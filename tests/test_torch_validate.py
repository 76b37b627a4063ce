"""repro_torch.core.validate (the port's copy) against repro.core.validate:
the same ParityStats, mean rates and raster times on seeded inputs,
NaN/inf entries and an empty active set included; tensors are taken as
numpy arrays are."""

import numpy as np
import pytest
import torch

from repro.core import validate as ref
from repro_torch.core import validate as port


def _rates(seed: int, n: int = 500) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    a = rng.gamma(1.0, 8.0, n) * (rng.random(n) < 0.6)
    b = np.clip(a + rng.normal(0.0, 1.5, n), 0.0, None)
    return a, b


def _poisoned(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Noisy rates with about 5% NaN in one and 5% inf in the other, at
    different neurons."""
    rng = np.random.default_rng(seed)
    a, b = _rates(seed)
    return (np.where(rng.random(a.size) < 0.05, np.nan, a),
            np.where(rng.random(b.size) < 0.05, np.inf, b))


CASES = {
    "noisy": lambda: _rates(0),
    "equal": lambda: (_rates(1)[0],) * 2,
    "nan_inf": lambda: _poisoned(2),
    "all_nonfinite": lambda: (np.full(40, np.nan), np.full(40, -np.inf)),
    "empty_active": lambda: (np.full(300, 0.2), np.zeros(300)),
    "constant_one_side": lambda: (np.full(200, 3.0), _rates(3, 200)[1]),
    "constant_both_differ": lambda: (np.full(50, 3.0), np.full(50, 4.0)),
    "float32_input": lambda: tuple(x.astype(np.float32) for x in _rates(4)),
}


@pytest.mark.parametrize("threshold", [0.5, 5.0])
@pytest.mark.parametrize("case", list(CASES))
def test_parity_matches_reference(case, threshold):
    a, b = CASES[case]()
    want = ref.parity(a, b, active_thresh_hz=threshold)
    got = port.parity(a, b, active_thresh_hz=threshold)
    assert type(got).__name__ == "ParityStats"
    assert got == port.ParityStats(**{
        k: getattr(want, k) for k in want.__dataclass_fields__})
    assert got.summary() == want.summary()
    # the same statistics from tensors
    assert port.parity(torch.from_numpy(np.asarray(a)),
                       torch.from_numpy(np.asarray(b)),
                       active_thresh_hz=threshold) == got


def test_parity_flags_what_it_masked():
    a, b = CASES["nan_inf"]()
    got = port.parity(a, b)
    assert got.n_nonfinite == int((~(np.isfinite(a) & np.isfinite(b))).sum())
    assert got.n_nonfinite > 0 and np.isfinite(got.rmse_hz)
    empty = port.parity(*CASES["empty_active"]())
    assert (empty.n_active, empty.rmse_hz, empty.pearson_r) == (0, 0.0, 1.0)


@pytest.mark.parametrize("trials", [1, 3, 10])
def test_mean_rates_over_trials_matches_reference(trials):
    rng = np.random.default_rng(trials)
    counts = [rng.integers(0, 40, 700).astype(np.int32)
              for _ in range(trials)]
    want = ref.mean_rates_over_trials(counts, 1000, 0.1)
    got = port.mean_rates_over_trials(counts, 1000, 0.1)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        want, port.mean_rates_over_trials(
            [torch.from_numpy(c) for c in counts], 1000, 0.1))


@pytest.mark.parametrize("density", [0.0, 0.003, 0.2])
def test_raster_to_times_matches_reference(density):
    raster = np.random.default_rng(5).random((120, 90)) < density
    want = ref.raster_to_times(raster, 0.1)
    got = port.raster_to_times(raster, 0.1)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(want, port.raster_to_times(torch.from_numpy(raster),
                                               0.1)):
        np.testing.assert_array_equal(a, b)
