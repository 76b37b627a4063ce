"""The port's ``load_flywire_parquet`` against the JAX package's, on edge
tables this test writes itself (the real FlyWire table is not in the
repository): duplicate (pre, post) pairs, 64-bit root ids far beyond n,
a ``weight`` column or else ``syn_count``.  The ``Connectome`` arrays
are equal, array for array (tolerance 0)."""

import numpy as np
import pytest

pq = pytest.importorskip("pyarrow.parquet")
pa = pytest.importorskip("pyarrow")

from repro.core import connectome as ref_conn  # noqa: E402
from repro_torch.core import connectome  # noqa: E402
from repro_torch.core import load_flywire_parquet  # noqa: E402

ARRAYS = ("in_indptr", "in_indices", "in_weights", "out_indptr",
          "out_indices", "out_weights")


def _write_table(path, column, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(720575940600000000, 720575940700000000,
                               dtype=np.int64), 400, replace=False)
    pre = rng.choice(ids, 6_000)
    post = rng.choice(ids, 6_000)
    pre[:500], post[:500] = pre[500:1000], post[500:1000]   # duplicate pairs
    w = rng.integers(1, 60, 6_000)
    table = pa.table({"pre_root_id": pre, "post_root_id": post, column: w,
                      "neuropil": np.array(["AL_L"] * 6_000)})
    pq.write_table(table, path)
    return ids, pre, post


@pytest.mark.parametrize("column", ["weight", "syn_count"])
def test_loader_matches_reference(tmp_path, column):
    path = str(tmp_path / f"edges_{column}.parquet")
    ids, pre, post = _write_table(path, column, seed=len(column))
    want = ref_conn.load_flywire_parquet(path)
    got = load_flywire_parquet(path)
    assert got.n == want.n == len(np.unique(np.concatenate([pre, post])))
    for k in ARRAYS:
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # duplicate pairs were condensed: fewer synapses than rows, weights
    # summed
    assert got.nnz < len(pre)
    assert int(got.in_weights.sum()) == int(
        pq.read_table(path).column(column).to_numpy().sum())
    assert connectome.load_flywire_parquet is load_flywire_parquet


def test_weight_column_wins_over_syn_count(tmp_path):
    """With both columns the loader reads ``weight``, as the reference's
    ``tbl.get("weight", tbl.get("syn_count"))`` does."""
    path = str(tmp_path / "both.parquet")
    pq.write_table(pa.table({"pre_root_id": [10, 20, 10],
                             "post_root_id": [20, 30, 20],
                             "weight": [-3, 5, 2], "syn_count": [7, 7, 7]}),
                   path)
    want, got = ref_conn.load_flywire_parquet(path), load_flywire_parquet(path)
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(want, k), getattr(got, k))
    assert got.n == 3 and sorted(got.in_weights.tolist()) == [-1, 5]
