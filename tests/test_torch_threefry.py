"""The threefry kernel's wrappers (``repro_torch.kernels.threefry``) on the
CPU and on meta tensors: the CPU path is the plain int64 chain, a call is
one charged launch whatever the device, keys are checked, and a mask is
one ``&`` after the draw.  The kernel itself is held against the chain on
the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from repro_torch import random as prng
from repro_torch.core.neuron import poisson_drive
from repro_torch.kernels import build
from repro_torch.kernels.threefry import kernel as TK
from repro_torch.kernels.threefry import ref
from repro_torch.launch import hlo

MODES = [True, False]
MODE_IDS = ["partitionable", "original"]


def _keys(lead, seed=0):
    words = np.random.default_rng(seed).integers(0, 2**32, lead + (2,))
    return torch.from_numpy(words.astype(np.int64))


def _calls(mode):
    """name -> (call through random.py, the plain chain)."""
    p = float(np.float32(0.02))
    return {
        "threefry_split": (
            lambda k: prng.split(k, 3, partitionable=mode),
            lambda k: ref.split_ref(k, 3, mode)),
        "threefry_bits": (
            lambda k: prng.random_bits(k, (37,), partitionable=mode),
            lambda k: ref.random_bits_ref(k, 37, mode)),
        "threefry_bernoulli": (
            lambda k: prng.bernoulli(k, 0.02, (37,), partitionable=mode),
            lambda k: ref.bernoulli_ref(k, p, 37, mode)),
    }


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("lead", [(), (3,), (4, 3)], ids=["1", "B3", "P4xB3"])
def test_cpu_path_is_the_plain_chain(mode, lead):
    """random.py's functions on the CPU are the chain's, bit for bit,
    and launch nothing."""
    k = _keys(lead)
    mask = torch.from_numpy(np.random.default_rng(1).random(37) < 0.5)
    calls = _calls(mode)
    calls["masked"] = (
        lambda k: poisson_drive(k, 37, 20.0, 1.0, mask, partitionable=mode),
        lambda k: ref.bernoulli_ref(k, float(np.float32(0.02)), 37, mode)
        & mask)
    TK.reset_launches()
    for name, (port, plain) in calls.items():
        got, want = port(k), plain(k)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    u = prng.uniform(k, (37,), partitionable=mode)
    assert torch.equal(u, ref.uniform_from_bits(ref.random_bits_ref(
        k, 37, mode)))
    assert TK.LAUNCHES == dict.fromkeys(TK.SOURCES, 0)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name", list(TK.SOURCES))
def test_one_call_is_one_launch_on_meta_and_the_cpu(mode, name):
    """Under hlo.count a call charges one launch of its kernel, with the
    same FLOPs, bytes and peak on meta and on the CPU (where the chain
    runs unseen by the counter)."""
    costs = {}
    for dev in ("meta", "cpu"):
        k = _keys((4, 3)).to(dev)
        call = _calls(mode)[name][0]
        with hlo.count(dev, resident=(k,)) as c:
            out = call(k)
        costs[dev] = c.cost
        assert out.device.type == dev
    meta, cpu = costs["meta"], costs["cpu"]
    assert meta.kernels == cpu.kernels == {name: 1}
    assert meta.launches == cpu.launches == 1
    assert (meta.flops, meta.bytes, meta.peak_bytes) == \
        (cpu.flops, cpu.bytes, cpu.peak_bytes)
    assert cpu.bytes == 12 * 16 + out.numel() * out.element_size()


@pytest.mark.parametrize("shape,dtype", [((4, 2), torch.int32),
                                         ((4, 3), torch.int64),
                                         ((), torch.int64),
                                         ((2,), torch.float64)])
def test_wrappers_refuse_keys_that_are_not_int64_pairs(shape, dtype):
    k = torch.zeros(shape, dtype=dtype)
    for name, (port, _) in _calls(True).items():
        with pytest.raises(ValueError, match="int64"):
            port(k)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_masks_follow_the_draw(mode):
    """poisson_drive's mask, a shared [n] row or a partition-stacked
    [P, U] one (shard_stimulus's), is one & after the draw's launch: the
    unmasked draws ANDed with the mask."""
    n, P_ = 500, 3
    rng = np.random.default_rng(2)
    k = _keys((P_,))
    row = torch.from_numpy(rng.random(n) < 0.7)
    stacked = torch.from_numpy(rng.random((P_, n)) < 0.7)
    free = poisson_drive(k, n, 300.0, 1.0, partitionable=mode)
    assert 0 < int(free.sum()) < free.numel()
    for mask in (row, stacked):
        got = poisson_drive(k, n, 300.0, 1.0, mask, partitionable=mode)
        assert torch.equal(got, free & mask)
        with hlo.count("cpu", resident=(k, mask)) as c:
            poisson_drive(k, n, 300.0, 1.0, mask, partitionable=mode)
        assert c.cost.kernels == {"threefry_bernoulli": 1}
        assert c.cost.launches == 2


def test_strided_keys_draw_what_their_copies_draw():
    """The carry's key is a strided view of the last split: the wrappers
    read it in place and draw what a contiguous copy draws."""
    keys = prng.split(_keys((4,)), 3)             # [4, 3, 2]
    view = keys[..., 1, :]
    assert not view.is_contiguous()
    for name, (port, _) in _calls(True).items():
        assert torch.equal(port(view), port(view.contiguous())), name


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_meta_gives_empty_results_of_the_right_shape(mode):
    k = torch.empty((32, 2), dtype=torch.int64, device="meta")
    assert prng.split(k, 3, partitionable=mode).shape == (32, 3, 2)
    b = prng.bernoulli(k, 0.1, (139,), partitionable=mode)
    assert (b.shape, b.dtype, b.device.type) == ((32, 139), torch.bool,
                                                 "meta")
    u = prng.uniform(k, (5, 7), partitionable=mode)
    assert (u.shape, u.dtype) == ((32, 5, 7), torch.float32)


def test_unseen_hides_ops_and_storage_from_every_counter():
    """build.unseen() (what the CPU path runs the chain under) hides its
    body's ops, bytes and storage from every active counter, nested ones
    included, and counting resumes after it."""
    x = torch.ones(1000)
    with hlo.count("cpu", resident=(x,)) as outer:
        with hlo.count("cpu", resident=(x,)) as inner:
            with build.unseen():
                y = (x + 1) * 2
            before = (outer.cost.launches, inner.cost.launches,
                      outer.cost.bytes, inner.cost.peak_bytes)
            x - 1
    assert torch.equal(y, torch.full((1000,), 4.0))
    assert before == (0, 0, 0, 4000)
    assert outer.cost.launches == inner.cost.launches == 1
