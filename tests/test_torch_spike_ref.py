"""The port's spike-delivery oracles (``repro_torch/kernels/spike_prop/
ref.py``) against the JAX package's, on the CPU, at n <= 1,600.

Both oracles sum integer weights (raw, and quantized to 9 bits as the
paper's configuration does) over 0/1 spikes in float32, where every
partial sum is an exact integer, so the comparisons are exact whatever
the summation order.  The tile oracle is also held against the port's
builder (``build_blocked``) and its plain delivery
(``spike_deliver_plain``) on the same store, and both oracles against
each other."""

import jax
import numpy as np
import pytest
import torch

from repro.core import connectome as ref_conn
from repro.kernels.spike_prop import ops as ref_ops
from repro.kernels.spike_prop import ref as ref_oracles
from repro_torch import convert
from repro_torch.kernels.spike_prop import kernel as K
from repro_torch.kernels.spike_prop import ops
from repro_torch.kernels.spike_prop import ref as oracles

NETS = {"n1500": (1_500, 3), "n1600": (1_600, 8)}
ACTIVITY = {"sparse": 0.02, "dense": 0.3, "all": 1.0}


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    n, seed = NETS[request.param]
    rc = ref_conn.synthetic_flywire(n, seed=seed)
    pc = convert.connectome_from_jax(rc)
    quant = np.clip(np.round(rc.in_weights / 2), -255, 255).astype(
        rc.in_weights.dtype)
    return rc, pc, quant


def _spikes(n, activity, seed=0):
    return np.random.default_rng(seed).random(n) < ACTIVITY[activity]


@pytest.mark.parametrize("quantized", [False, True], ids=["raw", "9bit"])
@pytest.mark.parametrize("activity", list(ACTIVITY))
def test_dense_oracle_matches_reference(net, activity, quantized):
    rc, pc, quant = net
    s = _spikes(rc.n, activity)
    q = quant if quantized else None
    want = np.asarray(ref_oracles.spike_deliver_dense_ref(rc, s, q))
    got = oracles.spike_deliver_dense_ref(pc, s, q, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == (rc.n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("activity", list(ACTIVITY))
def test_tile_oracle_matches_reference_and_plain(net, activity):
    rc, pc, _ = net
    s = _spikes(rc.n, activity, seed=1)
    want = np.asarray(ref_oracles.spike_deliver_ref(ref_ops.build_blocked(rc),
                                                    s))
    bs = ops.build_blocked(pc, device="cpu")
    got = oracles.spike_deliver_ref(bs, torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain delivery on the same store, and the dense oracle
    spk, nspk = ops.pad_spike_blocks(torch.from_numpy(s), bs.n, bs.n_sb)
    plain = K.spike_deliver_plain(bs.blk_id, bs.weights, spk, nspk)
    assert torch.equal(plain.reshape(-1)[:rc.n], got)
    dense = oracles.spike_deliver_dense_ref(pc, s, device="cpu")
    assert torch.equal(dense, got)


def test_dense_oracle_needs_a_device_without_cuda(net):
    _, pc, _ = net
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        oracles.spike_deliver_dense_ref(pc, np.zeros(pc.n, bool))
