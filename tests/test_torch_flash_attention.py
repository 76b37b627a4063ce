"""repro_torch.kernels.flash_attention against the JAX package's
flash_attention (Pallas, interpret mode) and attention_ref, over the sweep
of tests/test_kernels.py plus the head dims of the repo's configs (24 and
256).  On the CPU the wrapper runs its plain version.

Tolerance: atol 2e-4, the JAX package's own for its kernel against
attention_ref.  The online softmax sums in another order than the
materialized one (float32, scores of unit-normal inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import kernel as K

ATOL = 2e-4
SWEEP = [
    (1, 2, 2, 256, 64, True, None),
    (2, 4, 2, 128, 64, True, None),      # GQA
    (1, 2, 1, 200, 32, True, None),      # ragged (200 % 128 != 0)
    (1, 2, 2, 256, 64, False, None),     # bidirectional (whisper encoder)
    (1, 2, 2, 512, 64, True, 128),       # sliding window (gemma3 local)
    (1, 4, 4, 384, 128, True, 96),
    (1, 4, 2, 160, 24, True, None),      # d_head 24 (a smoke config's)
    (1, 2, 1, 192, 256, True, 64),       # d_head 256 (gemma3) with window
]


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def _inputs(B, H, Hkv, Sq, D, Skv=None, seed=None):
    rng = np.random.default_rng(Sq + D if seed is None else seed)
    Skv = Sq if Skv is None else Skv
    return (rng.normal(0, 1, (B, H, Sq, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Skv, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,Hkv,Sq,D,causal,window", SWEEP)
def test_flash_attention_matches_jax(B, H, Hkv, Sq, D, causal, window):
    q, k, v = _inputs(B, H, Hkv, Sq, D)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, window=window).numpy()
    want_k = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=causal, window=window))
    want_r = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=causal, window=window))
    np.testing.assert_allclose(got, want_k, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40)])
def test_attention_ref_matches_jax(causal, window):
    """The oracle itself, including the decode case Sq < Skv (queries
    aligned to the end of the keys).  Tolerance 1e-5: both materialize the
    float32 softmax; einsum orders differ."""
    q, k, v = _inputs(2, 4, 2, 48, 32, Skv=80, seed=3)
    got = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal, window=window).numpy()
    want = np.asarray(jax_ref(*(jnp.asarray(x) for x in (q, k, v)),
                              causal=causal, window=window))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_unequal_lengths_follow_the_kernel_not_the_oracle():
    """Sq != Skv: the TPU kernel places query i at position i (no end
    alignment), and so does the port; a causal query past the keys sees
    them all."""
    q, k, v = _inputs(1, 2, 2, 96, 32, Skv=160, seed=4)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True).numpy()
    want = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                causal=True))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_dtype_round_trip_and_launch_count():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(1, 2, 1, 64, 32, seed=5))
    K.reset_launches()
    out = flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert K.LAUNCHES["flash_attention"] == 0      # the plain version ran
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :, :16].float(), k.float(), v.float())
    z = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError):                 # 3 heads over 2 kv heads
        K.flash_attention_gqa(z, z[:, :2].contiguous(), z[:, :2].contiguous(),
                              scale=1.0, causal=True, window=None)
    z = torch.zeros(1, 1, 8, 300)
    with pytest.raises(ValueError):                 # head dim above 256
        K.flash_attention_gqa(z, z, z, scale=1.0, causal=True, window=None)
