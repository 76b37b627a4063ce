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


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds:
    to nearest, ties away from zero, with integer operations on the bits
    (adding half a TF32 ulp to the magnitude, then truncating)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """x = hi + lo as the CUDA kernel splits it: hi rounded to TF32, lo the
    exact rest truncated to TF32 (what the tensor cores read of it)."""
    hi = _tf32(x)
    rest = (x - hi).astype(np.float32).view(np.uint32)
    return hi, (rest & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the CUDA kernel forms it: each operand split into TF32 hi
    and lo, and each product as lo.hi + hi.lo + hi.hi (TF32 products are
    exact in float32; the sums are taken in float64 here)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    t = lambda x: torch.from_numpy(x).double()  # noqa: E731
    return (t(al) @ t(bh) + t(ah) @ t(bl) + t(ah) @ t(bh)).float().numpy()


def _matmul_tf32(a, b):
    """a @ b with each operand rounded to TF32 once: plain TF32."""
    return (torch.from_numpy(_tf32(a)).double()
            @ torch.from_numpy(_tf32(b)).double()).float().numpy()


def _attention_with(matmul, q, k, v):
    """Causal softmax attention over GQA operands with ``matmul`` for both
    products (the probabilities are float32 before P.V)."""
    H, Hkv, S, D = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k, v = (np.repeat(x, H // Hkv, axis=1) for x in (k, v))
    s = matmul(q, np.swapaxes(k, -1, -2)) * np.float32(D ** -0.5)
    mask = np.tril(np.ones((S, S), bool))
    s = np.where(mask, s, -np.inf)
    p = np.where(mask, np.exp(s - s.max(-1, keepdims=True)), 0.0)
    p = p.astype(np.float32)
    return matmul(p, v) / p.sum(-1, keepdims=True, dtype=np.float32)


def test_tf32_rounding_helper():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                  -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                     -(1.0 + 2.0 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(_tf32(x), want)   # ties away from zero
    y = np.random.default_rng(0).normal(0, 1, 100_000).astype(np.float32)
    hi, lo = _split(y)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.all(lo.view(np.uint32) & 0x1FFF == 0)
    resid = np.abs(y.astype(np.float64) - hi - lo) / np.abs(y)
    assert resid.max() <= 2.0 ** -21                # two TF32 parts: ~21 bits


def test_3xtf32_split_holds_the_tolerance_at_qwen_heads():
    """The flash kernel's precision scheme, before the card sees it: at the
    qwen2.5-14b head layout (40 query heads over 8 kv heads of 128), both
    products formed from split TF32 operands give attention within 2e-4
    of attention_ref and of the JAX kernel (Pallas, interpret mode); one
    TF32 product each would not."""
    q, k, v = _inputs(1, 40, 8, 64, 128, seed=6)
    got = _attention_with(_matmul_3xtf32, q, k, v)
    ref = attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=True).numpy()
    want_k = np.asarray(jax_flash(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, want_k, atol=ATOL, rtol=0)
    plain_tf32 = _attention_with(_matmul_tf32, q, k, v)
    assert np.abs(plain_tf32 - ref).max() > ATOL


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
