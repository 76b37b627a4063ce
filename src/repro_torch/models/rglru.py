"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.

Block: x -> {a = conv1d(W_x x), b = gelu(W_y x)} -> RG-LRU(a) * b -> W_o.
RG-LRU:  r_t = sigmoid(W_r a_t),  i_t = sigmoid(W_i a_t),
         alpha_t = exp(-c * softplus(lam) * r_t)          (c = 8)
         h_t = alpha_t * h_{t-1} + sqrt(1 - alpha_t^2) * (i_t * a_t)

The recurrence runs in float32 whatever the activation dtype.  The
reference's ``lax.scan`` over time is a Python loop over the steps here
(one fused multiply-add launch a step); under grad with ``remat`` it runs
in chunks of :data:`CHUNK` steps under ``torch.utils.checkpoint``, so the
backward pass keeps one state a chunk, as the reference's
``jax.checkpoint`` of its chunk step does.  Decode carries ``(h, conv
tail)``: O(1) state a token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _gelu, _mm, scan_in_chunks
from .param import dense_param

CONV_W = 4
C_LRU = 8.0
CHUNK = 64


def rglru_init(gen, d_model, d_rnn, device=None):
    """The block's parameters, drawn from ``gen`` in the reference's
    order.  ``lam`` is deterministic: softplus^-1 of ``-log(alpha) / c``
    for alpha evenly spaced in [0.9, 0.999], computed in float64 and
    rounded once to float32 (the reference's float32 ops land within
    4e-6 of it, relative)."""
    lam = torch.log(torch.expm1(-torch.log(torch.linspace(
        0.9, 0.999, d_rnn, dtype=torch.float64, device=device)) / C_LRU))
    lam = lam.float()
    p = {"w_x": dense_param(gen, d_model, d_rnn, device=device),
         "w_y": dense_param(gen, d_model, d_rnn, device=device)}
    p["conv"] = torch.randn((CONV_W, d_rnn), generator=gen,
                            device=device).mul_(0.1)
    p["w_r"] = dense_param(gen, d_rnn, d_rnn, device=device)
    p["w_i"] = dense_param(gen, d_rnn, d_rnn, device=device)
    p["lam"] = lam
    p["w_o"] = dense_param(gen, d_rnn, d_model, device=device)
    return p


def rglru_param_count(d_model, d_rnn) -> int:
    return 3 * d_model * d_rnn + 2 * d_rnn * d_rnn + (CONV_W + 1) * d_rnn


def _lru_coeffs(p, a):
    """float32 recurrence coefficients (alpha, drive) of the conv output
    ``a`` (Griffin runs the RG-LRU in float32 whatever the activation
    dtype)."""
    a32 = a.float()
    r = torch.sigmoid(a32 @ p["w_r"].float())
    i = torch.sigmoid(a32 @ p["w_i"].float())
    log_alpha = -C_LRU * F.softplus(p["lam"]) * r
    alpha = torch.exp(log_alpha)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_alpha),
                                      1e-12))
    return alpha, beta * i * a32


def _step(h, alpha_t, drive_t):
    """One step of the recurrence, h_t = alpha_t * h_{t-1} + drive_t;
    returns (h_t, h_t)."""
    h = torch.addcmul(drive_t, alpha_t, h)
    return h, h


def linear_scan(alpha, drive, h0, remat=True):
    """The sequential scan of :func:`rglru_apply` over [B, S, d] float32
    coefficients from ``h0`` [B, d], in checkpointed chunks of
    :data:`CHUNK` steps under grad with ``remat``
    (:func:`repro_torch.models.layers.scan_in_chunks`).  Returns (hs [B,
    S, d], h_last)."""
    h, hs = scan_in_chunks(_step, h0, (alpha.transpose(0, 1),
                                       drive.transpose(0, 1)), remat, CHUNK)
    return hs.transpose(0, 1), h


def assoc_scan(alpha, drive):
    """Log-depth (Hillis-Steele) inclusive scan of the affine maps
    ``h -> alpha_t * h + drive_t`` over axis 1 of [B, S, d]: the
    reference's ``lax.associative_scan`` with ``combine((al, bl), (ar,
    br)) = (al * ar, ar * bl + br)``.  Its sums group in another order
    than the sequential scan's, so the two agree to rounding only."""
    a, b = alpha, drive
    S, step = a.shape[1], 1
    while step < S:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        a_cur, b_cur = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :step], a_cur * b_prev + b_cur], dim=1)
        step *= 2
    return b


def rglru_apply(p, x, h0=None, assoc=False, remat=True):
    """x: [B, S, d].  Returns (out [B, S, d], (h_last, a_tail)), a_tail
    the last CONV_W - 1 pre-conv inputs (the decode conv window; with
    S < 3 it holds the zero padding).

    ``assoc=True``: the recurrence runs as a log-depth associative scan
    over time (:func:`assoc_scan`)."""
    B, S, _ = x.shape
    a_in = _mm(x, p["w_x"])
    b = _gelu(_mm(x, p["w_y"]))
    # depthwise causal conv, width 4: a Python sum from 0, as the
    # reference's
    a_pad = F.pad(a_in, (0, 0, CONV_W - 1, 0))
    a = sum(a_pad[:, i:i + S] * p["conv"][i] for i in range(CONV_W))
    alpha, drive = _lru_coeffs(p, a)
    a_tail = a_pad[:, S:S + CONV_W - 1]
    if assoc:
        if h0 is not None:
            drive = torch.cat([drive[:, :1] + alpha[:, :1]
                               * h0.float()[:, None], drive[:, 1:]], dim=1)
        hs = assoc_scan(alpha, drive)
        h_last = hs[:, -1]
    else:
        d_rnn = a.shape[-1]
        h0 = (torch.zeros((B, d_rnn), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
        hs, h_last = linear_scan(alpha, drive, h0, remat)
    h = hs.to(x.dtype)
    return _mm(h * b, p["w_o"]), (h_last.to(x.dtype), a_tail)


def rglru_decode(p, x, state):
    """x: [B, 1, d]; state = (h [B, d_rnn], conv_tail [B, CONV_W-1,
    d_rnn]).  Returns (out [B, 1, d], (h', tail'))."""
    h, tail = state
    a_t = _mm(x, p["w_x"])[:, 0]
    b_t = _gelu(_mm(x, p["w_y"]))[:, 0]
    window = torch.cat([tail, a_t[:, None]], dim=1)     # [B, 4, d_rnn]
    a = (window * p["conv"][None].to(window.dtype)).sum(1)
    alpha, drive = _lru_coeffs(p, a)
    h_new = alpha * h.float() + drive
    out = _mm(h_new.to(x.dtype) * b_t, p["w_o"])
    return out[:, None], (h_new.to(h.dtype), window[:, 1:])


def rglru_init_state(batch, d_rnn, dtype=torch.float32, device=None):
    return (torch.zeros((batch, d_rnn), dtype=dtype, device=device),
            torch.zeros((batch, CONV_W - 1, d_rnn), dtype=dtype,
                        device=device))


__all__ = ["CHUNK", "CONV_W", "C_LRU", "assoc_scan", "linear_scan",
           "rglru_apply", "rglru_decode", "rglru_init", "rglru_init_state",
           "rglru_param_count"]
