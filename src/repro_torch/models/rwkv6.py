"""RWKV-6 "Finch" block (arXiv:2404.05892): an attention-free SSM with
data-dependent per-channel decay.

Counterpart of ``repro/models/rwkv6.py``.

Time mixing (per head, head size 64):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
with w_t = exp(-exp(w0 + LoRA_w(x~))) the data-dependent decay, and
token-shift ddlerp mixes on every projection input.  Channel mixing:
r * W_v(relu(W_k x~)^2).

The state ``[B, H, 64, 64]`` is float32.  The reference's ``lax.scan``
over time is a Python loop here (about six launches a token); under grad
with ``remat`` it runs in chunks of :data:`CHUNK` steps under
``torch.utils.checkpoint``, so the backward pass keeps one state a chunk
rather than one a token, as the reference's ``jax.checkpoint`` of its
chunk step does.  Decode is :func:`timemix_apply` with S = 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import _mm, _promoted, recomputing, scan_in_chunks
from .param import dense_param, scale_param

HEAD = 64
LORA_R = 32
CHUNK = 64


def _lora_init(gen, d, r, out=None, device=None):
    out = d if out is None else out
    a = torch.randn((d, r), generator=gen, device=device).mul_(0.01)
    b = torch.randn((r, out), generator=gen, device=device).mul_(0.01)
    return {"a": a, "b": b}


def _lora(p, x):
    return _mm(torch.tanh(_mm(x, p["a"])), p["b"])


def timemix_init(gen, d, device=None):
    """The time-mix parameters: ``mu_*`` 0.5, ``w0`` -6, ``u`` 0 and
    ``ln_scale`` 1 as the reference's; the LoRAs (normal x 0.01) and the
    five projections (normal / sqrt(d)) drawn from ``gen``."""
    def full(v):
        return torch.full((d,), v, dtype=torch.float32, device=device)
    p = {f"mu_{n}": full(0.5) for n in ("base", "w", "k", "v", "r", "g")}
    p["lora_mix"] = _lora_init(gen, d, LORA_R, d * 5, device)
    p["w0"] = full(-6.0)
    p["lora_w"] = _lora_init(gen, d, LORA_R, device=device)
    p["u"] = full(0.0)
    for n in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[n] = dense_param(gen, d, d, device=device)
    p["ln_scale"] = scale_param(d, device=device)
    return p


def timemix_param_count(d) -> int:
    return 5 * d * d + (6 + 1 + 1 + 1) * d + LORA_R * (d + 5 * d) \
        + LORA_R * 2 * d


def _ddlerp(p, x, x_prev):
    """Finch's data-dependent token shift: one fused LoRA giving the five
    per-projection mix deltas."""
    d = x.shape[-1]
    base = x + (x_prev - x) * p["mu_base"]
    deltas = _lora(p["lora_mix"], base).reshape(*x.shape[:-1], 5, d)
    return [x + (x_prev - x) * (p[name] + deltas[..., i, :])
            for i, name in enumerate(("mu_w", "mu_k", "mu_v", "mu_r",
                                      "mu_g"))]


class _Readout(torch.autograd.Function):
    """A step's output ``einsum("bhij,bhi->bhj", a, r)``, a = S + diag(u)
    k v^T.  Its backward forms the gradient wrt ``a``, the outer product
    of ``r`` and the output's gradient, as a broadcast multiply (one
    product an entry, as XLA computes it; autograd's einsum would run a
    K = 1 matrix product), and the forward product is skipped while a
    checkpointed chunk is recomputed, since nothing in the backward reads
    the output (ROADMAP finding 15)."""

    @staticmethod
    def forward(ctx, a, r):
        ctx.save_for_backward(a, r)
        if recomputing():
            return r.new_empty(r.shape)
        return torch.einsum("bhij,bhi->bhj", a, r)

    @staticmethod
    def backward(ctx, g):
        a, r = ctx.saved_tensors
        g_a = (r[..., :, None] * g[..., None, :]
               if ctx.needs_input_grad[0] else None)
        g_r = (torch.einsum("bhij,bhj->bhi", a, g)
               if ctx.needs_input_grad[1] else None)
        return g_a, g_r


def _wkv_step(state, r, k, v, w, u):
    """One step of the recurrence from ``state`` [B, H, 64, 64] with r/k/
    v/w [B, H, 64] and ``u`` [H, 64]; returns (state, y [B, H, 64])."""
    kv = k[..., :, None] * v[..., None, :]                    # [B,H,64,64]
    y = _Readout.apply(*_promoted(state + u[..., :, None] * kv, r))
    return torch.addcmul(kv, w[..., :, None], state), y


def _wkv_scan(r, k, v, w, u, state, remat=True):
    """r/k/v: [B, S, H, 64]; w: [B, S, H, 64] decay in (0, 1); u: [H, 64].
    Returns (y [B, S, H, 64], state' [B, H, 64, 64]).

    Under grad with ``remat`` the steps run in checkpointed chunks of
    :data:`CHUNK` (:func:`repro_torch.models.layers.scan_in_chunks`): the
    backward pass keeps one ``[B, H, 64, 64]`` state a chunk, not one a
    step (S x 1 MiB a sequence at 7B width)."""
    xs = tuple(t.transpose(0, 1) for t in (r, k, v, w))     # [S, B, H, 64]
    state, ys = scan_in_chunks(_wkv_step, state, xs, remat, CHUNK,
                               consts=(u,))
    return ys.transpose(0, 1), state


def timemix_apply(p, x, shift_state=None, wkv_state=None, remat=True):
    """x: [B, S, d].  Returns (out, (x_last, wkv_state))."""
    B, S, d = x.shape
    H = d // HEAD
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)

    w = torch.exp(-torch.exp(p["w0"] + _lora(p["lora_w"], xw)))
    r = _mm(xr, p["w_r"]).reshape(B, S, H, HEAD)
    k = _mm(xk, p["w_k"]).reshape(B, S, H, HEAD)
    v = _mm(xv, p["w_v"]).reshape(B, S, H, HEAD)
    g = F.silu(_mm(xg, p["w_g"]))
    wh = w.reshape(B, S, H, HEAD)
    u = p["u"].reshape(H, HEAD)

    if wkv_state is None:
        wkv_state = torch.zeros((B, H, HEAD, HEAD), dtype=torch.float32,
                                device=x.device)
    y, wkv_state = _wkv_scan(r, k, v, wh, u, wkv_state, remat)
    # per-head group norm (the population variance, as jnp.var's)
    yh = y.reshape(B, S, H, HEAD).float()
    yh = (yh - yh.mean(-1, keepdim=True)) * torch.rsqrt(
        yh.var(-1, keepdim=True, correction=0) + 1e-5)
    y = (yh.reshape(B, S, d) * p["ln_scale"]).to(x.dtype)
    out = _mm(y * g, p["w_o"])
    return out, (x[:, -1], wkv_state)


def chanmix_init(gen, d, d_ff, device=None):
    return {"mu_k": torch.full((d,), 0.5, device=device),
            "mu_r": torch.full((d,), 0.5, device=device),
            "w_k": dense_param(gen, d, d_ff, device=device),
            "w_v": dense_param(gen, d_ff, d, device=device),
            "w_r": dense_param(gen, d, d, device=device)}


def chanmix_param_count(d, d_ff) -> int:
    return 2 * d + 2 * d * d_ff + d * d


def chanmix_apply(p, x, shift_state=None):
    """x: [B, S, d].  Returns (out, x_last)."""
    B, S, d = x.shape
    if shift_state is None:
        shift_state = torch.zeros((B, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    xk = x + (x_prev - x) * p["mu_k"]
    xr = x + (x_prev - x) * p["mu_r"]
    k = torch.square(torch.relu(_mm(xk, p["w_k"])))
    return torch.sigmoid(_mm(xr, p["w_r"])) * _mm(k, p["w_v"]), x[:, -1]


__all__ = ["CHUNK", "HEAD", "LORA_R", "chanmix_apply", "chanmix_init",
           "chanmix_param_count", "timemix_apply", "timemix_init",
           "timemix_param_count"]
