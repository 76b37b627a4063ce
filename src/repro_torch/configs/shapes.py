"""Assigned input-shape cells and per-(arch x cell) input specs.

Counterpart of ``repro/configs/shapes.py``.  Four cells per LM
architecture:
  train_4k     seq 4,096   global_batch 256   (training step)
  prefill_32k  seq 32,768  global_batch 32    (inference prefill)
  decode_32k   one token, 32,768-entry KV     global_batch 128
  long_500k    one token, 524,288-entry KV    global_batch 1
               (sub-quadratic archs only)

Family adjustments:
  * whisper-medium: encoder fixed at 1500 frames, decoder at its
    architectural max 448; decode cells use that max; long_500k skipped.
  * llava-next: n_patches stub embeddings occupy the head of the sequence.
  * pure full-attention archs skip long_500k.

The reference returns ``jax.ShapeDtypeStruct`` stand-ins; here a spec is a
tensor on the ``meta`` device, which has a shape and a dtype and holds no
memory.  :func:`cache_specs` is :func:`repro_torch.models.init_cache` on
that device: the port's cache layout (a dict per layer; for whisper
``{"self", "cross"}``, a ``{"k", "v"}`` per decoder layer each) with the
reference's shapes and dtypes.  llava's 576 patches do not fit the
smoke-scale sequence of 64, where the reference's token spec has a
negative length and a meta tensor cannot be made (ROADMAP finding 14).
"""

from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, init_cache

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

META = torch.device("meta")


def cell_supported(cfg: ModelConfig, cell: str) -> tuple[bool, str]:
    if cell == "long_500k":
        if cfg.is_encdec:
            return False, "whisper decoder max context is 448"
        if not cfg.subquadratic:
            return False, "pure full-attention arch; 500k decode skipped"
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tok(b, s):
    return _spec((b, s), torch.int32)


def _cell_size(cell: str, smoke_scale: bool) -> tuple[int, int]:
    spec = SHAPES[cell]
    B, S = spec["batch"], spec["seq"]
    if smoke_scale:
        B, S = max(2, B // 128), max(32, S // 512)
    return B, S


def input_specs(cfg: ModelConfig, cell: str, smoke_scale: bool = False):
    """Meta-tensor stand-ins for one step of the given cell.

    Returns dict with keys depending on kind:
      train:   batch={tokens, labels, (patches|frames)}
      prefill: batch={tokens, (patches|frames)}
      decode:  tokens [B], pos scalar   (cache specs built separately via
               cache_specs()).
    """
    B, S = _cell_size(cell, smoke_scale)
    kind = SHAPES[cell]["kind"]
    decode = {"tokens": _spec((B,), torch.int32),
              "pos": _spec((), torch.int32)}

    if cfg.is_encdec:
        # whisper: clamp to (enc 1500 frames, dec 448 tokens)
        Sd = cfg.dec_max
        frames = _spec((B, cfg.enc_seq, cfg.d_model), torch.float32)
        if kind == "train":
            return {"batch": {"frames": frames, "tokens": _tok(B, Sd),
                              "labels": _tok(B, Sd)}}
        if kind == "prefill":
            return {"batch": {"frames": frames, "tokens": _tok(B, Sd)}}
        return decode

    if kind in ("train", "prefill"):
        batch = {}
        S_tok = S
        if cfg.n_patches:
            S_tok = S - cfg.n_patches
            batch["patches"] = _spec((B, cfg.n_patches, cfg.d_model),
                                     torch.float32)
        batch["tokens"] = _tok(B, S_tok)
        if kind == "train":
            batch["labels"] = _tok(B, S_tok)
        return {"batch": batch}
    return decode


def cache_specs(cfg: ModelConfig, cell: str, dtype=torch.float32,
                smoke_scale: bool = False):
    """The decode cache of a decode cell, on the meta device."""
    B, S = _cell_size(cell, smoke_scale)
    return init_cache(cfg, B, S, dtype, device=META)


__all__ = ["SHAPES", "cache_specs", "cell_supported", "input_specs"]
