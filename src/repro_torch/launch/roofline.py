"""Roofline analysis of the dry-run records, against one NVIDIA H100.

Counterpart of ``repro/launch/roofline.py``.  Per (arch x cell x mesh),
from a record of :mod:`repro_torch.launch.dryrun`:

    compute_s    = counted FLOPs a rank / the card's peak for the
                   record's compute dtype
    memory_s     = the analytic traffic model's bytes a rank / HBM rate
    collective_s = link bytes a rank / the link rate of the record's
                   backend

plus MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N the active
parameters for MoE, and the useful-compute ratio MODEL_FLOPS / (counted
FLOPs x ranks), which shows recompute, padding and repeated work (the
port repeats the model's work on every rank along ``model``).

The peaks (:data:`H100`) are the data sheet's for the H100 SXM5 80GB
HBM3 at its 700 W limit: 66.9 TFLOP/s float32 on the CUDA cores (the
port keeps TF32 off), 989.4 TFLOP/s bfloat16 dense, 3.35 TB/s HBM3;
NVLink 450 GB/s a direction between ``nccl`` ranks, PCIe Gen5 x16
64 GB/s a direction for ``gloo``, which stages payloads through pinned
host memory.  :func:`analyse_record` takes other peaks as ``peaks``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.roofline \
        --in build/dryrun --out build/roofline.md
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import count_params

H100 = {
    "name": "NVIDIA H100 80GB HBM3 (SXM5, 700 W)",
    "flops": {"float32": 66.9e12, "bfloat16": 989.4e12},
    "hbm_bw": 3.35e12,
    "link_bw": {"nccl": 450e9, "gloo": 64e9},
    "hbm_bytes": 80e9,
}

_SUGGEST = {
    "compute": "raise tensor-core use: bfloat16 products, a larger batch "
               "a rank, fused attention where masked products dominate",
    "memory": "cut HBM traffic: fewer, fused kernels (the eager step "
              "reads and writes every intermediate), bfloat16 activations",
    "collective": "cut link traffic: nccl ranks on cards of their own, "
                  "shard so the hot dim stays local, overlap the "
                  "collectives with compute",
}


def _peak(table, key):
    """``table[key]`` for a dict of peaks, else the one peak given."""
    return table[key] if isinstance(table, dict) else table


def _active_params(cfg) -> float:
    """Non-expert parameters plus the activated fraction of the expert
    parameters (all of them for a dense model)."""
    n = count_params(cfg)
    if not cfg.n_experts:
        return n
    frac = (cfg.top_k + (1 if cfg.shared_expert else 0)) \
        / (cfg.n_experts + (1 if cfg.shared_expert else 0))
    expert = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    shared = (cfg.n_layers * 3 * cfg.d_model * cfg.d_ff
              if cfg.shared_expert else 0)
    return n - expert - shared + (expert + shared) * frac


def model_flops(arch: str, cell: str) -> float:
    cfg = get_config(arch)
    spec = SHAPES[cell]
    n = _active_params(cfg)
    if spec["kind"] == "train":
        tokens = spec["batch"] * spec["seq"]
        if cfg.is_encdec:
            tokens = spec["batch"] * (cfg.dec_max + cfg.enc_seq)
        return 6.0 * n * tokens
    if spec["kind"] == "prefill":
        tokens = spec["batch"] * (cfg.dec_max + cfg.enc_seq
                                  if cfg.is_encdec else spec["seq"])
        return 2.0 * n * tokens
    return 2.0 * n * spec["batch"]        # decode: one token a slot


def analytic_traffic(arch: str, cell: str, chips: int, meta: dict) -> float:
    """Structural HBM traffic a rank (bytes a step): the memory-term
    model, the reference's.  The counted bytes of the eager step are
    reported beside it as ``counted_bytes_bound_s``.

    train:   optimizer sweep (read p, m, v + write p, m, v, float32) +
             bfloat16 cast write + per-(microbatch x layer) activation
             I/O at 24 passes of [B_mb, S, d_model] + float32 logits (3
             passes) + the kv stream of each layer.
    prefill: weights once (bfloat16) + single-pass activations (8) +
             cache write.
    decode:  weights once + the whole cache read + the slice written.
    """
    cfg = get_config(arch)
    spec = SHAPES[cell]
    N = count_params(cfg)
    kind = spec["kind"]
    B, S = spec["batch"], spec["seq"]
    if cfg.is_encdec:
        S = cfg.dec_max + cfg.enc_seq
    L, d = cfg.n_layers + cfg.n_enc_layers, cfg.d_model
    mesh = meta.get("mesh", {})
    dp = mesh.get("data", 16) * mesh.get("pod", 1)
    model_n = mesh.get("model", 16)
    n_active = _active_params(cfg)

    if kind == "train":
        M = meta.get("microbatches", 8)
        B_loc = max(1, B // dp)
        opt = 6 * 4 * N / chips                     # p, m, v float32 r+w
        cast = (4 + 2) * N / chips                  # float32 read, bf16 write
        wstream = 3 * 2 * n_active * M / chips      # weights a microbatch
        acts = 24 * L * B_loc * S * d * 2
        logits = 3 * 4 * B_loc * S * cfg.vocab / max(1, model_n)
        kv = 3 * 2 * 2 * L * B_loc * S * cfg.n_kv_heads * cfg.d_head
        return opt + cast + wstream + acts + logits + kv

    if kind == "prefill":
        B_loc = max(1, B // dp)
        w = 2 * n_active / chips
        acts = 8 * L * B_loc * S * d * 2
        cache = 2 * 2 * L * B_loc * S * cfg.n_kv_heads * cfg.d_head
        return w + acts + cache

    w = 2 * n_active / (model_n if B >= dp else chips)
    cache_total = 2 * 2 * L * B * S * cfg.n_kv_heads * cfg.d_head
    if cfg.family == "ssm":
        cache_total = 2 * cfg.n_layers * B * cfg.d_model * 66  # wkv state
    elif cfg.family == "hybrid":
        n_attn = sum(1 for k in cfg.block_pattern if k == "local")
        cache_total = 2 * 2 * cfg.n_layers * (
            n_attn / len(cfg.block_pattern)) * B * min(cfg.window or S, S) \
            * cfg.n_kv_heads * cfg.d_head
    elif cfg.window and "local" in cfg.block_pattern:
        # gemma3: 5 of 6 layers read only their window
        n_local = sum(1 for k in cfg.block_pattern if k == "local")
        n_glob = len(cfg.block_pattern) - n_local
        eff = (n_local * min(cfg.window, S) + n_glob * S) / (
            len(cfg.block_pattern) * S)
        cache_total *= eff
    return w + cache_total / chips


def analyse_record(rec: dict, peaks: dict = H100) -> dict:
    """The roofline terms of a dry-run record on ``peaks`` (default
    :data:`H100`; ``flops`` and ``link_bw`` may be one number, or a dict
    by the record's compute dtype and backend)."""
    meta = rec.get("meta", {})
    flops = rec["cost"]["flops_per_device"]
    counted_bytes = rec["cost"]["bytes_per_device"]
    link = rec["collectives"]["link_bytes"]
    chips = rec["n_devices"]
    peak_flops = _peak(peaks["flops"], meta.get("compute_dtype",
                                                "bfloat16"))
    hbm = peaks["hbm_bw"]
    mem_bytes = analytic_traffic(rec["arch"], rec["cell"], chips, meta)
    terms = {
        "compute_s": flops / peak_flops,
        "memory_s": mem_bytes / hbm,
        "collective_s": link / _peak(peaks["link_bw"],
                                     meta.get("backend", "nccl")),
        "counted_bytes_bound_s": counted_bytes / hbm,
    }
    dominant = max(("compute_s", "memory_s", "collective_s"),
                   key=terms.get)
    mf = model_flops(rec["arch"], rec["cell"])
    total = flops * chips
    bound = max(terms["compute_s"], terms["memory_s"],
                terms["collective_s"])
    achieved = mf / chips / bound if bound else 0.0
    return dict(
        rec,
        terms=terms,
        dominant=dominant.replace("_s", ""),
        model_flops=mf,
        useful_ratio=mf / total if total else 0.0,
        step_time_bound_s=bound,
        roofline_frac=achieved / peak_flops,
        suggestion=_SUGGEST[dominant.replace("_s", "")],
    )


def to_markdown(rows: list) -> str:
    hdr = ("| arch | cell | mesh | compute | memory | collective | "
           "bound | peak GB/rank | fits | useful | roofline |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['cell']} | — | — | — | — | "
                       f"skip: {r['skipped']} | — | — | — | — |\n")
            continue
        t = r["terms"]
        out.append(
            f"| {r['arch']} | {r['cell']} | {r['mesh']} "
            f"| {t['compute_s'] * 1e3:.1f} ms "
            f"| {t['memory_s'] * 1e3:.1f} ms "
            f"| {t['collective_s'] * 1e3:.1f} ms | **{r['dominant']}** "
            f"| {r['memory']['peak_device_bytes']/1e9:.2f} "
            f"| {r.get('fits')} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac'] * 100:.1f}% "
            "|\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="in_dir", default="build/dryrun")
    ap.add_argument("--out", default="build/roofline.md")
    ap.add_argument("--json-out", default="build/roofline.json")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(glob.glob(os.path.join(args.in_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("kind") == "simulate":
            continue       # flywire records carry their own analysis
        rows.append(analyse_record(rec))
    md = to_markdown(rows)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(md)
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(md)


if __name__ == "__main__":
    main()


__all__ = ["H100", "analyse_record", "analytic_traffic", "main",
           "model_flops", "to_markdown"]
