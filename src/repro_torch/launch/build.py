"""(arch x shape cell x mesh) -> the step one rank of the port runs, with
its inputs as meta tensors and the reference's shardings as specs.

Counterpart of ``repro/launch/build.py``, used by
:mod:`repro_torch.launch.dryrun` and the tests.  The reference builds a
jit-ready function with abstract inputs and ``NamedSharding`` s, and
lowers and compiles it for the whole mesh.  The port has no compiler to
hand a mesh to: a :class:`BuiltStep` holds

* the reference's view: ``in_avals`` (the global inputs, meta tensors)
  and ``in_shardings`` / ``out_shardings`` as
  :class:`repro_torch.parallel.sharding.Spec` trees, from which
  :func:`analytic_bytes` computes each rank's resident bytes;
* the port's view: ``fn(*rank_inputs)``, the step that rank 0 of the
  mesh runs, on the inputs it holds, and :func:`count_step`, which runs
  it under :func:`repro_torch.launch.hlo.count` (the counterpart of
  ``lower_and_compile``).

What the port runs (``meta["execution"]``):

* ``train``: the sharded train step (``make_train_step(..., mesh=)``, its
  state from ``init_train_state(..., mesh=)``) on a
  :class:`repro_torch.launch.hlo.CountingMesh`: the rank holds its shards
  of the parameters and moments, gathers the full parameters for the
  step, runs its rows of the batch and all-reduces the gradients over
  the data axes;
* ``prefill`` / ``decode``: the unsharded ``prefill`` / ``decode_step``
  on the rank's rows of the batch (and of the cache) with the full
  parameters: the port has no sharded serving and no tensor-parallel
  split, so a rank along ``model`` repeats the same work.

``donate_argnums`` has no counterpart (eager mode donates nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import (SHAPES, cache_specs, cell_supported,
                                        input_specs)
from repro_torch.launch import hlo
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.model import _abstract_module, module_param_axes
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           Spec, make_param_shardings,
                                           shard_index)
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import named_tensors

EXECUTION = {
    "train": "sharded train step: shards of the parameters and moments, "
             "the full parameters gathered on every rank, the batch's "
             "rows over the data axes, gradients all-reduced over them",
    "prefill": "unsharded prefill on the rank's rows of the batch with the "
               "full parameters (no sharded serving, no tensor-parallel "
               "split)",
    "decode": "unsharded decode step on the rank's rows of the batch and "
              "cache with the full parameters (no sharded serving, no "
              "tensor-parallel split)",
}

META = torch.device("meta")


class BuiltStep(NamedTuple):
    fn: Any                 # fn(*rank_inputs): rank 0's step
    in_avals: tuple         # the global inputs (meta tensors)
    in_shardings: tuple     # their Spec trees
    kind: str
    meta: dict
    policy: dict            # activation policy (repro_torch.parallel.act)
    out_shardings: Any = None
    rank_inputs: tuple = ()  # what rank 0 holds: fn's arguments


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _n_dp(mesh) -> int:
    sizes = _mesh_sizes(mesh)
    return math.prod(sizes[a] for a in _dp_axes(mesh))


def _act_policy(mesh, cfg, cell: str) -> dict:
    """Activation-sharding policy for this (cfg, cell, mesh)."""
    dp, n_dp = _dp_axes(mesh), _n_dp(mesh)
    model_n = _mesh_sizes(mesh).get("model", 1)
    B = SHAPES[cell]["batch"]
    bax = dp if (dp and B % n_dp == 0) else None
    policy = {"residual": Spec(bax, None, None),
              "moe_buf": Spec(bax, None, None, None)}
    if model_n > 1 and cfg.vocab % model_n == 0:
        policy["logits"] = Spec(bax, None, "model")
    return policy


def _logits_sharding(mesh, cfg, B) -> Spec:
    dp, n_dp = _dp_axes(mesh), _n_dp(mesh)
    model_n = _mesh_sizes(mesh).get("model", 1)
    bax = dp if (dp and B % n_dp == 0) else None
    vax = "model" if (model_n > 1 and cfg.vocab % model_n == 0) else None
    return Spec(bax, vax)


def _batch_spec(mesh, x: torch.Tensor) -> Spec:
    dp, n_dp = _dp_axes(mesh), _n_dp(mesh)
    if x.dim() == 0 or not dp or x.shape[0] % n_dp != 0:
        return Spec()
    return Spec(dp, *([None] * (x.dim() - 1)))


def _shard_batch_tree(mesh, tree: dict) -> dict:
    """Leading-dim data-parallel specs for a batch dict."""
    return {k: _batch_spec(mesh, x) for k, x in tree.items()}


# decode-cache sharding strategy: "auto" (heads if divisible, else
# sequence) or "heads_padded" (always the kv-heads dim, padded where it
# does not divide), as the reference's
CACHE_MODE = "auto"


def _cache_sharding(mesh, shape: tuple) -> Spec:
    """The reference's KV/state cache spec of a leaf of ``shape`` (with a
    leading repeats dim where the reference stacks the scanned layers):
    the batch dim over the data axes, then the first model-divisible dim
    after it over ``model``; an unshardable batch (long_500k, B = 1) puts
    every mesh axis on the longest divisible dim."""
    sizes = _mesh_sizes(mesh)
    model_n = sizes.get("model", 1)
    dp, n_dp = _dp_axes(mesh), _n_dp(mesh)
    spec = [None] * len(shape)
    batch_dim = None
    for i in (1, 0):
        if i < len(shape) and dp and shape[i] % n_dp == 0 \
                and shape[i] >= n_dp:
            batch_dim = i
            break
    if batch_dim is not None:
        spec[batch_dim] = dp
        if model_n > 1:
            if (CACHE_MODE == "heads_padded" and len(shape) >= batch_dim + 3
                    and shape[batch_dim + 1] > 1):
                spec[batch_dim + 1] = "model"
                return Spec(*spec)
            for j in range(batch_dim + 1, len(shape)):
                if shape[j] % model_n == 0 and shape[j] >= model_n:
                    spec[j] = "model"
                    break
        return Spec(*spec)
    total = n_dp * model_n
    dims = sorted(range(1, len(shape)), key=lambda j: -shape[j])
    for j in dims:
        if shape[j] % total == 0 and shape[j] >= total:
            spec[j] = dp + ("model",) if dp else "model"
            return Spec(*spec)
    for j in dims:
        if model_n > 1 and shape[j] % model_n == 0 and shape[j] >= model_n:
            spec[j] = "model"
            break
    return Spec(*spec)


def cache_shardings(mesh, cache, cfg):
    """The specs of the port's per-layer cache (a list of per-layer dicts;
    enc-dec: ``{"self", "cross"}`` lists), each the reference's spec of
    the same leaf: where the reference stacks a layer's leaf on a leading
    repeats dim (the scanned pattern repeats; every enc-dec decoder
    layer), the spec of the stacked shape without that dim."""
    def layer(leaves: dict, repeats):
        out = {}
        for k, t in leaves.items():
            if repeats:
                spec = _cache_sharding(mesh, (repeats,) + tuple(t.shape))
                out[k] = Spec(*spec[1:])
            else:
                out[k] = _cache_sharding(mesh, tuple(t.shape))
        return out
    if cfg.is_encdec:
        return {part: [layer(c, cfg.n_layers) for c in cache[part]]
                for part in ("self", "cross")}
    pat = len(cfg.block_pattern)
    n_rep = cfg.n_layers // pat
    return [layer(c, n_rep if i < n_rep * pat else None)
            for i, c in enumerate(cache)]


def default_microbatches(arch: str, cell: str) -> int:
    """The reference's activation-memory heuristic: scan residuals per
    rank ~ L x B_loc / M x S x d_model x 2 B must sit well under the
    device's memory after the parameters and the optimizer state."""
    big = {"grok-1-314b": 16, "llava-next-34b": 16, "command-r-35b": 16,
           "llama4-scout-17b-a16e": 8, "qwen2.5-14b": 8, "gemma3-12b": 8,
           "phi3-medium-14b": 8}
    return big.get(arch, 4)


def optimizer_state_dtype(arch: str):
    """bfloat16 moments for grok-1 (314B parameters at 12 bytes each do
    not fit 256 ranks of the reference's layout otherwise), float32
    elsewhere: the reference's choice, kept so the layouts compare."""
    return torch.bfloat16 if arch == "grok-1-314b" else torch.float32


def _rows(mesh, x: torch.Tensor, coords: dict) -> torch.Tensor:
    """A fresh meta tensor of rank ``coords``'s rows of ``x``."""
    idx = shard_index(x.shape, _batch_spec(mesh, x), mesh, coords)
    return x[idx].clone() if x.dim() else x.clone()


def build_step(arch: str, cell: str, mesh,
               rules: ShardingRules = DEFAULT_RULES,
               microbatches: int = 0, smoke: bool = False,
               overrides: dict | None = None) -> BuiltStep:
    """The step of one (arch, cell) on a mesh layout
    (:func:`repro_torch.launch.mesh.mesh_layout`,
    :func:`~repro_torch.launch.mesh.make_production_mesh`), for rank 0.
    Outside ``smoke``, the production dtypes: bfloat16 compute, bfloat16
    serving weights and no remat for prefill / decode."""
    cfg = get_config(arch, smoke=smoke)
    spec = SHAPES[cell]
    kind = spec["kind"]
    ok, why = cell_supported(cfg, cell)
    if not ok:
        raise ValueError(f"{arch} x {cell} unsupported: {why}")
    over = {}
    if not smoke:
        over = {"compute_dtype": torch.bfloat16}
        if kind in ("prefill", "decode"):
            over.update(param_dtype=torch.bfloat16, remat=False)
    over.update(overrides or {})
    if over:
        cfg = dataclasses.replace(cfg, **over)

    module = _abstract_module(cfg)
    # detached: the sharded state releases the module's own values
    aparams = {k: t.detach() for k, t in named_tensors(module).items()}
    param_sh, fallbacks = make_param_shardings(
        mesh, module_param_axes(module), aparams, rules)
    coords = {a: 0 for a in mesh.axis_names}
    meta = {"arch": arch, "cell": cell, "kind": kind,
            "mesh": _mesh_sizes(mesh),
            "sharding_fallbacks": [f"{n}:{d}%{a}={s}"
                                   for (n, d, a, s) in fallbacks],
            "compute_dtype": str(cfg.compute_dtype or cfg.param_dtype
                                 ).replace("torch.", ""),
            "backend": "nccl", "execution": EXECUTION[kind]}
    policy = _act_policy(mesh, cfg, cell)
    ins = input_specs(cfg, cell, smoke_scale=smoke)

    if kind == "train":
        if microbatches <= 0:
            microbatches = default_microbatches(arch, cell)
        # the port splits a rank's rows into microbatches (the reference
        # the global batch): at most the rows a rank holds, a divisor
        rows = ins["batch"]["tokens"].shape[0]
        rows //= _n_dp(mesh) if rows % _n_dp(mesh) == 0 else 1
        meta["microbatches_asked"] = microbatches
        microbatches = max(m for m in range(1, min(microbatches, rows) + 1)
                           if rows % m == 0)
        opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000),
                    state_dtype=optimizer_state_dtype(arch))
        cmesh = hlo.CountingMesh(mesh, device=META)
        state = init_train_state(module, opt, mesh=cmesh)
        step = make_train_step(cfg, opt, microbatches=microbatches,
                               mesh=cmesh)
        meta["microbatches"] = microbatches
        meta["opt_state_dtype"] = str(optimizer_state_dtype(arch)).replace(
            "torch.", "")
        return BuiltStep(
            fn=step, in_avals=(aparams, ins["batch"]),
            in_shardings=(param_sh, _shard_batch_tree(mesh, ins["batch"])),
            kind=kind, meta=meta, policy=policy,
            rank_inputs=(state, ins["batch"]))

    if kind == "prefill":
        B = ins["batch"]["tokens"].shape[0]
        S = spec["seq"]
        if smoke:
            S = max(32, S // 512)
        max_len = cfg.dec_max if cfg.is_encdec else S
        rows = {k: _rows(mesh, v, coords) for k, v in ins["batch"].items()}
        # the returned cache: the activations' dtype (RWKV's state float32)
        cache = init_cache(cfg, B, max_len, cfg.compute_dtype
                           or cfg.param_dtype, device=META)
        out_sh = (_logits_sharding(mesh, cfg, B),
                  cache_shardings(mesh, cache, cfg))

        def fn(params, batch):
            return prefill(params, batch, cfg, max_len)
        return BuiltStep(
            fn=fn, in_avals=(aparams, ins["batch"], cache),
            in_shardings=(param_sh, _shard_batch_tree(mesh, ins["batch"])),
            kind=kind, meta=meta, policy=policy, out_shardings=out_sh,
            rank_inputs=(module, rows))

    dtype = cfg.param_dtype if not smoke else torch.float32
    acache = cache_specs(cfg, cell, dtype=dtype, smoke_scale=smoke)
    cache_sh = cache_shardings(mesh, acache, cfg)
    B = ins["tokens"].shape[0]
    tokens = _rows(mesh, ins["tokens"], coords)
    S = spec["seq"] if not smoke else max(32, spec["seq"] // 512)
    rank_cache = init_cache(cfg, tokens.shape[0], S, dtype, device=META)

    def fn(params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos, cfg)
    return BuiltStep(
        fn=fn, in_avals=(aparams, acache, ins["tokens"], ins["pos"]),
        in_shardings=(param_sh, cache_sh, _batch_spec(mesh, ins["tokens"]),
                      Spec()),
        kind=kind, meta=meta, policy=policy,
        out_shardings=(_logits_sharding(mesh, cfg, B), cache_sh),
        rank_inputs=(module, rank_cache, tokens, ins["pos"].clone()))


def _shard_bytes(mesh, x: torch.Tensor, spec: Spec) -> int:
    idx = shard_index(x.shape, spec, mesh, {a: 0 for a in mesh.axis_names})
    n = math.prod(s.stop - s.start for s in idx)
    return n * x.element_size()


def _tree_bytes(mesh, avals, specs) -> int:
    """Each leaf's shard bytes under its spec (the same tree shape: dicts
    and lists)."""
    if isinstance(avals, torch.Tensor):
        return _shard_bytes(mesh, avals, specs)
    if isinstance(avals, dict):
        return sum(_tree_bytes(mesh, avals[k], specs[k]) for k in avals)
    return sum(_tree_bytes(mesh, a, s) for a, s in zip(avals, specs))


def analytic_bytes(built: BuiltStep, mesh) -> dict:
    """Each rank's resident bytes by input category under the reference's
    specs (the shard shapes of :func:`repro_torch.parallel.sharding.
    shard_index`): what the reference's layout holds a rank, beside which
    the counted peak says what the port's step holds."""
    cats = {}
    params, p_sh = built.in_avals[0], built.in_shardings[0]
    cats["params"] = _tree_bytes(mesh, params, p_sh)
    if built.kind == "train":
        state = built.rank_inputs[0]
        # AdamW's step counter, then the moments, sharded as the params
        m_bytes = _tree_bytes(mesh, {k: torch.empty(
            p.shape, dtype=state.opt.m[k].dtype, device=META)
            for k, p in params.items()}, p_sh)
        cats["opt_state"] = 4 + 2 * m_bytes
        cats["batch"] = _tree_bytes(mesh, built.in_avals[1],
                                    built.in_shardings[1])
    elif built.kind == "prefill":
        cats["batch"] = _tree_bytes(mesh, built.in_avals[1],
                                    built.in_shardings[1])
        cats["cache_out"] = _tree_bytes(mesh, built.in_avals[2],
                                        built.out_shardings[1])
    else:
        cats["cache"] = _tree_bytes(mesh, built.in_avals[1],
                                    built.in_shardings[1])
    cats["total"] = sum(cats.values())
    return cats


def count_step(built: BuiltStep) -> hlo.StepCost:
    """Run rank 0's step once under :func:`repro_torch.launch.hlo.count`
    on its meta inputs (resident for the whole call); the counterpart of
    the reference's ``lower_and_compile``.  The inputs are updated in
    place, as the port's step updates them."""
    grad = built.kind == "train"
    with torch.set_grad_enabled(grad), \
            hlo.count("meta", resident=built.rank_inputs) as c:
        built.fn(*built.rank_inputs)
    return c.cost


__all__ = ["BuiltStep", "CACHE_MODE", "EXECUTION", "analytic_bytes",
           "build_step", "cache_shardings", "count_step",
           "default_microbatches", "optimizer_state_dtype"]
