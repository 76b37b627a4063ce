"""Connectome container and FlyWire-statistics synthetic generator.

The paper simulates the FlyWire adult Drosophila connectome (139,255 neurons,
~15M condensed synapses; 50M raw) as a flat irregular graph.  The real parquet
dump is not redistributable offline, so this module provides:

  * :class:`Connectome` — an immutable container with CSR views by target
    (fan-in) and by source (fan-out), plus the summary statistics the paper's
    figures are drawn from (Figs 2, 3).
  * :func:`synthetic_flywire` — a statistics-matched synthetic generator:
    log-normal out-degree with a heavy tail (max fan-out ~9.8k), preferential
    attachment for in-degree (max fan-in ~10.4k), signed integer weights
    dominated by ±1 with outliers up to [-2405, 1897], Dale's law per source
    neuron.

All arrays are numpy on host; the engines build device tensors from these
(see :mod:`repro_torch.core.engines`).  This module is a copy of
``repro/core/connectome.py`` (the port imports nothing of the JAX
package) and is held against it array for array by the tests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np

# Paper constants (Section 3.1)
FLYWIRE_N_NEURONS = 139_255
FLYWIRE_N_SYNAPSES = 15_000_000  # condensed (same-pair synapses merged)
FLYWIRE_MAX_FAN_IN = 10_356
FLYWIRE_MAX_FAN_OUT = 9_783
FLYWIRE_W_MIN = -2405
FLYWIRE_W_MAX = 1897


@dataclasses.dataclass(frozen=True)
class Connectome:
    """Flat irregular synapse graph in target-major CSR plus source-major CSR.

    Attributes:
      n: number of neurons.
      in_indptr:  [n+1] CSR row pointers, target-major (fan-in lists).
      in_indices: [nnz] source neuron id per synapse, grouped by target.
      in_weights: [nnz] integer weight per synapse (signed; excitatory > 0).
      out_indptr / out_indices / out_weights: source-major transpose
        (fan-out lists; out_weights[k] is the weight of the synapse onto
        out_indices[k]).
      out_delays: [nnz] delay in steps (>= 1) of each fan-out synapse, or
        None: the network has the one uniform delay of ``LIFParams.delay``.
        Only the ``delay_event`` engine reads it.

    A network with a delay a synapse may be held source-major alone
    (:func:`from_fanout`, the in_* arrays None): the engines that read the
    target-major lists then cannot build it.
    """

    n: int
    in_indptr: Optional[np.ndarray] = None
    in_indices: Optional[np.ndarray] = None
    in_weights: Optional[np.ndarray] = None
    out_indptr: Optional[np.ndarray] = None
    out_indices: Optional[np.ndarray] = None
    out_weights: Optional[np.ndarray] = None
    out_delays: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        ids = self.in_indices if self.in_indices is not None \
            else self.out_indices
        return int(ids.shape[0])

    @property
    def fan_in(self) -> np.ndarray:
        return np.diff(self.in_indptr)

    @property
    def fan_out(self) -> np.ndarray:
        return np.diff(self.out_indptr)

    def stats(self) -> dict:
        w = self.in_weights
        return {
            "n_neurons": self.n,
            "n_synapses": self.nnz,
            "max_fan_in": int(self.fan_in.max()) if self.nnz else 0,
            "max_fan_out": int(self.fan_out.max()) if self.nnz else 0,
            "mean_fan_in": float(self.fan_in.mean()) if self.nnz else 0.0,
            "w_min": int(w.min()) if self.nnz else 0,
            "w_max": int(w.max()) if self.nnz else 0,
            "frac_w_pm1": float(np.mean(np.abs(w) == 1)) if self.nnz else 0.0,
            "frac_inhibitory": float(np.mean(w < 0)) if self.nnz else 0.0,
        }

    def validate(self) -> None:
        if self.in_indptr is not None:
            assert self.in_indptr.shape == (self.n + 1,)
            assert self.in_indptr[0] == 0 and self.in_indptr[-1] == self.nnz
            assert np.all(np.diff(self.in_indptr) >= 0)
        assert self.out_indptr.shape == (self.n + 1,)
        assert self.out_indptr[-1] == self.nnz
        assert np.all(np.diff(self.out_indptr) >= 0)
        if self.nnz:
            if self.in_indices is not None:
                assert self.in_indices.min() >= 0
                assert self.in_indices.max() < self.n
            assert self.out_indices.min() >= 0
            assert self.out_indices.max() < self.n
        if self.out_delays is not None:
            assert self.out_delays.shape == (self.nnz,)
            assert not self.nnz or self.out_delays.min() >= 1

    def dense(self, dtype=np.float32) -> np.ndarray:
        """Dense [n, n] weight matrix W with W[target, source] — test-scale only."""
        if self.n > 20_000:
            raise ValueError("dense() is for test-scale connectomes only")
        w = np.zeros((self.n, self.n), dtype=dtype)
        tgt = np.repeat(np.arange(self.n), self.fan_in)
        w[tgt, self.in_indices] = self.in_weights.astype(dtype)
        return w


def _transpose_csr(n, indptr, indices, weights):
    """target-major CSR -> source-major CSR (or vice versa)."""
    counts = np.bincount(indices, minlength=n)
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=t_indptr[1:])
    order = np.argsort(indices, kind="stable")
    rows = np.repeat(np.arange(n), np.diff(indptr))
    t_indices = rows[order].astype(indices.dtype)
    t_weights = weights[order]
    return t_indptr, t_indices, t_weights


def from_fanout(n: int, out_indptr, out_indices, out_weights,
                out_delays=None) -> Connectome:
    """A network held source-major alone: fan-out lists (``out_indptr``
    [n+1], ``out_indices`` / ``out_weights`` [nnz]) and optionally each
    synapse's delay in steps (``out_delays`` [nnz], >= 1).  Same-pair
    synapses are kept apart (multapses with their own weights and
    delays), and the arrays are taken as they are, without a copy."""
    c = Connectome(n=int(n), out_indptr=np.asarray(out_indptr),
                   out_indices=np.asarray(out_indices),
                   out_weights=np.asarray(out_weights),
                   out_delays=None if out_delays is None
                   else np.asarray(out_delays))
    c.validate()
    return c


def from_edges(
    n: int, pre: np.ndarray, post: np.ndarray, weight: np.ndarray
) -> Connectome:
    """Build a Connectome from a flat (pre, post, weight) edge table.

    Same-pair duplicates are condensed by summing weights (the paper's
    simplification from 50M raw to ~15M condensed synapses).
    """
    pre = np.asarray(pre, dtype=np.int64)
    post = np.asarray(post, dtype=np.int64)
    weight = np.asarray(weight)
    # Condense duplicates: sort by (post, pre) and segment-sum weights.
    key = post * n + pre
    order = np.argsort(key, kind="stable")
    key_s, pre_s, post_s, w_s = key[order], pre[order], post[order], weight[order]
    uniq_mask = np.empty(key_s.shape, dtype=bool)
    uniq_mask[0:1] = True
    np.not_equal(key_s[1:], key_s[:-1], out=uniq_mask[1:])
    seg_ids = np.cumsum(uniq_mask) - 1
    w_c = np.zeros(int(seg_ids[-1]) + 1 if len(seg_ids) else 0, dtype=np.int64)
    np.add.at(w_c, seg_ids, w_s)
    pre_c = pre_s[uniq_mask]
    post_c = post_s[uniq_mask]
    # target-major CSR
    counts = np.bincount(post_c, minlength=n)
    in_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=in_indptr[1:])
    in_indices = pre_c.astype(np.int32)
    in_weights = w_c.astype(np.int32)
    out_indptr, out_indices, out_weights = _transpose_csr(
        n, in_indptr, in_indices, in_weights
    )
    c = Connectome(
        n=n,
        in_indptr=in_indptr,
        in_indices=in_indices,
        in_weights=in_weights,
        out_indptr=out_indptr,
        out_indices=out_indices.astype(np.int32),
        out_weights=out_weights,
    )
    c.validate()
    return c


def synthetic_flywire(
    n: int = FLYWIRE_N_NEURONS,
    target_synapses: Optional[int] = None,
    seed: int = 0,
    frac_inhibitory: float = 0.30,
    frac_pm1: float = 0.45,
    max_abs_weight_exc: int = FLYWIRE_W_MAX,
    max_abs_weight_inh: int = -FLYWIRE_W_MIN,
) -> Connectome:
    """Generate a synthetic connectome with FlyWire-like statistics.

    Degree model: out-degree ~ LogNormal tuned so mean degree matches
    `target_synapses / n`, clipped to [1, ~0.07n]; targets drawn with
    preferential attachment (in-attractiveness ~ LogNormal(1.0)) producing a
    heavy-tailed in-degree.  Weight model: |w| = 1 with prob `frac_pm1`, else
    1 + Geometric tail scaled into the paper's outlier range.  Dale's law:
    each source is excitatory or inhibitory for all its synapses.
    """
    rng = np.random.default_rng(seed)
    if target_synapses is None:
        target_synapses = int(n * FLYWIRE_N_SYNAPSES / FLYWIRE_N_NEURONS)
    mean_deg = target_synapses / n

    # --- out-degrees: lognormal with heavy tail, mean ~= mean_deg ---
    sigma = 1.1
    mu = np.log(mean_deg) - sigma**2 / 2
    deg = rng.lognormal(mu, sigma, size=n)
    # a few extreme-fan-out outliers (paper: max 9,783 at full scale)
    n_out = max(1, n // 2000)
    hi = min(0.07 * n, FLYWIRE_MAX_FAN_OUT)
    deg[rng.choice(n, n_out, replace=False)] = rng.uniform(0.5 * hi, hi, n_out)
    deg = np.clip(deg, 1, hi).astype(np.int64)
    # trim/pad to the synapse budget
    scale = target_synapses / deg.sum()
    deg = np.maximum(1, (deg * scale).astype(np.int64))
    nnz = int(deg.sum())

    # --- targets: preferential attachment ---
    attract = rng.lognormal(0.0, 1.0, size=n)
    n_in_out = max(1, n // 2000)
    attract[rng.choice(n, n_in_out, replace=False)] *= 40.0  # fan-in outliers
    p = attract / attract.sum()
    pre = np.repeat(np.arange(n, dtype=np.int64), deg)
    post = rng.choice(n, size=nnz, p=p).astype(np.int64)
    # no self-synapses: re-draw collisions cheaply by offsetting
    self_mask = pre == post
    post[self_mask] = (post[self_mask] + 1) % n

    # --- weights ---
    mag = np.ones(nnz, dtype=np.int64)
    tail = rng.random(nnz) >= frac_pm1
    # geometric body (2..~100 dominates) + rare large outliers
    body = 1 + rng.geometric(0.08, size=nnz)
    mag = np.where(tail, body, mag)
    out_mask = rng.random(nnz) < 2e-5
    mag = np.where(out_mask, rng.integers(300, max_abs_weight_exc, size=nnz), mag)
    inhibitory_src = rng.random(n) < frac_inhibitory
    sign = np.where(inhibitory_src[pre], -1, 1)
    w = sign * np.minimum(
        mag, np.where(sign < 0, max_abs_weight_inh, max_abs_weight_exc)
    )
    return from_edges(n, pre, post, w)


def load_flywire_parquet(path: str) -> Connectome:
    """Load the real FlyWire connectivity table (columns: pre_root_id,
    post_root_id, and weight or else syn_count).  The root ids map to
    0..n-1 in ascending order; same-pair rows are condensed by
    :func:`from_edges`.  Needs ``pyarrow`` at run time (imported here
    only)."""
    import importlib

    pq = importlib.import_module("pyarrow.parquet")
    tbl = pq.read_table(path).to_pydict()
    pre_ids = np.asarray(tbl["pre_root_id"])
    post_ids = np.asarray(tbl["post_root_id"])
    w = np.asarray(tbl.get("weight", tbl.get("syn_count")))
    uniq, inv = np.unique(np.concatenate([pre_ids, post_ids]),
                          return_inverse=True)
    pre, post = inv[:len(pre_ids)], inv[len(pre_ids):]
    return from_edges(len(uniq), pre, post, w)


def cache_path(n: int, seed: int, **kw) -> str:
    """Cache filename for a synthetic connectome.

    Any generator kwargs beyond (n, seed) — target_synapses, frac_inhibitory,
    ... — are folded into a digest so differently-parameterized connectomes
    never collide in the cache (kwarg-free calls keep the legacy name).
    The directory is ``$REPRO_CACHE``, else ``build/repro_cache`` in the
    checkout (the reference defaults to ``/tmp/repro_cache``).
    """
    base = f"connectome_{n}_{seed}"
    if kw:
        digest = hashlib.md5(
            repr(sorted(kw.items())).encode()).hexdigest()[:10]
        base += f"_{digest}"
    default = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "..", "build", "repro_cache")
    return os.path.join(os.environ.get("REPRO_CACHE", os.path.normpath(
        default)), base + ".npz")


def synthetic_flywire_cached(n: int, seed: int = 0, **kw) -> Connectome:
    """Disk-cached synthetic connectome.  The cache key covers every
    generator kwarg, not just (n, seed).  Unlike the reference's, the file
    is an uncompressed ``.npz``: at full size, compressing it takes longer
    than generating the network."""
    path = cache_path(n, seed, **kw)
    if os.path.exists(path):
        z = np.load(path)
        return Connectome(n=int(z["n"]), **{
            k: z[k] for k in ("in_indptr", "in_indices", "in_weights",
                              "out_indptr", "out_indices", "out_weights")})
    c = synthetic_flywire(n=n, seed=seed, **kw)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(
        path, n=c.n, in_indptr=c.in_indptr, in_indices=c.in_indices,
        in_weights=c.in_weights, out_indptr=c.out_indptr,
        out_indices=c.out_indices, out_weights=c.out_weights)
    return c
