"""The benchmark's network: a frozen copy of the FlyWire-statistics
generator, and its cache.

``synthetic_flywire`` below is a copy of the program's
``core/connectome.py::synthetic_flywire`` (with ``from_edges`` and the CSR
transpose it needs), frozen here so that no change to the program can
change the network the benchmark runs.  The arrays are handed to the
program as a ``Connectome`` and to the plain reference as they are.

The first run in a checkout generates the network (about a quarter of a
minute at full size) and caches it as an uncompressed ``.npz`` under
``build/portbench/`` in the checkout; later runs load it.
"""

from __future__ import annotations

import os

import numpy as np

FLYWIRE_N_SYNAPSES = 15_000_000
FLYWIRE_N_NEURONS = 139_255
FLYWIRE_MAX_FAN_OUT = 9_783
FLYWIRE_W_MIN = -2405
FLYWIRE_W_MAX = 1897

ARRAYS = ("in_indptr", "in_indices", "in_weights", "out_indptr",
          "out_indices", "out_weights")


def _transpose_csr(n, indptr, indices, weights):
    counts = np.bincount(indices, minlength=n)
    t_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=t_indptr[1:])
    order = np.argsort(indices, kind="stable")
    rows = np.repeat(np.arange(n), np.diff(indptr))
    return t_indptr, rows[order].astype(indices.dtype), weights[order]


def from_edges(n: int, pre, post, weight) -> dict:
    """Condense a (pre, post, weight) edge table (same-pair weights
    summed) into target-major and source-major CSR arrays."""
    pre = np.asarray(pre, dtype=np.int64)
    post = np.asarray(post, dtype=np.int64)
    weight = np.asarray(weight)
    key = post * n + pre
    order = np.argsort(key, kind="stable")
    key_s, pre_s, post_s, w_s = key[order], pre[order], post[order], \
        weight[order]
    uniq = np.empty(key_s.shape, dtype=bool)
    uniq[0:1] = True
    np.not_equal(key_s[1:], key_s[:-1], out=uniq[1:])
    seg = np.cumsum(uniq) - 1
    w_c = np.zeros(int(seg[-1]) + 1 if len(seg) else 0, dtype=np.int64)
    np.add.at(w_c, seg, w_s)
    pre_c, post_c = pre_s[uniq], post_s[uniq]
    in_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(post_c, minlength=n), out=in_indptr[1:])
    in_indices = pre_c.astype(np.int32)
    in_weights = w_c.astype(np.int32)
    out_indptr, out_indices, out_weights = _transpose_csr(
        n, in_indptr, in_indices, in_weights)
    return {"n": n, "in_indptr": in_indptr, "in_indices": in_indices,
            "in_weights": in_weights, "out_indptr": out_indptr,
            "out_indices": out_indices.astype(np.int32),
            "out_weights": out_weights}


def synthetic_flywire(n: int, target_synapses: int, seed: int = 0,
                      frac_inhibitory: float = 0.30, frac_pm1: float = 0.45,
                      max_abs_weight_exc: int = FLYWIRE_W_MAX,
                      max_abs_weight_inh: int = -FLYWIRE_W_MIN) -> dict:
    """Log-normal out-degrees with a few extreme fan-outs, preferential
    attachment for targets, weights of +-1 with a geometric tail and rare
    outliers, Dale's law per source (the program's generator, frozen)."""
    rng = np.random.default_rng(seed)
    mean_deg = target_synapses / n
    sigma = 1.1
    mu = np.log(mean_deg) - sigma**2 / 2
    deg = rng.lognormal(mu, sigma, size=n)
    n_out = max(1, n // 2000)
    hi = min(0.07 * n, FLYWIRE_MAX_FAN_OUT)
    deg[rng.choice(n, n_out, replace=False)] = rng.uniform(0.5 * hi, hi, n_out)
    deg = np.clip(deg, 1, hi).astype(np.int64)
    scale = target_synapses / deg.sum()
    deg = np.maximum(1, (deg * scale).astype(np.int64))
    nnz = int(deg.sum())

    attract = rng.lognormal(0.0, 1.0, size=n)
    n_in_out = max(1, n // 2000)
    attract[rng.choice(n, n_in_out, replace=False)] *= 40.0
    p = attract / attract.sum()
    pre = np.repeat(np.arange(n, dtype=np.int64), deg)
    post = rng.choice(n, size=nnz, p=p).astype(np.int64)
    self_mask = pre == post
    post[self_mask] = (post[self_mask] + 1) % n

    mag = np.ones(nnz, dtype=np.int64)
    tail = rng.random(nnz) >= frac_pm1
    body = 1 + rng.geometric(0.08, size=nnz)
    mag = np.where(tail, body, mag)
    out_mask = rng.random(nnz) < 2e-5
    mag = np.where(out_mask, rng.integers(300, max_abs_weight_exc, size=nnz),
                   mag)
    inhibitory_src = rng.random(n) < frac_inhibitory
    sign = np.where(inhibitory_src[pre], -1, 1)
    w = sign * np.minimum(
        mag, np.where(sign < 0, max_abs_weight_inh, max_abs_weight_exc))
    return from_edges(n, pre, post, w)


def cache_file(cache_dir: str, spec: dict) -> str:
    return os.path.join(cache_dir, "flywire_{n_neurons}_{target_synapses}_"
                        "{seed}.npz".format(**spec))


def load_network(spec: dict, cache_dir: str) -> dict:
    """The network a configuration's ``network`` entry names, from the
    cache or generated (and cached: written to a temporary file in the
    same directory and renamed, so a killed run leaves no torn file)."""
    if spec.get("generator") != "synthetic_flywire":
        raise ValueError(f"unknown network generator {spec.get('generator')!r}")
    path = cache_file(cache_dir, spec)
    if os.path.exists(path):
        with np.load(path) as z:
            return {"n": int(z["n"]), **{k: z[k] for k in ARRAYS}}
    net = synthetic_flywire(int(spec["n_neurons"]),
                            int(spec["target_synapses"]), int(spec["seed"]))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".partial.npz"
    np.savez(tmp, **net)
    os.replace(tmp, path)
    return net


def pick(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` distinct neurons drawn from ``seed`` (the scenarios' choice of
    driven neurons, standing for identified ones)."""
    rng = np.random.default_rng(seed)
    return rng.choice(n, size=min(int(k), n), replace=False)
