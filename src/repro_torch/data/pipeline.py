"""Deterministic, stateless synthetic LM data.

Counterpart of ``repro/data/pipeline.py``.  Batches are a pure function of
(seed, step), so a restarted job regenerates exactly the batches it would
have seen and no data state is checkpointed.  The token stream is an
order-2 Markov chain over the vocabulary (a deterministic transition
backbone with 25% noise), drawn on the host with numpy from the same seed
sequence as the reference's, so the tokens are equal to the reference's,
value for value.  The reference's ``sharding`` argument (each host builds
its own shards) has no counterpart on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


def _tokens_for_slice(seed, step, lo, hi, seq, vocab):
    """[hi-lo, seq+1] deterministic tokens for global rows [lo, hi)."""
    rows = []
    for r in range(lo, hi):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, r]))
        x = np.empty(seq + 1, dtype=np.int64)
        x[0] = rng.integers(vocab)
        noise = rng.integers(0, vocab, size=seq)
        pure = rng.random(seq) < 0.25
        for t in range(seq):
            nxt = (x[t] * 48271 + 13) % vocab       # markov backbone
            x[t + 1] = noise[t] if pure[t] else nxt
        rows.append(x)
    return np.stack(rows).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, device=None):
        """``{"tokens", "labels"}``: int32 [global_batch, seq] on
        ``device`` (default CUDA), the labels the tokens shifted by one."""
        full = torch.from_numpy(_tokens_for_slice(
            self.seed, step, 0, self.global_batch, self.seq, self.vocab))
        full = full.to(resolve_device(device))
        return {"tokens": full[:, :-1], "labels": full[:, 1:]}


def make_global_batch(cfg, shape_cell: dict, step: int, seed=0, device=None):
    ds = SyntheticLM(vocab=cfg.vocab, seq=shape_cell["seq"],
                     global_batch=shape_cell["batch"], seed=seed)
    return ds.batch_at(step, device)


__all__ = ["SyntheticLM", "make_global_batch"]
