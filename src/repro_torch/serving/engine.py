"""Batched serving engine: slot-based continuous batching over the
prefill/decode API.

Counterpart of ``repro/serving/engine.py``.  A fixed pool of B decode
slots shares one KV cache (a list of ``{"k", "v"}`` ``[B, Hkv, max_len,
D]`` per layer) on the parameters' device.  Requests are prefilled one at
a time (the request's kv is copied into its slot) and then decoded jointly:
each :meth:`ServingEngine.step` advances every live slot by one token.
Finished slots (EOS or length limit) are recycled.  Slot positions, the
scatter, the truncation rule and the counters behind :meth:`stats` are the
reference's; the cache is updated in place rather than copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import decode_step, init_cache, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int
    max_new: int = 32
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False       # run() hit max_steps with this in flight


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 256
    eos_id: int = -1              # -1: never stop early


class ServingEngine:
    def __init__(self, params, cfg, serve_cfg: ServeConfig):
        self.params = params
        self.cfg = cfg
        self.sc = serve_cfg
        self.device = params.embed.device
        B, L = serve_cfg.batch_slots, serve_cfg.max_len
        self.cache = init_cache(cfg, B, L, device=self.device)
        self.pos = np.zeros(B, dtype=np.int32)          # per-slot write pos
        self.live: list[Optional[Request]] = [None] * B
        # always-on accounting, as the reference's engine keeps it
        self.metrics = obs.MetricsRegistry()
        self._queue_depth = 0          # pending requests at last run() tick
        self._decode = obs.InstrumentedCall(
            lambda p, c, t, pos: decode_step(p, c, t, pos, cfg),
            "serving.decode", self.metrics)
        self._prefill1 = obs.InstrumentedCall(
            lambda p, b: prefill(p, b, cfg, L), "serving.prefill",
            self.metrics)

    def stats(self) -> dict:
        """Point-in-time snapshot: queue/slot occupancy plus the
        cumulative admission, decode, and compile-cache counters."""
        c = self.metrics.counters()
        live = sum(r is not None for r in self.live)
        cache = self.metrics.compile_snapshot()
        return {
            "slots_live": live,
            "slots_free": self.sc.batch_slots - live,
            "queue_depth": self._queue_depth,
            "admitted": int(c.get("serving.admitted", 0)),
            "rejected": int(c.get("serving.rejected", 0)),
            "decode_steps": int(c.get("serving.decode_steps", 0)),
            "tokens_generated": int(c.get("serving.tokens", 0)),
            "truncated": int(c.get("serving.truncated", 0)),
            "compile_cache": {"hits": cache["hits"],
                              "misses": cache["misses"]},
        }

    # -- slot management ---------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.live):
            if r is None:
                return i
        return None

    @torch.inference_mode()
    def add_request(self, req: Request) -> bool:
        slot = self._free_slot()
        if slot is None:
            self.metrics.inc("serving.rejected")
            return False
        self.metrics.inc("serving.admitted")
        # prefill the single request, then copy its cache into the slot
        tokens = torch.from_numpy(np.asarray(req.prompt, dtype=np.int64))
        batch = {"tokens": tokens[None].to(self.device)}
        logits, rcache = self._prefill1(self.params, batch)
        req.out.append(int(torch.argmax(logits[0])))
        for slots, one in zip(self.cache, rcache):
            for name, leaf in slots.items():
                ax = _batch_axis(leaf.shape, one[name].shape,
                                 self.sc.batch_slots)
                leaf.narrow(ax, slot, 1).copy_(one[name])
        self.pos[slot] = len(req.prompt)
        self.live[slot] = req
        return True

    # -- decode ------------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One joint decode step across all live slots; returns the
        requests whose slot finished (EOS / length limit) this step."""
        if not any(r is not None for r in self.live):
            return []
        B = self.sc.batch_slots
        toks = np.zeros(B, dtype=np.int64)
        for i, r in enumerate(self.live):
            if r is not None:
                toks[i] = r.out[-1]
        # per-slot positions: each live slot writes kv at its own pos
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos).to(self.device))
        self.metrics.inc("serving.decode_steps")
        nxt = torch.argmax(logits, -1).cpu().numpy()
        finished: list[Request] = []
        for i, r in enumerate(self.live):
            if r is None:
                continue
            self.metrics.inc("serving.tokens")
            r.out.append(int(nxt[i]))
            self.pos[i] += 1
            if (len(r.out) >= r.max_new or
                    int(nxt[i]) == self.sc.eos_id or
                    self.pos[i] >= self.sc.max_len - 1):
                r.done = True
                self.live[i] = None
                finished.append(r)
        return finished

    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Serve a workload; returns ALL submitted requests in completion
        order.  A request still in flight or still queued when
        ``max_steps`` runs out comes back with ``truncated=True``."""
        pending = list(requests)
        done: list[Request] = []
        steps = 0
        while (pending or any(r is not None for r in self.live)) \
                and steps < max_steps:
            while pending and self._free_slot() is not None:
                self.add_request(pending.pop(0))
            self._queue_depth = len(pending)
            done.extend(self.step())
            steps += 1
        leftover = [r for r in self.live if r is not None] + pending
        for r in leftover:
            r.truncated = True
            self.metrics.inc("serving.truncated")
        self.live = [None] * self.sc.batch_slots
        self._queue_depth = 0
        return done + leftover


def _batch_axis(slot_shape, one_shape, batch_slots) -> int:
    """The batch axis of a cache leaf: the first axis of size
    ``batch_slots`` in the slot cache and 1 in the single-request one."""
    for ax, (a, b) in enumerate(zip(slot_shape, one_shape)):
        if a == batch_slots and b == 1:
            return ax
    for ax, (a, b) in enumerate(zip(slot_shape, one_shape)):
        if a != b:
            return ax
    raise ValueError(f"no batch axis in {slot_shape} vs {one_shape}")


__all__ = ["Request", "ServeConfig", "ServingEngine"]
