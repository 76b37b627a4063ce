"""The comparison that decides ``correct``.

Every experiment the window completed is held against the plain
reference run of the same lane seeds, lane by lane and neuron by neuron
(in a cell of more than ``CHECK_LANES`` lanes, on that many lanes drawn
from the run's seed: the lanes are independent, and the reference's time
grows with the lanes it runs):

* ``count_mismatch``: lane-neurons whose spike count differs;
* ``state_mismatch``: lane-neurons where any bit of any field of the
  final state differs (a field is ``[B, n, ...]``; the family's
  ``STATE`` names the fields, in the program's order);
* ``dropped``: synapse events the program reports dropped (the engine is
  exact: none may be).

The comparison is exact, so each limit is 0: the program's Q19.12 path
is integer arithmetic, and its float32 path sums integer weights (exact
in any order) and rounds every operation as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LIMITS = {"count_mismatch": 0, "state_mismatch": 0, "dropped": 0}
CHECK_LANES = 64


class Result(NamedTuple):
    """What a family's plain reference returns."""
    counts: torch.Tensor    # [B, n] spike counts
    dropped: torch.Tensor   # [B]
    state: tuple            # the final state, fields [B, n, ...]
    stats: dict | None      # per-step counts for the least-work count


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


def _differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, n]: lane-neurons where any bit of field ``a`` differs from
    ``b`` (all of them where the two differ in shape or type)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return torch.ones(b.shape[:2], dtype=torch.bool, device=b.device)
    diff = _bits(a.to(b.device)) != _bits(b)
    return diff.reshape(diff.shape[0], diff.shape[1], -1).any(dim=-1)


def compare(results: list, ref: Result, names, lanes=None,
            by_field: dict | None = None) -> tuple[dict, int]:
    """``results``: (counts, dropped, state) of each experiment;
    ``ref``: the reference's :class:`Result` for the program's ``lanes``
    (all of them by default), in that order; ``names``: the family's
    ``STATE``, whose length both sides' states must have.  Returns the
    numbers summed over the experiments, and how many experiments failed
    one; ``by_field`` (a dict), if given, gathers each field's count of
    mismatching lane-neurons under its name."""
    if len(ref.state) != len(names):
        raise ValueError(f"the reference's state has {len(ref.state)} "
                         f"fields; STATE names {list(names)}")
    out = {k: 0 for k in LIMITS}
    failed = 0
    for counts, dropped, state in results:
        if len(state) != len(names):
            raise ValueError(f"the program's state has {len(state)} "
                             f"fields; STATE names {list(names)}")
        if lanes is not None:
            idx = torch.as_tensor(lanes, device=counts.device)
            counts, dropped = counts.index_select(0, idx), \
                dropped.index_select(0, idx)
            state = [x.index_select(0, idx.to(x.device)) for x in state]
        before = dict(out)
        out["count_mismatch"] += int((counts.to(ref.counts.device)
                                      != ref.counts).sum())
        bad = torch.zeros(ref.counts.shape[:2], dtype=torch.bool,
                          device=ref.counts.device)
        for name, a, b in zip(names, state, ref.state):
            diff = _differs(a, b)
            if by_field is not None:
                by_field[name] = by_field.get(name, 0) + int(diff.sum())
            bad |= diff.to(bad.device)
        out["state_mismatch"] += int(bad.sum())
        out["dropped"] += int(dropped.sum())
        failed += any(out[k] > before[k] for k in out)
    return out, failed


def verdict(numbers: dict, compared: int) -> tuple[bool, dict]:
    checks = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    correct = compared > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)
    return correct, checks
