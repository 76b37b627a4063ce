"""The comparison that decides ``correct``.

Every experiment the window completed is held against the plain
reference run of the same lane seeds, lane by lane and neuron by neuron
(in a cell of more than ``CHECK_LANES`` lanes, on that many lanes drawn
from the run's seed: the lanes are independent, and the reference's time
grows with the lanes it runs):

* ``count_mismatch``: lane-neurons whose spike count differs;
* ``state_mismatch``: lane-neurons whose final v, g or refractory
  countdown differs in any bit;
* ``dropped``: synapse events the program reports dropped (the engine is
  exact: none may be).

The comparison is exact, so each limit is 0: the program's Q19.12 path
is integer arithmetic, and its float32 path sums integer weights (exact
in any order) and rounds every operation as the reference does.
"""

from __future__ import annotations

import torch

LIMITS = {"count_mismatch": 0, "state_mismatch": 0, "dropped": 0}
CHECK_LANES = 64


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare(results: list, ref, lanes=None) -> tuple[dict, int]:
    """``results``: (counts, dropped, v, g, refrac) of each experiment;
    ``ref``: the reference's :class:`~portbench.reference.sim.Result` for
    the program's ``lanes`` (all of them by default), in that order.
    Returns the numbers summed over the experiments, and how many
    experiments failed one."""
    out = {k: 0 for k in LIMITS}
    failed = 0
    for result in results:
        if lanes is not None:
            idx = torch.as_tensor(lanes, device=result[0].device)
            result = [x.index_select(0, idx) for x in result]
        counts, dropped, v, g, refrac = result
        before = dict(out)
        out["count_mismatch"] += int((counts.to(ref.counts.device)
                                      != ref.counts).sum())
        state = torch.zeros_like(ref.counts, dtype=torch.bool)
        for a, b in ((v, ref.v), (g, ref.g), (refrac, ref.refrac)):
            state |= _bits(a.to(b.device)) != _bits(b)
        out["state_mismatch"] += int(state.sum())
        out["dropped"] += int(dropped.sum())
        failed += any(out[k] > before[k] for k in out)
    return out, failed


def verdict(numbers: dict, compared: int) -> tuple[bool, dict]:
    checks = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    correct = compared > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)
    return correct, checks
