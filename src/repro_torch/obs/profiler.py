"""``torch.profiler`` gating for the launcher's ``--profile DIR``.

Counterpart of ``repro/obs/profiler.py``, which wraps a block in
``jax.profiler.trace``.  :func:`profile_trace` wraps a block in
``torch.profiler.profile`` (the CPU activity, and the CUDA activity when
a card is present) and on exit writes the trace as a Chrome trace file,
``<DIR>/trace.json`` (loadable in Perfetto or ``chrome://tracing``).  It
does nothing when ``directory`` is falsy, so call sites can pass the CLI
flag straight through.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(directory):
    if not directory:
        yield
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(str(directory), exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(directory), "trace.json"))


__all__ = ["profile_trace"]
