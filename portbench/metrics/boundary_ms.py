"""boundary_ms: the supervision layer's cost a chunk boundary.

The mean over the window's chunks of the harness's chunk latency (from
the previous boundary's arrival, or from the ``run_trials`` call for an
experiment's first chunk) minus the ``wall_s`` of the program's own
``chunk`` span: the carry's counters reduced and brought to the host,
the event emitted, and an experiment's start.  Chunks whose latency holds
the profiler's start or stop are left out.
"""


def read(rec):
    chunks = rec["chunks"]
    if not chunks:
        return None
    return 1e3 * sum(lat - wall for lat, wall in chunks) / len(chunks)
