"""launches_per_step: device activities (kernels, copies, sets) the
profiler recorded in the traced stretch, over its steps."""


def read(rec):
    st = rec["stretch"]
    if st is None or not st["device_events"]:
        return None
    return st["device_events"] / rec["steps"]
