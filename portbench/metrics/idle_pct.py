"""idle_pct: the share of the traced stretch in which nothing ran on the
device."""


def read(rec):
    st = rec["stretch"]
    if st is None or not st["busy_s"]:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["wall_s"])
