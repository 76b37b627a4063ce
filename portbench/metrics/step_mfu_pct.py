"""step_mfu_pct: the counted least time of the traced stretch
(``portbench/yardstick.py``) as a share of its wall time: the whole
closed-loop step's share of the card's peak."""


def read(rec):
    st = rec["stretch"]
    if st is None or not st["device_events"] or rec["least_s"] is None:
        return None
    return 100.0 * rec["least_s"] / st["wall_s"]
