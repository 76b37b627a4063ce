"""kernels_roofline: the counted least time of the traced stretch
(``portbench/yardstick.py``) as a share of the summed device time of all
its kernels, copies and sets."""


def read(rec):
    st = rec["stretch"]
    if st is None or not st["device_s"] or rec["least_s"] is None:
        return None
    return 100.0 * rec["least_s"] / st["device_s"]
