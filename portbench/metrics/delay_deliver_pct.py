"""delay_deliver_pct: the share of the traced stretch's summed device
time that the delay_event engine's delivery kernel took (its spikes'
fan-out added into the pending ring at each synapse's delay).  None where
the kernel did not run."""


def read(rec):
    st = rec["stretch"]
    if st is None or not st["device_s"]:
        return None
    secs = [s for name, s in st["device_ops"] if "delay_deliver" in name]
    if not secs:
        return None
    return 100.0 * sum(secs) / st["device_s"]
