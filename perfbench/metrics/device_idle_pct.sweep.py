"""device_idle_pct.sweep: the share of the traced spans in which no
kernel, copy or fill ran on the device, in %."""

def read(rec):
    t = rec.get("trace") or {}
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t.get("window_s") else None
