"""forward_device_ms: device busy time per sweep batch in the traced spans
(the union of kernel and copy intervals), in ms."""

def read(rec):
    t = rec.get("trace") or {}
    return 1e3 * t["busy_s"] / t["steps"] if t.get("steps") else None
