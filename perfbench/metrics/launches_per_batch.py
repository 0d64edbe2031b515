"""launches_per_batch: device kernels (not copies or fills) per sweep
batch in the traced spans."""

def read(rec):
    t = rec.get("trace") or {}
    return t["kernels"] / t["steps"] if t.get("steps") else None
