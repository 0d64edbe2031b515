"""batch_p95_ms: the 95th percentile over the traced run's batches of the
time from the pipeline taking a batch from the loader to that batch's poses
on the host (the program's ``pose_extract`` span), in ms: the end-to-end
tail, read per layer where the host paces it. The traced spans' drains are
in it."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
