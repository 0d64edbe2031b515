"""h2d_ms: the sweep's host-to-device stage per batch (the program's
``StageTimes`` span ``h2d``: ``RegressionPredictor.transfer_batch`` packing
the batch into pinned memory and starting its copy, on a worker thread),
the median over the traced run's batches, in ms."""

import numpy as np


def read(rec):
    calls = rec.get("stages", {}).get("h2d")
    return 1e3 * float(np.median(calls)) if calls else None
