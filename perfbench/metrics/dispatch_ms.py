"""dispatch_ms: the sweep's dispatch stage per batch (the program's
``StageTimes`` span ``dispatch``: ``RegressionPredictor.dispatch_device``
issuing the forward on the calling thread), the median over the traced
run's batches, in ms."""

import numpy as np


def read(rec):
    calls = rec.get("stages", {}).get("dispatch")
    return 1e3 * float(np.median(calls)) if calls else None
