"""aggregator_dispatch_ms: the host's time per sweep batch in the program's
``aggregator`` stage (``models/regression.py``: the calling thread enqueuing
the unique-reference gather and K1's correlation inside ``dispatch``), the
median over the traced run's batches, in ms."""

import numpy as np


def read(rec):
    calls = rec.get("stages", {}).get("aggregator")
    return 1e3 * float(np.median(calls)) if calls else None
