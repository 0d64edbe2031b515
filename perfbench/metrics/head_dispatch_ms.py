"""head_dispatch_ms: the host's time per sweep batch in the program's
``head`` stage (``models/regression.py``: the calling thread enqueuing the
pose head, its residual blocks and the Kabsch solve, inside ``dispatch``),
the median over the traced run's batches, in ms."""

import numpy as np


def read(rec):
    calls = rec.get("stages", {}).get("head")
    return 1e3 * float(np.median(calls)) if calls else None
