"""encoder_dispatch_ms: the host's time per sweep batch in the program's
``encoder`` stage (``models/regression.py``: the calling thread enqueuing
the network's encoder, the convolutions and BatchNorm over every image of
the batch, inside ``dispatch``), the median over the traced run's batches,
in ms."""

import numpy as np


def read(rec):
    calls = rec.get("stages", {}).get("encoder")
    return 1e3 * float(np.median(calls)) if calls else None
