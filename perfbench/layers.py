"""One cell's sweep on the card, read by the program's spans: where the
device time, the host's waits and the device's idle time fall, layer by
layer.

    python3 perfbench/layers.py --workload <name> --seed <n> --seconds <s>

From the root of a checkout, as ``perfbench/run.py``. Runs the cell's
window once under the benchmark's traced plan (``harness/trace.py``),
keeping every span the program closes (``mapfree_tpu_torch/utils/
timing.py``) and stamping the host's clock just before each marker kernel,
and reads each traced span's events through them (``harness/spans.py``).
Standard error gets, per batch: the device's idle time by the calling
thread's span (the CUDA-only spans), the device time by the layer that
launched it against the naming span's busy time, the runtime calls that
wait for the device by span and each dispatch's first, and both clocks'
offsets. The last line of standard output is the summary as one JSON
object, with the traced run's kernels and busy time a batch and the host's
time a batch in each network span. The benchmark's own traced run reads
none of this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"
NETWORK = ("to_float", "encoder", "aggregator", "head", "fuse")


def layer_tracer(plan: dict, kept: list):
    """The benchmark's :class:`Tracer`, that also stamps the host's clock
    before each marker kernel and reads each traced span's events against
    the span records in ``kept`` (:func:`spans.reduce_span`) into
    ``layers`` (CUDA-only spans) and ``naming_layers``."""
    import torch

    from perfbench.harness import spans
    from perfbench.harness.trace import Tracer

    class LayerTracer(Tracer):
        def __init__(self):
            super().__init__(True, plan)
            self.marker_ns, self.layers, self.naming_layers = None, [], []

        def step(self):
            if self.prof is not None and self.phase == "warmup" and self.left <= 1:
                # drain here, so that the base class's drain returns at once
                # and the stamp falls just before the marker's launch
                torch.cuda.synchronize()
                self.marker_ns = time.perf_counter_ns()
            super().step()

        def _close(self):
            prof, naming = self.prof, self.naming_span
            super()._close()
            records = spans.closed_since(kept, self.marker_ns)
            layers = spans.reduce_span(prof.events(), records, self.marker_ns, naming)
            if layers:
                layers["steps"] = self.recorded
                (self.naming_layers if naming else self.layers).append(layers)

    return LayerTracer()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from mapfree_tpu_torch.utils import timing
    from perfbench.harness import cell as C
    from perfbench.harness import spans

    if not torch.cuda.is_available():
        print("perfbench: layers.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = C.load_cell(args.workload)
    with timing.recording() as kept:
        tracer = layer_tracer(cell["mix"]["trace"], kept)
        ctx = C.Context(cell, args.seed, args.seconds, tracer, torch.device("cuda:0"),
                        t_start=T_START)
        out = importlib.import_module(f"perfbench.harness.{cell['mix']['driver']}").run(ctx)
    ok, _ = C.compare(out["numbers"], cell["limits"])
    totals = tracer.totals()
    summary = spans.summarise(tracer.layers, tracer.naming_layers)
    steps = totals["steps"]
    window = spans.closed_since(kept, int(1e9 * tracer.t0))  # the warm-up's batches left out
    summary.update(
        correct=ok and out["failed"] == 0,
        kernels_per_batch=totals["kernels"] / steps if steps else None,
        forward_device_ms=1e3 * totals["busy_s"] / steps if steps else None,
        host_ms={name: spans.per_batch_ms(window, name) for name in ("dispatch",) + NETWORK},
        offsets_us=[[r["offset_us"], r["range_offset_us"]] for r in tracer.naming_layers],
        device=torch.cuda.get_device_name(0))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
