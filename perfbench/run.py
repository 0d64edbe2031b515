"""Run one cell of the benchmark once on the card and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the system (``mapfree_tpu_torch``).
Set-up (the predictor, the weights and the host pool
made from the seed, a warm-up of every shape the window drives) counts as
``setup_s``; then the window runs for ``--seconds``; then the check holds
what the window produced to the plain reference. The last line of standard
output is the result as one JSON object; the compared numbers and their
limits end standard error, after every reading of the check. With ``--trace 1`` the window is profiled
in a few short spans and the line carries the per-layer metrics and a
breakdown instead of the end-to-end metrics.

Fails (no result, exit code not 0) without a CUDA device, with fewer cards
than the cell asks for, or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # one process with few threads: the port's host work is its dispatch loop
    # and numpy packing, and idle intra-op pools only contend with them
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # compile caches at fixed places inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import cell as C

    chips = C.load_cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = C.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", t_start=T_START, readings=True)
    banned = C.banned_modules()
    if banned:
        print(f"perfbench: modules of JAX or the JAX package were imported: {banned}",
              file=sys.stderr)
        return 3
    for name, value in result.pop("readings").items():
        print(f"reading {name}: {value!r}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
