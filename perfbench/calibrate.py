"""The readings that a cell's limits are set from, in one process on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 5] [--out FILE]

For each of ``--seeds`` one short run of the cell (the program's numbers,
the lower readings); for each of ``--control-seeds`` the control: the
reference computed with its operands rounded to float8 e4m3 (one precision
below the configurations' bfloat16) put in the program's place and
compared with the float32 reference as the program is (the upper readings).
One JSON line per reading on standard output (and in ``--out``)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(name: str, seed: int, device, overrides=None) -> dict:
    """The control's numbers for cell ``name`` at seed ``seed`` (``overrides``:
    the tests' small sizes)."""
    from perfbench.harness import cell as C
    from perfbench.harness import sweep, traffic
    from perfbench.harness.trace import Tracer

    cell = C.load_cell(name)
    ctx = C.Context(cell, seed, 0.0, Tracer(False, {}), device, overrides)
    pool = traffic.make_pool(sweep.shape_of(ctx), ctx.mix, seed, device)
    weights = {k: v.to("cpu", copy=True) for k, v in sweep.make_state(ctx, pool).items()}
    batches = pool[:int(ctx.mix["checked_batches"])]
    ref = sweep.reference_poses(ctx, weights, batches)
    low = sweep.reference_poses(ctx, weights, batches, "fp8_e4m3")
    got = [([R[i] for i in range(R.shape[0])], [t[i] for i in range(t.shape[0])])
           for R, t in low]
    return sweep.pose_numbers(got, ref)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import cell as C

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, **extra):
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "numbers": numbers, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        r = C.run(args.workload, seed, args.seconds, False, device=device, readings=True)
        emit("program", seed, r["readings"],
             correct=r["correct"], failed=r["failed"], seconds=time.perf_counter() - t0,
             metrics={k: v["value"] for k, v in r["metrics"].items()})
        C.free_device()
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        emit("control_fp8_e4m3", seed, control(args.workload, seed, device),
             seconds=time.perf_counter() - t0)
        C.free_device()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
