"""One run of one cell: find the cell's configuration, traffic mix, limits
and metrics by name, run the mix's driver, and assemble the result line.

Everything that belongs to one configuration, mix or metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it:
``perfbench/configs/<config>.json`` (the settings as run, and the reference
module that implements them), ``perfbench/traffic/<mix>.json`` (the
generator's parameters and the driver that runs the window),
``perfbench/limits/<cell>.json`` (the limit of each number the check
compares) and ``perfbench/metrics/<metric>.py`` (a reader of the traced
run's record).

A metric's name may carry a variant after a dot: ``sweep_poses_per_s.host``
is ``sweep_poses_per_s`` in the cells that its entry lists, held to a bound
of its own. A metric is read by the reader, or taken from the driver's
end-to-end value, of the longest dotted prefix of its name that has one.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "mapfree_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: dict | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and metric entries."""
    bench = benchmark or read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    conf_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "name": name, "chips": int(cell["chips"]),
        "config": read_json(ROOT / conf_entry["file"]),
        "mix": read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json"),
        "limits": read_json(BENCH_DIR / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def program_cfg(config: dict, overrides: dict | None = None):
    """The system's config node: its defaults, then the configuration's
    settings (dotted keys), then ``overrides`` (the tests' small sizes)."""
    from mapfree_tpu_torch.config import cfg as default_cfg

    cfg = default_cfg.clone()
    for key, value in {**config["settings"], **(overrides or {})}.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def reference_module(config: dict):
    return importlib.import_module(f"perfbench.reference.{config['reference']['module']}")


def base_name(metric: str, known) -> str:
    """The longest dotted prefix of ``metric`` that is in ``known``."""
    name = metric
    while name not in known and "." in name:
        name = name.rsplit(".", 1)[0]
    if name not in known:
        raise KeyError(f"nothing reads the metric {metric!r}")
    return name


def load_reader(metric: str):
    readers = {p.stem for p in (BENCH_DIR / "metrics").glob("*.py")}
    path = BENCH_DIR / "metrics" / f"{base_name(metric, readers)}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Top-level names of ``sys.modules`` that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED_MODULES))


class WindowTimes:
    """The ``times`` object the sweep hands to ``predict``: the program
    opens a span at each stage (``load_wait``, ``h2d``, ``transfer_wait``,
    ``dispatch``, ``d2h_wait``, ``pose_extract``); each call's seconds are
    kept, and after each batch's pose extraction (its poses are on the
    host) its time is stamped and ``on_batch`` called."""

    def __init__(self, on_batch=None):
        self.per_call = defaultdict(list)
        self.done = []
        self.on_batch = on_batch

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        self.per_call[name].append(t1 - t0)
        if name == "pose_extract":
            self.done.append(t1)
            if self.on_batch is not None:
                self.on_batch()


def settle() -> None:
    """Just before a window opens: collect the set-up's garbage and freeze
    what is left, so that the window's collections scan only its own
    objects."""
    gc.collect()
    gc.freeze()


def free_device():
    import torch

    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Context:
    """What a driver gets: the cell, the program's config, the seed, the
    window's length, the tracer, the device and the planted fault of a
    test (None in a benchmark run)."""

    def __init__(self, cell, seed, seconds, tracer, device, overrides=None, fault=None,
                 t_start=None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.tracer, self.device, self.fault = tracer, device, fault
        self.config, self.mix = cell["config"], cell["mix"]
        self.cfg = program_cfg(self.config, overrides)
        self.reference = reference_module(self.config)
        self.ref_args = self.reference.arguments({**self.config["settings"], **(overrides or {})})
        self.t_start = time.perf_counter() if t_start is None else t_start


def compare(readings: dict, limits: dict) -> tuple:
    """(every compared number within its limit, {name: {"value", "limit"}}):
    the cell's limits file names the readings that are compared. A number
    that is not finite fails."""
    import math

    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        overrides=None, fault=None, t_start=None, benchmark=None, readings=False,
        limits=None) -> dict:
    """Run cell ``name`` once; returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
    traced, ``checks``), and with ``readings`` every reading of the check
    under ``readings``. ``overrides``, ``fault`` and ``limits`` (in place of
    the cell's) are the tests': small sizes, a planted fault, limits for
    them."""
    import torch

    from perfbench.harness.trace import Tracer, breakdown

    cell = load_cell(name, benchmark)
    tracer = Tracer(trace, cell["mix"]["trace"])
    ctx = Context(cell, seed, seconds, tracer, torch.device(device), overrides, fault, t_start)
    driver = importlib.import_module(f"perfbench.harness.{cell['mix']['driver']}")
    out = driver.run(ctx)
    ok, checks = compare(out["numbers"], cell["limits"] if limits is None else limits)
    rec = out["record"]
    if trace:
        rec["trace"] = tracer.totals()
        metrics = {}
        for m in cell["per_layer"]:
            value = load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = out["end_to_end"]
        metrics = {m["name"]: {"value": e2e[base_name(m["name"], e2e)], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": ok and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = breakdown(t)
    if readings:
        result["readings"] = out["numbers"]
    result["checks"] = checks
    return result
