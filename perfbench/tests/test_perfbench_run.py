"""A run from end to end: ``run.py`` refuses to run without a card; on the
CPU at a small size, past the look for a card, every fault the cells can
have in their timed path turns ``correct`` false, and the sweeps' control
(the reference one precision lower) reads farther from the reference than
the program. The ``cuda`` cases repeat a run and the sweeps' control at
the cells' own sizes on the card."""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import calibrate
from perfbench.harness import cell as C
from perfbench.tests.conftest import SMALL

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77  # larger than 32 signed bits hold, as a run's seed may be


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "3d3d-sweep",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def limits_from(readings: dict, cell_name: str) -> dict:
    """The cell's compared numbers, with limits that a sound small run
    passes with room: 1.5 times its readings."""
    return {k: 1.5 * readings[k] + 1e-6 for k in C.load_cell(cell_name)["limits"]}


@pytest.mark.parametrize("fault", ["altered", "half_missing"])
def test_every_fault_turns_correct_false(fault):
    sound = C.run("3d3d-sweep", SEED, 1.0, False, device="cpu", overrides=SMALL, readings=True,
                  limits={})
    limits = limits_from(sound["readings"], "3d3d-sweep")
    again = C.run("3d3d-sweep", SEED, 1.0, False, device="cpu", overrides=SMALL, limits=limits)
    assert again["correct"], again["checks"]
    r = C.run("3d3d-sweep", SEED, 1.0, False, device="cpu", overrides=SMALL, fault=fault,
              limits=limits)
    assert not r["correct"], (fault, r["checks"])


@pytest.mark.parametrize("cell_name,number", [("3d3d-sweep", "rot_median_deg"),
                                              ("fusion-sweep", "rot_median_deg")])
def test_the_control_reads_farther_than_the_program(cell_name, number):
    program = C.run(cell_name, SEED, 1.0, False, device="cpu", overrides=SMALL, readings=True,
                    limits={})["readings"][number]
    control = calibrate.control(cell_name, SEED, torch.device("cpu"), SMALL)[number]
    assert control > 2 * program


def test_result_line_has_the_contract_keys():
    r = C.run("3d3d-sweep", SEED, 1.0, False, device="cpu", overrides=SMALL)
    line = json.loads(json.dumps(r))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {"sweep_poses_per_s.host", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["3d3d-sweep", "fusion-sweep"])
def test_the_control_fails_the_cell_on_the_card(card, cell_name):
    readings = calibrate.control(cell_name, SEED, card)
    limits = C.load_cell(cell_name)["limits"]
    assert not C.compare(readings, limits)[0], readings


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "3d3d-sweep",
                           "--seed", str(SEED), "--seconds", "3", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
