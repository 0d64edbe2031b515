"""PyTorch port, the training loop: checkpoints (top-k, eviction,
``topk.json`` across a restart, resume), the fit loop on loaders of numpy
batches, the NaN guard and the host-to-device helpers. The validation step
against the JAX package is in tests/test_torch_val_step_vs_jax.py, a file of
its own so that test workers can run it beside this one."""

import json

import numpy as np
import pytest
import torch

from mapfree_tpu_torch.config import cfg as pt_default_cfg
from mapfree_tpu_torch.models.regression import build_regression_net as pt_build_net
from mapfree_tpu_torch.tools.convert_weights import load_checkpoint
from mapfree_tpu_torch.train import (
    CheckpointManager,
    check_finite_or_die,
    init_state,
    make_train_step,
)
from mapfree_tpu_torch.train import fit as pt_fit
from mapfree_tpu_torch.utils.data import data_to_device, prefetch_to_device

from test_torch_train import make_batch, tiny_cfg, to_torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CHANNELS = {
    "val_loss/R_loss", "val_loss/t_loss", "val_loss/loss",
    "val_metrics/t_ang_err", "val_metrics/t_scale_err",
    "val_metrics/t_euclidean_err", "val_metrics/R_err",
    "val_auc/euc_10", "val_auc/euc_50", "val_auc/euc_100",
    "val_auc/pose_5", "val_auc/pose_10", "val_auc/pose_20",
    "val_auc/rot_5", "val_auc/rot_10", "val_auc/rot_20",
    "val_auc/tang_5", "val_auc/tang_10", "val_auc/tang_20",
    "val_t_scale/a1", "val_t_scale/a2", "val_t_scale/a3",
}


def _state(cfg=None, seed=0):
    cfg = cfg or tiny_cfg(pt_default_cfg)
    net = pt_build_net(cfg)
    return cfg, init_state(net, cfg, torch.Generator().manual_seed(seed), device="cpu")


def test_checkpoint_save_restore_topk(tmp_path):
    cfg, state = _state()
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=2)
    mgr.save(state, step=1, val_loss=3.0)
    state.step = 2
    mgr.save(state, step=2, val_loss=1.0)
    state.step = 3
    mgr.save(state, step=3, val_loss=2.0)
    # top-2 kept: steps 2 (best) and 3; step 1 evicted
    assert mgr.path("step_2").exists() and mgr.path("step_3").exists()
    assert not mgr.path("step_1").exists()
    assert mgr.best_tag() == "step_2"
    # a non-finite validation loss refreshes 'last' only
    mgr.save(state, step=4, val_loss=float("nan"))
    assert not mgr.path("step_4").exists()

    _, fresh = _state(seed=1)
    assert not torch.equal(fresh.net.state_dict()["encoder.firstconv.weight"],
                           state.net.state_dict()["encoder.firstconv.weight"])
    restored = mgr.restore(fresh, tag="last")
    assert restored.step == 3
    for key, value in state.net.state_dict().items():
        assert torch.equal(restored.net.state_dict()[key], value), key
    # the net's part of a checkpoint loads for inference as any state_dict
    net = pt_build_net(cfg)
    load_checkpoint(net, mgr.path("step_2"))
    assert torch.equal(net.state_dict()["head.mlp.4.bias"], state.net.state_dict()["head.mlp.4.bias"])


def test_checkpoint_topk_survives_restart(tmp_path):
    _, state = _state()
    mgr = CheckpointManager(tmp_path / "ckpts", top_k=2)
    mgr.save(state, step=1, val_loss=1.0)
    mgr.save(state, step=2, val_loss=2.0)
    assert json.loads((tmp_path / "ckpts" / "topk.json").read_text()) == [[1.0, 1], [2.0, 2]]

    mgr2 = CheckpointManager(tmp_path / "ckpts", top_k=2)  # a restart
    assert mgr2._best == [(1.0, 1), (2.0, 2)]
    assert mgr2.best_tag() == "step_1"
    mgr2.save(state, step=3, val_loss=3.0)  # a worse step evicts itself
    assert mgr2.path("step_1").exists() and mgr2.path("step_2").exists()
    assert not mgr2.path("step_3").exists()
    mgr2.save(state, step=4, val_loss=0.5)  # a better step evicts the old worst
    assert mgr2.path("step_4").exists() and not mgr2.path("step_2").exists()
    mgr2.path("step_4").unlink()  # stale entries are dropped on load
    assert CheckpointManager(tmp_path / "ckpts", top_k=2)._best == [(1.0, 1)]


def test_optimizer_and_scheduler_state_resume_exactly(tmp_path):
    """Two steps, checkpoint, two more; against restore + two more: equal bits."""
    cfg = tiny_cfg(pt_default_cfg, **{"TRAINING.LR_STEP_INTERVAL": 3,
                                      "TRAINING.LR_STEP_GAMMA": 0.5})
    batches = [to_torch(make_batch(B=4, seed=s)) for s in range(4)]
    _, state = _state(cfg)
    step = make_train_step(state.net, cfg)
    for b in batches[:2]:
        state, _ = step(state, b)
    mgr = CheckpointManager(tmp_path, top_k=1)
    mgr.save(state, step=2)
    for b in batches[2:]:
        state, logs = step(state, b)

    _, other = _state(cfg, seed=5)
    other = mgr.restore(other)
    assert other.step == 2
    step2 = make_train_step(other.net, cfg)
    for b in batches[2:]:
        other, logs2 = step2(other, b)
    assert other.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"] == 5e-4
    assert float(logs2["train/loss"]) == float(logs["train/loss"])
    for key, value in state.net.state_dict().items():
        assert torch.equal(other.net.state_dict()[key], value), key


def _loader(n, B=4, seed=0, last=None):
    batches = [make_batch(B=B, seed=seed + i) for i in range(n)]
    if last:  # a ragged final batch, and f64 poses as the dataset yields them
        batches[-1] = {k: v[:last] for k, v in batches[-1].items()}
    for b in batches:
        b["T_0to1"] = b["T_0to1"].astype(np.float64)
        b["scene_id"] = ["s"] * len(b["image0"])
    return batches


def _fit_cfg(**overrides):
    return tiny_cfg(pt_default_cfg, **{
        "TRAINING.BATCH_SIZE": 4, "TRAINING.EPOCHS": 2, "TRAINING.VAL_INTERVAL": 0.5,
        "TRAINING.VAL_BATCHES": 2, "TRAINING.LOG_INTERVAL": 1, **overrides})


def test_fit_loop_validates_checkpoints_logs_and_resumes(tmp_path, capsys):
    cfg = _fit_cfg()
    train, val = _loader(4, last=3), _loader(3, seed=10)
    state = pt_fit.fit_loaders(cfg, train, val, experiment="exp", weights_dir=str(tmp_path),
                               device="cpu")
    assert state.step == 8  # 2 epochs of 4 batches
    ckpt_dir = tmp_path / "exp"
    # validation every 2 steps (0.5 of an epoch) over 2 of the 3 val batches
    assert sorted(int(p.stem.split("_")[1]) for p in ckpt_dir.glob("step_*.pt")) == [2, 4, 6, 8]
    assert (ckpt_dir / "last.pt").exists()
    records = [json.loads(ln) for ln in (ckpt_dir / "scalars.jsonl").read_text().splitlines()]
    train_recs = [r for r in records if "train/loss" in r]
    val_recs = [r for r in records if "val_loss/loss" in r]
    assert [r["step"] for r in train_recs] == list(range(1, 9))
    assert [r["step"] for r in val_recs] == [2, 4, 6, 8]
    assert all(CHANNELS.issubset(r) for r in val_recs)
    assert all(np.isfinite(r["train/loss"]) and r["train/samples_per_sec"] > 0
               for r in train_recs)
    assert "val_loss=" in capsys.readouterr().out

    # max_steps stops early and leaves a 'last' to resume from
    short = pt_fit.fit_loaders(cfg, train, val, experiment="short", weights_dir=str(tmp_path),
                               max_steps=3, device="cpu")
    assert short.step == 3
    resumed = pt_fit.fit_loaders(cfg, train, val, experiment="short", resume="last",
                                 weights_dir=str(tmp_path), max_steps=5, device="cpu")
    assert resumed.step == 5
    assert "resumed from last at step 3" in capsys.readouterr().out
    # the optimizer's state came along: Adam has counted all five steps
    adam_steps = {int(st["step"]) for st in resumed.optimizer.state.values()}
    assert adam_steps == {5}


def test_fit_loop_stops_on_a_non_finite_loss(tmp_path):
    cfg = _fit_cfg()
    train = _loader(2)
    train[1]["image0"] = np.full_like(train[1]["image0"], np.nan)
    with pytest.raises(FloatingPointError, match="step 2"):
        pt_fit.fit_loaders(cfg, train, _loader(1), weights_dir=str(tmp_path), device="cpu")


def test_fit_loop_writes_a_profiler_trace(tmp_path):
    cfg = _fit_cfg(**{"TPU.PROFILE_DIR": str(tmp_path / "trace"), "TRAINING.EPOCHS": 1})
    pt_fit.fit_loaders(cfg, _loader(2), _loader(1), weights_dir=str(tmp_path), device="cpu")
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_nan_guard():
    with pytest.raises(FloatingPointError):
        check_finite_or_die(float("nan"), 10)
    check_finite_or_die(1.0, 10)


def test_fit_needs_the_data_layer(tmp_path):
    """fit(cfg) trains on the DataModule of cfg.DATASET (the data layer's
    loaders: tests/test_torch_data_cli.py drives it end to end): it reads
    the configured tree, and its device defaults to the card."""
    cfg = _fit_cfg(**{"DATASET.DATA_SOURCE": "MapFree",
                      "DATASET.DATA_ROOT": str(tmp_path / "missing")})
    with pytest.raises(FileNotFoundError, match="missing"):
        pt_fit.fit(cfg, weights_dir=str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device here to refuse")
        pt_fit.fit(cfg, weights_dir=str(tmp_path))  # device defaults to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device here to refuse")
        pt_fit.fit_loaders(_fit_cfg(), _loader(1), _loader(1))  # device defaults to the card


def test_prefetch_keeps_order_and_bounds_lookahead():
    in_flight, peak = [0], [0]

    def transfer(b):
        in_flight[0] += 1
        peak[0] = max(peak[0], in_flight[0])
        return b * 10

    out = []
    for x in prefetch_to_device(range(7), transfer, lookahead=2, pool_workers=2):
        in_flight[0] -= 1
        out.append(x)
    assert out == [i * 10 for i in range(7)]
    assert peak[0] <= 4  # lookahead + 1 submitted, one being consumed
    assert list(prefetch_to_device([], transfer)) == []


def test_data_to_device_moves_numbers_and_keeps_metadata():
    batch = {"image0": np.zeros((2, 4, 4, 3), np.uint8), "T_0to1": np.eye(4)[None],
             "n": 3, "scene_id": ["a", "b"], "t": torch.ones(2)}
    out = data_to_device(batch, "cpu")
    assert out["image0"].dtype == torch.uint8 and out["T_0to1"].dtype == torch.float64
    assert out["scene_id"] == ["a", "b"] and int(out["n"]) == 3
    assert all(isinstance(out[k], torch.Tensor) for k in ("image0", "T_0to1", "n", "t"))
