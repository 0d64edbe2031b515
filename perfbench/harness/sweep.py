"""The inference sweep's driver: the leaderboard sweep as a user runs it,
``predict`` over a loader on ``build_model``'s predictor, in a closed loop
(the pipeline takes the next batch as soon as it can) from a host pool made
from the seed, for the window's seconds.

End-to-end: poses returned per second over the window (from its opening to
the last batch's poses on the host), and the 95th percentile over all the
window's batches of the time from the pipeline taking a batch from the
loader to that batch's poses on the host.

Check: a sample of the window's batches, drawn from the seed with the last
batch always in it, goes through the reference once the window has closed
and the program is freed; every pose of those batches is compared."""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.harness import cell as C
from perfbench.harness import traffic
from perfbench.harness.weights import SEED_MODULUS, calibrate_batchnorm, make_weights

CALIBRATION_ROWS = 4  # query rows (windows) of the first pool batch that set the statistics


def shape_of(ctx) -> dict:
    cfg = ctx.cfg
    return {"H": int(cfg.DATASET.HEIGHT), "W": int(cfg.DATASET.WIDTH),
            "batch": int(cfg.TPU.INFER_BATCH), "frames": ctx.ref_args["frames"]}


def reference_inputs(batch: dict, frames: int, device, rows=None) -> tuple:
    """The reference's (args, kwargs) for a pool batch, from its raw
    arrays; ``rows`` keeps the first queries (windows) only."""
    from perfbench.reference.model import rgb_uint8, yuv420_to_rgb

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = rows or batch["image1"].shape[0]
    if frames:
        i1 = batch["image1"][:n]
        return (rgb_uint8(dev(batch["image0"][:n])),
                rgb_uint8(dev(i1.reshape((-1,) + i1.shape[2:])))), {
            "q_device": dev(batch["abs_q_1_w2c_device"][:n]).float(),
            "t_device": dev(batch["abs_c_1_c2w_device"][:n]).float()}
    return (yuv420_to_rgb(dev(batch["image0_unique"])), yuv420_to_rgb(dev(batch["image1"][:n]))), {
        "ref_idx": dev(batch["ref_idx"][:n]).long()}


def make_state(ctx, pool: list) -> dict:
    """The benchmark's weights for this seed, with batch statistics
    calibrated on the first pool batch, on the device."""
    from perfbench.reference.model import Model, exact_float32

    with torch.device("meta"):
        spec = Model(**ctx.ref_args)
    weights = make_weights(spec, ctx.seed, ctx.device)
    model = Model(**ctx.ref_args).to(ctx.device)
    args, kwargs = reference_inputs(pool[0], ctx.ref_args["frames"], ctx.device,
                                    rows=CALIBRATION_ROWS)
    with exact_float32():
        weights = calibrate_batchnorm(model, weights, *args, **kwargs)
    del model
    return weights


def reference_poses(ctx, weights_host: dict, batches: list, rnd_name: str = "exact") -> list:
    """[(R [B, 3, 3], t [B, 3]) float64 numpy] of the reference over pool
    batches, computed in float32 with TF32 off and the rounding
    ``rnd_name``."""
    from perfbench.reference.model import ROUNDINGS, Model, exact_float32

    model = Model(**ctx.ref_args).to(ctx.device)
    model.load_state_dict(weights_host)
    model.eval()
    out = []
    with torch.no_grad(), exact_float32():
        for b in batches:
            args, kwargs = reference_inputs(b, ctx.ref_args["frames"], ctx.device)
            R, t = model(*args, **kwargs, rnd=ROUNDINGS[rnd_name], chunk=ctx.mix["reference_chunk"])
            out.append((R.double().cpu().numpy(), t.reshape(-1, 3).double().cpu().numpy()))
    del model
    C.free_device()
    return out


def quat2mat(q):
    w, x, y, z = np.moveaxis(q / np.linalg.norm(q, axis=-1, keepdims=True), -1, 0)
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
                     2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
                     2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
                    axis=-1).reshape(q.shape[:-1] + (3, 3))


def pose_numbers(got: list, ref: list) -> dict:
    """The compared numbers of served poses ``got`` [(R or None per row,
    t or None per row)] against the reference's ``ref`` [(R, t)], batch by
    batch: the rotation gap in degrees (largest and median), the
    translation gap over the median reference translation's length
    (largest and median), and the poses that never came."""
    rot, trans, missing, scale = [], [], 0, []
    for (Rg, tg), (Rr, tr) in zip(got, ref):
        scale.append(np.linalg.norm(tr, axis=-1))
        for i in range(Rr.shape[0]):
            if Rg[i] is None:
                missing += 1
                continue
            # ||R1 - R2||_F = 2 sqrt(2) sin(angle / 2)
            d = np.linalg.norm(Rg[i] - Rr[i]) / (2.0 * np.sqrt(2.0))
            rot.append(np.degrees(2.0 * np.arcsin(min(d, 1.0))))
            trans.append(np.linalg.norm(tg[i] - tr[i]))
    s = float(np.median(np.concatenate(scale)))
    rot, trans = np.array(rot or [np.inf]), np.array(trans or [np.inf]) / s
    return {"rot_max_deg": float(rot.max()), "rot_median_deg": float(np.median(rot)),
            "t_max_rel": float(trans.max()), "t_median_rel": float(np.median(trans)),
            "poses_missing": float(missing)}


def served_poses(results: dict, seq: int, batch: dict, frames: int) -> tuple:
    """Batch ``seq``'s poses as the sweep returned them: (R per row or
    None, t per row or None), from the results' scene ``<seq>[_<ref>]`` and
    query ``<row>`` names."""
    B = batch["image1"].shape[0]
    R, t = [None] * B, [None] * B
    scenes = {f"{seq}"} if frames else {f"{seq}_{r}" for r in set(batch["ref_idx"].tolist())}
    for scene in scenes:
        for p in results.get(scene, []):
            row = int(p.image_name)
            R[row], t[row] = quat2mat(np.asarray(p.q, np.float64)), np.asarray(p.t, np.float64)
    return R, t


def plant(ctx, model) -> None:
    """A test's fault in the timed path: ``"altered"`` hands every query
    its neighbour's pose (the batch's rows shifted by one), ``"half_missing"``
    makes half of every batch's poses NaN (the sweep drops them)."""
    if ctx.fault is None:
        return
    dispatch = model.dispatch_device

    def faulty(transferred, times=None):
        finalize = dispatch(transferred, times)

        def done():
            R, t, inl = finalize()
            R, t = R.copy(), t.copy()
            if ctx.fault == "altered":
                R, t = np.roll(R, 1, axis=0), np.roll(t, 1, axis=0)
            elif ctx.fault == "half_missing":
                R[: R.shape[0] // 2] = np.nan
            else:
                raise ValueError(f"no sweep fault {ctx.fault!r}")
            return R, t, inl
        return done

    model.dispatch_device = faulty


def run(ctx) -> dict:
    from mapfree_tpu_torch.models.builder import build_model
    from mapfree_tpu_torch.utils import submission

    shape = shape_of(ctx)
    frames = shape["frames"]
    model = build_model(ctx.cfg, device=ctx.device)
    pool = traffic.make_pool(shape, ctx.mix, ctx.seed, ctx.device)
    weights = make_state(ctx, pool)
    model.net.load_state_dict(weights)
    weights_host = {k: v.to("cpu", copy=True) for k, v in weights.items()}
    del weights
    plant(ctx, model)
    C.free_device()
    if ctx.device.type == "cuda":  # the peak of the program, not of the calibration
        torch.cuda.reset_peak_memory_stats(ctx.device)

    # every shape the window drives: as many batches as the pipeline holds,
    # each reference count of the cycle among them
    n_warm = submission.MAX_TRANSFERS + submission.DEPTH
    submission.predict([traffic.with_names(pool[i % len(pool)], -1 - i, frames)
                        for i in range(n_warm)], model)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    times = C.WindowTimes(on_batch=ctx.tracer.step)
    taken = []

    def loader():
        seq = 0
        while time.perf_counter() < deadline:
            b = traffic.with_names(pool[seq % len(pool)], seq, frames)
            taken.append(time.perf_counter())
            yield b
            seq += 1

    C.settle()
    ctx.tracer.start(ctx.seconds)
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    results = submission.predict(loader(), model, times)
    t1 = time.perf_counter()
    ctx.tracer.stop()
    n_batches = len(taken)
    memory_peak = (torch.cuda.max_memory_allocated(ctx.device)
                   if ctx.device.type == "cuda" else 0)
    del model
    C.free_device()

    n_poses = sum(len(v) for v in results.values())
    B = shape["batch"]
    latencies = np.array(times.done[:n_batches]) - np.array(taken)
    end_to_end = {"sweep_poses_per_s": n_poses / (t1 - t0),
                  "sweep_batch_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
                  "setup_s": setup_s}

    rng = np.random.default_rng(ctx.seed % SEED_MODULUS)
    k = min(int(ctx.mix["checked_batches"]), n_batches)
    seqs = sorted(set(rng.choice(n_batches - 1, k - 1, replace=False).tolist()) | {n_batches - 1}) \
        if n_batches > 1 else [0]
    slots = sorted({s % len(pool) for s in seqs})  # the pool cycles: each batch once
    ref = dict(zip(slots, reference_poses(ctx, weights_host, [pool[i] for i in slots])))
    got = [served_poses(results, s, pool[s % len(pool)], frames) for s in seqs]
    numbers = pose_numbers(got, [ref[s % len(pool)] for s in seqs])
    units = [int(b["image0_unique"].shape[0]) if "image0_unique" in b else 0
             for b in (pool[s % len(pool)] for s in range(n_batches))]
    record = {"driver": "sweep", "shape": shape, "window_s": t1 - t0, "batches": n_batches,
              "poses": n_poses, "stages": dict(times.per_call), "latencies_s": latencies.tolist(),
              "unique_refs": units, "ref_args": ctx.ref_args}
    return {"end_to_end": end_to_end, "numbers": numbers, "record": record,
            "attempted": n_batches * B, "failed": n_batches * B - n_poses,
            "memory_peak_bytes": memory_peak}
