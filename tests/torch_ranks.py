"""Process groups for the PyTorch port's CPU tests: ``run_ranks`` starts
``world`` processes over gloo, each calling ``fn(rank, world, *args)``, and
returns what each returned. A free port per call, a timeout on every
collective and a limit on the wait for the processes, so that a hang fails
the test instead of holding the suite. The functions the ranks run live here
or in other modules that import no JAX, so that a process starts in seconds.
"""

import pickle
import socket
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.multiprocessing as mp

JOIN_LIMIT_S = 120
COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, out_dir, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    log = open(Path(out_dir) / f"stdout_{rank}.txt", "w")
    sys.stdout = log
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=COLLECTIVE_TIMEOUT)
    try:
        result = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
        sys.stdout.flush()
    with open(Path(out_dir) / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, *args, limit_s: float = JOIN_LIMIT_S):
    """[(result, stdout) of rank r for r in range(world)]."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(_rank_main, args=(world, free_port(), out_dir, fn, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + limit_s
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running "
                                       f"after {limit_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(world):
            with open(Path(out_dir) / f"result_{r}.pkl", "rb") as f:
                result = pickle.load(f)
            out.append((result, (Path(out_dir) / f"stdout_{r}.txt").read_text()))
        return out


def numpy_state(net) -> dict:
    """Every parameter, gradient and buffer of ``net`` as numpy."""
    out = {f"param/{k}": p.detach().numpy().copy() for k, p in net.named_parameters()}
    out.update({f"grad/{k}": p.grad.detach().numpy().copy()
                for k, p in net.named_parameters() if p.grad is not None})
    out.update({f"buffer/{k}": b.detach().numpy().copy() for k, b in net.named_buffers()})
    return out


def steps(cfg, variables, batch, mesh=None):
    """The validation and predict steps of ``cfg``'s port model at
    ``variables`` (the JAX package's, as numpy) on ``batch`` (this rank's
    block with a ``mesh``), then one train step on it: the train logs,
    :func:`numpy_state` of the net after the train step, and the
    validation outputs and (R, t) as numpy."""
    from mapfree_tpu_torch.models.regression import build_regression_net
    from mapfree_tpu_torch.tools.convert_weights import load_jax_variables
    from mapfree_tpu_torch.train import (init_state, make_predict_step, make_train_step,
                                         make_val_step)

    net = build_regression_net(cfg)
    load_jax_variables(net, variables)
    state = init_state(net, cfg, device="cpu")
    val = make_val_step(net, cfg, mesh=mesh)(state, batch)
    R, t = make_predict_step(net, cfg, mesh=mesh)(state, batch)
    val = {k: v.numpy() for k, v in val.items()}
    val.update(R=R.numpy(), t=t.numpy())
    state, logs = make_train_step(net, cfg, mesh=mesh)(state, batch)
    return {k: float(v) for k, v in logs.items()}, numpy_state(net), val


def train_step_rank(rank, world, cfg, variables, batch, devices):
    """:func:`steps` on this rank's block of ``batch`` over the ranks'
    mesh."""
    from mapfree_tpu_torch.parallel import make_mesh, shard_batch

    mesh = make_mesh(cfg, devices=devices)
    assert mesh.group is not None and mesh.rank == rank
    local = shard_batch({k: torch.from_numpy(v.copy()) for k, v in batch.items()}, mesh)
    assert len(local) == 1
    return steps(cfg, variables, local[0], mesh)


def fit_rank(rank, world, cfg, weights_dir):
    """``fit`` on the CPU, this process one rank of the group; returns the
    steps taken."""
    from mapfree_tpu_torch.train.fit import fit

    state = fit(cfg, weights_dir=weights_dir, device="cpu", max_steps=1)
    return int(state.step)
