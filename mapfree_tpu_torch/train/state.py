"""Train state, optimizer, and the train / validation / predict steps (port
of mapfree_tpu/train/state.py).

The JAX package holds a functional ``TrainState`` pytree and jit-compiled
steps; here the state holds the ``nn.Module``, its optimizer and scheduler,
and the steps update it in place and return it, with the JAX package's
argument order (``step(state, batch)``) and log keys.

- optimizer: Adam(eps=1e-6) + StepLR staircase decay stepped once per
  optimizer step + optional global-norm clipping written to agree with
  ``optax.clip_by_global_norm`` (reference model.py:180-187, train.py:61);
- bfloat16 mode: parameters stay float32 and the forward runs under
  autocast (inside the net); float32 mode runs with TF32 off on the card;
- logs stay tensors on the device: nothing in a step waits for the device;
- with a ``mesh`` of more than one rank (one process per device, a
  ``torch.distributed`` group) each rank takes its block of the global
  batch: BatchNorm normalises over the whole batch
  (:func:`~mapfree_tpu_torch.models.blocks.sync_batchnorm`), the gradients
  are averaged over the ranks in one all-reduce before clipping and Adam,
  and the logged losses and validation outputs are those of the whole
  batch, so a step equals the single-process step on the global batch (the
  JAX step's SPMD program over its sharded batch).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from mapfree_tpu_torch.data.augment import augment_generator, make_device_augment
from mapfree_tpu_torch.losses import combined_loss
from mapfree_tpu_torch.metrics import pose_error
from mapfree_tpu_torch.models.blocks import init_weights, sync_batchnorm
from mapfree_tpu_torch.models.builder import resolve_device, tf32_off


@dataclass
class TrainState:
    """The net with its optimizer, scheduler and the number of steps taken."""

    net: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.net.parameters()).device

    def state_dict(self) -> dict:
        return {
            "state_dict": self.net.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
            "step": int(self.step),
        }

    def load_state_dict(self, ckpt: dict) -> None:
        self.net.load_state_dict(ckpt["state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        if self.scheduler is not None and ckpt.get("scheduler") is not None:
            self.scheduler.load_state_dict(ckpt["scheduler"])
        self.step = int(ckpt["step"])


def make_lr_schedule(tcfg) -> Callable:
    """``schedule(step) -> learning rate`` of the optimizer step with that
    0-based index: the staircase decay the StepLR scheduler applies."""
    lr = float(tcfg.LR)
    if tcfg.LR_STEP_INTERVAL:
        interval, gamma = int(tcfg.LR_STEP_INTERVAL), float(tcfg.LR_STEP_GAMMA)
        return lambda step: lr * gamma ** (int(step) // interval)
    return lambda step: lr


def make_optimizer(tcfg, params):
    """(Adam(eps=1e-6), StepLR or None) over ``params``. Both frameworks add
    eps outside the square root and correct both moments for bias."""
    optimizer = torch.optim.Adam(list(params), lr=float(tcfg.LR), eps=1e-6)
    scheduler = None
    if tcfg.LR_STEP_INTERVAL:
        scheduler = torch.optim.lr_scheduler.StepLR(
            optimizer, step_size=int(tcfg.LR_STEP_INTERVAL),
            gamma=float(tcfg.LR_STEP_GAMMA))
    return optimizer, scheduler


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place to a global norm of at most ``max_norm``
    and return the norm before clipping. As optax does: untouched while
    norm < max_norm, else (g / norm) * max_norm. (``clip_grad_norm_`` divides
    by norm + 1e-6 instead.) Nothing here waits for the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def init_state(net, cfg, generator=None, sample_batch=None, device="cuda") -> TrainState:
    """Move ``net`` to ``device`` and give it an optimizer. With a
    ``generator`` the weights are re-initialised from it first.
    ``sample_batch`` keeps the JAX package's argument order; torch modules
    need no shape inference, so it is not read."""
    del sample_batch
    if generator is not None:
        init_weights(net, generator)
    net = net.to(resolve_device(device))
    optimizer, scheduler = make_optimizer(cfg.TRAINING, net.parameters())
    return TrainState(net=net, optimizer=optimizer, scheduler=scheduler, step=0)


def _precision_context(net, cfg):
    """TF32 off around a float32 step on the card, so float32 stays float32
    (cuDNN's default is TF32 on). bfloat16 mode needs no setting: its
    convolutions run in bf16 under autocast, and its float32 MLP and Kabsch
    matmuls keep PyTorch's default of matmul TF32 off."""
    device = next(net.parameters()).device
    if device.type == "cuda" and cfg.TPU.COMPUTE_DTYPE == "float32":
        return tf32_off()
    return contextlib.nullcontext()


def _net_kwargs(net, batch) -> dict:
    """Extra inputs some models take: the fusion net's device-tracking
    poses."""
    if getattr(net, "needs_device_poses", False):
        return {"q_device": batch["abs_q_1_w2c_device"],
                "t_device": batch["abs_c_1_c2w_device"]}
    return {}


def _forward_loss(net, cfg, batch):
    R, t, aux = net(batch["image0"], batch["image1"], **_net_kwargs(net, batch))
    preds = dict(aux)
    preds["R"] = R
    preds["t"] = t
    R_loss, t_loss, loss = combined_loss(
        preds, batch, cfg.TRAINING.ROT_LOSS, cfg.TRAINING.TRANS_LOSS,
        float(cfg.TRAINING.LAMBDA), s_r=aux.get("s_r"), s_t=aux.get("s_t"))
    return loss, (R_loss, t_loss, R, t, preds)


def _mesh_group(mesh):
    """The process group a step reduces over: None without a mesh or on a
    mesh of one device. A mesh that one process drives over several devices
    is the predictor's layout, not a step's."""
    if mesh is None or mesh.size == 1:
        return None
    if mesh.group is None:
        raise ValueError(f"{mesh}: a train, validation or predict step over several devices "
                         "runs one process per device in a torch.distributed process group "
                         "(python -m mapfree_tpu_torch.train starts one rank per card)")
    return mesh.group


def _all_reduce_(t, group):
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _gather_rows(t, group, world):
    """The ranks' blocks of ``t`` concatenated in rank order: the whole
    batch's rows."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def average_gradients_(params, group, world: int) -> None:
    """Replace each gradient by its mean over the ranks: one all-reduce of
    the gradients packed into one buffer. Every rank holds the same set of
    gradients (the same net on the same code path)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = _all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    flat.div_(world)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(net, cfg, mesh=None):
    """``train_step(state, batch) -> (state, logs)``: one optimizer step on a
    batch of tensors on the net's device (``image0``, ``image1``, ``T_0to1``,
    and the device-tracking poses for the fusion net).
    ``logs`` are 0-d tensors on the device. With a ``mesh`` of several ranks
    ``batch`` is this rank's block of the global batch (``shard_batch``) and
    the step is the global batch's (see the module's docstring)."""
    augment = make_device_augment(cfg)
    aug_seed = int(cfg.TPU.SEED)
    max_norm = float(cfg.TRAINING.GRAD_CLIP or 0.0)
    kendall = float(cfg.TRAINING.LAMBDA) == 0.0
    group = _mesh_group(mesh)
    if group is not None:
        sync_batchnorm(net, group)
        world, rank = mesh.size, mesh.rank

    def train_step(state: TrainState, batch):
        net = state.net
        net.train()
        if augment is not None:
            device = batch["image0"].device
            generator = augment_generator(aug_seed, state.step, device)
            if group is None:
                batch = augment(generator, batch)
            else:  # the global batch's draw, this rank's rows of it
                b = batch["image0"].shape[0]
                batch = augment(generator, batch, rows=(rank * b, (rank + 1) * b, world * b))
        logs = {}
        if kendall:  # the weights the step was taken with, as the JAX step logs
            logs["train/s_R"] = net.s_r.detach()[0].clone()
            logs["train/s_t"] = net.s_t.detach()[0].clone()
        with _precision_context(net, cfg):
            state.optimizer.zero_grad(set_to_none=True)
            loss, (R_loss, t_loss, _, _, _) = _forward_loss(net, cfg, batch)
            loss.backward()
            if group is not None:
                average_gradients_(list(net.parameters()), group, world)
            if max_norm > 0:
                clip_by_global_norm_(list(net.parameters()), max_norm)
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
        state.step += 1
        losses = (R_loss.detach(), t_loss.detach(), loss.detach())
        if group is not None:  # the blocks' means: the global batch's
            losses = _all_reduce_(torch.stack(losses), group) / world
        logs = {"train/R_loss": losses[0], "train/t_loss": losses[1],
                "train/loss": losses[2], **logs}
        return state, logs

    return train_step


def make_val_step(net, cfg, mesh=None):
    """Per-batch validation: losses + per-sample pose errors, as tensors on
    the device (reference model.py:99-112). With a ``mesh`` of several ranks
    ``batch`` is this rank's block, and every rank gets the whole batch's
    outputs: the per-sample errors gathered in rank order, the losses
    averaged."""
    group = _mesh_group(mesh)

    def val_step(state: TrainState, batch):
        state.net.eval()
        with torch.no_grad(), _precision_context(state.net, cfg):
            loss, (R_loss, t_loss, R, t, _) = _forward_loss(state.net, cfg, batch)
            outputs = pose_error(R, t, batch["T_0to1"])
            if group is not None:
                outputs = {k: _gather_rows(v, group, mesh.size) for k, v in outputs.items()}
                R_loss, t_loss, loss = _all_reduce_(
                    torch.stack([R_loss, t_loss, loss]), group) / mesh.size
        outputs["R_loss"] = R_loss
        outputs["t_loss"] = t_loss
        outputs["loss"] = loss
        return outputs

    return val_step


def make_predict_step(net, cfg, mesh=None):
    """Batched inference returning (R, t); with a ``mesh`` of several ranks
    ``batch`` is this rank's block and (R, t) are the whole batch's,
    gathered in rank order."""
    group = _mesh_group(mesh)

    def predict(state: TrainState, batch):
        state.net.eval()
        with torch.no_grad(), _precision_context(state.net, cfg):
            R, t, _ = state.net(batch["image0"], batch["image1"],
                                **_net_kwargs(state.net, batch))
            if group is not None:
                R, t = (_gather_rows(x, group, mesh.size) for x in (R, t))
        return R, t

    return predict
