"""Shared conv building blocks (port of mapfree_tpu/models/blocks.py).

NCHW tensors inside; attribute names follow the reference's torch modules
(reference lib/models/regression/encoder/preact.py:13-64, resunet.py:15-38)
so one state_dict layout loads both a reference checkpoint and weights
carried over from the JAX package. BatchNorm: eps 1e-5, torch momentum 0.1
(flax's 0.9), running variance updated as flax updates it
(:class:`BatchNorm2d`). Convs carry no bias except in :class:`ConvBnElu`, as
in the JAX modules.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance takes in the BIASED batch
    variance, as flax's BatchNorm does (torch folds in the unbiased one, so
    after a train step the two frameworks' statistics would differ by
    n / (n - 1)). The normalisation itself and the state_dict keys are
    torch's. In training the op writes momentum * unbiased variance into a
    scratch tensor (the one autograd keeps), and the running variance is
    updated from it: three small kernels per layer.

    With ``process_group`` set (:func:`sync_batchnorm`, a group of more than
    one rank) training normalises by the statistics of the whole batch over
    the group's ranks (:class:`_SyncBatchNorm`), as the JAX step's
    BatchNorm does over a sharded batch."""

    process_group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats) or self.momentum is None:
            return super().forward(x)
        self._check_input_dim(x)
        if self.process_group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps,
                                                self.process_group)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
            return y
        n = x.numel() // x.shape[1]
        scratch = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, self.running_mean, scratch, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            # scratch = momentum * var * n / (n - 1): take the factor back out
            self.running_var.mul_(1.0 - self.momentum).add_(scratch, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


def _all_reduce(t, group):
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank of ``group``.

    Forward, in float32 whatever x's type: the global mean from the
    all-reduced per-channel sums and counts, then the BIASED global
    variance from the all-reduced sums of squared deviations from it (two
    passes, as torch's own BatchNorm, not E[x^2] - E[x]^2). Returns y in x's
    type and the batch mean and variance for the running statistics.

    Backward: the two per-channel sums, of dy and of dy * x_hat, all-reduced
    in one call, give the input gradient of the whole batch's loss; the
    weight and bias gradients are this rank's own sums (the train step
    averages every parameter gradient over the ranks)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        n_local = xf.numel() // xf.shape[1]
        sums = torch.cat([xf.sum(dims), xf.new_full((1,), float(n_local))])
        sums = _all_reduce(sums, group)
        n = sums[-1]
        mean = sums[:-1] / n
        xc = xf - mean.reshape(shape)
        var = _all_reduce((xc * xc).sum(dims), group) / n
        invstd = torch.rsqrt(var + eps)
        x_hat = xc * invstd.reshape(shape)
        y = x_hat * weight.reshape(shape) + bias.reshape(shape)
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        x_hat, weight, invstd, n = ctx.saved_tensors
        dims = [0] + list(range(2, x_hat.dim()))
        shape = [1, -1] + [1] * (x_hat.dim() - 2)
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xhat = (dyf * x_hat).sum(dims)
        total = _all_reduce(torch.stack([sum_dy, sum_dy_xhat]), ctx.group)
        dx = (weight * invstd).reshape(shape) * (
            dyf - (total[0] / n).reshape(shape) - x_hat * (total[1] / n).reshape(shape))
        return dx.to(dy.dtype), sum_dy_xhat, sum_dy, None, None


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Point every :class:`BatchNorm2d` of ``module`` at ``group`` (a process
    group of more than one rank). Not
    ``nn.SyncBatchNorm.convert_sync_batchnorm``: that layer folds the
    unbiased variance into the running statistics."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return module


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class PreActBlock(nn.Module):
    """Pre-activation residual basic block: BN-ReLU-Conv3x3(stride)-BN-ReLU-
    Conv3x3, with a 1x1 conv shortcut on the pre-activated input when the
    stride or channel count changes (reference preact.py:13-36)."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1, bn: bool = True):
        super().__init__()
        self.use_bn = bn
        if bn:
            self.bn1 = _bn(in_planes)
            self.bn2 = _bn(planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, self.expansion * planes, 1, stride, bias=False))
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(self.bn1(x) if self.use_bn else x)
        shortcut = self.shortcut(out) if self.shortcut is not None else x
        out = self.conv1(out)
        out = F.relu(self.bn2(out) if self.use_bn else out)
        out = self.conv2(out)
        return out + shortcut


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck block, expansion 4 (reference preact.py:39-64)."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn3 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, self.expansion * planes, 1, bias=False)
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, self.expansion * planes, 1, stride, bias=False))
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(self.bn1(x))
        shortcut = self.shortcut(out) if self.shortcut is not None else x
        out = self.conv1(out)
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + shortcut


class PreActBottleneckDepthwise(nn.Module):
    """Grouped-conv bottleneck, expansion 4 (reference preact.py:67-96):
    :class:`PreActBottleneck` with every conv, the shortcut's too, in
    ``min(in_planes, planes)`` groups."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        groups = min(in_planes, planes)
        self.bn1 = _bn(in_planes)
        self.conv1 = nn.Conv2d(in_planes, planes, 1, groups=groups, bias=False)
        self.bn2 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, groups=groups, bias=False)
        self.bn3 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, self.expansion * planes, 1, groups=groups,
                               bias=False)
        if stride != 1 or in_planes != self.expansion * planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, self.expansion * planes, 1, stride, groups=groups,
                          bias=False))
        else:
            self.shortcut = None

    forward = PreActBottleneck.forward


class ConvBnElu(nn.Module):
    """Conv (with bias) + BatchNorm + ELU (reference resunet.py:15-26)."""

    def __init__(self, in_planes: int, features: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, features, kernel_size, stride,
                              (kernel_size - 1) // 2)
        self.normalize = _bn(features)

    def forward(self, x):
        return F.elu(self.normalize(self.conv(x)))


class UpConv(nn.Module):
    """Bilinear 2x upsample (align_corners=True) + ConvBnElu
    (reference resunet.py:29-38)."""

    def __init__(self, in_planes: int, features: int, kernel_size: int = 3,
                 scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv1 = ConvBnElu(in_planes, features, kernel_size, 1)

    def forward(self, x):
        H, W = x.shape[-2:]
        x = resize_bilinear_align_corners(x, (H * self.scale, W * self.scale))
        return self.conv1(x)


@lru_cache(maxsize=16)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] align-corners linear-interpolation matrix, two nonzeros per
    row (mapfree_tpu/models/blocks.py::_interp_matrix). Cached per shape;
    callers must not write to the result."""
    if out_size == 1 or in_size == 1:
        src = np.zeros((out_size,), np.float32)
    else:
        src = np.arange(out_size, dtype=np.float32) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    frac = src - lo
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m


@lru_cache(maxsize=32)
def _interp_tensor(in_size: int, out_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`_interp_matrix` as a tensor of ``dtype`` on ``device``, made
    once per key: a copy from pageable host memory on every call would stall
    the host until the device caught up. Made outside inference mode, so
    that autograd may save it; callers must not write to it."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(in_size, out_size)).to(device, dtype)


def resize_bilinear_align_corners(x, out_hw):
    """Bilinear resize of NCHW ``x`` with align_corners=True, as the JAX
    package computes it (mapfree_tpu/models/blocks.py:226-248): two
    interpolation matmuls, along H and then along W, with the matrices in
    the compute dtype (autocast's, else ``x``'s), float32 accumulation, and
    the result rounded to the compute dtype after each axis."""
    H, W = x.shape[-2:]
    out_h, out_w = out_hw
    if (out_h, out_w) == (H, W):
        return x
    dev = x.device.type
    dtype = torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype
    mh = _interp_tensor(H, out_h, x.device, dtype)
    mw = _interp_tensor(W, out_w, x.device, dtype)
    with torch.autocast(dev, enabled=False):
        x = x.to(dtype)
        if x.is_contiguous() or not x.is_contiguous(memory_format=torch.channels_last):
            x = torch.matmul(mh, x)                     # [N, C, out_h, W]
            return torch.matmul(x, mw.transpose(0, 1))  # [N, C, out_h, out_w]
        # channels-last memory (what cuDNN's convolutions keep here): the same
        # products on the [N, H, W, C] view, so the result stays channels-last
        N, C = x.shape[:2]
        y = torch.matmul(mh, x.permute(0, 2, 3, 1).reshape(N, H, W * C))
        y = torch.matmul(mw, y.reshape(N * out_h, W, C))
        return y.reshape(N, out_h, out_w, C).permute(0, 3, 1, 2)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every layer from ``generator``: convs He-normal (fan-in,
    ReLU gain) with zero bias, linear layers with PyTorch's default
    (kaiming-uniform weights, fan-in uniform biases), BatchNorm to identity
    statistics. The same seed gives the same weights on every device. He
    init keeps the activations' scale through the residual stages, so an
    untrained net's poses still depend on its input (with PyTorch's default
    conv init they vary by ~1e-6 across inputs at 96x72)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, nonlinearity="relu",
                                        generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
                bound = 1.0 / m.weight.shape[1] ** 0.5
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
