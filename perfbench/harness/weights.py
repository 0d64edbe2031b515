"""The benchmark's weights, made from the seed on the device in two calls
of a generator there, and handed to the system under test and to the
reference alike.

Convolutions are He-normal (fan-in, ReLU gain), their biases normal with
standard deviation 0.1; dense layers uniform within 1/sqrt(fan-in), biases
too; batch normalisation gets a scale of 1 + 0.1 z, a shift of 0.1 z, a
running mean of 0.1 z and a running variance uniform in [0.8, 1.2], so that
evaluation mode applies statistics that are not the identity.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.model import BN, Conv, Linear

SEED_MODULUS = 2 ** 63


def _kinds(model):
    """[(state-dict key, shape, kind, fan_in)] in state-dict order."""
    out = []
    for prefix, m in model.named_modules():
        key = f"{prefix}." if prefix else ""
        if isinstance(m, Conv):
            fan_in = m.weight[0].numel()
            out.append((key + "weight", tuple(m.weight.shape), "he", fan_in))
            if m.bias is not None:
                out.append((key + "bias", tuple(m.bias.shape), "small", fan_in))
        elif isinstance(m, Linear):
            fan_in = m.weight.shape[1]
            out.append((key + "weight", tuple(m.weight.shape), "uniform", fan_in))
            out.append((key + "bias", tuple(m.bias.shape), "uniform", fan_in))
        elif isinstance(m, BN):
            c = (m.weight.shape[0],)
            out += [(key + "weight", c, "scale", 0), (key + "bias", c, "small", 0),
                    (key + "running_mean", c, "small", 0), (key + "running_var", c, "var", 0),
                    (key + "num_batches_tracked", (), "count", 0)]
    return out


def make_weights(spec_model, seed: int, device) -> dict:
    """The state dict of ``spec_model``'s architecture (a reference
    :class:`~perfbench.reference.model.Model`, its tensors may be on the
    meta device) drawn from ``seed`` on ``device``: float32 tensors, and
    the batch counters as zeros."""
    kinds = _kinds(spec_model)
    total = sum(math.prod(shape) for _, shape, kind, _ in kinds if kind != "count")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MODULUS)
    z = torch.randn(total, generator=g, device=device)
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for key, shape, kind, fan_in in kinds:
        if kind == "count":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        zs, us = z[at:at + n], u[at:at + n]
        at += n
        if kind == "he":
            t = zs * math.sqrt(2.0 / fan_in)
        elif kind == "uniform":
            t = (2.0 * us - 1.0) / math.sqrt(fan_in)
        elif kind == "scale":
            t = 1.0 + 0.1 * zs
        elif kind == "small":
            t = 0.1 * zs
        else:  # "var"
            t = 0.8 + 0.4 * us
        out[key] = t.reshape(shape)
    return out


def calibrate_batchnorm(model, weights: dict, *inputs, **net_inputs) -> dict:
    """``weights`` with every batch normalisation's running mean and
    (biased) variance replaced by the statistics of its input over
    the reference's forward of ``inputs`` (a calibration batch made from
    the seed), as a trained model's statistics follow its data: evaluation
    then normalises as training does. ``model`` is a reference
    :class:`~perfbench.reference.model.Model` on the images' device; it is
    left in training mode with ``weights`` loaded."""
    model.load_state_dict(weights)
    model.train()
    stats, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, BN):
            def hook(mod, args, _name=name):
                x = args[0]
                dims = [0, 2, 3]
                stats[_name] = (x.mean(dims), x.var(dims, unbiased=False))
            hooks.append(m.register_forward_pre_hook(hook))
    try:
        with torch.no_grad():
            model(*inputs, **net_inputs)
    finally:
        for h in hooks:
            h.remove()
    out = dict(weights)
    for name, (mean, var) in stats.items():
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out
