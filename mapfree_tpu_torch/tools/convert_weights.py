"""Weights into the port's modules: from the JAX package's variables, or from
a reference PyTorch(-Lightning) checkpoint.

The port's attributes are named as the reference's torch modules are
(reference lib/models/regression/model.py:22-51), so one state_dict layout
serves both sources. :func:`flax_path_to_torch_key` is the port's own copy
of the name mapping in mapfree_tpu/tools/convert_weights.py, and
:func:`load_jax_variables` applies its layout transforms in reverse:

- ``block{i}`` -> ``i``; ``trunk`` dropped; ``bn`` -> ``normalize``;
  ``shortcut`` -> ``shortcut.0``; ``fc1/2/3`` -> ``0/2/4``;
- conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in];
- BatchNorm ``scale``/``mean``/``var`` -> ``weight``/``running_mean``/
  ``running_var``.

The same rules carry every module of the RPR family: the QKV projections
(``aggregator.Q_mlp``, ``K_mlp``, ``V_mlp``, 1x1 convolutions), the heads'
``mlp`` (a Sequential of three, or one dense layer), the fusion net's
``frame_weight``, the ResNet encoder's ``conv1`` and ``layer1-3``, and
grouped convolutions, whose HWIO kernel [kh, kw, in / groups, out] takes the
same transpose to [out, in / groups, kh, kw], and the matching track's depth
net (``models/depth.py::MonoDepthNet``: ``stem``, ``stage1-3``, ``up3-0``,
``i3-1``, ``head``), which :func:`save_jax_variables` writes out as the
``.pt`` that ``DEPTH_NET.CHECKPOINT`` names. Any leaf without a
destination, any destination without a leaf and any shape mismatch raises:
silent random weights are worse than failing.

:func:`to_jax_variables` goes the other way: the port's module as the JAX
package's ``{"params", "batch_stats"}`` tree of numpy arrays in flax layout,
so that gradients, updated parameters and running statistics can be compared
tensor by tensor, and a port checkpoint can be read by the JAX package.

CLI (:func:`main`): a reference Lightning ``.ckpt`` -> the port's ``.pt``
state dict, which ``build_model(cfg, checkpoint)`` and the submission CLI
read::

    python -m mapfree_tpu_torch.tools.convert_weights ckpt.ckpt out.pt \\
        --config configs/regression/mapfree/3d3d.yaml \\
        --dataset_config configs/mapfree.yaml
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch import nn

_LEAF_MAP = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def flax_path_to_torch_key(path) -> str:
    """Translate a flax variable path (tuple of names) to the torch
    state_dict key of the same tensor."""
    parts = list(path)
    out = []
    for p in parts[:-1]:
        if p == "trunk":
            continue  # head trunks are attributes of the head module itself
        if p.startswith("block") and p[5:].isdigit():
            out.append(p[5:])  # stage blocks are Sequential indices
        elif p == "bn":
            out.append("normalize")  # ConvBnElu's BatchNorm
        elif p == "cv_block":
            out.append("CV_block")
        elif p in ("fc1", "fc2", "fc3"):
            out.append({"fc1": "0", "fc2": "2", "fc3": "4"}[p])
        elif p == "shortcut":
            out.append("shortcut.0")  # reference wraps it in nn.Sequential
        else:
            out.append(p)
    leaf = _LEAF_MAP.get(parts[-1], parts[-1])
    return ".".join(out + [leaf])


def _leaves(tree, prefix=()):
    for name, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def _to_torch_layout(value: np.ndarray, path) -> np.ndarray:
    if path[-1] == "kernel":
        if value.ndim == 4:  # conv HWIO -> OIHW
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 2:  # dense [in, out] -> [out, in]
            return value.transpose(1, 0)
    return value


def _is_bn_counter(key: str) -> bool:
    return key.endswith("num_batches_tracked")


def load_jax_variables(net: nn.Module, variables) -> None:
    """Fill ``net`` from the JAX package's ``{"params": ..., "batch_stats":
    ...}`` tree (nested dicts of numpy arrays)."""
    state = net.state_dict()
    filled = set()
    with torch.no_grad():
        for collection, tree in variables.items():
            for path, leaf in _leaves(tree):
                key = flax_path_to_torch_key(path)
                where = f"{collection}/{'/'.join(path)} -> {key}"
                if key not in state:
                    raise KeyError(f"no tensor in the port's module for {where}")
                value = _to_torch_layout(np.asarray(leaf, np.float32), path)
                if tuple(value.shape) != tuple(state[key].shape):
                    raise ValueError(f"shape mismatch at {where}: JAX "
                                     f"{tuple(value.shape)} vs port "
                                     f"{tuple(state[key].shape)}")
                state[key].copy_(torch.tensor(value))
                filled.add(key)
    missing = [k for k in state if k not in filled and not _is_bn_counter(k)]
    if missing:
        raise KeyError(f"JAX variables miss {len(missing)} tensors: {missing}")


def save_jax_variables(net: nn.Module, variables, path) -> None:
    """Fill ``net`` from the JAX package's variables (:func:`load_jax_variables`)
    and write its state dict to ``path`` with ``torch.save``: how a depth net
    trained by the JAX package (``MonoDepthNet``, orbax) becomes the ``.pt``
    that ``DEPTH_NET.CHECKPOINT`` names in the port."""
    load_jax_variables(net, variables)
    torch.save(net.state_dict(), path)


def _flax_module_path(net: nn.Module, module_key: str) -> tuple:
    """The flax path of the submodule at ``module_key`` (dotted torch path):
    the inverse of :func:`flax_path_to_torch_key`'s module part, decided by
    what each parent module is."""
    path = []
    parent = net
    names = module_key.split(".") if module_key else []
    for i, name in enumerate(names):
        child = getattr(parent, name) if not name.isdigit() else parent[int(name)]
        if name.isdigit():
            if i > 0 and names[i - 1] == "shortcut":
                pass  # the reference wraps the shortcut conv in nn.Sequential
            elif i > 0 and names[i - 1] == "mlp":
                path.append({"0": "fc1", "2": "fc2", "4": "fc3"}.get(name, name))
            else:
                path.append(f"block{name}")  # stage blocks are Sequential indices
        elif name == "normalize":
            path.append("bn")
        elif name == "CV_block":
            path.append("cv_block")
        elif name.startswith("resblock") and i > 0 and names[i - 1] == "head":
            path += ["trunk", name]  # head trunks are modules of their own in flax
        else:
            path.append(name)
        parent = child
    return tuple(path)


def to_jax_variables(net: nn.Module, grads: bool = False) -> dict:
    """``net`` as the JAX package's ``{"params": ..., "batch_stats": ...}``
    tree (nested dicts of float32 numpy arrays, flax names and layouts).
    With ``grads`` the params tree holds each parameter's ``.grad`` instead
    of its value (and batch_stats is left out)."""
    out = {"params": {}} if grads else {"params": {}, "batch_stats": {}}

    def put(collection, path, value):
        node = out[collection]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = value

    for module_key, module in net.named_modules():
        base = _flax_module_path(net, module_key)
        is_bn = isinstance(module, nn.modules.batchnorm._BatchNorm)
        for name, p in module.named_parameters(recurse=False):
            t = p.grad if grads else p
            if t is None:
                raise ValueError(f"{module_key}.{name} has no gradient")
            value = t.detach().cpu().float().numpy()
            leaf = name
            if name == "weight":
                leaf = "scale" if is_bn else "kernel"
                if value.ndim == 4:  # conv OIHW -> HWIO
                    value = value.transpose(2, 3, 1, 0)
                elif value.ndim == 2:  # dense [out, in] -> [in, out]
                    value = value.transpose(1, 0)
            put("params", base + (leaf,), np.ascontiguousarray(value))
        if is_bn and not grads:
            put("batch_stats", base + ("mean",), module.running_mean.cpu().numpy().copy())
            put("batch_stats", base + ("var",), module.running_var.cpu().numpy().copy())
    return out


def load_state_dict(net: nn.Module, state_dict: dict) -> None:
    """Load a reference torch state_dict, with or without the Lightning
    ``model.`` prefix. Missing tensors (other than BatchNorm's batch
    counters) and shape mismatches raise; extra keys are ignored."""
    own = net.state_dict()
    src = {}
    for key, value in state_dict.items():
        name = key[len("model."):] if key.startswith("model.") else key
        if name in own:
            src[name] = torch.as_tensor(value)
    missing = [k for k in own if k not in src and not _is_bn_counter(k)]
    if missing:
        raise KeyError(f"checkpoint misses {len(missing)} tensors: {missing}")
    for key, value in src.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(value.shape)} vs port {tuple(own[key].shape)}")
    net.load_state_dict(src, strict=False)


def load_checkpoint(net: nn.Module, path) -> None:
    """Load a ``torch.save`` file (a Lightning checkpoint's ``state_dict``,
    or a bare state_dict) into ``net``."""
    ckpt = torch.load(path, map_location="cpu")
    load_state_dict(net, ckpt.get("state_dict", ckpt))


def main(argv=None):
    """Convert a reference Lightning checkpoint into the port's ``.pt``: the
    net of the two configs is built on ``--device`` and loaded with
    :func:`load_checkpoint` (a missing tensor or a shape mismatch raises);
    its state dict, without the ``model.`` prefix and the optimizer state,
    is written to ``output``. Returns the output path."""
    from pathlib import Path

    from mapfree_tpu_torch.config import cfg as default_cfg
    from mapfree_tpu_torch.models.builder import resolve_device
    from mapfree_tpu_torch.models.regression import build_regression_net

    parser = argparse.ArgumentParser(prog="python -m mapfree_tpu_torch.tools.convert_weights")
    parser.add_argument("checkpoint", help="reference .ckpt path")
    parser.add_argument("output", help=".pt state dict to write")
    parser.add_argument("--config", required=True)
    parser.add_argument("--dataset_config", default="configs/mapfree.yaml")
    parser.add_argument("--device", default="cuda",
                        help="torch device to build the net on (default: cuda)")
    args = parser.parse_args(argv)

    cfg = default_cfg.clone()
    cfg.merge_from_file(args.dataset_config)
    cfg.merge_from_file(args.config)

    net = build_regression_net(cfg).to(resolve_device(args.device))
    load_checkpoint(net, args.checkpoint)
    state = {k: v.cpu() for k, v in net.state_dict().items()}
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    print(f"converted {len(state)} tensors -> {out}")
    return out


if __name__ == "__main__":
    main()
