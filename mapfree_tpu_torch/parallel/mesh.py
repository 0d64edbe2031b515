"""Device mesh and batch sharding (port of mapfree_tpu/parallel/mesh.py).

The JAX package runs each step as one SPMD program over a
``jax.sharding.Mesh``: batches sharded over the ``data`` axis, parameters
replicated. The port keeps that policy with two layouts of the same mesh:

- one process per device, in a ``torch.distributed`` process group of more
  than one rank (training, :mod:`mapfree_tpu_torch.train`): the mesh spans
  the ranks, each rank holds its own device, and the steps all-reduce over
  the group;
- one process driving several devices (the predictor,
  :class:`mapfree_tpu_torch.models.builder.RegressionPredictor`): one
  replica of the net per device.

Either way a batch is split into contiguous blocks over the ``data`` axis
(the layout ``P(DATA_AXIS)`` gives): with d devices along it, device i holds
rows [i B / d, (i + 1) B / d) of a batch of B rows, B a multiple of d.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

DATA_AXIS = "data"
# every collective of a process group the port starts waits at most this long
GROUP_TIMEOUT = timedelta(minutes=10)


class Mesh:
    """Devices laid out over named axes (``jax.sharding.Mesh``'s shape).

    ``devices`` is an object array of ``torch.device`` of the mesh's shape.
    With a ``group`` (a process group of more than one rank) device i of the
    flattened mesh belongs to rank i and this process is ``rank``; without
    one, this process drives every device."""

    def __init__(self, devices, axis_names, group=None, rank=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a mesh of shape "
                             f"{self.devices.shape}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> list:
        """The devices this process drives, in mesh order."""
        flat = list(self.devices.flat)
        return flat if self.group is None else [flat[self.rank]]

    @property
    def local_indices(self) -> list:
        """The flat mesh indices of :attr:`local_devices`."""
        return list(range(self.size)) if self.group is None else [self.rank]

    def __repr__(self):
        where = "one process" if self.group is None else f"rank {self.rank}"
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"{where})")


def world_and_rank():
    """(world size, rank) of torch.distributed's process group, or (1, 0)
    where none is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_devices(device) -> list:
    """Each rank's device, in rank order, gathered from every rank of the
    default process group (``device`` is this rank's)."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(torch.device(device)))
    return [torch.device(d) for d in out]


def make_mesh(cfg=None, devices=None) -> Mesh:
    """Build the device mesh. Default: a 1-D data mesh over every visible
    card (as ``jax.devices()``), or, inside a process group of more than one
    rank, over the ranks' cards (this rank's is the current CUDA device).
    ``devices`` (over the ranks, in a process group) overrides that.
    ``TPU.MESH_SHAPE`` takes the first prod(shape) devices, named by
    ``TPU.MESH_AXES``. No card and no ``devices`` raises: the mesh never
    falls back to the CPU by itself."""
    world, rank = world_and_rank()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available (pass devices=[...] "
                               "to build a mesh of other devices)")
        if world > 1:
            devices = rank_devices(torch.device("cuda", torch.cuda.current_device()))
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = local_mesh(cfg, devices)
    if world == 1:
        return mesh
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.size} devices in a process group of {world} "
                         "ranks: the mesh must hold one device per rank")
    import torch.distributed as dist

    return Mesh(mesh.devices, mesh.axis_names, group=dist.group.WORLD, rank=rank)


def local_mesh(cfg, devices) -> Mesh:
    """The mesh of ``devices`` that this one process drives (the
    predictor's layout), shaped by ``TPU.MESH_SHAPE`` as :func:`make_mesh`
    shapes it."""
    devices = [torch.device(d) for d in devices]
    shape, axes = (len(devices),), (DATA_AXIS,)
    if cfg is not None and cfg.TPU.MESH_SHAPE:
        shape = tuple(int(s) for s in cfg.TPU.MESH_SHAPE)
        axes = tuple(cfg.TPU.MESH_AXES)[: len(shape)]
        devices = devices[: int(np.prod(shape))]
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axes)


class NamedSharding:
    """How an array is laid out over a mesh: split on its leading axis over
    the mesh axes named by ``spec`` (``(DATA_AXIS,)``), or replicated
    (``()``)."""

    def __init__(self, mesh: Mesh, spec: tuple):
        self.mesh = mesh
        self.spec = tuple(spec)
        for axis in self.spec:
            if axis not in mesh.axis_names:
                raise ValueError(f"no axis {axis!r} in a mesh of axes {mesh.axis_names}")

    def blocks(self, n: int) -> list:
        """The rows [start, stop) of a leading axis of ``n`` that each
        device of the flattened mesh holds."""
        if not self.spec:
            return [(0, n)] * self.mesh.size
        split = [self.mesh.axis_names.index(a) for a in self.spec]
        parts = int(np.prod([self.mesh.devices.shape[i] for i in split]))
        if n % parts:
            raise ValueError(f"a leading axis of {n} does not split into {parts} equal blocks "
                             f"(pad it: pad_to_multiple({n}, {parts}))")
        per = n // parts
        out = []
        for flat in range(self.mesh.size):
            coords = np.unravel_index(flat, self.mesh.devices.shape)
            part = int(np.ravel_multi_index([coords[i] for i in split],
                                            [self.mesh.devices.shape[i] for i in split]))
            out.append((part * per, (part + 1) * per))
        return out

    def local_blocks(self, n: int) -> list:
        """(device, start, stop) for each device this process drives."""
        blocks = self.blocks(n)
        return [(self.mesh.devices.flat[i], *blocks[i]) for i in self.mesh.local_indices]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axis for a batch leaf."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """Place a host batch onto the mesh, sharding the leading axis: one dict
    per device this process drives (one in a process group), each holding
    that device's block of every entry as a tensor on the device."""
    sharding = batch_sharding(mesh)
    out = []
    for i, dev in enumerate(mesh.local_devices):
        shard = {}
        for key, x in batch.items():
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            _, start, stop = sharding.local_blocks(t.shape[0])[i]
            shard[key] = t[start:stop].to(dev)
        out.append(shard)
    return out


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
