"""Single-buffer host->device transfer packing.

The host packs every per-batch array into ONE contiguous uint8 buffer
(:func:`pack_arrays`, a copy of mapfree_tpu/utils/packing.py), so a batch
crosses PCIe as one pinned copy instead of one copy per array. On the
device, :func:`unpack` cuts the buffer back into typed tensors: each field
is a byte slice of the one uint8 tensor reinterpreted with ``Tensor.view``
(no copy). ``view`` needs the slice's byte offset to be a multiple of the
field's itemsize; the predictor keeps the wider fields first (``ref_idx``
int32 ahead of the uint8 images), and a misaligned field is copied once
rather than refused.
"""

from __future__ import annotations

import numpy as np
import torch

# the field types packed: images, ref indices, float images, bool masks
_TORCH_DTYPES = {"uint8": torch.uint8, "int32": torch.int32, "float32": torch.float32,
                 "bool": torch.bool}


def pack_arrays(arrays, out: np.ndarray | None = None) -> np.ndarray:
    """Concatenate arrays byte-wise into one contiguous uint8 buffer.

    ``out`` (uint8, exactly the total size) receives the bytes in place,
    e.g. the numpy view of a pinned host tensor."""
    total = sum(int(a.nbytes) for a in arrays)
    buf = np.empty(total, np.uint8) if out is None else out
    if buf.shape != (total,) or buf.dtype != np.uint8:
        raise ValueError(f"pack buffer must be uint8[{total}], got "
                         f"{buf.dtype}{list(buf.shape)}")
    off = 0
    for a in arrays:
        flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        buf[off: off + flat.nbytes] = flat
        off += flat.nbytes
    return buf


def spec_of(named) -> tuple:
    """Hashable layout spec for a list of (name, array)."""
    return tuple((n, tuple(a.shape), str(np.asarray(a).dtype)) for n, a in named)


def unpack(buf: torch.Tensor, spec) -> dict:
    """Inverse of :func:`pack_arrays` on a 1-D uint8 tensor: {name: tensor}
    with the original shapes and dtypes, as views of ``buf`` where the byte
    offset allows."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"unpack needs a 1-D uint8 tensor, got {buf.dtype}"
                         f"{list(buf.shape)}")
    out = {}
    off = 0
    for name, shape, dt in spec:
        dtype = _TORCH_DTYPES[dt]
        itemsize = torch.empty((), dtype=dtype).element_size()
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        seg = buf[off: off + n]
        if seg.numel() != n:
            raise ValueError(f"buffer of {buf.numel()} bytes ends inside field {name!r}")
        if itemsize > 1:
            if off % itemsize:
                seg = seg.clone()  # view() needs an itemsize-aligned offset
            seg = seg.view(dtype)
        elif dtype == torch.bool:  # nonzero bytes are True, as the JAX unpack casts
            seg = seg != 0
        out[name] = seg.reshape(shape)
        off += n
    if off != buf.numel():
        raise ValueError(f"spec covers {off} bytes of a {buf.numel()}-byte buffer")
    return out
