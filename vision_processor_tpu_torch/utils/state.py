"""Per-frame state between numpy (host, and the JAX package) and torch.

The processor's per-frame inputs — ``Processor.params()``, the packed
camera (float32[18]), the (7, 3) color tables, ``TrackedArrays.as_dict()``
— and its per-geometry inputs — the warp or gather grid dict and
``pack_field_marks`` — are dicts of numpy arrays and scalars in the JAX
package's layouts and dtypes. ``to_torch`` moves such a tree onto a device
with one host->device copy per dtype; ``to_numpy`` brings a tree of tensors
back with one device->host copy per dtype. The tests use them to feed
JAX-computed grids into the port and to compare outputs.

64-bit inputs narrow to the JAX package's 32-bit types (float64 ->
float32, int64 -> int32), as JAX does with x64 disabled.
"""
from __future__ import annotations

import numpy as np
import torch

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
}


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def _rebuild(tree, leaves, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,)) for i, v in enumerate(tree))
    return leaves[prefix]


def to_torch(tree, device) -> object:
    """numpy arrays / scalars (nested in dicts, tuples, lists) -> tensors on
    ``device``, one copy per dtype."""
    device = torch.device(device)
    arrays = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
        if a.dtype not in _TORCH:
            raise TypeError(f"to_torch: unsupported dtype {a.dtype} at {path}")
        arrays[path] = a
    leaves = {}
    by_dtype: dict = {}
    for path, a in arrays.items():
        by_dtype.setdefault(a.dtype, []).append(path)
    for dtype, paths in by_dtype.items():
        flat = np.concatenate([arrays[p].reshape(-1) for p in paths])
        buf = torch.from_numpy(flat).to(device)
        off = 0
        for p in paths:
            a = arrays[p]
            leaves[p] = buf[off: off + a.size].reshape(a.shape)
            off += a.size
    return _rebuild(tree, leaves)


def to_numpy(tree) -> object:
    """Tensors (nested in dicts, tuples, lists) -> numpy arrays, one
    device->host copy per dtype and device."""
    leaves = {}
    groups: dict = {}
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            groups.setdefault((leaf.dtype, leaf.device), []).append((path, leaf))
        else:
            leaves[path] = leaf
    for (_dtype, _dev), items in groups.items():
        flat = torch.cat([t.reshape(-1) for _, t in items]).cpu().numpy()
        off = 0
        for path, t in items:
            n = t.numel()
            leaves[path] = flat[off: off + n].reshape(tuple(t.shape))
            off += n
    return _rebuild(tree, leaves)
