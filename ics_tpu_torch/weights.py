"""JAX parameter trees into the port's state dicts.

``from_jax_variables`` takes the ``{"params": ...}`` tree of an
``ics_tpu`` model as nested dicts and lists of numpy arrays (no JAX
needed) and returns the state dict of the matching ``ics_tpu_torch``
module. Names follow the tree (``blocks.3.attn.qkv.w`` ->
``blocks.3.attn.qkv.weight``); layouts move from JAX's to PyTorch's:
conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in].
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

_LEAF_NAMES = {"w": "weight", "b": "bias", "gamma": "weight", "beta": "bias"}


def _walk(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _walk(sub, prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _walk(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _entries(variables: dict) -> Iterator[tuple[str, Any, tuple]]:
    """(torch name, JAX leaf, axis permutation or None) per parameter."""
    params = variables.get("params", variables)
    for path, leaf in _walk(params):
        name = path[-1]
        perm = None
        if name == "w":
            ndim = len(leaf.shape)
            if ndim == 4:
                perm = (3, 2, 0, 1)   # HWIO -> OIHW
            elif ndim == 2:
                perm = (1, 0)         # [in, out] -> [out, in]
            else:
                raise ValueError(f"unexpected kernel rank {ndim} at {'.'.join(path)}")
        torch_name = ".".join(path[:-1] + (_LEAF_NAMES.get(name, name),))
        yield torch_name, leaf, perm


def mapped_shapes(variables: dict) -> dict[str, tuple[int, ...]]:
    """The state-dict shapes a tree maps onto; leaves need only ``.shape``
    (``jax.eval_shape`` output will do)."""
    return {
        name: tuple(leaf.shape[i] for i in perm) if perm else tuple(leaf.shape)
        for name, leaf, perm in _entries(variables)
    }


def from_jax_variables(variables: dict) -> dict[str, torch.Tensor]:
    """State dict (fp32 CPU tensors) for ``module.load_state_dict(..., strict=True)``."""
    out = {}
    for name, leaf, perm in _entries(variables):
        arr = np.asarray(leaf, dtype=np.float32)
        if perm:
            arr = arr.transpose(perm)
        out[name] = torch.tensor(arr)  # a copy: JAX's buffers are read-only
    return out
