"""Move parameter trees between numpy (the reference package's arrays,
via ``np.asarray``) and the port's torch tensors, keys and dtypes exact.

A tree is nested dicts whose leaves are arrays.  bf16 arrives as the
``ml_dtypes`` ``bfloat16`` that ``np.asarray(jax_array)`` yields, which
``torch.from_numpy`` rejects: it crosses as a ``uint16`` bit view; the
e4m3 fp8 of quantized factors (``float8_e4m3fn``) crosses as a ``uint8``
bit view.  The dtypes are recognised by ``dtype.name`` so this module
never imports ``ml_dtypes`` (the machine with the card may not have it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

PyTree = Any

#: numpy dtypes torch cannot take directly: name -> (bit view, torch dtype)
_BIT_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
              "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
_TORCH_BITS = {np.uint16: torch.int16, np.uint8: torch.uint8}


def array_to_tensor(a: Any, device: str | torch.device = "cuda"
                    ) -> torch.Tensor:
    """One numpy-compatible array -> a torch tensor on ``device``."""
    a = np.array(a, order="C", copy=True)      # writable, owned buffer
    if a.dtype.name in _BIT_VIEWS:
        bits, dtype = _BIT_VIEWS[a.dtype.name]
        t = torch.from_numpy(a.view(bits)).view(dtype)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a numpy array of the same dtype.  bf16 and e4m3 come
    back as numpy's registered ``bfloat16`` / ``float8_e4m3fn`` (present
    once ``ml_dtypes`` has been imported, as the reference package
    does)."""
    t = t.detach().to("cpu").contiguous()
    for name, (bits, dtype) in _BIT_VIEWS.items():
        if t.dtype == dtype:
            try:
                np_dtype = np.dtype(name)
            except TypeError as e:
                raise TypeError(f"numpy has no {name} dtype registered; "
                                "import ml_dtypes first") from e
            return t.view(_TORCH_BITS[bits]).numpy().view(np_dtype)
    return t.numpy()


def to_torch(tree: PyTree, device: str | torch.device = "cuda") -> PyTree:
    """Map every array leaf of a nested-dict tree to a tensor on
    ``device``; ``None`` leaves pass through."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return array_to_tensor(tree, device)


def to_numpy(tree: PyTree) -> PyTree:
    """Inverse of :func:`to_torch`: every tensor leaf to numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tensor_to_array(tree)
