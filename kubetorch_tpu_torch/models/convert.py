"""Carry a JAX params tree over to the port, key for key.

The JAX package's params are nested dicts of arrays; after
``jax.device_get`` the leaves are numpy arrays, bf16 ones as
``ml_dtypes.bfloat16``. :func:`params_from_numpy` keeps the structure,
the keys (fused ``wqkv``/``wgu`` or not, int8 weights and their ``*_scale``
siblings) and every dtype.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from kubetorch_tpu_torch._device import resolve_device

_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _leaf(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()            # torch.from_numpy wants a writable buffer
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes.bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype in _NUMPY_TO_TORCH:
        t = torch.from_numpy(a)
    else:
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return t.to(device)


def params_from_numpy(tree: Any,
                      device: Union[str, torch.device] = "cuda") -> Any:
    """The JAX params tree with numpy leaves → the same tree of tensors on
    ``device``, dtype-preserving."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (np.ndarray, np.generic)):
            return _leaf(np.asarray(node), dev)
        raise TypeError(f"unsupported params leaf {type(node).__name__}; "
                        "pass the tree through jax.device_get first")

    return walk(tree)
