"""Device selection shared by the entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when CUDA is asked for
    and there is no card, instead of carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def check_on_device(tensor: torch.Tensor, device: torch.device,
                    what: str) -> None:
    """Raise unless ``tensor`` lies on ``device`` (index-insensitive for a
    bare ``cuda``)."""
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index != device.index):
        raise ValueError(f"{what} lies on {tensor.device}, expected {device}")
