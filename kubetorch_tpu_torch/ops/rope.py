"""Rotary position embeddings, Llama-3 style (port of
``kubetorch_tpu/ops/rope.py``): float32 angles, split-halves convention."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 500000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape ``positions.shape + (head_dim // 2,)``, float32."""
    fraction = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    timescale = torch.pow(theta, fraction)          # [head_dim/2] float32
    angles = positions.float()[..., None] / timescale
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor],
               theta: float = 500000.0,
               sin: Optional[torch.Tensor] = None,
               cos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by position; ``sin``/``cos`` ``[..., S,
    D/2]`` may be precomputed once and shared across layers."""
    if sin is None or cos is None:
        sin, cos = rope_angles(positions, x.shape[-1], theta)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    first, second = x.float().chunk(2, dim=-1)
    rotated = torch.cat(
        [first * cos - second * sin, second * cos + first * sin], dim=-1)
    return rotated.to(x.dtype)
