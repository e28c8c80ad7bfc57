"""Grouped-query attention with float32 softmax (port of
``kubetorch_tpu/ops/attention.py``).

The plain path: scores ``[B, Hkv, G, S, T]`` are materialized, which is fine
for short sequences. Long tileable sequences take the flash kernel
(:mod:`kubetorch_tpu_torch.ops.flash_attention`).
"""

from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(
    q: torch.Tensor,            # [B, S, Hq, D]
    k: torch.Tensor,            # [B, T, Hkv, D]
    v: torch.Tensor,            # [B, T, Hkv, D]
    *,
    causal: bool = True,
    bias: Optional[torch.Tensor] = None,         # broadcastable to [B,H,S,T]
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] packed-sequence ids
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Returns ``[B, S, Hq, D]`` in ``q.dtype``. ``q_offset`` shifts the
    causal diagonal (query block starts at that absolute key position)."""
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    # "b s (h g) d -> b h g s d": query head index = kv_head * G + g
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    logits = torch.einsum("bhgsd,bhtd->bhgst", (qg * scale).float(),
                          k.permute(0, 2, 1, 3).float())

    mask = None
    if causal:
        qpos = torch.arange(S, device=q.device) + q_offset
        kpos = torch.arange(T, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
    if segment_ids is not None:
        seg = (segment_ids[:, None, None, :, None]
               == segment_ids[:, None, None, None, :])
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    if bias is not None:
        logits = logits + torch.broadcast_to(bias, (B, Hq, S, T)).reshape(
            B, Hkv, G, S, T).float()

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", probs,
                       v.permute(0, 2, 1, 3).float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
