"""RMSNorm with float32 statistics (port of ``kubetorch_tpu/ops/norms.py``)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale``; statistics in float32 whatever
    the input dtype, output cast back to ``x.dtype``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    # type promotion upcasts a bf16 scale exactly inside the multiply
    return (normed * scale).to(x.dtype)
