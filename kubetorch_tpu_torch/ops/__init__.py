"""Ops of the port: norms, rotary embeddings, attention, the fused
cross-entropy, and the modules of the hand-written CUDA kernels
(``quant_matmul``; ``flash_attention`` with its forward and its two
backward kernels)."""

from kubetorch_tpu_torch.ops.norms import rms_norm
from kubetorch_tpu_torch.ops.rope import apply_rope, rope_angles
from kubetorch_tpu_torch.ops.attention import dot_product_attention
from kubetorch_tpu_torch.ops.xent import fused_cross_entropy

__all__ = ["rms_norm", "apply_rope", "rope_angles", "dot_product_attention",
           "fused_cross_entropy"]
