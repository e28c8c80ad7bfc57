"""Ops of the port: norms, rotary embeddings, attention, and the two
hand-written CUDA kernels of the serving path (``quant_matmul``,
``flash_attention``). ``fused_cross_entropy`` comes with the training
slice."""

from kubetorch_tpu_torch.ops.norms import rms_norm
from kubetorch_tpu_torch.ops.rope import apply_rope, rope_angles
from kubetorch_tpu_torch.ops.attention import dot_product_attention

__all__ = ["rms_norm", "apply_rope", "rope_angles", "dot_product_attention"]
