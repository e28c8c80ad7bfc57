"""PyTorch/CUDA port of ``kubetorch_tpu``'s compute stack, for NVIDIA Hopper.

Module names follow the JAX package so each function's counterpart is easy
to find (``kubetorch_tpu.ops.quant_matmul`` ↔
``kubetorch_tpu_torch.ops.quant_matmul``). Params are plain dicts of
tensors keyed exactly like the JAX tree, so weights carry over key for key
(:func:`kubetorch_tpu_torch.models.convert.params_from_numpy`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
``cuda`` request on a host without a card raises. On a CUDA tensor each
kernel wrapper launches its hand-written kernel (``csrc/``) or raises; only
a tensor that lies on the CPU takes the kernel's plain PyTorch version.

This package imports neither ``jax`` nor anything of ``kubetorch_tpu``.
"""
