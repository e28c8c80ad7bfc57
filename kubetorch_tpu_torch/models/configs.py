"""Model configurations and named presets (port of
``kubetorch_tpu/models/configs.py``; torch dtypes behind
``compute_dtype``/``storage_dtype``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; options: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Declared for field parity with the JAX package; the MoE blocks are
    not ported yet, so a config carrying one raises."""

    num_experts: int = 8
    top_k: int = 2
    expert_mlp_dim: int = 2048
    dispatch: str = "dense"
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Llama-3-style decoder-only transformer (GQA + RoPE + SwiGLU).

    Fields match the JAX config one for one. ``remat`` and ``remat_policy``
    apply to ``llama.hidden_states`` under autograd, ``xent_chunk`` to the
    training loss (``training.make_default_loss``).
    """

    vocab_size: int = 128256
    embed_dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 14336
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"        # compute dtype
    param_dtype: str = "bfloat16"  # storage dtype
    remat: bool = True
    remat_policy: str = "nothing"
    moe: Optional[MoEConfig] = None
    max_seq_len: int = 8192
    # "auto" → flash kernel for long tileable sequences, plain otherwise
    attn_impl: str = "auto"        # auto | xla | flash
    xent_chunk: int = 512

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "MoE layers are not ported to the torch package yet")
        torch_dtype(self.dtype)
        torch_dtype(self.param_dtype)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    # ---- presets -------------------------------------------------------
    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_1b(cls, **kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, embed_dim=2048, n_layers=16, n_heads=16,
                    n_kv_heads=8, head_dim=128, mlp_dim=8192)
        base.update(kw)
        return cls(**base)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """CI config: runs on the CPU in well under a second."""
        base = dict(vocab_size=512, embed_dim=64, n_layers=2, n_heads=4,
                    n_kv_heads=2, head_dim=16, mlp_dim=128, remat=False,
                    dtype="float32", param_dtype="float32", max_seq_len=128)
        base.update(kw)
        return cls(**base)
