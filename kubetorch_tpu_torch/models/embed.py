"""Text-embedding inference: pooled hidden states (port of
``kubetorch_tpu/models/embed.py``).

One forward over right-padded prompts, masked mean / last-token / first
pooling over the final hidden states, optional L2 normalization. Prompts
pad to a power-of-two bucket, so a 1025–2048-token batch runs at S = 2048
and takes the flash kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import numpy as np
import torch

from kubetorch_tpu_torch._device import check_on_device, resolve_device
from kubetorch_tpu_torch.models import llama
from kubetorch_tpu_torch.models.configs import LlamaConfig

POOLINGS = ("mean", "last", "first")


def _embed_impl(params, tokens, lens, *, pooling, normalize, cfg):
    B, P = tokens.shape
    # hidden_states already applies the final RMS norm
    x = llama.hidden_states(params, tokens, cfg).float()     # [B, P, E]
    if pooling == "mean":
        mask = torch.arange(P, device=tokens.device)[None, :] < lens[:, None]
        denom = lens[:, None].float().clamp(min=1.0)
        emb = (x * mask[:, :, None]).sum(dim=1) / denom
    elif pooling == "last":
        emb = x[torch.arange(B, device=tokens.device), lens - 1]
    else:                                                    # "first"
        emb = x[:, 0]
    if normalize:
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    return emb


class Embedder:
    """Batched embedding endpoint over the Llama decoder.

    >>> emb = Embedder(params, cfg, pooling="mean")
    >>> vecs = emb.embed([[1, 5, 9], [2, 7]])    # [2, E] float32, L2=1
    """

    def __init__(self, params: Dict[str, Any], cfg: LlamaConfig,
                 pooling: str = "mean", normalize: bool = True,
                 pad_id: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if pooling not in POOLINGS:
            raise ValueError(f"pooling must be one of {POOLINGS}, "
                             f"got {pooling!r}")
        self.device = resolve_device(device)
        check_on_device(params["embedding"], self.device, "params")
        self.params = params
        self.cfg = cfg
        self.pooling = pooling
        self.normalize = normalize
        self.pad_id = pad_id

    def embed(self, prompts: Sequence[Sequence[int]],
              bucket: int = 16) -> np.ndarray:
        """[len(prompts), embed_dim] float32. Prompts right-pad to a
        power-of-two bucket."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        if B == 0 or (lens <= 0).any():
            raise ValueError("empty prompt")
        P = bucket
        while P < lens.max():
            P *= 2
        if P > self.cfg.max_seq_len:
            raise ValueError(f"prompt length {lens.max()} exceeds "
                             f"max_seq_len {self.cfg.max_seq_len}")
        toks = np.full((B, P), self.pad_id, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        with torch.no_grad():
            out = _embed_impl(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device),
                pooling=self.pooling, normalize=self.normalize, cfg=self.cfg)
        return out.cpu().numpy()
