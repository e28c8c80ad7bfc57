"""Autoregressive generation: prefill + a decode loop over a preallocated
KV cache (port of ``kubetorch_tpu/models/generate.py``).

Shape discipline as in the JAX package: prompts are right-padded to a
common length ``Pmax``, the cache is one static buffer of
``Pmax + max_new_tokens`` slots, and generated tokens go at uniform slots
``Pmax + step`` with RoPE position ``prompt_len[b] + step``; attention masks
out each sequence's pad gap ``[prompt_len[b], Pmax)``. The decode loop is a
Python loop that mirrors the JAX scan step for step, including the one
forward per step whose logits the last step never reads.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from kubetorch_tpu_torch._device import check_on_device, resolve_device
from kubetorch_tpu_torch.models import llama
from kubetorch_tpu_torch.models.configs import LlamaConfig

_TOP_P_CANDIDATES = 2048  # nucleus threshold search space (the JAX
                          # package's bound: exact unless the nucleus is
                          # wider than this many tokens)


def filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Apply top-k and/or nucleus (top-p) filtering to [B, V] logits."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        # threshold search over the top candidates only; probabilities
        # still normalize over the full vocab
        c = min(_TOP_P_CANDIDATES, logits.shape[-1])
        cand = torch.topk(logits, c, dim=-1).values       # [B, c] descending
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        probs = torch.exp(cand - logz)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (always
        # keep the argmax); threshold = logit of the last kept token
        keep = cum - probs < top_p
        kth = torch.where(keep, cand, torch.full_like(cand, float("inf"))
                          ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def sample_tokens(gen: torch.Generator, logits: torch.Tensor,
                  temperature: float, top_k: Optional[int],
                  top_p: Optional[float]) -> torch.Tensor:
    """Sample [B] token ids from [B, V] logits (greedy iff temperature==0).
    The random numbers differ from the JAX package's for the same seed."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits / temperature, top_k, top_p)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class Generator:
    """Batched KV-cache text generation for the Llama decoder.

    >>> gen = Generator(params, cfg)          # params on the card
    >>> out = gen.generate([[1, 5, 9], [1, 7]], max_new_tokens=16,
    ...                    temperature=0.8, top_p=0.9, eos_id=2, seed=0)

    ``kv_dtype="int8"``: per-vector-quantized KV cache (half the cache
    bytes). ``device`` is where the params lie and the work runs: ``cuda``
    unless the caller asks for ``cpu``.
    """

    def __init__(self, params: Dict[str, Any], cfg: LlamaConfig,
                 pad_id: int = 0, kv_dtype: str = "bf16",
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        check_on_device(params["embedding"], self.device, "params")
        self.params = params
        self.cfg = cfg
        self.pad_id = pad_id
        self.kv_quantized = kv_dtype == "int8"

    # -------------------------------------------------------------- impl
    def prefill(self, tokens: torch.Tensor, prompt_lens: torch.Tensor,
                max_len: int):
        """Run the padded prompts [B, P] through a fresh cache of
        ``max_len`` slots → (next-token logits [B, V], cache)."""
        B, P = tokens.shape
        dev = self.device
        positions = torch.arange(P, device=dev)[None, :].expand(B, P)
        # causal over the prompt region; pad queries produce unused rows
        m = torch.arange(max_len, device=dev)[None, None, :]
        t = torch.arange(P, device=dev)[None, :, None]
        mask = (m <= t) & (m < prompt_lens[:, None, None])
        cache = llama.init_cache(self.cfg, B, max_len,
                                 quantized=self.kv_quantized, device=dev)
        # next-token logits at each sequence's last real token only
        logits, cache = llama.forward_cached(
            self.params, tokens, positions, cache, 0, mask, self.cfg,
            unembed_positions=prompt_lens - 1)
        return logits[:, 0], cache

    def _decode(self, cache, first_logits, prompt_lens, gen, win, *,
                n_steps, temperature, top_k, top_p, eos_id,
                repetition_penalty):
        B = first_logits.shape[0]
        M = cache["k"].shape[2]
        Pmax = M - n_steps
        dev = self.device
        slot_idx = torch.arange(M, device=dev)[None, :]
        logits = first_logits
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        toks = []
        for i in range(n_steps):
            if repetition_penalty != 1.0:
                # HF semantics over the rolling last-W window (−1 = empty);
                # empty slots scatter into a spare column that is dropped
                V = logits.shape[-1]
                gathered = logits.gather(1, win.clamp(min=0))
                adjusted = torch.where(gathered > 0,
                                       gathered / repetition_penalty,
                                       gathered * repetition_penalty)
                sidx = torch.where(win >= 0, win, torch.full_like(win, V))
                spare = torch.cat([logits, logits.new_zeros(B, 1)], dim=1)
                logits = spare.scatter(1, sidx, adjusted)[:, :V]
            tok = sample_tokens(gen, logits, temperature, top_k, top_p)
            tok = torch.where(done, torch.full_like(tok, self.pad_id), tok)
            if eos_id is not None:
                done = done | (tok == eos_id)
            win = torch.cat([win[:, 1:], tok[:, None]], dim=1)
            write_at = Pmax + i
            positions = (prompt_lens + i)[:, None]
            # attend: real prompt slots + generated slots up to write_at
            mask = ((slot_idx < prompt_lens[:, None])
                    | ((slot_idx >= Pmax) & (slot_idx <= write_at)))[:, None]
            step_logits, cache = llama.forward_cached(
                self.params, tok[:, None], positions, cache, write_at, mask,
                self.cfg)
            logits = step_logits[:, 0]
            toks.append(tok)
        return torch.stack(toks, dim=1), done

    # -------------------------------------------------------------- api
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 128,
        temperature: float = 0.7,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        repetition_penalty: float = 1.0,
        stop: Optional[Sequence[Sequence[int]]] = None,
    ) -> List[List[int]]:
        """Generate continuations; returns per-prompt token lists
        (truncated at ``eos_id`` if given, which is included).
        ``repetition_penalty`` (HF semantics, last-64-token window seeded
        from the prompt tail) applies every step; ``stop`` sequences trim
        the result afterwards."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int64)
        if (lens <= 0).any():
            raise ValueError("empty prompt")
        Pmax = int(lens.max())
        toks = np.full((B, Pmax), self.pad_id, np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        max_len = Pmax + max_new_tokens
        if max_len > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt+generation {max_len} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        W = 64
        win0 = np.full((B, W), -1, np.int64)
        if repetition_penalty != 1.0:
            for i, p in enumerate(prompts):
                tail = list(p)[-W:]
                win0[i, -len(tail):] = tail
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        lens_t = torch.from_numpy(lens).to(dev)
        with torch.no_grad():
            first_logits, cache = self.prefill(
                torch.from_numpy(toks).to(dev), lens_t, max_len)
            out, _ = self._decode(
                cache, first_logits, lens_t, gen,
                torch.from_numpy(win0).to(dev), n_steps=max_new_tokens,
                temperature=float(temperature), top_k=top_k, top_p=top_p,
                eos_id=eos_id,
                repetition_penalty=float(repetition_penalty))
        out = out.cpu().numpy()
        stop_seqs = [list(s) for s in (stop or []) if s]
        results: List[List[int]] = []
        for row in out:
            seq = row.tolist()
            if eos_id is not None and eos_id in seq:
                seq = seq[:seq.index(eos_id) + 1]
            for sseq in stop_seqs:
                n = len(sseq)
                for end in range(n, len(seq) + 1):
                    if seq[end - n:end] == sseq:
                        seq = seq[:end]
                        break
            results.append(seq)
        return results
