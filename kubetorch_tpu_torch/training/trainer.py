"""Training loop on one device (port of
``kubetorch_tpu/training/trainer.py``).

The state is ``{"params", "opt_state", "step"}`` as in the JAX package,
with a ``torch.optim`` optimizer in ``opt_state``: a torch optimizer holds
its moments itself and updates the params in place, so the optimizer
argument is a factory, ``optimizer(params) -> torch.optim.Optimizer`` (the
counterpart of an optax transformation, which is not bound to params
either). The default matches ``optax.adamw(3e-4, b1=0.9, b2=0.95,
weight_decay=0.1)``. ``init_fn(generator) -> params`` is the counterpart
of the JAX ``init_fn(key)``.

Not ported yet, and refused with ``NotImplementedError``: meshes and
sharding (the multi-GPU slice), checkpointing and its resilience hooks,
and ``Trainer.lora``.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from kubetorch_tpu_torch._device import resolve_device
from kubetorch_tpu_torch.models import llama
from kubetorch_tpu_torch.models.configs import LlamaConfig
from kubetorch_tpu_torch.ops.xent import fused_cross_entropy

TrainState = Dict[str, Any]
OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

_MULTI_GPU = "the multi-GPU slice (ROADMAP.md Queue 1 item 5)"
_CHECKPOINTS = ("training/checkpoint.py, which is not ported yet "
                "(ROADMAP.md Queue 1 item 4)")

default_optimizer: OptimizerFactory = functools.partial(
    torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.95), eps=1e-8,
    weight_decay=0.1)


def cross_entropy_loss(
    logits: torch.Tensor,                  # [B, S, V] float32
    targets: torch.Tensor,                 # [B, S] int
    mask: Optional[torch.Tensor] = None,   # [B, S] {0, 1}
):
    """Masked mean softmax cross-entropy (float32, logsumexp-stable).

    Returns ``(loss, aux)`` with token count and accuracy in ``aux``.
    """
    targets = targets.long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    per_tok = logz - gold
    mask = (torch.ones_like(per_tok) if mask is None else mask.float())
    n_tok = torch.clamp(mask.sum(), min=1.0)
    loss = (per_tok * mask).sum() / n_tok
    acc = ((logits.argmax(-1) == targets) * mask).sum() / n_tok
    return loss, {"tokens": n_tok, "accuracy": acc.detach()}


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree in the JAX package's leaf order
    (sorted keys)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    return [tree]


def init_train_state(
    seed: Union[int, torch.Generator],
    cfg: LlamaConfig,
    optimizer: Optional[OptimizerFactory] = None,
    init_fn: Optional[Callable[[torch.Generator], Any]] = None,
    device: Union[str, torch.device] = "cuda",
) -> TrainState:
    """Params (``llama.init``, or ``init_fn(generator)``) as leaf tensors
    that require grad, and the optimizer built over them."""
    dev = resolve_device(device)
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = (llama.init(gen, cfg, device=dev) if init_fn is None
              else init_fn(gen))
    leaves = _leaves(params)
    for t in leaves:
        if t.device.type != dev.type:
            raise ValueError(f"a param lies on {t.device}, expected {dev}")
        t.requires_grad_(True)
    opt = (optimizer or default_optimizer)(leaves)
    return {"params": params, "opt_state": opt, "step": 0}


def make_default_loss(cfg: LlamaConfig, head_grad: bool = True) -> Callable:
    """The LM objective: fused chunked cross-entropy over hidden states —
    never materializes [B, S, V] float32 logits (ops/xent.py)."""

    def default_loss(params, batch):
        x = llama.hidden_states(
            params, batch["inputs"], cfg,
            segment_ids=batch.get("segment_ids"),
            positions=batch.get("positions"))
        return fused_cross_entropy(
            x, llama.unembedding(params, cfg), batch["targets"],
            batch.get("mask"), chunk_size=cfg.xent_chunk,
            head_grad=head_grad)

    return default_loss


def make_train_step(
    cfg: LlamaConfig,
    loss_fn: Optional[Callable] = None,
    accum_steps: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], tuple]:
    """``train_step(state, batch) -> (state, metrics)``: gradients of
    ``loss_fn(params, batch) -> (loss, aux)``, then one optimizer update
    of the params in place.

    ``accum_steps > 1`` splits the batch's leading dim into that many
    microbatches, weights each microbatch's gradient by its token count
    (``aux["tokens"]``, else 1) and divides by the total: the full-batch
    masked mean, with the activation memory of one microbatch.
    """
    compute_loss = loss_fn or make_default_loss(cfg)

    def compute_grads(params, batch):
        if accum_steps <= 1:
            loss, aux = compute_loss(params, batch)
            loss.backward()
            return loss.detach(), aux
        B = next(iter(batch.values())).shape[0]
        if B % accum_steps:
            raise ValueError(
                f"batch dim {B} not divisible by accum_steps={accum_steps}")
        mb = B // accum_steps
        loss_sum = w_sum = 0.0
        aux_sum: Dict[str, torch.Tensor] = {}
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, aux = compute_loss(params, micro)
            w = aux.get("tokens", torch.ones((), device=loss.device))
            w = w.detach()
            (loss * w).backward()
            loss_sum = loss_sum + loss.detach() * w
            for k, a in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + a.detach() * w
            w_sum = w_sum + w
        inv = 1.0 / w_sum
        for p in _leaves(params):
            if p.grad is not None:
                p.grad.mul_(inv.to(p.grad.dtype))
        aux = {k: a * inv for k, a in aux_sum.items()}
        if "tokens" in aux:
            aux["tokens"] = w_sum   # a count, not an average
        return loss_sum * inv, aux

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        loss, aux = compute_grads(params, batch)
        leaves = _leaves(params)
        for p in leaves:
            if p.grad is None:      # unused by the loss: a zero gradient,
                p.grad = torch.zeros_like(p)   # as optax sees it
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad, dtype=torch.float32)
             for p in leaves]))
        opt.step()
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm, **aux}

    return train_step


class Trainer:
    """Single-device trainer: owns the state and the step.

    ``Trainer(cfg)`` trains ``llama.init`` params with the default AdamW;
    ``loss_fn(params, batch) -> (loss, aux)`` overrides the LM objective,
    ``accum_steps`` enables gradient accumulation and ``init_fn(generator)
    -> params`` overrides the trained tree.
    """

    def __init__(
        self,
        cfg: LlamaConfig,
        mesh=None,
        optimizer: Optional[OptimizerFactory] = None,
        rules=None,
        seed: int = 0,
        loss_fn=None,
        accum_steps: int = 1,
        init_fn=None,
        device: Union[str, torch.device] = "cuda",
    ):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                f"Trainer(mesh=..., rules=...): meshes and sharding come "
                f"with {_MULTI_GPU}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.optimizer = optimizer or default_optimizer
        self.state = init_train_state(seed, cfg, self.optimizer,
                                      init_fn=init_fn, device=self.device)
        self._step = make_train_step(cfg, loss_fn=loss_fn,
                                     accum_steps=accum_steps)
        self._step_count = 0

    @classmethod
    def lora(cls, *args, **kwargs) -> "Trainer":
        raise NotImplementedError(
            "Trainer.lora: LoRA fine-tuning comes with the LoRA slice "
            "(ROADMAP.md Queue 1 item 2)")

    def enable_checkpointing(self, *args, **kwargs) -> "Trainer":
        raise NotImplementedError(f"checkpointing needs {_CHECKPOINTS}")

    def resume(self) -> int:
        raise NotImplementedError(f"resume needs {_CHECKPOINTS}")

    def save_checkpoint(self, wait: bool = False) -> int:
        raise NotImplementedError(f"save_checkpoint needs {_CHECKPOINTS}")

    def emergency_checkpoint(self) -> dict:
        raise NotImplementedError(
            f"emergency_checkpoint needs {_CHECKPOINTS}")

    def step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (numpy arrays or tensors; they
        are moved to the trainer's device). Returns 0-d tensors:
        ``loss``, ``grad_norm``, ``tokens``, ``accuracy``."""
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        self.state, metrics = self._step(self.state, batch)
        self._step_count += 1
        return metrics

    def benchmark(self, batch: Dict[str, Any], n_steps: int = 10,
                  warmup: int = 2) -> Dict[str, float]:
        """Steady-state step time and tokens/sec. The timed region ends
        with a host fetch of the last step's loss, which waits for the
        whole step chain on the device."""
        for _ in range(warmup):
            metrics = self.step(batch)
        if warmup:
            float(metrics["loss"])
        t0 = time.perf_counter()
        for _ in range(n_steps):
            metrics = self.step(batch)
        loss = float(metrics["loss"])
        dt = (time.perf_counter() - t0) / n_steps
        tokens = int(batch["inputs"].shape[0] * batch["inputs"].shape[1])
        return {
            "step_time_s": dt,
            "tokens_per_sec": tokens / dt,
            "loss": loss,
        }


__all__ = ["Trainer", "TrainState", "cross_entropy_loss", "default_optimizer",
           "init_train_state", "make_default_loss", "make_train_step"]
