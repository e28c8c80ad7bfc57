"""The torch port's training slice against the JAX package: the fused
cross-entropy, the remat policies, the flash-attention path under
autograd, ``lm_batches`` and the ``Trainer``, on tiny configs.

Params come from the JAX package and go to the port through
``params_from_numpy``; inputs come from numpy seeds. Every comparison
states its tolerance. Flash attention runs the JAX package's Pallas
kernels in interpret mode and the port's plain versions (CPU tensors).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetorch_tpu.models import LlamaConfig as JConfig
from kubetorch_tpu.models import llama as jllama
from kubetorch_tpu.ops.xent import fused_cross_entropy as j_xent
from kubetorch_tpu.parallel import MeshSpec
from kubetorch_tpu.parallel.sharding import ShardingRules
from kubetorch_tpu.training import Trainer as JTrainer
from kubetorch_tpu.training import lm_batches as j_lm_batches
from kubetorch_tpu.training.trainer import make_default_loss as j_loss
from kubetorch_tpu_torch.models import LlamaConfig as TConfig
from kubetorch_tpu_torch.models import params_from_numpy
from kubetorch_tpu_torch.ops import flash_attention as t_fa
from kubetorch_tpu_torch.ops.xent import fused_cross_entropy as t_xent
from kubetorch_tpu_torch.training import (Trainer, host_shard,
                                          init_train_state, lm_batches,
                                          make_default_loss)
from kubetorch_tpu_torch.training.trainer import _leaves

pytestmark = pytest.mark.level("unit")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_torch(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _batch(vocab, B=2, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


def _jax_loss_and_grads(cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(j_loss(cfg, ShardingRules.default()),
                                    has_aux=True))
    (loss, aux), grads = fn(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return float(loss), aux, jax.device_get(grads)


def _torch_loss_and_grads(cfg, params, batch):
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss, aux = make_default_loss(cfg)(
        params, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), aux, grads


def _assert_grads(jgrads, tgrads, rel):
    """Each leaf's gradient within ``rel`` of its largest element, element
    by element, and within ``rel`` of its norm. Per-element relative
    bounds do not fit: an embedding row sums several tokens' terms with
    cancellation, in another order in each package."""
    jleaves = jax.tree.leaves(jgrads)      # sorted keys, as _leaves
    assert len(jleaves) == len(tgrads)
    for a, b in zip(jleaves, tgrads):
        a, b = np.asarray(a, np.float32), b.detach().numpy()
        assert a.shape == b.shape
        scale = np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)
        assert np.linalg.norm(b - a) <= rel * np.linalg.norm(a)


# --------------------------------------------------------------- xent

@pytest.mark.parametrize("backward,masked,head_grad", [
    ("streaming", False, True), ("streaming", True, True),
    ("recompute", False, True), ("recompute", True, True),
    ("streaming", True, False)])
def test_fused_cross_entropy_matches_jax(backward, masked, head_grad):
    """20 tokens in chunks of 8 (so the last chunk is padded), f32: both
    sides sum the same f32 logits per chunk, in another order."""
    rng = np.random.default_rng(10)
    B, S, E, V = 2, 10, 16, 64
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    head = (rng.standard_normal((E, V)) * 0.5).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.3).astype(np.float32) if masked else None

    def jfn(x, head):
        return j_xent(x, head, jnp.asarray(t),
                      None if mask is None else jnp.asarray(mask),
                      chunk_size=8, backward=backward, head_grad=head_grad)

    (jl, jaux), (jdx, jdw) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
    tx, th = _t(x).requires_grad_(), _t(head).requires_grad_()
    tl, taux = t_xent(tx, th, _t(t), None if mask is None else _t(mask),
                      chunk_size=8, backward=backward, head_grad=head_grad)
    tdx, tdw = torch.autograd.grad(tl, (tx, th))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    assert float(taux["tokens"]) == float(jaux["tokens"])
    np.testing.assert_allclose(float(taux["accuracy"]),
                               float(jaux["accuracy"]), rtol=1e-6)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tdw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-7)
    if not head_grad:
        assert not tdw.any()


def test_fused_cross_entropy_without_autograd_matches_dense():
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((3, 7, 8)).astype(np.float32))
    head = _t(rng.standard_normal((8, 32)).astype(np.float32))
    t = _t(rng.integers(0, 32, (3, 7)))
    loss, aux = t_xent(x, head, t, chunk_size=5)
    want = torch.nn.functional.cross_entropy((x @ head).reshape(-1, 32),
                                             t.reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert float(aux["tokens"]) == 21
    with pytest.raises(ValueError, match="streaming"):
        t_xent(x, head, t, backward="dense")


# --------------------------------------------------------------- remat

@pytest.fixture(scope="module")
def tiny_params():
    return jllama.init(jax.random.key(0), JConfig.tiny())


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_and_attn",
                                    "dots_no_mlp"])
def test_remat_policy_matches_no_remat(tiny_params, policy):
    """Checkpointing recomputes the same f32 ops in the same order: loss and
    grads must agree to rounding (the JAX package's own test, rtol 1e-6 /
    1e-5)."""
    batch = _batch(512)
    base = TConfig.tiny(remat=False)
    ref_loss, _, ref_grads = _torch_loss_and_grads(
        base, _to_torch(tiny_params), batch)
    cfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    loss, _, grads = _torch_loss_and_grads(cfg, _to_torch(tiny_params),
                                           batch)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_unknown_remat_policy_raises(tiny_params):
    cfg = TConfig.tiny(remat=True, remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        _torch_loss_and_grads(cfg, _to_torch(tiny_params), _batch(512))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(tiny_params, remat):
    """f32, 2 layers: the same math in another order. Measured: about
    1e-6 of each leaf's largest gradient; held to 1e-5."""
    batch = _batch(512, seed=1)
    jcfg = JConfig.tiny(remat=remat, remat_policy="dots_no_mlp")
    tcfg = TConfig.tiny(remat=remat, remat_policy="dots_no_mlp")
    jl, jaux, jg = _jax_loss_and_grads(jcfg, tiny_params, batch)
    tl, taux, tg = _torch_loss_and_grads(tcfg, _to_torch(tiny_params),
                                         batch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(float(taux["accuracy"]),
                               float(jaux["accuracy"]), rtol=1e-6)
    _assert_grads(jg, tg, rel=1e-5)


def test_flash_path_loss_and_grads_match_jax(monkeypatch):
    """head_dim 128, attn_impl="flash", S = 256, f32, 2 layers: the JAX
    package runs its Pallas forward and both backward kernels in interpret
    mode, the port its plain flash forward and backward (through the
    autograd Function)."""
    jcfg = JConfig.tiny(head_dim=128, attn_impl="flash", max_seq_len=256,
                        remat=True, remat_policy="dots_no_mlp")
    tcfg = TConfig.tiny(head_dim=128, attn_impl="flash", max_seq_len=256,
                        remat=True, remat_policy="dots_no_mlp")
    jp = jllama.init(jax.random.key(3), jcfg)
    batch = _batch(512, B=1, S=256, seed=2)
    jl, _, jg = _jax_loss_and_grads(jcfg, jp, batch)
    calls = []
    orig = t_fa.flash_backward_plain

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(t_fa, "flash_backward_plain", counted)
    tl, _, tg = _torch_loss_and_grads(tcfg, _to_torch(jp), batch)
    assert len(calls) == tcfg.n_layers   # one flash backward per layer
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_grads(jg, tg, rel=1e-5)


# --------------------------------------------------------------- data

def test_lm_batches_identical_to_jax():
    corpus = np.random.default_rng(12).integers(0, 1000, 5000)
    for kw in ({}, {"process_index": 1, "process_count": 2}):
        want = j_lm_batches(corpus, 4, 32, seed=5, **kw)
        got = lm_batches(corpus, 4, 32, seed=5, **kw)
        for _ in range(3):
            a, b = next(want), next(got)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    assert host_shard(8) == (0, 8)           # no process group: one process
    assert host_shard(8, 3, 4) == (6, 2)
    with pytest.raises(ValueError, match="divisible"):
        host_shard(6, 0, 4)
    with pytest.raises(ValueError, match="corpus"):
        next(lm_batches(corpus[:10], 2, 32))


# --------------------------------------------------------------- trainer

def _one_device_mesh():
    return MeshSpec(fsdp=-1).build(jax.devices()[:1])


def _port_trainer(jparams, cfg, **kw):
    host = jax.device_get(jparams)
    return Trainer(cfg, init_fn=lambda gen: params_from_numpy(host, "cpu"),
                   device="cpu", **kw)


def test_trainer_matches_jax_trainer():
    """Both trainers start from the same params with their default AdamW
    (optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1) vs
    torch.optim.AdamW at the same settings) and take 5 steps on one batch.

    The first step's gradients are the same f32 math (rounding level).
    Losses and grad norms then stay within 1e-4 relative. Params: Adam
    normalizes each gradient element, so an element whose gradient is at
    rounding level can move by up to lr in opposite directions in the two
    packages on each step; they are held to 2 · lr · steps absolute and
    to 1e-4 of their norm."""
    jcfg, tcfg = JConfig.tiny(), TConfig.tiny()
    jt = JTrainer(jcfg, _one_device_mesh(), seed=4)
    init = jax.device_get(jt.state["params"])
    tt = _port_trainer(init, tcfg)
    batch = _batch(512, B=4, S=16, seed=3)
    _, _, jg = _jax_loss_and_grads(jcfg, init, batch)
    jm = [jt.step({k: jnp.asarray(v) for k, v in batch.items()})]
    tm = [tt.step(batch)]
    _assert_grads(jg, [p.grad for p in _leaves(tt.state["params"])],
                  rel=1e-5)
    for _ in range(4):
        jm.append(jt.step({k: jnp.asarray(v) for k, v in batch.items()}))
        tm.append(tt.step(batch))
    jl = [float(m["loss"]) for m in jm]
    tl = [float(m["loss"]) for m in tm]
    assert tl[-1] < tl[0] - 0.01            # it trains
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in tm],
                               [float(m["grad_norm"]) for m in jm],
                               rtol=1e-4)
    for m in tm:
        assert set(m) == {"loss", "grad_norm", "tokens", "accuracy"}
        assert float(m["tokens"]) == 64
    assert tt.state["step"] == 5
    jfinal = jax.tree.leaves(jax.device_get(jt.state["params"]))
    for a, b in zip(jfinal, _leaves(tt.state["params"])):
        a, b = np.asarray(a, np.float32), b.detach().numpy()
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * 3e-4 * 5)
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a) + 1e-6


@pytest.mark.parametrize("ragged", [False, True])
def test_trainer_accum_matches_full_batch(tiny_params, ragged):
    """Token-weighted microbatches reproduce the full-batch masked mean and
    its gradient (SGD, so params compare directly; as the JAX package's
    own accumulation test)."""
    cfg = TConfig.tiny()
    batch = _batch(512, B=4, S=24, seed=6)
    if ragged:
        mask = np.ones((4, 24), np.float32)
        mask[0, 2:] = 0.0
        mask[1, 1:] = 0.0
        batch["mask"] = mask
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    full = _port_trainer(tiny_params, cfg, optimizer=sgd)
    acc = _port_trainer(tiny_params, cfg, optimizer=sgd, accum_steps=2)
    mf, ma = full.step(batch), acc.step(batch)
    np.testing.assert_allclose(float(ma["loss"]), float(mf["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ma["grad_norm"]),
                               float(mf["grad_norm"]), rtol=1e-4)
    assert float(ma["tokens"]) == float(mf["tokens"])
    for a, b in zip(_leaves(full.state["params"]),
                    _leaves(acc.state["params"])):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="accum_steps"):
        _port_trainer(tiny_params, cfg, accum_steps=3).step(batch)


def test_trainer_refuses_what_is_not_ported(tiny_params):
    cfg = TConfig.tiny()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        Trainer(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        Trainer.lora(cfg, None, tiny_params, None)
    tt = Trainer(cfg, device="cpu")
    for call in (lambda: tt.enable_checkpointing("/nonexistent"),
                 tt.resume, tt.save_checkpoint, tt.emergency_checkpoint):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            call()


def test_training_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(TConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(0, TConfig.tiny())


def test_smoke_profile_sum_skips_gpu_annotations():
    """chip_smoke's device-busy sum: a GPU user annotation (the optimizer's
    ``Optimizer.step#...`` range) spans kernels listed on their own and
    must not be added again; host ops are not device time."""
    import importlib.util
    import pathlib
    import types

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, ms, device=cuda, annotation=False):
        return types.SimpleNamespace(key=key, self_device_time_total=ms * 1e3,
                                     count=1, device_type=device,
                                     is_user_annotation=annotation)

    got = chip_smoke.device_kernels([
        ev("gemm", 2.0), ev("Optimizer.step#AdamW.step", 5.0,
                            annotation=True),
        ev("aten::mm", 3.0, device=cpu), ev("flash_bwd_dq_kernel", 4.0)])
    assert got == [("flash_bwd_dq_kernel", 4.0, 1), ("gemm", 2.0, 1)]
