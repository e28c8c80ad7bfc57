"""The torch port's ops against the JAX package's, on the same numpy inputs.

Each comparison runs the JAX function (Pallas kernels in interpret mode)
and its ``kubetorch_tpu_torch`` counterpart (plain versions: these tensors
lie on the CPU) and states its tolerance. The kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetorch_tpu.ops import apply_rope as j_apply_rope
from kubetorch_tpu.ops import dot_product_attention as j_dpa
from kubetorch_tpu.ops import quant_matmul as j_qm
from kubetorch_tpu.ops import rms_norm as j_rms_norm
from kubetorch_tpu.ops import rope_angles as j_rope_angles
from kubetorch_tpu.ops import flash_attention as j_fa
from kubetorch_tpu_torch.ops import apply_rope, dot_product_attention
from kubetorch_tpu_torch.ops import flash_attention as t_fa
from kubetorch_tpu_torch.ops import quant_matmul as t_qm
from kubetorch_tpu_torch.ops import rms_norm, rope_angles

pytestmark = pytest.mark.level("unit")


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------- norms/rope

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = rms_norm(_t(x), _t(scale), 1e-5)
    # f32 statistics on both sides: rounding-level differences only
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 120, size=(2, 7))
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    js, jc = j_rope_angles(jnp.asarray(pos), 16, 10000.0)
    ts, tc = rope_angles(_t(pos), 16, 10000.0)
    # f32 angles up to ~120 rad: sin/cos agree to a few f32 ulps of 120
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-5)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-5)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = apply_rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=5e-5)


@pytest.mark.parametrize("case", ["causal", "segments", "q_offset", "bias",
                                  "noncausal"])
def test_dot_product_attention_matches_jax(case):
    rng = np.random.default_rng(2)
    B, S, T, Hq, Hkv, D = 2, 6, 6, 4, 2, 8
    kw = {"causal": case != "noncausal"}
    if case == "q_offset":
        S, kw["q_offset"] = 2, 4
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    jkw, tkw = dict(kw), dict(kw)
    if case == "segments":
        seg = np.array([[0, 0, 0, 1, 1, 1], [0, 0, 1, 1, 1, 1]])
        jkw["segment_ids"], tkw["segment_ids"] = jnp.asarray(seg), _t(seg)
    if case == "bias":
        bias = rng.standard_normal((B, Hq, S, T)).astype(np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), _t(bias)
    want = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    got = dot_product_attention(_t(q), _t(k), _t(v), **tkw)
    # f32 softmax attention on both sides
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- int8 matmul

@pytest.mark.parametrize("b,k,n", [(8, 256, 512), (64, 512, 1024),
                                   (16, 384, 256)])
def test_int8_plain_matches_jax_kernel(b, k, n):
    """Plain version vs the Pallas kernel (interpret mode), f32 x: both sum
    exact f32 products of x and the int8 weights, in another order."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (np.abs(rng.standard_normal(n)) * 0.01 + 1e-4).astype(np.float32)
    want = j_qm.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(scale), interpret=True)
    got = t_qm.int8_matmul_plain(_t(x), _t(w), _t(scale))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)


def test_int8_plain_bf16_matches_jax_kernel():
    """bf16 x and scale: f32 accumulation then one rounding to bf16 on both
    sides, so at most one bf16 ulp apart (2^-7 relative)."""
    rng = np.random.default_rng(4)
    b, k, n = 4, 128, 256
    x = rng.standard_normal((b, k)).astype(np.float32)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    want = j_qm.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                            jnp.full((n,), 0.01, jnp.bfloat16),
                            interpret=True)
    got = t_qm.int8_matmul_plain(_t(x).to(torch.bfloat16), _t(w),
                                 torch.full((n,), 0.01, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=2 ** -7, atol=1e-6)


def test_int8_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((3, 64)).astype(np.float32))
    w = _t(rng.integers(-127, 128, size=(64, 32)).astype(np.int8))
    scale = torch.full((1, 32), 0.02)
    before = t_qm.int8_matmul.launches
    got = t_qm.int8_matmul(x, w, scale)
    assert torch.equal(got, t_qm.int8_matmul_plain(x, w, scale))
    assert t_qm.int8_matmul.launches == before   # no kernel launched
    with pytest.raises(TypeError, match="int8"):
        t_qm.int8_matmul(x, w.float(), scale)
    with pytest.raises(ValueError, match="K="):
        t_qm.int8_matmul(x[:, :32], w, scale)


def test_decode_matmul_viable_gate():
    w8 = torch.zeros(16, 8, dtype=torch.int8)
    s = torch.ones(8)
    assert t_qm.decode_matmul_viable(torch.zeros(4, 1, 16), w8, s)
    assert t_qm.decode_matmul_viable(torch.zeros(256, 16), w8, s)
    assert not t_qm.decode_matmul_viable(torch.zeros(257, 16), w8, s)
    assert not t_qm.decode_matmul_viable(torch.zeros(2, 16), w8, None)
    assert not t_qm.decode_matmul_viable(torch.zeros(2, 16), w8.float(), s)


def test_pick_splits_covers_k():
    """Every k row falls in exactly one non-empty split of whole 64-row
    stages, at most 8 splits (a portable cluster); the grid of (batch chunk,
    column tile, split) blocks covers every column once and fits the card's
    resident blocks whenever K allows more than one split."""
    for sms in (132, 114):
        for b, k, n in [(8, 4096, 6144), (8, 14336, 4096), (64, 4096, 28672),
                        (1, 100, 8), (256, 4096, 4096), (8, 4112, 4096),
                        (9, 1040, 256)]:
            splits, per = t_qm.pick_splits(b, k, n, sms)
            assert 1 <= splits <= 8 and per % 64 == 0
            assert (splits - 1) * per < k <= splits * per
            rows = 8 if b <= 8 else 16 if b <= 16 else 32
            tiles = -(-b // rows) * -(-n // 128)
            assert tiles * 128 >= n and (tiles // -(-b // rows) - 1) * 128 < n
            resident = sms * (2 if b <= 16 else 1)
            assert splits == 1 or tiles * splits <= resident


# --------------------------------------------------------------- flash

@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_pallas(causal):
    """Plain flash vs the Pallas kernel in interpret mode, blocks of 128,
    f32: both are f32 softmax attention (online vs materialized)."""
    rng = np.random.default_rng(6)
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 128
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = j_fa.flash_attention(jq, jk, jv, causal=causal, block_q=128,
                                block_k=128, interpret=True)
    want_o, want_lse = j_fa.flash_attention_with_lse(
        jq, jk, jv, causal=causal, block_q=128, block_k=128, interpret=True)
    got = t_fa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               block_q=128, block_k=128)
    got_o, got_lse = t_fa.flash_attention_with_lse(
        _t(q), _t(k), _t(v), causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    np.testing.assert_allclose(got_o.numpy(), _np(want_o), atol=2e-5)
    assert got_lse.shape == (B, Hq, S)
    np.testing.assert_allclose(got_lse.numpy(), _np(want_lse), atol=2e-5)


def test_flash_tiling_rule_matches_jax():
    for s, t, d in [(2048, 2048, 128), (1024, 1024, 128), (1536, 1536, 128),
                    (256, 256, 128), (96, 96, 128), (2048, 2048, 64),
                    (200, 200, 128)]:
        qs, ks = (2, s, 8, d), (2, t, 4, d)
        assert t_fa.flash_tileable(qs, ks) == j_fa.flash_tileable(qs, ks)
        assert t_fa.auto_block_q(s) == j_fa.auto_block_q(s)
        assert t_fa.auto_block_k(t) == j_fa.auto_block_k(t)


def test_flash_untileable_takes_plain_attention():
    rng = np.random.default_rng(7)
    q = _t(rng.standard_normal((1, 10, 2, 16)).astype(np.float32))
    k = _t(rng.standard_normal((1, 10, 1, 16)).astype(np.float32))
    before = t_fa.flash_forward.launches
    got = t_fa.flash_attention(q, k, k, causal=True)
    assert torch.equal(got, dot_product_attention(q, k, k, causal=True))
    assert t_fa.flash_forward.launches == before
    with pytest.raises(ValueError, match="tile"):
        t_fa.flash_attention_with_lse(q, k, k)


def test_flash_forward_refuses_autograd():
    """flash_attention under autograd (its own Function, not a tape through
    flash_forward): on the CPU its gradient equals the autograd gradient of
    dot_product_attention on the same inputs (f32 on both sides)."""
    rng = np.random.default_rng(8)
    q, k, v, g = (_t(rng.standard_normal(shape).astype(np.float32))
                  for shape in ((1, 256, 4, 128), (1, 256, 2, 128),
                                (1, 256, 2, 128), (1, 256, 4, 128)))
    for causal in (True, False):
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        out = t_fa.flash_attention(*a, causal=causal, block_q=128,
                                   block_k=128)
        assert out.grad_fn is not None
        got = torch.autograd.grad(out, a, g)
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(
            dot_product_attention(*b, causal=causal), b, g)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                       atol=1e-5)


def _jax_flash_bwd_case(causal, seed):
    """Inputs and the JAX package's _flash_backward (Pallas, interpret mode,
    blocks of 128) at B = 1, S = 256, 4/2 heads, D = 128, f32. Returns the
    [B,S,H,D] numpy inputs, lse [B,H,S], delta [B,H,S] and the JAX (dq, dk,
    dv) in [B,S,H,D], for an external delta (0.5 · rowsum(dO·O)) and the
    default one."""
    rng = np.random.default_rng(seed)
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 128
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    tr = (lambda a: jnp.asarray(a).transpose(0, 2, 1, 3))
    kw = dict(scale=D ** -0.5, causal=causal, block_q=128, block_k=128,
              interpret=True)
    out, lse = j_fa._flash_forward(tr(q), tr(k), tr(v), **kw)
    delta = j_fa.flash_bwd_delta(tr(g), out)
    half = delta * 0.5
    res = {}
    for name, d in (("default", None), ("external", half)):
        dq, dk, dv = j_fa._flash_backward(tr(q), tr(k), tr(v), out, lse,
                                          tr(g), delta=d, **kw)
        res[name] = [np.array(a.transpose(0, 2, 1, 3)) for a in
                     (dq, dk, dv)]
    return ((q, k, v, g, np.array(out.transpose(0, 2, 1, 3))),
            np.array(lse[..., 0]), np.array(delta[..., 0]),
            np.array(half[..., 0]), res)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_plain_matches_jax_pallas(causal):
    """Plain FA2 backward vs the Pallas dq and dk/dv kernels in interpret
    mode on the same (out, lse), f32: blockwise vs materialized sums of the
    same f32 terms."""
    (q, k, v, g, out), lse, delta, half, want = _jax_flash_bwd_case(causal, 9)
    np.testing.assert_allclose(
        t_fa.flash_bwd_delta(_t(g), _t(out)).numpy(), delta, rtol=1e-6,
        atol=1e-6)
    for name, d in (("default", None), ("external", _t(half))):
        got = t_fa.flash_backward(_t(q), _t(k), _t(v), _t(out), _t(lse),
                                  _t(g), scale=128 ** -0.5, causal=causal,
                                  delta=d)
        for x, y in zip(got, want[name]):
            np.testing.assert_allclose(x.numpy(), y, rtol=1e-4, atol=2e-5)


def test_flash_backward_checks_shapes_and_counts_no_cpu_launch():
    q = torch.zeros(1, 64, 2, 128)
    k = torch.zeros(1, 64, 1, 128)
    lse = torch.zeros(1, 2, 64)
    before = (t_fa.flash_backward.dq_launches,
              t_fa.flash_backward.dkv_launches)
    dq, dk, dv = t_fa.flash_backward(q, k, k, q, lse, q, scale=1.0,
                                     causal=True)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (t_fa.flash_backward.dq_launches,
            t_fa.flash_backward.dkv_launches) == before
    with pytest.raises(ValueError, match="lse"):
        t_fa.flash_backward(q, k, k, q, lse[:, :1], q, scale=1.0,
                            causal=True)
    with pytest.raises(ValueError, match="dO"):
        t_fa.flash_backward(q, k, k, q, lse, q[:, :32], scale=1.0,
                            causal=True)
    with pytest.raises(ValueError, match="device"):
        t_fa.flash_backward(q.to("meta"), k.to("meta"), k.to("meta"),
                            q.to("meta"), lse.to("meta"), q.to("meta"),
                            scale=1.0, causal=True)


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its .cu and every csrc/*.cuh it may include:
    editing a shared header changes the path, so a stale build is never
    loaded (no nvcc needed: only the names are computed)."""
    from kubetorch_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(p.parent == tmp_path / "_build" for p in before.values())
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    (csrc / "flash_fwd.cu").write_text(
        (csrc / "flash_fwd.cu").read_text() + "\n")
    again = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert again["flash_fwd"] != after["flash_fwd"]
    assert again["flash_bwd"] == after["flash_bwd"]
