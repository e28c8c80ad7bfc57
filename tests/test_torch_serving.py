"""The torch port's serving slice against the JAX package: quantization,
the cached forward, Generator and Embedder, on the tiny config.

Params come from the JAX package's init and go to the port through
``params_from_numpy``; every comparison states its tolerance. Greedy tokens
must be identical.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetorch_tpu.models import LlamaConfig as JConfig
from kubetorch_tpu.models import llama as jllama
from kubetorch_tpu.models import quant as jquant
from kubetorch_tpu.models.embed import Embedder as JEmbedder
from kubetorch_tpu.models.generate import Generator as JGenerator
from kubetorch_tpu.models.generate import filter_logits as j_filter_logits
from kubetorch_tpu_torch.models import LlamaConfig as TConfig
from kubetorch_tpu_torch.models import MoEConfig as TMoEConfig
from kubetorch_tpu_torch.models import Embedder, Generator, params_from_numpy
from kubetorch_tpu_torch.models import llama as tllama
from kubetorch_tpu_torch.models import quant as tquant
from kubetorch_tpu_torch.models.generate import filter_logits, sample_tokens

pytestmark = pytest.mark.level("unit")

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPTS = [[3, 7, 11, 2, 9], [5, 1], [8, 8, 8, 1, 2, 3, 4]]


@pytest.fixture(scope="module")
def jparams():
    return jllama.init(jax.random.key(0), JConfig.tiny())


def _to_torch(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _int8(jp, fuse):
    q = jquant.quantize_params(jp)
    if fuse:
        q = dict(q, layers=jquant.fuse_decode_layers(q["layers"]))
    return q


def _leaves_equal(jtree, ttree):
    assert jtree.keys() == ttree.keys()
    for key, jv in jtree.items():
        if isinstance(jv, dict):
            _leaves_equal(jv, ttree[key])
            continue
        a = np.asarray(jax.device_get(jv))
        t = ttree[key]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            assert np.array_equal(a.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16))
        else:
            assert np.array_equal(a, t.numpy()), key


# --------------------------------------------------------------- config

def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert jf == tf
    for preset in ("llama3_8b", "llama3_1b", "tiny"):
        j, t = getattr(JConfig, preset)(), getattr(TConfig, preset)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert tllama.num_params(t) == jllama.num_params(j)
    assert TConfig.tiny().compute_dtype == torch.float32
    assert TConfig.llama3_8b().storage_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="MoE"):
        TConfig.tiny(moe=TMoEConfig())


# --------------------------------------------------------------- quant

@pytest.mark.parametrize("tie", [False, True])
def test_quantize_params_bit_exact(tie):
    """int8 bytes and scales identical: both divide in f32 and round half
    to even."""
    cfg = JConfig.tiny(tie_embeddings=tie, dtype="bfloat16",
                       param_dtype="bfloat16")
    jp = jllama.init(jax.random.key(1), cfg)
    want = jquant.quantize_params(jp, quantize_unembed=True)
    got = tquant.quantize_params(_to_torch(jp), quantize_unembed=True)
    _leaves_equal(want, got)
    fused_want = jquant.fuse_decode_layers(want["layers"])
    fused_got = tquant.fuse_decode_layers(got["layers"])
    assert "wqkv" in fused_got and "wgu" in fused_got
    _leaves_equal(fused_want, fused_got)
    # dequantize: same products in bf16
    _leaves_equal(jquant.dequantize_params(want),
                  tquant.dequantize_params(got))
    with pytest.raises(ValueError, match="fused"):
        tquant.dequantize_params(dict(got, layers=fused_got))


def test_params_from_numpy_keeps_dtypes(jparams):
    tp = _to_torch(jparams)
    _leaves_equal(jparams, tp)
    q = _to_torch(_int8(jparams, fuse=True))
    assert q["layers"]["wqkv"].dtype == torch.int8
    assert q["layers"]["wqkv_scale"].dtype == torch.float32


def test_init_quantized_layout():
    cfg = TConfig.tiny(dtype="bfloat16", param_dtype="bfloat16")
    p = tquant.init_quantized(0, cfg, fuse=True, device="cpu")
    jp = jquant.init_quantized(jax.random.key(0), JConfig.tiny(
        dtype="bfloat16", param_dtype="bfloat16"), fuse=True)
    for name, jv in jp["layers"].items():
        t = p["layers"][name]
        assert tuple(t.shape) == jv.shape, name
        assert str(t.dtype).split(".")[-1] == str(jv.dtype), name
    assert set(p) == set(jp)
    again = tquant.init_quantized(0, cfg, fuse=True, device="cpu")
    assert torch.equal(p["layers"]["wgu"], again["layers"]["wgu"])


# --------------------------------------------------------------- forward

def test_forward_matches_jax(jparams):
    cfg_j, cfg_t = JConfig.tiny(), TConfig.tiny()
    toks = np.random.default_rng(0).integers(0, 512, size=(2, 12))
    want = jllama.forward(jparams, jnp.asarray(toks), cfg_j)
    got = tllama.forward(_to_torch(jparams), torch.from_numpy(toks), cfg_t)
    # f32 model, 2 layers: rounding-level differences
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("weights,kv", [("f32", "plain"), ("int8", "plain"),
                                        ("int8_fused", "plain"),
                                        ("f32", "int8"),
                                        ("int8_fused", "int8")])
def test_forward_cached_matches_jax(jparams, weights, kv):
    """Prefill, then a uniform-slot decode step and a per-sequence-slot one.
    f32 model: int8 weights take the JAX einsum on dequantized weights and
    the port's int8 plain version at decode, equal to ~1e-6 relative."""
    cfg_j, cfg_t = JConfig.tiny(), TConfig.tiny()
    jp = jparams if weights == "f32" else _int8(jparams,
                                                weights == "int8_fused")
    tp = _to_torch(jp)
    B, P, M = 2, 6, 10
    quant = kv == "int8"
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(B, P))
    lens = np.array([6, 4])
    pos = np.broadcast_to(np.arange(P)[None], (B, P))
    mask = ((np.arange(M)[None, None, :] <= np.arange(P)[None, :, None])
            & (np.arange(M)[None, None, :] < lens[:, None, None]))
    jc = jllama.init_cache(cfg_j, B, M, quantized=quant)
    tc = tllama.init_cache(cfg_t, B, M, quantized=quant, device="cpu")
    jl, jc = jllama.forward_cached(jp, jnp.asarray(toks), jnp.asarray(pos),
                                   jc, 0, jnp.asarray(mask), cfg_j,
                                   unembed_positions=jnp.asarray(lens - 1))
    tl, tc = tllama.forward_cached(tp, torch.from_numpy(toks),
                                   torch.from_numpy(pos.copy()), tc, 0,
                                   torch.from_numpy(mask), cfg_t,
                                   unembed_positions=torch.from_numpy(
                                       lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for name in jc:
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32),
                                   rtol=1e-4, atol=1e-4)
    # decode: uniform slot P, then per-sequence slots (the int8 cache takes
    # the uniform slot only, as in the JAX package)
    steps = [P] if quant else [P, np.array([P + 1, 4])]
    for write_at in steps:
        tok = rng.integers(0, 512, size=(B, 1))
        wa = np.broadcast_to(np.asarray(write_at), (B,))
        dpos = wa[:, None]
        m = np.arange(M)[None, None, :]
        dmask = (m <= wa[:, None, None]) & (
            (m < lens[:, None, None]) | (m >= P) | (m == wa[:, None, None]))
        jwa = jnp.asarray(write_at)
        twa = write_at if np.ndim(write_at) == 0 else torch.from_numpy(
            write_at)
        jl, jc = jllama.forward_cached(jp, jnp.asarray(tok),
                                       jnp.asarray(dpos), jc, jwa,
                                       jnp.asarray(dmask), cfg_j)
        tl, tc = tllama.forward_cached(tp, torch.from_numpy(tok),
                                       torch.from_numpy(dpos.copy()), tc,
                                       twa, torch.from_numpy(dmask), cfg_t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------- generate

@pytest.mark.parametrize("weights,kv", [("f32", "bf16"),
                                        ("int8_fused", "bf16"),
                                        ("int8_fused", "int8")])
def test_generate_greedy_identical_to_jax(jparams, weights, kv):
    jp = jparams if weights == "f32" else _int8(jparams, fuse=True)
    want = JGenerator(jp, JConfig.tiny(), kv_dtype=kv).generate(
        PROMPTS, max_new_tokens=16, temperature=0.0)
    got = Generator(_to_torch(jp), TConfig.tiny(), kv_dtype=kv,
                    device="cpu").generate(PROMPTS, max_new_tokens=16,
                                           temperature=0.0)
    assert got == want


def test_generate_penalty_eos_stop_identical_to_jax(jparams):
    kw = dict(max_new_tokens=12, temperature=0.0, repetition_penalty=1.3)
    want = JGenerator(jparams, JConfig.tiny()).generate(PROMPTS, **kw)
    eos = want[0][5]
    stop = [want[1][2:4]]
    kw.update(eos_id=eos, stop=stop)
    want = JGenerator(jparams, JConfig.tiny()).generate(PROMPTS, **kw)
    got = Generator(_to_torch(jparams), TConfig.tiny(),
                    device="cpu").generate(PROMPTS, **kw)
    assert got == want
    assert got[0][-1] == eos


@pytest.mark.parametrize("top_k,top_p", [(10, None), (None, 0.9),
                                         (20, 0.5)])
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(2).standard_normal((4, 512)).astype(
        np.float32) * 3
    want = np.asarray(j_filter_logits(jnp.asarray(logits), top_k, top_p))
    got = filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampled_tokens_stay_in_filtered_set():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 512)).astype(np.float32) * 2)
    gen = torch.Generator().manual_seed(0)
    for top_k, top_p in [(5, None), (None, 0.8), (8, 0.6)]:
        allowed = torch.isfinite(filter_logits(logits / 0.8, top_k, top_p))
        tok = sample_tokens(gen, logits, 0.8, top_k, top_p)
        assert allowed[torch.arange(64), tok].all()
    assert torch.equal(sample_tokens(gen, logits, 0.0, None, None),
                       logits.argmax(-1))


# --------------------------------------------------------------- embed

@pytest.mark.parametrize("pooling,normalize", [("mean", True),
                                               ("last", False),
                                               ("first", True)])
def test_embedder_matches_jax(jparams, pooling, normalize):
    want = JEmbedder(jparams, JConfig.tiny(), pooling=pooling,
                     normalize=normalize).embed(PROMPTS)
    got = Embedder(_to_torch(jparams), TConfig.tiny(), pooling=pooling,
                   normalize=normalize, device="cpu").embed(PROMPTS)
    # f32 model: rounding-level differences
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_embedder_flash_path_matches_jax():
    """head_dim 128 and attn_impl="flash" at S = 256: the JAX package runs
    its Pallas flash kernel in interpret mode, the port its plain flash
    version; f32 throughout."""
    jcfg = JConfig.tiny(head_dim=128, attn_impl="flash", max_seq_len=256)
    tcfg = TConfig.tiny(head_dim=128, attn_impl="flash", max_seq_len=256)
    jp = jllama.init(jax.random.key(2), jcfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (200, 256)]
    want = JEmbedder(jp, jcfg).embed(prompts)
    got = Embedder(_to_torch(jp), tcfg, device="cpu").embed(prompts)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------- device

def test_entry_points_raise_without_cuda(jparams):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    tp = _to_torch(jparams)
    cfg = TConfig.tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        Generator(tp, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Embedder(tp, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy(jax.device_get(jparams))
    with pytest.raises(RuntimeError, match="cuda"):
        tquant.init_quantized(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tllama.init(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tllama.init_cache(cfg, 1, 8)


def test_params_device_must_match():
    tp = tllama.init(0, TConfig.tiny(), device="cpu")
    assert tp["embedding"].device.type == "cpu"
    meta = dict(tp, embedding=tp["embedding"].to("meta"))
    with pytest.raises(ValueError, match="lies on"):
        Generator(meta, TConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        Generator(tp, TConfig.tiny(), device="meta")


# --------------------------------------------------------------- isolation

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+kubetorch_tpu\b"
    r"|from\s+kubetorch_tpu(\.|\s))", re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "kubetorch_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, (path, hits)
    # and at run time: importing every module pulls in neither
    code = ("import sys, pkgutil, importlib, kubetorch_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'kubetorch_tpu.')) or m == 'kubetorch_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_forbidden_pattern_spares_the_port_name():
    assert not _FORBIDDEN.search("from kubetorch_tpu_torch.ops import x")
    assert not _FORBIDDEN.search("import kubetorch_tpu_torch.models")
    assert _FORBIDDEN.search("from kubetorch_tpu.ops import x")
    assert _FORBIDDEN.search("import kubetorch_tpu.models")
    assert _FORBIDDEN.search("  from jax import numpy")
