"""The torch port's rolling (continuous-batching) engine against the JAX
package's, on the tiny config.

One scripted run per configuration drives both engines through the same
calls (mid-flight admission and row reuse, a shared prefix, chunked
prefill with one and with two rows at once, evictions and readmission,
repetition penalty, EOS and stop sequences) and records every event; the
tests hold the port's events against JAX's. Greedy tokens must be
identical, the int8 grid's bytes and scales bit-exact; float comparisons
state their tolerance. Params come from the JAX package's init through
``params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubetorch_tpu.models import LlamaConfig as JConfig
from kubetorch_tpu.models import llama as jllama
from kubetorch_tpu.models import quant as jquant
from kubetorch_tpu.models.rolling import RollingGenerator as JRolling
from kubetorch_tpu_torch.models import LlamaConfig as TConfig
from kubetorch_tpu_torch.models import RollingGenerator, params_from_numpy
from kubetorch_tpu_torch.models import llama as tllama
from kubetorch_tpu_torch.models import rolling as trolling

pytestmark = pytest.mark.level("unit")

ENGINE = dict(max_slots=4, max_len=64, steps_per_call=4, prefill_chunk=8)
PREFIX = [5, 6, 7, 8, 9, 10]
SUFFIX = [4, 9]
RNG = np.random.default_rng(7)
A = [3, 7, 11, 2, 9]
B = [12, 40, 7]
E = [21, 22, 23, 24, 25, 26]
F = RNG.integers(1, 512, 13).tolist()       # 2 prefill chunks
G = RNG.integers(1, 512, 11).tolist()       # 2 prefill chunks
H = RNG.integers(1, 512, 20).tolist()       # 3 prefill chunks
J = RNG.integers(1, 512, 7).tolist()
K = RNG.integers(1, 512, 20).tolist()
# (weights, kv_dtype): the serving form (fused int8 weights) on both grids,
# and f32 weights once
CONFIGS = [("int8", "bf16"), ("int8", "int8"), ("f32", "bf16")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread, so that the module's
    many small torch ops do not keep every core busy while the test
    workers beside it run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(tree):
    return params_from_numpy(jax.device_get(tree), device="cpu")


def _tokens(events, rid):
    return [t for step in events for r, toks, _ in step if r == rid
            for t in toks]


def _script(eng):
    """Drive ``eng`` through the scenario → (events per step, notes)."""
    ev, notes = [], {}
    pid = eng.register_prefix(PREFIX)
    notes["a"] = eng.submit(A, max_new_tokens=10)
    notes["b"] = eng.submit(B, max_new_tokens=6, repetition_penalty=1.3)
    ev.append(eng.step())
    # mid-flight: a prefixed request beside its full prompt, and one more
    # than the free rows (it waits for a row to free)
    notes["c"] = eng.submit(SUFFIX, max_new_tokens=8, prefix_id=pid)
    notes["d"] = eng.submit(PREFIX + SUFFIX, max_new_tokens=8)
    notes["e"] = eng.submit(E, max_new_tokens=5)
    ev.append(eng.step())
    notes["queued_mid_flight"] = eng.queued
    while eng.pending:
        ev.append(eng.step())
    # chunked prefill: two rows at once, then one beside a live row
    notes["f"] = eng.submit(F, max_new_tokens=6)
    notes["g"] = eng.submit(G, max_new_tokens=6)
    eng.admit()
    notes["two_prefilling"] = eng.prefilling_rows
    eng.prefill_step()
    ev.append(eng.decode_step())
    while eng.pending:
        ev.append(eng.step())
    notes["h"] = eng.submit(H, max_new_tokens=5)
    notes["i"] = eng.submit(A, max_new_tokens=9)
    eng.admit()
    eng.prefill_step()
    notes["one_prefilling_beside_live"] = (eng.prefilling_rows,
                                           eng.active_rows)
    ev.append(eng.decode_step())
    while eng.pending:
        ev.append(eng.step())
    # evict a live, a prefilling and a queued row, then readmit two
    notes["j"] = eng.submit(J, max_new_tokens=12)
    notes["k"] = eng.submit(K, max_new_tokens=5)
    others = [eng.submit(A, max_new_tokens=12),
              eng.submit(B, max_new_tokens=12)]
    notes["q"] = eng.submit(E, max_new_tokens=4)
    ev.append(eng.step())
    notes["before_evict"] = (eng.queued, eng.prefilling_rows,
                             eng.active_rows)
    notes["evicted"] = [eng.evict(notes["q"]), eng.evict(notes["k"]),
                        eng.evict(notes["j"]), eng.evict(10 ** 6)]
    notes["after_evict"] = (eng.queued, eng.prefilling_rows,
                            eng.active_rows, eng.free_rows)
    notes["j2"] = eng.submit(J, max_new_tokens=12)
    notes["k2"] = eng.submit(K, max_new_tokens=5)
    while eng.pending:
        ev.append(eng.step())
    # EOS (a's 5th token) and a stop sequence (d's tokens 2-3)
    eng.eos_id = _tokens(ev, notes["a"])[4]
    notes["eos"] = eng.eos_id
    notes["stop"] = _tokens(ev, notes["d"])[2:4]
    notes["a2"] = eng.submit(A, max_new_tokens=10)
    notes["d2"] = eng.submit(PREFIX + SUFFIX, max_new_tokens=8,
                             stop=[notes["stop"]])
    while eng.pending:
        ev.append(eng.step())
    notes["others"] = others
    notes["prefill_tokens"] = eng.prefill_tokens
    return ev, notes


@pytest.fixture(scope="module")
def jparams():
    return jllama.init(jax.random.key(0), JConfig.tiny())


@pytest.fixture(scope="module", params=CONFIGS,
                ids=["int8w-bf16kv", "int8w-int8kv", "f32w-bf16kv"])
def runs(request, jparams):
    """(JAX run, port run) of the scenario for one configuration, made once
    per module."""
    weights, kv = request.param
    jp = jparams
    if weights == "int8":
        jp = jquant.quantize_params(jparams)
        jp = dict(jp, layers=jquant.fuse_decode_layers(jp["layers"]))
    want = _script(JRolling(jp, JConfig.tiny(), kv_dtype=kv, **ENGINE))
    got = _script(RollingGenerator(_torch(jp), TConfig.tiny(), kv_dtype=kv,
                                   device="cpu", **ENGINE))
    return want, got


# ------------------------------------------------------------- scenario

def test_events_identical_to_jax(runs):
    (want, wnotes), (got, gnotes) = runs
    assert got == want
    assert gnotes == wnotes


def test_midflight_admission_and_row_reuse(runs):
    (want, _), (got, notes) = runs
    assert notes["queued_mid_flight"] == 1       # e waited for a row
    for name in "abcde":
        rid = notes[name]
        assert _tokens(got, rid) == _tokens(want, rid)
    assert len(_tokens(got, notes["e"])) == 5


def test_prefix_matches_jax_and_full_prompt(runs):
    (want, _), (got, notes) = runs
    c, d = _tokens(got, notes["c"]), _tokens(got, notes["d"])
    assert c == _tokens(want, notes["c"])
    assert c == d and len(c) == 8


def test_chunked_prefill_one_and_two_rows(runs):
    (want, _), (got, notes) = runs
    assert notes["two_prefilling"] == 2
    assert notes["one_prefilling_beside_live"] == (1, 1)
    for name, n in (("f", 6), ("g", 6), ("h", 5), ("i", 9)):
        toks = _tokens(got, notes[name])
        assert toks == _tokens(want, notes[name]) and len(toks) == n
    # i (prompt A, decoding beside a prefilling row) agrees with a (the
    # same prompt, earlier) token for token
    assert _tokens(got, notes["i"]) == _tokens(got, notes["a"])[:9]


def test_evict_queued_prefilling_live_then_readmit(runs):
    (want, _), (got, notes) = runs
    assert notes["before_evict"] == (1, 1, 3)
    assert notes["evicted"] == [True, True, True, False]
    assert notes["after_evict"] == (0, 0, 2, 2)
    j_first = _tokens(got, notes["j"])
    j_again = _tokens(got, notes["j2"])
    assert j_first and j_again[:len(j_first)] == j_first
    assert len(j_again) == 12 and len(_tokens(got, notes["k2"])) == 5
    assert _tokens(got, notes["q"]) == _tokens(got, notes["k"]) == []
    for name in ("j2", "k2"):
        assert _tokens(got, notes[name]) == _tokens(want, notes[name])


def test_eos_and_stop(runs):
    (want, _), (got, notes) = runs
    a2, d2 = _tokens(got, notes["a2"]), _tokens(got, notes["d2"])
    assert a2 == _tokens(want, notes["a2"])
    assert d2 == _tokens(want, notes["d2"])
    a = _tokens(got, notes["a"])
    assert a2 == a[:a.index(notes["eos"]) + 1] and len(a2) < 10
    d = _tokens(got, notes["d"])
    assert d2 == d[:4] and d2[-2:] == notes["stop"]


def test_repetition_penalty(runs):
    (want, _), (got, notes) = runs
    b = _tokens(got, notes["b"])
    assert b == _tokens(want, notes["b"]) and len(b) == 6
    assert _tokens(got, notes["others"][1]) == _tokens(
        want, notes["others"][1])


# ------------------------------------------------------- chunk-mode pieces

def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _grid_and_chunk(quantized, L=2, B=3, M=12, K=4, Hkv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    chunk = {n: rng.standard_normal((L, B, K, Hkv, D)).astype(np.float32)
             for n in ("k", "v")}
    if quantized:
        grid = {n: rng.integers(-127, 128, (L, B, M, Hkv, D)).astype(np.int8)
                for n in ("k", "v")}
        grid.update({n: rng.random((L, B, M, Hkv)).astype(np.float32)
                     for n in ("ks", "vs")})
    else:
        grid = {n: rng.standard_normal((L, B, M, Hkv, D)).astype(np.float32)
                for n in ("k", "v")}
    jgrid = {n: jnp.asarray(a, jnp.bfloat16 if n in ("k", "v")
                            and not quantized else None)
             for n, a in grid.items()}
    jchunk = {n: jnp.asarray(a, jnp.bfloat16) for n, a in chunk.items()}
    return jgrid, jchunk


def _to_t(jtree):
    return {n: params_from_numpy({"x": np.asarray(jax.device_get(a))},
                                 device="cpu")["x"]
            for n, a in jtree.items()}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("rows", [None, [2, 0]], ids=["all", "subset"])
def test_merge_chunk_into_grid_bit_exact(quantized, rows):
    """Rows with count 0 stay untouched; bf16 values land exactly, int8
    bytes and f32 scales are the JAX merge's bit for bit. ``rows``: a chunk
    of two rows merged into grid rows 2 and 0, held against the JAX merge
    of the full-width chunk with those rows in place."""
    jgrid, jchunk = _grid_and_chunk(quantized)
    start, count = np.array([2, 5, 9]), np.array([4, 0, 3])
    want = jllama.merge_chunk_into_grid(jgrid, jchunk, jnp.asarray(start),
                                        jnp.asarray(count))
    grid, chunk = _to_t(jgrid), _to_t(jchunk)
    if rows is not None:
        chunk = {n: t[:, rows] for n, t in chunk.items()}
        start, count = start[rows], count[rows]
    got = tllama.merge_chunk_into_grid(grid, chunk, start, count, rows)
    assert got is grid
    for name, w in _to_t(want).items():
        assert torch.equal(_bits(got[name]), _bits(w)), name
    # row 1 (count 0) is unchanged; written int8 rows are _kv_quantize's
    for name, before in _to_t(jgrid).items():
        assert torch.equal(_bits(got[name][:, 1]), _bits(before[:, 1]))
    if quantized:
        qk, sk = tllama._kv_quantize(_to_t(jchunk)["k"][:, 2, :3])
        assert torch.equal(got["k"][:, 2, 9:12], qk)
        assert torch.equal(got["ks"][:, 2, 9:12], sk)


def _attn_inputs(dtype, quantized, seed=1):
    rng = np.random.default_rng(seed)
    Bq, T, H, Hkv, D, M, K = 2, 3, 4, 2, 16, 10, 4
    q = rng.standard_normal((Bq, T, H, D)).astype(np.float32)
    gk, gv = (rng.standard_normal((Bq, M, Hkv, D)).astype(np.float32)
              for _ in range(2))
    ek, ev = (rng.standard_normal((Bq, K, Hkv, D)).astype(np.float32)
              for _ in range(2))
    depth = np.array([7, 3])
    gmask = np.broadcast_to(np.arange(M)[None, None] < depth[:, None, None],
                            (Bq, T, M)).copy()
    emask = np.broadcast_to(np.arange(K)[None, None] <= np.arange(T)[None, :,
                                                                      None],
                            (Bq, T, K)).copy()
    j = dict(q=jnp.asarray(q, dtype), ek=jnp.asarray(ek, jnp.bfloat16
                                                     if quantized else dtype),
             ev=jnp.asarray(ev, jnp.bfloat16 if quantized else dtype),
             gmask=jnp.asarray(gmask), emask=jnp.asarray(emask))
    if quantized:
        j["gk"], j["gks"] = jllama._kv_quantize(jnp.asarray(gk))
        j["gv"], j["gvs"] = jllama._kv_quantize(jnp.asarray(gv))
    else:
        j["gk"], j["gv"] = jnp.asarray(gk, dtype), jnp.asarray(gv, dtype)
    return j, _to_t(j)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", [False, True], ids=["grid", "int8grid"])
def test_cached_attn_merged_matches_jax(dtype, quantized):
    """f32 (or bf16-rounded) operands with f32 sums on both sides, in
    another order: f32 outputs agree to 1e-5, bf16 outputs to one bf16
    rounding (2^-8 relative)."""
    j, t = _attn_inputs(dtype, quantized)
    cfg_j, cfg_t = JConfig.tiny(), TConfig.tiny()
    if quantized:
        args = ("q", "gk", "gv", "gks", "gvs", "ek", "ev", "gmask", "emask")
        want = jllama._cached_attn_merged_q(*(j[a] for a in args), cfg_j)
        got = tllama._cached_attn_merged_q(*(t[a] for a in args), cfg_t)
    else:
        args = ("q", "gk", "gv", "ek", "ev", "gmask", "emask")
        want = jllama._cached_attn_merged(*(j[a] for a in args), cfg_j)
        got = tllama._cached_attn_merged(*(t[a] for a in args), cfg_t)
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -8
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("rows", [None, [2, 0]], ids=["full", "subset"])
def test_forward_cached_chunk_mode_matches_jax(jparams, kv, rows):
    """Chunk mode over a filled grid, at chunk column 1 with two tokens a
    row: logits and the written chunk against JAX (f32 model, int8 weights
    in the fused serving layout; 1e-4). ``rows``: the port runs rows 2 and
    0 only, reading their grid rows through ``grid_rows``; held against
    those rows of the JAX full-width call."""
    cfg_j, cfg_t = JConfig.tiny(), TConfig.tiny()
    jp = jquant.quantize_params(jparams)
    jp = dict(jp, layers=jquant.fuse_decode_layers(jp["layers"]))
    Bn, M, K, T = 3, 16, 4, 2
    rng = np.random.default_rng(3)
    quant = kv == "int8"
    # fill the grid by a JAX prefill of random prompts
    P = 8
    toks = rng.integers(0, 512, (Bn, P))
    depth = np.array([8, 5, 7])
    pos = np.broadcast_to(np.arange(P)[None], (Bn, P))
    m = np.arange(M)[None, None]
    pmask = (m <= np.arange(P)[None, :, None]) & (m < depth[:, None, None])
    _, jgrid = jllama.forward_cached(
        jp, jnp.asarray(toks), jnp.asarray(pos),
        jllama.init_cache(cfg_j, Bn, M, quantized=quant), 0,
        jnp.asarray(pmask), cfg_j)
    feed = rng.integers(0, 512, (Bn, T))
    positions = depth[:, None] + 1 + np.arange(T)[None]
    gmask = np.broadcast_to(m < depth[:, None, None], (Bn, T, M)).copy()
    emask = (np.arange(K)[None, None] <= 1 + np.arange(T)[None, :, None]
             ) & np.ones((Bn, 1, 1), bool)
    cdt = jnp.bfloat16 if quant else jnp.float32
    rng_chunk = rng.standard_normal((2, cfg_j.n_layers, Bn, K, 2, 16))
    jchunk = {n: jnp.asarray(rng_chunk[i], cdt) for i, n in
              enumerate(("k", "v"))}
    wl, wc = jllama.forward_cached(
        jp, jnp.asarray(feed), jnp.asarray(positions), jgrid, None,
        jnp.asarray(gmask), cfg_j, chunk=jchunk, chunk_col=1,
        chunk_mask=jnp.asarray(emask))
    tchunk = _to_t(jchunk)
    sel = slice(None) if rows is None else rows
    kw = {} if rows is None else {"grid_rows": torch.tensor(rows)}
    gl, gc = tllama.forward_cached(
        _torch(jp), torch.from_numpy(feed[sel]),
        torch.from_numpy(positions[sel]), _to_t(jgrid), None,
        torch.from_numpy(gmask[sel]), cfg_t,
        chunk={n: c[:, sel].clone() for n, c in tchunk.items()},
        chunk_col=1, chunk_mask=torch.from_numpy(emask[sel]), **kw)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl)[sel], rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(gc[name]),
                                   np.asarray(wc[name], np.float32)[:, sel],
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- sampling

def _sampled_run(seed, record=None):
    params = tllama.init(0, TConfig.tiny(), device="cpu")
    eng = RollingGenerator(params, TConfig.tiny(), top_k=20, top_p=0.9,
                           seed=seed, device="cpu", **ENGINE)
    rids = [eng.submit(A, max_new_tokens=12, temperature=0.8),
            eng.submit(B, max_new_tokens=12),
            eng.submit(H, max_new_tokens=12, temperature=0.8),
            eng.submit(E, max_new_tokens=12, temperature=0.8)]
    ev = []
    while eng.pending:
        ev.append(eng.step())
    return [_tokens(ev, r) for r in rids]


def test_sampled_rows_reproduce_and_stay_in_support(monkeypatch):
    """Sampled rows cannot match JAX's random numbers; they reproduce under
    one seed, stay inside ``filter_logits``' support at every step, and
    leave the greedy row's tokens as an all-greedy run has them."""
    first = _sampled_run(0)
    assert _sampled_run(0) == first
    assert _sampled_run(1) != first
    filtered, draws = [], []
    plain_filter, plain_sample = trolling.filter_logits, \
        RollingGenerator._sample

    def recording_filter(logits, top_k=None, top_p=None):
        filtered.append(plain_filter(logits, top_k, top_p))
        return filtered[-1]

    def recording_sample(self, logits, temps):
        tok = plain_sample(self, logits, temps)
        draws.append((filtered[-1], tok, temps > 0))
        return tok

    monkeypatch.setattr(trolling, "filter_logits", recording_filter)
    monkeypatch.setattr(RollingGenerator, "_sample", recording_sample)
    assert _sampled_run(0) == first
    assert draws
    for allowed, tok, sampled in draws:
        ok = torch.isfinite(allowed[torch.arange(len(tok)), tok])
        assert ok[sampled].all()
    params = tllama.init(0, TConfig.tiny(), device="cpu")
    greedy = RollingGenerator(params, TConfig.tiny(), device="cpu", **ENGINE)
    rid = [greedy.submit(A, 12), greedy.submit(B, 12)][1]
    assert greedy.run()[rid] == first[1]
    assert all(0 <= t < 512 for toks in first for t in toks)


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"rules": object()}, {"adapters": {}},
    {"adapter_scale": 2.0}, {"lora_slots": 4}, {"spec_k": 4},
    {"spec_ngram": 3}, {"spec_ema_alpha": 0.5}, {"device": "cuda"},
    {"kv_dtype": "fp8"}, {"prefill_chunk": 0}],
    ids=lambda kw: next(iter(kw)))
def test_unported_arguments_raise(kw):
    if kw.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    params = tllama.init(0, TConfig.tiny(), device="cpu")
    kw = {"device": "cpu", **kw}
    err = (RuntimeError if kw["device"] == "cuda"
           else ValueError if "kv_dtype" in kw or "prefill_chunk" in kw
           else NotImplementedError)
    with pytest.raises(err, match="cuda" if err is RuntimeError
                       else "item" if err is NotImplementedError
                       else "must be"):
        RollingGenerator(params, TConfig.tiny(), **kw)
    assert not hasattr(trolling.RollingGenerator, "_slot_adapter")


def test_submit_validates():
    params = tllama.init(0, TConfig.tiny(), device="cpu")
    eng = RollingGenerator(params, TConfig.tiny(), device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(A, max_new_tokens=64 - len(A) - 3)
    with pytest.raises(KeyError):
        eng.submit(A, prefix_id=0)
    pid = eng.register_prefix(PREFIX)
    assert eng.prefix_len(pid) == len(PREFIX)
    with pytest.raises(ValueError, match="suffix"):
        eng.submit([], prefix_id=pid)
    assert eng.drop_prefix(pid) and not eng.drop_prefix(pid)
    assert eng.pending == 0 and eng.free_rows == 4
