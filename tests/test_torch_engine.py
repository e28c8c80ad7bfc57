"""The torch port's serving engine against the JAX package's: row export
and import across the two packages, the KV pool's decisions, and
``DecodeEngine`` over both the host-only ``SimRollingEngine`` and a tiny
Llama ``RollingGenerator``, with prefix sharing and a session parked
through the store and resumed.

Greedy tokens and int8 grid bytes must be identical. Engine runs are
compared by their token streams, frames and final counters, never by tick
counts or timings: a park lands at a fixed point of a stream because the
engine's own driver thread parks the session at the start of a chosen
decode chunk (:func:`park_at_chunk`), where the engine lock is already
held. Every JAX reference result is computed once per module, torch runs
on one intra-op thread, and every ``DecodeEngine`` is closed by a
finalizer, even when its test fails.
"""

import itertools
import threading
import types
import uuid

import jax
import numpy as np
import pytest
import torch

from kubetorch_tpu.data_store import client as jclient
from kubetorch_tpu.exceptions import KVGeometryMismatch as JGeometry
from kubetorch_tpu.models import LlamaConfig as JConfig
from kubetorch_tpu.models import llama as jllama
from kubetorch_tpu.models import quant as jquant
from kubetorch_tpu.models.rolling import RollingGenerator as JRolling
from kubetorch_tpu.serving import engine as jengine
from kubetorch_tpu.serving import kvpool as jkvpool
from kubetorch_tpu_torch.data_store import client as tclient
from kubetorch_tpu_torch.exceptions import KVGeometryMismatch
from kubetorch_tpu_torch.models import LlamaConfig as TConfig
from kubetorch_tpu_torch.models import RollingGenerator, params_from_numpy
from kubetorch_tpu_torch.models.rolling import RollingDecoder, RollingService
from kubetorch_tpu_torch.observability import devstats
from kubetorch_tpu_torch.observability import tracing as ttracing
from kubetorch_tpu_torch.serving import engine as tengine
from kubetorch_tpu_torch.serving import kvpool as tkvpool

pytestmark = pytest.mark.level("unit")

ENGINE = dict(max_slots=3, max_len=96, steps_per_call=4, prefill_chunk=8)
PROMPT = [5, 9, 13, 2, 7, 11]
N_NEW = 24
SYSTEM = [21, 22, 23, 24, 25, 26, 27, 28]      # the shared prefix
USERS = [[3, 4], [8, 1, 6], [2, 2, 9, 10]]
# one session id for both packages' runs (each run drops its blob when the
# resumed program completes; the frames carry the id)
SESSION = f"sess-{uuid.uuid4().hex[:12]}"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_engine_outlives_the_module():
    """Every engine this module starts is closed by its end (threads that
    other modules of the worker left behind are not this module's)."""
    before = set(threading.enumerate())
    yield
    alive = [t.name for t in threading.enumerate()
             if t.name == "kt-engine-driver" and t.is_alive()
             and t not in before]
    assert not alive, f"engine driver threads left running: {alive}"


@pytest.fixture()
def stores(tmp_path, monkeypatch):
    """One store root under tmp_path shared by both packages (a blob one
    package parks, the other restores), plus fresh client singletons."""
    root = tmp_path / "store"
    monkeypatch.setattr(jclient, "_LOCAL_STORE", root)
    monkeypatch.setattr(jclient.DataStoreClient, "_default", None)
    monkeypatch.setattr(tclient.DataStoreClient, "_default", None)
    monkeypatch.setenv("KT_LOCAL_STORE", str(root))
    monkeypatch.delenv("KT_STORE_URL", raising=False)
    return root


@pytest.fixture()
def engines(request):
    """``engines(cls, inner, **kw)`` builds a DecodeEngine that a finalizer
    closes, whatever the test's outcome."""
    made = []

    def make(cls, inner, **kw):
        eng = cls(inner, poll_s=0.002, **kw)
        made.append(eng)
        return eng

    def close_all():
        for eng in made:
            eng.close()
        join_store_threads()

    request.addfinalizer(close_all)
    return make


def join_store_threads():
    """Wait for the engines' background offloads and blob drops, so none
    outlives the store root its test points at."""
    for t in threading.enumerate():
        if t.name in ("kt-kv-offload", "kt-kv-drop"):
            t.join(timeout=30)


def park_at_chunk(inner, dec, session_id, chunk):
    """Make ``inner`` (the rolling engine under DecodeEngine ``dec``) park
    ``session_id`` at the start of its ``chunk``-th decode chunk, on the
    driver thread, which holds the engine's (re-entrant) lock: the park
    lands at the same point of the stream in every run."""
    calls = itertools.count(1)
    decode = inner.decode_step
    parked = []

    def decode_step():
        if next(calls) == chunk:
            parked.append(dec.park(session_id))
        return decode()

    inner.decode_step = decode_step
    return parked


def stream(dec, prog):
    """Drain one program → (frames without rids, concatenated tokens)."""
    frames = [{k: v for k, v in f.items() if k != "rid"}
              for f in dec.generate(prog)]
    return frames, [t for f in frames for t in f["tokens"]]


# ------------------------------------------------- tiny Llama, both engines

@pytest.fixture(scope="module")
def params():
    jp = jquant.quantize_params(jllama.init(jax.random.key(0),
                                            JConfig.tiny()))
    jp = dict(jp, layers=jquant.fuse_decode_layers(jp["layers"]))
    return jp, params_from_numpy(jax.device_get(jp), device="cpu")


def jrolling(params, kv, **kw):
    return JRolling(params[0], JConfig.tiny(), kv_dtype=kv,
                    **{**ENGINE, **kw})


def trolling(params, kv, **kw):
    return RollingGenerator(params[1], TConfig.tiny(), kv_dtype=kv,
                            device="cpu", **{**ENGINE, **kw})


def first_chunks(eng, n_steps=2):
    rid = eng.submit(PROMPT, max_new_tokens=N_NEW)
    toks = []
    for _ in range(n_steps):
        for r, new, done in eng.step():
            assert r == rid and not done
            toks.extend(new)
    return rid, toks


def drain(eng, rid):
    out = []
    while eng.pending:
        for r, new, _ in eng.step():
            assert r == rid
            out.extend(new)
    return out


@pytest.fixture(scope="module", params=["bf16", "int8"])
def exported(request, params):
    """Per grid: a row exported from each package after the same two
    chunks, and the JAX engine's own uninterrupted stream (the exported
    row runs on to its end there). The JAX engine, idle after that, is
    the module's one JAX engine of the grid."""
    kv = request.param
    jeng = jrolling(params, kv)
    jrid, jfirst = first_chunks(jeng)
    # copied: the JAX export's host leaves may alias the engine's own
    # arrays (the penalty window), which the rest of the run rolls on
    jstate = jax.tree.map(np.array, jeng.export_row(jrid))
    expected = jfirst + drain(jeng, jrid)
    teng = trolling(params, kv)
    trid, tfirst = first_chunks(teng)
    return {"kv": kv, "expected": expected, "jax_engine": jeng,
            "jax": (jstate, jfirst),
            "torch": (teng.export_row(trid), tfirst)}


def test_port_matches_jax_before_export(exported):
    assert len(exported["expected"]) == N_NEW
    assert exported["jax"][1] == exported["torch"][1] == \
        exported["expected"][:8]


def test_jax_export_continues_in_the_port(exported, params):
    state, first = exported["jax"]
    eng = trolling(params, exported["kv"])
    rid = eng.import_row(state)
    assert first + drain(eng, rid) == exported["expected"]


def leaf_bits(x):
    """A leaf as numpy, bf16 as its int16 bits (exact comparisons)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_jax_export_round_trips_through_the_port_bit_exact(exported,
                                                          params):
    """Imported and exported again, a JAX row comes out bit for bit as it
    went in: the K/V planes (the int8 grid's (q, scale) pairs) are copied,
    never re-quantized."""
    state, _ = exported["jax"]
    eng = trolling(params, exported["kv"])
    again = eng.export_row(eng.import_row(state))
    assert sorted(again) == sorted(state)
    for name in state:
        if name == "kv":
            continue
        np.testing.assert_array_equal(leaf_bits(again[name]),
                                      leaf_bits(state[name]))
        assert leaf_bits(again[name]).dtype == leaf_bits(state[name]).dtype
    for name, blocks in state["kv"].items():
        assert sorted(again["kv"][name]) == sorted(blocks)
        for b, blk in blocks.items():
            got = leaf_bits(again["kv"][name][b])
            assert got.dtype == leaf_bits(blk).dtype
            np.testing.assert_array_equal(got, leaf_bits(blk))


def test_port_export_matches_jax_export(exported):
    """The two packages' exports of the same row: headers equal; int8
    values equal and scales within 2e-6 relative (the admission prefill's
    float32 K/V differ between the packages in the last bits: matmul
    summation order); bf16 planes within one bf16 step (2**-7
    relative)."""
    jstate, _ = exported["jax"]
    tstate, _ = exported["torch"]
    assert sorted(tstate) == sorted(jstate)
    for name in ("prompt", "tokens", "scalars", "geom", "win", "sampler",
                 "stop_flat", "stop_lens"):
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
        assert tstate[name].numpy().dtype == np.asarray(jstate[name]).dtype
    assert sorted(tstate["kv"]) == sorted(jstate["kv"])
    for name, blocks in jstate["kv"].items():
        assert sorted(blocks) == sorted(tstate["kv"][name])
        for b, blk in blocks.items():
            got = tstate["kv"][name][b].float().numpy()
            want = np.asarray(blk).astype(np.float32)
            if name in ("k", "v") and exported["kv"] == "int8":
                np.testing.assert_array_equal(got, want)
            else:
                rtol = 2e-6 if exported["kv"] == "int8" else 2 ** -7
                np.testing.assert_allclose(got, want, rtol=rtol,
                                           atol=1e-6)


def test_port_export_continues_in_jax_through_the_store(exported, params,
                                                         stores):
    state, first = exported["torch"]
    sid = f"s-{uuid.uuid4().hex[:12]}"
    tkvpool.offload_session(sid, state, quantized=exported["kv"] == "int8")
    back = jkvpool.restore_session(sid)
    assert back is not None
    eng = exported["jax_engine"]
    rid = eng.import_row(back)
    assert first + drain(eng, rid) == exported["expected"]


def test_jax_park_restores_in_the_port(exported, params, stores):
    state, first = exported["jax"]
    sid = f"s-{uuid.uuid4().hex[:12]}"
    jkvpool.offload_session(sid, state, quantized=exported["kv"] == "int8")
    back = tkvpool.restore_session(sid)
    assert back is not None
    eng = trolling(params, exported["kv"])
    rid = eng.import_row(back)
    assert first + drain(eng, rid) == exported["expected"]
    assert tkvpool.restore_session("s-missing") is None


@pytest.mark.parametrize("axis,block_tokens,kw", [
    ("block_tokens", 8, {}), ("max_len", None, {"max_len": 80})],
    ids=["block_tokens", "max_len"])
def test_geometry_mismatch_same_axis(exported, params, axis, block_tokens,
                                     kw):
    state, _ = exported["jax"]
    with pytest.raises(JGeometry) as want:
        jrolling(params, exported["kv"], **kw).import_row(
            state, block_tokens=block_tokens)
    with pytest.raises(KVGeometryMismatch) as got:
        trolling(params, exported["kv"], **kw).import_row(
            state, block_tokens=block_tokens)
    assert got.value.axis == want.value.axis == axis
    assert got.value.exported == want.value.exported


def test_export_zeroes_the_previous_occupant(params):
    eng = trolling(params, "bf16", max_slots=1)
    eng.submit(list(range(2, 42)), max_new_tokens=8)
    eng.run()
    rid = eng.submit([5, 6, 7], max_new_tokens=8)
    eng.step()
    state = eng.export_row(rid, block_tokens=16)
    dpos = int(state["scalars"][0])
    for blocks in state["kv"].values():
        plane = torch.cat([blocks[b] for b in sorted(blocks)], dim=1)
        assert plane.shape[1] > dpos and not plane[:, dpos:].any()


def test_rolling_decoder_and_service(params):
    ref = trolling(params, "int8")
    rid = ref.submit(PROMPT, max_new_tokens=N_NEW)
    expected = ref.run()[rid]
    dec = RollingDecoder(trolling(params, "int8"))
    rid = dec.submit(PROMPT, max_new_tokens=N_NEW)
    got = []
    while dec.pending():
        out = dec.step()
        got += [t for r, toks, _ in out["events"] if r == rid for t in toks]
    assert got == expected and dec.stats()["free_slots"] == 3
    svc = RollingService(trolling(params, "int8"))
    try:
        assert svc.generate(PROMPT, max_new_tokens=N_NEW) == expected
        assert list(svc.generate_iter(PROMPT, max_new_tokens=5)) == \
            expected[:5]
    finally:
        svc.close()
    assert not svc._driver.is_alive()


def test_warmup_and_devstats(params):
    eng = trolling(params, "int8")
    eng.warmup(prompt_buckets=(16,))
    assert not eng.pending and eng.free_rows == 3
    snap = eng.devstats_snapshot()
    assert snap["dispatches_total"] > 0 and snap["flops_total"] > 0
    assert eng.devstats_peaks() is None          # no peaks on the CPU
    assert devstats.hbm_stats("cpu") is None
    assert devstats.peaks_for_kind("NVIDIA H100 80GB HBM3") == (989e12,
                                                               3.35e12)
    assert devstats.peaks_for_kind("NVIDIA A10G") is None
    rid = eng.submit(PROMPT, max_new_tokens=N_NEW)
    ref = trolling(params, "int8")
    ref_rid = ref.submit(PROMPT, max_new_tokens=N_NEW)
    assert eng.run()[rid] == ref.run()[ref_rid]


# ------------------------------------------ DecodeEngine on the tiny Llama

def engine_scenario(make_dec, inner, sid):
    """Three programs over one system prompt (automatic prefix sharing),
    one session parked at its third decode chunk and resumed → (streams,
    counters)."""
    dec = make_dec(inner, prefix_split=f"len:{len(SYSTEM)}")
    out = {}
    for i, user in enumerate(USERS):
        out[f"user{i}"] = stream(dec, {"prompt": SYSTEM + user,
                                       "max_new_tokens": 12})
    parked = park_at_chunk(inner, dec, sid, 3)
    out["first"] = stream(dec, {"prompt": PROMPT, "max_new_tokens": N_NEW,
                                "session_id": sid})
    out["resumed"] = stream(dec, {"prompt": PROMPT,
                                  "max_new_tokens": N_NEW,
                                  "session_id": sid})
    with dec._wake:            # after the tick that ended the stream
        stats = dec.stats()
    out["counters"] = {k: stats[k] for k in (
        "parks", "restores", "prefix_cache_hits", "prefixes",
        "prefill_tokens_executed", "prefill_tokens_naive", "kv_blocks_used",
        "free_rows")}
    out["parked"] = parked
    return out


@pytest.fixture(scope="module")
def jax_engine_run(params, tmp_path_factory):
    """The JAX DecodeEngine + RollingGenerator scenario, once a module."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("jax-engine-store")
    mp.setattr(jclient, "_LOCAL_STORE", root)
    mp.setattr(jclient.DataStoreClient, "_default", None)
    made = []
    try:
        def make(inner, **kw):
            made.append(jengine.DecodeEngine(inner, poll_s=0.002, **kw))
            return made[-1]

        return engine_scenario(make, jrolling(params, "int8"), SESSION)
    finally:
        for eng in made:
            eng.close()
        join_store_threads()
        mp.undo()


def test_engine_streams_match_jax_through_prefix_and_park(
        jax_engine_run, params, stores, engines):
    got = engine_scenario(lambda inner, **kw: engines(
        tengine.DecodeEngine, inner, **kw), trolling(params, "int8"),
        SESSION)
    want = jax_engine_run
    assert got["parked"] == want["parked"] == [1]
    for i in range(len(USERS)):
        assert got[f"user{i}"] == want[f"user{i}"]
    # the parked program's frames end with the parked frame; the resumed
    # program continues where it stopped, with no new prefill
    assert got["first"][0][-1]["parked"]
    assert got["first"] == want["first"] and got["resumed"] == want["resumed"]
    tokens = got["first"][1] + got["resumed"][1]
    ref = trolling(params, "int8")
    rid = ref.submit(PROMPT, max_new_tokens=N_NEW)
    assert tokens == ref.run()[rid]
    assert got["counters"] == want["counters"]
    assert got["counters"]["parks"] == got["counters"]["restores"] == 1
    assert got["counters"]["prefix_cache_hits"] == 2


# -------------------------------------------- DecodeEngine on the sim twin

def sim_scenario(mod, make_dec, sid):
    sim = mod.SimRollingEngine(max_slots=2, steps_per_call=4,
                               prefill_chunk=4)
    dec = make_dec(sim, prefix_split="len:4")
    out = {}
    pid = dec.register_prefix([9, 9, 9, 9, 9])
    out["explicit"] = stream(dec, {"prompt": [1, 2], "max_new_tokens": 9,
                                   "prefix_id": pid, "tag": "explicit"})
    out["multi"] = stream(dec, {"prompts": [[1, 2, 3, 4, 5, 6],
                                            [1, 2, 3, 4, 7],
                                            [8, 8, 8, 8, 8, 8, 8, 8, 8, 8]],
                                "max_new_tokens": 10})
    parked = park_at_chunk(sim, dec, sid, 2)
    out["first"] = stream(dec, {"prompt": [3, 1, 4, 1, 5],
                                "max_new_tokens": 30, "session_id": sid})
    out["resumed"] = stream(dec, {"prompt": [3, 1, 4, 1, 5],
                                  "max_new_tokens": 30, "session_id": sid})
    with dec._wake:            # after the tick that ended the stream
        stats = dec.stats()
    out["counters"] = {k: stats[k] for k in (
        "parks", "restores", "prefix_cache_hits", "prefixes",
        "prefill_tokens_executed", "prefill_tokens_naive", "kv_blocks_used",
        "kv_row_blocks", "free_rows", "admitted_rows", "tokens")}
    out["parked"] = parked
    out["exec_count"] = (dec.exec_count("explicit"), dec.exec_count("none"))
    out["dropped"] = (dec.drop_prefix(pid), dec.stats()["prefixes"])
    return out


def test_sim_engine_frames_and_counters_match_jax(stores, engines):
    jdecs = []

    def jmake(inner, **kw):
        jdecs.append(jengine.DecodeEngine(inner, poll_s=0.002, **kw))
        return jdecs[-1]

    try:
        want = sim_scenario(jengine, jmake, SESSION)
    finally:
        for d in jdecs:
            d.close()
        join_store_threads()
    got = sim_scenario(tengine, lambda inner, **kw: engines(
        tengine.DecodeEngine, inner, **kw), SESSION)
    assert got == want
    assert got["parked"] == [1]
    assert got["exec_count"] == (1, 0) and got["dropped"][0] is True
    assert got["first"][1] + got["resumed"][1] == \
        tengine.SimRollingEngine.expected_tokens([3, 1, 4, 1, 5], 30)
    names = {s["name"] for s in ttracing.recorder.snapshot()}
    assert {"kv.offload", "kv.restore", "engine.step",
            "engine.prefix_fill"} <= names


# ------------------------------------------------------------- KV pool

def pool_script(mod):
    """One scripted sequence of pool calls → every decision it took."""
    clock = types.SimpleNamespace(monotonic=itertools.count().__next__)
    real = mod.time
    mod.time = clock
    try:
        pool = mod.PagedKVPool(budget_blocks=12, block_tokens=4,
                               split_rule="len:3")
        log = []
        for i, toks in enumerate([[1, 2, 3], [4, 5, 6, 7, 8], [9] * 9]):
            key = mod.prefix_key(toks, -1)
            pool.prefixes.insert(key, i, len(toks), -1)
            log.append(("insert", i, pool.stats()))
        hit = pool.prefixes.lookup(mod.prefix_key([1, 2, 3], -1))
        log.append(("hit", hit.pid, hit.hits))
        log.append(("reserve", pool.reserve_row(100, 10, prefix_pid=1)))
        log.append(("evicted", [e.pid for e in
                                pool.prefixes.evict_for(6)]))
        log.append(("after", pool.stats(), pool.free_blocks))
        log.append(("release", pool.release_row(100)))
        log.append(("evicted", [e.pid for e in
                                pool.prefixes.evict_for(12)]))
        log.append(("final", pool.stats(), pool.used_blocks))
        pool.prefixes.insert(mod.prefix_key([5], "tenant"), 7, 1, "tenant")
        log.append(("by_adapter", [e.pid for e in
                                   pool.prefixes.remove_by_adapter("tenant")],
                    pool.stats()))
        log.append(("split", mod.split_prompt([1, 2, 3, 4, 5], pool.split),
                    mod.padded_blocks(37, 16, 96),
                    mod.padded_blocks(5, 4, None)))
        return log
    finally:
        mod.time = real


def test_kv_pool_decisions_match_jax():
    assert pool_script(tkvpool) == pool_script(jkvpool)


# ------------------------------------------------------------- refusals

def test_refusals(params, engines):
    eng = trolling(params, "int8")
    with pytest.raises(NotImplementedError, match="item 3"):
        eng.submit(PROMPT, adapter_id=0)
    with pytest.raises(NotImplementedError, match="item 3"):
        eng.register_prefix(PROMPT, adapter_id=1)
    sim = tengine.SimRollingEngine(max_slots=1)
    for phase in ("prefill", "decode"):
        with pytest.raises(NotImplementedError,
                           match="disaggregated phases"):
            tengine.DecodeEngine(sim, phase=phase)
    with pytest.raises(NotImplementedError, match="item 3"):
        tengine.DecodeEngine(sim, adapter_pool=object())
    with pytest.raises(NotImplementedError, match="item 4"):
        tengine.DecodeEngine(types.SimpleNamespace(spec=True))
    rid, _ = first_chunks(eng, 1)
    state = dict(eng.export_row(rid), spec=np.zeros(3, np.int64))
    with pytest.raises(NotImplementedError, match="item 4"):
        trolling(params, "int8").import_row(state)
    dec = engines(tengine.DecodeEngine, trolling(params, "int8"))
    with pytest.raises(NotImplementedError, match="item 3"):
        list(dec.generate({"prompt": PROMPT, "adapter_id": 2}))
    with pytest.raises(NotImplementedError, match="disaggregated phases"):
        list(dec.generate({"prompt": PROMPT, "handoff_id": "h1"}))
    assert dec.stats()["free_rows"] == 3 and not dec.pending()
