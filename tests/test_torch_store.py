"""The torch port's store path against the JAX package's: the MessagePack
headers, the packed-array blob format under every codec, delta publishes
and the streaming unpacker.

The same seeded tree (float32, bfloat16 and int8 leaves, plus the int64
and int32 leaves of an exported row) goes through both packages. Blobs
must be byte-identical for the ``raw``, ``int8`` and ``zlib`` codecs, a
blob packed by either package must unpack in the other to the same
values (bit for bit: every comparison here is exact), and a delta
re-publish must ship the same patch. Each package writes to its own store
under ``tmp_path``.
"""

import uuid

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from kubetorch_tpu.data_store import client as jclient
from kubetorch_tpu.data_store import codec as jcodec
from kubetorch_tpu.data_store import device_transfer as jdt
from kubetorch_tpu_torch.data_store import client as tclient
from kubetorch_tpu_torch.data_store import codec as tcodec
from kubetorch_tpu_torch.data_store import device_transfer as tdt
from kubetorch_tpu_torch.data_store import msgpack_lite
from kubetorch_tpu_torch.data_store.types import BLOB_DELTA_SUFFIX

pytestmark = pytest.mark.level("unit")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    """Each package's local store (and restore cache) under tmp_path."""
    jroot, troot = tmp_path / "jax-store", tmp_path / "torch-store"
    monkeypatch.setattr(jclient, "_LOCAL_STORE", jroot)
    monkeypatch.setattr(jclient.DataStoreClient, "_default", None)
    monkeypatch.setattr(tclient.DataStoreClient, "_default", None)
    monkeypatch.setenv("KT_LOCAL_STORE", str(troot))
    monkeypatch.setenv("KT_RESTORE_CACHE", str(tmp_path / "rcache"))
    monkeypatch.delenv("KT_STORE_URL", raising=False)
    yield jroot, troot


def np_tree(seed=0, blocks=4):
    """A tree shaped like an exported row: per-block K/V leaves (bf16 on
    one plane, int8 + f32 scales on the other), f32 logits and int
    headers."""
    rng = np.random.default_rng(seed)
    bf = ml_dtypes.bfloat16
    return {
        "kv": {
            "k": {f"{b:05d}": rng.standard_normal((2, 16, 2, 8)).astype(bf)
                  for b in range(blocks)},
            "q": {f"{b:05d}": rng.integers(-127, 128, (2, 16, 2, 8),
                                           dtype=np.int8)
                  for b in range(blocks)},
            "s": {f"{b:05d}": rng.random((2, 16, 2)).astype(np.float32)
                  for b in range(blocks)},
        },
        "logits": rng.standard_normal(512).astype(np.float32),
        "w2d": rng.standard_normal((8, 32)).astype(np.float32),
        "win": np.full(64, -1, np.int32),
        "scalars": np.asarray([37, 5, 32, -1, 0, 16], np.int64),
        "empty": np.zeros((0, 3), np.float32),
    }


def to_torch(x):
    if isinstance(x, dict):
        return {k: to_torch(v) for k, v in x.items()}
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(x.copy())


def bits(x):
    """A leaf as numpy (bf16 as its int16 bits), for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def dtype_name(x):
    if isinstance(x, torch.Tensor):
        return tcodec.dtype_name(x.dtype)
    return np.asarray(x).dtype.name


def assert_same_leaves(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert dtype_name(g) == dtype_name(w)
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_array_equal(bits(g), bits(w))


# ------------------------------------------------------------- headers

@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63,
    1.5, "", "a" * 31, "a" * 32, "é" * 300, b"\x00" * 300,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(16)}, (1, (2,)), [[0, 10], [1, 5, 7]],
    {"treedef": "PyTreeDef({'a': *})", "codec": "int8",
     "leaves": [{"shape": [2, 3], "dtype": "bfloat16", "codec": "int8",
                 "cols": 3, "sdt": "float32"}], "digests": ["ab" * 8]},
], ids=lambda o: type(o).__name__)
def test_msgpack_lite_matches_msgpack(obj):
    assert msgpack_lite.packb(obj) == msgpack.packb(obj)
    assert msgpack_lite.unpackb(msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj))


def test_msgpack_lite_rejects_trailing_and_truncated_bytes():
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb([1, 2, 300])[:-1])


def test_tree_spec_and_leaf_order_match_jax():
    import jax

    tree = np_tree()
    tree["nested"] = {"t": (np.zeros(1), np.zeros(2)), "l": [np.zeros(3)],
                      "none": None, "one": (np.zeros(1),)}
    leaves, spec = tdt.tree_flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert spec == str(jdef)
    assert [id(x) for x in leaves] == [id(x) for x in jleaves]
    rebuilt = tdt.tree_unflatten(tree, leaves)
    assert tdt.tree_flatten(rebuilt)[1] == spec


# ---------------------------------------------------------------- blobs

@pytest.mark.parametrize("codec", ["raw", "int8", "zlib"])
def test_blobs_byte_identical(codec):
    tree = np_tree()
    want = jdt.pack_arrays(tree, codec=codec)
    assert tdt.pack_arrays(to_torch(tree), codec=codec) == want
    # and streamed in chunks
    assert b"".join(bytes(c) for c in tdt.iter_packed(
        to_torch(tree), chunk=100, codec=codec)) == want


@pytest.mark.parametrize("codec", ["raw", "int8", "zlib"])
def test_blob_unpacks_in_the_other_package(codec):
    tree = np_tree(seed=1)
    jblob = jdt.pack_arrays(tree, codec=codec)
    tblob = tdt.pack_arrays(to_torch(tree), codec=codec)
    want = jdt.unpack_arrays(jblob)
    # JAX blob → port, port blob → JAX: the same leaves, bit for bit
    # (int8-coded leaves dequantize to the same values in both)
    assert_same_leaves(tdt.unpack_arrays(jblob), want)
    assert_same_leaves(jdt.unpack_arrays(tblob, copy=True), want)
    back = tdt.unpack_arrays(jblob, template=tree)
    assert tdt.tree_flatten(back)[1] == tdt.tree_flatten(tree)[1]


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("chunk", [1, 7, 64, 4093, 1 << 20])
def test_stream_unpacker_any_chunking(codec, chunk):
    tree = np_tree(seed=2)
    blob = jdt.pack_arrays(tree, codec=codec)
    want = [a for _, a in jdt.iter_unpack_arrays([blob])]
    pieces = [blob[i:i + chunk] for i in range(0, len(blob), chunk)]
    got = dict(tdt.iter_unpack_arrays(pieces))
    assert sorted(got) == list(range(len(want)))
    assert_same_leaves([got[i] for i in range(len(want))], want)
    with pytest.raises(ValueError, match="short read"):
        list(tdt.iter_unpack_arrays([blob[:-1]]))


def test_int8_dequant_matches_jax_host_dequant():
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, (6, 10), dtype=np.int8)
    scale = rng.random(6).astype(np.float32)
    for jdtype, tdtype in ((np.float32, torch.float32),
                           (ml_dtypes.bfloat16, torch.bfloat16)):
        want = jcodec.QuantLeaf(q, scale, q.shape, np.dtype(jdtype),
                                10).dequant()
        got = tcodec.dequant(torch.from_numpy(q), torch.from_numpy(scale),
                             tdtype)
        np.testing.assert_array_equal(bits(got), bits(want))


def test_zstd_degrades_and_refuses_like_the_reference(monkeypatch):
    monkeypatch.setattr(jcodec, "_zstd", lambda: None)
    monkeypatch.setattr(tcodec, "_zstd", lambda: None)
    assert tcodec.resolve_codec("zstd") == jcodec.resolve_codec("zstd")
    tree = np_tree(seed=4)
    assert (tdt.pack_arrays(to_torch(tree), codec="zstd")
            == jdt.pack_arrays(tree, codec="zstd"))
    # a genuinely zstd-framed blob needs the module to decode
    header = tcodec.build_header(
        "PyTreeDef(*)", [{"shape": [4], "dtype": "float32",
                          "codec": "zstd"}], "zstd")
    blob = header + (4).to_bytes(8, "little") + b"\x28\xb5\x2f\xfd"
    with pytest.raises(ValueError, match="zstandard"):
        tdt.unpack_arrays(blob)


# ---------------------------------------------------- store round trips

def test_put_get_across_packages(stores):
    jroot, troot = stores
    tree = np_tree(seed=5)
    key = f"t/{uuid.uuid4().hex}"
    jdt.put_arrays(key, tree, codec="raw")
    tdt.put_arrays(key, to_torch(tree), codec="raw")
    assert (jroot / key).read_bytes() == (troot / key).read_bytes()
    got = tdt.get_arrays(key, template=tree)
    assert_same_leaves(tdt.tree_flatten(got)[0], jdt.unpack_arrays(
        (jroot / key).read_bytes()))
    assert tdt.last_restore_stats()["streaming"] == 1.0
    assert (tdt.last_publish_stats()["wire_bytes"]
            == jdt.last_publish_stats()["wire_bytes"])


def test_delta_republish_ships_the_same_patch(stores):
    jroot, troot = stores
    key = f"t/{uuid.uuid4().hex}"
    tree = np_tree(seed=6, blocks=8)
    jdt.put_arrays(key, tree, codec="raw", delta=True)
    tdt.put_arrays(key, to_torch(tree), codec="raw", delta=True)
    assert (jroot / key).read_bytes() == (troot / key).read_bytes()
    # a grown conversation: one block changes, the rest stay
    tree["kv"]["k"]["00003"] = (tree["kv"]["k"]["00003"].astype(np.float32)
                                + 1).astype(ml_dtypes.bfloat16)
    tree["scalars"] = tree["scalars"] + 1
    jdt.put_arrays(key, tree, codec="raw", delta=True)
    jstats = jdt.last_publish_stats()
    tdt.put_arrays(key, to_torch(tree), codec="raw", delta=True)
    tstats = tdt.last_publish_stats()
    assert tstats["delta"] == jstats["delta"] == 1.0
    for k in ("leaves", "leaves_sent", "leaves_skipped", "wire_bytes"):
        assert tstats[k] == jstats[k], k
    assert jstats["leaves_sent"] == 2
    side = key + BLOB_DELTA_SUFFIX
    assert (jroot / side).read_bytes() == (troot / side).read_bytes()
    assert (jroot / key).read_bytes() == (troot / key).read_bytes()
    # a fetcher holding the previous blob splices the patch
    got = tdt.get_arrays(key, template=tree, delta=True)
    assert_same_leaves(tdt.tree_flatten(got)[0],
                       jdt.unpack_arrays((jroot / key).read_bytes()))
    assert tdt.last_restore_stats()["delta_hit"] == 0.0
    tree["scalars"] = tree["scalars"] + 1
    tdt.put_arrays(key, to_torch(tree), codec="raw", delta=True)
    got = tdt.get_arrays(key, template=tree, delta=True)
    assert tdt.last_restore_stats()["delta_hit"] == 1.0
    np.testing.assert_array_equal(got["scalars"].numpy(), tree["scalars"])


def test_store_url_refused(monkeypatch):
    monkeypatch.setenv("KT_STORE_URL", "http://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tdt.put_arrays("t/x", {"a": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        tdt.get_arrays("t/x")
