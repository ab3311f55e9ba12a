"""Persistence in the port: WAL, snapshots, recovery, object stores.

The scenarios of ``tests/test_persist.py`` and ``tests/test_objstore_s3.py``
replayed against ``helix_tpu_torch`` (``Engine(device="cpu")``, the
port's own ``native.Wal`` and ``engine.persist``), and the cross-package
contract: a snapshot holds plain containers, scalars and numpy arrays
only, so a data dir written by either package recovers in the other,
with equal JSON for the same reads (vector search included).
"""

import io
import pickle
from array import array

import numpy as np
import pytest
import torch

from helix_tpu.engine import Engine as RefEngine
from helix_tpu_torch.dsl import (
    DynamicQueryRequest, NodeRef, SourcePredicate, define_params,
    define_queries, g, read_batch, register_read, write_batch,
)
from helix_tpu_torch.engine import Engine
from helix_tpu_torch.native import Wal, replay

from .s3_stub import S3Stub


def port_engine(data_dir, **kw) -> Engine:
    return Engine(device="cpu", data_dir=str(data_dir), **kw)


def wreq(batch):
    return {"request_type": "write", "query_name": None,
            "query": batch.encode(), "parameters": {}}


def rreq(batch):
    return {"request_type": "read", "query_name": None,
            "query": batch.encode(), "parameters": {}}


def count(engine, label=None) -> int:
    src = g().n_with_label(label) if label else g().n()
    return engine.execute(rreq(read_batch().var_as("c", src.count())))["c"]


# ------------------------------------------------------------------ WAL


def test_wal_roundtrip(tmp_path):
    path = tmp_path / "test.wal"
    wal = Wal(path)
    records = [b"alpha", b"beta" * 1000, b"", b'{"json": true}']
    for rec in records:
        wal.append(rec, sync=False)
    wal.flush()
    wal.close()
    assert list(replay(path)) == records


def test_wal_torn_tail_ignored(tmp_path):
    path = tmp_path / "torn.wal"
    wal = Wal(path)
    wal.append(b"good-record")
    wal.close()
    with open(path, "ab") as fh:
        fh.write(b"\xff\xff\xff")
    assert list(replay(path)) == [b"good-record"]


def test_wal_reset(tmp_path):
    path = tmp_path / "reset.wal"
    wal = Wal(path)
    wal.append(b"one")
    wal.reset()
    wal.append(b"two")
    wal.close()
    assert list(replay(path)) == [b"two"]


def test_poisoned_wal_header_fails_loudly(tmp_path):
    bad = tmp_path / "bad.wal"
    bad.write_bytes(b"NOTAWAL!" + b"x" * 32)
    with pytest.raises(OSError):
        Wal(bad)
    torn = tmp_path / "torn.wal"
    torn.write_bytes(b"HXW")
    with pytest.raises(OSError):
        Wal(torn)
    good = tmp_path / "good.wal"
    w = Wal(good)
    w.append(b"rec")
    w.close()
    with open(good, "ab") as fh:
        fh.write(b"\xff\xff")
    w2 = Wal(good)
    w2.append(b"rec2")
    w2.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_wal_files_cross_packages(tmp_path, writer, reader):
    import helix_tpu.native as ref_native
    import helix_tpu_torch.native as port_native

    mods = {"ref": ref_native, "port": port_native}
    path = tmp_path / "x.wal"
    wal = mods[writer].Wal(path)
    for rec in (b"a", b"bb" * 500, b""):
        wal.append(rec)
    wal.close()
    assert list(mods[reader].replay(path)) == [b"a", b"bb" * 500, b""]


# ------------------------------------------------------------- recovery


def test_engine_recovers_from_wal(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    eng.execute(wreq(
        write_batch()
        .var_as("a", g().add_n("User", {"name": "ann"}))
        .var_as("b", g().add_n("User", {"name": "bob"}))
        .var_as("e", g().n(NodeRef.var("a")).add_e("KNOWS", NodeRef.var("b")))
    ))
    eng.persistence.close()  # a crash: no checkpoint
    eng2 = port_engine(data)
    out = eng2.execute(rreq(
        read_batch()
        .var_as("users", g().n_with_label("User").count())
        .var_as("friends", g().n_where(SourcePredicate.eq("name", "ann"))
                .out("KNOWS").values(["name"]))
    ))
    assert out == {"users": 2, "friends": ["bob"]}


def test_engine_checkpoint_then_recover(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    eng.execute(wreq(
        write_batch()
        .var_as("idx", g().create_vector_index_nodes("Doc", "embedding"))
        .var_as("d1", g().add_n("Doc", {"title": "X", "embedding": [1.0, 0.0]}))
    ))
    eng.checkpoint()
    eng.execute(wreq(write_batch().var_as(
        "d2", g().add_n("Doc", {"title": "Y", "embedding": [0.0, 1.0]}))))
    eng.persistence.close()
    eng2 = port_engine(data)
    out = eng2.execute(rreq(read_batch().var_as(
        "hits", g().vector_search_nodes("Doc", "embedding", [0.0, 1.0], 1)
        .value_map(["title"]))))
    assert out["hits"] == [{"title": "Y"}]


def test_ids_stable_across_recovery(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    first = eng.execute(wreq(write_batch().var_as(
        "u", g().add_n("User", {"name": "a"}))))["u"][0]["$id"]
    eng.persistence.close()
    eng2 = port_engine(data)
    out = eng2.execute(wreq(write_batch().var_as(
        "u", g().add_n("User", {"name": "b"}))))
    assert out["u"][0]["$id"] == first + 1


def test_failed_write_not_logged(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    with pytest.raises(Exception):
        eng.execute(wreq(
            write_batch()
            .var_as("a", g().add_n("User", {"name": "x"}))
            .var_as("bad", g().n(NodeRef.var("a")).add_e("E", NodeRef.ids([999])))
        ))
    eng.persistence.close()
    assert count(port_engine(data)) == 0


@pytest.mark.parametrize("spec,write", [
    ({"NodeEquality": {"label": "U", "property": "email", "unique": True}},
     lambda: write_batch().var_as("u", g().add_n("U", {"email": "a@x"}))),
    ({"EdgeEquality": {"label": "Ref", "property": "slot", "unique": True}},
     lambda: write_batch()
     .var_as("src", g().n_with_label("N").limit(1))
     .var_as("e", g().n(NodeRef.var("src")).add_e(
         "Ref", NodeRef.var("src"), {"slot": 1}))),
])
def test_unique_index_survives_recovery(tmp_path, spec, write):
    data = tmp_path / "data"
    eng = port_engine(data)
    eng.execute(wreq(write_batch().var_as("idx", g().create_index(spec))))
    eng.execute(wreq(write_batch().var_as("n", g().add_n("N"))))
    eng.execute(wreq(write()))
    with pytest.raises(Exception, match="unique"):
        eng.execute(wreq(write()))
    eng.checkpoint()
    eng.persistence.close()
    eng2 = port_engine(data)
    with pytest.raises(Exception, match="unique"):
        eng2.execute(wreq(write()))
    eng2.close()


def test_routes_and_source_survive_recovery(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    queries = define_queries({"read": {"count_all": register_read(
        lambda pp: read_batch().var_as("n", g().n().count()).returning(["n"]),
        define_params({}),
    )}})
    eng.load_bundle(queries.build_query_bundle())
    eng.source_snapshot = {"files": {"queries.py": {"sha256": "abc"}}}
    eng.checkpoint()
    eng.persistence.close()
    eng2 = port_engine(data)
    assert eng2.execute_stored("count_all", {}) == {"n": 0}
    assert eng2.source_snapshot["files"]["queries.py"]["sha256"] == "abc"


def test_crash_between_snapshot_and_wal_truncate_no_double_apply(tmp_path):
    """The snapshot's WAL watermark skips records it already holds."""
    data = tmp_path / "data"
    eng = port_engine(data)
    for i in range(3):
        eng.execute(wreq(write_batch().var_as(
            "n", g().add_n("User", {"name": f"u{i}"}))))
    real_reset = eng.persistence.wal.reset
    eng.persistence.wal.reset = lambda: None
    eng.checkpoint()
    eng.persistence.wal.reset = real_reset
    eng.persistence.close()
    eng2 = port_engine(data)
    assert count(eng2) == 3
    eng2.execute(wreq(write_batch().var_as(
        "n", g().add_n("User", {"name": "u3"}))))
    eng2.close()
    eng3 = port_engine(data)
    assert count(eng3) == 4
    eng3.close()


@pytest.mark.parametrize("where", ["middle", "end"])
def test_tampered_snapshot_fails_loudly(tmp_path, where):
    data = tmp_path / "data"
    eng = port_engine(data)
    eng.execute(wreq(write_batch().var_as(
        "n", g().add_n("User", {"name": "a"}))))
    eng.checkpoint()
    eng.close()
    snap = data / "snapshot.bin"
    blob = bytearray(snap.read_bytes())
    blob[len(blob) // 2 if where == "middle" else -1] ^= 0xFF
    snap.write_bytes(bytes(blob))
    with pytest.raises(Exception, match="checksum|forbidden|unsupported"):
        port_engine(data)


def test_malicious_snapshot_rejected(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    evil = pickle.dumps({"version": 2, "boom": __import__("os").system})
    (data / "snapshot.bin").write_bytes(evil)
    with pytest.raises(Exception, match="forbidden"):
        port_engine(data)


def test_vector_checkpoint_blocks_roundtrip(tmp_path):
    data = tmp_path / "data"
    eng = port_engine(data)
    vecs = np.random.default_rng(8).normal(size=(50, 16)).astype(np.float32)
    batch = write_batch().var_as("idx", g().create_vector_index_nodes("Doc", "emb"))
    for i in range(50):
        batch = batch.var_as(f"d{i}", g().add_n("Doc", {
            "i": i, "emb": [float(x) for x in vecs[i]], "short": [1.0, 2.0]}))
    eng.execute(wreq(batch))
    eng.checkpoint()
    eng.persistence.close()
    eng2 = port_engine(data)
    row = eng2.execute(rreq(read_batch().var_as(
        "hit", g().vector_search_nodes("Doc", "emb", [float(x) for x in vecs[7]], 1)
        .value_map(["i", "emb", "short"]))))["hit"][0]
    assert row["i"] == 7 and row["short"] == [1.0, 2.0]
    assert np.allclose(row["emb"], vecs[7], rtol=1e-6)


def test_array_vector_props_extract_into_blocks():
    from helix_tpu_torch.engine.persist import _REF_KEY, _VectorExtractor

    ex = _VectorExtractor()
    out = ex.strip({"emb": {"F64Array": array("d", [float(i) for i in range(16)])}})
    assert _REF_KEY in out["emb"]
    assert _REF_KEY in ex.strip({"emb": {"F32Array": [1.0] * 16}})["emb"]
    blocks = ex.blocks()
    assert blocks[("F64Array", 16)].shape == (1, 16)
    assert blocks[("F32Array", 16)].shape == (1, 16)


def test_streaming_snapshot_file_read(tmp_path):
    from helix_tpu_torch.engine.persist import (
        frame_snapshot_blob, read_snapshot_file,
    )

    payload = {"version": 2, "hello": [1, 2, 3]}
    blob = pickle.dumps(payload, protocol=5)
    framed = tmp_path / "framed.bin"
    framed.write_bytes(frame_snapshot_blob(blob))
    assert read_snapshot_file(framed) == payload
    legacy = tmp_path / "legacy.bin"
    legacy.write_bytes(blob)
    assert read_snapshot_file(legacy) == payload
    corrupt = bytearray(frame_snapshot_blob(blob))
    corrupt[-1] ^= 0xFF
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(corrupt))
    with pytest.raises(RuntimeError, match="checksum"):
        read_snapshot_file(bad)


def ingest_docs(engine, vecs, first=0):
    engine.execute({
        "request_type": "write", "query_name": "ingest",
        "query": {"queries": [{"ForEach": {"param": "docs", "body": [
            {"Query": {"name": "d", "steps": [{"AddN": {
                "label": "Doc", "properties": [
                    ["i", {"Expr": {"Param": "docs.i"}}],
                    ["emb", {"Expr": {"Param": "docs.emb"}}]]}}],
                "condition": None}}]}}], "returns": []},
        "parameters": {"docs": [{"i": first + j, "emb": v}
                                for j, v in enumerate(vecs.tolist())]},
        "parameter_types": {"docs": {"Array": "Object"}},
    })


def search(engine, q, k=5):
    return engine.execute(rreq(read_batch().var_as(
        "hits", g().vector_search_nodes("Doc", "emb", [float(x) for x in q], k)
        .value_map(["$id", "$distance", "i"]))))


def test_checkpoint_with_a_live_device_index_holds_no_tensor(tmp_path):
    """A search uploads the matrix (torch tensors on the engine's
    device); the checkpoint taken after it unpickles under the restricted
    unpickler, and nothing in it is a tensor.  After recovery the first
    search rebuilds the device arrays and answers as before."""
    from helix_tpu_torch.engine.persist import SNAPSHOT_NAME, restricted_load

    data = tmp_path / "data"
    eng = port_engine(data)
    eng.execute(wreq(write_batch().var_as(
        "idx", g().create_vector_index_nodes("Doc", "emb"))))
    vecs = np.random.default_rng(2).normal(size=(4200, 16)).astype(np.float32)
    ingest_docs(eng, vecs)
    before = search(eng, vecs[3])
    matrix = eng.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)].matrix
    assert isinstance(matrix._device[1], torch.Tensor)   # live device copy
    eng.checkpoint()
    with open(data / SNAPSHOT_NAME, "rb") as fh:
        fh.seek(8 + 32)   # magic + digest
        payload = restricted_load(fh)

    def walk(obj):
        assert not isinstance(obj, torch.Tensor)
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(k)
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(payload)
    assert payload["vector_blocks"][("F64Array", 16)].shape == (4200, 16)
    eng.close()
    eng2 = port_engine(data)
    matrix2 = eng2.vectors.indexes[("NodeVector", "Doc", "emb")] \
        .partitions[("",)].matrix
    assert matrix2.n == 4200 and matrix2._device is None
    assert search(eng2, vecs[3]) == before
    assert isinstance(matrix2._device[1], torch.Tensor)
    eng2.close()


# -------------------------------------------------------- object stores


def test_snapshot_store_mirror_and_bootstrap(tmp_path):
    bucket = f"file://{tmp_path / 'bucket'}"
    eng = port_engine(tmp_path / "node_a", snapshot_store=bucket)
    eng.execute(DynamicQueryRequest.write(
        write_batch()
        .var_as("idx", g().create_vector_index_nodes("Doc", "v"))
        .var_as("d", g().add_n("Doc", {"i": 7, "v": [1.0] * 8}))
    ).encode())
    eng.checkpoint()
    assert (tmp_path / "bucket" / "snapshot.bin").exists()
    eng.close()
    fresh = port_engine(tmp_path / "node_b", snapshot_store=bucket)
    out = fresh.execute(DynamicQueryRequest.read(
        read_batch()
        .var_as("n", g().n_with_label("Doc").count())
        .var_as("hit", g().vector_search_nodes("Doc", "v", [1.0] * 8, 1)
                .value_map(["i"]))
    ).encode())
    assert out["n"] == 1 and out["hit"][0]["i"] == 7
    fresh.close()


def test_snapshot_store_local_snapshot_wins(tmp_path):
    from helix_tpu_torch.engine.objstore import MemoryObjectStore

    store = MemoryObjectStore("t-port-local-wins")
    eng = port_engine(tmp_path / "n", snapshot_store=store)
    eng.execute(DynamicQueryRequest.write(
        write_batch().var_as("a", g().add_n("A"))).encode())
    eng.checkpoint()
    eng.execute(DynamicQueryRequest.write(
        write_batch().var_as("b", g().add_n("B"))).encode())
    eng.persistence.close()
    again = port_engine(tmp_path / "n", snapshot_store=store)
    out = again.execute(DynamicQueryRequest.read(
        read_batch().var_as("labels", g().n().label())).encode())
    assert sorted(out["labels"]) == ["A", "B"]
    again.close()


def test_mirror_failures_are_visible(tmp_path):
    from types import SimpleNamespace

    from helix_tpu_torch.server.routes import dispatch

    class Broken:
        def put(self, key, data):
            raise OSError("bucket down")

        def get(self, key):
            return None

    class Fine:
        def put(self, key, data):
            pass

        def get(self, key):
            return None

    eng = port_engine(tmp_path / "n")
    eng.persistence.snapshot_store = Broken()
    eng.execute(DynamicQueryRequest.write(
        write_batch().var_as("a", g().add_n("A"))).encode())
    eng.checkpoint()  # must not raise
    assert (tmp_path / "n" / "snapshot.bin").exists()
    assert eng.persistence.mirror_failures == 1
    assert "bucket down" in eng.persistence.mirror_error
    srv = SimpleNamespace(engine=eng, replica_of=None, mcp_enabled=False)
    health = dispatch(srv, "GET", "/v1/health", b"").payload
    assert health["mirror_failures"] == 1
    assert "bucket down" in health["mirror_error"]
    eng.persistence.snapshot_store = Fine()
    eng.checkpoint()
    assert eng.persistence.mirror_error is None
    assert eng.persistence.mirror_failures == 1
    eng.close()


@pytest.fixture()
def stub(monkeypatch):
    with S3Stub("AKSTUBKEY", "stub-secret-key") as s3:
        for key, value in s3.env().items():
            monkeypatch.setenv(key, value)
        yield s3


def test_s3_put_get_and_bad_secret(stub, monkeypatch):
    from helix_tpu_torch.engine.objstore import S3ObjectStore, open_store

    store = open_store("s3://snapshots/prefix/a")
    assert isinstance(store, S3ObjectStore)
    store.put("snapshot.bin", b"\x00\x01hello")
    assert store.get("snapshot.bin") == b"\x00\x01hello"
    assert store.get("missing.bin") is None
    assert stub.blobs == {"snapshots/prefix/a/snapshot.bin": b"\x00\x01hello"}
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wrong")
    with pytest.raises(RuntimeError, match="403"):
        open_store("s3://b").put("k", b"x")


def test_s3_store_requires_credentials(monkeypatch):
    from helix_tpu_torch.engine.objstore import open_store

    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    with pytest.raises(RuntimeError, match="AWS_ACCESS_KEY_ID"):
        open_store("s3://some-bucket/prefix")


def test_disk_lifecycle_restart_from_s3_bucket(stub, tmp_path):
    """Checkpoint to the bucket, lose the disk, bootstrap a replacement
    from the bucket alone; and a reference node bootstraps from the
    port's checkpoint there too."""
    url = "s3://snapshots/dev"
    eng = port_engine(tmp_path / "node_a", snapshot_store=url)
    for i in range(5):
        eng.execute(wreq(write_batch().var_as(
            "n", g().add_n("User", {"name": f"u{i}"}))))
    eng.checkpoint()
    assert "snapshots/dev/snapshot.bin" in stub.blobs
    fresh = port_engine(tmp_path / "node_b", snapshot_store=url)
    assert count(fresh, "User") == 5
    fresh.execute(wreq(write_batch().var_as(
        "n", g().add_n("User", {"name": "u5"}))))
    fresh.checkpoint()
    ref = RefEngine(data_dir=str(tmp_path / "node_c"), snapshot_store=url)
    assert count(ref, "User") == 6
    ref.close()


# ------------------------------------------------------- cross-package


def populate(engine, vecs):
    engine.execute(wreq(
        write_batch()
        .var_as("idx", g().create_vector_index_nodes("Doc", "emb"))
        .var_as("a", g().add_n("User", {"name": "ann", "age": 31}))
        .var_as("b", g().add_n("User", {"name": "bob", "age": 29}))
        .var_as("e", g().n(NodeRef.var("a")).add_e("KNOWS", NodeRef.var("b"),
                                                  {"since": 2020}))
    ))
    ingest_docs(engine, vecs[:150])
    queries = define_queries({"read": {"count_all": register_read(
        lambda pp: read_batch().var_as("n", g().n().count()).returning(["n"]),
        define_params({}),
    )}})
    engine.load_bundle(queries.build_query_bundle())   # checkpoints


def reads(engine, vecs) -> list:
    out = [engine.execute(rreq(
        read_batch()
        .var_as("users", g().n_with_label("User").value_map(["name", "age"]))
        .var_as("friends", g().n_where(SourcePredicate.eq("name", "ann"))
                .out_e("KNOWS").value_map(["since"]))
        .var_as("docs", g().n_with_label("Doc").count())
    )), engine.execute_stored("count_all", {})]
    out += [search(engine, q, k=7) for q in vecs[190:196]]
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_data_dir_recovers_in_the_other_package(tmp_path, writer):
    """Snapshot plus WAL tail written by one package, recovered by the
    other: equal JSON for the same reads, vector search included, and
    the next id continues the writer's counter."""
    vecs = np.random.default_rng(5).normal(size=(200, 16)).astype(np.float32)
    make = {"ref": lambda: RefEngine(data_dir=str(tmp_path / "d")),
            "port": lambda: port_engine(tmp_path / "d")}
    reader = "port" if writer == "ref" else "ref"
    eng = make[writer]()
    populate(eng, vecs)
    ingest_docs(eng, vecs[150:180], first=150)       # WAL tail only
    want = reads(eng, vecs)
    eng.persistence.close()                           # crash: no checkpoint
    other = make[reader]()
    assert reads(other, vecs) == want
    got = other.execute(wreq(write_batch().var_as(
        "u", g().add_n("User", {"name": "cy"}))))["u"][0]["$id"]
    other.close()
    again = make[writer]()
    assert again.execute(wreq(write_batch().var_as(
        "u", g().add_n("User", {"name": "di"}))))["u"][0]["$id"] == got + 1
    again.close()


def test_restricted_unpickler_reads_a_reference_snapshot(tmp_path):
    from helix_tpu.engine.persist import build_snapshot_payload
    from helix_tpu_torch.engine.persist import restricted_load

    vecs = np.random.default_rng(6).normal(size=(200, 16)).astype(np.float32)
    ref = RefEngine()
    populate(ref, vecs)
    blob = pickle.dumps(build_snapshot_payload(ref), protocol=5)
    payload = restricted_load(io.BytesIO(blob))
    assert len(payload["nodes"]) == 152 and len(payload["edges"]) == 1
