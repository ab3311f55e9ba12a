"""The port's serving soak (``helix_tpu_torch.benchmarks.soak``) against
the reference's ``benchmarks/soak.py``.

- The client programs (``_CLIENT``, ``_INGEST_CLIENT``) must equal the
  reference's strings byte for byte.
- The port's index (:func:`soak.build`) and the reference's own set-up
  lines (``benchmarks/soak.py``: the seed-5 rows, ``PackedMatrix``, the
  poked ``Partition``), on JAX's CPU, must answer ``search_many`` on 8
  queries with equal ids, exactly (no tolerance: the same rows and an
  exact re-rank, on a seed without near-ties at rank 10).
- ``main`` on the CPU against a real native gateway prints a line with
  the reference's keys (and the port's three additions), every
  acknowledged write in the store (``nodes_final == ingested_docs >
  0``), and exits 0; a client that fails makes it exit 1.
"""

import json

import numpy as np
import torch

from helix_tpu_torch.benchmarks import soak

torch.set_num_threads(2)

REF_KEYS = {"search_requests", "search_qps", "p50_ms", "p99_ms", "max_ms",
            "ingested_docs", "seconds", "rss_start_mb", "rss_peak_mb",
            "rss_end_mb", "nodes_final"}
PORT_KEYS = {"device", "post_soak_recall_at_10", "kernel_launches"}


def test_client_programs_equal_the_reference_byte_for_byte():
    import benchmarks.soak as ref

    assert soak._CLIENT == ref._CLIENT
    assert soak._INGEST_CLIENT == ref._INGEST_CLIENT


def test_build_answers_as_the_reference_set_up():
    from helix_tpu.engine.vector import Partition
    from helix_tpu.ops.distance import PackedMatrix

    n, d = 4096, 128
    rng = np.random.default_rng(5)
    data = rng.normal(size=(n, d)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    matrix = PackedMatrix(d, "cosine")
    matrix.extend(data)
    # the reference's set-up lines, as benchmarks/soak.py runs them
    ref_part = Partition("cosine")
    ref_part.matrix = matrix
    ref_part._ensure_capacity(matrix.n)
    ref_part._ids[: matrix.n] = np.arange(1, matrix.n + 1, dtype=np.uint64)
    ref_part._live[: matrix.n] = True
    ref_part.n_rows = matrix.n
    ref_part._n_live = matrix.n

    engine, part, port_rng = soak.build(n, d, "cpu")
    np.testing.assert_array_equal(part.matrix.data[:n], matrix.data[:n])
    assert part.n_rows == part._n_live == n
    queries = port_rng.normal(size=(8, d)).astype(np.float32)
    np.testing.assert_array_equal(
        queries, rng.normal(size=(8, d)).astype(np.float32))
    got_ids, got_d = part.search_many(queries, 10)
    want_ids, want_d = ref_part.search_many(queries, 10)
    assert got_ids.shape == (8, 10)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_d, want_d, atol=1e-5)
    assert engine.vectors.indexes[("NodeVector", "Doc", "emb")].partitions[
        ("",)] is part


def test_main_soaks_a_real_gateway_on_the_cpu(capsys):
    rc = soak.main(["--device", "cpu", "--n", "4096", "--seconds", "2"])
    out = capsys.readouterr()
    assert rc == 0, out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == REF_KEYS | PORT_KEYS
    assert line["ingested_docs"] > 0
    assert line["nodes_final"] == line["ingested_docs"]
    assert line["search_requests"] > 0
    assert np.isfinite([line["p50_ms"], line["p99_ms"]]).all()
    assert line["post_soak_recall_at_10"] >= soak.RECALL_FLOOR
    assert line["device"] == "cpu"
    assert line["kernel_launches"] == {"bucket_scores": 0, "select_topk": 0}


def test_a_failed_client_fails_the_soak(capsys, monkeypatch):
    monkeypatch.setattr(soak, "_CLIENT", "import sys; sys.exit(3)")
    rc = soak.main(["--device", "cpu", "--n", "1024", "--seconds", "0.5"])
    out = capsys.readouterr()
    assert rc == 1 and "the search client exited 3" in out.err
    assert not out.out.strip()


def test_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert soak.main(["--n", "1024"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_readback_counts_hits_against_the_host_oracle():
    from helix_tpu_torch.native import load
    from helix_tpu_torch.server.native_gateway import NativeGateway

    load()
    engine, part, rng = soak.build(2048, 128, "cpu")
    gw = NativeGateway(engine, host="127.0.0.1", port=0)
    gw.start()
    try:
        assert soak.readback(gw.port, part, rng, 128, 10, 4) == 1.0
    finally:
        gw.stop(close_engine=False)
