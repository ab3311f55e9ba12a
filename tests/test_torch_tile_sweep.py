"""The port's tile sweep (``helix_tpu_torch.benchmarks.tile_sweep``)
against the reference's ``benchmarks/tile_sweep.py``.

Each side's ``main`` runs with its timer replaced by a recorder that
runs one step of the timed function on this file's own query batch: the
reference at tiles 8192 and 4096 with ``pl.pallas_call`` in interpret
mode (its ``fused_topk`` with ``_tile_rows`` swapped), the port at ring
depths 2 and 4 on CPU tensors (the ``shipped`` variant's plain version
as the fused step's winners).  Both compute kernel 1's fused step on the
same corpus, so the ids must be equal at every setting: exact equality,
no tolerance (the seed has no near-tie that the two products' rounding
could flip).
"""

import json
import sys

import numpy as np
import pytest
import torch

from helix_tpu_torch.benchmarks import onepass_sweep, tile_sweep

torch.set_num_threads(2)

N = 16_384
BATCH = 256


def queries(d: int = 128) -> np.ndarray:
    rng = np.random.default_rng(99)
    q = rng.normal(size=(BATCH, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def reference_ids():
    """{tile: ids [B, 10]} of the reference's main() at --n 16384."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import benchmarks.roofline as ref_roofline
    import benchmarks.tile_sweep as ref
    import helix_tpu.ops.fused_topk as JF

    qb = jnp.asarray(queries())
    ids = []

    def record(fn, *, operands=(), **kwargs):
        ids.append(np.asarray(fn(qb, *operands)))
        return 1.0, {"per_batch_ms_samples": [1.0]}

    original = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", lambda *a, **kw: original(
            *a, **{**kw, "interpret": True}))
        mp.setattr(ref_roofline, "timed_scan_qps", record)
        mp.setattr(sys, "argv", ["tile_sweep", "--n", str(N),
                                 "--tiles", "8192,4096"])
        ref.main()
    JF._bucket_scores.clear_cache()
    JF.fused_topk.clear_cache()
    assert len(ids) == 2
    return dict(zip((8192, 4096), ids))


def run_port(monkeypatch, capsys, tiles="2,4"):
    """(rc, stdout lines, ids per recorded step) of the port's main()."""
    qb = torch.from_numpy(queries())
    ids = []

    def record(fn, *, operands=(), **kwargs):
        ids.append(fn(qb, *operands).numpy())
        return 1.0, {"per_batch_ms_samples": [1.0]}

    monkeypatch.setattr(onepass_sweep, "timed_scan_qps", record)
    rc = tile_sweep.main(["--device", "cpu", "--n", str(N), "--tiles",
                          tiles])
    return rc, capsys.readouterr().out.splitlines(), ids


def test_every_depth_gives_the_reference_ids_at_every_tile(
        reference_ids, monkeypatch, capsys):
    rc, _, ids = run_port(monkeypatch, capsys)
    assert rc == 0 and len(ids) == 2
    for tile, want in reference_ids.items():
        assert want.shape == (BATCH, 10)
        for depth, got in zip((2, 4), ids):
            np.testing.assert_array_equal(
                got, want.astype(np.int64),
                err_msg=f"ring depth {depth} against tile {tile}")


def test_corpus_is_the_reference_corpus():
    rng = np.random.default_rng(42)
    data = rng.normal(size=(3000, 64)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
    got, q = tile_sweep.corpus(3000, 64, 16)
    np.testing.assert_array_equal(got, data)
    assert q.shape == (16, 64)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)


def test_main_prints_one_line_per_depth_and_the_json_line(capsys):
    rc = tile_sweep.main(["--device", "cpu", "--n", str(N), "--tiles",
                          "2,4", "--rounds", "2"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    lines = [ln for ln in out if ln.startswith("ring_depth=")]
    assert [ln.split(":")[0] for ln in lines] == ["ring_depth=2 (plan 2)",
                                                  "ring_depth=4 (plan 4)"]
    assert all("ms/batch" in ln and "QPS" in ln and "samples=[" in ln
               for ln in lines)
    line = json.loads(out[-1])
    assert line["metric"].startswith("ring depth sweep of kernel 1's plan")
    rows = line["variants"]
    assert [(r["kernel"], r["ring_depth"]) for r in rows] == [
        ("shipped", 2), ("shipped", 4)]
    assert all(r["qps"] > 0 and r["recall_at_10"] >= 0.95 for r in rows)


def test_a_failed_depth_fails_the_sweep(monkeypatch, capsys):
    def fail(*args, **kwargs):
        raise RuntimeError("no graph")

    monkeypatch.setattr(onepass_sweep, "timed_scan_qps", fail)
    rc = tile_sweep.main(["--device", "cpu", "--n", str(N), "--tiles", "2"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1 and "ring_depth=2: FAILED" in out
    assert json.loads(out[-1])["variants"] == []


def test_sweep_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tile_sweep.main(["--n", str(N)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
