"""The port's exact-rung coarse sweep (``helix_tpu_torch.benchmarks
.exact_sweep``) against the reference's ``benchmarks/exact_sweep.py``.

Both ``main``s run at n = 16,384, batch 256, ``--chunks 4096,8192
--int8`` with their timers replaced by a recorder of each variant's
``(fn, operands)``.  Each recorded function is then called on the same
``prepare_queries`` batch (the reference's corpus), the reference's on
its own operands, the port's on its CPU tensors.

- Exact rows (``resident_topk_auto``, the single shot, each chunk): the
  top-10 ids must be equal as sets per query, and position by position
  except where the two ids' float64 scores lie within ``RANK_TOL`` =
  1e-6 of each other: the f32 re-rank sums in another order on each
  side, and this seed has one such near-tie (query 109, ranks 7 and 8,
  1.5e-8 apart in float64).  On the CPU both sides'
  ``resident_topk_auto`` take ``topk_resident``: the reference's
  ``supports_fused`` needs the TPU backend, the port's a CUDA device.
- int8 coarse rows (the single shot, each chunk): the ``k_cand`` = 80
  candidates must be equal as sets per query (exact integer dots).
- The fused int8 row runs only on the card on both sides (the
  reference's ``backend == "tpu"``); here the port's is forced on
  (``use_fused_route``, kernel 2's plain version) and held to the
  reference's ``int8_fused_coarse`` in Pallas interpret mode, as sets.
"""

import json
import sys

import numpy as np
import pytest
import torch

import benchmarks.ladder as ref_ladder
from helix_tpu_torch.benchmarks import exact_sweep

torch.set_num_threads(2)

N = 16_384
BATCH = 256
ARGS = ["--n", str(N), "--batch", str(BATCH), "--chunks", "4096,8192",
        "--int8", "--rounds", "2"]
EXACT = ["resident_topk_auto (shipped serving)",
         "single_shot_bf16 (XLA path)", "chunked_bf16 c=4096",
         "chunked_bf16 c=8192"]
RANK_TOL = 1e-6
COARSE = ["int8_single_shot_xla", "int8_chunked_xla c=4096",
          "int8_chunked_xla c=8192"]


def port_name(ref_name: str) -> str:
    for ref, port in exact_sweep.RENAMES.items():
        for c in ("4096", "8192"):
            if ref.format(c=c) == ref_name:
                return port.format(c=c)
    return ref_name


def coarse_name(name: str) -> str:
    return f"{name} (coarse-only, k_cand=80)"


def recorder(recorded: list):
    def record(fn, *, operands=(), **kwargs):
        recorded.append((fn, operands))
        return 1.0, {"per_batch_ms_samples": [1.0]}
    return record


@pytest.fixture(scope="module")
def corpus():
    data, queries = ref_ladder._corpus(N, 128, BATCH, 1)
    return data, queries[:BATCH]


@pytest.fixture(scope="module")
def batch(corpus):
    from helix_tpu_torch.ops.distance import PackedMatrix

    matrix = PackedMatrix(128, "cosine", device="cpu")
    return matrix.prepare_queries(corpus[1])


@pytest.fixture(scope="module")
def reference():
    """{variant: (fn, operands)} and the JSON line of the reference's
    main()."""
    import benchmarks.exact_sweep as ref
    import benchmarks.roofline as ref_roofline

    recorded = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_roofline, "timed_scan_qps", recorder(recorded))
        mp.setattr(sys, "argv", ["exact_sweep", *ARGS])
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.main()
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    return dict(zip(EXACT + COARSE, recorded)), line


@pytest.fixture(scope="module")
def port():
    """{reference's variant name: (fn, operands)} and the JSON line of the
    port's main(), its fused int8 row forced on."""
    import contextlib
    import io

    recorded = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(exact_sweep, "timed_scan_qps", recorder(recorded))
        mp.setattr(exact_sweep, "use_fused_route", lambda device: True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = exact_sweep.main(["--device", "cpu", *ARGS])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    names = EXACT + ["int8_fused_pallas (shipped)"] + COARSE
    return dict(zip(names, recorded)), line


def call_reference(entry, qs):
    import jax.numpy as jnp

    fn, ops = entry
    return np.asarray(fn(jnp.asarray(qs), *ops)).astype(np.int64)


def call_port(entry, qs):
    fn, ops = entry
    return fn(torch.from_numpy(qs), *ops).numpy()


@pytest.mark.parametrize("name", EXACT)
def test_exact_variant_ids_equal_the_reference(reference, port, corpus,
                                               batch, name):
    want = call_reference(reference[0][name], batch)
    got = call_port(port[0][name], batch)
    assert got.shape == want.shape == (BATCH, 10)
    data = corpus[0].astype(np.float64)
    qs = batch[:, :128].astype(np.float64)
    for i in np.nonzero((got != want).any(axis=1))[0]:
        assert set(got[i].tolist()) == set(want[i].tolist()), f"query {i}"
        for j in np.nonzero(got[i] != want[i])[0]:
            gap = abs(data[got[i, j]] @ qs[i] - data[want[i, j]] @ qs[i])
            assert gap <= RANK_TOL, f"query {i} rank {j}: {gap}"


@pytest.mark.parametrize("name", COARSE)
def test_int8_coarse_candidates_equal_the_reference_as_sets(
        reference, port, batch, name):
    want = call_reference(reference[0][name], batch)
    got = call_port(port[0][name], batch)
    assert got.shape == want.shape == (BATCH, 80)
    for i in range(BATCH):
        assert set(got[i].tolist()) == set(want[i].tolist()), f"query {i}"


def test_fused_int8_candidates_equal_the_reference_interpret_mode(
        reference, port, batch):
    import jax.numpy as jnp

    from helix_tpu.ops.quant import int8_fused_coarse

    _, ops = reference[0]["int8_single_shot_xla"]
    want = np.asarray(int8_fused_coarse(
        ops[0], jnp.asarray(batch), jnp.int32(N), k=80, interpret=True)[1])
    got = call_port(port[0]["int8_fused_pallas (shipped)"], batch)
    assert got.shape == want.shape == (BATCH, 80)
    for i in range(BATCH):
        assert set(got[i].tolist()) == set(want[i].tolist()), f"query {i}"


def test_line_carries_the_reference_names_apart_from_the_renames(
        reference, port):
    ref_line, port_line = reference[1], port[1]
    assert port_line["metric"] == ref_line["metric"]
    want = [port_name(r["variant"].replace(" (coarse-only, k_cand=80)", ""))
            for r in ref_line["variants"]]
    want = [coarse_name(w) if w.startswith("int8") else w for w in want]
    got = [r["variant"] for r in port_line["variants"]]
    fused = coarse_name("int8_fused_cuda (shipped)")
    assert got == want[:4] + [fused] + want[4:]
    for ref_row, row in zip(ref_line["variants"],
                            [r for r in port_line["variants"]
                             if r["variant"] != fused]):
        assert set(row) == set(ref_row) | {"seconds"}
        key = "recall_at_10" if "recall_at_10" in ref_row else \
            "coarse_recall_at_10"
        assert row[key] == ref_row[key]
    assert set(port_line) == {"metric", "roofline_qps", "variants", "device",
                              "kernel_launches", "kernel_captured"}


def test_a_failed_variant_still_prints_the_line_and_exits_1(capsys,
                                                            monkeypatch):
    calls = []

    def fail_second(fn, **kwargs):
        calls.append(fn)
        if len(calls) == 2:
            raise RuntimeError("no graph")
        return 1.0, {"per_batch_ms_samples": [1.0]}

    monkeypatch.setattr(exact_sweep, "timed_scan_qps", fail_second)
    rc = exact_sweep.main(["--device", "cpu", "--n", "8192", "--chunks",
                           "4096"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 1 and "FAILED" in out.err
    assert [r["variant"] for r in line["variants"]] == [
        "resident_topk_auto (shipped serving)", "chunked_bf16 c=4096"]


def test_sweep_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert exact_sweep.main(["--n", str(N)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
