"""The port's ``quant_demo`` and ``beyond_hbm_demo``
(``helix_tpu_torch/benchmarks/``) against the reference's
``benchmarks/quant_demo.py`` and ``benchmarks/beyond_hbm_demo.py`` on the
CPU, at N=20,000 and 128 queries, comparing their JSON lines.

``quant_demo`` runs on both routes: unfused as each runs on the CPU, and
fused with the reference's ``jax.default_backend`` patched to "tpu" and
``pl.pallas_call`` in interpret mode, the port's route switch on (its
kernels' plain versions).  Everything but the times must be equal:
recall@10 exactly (integer coarse dots, the same native re-rank), the
candidate pool, the route and the residency figures.

``beyond_hbm_demo`` fits its own k-means on each side (the two fits
differ in the order of their bf16 sums), so each nprobe row's recall is
held within 0.05 of the reference's; the rows' other counts are equal.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import benchmarks.beyond_hbm_demo as RB  # noqa: E402
import benchmarks.quant_demo as RQ  # noqa: E402
import helix_tpu_torch.benchmarks.beyond_hbm_demo as PB  # noqa: E402
import helix_tpu_torch.benchmarks.ladder as PL  # noqa: E402
import helix_tpu_torch.benchmarks.quant_demo as PQ  # noqa: E402

from tests.test_torch_ladder_bench import interpret_mode  # noqa: E402,F401

torch.set_num_threads(2)

SMALL = ["--n", "20000", "--queries", "128"]
TIMES = {"value", "coarse_ms_per_batch", "rerank_ms_per_batch",
         "quantize_upload_s"}
PORT_ONLY = {"device", "card", "kernel_launches"}
IVF_RECALL_TOL = 0.05
# Budget below the exact tier's 20,000 x 128 x 6 bytes (15.4 MB).
BUDGET = ["--hbm-budget-gb", "0.01"]


def ref_lines(main, argv, monkeypatch, capsys) -> list:
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["demo", *argv])
    main()
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def port_lines(main, argv, capsys) -> list:
    capsys.readouterr()
    assert main([*argv, "--device", "cpu"]) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


@pytest.fixture(params=["unfused", "fused"])
def route(request, monkeypatch):
    if request.param == "fused":
        request.getfixturevalue("interpret_mode")
    monkeypatch.setattr(PL, "use_fused_route",
                        lambda device: request.param == "fused")
    return request.param


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_demo_matches_the_reference(bits, route, monkeypatch, capsys):
    argv = [*SMALL, "--rounds", "2", "--bits", str(bits)]
    [want] = ref_lines(RQ.main, argv, monkeypatch, capsys)
    [got] = port_lines(PQ.main, argv, capsys)
    assert set(got) - PORT_ONLY == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES | PORT_ONLY} \
        == {k: v for k, v in want.items() if k not in TIMES}
    assert got["fused"] == (bits == 4 and route == "fused")
    assert got["recall_at_10"] >= 0.95
    assert got["device"] == "cpu" and got["card"] is None
    assert all(v == 0 for v in got["kernel_launches"].values())
    for key in TIMES:
        assert got[key] > 0, key


def test_beyond_hbm_demo_matches_the_reference(monkeypatch, capsys):
    argv = [*SMALL, *BUDGET]
    want = ref_lines(RB.main, argv, monkeypatch, capsys)
    got = port_lines(PB.main, argv, capsys)
    assert [r["nprobe"] for r in got] == [r["nprobe"] for r in want] \
        == [4, 8, 16, 32]
    for g, w in zip(got, want):
        assert set(g) - {"scoring_path", "device"} == set(w)
        for key in ("tier", "n", "d", "batch", "nprobe"):
            assert g[key] == w[key], key
        assert abs(g["recall_at_10"] - w["recall_at_10"]) <= IVF_RECALL_TOL, \
            (g, w)
    assert max(r["recall_at_10"] for r in got) >= 0.9


def test_beyond_hbm_demo_refuses_a_budget_the_exact_tier_fits(capsys):
    assert PB.main([*SMALL, "--hbm-budget-gb", "1", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "budget" in captured.err and captured.out == ""


@pytest.mark.parametrize("main", [PL.main, PQ.main, PB.main],
                         ids=["ladder", "quant_demo", "beyond_hbm_demo"])
def test_entry_point_without_cuda_exits_naming_cuda(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main(["--n", "4096"]) != 0
    captured = capsys.readouterr()
    assert "CUDA" in captured.err and captured.out == ""
