"""The port's residency-ladder benchmark
(``helix_tpu_torch/benchmarks/ladder.py``, behind ``bench_torch.py
--ladder``) against the reference's ``benchmarks/ladder.py`` on the CPU,
and ``build_ladder_baseline``.

Both ``run_ladder``s run on the same seed at N=20,000, B=128, 2 rounds,
on both routes:

- unfused: the reference as it runs on the CPU; the port with its route
  switch (``use_fused_route``) off, as on the CPU;
- fused: the reference with ``jax.default_backend`` patched to "tpu" and
  ``pl.pallas_call`` in interpret mode (``tests/test_fused_topk.py``'s
  way); the port with the switch on, running its kernels' plain
  versions.

Both timers are replaced by one call of the timed step (QPS is not
compared, and the reference's XLA scan of the bf16 rung takes minutes
here); the port's own timer runs in ``tests/test_torch_bench.py``'s
``bench_torch.py --ladder`` test.
The port's IVF rung is given the reference's fit
(``convert.host_ivf_from_reference``).

What must be equal: the tier list, each rung's ``serving``,
``resident_gb``, chosen ``k_cand`` and nprobe, the fused/unfused route,
the keys (but for the listed differences), every recall the pool and
nprobe ladders print for the int8, int4 and IVF rungs, and the int8 /
int4 rows' recall (integer coarse arithmetic, the same native re-rank).
Within 0.01 (about one hit in 128 queries x 10): the exact rung (bf16
coarse sums in another order) and ``int8_dev`` (f16 rows, f32 sums in
another order).
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_torch as BT  # noqa: E402
import benchmarks.ladder as RL  # noqa: E402
import benchmarks.roofline as RR  # noqa: E402
import helix_tpu.ops.ivf as JIVF  # noqa: E402
import helix_tpu_torch.benchmarks.ladder as PL  # noqa: E402
import helix_tpu_torch.ops.ivf as TIVF  # noqa: E402
from helix_tpu_torch.benchmarks import build_ladder_baseline  # noqa: E402
from helix_tpu_torch.benchmarks.roofline import RooflineFault  # noqa: E402
from helix_tpu_torch.convert import host_ivf_from_reference  # noqa: E402

torch.set_num_threads(2)

N, BATCH, ROUNDS = 20_000, 128, 2
TIERS = ["exact", "int8_dev", "int8", "int4", "host_ivf"]
BF16_RECALL_TOL = 0.01
# Keys only one side has: the reference's clamp flags (the port raises),
# the port's bounds, card and kernel counts.
REF_ONLY = {"clamped_to_roofline", "coarse_clamped_to_roofline",
            "measured_qps_raw"}
PORT_ONLY = {"roofline_qps", "coarse_roofline_qps"}
PORT_TOP_ONLY = {"card", "kernel_launches", "kernel_captured"}
TIMER_QPS = 1000.0
LADDER_LINE = re.compile(r"(int\d pool=\d+|ivf nprobe=\d+): recall@10=\S+")


def one_step_ref(fn_q, *, batch, d, dim_pad, operands=(), **_):
    """The reference's timer replaced by one call of the step."""
    import jax.numpy as jnp

    idx = fn_q(jnp.zeros((batch, dim_pad), jnp.float32), *operands)
    assert idx.shape[0] == batch
    return TIMER_QPS, {}


def one_step_port(fn_q, *, batch, d, dim_pad, operands=(), device=None,
                  **_):
    idx = fn_q(torch.zeros((batch, dim_pad), device=device), *operands)
    assert idx.shape[0] == batch
    return TIMER_QPS, {}


@pytest.fixture
def interpret_mode(monkeypatch):
    import jax
    from jax.experimental import pallas as pl

    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jax.clear_caches()
    yield
    jax.clear_caches()


def run_both(route, monkeypatch, tmp_path):
    """Both ladders on ``route``; returns (ref, port, ref log, port log)."""
    monkeypatch.setattr(RR, "timed_scan_qps", one_step_ref)
    monkeypatch.setattr(PL, "timed_scan_qps", one_step_port)
    monkeypatch.setattr(PL, "use_fused_route", lambda device: route == "fused")
    fits = []
    ref_build = JIVF.HostIVFIndex.build

    def keep_fit(*args, **kwargs):
        fits.append(ref_build(*args, **kwargs))
        return fits[-1]

    monkeypatch.setattr(JIVF.HostIVFIndex, "build", staticmethod(keep_fit))

    def install_fit(data, *args, normalize=True, device, **kwargs):
        ref = fits[-1]
        assert ref.n == len(data) and not normalize
        return host_ivf_from_reference(
            np.asarray(ref.centroids), ref.packed, ref.indptr,
            ref.row_to_original, device=device)

    monkeypatch.setattr(TIVF.HostIVFIndex, "build",
                        staticmethod(install_fit))
    ref_log, port_log = [], []
    ref = RL.run_ladder(n=N, batch=BATCH, rounds=ROUNDS, log=ref_log.append)
    port = PL.run_ladder(n=N, batch=BATCH, rounds=ROUNDS, log=port_log.append,
                         device="cpu", cache_dir=tmp_path)
    return ref, port, ref_log, port_log


def k_cand(row):
    found = re.search(r"k_cand=(\d+)", row["detail"])
    return int(found.group(1)) if found else None


@pytest.fixture(params=["unfused", "fused"])
def route(request):
    if request.param == "fused":
        request.getfixturevalue("interpret_mode")
    return request.param


def test_run_ladder_matches_the_reference(route, monkeypatch, tmp_path):
    ref, port, ref_log, port_log = run_both(route, monkeypatch, tmp_path)

    assert set(port) - PORT_TOP_ONLY == set(ref)
    assert port["backend"] == "cpu" and port["card"] is None
    assert all(v == 0 for v in port["kernel_launches"].values())
    assert {key: port[key] for key in ("metric", "rounds", "recall_floor")} \
        == {key: ref[key] for key in ("metric", "rounds", "recall_floor")}
    assert [r["tier"] for r in port["rungs"]] == \
        [r["tier"] for r in ref["rungs"]] == TIERS

    for want, got in zip(ref["rungs"], port["rungs"]):
        tier = want["tier"]
        assert set(got) - PORT_ONLY == set(want) - REF_ONLY, tier
        for key in ("serving", "resident_gb"):
            assert got[key] == want[key], (tier, key)
        assert k_cand(got) == k_cand(want), tier
        if tier in ("int8", "int4"):
            assert got["recall_at_10"] == want["recall_at_10"], tier
            fused_ref = "fused Pallas" in want["detail"]
            assert fused_ref == (route == "fused")
            assert ("fused kernel" in got["detail"]) == fused_ref, tier
        elif tier == "host_ivf":
            assert got["recall_at_10"] == want["recall_at_10"]
            assert re.search(r"nprobe=\d+", got["detail"]).group() == \
                re.search(r"nprobe=\d+", want["detail"]).group()
        else:
            assert abs(got["recall_at_10"] - want["recall_at_10"]) \
                <= BF16_RECALL_TOL, tier
    # every recall the pool and nprobe ladders reached, in order
    ref_lines = [m for m in ref_log if LADDER_LINE.search(m)]
    port_lines = [m for m in port_log if LADDER_LINE.search(m)]
    assert ref_lines and [s.strip("# ") for s in port_lines] == \
        [s.strip("# ") for s in ref_lines], (ref_lines, port_lines)


def test_reading_past_the_bound_raises(monkeypatch, tmp_path):
    """The reference clamps a reading above the bound; the port raises."""
    monkeypatch.setattr(PL, "timed_scan_qps", one_step_port)
    monkeypatch.setattr(PL, "roofline_batch_seconds", lambda **_: 1.0)
    with pytest.raises(RooflineFault, match="above the card's bound"):
        PL.run_ladder(n=4096, batch=64, rounds=2, log=lambda m: None,
                      device="cpu", cache_dir=tmp_path)


def test_without_cuda_the_ladder_raises_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.run_ladder(n=4096, batch=64, rounds=2, log=lambda m: None)


# ----------------------------------------------- the baseline's record


def test_build_ladder_baseline_writes_only_the_ports_record(tmp_path):
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU HNSW baseline")
    committed = REPO / "BASELINE_MEASURED.json"
    before = committed.read_bytes()
    n = 3000
    assert build_ladder_baseline.main(
        ["--n", str(n), "--batch", "64", "--rounds", "1",
         "--cache-dir", str(tmp_path)]) == 0
    assert committed.read_bytes() == before
    record = json.loads((tmp_path / BT.OWN_BASELINE_NAME).read_text())
    assert list(record) == [f"ladder:{n}x128"]
    assert record[f"ladder:{n}x128"]["recall_at_k"] >= 0.95
    assert record[f"ladder:{n}x128"]["source"] == "measured"
    assert "measured_at" in record[f"ladder:{n}x128"]

    # the ladder reads it back as its baseline, and writes nothing
    data, queries = PL._corpus(n, 128, 64, 4)
    oracle = PL._oracle(data, queries[:64], 10)
    got = PL.read_baseline(data, queries[:64], oracle, cache_dir=tmp_path)
    assert got["source"] == "cached_measurement"
    assert got["qps"] == record[f"ladder:{n}x128"]["qps"]
    assert committed.read_bytes() == before


def test_ladder_baseline_lookup_order(tmp_path):
    """The port's own record (the ladder key, then at n <= 1M the
    headline's untagged key), then the committed record; no measurement
    without a cached index."""
    data = np.zeros((3000, 128), np.float32)
    committed = tmp_path / "committed.json"
    committed.write_text(json.dumps({"ladder:3000x128": {"qps": 3.0}}))
    own = tmp_path / BT.OWN_BASELINE_NAME

    def lookup():
        return PL.read_baseline(data, data[:8], np.zeros((8, 10)),
                                  cache_dir=tmp_path, committed=committed)

    got = lookup()
    assert got["qps"] == 3.0 and "another host" in got["note"]
    own.write_text(json.dumps({"3000x128": {"qps": 2.0}}))
    assert lookup()["qps"] == 2.0
    own.write_text(json.dumps({"3000x128": {"qps": 2.0},
                               "ladder:3000x128": {"qps": 1.0}}))
    assert lookup()["qps"] == 1.0
    assert lookup()["source"] == "cached_measurement"
    committed.write_text("{}")
    own.unlink()
    assert lookup() is None
    assert not list(tmp_path.glob("*.so"))  # nothing was built
