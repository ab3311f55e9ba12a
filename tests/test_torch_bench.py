"""``bench_torch.py``, the port's headline benchmark, against ``bench.py``
on the CPU.

The reference's ``bench.py`` runs once on JAX's CPU backend at 4,096 rows
(its rows saved through its own ``BENCH_CACHE``), ``bench_torch.py
--device cpu`` once at the same size: the rows are equal element for
element, the recall lines equal, the keys the reference's but for the
documented renames.  The search step is held to the JAX package's
``resident_topk_auto`` on the same numpy inputs (ids equal, dists within
1e-5, on a seed asserted to have no near-tie at rank 10).  The
real-dataset mode runs ``tests/test_bench_dataset.py``'s four tests on
the port; the rest pins what the port adds: no CPU fallback, no clamp to
the bound, ``BASELINE_MEASURED.json`` never written, no JAX needed, the
gateway's keys.  The graph timer itself needs the card (marker ``cuda``).
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_torch as BT  # noqa: E402
from tests.test_bench_dataset import write_fvecs, write_ivecs  # noqa: E402

N = 4096
SMALL = {"BENCH_N": str(N), "BENCH_BATCH": "64", "BENCH_ROUNDS": "4",
         "BENCH_SKIP_BASELINE": "1", "BENCH_SKIP_GATEWAY": "1"}
CPU = torch.device("cpu")


def run_script(args: list, env: dict, ok: bool = True):
    proc = subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", **env),
    )
    if not ok:
        return proc
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each script at the same size, rows cached to .npy."""
    tmp = tmp_path_factory.mktemp("bench")
    ref = run_script(["bench.py"],
                     dict(SMALL, BENCH_CACHE=str(tmp / "ref.npy")))
    port = run_script(["bench_torch.py", "--device", "cpu"],
                      dict(SMALL, BENCH_CACHE=str(tmp / "port.npy"),
                           BENCH_ROUNDS="8"))
    return tmp, ref, port


# ------------------------------------------------------------- corpus


def bench_py_draws(n, d, n_queries, rows=True):
    """``bench.py:721`` and ``:750-779``, draw for draw (``rows=False``:
    a cache hit, which skips the rows' draws)."""
    rng = np.random.default_rng(42)
    centers = rng.normal(size=(1000, d)).astype(np.float32)
    data = None
    if rows:
        assign = rng.integers(0, 1000, size=n)
        data = centers[assign] + 0.3 * rng.normal(
            size=(n, d)).astype(np.float32)
        data /= np.linalg.norm(data, axis=1, keepdims=True) + 1e-9
    queries = centers[rng.integers(0, 1000, size=n_queries)] + 0.3 * \
        rng.normal(size=(n_queries, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True) + 1e-9
    return data, queries


def test_rows_equal_bench_py_cache(runs):
    tmp, _, _ = runs
    ref_rows = np.load(tmp / "ref.npy")
    assert ref_rows.shape == (N, 128) and ref_rows.dtype == np.float32
    assert np.array_equal(np.load(tmp / "port.npy"), ref_rows)
    data, _, _ = BT.synthetic_corpus(N, 128, 512)
    assert np.array_equal(data, ref_rows)


def test_generator_makes_bench_py_draws():
    data, queries, _ = BT.synthetic_corpus(N, 64, 512)
    want_rows, want_queries = bench_py_draws(N, 64, 512)
    assert np.array_equal(data, want_rows)
    assert np.array_equal(queries, want_queries)


def test_cache_hit_skips_the_row_draws(tmp_path):
    cache = str(tmp_path / "rows.npy")
    rows, first, _ = BT.synthetic_corpus(N, 64, 512, cache=cache)
    cached, again, _ = BT.synthetic_corpus(N, 64, 512, cache=cache)
    assert np.array_equal(np.asarray(cached), rows)
    _, want = bench_py_draws(N, 64, 512, rows=False)
    assert np.array_equal(again, want)
    assert not np.array_equal(again, first)
    with pytest.raises(BT.BenchFault, match="cache shape"):
        BT.synthetic_corpus(N + 64, 64, 512, cache=cache)


# ------------------------------------------------------------- search


def no_near_tie(scores: np.ndarray, k: int, gap: float) -> bool:
    top = -np.sort(-scores, axis=1)[:, : k + 1]
    return bool((top[:, k - 1] - top[:, k] > gap).all())


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_search_step_matches_reference(metric):
    import jax.numpy as jnp

    from helix_tpu.ops.distance import PackedMatrix
    from helix_tpu.ops.distance import resident_topk_auto as ref_search

    data, queries, _ = BT.synthetic_corpus(N, 128, 64, seed=5)
    exact = queries.astype(np.float64) @ data.astype(np.float64).T
    if metric == "l2":
        exact = 2 * exact - (data.astype(np.float64) ** 2).sum(1)[None, :]
    assert no_near_tie(exact, 10, 1e-5)

    ref = PackedMatrix(128, metric)
    ref.extend(data)
    xs16, sq = ref.device_arrays()
    want_d, want_i = ref_search(
        xs16, ref.data_device(), jnp.asarray(ref.prepare_queries(queries)),
        jnp.int32(ref.n), sq, k=10, metric=metric)

    index = BT.ResidentIndex(data, metric, CPU)
    got_d, got_i = index.search(
        torch.from_numpy(index.matrix.prepare_queries(queries)))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)


def test_recall_lines_agree(runs):
    _, ref, port = runs
    assert port["recall_at_10"] == ref["recall_at_10"]
    assert port["recall_at_10"] >= 0.95


def test_keys_are_bench_py_keys(runs):
    _, ref, port = runs
    renamed = {"dispatch_submission_qps": "per_dispatch_qps",
               "e2e_tunnel_qps": "e2e_qps"}
    left_out = {"baseline_attempt"}
    added = {"card", "kernel_launches", "kernel_launches_by_window",
             "graph_kernel_launches", "launches_by_wrapper",
             "graph_peak_bytes"}
    want = {renamed.get(key, key) for key in ref} - left_out | added
    assert set(port) == want
    assert port["backend"] == "cpu" and port["card"] is None
    assert port["scan_timing"]["rounds"] == 8
    assert port["kernel_launches"] == 0  # the CPU runs the plain path
    assert port["kernel_launches_by_window"] == {"per_dispatch": 0, "e2e": 0}
    assert port["graph_kernel_launches"] is None  # no graphs off the card
    # kernel 1 and the selection kernel side by side, none on the CPU
    assert port["launches_by_wrapper"] == {
        name: {"per_dispatch": 0, "e2e": 0, "captured": None}
        for name in ("bucket_scores", "select_topk")}
    assert port["traversal_2hop_device_ms"] > 0
    assert port["hybrid_seed_expand_device_ms"] > 0


# ----------------------------------------------------- real-dataset mode


@pytest.fixture
def mini_sift(tmp_path):
    rng = np.random.default_rng(4)
    n, d, nq, k_gt = 3000, 32, 128, 100
    base = (rng.normal(size=(n, d)) * 20 + 100).astype(np.float32)
    queries = (rng.normal(size=(nq, d)) * 20 + 100).astype(np.float32)
    d2 = (np.sum(base * base, axis=1)[None, :] - 2.0 * queries @ base.T
          + np.sum(queries * queries, axis=1)[:, None])
    gt = np.argsort(d2, axis=1)[:, :k_gt].astype(np.int32)
    ds = tmp_path / "sift"
    ds.mkdir()
    write_fvecs(ds / "sift_base.fvecs", base)
    write_fvecs(ds / "sift_query.fvecs", queries)
    write_ivecs(ds / "sift_groundtruth.ivecs", gt)
    return ds, base, queries, gt


def test_fvecs_ivecs_roundtrip(mini_sift):
    ds, base, queries, gt = mini_sift
    got = BT.read_fvecs(str(ds / "sift_base.fvecs"))
    assert got.shape == base.shape and np.array_equal(got, base)
    assert np.array_equal(BT.read_ivecs(str(ds / "sift_groundtruth.ivecs")),
                          gt)
    loaded = BT.load_texmex(str(ds))
    want = bench._load_texmex(str(ds))
    assert loaded["name"] == want["name"] == "sift"
    assert np.array_equal(loaded["queries"], queries)
    for key in ("base", "queries", "groundtruth"):
        assert np.array_equal(loaded[key], want[key])


def test_load_texmex_missing_files_names_fetch_recipe(tmp_path):
    with pytest.raises(FileNotFoundError, match="fetch_sift.sh"):
        BT.load_texmex(str(tmp_path))


def run_dataset(ds: Path, extra: dict) -> dict:
    env = dict(SMALL, BENCH_SIFT=str(ds), **extra)
    del env["BENCH_N"]
    return run_script(["bench_torch.py", "--device", "cpu"], env)


def test_bench_cosine_mode_on_real_layout(mini_sift):
    ds, *_ = mini_sift
    out = run_dataset(ds, {})
    assert out["dataset"] == "sift"
    assert out["distance_metric"] == "cosine"
    assert out["recall_at_10"] >= 0.95
    assert "oracle" not in out  # normalised: published GT inapplicable


@pytest.mark.slow
def test_bench_l2_mode_uses_published_groundtruth(mini_sift):
    ds, *_ = mini_sift
    out = run_dataset(ds, {"BENCH_METRIC": "l2"})
    assert out["dataset"] == "sift"
    assert out["distance_metric"] == "l2"
    assert out["oracle"] == "published_groundtruth"
    assert out["recall_at_10"] >= 0.95


# ------------------------------------------------- what the port adds


def test_without_cuda_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = run_script(["bench_torch.py"], SMALL, ok=False)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert proc.stdout.strip() == ""


LADDER_TIERS = ["exact", "int8_dev", "int8", "int4", "host_ivf"]


def test_ladder_on_the_cpu_prints_five_rungs():
    """``--ladder`` runs the port's ladder (``bench.py --ladder``'s), its
    own timer included, and passes on the ladder's arguments."""
    proc = run_script(["bench_torch.py", "--ladder", "--device", "cpu",
                       "--n", "8192", "--batch", "64", "--rounds", "2"],
                      {"OMP_NUM_THREADS": "2"}, ok=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == ("residency ladder (N=8192, d=128, k=10, "
                             "batch=64)")
    assert [r["tier"] for r in out["rungs"]] == LADDER_TIERS
    assert out["backend"] == "cpu"
    for row in out["rungs"]:
        assert row["serving"] and row["recall_at_10"] >= 0.95, row
        assert np.isfinite(row["qps"]) and row["qps"] > 0, row


def test_ladder_without_cuda_exits_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = run_script(["bench_torch.py", "--ladder", "--n", "4096"], {},
                      ok=False)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert proc.stdout.strip() == ""


def test_ladder_arguments_need_ladder():
    with pytest.raises(SystemExit) as exc:
        BT.main(["--device", "cpu", "--n", "4096"])
    assert exc.value.code == 2


def test_reading_past_the_bound_fails():
    bound = BT.bound_seconds(1_007_616, 128, 256, "NVIDIA H100 80GB HBM3")
    # bytes: the bf16 matrix + the f32 batch at 3.35 TB/s (> 2 B N D
    # operations at 989 TFLOP/s)
    assert bound == pytest.approx((1_007_616 * 128 * 2 + 256 * 128 * 4)
                                  / 3.35e12)
    assert BT.bound_seconds(1_007_616, 128, 256, "some other card") is None
    BT.check_bound(2 * bound, bound)
    BT.check_bound(bound / 2, None)
    with pytest.raises(BT.BenchFault, match="faster than the card's bound"):
        BT.check_bound(bound / 2, bound)


def test_baseline_measurement_leaves_the_committed_record(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CPU HNSW baseline")
    before = (REPO / "BASELINE_MEASURED.json").read_bytes()
    data, queries, _ = BT.synthetic_corpus(2000, 32, 64)
    oracle = np.argsort(-(queries @ data.T), axis=1)[:, :10]
    got = BT.cpu_hnsw_baseline(data, queries, oracle, cache_dir=tmp_path)
    assert (REPO / "BASELINE_MEASURED.json").read_bytes() == before
    assert got["source"] == "measured" and got["qps"] > 0
    assert got["recall_at_k"] >= 0.95
    record = json.loads((tmp_path / BT.OWN_BASELINE_NAME).read_text())
    assert record["2000x32"]["qps"] == got["qps"]
    assert (tmp_path / "libhxhnsw.so").exists()


def test_unmeasured_baseline_reads_the_committed_record(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("BENCH_SKIP_BASELINE", "1")
    committed = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    shape = np.broadcast_to(np.zeros(128, np.float32), (1_000_000, 128))
    got = BT.cpu_hnsw_baseline(shape, None, None, cache_dir=tmp_path)
    want = committed["1000000x128"]
    assert got["source"] == "cached_measurement"
    assert got["qps"] == want["qps"]
    assert got["measured_at"] == want["measured_at"]
    assert "another host" in got["note"]
    small = np.broadcast_to(np.zeros(16, np.float32), (7, 16))
    assert BT.cpu_hnsw_baseline(small, None, None, cache_dir=tmp_path) == {
        "qps": BT.ASSUMED_CPU_HNSW_QPS, "source": "assumed"}


BLOCKED = r"""
import runpy, sys
from importlib.abc import MetaPathFinder


class Refuse(MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "helix_tpu", "benchmarks"):
            raise ImportError(f"{name} is refused in this run")
        return None


for name in [m for m in sys.modules if m.split(".")[0] == "jax"]:
    del sys.modules[name]
sys.meta_path.insert(0, Refuse())
sys.argv = ["bench_torch.py", "--device", "cpu"]
try:
    runpy.run_path("bench_torch.py", run_name="__main__")
finally:
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "helix_tpu", "benchmarks")]
    print("loaded:", loaded, file=sys.stderr)
"""


def test_runs_with_jax_and_the_reference_blocked():
    proc = run_script(["-c", BLOCKED], dict(SMALL, BENCH_ROUNDS="4"),
                      ok=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "loaded: []" in proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["recall_at_10"] >= 0.95


def test_gateway_bench_reports_reference_keys():
    data, _, _ = BT.synthetic_corpus(N, 64, 8)
    index = BT.ResidentIndex(data, "cosine", CPU)
    totals = {"search": 512, "docs": 500, "lookup": 512, "dyn_vs": 256}
    out = BT.gateway_bench(index.matrix, 64, 10, "cosine", CPU, totals)
    assert "e2e_gateway_note" not in out, out
    for key in ("e2e_gateway_qps", "e2e_gateway_ingest_docs_s",
                "e2e_gateway_lookup_qps", "e2e_gateway_dyn_vsearch_qps",
                "e2e_gateway_null_dispatch_qps"):
        assert out[key] > 0, key
    # warm-up + timed search phase, both on the vector fast path
    assert out["e2e_gateway_fast_path_requests"] >= 2 * totals["search"]
    assert out["e2e_gateway_lookup_requests"] > 0
    assert set(out["e2e_gateway_decomposition"]) == {
        "total_us_per_req", "non_device_us_per_req",
        "device_plus_tunnel_us_per_req", "cxx_framing_floor_us_per_req",
        "python_dispatch_us_per_req"}


def test_graph_checks_refuse_a_wrong_replay():
    ids = [torch.arange(20).reshape(2, 10) + i for i in range(3)]
    BT.check_same_answers(ids, [t.clone() for t in ids], "g")
    stale = [ids[0], ids[0], ids[2]]
    with pytest.raises(BT.BenchFault, match=r"g: .* batches \[1\] of 3"):
        BT.check_same_answers(stale, ids, "g")
    with pytest.raises(BT.BenchFault, match="graph gave 2"):
        BT.check_same_answers(ids[:2], ids, "g")
    BT.check_graph_counts("g", 128, 128)
    for captured, profiled in ((128, 0), (128, 127), (0, 0)):
        with pytest.raises(BT.BenchFault, match="profiled replay"):
            BT.check_graph_counts("g", captured, profiled)


def test_wrapper_counts_graph_nodes_apart_from_launches(monkeypatch):
    """Where the stream captures a CUDA graph the C entry says so and
    ``kernels.launch`` counts a node, not a launch (the node launches at
    each replay); every kernel wrapper carries both counters."""
    from helix_tpu_torch import kernels
    from helix_tpu_torch.benchmarks import i8_sweep, onepass_sweep
    from helix_tpu_torch.ops import distance, quant, quant4, topk
    from helix_tpu_torch.ops import fused_topk as F

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda dev: 0, raising=False)
    wrapper = SimpleNamespace(launches=0, captured=0)
    for rc in (0, kernels.CAPTURED, kernels.CAPTURED):
        kernels.launch(wrapper, lambda stream, rc=rc: rc, 0)
    assert (wrapper.launches, wrapper.captured) == (1, 2)
    for fn in (F.bucket_scores, quant.i8_bucket_scores,
               quant4.i4_bucket_scores, distance.l2_scores, topk.select_topk,
               *onepass_sweep.KERNELS.values(), *i8_sweep.KERNELS.values()):
        assert isinstance(fn.launches, int), fn
        assert isinstance(fn.captured, int), fn


@pytest.mark.cuda
def test_graph_timer_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dev = torch.device("cuda")
    data, _, _ = BT.synthetic_corpus(65_536, 128, 8)
    index = BT.ResidentIndex(data, "cosine", dev)
    rounds = 8
    qbufs = torch.zeros((rounds, 256, 128), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    launched = BT.launches()
    out = BT.device_throughput(index, qbufs, 128, rounds, gen)
    # one kernel-1 node per search, launched once per node in a profiled
    # replay; the wrapper counts the eager check's 8 searches alone
    assert out["graph"] == {"captured": {"half": 4, "full": 8},
                            "profiled_replay": {"half": 4, "full": 8},
                            "timed_replays": {"half": 3, "full": 3}}
    assert out["graph_peak_bytes"] > 0
    bound = BT.bound_seconds(int(index.xs16.shape[0]), 128, 256,
                             torch.cuda.get_device_name(dev))
    BT.check_bound(out["per_batch_s"], bound)
    lat = BT.serialized_latency(index, qbufs, 128, rounds, gen)
    assert lat["graph"] == {"captured": rounds, "profiled_replay": rounds,
                            "timed_replays": 3}
    assert lat["latency_ms"] > 0
    # warm-ups (2 + 1 captures' worth) and the eager checks (8 + 8)
    assert BT.launches() - launched == (8 + 4) + 8 + 8 + 8


# ------------------------------------------ the CPU HNSW baseline's copy


def _functions(path: Path) -> dict:
    """Every function and method of a module by name (``Class.method``)."""
    tree = ast.parse(path.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{f.name}": f for f in node.body
                        if isinstance(f, ast.FunctionDef)})
    return out


def _assigned(fn: ast.FunctionDef, name: str) -> list:
    """The source of every value assigned to ``name`` in ``fn``."""
    return [ast.unparse(n.value) for n in ast.walk(fn)
            if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == name
                    for t in n.targets)]


def _ef_ladder(fn: ast.FunctionDef) -> list:
    return [ast.literal_eval(n.iter) for n in ast.walk(fn)
            if isinstance(n, ast.For) and isinstance(n.target, ast.Name)
            and n.target.id == "ef"]


def _defaults(fn: ast.FunctionDef) -> dict:
    args = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
    pairs = list(zip(args, fn.args.defaults))
    pairs += [(a, d) for a, d in zip(fn.args.kwonlyargs, fn.args.kw_defaults)
              if d is not None]
    return {a.arg: ast.unparse(d) for a, d in pairs}


def _lists_from(fn: ast.FunctionDef, head: tuple) -> list:
    """Literal prefixes of the list displays in ``fn`` that start with
    ``head`` (the build's command lines)."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.List) and all(
                isinstance(e, ast.Constant) for e in node.elts[:len(head)]) \
                and tuple(e.value for e in node.elts[:len(head)]) == head:
            out.append([e.value for e in node.elts
                        if isinstance(e, ast.Constant)])
    return out


def _signatures(fn: ast.FunctionDef) -> set:
    """The ctypes ``lib.<entry>.argtypes / restype = ...`` lines."""
    return {ast.unparse(n) for n in ast.walk(fn)
            if isinstance(n, ast.Assign) and isinstance(n.targets[0],
                                                        ast.Attribute)
            and n.targets[0].attr in ("argtypes", "restype")}


def _returned_keys(fn: ast.FunctionDef) -> set:
    ret = [n.value for n in ast.walk(fn)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].keys}


def test_hnsw_baseline_copy_matches_benchmarks_cpu_hnsw():
    """``bench_torch.py`` carries its own copy of
    ``benchmarks/cpu_hnsw.py`` (the port may not import it: it imports
    ``helix_tpu.native``).  What sets the measured number stays equal:
    the ef ladder, the compile and link flags and the build key's
    suffix, the timed-query count, the index's build parameters and
    cache name, the target recall, the library's C signatures and the
    record's keys.  Intended differences: the library is built into
    ``.bench_cache/`` (the reference builds it into ``benchmarks/``),
    ``CpuHnsw`` takes the loaded library and ``load`` reads no header,
    ``search`` returns the ids alone, and the record of a measurement
    goes to ``.bench_cache/`` (``bench.py`` rewrites
    ``BASELINE_MEASURED.json``)."""
    ref = _functions(REPO / "benchmarks" / "cpu_hnsw.py")
    port = _functions(REPO / "bench_torch.py")
    ref_measure, port_measure = ref["measure_baseline"], \
        port["measure_baseline"]

    assert _ef_ladder(port_measure) == _ef_ladder(ref_measure) != []
    assert _assigned(port_measure, "reps") == _assigned(ref_measure, "reps")
    assert _assigned(port_measure, "cache") == _assigned(ref_measure, "cache")
    assert _defaults(port_measure)["target_recall"] == \
        _defaults(ref_measure)["target_recall"]
    assert _returned_keys(port_measure) == _returned_keys(ref_measure)

    build = ("m", "ef_construction", "seed", "chunk")
    assert {a: _defaults(port["CpuHnsw.build"])[a] for a in build} == \
        {a: _defaults(ref["CpuHnsw.build"])[a] for a in build}

    ref_build, port_build = ref["_build"], port["hnsw_library"]
    for head in (("g++", "-c"), ("g++", "-shared")):
        want = _lists_from(ref_build, head)
        assert want and _lists_from(port_build, head) == want, head
    # the build key: the same flags string over the source
    assert [k.split(", ", 1)[1] for k in _assigned(port_build, "key")] == \
        [k.split(", ", 1)[1] for k in _assigned(ref_build, "key")]
    assert _signatures(port_build) == _signatures(ref["_load"]) != set()

    bench_py = (REPO / "bench.py").read_text()
    assert f"ASSUMED_CPU_HNSW_QPS = {BT.ASSUMED_CPU_HNSW_QPS:_}" in bench_py
