"""The port's int8 sweep (kernel 5, ``helix_tpu_torch.benchmarks
.i8_sweep``) against the reference's ``benchmarks/i8_sweep.py``.

The reference's kernels are closures inside its ``main()``.  They are
reached without editing it: ``benchmarks.roofline.timed_scan_qps`` is
replaced by a stub that records each variant's ``(fn, operands)``, and
``main()`` runs with ``--interpret`` at a small ``--n`` (``pl.pallas_call``
is set through a ``MonkeyPatch`` first, so that the interpret wrapper
``main()`` installs is undone for the other test files of the worker).
Each recorded ``fn`` is then called on this file's own queries, and the
port's variant on the same operands (CPU tensors: the plain versions).

Variants that return winners (the probes, ``xT``) agree bit for bit (the
sums are exact integers), apart from the documented denormal rule
applied to the reference's side.  Variants that return ids return the
top ``k_cand`` buckets' rows: compared as per-query sets on the queries
whose winners hold no tie at rank ``k_cand``.  ``n`` = 12,000 pads to
16,384 (an interior tile, a tile holding padding rows, a straddling
bucket, wholly dead buckets); ``n`` = 16,384 has no padding row.
"""

import json
import sys

import numpy as np
import pytest
import torch

from helix_tpu_torch.benchmarks import i8_sweep
from helix_tpu_torch.ops import fused_topk as TF
from helix_tpu_torch.ops import quant as TQ

torch.set_num_threads(2)

ALL = ("shipped,full_noT,dotf32,ep_astype,ep_scale,ep_pack,ep_mask,"
       "ep_full_amk,xT,amk,scale2d,gscale,bf16dot,bf16dot_tail,i32pack,"
       "dot_i8,dot_bf16")
NAMES = ALL.split(",")
WINNERS = i8_sweep.PROBES + ("xT",)
KC = 80


@pytest.fixture(scope="module", params=[12_000, 16_384])
def reference(request):
    """(n, {variant: (fn, operands)}) of the reference's main() at
    ``--n`` = n, B = 128; pallas_call stays in interpret mode until the
    module's tests are done."""
    import benchmarks.i8_sweep as ref
    import benchmarks.roofline as ref_roofline
    from jax.experimental import pallas as pl

    n = request.param
    recorded = []

    def record(fn, *, operands=(), **kwargs):
        recorded.append((fn, operands))
        return 1.0, {"per_batch_ms_samples": [1.0]}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pl.pallas_call)
        mp.setattr(ref_roofline, "timed_scan_qps", record)
        mp.setattr(sys, "argv", ["i8_sweep", "--interpret", "--n", str(n),
                                 "--batch", "128", "--variants", ALL])
        ref.main()
        yield n, dict(zip(NAMES, recorded))


def port_operands(n, ref_ops):
    """The port's operand dict on the reference's operand arrays."""
    def t(name, i):
        return torch.from_numpy(np.asarray(ref_ops[name][1][i]).copy())

    return {"n_valid": n, "xs_i8": t("dot_i8", 0),
            "xscales": t("ep_astype", 1).reshape(-1),
            "xs_i8b": t("i32pack", 0), "bscales": t("i32pack", 1).reshape(-1),
            "xs_i8g": t("gscale", 0)}


def flush(v: np.ndarray) -> np.ndarray:
    bits = v.view(np.int32)
    return np.where((bits & 0x7F800000) == 0, bits & np.int32(-2 ** 31),
                    bits).view(np.float32)


def unit_queries(b, seed):
    q = np.random.default_rng(seed).normal(size=(b, 128)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def winners_for(name, ops, qs):
    """The port's bucket winners behind an id-returning variant, [B,
    buckets]."""
    q_i8, _ = TQ._quantize_queries(qs)
    if name == "shipped":
        return TQ.i8_bucket_scores(ops["xs_i8g"], q_i8, ops["n_valid"]).T
    kernel = i8_sweep.KERNELS[name]
    body = kernel.body
    a, sc = {"bucket": (ops["xs_i8b"], ops["bscales"]),
             "none": (ops["xs_i8g"] if name == "gscale" else ops["xs_i8"],
                      None)}.get(body.scale, (ops["xs_i8"], ops["xscales"]))
    q = q_i8.to(torch.bfloat16) if body.dot == "bf16" else q_i8
    vals = kernel(a, q, sc, ops["n_valid"])
    return vals if body.transposed else vals.T


@pytest.mark.parametrize("b", [128, 256])
@pytest.mark.parametrize("name", NAMES)
def test_variant_equals_the_reference(reference, name, b):
    import jax.numpy as jnp

    n, ref_ops = reference
    fn, operands = ref_ops[name]
    qs = unit_queries(b, seed=b + n)
    want = np.asarray(fn(jnp.asarray(qs), *operands))
    ops = port_operands(n, ref_ops)
    port_fn, port_args, _ = i8_sweep.variants(ops, KC, 0)[name]
    got = port_fn(torch.from_numpy(qs), *port_args).numpy()
    assert got.shape == want.shape
    if name in WINNERS:
        np.testing.assert_array_equal(got.view(np.int32),
                                      flush(want).view(np.int32))
        return
    vals = winners_for(name, ops, torch.from_numpy(qs))
    top = torch.sort(vals, dim=1, descending=True).values
    untied = (top[:, KC - 1] != top[:, KC]).numpy()
    # amk's winners are unpacked integers, which tie often
    assert untied.mean() >= (0.5 if name == "amk" else 1.0)
    for i in np.flatnonzero(untied):
        assert set(got[i]) == set(want[i]), (name, i)


def planted(n_pad):
    """Operands whose winners for a query along e_0 are known: every row
    scores 127 * -50 but bucket 3 (rows 202 and 212 tie at 127 * -10),
    bucket 7 (rows 453 and 488 tie at 127 * 30) and bucket 11 (row 737
    is zero: a zero sum wins its bucket)."""
    xs = np.zeros((n_pad, 128), np.int8)
    xs[:, 0] = -50
    xs[[202, 212], 0] = -10
    xs[[453, 488], 0] = 30
    xs[737] = 0
    q = np.zeros((1, 128), np.float32)
    q[0, 0] = 1.0
    return xs, q


@pytest.mark.parametrize("name", ["i32pack", "scale2d"])
def test_ties_and_the_zero_sum_winner(reference, name):
    """i32pack takes the higher row among equal sums of either sign (the
    int domain); the f32 pack takes the higher one among positive and
    the lower among negative scores.  A zero-sum winner packs (scale2d)
    or re-packs (i32pack) to a bare index, a denormal: the port flushes it
    to 0, index bits 0, in both.  The reference flushes the packed max
    (XLA's flush) but keeps the re-packed bits, a bitcast: its i32pack
    names the zero row itself (737)."""
    import jax.numpy as jnp

    n, ref_ops = reference
    fn, operands = ref_ops[name]
    xs, q = planted(operands[0].shape[0])
    scales = np.full(operands[1].shape, 1 / 127, np.float32)
    want = np.asarray(fn(jnp.asarray(q), jnp.asarray(xs),
                         jnp.asarray(scales)))[0, :3]
    port_fn, _, _ = i8_sweep.variants(port_operands(n, ref_ops), KC, 0)[name]
    got = port_fn(torch.from_numpy(q), torch.from_numpy(xs),
                  torch.from_numpy(scales.reshape(-1))).numpy()[0, :3]
    negative_tie = 212 if name == "i32pack" else 202
    assert got.tolist() == [488, 11 * 64, negative_tie]
    assert want[0] == 488 and want[2] == negative_tie
    assert want[1] == (737 if name == "i32pack" else 11 * 64)


def test_quantize_rows_bucketed_equals_the_reference():
    import benchmarks.i8_sweep as ref

    rows = np.random.default_rng(2).normal(size=(640, 96)).astype(np.float32)
    rows[128:192] = 0  # a zero bucket takes scale 1
    for got, want in zip(i8_sweep.quantize_rows_bucketed(rows, 64),
                         ref.quantize_rows_bucketed(rows, 64)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(i8_sweep.BODIES))
def test_body_matches_its_plain_version_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    kernel = i8_sweep.KERNELS[name]
    rng = np.random.default_rng(21)
    n, b, n_valid = 65_536, 256, 60_000 - 37
    xs = torch.from_numpy(rng.integers(-127, 128, size=(n, 128),
                                       dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 128, size=(b, 128),
                                      dtype=np.int8))
    if kernel.body.dot == "bf16":
        q = q.to(torch.bfloat16)
    rows = n // TF.BUCKET if kernel.body.scale == "bucket" else n
    sc = torch.from_numpy(rng.random(rows, dtype=np.float32) + 0.5)
    sc = None if kernel.body.scale == "none" else sc
    want = kernel.reference(xs, q, sc, n_valid)
    before = kernel.launches
    got = kernel(xs.to(dev), q.to(dev), None if sc is None else sc.to(dev),
                 n_valid).cpu()
    assert kernel.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ------------------------------------------------------------ the sweep


def run_main(argv, capsys):
    rc = i8_sweep.main(argv)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.out
    return rc, json.loads(lines[0]), out.err


def test_sweep_runs_every_variant_on_the_cpu(capsys):
    rc, line, _ = run_main(["--device", "cpu", "--n", "12000",
                            "--rounds", "2", "--variants", ALL], capsys)
    assert rc == 0
    assert set(line) == {"metric", "roofline_qps_int8_mxu",
                         "roofline_qps_bf16_mxu", "plan", "device",
                         "variants"}
    assert line["metric"] == ("int8 coarse kernel sweep (N=12000, d=128, "
                              "batch=256, k_cand=80)")
    assert line["plan"] is None and line["device"] == "cpu"
    rows = {row["variant"]: row for row in line["variants"]}
    assert list(rows) == NAMES
    for name, row in rows.items():
        keys = {"variant", "qps", "per_batch_ms", "bound_ms", "launches",
                "captured"}
        if name not in i8_sweep.TIMING_ONLY:
            keys.add("containment_at_kcand")
            assert row["containment_at_kcand"] >= 0.95
        assert set(row) == keys and row["qps"] > 0


def test_sweep_defaults_are_the_reference_variants(capsys):
    rc, line, _ = run_main(["--device", "cpu", "--n", "12000",
                            "--rounds", "2"], capsys)
    assert rc == 0
    assert [r["variant"] for r in line["variants"]] == [
        "shipped", "bf16dot", "bf16dot_tail", "i32pack", "dot_i8",
        "dot_bf16"]


def test_a_failed_variant_fails_the_sweep(capsys, monkeypatch):
    real = i8_sweep.timed_scan_qps

    def timed(fn, **kwargs):
        if fn.__name__ == "fn_shipped":
            raise RuntimeError("no graph")
        return real(fn, **kwargs)

    monkeypatch.setattr(i8_sweep, "timed_scan_qps", timed)
    rc, line, err = run_main(["--device", "cpu", "--n", "12000",
                              "--rounds", "2", "--variants",
                              "shipped,gscale"], capsys)
    assert rc == 1 and "shipped: FAILED" in err
    assert line["variants"][0] == {"variant": "shipped",
                                   "error": "RuntimeError('no graph')"}
    assert line["variants"][1]["variant"] == "gscale"
