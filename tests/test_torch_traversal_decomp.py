"""The port's 2-hop decomposition (``helix_tpu_torch.benchmarks
.traversal_decomp``) against the reference's
``benchmarks/traversal_decomp.py``.

Both ``main``s run with ``chained_ms`` replaced by a recorder of each
piece's function, at ``--n 65536`` (``mask_from``'s power-of-two branch,
``carry & (n - 1)``) and ``--n 70000`` (its ``carry % n`` branch),
``--deg 4``, on one graph each (both build it from the same seed).  Every
piece returns an integer, so its scalar must be equal exactly (no
tolerance) at carries 1 and 12,345 and along a 3-step chain in which
each result is the next carry, ``full_2hop`` included.  The port's own
``compact_nonzero`` (the compaction its hop runs) must count what
``compact65536`` counts while the frontier holds at most 65,536 rows.
"""

import json
import sys

import numpy as np
import pytest
import torch

from helix_tpu_torch.benchmarks import traversal_decomp

torch.set_num_threads(2)

REF_PIECES = ["compact4096", "compact65536", "gather4096", "gather65536",
              "scatter_from_4096x4", "scatter_from_65536x4", "dense_hop",
              "full_2hop"]
CARRIES = (1, 12_345)


def recorder(recorded: dict, names: list):
    def record(fn, seed_val, rounds=8, **kwargs):
        recorded[names[len(recorded)]] = fn
        return 1.0
    return record


@pytest.fixture(scope="module", params=[65_536, 70_000])
def sides(request):
    """(n, the reference's pieces, the port's pieces, both JSON lines)."""
    import contextlib
    import io

    import benchmarks.traversal_decomp as ref

    n = request.param
    argv = ["--n", str(n), "--deg", "4"]
    ref_pieces, port_pieces = {}, {}
    port_names = REF_PIECES[:2] + ["compact_nonzero"] + REF_PIECES[2:]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "chained_ms", recorder(ref_pieces, REF_PIECES))
        mp.setattr(traversal_decomp, "chained_ms",
                   recorder(port_pieces, port_names))
        mp.setattr(sys, "argv", ["traversal_decomp", *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.main()
            rc = traversal_decomp.main(["--device", "cpu", *argv])
    assert rc == 0
    ref_line, port_line = (json.loads(x) for x in
                           buf.getvalue().strip().splitlines())
    return n, ref_pieces, port_pieces, ref_line, port_line


def ref_value(fn, carry: int) -> int:
    import jax.numpy as jnp

    return int(fn(jnp.int32(carry)))


def port_value(fn, carry: int) -> int:
    return int(fn(torch.tensor(carry, dtype=torch.int32)))


@pytest.mark.parametrize("piece", REF_PIECES)
@pytest.mark.parametrize("carry", CARRIES)
def test_piece_equals_the_reference_at_a_carry(sides, piece, carry):
    _, ref_pieces, port_pieces, _, _ = sides
    assert port_value(port_pieces[piece], carry) == ref_value(
        ref_pieces[piece], carry)


@pytest.mark.parametrize("piece", REF_PIECES)
def test_piece_equals_the_reference_along_a_chain(sides, piece):
    _, ref_pieces, port_pieces, _, _ = sides
    want, got = [1], [1]
    for _ in range(3):
        want.append(ref_value(ref_pieces[piece], want[-1]))
        got.append(port_value(port_pieces[piece], got[-1]))
    assert got == want


@pytest.mark.parametrize("carry", CARRIES)
def test_compact_nonzero_counts_what_compact65536_counts(sides, carry):
    _, _, port_pieces, _, _ = sides
    count = port_value(port_pieces["compact_nonzero"], carry)
    assert 0 < count <= 65_536
    assert count == port_value(port_pieces["compact65536"], carry)


def test_line_has_the_reference_pieces(sides):
    n, _, _, ref_line, port_line = sides
    assert port_line["metric"] == ref_line["metric"] == (
        f"adaptive-2hop decomposition (N={n}, P=4)")
    assert list(port_line["pieces_ms"]) == (
        REF_PIECES[:2] + ["compact_nonzero"] + REF_PIECES[2:])
    assert set(ref_line["pieces_ms"]) == set(REF_PIECES)
    assert port_line["backend"] == "cpu"
    assert port_line["values"]["full_2hop"] == ref_value(
        sides[1]["full_2hop"], 1)


def test_port_timer_runs_eagerly_on_the_cpu():
    calls = []

    def fn(carry):
        calls.append(int(carry))
        return (torch.arange(50_000) * carry).sum() % 1000 + 1

    ms = traversal_decomp.chained_ms(fn, 1, 8, device=torch.device("cpu"))
    assert np.isfinite(ms) and ms > 0
    assert len(calls) == 4 + 3 * 12  # warm-up, then 3 x (8 + 4)
    assert calls[1] == int(fn(torch.tensor(1))) and calls[0] == 1


def test_a_failed_piece_still_prints_the_line_and_exits_1(capsys,
                                                          monkeypatch):
    def fail(fn, seed_val, rounds=8, **kwargs):
        if kwargs.get("eager"):
            raise RuntimeError("timing fault")
        return 1.0

    monkeypatch.setattr(traversal_decomp, "chained_ms", fail)
    rc = traversal_decomp.main(["--device", "cpu", "--n", "8192", "--deg",
                                "2"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert rc == 1 and out.err.count("FAILED") == 2
    assert "full_2hop" not in line["pieces_ms"] and "dense_hop" in \
        line["pieces_ms"]


def test_refuses_to_run_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert traversal_decomp.main(["--n", "8192"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
