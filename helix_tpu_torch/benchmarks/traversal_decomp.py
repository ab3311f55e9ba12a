"""Per-primitive decomposition of the adaptive device 2-hop (PyTorch port
of ``benchmarks/traversal_decomp.py``).

Each primitive of the adaptive hop (``ops/csr.py``) is timed by
:func:`chained_ms`: R-vs-R/2 differenced chains in which each result
feeds the next call's input (the carry perturbs one slot of the start
mask, or offsets the gathered rows), so no call can be hoisted or
overlapped away.

Pieces, on a random graph of N nodes and degree P (``--deg``):

- ``compact4096``, ``compact65536``: top-k of the masked iota (the
  reference's frontier compaction), ``distance._top_k`` for
  ``lax.top_k``;
- ``compact_nonzero``: the compaction the port's hop runs
  (``mask.nonzero()``), so that the pieces add up to the port's
  ``full_2hop``;
- ``gather4096``, ``gather65536``: a row gather ``[K, P]`` + label mask;
- ``scatter_from_4096xP``, ``scatter_from_65536xP``: a scatter of the
  gathered targets into an N-mask;
- ``dense_hop``: the dense tier (every row's masked slots);
- ``full_2hop``: the shipped ``khop_count`` (2 hops, label 1, a keep
  mask).

Usage::

    python -m helix_tpu_torch.benchmarks.traversal_decomp [--n 1000000]
        [--deg 16] [--rounds 8]
    python -m helix_tpu_torch.benchmarks.traversal_decomp --device cpu \\
        --n 65536 --deg 4

Prints one JSON line: ``metric``, ``backend``, ``pieces_ms``.

Differences from the reference:

- ``--device cuda`` (the default; exits nonzero without a card) or
  ``cpu``; ``backend`` names the card (or ``cpu``).
- On the card each chain of R (or R/2) dependent calls is one CUDA
  graph (the carry a 0-d int32 device tensor), replayed and timed with
  CUDA events, median of 3 differences; the graph's final carry is held
  to an eager chain's.  ``compact_nonzero`` and ``full_2hop`` cannot be
  captured (``nonzero`` and the hop's tier choice read the live count on
  the host, one sync per hop), so they run as eager chains timed on the
  host clock after ``torch.cuda.synchronize``; the line lists them under
  ``eager``.  On the CPU every chain is eager.
- A difference that is not positive fails its piece (the reference
  floors it at 0); a failed piece prints ``FAILED`` on stderr, the line
  is still printed, and the script exits 1.
- ``jnp.take(mode="clip")`` is a clamp and ``index_select``;
  ``.at[...].set(True)`` is ``index_fill_`` with int64 indices.
- ``pieces_ms`` keeps 5 decimals (the reference 3).
- The line adds ``values``: each piece's scalar at carry 1 (the chain's
  first call), and ``eager``.
- The hop's kernels are loaded before any chain runs
  (``csr._load_hop_kernels``), so lazy module loading lands in no chain.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from ..ops import csr
from ..ops.distance import _top_k
from .roofline import _capture, _elapsed_ms

# Pieces that read a count on the host: never captured.
EAGER = ("compact_nonzero", "full_2hop")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _chain(fn, seed: torch.Tensor, r: int) -> torch.Tensor:
    carry = seed
    for _ in range(r):
        carry = fn(carry).to(torch.int32)
    return carry


def chained_ms(fn, seed_val: int, rounds: int = 8, *,
               device: torch.device, eager: bool = False) -> float:
    """Median of 3 R-vs-R/2 differences of a chain around ``fn``, in ms
    per call.  ``fn(carry) -> 0-d tensor`` must consume the carry (a
    data dependency) and return a scalar derived from its real work.  On
    a CUDA device each chain is a CUDA graph unless ``eager``."""
    half = max(rounds // 2, 1)
    seed = torch.tensor(seed_val, dtype=torch.int32, device=device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda and not eager:
        graphs = {r: _capture(lambda r=r: _chain(fn, seed, r), device)
                  for r in (half, rounds)}

        def run(r: int) -> float:
            return _elapsed_ms(graphs[r][0].replay, device)
    else:
        graphs = None

        def run(r: int) -> float:
            sync()
            t0 = time.perf_counter()
            _chain(fn, seed, r)
            sync()
            return (time.perf_counter() - t0) * 1e3

        run(half)  # warm-up
    samples = []
    for _ in range(3):
        t_full = run(rounds)
        t_half = run(half)
        samples.append((t_full - t_half) / (rounds - half))
    per_call = statistics.median(samples)
    if not (per_call > 0 and math.isfinite(per_call)):
        raise RuntimeError(f"timing fault: full - half differences "
                           f"{samples} ms per call are not positive")
    if graphs is not None:
        want = _chain(fn, seed, rounds)
        if not torch.equal(graphs[rounds][1], want):
            raise RuntimeError(f"the timed graph's carry "
                               f"{int(graphs[rounds][1])} differs from an "
                               f"eager chain's {int(want)}")
    return per_call


def build(n: int, deg: int, device: torch.device) -> dict:
    """The reference's graph (seed 0: degree ``deg`` random targets, 4
    label codes), its keep and start masks, and the pieces."""
    rng = np.random.default_rng(0)
    edge_dst = rng.integers(0, n, size=n * deg).astype(np.int32)
    indptr = np.arange(n + 1, dtype=np.int64) * deg
    edge_lab = rng.integers(0, 4, size=n * deg).astype(np.int32)
    padded = csr.PaddedGraph.from_csr(indptr, edge_dst, edge_lab, n,
                                      device=device)
    csr._load_hop_kernels(padded)
    neighbors, labels = padded.neighbors, padded.edge_labels
    p = neighbors.shape[1]
    keep = torch.from_numpy(rng.random(n) < 0.5).to(device)
    start = torch.from_numpy(rng.random(n) < 0.001).to(device)
    label_code = 1
    iota = torch.arange(n, dtype=torch.int32, device=device)

    def mask_from(carry):
        # perturb one slot per call off the fixed start mask
        slot = carry & (n - 1) if (n & (n - 1)) == 0 else carry % n
        return start ^ (iota == slot)

    def scatter_true(targets):
        out = torch.zeros(n + 1, dtype=torch.bool, device=device)
        out.index_fill_(0, targets.reshape(-1).long(), True)
        return out[:n]

    def take(table, idx):
        return table.index_select(0, idx.clamp(0, n - 1))

    pieces = {}
    for kk in (4096, 65536):
        def compact(carry, kk=kk):
            score = torch.where(mask_from(carry), iota, -1)
            v, _ = _top_k(score, kk)
            return torch.sum(v >= 0)
        pieces[f"compact{kk}"] = compact

    def compact_nonzero(carry):
        live = mask_from(carry).nonzero().squeeze(1)
        return torch.sum(live >= 0)
    pieces["compact_nonzero"] = compact_nonzero

    for kk in (4096, 65536):
        def gather(carry, kk=kk):
            idx = (torch.arange(kk, dtype=torch.int32, device=device) * 7919
                   + carry) % n
            rows, labs = take(neighbors, idx), take(labels, idx)
            ok = labs == label_code
            return torch.sum(torch.where(ok, rows, 0) & 1)
        pieces[f"gather{kk}"] = gather

    for kk in (4096, 65536):
        def scatter(carry, kk=kk):
            idx = (torch.arange(kk, dtype=torch.int32, device=device) * 7919
                   + carry) % n
            return torch.sum(scatter_true(take(neighbors, idx)))
        pieces[f"scatter_from_{kk}x{p}"] = scatter

    def dense(carry):
        live = mask_from(carry)[:, None]
        ok = labels == label_code
        return torch.sum(scatter_true(torch.where(live & ok, neighbors, n)))
    pieces["dense_hop"] = dense

    def full(carry):
        return csr.khop_count(neighbors, labels, mask_from(carry),
                              label_code, 2, keep)
    pieces["full_2hop"] = full

    return {"graph": padded, "p": p, "keep": keep, "label_code": label_code,
            "mask_from": mask_from, "pieces": pieces,
            "csr": (indptr, edge_dst, edge_lab)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="the adaptive device 2-hop, piece by piece")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        log("traversal_decomp: no CUDA device (use --device cpu)")
        return 1
    ctx = build(args.n, args.deg, device)
    seed = torch.tensor(1, dtype=torch.int32, device=device)
    out, values, failed = {}, {}, []
    for name, fn in ctx["pieces"].items():
        try:
            values[name] = int(fn(seed))
            out[name] = round(chained_ms(fn, 1, args.rounds, device=device,
                                         eager=name in EAGER), 5)
        except Exception as exc:  # noqa: BLE001 -- the line still prints
            log(f"# {name}: FAILED {exc!r}")
            failed.append(name)
            continue
        log(f"# {name}: {out[name]} ms")
    print(json.dumps({
        "metric": f"adaptive-2hop decomposition (N={args.n}, P={ctx['p']})",
        "backend": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
        "pieces_ms": out,
        "values": values,
        "eager": list(EAGER if device.type == "cuda" else ctx["pieces"]),
    }), flush=True)
    if failed:
        log(f"# failed: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
