"""Build and measure the CPU HNSW baseline over the ladder's corpus
(PyTorch port of ``benchmarks/build_ladder_baseline.py``).

Builds once (cached under ``.bench_cache/``) a reference-class CPU HNSW
(m=16, ef_construction=128) over the corpus ``benchmarks/ladder.py``
serves (:func:`ladder._corpus`), walks the ef_search ladder to
recall@10 >= 0.95 against the ladder's own oracle, and records the
measurement under ``ladder:{n}x{d}``, which ``ladder.py`` reads as each
rung's ``vs_baseline`` denominator.

    python -m helix_tpu_torch.benchmarks.build_ladder_baseline --n 10000000

(a 10M single-core build takes hours; it runs once and is cached).

Differences from the reference:

- The HNSW is ``bench_torch.py``'s copy of ``benchmarks/cpu_hnsw.py``.
- The measurement goes to the port's own record,
  ``.bench_cache/baseline_measured_torch.json`` (``--cache-dir``), never
  to ``BASELINE_MEASURED.json``, which the reference rewrites.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .ladder import _corpus, _oracle, log


def ladder_baseline(n: int, d: int = 128, batch: int = 256,
                    rounds: int = 8, k: int = 10, allow_build: bool = True,
                    cache_dir: Path | None = None, log=log) -> dict | None:
    """Measure (or load and measure) the CPU HNSW baseline for the ladder
    corpus at scale ``n`` and record it in ``cache_dir``'s own record.
    Returns the measurement, or None when no cached index exists and
    builds are not allowed."""
    import bench_torch as BT  # the checkout's root script: the HNSW copy

    cache_dir = BT.CACHE_DIR if cache_dir is None else Path(cache_dir)
    log(f"# generating ladder corpus N={n} d={d} (seed 42)...")
    data, queries = _corpus(n, d, batch, max(4, rounds))
    log("# oracle (blocked exact host scan) over the first batch...")
    oracle = _oracle(data, queries[:batch], k)
    measured = BT.measure_baseline(
        data, queries[:batch], oracle, cache_dir,
        allow_build=allow_build, cache_tag="ladder",
    )
    if measured is not None:
        measured["corpus"] = "ladder"
        measured["source"] = "measured"
        BT.record_baseline(cache_dir / BT.OWN_BASELINE_NAME,
                           f"ladder:{n}x{d}", measured)
    return measured


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--cache-dir", default=None,
                    help="where the index and the port's record live "
                         "(default: the checkout's .bench_cache/)")
    args = ap.parse_args(argv)
    measured = ladder_baseline(args.n, args.d, args.batch, args.rounds,
                               cache_dir=args.cache_dir)
    print(json.dumps(measured), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
