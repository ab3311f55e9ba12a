"""hxbench: the end-to-end benchmark of ``helix_tpu_torch`` on one H100.

One command runs one cell (a configuration under a traffic mix) once::

    python3 -m hxbench.run --workload deep10m-cos.batch256 --seed 7 \\
        --seconds 20 --trace 0

and prints, as its last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device``.  The
cells and metrics are listed in ``BENCHMARK.json`` at the root of the
repository; everything else is found by name, so a new cell, mix or
metric is new files and new entries, never an edit of a file here:

- A configuration is ``configs/<name>.json``: its source, its published
  shape (``rows``, ``dim``, ``metric``, ``k``), ``reduced``, the data
  generator and its parameters (``generator``, listed under
  ``assumed``), the guarantees the comparison holds the answers to
  (``guarantees``), and the deployment (``deployment``), whose
  ``hbm_budget_bytes`` and ``quant_candidates`` are handed to the
  engine: the residency ladder's budget and its quantized rungs'
  candidate floor, absent or null for the engine's default (no budget,
  so the exact rung serves).  Standard error names the rung that
  serves.  Add the file and an entry under ``configs`` in
  ``BENCHMARK.json`` whose ``file`` names it.
- A traffic mix is ``traffic/<name>.json``: parameters only, read by the
  one general generator in :mod:`hxbench.loops`.  ``"entry": "engine"``
  is a closed loop of batches through ``Partition.search_many_async``
  (``batch``, ``in_flight``, ``k``, ``pool_qps``, and for a write mix
  ``insert_share``: inserts as a share of all operations, each a
  ``Partition.add`` of a row from the seed's insert stream, and
  ``latest_share``: the share of each batch's queries that search the
  newest acknowledged rows with their own rows; every answer is held to
  the rows acknowledged before its dispatch, and the newest inserts are
  read back after the window); ``"entry": "http"``
  is an open loop of single-query requests through the native gateway
  (``rate_per_s``, ``clients``, ``connections``, ``k``).  A cell's own
  values, such as the rate a sweep found for one configuration, go in
  ``cells/<workload name>.json``, which overrides the mix's keys for
  that cell alone.
- A per-layer metric is ``metrics/<metric name>.py`` with one function
  ``read(run) -> float | None`` over the run's record
  (:class:`hxbench.record.Record`: spans, counters, the reduced device
  trace, the cell).  It returns ``None`` where it finds nothing to read,
  and the metric is then left out of the result line.

The harness takes from the program (the ``helix_tpu_torch`` package) only
the system under test: the engine, its partition and the gateway.  The
data generator, the reference, the comparison, the peaks and the trace
reduction are this package's own, and it imports neither ``jax`` nor
``helix_tpu`` nor ``benchmarks``.

Tests: ``python -m pytest hxbench/tests -q`` (CPU; the tests marked
``cuda`` run on the card with ``python -m pytest hxbench/tests -m cuda``).
"""
