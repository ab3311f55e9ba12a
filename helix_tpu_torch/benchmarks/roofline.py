"""The card's bound for a batch, and scan timing (PyTorch port of
``benchmarks/roofline.py``).

:func:`timed_scan_qps` measures the sustained per-batch throughput of
``fn_q(qb, *operands)`` by the reference's two-point difference: the time
of ``rounds`` calls over distinct fresh query batches minus the time of
``rounds / 2``, over ``rounds / 2``, the median of ``reps`` differences.
:func:`roofline_batch_seconds` is the least time one batch could take.

Differences from the reference:

- The peaks are the card's (``helix_tpu_torch/card.py``: the H100's
  3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOP/s int8), not the TPU table; a
  card the table does not know, and the CPU, have no bound (None).
- The timed window on the card is one CUDA graph of ``rounds`` calls
  (``bench_torch.py``'s pattern), captured after a warm-up on a side
  stream, over static query buffers ``[rounds, batch, dim_pad]`` that a
  ``torch.Generator`` refills in place before each replay: the kernels
  encode their TMA descriptors from the pointers at each call, so a graph
  replays the pointers it captured.  After the timed replays the full
  graph's outputs are held to an eager run over the same buffers (a
  stale pointer keeps its timing, not its answers).  On the CPU the
  window is an eager loop.
- A difference that is not positive raises, where the reference floors
  it at a full scan's time over ``8 * rounds``.
- :func:`apply_roofline` raises on a reading above the bound
  (:class:`RooflineFault`), where the reference clamps it to the bound:
  an impossible number is a fault of the measurement, as in
  ``bench_torch.check_bound``.
"""

from __future__ import annotations

import statistics
import time

import torch


class RooflineFault(RuntimeError):
    pass


def device_specs(device: torch.device | str | None = None
                 ) -> tuple[float, float, float] | None:
    """(bytes/s, bf16 FLOP/s, int8 OP/s) of the card ``device`` names
    (default: the first CUDA device), or None on the CPU or on a card
    ``card.py`` does not know."""
    from ..card import peaks

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return peaks(torch.cuda.get_device_name(device))


def roofline_batch_seconds(
    *, bytes_read: float, mxu_ops: float, dtype: str = "bf16",
    device: torch.device | str | None = None,
) -> float | None:
    """The card's least seconds for one batch: the larger of the bytes
    over the memory rate and the operations over the tensor cores' rate
    for ``dtype`` ("bf16" or "int8"); None without a known card."""
    specs = device_specs(device)
    if specs is None:
        return None
    bw, bf16, int8 = specs
    rate = int8 if dtype == "int8" else bf16
    return max(bytes_read / bw, mxu_ops / rate)


def apply_roofline(row: dict, batch: int, floor_s: float | None) -> dict:
    """Add the bound's QPS to ``row``; raise when ``row['qps']`` is above
    it (no clamp).  No-op when the bound is unknown."""
    if floor_s is None or floor_s <= 0:
        return row
    cap = batch / floor_s
    row["roofline_qps"] = round(cap, 1)
    if row["qps"] > cap:
        raise RooflineFault(
            f"timing fault: {row['qps']:.1f} QPS is above the card's bound "
            f"{cap:.1f} QPS")
    return row


def _fill(bufs: torch.Tensor, d: int, gen: torch.Generator,
          normalize: bool) -> None:
    """Fresh N(0, 1) rows (normalised) into ``bufs[..., :d]`` in place;
    the padding columns stay zero."""
    fresh = torch.randn(bufs.shape[:-1] + (d,), generator=gen,
                        device=bufs.device)
    if normalize:
        fresh /= fresh.norm(dim=-1, keepdim=True) + 1e-9
    bufs[..., :d].copy_(fresh)


def _elapsed_ms(fn, device: torch.device) -> float:
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _capture(fn, device: torch.device):
    """``fn()`` in a CUDA graph after one warm-up run on a side stream
    (the kernel builds, the shared-memory opt-ins, the libraries'
    handles).  Returns ``(graph, its outputs)``."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    torch.cuda.synchronize(device)
    return graph, out


def timed_scan_qps(
    fn_q, *, batch: int, d: int, dim_pad: int, rounds: int = 48,
    reps: int = 3, seed: int = 7, normalize: bool = True,
    operands: tuple = (), device: torch.device | str | None = None,
) -> tuple[float, dict]:
    """Sustained per-batch throughput of ``fn_q(qb, *operands) -> idx
    [B, k]`` (see the module docstring).  ``device`` defaults to the
    first operand's.  Returns ``(qps, diagnostics)``."""
    if device is None:
        device = operands[0].device if operands else torch.device("cuda")
    device = torch.device(device)
    rounds = max(rounds, 2)
    half = max(rounds // 2, 1)
    qbufs = torch.zeros((rounds, batch, dim_pad), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def scan(r: int) -> list:
        return [fn_q(qbufs[i], *operands)[:, 0] for i in range(r)]

    if device.type == "cuda":
        _fill(qbufs, d, gen, normalize)
        graphs = {r: _capture(lambda r=r: scan(r), device)
                  for r in (half, rounds)}

        def run(r: int) -> float:
            return _elapsed_ms(graphs[r][0].replay, device)
    else:
        graphs = None

        def run(r: int) -> float:
            return _elapsed_ms(lambda: scan(r), device)

        run(half)  # warm-up
    samples, full_ms = [], []
    for _ in range(reps):
        times = {}
        for r in (half, rounds):
            _fill(qbufs[:r], d, gen, normalize)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times[r] = run(r)
        full_ms.append(times[rounds])
        samples.append((times[rounds] - times[half]) / (rounds - half))
    per_batch_ms = statistics.median(samples)
    if per_batch_ms <= 0:
        raise RooflineFault(f"timing fault: full - half differences "
                            f"{samples} ms per batch are not positive")
    if graphs is not None:
        want = scan(rounds)
        got = graphs[rounds][1]
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not torch.equal(g, w)]
        if bad:
            raise RooflineFault(f"the timed graph's outputs differ from an "
                                f"eager run in rounds {bad[:8]}")
    diag = {
        "per_batch_ms_samples": [round(s, 4) for s in samples],
        "rounds": rounds,
        "full_scan_s_median": round(statistics.median(full_ms) / 1e3, 4),
    }
    return batch / (per_batch_ms / 1e3), diag
