"""The card a run measures on: its name and power limit, and its peak
rates, from which a measurement's bound (the least time the card could
take for the same work) follows.

``chip_smoke.py`` and ``bench_torch.py`` both read the rates here.  They
are NVIDIA's data-sheet peaks of the H100 SXM part (dense, no sparsity),
which assume its full 700 W power limit; :func:`card_line` gives the
limit the card is set to, and every number is kept beside it.
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_PER_S = 989e12
PEAK_INT8_PER_S = 1979e12

# torch.cuda.get_device_name substring -> (bytes/s, bf16 FLOP/s, int8 OP/s)
KNOWN_CARDS = {
    "H100 80GB HBM3": (PEAK_BYTES_PER_S, PEAK_BF16_PER_S, PEAK_INT8_PER_S),
}


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(device_name: str) -> tuple[float, float, float] | None:
    """(bytes/s, bf16 FLOP/s, int8 OP/s) of a card by its name, or None
    for a card this table does not know (then no bound is reported)."""
    for sub, rates in KNOWN_CARDS.items():
        if sub in device_name:
            return rates
    return None


def bound(n_bytes: float, ops: float, peak_ops: float,
          peak_bytes: float = PEAK_BYTES_PER_S) -> tuple[float, str]:
    """The bound in ms: the larger of the bytes over the memory rate and
    the operations over ``peak_ops``, and which of the two it is."""
    t_bytes = n_bytes / peak_bytes * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
