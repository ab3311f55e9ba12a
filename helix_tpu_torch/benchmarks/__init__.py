"""Ports of the reference's ``benchmarks/`` scripts: the kernel sweeps
``onepass_sweep`` (kernel 4) and ``i8_sweep`` (kernel 5), the residency
ladder ``ladder`` (behind ``bench_torch.py --ladder``) with
``build_ladder_baseline``, ``quant_demo`` and ``beyond_hbm_demo``, and
``roofline``'s bound and timer.  Each module's docstring lists how it
differs from its counterpart under ``benchmarks/``."""
