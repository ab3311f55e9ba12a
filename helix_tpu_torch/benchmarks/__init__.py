"""Ports of the reference's ``benchmarks/`` scripts: the kernel sweeps
``onepass_sweep`` (kernel 4) and ``i8_sweep`` (kernel 5), the residency
ladder ``ladder`` (behind ``bench_torch.py --ladder``) with
``build_ladder_baseline``, ``quant_demo`` and ``beyond_hbm_demo``, the
exact rung's coarse-phase sweep ``exact_sweep``, kernel 1's ring-depth
sweep ``tile_sweep`` (the reference's VMEM tile sweep), the device
2-hop's decomposition ``traversal_decomp``, the serving soak ``soak``,
and ``roofline``'s bound and timer.  Each module's docstring lists how it
differs from its counterpart under ``benchmarks/``."""
