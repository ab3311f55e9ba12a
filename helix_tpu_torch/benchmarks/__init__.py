"""Ports of the reference's ``benchmarks/`` scripts that run a kernel of
their own: the kernel sweeps ``onepass_sweep`` (kernel 4) and
``i8_sweep`` (kernel 5), with what they import from ``ladder`` and
``roofline``.  Each module's docstring lists how it differs from its
counterpart under ``benchmarks/``."""
