"""helix-tpu on PyTorch and CUDA: the port of :mod:`helix_tpu` to one
NVIDIA H100.

The package mirrors ``helix_tpu``'s layout.  It imports ``torch`` and
never ``jax``, and nothing of ``helix_tpu``: it carries its own copies
of the framework-free layers (:mod:`~helix_tpu_torch.wire`, the part of
:mod:`~helix_tpu_torch.dsl` the engine uses,
:mod:`~helix_tpu_torch.native` with the C++ sources it calls,
:mod:`~helix_tpu_torch.telemetry`, :mod:`~helix_tpu_torch.fastjson`),
which ``tests/test_torch_engine_copy.py`` holds equal to the
reference's.  It serves vector search end to end on one device: the exact
tier and, under a device-memory budget, the int8, int4 and host-exact
rungs of the residency ladder:

- :mod:`helix_tpu_torch.engine` — the engine (``Engine(device=...)``),
  host modules copied from ``helix_tpu.engine``;
- :mod:`helix_tpu_torch.ops` — distance/top-k, the int8 and int4 rungs,
  and the wrappers of the three bucket-scores kernels;
- :mod:`helix_tpu_torch.kernels` — builds ``csrc/*.cu`` with ``nvcc``;
- :mod:`helix_tpu_torch.convert` — carries ``helix_tpu`` state across
  (given as numpy arrays and plain objects; it imports nothing of
  ``helix_tpu`` either).
"""
