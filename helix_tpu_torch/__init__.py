"""helix-tpu on PyTorch and CUDA: the port of :mod:`helix_tpu` to one
NVIDIA H100.

The package mirrors ``helix_tpu``'s layout.  It imports ``torch`` and
never ``jax``; the framework-free layers it shares with the reference
(wire, dsl, native, telemetry, fastjson) are imported from ``helix_tpu``
directly.  This slice serves exact vector search end to end:

- :mod:`helix_tpu_torch.engine` — the engine (``Engine(device=...)``),
  host modules copied from ``helix_tpu.engine``;
- :mod:`helix_tpu_torch.ops` — distance/top-k and the fused bucket-scores
  kernel wrapper;
- :mod:`helix_tpu_torch.kernels` — builds ``csrc/*.cu`` with ``nvcc``;
- :mod:`helix_tpu_torch.convert` — carries ``helix_tpu`` state across.
"""
