"""helix-tpu on PyTorch and CUDA: the port of :mod:`helix_tpu` to one
NVIDIA H100.

The package mirrors ``helix_tpu``'s layout.  It imports ``torch`` and
never ``jax``, and nothing of ``helix_tpu``: it carries its own copies
of the framework-free layers (:mod:`~helix_tpu_torch.wire`,
:mod:`~helix_tpu_torch.dsl`, :mod:`~helix_tpu_torch.native` with the C++
sources it calls, :mod:`~helix_tpu_torch.telemetry`,
:mod:`~helix_tpu_torch.fastjson`, :mod:`~helix_tpu_torch.client`), which
``tests/test_torch_engine_copy.py`` holds equal to the reference's.  It
serves every single-device path of the engine, persists to disk, and
answers HTTP (``python -m helix_tpu_torch.server.http_server``):

- :mod:`helix_tpu_torch.server` — the HTTP front door (the native
  gateway, the Python fallback server, MCP), copied from
  ``helix_tpu.server``;
- :mod:`helix_tpu_torch.client` — the HTTP client SDK;
- :mod:`helix_tpu_torch.engine` — the engine (``Engine(device=...)``),
  host modules copied from ``helix_tpu.engine``;
- :mod:`helix_tpu_torch.ops` — distance/top-k, the int8 and int4 rungs,
  and the wrappers of the three bucket-scores kernels;
- :mod:`helix_tpu_torch.kernels` — builds ``csrc/*.cu`` with ``nvcc``;
- :mod:`helix_tpu_torch.convert` — carries ``helix_tpu`` state across
  (given as numpy arrays and plain objects; it imports nothing of
  ``helix_tpu`` either).
"""

__version__ = "0.1.0"

from . import wire  # noqa: F401
from .dsl import (  # noqa: F401
    g, sub, read_batch, write_batch, define_params, define_queries, param,
    register_read, register_write,
    Predicate, SourcePredicate, Expr, PropertyValue, NodeRef, EdgeRef,
    StreamBound, Projection, BindingProjection, BindingRef, BindingTarget,
    IndexSpec, RepeatConfig, BatchCondition, DynamicQueryRequest,
    Order, EmitBehavior, AggregateFunction, CompareOp, DateTime,
    i64, f32, f64, bytes_,
)
