"""The helix-tpu database engine on PyTorch: storage, indexes, and the
interpreter (port of :mod:`helix_tpu.engine`)."""

from .engine import Engine  # noqa: F401
from .errors import EngineError, ParamError, QueryError, WriteError  # noqa: F401
