"""HTTP serving shell for the helix-tpu engine.

Port copy of ``helix_tpu/server/__init__.py`` for ``helix_tpu_torch``.
``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from .http_server import HelixHTTPServer, serve  # noqa: F401
