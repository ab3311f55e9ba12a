"""helix-tpu command-line interface.

Port copy of ``helix_tpu/cli/__init__.py`` for ``helix_tpu_torch``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from .main import main  # noqa: F401
