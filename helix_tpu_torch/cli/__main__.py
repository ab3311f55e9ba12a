"""Port copy of ``helix_tpu/cli/__main__.py`` for ``helix_tpu_torch``:
``python -m helix_tpu_torch.cli``.

``tests/test_torch_engine_copy.py`` holds the code equal to the
reference's except for the functions listed here.

Differs from the reference in:
"""

from .main import main

if __name__ == "__main__":
    raise SystemExit(main())
