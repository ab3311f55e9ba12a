"""The reference's ``tests/test_dyn_fast_path.py`` on the port (``tests/ref_on_port.py``)."""

from tests.ref_on_port import run_suite

run_suite("dyn_fast_path", globals())
