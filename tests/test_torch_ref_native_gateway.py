"""The reference's ``tests/test_native_gateway.py`` on the port (``tests/ref_on_port.py``)."""

from tests.ref_on_port import run_suite

run_suite("native_gateway", globals())
