"""The reference's ``tests/test_device_traversal.py`` on the port (``tests/ref_on_port.py``)."""

from tests.ref_on_port import run_suite

run_suite("device_traversal", globals())
