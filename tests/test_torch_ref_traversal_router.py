"""The reference's ``tests/test_traversal_router.py`` on the port (``tests/ref_on_port.py``)."""

from tests.ref_on_port import run_suite

run_suite("traversal_router", globals())
