"""The reference's ``tests/test_malformed.py`` on the port (``tests/ref_on_port.py``)."""

from tests.ref_on_port import run_suite

run_suite("malformed", globals())
