"""The reference's ``tests/test_quant4_gate.py`` on the port
(``tests/ref_on_port.py``).

Patched: the ``single_device`` fixture also pins the port's mesh to one
device (``one_port_device``), as it pins ``jax.devices``.
"""

from tests.ref_on_port import run_suite

run_suite(
    "quant4_gate", globals(),
    patches=[('monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev])',
              'monkeypatch.setattr(jax, "devices", lambda *a, **kw: [dev]); '
              'one_port_device(monkeypatch)')],
)
