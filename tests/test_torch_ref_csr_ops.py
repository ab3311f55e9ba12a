"""The reference's ``tests/test_csr_ops.py`` on the port
(``tests/ref_on_port.py``).

Patched: ``jax.numpy`` is :data:`tests.ref_on_port.torch_numpy` (the
port's ops take torch tensors and int label codes).
"""

from tests.ref_on_port import run_suite

run_suite(
    "csr_ops", globals(),
    patches=[("    import jax.numpy as jnp\n",
              "    jnp = torch_numpy\n", 4)],
)
