"""The reference's ``tests/test_quant_device_rerank.py`` on the port
(``tests/ref_on_port.py``).

Patched: ``jax.numpy`` is :data:`tests.ref_on_port.torch_numpy` (the
port's ``device_rerank_topk`` takes torch tensors and an int).
"""

from tests.ref_on_port import run_suite

run_suite(
    "quant_device_rerank", globals(),
    patches=[("    import jax.numpy as jnp\n",
              "    jnp = torch_numpy\n", 2)],
)
