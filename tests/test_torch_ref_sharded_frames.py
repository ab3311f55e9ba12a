"""The reference's ``tests/test_sharded_frames.py`` on the port
(``tests/ref_on_port.py``).

Patched: the JAX mesh ``Mesh(np.array(jax.devices()), ("shard",))`` is
the port's ``parallel.make_mesh(device="cpu")`` over the 8 virtual CPU
devices.
"""

from tests.ref_on_port import run_suite

run_suite(
    "sharded_frames", globals(),
    patches=[("    from jax.sharding import Mesh\n",
              "    from helix_tpu.parallel import make_mesh\n", 4),
             ('mesh = Mesh(np.array(jax.devices()), ("shard",))',
              "mesh = make_mesh()", 4)],
)
