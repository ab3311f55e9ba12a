"""The reference's ``tests/test_crash_torture.py`` on the port
(``tests/ref_on_port.py``).

Patched: the server each test spawns and SIGKILLs is the port's
``helix_tpu_torch.server.http_server.serve`` on ``device='cpu'`` (the
reference builds it from a code string, which the import rewrite does
not reach).
"""

from tests.ref_on_port import run_suite

run_suite(
    "crash_torture", globals(),
    patches=[('"from helix_tpu.server.http_server import serve;"',
              '"from helix_tpu_torch.server.http_server import serve;"'),
             ("data_dir={data_dir!r})", "data_dir={data_dir!r}, "
              "device='cpu')")],
)
