"""The repository's lint gate (``tools/lint.py``) over the port: the
package, the card scripts and the port's tests.  ``tools/lint.py``'s
default targets and ``check.sh`` name only the reference's sources."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT_TARGETS = ["helix_tpu_torch", "chip_smoke.py", "chip_ab.py",
                "bench_torch.py",
                *sorted(str(p.relative_to(REPO)) for p in
                        (REPO / "tests").glob("test_torch_*.py")),
                "tests/ref_on_port.py"]


def test_port_has_no_lint_findings():
    proc = subprocess.run(
        [sys.executable, "tools/lint.py", *PORT_TARGETS],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    report = proc.stdout + proc.stderr
    assert proc.returncode == 0, report[-4000:]
    assert report.strip().endswith(" 0 findings"), report[-2000:]
