"""What the harness loads: no ``jax``, ``jaxlib``, ``flax``,
``helix_tpu`` or ``benchmarks`` module by whole top-level name after a
run, and nothing of the program in the reference and the comparison."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hxbench import run, spec

ROOT = str(spec.ROOT)


def _python(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys\n"
        "from hxbench import spec, run\n"
        "from hxbench.tests.conftest import rehearse\n"
        "line = rehearse(spec.load_benchmark(), 'deep10m-cos.http1')\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': line['correct'], 'top': top,\n"
        "                  'bad': run.forbidden_modules()}))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["bad"] == []
    assert "helix_tpu_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "helix_tpu", "benchmarks"} \
        & set(out["top"])


def test_forbidden_is_a_whole_name_compare(monkeypatch):
    monkeypatch.setitem(sys.modules, "helix_tpu_torch_fake", object())
    assert "helix_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "helix_tpu.fake", object())
    assert run.forbidden_modules() == ["helix_tpu.fake"]


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        "import hxbench.reference, hxbench.check, hxbench.control\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not {"helix_tpu_torch", "helix_tpu", "jax", "benchmarks"} & top


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "hxbench.run", "--workload",
         "sift1m-l2.batch256", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_result_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(spec.ROOT / "hxbench", tmp_path / "hxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "hxbench.run", "--workload",
         "sift1m-l2.batch256", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
