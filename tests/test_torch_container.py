"""The port's container image (``Dockerfile.torch``), the counterpart of
``tests/test_container.py``'s checks of the reference's ``Dockerfile``.

Static tier (always runs): the COPY sources exist; the base is a public
CUDA development image (``nvcc`` for the kernels); no RUN line installs
JAX; the lint gate runs over ``helix_tpu_torch``; the ENTRYPOINT parses
against the port's server argparse surface with its default device,
``cuda``, and with ``--metric l2`` appended; the exposed port matches the
entry point's.  Build-and-run tier: only where docker or podman is on
PATH (decided inside the test; this image ships neither), the image is
built and run with ``--device cpu`` appended and must answer the
reference's readiness probe.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import time
import urllib.request
import uuid
from pathlib import Path

import pytest

from helix_tpu_torch.server.http_server import build_arg_parser

from tests.test_container import READINESS_BATCH

REPO = Path(__file__).resolve().parents[1]
DOCKERFILE = REPO / "Dockerfile.torch"


def instructions(name: str) -> list[str]:
    """The Dockerfile's ``name`` instructions, continuation lines joined."""
    text = DOCKERFILE.read_text().replace("\\\n", " ")
    return [line[len(name) + 1:].strip() for line in text.splitlines()
            if line.startswith(name + " ")]


def entrypoint() -> list[str]:
    (argv,) = instructions("ENTRYPOINT")
    return json.loads(argv)


def test_copy_sources_exist():
    copies = instructions("COPY")
    assert copies
    sources = [src for line in copies for src in line.split()[:-1]]
    for src in sources:
        assert (REPO / src).exists(), f"COPY source missing: {src}"
    assert {"helix_tpu_torch", "tools", "pyproject.toml",
            "README.md"} <= set(sources)
    assert "helix_tpu" not in sources


def test_base_has_nvcc_and_no_jax_is_installed():
    (base,) = instructions("FROM")
    assert re.fullmatch(r"nvidia/cuda:[\d.]+-devel-ubuntu[\d.]+", base), base
    runs = " ".join(instructions("RUN")).lower()
    assert "torch" in runs and "g++" in runs
    assert "jax" not in runs
    assert "python tools/lint.py helix_tpu_torch" in runs


def test_entrypoint_parses_against_the_port_server():
    argv = entrypoint()
    assert argv[:3] == ["python", "-m", "helix_tpu_torch.server.http_server"]
    parser = build_arg_parser()
    args = parser.parse_args(argv[3:])
    assert args.device == "cuda" and args.metric == "cosine"
    l2 = parser.parse_args(argv[3:] + ["--metric", "l2"])
    assert l2.metric == "l2" and l2.device == "cuda"
    (exposed,) = instructions("EXPOSE")
    assert int(exposed) == args.port


def test_container_build_run_readiness():
    runtime = shutil.which("docker") or shutil.which("podman")
    if runtime is None:
        pytest.skip("no container runtime (docker/podman) on this machine")
    tag = f"helix-tpu-torch-test-{uuid.uuid4().hex[:8]}"
    build = subprocess.run(
        [runtime, "build", "-f", str(DOCKERFILE), "-t", tag, str(REPO)],
        capture_output=True, timeout=3600,
    )
    assert build.returncode == 0, build.stderr.decode()[-2000:]
    run = subprocess.run(
        [runtime, "run", "-d", "-p", "16990:8080", tag, "--device", "cpu"],
        capture_output=True, timeout=120,
    )
    container = run.stdout.decode().strip()
    try:
        assert run.returncode == 0, run.stderr.decode()[-2000:]
        body = json.dumps(READINESS_BATCH).encode()
        deadline = time.time() + 120
        last: Exception | None = None
        while time.time() < deadline:
            try:
                resp = urllib.request.urlopen(urllib.request.Request(
                    "http://127.0.0.1:16990/v1/query", data=body,
                    headers={"Content-Type": "application/json"},
                ), timeout=2)
                assert json.loads(resp.read())["ready"] == 0
                return
            except (OSError, ValueError) as exc:  # not up yet
                last = exc
                time.sleep(0.25)
        raise AssertionError(f"container never became ready: {last}")
    finally:
        if container:
            subprocess.run([runtime, "rm", "-f", container],
                           capture_output=True, timeout=60)
        subprocess.run([runtime, "rmi", "-f", tag],
                       capture_output=True, timeout=60)
