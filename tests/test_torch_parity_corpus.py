"""The parity corpus through the port's engine.

``tests/parity/fixtures``' runtime and combo buckets replayed in the
order and seeding of ``tests/parity/replay.py`` (runtime fixtures in
filename order against one engine; combo fixtures against the state
after runtime fixtures 001-004), through ``helix_tpu_torch``'s
``Engine(device="cpu")``, and held to the committed goldens
``tests/parity/expected/*.json`` with ``tests/test_parity.py``'s
``approx_equal`` (floats to rel 1e-6), one test per fixture.  Then the
reference's three-process HTTP replay (``tests/test_cross_sdk.py``'s
``test_three_server_processes_agree``) on the port's entry point,
``python -m helix_tpu_torch.server.http_server --device cpu``.
"""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from helix_tpu_torch.engine import Engine
from tests.parity.replay import SEED_PREFIXES, fixture_paths
from tests.test_cross_sdk import _replay_runtime, _wait_ready
from tests.test_parity import approx_equal

EXPECTED = Path(__file__).parent / "parity" / "expected"


@functools.cache
def replay(bucket: str) -> dict:
    engine = Engine(device="cpu")
    if bucket == "combo":
        for path in fixture_paths("runtime"):
            if path.name.startswith(SEED_PREFIXES):
                engine.execute(json.loads(path.read_text()))
    return {path.stem: engine.execute(json.loads(path.read_text()))
            for path in fixture_paths(bucket)}


@functools.cache
def expected(bucket: str) -> dict:
    return json.loads((EXPECTED / f"{bucket}.json").read_text())


CASES = [(bucket, path.stem) for bucket in ("runtime", "combo")
         for path in fixture_paths(bucket)]


def test_corpus_covers_every_golden():
    for bucket in ("runtime", "combo"):
        assert set(replay(bucket)) == set(expected(bucket))


@pytest.mark.parametrize("bucket,name", CASES,
                         ids=[f"{b}/{n}" for b, n in CASES])
def test_fixture_replays_equal_to_the_golden(bucket, name):
    got, want = replay(bucket)[name], expected(bucket)[name]
    assert approx_equal(got, want), (
        f"{name}:\nport:     {json.dumps(got, sort_keys=True)}\n"
        f"expected: {json.dumps(want, sort_keys=True)}")


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def test_three_server_processes_agree():
    """The runtime bucket over HTTP against three fresh processes of the
    port's entry point: the outputs agree with each other and with the
    golden."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    ports = _free_ports(3)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "helix_tpu_torch.server.http_server",
         "--port", str(p), "--host", "127.0.0.1", "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    ) for p in ports]
    try:
        for p in ports:
            _wait_ready(p)
        outputs = [_replay_runtime(p) for p in ports]
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.wait(timeout=30)
    assert outputs[0] == outputs[1] == outputs[2]
    golden = expected("runtime")
    assert set(outputs[0]) == set(golden)
    for name in golden:
        assert approx_equal(outputs[0][name], golden[name]), name
