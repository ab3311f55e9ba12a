"""The parity corpus through the port's engine.

``tests/parity/fixtures``' runtime and combo buckets replayed in the
order and seeding of ``tests/parity/replay.py`` (runtime fixtures in
filename order against one engine; combo fixtures against the state
after runtime fixtures 001-004), through ``helix_tpu_torch``'s
``Engine(device="cpu")``, and held to the committed goldens
``tests/parity/expected/*.json`` with ``tests/test_parity.py``'s
``approx_equal`` (floats to rel 1e-6), one test per fixture.
"""

import functools
import json
from pathlib import Path

import pytest

from helix_tpu_torch.engine import Engine
from tests.parity.replay import SEED_PREFIXES, fixture_paths
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
