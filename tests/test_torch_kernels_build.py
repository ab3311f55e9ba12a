"""The kernel build's inputs (``helix_tpu_torch/kernels.py``): every file
under ``csrc/`` is a compiled source or a header the library hash covers,
and every header a source includes is one of them, so an edited header
always rebuilds.  The kernel sweeps build into a library of their own:
each ``.cu`` file is a source of exactly one library, and the serving
library's name does not follow the sweep sources."""

import re

from helix_tpu_torch import kernels

CSRC = kernels._HERE / "csrc"


SOURCES = kernels.SOURCES + kernels.SWEEP_SOURCES
HEADERS = kernels.HEADERS + kernels.SWEEP_HEADERS


def test_every_csrc_file_is_a_source_or_a_header():
    listed = {p.name for p in SOURCES + HEADERS}
    on_disk = {p.name for p in CSRC.iterdir() if p.is_file()}
    assert on_disk == listed
    assert all(p.suffix == ".cu" for p in SOURCES)
    assert all(p.suffix == ".cuh" for p in HEADERS)


def test_every_local_include_is_a_listed_header():
    headers = {p.name for p in HEADERS}
    included = set()
    for path in SOURCES + HEADERS:
        included |= set(re.findall(r'^#include "([^"]+)"',
                                   path.read_text(), re.M))
    assert included <= headers
    # each source includes the shared Hopper header
    for path in SOURCES:
        assert '#include "hopper.cuh"' in path.read_text()


def test_every_source_belongs_to_exactly_one_library():
    serving = {p.name for p in kernels.SOURCES}
    sweep = {p.name for p in kernels.SWEEP_SOURCES}
    assert serving and sweep and not serving & sweep
    assert len(serving) == len(kernels.SOURCES)
    assert len(sweep) == len(kernels.SWEEP_SOURCES)
    # the sweep-only header is no serving source's
    for path in kernels.SOURCES:
        assert "sweep.cuh" not in path.read_text()
    for path in kernels.SWEEP_SOURCES:
        assert '#include "sweep.cuh"' in path.read_text()


def test_serving_library_does_not_follow_the_sweep_sources(tmp_path,
                                                           monkeypatch):
    serving, sweep = kernels.library_path(), kernels.sweep_library_path()
    assert serving.name.startswith("libhxcuda-")
    assert sweep.name.startswith("libhxsweep-")
    edited = tmp_path / kernels.SWEEP_SOURCES[0].name
    edited.write_text(kernels.SWEEP_SOURCES[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(kernels, "SWEEP_SOURCES",
                        (edited,) + kernels.SWEEP_SOURCES[1:])
    assert kernels.library_path() == serving
    assert kernels.sweep_library_path() != sweep
    header = tmp_path / "sweep.cuh"
    header.write_text(kernels.SWEEP_HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(kernels, "SWEEP_HEADERS", (header,))
    assert kernels.library_path() == serving


def test_every_sweep_entry_is_defined_once():
    defined = []
    for path in kernels.SWEEP_SOURCES:
        defined += re.findall(r"^HX_SWEEP_ENTRY\(\s*(\w+),",
                              path.read_text(), re.M)
    assert sorted(defined) == sorted(kernels.SWEEP_ENTRIES)


def test_library_name_follows_every_header(tmp_path, monkeypatch):
    before = kernels.library_path()
    before_sweep = kernels.sweep_library_path()
    header = tmp_path / "hopper.cuh"
    header.write_text(kernels.HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(kernels, "HEADERS", (header,))
    assert kernels.library_path() != before
    assert kernels.sweep_library_path() != before_sweep
