"""The kernel build's inputs (``helix_tpu_torch/kernels.py``): every file
under ``csrc/`` is a compiled source or a header the library hash covers,
and every header a source includes is one of them, so an edited header
always rebuilds."""

import re

from helix_tpu_torch import kernels

CSRC = kernels._HERE / "csrc"


def test_every_csrc_file_is_a_source_or_a_header():
    listed = {p.name for p in kernels.SOURCES + kernels.HEADERS}
    on_disk = {p.name for p in CSRC.iterdir() if p.is_file()}
    assert on_disk == listed
    assert all(p.suffix == ".cu" for p in kernels.SOURCES)
    assert all(p.suffix == ".cuh" for p in kernels.HEADERS)


def test_every_local_include_is_a_listed_header():
    headers = {p.name for p in kernels.HEADERS}
    included = set()
    for path in kernels.SOURCES + kernels.HEADERS:
        included |= set(re.findall(r'^#include "([^"]+)"',
                                   path.read_text(), re.M))
    assert included <= headers
    # each source includes the shared Hopper header
    for path in kernels.SOURCES:
        assert '#include "hopper.cuh"' in path.read_text()


def test_library_name_follows_every_header(tmp_path, monkeypatch):
    before = kernels.library_path()
    header = tmp_path / "hopper.cuh"
    header.write_text(kernels.HEADERS[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(kernels, "HEADERS", (header,))
    assert kernels.library_path() != before
