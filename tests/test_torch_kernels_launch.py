"""The port's one launch path for its hand kernels
(``helix_tpu_torch/kernels.py``): ``launch`` calls a C entry with the
device's current stream, counts a launch or a captured node by the code
the entry returns and raises on any other code; ``check_operands`` holds
a kernel's operands to one CUDA device, their dtypes, contiguity and
16-byte alignment, one operand at a time.  On the sources' side: every
C launch entry reports a capturing stream through the one helper of
``csrc/hopper.cuh``, and no Python module calls a launch entry but
``launch``.  All on the CPU, with the stream lookup stubbed."""

import ast
import re
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from helix_tpu_torch import kernels

CSRC = kernels._HERE / "csrc"
REPO = kernels._HERE.parent


@pytest.fixture
def devices(monkeypatch):
    """Device 0 current, device ``i``'s raw stream ``1000 + i``; returns
    the devices entered, in order."""
    entered = []

    @contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    monkeypatch.setattr(torch.cuda, "device", device)
    return entered


def fake_entry(rc: int, calls: list):
    def hx_fake_scores(*args):
        calls.append(args)
        return rc
    return hx_fake_scores


@pytest.mark.parametrize("rc, counts, error", [
    (0, (1, 0), None),
    (kernels.CAPTURED, (0, 1), None),
    (-3, (0, 0), r"hx_fake_scores kernel launch failed: code -3 .*"
                 r"-3: shape refused"),
    (700, (0, 0), r"hx_fake_scores kernel launch failed: code 700 "
                  r"\(a CUDA error"),
], ids=["launched", "captured", "shape-refused", "cuda-error"])
def test_launch_counts_or_raises_by_the_entrys_code(devices, rc, counts,
                                                     error):
    wrapper = SimpleNamespace(launches=0, captured=0)
    calls = []
    entry = fake_entry(rc, calls)
    if error is None:
        assert kernels.launch(wrapper, entry, 0, 11, 22) is \
            (rc == kernels.CAPTURED)
    else:
        with pytest.raises(RuntimeError, match=error):
            kernels.launch(wrapper, entry, 0, 11, 22)
    assert calls == [(11, 22, 1000)]  # the arguments, then the stream
    assert (wrapper.launches, wrapper.captured) == counts
    assert devices == []


@pytest.mark.parametrize("device, entered", [(0, []), (1, [1])])
def test_launch_enters_the_device_only_where_it_is_not_current(
        devices, device, entered):
    wrapper = SimpleNamespace(launches=0, captured=0)
    calls = []
    assert kernels.launch(wrapper, fake_entry(0, calls), device, 5) is False
    assert calls == [(5, 1000 + device)]
    assert devices == entered
    assert (wrapper.launches, wrapper.captured) == (1, 0)


def operand(dtype=torch.bfloat16, device="cuda:0", contiguous=True,
            ptr=4096):
    """What check_operands reads of a tensor, without a card."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           is_contiguous=lambda: contiguous,
                           data_ptr=lambda: ptr)


@pytest.mark.parametrize("xs, qs, error, match", [
    (operand(), operand(), None, None),
    (operand(device="cpu"), operand(), ValueError,
     "k needs every operand on one CUDA device, got xs on cpu"),
    (operand(), operand(device="cuda:1"), ValueError,
     "k needs every operand on one CUDA device, got qs on cuda:1"),
    (operand(), operand(dtype=torch.float32), TypeError,
     "k: qs must be torch.bfloat16, got torch.float32"),
    (operand(contiguous=False), operand(), ValueError,
     "k: xs must be contiguous"),
    (operand(), operand(ptr=4104), ValueError,
     "k: qs must be 16-byte aligned"),
    # one operand at a time: xs's fault before qs's
    (operand(ptr=4104), operand(device="cpu"), ValueError,
     "k: xs must be 16-byte aligned"),
], ids=["taken", "cpu", "two-devices", "dtype", "strided", "unaligned",
        "in-operand-order"])
def test_check_operands(xs, qs, error, match):
    ops = {"xs": xs, "qs": qs}
    want = {"xs": torch.bfloat16, "qs": torch.bfloat16}
    if error is None:
        kernels.check_operands("k", ops, want)
    else:
        with pytest.raises(error, match=match):
            kernels.check_operands("k", ops, want)


# ----------------------------------------------------------------- sources


def launch_entries() -> set[str]:
    """The C launch entries of both libraries (every ``hx_*`` entry but
    the ``*_plan`` ones)."""
    names = set(kernels.SWEEP_ENTRIES)
    for path in kernels.SOURCES:
        names |= set(re.findall(r'extern "C" int (hx_\w+)\(',
                                path.read_text()))
    return {n for n in names if not n.endswith("_plan")}


def test_captured_code_is_the_headers():
    header = (CSRC / "hopper.cuh").read_text()
    value = re.search(r"constexpr int HX_CAPTURED = ([^;]+);", header)
    assert value and eval(value.group(1)) == kernels.CAPTURED
    for path in kernels.SOURCES + kernels.SWEEP_SOURCES + \
            kernels.SWEEP_HEADERS:
        text = path.read_text()
        assert "constexpr int HX_CAPTURED" not in text, path.name
        assert "cudaStreamIsCapturing" not in text, path.name


@pytest.mark.parametrize("name", [
    "bucket_scores.cu", "i8_bucket_scores.cu", "i4_bucket_scores.cu",
    "l2_scores.cu", "select_topk.cu", "sweep.cuh",
])
def test_every_launch_reports_capture_through_the_helper(name):
    """Each launch entry's result passes through ``hx::launched``; in the
    sources with one kernel per entry, the launch's error code reaches
    the entry through it alone."""
    text = (CSRC / name).read_text()
    assert re.search(r"\blaunched\(", text)
    if name != "select_topk.cu":
        assert text.count("cudaGetLastError()") == text.count(
            "launched(stream, static_cast<int>(cudaGetLastError()))")


def python_sources() -> list[Path]:
    return sorted(kernels._HERE.rglob("*.py")) + [
        REPO / name for name in ("bench_torch.py", "chip_smoke.py",
                                 "chip_ab.py") if (REPO / name).exists()]


def test_no_module_calls_a_launch_entry_but_launch():
    entries = launch_entries()
    assert {"hx_bucket_scores", "hx_i8_bucket_scores", "hx_i4_bucket_scores",
            "hx_select_topk", "hx_l2_scores", "hx_sweep_onepass"} <= entries
    calls = []
    for path in python_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr in entries:
                calls.append(f"{path.name}:{node.lineno}")
            # a sweep entry looked up by name and called
            if (isinstance(func, ast.Call)
                    and isinstance(func.func, ast.Name)
                    and func.func.id == "getattr"
                    and "load_sweep" in ast.unparse(func.args[0])):
                calls.append(f"{path.name}:{node.lineno}")
    assert calls == []
