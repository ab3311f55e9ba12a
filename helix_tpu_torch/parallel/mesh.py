"""Device meshes for the port's mesh paths: the counterpart of
``jax.devices()`` and of ``helix_tpu/parallel/sharded.py:make_mesh``.

The reference is single-controller: one process drives every device
through ``shard_map``.  The port keeps that design without
``torch.distributed``: one process drives a list of ``torch.device``\\ s.

- Each shard's tensors live on the shard's device, and the per-shard
  work is launched on that device.
- An ``all_gather`` becomes a shard-major concatenation on the merge
  device (the engine's device, :attr:`Mesh.device`); a ``psum`` becomes
  a sum there, copied back to each shard's device where a next step
  needs it.  Outputs move with ``non_blocking=True`` and the host reads
  after one synchronisation, so distinct devices need no other branch.

By default the devices of a type are the visible ones: every CUDA device
``torch.cuda.device_count()`` reports, or the one CPU.  :func:`virtual_devices`
sets a mesh whose devices may repeat one device, the counterpart of the
reference's ``--xla_force_host_platform_device_count``; tests and
``chip_smoke.py`` use it, and no environment variable turns it on.  It is
process-wide, as the XLA flag is, and read per call, as the reference
reads ``jax.devices()`` per call.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..ops.distance import _top_k

_LOCK = threading.Lock()
# device type -> the devices a virtual mesh holds; replaced whole under
# the lock, read without it (one dict lookup).
_VIRTUAL: dict[str, tuple[torch.device, ...]] = {}


def _visible(device_type: str) -> tuple[torch.device, ...]:
    if device_type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device(device_type),)


def devices(device_type: str) -> tuple[torch.device, ...]:
    """The devices a mesh of ``device_type`` spans: the virtual mesh's
    when one is set, else the visible ones."""
    virtual = _VIRTUAL.get(device_type)
    return virtual if virtual is not None else _visible(device_type)


def device_count(device: torch.device | str) -> int:
    """Devices of ``device``'s type a mesh would span (the engine's
    ``len(jax.devices())``)."""
    return len(devices(torch.device(device).type))


@contextmanager
def virtual_devices(device_type: str, n: int):
    """Within the block, meshes of ``device_type`` hold ``n`` devices laid
    round-robin over the visible ones: 4 on one card is ``cuda:0`` four
    times; 1 on a machine of four cards is ``cuda:0`` alone.  For tests
    and ``chip_smoke.py`` only (the counterpart of
    ``--xla_force_host_platform_device_count``).  Nests; the previous
    setting comes back on exit."""
    real = _visible(device_type)
    if not real:
        raise RuntimeError(f"no {device_type} device for a virtual mesh")
    if n < 1:
        raise ValueError(f"a virtual mesh needs at least one device, got {n}")
    mesh_devices = tuple(real[i % len(real)] for i in range(n))
    with _LOCK:
        before = _VIRTUAL.get(device_type)
        _VIRTUAL[device_type] = mesh_devices
    try:
        yield mesh_devices
    finally:
        with _LOCK:
            if before is None:
                _VIRTUAL.pop(device_type, None)
            else:
                _VIRTUAL[device_type] = before


class Mesh:
    """A ``[data, shard]`` grid of devices and the merge device.

    ``shape`` is ``{"data": .., "shard": ..}`` as the reference's
    ``Mesh.shape`` reads.  Searchers that replicate their work over the
    ``data`` axis in the reference (all but ``ShardedVectorSearch``, whose
    queries are data-parallel) compute on the first row's devices only:
    every row would compute the same answer."""

    def __init__(self, grid: tuple[tuple[torch.device, ...], ...],
                 device: torch.device):
        self.devices = grid
        self.device = device
        self.shape = {"data": len(grid), "shard": len(grid[0])}

    @property
    def shard_devices(self) -> tuple[torch.device, ...]:
        return self.devices[0]


def make_mesh(n_devices: int | None = None, data: int = 1, *,
              device: torch.device | str) -> Mesh:
    """Build a (data, shard) mesh over the devices of ``device``'s type
    (a CPU engine never shards onto CUDA, nor a CUDA engine onto the
    CPU); ``device`` is the merge device."""
    device = torch.device(device)
    devs = devices(device.type)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n % data != 0:
        raise ValueError(f"cannot split {n} devices into data={data}")
    per = n // data
    grid = tuple(tuple(devs[r * per:(r + 1) * per]) for r in range(data))
    return Mesh(grid, device)


def shard_rows(host: np.ndarray, n_shard: int,
               shard_devices: tuple[torch.device, ...]) -> list[torch.Tensor]:
    """Split ``host`` (rows a multiple of ``n_shard``) into ``n_shard``
    row blocks, block ``s`` copied to ``shard_devices[s]`` (a copy on the
    CPU too: the host array may change after the upload)."""
    rows = len(host) // n_shard
    return [torch.from_numpy(np.ascontiguousarray(
        host[s * rows:(s + 1) * rows])).to(dev, copy=True)
        for s, dev in enumerate(shard_devices)]


def merge_topk(device: torch.device, scores: list[torch.Tensor],
               ids: list[torch.Tensor], k: int):
    """The reference's ``all_gather`` + ``top_k``: each shard's
    candidates (scores and global ids along the last axis) move to
    ``device`` and concatenate shard-major, so among equal scores the
    earlier shard, the lower global id, wins; then the top
    ``min(k, width)``.  Returns ``(scores, ids)``, descending."""
    flat_s = torch.cat([s.to(device, non_blocking=True) for s in scores],
                       dim=-1)
    flat_i = torch.cat([i.to(device, non_blocking=True) for i in ids],
                       dim=-1)
    top_s, pos = _top_k(flat_s, min(k, flat_s.shape[-1]))
    return top_s, torch.gather(flat_i, -1, pos)
