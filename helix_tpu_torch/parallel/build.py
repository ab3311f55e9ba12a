"""Sharded index construction: data-parallel k-means over the mesh
(PyTorch port of ``helix_tpu/parallel/build.py``).

Data rows are partitioned across the ``shard`` axis; each shard assigns
its rows to the centroids on its own device and accumulates local sums
and counts (``index_add_``, the reference's ``segment_sum``); the
partial statistics sum on the merge device (the reference's ``psum``),
which yields the next centroid set, copied back to each shard for the
next step.

Deliberate differences from the reference: ``bf16`` defaults to true on
a CUDA mesh where the reference says ``jax.default_backend() == "tpu"``;
the sums across shards run in shard order on the merge device, so the
centroids agree with the reference's to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import require_fp32_matmul
from .mesh import Mesh, shard_rows


class ShardedKMeans:
    """Sharded k-means step over a fixed mesh."""

    def __init__(self, mesh: Mesh, n_clusters: int, bf16: bool | None = None):
        self.mesh = mesh
        self.n_clusters = n_clusters
        self.bf16 = bf16 if bf16 is not None else mesh.device.type == "cuda"

    def _step(self, xs, valid, centroids: torch.Tensor) -> torch.Tensor:
        """One update: ``xs``/``valid`` per shard, ``centroids [C, D]`` on
        the merge device; returns the next centroids there."""
        merge = self.mesh.device
        n_clusters = self.n_clusters
        sums = torch.zeros(centroids.shape, dtype=torch.float32, device=merge)
        counts = torch.zeros((n_clusters, 1), dtype=torch.float32,
                             device=merge)
        for data, ok in zip(xs, valid):
            c = centroids.to(data.device)
            if self.bf16:
                sims = data.to(torch.bfloat16).float() \
                    @ c.to(torch.bfloat16).float().T
            else:
                require_fp32_matmul()
                sims = data @ c.T
            assign = torch.argmax(sims, dim=1)
            weights = ok.float()[:, None]
            local_sums = torch.zeros((n_clusters, data.shape[1]),
                                     dtype=torch.float32, device=data.device)
            local_sums.index_add_(0, assign, data * weights)
            local_counts = torch.zeros((n_clusters, 1), dtype=torch.float32,
                                       device=data.device)
            local_counts.index_add_(0, assign, weights)
            sums += local_sums.to(merge, non_blocking=True)
            counts += local_counts.to(merge, non_blocking=True)
        fresh = sums / torch.clamp(counts, min=1.0)
        fresh = torch.where(counts > 0, fresh, centroids)
        norms = torch.linalg.norm(fresh, dim=1, keepdim=True)
        return fresh / torch.clamp(norms, min=1e-9)

    def shard_arrays(self, data: np.ndarray):
        """Pad to whole 8-row blocks per shard and put each shard's rows
        and valid flags on its device."""
        n_shard = self.mesh.shape["shard"]
        n, d = data.shape
        rows = -(-n // n_shard)
        rows = ((rows + 7) // 8) * 8
        total = rows * n_shard
        padded = np.zeros((total, d), np.float32)
        padded[:n] = data
        valid = np.zeros(total, bool)
        valid[:n] = True
        devs = self.mesh.shard_devices
        return shard_rows(padded, n_shard, devs), \
            shard_rows(valid, n_shard, devs)

    def fit(
        self, data: np.ndarray, iters: int = 8, seed: int = 0
    ) -> np.ndarray:
        data = np.asarray(data, np.float32)
        norms = np.linalg.norm(data, axis=1, keepdims=True)
        data = data / np.maximum(norms, 1e-9)
        rng = np.random.default_rng(seed)
        centroids = torch.from_numpy(
            data[rng.choice(len(data), self.n_clusters, replace=False)]
        ).to(self.mesh.device)
        xs, valid = self.shard_arrays(data)
        for _ in range(iters):
            centroids = self._step(xs, valid, centroids)
        return centroids.cpu().numpy()
