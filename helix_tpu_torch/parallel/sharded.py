"""Sharded vector search over a device mesh (PyTorch port of
``helix_tpu/parallel/sharded.py``).

The packed vector matrix is sharded row-wise across the mesh's ``shard``
axis; each shard runs the exact search over its rows on its own device,
and the per-shard top-k candidates merge into the global top-k on the
merge device (the reference's ``all_gather``: a shard-major
concatenation, then one top-k).  Queries may also be data-parallel over
the ``data`` axis.

On a CUDA mesh with cosine rows each shard runs kernel 1
(``csrc/bucket_scores.cu``, through ``ops/fused_topk.bucket_scores``) in
:func:`_local_fused`: one launch per shard per block of at most 256
queries.  Otherwise each shard runs :func:`_local_topk`, a chunked scan
with a running top-k (torch ops; the reference's is XLA outside any
kernel).

Deliberate differences from the reference:

- ``bf16`` and ``use_fused`` default to true on a CUDA mesh (``use_fused``
  for cosine only), where the reference says ``jax.default_backend() ==
  "tpu"``.
- ``approx_max_k`` becomes an exact top-k (``ops/distance._top_k``:
  ties go to the lower position, as in ``lax.top_k``; the selection
  kernel on the card); on the CPU the reference's ``approx_max_k`` is
  exact too.
- The fused path splits a batch into blocks of at most 256 queries
  (kernel 1 takes B of 128 or 256), where the reference pads the whole
  batch to a multiple of 128; per query the answer is the same.  A shard
  shape kernel 1 refuses (``bucket_kernel_refusal``: D not a multiple of
  64) takes :func:`_local_topk`.
- The bf16 copy of each shard's rows is made once, in
  :meth:`ShardedVectorSearch.shard_arrays`, not per call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import chunked_topk, pick_chunk
from ..ops.fused_topk import TILE, bucket_kernel_refusal, fused_candidates
from .mesh import Mesh, merge_topk, shard_rows


def _local_topk(xs, qs, n_valid, sq_norms, k, chunk, metric):
    """Per-shard chunked scan + running top-k (the scan of
    ``ops/distance.chunked_topk``); k is cut to the scanned chunk, and
    the caller pads the merged result back out to the requested k."""
    n = xs.shape[0]
    chunk = pick_chunk(n, min(chunk, n))
    return chunked_topk(xs, qs, n_valid, sq_norms, k=min(k, chunk),
                        chunk=chunk, metric=metric)


def _local_fused(xs16, xs32, qs32, local_valid, k):
    """Per-shard fused packed-bucket candidates + exact f32 re-rank
    (``ops/fused_topk.fused_candidates``, kernel 1 on CUDA), returning
    (similarities, local indices).  At most one candidate per bucket
    exists, so k is clamped to the bucket count's pool; a -inf slot keeps
    the id its packed winner names, as in the reference."""
    best_s, best_i, _ = fused_candidates(xs16, xs32, qs32, local_valid, k=k)
    return best_s, best_i


class ShardedVectorSearch:
    """Sharded search over a fixed mesh + matrix shape.

    ``shard_arrays`` lays the matrix out ``[n_shard * rows_per_shard, D]``
    and puts shard ``s``'s rows on each device of the mesh's column
    ``s``; queries split over the ``data`` axis.  Returns ``(dists [B,
    k], global row indices [B, k])`` on the mesh's merge device."""

    def __init__(
        self,
        mesh: Mesh,
        k: int,
        metric: str = "cosine",
        chunk: int = 65536,
        bf16: bool | None = None,
        use_fused: bool | None = None,
    ):
        self.mesh = mesh
        self.k = k
        self.metric = metric
        self.chunk = chunk
        on_cuda = mesh.device.type == "cuda"
        self.bf16 = bf16 if bf16 is not None else on_cuda
        # Per-shard fused kernel (ops/fused_topk.py): CUDA + cosine only;
        # shard_arrays pads each shard's rows to the fused tile.
        if use_fused is None:
            use_fused = on_cuda and metric == "cosine" and self.bf16
        self.use_fused = use_fused
        self.n_shard = mesh.shape["shard"]

    def _shard_search(self, shard, qs, local_valid):
        x32, x16, sq = shard
        rows, d = x32.shape
        if self.bf16:
            xs_c, qs_c = x16, qs.to(torch.bfloat16)
        else:
            xs_c, qs_c = x32, qs
        if (self.use_fused and rows % TILE == 0
                and bucket_kernel_refusal(rows, d, 128) is None):
            return _local_fused(xs_c, x32, qs, local_valid, self.k)
        return _local_topk(xs_c, qs_c, local_valid, sq, self.k, self.chunk,
                           self.metric)

    def _merge(self, scores, ids, qs):
        """The reference's all-gather + top-k on the merge device
        (``mesh.merge_topk``).  Per-shard paths clamp k to their
        candidate width, so the merged result pads overflow slots (dist
        +inf, id -1)."""
        k = self.k
        top_s, top_i = merge_topk(self.mesh.device, scores, ids, k)
        if top_s.shape[1] < k:
            pad = k - top_s.shape[1]
            top_s = torch.nn.functional.pad(top_s, (0, pad),
                                            value=float("-inf"))
            top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
        if self.metric == "cosine":
            dists = 1.0 - top_s
        else:
            q_sq = torch.sum(qs * qs, dim=1, keepdim=True)
            dists = -top_s + q_sq
        return dists, top_i

    def shard_arrays(self, data: np.ndarray, sq_norms: np.ndarray):
        """Pad the packed matrix and put it on the mesh.  Returns ``(xs,
        sq, n_valid)``: ``xs[r][s]`` is shard ``s``'s ``(f32 rows, bf16
        rows or None)`` on the device at mesh position ``(r, s)``, ``sq``
        the squared norms laid out the same way."""
        n, d = data.shape
        rows_per_shard = -(-n // self.n_shard)
        if self.use_fused:
            # Fused kernel wants whole row tiles per shard.
            rows_per_shard = ((rows_per_shard + TILE - 1) // TILE) * TILE
        else:
            rows_per_shard = ((rows_per_shard + 127) // 128) * 128
        total = rows_per_shard * self.n_shard
        padded = np.zeros((total, d), np.float32)
        padded[:n] = data
        sq = np.zeros(total, np.float32)
        sq[:n] = sq_norms[:n]
        first = self.mesh.devices[0]
        x32 = shard_rows(padded, self.n_shard, first)
        x16 = [x.to(torch.bfloat16) if self.bf16 else None for x in x32]
        sqd = shard_rows(sq, self.n_shard, first)
        xs, sqs = [], []
        for row in self.mesh.devices:
            xs.append([(x32[s].to(dev), None if x16[s] is None
                        else x16[s].to(dev)) for s, dev in enumerate(row)])
            sqs.append([sqd[s].to(dev) for s, dev in enumerate(row)])
        return xs, sqs, n

    def __call__(self, xs, qs, n_valid, sq_norms):
        qs = torch.from_numpy(np.asarray(qs, np.float32))
        b = qs.shape[0]
        n_data = self.mesh.shape["data"]
        if b % n_data:
            raise ValueError(
                f"a batch of {b} queries does not split over data={n_data}")
        per = b // n_data
        out_d, out_i = [], []
        for r, row in enumerate(self.mesh.devices):
            q_r = qs[r * per:(r + 1) * per]
            scores, ids = [], []
            for s, dev in enumerate(row):
                x32, x16 = xs[r][s]
                rows = x32.shape[0]
                local_valid = min(max(int(n_valid) - s * rows, 0), rows)
                best_s, best_i = self._shard_search(
                    (x32, x16, sq_norms[r][s]), q_r.to(dev), local_valid)
                scores.append(best_s)
                ids.append(best_i + s * rows)
            dists, top_i = self._merge(scores, ids, q_r.to(self.mesh.device))
            out_d.append(dists)
            out_i.append(top_i)
        if n_data == 1:
            return out_d[0], out_i[0]
        return torch.cat(out_d), torch.cat(out_i)
