"""Device BM25 scoring: padded postings + per-term scatter-add (PyTorch
port of ``helix_tpu/ops/bm25.py``).

Layout as in the reference: postings become a padded ``[T, P]`` doc-slot
matrix (pad ``N``) with a parallel term-frequency matrix, and a query
scores by adding each query term's Okapi contributions into a dense
``[N]`` score vector (k1=1.2, b=0.75, as the host index).

Deliberate differences from the reference:

- The scatter adds one query term at a time (one ``index_add_`` of
  ``[P]`` per known term, at most ``MAX_QUERY_TERMS``).  A doc appears
  at most once in a postings row, so each doc's score is summed in term
  order, deterministically, which is the order of XLA's CPU scatter;
  one ``index_add_`` of ``[Q * P]`` on CUDA would add in whatever order
  its atomics land, and two docs that tie could split by one ulp.
- Each contribution is rounded as XLA compiles the reference on the CPU
  (``tf + k1 * x`` as one fused multiply-add, ``idf * (k1 + 1)``
  first), so the scores equal the reference's bit for bit
  (``tests/test_torch_bm25.py``).
- The top-k breaks ties toward the lower slot, as ``lax.top_k`` does
  (:func:`~helix_tpu_torch.ops.distance._top_k`); slots are
  assigned in ascending doc-id order, so top-k membership under exact
  ties follows the host's ``(-score, id)`` rule.
- The query's terms are host arrays (they come from the host
  vocabulary), so the number of known terms is read without a sync.

:class:`ShardedBM25` is the mesh path: documents partition across the
mesh's shards, each shard scores its slice with :func:`bm25_scores` on
its own device (the global IDF and avgdl travel with the query), and the
per-shard top-k merge on the merge device (``parallel/mesh.py``).
``bm25_scores.cuda_calls`` counts the calls made on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import _top_k

K1 = 1.2
B = 0.75
MAX_QUERY_TERMS = 16


def _prepare_terms(vocab, df, n_docs, tokens):
    """Shared query prep for the single-device and sharded paths:
    ``(terms, idf)`` padded to MAX_QUERY_TERMS, ``None`` when the query
    has more known terms than the pad (caller -> host path), or
    ``(None, None)`` when nothing matched the vocabulary."""
    import math

    rows, idfs = [], []
    for token in tokens:
        row = vocab.get(token)
        if row is None:
            continue
        rows.append(row)
        d = df[row]
        idfs.append(math.log(1.0 + (n_docs - d + 0.5) / (d + 0.5)))
    if len(rows) > MAX_QUERY_TERMS:
        return None
    if not rows:
        return (None, None)
    pad = MAX_QUERY_TERMS - len(rows)
    return (
        np.array(rows + [-1] * pad, np.int32),
        np.array(idfs + [0.0] * pad, np.float32),
    )


def _finalize(scores, slots, slot_to_doc):
    """Shared postprocess: drop zero scores, map slots to doc ids, and
    order by (-score, id) — membership already matches the host rule
    because slots are id-ordered (see the build methods)."""
    scores = np.asarray(scores, np.float64)
    slots = np.asarray(slots)
    keep = scores > 0
    ids = slot_to_doc[slots[keep]].astype(np.uint64)
    vals = scores[keep]
    order = np.lexsort((ids, -vals))
    return ids[order], vals[order]


def bm25_scores(
    post_docs: torch.Tensor,    # [T, P] int32 doc slots, pad = N
    post_tf: torch.Tensor,      # [T, P] float32 term frequencies
    doc_len: torch.Tensor,      # [N] float32
    avgdl: float,
    query_terms: np.ndarray,    # [Q] int32 term rows, pad = -1
    query_idf: np.ndarray,      # [Q] float32 (0 for pads)
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (scores desc, doc slots) for one query."""
    if post_docs.is_cuda:
        bm25_scores.cuda_calls += 1
    n = doc_len.shape[0]
    device = doc_len.device
    terms = np.asarray(query_terms)
    known = terms >= 0
    rows = torch.from_numpy(terms[known].astype(np.int64)).to(device)
    idf = torch.from_numpy(
        np.asarray(query_idf, np.float32)[known]).to(device)
    docs = post_docs.index_select(0, rows)           # [Q', P]
    tf = post_tf.index_select(0, rows)
    doc_valid = docs < n
    dl = doc_len[torch.where(doc_valid, docs, 0).long()]
    avg = max(float(np.float32(avgdl)), 1e-9)
    # The arithmetic as XLA compiles the reference on the CPU: it
    # contracts tf + k1 * x into one fused multiply-add (rounded once:
    # float64 holds the product of two floats exactly, and the sum too,
    # since tf >= 1 and k1 * x >= 0.3 on every live slot), and its
    # simplifier scales the [Q] idf vector before multiplying by tf.
    x = (1.0 - B) + B * dl / avg
    denom = (tf.double() + float(np.float32(K1)) * x.double()).float()
    contrib = tf * (idf * (K1 + 1.0))[:, None] / torch.clamp(denom, min=1e-9)
    contrib = torch.where(doc_valid, contrib, 0.0)
    target = torch.where(doc_valid, docs, n).long()
    scores = torch.zeros(n + 1, dtype=torch.float32, device=device)
    for i in range(len(rows)):   # term order: a deterministic f32 sum
        scores.index_add_(0, target[i], contrib[i])
    return _top_k(scores[:n], min(k, n))


bm25_scores.cuda_calls = 0


class DevicePostings:
    """Device-ready postings built from the host inverted index."""

    def __init__(
        self,
        vocab: dict[str, int],
        post_docs: torch.Tensor,
        post_tf: torch.Tensor,
        doc_len: torch.Tensor,
        avgdl: float,
        slot_to_doc: np.ndarray,
        n_docs: int,
        df: np.ndarray,
    ):
        self.vocab = vocab
        self.post_docs = post_docs
        self.post_tf = post_tf
        self.doc_len = doc_len
        self.avgdl = avgdl
        self.slot_to_doc = slot_to_doc
        self.n_docs = n_docs
        self.df = df

    @staticmethod
    def host_arrays(
        postings: dict[str, dict[int, int]],
        doc_len: dict[int, int],
        max_postings_cap: int = 1 << 16,
    ):
        """The reference's packed host layout ``(terms, docs [T, P],
        tf [T, P], lengths [N], slot_to_doc [N], df [T])``; None when a
        term's postings exceed the cap (ultra-common terms — callers keep
        the host path) or the index is empty."""
        n = len(doc_len)
        if n == 0:
            return None
        # Slot order IS the tie-break order: ascending-id slots make
        # device membership match the host's (-score, id) rule even when
        # ties straddle rank k.
        slot_to_doc = np.sort(np.fromiter(doc_len.keys(), np.int64, count=n))
        doc_to_slot = {int(d): i for i, d in enumerate(slot_to_doc)}
        lengths = np.array(
            [doc_len[int(d)] for d in slot_to_doc], np.float32
        )
        terms = sorted(postings.keys())
        widths = [len(postings[t]) for t in terms]
        p = max(widths) if widths else 1
        if p > max_postings_cap:
            return None
        t = max(len(terms), 1)
        docs = np.full((t, p), n, np.int32)
        tf = np.zeros((t, p), np.float32)
        df = np.zeros(t, np.int64)
        for row, term in enumerate(terms):
            bucket = postings[term]
            df[row] = len(bucket)
            for col, (doc, freq) in enumerate(bucket.items()):
                docs[row, col] = doc_to_slot[doc]
                tf[row, col] = freq
        return terms, docs, tf, lengths, slot_to_doc, df

    @staticmethod
    def build(
        postings: dict[str, dict[int, int]],
        doc_len: dict[int, int],
        max_postings_cap: int = 1 << 16,
        *,
        device: torch.device | str,
    ) -> "DevicePostings | None":
        """Pack the host index onto ``device``; None where
        :meth:`host_arrays` is None."""
        host = DevicePostings.host_arrays(postings, doc_len, max_postings_cap)
        if host is None:
            return None
        terms, docs, tf, lengths, slot_to_doc, df = host
        device = torch.device(device)
        return DevicePostings(
            {term: i for i, term in enumerate(terms)},
            torch.from_numpy(docs).to(device),
            torch.from_numpy(tf).to(device),
            torch.from_numpy(lengths).to(device),
            float(lengths.sum() / len(lengths)),
            slot_to_doc,
            len(lengths),
            df,
        )

    def search(self, tokens: list[str], k: int) -> tuple[np.ndarray, np.ndarray] | None:
        """(doc ids, scores desc) for tokenized query text.

        Returns ``None`` when the query has more KNOWN terms than the
        pad width — the caller serves it on the host path so results
        never silently drop terms.  Unknown tokens are filtered BEFORE
        the cap (they score nothing on either path)."""
        prepared = _prepare_terms(self.vocab, self.df, self.n_docs, tokens)
        if prepared is None:
            return None
        terms, idf = prepared
        if terms is None:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        scores, slots = bm25_scores(
            self.post_docs, self.post_tf, self.doc_len, self.avgdl,
            terms, idf, k=k,
        )
        return _finalize(scores.cpu().numpy(), slots.cpu().numpy(),
                         self.slot_to_doc)


class ShardedBM25:
    """Multi-device BM25: documents partition across the mesh, each shard
    scores its slice with the same Okapi arithmetic (global IDF/avgdl
    travel with the query), and the per-shard top-k merge on the merge
    device.

    Docs take slots in ascending id order, shard-major: within a shard
    the top-k's lowest-slot tie rule is the lowest id, and the merge
    flattens shard-major, preferring earlier shards (lower ids).
    Together these are the host's ``(-score, id)`` membership rule,
    exactly."""

    def __init__(self, mesh, vocab, docs, tf, dl, rows_per_shard,
                 avgdl, slot_to_doc, n_docs, df):
        self.mesh = mesh
        self.vocab = vocab
        self.docs = docs            # per shard [T, P] local slots, pad = rows
        self.tf = tf
        self.dl = dl                # per shard [rows]
        self.rows_per_shard = rows_per_shard
        self.avgdl = avgdl
        self.slot_to_doc = slot_to_doc  # [S * rows] host (0 pads)
        self.n_docs = n_docs
        self.df = df

    @staticmethod
    def build(postings, doc_len, mesh, max_postings_cap: int = 1 << 16):
        """Pack the host index over ``mesh``'s shards; None when the
        index is empty or a term's postings on one shard exceed the
        cap."""
        from ..parallel.mesh import shard_rows

        n = len(doc_len)
        if n == 0:
            return None
        n_shard = int(mesh.shape["shard"])
        rows = -(-n // n_shard)
        rows = ((rows + 127) // 128) * 128
        all_docs = np.sort(np.fromiter(doc_len.keys(), np.int64, count=n))
        slot_to_doc_full = np.zeros(n_shard * rows, np.int64)
        slot_to_doc_full[:n] = all_docs
        lengths_full = np.zeros(n_shard * rows, np.float32)
        lengths_full[:n] = [doc_len[int(d)] for d in all_docs]
        terms = sorted(postings.keys())
        t = max(len(terms), 1)
        placed = []
        width = 1
        for term in terms:
            bucket = postings[term]
            slot = np.searchsorted(all_docs, np.fromiter(
                bucket.keys(), np.int64, count=len(bucket)))
            freq = np.fromiter(bucket.values(), np.float32, count=len(bucket))
            # per shard, in the bucket's order (the reference's fill)
            order = np.argsort(slot // rows, kind="stable")
            shard = slot[order] // rows
            counts = np.bincount(shard, minlength=n_shard)
            col = np.arange(len(order)) - np.repeat(
                np.cumsum(counts) - counts, counts)
            placed.append((shard, slot[order] % rows, col, freq[order]))
            width = max(width, int(counts.max()))
        if width > max_postings_cap:
            return None
        docs = np.full((n_shard, t, width), rows, np.int32)
        tf = np.zeros((n_shard, t, width), np.float32)
        df = np.zeros(t, np.int64)
        for row, (shard, local, col, freq) in enumerate(placed):
            df[row] = len(shard)
            docs[shard, row, col] = local
            tf[shard, row, col] = freq
        devs = mesh.shard_devices
        return ShardedBM25(
            mesh,
            {term: i for i, term in enumerate(terms)},
            [torch.from_numpy(docs[s]).to(dev) for s, dev in enumerate(devs)],
            [torch.from_numpy(tf[s]).to(dev) for s, dev in enumerate(devs)],
            shard_rows(lengths_full, n_shard, devs),
            rows,
            float(lengths_full.sum() / n),
            slot_to_doc_full,
            n,
            df,
        )

    def search(self, tokens: list[str], k: int):
        """(doc ids, scores desc) — None when the query exceeds the
        term pad (caller serves on the host path)."""
        prepared = _prepare_terms(self.vocab, self.df, self.n_docs, tokens)
        if prepared is None:
            return None
        terms, idf = prepared
        if terms is None:
            return np.empty(0, np.uint64), np.empty(0, np.float64)
        from ..parallel.mesh import merge_topk

        rows = self.rows_per_shard
        scores, ids = [], []
        for s in range(len(self.docs)):
            top, idx = bm25_scores(
                self.docs[s], self.tf[s], self.dl[s], self.avgdl,
                terms, idf, k=min(k, rows),
            )
            scores.append(top)
            ids.append(idx + s * rows)
        top, slots = merge_topk(self.mesh.device, scores, ids, k)
        return _finalize(top.cpu().numpy(), slots.cpu().numpy(),
                         self.slot_to_doc)
