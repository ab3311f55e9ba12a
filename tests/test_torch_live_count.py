"""The exact search's live count taken from the partition that keeps it.

``Partition.search_many_async`` passes its own count (``_n_live``) to
``search_packed_async``, which then neither counts the mask nor, while
no row is dead, copies it for ``finalize()``.  With and without
tombstones, with a row removed between dispatch and ``finalize()``, and
with every row dead, its answers must be bit for bit those of the
recount (the same call without ``n_live``).  Where nothing is removed
after dispatch they must also be ``helix_tpu``'s ``search_packed``'s on
the same rows and mask: ids equal, distances equal on the host path and
within the reference's re-rank rounding on the device path."""

import numpy as np
import pytest
import torch

import helix_tpu.ops.distance as JD
from helix_tpu_torch.engine.vector import Partition
from helix_tpu_torch.ops.distance import search_packed_async

torch.set_num_threads(2)

K = 10
DIM = 16
# distances against the reference's device path: its re-rank sums in
# another order (tests/test_torch_distance.py); the host paths agree bit
# for bit
TOL = 1e-6

CASES = [
    "no_tombstones",
    "one_dead",
    "every_7th_dead",
    "removed_after_dispatch",
    "removed_after_dispatch_with_tombstones",
    "all_dead",
]


def build(n: int, metric: str, seed: int):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n, DIM)).astype(np.float32)
    queries = rng.normal(size=(5, DIM)).astype(np.float32)
    # under l2 the zeroed rows of the dead are this query's nearest, so
    # its answers hold only if finalize() compacts them out
    queries[0] *= 0.01
    part = Partition(metric, device=torch.device("cpu"))
    part.add_bulk(list(range(1, n + 1)), rows)
    if part.matrix._grow_thread is not None:
        part.matrix._grow_thread.join()
    ref = JD.PackedMatrix(DIM, metric)
    ref.extend(rows)
    return part, ref, queries


def kill(part: Partition, ref, positions) -> None:
    """Tombstone rows as the engine does: the partition's ``remove``
    zeroes the port's row, and the reference's row is zeroed alike."""
    for pos in positions:
        part.remove(int(pos) + 1)
        ref.overwrite(int(pos), None)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("use_device", [True, False], ids=["device", "host"])
@pytest.mark.parametrize("case", CASES)
def test_partition_count_answers_as_the_recount(case, use_device, metric):
    # the exact search takes its device path from 4,096 rows
    n = 4160 if use_device else 3000
    part, ref, queries = build(n, metric, seed=CASES.index(case))
    if case == "one_dead":
        kill(part, ref, part.search_many(queries[1:2], 1)[0][0] - 1)
    elif case in ("every_7th_dead", "removed_after_dispatch_with_tombstones"):
        kill(part, ref, range(0, n, 7))
    elif case == "all_dead":
        kill(part, ref, range(n))
    assert part.live_count() == int(part.live_mask.sum())
    removed = None
    if case.startswith("removed_after_dispatch"):
        removed = int(part.search_many(queries[:1], 1)[0][0, 0])

    mask = part.live_mask.copy()  # the state at dispatch
    served = part.search_many_async(queries, K)
    recount = search_packed_async(part.matrix, queries, K, part.live_mask,
                                  use_device=use_device)
    counted = search_packed_async(part.matrix, queries, K, part.live_mask,
                                  use_device=use_device,
                                  n_live=part.live_count())
    if removed is not None:
        part.remove(removed)
    ids, dists = served()
    rd, rp = recount()
    cd, cp = counted()

    # the count given and the count taken answer alike, sentinels too
    np.testing.assert_array_equal(cp, rp)
    np.testing.assert_array_equal(cd, rd)
    want_ids, want_dists = part._map_hits(rd, rp, part.id_table)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_dists)

    if case == "all_dead":
        assert ids.shape == (len(queries), 0) and rp.shape[1] == 0
        assert cp.shape[1] == 0
    else:
        assert ids.shape == (len(queries), K)
        assert not np.isin(ids, np.flatnonzero(~mask) + 1).any()
    if removed is not None:
        # the answer is of the rows live at dispatch
        assert removed in ids[0]
        return
    jd, jp = JD.search_packed(ref, queries, K, mask, use_device=use_device)
    np.testing.assert_array_equal(cp, jp)
    if use_device:
        assert np.all(np.abs(cd - jd) <= TOL * np.maximum(1.0, np.abs(jd)))
    else:
        np.testing.assert_array_equal(cd, jd)
