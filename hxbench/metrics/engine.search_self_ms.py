"""Mean self time, in ms, of one dispatch of the exact search: an
``engine.search`` span's duration less the parts of its direct children
that fall inside it (the live count, the H2D, the enqueue, the mask
copy), so what is left is the query preparation, the padding, the
device-array lookup and the start of the pinned D2H copies.
``engine.d2h_wait`` is a child too, but in ``finalize()``, outside it.
Read from the program's own spans (:mod:`hxbench.program_spans`)."""

from hxbench.program_spans import snapshot


def read(run):
    snap = snapshot(run)
    if snap is None:
        return None
    own = {r[1]: [r[4], r[5], r[5] - r[4]] for r in snap.spans
           if r[0] == "engine.search"}
    if not own:
        return None
    for r in snap.spans:
        parent = own.get(r[2])
        if parent is not None:
            parent[2] -= max(0, min(r[5], parent[1]) - max(r[4], parent[0]))
    return sum(v[2] for v in own.values()) / len(own) * 1e-6
