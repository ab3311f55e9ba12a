"""Mean host time of one acknowledged ``Partition.add`` of a write mix in
the window (the span ``engine.insert``).  The first insert after the bulk
build, which grows the id table and the matrix once, is made in set-up
and is not among them."""


def read(run):
    spans = run.spans.get("engine.insert")
    return sum(spans) / len(spans) * 1e3 if spans else None
