"""Mean host time inside one ``finalize()`` in the window."""


def read(run):
    spans = run.spans.get("engine.finalize")
    return sum(spans) / len(spans) * 1e3 if spans else None
