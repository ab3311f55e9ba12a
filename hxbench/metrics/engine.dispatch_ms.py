"""Mean host time of one ``search_many_async`` call in the window."""


def read(run):
    spans = run.spans.get("engine.dispatch")
    return sum(spans) / len(spans) * 1e3 if spans else None
