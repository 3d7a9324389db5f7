"""Mean host milliseconds of the pipeline's ``submit`` (validation,
tokenization, uploads and every kernel launch of one batch) over the
batches dispatched in the window: a span the benchmark records around the
call."""


def read(run):
    w = run.main
    spans = [e - s for s, e in w.spans.by_name.get("dispatch", ()) if w.t0 < s <= w.t1]
    return 1e3 * sum(spans) / len(spans) if spans else None
