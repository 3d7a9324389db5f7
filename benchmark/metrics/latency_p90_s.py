"""The 90th percentile (nearest rank) of the latency of every request
completed in the window, from the client's ``submit`` call (an open loop:
the request's due time) to the image in its hands (host clock)."""

from benchmark.stats import latency_percentile


def read(run):
    w = run.main
    return latency_percentile(w.timings(), w.t0, w.t1, 90.0)
