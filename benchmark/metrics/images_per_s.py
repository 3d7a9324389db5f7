"""Images completed in the window per second of the window (host clock):
every request whose image reached its client after the window opened and
by its end, over the window's whole length (``run.Window``)."""

from benchmark.stats import rate


def read(run):
    w = run.main
    return rate(w.timings(), w.t0, w.t1)
