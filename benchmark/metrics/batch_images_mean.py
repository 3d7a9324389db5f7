"""Mean images per batch the micro-batcher dispatched in the window, from
its own counter ``MicroBatcher.sizes``."""


def read(run):
    sizes = run.main.sizes
    n = sum(sizes.values())
    return sum(k * v for k, v in sizes.items()) / n if n else None
