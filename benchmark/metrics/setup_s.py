"""Seconds from the process's start to the window's opening: imports, the
CUDA context, the served system's kernel builds (none once built in the
checkout), the weights, the pipeline, one batch of each size, and the
loop's first two batches."""


def read(run):
    return run.setup_s
