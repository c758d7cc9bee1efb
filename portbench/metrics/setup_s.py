"""Process start to the window's start: imports, the kernels' build or
load, weights, and the capture of every CUDA graph the window replays."""


def read(run):
    return run.setup_s
