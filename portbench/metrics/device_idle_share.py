"""One minus the union of the device's op intervals over the profiled
slice's wall time, in percent."""

from pbench import trace


def read(run):
    sl = run.slice
    if sl is None or not sl.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_us(sl) / (sl.t1 - sl.t0))
