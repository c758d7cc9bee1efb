"""The paged decode attention kernel (``ring_decode_kernel<T, true,
R>``) over the profiled slice: the sum of each counted decode step's
bound (its live K/V rows, q and the output at the HBM rate, or its
operations at the peak, whichever is larger; ``pbench.counts``) over the
kernel's summed device time, in percent."""

import sys

from pbench import counts, peaks, trace


def is_paged_decode(name: str) -> bool:
    return "ring_decode_kernel<" in name and ", true," in name


def read(run):
    sl = run.slice
    if sl is None:
        return None
    us, n = trace.kernel_us(sl, is_paged_decode)
    if not n:
        return None
    if n != run.model.layers * len(sl.decode_steps):
        print(f"# paged_decode_roofline: {n} launches in the slice for "
              f"{len(sl.decode_steps)} steps of {run.model.layers} layers",
              file=sys.stderr)
    sched = run.sched
    bound = sum(counts.paged_decode_bound_s(
        run.model, int(sched.active[s]), int(sched.ctx_rows[s]),
        peaks.flops(run.model.dtype), peaks.HBM_BYTES_PER_S)
        for s in sl.decode_steps)
    return 100.0 * bound / (us * 1e-6)
