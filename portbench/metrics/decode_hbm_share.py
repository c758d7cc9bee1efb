"""The bytes the profiled slice's decode steps need (the weights once a
step, the live K/V read and the new token's written; ``pbench.counts``)
over the device time inside those steps' spans times the HBM rate, in
percent."""

from pbench import counts, peaks, trace


def read(run):
    sl = run.slice
    if sl is None:
        return None
    merged = trace.union([(a, b) for _, a, b in sl.kernels])
    spans = [s for s in sl.spans if s[0] == "serve_decode_step"]
    dev_us = sum(trace.covered(merged, a, b) for _, a, b in spans)
    if not dev_us or len(spans) != len(sl.decode_steps):
        return None
    sched = run.sched
    need = sum(counts.decode_step_bytes(
        run.model, int(sched.active[s]), int(sched.ctx_rows[s]))
        for s in sl.decode_steps)
    return 100.0 * need / (dev_us * 1e-6 * peaks.HBM_BYTES_PER_S)
