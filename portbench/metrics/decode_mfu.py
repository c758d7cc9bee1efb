"""The model's operations in the window's decode steps over the seconds
of its ``serve_decode_step`` spans times the chip's peak, in percent:
the whole decode step's share of the peak, which bounds what any of its
kernels can give."""

from pbench import counts, peaks


def read(run):
    ms = run.tracer.span_ms("serve_decode_step") if run.tracer else []
    if not ms:
        return None
    flops = counts.decode_flops(run.model, run.sched)
    return 100.0 * flops / (sum(ms) * 1e-3 * peaks.flops(run.model.dtype))
