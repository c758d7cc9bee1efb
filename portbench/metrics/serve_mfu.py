"""The model's operations for the window's requests (``pbench.counts``:
prompts at their own length, the top-k experts a token uses) over the
window's wall seconds times the chip's peak, in percent."""

from pbench import counts, peaks


def read(run):
    flops = counts.window_flops(run.model, run.sched)
    return 100.0 * flops / (run.window_s * peaks.flops(run.model.dtype))
