"""The prefill flash attention kernel (``attention_wg_kernel``) over the
profiled slice: the sum of each admitted prompt's causal attention bound
at its own length (operations at the peak, or q/k/v/out at the HBM rate,
whichever is larger; ``pbench.counts``) over the kernel's summed device
time, in percent. Padding to the bucket shows as lost share."""

import sys

from pbench import counts, peaks, trace


def is_prefill_attn(name: str) -> bool:
    return "attention_wg_kernel" in name


def read(run):
    sl = run.slice
    if sl is None or not sl.admitted:
        return None
    us, n = trace.kernel_us(sl, is_prefill_attn)
    if not n:
        return None
    if n != run.model.layers * len(sl.admitted):
        print(f"# prefill_attn_roofline: {n} launches in the slice for "
              f"{len(sl.admitted)} admissions of {run.model.layers} layers",
              file=sys.stderr)
    plen = dict(zip(run.sched.rids.tolist(), run.sched.plen.tolist()))
    bound = sum(counts.prefill_attn_bound_s(
        run.model, plen[r], peaks.flops(run.model.dtype),
        peaks.HBM_BYTES_PER_S) for r in sl.admitted)
    return 100.0 * bound / (us * 1e-6)
