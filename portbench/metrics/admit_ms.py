"""Mean of the scheduler's ``serve_admit`` spans: one request's prefill
at its bucket, the scatter of its K/V into the paged pool and the
synchronise after them."""


def read(run):
    ms = run.tracer.span_ms("serve_admit") if run.tracer else []
    return sum(ms) / len(ms) if ms else None
