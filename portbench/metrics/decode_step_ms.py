"""Mean of the scheduler's ``serve_decode_step`` spans: one compiled
decode step over every slot, its host read of the greedy tokens and the
synchronise."""


def read(run):
    ms = run.tracer.span_ms("serve_decode_step") if run.tracer else []
    return sum(ms) / len(ms) if ms else None
