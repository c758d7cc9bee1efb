"""Window wall ms over its decode steps: the mean gap between two tokens
of an active request, prefill stalls included. The harness counts the
steps (``pbench.counts.schedule``) and holds the count against the one
the scheduler returns."""


def read(run):
    if not run.sched.steps:
        return None
    return run.window_s * 1e3 / run.sched.steps
