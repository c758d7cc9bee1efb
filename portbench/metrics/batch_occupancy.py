"""Output tokens over decode steps, both counted by the harness: the
rows a decode step serves, on average (at most the cell's slots)."""


def read(run):
    if not run.sched.steps:
        return None
    return run.sched.tokens / run.sched.steps
