"""Output tokens the window's call completed (counted by the harness
from ``outputs``) over the window's wall seconds."""


def read(run):
    return run.sched.tokens / run.window_s
