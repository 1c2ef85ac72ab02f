"""The 90th percentile of every step's completion gap in the traced window."""

from portbench.record import p90


def read(run):
    return p90(run.step_ms) if run.trace is not None else None
