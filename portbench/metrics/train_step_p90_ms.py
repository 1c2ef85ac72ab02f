"""The 90th percentile of every step's completion gap on the device."""

from portbench.record import p90


def read(run):
    return p90(run.step_ms)
