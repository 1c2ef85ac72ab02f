"""Host time of the step call (issue only, no sync inside), mean a step."""

from statistics import fmean


def read(run):
    return fmean(run.host_ms)
