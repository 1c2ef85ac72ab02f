"""Host time a step waits in next() of the batch iterator, mean a step."""

from statistics import fmean


def read(run):
    return fmean(run.feed_ms)
