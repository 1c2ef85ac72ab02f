"""Set-up: process start to the window's start (loading, building, warming)."""


def read(run):
    return run.setup_s
