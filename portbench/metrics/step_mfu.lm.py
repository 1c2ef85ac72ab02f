"""Model FLOPs of the window's steps over the traced window, at 989 TFLOP/s."""

from portbench.record import step_mfu


def read(run):
    return step_mfu(run)
