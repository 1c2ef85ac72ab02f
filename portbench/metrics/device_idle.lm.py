"""Share of the traced window with no operation on the card."""

from portbench.record import device_idle


def read(run):
    return device_idle(run)
