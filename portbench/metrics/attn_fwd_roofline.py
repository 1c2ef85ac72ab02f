"""The attention forward's bound over the forward kernel's mean time a call."""

from portbench.record import attention_roofline


def read(run):
    return attention_roofline(run, "fwd")
