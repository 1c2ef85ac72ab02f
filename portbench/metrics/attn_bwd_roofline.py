"""The attention backward's bound over the Δ, dK/dV and dQ kernels' mean
time a call."""

from portbench.record import attention_roofline


def read(run):
    return attention_roofline(run, "bwd")
