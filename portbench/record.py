"""What a run hands to the metric readers (``metrics/<name>.py``), and the
arithmetic they share.  A reader returns ``None`` where it finds nothing to
read; the harness then leaves its metric out of the line."""

from __future__ import annotations

import dataclasses
import re
import statistics

from portbench import roofline


@dataclasses.dataclass
class RunRecord:
    cell: dict
    config: dict
    mix: dict
    shapes: dict          # the entry's shapes: step FLOPs, attention's sizes
    unit: str             # what a step completes: "tokens", "images"
    units_per_step: int
    setup_s: float        # process start to the window's start
    window_s: float       # host clock, synchronise to synchronise
    step_ms: list         # each step's completion gap on the device (CUDA events)
    feed_ms: list         # host clock around each next() of the batch iterator
    host_ms: list         # host clock around each step call (no sync inside)
    trace: object = None  # trace.TraceView of a traced run

    @property
    def steps(self) -> int:
        return len(self.step_ms)


def p90(values) -> float:
    """The 90th percentile over every value (``statistics.quantiles``,
    inclusive)."""
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def step_mfu(run: RunRecord):
    """Model FLOPs of the window's steps over the traced window, at the
    card's bf16 peak, in %."""
    if run.trace is None:
        return None
    return 100.0 * run.shapes["step_flops"] * run.steps / run.trace.window_s \
        / roofline.PEAK_BF16_FLOPS


def device_idle(run: RunRecord):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


FWD_KERNEL = re.compile(r"flash_fwd_kernel")
BWD_KERNELS = re.compile(r"flash_bwd_(delta|dkdv|dq)_kernel")
BWD_CALL = re.compile(r"flash_bwd_dq_kernel")  # one of each of the three a call


def attention_roofline(run: RunRecord, side: str):
    """The attention bound of one call (``roofline``, from the cell's
    shapes) over the mean device time of one call, in %: the forward
    kernel, or the backward's Δ, dK/dV and dQ kernels summed."""
    a = run.shapes.get("attention")
    if run.trace is None or a is None:
        return None
    args = (a["batch"], a["seq"], a["heads"], a["head_dim"], True, a["itemsize"])
    if side == "fwd":
        runs = run.trace.calls(FWD_KERNEL)
        calls = len(runs)
        bound, _ = roofline.attention_fwd_bound_s(a["batch"], a["seq"], a["seq"],
                                                  *args[2:])
    else:
        runs = run.trace.calls(BWD_KERNELS)
        calls = len(run.trace.calls(BWD_CALL))
        bound, _ = roofline.attention_bwd_bound_s(*args)
    if not calls:
        return None
    return 100.0 * bound / (sum(runs) / calls)
