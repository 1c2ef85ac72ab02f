"""The comparison that decides ``correct`` for a training cell.

Both sides report the same readings (``reference/train.py``): the loss of
each of the first steps, each parameter's gradient norm at the first step
(the program's worked out from its optimizer's state after that step), and
each parameter's and buffer's change after the last of them.  The numbers:

- ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
- ``grad_norm_gap``: over the parameters, the largest gap between the two
  norms, ``|‖g_prog‖ - ‖g_ref‖|``, over the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- ``change_norm_gap``: the same for the change; under Adam it leaves out
  the parameters whose reference gradient at the first step is under a
  thousandth of the median leaf's, since Adam's step does not shrink with
  the gradient and such a leaf moves by round-off alone (SGD's does).

Each is held to the cell's limit; a number that is not finite, or a leaf
that one side lacks, fails.
"""

from __future__ import annotations

import math
import statistics

NOUGHT_GRADIENT = 1e-3  # share of the median leaf's gradient norm


def _worst(program: dict, reference: dict, names: list) -> tuple[float, str]:
    median = statistics.median(reference[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        if n not in program:
            return math.inf, n
        gap = abs(program[n] - reference[n]) / max(reference[n], median, 1e-30)
        if not gap <= worst:  # a NaN is the worst
            worst, where = gap, n
            if math.isnan(gap):
                break
    return worst, where


def numbers(program: dict, reference: dict, optimizer: str) -> dict:
    """``{name: (value, where)}`` for the three numbers; ``optimizer`` is
    the configuration's (``"adamw"``, ``"sgd"``)."""
    if len(program["loss"]) != len(reference["loss"]):
        loss = (math.inf, "steps")
    else:
        loss = max(((abs(p - r) / abs(r), f"step {i}") for i, (p, r)
                    in enumerate(zip(program["loss"], reference["loss"]), start=1)),
                   key=lambda gap: (math.isnan(gap[0]), gap[0]))
    grads = reference["grad_norm"]
    median = statistics.median(grads.values())
    moving = [n for n in reference["change_norm"] if optimizer != "adamw"
              or n not in grads or grads[n] >= NOUGHT_GRADIENT * median]
    return {"loss_gap": loss,
            "grad_norm_gap": _worst(program["grad_norm"], grads, list(grads)),
            "change_norm_gap": _worst(program["change_norm"], reference["change_norm"],
                                      moving)}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit; ``checks``
    holds each number, its limit and the leaf or step it was read at."""
    checks, correct = {}, True
    for name, (value, where) in found.items():
        correct = correct and value <= limits[name]
        # a number that is not finite is printed as text: JSON has no NaN
        checks[name] = {"value": value if math.isfinite(value) else str(value),
                        "limit": limits[name], "at": where}
    return correct, checks
