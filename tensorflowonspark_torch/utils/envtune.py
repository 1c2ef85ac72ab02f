"""Env-tunable numeric knobs (reference: ``TFOS_SERVER_TIMEOUT``-style ops
overrides, ``reservation.py:~120-160``): ops can raise fleet-wide budgets
without touching job code.  Shared by the cluster, data plane, and the
elastic-recovery layer so every timeout/retry default follows one pattern.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

_unregistered_warned: set[str] = set()


def _note_read(name: str) -> None:
    """Warn (once per name) when a ``TOS_*`` knob is read without being in
    the central registry — an undiscoverable knob is a knob ops cannot tune;
    ``utils/knobs.py`` + the README table are the discovery surface, and the
    ``knob-discipline`` checker enforces the same invariant statically."""
    if not name.startswith("TOS_") or name in _unregistered_warned:
        return
    from tensorflowonspark_torch.utils import knobs

    if name not in knobs.KNOBS:
        _unregistered_warned.add(name)
        logger.warning("env knob %s is not registered in utils/knobs.py; "
                       "add it so ops can discover it", name)


def env_float(name: str, default: float) -> float:
    """Positive float from the environment, else ``default``.

    0 is NOT "no timeout" for the knobs this serves — it would make every
    bounded wait fail instantly; non-positive and junk values fall back to
    the default with a warning instead.
    """
    _note_read(name)
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default
    if value <= 0:
        logger.warning("ignoring non-positive %s=%r", name, raw)
        return default
    return value


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Integer knob with a floor (retry/attempt counts must stay >= 1)."""
    _note_read(name)
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", name, raw)
        return default
    if value < minimum:
        logger.warning("ignoring %s=%r below floor %d", name, raw, minimum)
        return default
    return value


def env_str(name: str, default: str = "") -> str:
    """String knob, returned verbatim when set (``default`` when unset).

    Empty-string values pass through: for knobs like ``TOS_COORDINATOR_HOST``
    the empty string is a meaningful setting (bind all interfaces), not an
    absence.
    """
    _note_read(name)
    raw = os.environ.get(name)
    return default if raw is None else raw


_BOOL_VALUES = {"1": True, "true": True, "yes": True, "on": True,
                "0": False, "false": False, "no": False, "off": False}


def env_bool(name: str, default: bool) -> bool:
    """Boolean knob; junk values fall back to the default with a warning
    (an ops typo must degrade to the documented default, never silently
    flip a feature)."""
    _note_read(name)
    raw = os.environ.get(name)
    if not raw:
        return default
    value = _BOOL_VALUES.get(raw.strip().lower())
    if value is None:
        logger.warning("ignoring non-boolean %s=%r", name, raw)
        return default
    return value
