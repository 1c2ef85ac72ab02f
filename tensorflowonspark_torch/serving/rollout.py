"""Rollout governor: watch a canary cohort, promote or auto-roll-back.

The decision half of staged rollouts (``gateway.rollout``).  The router
feeds every batch outcome — cohort, replica, latency, results, transport
error, and for shadow mirrors the primary's results — into
:meth:`RolloutGovernor.observe`; the governor keeps sliding windows
(``TOS_SERVE_ROLLOUT_WINDOW_SECS``) per cohort and resolves the rollout
one of three ways:

- **promote**: a full window elapsed with enough canary samples and no
  regression verdict — the gateway swaps the whole fleet onto the
  candidate (the existing drained reload path, now signature-verified);
- **roll back**: the canary regressed vs the primary baseline — NaN
  outputs, shadow-mirror divergence past threshold, model-attributable
  errors the primary does not show, or canary p99 inflated well past the
  primary's — so the canaries reload the prior export and the candidate
  is journaled as rolled back;
- **abort**: the gateway closed (or the resolution action itself failed)
  mid-rollout.

Error classification is the load-bearing subtlety: the router's observer
reports *transport* failures (dead replica, severed socket, timed-out
round — ``ConnectionError``/``OSError``/``TimeoutError``/``EOFError`` and
chaos ``FaultInjected``).  Those are INFRA errors: they already have an
owner (retry-once + recovery re-admission) and never count toward the
regression verdict — a SIGKILLed canary replica must trigger recovery and
cohort re-convergence, not a spurious rollback of a healthy model.  Only
errors that cannot be transport (and the model-output signals: NaN rate,
divergence, latency inflation) indict the candidate itself.

Everything here is driver-side bookkeeping; the fleet actions (promote /
rollback control rounds) stay in the gateway, under its reload lock, and
the resulting state transitions are journaled through the coordinator's
rollout registry so a control-plane failover restores what was in flight.
"""

from __future__ import annotations

import collections
import logging
import threading
from tensorflowonspark_torch.utils.locks import tos_named_lock
import time
from time import monotonic as _monotonic

import numpy as np

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.faultinject import FaultInjected
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.utils.envtune import env_float

logger = logging.getLogger(__name__)

#: Transport/infra failures (the router's retry + recovery machinery owns
#: these); never evidence against the candidate model.
_INFRA_ERRORS = (ConnectionError, OSError, TimeoutError, EOFError,
                 FaultInjected)


def _is_infra_error(error: BaseException | None) -> bool:
    return isinstance(error, _INFRA_ERRORS)


def _iter_values(row):
    """The numeric leaves of one result row (dict rows yield per output)."""
    if isinstance(row, dict):
        yield from row.values()
    else:
        yield row


def nan_fraction(results, sample: int = 8) -> float:
    """Fraction of NaN elements across (up to ``sample``) result rows —
    the cheapest possible "is the candidate emitting garbage" probe."""
    total = bad = 0
    for row in (results or [])[:sample]:
        for v in _iter_values(row):
            try:
                a = np.asarray(v)
            except Exception:  # noqa: BLE001 - non-numeric output kind
                continue
            if a.dtype.kind != "f":
                continue
            total += a.size
            bad += int(np.isnan(a).sum())
    return bad / total if total else 0.0


def divergence(canary_rows, primary_rows, sample: int = 8) -> float:
    """Worst relative element divergence between a mirror's canary outputs
    and the primary results it shadows.  Shape mismatch, output-key
    mismatch, or NaN on exactly one side is maximal divergence (1.0) —
    those are the regressions shadow testing exists to catch."""
    worst = 0.0
    pairs = list(zip(canary_rows or [], primary_rows or []))[:sample]
    for c_row, p_row in pairs:
        if isinstance(c_row, dict) != isinstance(p_row, dict):
            return 1.0
        if isinstance(c_row, dict):
            if set(c_row) != set(p_row):
                return 1.0
            values = [(c_row[k], p_row[k]) for k in c_row]
        else:
            values = [(c_row, p_row)]
        for cv, pv in values:
            try:
                a = np.asarray(cv, dtype=float)
                b = np.asarray(pv, dtype=float)
            except (TypeError, ValueError):
                # non-numeric outputs (e.g. argmax'd class ids arrive as
                # ints — asarray handles those; strings land here): diverged
                # means not equal
                if cv != pv:
                    return 1.0
                continue
            if a.shape != b.shape:
                return 1.0
            a_nan, b_nan = bool(np.isnan(a).any()), bool(np.isnan(b).any())
            if a_nan or b_nan:
                if a_nan != b_nan:
                    return 1.0
                continue  # both NaN in the same batch: no verdict either way
            if a.size == 0:
                continue
            denom = max(float(np.abs(b).max()), 1.0)
            worst = max(worst, float(np.abs(a - b).max()) / denom)
    return worst


class RolloutState:
    """The journaled facts of one staged rollout — everything a failover
    (or an operator reading statz) needs to know what was in flight."""

    __slots__ = ("candidate", "prior", "canary", "pct", "shadow", "status",
                 "reason", "started_at", "regression_detected_at",
                 "resolved_at", "_mono_detected", "_mono_resolved",
                 "_mono_started")

    def __init__(self, *, candidate: str, prior: str, canary: list[int],
                 pct: int, shadow: bool):
        self.candidate = candidate
        self.prior = prior
        self.canary = sorted(int(e) for e in canary)
        self.pct = int(pct)
        self.shadow = bool(shadow)
        self.status = "canary"  # canary -> promoted | rolled_back | aborted
        self.reason: str | None = None
        self.started_at = time.time()
        self.regression_detected_at: float | None = None
        self.resolved_at: float | None = None
        self._mono_started = _monotonic()
        self._mono_detected: float | None = None
        self._mono_resolved: float | None = None

    def payload(self) -> dict:
        """Journal/statz form (plain JSON-able dict)."""
        return {"candidate": self.candidate, "prior": self.prior,
                "canary": list(self.canary), "pct": self.pct,
                "shadow": self.shadow, "status": self.status,
                "reason": self.reason, "started_at": self.started_at,
                "resolved_at": self.resolved_at}

    def rollback_secs(self) -> float | None:
        """Regression-detected -> canaries-back-on-prior latency (the bench
        headline); None unless this rollout rolled back."""
        if self._mono_detected is None or self._mono_resolved is None:
            return None
        return self._mono_resolved - self._mono_detected


class RolloutGovernor:
    """Watch one rollout's canary cohort and resolve it.

    Lifecycle: built by ``gateway.rollout`` (which wires :meth:`observe`
    into the router and the cohort split into routing), then
    :meth:`start`-ed.  The governor thread evaluates the sliding windows
    every ``poll`` seconds and calls back into the gateway for the fleet
    action; ``wait()`` blocks callers until the rollout resolves.
    """

    def __init__(self, gateway, state: RolloutState, *,
                 window_secs: float | None = None,
                 auto_promote: bool = True,
                 min_canary_samples: int = 3,
                 nan_threshold: float = 1e-3,
                 divergence_threshold: float = 0.05,
                 latency_factor: float = 3.0,
                 latency_floor_secs: float = 0.05,
                 poll_secs: float = 0.25):
        self._gateway = gateway
        self.state = state
        self.window = (float(window_secs) if window_secs is not None
                       else env_float("TOS_SERVE_ROLLOUT_WINDOW_SECS", 5.0))
        self.auto_promote = bool(auto_promote)
        self.min_canary_samples = max(1, int(min_canary_samples))
        self.nan_threshold = float(nan_threshold)
        self.divergence_threshold = float(divergence_threshold)
        self.latency_factor = float(latency_factor)
        self.latency_floor = float(latency_floor_secs)
        self.poll = max(0.05, float(poll_secs))
        self._lock = tos_named_lock("rollout._lock")
        self._stop_evt = threading.Event()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        # sliding windows, all (monotonic_t, value), pruned to self.window
        self._lat = {"primary": collections.deque(),
                     "canary": collections.deque()}
        self._model_errs = {"primary": collections.deque(),
                            "canary": collections.deque()}
        self._nan: collections.deque = collections.deque()
        self._div: collections.deque = collections.deque()
        self._canary_samples = 0  # lifetime, not windowed (promote gate)
        self._infra_errors = 0    # excluded from the verdict; statz only

    # -- router observer ------------------------------------------------------

    def observe(self, cohort: str, executor_id: int, ok: bool, secs: float,
                results, error, mirror_of) -> None:
        """One batch outcome from the router (worker threads; must stay
        cheap and never raise — the router guards, but don't lean on it)."""
        now = _monotonic()
        is_mirror = mirror_of is not None
        with self._lock:
            if not ok:
                if _is_infra_error(error):
                    # infra failure: recovery's problem, not the model's —
                    # but counted, so statz shows a noisy rollout
                    self._infra_errors += 1
                else:
                    self._model_errs[
                        "canary" if cohort == "canary" else "primary"
                    ].append((now, 1))
                return
            if cohort == "canary":
                self._canary_samples += 1
                self._nan.append((now, nan_fraction(results)))
                if is_mirror:
                    self._div.append((now, divergence(results, mirror_of)))
                else:
                    # mirrors replay a batch the primary already timed —
                    # only LIVE canary batches shape the latency compare
                    self._lat["canary"].append((now, secs))
            elif not is_mirror:
                self._lat["primary"].append((now, secs))

    # -- verdict --------------------------------------------------------------

    def _prune_locked(self, now: float) -> None:
        cut = now - self.window
        for dq in (*self._lat.values(), *self._model_errs.values(),
                   self._nan, self._div):
            while dq and dq[0][0] < cut:
                dq.popleft()

    def _verdict_locked(self, now: float) -> str | None:
        """The regression verdict over the current window, or None while
        the canary looks healthy.  Signals, cheapest/most-damning first."""
        self._prune_locked(now)
        nan_rate = (max(v for _, v in self._nan) if self._nan else 0.0)
        if nan_rate > self.nan_threshold:
            return (f"canary emitted NaN outputs (worst window fraction "
                    f"{nan_rate:.3f})")
        if self._div:
            worst = max(v for _, v in self._div)
            if worst > self.divergence_threshold:
                return (f"canary diverges from primary on mirrored traffic "
                        f"(worst relative divergence {worst:.4f} > "
                        f"{self.divergence_threshold:g})")
        c_errs = len(self._model_errs["canary"])
        if c_errs and not len(self._model_errs["primary"]):
            return (f"{c_errs} model-attributable error(s) on the canary, "
                    "none on the primary")
        c_lat = [v for _, v in self._lat["canary"]]
        p_lat = [v for _, v in self._lat["primary"]]
        if (len(c_lat) >= self.min_canary_samples
                and len(p_lat) >= self.min_canary_samples):
            c99 = float(np.percentile(c_lat, 99))
            p99 = float(np.percentile(p_lat, 99))
            if (c99 > self.latency_factor * max(p99, 1e-3)
                    and c99 - p99 > self.latency_floor):
                return (f"canary p99 inflated: {c99 * 1e3:.0f}ms vs primary "
                        f"{p99 * 1e3:.0f}ms "
                        f"(> {self.latency_factor:g}x)")
        return None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-rollout-governor")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.poll):
            now = _monotonic()
            with self._lock:
                if self.state.status != "canary":
                    return
                verdict = self._verdict_locked(now)
                samples = self._canary_samples
            if verdict is not None:
                self.state.regression_detected_at = time.time()
                self.state._mono_detected = now
                telemetry.counter("serve.rollout_regressions").inc()
                ttrace.event("rollout_regression", reason=verdict,
                             candidate=self.state.candidate)
                logger.warning("rollout regression detected: %s", verdict)
                self._resolve("rolled_back", verdict)
                return
            if (self.auto_promote
                    and now - self.state._mono_started >= self.window
                    and samples >= self.min_canary_samples):
                self._resolve("promoted", None)
                return

    def _resolve(self, status: str, reason: str | None) -> None:
        """Run the fleet action for ``status`` through the gateway and
        finalize + journal the state (``aborted`` when the action fails —
        an operator must never read "promoted" off a swap that half
        happened)."""
        try:
            if status == "promoted":
                self._gateway._promote_rollout(self)
            else:
                self._gateway._rollback_rollout(self, reason)
        except Exception as e:  # noqa: BLE001 - surface via status, never lose it
            logger.exception("rollout %s action failed", status)
            status, reason = "aborted", f"{status} failed: {e}"
        self._finalize(status, reason)

    def _finalize(self, status: str, reason: str | None) -> None:
        now = _monotonic()
        with self._lock:
            if self.state.status != "canary":
                return  # already resolved (stop raced the governor)
            self.state.status = status
            self.state.reason = reason
            self.state.resolved_at = time.time()
            self.state._mono_resolved = now
        ttrace.event("rollout_resolved", status=status, reason=reason,
                     candidate=self.state.candidate)
        self._gateway._note_rollout(self.state.payload())
        self._done.set()

    def promote(self) -> str:
        """Operator-driven promotion (the ``auto_promote=False`` workflow:
        the governor still auto-rolls-back on regression, but promotion
        waits for this call).  Runs the fleet swap now; returns the final
        status — which may be a resolution the governor already reached
        if it beat the operator to it."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if not self._done.is_set():
            self._resolve("promoted", None)
        return self.state.status

    def stop(self) -> None:
        """Abort an unresolved rollout (gateway close): no fleet action —
        the cluster is going away — just finalize + journal the abort."""
        self._stop_evt.set()
        if not self._done.is_set():
            self._finalize("aborted", "gateway closed mid-rollout")
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    # -- introspection --------------------------------------------------------

    def active(self) -> bool:
        return self.state.status == "canary"

    def wait(self, timeout: float | None = None) -> str:
        """Block until the rollout resolves; returns the final status
        (still ``"canary"`` when ``timeout`` fires first)."""
        self._done.wait(timeout)
        return self.state.status

    def status(self) -> dict:
        """Live snapshot: the journaled payload plus the window evidence
        (sample counts, current windowed signals, rollback latency)."""
        now = _monotonic()
        with self._lock:
            self._prune_locked(now)
            out = self.state.payload()
            out.update({
                "canary_samples": self._canary_samples,
                "infra_errors": self._infra_errors,
                "window_secs": self.window,
                "windowed": {
                    "canary_lat": len(self._lat["canary"]),
                    "primary_lat": len(self._lat["primary"]),
                    "mirror_diffs": len(self._div),
                    "worst_divergence": (max(v for _, v in self._div)
                                         if self._div else None),
                    "worst_nan_fraction": (max(v for _, v in self._nan)
                                           if self._nan else None),
                },
            })
        out["rollback_secs"] = self.state.rollback_secs()
        return out
