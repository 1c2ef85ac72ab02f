"""Per-tenant fairness for the serving gateway's admission queue.

Before this module, admission was one global FIFO with one failure mode:
``ServeQueueFull`` when the queue hit its bound.  One hot client could fill
the whole queue and every other caller's p99 rode its backlog — the
isolation gap the TensorFlow-Serving lineage calls out for multi-tenant
model servers.  This module replaces the single deque inside
:class:`~.batcher.MicroBatcher` with three mechanisms, all scoped by an
optional per-request *tenant key* (anonymous ``""`` for legacy callers):

- **weighted per-tenant queues with deficit-round-robin drain**: each
  tenant gets its own FIFO; batch building pulls rows tenant-by-tenant
  with a row-granularity DRR (each turn grants ``quantum × weight`` rows
  of deficit, an emptied queue forfeits its deficit), so a tenant with a
  deep backlog cannot monopolize batch fill — everyone else's head-of-line
  requests keep landing in the next batch;
- **per-tenant token-bucket rate limits** (``TOS_SERVE_TENANT_RATE`` rows/
  second per unit weight, one second of burst): a tenant over its budget
  gets its own 429-equivalent (:class:`ServeThrottled`, wire kind
  ``throttled``) at the door, before it can occupy an admission slot;
- **a brownout ladder** (``TOS_SERVE_SHED_LADDER``, occupancy fractions of
  the queue bound): overload sheds in stages instead of one cliff — level
  1 pauses shadow-mirror traffic (the rollout layer polls
  ``shed_level()``), level 2 sheds any tenant past its weight-proportional
  share of the queue (the lowest-weight tenants' overage first, since
  their absolute share is smallest), and only then does the queue-full
  cliff (``ServeQueueFull``) remain for the last rung.

Threading contract: :class:`TenantQueues` is NOT internally locked — it is
owned by the :class:`~.batcher.MicroBatcher` and every method is called
under the batcher's condition lock (the same discipline as the deque it
replaces).  The ``hot_tenant`` chaos hook (``faultinject.tenant_charge_mult``)
rides the admission path so overload tests are deterministic.
"""

from __future__ import annotations

import collections
from time import monotonic as _monotonic

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.utils.envtune import env_float, env_str

#: Rows of DRR deficit granted per unit of tenant weight per rotation turn.
#: Small enough that a max_batch=64 batch interleaves several backlogged
#: tenants; large enough that a single-tenant steady state never pays
#: rotation overhead per row.
_DRR_QUANTUM = 8


class ServeThrottled(RuntimeError):
    """Per-tenant admission rejection (the 429 of this wire protocol):
    THIS tenant is over its token-bucket rate limit or — under brownout —
    past its weight-proportional queue share.  Other tenants' requests are
    still being admitted; retry with backoff or raise the tenant's
    weight/rate."""


class _Tenant:
    __slots__ = ("key", "weight", "queue", "deficit", "tokens", "refilled")

    def __init__(self, key: str, weight: float, burst: float):
        self.key = key
        self.weight = weight
        self.queue: collections.deque = collections.deque()
        self.deficit = 0.0
        # token bucket starts full: a fresh tenant gets its burst
        self.tokens = burst
        self.refilled = _monotonic()


def _parse_ladder(spec: str) -> tuple[float, ...]:
    """Occupancy fractions (ascending) at which shedding escalates; a bad
    spec falls back to the documented default rather than disabling the
    ladder."""
    try:
        rungs = tuple(sorted(float(p) for p in spec.split(",") if p.strip()))
        if rungs and all(0.0 < r <= 1.0 for r in rungs):
            return rungs
    except ValueError:  # toslint: allow-silent(operator typo in the ladder spec; the default ladder below still protects the queue)
        pass
    return (0.5, 0.8)


class TenantQueues:
    """The MicroBatcher's admission queue: per-tenant FIFOs + DRR drain +
    token buckets + the brownout ladder.  Every method runs under the
    owning batcher's lock (see module docstring)."""

    def __init__(self, *, queue_limit: int,
                 weights: dict[str, float] | None = None,
                 rate: float | None = None,
                 ladder: str | None = None):
        self.queue_limit = max(1, int(queue_limit))
        self._weights = {str(k): max(1e-3, float(v))
                         for k, v in (weights or {}).items()}
        self._rate = (float(rate) if rate is not None
                      else env_float("TOS_SERVE_TENANT_RATE", 0.0))
        self._ladder = _parse_ladder(
            ladder if ladder is not None
            else env_str("TOS_SERVE_SHED_LADDER", "0.5,0.8"))
        self._tenants: dict[str, _Tenant] = {}
        # DRR rotation ring over ALL known tenants (rotation skips the
        # empty ones, resetting their deficit — classic DRR forfeiture)
        self._ring: collections.deque[_Tenant] = collections.deque()
        self._current: _Tenant | None = None
        self._n = 0
        self._shed_gauge = telemetry.gauge("serve.shed_level")
        self._shed_gauge.set(0)

    # -- tenant bookkeeping --------------------------------------------------

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def _tenant(self, key: str) -> _Tenant:
        t = self._tenants.get(key)
        if t is None:
            w = self.weight(key)
            burst = max(self._rate * w, 1.0) if self._rate > 0 else 0.0
            t = self._tenants[key] = _Tenant(key, w, burst)
            self._ring.append(t)
        return t

    # -- admission (token buckets + brownout) --------------------------------

    def shed_level(self) -> int:
        """Current brownout rung: 0 = normal; 1+ = the highest ladder
        fraction the queue occupancy has crossed.  Level 1 pauses shadow
        mirroring (polled by the rollout layer), level >= 2 sheds tenants
        past their weight-proportional queue share at admission."""
        occ = self._n / self.queue_limit
        level = 0
        for i, frac in enumerate(self._ladder, start=1):
            if occ >= frac:
                level = i
        return level

    def admission_error(self, tenant: str, nrows: int) -> Exception | None:
        """Token-bucket + brownout check for one arriving request; returns
        the rejection to answer with (:class:`ServeThrottled`) or None to
        admit.  Runs BEFORE the request occupies a queue slot, so a
        flooding tenant is refused at the door and never inflates anyone
        else's backlog."""
        from tensorflowonspark_torch import faultinject

        t = self._tenant(tenant)
        level = self.shed_level()
        self._shed_gauge.set(level)
        if self._rate > 0:
            rate = self._rate * t.weight
            burst = max(rate, 1.0)
            now = _monotonic()
            t.tokens = min(burst, t.tokens + (now - t.refilled) * rate)
            t.refilled = now
            charge = nrows * faultinject.tenant_charge_mult(tenant)
            if charge > t.tokens:
                telemetry.counter("serve.throttled_total").inc()
                return ServeThrottled(
                    f"tenant {tenant or '(anonymous)'!r} over its rate "
                    f"limit ({rate:g} rows/s); retry with backoff")
            t.tokens -= charge
        if level >= 2:
            # brownout level 2: no tenant may hold more than its weight-
            # proportional share of the remaining queue — the lowest-weight
            # tenants' overage sheds first because their share is smallest
            active_w = sum(x.weight for x in self._tenants.values()
                           if x.queue or x is t)
            share = max(1, int(self.queue_limit * t.weight / max(active_w,
                                                                 t.weight)))
            if len(t.queue) >= share:
                telemetry.counter("serve.throttled_total").inc()
                telemetry.counter("serve.shed_total").inc()
                return ServeThrottled(
                    f"gateway under brownout (level {level}): tenant "
                    f"{tenant or '(anonymous)'!r} past its queue share "
                    f"({share} of {self.queue_limit}); retry with backoff")
        return None

    # -- queue surface (what the batcher's deque used to provide) ------------

    def append(self, req) -> None:
        t = self._tenant(req.tenant)
        t.queue.append(req)
        self._n += 1

    def remove(self, req) -> None:
        """Remove a queued request (expiry/cancel); raises ValueError when
        absent — the batcher's existing races catch it, same as deque."""
        t = self._tenants.get(req.tenant)
        if t is None:
            raise ValueError("tenant unknown")
        t.queue.remove(req)  # raises ValueError when already pulled
        self._n -= 1
        if not t.queue:
            t.deficit = 0.0

    def discard(self, req) -> None:
        """Drop an already-resolved request found at batch-build time (its
        slot frees without a batch entry)."""
        t = self._tenants.get(req.tenant)
        if t is not None and t.queue and t.queue[0] is req:
            t.queue.popleft()
            self._n -= 1
            if not t.queue:
                t.deficit = 0.0

    def clear(self) -> None:
        for t in self._tenants.values():
            t.queue.clear()
            t.deficit = 0.0
        self._n = 0
        self._current = None

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        for t in self._tenants.values():
            yield from t.queue

    def oldest_submit(self) -> float | None:
        """Earliest ``t_submit`` across every tenant's head-of-line request
        (per-tenant queues are FIFO, so heads are each tenant's oldest) —
        the batcher's ripeness clock."""
        heads = [t.queue[0].t_submit for t in self._tenants.values()
                 if t.queue]
        return min(heads) if heads else None

    # -- DRR drain (batch building) ------------------------------------------

    def next_for_batch(self):
        """The request batch-building should pull rows from next, DRR
        order, or None when nothing is queued.  The current tenant keeps
        the turn while it has queue AND deficit; otherwise the ring
        rotates, granting each visited nonempty tenant ``quantum × weight``
        more deficit."""
        if not self._n:
            return None
        cur = self._current
        if cur is not None and cur.queue and cur.deficit > 0:
            return cur.queue[0]
        self._current = None
        for _ in range(len(self._ring)):
            t = self._ring[0]
            self._ring.rotate(-1)
            if not t.queue:
                t.deficit = 0.0  # an empty queue forfeits its deficit
                continue
            t.deficit += _DRR_QUANTUM * t.weight
            if t.deficit > 0:
                self._current = t
                return t.queue[0]
        return None

    def charge(self, req, nrows: int) -> None:
        """Account ``nrows`` just pulled from ``req`` against its tenant's
        deficit; pops the request once fully pulled into batches."""
        t = self._tenants.get(req.tenant)
        if t is None:  # pragma: no cover - charge always follows next_for_batch
            return
        t.deficit -= nrows
        if req.offset >= len(req.rows):
            if t.queue and t.queue[0] is req:
                t.queue.popleft()
                self._n -= 1
            if not t.queue:
                t.deficit = 0.0
                if self._current is t:
                    self._current = None

    # -- introspection (stats / tests) ---------------------------------------

    def depths(self) -> dict[str, int]:
        """Queued requests per tenant (nonzero only) — the per-tenant
        stats block's queue picture."""
        return {t.key: len(t.queue) for t in self._tenants.values()
                if t.queue}
