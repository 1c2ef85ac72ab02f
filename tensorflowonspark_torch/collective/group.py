"""Coordinator-brokered collective group: rendezvous, generations, buckets.

:class:`CollectiveGroup` is the map_fun-facing handle for cross-host
synchronous training (the ParameterServer/MWMS replacement at
cluster scope): the coordinator's rendezvous assigns **rank / world-size /
peer endpoints** and a monotone **generation** (the ``form`` reduce kind in
``coordinator.py``); the tensor plane then runs rank-to-rank over each
node's existing data-plane port (``transport.py``), and every gradient
exchange is a bucketed ring all-reduce (``ops.py``).

Elastic rejoin — the generation barrier
---------------------------------------

A peer death poisons the in-flight round: every member observes
:class:`CollectiveAborted` within milliseconds (broken-connection cascade,
see ``transport.py``) instead of deadlocking.  Recovery is then symmetric
for survivors and the supervised replacement:

1. everyone calls :meth:`reform` — a fresh coordinator rendezvous at a
   bumped generation (the **generation barrier**: nothing proceeds until
   the full world, including the restarted slot, stands at it; the
   coordinator's incarnation fencing keeps the dead predecessor out);
2. everyone calls :meth:`sync_state` — the member that voted the highest
   step (a survivor holding live state, or everyone's checkpoint step
   after a full restart) broadcasts its state tree, and the group resumes
   from that step in lockstep.

Stale traffic from the aborted generation — late kernel-buffer flushes, a
fenced zombie's chunks — carries the old generation stamp and is dropped.

Gradient buckets
----------------

:meth:`all_reduce_tree` (and the :func:`grad_fn` hook it powers, consumed
by ``parallel.dp.make_train_step(cross_host_grad_fn=...)``) packs tree
leaves into ``TOS_COLLECTIVE_BUCKET_BYTES`` buckets per wire dtype and
flushes each bucket to the comm thread AS IT FILLS: bucket *k*'s ring
all-reduce runs concurrently with the host-side copy/pack of bucket *k+1*,
so communication overlaps the tail of backprop instead of serializing
after it.

Trees (the port's counterpart of the JAX pytrees)
-------------------------------------------------

A tree is nested dicts, lists and tuples whose array leaves are torch
tensors (on any device) and numpy arrays — the ``{name: grad}`` dict
``make_train_step`` hands the hook, or a ``TrainState.tree()``.  Any other
value (a python number, a string, ``None``) is not a leaf: it passes
through untouched.  Results come back in each leaf's own kind: a tensor
leaf as a tensor on its own device and in its own dtype (the hook assigns
them to ``p.grad``), a numpy leaf as numpy.  The wire is numpy, which has
no bfloat16: a bfloat16 leaf travels as float32 (exact), is summed in
float32 and rounds back to bfloat16 once, at the end.  An averaged
integer leaf comes back promoted to float64, as ``ops._averaged`` promotes
it.

Gray failures — stragglers, quorum eviction, degraded worlds
------------------------------------------------------------

Deaths are the easy case; a *slow-but-alive* member (GC pause, one stolen
core, a degraded NIC) used to stall every round for the full collective
timeout and then thrash: reform re-admitted it at full world and the next
round stalled again.  The gray-failure path:

1. **Detection** — the transport keeps per-peer rolling contribution
   timings; a wait running ``TOS_COLLECTIVE_SUSPECT_FACTOR`` past the
   rolling baseline files a ``suspect`` vote with the coordinator
   (relative, so uniform slowness never flags anyone; abort attribution —
   the vote names the peer being waited on).
2. **Quorum eviction** — the coordinator resolves transitive blame (a
   member that is itself complaining about its upstream is a pipeline
   victim, not the straggler) and at ``TOS_COLLECTIVE_EVICT_QUORUM``
   survivor votes EVICTS: the member's incarnation is fenced and the
   process parks in probation (``TOS_COLLECTIVE_PROBATION_SECS``) instead
   of being respawned into the group.
3. **Degraded-world continuation** — :meth:`form` rendezvouses at the
   *effective* world (nominal minus evicted, coordinator-adjudicated), so
   survivors resume at W-1 well inside one collective timeout;
   :meth:`check_grow` notices a readmitted member and the next
   :meth:`reform` grows the world back at a later generation barrier.
4. **Hard peer-plane fencing** — the old known limitation (a fenced-but-
   alive zombie could keep moving bytes on the peer plane until the next
   reform) is closed: survivors' inboxes reject frames by (generation,
   membership), refuse attaches from non-members, and actively sever an
   evicted peer's attach connections at reconfigure.
"""

from __future__ import annotations

import concurrent.futures
import logging
import time

import numpy as np
import torch

from tensorflowonspark_torch import telemetry
from tensorflowonspark_torch.collective import ops as cops
from tensorflowonspark_torch.collective.transport import (
    CollectiveAborted,
    PeerTransport,
)
from tensorflowonspark_torch.coordinator import CoordinatorClient, CoordinatorFenced
from tensorflowonspark_torch.telemetry import trace as ttrace
from tensorflowonspark_torch.utils.envtune import env_float, env_int, env_str

logger = logging.getLogger(__name__)


# torch dtype -> the numpy dtype it travels as (bfloat16 has none: float32)
def _wire_dtype(leaf) -> np.dtype:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return np.dtype(torch.empty(0, dtype=leaf.dtype).numpy().dtype)
    return np.dtype(getattr(leaf, "dtype", np.asarray(leaf).dtype))


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _flatten(tree) -> tuple[list, object]:
    """``(leaves, spec)`` of a tree (see the module docstring); ``spec``
    rebuilds it with :func:`_unflatten`."""
    leaves: list = []

    def walk(node):
        if _is_leaf(node):
            leaves.append(node)
            return _LEAF
        if isinstance(node, dict):
            return (dict, [(k, walk(v)) for k, v in node.items()])
        if isinstance(node, (list, tuple)):
            return (type(node), [walk(v) for v in node])
        return (None, node)                       # passes through untouched

    return leaves, walk(tree)


_LEAF = object()


def _unflatten(spec, leaves: list):
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        kind, body = node
        if kind is None:
            return body
        if kind is dict:
            return {k: build(v) for k, v in body}
        items = [build(v) for v in body]
        if kind is list:
            return items
        return kind(*items) if hasattr(kind, "_fields") else kind(items)

    return build(spec)


def _pack(leaves: list) -> np.ndarray:
    """One bucket's leaves as one flat host array of their wire dtype.  CUDA
    leaves of one device concatenate there and cross to the host in ONE
    copy (which waits for the device to finish them)."""
    if all(isinstance(l, torch.Tensor) for l in leaves) \
            and len({l.device for l in leaves}) == 1:
        wire = torch.float32 if leaves[0].dtype == torch.bfloat16 else leaves[0].dtype
        flat = [l.detach().reshape(-1).to(wire) for l in leaves]
        # the collective ops copy before they write, so a CPU view is safe
        return (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
    arrs = [np.ascontiguousarray(_host(l).reshape(-1)) for l in leaves]
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def _unpack(packed: np.ndarray, leaves: list) -> list:
    """Slice a reduced bucket back into leaves of each input leaf's kind,
    device and dtype (an integer leaf promoted by averaging stays float)."""
    packed = np.asarray(packed).reshape(-1)
    if not packed.flags.writeable:          # a frame's buffer off the wire
        packed = packed.copy()
    out: list = []
    dev_copy: dict = {}          # one host->device copy per device a bucket needs
    off = 0
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        n = int(np.prod(shape, dtype=np.int64))
        if isinstance(leaf, torch.Tensor):
            if leaf.device not in dev_copy:
                dev_copy[leaf.device] = torch.from_numpy(packed).to(leaf.device)
            t = dev_copy[leaf.device][off:off + n].reshape(shape)
            if leaf.is_floating_point() or not t.is_floating_point():
                t = t.to(leaf.dtype)
            out.append(t)
        else:
            out.append(packed[off:off + n].reshape(shape))
        off += n
    return out


def _plan_buckets(leaves: list, bucket_bytes: int) -> list[list[int]]:
    """Greedy leaf->bucket assignment: consecutive same-wire-dtype leaves
    pack into buckets of at most ``bucket_bytes`` (an oversized leaf is its
    own bucket — ring chunking bounds its frames).  Consecutive-only on
    purpose: packing preserves tree order, so unpacking is pure slicing."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        # shape/dtype attributes only: a host copy here would force a
        # device->host transfer during PLANNING, before any overlap begins
        dtype = _wire_dtype(leaf)
        shape = tuple(getattr(leaf, "shape", ()))
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if cur and (dtype != cur_dtype or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = dtype
    if cur:
        buckets.append(cur)
    return buckets


class CollectiveGroup:
    """One node's membership in a named cluster-wide collective group.

    Construct via :meth:`NodeContext.collective_group` inside a map_fun (or
    directly with explicit endpoints — the bench does), then :meth:`form`
    before the first collective.  All collectives are SPMD calls: every
    member must make the same sequence of calls with compatible arrays.
    Thread contract: the constructing thread owns the public API; the
    internal comm executor serializes all peer I/O.
    """

    def __init__(self, coordinator_addr: tuple[str, int], authkey: bytes,
                 executor_id: int, world: int, host: str, data_port: int,
                 name: str = "train", incarnation: int = 0,
                 timeout: float | None = None,
                 bucket_bytes: int | None = None, detect: bool = True):
        if world < 1:
            raise ValueError("collective group needs world >= 1")
        self.name = name
        self.executor_id = int(executor_id)
        # NOMINAL world: the full membership this group was sized for.
        # After a gray-failure eviction the group runs DEGRADED — the
        # effective world (len(self._members), coordinator-adjudicated at
        # each form) may be smaller until the evicted member grows back in.
        self.world = int(world)
        self.incarnation = int(incarnation)
        self._host = host
        self._data_port = int(data_port)
        self._timeout = (env_float("TOS_COLLECTIVE_TIMEOUT", 120.0)
                         if timeout is None else float(timeout))
        self._algo = env_str("TOS_COLLECTIVE_ALGO", "ring")
        self._bucket_bytes = (env_int("TOS_COLLECTIVE_BUCKET_BYTES", 4 << 20)
                              if bucket_bytes is None else int(bucket_bytes))
        # Dedicated control-plane connection: formation rendezvous can block
        # through a whole restart window and must never wedge the node's
        # main client (heartbeats already have their own).
        self._coordinator_addr = coordinator_addr
        self._authkey = authkey
        self._client = CoordinatorClient(coordinator_addr, authkey=authkey)
        self._client.set_identity(self.executor_id, self.incarnation)
        self._tp = PeerTransport(name, authkey, self._timeout, detect=detect)
        # straggler detection: the transport measures, this group reports.
        # The vote gets its OWN lazy connection (bounded dial + call): the
        # main client's lock can be held across a minutes-long blocking
        # barrier, and a suspicion that cannot be filed is an eviction
        # that never happens.
        self._tp.set_suspect_callback(self._report_suspect)
        self._sus_client: CoordinatorClient | None = None
        self._grow_checked = 0.0
        # ONE comm thread: serializes all peer I/O (sends never interleave)
        # and is the overlap engine — bucket k reduces here while the caller
        # packs bucket k+1.
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"collective-{name}")
        self.rank = -1
        self.generation = 0
        self.agreed_step = 0
        self._root_rank = 0
        self._members: list[dict] = []
        self._seq = 0
        self._closed = False

    # -- formation / the generation barrier -----------------------------------

    def form(self, resume_step: int = 0, timeout: float | None = None) -> int:
        """Rendezvous with every member at a fresh generation; returns the
        group's agreed resume step (the max of all members' votes — a
        survivor's live step, or the checkpoint step after a cold start).

        Retries through coordinator-side aborts: a rendezvous generation
        poisoned by a death declaration (or by one member timing out while
        the restarted slot is still booting) is simply re-entered until the
        full world stands at the barrier or ``timeout`` expires.  A
        coordinator CRASH mid-formation rides the same loop: the client
        reconnects with backoff against the journal-recovered server (or a
        ``CoordinatorRestarted``/epoch-fence reply) and re-enters — the
        generation barrier is also the control-plane failover barrier.
        """
        if self._closed:
            raise CollectiveAborted(f"collective group {self.name!r} is closed")
        budget = self._timeout if timeout is None else float(timeout)
        deadline = time.monotonic() + budget
        t0 = time.monotonic()
        last_err: Exception | None = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CollectiveAborted(
                    f"collective group {self.name!r} did not form within "
                    f"{budget:.0f}s (world {self.world}): {last_err}")
            # Degraded-world rendezvous: form at the coordinator-adjudicated
            # EFFECTIVE world (nominal minus evicted members), re-queried
            # every attempt — an eviction or readmission landing mid-retry
            # is picked up at the next pass.  Re-stamped each attempt: a
            # readmission hands this client its bumped incarnation on the
            # reply, and the next join must carry it.
            count = self._effective_world() or self.world
            me = {"eid": self.executor_id, "host": self._host,
                  "port": self._data_port, "gen": self.generation + 1,
                  "step": int(resume_step),
                  "incarnation": self._client.incarnation}
            try:
                result = self._client.collective_form(
                    f"cg.{self.name}.form", me, count=count,
                    timeout=min(10.0, max(1.0, remaining)))
                break
            except CoordinatorFenced as e:
                # EVICTED (gray failure) or genuinely fenced: ride out the
                # probation — the coordinator readmits this process on a
                # heartbeat once probation expires, the reply hands every
                # client the bumped incarnation, and the next join passes.
                # A dead slot's zombie never readmits and times out here.
                last_err = e
                time.sleep(0.5)
            except (RuntimeError, ConnectionError) as e:
                # peer-abort / slice timeout / death-declaration abort /
                # coordinator failover (CoordinatorRestarted, or the
                # reconnect itself still failing while the control plane
                # restores): re-enter the barrier — the restarted slot may
                # still be riding out its supervisor backoff, and a
                # recovering coordinator its own
                last_err = e
                time.sleep(0.2)
        members = result["members"]
        ranks = [int(m["eid"]) for m in members]
        if self.executor_id not in ranks:
            raise CollectiveAborted(
                f"formation of {self.name!r} completed without this node "
                f"(executor {self.executor_id} not in {ranks})")
        # a readmitted member adopted its bumped incarnation on the wire;
        # the group-level view follows so peers/telemetry see the truth
        self.incarnation = max(self.incarnation, self._client.incarnation)
        self.rank = ranks.index(self.executor_id)
        self.generation = int(result["generation"])
        self.agreed_step = int(result["step"])
        # state root: the lowest rank among the highest-step voters — the
        # member whose state tree sync_state broadcasts
        steps = [int(m.get("step", 0)) for m in members]
        self._root_rank = steps.index(max(steps))
        self._members = members
        self._seq = 0  # SPMD op counter restarts with the generation
        self._tp.configure(self.generation, self.rank, members)
        telemetry.gauge("collective.generation").set(self.generation)
        telemetry.counter("collective.formations_total").inc()
        telemetry.histogram("collective.form_secs").observe(
            time.monotonic() - t0)
        ttrace.event("collective_form", group=self.name,
                     generation=self.generation, rank=self.rank,
                     world=len(members), nominal_world=self.world,
                     step=self.agreed_step)
        if len(members) < self.world:
            telemetry.gauge("collective.degraded_world").set(len(members))
            logger.warning(
                "collective group %r formed DEGRADED: %d/%d members "
                "(evicted slots excluded), generation %d",
                self.name, len(members), self.world, self.generation)
        else:
            telemetry.gauge("collective.degraded_world").set(0)
        logger.info("collective group %r formed: generation %d, rank %d/%d, "
                    "agreed step %d", self.name, self.generation, self.rank,
                    len(members), self.agreed_step)
        return self.agreed_step

    def reform(self, resume_step: int = 0,
               timeout: float | None = None) -> int:
        """Re-form after an aborted round (peer death / timeout): poison the
        current generation, DRAIN the comm thread, and stand at the next
        generation barrier.  Survivors pass their live step; a restarted
        node passes its checkpoint step (0 when it has none) —
        :meth:`sync_state` then levels everyone.

        The drain matters: a straggler bucket flight still running on the
        comm thread would otherwise race the reconfigure — its sends would
        pick up the NEW generation and rank table, and with ``_seq`` reset
        at formation its stale chunks could collide with a fresh round's
        ``(generation, seq, tag)`` keys.  Poisoning first makes the
        straggler fail within milliseconds, so the drain is cheap."""
        self._tp.poison_generation()
        sentinel = self._exec.submit(lambda: None)
        try:
            # single comm worker: this resolves only after every previously
            # submitted flight finished (poisoned, so promptly)
            sentinel.result(timeout=self._timeout + 30.0)
        except concurrent.futures.TimeoutError:
            raise CollectiveAborted(
                "comm thread did not drain after poisoning the aborted "
                "generation; cannot safely re-form") from None
        telemetry.counter("collective.reforms_total").inc()
        return self.form(resume_step=resume_step, timeout=timeout)

    # -- gray-failure detection / degraded worlds ------------------------------

    @property
    def effective_world(self) -> int:
        """Members in the CURRENT formation (may be below the nominal
        ``world`` while an evicted member sits in probation)."""
        return len(self._members) if self._members else self.world

    def _effective_world(self) -> int | None:
        """Coordinator-adjudicated formation count: nominal world minus the
        group's evicted members.  None when the query cannot answer (e.g.
        this client is itself fenced — the form attempt will say so)."""
        try:
            resp = self._client.collective_world(self.name, self.world)
        except (RuntimeError, OSError, ValueError):
            # transient control-plane faults (incl. a post-reconnect resend
            # failing with a raw OSError, or a torn frame's ValueError) are
            # ridden out by the caller's retry loop, never propagated into
            # a training step
            return None
        eff = resp.get("effective")
        return int(eff) if eff is not None else None

    def _suspect_channel(self) -> CoordinatorClient:
        """Lazy dedicated connection for suspicion votes, every phase
        bounded (single dial attempt, call timeout): the comm thread files
        these mid-recv, and neither a busy main client nor a blackholed
        coordinator may wedge it."""
        if self._sus_client is None:
            client = CoordinatorClient(
                self._coordinator_addr, authkey=self._authkey,
                connect_timeout=5.0, connect_attempts=1, call_timeout=10.0)
            client.set_identity(self.executor_id, self._client.incarnation)
            self._sus_client = client
        return self._sus_client

    def _report_suspect(self, src_rank: int, wait_secs: float) -> bool:
        """Transport callback: file a suspicion vote against the peer this
        node has been waiting on (abort attribution included — the vote
        names the rank, the coordinator resolves transitive blame).  True
        when quorum evicted a member of the CURRENT formation: the caller
        aborts the round now and re-forms at the degraded world."""
        members = self._tp.member_eids()
        if not 0 <= src_rank < len(members):
            return False
        suspect_eid = members[src_rank]
        try:
            resp = self._suspect_channel().suspect(self.name, suspect_eid,
                                                   wait_secs)
        except (RuntimeError, OSError, ValueError):
            # a failed vote never poisons a healthy round; drop the channel
            # so the next report dials fresh
            sus, self._sus_client = self._sus_client, None
            if sus is not None:
                try:
                    sus.close()
                except OSError:  # toslint: allow-silent(best-effort teardown of a failed suspicion channel)
                    pass
            return False
        telemetry.counter("collective.suspects_total").inc()
        ttrace.event("suspect", group=self.name, executor=self.executor_id,
                     peer=suspect_eid, wait_secs=round(wait_secs, 2))
        logger.warning("collective group %r: rank %d (executor %d) running "
                       "%.1fs behind; suspicion filed with the coordinator",
                       self.name, src_rank, suspect_eid, wait_secs)
        evicted = {int(e) for e in resp.get("evicted") or ()}
        return bool(evicted & set(members))

    def check_grow(self, min_interval: float = 1.0) -> bool:
        """Cheap grow-back poll (rate-limited to one control round-trip per
        ``min_interval``): True when a previously evicted member has been
        readmitted and a :meth:`reform` would stand a LARGER world at the
        next generation barrier.  Call it at step boundaries; on True,
        ``reform`` + ``sync_state`` level the rejoiner."""
        now = time.monotonic()
        if now - self._grow_checked < min_interval:
            return False
        self._grow_checked = now
        eff = self._effective_world()
        return bool(eff is not None and self._members
                    and eff > len(self._members))

    # -- collectives -----------------------------------------------------------

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _run(self, label: str, seq: int, fn):
        """Execute one collective op on the comm thread and account for it;
        a :class:`CollectiveAborted` tears the peer channels down so the
        abort cascades to every member before their timeouts expire."""
        t0 = time.monotonic()
        fut = self._exec.submit(fn)
        try:
            # backstop only: the op's own recv/socket timeouts fire first
            out = fut.result(timeout=2.0 * self._timeout + 30.0)
        except concurrent.futures.TimeoutError:
            self._abort_round(label, seq)
            raise CollectiveAborted(
                f"collective {label} (seq {seq}) wedged past "
                f"{2.0 * self._timeout + 30.0:.0f}s") from None
        except Exception:
            # ANY failure poisons the round — not just CollectiveAborted: a
            # programming error (shape mismatch in the accumulate, a bad
            # dtype) on one member must still cascade the abort to its
            # peers, or they sit out the full collective timeout blind
            self._abort_round(label, seq)
            raise
        dur = time.monotonic() - t0
        telemetry.counter("collective.rounds_total").inc()
        telemetry.histogram(f"collective.{label}_secs").observe(dur)
        ttrace.record_span("collective.round", ttrace.sample(), None,
                           t0, dur, {"op": label, "seq": seq,
                                     "gen": self.generation})
        return out

    def _abort_round(self, label: str, seq: int) -> None:
        """Poison the current generation (local waiters + peer cascade) and
        meter/record the abort."""
        self._tp.poison_generation()
        telemetry.counter("collective.aborts_total").inc()
        ttrace.event("collective_abort", group=self.name,
                     generation=self.generation, op=label, seq=seq)

    def all_reduce(self, arr, average: bool = False,
                   algo: str | None = None) -> np.ndarray:
        """Element-wise sum (or mean) of ``arr`` across the group."""
        seq = self._next_seq()
        algo = algo or self._algo
        bb = self._bucket_bytes
        return self._run("all_reduce", seq,
                         lambda: cops.all_reduce(self._tp, arr, seq=seq,
                                                 bucket_bytes=bb, algo=algo,
                                                 average=average))

    def reduce_scatter(self, arr, average: bool = False) -> tuple[int, np.ndarray]:
        seq = self._next_seq()
        bb = self._bucket_bytes
        return self._run("reduce_scatter", seq,
                         lambda: cops.reduce_scatter(self._tp, arr, seq=seq,
                                                     bucket_bytes=bb,
                                                     average=average))

    def all_gather(self, arr) -> list[np.ndarray]:
        seq = self._next_seq()
        return self._run("all_gather", seq,
                         lambda: cops.all_gather(self._tp, arr, seq=seq))

    def broadcast(self, arr=None, root: int = 0) -> np.ndarray:
        seq = self._next_seq()
        bb = self._bucket_bytes
        return self._run("broadcast", seq,
                         lambda: cops.broadcast(self._tp, arr, seq=seq,
                                                root=root, bucket_bytes=bb))

    def sparse_all_to_all(self, parts: list) -> list:
        """Personalized exchange of per-destination ``(ids, values)`` CSR
        pairs (the embedding tier's lookup request/response legs); returns
        the received pairs indexed by source rank.  Same comm thread, same
        generation fencing, same abort cascade as the dense ops."""
        seq = self._next_seq()
        return self._run("sparse_all_to_all", seq,
                         lambda: cops.sparse_all_to_all(self._tp, parts,
                                                        seq=seq))

    def sparse_reduce_scatter(self, ids, rows, bounds) -> tuple:
        """Scatter (ids, rows) gradient contributions back to the ranks
        owning them under the shard plan's ``bounds``; returns this rank's
        exact-summed ``(uniq_ids, rows)`` — see ``ops.sparse_reduce_scatter``."""
        seq = self._next_seq()
        return self._run("sparse_reduce_scatter", seq,
                         lambda: cops.sparse_reduce_scatter(
                             self._tp, ids, rows, bounds, seq=seq))

    def barrier(self, timeout: float | None = None) -> None:
        """Control-plane barrier scoped to this group's EFFECTIVE world
        (generation-stamped name, so a stale member can never satisfy a
        live one — and a degraded formation never waits on its evicted
        member)."""
        self._client.barrier(
            f"cg.{self.name}.g{self.generation}.b{self._next_seq()}",
            self.executor_id,
            timeout=self._timeout if timeout is None else timeout,
            count=self.effective_world)

    # -- gradient buckets (the dp.make_train_step hook) ------------------------

    def all_reduce_tree(self, tree, average: bool = True,
                        bucket_bytes: int | None = None,
                        algo: str | None = None):
        """Bucketed cross-host all-reduce of a tree (gradients).

        Leaves pack into per-wire-dtype buckets of ``bucket_bytes``; each
        bucket is submitted to the comm thread AS IT IS PACKED, so bucket
        *k*'s ring all-reduce overlaps the host copy (device to host) of
        bucket *k+1* — the communication/backprop overlap of the
        sync-training design, at host granularity.  Returns a tree of the
        input's structure whose leaves are each input leaf's kind, device
        and dtype (module docstring, "Trees").
        """
        leaves, treedef = _flatten(tree)
        if not leaves:
            return tree
        bb = self._bucket_bytes if bucket_bytes is None else int(bucket_bytes)
        algo = algo or self._algo
        buckets = _plan_buckets(leaves, bb)
        t0 = time.monotonic()
        flights = []
        for bucket in buckets:
            # host materialization (device->host for CUDA leaves) happens
            # HERE, on the caller's thread, while previous buckets reduce
            # on the comm thread
            packed = _pack([leaves[i] for i in bucket])
            seq = self._next_seq()
            fut = self._exec.submit(cops.all_reduce, self._tp, packed,
                                    seq=seq, bucket_bytes=bb, algo=algo,
                                    average=average)
            flights.append((bucket, fut))
        out_leaves: list = list(leaves)
        try:
            for bucket, fut in flights:
                packed = fut.result(timeout=2.0 * self._timeout + 30.0)
                for i, leaf in zip(bucket, _unpack(packed, [leaves[i] for i in bucket])):
                    out_leaves[i] = leaf
        except Exception as e:  # noqa: BLE001 - classified + re-raised below
            # Poison FIRST (unblocks a bucket flight still running on the
            # comm thread within milliseconds), then reap every flight —
            # none may still be alive when a reform reconfigures ranks/seq,
            # or its stale chunks could collide with the next round's keys.
            self._abort_round("all_reduce_tree", self._seq)
            for _, fut in flights:
                fut.cancel()
                if not fut.cancelled():
                    try:
                        fut.result(timeout=self._timeout + 30.0)
                    except Exception:  # noqa: BLE001  # toslint: allow-silent(reaping poisoned flights; the primary error is re-raised below)
                        pass
            if isinstance(e, CollectiveAborted):
                raise
            if isinstance(e, concurrent.futures.TimeoutError):
                raise CollectiveAborted(
                    f"bucketed all-reduce wedged: {e}") from e
            raise
        dur = time.monotonic() - t0
        telemetry.counter("collective.rounds_total").inc()
        telemetry.histogram("collective.all_reduce_secs").observe(dur)
        ttrace.record_span("collective.round", ttrace.sample(), None, t0,
                           dur, {"op": "all_reduce_tree",
                                 "buckets": len(buckets),
                                 "gen": self.generation})
        return _unflatten(treedef, out_leaves)

    def grad_fn(self, average: bool = True, bucket_bytes: int | None = None,
                algo: str | None = None):
        """The ``cross_host_grad_fn`` hook for
        :func:`tensorflowonspark_torch.parallel.dp.make_train_step`: averages
        the per-host gradient tree across the group each step."""
        def fn(grads):
            return self.all_reduce_tree(grads, average=average,
                                        bucket_bytes=bucket_bytes, algo=algo)
        return fn

    # -- post-reform state resync ----------------------------------------------

    def broadcast_tree(self, tree, root: int | None = None):
        """Broadcast a whole tree from ``root`` (bucketed like
        :meth:`all_reduce_tree`); non-root members' leaf VALUES are ignored
        — only the tree structure (shapes/dtypes) must match."""
        root = self._root_rank if root is None else int(root)
        leaves, treedef = _flatten(tree)
        if not leaves or self.effective_world == 1:
            return tree
        buckets = _plan_buckets(leaves, self._bucket_bytes)
        out_leaves: list = list(leaves)
        for bucket in buckets:
            seq = self._next_seq()
            packed = _pack([leaves[i] for i in bucket]) if self.rank == root else None
            got = self._run("broadcast", seq,
                            lambda p=packed, s=seq: cops.broadcast(
                                self._tp, p, seq=s, root=root,
                                bucket_bytes=self._bucket_bytes))
            for i, leaf in zip(bucket, _unpack(got, [leaves[i] for i in bucket])):
                out_leaves[i] = leaf
        return _unflatten(treedef, out_leaves)

    def sync_state(self, tree, step: int):
        """Level every member onto the agreed state after :meth:`form` /
        :meth:`reform`: the highest-step voter broadcasts its state tree and
        everyone adopts ``(its_tree, agreed_step)``.  A member already at
        the agreed step keeps its own values bit-identical (it either IS
        the root or receives the root's identical state).

        ``tree`` may be a ``parallel.dp.TrainState`` (anything with
        ``tree()`` and ``restore(tree)``): its model and optimizer state are
        broadcast and loaded in place, and the state comes back at the
        agreed step."""
        if self.effective_world == 1:
            return tree, int(step)
        if hasattr(tree, "tree") and hasattr(tree, "restore"):
            synced = self.broadcast_tree(tree.tree(), root=self._root_rank)
            synced = tree.restore({**synced, "step": self.agreed_step})
        else:
            synced = self.broadcast_tree(tree, root=self._root_rank)
        if int(step) != self.agreed_step:
            ttrace.event("collective_resync", group=self.name,
                         generation=self.generation,
                         from_step=int(step), to_step=self.agreed_step)
            logger.info("collective group %r: resynced rank %d from step %d "
                        "to step %d", self.name, self.rank, int(step),
                        self.agreed_step)
        return synced, self.agreed_step

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._exec.shutdown(wait=False)
        self._tp.close()
        try:
            self._client.close()
        except OSError:  # toslint: allow-silent(best-effort teardown of the dedicated control-plane connection)
            pass
        if self._sus_client is not None:
            try:
                self._sus_client.close()
            except OSError:  # toslint: allow-silent(best-effort teardown of the suspicion channel)
                pass
