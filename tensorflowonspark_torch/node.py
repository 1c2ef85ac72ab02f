"""Per-host node runtime — the ``TFSparkNode`` replacement.

Counterpart of ``tensorflowonspark_tpu/node.py`` for the PyTorch / CUDA
port.  Reference (``tensorflowonspark/TFSparkNode.py:~140-420``): a Spark
task on each executor derives its executor id, allocates GPUs into
``CUDA_VISIBLE_DEVICES``, starts TFManager queues, registers with the
reservation server, writes ``TF_CONFIG``, optionally spawns TensorBoard,
then invokes the user ``map_fun(args, ctx)``.

Design (as in the JAX package):
- the coordinator *assigns* ``executor_id``/role at registration (race-free,
  replacing partition-id derivation and ``gpu_info.py`` GPU-pick retries);
- accelerator visibility is whatever CUDA exposes to this process
  (``CUDA_VISIBLE_DEVICES`` through ``env``/``per_node_env``); the node
  registers ``gpu_info.device_summary()``;
- instead of ``TF_CONFIG`` + ``tf.train.Server``, a multi-process torch
  world is set up via ``torch.distributed.init_process_group`` (NCCL on
  the card, gloo when the map_fun's args ask for the CPU) when
  ``torch_distributed`` is enabled;
- ``map_fun`` runs in the node process's main thread — there is no Spark task
  slot to give back, so the reference's background-process fork
  (``TFSparkNode.py:~300-420``) and its cross-process manager queues are
  unnecessary.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Sequence

from tensorflowonspark_torch.coordinator import CoordinatorClient
from tensorflowonspark_torch.dataserver import DataServer
from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
from tensorflowonspark_torch.marker import EndOfFeed
from tensorflowonspark_torch.utils import paths as _paths
from tensorflowonspark_torch.utils.net import local_ip

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class NodeConfig:
    """Everything a node process needs to join the cluster."""

    coordinator_addr: tuple[str, int]
    authkey: bytes
    map_fun: Callable[[Any, "NodeContext"], Any]
    tf_args: Any = None
    queues: Sequence[str] = ("input", "output", "error")
    input_qnames: Sequence[str] = ("input",)
    # "streaming" (driver streams rows) or "direct" (the feed carries shard
    # PATHS and ctx.get_data_feed returns the node-side ingest pipeline).
    input_mode: str = "streaming"
    queue_capacity: int = 1024
    feed_timeout: float = 600.0
    reservation_timeout: float = 120.0
    default_fs: str = ""
    working_dir: str = ""
    log_dir: str = ""
    tensorboard: bool = False
    torch_distributed: bool = False
    heartbeat_interval: float = 2.0
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    # Position in the launcher's process list; registered back to the
    # coordinator so the driver can map executor_id -> process handle
    # (pids don't work for that: over ssh transports the local handle's pid
    # is the ssh client, not the remote node).
    launch_index: int = -1
    # >= 0: this process is a supervised RESTART re-registering into the
    # named (dead) executor slot; it adopts the slot's bumped incarnation,
    # fencing out its predecessor (supervisor.py).
    replace_executor_id: int = -1
    # Decode options for the data-service tier (cluster.run(ingest_opts=...)):
    # keyword args for ingest.service.IngestService — schema=, chunk_records=,
    # readers=, cache_bytes=, shuffle=, ...  Only read by processes the
    # coordinator assigns the "ingest" role (role-aware dispatch below);
    # carried on EVERY config because role assignment is registration-order,
    # so any launched process may become an ingest worker.
    ingest_opts: dict | None = None
    # True when this process may be assigned the "ingest" role (the cluster
    # runs a data-service tier).  Such a process touches no CUDA before it
    # knows its role: it registers a placeholder device and reports the real
    # facts by update_meta once the role is known — an ingest worker hides
    # every card from itself first, so it decodes on host cores and never
    # opens a CUDA context on the trainer's card.
    ingest_tier: bool = False


class NodeContext:
    """The ``ctx`` handed to user ``map_fun`` (reference ``TFNodeContext``,
    ``TFSparkNode.py:~27-60``), extended with TPU mesh facilities."""

    def __init__(
        self,
        executor_id: int,
        job_name: str,
        task_index: int,
        num_executors: int,
        cluster_info: list[dict],
        queues: FeedQueues,
        config: NodeConfig,
        client: CoordinatorClient,
        stop_event: threading.Event | None = None,
        incarnation: int = 0,
    ):
        self.executor_id = executor_id
        self.job_name = job_name
        self.task_index = task_index
        # 0 for a first-launch node; a supervised restart adopts its slot's
        # bumped generation (map_funs can key restart-only behaviour on it,
        # e.g. "resume from the latest checkpoint").
        self.incarnation = incarnation
        self.num_executors = num_executors
        self.cluster_info = cluster_info
        self.queues = queues
        self.default_fs = config.default_fs
        self.working_dir = config.working_dir or os.getcwd()
        self.log_dir = config.log_dir
        self.tf_args = config.tf_args
        self._config = config
        self._client = client
        self._cons_client = None
        self._cons_pending = False
        # shared with the heartbeat thread, which starts before this context
        # exists (liveness must not wait for process-group init / first kernel builds)
        self.stop_requested = stop_event if stop_event is not None else threading.Event()

    @property
    def is_restart(self) -> bool:
        """True when this node is a supervised restart of a dead predecessor
        — the cue to resume from the latest checkpoint
        (``checkpoint.restore_for_restart``) before re-entering the feed."""
        return self.incarnation > 0

    # -- data plane ----------------------------------------------------------

    def get_data_feed(
        self,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping: dict | None = None,
        **ingest_opts,
    ):
        """Reference: ``TFNode.DataFeed(ctx.mgr, ...)`` (``TFNode.py:~250``).

        The feed-source switch: on a STREAMING cluster this is the
        driver-streamed ``DataFeed``; on a DIRECT cluster the same call
        returns an :class:`~tensorflowonspark_torch.ingest.IngestFeed` — the
        node-side reader pipeline over the shard paths the ledger assigns —
        so one map_fun body serves both input modes.  ``ingest_opts``
        (``decode=``, ``readers=``, ``verify=``, ...) configure the
        pipeline and are DIRECT-only; see :meth:`get_ingest_feed`.
        """
        if self._config.input_mode == "direct":
            return self.get_ingest_feed(
                train_mode=train_mode, qname_in=qname_in, qname_out=qname_out,
                input_mapping=input_mapping, **ingest_opts)
        if ingest_opts:
            raise TypeError(
                f"ingest options {sorted(ingest_opts)} need InputMode.DIRECT "
                "(alias TENSORFLOW); this cluster runs InputMode.STREAMING "
                "(alias SPARK), whose feed carries driver-streamed rows")
        return DataFeed(self.queues, train_mode, qname_in, qname_out, input_mapping,
                        stop_event=self.stop_requested)

    def get_ingest_feed(
        self,
        train_mode: bool = True,
        qname_in: str = "input",
        qname_out: str = "output",
        input_mapping: dict | None = None,
        readers: int | None = None,
        decode=None,
        chunk_records: int = 256,
        verify: bool = True,
        prefetch: int | None = None,
        autotune: bool | None = None,
        zerocopy=None,
        schema=None,
        binary_features=None,
    ):
        """DIRECT-mode feed: shard paths (or sub-shard spans) in, decoded
        record batches out.

        Records from plain shards are zero-copy ``memoryview`` slices by
        default (``zerocopy`` overrides ``TOS_INGEST_ZEROCOPY``; views are
        valid until their batch retires — see the ``IngestFeed`` decode
        contract).  ``decode`` runs per record inside the reader threads
        and ALWAYS receives ``bytes`` — the pre-existing contract (e.g.
        ``lambda rec: dfutil.from_example(rec, schema)``); ``None`` yields
        the raw payloads.  ``schema`` (a ``dfutil.Schema``)
        switches to COLUMNAR Example decode instead: batches arrive as
        ``{column: ndarray-view}`` dicts materialized from contiguous
        column buffers in the reader pool (mutually exclusive with
        ``decode``).  ``readers``/``prefetch``/``autotune`` override the
        ``TOS_INGEST_*`` knobs; ``verify=False`` skips CRC checks for
        trusted local data.
        """
        from tensorflowonspark_torch.ingest import IngestFeed

        return IngestFeed(
            self.queues, train_mode, qname_in, qname_out, input_mapping,
            stop_event=self.stop_requested, readers=readers, decode=decode,
            chunk_records=chunk_records, verify=verify, prefetch=prefetch,
            autotune=autotune, zerocopy=zerocopy, schema=schema,
            binary_features=binary_features)

    def job_manifest(self) -> dict:
        """The driver-published description of the current DIRECT-mode feed
        (shard/partition/epoch counts — what ``cluster.train(path)``
        enumerated), for map_funs that want progress denominators.  Empty
        until a DIRECT train publishes one."""
        return self._client.manifest()

    # -- path plumbing -------------------------------------------------------

    def absolute_path(self, path: str) -> str:
        """Reference: ``TFNode.hdfs_path(ctx, path)`` (``TFNode.py:~30-70``)."""
        return _paths.absolute_path(path, self.default_fs, self.working_dir)

    # -- mesh / SPMD ---------------------------------------------------------

    def make_mesh(self, device=None, **axis_sizes: int):
        """A named ``DeviceMesh`` over the ``torch.distributed`` world
        (``run(torch_distributed=True)`` forms it, one device per node
        process), or over this process's device alone without one — the
        JAX package's ``parallel.mesh.make_mesh``.  ``device`` as
        ``parallel.mesh.make_mesh`` takes it (default ``cuda``)."""
        from tensorflowonspark_torch.parallel.mesh import make_mesh

        return make_mesh(device, **axis_sizes)

    # -- global consensus (sync SPMD end-of-data, SURVEY.md §7.3-1) ----------

    @property
    def num_data_nodes(self) -> int:
        """Nodes that participate in the trainer data plane — everything but
        the evaluator sidecar and the data-service (ingest) tier, which
        never joins trainer consensus/collectives."""
        return sum(1 for m in self.cluster_info
                   if m["job_name"] not in ("evaluator", "ingest"))

    def all_done(self, done: bool, timeout: float = 300.0) -> bool:
        """Control-plane all-reduce: True only when *every* data node is done.

        Sync data-parallel training cannot let one host run out of data early
        (SURVEY.md §5.8-3); call this each epoch/partition boundary.  Scoped
        to data nodes — the evaluator never sees the feed and must not be
        counted, or the reduce would deadlock.
        """
        name = self._client.next_collective_name("all_done")
        return bool(self._client.reduce(name, bool(done), kind="all", timeout=timeout,
                                        count=self.num_data_nodes))

    def all_done_begin(self, done: bool, timeout: float = 300.0):
        """Pipelined ``all_done``: vote now, read the result later via the
        returned zero-arg callable.

        The per-step end-of-data consensus would otherwise cost one blocking
        control-plane RTT per global step (VERDICT r4 weak #2); with the
        pipelined form an *active* host votes, runs its training step while
        the rendezvous resolves, and reads the result at the top of the next
        round.  Votes MUST stay one-per-round on every host (same generation
        sequence as ``all_done`` — the two share a name counter, so hosts
        may mix sync and pipelined calls freely as long as each host makes
        exactly one per round).  Runs on a dedicated coordinator connection
        so a pending vote never blocks heartbeats/update_meta/barriers."""
        if self._cons_pending:
            # The previous pipelined vote was abandoned un-resolved (an
            # exception skipped its result() call): its reply is unread and
            # the connection lock is still held — drop the connection and
            # start fresh rather than self-deadlocking on acquire.  The
            # abandoned generation will surface as a peer-side timeout.
            self._reset_consensus_client()
        name = self._client.next_collective_name("all_done")
        finish = self._consensus_client().reduce_begin(
            name, bool(done), kind="all", timeout=timeout,
            count=self.num_data_nodes)
        self._cons_pending = True

        def result() -> bool:
            out = bool(finish())
            self._cons_pending = False
            return out

        return result

    def _consensus_client(self):
        """Lazy dedicated connection for the end-of-data consensus (its
        pipelined votes hold the client lock from begin to finish)."""
        if self._cons_client is None:
            self._cons_client = CoordinatorClient(self._config.coordinator_addr,
                                                  authkey=self._config.authkey)
            self._cons_client.set_identity(self.executor_id, self.incarnation)
        return self._cons_client

    def _reset_consensus_client(self) -> None:
        """Drop the consensus connection (e.g. a pipelined vote was
        abandoned mid-flight, leaving an unread reply on the socket)."""
        if self._cons_client is not None:
            try:
                self._cons_client._sock.close()
            except OSError:  # toslint: allow-silent(best-effort close of an already-abandoned socket)
                pass
            self._cons_client = None
        self._cons_pending = False

    # -- cross-host collectives (tensor plane over the cluster wire) ---------

    def collective_group(self, name: str = "train", world: int | None = None,
                         timeout: float | None = None):
        """Handle for cluster-wide tensor collectives (ring all-reduce /
        broadcast / all-gather on numpy arrays, and trees of tensors through
        ``all_reduce_tree``) — the gradient-exchange plane of
        ``cluster.train(..., mode="sync")``.

        Call :meth:`~tensorflowonspark_torch.collective.CollectiveGroup.form`
        before the first collective; on a supervised restart pass the
        restored checkpoint step so the group's ``sync_state`` can level
        everyone (``ctx.is_restart`` is the cue).  ``world`` defaults to
        the data nodes (the evaluator sidecar never joins collectives —
        same exclusion as ``all_done``/``barrier(group='data')``).  Peer
        traffic rides each node's registered data-plane port; the
        rendezvous and generation barriers ride a dedicated coordinator
        connection, so incarnation fencing applies end to end.
        """
        from tensorflowonspark_torch.collective import CollectiveGroup

        me = next((m for m in self.cluster_info
                   if m["executor_id"] == self.executor_id), None)
        if me is None or not me.get("data_port"):
            raise RuntimeError(
                "this node has no registered data_port; collective groups "
                "ride the data-plane wire and need one")
        return CollectiveGroup(
            coordinator_addr=self._config.coordinator_addr,
            authkey=self._config.authkey,
            executor_id=self.executor_id,
            world=int(world) if world else self.num_data_nodes,
            host=me["host"], data_port=int(me["data_port"]),
            name=name, incarnation=self.incarnation, timeout=timeout)

    def any_done(self, done: bool, timeout: float = 300.0) -> bool:
        name = self._client.next_collective_name("any_done")
        return bool(self._client.reduce(name, bool(done), kind="any", timeout=timeout,
                                        count=self.num_data_nodes))

    def barrier(self, name: str = "user", timeout: float = 300.0, group: str = "all") -> None:
        """Block until all participants arrive; ``group='data'`` excludes the
        evaluator (use it in code paths the evaluator never runs)."""
        count = self.num_data_nodes if group == "data" else None
        self._client.barrier(f"{name}:{_next_barrier_id()}", self.executor_id, timeout, count=count)

    def update_meta(self, patch: dict) -> None:
        """Publish metadata to the driver's ``cluster_info`` view (the same
        channel the TensorBoard URL uses) — e.g. device facts or results a
        test/driver wants to observe after shutdown."""
        self._client.update_meta(self.executor_id, patch)

    # -- telemetry -----------------------------------------------------------

    @property
    def metrics(self):
        """This process's telemetry registry — the ``map_fun``-facing metrics
        surface.  Anything recorded here rides the heartbeat piggyback into
        ``cluster.metrics()`` / the run report, e.g.::

            ctx.metrics.gauge("train.steps_per_sec").set(rate)
            ctx.metrics.counter("train.samples").inc(n)
            with ctx.metrics.timed("train.step_secs"): ...
        """
        from tensorflowonspark_torch import telemetry

        return telemetry.get_registry()


_barrier_counter = [0]


def _next_barrier_id() -> int:
    _barrier_counter[0] += 1
    return _barrier_counter[0]


def _start_tensorboard(log_dir: str) -> tuple[subprocess.Popen | None, str | None]:
    """Spawn TensorBoard on a free port (reference ``TFSparkNode.py:~300-330``)."""
    try:
        from tensorflowonspark_torch.utils.net import find_free_port

        port = find_free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tensorboard.main", "--logdir", log_dir,
             "--port", str(port), "--bind_all"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        return proc, f"http://{local_ip()}:{port}"
    except Exception:
        logger.warning("could not launch tensorboard", exc_info=True)
        return None, None


def _distributed_backend(tf_args) -> str:
    """``gloo`` when the map_fun's args ask for the CPU (``device="cpu"``),
    else ``nccl``: the node's device is the CUDA card unless the caller
    asks otherwise."""
    device = (tf_args.get("device") if isinstance(tf_args, dict)
              else getattr(tf_args, "device", None))
    return "gloo" if str(device or "cuda").startswith("cpu") else "nccl"


def _init_process_group(init_method: str, rank: int, world_size: int,
                        backend: str, timeout: float) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torch_distributed on the card needs a CUDA device and this "
                "node has none; pass device='cpu' in the map_fun's args for "
                "a gloo process group on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    logger.info("torch.distributed: rank %d of %d, backend %s, %s", rank,
                world_size, backend, init_method)


def _destroy_process_group() -> None:
    if "torch.distributed" not in sys.modules:
        return
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _ingest_worker(tf_args, ctx) -> None:
    """The data-service worker loop, then this process's CUDA state for the
    driver to read: an ingest worker never initialises CUDA."""
    from tensorflowonspark_torch.ingest.service import ingest_worker_main

    try:
        ingest_worker_main(tf_args, ctx)
    finally:
        torch = sys.modules.get("torch")
        try:
            ctx._client.update_meta(ctx.executor_id, {
                "cuda_initialized": bool(torch is not None
                                         and torch.cuda.is_initialized()),
                "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")})
        except Exception:
            logger.debug("could not report the ingest worker's CUDA state",
                         exc_info=True)


def node_main(config: NodeConfig) -> int:
    """Entry point of one node process; returns a process exit code."""
    for k, v in config.env.items():
        os.environ[k] = v
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [node %(process)d] %(name)s: %(message)s",
        force=True,
    )
    from tensorflowonspark_torch import faultinject

    # Chaos hooks arm only AFTER per-node env landed (per_node_env is how a
    # test makes exactly one node of a cluster misbehave).
    faultinject.init_from_env(force=True)

    client = CoordinatorClient(config.coordinator_addr, authkey=config.authkey)
    queues = FeedQueues(config.queues, config.queue_capacity)
    server = DataServer(queues, config.authkey, config.feed_timeout)
    data_port = server.start()

    from tensorflowonspark_torch import gpu_info

    # In distributed mode register a placeholder and fill in the real device
    # facts (with this process's rank) via update_meta right after
    # init_process_group, as the JAX package does around its initialize.  A
    # process that may become an ingest worker registers a placeholder too
    # (reading the device facts would initialise CUDA before the role is
    # known).
    if config.torch_distributed:
        device_meta = {"platform": "pending_distributed_init"}
    elif config.ingest_tier:
        device_meta = {"platform": "pending_role"}
    else:
        device_meta = gpu_info.device_summary()
    ident = client.register({"host": local_ip(), "data_port": data_port,
                             "pid": os.getpid(), "device": device_meta,
                             "launch_index": config.launch_index},
                            replace=(config.replace_executor_id
                                     if config.replace_executor_id >= 0 else None))
    executor_id = ident["executor_id"]
    incarnation = int(ident.get("incarnation", 0))
    # Every control-plane message from here carries this identity, so a
    # zombie predecessor of this slot (or this process, once IT is declared
    # dead) is fenced by the coordinator instead of racing its replacement.
    client.set_identity(executor_id, incarnation)
    # chaos identity includes the assigned ROLE: `role=ingest` filters let
    # a cluster-wide TOS_FAULTINJECT spec target exactly the data-service
    # tier even though role assignment is registration-order
    faultinject.set_identity(executor_id, incarnation,
                             role=ident["job_name"])
    if config.ingest_tier and not config.torch_distributed:
        if ident["job_name"] == "ingest":
            # before anything in this process initialises CUDA: the worker
            # decodes on host cores and must not hold a context on the card
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
        client.update_meta(executor_id, {"device": gpu_info.device_summary()})
    if config.log_dir:
        # chaos-kill postmortem: a `kill` fault dumps this process's flight
        # recorder (recent spans + events) next to the job logs before the
        # SIGKILL — the one record of the node's last seconds that survives
        faultinject.set_flight_dump(
            os.path.join(config.log_dir, f"flight_node{executor_id}.json"),
            node=f"node{executor_id}")
    cluster_info = client.await_cluster(timeout=config.reservation_timeout)

    # Heartbeats must start IMMEDIATELY after registration — before
    # torch.distributed.init_process_group and before map_fun's first kernel
    # builds (nvcc, seconds to minutes on a fresh machine): the driver's dead-node monitor flags any node
    # silent past its window, and a healthy-but-compiling node must never
    # look dead.  Own connection: the main client's socket can be tied up
    # for minutes inside a blocking barrier/reduce, which would starve
    # liveness pings and block the driver's stop signal.
    stop_requested = threading.Event()

    def _heartbeat_loop() -> None:
        nonlocal incarnation
        from tensorflowonspark_torch import telemetry
        from tensorflowonspark_torch.telemetry import trace as ttrace
        from tensorflowonspark_torch.utils.envtune import env_float

        # Heartbeats are load-bearing for liveness (the driver's monitor
        # flags silent nodes dead) AND for the client-side SELF-FENCE
        # (ISSUE 13): a node that cannot reach the coordinator for longer
        # than TOS_COORDINATOR_GRACE_SECS must not keep computing as a
        # zombie — once the driver's death-declaration window expires, a
        # replacement may own this slot, and split-brain writes (outputs,
        # checkpoints) are exactly what incarnation fencing exists to
        # prevent.  Timeline on sustained silence:
        #   0 .. grace      — redial every interval (a supervised
        #                     coordinator restart lands well inside this);
        #   grace ..        — PARK: the feeds stop taking new work
        #                     ("parked" queue state) until a successful
        #                     ping re-admits us (or a fenced reply says
        #                     stop, i.e. re-registration owns the slot);
        #   4 x grace       — give up: force end-of-feed and exit (the
        #                     driver is gone for good).
        # The heartbeat channel dials single-shot with a BOUNDED call
        # timeout so a blackholed (packets dropped, not refused)
        # coordinator surfaces as a timeout this loop can count, instead
        # of wedging the liveness thread forever — the zombie asymmetry
        # this satellite closes.
        grace = env_float("TOS_COORDINATOR_GRACE_SECS",
                          max(12.0, 6.0 * config.heartbeat_interval))
        tracer = ttrace.get_tracer()
        hb_client = None
        parked = False
        ever_ok = False
        last_ok = time.monotonic()
        metrics_state: dict | None = None
        while not stop_requested.is_set():
            if faultinject.drop_heartbeat():
                # Chaos hook: swallow this liveness ping (models a network
                # partition — the process lives on as a zombie the driver
                # will declare dead; incarnation fencing handles the rest).
                time.sleep(config.heartbeat_interval)
                continue
            payload: dict | None = None
            trace_payload: dict | None = None
            stop = False
            try:
                if hb_client is None:
                    hb_client = CoordinatorClient(
                        config.coordinator_addr, authkey=config.authkey,
                        connect_timeout=3.0, connect_attempts=1,
                        call_timeout=max(5.0, min(grace, 15.0)))
                    hb_client.set_identity(executor_id, incarnation)
                # Compact telemetry delta piggybacks on the ping (absolute
                # cumulative values, changed keys only): the cluster metrics
                # transport costs zero extra round-trips, and a delta lost
                # with a failed ping is re-sent implicitly by the next one.
                # The trace delta (new spans + flight events, stamped with
                # the current clock-offset estimate) rides the same ping.
                if telemetry.enabled():
                    payload, metrics_state = telemetry.collect_changed(
                        metrics_state)
                trace_payload = tracer.collect_delta()
                stop = hb_client.heartbeat(executor_id,
                                           metrics=payload or None,
                                           trace=trace_payload)
                # feed the round-trip's clock estimate back to the tracer
                # (best-RTT midpoint wins; used by export + flight dumps)
                if hb_client.last_clock_offset is not None:
                    tracer.note_clock(hb_client.last_clock_offset,
                                      hb_client.last_rtt)
                ever_ok = True
                last_ok = time.monotonic()
                if hb_client.incarnation != incarnation:
                    # READMITTED after a gray-failure eviction: the
                    # coordinator handed this channel the slot's bumped
                    # incarnation.  Propagate to the process's other
                    # identity holders NOW — the main client may sit idle
                    # for minutes (its next round-trip would also relearn),
                    # and faultinject keys per-incarnation arming off it.
                    incarnation = hb_client.incarnation
                    client.set_identity(executor_id, incarnation)
                    faultinject.set_identity(executor_id, incarnation,
                                             role=ident["job_name"])
                    logger.warning("node %d adopted incarnation %d after "
                                   "readmission", executor_id, incarnation)
                if hb_client.last_evicted:
                    # EVICTED from the collective group at quorum (gray
                    # failure): park — no new ledger work while benched;
                    # keep heartbeating (the pings ARE the probation
                    # health probe the coordinator readmits on).
                    if not parked:
                        parked = True
                        queues.compare_and_set("state", "running", "parked")
                        ttrace.event("evicted_parked", executor=executor_id)
                        logger.warning(
                            "node %d evicted from its collective group "
                            "(quorum of straggler-suspicion votes); parked "
                            "in probation until readmitted", executor_id)
                elif parked:
                    # re-admitted: the coordinator (possibly a journal-
                    # recovered one at a bumped epoch, possibly after an
                    # eviction probation) answered our ping without fencing
                    # or benching us — resume taking ledger work.
                    # compare_and_set: a feed that TERMINATED while parked
                    # keeps its fast-drain state (stop beats park).
                    parked = False
                    queues.compare_and_set("state", "parked", "running")
                    ttrace.event("readmit", executor=executor_id)
                    logger.warning("coordinator re-admitted node %d; "
                                   "unparked", executor_id)
            except Exception:
                # the delta that rode the failed ping may be lost: drop the
                # dedupe state so the next successful ping re-sends a full
                # snapshot (values are absolute — re-sending is idempotent),
                # give the drained span samples back to their outboxes, and
                # give the trace delta back to the tracer — spans/flight
                # events are the parts of a delta that are NOT re-derivable
                metrics_state = None
                if payload:
                    telemetry.get_registry().restore_recent(payload)
                tracer.restore_delta(trace_payload)
                if hb_client is not None:
                    try:
                        hb_client.close()
                    except OSError:  # toslint: allow-silent(socket already dead; a fresh dial follows)
                        pass
                    hb_client = None
                silent = time.monotonic() - last_ok
                # a channel that NEVER connected fails fast at one grace —
                # the driver's monitor declares this node dead at
                # TOS_DEAD_NODE_TIMEOUT with a generic death error, so the
                # specific report below must beat the 4x-grace ladder
                # (riding out a coordinator restart window still fits: the
                # supervisor backoff is well under one grace)
                give_up_at = grace if not ever_ok else 4.0 * grace
                if silent > give_up_at:
                    logger.error(
                        "coordinator unreachable for %.0fs (budget %.0fs, "
                        "TOS_COORDINATOR_GRACE_SECS=%.0fs); forcing "
                        "end-of-feed", silent, give_up_at, grace)
                    if not ever_ok:
                        # never had a liveness channel at all: a clean exit
                        # would deregister and silently drop this node's
                        # partitions — report through the main client
                        # (thread-safe) so train()/shutdown() raise
                        try:
                            client.report_error(
                                executor_id,
                                "heartbeat channel never connected; node "
                                "cannot participate in liveness tracking")
                        except Exception:
                            logger.debug("could not deliver the heartbeat-"
                                         "channel failure report either",
                                         exc_info=True)
                    _enter_stop_state()
                    return
                if not parked and silent > grace:
                    # SELF-FENCE: past the grace the driver has (or soon
                    # will have) declared us dead and re-fed our work —
                    # stop accepting new ledger work and park until a
                    # heartbeat round-trip re-admits (or fences) us.
                    # compare_and_set: never clobber a 'terminating' feed's
                    # fast-drain state — a stopped node has nothing to fence.
                    parked = True
                    queues.compare_and_set("state", "running", "parked")
                    ttrace.event("self_fence", executor=executor_id,
                                 silent_secs=round(silent, 1))
                    logger.warning(
                        "coordinator unreachable for %.1fs (> "
                        "TOS_COORDINATOR_GRACE_SECS=%.0fs); node %d "
                        "self-fenced: parked, no new ledger work until "
                        "re-admitted", silent, grace, executor_id)
            if stop:
                # Driver asked us to stop: unblock any DataFeed consumer so
                # map_fun can exit (zombie-free teardown, SURVEY.md §7.3-5).
                _enter_stop_state()
                return
            time.sleep(config.heartbeat_interval)

    def _enter_stop_state() -> None:
        from tensorflowonspark_torch.dataserver import _force_put

        stop_requested.set()
        # fast-drain: in-flight and future driver feed puts return
        # "terminating" instead of blocking on a consumer that may be
        # wedged in user code (never in the feed again)
        queues.set("state", "terminating")
        for qname in config.input_qnames:
            _force_put(queues.get_queue(qname), EndOfFeed())

    hb = threading.Thread(target=_heartbeat_loop, daemon=True, name="heartbeat")
    hb.start()

    tb_proc = None
    # The chief is always executor 0 whatever its role is named (master_node
    # lets users rename it), so key on id, not on the name.
    if config.tensorboard and executor_id == 0 and config.log_dir:
        tb_proc, tb_url = _start_tensorboard(config.log_dir)
        if tb_url:
            client.update_meta(executor_id, {"tb_url": tb_url})

    if config.torch_distributed and ident["job_name"] not in ("evaluator",
                                                              "ingest"):
        # Multi-process torch world: one rank per data node.  The chief
        # picks a free port on its own host and distributes it through a
        # control-plane max-reduce (everyone else contributes -1), so no node
        # guesses at unreserved ports (SURVEY.md §5.2 race class).
        #
        # DATA NODES ONLY: the evaluator is a sidecar excluded from every
        # collective by design (consensus, barriers, and the process group's
        # collectives: an evaluator inside the group would deadlock them).
        # Role assignment puts the evaluator last, so data nodes are the
        # contiguous ids 0..N_data-1 that the process group's ranks need.
        from tensorflowonspark_torch.utils.net import bound_socket

        num_data = sum(1 for m in cluster_info
                       if m["job_name"] not in ("evaluator", "ingest"))
        # The chief HOLDS the port bound through the whole reduce (the long,
        # unbounded wait for peers) and releases it only at handoff to the
        # process group's TCP store, which rank 0 binds next — no
        # bind-then-release window a concurrent process could squat in
        # (SURVEY.md §5.2 race class; SO_REUSEADDR lets the store re-bind
        # immediately).
        sock = bound_socket() if executor_id == 0 else None
        port = sock.getsockname()[1] if sock is not None else -1
        port = int(client.reduce("torch_distributed_port", port, kind="max",
                                 timeout=config.reservation_timeout,
                                 count=num_data))
        chief_host = cluster_info[0]["host"]
        if sock is not None:
            sock.close()  # handoff: rank 0's TCP store binds it next
        _init_process_group(f"tcp://{chief_host}:{port}", executor_id,
                            num_data, _distributed_backend(config.tf_args),
                            config.reservation_timeout)
        client.update_meta(executor_id, {"device": gpu_info.device_summary()})
    elif config.torch_distributed:
        # evaluator in a distributed job: no process group; report what this
        # host exposes
        client.update_meta(executor_id, {"device": gpu_info.device_summary()})

    ctx = NodeContext(
        executor_id=executor_id,
        job_name=ident["job_name"],
        task_index=ident["task_index"],
        num_executors=len(cluster_info),
        cluster_info=cluster_info,
        queues=queues,
        config=config,
        client=client,
        stop_event=stop_requested,
        incarnation=incarnation,
    )

    # Role-aware dispatch: a process the coordinator assigned the "ingest"
    # role runs the data-service worker loop instead of the user map_fun —
    # role assignment is registration-order, so the dispatch must key on
    # the ASSIGNED role, never on which config launched the process.
    if ident["job_name"] == "ingest":
        effective_map_fun = _ingest_worker
    else:
        effective_map_fun = config.map_fun

    exit_code = 0
    try:
        logger.info("node %d (%s:%d) invoking map_fun", executor_id, ident["job_name"], ident["task_index"])
        from tensorflowonspark_torch import telemetry

        with telemetry.timed("node.map_fun_secs"):
            effective_map_fun(config.tf_args, ctx)
    except Exception:
        tb = traceback.format_exc()
        logger.error("map_fun failed:\n%s", tb)
        try:
            client.report_error(executor_id, tb)
        except Exception:
            # the error still reaches the driver: the silent heartbeat
            # (no deregister follows a failed report) flags this node dead
            logger.debug("could not report map_fun failure to the "
                         "coordinator", exc_info=True)
        exit_code = 1
    finally:
        ctx.stop_requested.set()
        server.stop()
        _destroy_process_group()
        if tb_proc is not None:
            tb_proc.terminate()
        try:
            # Deliberate exit (normal completion, or error already reported
            # above): tell the driver to stop liveness-tracking this node so
            # its monitor never mistakes the exit for a death.  The final
            # telemetry snapshot rides along — metrics recorded after the
            # last heartbeat (tail batches, the map_fun span itself) must
            # still reach the driver's cluster view.
            from tensorflowonspark_torch import telemetry
            from tensorflowonspark_torch.telemetry import trace as ttrace

            # The tracer drain is single-consumer: wait for the heartbeat
            # thread (the in-run consumer) to see the stop flag before the
            # final drain, else a failed in-flight ping could restore_delta
            # AFTER collect_final and strand those spans (or rewind a ring
            # cursor mid-drain).  A wedged ping forfeits the final trace
            # rather than racing for it — metrics stay safe either way
            # (absolute values, idempotent).
            hb.join(config.heartbeat_interval + 10.0)
            final_metrics = (telemetry.collect_changed(None)[0]
                             if telemetry.enabled() else None)
            client.deregister(executor_id, metrics=final_metrics or None,
                              trace=(ttrace.collect_final()
                                     if not hb.is_alive() else None))
        except Exception:
            logger.debug("deregister failed during teardown (driver may "
                         "flag this exit as a death)", exc_info=True)
        client.close()
    return exit_code
