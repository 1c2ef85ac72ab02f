"""Process launchers — the Spark-role replacement for process placement.

Counterpart of ``tensorflowonspark_tpu/launcher.py`` for the PyTorch / CUDA
port.  In the reference, Spark places one long-running task per executor
(``sc.parallelize(...).foreachPartition(TFSparkNode.run(...))``,
``TFCluster.py:~340-360``) and YARN/Hops provisions the hosts.  Here a
launcher backend owns process placement (SURVEY.md §7.1-4):

- ``LocalLauncher`` — N node processes on this machine via multiprocessing
  (the test/dev path, mirroring the reference's ``local-cluster[N,...]``
  test trick, SURVEY.md §4).
- ``SubprocessLauncher`` — N node processes as fresh OS subprocesses, each
  with its own environment.  Required for per-process accelerator
  visibility (``CUDA_VISIBLE_DEVICES``), where env must be in place
  *before* the child interpreter starts.
- ``GPUPodLauncher`` — placement across GPU hosts, the counterpart of the
  JAX package's ``TPUPodLauncher``: one node process per (host, card
  slice), spawned over ``ssh`` (default) or, with ``transport='local'``,
  on this machine for single-box pods and tests.
  ``gpu_info.gpu_visibility_env`` makes each process see
  exactly its card slice, and the processes form one ``torch.distributed``
  world.

``NodeConfig`` travels to the child with ``cloudpickle`` when it is
installed (so lambdas and closures work as map_funs), and otherwise with
the standard library's ``pickle``, which carries module-level map_funs by
reference; a map_fun that ``pickle`` cannot carry raises a
``PicklingError`` naming ``cloudpickle``.  Either payload loads with
``pickle.loads`` in the child.

All launchers expose the same surface consumed by ``cluster.TorchCluster``:
``launch(configs, log_dir)``, ``processes`` (handles with ``.exitcode``),
``join(timeout)``, ``alive()``, ``terminate()``.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shlex
import subprocess
import sys
import time
from typing import Sequence

import pickle

from tensorflowonspark_torch.node import NodeConfig


def dumps_config(config: NodeConfig) -> bytes:
    """Serialize a ``NodeConfig`` for a child process: ``cloudpickle`` when
    it is installed, else ``pickle`` (module-level map_funs only)."""
    try:
        import cloudpickle
    except ImportError:
        cloudpickle = None
    if cloudpickle is not None:
        return cloudpickle.dumps(config)
    try:
        return pickle.dumps(config)
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise pickle.PicklingError(
            f"cannot ship map_fun {getattr(config.map_fun, '__qualname__', config.map_fun)!r} "
            f"to a node process: without cloudpickle installed only "
            f"module-level functions travel (pickle by reference); install "
            f"cloudpickle to ship lambdas and closures ({e})") from e


def _child_entry(payload: bytes, log_path: str | None) -> None:
    """Module-level child target (picklable under the 'spawn' start method)."""
    if log_path:
        f = open(log_path, "a", buffering=1)
        os.dup2(f.fileno(), sys.stdout.fileno())
        os.dup2(f.fileno(), sys.stderr.fileno())
    config: NodeConfig = pickle.loads(payload)
    from tensorflowonspark_torch.node import node_main

    sys.exit(node_main(config))


class _RespawnMixin:
    """Shared supervised-restart scaffolding: launch-time config capture and
    the reap-then-respawn of one slot.  Subclasses provide ``_spawn_one`` and
    a ``self._procs`` list of handles exposing
    ``is_alive/terminate/kill/join``."""

    def _remember_launch(self, configs: Sequence["NodeConfig"],
                         log_dir: str | None) -> None:
        self._configs = list(configs)
        self._log_dir = log_dir

    @property
    def configs(self) -> list["NodeConfig"]:
        """The per-slot NodeConfigs of the most recent launch()."""
        return list(self._configs)

    def respawn(self, index: int, config: "NodeConfig | None" = None) -> None:
        """Replace the process at ``index`` with a fresh one (supervised
        restart path).  Reaps the predecessor FIRST — terminate, then kill —
        so a zombie (alive but fenced) can never share the slot's ports or
        accelerators with its replacement; the old handle (and its exit
        code) is dropped, keeping shutdown's exit-code audit about the
        processes that finished the job."""
        old = self._procs[index]
        if old.is_alive():
            old.terminate()
            old.join(5.0)
            if old.is_alive():
                old.kill()
        old.join(5.0)
        self._procs[index] = self._spawn_one(index, config or self._configs[index])

    def spawn_more(self, configs: Sequence["NodeConfig"]) -> None:
        """Append fresh node processes to a LIVE launch (cluster.resize
        scale-out): each config's ``launch_index`` must equal its position
        in the extended process list — the registration-time key the driver
        uses to map executor ids back to process handles."""
        for offset, config in enumerate(configs):
            expect = len(self._procs) + offset
            if config.launch_index != expect:
                raise ValueError(
                    f"spawn_more config at position {offset} has "
                    f"launch_index {config.launch_index}, expected {expect}")
        for config in configs:
            self._configs.append(config)
            try:
                self._procs.append(self._spawn_one(config.launch_index, config))
            except Exception:
                # keep _configs and _procs the same length: a later
                # spawn_more validates launch_index against len(_procs),
                # and a dangling config would desynchronize them for good
                self._configs.pop()
                raise


class LocalLauncher(_RespawnMixin):
    """Spawn node processes on the local host.

    Uses the 'spawn' start method: forking a process after JAX/XLA has
    initialized in the driver is unsafe (CUDA too), and spawn matches how real
    hosts start fresh Python processes.  ``map_fun`` travels via cloudpickle
    where installed (the same closure-shipping contract Spark gave the
    reference), else by reference through ``pickle``.

    Env caveat: ``config.env`` is applied inside ``node_main`` — after the
    child interpreter (and any site hooks) started.  Vars that must be seen
    at interpreter startup (``CUDA_VISIBLE_DEVICES`` once anything has
    initialised CUDA) need ``SubprocessLauncher``.
    """

    def __init__(self, env: dict[str, str] | None = None):
        self.env = dict(env or {})
        self._procs: list[mp.Process] = []
        self._configs: list[NodeConfig] = []
        self._log_dir: str | None = None

    def launch(self, configs: Sequence[NodeConfig], log_dir: str | None = None) -> None:
        # Re-launchable: a fresh cluster must not inherit handles of a
        # previous run (launch_index -> process mapping relies on positions
        # matching THIS launch's configs).  Leftovers still alive — e.g. a
        # prior run that raised before shutdown — are terminated, not
        # silently orphaned holding ports/accelerators.
        if any(p.is_alive() for p in self._procs):
            self.terminate()
        self._procs = []
        self._remember_launch(configs, log_dir)
        for i, config in enumerate(configs):
            config.env = {**self.env, **config.env}
            self._procs.append(self._spawn_one(i, config))

    def _spawn_one(self, i: int, config: NodeConfig) -> mp.Process:
        ctx = mp.get_context("spawn")
        log_path = os.path.join(self._log_dir, f"node_{i}.log") if self._log_dir else None
        payload = dumps_config(config)
        p = ctx.Process(target=_child_entry, args=(payload, log_path), name=f"torch-node-{i}")
        p.daemon = False
        p.start()
        return p

    @property
    def processes(self) -> list[mp.Process]:
        return list(self._procs)

    def join(self, timeout: float | None = None) -> bool:
        """Join all node processes; True if all exited within the timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in self._procs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            p.join(remaining)
        return all(p.exitcode is not None for p in self._procs)

    def alive(self) -> list[int]:
        return [i for i, p in enumerate(self._procs) if p.is_alive()]

    def terminate(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()


class PopenHandle:
    """Adapt ``subprocess.Popen`` to the ``mp.Process``-ish handle surface
    (``exitcode``/``is_alive``/``join``/``terminate``/``kill``) that
    ``TorchCluster.shutdown`` consumes."""

    def __init__(self, proc: subprocess.Popen):
        self.proc = proc

    @property
    def pid(self) -> int:
        return self.proc.pid

    @property
    def exitcode(self) -> int | None:
        return self.proc.poll()

    def is_alive(self) -> bool:
        return self.proc.poll() is None

    def join(self, timeout: float | None = None) -> None:
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:  # toslint: allow-silent(mp.Process.join contract: a timed-out join returns with the process still alive)
            pass

    def terminate(self) -> None:
        if self.is_alive():
            self.proc.terminate()

    def kill(self) -> None:
        if self.is_alive():
            self.proc.kill()


def _node_command() -> list[str]:
    """The command line that runs one node from a stdin payload.

    ``node_entry`` is a dedicated module NOT imported by the package
    ``__init__`` — running ``-m`` on a module that is also imported as a
    package attribute would execute it twice as two distinct module objects
    (runpy's 'found in sys.modules' hazard)."""
    return [sys.executable, "-m", "tensorflowonspark_torch.node_entry"]


def _pythonpath_env() -> dict[str, str]:
    """PYTHONPATH that reproduces the driver's ``sys.path`` in a fresh local
    interpreter, so cloudpickled map_funs resolve their defining modules
    (and this package itself imports from a source checkout).  The same
    contract Spark gave the reference by shipping the driver's PYTHONPATH /
    egg to executors; ``multiprocessing`` spawn does it implicitly for
    ``LocalLauncher``."""
    entries = [p for p in sys.path if p and os.path.isdir(p)]
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if pkg_parent not in entries:
        entries.append(pkg_parent)
    return {"PYTHONPATH": os.pathsep.join(entries)}


class SubprocessLauncher(_RespawnMixin):
    """Spawn node processes as fresh OS subprocesses with per-node env.

    Each child runs ``python -m tensorflowonspark_torch.node_entry`` and
    reads its pickled ``NodeConfig`` from stdin.  ``config.env`` is merged
    into the *OS-level* environment of the child, so interpreter-startup
    consumers (CUDA's device visibility) see it — the property
    ``LocalLauncher`` cannot provide.
    """

    def __init__(self, env: dict[str, str] | None = None):
        self.env = dict(env or {})
        self._procs: list[PopenHandle] = []
        self._configs: list[NodeConfig] = []
        self._log_dir: str | None = None

    def launch(self, configs: Sequence[NodeConfig], log_dir: str | None = None) -> None:
        if any(p.is_alive() for p in self._procs):
            self.terminate()  # re-launchable (see LocalLauncher.launch)
        self._procs = []
        self._remember_launch(configs, log_dir)
        for i, config in enumerate(configs):
            config.env = {**self.env, **config.env}
            self._procs.append(self._spawn_one(i, config))

    def _spawn_one(self, i: int, config: NodeConfig) -> PopenHandle:
        log_f = None
        if self._log_dir:
            log_f = open(os.path.join(self._log_dir, f"node_{i}.log"), "ab", buffering=0)
        payload = dumps_config(config)
        try:
            proc = self._popen(i, config.env, log_f)
        finally:
            if log_f is not None:
                log_f.close()  # child holds its own fd now
        proc.stdin.write(payload)
        proc.stdin.close()
        return PopenHandle(proc)

    def _popen(self, i: int, env: dict[str, str], log_f) -> subprocess.Popen:
        """Start node ``i``'s interpreter on this machine, ``env`` over the
        driver's environment, its output into ``log_f``."""
        return subprocess.Popen(
            _node_command(),
            stdin=subprocess.PIPE,
            stdout=log_f,
            stderr=subprocess.STDOUT if log_f else None,
            env={**os.environ, **_pythonpath_env(), **env},
        )

    @property
    def processes(self) -> list[PopenHandle]:
        return list(self._procs)

    def join(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for p in self._procs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            p.join(remaining)
        return all(p.exitcode is not None for p in self._procs)

    def alive(self) -> list[int]:
        return [i for i, p in enumerate(self._procs) if p.is_alive()]

    def terminate(self) -> None:
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()


class GPUPodLauncher(SubprocessLauncher):
    """Placement across GPU hosts: one node process per (host, card slice).

    ``hosts`` has one entry per process and may repeat (two processes on
    one host: ``["gpu-0", "gpu-0"]``).  Every process joins one
    ``torch.distributed`` world (``NodeConfig.torch_distributed=True`` is
    forced): NCCL across the hosts, one rank per card.

    Transports:
    - ``'ssh'`` (default): ``ssh <host> env K=V... python -m
      tensorflowonspark_torch.node_entry`` with the pickled config streamed
      over stdin.  Requires passwordless ssh and the package importable on
      the remote host (reference parity: ``TFCluster.py:~340-360`` used
      Spark's executor placement instead).
    - ``'local'``: every "host" is this machine, spawned as
      ``SubprocessLauncher`` spawns; used for single-host multi-process
      pods and for tests.

    ``gpu_slices`` optionally gives each process its card ids on its host
    (two processes splitting one host's cards: ``[[0], [1]]``); the env is
    then ``gpu_info.gpu_visibility_env`` of the slice plus ``LOCAL_RANK=0``:
    the process sees its first card as ``cuda:0`` and binds it.  Without
    slices each process sees every card of its host.  ``platform='cpu'``
    hides the cards (a gloo world of CPU ranks, as the tests run it).
    """

    def __init__(
        self,
        hosts: Sequence[str],
        transport: str = "ssh",
        env: dict[str, str] | None = None,
        gpu_slices: Sequence[Sequence[int]] | None = None,
        platform: str = "gpu",
    ):
        if transport not in ("ssh", "local"):
            raise ValueError(f"unknown transport {transport!r}: 'ssh' or 'local'")
        if gpu_slices is not None and len(gpu_slices) != len(hosts):
            raise ValueError("gpu_slices must have one entry per host")
        super().__init__(env)
        self.hosts = list(hosts)
        self.transport = transport
        self.gpu_slices = [list(s) for s in gpu_slices] if gpu_slices else None
        self.platform = platform

    def host_env(self, index: int) -> dict[str, str]:
        """The accelerator-visibility env for host ``index``."""
        from tensorflowonspark_torch import gpu_info

        env = dict(self.env)
        if self.gpu_slices is not None:
            env.update(gpu_info.gpu_visibility_env(
                self.gpu_slices[index], platform=self.platform))
            env["LOCAL_RANK"] = "0"  # the slice's first card is this rank's
        elif self.platform == "cpu":
            env.update(gpu_info.gpu_visibility_env((), platform="cpu"))
        return env

    def launch(self, configs: Sequence[NodeConfig], log_dir: str | None = None) -> None:
        if len(configs) != len(self.hosts):
            raise ValueError(
                f"pod launcher got {len(configs)} configs for {len(self.hosts)} hosts")
        for i, config in enumerate(configs):
            config.torch_distributed = True  # a pod IS a torch.distributed job
            config.env = {**self.host_env(i), **config.env}
        super().launch(configs, log_dir)

    def _popen(self, i: int, env: dict[str, str], log_f) -> subprocess.Popen:
        if self.transport == "local":
            return super()._popen(i, env, log_f)
        # ssh joins argv into ONE remote shell line, so every env value and
        # command token must be shell-quoted (NCCL_* and PYTHONPATH values
        # may hold spaces or ':'; unquoted values would also be an injection
        # hole).
        env_prefix = ["env"] + [
            shlex.quote(f"{k}={v}") for k, v in sorted(env.items())]
        remote = env_prefix + [shlex.quote(c) for c in _node_command()]
        return subprocess.Popen(
            ["ssh", "-o", "BatchMode=yes", self.hosts[i]] + remote,
            stdin=subprocess.PIPE,
            stdout=log_f,
            stderr=subprocess.STDOUT if log_f else None)

    def respawn(self, index: int, config: NodeConfig | None = None) -> None:
        """A pod is one ``torch.distributed`` job — a restarted process
        cannot rejoin the live process group, so there is nothing a per-slot
        respawn could correctly do (``cluster.run`` refuses ``elastic`` with
        this launcher up front; this guard catches direct callers)."""
        raise NotImplementedError(
            "GPUPodLauncher cannot respawn a single slot of a live "
            "torch.distributed world; relaunch the whole pod instead")

    def spawn_more(self, configs: Sequence[NodeConfig]) -> None:
        """A pod's process count is fixed by its torch.distributed world
        size; ``cluster.resize`` refuses distributed jobs up front — this
        guard catches direct callers."""
        raise NotImplementedError(
            "GPUPodLauncher cannot grow a live torch.distributed world; "
            "relaunch the pod at the new size instead")
