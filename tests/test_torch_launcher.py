"""The port's pod launcher (``GPUPodLauncher``) on the CPU, restating the
JAX package's pod tests against it.

From ``tests/test_launcher.py``: the card-slice env, the CPU env, payload
delivery (over the ssh transport's ``Popen``: the port has no custom
transports), the ssh command line and the refusal of mismatched configs.  From ``tests/test_distributed.py``: a two-host pod
through a fake ``ssh`` on ``PATH`` that runs the remote line in a local
shell (env values with spaces survive the quoting; nothing a remote host
consumes points at loopback), and a two-host pod through
``transport="local"``.  Each pod is a gloo world of two CPU ranks that
sums over an all-reduce.  Then ``examples_torch/mnist/mnist_pod.py`` as a
two-rank pod: its first 3 losses against the JAX package's steps on the
concatenated batches.  And the card a rank binds before NCCL forms.  The pods run real node processes; each test bounds
its own wait (``reservation_timeout``, ``feed_timeout``, ``shutdown``).
"""

from __future__ import annotations

import io
import os
import pickle
import stat
import types

import numpy as np
import pytest
import torch

import tensorflowonspark_torch as tos
from tensorflowonspark_torch import cluster as tcluster
from tensorflowonspark_torch import launcher as launchermod
from tensorflowonspark_torch.launcher import GPUPodLauncher
from tensorflowonspark_torch.node import NodeConfig
from tensorflowonspark_torch.utils.net import local_ip
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

from tests import torch_mapfuns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HB = 0.5  # heartbeat interval: a node's exit waits for its heartbeat thread
WAIT = 120.0  # each pod test's bound on registration and on shutdown


def _config(**kw) -> NodeConfig:
    return NodeConfig(coordinator_addr=("127.0.0.1", 1), authkey=b"k",
                      map_fun=torch_mapfuns.noop, **kw)


class _CapturingStdin(io.BytesIO):
    def close(self):
        self.value = self.getvalue()
        super().close()


class _FakeProc:
    def __init__(self):
        self.stdin = _CapturingStdin()
        self.returncode = None

    def poll(self):
        return self.returncode


def test_pod_launcher_gpu_slice_env():
    pod = GPUPodLauncher(hosts=["host-a", "host-a"], gpu_slices=[[0, 1], [2, 3]])
    env0, env1 = pod.host_env(0), pod.host_env(1)
    assert env0["CUDA_VISIBLE_DEVICES"] == "0,1"
    assert env1["CUDA_VISIBLE_DEVICES"] == "2,3"
    # the ids number the cards as nvidia-smi does
    assert env0["CUDA_DEVICE_ORDER"] == env1["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    # each rank binds the first card of its slice
    assert env0["LOCAL_RANK"] == env1["LOCAL_RANK"] == "0"


def test_pod_launcher_cpu_env():
    pod = GPUPodLauncher(hosts=["localhost"], transport="local", platform="cpu")
    env = pod.host_env(0)
    assert env == {"CUDA_VISIBLE_DEVICES": ""}


def test_pod_launcher_transport_delivers_payload(monkeypatch):
    """The JAX test's custom transport, restated over the ssh transport's
    ``Popen``: one process per host, each fed its config on stdin with the
    torch.distributed bootstrap forced and the pod env merged."""
    spawned = []

    def fake_popen(cmd, **kw):
        proc = _FakeProc()
        spawned.append((cmd, proc))
        return proc

    monkeypatch.setattr(launchermod.subprocess, "Popen", fake_popen)
    pod = GPUPodLauncher(hosts=["h0", "h1"], env={"MY_FLAG": "1"})
    pod.launch([_config(), _config()])
    assert [cmd[3] for cmd, _ in spawned] == ["h0", "h1"]
    for cmd, proc in spawned:
        assert cmd[-2:] == ["-m", "tensorflowonspark_torch.node_entry"]
        # pod membership forces the torch.distributed bootstrap
        got = pickle.loads(proc.stdin.value)
        assert got.torch_distributed is True
        assert got.env["MY_FLAG"] == "1"
    assert pod.alive() == [0, 1]


def test_pod_launcher_refuses_an_unknown_transport():
    with pytest.raises(ValueError, match="unknown transport 'rsh'"):
        GPUPodLauncher(hosts=["h0"], transport="rsh")


def test_pod_launcher_ssh_command(monkeypatch):
    calls = []

    def fake_popen(cmd, **kw):
        calls.append(cmd)
        return _FakeProc()

    monkeypatch.setattr(launchermod.subprocess, "Popen", fake_popen)
    pod = GPUPodLauncher(hosts=["gpu-vm-0"],
                         env={"A": "1", "NCCL_DEBUG_SUBSYS": "INIT ENV"})
    pod.launch([_config()])
    (cmd,) = calls
    assert cmd[0] == "ssh"
    assert "gpu-vm-0" in cmd
    env_i = cmd.index("env")
    assert "A=1" in cmd[env_i:]
    # ssh flattens argv into one remote shell line: values with spaces must
    # arrive shell-quoted or `env` would execute 'ENV' as the command
    assert "'NCCL_DEBUG_SUBSYS=INIT ENV'" in cmd[env_i:]
    assert cmd[-1].endswith("tensorflowonspark_torch.node_entry")


def test_pod_launcher_rejects_mismatched_configs():
    pod = GPUPodLauncher(hosts=["a"])
    with pytest.raises(ValueError, match="2 configs"):
        pod.launch([_config(), _config()])


def test_pod_launcher_cannot_respawn_grow_or_resize():
    """A pod is one live ``torch.distributed`` world: no slot restarts, no
    scale-out, and the cluster refuses to resize it or to give it an
    ingest tier."""
    pod = GPUPodLauncher(hosts=["h0"])
    with pytest.raises(NotImplementedError, match="a live torch.distributed world"):
        pod.respawn(0)
    with pytest.raises(NotImplementedError, match="a live torch.distributed world"):
        pod.spawn_more([_config()])
    with pytest.raises(RuntimeError, match="GPUPodLauncher"):
        tcluster.TorchCluster.resize(types.SimpleNamespace(launcher=pod), 2)
    with pytest.raises(ValueError, match="GPUPodLauncher"):
        tos.run(torch_mapfuns.noop, num_executors=1, launcher=pod, ingest_workers=1)


def _check_two_rank_world(cluster):
    infos = [m.get("dist_check") for m in cluster.coordinator.cluster_info()]
    assert all(i is not None for i in infos), f"missing dist_check: {infos}"
    assert sorted(i["rank"] for i in infos) == [0, 1]
    for info in infos:
        assert info["world"] == 2 and info["backend"] == "gloo"
        assert info["sum"] == 3.0  # rank 0 adds 1, rank 1 adds 2
        assert info["cuda_visible_devices"] == ""  # platform="cpu" hides the cards
    # the post-init device report replaced the placeholder, with the rank
    for m in cluster.coordinator.cluster_info():
        assert m["device"]["platform"] == "cpu"
        assert m["device"]["process_index"] == m["executor_id"]


def test_pod_launcher_ssh_transport_two_hosts(tmp_path, monkeypatch):
    """Drive the REAL ssh branch end-to-end with a fake `ssh` on PATH that
    execs the remote shell line locally (`bash -c "$*"`), exactly as sshd's
    remote shell would.  Covers: argv quoting (env values with spaces),
    stdin payload delivery, per-host env composition, log routing, and the
    2-rank world."""
    shim_dir = tmp_path / "bin"
    shim_dir.mkdir()
    shim = shim_dir / "ssh"
    # argv: ssh -o BatchMode=yes <host> <tok> <tok> ...  → record, then run
    # the joined remote line through a shell (what sshd does remotely)
    shim.write_text(
        "#!/bin/bash\n"
        f'echo "$@" >> {tmp_path}/ssh_calls.log\n'
        'if [ "$1" = "-o" ]; then shift 2; fi\n'
        "host=$1; shift\n"
        'exec bash -c "$*"\n'
    )
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{shim_dir}{os.pathsep}{os.environ['PATH']}")

    spaced = "--fake_a=1 --fake_b='two words'"
    # Real ssh does NOT carry the driver's sys.path (remote hosts have their
    # own installs); ship the import path as pod env, which also covers the
    # quoting of ':'-joined values.
    pod = GPUPodLauncher(hosts=["pod-host-0", "pod-host-1"], transport="ssh",
                         platform="cpu",
                         env={"TOS_TEST_SPACES": spaced,
                              "PYTHONPATH": f"{REPO}{os.pathsep}{os.path.join(REPO, 'tests')}"})
    cluster = tcluster.run(
        torch_mapfuns.pod_probe,
        {"expect_env": {"TOS_TEST_SPACES": spaced}, "device": "cpu"},
        num_executors=2, input_mode=tcluster.InputMode.DIRECT, launcher=pod,
        log_dir=str(tmp_path / "logs"), reservation_timeout=WAIT,
        heartbeat_interval=HB)
    # Multi-host fidelity guard: nothing a remote host consumes may point at
    # loopback — the advertised coordinator address and every registered
    # host (the chief's is the process group's rendezvous) must be
    # routable, or a REAL pod (where the shim is actual sshd) could never
    # form.  (Skipped only when the box itself has no routable interface,
    # local_ip()'s documented fallback.)
    if local_ip() != "127.0.0.1":
        assert cluster.coordinator.address[0] != "127.0.0.1"
        for m in cluster.coordinator.cluster_info():
            assert m["host"] != "127.0.0.1"
    cluster.shutdown(timeout=WAIT)
    _check_two_rank_world(cluster)
    # the shim really was the transport: one call per host, BatchMode set
    calls = (tmp_path / "ssh_calls.log").read_text().strip().splitlines()
    assert len(calls) == 2
    assert {c.split()[2] for c in calls} == {"pod-host-0", "pod-host-1"}
    assert all(c.startswith("-o BatchMode=yes") for c in calls)
    # log routing: one node log per host
    for i in (0, 1):
        assert (tmp_path / "logs" / f"node_{i}.log").exists()


def test_pod_launcher_local_transport_two_hosts(tmp_path):
    """A '2-host pod' on localhost through GPUPodLauncher(transport='local'):
    the launcher composes per-host env, ships configs over stdin, forces
    torch_distributed, and the two node processes form one world — the pod
    path end-to-end minus ssh (reference: Spark executor placement,
    ``TFCluster.py:~340-360``)."""
    pod = GPUPodLauncher(hosts=["localhost", "localhost"], transport="local",
                         platform="cpu")
    cluster = tcluster.run(
        torch_mapfuns.pod_probe, {"device": "cpu"}, num_executors=2,
        input_mode=tcluster.InputMode.DIRECT, launcher=pod, log_dir=str(tmp_path),
        reservation_timeout=WAIT, heartbeat_interval=HB)
    cluster.shutdown(timeout=WAIT)
    _check_two_rank_world(cluster)


def test_mnist_pod_losses_match_one_process_on_the_global_batch(tmp_path):
    """``examples_torch/mnist/mnist_pod.py`` as a two-rank pod (the JAX
    example's widths and data: features (32, 64), dense 256, 64 rows a
    rank, 2000 samples in 8 STREAMING partitions): every rank trains on its
    own rows and the step sums the gradients, so its first 3 losses equal
    the JAX package's steps (its MNIST, ``optax.sgd(0.05, momentum=0.9)``,
    from the same initial weights) on the two ranks' batches concatenated
    (f32, 1e-5).  Every sample is fed once and the collective save commits."""
    from examples_torch.mnist import mnist_pod
    import optax

    from tensorflowonspark_torch import convert
    from tensorflowonspark_torch.checkpoint import latest_step_dir
    from tensorflowonspark_torch.models import mnist
    from tensorflowonspark_tpu.models import mnist as jmnist
    from tensorflowonspark_tpu.parallel import dp as jdp

    args = {"batch_size": 64, "model_dir": str(tmp_path / "model"), "device": "cpu",
            "out_dir": str(tmp_path), "record": 3}
    pod = GPUPodLauncher(hosts=["localhost", "localhost"], transport="local",
                         platform="cpu", env={"OMP_NUM_THREADS": "2"})
    cluster = tos.run(torch_mapfuns.mnist_pod_recorded, args, num_executors=2,
                      input_mode=tos.InputMode.STREAMING, launcher=pod,
                      log_dir=str(tmp_path / "logs"), reservation_timeout=WAIT,
                      feed_timeout=WAIT, heartbeat_interval=HB)
    try:
        cluster.train(tos.PartitionedDataset.from_iterable(
            mnist.synthetic_mnist(2000), 8), num_epochs=1)
    finally:
        cluster.shutdown(timeout=WAIT)
    reports = {m["executor_id"]: m["mnist_pod"] for m in cluster.coordinator.cluster_info()}
    assert sorted(r["rank"] for r in reports.values()) == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in reports.values())
    assert sum(r["rows"] for r in reports.values()) == 2000  # every sample once
    assert reports[0]["steps"] == reports[1]["steps"]  # lockstep
    assert reports[0]["losses"] == reports[1]["losses"]  # averaged over dp
    assert latest_step_dir(args["model_dir"]).endswith(f"step_{reports[0]['steps']}")

    # the reference: the JAX package's MNIST and step with optax.sgd(0.05,
    # momentum=0.9), from the pod's seeded initial weights, on the two
    # ranks' recorded batches concatenated
    recorded = [np.load(tmp_path / f"batches_{r}.npz") for r in (0, 1)]
    assert all(len(rec.files) == 6 for rec in recorded), "a rank took < 3 batches"
    config = mnist_pod.model_config(args)
    model = mnist.build_mnist(config)
    model.init_weights(torch.Generator().manual_seed(0))
    params = convert.torch_to_flax(model.state_dict(), config=config)["params"]
    jmodel = jmnist.build_mnist(config)
    jopt = optax.sgd(0.05, momentum=0.9)
    state = jdp.TrainState.create(params, jopt)
    step = jdp.make_train_step(jmnist.make_loss_fn(jmodel), jopt, donate=False)
    want = []
    for i in range(3):
        images = np.concatenate([rec[f"image{i}"] for rec in recorded])
        labels = np.concatenate([rec[f"label{i}"] for rec in recorded])
        state, metrics = step(state, jmnist.batch_to_arrays(list(zip(images, labels))))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(reports[0]["losses"][:3], want, rtol=0, atol=1e-5)


def test_local_rank_counts_the_ranks_of_its_host(monkeypatch):
    """Without a ``LOCAL_RANK`` from its launcher a rank binds the card of
    its index among the data nodes of its host, round robin over the cards
    it sees."""
    from tensorflowonspark_torch.node import _local_rank

    hosts = [{"host": h} for h in ("10.0.0.1", "10.0.0.2", "10.0.0.1", "10.0.0.2")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert [_local_rank(hosts, r) for r in range(4)] == [0, 0, 1, 1]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert [_local_rank(hosts, r) for r in range(4)] == [0, 0, 1, 1]
    one_host = [{"host": "10.0.0.1"}] * 3
    assert [_local_rank(one_host, r) for r in range(3)] == [0, 1, 2]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # a one-card slice
    assert [_local_rank(one_host, r) for r in range(3)] == [0, 0, 0]


@pytest.mark.parametrize("local_rank", ["0", "3"])
def test_nccl_rank_binds_the_card_mesh_device_names(monkeypatch, local_rank):
    """The card a rank binds before NCCL forms is ``parallel.mesh``'s
    ``mesh_device()``: ``cuda:<LOCAL_RANK>``."""
    import torch.distributed as dist

    from tensorflowonspark_torch.node import _init_process_group
    from tensorflowonspark_torch.parallel.mesh import mesh_device

    bound = []
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: None)
    _init_process_group("tcp://127.0.0.1:1", 0, 1, "nccl", 5.0)
    assert bound == [torch.device("cuda", int(local_rank))] == [mesh_device()]


def test_rendezvous_refuses_a_loopback_chief_across_hosts():
    """The process group's rendezvous is the chief's registered address: a
    loopback one is refused once the data nodes span hosts (no remote rank
    could reach it), and used as is on one host."""
    from tensorflowonspark_torch.node import _rendezvous_host

    one_host = [{"host": "127.0.0.1"}, {"host": "127.0.0.1"}]
    assert _rendezvous_host(one_host, 2) == "127.0.0.1"
    routable = [{"host": "10.0.0.1"}, {"host": "10.0.0.2"}]
    assert _rendezvous_host(routable, 2) == "10.0.0.1"
    # an evaluator past the data nodes does not count
    assert _rendezvous_host(one_host + [{"host": "10.0.0.9"}], 2) == "127.0.0.1"
    with pytest.raises(RuntimeError, match="loopback address 127.0.0.1"):
        _rendezvous_host([{"host": "127.0.0.1"}, {"host": "10.0.0.2"}], 2)
