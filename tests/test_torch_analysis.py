"""Unit tests for the port's copy of toslint
(``tensorflowonspark_torch/analysis``) and every checker: the cases of
``tests/test_analysis.py`` restated against the copy, with the package
name changed, and those that repeat one fixture over several modules
merged into parametrised tests (one case each).

Contract per checker: at least one fixture it FIRES on and one compliant
rewrite it stays QUIET on — so a checker that silently stops matching (an
ast refactor, a rename) fails here, not by letting rot back in.  Plus the
baseline round-trip (add finding -> baseline suppresses -> removing the
entry re-fires) and CLI determinism.
"""

from __future__ import annotations

import json
import textwrap

import pytest

from tensorflowonspark_torch.analysis import core
from tensorflowonspark_torch.utils import envtune, knobs
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

PKG = "tensorflowonspark_torch"


def lint(src: str, path: str, checker: str) -> list[core.Finding]:
    return core.analyze_source(textwrap.dedent(src), path, [checker])


# -- knob discipline ----------------------------------------------------------


def test_knob_fires_on_raw_environ_get():
    found = lint(
        """
        import os
        def f():
            return os.environ.get("TOS_FOO")
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert len(found) == 1 and "TOS_FOO" in found[0].message


def test_knob_fires_on_environ_subscript_and_module_constant():
    found = lint(
        """
        import os
        KEY = "TOS_BAR"
        def f():
            a = os.environ["TOS_FOO"]
            b = os.environ.get(KEY)
            return a, b
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert {f.anchor for f in found} == {"f@TOS_FOO", "f@TOS_BAR"}


def test_knob_quiet_on_non_tos_names_and_inside_envtune():
    quiet = lint(
        """
        import os
        def f():
            return os.environ.get("JAX_PLATFORMS")
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert quiet == []
    exempt = lint(
        """
        import os
        def env_float(name, default):
            return os.environ.get("TOS_WHATEVER")
        """, f"{PKG}/utils/envtune.py", "knob-discipline")
    assert exempt == []


def test_knob_fires_on_unregistered_helper_read():
    found = lint(
        """
        from tensorflowonspark_torch.utils.envtune import env_float
        x = env_float("TOS_NOT_A_REAL_KNOB", 1.0)
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert len(found) == 1 and "not registered" in found[0].message


def test_knob_quiet_on_registered_read_even_aliased():
    quiet = lint(
        """
        from tensorflowonspark_torch.utils.envtune import env_float as _env_float
        from tensorflowonspark_torch.utils.envtune import env_int
        a = _env_float("TOS_EOF_TIMEOUT", 20.0)
        b = env_int("TOS_MAX_RESTARTS", 2, minimum=0)
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert quiet == []


def test_knob_fires_on_dynamic_knob_name():
    found = lint(
        """
        from tensorflowonspark_torch.utils.envtune import env_float
        def f(name):
            return env_float(name, 1.0)
        """, f"{PKG}/somemod.py", "knob-discipline")
    assert len(found) == 1 and "literal" in found[0].hint


def test_knob_registry_readme_sync(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("")
    readme = tmp_path / "README.md"
    # 1) markers missing entirely
    readme.write_text("# nothing\n")
    findings = core.run_analysis(pkg, ["knob-discipline"])
    assert any(f.anchor == "<readme>@knob-table"
               and "markers missing" in f.message for f in findings)
    # 2) markers present but the table drifted
    readme.write_text(
        f"{knobs.TABLE_BEGIN}\n| stale |\n{knobs.TABLE_END}\n")
    findings = core.run_analysis(pkg, ["knob-discipline"])
    assert any(f.anchor == "<readme>@knob-table"
               and "out of sync" in f.message for f in findings)
    # 3) generated table in place -> quiet
    readme.write_text(
        f"{knobs.TABLE_BEGIN}\n{knobs.knob_table_markdown()}\n{knobs.TABLE_END}\n")
    findings = core.run_analysis(pkg, ["knob-discipline"])
    assert not any(f.anchor == "<readme>@knob-table" for f in findings)


def test_knob_registry_flags_never_read_knobs(tmp_path):
    # a tmp package that reads nothing: every registered knob is "unused"
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text("")
    findings = core.run_analysis(pkg, ["knob-discipline"])
    unused = {f.anchor.split("@", 1)[1] for f in findings
              if f.anchor.startswith("<registry>@")}
    assert unused == set(knobs.KNOBS)


# -- dial discipline ----------------------------------------------------------


def test_dial_fires_outside_net_py():
    found = lint(
        """
        import socket
        def dial(addr):
            return socket.create_connection(addr, timeout=5)
        """, f"{PKG}/somemod.py", "dial-discipline")
    assert len(found) == 1 and found[0].anchor == "dial@create_connection"


def test_dial_quiet_inside_net_py_and_on_sanctioned_dial():
    assert lint(
        """
        import socket
        def connect_with_backoff(addr):
            return socket.create_connection(addr)
        """, f"{PKG}/utils/net.py", "dial-discipline") == []
    assert lint(
        """
        from tensorflowonspark_torch.utils.net import connect_with_backoff
        def dial(addr):
            return connect_with_backoff(addr, attempts=3)
        """, f"{PKG}/somemod.py", "dial-discipline") == []


def test_dial_fires_on_raw_zerocopy_io_outside_allowed_files():
    found = lint(
        """
        def pump(sock, bufs, out):
            sock.sendmsg(bufs)
            sock.recv_into(out)
        """, f"{PKG}/somemod.py", "dial-discipline")
    assert {f.anchor for f in found} == {"pump@sendmsg", "pump@recv_into"}


@pytest.mark.parametrize("home", ["utils/net.py", "dataserver.py"])
def test_dial_quiet_on_zerocopy_io_in_net_and_dataserver(home):
    src = """
        def pump(sock, bufs, out):
            sock.sendmsg(bufs)
            sock.recv_into(out)
        """
    assert lint(src, f"{PKG}/{home}", "dial-discipline") == []


def test_dial_fires_on_collective_peer_sockets_outside_transport():
    """ISSUE 12 satellite: raw peer-to-peer collective sockets are confined
    to collective/transport.py — even the otherwise-sanctioned
    connect_with_backoff/bound_socket fire in other collective modules."""
    found = lint(
        """
        import socket
        from tensorflowonspark_torch.utils.net import (
            bound_socket,
            connect_with_backoff,
        )
        def form(addr):
            srv = bound_socket("")
            c = connect_with_backoff(addr)
            s = socket.socket()
            return srv, c, s
        """, f"{PKG}/collective/group.py", "dial-discipline")
    assert {f.anchor for f in found} == {
        "form@bound_socket", "form@connect_with_backoff", "form@socket"}
    assert all("collective/transport.py" in f.message for f in found)


def test_dial_quiet_in_collective_transport_and_on_zerocopy_io_there():
    src = """
        from tensorflowonspark_torch.utils.net import connect_with_backoff
        def dial(addr, sock, bufs, out):
            c = connect_with_backoff(addr)
            sock.sendmsg(bufs)
            sock.recv_into(out)
            return c
        """
    assert lint(src, f"{PKG}/collective/transport.py", "dial-discipline") == []


def test_dial_fires_on_ingest_peer_sockets():
    """Disaggregated-ingest satellite: worker->trainer chunk streams are
    confined to the dataserver transport homes — raw sockets (even the
    otherwise-sanctioned dial helpers) fire anywhere under ingest/."""
    found = lint(
        """
        import socket
        from tensorflowonspark_torch.utils.net import connect_with_backoff
        def forward(addr):
            c = connect_with_backoff(addr)
            s = socket.socket()
            return c, s
        """, f"{PKG}/ingest/service.py", "dial-discipline")
    assert {f.anchor for f in found} == {
        "forward@connect_with_backoff", "forward@socket"}
    assert all("transport homes" in f.message for f in found)


def test_dial_quiet_on_ingest_dataclient_forwarding():
    """The compliant shape: the forwarder speaks DataClient (dataserver.py
    owns the socket) — nothing under ingest/ fires."""
    src = """
        from tensorflowonspark_torch.dataserver import DataClient
        def forward(host, port, authkey, chunk):
            client = DataClient(host, port, authkey)
            return client.forward_chunks([chunk])
        """
    assert lint(src, f"{PKG}/ingest/service.py", "dial-discipline") == []


def test_dial_fires_on_embedding_tier_sockets():
    """ISSUE 19 satellite: the embedding tier has no wire of its own —
    raw sockets (even the sanctioned dial helpers) fire anywhere under
    embedding/; exchanges must ride the collective transport or the embed
    data-feed queue pair."""
    found = lint(
        """
        import socket
        from tensorflowonspark_torch.utils.net import connect_with_backoff
        def fetch_rows(addr):
            c = connect_with_backoff(addr)
            s = socket.socket()
            return c, s
        """, f"{PKG}/embedding/table.py", "dial-discipline")
    assert {f.anchor for f in found} == {
        "fetch_rows@connect_with_backoff", "fetch_rows@socket"}
    assert all("embedding/" in f.message for f in found)


@pytest.mark.parametrize("module", ["table.py", "serve.py"])
def test_dial_quiet_on_embedding_collective_and_feed_use(module):
    """The compliant shape: lookups ride group.sparse_all_to_all and the
    responder rides ctx.get_data_feed — nothing under embedding/ fires."""
    src = """
        def exchange(group, parts, ctx):
            got = group.sparse_all_to_all(parts)
            feed = ctx.get_data_feed(train_mode=False, qname_in="embed")
            return got, feed
        """
    assert lint(src, f"{PKG}/embedding/{module}", "dial-discipline") == []


# -- lock discipline ----------------------------------------------------------

_MIXED = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0
    def locked_inc(self):
        with self._lock:
            self.n += 1
    def unlocked_set(self):
        self.n = 5
"""


@pytest.mark.parametrize("module", [
    "cluster.py",
    # the embedding tier's modules are in the threaded set
    "embedding/table.py",
    # the collective layer joined the threaded set
    "collective/group.py", "collective/transport.py", "collective/ops.py",
    # the rollout/tenancy modules too (governor thread vs router workers;
    # batcher-owned queues)
    "serving/rollout.py", "serving/tenancy.py",
])
def test_lock_fires_on_mixed_locked_unlocked_mutation(module):
    """The classic mixed locked/unlocked mutation fixture fires in every
    module of the threaded set (``tests/test_analysis.py``'s cluster,
    embedding, collective and rollout/tenancy cases)."""
    found = lint(_MIXED, f"{PKG}/{module}", "lock-discipline")
    assert len(found) == 1
    assert found[0].anchor == "C.unlocked_set@mixed:n"
    assert "locked_inc" in found[0].message


def test_lock_quiet_outside_threaded_modules_and_when_all_locked():
    assert lint(_MIXED, f"{PKG}/models/mnist.py", "lock-discipline") == []
    assert lint(
        """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def inc(self):
                with self._lock:
                    self.n += 1
            def reset(self):
                with self._lock:
                    self.n = 0
        """, f"{PKG}/cluster.py", "lock-discipline") == []


def test_lock_fires_on_blocking_call_under_lock():
    found = lint(
        """
        import time
        class C:
            def f(self):
                with self._lock:
                    time.sleep(1.0)
        """, f"{PKG}/dataserver.py", "lock-discipline")
    assert len(found) == 1 and found[0].anchor == "C.f@block:sleep"


def test_lock_quiet_on_blocking_call_outside_lock_and_safe_joins():
    assert lint(
        """
        import time
        class C:
            def f(self):
                with self._lock:
                    x = 1
                time.sleep(1.0)
        """, f"{PKG}/dataserver.py", "lock-discipline") == []
    assert lint(
        """
        import os
        class C:
            def f(self, parts):
                with self._lock:
                    a = ",".join(parts)
                    b = os.path.join("x", "y")
                return a, b
        """, f"{PKG}/dataserver.py", "lock-discipline") == []


def test_lock_locked_suffix_means_caller_holds_the_lock():
    # the `*_locked` naming contract: its mutations count as locked...
    assert lint(
        """
        import threading
        class C:
            def inc(self):
                with self._lock:
                    self.n += 1
                    self._bump_locked()
            def _bump_locked(self):
                self.n += 1
        """, f"{PKG}/cluster.py", "lock-discipline") == []
    # ...and blocking calls in it ARE blocking-under-lock
    found = lint(
        """
        import time
        class C:
            def _wait_locked(self):
                time.sleep(0.5)
        """, f"{PKG}/cluster.py", "lock-discipline")
    assert len(found) == 1 and found[0].anchor == "C._wait_locked@block:sleep"


def test_reactor_fires_on_blocking_calls_in_callback_scope():
    found = lint(
        """
        import time
        class ServeReactor:
            def _on_readable(self, conn):
                time.sleep(0.1)
            def _sweep_deadlines(self):
                blob = recv_exact(self._sock, 8)
            def _flush_writes(self, conn):
                sendmsg_all(conn.sock, conn.wviews)
        """, f"{PKG}/serving/frontend.py", "reactor-discipline")
    assert {f.anchor for f in found} == {
        "ServeReactor._on_readable@block:sleep",
        "ServeReactor._sweep_deadlines@block:recv_exact",
        "ServeReactor._flush_writes@block:sendmsg_all"}


def test_reactor_quiet_on_exempt_methods_safe_joins_and_other_scopes():
    # __init__ (pre-publication) and stop() (caller-thread join point) are
    # the two contract exemptions; str joins and the one-shot non-blocking
    # primitives are not blocking; other files/classes are out of scope
    assert lint(
        """
        class ServeReactor:
            def __init__(self):
                self._probe_thread.join()
            def stop(self):
                self._thread.join(timeout=10.0)
            def _on_readable(self, conn):
                name = ",".join(parts)
                sent = sendmsg_some(conn.sock, conn.wviews)
        """, f"{PKG}/serving/frontend.py", "reactor-discipline") == []
    blocking_elsewhere = """
        import time
        class Helper:
            def _on_readable(self):
                time.sleep(0.1)
        """
    assert lint(blocking_elsewhere, f"{PKG}/serving/frontend.py",
                "reactor-discipline") == []  # class is not a *Reactor*
    assert lint(blocking_elsewhere.replace("Helper", "FooReactor"),
                f"{PKG}/serving/router.py", "reactor-discipline") == []


def test_dial_discipline_covers_the_reactor_frontend():
    # the frontend does raw non-blocking socket I/O, but dials and the
    # zero-copy loop primitives stay confined: a raw dial or sendmsg in
    # serving/frontend.py fires like anywhere else
    found = lint(
        """
        import socket
        class ServeReactor:
            def _reconnect(self, addr):
                return socket.create_connection(addr)
            def _flush(self, conn):
                conn.sock.sendmsg(conn.wviews)
        """, f"{PKG}/serving/frontend.py", "dial-discipline")
    assert {f.anchor for f in found} == {
        "ServeReactor._reconnect@create_connection",
        "ServeReactor._flush@sendmsg"}


def test_lock_fires_on_framing_wrapper_io_under_lock():
    # the tree's idiomatic blocking I/O goes through _send/_recv wrappers;
    # the checker must see those, not just bare socket method names
    found = lint(
        """
        class C:
            def call(self, msg):
                with self._lock:
                    _send_msg(self._sock, msg)
                    return _recv_msg(self._sock)
        """, f"{PKG}/coordinator.py", "lock-discipline")
    assert {f.anchor for f in found} == {"C.call@block:_send_msg",
                                         "C.call@block:_recv_msg"}


def test_lock_bare_annotation_is_not_a_mutation():
    assert lint(
        """
        import threading
        class C:
            def inc(self):
                with self._lock:
                    self.n += 1
            def h(self):
                self.n: int
        """, f"{PKG}/cluster.py", "lock-discipline") == []


def test_lock_closure_bodies_do_not_inherit_the_lock():
    assert lint(
        """
        import time, threading
        class C:
            def f(self):
                with self._lock:
                    def cb():
                        time.sleep(1.0)
                    self._cb = cb
        """, f"{PKG}/node.py", "lock-discipline") == []


# -- shard IO discipline ------------------------------------------------------


def test_shard_io_fires_on_raw_binary_shard_open():
    found = lint(
        """
        import gzip
        def f(shard_path, part_file):
            a = open(shard_path, "rb").read()
            b = gzip.open("data/part-00001", mode="rb").read()
            c = gzip.open(shard_path).read()   # gzip's DEFAULT mode is 'rb'
            return a, b, c
        """, f"{PKG}/somemod.py", "shard-io-discipline")
    assert len(found) == 3
    assert all("CRC" in f.message for f in found)


def test_shard_io_fires_on_path_read_bytes():
    found = lint(
        """
        from pathlib import Path
        def f(shard):
            return Path(shard).read_bytes()
        """, f"{PKG}/somemod.py", "shard-io-discipline")
    assert len(found) == 1 and "read_bytes" in found[0].anchor


def test_shard_io_fires_on_raw_shard_buffer_views():
    found = lint(
        """
        import mmap
        def f(shard_buf, shard_file):
            v = memoryview(shard_buf)[12:4096]
            m = mmap.mmap(shard_file.fileno(), 0)
            return v, m
        """, f"{PKG}/somemod.py", "shard-io-discipline")
    assert len(found) == 2
    assert all("lifetime contract" in f.message for f in found)


def test_shard_io_view_rule_confined_to_codec_homes():
    """tfrecord.py/dfutil.py own view production; ingest/ is exempt from
    the OPEN rule (it reads via the codecs) but NOT the view rule — its
    views must come from tfrecord.record_views, not ad-hoc slicing."""
    src = """
        def f(shard_buf):
            return memoryview(shard_buf)[0:100]
        """
    assert lint(src, f"{PKG}/tfrecord.py", "shard-io-discipline") == []
    assert lint(src, f"{PKG}/dfutil.py", "shard-io-discipline") == []
    assert len(lint(src, f"{PKG}/ingest/readers.py",
                    "shard-io-discipline")) == 1
    # non-shard-named buffers stay quiet everywhere (lexical heuristic)
    assert lint(
        """
        def f(frame_buf):
            return memoryview(frame_buf)[4:]
        """, f"{PKG}/somemod.py", "shard-io-discipline") == []


def test_shard_io_quiet_in_sanctioned_homes_and_on_non_shard_io():
    src = """
        def f(shard_path):
            return open(shard_path, "rb").read()
        """
    assert lint(src, f"{PKG}/tfrecord.py", "shard-io-discipline") == []
    assert lint(src, f"{PKG}/ingest/readers.py", "shard-io-discipline") == []
    quiet = lint(
        """
        def f(shard_meta, config_path, shard_out):
            a = open(shard_meta) .read()           # text mode: not a codec bypass
            b = open(config_path, "rb").read()     # binary, but not shard-named
            open(shard_out, "wb").write(b"x")      # writes are the writer's business
            return a, b
        """, f"{PKG}/somemod.py", "shard-io-discipline")
    assert quiet == []


# -- journal-write discipline (ISSUE 13) --------------------------------------


def test_journal_discipline_fires_on_stray_fsync():
    found = lint(
        """
        import os
        def persist(fd):
            os.fsync(fd)
        """, f"{PKG}/somemod.py", "journal-discipline")
    assert len(found) == 1 and "os.fsync" in found[0].message
    assert "journal.py" in found[0].hint


def test_journal_discipline_fires_on_journal_file_open():
    found = lint(
        """
        import os
        def peek(log_dir):
            a = open(log_dir + "/coordinator.journal").read()
            b = os.open(journal_path, os.O_WRONLY)
            return a, b
        """, f"{PKG}/somemod.py", "journal-discipline")
    assert {f.anchor for f in found} == {"peek@open", "peek@os.open"}


def test_journal_discipline_quiet_in_journal_py_and_on_non_journal_io():
    src = """
        import os
        def append(fd, path):
            os.write(fd, b"x")
            os.fsync(fd)
            return open(path + ".journal", "rb").read()
        """
    assert lint(src, f"{PKG}/journal.py", "journal-discipline") == []
    quiet = lint(
        """
        import os
        def f(path):
            data = open(path, "rb").read()       # not journal-named
            os.write(1, data)                    # write without fsync
            return data
        """, f"{PKG}/somemod.py", "journal-discipline")
    assert quiet == []


# -- timeout discipline (collective/) -----------------------------------------


def test_timeout_discipline_fires_on_unbounded_waits():
    found = lint(
        """
        def run(self, fut, tp, seq, cond):
            a = fut.result()
            cond.wait()
            b = tp.recv(0, seq, ("rs", 0, 0))
            return a, b
        """, f"{PKG}/collective/somemod.py", "timeout-discipline")
    assert {f.anchor for f in found} == {"run@result", "run@wait",
                                         "run@recv"}


def test_timeout_discipline_fires_on_explicit_none_timeout():
    found = lint(
        """
        def run(fut):
            return fut.result(timeout=None)
        """, f"{PKG}/collective/somemod.py", "timeout-discipline")
    assert len(found) == 1 and "result" in found[0].message


def test_timeout_discipline_quiet_on_bounded_waits_and_outside_collective():
    src = """
        def run(self, fut, tp, cond, gen, src, seq, tag, slice_):
            a = fut.result(timeout=2.0 * self._timeout + 30.0)
            cond.wait(min(0.5, remaining))
            b = tp.recv(src, seq, tag, timeout=_left(deadline))
            c = self.inbox.recv(gen, src, seq, tag, slice_)
            return a, b, c
        """
    assert lint(src, f"{PKG}/collective/somemod.py",
                "timeout-discipline") == []
    # same unbounded calls OUTSIDE collective/ are out of scope
    assert lint(
        """
        def run(fut):
            return fut.result()
        """, f"{PKG}/serving/router.py", "timeout-discipline") == []


# -- silent-except discipline -------------------------------------------------


def test_silent_except_fires():
    found = lint(
        """
        def f():
            try:
                risky()
            except ValueError:
                pass
        """, f"{PKG}/somemod.py", "silent-except")
    assert len(found) == 1 and found[0].anchor == "f@except:ValueError"


def test_silent_except_quiet_with_reasoned_pragma_only():
    assert lint(
        """
        def f():
            try:
                risky()
            except ValueError:  # toslint: allow-silent(best-effort teardown)
                pass
        """, f"{PKG}/somemod.py", "silent-except") == []
    # a reason-less pragma documents nothing and suppresses nothing
    found = lint(
        """
        def f():
            try:
                risky()
            except ValueError:  # toslint: allow-silent()
                pass
        """, f"{PKG}/somemod.py", "silent-except")
    assert len(found) == 1


def test_silent_except_quiet_when_logged_and_on_generic_disable():
    assert lint(
        """
        def f():
            try:
                risky()
            except ValueError:
                logger.debug("risky failed", exc_info=True)
        """, f"{PKG}/somemod.py", "silent-except") == []
    assert lint(
        """
        def f():
            try:
                risky()
            except ValueError:  # toslint: disable=silent-except
                pass
        """, f"{PKG}/somemod.py", "silent-except") == []


# -- trace purity -------------------------------------------------------------


def test_trace_purity_fires_on_decorated_wallclock():
    found = lint(
        """
        import time
        import jax
        @jax.jit
        def step(x):
            return x * time.time()
        """, f"{PKG}/parallel/dp.py", "trace-purity")
    assert len(found) == 1 and found[0].anchor == "step@time.time"


def test_trace_purity_fires_through_partial_decorator():
    found = lint(
        """
        import os
        from functools import partial
        import jax
        @partial(jax.jit, static_argnums=0)
        def step(n, x):
            return x if os.environ.get("TOS_X") else -x
        """, f"{PKG}/ops/xent.py", "trace-purity")
    assert any(f.anchor == "step@os.environ" for f in found)


def test_trace_purity_fires_on_wrapped_function_and_lambda():
    found = lint(
        """
        import numpy as np
        import jax
        def noisy(x):
            return x + np.random.rand()
        step = jax.jit(noisy)
        """, f"{PKG}/models/mnist.py", "trace-purity")
    assert len(found) == 1 and found[0].anchor == "noisy@numpy.random.rand"
    found = lint(
        """
        import time
        import jax
        step = jax.jit(lambda x: x * time.time())
        """, f"{PKG}/models/mnist.py", "trace-purity")
    assert len(found) == 1 and found[0].anchor == "<lambda>@time.time"


def test_trace_purity_fires_on_nonlocal_mutation():
    found = lint(
        """
        import jax
        def make_step():
            count = 0
            @jax.jit
            def step(x):
                nonlocal count
                count += 1
                return x
            return step
        """, f"{PKG}/parallel/dp.py", "trace-purity")
    assert any(f.anchor == "step@nonlocal:count" for f in found)


def test_trace_purity_stays_quiet_on_the_port():
    """``trace-purity`` is jit-specific and the port traces no jit: over the
    port's whole package it finds nothing."""
    assert core.run_analysis(checker_ids=["trace-purity"]) == []


def test_trace_purity_quiet_on_pure_jit_and_untraced_impurity():
    assert lint(
        """
        import jax
        import jax.numpy as jnp
        @jax.jit
        def step(key, x):
            return x + jax.random.normal(key, x.shape)
        """, f"{PKG}/parallel/dp.py", "trace-purity") == []
    assert lint(
        """
        import time
        def wall():
            return time.time()
        """, f"{PKG}/summary.py", "trace-purity") == []


# -- metrics discipline -------------------------------------------------------


def test_metrics_fires_on_module_level_counter_dicts():
    found = lint(
        """
        _METRICS = {}
        REQUEST_COUNTERS: dict = {}
        frame_stats = dict()
        """, f"{PKG}/somemod.py", "metrics-discipline")
    assert {f.anchor for f in found} == {
        "<module>@_METRICS", "<module>@REQUEST_COUNTERS",
        "<module>@frame_stats"}
    assert all("telemetry" in f.hint for f in found)


def test_metrics_fires_on_collections_counter_any_name():
    found = lint(
        """
        import collections
        from collections import Counter
        SEEN = collections.Counter()
        tallies = Counter()
        """, f"{PKG}/somemod.py", "metrics-discipline")
    assert {f.anchor for f in found} == {"<module>@SEEN", "<module>@tallies"}


def test_metrics_fires_on_defaultdict_store():
    found = lint(
        """
        from collections import defaultdict
        BYTE_COUNTERS = defaultdict(int)
        """, f"{PKG}/somemod.py", "metrics-discipline")
    assert len(found) == 1 and "BYTE_COUNTERS" in found[0].message


def test_metrics_quiet_on_registry_usage_and_non_metric_names():
    # the sanctioned path: metrics created through the telemetry registry
    assert lint(
        """
        from tensorflowonspark_torch import telemetry
        _TX = telemetry.counter("dataplane.tx_bytes")
        def f(n):
            _TX.inc(n)
        """, f"{PKG}/somemod.py", "metrics-discipline") == []
    # non-metric-named module dicts (registries, tables) stay quiet
    assert lint(
        """
        KNOBS = {}
        _ROUTES: dict = {}
        _barrier_counter = [0]
        def g():
            local_counters = {}
            return local_counters
        """, f"{PKG}/somemod.py", "metrics-discipline") == []


def test_metrics_quiet_inside_telemetry_package():
    assert lint(
        """
        _METRICS = {}
        """, f"{PKG}/telemetry/registry.py", "metrics-discipline") == []


def test_span_discipline_fires_on_bad_span_names():
    """Span names recorded through telemetry.trace must be dotted lowercase
    (the metric-name convention) — ad-hoc spellings fragment the merged
    trace's subsystem grouping."""
    found = lint(
        """
        from tensorflowonspark_torch.telemetry import trace as ttrace
        def f(ctx, t0):
            with ttrace.span("WireCall", parent=ctx):
                pass
            ttrace.record_span("onewordname", ctx, None, t0, 0.1)
            ttrace.record_child("serve.Reply", ctx, t0, 0.1)
        """, f"{PKG}/somemod.py", "metrics-discipline")
    assert {f.anchor for f in found} == {
        "f@span:WireCall", "f@span:onewordname", "f@span:serve.Reply"}
    assert all("dotted-lowercase" in f.hint for f in found)


def test_span_discipline_fires_on_module_level_span_buffers():
    found = lint(
        """
        import collections
        _SPANS = []
        trace_buffer = collections.deque()
        """, f"{PKG}/somemod.py", "metrics-discipline")
    assert {f.anchor for f in found} == {
        "<module>@_SPANS", "<module>@trace_buffer"}


def test_span_discipline_quiet_on_sanctioned_usage():
    # dotted-lowercase names through the tracer, and non-span containers
    assert lint(
        """
        from tensorflowonspark_torch.telemetry import trace as ttrace
        def f(ctx, t0):
            with ttrace.span("serve.wire", parent=ctx):
                pass
            ttrace.record_child("feed.partition_consume", ctx, t0, 0.1)
        def g(name, ctx, t0):
            ttrace.record_span(name, ctx, None, t0, 0.1)  # dynamic: not ours
        _ROUTES = []
        """, f"{PKG}/somemod.py", "metrics-discipline") == []
    # an unrelated .span() method is not our API (re.Match.span takes a
    # group name, not a span name) — must not fire
    assert lint(
        """
        import re
        def h(text):
            m = re.match(r"(?P<word>\\\\w+)", text)
            return m.span("word")
        """, f"{PKG}/somemod.py", "metrics-discipline") == []
    # the tracer implementation itself is exempt
    assert lint(
        """
        _SPANS = []
        """, f"{PKG}/telemetry/trace.py", "metrics-discipline") == []


# -- baseline round-trip + ids ------------------------------------------------

_VIOLATION = """
def f():
    try:
        risky()
    except ValueError:
        pass
"""


def _tmp_pkg(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent(_VIOLATION))
    return pkg


def test_baseline_round_trip(tmp_path):
    pkg = _tmp_pkg(tmp_path)
    bl = tmp_path / "baseline.json"
    findings = core.run_analysis(pkg, ["silent-except"])
    assert len(findings) == 1
    # add finding -> baseline suppresses
    refused = core.write_baseline(bl, findings)
    assert refused == []
    new, suppressed, stale = core.partition_by_baseline(
        core.run_analysis(pkg, ["silent-except"]), core.load_baseline(bl))
    assert new == [] and len(suppressed) == 1 and stale == set()
    # removing the baseline entry re-fires
    bl.write_text(json.dumps({"version": 1, "findings": []}))
    new, _, _ = core.partition_by_baseline(
        core.run_analysis(pkg, ["silent-except"]), core.load_baseline(bl))
    assert len(new) == 1


def test_baseline_refuses_knob_and_dial_classes(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent(
        """
        import os, socket
        a = os.environ.get("TOS_RAW")
        b = socket.create_connection(("h", 1))
        """))
    bl = tmp_path / "baseline.json"
    findings = core.run_analysis(pkg, ["knob-discipline", "dial-discipline"])
    refused = core.write_baseline(bl, findings)
    assert {f.checker for f in refused} == {"knob-discipline", "dial-discipline"}
    assert not any(
        fid.startswith(("knob-discipline:", "dial-discipline:"))
        for fid in core.load_baseline(bl))


def test_finding_ids_are_line_free_and_duplicate_stable():
    src = """
    def f():
        try:
            a()
        except ValueError:
            pass
        try:
            b()
        except ValueError:
            pass
    """
    findings = lint(src, f"{PKG}/somemod.py", "silent-except")
    ids = [fid for _, fid in core.finding_ids(findings)]
    assert ids == [
        f"silent-except:{PKG}/somemod.py:f@except:ValueError",
        f"silent-except:{PKG}/somemod.py:f@except:ValueError#2",
    ]
    assert not any(str(f.line) in fid for f, fid in core.finding_ids(findings)
                   if f.line > 3)


def test_cli_baseline_update_is_deterministic(tmp_path):
    from tensorflowonspark_torch.analysis.__main__ import main

    pkg = _tmp_pkg(tmp_path)
    bl = tmp_path / "baseline.json"
    argv = ["--package-root", str(pkg), "--baseline", str(bl),
            "--baseline-update", "--checkers", "silent-except"]
    assert main(argv) == 0
    first = bl.read_bytes()
    assert main(argv) == 0
    assert bl.read_bytes() == first
    assert b'"version"' in first
    # and the gate now passes against that baseline
    assert main(["--package-root", str(pkg), "--baseline", str(bl),
                 "--checkers", "silent-except"]) == 0


def test_scoped_baseline_update_preserves_other_checkers_entries(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    # the file must carry a threaded-module basename for lock-discipline
    (pkg / "cluster.py").write_text(textwrap.dedent(
        """
        import time
        class C:
            def f(self):
                with self._lock:
                    time.sleep(1)
            def g(self):
                try:
                    risky()
                except ValueError:
                    pass
        """))
    bl = tmp_path / "baseline.json"
    # full update: both checkers' findings land
    core.write_baseline(bl, core.run_analysis(
        pkg, ["lock-discipline", "silent-except"]))
    assert len(core.load_baseline(bl)) == 2
    # scoped update from a silent-except-only run (which sees no lock
    # findings) must NOT drop the lock-discipline entry
    core.write_baseline(bl, core.run_analysis(pkg, ["silent-except"]),
                        replace_checkers=["silent-except"])
    kept = core.load_baseline(bl)
    assert any(fid.startswith("lock-discipline:") for fid in kept)
    assert any(fid.startswith("silent-except:") for fid in kept)
    # and a scoped update DOES trim its own checker's stale entries
    (pkg / "cluster.py").write_text("def f():\n    pass\n")
    core.write_baseline(bl, core.run_analysis(pkg, ["silent-except"]),
                        replace_checkers=["silent-except"])
    kept = core.load_baseline(bl)
    assert not any(fid.startswith("silent-except:") for fid in kept)
    assert any(fid.startswith("lock-discipline:") for fid in kept)


def test_unknown_checker_id_is_a_usage_error(tmp_path):
    from tensorflowonspark_torch.analysis.__main__ import main

    assert main(["--package-root", str(_tmp_pkg(tmp_path)),
                 "--checkers", "nope"]) == 2


# -- envtune additions (env_str / env_bool / registry warning) ---------------


def test_env_str_passthrough_and_default(monkeypatch):
    monkeypatch.delenv("TOS_COORDINATOR_HOST", raising=False)
    assert envtune.env_str("TOS_COORDINATOR_HOST", "d") == "d"
    monkeypatch.setenv("TOS_COORDINATOR_HOST", "")
    assert envtune.env_str("TOS_COORDINATOR_HOST", "d") == ""
    monkeypatch.setenv("TOS_COORDINATOR_HOST", "10.0.0.1")
    assert envtune.env_str("TOS_COORDINATOR_HOST", "d") == "10.0.0.1"


@pytest.mark.parametrize("raw,expect", [
    ("0", False), ("false", False), ("No", False), ("off", False),
    ("1", True), ("true", True), ("YES", True), ("on", True),
    ("junk", True),  # junk degrades to the default, never flips silently
])
def test_env_bool_values(monkeypatch, raw, expect):
    monkeypatch.setenv("TOS_SHM_RING", raw)
    assert envtune.env_bool("TOS_SHM_RING", True) is expect


def test_env_bool_unset_returns_default(monkeypatch):
    monkeypatch.delenv("TOS_SHM_RING", raising=False)
    assert envtune.env_bool("TOS_SHM_RING", False) is False


def test_unregistered_knob_read_warns_once(monkeypatch, caplog):
    monkeypatch.setattr(envtune, "_unregistered_warned", set())
    with caplog.at_level("WARNING", logger="tensorflowonspark_torch.utils.envtune"):
        envtune.env_float("TOS_DEFINITELY_UNREGISTERED", 1.0)
        envtune.env_float("TOS_DEFINITELY_UNREGISTERED", 1.0)
    hits = [r for r in caplog.records if "not registered" in r.message]
    assert len(hits) == 1
    caplog.clear()
    with caplog.at_level("WARNING", logger="tensorflowonspark_torch.utils.envtune"):
        envtune.env_float("TOS_EOF_TIMEOUT", 20.0)
    assert not [r for r in caplog.records if "not registered" in r.message]


def test_every_registered_knob_has_doc_and_default():
    for k in knobs.KNOBS.values():
        assert k.doc and k.default and k.kind in {"float", "int", "str", "bool"}
    assert knobs.knob_table_markdown().splitlines()[0].startswith("| Knob ")


# -- lock-order (tossan static half, ISSUE 17) --------------------------------


def lock_findings(files: dict[str, str]) -> list[core.Finding]:
    """Build the whole-tree lock graph over in-memory modules and return
    the lock-order findings (the checker's finalize path, unit-sized)."""
    from tensorflowonspark_torch.analysis import lockgraph

    mods = [core.ModuleSource(p, textwrap.dedent(s))
            for p, s in files.items()]
    return list(lockgraph.lock_order_findings(lockgraph.build_lockgraph(mods)))


_CYCLE_A = f"""
    from {PKG}.utils.locks import tos_named_lock
    from {PKG}.bmod import B

    class A:
        def __init__(self):
            self._lock = tos_named_lock("a._lock")
            self._b = B()

        def m(self):
            with self._lock:
                self._b.n()
    """

_CYCLE_B = f"""
    from {PKG}.utils.locks import tos_named_lock
    from {PKG}.amod import A

    class B:
        def __init__(self):
            self._lock = tos_named_lock("b._lock")
            self._a = A()

        def n(self):
            with self._lock:
                pass

        def r(self):
            with self._lock:
                self._a.m()
    """


def test_lock_order_fires_on_two_module_cycle():
    found = lock_findings({f"{PKG}/amod.py": _CYCLE_A,
                           f"{PKG}/bmod.py": _CYCLE_B})
    assert len(found) == 1
    f = found[0]
    assert f.checker == "lock-order"
    assert "potential deadlock" in f.message
    # the full witness chain names both locks and both call sites
    assert "a._lock -> b._lock" in f.message
    assert "b._lock -> a._lock" in f.message
    assert "amod.py" in f.message and "bmod.py" in f.message
    assert f.anchor == "cycle:a._lock->b._lock"


def test_lock_order_quiet_on_diamond_without_cycle():
    found = lock_findings({f"{PKG}/dmod.py": f"""
        from {PKG}.utils.locks import tos_named_lock

        class D:
            def __init__(self):
                self._a = tos_named_lock("d.a")
                self._b = tos_named_lock("d.b")
                self._c = tos_named_lock("d.c")
                self._d = tos_named_lock("d.d")

            def m1(self):
                with self._a:
                    with self._b:
                        pass

            def m2(self):
                with self._a:
                    with self._c:
                        pass

            def m3(self):
                with self._b:
                    with self._d:
                        pass

            def m4(self):
                with self._c:
                    with self._d:
                        pass
        """})
    assert found == []


def test_lock_order_pragma_with_reason_suppresses_cycle():
    b_blessed = _CYCLE_B.replace(
        "self._a.m()",
        "self._a.m()  # toslint: allow-lock-order(startup-only path, "
        "externally serialized)")
    found = lock_findings({f"{PKG}/amod.py": _CYCLE_A,
                           f"{PKG}/bmod.py": b_blessed})
    assert found == []
    # a reason-less pragma documents nothing and suppresses nothing
    b_bare = _CYCLE_B.replace("self._a.m()",
                              "self._a.m()  # toslint: allow-lock-order()")
    found = lock_findings({f"{PKG}/amod.py": _CYCLE_A,
                           f"{PKG}/bmod.py": b_bare})
    assert len(found) == 1


def test_lock_order_flags_callback_fired_under_lock():
    found = lock_findings({f"{PKG}/cbmod.py": f"""
        from {PKG}.utils.locks import tos_named_lock

        class Batcher:
            def __init__(self, on_done):
                self._lock = tos_named_lock("batcher._lock")
                self._cb = on_done

            def fire(self):
                with self._lock:
                    self._cb(1)

        class User:
            def __init__(self):
                self._lock = tos_named_lock("user._lock")
                self._batcher = Batcher(on_done=self._handle)

            def _handle(self, x):
                with self._lock:
                    pass
        """})
    assert any(f.anchor == "callback:_cb@user._lock" for f in found)
    f = next(f for f in found if f.anchor.startswith("callback:"))
    assert "batcher._lock" in f.message and "_handle" in f.message


def test_lock_order_quiet_on_callback_fired_outside_lock():
    # the batcher's _fire_done pattern: collect under the lock, invoke after
    found = lock_findings({f"{PKG}/cbmod.py": f"""
        from {PKG}.utils.locks import tos_named_lock

        class Batcher:
            def __init__(self, on_done):
                self._lock = tos_named_lock("batcher._lock")
                self._cb = on_done

            def fire(self):
                with self._lock:
                    batch = [1]
                self._cb(batch)

        class User:
            def __init__(self):
                self._lock = tos_named_lock("user._lock")
                self._batcher = Batcher(on_done=self._handle)

            def _handle(self, x):
                with self._lock:
                    pass
        """})
    assert found == []


def test_lock_order_sees_cycle_through_module_function_and_local_var():
    # interprocedural depth: a module function constructs a tree class into
    # a LOCAL and calls through it; unnamed threading.Lock attrs get
    # synthesized <module>.<Class>.<attr> node ids
    found = lock_findings({f"{PKG}/x.py": f"""
        import threading
        from {PKG}.y import helper

        class X:
            def __init__(self):
                self._lock = threading.Lock()

            def m(self):
                with self._lock:
                    helper()
        """, f"{PKG}/y.py": f"""
        import threading
        from {PKG}.x import X

        class Y:
            def __init__(self):
                self._lock = threading.Lock()

            def n(self):
                with self._lock:
                    x = X()
                    x.m()

        def helper():
            y = Y()
            y.n()
        """})
    assert len(found) == 1
    assert "x.X._lock" in found[0].message
    assert "y.Y._lock" in found[0].message


def test_lock_order_refuses_baseline(tmp_path):
    # like knob/dial classes: --baseline-update refuses lock-order findings
    assert "lock-order" in core.NEVER_BASELINE
    f = core.Finding("lock-order", f"{PKG}/amod.py", 3, "cycle", "fix",
                     "cycle:a._lock->b._lock")
    refused = core.write_baseline(tmp_path / "b.json", [f])
    assert refused == [f]
    assert core.load_baseline(tmp_path / "b.json") == set()


def test_dump_lockgraph_cli_writes_dot_and_json(tmp_path, capsys):
    from tensorflowonspark_torch.analysis.__main__ import main

    assert main(["--dump-lockgraph", str(tmp_path / "lg")]) == 0
    dot = (tmp_path / "lg" / "lockgraph.dot").read_text()
    data = json.loads((tmp_path / "lg" / "lockgraph.json").read_text())
    assert dot.startswith("digraph lockgraph")
    assert data["schema"] == "tos-lockgraph-v1"
    # the real tree's cross-module spine is in the resolved graph
    edges = {(e["from"], e["to"]) for e in data["edges"]}
    assert ("coordinator._lock", "journal._lock") in edges
    for e in data["edges"]:
        assert e["witness"], e  # every edge carries its witness chain


def test_cli_format_json_emits_machine_rows(capsys):
    from tensorflowonspark_torch.analysis.__main__ import main

    assert main(["--format=json"]) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["schema"] == "toslint-findings-v1"
    assert all(set(r) == {"checker", "path", "line", "message", "hint",
                          "id", "baselined"} for r in data["findings"])
    # a clean tree still reports its baselined findings, marked as such
    assert all(r["baselined"] for r in data["findings"])
