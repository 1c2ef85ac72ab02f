"""The port's lock-witness session gate (``tests/torch_lock_gate.py``),
pinned from the outside: a pytest session in a subprocess, under
``TOS_LOCK_WITNESS=warn``, whose one test takes two of the port's named
locks in both orders fails at the session's end and names the inversion;
the same session without the inversion passes."""

import os
import subprocess
import sys

import pytest

from torch_lock_gate import torch_lock_witness_gate  # noqa: F401 - the port's lock-witness gate

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

SESSION = """\
from torch_lock_gate import torch_lock_witness_gate  # noqa: F401
from tensorflowonspark_torch.utils.locks import tos_named_lock


def test_takes_two_locks():
    a, b = tos_named_lock("gate_test.a"), tos_named_lock("gate_test.b")
    with a:
        with b:
            pass
    if {invert}:
        with b:
            with a:
                pass
"""


@pytest.mark.parametrize("invert", [True, False])
def test_warn_mode_inversion_fails_the_session(tmp_path, invert):
    (tmp_path / "test_session.py").write_text(SESSION.format(invert=invert))
    env = {**os.environ, "TOS_LOCK_WITNESS": "warn",
           "PYTHONPATH": os.pathsep.join([REPO, TESTS])}
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:xdist",
         "-p", "no:randomly", "--rootdir", str(tmp_path), "test_session.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = res.stdout + res.stderr
    assert "1 passed" in out, out  # the test itself passes: warn mode only records
    if invert:
        assert res.returncode != 0, out
        assert "the port's lock witness recorded order inversions" in out, out
        assert "gate_test.a" in out and "gate_test.b" in out, out
    else:
        assert res.returncode == 0, out
