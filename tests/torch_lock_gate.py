"""The port's lock-witness session gate.

Every ``tests/test_torch_*.py`` imports ``torch_lock_witness_gate``, a
session-scoped autouse fixture that fails the session when the witness of
``tensorflowonspark_torch.utils.locks`` recorded acquisition-order
inversions that nothing raised for: a ``TOS_LOCK_WITNESS=warn`` run only
records them (in raise mode an inversion already fails the test at its
acquire site).  The JAX package's witness has its own gate in
``tests/conftest.py``; this module imports no JAX, so the card's test file
(run with ``--noconftest``) keeps the gate too.
"""

import pytest


@pytest.fixture(scope="session", autouse=True)
def torch_lock_witness_gate():
    yield
    from tensorflowonspark_torch.utils import locks

    witness = locks.get_witness()
    if witness is not None and witness.inversions:
        pytest.fail("the port's lock witness recorded order inversions:\n"
                    + "\n".join(witness.inversions))
