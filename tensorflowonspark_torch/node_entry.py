"""Child-process entry: ``python -m tensorflowonspark_torch.node_entry``.

Runs one node whose pickled ``NodeConfig`` arrives on stdin (the
SubprocessLauncher spawn contract — the analogue of the
reference's Spark-executor task entry, ``TFSparkNode.py:~200-260``).

Deliberately a leaf module that the package ``__init__`` does NOT import:
``-m`` on a module already imported as a package attribute executes its body
twice as two distinct module objects (runpy's ``found in sys.modules``
warning), which breaks class-identity checks in the child.
"""

from __future__ import annotations

import sys


def main() -> int:
    payload = sys.stdin.buffer.read()
    if not payload:
        print("tensorflowonspark_torch.node_entry: no NodeConfig on stdin",
              file=sys.stderr)
        return 2
    import pickle

    # cloudpickle's payloads load with pickle too (it imports cloudpickle's
    # helpers by reference when the payload needs them)
    config = pickle.loads(payload)
    from tensorflowonspark_torch.node import node_main

    return node_main(config)


if __name__ == "__main__":
    sys.exit(main())
