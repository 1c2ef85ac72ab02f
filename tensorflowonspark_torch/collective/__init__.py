"""Cross-host collective communication over the cluster wire.

The subsystem behind ``cluster.train(..., mode="sync")``: coordinator-
brokered group formation with generation fencing (``group.py``), ring /
naive dense collective algorithms plus the sparse (CSR) all-to-all /
reduce-scatter of the embedding tier on numpy arrays (``ops.py``), and the
peer transport that rides each node's existing zero-copy data-plane port
(``transport.py``).  See the README "Synchronous training" and "Sharded
embeddings" sections for the map_fun-level walkthroughs.
"""

from tensorflowonspark_torch.collective.group import CollectiveGroup
from tensorflowonspark_torch.collective.transport import (
    CollectiveAborted,
    pack_csr,
    unpack_csr,
)

__all__ = ["CollectiveAborted", "CollectiveGroup", "pack_csr", "unpack_csr"]
