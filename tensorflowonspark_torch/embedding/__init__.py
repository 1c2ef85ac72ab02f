"""Sharded embedding tier: model-parallel embedding tables.

BASELINE config 4 (wide-and-deep on Criteo) stresses embedding tables too
large to replicate per host.  The reference era answered with parameter-
server sparse updates (arxiv 1605.08695 §4.4); this tier is the modern
equivalent over the landed cluster machinery: tables range-sharded by row
id across the sync-training world (``sharding.py``), a forward path that
exchanges unique-id lookup requests and gathered rows via the sparse
all-to-all collective, a backward path that exact-sums gradient rows back
to their owning shards via the sparse reduce-scatter (``table.py``), and a
serving path with shards resident on gateway replicas (``serve.py``).
Everything rides the generation-fenced collective wire, so straggler
eviction and elastic rejoin carry over unchanged.
"""

from tensorflowonspark_torch.embedding.sharding import (
    EmbeddingShard,
    ShardPlan,
    init_rows,
)
from tensorflowonspark_torch.embedding.table import ShardedTable

__all__ = ["EmbeddingShard", "ShardPlan", "ShardedTable", "init_rows"]
