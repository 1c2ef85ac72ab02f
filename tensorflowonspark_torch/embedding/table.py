"""ShardedTable: the distributed lookup / sparse-update face of a shard.

One instance per training node wraps that node's :class:`EmbeddingShard`
plus the node's :class:`CollectiveGroup` and exposes exactly two data-path
operations:

``lookup(ids)``
    Forward path.  Dedups the batch's flat ids (``np.unique``, gated by
    ``TOS_EMBED_DEDUP``), partitions the unique ids by the shard plan, and
    runs TWO sparse all-to-alls: an id-request round (ids only, no rows)
    and a row-response round (each peer gathers its resident rows for the
    ids it was asked for and echoes them back).  Rows scatter back into
    unique-id order and expand through the inverse permutation — output is
    ``ids.shape + (dim,)``, exactly what a replicated-table gather would
    produce.

``apply_gradients(ids, grads, lr, scale)``
    Backward path.  Locally combines duplicate-position gradients into CSR
    form (one deterministic exact-sum kernel, ``combine_csr`` — the same
    kernel the reduce-scatter's owner side runs), sparse-reduce-scatters
    the rows to their owning shards, then each owner applies the
    world-scaled SGD row update.  Summation order is pinned (concat in
    rank order + unbuffered ``np.add.at``), which is what makes a sharded
    run bit-identical to a single-process replay of the same per-node
    batches.

With ``group=None`` (world 1) both paths degrade to purely local gathers
and updates over the full table — the reference path the equivalence test
compares against.
"""

from __future__ import annotations

import numpy as np

from tensorflowonspark_torch.collective import ops as cops
from tensorflowonspark_torch.embedding.sharding import EmbeddingShard, ShardPlan
from tensorflowonspark_torch.utils.envtune import env_bool, env_int


class ShardedTable:
    """Distributed embedding table = local shard + sparse collectives."""

    def __init__(self, shard: EmbeddingShard, group=None):
        self.shard = shard
        self.plan: ShardPlan = shard.plan
        self.group = group
        if group is not None and group.world != self.plan.world:
            raise ValueError(
                f"plan world {self.plan.world} != collective world "
                f"{group.world} — build the plan from the formed group")
        # wire accounting for the bench: ids/rows actually exchanged vs the
        # dense alternative (whole-table all-reduce) — the algorithmic
        # headline a one-core box can still demonstrate.
        self.stats = {"lookups": 0, "ids_in": 0, "ids_sent": 0,
                      "rows_fetched": 0, "grad_rows_sent": 0, "updates": 0}

    @property
    def dim(self) -> int:
        return self.plan.dim

    # -- forward ------------------------------------------------------------

    def _dedup(self, flat: np.ndarray):
        if env_bool("TOS_EMBED_DEDUP", True):
            return np.unique(flat, return_inverse=True)
        return flat, np.arange(flat.size, dtype=np.int64)

    def lookup(self, ids) -> np.ndarray:
        """Gather rows for ``ids`` (any shape) -> ``ids.shape + (dim,)``."""
        ids = np.asarray(ids, dtype=np.int64)
        flat = ids.reshape(-1)
        uniq, inv = self._dedup(flat)
        self.stats["lookups"] += 1
        self.stats["ids_in"] += int(flat.size)
        uniq_rows = self._exchange_rows(uniq)
        return uniq_rows[inv].reshape(ids.shape + (self.dim,))

    def _exchange_rows(self, uniq: np.ndarray) -> np.ndarray:
        if self.group is None or self.plan.world == 1:
            self.stats["rows_fetched"] += int(uniq.size)
            return self.shard.lookup(uniq)
        idx = self.plan.partition(uniq)
        parts = [(uniq[idx[r]], None) for r in range(self.plan.world)]
        self.stats["ids_sent"] += int(
            sum(idx[r].size for r in range(self.plan.world)
                if r != self.shard.rank))
        # round 1: who needs what (ids only) — requests[src] is the id set
        # src wants from OUR shard, all inside [lo, hi) by construction
        requests = self.group.sparse_all_to_all(parts)
        resp = [(req_ids, self.shard.lookup(req_ids))
                for req_ids, _ in requests]
        # round 2: echo ids + resident rows; responses[r] comes back in the
        # exact order we asked (peers gather in request order), so rows
        # scatter straight through the partition index arrays
        responses = self.group.sparse_all_to_all(resp)
        out = np.empty((uniq.size, self.dim), np.float32)
        for r, (_, rows) in enumerate(responses):
            out[idx[r]] = rows
        self.stats["rows_fetched"] += int(uniq.size)
        return out

    # -- backward -----------------------------------------------------------

    def apply_gradients(self, ids, grads, *, lr: float,
                        scale: float = 1.0) -> int:
        """Scatter-add gradient rows to their owning shards and apply the
        SGD update there; ``scale`` (typically ``1/world``) multiplies the
        exact cross-node sum before the ``lr`` step.  Returns the number of
        unique rows this shard updated."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        g = np.ascontiguousarray(np.asarray(grads, np.float32)).reshape(
            ids.size, self.dim)
        uniq, acc = cops.combine_csr([ids], [g], self.dim)
        if self.group is None or self.plan.world == 1:
            got_ids, got_rows = uniq, acc
        else:
            self.stats["grad_rows_sent"] += int(
                uniq.size - self.plan.partition(uniq)[self.shard.rank].size)
            got_ids, got_rows = self.group.sparse_reduce_scatter(
                uniq, acc, self.plan.bounds)
        if np.float32(scale) != np.float32(1.0):
            got_rows = got_rows * np.float32(scale)
        self.shard.apply_grad_rows(got_ids, got_rows, lr)
        self.stats["updates"] += 1
        return int(got_ids.size)

    # -- durability ---------------------------------------------------------

    def checkpoint(self, model_dir: str, step: int) -> str:
        return self.shard.save(model_dir, step)

    def maybe_checkpoint(self, model_dir: str, step: int) -> bool:
        """Checkpoint this shard every ``TOS_EMBED_CKPT_EVERY`` steps
        (0 disables — explicit ``checkpoint()`` calls only)."""
        every = env_int("TOS_EMBED_CKPT_EVERY", 0, minimum=0)
        if every <= 0 or step % every != 0:
            return False
        self.shard.save(model_dir, step)
        return True

    def restore(self, model_dir: str, step: int) -> None:
        self.shard.restore(model_dir, step)
