"""Range-shard plans and per-node shard state for model-parallel tables.

A :class:`ShardPlan` splits one logical ``[total_rows, dim]`` table into
``world`` contiguous id ranges — the model-parallel layout of the embedding
tier.  The plan is pure data (world+1 monotone bounds, like the dense
ring's ``_segment_bounds``), travels in the job manifest published by
``cluster.train(mode="sync", embedding=...)``, and is the ONE authority on
row ownership: the forward lookup partitions unique ids by it, the sparse
reduce-scatter scatters gradient rows back by it, and the serving router
fans lookup sub-requests by it.

Row init is deterministic and range-addressable (:func:`init_rows`): rows
are generated in fixed 4096-row blocks, each from its own counter-seeded
RNG, so any ``[lo, hi)`` slice is bit-identical whether materialized as one
table in one process or as shards across a world — the property the
sharded-vs-unsharded bit-for-bit equivalence test pins.

Durability: :class:`EmbeddingShard` saves/restores through the
``checkpoint.py`` shard helpers — per-range npz files committed by atomic
rename, with restore able to REASSEMBLE any requested range from whatever
shard files cover it, so a re-shard after eviction (world W -> W-1, new
bounds) restores each new shard from the old files.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Row-init block size: init is generated per 4096-row block from a
# counter-derived seed, so shard init cost is O(range), never O(table).
ROW_INIT_BLOCK = 4096


def even_bounds(total_rows: int, world: int) -> tuple[int, ...]:
    """World+1 monotone bounds splitting ``total_rows`` ids into ``world``
    near-equal contiguous ranges (same convention as the dense ring's
    segment bounds; empty ranges are legal on tiny tables)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    return tuple((total_rows * i) // world for i in range(world + 1))


def init_rows(total_rows: int, dim: int, lo: int, hi: int, *,
              seed: int = 0, scale: float = 0.01) -> np.ndarray:
    """Deterministic rows for the id range ``[lo, hi)`` of a logical
    ``[total_rows, dim]`` table: ``normal(0, scale)`` float32, generated in
    :data:`ROW_INIT_BLOCK`-row blocks each from ``RandomState(seed', block)``
    — any slicing of the table into ranges reproduces the same bytes."""
    if not (0 <= lo <= hi <= total_rows):
        raise ValueError(f"range [{lo}, {hi}) outside table [0, {total_rows})")
    if hi == lo:
        return np.empty((0, dim), np.float32)
    first, last = lo // ROW_INIT_BLOCK, (hi - 1) // ROW_INIT_BLOCK
    pieces = []
    for block in range(first, last + 1):
        b_lo = block * ROW_INIT_BLOCK
        n = min(ROW_INIT_BLOCK, total_rows - b_lo)
        # one independent stream per block: seeds fold the caller's seed so
        # two tables with different seeds never share rows
        rng = np.random.RandomState((seed * 2654435761 + block) % (2**31 - 1))
        rows = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        pieces.append(rows[max(lo - b_lo, 0):hi - b_lo])
    return pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=0)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Immutable range-shard layout of one logical embedding table."""

    name: str
    total_rows: int
    dim: int
    bounds: tuple[int, ...]

    def __post_init__(self):
        b = tuple(int(x) for x in self.bounds)
        if len(b) < 2 or b[0] != 0 or b[-1] != self.total_rows:
            raise ValueError(
                f"bounds must run 0..total_rows ({self.total_rows}), got {b}")
        if any(b[i] > b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bounds must be monotone, got {b}")
        object.__setattr__(self, "bounds", b)

    @classmethod
    def even(cls, name: str, total_rows: int, dim: int,
             world: int) -> "ShardPlan":
        return cls(name, int(total_rows), int(dim),
                   even_bounds(int(total_rows), int(world)))

    @property
    def world(self) -> int:
        return len(self.bounds) - 1

    def range_of(self, rank: int) -> tuple[int, int]:
        return self.bounds[rank], self.bounds[rank + 1]

    def rows_of(self, rank: int) -> int:
        lo, hi = self.range_of(rank)
        return hi - lo

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning rank per id (vectorized searchsorted over the interior
        bounds — the same mapping the sparse reduce-scatter applies)."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.total_rows):
            raise ValueError(
                f"ids outside table [0, {self.total_rows}) for plan "
                f"{self.name!r}")
        return np.searchsorted(np.asarray(self.bounds[1:-1], np.int64),
                               ids, side="right")

    def partition(self, ids: np.ndarray) -> list[np.ndarray]:
        """Per-owner index arrays into ``ids`` (rank-indexed list); an owner
        with no ids gets an empty index array — the empty-partition edge the
        sparse collectives ship as zero-row frames."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        owner = self.owner_of(ids)
        return [np.flatnonzero(owner == r) for r in range(self.world)]

    def to_manifest(self) -> dict:
        """JSON-safe manifest block (``cluster.train`` publishes this under
        the sync block; nodes rebuild with :meth:`from_manifest`)."""
        return {"name": self.name, "total_rows": self.total_rows,
                "dim": self.dim, "bounds": list(self.bounds)}

    @classmethod
    def from_manifest(cls, block: dict) -> "ShardPlan":
        return cls(str(block["name"]), int(block["total_rows"]),
                   int(block["dim"]), tuple(block["bounds"]))

    def reshard(self, world: int) -> "ShardPlan":
        """The same logical table laid out over a different world — the
        eviction/serve-time path (train W != serve replica count)."""
        return ShardPlan.even(self.name, self.total_rows, self.dim, world)


class EmbeddingShard:
    """One node's resident rows ``[lo, hi)`` of a sharded table.

    Plain numpy state + plain SGD row updates: adaptive optimizers would
    need sharded slot state per row (out of scope, documented in the README
    section); the dense half of the model keeps its optax optimizer.
    """

    def __init__(self, plan: ShardPlan, rank: int, rows: np.ndarray):
        lo, hi = plan.range_of(rank)
        rows = np.ascontiguousarray(np.asarray(rows, np.float32))
        if rows.shape != (hi - lo, plan.dim):
            raise ValueError(
                f"shard rows shape {rows.shape} != expected "
                f"{(hi - lo, plan.dim)} for rank {rank} of {plan.name!r}")
        self.plan = plan
        self.rank = int(rank)
        self.lo, self.hi = lo, hi
        self.rows = rows

    @classmethod
    def create(cls, plan: ShardPlan, rank: int, *, seed: int = 0,
               scale: float = 0.01,
               zero_cols: Sequence[int] = ()) -> "EmbeddingShard":
        """Deterministically initialize this rank's range (``init_rows``).
        ``zero_cols`` zeroes the named columns after init — the fused
        wide-and-deep table keeps its wide weights (last column) zeros-init
        like the reference's linear model."""
        lo, hi = plan.range_of(rank)
        rows = init_rows(plan.total_rows, plan.dim, lo, hi,
                         seed=seed, scale=scale)
        for c in zero_cols:
            rows[:, c] = 0.0
        return cls(plan, rank, rows)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Gather rows for GLOBAL ids owned by this shard."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size and (ids.min() < self.lo or ids.max() >= self.hi):
            raise ValueError(
                f"lookup ids outside shard [{self.lo}, {self.hi})")
        return self.rows[ids - self.lo]

    def apply_grad_rows(self, ids: np.ndarray, grad_rows: np.ndarray,
                        lr: float) -> None:
        """SGD row update for exact-summed UNIQUE ids (the sparse
        reduce-scatter's output): ``rows[id] -= lr * grad``."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            return
        if ids.min() < self.lo or ids.max() >= self.hi:
            raise ValueError(
                f"grad ids outside shard [{self.lo}, {self.hi})")
        self.rows[ids - self.lo] -= np.float32(lr) * np.asarray(
            grad_rows, np.float32).reshape(ids.size, -1)

    # -- durability (checkpoint.py shard helpers) -----------------------------

    def save(self, model_dir: str, step: int) -> str:
        from tensorflowonspark_torch.checkpoint import save_embedding_shard

        return save_embedding_shard(model_dir, self.plan.name, step,
                                    self.lo, self.hi, self.rows)

    def restore(self, model_dir: str, step: int) -> None:
        """Replace this shard's rows with the checkpointed range at
        ``step`` (reassembled across old shard files if the bounds moved)."""
        from tensorflowonspark_torch.checkpoint import restore_embedding_shard

        self.rows = restore_embedding_shard(model_dir, self.plan.name, step,
                                            self.lo, self.hi, self.plan.dim)

    @classmethod
    def restore_at(cls, plan: ShardPlan, rank: int, model_dir: str,
                   step: int) -> "EmbeddingShard":
        from tensorflowonspark_torch.checkpoint import restore_embedding_shard

        lo, hi = plan.range_of(rank)
        rows = restore_embedding_shard(model_dir, plan.name, step, lo, hi,
                                       plan.dim)
        return cls(plan, rank, rows)
