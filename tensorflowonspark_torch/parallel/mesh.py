"""Device mesh and sharding helpers — counterpart of
``tensorflowonspark_tpu/parallel/mesh.py``.

The JAX package names a ``jax.sharding.Mesh`` over the devices of one
program.  Here every rank of the ``torch.distributed`` world is a process
that owns one device, so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks with
the same axis names (``AXES``): ``dp`` (data parallel), ``fsdp``
(parameters sharded ZeRO-3 style), ``tp`` (Megatron tensor parallel,
``tp.py``), ``sp`` (ring / Ulysses sequence parallel, ``sp.py``), ``ep``
(expert parallel, ``ep.py``) and ``pp`` (pipeline stages, ``pp.py``).  Axes
left out have size 1.  Without a process group the mesh is the process's
own device alone (every axis 1).

Shardings are a ``Sharding`` (the mesh and a ``P`` spec: one entry per
tensor dimension, an axis name, a tuple of them or ``None``), whose
``placements`` are DTensor's ``Shard``/``Replicate`` per mesh axis.  A rank
holds its *local* shard of each tensor (``shard_tree``); the modules that
consume sharded weights (``tp.py``, ``ep.py``) issue the collectives
themselves.  A batch is each rank's own disjoint rows (``shard_batch``),
the JAX package's multi-process semantics.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")
BATCH_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named mesh layout; axes omitted at construction default to 1."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes())

    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)


class P(tuple):
    """A partition spec, the JAX package's ``PartitionSpec``: one entry per
    tensor dimension (an axis name, a tuple of axis names, or ``None``);
    trailing dimensions left out are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axis_sizes(axis_sizes: dict, n: int) -> dict:
    """``make_mesh``'s reshape rule: ``-1`` absorbs the rest, no axes at all
    put everything on ``dp``."""
    unknown = set(axis_sizes) - set(AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXES}")
    sizes = {a: int(axis_sizes.get(a, 1)) for a in AXES}
    wilds = [a for a, s in sizes.items() if s == -1]
    if len(wilds) > 1:
        raise ValueError("at most one axis may be -1")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if wilds:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes product {fixed}")
        sizes[wilds[0]] = n // fixed
    elif not axis_sizes:
        sizes["dp"] = n
    elif fixed != n:
        raise ValueError(f"mesh axes product {fixed} != device count {n}")
    return sizes


def mesh_device(device=None) -> torch.device:
    """This rank's device: the card of its local rank (``LOCAL_RANK``, as
    ``torchrun`` and ``run(torch_distributed=True)`` set it) unless the
    caller asks for the CPU; ``default_device`` raises without a card."""
    import os

    from tensorflowonspark_torch.gpu_info import default_device

    dev = default_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(device=None, **axis_sizes: int):
    """A ``DeviceMesh`` named by ``AXES`` over the ranks of the
    ``torch.distributed`` world (one device per rank, ``mesh_device``), or
    over this process alone when no process group is initialised.

    Any axis given as ``-1`` absorbs the remaining ranks; with no axes at
    all everything lands on ``dp``.  The same ``ValueError``s as the JAX
    package's for unknown axes, two wildcards and products that do not
    match.  Rank ``r`` sits at the row-major coordinate of ``r`` in the
    ``AXES`` order (``pp`` innermost), the JAX package's layout."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = mesh_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = _axis_sizes(axis_sizes, world)
    ranks = torch.arange(world, dtype=torch.int).reshape([sizes[a] for a in AXES])
    if world > 1:
        mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=AXES)
    else:  # one rank: no process group to form or ask
        mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=AXES,
                          _init_backend=False, _rank=0)
    mesh.tos_device = dev
    return mesh


def spec(mesh) -> MeshSpec:
    return MeshSpec(**dict(zip(mesh.mesh_dim_names, mesh.shape)))


def axis_size(mesh, *axes: str) -> int:
    """The product of the sizes of ``axes`` (1 without a mesh)."""
    axes = tuple(a for a in AXES if a in axes)
    if mesh is None:
        return 1
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(shape[a] for a in axes)


def axis_index(mesh, *axes: str) -> int:
    """This rank's row-major index along ``axes`` (0 without a mesh)."""
    if mesh is None:
        return 0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + coord[a]
    return idx


def device_of(mesh) -> torch.device:
    return mesh.tos_device if mesh is not None else torch.device("cpu")


_GROUPS: dict = {}


def group(mesh, *axes: str):
    """The process group of the ranks that differ from this one only along
    ``axes`` (ordered by their index along ``axes``), or ``None`` when that
    group is this rank alone.  Every rank must ask for the same groups in
    the same order (``new_subgroups_by_enumeration`` is collective); they
    are cached per mesh."""
    if mesh is None or axis_size(mesh, *axes) == 1:
        return None
    # in AXES order, the group's ranks ascend with their index along axes,
    # so a rank's place in the group is that index
    axes = tuple(a for a in AXES if a in axes)
    key = (id(mesh), axes)
    if key not in _GROUPS:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh
        order = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in order]
        flat = grid.permute(*rest, *order).reshape(-1, axis_size(mesh, *axes))
        mine, _ = dist.new_subgroups_by_enumeration(flat.tolist())
        _GROUPS[key] = (mesh, mine)  # hold the mesh so its id stays unique
    return _GROUPS[key][1]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A ``NamedSharding``: ``spec`` over ``mesh``."""

    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        """DTensor placements, one per mesh axis: ``Shard(d)`` on the axes
        that split tensor dimension ``d``, ``Replicate()`` on the rest."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in self.mesh.mesh_dim_names]
        for d, entry in enumerate(self.spec):
            for a in _entry_axes(entry):
                out[list(self.mesh.mesh_dim_names).index(a)] = Shard(d)
        return out

    def axes_of(self, dim: int) -> tuple[str, ...]:
        return _entry_axes(self.spec[dim]) if dim < len(self.spec) else ()


def batch_sharding(mesh, extra_dims: int = 0) -> Sharding:
    """A batch: the leading dim split over ``(dp, fsdp)``, the rest
    replicated."""
    return Sharding(mesh, P(BATCH_AXES, *([None] * extra_dims)))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, P())


def pick_shard_dim(shape, axis_size: int, taken=()) -> int | None:
    """Largest dim divisible by ``axis_size`` (skipping ``taken`` dims), or
    None if nothing splits evenly — the shared heuristic behind fsdp
    sharding here and ``tp.compose_fsdp``."""
    dims = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    for d in dims:
        if d in taken:
            continue
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            return d
    return None


def fsdp_shardings(mesh, tree: dict) -> dict:
    """Per-leaf shardings splitting each leaf on its largest
    fsdp-divisible dim (ZeRO-3); leaves with no such dim, scalars and
    everything on a mesh without ``fsdp`` stay replicated."""
    size = axis_size(mesh, "fsdp")

    def leaf(x) -> Sharding:
        if size == 1 or not hasattr(x, "shape") or len(x.shape) == 0:
            return replicated(mesh)
        d = pick_shard_dim(tuple(x.shape), size)
        if d is None:
            return replicated(mesh)
        entries = [None] * len(x.shape)
        entries[d] = "fsdp"
        return Sharding(mesh, P(*entries))

    return {k: leaf(x) for k, x in tree.items()}


def is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than this process."""
    return mesh is not None and mesh.mesh.numel() > 1


def local_shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``sharding``: each
    sharded dim cut into equal parts, the part at this rank's index along
    the dim's axes (several axes on one dim index row-major)."""
    out = x
    for d in range(len(x.shape)):
        axes = sharding.axes_of(d)
        n = axis_size(sharding.mesh, *axes) if axes else 1
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over "
                             f"{axes} ({n})")
        out = out.chunk(n, dim=d)[axis_index(sharding.mesh, *axes)]
    return out


def shard_tree(mesh, tree: dict, shardings: dict | None = None) -> dict:
    """Each leaf of ``{name: tensor or array}`` cut to this rank's block
    (``local_shard``) and put on the mesh's device, as fresh contiguous
    tensors.  Every rank must hold the same full value (a shared seed or
    the same checkpoint), as in the JAX package's multi-process case.
    ``shardings`` defaults to ``fsdp_shardings``."""
    shardings = shardings if shardings is not None else fsdp_shardings(mesh, tree)
    dev = device_of(mesh)
    return {k: local_shard(torch.as_tensor(x), shardings[k]).to(dev).contiguous().clone()
            for k, x in tree.items()}


def shard_batch(mesh, batch):
    """This rank's batch on the mesh's device.

    Each rank holds a DISJOINT local batch (its own streamed partitions),
    the JAX package's multi-process semantics: the global batch is the
    concatenation over ``(dp, fsdp)`` in rank order.  Ranks that differ only
    along the other axes (``tp``, ``sp``, ``ep``, ``pp``) compute on the
    same rows, so they take the batch of the first of them (a broadcast
    inside that group)."""
    dev = device_of(mesh)

    def put(x):
        return torch.as_tensor(x).to(dev)

    out = ({k: put(v) for k, v in batch.items()} if isinstance(batch, dict)
           else put(batch))
    peers = group(mesh, "tp", "sp", "ep", "pp")
    if peers is not None:
        src = dist.get_global_rank(peers, 0)
        for t in (out.values() if isinstance(out, dict) else (out,)):
            dist.broadcast(t, src=src, group=peers)
    return out
