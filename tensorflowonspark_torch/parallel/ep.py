"""Expert parallelism: the mixture-of-experts FFN, experts sharded over the
``ep`` axis — counterpart of ``tensorflowonspark_tpu/parallel/ep.py``.

The GShard/Switch static-capacity contract: top-k routing in f32, per-expert
capacity ``c = ceil(n · capacity_factor · k / e)`` taken from the ``n``
tokens of the call, overflow dropped.  ``dispatch="sort"`` (the default and
the path) assigns slots with sorted indices (``_sorted_dispatch``, the
GShard priority rule bit for bit) and scatters the kept tokens straight
into the ``[e, c, d]`` expert buffer; ``"einsum"`` keeps the one-hot
``[n, e, c]`` formulation as the parity reference.  The expert products are
batched matmuls, as in the JAX package (no kernel of its own there).

Under a mesh the layer routes the global batch as one group, as the JAX
package does: the ranks that hold different tokens (the ``dp``/``fsdp``
rows and, with the sequence split, the ``sp`` blocks: the *token group*)
all-gather their tokens, each rank routes and dispatches all of them,
runs the experts on its share of every expert's capacity slots, and the
expert outputs are all-gathered back over the token group; each rank keeps
its own tokens' rows.  ``tp.shard_model`` splits the experts over ``ep``
(a rank runs its block, the outputs all-gathered over ``ep``) and each
expert's ``F`` over ``tp`` (Megatron).  Routing, dispatch and combine are
repeated on every rank of the token group; only the expert matmuls are
split.

``forward`` returns ``(y, aux)``: ``aux`` holds the two auxiliary losses,
``load_balance`` (Switch eq. 4) and ``router_z`` (ST-MoE z-loss), the
JAX package's ``aux_loss`` sows.  They are outputs, not side effects, so a
block recomputed under ``torch.utils.checkpoint`` does not count them
twice; ``models.transformer.make_loss_fn`` sums them.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from tensorflowonspark_torch.parallel import mesh as meshlib
from tensorflowonspark_torch.parallel.tp import copy_to, gather_from, reduce_from


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; an index outside ``[0, n)`` gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest along the last axis, ties
    to the lower index (``jax.lax.top_k``'s order; ``torch.topk`` does not
    promise one): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sorted_dispatch(top_idx, top_p, capacity: int, n_experts: int):
    """GShard slot assignment without one-hot tensors.

    Returns ``(slots, token_ids, gates, keep)``, each ``[n · k]`` flat over
    (choice-round j, sorted-token) pairs: ``slots`` is the flat
    expert-buffer slot (``expert · capacity + position``, or ``e ·
    capacity`` for dropped pairs), ``token_ids`` the source token of each
    pair, ``gates`` its normalised routing weight.  Within round j,
    positions go in token order (a stable sort by expert id); rounds go in
    priority order, and only kept assignments of earlier rounds advance an
    expert's fill count — the JAX package's values exactly."""
    n, k = top_idx.shape
    e = n_experts
    dev = top_idx.device
    counts = torch.zeros((e,), dtype=torch.int64, device=dev)
    arange_n = torch.arange(n, device=dev)
    experts = torch.arange(e, device=dev)
    slots, toks, gates, keeps = [], [], [], []
    for j in range(k):
        eid = top_idx[:, j].long()
        order = torch.argsort(eid, stable=True)
        sorted_eid = eid[order].contiguous()
        starts = torch.searchsorted(sorted_eid, experts)
        pos = arange_n - starts[sorted_eid] + counts[sorted_eid]
        keep = pos < capacity
        slots.append(torch.where(keep, sorted_eid * capacity + pos, e * capacity))
        toks.append(order)
        gates.append(top_p[order, j])
        keeps.append(keep)
        counts = counts.index_add(0, sorted_eid, keep.long())
    return (torch.cat(slots), torch.cat(toks), torch.cat(gates), torch.cat(keeps))


def capacity_of(n: int, capacity_factor: float, top_k_: int, n_experts: int) -> int:
    return max(1, int(math.ceil(n * capacity_factor * top_k_ / n_experts)))


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU MoE FFN, ``[B, S, D] -> ([B, S, D], aux)``.

    Parameters under the JAX package's names: ``router.weight`` ``[E, D]``
    (flax ``router/kernel`` transposed; f32, never cast), and the expert
    stacks in flax's layout, ``experts_gate``/``experts_up`` ``[E, D, F]``
    and ``experts_down`` ``[E, F, D]``, cast to ``compute_dtype`` at use.

    ``mesh`` with ``seq_parallel`` (the sequence split over ``sp``) sets
    the token group (module docstring); without a mesh the layer routes
    the tokens of its call.  ``replay`` set to a ``top_idx`` ``[n, k]``
    routes the next calls by it (the gates are this call's probabilities
    at those experts): two paths whose numerics differ (a kernel and plain
    attention in bf16) can then be held against each other at one routing,
    where a router logit that rounds across a top-k boundary would
    otherwise send a token to another expert.  The router's output (the
    f32 logits of every routed token) is what a forward hook on
    ``router`` sees."""

    tp_group = None  # set by tp.shard_model
    ep_group = None

    def __init__(self, d_model: int, d_ff: int, n_experts: int, top_k: int = 2,
                 capacity_factor: float = 1.25, compute_dtype=torch.float32,
                 dispatch: str = "sort", mesh=None, seq_parallel: bool = False):
        super().__init__()
        if dispatch not in ("sort", "einsum"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        if not 1 <= top_k <= n_experts:
            raise ValueError(f"top_k {top_k} must be in [1, n_experts={n_experts}]")
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.compute_dtype = compute_dtype
        self.dispatch = dispatch
        self.router = nn.Linear(d_model, n_experts, bias=False)
        self.experts_gate = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.experts_up = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.experts_down = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.replay = None
        seq_axes = ("sp",) if seq_parallel else ()
        self.seq_group = meshlib.group(mesh, *seq_axes) if seq_axes else None
        self.batch_group = meshlib.group(mesh, *meshlib.BATCH_AXES)
        self.token_group = meshlib.group(mesh, *meshlib.BATCH_AXES, *seq_axes)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's ``lecun_normal``: for the router std 1/sqrt(D); for an
        ``[E, in, out]`` stack flax counts the expert axis in the fan-in
        (``E · in``)."""
        from tensorflowonspark_torch.models.transformer import _TRUNC_STD

        for w, fan_in in ((self.router.weight, self.router.weight.shape[1]),
                          (self.experts_gate, self.experts_gate.shape[0] * self.experts_gate.shape[1]),
                          (self.experts_up, self.experts_up.shape[0] * self.experts_up.shape[1]),
                          (self.experts_down, self.experts_down.shape[0] * self.experts_down.shape[1])):
            std = fan_in ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)

    @torch.no_grad()
    def cast_experts_(self) -> None:
        """Serving's cast-once-at-load: the expert stacks to the compute
        type (the router stays f32)."""
        for name in ("experts_gate", "experts_up", "experts_down"):
            p = getattr(self, name)
            p.data = p.data.to(self.compute_dtype)

    def forward(self, x):
        """``x`` is this rank's block of the global batch; the global
        batch is routed as one group and this rank's rows come back."""
        xg = gather_from(gather_from(x, 1, self.seq_group, sum_grads=True),
                         0, self.batch_group, sum_grads=True)
        b, s, d = xg.shape
        y, aux = self._route_and_run(xg.reshape(b * s, d))
        y = y.reshape(b, s, d).to(x.dtype)
        for grp, dim in ((self.batch_group, 0), (self.seq_group, 1)):
            if grp is not None:
                y = y.chunk(dist.get_world_size(grp), dim=dim)[dist.get_rank(grp)]
        if self.seq_group is not None:
            # every sp rank computes the same aux losses and the train step
            # sums gradients over sp: each passes 1/sp of their gradient
            n = dist.get_world_size(self.seq_group)
            aux = {k: v / n + (v - v / n).detach() for k, v in aux.items()}
        return y, aux

    def _route_and_run(self, xf):
        """The MoE on the ``[n, d]`` tokens of the whole group.  The four
        stages run under ``torch.profiler`` labels (``moe.route``,
        ``moe.dispatch``, ``moe.experts``, ``moe.combine``), so a trace
        splits the layer's time."""
        n, d = xf.shape
        e, k = self.n_experts, self.top_k
        with record_function("moe.route"):
            router_logits = self.router(xf.float())                    # routing always f32
            probs = torch.softmax(router_logits, dim=-1)
            if self.replay is None:
                top_p, top_idx = top_k(probs, k)                       # [n, k]
            else:
                top_idx = self.replay
                top_p = probs.gather(-1, top_idx)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            capacity = capacity_of(n, self.capacity_factor, k, e)
            # load-balancing aux loss (Switch eq. 4): e · Σ_e f_e · P_e
            frac_tokens = _one_hot(top_idx[:, 0], e).mean(dim=0)
            frac_probs = probs.mean(dim=0)
            z = torch.logsumexp(router_logits, dim=-1)
            aux = {"load_balance": e * (frac_tokens * frac_probs).sum(),
                   "router_z": (z * z).mean()}

        cdt = self.compute_dtype
        with record_function("moe.dispatch"):
            if self.dispatch == "einsum":
                expert_in, combine = self._einsum_dispatch(xf, top_idx, top_p, capacity, cdt)
            else:
                slots, toks, gates, keeps = _sorted_dispatch(top_idx, top_p, capacity, e)
                x_pairs = xf[toks].to(cdt) * keeps[:, None].to(cdt)
                # slot e·capacity is the dropped pairs' dump row (JAX's
                # mode="drop"), cut off after the scatter
                buf = torch.zeros((e * capacity + 1, d), dtype=cdt, device=xf.device)
                expert_in = buf.index_add(0, slots, x_pairs)[:e * capacity].view(e, capacity, d)

        with record_function("moe.experts"):
            out = self._experts(expert_in, cdt)                        # [e, c, d]

        with record_function("moe.combine"):
            if self.dispatch == "einsum":
                y = torch.einsum("nec,ecd->nd", combine.to(cdt), out)
            else:
                # each kept pair's expert output, weighted by its gate, added
                # to its token one round at a time (a round's tokens are
                # distinct), so the k terms sum in round order in the
                # compute type
                out_flat = out.reshape(e * capacity, d)
                safe = slots.clamp(max=e * capacity - 1)
                contrib = out_flat[safe] * gates[:, None].to(cdt) * keeps[:, None].to(cdt)
                y = torch.zeros((n, d), dtype=cdt, device=xf.device)
                for t, c in zip(toks.chunk(k), contrib.chunk(k)):
                    y = y.index_add(0, t, c)
        return y, aux

    def _experts(self, expert_in, cdt):
        """SwiGLU per expert on ``[e, c, d]``: this rank's experts (its
        block of the ``ep`` split, with its ``F`` block under ``tp``) on its
        share of the capacity slots (its block of the token group's split),
        the outputs all-gathered over both."""
        x_e = copy_to(copy_to(expert_in, self.ep_group), self.tp_group)
        w_gate, w_up, w_down = self.experts_gate, self.experts_up, self.experts_down
        if self.ep_group is not None:
            e_loc = w_gate.shape[0]
            x_e = x_e[dist.get_rank(self.ep_group) * e_loc:][:e_loc]
        c = x_e.shape[1]
        if self.token_group is not None:
            # capacity padded to a multiple of the group (zero rows give zero
            # outputs); the gather's backward sums over the group, whose
            # ranks each use their own tokens' rows of the result
            g = dist.get_world_size(self.token_group)
            per = -(-c // g)
            me = dist.get_rank(self.token_group)
            x_e = F.pad(x_e, (0, 0, 0, per * g - c))[:, me * per:(me + 1) * per]
        h = (F.silu(torch.bmm(x_e, w_gate.to(cdt))) * torch.bmm(x_e, w_up.to(cdt)))
        out = reduce_from(torch.bmm(h, w_down.to(cdt)), self.tp_group)
        out = gather_from(out, 1, self.token_group, sum_grads=True)[:, :c]
        return gather_from(out, 0, self.ep_group)

    def _einsum_dispatch(self, xf, top_idx, top_p, capacity, cdt):
        """Classic GShard one-hot dispatch/combine (parity reference)."""
        e = self.n_experts
        n = xf.shape[0]
        counts = torch.zeros((e,), dtype=torch.float32, device=xf.device)
        dispatch = torch.zeros((n, e, capacity), dtype=torch.float32, device=xf.device)
        combine = torch.zeros_like(dispatch)
        for j in range(self.top_k):
            oh = _one_hot(top_idx[:, j], e)                             # [n, e]
            pos = torch.cumsum(oh, dim=0) - oh + counts[None, :]        # [n, e]
            keep = (pos < capacity).float() * oh
            counts = counts + keep.sum(dim=0)
            slot = _one_hot((pos * oh).sum(dim=-1).long(), capacity)    # [n, c]
            d_j = keep[:, :, None] * slot[:, None, :]
            dispatch = dispatch + d_j
            combine = combine + d_j * top_p[:, j][:, None, None]
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cdt), xf.to(cdt))
        return expert_in, combine
