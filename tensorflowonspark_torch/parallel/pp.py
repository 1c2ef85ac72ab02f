"""Pipeline parallelism over the ``pp`` axis — counterpart of
``tensorflowonspark_tpu/parallel/pp.py``.

Every rank of the ``pp`` axis holds one stage's parameters: the
stage-stacked tree (``stack_stages``: ``{name: [n_stages, …]}``) placed by
``stage_shardings`` (``P("pp", None, …)``, so a rank keeps its own slice,
leading dim 1), or the whole stack, of which a rank reads its own slice.
``stage_fn(params_i, mb) -> mb`` runs one stage on one microbatch; it
takes a ``{name: tensor}`` dict, as ``torch.func.functional_call`` of a
stage module does (``module_stage_fn``).  Activations hop stage to stage
by ``isend``/``irecv`` over the ``pp`` group, the JAX package's
``ppermute``; ``pp`` is the mesh's innermost axis, so neighbouring stages
are neighbouring ranks.

- ``gpipe``: the forward schedule over ``m + s - 1`` ticks, and a backward
  that runs the ticks in reverse, recomputing each stage forward from its
  saved input and sending its input's gradient to the stage before
  (``_GPipe``); the outputs reach every stage through ``tp.reduce_from``.
  Differentiable: ``loss.backward()`` through it gives each rank its
  stage's gradients.
- ``pipeline_1f1b``: one forward and one backward microbatch per stage in
  steady state over ``2(m + s) - 2`` ticks, the backward recomputing the
  stage forward from the saved input (``torch.autograd.grad`` on a fresh
  graph), the loss head on the last stage only, returning ``(loss, grads[,
  head_grads][, dx])``.  The tick loop (``_run_ticks``) is apart from the
  exchange: it hands each tick's outgoing wires to a callable and takes
  the incoming ones back, so the same loop runs one stage over a
  ``torch.distributed`` ``pp`` group (``_p2p_wires``) or every stage in one
  process (``_local_wires``: the mesh's ``pp`` axis is 1 and the stack
  holds every stage), which is how one card runs it.

A batch is this rank's rows (the port's mesh convention, ``mesh.py``):
with ``data_axis`` (default ``dp``) larger than 1 each dp row pipelines its
own rows, and the 1F1B loss and gradients are averaged over the rows as
the JAX package's ``_dp_mean`` does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from tensorflowonspark_torch.parallel.mesh import P, Sharding, axis_index, axis_size, group
from tensorflowonspark_torch.parallel.tp import reduce_from


def stack_stages(param_trees: list) -> dict:
    """Stack per-stage ``{name: tensor}`` trees into the stage-stacked
    layout ``{name: [n_stages, …]}`` (nested dicts stack leaf by leaf)."""
    first = param_trees[0]
    if isinstance(first, dict):
        return {k: stack_stages([t[k] for t in param_trees]) for k in first}
    return torch.stack([torch.as_tensor(t) for t in param_trees])


def stage_shardings(mesh, stacked_params: dict, axis_name: str = "pp") -> dict:
    """``Sharding``s placing each leaf's leading stage dim over ``pp``
    (``mesh.shard_tree`` then keeps this rank's slice, leading dim 1)."""
    return {k: Sharding(mesh, P(axis_name, *([None] * (v.dim() - 1))))
            for k, v in stacked_params.items()}


def module_stage_fn(module: torch.nn.Module) -> Callable:
    """``stage_fn(params_i, mb)`` that runs ``module`` with the stage's
    parameters in place of its own (``torch.func.functional_call``)."""
    from torch.func import functional_call

    return lambda params, x: functional_call(module, params, (x,))


# ---------------------------------------------------------------------------
# Shared plumbing.
# ---------------------------------------------------------------------------

def _dp_batch_spec(mesh, data_axis: str, batch: int, n_microbatches: int) -> int:
    """The ``data_axis`` size, after checking that this rank's rows split
    into ``n_microbatches``."""
    dp_size = axis_size(mesh, data_axis)
    if batch % n_microbatches:
        raise ValueError(
            f"batch {batch} (the rows of this {data_axis} row of {dp_size}) not "
            f"divisible by n_microbatches = {n_microbatches}")
    return dp_size


def _layout(mesh, stage_params: dict, axis_name: str) -> tuple[int, int, bool]:
    """``(n_stages, this rank's stage, distributed)``: ``n_stages`` is the
    ``pp`` size when it is above 1 (leaves hold every stage or, placed by
    ``stage_shardings``, this rank's alone), else the leaves' leading dim
    (every stage in this process)."""
    pp = axis_size(mesh, axis_name)
    leads = {k: (v.shape[0] if v.dim() else None) for k, v in stage_params.items()}
    n_stages = pp if pp > 1 else next(iter(leads.values()))
    ok = (n_stages, 1) if pp > 1 else (n_stages,)
    for k, lead in leads.items():
        if lead is None or lead not in ok:
            raise ValueError(
                f"stage_params leaf {k} has shape {tuple(stage_params[k].shape)}, "
                f"expected leading dim n_stages={n_stages} (use stack_stages)")
    return n_stages, axis_index(mesh, axis_name) if pp > 1 else 0, pp > 1


def _stage(params: dict, i: int) -> dict:
    """Stage ``i``'s slice of the stage-stacked leaves (a placed leaf holds
    only this rank's stage, at index 0)."""
    return {k: v[i] if v.shape[0] > 1 else v[0] for k, v in params.items()}


def _micro(tree, m: int):
    """Every leaf ``[B, …]`` as ``[m, B/m, …]``."""
    if isinstance(tree, dict):
        return {k: _micro(v, m) for k, v in tree.items()}
    return tree.reshape((m, tree.shape[0] // m) + tuple(tree.shape[1:]))


def _pick(tree, k: int):
    if isinstance(tree, dict):
        return {key: _pick(v, k) for key, v in tree.items()}
    return tree[k]


def _peers(grp, idx: int, s: int) -> tuple:
    """Global ranks of the stage before and after ``idx`` (None at the
    ends: the wires do not wrap)."""
    prev = dist.get_global_rank(grp, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(grp, idx + 1) if idx + 1 < s else None
    return prev, nxt


def _exchange(sends: list, recvs: list, grp) -> None:
    """``sends``/``recvs``: ``(tensor, peer)`` pairs, one batch of
    ``isend``/``irecv``; returns once all have completed."""
    ops = ([dist.P2POp(dist.isend, t.contiguous(), peer, grp) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer, grp) for t, peer in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _all_reduce(x: torch.Tensor, grp) -> torch.Tensor:
    if grp is not None:
        x = x.contiguous().clone()
        dist.all_reduce(x, group=grp)
    return x


def _dp_mean(tree, grp, n: int):
    if grp is None:
        return tree
    if isinstance(tree, dict):
        return {k: _dp_mean(v, grp, n) for k, v in tree.items()}
    return _all_reduce(tree, grp) / n


# ---------------------------------------------------------------------------
# GPipe.
# ---------------------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one stage over the ``pp`` group: forward
    ``k`` at tick ``idx + k``, the output sent to the next stage every tick
    (zeros when idle), the last stage's outputs accumulated in f32.  The
    backward runs the ticks in reverse: it recomputes the stage forward
    from the saved input, takes the output's gradient from the next stage
    (the last stage from the outputs'), and sends the input's gradient to
    the stage before.  ``x``'s gradient is stage 0's, summed over ``pp`` so
    every stage holds it (``x`` is the same on all of them)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, names, idx, s, m, grp = run
        params = _stage(dict(zip(names, leaves)), idx)
        xs = _micro(x, m)
        prev, nxt = _peers(grp, idx, s)
        outputs = torch.zeros(xs.shape, dtype=torch.promote_types(x.dtype, torch.float32),
                              device=x.device)
        recv = torch.zeros_like(xs[0])
        saved = [None] * m
        for t in range(m + s - 1):
            k = t - idx
            out = torch.zeros_like(xs[0])
            if 0 <= k < m:
                cur = xs[k] if idx == 0 else recv
                saved[k] = cur
                out = stage_fn(params, cur)
                if idx == s - 1:
                    outputs[k] += out
            recv = torch.empty_like(xs[0])
            _exchange([(out.to(x.dtype), nxt)] if nxt is not None else [],
                      [(recv, prev)] if prev is not None else [], grp)
        ctx.run, ctx.shapes = run, (x.shape, x.dtype)
        ctx.save_for_backward(*leaves, *saved)
        return outputs.reshape((x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g_outputs):
        stage_fn, names, idx, s, m, grp = ctx.run
        x_shape, x_dtype = ctx.shapes
        leaves, saved = ctx.saved_tensors[:len(names)], ctx.saved_tensors[len(names):]
        stacked = dict(zip(names, leaves))
        prev, nxt = _peers(grp, idx, s)
        g_out_mb = _micro(g_outputs.float(), m)
        acc = {k: torch.zeros(v.shape[1:], dtype=torch.float32, device=v.device)
               for k, v in stacked.items()}
        dx = torch.zeros(g_out_mb.shape, dtype=torch.float32, device=g_outputs.device)
        g_recv = torch.zeros_like(g_out_mb[0])
        for t in reversed(range(m + s - 1)):
            k = t - idx
            g_in = torch.zeros_like(g_out_mb[0])
            if 0 <= k < m:
                g_out = g_out_mb[k] if idx == s - 1 else g_recv
                with torch.enable_grad():
                    p = {n: v.detach().requires_grad_() for n, v in _stage(stacked, idx).items()}
                    cur = saved[k].detach().requires_grad_()
                    out = stage_fn(p, cur)
                    grads = torch.autograd.grad(out, [*p.values(), cur], g_out.to(out.dtype),
                                                allow_unused=True)
                for n, g in zip(p, grads):
                    if g is not None:
                        acc[n] += g.float()
                if grads[-1] is not None:
                    g_in = grads[-1].float()
                if idx == 0:
                    dx[k] = g_in
            g_recv = torch.empty_like(g_out_mb[0])
            _exchange([(g_in, prev)] if prev is not None else [],
                      [(g_recv, nxt)] if nxt is not None else [], grp)
        dx = _all_reduce(dx, grp).reshape(x_shape).to(x_dtype)
        g_leaves = []
        for n, leaf in stacked.items():
            g = torch.zeros_like(leaf)
            g[idx if leaf.shape[0] > 1 else 0] = acc[n].to(leaf.dtype)
            g_leaves.append(g)
        return (None, dx, *g_leaves)


def gpipe(stage_fn: Callable[[dict, torch.Tensor], torch.Tensor], stage_params: dict,
          x: torch.Tensor, *, mesh, n_microbatches: int, axis_name: str = "pp",
          data_axis: str = "dp") -> torch.Tensor:
    """Run ``x`` (this rank's rows ``[B, …]``) through a pipeline of
    stages; returns the final activations, on every stage.

    - ``stage_params``: ``{name: [n_stages, …]}`` (``stack_stages``), or
      placed by ``stage_shardings`` (this rank's stage, leading dim 1).
    - ``stage_fn(params_i, mb) -> mb``: one stage's computation; activation
      shapes are the same between stages (the wire's format).
    - ``B`` divisible by ``n_microbatches``; each ``data_axis`` row
      pipelines its own rows.

    **Bubble accounting.**  With ``m`` microbatches over ``s`` stages the
    schedule runs ``m + s - 1`` ticks of which each stage computes on
    ``m``: utilisation ``m / (m + s - 1)``, bubble ``(s-1)/(m+s-1)``; the
    backward (the ticks in reverse) has the same fraction.  Memory: each
    stage keeps its ``m`` microbatch inputs and recomputes its forward in
    the backward; ``pipeline_1f1b`` keeps at most ``s`` of them.

    On a mesh whose ``pp`` axis is 1 the stages run one after another in
    this process, under ordinary autograd."""
    n_stages, idx, spread = _layout(mesh, stage_params, axis_name)
    _dp_batch_spec(mesh, data_axis, x.shape[0], n_microbatches)
    if not spread:
        h = x
        for i in range(n_stages):
            h = stage_fn(_stage(stage_params, i), h)
        return h
    names = list(stage_params)
    grp = group(mesh, axis_name)
    run = (stage_fn, names, idx, n_stages, n_microbatches, grp)
    out = _GPipe.apply(run, x, *stage_params.values())
    # only the last stage holds the outputs; the others add zeros
    return reduce_from(out, grp).to(x.dtype)


# ---------------------------------------------------------------------------
# 1F1B.
# ---------------------------------------------------------------------------

class _Stage1F1B:
    """One stage's state and its work at each tick of the 1F1B schedule:
    the residual ring of ``s`` stage inputs (slot ``k % s``) in the
    activation type, and f32 accumulators of the stage's gradients, the
    loss, the head's gradients and ``dx`` (stage 0)."""

    def __init__(self, stage_fn, params: dict, idx: int, s: int, m: int, xs, tgts,
                 loss_fn, head_params, with_input_grad: bool):
        self.stage_fn, self.params, self.idx, self.s, self.m = stage_fn, params, idx, s, m
        self.xs, self.tgts, self.loss_fn = xs, tgts, loss_fn
        self.head, self.with_input_grad = head_params, with_input_grad
        mb_shape, dev = xs.shape[1:], xs.device
        self.zero_act = torch.zeros(mb_shape, dtype=xs.dtype, device=dev)
        self.zero_grad = torch.zeros(mb_shape, dtype=torch.float32, device=dev)
        self.resid: list = [None] * s
        self.grad_acc = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                         for k, v in params.items()}
        self.loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        self.hg_acc = ({k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                        for k, v in head_params.items()} if head_params is not None else None)
        self.dx_buf = (torch.zeros((m,) + tuple(mb_shape), dtype=torch.float32, device=dev)
                       if with_input_grad else None)

    def tick(self, t: int, fwd_recv, bwd_recv) -> tuple:
        """Forward ``k`` at ``t = idx + 2k``, backward ``k`` at
        ``t = 2s - 1 - idx + 2k`` (disjoint by parity); returns the wires
        this stage sends: ``(activation to the next, f32 gradient to the
        previous)``, zeros when it has none."""
        idx, s, m = self.idx, self.s, self.m
        tf, tb = t - idx, t - (2 * s - 1 - idx)
        if tf >= 0 and tf % 2 == 0 and tf < 2 * m:
            k = tf // 2
            x_in = self.xs[k] if idx == 0 else fwd_recv
            with torch.no_grad():
                out = self.stage_fn(self.params, x_in)
            self.resid[k % s] = x_in
            return out.to(self.xs.dtype), self.zero_grad
        if tb >= 0 and tb % 2 == 0 and tb < 2 * m:
            return self.zero_act, self._backward(tb // 2, bwd_recv)
        return self.zero_act, self.zero_grad

    def _backward(self, k: int, bwd_recv):
        idx, last = self.idx, self.idx == self.s - 1
        need_in = idx > 0 or self.with_input_grad
        with torch.enable_grad():
            p = {n: v.detach().requires_grad_() for n, v in self.params.items()}
            inp = self.resid[k % self.s].detach().requires_grad_(need_in)
            out = self.stage_fn(p, inp)
            if last:  # the loss head runs on the last stage alone
                g_out = self._head(k, out).to(out.dtype)
            else:
                g_out = bwd_recv.to(out.dtype)
            wrt = [*p.values()] + ([inp] if need_in else [])
            grads = torch.autograd.grad(out, wrt, g_out, allow_unused=True)
        for n, g in zip(p, grads):
            if g is not None:
                self.grad_acc[n] += g.float()
        if not need_in or grads[-1] is None:
            return self.zero_grad
        g_in = grads[-1].float()
        if idx == 0:
            self.dx_buf[k] = g_in
        return g_in

    def _head(self, k: int, out):
        """The loss of microbatch ``k`` and its gradient w.r.t. ``out``
        (f32); the head's gradients and the loss accumulate."""
        y = out.detach().requires_grad_()
        args = [y] if self.tgts is None else [y, _pick(self.tgts, k)]
        if self.head is None:
            loss = self.loss_fn(*args)
            (g_y,) = torch.autograd.grad(loss, [y])
        else:
            hp = {n: v.detach().requires_grad_() for n, v in self.head.items()}
            loss = self.loss_fn(hp, *args)
            g_y, *g_hp = torch.autograd.grad(loss, [y, *hp.values()], allow_unused=True)
            for n, g in zip(hp, g_hp):
                if g is not None:
                    self.hg_acc[n] += g.float()
        self.loss_acc += loss.detach().float()
        return g_y.float()


def _run_ticks(stages: list, n_ticks: int, wires: Callable[[list], list]) -> None:
    """The 1F1B tick loop: at each tick every stage held here works
    (``_Stage1F1B.tick``), and ``wires(sends)`` — one ``(activation,
    gradient)`` pair per stage held — returns what each of them receives
    for the next tick."""
    recv = [(st.zero_act, st.zero_grad) for st in stages]
    for t in range(n_ticks):
        recv = wires([st.tick(t, f, b) for st, (f, b) in zip(stages, recv)])


def _local_wires(stages: list) -> Callable[[list], list]:
    """Every stage in this process: stage ``i`` receives stage ``i-1``'s
    activation and stage ``i+1``'s gradient (zeros at the ends)."""
    s = len(stages)

    def wires(sends):
        return [(sends[i - 1][0] if i > 0 else stages[i].zero_act,
                 sends[i + 1][1] if i + 1 < s else stages[i].zero_grad)
                for i in range(s)]

    return wires


def _p2p_wires(stage: _Stage1F1B, grp) -> Callable[[list], list]:
    """One stage of a ``pp`` group: both wires go to the neighbours every
    tick (``isend``/``irecv``; an idle stage sends zeros, as the JAX
    package's ``ppermute`` does)."""
    prev, nxt = _peers(grp, stage.idx, stage.s)

    def wires(sends):
        (send_f, send_b), = sends
        fwd_recv, bwd_recv = stage.zero_act, stage.zero_grad
        out, inc = [], []
        if nxt is not None:
            bwd_recv = torch.empty_like(stage.zero_grad)
            out.append((send_f, nxt))
            inc.append((bwd_recv, nxt))
        if prev is not None:
            fwd_recv = torch.empty_like(stage.zero_act)
            out.append((send_b, prev))
            inc.append((fwd_recv, prev))
        _exchange(out, inc, grp)
        return [(fwd_recv, bwd_recv)]

    return wires


def pipeline_1f1b(stage_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                  stage_params: dict, x: torch.Tensor, loss_fn: Callable, *, mesh,
                  n_microbatches: int, targets: Any = None, head_params: dict | None = None,
                  with_input_grad: bool = False, axis_name: str = "pp",
                  data_axis: str = "dp") -> tuple:
    """One-forward-one-backward (PipeDream-flush) pipelined loss and grads.

    Returns ``(loss, grads[, head_grads][, dx])``: ``loss`` is the mean of
    the per-microbatch losses, ``grads`` is ``d loss / d stage_params``,
    stage-stacked and f32: over a ``pp`` group this rank's stage (leading
    dim 1), in one process every stage.  With ``head_params`` the loss head
    outside the pipe (final norm and lm_head) trains too:
    ``loss_fn(head_params, y_mb[, tgt_mb])``, and ``head_grads`` joins the
    result (every stage holds them).  ``with_input_grad=True`` adds
    ``dx = d loss / d x`` ``[B, …]`` for an embedding outside the pipe.

    Schedule (tick ``t``, stage ``i``, ``s`` stages, ``m`` microbatches):
    forward ``k`` at ``t = i + 2k``, backward ``k`` at ``t = 2s - 1 - i +
    2k``, over ``2(m + s) - 2`` ticks.  Only stage inputs are kept, in a
    ring of ``s`` slots (O(s) residuals, independent of ``m``); the
    backward recomputes the stage forward.  The forward wire and the ring
    ride in the activation type (bf16 stays bf16); the gradient wire is
    f32.  The bubble is GPipe's ``(s-1)/(m+s-1)``.

    ``stage_fn(params_i, mb) -> mb_out`` as in ``gpipe``; ``targets`` (a
    tensor or a dict of ``[B, …]`` tensors) are cut into microbatches
    beside ``x``; ``loss_fn`` returns a scalar.  ``x`` and ``targets`` are
    this rank's rows; with ``data_axis`` above 1 the loss and every
    gradient are averaged over its rows (``dx`` divided by their count), so
    the result equals one pipeline over the concatenated batch.  On a mesh
    whose ``pp`` axis is 1 (or ``mesh=None``) every stage of the stack runs
    in this process, through the same tick loop."""
    n_stages, idx, spread = _layout(mesh, stage_params, axis_name)
    m = n_microbatches
    dp_size = _dp_batch_spec(mesh, data_axis, x.shape[0], m)
    dp_grp = group(mesh, data_axis)
    xs = _micro(x, m)
    tgts = _micro(targets, m) if targets is not None else None
    n_ticks = 2 * (m + n_stages) - 2

    def make(i):
        return _Stage1F1B(stage_fn, _stage(stage_params, i), i, n_stages, m, xs, tgts,
                          loss_fn, head_params, with_input_grad)

    if spread:
        pp_grp = group(mesh, axis_name)
        stage = make(idx)
        _run_ticks([stage], n_ticks, _p2p_wires(stage, pp_grp))
        loss = _all_reduce(stage.loss_acc, pp_grp)
        grads = {k: (v / m)[None] for k, v in stage.grad_acc.items()}
        head = ({k: _all_reduce(v, pp_grp) for k, v in stage.hg_acc.items()}
                if head_params is not None else None)
        dx = _all_reduce(stage.dx_buf, pp_grp) if with_input_grad else None
    else:
        stages = [make(i) for i in range(n_stages)]
        _run_ticks(stages, n_ticks, _local_wires(stages))
        loss = sum(st.loss_acc for st in stages)
        grads = {k: torch.stack([st.grad_acc[k] for st in stages]) / m for k in stage_params}
        head = ({k: sum(st.hg_acc[k] for st in stages) for k in head_params}
                if head_params is not None else None)
        dx = stages[0].dx_buf if with_input_grad else None
    outs = [_dp_mean(loss / m, dp_grp, dp_size), _dp_mean(grads, dp_grp, dp_size)]
    if head is not None:
        outs.append(_dp_mean({k: v / m for k, v in head.items()}, dp_grp, dp_size))
    if with_input_grad:
        # 1/dp: the gradient of the dp-averaged loss the others differentiate
        outs.append((dx / (m * dp_size)).reshape((x.shape[0],) + tuple(x.shape[1:])))
    return tuple(outs)
