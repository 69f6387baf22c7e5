"""Pipeline parallelism over the "pipe" axis: GPipe and 1F1B.

The counterpart of ``pipegoose_tpu/nn/pipeline_parallel/pipeline.py``. The
JAX package compiles one SPMD program: a ``lax.scan`` over clock cycles,
every stage computing on every clock (bubbles on garbage, masked), the
backward by reverse-mode AD of the scan. Here every rank runs its own
process and walks the same clocks eagerly:

- :func:`gpipe` runs this stage's microbatches at their clocks (task (m,
  p) at clock m + p) and skips the bubbles, but every rank enters every
  clock's transfer, a differentiable ``ppermute`` to the next stage, in
  the same order. The backward is autograd through those ``ppermute``s:
  their backward sends each cotangent to the previous stage, so every
  rank must run every clock's transfer node in reverse clock order. For
  that the nodes form one chain on each rank: a bubble hands on what it
  received, stage 0 ties what it received to its next input, and the
  chain's end reaches the caller's loss through the zeros a non-last
  stage returns (:func:`last_stage_value` keeps them in the graph).
- :func:`one_f_one_b` walks ``one_f_one_b_tables``' clock timetable: a
  forward slot runs the stage without a graph and keeps its input, a
  backward slot recomputes the stage (with the head on the last stage)
  and takes ``torch.autograd.grad`` against the cotangent that arrived.
  Only the transfers some stage makes at a clock run, the same on every
  rank. :func:`manual_grads_loss` turns its gradients into a loss that
  ``backward()`` hands them out of.

Stages own their blocks: ``pipe_stage_specs`` marks every block leaf
with the pipe axis, so the gradient sync over "pipe" sums only the
replicated leaves (the tied embedding, its LayerNorm, ``ln_f``).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from pipegoose_tpu_torch.distributed.functional import (
    _ppermute_raw,
    axis_index,
    axis_size,
    ppermute,
    reduce_from_tensor_group,
)
from pipegoose_tpu_torch.nn.parallel import tree_leaves, tree_map
from pipegoose_tpu_torch.nn.pipeline_parallel.scheduler import (
    GPipeScheduler,
    one_f_one_b_tables,
)


def _index(tree: Any, i: int) -> Any:
    """Microbatch ``i`` of every leaf of a tree with a leading M dim."""
    if tree is None:
        return None
    return tree_map(lambda a: a[i], tree)


def _add(acc: Any, x: Any) -> Any:
    return x if acc is None else tree_map(torch.add, acc, x)


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``dep`` made one of its inputs: the backward
    reaches ``dep``'s producer (with a zero gradient) but moves nothing."""

    @staticmethod
    def forward(ctx, x, dep):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gpipe(stage_fn: Callable[..., Any], stage_params: Any, inputs: torch.Tensor,
          side_inputs: Optional[Any] = None, axis_name: str = "pipe",
          remat: bool = True, with_aux: bool = False):
    """Run ``inputs`` ((M, ...) pipeline-entry activations, read on stage 0
    only) through the P stages of the pipe axis.

    ``stage_fn(stage_params, h[, side]) -> h`` keeps the activation's shape
    (each stage applies its own blocks). ``side_inputs`` (a tree with a
    leading M dim, the same on every stage) are per-microbatch values every
    stage needs, such as attention masks: each stage indexes them by its
    own microbatch. ``remat=True`` checkpoints the whole stage call
    (non-reentrant ``torch.utils.checkpoint``; the transfers stay outside
    it). With ``with_aux=True`` ``stage_fn`` returns ``(h, aux)``, and the
    aux of this stage's microbatches is summed and returned per rank.

    Returns the last stage's outputs, shaped like ``inputs``, on the last
    rank; on every other rank zeros of that shape that close the backward
    chain, which the caller must let reach its loss (multiplied by zero;
    :func:`last_stage_value` does). With aux: ``(outputs, aux_sum)``.
    Task (m, p) runs at clock m + p over M + P - 1 clocks (GPipeScheduler)."""
    from torch.utils.checkpoint import checkpoint

    P, stage = axis_size(axis_name), axis_index(axis_name)
    M = inputs.shape[0]
    n_clock = GPipeScheduler(M, P).total_forward_clocks
    fn = ((lambda *a: checkpoint(stage_fn, *a, use_reentrant=False)) if remat
          else stage_fn)
    perm = [(i, i + 1) for i in range(P - 1)]
    outs, aux_sum = [None] * M, None
    carry = None   # what arrived from the previous stage last clock
    for c in range(n_clock):
        m = c - stage
        if 0 <= m < M:
            if stage > 0:
                h_in = carry
            else:
                h_in = inputs[m] if carry is None else _Tie.apply(inputs[m], carry)
            side = () if side_inputs is None else (_index(side_inputs, m),)
            res = fn(stage_params, h_in, *side)
            h_out, aux = res if with_aux else (res, None)
            aux_sum = _add(aux_sum, aux) if with_aux else None
            if stage == P - 1:
                outs[m] = h_out
        elif carry is not None:
            h_out = carry   # a bubble: no compute, the chain goes on
        else:   # a later stage before its first microbatch arrives
            h_out = torch.zeros_like(inputs[0]).requires_grad_(torch.is_grad_enabled())
        if P > 1 and c < n_clock - 1:
            carry = ppermute(h_out, axis_name, perm)
    if stage == P - 1:
        out = torch.stack(outs)
    else:   # the chain's end, zeroed, carried into the caller's loss
        out = (h_out * 0).unsqueeze(0).expand(M, *h_out.shape)
    return (out, aux_sum) if with_aux else out


def _transfer(x: Optional[torch.Tensor], like: torch.Tensor, axis_name: str, perm):
    """One clock's point-to-point transfers of ``perm`` ((src, dst) stage
    pairs, the same list on every rank): this rank sends ``x`` where it is
    a source; returns what it receives, or None where it is no
    destination."""
    got = _ppermute_raw([like if x is None else x], axis_name, perm)[0]
    return got if any(d == axis_index(axis_name) for _, d in perm) else None


def one_f_one_b(stage_fn: Callable[..., Any], stage_params: Any,
                head_fn: Callable[..., torch.Tensor], head_params: Any,
                inputs: torch.Tensor, side_inputs: Any, axis_name: str = "pipe",
                with_aux: bool = False):
    """1F1B (PipeDream-flush) with a manual, interleaved backward.

    The backward of microbatch m starts as soon as its forward leaves the
    last stage, so a stage keeps at most ``n_slots <= P`` saved inputs:
    live activations bounded by the stage count, not the microbatch
    count. Forward slots run ``stage_fn`` without a graph and keep the
    stage input; backward slots recompute the stage inside
    ``torch.autograd.grad`` (rematerialization), the last stage seeding its
    own backward through ``head_fn(head_params, h, side) -> scalar loss
    contribution`` (already normalized by the caller). The last stage skips
    its forward slots' compute: its backward slot recomputes it anyway, and
    nothing is sent on.

    ``stage_fn(stage_params, h, side) -> h`` as in :func:`gpipe`;
    ``side_inputs`` is required (carry the head's labels and mask in it);
    ``inputs`` is read on stage 0 only (other stages need its shape and
    dtype). Returns ``(loss_sum, d_inputs, d_stage_params, d_head_params)``:
    the loss and the head's gradients on the LAST rank (zero, or the aux
    sum with ``with_aux``, and None elsewhere), ``d_inputs`` (M-leading) on
    the FIRST (None elsewhere), the gradients as lists in ``tree_leaves`` order, None for a leaf that got
    none. Call it outside autograd (it returns gradients); :func:`manual_grads_loss` wraps it.

    ``with_aux=True``: ``stage_fn`` returns ``(h, aux_scalar)``, this stage's
    pre-weighted, pre-normalized scalar loss contribution for the
    microbatch (e.g. MoE router losses times their weights over L x M).
    Each stage's backward seeds a unit cotangent on its own aux scalar, so
    its router gradients flow in ITS backward with no traffic between
    stages, and the aux values add into ``loss_sum`` on EVERY rank: the
    caller combines the loss with a plain sum over the pipe axis."""
    P, stage = axis_size(axis_name), axis_index(axis_name)
    M = inputs.shape[0]
    fwd, bwd, _n_slots, n_clock = one_f_one_b_tables(M, P)
    first, last = stage == 0, stage == P - 1
    p_leaves, h_leaves = tree_leaves(stage_params), tree_leaves(head_params)
    like = inputs[0]
    send_h = send_g = None
    recv_h, recv_g, acts = {}, {}, {}
    p_grads = [None] * len(p_leaves)
    h_grads = [None] * len(h_leaves)
    dh0 = [None] * M
    loss = torch.zeros((), dtype=torch.float32, device=like.device)

    def acc(total, new):
        for i, g in enumerate(new):
            if g is not None:
                total[i] = g if total[i] is None else total[i] + g

    for c in range(n_clock):
        if c > 0:   # what the neighbours sent at clock c - 1
            h_perm = [(s, s + 1) for s in range(P - 1) if fwd[c - 1, s] >= 0]
            g_perm = [(s + 1, s) for s in range(P - 1) if bwd[c - 1, s + 1] >= 0]
            got = _transfer(send_h, like, axis_name, h_perm) if h_perm else None
            if got is not None:
                recv_h[int(fwd[c - 1, stage - 1])] = got
            got = _transfer(send_g, like, axis_name, g_perm) if g_perm else None
            if got is not None:
                recv_g[int(bwd[c - 1, stage + 1])] = got
        f_m, b_m = int(fwd[c, stage]), int(bwd[c, stage])
        if f_m >= 0:
            h_in = inputs[f_m] if first else recv_h.pop(f_m)
            acts[f_m] = h_in
            if not last:
                with torch.no_grad():
                    out = stage_fn(stage_params, h_in, _index(side_inputs, f_m))
                send_h = out[0] if with_aux else out
        elif b_m >= 0:
            side = _index(side_inputs, b_m)
            with torch.enable_grad():
                h = acts.pop(b_m).detach().requires_grad_(True)
                h_out, aux = (stage_fn(stage_params, h, side) if with_aux
                              else (stage_fn(stage_params, h, side), None))
                if last:
                    loss_m = head_fn(head_params, h_out, side)
                    if with_aux:
                        loss_m = loss_m + aux
                    outputs, cts = [loss_m], [torch.ones_like(loss_m)]
                    wrt = p_leaves + h_leaves + [h]
                else:
                    outputs, cts = [h_out], [recv_g.pop(b_m)]
                    if with_aux:   # a unit cotangent on this stage's own aux
                        outputs, cts = outputs + [aux], cts + [torch.ones_like(aux)]
                    wrt = p_leaves + [h]
                grads = torch.autograd.grad(outputs, wrt, cts, allow_unused=True)
            acc(p_grads, grads[:len(p_leaves)])
            if last:
                acc(h_grads, grads[len(p_leaves):-1])
            dh = grads[-1]
            if first:
                dh0[b_m] = dh
            send_g = dh
            if last:
                loss = loss + loss_m.detach().float()
            elif with_aux:
                loss = loss + aux.detach().float()
    return (loss, torch.stack(dh0) if first else None, p_grads,
            h_grads if last else [None] * len(h_leaves))


class _ManualGrads(torch.autograd.Function):
    """A loss whose gradients were computed when it was: the backward
    returns them times the cotangent."""

    @staticmethod
    def forward(ctx, run, params, *leaves):
        with torch.enable_grad():
            loss, grads = run(params)
        ctx.grads = tree_leaves(grads)
        return loss.detach()

    @staticmethod
    def backward(ctx, ct):
        return (None, None, *[None if g is None else (g * ct).to(g.dtype)
                              for g in ctx.grads])


def manual_grads_loss(run: Callable[[Any], tuple], params: Any) -> torch.Tensor:
    """A differentiable loss from ``run(params) -> (loss, grads)``, which
    computes the gradients itself (the 1F1B forward and backward in one):
    ``loss.backward()`` hands ``grads`` (a tree like ``params``, None for
    a leaf with none) times the cotangent to the leaves' ``.grad``, so the
    loss plugs into ``make_hybrid_train_step`` unchanged."""
    return _ManualGrads.apply(run, params, *tree_leaves(params))


def one_f_one_b_loss(params: dict, stage_fn: Callable[..., Any],
                     head_fn: Callable[..., torch.Tensor], entry_keys: tuple,
                     head_keys: tuple, entry_fn: Callable[[dict], torch.Tensor],
                     side_inputs: Any, axis_name: str = "pipe",
                     with_aux: bool = False, stage_key: str = "blocks") -> torch.Tensor:
    """A model's 1F1B loss over ``params`` (a tree whose ``stage_key`` entry
    holds this stage's parameters: ``"blocks"``, or ALBERT's shared
    ``"layer"``): :func:`one_f_one_b` over them, ``head_fn`` on the
    ``head_keys`` leaves (the last stage), the entry's gradients through
    ``entry_fn({k: params[k] for k in entry_keys})`` (the pipeline-entry
    activations, read on the first stage) from the first stage's d_inputs;
    a leaf reached twice (a tied embedding, in the entry and the head) gets
    the sum. The loss is summed over the pipe axis, and
    :func:`manual_grads_loss` hands the gradients to ``backward()``."""
    from pipegoose_tpu_torch.distributed.functional import all_reduce

    def run(params):
        entry = {k: params[k] for k in entry_keys}
        h0 = entry_fn(entry)
        head = {k: params[k] for k in head_keys}
        loss, dh0, d_blocks, d_head = one_f_one_b(
            stage_fn, params[stage_key], head_fn, head, h0.detach(), side_inputs,
            axis_name, with_aux=with_aux)
        grads = {}

        def add(leaves, gs):
            for leaf, g in zip(leaves, gs):
                if g is not None:
                    grads[id(leaf)] = grads[id(leaf)] + g if id(leaf) in grads else g

        add(tree_leaves(params[stage_key]) + tree_leaves(head), d_blocks + d_head)
        if axis_index(axis_name) == 0:
            leaves = tree_leaves(entry)
            add(leaves, torch.autograd.grad(h0, leaves, dh0, allow_unused=True))
        return all_reduce(loss, axis_name), tree_map(lambda t: grads.get(id(t)), params)

    return manual_grads_loss(run, params)


def last_stage_value(x: torch.Tensor, axis_name: str = "pipe") -> torch.Tensor:
    """A value computed on the LAST pipe rank, replicated to every rank of
    the axis, with an identity backward so that each rank's gradient stays
    its own (a sum's backward would scale every gradient by P). Other
    ranks' ``x`` is multiplied by zero, not dropped: their backward still
    runs through it (:func:`gpipe`'s chain)."""
    if axis_size(axis_name) == 1:
        return x
    masked = x if axis_index(axis_name) == axis_size(axis_name) - 1 else x * 0
    return reduce_from_tensor_group(masked, axis_name)


def pipe_stage_specs(spec_tree: Any, axis_name: str = "pipe") -> Any:
    """Every spec of a blocks spec tree with the pipe axis prepended to its
    dim 0 entry: on a stacked tree, the n_layer dim sharded over the axis
    (the JAX stage assignment); on the port's per-layer list, the mark that
    the leaf belongs to this rank's stage alone."""
    def f(spec):
        dim0 = spec[0] if len(spec) else None
        if dim0 is None:
            new0 = axis_name
        elif isinstance(dim0, (tuple, list)):
            new0 = (axis_name, *dim0)
        else:
            new0 = (axis_name, dim0)
        return (new0, *spec[1:])

    return tree_map(f, spec_tree)
