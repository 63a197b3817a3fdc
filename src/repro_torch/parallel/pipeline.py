"""Pipeline parallelism over the ``pod`` axis, GPipe style (port of
``src/repro/parallel/pipeline.py``).

  * the layer stack is split into ``n_stages`` equal groups, stage s held
    by the rank at pod coordinate s (params stacked on a leading stage
    dim, sharded over the pod axis or whole on every rank);
  * microbatches stream through the stages; activations hop to the next
    pod with ``dist.batch_isend_irecv`` on ``mesh.get_group(axis)`` (JAX's
    ring ``ppermute``);
  * the steady state keeps every stage busy but for the (S-1) bubble fill
    and drain: a bubble fraction of (S-1)/(S-1+M) for M microbatches.

With one stage the hand-off goes from the stage to itself, the identity,
as ``ppermute`` over a ring of one is; no message is sent.

The loop is differentiable, with JAX's transpose rules:

  * the ring hand-off's backward sends the cotangent the other way round
    the ring (``ppermute``'s transpose);
  * the broadcast of the last stage's outputs (a one-hot all-reduce) hands
    each rank's cotangent to its own copy once, and only the last stage
    keeps it: the transpose of a ``psum`` into a replicated output, which
    neither scales it by the stage count nor reduces it again;
  * the microbatches and whole (unsplit) stage params are replicated
    inputs: their gradients are summed over the pod group, so every rank
    holds the full gradient (nothing is reduced over other axes); params
    that are a ``DTensor`` split over the pod axis get a ``DTensor``
    gradient of the same placement, each rank's shard its stage's.

The point-to-point calls of the backward must pair up round the ring, so
every hand-off names the stage's differentiable inputs as its own: autograd
then runs every hand-off's backward on every rank, in reverse step order,
whatever the caller differentiates.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import tree_leaves, tree_map


def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to global rank ``to``; return what ``frm`` sent."""
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, got, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


class _RingShift(torch.autograd.Function):
    """``x`` to the next stage of the ring, the previous stage's ``x`` back;
    the backward sends the cotangent to the previous stage.  ``anchors``
    take no gradient: they tie the hand-off to the stage's inputs."""

    @staticmethod
    def forward(ctx, x, ring, *anchors):
        ctx.ring, ctx.n_anchors = ring, len(anchors)
        group, nxt, prv = ring
        return _exchange(x, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.ring
        return (_exchange(g, group, prv, nxt), None) + (None,) * ctx.n_anchors


class _ReplicatedIn(torch.autograd.Function):
    """The identity on inputs every stage holds whole; the backward sums
    each gradient over the pod group (JAX's transpose of a replicated
    input), in one fixed order on every rank."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g in gs:
            g = torch.clone(g, memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _FromLastStage(torch.autograd.Function):
    """JAX's one-hot ``psum``: the sum over the pod group of what each stage
    holds (zeros but on the last stage).  The backward hands the replicated
    output's cotangent to each rank's input once."""

    @staticmethod
    def forward(ctx, local, group):
        out = local.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(
    stage_params,  # tree stacked on a leading dim = n_stages
    x,  # (M, micro_batch, ...) microbatches, the same on every rank
    body: Callable,  # body(params_slice, activation) -> activation
    mesh,
    axis: str = "pod",
):
    """Run x through the ``n_stages`` pipeline stages laid out on ``axis``.

    Schedule: for t in range(M + S - 1) every stage processes the
    microbatch it holds, then activations shift one pod to the right.
    Stage s processes microbatch m at t = m + s.  Returns the (M, ...)
    outputs of the last stage on every rank (JAX's one-hot ``psum``)."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    stage = mesh.get_local_rank(axis)
    if isinstance(x, DTensor):
        x = x.full_tensor()
    m = x.shape[0]
    leaves = tree_leaves(stage_params)
    recording = torch.is_grad_enabled() and any(t.requires_grad for t in [x, *leaves])
    whole = [a for a in leaves if not isinstance(a, DTensor) and a.requires_grad]
    if recording and n_stages > 1 and (x.requires_grad or whole):
        rep = iter(_ReplicatedIn.apply(group, *([x] if x.requires_grad else []), *whole))
        x = next(rep) if x.requires_grad else x
        stage_params = tree_map(
            lambda a: next(rep) if not isinstance(a, DTensor) and a.requires_grad else a,
            stage_params)

    def mine(a):
        # a DTensor split over the pod axis holds this stage's slice alone
        return a.to_local()[0] if isinstance(a, DTensor) else a[stage]

    sp = tree_map(mine, stage_params)
    anchors = tuple(t for t in [x, *tree_leaves(sp)] if t.requires_grad) if recording else ()
    ring = (group, ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages])
    first = torch.tensor(stage == 0, device=x.device)
    total = m + n_stages - 1
    acts = torch.zeros_like(x[0])
    emitted = []
    for t in range(total):
        # a ``where`` on every stage, as JAX's: the hand-off's output stays
        # in each stage's graph, so its backward runs on stage 0 too
        cur = torch.where(first, x[min(t, m - 1)], acts)
        out = body(sp, cur) if 0 <= t - stage < m else cur
        if t >= n_stages - 1:  # the last stage emits microbatch t - (S - 1)
            emitted.append(out)
        if t < total - 1 and n_stages > 1:  # the last step's hand-off reaches no one
            acts = _RingShift.apply(out, ring, *anchors)
        else:
            acts = out
    last = torch.tensor(stage == n_stages - 1, device=x.device)
    local = torch.where(last, torch.stack(emitted), 0.0)
    return local if n_stages == 1 else _FromLastStage.apply(local, group)
