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
as ``ppermute`` over a ring of one is; no message is sent.  Unlike JAX's
(``ppermute`` has a transpose rule), this loop runs forward only: the
point-to-point calls are not differentiable.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.optim.adamw import tree_map


def _ring_shift(x: torch.Tensor, group, ranks, stage: int) -> torch.Tensor:
    """``x`` from the previous stage of the ring; ``x`` goes to the next."""
    n = len(ranks)
    if n == 1:
        return x
    x = x.contiguous()
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(stage + 1) % n], group),
           dist.P2POp(dist.irecv, got, ranks[(stage - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


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

    def mine(a):
        # a DTensor split over the pod axis holds this stage's slice alone
        return a.to_local()[0] if isinstance(a, DTensor) else a[stage]

    sp = tree_map(mine, stage_params)
    acts = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        cur = x[min(max(t, 0), m - 1)] if stage == 0 else acts
        live = 0 <= t - stage < m
        out = body(sp, cur) if live else cur
        if stage == n_stages - 1 and live:
            outs[t - (n_stages - 1)] = out
        acts = _ring_shift(out, group, ranks, stage)
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs
