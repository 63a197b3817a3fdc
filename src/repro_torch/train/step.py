"""Train, prefill and serve steps (port of ``src/repro/train/step.py``).

The JAX package jit-compiles these with explicit shardings over a mesh;
the port runs them eagerly.  Without a mesh they run on the params'
device.  With one (a ``DeviceMesh``), every plain tensor they are given
is placed first: params and AdamW's moments by ``param_shardings`` under
the arch's rule set (``state_shardings``), the batch by
``batch_shardings``, a decode cache by ``cache_shardings``, tokens over
the data axes; a ``DTensor`` is taken as placed.  The model then runs on
``DTensor`` s under ``parallel.ctx.use_mesh``; the grads are brought to
their params' placements (the data-parallel all-reduce), the loss, the
grad norm and the logits come back as the values every rank shares.  A
caller that keeps its state across steps places it once (the Trainer
does): a decode step writes its cache in place only in a cache that is
already placed.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch._shardmap_compat import NamedSharding, PartitionSpec, axis_sizes, place
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import RULE_SETS, param_shardings
from repro_torch.optim import adamw_update, clip_by_global_norm, warmup_cosine
from repro_torch.optim.adamw import OptState, tree_leaves, tree_map
from repro_torch.parallel.ctx import use_mesh
from repro_torch.parallel.sharding import batch_shardings, cache_shardings, data_axes


class TrainStepOut(NamedTuple):
    params: Any
    opt_state: Any
    metrics: Any


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _whole(x):
    """A ``DTensor``'s global value (the loss, a norm), else ``x``."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def state_shardings(cfg: ModelConfig, mesh) -> dict:
    """``{"params": ..., "opt": OptState(...)}``: each param leaf's
    ``NamedSharding`` under the arch's rule set, AdamW's moments placed as
    their params, its step count kept whole."""
    ps = param_shardings(backbone.model_spec(cfg), mesh, RULE_SETS[cfg.rules])
    return {"params": ps, "opt": OptState(m=ps, v=ps, count=None)}


def make_train_step(
    cfg: ModelConfig,
    mesh=None,
    *,
    lr_peak: float = 3e-4,
    grad_clip: float = 1.0,
    microbatch: Optional[int] = None,
    schedule=warmup_cosine,
    donate: bool = False,
):
    """Returns ``step_fn(params, opt, batch, step) -> TrainStepOut``: the
    loss and its grads (summed over ``batch // microbatch`` accumulation
    steps, then averaged, when ``microbatch`` is set), global-norm clipping,
    the learning rate ``schedule(step, peak=lr_peak)`` and one AdamW step.
    ``batch`` is a dict of tensors on the params' device; ``step`` an int.
    ``donate`` (JAX's ``donate_argnums=(0, 1)``) updates the params and the
    optimizer state it is given in place and returns them; the values are
    those of the step that does not donate.  ``mesh``: see the module
    docstring."""
    shardings = state_shardings(cfg, mesh) if mesh is not None else None

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = backbone.loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        if mesh is not None:  # each grad placed as its param: the DP / TP reductions
            grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
                     for g, p in zip(grads, tree_leaves(params))]
        return loss.detach(), _unflatten(params, grads)

    def grads_of(params, batch):
        if microbatch:
            b = next(iter(batch.values())).shape[0]
            n_acc = max(1, b // microbatch)
            g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            l_acc = 0.0
            for i in range(n_acc):
                mb = {k: x[i * microbatch:(i + 1) * microbatch] for k, x in batch.items()}
                l, g = loss_and_grads(params, mb)
                g_acc = tree_map(lambda a, b_: a + b_, g_acc, g)
                l_acc = l_acc + l
            return l_acc / n_acc, tree_map(lambda x: x / n_acc, g_acc)
        return loss_and_grads(params, batch)

    def body(params, opt_state, batch, step):
        l, g = grads_of(params, batch)
        g, gnorm = clip_by_global_norm(g, grad_clip, donate=donate)
        l, gnorm = _whole(l), _whole(gnorm)
        lr = schedule(step, peak=lr_peak).to(l.device)
        params, opt_state = adamw_update(g, opt_state, params, lr, donate=donate)
        metrics = {"loss": l, "grad_norm": gnorm, "lr": lr}
        return TrainStepOut(params, opt_state, metrics)

    def step_fn(params, opt_state, batch, step):
        if mesh is None:
            return body(params, opt_state, batch, step)
        params = place(params, shardings["params"])
        opt_state = place(opt_state, shardings["opt"])
        batch = place(batch, batch_shardings(cfg, batch, mesh))
        with use_mesh(mesh):
            return body(params, opt_state, batch, step)

    return step_fn


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Inference forward over a full prompt: the logits of the last
    position (the sampling entry point), a ``DTensor`` under a mesh."""
    p_shard = state_shardings(cfg, mesh)["params"] if mesh is not None else None

    @torch.no_grad()
    def prefill(params, batch):
        if mesh is not None:
            params = place(params, p_shard)
            batch = place(batch, batch_shardings(cfg, batch, mesh))
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        with use_mesh(mesh):
            return backbone.forward_train(params, batch["tokens"], cfg, extra)[:, -1, :]

    return prefill


def token_sharding(mesh, batch: int) -> NamedSharding:
    """A decode step's (B,) tokens: over the data axes where they divide B."""
    da = data_axes(mesh)
    size = 1
    for a in da:
        size *= axis_sizes(mesh)[a]
    return NamedSharding(mesh, PartitionSpec(da if da and batch % size == 0 else None))


def make_serve_step(cfg: ModelConfig, mesh, batch: int, s_max: int):
    """One decode step over a cache of length ``s_max``:
    ``serve(params, cache, tokens, pos) -> (logits (B, V) f32, cache)``
    (JAX's ``make_serve_step``), the params, the cache (by
    ``cache_shardings``) and the tokens placed on ``mesh``."""
    p_shard = state_shardings(cfg, mesh)["params"]
    c_shard = cache_shardings(cfg, batch, s_max, mesh)
    t_shard = token_sharding(mesh, batch)

    @torch.no_grad()
    def serve(params, cache, tokens, pos):
        params = place(params, p_shard)
        cache = place(cache, c_shard)
        tokens = place(tokens, t_shard)
        with use_mesh(mesh):
            return backbone.forward_decode(params, cache, tokens, pos, cfg)

    return serve
