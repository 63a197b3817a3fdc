"""Train and prefill steps (port of ``src/repro/train/step.py``).

The JAX package jit-compiles these with explicit shardings over a mesh;
the port runs them eagerly on one device and takes no mesh (parallelism is
ROADMAP.md queue A, item 9).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_update, clip_by_global_norm, warmup_cosine
from repro_torch.optim.adamw import tree_leaves, tree_map


class TrainStepOut(NamedTuple):
    params: Any
    opt_state: Any
    metrics: Any


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(
    cfg: ModelConfig,
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
    those of the step that does not donate."""

    def loss_and_grads(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = backbone.loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return loss.detach(), _unflatten(params, grads)

    def grads_of(params, batch):
        if microbatch:
            b = next(iter(batch.values())).shape[0]
            n_acc = max(1, b // microbatch)
            g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            l_acc = 0.0
            for i in range(n_acc):
                mb = {k: x[i * microbatch:(i + 1) * microbatch] for k, x in batch.items()}
                l, g = loss_and_grads(params, mb)
                g_acc = tree_map(lambda a, b_: a + b_, g_acc, g)
                l_acc = l_acc + l
            return l_acc / n_acc, tree_map(lambda x: x / n_acc, g_acc)
        return loss_and_grads(params, batch)

    def step_fn(params, opt_state, batch, step):
        l, g = grads_of(params, batch)
        g, gnorm = clip_by_global_norm(g, grad_clip, donate=donate)
        lr = schedule(step, peak=lr_peak).to(l.device)
        params, opt_state = adamw_update(g, opt_state, params, lr, donate=donate)
        metrics = {"loss": l, "grad_norm": gnorm, "lr": lr}
        return TrainStepOut(params, opt_state, metrics)

    return step_fn


def make_prefill_step(cfg: ModelConfig):
    """Inference forward over a full prompt: the logits of the last
    position (the sampling entry point)."""

    @torch.no_grad()
    def prefill(params, batch):
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        return backbone.forward_train(params, batch["tokens"], cfg, extra)[:, -1, :]

    return prefill
