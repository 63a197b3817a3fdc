"""AdamW over param trees (port of ``src/repro/optim/adamw.py``).

The state mirrors the param tree (nested dicts of tensors); ``OptState``
keeps the JAX field names, so a checkpoint's leaf names are the same in
both packages (``opt.m.…``, ``opt.v.…``, ``opt.count``).  Decay masking
follows the usual convention: no decay on 1-D tensors (norms, biases).
Every function runs under ``torch.no_grad()`` and returns new trees, as the
JAX functions do; nothing is updated in place."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor  # () int32


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


@torch.no_grad()
def adamw_init(params) -> OptState:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    some = tree_leaves(params)[0]
    return OptState(
        m=tree_map(z, params),
        v=tree_map(z, params),
        count=torch.zeros((), dtype=torch.int32, device=some.device),
    )


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """``grads`` scaled so their global L2 norm is at most ``max_norm``, and
    the norm before scaling (f32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(
    grads,
    state: OptState,
    params,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """One AdamW step.  Returns (new params, new OptState)."""
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)

    def upd(g, m, v, p):
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        step = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay and p.dim() >= 2:  # no decay on norms/biases (1-D)
            step = step + weight_decay * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        return p_new, m_new, v_new

    out = tree_map(upd, grads, state.m, state.v, params)
    pick = lambda i: tree_map(lambda t: t[i], out) if isinstance(out, dict) else out[i]
    return pick(0), OptState(m=pick(1), v=pick(2), count=count)
