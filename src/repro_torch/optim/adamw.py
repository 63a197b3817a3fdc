"""AdamW over param trees (port of ``src/repro/optim/adamw.py``).

The state mirrors the param tree (nested dicts of tensors); ``OptState``
keeps the JAX field names, so a checkpoint's leaf names are the same in
both packages (``opt.m.…``, ``opt.v.…``, ``opt.count``).  Decay masking
follows the usual convention: no decay on 1-D tensors (norms, biases).
Every function runs under ``torch.no_grad()`` with one body, which updates
its trees in place, a leaf at most ``CHUNK`` elements at a time.  A caller
that donates its trees (``donate=True``, the JAX train step's
``donate_argnums``) gets them back updated; any other call updates copies
and returns new trees, as the JAX functions do.  At granite-moe-3b's 3.4 B
parameters the new trees would need another 54 GB of fp32 beside the old
ones.

Under a mesh the leaves are ``DTensor`` s: the global norm is a sum over
them (``DTensor`` reduces it across the ranks), and the clip's scaling and
AdamW's passes, which are elementwise, run on each rank's local shards
(grads, moments and params placed alike), in place."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor


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
def clip_by_global_norm(grads, max_norm: float, *, donate: bool = False):
    """``grads`` scaled so their global L2 norm is at most ``max_norm``, and
    the norm before scaling (f32).  ``donate`` scales ``grads`` in place."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    if isinstance(gn, DTensor):
        gn = gn.full_tensor()
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    if not donate:
        grads = tree_map(torch.clone, grads)
    for g in tree_leaves(grads):
        (g.to_local() if isinstance(g, DTensor) else g).mul_(scale)
    return grads, gn


CHUNK = 1 << 26  # elements an update pass takes at once: 256 MiB a temporary in fp32


def _chunks(*leaves):
    """Equal views of same-shaped leaves: runs of whole rows along dim 0
    (layers of a stacked leaf) of at most ``CHUNK`` elements where the leaf
    is larger, else the leaves whole."""
    x = leaves[0]
    if x.dim() == 0 or x.numel() <= CHUNK:
        return (leaves,)
    rows = max(1, CHUNK * x.shape[0] // x.numel())
    return zip(*(t.split(rows) for t in leaves))


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
    donate: bool = False,
):
    """One AdamW step.  Returns (new params, new OptState); with ``donate``,
    ``params`` and ``state``'s moments updated in place (fp32 params)."""
    if not donate:
        params = tree_map(torch.clone, params)
        state = state._replace(m=tree_map(torch.clone, state.m), v=tree_map(torch.clone, state.v))
    count = state.count + 1
    cf = count.float()
    bc1 = 1.0 - torch.pow(b1, cf)
    bc2 = 1.0 - torch.pow(b2, cf)

    def upd_(g, m, v, p):
        decay = weight_decay and p.dim() >= 2  # no decay on norms/biases (1-D)
        g, m, v, p = (x.to_local() if isinstance(x, DTensor) else x for x in (g, m, v, p))
        for g, m, v, p in _chunks(g, m, v, p):
            gf = g.float()
            m.mul_(b1).add_(gf * (1 - b1))
            t = gf * (1 - b2)
            v.mul_(b2).add_(t.mul_(gf))
            step = m / bc1
            denom = v / bc2
            step.div_(denom.sqrt_().add_(eps))
            if decay:
                step.add_(weight_decay * p)
            p.sub_(step.mul_(lr))

    tree_map(upd_, grads, state.m, state.v, params)
    return params, OptState(m=state.m, v=state.v, count=count)
