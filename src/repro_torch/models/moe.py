"""Mixture-of-experts FFN: top-k token-choice routing with static-capacity
sort-based dispatch, GShard/Switch style (port of ``src/repro/models/moe.py``).

The router is f32 (its weight stays fp32 under ``backbone.compute_params``).
Per token group: softmax, top-k (ties to the lower expert, as
``jax.lax.top_k``), the chosen weights renormalized, the (token, slot) pairs
sorted stably by expert, each pair ranked within its expert by
``searchsorted``; pairs ranked at or past the capacity are dropped into one
extra row.  The experts' SwiGLU runs as three batched products over the
experts, and each token sums its weighted expert outputs.

The capacity is a host int computed from shapes, and nothing here reads a
device value on the host, so the dispatch never waits for the card and a
CUDA graph can capture it.  The scatter back is deterministic on the card:
each token adds its contributions in ascending expert order, one add after
another (the order of JAX's sequential scatter over the stable sort), not
with atomics.

Without a mesh the JAX package runs grouped dispatch (``moe_groups > 0``) as
a ``vmap`` of the global dispatch over the groups; here a leading group
axis carries the same computation, capacity evaluated per group.  The
products stay ``torch.matmul``: the JAX package computes them as einsums
outside any Pallas kernel.

Under a mesh (``parallel.ctx.use_mesh``) the routed experts run in a local
region (``shard_map_compat``), as JAX's ``_grouped_dispatch`` runs under
``shard_map``: where the (pod, data) axes divide the groups, each rank
dispatches its own groups only, so the sort, gather and scatter never
cross a data shard; otherwise every rank runs the whole dispatch.  The
model axis keeps its split of the expert weights inside the region, as
JAX's partitioner keeps it (the axis is "auto" there): under the expert
rules (experts over ``model``) each rank runs the FFN of its own experts
on their rows of the dispatch, under the TP rules (``expert_ffn`` over
``model``) its slice of every expert's hidden width; either way its
output is a partial sum over ``model``, which ``DTensor`` reduces where
it is next read.  Only the axes that split ``embed`` (FSDP's ``data``)
are gathered.  The shared expert runs outside the region on the
``DTensor`` s.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch._shardmap_compat import PartitionSpec, axis_sizes, shard_map_compat
from repro_torch.models.layers import cdt
from repro_torch.models.params import P
from repro_torch.parallel.ctx import current_mesh


def moe_spec(cfg):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    s = {
        "router": P((d, e), ("embed", None)),
        "wi": P((e, d, f), ("experts", "embed", "expert_ffn")),
        "wg": P((e, d, f), ("experts", "embed", "expert_ffn")),
        "wo": P((e, f, d), ("experts", "expert_ffn", "embed")),
    }
    if cfg.n_shared:
        s["shared"] = {
            "wi": P((d, cfg.n_shared * f), ("embed", "ffn")),
            "wg": P((d, cfg.n_shared * f), ("embed", "ffn")),
            "wo": P((cfg.n_shared * f, d), ("ffn", "embed")),
        }
    return s


class Routing(NamedTuple):
    """The dispatch decisions of ``route``; every field has a leading group
    axis G, and the pair axis (T·k) is in the stable by-expert order."""

    topi: torch.Tensor  # (G, T, k) int64: chosen experts, by falling weight
    topw: torch.Tensor  # (G, T, k) f32: their renormalized weights
    order: torch.Tensor  # (G, T·k) int64: the stable sort of the pairs by expert
    eid_s: torch.Tensor  # (G, T·k) int64: expert of each sorted pair
    tok_s: torch.Tensor  # (G, T·k) int64: token of each sorted pair
    w_s: torch.Tensor  # (G, T·k) f32: weight of each sorted pair
    rank: torch.Tensor  # (G, T·k) int64: rank within its expert
    ok: torch.Tensor  # (G, T·k) bool: rank < capacity (kept)
    slot: torch.Tensor  # (G, T·k) int64: row of (E·cap + 1); dropped pairs E·cap


def router_logits(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """(G, T, d) tokens → (G, T, E) f32 logits."""
    return xg.float() @ router.float()


def route(logits: torch.Tensor, k: int, cap: int) -> Routing:
    """Top-k routing and capacity dispatch of (G, T, E) f32 logits."""
    g, t, e = logits.shape
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal weights keep the lower expert first
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = srt.values[..., :k], srt.indices[..., :k]
    topw = topw / topw.sum(-1, keepdim=True)  # renormalize over the chosen
    # flatten (token, slot) pairs and rank each within its expert in the
    # sorted order: its index less the first index of its expert
    eid = topi.reshape(g, t * k)
    dev = logits.device
    order = torch.sort(eid, dim=-1, stable=True).indices
    eid_s = eid.gather(1, order)
    tok_s = torch.div(order, k, rounding_mode="floor")  # pair t·k + j is token t's
    w_s = topw.reshape(g, t * k).gather(1, order)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    first = torch.searchsorted(eid_s, experts, side="left")  # (G, E)
    rank = torch.arange(t * k, device=dev) - first.gather(1, eid_s)
    ok = rank < cap
    slot = torch.where(ok, eid_s * cap + rank, e * cap)  # overflow → the dropped row
    return Routing(topi, topw, order, eid_s, tok_s, w_s, rank, ok, slot)


def _experts(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """(E, N, a) @ (E, a, b) → (E, N, b): one batched product over the experts."""
    return torch.matmul(x, w.to(dt))


def _dispatch_ffn(p, xg, cfg, cap: int, e0: int = 0):
    """Capacity dispatch + expert SwiGLU over G token groups.
    xg: (G, T, d) → (G, T, d).  ``p``'s expert weights may hold a run of
    the experts alone, from expert ``e0`` on (a rank's own, under a mesh):
    then only those experts' rows run, and the others add nothing."""
    dt = cdt(cfg)
    g, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(router_logits(p["router"], xg), k, cap)

    # gather the tokens to (G, E·cap + 1, d).  Every dropped pair writes the
    # extra row E·cap, so that row's duplicate writes race; it is thrown
    # away below, so which of them lands does not matter.
    rows = e * cap + 1
    src = xg.gather(1, r.tok_s[..., None].expand(g, t * k, d)).to(dt)
    xe = torch.zeros((g, rows, d), dtype=dt, device=xg.device)
    xe = xe.scatter(1, r.slot[..., None].expand(g, t * k, d), src)
    # experts first: (E, G·cap, d)
    xe = xe[:, :-1].reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)

    # expert FFN (SwiGLU) of the experts held, e0 … e0 + el
    el = p["wi"].shape[0]
    xe = xe[e0:e0 + el]
    h = _experts(xe, p["wi"], dt)
    gate = _experts(xe, p["wg"], dt)
    ye = _experts(F.silu(gate) * h, p["wo"], dt)  # (el, G·cap, d)
    if el < e:
        ye = F.pad(ye, (0, 0, 0, 0, e0, e - e0 - el))
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

    return scatter_back(ye, r, t)


def scatter_back(ye: torch.Tensor, r: Routing, t: int) -> torch.Tensor:
    """(G, E·cap, d) expert outputs → (G, T, d): each token's weighted
    outputs, added one after another in ascending expert order (the order
    of JAX's sequential scatter-add over the stable sort), with no atomics.
    Position ``inv[i]`` of pair i in the sorted order; a token's pairs in
    ascending position are its experts in ascending order."""
    g, ec, d = ye.shape
    k = r.topi.shape[-1]
    pairs = torch.arange(t * k, device=ye.device).expand(g, t * k)
    inv = torch.empty_like(r.order).scatter_(1, r.order, pairs)
    pos = inv.reshape(g, t, k).sort(dim=-1).values.reshape(g, t * k)
    slot = r.slot.clamp(max=ec - 1).gather(1, pos)
    w = torch.where(r.ok, r.w_s, 0.0).gather(1, pos)
    parts = ye.gather(1, slot[..., None].expand(g, t * k, d)) * w[..., None].to(ye.dtype)
    parts = parts.reshape(g, t, k, d)
    y = torch.zeros((g, t, d), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        y = y + parts[:, :, j]
    return y


def capacity(cfg, tokens: int) -> tuple:
    """(groups, capacity per expert and group) for ``tokens`` tokens: host
    ints, from shapes alone."""
    e, k = cfg.n_experts, cfg.top_k
    g = cfg.moe_groups if cfg.moe_groups and tokens % cfg.moe_groups == 0 else 1
    return g, int(max(1, round(tokens / g * k / e * cfg.capacity_factor)))


def _model_split(w, mesh):
    """The dim of expert weight ``w`` that the mesh's ``model`` axis
    splits, or None."""
    if not isinstance(w, DTensor) or "model" not in mesh.mesh_dim_names:
        return None
    pl = w.placements[mesh.mesh_dim_names.index("model")]
    return pl.dim if isinstance(pl, Shard) else None


def _routed_under_mesh(p, xg, cfg, cap: int, mesh):
    """``_dispatch_ffn`` of (G, T, d) groups in a local region over ``mesh``:
    each rank's own groups when the (pod, data) axes divide G > 1, else all
    of them on every rank; each rank's own experts, or its slice of their
    hidden width, where ``model`` splits the expert weights."""
    sizes = axis_sizes(mesh)
    manual = tuple(a for a in ("pod", "data") if a in sizes)
    shards = 1
    for a in manual:
        shards *= sizes[a]
    if xg.shape[0] == 1 or xg.shape[0] % shards:
        manual = ()
    spec = PartitionSpec(manual or None, None, None)
    routed = {k: p[k] for k in ("router", "wi", "wg", "wo")}
    wspecs = {"router": PartitionSpec()}
    for k in ("wi", "wg", "wo"):
        split = _model_split(routed[k], mesh)
        wspecs[k] = PartitionSpec(*("model" if dim == split else None for dim in range(3)))
    split = _model_split(routed["wi"], mesh)
    by_model = ("model",) if split is not None else ()
    e0 = mesh.get_local_rank("model") * (cfg.n_experts // sizes["model"]) if split == 0 else 0
    fn = shard_map_compat(lambda p_, xx: _dispatch_ffn(p_, xx, cfg, cap, e0), mesh=mesh,
                          in_specs=(wspecs, spec), out_specs=spec, manual=manual + by_model,
                          partial=by_model)
    return fn(routed, xg)


def moe_apply(p, x, cfg):
    """x: (B, S, d) → (B, S, d).  Static capacity = T·k/E·cf per expert.

    ``cfg.moe_groups > 0`` routes tokens within fixed groups; routing is the
    same except that capacity overflow is evaluated per group (the same
    total capacity)."""
    dt = cdt(cfg)
    b, s, d = x.shape
    t = b * s
    g, cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    mesh = current_mesh()
    if mesh is None:
        y = _dispatch_ffn(p, xf.reshape(g, t // g, d), cfg, cap)
    else:
        y = _routed_under_mesh(p, xf.reshape(g, t // g, d), cfg, cap, mesh)
    y = y.reshape(t, d)

    if cfg.n_shared:
        sp = p["shared"]
        hs = xf @ sp["wi"].to(dt)
        gs = xf @ sp["wg"].to(dt)
        y = y + (F.silu(gs) * hs) @ sp["wo"].to(dt)

    return y.reshape(b, s, d)


def aux_load_balance_loss(logits: torch.Tensor, topi: torch.Tensor, n_experts: int):
    """Switch-style auxiliary load-balancing loss: ``n_experts`` times the
    dot product of the mean router probability and the top-1 routed
    fraction of each expert."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = probs.mean(0)  # mean router prob per expert
    ce = F.one_hot(topi[..., 0].long(), n_experts).float().mean(0)  # top-1 fraction
    return n_experts * torch.sum(me * ce)
