"""Mixture-of-Experts FFN of the port (PyTorch port of
``repro/models/moe.py``): top-k routing with per-group expert capacity.

Tokens are grouped (``group_size`` per group; a one-token decode step is a
group of its own, so a batch of decode steps never competes for one
group's capacity); each expert takes ``capacity = ceil(top_k * group_size
/ E * capacity_factor)`` tokens a group, in order of (k, token), and the
rest are dropped.  Two forms of one function, selected by
:func:`set_moe_impl` (the JAX package's ``MOE_IMPL`` selector; both give
the same routing and outputs):

  * :func:`moe_ffn_gather` — the gather dispatch of JAX's
    ``moe_ffn_gather``: each expert's slots are filled by integer indices
    (the tokens scattered into their slots, so that the backward is a
    gather, deterministic on the card), the experts' SwiGLU products are
    ``torch.bmm`` over ``(E, G*C, d)``, and each token gathers its K
    outputs back.  Memory O(G E C d), no dispatch products.
  * :func:`moe_ffn_einsum` — the dense one-hot einsum (Switch
    Transformer) form of JAX's ``moe_ffn_einsum``: two ``(G, S, E, C)``
    tensors and the dispatch and combine products over them.

:func:`moe_ffn` dispatches on ``MOE_IMPL``.  The port's default is
``"gather"``, where JAX's is ``"einsum"``: the einsum form's two
``(G, S, E, C)`` tensors are why the model never uses it, and the gather
form is the one that serves deepseek-v2-lite-16b at full width on one
card.  The dry run's ``--moe-impl`` defaults to ``einsum``, as JAX's CLI
does, so its cost is the program JAX's dry run compiles; the trainer and
the server run ``gather``.

No in-place ops on differentiable tensors and no ``torch.compile``: the
UGA client update takes jvp-of-grad through the MoE with ``torch.func``
(gradients reach the router through the combine weights).  Parameters
are the JAX layout: ``router`` (d, E) fp32, ``w_gate`` / ``w_up`` (E, d,
de), ``w_down`` (E, de, d) and, with shared experts, a ``shared`` dict of
``w_gate`` / ``w_up`` (d, de * num_shared) and ``w_down``.

Over a model axis (``tp``, tensor-parallel client compute) the experts
split: each process holds ``E / M`` of them, computes the whole routing
from the gathered router weight (so it is bitwise the unsharded one), runs
its own experts' slots and the partial outputs are summed over the axis
(:func:`_experts`, :func:`_finish`).  This is the eager meaning of JAX's
``set_expert_axis``: the experts' placement, not an all-to-all.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init, swiglu
from repro_torch.sharding.tensor_parallel import (all_gather_cat,
                                                  all_reduce_copy)

LEAVES = ("router", "w_down", "w_gate", "w_up")

# Dispatch selector ("gather" | "einsum"), a module-level hint as in the
# JAX package: a property of the launch, not of the model
MOE_IMPL = "gather"


def set_moe_impl(impl: str) -> None:
    global MOE_IMPL
    if impl not in ("gather", "einsum"):
        raise ValueError(f"moe impl {impl!r}: one of 'gather', 'einsum'")
    MOE_IMPL = impl


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             d_ff_dense: int, *, lead=(), dtype=torch.float32) -> dict:
    """The block's MoE leaves (the JAX tree: ``shared`` a dict of its
    own), each with the leading shape ``lead``."""
    de = cfg.d_expert or d_ff_dense
    E, lead = cfg.num_experts, tuple(lead)

    def experts(d_in, d_out):                  # N(0, 1/d_in), in place
        w = torch.randn(lead + (E, d_in, d_out), generator=gen,
                        device=gen.device)
        return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)

    p = {"router": dense_init(gen, d_model, E, lead=lead,
                              dtype=torch.float32)}   # the router in fp32
    p["w_gate"] = experts(d_model, de)
    p["w_up"] = experts(d_model, de)
    p["w_down"] = experts(de, d_model)
    if cfg.num_shared:
        ds = de * cfg.num_shared
        p["shared"] = {
            "w_gate": dense_init(gen, d_model, ds, lead=lead, dtype=dtype),
            "w_up": dense_init(gen, d_model, ds, lead=lead, dtype=dtype),
            "w_down": dense_init(gen, ds, d_model, lead=lead, dtype=dtype)}
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)``'s int64 values without its range check, which
    on the CPU reads the indices' min and max on the host (a read the
    roofline trace on fake tensors cannot follow; the CUDA path skips
    it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _top_k(xg: torch.Tensor, router: torch.Tensor, K: int):
    """The router on grouped tokens xg (G, S, d): (the renormalized top-k
    gates (G, S, K), their experts, the probabilities (G, S, E))."""
    logits = xg.to(torch.float32) @ router                    # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert, as lax.top_k breaks them: the
    # zero rows that pad the last group tie everywhere, and their k = 0
    # entries queue ahead of the real tokens' k = 1 entries
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return gate_vals, expert_idx, probs


def _slots(expert_idx: torch.Tensor, cfg: MoEConfig):
    """Each (token, k)'s place in its expert's queue within its group
    (k = 0 of every token first) and whether it fits the capacity C of a
    group of S tokens.  Returns (pos_in_e, keep, C)."""
    G, S, K = expert_idx.shape
    E = cfg.num_experts
    C = max(int(math.ceil(K * S / E * cfg.capacity_factor)), 1)
    onehot = _one_hot(expert_idx, E)                          # (G,S,K,E)
    oh_flat = onehot.permute(0, 2, 1, 3).reshape(G, K * S, E)
    pos_flat = torch.cumsum(oh_flat, dim=1) - oh_flat
    pos = pos_flat.reshape(G, K, S, E).permute(0, 2, 1, 3)    # (G,S,K,E)
    pos_in_e = (pos * onehot).sum(dim=-1)                     # (G, S, K)
    return pos_in_e, pos_in_e < C, C


def _route(xg: torch.Tensor, p, cfg: MoEConfig):
    """Routing of grouped tokens xg (G, S, d).  Returns (gate_vals,
    expert_idx, pos_in_e, keep, probs, C): the renormalized top-k gates
    and experts (G, S, K), each (token, k)'s place in its expert's queue
    (k = 0 of every token first) and whether it fits the capacity C."""
    gate_vals, expert_idx, probs = _top_k(xg, p["router"], cfg.top_k)
    pos_in_e, keep, C = _slots(expert_idx, cfg)
    return gate_vals, expert_idx, pos_in_e, keep, probs, C


class _Spread(NamedTuple):
    """This process's tokens among the groups of a batch whose rows split
    over processes (serving on a mesh): ``T`` of the batch's ``T_all``,
    from global token ``off``; the groups it touches start at global
    group ``g0``, its first token at place ``lo`` of it.  ``group`` is
    the process group the rows split over."""
    group: Any
    T: int
    T_all: int
    g0: int
    lo: int


def _route_spread(xg: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
                  sp: _Spread):
    """:func:`_route` of this process's tokens inside the batch's groups
    (xg: the groups it touches, zero where another process's tokens or the
    pad sit).  The gates come from its own tokens; the capacity slots
    from every token of those groups, whose experts are all-gathered over
    ``sp.group`` (a (T, K) integer tensor each), the pad's (zero rows,
    the lower experts) appended.  Another process's entries are not kept
    here: their process dispatches them.  Also returns a pad row's
    probabilities and top-1 expert, and whether each place is this
    process's."""
    G, S, d = xg.shape
    K = cfg.top_k
    gate_vals, expert_idx, probs = _top_k(xg, router, K)
    own_idx = expert_idx.reshape(-1, K)[sp.lo:sp.lo + sp.T]
    every = all_gather_cat(own_idx, 0, sp.group)              # (T_all, K)
    _, pad_idx, pad_probs = _top_k(xg.new_zeros((1, 1, d)), router, K)
    pad = (-sp.T_all) % S
    if pad:
        every = torch.cat([every, pad_idx.reshape(1, K).expand(pad, K)])
    expert_idx = every[sp.g0 * S:(sp.g0 + G) * S].reshape(G, S, K)
    pos_in_e, keep, C = _slots(expert_idx, cfg)
    own = torch.zeros(G * S, dtype=torch.bool, device=xg.device)
    own[sp.lo:sp.lo + sp.T] = True
    own = own.reshape(G, S)
    route = (gate_vals, expert_idx, pos_in_e, keep & own[..., None], probs,
             C)
    return route, (pad_probs.reshape(-1), pad_idx.reshape(-1)[0]), own


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
              cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load balance: E * sum_e mean prob_e * top-1 share_e,
    averaged over groups, times ``aux_loss_coef``."""
    E = cfg.num_experts
    me = probs.mean(dim=1)                                    # (G, E)
    ce = _one_hot(expert_idx[..., 0], E).to(torch.float32).mean(dim=1)
    return cfg.aux_loss_coef * E * (me * ce).sum(dim=-1).mean()


def _spread_aux(probs: torch.Tensor, expert_idx: torch.Tensor,
                own: torch.Tensor, pad_row, sp: _Spread, cfg: MoEConfig
                ) -> torch.Tensor:
    """:func:`_aux_loss` over the batch's groups from this process's part
    of them: each group's sums of the probabilities and of the top-1
    counts over its own tokens, summed over ``sp.group``, the pad's rows
    added to the last group."""
    G, S, E = probs.shape
    ownf = own[..., None].to(torch.float32)
    part = torch.stack([(probs * ownf).sum(1),
                        (_one_hot(expert_idx[..., 0], E).to(torch.float32)
                         * ownf).sum(1)])                       # (2, G, E)
    n_groups = -(-sp.T_all // S)
    tot = part.new_zeros((2, n_groups, E))
    tot[:, sp.g0:sp.g0 + G] = part
    tot = all_reduce_copy(tot, sp.group)
    pad = n_groups * S - sp.T_all
    if pad:
        pad_probs, pad_top1 = pad_row
        tot[0, -1] += pad * pad_probs
        tot[1, -1] += pad * _one_hot(pad_top1, E).to(torch.float32)
    me, ce = tot[0] / S, tot[1] / S
    return cfg.aux_loss_coef * E * (me * ce).sum(dim=-1).mean()


def _group(x: torch.Tensor, cfg: MoEConfig):
    """x (..., S, d) -> (groups (G, gs, d), token count T, pad).  A decode
    step (S = 1) makes every token its own group."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    T = tokens.shape[0]
    gs = 1 if x.dim() > 1 and x.shape[-2] == 1 else min(cfg.group_size, T)
    pad = (-T) % gs
    if pad:
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))], dim=0)
    return tokens.reshape(-1, gs, d), T, pad


def _group_batch(x: torch.Tensor, cfg: MoEConfig, tp=None):
    """:func:`_group`, returning (groups, token count T, spread).

    Serving on a mesh whose processes split the batch's rows (``tp`` a
    ``serve_axis`` whose rows are a part of the batch; not a decode step),
    the groups are the whole batch's, as JAX groups the batch it is given:
    ``gs = min(group_size, T_all)`` of the batch's token count, this
    process's tokens at their global offset in the flattened (B S) order,
    the pad in the last group of the batch.  Then the groups are those
    this process's tokens touch, zero elsewhere, and ``spread`` says where
    its tokens lie (:class:`_Spread`); else ``spread`` is None."""
    split = (None if tp is None or tp.serving is None
             or (x.dim() > 1 and x.shape[-2] == 1)
             else tp.serving.batch_split())
    if split is None:
        xg, T, _ = _group(x, cfg)
        return xg, T, None
    group, n, coord = split
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    T = tokens.shape[0]
    T_all = T * n
    gs = min(cfg.group_size, T_all)
    g0, lo = divmod(coord * T, gs)
    ng = -(-(lo + T) // gs)
    tokens = F.pad(tokens, (0, 0, lo, ng * gs - lo - T))
    return tokens.reshape(ng, gs, d), T, _Spread(group, T, T_all, g0, lo)


def _experts(xg: torch.Tensor, p, cfg: MoEConfig, tp,
             sp: Optional[_Spread] = None):
    """The routing, replicated, and this process's share of the experts.
    Returns (route (gate_vals, expert_idx, pos_in_e, keep, probs, C), the
    first expert this process holds, how many, the tokens and the gates
    as its experts take them, whether the experts are split, the aux
    loss).  ``sp``: this process's tokens among the batch's groups
    (:func:`_group_batch`), routed by :func:`_route_spread`.

    Over the model axis ``tp`` where it splits the experts (``router``'s
    E columns and the ``(E, ., .)`` stacks), the router WEIGHT is gathered
    whole and the logits computed at the unsharded shape, so the discrete
    routing (top-k, capacity slots) is bitwise that of the unsharded run;
    every process routes every token (the tokens are replicated, so no
    all-to-all) and keeps the entries of its own experts.  The tokens and
    the gates enter the experts through ``tp.copy``: each process's
    cotangent of them covers its own experts only, and the copy's
    backward sums them, so the router's gradient is whole again."""
    E = cfg.num_experts
    e_loc = p["w_gate"].shape[-3]
    split = tp is not None and tp.is_split(e_loc, E)
    router = tp.gather(p["router"], -1) if split else p["router"]
    if sp is None:
        route = _route(xg, {"router": router}, cfg)
        aux = _aux_loss(route[4], route[1], cfg)
    else:
        route, pad_row, own = _route_spread(xg, router, cfg, sp)
        aux = _spread_aux(route[4], route[1], own, pad_row, sp, cfg)
    if not split:
        return route, 0, E, xg, route[0], False, aux
    return (route, tp.coord * e_loc, e_loc, tp.copy(xg), tp.copy(route[0]),
            True, aux)


def _finish(y: torch.Tensor, xg: torch.Tensor, xs: torch.Tensor, p,
            cfg: MoEConfig, tp, split: bool) -> torch.Tensor:
    """The experts' output ``y`` (this process's partial sum where
    ``split``; ``xs`` the tokens as they entered its experts) plus the
    shared experts, whole on every process.  The shared experts split
    like the dense MLP (``w_gate``/``w_up`` columns, ``w_down`` rows)
    where the axis divides their width; a split one's partial sum joins
    the experts' before the one reduce."""
    sp = p.get("shared")
    ds = p["w_gate"].shape[-1] * cfg.num_shared
    sh_split = (sp is not None and tp is not None
                and tp.is_split(sp["w_gate"].shape[-1], ds))
    if sh_split:
        part = swiglu(xs if split else tp.copy(xg), sp["w_gate"],
                      sp["w_up"], sp["w_down"])
        y = y + part if split else y + tp.reduce(part)
    if split:
        y = tp.reduce(y)
    if sp is not None and not sh_split:
        y = y + swiglu(xg, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y


def _ungroup(y: torch.Tensor, T: int, sp: Optional[_Spread], shape
             ) -> torch.Tensor:
    lo = 0 if sp is None else sp.lo
    return y.reshape(-1, y.shape[-1])[lo:lo + T].reshape(shape)


def moe_ffn(x: torch.Tensor, p, cfg: MoEConfig, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch per the ``MOE_IMPL`` selector.  ``tp``: the model axis
    (:class:`repro_torch.sharding.tensor_parallel.ModelAxis`) whose
    shards ``p`` holds: each process runs its own experts
    (:func:`_experts`), the outputs summed over the axis."""
    if MOE_IMPL == "einsum":
        return moe_ffn_einsum(x, p, cfg, tp)
    return moe_ffn_gather(x, p, cfg, tp)


def moe_ffn_gather(x: torch.Tensor, p, cfg: MoEConfig, tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather dispatch.  x: (..., S, d) -> (same shape, aux loss).  ``p``
    is one layer's MoE tree."""
    xg, T, sp = _group_batch(x, cfg, tp)
    G, S, d = xg.shape
    K = cfg.top_k
    route, lo, E, xe_in, gate_vals, split, aux = _experts(xg, p, cfg, tp,
                                                          sp)
    _, expert_idx, pos_in_e, keep, probs, C = route
    # this process's experts [lo, lo + E): the others' entries are dropped
    # here (gate 0, dispatched to the scratch slot) and summed in by their
    # own process
    mine = (expert_idx >= lo) & (expert_idx < lo + E)
    keep_l = keep & mine
    e_l = torch.where(mine, expert_idx - lo, 0)
    gate_vals = gate_vals * keep_l.to(gate_vals.dtype)

    # dispatch: each kept (token, k) entry's token written to its slot by
    # a scatter, whose backward is a gather (a gather dispatch's backward
    # would sum a token's K slots by atomic adds, in an order that changes
    # the bits from run to run); the dropped entries go to a scratch slot
    # past the last, cut off; an empty slot stays zero
    pos_w = torch.where(keep_l, pos_in_e, C - 1)
    dest = torch.where(keep_l, e_l * C + pos_in_e, E * C).reshape(G, S * K, 1)
    src = xe_in[:, :, None, :].expand(G, S, K, d).reshape(G, S * K, d)
    xe = torch.zeros((G, E * C + 1, d), dtype=xg.dtype, device=x.device
                     ).scatter(1, dest.expand(G, S * K, d), src)[:, :E * C]

    # the experts: (E, G*C, d) x (E, d, de)
    xe_f = xe.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe_f, p["w_gate"])) * torch.bmm(xe_f, p["w_up"])
    ye_f = torch.bmm(h, p["w_down"])
    ye = ye_f.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine: each token's K expert outputs, weighted by its gates
    flat_slot = (e_l * C + pos_w).reshape(G, S * K)
    yk = torch.gather(ye, 1, flat_slot[..., None].expand(G, S * K, d))
    y = (yk.reshape(G, S, K, d) * gate_vals[..., None].to(yk.dtype)).sum(2)
    y = _finish(y, xg, xe_in, p, cfg, tp, split)
    return _ungroup(y, T, sp, x.shape), aux


def moe_ffn_einsum(x: torch.Tensor, p, cfg: MoEConfig, tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot einsum dispatch: the oracle :func:`moe_ffn_gather`
    is held to."""
    xg, T, sp = _group_batch(x, cfg, tp)
    route, lo, E, xe_in, gate_vals, split, aux = _experts(xg, p, cfg, tp,
                                                          sp)
    _, expert_idx, pos_in_e, keep, probs, C = route
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    # this process's experts [lo, lo + E): another's index one-hots to 0
    onehot = _one_hot(expert_idx - lo, E).to(torch.float32)
    # a dropped entry's place (>= C) is clamped, then zeroed by keep
    slot_oh = (_one_hot(torch.clamp(pos_in_e, max=C - 1), C)
               .to(torch.float32) * keep[..., None])
    combine = torch.einsum("gske,gskc->gsec", onehot * gate_vals[..., None],
                           slot_oh)
    dispatch = (combine > 0).to(xg.dtype)                     # (G,S,E,C)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xe_in)
    h = (F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
         * torch.einsum("gecd,edf->gecf", xe, p["w_up"]))
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(ye.dtype), ye)
    y = _finish(y, xg, xe_in, p, cfg, tp, split)
    return _ungroup(y, T, sp, x.shape), aux
