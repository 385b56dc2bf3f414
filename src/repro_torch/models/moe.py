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
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import dense_init, swiglu

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


def _route(xg: torch.Tensor, p, cfg: MoEConfig):
    """Routing of grouped tokens xg (G, S, d).  Returns (gate_vals,
    expert_idx, pos_in_e, keep, probs, C): the renormalized top-k gates
    and experts (G, S, K), each (token, k)'s place in its expert's queue
    (k = 0 of every token first) and whether it fits the capacity C."""
    G, S, _ = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = xg.to(torch.float32) @ p["router"]               # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert, as lax.top_k breaks them: the
    # zero rows that pad the last group tie everywhere, and their k = 0
    # entries queue ahead of the real tokens' k = 1 entries
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    C = max(int(math.ceil(K * S / E * cfg.capacity_factor)), 1)
    onehot = _one_hot(expert_idx, E)                          # (G,S,K,E)
    oh_flat = onehot.permute(0, 2, 1, 3).reshape(G, K * S, E)
    pos_flat = torch.cumsum(oh_flat, dim=1) - oh_flat
    pos = pos_flat.reshape(G, K, S, E).permute(0, 2, 1, 3)    # (G,S,K,E)
    pos_in_e = (pos * onehot).sum(dim=-1)                     # (G, S, K)
    keep = pos_in_e < C
    return gate_vals, expert_idx, pos_in_e, keep, probs, C


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
              cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load balance: E * sum_e mean prob_e * top-1 share_e,
    averaged over groups, times ``aux_loss_coef``."""
    E = cfg.num_experts
    me = probs.mean(dim=1)                                    # (G, E)
    ce = _one_hot(expert_idx[..., 0], E).to(torch.float32).mean(dim=1)
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


def _experts(xg: torch.Tensor, p, cfg: MoEConfig, tp):
    """The routing, replicated, and this process's share of the experts.
    Returns (route (gate_vals, expert_idx, pos_in_e, keep, probs, C), the
    first expert this process holds, how many, the tokens and the gates
    as its experts take them, whether the experts are split).

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
    route = _route(xg, {"router": router}, cfg)
    if not split:
        return route, 0, E, xg, route[0], False
    return route, tp.coord * e_loc, e_loc, tp.copy(xg), tp.copy(route[0]), \
        True


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


def _ungroup(y: torch.Tensor, T: int, pad: int, shape) -> torch.Tensor:
    y = y.reshape(-1, y.shape[-1])
    return (y[:T] if pad else y).reshape(shape)


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
    xg, T, pad = _group(x, cfg)
    G, S, d = xg.shape
    K = cfg.top_k
    route, lo, E, xe_in, gate_vals, split = _experts(xg, p, cfg, tp)
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
    return _ungroup(y, T, pad, x.shape), _aux_loss(probs, expert_idx, cfg)


def moe_ffn_einsum(x: torch.Tensor, p, cfg: MoEConfig, tp=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot einsum dispatch: the oracle :func:`moe_ffn_gather`
    is held to."""
    xg, T, pad = _group(x, cfg)
    route, lo, E, xe_in, gate_vals, split = _experts(xg, p, cfg, tp)
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
    return _ungroup(y, T, pad, x.shape), _aux_loss(probs, expert_idx, cfg)
