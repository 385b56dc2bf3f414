"""Public engine for the fused server-side update (PyTorch port of
``repro/kernels/fused_update/ops.py``).

Two sweeps over flat per-dtype-group fp32 buffers (:mod:`repro_torch.core.
flat`) per round:

  pass 1  kernel.aggregate_pass   cohort-weighted mean + ||G||^2
          (or, for the client-sequential scan cohort, one
          kernel.accumulate_pass per client: acc + w_k g_k)
  pass 2  kernel.update_pass      clip scale + sgd/sgdm/adam/yogi + write

Everything between the passes — weight normalization, ||G||, the clip
scale, bias corrections — stays on the device as 0-d tensors, so a round
never waits on the host for them.

The engine is differentiable: each kernel is wrapped in a
``torch.autograd.Function`` whose backward is the matching backward kernel
(``_Aggregate``, ``_Accumulate``, ``_Update``: the counterparts of JAX's
``_agg_vjp``, ``_acc_vjp`` and ``_upd_vjp``), so ``torch.autograd.grad``
through :func:`fused_server_update` — w.r.t. the client weights, the
learning rate, the stacked gradients and the parameters — costs the
backward kernels' sweeps.  That is what ``meta_mode='through_aggregation'``
(``core/meta.py``) differentiates.  When nothing requires grad (the post
meta mode) the Functions record no graph and save nothing.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import flat as flat_mod
from repro_torch.core.flat import FlatSpec, Params
from repro_torch.kernels.fused_update import kernel as K


def init_flat_opt_state(opt: str, spec: FlatSpec, device=None) -> Dict:
    """Optimizer state in the flat layout (one fp32 buffer per group)."""
    zeros = lambda: tuple(flat_mod.zeros_flat(spec, device))
    if opt == "sgd":
        return {}
    if opt == "sgdm":
        return {"m": zeros()}
    if opt in ("adam", "yogi"):
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}
    raise ValueError(opt)


def normalize_weights(client_weights: torch.Tensor) -> torch.Tensor:
    w = client_weights.to(torch.float32)
    return w / torch.clamp(torch.sum(w), min=1e-30)


class _Aggregate(torch.autograd.Function):
    """(g_stack, w_norm) -> (G, ssq); saves (g_stack, w_norm, G)."""

    @staticmethod
    def forward(ctx, g_stack, w_norm):
        G, ssq = K.aggregate_pass(g_stack, w_norm)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(g_stack, w_norm, G)
        return G, ssq

    @staticmethod
    def backward(ctx, dG, dssq):
        g_stack, w_norm, G = ctx.saved_tensors
        dg, dw = K.aggregate_pass_bwd(g_stack, w_norm, G, dG.contiguous(),
                                      dssq.contiguous())
        # the (cohort, rows, 128) dg is dropped here unless g_stack needs it
        return (dg if ctx.needs_input_grad[0] else None), dw


class _Accumulate(torch.autograd.Function):
    """(acc, g, w) -> acc + w g; the accumulator's cotangent passes
    through unchanged."""

    @staticmethod
    def forward(ctx, acc, g, w):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(g, w)
        return K.accumulate_pass(acc, g, w)

    @staticmethod
    def backward(ctx, d_out):
        g, w = ctx.saved_tensors
        d_out = d_out.contiguous()
        dg, dw = K.accumulate_pass_bwd(g, w, d_out)
        return (d_out, dg if ctx.needs_input_grad[1] else None,
                dw.reshape(w.shape))


class _Update(torch.autograd.Function):
    """(G, p, scalars, m, v) -> (p', m', v') with None slots per optimizer
    arity; saves (G, m, v, scalars) and the backward kernel replays the
    recurrence from them.  dp = dp' (p' = p - lr * step)."""

    @staticmethod
    def forward(ctx, G, p, scalars, m, v, hp):
        ctx.hp = hp
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(G, m, v, scalars)
        return K.update_pass(G, p, m, v, scalars, **hp)

    @staticmethod
    def backward(ctx, d_new_p, d_new_m, d_new_v):
        G, m, v, scalars = ctx.saved_tensors
        d_new_p = d_new_p.contiguous()
        cont = lambda t: None if t is None else t.contiguous()
        dG, dm, dv, dscal = K.update_pass_bwd(
            G, m, v, scalars, d_new_p, cont(d_new_m), cont(d_new_v),
            **ctx.hp)
        return dG, d_new_p, dscal, dm, dv, None


class _Unflatten(torch.autograd.Function):
    """Flat group buffers -> the parameter leaves; the backward is one
    :func:`repro_torch.core.flat.flatten_tree` of the leaves' cotangents
    instead of a zero-filled full-size scatter per leaf.

    Each leaf is a copy that owns its storage, not a view of the buffer:
    the new parameters become the next round's ``w_t``, and ``torch.func``
    differentiating the client update w.r.t. leaves that share one
    storage allocates several model-sized buffers more (``PERF.md``, the
    through-aggregation runs' peak memory)."""

    @staticmethod
    def forward(ctx, spec, *bufs):
        ctx.spec = spec
        return tuple(t.clone() for t in
                     flat_mod.unflatten_tree(spec, bufs).values())

    @staticmethod
    def backward(ctx, *d_leaves):
        spec = ctx.spec
        return (None, *flat_mod.flatten_tree(spec,
                                             dict(zip(spec.names, d_leaves))))


def flat_weighted_aggregate(spec: FlatSpec, g_stacks: Sequence[torch.Tensor],
                            client_weights: torch.Tensor
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Pass 1: normalize ``client_weights`` and reduce each group's
    ``(cohort, rows, 128)`` gradient stack.  Returns (G_groups, ssq) with
    ``ssq = ||G||^2`` summed over groups."""
    assert len(g_stacks) == len(spec.groups)
    w = normalize_weights(client_weights)
    Gs, ssq = [], None
    for g_stack in g_stacks:
        G, s = _Aggregate.apply(g_stack, w)
        Gs.append(G)
        ssq = s if ssq is None else ssq + s
    return Gs, ssq


def flat_accumulate(acc: torch.Tensor, g: torch.Tensor, w: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Streaming Eq. (14) term ``acc + w * g`` over one group buffer,
    differentiable in (acc, g, w).  ``out=`` writes in place and records no
    graph, so it refuses inputs that require grad."""
    if out is None:
        return _Accumulate.apply(acc, g, w)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (acc, g, w)):
        raise ValueError("flat_accumulate(out=...) is not differentiable")
    return K.accumulate_pass(acc, g, w, out=out)


def _scalar(x, device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``; a host number becomes a fill
    kernel's argument, not a host-to-device copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def flat_apply_groups(spec: FlatSpec, G_groups, gn: torch.Tensor,
                      params: Params, opt_state: Dict, *, opt: str, lr,
                      clip_norm: float = 0.0, momentum: float = 0.9,
                      b1: float = 0.9, b2: float = 0.99, eps: float = 1e-8,
                      mesh=None) -> Tuple[Params, Dict, torch.Tensor]:
    """Pass 2: clip scale + optimizer + param write over aggregated flat
    buffers, with the pre-clip global norm ``gn`` (a device scalar) from
    the caller.  Differentiable in ``G_groups``, ``gn``, ``lr`` (a tensor
    or a number), the parameters and the optimizer state.  With a
    ``mesh`` (a model axis above 1; ``spec`` carries each group's row
    slice, :func:`repro_torch.core.flat.with_pspecs`) the update kernel
    runs on this process's rows of each split group and an all-gather
    over the model axis returns the whole new parameters and slots to
    every process, bitwise the same.  The backward runs the update's
    backward kernel on the same rows: the rows' cotangents are
    all-gathered whole (:func:`repro_torch.core.flat.constrain_groups`),
    and the scalars enter the split groups through the axis's ``copy``,
    so their cotangents, partial over this process's rows, are summed
    over the axis before they reach ``gn``, ``lr`` and, through ``gn``,
    ``G_groups``.  Returns (new_params, new_opt_state, gn_after_clip)."""
    device = gn.device
    p_groups = flat_mod.flatten_tree(spec, params)
    if clip_norm > 0:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    else:
        scale = _scalar(1.0, device)
    if opt in ("adam", "yogi"):
        t = opt_state["t"] + 1
        tf = t.to(torch.float32)
        bc1 = 1.0 / (1.0 - torch.pow(_scalar(b1, device), tf))
        bc2 = 1.0 / (1.0 - torch.pow(_scalar(b2, device), tf))
    else:
        t = None
        bc1 = bc2 = _scalar(1.0, device)
    scalars = torch.stack([scale, _scalar(lr, device), bc1, bc2])

    ms = opt_state.get("m", (None,) * len(spec.groups))
    vs = opt_state.get("v", (None,) * len(spec.groups))
    hp = dict(opt=opt, momentum=momentum, b1=b1, b2=b2, eps=eps)
    rows = lambda bufs: (bufs if mesh is None or bufs[0] is None else
                         flat_mod.constrain_groups(spec, bufs, mesh))
    split = [False] * len(spec.groups)
    if mesh is not None:
        from repro_torch.sharding.tensor_parallel import row_axis
        split = flat_mod.split_groups(spec)
        scalars_rows = row_axis(mesh).copy(scalars)
    new_p, new_m, new_v = [], [], []
    for G, p, m, v, s in zip(rows(G_groups), rows(p_groups), rows(ms),
                             rows(vs), split):
        np_, nm, nv = _Update.apply(G, p, scalars_rows if s else scalars, m,
                                    v, hp)
        new_p.append(np_)
        new_m.append(nm)
        new_v.append(nv)
    if mesh is not None:
        whole = lambda bufs: (bufs if bufs[0] is None else
                              flat_mod.gather_groups(spec, bufs, mesh))
        new_p, new_m, new_v = whole(new_p), whole(new_m), whole(new_v)
    new_params = dict(zip(spec.names, _Unflatten.apply(spec, *new_p)))
    if opt == "sgd":
        new_state: Dict = {}
    elif opt == "sgdm":
        new_state = {"m": tuple(new_m)}
    else:
        new_state = {"m": tuple(new_m), "v": tuple(new_v), "t": t}
    return new_params, new_state, gn * scale


def fused_apply_flat(params: Params, G_groups, opt_state: Dict, *,
                     opt: str = "sgd", lr, clip_norm: float = 0.0,
                     momentum: float = 0.9, b1: float = 0.9,
                     b2: float = 0.99, eps: float = 1e-8,
                     spec: Optional[FlatSpec] = None, mesh=None
                     ) -> Tuple[Params, Dict, torch.Tensor]:
    """Pass 2 over ALREADY-aggregated buffers (the scan cohort's entry
    point): ||G||^2 is reduced here with plain PyTorch, as the JAX package
    reduces it with plain jnp — over the whole buffers, so each parameter
    counts once under a ``mesh`` too (:func:`flat_apply_groups`)."""
    if spec is None:
        spec = flat_mod.make_flat_spec(params)
    gn = torch.sqrt(flat_mod.flat_sq_norm(G_groups))
    return flat_apply_groups(spec, G_groups, gn, params, opt_state, opt=opt,
                             lr=lr, clip_norm=clip_norm, momentum=momentum,
                             b1=b1, b2=b2, eps=eps, mesh=mesh)


def fused_server_update(params: Params, grad_stack: Params,
                        client_weights: torch.Tensor, opt_state: Dict, *,
                        opt: str = "sgd", lr, clip_norm: float = 0.0,
                        momentum: float = 0.9, b1: float = 0.9,
                        b2: float = 0.99, eps: float = 1e-8,
                        spec: Optional[FlatSpec] = None
                        ) -> Tuple[Params, Dict, torch.Tensor]:
    """One fused server step over stacked per-client gradients (both
    passes).  grad_stack: ``params``' names with a leading cohort axis on
    every leaf; client_weights: (cohort,) n_k, un-normalized; opt_state:
    flat, from :func:`init_flat_opt_state`.  Returns (new_params,
    new_opt_state, grad_norm_after_clip)."""
    if spec is None:
        spec = flat_mod.make_flat_spec(params)
    Gs, ssq = flat_weighted_aggregate(
        spec, flat_mod.flatten_stacked(spec, grad_stack), client_weights)
    return flat_apply_groups(spec, Gs, torch.sqrt(ssq), params, opt_state,
                             opt=opt, lr=lr, clip_norm=clip_norm,
                             momentum=momentum, b1=b1, b2=b2, eps=eps)
