"""Plain PyTorch versions of the SSD-scan kernel.

``ssd_ref`` is the sequential recurrence, the counterpart of
``repro/kernels/ssd_scan/ref.py`` (the definitionally correct form):
h_t = exp(a_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t.

``ssd_chunked_ref`` is the chunked form of ``repro/models/ssm.py::
ssd_chunked`` that the JAX prefill runs and the kernel computes: within a
chunk of L positions a masked quadratic form, across chunks the carried
(N, P) state.  It zero-pads S to a multiple of L before ``a = dt * A``, as
JAX does, so padded positions carry the state unchanged to ``h_final``.
The CPU path and the tests run these; on the card they are only the
yardsticks the kernel is held to.

``ssd_chunk_parallel_ref`` renders the kernel's own decomposition in plain
PyTorch, for the tests only: (i) acum sequentially in index order, (ii)
each chunk's state, (iii) the states passed across the chunks, (iv) each
chunk's outputs, every matrix product through one function that a test may
replace (with an emulation of the kernel's 3xTF32 products).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x: (BH, S, P); dt, a: (BH, S, 1); Bm, Cm: (BH, S, N) -> (BH, S, P)."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = (torch.exp(a[:, t].float())[..., None] * h
             + torch.einsum("bn,bp->bnp", Bm[:, t].float(),
                            x[:, t].float() * dt[:, t].float()))
        ys.append(torch.einsum("bn,bnp->bp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype)


def expand_groups(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, heads, N): head h reads group h // (heads /
    G), as ``jnp.repeat(..., heads // G, axis=2)`` in the JAX block."""
    G = t.shape[2]
    return t if G == heads else t.repeat_interleave(heads // G, dim=2)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) (already softplus'ed); A: (H,)
    negative; Bm, Cm: (B, S, G, N) with G dividing H (G = H: broadcast
    already).  Returns (y (B, S, H, P), h_final (B, H, N, P) fp32), from
    a zero state."""
    B_, S, H, P = x.shape
    Bm, Cm = expand_groups(Bm, H), expand_groups(Cm, H)
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        zf = lambda t: F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    nc = x.shape[1] // L
    a = dt * A[None, None, :]                                  # <= 0
    rs = lambda t: t.reshape((B_, nc, L) + tuple(t.shape[2:])).transpose(0, 1)
    xc, dtc, ac, Bc, Cc = rs(x), rs(dt), rs(a), rs(Bm), rs(Cm)
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
    idx = torch.arange(L, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for xk, dtk, ak, Bk, Ck in zip(xc, dtc, ac, Bc, Cc):
        acum = torch.cumsum(ak.float(), dim=1)                 # (B, L, H)
        seg = acum[:, :, None, :] - acum[:, None, :, :]        # (B, t, s, H)
        decay = torch.exp(torch.where(tri, seg, -torch.inf))
        scores = torch.einsum("blhn,bmhn->blmh", Ck.float(), Bk.float())
        xdt = xk.float() * dtk[..., None]
        y_intra = torch.einsum("blmh,bmhp->blhp", scores * decay, xdt)
        y_inter = torch.einsum("blhn,bhnp->blhp",
                               Ck.float() * torch.exp(acum)[..., None], h)
        decay_to_end = torch.exp(acum[:, -1:, :] - acum)       # (B, L, H)
        h = (torch.exp(acum[:, -1])[:, :, None, None] * h
             + torch.einsum("blhn,blhp->bhnp",
                            Bk.float() * decay_to_end[..., None], xdt))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B_, nc * L, H, P)
    return y[:, :S].to(x.dtype), h


def sequential_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive cumsum along ``dim``, one position at a time in index
    order, each sum rounded on its own: how the kernel takes acum."""
    a = a.movedim(dim, 0)
    out = torch.empty_like(a)
    run = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        run = run + a[i]
        out[i] = run
    return out.movedim(0, dim)


def ssd_chunk_parallel_ref(x: torch.Tensor, dt: torch.Tensor,
                           A: torch.Tensor, Bm: torch.Tensor,
                           Cm: torch.Tensor, chunk: int,
                           mm: Callable = torch.matmul,
                           cumsum: Callable = sequential_cumsum
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as :func:`ssd_chunked_ref`, in the order the CUDA
    kernel computes it; ``mm(a, b)``, a batched ``a @ b``, takes every
    matrix product, ``cumsum(a, dim)``
    takes acum (default the kernel's sequential order; a test that holds
    the decomposition to another implementation hands it that one's)."""
    B_, S, H, P = x.shape
    Bm, Cm = expand_groups(Bm, H), expand_groups(Cm, H)
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        zf = lambda t: F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    nc = x.shape[1] // L
    # (B, H, nc, L, ...): one row per (b, h, chunk)
    rs = lambda t: t.reshape((B_, nc, L) + tuple(t.shape[2:])).movedim(
        3, 1).float()
    xc, Bc, Cc = rs(x), rs(Bm), rs(Cm)
    dtc = dt.reshape(B_, nc, L, H).movedim(3, 1).float()
    # (i) acum, sequentially in index order within each chunk
    acum = cumsum(dtc * A.float()[None, :, None, None], 3)
    aL = acum[..., -1:]
    xdt = xc * dtc[..., None]                                 # (B,H,nc,L,P)
    # (ii) each chunk's state (N, P)
    states = mm((Bc * torch.exp(aL - acum)[..., None]).transpose(-1, -2),
                xdt)
    # (iii) the state entering each chunk, in the reference's order
    h = torch.zeros((B_, H, N, P), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(aL[:, :, c])[..., None] * h + states[:, :, c]
    hc = torch.stack(entering, dim=2)                         # (B,H,nc,N,P)
    # (iv) the outputs
    idx = torch.arange(L, device=x.device)
    tri = idx[:, None] >= idx[None, :]
    seg = acum[..., :, None] - acum[..., None, :]
    decay = torch.exp(torch.where(tri, seg, -torch.inf))
    scores = mm(Cc, Bc.transpose(-1, -2)) * decay
    y = mm(scores, xdt) + torch.exp(acum)[..., None] * mm(Cc, hc)
    y = y.movedim(1, 3).reshape(B_, nc * L, H, P)
    return y[:, :S].to(x.dtype), h
