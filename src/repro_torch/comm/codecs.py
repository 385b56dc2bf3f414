"""GradientCodec plugin registry — the communication-compression uplink
(PyTorch port of ``repro/comm/codecs.py``).

A :class:`GradientCodec` encodes ONE client's gradient, per dtype group in
the fused engine's flat ``(rows, 128)`` fp32 layout
(:mod:`repro_torch.core.flat`), into a transport payload, and the server
decodes it into the Eq. (14) aggregation.  The round threads the codec
through the cohort executors (:meth:`repro_torch.core.executors.
CohortExecutor.run_coded`), so every client algorithm composes with every
codec unchanged.

Built-ins:

  * ``none``     — identity; the round never enters the codec stage, so it
    is the exact codec-free round;
  * ``int8``     — symmetric per-group int8 with one fp32 scale
    ``max(amax, 1e-30) / 127`` (about 4x less uplink);
  * ``sign1bit`` — 1-bit signs packed 8 to a byte plus one per-group
    magnitude ``mu = sum |g| / size`` (about 32x);
  * ``topk``     — the ``FedConfig.topk_ratio`` fraction of largest-|g|
    elements as (value, index) pairs.

``int8`` and ``sign1bit`` run on the kernels of
:mod:`repro_torch.kernels.comm` (quantize or pack with the error-feedback
residual in one sweep; decode fused into the accumulation, in place).
Their scale and magnitude are PyTorch reductions outside the kernels, as
the JAX package computes them in jnp outside its kernels: amax is
``torch.linalg.vector_norm`` with ord inf, exact and without the
full-size ``|g|`` temporary; ``mu`` is ``sum(|g|)`` as the JAX package
writes it (``vector_norm``'s ord-1 sum drifts by about 1e-6 on the CPU,
where ``torch.sum`` keeps about 5e-8).  ``topk`` is plain PyTorch
(``torch.topk`` on ``|g|`` and a scatter), as the JAX package has no
kernel for it.  Which index ``torch.topk`` keeps among equal magnitudes at
the k-th value is implementation-defined, here as in ``lax.top_k``.

Lossy codecs run in ``meta_mode='post'`` only: the hypergradient of
``through_aggregation`` would differentiate through the quantizer.

On a model axis above 1 (tensor-parallel client compute) a process holds
of a client's gradient the elements it owns, zero elsewhere, and the
executor hands ``encode`` / ``encode_ef`` the group's :class:`AxisShare`:
the statistic is the whole group's (int8's amax reduced by MAX, exact;
sign1bit's sum of |g| by SUM; topk's k picked from every process's
candidates), and what a process decodes at elements it does not own is
dropped by the caller (:func:`repro_torch.core.aggregate.
chunked_cohort_gradient_coded`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.flat import LANES, GroupSpec
from repro_torch.core.registry import Registry
from repro_torch.kernels.comm import ops as C

__all__ = ["GradientCodec", "AxisShare", "register_codec", "get_codec",
           "available_codecs", "resolve_codec"]


class AxisShare(NamedTuple):
    """One process's share of a dtype group on a model axis above 1:
    ``own`` is the group's ``(rows, 128)`` ownership mask (1.0 where the
    process holds the element, 0.0 elsewhere and in the pad;
    :meth:`repro_torch.sharding.tensor_parallel.ModelAxis.ownership`);
    ``max(x)`` / ``sum(x)`` reduce a 0-d tensor over the axis; ``gather(x)``
    concatenates every process's ``x`` on dim 0, in coordinate order."""
    own: torch.Tensor
    max: Callable
    sum: Callable
    gather: Callable


def share_kw(share: Optional[AxisShare]) -> dict:
    """``encode``'s keyword for ``share``: none without a model axis, so
    a codec that takes no share still runs there."""
    return {} if share is None else {"share": share}


class GradientCodec:
    """Protocol.  Every method works on ONE dtype group at a time."""
    name: str = "?"
    lossy: bool = True          # False: decode(encode(g)) == g exactly

    def encode(self, group: GroupSpec, g: torch.Tensor,
               share: Optional[AxisShare] = None) -> Any:
        """(rows, 128) fp32 gradient -> transport payload; ``share`` on a
        model axis above 1 (the module docstring)."""
        raise NotImplementedError

    def decode(self, group: GroupSpec, payload: Any) -> torch.Tensor:
        """Payload -> (rows, 128) fp32 reconstruction; pad elements (flat
        index >= group.size) decode to exact zero."""
        raise NotImplementedError

    def encode_ef(self, group: GroupSpec, e: torch.Tensor,
                  share: Optional[AxisShare] = None
                  ) -> Tuple[Any, torch.Tensor]:
        """Encode the error-compensated gradient ``e = g + residual``;
        returns (payload, new_residual = e - decode(payload)).  Codecs
        with a fused quantize-and-residual kernel override this."""
        payload = self.encode(group, e, **share_kw(share))
        return payload, e - self.decode(group, payload)

    def decode_fma(self, group: GroupSpec, acc: torch.Tensor, payload: Any,
                   w: torch.Tensor) -> torch.Tensor:
        """Server-side streaming aggregate ``acc + w * decode(payload)``
        (w: the client's normalized Eq. 14 weight, a device scalar),
        written into ``acc`` in place and returned."""
        return acc.add_(w * self.decode(group, payload))

    def payload_bytes(self, group: GroupSpec) -> int:
        """Uplink bytes one client ships for this group: group.size true
        elements plus per-group scalars, not the padded layout."""
        raise NotImplementedError


_CODECS = Registry("gradient codec",
                   "repro_torch.comm.codecs.register_codec")


def register_codec(name: str):
    """Decorator registering a codec factory ``factory(fed) -> codec``."""
    def deco(factory: Callable) -> Callable:
        _CODECS.register(name, factory)
        return factory
    return deco


def get_codec(name: str) -> Callable:
    return _CODECS.get(name)


def available_codecs() -> tuple:
    return _CODECS.names()


def resolve_codec(fed, *, codec: Optional[str] = None) -> GradientCodec:
    """An explicit registry name wins, then ``fed.codec`` (default
    'none')."""
    if codec is None:
        codec = getattr(fed, "codec", "none")
    return get_codec(codec)(fed)


# ---------------------------------------------------------------------------
# built-in codecs
# ---------------------------------------------------------------------------
@register_codec("none")
class NoneCodec(GradientCodec):
    """Identity transport: fp32 ships as it is.  ``lossy = False`` makes
    the round skip the codec stage, so 'none' is the codec-free round."""
    name = "none"
    lossy = False

    def __init__(self, fed=None):
        del fed

    def encode(self, group, g):
        return g

    def decode(self, group, payload):
        return payload

    def payload_bytes(self, group):
        return 4 * group.size


@register_codec("int8")
class Int8Codec(GradientCodec):
    """Symmetric per-group int8: one fp32 scale ``amax / 127`` per group,
    round half to even; the residual rides the quantize sweep and the
    decode the accumulation (``kernels/comm``)."""
    name = "int8"
    lossy = True

    def __init__(self, fed=None):
        del fed

    @staticmethod
    def _scale(g, share=None):
        amax = torch.linalg.vector_norm(g, float("inf"))
        if share is not None:
            amax = share.max(amax)
        return torch.clamp(amax, min=1e-30) / 127.0

    def encode(self, group, g, share=None):
        scale = self._scale(g, share)
        return {"q": C.quantize_i8(g, 1.0 / scale, scale), "scale": scale}

    def encode_ef(self, group, e, share=None):
        scale = self._scale(e, share)
        q, err = C.quantize_i8(e, 1.0 / scale, scale, with_error=True)
        return {"q": q, "scale": scale}, err

    def decode(self, group, payload):
        return payload["q"].to(torch.float32) * payload["scale"]

    def decode_fma(self, group, acc, payload, w):
        return C.dequant_i8_fma(acc, payload["q"], payload["scale"] * w,
                                out=acc)

    def payload_bytes(self, group):
        return group.size + 4                       # int8 elements + scale


@register_codec("sign1bit")
class Sign1BitCodec(GradientCodec):
    """signSGD-style 1-bit: sign bits packed 8 to a uint8 plus one
    per-group magnitude ``mu = mean |g|`` over the true elements; the
    kernels mask the layout pad back to zero."""
    name = "sign1bit"
    lossy = True

    def __init__(self, fed=None):
        del fed

    @staticmethod
    def _mu(group, g, share=None):
        total = torch.sum(torch.abs(g))
        if share is not None:
            total = share.sum(total)
        return total / float(group.size)

    def encode(self, group, g, share=None):
        mu = self._mu(group, g, share)
        return {"bits": C.sign_pack(g, mu, group.size), "mu": mu}

    def encode_ef(self, group, e, share=None):
        mu = self._mu(group, e, share)
        bits, err = C.sign_pack(e, mu, group.size, with_error=True)
        return {"bits": bits, "mu": mu}, err

    def decode(self, group, payload):
        zeros = torch.zeros((group.rows, LANES), dtype=torch.float32,
                            device=payload["bits"].device)
        return C.sign_unpack_fma(zeros, payload["bits"], payload["mu"],
                                 group.size, out=zeros)

    def decode_fma(self, group, acc, payload, w):
        return C.sign_unpack_fma(acc, payload["bits"], payload["mu"] * w,
                                 group.size, out=acc)

    def payload_bytes(self, group):
        return -(-group.size // 8) + 4              # ceil(size/8) bits + mu


@register_codec("topk")
class TopKCodec(GradientCodec):
    """Magnitude sparsification: the ``FedConfig.topk_ratio`` fraction of
    largest-|g| elements per group as (fp32 value, index) pairs.  Plain
    PyTorch (``torch.topk`` + scatter), as in the JAX package.  The port
    keeps int64 indices; ``payload_bytes`` counts the 4-byte index the
    JAX package ships."""
    name = "topk"
    lossy = True

    def __init__(self, fed=None):
        self._ratio = (getattr(fed, "topk_ratio", 0.01) if fed is not None
                       else 0.01)

    def _k(self, group: GroupSpec) -> int:
        return max(1, min(group.size, int(round(group.size * self._ratio))))

    def encode(self, group, g, share=None):
        flat = g.reshape(-1)
        k = self._k(group)
        if share is None:
            _, idx = torch.topk(torch.abs(flat), k, sorted=False)
            return {"values": flat[idx], "indices": idx}
        # a model axis: each process's k largest |g| among the elements it
        # owns (never one it does not: those score -1), every process's
        # candidates gathered, and the group's k picked from them by |g|,
        # then by global index, the same pick on every process
        score = torch.where(share.own.reshape(-1) > 0, torch.abs(flat), -1.0)
        top, idx = torch.topk(score, k, sorted=False)
        top, idx = share.gather(top), share.gather(idx)
        by_index = torch.argsort(idx, stable=True)
        top, idx = top[by_index], idx[by_index]
        idx = idx[torch.argsort(top, descending=True, stable=True)[:k]]
        return {"values": flat[idx], "indices": idx}

    def decode(self, group, payload):
        flat = torch.zeros((group.rows * LANES,), dtype=torch.float32,
                           device=payload["values"].device)
        flat[payload["indices"]] = payload["values"]
        return flat.reshape(group.rows, LANES)

    def payload_bytes(self, group):
        return 8 * self._k(group)                   # fp32 value + i32 index
