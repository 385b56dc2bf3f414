"""Shared pieces of the serving tests over a mesh
(``test_torch_tp_serve.py``, ``test_torch_tp_decode_seq.py``): JAX's
greedy serving of one smoke config (its prefill, its cache and the
logits of each decode step), the port's world of one fed the same
tokens, the gloo job of ranks (``_torch_tp_serve_worker.py``, which
imports no JAX), and each rank's part of a whole cache by the placement
rules (``sharding/specs.py::cache_shardings`` and ``local_slices``, the
JAX package's rules, held to JAX's in ``test_torch_specs.py``), never by
the serving code under test.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_tp_serve_worker as W
from _torch_parity import jax_params_to_torch
from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models.model import build_model
from repro_torch.sharding.specs import Mesh, cache_shardings, local_slices


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def request(name, seed, *, batch, prompt, cache_len, steps, window=0,
            change=None):
    """JAX's parameters (bridged) and a request made with numpy from
    ``seed``: prompts (``batch``, ``prompt``) and, for an encoder config,
    ``enc_embeds``.  ``change(cfg)`` returns the config to serve in place
    of the named one (applied to JAX's and to the port's)."""
    cfg = jax_get_arch(name)
    port_cfg = get_arch(name)
    if change is not None:
        cfg, port_cfg = change(cfg), change(port_cfg)
    jm = jax_build_model(cfg, dtype=jnp.float32, decode_window=window)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, 512, (batch, prompt)).astype(np.int32)}
    if cfg.encoder is not None:
        b["enc_embeds"] = rng.standard_normal(
            (batch, cfg.encoder.enc_len, cfg.encoder.enc_dim)).astype(
            np.float32)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["tokens"] = tb["tokens"].long()
    return dict(name=name, jm=jm, jp=jp, jb=b, batch=tb, window=window,
                p0=jax_params_to_torch(jp), cache_len=cache_len,
                steps=steps, cfg=port_cfg)


def jax_serve(req):
    """JAX's prefill (logits, cache as numpy) and ``steps`` greedy decode
    steps (one jit of each): the tokens fed (B, steps) and each step's
    logits."""
    jm, jp = req["jm"], req["jp"]
    logits, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, cache_len=req["cache_len"]))(
        jp, {k: jnp.asarray(v) for k, v in req["jb"].items()})
    out = {"prefill": np.asarray(logits),
           "cache": jax.tree.map(np.asarray, cache), "steps": [],
           "fed": []}
    decode = jax.jit(jm.decode)
    tok = np.argmax(out["prefill"], -1)
    for _ in range(req["steps"]):
        out["fed"].append(tok)
        logits, cache = decode(jp, jnp.asarray(tok), cache)
        out["steps"].append(np.asarray(logits))
        tok = np.argmax(out["steps"][-1], -1)
    out["fed"] = np.stack(out["fed"], 1)
    return out


def port_serve(req, feed):
    """The port's world of one (no mesh) fed ``feed``: prefill logits,
    cache, each step's logits."""
    m = build_model(req["cfg"], decode_window=req["window"])
    logits, cache = m.prefill(req["p0"], req["batch"], req["cache_len"])
    out = {"prefill": logits, "cache": W._copy(cache), "steps": []}
    for i in range(req["steps"]):
        logits, cache = m.decode(req["p0"], torch.from_numpy(
            np.asarray(feed[:, i])).long(), cache)
        out["steps"].append(logits)
    out["cache_end"] = cache
    return out


def serve_job(tag, req, feed=None):
    return dict(kind="serve", tag=tag, name=req["name"], cfg=req["cfg"],
                p0=req["p0"],
                batch=req["batch"], cache_len=req["cache_len"],
                steps=req["steps"], window=req["window"],
                feed=None if feed is None else torch.from_numpy(
                    np.asarray(feed)).long())


def start(mesh, jobs, tmp):
    """A gloo job of ranks on a ``mesh`` = (data, model) running
    ``jobs``; the parent goes on while they run; :func:`join` waits."""
    world = mesh[0] * mesh[1]
    torch.save({"mesh": mesh, "jobs": jobs}, tmp / "inputs.pt")
    ctx = torch.multiprocessing.start_processes(
        W.main, args=(world, _free_port(), str(tmp)), nprocs=world,
        join=False, start_method="spawn")
    return ctx, tmp, world


def join(job):
    ctx, tmp, world = job
    while not ctx.join():
        pass
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def rank_part(cache, coords, shape, rows):
    """A rank's part of a whole cache tree (``layers``, ``index``, and
    ``enc_out`` where present): each leaf as ``cache_shardings`` places
    it on a mesh of ``shape`` at ``coords``, its batch dim (dim 1 of a
    leaf stacked over periods, dim 0 of ``enc_out``) the rank's ``rows``
    (a slice)."""
    mesh = Mesh(("data", "model"), dict(zip(("data", "model"), shape)),
                dict(coords), {}, torch.device("cpu"))
    whole = {"layers": tuple({k: torch.empty(np.shape(v), device="meta")
                              for k, v in e.items()}
                             for e in cache["layers"])}
    pl = cache_shardings(whole, mesh)
    out = {"layers": tuple(
        {k: _part(_np(v), p[k], mesh, rows, 1) for k, v in e.items()}
        for e, p in zip(cache["layers"], pl["layers"]))}
    if "enc_out" in cache:
        enc = _np(cache["enc_out"])
        epl = cache_shardings({"enc_out": torch.empty(enc.shape,
                                                      device="meta")}, mesh)
        out["enc_out"] = _part(enc, epl["enc_out"], mesh, rows, 0)
    return out


def _part(a, placement, mesh, rows, bdim):
    sl = list(local_slices(placement, a.shape, mesh))
    sl[bdim] = rows
    return a[tuple(sl)]


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]
