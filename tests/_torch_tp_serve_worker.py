"""The process body of ``tests/test_torch_tp_serve.py`` and
``tests/test_torch_tp_decode_seq.py``: one rank of a gloo job on the CPU,
launched as ``torchrun`` would launch it.  It imports torch and the port
only, never JAX: the parent hands it the jobs in ``<out>/inputs.pt`` and
compares what each rank writes to ``<out>/rank<r>.pt``.

A serving job (``kind`` "serve") runs, on a (data, model) mesh of the
job's world, one request: this rank's shards of the parameters
(:func:`repro_torch.sharding.tensor_parallel.serve_axis`), its rows of
the batch, ``model.prefill`` into a cache of ``cache_len``, then
``steps`` decode steps fed ``feed`` (the teacher's tokens, one column a
step) or, without it, the greedy tokens; ``cfg`` (a config in place of
the named one's) is optional.  It records the prefill's
logits, this rank's cache after the prefill and after the last step,
every step's logits and the tokens it fed.

A MoE job (``kind`` "moe") runs one MoE FFN on this rank's rows of a
batch under the serving axis of the whole batch, and records its
tokens' routing, the output and the aux loss.

A partials job (``kind`` "partials") holds the sequence-split decode of
``models/attention.py`` on the model axis: q against this rank's half of
a cache whose valid positions all lie in rank 0's half (rank 1 holds no
valid slot), merged by ``sharding/longctx.py::sharded_flash_decode``.
"""
import os

import torch


def _serve(job, mesh):
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    from repro_torch.sharding.tensor_parallel import serve_axis
    cfg = job.get("cfg") or get_arch(job["name"])
    model = build_model(cfg, decode_window=job.get("window", 0))
    p0, batch = job["p0"], job["batch"]
    B = batch["tokens"].shape[0]
    S = job.get("window") or job["cache_len"]
    tp = serve_axis(mesh, p0, batch=B, cache_len=S)
    rows = tp.serving.batch_rows()
    params = tp.shard(p0)
    mine = {k: v[rows] for k, v in batch.items()}
    logits, cache = model.prefill(params, mine, S, tp=tp)
    out = {"rows": (rows.start, rows.stop), "prefill": logits,
           "cache": _copy(cache), "steps": [], "fed": []}
    tok = logits.argmax(-1)
    for i in range(job["steps"]):
        if job.get("feed") is not None:
            tok = job["feed"][rows, i]
        out["fed"].append(tok)
        logits, cache = model.decode(params, tok, cache, tp=tp)
        out["steps"].append(logits)
        tok = logits.argmax(-1)
    out["cache_end"] = _copy(cache)
    return out


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def _moe(job, mesh):
    """One MoE FFN on this rank's rows of ``x`` (B, S, d) under a serving
    axis of the whole batch: the routing of its tokens (experts and the
    kept mask, (T, K) in token order), the output and the aux loss of
    both dispatch forms."""
    from repro_torch.models import moe as M
    from repro_torch.sharding.tensor_parallel import serve_axis
    cfg, p, x = job["cfg"], job["p"], job["x"]
    tp = serve_axis(mesh, {}, batch=x.shape[0], cache_len=x.shape[1])
    rows = tp.serving.batch_rows()
    xr = x[rows]
    xg, T, sp = M._group_batch(xr, cfg, tp)
    route = M._experts(xg, p, cfg, tp, sp)[0]
    lo = 0 if sp is None else sp.lo
    own = lambda t: t.reshape(-1, cfg.top_k)[lo:lo + T]
    out = {"rows": (rows.start, rows.stop), "expert_idx": own(route[1]),
           "keep": own(route[3])}
    prev = M.MOE_IMPL
    try:
        for impl in ("gather", "einsum"):
            M.set_moe_impl(impl)
            out[impl] = M.moe_ffn(xr, p, cfg, tp)
    finally:
        M.set_moe_impl(prev)
    return out


def _partials(job, mesh):
    from repro_torch.sharding.longctx import sharded_flash_decode
    from repro_torch.sharding.specs import cache_shardings
    from repro_torch.sharding.tensor_parallel import Serving
    q, k, v, index = job["q"], job["k"], job["v"], job["index"]
    shape = (1,) + tuple(k.shape)
    sv = Serving(mesh, k.shape[0], k.shape[1])
    seq = sv.seq_split("k", shape)
    pl = cache_shardings({"k": torch.empty(shape, device="meta")}, mesh)
    sl = slice(seq.offset, seq.offset + seq.local)
    return {"out": sharded_flash_decode(q, k[:, sl], v[:, sl], index, seq),
            "placement": tuple(pl["k"]), "local": seq.local}


def main(rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import _torch_parity  # noqa: F401  (one torch thread a rank)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh

    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    data, model = inputs["mesh"]
    mesh = make_debug_mesh(data, model, device="cpu")
    res = {"coords": dict(mesh.coords)}
    for job in inputs["jobs"]:
        fn = {"serve": _serve, "moe": _moe}.get(job["kind"], _partials)
        res[job["tag"]] = fn(job, mesh)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
