"""Tensor-parallel client compute over the mesh's model axis
(``repro_torch.sharding.tensor_parallel``) on the CPU with gloo.

Three jobs are spawned, launched as ``torchrun`` launches them (the rank
body is ``tests/_torch_tp_worker.py``, which imports no JAX): a world of
two on a (1, 2) mesh, of three on (1, 3) and of four on (2, 2).

  * The autograd Functions (copy / reduce, gather / split, the constant
    MAX / MIN) in value, ``grad``, ``jvp`` of ``grad`` and ``vmap``
    against the unsharded computation, 1e-6 of max |b| (the same fp32
    products, some sums in another order); the vocab-split
    cross-entropy and its gradients against the whole-vocab one, and the
    argmax's first index across a tie between two processes, exactly.
  * smollm-360m-smoke (3 heads, 1 KV head, d 192: M = 2 splits ``wq``
    mid-head and ``wk``/``wv`` mid-head; M = 3 gives ``wq`` a head each
    and leaves ``wk``, ``wv``, the MLP and the 512-row vocab whole) from
    JAX's parameters through the bridge and ``shard_params``: the loss
    within 1e-6 of JAX's, the gradient within 1e-5, one ``uga_update``
    within 1e-4 of JAX's (the port's own world of one is held there,
    ``tests/test_torch_client.py``) and 1e-5 of the port's unsharded
    update; ``gather_params`` of the shards is the parameters bitwise.
  * Two chained sharded rounds on (1, 2) and (2, 2) (chunks 1 and 2;
    sgd, and adam from a warm state: ROADMAP Queue 3 item 1) against
    JAX's unsharded trainer and the port's world of one: parameters and
    optimizer slots 1e-5, metrics 1e-4 (ROADMAP's tolerances); every
    rank's state bitwise the same.
  * The layer kinds and the modes build a round on the axis; the
    buffered-async runtime refuses it with JAX's ValueError; a (1, 2)
    run's checkpoint restores in a world of one, bitwise.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_worker as W
from _torch_parity import (SMOKE, jax_params_to_torch, max_tree_rel_err,
                           rel_err)
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.core import client as JCL
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.core.client import uga_update
from repro_torch.models.model import build_model

TOL_FN = 1e-6


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_setup():
    jm = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                         loss_chunk=256)
    jp = jm.init(jax.random.PRNGKey(2))
    toks = np.random.default_rng(4).integers(0, 512, (4, 17)).astype(
        np.int32)
    return jm, jp, toks


def _spawn(world, model, tmp, jax_setup):
    _, jp, toks = jax_setup
    torch.save({"p0": jax_params_to_torch(jp),
                "tokens": torch.from_numpy(toks).long()},
               tmp / "inputs.pt")
    torch.multiprocessing.spawn(W.main, args=(world, model, _free_port(),
                                              str(tmp)), nprocs=world)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory, jax_setup):
    tmp = tmp_path_factory.mktemp("tp_1x2")
    return tmp, _spawn(2, 2, tmp, jax_setup)


@pytest.fixture(scope="module")
def mesh_1x3(tmp_path_factory, jax_setup):
    return _spawn(3, 3, tmp_path_factory.mktemp("tp_1x3"), jax_setup)


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory, jax_setup):
    return _spawn(4, 2, tmp_path_factory.mktemp("tp_2x2"), jax_setup)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _part(full, local, coord, n):
    """``local``'s place in ``full``: the dim where their sizes differ
    split evenly."""
    for d, (a, b) in enumerate(zip(full.shape, local.shape)):
        if a != b:
            return full.narrow(d, coord * b, b)
    return full


@pytest.mark.parametrize("form", ["reduce", "gather"])
def test_functions_value_grad_hvp_vmap(mesh_1x2, form):
    _, ranks = mesh_1x2
    for res in ranks:
        tp, ref = res["functions"]["tp"][form], res["functions"]["ref"]
        coord = res["mesh"][1]["model"]
        assert rel_err(tp["value"], ref["value"]) <= TOL_FN
        for key in ("grad", "hvp"):
            for got, want in zip(tp[key], ref[key]):
                assert rel_err(got, _part(want, got, coord, 2)) <= TOL_FN, \
                    (form, key)
        for key in ("vmap", "vmap_hvp"):
            for got, want in zip(tp[key], ref[key]):
                for i in range(want.shape[0]):
                    assert rel_err(got[i], _part(want[i], got[i], coord,
                                                 2)) <= TOL_FN, (form, key)


def test_vocab_xent_and_argmax_across_processes(mesh_1x2):
    _, ranks = mesh_1x2
    x = ranks[0]["functions"]["xent"]
    h, head, labels, mask = x["h"], x["head"], x["labels"], x["mask"]

    def whole(hh, w):
        logits = hh @ w
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
        return torch.sum(nll * mask)
    g_h, g_w = torch.func.grad(whole, argnums=(0, 1))(h, head)
    hit = torch.sum((torch.argmax(h @ head, -1) == labels).float() * mask)
    assert int(torch.argmax((h @ head)[0, 0])) == 3   # the tie, index 3
    for res in ranks:
        r = res["functions"]["xent"]
        coord = res["mesh"][1]["model"]
        assert rel_err(r["nll"], whole(h, head)) <= TOL_FN
        assert float(r["hit"]) == float(hit)
        assert rel_err(r["grad_h"], g_h) <= TOL_FN
        assert rel_err(r["grad_w"], _part(g_w, r["grad_w"], coord, 2)) \
            <= TOL_FN


@pytest.fixture(scope="module")
def jax_model_refs(jax_setup):
    jm, jp, toks = jax_setup
    jb = {"tokens": jnp.asarray(toks)}
    loss, metrics = jm.loss(jp, jb)
    g = jax.grad(lambda w: jm.loss(w, jb)[0])(jp)
    G, l_eval = jax.jit(lambda w: JCL.uga_update(jm.loss, w, jb, 0.05))(jp)
    tm = build_model(get_arch(SMOKE), loss_chunk=256)
    tp = jax_params_to_torch(jp)
    tb = {"tokens": torch.from_numpy(toks).long()}
    G1, _ = uga_update(tm.loss, tp, tb, 0.05)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax_params_to_torch(g), jax_params_to_torch(G), float(l_eval),
            G1)


@pytest.mark.parametrize("m", [2, 3])
def test_smoke_model_matches_jax(request, jax_model_refs, m):
    ranks = request.getfixturevalue(f"mesh_1x{m}")
    ranks = ranks[1] if m == 2 else ranks
    loss, metrics, g, G, l_eval, G1 = jax_model_refs
    shapes = ranks[0]["model"]["shapes"]
    if m == 2:      # wq 192 -> 96 columns, wk/wv 64 -> 32: mid-head
        assert shapes["blocks.0.attn.wq"] == (2, 192, 96)
        assert shapes["blocks.0.attn.wk"] == (2, 192, 32)
        assert shapes["embed"] == (256, 192)
    else:           # wq a head each; wk/wv, the MLP and the vocab whole
        assert shapes["blocks.0.attn.wq"] == (2, 192, 64)
        assert shapes["blocks.0.attn.wk"] == (2, 192, 64)
        assert shapes["blocks.0.mlp.w_gate"] == (2, 192, 512)
        assert shapes["embed"] == (512, 192)
    for res in ranks:
        r = res["model"]
        assert r["gather_bitwise"]
        assert abs(float(r["loss"]) - loss) <= 1e-6 * abs(loss)
        for k, v in metrics.items():
            assert abs(float(r["metrics"][k]) - v) <= 1e-6 * max(abs(v),
                                                                 1.0), k
        assert max_tree_rel_err(r["grad"], g) <= 1e-5
        assert max_tree_rel_err(r["uga"], G) <= 1e-4
        assert max_tree_rel_err(r["uga"], G1) <= 1e-5
        assert abs(float(r["uga_loss"]) - l_eval) <= 1e-5 * abs(l_eval)


@pytest.fixture(scope="module")
def references(jax_setup):
    """{opt: JAX's unsharded trainer history and state} (one JAX compile
    per optimizer) and {(opt, chunk): the port's world of one}."""
    _, jp, _ = jax_setup
    p0 = jax_params_to_torch(jp)
    jax_out, port = {}, {}
    for opt in ("sgd", "adam"):
        kw = {**W.FED, "server_opt": opt}
        jt = JaxTrainer(jax_build_model(jax_get_arch(SMOKE),
                                        dtype=jnp.float32, loss_chunk=256),
                        JaxFedConfig(**kw), seed=0)
        # a copy: the trainer donates its state's buffers
        jt.state["params"] = jax.tree.map(lambda x: jnp.array(x, copy=True),
                                          jp)
        if opt == "adam":
            warm = W.warm_adam(jt.state["opt"]["m"][0].shape[0])
            jt.state["opt"] = {k: (tuple(jnp.asarray(x.numpy()) for x in v)
                                   if k != "t" else jnp.asarray(5, jnp.int32))
                               for k, v in warm.items()}
        hist = jt.run(jax_fed_data(jax_get_arch(SMOKE), **W.DATA),
                      rounds=W.ROUNDS, cohort=W.COHORT, batch=W.BATCH,
                      meta_batch=2 * W.BATCH)
        jax_out[opt] = (hist, jax_params_to_torch(jt.state["params"]),
                        {k: [np.asarray(x) for x in v]
                         for k, v in jt.state["opt"].items() if k != "t"})
    for cases in W.ROUND_CASES.values():
        for opt, chunk in cases:
            if (opt, chunk) not in port:
                port[(opt, chunk)] = W.run_rounds(p0, opt, chunk)
    return jax_out, port


def _hold_state(state, hist, ref_hist, ref_params, ref_opt):
    assert [r["round"] for r in hist] == list(range(W.ROUNDS))
    for tr, jr in zip(hist, ref_hist):
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= 1e-4 * abs(jr[k]), (k, tr, jr)
    assert max_tree_rel_err(state["params"], ref_params) <= 1e-5
    for slot, bufs in ref_opt.items():
        for a, b in zip(state["opt"][slot], bufs):
            assert rel_err(a, b) <= 1e-5, slot


@pytest.mark.parametrize("mesh,opt,chunk", [
    ("1x2", "sgd", 1), ("1x2", "adam", 2), ("2x2", "sgd", 2),
    ("2x2", "adam", 1)])
def test_two_sharded_rounds(request, references, mesh, opt, chunk):
    ranks = request.getfixturevalue(f"mesh_{mesh}")
    ranks = ranks[1] if mesh == "1x2" else ranks
    jax_out, port = references
    state, hist = ranks[0][f"rounds:{opt}:{chunk}"]
    _hold_state(state, hist, *jax_out[opt])
    pstate, phist = port[(opt, chunk)]
    _hold_state(state, hist, phist, pstate["params"],
                {k: v for k, v in pstate["opt"].items() if k != "t"})
    for res in ranks[1:]:
        other, ohist = res[f"rounds:{opt}:{chunk}"]
        assert ohist == hist
        for (n, a), (_, b) in zip(_leaves(other), _leaves(state)):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), n


BUILDS = ("mamba", "moe", "mla", "encoder", "through_aggregation", "codec",
          "legacy_tree")


def test_refusals_name_item_7c(mesh_1x2):
    """Every layer kind builds a round on the axis (mamba, MoE, MLA, the
    encoder and cross layers), and so do the modes (through_aggregation,
    a lossy codec, the legacy_tree engine); the buffered-async runtime
    refuses a mesh with JAX's reason, its replicated delta pool (the
    label is item 7c's, which that refusal once named)."""
    _, ranks = mesh_1x2
    for res in ranks:
        assert set(BUILDS) < set(res["refusals"])
        for name, msg in res["refusals"].items():
            if name in BUILDS:
                assert msg == "accepted", (name, msg)
            else:
                assert "replicated delta pool" in msg, (name, msg)


def test_checkpoint_of_a_model_axis_restores_in_a_world_of_one(mesh_1x2):
    """A (1, 2) run's blob is JAX's of the global state: a trainer with no
    mesh restores it bitwise."""
    from repro_torch.configs import FedConfig
    from repro_torch.core.trainer import FederatedTrainer
    tmp, ranks = mesh_1x2
    state, _ = ranks[0]["rounds:sgd:1"]
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256),
                          FedConfig(**W.FED, server_opt="sgd"),
                          device="cpu", seed=1)
    tt.restore(str(tmp / "ckpt.msgpack"))
    assert tt.round == W.ROUNDS
    for k, v in state["params"].items():
        assert torch.equal(tt.state["params"][k], v), k
