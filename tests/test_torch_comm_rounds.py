"""The compressed uplink end to end: 3 rounds of the JAX ``FederatedTrainer``
against the port's trainer with a lossy codec — same data seed, same
bridged init, fused engine, UGA + FedMeta (``meta_mode='post'``) — at
smoke size.  The int8 cases are here, the sign1bit and topk cases in
``test_torch_comm_rounds_sign_topk.py`` (each JAX trainer compiles for
its own config, so the cases are spread over two files for a parallel
run); the guards and the CLI are ``test_torch_comm_round.py``.

Tolerances: history metrics <= 1e-4 relative (the JAX suite's across
engines) and ``comm_bytes`` exactly.  Parameters and error-feedback
residuals are held by a flip-aware criterion.  The codecs are
discontinuous: a one-ulp difference between the two packages' client
gradients moves an int8 code by one step, or flips a sign, at the few
elements that sit on a rounding boundary, and that moves the aggregate
there by ``scale * w_k`` (about amax / 127) or ``2 mu w_k``.  So:

  * every element off by more than 1e-5 (of max |b| per parameter leaf;
    of the encoded input's size for the residuals, see below) is counted,
    and the count must stay under FLIP_FRACTION (1e-3) of the elements;
  * each counted element's difference must be at most what a few flips
    amount to there (parameters: FLIP_CAP of the leaf's largest entry;
    residuals: one codec step per round);
  * every other element is held to the usual 1e-5.

The counts seen are printed (``-s``) and stated in ``PERF.md``.  Adam runs
from a warm state (t = 5, random m, v > 0), as the port's other adam
parity tests do (ROADMAP Queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import SMOKE, jax_params_to_torch
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.model import build_model
from test_torch_comm_round import COHORT, DATA_KW, ROUNDS, RUN_KW, _fed_kw

TOL, TOL_METRIC = 1e-5, 1e-4
FLIP_FRACTION = 1e-3
FLIP_CAP = 1e-3


def flip_aware(port, ref, *, ref_scale, cap, what):
    """Hold ``port`` to ``ref`` element by element: those off by more than
    TOL * ``ref_scale`` are counted; there may be at most FLIP_FRACTION of
    the elements, each off by at most ``cap``.  Returns the count."""
    a = np.asarray(port, np.float64).reshape(-1)
    b = np.asarray(ref, np.float64).reshape(-1)
    diff = np.abs(a - b)
    off = diff > TOL * ref_scale
    n_off = int(off.sum())
    assert n_off <= FLIP_FRACTION * a.size, (what, n_off, a.size)
    if n_off:
        assert diff[off].max() <= cap, (what, diff[off].max(), cap)
    return n_off


def _warm(rows, seed):
    rng = np.random.default_rng(seed)
    m = (0.01 * rng.standard_normal((rows, 128))).astype(np.float32)
    v = (1e-3 * rng.random((rows, 128)) + 1e-4).astype(np.float32)
    res = (1e-3 * rng.standard_normal((COHORT, rows, 128))).astype(
        np.float32)
    return {"m": (m,), "v": (v,), "t": np.int32(5)}, {"residual": (res,)}


CASES = {
    "int8-vmap-sgd": ("vmap", "sgd", "int8", False),
    "int8ef-scan-adam-warm": ("scan", "adam", "int8", True),
    "sign1bitef-vmap-sgd": ("vmap", "sgd", "sign1bit", True),
    "topk-scan-sgd": ("scan", "sgd", "topk", False),
}


def three_rounds_match_jax_trainer(case):
    """Run ``case`` of :data:`CASES` 3 rounds in both trainers and hold
    the port to JAX (see the module docstring)."""
    strategy, opt, codec, ef = CASES[case]
    kw = _fed_kw(strategy, opt, codec, ef, topk_ratio=0.05)
    jt = JaxTrainer(jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32,
                                    loss_chunk=256), JaxFedConfig(**kw),
                    seed=0)
    tt = FederatedTrainer(build_model(get_arch(SMOKE), loss_chunk=256),
                          FedConfig(**kw), device="cpu",
                          params=jax_params_to_torch(jt.state["params"]))
    assert ("comm" in tt.state) == ("comm" in jt.state) == ef
    if opt == "adam":
        opt_np, comm_np = _warm(jt.state["opt"]["m"][0].shape[0], 5)
        jt.state["opt"] = jax.tree.map(jnp.asarray, opt_np)
        jt.state["comm"] = jax.tree.map(jnp.asarray, comm_np)
        tt.state.update(bridge.server_state_to_torch(opt_np, comm=comm_np))
    jh = jt.run(jax_fed_data(jax_get_arch(SMOKE), **DATA_KW), **RUN_KW)
    th = tt.run(build_synthetic_fed_data(get_arch(SMOKE), **DATA_KW),
                **RUN_KW)

    assert [r["round"] for r in th] == list(range(ROUNDS))
    for jr, tr in zip(jh, th):
        assert set(tr) == set(jr) == {"round", "client_loss", "grad_norm",
                                      "meta_loss", "comm_bytes"}
        assert tr["comm_bytes"] == jr["comm_bytes"]
        for k in ("client_loss", "grad_norm", "meta_loss"):
            assert abs(tr[k] - jr[k]) <= TOL_METRIC * abs(jr[k]), (tr, jr)

    # parameters: a flip moves G by scale * w_k (int8) or 2 mu w_k
    # (sign1bit) at one element, and the server step moves that parameter
    # by lr times it (adam: by its step's response to it), about 1e-4 of
    # the leaf's largest entry here; FLIP_CAP allows several flips
    tp = tt.state["params"]
    jp = jax_params_to_torch(jt.state["params"])
    n_p = 0
    for k in jp:
        scale = float(np.max(np.abs(jp[k].numpy())))
        n_p += flip_aware(tp[k], jp[k], ref_scale=scale,
                          cap=FLIP_CAP * scale, what=k)
    n_r = 0
    if ef:
        # residuals: e - decode(encode(e)) is a cancellation, so it is held
        # against the size of e (int8: |r| <= scale / 2 = amax(e) / 254),
        # and a flip moves it by one step (int8: scale, at most 2 max |r|;
        # sign1bit: 2 mu), at most once a round
        res_t = tt.state["comm"]["residual"][0]
        res_j = np.asarray(jt.state["comm"]["residual"][0])
        r_max = float(np.max(np.abs(res_j)))
        n_r = flip_aware(
            res_t, res_j, ref_scale=r_max * (254 if codec == "int8" else 1),
            cap=ROUNDS * 2 * r_max * (1 + TOL), what="residual")
    print(f"{case}: parameter elements off by more than 1e-5: {n_p} of "
          f"{sum(v.numel() for v in tp.values())}; residual elements: {n_r}")


@pytest.mark.parametrize("case", ["int8-vmap-sgd", "int8ef-scan-adam-warm"])
def test_three_rounds_match_jax_trainer(case):
    three_rounds_match_jax_trainer(case)
