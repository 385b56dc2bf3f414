"""Checkpoints, the port against the JAX package: the blob format (the
port's own msgpack writer and reader against ``msgpack``), blobs that
cross-load both ways, bitwise round trips of every server-state form, a
mid-run async save and resume equal to never stopping, the errors, the
managed store, and the launchers' ``--ckpt`` / ``--resume`` / ``--run-dir``
(train) and ``--ckpt`` (serve).

JAX's own ``test_async_save_resume_bit_identical`` fails under this jax on
its precondition (the 'flaky' run's pool is empty after 3 ticks), so the
resume test here uses a config whose pool holds pending deltas at the save
and asserts that first."""
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch
from repro import checkpoint as JC
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import FederatedTrainer as JaxTrainer
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.checkpoint import ckpt as C
from repro_torch.checkpoint import manager as M
from repro_torch.configs import FedConfig
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from test_torch_faults import BASE, COHORT, _arrays, _jax_mlp, _params0
from test_torch_faults import _torch_mlp

# a pool with pending deltas after 3 ticks: half the reports one or two
# ticks late, K = 2 of capacity 8
RESUME = dict(BASE, engine="buffered_async", cohort_strategy="scan",
              async_buffer=2, async_capacity=8, fault_delay=0.5,
              fault_max_delay=2, fault_crash=0.1, fault_garble=0.2)


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------
PAYLOADS = {
    "scalars": [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
                2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33, -128, -129,
                -32768, -32769, -2**31, -2**31 - 1, -2**63, 0.0, -0.0, 1.5,
                float("inf"), 1e-300, 3.141592653589793],
    "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535,
                "f" * 65536, "é✓"],
    "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65535,
             b"\x03" * 65536],
    "containers": [[], list(range(15)), list(range(16)),
                   list(range(65536)), {}, {str(i): i for i in range(15)},
                   {str(i): [i] for i in range(16)},
                   {f"k{i}": None for i in range(65536)},
                   {"leaves": {"a/b": {"dtype": "float32", "shape": [2, 3],
                                       "data": b"\x00" * 24}},
                    "extra": {"history": [{"round": 0, "loss": 1.25,
                                           "hist": [0.0, 2.0]}]}}],
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_packb_bytes_equal_msgpack(name):
    obj = PAYLOADS[name]
    ours = C.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    back = C.unpackb(ours)
    assert C._plain(back) == msgpack.unpackb(ours, raw=False)


@pytest.mark.parametrize("bad", [b"", b"\x92\x01", b"\xc4\x05ab",
                                 b"\x01\x02", b"\xc1", b"\x81\x01\x02"],
                         ids=["empty", "short-array", "short-bin", "extra",
                              "never-used", "int-key"])
def test_unpackb_rejects_what_msgpack_rejects(bad):
    with pytest.raises(ValueError):
        C.unpackb(bad)
    with pytest.raises(Exception):
        msgpack.unpackb(bad, raw=False)


# ---------------------------------------------------------------------------
# blobs across the packages
# ---------------------------------------------------------------------------
def _data():
    return FederatedData(**_arrays())


def _jax_trainer(kw, rounds):
    tr = JaxTrainer(_jax_mlp(), JaxFedConfig(**kw), seed=0)
    tr.state["params"] = _params0()[0]
    tr.run(_jax_data(), rounds=rounds, cohort=COHORT, batch=8, meta_batch=8)
    return tr


def _jax_data():
    from repro.data.pipeline import FederatedData as JaxFederatedData
    return JaxFederatedData(**_arrays())


def _port_like(kw):
    return FederatedTrainer(_torch_mlp(), FedConfig(**kw), seed=0,
                            device="cpu", params=_params0()[1])


def _flat(tree):
    return dict(C.tree_leaves(tree))


def _assert_trees_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        x, y = C._host(fa[k]), C._host(fb[k])     # an int: int32
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


STATE_FORMS = {
    "post-vmap-sgd": dict(BASE),
    "post-scan-adam": dict(BASE, cohort_strategy="scan", server_opt="adam"),
    "ctrl": dict(BASE, meta_mode="through_aggregation"),
    "comm-int8-ef": dict(BASE, codec="int8", error_feedback=True),
    "async": RESUME,
}


@pytest.mark.parametrize("form", list(STATE_FORMS))
def test_jax_blob_restores_into_the_port_and_back(form, tmp_path):
    """JAX's trainer saves after 3 rounds; the port restores it equal to
    the JAX state, bit for bit; the port saves that state, JAX restores it
    equal again, and the two blobs are the same bytes."""
    kw = STATE_FORMS[form]
    jt = _jax_trainer(kw, 3)
    jpath, tpath = str(tmp_path / "jax.msgpack"), str(tmp_path / "t.msgpack")
    jt.save(jpath, extra={"arch": "mlp"})
    tt = _port_like(kw)
    extra = tt.restore(jpath)
    assert extra == {"arch": "mlp"} and tt.round == 3
    assert len(tt.history) == 3 and tt.history == jt.history
    jstate = jax.tree.map(np.asarray, jt.state)
    jtree = {**jstate, "params": bridge.to_torch(jstate["params"])}
    _assert_trees_bitwise(tt.checkpoint_tree(), jtree)
    tt.save(tpath, extra={"arch": "mlp"})
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    back, bextra = JC.restore(tpath, jt.state)
    assert bextra["arch"] == "mlp"
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jt.state)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("form", list(STATE_FORMS))
def test_port_state_round_trips_bitwise(form, tmp_path):
    kw = STATE_FORMS[form]
    tr = _port_like(kw)
    tr.run(_data(), rounds=4, cohort=COHORT, batch=8, meta_batch=8)
    path = str(tmp_path / "state.msgpack")
    tr.save(path)
    fresh = _port_like(kw)
    fresh.restore(path)
    _assert_trees_bitwise(fresh.checkpoint_tree(), tr.checkpoint_tree())
    assert fresh.history == tr.history and fresh.round == 4
    if form == "async":
        # the physical slot order is not state; the restored pool is in
        # logical order
        assert not np.array_equal(tr.state["async"]["slot"], np.arange(8))
        assert np.array_equal(fresh.state["async"]["slot"], np.arange(8))


def test_async_mid_run_save_resume_equals_never_stopping(tmp_path):
    ref = _port_like(RESUME)
    ref.run(_data(), rounds=7, cohort=COHORT, batch=8, meta_batch=8)
    tr = _port_like(RESUME)
    tr.run(_data(), rounds=3, cohort=COHORT, batch=8, meta_batch=8)
    a = tr.state["async"]
    # the precondition JAX's own test asserts: deltas pending in the pool
    assert float(np.sum(a["weight"])) > 0
    assert np.any((a["weight"] > 0) & (a["deliver"] > 2))
    path = str(tmp_path / "async.msgpack")
    tr.save(path)
    tr2 = _port_like(RESUME)
    tr2.restore(path)
    tr2.run(_data(), rounds=7, cohort=COHORT, batch=8, meta_batch=8)
    ref_tree, got = ref.checkpoint_tree(), tr2.checkpoint_tree()
    occ = ref_tree["async"]["weight"] > 0
    for t in (ref_tree, got):     # a free slot's contents are not state
        t["async"]["pool"] = tuple(p[torch.from_numpy(occ)]
                                   for p in t["async"]["pool"])
    _assert_trees_bitwise(got, ref_tree)
    assert tr2.history == ref.history
    assert sum(h["server_steps"] for h in ref.history[3:]) > 0


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------
def test_corrupt_truncated_and_foreign_blobs_raise(tmp_path):
    path = str(tmp_path / "state.msgpack")
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    save(path, tree)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(ValueError) as ei:
        restore(path, tree)
    assert path in str(ei.value) and "truncated" in str(ei.value)
    with open(path, "wb") as f:
        f.write(msgpack.packb({"not": "a checkpoint"}))
    with pytest.raises(ValueError, match="leaves"):
        restore(path, tree)
    save(path, tree)
    with pytest.raises(KeyError, match="'v'"):
        restore(path, {"v": torch.zeros(8)})
    with pytest.raises(ValueError, match=r"shape \(8,\).*\(4,\)"):
        restore(path, {"w": torch.zeros(4)})
    payload = msgpack.unpackb(blob, raw=False)
    payload["leaves"]["w"]["data"] = b"\x00" * 5
    with open(path, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    with pytest.raises(ValueError, match="leaf 'w' is corrupt"):
        restore(path, tree)


def test_failed_save_keeps_the_previous_blob(tmp_path, monkeypatch):
    path = str(tmp_path / "state.msgpack")
    tree0 = {"w": torch.arange(8, dtype=torch.float32)}
    save(path, tree0, extra={"gen": 0})
    real = C._write_payload

    def boom(f, *a):
        real(f, *a)
        raise RuntimeError("disk full (simulated)")

    monkeypatch.setattr(C, "_write_payload", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        save(path, {"w": torch.zeros(8)}, extra={"gen": 1})
    monkeypatch.undo()
    restored, extra = restore(path, tree0)
    assert extra == {"gen": 0} and torch.equal(restored["w"], tree0["w"])
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_a_leaf_past_the_bin32_limit_raises_before_writing(tmp_path):
    """msgpack's bin32 holds 2**32 - 1 bytes; JAX's format shares the
    limit.  The full-width async pool of smollm-360m is 11.58 GB."""
    path = str(tmp_path / "big.msgpack")
    big = torch.empty((8, 2_826_728, 128), device="meta")
    with pytest.raises(ValueError, match=r"'async/pool/0' is "
                       r"11,578,277,888 bytes"):
        save(path, {"async": {"pool": (big,)}, "round": 3})
    assert os.listdir(tmp_path) == []


def test_snapshots_copy_cpu_tensors():
    t = torch.zeros(4)
    snap = M.host_copy({"a": t, "b": (np.zeros(2),), "round": 1})
    t.add_(1.0)
    assert torch.equal(snap["a"], torch.zeros(4)) and snap["round"] == 1


# ---------------------------------------------------------------------------
# the managed store
# ---------------------------------------------------------------------------
def test_manager_retention_latest_and_failures(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpts")
    with CheckpointManager(d, keep_last=2, keep_every=4) as m:
        for step in range(1, 10):
            m.save(step, {"w": torch.full((3,), float(step))},
                   extra={"step": step})
        m.wait()
        assert m.latest() == 9
        assert m.saved_steps() == [4, 8, 9]
        tree, extra, step = m.restore_latest({"w": torch.zeros(3)})
        assert step == 9 and extra == {"step": 9}
        assert torch.equal(tree["w"], torch.full((3,), 9.0))
        with pytest.raises(ValueError, match="not after"):
            m.save(9, {"w": torch.zeros(3)})
    assert sorted(os.listdir(d)) == ["manifest.json", "step_00000004.msgpack",
                                     "step_00000008.msgpack",
                                     "step_00000009.msgpack"]
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    assert manifest["latest"] == 9 and manifest["keep_last"] == 2
    assert CheckpointManager(d).latest() == 9      # a fresh process
    # a failed background write surfaces on the next call; its step is
    # dropped, so it can be saved again
    m = CheckpointManager(d, keep_last=2)

    def boom(*a, **kw):
        raise OSError("disk full (simulated)")

    monkeypatch.setattr(M, "ckpt_save", boom)
    m.save(10, {"w": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="step 10"):
        m.wait()
    assert m.latest() == 9
    monkeypatch.undo()
    m.save(10, {"w": torch.zeros(3)})
    m.close()
    assert m.saved_steps() == [9, 10]
    with pytest.raises(ValueError, match="keep_last"):
        CheckpointManager(d, keep_last=0)


def test_manager_quick_saves_under_thread_switches(tmp_path):
    """Saves queued faster than the writer drains them, with the
    interpreter switching threads often: every blob lands in order, the
    pruner keeps the newest two, and the writer stops on close."""
    import sys
    d = str(tmp_path / "ckpts")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        m = CheckpointManager(d, keep_last=2)
        for step in range(1, 41):
            m.save(step, {"w": torch.full((64,), float(step))},
                   extra={"step": step})
        m.close()
    finally:
        sys.setswitchinterval(old)
    assert m._worker is None and m.saved_steps() == [39, 40]
    assert sorted(os.listdir(d)) == ["manifest.json",
                                     "step_00000039.msgpack",
                                     "step_00000040.msgpack"]
    tree, extra = restore(m.path(40), {"w": torch.zeros(64)})
    assert extra == {"step": 40} and float(tree["w"][0]) == 40.0


def test_trainer_managed_store_and_resume_latest(tmp_path):
    kw = RESUME
    run_dir = str(tmp_path / "run")
    tr = FederatedTrainer(_torch_mlp(), FedConfig(**kw), seed=0,
                          device="cpu", params=_params0()[1],
                          run_dir=run_dir, checkpoint_every=2, keep_last=2)
    tr.run(_data(), rounds=5, cohort=COHORT, batch=8, meta_batch=8)
    tr.finish()
    assert tr.manager.saved_steps() == [4, 5]
    tr2 = FederatedTrainer(_torch_mlp(), FedConfig(**kw), seed=0,
                           device="cpu", params=_params0()[1],
                           run_dir=run_dir, checkpoint_every=2)
    assert tr2.resume_latest() == 5 and tr2.round == 5
    assert tr2.history == tr.history
    with pytest.raises(ValueError, match="run_dir"):
        FederatedTrainer(_torch_mlp(), FedConfig(**kw), device="cpu",
                         params=_params0()[1], checkpoint_every=2)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
TRAIN = ["--arch", SMOKE, "--fused", "--cohort", "2", "--client-batch", "2",
         "--seq", "16", "--num-clients", "4", "--examples", "32",
         "--device", "cpu", "--log-every", "0"]


def test_train_cli_ckpt_resume_and_run_dir(tmp_path, capsys):
    """``--ckpt`` then ``--resume PATH`` continues where the first run
    stopped, as one uninterrupted async run; ``--run-dir`` keeps the
    managed store and ``--resume auto`` resumes its newest blob."""
    async_kw = ["--engine", "buffered_async", "--async-buffer", "1",
                "--async-capacity", "3", "--staleness-mode", "inv"]
    ckpt, hist = str(tmp_path / "c.msgpack"), str(tmp_path / "h.json")
    ttrain.main(TRAIN + async_kw + ["--rounds", "3",
                                    "--history-out", hist])
    whole = json.load(open(hist))
    ttrain.main(TRAIN + async_kw + ["--rounds", "2", "--ckpt", ckpt])
    ttrain.main(TRAIN + async_kw + ["--rounds", "3", "--resume", ckpt,
                                    "--history-out", hist])
    assert json.load(open(hist)) == whole[2:]
    out = capsys.readouterr().out
    assert "saved server state" in out and "resumed" in out
    run_dir = str(tmp_path / "run")
    ttrain.main(TRAIN + ["--rounds", "2", "--run-dir", run_dir,
                         "--ckpt-every", "1", "--keep-last", "1"])
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == [
        "manifest.json", "step_00000002.msgpack"]
    ttrain.main(TRAIN + ["--rounds", "3", "--run-dir", run_dir,
                         "--resume", "auto", "--history-out", hist])
    assert "resume auto: round 2" in capsys.readouterr().out
    assert len(json.load(open(hist))) == 1
    with pytest.raises(ValueError, match="--run-dir"):
        ttrain.main(TRAIN + ["--rounds", "1", "--resume", "auto"])
    # --engine legacy_tree overrides --fused and runs, as in the JAX
    # launcher; its blob holds the tree engine's server state
    ttrain.main(TRAIN + ["--rounds", "1", "--engine", "legacy_tree",
                         "--server-opt", "sgdm", "--ckpt", ckpt,
                         "--history-out", hist])
    (rec,) = json.load(open(hist))
    assert rec["round"] == 0 and np.isfinite(rec["grad_norm"])
    with open(ckpt, "rb") as f:
        paths = list(msgpack.unpackb(f.read())["leaves"])
    assert any(k.startswith("opt/m/blocks/") for k in paths)
    assert not any(k.startswith(("opt/v", "opt/t")) for k in paths)


def test_serve_ckpt_restores_bare_params(tmp_path, capsys):
    """A bare-params blob, written by the JAX package or the port, serves
    the tokens the same params give directly."""
    cfg = jax_get_arch(SMOKE)
    jparams = jax_build_model(cfg, dtype=jnp.float32).init(
        jax.random.PRNGKey(5))
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    JC.save(jpath, jparams, extra={"note": "bare"})
    argv = ["--arch", SMOKE, "--batch", "2", "--prompt-len", "8", "--gen",
            "4", "--device", "cpu"]
    toks, _ = tserve.main(argv + ["--ckpt", jpath])
    assert "restored" in capsys.readouterr().out
    params = jax_params_to_torch(jparams)
    save(tpath, params)
    toks2, _ = tserve.main(argv + ["--ckpt", tpath])
    from repro_torch.configs import get_arch
    from repro_torch.models.model import build_model
    model = build_model(get_arch(SMOKE), dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    ref, _ = tserve.generate(model, params, prompts, gen_len=4,
                             cache_len=13)
    assert torch.equal(toks, ref) and torch.equal(toks2, ref)
    restored, _ = restore(tpath, params)
    assert all(torch.equal(restored[k], params[k]) for k in params)
    with pytest.raises(KeyError, match="bare params"):
        tserve.main(argv + ["--ckpt", str(_full_state_blob(tmp_path))])


def _full_state_blob(tmp_path):
    path = tmp_path / "full.msgpack"
    tr = _port_like(BASE)
    tr.save(str(path))
    return path


def test_run_training_takes_the_jax_launchers_knobs():
    """The launcher's run_training takes every async and checkpoint knob
    the JAX launcher does."""
    import inspect
    from repro.launch import train as jtrain
    ours = set(inspect.signature(ttrain.run_training).parameters)
    for name in ("engine", "async_buffer", "async_capacity",
                 "async_max_staleness", "staleness_mode", "ckpt_path",
                 "resume", "run_dir", "ckpt_every", "keep_last",
                 "keep_every"):
        assert name in ours
        assert name in inspect.signature(jtrain.run_training).parameters
