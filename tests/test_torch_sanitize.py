"""The round sanitizer in the port (``repro_torch.core.sanitize``),
mirroring ``tests/test_sanitize.py``.

A clean sanitized run is bitwise the unsanitized one (the probes only
read), sync and async, at K = 1 and K = 2; an injected NaN payload — a
garbled async uplink whose multiplier range is infinite — is caught the
round it happens, with an error naming the flat group, as JAX's
checkified round names it; unsanitized, the same run completes with
non-finite parameters.  The MLP of ``test_torch_faults.py``, parameters
from the JAX init."""
import numpy as np
import pytest
import torch
from jax.experimental.checkify import JaxRuntimeError

from repro.configs import FedConfig as JaxFedConfig
from repro.core import FederatedTrainer as JaxTrainer
from repro.data.pipeline import FederatedData as JaxFederatedData
from repro_torch.configs import FedConfig
from repro_torch.core.flat import flatten_tree, make_flat_spec
from repro_torch.core.sanitize import (SanitizeError, check_flat_groups,
                                       probe_log, sanitize_round)
from repro_torch.core.trainer import FederatedTrainer
from repro_torch.data.pipeline import FederatedData
from test_torch_faults import COHORT, _arrays, _jax_mlp, _params0, _torch_mlp

SYNC = dict(cohort=COHORT, fused_update=True, cohort_strategy="scan",
            meta=False)
ASYNC = dict(SYNC, engine="buffered_async", async_capacity=2 * COHORT)
GARBLE = dict(ASYNC, fault_garble=1.0, fault_garble_scale=float("inf"))


def _run(kw, *, k=1, sanitize=False, rounds=2):
    tr = FederatedTrainer(_torch_mlp(), FedConfig(**kw), rounds_per_call=k,
                          seed=0, device="cpu", params=_params0()[1],
                          sanitize=sanitize)
    hist = tr.run(FederatedData(**_arrays()), rounds=rounds, cohort=COHORT,
                  batch=8)
    return tr, hist


def _finite(params) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in params.values())


# ---------------------------------------------------------------------------
# clean runs: the sanitizer is additive
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kw", [SYNC, ASYNC], ids=["sync", "async"])
def test_sanitized_clean_run_bitwise(kw, k):
    (a, ha), (b, hb) = _run(kw, k=k), _run(kw, k=k, sanitize=True)
    assert len(hb) == 2 and ha == hb
    assert _finite(b.state["params"])
    assert all(torch.equal(a.state["params"][n], b.state["params"][n])
               for n in a.state["params"])


# ---------------------------------------------------------------------------
# the injected NaN payload is caught, with the flat group named
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2])
def test_nan_garble_payload_caught_as_in_jax(k):
    with pytest.raises(SanitizeError, match="flat group 0") as port:
        _run(GARBLE, k=k, sanitize=True)
    msg = str(port.value)
    assert "decoded client deltas before pool insert (async tick)" in msg
    assert "round 0" in msg
    assert "repro_torch.core.flat.unflatten_tree" in msg
    jt = JaxTrainer(_jax_mlp(), JaxFedConfig(**GARBLE), rounds_per_call=k,
                    seed=0, sanitize=True)
    with pytest.raises(JaxRuntimeError, match="flat group 0") as ref:
        jt.run(JaxFederatedData(**_arrays()), rounds=2, cohort=COHORT,
               batch=8)
    # the same site and group; the port adds the round
    assert msg.split(" at ")[0].split(" in ")[1] == \
        str(ref.value).split(" at ")[0].split(" in ")[1]


def test_nan_garble_unsanitized_is_silent():
    tr, hist = _run(GARBLE)
    assert len(hist) == 2
    assert not _finite(tr.state["params"])


# ---------------------------------------------------------------------------
# the probe: its message, and one read a call
# ---------------------------------------------------------------------------
def test_check_flat_groups_message_names_group_and_site():
    params = _params0()[1]
    spec = make_flat_spec(params)
    bufs = flatten_tree(spec, params)
    check_flat_groups(spec, bufs, "unit-test probe")     # clean: no error
    poisoned = [b.clone() for b in bufs]
    poisoned[0][0, 0] = float("nan")
    poisoned[0][1, 3] = float("inf")
    with pytest.raises(SanitizeError) as e:
        check_flat_groups(spec, poisoned, "unit-test probe", round_idx=7)
    msg = str(e.value)
    assert msg.startswith("sanitize: 2 non-finite element(s) in flat "
                          "group 0 (dtype float32, ")
    assert "x128 fp32 buffer) at unit-test probe, round 7;" in msg
    assert "unflatten_tree" in msg
    # a group given as a sequence of buffers sums their counts
    with pytest.raises(SanitizeError, match="sanitize: 4 non-finite"):
        check_flat_groups(spec, [[poisoned[0], poisoned[0]]], "slots")


def test_probes_are_read_after_the_call():
    """Inside a probed call the counts stay on the device; the first
    non-finite probe raises when the call returns, and an outer
    ``probe_log`` (the trainer's, around dispatch and device sync)
    defers it to its own exit."""
    params = _params0()[1]
    spec = make_flat_spec(params)
    bad = [b.clone() for b in flatten_tree(spec, params)]
    bad[0][0, 0] = float("nan")
    after = []

    def call():
        check_flat_groups(spec, flatten_tree(spec, params), "clean",
                          round_idx=0)
        check_flat_groups(spec, bad, "first bad", round_idx=1)
        check_flat_groups(spec, bad, "second bad", round_idx=2)
        after.append(True)
        return "out"

    with pytest.raises(SanitizeError, match="first bad, round 1"):
        sanitize_round(call)()
    assert after == [True]
    with pytest.raises(SanitizeError, match="first bad, round 1"):
        with probe_log():
            assert sanitize_round(call)() == "out"
            after.append("still inside")
    assert after == [True, True, "still inside"]
    assert sanitize_round(lambda: 3)() == 3


def test_probe_error_wins_over_a_downstream_failure():
    """A probe that saw a NaN names it even when the call then failed on
    it further down (anomaly mode raising in a later backward)."""
    params = _params0()[1]
    spec = make_flat_spec(params)
    bad = [b.clone() for b in flatten_tree(spec, params)]
    bad[0][0, 0] = float("nan")

    def call():
        check_flat_groups(spec, bad, "uplink", round_idx=0)
        raise RuntimeError("Function 'X' returned nan values")

    with pytest.raises(SanitizeError, match="uplink") as e:
        sanitize_round(call)()
    assert isinstance(e.value.__cause__, RuntimeError)
    with pytest.raises(RuntimeError, match="returned nan"):
        sanitize_round(lambda: (_ for _ in ()).throw(
            RuntimeError("returned nan")))()


# ---------------------------------------------------------------------------
# --sanitize through the CLI (probes + anomaly mode)
# ---------------------------------------------------------------------------
SMOKE = ["--arch", "smollm-360m-smoke", "--rounds", "2", "--cohort", "2",
         "--client-batch", "4", "--seq", "16", "--device", "cpu", "--fused",
         "--log-every", "0"]


def test_sanitize_through_the_cli(tmp_path, capsys):
    import json

    from repro_torch.launch.train import main
    clean, san = tmp_path / "clean.json", tmp_path / "san.json"
    main(SMOKE + ["--history-out", str(clean)])
    main(SMOKE + ["--sanitize", "--history-out", str(san)])
    assert json.loads(clean.read_text()) == json.loads(san.read_text())
    with pytest.raises(SanitizeError, match="flat group 0") as e:
        main(SMOKE + ["--sanitize", "--engine", "buffered_async",
                      "--fault-garble", "1.0", "--fault-garble-scale",
                      "inf"])
    # anomaly mode failed downstream on the NaN the probe had seen
    assert e.value.__cause__ is None or "nan" in str(e.value.__cause__)


def test_anomaly_mode_raises_inside_the_client_update():
    """Why ``--sanitize`` turns anomaly mode on: a NaN in one client's
    data raises inside the ``torch.func`` client update, naming the
    backward function that produced it."""
    arrays = _arrays()
    arrays["arrays"]["x"][:, 3] = np.nan
    for strategy in ("vmap", "scan"):
        fed = FedConfig(**dict(SYNC, cohort_strategy=strategy))
        tr = FederatedTrainer(_torch_mlp(), fed, seed=0, device="cpu",
                              params=_params0()[1])
        with pytest.raises(RuntimeError, match="returned nan values"):
            with torch.autograd.detect_anomaly(check_nan=True):
                tr.run(FederatedData(**arrays), rounds=1, cohort=COHORT,
                       batch=8)
