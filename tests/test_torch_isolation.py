"""The PyTorch port stands alone: no JAX, no reference-package imports, no
``msgpack`` (the card's machine has none; the checkpoint blobs are written
by the port's own packer), no silent CPU fallback, and loud errors for
what is not ported yet (the other synchronous arms)."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import rngtags as jax_rngtags
from repro_torch.configs import FedConfig, get_arch
from repro_torch.configs.base import ArchConfig, EncoderConfig, MoEConfig
from repro_torch.core import rngtags
from repro_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_to_fall_back_to_cpu():
    from repro_torch.launch import serve
    from repro_torch.launch.train import run_training
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training("smollm-360m-smoke", rounds=1, cohort=2,
                     client_batch=4, seq=8, fused=True)
    for arch in ("smollm-360m-smoke", "mamba2-780m-smoke"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--batch", "1", "--prompt-len", "4",
                        "--gen", "2"])
    assert resolve_device("cpu").type == "cpu"


def test_fedconfig_mirrors_jax_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(FedConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxFedConfig)]
    assert ours == ref


def test_rng_tags_match_jax():
    assert rngtags.TAGS == jax_rngtags.TAGS


@pytest.mark.parametrize("kw", [
    pytest.param(dict(engine="legacy_tree"), id="legacy_tree"),
    dict(fused_update=False),
], ids=lambda kw: next(iter(kw)))
def test_unported_features_raise_naming_the_roadmap(kw):
    base = dict(fused_update=True)
    base.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        FedConfig(**base)


@pytest.mark.parametrize("kw", [
    dict(cohort_chunk=2), dict(cohort_strategy="chunked", cohort_chunk=2),
], ids=lambda kw: next(iter(kw)))
def test_chunked_features_are_accepted(kw):
    """The chunked executor is ported: ``cohort_chunk`` builds a config
    equal to the JAX package's, and its round."""
    from repro_torch.core.round import make_federated_round
    from repro_torch.models.model import build_model
    cfg = FedConfig(fused_update=True, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxFedConfig(fused_update=True, **kw))
    make_federated_round(build_model(get_arch("smollm-360m-smoke")), cfg)


@pytest.mark.parametrize("kw", [
    dict(engine="buffered_async"), dict(async_buffer=2),
    dict(async_capacity=8), dict(async_max_staleness=3),
], ids=lambda kw: next(iter(kw)))
def test_async_features_are_accepted(kw):
    """The buffered-async runtime is ported: its knobs build a config, as
    the JAX package's do, and the async engine's round is the tick."""
    from repro_torch.core.round import make_federated_round
    from repro_torch.models.model import build_model
    cfg = FedConfig(fused_update=True, **kw)
    assert cfg == dataclasses.replace(FedConfig(fused_update=True), **kw)
    JaxFedConfig(fused_update=True, **kw)
    fn = make_federated_round(build_model(get_arch("smollm-360m-smoke")),
                              cfg)
    assert (fn.__name__ == "one_tick") == (kw.get("engine")
                                           == "buffered_async")


@pytest.mark.parametrize("kw", [
    dict(participation=0.5), dict(fault_profile="flaky"),
    dict(fault_drop=0.1), dict(round_deadline=2.0),
    dict(retry_backoff=1, fault_crash=0.2),
], ids=lambda kw: next(iter(kw)))
def test_fault_features_are_accepted(kw):
    """Participation and the synchronous fault model are ported: the
    config builds, as the JAX package's does, and so does its round."""
    from repro_torch.core.round import make_federated_round
    from repro_torch.models.model import build_model
    cfg = FedConfig(fused_update=True, **kw)
    assert cfg == dataclasses.replace(FedConfig(fused_update=True), **kw)
    JaxFedConfig(fused_update=True, **kw)
    make_federated_round(build_model(get_arch("smollm-360m-smoke")), cfg)


def test_async_half_raises_naming_its_item():
    """The async half (ROADMAP Queue 1 item 3) is ported: the engine
    builds, and what stays refused names the engine to use instead — an
    explicit garble on a synchronous engine, the async executor as a
    synchronous one."""
    from repro_torch.core.executors import get_executor
    cfg = FedConfig(fused_update=True, engine="buffered_async")
    with pytest.raises(NotImplementedError, match="engine='buffered_async'"):
        get_executor("buffered_async")(cfg).run()
    with pytest.raises(ValueError, match="engine='buffered_async'"):
        from repro_torch.core.round import make_federated_round
        from repro_torch.models.model import build_model
        make_federated_round(build_model(get_arch("smollm-360m-smoke")),
                             FedConfig(fused_update=True, fault_garble=0.1))


def test_sim_package_mirrors_jax():
    """The new ``repro_torch.sim`` package is covered by the import check
    above and exports the JAX package's names and profiles."""
    import repro.sim as jsim
    import repro_torch.sim as tsim
    assert {p.name for p in PORT_FILES if p.parent.name == "sim"} == {
        "__init__.py", "faults.py"}
    assert tsim.__all__ == jsim.__all__
    assert tsim.FAULT_PROFILES == jsim.FAULT_PROFILES
    assert ([f.name for f in dataclasses.fields(tsim.FaultConfig)]
            == [f.name for f in dataclasses.fields(jsim.FaultConfig)])
    assert tsim.FaultStreams._fields == jsim.FaultStreams._fields


def test_bad_values_raise_value_errors():
    with pytest.raises(ValueError, match="algorithm"):
        FedConfig(fused_update=True, algorithm="nope")
    with pytest.raises(ValueError, match="server_opt"):
        FedConfig(fused_update=True, server_opt="lamb")
    with pytest.raises(ValueError, match="cohort_strategy"):
        FedConfig(fused_update=True, cohort_strategy="nope")


def test_build_model_refuses_unported_families():
    """Every family of the JAX transformer builds now: MoE FFNs on an
    attention stack (deepseek, llama4), the jamba hybrid's attention/mamba
    period with MoE and an encoder (ROADMAP Queue 1 items 6e, 6f, done),
    and trains, through mamba layers too (item 10, done), and serves from
    a checkpoint (item 4, done): a missing ``--ckpt`` is the file's
    error, not a refusal."""
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    moe = MoEConfig(num_experts=4, top_k=2, every=2)
    cfg = dataclasses.replace(get_arch("mamba2-780m-smoke"), family="hybrid",
                              attn_period=2, num_heads=4, num_kv_heads=4,
                              d_ff=64, moe=moe)
    hybrid = build_model(cfg)
    hp = hybrid.init(torch.Generator().manual_seed(0))
    loss, _ = hybrid.loss(hp, {"tokens": torch.zeros((1, 5),
                                                     dtype=torch.long)})
    assert torch.isfinite(loss)
    enc = dataclasses.replace(get_arch("smollm-360m-smoke"),
                              encoder=EncoderConfig(1, 8, 32, enc_heads=2))
    model = build_model(enc)
    params = model.init(torch.Generator().manual_seed(0))
    assert params["encoder.proj"].shape == (32, enc.d_model)
    loss, _ = model.loss(params, {"tokens": torch.zeros((1, 5), dtype=torch
                                                        .long),
                                  "enc_embeds": torch.zeros((1, 8, 32))})
    assert torch.isfinite(loss)
    build_model(dataclasses.replace(get_arch("smollm-360m-smoke"),
                                    family="moe", moe=moe))
    assert isinstance(get_arch("smollm-360m"), ArchConfig)
    with pytest.raises(FileNotFoundError):
        serve.main(["--arch", "whisper-large-v3-smoke", "--ckpt",
                    "no-such-blob.msgpack", "--device", "cpu"])


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", JAX_ARCHS)
def test_every_jax_architecture_builds(name, smoke):
    """The port registers each of the JAX package's architectures, full and
    smoke, and builds its module (on the meta device: full width costs
    nothing here) with the JAX config's values."""
    from repro_torch.models.model import build_model
    cfg = get_arch(f"{name}-smoke" if smoke else name)
    jcfg = jax_get_arch(f"{name}-smoke" if smoke else name)
    assert cfg.name == jcfg.name and cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.param_count() == jcfg.param_count()
    model = build_model(cfg)
    assert model.name == cfg.name and model.prefill is not None
