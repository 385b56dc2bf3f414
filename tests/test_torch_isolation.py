"""The PyTorch port stands alone: no JAX, no reference-package imports, no
silent CPU fallback, and loud errors for what is not ported yet."""
import ast
import dataclasses
import pathlib

import pytest
import torch

from repro.configs import FedConfig as JaxFedConfig
from repro.core import rngtags as jax_rngtags
from repro_torch.configs import FedConfig, get_arch
from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.core import rngtags
from repro_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_to_fall_back_to_cpu():
    from repro_torch.launch.train import run_training
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training("smollm-360m-smoke", rounds=1, cohort=2,
                     client_batch=4, seq=8, fused=True)
    assert resolve_device("cpu").type == "cpu"


def test_fedconfig_mirrors_jax_fields_and_defaults():
    ours = [(f.name, f.default) for f in dataclasses.fields(FedConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxFedConfig)]
    assert ours == ref


def test_rng_tags_match_jax():
    assert rngtags.TAGS == jax_rngtags.TAGS


@pytest.mark.parametrize("kw", [
    dict(participation=0.5), dict(fault_profile="flaky"),
    dict(fault_drop=0.1), dict(engine="buffered_async"),
    dict(codec="int8"), dict(meta_mode="through_aggregation"),
    dict(cohort_chunk=2), dict(fused_update=False),
], ids=lambda kw: next(iter(kw)))
def test_unported_features_raise_naming_the_roadmap(kw):
    base = dict(fused_update=True)
    base.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        FedConfig(**base)


def test_bad_values_raise_value_errors():
    with pytest.raises(ValueError, match="algorithm"):
        FedConfig(fused_update=True, algorithm="nope")
    with pytest.raises(ValueError, match="server_opt"):
        FedConfig(fused_update=True, server_opt="lamb")
    with pytest.raises(ValueError, match="cohort_strategy"):
        FedConfig(fused_update=True, cohort_strategy="nope")


def test_build_model_refuses_unported_families():
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("smollm-360m-smoke"), family="moe",
                              moe=MoEConfig(num_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="MoE"):
        build_model(cfg)
    assert isinstance(get_arch("smollm-360m"), ArchConfig)
