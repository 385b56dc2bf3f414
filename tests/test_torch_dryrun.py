"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads:
``SHAPES``, ``SKIPS``, ``matrix()`` and ``get_shape`` equal to the JAX
package's, ``models/moe.py``'s ``set_moe_impl`` selector against JAX's,
``run_one`` on each kind of shape at smoke width, the CLI at full width
(smollm-360m x decode_32k: fake tensors, nothing allocated), a ``2x1``
mesh under torch's fake process group, and the refusal of a model axis.

The MoE parity tolerance is ``test_torch_moe.py``'s: 1e-6 of max |b|
(the same fp32 products summed in another order)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from _torch_parity import rel_err
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import SKIPS as JAX_SKIPS
from repro.configs import get_shape as jax_get_shape
from repro.configs import matrix as jax_matrix
from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.models import moe as JM
from repro_torch.configs import SHAPES, SKIPS, get_shape, matrix
from repro_torch.configs.base import MoEConfig
from repro_torch.launch.dryrun import run_one
from repro_torch.models import moe as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD_KEYS = {"arch", "shape", "mesh", "chips", "algorithm", "memory",
               "cost", "collectives", "roofline_raw", "roofline",
               "hlo_cost", "trace_s", "launches", "fits"}


def test_shapes_skips_and_matrix_equal_jaxs():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    assert SKIPS == JAX_SKIPS
    assert sorted(matrix()) == sorted(jax_matrix())
    assert len(matrix()) == len(set(matrix())) == 39
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name)) == \
            dataclasses.asdict(jax_get_shape(name))


@pytest.mark.parametrize("impl", ["gather", "einsum"])
def test_moe_impl_selector_matches_jax(impl):
    kw = dict(num_experts=8, top_k=2, num_shared=1, group_size=16)
    jcfg, tcfg = JaxMoEConfig(**kw), MoEConfig(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(1), 32, jcfg, 16)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(1).standard_normal((2, 24, 32),
                                                 dtype=np.float32)
    assert TM.MOE_IMPL == "gather"            # the port's default
    jprev = JM.MOE_IMPL
    try:
        JM.set_moe_impl(impl)
        TM.set_moe_impl(impl)
        jy, jaux = JM.moe_ffn(jnp.asarray(x), jp, jcfg)
        ty, taux = TM.moe_ffn(torch.from_numpy(x), tp, tcfg)
    finally:
        JM.set_moe_impl(jprev)
        TM.set_moe_impl("gather")
    assert rel_err(ty, np.asarray(jy)) <= 1e-6
    assert rel_err(taux, np.asarray(jaux)) <= 1e-6
    with pytest.raises(ValueError, match="moe impl"):
        TM.set_moe_impl("dense")


# a train pair at bf16 runs each server pass once for each of its two flat
# dtype groups (the bf16 leaves, the fp32 norms and router)
@pytest.mark.parametrize("arch,shape,want", [
    ("smollm-360m-smoke", "train_4k", {"aggregate_pass": 2,
                                       "update_pass": 2}),
    ("smollm-360m-smoke", "prefill_32k", {"flash_attention_fwd": 2}),
    ("mamba2-780m-smoke", "prefill_32k", {"ssd_scan_fwd": 2}),
    # MoE routing in a traced round: no host read (moe.py::_one_hot)
    ("llama4-scout-17b-a16e-smoke", "train_4k", {"aggregate_pass": 2,
                                                 "update_pass": 2}),
    ("smollm-360m-smoke", "decode_32k", {}),
    ("deepseek-v2-lite-16b-smoke", "decode_32k", {}),
])
def test_run_one_on_each_kind_of_shape(arch, shape, want):
    rec = run_one(arch, shape, verbose=False)
    assert RECORD_KEYS <= set(rec)
    assert rec["launches"] == want
    assert rec["roofline"] == rec["roofline_raw"]
    assert rec["cost"]["flops"] > 0 and rec["memory"][
        "argument_size_in_bytes"] > 0
    assert ("cohort" in rec) == (shape == "train_4k")
    assert ("decode_window" in rec) == (shape == "decode_32k")
    assert TM.MOE_IMPL == "gather"            # restored after the run


def test_run_one_names_a_form_the_kernel_refuses():
    # deepseek's smoke MLA prefill is flash form (96, 64), not built
    with pytest.raises(NotImplementedError, match="head dims"):
        run_one("deepseek-v2-lite-16b-smoke", "prefill_32k", verbose=False)


def _cli(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(tmp_path), *args], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        timeout=300)


def test_cli_full_width_decode_record(tmp_path):
    p = _cli(tmp_path, "--arch", "smollm-360m", "--shape", "decode_32k")
    assert p.returncode == 0, p.stdout + p.stderr
    with open(tmp_path / "smollm-360m__decode_32k__1x1.json") as f:
        rec = json.load(f)
    assert RECORD_KEYS | {"decode_window"} <= set(rec)
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    # the 32k cache of 128 sequences: 32 layers x 2 x (128, 32768, 5, 64)
    # at bf16, the config's dtype
    cache = 32 * 2 * 128 * 32768 * 5 * 64 * 2
    assert rec["dtype"] == "bfloat16"
    assert rec["memory"]["argument_size_in_bytes"] > cache
    assert rec["fits"] is False and rec["chips"] == 1


def test_two_card_mesh_counts_collectives():
    rec = run_one("smollm-360m-smoke", "train_4k", mesh="2x1",
                  verbose=False)
    assert rec["chips"] == 2 and rec["cohort"] == 2
    assert rec["hlo_cost"]["collective_bytes"] > 0
    assert rec["collectives"]["_counts"]["allreduce_"] >= 1
    # each pass once for each of the two flat dtype groups at bf16
    assert rec["launches"] == {"accumulate_pass": 2, "update_pass": 2}
    assert not torch.distributed.is_initialized()


def test_model_axis_raises_naming_item_7b(tmp_path):
    """The dry run of a model axis traces rank 0 of the mesh (the round's
    client update on its shards, the model axis's collectives counted);
    JAX's activation-sharding hint is on by default (the residual stream
    split over model by batch rows); what still refuses there, the
    experts over another axis than model, names item 7d, from run_one and
    from the CLI."""
    rec = run_one("smollm-360m-smoke", "train_4k", mesh="1x2",
                  verbose=False)
    assert rec["chips"] == 2 and rec["mesh"] == "1x2"
    # each pass once for each of the two flat dtype groups at bf16
    assert rec["launches"] == {"accumulate_pass": 2, "update_pass": 2}
    assert rec["collectives"]["_counts"]["allgather_"] >= 1
    assert rec["act_spec"] == "on"
    assert "split over model" in rec["placement"]["activations"]
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="item 7d"):
        run_one("smollm-360m-smoke", "train_4k", mesh="1x2",
                expert_axis="data", verbose=False)
    p = _cli(tmp_path, "--arch", "smollm-360m", "--shape", "train_4k",
             "--mesh", "1x2", "--expert-axis", "data")
    assert p.returncode != 0 and "item 7d" in p.stderr
