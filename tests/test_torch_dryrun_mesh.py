"""The dry run on the JAX package's production meshes (and any DxM),
traced on fake tensors under torch's fake process-group backend: rank 0's
parameter shards, rows of the batch and part of the cache.

  * smollm-360m x decode_32k at 16x16 and with ``--multi-pod`` writes
    JAX's tags (``__16x16``, ``__2x16x16``) and keys, the ``placement``,
    and a per-device argument size of rank 0's parameter shards, tokens
    and cache part: the bytes ``specs.cache_shardings`` (and
    ``param_spec``'s model entries) with ``local_slices`` give;
  * a smoke prefill on a (1, 2) mesh charges flash at the rank's heads
    (whisper's 2 of 4, its encoder's too) and the SSD scan at the rank's
    heads (mamba2's 4 of 8);
  * the train shape on the production meshes: the sharded executor's
    cohort over the batch axes, (pod, data) on the multi-pod mesh;
  * ``--multi-pod``, ``--both-meshes`` and ``--expert-axis model`` parse;
    ``--act-spec on`` (the default) records a serving pair's stream
    whole; ``--expert-axis data`` and an ``--act-spec`` other than on or
    off raise, naming their reasons.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch.dryrun import (main, param_dtypes, parse_mesh,
                                       run_one)
from repro_torch.models import transformer as TT
from repro_torch.sharding.specs import (Mesh, cache_shardings, local_slices,
                                        model_axis_placement, param_spec,
                                        tree_paths)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"arch", "shape", "mesh", "chips", "algorithm", "memory", "cost",
            "collectives", "roofline_raw", "roofline", "hlo_cost"}


def _cli(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
         str(tmp_path), *args], capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        timeout=300)


def _rank0(sizes):
    axes = ("pod", "data", "model") if len(sizes) == 3 else ("data",
                                                               "model")
    return Mesh(axes, dict(zip(axes, sizes)), {a: 0 for a in axes}, {},
                torch.device("cpu"))


def _nbytes(placement, shape, mesh, itemsize):
    return itemsize * math.prod(s.stop - s.start for s in local_slices(
        placement, shape, mesh))


def _expected_arguments(arch, shape_name, sizes):
    """Rank 0's parameter shards, tokens and cache part, in bytes, in the
    config's dtype (bf16; the norms fp32)."""
    cfg, shape = get_arch(arch), get_shape(shape_name)
    mesh = _rank0(sizes)
    params = dict(TT.Transformer(cfg).named_parameters())
    size = {k: torch.empty((), dtype=d).element_size()
            for k, d in param_dtypes(cfg).items()}
    p = sum(_nbytes(model_axis_placement(param_spec(path, tuple(
        leaf.shape), mesh)), tuple(leaf.shape), mesh,
        size[path.replace("/", ".")])
        for path, leaf in tree_paths(params))
    cache = TT.make_cache(cfg, shape.global_batch, shape.seq_len,
                          torch.bfloat16, device="meta")
    pl = cache_shardings(cache, mesh)
    c = sum(_nbytes(pl["layers"][j][k], tuple(t.shape), mesh,
                    t.element_size())
            for j, e in enumerate(cache["layers"]) for k, t in e.items())
    b = shape.global_batch // math.prod(sizes[:-1])
    return p, c, 8 * b + 4                  # int64 tokens, the int32 index


@pytest.mark.parametrize("flag,tag,sizes", [
    (("--mesh", "16x16"), "16x16", (16, 16)),
    (("--multi-pod",), "2x16x16", (2, 16, 16)),
])
def test_decode_32k_on_a_production_mesh(tmp_path, flag, tag, sizes):
    p = _cli(tmp_path, "--arch", "smollm-360m", "--shape", "decode_32k",
             *flag)
    assert p.returncode == 0, p.stdout + p.stderr
    with open(tmp_path / f"smollm-360m__decode_32k__{tag}.json") as f:
        rec = json.load(f)
    assert JAX_KEYS | {"decode_window", "placement", "fits"} <= set(rec)
    assert rec["mesh"] == tag and rec["chips"] == math.prod(sizes)
    params, cache, rest = _expected_arguments("smollm-360m", "decode_32k",
                                              sizes)
    # 32 layers x k, v of (128 / batch axes, 32768 / 16, 5, 64) bf16
    assert cache == 32 * 2 * (128 // math.prod(sizes[:-1])) * 2048 * 5 \
        * 64 * 2
    assert rec["dtype"] == "bfloat16"
    assert rec["memory"]["argument_size_in_bytes"] == params + cache + rest
    assert rec["launches"] == {} and rec["fits"] is True
    assert rec["collectives"]["_counts"]["allgather_"] >= 32


@pytest.mark.parametrize("arch,kernel,heads,calls", [
    # 2 decoder layers (self, cross) and 2 encoder layers, 2 of 4 heads
    ("whisper-large-v3-smoke", "attention_cost", 2, 4),
    # 2 mamba layers, 4 of 8 heads
    ("mamba2-780m-smoke", "ssd_cost", 4, 2),
])
def test_smoke_prefill_charges_the_kernels_at_the_rank_heads(
        monkeypatch, arch, kernel, heads, calls):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd_scan import kernel as SK
    mod = FK if kernel == "attention_cost" else SK
    seen, orig = [], getattr(mod, kernel)

    def record(B, H, *a, **k):
        seen.append(H)
        return orig(B, H, *a, **k)
    monkeypatch.setattr(mod, kernel, record)
    rec = run_one(arch, "prefill_32k", mesh="1x2", verbose=False)
    assert seen == [heads] * calls
    assert sum(rec["launches"].values()) == calls
    assert not torch.distributed.is_initialized()


def test_train_on_the_production_meshes():
    """The round's cohort over the batch axes: 16 clients on (16, 16), 32
    on (2, 16, 16), rank 0 running one of them through its shards (an
    accumulate pass and an update pass on its rows for each flat dtype
    group)."""
    for mesh, cohort in (("16x16", 16), ("2x16x16", 32)):
        rec = run_one("smollm-360m-smoke", "train_4k", mesh=mesh,
                      verbose=False)
        assert rec["cohort"] == cohort and rec["chips"] == cohort * 16
        # each pass once for each of the two flat dtype groups at bf16
        assert rec["launches"] == {"accumulate_pass": 2, "update_pass": 2}
        assert rec["collectives"]["_counts"]["allgather_"] >= 1
        assert not torch.distributed.is_initialized()


def test_the_mesh_flags_parse(tmp_path):
    assert parse_mesh("16x16") == (16, 16)
    assert parse_mesh("2x16x16") == (2, 16, 16)
    with pytest.raises(ValueError, match="DATAxMODEL"):
        parse_mesh("16")
    assert main(["--arch", "smollm-360m-smoke", "--shape", "decode_32k",
                 "--both-meshes", "--expert-axis", "model", "--out",
                 str(tmp_path)]) == 0
    for tag in ("16x16", "2x16x16"):
        with open(tmp_path / f"smollm-360m-smoke__decode_32k__{tag}.json"
                  ) as f:
            rec = json.load(f)
        assert rec["mesh"] == tag and rec["expert_axis"] == "model"
        assert "model" in rec["placement"]["experts"]
    with pytest.raises(SystemExit):
        main(["--arch", "smollm-360m-smoke", "--shape", "decode_32k",
              "--multi-pod", "--mesh", "2x1", "--out", str(tmp_path)])


def test_what_still_refuses_names_its_reason():
    rec = run_one("smollm-360m-smoke", "decode_32k", mesh="16x16",
                  act_spec="on", verbose=False)
    assert rec["act_spec"] == "on"
    assert rec["placement"]["activations"].startswith("replicated")
    with pytest.raises(ValueError, match="model axis only.*item 7d"):
        run_one("deepseek-v2-lite-16b-smoke", "decode_32k", mesh="16x16",
                expert_axis="data", verbose=False)
    with pytest.raises(ValueError, match="on or off"):
        run_one("smollm-360m-smoke", "decode_32k", mesh="16x16",
                act_spec="rows", verbose=False)
    with pytest.raises(ValueError, match="item 7d"):
        main(["--arch", "smollm-360m-smoke", "--shape", "decode_32k",
              "--mesh", "16x16", "--expert-axis", "data"])
    assert not torch.distributed.is_initialized()
