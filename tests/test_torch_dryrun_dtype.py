"""The dry run in the config's dtype (``repro_torch.launch.dryrun``), as
JAX's dry run builds its models: without a dtype, so at ``cfg.dtype``
(bfloat16 for every config).

  * For the smoke config of every architecture of ``configs.matrix()``,
    each parameter stand-in's dtype and the parameters' bytes equal those
    of JAX's ``jax.eval_shape(model.init, ...)`` for the same config
    (shapes only, nothing compiled): the bf16 leaves at 2 bytes, the
    norms, the router and the mamba scalars fp32.
  * A train pair's record states ``bfloat16`` and charges the server's
    passes once for each flat dtype group, the flat buffers fp32
    (``core/flat.py``); a decode pair's arguments are its parameters, the
    bf16 cache and the tokens, byte for byte; a serving pair charges
    flash attention at 2 bytes an element and its products at the bf16
    rate.
"""
import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_parity  # noqa: F401  (one torch thread)
from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch, get_shape, matrix
from repro_torch.kernels.flash_attention.kernel import attention_cost
from repro_torch.launch.dryrun import _param_stand_ins, param_dtypes, run_one
from repro_torch.models import transformer as TT

ARCHS = sorted({a for a, _ in matrix()})


def _jax_shapes(name):
    jm = jax_build_model(jax_get_arch(name))
    tree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {}
    bridge._walk(tree, "", flat)
    return flat


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_equal_jax_eval_shape(arch):
    name = f"{arch}-smoke"
    want = _jax_shapes(name)
    with FakeTensorMode():
        got = _param_stand_ins(get_arch(name), torch.device("cpu"))
    assert set(got) == set(want)
    for k, t in got.items():
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    nbytes = sum(t.numel() * t.element_size() for t in got.values())
    assert nbytes == sum(int(np.prod(s.shape)) * s.dtype.itemsize
                         for s in want.values())
    assert torch.bfloat16 in {t.dtype for t in got.values()}


def test_train_pair_records_bfloat16():
    rec = run_one("smollm-360m-smoke", "train_4k", verbose=False)
    assert rec["dtype"] == get_arch("smollm-360m-smoke").dtype == "bfloat16"
    # the bf16 leaves and the fp32 norms: two flat groups, a pass each
    assert rec["launches"] == {"aggregate_pass": 2, "update_pass": 2}
    assert rec["cost"]["bf16_flops"] > 0


def test_decode_pair_arguments_are_bf16_bytes():
    name, shape = "smollm-360m-smoke", get_shape("decode_32k")
    rec = run_one(name, "decode_32k", verbose=False)
    cfg = get_arch(name)
    size = {k: torch.empty((), dtype=d).element_size()
            for k, d in param_dtypes(cfg).items()}
    params = sum(size[k] * v.numel()
                 for k, v in TT.Transformer(cfg).named_parameters())
    cache = TT.make_cache(cfg, shape.global_batch, shape.seq_len,
                          torch.bfloat16, device="meta")
    cache_b = sum(t.numel() * t.element_size()
                  for e in cache["layers"] for t in e.values())
    assert rec["memory"]["argument_size_in_bytes"] == (
        params + cache_b + 8 * shape.global_batch + 4)


def test_prefill_pair_charges_flash_at_bf16(monkeypatch):
    from repro_torch.kernels.flash_attention import kernel as FK
    seen = []

    def record(*a, **k):
        seen.append(k.get("nbytes"))
        return attention_cost(*a, **k)
    monkeypatch.setattr(FK, "attention_cost", record)
    rec = run_one("smollm-360m-smoke", "prefill_32k", verbose=False)
    assert seen and set(seen) == {2}
    assert rec["dtype"] == "bfloat16"
    kc = attention_cost(1, 2, 1, 64, 64, 64, 64, nbytes=2)
    assert kc.tc_flops == 0 and kc.bf16_flops > 0
