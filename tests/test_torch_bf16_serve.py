"""Serving a model built at bf16: smollm-360m-smoke (flash attention),
mamba2-780m-smoke (the SSD scan) and deepseek-v2-lite-16b-smoke (MLA and
the MoE), each at ``dtype=bfloat16`` in both packages on the same
parameters (JAX's init at bf16, bridged: bf16 leaves stay bf16, the
norms, the router and the mamba scalars fp32).  The port's prefill runs
the kernels' plain versions at bf16 (the wrappers take bf16 now), JAX's
its XLA attention and chunked scan at bf16.

Held: the prefill's logits, every cache leaf (its dtype too: k / v and
MLA's latents bf16, the SSM state fp32, the conv tail bf16) and one
decode step's logits.  Tolerance 3e-2, max |a-b| over max |b|: the two
packages round to bf16 at other places (the products' accumulation
order, where a sum is rounded, the online softmax's blocks against one
softmax), so each layer's output may differ by a few bf16 steps of 2^-8;
3e-2 is JAX's own flash kernel's bf16 tolerance (``tests/test_kernels.py``,
atol on unit-scale outputs; its SSD scan's is 6e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params_to_torch, rel_err
from repro.configs import get_arch as jax_get_arch
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.models.model import build_model

ARCHS = ["smollm-360m-smoke", "mamba2-780m-smoke",
         "deepseek-v2-lite-16b-smoke"]
B, PROMPT, CACHE = 2, 24, 32
TOL = 3e-2


def _bf16_params(jp):
    """JAX's bf16 tree -> the port's dict, each leaf in its JAX dtype."""
    flat32 = jax_params_to_torch(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp))
    dts = jax_params_to_torch(jax.tree.map(
        lambda a: np.zeros((), np.int8 if a.dtype == jnp.bfloat16
                           else np.float32), jp))
    return {k: v.to(torch.bfloat16) if dts[k].dtype == torch.int8 else v
            for k, v in flat32.items()}


def _np32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, t in enumerate(tree)
                for x in _leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    name = request.param
    jm = jax_build_model(jax_get_arch(name), dtype=jnp.bfloat16)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (B, PROMPT)).astype(np.int32)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=CACHE))(
        jp, {"tokens": jnp.asarray(tokens)})
    tok = np.argmax(np.asarray(jl, np.float32), -1)
    jd, _ = jax.jit(jm.decode)(jp, jnp.asarray(tok), jc)

    m = build_model(get_arch(name), dtype=torch.bfloat16)
    params = _bf16_params(jp)
    tl, tc = m.prefill(params, {"tokens": torch.from_numpy(tokens).long()},
                       CACHE)
    td, _ = m.decode(params, torch.from_numpy(tok).long(),
                     {**tc, "layers": tuple({k: v.clone() for k, v in
                                             e.items()} for e in
                                            tc["layers"])})
    return dict(name=name, jax=(jl, jc, jd), port=(tl, tc, td),
                params=params)


def test_parameters_keep_their_dtypes(served):
    """The bridged tree is what the port's init builds at bf16: the same
    names and dtypes."""
    from repro_torch.launch.dryrun import param_dtypes
    want = param_dtypes(get_arch(served["name"]))
    got = {k: v.dtype for k, v in served["params"].items()}
    assert got == want
    assert torch.bfloat16 in set(got.values())


def test_prefill_logits_match_jax_at_bf16(served):
    jl, tl = served["jax"][0], served["port"][0]
    assert tl.dtype == torch.bfloat16
    assert rel_err(_np32(tl), _np32(jl)) <= TOL


def test_prefill_cache_matches_jax_at_bf16(served):
    want = _leaves({k: v for k, v in served["jax"][1].items()
                    if k != "index"})
    got = _leaves({k: v for k, v in served["port"][1].items()
                   if k != "index"})
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        assert rel_err(_np32(a), _np32(b)) <= TOL, path


def test_one_decode_step_matches_jax_at_bf16(served):
    jd, td = served["jax"][2], served["port"][2]
    assert td.dtype == torch.bfloat16
    assert rel_err(_np32(td), _np32(jd)) <= TOL
