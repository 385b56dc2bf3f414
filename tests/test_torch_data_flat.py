"""Data pipeline and flat layout of the PyTorch port against the JAX
package: batches byte-identical from the same seed, flat specs and
buffers element-equal on bridged parameters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SMOKE, jax_params_to_torch
from repro.configs import get_arch as jax_get_arch
from repro.core import flat as JF
from repro.launch.train import build_synthetic_fed_data as jax_fed_data
from repro.models.model import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import flat as TF
from repro_torch.launch.train import build_synthetic_fed_data
from repro_torch.models.transformer import Transformer


def _both_data(iid, seed=3):
    cfg = get_arch(SMOKE)
    kw = dict(num_clients=8, examples=96, seq=16, iid=iid, seed=seed)
    return (build_synthetic_fed_data(cfg, **kw),
            jax_fed_data(jax_get_arch(SMOKE), **kw))


def _assert_same_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("iid", [False, True])
@pytest.mark.parametrize("share", [False, True])
def test_sample_round_byte_identical(iid, share):
    ours, ref = _both_data(iid)
    _assert_same_tree(ours.arrays, ref.arrays)
    for r in range(3):
        a = ours.sample_round(r, cohort=4, batch=6, share=share)
        b = ref.sample_round(r, cohort=4, batch=6, share=share)
        _assert_same_tree(a["cohort_batch"], b["cohort_batch"])
        assert a["client_weights"].tobytes() == b["client_weights"].tobytes()
        assert a["clients"].tobytes() == b["clients"].tobytes()


@pytest.mark.parametrize("iid", [False, True])
def test_sample_meta_byte_identical(iid):
    ours, ref = _both_data(iid)
    for r in range(3):
        _assert_same_tree(ours.sample_meta(r, 8), ref.sample_meta(r, 8))


@pytest.fixture(scope="module")
def smoke_params():
    model = jax_build_model(jax_get_arch(SMOKE), dtype=jnp.float32)
    jp = model.init(jax.random.PRNGKey(7))
    return jp, jax_params_to_torch(jp)


def _assert_same_spec(ts, js):
    assert len(ts.groups) == len(js.groups)
    jleaves = jax.tree_util.tree_flatten_with_path(js.treedef.unflatten(
        [0] * js.num_leaves))[0]
    jnames = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in jleaves]
    assert list(ts.names) == jnames
    for tg, jg in zip(ts.groups, js.groups):
        assert (tg.size, tg.rows) == (jg.size, jg.rows)
        assert [(l.index, l.shape, l.offset, l.size) for l in tg.leaves] == \
               [(l.index, l.shape, l.offset, l.size) for l in jg.leaves]


def test_flat_spec_matches_jax(smoke_params):
    jp, tp = smoke_params
    _assert_same_spec(TF.make_flat_spec(tp), JF.make_flat_spec(jp))


def test_full_width_flat_spec_matches_jax():
    """smollm-360m at full width, from shapes alone: one fp32 group of
    361,821,120 elements in (2,826,728, 128)."""
    jcfg = jax_get_arch("smollm-360m")
    jshape = jax.eval_shape(jax_build_model(jcfg, dtype=jnp.float32).init,
                            jax.random.PRNGKey(0))
    js = JF.make_flat_spec(jshape)
    ts = TF.make_flat_spec(dict(
        Transformer(get_arch("smollm-360m")).named_parameters()))
    _assert_same_spec(ts, js)
    assert (ts.groups[0].size, ts.groups[0].rows) == (361_821_120, 2_826_728)


def test_flat_buffers_equal_jax(smoke_params):
    jp, tp = smoke_params
    ts, js = TF.make_flat_spec(tp), JF.make_flat_spec(jp)
    for a, b in zip(TF.flatten_tree(ts, tp), JF.flatten_tree(js, jp)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    stack = {k: torch.stack([v, 2 * v, -v]) for k, v in tp.items()}
    jstack = jax.tree.map(lambda v: jnp.stack([v, 2 * v, -v]), jp)
    for a, b in zip(TF.flatten_stacked(ts, stack),
                    JF.flatten_stacked(js, jstack)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert float(TF.flat_sq_norm(TF.flatten_tree(ts, tp))) == pytest.approx(
        float(JF.flat_sq_norm(JF.flatten_tree(js, jp))), rel=1e-6)


def test_flat_and_bridge_round_trip(smoke_params):
    jp, tp = smoke_params
    spec = TF.make_flat_spec(tp)
    bufs = TF.flatten_tree(spec, tp)
    assert bufs[0].view(-1)[spec.groups[0].size:].abs().sum() == 0
    back = TF.unflatten_tree(spec, bufs)
    assert list(back) == list(spec.names)
    for k in tp:
        assert back[k].dtype == tp[k].dtype
        assert torch.equal(back[k], tp[k])
    nested = bridge.to_numpy(tp)
    assert jax.tree.structure(nested) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(nested), jax.tree.leaves(jp)):
        assert np.array_equal(a, np.asarray(b))


def test_leaf_order_is_jax_tree_order():
    tree = {"embed": 0, "final_norm": 0, "w1": 0,
            "blocks": tuple({"w": 0, "a_b": 0, "a": {"c": 0}}
                            if i in (2, 10) else {} for i in range(11))}
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    shuffled = list(np.random.default_rng(0).permutation(paths))
    assert TF.leaf_order(shuffled) == paths
