"""The port's placement rules (``repro_torch.sharding.specs``) against the
JAX package's ``repro/sharding/specs.py``, and the production meshes.

Every spec function is held EQUAL to JAX's — a placement is the tuple a
``PartitionSpec`` holds, a one-name tuple and the bare name being one
entry as newer JAX normalizes them — at every configuration's full-width
shapes (the port's on the ``meta`` device, JAX's from
``jax.eval_shape``), on the meshes (16, 16), (2, 16, 16) under both
cohort strategies, (1, 2), (2, 2) and (1, 3).  JAX's functions run
whole, on a ``jax.sharding.AbstractMesh`` of those axes (no devices), and
their ``NamedSharding``s' specs are compared.  One JAX shape trace per
configuration.
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_parity  # noqa: F401  (one torch thread)
from repro import configs as JC
from repro.configs.base import FedConfig as JaxFedConfig
from repro.core import flat as JF
from repro.core.round import init_server_state as jax_init_state
from repro.models.model import build_model as jax_build_model
from repro.sharding import specs as JS
from repro_torch import configs as TC
from repro_torch.configs import FedConfig
from repro_torch.core import flat as TF
from repro_torch.core.round import init_server_state
from repro_torch.models import transformer as TT
from repro_torch.sharding import specs as TS

MESHES = {"16x16": ("data", "model"), "2x16x16": ("pod", "data", "model"),
          "1x2": ("data", "model"), "2x2": ("data", "model"),
          "1x3": ("data", "model")}
STRATEGIES = ("vmap", "scan")


def sizes(name):
    return tuple(int(x) for x in name.split("x"))


def jax_mesh(name):
    return AbstractMesh(sizes(name), MESHES[name])


def port_mesh(name, coords=None):
    axes = MESHES[name]
    return TS.Mesh(axes, dict(zip(axes, sizes(name))),
                   coords or {a: 0 for a in axes}, {}, torch.device("cpu"))


def norm(entry):
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def placement(spec):
    return tuple(norm(e) for e in spec)


def jax_specs(tree):
    """(paths, placements) of a tree of NamedShardings, in JAX's order."""
    flat, _, paths = JS.tree_paths(tree)
    return paths, [placement(s.spec) for _, s in flat]


def port_specs(tree):
    got = TS.tree_paths(tree)
    return [p for p, _ in got], [placement(s) for _, s in got]


def strategies(mname):
    # fsdp_axes differs between the strategies only with a pod axis
    return STRATEGIES if "pod" in MESHES[mname] else ("vmap",)


@pytest.fixture(scope="module")
def shapes():
    """{arch: (JAX params shape tree, the port's meta params)}."""
    out = {}
    for name in JC.ARCHS:
        jm = jax_build_model(JC.get_arch(name), dtype=jnp.float32)
        jshape = jax.eval_shape(jm.init, jax.ShapeDtypeStruct((2,),
                                                               jnp.uint32))
        out[name] = (jshape, dict(TT.Transformer(
            TC.get_arch(name)).named_parameters()))
    return out


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_param_rules_equal_jax(shapes, arch):
    """tree_paths in JAX's order, and fsdp_axes, param_spec,
    param_shardings and cohort_grad_shardings leaf for leaf, on every
    mesh and strategy."""
    jshape, tp = shapes[arch]
    flat, _, jpaths = JS.tree_paths(jshape)
    tpaths = TS.tree_paths(tp)
    assert [p for p, _ in tpaths] == jpaths
    assert [tuple(l.shape) for _, l in tpaths] == \
        [tuple(l.shape) for _, l in flat]
    for mname in MESHES:
        for strategy in strategies(mname):
            jm, tm = jax_mesh(mname), port_mesh(mname)
            assert norm(TS.fsdp_axes(tm, strategy)) == \
                norm(JS.fsdp_axes(jm, strategy))
            want = [placement(JS.param_spec(p, l.shape, jm, strategy))
                    for p, (_, l) in zip(jpaths, flat)]
            assert [placement(TS.param_spec(p, tuple(l.shape), tm,
                                            strategy))
                    for p, l in tpaths] == want, (mname, strategy)
            assert port_specs(TS.param_shardings(tp, tm, strategy)) == \
                jax_specs(JS.param_shardings(jshape, jm, strategy))
            assert port_specs(TS.cohort_grad_shardings(tp, tm, strategy)) \
                == jax_specs(JS.cohort_grad_shardings(jshape, jm, strategy))


def test_param_rules_on_jax_own_cases():
    """The JAX suite's own cases (tests/test_sharding_and_dryrun.py),
    through the port's rules."""
    m = port_mesh("2x2")
    m = TS.Mesh(m.axis_names, {"data": 4, "model": 2}, m.coords, {},
                m.device)
    assert TS.param_spec("blocks/0/attn/wq", (4, 64, 128), m) == \
        (None, "data", "model")
    assert TS.param_spec("blocks/0/attn/wo", (4, 128, 64), m) == \
        (None, "model", "data")
    assert TS.param_spec("embed", (1024, 64), m) == ("model", "data")
    assert TS.param_spec("blocks/0/norm1", (4, 64), m) == (None, None)
    assert TS.param_spec("final_norm", (64,), m) == (None,)
    assert TS.param_spec("blocks/0/mlp/w_down", (4, 8, 32, 64), m) == \
        (None, "model", None, "data")
    assert TS.param_spec("embed", (51866, 1280), port_mesh("16x16")) == \
        (None, "data")


@pytest.mark.parametrize("opt,fused", [("sgd", True), ("adam", True),
                                       ("adam", False)])
def test_state_and_flat_rules_equal_jax(shapes, opt, fused):
    """state_shardings over smollm-360m's server state (fused: the flat
    optimizer slots; legacy: the tree ones), flat_group_shardings, and
    the rows flat_group_pspecs gives each model coordinate."""
    arch = "smollm-360m"
    jshape, tp = shapes[arch]
    jmodel = jax_build_model(JC.get_arch(arch), dtype=jnp.float32)
    kw = dict(server_opt=opt, fused_update=fused)
    jstate = jax.eval_shape(lambda k: jax_init_state(
        jmodel, JaxFedConfig(**kw), k), jax.ShapeDtypeStruct((2,),
                                                            jnp.uint32))
    tstate = init_server_state(None, FedConfig(**kw), params=tp)
    jspec, tspec = JF.make_flat_spec(jshape), TF.make_flat_spec(tp)
    assert [g.rows for g in tspec.groups] == [g.rows for g in jspec.groups]
    for mname in MESHES:
        jm, tm = jax_mesh(mname), port_mesh(mname)
        assert port_specs(TS.state_shardings(tstate, tm)) == \
            jax_specs(JS.state_shardings(jstate, jm))
        want = [placement(s.spec) for s in
                JS.flat_group_shardings(jspec, jm)]
        assert [placement(p) for p in
                TS.flat_group_shardings(tspec, tm)] == want
        assert want == [placement(p) for p in
                        JS.flat_group_pspecs(jspec, jm)]
        m = tm.shape["model"]
        for c in range(m):
            rows = TS.flat_group_pspecs(
                tspec, port_mesh(mname, {**tm.coords, "model": c}))
            for g, sl, p in zip(tspec.groups, rows, want):
                n = g.rows // m if p[0] == "model" else g.rows
                lo = c * n if p[0] == "model" else 0
                assert (sl.start, sl.stop) == (lo, lo + n)


@pytest.mark.parametrize("arch", ["smollm-360m", "jamba-1.5-large-398b",
                                  "deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
def test_batch_and_cache_rules_equal_jax(arch):
    """cohort_batch_shardings (vmap, scan), simple_batch_shardings,
    cache_shardings at B 8 and B 1 (the sequence then takes the FSDP
    axes) and replicated, on every mesh; the caches hold KV, MLA, SSM,
    conv and cross leaves between them."""
    jmodel = jax_build_model(JC.get_arch(arch), dtype=jnp.float32)
    tcfg = TC.get_arch(arch)
    batch = {"tokens": (16, 8, 129)}
    if tcfg.encoder is not None:
        batch["enc_embeds"] = (16, 8, tcfg.encoder.enc_len,
                               tcfg.encoder.enc_dim)
    tbatch = {k: torch.empty(s, device="meta") for k, s in batch.items()}
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, s in batch.items()}
    caches = {B: (jax.eval_shape(lambda B=B: jmodel.make_cache(B, 64)),
                  TT.make_cache(tcfg, B, 64, device="meta"))
              for B in (8, 1)}
    for mname in MESHES:
        jm, tm = jax_mesh(mname), port_mesh(mname)
        for strategy in STRATEGIES:
            assert port_specs(TS.cohort_batch_shardings(tbatch, tm,
                                                        strategy)) == \
                jax_specs(JS.cohort_batch_shardings(jbatch, jm, strategy))
        first = {k: v[0] for k, v in tbatch.items()}
        jfirst = {k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
                  for k, v in jbatch.items()}
        assert port_specs(TS.simple_batch_shardings(first, tm)) == \
            jax_specs(JS.simple_batch_shardings(jfirst, jm))
        for B, (jcache, tcache) in caches.items():
            assert port_specs(TS.cache_shardings(tcache, tm)) == \
                jax_specs(JS.cache_shardings(jcache, jm)), (mname, B)
            assert port_specs(TS.replicated(tcache, tm)) == \
                jax_specs(JS.replicated(jcache, jm))


def test_local_slices_tile_every_placement():
    """The slices of every mesh coordinate tile an array exactly once per
    replica, for each placement kind (one axis, a tuple of axes, None)."""
    tm = port_mesh("2x16x16")
    shape = (256, 64, 32)
    for pl in [(None, "model", ("pod", "data")),
               (("data", "model"), None, None), (None, None, None)]:
        seen = np.zeros(shape, np.int32)
        for pod in range(2):
            for d in range(16):
                for m in range(16):
                    cm = port_mesh("2x16x16", {"pod": pod, "data": d,
                                               "model": m})
                    seen[TS.local_slices(pl, shape, cm)] += 1
        split = math.prod(tm.shape[a] for e in pl if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        assert (seen == tm.size // split).all(), pl


def test_production_meshes_match_jax():
    """make_production_mesh under torch's fake backend has JAX's shapes
    and axes (JAX's built on 512 host devices, in a process of its
    own)."""
    code = ("import json; from repro.launch.mesh import make_production_mesh"
            " as m; print(json.dumps([[list(x.axis_names), dict(x.shape)] "
            "for x in (m(), m(multi_pod=True))]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(root, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    want = json.loads(p.stdout.strip().splitlines()[-1])
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    got = []
    for multi in (False, True):
        try:
            m = make_production_mesh(multi_pod=multi)
            got.append([list(m.axis_names), dict(m.shape)])
            assert m.coords == {a: 0 for a in m.axis_names}
            # and, on the multi-pod mesh, the batch axes' group
            assert set(m.groups) == set(m.axis_names) | (
                {("pod", "data")} if multi else set())
            assert dist.get_world_size() == m.size
        finally:
            dist.destroy_process_group()
    assert got == want
