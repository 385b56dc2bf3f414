"""The port's static analyzer (``repro_torch.analysis.fedlint``) against
the JAX package's (``repro.analysis.fedlint``), rule by rule, on tiny
synthetic trees written under ``tmp_path`` (``tests/test_fedlint.py``'s
fixtures).

Where a rule keeps JAX's form (FL001, FL101, FL102, FL301, FL302, FL501
and the suppressions), both analyzers run over the same snippets and must
report the same (code, line) findings, the documented ones.  Where the
port's contract differs (FL103, FL201-FL204, FL401), the port's rule runs
on fixtures of the port's own idiom: host numpy generators, wrappers that
dispatch on the device of their tensors, ``torch.autograd.Function``, the
round builders' bodies and ``torch.func`` transforms; among them the line
the port's round held before its all-failed test moved to the host
(``if needs_draws and not bool(torch.sum(client_weights) > 0):``).  Last,
the analyzer over ``src/repro_torch`` is clean, and the CLI's exit codes
are JAX's."""
import os
import textwrap

import pytest

import _torch_parity  # noqa: F401  (one torch thread)
from repro.analysis.fedlint import run_fedlint as jax_run_fedlint
from repro_torch.analysis.fedlint import Finding, run_fedlint
from repro_torch.analysis.fedlint.__main__ import main as fedlint_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, files):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def run_on(tmp_path, files, run=run_fedlint):
    _write(tmp_path, files)
    return run([str(tmp_path)])


def codes(findings):
    return sorted(f.code for f in findings)


def code_lines(findings):
    return sorted((f.code, f.line) for f in findings)


# ---------------------------------------------------------------------------
# rules in JAX's form: the same (code, line) findings as JAX's analyzer
# ---------------------------------------------------------------------------
_FULL_ENGINE = """\
    from engines import register_engine

    @register_engine("full")
    class FullEngine:
        accepts = ("delta",)
        preferred = "delta"
        meta_capabilities = ("none",)
        codec_capabilities = ("identity",)
        is_async = False
"""
_PROBED_ROUND = """\
    from sanitize import check_flat_groups

    def make_federated_round(model, fed, sanitize=False):
        def one_round(state, batch):
            if sanitize:
                check_flat_groups(None, state, "post-round params")
            return state, {}
        return one_round
"""

PARITY = {
    "FL001-unparseable": ({"broken.py": "def f(:\n"}, ["FL001"]),
    "FL101-inline-fold-tag": ({"mod.py": """\
        import jax

        def derive(k):
            return jax.random.fold_in(k, 0x1234)
    """}, ["FL101"]),
    "FL101-local-constant-tag": ({"mod.py": """\
        import jax

        MY_TAG = 99

        def derive(k):
            return jax.random.fold_in(k, MY_TAG)
    """}, ["FL101"]),
    "FL101-inline-seed-tuple": ({"mod.py": """\
        import numpy as np

        def rng_for(seed, r):
            return np.random.default_rng((seed, 7777, r))
    """}, ["FL101"]),
    "FL101-local-seed-component": ({"mod.py": """\
        import numpy as np

        SPEED = 0x5BEED

        def rng_for(seed):
            return np.random.default_rng((seed, SPEED))
    """}, ["FL101"]),
    "FL101-good-registry-and-dynamic": ({
        "core/rngtags.py": "EVAL_FOLD = 10_000\nFAULT_FOLD = 0xFA0175\n",
        "mod.py": """\
            import numpy as np
            from core.rngtags import EVAL_FOLD, FAULT_FOLD

            def derive(seed, r, i):
                a = np.random.default_rng((seed, FAULT_FOLD, r))
                b = np.random.default_rng((seed, EVAL_FOLD + i))
                return a, b
        """}, []),
    "FL102-registry-collision": ({"core/rngtags.py": """\
        A_FOLD = 0x42
        B_FOLD = 0x42
    """}, ["FL102"]),
    "FL102-inline-collides-with-registry": ({
        "core/rngtags.py": "A_FOLD = 0x42\n",
        "mod.py": """\
            import numpy as np

            def rng_for(seed):
                return np.random.default_rng((seed, 0x42))
        """}, ["FL101", "FL102"]),
    "FL102-good-distinct": ({"core/rngtags.py": """\
        A_FOLD = 0x42
        B_FOLD = 0x43
    """}, []),
    "FL301-engine-missing-capabilities": ({"mod.py": """\
        from engines import register_engine

        @register_engine("half")
        class HalfEngine:
            accepts = ("delta",)
            preferred = "delta"
    """}, ["FL301"]),
    "FL301-good-capabilities-via-base": ({"mod.py": """\
        from engines import register_engine

        class Base:
            meta_capabilities = ("none",)
            codec_capabilities = ("identity",)
            is_async = False

        @register_engine("full")
        class FullEngine(Base):
            accepts = ("delta",)
            preferred = "delta"
    """}, []),
    "FL301-algorithm-without-pseudo-gradient": ({"mod.py": """\
        from algorithms import register_algorithm

        register_algorithm("fedavg", description="plain averaging")
    """}, ["FL301"]),
    "FL301-executor-and-codec": ({"mod.py": """\
        from registry import register_codec, register_executor

        @register_executor("half")
        class HalfExecutor:
            produces = ("flat",)

        @register_codec("noisy")
        class Noisy:
            pass
    """}, ["FL301", "FL301"]),
    "FL302-stale-config-field": ({"mod.py": """\
        class FedConfig:
            cohort_size: int = 4

        def guard(cfg):
            raise ValueError("bad setup; set num_cohorts=8 instead")
    """}, ["FL302"]),
    "FL302-good-field-and-param": ({"mod.py": """\
        class FedConfig:
            cohort_size: int = 4

        def guard(cfg, server_lr):
            raise ValueError(
                f"bad setup (server_lr={server_lr}); set cohort_size=8")
    """}, []),
    "FL501-builder-lost-its-probe": ({
        "engine.py": _FULL_ENGINE,
        "round.py": """\
            def make_federated_round(model, fed, sanitize=False):
                def one_round(state, batch):
                    return state, {}
                return one_round
        """}, ["FL501"]),
    "FL501-good-guarded-probe": ({"engine.py": _FULL_ENGINE,
                                  "round.py": _PROBED_ROUND}, []),
    "FL501-async-engine-checks-make-async-tick": ({
        "engine.py": """\
            from engines import register_engine

            @register_engine("buffered")
            class BufferedEngine:
                accepts = ("delta",)
                preferred = "delta"
                meta_capabilities = ("none",)
                codec_capabilities = ("identity",)
                is_async = True
        """,
        "async_round.py": """\
            def make_async_tick(model, fed, sanitize=False):
                def one_tick(state, batch):
                    return state, {}
                return one_tick
        """,
        "round.py": _PROBED_ROUND}, ["FL501"]),
    "FL501-good-class-local-probe": ({
        "engine.py": """\
            from engines import register_engine
            from sanitize import check_flat_groups

            @register_engine("careful")
            class CarefulEngine:
                accepts = ("delta",)
                preferred = "delta"
                meta_capabilities = ("none",)
                codec_capabilities = ("identity",)
                is_async = False

                def apply(self, params, handle, opt, lr, sanitize=False):
                    if sanitize:
                        check_flat_groups(None, handle, "engine apply")
                    return params, opt, 0.0
        """,
        "round.py": """\
            def make_federated_round(model, fed, sanitize=False):
                def one_round(state, batch):
                    return state, {}
                return one_round
        """}, []),
    "FL501-silent-without-builder": ({"engine.py": _FULL_ENGINE}, []),
    "suppression-drops-finding": ({"mod.py": """\
        import numpy as np

        def rng_for(seed):
            return np.random.default_rng((seed, 7))  # fedlint: disable=FL101
    """}, []),
    "suppression-is-code-specific": ({"mod.py": """\
        import numpy as np

        def rng_for(seed):
            return np.random.default_rng((seed, 7))  # fedlint: disable=FL999
    """}, ["FL101"]),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_jax_form_rules_match_jaxs_analyzer(tmp_path, name):
    files, want = PARITY[name]
    _write(tmp_path, files)
    ours = run_fedlint([str(tmp_path)])
    theirs = jax_run_fedlint([str(tmp_path)])
    assert codes(ours) == want, ours
    assert code_lines(ours) == code_lines(theirs), (ours, theirs)


# ---------------------------------------------------------------------------
# FL103, torch form: one host stream built twice
# ---------------------------------------------------------------------------
def test_fl103_same_seed_built_twice(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import numpy as np
        from core.rngtags import FAULT_FOLD

        def draws(seed, r):
            a = np.random.default_rng((seed, FAULT_FOLD, r)).random(4)
            b = np.random.default_rng((seed, FAULT_FOLD, r)).random(4)
            return a, b
    """})
    assert code_lines(found) == [("FL103", 6)]
    assert "line 5" in found[0].message


def test_fl103_torch_generator_seeded_twice(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import torch

        def init(model, dev, seed):
            p = model.init(torch.Generator(device=dev).manual_seed(seed))
            q = model.init(torch.Generator(device=dev).manual_seed(seed))
            return p, q
    """})
    assert code_lines(found) == [("FL103", 5)]


def test_fl103_good_rebind_branches_and_kinds(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import numpy as np
        import torch

        def draws(seed, rounds, flag):
            out = []
            for r in range(rounds):
                out.append(np.random.default_rng((seed, r)).random(2))
            if flag:
                g = np.random.default_rng(seed)
            else:
                g = np.random.default_rng(seed)
            seed = seed + 1
            h = np.random.default_rng(seed)
            t = torch.Generator().manual_seed(seed)
            fresh = np.random.default_rng(), np.random.default_rng()
            return out, g, h, t, fresh
    """})
    assert found == []


# ---------------------------------------------------------------------------
# FL201-FL203, torch form: the wrapper / oracle contract
# ---------------------------------------------------------------------------
_WRAPPER = """\
    from . import ref as R
    from _cuda import charge, device_of, traced

    def foo_pass(x, w, *, out=None):
        dev = device_of(x, w)
        if traced(x, w):
            charge(foo_pass, None)
            return x.new_empty(x.shape)
        if dev.type == "cpu":
            res = R.foo_ref(x, w)
            return res if out is None else out.copy_(res)
        foo_pass.launches += 1
        return launch(x, w, out)
"""
_ORACLE = "def foo_ref(x, w):\n    return x * w\n"


def test_kernel_pair_good(tmp_path):
    found = run_on(tmp_path, {"kernels/foo/kernel.py": _WRAPPER,
                              "kernels/foo/ref.py": _ORACLE})
    assert found == []


def test_fl201_missing_oracle(tmp_path):
    found = run_on(tmp_path, {"kernels/foo/kernel.py": _WRAPPER,
                              "kernels/foo/ref.py": ""})
    assert codes(found) == ["FL201"]
    assert "foo_ref" in found[0].message


def test_fl202_drift_beyond_out(tmp_path):
    found = run_on(tmp_path, {
        "kernels/foo/kernel.py": _WRAPPER,
        "kernels/foo/ref.py": "def foo_ref(x, inv, scale):\n    return x\n"})
    assert code_lines(found) == [("FL202", 4)]
    assert "signature drift" in found[0].message


@pytest.mark.parametrize("edit,line,what", [
    (('if dev.type == "cpu":', 'if dev.type == "meta":'), 4, "oracle"),
    (("if traced(x, w):", "if x is None:"), 4, "traced"),
    (("charge(foo_pass, None)", "charge(bar_pass, None)"), 4, "traced"),
    (("        foo_pass.launches += 1\n        return launch(x, w, out)",
      "        try:\n            return launch(x, w, out)\n"
      "        except RuntimeError:\n            return R.foo_ref(x, w)"),
     12, "fallback"),
], ids=["no-cpu-arm", "no-traced-arm", "charges-another", "try-except"])
def test_fl203_dispatch_contract(tmp_path, edit, line, what):
    found = run_on(tmp_path, {
        "kernels/foo/kernel.py": _WRAPPER.replace(*edit),
        "kernels/foo/ref.py": _ORACLE})
    assert code_lines(found) == [("FL203", line)], found
    assert what in found[0].message


def test_kernel_rules_ignore_non_kernel_dirs(tmp_path):
    found = run_on(tmp_path, {"misc/kernel.py":
                              "def bar_pass(x):\n    return x\n"})
    assert found == []


# ---------------------------------------------------------------------------
# FL204, torch form: torch.autograd.Function
# ---------------------------------------------------------------------------
def test_fl204_missing_backward_and_not_static(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import torch
        from torch.autograd import Function

        class Half(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 0.5

        class Loose(Function):
            def forward(ctx, x):
                return x

            @staticmethod
            def backward(ctx, g):
                return g
    """})
    assert code_lines(found) == [("FL204", 4), ("FL204", 10)]
    assert "backward" in found[0].message
    assert "staticmethod" in found[1].message


def test_fl204_good_function_and_other_classes(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import torch

        class Square(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * x

            @staticmethod
            def backward(ctx, g):
                (x,) = ctx.saved_tensors
                return 2.0 * x * g

        class Function:
            def run(self):
                return 0
    """})
    assert found == []


# ---------------------------------------------------------------------------
# FL401, torch form: host reads in traced bodies
# ---------------------------------------------------------------------------
_ALL_FAILED_READ = """\
    import numpy as np
    import torch

    def make_federated_round(model, fed):
        needs_draws = fed.participation < 1.0

        def one_round(state, cohort_batch, meta_batch,
                      client_weights: torch.Tensor, draws=None):
            if needs_draws and not bool(torch.sum(client_weights) > 0):
                return state, {}
            return state, {"participants": np.float32(2)}

        return one_round
"""
_HOST_TEST = """\
    import numpy as np
    import torch

    def make_federated_round(model, fed):
        needs_draws = fed.participation < 1.0

        def one_round(state, cohort_batch, meta_batch, client_weights,
                      draws=None):
            w = np.asarray(client_weights, np.float32)
            if needs_draws:
                w = w * np.asarray(draws.participation, np.float32)
                if not np.sum(w, dtype=np.float32) > 0:
                    return state, {"participants": float(np.sum(w > 0))}
            t = torch.tensor(w)
            n = int(t.shape[0]) + t.numel()
            return state, {"n": n, "lr": float(np.float32(0.1) * 0.5)}

        return one_round
"""


def test_fl401_flags_the_all_failed_device_read(tmp_path):
    found = run_on(tmp_path, {"core/round.py": _ALL_FAILED_READ})
    assert code_lines(found) == [("FL401", 9)]
    assert "bool()" in found[0].message


def test_fl401_silent_on_host_numpy_and_metadata(tmp_path):
    assert run_on(tmp_path, {"core/round.py": _HOST_TEST}) == []


def test_fl401_reads_in_builders_and_transforms(tmp_path):
    found = run_on(tmp_path, {"mod.py": """\
        import torch
        from torch.func import grad, jvp

        def make_async_tick(model, fed):
            def one_tick(state, client_weights, draws=None):
                w_in = client_weights.detach().to("cpu").numpy()
                return state, {"w": w_in}
            return one_tick

        def _chunk_rounds(one_round, k):
            def round_fn(state, batches):
                loss = torch.zeros(())
                for j in range(k):
                    state, m = one_round(state, batches[j])
                return state, {"loss": loss.item()}
            return round_fn

        def local_loss(w, batch):
            s = (w * batch).sum()
            print(float(s))
            return s

        def hvp(w, v, batch):
            g = grad(local_loss)(w, batch)
            _, t = jvp(lambda w_: grad(local_loss)(w_, batch).cpu(), (w,),
                       (v,))
            per = torch.func.vmap(lambda b: (w * b).sum().tolist())(batch)
            return g, t, per

        def host_side(w):
            return float(w.sum()), w.cpu().numpy()
    """})
    assert code_lines(found) == [("FL401", 6), ("FL401", 6), ("FL401", 15),
                                 ("FL401", 20), ("FL401", 25),
                                 ("FL401", 27)], found


def test_fl401_takes_the_last_binding(tmp_path):
    """A name rebound from a tensor to a host value is host data after
    the rebinding, and the other way round."""
    found = run_on(tmp_path, {"core/round.py": """\
        import numpy as np
        import torch

        def make_federated_round(model, fed):
            def one_round(state, w):
                x = torch.ones(3)
                x = np.ones(3)
                a = float(x.sum())
                y = np.ones(3)
                y = torch.ones(3)
                b = float(y.sum())
                return state, {"a": a, "b": b}
            return one_round
    """})
    assert code_lines(found) == [("FL401", 11)]


# ---------------------------------------------------------------------------
# the port's tree, the reference's, suppressions, format and CLI
# ---------------------------------------------------------------------------
def test_the_port_is_clean(capsys):
    assert fedlint_main([os.path.join(ROOT, "src", "repro_torch")]) == 0
    assert "clean" in capsys.readouterr().out


def test_suppression_comment_drops_a_torch_form_finding(tmp_path):
    src = _ALL_FAILED_READ.replace(
        "> 0):", "> 0):  # fedlint: disable=FL401")
    assert run_on(tmp_path, {"core/round.py": src}) == []


def test_finding_format():
    f = Finding("src/x.py", 12, "FL401", "host read")
    assert f.format() == "src/x.py:12: FL401 host read"


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad"
    (bad / "core").mkdir(parents=True)
    (bad / "core" / "round.py").write_text(textwrap.dedent(_ALL_FAILED_READ))
    assert fedlint_main([str(bad)]) == 1
    assert "FL401" in capsys.readouterr().out
    good = tmp_path / "good"
    good.mkdir()
    (good / "mod.py").write_text("def f(x):\n    return x\n")
    assert fedlint_main([str(good)]) == 0
    assert "clean" in capsys.readouterr().out


def test_the_analyzer_imports_no_torch(tmp_path):
    """Pure stdlib: a fresh interpreter runs it with torch unimportable."""
    import subprocess
    import sys
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "torch.py").write_text("raise ImportError('no torch here')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(stub), os.path.join(ROOT, "src")])}
    p = subprocess.run([sys.executable, "-m", "repro_torch.analysis.fedlint",
                        os.path.join(ROOT, "src", "repro_torch")],
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "clean" in p.stdout
