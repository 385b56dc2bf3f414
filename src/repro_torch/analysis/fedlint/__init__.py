"""fedlint: the port's static analyzer (PyTorch port of
``repro/analysis/fedlint``).

Five passes over the source tree (pure stdlib ``ast`` + ``re``: no torch
import, no code execution).  The rules keep JAX's codes; where the port's
contract differs from the JAX package's, the rule checks the port's:

  ======  ==================================================================
  FL001   file cannot be parsed
  FL101   inline constant rng tag or seed-tuple component (belongs in
          repro_torch.core.rngtags)
  FL102   two constant rng tags share a value (stream collision)
  FL103   one host rng stream built twice: the same seed expression handed
          to ``default_rng`` / ``manual_seed`` twice in one straight-line
          statement list, nothing it reads rebound between
  FL201   kernel ``*_pass`` without a matching ``ref.py`` oracle
  FL202   kernel/oracle signature drift (the wrapper's ``out=`` dropped)
  FL203   kernel pass without the port's dispatch: a device-type arm that
          returns its oracle, a ``traced(...)`` arm that calls ``charge``,
          and no ``try``/``except`` (a fallback) around the launch
  FL204   ``torch.autograd.Function`` without ``forward`` and ``backward``
          as staticmethods
  FL301   registered class missing capability declarations /
          ``register_algorithm`` without ``pseudo_gradient=``
  FL302   ValueError guidance naming a nonexistent config field
  FL401   host read of a device value (``.item()``, ``.tolist()``,
          ``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``bool`` / ``float`` /
          ``int`` of a torch expression) in a traced body
  FL501   registered engine whose round builder lost its sanitize-guarded
          ``check_flat_groups`` probe site
  ======  ==================================================================

FL402 (host numpy in a traced body) and FL403 (a clock read in a traced
body) have no torch form: :mod:`repro_torch.analysis.fedlint.jit_rules`
says why.

CLI::

    python -m repro_torch.analysis.fedlint src/repro_torch  # 1 on findings

Per-line suppression::

    rng = np.random.default_rng((seed, 7))   # fedlint: disable=FL101

API: :func:`run_fedlint` returns the findings programmatically.
"""
from repro_torch.analysis.fedlint.core import (Finding, format_findings,
                                               run_fedlint)

__all__ = ["Finding", "run_fedlint", "format_findings"]
