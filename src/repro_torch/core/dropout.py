"""The dropout keep masks of a round, drawn on the host.

The paper CNN drops a share of each hidden fc layer's units
(:mod:`repro_torch.models.smallnets`).  JAX draws the keep masks inside
the round from its key chain: each client's key (a row of
``split(rng_c, cohort)``) folds in local step i, or ``EVAL_FOLD`` for the
gradient evaluation, the forward splits one subkey per layer, and the
FedMeta step draws from the meta key ``rng_m``.

The port draws them with numpy before the round runs, outside the
``torch.func`` transforms, and hands client k its :class:`ClientMasks` as
the ``rng`` of every ``client_update`` call; the FedMeta step gets the
round's ``meta`` masks.  Step i of the keep-trace forward, of the HVP
sweep and of the through-aggregation backward's re-run index the same
tensor, as JAX's ``fold_in(rng, i)`` gives them the same key.  A host draw
gives the same bits on the card and on the CPU.

A round's masks come from a source with ``masks(...)``:

  * :class:`HostDropout` — numpy draws keyed by (run seed,
    ``DROPOUT_SEED``, round, 0, client slot, step, layer) for the clients
    (step ``EVAL_FOLD`` for the gradient evaluation) and (run seed,
    ``DROPOUT_SEED``, round, 1, layer) for the FedMeta step;
  * :class:`InjectedDropout` — given arrays (the tests inject the masks
    JAX's key chain draws).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.rngtags import DROPOUT_SEED, EVAL_FOLD

Masks = Tuple[torch.Tensor, ...]      # one boolean tensor per masked layer


class ClientMasks(NamedTuple):
    """One client's masks for a round, per masked layer: ``steps``
    (n_steps, step_batch, width), ``evaluation`` (batch, width)."""
    steps: Masks
    evaluation: Masks

    def step(self, i: int) -> Masks:
        """The masks of local step ``i`` (counted over every epoch)."""
        return tuple(s[i] for s in self.steps)


class RoundMasks(NamedTuple):
    """A round's masks, per masked layer: ``steps`` (cohort, n_steps,
    step_batch, width), ``evaluation`` (cohort, batch, width) and ``meta``
    (meta_batch, width), or None without a FedMeta step."""
    steps: Masks
    evaluation: Masks
    meta: Optional[Masks]

    def client(self, k: int) -> ClientMasks:
        return ClientMasks(tuple(s[k] for s in self.steps),
                           tuple(e[k] for e in self.evaluation))

    def clients(self):
        """Every cohort slot's :class:`ClientMasks`, in slot order."""
        return [self.client(k) for k in range(self.steps[0].shape[0])]


def _to_device(arrays, device) -> Optional[Masks]:
    if arrays is None:
        return None
    return tuple(torch.from_numpy(np.array(a, dtype=bool)).to(device)
                 for a in arrays)


class HostDropout(NamedTuple):
    """Round ``round_idx``'s masks of a run seeded ``seed``, drawn with
    numpy: keep where ``uniform < 1 - rate``."""
    seed: int
    round_idx: int

    def masks(self, dropout, *, cohort: int, n_steps: int, step_batch: int,
              eval_batch: int, meta_batch: Optional[int], device
              ) -> RoundMasks:
        keep = 1.0 - dropout.rate

        def draw(key, shape):
            return (np.random.default_rng((self.seed, DROPOUT_SEED,
                                           self.round_idx) + key)
                    .random(shape) < keep)

        steps, evals = [], []
        for l, w in enumerate(dropout.widths):
            steps.append(np.stack([np.stack([
                draw((0, k, i, l), (step_batch, w))
                for i in range(n_steps)]) for k in range(cohort)]))
            evals.append(np.stack([draw((0, k, EVAL_FOLD, l),
                                        (eval_batch, w))
                                   for k in range(cohort)]))
        meta = (None if meta_batch is None else
                [draw((1, l), (meta_batch, w))
                 for l, w in enumerate(dropout.widths)])
        return RoundMasks(_to_device(steps, device),
                          _to_device(evals, device),
                          _to_device(meta, device))


class InjectedDropout(NamedTuple):
    """Given keep masks (arrays of :class:`RoundMasks`' shapes), checked
    against the round's shapes."""
    steps: Sequence[np.ndarray]
    evaluation: Sequence[np.ndarray]
    meta: Optional[Sequence[np.ndarray]] = None

    def masks(self, dropout, *, cohort: int, n_steps: int, step_batch: int,
              eval_batch: int, meta_batch: Optional[int], device
              ) -> RoundMasks:
        ws = dropout.widths
        want = ([(cohort, n_steps, step_batch, w) for w in ws],
                [(cohort, eval_batch, w) for w in ws],
                None if meta_batch is None else [(meta_batch, w)
                                                 for w in ws])
        got = ([np.shape(a) for a in self.steps],
               [np.shape(a) for a in self.evaluation],
               None if meta_batch is None
               else [np.shape(a) for a in (self.meta or ())])
        if got != want:
            raise ValueError(f"injected dropout masks have shapes {got}; "
                             f"the round needs {want}")
        return RoundMasks(_to_device(self.steps, device),
                          _to_device(self.evaluation, device),
                          _to_device(None if meta_batch is None
                                     else self.meta, device))


def round_masks(dropout, source, *, fed, cohort_batch, meta_batch
                ) -> RoundMasks:
    """The masks a round of ``fed`` on these batches needs, from
    ``source`` (a round's ``draws.dropout``)."""
    if source is None:
        raise ValueError(
            "the model draws dropout masks: the round needs its draws "
            "(draws=RoundDraws(dropout=HostDropout(seed, round)), e.g. from "
            "draw_round(..., dropout=True))")
    leaf = next(iter(cohort_batch.values()))
    cohort, b = int(leaf.shape[0]), int(leaf.shape[1])
    meta_b = (int(next(iter(meta_batch.values())).shape[0])
              if fed.meta and meta_batch is not None else None)
    return source.masks(dropout, cohort=cohort,
                        n_steps=fed.local_steps * fed.local_epochs,
                        step_batch=b // fed.local_steps, eval_batch=b,
                        meta_batch=meta_b, device=leaf.device)
