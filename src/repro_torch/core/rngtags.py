"""The rng tag constants of the JAX package's ``repro/core/rngtags.py``,
as plain ints, and the port's own host-stream tags.

The port draws no device randomness: the host-side numpy streams use
these components, so that the data pipeline gives byte-identical batches
to the JAX package's, and the paper CNN's dropout masks are numpy draws
keyed by ``DROPOUT_SEED`` (:mod:`repro_torch.core.dropout`), where JAX
draws them from its key chain on the device."""
from __future__ import annotations

PARTICIPATION_FOLD = 0x5712A661
FAULT_FOLD = 0x00FA0175
EVAL_FOLD = 10_000
ROUND_OFFSET = 0
META_SAMPLE_SEED = 7_777
SPEED_SEED = 0x5BEED

TAGS = {
    "PARTICIPATION_FOLD": PARTICIPATION_FOLD,
    "FAULT_FOLD": FAULT_FOLD,
    "EVAL_FOLD": EVAL_FOLD,
    "ROUND_OFFSET": ROUND_OFFSET,
    "META_SAMPLE_SEED": META_SAMPLE_SEED,
    "SPEED_SEED": SPEED_SEED,
}

# the port's own host-stream components (JAX has no counterpart: its
# dropout masks come from the client and meta keys)
DROPOUT_SEED = 0xD20B0
PORT_TAGS = {"DROPOUT_SEED": DROPOUT_SEED}

_ALL = {**TAGS, **PORT_TAGS}
assert len(set(_ALL.values())) == len(_ALL), "rng tag collision"
