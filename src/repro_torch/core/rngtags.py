"""The rng tag constants of the JAX package's ``repro/core/rngtags.py``,
as plain ints.

The port draws no device randomness on its main path (the LM loss takes no
rng); the host-side numpy streams use these components so that the data
pipeline gives byte-identical batches to the JAX package's."""
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
assert len(set(TAGS.values())) == len(TAGS), "rng tag collision"
