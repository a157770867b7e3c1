"""One seed per purpose of a run, derived from the run's --seed.

A family draws its weights and inputs on streams of its own; the harness
draws the sample of outputs it checks on `STREAM_SAMPLE`.
"""

from __future__ import annotations

STREAM_SAMPLE = 4


def derive_seed(seed: int, stream: int) -> int:
    """One 63-bit seed per purpose (weights, style, frames, ...) of a run."""
    return (int(seed) * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)
