"""Keyed-hash sampling: the deterministic per-element draws.

The port's own copy of the part of ``src/repro/core/stochastic.py`` that the
completion objective's holdout mask needs: ``splitmix64``, ``sample_unit``
and the domain constants, in numpy and unchanged, so the port's holdout
masks are bit-identical to the reference's. The stochastic-refine rung
(``sample_batch``, ``blend_factor`` and the rest) is ROADMAP Queue A item 11.

Every selection is a pure function of ``(absolute element index, seed)``
through a splitmix64-style hash. Consumers draw from domain-separated key
streams (an additive constant mixed into the hash input); the holdout
stream is domain 0.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HOLDOUT_DOMAIN", "SAMPLE_DOMAIN", "RESERVOIR_DOMAIN",
           "splitmix64", "sample_unit"]

# additive 64-bit offsets mixed into the hash input so each consumer draws
# an independent key stream from the same (index, seed) pair; the holdout
# stream is 0, the others arbitrary odd constants distinct from it
HOLDOUT_DOMAIN = 0
SAMPLE_DOMAIN = 0xA5A5F00D5EEDC0DE
RESERVOIR_DOMAIN = 0x3C6EF372FE94F82B

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SEED_MIX = np.uint64(0xD1B54A32D192ED03)


def splitmix64(idx, seed: int, domain: int = 0) -> np.ndarray:
    """Vectorized splitmix64 finalizer over ``idx * GOLDEN + seed * MIX +
    domain``: the keyed hash behind every deterministic per-element
    decision."""
    with np.errstate(over="ignore"):
        z = (np.asarray(idx, dtype=np.uint64) * _GOLDEN
             + np.uint64(int(seed) % (1 << 64)) * _SEED_MIX
             + np.uint64(int(domain) % (1 << 64)))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def sample_unit(idx, seed: int, domain: int = 0) -> np.ndarray:
    """Uniform [0, 1) variates from the keyed hash (53-bit mantissa)."""
    z = splitmix64(idx, seed, domain)
    return (z >> np.uint64(11)).astype(np.float64) / float(1 << 53)
