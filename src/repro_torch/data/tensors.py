"""Synthetic sparse tensor generators mirroring the paper's FROSTT benchmark.

The port's own copy of the reference's numpy generator
(``src/repro/data/tensors.py``): the same seed gives a bitwise-identical
tensor in both packages, which is what lets the parity tests and the
on-card run use the reference's recipes unchanged.

  * mode coordinates drawn from Zipf-like distributions with per-mode exponent,
  * optional "hub" slices that concentrate a fixed fraction of elements
    (models enron's 5M-element slices out of 54M),
  * deduplicated coordinates, reproducible by seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.coo import SparseTensor

__all__ = ["synth_tensor", "SuiteSpec", "SUITE_SPECS", "paper_suite"]


def _zipf_coords(rng, L: int, n: int, alpha: float) -> np.ndarray:
    """n samples in [0, L) with a Zipf(alpha)-shaped marginal (alpha=0: uniform)."""
    if alpha <= 0:
        return rng.integers(0, L, size=n)
    # inverse-CDF sampling over ranks 1..L with p(r) ~ r^-alpha; permuted so the
    # popular slices are in random positions (as in real data).
    ranks = np.arange(1, L + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    u = rng.random(n)
    idx = np.searchsorted(cdf, u, side="left")
    perm = rng.permutation(L)
    return perm[np.minimum(idx, L - 1)]


def synth_tensor(
    shape: tuple[int, ...],
    nnz: int,
    alphas: tuple[float, ...] | float = 1.0,
    hub_fraction: float = 0.0,
    hub_modes: tuple[int, ...] = (),
    seed: int = 0,
) -> SparseTensor:
    """Generate a random sparse tensor with skewed slices.

    hub_fraction: this fraction of elements is forced into a single random
    slice along each mode in hub_modes (creates the pathological large slices
    the paper discusses for CoarseG).
    """
    rng = np.random.default_rng(seed)
    N = len(shape)
    if isinstance(alphas, (int, float)):
        alphas = tuple(float(alphas) for _ in range(N))
    cols = [_zipf_coords(rng, shape[n], nnz, alphas[n]) for n in range(N)]
    coords = np.stack(cols, axis=1).astype(np.int64)
    if hub_fraction > 0 and hub_modes:
        k = int(nnz * hub_fraction)
        pick = rng.choice(nnz, size=k, replace=False)
        for m in hub_modes:
            coords[pick, m] = rng.integers(0, shape[m])
    values = rng.standard_normal(nnz)
    t = SparseTensor(coords, values, shape)
    return t.dedup()


@dataclasses.dataclass(frozen=True)
class SuiteSpec:
    name: str
    shape: tuple[int, ...]
    nnz: int
    alphas: tuple[float, ...]
    hub_fraction: float = 0.0
    hub_modes: tuple[int, ...] = ()
    mirror_of: str = ""  # which FROSTT tensor this is scaled from


# Scaled-down mirrors of the paper's Fig 9 suite (same mode-count and skew
# character; ~1e4–2e5 nnz so full HOOI benchmarks run on one CPU in seconds).
SUITE_SPECS: tuple[SuiteSpec, ...] = (
    SuiteSpec("delicious-s", (530, 17000, 2400, 140), 140_000, (1.1, 1.3, 1.2, 0.9),
              mirror_of="delicious"),
    SuiteSpec("enron-s", (600, 500, 2400, 100), 54_000, (1.4, 1.4, 1.1, 0.8),
              hub_fraction=0.09, hub_modes=(0,), mirror_of="enron"),
    SuiteSpec("flickr-s", (320, 28000, 1600, 73), 112_000, (1.2, 1.4, 1.2, 0.7),
              mirror_of="flickr"),
    SuiteSpec("nell1-s", (2900, 2100, 25000), 143_000, (1.2, 1.2, 1.4),
              mirror_of="nell1"),
    SuiteSpec("nell2-s", (1200, 900, 2800), 77_000, (0.9, 0.9, 1.0),
              mirror_of="nell2"),
    # "big" mirrors: denser, very large hub slices (amazon/patents/reddit)
    SuiteSpec("amazon-s", (4800, 1700, 1800), 170_000, (1.0, 1.1, 1.1),
              hub_fraction=0.05, hub_modes=(0,), mirror_of="amazon"),
    SuiteSpec("patents-s", (46, 2390, 239), 200_000, (0.4, 1.0, 0.5),
              mirror_of="patents"),
    SuiteSpec("reddit-s", (8200, 1760, 8100), 230_000, (1.3, 0.9, 1.3),
              hub_fraction=0.04, hub_modes=(1,), mirror_of="reddit"),
)


def paper_suite(scale: float = 1.0, seed: int = 0) -> dict[str, SparseTensor]:
    """Instantiate the synthetic suite; ``scale`` multiplies nnz."""
    out = {}
    for i, s in enumerate(SUITE_SPECS):
        out[s.name] = synth_tensor(
            s.shape,
            max(1000, int(s.nnz * scale)),
            s.alphas,
            hub_fraction=s.hub_fraction,
            hub_modes=s.hub_modes,
            seed=seed + i,
        )
    return out
