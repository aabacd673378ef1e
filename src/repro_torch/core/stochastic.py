"""Keyed-hash sampling and the stochastic-refine rung's host side.

The port's own copy of ``src/repro/core/stochastic.py``. The refresh
ladder's ``stochastic-refine`` rung updates carried factors from a *sample*
of a streamed append's elements instead of a full sweep; this module owns
what must be bitwise deterministic about it: which elements enter a
minibatch (``sample_batch``), the step-size schedule (``step_eta``) and the
factor blend (``blend_factor``). The completion objective's holdout mask
draws from the same keyed hash (``splitmix64``, ``sample_unit``).

Every selection is a pure function of ``(absolute element index, seed)``
through a splitmix64-style hash, in numpy and unchanged from the reference,
so the port's masks and minibatches are bit-identical to the reference's.
Consumers draw from domain-separated key streams (an additive constant
mixed into the hash input); the holdout stream is domain 0.
``blend_factor``'s small SVD and QR run on the host (LAPACK), as the port's
other small factorizations do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["HOLDOUT_DOMAIN", "SAMPLE_DOMAIN", "RESERVOIR_DOMAIN",
           "splitmix64", "sample_unit", "sample_batch", "next_pow2",
           "SampledBatch", "step_eta", "blend_factor"]

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


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """One deterministic minibatch: replay reservoir + sampled new entries.

    ``indices`` are absolute element indices into the source view (replay
    entries first, then the sampled new-batch entries, each group in
    ascending order). ``coords``/``values`` are the gathered elements,
    zero-padded to ``padded_nnz`` (the next power of two): padding rows
    carry coordinate 0 and value 0.0, which add nothing to a Z-build.
    """

    indices: np.ndarray  # (S,) int64 absolute indices, replay then new
    coords: np.ndarray  # (padded_nnz, N) int64
    values: np.ndarray  # (padded_nnz,) float64
    sample_nnz: int  # sampled new-batch entries
    replay_nnz: int  # replay-reservoir entries
    padded_nnz: int


def next_pow2(n: int) -> int:
    """Smallest power of two >= n: the pad granularity of every shape that
    keys a cached stochastic-path step."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def sample_batch(coords: np.ndarray, values: np.ndarray, covered: int,
                 fraction: float, seed: int,
                 replay_nnz: int = 1024) -> SampledBatch:
    """The stochastic-refine minibatch for one streamed append.

    ``covered`` leading elements are already in the factors; the new batch
    is everything after them. Element ``i >= covered`` enters iff
    ``sample_unit(i, seed, SAMPLE_DOMAIN) < fraction``, so later appends
    never change earlier choices. The replay reservoir draws ``min(
    replay_nnz, covered)`` indices of the prefix,
    ``splitmix64(j, seed, RESERVOIR_DOMAIN) % covered`` for a draw counter
    ``j``. ``fraction >= 1`` takes the whole new batch.
    """
    coords = np.asarray(coords)
    values = np.asarray(values)
    nnz = int(coords.shape[0])
    covered = min(max(int(covered), 0), nnz)
    if not 0.0 < float(fraction) <= 1.0:
        raise ValueError(
            f"sample fraction must be in (0, 1], got {fraction}")

    new_idx = np.arange(covered, nnz, dtype=np.int64)
    if float(fraction) < 1.0 and len(new_idx):
        keep = sample_unit(new_idx, seed, SAMPLE_DOMAIN) < float(fraction)
        new_idx = new_idx[keep]

    n_replay = min(max(int(replay_nnz), 0), covered)
    if n_replay:
        draws = splitmix64(np.arange(n_replay, dtype=np.uint64), seed,
                           RESERVOIR_DOMAIN)
        replay_idx = np.sort((draws % np.uint64(covered)).astype(np.int64))
    else:
        replay_idx = np.zeros(0, dtype=np.int64)

    indices = np.concatenate([replay_idx, new_idx])
    padded = next_pow2(max(len(indices), 1))
    pc = np.zeros((padded, coords.shape[1]), dtype=np.int64)
    pv = np.zeros(padded, dtype=np.float64)
    pc[: len(indices)] = coords[indices]
    pv[: len(indices)] = values[indices]
    return SampledBatch(indices=indices, coords=pc, values=pv,
                        sample_nnz=int(len(new_idx)),
                        replay_nnz=int(n_replay), padded_nnz=int(padded))


def step_eta(base: float, decay: float, step_index: int) -> float:
    """Per-refine step size ``base / (1 + decay * t)``; ``step_index``
    counts refines since the last full sweep."""
    return float(base) / (1.0 + float(decay) * max(int(step_index), 0))


def blend_factor(F_old: torch.Tensor, F_hat: torch.Tensor,
                 eta: float) -> torch.Tensor:
    """Blend the minibatch oracle's basis into the carried factor.

    ``F_hat`` is first aligned to ``F_old`` by the orthogonal Procrustes
    rotation (``R = U Vᵀ`` from the K×K SVD of ``F_hatᵀ F_old``), then the
    step is re-orthonormalized::

        Q, _ = qr((1 - eta) · F_old + eta · F_hat R)

    with the QR's column signs fixed to a nonnegative ``diag(R)``, so the
    blend is continuous in ``eta``. Returns an orthonormal (L, K) factor on
    ``F_old``'s device. The products, the SVD and the QR run on the host
    (LAPACK): the matrices are a factor wide.
    """
    dev = F_old.device
    Fo = F_old.detach().cpu().to(torch.float32)
    Fh = F_hat.detach().cpu().to(torch.float32)
    u, _, vt = torch.linalg.svd(Fh.T @ Fo, full_matrices=False)
    aligned = Fh @ (u @ vt)
    mix = (1.0 - float(eta)) * Fo + float(eta) * aligned
    q, r = torch.linalg.qr(mix)
    signs = torch.sign(torch.diagonal(r))
    q = q * torch.where(signs == 0, 1.0, signs)[None, :]
    return q.to(dev)
