"""Distribution schemes for sparse Tucker decomposition (paper §5–6).

The port's version of the reference's host-side ``core/distribution.py``
(host numpy): it computes the reference's arrays by counting over bounded
keys (``core/tally.py``) where the reference sorts, and
``tests/test_torch_plan.py`` holds them bitwise equal to the reference's.

A *policy* along mode n is a mapping ``pi_n: elements -> [0, P)`` represented as
an int32 array of shape (nnz,). A *scheme* is a sequence of N policies (multi-
policy) or one policy reused across modes (uni-policy).

Schemes implemented:

  * ``lite``     — the paper's contribution (Fig 8). Multi-policy. Provably
                   E_max <= ceil(|E|/P), R_sum <= L + P, R_max <= ceil(L/P)+2.
  * ``coarse``   — CoarseG: whole slices per rank. Multi-policy. Strategies:
                   LPT best-processor-fit (default) or randomized contiguous
                   blocks (Smith-Karypis style).
  * ``medium``   — MediumG: medium-grained processor grid (Smith-Karypis).
                   Uni-policy.
  * ``hypergraph`` — HyperG stand-in: streaming greedy hypergraph partitioner
                   (elements = vertices, slices along all modes = hyperedges;
                   objective = balanced connectivity-1 min cut). Uni-policy.
  * ``random``   — uniform random elements. Uni-policy (sanity baseline).
  * ``auto``     — real-time selector: builds the cheap candidates (lite,
                   coarse, medium), scores them with the analytic cost model
                   in ``repro_torch.core.plan``, and returns the
                   predicted-fastest one.

The scheme constructors work on the host, except the per-element passes of
``lite`` and ``coarse`` (slice sizes, the element gathers, Lite's stage-2
ordering and cut), which run on the plan's device (``core/tally.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Sequence

import numpy as np
import torch

from . import tally
from .coo import SparseTensor

__all__ = [
    "Scheme",
    "lite_policy",
    "coarse_policy",
    "medium_policies",
    "hypergraph_policy",
    "random_policy",
    "build_scheme",
    "row_owner_map",
    "SCHEMES",
]


@dataclasses.dataclass(frozen=True)
class Scheme:
    """A distribution scheme: one policy per mode."""

    name: str
    policies: tuple[np.ndarray, ...]  # each (nnz,) int32, one per mode
    uni: bool  # True if every mode uses the same policy (single tensor copy)
    P: int

    def policy(self, mode: int) -> np.ndarray:
        return self.policies[mode]

    @property
    def nmodes(self) -> int:
        return len(self.policies)

    def tensor_copies(self) -> int:
        """Copies of the input tensor stored (memory model, paper §7.3)."""
        return 1 if self.uni else self.nmodes

    def content_key(self) -> str:
        """Content hash of (name, P, uni, policy bytes), memoized.

        Used as the plan-cache key for prebuilt schemes: keying on ``id()``
        would let CPython reuse a garbage-collected scheme's id and hand a
        *different* scheme the old cached plan. Two schemes with equal
        content hash equal — that is exactly when their plans coincide.
        """
        cached = getattr(self, "_content_key", None)
        if cached is None:
            h = hashlib.sha1()
            h.update(f"{self.name}|{self.P}|{self.uni}|".encode())
            for pol in self.policies:
                arr = np.ascontiguousarray(pol)
                h.update(str(arr.shape).encode())
                h.update(str(arr.dtype).encode())
                h.update(arr.tobytes())
            cached = h.hexdigest()
            object.__setattr__(self, "_content_key", cached)  # frozen dc
        return cached


# =========================================================================
# Lite (paper Fig 8) — the contribution
# =========================================================================
def lite_policy(t: SparseTensor, mode: int, P: int) -> np.ndarray:
    """Lite distribution along ``mode`` (paper Fig 8), vectorized.

    Stage 1: slices sorted by cardinality ascending, assigned whole to ranks
    round-robin while the hard limit ceil(|E|/P) is respected.
    Stage 2: remaining (large) slices split across *contiguous* ranks, filling
    each rank exactly to the limit.
    """
    nnz = t.nnz
    if nnz == 0:
        return np.zeros(0, dtype=np.int32)
    L = t.shape[mode]
    limit = -(-nnz // P)  # ceil

    with tally.scope(t):
        sizes = tally.slice_sizes(t, mode)  # (L,)
        order, sorted_sizes = tally.stable_order(sizes, nnz + 1)  # ascending

        # ---- stage 1: find the exit iteration t_hat (0-based over sorted
        # slices). Slice at sorted position j goes to rank j % P; violation
        # when the rank's running load + size > limit. Compute per-residue-
        # class prefix loads.
        loads_before = np.zeros(L, dtype=np.int64)
        for r in range(min(P, L)):
            cs = np.cumsum(sorted_sizes[r::P])  # positions r, r + P, ...
            loads_before[r + P :: P] = cs[:-1]
        violation = loads_before + sorted_sizes > limit
        viol_idx = np.flatnonzero(violation)
        t_hat = int(viol_idx[0]) if viol_idx.size else L  # first violating

        # per slice: its rank if stage 1 placed it (sorted position j <
        # t_hat goes to rank j % P), else -1 - its order among the stage-2
        # slices (sorted positions t_hat..L-1)
        table = np.empty(L, dtype=np.int32)
        for r in range(P):
            table[order[r:t_hat:P]] = r
        table[order[t_hat:]] = -1 - np.arange(L - t_hat, dtype=np.int32)
        # rank loads at end of stage 1: rank r took sorted positions r, r+P
        stage1_loads = np.array([sorted_sizes[r:t_hat:P].sum()
                                 for r in range(P)], dtype=np.int64)

        # ---- element-level assignment, on the device (stage-2 elements
        # hold their slice's negative entry until below)
        owners = tally.upload(t, table, torch.int32).index_select(
            0, tally.device_coords(t)[:, mode])
        n_stage2 = nnz - int(stage1_loads.sum())
        if n_stage2:
            # Stage-2 elements, ordered by (sorted slice rank, element
            # order): concatenated stream cut into segments by remaining
            # rank gaps in rank order 0..P-1. Elements of each large slice
            # land on contiguous ranks.
            e_idx = torch.nonzero(owners < 0).flatten()
            key = owners.index_select(0, e_idx).neg_()  # 1 + stage-2 order
            stream = e_idx.index_select(0, torch.sort(key, stable=True)[1])
            del e_idx, key
            gaps = limit - stage1_loads  # (P,) >= 0
            cum = tally.upload(t, np.cumsum(gaps), torch.int64)
            # position i in stream -> first rank whose cumulative gap
            # exceeds i
            pos = torch.arange(n_stage2, device=owners.device)
            owners.index_copy_(0, stream, torch.searchsorted(
                cum, pos, right=True).to(torch.int32))
        return tally.keep_policy(t, owners)


# =========================================================================
# CoarseG — whole slices per rank
# =========================================================================
def coarse_policy(
    t: SparseTensor,
    mode: int,
    P: int,
    strategy: str = "lpt",
    seed: int = 0,
) -> np.ndarray:
    """Coarse-grained policy: every slice assigned in its entirety.

    strategy='lpt':   best-processor-fit on slices sorted descending (classic
                      LPT, 4/3-approx for makespan) — the strongest coarse
                      heuristic discussed in the paper.
    strategy='block': random slice order, contiguous blocks with balanced
                      element counts (Smith & Karypis [25] style).
    """
    L = t.shape[mode]
    sizes = tally.slice_sizes(t, mode)
    owner_of_slice = np.empty(L, dtype=np.int64)
    if strategy == "lpt":
        order = np.argsort(-sizes, kind="stable")
        loads = np.zeros(P, dtype=np.int64)
        # LPT via heap-free argmin (P small); vectorizing is not worth it here
        import heapq

        heap = [(0, p) for p in range(P)]
        heapq.heapify(heap)
        for sl in order:
            load, p = heapq.heappop(heap)
            owner_of_slice[sl] = p
            heapq.heappush(heap, (load + int(sizes[sl]), p))
    elif strategy == "block":
        rng = np.random.default_rng(seed + mode)
        order = rng.permutation(L)
        csum = np.cumsum(sizes[order])
        total = int(csum[-1]) if L else 0
        # cut points at total*p/P
        targets = (np.arange(1, P) * total) // P
        cuts = np.searchsorted(csum, targets, side="left")
        block_id = np.zeros(L, dtype=np.int64)
        block_id[cuts] += 1  # may repeat; cumsum caps below
        block_id = np.minimum(np.cumsum(block_id), P - 1)
        owner_of_slice[order] = block_id
    else:
        raise ValueError(f"unknown coarse strategy {strategy!r}")
    with tally.scope(t):
        table = tally.upload(t, owner_of_slice, torch.int32)
        return tally.keep_policy(
            t, table.index_select(0, tally.device_coords(t)[:, mode]))


# =========================================================================
# MediumG — processor grid (uni-policy)
# =========================================================================
def _factor_grid(P: int, lengths: Sequence[int]) -> list[int]:
    """Factorize P into q_1 x ... x q_N with q_n roughly proportional to L_n."""
    # prime factorization of P
    primes = []
    x = P
    d = 2
    while d * d <= x:
        while x % d == 0:
            primes.append(d)
            x //= d
        d += 1
    if x > 1:
        primes.append(x)
    primes.sort(reverse=True)
    q = [1] * len(lengths)
    for f in primes:
        # give factor to the mode with largest remaining length ratio L_n / q_n
        ratios = [lengths[n] / q[n] for n in range(len(lengths))]
        n = int(np.argmax(ratios))
        q[n] *= f
    return q


def medium_policies(
    t: SparseTensor, P: int, seed: int = 0
) -> tuple[np.ndarray, list[int]]:
    """MediumG: overlay a q_1 x ... x q_N processor grid; random index perms."""
    rng = np.random.default_rng(seed)
    q = _factor_grid(P, t.shape)
    owner = np.zeros(t.nnz, dtype=np.int64)
    stride = 1
    for n in reversed(range(t.ndim)):
        L = t.shape[n]
        perm = rng.permutation(L)
        permuted = perm[t.coords[:, n]]
        # block index along mode n in [0, q_n)
        block = (permuted.astype(np.int64) * q[n]) // L
        owner += block * stride
        stride *= q[n]
    return owner.astype(np.int32), q


# =========================================================================
# HyperG stand-in — streaming greedy hypergraph partitioner (uni-policy)
# =========================================================================
def hypergraph_policy(
    t: SparseTensor,
    P: int,
    seed: int = 0,
    imbalance: float = 0.05,
) -> np.ndarray:
    """Greedy streaming hypergraph partitioning.

    Vertices = elements; hyperedges = slices along all modes. For each element
    (random order) choose the part that minimizes new slice-part connections
    (connectivity-1 metric), subject to a hard balance cap. Candidates are the
    parts already touching one of the element's N slices, plus the least
    loaded part.

    This is the in-repo stand-in for Zoltan; it shares the objective but is
    far cheaper. Like the paper's HyperG, it is meant for
    medium tensors only.
    """
    rng = np.random.default_rng(seed)
    nnz = t.nnz
    if nnz == 0:
        return np.zeros(0, dtype=np.int32)
    cap = int(math.ceil(nnz / P * (1.0 + imbalance)))
    # slice key per (mode, coord): offset coords per mode into one id space
    offsets = np.concatenate([[0], np.cumsum(t.shape)])[: t.ndim]
    slice_ids = t.coords + offsets[None, :]  # (nnz, N) global slice ids

    part_of: list[dict[int, int]] = [dict() for _ in range(int(offsets[-1] + t.shape[-1]))]
    # part_of[slice_id] : dict part -> count of that slice's elements in part
    loads = np.zeros(P, dtype=np.int64)
    owners = np.empty(nnz, dtype=np.int32)
    order = rng.permutation(nnz)
    for e in order:
        sids = slice_ids[e]
        cand: set[int] = set()
        for s in sids:
            cand.update(part_of[s].keys())
        cand.add(int(np.argmin(loads)))
        best_p, best_score = -1, None
        for p in cand:
            if loads[p] >= cap:
                continue
            # connections created = slices of e not yet touching p
            new_conn = sum(1 for s in sids if p not in part_of[s])
            score = (new_conn, loads[p])
            if best_score is None or score < best_score:
                best_score, best_p = score, p
        if best_p < 0:  # everything at cap (shouldn't happen with slack)
            best_p = int(np.argmin(loads))
        owners[e] = best_p
        loads[best_p] += 1
        for s in sids:
            d = part_of[s]
            d[best_p] = d.get(best_p, 0) + 1
    return owners


def random_policy(t: SparseTensor, P: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=t.nnz, dtype=np.int32)


# =========================================================================
# Scheme factory
# =========================================================================
def build_scheme(
    t: SparseTensor,
    name: str,
    P: int,
    seed: int = 0,
    **kw,
) -> Scheme:
    name = name.lower()
    if name == "auto":
        # Real-time selection (paper's headline loop): delegate to the plan
        # layer, which builds the cheap candidates, scores them with the
        # analytic cost model, and caches the result. Lazy import: plan.py
        # imports this module.
        from .plan import plan as _plan

        return _plan(t, "auto", P, seed=seed, **kw).scheme
    if name == "lite":
        with tally.scope(t):  # one upload for every mode
            pols = tuple(lite_policy(t, n, P) for n in range(t.ndim))
        return Scheme("lite", pols, uni=False, P=P)
    if name in ("coarse", "coarseg"):
        with tally.scope(t):
            pols = tuple(
                coarse_policy(t, n, P, strategy=kw.get("strategy", "lpt"),
                              seed=seed)
                for n in range(t.ndim)
            )
        return Scheme("coarse", pols, uni=False, P=P)
    if name in ("medium", "mediumg"):
        pol, _ = medium_policies(t, P, seed=seed)
        return Scheme("medium", tuple(pol for _ in range(t.ndim)), uni=True, P=P)
    if name in ("hypergraph", "hyperg"):
        pol = hypergraph_policy(t, P, seed=seed, imbalance=kw.get("imbalance", 0.05))
        return Scheme("hypergraph", tuple(pol for _ in range(t.ndim)), uni=True, P=P)
    if name == "random":
        pol = random_policy(t, P, seed=seed)
        return Scheme("random", tuple(pol for _ in range(t.ndim)), uni=True, P=P)
    raise ValueError(f"unknown scheme {name!r}")


SCHEMES = ("lite", "coarse", "medium", "hypergraph", "random")


# =========================================================================
# Row-index mapping sigma_n (paper §3, §5 "Row-Index Mapping")
# =========================================================================
def row_owner_map(t: SparseTensor, policy: np.ndarray, mode: int, P: int) -> np.ndarray:
    """sigma_n: row index -> owning rank.

    The owner of row l is chosen among the ranks sharing Slice_n^l — we pick
    the rank holding the most elements of the slice (minimizes the data that
    rank must receive), breaking ties toward the highest rank. Empty slices
    get round-robin owners (their factor rows are zero but still live
    somewhere). Read from the (slice, rank) counts (``tally``); a copy,
    since callers such as ``MetricsExtender`` update the map in place.
    """
    return tally.row_owner(t, policy, mode, P).copy()
