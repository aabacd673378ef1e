"""Performance metrics for distribution schemes (paper §4).

Per mode n, for a policy pi_n:

  Metric 1  E_max = max_p |E_n^p|                  (TTM load balance)
  Metric 2  R_sum = sum_p R_n^p                    (SVD load + oracle comm)
  Metric 3  R_max = max_p R_n^p                    (SVD load balance)

plus the derived quantities used in the paper's experimental section:
normalized SVD redundancy, oracle communication volume Q_n*(R_sum - L_n),
factor-matrix transfer volume (uni- and multi-policy), FLOP counts and the
memory model of §7.3.

The port's version of the reference's ``core/metrics.py``: it computes the
reference's metrics by counting (slice, rank) pairs over their bounded range
where the reference sorts them, the counts and the factor-matrix volume's
presence marks on the plan's device (``core/tally.py``), and
``tests/test_torch_plan.py`` holds them equal to the reference's. With the
streaming ``MetricsExtender``, which keeps the metrics of a repartitioned
stream up to date in O(batch).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import tally
from .coo import SparseTensor
from .distribution import Scheme, row_owner_map

__all__ = ["ModeMetrics", "SchemeMetrics", "mode_metrics", "scheme_metrics",
           "MetricsExtender"]


@dataclasses.dataclass(frozen=True)
class ModeMetrics:
    mode: int
    P: int
    nnz: int
    L: int  # mode length
    L_nonempty: int  # non-empty slices (empty slices have no sharers)
    E_max: int
    E_avg: float
    R_sum: int
    R_max: int
    R_avg: float

    # ------- derived (paper §4.2, §7.2) -------
    @property
    def ttm_imbalance(self) -> float:
        """max/avg element load; 1.0 is perfect (paper Fig 12a)."""
        return self.E_max / max(self.E_avg, 1e-12)

    @property
    def svd_redundancy(self) -> float:
        """R_sum normalized by optimal L_nonempty; 1.0 is optimal (Fig 12b)."""
        return self.R_sum / max(self.L_nonempty, 1)

    @property
    def svd_imbalance(self) -> float:
        """max/avg local penultimate rows; 1.0 is perfect (Fig 12c)."""
        return self.R_max / max(self.R_avg, 1e-12)

    def oracle_comm_per_query(self) -> int:
        """Units (scalars) moved per Lanczos matrix-vector product (§4.2)."""
        return self.R_sum - self.L_nonempty


@dataclasses.dataclass(frozen=True)
class SchemeMetrics:
    scheme: str
    P: int
    per_mode: tuple[ModeMetrics, ...]
    core_dims: tuple[int, ...]
    fm_volume: int  # factor-matrix transfer units, all modes (§4.2)
    svd_volume: int  # oracle comm units, all modes, all queries

    # FLOP model (§4.3): TTM = nnz * prod_{j != n} K_j mults (+adds) per mode;
    # SVD oracle = Q_n * K_hat_n * R_sum per mode (x2 for the two products).
    ttm_flops: int
    svd_flops: int
    ttm_flops_max: int  # on the bottleneck rank (determines wall time)
    svd_flops_max: int

    @property
    def total_flops(self) -> int:
        return self.ttm_flops + self.svd_flops

    @property
    def critical_path_flops(self) -> int:
        return self.ttm_flops_max + self.svd_flops_max

    def memory_bytes_per_rank(self, value_bytes: int = 8, coord_bytes: int = 8) -> dict:
        """Paper §7.3 memory model: tensor copies + penultimate + factors."""
        mm = self.per_mode
        N = len(mm)
        copies = 1 if self.scheme in ("medium", "hypergraph", "random") else N
        elem_bytes = value_bytes + coord_bytes * N
        tensor = copies * max(m.E_max for m in mm) * elem_bytes
        khat = [int(np.prod([self.core_dims[j] for j in range(N) if j != n]))
                for n in range(N)]
        penult = sum(mm[n].R_max * khat[n] * value_bytes for n in range(N))
        factors = sum(mm[n].L * self.core_dims[n] * value_bytes for n in range(N))
        return {
            "tensor": int(tensor),
            "penultimate": int(penult),
            "factors": int(factors),
            "total": int(tensor + penult + factors),
        }


def _r_per_rank(t: SparseTensor, policy: np.ndarray, mode: int, P: int) -> np.ndarray:
    """R_n^p for all p: number of distinct slices each rank shares."""
    return np.array([np.count_nonzero(c)
                     for c in tally.pair_counts(t, policy, mode, P)],
                    dtype=np.int64)


def mode_metrics(t: SparseTensor, policy: np.ndarray, mode: int, P: int) -> ModeMetrics:
    with tally.scope(t):  # one pair count for both
        counts = tally.pair_counts(t, policy, mode, P).sum(axis=1,
                                                           dtype=np.int64)
        r = _r_per_rank(t, policy, mode, P)
        L_ne = int((tally.slice_sizes(t, mode) > 0).sum())
    return ModeMetrics(
        mode=mode,
        P=P,
        nnz=t.nnz,
        L=t.shape[mode],
        L_nonempty=L_ne,
        E_max=int(counts.max()) if len(counts) else 0,
        E_avg=t.nnz / P,
        R_sum=int(r.sum()),
        R_max=int(r.max()) if len(r) else 0,
        R_avg=float(r.sum()) / P,
    )


def _fm_volume(t: SparseTensor, scheme: Scheme, core: Sequence[int]) -> int:
    """Factor-matrix transfer volume (paper §4.2).

    Row F_n[l,:] must reach every rank that owns an element of Slice_n^l under
    any policy pi_j, j != n (for uni-policy this reduces to sharers of the
    slice). The producing owner sigma_n(l) is one of the sharers under pi_n;
    we charge (|need(l)| - 1) rows of K_n entries, clamped at >= 0, using the
    best case that the owner is itself a needer.
    """
    total = 0
    N = t.ndim
    P = scheme.P
    with tally.scope(t):
        c = tally.device_coords(t)
        for n in range(N):
            L = t.shape[n]
            kdt = tally.key_dtype(P * L)
            # need[p, l]: rank p holds an element of slice l under some pi_j
            need = torch.zeros(P * L, dtype=torch.bool, device=c.device)
            done: set[int] = set()
            for j in range(N):
                pol = scheme.policy(j)
                if j == n or id(pol) in done:
                    continue
                done.add(id(pol))
                key = tally.device_policy(t, pol).to(kdt, copy=True)
                key.mul_(L).add_(c[:, n])
                need |= torch.bincount(key, minlength=P * L) > 0
                del key
            need = tally.to_host(t, need).reshape(P, L)
            # subtract one per slice for the producing owner if it is a
            # needer
            sigma = tally.row_owner(t, scheme.policy(n), n, P)
            owner_hit = sum(np.count_nonzero(need[p] & (sigma == p))
                            for p in range(P))
            rows_to_send = np.count_nonzero(need) - owner_hit
            total += rows_to_send * int(core[n])
    return total


def scheme_metrics(
    t: SparseTensor,
    scheme: Scheme,
    core: Sequence[int],
    lanczos_queries: Sequence[int] | None = None,
) -> SchemeMetrics:
    """Aggregate §4 metrics for a scheme over all modes.

    ``lanczos_queries``: Q_n per mode; defaults to 4*K_n (2K_n Lanczos
    iterations, two oracle products each — paper §4.3 / SLEPc convention).
    """
    N = t.ndim
    core = tuple(int(k) for k in core)
    if lanczos_queries is None:
        lanczos_queries = [4 * core[n] for n in range(N)]
    with tally.scope(t):  # the owner maps of the modes, for _fm_volume
        per_mode = tuple(
            mode_metrics(t, scheme.policy(n), n, scheme.P) for n in range(N)
        )
        fm_vol = _fm_volume(t, scheme, core)
    khat = [int(np.prod([core[j] for j in range(N) if j != n])) for n in range(N)]

    # FLOPs (multiply-accumulate counted as 2 flops)
    ttm = 0
    ttm_max = 0
    svd = 0
    svd_max = 0
    for n in range(N):
        m = per_mode[n]
        # Kronecker contribution of one element: khat[n] mults (+ adds into row)
        ttm += 2 * t.nnz * khat[n]
        ttm_max += 2 * m.E_max * khat[n]
        q = int(lanczos_queries[n])
        svd += q * m.R_sum * khat[n] * 2
        svd_max += q * m.R_max * khat[n] * 2
    svd_vol = sum(
        int(lanczos_queries[n]) * per_mode[n].oracle_comm_per_query()
        for n in range(N)
    )
    return SchemeMetrics(
        scheme=scheme.name,
        P=scheme.P,
        per_mode=per_mode,
        core_dims=core,
        fm_volume=int(fm_vol),
        svd_volume=int(svd_vol),
        ttm_flops=int(ttm),
        svd_flops=int(svd),
        ttm_flops_max=int(ttm_max),
        svd_flops_max=int(svd_max),
    )


class MetricsExtender:
    """Incrementally maintained ``SchemeMetrics`` under streaming appends.

    A full ``scheme_metrics`` recompute is O(nnz * N^2) host work — paid on
    every batch, it would defeat the streaming scheduler's "repartition is
    O(batch)" contract. This class pays that cost *once* (at plan adoption)
    to build per-mode incremental state, then ``extend`` folds a batch of
    appended elements in O(batch * N^2) and returns metrics **identical** to
    a from-scratch recompute on the extended scheme (same tie-breaks, same
    integer arithmetic — asserted by the equivalence test).

    Per-mode state and how each §4 quantity extends:

      * element counts per rank  -> E_max   (bincount of the new policy tail)
      * (slice, rank) pair counts -> R_sum/R_max (a pair new to the dict
        means that rank shares one more distinct slice)
      * per-slice nnz            -> L_nonempty (0 -> positive transitions)
      * live ``row_owner_map`` argmax: the owner of slice l is the rank with
        the lexicographically greatest (count, rank) among sharers — counts
        only grow, so the argmax can only move to a pair the batch touched
      * fm need-set (slice*P + rank pairs over policies j != n) plus a
        per-slice "owner is a needer" flag -> fm_volume; only slices touched
        by the batch can change their flag, so the update stays O(batch).

    Duplicate coordinates count as distinct elements, exactly as
    ``scheme_metrics`` counts them (streaming value-updates append dups).
    """

    def __init__(self, t: SparseTensor, scheme: Scheme,
                 core: Sequence[int],
                 lanczos_queries: Sequence[int] | None = None):
        N = t.ndim
        P = scheme.P
        self.P = P
        self.shape = tuple(t.shape)
        self.core = tuple(int(k) for k in core)
        self.name = scheme.name
        if lanczos_queries is None:
            lanczos_queries = [4 * self.core[n] for n in range(N)]
        self.queries = tuple(int(q) for q in lanczos_queries)
        self.nnz = t.nnz
        coords = np.asarray(t.coords)
        self._e_per_rank = []
        self._r_per_rank = []
        self._pair_counts: list[dict] = []
        self._owner = []
        self._slice_nnz = []
        self._L_ne = []
        self._fm_pairs: list[set] = []
        self._hit_flags = []
        self._fm_hits = []
        with tally.scope(t):  # the owner maps' counts, one upload
            owners = [row_owner_map(t, scheme.policy(n), n, P)
                      for n in range(N)]
        for n in range(N):
            pol = np.asarray(scheme.policy(n))
            slc = coords[:, n].astype(np.int64)
            self._e_per_rank.append(np.bincount(pol, minlength=P)
                                    .astype(np.int64))
            pair = slc * P + pol
            uniq, counts = np.unique(pair, return_counts=True)
            self._pair_counts.append(
                dict(zip(uniq.tolist(), counts.tolist())))
            self._r_per_rank.append(
                np.bincount((uniq % P).astype(np.int64), minlength=P)
                .astype(np.int64))
            self._owner.append(owners[n])
            snnz = np.bincount(slc, minlength=t.shape[n]).astype(np.int64)
            self._slice_nnz.append(snnz)
            self._L_ne.append(int((snnz > 0).sum()))
            need = [slc * P + np.asarray(scheme.policy(j))
                    for j in range(N) if j != n]
            fm = np.unique(np.concatenate(need)) if need else \
                np.zeros(0, np.int64)
            self._fm_pairs.append(set(fm.tolist()))
            L = t.shape[n]
            key = np.arange(L, dtype=np.int64) * P + self._owner[n]
            flags = np.isin(key, fm)
            self._hit_flags.append(flags)
            self._fm_hits.append(int(flags.sum()))

    def extend(self, new_coords: np.ndarray, scheme: Scheme) -> SchemeMetrics:
        """Fold ``new_coords`` into the state; ``scheme`` is the *extended*
        scheme (``extend_scheme`` output — its policy tails carry the batch's
        rank assignments). Returns the metrics of the extended state."""
        new_coords = np.asarray(new_coords)
        B = len(new_coords)
        N = len(self.shape)
        P = self.P
        for n in range(N):
            pol_full = np.asarray(scheme.policy(n))
            if len(pol_full) != self.nnz + B:
                raise ValueError(
                    f"mode {n} policy has {len(pol_full)} entries, expected "
                    f"{self.nnz} tracked + {B} appended — scheme is not the "
                    "extension of the tracked state")
            tail = pol_full[self.nnz:].astype(np.int64)
            slc = new_coords[:, n].astype(np.int64)
            self._e_per_rank[n] += np.bincount(tail, minlength=P)
            # distinct (slice, rank) pairs: dict miss -> R grows
            pair = slc * P + tail
            puniq, pcnt = np.unique(pair, return_counts=True)
            pc = self._pair_counts[n]
            for p, c in zip(puniq.tolist(), pcnt.tolist()):
                old = pc.get(p, 0)
                if old == 0:
                    self._r_per_rank[n][p % P] += 1
                pc[p] = old + c
                # live owner argmax: (count, rank) lexicographic, exactly
                # row_owner_map's sort-and-keep-last tie-break
                l, r = p // P, p % P
                o = int(self._owner[n][l])
                if o < 0 or (old + c, r) > (int(pc.get(l * P + o, 0)), o):
                    self._owner[n][l] = r
            snnz = self._slice_nnz[n]
            suniq, scnt = np.unique(slc, return_counts=True)
            self._L_ne[n] += int((snnz[suniq] == 0).sum())
            snnz[suniq] += scnt
            # fm need-set: this element's row must reach its ranks under
            # every other mode's policy
            fm = self._fm_pairs[n]
            for j in range(N):
                if j == n:
                    continue
                tj = np.asarray(scheme.policy(j))[self.nnz:].astype(np.int64)
                fm.update((slc * P + tj).tolist())
            # re-derive the "owner is a needer" flag for touched slices only
            for l in suniq.tolist():
                new_flag = (l * P + int(self._owner[n][l])) in fm
                if new_flag != bool(self._hit_flags[n][l]):
                    self._fm_hits[n] += 1 if new_flag else -1
                    self._hit_flags[n][l] = new_flag
        self.nnz += B
        return self.metrics()

    def metrics(self) -> SchemeMetrics:
        """Assemble ``SchemeMetrics`` from the tracked state — the same
        arithmetic as ``scheme_metrics``, fed from incremental counters."""
        N = len(self.shape)
        per_mode = []
        for n in range(N):
            e = self._e_per_rank[n]
            r = self._r_per_rank[n]
            per_mode.append(ModeMetrics(
                mode=n,
                P=self.P,
                nnz=self.nnz,
                L=self.shape[n],
                L_nonempty=self._L_ne[n],
                E_max=int(e.max()) if len(e) else 0,
                E_avg=self.nnz / self.P,
                R_sum=int(r.sum()),
                R_max=int(r.max()) if len(r) else 0,
                R_avg=float(r.sum()) / self.P,
            ))
        core = self.core
        khat = [int(np.prod([core[j] for j in range(N) if j != n]))
                for n in range(N)]
        ttm = ttm_max = svd = svd_max = 0
        for n in range(N):
            m = per_mode[n]
            ttm += 2 * self.nnz * khat[n]
            ttm_max += 2 * m.E_max * khat[n]
            q = self.queries[n]
            svd += q * m.R_sum * khat[n] * 2
            svd_max += q * m.R_max * khat[n] * 2
        svd_vol = sum(self.queries[n] * per_mode[n].oracle_comm_per_query()
                      for n in range(N))
        fm_vol = sum((len(self._fm_pairs[n]) - self._fm_hits[n]) * core[n]
                     for n in range(N))
        return SchemeMetrics(
            scheme=self.name,
            P=self.P,
            per_mode=tuple(per_mode),
            core_dims=core,
            fm_volume=int(fm_vol),
            svd_volume=int(svd_vol),
            ttm_flops=int(ttm),
            svd_flops=int(svd),
            ttm_flops_max=int(ttm_max),
            svd_flops_max=int(svd_max),
        )
