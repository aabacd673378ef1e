"""Performance metrics for distribution schemes (paper §4).

Per mode n, for a policy pi_n:

  Metric 1  E_max = max_p |E_n^p|                  (TTM load balance)
  Metric 2  R_sum = sum_p R_n^p                    (SVD load + oracle comm)
  Metric 3  R_max = max_p R_n^p                    (SVD load balance)

plus the derived quantities used in the paper's experimental section:
normalized SVD redundancy, oracle communication volume Q_n*(R_sum - L_n),
factor-matrix transfer volume (uni- and multi-policy), FLOP counts and the
memory model of §7.3.

The port's own copy of the reference's ``core/metrics.py`` (pure numpy),
without the streaming ``MetricsExtender`` (ROADMAP Queue A item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .coo import SparseTensor
from .distribution import Scheme

__all__ = ["ModeMetrics", "SchemeMetrics", "mode_metrics", "scheme_metrics"]


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
    pair = t.coords[:, mode].astype(np.int64) * P + policy
    uniq = np.unique(pair)
    ranks = (uniq % P).astype(np.int64)
    return np.bincount(ranks, minlength=P)


def mode_metrics(t: SparseTensor, policy: np.ndarray, mode: int, P: int) -> ModeMetrics:
    counts = np.bincount(policy, minlength=P)
    r = _r_per_rank(t, policy, mode, P)
    L_ne = int((t.slice_sizes(mode) > 0).sum())
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
    from .distribution import row_owner_map

    total = 0
    N = t.ndim
    for n in range(N):
        L = t.shape[n]
        slc = t.coords[:, n].astype(np.int64)
        need_pairs = []
        for j in range(N):
            if j == n:
                continue
            need_pairs.append(slc * scheme.P + scheme.policy(j))
        pairs = np.unique(np.concatenate(need_pairs))
        # subtract one per slice for the producing owner if it is a needer
        sigma = row_owner_map(t, scheme.policy(n), n, scheme.P)
        slices_in_pairs = (pairs // scheme.P).astype(np.int64)
        ranks_in_pairs = (pairs % scheme.P).astype(np.int64)
        owner_hit = sigma[slices_in_pairs] == ranks_in_pairs
        rows_to_send = len(pairs) - int(owner_hit.sum())
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
    per_mode = tuple(
        mode_metrics(t, scheme.policy(n), n, scheme.P) for n in range(N)
    )
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
    fm_vol = _fm_volume(t, scheme, core)
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
