"""Matrix-free Lanczos (Golub–Kahan) bidiagonalization for the SVD step.

The port of ``src/repro/core/lanczos.py``: the vector driver ``gk_bidiag``
and the block (s-step) driver ``gk_block_bidiag``. The method only asks for
the two products ``Z @ x`` and ``Zᵀ @ y`` (paper §3 'SVD Component');
callers supply them as closures. Per the paper (§7.1, after SLEPc), ``2*K``
bidiagonalization iterations serve K requested singular vectors, with full
two-pass reorthogonalization to keep float32 stable.

The u-space (left/row space) is replicated (``axis=None``) or *sharded*
over ranks. The reference shards it over a mesh axis and ``psum``s its inner
products (``_space_reduce``); here the P ranks are stacked along a leading
dimension, so ``axis=P``, a u-space vector is a ``(P, dim_u)`` tensor, and
every u-space inner product is a per-rank sum followed by ``rank_sum`` over
the ranks in rank order. Over the device groups of a mesh
(``distributed.mesh``), ``axis`` is the ``RankMesh``: a u-space value is a
``GroupTensor`` of one ``(P/G, dim_u)`` part per group, each rank's partial
is taken on its group (in the stacked layout, so it is the stacked run's
bits), and the partials come home to the same ``rank_sum``. Each rank draws
its own breakdown-restart and completion directions along the reference's
``fold_in(…, axis_index)``: the paths ``+(17, p)`` and ``+(1, p)``. The
v-space (K̂) is always replicated, at the mesh's home.

The reference's ``fori_loop`` is a Python loop here, and every
data-dependent choice (breakdown restarts) is a ``torch.where`` on device
scalars, so the loop never waits for the device. The random draws come from
``key`` along the reference's ``fold_in`` chain (``repro_torch.random``).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import GroupTensor, RankMesh
from repro_torch.graphs import host_call, upload
from repro_torch.random import Key, make_key

__all__ = ["LanczosResult", "lanczos_bidiag", "svd_via_lanczos",
           "gk_bidiag", "gk_block_bidiag", "svd_from_bidiag",
           "lanczos_niter", "effective_block_size", "block_start_panel",
           "rank_sum"]

_EPS = 1e-30


class LanczosResult(NamedTuple):
    left_vectors: torch.Tensor  # (nrows, k) leading left singular vectors
    singular_values: torch.Tensor  # (k,)
    n_queries: int  # oracle queries consumed (Q_n in the paper)


def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``psum`` over stacked ranks: the sum over dim 0,
    taken in rank order (so every rerun adds in the same order)."""
    return functools.reduce(torch.add, x.unbind(0))


class _Space:
    """Inner products of one (possibly sharded) space."""

    def __init__(self, axis: int | None):
        self.axis = axis

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Global ``sum(a * b)``: per rank, then over ranks."""
        if self.axis is None:
            return torch.sum(a * b)
        return rank_sum((a * b).reshape(self.axis, -1).sum(1))

    def proj(self, basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """``basis @ (basisᵀ u)`` with the global inner products."""
        if self.axis is None:
            return basis @ (basis.T @ u)
        if u.dim() == 2:  # (P, d) vector
            coef = rank_sum((basis.mT @ u.unsqueeze(-1)).squeeze(-1))
        else:  # (P, d, s) panel
            coef = rank_sum(basis.mT @ u)
        return basis @ coef

    def normal(self, key: Key, dim: int, cols: int,
               device: torch.device) -> torch.Tensor:
        """Draws of ``key`` for ``(dim, cols)`` per rank: ``+(p,)`` when
        sharded (the reference's ``fold_in(key, axis_index)``)."""
        if self.axis is None:
            return key.normal((dim, cols), device)
        return torch.stack([key.fold_in(p).normal((dim, cols), device)
                            for p in range(self.axis)])

    def zeros(self, dim: int, tail: tuple, device: torch.device
              ) -> torch.Tensor:
        """A zero value of ``dim`` rows (per rank when sharded) and
        trailing shape ``tail``."""
        rows = (dim,) if self.axis is None else (self.axis, dim)
        return torch.zeros(rows + tuple(tail), dtype=torch.float32,
                           device=device)


class _MeshSpace(_Space):
    """The u-space of a mesh's boundary backend: ``GroupTensor`` values,
    each rank's partial taken on its group's frame (so it is the stacked
    ``_Space``'s, bit for bit), the partials home, ``rank_sum`` in rank
    order. The port of the reference's ``_space_reduce`` over the mesh
    axis; the results (scalars, coefficients) are home values."""

    def __init__(self, mesh: RankMesh):
        super().__init__(mesh.P)
        self.mesh = mesh

    def _sum_home(self, partial) -> torch.Tensor:
        """``rank_sum`` at home of ``partial(g, lo, hi)``, each group's
        ranks' partials, made on the group."""
        mesh = self.mesh

        def make(g):
            r = mesh.ranks_of(g)
            return partial(g, r.start, r.stop)

        parts = GroupTensor.build(mesh, make)
        return rank_sum(parts.home())

    def dot(self, a: GroupTensor, b: GroupTensor) -> torch.Tensor:
        P = self.axis

        def partial(g, lo, hi):
            pa, pb = a.parts[g], b.parts[g]
            prod = pa.new_zeros((P,) + tuple(pa.shape[1:]))
            torch.mul(pa, pb, out=prod[lo:hi])
            return prod.reshape(P, -1).sum(1)[lo:hi]

        return self._sum_home(partial)

    def proj(self, basis: GroupTensor, u: GroupTensor) -> GroupTensor:
        def partial(g, lo, hi):
            B, x = basis.frame(g), u.frame(g)
            if u.dim() == 2:  # (P, d) vector
                return (B.mT @ x.unsqueeze(-1)).squeeze(-1)[lo:hi]
            return (B.mT @ x)[lo:hi]

        return basis @ self._sum_home(partial)

    def normal(self, key: Key, dim: int, cols: int,
               device: torch.device | None = None) -> GroupTensor:
        """Each rank's ``+(p,)`` draws, made on its group's device."""
        mesh = self.mesh

        def make(g):
            dev = mesh.devices[g]
            f = torch.zeros((mesh.P, dim, cols), dtype=torch.float32,
                            device=dev)
            for p in mesh.ranks_of(g):
                f[p] = key.fold_in(p).normal((dim, cols), dev)
            return f

        return GroupTensor.build(mesh, make, framed=True)

    def zeros(self, dim: int, tail: tuple,
              device: torch.device | None = None) -> GroupTensor:
        mesh = self.mesh
        return GroupTensor.build(mesh, lambda g: torch.zeros(
            (mesh.P, dim) + tuple(tail), dtype=torch.float32,
            device=mesh.devices[g]), framed=True)


def _space(axis) -> _Space:
    """The space of ``axis``: None (replicated), P stacked ranks, or a
    ``RankMesh`` of device groups."""
    return _MeshSpace(axis) if isinstance(axis, RankMesh) else _Space(axis)


def lanczos_niter(k: int, nrows: int, ncols: int, block_size: int = 1) -> int:
    """The paper/SLEPc iteration count, clamped to the operator's rank cap
    (in block iterations when ``block_size > 1``)."""
    base = int(min(2 * k, nrows, ncols))
    if block_size <= 1:
        return base
    s = min(int(block_size), max(base, 1))
    return -(-base // s)


def effective_block_size(k: int, nrows: int, ncols: int,
                         block_size: int) -> int:
    """Clamp a requested panel width to the operator's vector-iteration
    budget."""
    base = lanczos_niter(k, nrows, ncols)
    return max(1, min(int(block_size), base))


def block_start_panel(key: Key, ncols: int, block_size: int,
                      device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Orthonormal start panel V_1 (ncols, s) from the draw ``+(3,)``, the
    stream the vector driver's start vector uses, so the fused Z-build and
    the block driver agree on it without communicating. The QR runs on the
    host (LAPACK), so card and CPU runs start from the same panel; the panel
    comes back row-major, the layout the fused Z-build kernel reads."""
    key3 = key.fold_in(3)

    def panel() -> torch.Tensor:
        q, _ = torch.linalg.qr(key3.normal((ncols, block_size), "cpu"))
        return q.contiguous()

    # depends on the draw only: a captured step makes it before its replay
    return upload(panel, resolve_device(device))


def _reorth(u: torch.Tensor, basis: torch.Tensor, space: _Space
            ) -> torch.Tensor:
    # CGS2 ("twice is enough"); zero columns of the preallocated basis
    # contribute nothing, so the full fixed-shape product is safe
    for _ in range(2):
        u = u - space.proj(basis, u)
    return u


def gk_bidiag(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    dim_u: int,
    ncols: int,
    niter: int,
    key: Key,
    axis: int | RankMesh | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The GK bidiagonalization body. Returns ``(U, B)`` with ``B`` upper
    bidiagonal: ``Z V = U B``. ``dim_u`` is the per-rank u-space dimension
    when ``axis`` (the number of stacked ranks, or a mesh) is given; ``U``
    is then ``(axis, dim_u, niter)`` (a ``GroupTensor`` over a mesh).
    ``device`` is where the oracle's v-space vectors live (default: the
    card)."""
    dev = resolve_device(device)
    us, vs = _space(axis), _Space(None)
    f32 = torch.float32
    V = torch.zeros((ncols, niter), dtype=f32, device=dev)
    U = us.zeros(dim_u, (niter,), dev)
    alphas = torch.zeros((niter,), dtype=f32, device=dev)
    betas = torch.zeros((niter,), dtype=f32, device=dev)

    r_u = us.normal(key.fold_in(17), dim_u, niter, dev)  # breakdown restarts
    r_v = key.fold_in(29).normal((ncols, niter), dev)
    v = key.fold_in(3).normal((ncols,), dev)
    v = v / (torch.linalg.norm(v) + _EPS)

    u_prev = us.zeros(dim_u, (), dev)
    beta_prev = torch.zeros((), dtype=f32, device=dev)
    scale = torch.full((), _EPS, dtype=f32, device=dev)
    for i in range(niter):
        V[:, i] = v
        u = matvec(v) - beta_prev * u_prev
        u = _reorth(u, U, us)
        alpha = torch.sqrt(us.dot(u, u))
        scale = torch.maximum(scale, alpha)
        # Lucky breakdown: restart with a fresh direction, record alpha = 0
        # so the restart never mixes into the computed singular vectors.
        ok = alpha > 1e-6 * scale
        u_new = _reorth(r_u[..., i], U, us)
        u_new = u_new / (torch.sqrt(us.dot(u_new, u_new)) + _EPS)
        u = torch.where(ok, u / (alpha + _EPS), u_new)
        alpha = torch.where(ok, alpha, 0.0)
        U[..., i] = u
        alphas[i] = alpha

        w = rmatvec(u) - alpha * v
        w = _reorth(w, V, vs)
        beta = torch.linalg.norm(w)
        scale = torch.maximum(scale, beta)
        ok_b = beta > 1e-6 * scale
        v_new = _reorth(r_v[:, i], V, vs)
        v_new = v_new / (torch.linalg.norm(v_new) + _EPS)
        v = torch.where(ok_b, w / (beta + _EPS), v_new)
        beta = torch.where(ok_b, beta, 0.0)
        betas[i] = beta
        u_prev, beta_prev = u, beta

    # Z V = U B with B *upper* bidiagonal: alphas on the diagonal, betas on
    # the superdiagonal (Z v_{i+1} = beta_i u_i + alpha_{i+1} u_{i+1}).
    B = torch.diag(alphas) + torch.diag(betas[:-1], 1)
    return U, B


def _panel_qr(W, basis, restarts, space: _Space, scale):
    """Column-MGS QR of a panel with per-column breakdown restarts.

    Restart columns get a fresh direction orthogonal to ``basis`` and the
    panel built so far, with a zero diagonal R entry, so they never mix into
    the computed singular vectors (the vector driver's contract).
    """
    s = W.shape[-1]
    cols = []
    R = torch.zeros((s, s), dtype=W.dtype, device=W.device)
    for j in range(s):
        w = W[..., j]
        for _pass in range(2):  # MGS twice within the panel
            for jj in range(j):
                r = space.dot(cols[jj], w)
                w = w - r * cols[jj]
                R[jj, j] = R[jj, j] + r
        nrm = torch.sqrt(space.dot(w, w))
        scale = torch.maximum(scale, nrm)
        ok = nrm > 1e-6 * scale
        c = restarts[..., j]
        for _pass in range(2):
            c = c - space.proj(basis, c)
            for jj in range(j):
                c = c - space.dot(cols[jj], c) * cols[jj]
        c = c / (torch.sqrt(space.dot(c, c)) + _EPS)
        q = torch.where(ok, w / (nrm + _EPS), c)
        R[j, j] = torch.where(ok, nrm, 0.0)
        cols.append(q)
    return torch.stack(cols, dim=-1), R, scale


def gk_block_bidiag(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    dim_u: int,
    ncols: int,
    niter: int,
    block_size: int,
    key: Key,
    axis: int | RankMesh | None = None,
    first_panel: torch.Tensor | None = None,
    first_product: torch.Tensor | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block (s-step) GK bidiagonalization: ``Z V = U B`` with B banded.

    ``niter`` counts *block* iterations; matvec/rmatvec consume and produce
    ``(., s)`` panels. ``U`` is ``(dim_u, niter*s)`` (``(axis, dim_u,
    niter*s)`` sharded) and ``B`` the block upper bidiagonal ``(niter*s,
    niter*s)`` matrix: the panel-QR factors ``A_i`` on the diagonal blocks,
    ``B_{i-1}ᵀ`` above them. ``svd_from_bidiag`` consumes it unchanged.

    ``first_panel``/``first_product`` are the seam the fused Z-build stage
    uses: it passes ``block_start_panel(key, ncols, s)`` (the default, so
    resumed and cold drivers walk the same Krylov space) and the product
    ``Z @ V_1`` it already computed, which replaces the first ``matvec``.
    """
    dev = resolve_device(device)
    us, vs = _space(axis), _Space(None)
    f32 = torch.float32
    s = int(block_size)
    m = int(niter)
    total = m * s

    r_u = us.normal(key.fold_in(17), dim_u, total, dev)  # breakdown restarts
    r_v = key.fold_in(29).normal((ncols, total), dev)
    if first_panel is None:
        first_panel = block_start_panel(key, ncols, s, dev)

    U = us.zeros(dim_u, (total,), dev)
    V = torch.zeros((ncols, total), dtype=f32, device=dev)
    B = torch.zeros((total, total), dtype=f32, device=dev)

    Vi = first_panel
    Uprev = us.zeros(dim_u, (s,), dev)
    Bprev = torch.zeros((s, s), dtype=f32, device=dev)
    scale = torch.full((), _EPS, dtype=f32, device=dev)
    for i in range(m):
        blk = slice(i * s, (i + 1) * s)
        V[:, blk] = Vi
        # Z V_i = U_{i-1} B_{i-1}ᵀ + U_i A_i
        ZV = first_product if (i == 0 and first_product is not None) \
            else matvec(Vi)
        W = _reorth(ZV - Uprev @ Bprev.T, U, us)
        Ui, Ai, scale = _panel_qr(W, U, r_u[..., blk], us, scale)
        U[..., blk] = Ui
        B[blk, blk] = Ai

        # Zᵀ U_i = V_i A_iᵀ + V_{i+1} B_i
        G = _reorth(rmatvec(Ui) - Vi @ Ai.T, V, vs)
        Vn, Bi, scale = _panel_qr(G, V, r_v[:, blk], vs, scale)
        if i + 1 < m:
            B[blk, (i + 1) * s:(i + 2) * s] = Bi.T
        Uprev, Bprev, Vi = Ui, Bi, Vn
    return U, B


def _complete_columns(left: torch.Tensor, m: int, key: Key,
                      axis: int | RankMesh | None) -> torch.Tensor:
    """Append ``m`` orthonormal columns to ``left`` (rank-deficient edge),
    column by column with CGS2 and the space's global inner products."""
    space = _space(axis)
    extra = space.normal(key.fold_in(1), left.shape[-2], m, left.device)
    basis = left
    for j in range(m):
        c = extra[..., j]
        for _ in range(2):
            c = c - space.proj(basis, c)
        c = c / (torch.sqrt(space.dot(c, c)) + _EPS)
        basis = torch.cat([basis, c[..., None]], dim=-1)
    return basis


def _host_svd(B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    P, S, _ = torch.linalg.svd(B, full_matrices=False)
    return P, S


def svd_from_bidiag(
    U: torch.Tensor,
    B: torch.Tensor,
    k: int,
    key: Key,
    axis: int | RankMesh | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Left singular vectors from the GK output: SVD of the small bidiagonal
    matrix, projected through U, completed to ``k`` orthonormal columns when
    the iteration count could not reach ``k`` (rank-deficient operators).

    The (niter, niter) SVD runs on the host (LAPACK) whatever ``U``'s
    device: singular vectors are defined up to sign, and a sign flip here
    flips columns of the next mode's Z and so changes its Krylov space. One
    routine keeps card and CPU runs on the same trajectory, and the matrix
    is at most a few dozen wide.
    """
    P, S = host_call(_host_svd, B)
    niter = int(B.shape[0])
    kk = min(k, niter)
    left = U @ P[:, :kk]
    if kk < k:
        left = _complete_columns(left, k - kk, key, axis)
        S = torch.cat([S[:kk], torch.zeros((k - kk,), dtype=S.dtype,
                                           device=S.device)])
    return left, S[:k]


def lanczos_bidiag(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    nrows: int,
    ncols: int,
    k: int,
    niter: int | None = None,
    key: Key | None = None,
    *,
    device: str | torch.device | None = None,
) -> LanczosResult:
    """Leading-k left singular vectors of the oracle matrix Z.

    matvec : x (ncols,) -> Z @ x (nrows,)
    rmatvec: u (nrows,) -> Z.T @ u (ncols,)
    """
    if key is None:
        key = make_key(0)
    if niter is None:
        niter = lanczos_niter(k, nrows, ncols)
    else:
        niter = int(min(niter, nrows, ncols))
        niter = max(niter, min(k, nrows, ncols))
    U, B = gk_bidiag(matvec, rmatvec, nrows, ncols, niter, key, axis=None,
                     device=device)
    left, S = svd_from_bidiag(U, B, k, key, axis=None)
    return LanczosResult(left, S, n_queries=2 * niter)


def svd_via_lanczos(Z: torch.Tensor, k: int, key: Key | None = None,
                    niter: int | None = None) -> LanczosResult:
    """Convenience wrapper: explicit (single-rank) Z, on Z's device."""
    return lanczos_bidiag(
        lambda x: Z @ x,
        lambda u: Z.T @ u,
        Z.shape[0],
        Z.shape[1],
        k,
        niter=niter,
        key=key,
        device=Z.device,
    )
