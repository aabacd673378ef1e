"""Oracle stage: how a mode step answers the Lanczos products for its Z.

The port of ``src/repro/engine/oracle.py``. The SVD component only consumes
Z through ``Z @ x`` and ``Zᵀ @ y`` (paper §3):

* ``fused=False`` — plain ``torch.matmul`` products, as the reference leaves
  them to XLA.
* ``fused=True`` — the ``oracle_pair`` kernel. GK's two products of one
  iteration depend on each other (u = f(Z v) before Zᵀ u), so each call
  asks for one product and leaves the other operand out (None). The
  reference passes a zero companion instead and discards its product; the
  results are the same, and either way it is one pass of Z per product.

``stacked_products`` gives the same two products for the distributed
step's stacked ranks, ``group_products`` each device group's of a
``distributed.mesh.RankMesh`` (one product per group, on its device and
stream: the boundary space places them on the groups), and
``mesh_products`` those with the answers gathered at home in the stacked
layout (the psum space); ``solve_oracle``/``solve_oracle_block`` run the
vector and the block Lanczos drivers. ``resolve_warm_start``,
``choose_warm_start`` and ``count_z_passes`` settle the sketch warm start
(``core.sketch``) per mode and count what each choice reads of Z.

``ModeSpec`` is one mode step's solve parameters. ``resolve_knobs`` turns a
run's knobs (``REPRO_*`` variables included) into the request once, and
``mode_spec`` derives each mode's spec from it and the mode's geometry:
``hooi``, the executor's steps and the stochastic rung all take their
panel width, warm start, fused first product and iteration budget from it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import envknobs
from repro_torch.core.lanczos import (effective_block_size, gk_bidiag,
                                      gk_block_bidiag, lanczos_niter,
                                      svd_from_bidiag)
from repro_torch.core.sketch import (DEFAULT_POWER_ITERS, sketch_block_size,
                                     sketch_niter)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.random import Key

from .zbuild import resolve_fused_zbuild, resolve_precision

__all__ = ["z_products", "stacked_products", "group_products",
           "mesh_products", "solve_oracle",
           "solve_oracle_block", "resolve_block_size", "resolve_warm_start",
           "choose_warm_start", "count_z_passes", "ModeSpec",
           "resolve_knobs", "mode_spec"]


def resolve_block_size(block_size: int | None) -> int:
    """Lanczos panel width (1 = the vector driver). ``None`` honors
    ``REPRO_LANCZOS_BLOCK``, else 1. A request: mode steps clamp it with
    ``effective_block_size``."""
    if block_size is None:
        block_size = envknobs.lanczos_block() or 1
    block_size = int(block_size)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return block_size


def resolve_warm_start(warm_start: str | None) -> str:
    """Oracle warm start: ``"none"``, ``"sketch"`` or ``"auto"``. ``None``
    honors ``REPRO_WARM_START``, else ``"none"``. ``"auto"`` is settled per
    mode by ``choose_warm_start``."""
    if warm_start is None:
        warm_start = envknobs.warm_start() or "none"
    if warm_start not in envknobs.WARM_STARTS:
        raise ValueError(f"unknown warm_start {warm_start!r} "
                         f"(expected one of {envknobs.WARM_STARTS})")
    return warm_start


def choose_warm_start(
    warm_start: str,
    k: int,
    nrows: int,
    ncols: int,
    block_size: int = 1,
    fused_zbuild: bool = False,
    power_iters: int = DEFAULT_POWER_ITERS,
) -> str:
    """Per-mode resolution of ``warm_start="auto"``: the sketch exactly when
    it strictly reduces counted Z passes for this mode's geometry (seed and
    power passes included; the sketch forgoes the fused first product and
    runs the widened ``sketch_block_size`` panel). Other values pass."""
    if warm_start != "auto":
        return warm_start
    full = count_z_passes(
        lanczos_niter(k, nrows, ncols, block_size), fused_zbuild)
    s_sk = sketch_block_size(k, nrows, ncols, block_size)
    sk = count_z_passes(
        sketch_niter(k, nrows, ncols, s_sk),
        False, warm_start="sketch", power_iters=power_iters)
    return "sketch" if sk < full else "none"


def count_z_passes(niter: int, fused_zbuild: bool = False, *,
                   warm_start: str = "none",
                   power_iters: int = 0) -> int:
    """Counted passes over Z for one mode step: one write at build time and
    two reads (``Z @ x``, ``Zᵀ @ y``) per oracle iteration, block
    iterations under block Lanczos; the fused build serves the first
    ``Z @ V_1`` and saves one read. A sketch warm start adds one read for
    the seed ``Zᵀ F`` and two per power iteration."""
    passes = 1 + 2 * int(niter) - (1 if fused_zbuild else 0)
    if warm_start == "sketch":
        passes += 1 + 2 * int(power_iters)
    return passes


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One mode step's static solve parameters.

    ``resolve_knobs`` gives a run's request in this form (``block_size``
    the requested panel width, ``warm_start`` possibly ``"auto"``);
    ``mode_spec`` settles it per mode. The defaults are the main path's:
    vector Lanczos, f32, plain products, no warm start, no fusion.
    """

    backend: str = "local"  # engine.comm's name ("zbuild": the TTM probe)
    K_n: int = 0  # left singular vectors the solve returns
    niter: int = 0  # block iterations when the block driver runs
    block_size: int = 1  # effective (clamped) Lanczos panel width
    fused_zbuild: bool = False  # the Z-build serves the first Z @ V_1
    warm_start: str = "none"  # settled per mode: "none" | "sketch"
    precision: str = "f32"  # the Z-build's
    use_fused: bool = False  # the products run the oracle_pair kernel
    objective: str = "tucker"

    @property
    def block_driver(self) -> bool:
        """The block driver runs: a panel wider than 1, the fused first
        product or the sketch's seeded panel."""
        return (self.warm_start == "sketch" or self.fused_zbuild
                or self.block_size > 1)


def resolve_knobs(precision: str | None = None,
                  lanczos_block: int | None = None,
                  fused_zbuild: bool | None = None,
                  warm_start: str | None = None,
                  use_fused_oracle: bool | None = None,
                  objective: str = "tucker") -> ModeSpec:
    """A run's knobs as the request ``mode_spec`` settles per mode; each
    None honors its ``REPRO_*`` variable (``precision="auto"`` consults
    the fitted cost model)."""
    return ModeSpec(precision=resolve_precision(precision),
                    block_size=resolve_block_size(lanczos_block),
                    fused_zbuild=resolve_fused_zbuild(fused_zbuild),
                    warm_start=resolve_warm_start(warm_start),
                    use_fused=bool(use_fused_oracle), objective=objective)


def mode_spec(knobs: ModeSpec, K_n: int, L: int, khat: int,
              niter: int | None = None, *,
              backend: str = "local") -> ModeSpec:
    """One mode's spec from the request ``knobs``, the reference's
    arithmetic: for a mode of ``L`` rows whose Z has ``khat`` columns, the
    panel clamped with ``effective_block_size``, ``"auto"`` settled by
    ``choose_warm_start``, a sketch mode at the widened
    ``sketch_block_size`` panel and never fused, and the iteration budget
    (``lanczos_niter``, or ``sketch_niter`` for a sketch mode).

    A given ``niter`` (``hooi``'s ``lanczos_iters``, a vector budget) is
    counted in block iterations on the block driver and clamped as the
    reference's ``lanczos_bidiag`` clamps it on the vector driver.
    """
    K_n, L, khat = int(K_n), int(L), int(khat)
    s = effective_block_size(K_n, L, khat, knobs.block_size)
    warm = choose_warm_start(knobs.warm_start, K_n, L, khat, s,
                             knobs.fused_zbuild)
    if warm == "sketch":
        s = sketch_block_size(K_n, L, khat, knobs.block_size)
    spec = dataclasses.replace(
        knobs, backend=backend, K_n=K_n, block_size=s, warm_start=warm,
        fused_zbuild=knobs.fused_zbuild and warm != "sketch")
    if niter is None:
        niter = (sketch_niter(K_n, L, khat, s) if warm == "sketch"
                 else lanczos_niter(K_n, L, khat, s))
    elif spec.block_driver:
        niter = -(-int(niter) // s)  # vector budget -> block count
    else:
        niter = max(int(min(niter, L, khat)), min(K_n, L, khat))
    return dataclasses.replace(spec, niter=int(niter))


def z_products(Z: torch.Tensor, *,
               fused: bool = False) -> tuple[Callable, Callable]:
    """(matvec, rmatvec) for an explicit Z. Both accept width-``s`` panels
    as well as vectors."""
    if not fused:
        # the vector rmatvec keeps the reference's ``y @ Z`` contraction
        return ((lambda x: Z @ x),
                (lambda y: y @ Z if y.dim() == 1 else Z.T @ y))

    def matvec(x):
        return kernel_ops.oracle_pair(Z, x.contiguous(), None)[0]

    def rmatvec(y):
        return kernel_ops.oracle_pair(Z, None, y.contiguous())[1]

    return matvec, rmatvec


def stacked_products(Z: torch.Tensor, P: int, *,
                     fused: bool = False) -> tuple[Callable, Callable]:
    """(zmv, zrmv) for the distributed step's stacked ranks.

    ``Z`` is the ranks' local Z matrices stacked as ``(P*R_pad, K_hat)``.
    ``zmv(x)`` is one product over all ranks, ``(P*R_pad[, s])``;
    ``zrmv(y)`` takes ``(P, R_pad[, s])`` and returns each rank's
    ``Z_pᵀ y_p`` as ``(P, K_hat[, s])`` (the comm space sums them over the
    ranks). Fused, that is one batched ``oracle_pair`` call: on the card
    one launch for all ranks.
    """
    matvec = z_products(Z, fused=fused)[0]
    if fused:
        def rmatvec(y):
            return kernel_ops.oracle_pair(Z, None, y.contiguous(), P)[1]
    else:
        # the plain products, rank by rank as the reference's shard_map
        # body takes them
        per_rank = [z_products(Zp)[1] for Zp in Z.view(P, -1, Z.shape[1])]

        def rmatvec(y):
            return torch.stack([r(yp) for r, yp in zip(per_rank, y)])

    return matvec, rmatvec


def group_products(Zs, mesh, *, fused: bool = False
                   ) -> list[tuple[Callable, Callable]]:
    """``stacked_products`` of each group's ``(P/G*R_pad, K_hat)`` stack
    ``Zs[g]``, made on its group: call each on its group."""
    return mesh.each(lambda g: stacked_products(Zs[g], mesh.per_group,
                                                fused=fused))


def mesh_products(Zs, mesh, *, fused: bool = False
                  ) -> tuple[Callable, Callable]:
    """(zmv, zrmv) for ranks spread over a mesh's device groups, with
    ``stacked_products``' contract at home.

    ``Zs[g]`` is group g's ``(P/G*R_pad, K_hat)`` stack on its device.
    ``zmv(x)`` sends x to every group, runs each group's product on its
    stream and brings the ``(P/G*R_pad[, s])`` answers home, concatenated
    as ``(P*R_pad[, s])``; ``zrmv(y)`` sends each group its ``(P/G,
    R_pad[, s])`` rows of y and returns ``(P, K_hat[, s])`` at home. Every
    group's work is queued before home waits for any of it.
    """
    per = mesh.per_group
    prods = group_products(Zs, mesh, fused=fused)

    def gathered(calls):
        outs = []
        for g, (call, arg) in enumerate(calls):
            arg = mesh.to_group(arg, g)
            with mesh.group(g):
                outs.append(call(arg))
        return torch.cat([mesh.to_home(o, g) for g, o in enumerate(outs)])

    def zmv(x):
        return gathered([(mv, x) for mv, _ in prods])

    def zrmv(y):
        return gathered([(rmv, y[g * per:(g + 1) * per])
                         for g, (_, rmv) in enumerate(prods)])

    return zmv, zrmv


def solve_oracle(
    matvec: Callable,
    rmatvec: Callable,
    dim_u: int,
    ncols: int,
    k: int,
    niter: int,
    key: Key,
    axis: str | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leading-k left singular vectors of the oracle: one GK sweep plus the
    small-SVD projection."""
    U, B = gk_bidiag(matvec, rmatvec, dim_u, ncols, niter, key, axis=axis,
                     device=device)
    return svd_from_bidiag(U, B, k, key, axis=axis)


def solve_oracle_block(
    matvec: Callable,
    rmatvec: Callable,
    dim_u: int,
    ncols: int,
    k: int,
    niter: int,
    block_size: int,
    key: Key,
    axis: int | None = None,
    first_panel: torch.Tensor | None = None,
    first_product: torch.Tensor | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-Lanczos counterpart of ``solve_oracle``: ``niter`` counts
    block iterations; ``first_panel``/``first_product`` come from the fused
    Z-build stage."""
    U, B = gk_block_bidiag(matvec, rmatvec, dim_u, ncols, niter, block_size,
                           key, axis=axis, first_panel=first_panel,
                           first_product=first_product, device=device)
    return svd_from_bidiag(U, B, k, key, axis=axis)
