"""Mode steps composed from the engine stages.

The port of ``src/repro/engine/steps.py``. A HOOI mode step is the
**Z-build** (``engine.zbuild``) followed by the **oracle**
(``engine.oracle``: the Z products and the Lanczos body) and, for the
distributed step, the **comm backend** (``engine.comm``):

* ``make_mode_step_fn`` — one distributed mode step over the P ranks,
  stacked along a leading dimension on one device (the reference wraps the
  same function in ``shard_map``), or with a ``mesh`` of several device
  groups, each group's ranks stacked on its device: the Z-build and the
  Z products run per group, and under ``boundary`` the u-space stays on
  the groups too;
* ``local_mode_step`` — the same composition with the identity partition
  and no comm space: what ``repro_torch.core.hooi`` runs;
* ``make_zbuild_step_fn`` — the Z-build alone over the stacked ranks (the
  executor's ``profile_phases`` times it as the TTM phase);
* ``make_stochastic_step_fn`` — one minibatch step of the stochastic-refine
  rung: a sketch-seeded block solve over sampled elements on one device.

The executor caches the first three kinds of step and, on the card,
captures each into CUDA graphs (``repro_torch.graphs``); a step reaches its
host factorizations and its draws only through ``graphs.host_call`` and
``graphs.upload``, so the same code runs eagerly and captured.

Every step reads its solve parameters from an ``oracle.ModeSpec`` and
runs the same solve after its Z-build, over an ``OracleSpace``: the comm
backend's for the distributed step, a one-rank space over ``Z`` for the
local and the stochastic steps. The solve runs the vector driver, or the
block driver when the panel is wider than 1, the fused Z-build is on, or
the mode runs the sketch warm start (``warm_start="sketch"``: the
factor-seeded start panel of ``core.sketch``, one power iteration through
the oracle, then the reduced ``sketch_niter`` budget; a sketch mode never
takes the fused build).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch import tracing
from repro_torch.core.lanczos import block_start_panel
from repro_torch.core.sketch import (DEFAULT_POWER_ITERS, power_refine,
                                     seeded_start_panel)
from repro_torch.random import Key

from .comm import OracleSpace, make_comm_space, make_mesh_boundary_space
from .oracle import (ModeSpec, group_products, mesh_products, mode_spec,
                     solve_oracle, solve_oracle_block, stacked_products,
                     z_products)
from .zbuild import build_group_z, build_local_z, build_local_z_oracle

__all__ = ["make_mode_step_fn", "make_zbuild_step_fn",
           "make_stochastic_step_fn", "local_mode_step"]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _khat(factors: Sequence[torch.Tensor], mode: int) -> int:
    Khat = 1
    for j, f in enumerate(factors):
        if j != mode:
            Khat *= int(f.shape[1])
    return Khat


def _spread(mesh) -> bool:
    return mesh is not None and mesh.G > 1


def _same(x):
    return x


def _local_space(Z: torch.Tensor, fused: bool = False) -> OracleSpace:
    """The one-rank space over an explicit ``Z``: its products, nothing to
    place or gather, and the sketch seed ``Zᵀ F`` one ``rmatvec``."""
    matvec, rmatvec = z_products(Z, fused=fused)
    return OracleSpace(matvec, rmatvec, int(Z.shape[0]), None, _same, _same,
                       lambda F: rmatvec(F.contiguous()))


def _solve(space: OracleSpace, spec: ModeSpec, F_n: torch.Tensor, key: Key,
           Khat: int, device, first_panel: torch.Tensor | None = None,
           ZV1: torch.Tensor | None = None):
    """A mode step after its Z-build: the sketch's seeded panel and its
    power iteration, then the vector or the block driver over ``space``.
    ``first_panel``/``ZV1`` are the fused Z-build's panel and its product.
    Returns ``(space.finalize(left), S)``."""
    if spec.warm_start == "sketch":
        w = min(spec.block_size, int(F_n.shape[1]))
        seed = space.seed(F_n[:, :w])
        first_panel = seeded_start_panel(seed, key, Khat, spec.block_size)
        first_panel = power_refine(space.matvec, space.rmatvec, first_panel,
                                   DEFAULT_POWER_ITERS)
    if spec.block_driver:
        first_product = None if ZV1 is None else space.wrap_matvec_out(ZV1)
        left, S = solve_oracle_block(
            space.matvec, space.rmatvec, space.dim_u, Khat, spec.K_n,
            spec.niter, spec.block_size, key, axis=space.axis,
            first_panel=first_panel, first_product=first_product,
            device=device)
    else:
        left, S = solve_oracle(space.matvec, space.rmatvec, space.dim_u,
                               Khat, spec.K_n, spec.niter, key,
                               axis=space.axis, device=device)
    return space.finalize(left), S


def make_zbuild_step_fn(ms: dict, mesh=None):
    """TTM-only step: the stacked ranks' Z build, ``(P*R_pad, K_hat)``.

    ``fn(arrs, factors, key) -> Z`` over the arrays of
    ``make_mode_step_fn`` (``coords``, ``values``, ``rows``) at the
    precision of ``ms["spec"]``; ``key`` is unused. The executor's
    per-phase calibration probe. Over a mesh of several groups it returns
    the groups' Z, each on its device.
    """
    num_rows, mode = ms["P"] * ms["R_pad"], ms["mode"]
    precision = ms["spec"].precision

    def fn(arrs: dict, factors: Sequence[torch.Tensor], key: Key):
        if _spread(mesh):
            return tuple(build_group_z(
                mesh, arrs["groups"], factors, mode, num_rows // mesh.G,
                precision=precision)[0])
        return build_local_z(arrs["coords"], arrs["values"], arrs["rows"],
                             factors, mode, num_rows, precision=precision)

    return fn


def make_stochastic_step_fn(mode: int, num_rows: int, K_n: int, niter: int,
                            block_size: int, precision: str = "f32"):
    """One minibatch mode step of the stochastic-refine rung.

    ``local_mode_step``'s sketch path over sampled elements: the Z-build
    (the elements are unsorted, so the device sort runs first), the seed
    ``Zᵀ F_n[:, :w]`` of the carried factor, one power iteration and the
    block driver's ``niter`` iterations at ``block_size``, all on one
    device and with the plain products, as the reference's step.

    ``fn(arrs, factors, key) -> (left, S)``: ``arrs`` holds the minibatch's
    ``coords`` (original coordinates, zero-padded to a power of two: the
    padding has value 0 and adds nothing) and ``values``; ``left`` is an
    orthonormal (num_rows, K_n) basis the caller blends into the carried
    factor (``core.stochastic.blend_factor``) and refines with the
    objective.
    """
    spec = ModeSpec(K_n=int(K_n), niter=int(niter),
                    block_size=int(block_size), warm_start="sketch",
                    precision=precision)

    def fn(arrs: dict, factors: Sequence[torch.Tensor], key: Key):
        coords, values = arrs["coords"], arrs["values"]
        Z = build_local_z(coords, values, coords[:, mode], factors, mode,
                          num_rows, sorted_rows=False, precision=precision)
        # the seed reads the factor's column slice in place: on the card
        # cuBLAS can round a strided operand apart from its contiguous copy
        space = dataclasses.replace(_local_space(Z), seed=lambda F: Z.T @ F)
        return _solve(space, spec, factors[mode], key, int(Z.shape[1]),
                      Z.device)

    return fn


def make_mode_step_fn(ms: dict, mesh=None):
    """One distributed mode step over the stacked ranks.

    ``ms`` is the static partition signature (mode, R_pad, Lp, P) with the
    mode's ``spec`` (an ``oracle.ModeSpec``: the comm backend, one of
    ``engine.comm``'s names, and the solve's parameters; ``niter`` counts
    block iterations when the block driver runs).

    ``fn(arrs, factors, key) -> (F, S)``: ``arrs`` holds the partition's
    elements flattened over the ranks (``coords`` (P*E_pad, N), ``values``,
    and ``rows``, each rank's local row ids offset by ``p*R_pad``) and the
    comm space's gather maps. Each rank's elements are sorted by local row
    and its padding elements carry its last real row, so the concatenation
    is sorted: one Z-build launch serves all ranks and gives their local Z
    matrices stacked as ``(P*R_pad, K_hat)``. ``F`` is ``(P, Lp, K_n)``,
    each rank's owned rows in relabelled order.

    ``warm_start="sketch"`` seeds the block driver with ``Σ_p Z_pᵀ
    F_n[orig_p][:, :w]`` (the space's ``seed``): the map ``f_src`` (built
    once per plan, ``comm.comm_maps``) gives each local row's original row
    id, the gather of those factor rows is one stacked ``rmatvec`` (one
    ``oracle_pair`` launch for all ranks when fused) and ``rank_sum`` adds
    the ranks in order. ``oracle.mode_spec`` turns the fused build off for
    sketch modes.

    With a ``mesh`` of G > 1 device groups (``distributed.mesh``), ``arrs``
    holds ``groups`` instead of the elements: per group its ranks'
    ``coords``, ``values`` and ``rows`` (offset by ``p*R_pad`` within the
    group) on its device, and ``space``, its ``comm.group_maps``. Each
    group builds its Z and answers its share of every product. Under
    ``boundary`` the u-space is sharded over the groups
    (``comm.make_mesh_boundary_space``): the fused first panel's product
    stays on them, the Lanczos body runs on ``GroupTensor`` shards, and
    ``F`` comes back as the groups' ``(P/G, Lp, K_n)`` shards (the caller
    brings them home). Under ``psum`` the products' answers come home
    (``oracle.mesh_products``) to the stacked space there.
    """
    P, R_pad, mode = ms["P"], ms["R_pad"], ms["mode"]
    spec: ModeSpec = ms["spec"]
    backend, precision, fused = spec.backend, spec.precision, spec.use_fused
    assert not (spec.fused_zbuild and spec.warm_start == "sketch"), \
        "sketch warm start excludes the fused first product (mode_spec)"

    def fn(arrs: dict, factors: Sequence[torch.Tensor], key: Key):
        Khat = _khat(factors, mode)
        dev = mesh.home if _spread(mesh) else arrs["values"].device
        first_panel = ZV1 = None
        if spec.fused_zbuild:
            first_panel = block_start_panel(key, Khat, spec.block_size, dev)
        if _spread(mesh):
            sharded = backend == "boundary"
            Zs, ZV1 = build_group_z(mesh, arrs["groups"], factors, mode,
                                    P // mesh.G * R_pad, first_panel,
                                    precision=precision, gather=not sharded)
            if sharded:
                space = make_mesh_boundary_space(
                    ms, arrs["space"], mesh,
                    group_products(Zs, mesh, fused=fused))
            else:
                space = make_comm_space(backend, ms, arrs,
                                        *mesh_products(Zs, mesh, fused=fused))
        else:
            if spec.fused_zbuild:
                Z, ZV1 = build_local_z_oracle(
                    arrs["coords"], arrs["values"], arrs["rows"], factors,
                    mode, P * R_pad, first_panel, precision=precision)
            else:
                Z = build_local_z(arrs["coords"], arrs["values"],
                                  arrs["rows"], factors, mode, P * R_pad,
                                  precision=precision)
            space = make_comm_space(backend, ms, arrs,
                                    *stacked_products(Z, P, fused=fused))
        return _solve(space, spec, factors[mode], key, Khat, dev,
                      first_panel, ZV1)

    return fn


def local_mode_step(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    key: Key,
    spec: ModeSpec | None = None,
    *,
    timings: dict | None = None,
    objective=None,
) -> torch.Tensor:
    """One single-process mode step; returns the refined factor
    (num_rows, spec.K_n).

    ``spec`` is the mode's ``oracle.mode_spec`` (None: the main path's
    defaults over this mode's geometry); the block driver runs where it
    says, as in the distributed step, so ``hooi`` and ``dist_hooi(P=1)``
    walk the same Krylov space. A sketch mode seeds the block driver with
    ``Zᵀ F_n[:, :w]`` through the one-rank space's ``rmatvec``, then one
    power iteration. ``objective`` (an ``engine.objective.Objective``)
    post-processes the solve with ``refine_factor(left, S)``. ``timings``
    (optional) accumulates blocking per-phase wall times under
    ``"ttm"``/``"svd"``.
    """
    Khat = _khat(factors, mode)
    if spec is None:
        spec = mode_spec(ModeSpec(), int(factors[mode].shape[1]), num_rows,
                         Khat)
    t0 = time.perf_counter()
    first_panel = ZV1 = None
    if spec.fused_zbuild:
        first_panel = block_start_panel(key, Khat, spec.block_size,
                                        coords.device)
        Z, ZV1 = build_local_z_oracle(
            coords, values, coords[:, mode], factors, mode, num_rows,
            first_panel, sorted_rows=False, precision=spec.precision)
    else:
        Z = build_local_z(coords, values, coords[:, mode], factors, mode,
                          num_rows, sorted_rows=False,
                          precision=spec.precision)
    if timings is not None:
        _sync(Z)
    t1 = time.perf_counter()
    with tracing.span("lanczos"):
        left, S = _solve(_local_space(Z, spec.use_fused), spec,
                         factors[mode], key, Khat, Z.device, first_panel, ZV1)
    if objective is not None:
        left = objective.refine_factor(left, S)
    if timings is not None:
        _sync(left)
        t2 = time.perf_counter()
        timings["ttm"] = timings.get("ttm", 0.0) + (t1 - t0)
        timings["svd"] = timings.get("svd", 0.0) + (t2 - t1)
    return left
