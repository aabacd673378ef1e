"""Comm backends: how a mode step's oracle answers cross the ranks.

The port of ``src/repro/engine/comm.py``. A backend wraps the per-rank Z
products into the global oracle the shared Lanczos body consumes:

* ``local`` — P = 1: no collectives. ``dist_hooi(P=1)`` runs here, the same
  engine instantiation as single-process ``hooi``.
* ``psum`` — the paper's framework (the historical ``baseline`` path): the
  oracle answer lives replicated in the full padded row space
  ``L_sent = P*Lp``, aggregated over ranks; the u-space is replicated
  (``axis=None``).
* ``boundary`` — the historical ``liteopt`` path: rows are relabelled so
  each rank owns a contiguous block of ``Lp`` rows, the oracle answer is
  sharded, and only the split-slice (boundary) rows cross ranks; the
  u-space is sharded (``axis=P``).

The reference runs each rank on its own device inside ``shard_map``. Here
the P ranks are a stacked leading dimension on one device, so a ``psum`` is
a sum over that dimension taken in rank order (``rank_sum``), and a sharded
u-space vector is a ``(P, Lp[, s])`` tensor.

Over a mesh of G > 1 device groups (``repro_torch.distributed.mesh``):

* ``boundary`` keeps each group's ranks' u-space rows on that group, as the
  reference keeps each device's shard (``make_mesh_boundary_space``, over
  the per-group maps of ``group_maps``, split once per plan). A product
  ``Z @ x`` sends ``x`` out and leaves each group's answer where it was
  computed: only the boundary rows computed on one group for an owner on
  another cross, straight between the two groups. ``Zᵀ @ y`` reads a
  group's own rows in place, brings in only its foreign boundary rows,
  and sends its ``(P/G, K_hat[, s])`` partials home to ``rank_sum``. The
  shards are ``GroupTensor`` values; the Lanczos body's inner products
  take their partials on the groups (``core.lanczos``).
* ``psum`` keeps its replicated u-space at home, as the reference
  replicates it: each product's operands go out and the groups' answers
  come home (``oracle.mesh_products``), then the stacked space below.

The reference's scatters with ``mode="drop"`` and gathers with
``mode="fill"`` become gathers through
index maps built once per partition on the host (``comm_maps``), with -1
for "nothing here": every padding row reads 0 and adds 0. No step uses a
scatter-add over colliding indices, so no float atomics run on the card and
reruns are bitwise equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.lanczos import rank_sum
from repro_torch.distributed.mesh import GroupTensor

__all__ = ["OracleSpace", "make_comm_space", "comm_maps", "gather_rows",
           "group_maps", "crossing_slots", "make_mesh_boundary_space",
           "resolve_backend",
           "cheaper_backend", "backend_comm_bytes", "COMM_BACKENDS",
           "PATH_BACKENDS", "BACKEND_BYTES_KEY"]

COMM_BACKENDS = ("local", "psum", "boundary")

# historical path names -> backend families (P=1 always resolves to local)
PATH_BACKENDS = {"baseline": "psum", "liteopt": "boundary"}

# which comm_model entry a backend's collectives move
BACKEND_BYTES_KEY = {"psum": "baseline_bytes", "boundary": "liteopt_bytes"}


def backend_comm_bytes(backend: str, comm: dict) -> float:
    """Collective bytes one mode moves under ``backend`` (local: none)."""
    if backend == "local":
        return 0.0
    return float(comm[BACKEND_BYTES_KEY[backend]])


def cheaper_backend(comm: dict, model) -> str:
    """The modeled-cheaper of psum/boundary for one mode's comm model — the
    one auto rule plan costing and run-time resolution share."""
    return ("psum"
            if model.comm_seconds(comm["baseline_bytes"], "psum")
            < model.comm_seconds(comm["liteopt_bytes"], "boundary")
            else "boundary")


@dataclasses.dataclass
class OracleSpace:
    """What a comm backend hands the shared Lanczos body.

    All closures take vectors or width-``s`` panels. ``axis`` is None for a
    replicated u-space (``dim_u`` rows), P for a sharded one (``(P,
    dim_u)`` stacked rows) and the ``RankMesh`` for one sharded over a
    mesh's groups (``GroupTensor`` values). ``wrap_matvec_out`` is the
    backend's placement step alone — ``matvec = wrap_matvec_out ∘ zmv`` —
    so a fused Z-build that already holds ``Z_local @ V_1`` lifts it into
    the oracle space without a second pass over Z. ``seed(F)`` is the
    sketch warm start's ``Σ_p Z_pᵀ F[orig_p]``: the factor's leading
    columns ``F`` (a column slice, made contiguous here) gathered per local
    row through ``f_src``, summed over the ranks.
    """

    matvec: Callable  # x (K_hat[, s]) -> u-space vector/panel
    rmatvec: Callable  # u-space vector/panel -> (K_hat[, s]) replicated
    dim_u: int  # per-rank u-space rows
    axis: object  # None (replicated), P stacked ranks, or a RankMesh
    finalize: Callable  # left vectors -> (P, Lp, k) per-rank factor rows
    wrap_matvec_out: Callable = None  # local Z product -> u-space placement
    seed: Callable = None  # (L, w) factor column slice -> (K_hat, w) at home


def resolve_backend(path: str, P: int, comm: dict | None = None) -> str:
    """Backend for one mode step: ``"baseline"``/``"liteopt"`` (forced
    family), ``"auto"`` (the cheaper of psum/boundary under the current
    cost model, from the mode's analytic ``comm``) or a backend name. P = 1
    always resolves to ``local``."""
    if P == 1:
        return "local"
    if path in COMM_BACKENDS:
        return path
    if path == "auto":
        if comm is None:
            return "boundary"
        from repro_torch.core.calibrate import current_cost_model

        return cheaper_backend(comm, current_cost_model())
    try:
        return PATH_BACKENDS[path]
    except KeyError:
        raise ValueError(f"unknown path/backend {path!r}") from None


def comm_maps(mp) -> dict[str, np.ndarray]:
    """Gather maps of one ``ModePartition`` for the comm spaces (host work,
    once per plan). Each entry is a flat index into a stacked tensor, or -1
    where the reference's scatter drops or its gather fills:

    * ``gid_src`` (P, P*Lp): local row ``p*R_pad + r`` holding relabelled
      row g on rank p (the psum/local placement);
    * ``own_src`` (P, Lp): local row of rank p's owned row at offset o;
    * ``bnd_src``/``bnd_dst`` (P, B_pad): for rank p's j-th owned boundary
      slot, the foreign local row that computed it and the owned offset it
      adds into (``Lp`` = none);
    * ``u_src`` (P, R_pad): the entry of the flattened u-space a local row
      reads — its relabelled row id (the flattened ``(P, Lp)`` shards of the
      boundary space are the replicated vector of the psum space);
    * ``f_src`` (P, R_pad): the original (factor) row id of each local row,
      -1 for a row that holds no element. The sketch warm start gathers the
      mode's factor rows through it. The reference recovers the same ids in
      its step with a scatter-max over the element coordinates; here they
      come once per plan from each rank's real elements, which all share
      their row's original id.
    """
    P, R_pad, Lp, S_pad = mp.P, mp.R_pad, mp.Lp, mp.S_pad
    L_sent = P * Lp
    ranks = np.arange(P)[:, None]
    local = ranks * R_pad + np.arange(R_pad)[None, :]  # (P, R_pad)
    real = mp.row_gid < L_sent

    gid_src = np.full((P, L_sent), -1, np.int64)
    p_idx, r_idx = np.nonzero(real)
    gid_src[p_idx, mp.row_gid[p_idx, r_idx]] = local[p_idx, r_idx]

    own_src = np.full((P, Lp), -1, np.int64)
    p_idx, r_idx = np.nonzero(mp.row_owned & real)
    off = mp.row_gid[p_idx, r_idx] - p_idx * Lp
    own_src[p_idx, off] = local[p_idx, r_idx]

    slot_src = np.full(S_pad + 1, -1, np.int64)  # slot S_pad: the sentinel
    p_idx, r_idx = np.nonzero(mp.bnd_slot < S_pad)
    slot_src[mp.bnd_slot[p_idx, r_idx]] = local[p_idx, r_idx]
    bnd_src = slot_src[np.minimum(mp.own_bnd_slot, S_pad)]
    bnd_dst = mp.own_bnd_off.astype(np.int64)

    # a local row reads the u-shard entry of its relabelled row: the
    # flattened (P, Lp) shards are the global row vector, owned or not
    u_src = np.where(real, mp.row_gid, -1).astype(np.int64)

    f_src = np.full((P, R_pad), -1, np.int64)
    for p, k in enumerate(mp.e_per_rank):
        f_src[p, mp.local_rows[p, :k]] = mp.coords[p, :k, mp.mode]
    return {"gid_src": gid_src, "own_src": own_src, "bnd_src": bnd_src,
            "bnd_dst": bnd_dst, "u_src": u_src, "f_src": f_src}


def group_maps(maps: dict, P: int, R_pad: int, Lp: int, G: int
               ) -> list[dict[str, np.ndarray]]:
    """``comm_maps`` split over G device groups of P/G ranks (host work,
    once per plan) for ``make_mesh_boundary_space``. Per group g, indices
    into the group's own arrays (-1: nothing here):

    * ``own_src`` (P/G, Lp), ``bnd_dst`` (P/G, B_pad), ``f_src`` (P/G,
      R_pad): the stacked maps' rows of g's ranks, local rows counted from
      the group's first rank;
    * ``mv_send{h}``: g's local rows that computed a boundary slot owned by
      a rank of group h, in the order of h's ``(P/G, B_pad)`` owner table
      (``mv_send{g}`` stays on g);
    * ``mv_idx`` (P/G, B_pad): for g's owners' slot table, the entry of the
      concatenation over groups h of what h sent g;
    * ``rmv_send{h}`` (h != g): offsets into g's flattened ``(P/G*Lp)``
      shard of the owned rows that group h's ranks hold as boundary rows,
      in h's local row order;
    * ``u_idx`` (P/G, R_pad): the entry each local row reads of g's
      flattened shard followed by the concatenation over h != g of what h
      sent g.

    Boundary slots cross between groups only where their computing rank
    and their owner lie in different groups, once per product each way.
    """
    per = P // G
    own_src, bnd_src, bnd_dst = maps["own_src"], maps["bnd_src"], \
        maps["bnd_dst"]
    u_src, f_src = maps["u_src"], maps["f_src"]
    out = []
    for g in range(G):
        lo, hi = g * per, (g + 1) * per
        own = own_src[lo:hi]
        out.append({"own_src": np.where(own >= 0, own - lo * R_pad, -1),
                    "bnd_dst": bnd_dst[lo:hi], "f_src": f_src[lo:hi]})
    for g in range(G):  # Z @ x: owner group g's slot table
        lo, hi = g * per, (g + 1) * per
        src = bnd_src[lo:hi]
        from_grp = np.where(src >= 0, src // (per * R_pad), -1)
        idx = np.full(src.shape, -1, np.int64)
        base = 0
        for h in range(G):
            sel = from_grp == h
            out[h][f"mv_send{g}"] = src[sel] - h * per * R_pad
            idx[sel] = base + np.arange(int(sel.sum()))
            base += int(sel.sum())
        out[g]["mv_idx"] = idx
    for h in range(G):  # Zᵀ @ y: reader group h's local rows
        lo, hi = h * per, (h + 1) * per
        gid = u_src[lo:hi]
        owner_grp = np.where(gid >= 0, gid // (per * Lp), -1)
        idx = np.full(gid.shape, -1, np.int64)
        mine = owner_grp == h
        idx[mine] = gid[mine] - lo * Lp
        base = per * Lp
        for g in range(G):
            if g == h:
                continue
            sel = owner_grp == g
            out[g][f"rmv_send{h}"] = gid[sel] - g * per * Lp
            idx[sel] = base + np.arange(int(sel.sum()))
            base += int(sel.sum())
        out[h]["u_idx"] = idx
    return out


def crossing_slots(gmaps: list[dict]) -> int:
    """``S_x``: boundary slots whose computing rank and owner lie in
    different groups (what one product moves between groups, per column)."""
    G = len(gmaps)
    return sum(int(gmaps[h][f"mv_send{g}"].shape[0])
               for h in range(G) for g in range(G) if g != h)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over dim 0 with -1 reading 0; the result has shape
    ``idx.shape + src.shape[1:]``."""
    if src.shape[0] == 0:  # nothing to read: every index is -1
        return src.new_zeros(tuple(idx.shape) + tuple(src.shape[1:]))
    flat = idx.reshape(-1)
    out = src.index_select(0, flat.clamp(min=0))
    mask = (flat >= 0).reshape((-1,) + (1,) * (src.dim() - 1))
    out = torch.where(mask, out, torch.zeros((), dtype=src.dtype,
                                             device=src.device))
    return out.reshape(tuple(idx.shape) + tuple(src.shape[1:]))


def add_slots(flat: torch.Tensor, base: torch.Tensor, dst: torch.Tensor,
              vals: torch.Tensor, Lp: int, rounds: int) -> None:
    """``flat[base[r] + dst[r, j]] += vals[r, j]`` for every rank row r and
    slot column j, each destination row's adds in slot (column) order, as
    a loop over the columns would run them; ``dst == Lp`` is no slot (its
    rank's dump row). A destination row takes at most one slot from each
    other rank, so ``rounds`` = P - 1 rounds cover it: round k adds every
    row's k-th slot at once, in a few launches whatever the columns (a
    uni-policy plan has thousands)."""
    R, B = dst.shape
    if B == 0:
        return
    order = torch.argsort(dst, dim=1, stable=True)
    run = torch.gather(dst, 1, order)
    start = torch.ones_like(run, dtype=torch.bool)
    start[:, 1:] = run[:, 1:] != run[:, :-1]
    pos = torch.arange(B, device=dst.device).expand(R, B)
    first = torch.cummax(torch.where(start, pos, 0), dim=1).values
    occ = torch.empty_like(order).scatter_(1, order, pos - first)
    tail = tuple(vals.shape[2:])
    for k in range(rounds):
        take = (occ == k) & (dst < Lp)
        idx = (base[:, None] + torch.where(take, dst, Lp)).reshape(-1)
        add = torch.where(take.reshape((R * B,) + (1,) * len(tail)),
                          vals.reshape((R * B,) + tail),
                          torch.zeros((), dtype=vals.dtype,
                                      device=vals.device))
        flat[idx] = flat[idx] + add


def _psum_space(ms: dict, maps: dict, zmv, zrmv) -> OracleSpace:
    P, Lp = ms["P"], ms["Lp"]
    gid_src, u_src = maps["gid_src"], maps["u_src"]

    def wrap(local):  # (P*R_pad[, s]) -> (L_sent[, s]) replicated
        return rank_sum(gather_rows(local, gid_src))

    def rmatvec(u):  # u replicated (L_sent[, s])
        return rank_sum(zrmv(gather_rows(u, u_src)))

    def finalize(left):  # (L_sent, k) replicated -> (P, Lp, k) shards
        return left.reshape(P, Lp, *left.shape[1:])

    return OracleSpace(lambda x: wrap(zmv(x)), rmatvec, P * Lp, None,
                       finalize, wrap, _stacked_seed(maps, zrmv))


def _stacked_seed(maps: dict, zrmv) -> Callable:
    def seed(F):  # (L, w) -> (K_hat, w): one stacked rmatvec, ranks summed
        F = F.contiguous()
        return rank_sum(zrmv(gather_rows(F, maps["f_src"])))

    return seed


def _boundary_space(ms: dict, maps: dict, zmv, zrmv) -> OracleSpace:
    P, Lp = ms["P"], ms["Lp"]
    own_src, bnd_src, bnd_dst = maps["own_src"], maps["bnd_src"], \
        maps["bnd_dst"]
    u_src = maps["u_src"]
    rank_base = torch.arange(P, device=own_src.device) * (Lp + 1)

    def wrap(local):  # (P*R_pad[, s]) -> (P, Lp[, s]) owned-row shards
        tail = tuple(local.shape[1:])
        shard = torch.zeros((P, Lp + 1) + tail, dtype=local.dtype,
                            device=local.device)
        shard[:, :Lp] = gather_rows(local, own_src)
        flat = shard.view((P * (Lp + 1),) + tail)
        # boundary rows computed elsewhere add into their owner's row in
        # slot order (the sentinel Lp lands in a dump row)
        add_slots(flat, rank_base, bnd_dst, gather_rows(local, bnd_src), Lp,
                  P - 1)
        return shard[:, :Lp]

    def rmatvec(u_shard):  # (P, Lp[, s]) -> (K_hat[, s])
        u_flat = u_shard.reshape((P * Lp,) + tuple(u_shard.shape[2:]))
        return rank_sum(zrmv(gather_rows(u_flat, u_src)))

    return OracleSpace(lambda x: wrap(zmv(x)), rmatvec, Lp, P,
                       lambda left: left, wrap, _stacked_seed(maps, zrmv))


def make_mesh_boundary_space(ms: dict, gmaps: list, mesh, prods
                             ) -> OracleSpace:
    """The boundary space over a mesh's G device groups, its u-space
    sharded over them (``GroupTensor`` values of ``(P/G, Lp[, s])`` parts).

    ``gmaps[g]`` holds group g's ``group_maps`` on its device; ``prods[g]``
    is ``(mv, rmv)``, group g's stacked products (``oracle.group_products``:
    ``mv(x)`` its ``(P/G*R_pad[, s])`` rows, ``rmv(y)`` its ranks' ``Z_pᵀ
    y_p`` from ``(P/G, R_pad[, s])``). Each group places its product as
    ``_boundary_space`` does, the same adds in the same slot order, so the
    shards are the stacked space's rows. ``wrap_matvec_out`` takes the
    groups' products as a list (the fused first panel's, left on the
    groups).
    """
    Lp, G, per = ms["Lp"], mesh.G, mesh.per_group
    rank_base = mesh.each(lambda g: torch.arange(
        per, device=mesh.devices[g]) * (Lp + 1))

    def wrap(locals_):  # [(P/G*R_pad[, s]) per group] -> owned-row shards
        sends = mesh.each(lambda h: [
            gather_rows(locals_[h], gmaps[h][f"mv_send{g}"])
            for g in range(G)])
        inc = [[mesh.between(sends[h][g], h, g) for h in range(G)]
               for g in range(G)]

        def place(g):
            local, m = locals_[g], gmaps[g]
            tail = tuple(local.shape[1:])
            shard = torch.zeros((per, Lp + 1) + tail, dtype=local.dtype,
                                device=local.device)
            shard[:, :Lp] = gather_rows(local, m["own_src"])
            flat = shard.view((per * (Lp + 1),) + tail)
            bnd = gather_rows(torch.cat(inc[g]), m["mv_idx"])
            # the stacked space's adds over g's owners, in slot order
            add_slots(flat, rank_base[g], m["bnd_dst"], bnd, Lp,
                      G * per - 1)
            return shard[:, :Lp]

        return GroupTensor.build(mesh, place)

    def matvec(x):
        xs = [mesh.to_group(x, g) for g in range(G)]
        return wrap(mesh.each(lambda g: prods[g][0](xs[g])))

    def rmatvec(u):  # GroupTensor (P/G, Lp[, s]) parts -> (K_hat[, s])
        flat = mesh.each(lambda g: u.parts[g].reshape(
            (per * Lp,) + tuple(u.parts[g].shape[2:])))
        sends = mesh.each(lambda g: {
            h: gather_rows(flat[g], gmaps[g][f"rmv_send{h}"])
            for h in range(G) if h != g})
        inc = [[mesh.between(sends[g][h], g, h) for g in range(G) if g != h]
               for h in range(G)]
        partials = GroupTensor.build(mesh, lambda h: prods[h][1](
            gather_rows(torch.cat([flat[h], *inc[h]]), gmaps[h]["u_idx"])))
        return rank_sum(partials.home())

    def seed(F):  # (L, w) factor columns at home -> (K_hat, w)
        F = F.contiguous()
        Fs = [mesh.to_group(F, g, "factors") for g in range(G)]
        partials = GroupTensor.build(mesh, lambda g: prods[g][1](
            gather_rows(Fs[g], gmaps[g]["f_src"])))
        return rank_sum(partials.home())

    return OracleSpace(matvec, rmatvec, Lp, mesh, lambda left: left, wrap,
                       seed)


# on stacked ranks the local space is the psum space at P = 1: its gathers
# are the reference's drop/fill placements and a sum over one rank is that
# rank's value, so no collective-free variant is needed
_SPACES = {
    "local": _psum_space,
    "psum": _psum_space,
    "boundary": _boundary_space,
}


def make_comm_space(backend: str, ms: dict, maps: dict, zmv, zrmv
                    ) -> OracleSpace:
    """Wrap the stacked ranks' Z products into the global oracle.

    ``zmv(x)`` returns the ranks' products stacked as ``(P*R_pad[, s])``;
    ``zrmv(y)`` takes ``(P, R_pad[, s])`` and returns each rank's
    ``Z_pᵀ y_p`` stacked as ``(P, K_hat[, s])``. ``maps`` holds the device
    copies of ``comm_maps``.
    """
    if backend == "local" and ms["P"] != 1:
        raise ValueError("local comm backend requires P == 1")
    try:
        make = _SPACES[backend]
    except KeyError:
        raise ValueError(f"unknown comm backend {backend!r}") from None
    return make(ms, maps, zmv, zrmv)
