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
u-space vector is a ``(P, Lp[, s])`` tensor. Over a mesh of device groups
(``repro_torch.distributed.mesh``) the maps and every space below live at
the mesh's home, unchanged: what crosses between groups is only the Z
products' operands and answers (``oracle.mesh_products``: ``x`` or each
group's rows of ``y`` out, its ``(P/G*R_pad[, s])`` or ``(P/G, K_hat[,
s])`` answer back), and the factors and first panel each group's Z-build
reads, and the fused first panel's product back. The u-space is not
sharded over the groups' devices.

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

__all__ = ["OracleSpace", "make_comm_space", "comm_maps", "gather_rows",
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
    replicated u-space (``dim_u`` rows) and P for a sharded one (``(P,
    dim_u)`` stacked rows). ``wrap_matvec_out`` is the backend's placement
    step alone — ``matvec = wrap_matvec_out ∘ zmv`` — so a fused Z-build
    that already holds ``Z_local @ V_1`` lifts it into the oracle space
    without a second pass over Z.
    """

    matvec: Callable  # x (K_hat[, s]) -> u-space vector/panel
    rmatvec: Callable  # u-space vector/panel -> (K_hat[, s]) replicated
    dim_u: int  # per-rank u-space rows
    axis: int | None  # ranks the u-space is sharded over (None: replicated)
    finalize: Callable  # left vectors -> (P, Lp, k) per-rank factor rows
    wrap_matvec_out: Callable = None  # local Z product -> u-space placement


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


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over dim 0 with -1 reading 0; the result has shape
    ``idx.shape + src.shape[1:]``."""
    flat = idx.reshape(-1)
    out = src.index_select(0, flat.clamp(min=0))
    mask = (flat >= 0).reshape((-1,) + (1,) * (src.dim() - 1))
    out = torch.where(mask, out, torch.zeros((), dtype=src.dtype,
                                             device=src.device))
    return out.reshape(tuple(idx.shape) + tuple(src.shape[1:]))


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
                       finalize, wrap)


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
        # boundary rows computed elsewhere add into their owner's row, one
        # slot column at a time: within a column each rank adds to its own
        # row (the sentinel Lp lands in a dump row), so no two writes of a
        # column collide and the sums run in slot order
        for j in range(bnd_src.shape[1]):
            dst = rank_base + bnd_dst[:, j]
            flat[dst] = flat[dst] + gather_rows(local, bnd_src[:, j])
        return shard[:, :Lp]

    def rmatvec(u_shard):  # (P, Lp[, s]) -> (K_hat[, s])
        u_flat = u_shard.reshape((P * Lp,) + tuple(u_shard.shape[2:]))
        return rank_sum(zrmv(gather_rows(u_flat, u_src)))

    return OracleSpace(lambda x: wrap(zmv(x)), rmatvec, Lp, P,
                       lambda left: left, wrap)


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
