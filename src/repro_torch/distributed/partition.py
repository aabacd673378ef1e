"""Scheme -> padded per-rank arrays (the SPMD runtime's view of a policy).

The port's version of the reference's ``distributed/partition.py``: it
computes the reference's host arrays by counting and by one ordering of the
elements per mode where the reference sorts each rank apart, and
``tests/test_torch_plan.py`` holds them bitwise equal to the reference's.
The per-element passes (the key, its stable order, the local rows and the
gather of each rank's records) run on the plan's device (``core/tally.py``)
and are copied straight into the numpy arrays; the relabelling and the
boundary slots are ``O(P * R_pad)`` host work. The port stacks the P ranks
along a leading dimension on one device; the arrays below already have that
shape.

The paper's runtime hands each MPI rank a ragged list of elements. SPMD
hardware wants identical static shapes everywhere, so load imbalance
literally becomes padding (dead work on every device) — this is where Lite's
``E_max <= ceil(|E|/P)`` and ``R_max <= ceil(L/P)+2`` bounds pay off: they
minimize exactly the two padded dimensions (E_pad, R_pad).

Also computed here: the *row relabeling* for the optimized collective path.
We permute mode-n row ids so that every device's owned rows (sigma_n) are a
contiguous block — then the paper's point-to-point owner reduction becomes a
reduce-scatter, and the only cross-device rows are the split (stage-2)
slices, of which Lite guarantees <= 2 per device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import tally
from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import Scheme

__all__ = [
    "ModePartition",
    "make_mode_partition",
    "make_mode_partitions",
    "comm_model",
    "round_up_pow2",
]


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1) — the pad quantum for streaming.

    Compiled mode steps are keyed on the padded dimensions, so any growth in
    E_pad/R_pad forces a re-jit. Quantizing pads geometrically gives shape
    *stability* under appends: a batch that grows the bottleneck rank's
    element count by less than the remaining pow2 slack keeps every compiled
    step valid (at most 2x padding waste — dead scatter work on values that
    are zero anyway).
    """
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class ModePartition:
    """Everything one HOOI mode step needs, padded to static shapes.

    Sentinel conventions (the reference's; its jnp scatters and gathers drop
    or fill them, the port's comm spaces mask them explicitly):
      * padding elements: values 0, local_row = the rank's *last real* row
        (``max(r_p - 1, 0)``) — value 0 makes them no-ops in the scatter-add,
        and reusing the last real id keeps each rank's element list sorted by
        dense local row id (the kron_segsum precondition)
      * padding local rows: row_gid = L_perm (== P*Lp, out of range)
      * non-boundary rows: bnd_slot = S_pad (out of range)
    """

    mode: int
    P: int
    L: int
    N: int
    E_pad: int
    R_pad: int
    Lp: int  # owned rows per device (ceil(L/P)), post-relabel
    S_pad: int  # global boundary (split-row) slots

    coords: np.ndarray  # (P, E_pad, N) int32 — original coords (mode col too)
    values: np.ndarray  # (P, E_pad) f32
    local_rows: np.ndarray  # (P, E_pad) int32 in [0, R_pad)
    row_gid: np.ndarray  # (P, R_pad) int32 — *relabelled* global row id
    row_owned: np.ndarray  # (P, R_pad) bool — owner(sigma) == this device
    bnd_slot: np.ndarray  # (P, R_pad) int32 — slot id if foreign else S_pad
    own_bnd_slot: np.ndarray  # (P, B_pad) int32 — slots this device owns
    own_bnd_off: np.ndarray  # (P, B_pad) int32 — offset of that row in shard
    B_pad: int

    row_perm: np.ndarray  # (L,) old gid -> new gid
    inv_perm: np.ndarray  # (L,) new gid -> old gid

    # bookkeeping for reporting
    r_per_rank: np.ndarray  # (P,)
    e_per_rank: np.ndarray  # (P,)


def make_mode_partition(
    t: SparseTensor, scheme: Scheme, mode: int, *, pad_geometric: bool = False
) -> ModePartition:
    """Build the padded SPMD view of ``scheme`` along ``mode``.

    ``pad_geometric=True`` rounds every padded dimension (E_pad, R_pad,
    S_pad, B_pad) up to the next power of two — the streaming scheduler's
    compiled-shape stability knob (see ``round_up_pow2``). Default off:
    one-shot decompositions keep the tight pads.
    """
    with tally.scope(t):
        return _mode_partition(t, scheme, mode, pad_geometric)


def _mode_partition(t: SparseTensor, scheme: Scheme, mode: int,
                    pad_geometric: bool) -> ModePartition:
    quant = round_up_pow2 if pad_geometric else (lambda x: max(int(x), 1))
    P = scheme.P
    N = t.ndim
    L = t.shape[mode]
    policy = scheme.policy(mode)
    pairs = tally.pair_counts(t, policy, mode, P)  # (P, L) elements a rank
    sigma = tally.row_owner(t, policy, mode, P)  # (L,) owner per global row

    # ---- row relabeling: contiguous ownership
    # devices own exactly ceil(L/P) consecutive new ids; pad L to P*Lp
    Lp = -(-L // P)
    # owner counts may differ from Lp; we re-balance by assigning overflow
    # rows of heavily-owning devices to the global tail. Simpler and exact:
    # give each device its sigma rows; devices with > Lp rows spill the
    # excess (empty-slice rows preferentially) to devices with < Lp.
    sizes = tally.slice_sizes(t, mode)
    new_gid = np.full(L, -1, dtype=np.int64)
    spill: list[np.ndarray] = []
    next_free = np.zeros(P, dtype=np.int64)
    # prefer keeping non-empty rows with their sigma owner
    for p in range(P):
        rows_p = np.nonzero(sigma == p)[0]
        if len(rows_p) > Lp:
            # spill empty rows first (no traffic impact), then smallest
            # slices: rows by size descending, ascending among equal sizes
            s_p = sizes[rows_p]
            top = int(s_p.max())
            keep_order = tally.stable_order(top - s_p, top + 1)[0]
            spill.append(rows_p[keep_order[Lp:]])
            rows_p = rows_p[keep_order[:Lp]]
        new_gid[rows_p] = p * Lp + np.arange(len(rows_p))
        next_free[p] = len(rows_p)
    if spill:
        spill_arr = np.concatenate(spill)
        si = 0
        for p in range(P):
            free = Lp - next_free[p]
            if free <= 0:
                continue
            take = spill_arr[si : si + free]
            new_gid[take] = p * Lp + next_free[p] + np.arange(len(take))
            si += len(take)
        assert si == len(spill_arr)
    assert (new_gid >= 0).all()
    row_perm = new_gid
    inv_perm = np.full(P * Lp, L, dtype=np.int64)  # L: sentinel, padded ids
    inv_perm[row_perm] = np.arange(L)
    # the owner of new id g is g // Lp

    # ---- per-device element lists, padded: one stable ordering of all
    # elements by (rank, new gid) => each rank's elements in order of their
    # dense local row (kernel req), equal rows in element order
    e_per_rank = pairs.sum(axis=1, dtype=np.int64)
    r_per_rank = np.array([np.count_nonzero(c) for c in pairs], dtype=np.int64)
    E_pad = quant(int(e_per_rank.max()))
    R_pad = quant(int(r_per_rank.max()))
    coords = np.zeros((P, E_pad, N), dtype=np.int32)
    values = np.zeros((P, E_pad), dtype=np.float32)
    local_rows = np.zeros((P, E_pad), dtype=np.int32)
    L_sent = P * Lp  # out-of-range gid sentinel
    row_gid = np.full((P, R_pad), L_sent, dtype=np.int32)

    c = tally.device_coords(t)
    kdt = tally.key_dtype(P * L_sent)
    key = tally.device_policy(t, policy).to(kdt, copy=True)
    key.mul_(L_sent).add_(
        tally.upload(t, row_perm, kdt).index_select(0, c[:, mode]))
    key, order = torch.sort(key, stable=True)
    # first element of each distinct (rank, row): its running count less
    # one within the rank is the element's dense local row
    first = torch.ones(len(key), dtype=torch.bool, device=key.device)
    torch.ne(key[1:], key[:-1], out=first[1:])
    gids = tally.to_host(t, key[first])  # the R_sum distinct keys, in order
    del key
    v = tally.device_values(t)
    bounds = np.concatenate([[0], np.cumsum(e_per_rank)])
    rbounds = np.concatenate([[0], np.cumsum(r_per_rank)])
    for p in range(P):
        a, b = int(bounds[p]), int(bounds[p + 1])
        k = b - a
        idx = order[a:b]
        tally.download(t, coords[p, :k], c.index_select(0, idx))
        tally.download(t, values[p, :k], v.index_select(0, idx))
        tally.download(t, local_rows[p, :k],
                       torch.cumsum(first[a:b], 0, dtype=torch.int32).sub_(1))
        g = gids[rbounds[p]:rbounds[p + 1]] - p * L_sent
        row_gid[p, : len(g)] = g
        # padding elements -> last local row with value 0 (kernel-safe)
        if k < E_pad:
            local_rows[p, k:] = max(int(r_per_rank[p]) - 1, 0)
    row_owned = (row_gid < L_sent) & (row_gid // Lp == np.arange(P)[:, None])

    # ---- boundary (foreign) rows: local rows owned elsewhere, as
    # (device, local_row_idx) in that order; slot s is the s-th of them
    fp, fr = np.nonzero(~row_owned & (row_gid < L_sent))
    fg = row_gid[fp, fr].astype(np.int64)
    S = len(fp)
    S_pad = quant(S)
    bnd_slot = np.full((P, R_pad), S_pad, dtype=np.int32)
    bnd_slot[fp, fr] = np.arange(S)
    # owner side: for each slot, the owning device and the offset in its
    # shard; each device's slots in slot order
    op = fg // Lp
    per_owner = np.bincount(op, minlength=P)
    B_pad = quant(int(per_owner.max()))
    own_bnd_slot = np.full((P, B_pad), S_pad, dtype=np.int32)
    own_bnd_off = np.full((P, B_pad), Lp, dtype=np.int32)  # Lp = drop sentinel
    slots = np.argsort(op, kind="stable")
    op_s = op[slots]
    j = np.arange(S) - np.concatenate([[0], np.cumsum(per_owner)])[op_s]
    own_bnd_slot[op_s, j] = slots
    own_bnd_off[op_s, j] = fg[slots] - op_s * Lp

    return ModePartition(
        mode=mode, P=P, L=L, N=N, E_pad=E_pad, R_pad=R_pad, Lp=Lp,
        S_pad=S_pad, coords=coords, values=values, local_rows=local_rows,
        row_gid=row_gid, row_owned=row_owned, bnd_slot=bnd_slot,
        own_bnd_slot=own_bnd_slot, own_bnd_off=own_bnd_off, B_pad=B_pad,
        row_perm=row_perm, inv_perm=inv_perm,
        r_per_rank=r_per_rank, e_per_rank=e_per_rank,
    )


def make_mode_partitions(
    t: SparseTensor, scheme: Scheme, *, pad_geometric: bool = False
) -> tuple[ModePartition, ...]:
    """All N mode partitions for a scheme (the padded SPMD view of a plan)."""
    with tally.scope(t):  # one upload for every mode
        return tuple(make_mode_partition(t, scheme, n,
                                         pad_geometric=pad_geometric)
                     for n in range(t.ndim))


def comm_model(mp: ModePartition, khat: int, niter: int) -> dict:
    """Analytic bytes moved per device per HOOI mode (f32).

    psum of an n-vector moves ~2n(P-1)/P words per device (ring allreduce).
    """
    ring = 2.0 * (mp.P - 1) / mp.P
    q = 2 * niter  # oracle queries (matvec+rmatvec per iteration)
    base = q * (mp.P * mp.Lp * ring + khat * ring) * 4
    opt = q * (mp.S_pad * ring + khat * ring) * 4
    return {"baseline_bytes": base, "liteopt_bytes": opt,
            "boundary_rows": mp.S_pad}
