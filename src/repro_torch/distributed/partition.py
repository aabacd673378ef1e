"""Scheme -> padded per-rank arrays (the SPMD runtime's view of a policy).

The port's own copy of the reference's ``distributed/partition.py`` (pure
numpy, unchanged apart from this paragraph), so the port's partitions are
bit-identical to the reference's. The port stacks the P ranks along a
leading dimension on one device; the arrays below already have that shape.

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

from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import Scheme, row_owner_map

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
    quant = round_up_pow2 if pad_geometric else (lambda x: max(int(x), 1))
    P = scheme.P
    N = t.ndim
    L = t.shape[mode]
    policy = scheme.policy(mode).astype(np.int64)
    sigma = row_owner_map(t, policy, mode, P)  # (L,) owner per global row

    # ---- row relabeling: sort rows by (owner, gid) -> contiguous ownership
    order = np.lexsort((np.arange(L), sigma))
    # devices own exactly ceil(L/P) consecutive new ids; pad L to P*Lp
    Lp = -(-L // P)
    # new id of old row order[i] is i, BUT contiguity must respect quotas:
    # owner counts may differ from Lp; we re-balance by assigning overflow
    # rows of heavily-owning devices to the global tail. Simpler and exact:
    # give each device its sigma rows; devices with > Lp rows spill the
    # excess (empty-slice rows preferentially) to devices with < Lp.
    sizes = t.slice_sizes(mode)
    counts = np.bincount(sigma, minlength=P)
    new_gid = np.full(L, -1, dtype=np.int64)
    spill: list[int] = []
    next_free = np.zeros(P, dtype=np.int64)
    # prefer keeping non-empty rows with their sigma owner
    for p in range(P):
        rows_p = np.nonzero(sigma == p)[0]
        if len(rows_p) > Lp:
            # spill empty rows first (no traffic impact), then smallest slices
            keep_order = np.lexsort((rows_p, -sizes[rows_p]))
            keep = rows_p[keep_order[:Lp]]
            spill.extend(rows_p[keep_order[Lp:]].tolist())
            rows_p = keep
        new_gid[rows_p] = p * Lp + np.arange(len(rows_p))
        next_free[p] = len(rows_p)
    if spill:
        spill_arr = np.asarray(spill, dtype=np.int64)
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
    inv_perm = np.zeros(P * Lp, dtype=np.int64)
    inv_perm[:] = L  # sentinel for padded ids
    inv_perm[row_perm] = np.arange(L)
    inv_perm = inv_perm[: P * Lp]
    owner_of_new = np.arange(P * Lp) // Lp

    # ---- per-device element lists, padded
    e_per_rank = np.bincount(policy, minlength=P)
    E_pad = quant(int(e_per_rank.max()))
    coords = np.zeros((P, E_pad, N), dtype=np.int32)
    values = np.zeros((P, E_pad), dtype=np.float32)
    local_rows = np.zeros((P, E_pad), dtype=np.int32)
    row_gid_l: list[np.ndarray] = []
    r_per_rank = np.zeros(P, dtype=np.int64)

    elem_new_gid = row_perm[t.coords[:, mode]]
    for p in range(P):
        idx = np.nonzero(policy == p)[0]
        k = len(idx)
        # sort by new gid => local dense renumbering is monotone (kernel req)
        sub = idx[np.argsort(elem_new_gid[idx], kind="stable")]
        gids, lrows = np.unique(elem_new_gid[sub], return_inverse=True)
        coords[p, :k] = t.coords[sub]
        values[p, :k] = t.values[sub]
        local_rows[p, :k] = lrows
        r_per_rank[p] = len(gids)
        row_gid_l.append(gids)
    R_pad = quant(int(r_per_rank.max()))
    # padding elements -> last local row with value 0 (kernel-safe)
    for p in range(P):
        k = int(e_per_rank[p])
        if k < E_pad:
            local_rows[p, k:] = max(int(r_per_rank[p]) - 1, 0)

    L_sent = P * Lp  # out-of-range gid sentinel
    row_gid = np.full((P, R_pad), L_sent, dtype=np.int32)
    row_owned = np.zeros((P, R_pad), dtype=bool)
    for p in range(P):
        g = row_gid_l[p]
        row_gid[p, : len(g)] = g
        row_owned[p, : len(g)] = owner_of_new[g] == p

    # ---- boundary (foreign) rows: local rows owned elsewhere
    bnd_pairs = []  # (device, local_row_idx, new_gid)
    for p in range(P):
        foreign = np.nonzero(~row_owned[p] & (row_gid[p] < L_sent))[0]
        for r in foreign:
            bnd_pairs.append((p, int(r), int(row_gid[p, r])))
    S = len(bnd_pairs)
    S_pad = quant(S)
    bnd_slot = np.full((P, R_pad), S_pad, dtype=np.int32)
    for s, (p, r, g) in enumerate(bnd_pairs):
        bnd_slot[p, r] = s
    # owner side: for each slot, the owning device and the offset in its shard
    own_lists: list[list[tuple[int, int]]] = [[] for _ in range(P)]
    for s, (_p, _r, g) in enumerate(bnd_pairs):
        op = int(owner_of_new[g])
        own_lists[op].append((s, g - op * Lp))
    B_pad = quant(max((len(x) for x in own_lists), default=0))
    own_bnd_slot = np.full((P, B_pad), S_pad, dtype=np.int32)
    own_bnd_off = np.full((P, B_pad), Lp, dtype=np.int32)  # Lp = drop sentinel
    for p in range(P):
        for j, (s, off) in enumerate(own_lists[p]):
            own_bnd_slot[p, j] = s
            own_bnd_off[p, j] = off

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
    return tuple(make_mode_partition(t, scheme, n, pad_geometric=pad_geometric)
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
