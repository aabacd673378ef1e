"""Counting in place of sorting for the plan's host arrays.

The scheme, the partition and the metrics of a plan reduce (slice, rank)
pairs of one mode, whose keys ``slice * P + rank`` lie below ``P * L_n``.
Over such a bounded range a tally answers what the reference asks of
``np.unique``: the nonzero entries of ``np.bincount(key, minlength=P*L_n)``
are the sorted unique keys and its values their counts. Counted by
``rank * L_n + slice`` instead, as a ``(P, L_n)`` array, it gives the
owner of each slice, the distinct slices of each rank and the elements of
each rank without a sort. Orderings that remain (elements by rank and new row, slices by size) are stable sorts of
bounded keys; ``stable_order`` sorts them packed with their positions, so
one unstable sort of distinct keys gives the stable permutation.

``scope(t)`` opens a build: inside it each mode's slice sizes, each (mode,
policy) pair count and owner map, and one record per element of its
int32 coordinates and float32 value are made once and shared by the
scheme, the partition and the metrics. Outside a scope every function
computes afresh. The arrays are the reference's, bit for bit
(``tests/test_torch_plan.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np

from .coo import SparseTensor

__all__ = ["scope", "slice_sizes", "pair_counts", "owner_from_counts",
           "row_owner", "stable_order", "records", "take_records"]

_INT32_MAX = np.iinfo(np.int32).max
_LOCAL = threading.local()


@dataclasses.dataclass
class _Tally:
    t: SparseTensor
    sizes: dict = dataclasses.field(default_factory=dict)
    # (mode, id(policy)) -> (policy, value); the policy is held so that its
    # id cannot be reused while the scope lives
    pairs: dict = dataclasses.field(default_factory=dict)
    owners: dict = dataclasses.field(default_factory=dict)
    records: np.ndarray | None = None


@contextlib.contextmanager
def scope(t: SparseTensor):
    """Share this thread's tallies of ``t`` until the block ends. A scope
    opened inside another of the same tensor joins it."""
    outer = getattr(_LOCAL, "tally", None)
    if outer is not None and outer.t is t:
        yield
        return
    _LOCAL.tally = _Tally(t)
    try:
        yield
    finally:
        _LOCAL.tally = outer


def _current(t: SparseTensor) -> _Tally | None:
    tl = getattr(_LOCAL, "tally", None)
    return tl if tl is not None and tl.t is t else None


def _by_policy(store: dict, mode: int, policy: np.ndarray, make):
    hit = store.get((mode, id(policy)))
    if hit is not None and hit[0] is policy:
        return hit[1]
    value = make()
    store[(mode, id(policy))] = (policy, value)
    return value


def slice_sizes(t: SparseTensor, mode: int) -> np.ndarray:
    """``t.slice_sizes(mode)``, once per scope."""
    tl = _current(t)
    if tl is None:
        return t.slice_sizes(mode)
    if mode not in tl.sizes:
        tl.sizes[mode] = t.slice_sizes(mode)
    return tl.sizes[mode]


def _count_pairs(t: SparseTensor, policy: np.ndarray, mode: int, P: int
                 ) -> np.ndarray:
    L = t.shape[mode]
    key = np.multiply(policy, L, dtype=np.int64)
    key += t.coords[:, mode]
    counts = np.bincount(key, minlength=P * L)
    del key
    if t.nnz <= _INT32_MAX:
        counts = counts.astype(np.int32)
    return counts.reshape(P, L)


def pair_counts(t: SparseTensor, policy: np.ndarray, mode: int, P: int
                ) -> np.ndarray:
    """``(P, L_n)`` counts: ``[p, l]`` is the number of elements of slice
    ``l`` that ``policy`` puts on rank ``p``; int32 when ``nnz`` fits.
    The reference's sorted unique (slice, rank) pairs are its nonzero
    entries in slice-major order, their counts its values."""
    tl = _current(t)
    if tl is None:
        return _count_pairs(t, policy, mode, P)
    return _by_policy(tl.pairs, mode, policy,
                      lambda: _count_pairs(t, policy, mode, P))


def owner_from_counts(counts: np.ndarray) -> np.ndarray:
    """Owner of each slice from its ``(P, L)`` pair counts: the rank with
    the most elements, the highest rank among equal counts (the last of
    the reference's sort by (slice, count)); empty slices round-robin over
    the ranks in slice order. int64 ``(L,)``."""
    P, L = counts.shape
    owner = np.zeros(L, dtype=np.int64)
    best = counts[0].copy()
    for p in range(1, P):
        np.copyto(owner, p, where=counts[p] >= best)
        np.maximum(best, counts[p], out=best)
    empty = best == 0
    owner[empty] = np.arange(int(np.count_nonzero(empty))) % P
    return owner


def row_owner(t: SparseTensor, policy: np.ndarray, mode: int, P: int
              ) -> np.ndarray:
    """``owner_from_counts`` of ``pair_counts``, once per scope."""
    tl = _current(t)
    make = lambda: owner_from_counts(pair_counts(t, policy, mode, P))  # noqa: E731
    if tl is None:
        return make()
    return _by_policy(tl.owners, mode, policy, make)


def stable_order(key: np.ndarray, bound: int) -> tuple[np.ndarray, np.ndarray]:
    """``(order, key[order])`` with ``order == np.argsort(key,
    kind="stable")``, for integer keys in ``[0, bound)``.

    Each key is packed above its position into one int64, so the packed
    words are distinct and one unstable sort of them orders equal keys by
    position. Keys too wide to pack sort stably as they are.
    """
    n = len(key)
    b = max(n - 1, 0).bit_length()
    if (max(int(bound), 1) - 1).bit_length() + b > 62:
        order = np.argsort(key, kind="stable")
        return order, key[order]
    packed = np.left_shift(key, b, dtype=np.int64)
    packed |= np.arange(n, dtype=np.int64)
    packed.sort()
    order = packed & ((1 << b) - 1)
    packed >>= b
    return order, packed


def records(t: SparseTensor) -> np.ndarray:
    """One ``(nnz,)`` record per element, once per scope: its int32
    coordinates (field ``c``) and its float32 value (``v``), so that one
    gather moves both (``take_records``)."""
    tl = _current(t)
    if tl is not None and tl.records is not None:
        return tl.records
    N = t.ndim
    words = np.empty((t.nnz, N + 1), dtype=np.int32)
    words[:, :N] = t.coords
    words[:, N] = t.values.astype(np.float32).view(np.int32)
    rec = words.view(np.dtype({"names": ["c", "v"],
                               "formats": [f"V{4 * N}", "f4"],
                               "offsets": [0, 4 * N],
                               "itemsize": 4 * (N + 1)})).reshape(t.nnz)
    if tl is not None:
        tl.records = rec
    return rec


def take_records(rec: np.ndarray, idx: np.ndarray, coords: np.ndarray,
                 values: np.ndarray) -> None:
    """Fill the contiguous int32 ``coords`` ``(k, N)`` and float32
    ``values`` ``(k,)`` with the elements ``idx`` of ``records``."""
    got = np.take(rec, idx)
    coords.view(rec.dtype["c"]).reshape(len(idx))[...] = got["c"]
    values[...] = got["v"]
