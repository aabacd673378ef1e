"""Counting in place of sorting for the plan's host arrays, on a device.

The scheme, the partition and the metrics of a plan reduce (slice, rank)
pairs of one mode, whose keys ``slice * P + rank`` lie below ``P * L_n``.
Over such a bounded range a tally answers what the reference asks of
``np.unique``: the nonzero entries of a bincount of the keys over ``P*L_n``
bins are the sorted unique keys and its values their counts. Counted by
``rank * L_n + slice`` instead, as a ``(P, L_n)`` array, it gives the
owner of each slice, the distinct slices of each rank and the elements of
each rank without a sort.

``scope(t, device)`` opens a build. The first pass over the elements that
needs them uploads the coordinates once, as one ``(nnz, N)`` int32 array
(int64 where a mode is longer than int32 holds), and the values as float32;
every pass over the elements then runs in PyTorch on the scope's device:
``slice_sizes``, ``pair_counts`` and ``row_owner``, the policies' element
gathers and the partition's ordering and record gathers. Only what is
``O(P * L_n)`` and the final arrays come back. Inside a scope each mode's
slice sizes, each (mode, policy) pair count and owner map and each policy's
device copy are made once and shared by the scheme, the partition and the
metrics; when the scope ends nothing it made on the device stays allocated.
Outside a scope each function opens one for its own call. Every operation is
on integers or a float32 cast, so the arrays are the reference's, bit for
bit, on either device (``tests/test_torch_plan.py``; on the card
``tests/test_torch_cuda.py``).

Transfers run under the spans ``plan.upload`` and ``plan.download`` and
are counted as ``plan.upload_bytes`` and ``plan.download_bytes``
(``repro_torch.tracing``): the bytes that crossed to and from the device,
0 on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import plan_device

from .coo import SparseTensor

__all__ = ["scope", "device_coords", "device_values", "device_policy",
           "upload", "download", "to_host", "keep_policy", "key_dtype",
           "slice_sizes", "pair_counts", "owner_from_counts", "row_owner",
           "stable_order"]

_INT32_MAX = np.iinfo(np.int32).max
_CHUNK_BYTES = 1 << 28  # the most host bytes one step of an upload sends
_LOCAL = threading.local()


@dataclasses.dataclass
class _Tally:
    t: SparseTensor
    device: torch.device
    coords: torch.Tensor | None = None
    values: torch.Tensor | None = None
    sizes: dict = dataclasses.field(default_factory=dict)
    # id(policy) -> (policy, device copy); (mode, id(policy)) -> (policy,
    # value): the policy is held so that its id cannot be reused while the
    # scope lives
    policies: dict = dataclasses.field(default_factory=dict)
    pairs: dict = dataclasses.field(default_factory=dict)
    owners: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def scope(t: SparseTensor, device: str | torch.device | None = None):
    """Share this thread's tallies and device copies of ``t`` until the
    block ends (``device``: ``repro_torch.device.plan_device``). A scope
    opened inside another of the same tensor joins it, and its device."""
    outer = getattr(_LOCAL, "tally", None)
    if outer is not None and outer.t is t:
        yield
        return
    tl = _LOCAL.tally = _Tally(t, plan_device(device))
    try:
        yield
    finally:
        _LOCAL.tally = outer
        tl.coords = tl.values = None
        tl.policies.clear()


def _current(t: SparseTensor) -> _Tally:
    tl = getattr(_LOCAL, "tally", None)
    if tl is None or tl.t is not t:
        raise RuntimeError("no tally.scope is open for this tensor")
    return tl


def _moved(tl: _Tally, nbytes: int) -> int:
    return nbytes if tl.device.type != "cpu" else 0


def upload(t: SparseTensor, arr: np.ndarray, dtype: torch.dtype
           ) -> torch.Tensor:
    """``arr`` as a ``dtype`` tensor on the scope's device: sent as it is,
    a bounded number of rows at a time, and cast there."""
    tl = _current(t)
    out = torch.empty(arr.shape, dtype=dtype, device=tl.device)
    row = max(arr[:1].nbytes, 1)
    step = max(_CHUNK_BYTES // row, 1)
    with tracing.span("plan.upload"):
        for a in range(0, len(arr), step):
            part = np.require(arr[a:a + step], requirements="CW")
            out[a:a + step].copy_(torch.from_numpy(part).to(tl.device))
        tracing.count("plan.upload_bytes", _moved(tl, arr.nbytes))
    return out


def download(t: SparseTensor, dst: np.ndarray, src: torch.Tensor) -> None:
    """Copy the device tensor ``src`` into the contiguous numpy ``dst`` of
    the same dtype and size."""
    tl = _current(t)
    with tracing.span("plan.download"):
        torch.from_numpy(dst).copy_(src.reshape(dst.shape))
        tracing.count("plan.download_bytes", _moved(tl, dst.nbytes))


def to_host(t: SparseTensor, src: torch.Tensor) -> np.ndarray:
    """A new numpy array holding the device tensor ``src``."""
    dst = np.empty(tuple(src.shape), dtype=torch.empty(
        0, dtype=src.dtype).numpy().dtype)
    download(t, dst, src)
    return dst


def device_coords(t: SparseTensor) -> torch.Tensor:
    """The ``(nnz, N)`` coordinates on the scope's device, uploaded once."""
    tl = _current(t)
    if tl.coords is None:
        dtype = torch.int32 if max(t.shape, default=0) <= _INT32_MAX \
            else torch.int64
        tl.coords = upload(t, t.coords, dtype)
    return tl.coords


def device_values(t: SparseTensor) -> torch.Tensor:
    """The ``(nnz,)`` float32 values on the scope's device, uploaded once."""
    tl = _current(t)
    if tl.values is None:
        tl.values = upload(t, t.values, torch.float32)
    return tl.values


def keep_policy(t: SparseTensor, dev: torch.Tensor) -> np.ndarray:
    """Bring a policy built on the device back as the ``(nnz,)`` int32
    array a ``Scheme`` holds, and keep ``dev`` as its device copy."""
    tl = _current(t)
    policy = to_host(t, dev)
    tl.policies[id(policy)] = (policy, dev)
    return policy


def device_policy(t: SparseTensor, policy: np.ndarray) -> torch.Tensor:
    """``policy`` as int32 on the scope's device, uploaded once a scope."""
    tl = _current(t)
    hit = tl.policies.get(id(policy))
    if hit is not None and hit[0] is policy:
        return hit[1]
    dev = upload(t, np.asarray(policy), torch.int32)
    tl.policies[id(policy)] = (policy, dev)
    return dev


def key_dtype(bound: int) -> torch.dtype:
    """The narrower integer dtype that holds keys below ``bound``."""
    return torch.int32 if bound - 1 <= _INT32_MAX else torch.int64


def _by_policy(store: dict, mode: int, policy: np.ndarray, make):
    hit = store.get((mode, id(policy)))
    if hit is not None and hit[0] is policy:
        return hit[1]
    value = make()
    store[(mode, id(policy))] = (policy, value)
    return value


def slice_sizes(t: SparseTensor, mode: int) -> np.ndarray:
    """``t.slice_sizes(mode)``, once per scope."""
    with scope(t):
        tl = _current(t)
        if mode not in tl.sizes:
            col = device_coords(t)[:, mode]
            tl.sizes[mode] = to_host(
                t, torch.bincount(col, minlength=t.shape[mode]))
        return tl.sizes[mode]


def _count_pairs(t: SparseTensor, policy: np.ndarray, mode: int, P: int
                 ) -> np.ndarray:
    L = t.shape[mode]
    key = device_policy(t, policy).to(key_dtype(P * L), copy=True)
    key.mul_(L).add_(device_coords(t)[:, mode])
    counts = torch.bincount(key, minlength=P * L)
    del key
    if t.nnz <= _INT32_MAX:
        counts = counts.to(torch.int32)
    return to_host(t, counts).reshape(P, L)


def pair_counts(t: SparseTensor, policy: np.ndarray, mode: int, P: int
                ) -> np.ndarray:
    """``(P, L_n)`` counts: ``[p, l]`` is the number of elements of slice
    ``l`` that ``policy`` puts on rank ``p``; int32 when ``nnz`` fits.
    The reference's sorted unique (slice, rank) pairs are its nonzero
    entries in slice-major order, their counts its values."""
    with scope(t):
        return _by_policy(_current(t).pairs, mode, policy,
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
    with scope(t):
        return _by_policy(
            _current(t).owners, mode, policy,
            lambda: owner_from_counts(pair_counts(t, policy, mode, P)))


def stable_order(key: np.ndarray, bound: int) -> tuple[np.ndarray, np.ndarray]:
    """``(order, key[order])`` with ``order == np.argsort(key,
    kind="stable")``, for integer keys in ``[0, bound)``; the host's sort
    of the plan's ``O(L_n)`` keys (slices by size).

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
