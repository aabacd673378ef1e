"""Turn the reference's state, given as numpy arrays, into the port's.

The JAX package hands its tensors, factor matrices and decompositions over as
numpy arrays (``np.asarray`` of a JAX array); these functions build the
port's counterparts from them, on an explicit device. They are also how the
entry points put a host ``SparseTensor`` on the device: ``device_coords``
keeps the device copy with the tensor, so a tensor crosses the bus once per
device.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.coo import SparseTensor
from repro_torch.device import indexed_device, resolve_device

__all__ = ["sparse_tensor", "factors", "decomposition", "device_coords",
           "kept_coords"]

_KEEP_LOCK = threading.Lock()  # guards the per-tensor memos' first entry


def sparse_tensor(coords, values, shape: Sequence[int]) -> SparseTensor:
    """The port's ``SparseTensor`` from reference COO arrays (copied)."""
    return SparseTensor(np.array(coords), np.array(values),
                        tuple(int(L) for L in shape))


def _f32(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    # a copy: arrays handed over from JAX are read-only
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def factors(arrays: Sequence, device: str | torch.device | None = None
            ) -> list[torch.Tensor]:
    """Factor matrices (numpy arrays or tensors) as float32 tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    return [_f32(f, dev) for f in arrays]


def decomposition(core, factor_arrays: Sequence,
                  device: str | torch.device | None = None):
    """A ``Decomposition`` from a reference core (or None) and factors."""
    from repro_torch.core.hooi import Decomposition

    dev = resolve_device(device)
    core_t = None if core is None else _f32(core, dev)
    return Decomposition(core=core_t, factors=factors(factor_arrays, dev))


def kept_coords(t: SparseTensor, device: str | torch.device
                ) -> tuple[torch.Tensor, torch.Tensor] | None:
    """The pair ``device_coords`` keeps for ``t`` on ``device``, or None
    when it has made none yet (then the next call copies)."""
    memo = getattr(t, "_device_coords", None)
    return None if memo is None else memo.get(indexed_device(device))


def device_coords(t: SparseTensor, device: str | torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(coords int32 (nnz, N), values float32 (nnz,)) of ``t`` on ``device``,
    the dtypes the reference's entry points use on its device.

    Kept with ``t``, one pair per device (``"cuda"`` and ``"cuda:0"`` are
    one): the first call for a (tensor, device) pair casts on the host and
    copies; later calls return the same two tensors, with no cast and no
    copy, as ``SparseTensor.fingerprint`` is kept on the premise that a
    tensor's arrays never change. The pair is shared by every caller, so
    it is read only, and it stays on the device while ``t`` lives. Two
    threads that miss at once both copy; the first pair stored is kept and
    returned to both.
    """
    dev = indexed_device(device)
    kept = kept_coords(t, dev)
    if kept is not None:
        return kept
    coords = torch.from_numpy(np.ascontiguousarray(t.coords, dtype=np.int32))
    values = torch.from_numpy(np.ascontiguousarray(t.values, dtype=np.float32))
    pair = (coords.to(dev), values.to(dev))
    with _KEEP_LOCK:
        memo = getattr(t, "_device_coords", None)
        if memo is None:
            memo = {}
            object.__setattr__(t, "_device_coords", memo)
        return memo.setdefault(dev, pair)
