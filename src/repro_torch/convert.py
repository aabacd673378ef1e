"""Turn the reference's state, given as numpy arrays, into the port's.

The JAX package hands its tensors, factor matrices and decompositions over as
numpy arrays (``np.asarray`` of a JAX array); these functions build the
port's counterparts from them, on an explicit device. They are also how the
entry points put a host ``SparseTensor`` on the device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.coo import SparseTensor
from repro_torch.device import resolve_device

__all__ = ["sparse_tensor", "factors", "decomposition", "device_coords"]


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


def device_coords(t: SparseTensor, device: torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(coords int32 (nnz, N), values float32 (nnz,)) of ``t`` on ``device``,
    the dtypes the reference's entry points use on its device."""
    coords = torch.from_numpy(np.ascontiguousarray(t.coords, dtype=np.int32))
    values = torch.from_numpy(np.ascontiguousarray(t.values, dtype=np.float32))
    return coords.to(device), values.to(device)
