"""The plain check of a distribution: each mode's partition holds every
element of the tensor exactly once, with its value.

A partition is judged from its host arrays: per rank its elements'
coordinates ``(E_pad, N)`` and values ``(E_pad,)``, the first ``count`` of
them real. Plain PyTorch; it imports neither the program nor JAX.
"""

from __future__ import annotations

import torch

__all__ = ["linear_index", "mismatches"]


def linear_index(coords: torch.Tensor, shape) -> torch.Tensor:
    key = coords[:, 0].to(torch.int64)
    for m in range(1, len(shape)):
        key = key * int(shape[m]) + coords[:, m].to(torch.int64)
    return key


def mismatches(ranks, want_key: torch.Tensor, want_values: torch.Tensor,
               shape, device) -> int:
    """Elements the partition gets wrong: missing, doubled, foreign or with
    another value (as float32, the precision the program computes in).

    ``ranks`` yields ``(coords, values, count)`` per rank (numpy or torch);
    ``want_key`` is the tensor's sorted linear index and ``want_values``
    its values in that order, on ``device``.
    """
    keys, vals = [], []
    for coords, values, count in ranks:
        count = int(count)
        c = torch.as_tensor(coords[:count]).to(device)
        keys.append(linear_index(c, shape))
        vals.append(torch.as_tensor(values[:count]).to(device))
    got_key = torch.cat(keys)
    got_val = torch.cat(vals).to(torch.float32)
    if got_key.numel() != want_key.numel():
        return abs(got_key.numel() - want_key.numel()) + int(
            min(got_key.numel(), want_key.numel()))
    order = torch.argsort(got_key)
    got_key, got_val = got_key[order], got_val[order]
    bad = (got_key != want_key) | (got_val != want_values.to(torch.float32))
    return int(bad.sum())
