"""The plain check of a distribution: each mode's partition holds every
element of the tensor exactly once, with its value.

A partition is judged from its host arrays: per rank its elements'
coordinates ``(E_pad, N)`` and values ``(E_pad,)``, the first ``count`` of
them real. Elements are compared by their keys (``tuckerbench.keys``): the
linear index below 2**63, the (head, tail) pair of int64 words from it up,
so no two coordinates share a key. Plain PyTorch; it imports neither the
program nor JAX.
"""

from __future__ import annotations

import torch

from tuckerbench.keys import lex_order, words

__all__ = ["key", "mismatches"]


def key(coords: torch.Tensor, shape) -> list[torch.Tensor]:
    """Each element's key: ``[linear index]`` below 2**63, ``[head, tail]``
    from it up."""
    return words([coords[:, m].to(torch.int64) for m in range(len(shape))],
                 shape)


def mismatches(ranks, want_key: list[torch.Tensor],
               want_values: torch.Tensor, shape, device) -> int:
    """Elements the partition gets wrong: missing, doubled, foreign or with
    another value (as float32, the precision the program computes in).

    ``ranks`` yields ``(coords, values, count)`` per rank (numpy or torch);
    ``want_key`` is the tensor's ``key``, sorted, and ``want_values`` its
    values in that order, on ``device``.
    """
    got, vals = [], []
    for coords, values, count in ranks:
        count = int(count)
        c = torch.as_tensor(coords[:count]).to(device)
        got.append(key(c, shape))
        vals.append(torch.as_tensor(values[:count]).to(device))
    got_key = [torch.cat(w) for w in zip(*got)]
    got_val = torch.cat(vals).to(torch.float32)
    n, want = got_key[0].numel(), want_key[0].numel()
    if n != want:
        return abs(n - want) + min(n, want)
    order = lex_order(got_key)
    bad = got_val[order] != want_values.to(torch.float32)
    for g, w in zip(got_key, want_key):
        bad |= g[order] != w
    return int(bad.sum())
