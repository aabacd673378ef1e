"""Keys of coordinates in linear order, also past a 64-bit linear index.

Below 2**63 a coordinate's key is one int64 word, its linear index (the
last mode fastest). From 2**63 up it is two words: the head, the linear
index over the leading modes, as many as stay under 2**63, and the tail,
the linear index over the remaining modes. Lexicographic order on the words
is linear order, so the generator and the partition check sort, find
distinct coordinates and compare by words. A shape whose modes cannot be
split into two such words is refused. Plain PyTorch.
"""

from __future__ import annotations

import math

import torch

__all__ = ["groups", "words", "unravel", "lex_order", "starts"]

LIMIT = 2 ** 63


def groups(shape) -> list[tuple[int, ...]]:
    """The modes of each word: all of them below ``LIMIT``, else the head's
    leading modes and the tail's rest."""
    shape = [int(L) for L in shape]
    N = len(shape)
    if math.prod(shape) < LIMIT:
        return [tuple(range(N))]
    h = 0
    while math.prod(shape[:h + 1]) < LIMIT:
        h += 1
    if math.prod(shape[h:]) >= LIMIT:
        raise ValueError(f"shape {tuple(shape)} overflows two 64-bit words "
                         f"of a linear index")
    return [tuple(range(h)), tuple(range(h, N))]


def words(cols, shape) -> list[torch.Tensor]:
    """The key of each coordinate, from its ``N`` int64 columns."""
    out = []
    for g in groups(shape):
        key = cols[g[0]]
        for m in g[1:]:
            key = key * int(shape[m]) + cols[m]
        out.append(key)
    return out


def unravel(keys, shape) -> torch.Tensor:
    """int64 ``(n, N)`` coordinates of the keys ``keys`` (``words``'s)."""
    coords = torch.empty((keys[0].numel(), len(shape)), dtype=torch.int64,
                         device=keys[0].device)
    for rest, g in zip(keys, groups(shape)):
        for m in reversed(g):
            coords[:, m] = rest % int(shape[m])
            rest = rest // int(shape[m])
    return coords


def lex_order(keys) -> torch.Tensor:
    """The stable permutation that sorts by the keys: one stable sort per
    word, the last word first, so equal keys keep their order."""
    order = torch.sort(keys[-1], stable=True).indices
    for w in reversed(keys[:-1]):
        order = order[torch.sort(w[order], stable=True).indices]
    return order


def starts(keys) -> torch.Tensor:
    """Of sorted keys: True where a key differs from the one before it."""
    out = torch.ones(keys[0].numel(), dtype=torch.bool, device=keys[0].device)
    diff = keys[0][1:] != keys[0][:-1]
    for w in keys[1:]:
        diff |= w[1:] != w[:-1]
    out[1:] = diff
    return out
