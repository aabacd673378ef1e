"""Draw the benchmark's sparse tensors on the device, from a seed.

A PyTorch rewrite of the distribution that
``repro_torch.data.tensors.synth_tensor`` draws from, so that a
FROSTT-sized tensor takes seconds instead of the host's minutes:

* each mode's coordinate has a Zipf(alpha) marginal over its slices
  (``p(r) ~ r**-alpha`` over ranks ``1..L``, drawn by inverse CDF; alpha <= 0
  is uniform), its ranks put in random positions by a permutation drawn once
  per mode;
* a share ``hub_fraction`` of the draws has its coordinate in each hub mode
  replaced by one slice drawn once per mode (enron's large slices);
* values are standard normal, and the values of draws that land on the same
  coordinate are summed, as ``SparseTensor.dedup`` sums them.

Only the seed and the count differ from ``synth_tensor``. That function
deduplicates one batch of ``nnz`` draws and so holds fewer distinct
nonzeros than asked (nell-2's 76.9M draws give 61.4M, enron's 54.2M give
35.8M). This one keeps drawing in rounds from the same distribution until
it holds the requested number of distinct coordinates, and then keeps
exactly the draws up to the one at which the last of them first appeared.
So its duplicates are the draws that fall on a coordinate already held:
more of them than ``synth_tensor`` sums (it draws more in all), which makes
the summed values of the hottest coordinates somewhat larger, and the
tensor holds more of the distribution's tail than a one-batch draw would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["draw_tensor", "MAX_ROUNDS"]

MAX_ROUNDS = 40  # rounds of top-up draws before the generator gives up


def _cdf(L: int, alpha: float, device) -> torch.Tensor:
    ranks = torch.arange(1, L + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(ranks ** (-float(alpha)), 0)
    return cdf / cdf[-1]


def _round(n: int, shape, cdfs, perms, hubs, hub_fraction, g, device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` draws: their linear coordinates (int64) and values (f64)."""
    N = len(shape)
    cols = []
    for m in range(N):
        if cdfs[m] is None:
            cols.append(torch.randint(0, shape[m], (n,), generator=g,
                                      device=device))
            continue
        u = torch.rand(n, dtype=torch.float64, generator=g, device=device)
        idx = torch.searchsorted(cdfs[m], u, side="left")
        cols.append(perms[m][idx.clamp_(max=shape[m] - 1)])
    if hubs:
        k = int(n * hub_fraction)
        pick = torch.randperm(n, generator=g, device=device)[:k]
        for m, slice_ in hubs.items():
            cols[m][pick] = slice_
    key = cols[0]
    for m in range(1, N):
        key = key * shape[m] + cols[m]
    values = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    return key, values


def draw_tensor(shape, nnz: int, alphas, hub_fraction: float = 0.0,
                hub_modes=(), seed: int = 0, device="cuda"
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exactly ``nnz`` distinct coordinates of ``shape`` and their values.

    Returns ``(coords, values)`` on the host: int64 ``(nnz, N)`` sorted by
    linear index, and float64 ``(nnz,)``. The same seed gives the same
    arrays on the same kind of device.
    """
    shape = tuple(int(L) for L in shape)
    N = len(shape)
    if isinstance(alphas, (int, float)):
        alphas = (float(alphas),) * N
    if math.prod(shape) >= 2 ** 63:
        raise ValueError(f"shape {shape} overflows a 64-bit linear index")
    if nnz > math.prod(shape):
        raise ValueError(f"{nnz} distinct coordinates do not fit {shape}")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (2 ** 63))
    cdfs = [_cdf(L, a, dev) if a > 0 else None for L, a in zip(shape, alphas)]
    perms = [torch.randperm(L, generator=g, device=dev) for L in shape]
    hubs = {}
    if hub_fraction > 0:
        for m in hub_modes:
            hubs[int(m)] = int(torch.randint(0, shape[m], (1,), generator=g,
                                             device=dev))

    keys, vals = [], []
    n, held, drawn = int(nnz), 0, 0
    for _ in range(MAX_ROUNDS):
        k, v = _round(n, shape, cdfs, perms, hubs, hub_fraction, g, dev)
        keys.append(k)
        vals.append(v)
        drawn += n
        before = held
        held = int(torch.unique(torch.cat(keys)).numel())
        if held >= nnz:
            break
        # the next round: what is missing over the share of new coordinates
        # the last round found, with room, so few rounds are needed
        rate = max((held - before) / n, 1e-3)
        n = int(min(1.3 * (nnz - held) / rate, 8 * nnz)) + 4096
    else:
        raise RuntimeError(f"{held} distinct coordinates after {drawn} "
                           f"draws, {nnz} asked for")
    key = torch.cat(keys)
    value = torch.cat(vals)
    del keys, vals
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    # the draw at which each coordinate first appeared; keep the draws up
    # to the one that brought the nnz-th
    first = torch.full((uniq.numel(),), key.numel(), dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, inv, torch.arange(key.numel(), device=dev),
                          "amin")
    last = int(torch.sort(first).values[nnz - 1])
    del uniq, inv, first
    key, value = key[:last + 1], value[:last + 1]
    # sum the values of duplicates in a fixed order: sort by coordinate
    # (stable, so draws keep their order), then segment sums by differences
    # of one float64 prefix sum
    order = torch.sort(key, stable=True).indices
    key, value = key[order], value[order]
    del order
    starts = torch.ones(key.numel(), dtype=torch.bool, device=dev)
    starts[1:] = key[1:] != key[:-1]
    head = torch.nonzero(starts).squeeze(1)
    ends = torch.cat([head[1:], head.new_tensor([key.numel()])]) - 1
    csum = torch.cumsum(value, 0)
    sums = csum[ends] - torch.where(head > 0, csum[(head - 1).clamp_(min=0)],
                                    torch.zeros_like(csum[ends]))
    key = key[head]
    if key.numel() != nnz:
        raise AssertionError(f"kept {key.numel()} coordinates, not {nnz}")
    coords = torch.empty((nnz, N), dtype=torch.int64, device=dev)
    rest = key
    for m in range(N - 1, -1, -1):
        coords[:, m] = rest % shape[m]
        rest = rest // shape[m]
    return coords.cpu().numpy(), sums.cpu().numpy()
