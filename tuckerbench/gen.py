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

Coordinates are sorted, told apart and summed by their keys
(``tuckerbench.keys``): one int64 word, the linear index, below 2**63, and
two words past it, so tensors such as FROSTT's nell-1 (an index space of
1.6e20) can be drawn too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tuckerbench import keys

__all__ = ["draw_tensor", "MAX_ROUNDS"]

MAX_ROUNDS = 40  # rounds of top-up draws before the generator gives up


def _cdf(L: int, alpha: float, device) -> torch.Tensor:
    ranks = torch.arange(1, L + 1, dtype=torch.float64, device=device)
    cdf = _prefix_sum(ranks ** (-float(alpha)))
    return cdf / cdf[-1]


def _round(n: int, shape, cdfs, perms, hubs, hub_fraction, g, device
           ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """``n`` draws: their keys (``keys.words``) and values (f64)."""
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
    key = keys.words(cols, shape)
    values = torch.randn(n, dtype=torch.float64, generator=g, device=device)
    return key, values


def draw_tensor(shape, nnz: int, alphas, hub_fraction: float = 0.0,
                hub_modes=(), seed: int = 0, device="cuda"
                ) -> tuple[np.ndarray, np.ndarray]:
    """Exactly ``nnz`` distinct coordinates of ``shape`` and their values.

    Returns ``(coords, values)`` on the host: int64 ``(nnz, N)`` sorted by
    linear index, and float64 ``(nnz,)``. The same seed gives the same
    arrays on the same kind of device. Refuses a shape whose keys need more
    than two words.
    """
    shape = tuple(int(L) for L in shape)
    N = len(shape)
    if isinstance(alphas, (int, float)):
        alphas = (float(alphas),) * N
    if nnz > math.prod(shape):
        raise ValueError(f"{nnz} distinct coordinates do not fit {shape}")
    keys.groups(shape)  # refuses a shape past two words
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

    rounds, vals = [], []
    n, held, drawn = int(nnz), 0, 0
    for _ in range(MAX_ROUNDS):
        k, v = _round(n, shape, cdfs, perms, hubs, hub_fraction, g, dev)
        rounds.append(k)
        vals.append(v)
        drawn += n
        before = held
        key = [torch.cat(w) for w in zip(*rounds)]
        rounds = [key]
        # sorted by key, equal keys in draw order; a key's first draw leads
        order = keys.lex_order(key)
        lead = keys.starts([w[order] for w in key])
        held = int(lead.sum())
        if held >= nnz:
            break
        # the next round: what is missing over the share of new coordinates
        # the last round found, with room, so few rounds are needed
        rate = max((held - before) / n, 1e-3)
        n = int(min(1.3 * (nnz - held) / rate, 8 * nnz)) + 4096
    else:
        raise RuntimeError(f"{held} distinct coordinates after {drawn} "
                           f"draws, {nnz} asked for")
    value = torch.cat(vals)
    del rounds, vals
    # keep the draws up to the one at which the nnz-th coordinate first
    # appeared, still sorted by key and in draw order among equal keys
    last = int(torch.sort(order[lead]).values[nnz - 1])
    del lead
    order = order[order <= last]
    key = [w[order] for w in key]
    value = value[order]
    del order
    head = torch.nonzero(keys.starts(key)).squeeze(1)
    key = [w[head] for w in key]
    if key[0].numel() != nnz:
        raise AssertionError(f"kept {key[0].numel()} coordinates, not {nnz}")
    # sum the values of duplicates in that fixed order: segment sums by
    # differences of one float64 prefix sum
    ends = torch.cat([head[1:], head.new_tensor([value.numel()])]) - 1
    csum = _prefix_sum(value)
    sums = csum[ends] - torch.where(head > 0, csum[(head - 1).clamp_(min=0)],
                                    torch.zeros_like(csum[ends]))
    return keys.unravel(key, shape).cpu().numpy(), sums.cpu().numpy()


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``x``, added in sequence on the host and
    handed back on ``x``'s device, so that a seed gives the same tensor in
    every run: the card's ``torch.cumsum`` combines its partial sums in an
    order that changes from run to run (and with it a slice's CDF and the
    summed values)."""
    return torch.cumsum(x.cpu(), 0).to(x.device)
