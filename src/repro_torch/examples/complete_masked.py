"""Objective-pluggable sweeps: masked completion and nonnegative Tucker.

The port of ``examples/complete_masked.py``. Act 1: a fraction of a
tensor's stored entries is corrupted (untrusted measurements). The standard
Tucker objective trains on everything and chases the garbage; the
completion objective drops exactly those entries (masked fit) and recovers
the underlying model better at the held-out coordinates. Act 2: the same
data, FROSTT ``.tns`` round-trip: written to disk, streamed back
batch-by-batch into a ``StreamingTensor``, and decomposed under the
completion objective. Act 3: nonnegative Tucker by ADMM on block-structured
nonneg data.

  PYTHONPATH=src python -m repro_torch.examples.complete_masked [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.coo import SparseTensor, write_tns
from repro_torch.core.hooi import hooi
from repro_torch.data.frostt import iter_tns_batches, stream_tns
from repro_torch.engine.objective import holdout_mask, predict_at_coords


def predict(core, factors, coords) -> np.ndarray:
    return predict_at_coords(core, factors, coords).cpu().numpy()


def lowrank_sample(rng, shape, rank, nnz):
    """An exact rank-``rank`` model sampled (densely) at random coords."""
    g = rng.standard_normal(rank)
    us = [np.linalg.qr(rng.standard_normal((L, r)))[0]
          for L, r in zip(shape, rank)]
    coords = np.unique(np.stack([rng.integers(0, L, 2 * nnz) for L in shape],
                                axis=1), axis=0)[:nnz]
    vals = predict(g, us, coords)
    return coords, vals / max(np.abs(vals).max(), 1e-12)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where HOOI runs (default: the card)")
    dev = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    shape, core = (24, 20, 18), (4, 4, 4)
    coords, true_vals = lowrank_sample(rng, shape, core, 6000)

    # corrupt the entries the completion objective will hold out
    # (fraction 0.2, seed 0 are the CompletionObjective defaults)
    held = holdout_mask(len(coords), 0.2, 0)
    vals = true_vals.copy()
    vals[held] = rng.standard_normal(int(held.sum())) * 5.0 * true_vals.std()
    t = SparseTensor(coords=coords, values=vals, shape=shape)
    print(f"== {t.nnz} observed entries, {int(held.sum())} corrupted ==")

    print("\n== Act 1: unmasked Tucker vs masked completion ==")
    for obj in ("tucker", "completion"):
        dec, fits = hooi(t, core, n_invocations=3, seed=0, objective=obj,
                         device=dev)
        pred = predict(dec.core, dec.factors, coords[held])
        rmse = float(np.sqrt(np.mean((pred - true_vals[held]) ** 2)))
        print(f"   {obj:12s} fit={fits[-1]:.4f}  "
              f"held-out RMSE vs truth={rmse:.4f}")
    print("   -> completion ignores the corrupted entries; the baseline "
          "chases them.")

    print("\n== Act 2: FROSTT .tns round-trip through StreamingTensor ==")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "fixture.tns")
        write_tns(path, t)
        n_batches = sum(1 for _ in iter_tns_batches(path, batch_nnz=2000))
        stream = stream_tns(path, batch_nnz=2000)
        snap = stream.snapshot()
        print(f"   {os.path.basename(path)}: {n_batches} batches -> "
              f"version {stream.version}, nnz={snap.nnz}")
        dec, fits = hooi(snap, core, n_invocations=2, seed=0,
                         objective="completion", device=dev)
        print(f"   completion on the streamed copy: fit={fits[-1]:.4f}")

    print("\n== Act 3: nonnegative Tucker (ADMM) ==")
    us_nn = []
    for L in shape:
        f = np.zeros((L, 4))
        for j in range(4):
            lo, hi = j * L // 4, (j + 1) * L // 4
            f[lo:hi, j] = np.abs(rng.standard_normal(hi - lo)) + 0.1
        us_nn.append(f)
    vals_nn = predict(np.abs(rng.standard_normal(core)), us_nn, coords)
    t_nn = SparseTensor(coords=coords,
                        values=vals_nn / max(vals_nn.max(), 1e-12),
                        shape=shape)
    dec, fits = hooi(t_nn, core, n_invocations=3, seed=0, objective="nn",
                     device=dev)
    mn = min(float(f.min()) for f in dec.factors)
    print(f"   nn fit trajectory: {[round(f, 4) for f in fits]}")
    print(f"   min factor entry: {mn} (exactly nonnegative)")


if __name__ == "__main__":
    main()
