"""Quickstart: sparse Tucker decomposition with the Lite scheme.

The port of ``examples/quickstart.py``. Builds a skewed synthetic sparse
tensor (the paper's regime: a few huge slices), runs HOOI to a
rank-(8,8,8) Tucker decomposition on the card, and prints the §4 metrics
for Lite against the prior schemes: the paper's headline comparison at
laptop scale.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.distribution import build_scheme
from repro_torch.core.hooi import hooi
from repro_torch.core.metrics import scheme_metrics
from repro_torch.data.tensors import synth_tensor


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where HOOI runs (default: the card)")
    args = ap.parse_args(argv)

    print("== building synthetic tensor (enron-like skew) ==")
    t = synth_tensor((300, 400, 350), 60_000, alphas=(1.3, 1.1, 1.1),
                     hub_fraction=0.15, hub_modes=(0,), seed=0)
    print(f"   {t}")
    sizes = np.sort(t.slice_sizes(0))[::-1]
    print(f"   largest mode-0 slices: {sizes[:5].tolist()} "
          f"(avg {t.nnz // t.shape[0]})")

    print(f"\n== HOOI (5 invocations, K=8, random bootstrap) on "
          f"{args.device} ==")
    dec, fits = hooi(t, (8, 8, 8), n_invocations=5, seed=0,
                     device=args.device)
    for i, f in enumerate(fits):
        print(f"   invocation {i}: fit = {f:.4f}")
    print(f"   core shape: {tuple(dec.core.shape)}")

    print("\n== distribution metrics at P=32 (paper §4, Fig 12) ==")
    P = 32
    hdr = (f"{'scheme':12s} {'E_imbalance':>12s} {'R_redundancy':>13s} "
           f"{'R_imbalance':>12s}")
    print("   " + hdr)
    for name in ("lite", "coarse", "medium", "hypergraph"):
        s = build_scheme(t, name, P)
        sm = scheme_metrics(t, s, (8, 8, 8))
        imb = max(m.ttm_imbalance for m in sm.per_mode)
        red = max(m.svd_redundancy for m in sm.per_mode)
        simb = max(m.svd_imbalance for m in sm.per_mode)
        print(f"   {name:12s} {imb:12.2f} {red:13.2f} {simb:12.2f}")
    print("\n   -> Lite is simultaneously ~1.0 on all three "
          "(Theorem 6.1); CoarseG blows up E, uni-policy schemes blow up R.")


if __name__ == "__main__":
    main()
