"""Tiny stand-ins of the benchmark's cells, for the CPU tests: each cell's
own traffic and limits, its configuration's skew, and a small shape."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SHAPES = {3: (200, 150, 300), 4: (60, 50, 80, 30)}
NNZ = 20_000
SEED = 2 ** 31 + 12345  # past 32 signed bits: a seed may be that large


def tiny_spec(cell: str):
    """The cell's spec with its tensor shrunk to ``SHAPES`` and ``NNZ``."""
    from tuckerbench import harness

    spec = harness.load_spec(cell, ROOT)
    N = len(spec.config["shape"])
    spec.config = dict(spec.config, shape=list(SHAPES[N]), nnz=NNZ,
                       name=f"tiny {spec.config['name']}")
    return spec


def run_tiny(cell: str, control: str | None = None, seed: int = SEED,
             seconds: float = 0.5, trace: bool = False) -> dict:
    import torch

    from tuckerbench import harness

    return harness.run(tiny_spec(cell), seed, seconds, trace,
                       time.perf_counter(), device=torch.device("cpu"),
                       control=control)
