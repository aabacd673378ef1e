"""Each mode's solve parameters, pinned.

``(backend, K_n, niter, block_size, fused_zbuild, warm_start)`` of a mode
step as the three derivations give them, as literals over a grid of
geometries and knobs: the single-process one (``hooi`` and
``hooi_invocation``: ``K_n`` the factor's width ``min(K, L)``, a given
``lanczos_iters`` clamped on the vector driver and counted in block
iterations on the block driver), the executor's (``K_n`` the core width,
P = 4 on the boundary backend) and the stochastic rung's (always the
sketch at panel 1 requested). Mode 0 of a three-mode geometry ``(L, K̂,
1)`` with core ``(K, K̂, 1)``: ``K̂ = 1000`` is the four-mode width the
benchmark runs.

A table has one line per ``(K, L, K̂)``: ``K L K̂ | backend K_n |`` then
one ``niter,block_size,flag`` entry per requested block in (1, 4, 8) (the
stochastic rung: block 1 only), where flag is ``f`` (fused Z-build), ``s``
(sketch warm start) or ``-`` (neither).
"""

from __future__ import annotations

import types

import pytest
import torch

from repro_torch.core.hooi import _local_specs
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.oracle import ModeSpec, mode_spec, resolve_knobs

KS, LS, KHATS, BLOCKS = (1, 3, 10), (2, 7, 200), (3, 100, 1000), (1, 4, 8)

EXPECT = {
    "local-none-zb": """
 1   2    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1   2  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1   2 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 3   2    3 | local  2 | 2,1,-   1,2,-   1,2,-
 3   2  100 | local  2 | 2,1,-   1,2,-   1,2,-
 3   2 1000 | local  2 | 2,1,-   1,2,-   1,2,-
 3   7    3 | local  3 | 3,1,-   1,3,-   1,3,-
 3   7  100 | local  3 | 6,1,-   2,4,-   1,6,-
 3   7 1000 | local  3 | 6,1,-   2,4,-   1,6,-
 3 200    3 | local  3 | 3,1,-   1,3,-   1,3,-
 3 200  100 | local  3 | 6,1,-   2,4,-   1,6,-
 3 200 1000 | local  3 | 6,1,-   2,4,-   1,6,-
10   2    3 | local  2 | 2,1,-   1,2,-   1,2,-
10   2  100 | local  2 | 2,1,-   1,2,-   1,2,-
10   2 1000 | local  2 | 2,1,-   1,2,-   1,2,-
10   7    3 | local  7 | 3,1,-   1,3,-   1,3,-
10   7  100 | local  7 | 7,1,-   2,4,-   1,7,-
10   7 1000 | local  7 | 7,1,-   2,4,-   1,7,-
10 200    3 | local 10 | 3,1,-   1,3,-   1,3,-
10 200  100 | local 10 | 20,1,-  5,4,-   3,8,-
10 200 1000 | local 10 | 20,1,-  5,4,-   3,8,-
""",
    "local-none-zb-iters5": """
 1   2    3 | local  1 | 2,1,-   3,2,-   3,2,-
 1   2  100 | local  1 | 2,1,-   3,2,-   3,2,-
 1   2 1000 | local  1 | 2,1,-   3,2,-   3,2,-
 1   7    3 | local  1 | 3,1,-   3,2,-   3,2,-
 1   7  100 | local  1 | 5,1,-   3,2,-   3,2,-
 1   7 1000 | local  1 | 5,1,-   3,2,-   3,2,-
 1 200    3 | local  1 | 3,1,-   3,2,-   3,2,-
 1 200  100 | local  1 | 5,1,-   3,2,-   3,2,-
 1 200 1000 | local  1 | 5,1,-   3,2,-   3,2,-
 3   2    3 | local  2 | 2,1,-   3,2,-   3,2,-
 3   2  100 | local  2 | 2,1,-   3,2,-   3,2,-
 3   2 1000 | local  2 | 2,1,-   3,2,-   3,2,-
 3   7    3 | local  3 | 3,1,-   2,3,-   2,3,-
 3   7  100 | local  3 | 5,1,-   2,4,-   1,6,-
 3   7 1000 | local  3 | 5,1,-   2,4,-   1,6,-
 3 200    3 | local  3 | 3,1,-   2,3,-   2,3,-
 3 200  100 | local  3 | 5,1,-   2,4,-   1,6,-
 3 200 1000 | local  3 | 5,1,-   2,4,-   1,6,-
10   2    3 | local  2 | 2,1,-   3,2,-   3,2,-
10   2  100 | local  2 | 2,1,-   3,2,-   3,2,-
10   2 1000 | local  2 | 2,1,-   3,2,-   3,2,-
10   7    3 | local  7 | 3,1,-   2,3,-   2,3,-
10   7  100 | local  7 | 7,1,-   2,4,-   1,7,-
10   7 1000 | local  7 | 7,1,-   2,4,-   1,7,-
10 200    3 | local 10 | 3,1,-   2,3,-   2,3,-
10 200  100 | local 10 | 10,1,-  2,4,-   1,8,-
10 200 1000 | local 10 | 10,1,-  2,4,-   1,8,-
""",
    "local-none-zb-iters40": """
 1   2    3 | local  1 | 2,1,-   20,2,-  20,2,-
 1   2  100 | local  1 | 2,1,-   20,2,-  20,2,-
 1   2 1000 | local  1 | 2,1,-   20,2,-  20,2,-
 1   7    3 | local  1 | 3,1,-   20,2,-  20,2,-
 1   7  100 | local  1 | 7,1,-   20,2,-  20,2,-
 1   7 1000 | local  1 | 7,1,-   20,2,-  20,2,-
 1 200    3 | local  1 | 3,1,-   20,2,-  20,2,-
 1 200  100 | local  1 | 40,1,-  20,2,-  20,2,-
 1 200 1000 | local  1 | 40,1,-  20,2,-  20,2,-
 3   2    3 | local  2 | 2,1,-   20,2,-  20,2,-
 3   2  100 | local  2 | 2,1,-   20,2,-  20,2,-
 3   2 1000 | local  2 | 2,1,-   20,2,-  20,2,-
 3   7    3 | local  3 | 3,1,-   14,3,-  14,3,-
 3   7  100 | local  3 | 7,1,-   10,4,-  7,6,-
 3   7 1000 | local  3 | 7,1,-   10,4,-  7,6,-
 3 200    3 | local  3 | 3,1,-   14,3,-  14,3,-
 3 200  100 | local  3 | 40,1,-  10,4,-  7,6,-
 3 200 1000 | local  3 | 40,1,-  10,4,-  7,6,-
10   2    3 | local  2 | 2,1,-   20,2,-  20,2,-
10   2  100 | local  2 | 2,1,-   20,2,-  20,2,-
10   2 1000 | local  2 | 2,1,-   20,2,-  20,2,-
10   7    3 | local  7 | 3,1,-   14,3,-  14,3,-
10   7  100 | local  7 | 7,1,-   10,4,-  6,7,-
10   7 1000 | local  7 | 7,1,-   10,4,-  6,7,-
10 200    3 | local 10 | 3,1,-   14,3,-  14,3,-
10 200  100 | local 10 | 40,1,-  10,4,-  5,8,-
10 200 1000 | local 10 | 40,1,-  10,4,-  5,8,-
""",
    "local-none-fz": """
 1   2    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1   2  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1   2 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 3   2    3 | local  2 | 2,1,f   1,2,f   1,2,f
 3   2  100 | local  2 | 2,1,f   1,2,f   1,2,f
 3   2 1000 | local  2 | 2,1,f   1,2,f   1,2,f
 3   7    3 | local  3 | 3,1,f   1,3,f   1,3,f
 3   7  100 | local  3 | 6,1,f   2,4,f   1,6,f
 3   7 1000 | local  3 | 6,1,f   2,4,f   1,6,f
 3 200    3 | local  3 | 3,1,f   1,3,f   1,3,f
 3 200  100 | local  3 | 6,1,f   2,4,f   1,6,f
 3 200 1000 | local  3 | 6,1,f   2,4,f   1,6,f
10   2    3 | local  2 | 2,1,f   1,2,f   1,2,f
10   2  100 | local  2 | 2,1,f   1,2,f   1,2,f
10   2 1000 | local  2 | 2,1,f   1,2,f   1,2,f
10   7    3 | local  7 | 3,1,f   1,3,f   1,3,f
10   7  100 | local  7 | 7,1,f   2,4,f   1,7,f
10   7 1000 | local  7 | 7,1,f   2,4,f   1,7,f
10 200    3 | local 10 | 3,1,f   1,3,f   1,3,f
10 200  100 | local 10 | 20,1,f  5,4,f   3,8,f
10 200 1000 | local 10 | 20,1,f  5,4,f   3,8,f
""",
    "local-none-fz-iters5": """
 1   2    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1   2  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1   2 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 3   2    3 | local  2 | 5,1,f   3,2,f   3,2,f
 3   2  100 | local  2 | 5,1,f   3,2,f   3,2,f
 3   2 1000 | local  2 | 5,1,f   3,2,f   3,2,f
 3   7    3 | local  3 | 5,1,f   2,3,f   2,3,f
 3   7  100 | local  3 | 5,1,f   2,4,f   1,6,f
 3   7 1000 | local  3 | 5,1,f   2,4,f   1,6,f
 3 200    3 | local  3 | 5,1,f   2,3,f   2,3,f
 3 200  100 | local  3 | 5,1,f   2,4,f   1,6,f
 3 200 1000 | local  3 | 5,1,f   2,4,f   1,6,f
10   2    3 | local  2 | 5,1,f   3,2,f   3,2,f
10   2  100 | local  2 | 5,1,f   3,2,f   3,2,f
10   2 1000 | local  2 | 5,1,f   3,2,f   3,2,f
10   7    3 | local  7 | 5,1,f   2,3,f   2,3,f
10   7  100 | local  7 | 5,1,f   2,4,f   1,7,f
10   7 1000 | local  7 | 5,1,f   2,4,f   1,7,f
10 200    3 | local 10 | 5,1,f   2,3,f   2,3,f
10 200  100 | local 10 | 5,1,f   2,4,f   1,8,f
10 200 1000 | local 10 | 5,1,f   2,4,f   1,8,f
""",
    "local-none-fz-iters40": """
 1   2    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1   2  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1   2 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 3   2    3 | local  2 | 40,1,f  20,2,f  20,2,f
 3   2  100 | local  2 | 40,1,f  20,2,f  20,2,f
 3   2 1000 | local  2 | 40,1,f  20,2,f  20,2,f
 3   7    3 | local  3 | 40,1,f  14,3,f  14,3,f
 3   7  100 | local  3 | 40,1,f  10,4,f  7,6,f
 3   7 1000 | local  3 | 40,1,f  10,4,f  7,6,f
 3 200    3 | local  3 | 40,1,f  14,3,f  14,3,f
 3 200  100 | local  3 | 40,1,f  10,4,f  7,6,f
 3 200 1000 | local  3 | 40,1,f  10,4,f  7,6,f
10   2    3 | local  2 | 40,1,f  20,2,f  20,2,f
10   2  100 | local  2 | 40,1,f  20,2,f  20,2,f
10   2 1000 | local  2 | 40,1,f  20,2,f  20,2,f
10   7    3 | local  7 | 40,1,f  14,3,f  14,3,f
10   7  100 | local  7 | 40,1,f  10,4,f  6,7,f
10   7 1000 | local  7 | 40,1,f  10,4,f  6,7,f
10 200    3 | local 10 | 40,1,f  14,3,f  14,3,f
10 200  100 | local 10 | 40,1,f  10,4,f  5,8,f
10 200 1000 | local 10 | 40,1,f  10,4,f  5,8,f
""",
    "local-sketch-zb": """
 1   2    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1   2  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1   2 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 3   2    3 | local  2 | 1,2,s   1,2,s   1,2,s
 3   2  100 | local  2 | 1,2,s   1,2,s   1,2,s
 3   2 1000 | local  2 | 1,2,s   1,2,s   1,2,s
 3   7    3 | local  3 | 1,3,s   1,3,s   1,3,s
 3   7  100 | local  3 | 1,3,s   1,4,s   1,6,s
 3   7 1000 | local  3 | 1,3,s   1,4,s   1,6,s
 3 200    3 | local  3 | 1,3,s   1,3,s   1,3,s
 3 200  100 | local  3 | 1,3,s   1,4,s   1,6,s
 3 200 1000 | local  3 | 1,3,s   1,4,s   1,6,s
10   2    3 | local  2 | 1,2,s   1,2,s   1,2,s
10   2  100 | local  2 | 1,2,s   1,2,s   1,2,s
10   2 1000 | local  2 | 1,2,s   1,2,s   1,2,s
10   7    3 | local  7 | 1,3,s   1,3,s   1,3,s
10   7  100 | local  7 | 1,7,s   1,7,s   1,7,s
10   7 1000 | local  7 | 1,7,s   1,7,s   1,7,s
10 200    3 | local 10 | 1,3,s   1,3,s   1,3,s
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-sketch-zb-iters5": """
 1   2    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1   2  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1   2 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 3   2    3 | local  2 | 3,2,s   3,2,s   3,2,s
 3   2  100 | local  2 | 3,2,s   3,2,s   3,2,s
 3   2 1000 | local  2 | 3,2,s   3,2,s   3,2,s
 3   7    3 | local  3 | 2,3,s   2,3,s   2,3,s
 3   7  100 | local  3 | 2,3,s   2,4,s   1,6,s
 3   7 1000 | local  3 | 2,3,s   2,4,s   1,6,s
 3 200    3 | local  3 | 2,3,s   2,3,s   2,3,s
 3 200  100 | local  3 | 2,3,s   2,4,s   1,6,s
 3 200 1000 | local  3 | 2,3,s   2,4,s   1,6,s
10   2    3 | local  2 | 3,2,s   3,2,s   3,2,s
10   2  100 | local  2 | 3,2,s   3,2,s   3,2,s
10   2 1000 | local  2 | 3,2,s   3,2,s   3,2,s
10   7    3 | local  7 | 2,3,s   2,3,s   2,3,s
10   7  100 | local  7 | 1,7,s   1,7,s   1,7,s
10   7 1000 | local  7 | 1,7,s   1,7,s   1,7,s
10 200    3 | local 10 | 2,3,s   2,3,s   2,3,s
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-sketch-zb-iters40": """
 1   2    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1   2  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1   2 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 3   2    3 | local  2 | 20,2,s  20,2,s  20,2,s
 3   2  100 | local  2 | 20,2,s  20,2,s  20,2,s
 3   2 1000 | local  2 | 20,2,s  20,2,s  20,2,s
 3   7    3 | local  3 | 14,3,s  14,3,s  14,3,s
 3   7  100 | local  3 | 14,3,s  10,4,s  7,6,s
 3   7 1000 | local  3 | 14,3,s  10,4,s  7,6,s
 3 200    3 | local  3 | 14,3,s  14,3,s  14,3,s
 3 200  100 | local  3 | 14,3,s  10,4,s  7,6,s
 3 200 1000 | local  3 | 14,3,s  10,4,s  7,6,s
10   2    3 | local  2 | 20,2,s  20,2,s  20,2,s
10   2  100 | local  2 | 20,2,s  20,2,s  20,2,s
10   2 1000 | local  2 | 20,2,s  20,2,s  20,2,s
10   7    3 | local  7 | 14,3,s  14,3,s  14,3,s
10   7  100 | local  7 | 6,7,s   6,7,s   6,7,s
10   7 1000 | local  7 | 6,7,s   6,7,s   6,7,s
10 200    3 | local 10 | 14,3,s  14,3,s  14,3,s
10 200  100 | local 10 | 4,10,s  4,10,s  4,10,s
10 200 1000 | local 10 | 4,10,s  4,10,s  4,10,s
""",
    "local-sketch-fz": """
 1   2    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1   2  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1   2 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1   7 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200    3 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200  100 | local  1 | 1,1,s   1,2,s   1,2,s
 1 200 1000 | local  1 | 1,1,s   1,2,s   1,2,s
 3   2    3 | local  2 | 1,2,s   1,2,s   1,2,s
 3   2  100 | local  2 | 1,2,s   1,2,s   1,2,s
 3   2 1000 | local  2 | 1,2,s   1,2,s   1,2,s
 3   7    3 | local  3 | 1,3,s   1,3,s   1,3,s
 3   7  100 | local  3 | 1,3,s   1,4,s   1,6,s
 3   7 1000 | local  3 | 1,3,s   1,4,s   1,6,s
 3 200    3 | local  3 | 1,3,s   1,3,s   1,3,s
 3 200  100 | local  3 | 1,3,s   1,4,s   1,6,s
 3 200 1000 | local  3 | 1,3,s   1,4,s   1,6,s
10   2    3 | local  2 | 1,2,s   1,2,s   1,2,s
10   2  100 | local  2 | 1,2,s   1,2,s   1,2,s
10   2 1000 | local  2 | 1,2,s   1,2,s   1,2,s
10   7    3 | local  7 | 1,3,s   1,3,s   1,3,s
10   7  100 | local  7 | 1,7,s   1,7,s   1,7,s
10   7 1000 | local  7 | 1,7,s   1,7,s   1,7,s
10 200    3 | local 10 | 1,3,s   1,3,s   1,3,s
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-sketch-fz-iters5": """
 1   2    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1   2  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1   2 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1   7 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200    3 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200  100 | local  1 | 5,1,s   3,2,s   3,2,s
 1 200 1000 | local  1 | 5,1,s   3,2,s   3,2,s
 3   2    3 | local  2 | 3,2,s   3,2,s   3,2,s
 3   2  100 | local  2 | 3,2,s   3,2,s   3,2,s
 3   2 1000 | local  2 | 3,2,s   3,2,s   3,2,s
 3   7    3 | local  3 | 2,3,s   2,3,s   2,3,s
 3   7  100 | local  3 | 2,3,s   2,4,s   1,6,s
 3   7 1000 | local  3 | 2,3,s   2,4,s   1,6,s
 3 200    3 | local  3 | 2,3,s   2,3,s   2,3,s
 3 200  100 | local  3 | 2,3,s   2,4,s   1,6,s
 3 200 1000 | local  3 | 2,3,s   2,4,s   1,6,s
10   2    3 | local  2 | 3,2,s   3,2,s   3,2,s
10   2  100 | local  2 | 3,2,s   3,2,s   3,2,s
10   2 1000 | local  2 | 3,2,s   3,2,s   3,2,s
10   7    3 | local  7 | 2,3,s   2,3,s   2,3,s
10   7  100 | local  7 | 1,7,s   1,7,s   1,7,s
10   7 1000 | local  7 | 1,7,s   1,7,s   1,7,s
10 200    3 | local 10 | 2,3,s   2,3,s   2,3,s
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-sketch-fz-iters40": """
 1   2    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1   2  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1   2 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1   7 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200    3 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200  100 | local  1 | 40,1,s  20,2,s  20,2,s
 1 200 1000 | local  1 | 40,1,s  20,2,s  20,2,s
 3   2    3 | local  2 | 20,2,s  20,2,s  20,2,s
 3   2  100 | local  2 | 20,2,s  20,2,s  20,2,s
 3   2 1000 | local  2 | 20,2,s  20,2,s  20,2,s
 3   7    3 | local  3 | 14,3,s  14,3,s  14,3,s
 3   7  100 | local  3 | 14,3,s  10,4,s  7,6,s
 3   7 1000 | local  3 | 14,3,s  10,4,s  7,6,s
 3 200    3 | local  3 | 14,3,s  14,3,s  14,3,s
 3 200  100 | local  3 | 14,3,s  10,4,s  7,6,s
 3 200 1000 | local  3 | 14,3,s  10,4,s  7,6,s
10   2    3 | local  2 | 20,2,s  20,2,s  20,2,s
10   2  100 | local  2 | 20,2,s  20,2,s  20,2,s
10   2 1000 | local  2 | 20,2,s  20,2,s  20,2,s
10   7    3 | local  7 | 14,3,s  14,3,s  14,3,s
10   7  100 | local  7 | 6,7,s   6,7,s   6,7,s
10   7 1000 | local  7 | 6,7,s   6,7,s   6,7,s
10 200    3 | local 10 | 14,3,s  14,3,s  14,3,s
10 200  100 | local 10 | 4,10,s  4,10,s  4,10,s
10 200 1000 | local 10 | 4,10,s  4,10,s  4,10,s
""",
    "local-auto-zb": """
 1   2    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1   2  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1   2 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1   7 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200    3 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200  100 | local  1 | 2,1,-   1,2,-   1,2,-
 1 200 1000 | local  1 | 2,1,-   1,2,-   1,2,-
 3   2    3 | local  2 | 2,1,-   1,2,-   1,2,-
 3   2  100 | local  2 | 2,1,-   1,2,-   1,2,-
 3   2 1000 | local  2 | 2,1,-   1,2,-   1,2,-
 3   7    3 | local  3 | 1,3,s   1,3,-   1,3,-
 3   7  100 | local  3 | 1,3,s   2,4,-   1,6,-
 3   7 1000 | local  3 | 1,3,s   2,4,-   1,6,-
 3 200    3 | local  3 | 1,3,s   1,3,-   1,3,-
 3 200  100 | local  3 | 1,3,s   2,4,-   1,6,-
 3 200 1000 | local  3 | 1,3,s   2,4,-   1,6,-
10   2    3 | local  2 | 2,1,-   1,2,-   1,2,-
10   2  100 | local  2 | 2,1,-   1,2,-   1,2,-
10   2 1000 | local  2 | 2,1,-   1,2,-   1,2,-
10   7    3 | local  7 | 1,3,s   1,3,-   1,3,-
10   7  100 | local  7 | 1,7,s   2,4,-   1,7,-
10   7 1000 | local  7 | 1,7,s   2,4,-   1,7,-
10 200    3 | local 10 | 1,3,s   1,3,-   1,3,-
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-auto-zb-iters5": """
 1   2    3 | local  1 | 2,1,-   3,2,-   3,2,-
 1   2  100 | local  1 | 2,1,-   3,2,-   3,2,-
 1   2 1000 | local  1 | 2,1,-   3,2,-   3,2,-
 1   7    3 | local  1 | 3,1,-   3,2,-   3,2,-
 1   7  100 | local  1 | 5,1,-   3,2,-   3,2,-
 1   7 1000 | local  1 | 5,1,-   3,2,-   3,2,-
 1 200    3 | local  1 | 3,1,-   3,2,-   3,2,-
 1 200  100 | local  1 | 5,1,-   3,2,-   3,2,-
 1 200 1000 | local  1 | 5,1,-   3,2,-   3,2,-
 3   2    3 | local  2 | 2,1,-   3,2,-   3,2,-
 3   2  100 | local  2 | 2,1,-   3,2,-   3,2,-
 3   2 1000 | local  2 | 2,1,-   3,2,-   3,2,-
 3   7    3 | local  3 | 2,3,s   2,3,-   2,3,-
 3   7  100 | local  3 | 2,3,s   2,4,-   1,6,-
 3   7 1000 | local  3 | 2,3,s   2,4,-   1,6,-
 3 200    3 | local  3 | 2,3,s   2,3,-   2,3,-
 3 200  100 | local  3 | 2,3,s   2,4,-   1,6,-
 3 200 1000 | local  3 | 2,3,s   2,4,-   1,6,-
10   2    3 | local  2 | 2,1,-   3,2,-   3,2,-
10   2  100 | local  2 | 2,1,-   3,2,-   3,2,-
10   2 1000 | local  2 | 2,1,-   3,2,-   3,2,-
10   7    3 | local  7 | 2,3,s   2,3,-   2,3,-
10   7  100 | local  7 | 1,7,s   2,4,-   1,7,-
10   7 1000 | local  7 | 1,7,s   2,4,-   1,7,-
10 200    3 | local 10 | 2,3,s   2,3,-   2,3,-
10 200  100 | local 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | local 10 | 1,10,s  1,10,s  1,10,s
""",
    "local-auto-zb-iters40": """
 1   2    3 | local  1 | 2,1,-   20,2,-  20,2,-
 1   2  100 | local  1 | 2,1,-   20,2,-  20,2,-
 1   2 1000 | local  1 | 2,1,-   20,2,-  20,2,-
 1   7    3 | local  1 | 3,1,-   20,2,-  20,2,-
 1   7  100 | local  1 | 7,1,-   20,2,-  20,2,-
 1   7 1000 | local  1 | 7,1,-   20,2,-  20,2,-
 1 200    3 | local  1 | 3,1,-   20,2,-  20,2,-
 1 200  100 | local  1 | 40,1,-  20,2,-  20,2,-
 1 200 1000 | local  1 | 40,1,-  20,2,-  20,2,-
 3   2    3 | local  2 | 2,1,-   20,2,-  20,2,-
 3   2  100 | local  2 | 2,1,-   20,2,-  20,2,-
 3   2 1000 | local  2 | 2,1,-   20,2,-  20,2,-
 3   7    3 | local  3 | 14,3,s  14,3,-  14,3,-
 3   7  100 | local  3 | 14,3,s  10,4,-  7,6,-
 3   7 1000 | local  3 | 14,3,s  10,4,-  7,6,-
 3 200    3 | local  3 | 14,3,s  14,3,-  14,3,-
 3 200  100 | local  3 | 14,3,s  10,4,-  7,6,-
 3 200 1000 | local  3 | 14,3,s  10,4,-  7,6,-
10   2    3 | local  2 | 2,1,-   20,2,-  20,2,-
10   2  100 | local  2 | 2,1,-   20,2,-  20,2,-
10   2 1000 | local  2 | 2,1,-   20,2,-  20,2,-
10   7    3 | local  7 | 14,3,s  14,3,-  14,3,-
10   7  100 | local  7 | 6,7,s   10,4,-  6,7,-
10   7 1000 | local  7 | 6,7,s   10,4,-  6,7,-
10 200    3 | local 10 | 14,3,s  14,3,-  14,3,-
10 200  100 | local 10 | 4,10,s  4,10,s  4,10,s
10 200 1000 | local 10 | 4,10,s  4,10,s  4,10,s
""",
    "local-auto-fz": """
 1   2    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1   2  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1   2 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1   7 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200    3 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200  100 | local  1 | 2,1,f   1,2,f   1,2,f
 1 200 1000 | local  1 | 2,1,f   1,2,f   1,2,f
 3   2    3 | local  2 | 2,1,f   1,2,f   1,2,f
 3   2  100 | local  2 | 2,1,f   1,2,f   1,2,f
 3   2 1000 | local  2 | 2,1,f   1,2,f   1,2,f
 3   7    3 | local  3 | 3,1,f   1,3,f   1,3,f
 3   7  100 | local  3 | 1,3,s   2,4,f   1,6,f
 3   7 1000 | local  3 | 1,3,s   2,4,f   1,6,f
 3 200    3 | local  3 | 3,1,f   1,3,f   1,3,f
 3 200  100 | local  3 | 1,3,s   2,4,f   1,6,f
 3 200 1000 | local  3 | 1,3,s   2,4,f   1,6,f
10   2    3 | local  2 | 2,1,f   1,2,f   1,2,f
10   2  100 | local  2 | 2,1,f   1,2,f   1,2,f
10   2 1000 | local  2 | 2,1,f   1,2,f   1,2,f
10   7    3 | local  7 | 3,1,f   1,3,f   1,3,f
10   7  100 | local  7 | 1,7,s   2,4,f   1,7,f
10   7 1000 | local  7 | 1,7,s   2,4,f   1,7,f
10 200    3 | local 10 | 3,1,f   1,3,f   1,3,f
10 200  100 | local 10 | 1,10,s  1,10,s  3,8,f
10 200 1000 | local 10 | 1,10,s  1,10,s  3,8,f
""",
    "local-auto-fz-iters5": """
 1   2    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1   2  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1   2 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1   7 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200    3 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200  100 | local  1 | 5,1,f   3,2,f   3,2,f
 1 200 1000 | local  1 | 5,1,f   3,2,f   3,2,f
 3   2    3 | local  2 | 5,1,f   3,2,f   3,2,f
 3   2  100 | local  2 | 5,1,f   3,2,f   3,2,f
 3   2 1000 | local  2 | 5,1,f   3,2,f   3,2,f
 3   7    3 | local  3 | 5,1,f   2,3,f   2,3,f
 3   7  100 | local  3 | 2,3,s   2,4,f   1,6,f
 3   7 1000 | local  3 | 2,3,s   2,4,f   1,6,f
 3 200    3 | local  3 | 5,1,f   2,3,f   2,3,f
 3 200  100 | local  3 | 2,3,s   2,4,f   1,6,f
 3 200 1000 | local  3 | 2,3,s   2,4,f   1,6,f
10   2    3 | local  2 | 5,1,f   3,2,f   3,2,f
10   2  100 | local  2 | 5,1,f   3,2,f   3,2,f
10   2 1000 | local  2 | 5,1,f   3,2,f   3,2,f
10   7    3 | local  7 | 5,1,f   2,3,f   2,3,f
10   7  100 | local  7 | 1,7,s   2,4,f   1,7,f
10   7 1000 | local  7 | 1,7,s   2,4,f   1,7,f
10 200    3 | local 10 | 5,1,f   2,3,f   2,3,f
10 200  100 | local 10 | 1,10,s  1,10,s  1,8,f
10 200 1000 | local 10 | 1,10,s  1,10,s  1,8,f
""",
    "local-auto-fz-iters40": """
 1   2    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1   2  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1   2 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1   7 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200    3 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200  100 | local  1 | 40,1,f  20,2,f  20,2,f
 1 200 1000 | local  1 | 40,1,f  20,2,f  20,2,f
 3   2    3 | local  2 | 40,1,f  20,2,f  20,2,f
 3   2  100 | local  2 | 40,1,f  20,2,f  20,2,f
 3   2 1000 | local  2 | 40,1,f  20,2,f  20,2,f
 3   7    3 | local  3 | 40,1,f  14,3,f  14,3,f
 3   7  100 | local  3 | 14,3,s  10,4,f  7,6,f
 3   7 1000 | local  3 | 14,3,s  10,4,f  7,6,f
 3 200    3 | local  3 | 40,1,f  14,3,f  14,3,f
 3 200  100 | local  3 | 14,3,s  10,4,f  7,6,f
 3 200 1000 | local  3 | 14,3,s  10,4,f  7,6,f
10   2    3 | local  2 | 40,1,f  20,2,f  20,2,f
10   2  100 | local  2 | 40,1,f  20,2,f  20,2,f
10   2 1000 | local  2 | 40,1,f  20,2,f  20,2,f
10   7    3 | local  7 | 40,1,f  14,3,f  14,3,f
10   7  100 | local  7 | 6,7,s   10,4,f  6,7,f
10   7 1000 | local  7 | 6,7,s   10,4,f  6,7,f
10 200    3 | local 10 | 40,1,f  14,3,f  14,3,f
10 200  100 | local 10 | 4,10,s  4,10,s  5,8,f
10 200 1000 | local 10 | 4,10,s  4,10,s  5,8,f
""",
    "dist-none-zb": """
 1   2    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   2  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   2 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 3   2    3 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   2  100 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   2 1000 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   7    3 | boundary  3 | 3,1,-   1,3,-   1,3,-
 3   7  100 | boundary  3 | 6,1,-   2,4,-   1,6,-
 3   7 1000 | boundary  3 | 6,1,-   2,4,-   1,6,-
 3 200    3 | boundary  3 | 3,1,-   1,3,-   1,3,-
 3 200  100 | boundary  3 | 6,1,-   2,4,-   1,6,-
 3 200 1000 | boundary  3 | 6,1,-   2,4,-   1,6,-
10   2    3 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   2  100 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   2 1000 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   7    3 | boundary 10 | 3,1,-   1,3,-   1,3,-
10   7  100 | boundary 10 | 7,1,-   2,4,-   1,7,-
10   7 1000 | boundary 10 | 7,1,-   2,4,-   1,7,-
10 200    3 | boundary 10 | 3,1,-   1,3,-   1,3,-
10 200  100 | boundary 10 | 20,1,-  5,4,-   3,8,-
10 200 1000 | boundary 10 | 20,1,-  5,4,-   3,8,-
""",
    "dist-none-fz": """
 1   2    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   2  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   2 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 3   2    3 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   2  100 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   2 1000 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   7    3 | boundary  3 | 3,1,f   1,3,f   1,3,f
 3   7  100 | boundary  3 | 6,1,f   2,4,f   1,6,f
 3   7 1000 | boundary  3 | 6,1,f   2,4,f   1,6,f
 3 200    3 | boundary  3 | 3,1,f   1,3,f   1,3,f
 3 200  100 | boundary  3 | 6,1,f   2,4,f   1,6,f
 3 200 1000 | boundary  3 | 6,1,f   2,4,f   1,6,f
10   2    3 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   2  100 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   2 1000 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   7    3 | boundary 10 | 3,1,f   1,3,f   1,3,f
10   7  100 | boundary 10 | 7,1,f   2,4,f   1,7,f
10   7 1000 | boundary 10 | 7,1,f   2,4,f   1,7,f
10 200    3 | boundary 10 | 3,1,f   1,3,f   1,3,f
10 200  100 | boundary 10 | 20,1,f  5,4,f   3,8,f
10 200 1000 | boundary 10 | 20,1,f  5,4,f   3,8,f
""",
    "dist-sketch-zb": """
 1   2    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   2  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   2 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 3   2    3 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   2  100 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   2 1000 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   7    3 | boundary  3 | 1,3,s   1,3,s   1,3,s
 3   7  100 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3   7 1000 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3 200    3 | boundary  3 | 1,3,s   1,3,s   1,3,s
 3 200  100 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3 200 1000 | boundary  3 | 1,3,s   1,4,s   1,6,s
10   2    3 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   2  100 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   2 1000 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   7    3 | boundary 10 | 1,3,s   1,3,s   1,3,s
10   7  100 | boundary 10 | 1,7,s   1,7,s   1,7,s
10   7 1000 | boundary 10 | 1,7,s   1,7,s   1,7,s
10 200    3 | boundary 10 | 1,3,s   1,3,s   1,3,s
10 200  100 | boundary 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | boundary 10 | 1,10,s  1,10,s  1,10,s
""",
    "dist-sketch-fz": """
 1   2    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   2  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   2 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1   7 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200    3 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200  100 | boundary  1 | 1,1,s   1,2,s   1,2,s
 1 200 1000 | boundary  1 | 1,1,s   1,2,s   1,2,s
 3   2    3 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   2  100 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   2 1000 | boundary  3 | 1,2,s   1,2,s   1,2,s
 3   7    3 | boundary  3 | 1,3,s   1,3,s   1,3,s
 3   7  100 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3   7 1000 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3 200    3 | boundary  3 | 1,3,s   1,3,s   1,3,s
 3 200  100 | boundary  3 | 1,3,s   1,4,s   1,6,s
 3 200 1000 | boundary  3 | 1,3,s   1,4,s   1,6,s
10   2    3 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   2  100 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   2 1000 | boundary 10 | 1,2,s   1,2,s   1,2,s
10   7    3 | boundary 10 | 1,3,s   1,3,s   1,3,s
10   7  100 | boundary 10 | 1,7,s   1,7,s   1,7,s
10   7 1000 | boundary 10 | 1,7,s   1,7,s   1,7,s
10 200    3 | boundary 10 | 1,3,s   1,3,s   1,3,s
10 200  100 | boundary 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | boundary 10 | 1,10,s  1,10,s  1,10,s
""",
    "dist-auto-zb": """
 1   2    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   2  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   2 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1   7 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200    3 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200  100 | boundary  1 | 2,1,-   1,2,-   1,2,-
 1 200 1000 | boundary  1 | 2,1,-   1,2,-   1,2,-
 3   2    3 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   2  100 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   2 1000 | boundary  3 | 2,1,-   1,2,-   1,2,-
 3   7    3 | boundary  3 | 1,3,s   1,3,-   1,3,-
 3   7  100 | boundary  3 | 1,3,s   2,4,-   1,6,-
 3   7 1000 | boundary  3 | 1,3,s   2,4,-   1,6,-
 3 200    3 | boundary  3 | 1,3,s   1,3,-   1,3,-
 3 200  100 | boundary  3 | 1,3,s   2,4,-   1,6,-
 3 200 1000 | boundary  3 | 1,3,s   2,4,-   1,6,-
10   2    3 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   2  100 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   2 1000 | boundary 10 | 2,1,-   1,2,-   1,2,-
10   7    3 | boundary 10 | 1,3,s   1,3,-   1,3,-
10   7  100 | boundary 10 | 1,7,s   2,4,-   1,7,-
10   7 1000 | boundary 10 | 1,7,s   2,4,-   1,7,-
10 200    3 | boundary 10 | 1,3,s   1,3,-   1,3,-
10 200  100 | boundary 10 | 1,10,s  1,10,s  1,10,s
10 200 1000 | boundary 10 | 1,10,s  1,10,s  1,10,s
""",
    "dist-auto-fz": """
 1   2    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   2  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   2 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1   7 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200    3 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200  100 | boundary  1 | 2,1,f   1,2,f   1,2,f
 1 200 1000 | boundary  1 | 2,1,f   1,2,f   1,2,f
 3   2    3 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   2  100 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   2 1000 | boundary  3 | 2,1,f   1,2,f   1,2,f
 3   7    3 | boundary  3 | 3,1,f   1,3,f   1,3,f
 3   7  100 | boundary  3 | 1,3,s   2,4,f   1,6,f
 3   7 1000 | boundary  3 | 1,3,s   2,4,f   1,6,f
 3 200    3 | boundary  3 | 3,1,f   1,3,f   1,3,f
 3 200  100 | boundary  3 | 1,3,s   2,4,f   1,6,f
 3 200 1000 | boundary  3 | 1,3,s   2,4,f   1,6,f
10   2    3 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   2  100 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   2 1000 | boundary 10 | 2,1,f   1,2,f   1,2,f
10   7    3 | boundary 10 | 3,1,f   1,3,f   1,3,f
10   7  100 | boundary 10 | 1,7,s   2,4,f   1,7,f
10   7 1000 | boundary 10 | 1,7,s   2,4,f   1,7,f
10 200    3 | boundary 10 | 3,1,f   1,3,f   1,3,f
10 200  100 | boundary 10 | 1,10,s  1,10,s  3,8,f
10 200 1000 | boundary 10 | 1,10,s  1,10,s  3,8,f
""",
    "stoch": """
 1   2    3 | local  1 | 1,1,s
 1   2  100 | local  1 | 1,1,s
 1   2 1000 | local  1 | 1,1,s
 1   7    3 | local  1 | 1,1,s
 1   7  100 | local  1 | 1,1,s
 1   7 1000 | local  1 | 1,1,s
 1 200    3 | local  1 | 1,1,s
 1 200  100 | local  1 | 1,1,s
 1 200 1000 | local  1 | 1,1,s
 3   2    3 | local  2 | 1,2,s
 3   2  100 | local  2 | 1,2,s
 3   2 1000 | local  2 | 1,2,s
 3   7    3 | local  3 | 1,3,s
 3   7  100 | local  3 | 1,3,s
 3   7 1000 | local  3 | 1,3,s
 3 200    3 | local  3 | 1,3,s
 3 200  100 | local  3 | 1,3,s
 3 200 1000 | local  3 | 1,3,s
10   2    3 | local  2 | 1,2,s
10   2  100 | local  2 | 1,2,s
10   2 1000 | local  2 | 1,2,s
10   7    3 | local  7 | 1,3,s
10   7  100 | local  7 | 1,7,s
10   7 1000 | local  7 | 1,7,s
10 200    3 | local 10 | 1,3,s
10 200  100 | local 10 | 1,10,s
10 200 1000 | local 10 | 1,10,s
""",
}


def _derive(case: str, K: int, L: int, khat: int, block: int) -> tuple:
    """The parameters the code under test gives for mode 0 of ``case``."""
    kind, *rest = case.split("-")
    if kind == "stoch":  # run_stochastic's request, at the factor widths
        sp = mode_spec(resolve_knobs("f32", 1, False, "sketch"), min(K, L),
                       L, khat)
    else:
        knobs = ModeSpec(block_size=block, fused_zbuild=rest[1] == "fz",
                         warm_start=rest[0])
        if kind == "dist":  # the executor's loop over a plan's modes
            ex = HooiExecutor(4, "cpu")
            pl = types.SimpleNamespace(
                parts=[types.SimpleNamespace(L=n) for n in (L, khat, 1)],
                cost=types.SimpleNamespace(path="liteopt", mode_backends=()))
            sp = ex._mode_specs(pl, (K, khat, 1), "liteopt", knobs)[0]
        else:  # hooi's: K_n the factor's width, maybe a given budget
            iters = int(rest[2][len("iters"):]) if len(rest) > 2 else None
            factors = [torch.empty(L, min(K, L)), torch.empty(khat, khat),
                       torch.empty(1, 1)]
            sp = _local_specs(knobs, factors, (L, khat, 1), iters)[0]
    return (sp.backend, sp.K_n, sp.niter, sp.block_size, sp.fused_zbuild,
            sp.warm_start)


def _parse(case: str) -> list[tuple]:
    kind = case.split("-")[0]
    rows = []
    for line in EXPECT[case].strip().splitlines():
        head, who, toks = line.split("|")
        K, L, khat = map(int, head.split())
        backend, K_n = who.split()
        blocks = (1,) if kind == "stoch" else BLOCKS
        for block, tok in zip(blocks, toks.split()):
            niter, s, flag = tok.split(",")
            rows.append(((K, L, khat, block),
                         (backend, int(K_n), int(niter), int(s), flag == "f",
                          "sketch" if flag == "s" else "none")))
    return rows


@pytest.mark.parametrize("case", sorted(EXPECT))
def test_mode_spec_matches_the_pinned_table(case):
    rows = _parse(case)
    assert len(rows) == len(KS) * len(LS) * len(KHATS) * (
        1 if case == "stoch" else len(BLOCKS))
    got = {args: _derive(case, *args) for args, _ in rows}
    assert got == dict(rows)
