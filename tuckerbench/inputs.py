"""The inputs the benchmark hands to the program and to the reference alike.

Everything here is made from the run's ``--seed``: the initial factors of
each decomposition and the random draws of its Lanczos start panels. The
program receives them through its public arguments (``init=``, ``seed=``
and ``draw=``); the reference re-derives them with the same functions. This
module imports neither the program nor JAX.
"""

from __future__ import annotations

import hashlib
import struct

import torch

__all__ = ["derive", "Draws", "init_factors", "start_panel"]


def derive(seed: int, *parts) -> int:
    """A 62-bit seed from ``seed`` and a tuple of ints and strings."""
    h = hashlib.blake2b(digest_size=8)
    h.update(str(int(seed)).encode())
    for p in parts:
        h.update(b"|" + str(p).encode())
    return int.from_bytes(h.digest(), "little") & ((1 << 62) - 1)


def _path_seed(seed: int, path: tuple) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", int(seed)))
    for p in path:
        if isinstance(p, tuple):  # a split child
            h.update(b"S" + struct.pack("<q", int(p[1])))
        else:
            h.update(struct.pack("<q", int(p)))
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


class Draws:
    """The benchmark's draw for the program's random seam: a CPU generator
    seeded from ``(seed, path)`` per draw, float32 normals (and the seam's
    ``choice`` and ``bernoulli`` kinds). The program asks it for a draw by
    the path of ``fold_in`` numbers that names it."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, path, shape, kind: str = "normal", **params):
        g = torch.Generator(device="cpu")
        g.manual_seed(_path_seed(self.seed, tuple(path)))
        shape = tuple(int(s) for s in shape)
        if kind == "normal":
            return torch.randn(shape, generator=g, dtype=torch.float32)
        if kind == "choice":
            return torch.randperm(int(params["n"]), generator=g)[:shape[0]]
        if kind == "bernoulli":
            return torch.rand(shape, generator=g) < float(params["p"])
        raise ValueError(f"unknown draw kind {kind!r}")


def start_panel(seed: int, sweep: int, nmodes: int, mode: int, ncols: int,
                width: int) -> torch.Tensor:
    """The Lanczos start vector (``width`` 1) or panel of one mode step, as
    the program draws it: the path ``(1000 + sweep * nmodes + mode, 3)``
    below the root, ``(ncols, width)`` normals (f64 on the host)."""
    path = (1000 + sweep * nmodes + mode, 3)
    shape = (ncols,) if width == 1 else (ncols, width)
    x = Draws(seed)(path, shape).to(torch.float64)
    return x.reshape(ncols, width)


def init_factors(shape, core_dims, seed: int, device) -> list[torch.Tensor]:
    """Random orthonormal initial factors (f32, ``(L_n, K_n)``), drawn and
    orthonormalized on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = []
    for L, K in zip(shape, core_dims):
        x = torch.randn((int(L), int(K)), generator=g, device=device,
                        dtype=torch.float32)
        out.append(torch.linalg.qr(x).Q.contiguous())
    return out
