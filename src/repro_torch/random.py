"""The one seam every random draw of the port goes through.

The reference draws from JAX threefry keys, which PyTorch cannot reproduce.
So the port names each draw by its ``fold_in`` chain from the root key — the
*path* — and asks a ``Draw`` callable for it::

    draw(path: tuple[int, ...], shape: tuple[int, ...]) -> Tensor  # float32

The paths are the reference's: ``(n,)`` for ``random_factors``,
``(1000 + it*N + n,)`` per sweep, then ``+(3,)`` / ``+(17,)`` / ``+(29,)``
inside ``gk_bidiag``, ``+(1,)`` in ``_complete_columns`` and ``+(41,)`` in
the sketch's ``seeded_start_panel``. ``Key`` carries a draw together with its
path, so functions keep the reference's ``key``-taking signatures and
``key.fold_in(i)`` reads as it does there.

Besides normals the sketch's SRHT test matrix needs two other kinds of draw
below a ``jax.random.split`` (not a ``fold_in``): ``choice`` (distinct
integers, ``jax.random.choice(..., replace=False)``) and ``bernoulli``. A
split child is named by its position, the path element ``("split", i)``, and
the draw is asked for its kind by keyword::

    draw(path, (s,), kind="choice", n=m) -> int64 distinct values in [0, m)
    draw(path, shape, kind="bernoulli", p=0.5) -> bool

A draw that is only ever asked for normals may take ``(path, shape)`` alone.

The default draw is a ``torch.Generator`` seeded from ``(seed, path)``: the
same seed gives the same numbers on every device and in every process.
Parity tests fill the seam with the reference's ``jax.random`` draws along
the same chains.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Callable, Sequence

import torch

from repro_torch.graphs import upload

__all__ = ["Draw", "SeededDraws", "Key", "make_key"]

Draw = Callable[..., torch.Tensor]
Path = tuple  # of fold_in ints and ("split", i) children


def _path_seed(seed: int, path: Path) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", int(seed)))
    for p in path:
        if isinstance(p, tuple):  # a split child, tagged apart from fold_ins
            h.update(b"S" + struct.pack("<q", int(p[1])))
        else:  # the bytes an all-fold_in path always hashed
            h.update(struct.pack("<q", int(p)))
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class SeededDraws:
    """Default draw: a CPU generator per (seed, path)."""

    seed: int = 0

    def __call__(self, path: Path, shape: tuple[int, ...],
                 kind: str = "normal", **params) -> torch.Tensor:
        g = torch.Generator(device="cpu")
        g.manual_seed(_path_seed(self.seed, tuple(path)))
        shape = tuple(shape)
        if kind == "normal":
            return torch.randn(shape, generator=g, dtype=torch.float32)
        if kind == "choice":
            return torch.randperm(int(params["n"]), generator=g)[:shape[0]]
        if kind == "bernoulli":
            return torch.rand(shape, generator=g) < float(params["p"])
        raise ValueError(f"unknown draw kind {kind!r}")


@dataclasses.dataclass(frozen=True)
class Key:
    """A draw plus its ``fold_in`` path: the port's counterpart of a JAX key."""

    draw: Draw
    path: Path = ()

    def fold_in(self, data: int) -> "Key":
        return Key(self.draw, self.path + (int(data),))

    def split(self, num: int = 2) -> tuple["Key", ...]:
        """The children of ``jax.random.split(key, num)``, by position."""
        return tuple(Key(self.draw, self.path + (("split", i),))
                     for i in range(int(num)))

    def normal(self, shape: Sequence[int],
               device: torch.device | str) -> torch.Tensor:
        """float32 standard normals of ``shape`` for this path, on ``device``."""
        shape = tuple(int(s) for s in shape)

        def make() -> torch.Tensor:
            out = self.draw(self.path, shape)
            if tuple(out.shape) != shape:
                raise ValueError(f"draw for path {self.path} returned shape "
                                 f"{tuple(out.shape)}, expected {shape}")
            return out.to(dtype=torch.float32)

        # a captured step refills the draw from each call's own key
        return upload(make, device)

    def choice(self, n: int, size: int,
               device: torch.device | str) -> torch.Tensor:
        """``size`` distinct integers of ``[0, n)`` (int64) for this path:
        ``jax.random.choice(key, n, (size,), replace=False)``."""
        out = torch.as_tensor(self.draw(self.path, (int(size),),
                                        kind="choice", n=int(n)))
        if tuple(out.shape) != (int(size),):
            raise ValueError(f"choice draw for path {self.path} returned "
                             f"shape {tuple(out.shape)}, expected {(size,)}")
        return out.to(device=device, dtype=torch.int64)

    def bernoulli(self, p: float, shape: Sequence[int],
                  device: torch.device | str) -> torch.Tensor:
        """Booleans of ``shape``, True with probability ``p``, for this path:
        ``jax.random.bernoulli(key, p, shape)``."""
        shape = tuple(int(s) for s in shape)
        out = torch.as_tensor(self.draw(self.path, shape, kind="bernoulli",
                                        p=float(p)))
        if tuple(out.shape) != shape:
            raise ValueError(f"bernoulli draw for path {self.path} returned "
                             f"shape {tuple(out.shape)}, expected {shape}")
        return out.to(device=device, dtype=torch.bool)


def make_key(seed: int = 0, draw: Draw | None = None) -> Key:
    """Root key: the port's ``jax.random.PRNGKey(seed)``. ``draw`` replaces
    the default seeded generator (the parity tests inject JAX draws)."""
    return Key(SeededDraws(int(seed)) if draw is None else draw, ())
