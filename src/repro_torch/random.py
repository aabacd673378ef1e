"""The one seam every random draw of the port goes through.

The reference draws from JAX threefry keys, which PyTorch cannot reproduce.
So the port names each draw by its ``fold_in`` chain from the root key — the
*path* — and asks a ``Draw`` callable for it::

    draw(path: tuple[int, ...], shape: tuple[int, ...]) -> Tensor  # float32

The paths are the reference's: ``(n,)`` for ``random_factors``,
``(1000 + it*N + n,)`` per sweep, then ``+(3,)`` / ``+(17,)`` / ``+(29,)``
inside ``gk_bidiag`` and ``+(1,)`` in ``_complete_columns``. ``Key`` carries
a draw together with its path, so functions keep the reference's
``key``-taking signatures and ``key.fold_in(i)`` reads as it does there.

The default draw is a ``torch.Generator`` seeded from ``(seed, path)``: the
same seed gives the same numbers on every device and in every process.
Parity tests fill the seam with the reference's ``jax.random.normal`` draws
along the same chains.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Callable, Sequence

import torch

__all__ = ["Draw", "SeededDraws", "Key", "make_key"]

Draw = Callable[[tuple[int, ...], tuple[int, ...]], torch.Tensor]


def _path_seed(seed: int, path: tuple[int, ...]) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack(f"<{1 + len(path)}q", int(seed), *path))
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


@dataclasses.dataclass(frozen=True)
class SeededDraws:
    """Default draw: standard normals from a CPU generator per (seed, path)."""

    seed: int = 0

    def __call__(self, path: tuple[int, ...],
                 shape: tuple[int, ...]) -> torch.Tensor:
        g = torch.Generator(device="cpu")
        g.manual_seed(_path_seed(self.seed, tuple(path)))
        return torch.randn(tuple(shape), generator=g, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class Key:
    """A draw plus its ``fold_in`` path: the port's counterpart of a JAX key."""

    draw: Draw
    path: tuple[int, ...] = ()

    def fold_in(self, data: int) -> "Key":
        return Key(self.draw, self.path + (int(data),))

    def normal(self, shape: Sequence[int],
               device: torch.device | str) -> torch.Tensor:
        """float32 standard normals of ``shape`` for this path, on ``device``."""
        shape = tuple(int(s) for s in shape)
        out = self.draw(self.path, shape)
        if tuple(out.shape) != shape:
            raise ValueError(f"draw for path {self.path} returned shape "
                             f"{tuple(out.shape)}, expected {shape}")
        return out.to(device=device, dtype=torch.float32)


def make_key(seed: int = 0, draw: Draw | None = None) -> Key:
    """Root key: the port's ``jax.random.PRNGKey(seed)``. ``draw`` replaces
    the default seeded generator (the parity tests inject JAX draws)."""
    return Key(SeededDraws(int(seed)) if draw is None else draw, ())
