"""Sparse tensor container in coordinate (COO) format.

The port's own copy of the reference's host-side ``SparseTensor``
(``src/repro/core/coo.py``), limited to what the port's paths use, with
the FROSTT ``.tns`` reader and writer. It stays in numpy: generation and
validation are host work, and the device copies are made at the entry point
(``repro_torch.convert.device_coords``), which keeps them on the instance
beside the fingerprint: a tensor's arrays are never written once built, and
the kept device copies are read only.
A mode-n *slice* is the set of elements sharing the n-th coordinate.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = ["SparseTensor", "read_tns", "write_tns"]


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """N-dimensional sparse tensor in COO format.

    Attributes:
      coords: int32/int64 array of shape (nnz, N); 0-based coordinates.
      values: float array of shape (nnz,).
      shape:  tuple of N mode lengths (L_1, ..., L_N).
    """

    coords: np.ndarray
    values: np.ndarray
    shape: tuple[int, ...]

    def __post_init__(self):
        coords = np.asarray(self.coords)
        values = np.asarray(self.values)
        if coords.ndim != 2:
            raise ValueError(f"coords must be 2-D (nnz, N), got {coords.shape}")
        if values.ndim != 1 or values.shape[0] != coords.shape[0]:
            raise ValueError(
                f"values must be 1-D with len == nnz, got {values.shape} vs "
                f"{coords.shape[0]} coords"
            )
        if len(self.shape) != coords.shape[1]:
            raise ValueError(
                f"shape has {len(self.shape)} modes but coords has {coords.shape[1]}"
            )
        if coords.size and (coords.min() < 0):
            raise ValueError("coordinates must be non-negative")
        for n, L in enumerate(self.shape):
            if coords.size and int(coords[:, n].max()) >= L:
                raise ValueError(
                    f"mode-{n} coordinate {int(coords[:, n].max())} out of bounds "
                    f"for length {L}"
                )
        object.__setattr__(self, "coords", coords)
        object.__setattr__(self, "values", values)
        object.__setattr__(self, "shape", tuple(int(L) for L in self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        return int(self.coords.shape[0])

    @property
    def sparsity(self) -> float:
        total = float(np.prod([float(L) for L in self.shape]))
        return self.nnz / total if total else 0.0

    def __repr__(self) -> str:
        return (f"SparseTensor(shape={self.shape}, nnz={self.nnz}, "
                f"sparsity={self.sparsity:.2e})")

    def slice_sizes(self, mode: int) -> np.ndarray:
        """Cardinality |Slice_n^l| for every l in [0, L_n)."""
        return np.bincount(self.coords[:, mode], minlength=self.shape[mode])

    def nonempty_slices(self, mode: int) -> np.ndarray:
        """Indices l with |Slice_n^l| > 0."""
        return np.nonzero(self.slice_sizes(mode))[0]

    def sorted_by_mode(self, mode: int) -> "SparseTensor":
        """Elements stably sorted by their mode-n coordinate."""
        order = np.argsort(self.coords[:, mode], kind="stable")
        return SparseTensor(self.coords[order], self.values[order], self.shape)

    def permute_mode(self, mode: int, perm: np.ndarray) -> "SparseTensor":
        """Relabel mode-n indices: new coordinate = perm[old coordinate]."""
        coords = self.coords.copy()
        coords[:, mode] = np.asarray(perm)[coords[:, mode]]
        return SparseTensor(coords, self.values, self.shape)

    def todense(self) -> np.ndarray:
        """Materialize as a dense numpy array (tests / small tensors only)."""
        total = int(np.prod(self.shape))
        if total > 200_000_000:
            raise MemoryError(f"refusing to densify {self.shape}")
        out = np.zeros(self.shape, dtype=np.float64)
        np.add.at(out, tuple(self.coords.T), self.values)
        return out

    @staticmethod
    def fromdense(arr: np.ndarray, tol: float = 0.0) -> "SparseTensor":
        mask = np.abs(arr) > tol
        coords = np.argwhere(mask)
        values = arr[mask].astype(np.float64)
        return SparseTensor(coords, values, arr.shape)

    def dedup(self) -> "SparseTensor":
        """Merge duplicate coordinates (sum values)."""
        flat = np.ravel_multi_index(tuple(self.coords.T), self.shape)
        uniq, inv = np.unique(flat, return_inverse=True)
        vals = np.zeros(len(uniq), dtype=self.values.dtype)
        np.add.at(vals, inv, self.values)
        coords = np.stack(np.unravel_index(uniq, self.shape), axis=1)
        return SparseTensor(coords, vals, self.shape)

    def norm(self) -> float:
        return float(np.linalg.norm(self.values))

    def fingerprint(self) -> str:
        """Content hash of (shape, coords, values), the reference's.

        Memoized on the instance (coords/values are treated as immutable).
        It keys the plan cache (``repro_torch.core.plan``).
        """
        cached = getattr(self, "_fingerprint", None)
        if cached is not None:
            return cached
        h = hashlib.sha1()
        h.update(repr(self.shape).encode())
        h.update(np.ascontiguousarray(self.coords).tobytes())
        h.update(np.ascontiguousarray(self.values).tobytes())
        fp = h.hexdigest()
        object.__setattr__(self, "_fingerprint", fp)
        return fp

    def take(self, idx: np.ndarray) -> "SparseTensor":
        return SparseTensor(self.coords[idx], self.values[idx], self.shape)


# ------------------------------------------------------------------ FROSTT IO
def read_tns(path: str) -> SparseTensor:
    """Read a FROSTT ``.tns`` file (1-based coords, whitespace separated)."""
    rows = np.loadtxt(path, dtype=np.float64, ndmin=2, comments=("#", "%"))
    coords = rows[:, :-1].astype(np.int64) - 1
    values = rows[:, -1]
    shape = tuple(int(coords[:, n].max()) + 1 for n in range(coords.shape[1]))
    return SparseTensor(coords, values, shape)


def write_tns(path: str, t: SparseTensor) -> None:
    with open(path, "w") as f:
        for c, v in zip(t.coords, t.values):
            f.write(" ".join(str(int(x) + 1) for x in c)
                    + f" {float(v)!r}\n")
