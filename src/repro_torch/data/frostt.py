"""FROSTT-style ``.tns`` ingestion: one-shot loads and streamed batches.

The port's own copy of ``load_tns`` and ``iter_tns_batches`` from
``src/repro/data/frostt.py`` (numpy, unchanged). The paper's evaluation
tensors (delicious, enron, nell, ...) are published by FROSTT as ``.tns``
text files: one element per line, 1-based coordinates followed by the
value, ``#``/``%`` comment lines allowed.

* ``load_tns`` — whole-file read into a ``SparseTensor``; an explicit
  ``shape`` pins the dense extent instead of inferring it from the largest
  coordinate.
* ``iter_tns_batches`` — a generator of bounded COO batches that never
  materializes the whole file.
* ``stream_tns`` — builds a ``StreamingTensor`` by appending those batches
  in file order (with ``shape=None`` an extra pass infers the extent
  first: a stream's shape is fixed at birth). The result drops straight
  into ``StreamScheduler.submit``.

Values are kept as written (float64); duplicate coordinates are preserved
(under streaming semantics they are value updates).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.core.coo import SparseTensor
from repro_torch.streaming import StreamingTensor

__all__ = ["load_tns", "iter_tns_batches", "stream_tns"]

_COMMENTS = ("#", "%")


def _parse_lines(lines, ndim: int | None):
    """Parse text lines -> (coords 0-based, values, ndim); skips comments."""
    coords, values = [], []
    for line in lines:
        s = line.strip()
        if not s or s.startswith(_COMMENTS):
            continue
        parts = s.split()
        if ndim is None:
            ndim = len(parts) - 1
            if ndim < 1:
                raise ValueError(
                    f"a .tns line needs >= 1 coordinate plus a value, "
                    f"got {s!r}")
        if len(parts) != ndim + 1:
            raise ValueError(
                f"inconsistent .tns line (expected {ndim} coords + value): "
                f"{s!r}")
        coords.append([int(p) for p in parts[:ndim]])
        values.append(float(parts[ndim]))
    if not coords:
        return np.zeros((0, ndim or 0), np.int64), np.zeros(0), ndim
    c = np.asarray(coords, dtype=np.int64)
    if c.min() < 1:
        raise ValueError(".tns coordinates are 1-based; got a coordinate "
                         f"{int(c.min())}")
    return c - 1, np.asarray(values, dtype=np.float64), ndim


def load_tns(path, shape: tuple[int, ...] | None = None) -> SparseTensor:
    """Read a whole ``.tns`` file into a ``SparseTensor``.

    ``shape`` pins the dense extent (validated against the data); ``None``
    infers it as the per-mode max coordinate.
    """
    with open(path) as f:
        coords, values, ndim = _parse_lines(f, None)
    if ndim is None:
        raise ValueError(f"{path}: no elements found")
    if shape is None:
        shape = tuple(int(coords[:, n].max()) + 1 for n in range(ndim))
    else:
        shape = tuple(int(L) for L in shape)
        if len(shape) != ndim:
            raise ValueError(
                f"shape has {len(shape)} modes, file has {ndim}")
    return SparseTensor(coords, values, shape)


def iter_tns_batches(path, batch_nnz: int = 100_000
                     ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(coords, values)`` batches of at most ``batch_nnz`` elements.

    Streams the file line by line (bounded memory); coordinates come out
    0-based, file order preserved across batches.
    """
    if batch_nnz < 1:
        raise ValueError(f"batch_nnz must be >= 1, got {batch_nnz}")
    ndim = None
    pending: list[str] = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith(_COMMENTS):
                continue
            pending.append(s)
            if len(pending) >= batch_nnz:
                coords, values, ndim = _parse_lines(pending, ndim)
                pending.clear()
                yield coords, values
    if pending:
        coords, values, _ = _parse_lines(pending, ndim)
        yield coords, values


def stream_tns(path, batch_nnz: int = 100_000,
               shape: tuple[int, ...] | None = None,
               name: str | None = None) -> StreamingTensor:
    """Materialize a ``.tns`` file as a ``StreamingTensor``, batch by batch.

    With ``shape=None`` an extra pass over the file infers the dense extent
    first. Each batch is one ``append``, so a scheduler consuming the
    stream sees the version-by-version growth a live ingest would produce.
    """
    if shape is None:
        hi = None
        for coords, _ in iter_tns_batches(path, batch_nnz):
            if len(coords) == 0:
                continue
            m = coords.max(axis=0)
            hi = m if hi is None else np.maximum(hi, m)
        if hi is None:
            raise ValueError(f"{path}: no elements found")
        shape = tuple(int(x) + 1 for x in hi)
    if name is None:
        name = str(path)
    stream = StreamingTensor(shape, name=name)
    for coords, values in iter_tns_batches(path, batch_nnz):
        stream.append(coords, values)
    return stream
