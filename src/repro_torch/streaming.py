"""Streaming sparse tensors: incremental COO appends + chain fingerprints.

The port's own copy of ``src/repro/streaming.py``, with the same behaviour.
A ``StreamingTensor`` accumulates COO batches (the serving regime: ratings
or interactions arriving in batches, each followed by a re-decomposition)
and answers, in O(batch) rather than O(nnz):

  * **fingerprint** — a hash chain ``fp_{k+1} = H(fp_k || batch_k)``, byte
    for byte the reference's, so the plan cache (``repro_torch.core.plan``)
    and the executor's upload cache keep working across snapshots without
    re-hashing the full tensor. Distinct histories of equal content hash
    differently — a conservative cache miss, never a false hit.
  * **per-mode slice histograms** — maintained incrementally
    (``slice_hist``), for monitoring a stream's shape. The scheduler does
    not read them: it projects appended coordinates onto the adopted plan's
    owner maps (``repro_torch.engine.scheduler``).

``snapshot()`` materializes the state as a ``SparseTensor`` whose memoized
fingerprint is the chain value, carrying ``_stream_version`` and the true
``_true_norm2``.

Element semantics are plain COO: appending a coordinate that already exists
adds a second element with that coordinate (a *value update* for every
linear consumer). ||T||_F^2, the fit denominator, is the sum of
*accumulated* values squared; it is maintained per unique coordinate and
``fit_score`` prefers it. The reference keeps the accumulated values in a
dict keyed by the raveled coordinate; here they are two numpy arrays
(sorted unique raveled keys and their values), which holds the same state
in a fraction of the memory and time. The norm update sums the same
sorted-unique array in the same order, so ``_true_norm2`` has the
reference's bits.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from repro_torch.core.coo import SparseTensor

__all__ = ["StreamingTensor"]


class StreamingTensor:
    """Append-only COO stream over a fixed dense shape.

    Thread-safety: ``append`` and the read methods take an internal lock, so
    a producer thread can append while scheduler workers snapshot. The
    *scheduling* of concurrent appends vs. submits is the scheduler's
    contract (see ``repro_torch.engine.scheduler``).
    """

    def __init__(self, shape, *, name: str = "stream"):
        self.shape = tuple(int(L) for L in shape)
        if not self.shape or any(L <= 0 for L in self.shape):
            raise ValueError(f"invalid shape {shape!r}")
        self.name = str(name)
        self._lock = threading.RLock()
        self._coords: list[np.ndarray] = []  # one (batch, N) array per append
        self._values: list[np.ndarray] = []
        self._version = 0
        h = hashlib.sha1()
        h.update(b"stream:")
        h.update(repr(self.shape).encode())
        self._fp = h.hexdigest()
        self._hists = [np.zeros(L, dtype=np.int64) for L in self.shape]
        # accumulated value per unique coordinate: sorted raveled keys and
        # their values, and the true ||T||^2 = sum of accumulated values
        # squared
        self._keys = np.zeros(0, dtype=np.int64)
        self._acc = np.zeros(0, dtype=np.float64)
        self._norm2 = 0.0
        self._snapshot: SparseTensor | None = None

    @classmethod
    def from_tensor(cls, t: SparseTensor, *, name: str = "stream"
                    ) -> "StreamingTensor":
        """Seed a stream with an existing tensor as its first batch."""
        s = cls(t.shape, name=name)
        s.append(t.coords, t.values)
        return s

    # ------------------------------------------------------------- queries
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def nnz(self) -> int:
        with self._lock:
            return sum(int(c.shape[0]) for c in self._coords)

    @property
    def version(self) -> int:
        """Number of appended batches so far (0 = empty stream)."""
        with self._lock:
            return self._version

    def fingerprint(self) -> str:
        """Chain fingerprint of the append history (O(1) read)."""
        with self._lock:
            return self._fp

    def slice_hist(self, mode: int) -> np.ndarray:
        """|Slice_mode^l| for every l — maintained incrementally."""
        with self._lock:
            return self._hists[mode].copy()

    # -------------------------------------------------------------- ingest
    def append(self, coords, values) -> int:
        """Append one COO batch; returns the new stream version.

        Coordinates must lie inside ``shape`` (a mode-length change is a
        different stream). Duplicate coordinates are additive updates. An
        empty batch is a no-op: version and fingerprint are unchanged, so a
        serving loop that flushes on a timer keeps hitting the scheduler's
        ``reuse`` path when nothing arrived.
        """
        coords = np.ascontiguousarray(np.asarray(coords, dtype=np.int64))
        values = np.ascontiguousarray(
            np.asarray(values, dtype=np.float64).ravel())
        if coords.ndim != 2 or coords.shape[1] != self.ndim:
            raise ValueError(
                f"coords must be (batch, {self.ndim}), got {coords.shape}")
        if values.shape[0] != coords.shape[0]:
            raise ValueError(
                f"{values.shape[0]} values for {coords.shape[0]} coords")
        if coords.shape[0] == 0:
            with self._lock:
                return self._version
        if coords.min() < 0:
            raise ValueError("coordinates must be non-negative")
        for n, L in enumerate(self.shape):
            hi = int(coords[:, n].max())
            if hi >= L:
                raise ValueError(
                    f"mode-{n} coordinate {hi} out of bounds for "
                    f"length {L}")
        with self._lock:
            self._coords.append(coords)
            self._values.append(values)
            self._version += 1
            h = hashlib.sha1()
            h.update(self._fp.encode())
            h.update(coords)  # the bytes of coords.tobytes(), uncopied
            h.update(values)
            self._fp = h.hexdigest()
            for n in range(self.ndim):
                self._hists[n] += np.bincount(
                    coords[:, n], minlength=self.shape[n])
            # duplicate-aware norm update: ||T||^2 changes by
            # (old+delta)^2 - old^2 per *unique* coordinate touched;
            # bincount adds in element order, as the reference's add.at
            flat = np.ravel_multi_index(tuple(coords.T), self.shape)
            uniq, inv = np.unique(flat, return_inverse=True)
            deltas = np.bincount(inv.ravel(), weights=values,
                                 minlength=len(uniq))
            pos = np.searchsorted(self._keys, uniq)
            found = pos < len(self._keys)
            found[found] = self._keys[pos[found]] == uniq[found]
            olds = np.zeros(len(uniq))
            olds[found] = self._acc[pos[found]]
            news = olds + deltas
            self._norm2 += float(np.sum(news * news - olds * olds))
            self._acc[pos[found]] = news[found]
            fresh = ~found
            if fresh.any():
                self._keys = np.insert(self._keys, pos[fresh], uniq[fresh])
                self._acc = np.insert(self._acc, pos[fresh], news[fresh])
            self._snapshot = None
            return self._version

    def coords_since(self, version: int) -> np.ndarray:
        """Coordinates appended after ``version`` (concatenated, in order).

        For external consumers tracking a stream against a known version.
        The scheduler does not read the live stream for its invalidation
        input: it slices its own snapshot, so a racing append can never
        produce a policy extension longer than the tensor it extends.
        """
        with self._lock:
            if not 0 <= version <= self._version:
                raise ValueError(
                    f"version {version} outside [0, {self._version}]")
            chunks = self._coords[version:]
            if not chunks:
                return np.zeros((0, self.ndim), dtype=np.int64)
            return np.concatenate(chunks, axis=0)

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> SparseTensor:
        """The stream's current state as a ``SparseTensor``.

        Its memoized fingerprint is the chain fingerprint (repeated
        snapshots at one version hit the same plan-cache entry), and it
        carries ``_stream_version`` and ``_true_norm2``. Cached until the
        next append. Its arrays are its own (concatenated copies), so a
        caller reusing an appended buffer cannot change a snapshot whose
        fingerprint keys the plan and upload caches.
        """
        with self._lock:
            if self._snapshot is not None:
                return self._snapshot
            if self._coords:
                coords = np.concatenate(self._coords, axis=0)
                values = np.concatenate(self._values, axis=0)
            else:
                coords = np.zeros((0, self.ndim), dtype=np.int64)
                values = np.zeros(0, dtype=np.float64)
            t = SparseTensor(coords, values, self.shape)
            object.__setattr__(t, "_fingerprint", self._fp)
            object.__setattr__(t, "_stream_version", self._version)
            # duplicates make sum(values**2) != ||T||^2; hand consumers
            # the maintained true norm (fit_score prefers it)
            object.__setattr__(t, "_true_norm2", max(self._norm2, 0.0))
            self._snapshot = t
            return t
