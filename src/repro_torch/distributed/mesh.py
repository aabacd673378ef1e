"""RankMesh: the P ranks of a distributed run spread over device groups.

The port of ``make_ranks_mesh`` (``src/repro/distributed/executor.py``) and
of ``jax_compat.make_mesh_auto`` for the ``ranks`` axis. The reference puts
one rank on each of P devices and runs each mode step inside ``shard_map``.
Here a mesh is an ordered list of G **device groups**: group g holds ranks
``g*P/G .. (g+1)*P/G - 1``, stacked on ``devices[g]`` as the single-device
executor stacks all P. G = 1 is that executor exactly.

What lives where (``distributed.executor``, ``engine.zbuild``,
``engine.oracle``, ``engine.comm``, ``core.lanczos``):

* each group holds its ranks' elements and builds and multiplies their Z
  (``kron_segsum_gather``/``kron_segsum_oracle`` and ``oracle_pair``, one
  launch per group, P/G stacked ranks per call) on its own stream;
* under the ``boundary`` backend each group also holds its ranks' rows of
  the Lanczos u-space, as the reference keeps each device's shard: a
  ``GroupTensor`` of one ``(P/G, Lp[, s])`` part per group. Its inner
  products are per-rank partials on the groups, added at home in rank
  order (the reference's ``psum``);
* the first group's device is the mesh's **home**: the v-space (``K_hat``
  rows), the small bidiagonal matrix and its host SVD, the core and the
  fit stay there, as the reference replicates them. Under ``psum`` the
  u-space is replicated in the reference, and its one replica is at home.

``to_group``, ``to_home`` and ``between`` are the only ways a tensor
crosses between groups. Each orders the reading stream behind the writing
one with an event (``wait_stream``), never a device-wide synchronize. A
group on the same device reads the tensor in place and marks it read on
its stream (``record_stream``), so the caching allocator cannot hand the
block out again before that read has run; across devices the copy itself
is ordered against both streams. ``moved_bytes`` counts what crossed
between groups (everything but a group's traffic with itself), whether or
not the devices differ: on one card, with a device repeated, it is what a
mesh over distinct cards would move. ``moved_by_kind`` splits it:
``"factors"`` for the factor rows each group's Z-build reads (and the
sketch seed's factor columns) and the factor shards coming home, ``"u"``
for everything of the comm space and the Lanczos body.

**The u-space bytes of a boundary mode step** (``u_space_bytes``), in f32
words (a breakdown flag is one byte), with ``q = P/G`` ranks a group,
``K`` = ``K_hat``, ``s`` the panel width (1: the vector driver), ``T`` the
u-basis width (the vector driver's ``niter``; ``m*s`` for ``m`` block
iterations), ``k`` the factor's columns and ``S_x`` the plan's boundary
slots whose computing rank and owner lie in different groups (``S_x <=
S <= S_pad``; ``B_pad`` bounds the slots of one owner rank, so ``S_x <=
P*B_pad``):

* a product ``Z @ x``: ``(G-1)*K*s`` (``x`` out; the fused Z-build's
  first panel counts as this) + ``S_x*s`` (boundary rows computed on one
  group for an owner on another);
* a product ``Zᵀ @ y``: ``S_x*s`` (owners' boundary rows out to the
  groups that hold them) + ``(G-1)*q*K*s`` (the groups' partials home);
* an inner product: ``(G-1)*q`` partials home; a projection on the
  width-``T`` basis: ``(G-1)*(q+1)*T*c`` (partials home, coefficients
  out; ``c`` = 1 for a vector, ``s`` for a panel); a home scalar a group
  op reads: ``G-1`` words;
* per vector iteration: one ``Z @ x`` and one ``Zᵀ @ y``, 4 vector
  projections, 2 inner products, 3 scalars and a flag; per block
  iteration: one of each product, 2 panel projections, ``2 s²`` inner
  products, ``2 s²`` scalars, ``2 s`` vector projections, ``s`` flags
  and the ``s × s`` coupling block out; after the last, the ``T × k``
  rotation of the small SVD out;
* the sketch warm start adds its seed's partials home, ``(G-1)*q*K*w``
  for ``w`` seed columns (the factor columns out are ``"factors"``), and
  one ``Z @ x`` and one ``Zᵀ @ y`` per power iteration.

No term grows with ``Lp`` or ``R_pad``: the rows stay where they are
computed. The factor bytes are each non-home group's factor rows, and the
non-home shards ``(G-1)*q*Lp*k`` coming home once a mode step.

A device may appear more than once: ``["cpu"] * G`` runs the group path on
the CPU, and ``[cuda:0] * G`` on one card, each group on its own stream.

A mesh whose groups all lie on one card has its steps captured as CUDA
graphs (``repro_torch.graphs``): each segment of a capture forks every
group's stream from the capturing stream (``fork``) and joins them back
before it ends (``join``), so the groups' launches are branches of one
graph. ``moved_bytes`` is counted in Python as a step runs; a captured
step records its segments' counts (``graphs.tally``) and each replay adds
them again (``add_moved``), so a captured run counts the eager run's bytes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.device import indexed_device, on_device
from repro_torch.graphs import tally

__all__ = ["RankMesh", "GroupTensor", "make_ranks_mesh", "u_space_bytes",
           "MOVE_KINDS"]

MOVE_KINDS = ("u", "factors")  # what ``moved_by_kind`` splits


class RankMesh:
    """P ranks over an ordered list of device groups (see the module
    docstring). ``devices[g]`` holds ranks ``ranks_of(g)``; ``home`` is
    ``devices[0]``; ``streams[g]`` is group g's CUDA stream (None on the
    CPU)."""

    def __init__(self, P_ranks: int, devices: Sequence):
        self.P = int(P_ranks)
        self.devices = tuple(indexed_device(d) for d in devices)
        self.G = len(self.devices)
        if self.P < 1 or self.G < 1 or self.P % self.G:
            raise ValueError(f"{self.G} device groups do not split P="
                             f"{P_ranks} ranks evenly")
        kinds = {d.type for d in self.devices}
        if len(kinds) > 1:
            raise ValueError(f"a mesh is all CUDA or all CPU, got "
                             f"{[str(d) for d in self.devices]}")
        self.per_group = self.P // self.G
        self.home = self.devices[0]
        self.streams = tuple(
            torch.cuda.Stream(d) if d.type == "cuda" else None
            for d in self.devices)
        self._lock = threading.Lock()
        self._moved = dict.fromkeys(MOVE_KINDS, 0)

    def __repr__(self) -> str:
        return (f"RankMesh(P={self.P}, devices="
                f"{[str(d) for d in self.devices]})")

    def ranks_of(self, g: int) -> range:
        return range(g * self.per_group, (g + 1) * self.per_group)

    def key(self) -> tuple:
        """The mesh's content, as the reference keys a shared executor by
        its mesh: equal for meshes of the same P over the same devices."""
        return (self.P, tuple(str(d) for d in self.devices))

    @property
    def moved_bytes(self) -> int:
        """Bytes that have crossed between groups through this mesh."""
        with self._lock:
            return sum(self._moved.values())

    @property
    def moved_by_kind(self) -> dict:
        """``moved_bytes`` by kind: ``{"u": ..., "factors": ...}``."""
        with self._lock:
            return dict(self._moved)

    def add_moved(self, kind: str, nbytes: int) -> None:
        """Count ``nbytes`` of ``kind`` as crossed between groups."""
        with self._lock:
            self._moved[kind] += int(nbytes)

    def _count(self, t: torch.Tensor, crossed: bool, kind: str) -> None:
        if kind not in self._moved:
            raise ValueError(f"unknown crossing kind {kind!r}")
        nbytes = t.numel() * t.element_size()
        if crossed and tally(self, kind, nbytes):
            self.add_moved(kind, nbytes)

    def fork(self, stream) -> None:
        """Every group's stream waits for the work queued on ``stream`` (a
        CUDA stream at home): under capture, each group joins it."""
        for s in self.streams:
            if s is not None:
                s.wait_stream(stream)

    def join(self, stream) -> None:
        """``stream`` waits for the work queued on every group's stream:
        under capture, each group's branch ends in it."""
        for s in self.streams:
            if s is not None:
                stream.wait_stream(s)

    @contextlib.contextmanager
    def group(self, g: int):
        """Run what follows on group g: its device current, its stream the
        current stream there."""
        dev, stream = self.devices[g], self.streams[g]
        with on_device(dev), (torch.cuda.stream(stream) if stream is not None
                              else contextlib.nullcontext()):
            yield

    def each(self, make) -> list:
        """``[make(g) for every group g]``, each on its group."""
        out = []
        for g in range(self.G):
            with self.group(g):
                out.append(make(g))
        return out

    def to_group(self, x: torch.Tensor, g: int, kind: str = "u"
                 ) -> torch.Tensor:
        """``x``, written at home on the current stream, for group g to read
        on its stream."""
        self._count(x, g != 0, kind)
        dev, stream = self.devices[g], self.streams[g]
        if stream is None:
            return x.to(dev)
        stream.wait_stream(torch.cuda.current_stream(self.home))
        if dev == self.home:
            x.record_stream(stream)
            return x
        with self.group(g):  # the copy waits for both devices' streams
            return x.to(dev, non_blocking=True)

    def to_home(self, y: torch.Tensor, g: int, kind: str = "u"
                ) -> torch.Tensor:
        """``y``, written by group g on its stream, for home to read on the
        current stream."""
        self._count(y, g != 0, kind)
        dev, stream = self.devices[g], self.streams[g]
        if stream is None:
            return y.to(self.home)
        here = torch.cuda.current_stream(self.home)
        here.wait_stream(stream)
        if dev == self.home:
            y.record_stream(here)
            return y
        with self.group(g):  # the copy waits for both devices' streams
            return y.to(self.home, non_blocking=True)

    def between(self, x: torch.Tensor, h: int, g: int, kind: str = "u"
                ) -> torch.Tensor:
        """``x``, written by group h on its stream, for group g to read on
        its stream (``x`` itself when h == g)."""
        if h == g:
            return x
        self._count(x, True, kind)
        dev, stream = self.devices[g], self.streams[g]
        if stream is None:
            return x.to(dev)
        stream.wait_stream(self.streams[h])
        if dev == self.devices[h]:
            x.record_stream(stream)
            return x
        with self.group(h), self.group(g):  # both groups' streams current
            return x.to(dev, non_blocking=True)

    def synchronize(self) -> None:
        """Wait for every group's device (CUDA); off CUDA nothing."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def _stream_id(dev: torch.device) -> int | None:
    return torch.cuda.current_stream(dev).cuda_stream \
        if dev.type == "cuda" else None


class GroupTensor:
    """A u-space value of a mesh's boundary space: one ``(P/G, ...)`` part
    per group, on the group's device, made on the group's stream. Its
    logical shape is the stacked ``(P, ...)``; ``device`` is the home, where
    the small matrices and scalars it meets live.

    It carries only what the Lanczos drivers apply to u-space values:
    ``a - b``, a home scalar times a group tensor (``c * b``, through
    ``__torch_function__``), ``/`` by a home scalar, ``torch.where`` on a
    home flag, ``torch.stack``/``torch.cat``
    along a trailing dimension, indexing and assignment of trailing
    dimensions (``U[..., i] = u``), and ``@`` with a small home matrix. A
    home tensor an operation reads crosses to each group once
    (``RankMesh.to_group``, kind ``"u"``).

    **Frames.** A batched product or reduction over the stacked ranks takes
    its kernel path from its shape (cuBLAS and the reduction kernels choose
    their blocking by the batch and row counts), so the same op over a
    group's P/G ranks may round each rank apart from the stacked run. Each
    group therefore runs those ops on a *frame*: the stacked ``(P, ...)``
    layout with its own ranks filled and the others zero, and keeps its
    ranks of the result. Every rank's partial is then the stacked run's,
    bit for bit. The zero ranks never cross; they cost (G-1)/G of a small
    product. Values made by ``zeros`` and ``normal`` live in frames (their
    parts are views), and indexing keeps them, so the Lanczos basis, the
    draws and their columns are framed at no copy; other values are copied
    into a fresh frame when a product reads them.
    """

    def __init__(self, mesh: RankMesh, parts: Sequence[torch.Tensor],
                 frames: Sequence[torch.Tensor] | None = None,
                 made_on: Sequence | None = None):
        self.mesh = mesh
        self.parts = tuple(parts)
        self.frames = None if frames is None else tuple(frames)
        # the stream current where each part was made (None on the CPU)
        self.made_on = tuple(made_on) if made_on is not None else tuple(
            _stream_id(d) for d in mesh.devices)

    @classmethod
    def build(cls, mesh: RankMesh, make, framed: bool = False
              ) -> "GroupTensor":
        """``make(g)`` for every group, on its device and stream. With
        ``framed``, ``make`` returns group g's frame and the part is its
        ranks' rows."""
        made = mesh.each(lambda g: (make(g), _stream_id(mesh.devices[g])))
        outs, made_on = [m for m, _ in made], [s for _, s in made]
        if not framed:
            return cls(mesh, outs, made_on=made_on)
        parts = [f[mesh.ranks_of(g).start:mesh.ranks_of(g).stop]
                 for g, f in enumerate(outs)]
        return cls(mesh, parts, outs, made_on)

    # ----------------------------------------------------------- metadata
    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.mesh.P,) + tuple(self.parts[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return self.ndim

    def __repr__(self) -> str:
        return f"GroupTensor(shape={tuple(self.shape)}, G={self.mesh.G})"

    # ---------------------------------------------------------- crossings
    def home(self, kind: str = "u") -> torch.Tensor:
        """The stacked ``(P, ...)`` value at home: every part crosses."""
        mesh = self.mesh
        return torch.cat([mesh.to_home(p, g, kind)
                          for g, p in enumerate(self.parts)])

    def frame(self, g: int) -> torch.Tensor:
        """Group g's part in the stacked layout (see the class docstring);
        call on the group."""
        if self.frames is not None:
            return self.frames[g]
        part = self.parts[g]
        r = self.mesh.ranks_of(g)
        f = part.new_zeros((self.mesh.P,) + tuple(part.shape[1:]))
        f[r.start:r.stop] = part
        return f

    def clone(self) -> "GroupTensor":
        """A copy, each part cloned on its group's stream after the work
        queued on the current stream; the current stream then waits for
        the copies (a captured step's outputs, copied out after a
        replay)."""
        mesh = self.mesh
        here = torch.cuda.current_stream(mesh.home) \
            if mesh.home.type == "cuda" else None
        if here is not None:
            mesh.fork(here)
        out = GroupTensor.build(mesh, lambda g: self.parts[g].clone())
        if here is not None:
            mesh.join(here)
        return out

    # --------------------------------------------------------- operations
    @classmethod
    def _map(cls, func, args, kwargs) -> "GroupTensor":
        """``func`` per group: a group tensor reads its part, a home tensor
        crosses to the group (once per op), a list maps elementwise."""
        mesh = next(a.mesh for a in _leaves(args, kwargs)
                    if isinstance(a, GroupTensor))
        sent: dict = {}

        def on(g, a):
            if isinstance(a, GroupTensor):
                return a.parts[g]
            if isinstance(a, torch.Tensor):
                if (id(a), g) not in sent:
                    sent[id(a), g] = mesh.to_group(a, g)
                return sent[id(a), g]
            if isinstance(a, (list, tuple)):
                return type(a)(on(g, x) for x in a)
            return a

        for g in range(mesh.G):  # crossings on the home's stream
            for a in _leaves(args, kwargs):
                on(g, a)
        return cls.build(mesh, lambda g: func(
            *(on(g, a) for a in args),
            **{k: on(g, v) for k, v in (kwargs or {}).items()}))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.stack, torch.cat):
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            if dim >= 0:  # dim 0 is the ranks: trailing dimensions only
                raise ValueError("a group tensor stacks or concatenates "
                                 "along a trailing (negative) dimension")
        return cls._map(func, args, kwargs)

    def __sub__(self, o):
        return self._map(torch.sub, (self, o), None)

    def __truediv__(self, o):
        return self._map(torch.div, (self, o), None)

    def __getitem__(self, idx):
        _trailing(idx)
        frames = None if self.frames is None else [f[idx]
                                                   for f in self.frames]
        return GroupTensor(self.mesh, [p[idx] for p in self.parts], frames,
                           self.made_on)

    def __setitem__(self, idx, value: "GroupTensor") -> None:
        _trailing(idx)
        mesh = self.mesh
        for g, part in enumerate(self.parts):
            with mesh.group(g):
                part[idx] = value.parts[g]

    def __matmul__(self, m: torch.Tensor) -> "GroupTensor":
        """``self @ m`` for a small home matrix ``m``, on each group's
        frame."""
        mesh = self.mesh
        ms = [mesh.to_group(m, g) for g in range(mesh.G)]

        def make(g):
            r = mesh.ranks_of(g)
            return (self.frame(g) @ ms[g])[r.start:r.stop]

        return GroupTensor.build(mesh, make)


def _leaves(args, kwargs):
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, (list, tuple)):
            yield from a
        else:
            yield a


def _trailing(idx) -> None:
    if not (isinstance(idx, tuple) and idx and idx[0] is Ellipsis):
        raise IndexError("a group tensor indexes trailing dimensions only "
                         "(x[..., i])")


def u_space_bytes(P: int, G: int, S_x: int, K_hat: int, k: int, niter: int,
                  block_size: int = 1, *, blockish: bool = False,
                  seed_cols: int = 0, power_iters: int = 0) -> int:
    """Bytes of kind ``"u"`` one boundary mode step moves between a mesh's
    groups: the formula of the module docstring. ``niter`` counts block
    iterations when ``blockish`` (the block driver: a panel wider than 1,
    the fused Z-build or the sketch warm start), ``seed_cols``/
    ``power_iters`` the sketch's seed columns and power iterations."""
    q, s = P // G, int(block_size) if blockish else 1
    T = niter * s
    words = flags = 0

    def mv(c):
        return (G - 1) * K_hat * c + S_x * c

    def rmv(c):
        return S_x * c + (G - 1) * q * K_hat * c

    def proj(width, c):
        return (G - 1) * (q + 1) * width * c

    dot, scalar = (G - 1) * q, G - 1
    if blockish:
        per_iter = (mv(s) + rmv(s) + 2 * proj(T, s) + 2 * s * s * dot
                    + 2 * s * s * scalar + 2 * s * proj(T, 1)
                    + (G - 1) * s * s)
        words += niter * per_iter
        flags += niter * s * (G - 1)
        words += (G - 1) * q * K_hat * seed_cols
        words += power_iters * (mv(s) + rmv(s))
    else:
        words += niter * (mv(1) + rmv(1) + 4 * proj(T, 1) + 2 * dot
                          + 3 * scalar)
        flags += niter * (G - 1)
    kk = min(k, T)
    words += (G - 1) * T * kk  # the small SVD's rotation
    for j in range(k - kk):  # completion of a rank-deficient basis
        words += 2 * proj(kk + j, 1) + dot + scalar
    return 4 * words + flags


def make_ranks_mesh(P_ranks: int, devices: Sequence | None = None
                    ) -> RankMesh:
    """A mesh of ``P_ranks`` ranks. ``devices=None`` is the first P CUDA
    devices, one rank each, as the reference takes ``jax.devices()[:P]``:
    with fewer cards it raises, and never falls back to stacking or to the
    CPU. A given list of G devices (G dividing P) stacks P/G ranks on each;
    a device may repeat (``["cpu"] * G``, ``["cuda:0"] * G``), and
    ``"cuda"`` is the current card."""
    P = int(P_ranks)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count < P:
            raise ValueError(
                f"need {P} CUDA devices, have {count}: pass devices= to "
                f"stack several ranks on one device (e.g. ['cuda:0'] * G "
                f"or ['cpu'] * G groups)")
        devices = [torch.device("cuda", i) for i in range(P)]
    return RankMesh(P, devices)
