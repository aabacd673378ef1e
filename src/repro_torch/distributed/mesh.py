"""RankMesh: the P ranks of a distributed run spread over device groups.

The port of ``make_ranks_mesh`` (``src/repro/distributed/executor.py``) and
of ``jax_compat.make_mesh_auto`` for the ``ranks`` axis. The reference puts
one rank on each of P devices and runs each mode step inside ``shard_map``.
Here a mesh is an ordered list of G **device groups**: group g holds ranks
``g*P/G .. (g+1)*P/G - 1``, stacked on ``devices[g]`` as the single-device
executor stacks all P. G = 1 is that executor exactly.

What lives where (``distributed.executor``, ``engine.zbuild``,
``engine.oracle``):

* each group holds its ranks' elements and builds and multiplies their Z
  (``kron_segsum_gather``/``kron_segsum_oracle`` and ``oracle_pair``, one
  launch per group, P/G stacked ranks per call) on its own stream;
* the first group's device is the mesh's **home**: the comm spaces' gather
  maps and rank sums, the Lanczos state, the core and the fit stay there, in
  the stacked layout, so ranks are summed in the same order as when they
  are stacked. The u-space is not sharded over the groups' devices.

``to_group`` and ``to_home`` are the only ways a tensor crosses between
groups. Each orders the reading stream behind the writing one with an
event (``wait_stream``), never a device-wide synchronize. A group on the
home device reads the tensor in place and marks it read on its stream
(``record_stream``), so the caching allocator cannot hand the block out
again before that read has run; across devices the copy itself is ordered
against both streams. ``moved_bytes`` counts what crossed between groups
(everything but the home group's own traffic), whether or not the devices
differ: on one card, with a device repeated, it is what a mesh over
distinct cards would move.

A device may appear more than once: ``["cpu"] * G`` runs the group path on
the CPU, and ``[cuda:0] * G`` on one card, each group on its own stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

from repro_torch.device import indexed_device, on_device

__all__ = ["RankMesh", "make_ranks_mesh"]


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
        self._moved = 0

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
            return self._moved

    def _count(self, t: torch.Tensor, g: int) -> None:
        if g:
            with self._lock:
                self._moved += t.numel() * t.element_size()

    @contextlib.contextmanager
    def group(self, g: int):
        """Run what follows on group g: its device current, its stream the
        current stream there."""
        dev, stream = self.devices[g], self.streams[g]
        with on_device(dev), (torch.cuda.stream(stream) if stream is not None
                              else contextlib.nullcontext()):
            yield

    def to_group(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """``x``, written at home on the current stream, for group g to read
        on its stream."""
        self._count(x, g)
        dev, stream = self.devices[g], self.streams[g]
        if stream is None:
            return x.to(dev)
        stream.wait_stream(torch.cuda.current_stream(self.home))
        if dev == self.home:
            x.record_stream(stream)
            return x
        with self.group(g):  # the copy waits for both devices' streams
            return x.to(dev, non_blocking=True)

    def to_home(self, y: torch.Tensor, g: int) -> torch.Tensor:
        """``y``, written by group g on its stream, for home to read on the
        current stream."""
        self._count(y, g)
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

    def synchronize(self) -> None:
        """Wait for every group's device (CUDA); off CUDA nothing."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


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
