"""Mode steps as captured CUDA graphs: the port's counterpart of a jitted step.

The reference compiles each distributed mode step once with ``jax.jit`` and
then dispatches it as one program. Here a step is eager PyTorch code, and its
counterpart of a compilation is a **capture**: the step's launches recorded
into ``torch.cuda.CUDAGraph`` objects that later calls replay.

A step leaves the device on purpose at two kinds of points, and calls this
module there instead of moving data itself:

* ``upload(make_host, device)`` — a host tensor that depends on the step's
  random draws only: a draw of the seam (``random.Key.normal``) or
  ``block_start_panel``'s QR of one. Eagerly it is ``make_host().to(device)``.
  Under capture it is a slot of one pinned host buffer; before every replay
  the slots are refilled from the call's own key (the draws differ per
  sweep, along ``1000 + it*N + n``), and the first node of the first graph
  copies the whole buffer to the device. A pageable copy is never captured.
* ``host_call(fn, *tensors)`` — a small factorization on the host (the
  bidiagonal SVD, the sketch's QRs), which the port keeps on the host so
  that card and CPU runs share signs. Eagerly it is ``fn`` of the tensors'
  host copies, moved back. Under capture it cuts the step: the graph
  captured so far ends as one **segment** and runs, ``fn`` reads its
  outputs, and its results are copied into static device buffers of the
  same strides through pinned memory by the first nodes of the next
  segment.

``StepGraph.capture`` runs the step once eagerly on a side stream (the
warm-up: kernels built, scratch grown, the upload slots counted), then
captures it segment by segment over static inputs: the step's arrays (which
must stay the same objects), copies of the factors, and the upload slots. A
call then copies the new factors and draws in and replays the segments in
order, running the host calls between them. A step with no host call is one
segment; the default block step is two (the SVD cuts it), a sketch step
four (the seed's QR, the power iteration's QR, the SVD). A failed capture
raises; nothing falls back to the eager step.

A step over a mesh of several device groups (``distributed.mesh``: its
arrays hold ``groups``) whose groups all lie on the home's device is
captured too, the counterpart of the reference's ``jax.jit`` of a
``shard_map`` step. Each group launches on its own stream; at every
segment's begin (after the first segment's staged copy) each group's stream
is forked from the capturing stream (``RankMesh.fork``), so every launch a
group makes belongs to the capture, and before every cut and the capture's
end each is joined back (``RankMesh.join``). A replay launches each segment
on the caller's stream, the groups' branches inside it. What the groups'
crossings count (``RankMesh.moved_by_kind``) is counted in Python as the
step runs; a capture records it per segment (``tally``) and every replay
adds it again. A mesh over distinct cards is refused: a graph that spans
cards cannot be checked on one card, so the executor runs those steps
eagerly.

Every step of one ``CaptureHome`` shares its memory pool, so replays of
different steps must not overlap on the card: they are serialized under the
home's lock on the host and chained on the card through ``CaptureHome.last``,
which each replay (or capture) waits for and then records, whatever stream
the caller runs on. A pool serves captures while a graph captured into it
lives; once every one has died (the plans that held them dropped), the next
capture takes a fresh pool (``CaptureHome.pool_for_capture``).

A kernel wrapper counts only the launches it makes; a launch recorded under
capture runs at each replay, and the wrapper does not count it. A buffer a
recorded launch uses that lives outside the pool (``oracle_pair``'s scratch)
is handed to ``keep`` and lives as long as the step.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable

import torch

from repro_torch import tracing

__all__ = ["upload", "host_call", "keep", "tally", "StepGraph",
           "CaptureHome"]

_STATE = threading.local()


def _recorder():
    return getattr(_STATE, "rec", None)


@contextlib.contextmanager
def _recording(rec):
    prev = _recorder()
    _STATE.rec = rec
    try:
        yield rec
    finally:
        _STATE.rec = prev


def upload(make_host: Callable[[], torch.Tensor],
           device: str | torch.device) -> torch.Tensor:
    """``make_host()`` (a host tensor that depends on the step's draws
    only) on ``device``; under capture a slot refilled on every replay."""
    dev = torch.device(device)
    rec = _recorder()
    if rec is None or dev.type != "cuda":
        return make_host().to(device=dev)
    return rec.upload(make_host, dev)


def host_call(fn: Callable, *tensors: torch.Tensor):
    """``fn`` of the tensors' host copies, with its results (a tensor or a
    tuple of tensors, on the host) moved to the tensors' device; under
    capture a cut between two segments."""
    rec = _recorder()
    if rec is None or rec.mode != "capture" or not tensors[0].is_cuda:
        with tracing.span("graphs.cut"):
            outs = fn(*(t.cpu() for t in tensors))
            dev = tensors[0].device
            single = isinstance(outs, torch.Tensor)
            outs = tuple(o.to(dev) for o in ((outs,) if single else outs))
            tracing.count("graphs.cut_bytes", _nbytes(tensors + outs))
        return outs[0] if single else outs
    return rec.cut(fn, tensors)


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


def keep(*objs) -> None:
    """Keep ``objs`` alive as long as the step being captured (a buffer
    outside the capture pool that a recorded launch reads or writes); no-op
    outside a capture."""
    rec = _recorder()
    if getattr(rec, "mode", None) == "capture":
        rec.kept.extend(objs)


def tally(counter, kind: str, nbytes: int) -> bool:
    """Whether ``counter`` (a ``RankMesh``) counts ``nbytes`` of ``kind``
    that a step moves between groups now: outside a capture yes; in a
    capture's eager warm-up no (it is not a run); in a capture yes, and they
    are recorded against the segment being captured, so that every replay
    of it adds them again."""
    rec = _recorder()
    return True if rec is None else rec.tally(counter, kind, nbytes)


class _KeySlot:
    """A draw that forwards to the key of the current call: the captured
    step's closures hold keys built on it, so each replay draws along its
    own call's paths."""

    def __init__(self, key):
        self.key = key

    def __call__(self, path, shape, **params):
        return self.key.draw(self.key.path + tuple(path), shape, **params)


class CaptureHome:
    """What the captured steps of one executor share on one device: a
    memory pool, the side stream their warm-ups and captures run on, and
    the event that orders them. The steps' intermediates share the pool's
    blocks, so no two replays may overlap on the card: they run under
    ``lock``, and each one's stream first waits for ``last``, the end of the
    one before, then records it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.RLock()
        self.last = torch.cuda.Event()  # no wait before its first record
        self.renew()

    def renew(self) -> None:
        """A fresh pool and side stream. After a failed capture the old
        ones may still be marked as capturing (the allocator keeps routing
        the stream's allocations into the pool), so they are left behind;
        graphs captured into the old pool keep it alive and stay valid."""
        self.new_pool()
        self.stream = torch.cuda.Stream(self.device)

    def new_pool(self) -> None:
        # the graphs captured into ``pool`` that are alive: a pool lives as
        # long as one of them (PyTorch counts its uses by live graphs, and
        # one that has dropped to none cannot be captured into again)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = weakref.WeakSet()

    def pool_for_capture(self) -> tuple:
        """The pool a segment about to be captured goes into: ``pool``, or
        a fresh one when every graph captured into it has died (a plan
        dropped with its steps), for its uses can no longer grow."""
        if not self.graphs:
            self.new_pool()
        return self.pool


@dataclasses.dataclass
class _HostOp:
    fn: Callable
    inputs: tuple  # static device tensors of the segment before
    pinned: tuple  # pinned host buffers the next segment copies in
    outputs: tuple  # the device buffers it copies them to (kept alive)


@dataclasses.dataclass
class _Warmup:
    """Recorder of the eager warm-up: the upload slots, in call order."""

    slots: list = dataclasses.field(default_factory=list)
    mode: str = "warmup"

    def upload(self, make_host, dev):
        val = make_host()
        self.slots.append((make_host, tuple(val.shape), val.dtype))
        return val.to(device=dev)

    def tally(self, counter, kind, nbytes) -> bool:
        return False


class StepGraph:
    """One captured step: its segments, host calls and static buffers."""

    mode = "capture"

    def __init__(self, home: CaptureHome, arrs, factors, mesh=None):
        self.home = home
        self.arrs = arrs
        self.mesh = mesh  # whose group streams each segment forks and joins
        self.moved: list[collections.Counter] = []  # per segment
        self.shapes = tuple(tuple(f.shape) for f in factors)
        self.segments: list[torch.cuda.CUDAGraph] = []
        self.kept: list = []  # buffers outside the pool the launches use
        self.host_ops: list[_HostOp] = []
        self.outputs: tuple = ()
        self.single = False  # the step returns one tensor, not a tuple
        self.slot = None
        self.slots: list = []  # (make_host, shape, offset, numel)
        self.pinned = self.staged = None
        self.factors: list[torch.Tensor] = []
        self._next_slot = 0
        self._graph = None
        self._done = None

    # ------------------------------------------------------------ capture
    @classmethod
    def capture(cls, home: CaptureHome, fn: Callable, arrs, factors, key,
                mesh=None):
        """Warm up, capture and run ``fn(arrs, factors, key)``; returns the
        step and its first outputs (copies). ``mesh`` is the ``RankMesh``
        whose groups the step runs on (all on ``home.device``)."""
        from repro_torch.random import Key

        if len(arrs.get("groups", ())) > 1 and (mesh is None or any(
                d != home.device for d in mesh.devices)):
            raise ValueError(
                "a step over several device groups is captured only when "
                "every group lies on the home's device: a graph that spans "
                "cards cannot be checked on one card (the executor runs it "
                "eagerly)")
        dev = home.device
        sg = cls(home, arrs, factors, mesh)
        sg.slot = _KeySlot(key)
        skey = Key(sg.slot, ())
        sg.factors = [torch.empty(f.shape, dtype=f.dtype, device=dev)
                      .copy_(f) for f in factors]
        caller = torch.cuda.current_stream(dev)
        home.stream.wait_stream(caller)
        home.stream.wait_event(home.last)
        warm = _Warmup()
        with torch.cuda.stream(home.stream), _recording(warm):
            fn(arrs, sg.factors, skey)
        home.stream.synchronize()
        off = 0
        for make_host, shape, dtype in warm.slots:
            if dtype != torch.float32:
                raise RuntimeError(f"a captured step uploads {dtype} "
                                   f"{shape}: only float32 draws are staged")
            n = 1
            for s in shape:
                n *= int(s)
            sg.slots.append((make_host, shape, off, n))
            off += n
        sg.pinned = torch.empty(max(off, 1), dtype=torch.float32,
                                pin_memory=True)
        sg.staged = torch.empty(max(off, 1), dtype=torch.float32, device=dev)
        sg._fill(sg._draw())
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(home.stream), _recording(sg):
            try:
                sg._begin(first=True)
                out = fn(arrs, sg.factors, skey)
                sg._end()
            except BaseException:
                sg._abort()
                home.renew()
                raise
            if sg._next_slot != len(sg.slots):
                raise RuntimeError(
                    f"the capture made {sg._next_slot} uploads, the "
                    f"warm-up {len(sg.slots)}: the step is not the same "
                    "code twice")
            sg.single = not isinstance(out, (tuple, list))
            sg.outputs = (out,) if sg.single else tuple(out)
            sg._replay_segment(len(sg.segments) - 1, count=False)
            result = sg._results()
        caller.wait_stream(home.stream)
        sg._done = torch.cuda.Event()
        sg._done.record(caller)
        home.last.record(caller)
        return sg, result

    def _begin(self, first: bool = False, copies=()) -> None:
        """Begin a segment: the first one copies every upload slot in, a
        later one the host call's results (``copies``: (device, pinned)
        pairs); then every group's stream forks from the capture."""
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.home.pool_for_capture(),
                                  capture_error_mode="thread_local")
        self.home.graphs.add(self._graph)
        self.moved.append(collections.Counter())
        if first:  # every upload slot, in one copy
            self.staged.copy_(self.pinned, non_blocking=True)
        for d, p in copies:
            d.copy_(p, non_blocking=True)
        if self.mesh is not None:
            self.mesh.fork(self.home.stream)

    def _end(self) -> None:
        """Join every group's stream back, and end the segment."""
        if self.mesh is not None:
            self.mesh.join(self.home.stream)
        self._graph.capture_end()
        self.segments.append(self._graph)
        self._graph = None

    def _abort(self) -> None:
        """End a capture that failed, so the streams are usable again."""
        if self._graph is not None:
            if self.mesh is not None:
                with contextlib.suppress(RuntimeError):
                    self.mesh.join(self.home.stream)
            with contextlib.suppress(RuntimeError):
                self._graph.capture_end()
            self._graph = None

    def tally(self, counter, kind, nbytes) -> bool:
        self.moved[-1][counter, kind] += nbytes
        return True

    def upload(self, make_host, dev) -> torch.Tensor:
        i = self._next_slot
        if i >= len(self.slots):
            raise RuntimeError("the capture made more uploads than the "
                               "warm-up")
        _, shape, off, n = self.slots[i]
        self._next_slot += 1
        return self.staged[off:off + n].view(shape)

    def cut(self, fn, tensors):
        """End the segment, run it, run ``fn`` on the host, and begin the
        next segment with the copies of its results."""
        self._end()
        # the capture counted this segment's crossings as it ran
        self._replay_segment(len(self.segments) - 1, count=False)
        outs = fn(*(t.cpu() for t in tensors))
        single = isinstance(outs, torch.Tensor)
        outs = (outs,) if single else tuple(outs)
        # the buffers keep the results' strides (LAPACK's column-major
        # factors), as an eager host call's results keep them: a product
        # that reads one then makes the eager step's library call
        pinned = tuple(torch.empty_strided(o.shape, o.stride(), dtype=o.dtype,
                                           pin_memory=True).copy_(o)
                       for o in outs)
        dev = tuple(torch.empty_strided(o.shape, o.stride(), dtype=o.dtype,
                                        device=self.home.device)
                    for o in outs)
        self.host_ops.append(_HostOp(fn, tuple(tensors), pinned, dev))
        self._begin(copies=zip(dev, pinned))
        return dev[0] if single else dev

    # ------------------------------------------------------------- replay
    def _draw(self) -> list[torch.Tensor]:
        """Every upload slot's host values for the current key."""
        vals = []
        for make_host, shape, _, _ in self.slots:
            val = make_host()
            if tuple(val.shape) != shape:
                raise RuntimeError(f"an upload slot of shape {shape} got "
                                   f"{tuple(val.shape)}")
            vals.append(val)
        return vals

    def _fill(self, vals: list[torch.Tensor]) -> None:
        for val, (_, _, off, n) in zip(vals, self.slots):
            self.pinned[off:off + n].copy_(val.reshape(-1))

    def _results(self):
        # a ``GroupTensor`` output clones its parts on their groups' streams
        result = tuple(o.clone() for o in self.outputs)
        return result[0] if self.single else result

    def _replay_segment(self, i: int, count: bool = True) -> None:
        """Replay segment i; with ``count``, its crossings count again."""
        self.segments[i].replay()
        if count:
            for (counter, kind), n in self.moved[i].items():
                counter.add_moved(kind, n)

    def __call__(self, arrs, factors, key):
        """Replay on the current stream with new factors and draws."""
        if arrs is not self.arrs:
            raise RuntimeError("a captured step replays over the arrays it "
                               "was captured with")
        if tuple(tuple(f.shape) for f in factors) != self.shapes:
            raise RuntimeError(
                f"factor shapes {[tuple(f.shape) for f in factors]} "
                f"differ from the captured {self.shapes}")
        with self.home.lock:
            stream = torch.cuda.current_stream(self.home.device)
            self.slot.key = key
            vals = self._draw()  # on the host while the card still works
            with tracing.span("graphs.wait"):
                # the last replay has read the buffers
                self._done.synchronize()
            self._fill(vals)
            stream.wait_event(self.home.last)
            for s, f in zip(self.factors, factors):
                s.copy_(f)
            with tracing.span("graphs.replay", device=True):
                for i in range(len(self.segments)):
                    self._replay_segment(i)
                    if i < len(self.host_ops):
                        op = self.host_ops[i]
                        with tracing.span("graphs.cut"):
                            outs = op.fn(*(t.cpu() for t in op.inputs))
                            outs = (outs,) if isinstance(outs, torch.Tensor) \
                                else tuple(outs)
                            for p, o in zip(op.pinned, outs):
                                p.copy_(o)
                            tracing.count("graphs.cut_bytes",
                                          _nbytes(op.inputs + op.pinned))
            result = self._results()
            self._done.record(stream)
            self.home.last.record(stream)
        return result
