"""Where a captured mode step first rounds apart from the same step run
eagerly, on the card.

A captured step (``repro_torch.graphs``) records the eager step's kernels,
so its outputs should be the eager step's bits; on some plans they differ
in the last bits. This script finds where. Per mode step of a plan
(``fused_block8``: ``lanczos_block=8``, the fused Z-build, ``oracle_pair``),
it runs the step eagerly and through the executor's capture, logging every
aten op's CUDA inputs and outputs (a ``TorchDispatchMode``; under capture
the logged copies are graph nodes, read after the capture's own run), then
compares

* the outputs of each segment (what each host call between segments reads:
  the small bidiagonal matrix, the sketch's panels) and the step's outputs;
* op by op, the first op whose output differs, whether its inputs were
  equal, and what it does when run alone on those inputs: eagerly on the
  default stream, eagerly on a side stream, and captured on a side stream,
  with the CUDA kernels each ran (``torch.profiler``).

Run on a card from the repo root::

    PYTHONPATH=src python -m repro_torch.capture_diff [--out FILE]

It builds ``synth_tensor((1200, 900, 2800), 3_000_000)`` and its Lite plan
for P = 4 ranks and core (10, 10, 10), and prints one JSON line per step
(written to ``--out`` too).
"""

from __future__ import annotations

import argparse
import contextlib
import difflib
import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

SHAPE, NNZ, CORE, P = (1200, 900, 2800), 3_000_000, (10, 10, 10), 4
KNOBS = dict(block_size=8, fused_zbuild=True, use_fused=True)
# ops whose CUDA output is a seam's own copy, not the step's arithmetic
_SKIP = ("aten._to_copy", "aten.empty")


class OpLog(TorchDispatchMode):
    """Every non-view aten op's CUDA inputs and outputs, copied, while
    ``active()`` and not ``paused``: ``ops`` holds (func, inputs,
    outputs)."""

    def __init__(self, active):
        super().__init__()
        self.active = active
        self.paused = False
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils._pytree import tree_leaves

        kwargs = kwargs or {}
        logged = self.active() and not self.paused and not func.is_view \
            and not str(func).startswith(_SKIP)
        ins = [a.clone() for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor) and a.is_cuda] \
            if logged else None
        out = func(*args, **kwargs)
        if logged:
            outs = [o.clone() for o in tree_leaves(out)
                    if isinstance(o, torch.Tensor) and o.is_cuda]
            if outs:
                self.ops.append((func, args, kwargs, ins, outs))
        return out


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def _gap(a: list, b: list) -> float:
    return max((float((x.double() - y.double()).abs().max())
                for x, y in zip(a, b) if x.numel() and x.shape == y.shape),
               default=0.0)


@contextlib.contextmanager
def _paused(log: OpLog, targets: list):
    """While any of ``targets`` ((object, attribute) of a callable) runs,
    ``log`` is paused; ``calls`` records each call's argument tensors and
    the op count at its start."""
    calls: list = []
    saved = [(obj, name, getattr(obj, name)) for obj, name in targets]

    def wrap(real):
        def call(*a, **k):
            log.paused = True
            try:
                calls.append((len(log.ops), [t.clone() for t in a
                                             if isinstance(t, torch.Tensor)]))
                return real(*a, **k)
            finally:
                log.paused = False
        return call

    for obj, name, real in saved:
        setattr(obj, name, wrap(real))
    try:
        yield calls
    finally:
        for obj, name, real in saved:
            setattr(obj, name, real)


def _kernels(run) -> list:
    """The CUDA kernels ``run()`` executes, by name (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)


def _alone(func, args, kwargs, ins_eager: list) -> dict:
    """``func`` on the eager run's inputs, alone: eagerly on the default
    stream, eagerly on a side stream and captured on a side stream; each
    output's bits and the kernels each ran."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    def fresh():  # the op's arguments with the eager inputs put back
        leaves, spec = tree_flatten((args, kwargs))
        it = iter(ins_eager)
        leaves = [next(it).clone() if isinstance(a, torch.Tensor)
                  and a.is_cuda else a for a in leaves]
        return tree_unflatten(leaves, spec)

    def outs(out):
        from torch.utils._pytree import tree_leaves
        return [o.clone() for o in tree_leaves(out)
                if isinstance(o, torch.Tensor) and o.is_cuda]

    got = {}
    a, k = fresh()
    got["default_stream"] = outs(func(*a, **k))
    names = {"default_stream": _kernels(lambda: func(*fresh()[0],
                                                     **fresh()[1]))}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a, k = fresh()
        got["side_stream"] = outs(func(*a, **k))
        names["side_stream"] = _kernels(lambda: func(*fresh()[0],
                                                     **fresh()[1]))
        a, k = fresh()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = func(*a, **k)
        graph.replay()
        torch.cuda.synchronize()
        got["captured"] = outs(out)
        names["captured"] = _kernels(graph.replay)
    torch.cuda.synchronize()
    return {"outputs": got, "kernels": names}


def diff_step(ex, up, mp, spec, factors, key) -> dict:
    """One mode step eagerly and captured (the executor's first call over
    the plan's arrays), logged and compared."""
    from repro_torch import graphs
    from repro_torch.core import lanczos, sketch
    from repro_torch.distributed.executor import _tally, step_spec
    from repro_torch.engine.steps import make_mode_step_fn

    kw = dict(KNOBS, precision=spec.precision, block_size=spec.block_size,
              fused_zbuild=spec.fused_zbuild, warm_start=spec.warm_start)
    skey, step = ex._get_step(mp, spec.backend, spec.K_n, niter=spec.niter,
                              objective=spec.objective, **kw)
    eager = make_mode_step_fn(step_spec(mp, **kw), spec.backend, spec.K_n,
                              spec.niter)
    arrs = up.arrs[mp.mode]
    eager(arrs, factors, key)  # the kernels built, their scratch grown
    torch.cuda.synchronize()

    with OpLog(lambda: True) as elog, _paused(
            elog, [(lanczos, "host_call"), (sketch, "host_call")]) as ecuts:
        want = eager(arrs, factors, key)
    torch.cuda.synchronize()
    with OpLog(torch.cuda.is_current_stream_capturing) as clog, _paused(
            clog, [(graphs.StepGraph, "cut"),
                   (graphs.StepGraph, "_begin")]):
        got = ex._call_step(skey, step, up, arrs, factors, key, _tally())
    torch.cuda.synchronize()
    sg = next(g for k, g in up.graphs.items() if k[0] == skey)

    out = {"mode": mp.mode, "backend": spec.backend,
           "segments": len(sg.segments), "ops": [len(elog.ops),
                                                 len(clog.ops)],
           "outputs_bitwise": _equal(list(want), list(got)),
           "outputs_max_gap": _gap(list(want), list(got))}
    # what each host call between segments read (its inputs' bits)
    out["segment_outputs_bitwise"] = [
        _equal(cut_ins, [t for t in op.inputs])
        for (_, cut_ins), op in zip(ecuts, sg.host_ops)]
    names_e = [str(f) for f, *_ in elog.ops]
    names_c = [str(f) for f, *_ in clog.ops]
    # ops of one run only (a copy that makes a factor contiguous, say) are
    # set aside: the runs are compared on the longest common op sequence
    match = difflib.SequenceMatcher(None, names_e, names_c, autojunk=False)
    pairs = [(a + k, b + k) for a, b, n in match.get_matching_blocks()
             for k in range(n)]
    out["unmatched"] = {
        "eager": [names_e[i] for i in sorted(set(range(len(names_e)))
                                             - {a for a, _ in pairs})],
        "captured": [names_c[i] for i in sorted(set(range(len(names_c)))
                                                - {b for _, b in pairs})]}
    bounds = [n for n, _ in ecuts]
    for i, j in pairs:
        func, args, kwargs, ins_e, outs_e = elog.ops[i]
        _, _, _, ins_c, outs_c = clog.ops[j]
        if _equal(outs_e, outs_c):
            continue
        seg = sum(1 for b in bounds if b <= i)
        alone = _alone(func, args, kwargs, ins_e)
        out["first_diff"] = {
            "op": str(func), "index": i, "segment": seg,
            "index_in_segment": i - (bounds[seg - 1] if seg else 0),
            "shapes_in": [list(t.shape) for t in ins_e],
            "strides_in": [list(t.stride()) for t in ins_e],
            "strides_in_captured": [list(t.stride()) for t in ins_c],
            "shapes_out": [list(t.shape) for t in outs_e],
            "inputs_bitwise": _equal(ins_e, ins_c),
            "max_gap": _gap(outs_e, outs_c),
            "previous_ops": names_e[max(0, i - 3):i],
            "alone": {
                where: {"equals_eager_run": _equal(o, outs_e),
                        "equals_captured_run": _equal(o, outs_c)}
                for where, o in alone["outputs"].items()},
            "kernels": alone["kernels"]}
        break
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the JSON "
                        "lines to this file")
    parser.add_argument("--paths", default="liteopt,baseline")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("capture_diff: needs a CUDA device (a capture runs on the "
              "card only)", file=sys.stderr)
        return 1
    from repro_torch.core.hooi import random_factors
    from repro_torch.core.plan import plan
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.device import full_precision_matmul
    from repro_torch.distributed.executor import HooiExecutor, _tally
    from repro_torch.random import make_key

    full_precision_matmul()
    t = synth_tensor(SHAPE, NNZ)
    lines = []
    for path in args.paths.split(","):
        pl = plan(t, "lite", P, core_dims=CORE, path=path)
        ex = HooiExecutor(P)
        specs = ex._mode_specs(pl, CORE, path, block_size=8,
                               fused_zbuild=True)
        up = ex._get_upload(pl, t, _tally())
        factors = random_factors(t.shape, CORE, make_key(21), "cuda")
        for mp, spec in zip(pl.parts, specs):
            key = make_key(22).fold_in(1000 + mp.mode)
            row = dict(path=path, tensor=[list(SHAPE), t.nnz],
                       **diff_step(ex, up, mp, spec, factors, key))
            line = json.dumps(row)
            print("capture_diff " + line, flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
