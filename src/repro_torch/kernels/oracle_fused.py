"""Wrapper of the CUDA ``oracle_pair`` kernel (``csrc/oracle_pair.cu``).

Replaces the TPU kernel ``src/repro/kernels/oracle_fused.py::oracle_pair``:
``(Z @ x, Zᵀ @ y)`` in one launch over Z, for vectors or width-``s``
panels; either half may be left out. With ``P`` the call takes P stacked
ranks (the reference's per-rank ``shard_map`` body, written out as a batch
dimension): Z is ``(P*R, K)``, y ``(P, R[, s])`` and the second product
``(P, K[, s])``, each rank's ``Z_pᵀ y_p``.

A tensor on the CPU goes to the plain version (``ref.oracle_pair_ref``); a
CUDA tensor goes to the kernel, and anything the kernel does not take
raises. The per-call host work is kept small: shape checks on attributes,
one ``torch.empty`` per output, the current stream's raw handle (the one
``torch.cuda.current_stream(dev).cuda_stream`` gives, without building a
``Stream`` object on every call; under capture the capturing stream), and
the kernel's reduction scratch kept here per stream and reused, so calls on
different streams of one device (a mesh's device groups) never share it
(a captured step holds the scratch its recorded launches write,
``graphs.keep``).

``oracle_pair.launches`` counts the calls that launched the kernel; a call
under stream capture records a launch and is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.graphs import keep

from . import build, ref

__all__ = ["oracle_pair"]

_FN = None
_GEOMETRY = {}  # (device index, R, K, s, with y) -> (rb, bpr, groups)
_SCRATCH = {}  # (device index, stream) -> (part, gpart, ticket), grown


def _launcher():
    global _FN
    if _FN is None:
        lib = build.load("oracle_pair")
        fn = lib.oracle_pair_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        geo = lib.oracle_pair_geometry
        geo.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        geo.restype = ctypes.c_int
        _FN = (fn, geo)
    return _FN


def _geometry(dev: torch.device, R: int, K: int, s: int, with_y: bool
              ) -> tuple[int, int, int]:
    """(rows per block, blocks per rank, reduction groups per rank)."""
    key = (dev.index, R, K, s, with_y)
    got = _GEOMETRY.get(key)
    if got is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out = [ctypes.c_int() for _ in range(3)]
        if _launcher()[1](R, K, s, sms, int(with_y),
                          *(ctypes.byref(o) for o in out)):
            raise ValueError(f"oracle_pair stages whole rows of Z in shared "
                             f"memory: K = {K} with s = {s} is too wide")
        got = _GEOMETRY[key] = tuple(o.value for o in out)
    return got


def _scratch(dev: torch.device, stream: int, n_part: int, n_gpart: int,
             n_ticket: int):
    """Partials, group sums and zeroed tickets of ``stream`` (a raw
    handle), at least these sizes; calls stream-ordered behind each other
    share them. The kernel leaves its tickets zero, so a buffer is zeroed
    only when made.

    A captured step records the scratch's address, so under capture the
    scratch is handed to the step to keep (``graphs.keep``): a larger call
    replaces it here, and the old buffer lives on as long as the steps that
    write it. It may not grow during a capture (the eager warm-up before it
    grows it at the same shapes)."""
    have = _SCRATCH.get((dev.index, stream))
    capturing = torch.cuda.is_current_stream_capturing()
    if have is None or have[0].numel() < n_part or have[1].numel() < n_gpart \
            or have[2].numel() < n_ticket:
        if capturing:
            raise RuntimeError("oracle_pair's scratch would grow during a "
                               "capture; run the step eagerly first")
        n_part = max(n_part, 0 if have is None else have[0].numel())
        n_gpart = max(n_gpart, 0 if have is None else have[1].numel())
        n_ticket = max(n_ticket, 0 if have is None else have[2].numel())
        have = _SCRATCH[(dev.index, stream)] = (
            torch.empty(n_part, dtype=torch.float32, device=dev),
            torch.empty(n_gpart, dtype=torch.float32, device=dev),
            torch.zeros(n_ticket, dtype=torch.int32, device=dev))
    if capturing:
        keep(have)
    return have


def oracle_pair(
    Z: torch.Tensor,  # (P*R, K) float32
    x: torch.Tensor | None,  # (K,) or (K, s)
    y: torch.Tensor | None,  # (R,) / (R, s), or with P: (P, R) / (P, R, s)
    P: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Returns ``(Z @ x, Zᵀ @ y)``; x and y share vector-ness and width.

    Either operand may be None, and then so is its product and the kernel
    skips that half: the Lanczos loop asks for one product at a time. With
    ``P`` ranks stacked in Z, y carries a leading rank dimension and the
    second product is ``(P, K[, s])``; Z @ x is over all rows as without P.
    """
    if Z.dim() != 2 or (x is None and y is None):
        raise ValueError(f"expected Z (R, K) and at least one of x, y; got "
                         f"{tuple(Z.shape)}, {_shape(x)}, {_shape(y)}")
    RP, K = Z.shape
    nP = 1 if P is None else int(P)
    if nP < 1 or RP % nP:
        raise ValueError(f"{RP} rows of Z do not split into P={P} ranks")
    R = RP // nP
    lead = () if P is None else (nP,)
    given = x if x is not None else y
    vec = given.dim() == (1 if x is not None else 1 + len(lead))
    s = 1 if vec else given.shape[-1]
    tail = () if vec else (s,)
    if (x is not None and tuple(x.shape) != (K, *tail)) or \
            (y is not None and tuple(y.shape) != (*lead, R, *tail)):
        raise ValueError(f"shapes do not match: Z {tuple(Z.shape)}, P={P}, "
                         f"x {_shape(x)}, y {_shape(y)}")
    if Z.dtype != torch.float32 or (x is not None and x.dtype != Z.dtype) \
            or (y is not None and y.dtype != Z.dtype):
        raise TypeError(f"expected float32 operands; got {Z.dtype}, "
                        f"{None if x is None else x.dtype}, "
                        f"{None if y is None else y.dtype}")
    dev = Z.device
    if (x is not None and x.device != dev) or \
            (y is not None and y.device != dev):
        raise ValueError(f"operands on different devices: {dev}, "
                         f"{None if x is None else x.device}, "
                         f"{None if y is None else y.device}")
    if dev.type == "cpu":
        return ref.oracle_pair_ref(Z, x, y, P)
    if dev.type != "cuda":
        raise ValueError(f"oracle_pair runs on CUDA or CPU tensors, "
                         f"not {dev}")
    if not (Z.is_contiguous() and (x is None or x.is_contiguous())
            and (y is None or y.is_contiguous())):
        raise ValueError("oracle_pair needs contiguous Z, x and y")
    xo = None if x is None else torch.empty(
        (RP, *tail), dtype=torch.float32, device=dev)
    yo = None if y is None else torch.empty(
        (*lead, K, *tail), dtype=torch.float32, device=dev)
    if R == 0 or K == 0 or s == 0:
        return (None if xo is None else xo.zero_(),
                None if yo is None else yo.zero_())
    rb, bpr, groups = _geometry(dev, R, K, s, y is not None)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = gpart = ticket = None
    if y is not None:
        n = K * s
        part, gpart, ticket = _scratch(dev, stream, nP * bpr * n,
                                       nP * groups * n, nP * (groups + 1))
    rc = _launcher()[0](
        Z.data_ptr(), _ptr(x), _ptr(y), _ptr(xo), _ptr(yo), _ptr(part),
        _ptr(gpart), _ptr(ticket), R, K, s, nP, rb, bpr, stream)
    if rc != 0:
        raise RuntimeError(f"oracle_pair launch failed with CUDA error {rc} "
                           f"(R={R}, K={K}, s={s}, P={nP})")
    if not torch.cuda.is_current_stream_capturing():
        oracle_pair.launches += 1
    return xo, yo


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _shape(t: torch.Tensor | None) -> tuple | None:
    return None if t is None else tuple(t.shape)


oracle_pair.launches = 0
