"""Wrappers of the CUDA kernels in ``csrc/kron_segsum.cu``.

``kron_segsum`` replaces the TPU kernel
``src/repro/kernels/kron_segsum.py::kron_segsum``:
``Z[r] = sum_{e: rows[e]=r} kron(a[e], b[e])`` for elements sorted by row,
in f32 or under the bf16 product contract. ``kron_segsum_oracle`` replaces
``src/repro/kernels/kron_segsum.py::kron_segsum_oracle``: the same Z (the
same bits: the same two kernels run) together with ``Z @ X`` for the first
block-Lanczos panel X, from a third kernel that reads Z right after it is
written.

Both take the TPU function's own signature, per-element rows ``a`` and
``b``. The main path calls ``kron_segsum_gather`` instead: the same kernels,
reading each element's row id, value and coordinates and gathering the
factor rows themselves, so the (E, Ka) and (E, Kb) operands are never
materialised. Given the same ``a`` bits, both forms give the same Z bits.
``kron_segsum_gather2`` takes two leading factors (four-mode tensors) and
runs a walk of its own that gathers both and forms ``a`` in registers, one
pass over the elements for every column; Z is bitwise the fold's
(``ops._lead_a``) through the gather form, with the same chunks, partial
slots and fix-up.

A tensor on the CPU goes to the plain version (``ref.kron_segsum_ref``,
``ref.kron_segsum_oracle_ref``, ``ref.kron_segsum_gather_ref``,
``ref.kron_segsum_gather2_ref``); a CUDA
tensor goes to the kernel, and anything the kernel does not take raises.
There is no admission gate and no fallback: the kernels take every row
count, every panel width and every width the chunk walk can stage in
shared memory (Ka + Kb up to about 1,250 floats; the four-mode walk's three
factor rows up to about 1,600); a wider one raises.

``kron_segsum.launches`` and ``kron_segsum_oracle.launches`` count the
calls that launched each kernel, in any form, and
``kron_segsum_gather2.launches`` those of the four-mode walk; a call under
stream capture records a launch and is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["kron_segsum", "kron_segsum_oracle", "kron_segsum_gather",
           "kron_segsum_gather2", "CHUNK"]

# elements per warp: large enough that the two partial slots per chunk are a
# small share of the traffic, small enough to give the card many warps
CHUNK = 1024

_FNS = None


def _launchers():
    global _FNS
    if _FNS is None:
        lib = build.load("kron_segsum")
        fn = lib.kron_segsum_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ofn = lib.kron_segsum_oracle_launch
        ofn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [
            ctypes.c_int] * 9 + [ctypes.c_void_p]
        ofn.restype = ctypes.c_int
        gfn = lib.kron_segsum_lead2_launch
        gfn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong] + [
            ctypes.c_int] * 11 + [ctypes.c_void_p]
        gfn.restype = ctypes.c_int
        _FNS = (fn, ofn, gfn)
    return _FNS


def _check_precision(precision):
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")


def _check_device(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kron_segsum runs on CUDA or CPU tensors, "
                         f"not {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError("kron_segsum needs contiguous operands")


def _check_operands(rows, a, b, precision):
    """Shapes, types and devices of the row form; returns (E, Ka, Kb)."""
    _check_precision(precision)
    if rows.dim() != 1 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected rows (E,), a (E, Ka), b (E, Kb); got "
                         f"{tuple(rows.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    E, Ka = a.shape
    Kb = b.shape[1]
    if rows.shape[0] != E or b.shape[0] != E:
        raise ValueError(f"element counts differ: rows {rows.shape[0]}, "
                         f"a {E}, b {b.shape[0]}")
    if rows.dtype != torch.int32 or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError(f"expected int32 rows and float32 a, b; got "
                        f"{rows.dtype}, {a.dtype}, {b.dtype}")
    _check_device(rows, a, b)
    return E, Ka, Kb


def _check_panel(X, K, dev):
    if X.dim() != 2 or X.shape[0] != K or X.shape[1] < 1:
        raise ValueError(f"expected X of shape ({K}, s) with s >= 1; got "
                         f"{tuple(X.shape)}")
    if X.dtype != torch.float32 or X.device != dev:
        raise TypeError(f"expected float32 X on {dev}; got "
                        f"{X.dtype} on {X.device}")
    if dev.type == "cuda" and not X.is_contiguous():
        raise ValueError("kron_segsum_oracle needs a contiguous X")


def _outputs(E, K, num_rows, X, dev):
    """Z (zeros), Z @ X (None without X) and the chunk partials of one
    build on the card; no partials when there is nothing to walk."""
    z = torch.zeros((num_rows, K), dtype=torch.float32, device=dev)
    if E == 0 or K == 0:  # the sum over no elements
        zx = None if X is None else torch.zeros(
            (num_rows, X.shape[1]), dtype=torch.float32, device=dev)
        return z, zx, None
    zx = None if X is None else torch.empty(
        (num_rows, X.shape[1]), dtype=torch.float32, device=dev)
    part = torch.empty((2 * (-(-E // CHUNK)), K), dtype=torch.float32,
                       device=dev)
    return z, zx, part


def _finish(rc, X, what):
    """Raise on a failed launch; count it under its kernel (not under
    stream capture). Returns the count added."""
    if rc != 0:
        raise RuntimeError(f"kron_segsum launch failed with CUDA error {rc} "
                           f"({what}, s={None if X is None else X.shape[1]})")
    counted = 0 if torch.cuda.is_current_stream_capturing() else 1
    if X is None:
        kron_segsum.launches += counted
    else:
        kron_segsum_oracle.launches += counted
    return counted


def _run(rows, values, coords, A, B, col_a, col_b, E, Ka, Kb, num_rows, X,
         precision):
    """Launch the chunk walk and the fix-up (and, with X, the row
    products) on the card; returns Z, or (Z, Z @ X). Counts the launch
    under its kernel."""
    dev = rows.device
    z, zx, part = _outputs(E, Ka * Kb, num_rows, X, dev)
    if part is None:
        return z if X is None else (z, zx)
    N = 0 if coords is None else coords.shape[1]
    head = (rows.data_ptr(), _ptr(values), _ptr(coords), A.data_ptr(),
            B.data_ptr(), z.data_ptr(), part.data_ptr())
    tail = (1 if precision == "bf16" else 0,
            torch.cuda.current_stream(dev).cuda_stream)
    fn, ofn, _ = _launchers()
    if X is None:
        rc = fn(*head, E, num_rows, Ka, Kb, N, col_a, col_b, CHUNK, *tail)
    else:
        rc = ofn(*head, X.data_ptr(), zx.data_ptr(), E, num_rows, Ka, Kb, N,
                 col_a, col_b, CHUNK, X.shape[1], *tail)
    _finish(rc, X, f"E={E}, Ka={Ka}, Kb={Kb}, N={N}")
    return z if X is None else (z, zx)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def kron_segsum(
    rows: torch.Tensor,  # (E,) int32, sorted ascending, ids in [0, num_rows)
    a: torch.Tensor,  # (E, Ka) float32, values folded in
    b: torch.Tensor,  # (E, Kb) float32
    num_rows: int,
    *,
    precision: str = "f32",
) -> torch.Tensor:
    """Z of shape (num_rows, Ka*Kb), float32; rows without elements are 0.

    ``rows`` must be sorted, which the callers arrange with a device sort;
    it is not read on the host, so a launch costs no sync. On the card an id
    outside ``[0, num_rows)`` adds nothing, as in the reference's
    ``segment_sum``.
    """
    E, Ka, Kb = _check_operands(rows, a, b, precision)
    if rows.device.type == "cpu":
        return ref.kron_segsum_ref(rows, a, b, num_rows, precision)
    return _run(rows, None, None, a, b, -1, -1, E, Ka, Kb, num_rows, None,
                precision)


kron_segsum.launches = 0


def kron_segsum_oracle(
    rows: torch.Tensor,  # (E,) int32, sorted ascending, ids in [0, num_rows)
    a: torch.Tensor,  # (E, Ka) float32, values folded in
    b: torch.Tensor,  # (E, Kb) float32
    num_rows: int,
    X: torch.Tensor,  # (Ka*Kb, s) float32, the first oracle panel
    *,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Z, Z @ X)``: Z exactly as ``kron_segsum`` gives it (the same bits
    on the card), and its product with the panel X in f32.

    Same preconditions as ``kron_segsum``; ``X`` has ``s >= 1`` columns.
    Rows without elements are 0 in both outputs.
    """
    E, Ka, Kb = _check_operands(rows, a, b, precision)
    _check_panel(X, Ka * Kb, rows.device)
    if rows.device.type == "cpu":
        return ref.kron_segsum_oracle_ref(rows, a, b, num_rows, X, precision)
    return _run(rows, None, None, a, b, -1, -1, E, Ka, Kb, num_rows, X,
                precision)


kron_segsum_oracle.launches = 0


def kron_segsum_gather(
    rows: torch.Tensor,  # (E,) int32, sorted ascending, ids in [0, num_rows)
    coords: torch.Tensor,  # (E, N) int32, each element's coordinates
    values: torch.Tensor | None,  # (E,) float32; None when lead is ``a``
    lead: torch.Tensor,  # (L, Ka) factor, or (E, Ka) a when lead_col is None
    last: torch.Tensor,  # (L, Kb) factor
    lead_col: int | None,
    last_col: int,
    num_rows: int,
    *,
    X: torch.Tensor | None = None,  # (Ka*Kb, s) float32 first oracle panel
    precision: str = "f32",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``kron_segsum`` with the factor rows gathered per element.

    ``a[e] = values[e] * lead[coords[e, lead_col]]`` (one f32 multiply per
    entry) and ``b[e] = last[coords[e, last_col]]``; with ``lead_col=None``
    ``lead`` is the per-element ``a`` itself (values folded in, ``values``
    unused) and only b is gathered. Returns Z, or ``(Z, Z @ X)`` when a
    panel X is given, exactly as ``kron_segsum``/``kron_segsum_oracle``
    give them on ``(rows, a, b)``. Coordinates must index their factors'
    rows; elements with value 0 add nothing.
    """
    _check_precision(precision)
    if rows.dim() != 1 or coords.dim() != 2 or lead.dim() != 2 \
            or last.dim() != 2:
        raise ValueError(f"expected rows (E,), coords (E, N) and 2-D "
                         f"factors; got {tuple(rows.shape)}, "
                         f"{tuple(coords.shape)}, {tuple(lead.shape)}, "
                         f"{tuple(last.shape)}")
    E, N = coords.shape
    gather_a = lead_col is not None
    if rows.shape[0] != E or (gather_a and (
            values is None or tuple(values.shape) != (E,))) \
            or (not gather_a and lead.shape[0] != E):
        raise ValueError(f"element counts differ: rows {rows.shape[0]}, "
                         f"coords {E}, values {None if values is None else tuple(values.shape)}, "
                         f"lead {tuple(lead.shape)} (lead_col={lead_col})")
    if not 0 <= last_col < N or (gather_a and not 0 <= lead_col < N):
        raise ValueError(f"columns {lead_col}, {last_col} outside the "
                         f"{N} coordinates")
    floats = [lead, last] + ([values] if gather_a else [])
    if rows.dtype != torch.int32 or coords.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"expected int32 rows and coords and float32 "
                        f"values and factors; got {rows.dtype}, "
                        f"{coords.dtype}, {[t.dtype for t in floats]}")
    _check_device(rows, coords, *floats)
    Ka, Kb = lead.shape[1], last.shape[1]
    if X is not None:
        _check_panel(X, Ka * Kb, rows.device)
    if rows.device.type == "cpu":
        z = ref.kron_segsum_gather_ref(rows, coords, values, lead, last,
                                       lead_col, last_col, num_rows,
                                       precision)
        return z if X is None else (z, z @ X)
    return _run(rows, values if gather_a else None, coords, lead, last,
                lead_col if gather_a else -1, last_col, E, Ka, Kb, num_rows,
                X, precision)


def kron_segsum_gather2(
    rows: torch.Tensor,  # (E,) int32, sorted ascending, ids in [0, num_rows)
    coords: torch.Tensor,  # (E, N) int32, each element's coordinates
    values: torch.Tensor,  # (E,) float32
    F1: torch.Tensor,  # (L1, K1) first leading factor
    F2: torch.Tensor,  # (L2, K2) second leading factor
    last: torch.Tensor,  # (L, Kb) factor
    c1: int,
    c2: int,
    last_col: int,
    num_rows: int,
    *,
    X: torch.Tensor | None = None,  # (K1*K2*Kb, s) float32 oracle panel
    precision: str = "f32",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``kron_segsum_gather`` with two leading factors (the four-mode walk):
    ``a[e] = kron(values[e] * F1[coords[e, c1]], F2[coords[e, c2]])``, each
    entry rounded as ``ops._lead_a`` rounds it (Ka = K1 * K2), formed in
    registers, and ``b[e] = last[coords[e, last_col]]``. Returns Z, or
    ``(Z, Z @ X)``, bitwise as ``kron_segsum``/``kron_segsum_oracle`` give
    them on the fold's ``(rows, a, b)``. Coordinates must index their
    factors' rows; elements with value 0 add nothing.
    """
    _check_precision(precision)
    if rows.dim() != 1 or coords.dim() != 2 or values.dim() != 1 \
            or any(f.dim() != 2 for f in (F1, F2, last)):
        raise ValueError(f"expected rows (E,), coords (E, N), values (E,) "
                         f"and 2-D factors; got {tuple(rows.shape)}, "
                         f"{tuple(coords.shape)}, {tuple(values.shape)}, "
                         f"{tuple(F1.shape)}, {tuple(F2.shape)}, "
                         f"{tuple(last.shape)}")
    E, N = coords.shape
    if rows.shape[0] != E or values.shape[0] != E:
        raise ValueError(f"element counts differ: rows {rows.shape[0]}, "
                         f"coords {E}, values {values.shape[0]}")
    if any(not 0 <= j < N for j in (c1, c2, last_col)):
        raise ValueError(f"columns {c1}, {c2}, {last_col} outside the {N} "
                         f"coordinates")
    floats = (values, F1, F2, last)
    if rows.dtype != torch.int32 or coords.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"expected int32 rows and coords and float32 "
                        f"values and factors; got {rows.dtype}, "
                        f"{coords.dtype}, {[t.dtype for t in floats]}")
    _check_device(rows, coords, *floats)
    K1, K2, Kb = F1.shape[1], F2.shape[1], last.shape[1]
    if X is not None:
        _check_panel(X, K1 * K2 * Kb, rows.device)
    if rows.device.type == "cpu":
        z = ref.kron_segsum_gather2_ref(rows, coords, values, F1, F2, last,
                                        c1, c2, last_col, num_rows,
                                        precision)
        return z if X is None else (z, z @ X)
    dev = rows.device
    z, zx, part = _outputs(E, K1 * K2 * Kb, num_rows, X, dev)
    if part is None:
        return z if X is None else (z, zx)
    rc = _launchers()[2](
        rows.data_ptr(), values.data_ptr(), coords.data_ptr(), F1.data_ptr(),
        F2.data_ptr(), last.data_ptr(), z.data_ptr(), part.data_ptr(),
        _ptr(X), _ptr(zx), E, num_rows, K1, K2, Kb, N, c1, c2, last_col,
        CHUNK, 0 if X is None else X.shape[1],
        1 if precision == "bf16" else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kron_segsum_gather2.launches += _finish(
        rc, X, f"E={E}, K1={K1}, K2={K2}, Kb={Kb}, N={N}")
    return z if X is None else (z, zx)


# launches of the four-mode walk, counted as well under
# ``kron_segsum.launches`` or ``kron_segsum_oracle.launches``
kron_segsum_gather2.launches = 0
