"""Wrappers of the CUDA kernels in ``csrc/kron_segsum.cu``.

``kron_segsum`` replaces the TPU kernel
``src/repro/kernels/kron_segsum.py::kron_segsum``:
``Z[r] = sum_{e: rows[e]=r} kron(a[e], b[e])`` for elements sorted by row,
in f32 or under the bf16 product contract. ``kron_segsum_oracle`` replaces
``src/repro/kernels/kron_segsum.py::kron_segsum_oracle``: the same Z (the
same bits: the same two kernels run) together with ``Z @ X`` for the first
block-Lanczos panel X, from a third kernel that reads Z right after it is
written.

A tensor on the CPU goes to the plain version (``ref.kron_segsum_ref``,
``ref.kron_segsum_oracle_ref``); a CUDA tensor goes to the kernel, and
anything the kernel does not take raises. There is no admission gate and no
fallback: the kernels take every row count, every width ``Ka * Kb``
(K̂ = 1000 for 4-mode tensors at K = 10 included) and every panel width.

``kron_segsum.launches`` and ``kron_segsum_oracle.launches`` count the
calls that launched each kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["kron_segsum", "kron_segsum_oracle", "CHUNK"]

# elements per warp: large enough that the two partial slots per chunk are a
# small share of the traffic, small enough to give the card many warps
CHUNK = 1024

_FN = None
_ORACLE_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = build.load("kron_segsum").kron_segsum_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _oracle_launcher():
    global _ORACLE_FN
    if _ORACLE_FN is None:
        fn = build.load("kron_segsum").kron_segsum_oracle_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ORACLE_FN = fn
    return _ORACLE_FN


def _check_operands(rows, a, b, precision):
    """Shapes, types and devices both kernels take; returns (E, Ka, Kb)."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
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
    if not (rows.device == a.device == b.device):
        raise ValueError(f"operands on different devices: {rows.device}, "
                         f"{a.device}, {b.device}")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kron_segsum runs on CUDA or CPU tensors, "
                         f"not {rows.device}")
    if rows.device.type == "cuda" and not (
            rows.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kron_segsum needs contiguous rows, a and b")
    return E, Ka, Kb


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
    out = torch.zeros((num_rows, Ka * Kb), dtype=torch.float32,
                      device=rows.device)
    if E == 0 or Ka * Kb == 0:
        return out  # the sum over no elements
    nchunks = -(-E // CHUNK)
    part = torch.empty((2 * nchunks, Ka * Kb), dtype=torch.float32,
                       device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(rows.data_ptr(), a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), part.data_ptr(), E, num_rows, Ka,
                         Kb, CHUNK, 1 if precision == "bf16" else 0, stream)
    if rc != 0:
        raise RuntimeError(f"kron_segsum launch failed with CUDA error {rc} "
                           f"(E={E}, Ka={Ka}, Kb={Kb})")
    kron_segsum.launches += 1
    return out


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
    K = Ka * Kb
    if X.dim() != 2 or X.shape[0] != K or X.shape[1] < 1:
        raise ValueError(f"expected X of shape ({K}, s) with s >= 1; got "
                         f"{tuple(X.shape)}")
    if X.dtype != torch.float32 or X.device != rows.device:
        raise TypeError(f"expected float32 X on {rows.device}; got "
                        f"{X.dtype} on {X.device}")
    if rows.device.type == "cpu":
        return ref.kron_segsum_oracle_ref(rows, a, b, num_rows, X, precision)
    if not X.is_contiguous():
        raise ValueError("kron_segsum_oracle needs a contiguous X")
    s = X.shape[1]
    z = torch.zeros((num_rows, K), dtype=torch.float32, device=rows.device)
    if E == 0 or K == 0:  # the sum over no elements
        return z, torch.zeros((num_rows, s), dtype=torch.float32,
                              device=rows.device)
    zx = torch.empty((num_rows, s), dtype=torch.float32, device=rows.device)
    nchunks = -(-E // CHUNK)
    part = torch.empty((2 * nchunks, K), dtype=torch.float32,
                       device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _oracle_launcher()(
            rows.data_ptr(), a.data_ptr(), b.data_ptr(), z.data_ptr(),
            part.data_ptr(), X.data_ptr(), zx.data_ptr(), E, num_rows, Ka,
            Kb, CHUNK, s, 1 if precision == "bf16" else 0, stream)
    if rc != 0:
        raise RuntimeError(f"kron_segsum_oracle launch failed with CUDA "
                           f"error {rc} (E={E}, Ka={Ka}, Kb={Kb}, s={s})")
    kron_segsum_oracle.launches += 1
    return z, zx


kron_segsum_oracle.launches = 0
