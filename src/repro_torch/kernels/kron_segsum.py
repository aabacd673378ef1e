"""Wrapper of the CUDA ``kron_segsum`` kernel (``csrc/kron_segsum.cu``).

Replaces the TPU kernel ``src/repro/kernels/kron_segsum.py::kron_segsum``:
``Z[r] = sum_{e: rows[e]=r} kron(a[e], b[e])`` for elements sorted by row,
in f32 or under the bf16 product contract. A tensor on the CPU goes to the
plain version (``ref.kron_segsum_ref``); a CUDA tensor goes to the kernel,
and anything the kernel does not take raises. There is no admission gate
and no fallback: the kernel takes every row count and every width
``Ka * Kb`` (K̂ = 1000 for 4-mode tensors at K = 10 included).

``kron_segsum.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["kron_segsum", "CHUNK"]

# elements per warp: large enough that the two partial slots per chunk are a
# small share of the traffic, small enough to give the card many warps
CHUNK = 1024

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = build.load("kron_segsum").kron_segsum_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    if rows.device.type == "cpu":
        return ref.kron_segsum_ref(rows, a, b, num_rows, precision)
    if rows.device.type != "cuda":
        raise ValueError(f"kron_segsum runs on CUDA or CPU tensors, "
                         f"not {rows.device}")
    if not (rows.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kron_segsum needs contiguous rows, a and b")
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
