"""Wrapper of the CUDA ``oracle_pair`` kernel (``csrc/oracle_pair.cu``).

Replaces the TPU kernel ``src/repro/kernels/oracle_fused.py::oracle_pair``:
``(Z @ x, Zᵀ @ y)`` in one pass over Z, for vectors or width-``s`` panels;
either half may be left out.
A tensor on the CPU goes to the plain version (``ref.oracle_pair_ref``); a
CUDA tensor goes to the kernel, and anything the kernel does not take
raises.

``oracle_pair.launches`` counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

__all__ = ["oracle_pair"]

# the kernel stages rb rows of Z and y in the default 48 KB of shared memory
_SMEM_FLOATS = 48 * 1024 // 4
_MAX_ROWS_PER_BLOCK = 64

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        fn = build.load("oracle_pair").oracle_pair_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _rows_per_block(K: int, s: int) -> int:
    """Rows of Z one block stages: as many as fit, at most 64."""
    return min(_MAX_ROWS_PER_BLOCK, _SMEM_FLOATS // (K + s))


def oracle_pair(
    Z: torch.Tensor,  # (R, Khat) float32
    x: torch.Tensor | None,  # (Khat,) or (Khat, s)
    y: torch.Tensor | None,  # (R,) or (R, s)
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Returns (Z @ x, Zᵀ @ y); both operands share vector-ness and width.

    Either operand may be None, and then so is its product and the kernel
    skips that half: the Lanczos loop asks for one product at a time.
    """
    given = [v for v in (x, y) if v is not None]
    if Z.dim() != 2 or not given or given[0].dim() not in (1, 2) \
            or given[-1].dim() != given[0].dim():
        raise ValueError(f"expected Z (R, K) with x, y both vectors or both "
                         f"panels (one may be None); got {tuple(Z.shape)}, "
                         f"{_shape(x)}, {_shape(y)}")
    R, K = Z.shape
    vec = given[0].dim() == 1
    s = 1 if vec else given[0].shape[1]
    if (x is not None and (x.shape[0] != K or (not vec and x.shape[1] != s))) \
            or (y is not None
                and (y.shape[0] != R or (not vec and y.shape[1] != s))):
        raise ValueError(f"shapes do not match: Z {tuple(Z.shape)}, "
                         f"x {_shape(x)}, y {_shape(y)}")
    if any(v.dtype != torch.float32 for v in (Z, *given)):
        raise TypeError(f"expected float32 operands; got {Z.dtype}, "
                        f"{[v.dtype for v in given]}")
    if any(v.device != Z.device for v in given):
        raise ValueError(f"operands on different devices: {Z.device}, "
                         f"{[v.device for v in given]}")
    if Z.device.type == "cpu":
        return ref.oracle_pair_ref(Z, x, y)
    if Z.device.type != "cuda":
        raise ValueError(f"oracle_pair runs on CUDA or CPU tensors, "
                         f"not {Z.device}")
    if not all(v.is_contiguous() for v in (Z, *given)):
        raise ValueError("oracle_pair needs contiguous Z, x and y")
    xo = None if x is None else torch.empty(
        (R,) if vec else (R, s), dtype=torch.float32, device=Z.device)
    yo = None if y is None else torch.empty(
        (K,) if vec else (K, s), dtype=torch.float32, device=Z.device)
    if R == 0 or K == 0 or s == 0:
        return (None if xo is None else xo.zero_(),
                None if yo is None else yo.zero_())
    rb = _rows_per_block(K, s)
    if rb < 1:
        raise ValueError(f"oracle_pair stages whole rows of Z in shared "
                         f"memory: K + s = {K + s} floats exceed "
                         f"{_SMEM_FLOATS}")
    part = None if y is None else torch.empty(
        (-(-R // rb), K, s), dtype=torch.float32, device=Z.device)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launcher()(Z.data_ptr(), _ptr(x), _ptr(y), _ptr(xo), _ptr(yo),
                         _ptr(part), R, K, s, rb, stream)
    if rc != 0:
        raise RuntimeError(f"oracle_pair launch failed with CUDA error {rc} "
                           f"(R={R}, K={K}, s={s})")
    oracle_pair.launches += 1
    return xo, yo


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _shape(t: torch.Tensor | None) -> tuple | None:
    return None if t is None else tuple(t.shape)


oracle_pair.launches = 0
