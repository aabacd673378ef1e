"""The ``REPRO_*`` environment knobs the port reads.

The port's own copy of the reference's parsing (``repro/envknobs.py``),
limited to the knobs the port consults (``KNOBS`` lists them): an unset or
empty variable means "no override", and a malformed value raises
``ValueError`` naming the variable.
"""

from __future__ import annotations

import os

__all__ = ["PRECISIONS", "OBJECTIVES", "WARM_STARTS", "KNOBS", "env_flag",
           "fused_zbuild", "precision", "lanczos_block", "objective",
           "warm_start", "sample_fraction", "snapshot"]

PRECISIONS = ("f32", "bf16")
OBJECTIVES = ("tucker", "completion", "nn")
WARM_STARTS = ("none", "sketch", "auto")


def _raw(name: str) -> str:
    return os.environ.get(name, "").strip()


def env_flag(name: str) -> bool:
    """Parse a 0/1 switch; unset/empty and ``0`` are False, ``1`` is True."""
    raw = _raw(name)
    if raw in ("", "0"):
        return False
    if raw == "1":
        return True
    raise ValueError(f"{name} must be '0' or '1', got {raw!r}")


def _choice(name: str, allowed: tuple[str, ...]) -> str | None:
    raw = _raw(name)
    if not raw:
        return None
    if raw not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {raw!r}")
    return raw


def fused_zbuild() -> bool:
    """``REPRO_FUSED_ZBUILD=1`` asks for the fused Z-build→oracle pipeline."""
    return env_flag("REPRO_FUSED_ZBUILD")


def precision() -> str | None:
    """``REPRO_PRECISION``: Z-build precision override, or None if unset."""
    return _choice("REPRO_PRECISION", PRECISIONS)


def lanczos_block() -> int | None:
    """``REPRO_LANCZOS_BLOCK``: requested Lanczos panel width, or None."""
    raw = _raw("REPRO_LANCZOS_BLOCK")
    if not raw:
        return None
    try:
        value = int(raw)
    except ValueError:
        raise ValueError(
            f"REPRO_LANCZOS_BLOCK must be an integer >= 1, got {raw!r}"
        ) from None
    if value < 1:
        raise ValueError(f"REPRO_LANCZOS_BLOCK must be >= 1, got {value}")
    return value


def objective() -> str | None:
    """``REPRO_OBJECTIVE``: default sweep objective name, or None."""
    return _choice("REPRO_OBJECTIVE", OBJECTIVES)


def warm_start() -> str | None:
    """``REPRO_WARM_START``: default oracle warm-start mode, or None."""
    return _choice("REPRO_WARM_START", WARM_STARTS)


def sample_fraction() -> float | None:
    """``REPRO_SAMPLE_FRACTION``: default stochastic-refine sample
    fraction for the streaming scheduler, or None (rung disabled)."""
    raw = _raw("REPRO_SAMPLE_FRACTION")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        raise ValueError(
            f"REPRO_SAMPLE_FRACTION must be a float in (0, 1], "
            f"got {raw!r}") from None
    if not 0.0 < value <= 1.0:
        raise ValueError(
            f"REPRO_SAMPLE_FRACTION must be in (0, 1], got {value}")
    return value


# the registry: variable name -> zero-arg validated parser (the reference's
# TPU-only REPRO_FORCE_KERNEL and REPRO_VMEM_BUDGET are not ported)
KNOBS = {
    "REPRO_FUSED_ZBUILD": fused_zbuild,
    "REPRO_PRECISION": precision,
    "REPRO_LANCZOS_BLOCK": lanczos_block,
    "REPRO_OBJECTIVE": objective,
    "REPRO_WARM_START": warm_start,
    "REPRO_SAMPLE_FRACTION": sample_fraction,
}


def snapshot() -> dict[str, object]:
    """Resolved value of every knob the port reads: a run's provenance."""
    return {name: parse() for name, parse in KNOBS.items()}
