"""Device policy of the port's entry points.

``device=None`` means the card. A caller that wants the plain PyTorch path on
the CPU says so with ``device="cpu"``; the port never drops to the CPU on its
own, because a run that silently left the card would report CPU numbers as
if they were the card's.

A plan's build is the one exception (``plan_device``): it counts on the card
when there is one and on the CPU otherwise, unasked. Its result is host
numpy arrays, made by integer counts, sorts and gathers and a float32 cast,
so they are bitwise the same on either device and no number it reports
depends on where it counted; only its host seconds do.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["resolve_device", "plan_device", "indexed_device",
           "full_precision_matmul", "on_device", "on_own_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises ``RuntimeError`` when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA unless asked otherwise, and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def plan_device(device: str | torch.device | None = None) -> torch.device:
    """The device a plan's build counts on: ``device`` when given
    (``resolve_device``), else the card when there is one, else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return resolve_device(device)


def indexed_device(device: str | torch.device) -> torch.device:
    """``resolve_device(device)`` with an explicit index: ``"cuda"`` means
    the current CUDA device, which ``"cuda:0"`` may name too, so two names
    of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def full_precision_matmul() -> None:
    """Pin f32 matrix products to full f32 on the port's path.

    TF32 keeps about three decimal digits, so the Lanczos products and the
    core projection would drift from the reference by far more than the
    1e-4 fit parity the port is held to. Set on every entry point rather
    than trusting the process default.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def on_device(dev: torch.device):
    """A context that makes ``dev`` the current CUDA device (off CUDA it
    does nothing). The kernels launch through ``ctypes`` on the current
    device's context, and captures, events and pinned copies bind to it as
    well, so work for ``cuda:1`` issued from a thread whose current device
    is ``cuda:0`` (every new thread starts there) would go to the wrong
    card."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def on_own_device(method):
    """Run a method of an object with a ``device`` under that device
    (``on_device``)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with on_device(self.device):
            return method(self, *args, **kwargs)

    return run
