"""PyTorch/CUDA port of the sparse Tucker (HOOI) system.

A second package beside the JAX/Pallas reference ``repro``: the same layout
(``core/``, ``data/``, ``engine/``, ``kernels/``) with plain PyTorch on the
host side and hand-written CUDA kernels for Hopper (``sm_90a``) on the hot
path. It imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``: what it needs of the reference's JAX-free host code it keeps as
its own copy.

Entry points (``repro_torch.core.hooi.hooi`` and friends) run on the card
unless the caller passes ``device="cpu"``; without CUDA they raise instead
of dropping to the CPU.
"""
