"""What the port's main path calls, on the CPU.

The Z-build reads each element's coordinates and gathers the factor rows
in the kernel (its gather form), so for 3-mode tensors the host never forms
the (E, Ka) and (E, Kb) operands of ``kernels.ops._split_ab``; and the
distributed step's ``Zᵀ y`` over the stacked ranks is one batched
``oracle_pair`` call per product. On the card these are the same calls, so
``chip_smoke.py``'s launch counts show the same thing there.
"""

import pytest

from repro_torch.core.hooi import hooi
from repro_torch.data.tensors import synth_tensor
from repro_torch.distributed.dist_hooi import dist_hooi
from repro_torch.engine import oracle as engine_oracle
from repro_torch.engine import steps
from repro_torch.kernels import kron_segsum as kron_module
from repro_torch.kernels import ops

CORE = (3, 3, 3)


@pytest.fixture(scope="module")
def tensor():
    return synth_tensor((30, 25, 20), 2_000, alphas=(1.1, 1.0, 0.9), seed=4)


def _forbid_split(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("_split_ab on the main path")

    monkeypatch.setattr(ops, "_split_ab", refuse)
    monkeypatch.setattr(ops, "_lead_a", refuse)
    calls = []
    gather = kron_module.kron_segsum_gather

    def counted(*args, **kwargs):
        calls.append(kwargs.get("X") is not None)
        return gather(*args, **kwargs)

    monkeypatch.setattr(ops, "kron_segsum_gather", counted)
    return calls


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_fused_oracle=True),
    dict(lanczos_block=4, fused_zbuild=True, use_fused_oracle=True),
], ids=["vector", "fused_oracle", "block4_fused"])
def test_single_process_gathers_without_split(monkeypatch, tensor, kw):
    calls = _forbid_split(monkeypatch)
    _, fits = hooi(tensor, CORE, n_invocations=2, seed=0, device="cpu", **kw)
    assert len(fits) == 2
    fused = kw.get("fused_zbuild", False)
    # three mode steps per sweep (fused ones with a panel), then the core
    assert calls == 2 * ([fused] * 3 + [False])


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
@pytest.mark.parametrize("fused_zbuild", [False, True])
def test_distributed_gathers_without_split(monkeypatch, tensor, path,
                                           fused_zbuild):
    calls = _forbid_split(monkeypatch)
    _, st = dist_hooi(tensor, CORE, 4, path=path, n_invocations=2, seed=0,
                      lanczos_block=4, fused_zbuild=fused_zbuild,
                      use_fused_oracle=True, device="cpu")
    assert len(st.fits) == 2
    assert calls == 2 * ([fused_zbuild] * 3 + [False])


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
def test_stacked_products_one_call_per_product(monkeypatch, tensor, path):
    """Every ``zrmv`` of the distributed step is one ``oracle_pair`` call
    over all P ranks, and every ``zmv`` one call over the stacked rows."""
    P = 4
    seen = []
    pair = ops.oracle_pair

    def counted_pair(Z, x, y, P_=None):
        seen.append(("zmv" if y is None else "zrmv", P_,
                     None if y is None else tuple(y.shape)))
        return pair(Z, x, y, P_)

    products = []
    stacked = engine_oracle.stacked_products

    def counted_stacked(Z, P_, *, fused=False):
        zmv, zrmv = stacked(Z, P_, fused=fused)

        def zmv_c(x):
            products.append("zmv")
            return zmv(x)

        def zrmv_c(y):
            products.append("zrmv")
            return zrmv(y)

        return zmv_c, zrmv_c

    monkeypatch.setattr(ops, "oracle_pair", counted_pair)
    monkeypatch.setattr(steps, "stacked_products", counted_stacked)
    dist_hooi(tensor, CORE, P, path=path, n_invocations=2, seed=0,
              lanczos_block=4, fused_zbuild=True, use_fused_oracle=True,
              device="cpu")
    assert products.count("zrmv") > 0
    assert [k for k, _, _ in seen] == products
    for kind, got_P, y_shape in seen:
        if kind == "zrmv":
            assert got_P == P and y_shape[0] == P
        else:
            assert got_P is None
