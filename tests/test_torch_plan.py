"""The port's host layer against the reference's: schemes, metrics, plans.

The port keeps its own copies of the reference's numpy host code
(``core/distribution.py``, ``core/metrics.py``, ``core/plan.py``,
``distributed/partition.py``), so the same tensor and the same scheme must
give exactly the same partitions: every ``ModePartition`` array, every
``SchemeMetrics`` field and every modeled cost compare with
``np.array_equal``/``==``, for ``lite``, ``coarse`` and ``medium`` at P = 4
on the three shared fixtures.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import plan as ref_plan
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core.distribution import build_scheme

CORE = {"small_tensor": (3, 3, 3), "lowrank_tensor": (2, 2, 2),
        "skewed_tensor": (4, 4, 4)}


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _assert_same_fields(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            for x, y in zip(a, b, strict=True):
                _assert_same_fields(x, y)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scheme", ["lite", "coarse", "medium"])
@pytest.mark.parametrize("fixture", sorted(CORE))
def test_plan_matches_reference_exactly(request, fixture, scheme):
    t = request.getfixturevalue(fixture)
    core = CORE[fixture]
    want = ref_plan.plan(t, scheme, 4, core_dims=core, path="liteopt",
                         use_cache=False)
    got = port_plan.plan(_port(t), scheme, 4, core_dims=core,
                         path="liteopt", use_cache=False)
    assert got.fingerprint == want.fingerprint
    assert got.scheme.uni == want.scheme.uni
    for a, b in zip(got.scheme.policies, want.scheme.policies, strict=True):
        assert np.array_equal(a, b)
    assert len(got.parts) == len(want.parts) == t.ndim
    for mp, mp_ref in zip(got.parts, want.parts):
        _assert_same_fields(mp, mp_ref)
    _assert_same_fields(got.metrics, want.metrics)
    for f in ("flops_s", "comm_s", "comm_bytes", "path", "ttm_s", "svd_s",
              "mode_backends", "backend_s"):
        assert getattr(got.cost, f) == getattr(want.cost, f), f
    for n in range(t.ndim):
        assert got.comm(n) == want.comm(n)


def test_auto_selection_matches_reference(skewed_tensor):
    t, core = skewed_tensor, CORE["skewed_tensor"]
    want = ref_plan.plan(t, "auto", 4, core_dims=core, path="auto",
                         use_cache=False)
    got = port_plan.plan(_port(t), "auto", 4, core_dims=core, path="auto",
                         use_cache=False)
    assert got.name == want.name
    assert got.candidates == want.candidates
    assert got.cost.mode_backends == want.cost.mode_backends


def test_plan_cache_returns_the_same_object(small_tensor):
    # another test file in this process may have cached these plans
    port_plan.plan_cache_clear()
    t = _port(small_tensor)
    first = port_plan.plan(t, "lite", 4, core_dims=(3, 3, 3))
    again = port_plan.plan(_port(small_tensor), "lite", 4,
                           core_dims=(3, 3, 3))
    assert again is first and port_plan.last_plan_call_cache_hit()
    other = port_plan.plan(t, "lite", 2, core_dims=(3, 3, 3))
    assert other is not first and not port_plan.last_plan_call_cache_hit()
    # a prebuilt Scheme is keyed on its content, not its identity
    s1 = build_scheme(t, "coarse", 4)
    s2 = build_scheme(t, "coarse", 4)
    assert port_plan.plan(t, s1, core_dims=(3, 3, 3)) is \
        port_plan.plan(t, s2, core_dims=(3, 3, 3))


def test_plan_refuses_other_objectives(small_tensor):
    """Every objective of the reference plans (ROADMAP Queue A item 9) and
    is stamped on its plan; unknown objectives and paths are refused."""
    pl = port_plan.plan(_port(small_tensor), "lite", 4, objective="nn")
    assert pl.objective == "nn"
    with pytest.raises(ValueError, match="unknown objective"):
        port_plan.plan(_port(small_tensor), "lite", 4, objective="ridge")
    with pytest.raises(ValueError):
        port_plan.plan(_port(small_tensor), "lite", 4, path="nowhere")
