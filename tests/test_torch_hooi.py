"""The slice as a whole: the port's ``hooi`` against ``repro.core.hooi.hooi``.

On the shared fixtures, 3 invocations, with the reference's initial factors
(passed over through ``repro_torch.convert``) and the reference's
``jax.random`` draws injected through the port's draw seam, under both
``use_fused_oracle`` settings:

* fits agree within 1e-4;
* factor subspaces ``F Fᵀ`` agree within 1e-3;
* the exactly low-rank fixture reaches a fit above 0.99.

One caveat on the fit bar, which is a property of the metric and not of
either implementation: ``fit = 1 - sqrt(max(‖T‖² - ‖G‖², 0)) / ‖T‖``. On
the exactly low-rank fixture ``‖T‖² - ‖G‖²`` is pure f32 rounding of
``‖G‖²`` (a few 1e-7 of ``‖T‖²``), and the square root turns that into fit
differences of a few 1e-4 — the reference's own two oracle settings differ
by 2.6e-4 there. Where the reference's fit is within 1e-3 of 1, the test
therefore compares the quantity that carries the information, the captured
energy share ``‖G‖²/‖T‖² = 1 - (1 - fit)²``, within 1e-6 relative (a few
f32 ulps) instead of the fit within 1e-4. Every fixture also holds the
final core's ``‖G‖²/‖T‖²``, taken from the cores themselves, to 2e-6
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hooi import fit_score as ref_fit_score
from repro.core.hooi import hooi as ref_hooi
from repro.core.hooi import hooi_invocation as ref_hooi_invocation
from repro.core.hooi import hosvd_init as ref_hosvd_init
from repro.core.hooi import random_factors as ref_random_factors
from repro_torch import convert
from repro_torch.core import hooi as port
from repro_torch.random import Key

CORE = {"small_tensor": (3, 3, 3), "lowrank_tensor": (2, 2, 2),
        "skewed_tensor": (4, 4, 4)}


def jax_draws(seed):
    """The reference's draws along a fold_in path, through numpy."""
    root = jax.random.PRNGKey(seed)

    def draw(path, shape):
        k = root
        for p in path:
            k = jax.random.fold_in(k, p)
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))

    return draw


def assert_fits_match(port_fits, ref_fits):
    port_fits, ref_fits = np.asarray(port_fits), np.asarray(ref_fits)
    assert port_fits.shape == ref_fits.shape
    near_one = ref_fits > 1 - 1e-3
    np.testing.assert_allclose(port_fits[~near_one], ref_fits[~near_one],
                               rtol=0, atol=1e-4)
    # captured energy share ‖G‖²/‖T‖², recovered from the fit
    np.testing.assert_allclose(1 - (1 - port_fits[near_one]) ** 2,
                               1 - (1 - ref_fits[near_one]) ** 2,
                               rtol=1e-6, atol=0)


def assert_core_energy_matches(t, port_core, ref_core):
    """‖G‖²/‖T‖² of the final cores, summed in f64."""
    tt = float(np.sum(np.asarray(t.values, np.float64) ** 2))
    got = float(np.sum(port_core.cpu().double().numpy() ** 2)) / tt
    want = float(np.sum(np.asarray(ref_core, np.float64) ** 2)) / tt
    assert got == pytest.approx(want, rel=2e-6, abs=0)


def assert_subspaces_match(port_factors, ref_factors):
    for F, Fr in zip(port_factors, ref_factors):
        F, Fr = F.cpu().numpy(), np.asarray(Fr)
        np.testing.assert_allclose(F @ F.T, Fr @ Fr.T, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("fixture", sorted(CORE))
def test_hooi_matches_reference(request, fixture, fused):
    t = request.getfixturevalue(fixture)
    core = CORE[fixture]
    ref_dec, ref_fits = ref_hooi(t, core, n_invocations=3, seed=0,
                                 use_fused_oracle=fused)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, fits = port.hooi(
        convert.sparse_tensor(t.coords, t.values, t.shape), core,
        n_invocations=3, seed=0, init=[np.asarray(f) for f in init],
        draw=jax_draws(0), use_fused_oracle=fused, device="cpu")
    assert all(np.isfinite(fits)) and all(0.0 <= f <= 1.0 for f in fits)
    assert_fits_match(fits, ref_fits)
    assert_core_energy_matches(t, dec.core, ref_dec.core)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    assert tuple(dec.core.shape) == core
    if fixture == "lowrank_tensor":
        assert fits[-1] > 0.99


def test_converted_decomposition_scores_like_reference(skewed_tensor):
    """``convert.decomposition`` carries a reference result over intact:
    the port's ``fit_score`` of it is the reference's, up to the f32 sum
    of the core's squares taken in another order."""
    t = skewed_tensor
    ref_dec, ref_fits = ref_hooi(t, (4, 4, 4), n_invocations=1, seed=2)
    dec = convert.decomposition(np.asarray(ref_dec.core),
                                [np.asarray(f) for f in ref_dec.factors],
                                "cpu")
    assert dec.core_dims == (4, 4, 4)
    port_t = convert.sparse_tensor(t.coords, t.values, t.shape)
    assert port.fit_score(port_t, dec) == pytest.approx(ref_fits[-1],
                                                        rel=0, abs=1e-6)
    assert port.fit_score(port_t, dec) == pytest.approx(
        ref_fit_score(t, ref_dec), rel=0, abs=1e-6)


def test_hooi_invocation_matches_reference(small_tensor):
    t, core = small_tensor, CORE["small_tensor"]
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(1))
    ref_new = ref_hooi_invocation(t, list(init), jax.random.PRNGKey(4))
    timings = {}
    new = port.hooi_invocation(
        convert.sparse_tensor(t.coords, t.values, t.shape),
        convert.factors(init, "cpu"), Key(jax_draws(4)), timings=timings,
        device="cpu")
    assert_subspaces_match(new, ref_new)
    assert set(timings) == {"ttm", "svd"}


def test_hosvd_init_matches_reference(small_tensor):
    """HOSVD bootstrap: the same leading subspaces of the dense unfoldings,
    and with the reference's draws ``init="hosvd"`` gives its fits."""
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    got = port.hosvd_init(t, (3, 3, 3), device="cpu")
    assert_subspaces_match(got, ref_hosvd_init(small_tensor, (3, 3, 3)))
    _, fits = port.hooi(t, (3, 3, 3), n_invocations=2, init="hosvd",
                        seed=0, draw=jax_draws(0), device="cpu")
    _, ref_fits = ref_hooi(small_tensor, (3, 3, 3), n_invocations=2,
                           init="hosvd", seed=0)
    assert_fits_match(fits, ref_fits)


def test_default_draws_lowrank_and_bitwise_rerun(lowrank_tensor):
    """The port's own seeded draws: the low-rank fixture still converges,
    and a rerun is bitwise equal."""
    t = convert.sparse_tensor(lowrank_tensor.coords, lowrank_tensor.values,
                              lowrank_tensor.shape)
    dec1, fits1 = port.hooi(t, (2, 2, 2), n_invocations=3, seed=1,
                            device="cpu")
    dec2, fits2 = port.hooi(t, (2, 2, 2), n_invocations=3, seed=1,
                            device="cpu")
    assert fits1[-1] > 0.99
    assert fits1 == fits2
    for a, b in zip(dec1.factors, dec2.factors):
        assert torch.equal(a, b)
    for F in dec1.factors:
        np.testing.assert_allclose((F.T @ F).numpy(), np.eye(2), atol=1e-4)


def test_bf16_stays_within_contract_bound(small_tensor):
    """bf16 Z-build (operands and products rounded, f32 sums) keeps the fit
    within the reference's documented 1e-2 of f32."""
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    _, f32 = port.hooi(t, (3, 3, 3), n_invocations=2, device="cpu")
    _, bf16 = port.hooi(t, (3, 3, 3), n_invocations=2, device="cpu",
                        precision="bf16")
    np.testing.assert_allclose(bf16, f32, rtol=0, atol=1e-2)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           small_tensor):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.hooi(t, (3, 3, 3), n_invocations=1)
    with pytest.raises(RuntimeError):
        port.random_factors(t.shape, (3, 3, 3), Key(jax_draws(0)))
    with pytest.raises(RuntimeError):
        convert.factors([np.eye(3, dtype=np.float32)])
    # asking for the CPU works on the same machine
    _, fits = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu")
    assert len(fits) == 1


@pytest.mark.parametrize("kw", [
    dict(warm_start="sketch"), dict(warm_start="auto"),
    dict(objective="nn"), dict(objective="completion"),
    dict(precision="auto"),
])
def test_out_of_slice_knobs_refuse(kw, small_tensor):
    """Every knob of the reference runs: the warm starts and objectives of
    Queue A items 8 and 9, and ``precision="auto"`` since item 10 (under
    the default cost model it resolves to f32, as the reference's)."""
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    _, fits = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu", **kw)
    assert len(fits) == 1 and np.isfinite(fits[0]) and 0 <= fits[0] <= 1


@pytest.mark.parametrize("var,value", [
    ("REPRO_WARM_START", "sketch"), ("REPRO_OBJECTIVE", "nn"),
])
def test_out_of_slice_env_knobs_refuse(monkeypatch, var, value,
                                       small_tensor):
    """The ``REPRO_*`` variables of items 8 and 9 are read: setting one
    gives the trajectory of passing its value."""
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    knob = {"REPRO_WARM_START": "warm_start", "REPRO_OBJECTIVE": "objective"}
    _, want = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu",
                        **{knob[var]: value})
    monkeypatch.setenv(var, value)
    _, got = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu")
    assert got == want


def test_precision_env_knob_is_read(monkeypatch, small_tensor):
    t = convert.sparse_tensor(small_tensor.coords, small_tensor.values,
                              small_tensor.shape)
    _, want = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu",
                        precision="bf16")
    monkeypatch.setenv("REPRO_PRECISION", "bf16")
    _, got = port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu")
    assert got == want
    monkeypatch.setenv("REPRO_PRECISION", "fp8")
    with pytest.raises(ValueError, match="REPRO_PRECISION"):
        port.hooi(t, (3, 3, 3), n_invocations=1, device="cpu")


BLOCK_KNOBS = {"block2": dict(lanczos_block=2),
               "block4": dict(lanczos_block=4),
               "fused": dict(fused_zbuild=True),
               "block4_fused": dict(lanczos_block=4, fused_zbuild=True)}


@pytest.mark.parametrize("knobs", sorted(BLOCK_KNOBS))
@pytest.mark.parametrize("fixture", ["lowrank_tensor", "skewed_tensor"])
def test_block_and_fused_knobs_match_reference(request, fixture, knobs):
    """``lanczos_block`` and ``fused_zbuild`` run the block driver and the
    fused Z-build, and give the reference's block and fused ``hooi``."""
    t = request.getfixturevalue(fixture)
    core = CORE[fixture]
    kw = BLOCK_KNOBS[knobs]
    ref_dec, ref_fits = ref_hooi(t, core, n_invocations=3, seed=0, **kw)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, fits = port.hooi(
        convert.sparse_tensor(t.coords, t.values, t.shape), core,
        n_invocations=3, seed=0, init=[np.asarray(f) for f in init],
        draw=jax_draws(0), device="cpu", **kw)
    assert_fits_match(fits, ref_fits)
    assert_core_energy_matches(t, dec.core, ref_dec.core)
    assert_subspaces_match(dec.factors, ref_dec.factors)


@pytest.mark.parametrize("var,value,kw", [
    ("REPRO_LANCZOS_BLOCK", "4", dict(lanczos_block=4)),
    ("REPRO_FUSED_ZBUILD", "1", dict(fused_zbuild=True)),
])
def test_block_and_fused_env_knobs_are_read(monkeypatch, var, value, kw,
                                            lowrank_tensor):
    """The environment variables mean what the arguments mean, in the port
    and in the reference alike."""
    t = lowrank_tensor
    pt = convert.sparse_tensor(t.coords, t.values, t.shape)
    init = [np.asarray(f) for f in ref_random_factors(
        t.shape, (2, 2, 2), jax.random.PRNGKey(0))]
    _, want = port.hooi(pt, (2, 2, 2), n_invocations=2, seed=0, init=init,
                        draw=jax_draws(0), device="cpu", **kw)
    monkeypatch.setenv(var, value)
    _, got = port.hooi(pt, (2, 2, 2), n_invocations=2, seed=0, init=init,
                       draw=jax_draws(0), device="cpu")
    assert got == want
    _, ref_fits = ref_hooi(t, (2, 2, 2), n_invocations=2, seed=0)
    assert_fits_match(got, ref_fits)
    monkeypatch.setenv(var, "x")
    with pytest.raises(ValueError, match=var):
        port.hooi(pt, (2, 2, 2), n_invocations=1, device="cpu")
