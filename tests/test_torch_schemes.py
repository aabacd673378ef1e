"""The paper's distribution schemes and four-mode tensors against the
reference.

CoarseG (``coarse``, LPT), MediumG (``medium``) and HyperG (``hypergraph``)
split the tensor otherwise than Lite: MediumG and HyperG are uni-policy
(one copy of the tensor, each mode's rows shared by several ranks), which
gives other ``Lp``, boundary maps and padding. ``auto`` picks among Lite,
CoarseG and MediumG by the modeled cost. Each runs here through the port's
``dist_hooi`` against the reference's ``use_kernel=False`` run on its
simulated devices, on the hub-skewed fixture and on a four-mode tensor with
the paper suite's enron-s skew and hub (``SUITE_SPECS``; its cases in
``test_torch_schemes_four_mode.py``), with the
reference's initial factors and draws. Also single-process ``hooi`` on the
four-mode tensor. The reference's runs use the default (vector) Lanczos:
its compile time, not the sweeps, sets these files' time.

Bars, as ``test_torch_hooi.py`` sets them out: fits within 1e-4 (as the
captured energy share within 1e-6 relative where the fit is within 1e-3 of
1), ``F Fᵀ`` within 1e-3, final cores' energy within 2e-6 relative.
"""

import jax
import numpy as np
import pytest

from repro.core.hooi import hooi as ref_hooi
from repro.core.hooi import random_factors as ref_random_factors
from repro.data.tensors import SUITE_SPECS as REF_SUITE_SPECS
from repro.data.tensors import synth_tensor as ref_synth_tensor
from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core.hooi import hooi
from repro_torch.data.tensors import SUITE_SPECS
from repro_torch.distributed.dist_hooi import dist_hooi
from test_torch_hooi import (assert_core_energy_matches, assert_fits_match,
                             assert_subspaces_match, jax_draws)

ENRON_S = next(s for s in SUITE_SPECS if s.name == "enron-s")
CORE = {"skewed": (4, 4, 4), "four_mode": (3, 3, 3, 3)}


def _four_mode():
    """enron-s's skew and its 9% hub on mode 0, at a CPU test's size."""
    spec = next(s for s in REF_SUITE_SPECS if s.name == "enron-s")
    return ref_synth_tensor((60, 57, 240, 12), 6_000, spec.alphas,
                            hub_fraction=spec.hub_fraction,
                            hub_modes=spec.hub_modes, seed=0)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def test_four_mode_tensor_carries_enron_s_skew():
    t = _four_mode()
    assert t.ndim == 4 and ENRON_S.hub_modes == (0,)
    assert ENRON_S.alphas == (1.4, 1.4, 1.1, 0.8)
    assert t.slice_sizes(0).max() >= ENRON_S.hub_fraction * t.nnz


SCHEMES = ["coarse", "medium", "hypergraph", "auto"]


def check_scheme_against_reference(t, core, scheme, path):
    """``dist_hooi`` under ``scheme`` on ``path`` (vector Lanczos, the
    fused oracle's plain version), held to the reference's run."""
    kw = dict(n_invocations=3, path=path, seed=0)
    ref_dec, ref_st = ref_dist_hooi(t, core, 4, scheme=scheme,
                                    use_kernel=False, **kw)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, st = dist_hooi(_port(t), core, 4, scheme=scheme, device="cpu",
                        draw=jax_draws(0), use_fused_oracle=True,
                        init=[np.asarray(f) for f in init], **kw)
    assert st.scheme == ref_st.scheme
    if scheme == "auto":
        assert st.scheme in port_plan.AUTO_CANDIDATES
        assert st.selection.keys() == ref_st.selection.keys()
    assert st.comm_backends == ref_st.comm_backends
    assert st.r_pad == ref_st.r_pad and st.e_pad == ref_st.e_pad
    assert st.z_passes == ref_st.z_passes
    assert all(np.isfinite(st.fits)) and all(0 <= f <= 1 for f in st.fits)
    assert_fits_match(st.fits, ref_st.fits)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    assert_core_energy_matches(t, dec.core, ref_dec.core)


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_matches_reference(skewed_tensor, scheme, path):
    """On the hub-skewed fixture; the four-mode tensor's cases are in
    ``test_torch_schemes_four_mode.py`` (the reference compiles every
    scheme's steps anew, about 11 s each at four modes)."""
    check_scheme_against_reference(skewed_tensor, CORE["skewed"], scheme,
                                   path)


@pytest.mark.parametrize("scheme", ["lite", "coarse", "medium",
                                    "hypergraph"])
def test_schemes_agree_on_four_modes(scheme):
    """The distribution changes the time, not the result: each scheme's
    fits on the four-mode tensor lie within 1e-4 of Lite's, its final
    core's energy within 2e-6 relative (the bars ``chip_smoke.py`` holds
    the card's schemes to); uni-policy plans keep one copy of the
    elements."""
    t = _port(_four_mode())
    core = CORE["four_mode"]
    kw = dict(n_invocations=2, path="liteopt", seed=1, lanczos_block=4,
              fused_zbuild=True, use_fused_oracle=True, device="cpu")
    pl = port_plan.plan(t, scheme, 4, core_dims=core, path="auto")
    dec, st = dist_hooi(t, core, 4, scheme=pl, **kw)
    lite, lst = dist_hooi(t, core, 4, scheme="lite", **kw)
    np.testing.assert_allclose(st.fits, lst.fits, rtol=0, atol=1e-4)
    tt = float(np.sum(np.asarray(t.values, np.float64) ** 2))
    share = [float((d.core.double() ** 2).sum()) / tt for d in (dec, lite)]
    assert share[0] == pytest.approx(share[1], rel=2e-6, abs=0)
    held = [int(mp.e_per_rank.sum()) for mp in pl.parts]
    if pl.scheme.uni:
        assert held == [t.nnz] * t.ndim
    assert [mp.mode for mp in pl.parts] == list(range(t.ndim))


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_hooi_four_mode_matches_reference(fused):
    """Single-process ``hooi`` on the four-mode tensor: the gather form's
    N >= 4 fold of the leading factors into ``a`` (K̂ = 27 here)."""
    t = _four_mode()
    core = CORE["four_mode"]
    ref_dec, ref_fits = ref_hooi(t, core, n_invocations=2, seed=0,
                                 use_fused_oracle=fused)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, fits = hooi(_port(t), core, n_invocations=2, seed=0,
                     init=[np.asarray(f) for f in init], draw=jax_draws(0),
                     use_fused_oracle=fused, device="cpu")
    assert all(np.isfinite(fits)) and all(0.0 <= f <= 1.0 for f in fits)
    assert_fits_match(fits, ref_fits)
    assert_core_energy_matches(t, dec.core, ref_dec.core)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    assert tuple(dec.core.shape) == core


@pytest.mark.parametrize("scheme", ["lite", "medium", "hypergraph"])
def test_boundary_slot_rounds_bitwise_column_loop(scheme):
    """The boundary space adds each owned row's boundary slots in rounds
    (``comm.add_slots``: a row takes at most one slot from each other rank,
    so P - 1 rounds); the bits are those of adding one slot column at a
    time, every row's adds in slot order. Uni-policy plans hold thousands
    of slot columns a rank at nell-2 size."""
    import torch

    from repro_torch.data.tensors import synth_tensor
    from repro_torch.engine.comm import add_slots, comm_maps, gather_rows

    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    pl = port_plan.plan(t, scheme, 4, core_dims=(5, 5, 5), path="auto")
    g = torch.Generator().manual_seed(0)
    most = 0  # slots a row takes, at most
    for mp in pl.parts:
        maps = {k: torch.from_numpy(v) for k, v in comm_maps(mp).items()}
        P, Lp = mp.P, mp.Lp
        base = torch.arange(P) * (Lp + 1)
        local = torch.randn((P * mp.R_pad, 8), generator=g) * 1e3
        want = torch.randn((P * (Lp + 1), 8), generator=g)
        got = want.clone()
        for j in range(maps["bnd_dst"].shape[1]):
            dst = base + maps["bnd_dst"][:, j]
            want[dst] = want[dst] + gather_rows(local, maps["bnd_src"][:, j])
        add_slots(got, base, maps["bnd_dst"],
                  gather_rows(local, maps["bnd_src"]), Lp, P - 1)
        keep = torch.ones(P * (Lp + 1), dtype=torch.bool)
        keep[base + Lp] = False  # the dump rows
        assert torch.equal(got[keep], want[keep])
        most = max([most] + [
            int(torch.unique(d[d < Lp], return_counts=True)[1].max())
            for d in maps["bnd_dst"] if (d < Lp).any()])
    if scheme != "lite":  # rows with slots from two and three other ranks
        assert most == 3
