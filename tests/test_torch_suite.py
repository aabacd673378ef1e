"""The reference's last public host names, in the port.

``repro_torch.data.tensors.paper_suite``, ``SparseTensor.norm`` and
``repro_torch.envknobs.snapshot`` are copies of the reference's
(``src/repro/data/tensors.py``, ``src/repro/core/coo.py``,
``src/repro/envknobs.py``): the same arguments and environment give the
same answer bit for bit. Twins of ``tests/test_coo_io.py``'s suite test and
``tests/test_envknobs.py``'s snapshot test.
"""

import numpy as np
import pytest

from repro import envknobs as ref_envknobs
from repro.data import tensors as ref_tensors
from repro_torch import envknobs
from repro_torch.data import tensors


@pytest.mark.parametrize("scale,seed", [(0.05, 0), (0.05, 4), (0.2, 0),
                                        (0.2, 4)])
def test_paper_suite_bitwise(scale, seed):
    port = tensors.paper_suite(scale=scale, seed=seed)
    ref = ref_tensors.paper_suite(scale=scale, seed=seed)
    assert list(port) == list(ref)
    for name, t in port.items():
        r = ref[name]
        assert t.shape == r.shape, name
        assert t.coords.dtype == r.coords.dtype
        assert t.values.dtype == r.values.dtype
        np.testing.assert_array_equal(t.coords, r.coords)
        np.testing.assert_array_equal(t.values, r.values)
        # SparseTensor.norm: the same float, bit for bit
        assert t.norm() == r.norm()
        assert isinstance(t.norm(), float)


def test_paper_suite_mirrors_shape_families():
    """``tests/test_coo_io.py::test_paper_suite_mirrors_shape_families`` on
    the port's suite: three four-mode and five three-mode tensors, and
    enron-s's hub slice."""
    suite = tensors.paper_suite(scale=0.05)
    assert len(suite) == 8
    assert sum(t.ndim == 4 for t in suite.values()) == 3
    assert sum(t.ndim == 3 for t in suite.values()) == 5
    enron = suite["enron-s"]
    assert enron.slice_sizes(0).max() > 10 * enron.nnz / enron.shape[0]


def test_norm_of_an_empty_tensor_is_zero():
    from repro.core.coo import SparseTensor as RefSparseTensor
    from repro_torch.core.coo import SparseTensor

    coords = np.zeros((0, 3), dtype=np.int64)
    values = np.zeros(0)
    assert SparseTensor(coords, values, (2, 3, 4)).norm() == \
        RefSparseTensor(coords, values, (2, 3, 4)).norm() == 0.0


ENV = {"REPRO_FUSED_ZBUILD": "1", "REPRO_PRECISION": " bf16 ",
       "REPRO_LANCZOS_BLOCK": "8", "REPRO_OBJECTIVE": "completion",
       "REPRO_WARM_START": "sketch", "REPRO_SAMPLE_FRACTION": "0.25"}


@pytest.mark.parametrize("env", ["unset", "set"])
def test_snapshot_matches_reference(monkeypatch, env):
    """The port's snapshot covers exactly its ``KNOBS``, each resolved as
    the reference resolves it, with the environment unset and set."""
    for var in ref_envknobs.KNOBS:
        monkeypatch.delenv(var, raising=False)
    if env == "set":
        for var, value in ENV.items():
            monkeypatch.setenv(var, value)
    got = envknobs.snapshot()
    want = ref_envknobs.snapshot()
    assert list(got) == list(envknobs.KNOBS)
    assert set(got) <= set(want)
    assert got == {k: want[k] for k in got}
    if env == "set":
        assert got["REPRO_PRECISION"] == "bf16"
        assert got["REPRO_LANCZOS_BLOCK"] == 8
        assert got["REPRO_SAMPLE_FRACTION"] == 0.25
    else:
        assert got["REPRO_FUSED_ZBUILD"] is False
        assert all(v is None for k, v in got.items()
                   if k != "REPRO_FUSED_ZBUILD")


def test_snapshot_refuses_a_malformed_knob(monkeypatch):
    monkeypatch.setenv("REPRO_LANCZOS_BLOCK", "zero")
    with pytest.raises(ValueError, match="REPRO_LANCZOS_BLOCK"):
        envknobs.snapshot()
    with pytest.raises(ValueError, match="REPRO_LANCZOS_BLOCK"):
        ref_envknobs.snapshot()
