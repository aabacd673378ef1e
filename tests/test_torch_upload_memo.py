"""``convert.device_coords`` keeps a tensor's device copy with the tensor.

The first ``hooi`` call on a ``SparseTensor`` casts its coordinates and
values and copies them to the device; later calls on the same instance reuse
that copy, count 0 ``hooi.upload_bytes`` and 1 ``hooi.upload_reused``, and
give bitwise what a call on a fresh instance gives. The copy is keyed by the
instance (never by its fingerprint) and freed with it.
"""

import gc
import threading
import weakref

import numpy as np
import pytest
import torch

from repro_torch import convert, tracing
from repro_torch.core.coo import SparseTensor
from repro_torch.core.hooi import hooi, hooi_invocation, random_factors
from repro_torch.random import make_key

SHAPES = {3: (30, 20, 25), 4: (12, 10, 14, 8)}
NNZ = 1500
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _tensor(N: int, seed: int = 0) -> SparseTensor:
    """int64 coordinates and float64 values, so the first call converts."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[N]
    lin = rng.choice(int(np.prod(shape)), NNZ, replace=False)
    coords = np.stack(np.unravel_index(lin, shape), 1).astype(np.int64)
    return SparseTensor(coords, rng.random(NNZ), shape)


def _run(t: SparseTensor):
    return hooi(t, (3,) * t.ndim, n_invocations=2, seed=5, device="cpu")


def _assert_bitwise(a, b):
    (dec_a, fits_a), (dec_b, fits_b) = a, b
    assert fits_a == fits_b
    assert torch.equal(dec_a.core, dec_b.core)
    for Fa, Fb in zip(dec_a.factors, dec_b.factors):
        assert torch.equal(Fa, Fb)


def _spy(monkeypatch) -> list:
    """Every pair ``convert.device_coords`` hands out, in order."""
    seen = []
    real = convert.device_coords

    def device_coords(t, device):
        seen.append(real(t, device))
        return seen[-1]

    monkeypatch.setattr(convert, "device_coords", device_coords)
    return seen


def _refuse_copy(*args, **kwargs):
    raise AssertionError("the host arrays were converted again")


@pytest.mark.parametrize("N", [3, 4])
def test_second_call_reuses_the_copy(N, monkeypatch):
    t = _tensor(N)
    seen = _spy(monkeypatch)
    with tracing.recording():
        _run(t)
    first = tracing.summary()["hooi.upload"]["counters"]
    assert first == {"hooi.upload_bytes": t.nnz * (4 * N + 4)}
    tracing.clear()
    monkeypatch.setattr(torch, "from_numpy", _refuse_copy)
    with tracing.recording():
        _run(t)
    second = tracing.summary()["hooi.upload"]["counters"]
    assert second == {"hooi.upload_bytes": 0, "hooi.upload_reused": 1}
    assert seen[1][0] is seen[0][0] and seen[1][1] is seen[0][1]


@pytest.mark.parametrize("N", [3, 4])
def test_reused_copy_is_bitwise_a_fresh_instance(N):
    t = _tensor(N)
    _run(t)
    reused = _run(t)
    assert convert.kept_coords(t, CPU) is not None
    fresh = _run(SparseTensor(t.coords, t.values, t.shape))
    _assert_bitwise(reused, fresh)


@pytest.mark.parametrize("N", [3, 4])
def test_fresh_instance_misses_and_no_fingerprint(N):
    t = _tensor(N)
    _run(t)
    assert getattr(t, "_fingerprint", None) is None
    twin = SparseTensor(t.coords, t.values, t.shape)
    assert convert.kept_coords(twin, CPU) is None
    with tracing.recording():
        _run(twin)
    counters = tracing.summary()["hooi.upload"]["counters"]
    assert counters == {"hooi.upload_bytes": t.nnz * (4 * N + 4)}
    assert convert.kept_coords(twin, CPU)[0] is not \
        convert.kept_coords(t, CPU)[0]
    assert getattr(twin, "_fingerprint", None) is None


@pytest.mark.parametrize("N", [3, 4])
def test_invocation_hits_the_copy_hooi_kept(N, monkeypatch):
    t = _tensor(N)
    _run(t)
    kept = convert.kept_coords(t, "cpu")
    seen = _spy(monkeypatch)
    monkeypatch.setattr(torch, "from_numpy", _refuse_copy)
    factors = random_factors(t.shape, (3,) * N, make_key(2), "cpu")
    hooi_invocation(t, factors, make_key(3), device="cpu")
    assert len(seen) == 1
    assert seen[0][0] is kept[0] and seen[0][1] is kept[1]


@pytest.mark.parametrize("N", [3, 4])
def test_copy_is_freed_with_the_tensor(N):
    t = _tensor(N)
    _run(t)
    coords, values = convert.kept_coords(t, CPU)
    refs = weakref.ref(coords), weakref.ref(values)
    del t, coords, values
    gc.collect()
    assert all(r() is None for r in refs)


@pytest.mark.parametrize("N", [3, 4])
def test_device_names_share_one_entry(N):
    t = _tensor(N)
    a = convert.device_coords(t, "cpu")
    b = convert.device_coords(t, CPU)
    assert a[0] is b[0] and a[1] is b[1]
    assert len(t._device_coords) == 1
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.float32
    assert np.array_equal(a[0].numpy(), t.coords)
    assert np.array_equal(a[1].numpy(), t.values.astype(np.float32))


@pytest.mark.parametrize("N", [3, 4])
def test_racing_misses_keep_one_copy(N, monkeypatch):
    """Two threads that both miss each copy; one pair survives, and both
    are handed it."""
    t = _tensor(N)
    both_missed = threading.Barrier(2, timeout=30)
    real = convert.kept_coords

    def kept_coords(tt, device):
        got = real(tt, device)
        both_missed.wait()
        return got

    monkeypatch.setattr(convert, "kept_coords", kept_coords)
    out = [None, None]

    def call(i):
        out[i] = convert.device_coords(t, CPU)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    monkeypatch.undo()
    assert out[0][0] is out[1][0] and out[0][1] is out[1][1]
    assert len(t._device_coords) == 1
    assert convert.kept_coords(t, CPU)[0] is out[0][0]
