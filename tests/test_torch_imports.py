"""The PyTorch port's import graph: it stands apart from JAX and ``repro``.

* every ``repro_torch`` module imports here, with no CUDA and no ``triton``
  (nothing is built or loaded at import);
* importing the whole package in a fresh interpreter leaves ``jax`` and
  ``repro`` out of ``sys.modules`` and loads no kernel library;
* no port source, and not ``chip_smoke.py``, imports ``jax`` or ``repro``.
"""

import glob
import importlib
import os
import re
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
PORT_FILES = sorted(glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"),
                              recursive=True))


def _modules():
    for py in PORT_FILES:
        mod = os.path.relpath(py, SRC)[:-3].replace(os.sep, ".")
        yield mod[: -len(".__init__")] if mod.endswith(".__init__") else mod


def test_every_port_module_imports():
    failures = {}
    for mod in _modules():
        try:
            importlib.import_module(mod)
        except Exception as e:  # noqa: BLE001 — report all, not just first
            failures[mod] = f"{type(e).__name__}: {e}"
    assert not failures, f"port modules that fail to import: {failures}"
    assert len(list(_modules())) >= 20


def test_streaming_and_scheduler_are_covered():
    mods = set(_modules())
    assert {"repro_torch.streaming", "repro_torch.engine.scheduler",
            "repro_torch.data.frostt"} <= mods


def test_pool_router_and_examples_are_covered():
    """The serving tier and the example twins are among the modules the
    import checks above load without ``jax``/``repro``."""
    mods = set(_modules())
    assert {"repro_torch.engine.pool", "repro_torch.engine.router",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.tucker_compress",
            "repro_torch.examples.complete_masked",
            "repro_torch.examples.serve_pool"} <= mods
    from repro_torch import engine

    assert {"ExecutorPool", "PoolLane", "PoolStats", "device_slices",
            "PoolSaturated", "StreamRouter", "StreamScheduler"} \
        <= set(engine.__all__)
    # not ported on purpose: the device picks the kernel, and stacked
    # ranks have no mesh axis or per-shard upload layout
    assert not {"resolve_kernel", "kernel_forced_by_env", "AXIS",
                "ARRAY_FIELDS"} & set(engine.__all__)


def test_mesh_is_covered():
    """The rank mesh is among the modules the import checks load without
    ``jax``/``repro``, and the entry points export it as the reference's
    ``dist_hooi`` does."""
    assert "repro_torch.distributed.mesh" in set(_modules())
    from repro_torch import distributed, engine
    from repro_torch.distributed import dist_hooi, executor

    assert {"RankMesh", "make_ranks_mesh"} <= set(distributed.__all__)
    assert "make_ranks_mesh" in dist_hooi.__all__
    assert "make_ranks_mesh" in executor.__all__
    assert {"mesh_products", "build_group_z"} <= set(engine.__all__)


def test_serve_pool_example_runs_on_cpu(capsys):
    """``python -m repro_torch.examples.serve_pool --device cpu`` at its
    own size: two CPU lanes, sticky warm resubmits, a warm-start reroute."""
    from repro_torch.examples import serve_pool

    serve_pool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    sticky = out.split("== streams are sticky")[1].split("== warm-start")[0]
    assert sticky.count("decision=reuse   new_steps=0  captures=0  "
                        "uploads=0") == 4
    assert "client-0 now on lane 1: decision=reuse  new_steps=0  " \
        "captures=0  uploads=0" in out
    assert "lanes=2  submitted=" in out and "failed=0" in out
    assert "rerouted=1" in out
    assert not [th for th in threading.enumerate()
                if th.name.startswith(("sched-prepare", "sched-run"))]


def test_port_import_leaves_jax_and_repro_unloaded():
    mods = ", ".join(repr(m) for m in _modules())
    code = (
        "import importlib, sys\n"
        f"for m in [{mods}]:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "from repro_torch.kernels import build\n"
        "print(bad, build._LIBS)\n"
        "sys.exit(1 if bad or build._LIBS else 0)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                        re.MULTILINE)


def test_no_port_source_imports_jax_or_repro():
    offenders = {}
    for py in PORT_FILES + [os.path.join(REPO, "chip_smoke.py")]:
        text = open(py, encoding="utf-8").read()
        hits = _FORBIDDEN.findall(text)
        if hits:
            offenders[os.path.relpath(py, REPO)] = hits
    assert not offenders, f"port files importing jax/repro: {offenders}"


def test_kernel_sources_present():
    from repro_torch.kernels import build

    assert set(build.sources()) == {"kron_segsum", "oracle_pair"}
