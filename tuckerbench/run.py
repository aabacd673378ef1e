"""tuckerbench: the benchmark of ``repro_torch`` on one NVIDIA card.

    python3 tuckerbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control bf16]

Run from the root of a checkout. Loads the cell named in ``BENCHMARK.json``,
draws its tensor from the seed, sets up, warms up, measures for
``--seconds`` (``--trace 1``: profiles the traced decompositions instead),
checks the decomposition against the plain reference and prints one JSON
line last on standard output. ``--control bf16`` runs the lower-precision
control, whose ``correct`` has to come out false. Exits non-zero, with no
result, without a CUDA card, or if JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".tuckerbench_cache"

# every build and kernel cache at a fixed path inside the checkout; the
# program's own knobs pinned by the traffic, not by the environment
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
# one process with one host thread per pool: on a host whose cores are
# shared, fewer threads make runs steadier (and no slower here)
for _pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_pool] = "1"
for _knob in [k for k in os.environ if k.startswith("REPRO_")]:
    del os.environ[_knob]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None)
    args = p.parse_args(argv)

    from tuckerbench import harness

    try:
        spec = harness.load_spec(args.workload, ROOT)
        result = harness.run(spec, args.seed, args.seconds,
                             bool(args.trace), T_START,
                             control=args.control)
    except harness.BenchError as e:
        print(f"tuckerbench: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"tuckerbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
