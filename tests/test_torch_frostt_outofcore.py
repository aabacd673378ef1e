"""Out-of-core twin of ``tests/test_frostt_outofcore.py`` for the port.

The same subprocess (a multi-hundred-MB synthetic ``.tns`` file generated
and streamed in twelve 750,000-element batches) through the port's
``repro_torch.data.frostt.stream_tns``, held to the reference's bounds:
peak RSS under 2.5x the binary size of the accumulated arrays plus 300 MB,
and the stream's chain fingerprint equal to the sha1 chain recomputed from
the source arrays. The port keeps the accumulated values in numpy arrays,
not in a dict, which is what the RSS bound measures.

The script is started through ``/bin/sh`` (which forks it) rather than
directly: a process that Python's ``subprocess`` starts reports in
``ru_maxrss`` the peak RSS of the process that started it (on Linux the
exec carries the parent's high-water mark over), so under a test worker
that has loaded JAX and torch the reading is the worker's, not the
script's. Forked from the small shell, the script's reading is its own.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
from test_frostt_outofcore import _SCRIPT as _REF_SCRIPT

REPO = Path(__file__).resolve().parent.parent
_REF_IMPORT = "from repro.data.frostt import stream_tns"
_SCRIPT = _REF_SCRIPT.replace(_REF_IMPORT,
                              "from repro_torch.data.frostt import stream_tns")


def test_stream_tns_multi_hundred_mb_bounded_memory(tmp_path):
    pytest.importorskip("resource")  # POSIX-only RSS accounting
    assert _REF_IMPORT in _REF_SCRIPT and _REF_IMPORT not in _SCRIPT
    out = subprocess.run(
        ["/bin/sh", "-c", '"$0" "$@"; exit $?', sys.executable, "-c",
         _SCRIPT, str(tmp_path / "ooc.tns")],
        cwd=REPO, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("JSON::")][-1]
    r = json.loads(line[len("JSON::"):])

    assert r["nnz"] == 12 * 750_000
    assert r["version"] == 12  # one stream version per file batch
    assert r["file_bytes"] > 200 * 2**20  # genuinely multi-hundred-MB text
    assert r["fingerprint"] == r["expected"]
    ceiling = 2.5 * r["data_bytes"] + 300 * 2**20
    assert r["maxrss_bytes"] < ceiling, (r["maxrss_bytes"], ceiling)
