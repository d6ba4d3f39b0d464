"""Nothing the benchmark runs loads JAX or the JAX package: every module of
the benchmark imported, and a whole run driven, in a fresh process, and
``sys.modules`` read by whole top-level names (the port, ``vjf_tpu_torch``,
shares the JAX package's prefix and must not match)."""
import subprocess
import sys

from bench_tiny import BENCH, ROOT

import run

PROBE = r"""
import importlib, pathlib, sys
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
mods = [p.stem for p in pathlib.Path({bench!r}).glob("*.py")]
mods += ["gen.spikes", "reference.plain", "tests.bench_tiny"]
for m in mods:
    importlib.import_module(m)
for p in pathlib.Path({bench!r}, "metrics").glob("*.py"):
    import cells
    cells.reader(p.stem)
{drive}
import run
print("LOADED", run.forbidden_modules())
print("PORT", "vjf_tpu_torch" in sys.modules)
"""

DRIVE = r"""
sys.path.insert(0, {tests!r})
from bench_tiny import tiny
import run
run.run_cell(tiny("flagship.prefix_free"), 5, 0.1, False, torch.device("cpu"))
"""


def _probe(drive: str) -> str:
    code = PROBE.format(bench=str(BENCH), root=str(ROOT),
                        drive=drive.format(tests=str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_no_jax_after_importing_every_module():
    out = _probe("import run")
    assert "LOADED []" in out


def test_no_jax_after_a_run():
    out = _probe(DRIVE)
    assert "LOADED []" in out and "PORT True" in out


def test_forbidden_names_match_whole():
    sys.modules.setdefault("vjf_tpu_torch_probe_name", sys)
    try:
        assert "vjf_tpu_torch_probe_name" not in run.forbidden_modules()
        assert all(m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())
    finally:
        del sys.modules["vjf_tpu_torch_probe_name"]
