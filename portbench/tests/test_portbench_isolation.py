"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: checked in fresh interpreters,
since a test worker may hold ``jax`` from other files. Top-level module
names are compared whole: the port's name begins with the JAX
package's."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN_TINY = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from portbench.core import bench
from portbench.tests import tiny
out = bench.run_cell("tiny", 5, 0.5, False, time.time(), device="cpu",
                     bench=tiny.bench(), resolved=tiny.cell())
assert out["correct"], out
import portbench.tools.calibrate, portbench.tools.knee  # noqa
for p in (__import__("pathlib").Path({root!r}) / "portbench" / "metrics"
          ).glob("*.py"):
    bench.metric_reader(p.stem)
tops = sorted({{k.split(".")[0] for k, v in sys.modules.items() if v}})
print(json.dumps(tops))
"""

REFERENCE = """
import json, pkgutil, importlib, sys
sys.path[:0] = [{root!r}, {src!r}]
import portbench.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module("portbench.reference." + m.name)
print(json.dumps(sorted({{k.split(".")[0] for k, v in sys.modules.items()
                          if v}})))
"""


def _tops(code: str):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c",
                        code.format(root=str(ROOT), src=str(ROOT / "src"))],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    tops = _tops(RUN_TINY)
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE)
    assert "torch" in tops
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_source_names_the_jax_package_or_the_old_benchmarks():
    import re
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)"
                     r"|bench" r"marks/", re.M)
    for p in (ROOT / "portbench").rglob("*.py"):
        assert not bad.search(p.read_text()), p
