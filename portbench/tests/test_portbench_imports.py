"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import REPO, ROOT, load_cell, load_manifest

_RUN = """
import json, sys
from portbench.harness import forbidden_modules, load_cell, load_manifest, load_module, run_cell
from portbench import calibrate, tracing, generators, work
sys.path.insert(0, {tests!r})
from bench_cells import SEED, tiny
manifest = load_manifest()
for m in manifest["per_layer"]:
    load_module("metrics", m["name"])
manifest, cell, overrides = tiny({workload!r})
run_cell(manifest, cell, SEED, 0.2, True, device="cpu", mix_overrides=overrides)
print(json.dumps(forbidden_modules()))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def _one_cell_per_driver():
    manifest = load_manifest()
    by_driver = {}
    for cell in manifest["workloads"]:
        by_driver.setdefault(load_cell(manifest, cell["name"])["mix_data"]["driver"], cell["name"])
    return sorted(by_driver.values())


@pytest.mark.parametrize("workload", _one_cell_per_driver())
def test_a_run_of_each_driver_loads_no_jax(workload):
    assert json.loads(_python(_RUN.format(tests=str(ROOT / "tests"), workload=workload))) == []


def test_the_reference_imports_nothing_of_the_program():
    code = ("import json, sys, portbench.reference.vae; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules if m.startswith('debvader')})))")
    assert json.loads(_python(code)) == []
    for path in (ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert not name.split(".")[0].startswith(("debvader", "jax", "flax")), (path, name)
