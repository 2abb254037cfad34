"""No module a cell runs imports jax, jaxlib, flax or the JAX package
(whole top-level names: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import subprocess
import sys

import pytest

from conftest import ROOT

BLOCKER = """
import sys
class Block:
    def __init__(self, names):
        self.names = set(names)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError(f"blocked: {{name}}")
        return None
sys.meta_path.insert(0, Block({names!r}))
sys.path.insert(0, {root!r})
"""

JAX = ["jax", "jaxlib", "flax", "deeppreconditioning_tpu"]


def _modules(folder: str) -> list:
    base = ROOT / "portbench" / folder
    return [p for p in sorted(base.glob("*.py")) if p.name != "__init__.py"]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_a_cell_runs_imports_without_jax():
    loads = "\n".join(
        [f"spec.load_runner({p.stem!r})" for p in _modules("runners")]
        + [f"spec.load_reader({p.stem!r})" for p in _modules("metrics")])
    code = (BLOCKER.format(names=JAX, root=str(ROOT))
            + "import portbench.run, portbench.calibrate\n"
            + "from portbench.harness import spec, loop, readers, trace\n"
            + loads + "\n"
            + "from portbench.harness.loop import jax_modules\n"
            + "assert not jax_modules(), jax_modules()\n"
            + "import deeppreconditioning_tpu_torch\n"
            + "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


@pytest.mark.parametrize("module", [p.stem for p in _modules("reference")])
def test_reference_imports_nothing_of_the_port(module):
    code = (BLOCKER.format(names=JAX + ["deeppreconditioning_tpu_torch"],
                           root=str(ROOT))
            + f"import portbench.reference.{module}\n"
            + "import sys\n"
            + "tops = {n.split('.')[0] for n in sys.modules}\n"
            + "assert 'deeppreconditioning_tpu_torch' not in tops\n"
            + "print('ok')\n")
    out = _run(code)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr


def test_run_without_the_port_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the run
    exits non-zero and prints nothing on standard output."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sludge2d-percase-learned", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
