"""The PyTorch port imports no JAX, Flax or YAML: every module of the
package (and ``chip_smoke.py``) imports in a subprocess where those
modules cannot be imported."""

import subprocess
import sys
from pathlib import Path

import torch  # noqa: F401  (the port needs torch, and only torch)

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "yaml", "msgpack"):
    sys.modules[name] = None
import deeppreconditioning_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("ops.ic0", "ops.trisolve", "ops.amg", "ops.banded_factor",
             "bench.irregular"):
    assert pkg.__name__ + "." + name in sys.modules, name
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "yaml", "deeppreconditioning_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40
