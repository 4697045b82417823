"""The port stands alone: every module of concept_tpu_torch imports with
JAX blocked, no file of the port (nor chip_smoke.py) imports the JAX
package, and the entry points run on the CUDA card unless the caller asks
for the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # parallel test workers share the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "concept_tpu_torch", "**", "*.py"),
                              recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]


def test_every_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import concept_tpu_torch\n"
        "for m in pkgutil.walk_packages(concept_tpu_torch.__path__, 'concept_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'concept_tpu' or k.startswith('concept_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_jax_package(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("concept_tpu", "jax", "jaxlib"), (path, name)


def test_run_without_cuda_raises(monkeypatch):
    """run(..., device=None) means the card: without CUDA it raises
    instead of carrying on on the CPU."""
    from concept_tpu_torch.device import resolve_device
    from concept_tpu_torch.param import load_params
    from concept_tpu_torch.run import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_params(os.path.join(ROOT, "param", "example_basic.py"),
                      overrides=["initial_conditions={'species':'matter','N':8**3}"])
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(cfg, device=device)
    assert resolve_device("cpu").type == "cpu"


def test_the_scan_covers_every_subpackage():
    """Every subpackage of the port is in the AST scan above, the renders
    (graphics/) and the ranks (parallel/) among them."""
    scanned = {os.path.dirname(os.path.relpath(p, ROOT)) for p in PORT_FILES}
    subpackages = {os.path.relpath(os.path.dirname(p), ROOT) for p in glob.glob(
        os.path.join(ROOT, "concept_tpu_torch", "*", "__init__.py"))}
    assert {"concept_tpu_torch/graphics", "concept_tpu_torch/parallel"} <= subpackages
    assert subpackages <= scanned
