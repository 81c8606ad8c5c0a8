"""The port imports no JAX and nothing of the JAX package: an AST scan of
every module of flvis_tpu_torch and of chip_smoke.py, followed through the
imports that resolve inside this repository (transitively).

A sys.modules check cannot show this here: the test process imports jax
for the parity tests, and the container may import it at interpreter
start."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "flvis_tpu_torch"


def _imports(path: Path):
    """Absolute module names imported by a file (relative imports resolved)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    if path.name == "__init__.py":
        pkg = path.relative_to(ROOT).parts[:-1]
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(pkg[:len(pkg) - node.level + 1])
                mod = ".".join(base + ([node.module] if node.module else []))
                out.append(mod)
                out += [f"{mod}.{a.name}" for a in node.names]
            else:
                out.append(node.module)
                out += [f"{node.module}.{a.name}" for a in node.names]
    return out


def _module_file(name: str):
    p = ROOT.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _closure():
    """Files reachable from the port's modules and chip_smoke.py through
    imports that resolve inside this repository (packages' __init__ too)."""
    todo = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    seen = set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in _imports(f):
            parts = name.split(".")
            for i in range(1, len(parts) + 1):
                mf = _module_file(".".join(parts[:i]))
                if mf is not None and mf not in seen:
                    todo.append(mf)
    return sorted(seen)


def test_closure_reaches_the_shared_modules():
    """The closure reaches no file of the JAX package; the port's own copies
    of its JAX-free modules take their place."""
    files = {str(f.relative_to(ROOT)) for f in _closure()}
    assert not [f for f in files if f.startswith("flvis_tpu/")], sorted(files)
    for own in ("flvis_tpu_torch/config.py", "flvis_tpu_torch/io/synthetic.py",
                "flvis_tpu_torch/ops/kernels/schur.py", "chip_smoke.py",
                "flvis_tpu_torch/io/trajectory.py", "flvis_tpu_torch/io/rosbag.py",
                "flvis_tpu_torch/io/euroc.py", "flvis_tpu_torch/io/kitti.py",
                "flvis_tpu_torch/utils/evaluation.py", "flvis_tpu_torch/utils/timing.py",
                "flvis_tpu_torch/utils/profiling.py", "flvis_tpu_torch/run_dataset.py"):
        assert own in files, own


@pytest.mark.parametrize("path", [str(f.relative_to(ROOT)) for f in _closure()])
def test_no_jax_import(path):
    bad = [m for m in _imports(ROOT / path) if m == "jax" or m.startswith("jax.")
           or m == "jaxlib" or m.startswith("jaxlib.")]
    assert not bad, f"{path} imports {bad}"
