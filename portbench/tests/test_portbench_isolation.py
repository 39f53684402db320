"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the port (top-level names compared whole:
the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "durf_tpu"}


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "durf_tpu_torch" not in imported(path), path
    code = ("import sys; import portbench.reference.nerf, portbench.reference.step, "
            "portbench.reference.scene; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'durf_tpu_torch', 'durf_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}, check=True)
    assert out.stdout.strip() == "[]"


def test_a_rehearsal_loads_no_jax():
    """A tiny CPU rehearsal of a training and the render cell, then the
    harness's own check of sys.modules."""
    code = (
        "import sys\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        "tiny.run('flagship.train-b16384', seconds=0.2)\n"
        "tiny.run('waymo_fast.render-views', seconds=0.2)\n"
        "assert 'durf_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
