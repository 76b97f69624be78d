"""Nothing of the benchmark imports JAX, flax or the JAX package (top-level
names compared whole: optispeech_tpu_torch is not optispeech_tpu), and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optispeech_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax():
    files = list(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not FORBIDDEN & set(_imports(f)), f


def test_reference_imports_nothing_of_the_program():
    for f in [*(BENCH / "reference").rglob("*.py"), *(BENCH / "tests" / "reference").rglob("*.py")]:
        assert not {"optispeech_tpu_torch"} & set(_imports(f)), f


def test_loaded_modules_after_a_cell():
    """Import what run.py imports, and a cell's traffic, metrics and
    reference, in a fresh process: no forbidden top-level module loaded."""
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r})
import run
from harness import common, compare, synthesis, trace, roofline, weights
import reference.generator
common.checkout_env()
for kind in ("traffic", "metrics"):
    for f in sorted((common.BENCH_DIR / kind).glob("*.py")):
        common.load_module(kind, f.stem)
import optispeech_tpu_torch.cli.serve, optispeech_tpu_torch.models.optispeech
print(sorted(k for k in sys.modules if k.split(".")[0] in {sorted(FORBIDDEN)!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
