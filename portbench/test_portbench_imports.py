"""No module of the benchmark imports JAX or the JAX package ``repro``,
compared by whole top-level names (the port, ``repro_torch``, begins with
``repro``); the reference imports nothing of the port either."""
import ast
import subprocess
import sys

from portbench import run as entry
from portbench.harness.cell import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    for p in files:
        assert not set(imported_tops(p)) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in sorted((ROOT / "reference").rglob("*.py")):
        tops = set(imported_tops(p))
        assert tops <= {"__future__", "math", "typing", "numpy", "torch"}, \
            (p, tops)


def test_forbidden_names_are_whole_names():
    loaded = ["repro_torch", "repro_torch.models", "jaxtyping", "torch"]
    assert entry.forbidden_modules(loaded) == []
    assert entry.forbidden_modules(loaded + ["repro.core", "jax.numpy"]) \
        == ["jax", "repro"]


def test_a_run_loads_no_jax():
    """A whole CPU run at the reduced size, in a process of its own, leaves
    none of the forbidden modules loaded."""
    code = (
        "import sys\n"
        "from portbench.conftest import small_cell\n"
        "from portbench.drivers import train as drv\n"
        "from portbench import run as entry\n"
        "from portbench.harness.metrics import readers\n"
        "readers()\n"
        "r = drv.run(small_cell('zamba2-1.2b.train_4k.b4'), 3,"
        " 0.05, False, lambda: 0.0, device='cpu')\n"
        "print(entry.forbidden_modules(), r['correct'])\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT.parent,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                            "PYTHONPATH": f"{ROOT.parent / 'src'}:"
                                          f"{ROOT.parent}"})
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"
