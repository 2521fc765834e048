"""Nothing the benchmark runs imports JAX or the JAX package, compared by
the whole top-level name; the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "xsarsea_tpu"}
PROGRAM = "xsarsea_tpu_torch"
# the one module that hands the program its inputs; the tests compare with it
MAY_IMPORT_PROGRAM = {BENCH / "system.py"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = imported_top_names(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_only_the_system_adapter_imports_the_program():
    for path in sources():
        if path in MAY_IMPORT_PROGRAM or path.parent.name == "tests":
            continue
        assert PROGRAM not in imported_top_names(path), path


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch\n"
        "from benchmark.harness import Cell\n"
        "from benchmark.reference.luts import Tables\n"
        "from benchmark.reference.judge import Judge\n"
        "cell = Cell(%r, 'lut_scansar_resident')\n"
        "j = Judge(Tables(cell.config, %r), 0.1, torch.device('cpu'))\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'xsarsea_tpu', 'xsarsea_tpu_torch'}))\n"
    ) % (str(BENCH.parent), str(BENCH.parent), str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"
