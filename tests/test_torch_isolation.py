"""The port stands alone: nothing of JAX or of the reference package is
reachable from ``repro_torch`` or from ``chip_smoke.py``, which run on a
machine that has neither."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")
CHIP_SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    for dirpath, _, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(_port_files()) + [CHIP_SMOKE],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax():
    import repro_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    script = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {SRC!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import runpy\n"
        f"runpy.run_path({CHIP_SMOKE!r}, run_name='chip_smoke')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(mods) >= 20
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
