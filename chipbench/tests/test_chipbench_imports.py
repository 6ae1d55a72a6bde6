"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or the JAX package ``ics_tpu`` (compared whole: the port's
``ics_tpu_torch`` begins with it), and nothing of the program in the
reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from chipbench.manifest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ics_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_nothing_under_reference_imports_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"ics_tpu_torch"}), path


def test_the_modules_a_run_loads_are_not_jax_nor_the_jax_package():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['run']\n"
        "import chipbench.run as run, chipbench.readings, chipbench.sweep\n"
        "import chipbench.entries.classify, chipbench.loops.open, chipbench.loops.closed\n"
        "import ics_tpu_torch.runtime.service, ics_tpu_torch.ops.attention\n"
        "import ics_tpu_torch.ops.bottleneck\n"
        "for m in ('batch_fill.label', 'flash_roofline', 'chain_roofline', 'mfu.backlog',\n"
        "          'classify_p95_ms', 'images_per_s', 'setup_s'):\n"
        "    run.manifest.reader(m)\n"
        "print(','.join(run.forbidden_modules()) or 'none')\n"
        "print('ics_tpu_torch' in {m.split('.')[0] for m in sys.modules})\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert out == ["none", "True"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, chipbench.reference.models, chipbench.reference.preprocess, "
            "chipbench.reference.resnet_bottleneck, chipbench.reference.vit, "
            "chipbench.weights, chipbench.correct\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ics_tpu_torch', 'ics_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.strip()
    assert out == "[]"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import types

    from chipbench import run

    monkeypatch.setitem(sys.modules, "ics_tpu_torch_like", types.ModuleType("ics_tpu_torch_like"))
    assert "ics_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ics_tpu.runtime", types.ModuleType("ics_tpu.runtime"))
    assert run.forbidden_modules() == ["ics_tpu"]
