"""The port's engine, serving and runtime layers are family-agnostic.

The JAX package's rule (DESIGN.md §13, ``tools/check_layering.py``,
``tests/test_layering.py``) applied to ``src/repro_torch``: no module
under ``engine``, ``serve`` or ``runtime`` imports ``repro_torch.core``,
and none names ``HLLConfig``, ``ADSConfig`` or ``_NEWTON_ITERS`` anywhere
in its text, docstrings included. The scan is a plain text scan of its
own, as the reference's is; ``tools/check_layering.py`` gates only the
JAX package.
"""
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATED_DIRS = ("src/repro_torch/engine", "src/repro_torch/serve",
              "src/repro_torch/runtime")
#: an import of the family-math package, however spelled
_IMPORT = re.compile(
    r"^\s*(from\s+repro_torch\.core\b|import\s+repro_torch\.core\b"
    r"|from\s+repro_torch\s+import\s+(\(\s*)?core\b)")
BANNED = ("HLLConfig", "ADSConfig", "_NEWTON_ITERS")


def scan(root: str) -> list[tuple[str, int, str]]:
    """Every violation under ``root``'s gated dirs as (path, line, text)."""
    bad = []
    for rel in GATED_DIRS:
        for dirpath, _dirs, files in os.walk(os.path.join(root, rel)):
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as f:
                    for lineno, line in enumerate(f, start=1):
                        if _IMPORT.match(line) or any(
                                sym in line for sym in BANNED):
                            bad.append((os.path.relpath(path, root), lineno,
                                        line.rstrip()))
    return bad


def _tree(tmp_path):
    for rel in GATED_DIRS:
        (tmp_path / rel).mkdir(parents=True)
    return tmp_path


def test_port_layers_are_family_agnostic():
    """The live tree has no violation (each is named on failure)."""
    assert all(os.path.isdir(os.path.join(REPO, d)) for d in GATED_DIRS)
    bad = scan(REPO)
    assert not bad, "\n".join(f"{p}:{n}: {t}" for p, n, t in bad)


@pytest.mark.parametrize("line", [
    "from repro_torch.core import hll  # planted",
    "from repro_torch.core.degreesketch import pad_vertices",
    "import repro_torch.core.families",
    "    from repro_torch import core",
])
def test_scan_catches_an_import_leak(tmp_path, line):
    """A planted core import is found and located."""
    root = _tree(tmp_path)
    leak = root / "src/repro_torch/engine/leak.py"
    leak.write_text(f"x = 1\n{line}\n")
    bad = scan(str(root))
    assert len(bad) == 1
    path, lineno, text = bad[0]
    assert path.endswith("leak.py") and lineno == 2 and "core" in text


@pytest.mark.parametrize("symbol", BANNED)
@pytest.mark.parametrize("layer", ["serve", "runtime"])
def test_scan_catches_banned_vocabulary(tmp_path, symbol, layer):
    """Each banned name is caught, even inside a docstring."""
    root = _tree(tmp_path)
    (root / f"src/repro_torch/{layer}/doc.py").write_text(
        f'"""Pass a {symbol} here."""\n')
    bad = scan(str(root))
    assert len(bad) == 1 and bad[0][1] == 1


def test_scan_passes_other_imports(tmp_path):
    """Imports of the layers below (kernels, graph, ckpt) are allowed."""
    root = _tree(tmp_path)
    (root / "src/repro_torch/engine/ok.py").write_text(
        "from repro_torch.kernels.inputs import pad_vertices\n"
        "from repro_torch.kernels import registry\n"
        "import repro_torch.corelike\n")
    assert scan(str(root)) == []
