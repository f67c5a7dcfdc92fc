"""The repository's check gate (``scripts/check.sh``: lint, byte-compile,
doctest) over the port: every ``fqtk_tpu_torch/**/*.py``, every
``tests/test_torch_*.py`` and ``chip_smoke.py``.

``scripts/lint.py`` names only the JAX package's files in its targets, so
it is loaded here by path, unchanged, and its ``check_file`` runs on each
of the port's files (every finding is an error, as there).  One case per
file, so a finding names its file."""

import doctest
import importlib
import importlib.util
import py_compile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "fqtk_tpu_torch"
FILES = (sorted(PKG.rglob("*.py")) + sorted((ROOT / "tests").glob("test_torch_*.py"))
         + [ROOT / "chip_smoke.py"])
#: port modules that hold doctest examples
DOCTEST_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if ">>>" in p.read_text()
)


def _ids(path):
    return str(path.relative_to(ROOT))


def _lint():
    spec = importlib.util.spec_from_file_location("_repo_lint", ROOT / "scripts" / "lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gate_covers_the_port():
    names = {_ids(p) for p in FILES}
    for must in ("fqtk_tpu_torch/__init__.py", "fqtk_tpu_torch/bench.py",
                 "fqtk_tpu_torch/scripts/profile_e2e.py", "tests/test_torch_check_gate.py",
                 "tests/test_torch_subsample.py", "chip_smoke.py"):
        assert must in names
    assert "fqtk_tpu_torch.core.bitenc" in DOCTEST_MODULES


@pytest.mark.parametrize("path", FILES, ids=_ids)
def test_lint(path):
    assert _lint().check_file(path) == []


@pytest.mark.parametrize("path", FILES, ids=_ids)
def test_compiles(path, tmp_path):
    py_compile.compile(str(path), cfile=str(tmp_path / "out.pyc"), doraise=True)


@pytest.mark.parametrize("name", DOCTEST_MODULES)
def test_doctests(name):
    result = doctest.testmod(importlib.import_module(name))
    assert result.attempted > 0 and result.failed == 0, result
