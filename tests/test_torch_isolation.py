"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and the
port's examples import neither JAX (nor ``ml_dtypes``, which comes with
it) nor anything of the JAX package ``repro`` — not even its JAX-free
modules — and the chip script refuses to run outside a checkout."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports_in_the_source():
    """The package, the port's chip script (``chip_smoke.py``) and its
    examples (``examples/*_torch.py``)."""
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(examples) >= 2
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = sorted({"repro_torch." + ".".join(
        f.relative_to(PKG).with_suffix("").parts).removesuffix(".__init__")
        for f in PKG.rglob("*.py")})
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """Copied into a directory that holds nothing else of the repository
    (and, here, without a card), the chip script exits non-zero and prints
    no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
