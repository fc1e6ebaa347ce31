"""The port stands alone: importing it (and chip_smoke.py) loads neither JAX
nor anything of the janus_tpu package."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import janus_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "janus_tpu_torch"


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(janus_tpu_torch.__path__, prefix="janus_tpu_torch.")
    )


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "janus_tpu")


def test_importing_the_port_loads_no_jax_or_janus_tpu():
    mods = _modules()
    assert "janus_tpu_torch.vdaf.backend" in mods and "janus_tpu_torch.ops.prepare" in mods
    # the Poplar1 slice's modules
    for m in ("ops.aes", "ops.poplar1_batch", "vdaf.idpf", "vdaf.poplar1"):
        assert f"janus_tpu_torch.{m}" in mods, m
    # the service binaries, the management API, their core modules and
    # the host XOF
    for m in ("binaries.main", "binaries.config", "binaries.janus_cli", "binaries.collect", "binaries.__main__",
              "aggregator_api", "core.statusz", "core.slo", "core.otlp", "native"):
        assert f"janus_tpu_torch.{m}" in mods, m
    # canonical shape buckets
    assert "janus_tpu_torch.vdaf.canonical" in mods
    # the multi-card dry run
    assert "janus_tpu_torch.dryrun" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'janus_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "", out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_janus_tpu(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def _resolves(path: Path, node: ast.ImportFrom) -> bool:
    """Whether a relative import in ``path`` names a module or package of
    the port (``from ..x import y`` may also name a submodule ``y``)."""
    base = path.parent
    for _ in range(node.level - 1):
        base = base.parent
    if PORT not in (base, *base.parents):
        return False
    target = base.joinpath(*node.module.split(".")) if node.module else base
    if target.with_suffix(".py").is_file():
        return True
    if (target / "__init__.py").is_file():
        # ``from . import x``: each x is a module of the package or a name
        # its __init__ defines
        return node.module is not None or all(
            (target / f"{a.name}.py").is_file()
            or (target / a.name / "__init__.py").is_file()
            or a.name in (target / "__init__.py").read_text()
            for a in node.names
        )
    return False


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_every_relative_import_resolves_inside_the_port(path):
    """A relative import of a module the port lacks (``from ..vdaf.canonical
    import ...``) would fail only when its branch runs; hold every one,
    however deep in a function, to a file under janus_tpu_torch/."""
    file = ROOT / path
    for node in ast.walk(ast.parse(file.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            assert _resolves(file, node), (path, node.lineno, "." * node.level + (node.module or ""))


def test_control_plane_imports_without_aiohttp():
    """The aggregator package, the client, the collector and the in-process
    pair's modules load on a host with no aiohttp."""
    code = (
        "import sys\n"
        "sys.modules['aiohttp'] = None\n"
        "import janus_tpu_torch.aggregator, janus_tpu_torch.client, janus_tpu_torch.collector\n"
        "import janus_tpu_torch.aggregator.test_util, janus_tpu_torch.datastore.test_util\n"
        "import janus_tpu_torch.core.retries\n"
        "print('http_handlers' in ' '.join(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "False", out.stdout
