"""The port's kernel library interface, checked without a compiler.

Every launcher that ``_native`` binds with ctypes is defined in ``csrc/``
with the number of arguments ``_SIGNATURES`` declares (ctypes cannot see a
mismatch; it would only show as a wrong result on the card), every
launcher defined there is bound, two threads of one process build and load
the library once, and every module of the port (and ``chip_smoke.py``)
imports without JAX, down to the imports inside its functions.
"""

import ast
import re
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from sph_pie_torch import _native

ROOT = Path(__file__).resolve().parents[1]


def _launchers() -> dict[str, int]:
    """{name: argument count} of the extern "C" launchers in csrc/."""
    found = {}
    for src in _native._sources():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = len(m.group(2).split(","))
    return found


@pytest.mark.parametrize("name", sorted(_native._SIGNATURES))
def test_launcher_is_defined_with_its_argument_count(name):
    assert _launchers().get(name) == len(_native._SIGNATURES[name])


def test_every_launcher_is_bound():
    assert set(_launchers()) == set(_native._SIGNATURES)


def test_float64_launch_of_a_float32_kernel_raises():
    with pytest.raises(TypeError, match="no CUDA kernel"):
        _native.launch("forces_mma", torch.float64)


# A stand-in for nvcc: writes its -o file; a compile (-c) also marks that it
# started and waits until every source's compile has, so it fails unless all
# compiles run at once. FAIL_SRC names a source whose compile fails.
FAKE_NVCC = """\
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = os.path.basename(args[-1])
    open(out + ".started", "w").close()
    if src == os.environ.get("FAIL_SRC"):
        print("error in " + src)
        sys.exit(2)
    deadline = time.time() + 60
    while len([f for f in os.listdir(os.path.dirname(out)) if f.endswith(".started")]) < int(os.environ["N_SRC"]):
        if time.time() > deadline:
            sys.exit(3)
        time.sleep(0.05)
    print("ptxas info    : " + src)
open(out, "w").write("built")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    script.chmod(0o755)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    n_src = len([s for s in _native._sources() if s.suffix == ".cu"])
    monkeypatch.setenv("N_SRC", str(n_src))
    return str(script), n_src


def test_build_compiles_every_source_at_once_then_links(fake_nvcc):
    nvcc, n_src = fake_nvcc
    out = _native.build(nvcc)
    assert out == _native.library_path() and out.read_text() == "built"
    log = out.with_suffix(".log").read_text()
    assert log.count("ptxas info") == n_src > 1
    assert not list(out.parent.glob("*.o"))
    assert _native.build(nvcc) == out  # built once: the second call loads it


def test_build_raises_with_the_failing_compile_and_leaves_no_library(fake_nvcc, monkeypatch):
    nvcc, _ = fake_nvcc
    monkeypatch.setenv("FAIL_SRC", "forces_mma.cu")
    with pytest.raises(RuntimeError, match="(?s)code 2.*forces_mma.cu.*error in forces_mma.cu"):
        _native.build(nvcc)
    assert not _native.library_path().exists()
    assert not list(_native.BUILD_DIR.glob("*.o"))


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys, sph_pie_torch\n"
        "for m in pkgutil.walk_packages(sph_pie_torch.__path__, 'sph_pie_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'sph_pie_torch.micro.forces_mma' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sph_pie_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def _at_once(fn, n: int = 2) -> list:
    """``fn()`` in ``n`` threads released together; their results."""
    barrier, out = threading.Barrier(n), [None] * n

    def run(i):
        barrier.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def test_two_threads_build_once(fake_nvcc):
    """Two threads of one process call ``build`` at once (a service's run
    worker and a preview request making the first launch): each source
    compiles once, both get the one library, and no object is left."""
    nvcc, n_src = fake_nvcc
    first, second = _at_once(lambda: _native.build(nvcc))
    assert first == second == _native.library_path() and first.read_text() == "built"
    assert len(list(_native.BUILD_DIR.glob("*.started"))) == n_src
    assert first.with_suffix(".log").read_text().count("ptxas info") == n_src
    assert not list(_native.BUILD_DIR.glob("*.o")) and not list(_native.BUILD_DIR.glob("*.tmp"))


def test_two_threads_load_one_library(fake_nvcc, monkeypatch):
    """``library()`` from two threads at once: one build, one load, one
    object for both."""
    nvcc, _ = fake_nvcc
    loads = []

    class Lib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(_native.ctypes, "CDLL", Lib)
    first, second = _at_once(_native.library)
    assert first is second and loads == [str(_native.library_path())]
    assert first.sph_density_f32.argtypes == _native._SIGNATURES["sph_density_f32"]


FORBIDDEN = ("jax", "jaxlib", "sph_pie_tpu")


def _imports(path: Path) -> list[tuple[int, str]]:
    """(line, module) of every import in ``path``: statements at any depth
    (inside functions too) and ``__import__`` / ``import_module`` calls on a
    literal name."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            name = getattr(node.func, "id", getattr(node.func, "attr", ""))
            if name in ("__import__", "import_module") and isinstance(node.args[0].value, str):
                found.append((node.lineno, node.args[0].value))
    return found


PORT_FILES = sorted((ROOT / "sph_pie_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_jax_or_the_jax_package(path):
    bad = [(line, m) for line, m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_import_scan_sees_imports_inside_functions(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\n"
        "def f():\n"
        "    from sph_pie_tpu.service import api\n"
        "    import jax.numpy as jnp\n"
        "    return __import__('jaxlib')\n"
    )
    assert [m for _, m in _imports(src)] == ["os", "sph_pie_tpu.service", "jax.numpy", "jaxlib"]
