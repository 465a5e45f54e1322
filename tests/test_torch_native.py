"""The port's kernel library interface, checked without a compiler.

Every launcher that ``_native`` binds with ctypes is defined in ``csrc/``
with the number of arguments ``_SIGNATURES`` declares (ctypes cannot see a
mismatch; it would only show as a wrong result on the card), every
launcher defined there is bound, and every module of the port imports
without JAX.
"""

import re
import subprocess
import sys
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
