"""Runtime set-up: where the compile cache lives, how the native CABAC
library is built, and that the on-chip smoke test refuses a CPU."""

import ctypes
import os
import subprocess
import sys

import pytest

import kvazaar_jax
from kvazaar_jax.bitstream import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ("/some/cache", "/some/cache"),
    (None, os.path.join(ROOT, ".jax_cache")),
    ("", None),
])
def test_compile_cache_dir(monkeypatch, env, want):
    """The variable, when set, is the only cache directory and an empty
    value disables the cache; unset, the cache sits in the checkout."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert kvazaar_jax.compile_cache_dir() == want
    if env == "":
        import jax
        before = jax.config.jax_compilation_cache_dir
        kvazaar_jax.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == before


_SRC = 'extern "C" int kvz_probe() { return %d; }\n'


def _write(path, version):
    with open(path, "w") as f:
        f.write(_SRC % version)


def test_native_lib_path_keyed_by_source_and_flags(tmp_path):
    src = tmp_path / "probe.cpp"
    _write(src, 1)
    cmd = ("g++", "-O2", "-shared", "-fPIC")
    p1 = native.lib_path(str(src), str(tmp_path), cmd)
    assert p1 == native.lib_path(str(src), str(tmp_path), cmd)
    assert p1 != native.lib_path(str(src), str(tmp_path),
                                 cmd[:1] + ("-O3",) + cmd[2:])
    _write(src, 2)
    assert p1 != native.lib_path(str(src), str(tmp_path), cmd)
    # The production library's key covers its real source and flags.
    assert os.path.basename(native.lib_path()).startswith(
        "libhevc_cabac-")


def test_native_rebuilds_after_source_change(tmp_path):
    src = tmp_path / "probe.cpp"
    cmd = ("g++", "-O1", "-shared", "-fPIC")
    versions = []
    for v in (1, 2):
        _write(src, v)
        lib = native.build(str(src), str(tmp_path / "build"), cmd)
        versions.append(ctypes.CDLL(lib).kvz_probe())
    assert versions == [1, 2]
    assert len(os.listdir(tmp_path / "build")) == 2


def test_native_failed_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native CABAC build failed"):
        native.build(str(src), str(tmp_path / "build"),
                     ("g++", "-shared", "-fPIC"))
    assert not (tmp_path / "build").exists() or \
        not any(p.endswith(".so") for p in os.listdir(tmp_path / "build"))


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr
