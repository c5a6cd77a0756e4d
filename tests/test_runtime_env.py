"""Running environment: compile-cache placement, the native library's
build and failure reporting, and which backend / engine / complex mode
the library chooses on its own."""

import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pangulu_jax import native, utils
from pangulu_jax.api import InitOptions, device_bytes_limit, init
from pangulu_jax.models import poisson2d, random_unsymmetric
from pangulu_jax.numeric import LUFactorizer
from pangulu_jax.ops.interface import get_backend

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = ("import jax; from pangulu_jax.utils import "
            "enable_compilation_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.split()


def test_compile_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    assert _cache_dir_in_fresh_process(want) == [want, want]


def test_compile_cache_default_is_fixed_in_checkout():
    got = _cache_dir_in_fresh_process(None)
    assert got == [utils.DEFAULT_CACHE_DIR] * 2
    path = pathlib.Path(utils.DEFAULT_CACHE_DIR)
    assert path == ROOT / ".jax_cache"
    # no temporary, pid or time component: identical in every process
    assert str(os.getpid()) not in path.name
    assert not str(path).startswith(("/tmp", os.environ.get("TMPDIR", "/tmp")))
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def test_native_library_builds_from_source():
    assert native.get_lib() is not None
    assert pathlib.Path(native._LIB_PATH).exists()
    assert not any(ROOT.joinpath("native").glob("*.tmp"))


def test_native_build_failure_is_a_warning(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(native, "_SRC", tmp_path)          # no source
    monkeypatch.setattr(native, "_LIB_PATH", str(tmp_path / "lib.so"))
    logger = logging.getLogger("pangulu_jax")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="pangulu_jax"):
        assert native._build() is False
    assert "native host library build failed" in caplog.text
    assert "pangulu_host.cpp" in caplog.text   # the compiler's error


@pytest.mark.parametrize("name", ["auto", "jax"])
def test_auto_backend_is_jax(name):
    assert get_backend(name).name == "jax"


@pytest.mark.parametrize("name", ["pallas", "mosaic", "cuda"])
def test_unknown_backend_raises(name):
    with pytest.raises(ValueError, match="unknown kernel backend"):
        get_backend(name)


@pytest.mark.parametrize("ordering", ["rcm", "mindeg"])
def test_dd_never_chosen_automatically(ordering):
    h = init(poisson2d(10), InitOptions(nb=16, dtype="r64",
                                        ordering=ordering))
    fac = LUFactorizer(h.blocked, h.schedule)
    assert fac.dispatch in ("fused", "segmented")


def test_complex_auto_runs_native():
    a = random_unsymmetric(40, 0.1, seed=1, dtype=np.complex128)
    h = init(a, InitOptions(nb=8, dtype="cr64"))
    assert h.complex_embed is None
    h = init(a, InitOptions(nb=8, dtype="cr64", complex_mode="embed"))
    assert h.complex_embed is not None
    with pytest.raises(ValueError):
        init(a, InitOptions(nb=8, dtype="cr64", complex_mode="mxu"))


def test_no_capacity_assumed_without_memory_stats(monkeypatch, caplog):
    # the CPU backend reports no bytes_limit: no size is assumed and the
    # tile-store warning is skipped
    monkeypatch.setattr(logging.getLogger("pangulu_jax"), "propagate", True)
    assert device_bytes_limit() is None
    with caplog.at_level(logging.WARNING, logger="pangulu_jax"):
        init(poisson2d(8), InitOptions(nb=8, dtype="r64"))
    assert "tile store" not in caplog.text


@pytest.mark.parametrize("environ,unknown", [
    ({"PANGULU_LOG": "info", "PANGULU_DIST_DD": "1"}, []),
    ({"PANGULU_BENCH_NX": "32", "HOME": "/x"}, []),
    ({"PANGULU_LOG_LEVEL": "info", "PANGULU_DIST_D": "1"},
     ["PANGULU_DIST_D", "PANGULU_LOG_LEVEL"])])
def test_unknown_settings(environ, unknown):
    from pangulu_jax.utils.log import unknown_settings

    assert unknown_settings(environ) == unknown


def test_unknown_setting_warns_at_import():
    env = dict(os.environ, PANGULU_SOLVE_GROUP="4")
    out = subprocess.run([sys.executable, "-c", "import pangulu_jax.api"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    assert "unknown environment settings PANGULU_SOLVE_GROUP" in out.stderr
