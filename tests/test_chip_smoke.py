"""chip_smoke.py off the GPU: its compile-cache rule, its refusal to run
without a GPU, and the exact shape of its last line."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from pyipm_jax.utils import compile_cache  # noqa: E402


@pytest.mark.parametrize("env_dir", [None, "/cache/from/env"])
def test_cache_dir_rule(monkeypatch, env_dir):
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV, raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        monkeypatch.setenv(compile_cache.ENV, env_dir)
        want = env_dir
    assert compile_cache.cache_dir(chip_smoke.ROOT) == want


def test_cache_enable_sets_no_dir_when_env_is_set(monkeypatch):
    """With the variable set, enable() leaves JAX's own setting alone."""
    import jax

    monkeypatch.setenv(compile_cache.ENV, "/cache/from/env")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable(REPO) == "/cache/from/env"
    assert jax.config.jax_compilation_cache_dir == before


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=REPO)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok"' not in lines[-1]
    assert "no GPU" in out.stderr


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


class _Jax:
    @staticmethod
    def devices():
        return [_Dev()] * 4


def test_last_line_shape():
    line = chip_smoke.last_line(_Jax)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
