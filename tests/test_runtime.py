"""Entry-point plumbing: the compile-cache rule, the GPU-only smoke, and
the absence of any platform branch or kernel-choosing option."""

import glob
import os
import re
import shutil
import subprocess
import sys

import jax
import pytest

from tpu_mf import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert runtime.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cli_sets_compile_cache_before_loading(monkeypatch):
    from tpu_mf import cli

    calls = []
    monkeypatch.setattr(runtime, "enable_compile_cache",
                        lambda: calls.append(1))
    with pytest.raises(FileNotFoundError):
        cli.main(["--alg", "mf", "--train", "/nonexistent/train.pb"])
    assert calls == [1]


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "tpu_mf", "**", "*.py"),
                       recursive=True)
) + ["bench.py", "chip_smoke.py", "__graft_entry__.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_no_platform_branch_or_removed_kernel(path):
    """Nothing imports the removed Mosaic Pallas kernels' library, runs a
    kernel interpreted, branches on the backend, or keeps their options."""
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    for pattern in (r"pallas\.t[p]u\b", r"\bplt[p]u\b", r"default_backend\(",
                    r"\binterpret=", r"use_pallas", r"use_dense",
                    r"no-pallas", r"no-dense"):
        assert not re.search(pattern, text), f"{path} matches {pattern!r}"


@pytest.fixture
def gpu_machine():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi not found)")


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_machine):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')


def test_bench_trace_reduction(tmp_path, monkeypatch):
    """Busy time is the union of kernel intervals on GPU stream lines;
    host planes and non-stream lines do not count."""
    from types import SimpleNamespace as NS

    import bench

    def ev(name, start, dur):
        return NS(name=name, start_ns=start, duration_ns=dur)

    planes = [
        NS(name="/host:CPU", lines=[NS(name="python", events=[ev("x", 0, 10**9)])]),
        NS(name="/device:GPU:0", lines=[
            NS(name="Stream #13(Compute)", events=[
                ev("scatter", 0, 40), ev("copy", 30, 20),   # overlap: busy 50
                ev("scatter", 80, 20),                     # gap 30, busy 20
            ]),
            NS(name="XLA Modules", events=[ev("jit_epoch", 0, 100)]),
        ]),
    ]
    (tmp_path / "plugins").mkdir()
    (tmp_path / "plugins" / "t.xplane.pb").write_bytes(b"")
    monkeypatch.setattr(jax.profiler.ProfileData, "from_file",
                        staticmethod(lambda p: NS(planes=planes)))
    out = bench.reduce_trace(str(tmp_path))
    assert out["busy_ms"] == pytest.approx(70e-6)
    assert out["window_ms"] == pytest.approx(100e-6)
    assert out["idle_share"] == pytest.approx(0.3)
    assert out["top_ops"][0][0] == "scatter"
    assert out["top_ops"][0][2] == pytest.approx(60 / 80)
