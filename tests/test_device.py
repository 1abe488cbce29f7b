"""Start-up guards: no silent CPU run, the compile cache's place, and the
entry points that refuse to run without a GPU."""

import os
import subprocess
import sys
import types

import jax
import pytest

from navierstokes_parallel_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_dir_set_is_left_to_jax(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert device.compile_cache_dir() is None


def test_jax_cache_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("env_set", [True, False])
def test_require_device_places_cache_on_gpu(monkeypatch, env_set):
    """On an accelerator the helper sets the fixed cache only when the
    environment names none."""
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.__setitem__(name, val))
    device.require_device()
    if env_set:
        assert "jax_compilation_cache_dir" not in updates
    else:
        assert updates["jax_compilation_cache_dir"] == os.path.join(
            REPO, ".jax_cache")


@pytest.mark.parametrize("platforms,ok", [
    ("cpu", True), ("cuda,cpu", True), (" CPU ", True), ("", False),
    (None, False), ("cuda", False)])
def test_require_device_refuses_silent_cpu(monkeypatch, capsys, platforms,
                                           ok):
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    if ok:
        assert device.require_device().platform == "cpu"
    else:
        with pytest.raises(SystemExit) as exc:
            device.require_device()
        assert exc.value.code == 2
        assert "no accelerator" in capsys.readouterr().err


def test_cli_refuses_silent_cpu(monkeypatch, tmp_path, capsys):
    from navierstokes_parallel_tpu import cli

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit) as exc:
        cli.main([os.path.join(REPO, "configs", "1.in")])
    assert exc.value.code == 2


def test_bench_refuses_silent_cpu(monkeypatch):
    sys.path.insert(0, REPO)
    import bench

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit) as exc:
        bench.main(["--config", os.path.join(REPO, "configs", "1.in")])
    assert exc.value.code == 2


def _small_config(tmp_path):
    from navierstokes_parallel_tpu.config import Params

    path = tmp_path / "c.in"
    Params(problem=1, i_max=16, j_max=16, T=0.01, Re=100.0, tau=0.5,
           max_it=100).to_file(str(path))
    return str(path)


def test_cli_backend_pallas_refused_on_cpu(tmp_path, capsys):
    from navierstokes_parallel_tpu import cli

    rc = cli.main([_small_config(tmp_path), "--backend", "pallas"])
    assert rc == 1
    assert "needs an NVIDIA GPU" in capsys.readouterr().err


def test_sharded_pallas_sor_refused():
    from navierstokes_parallel_tpu.config import Params
    from navierstokes_parallel_tpu.parallel import sharded
    from navierstokes_parallel_tpu.parallel.topology import make_grid_mesh

    params = Params(problem=1, i_max=16, j_max=16, dtype="float32")
    mesh = make_grid_mesh(4, 16, 16)
    with pytest.raises(ValueError, match="single-chip only"):
        sharded._check_method(params, mesh, "pallas_sor")
    with pytest.raises(ValueError, match="single-chip only"):
        sharded.solve_sharded(params, mesh=mesh, pressure_method="pallas_sor")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU, and copied into a directory without the package,
    chip_smoke.py exits non-zero and prints no result."""
    src = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        with open(src) as fh, open(tmp_path / "chip_smoke.py", "w") as out:
            out.write(fh.read())
        src = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, src], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("script", ["sor_tile_probe.py",
                                    "dct_route_probe.py"])
def test_chip_probes_fail_without_gpu(script):
    """The GPU probes exit non-zero on the CPU and time nothing."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), "--sizes",
         "16"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 2
    assert "needs a GPU" in proc.stderr
    assert "/solve" not in proc.stdout and "/sweep" not in proc.stdout


def test_dryrun_multichip_refuses_short_gpu(monkeypatch):
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft

    fake = types.SimpleNamespace(platform="gpu", id=0)
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    with pytest.raises(RuntimeError, match="needs 4 gpu devices; 1 visible"):
        graft.dryrun_multichip(4)
