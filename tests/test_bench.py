"""bench.py argument handling: the sharded/gspmd arms must HONOR --method
(a `--backend sharded --method mg` benchmark used to
silently measure rb_sor), and the ensemble arm must report the batching
speedup.  Runs on tiny grids on the CPU mesh; numbers are not asserted,
behavior is."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.fixture
def tiny_config(tmp_path):
    path = tmp_path / "tiny.in"
    path.write_text(
        "1\n1\n16\n16\n1.0\n1.0\n0.01\n100.0\n0.0\n0.0\n1.0\n1.7\n"
        "0.0001\n2000\n1\n"
    )
    return str(path)


def _run(argv, capsys):
    rc = bench.main(argv)
    out = capsys.readouterr()
    assert rc == 0
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_sharded_arm_honors_method(tiny_config, capsys):
    """--backend sharded --method mg must actually run multigrid: the
    stderr names the solver AND the iteration count collapses (~100x fewer
    than rb_sor sweeps on the same workload)."""
    res_mg, err_mg = _run(
        ["--config", tiny_config, "--backend", "sharded", "--method", "mg"],
        capsys)
    assert "pressure solver: mg (sharded)" in err_mg
    res_rb, err_rb = _run(
        ["--config", tiny_config, "--backend", "sharded",
         "--method", "rb_sor"], capsys)
    assert "pressure solver: rb_sor (sharded)" in err_rb

    def iters(err):
        for tok in err.split():
            if tok.startswith("sor_iterations="):
                return int(tok.split("=")[1])
        raise AssertionError(f"no sor_iterations in {err!r}")

    assert iters(err_mg) * 10 < iters(err_rb), (
        f"mg ran {iters(err_mg)} iterations vs rb_sor {iters(err_rb)} — "
        "the sharded arm is not honoring --method")


def test_gspmd_arm_honors_method(tiny_config, capsys):
    res, err = _run(
        ["--config", tiny_config, "--backend", "gspmd", "--method", "mg"],
        capsys)
    assert "pressure solver: mg (gspmd)" in err


def test_ensemble_arm(tiny_config, capsys):
    res, err = _run(["--config", tiny_config, "--ensemble", "2"], capsys)
    assert "ensemble2" in res["metric"]
    assert res["unit"] == "s"
    assert res["vs_baseline"] is not None


def test_sharded_arm_runs_fft(tiny_config, capsys):
    """--backend sharded --method fft runs the pencil-decomposed spectral
    solve: the stderr names it and the iteration count is direct-solve
    scale (a few per step), not sweep scale."""
    res, err = _run(
        ["--config", tiny_config, "--backend", "sharded", "--method", "fft"],
        capsys)
    assert "pressure solver: fft (sharded)" in err
    for tok in err.split():
        if tok.startswith("sor_iterations="):
            iters = int(tok.split("=")[1])
            break
    else:
        raise AssertionError(f"no sor_iterations in {err!r}")
    for tok in err.split():
        if tok.startswith("steps="):
            steps = int(tok.split("=")[1])
            break
    assert iters <= 8 * steps, f"{iters} solves over {steps} steps"


def test_bench_invalid_knobs_get_clean_errors(tiny_config, capsys):
    """Out-of-range --fft-solves / malformed --mesh must exit through
    argparse (usage + exit code 2), not an uncaught Params/mesh traceback."""
    for argv in (["--config", tiny_config, "--fft-solves", "9"],
                 ["--config", tiny_config, "--backend", "sharded",
                  "--mesh", "0x2"],
                 ["--config", tiny_config, "--backend", "sharded",
                  "--mesh", "2x3x4"]):
        with pytest.raises(SystemExit) as exc:
            bench.main(argv)
        assert exc.value.code == 2
        capsys.readouterr()


@pytest.fixture
def tiny_thermal_config(tmp_path):
    path = tmp_path / "thermal.in"
    path.write_text(
        "5\n1\n16\n16\n1.0\n1.0\n0.05\n37.5\n0.0\n0.0\n0.5\n1.7\n"
        "0.0001\n2000\n1\n1000.0\n0.71\n"
    )
    return str(path)


def test_thermal_arm_fence_mode_and_ab2_guard(tiny_thermal_config, capsys):
    """The problem-5 arm times each run to its end (seconds= on stderr,
    like every other arm) and mirrors cli.py's gate: --time-order 2 is
    single-chip only — a sharded/gspmd AB2 'benchmark' would silently
    measure Euler."""
    res, err = _run(["--config", tiny_thermal_config], capsys)
    assert "convection16" in res["metric"]
    assert f"seconds={res['value']:.6f}" in err
    res, err = _run(["--config", tiny_thermal_config, "--time-order", "2"],
                    capsys)
    assert "(thermal, AB2)" in err
    for backend in ("sharded", "gspmd"):
        rc = bench.main(["--config", tiny_thermal_config, "--backend",
                         backend, "--time-order", "2"])
        assert rc == 2
        assert "single-chip" in capsys.readouterr().err
