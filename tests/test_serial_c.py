"""Native C serial backend tests: exact parity with the Python oracle and
the reference tolerance contract vs the device path."""

import shutil
import subprocess

import numpy as np
import pytest

from navierstokes_parallel_tpu.config import Params
from navierstokes_parallel_tpu import oracle

pytestmark = pytest.mark.skipif(shutil.which("make") is None,
                                reason="no make/cc toolchain")


def _params(**kw):
    defaults = dict(i_max=24, j_max=24, T=0.05, Re=100.0, tau=0.5,
                    epsilon=1e-4, max_it=500, dtype="float64")
    defaults.update(kw)
    return Params(**defaults)


@pytest.fixture(scope="module")
def serial_c():
    from navierstokes_parallel_tpu.backends import serial_c as mod
    mod.build()
    return mod


def test_c_matches_python_oracle(serial_c):
    prm = _params()
    res_c = serial_c.solve(prm)
    res_py = oracle.oracle_solve(prm)
    assert res_c.steps == res_py.steps
    assert res_c.total_sor_iterations == res_py.total_sor_iterations
    np.testing.assert_allclose(res_c.u, res_py.u, atol=1e-13)
    np.testing.assert_allclose(res_c.v, res_py.v, atol=1e-13)
    np.testing.assert_allclose(res_c.p, res_py.p, atol=1e-12)


def test_c_oscillating_lid(serial_c):
    prm = _params(problem=2, f=10.0)
    res_c = serial_c.solve(prm)
    res_py = oracle.oracle_solve(prm)
    assert res_c.steps == res_py.steps
    np.testing.assert_allclose(res_c.u, res_py.u, atol=1e-13)


def test_c_vs_jnp_contract(serial_c):
    from navierstokes_parallel_tpu import solve
    from conftest import assert_close_reference_contract

    prm = _params()
    res_c = serial_c.solve(prm)
    state, stats = solve(prm)
    assert int(stats.steps) == res_c.steps
    assert_close_reference_contract(np.asarray(state.u), res_c.u, tol=1e-4)
    assert_close_reference_contract(np.asarray(state.v), res_c.v, tol=1e-4)


def test_c_executable_protocol(serial_c, tmp_path):
    """The standalone binary speaks the reference stdout/stderr protocol."""
    cfg = tmp_path / "c.in"
    _params(i_max=16, j_max=16, T=0.02).to_file(str(cfg))
    proc = subprocess.run([serial_c.executable_path(), str(cfg)],
                          capture_output=True, text=True)
    assert proc.returncode == 0
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("U-CENTER: ")
    assert lines[1].startswith("V-CENTER: ")
    float(proc.stderr.strip())  # single scrapeable float


def test_c_sor_direct(serial_c):
    """nsp_sor on a manufactured system matches the Python oracle's SOR."""
    n = 24
    prm = _params(i_max=n, j_max=n, epsilon=1e-6, max_it=20000)
    rng = np.random.default_rng(1)
    rhs = np.zeros((n + 2, n + 2))
    ri = rng.standard_normal((n, n))
    ri -= ri.mean()
    rhs[1:-1, 1:-1] = ri

    p_py = np.zeros((n + 2, n + 2))
    it_py, _ = oracle.sor_serial(p_py, rhs, prm)
    it_c, p_c = serial_c.sor(prm, np.zeros((n + 2, n + 2)), rhs)
    assert it_c == it_py
    np.testing.assert_allclose(p_c, p_py, atol=1e-12)
