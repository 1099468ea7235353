"""Port parity: saddle_point_petsc_tpu_torch.cli (-device cpu) against the
JAX package's cli, plus the port's viewers and its import boundary.

Tolerances:
- the summary text up to `rnorm=` and the -ksp_converged_reason line are
  identical;
- rnorm to 1e-9 of the initial residual norm: the 9x9 saddle run stops in
  a MINRES plateau where a one-ulp change of f moves the JAX package's
  own final rnorm by ~3% (see tests/test_torch_saddle.py);
- test.vtk: header, POINTS and POLYGONS bytes identical; data values to
  1e-8 * max|value|, covering the 9-digit print (5e-10 relative) and the
  reference's own 1e-9 sensitivity of u to a one-ulp change of f.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from saddle_point_petsc_tpu import cli as jcli
from saddle_point_petsc_tpu.models import poisson as jpoisson
from saddle_point_petsc_tpu.utils.viewers import view_from_options as jview
from saddle_point_petsc_tpu_torch import cli as tcli
from saddle_point_petsc_tpu_torch.models import poisson as tpoisson
from saddle_point_petsc_tpu_torch.ops.stencil import StencilOperator
from saddle_point_petsc_tpu_torch.solvers import precond as tpc
from saddle_point_petsc_tpu_torch.utils import vtk as tvtk
from saddle_point_petsc_tpu_torch.utils.options import Options
from saddle_point_petsc_tpu_torch.utils.viewers import view_from_options as tview

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SUMMARY = re.compile(r"^(\w+: grid .*), rnorm=(\S+)$", re.M)
REASON = re.compile(r"^Linear solve .*$", re.M)


def _jax_draw(template, generator):
    """The JAX package's estimate_lmax start vector (PRNGKey(0))."""
    import jax
    import jax.numpy as jnp

    def draw(a):
        v = jax.random.normal(jax.random.PRNGKey(0), tuple(a.shape), jnp.float64)
        return torch.tensor(np.asarray(v), dtype=a.dtype)

    return tuple(draw(a) for a in template) if isinstance(template, tuple) else draw(template)


def _vtk_parts(path):
    """(geometry lines, keyword lines of the data part, its numbers)."""
    lines = path.read_text().split("\n")
    head = lines.index("POINT_DATA " + lines[4].split()[1])
    data = lines[head:]
    words = [ln for ln in data if ln[:1].isalpha()]
    nums = [float(v) for ln in data if not ln[:1].isalpha() for v in ln.split()]
    return lines[:head], words, np.array(nums)


_G17 = ["-da_grid_x", "17", "-da_grid_y", "17"]
_CG = ["-ksp_type", "cg", "-ksp_rtol", "1e-8"]


@pytest.mark.parametrize(
    "args",
    [
        ["-da_grid_x", "9", "-da_grid_y", "9", "-problem_type", "saddle",
         "-body_force", "trig", "-ksp_rtol", "1e-8"],
        [],  # the default route: 4x4 nodes, Poisson, GMRES + Jacobi
        _G17 + ["-mat_type", "aij", "-pc_type", "jacobi"] + _CG,
        _G17 + ["-mat_type", "dia", "-pc_type", "jacobi"] + _CG,
        _G17 + ["-mat_type", "bdia", "-pc_type", "jacobi"] + _CG,
        _G17 + ["-mat_type", "dia", "-pc_type", "gamg"] + _CG,
        _G17 + ["-mat_type", "aij", "-pc_type", "gamg"],  # GMRES + gamg
        _G17 + ["-pc_type", "gamg"] + _CG,  # gamg from the stencil operator
        _G17 + ["-problem_type", "saddle", "-body_force", "trig",
                "-fieldsplit_inner_pc_type", "gamg", "-ksp_rtol", "1e-8"],
        _G17 + ["-pc_type", "mg"] + _CG,  # the JAX README's first quick-start line
        _G17 + ["-pc_type", "mg", "-pc_mg_smoother", "chebyshev", "-pc_mg_cycles", "2"] + _CG,
        _G17 + ["-ksp_type", "bcgs", "-pc_type", "sor", "-pc_sor_omega", "1.2", "-ksp_rtol", "1e-8"],
        _G17 + ["-ksp_type", "richardson", "-pc_type", "mg", "-ksp_max_it", "20"],
        _G17 + ["-ksp_type", "chebyshev", "-pc_type", "pbjacobi", "-ksp_rtol", "1e-8"],
        _G17 + ["-pc_type", "fieldsplit", "-pc_fieldsplit_type", "multiplicative", "-ksp_rtol", "1e-8"],
        _G17 + ["-pc_type", "chebyshev", "-pc_chebyshev_esteig"] + _CG,
        _G17 + ["-pc_type", "bjacobi", "-pc_bjacobi_blocks", "3"] + _CG,
        _G17 + ["-problem_type", "saddle", "-body_force", "trig", "-ksp_type", "fgmres",
                "-pc_type", "fieldsplit", "-pc_fieldsplit_schur_fact_type", "full",
                "-fieldsplit_inner_pc_type", "mg", "-pc_mg_smoother", "chebyshev", "-ksp_rtol", "1e-8"],
        _G17 + ["-problem_type", "saddle", "-body_force", "trig", "-ksp_type", "fgmres",
                "-pc_type", "fieldsplit", "-fieldsplit_inner_ksp_type", "cg",
                "-fieldsplit_inner_pc_type", "mg", "-ksp_rtol", "1e-8"],
        ["-da_grid_x", "17", "-da_grid_y", "13", "-problem_type", "saddle", "-body_force", "trig",
         "-ksp_type", "minres", "-fieldsplit_inner_pc_type", "bjacobi", "-ksp_rtol", "1e-8"],
    ],
    ids=["saddle9", "default", "aij17", "dia17", "bdia17", "dia17-gamg",
         "aij17-gmres-gamg", "stencil17-gamg", "saddle17-gamg", "mg17", "mg17-chebyshev-w",
         "bcgs17-sor", "richardson17-mg", "chebyshev17-pbjacobi", "fieldsplit17-mult",
         "chebyshev-pc17-esteig", "bjacobi17", "saddle17-fgmres-mg", "saddle17-inner-cg-mg",
         "saddle17x13-minres-bjacobi"],
)
def test_cli_matches_jax(tmp_path, capsys, monkeypatch, args):
    # estimate_lmax (the chebyshev smoother, -pc_chebyshev_esteig, the
    # chebyshev KSP) starts from the JAX package's draw
    monkeypatch.setattr(tpc, "_start_vector", _jax_draw)
    args = args + ["-ksp_converged_reason"]
    jpath, tpath = tmp_path / "jax.vtk", tmp_path / "torch.vtk"
    assert jcli.main(args + ["-vtk", str(jpath)]) == 0
    out_j = capsys.readouterr().out
    run = tcli.run(args + ["-device", "cpu", "-vtk", str(tpath)])
    out_t = capsys.readouterr().out
    assert run.rc == 0

    [(sum_j, rn_j)], [(sum_t, rn_t)] = SUMMARY.findall(out_j), SUMMARY.findall(out_t)
    assert sum_t == sum_j
    assert abs(float(rn_t) - float(rn_j)) <= 1e-9 * run.result.rnorm0
    assert REASON.findall(out_t) == REASON.findall(out_j)

    geo_j, words_j, vj = _vtk_parts(jpath)
    geo_t, words_t, vt = _vtk_parts(tpath)
    assert geo_t == geo_j  # header, POINTS, POLYGONS
    assert words_t == words_j and vt.shape == vj.shape
    assert np.max(np.abs(vt - vj)) <= 1e-8 * max(np.max(np.abs(vj)), 1e-300)


def test_vtk_roundtrip(tmp_path):
    prob = tpoisson.assemble_poisson(3, 3, device="cpu")
    u = torch.arange(32, dtype=torch.float64).reshape(2, 4, 4)
    path = tmp_path / "out.vtk"
    tvtk.write_vtk(path, prob.coords, u)
    pts, polys, uu = tvtk.read_vtk_points(path)
    assert pts.shape == (16, 3) and polys.shape == (9, 4)
    np.testing.assert_allclose(pts[:, :2], prob.coords.numpy().reshape(-1, 2))
    np.testing.assert_allclose(uu[:, :2], u.permute(1, 2, 0).reshape(-1, 2).numpy())


def test_port_never_imports_jax(tmp_path):
    """Importing every module of the port and running its CLI on the CPU
    (the saddle route, and -mat_type dia with gamg) leaves jax and every
    module of the JAX package out of the process."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import saddle_point_petsc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from saddle_point_petsc_tpu_torch import cli\n"
        "rc = cli.main(['-device', 'cpu', '-problem_type', 'saddle', '-body_force', 'trig',\n"
        "               '-da_grid_x', '6', '-da_grid_y', '5', '-ksp_converged_reason'])\n"
        "assert rc == 0, rc\n"
        "rc = cli.main(['-device', 'cpu', '-mat_type', 'dia', '-pc_type', 'gamg', '-ksp_type', 'cg',\n"
        "               '-da_grid_x', '21', '-da_grid_y', '19', '-ksp_converged_reason',\n"
        "               '-vtk', 'dia.vtk'])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules\n"
        "             if m == 'saddle_point_petsc_tpu' or m.startswith('saddle_point_petsc_tpu.'))\n"
        "assert not ref, ref\n"
        "print('no jax')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("reason=CONVERGED_RTOL") == 2 and "no jax" in proc.stdout
    assert "pc=gamg" in proc.stdout
    assert (tmp_path / "test.vtk").exists() and (tmp_path / "dia.vtk").exists()


@pytest.mark.parametrize("argv", [["-device", "cuda"], []], ids=["explicit", "default"])
def test_device_cuda_without_card_raises(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv + ["-no_vtk"])


@pytest.mark.parametrize(
    "extra",
    [
        ["-dist"],
        ["-mesh", "2,2"],
        ["-mat_type", "aij", "-dist"],
    ],
)
def test_later_slices_raise_not_implemented(capsys, extra):
    """-dist runs, in a world of one (gloo, an in-process store, destroyed
    at the end), and -mesh alone is not read (as in the JAX CLI): both give
    the serial route's its= line and solution bits. MATMPIAIJ (-mat_type
    aij -dist, a DistAIJ) runs too and gives the serial -mat_type aij
    route's its= line."""
    import torch.distributed as dist

    argv = ["-device", "cpu", "-no_vtk"] + extra
    run = tcli.run(argv)
    its = ITS.findall(capsys.readouterr().out)
    serial = tcli.run(["-device", "cpu", "-no_vtk"] + [t for t in extra if t not in ("-dist", "-mesh", "2,2")])
    assert run.rc == 0 and len(its) == 1 and its == ITS.findall(capsys.readouterr().out)
    if "aij" in extra:
        assert type(run.problem.A).__name__ == "DistAIJ"
        torch.testing.assert_close(run.result.x[: serial.result.x.shape[0]], serial.result.x, rtol=0, atol=1e-12)
    else:
        assert torch.equal(run.result.x, serial.result.x)
    assert not dist.is_initialized()


ITS = re.compile(r"its=\d+, reason=\w+")


@pytest.mark.parametrize(
    "extra",
    [
        ["-mat_type", "aij", "-pc_type", "ilu"],
        ["-profile", "{tmp}"],
        ["-pc_type", "ilu"],
        ["-mat_type", "dia", "-pc_type", "ilu"],
        ["-problem_type", "saddle", "-fieldsplit_inner_pc_type", "ilu"],
        ["-use_cpu"],
        ["-mat_type", "aij", "-pc_type", "ilu", "-pc_ilu_sweeps", "0", "-ksp_type", "cg"],
        ["-pc_type", "ilu", "-pc_ilu_sweeps", "0", "-ksp_type", "cg"],
    ],
    ids=["aij-ilu", "profile", "stencil-ilu", "dia-ilu-raises", "saddle-inner-ilu", "use_cpu",
         "aij-ilu-exact", "stencil-ilu-no-sweeps"],
)
def test_ilu_profile_use_cpu_match_jax(tmp_path, capsys, extra):
    """The CLI routes that raised before ILU(0), -profile and -use_cpu were
    ported, on the default 4x4-node grid: the its= line equals the JAX
    CLI's, -mat_type dia -pc_type ilu raises ValueError in both, -profile
    writes a trace and changes no result, and -use_cpu runs on the CPU in
    f64 as the JAX CLI picks."""
    extra = [a.replace("{tmp}", str(tmp_path / "trace")) for a in extra]
    device = [] if extra == ["-use_cpu"] else ["-device", "cpu"]
    argv = ["-no_vtk", "-ksp_converged_reason"] + device + extra
    if "dia" in extra:
        for main in (jcli.main, tcli.main):
            with pytest.raises(ValueError, match="ilu PC requires stencil or CSR operator"):
                main(argv)
        return
    assert jcli.main(argv) == 0
    its_j = ITS.findall(capsys.readouterr().out)
    run = tcli.run(argv)
    its_t = ITS.findall(capsys.readouterr().out)
    assert run.rc == 0 and its_t == its_j and len(its_t) == 1
    x = run.result.x[0] if isinstance(run.result.x, tuple) else run.result.x
    assert x.device.type == "cpu" and x.dtype == torch.float64
    if "-profile" in extra:
        assert (tmp_path / "trace" / "kspsolve.pt.trace.json").stat().st_size > 0
        plain = tcli.run(argv[:-2])
        assert ITS.findall(capsys.readouterr().out) == its_t
        assert torch.equal(plain.result.x, run.result.x)


@pytest.mark.parametrize(
    "flag,route",
    [
        ("mat_stencil_backend", []),
        ("mat_dia_backend", ["-mat_type", "dia"]),
        ("mat_bdia_backend", ["-mat_type", "bdia"]),
    ],
)
def test_unread_backend_flag_is_reported(capsys, flag, route):
    """The port has no backend switch (a tensor's device picks plain
    version or kernel), so -options_left reports the JAX CLI's flag."""
    assert tcli.main(
        ["-device", "cpu", "-no_vtk", f"-{flag}", "pallas", "-options_left"] + route
    ) == 0
    assert f"unused option: -{flag}" in capsys.readouterr().err


def test_viewers_match_jax(tmp_path, capsys):
    jp = jpoisson.assemble_poisson(2, 2)
    tp = tpoisson.assemble_poisson(2, 2, device="cpu")
    for view, A, name in ((jview, jp.A, "j.npz"), (tview, tp.A, "t.npz")):
        assert view(A, Options(["-A_mat_view", f"{tmp_path / name}:npz"]), "A_mat_view", "A")
    np.testing.assert_allclose(
        np.load(tmp_path / "t.npz")["A"], np.load(tmp_path / "j.npz")["A"], rtol=1e-13, atol=1e-15
    )
    assert tview(tp.f, Options(["-f_vec_view"]), "f_vec_view", "f")
    assert "f =" in capsys.readouterr().out
    assert not tview(tp.f, Options(), "not_set")


@pytest.mark.parametrize("mat_type", ["aij", "dia", "bdia"])
def test_mat_view_of_sparse_routes_matches_jax_csr(tmp_path, mat_type):
    """-A_mat_view on the -mat_type routes dumps the operator the JAX CLI
    dumps for -mat_type aij (its dense CSR view)."""
    args = ["-da_grid_x", "5", "-da_grid_y", "4", "-no_vtk"]
    jnpz, tnpz = tmp_path / "j.npz", tmp_path / "t.npz"
    assert jcli.main(args + ["-mat_type", "aij", "-A_mat_view", f"{jnpz}:npz"]) == 0
    run = tcli.run(args + ["-device", "cpu", "-mat_type", mat_type, "-A_mat_view", f"{tnpz}:npz"])
    assert run.rc == 0
    np.testing.assert_allclose(
        np.load(tnpz)["A"], np.load(jnpz)["A"], rtol=1e-13, atol=1e-15
    )


def test_viewer_large_sparse_no_densify(tmp_path, capsys):
    """Above DENSE_LIMIT rows -A_mat_view dumps COO triplets, and they
    reproduce the operator's matvec."""
    import scipy.sparse as sps

    prob = tpoisson.assemble_poisson(127, 127, device="cpu")  # 128^2 * 2 = 32768 rows
    assert tview(prob.A, Options(["-A_mat_view"]), "A_mat_view", "A")
    assert "sparse 32768x32768" in capsys.readouterr().out
    npz = tmp_path / "a.npz"
    assert tview(prob.A, Options(["-A_mat_view", f"{npz}:npz"]), "A_mat_view", "A")
    d = np.load(npz)
    a = sps.coo_matrix((d["A_data"], (d["A_row"], d["A_col"])), shape=tuple(d["A_shape"])).tocsr()
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    y = StencilOperator(prob.A.planes).matvec(torch.tensor(x)).numpy()
    np.testing.assert_allclose(a @ x, y, rtol=1e-10, atol=1e-12)


def test_monitor_lines_match_jax(capsys):
    """-ksp_monitor prints PETSc's line format; the iteration numbers match
    the JAX CLI's and the first residual norm to 1e-12 relative (later
    entries are at roundoff on this 2-iteration solve)."""
    assert jcli.main(["-ksp_monitor", "-no_vtk"]) == 0
    out_j = capsys.readouterr().out
    assert tcli.main(["-device", "cpu", "-ksp_monitor", "-no_vtk"]) == 0
    out_t = capsys.readouterr().out
    line = re.compile(r"^ *(\d+) KSP Residual norm (\S+)$", re.M)
    mj, mt = line.findall(out_j), line.findall(out_t)
    assert [i for i, _ in mt] == [i for i, _ in mj] and len(mt) >= 2
    assert abs(float(mt[0][1]) - float(mj[0][1])) <= 1e-12 * float(mj[0][1])
