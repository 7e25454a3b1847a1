"""ndtpu_torch.data.g2o and the solve_g2o CLI against the JAX package's, on
the CPU: the Manhattan-world generator (equal arrays), g2o and TORO files
written by one package and read by the other, ``to_graph`` in f64, and
``python -m ndtpu_torch.solve_g2o`` against ``python -m ndtpu.solve_g2o``
on the same arguments."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndtpu.data import g2o as jg2o
from ndtpu_torch import convert
from ndtpu_torch.data import g2o as tg2o

torch.set_num_threads(2)


@pytest.mark.parametrize("n,seed,loop_prob", [(50, 2, 0.1), (240, 3, 0.15),
                                              (600, 9, 0.3), (1000, 0, 0.1)])
def test_manhattan_world_equal_to_jax(n, seed, loop_prob):
    ref = jg2o.manhattan_world(n, seed=seed, loop_prob=loop_prob)
    got = tg2o.manhattan_world(n, seed=seed, loop_prob=loop_prob)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _data(n=80, seed=2):
    """A Manhattan graph with one edge's information made non-diagonal, so
    the six information entries' order matters."""
    data = jg2o.manhattan_world(n, seed=seed, loop_prob=0.2)
    info = data.edges_info.copy()
    info[3] = [[300.0, 12.0, -4.0], [12.0, 250.0, 7.0], [-4.0, 7.0, 9000.0]]
    return data._replace(edges_info=info)


def _assert_data_equal(a, b):
    np.testing.assert_array_equal(a.edges_ij, b.edges_ij)
    for x, y in ((a.poses, b.poses), (a.edges_z, b.edges_z),
                 (a.edges_info, b.edges_info)):
        np.testing.assert_array_equal(x, y)


def test_g2o_files_cross_read(tmp_path):
    """A file written by either package reads back equal in the other."""
    data = _data()
    jpath, tpath = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jg2o.write_g2o(jpath, data)
    tg2o.write_g2o(tpath, data)
    assert open(jpath).read() == open(tpath).read()
    _assert_data_equal(tg2o.read_g2o(jpath), jg2o.read_g2o(jpath))
    _assert_data_equal(jg2o.read_g2o(tpath), tg2o.read_g2o(tpath))
    back = tg2o.read_g2o(jpath)
    np.testing.assert_allclose(back.poses, data.poses, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(back.edges_info, data.edges_info, rtol=1e-8)


def test_toro_files_read_alike(tmp_path):
    """TORO's ``I00 I01 I11 I22 I02 I12`` order, in both readers."""
    data = _data()
    path = tmp_path / "t.graph"
    lines = [f"VERTEX2 {k} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}"
             for k, p in enumerate(data.poses)]
    for (i, j), z, m in zip(data.edges_ij, data.edges_z, data.edges_info):
        u = [m[0, 0], m[0, 1], m[1, 1], m[2, 2], m[0, 2], m[1, 2]]
        lines.append(f"EDGE2 {i} {j} {z[0]:.9g} {z[1]:.9g} {z[2]:.9g} "
                     + " ".join(f"{x:.9g}" for x in u))
    path.write_text("\n".join(lines) + "\n")
    got, ref = tg2o.read_toro(str(path)), jg2o.read_toro(str(path))
    _assert_data_equal(got, ref)
    np.testing.assert_allclose(got.edges_info, data.edges_info, rtol=1e-8)
    with pytest.raises(ValueError, match="no vertex lines"):
        tg2o.read_g2o(str(path))


def test_to_graph_equal_to_jax():
    data = _data(240, 3)
    ref = convert.to_numpy(convert.from_numpy(
        jg2o.to_graph(data, dtype=jnp.float64)))
    got = convert.to_numpy(tg2o.to_graph(data, dtype=torch.float64))
    for name, a, b in zip(ref._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-14,
                                   err_msg=name)


def _iters(err: str) -> int:
    return int(re.search(r" in (\d+) iters", err).group(1))


def _chi2(data):
    """chi^2 of a read-back graph, in f64 (the port's plain version)."""
    from ndtpu_torch.graph import factors as tfct

    return float(tfct.chi2(tg2o.to_graph(data, dtype=torch.float64)))


def _run_both(tmp_path, capsys, args):
    """Both CLIs on ``args``; ``(port's result, port's stderr, JAX's stderr,
    port's written graph, JAX's written graph)``."""
    from ndtpu import solve_g2o as jcli
    from ndtpu_torch import solve_g2o as tcli

    jout, tout = str(tmp_path / "j.g2o"), str(tmp_path / "t.g2o")
    jcli.main(args + ["-o", jout])
    j_err = capsys.readouterr().err
    res = tcli.main(args + ["--device", "cpu", "-o", tout])
    t_err = capsys.readouterr().err
    got, ref = tg2o.read_g2o(tout), jg2o.read_g2o(jout)
    np.testing.assert_array_equal(got.edges_ij, ref.edges_ij)
    return res, t_err, j_err, got, ref


def _converged(err: str) -> bool:
    return "converged=True" in err


@pytest.mark.parametrize("method", ["auto", "supernodal"])
def test_solve_g2o_cli_matches_jax(tmp_path, capsys, method):
    """Both CLIs on ``--manhattan 200`` (auto takes dense at this size), each
    run to its own stop: the written graphs' chi^2 (in f64) within rtol
    1e-5 of each other and of the f64 optimum (the JAX package's dense f64
    solve, from JAX's written poses). The iteration counts, the converged flag and the poses are not
    compared here: past the f32 noise floor of chi^2 the accept test
    compares chi^2 values equal to their last bits, so they are decided by
    roundoff. On this graph the JAX package's own supernodal run takes 16
    iterations (converged) at 8 shards and 23 (not converged) at 4, and the
    port's own dense run 16 iterations with 1 or 2 CPU threads and 21 with
    3, ending 8.4e-4 or 1.8e-5 from the f64 optimum's poses (1.5e-2 with 6
    threads). The schedule up to the floor is held by the test below."""
    from ndtpu.config import SolverConfig as JSolverConfig
    from ndtpu.graph import solve as jslv

    res, t_err, j_err, got, ref = _run_both(
        tmp_path, capsys, ["--manhattan", "200", "--method", method,
                           "--shards", "8"])
    assert res["method"] == ("dense" if method == "auto" else method)
    assert res["n_iter"] == _iters(t_err)
    assert res["chi2_final"] < res["chi2_initial"]
    opt = jslv.optimize(jg2o.to_graph(ref, dtype=jnp.float64),
                        JSolverConfig(max_iter=100, tol=1e-12),
                        method="dense")
    assert bool(opt.converged)
    np.testing.assert_allclose(_chi2(got), _chi2(ref), rtol=1e-5)
    np.testing.assert_allclose(_chi2(got), float(opt.chi2), rtol=1e-5)
    np.testing.assert_allclose(_chi2(ref), float(opt.chi2), rtol=1e-5)


@pytest.mark.parametrize("method", ["auto", "supernodal"])
def test_solve_g2o_cli_schedule_matches_jax(tmp_path, capsys, method):
    """Both CLIs on ``--manhattan 200`` capped at 4 LM iterations, while
    chi^2 still falls by about 1% an iteration (3.3e-3 above the optimum),
    so a step accepted or rejected differently, or another lambda, would
    move it far past the tolerance: neither stops early, and the written
    graphs' chi^2 agree within rtol 1e-5 and their poses within 1e-3."""
    res, t_err, j_err, got, ref = _run_both(
        tmp_path, capsys, ["--manhattan", "200", "--max-iter", "4",
                           "--method", method, "--shards", "8"])
    assert _iters(t_err) == _iters(j_err) == 4
    assert not _converged(t_err) and not _converged(j_err)
    np.testing.assert_allclose(_chi2(got), _chi2(ref), rtol=1e-5)
    np.testing.assert_allclose(got.poses, ref.poses, rtol=0, atol=1e-3)


def test_solve_g2o_cli_without_card_raises():
    from ndtpu_torch import solve_g2o as tcli

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--manhattan", "50", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--manhattan", "50"])


def test_solve_g2o_cli_reads_a_file(tmp_path, capsys):
    """An input file through the port's CLI on the CPU."""
    from ndtpu_torch import solve_g2o as tcli

    path = str(tmp_path / "in.g2o")
    tg2o.write_g2o(path, tg2o.manhattan_world(120, seed=1, loop_prob=0.2))
    res = tcli.main([path, "--device", "cpu", "--method", "pcg"])
    assert res["n_poses"] == 120 and res["method"] == "pcg"
    assert res["chi2_final"] <= res["chi2_initial"]
    assert "[solve_g2o]" in capsys.readouterr().err
