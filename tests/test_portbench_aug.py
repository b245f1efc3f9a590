"""The benchmark's AUG2D-L cell, ``aug2d_l.rhs_stream``, at CPU sizes.

* ``portbench/gen/aug.py`` builds ``utils/mm.py::aug_kkt``'s systems bit
  for bit, and its requests follow the seed with b2 nonzero;
* a whole run of the cell at grid 40 (the reduced-scan factor at p 80,
  r 79: B4/B6's plain versions) is ``correct``, and with the control
  (``harness.CONTROL``) it is not;
* the plain PyTorch reference ``portbench/reference/kkt_schur.py`` matches
  scipy's ``spsolve``; the port's ``solve`` matches the reference within
  the error its stopping contract allows, and ``M.apply`` matches the
  exact P^-1 r;
* on the card (``cuda``; skips without one), the same at grid 100 (p 200,
  r 199), with B4 launched at least twice an iteration.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cpkrylov_tpu_torch as cpt
from cpkrylov_tpu_torch.precond.trisolve import ReducedScanTriFactor
from cpkrylov_tpu_torch.utils.mm import aug_kkt
from cpkrylov_tpu_torch.utils.profiling import launch_counts
from portbench import harness
from portbench.gen import aug
from portbench.reference.kkt_schur import KKTSchur, rel_err

CELL = "aug2d_l.rhs_stream"
SEED = 2**33 + 17
BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CONFIG = harness.load_json(harness.ROOT, "portbench/configs/aug2d_l.json")
# the reduced-scan panel and reach of K_P's factor at each grid
FORM = {40: (80, 79), 100: (200, 199)}
# M.apply against the exact P^-1 r: the apply refines its direct solve
# until ||z - K_P y|| < 1e-8 ||z|| (at most 3 passes, each with the
# probe's factor refinement), and the readings were 2.8e-15 to 4.7e-14 at
# grids 40 and 100 on the CPU; 1e-11 sits 200x above the largest and
# still 100x below the one-pass factor's probe residual (1.2e-9)
APPLY_TOL = 1e-11


def _config(grid):
    cfg = harness.load_json(harness.ROOT, "portbench/configs/aug2d_l.json")
    cfg["generator"]["grid"] = grid
    return cfg


def _family(grid, seed=0):
    return aug.Family(dict(CONFIG["generator"], grid=grid, seed=seed))


def _same(a, b):
    a, b = a.tocsr(), b.tocsr()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


@pytest.mark.parametrize("grid", [12, 40])
@pytest.mark.parametrize("seed", [0, 5])
def test_aug_copy_is_bit_identical(grid, seed):
    ref = aug_kkt("2d", grid, mu=1e-4, delta=1e-8, seed=seed,
                  g_mode="identity")
    got = _family(grid, seed).base()
    for name in "ABCG":
        _same(getattr(got, name), getattr(ref, name))
    assert np.array_equal(got.b, ref.b)


def test_the_config_states_its_sizes():
    fam = aug.Family(CONFIG["generator"])
    assert (fam.n, fam.m) == (CONFIG["n"], CONFIG["m"]) == (199080, 99855)
    assert CONFIG["N"] == fam.n + fam.m and CONFIG["reduced"] == []


def test_requests_follow_the_seed():
    fam = _family(12)
    r1 = fam.rhs(np.random.default_rng([2**33 + 1, 0, 4]))
    r2 = fam.rhs(np.random.default_rng([2**33 + 1, 0, 4]))
    r3 = fam.rhs(np.random.default_rng([2**33 + 2, 0, 4]))
    assert np.array_equal(r1, r2) and not np.array_equal(r1, r3)
    assert r1.shape == (fam.n + fam.m,)
    assert np.all(r1[fam.n:] != 0)            # b2 nonzero: the driver shifts
    cell = harness.Cell(BENCH, CELL, SEED, config=_config(12))
    assert cell.system(0)[0] is cell.base
    assert not np.array_equal(cell.system(0)[1], cell.system(1)[1])


@pytest.mark.parametrize("side", ["program", "control"])
def test_a_tiny_run_is_correct_and_the_control_is_not(side):
    program = harness.CONTROL if side == "control" else None
    res, lines = harness.run_cell(CELL, SEED, 0.3, False, t_start=0.0,
                                  device="cpu", config=_config(40),
                                  program=program)
    assert res["correct"] is (side == "program")
    assert res["attempted"] >= 1 and "setup_s" in res["metrics"]
    checks = res["checks"]
    if side == "program":
        assert checks["resid_ratio_max"]["value"] < 1.0
    else:
        assert (checks["resid_ratio_max"]["value"]
                > checks["resid_ratio_max"]["limit"]
                or checks["unsolved"]["value"] > 0)


@pytest.mark.parametrize("seed", [0, 3])
def test_the_reference_matches_spsolve(seed):
    s = _family(12, seed).base()
    K = sp.bmat([[s.A, s.B.T], [s.B, -s.C]], format="csc")
    want = spla.spsolve(K, s.b)
    got = KKTSchur(s.A, s.B, s.C).solve(s.b)
    assert rel_err(want, got.x) <= 1e-10
    assert got.cg_rel <= 1e-13 and got.kkt_rel <= 1e-10


def test_the_reference_refuses_a_non_diagonal_h():
    s = _family(12).base()
    with pytest.raises(ValueError, match="not diagonal"):
        KKTSchur(s.A + sp.eye(s.A.shape[0], k=1), s.B, s.C)


def _contract_tol(s, b, x_ref, atol, rtol):
    """The largest relative error that the stopping contract allows:
    ||x - x*|| <= ||K^-1|| ||b - K x|| and ||b - K x|| <= atol + rtol ||b||
    give ||K^-1|| (atol + rtol ||b||) / ||x*||, with ||K^-1|| = 1 / the
    smallest |eigenvalue| of the symmetric K."""
    K = sp.bmat([[s.A, s.B.T], [s.B, -s.C]], format="csc")
    lam = abs(spla.eigsh(K, k=1, sigma=0, which="LM",
                         return_eigenvectors=False)[0])
    return (atol + rtol * np.linalg.norm(b)) / lam / float(
        torch.linalg.vector_norm(x_ref))


def _check_solve_and_apply(grid, device):
    cell = harness.Cell(BENCH, CELL, SEED, config=_config(grid))
    call, M = harness._program(cell, device)
    p, r = FORM[grid]
    for tf in (M.factor.tf1, M.factor.tf2):
        assert isinstance(tf, ReducedScanTriFactor)
        assert (tf.panel, tf.r) == (p, r)
    s = cell.base
    ref = KKTSchur(s.A, s.B, s.C, device=device)
    exact_p = KKTSchur(s.G, s.B, s.C, device=device)
    for i in range(2):
        sysm, b = cell.system(i)
        launches = launch_counts()["band_tri"]
        out = call(sysm, b)
        assert out.solved
        if device != "cpu":
            assert (launch_counts()["band_tri"] - launches
                    >= 2 * out.niters)
        x_ref = ref.solve(b).x
        tol = _contract_tol(s, b, x_ref, cell.atol, cell.rtol)
        err = rel_err(out.x.detach().cpu().double().numpy(), x_ref)
        # measured 3.7e-9 to 6.5e-9 against contract tolerances ~9e-6
        assert 0 < err <= tol
        z = torch.as_tensor(np.random.default_rng([9, i]).standard_normal(
            s.A.shape[0] + s.B.shape[0]), device=device)
        _, y, _ = M.apply(M.init_state(), z)
        assert rel_err(y, exact_p.solve(z.cpu().numpy()).x) <= APPLY_TOL


def test_the_solve_and_the_apply_match_the_reference():
    _check_solve_and_apply(40, "cpu")


@pytest.mark.cuda
def test_the_card_matches_the_reference_at_grid_100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _check_solve_and_apply(100, "cuda")
