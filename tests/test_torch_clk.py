"""Kernel 2 (clk): the plain level-by-level clk factor and the plain
right-looking ``factor_plain`` against the JAX package's clk kernel (in
interpret mode) and its float64 XLA executor, on the cases of
tests/test_clk.py; and the source-ready wave tapes of ``clk_update``:
their invariants, and the factor through ``clk_update_waves_plain``
against the same references."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from superlu_dist_tpu.ops.host.symbolic import block_symbolic as jsym
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import clk as jclk

from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.host.ordering import get_perm_c
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import clk
from superlu_dist_tpu_torch.ops.kernels.diag_lu import diag_lu
from superlu_dist_tpu_torch.utils.options import ColPerm
from superlu_dist_tpu_torch.utils.testing import laplacian_2d, laplacian_3d

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)


def jax_f64_truth(A, plan):
    """Reference factors via the JAX package's float64 XLA executor."""
    pool0 = jbl.init_pool(plan, A.data.astype(np.float64), np.float64)
    fn = jbl.build_factor_fn(plan, chunk=8)
    p, li, ui, _ = fn(jnp.array(pool0), jnp.asarray(0.0, jnp.float64),
                      jbl.make_factor_tapes(plan))
    return np.asarray(p), np.asarray(li), np.asarray(ui)


def jax_clk(A, plan):
    pool0 = jbl.init_pool(plan, A.data, np.float32)
    fn, tapes = jclk.build_factor_fn_clk(plan, interpret=True)
    p, li, ui, tiny = fn(jnp.array(pool0), jnp.asarray(0.0, jnp.float32),
                         tapes)
    return np.asarray(p), np.asarray(li), np.asarray(ui), int(tiny)


def waves_factor(pool, tp, nb):
    """``clk.factor`` with the update through the wave tapes."""
    bs = pool.shape[-1]
    linv = torch.zeros((nb, bs, bs))
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32)
    for level in range(tp.nlvl):
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        clk.clk_update_waves_plain(pool, linv, tp, level)
        diag_lu(pool, linv, uinv, tp.dslot[lo:hi], tp.dstep[lo:hi], 0.0,
                tiny)
        clk.clk_trsm(pool, uinv, tp, level)
    return pool, linv, uinv, tiny


def port_factors(A, plan, waves=False):
    """(plain clk factor, plain right-looking factor), both float32; with
    ``waves`` the clk update runs through the wave tapes."""
    tp = clk.build_clk_tapes(plan, "cpu")
    p = tbl.init_pool(plan, A.data, np.float32, "cpu")
    c = (waves_factor(p, tp, plan.nb) if waves
         else clk.factor(p, 0.0, tp, plan.nb))
    r = tbl.factor_plain(plan, tbl.init_pool(plan, A.data, np.float32,
                                             "cpu"), 0.0)
    return c, r


def check(A, bs, ulps, waves=False):
    A = A.tocsc().astype(np.float32)
    plan = block_symbolic(A, bs)
    ns, nb = plan.nslots, plan.nb
    p64, li64, ui64 = jax_f64_truth(A, jsym(A, bs))
    pj, lij, _, tj = jax_clk(A, jsym(A, bs))
    (pc, lic, uic, tc), (pr, lir, uir, tr) = port_factors(A, plan, waves)
    assert int(tc) == tr == tj == 0
    scale = max(np.abs(p64[:ns]).max(), 1.0)
    tol = ulps * EPS32 * scale
    for pool in (pc, pr):
        assert np.abs(pool[:ns].numpy() - p64[:ns]).max() < tol
        assert np.abs(pool[:ns].numpy() - pj[:ns]).max() < 2 * tol
    ltol = ulps * EPS32 * max(np.abs(li64[:nb]).max(), 1.0)
    for li in (lic, lir):
        assert np.abs(li.numpy() - li64[:nb]).max() < ltol
        assert np.abs(li.numpy() - lij[:nb]).max() < 2 * ltol
    utol = ulps * EPS32 * max(np.abs(ui64[:nb]).max(), 1.0)
    for ui in (uic, uir):
        assert np.abs(ui.numpy() - ui64[:nb]).max() < utol


MATS = [("lap2d12", 16), ("lap3d8", 32), ("lap2d20", 8)]
#: the wave tests add the matrices in a minimum-degree order, whose plans
#: give a target several products in one wave (the natural order never
#: does on these matrices)
WAVE_MATS = MATS + [("lap3d8-mmd", 8), ("lap2d20-mmd", 8)]


def matrix(mat):
    name, _, order = mat.partition("-")
    A = {"lap2d12": laplacian_2d(12), "lap3d8": laplacian_3d(8),
         "lap2d20": laplacian_2d(20)}[name].tocsc()
    if order:
        p = get_perm_c(ColPerm.MMD_AT_PLUS_A, A)
        A = A[p][:, p]
    return A


def random_pattern(trial):
    rng = np.random.default_rng(7)
    for _ in range(trial + 1):
        n = 160
        d = rng.uniform(0.02, 0.08)
        M = sp.random(n, n, density=d, random_state=rng.integers(1 << 30),
                      format="csc")
    return M + M.T + sp.eye(n) * (n * 0.5)


@pytest.mark.parametrize("mat,bs", MATS)
def test_clk_matches_jax(mat, bs):
    """64 ulp at the pool scale against the float64 truth (the tolerance
    of tests/test_clk.py), twice that against the JAX float32 clk."""
    check(matrix(mat), bs, 64)


@pytest.mark.parametrize("trial", range(5))
def test_clk_random_patterns(trial):
    """Random sparse patterns stress the pair schedule and the fill
    closure's target map; 512 ulp as in tests/test_clk.py."""
    check(random_pattern(trial), 16, 512)


@pytest.mark.parametrize("mat,bs", WAVE_MATS)
def test_clk_waves_match_jax(mat, bs):
    """The factor with the update through the wave tapes, held as
    test_clk_matches_jax holds the reference order."""
    check(matrix(mat), bs, 64, waves=True)


@pytest.mark.parametrize("trial", range(5))
def test_clk_waves_random_patterns(trial):
    """The wave factor on the random patterns, at 512 ulp."""
    check(random_pattern(trial), 16, 512, waves=True)


def check_wave_tapes(plan, tp):
    """The wave tapes' invariants: every Schur triple is exactly one
    product; a target appears at most once per wave and its list runs in
    ascending source row j; a product's wave lies above its source's
    finalize wave; each U block is finalized exactly once, by linv of its
    row, in the wave of its last product (wave 0 when it has none), and
    no other block is."""
    h = tp.host
    nt, nw = len(h["tslot"]), int(tp.lwave[-1])
    assert tp.wptr[0] == 0 and tp.wptr[-1] == nt and np.all(
        np.diff(tp.wptr) > 0)
    t_wave = np.repeat(np.arange(nw), np.diff(tp.wptr))
    t_lvl = np.searchsorted(tp.lwave, t_wave, side="right") - 1
    p_tgt = np.repeat(np.arange(nt), np.diff(h["pptr"]))
    prods = list(zip(h["cl"].tolist(), h["cu"].tolist(),
                     h["tslot"][p_tgt].tolist()))
    triples = list(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                       plan.g_t.tolist()))
    assert len(prods) == len(set(prods)) == len(triples)
    assert set(prods) == set(triples)
    assert len(set(zip(t_wave.tolist(), h["tslot"].tolist()))) == nt
    same = p_tgt[1:] == p_tgt[:-1]
    assert np.all(h["pj"][1:][same] > h["pj"][:-1][same])
    assert np.array_equal(h["pj"], np.asarray(plan.slot_row)[h["cu"]])
    job_of = dict(zip(h["job_slot"].tolist(), range(len(h["job_slot"]))))
    src_f = h["job_fwave"][[job_of[u] for u in h["cu"].tolist()]]
    p_wave = t_wave[p_tgt] - tp.lwave[t_lvl[p_tgt]]
    assert np.all(p_wave > src_f)
    fin = h["tfin"] == clk.FIN_U
    assert set(np.unique(h["tfin"])) <= {clk.FIN_NONE, clk.FIN_U}
    fslot = h["tslot"][fin]
    assert sorted(fslot.tolist()) == sorted(job_of)
    last = {}
    for t, w in zip(h["tslot"][p_tgt].tolist(), p_wave.tolist()):
        last[t] = max(last.get(t, 0), w)
    f_wave = t_wave[fin] - tp.lwave[t_lvl[fin]]
    for s_, w, st in zip(fslot.tolist(), f_wave.tolist(),
                         h["tstep"][fin].tolist()):
        assert w == last.get(s_, 0) == h["job_fwave"][job_of[s_]]
        assert st == plan.slot_row[s_]


@pytest.mark.parametrize("mat,bs", WAVE_MATS)
def test_clk_wave_tapes(mat, bs):
    A = matrix(mat).tocsc()
    plan = block_symbolic(A, bs)
    check_wave_tapes(plan, clk.build_clk_tapes(plan, "cpu"))


@pytest.mark.parametrize("trial", range(5))
def test_clk_wave_tapes_random_patterns(trial):
    A = random_pattern(trial).tocsc()
    plan = block_symbolic(A, 16)
    check_wave_tapes(plan, clk.build_clk_tapes(plan, "cpu"))


def test_clk_refuses_ilu_plan():
    """ILU plans drop fill, which breaks the closure clk relies on."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 8, ilu_level=0)
    assert plan.nslots < block_symbolic(A, 8).nslots
    with pytest.raises(ValueError):
        clk.build_clk_tapes(plan, "cpu")


def test_clk_tapes_cover_every_schur_triple():
    """Every Schur triple of the plan is exactly one (job, L block) pair
    of the left-looking tapes, with the same target slot."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 16)
    tp = clk.build_clk_tapes(plan, "cpu")
    h = tp.host
    pairs = set()
    for q in range(len(h["job_src"])):
        uslot = None
        for k in range(plan.nb):
            if h["col_job0"][k] <= q < h["col_job0"][k] + h["col_dpos"][k]:
                uslot = h["col_base"][k] + q - h["col_job0"][k]
        for m in range(h["job_lm"][q]):
            pairs.add((int(h["job_la0"][q] + m), int(uslot),
                       int(h["dst"][h["job_dst0"][q] + m])))
    triples = set(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                      plan.g_t.tolist()))
    assert pairs == triples


@pytest.mark.parametrize("bs", [8, 16])
def test_clk_trsm_each_level(bs):
    """clk_trsm (its plain version on the CPU) level by level on lap3d8's
    clk plan: each L block of the level becomes L(i,k)·uinv(k), every
    other slot is untouched; a level lists several L blocks of one column,
    so steps repeat within a launch."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, bs)
    tp = clk.build_clk_tapes(plan, "cpu")
    rng = np.random.default_rng(bs)
    pool = torch.as_tensor(rng.standard_normal((plan.nslots, bs, bs)),
                           dtype=torch.float32)
    uinv = torch.triu(torch.as_tensor(
        rng.standard_normal((plan.nb, bs, bs)), dtype=torch.float32))
    repeats = 0
    for level in range(tp.nlvl):
        lo, hi = int(tp.lptr[level]), int(tp.lptr[level + 1])
        steps = tp.lstep[lo:hi].tolist()
        repeats += len(steps) - len(set(steps))
        want = pool.clone()
        for s, k in zip(tp.lslot[lo:hi].tolist(), steps):
            want[s] = pool[s] @ uinv[k]
        clk.clk_trsm(pool, uinv, tp, level)
        assert torch.allclose(pool, want, rtol=1e-6, atol=1e-6)
    assert repeats > 0
