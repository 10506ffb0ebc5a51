"""The port's pass precision of the factor's products (``gemm_precision``)
against the JAX package's (tests/test_precision.py; its driver.py:706-727,
1543-1578): bf16-first under "auto" with the escalation to "highest" on a
stalled refinement, on the CPU through the plain versions' bf16 products.

"auto" arms the low pass only on CUDA (``driver._auto_low_pass``), as the
JAX package arms it only on its Pallas path; the ``armed`` fixture patches
that one function so that the rule runs here, as tests/test_precision.py
forces interpret mode. Two decisions on ADVICE.md are pinned here:

- item 1, matched on purpose: "auto" factors bf16-first whenever
  refinement is configured (the default), and at "highest" under
  NOREFINE, whose raw solve is the answer;
- item 3, diverged from on purpose: the port reads no
  ``SLU_TPU_CLK_GEMM_PRECISION``, so no variable overrides the precision
  that the counter reports, the escalation's re-factor included.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import superlu_dist_tpu as J

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.models import driver as tdrv
from superlu_dist_tpu_torch.ops import blocklu
from superlu_dist_tpu_torch.ops.kernels import clk, diag_lu, schur
from superlu_dist_tpu_torch.utils import testing as tt

torch.set_num_threads(2)
EPS32 = float(np.finfo(np.float32).eps)
#: one bf16 ulp at 1 (8 significant bits)
EPS_BF16 = 2.0 ** -8


@pytest.fixture
def armed(monkeypatch):
    """"auto" arms the low pass on the CPU, as on CUDA."""
    monkeypatch.setattr(tdrv, "_auto_low_pass", lambda device: True)


def _solve_refine(lu, A):
    b = np.asarray(A @ np.ones(A.shape[0]))
    return lu.refine(b, lu.solve(b))


def _lu(A, **kw):
    return T.SparseLU(A, T.Options(dtype="float32", block_size=8, **kw),
                      device="cpu")


def test_auto_runs_low_pass_first(armed):
    """Unlike the JAX package's interpret mode, whose dots are exact in
    float32, the plain versions round to bf16: refinement takes more
    steps than after a "highest" factor, and converges without an
    escalation."""
    A = tt.laplacian_2d(12)
    lu = _lu(A)
    assert lu.stat.counters["gemm_precision"] == "default"
    assert lu._gemm_prec_used == "default"
    _, berr = _solve_refine(lu, A)
    assert float(berr.max()) < 1e-13
    assert "precision_escalated" not in lu.stat.counters
    steps = lu.stat.refine_steps
    hi = _lu(A, gemm_precision="highest")
    _solve_refine(hi, A)
    assert steps > hi.stat.refine_steps


def test_highest_opts_out_of_low_pass(armed):
    lu = _lu(tt.laplacian_2d(12), gemm_precision="highest")
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert lu._gemm_prec_used == "highest"


def test_cpu_auto_resolves_to_highest():
    """Without the patch the CPU runs "auto" at "highest", as the JAX
    package's CPU path factors, so the port's CPU comparisons with it
    stay as they were."""
    A = tt.laplacian_2d(12)
    lu = _lu(A)
    assert lu.stat.counters["gemm_precision"] == "highest"
    ref = _lu(A, gemm_precision="highest")
    assert torch.equal(lu.pool, ref.pool)


def test_escalation_refactors_at_highest(armed, monkeypatch):
    """Simulated stall: the first refinement reports a stalled berr; the
    driver re-factors at "highest" (bit-equal to a "highest" factor of
    the same matrix) and recovers to < 1e-13; the escalation is sticky
    across a SamePattern_SameRowPerm refactor and does not re-trigger."""
    A = tt.laplacian_2d(12)
    lu = _lu(A)
    assert lu._gemm_prec_used == "default"
    real_impl = lu._refine_impl
    calls = {"n": 0}

    def stalled_once(b, x0, trans=T.Trans.NOTRANS):
        calls["n"] += 1
        x, berr = real_impl(b, x0, trans)
        if calls["n"] == 1:
            return x, np.full_like(np.atleast_1d(berr), 1e-8)
        return x, berr

    monkeypatch.setattr(lu, "_refine_impl", stalled_once)
    _, berr = _solve_refine(lu, A)
    assert calls["n"] == 2
    assert lu.stat.counters["precision_escalated"] == 1
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert lu._gemm_prec_used == "highest"
    assert float(np.max(berr)) < 1e-13
    assert torch.equal(lu.pool, _lu(A, gemm_precision="highest").pool)
    assert not lu._should_escalate(np.array([1e-8]))
    A2 = A.copy()
    A2.data = A2.data * 1.25
    lu.refactor(A2, fact=T.Fact.SAME_PATTERN_SAME_ROWPERM)
    assert lu._gemm_prec_used == "highest"
    assert lu.stat.counters["gemm_precision"] == "highest"
    _solve_refine(lu, A2)
    assert calls["n"] == 3


def test_escalation_disabled_outside_auto(armed):
    lu = _lu(tt.laplacian_2d(12), gemm_precision="bf16")
    assert lu._gemm_prec_used == "default"
    assert not lu._should_escalate(np.array([1e-8]))


def test_norefine_caller_gets_highest(armed):
    """ADVICE.md item 1: NOREFINE disarms the bf16-first attempt."""
    lu = _lu(tt.laplacian_2d(12), iter_refine=T.IterRefine.NOREFINE)
    assert lu._gemm_prec_used == "highest"


@pytest.mark.parametrize("kw", [
    dict(executor="xla"), dict(executor="pallas"), dict(dtype="float64"),
    dict(dtype="complex64"), dict(dtype="float64", gemm_precision="bf16"),
], ids=["xla", "pallas", "float64", "complex64", "float64-bf16"])
def test_level_executor_reports_highest(armed, kw):
    """The level executor ("xla", "pallas", float64, native complex) has
    no low pass: it reports "highest" and never escalates, as the JAX
    package's non-fused executors (test_xla_path_reports_highest)."""
    A = tt.laplacian_2d(12)
    lu = T.SparseLU(A, T.Options(**{"dtype": "float32", "block_size": 8,
                                    **kw}), device="cpu")
    assert lu.stat.counters["executor"] == "pallas"
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert not lu._should_escalate(np.array([1e-8]))


def test_grid_and_batch_report_highest(armed):
    """The 2D grid and the batch factor at full precision and never
    escalate (the JAX package's dist_driver.py:202; its batch runs no
    fused kernel)."""
    A = tt.laplacian_2d(12)
    o = T.Options(dtype="float32", block_size=8)
    lu = T.DistributedSparseLU(A, T.Grid2D(2, 2), o, device="cpu")
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert not lu._should_escalate(np.array([1e-8]))
    bl = T.BatchedSparseLU([A, A * 2.0], o, device="cpu")
    assert bl.stat.counters["gemm_precision"] == "highest"
    assert not bl._escalate_ok


def test_tck_flk_low_pass_is_item_2b(armed):
    """ROADMAP.md item 2b: tck and flk (and ILU(1), whose plan runs flk)
    take the low pass as clk does, as the JAX package's Pallas path
    factors them (its driver.py:714-727, 764-776): "auto", "bf16" and
    "default" resolve to "default"; "highest" and NOREFINE to
    "highest"."""
    A = tt.laplacian_2d(12)
    for kw, exc in ((dict(executor="tck"), "tck"),
                    (dict(executor="flk"), "flk"),
                    (dict(ilu_level=1), "flk")):
        for prec in ("auto", "bf16", "default"):
            lu = _lu(A, gemm_precision=prec, **kw)
            assert lu.executor == exc
            assert lu.stat.counters["gemm_precision"] == "default"
            assert lu._gemm_prec_used == "default"
        for hi in (dict(gemm_precision="highest"),
                   dict(iter_refine=T.IterRefine.NOREFINE)):
            lu = _lu(A, **hi, **kw)
            assert lu.executor == exc
            assert lu.stat.counters["gemm_precision"] == "highest"


def test_no_environment_override(armed, monkeypatch):
    """ADVICE.md item 3: with ``SLU_TPU_CLK_GEMM_PRECISION`` set low, an
    explicit "highest" still factors at "highest", bit for bit, and so
    does an escalation's re-factor."""
    A = tt.laplacian_2d(12)
    ref = _lu(A, gemm_precision="highest")
    monkeypatch.setenv("SLU_TPU_CLK_GEMM_PRECISION", "default")
    lu = _lu(A, gemm_precision="highest")
    assert lu.stat.counters["gemm_precision"] == "highest"
    assert torch.equal(lu.pool, ref.pool)
    lu = _lu(A)
    lu._refactor_values("highest")
    assert lu._gemm_prec_used == "highest"
    assert torch.equal(lu.pool, ref.pool)


# ---------------------------------------------------------------------------
# the plain bf16 products against a numpy oracle
# ---------------------------------------------------------------------------


def _bf(a):
    """float32 → bf16 (nearest even, ml_dtypes) → float64."""
    return np.asarray(a, dtype=np.float32).astype(
        ml_dtypes.bfloat16).astype(np.float64)


def _oracle_update(pool, linv, tp, level):
    """clk_update at "default" in numpy: the reference order of
    ``clk_update_plain``, each operand it rounds rounded by ml_dtypes,
    the products and sums in float64, every stored block in float32."""
    h = tp.host
    for k in h["ucols"][tp.uptr[level]:tp.uptr[level + 1]]:
        base, q0 = int(h["col_base"][k]), int(h["col_job0"][k])
        for t in range(int(h["col_dpos"][k])):
            q = q0 + t
            U = (_bf(linv[int(h["job_src"][q])]) @ _bf(pool[base + t])
                 ).astype(np.float32)
            pool[base + t] = U
            lm, a0 = int(h["job_lm"][q]), int(h["job_la0"][q])
            d0 = int(h["job_dst0"][q])
            for r in range(lm):
                d = int(h["dst"][d0 + r])
                pool[d] = (pool[d] - _bf(pool[a0 + r]) @ _bf(U)
                           ).astype(np.float32)


def test_plain_bf16_level_matches_ml_dtypes_oracle():
    """One level of ``clk_update_plain`` and ``clk_trsm_plain`` at
    "default" (its input made by the levels below at "default") against
    the numpy oracle that rounds the same operands with ml_dtypes: within
    64 float32 ulp of the output's scale (float32 sums against float64
    ones), where rounding another operand, or truncating instead of
    rounding to nearest even, moves the result by about a bf16 ulp
    (2^-8). The plain wave order and the driver's whole factor agree with
    it too."""
    A = tt.laplacian_3d(6).tocsc()
    # values that bf16 does not hold exactly (the Laplacian's do)
    A.data = A.data * (1.0 + 0.1 * np.random.default_rng(4).standard_normal(
        A.nnz))
    bs = 16
    lu = T.SparseLU(A, T.Options(dtype="float32", block_size=bs,
                                 gemm_precision="bf16"), device="cpu")
    plan, tp = lu.plan, lu._ftapes
    pool = blocklu.init_pool(plan, lu._a3_data, np.float32, "cpu")
    linv = torch.zeros((plan.nb, bs, bs))
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32)
    nblk = np.diff(tp.uptr)
    level = int(np.argmax(nblk))
    assert nblk[level] > 1 and tp.lptr[level + 1] > tp.lptr[level]
    for lvl in range(level):
        clk.factor_level(pool, linv, uinv, tiny, lu._thresh(), tp, lvl,
                         "default")
    want = pool.numpy().copy()
    _oracle_update(want, linv.numpy(), tp, level)
    waves, full = pool.clone(), pool.clone()
    clk.clk_update_plain(pool, linv, tp, level, "default")
    clk.clk_update_waves_plain(waves, linv, tp, level, "default")
    clk.clk_update_plain(full, linv, tp, level, "highest")
    tol = 64 * EPS32 * max(1.0, float(np.abs(want).max()))
    assert np.abs(pool.numpy() - want).max() <= tol
    assert float((waves - pool).abs().max()) <= tol
    # the oracle tells the passes apart
    assert np.abs(full.numpy() - want).max() > 10 * tol
    lo, hi_ = int(tp.dptr[level]), int(tp.dptr[level + 1])
    diag_lu.diag_lu(pool, linv, uinv, tp.dslot[lo:hi_], tp.dstep[lo:hi_],
                    lu._thresh(), tiny)
    ls = tp.lslot[int(tp.lptr[level]):int(tp.lptr[level + 1])].long()
    lk = tp.lstep[int(tp.lptr[level]):int(tp.lptr[level + 1])].long()
    want = np.stack([(_bf(pool[s].numpy()) @ _bf(uinv[k].numpy()))
                     for s, k in zip(ls, lk)]).astype(np.float32)
    full = (pool[ls] @ uinv[lk]).numpy()
    clk.clk_trsm_plain(pool, uinv, tp, level, "default")
    tol = 64 * EPS32 * max(1.0, float(np.abs(want).max()))
    assert np.abs(pool[ls].numpy() - want).max() <= tol
    assert np.abs(full - want).max() > 10 * tol
    for lvl in range(level + 1, tp.nlvl):
        clk.factor_level(pool, linv, uinv, tiny, lu._thresh(), tp, lvl,
                         "default")
    assert torch.equal(pool, lu.pool)


def test_trsm_plain_rounds_both_operands():
    """``schur.trsm_plain`` at "default" equals the float32 product of the
    bf16-rounded operands, bit for bit, and refuses a complex pool."""
    rng = np.random.default_rng(5)
    pool = torch.as_tensor(rng.standard_normal((5, 16, 16)),
                           dtype=torch.float32)
    dinv = torch.as_tensor(rng.standard_normal((3, 16, 16)),
                           dtype=torch.float32)
    slots, steps = torch.tensor([1, 3], dtype=torch.int32), \
        torch.tensor([2, 0], dtype=torch.int32)
    got = pool.clone()
    schur.trsm_plain(got, dinv, slots, steps, left=False,
                     precision="default")
    bf = (lambda t: torch.as_tensor(_bf(t.numpy()), dtype=torch.float32))
    want = bf(pool[[1, 3]]) @ bf(dinv[[2, 0]])
    assert torch.equal(got[[1, 3]], want)
    assert torch.equal(got[[0, 2, 4]], pool[[0, 2, 4]])
    with pytest.raises(ValueError, match="precision"):
        schur.trsm_plain(got, dinv, slots, steps, left=False,
                         precision="high")
    with pytest.raises(ValueError, match="float32"):
        schur.trsm_plain(got.to(torch.complex64), dinv.to(torch.complex64),
                         slots, steps, left=False, precision="default")


# ---------------------------------------------------------------------------
# the whole driver against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lap3d8", "fem3d"])
def test_gssvx_bf16_matches_jax(name):
    """``gssvx(..., gemm_precision="bf16")`` on the CPU against the JAX
    package's ``gssvx`` with the same Options (whose CPU path factors at
    full precision): the refined x agree to 1e-10 relative and both berr
    ≤ 1e-12; the unrefined factor pools, slot by slot on the same plan,
    agree within 8 bf16 ulp (8·2^-8) of the pool's scale, the distance of
    the low pass's rounding (measured 0.64 and 0.13 ulp), and differ by
    more than float32 rounding. The port refines in more steps (9 and 6
    against 2 and 3)."""
    A = {"lap3d8": lambda: tt.laplacian_3d(8),
         "fem3d": lambda: tt.fem3d_delaunay(150, seed=1)}[name]().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(dtype="float32", block_size=16, gemm_precision="bf16")
    rj, jlu = J.gssvx(A, b, J.Options(**kw))
    rt, lu = T.gssvx(A, b, T.Options(**kw), device="cpu")
    assert rt.stat.counters["gemm_precision"] == "default"
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert rt.berr.max() <= 1e-12 and rj.berr.max() <= 1e-12
    assert rt.stat.refine_steps > rj.stat.refine_steps
    ns = lu.plan.nslots
    assert ns == jlu.plan.nslots
    jp = np.asarray(jlu._export_factors()[0])[:ns]
    tp = lu.pool[:ns].numpy()
    scale = max(1.0, float(np.abs(jp).max()))
    err = float(np.abs(tp - jp).max())
    assert 64 * EPS32 * scale < err <= 8 * EPS_BF16 * scale


def test_embedded_complex64_under_armed_rule(armed, monkeypatch):
    """The ring-embedded complex64 factor runs clk in float32, so "auto"
    arms its low pass too: refined to berr ≤ 1e-12, within 1e-10 of the
    native complex64 solution."""
    A = tt.helmholtz_3d(5).tocsc()
    n = A.shape[0]
    rng = np.random.default_rng(2)
    b = A @ (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    o = T.Options(dtype="complex64", block_size=16)
    rn, _ = T.gssvx(A, b, o, device="cpu")
    monkeypatch.setenv("SLU_TPU_COMPLEX", "embed")
    re, lu = T.gssvx(A, b, o, device="cpu")
    assert lu._embed and lu.pool.dtype == torch.float32
    assert re.stat.counters["executor"] == "clk"
    assert re.stat.counters["gemm_precision"] == "default"
    assert rn.stat.counters["gemm_precision"] == "highest"
    assert re.berr.max() <= 1e-12
    assert np.abs(re.x - rn.x).max() <= 1e-10 * np.abs(rn.x).max()
    assert np.abs(A @ re.x - b).max() <= 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("kw", [
    dict(), dict(executor="tck"), dict(executor="flk"), dict(ilu_level=1),
    dict(iter_refine="NOREFINE"), dict(gemm_precision="highest"),
    dict(gemm_precision="bf16"), dict(executor="xla"),
    dict(dtype="float64"),
], ids=["auto", "tck", "flk", "ilu1", "norefine", "highest", "bf16", "xla",
        "float64"])
def test_counter_matches_jax(armed, monkeypatch, kw):
    """The resolved precision against the JAX package's for the same
    Options on its Pallas path (``SLU_TPU_FORCE_PALLAS=interpret``):
    equal for every executor, tck, flk and ILU(1) included, and the same
    executor named."""
    monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
    A = tt.laplacian_2d(12)
    kw = dict(kw)
    if "iter_refine" in kw:
        kw["iter_refine"] = getattr(J.IterRefine, kw["iter_refine"])
    base = dict(dtype="float32", block_size=8, align_blocks="on")
    jlu = J.SparseLU(A, J.Options(**{**base, **kw}))
    tkw = {**base, **kw}
    if "iter_refine" in tkw:
        tkw["iter_refine"] = T.IterRefine.NOREFINE
    lu = T.SparseLU(A, T.Options(**tkw), device="cpu")
    assert lu._gemm_prec_used == jlu._gemm_prec_used
    assert lu.stat.counters["gemm_precision"] == jlu._gemm_prec_used
    if kw.get("executor") in ("tck", "flk") or "ilu_level" in kw:
        assert jlu._gemm_prec_used == "default"
        assert lu.executor == ("tck" if kw.get("executor") == "tck"
                               else "flk")
