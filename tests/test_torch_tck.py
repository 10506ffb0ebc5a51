"""Kernel 5 (tck): the port's plain level-by-level tck factor against the
JAX package's tck kernel (in interpret mode) on the cases of
tests/test_tck.py, its job stream against the JAX tapes, its refusal of
ILU plans, and ``gssvx(..., executor="tck")`` against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superlu_dist_tpu as J
from superlu_dist_tpu.ops.host.symbolic import block_symbolic as jsym
from superlu_dist_tpu.ops.kernels import blocklu as jbl
from superlu_dist_tpu.ops.kernels import tck as jtck
from superlu_dist_tpu.utils.testing import random_sparse

import superlu_dist_tpu_torch as T
from superlu_dist_tpu_torch.ops import blocklu as tbl
from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import clk, diag_lu, flk, tck
from superlu_dist_tpu_torch.utils.testing import laplacian_2d, laplacian_3d

torch.set_num_threads(2)

#: tests/test_tck.py's cases: matrix, block size, tile rows
CASES = {
    "lap2d12-w16": (lambda: laplacian_2d(12), 8, 16),
    "lap3d8-w4": (lambda: laplacian_3d(8), 8, 4),
    "lap3d8-w8": (lambda: laplacian_3d(8), 8, 8),
    "random180-w4": (lambda: random_sparse(180, density=0.05, seed=4), 8, 4),
}


def _plans(name):
    make, bs, w = CASES[name]
    A = make().tocsc().astype(np.float32)
    return A, block_symbolic(A, bs), jsym(A, bs), w


@pytest.mark.parametrize("name", sorted(CASES))
def test_tck_factor_matches_jax(name):
    """Pool, linv and uinv slot by slot to 1e-4·max(1, scale), the
    tolerance of tests/test_tck.py (float32 sums in other orders)."""
    A, plan, jplan, w = _plans(name)
    pool0 = jbl.init_pool(jplan, A.data, np.float32)
    fn, tapes = jtck.build_factor_fn_tck(jplan, w=w, interpret=True)
    pj, lj, uj, tj = fn(jnp.array(pool0), jnp.asarray(0.0, jnp.float32),
                        tapes)
    tp = tck.build_tck_tapes(plan, "cpu", w=w)
    pt, lt, ut, tt = tck.factor(tbl.init_pool(plan, A.data, np.float32,
                                              "cpu"), 0.0, tp, plan.nb)
    assert int(tt) == int(tj) == 0
    ns, nb = plan.nslots, plan.nb
    for got, want in ((pt[:ns], pj[:ns]), (lt, lj[:nb]), (ut, uj[:nb])):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    if name != "lap2d12-w16":
        assert tp.host["counts"]["tiles"] > plan.nb, "tiling not exercised"


@pytest.mark.parametrize("name", sorted(CASES))
def test_tck_job_stream_matches_jax_tapes(name):
    """The port's job counts by type equal the JAX tapes' job stream at
    the same tile rows and chunk size, with the NOP pads removed."""
    _, plan, jplan, w = _plans(name)
    jtapes, _ = jtck.build_tck_tapes(jplan, w, tck.MC)
    jt = np.concatenate([np.asarray(t["jt"]) for t in jtapes])
    jt = jt[jt != jtck.J_NOP]
    want = dict(gemm=jtck.J_GEMM, finu=jtck.J_FINU, diag=jtck.J_DIAG,
                trsm=jtck.J_TRSM, tiles=jtck.J_LOAD)
    got = tck.build_tck_tapes(plan, "cpu", w=w).host["counts"]
    assert got == {k: int((jt == v).sum()) for k, v in want.items()}
    assert int((jt == jtck.J_STORE).sum()) == got["tiles"]


def test_tck_tapes_cover_every_schur_triple():
    """Every Schur triple of the plan is exactly one phase-A wave product
    or one phase-B tile product, with the same target slot; every U block
    is finalized exactly once, in phase A; every phase-B source is a U
    block that phase A finalized; a tile's products run in ascending
    source j, then L block, within its w rows."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 8)
    tp = tck.build_tck_tapes(plan, "cpu", w=4)
    h = tp.host
    prods, finals = [], []
    for t in range(len(h["tslot"])):
        for p in range(h["pptr"][t], h["pptr"][t + 1]):
            prods.append((int(h["cl"][p]), int(h["cu"][p]),
                          int(h["tslot"][t])))
        if h["tfin"][t] == clk.FIN_U:
            finals.append(int(h["tslot"][t]))
    nwave = len(prods)
    srow = np.asarray(plan.slot_row)
    for s0, rows, q0, q1 in h["tiles"]:
        assert 1 <= rows <= tp.w
        assert set(h["bd"][q0:q1]) <= set(range(rows))
        key = [(srow[u], srow[l]) for l, u in zip(h["bl"][q0:q1],
                                                  h["bu"][q0:q1])]
        assert key == sorted(key)
        prods += [(int(l), int(u), int(s0 + d)) for l, u, d in zip(
            h["bl"][q0:q1], h["bu"][q0:q1], h["bd"][q0:q1])]
    triples = list(zip(plan.g_l.tolist(), plan.g_u.tolist(),
                       plan.g_t.tolist()))
    assert sorted(prods) == sorted(triples)
    assert 0 < nwave < len(prods)
    assert sorted(finals) == sorted(np.asarray(plan.u_slots).tolist())
    assert set(h["bu"].tolist()) <= set(finals)
    assert h["tiles"][:, 1].max() > 1, "multi-row tiles not exercised"


@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_tck_chain_tapes_cover_phase_b_once(chunk):
    """The bf16 phase B's tape (``TckTapes.chains``) holds every phase-B
    tile product exactly once: level by level, one chain per position
    that has products, in the tiles' order (a tile's positions top down),
    each chain the tile's products into that position in the tile's order
    (ascending source j); each chain cut into chunks of at most
    CHUNK_MAX products (``chunk`` when given) that cover it in order; a
    position of one chunk takes no scratch row, the chunks of a position
    of several take consecutive rows, numbered in chunk order and
    distinct within the level, and the position is a pass-2 job of its
    level with those rows."""
    A = laplacian_3d(8).tocsc()
    plan = block_symbolic(A, 8)
    tp = tck.build_tck_tapes(plan, "cpu", w=4, chunk=chunk)
    h, c = tp.host, tp.chains
    ch = c.host
    cap = chunk or flk.CHUNK_MAX
    multi = 0
    for lvl in range(tp.nlvl):
        want = []   # (slot, [(l, u), ...]) per position, in tile order
        for s0, rows, q0, q1 in h["tiles"][tp.tptr[lvl]:tp.tptr[lvl + 1]]:
            for d in range(rows):
                sel = np.flatnonzero(h["bd"][q0:q1] == d) + q0
                if len(sel):
                    want.append((s0 + d, list(zip(h["bl"][sel].tolist(),
                                                  h["bu"][sel].tolist()))))
        t0, t1 = c.tptr[lvl], c.tptr[lvl + 1]
        got = [(int(ch["tslot"][t]),
                list(zip(ch["cl"][ch["cptr"][t]:ch["cptr"][t + 1]].tolist(),
                         ch["cu"][ch["cptr"][t]:ch["cptr"][t + 1]].tolist())))
               for t in range(t0, t1)]
        assert got == want
        rows = set()
        m = range(c.mptr[lvl], c.mptr[lvl + 1])
        for t in range(t0, t1):
            q0, q1 = ch["chunkptr"][t], ch["chunkptr"][t + 1]
            assert c.qptr[lvl] <= q0 < q1 <= c.qptr[lvl + 1]
            assert (ch["qtgt"][q0:q1] == t).all()
            assert ch["qcptr"][q0] == ch["cptr"][t]
            assert ch["qcptr"][q1] == ch["cptr"][t + 1]
            assert (np.diff(ch["qcptr"][q0:q1 + 1]) >= 1).all()
            assert (np.diff(ch["qcptr"][q0:q1 + 1]) <= cap).all()
            r = ch["qrow"][q0:q1]
            if q1 - q0 == 1:
                assert r[0] == -1 and t not in ch["mtgt"][m.start:m.stop]
                continue
            multi += 1
            assert (np.diff(r) == 1).all() and 0 <= r[0]
            assert r[-1] < c.nrow[lvl] and not rows & set(r.tolist())
            rows |= set(r.tolist())
            j = m.start + int(np.flatnonzero(ch["mtgt"][m.start:m.stop]
                                             == t)[0])
            assert ch["mrow"][j] == r[0] and ch["mcnt"][j] == q1 - q0
        assert len(rows) == c.nrow[lvl]
    assert multi == len(ch["mtgt"]) > 0
    assert len(ch["cl"]) == len(h["bl"])


@pytest.mark.parametrize("chunk", [None, 3])
def test_tck_chains_plain_matches_tiles_plain(chunk):
    """At "highest" the bf16 phase B's plain version on its chunks
    (``tck_chains_plain``) computes the FP32 tiles' function: from the
    same pool, level by level, within 16 float32 ulp of the pool's scale
    of ``tck_tiles_plain`` (a position sums its chunks' partial sums
    instead of one running sum)."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    A.data = A.data * (1.0 + 0.1 * np.random.default_rng(2)
                       .standard_normal(A.nnz)).astype(np.float32)
    plan = block_symbolic(A, 8)
    tp = tck.build_tck_tapes(plan, "cpu", w=4, chunk=chunk)
    pool = tbl.init_pool(plan, A.data, np.float32, "cpu")
    bs, nb = plan.bs, plan.nb
    linv = torch.zeros((nb, bs, bs))
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32)
    eps = float(np.finfo(np.float32).eps)
    moved = 0.0
    for level in range(tp.nlvl):
        tck.tck_waves_plain(pool, linv, tp, level)
        tiles, chains = pool.clone(), pool.clone()
        tck.tck_tiles_plain(tiles, tp, level)
        tck.tck_chains_plain(chains, tp, level, "highest")
        scale = max(1.0, float(tiles.abs().max()))
        diff = float((tiles - chains).abs().max())
        assert diff <= 16 * eps * scale, level
        moved = max(moved, diff)
        pool = tiles
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), 0.0, tiny)
        clk.clk_trsm_plain(pool, uinv, tp, level)
    if chunk == 3:
        assert moved > 0, "no position summed chunks apart"


def test_tck_equals_clk_plain():
    """tck and clk compute the same function: their plain factors agree
    to float32 rounding on a multi-tile plan."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 8)
    outs = [mod.factor(tbl.init_pool(plan, A.data, np.float32, "cpu"), 0.0,
                       tapes, plan.nb)
            for mod, tapes in ((tck, tck.build_tck_tapes(plan, "cpu", w=4)),
                               (clk, clk.build_clk_tapes(plan, "cpu")))]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 64 * np.finfo(np.float32).eps \
            * scale


def test_tck_u_blocks_equal_clk_waves_plain():
    """tck's phase A runs clk's wave tapes restricted to the U targets, so
    from the same pool every level's U blocks come out bit for bit as
    ``clk.clk_update_waves_plain`` leaves them; the phase-B products touch
    no U block."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 8)
    tp = tck.build_tck_tapes(plan, "cpu", w=4)
    cp = clk.build_clk_tapes(plan, "cpu")
    u = torch.as_tensor(np.asarray(plan.u_slots, dtype=np.int64))
    pool = tbl.init_pool(plan, A.data, np.float32, "cpu")
    bs, nb = plan.bs, plan.nb
    linv = torch.zeros((nb, bs, bs))
    uinv = torch.zeros_like(linv)
    tiny = torch.zeros(1, dtype=torch.int32)
    for level in range(tp.nlvl):
        ref = pool.clone()
        clk.clk_update_waves_plain(ref, linv, cp, level)
        tck.tck_update_plain(pool, linv, tp, level)
        assert torch.equal(pool[u], ref[u])
        lo, hi = int(tp.dptr[level]), int(tp.dptr[level + 1])
        diag_lu.diag_lu_plain(pool, linv, uinv, tp.dslot[lo:hi].long(),
                              tp.dstep[lo:hi].long(), 0.0, tiny)
        clk.clk_trsm_plain(pool, uinv, tp, level)
    assert not set(tp.host["bd"] + np.repeat(
        tp.host["tiles"][:, 0], np.diff(tp.host["tiles"][:, 2:], axis=1)
        [:, 0])) & set(u.tolist())


def test_tck_refuses_ilu_plan():
    """The fill-closure ValueError of the JAX tck (tck.py:121-123), from
    ``build_tck_tapes`` and from ``SparseLU``, which does not reroute
    tck."""
    A = laplacian_3d(8).tocsc().astype(np.float32)
    plan = block_symbolic(A, 8, ilu_level=1)
    with pytest.raises(ValueError, match="fill closure"):
        jtck.build_tck_tapes(jsym(A, 8, ilu_level=1), 4, tck.MC)
    with pytest.raises(ValueError, match="fill closure"):
        tck.build_tck_tapes(plan, "cpu", w=4)
    with pytest.raises(ValueError, match="fill closure"):
        T.SparseLU(A, T.Options(dtype="float32", block_size=8,
                                executor="tck", ilu_level=1), device="cpu")


def test_tile_rows():
    """The tile rows that fit beside the ring in half an SM's 228 KiB,
    less the card's 1 KiB per CTA."""
    assert [tck.tile_rows(bs) for bs in (32, 64, 128)] == [46, 20, 6]
    for bs in (32, 64, 128):
        need = tck.ring_bytes(bs) + tck.tile_rows(bs) * bs * tck.TN * 4
        assert need <= tck.TILE_SMEM < need + bs * tck.TN * 4


@pytest.mark.parametrize("make,bs", [(lambda: laplacian_3d(8), 16),
                                     (lambda: laplacian_2d(16), 8)],
                         ids=["lap3d8", "lap2d16"])
def test_gssvx_tck_matches_jax(make, bs, monkeypatch):
    """``executor="tck"`` end to end against the JAX package's tck in
    interpret mode, on the same plan (``align_blocks="on"``): equal
    fill_blocks and tiny pivots, x within 1e-10 relative."""
    monkeypatch.setenv("SLU_TPU_FORCE_PALLAS", "interpret")
    A = make().tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(dtype="float32", block_size=bs, executor="tck",
              align_blocks="on")
    rj, jlu = J.gssvx(A, b, J.Options(**kw))
    rt, lu = T.gssvx(A, b, T.Options(**kw), device="cpu")
    # tck_jobs counts the JAX tapes' jobs at the port's tile rows, without
    # the NOP pads that the JAX counter also counts
    jtapes, _ = jtck.build_tck_tapes(jlu.plan, lu._ftapes.w, tck.MC)
    jt = np.concatenate([np.asarray(t["jt"]) for t in jtapes])
    assert rt.stat.counters["executor"] == "tck"
    assert rt.stat.counters["tck_jobs"] == int((jt != jtck.J_NOP).sum()) > 0
    assert rj.stat.counters["tck_jobs"] >= sum(
        int((np.asarray(t["jt"]) != jtck.J_NOP).sum()) for t in jlu.tapes)
    assert rt.stat.counters["fill_blocks"] == rj.stat.counters["fill_blocks"]
    assert rt.stat.tiny_pivots == rj.stat.tiny_pivots
    assert rt.berr.max() <= 1e-12 and rj.berr.max() <= 1e-12
    assert np.abs(rt.x - rj.x).max() <= 1e-10 * np.abs(rj.x).max()
    assert np.abs(A @ rt.x - b).max() / np.abs(b).max() < 1e-10


@pytest.mark.parametrize("bs", [32, 64])
def test_tck_one_block_column(bs):
    """A matrix of one block column (lap3d4 at bs 64, n = 64) has no U
    block and no product: the tapes are empty, and ``executor="tck"``
    solves it as clk does, bit for bit."""
    A = laplacian_3d(4).tocsc()
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    rt, lu = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                      executor="tck"), device="cpu")
    rc, _ = T.gssvx(A, b, T.Options(dtype="float32", block_size=bs,
                                    executor="clk"), device="cpu")
    tp = lu._ftapes
    if lu.plan.nb == 1:
        assert len(tp.host["tiles"]) == 0 and int(tp.lwave[-1]) == 0
    assert rt.berr.max() <= 1e-12
    assert np.array_equal(rt.x, rc.x)
