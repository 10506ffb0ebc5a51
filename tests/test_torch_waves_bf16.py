"""The bf16 wave kernel's geometry (``csrc/waves.cuh``'s ``WaveMma``) as
the host chooses it per wave (``clk.wave_geom``, ``clk.wave_geoms``):
strips of 16 columns and a deep ring where a wave's CTAs would leave SMs
idle, the widest strip that still fills them at the FP32 kernel's depth
elsewhere, and the shared memory that each choice implies, mirrored from
``WaveMma::bytes``. The kernel itself is held to the plain version on the
card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from superlu_dist_tpu_torch.ops.host.symbolic import block_symbolic
from superlu_dist_tpu_torch.ops.kernels import clk, tck
from superlu_dist_tpu_torch.utils import testing as tt

BLOCK_SIZES = (32, 64, 128)


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_every_choice_fits_a_cta(bs):
    """Every geometry the host may choose takes at most 227 KiB, a
    ring of at least two stages, and a strip width that divides bs; the
    deepest ring of each width is the deepest that fits (or WAVE_DEEP)."""
    choices = clk.wave_geom_choices(bs)
    assert (16, clk.wave_max_stages(bs, 16)) in choices
    assert (16, clk.WAVE_SHALLOW) in choices
    for tn, st in choices:
        assert tn in clk.WAVE_WIDTHS and bs % tn == 0
        assert 2 <= st <= clk.wave_max_stages(bs, tn)
        assert clk.wave_mma_bytes(bs, tn, st) <= 227 * 1024
    for tn in clk.WAVE_WIDTHS:
        if tn > bs:
            continue
        top = clk.wave_max_stages(bs, tn)
        assert clk.wave_mma_bytes(bs, tn, top) <= clk.CTA_SMEM_MAX
        assert top == clk.WAVE_DEEP or \
            clk.wave_mma_bytes(bs, tn, top + 1) > clk.CTA_SMEM_MAX


def test_shared_memory_bytes():
    """WaveMma::bytes at bs 128: a stage is an L box of 128 rows of 32
    floats, a U box of 32 rows of tn floats and two 8-byte mbarriers; then
    1024 bytes to align the ring, and the finalize operand, tn rows of 136
    bf16."""
    assert clk.wave_stage_bytes(128, 16) == (128 * 32 + 32 * 16) * 4 + 16
    assert clk.wave_mma_bytes(128, 16, 8) == 8 * 18448 + 1024 + 16 * 136 * 2
    assert clk.wave_mma_bytes(128, 64, 3) == 3 * 24592 + 1024 + 64 * 136 * 2
    assert clk.wave_max_stages(128, 16) == 8
    assert clk.wave_max_stages(128, 64) == 8


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("sms", [132, 114])
def test_wave_geom_rule(bs, sms):
    """Narrow waves (strips of 16 would give fewer CTAs than SMs) take
    strips of 16 and the deepest ring; the others the widest strip whose
    CTAs still give WAVE_FILL an SM (16 where none does), at WAVE_SHALLOW
    stages."""
    fill = clk.WAVE_FILL * sms
    for n in range(1, 4 * fill):
        tn, st = clk.wave_geom(bs, n, sms)
        if n * (bs // 16) < sms:
            assert (tn, st) == (16, clk.wave_max_stages(bs, 16)), n
            continue
        assert st == clk.WAVE_SHALLOW, n
        assert tn == 16 or n * (bs // tn) >= fill, n
        wider = [w for w in clk.WAVE_WIDTHS if tn < w <= bs]
        assert all(n * (bs // w) < fill for w in wider), n
    # bs 128 on an H100: 16 up to 131 targets, 32 from 132 (4 CTAs an
    # SM), 64 from 264
    if bs == 128 and sms == 132:
        assert [clk.wave_geom(128, n)[0]
                for n in (16, 17, 131, 132, 263, 264)] == \
            [16, 16, 16, 32, 32, 64]


@pytest.mark.parametrize("executor", ["clk", "tck"])
def test_wave_geoms_on_tapes(executor):
    """wave_geoms gives one code (strip width << 8 | ring depth) per wave
    of clk's tapes and of tck's phase-A tapes, each wave_geom of the
    wave's target count, and caches it per block size."""
    bs = 32
    plan = block_symbolic(tt.laplacian_3d(8).tocsc(), bs)
    tp = (clk.build_clk_tapes(plan, "cpu") if executor == "clk"
          else tck.build_tck_tapes(plan, "cpu"))
    g = clk.wave_geoms(tp, bs)
    assert g.dtype == np.int32 and len(g) == int(tp.lwave[-1])
    for w, code in enumerate(g):
        n = int(tp.wptr[w + 1] - tp.wptr[w])
        assert (int(code) >> 8, int(code) & 255) == clk.wave_geom(bs, n)
    assert clk.wave_geoms(tp, bs) is g


@pytest.mark.parametrize("geom", [(8, 3), (64, 3), (16, 1), (16, 9),
                                  (32, 9)])
def test_launch_rejects_a_geometry_it_cannot_take(geom):
    """A forced geometry outside the kernel's (a width it has no code
    for, wider than the block, or a ring outside 2 .. wave_max_stages) is
    refused before anything launches."""
    bs = 32
    plan = block_symbolic(tt.laplacian_3d(6).tocsc(), bs)
    tp = clk.build_clk_tapes(plan, "cpu")
    pool = torch.zeros((plan.nslots, bs, bs))
    linv = torch.zeros((plan.nb, bs, bs))
    with pytest.raises(ValueError, match="wave geometry"):
        clk.launch_waves(clk.UPDATE_BF16, "slu_clk_waves_bf16", pool, linv,
                         tp, 0, geom)
    with pytest.raises(ValueError, match="wave geometry"):
        clk.launch_waves(clk.UPDATE, "slu_clk_waves_f32", pool, linv, tp, 0,
                         (16, 3))
