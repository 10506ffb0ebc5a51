"""The geometry of ``csrc/passes.cuh``'s bf16 chain product (``ChainMma``,
which flk's bf16 pass and tck's bf16 phase B run) as the host mirrors it
(``flk.chain_mma_bytes``): every band geometry that chain.cuh's
``by_geometry`` may choose at bs 32, 64 and 128 fits a CTA's shared
memory with two CTAs an SM. The kernels themselves are held to their
plain versions on the card (``tests/test_torch_cuda.py``)."""

import pathlib

import pytest

from superlu_dist_tpu_torch.ops.kernels import flk

CSRC = pathlib.Path(flk.__file__).parent / "csrc"
#: the band widths chain.cuh's by_geometry takes at each block size (bs
#: 32 the whole block; bs 64 and 128 bands of 16 or 64)
BANDS = {32: (32,), 64: (16, 64), 128: (16, 64)}


@pytest.mark.parametrize("bs,bm", [(bs, bm) for bs, bms in BANDS.items()
                                   for bm in bms])
def test_every_band_geometry_fits(bs, bm):
    """At most 113 KiB a CTA, so that two CTAs (and the card's 1 KiB
    each) share an SM's 228 KiB, within the 227 KiB that one CTA may
    take."""
    nbytes = flk.chain_mma_bytes(bs, bm)
    assert 0 < nbytes <= flk.HALF_SM_SMEM < 227 * 1024
    assert 2 * (nbytes + 1024) <= 228 * 1024


def test_shared_memory_bytes():
    """ChainMma::kBytes: 3 stages in bands of 64, else 4; a stage is the
    larger orientation's chunk (A's block or band in rows of 36 floats,
    then 32 rows of B padded by 4 floats); then the band, bm rows of
    bs + 4 floats."""
    assert flk.chain_mma_bytes(128, 64) == 4 * (
        3 * (128 * 36 + 32 * 68) + 64 * 132)
    assert flk.chain_mma_bytes(128, 16) == 4 * (
        4 * (128 * 36 + 32 * 20) + 16 * 132)
    assert flk.chain_mma_bytes(64, 16) == 4 * (
        4 * (64 * 36 + 32 * 20) + 16 * 68)
    assert flk.chain_mma_bytes(32, 32) == 4 * (4 * (32 * 36 + 32 * 36)
                                               + 32 * 36)
    assert flk.chain_mma_bytes(128, 64) == 115200


def test_mirror_matches_the_source():
    """The stages and rows the mirror assumes are the sources': chain.cuh
    takes 3 stages for bands of 64 with a finalize, passes.cuh keeps the
    band in rows of BS + 4 and asserts the 113 KiB."""
    chain = (CSRC / "chain.cuh").read_text()
    passes = (CSRC / "passes.cuh").read_text()
    assert "constexpr int STW = FIN ? 3 : 4;" in chain
    assert "static constexpr int LDT = G::BS + 4;" in passes
    assert 'static_assert(kBytes <= 113 * 1024, "shared memory: two CTAs ' \
        'per SM");' in passes
