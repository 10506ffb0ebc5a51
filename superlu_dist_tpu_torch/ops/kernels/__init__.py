"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version."""


def cuda_kernels() -> dict:
    """Every hand-written CUDA kernel of the port, by the name its
    launch counter carries (``CudaKernel.name``): the single-device
    factor's and solves' kernels (the bf16 passes of clk, tck and flk
    counted apart, as ``*_bf16``), the grid's (``rdma.cu``) and the
    batch's (``*_batch``). ``utils.prewarm`` builds them all and
    ``chip_smoke.py`` checks each against its plain version."""
    from ...parallel import dist2d_rdma as rdma
    from . import clk, diag_lu, flk, schur, solve_gemm, tck
    return {k.name: k for k in (
        diag_lu.KERNEL, clk.UPDATE, clk.TRSM, clk.UPDATE_BF16,
        clk.TRSM_BF16, solve_gemm.SWEEP, flk.KERNEL, schur.SCHUR,
        schur.TRSM, solve_gemm.SOLVE_GEMM, solve_gemm.DIAG_APPLY,
        tck.UPDATE, tck.UPDATE_BF16, flk.KERNEL_BF16, rdma.RDMA_FACTOR,
        rdma.RDMA_SOLVE,
        diag_lu.DIAG_LU_BATCH, schur.TRSM_BATCH, schur.SCHUR_BATCH,
        solve_gemm.SWEEP_BATCH)}
