"""Solver options, enums, and the tuning-parameter oracle.

A field-for-field copy of the JAX package's options, so both packages
build the same plan from the same Options. Analog of the reference's
three-tier config system:
  1. ``superlu_dist_options_t`` struct + ``set_default_options_dist``
     (reference: SRC/include/superlu_defs.h:684-728, SRC/prec-independent/util.c)
  2. ``sp_ienv_dist`` tuning oracle consulting env vars first, then options
     (reference: SRC/prec-independent/sp_ienv.c:81-179)
  3. per-run keyword overrides.

Here tier (1) is the :class:`Options` dataclass, tier (2) is :func:`sp_ienv`
reading ``SLU_TPU_*`` environment variables, tier (3) is ``dataclasses.replace``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Optional


class Fact(enum.Enum):
    """Factorization staging / reuse modes.

    Mirrors ``fact_t`` (reference: SRC/include/superlu_enum_consts.h:30,
    superlu_defs.h:545-566):

    - DOFACT: factor from scratch.
    - SAME_PATTERN: reuse column permutation + elimination tree + symbolic
      structure; matrix values (and row permutation) may differ.
    - SAME_PATTERN_SAME_ROWPERM: additionally reuse row permutation and
      scalings; only numeric values differ.
    - FACTORED: L/U already computed; only solve (+ refinement).
    """

    DOFACT = "DOFACT"
    SAME_PATTERN = "SamePattern"
    SAME_PATTERN_SAME_ROWPERM = "SamePattern_SameRowPerm"
    FACTORED = "FACTORED"


class RowPerm(enum.Enum):
    """Row permutation strategy (``rowperm_t``, superlu_enum_consts.h:32)."""

    NOROWPERM = "NOROWPERM"
    LARGE_DIAG_MC64 = "LargeDiag_MC64"   # serial weighted bipartite matching
    LARGE_DIAG_HWPM = "LargeDiag_HWPM"   # parallel heavy-weight perfect matching
    MY_PERMR = "MY_PERMR"                # user-supplied perm_r


class ColPerm(enum.Enum):
    """Fill-reducing column ordering (``colperm_t``, superlu_enum_consts.h:31,
    dispatch at SRC/prec-independent/get_perm_c.c:500-546)."""

    NATURAL = "NATURAL"
    MMD_ATA = "MMD_ATA"                  # minimum degree on A^T A
    MMD_AT_PLUS_A = "MMD_AT_PLUS_A"      # minimum degree on A^T + A
    COLAMD = "COLAMD"                    # approximate column minimum degree
    METIS_AT_PLUS_A = "METIS_AT_PLUS_A"  # nested dissection on A^T + A
    PARMETIS = "PARMETIS"                # parallel nested dissection
    MY_PERMC = "MY_PERMC"                # user-supplied perm_c


class Trans(enum.Enum):
    """Transpose mode (``trans_t``)."""

    NOTRANS = "N"
    TRANS = "T"
    CONJ = "C"


class IterRefine(enum.Enum):
    """Iterative refinement mode (``IterRefine_t``).

    SLU_SINGLE/SLU_DOUBLE select the residual precision; SLU_EXTRA is mapped
    to double here (the reference treats it similarly). The mixed-precision
    path (factor in low precision, refine with a higher-precision residual)
    mirrors psgssvx_d2 (reference: SRC/single/psgssvx_d2.c:516).
    """

    NOREFINE = "NOREFINE"
    SLU_SINGLE = "SINGLE"
    SLU_DOUBLE = "DOUBLE"


class Equil(enum.Enum):
    NO = "NO"
    YES = "YES"


class DiagScale(enum.Enum):
    """Which equilibration was applied (``DiagScale_t``)."""

    NOEQUIL = "N"
    ROW = "R"
    COL = "C"
    BOTH = "B"


@dataclasses.dataclass
class Options:
    """Solver options — analog of ``superlu_dist_options_t``
    (reference: SRC/include/superlu_defs.h:684-728) with the tuning knobs
    of the JAX package. Fields that only steer JAX-package executors
    (tck/flk/pallas, the distributed drivers) are kept for plan parity.
    """

    fact: Fact = Fact.DOFACT
    equil: Equil = Equil.YES
    row_perm: RowPerm = RowPerm.LARGE_DIAG_MC64
    col_perm: ColPerm = ColPerm.METIS_AT_PLUS_A
    trans: Trans = Trans.NOTRANS
    iter_refine: IterRefine = IterRefine.SLU_DOUBLE
    replace_tiny_pivot: bool = True
    solve_only: bool = False           # treat input as prefactored (superlu_defs.h:696)
    diag_inv: bool = True              # precompute block-diagonal inverses
                                       # (mirrors pdCompute_Diag_Inv, pdgstrs.c:842);
                                       # this makes every solve step a GEMM.
    print_stat: bool = False
    condition_number: bool = False     # estimate rcond during gssvx
                                       # (options.ConditionNumber analog)

    # ---- tuning (tier-2 defaults; overridable via SLU_TPU_* env) ----
    block_size: int = 64               # elimination block width (MAXSUP analog);
                                       # multiple of 8; the CUDA kernels take
                                       # 32, 64 or 128.
    gemm_chunk: int = 32               # batched-GEMM chunk per tape macro-op
    lookahead: int = 0                 # pipeline depth (reserved; XLA overlaps
                                       # collectives inside the fori_loop)
    max_refine_steps: int = 20         # ITMAX (reference: SRC/double/pdgsrfs.c:131)
    refine_rthresh: float = 0.5        # stop if berr not halved (pdgsrfs.c:237)
    executor: Optional[str] = None     # "clk" | "tck" | "flk" | "pallas" | "xla";
                                       # None = auto (clk, falling back)
    clk_mc: int = 8                    # clk A-range rows per pair chunk
    flk_kc: int = 8                    # flk contribution lanes per window
    diag_chunk: int = 4                # distributed diag LU batch width
    dist_executor: str = "xla"         # "xla" (per-level collectives) |
                                       # "rdma" (fused kernel + remote DMA
                                       # panel broadcasts; f32 only)
    anc25d: str = "replicated"         # 3D top-level strategy: ancestors
                                       # "replicated" (redundant compute,
                                       # no z-comm) | "zsplit" (gemms
                                       # split over z + per-level z-psum;
                                       # the anc25d.hpp analog)

    # dtype of the factorization pool: "float32" | "float64" | "complex64"
    # | "complex128" | "bfloat16". The reference's s/d/c/z precisions.
    dtype: str = "float32"
    # dtype for residuals in iterative refinement (mixed precision analog of
    # psgssvx_d2); None → same as dtype promoted to double-width.
    refine_dtype: Optional[str] = None

    # user-supplied permutations, used with ColPerm.MY_PERMC /
    # RowPerm.MY_PERMR (the reference reads these from ScalePermstruct,
    # pdgssvx.c "perm_c/perm_r input" contract). perm[k] = k-th
    # column/row to eliminate.
    user_colperm: object = None
    user_rowperm: object = None

    # etree-aligned block boundaries (ops/host/align.py): "auto" aligns
    # whenever the expansion stays under align_max_inflate (recovers the
    # supernodal-etree schedule parallelism, reference:
    # supernodal_etree.c:32-1099); "off" keeps position blocking.
    align_blocks: str = "auto"         # "auto" | "on" | "off"
    align_max_inflate: float = 1.5     # max padded-dimension growth factor

    # Schur-GEMM pass precision. In the JAX package "auto" factors with
    # one-pass bf16 GEMMs when refinement is on and re-factors at
    # "highest" when refinement stalls (the psgssvx_d2 escalation,
    # reference: SRC/single/psgssvx_d2.c:516-1584). The PyTorch port's
    # kernels compute in IEEE FP32 only, so there "auto" resolves to
    # "highest" and the escalation never fires.
    gemm_precision: str = "auto"       # "auto" | "bf16" | "highest"

    # adaptive plan policy (irregular-matrix guard): when the block plan's
    # pad ratio (device flops / scalar-structure estimate) exceeds
    # adapt_pad_max, or its pool exceeds the HBM budget, the driver
    # retries alternative column orderings (and block sizes for budget
    # overruns) and keeps the cheapest plan, logging every decision in
    # stat.counters["adapt_*"]. "off" keeps the first plan unconditionally.
    adapt_policy: str = "auto"         # "auto" | "off"
    adapt_pad_max: float = 48.0        # flop-pad trigger (vs GNP estimate)
    hbm_budget_gb: float = 14.5        # device pool budget of the adaptive
                                       # plan policy; kept at the JAX
                                       # package's default so both packages
                                       # pick the same plan

    # Distributed planning (psymbfact/get_perm_c_parmetis role, reference:
    # SRC/prec-independent/psymbfact.c:26-5380): with sharded NRLoc input,
    # NO process — including process 0 — ever assembles the global scalar
    # pattern or values. Each process maps its local entries to block
    # keys; only the deduplicated BLOCK pattern (O(a_blocks) keys, orders
    # of magnitude smaller than nnz) is allgathered, and every process
    # derives the identical plan from it. Requires equil=NO,
    # row_perm ∈ {NOROWPERM, MY_PERMR}, col_perm ∈ {NATURAL, MY_PERMC}
    # (the same contract as the reference's parallel-symbolic path, which
    # also runs only under externally-supplied orderings), and implies
    # align_blocks=off (the alignment pass reads the scalar pattern).
    dist_planning: bool = False

    batch_count: int = 0               # >0 for the batched interface
    # level-based incomplete factorization (ILU(k) analog of
    # ilu_level_symbfact); None = complete LU. The factorization becomes a
    # preconditioner: refine() turns into a preconditioned Richardson
    # iteration rather than converging in O(1) steps.
    ilu_level: Optional[int] = None

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


def set_default_options() -> Options:
    """Analog of ``set_default_options_dist`` (util.c)."""
    return Options()


_ENV_PREFIX = "SLU_TPU_"

def _as_bool(s):
    return str(s).strip().lower() in ("1", "true", "yes", "y", "on")


# Mapping from sp_ienv-style spec names to Options fields; the analog of
# the reference's spec table + SUPERLU_* env surface (sp_ienv.c:81-179,
# which reads SUPERLU_MAXSUP, SUPERLU_RELAX, SUPERLU_NUM_LOOKAHEADS,
# SUPERLU_N_GEMM, SUPERLU_MAX_BUFFER_SIZE, SUPERLU_ACC_OFFLOAD, ...).
_SPEC_FIELDS = {
    # elimination structure
    "BLOCK_SIZE": ("block_size", int),       # MAXSUP analog (SUPERLU_MAXSUP)
    "ILU_LEVEL": ("ilu_level", int),         # ILU(k) drop level
    "ALIGN": ("align_blocks", str),          # etree-aligned blocks (auto|on|off)
    "ALIGN_MAX_INFLATE": ("align_max_inflate", float),
    "GEMM_PRECISION": ("gemm_precision", str),  # auto | bf16 | highest
    "DIST_PLANNING": ("dist_planning", _as_bool),  # sharded-pattern plans
    "ADAPT_POLICY": ("adapt_policy", str),   # auto | off (pad-ratio guard)
    "ADAPT_PAD_MAX": ("adapt_pad_max", float),
    "HBM_BUDGET_GB": ("hbm_budget_gb", float),
    # executor selection & shape
    "EXECUTOR": ("executor", str),           # clk | flk | pallas | xla
    "DIST_EXECUTOR": ("dist_executor", str),  # xla | rdma
    "ANC25D": ("anc25d", str),               # replicated | zsplit (3D top)
    "GEMM_CHUNK": ("gemm_chunk", int),       # batching granularity
    "CLK_MC": ("clk_mc", int),               # clk pair-chunk rows
    "FLK_KC": ("flk_kc", int),               # flk window lanes
    "DIAG_CHUNK": ("diag_chunk", int),       # distributed diag batch
    "LOOKAHEAD": ("lookahead", int),         # SUPERLU_NUM_LOOKAHEADS analog
    # numerics
    "REPLACE_TINY_PIVOT": ("replace_tiny_pivot", _as_bool),
    "EQUIL": ("equil", lambda s: Equil.YES if _as_bool(s) else Equil.NO),
    "ROWPERM": ("row_perm", RowPerm),
    "COLPERM": ("col_perm", ColPerm),
    "DTYPE": ("dtype", str),
    "REFINE_DTYPE": ("refine_dtype", str),
    "MAX_REFINE_STEPS": ("max_refine_steps", int),
    "REFINE_RTHRESH": ("refine_rthresh", float),
    "DIAG_INV": ("diag_inv", _as_bool),
    "CONDITION_NUMBER": ("condition_number", _as_bool),
    "PRINT_STAT": ("print_stat", _as_bool),
}

#: Environment variables without an Options field (read where used):
#:   SLU_TPU_NATIVE         0 | 1            (C++ host engine)
#:   SLU_TPU_SYMB_THREADS   N                (parallel symbolic threads)
_ENV_ONLY = ("NATIVE", "SYMB_THREADS")


def sp_ienv(spec: str, options: Optional[Options] = None):
    """Tuning-parameter oracle: env var first, then options, then default.

    Analog of ``sp_ienv_dist`` (reference: SRC/prec-independent/sp_ienv.c:81-179),
    which consults ``SUPERLU_*`` env vars before the options struct.
    ``spec`` is a key of ``_SPEC_FIELDS`` (e.g. BLOCK_SIZE, EXECUTOR,
    REPLACE_TINY_PIVOT); the env var is ``SLU_TPU_<spec>``.
    """
    field, conv = _SPEC_FIELDS[spec]
    env = os.environ.get(_ENV_PREFIX + spec)
    if env is not None:
        return conv(env)
    opts = options or Options()
    return getattr(opts, field)


def apply_env_overrides(options: Options) -> Options:
    """Fold every set ``SLU_TPU_*`` spec var into an Options copy (the
    tier-2 pass the drivers run once at entry)."""
    kw = {}
    for spec, (field, conv) in _SPEC_FIELDS.items():
        env = os.environ.get(_ENV_PREFIX + spec)
        if env is not None:
            kw[field] = conv(env)
    return dataclasses.replace(options, **kw) if kw else options


def print_options(options: Options) -> str:
    """Analog of ``print_options_dist`` (util.c:256-278)."""
    lines = ["**************************************************",
             ".. options:"]
    for f in dataclasses.fields(options):
        v = getattr(options, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        lines.append(f"**    {f.name:<22}: {v}")
    lines.append("**************************************************")
    return "\n".join(lines)
