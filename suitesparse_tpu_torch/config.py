"""Runtime configuration of the port.

The fields of the JAX package's ``Config`` that the port reads, with the
same defaults (the reference's numerical contract, ``cholmod_core.h:456-510``),
plus the port's own knobs ``solve_mode`` and ``segment_bytes`` and the
fields that stand for the reference's opt-in kernel switches
(``tile_pair``, ``solve_pmv``, ``solve_bmv``). The port takes no
``SSTPU_*`` environment variables.

The reference's fields that no code of the reference reads are left out:
``accum_dtype``, ``grow_ratio``, ``leaf_batch``, ``lu_memgrow``,
``nd_components``, ``nd_oksep``, ``panel_pad``, ``sublane_pad``,
``umf_block_size``, ``umf_pivot_tol``, ``umf_sym_pivot_tol`` and
``use_pallas``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Sequence


class Ordering(enum.Enum):
    """Fill-reducing ordering method (reference ``cholmod_core.h:599-623``)."""

    NATURAL = "natural"
    AMD = "amd"
    COLAMD = "colamd"     # column order of A'A for QR, without forming A'A
    METIS = "nd"          # nested dissection (METIS_NodeND analog)
    NESDIS = "nesdis"     # taken by the same nested dissection here
    BEST = "best"         # AMD and ND, keep lowest nnz(L)


class FactorKind(enum.Enum):
    """What kind of factorization to compute."""

    SIMPLICIAL_LL = "simplicial_ll"
    SIMPLICIAL_LDL = "simplicial_ldl"
    SUPERNODAL_LL = "supernodal_ll"
    AUTO = "auto"  # supernodal iff flops/nnz(L) >= supernodal_switch


SOLVE_MODES = ("auto", "classic", "inv")


@dataclasses.dataclass
class Config:
    """Every knob of the port, with reference-parity defaults."""

    # ----- Cholesky analysis -----
    ordering: Ordering = Ordering.AMD
    factor_kind: FactorKind = FactorKind.AUTO
    # supernodal iff fl/lnz >= this (reference cholmod_core.h:456-463)
    supernodal_switch: float = 40.0
    # relaxed supernode amalgamation (reference cholmod_core.h:495-510)
    nrelax: Sequence[int] = (4, 16, 48)
    zrelax: Sequence[float] = (0.8, 0.1, 0.05)
    # bound on D entries for LDL' (cholmod_core.h:420-430)
    dbound: float = 0.0

    # ----- AMD (reference amd.h:316-320 Control[]) -----
    amd_dense: float = 10.0          # rows with deg > dense*sqrt(n) postponed
    amd_aggressive: bool = True      # aggressive absorption

    # ----- COLAMD (reference colamd.h knobs) -----
    # rows with more than max(16, dense_row * sqrt(n)) entries, and columns
    # with more than max(16, dense_col * sqrt(min(m, n))), are set aside
    colamd_dense_row: float = 10.0
    colamd_dense_col: float = 10.0

    # ----- nested dissection (reference cholmod_core.h:702-731) -----
    nd_small: int = 200              # stop dissecting below this many nodes

    # ----- LU (reference klu_defaults.c:20-32, umfpack.h:261-300) -----
    lu_pivot_tol: float = 0.001      # diagonal-preference threshold (klu tol)
    lu_btf: bool = True              # block triangular form first
    # maxtrans work budget, multiples of nnz; <= 0 = unlimited (klu maxwork,
    # reference btf.h:206)
    btf_work_limit: float = -1.0
    lu_scale: int = 2                # 0 none, 1 row-sum, 2 row-max (klu scale)
    halt_if_singular: bool = True
    ir_steps: int = 2                # iterative-refinement sweeps (IRSTEP)

    # ----- QR (reference spqr_tol.cpp:23) -----
    # rank-detection tolerance; <0 means 20*(m+n)*eps*max column 2-norm
    qr_tol: float = -1.0

    # ----- device execution -----
    compute_dtype: str = "float32"   # factor and solve dtype on the device
    # store child update matrices in bfloat16 (halves extend-add traffic and
    # the memory the live updates hold; fronts/panels stay in compute_dtype,
    # accumulation is in compute_dtype). Pair with solve-side iterative
    # refinement (solve_refined) to recover fp32-class residuals. Any other
    # value means compute_dtype.
    update_dtype: str = "float32"
    # "highest": true fp32 matmuls (TF32 off inside each call)
    precision: str = "highest"
    # multifrontal solve sweep of a device factor:
    #   "auto"    the w2 sweep (stacked inverse panels W2 = [L11^-1 ;
    #             L21 L11^-1], one batched matmul per group and sweep, one
    #             extra factor-sized copy built at the first solve) where W2
    #             fits in the device memory, else the classic sweep;
    #   "classic" triangular solves on the factor's panels (K3 solve_step
    #             and K4 trisolve kernels), no inverse panels;
    #   "inv"     inverse panels without W2: W = L11^-1 a group (a C x C
    #             copy, built at the first solve), each step two batched
    #             matvecs (W, then the factor's L21), with K6 under
    #             solve_bmv. "auto" does not take it (ROADMAP item 4).
    #   Every mode runs on the coarse solve plan, over a copy of the factor
    #   relaid into it, where that copy fits in the device memory, else on
    #   the factor's own plan (numeric/supernodal_solve.solve_ladder).
    solve_mode: str = "auto"
    # opt-in kernel routes, the counterparts of the reference's
    # SSTPU_TILE_PAIR, SSTPU_SOLVE_PMV and SSTPU_SOLVE_BMV (all default off):
    #   tile_pair  two pieces per tiled extend-add step (K2b kernel);
    #   solve_pmv  w2 groups with B <= 32 and big panels apply W2 through
    #              the streaming panel matvec (K5; keeps W2^T as well);
    #   solve_bmv  w2 groups with B >= 32 apply W2 through the batched
    #              matvec (K6), and the inv sweep's groups with B >= 32
    #              apply W and L21 through it.
    tile_pair: bool = False
    solve_pmv: bool = False
    solve_bmv: bool = False
    # segmented execution of the device factors (the Cholesky, the QR and
    # the unsymmetric LU; the counterpart of the reference's SSTPU_SEGMENT
    # and SSTPU_SEG_CELLS), in bytes of what a factor holds beyond its
    # output (index arrays, one group's front and workspace):
    #   0         auto: on a CUDA device a share of the free memory at call
    #             time (numeric/segmented.py, AUTO_SHARE); on the CPU the
    #             factor always runs in one piece;
    #   positive  the budget itself: a factor whose one-piece estimate
    #             passes it runs in segments that each stay under it.
    segment_bytes: int = 0

    # ----- diagnostics -----
    check_inputs: bool = True        # assert the analysis input is sym=1
    record_stats: bool = True        # lnz, fl, anz into stats.GLOBAL_STATS

    # ----- failure handling (reference cholmod_core.h:565-573) -----
    error_handler: Callable[[str], None] | None = None

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
