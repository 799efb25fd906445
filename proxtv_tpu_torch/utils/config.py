"""Solver configuration: the reference's compile-time tolerance table as dataclasses.

The reference hard-codes every tolerance and iteration cap as a preprocessor
constant (``src/TVopt.h:24-85``, ``src/LPopt.h:22-38``).  Here they are lifted into
frozen dataclasses so callers can override per call while the defaults replicate the
reference contract exactly.  Same names and defaults as the JAX package's
``proxtv_tpu.utils.config`` (plain data, copied so the port imports nothing of it).
"""
from __future__ import annotations

import dataclasses

# Global numeric tolerance (reference src/general.h:64)
EPSILON = 1e-10


@dataclasses.dataclass(frozen=True)
class TV1Config:
    """TV-L1 projected-Newton solver settings (reference src/TVopt.h:27-31)."""

    stop: float = 1e-6          # STOP_PN: duality-gap stopping tolerance
    sigma: float = 0.05         # SIGMA: Armijo sufficient-descent parameter
    max_iters: int = 100        # MAX_ITERS_PN
    max_armijo: int = 30        # bound on inner stepsize-search iterations


@dataclasses.dataclass(frozen=True)
class TV2Config:
    """TV-L2 More-Sorensen / projected-gradient settings (src/TVopt.h:36-39)."""

    stop: float = 1e-5          # STOP_MS: duality gap
    stop_boundary: float = 1e-6  # STOP_MSSUB: distance to the constraint boundary
    max_iters: int = 100        # MAX_ITERS_MS
    pg_step: float = 0.25       # fixed PG stepsize (1/L, src/TVL2opt.cpp:476 STEP)
    pg_max_iters: int = 100000  # MAX_PG for the pure-PG solver (src/TVL2opt.cpp:477)
    mspg_pg_iters: int = 50     # PG attempts before falling back to MS (src/TVL2opt.cpp:254)


@dataclasses.dataclass(frozen=True)
class TVpConfig:
    """TV-Lp dual solver settings (src/TVopt.h:44-66)."""

    stop: float = 1e-5              # STOP_TVLP: duality gap
    max_iters: int = 10000          # MAX_ITERS_TVLP (GP/OGP/FISTA)
    max_iters_fw: int = 1000000     # MAX_ITERS_TVLPFW / MAX_ITERS_TVLPGPFW
    max_noimp: int = 10             # MAX_NOIMP_TVLP
    inner_objgap: float = 1e-15     # OBJGAP_LPPROX_TVLP: accuracy of inner Lp prox
    fw_cycles: int = 10             # FW_CYCLES_TVLP: FW steps per GP step in hybrid
    min_imp: float = 1e-10          # MIN_IMP_TVLP
    stop_step_fw: float = 1e-15     # STOP_STEP_TVLP_FW
    p_gp_only: float = 10.0         # GPFW falls back to GP for p above this (TVLPopt.cpp:1144)


@dataclasses.dataclass(frozen=True)
class LPpConfig:
    """Inner Lp-prox projected-Newton settings (src/LPopt.h:22-38)."""

    stop_gap: float = 1e-5      # STOP_GAP_PNLP
    stop_rel: float = 1e-5      # STOP_PNLP: relative objective change stop
    max_iters: int = 1000       # MAX_ITERS_PNLP
    sigma: float = 0.05         # SIGMA_PNLP: Armijo parameter
    epsilon: float = 1e-15      # EPSILON_PNLP: active-set zero threshold
    min_step: float = 1e-10     # MIN_STEP_PNLP
    p_small: float = 1.002      # LPPROJ_PSMALL: treat p below this as L1
    p_large: float = 100.0      # LPPROJ_PLARGE: treat p above this as Linf
    max_armijo: int = 60        # bound on inner Armijo iterations


@dataclasses.dataclass(frozen=True)
class CombinerConfig:
    """Multidimensional proximal-combiner settings (src/TVopt.h:71-85)."""

    stop: float = 1e-6              # STOP_PD: mean absolute change
    max_iters_pd: int = 35          # MAX_ITERS_PD
    max_iters_dr: int = 35          # MAX_ITERS_DR
    max_iters_yang: int = 35        # MAX_ITERS_YANG
    max_iters_condat: int = 2500    # MAX_ITERS_CONDAT
    stop_condat: float = 0.0        # STOP_CONDAT (disabled in reference)
    max_iters_kolmogorov: int = 2500  # MAX_ITERS_KOLMOGOROV
    stop_kolmogorov: float = 0.0    # STOP_KOLMOGOROV (disabled in reference)
    yang_rho: float = 10.0          # ADMM rho (src/TV2Dopt.cpp:807)
    cp_sigma: float = 10.0          # Chambolle-Pock sigma (src/TV2Dopt.cpp:610)
    pdhg_gap_tol: float = 1e-5      # fused-PDHG per-image relative duality-gap stop


DEFAULT_TV1 = TV1Config()
DEFAULT_TV2 = TV2Config()
DEFAULT_TVP = TVpConfig()
DEFAULT_LPP = LPpConfig()
DEFAULT_COMBINER = CombinerConfig()
