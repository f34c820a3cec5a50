"""Host float64 control of the coded matmul: codes, decode solves, β rules,
straggler models, the block split and the Monte-Carlo engine.

A copy of the reference package's pure-numpy ``core`` modules (the port
imports nothing from the reference), plus a tensor ``split_contraction``
that returns strided views for the device encode.
"""
from .beta import (eq5_beta, group_beta, layer_beta, thm1_beta, thm1_moments,
                   thm2_beta, thm2_gammas)
from .codes.base import CDCCode, DecodeInfo
from .codes.group_sac import GroupSACCode, group_thresholds
from .codes.lagrange import LagrangeCode
from .codes.layer_sac import LayerSACCode, clustered_points
from .codes.matdot import EpsApproxMatDotCode, MatDotCode
from .codes.orthomatdot import OrthoMatDotCode
from .partition import block_outer_products, split_contraction
from .points import x_complex, x_equal
from .poly import (ChebyshevBasis, LagrangeBasis, MappedChebyshevBasis,
                   MonomialBasis, chebyshev_roots)
from .registry import (CODE_NAMES, make_code, make_code_from_spec,
                       paper_fig3a_codes, restrict_code)
from .simulate import (BatchErrorCurves, ErrorCurves, ProblemContext,
                       SimulationEngine, average_curves,
                       average_curves_reference, correlated_problem,
                       random_problem, run_trace, run_trace_reference)
from .solve import (condition_number, extraction_weights,
                    extraction_weights_batch, fit_coefficients)
from .straggler import (LATENCY_MODELS, CompletionBatch, CompletionTrace,
                        sample_times, shifted_exp_times, simulate_completion,
                        simulate_completion_batch, validate_latency_kw)

__all__ = [
    "CDCCode", "DecodeInfo", "MatDotCode", "EpsApproxMatDotCode",
    "OrthoMatDotCode", "LagrangeCode", "GroupSACCode", "LayerSACCode",
    "group_thresholds", "clustered_points", "make_code", "CODE_NAMES",
    "paper_fig3a_codes", "restrict_code", "make_code_from_spec", "x_equal",
    "x_complex", "split_contraction", "block_outer_products", "thm1_beta",
    "thm1_moments", "thm2_beta", "thm2_gammas", "group_beta", "layer_beta",
    "eq5_beta", "extraction_weights", "extraction_weights_batch",
    "fit_coefficients", "condition_number", "CompletionTrace",
    "CompletionBatch", "simulate_completion", "simulate_completion_batch",
    "LATENCY_MODELS",
    "sample_times", "shifted_exp_times", "validate_latency_kw",
    "chebyshev_roots", "MonomialBasis", "ChebyshevBasis",
    "MappedChebyshevBasis", "LagrangeBasis", "ErrorCurves",
    "BatchErrorCurves", "ProblemContext", "SimulationEngine", "run_trace",
    "average_curves", "run_trace_reference", "average_curves_reference",
    "random_problem", "correlated_problem",
]
