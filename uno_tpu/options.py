"""Solver options and presets.

Mirrors the capability surface of the reference's layered string-option system
(/root/reference/uno/options/DefaultOptions.cpp:11-190 and Presets.cpp:39-152)
as a typed frozen dataclass.  Every algorithmic constant of the reference's
defaults and of the `ipopt` / `filtersqp` / `byrd` / `funnelsqp` / `filterslp`
presets is reproduced here so that preset behavior matches the reference.

Options are static (Python-level) configuration: they select the compiled
program. They are NOT traced values; changing an option triggers a re-jit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


LDLT_BACKENDS = ("auto", "distributed")


@dataclass(frozen=True)
class Options:
    # ---- ingredient selection (the six orthogonal ingredients) -------------
    # reference README.md:24-39
    constraint_relaxation_strategy: str = "feasibility_restoration"  # | "l1_relaxation"
    inequality_handling_method: str = "primal_dual_interior_point"   # | "inequality_constrained"
    hessian_model: str = "exact"             # | "identity" | "zero"
    regularization_strategy: str = "primal_dual"  # | "primal" | "none"
    globalization_strategy: str = "waechter_filter_method"
    # | "fletcher_filter_method" | "funnel_method" | "l1_merit"
    globalization_mechanism: str = "LS"      # | "TR"
    filter_type: str = "standard"            # | "nonmonotone"

    # ---- termination (DefaultOptions.cpp:15-30) ----------------------------
    tolerance: float = 1e-8
    loose_tolerance: float = 1e-6
    loose_tolerance_consecutive_iteration_threshold: int = 15
    max_iterations: int = 2000
    time_limit: float = np.inf
    unbounded_objective_threshold: float = -1e20
    enforce_linear_constraints: bool = False

    # ---- main (DefaultOptions.cpp:52-75) -----------------------------------
    scale_functions: bool = False
    function_scaling_threshold: float = 100.0
    function_scaling_factor: float = 100.0
    scale_residuals: bool = True
    progress_norm: str = "L1"        # norm for progress measures
    residual_norm: str = "INF"       # norm for primal-dual residuals
    residual_scaling_threshold: float = 100.0
    protect_actual_reduction_against_roundoff: bool = False

    # ---- globalization strategy (DefaultOptions.cpp:77-105) ----------------
    armijo_decrease_fraction: float = 1e-4
    armijo_tolerance: float = 1e-9
    switching_delta: float = 0.999
    switching_infeasibility_exponent: float = 2.0
    filter_beta: float = 0.999
    filter_gamma: float = 0.001
    filter_ubd: float = 1e2
    filter_fact: float = 1.25
    filter_capacity: int = 50
    filter_sufficient_infeasibility_decrease_factor: float = 0.9
    nonmonotone_filter_number_dominated_entries: int = 3
    funnel_kappa: float = 0.5
    funnel_beta: float = 0.9999
    funnel_gamma: float = 0.001
    funnel_ubd: float = 1.0
    funnel_fact: float = 1.5
    funnel_update_strategy: int = 1
    funnel_require_acceptance_wrt_current_iterate: bool = False

    # ---- line search (DefaultOptions.cpp:107-113) --------------------------
    LS_backtracking_ratio: float = 0.5
    LS_min_step_length: float = 1e-12
    LS_scale_duals_with_step_length: bool = True

    # ---- regularization (DefaultOptions.cpp:115-131) -----------------------
    # reference: 1e40; capped into f32 range for a machine whose f64 was
    # emulated in f32 pairs, not yet re-decided on the H100 (ROADMAP C3)
    regularization_failure_threshold: float = 1e38
    regularization_initial_value: float = 1e-4
    regularization_increase_factor: float = 2.0
    primal_regularization_initial_factor: float = 1e-4
    dual_regularization_fraction: float = 1e-8
    primal_regularization_lb: float = 1e-20
    primal_regularization_decrease_factor: float = 3.0
    primal_regularization_fast_increase_factor: float = 100.0
    primal_regularization_slow_increase_factor: float = 8.0
    threshold_unsuccessful_attempts: int = 8
    # static bound on inertia-correction refactorizations inside one KKT solve
    # (jit requires a bounded loop; 40 doublings cover up to 1e40 threshold)
    max_regularization_attempts: int = 40

    # ---- trust region (DefaultOptions.cpp:133-149) -------------------------
    TR_radius: float = 10.0
    TR_increase_factor: float = 2.0
    TR_decrease_factor: float = 2.0
    TR_aggressive_decrease_factor: float = 4.0
    TR_activity_tolerance: float = 1e-6
    TR_min_radius: float = 1e-7
    TR_radius_reset_threshold: float = 1e-4
    convexify_QP: bool = False

    # ---- constraint relaxation (DefaultOptions.cpp:151-169) ----------------
    l1_relaxation_initial_parameter: float = 1.0
    l1_relaxation_fixed_parameter: bool = False
    l1_relaxation_decrease_factor: float = 10.0
    l1_relaxation_epsilon1: float = 0.1
    l1_relaxation_epsilon2: float = 0.1
    l1_relaxation_residual_small_threshold: float = 1e-12
    l1_constraint_violation_coefficient: float = 1.0
    l1_small_duals_threshold: float = 1e-10
    switch_to_optimality_requires_linearized_feasibility: bool = True

    # ---- barrier subproblem (DefaultOptions.cpp:171-190) -------------------
    barrier_initial_parameter: float = 0.1
    barrier_default_multiplier: float = 1.0
    barrier_tau_min: float = 0.99
    barrier_k_sigma: float = 1e10
    barrier_smax: float = 100.0
    barrier_k_mu: float = 0.2
    barrier_theta_mu: float = 1.5
    barrier_k_epsilon: float = 10.0
    barrier_update_fraction: float = 10.0
    barrier_regularization_exponent: float = 0.25
    barrier_small_direction_factor: float = 10.0
    barrier_push_variable_to_interior_k1: float = 1e-2
    barrier_push_variable_to_interior_k2: float = 1e-2
    barrier_damping_factor: float = 1e-5
    least_square_multiplier_max_norm: float = 1e3

    # ---- line-search bound on inner iterations under jit -------------------
    # log_0.5(5e-7) ~ 21; default LS_min_step_length 1e-12 needs 40
    max_line_search_iterations: int = 45

    # ---- logging (DefaultOptions.cpp:51; default here is SILENT since this
    # is a library; set "INFO" for the reference-style iteration table) ------
    logger: str = "SILENT"
    print_solution: bool = False

    # ---- accelerator execution options (no reference equivalent) ----------
    dtype: str = "float64"           # factorization/compute dtype
    # KKT factorization dtype: "float32" factors in single precision and
    # recovers f64 accuracy with iterative refinement (MA57-style)
    kkt_dtype: str = "float64"
    kkt_refinement_steps: int = 1            # f64 refinements after f32 solve
    LS_batch_candidates: int = 1             # backtracking alphas per LS trip
    # "auto" = pick_factorizer by KKT dim | "distributed" = the KKT
    # factorization sharded over a mesh (parallel/dist_ldlt.py)
    ldlt_backend: str = "auto"
    # blocked LDL^T panel width; chosen on another machine and not yet
    # measured on the H100 (ROADMAP A7)
    ldlt_block_size: int = 32
    dist_ldlt_block: int = 64        # distributed-KKT panel width (per chip)
    # "augmented" dense LDL^T | "lifted" condensed Cholesky | "banded"
    # structured block-tridiagonal Cholesky (requires NLP.structure) |
    # "sparse" general static-sparsity supernodal LDL^T (fill-reducing
    # ordering + supernodal schedule, linalg/sparse_ldlt.py) |
    # "auto" = banded when the model declares structure; with
    # auto_permute=True, probes sparsity and routes sparse when the
    # scheduled flops beat the dense path; else augmented
    kkt_formulation: str = "auto"
    # automatic RCM bandwidth-reduction over the DETECTED Hessian/Jacobian
    # sparsity (transforms.detect_structure): structured models need not
    # hand-declare NLPStructure; falls back to dense when the pattern
    # stays wide (irregular coupling) — round-4 analogue of MA57's
    # symbolic analysis (MA57Solver.cpp:40-90)
    auto_permute: bool = False
    # SQP driver: "fused" = single lax.while_loop state machine (jittable,
    # vmappable — solvers/sqp_fused.py); "host" = Python outer loop with
    # jitted kernels (solvers/sqp.py); "auto" = fused for the TR +
    # feasibility-restoration family, host otherwise
    sqp_driver: str = "auto"
    lifted_kkt_relaxation: float = 1e-8  # tau; use ~1e-5 with f32 factors
    bound_infinity: float = 1e20     # |bound| >= this is treated as infinite

    def __post_init__(self):
        if self.ldlt_backend not in LDLT_BACKENDS:
            raise ValueError(f"unknown ldlt_backend {self.ldlt_backend!r}; "
                             f"available: {list(LDLT_BACKENDS)}")

    def replace(self, **kwargs) -> "Options":
        return dataclasses.replace(self, **kwargs)

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)


# ---------------------------------------------------------------------------
# presets — constants of reference Presets.cpp:39-152
# ---------------------------------------------------------------------------

_PRESETS = {
    # Presets.cpp:39-74 ("ipopt")
    "ipopt": dict(
        constraint_relaxation_strategy="feasibility_restoration",
        inequality_handling_method="primal_dual_interior_point",
        hessian_model="exact",
        regularization_strategy="primal_dual",
        globalization_mechanism="LS",
        globalization_strategy="waechter_filter_method",
        filter_type="standard",
        filter_beta=0.99999,
        filter_gamma=1e-8,
        switching_delta=1.0,
        filter_ubd=1e4,
        filter_fact=1e4,
        switching_infeasibility_exponent=1.1,
        armijo_decrease_fraction=1e-8,
        LS_backtracking_ratio=0.5,
        LS_min_step_length=5e-7,
        barrier_tau_min=0.99,
        barrier_damping_factor=1e-5,
        l1_constraint_violation_coefficient=1000.0,
        progress_norm="L1",
        residual_norm="INF",
        scale_functions=True,
        tolerance=1e-8,
        loose_tolerance=1e-6,
        loose_tolerance_consecutive_iteration_threshold=15,
        switch_to_optimality_requires_linearized_feasibility=False,
        LS_scale_duals_with_step_length=True,
        protect_actual_reduction_against_roundoff=True,
    ),
    # Presets.cpp:75-93 ("filtersqp")
    "filtersqp": dict(
        constraint_relaxation_strategy="feasibility_restoration",
        inequality_handling_method="inequality_constrained",
        hessian_model="exact",
        regularization_strategy="none",
        globalization_mechanism="TR",
        globalization_strategy="fletcher_filter_method",
        filter_type="standard",
        progress_norm="L1",
        residual_norm="L2",
        TR_radius=10.0,
        l1_constraint_violation_coefficient=1.0,
        enforce_linear_constraints=True,
        tolerance=1e-6,
        loose_tolerance=1e-6,
        TR_min_radius=1e-8,
        switch_to_optimality_requires_linearized_feasibility=True,
        protect_actual_reduction_against_roundoff=False,
    ),
    # Presets.cpp:94-112 ("byrd")
    "byrd": dict(
        constraint_relaxation_strategy="l1_relaxation",
        inequality_handling_method="inequality_constrained",
        hessian_model="exact",
        regularization_strategy="primal",
        globalization_mechanism="LS",
        globalization_strategy="l1_merit",
        l1_relaxation_initial_parameter=1.0,
        LS_backtracking_ratio=0.5,
        armijo_decrease_fraction=1e-8,
        l1_relaxation_epsilon1=0.1,
        l1_relaxation_epsilon2=0.1,
        l1_constraint_violation_coefficient=1.0,
        tolerance=1e-6,
        loose_tolerance=1e-6,
        progress_norm="L1",
        residual_norm="L1",
        LS_scale_duals_with_step_length=False,
        protect_actual_reduction_against_roundoff=False,
    ),
    # Presets.cpp:113-143 ("funnelsqp")
    "funnelsqp": dict(
        constraint_relaxation_strategy="feasibility_restoration",
        inequality_handling_method="inequality_constrained",
        hessian_model="exact",
        regularization_strategy="none",
        globalization_mechanism="TR",
        globalization_strategy="funnel_method",
        progress_norm="L1",
        residual_norm="L2",
        TR_radius=10.0,
        l1_constraint_violation_coefficient=1.0,
        enforce_linear_constraints=True,
        tolerance=1e-6,
        loose_tolerance=1e-6,
        TR_min_radius=1e-8,
        switch_to_optimality_requires_linearized_feasibility=True,
        funnel_beta=0.9999,
        funnel_gamma=0.001,
        switching_delta=0.999,
        funnel_kappa=0.5,
        funnel_ubd=1.0,
        funnel_fact=1.5,
        switching_infeasibility_exponent=2.0,
        funnel_update_strategy=2,
    ),
    # Presets.cpp:144-163 ("filterslp")
    "filterslp": dict(
        constraint_relaxation_strategy="feasibility_restoration",
        inequality_handling_method="inequality_constrained",
        hessian_model="zero",
        regularization_strategy="none",
        globalization_mechanism="TR",
        globalization_strategy="fletcher_filter_method",
        filter_type="standard",
        progress_norm="L1",
        residual_norm="L2",
        TR_radius=10.0,
        l1_constraint_violation_coefficient=1.0,
        enforce_linear_constraints=True,
        tolerance=1e-5,
        loose_tolerance=1e-4,
        TR_min_radius=1e-8,
        switch_to_optimality_requires_linearized_feasibility=True,
        protect_actual_reduction_against_roundoff=False,
    ),
}


def preset_overrides(name: str) -> dict:
    """The raw option overrides of a named preset (for layered application,
    reference uno_ampl.cpp:110-131: defaults <- option file <- preset <- CLI)."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return dict(_PRESETS[name])


def preset(name: str, **overrides) -> Options:
    """Build Options for a named preset; keyword overrides are applied last."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}")
    return Options(**{**_PRESETS[name], **overrides})


def available_presets() -> list[str]:
    return sorted(_PRESETS)
