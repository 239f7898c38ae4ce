"""Cross-preset solved-status smoke gate.

A ~25-solve slice of the full-library sweep promoted into the DEFAULT
pytest tier, so solved-status regressions surface without `--runslow`.
Problems and presets are chosen from the round-3 sweep's rows that are
fast and stably solved; expectations mirror the sweep's success convention
(`success` or a feasible small step at the certified objective).
"""

import numpy as np
import pytest

import uno_tpu
from uno_tpu.model.library import acceptable_optima, get_problem

# (problem, preset) pairs covering: all five presets, the fused TR and byrd
# drivers, the IPM, the banded structured path (dtoc1/srosenbr), the .nl
# ingestion path, constrained classics, and the new MGH corpus
CASES = [
    ("hs015", "ipopt"),
    ("hs015", "filtersqp"),
    ("hs015", "byrd"),
    ("hs021", "funnelsqp"),
    ("hs035", "filterslp"),
    ("hs052", "byrd"),
    ("hs076", "ipopt"),
    ("hs100", "filtersqp"),
    ("hs113", "byrd"),
    ("maratos", "filtersqp"),
    ("bt1", "ipopt"),
    ("rosenbrock", "ipopt"),
    ("booth", "filtersqp"),
    ("beale", "ipopt"),
    ("srosenbr_n10", "ipopt"),
    ("srosenbr_n100", "ipopt"),       # auto-banded structured path
    ("dtoc1_n11", "ipopt"),           # permuted control family, banded
    ("lukvle1_n10", "filtersqp"),
    ("catena_n8", "ipopt"),
    ("dixon3dq_n10", "funnelsqp"),
    ("sphere_proj_n10", "ipopt"),
    ("exthimmelblau_n10", "byrd"),
    ("nl_srosenbr_n10", "ipopt"),     # .nl ingestion end-to-end
    ("nl_tridia_n10", "filtersqp"),
    ("polygon_k6", "ipopt"),
]


# default tier keeps a 2-per-preset core (wall-time budget, round-4:
# default suite must stay < 300 s); the rest run with --runslow (and the
# FULL library runs out-of-band via tools/sweep.py)
CORE = {("hs015", "ipopt"), ("hs015", "filtersqp"), ("hs015", "byrd"),
        ("hs021", "funnelsqp"), ("hs035", "filterslp"),
        ("srosenbr_n100", "ipopt"), ("dtoc1_n11", "ipopt"),
        ("lukvle1_n10", "filtersqp"), ("nl_srosenbr_n10", "ipopt"),
        ("maratos", "filtersqp")}


@pytest.mark.parametrize("name,preset", [
    pytest.param(n, p, marks=[] if (n, p) in CORE else pytest.mark.slow)
    for n, p in CASES])
def test_smoke_solved(name, preset):
    nlp = get_problem(name)
    res = uno_tpu.solve(nlp, preset=preset, max_iterations=500)
    optima = acceptable_optima(name)
    # the sweep's success convention (tools/sweep.py): a solver success, or
    # a feasible small step AT a certified optimum
    ok = res.success or (res.status == "feasible_small_step"
                         and res.primal_feasibility <= 1e-5 and optima)
    assert ok, (name, preset, res.status, float(res.objective))
    if optima:
        err = min(abs(float(res.objective) - f) / max(1.0, abs(f))
                  for f in optima)
        assert err <= 1e-4, (name, preset, float(res.objective), err)
