"""Strategy search: the machine models (flat and topology-aware), the
cost model, the measured mode, the DP machine-view assignment, the
substitution engine, the memory-aware search and the MCMC search with
its task-graph simulator -- the PyTorch counterparts of the JAX
package's search/ (reference:
src/runtime/{simulator,graph,substitution,model-mcmc,network}.cc)."""
from .cost_model import (  # noqa: F401
    apply_calibration,
    CostMetrics,
    CostModel,
    CostObjective,
    op_decode_bytes,
)
from .dp_search import GraphCostResult, SearchHelper, research_views  # noqa: F401
from .machine_model import (  # noqa: F401
    H100_SPEC,
    MachineModel,
    TPUChipSpec,
    for_device_count,
    h100_machine,
    parse_machine_config,
)
from .mcmc import MCMCSearch, simulate_runtime  # noqa: F401
from .survivability import (  # noqa: F401
    OpSurvivability,
    StrategySurvivability,
    strategy_survivability,
    survivability_cost_factor,
)
from .substitution import (  # noqa: F401
    GraphSearchHelper,
    Substitution,
    generate_all_pcg_xfers,
)

# ----------------------------------------------------------------------
# strategy-validator hook (runtime/verify.py registers the default)
# ----------------------------------------------------------------------
# Validators run over every search result before it is lowered: each is
# called as fn(graph, views, num_devices) and returns a list of
# human-readable violation strings (empty = fine). FFModel.compile()
# warns on violations; the differential verifier
# (runtime.verify.verify_strategy) folds them into its verdict.
_STRATEGY_VALIDATORS: list = []


def register_strategy_validator(fn):
    """Register `fn(graph, views, num_devices) -> list[str]` to vet every
    searched strategy. Returns `fn` so it works as a decorator."""
    _STRATEGY_VALIDATORS.append(fn)
    return fn


def run_strategy_validators(graph, views, num_devices: int) -> list:
    """Run every registered validator; concatenated violation strings."""
    problems: list = []
    for fn in list(_STRATEGY_VALIDATORS):
        problems.extend(fn(graph, views, num_devices) or [])
    return problems


def _default_structural_validator(graph, views, num_devices):
    from ..runtime.verify import validate_searched_strategy

    return validate_searched_strategy(graph, views, num_devices)


def _static_analysis_validator(graph, views, num_devices):
    """The static PCG analyzer (analysis/) as a strategy validator:
    structure + sharding/shape inference + collective consistency (+ the
    precision flow) over every search result, so a malformed strategy is
    named at compile() time instead of producing wrong numbers on the
    device."""
    from ..analysis import strategy_violations

    return strategy_violations(graph, views, num_devices)


register_strategy_validator(_default_structural_validator)
register_strategy_validator(_static_analysis_validator)
