"""Strategy search: the machine and cost models, the measured mode, the
DP machine-view assignment and the substitution engine -- the PyTorch
counterparts of the JAX package's search/ (reference:
src/runtime/{simulator,graph,substitution}.cc). Not ported yet: the MCMC
search (search/mcmc.py), the memory-aware search
(search/memory_optimization.py, --memory-search) and the
topology-aware machine model (search/network.py)."""
from .cost_model import (  # noqa: F401
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
# warns on violations.
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


register_strategy_validator(_default_structural_validator)
