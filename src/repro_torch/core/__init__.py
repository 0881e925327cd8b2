"""CIAO core: the paper's contribution (predicates, selection, loading)."""
from .bitvector import pack, popcount, unpack  # noqa: F401
from .client import (  # noqa: F401
    Chunk,
    NumpyEngine,
    PythonEngine,
    encode_chunk,
    get_engine,
)
from .cost_model import CostModel, calibrate, fit  # noqa: F401
from .planner import PlanReport, build_plan, plan_for_clients  # noqa: F401
from .predicates import (  # noqa: F401
    Clause,
    Kind,
    Query,
    SimplePredicate,
    all_patterns,
    clause,
    exact,
    key_value,
    presence,
    query,
    substring,
)
from .selection import (  # noqa: F401
    SelectionProblem,
    SelectionResult,
    brute_force,
    celf_greedy,
    combined_celf,
    combined_greedy,
    greedy,
    objective,
)
from .server import (  # noqa: F401
    CiaoStore,
    DataSkippingScanner,
    FullScanBaseline,
    PushdownPlan,
    StaleEpochError,
    evolve_plan,
)
from .workload import (  # noqa: F401
    DriftPhase,
    Workload,
    drifting_query_stream,
    drifting_workloads,
    estimate_selectivities,
    generate_workload,
)
