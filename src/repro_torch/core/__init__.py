"""Core library of the port: the batched OCC-ABtree and Elim-ABtree round
engine, one tree (``ABTree``) or a key-partitioned forest (``ABForest``),
with durable (link-and-persist) commits (``DurableABTree``,
``DurableForest``, ``recover``) and their fault injection."""
from repro_torch.core.abtree import (
    ABTree,
    EMPTY,
    NOTFOUND,
    OP_DELETE,
    OP_FIND,
    OP_INSERT,
    OP_NOP,
    OP_RANGE,
    RoundOutput,
    ScanConflictError,
    ScanOutput,
    TreeConfig,
    TreeState,
    range_query,
)
from repro_torch.core.forest import ABForest, check_forest_invariants
from repro_torch.core.durable import (
    DurableABTree,
    DurableForest,
    RecoveryError,
    recover,
    recover_forest,
)
from repro_torch.core.faults import (
    CrashPoint,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    SimulatedCrash,
)
from repro_torch.core.rounds import RoundPlan, build_plan
from repro_torch.core.oracle import DictOracle, check_invariants, tree_contents

__all__ = [
    "ABForest",
    "ABTree",
    "CrashPoint",
    "DictOracle",
    "DurableABTree",
    "DurableForest",
    "EMPTY",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "NOTFOUND",
    "OP_DELETE",
    "OP_FIND",
    "OP_INSERT",
    "OP_NOP",
    "OP_RANGE",
    "RecoveryError",
    "RoundOutput",
    "RoundPlan",
    "ScanConflictError",
    "ScanOutput",
    "SimulatedCrash",
    "TreeConfig",
    "TreeState",
    "build_plan",
    "check_forest_invariants",
    "check_invariants",
    "range_query",
    "recover",
    "recover_forest",
    "tree_contents",
]
