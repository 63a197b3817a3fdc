"""Core library of the port: the batched OCC-ABtree and Elim-ABtree round
engine, one tree (``ABTree``) or a key-partitioned forest (``ABForest``)."""
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
from repro_torch.core.rounds import RoundPlan, build_plan
from repro_torch.core.oracle import DictOracle, check_invariants, tree_contents

__all__ = [
    "ABForest",
    "ABTree",
    "DictOracle",
    "EMPTY",
    "NOTFOUND",
    "OP_DELETE",
    "OP_FIND",
    "OP_INSERT",
    "OP_NOP",
    "OP_RANGE",
    "RoundOutput",
    "RoundPlan",
    "ScanConflictError",
    "ScanOutput",
    "TreeConfig",
    "TreeState",
    "build_plan",
    "check_forest_invariants",
    "check_invariants",
    "range_query",
    "tree_contents",
]
