"""Core library of the port: the batched Elim-ABtree round engine."""
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
)
from repro_torch.core.oracle import DictOracle, check_invariants, tree_contents

__all__ = [
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
    "ScanConflictError",
    "ScanOutput",
    "TreeConfig",
    "TreeState",
    "check_invariants",
    "tree_contents",
]
