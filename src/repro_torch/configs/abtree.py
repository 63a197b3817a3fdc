"""The paper's own data-structure configs (copy of
``src/repro/configs/abtree.py``): the (a,b) presets from the paper, MIN_SIZE
2 with MAX 8 / 11 / 16, for the microbenchmarks and ``chip_smoke.py``."""
from repro_torch.core.abtree import TreeConfig

PAPER = TreeConfig(capacity=1 << 16, b=11, a=2, max_height=24)  # paper's b=11
TPU8 = TreeConfig(capacity=1 << 16, b=8, a=2, max_height=24)  # the JAX package's VREG-lane width
WIDE16 = TreeConfig(capacity=1 << 16, b=16, a=2, max_height=24)
