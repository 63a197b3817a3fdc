"""PyTorch/CUDA port of the batched Elim-ABtree (the JAX package ``repro``
is the reference).  See ``core/abtree.py`` for the tree and
``core/rounds.py`` for the round engine."""
