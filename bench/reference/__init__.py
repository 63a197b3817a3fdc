"""The plain reference: a Python dict with the round semantics the
benchmark holds the program to.  It imports neither ``jax`` nor ``repro``
nor anything of ``repro_torch``, and works out every answer it compares
from the round inputs alone."""
from bench.reference.dictionary import EMPTY, NOTFOUND, Dictionary, RoundAnswer

__all__ = ["EMPTY", "NOTFOUND", "Dictionary", "RoundAnswer"]
