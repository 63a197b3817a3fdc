"""Serving engine of the port: continuous batching over the dense LM decode
path, with the Elim-ABtree as its prefix and session index."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pages import PagedKVCache, PrefixIndex, SessionIndex

__all__ = ["PagedKVCache", "PrefixIndex", "Request", "ServeEngine", "SessionIndex"]
