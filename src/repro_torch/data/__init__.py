"""Data of the port: the tree path's workload generators, the training
path's synthetic token stream and the dedup index over the Elim-ABtree."""
from repro_torch.data.dedup import DedupIndex, content_hash
from repro_torch.data.pipeline import DataConfig, make_data_iter, synthetic_batches

__all__ = ["DataConfig", "DedupIndex", "content_hash", "make_data_iter", "synthetic_batches"]
