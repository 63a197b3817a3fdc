"""Data of the port: the tree path's workload generators, the training
path's synthetic token stream and the dedup index over the Elim-ABtree."""
from repro_torch.data.dedup import DedupIndex, content_hash
from repro_torch.data.pipeline import DataConfig, make_data_iter, synthetic_batches
from repro_torch.data.workloads import WorkloadConfig, op_stream, zipf_keys

__all__ = ["DataConfig", "DedupIndex", "WorkloadConfig", "content_hash", "make_data_iter",
           "op_stream", "synthetic_batches", "zipf_keys"]
