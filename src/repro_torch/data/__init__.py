"""Data of the port: the tree path's workload generators and the training
path's synthetic token stream."""
from repro_torch.data.pipeline import DataConfig, make_data_iter, synthetic_batches

__all__ = ["DataConfig", "make_data_iter", "synthetic_batches"]
