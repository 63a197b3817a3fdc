"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
24L d_model=1024 4H vocab=50304, d_ff=0 (cells carry their own up/down
projections).  Every 6th block is an sLSTM (paper's mixed ratio)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    slstm_every=6,
    rules="tp",
)
