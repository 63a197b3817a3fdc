"""whisper-tiny [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified].  4L enc + 4L dec, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865.  input_specs supplies 1500 precomputed frame
embeddings; LayerNorm + GELU + sinusoidal positions (no rope)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    d_ff=1536,
    vocab=51865,
    enc_layers=4,
    enc_frames=1500,
    norm="ln",
    act="gelu",
    use_rope=False,
    tie_embeddings=True,
    scan_layers=False,
    rules="tp",
)
