"""The optimized variants of three cells (port of
``src/repro/configs/optimized.py``): the dry-run's ``--suite opt``.

Keys: (arch, shape) → dict of ModelConfig overrides (+ the special key
``param_dtype`` consumed by the dry-run: serving-weight dtype)."""

OPTIMIZED = {
    # the sequential mLSTM scan → chunkwise (state traffic ÷ chunk, outer
    # products → batched matmuls)
    ("xlstm-350m", "train_4k"): {"mlstm_chunk": 64},
    # global MoE dispatch → shard-local grouped dispatch (32 groups align
    # with the (pod, data) batch sharding on both meshes)
    ("granite-moe-3b-a800m", "train_4k"): {"moe_groups": 32},
    # fp32 resident weights stream every decode step → bf16 serving weights
    # (master weights stay fp32 in the training checkpoints)
    ("deepseek-v3-671b", "decode_32k"): {"param_dtype": "bfloat16"},
}


def overrides_for(arch: str, shape: str) -> dict:
    return dict(OPTIMIZED.get((arch, shape), {}))
