"""qwen2-vl-7b: VLM backbone only, M-RoPE, dynamic-resolution patch frontend
is a STUB (input_specs() supplies precomputed patch embeddings + 3D position
ids) [arXiv:2409.12191; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # temporal/height/width; sums to head_dim/2
    use_fsdp=True, microbatches=4, source="arXiv:2409.12191",
)
