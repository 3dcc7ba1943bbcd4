"""yi-9b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab=64000, head_dim=128, rope_theta=10_000.0,
    use_fsdp=True, microbatches=4, source="arXiv:2403.04652",
)
