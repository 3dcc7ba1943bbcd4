"""tinyllama-1.1b: llama2-arch small, GQA kv=4 [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000, head_dim=64, rope_theta=10_000.0,
    use_fsdp=False, source="arXiv:2401.02385",
)
