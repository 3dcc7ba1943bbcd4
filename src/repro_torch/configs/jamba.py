"""jamba-v0.1-52b: Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer [arXiv:2403.19887; hf]."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_period=8, hybrid_attn_index=4,
    use_fsdp=True, microbatches=8, opt_bits=8, source="arXiv:2403.19887",
)
