"""qwen3-moe-235b-a22b: 128 experts top-8, GQA kv=4 [hf:Qwen/Qwen3 family]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    use_fsdp=True, microbatches=16, remat_group=2, opt_bits=8, accum_bf16=True, source="hf:Qwen/Qwen3-30B-A3B (scaled per assignment)",
)
