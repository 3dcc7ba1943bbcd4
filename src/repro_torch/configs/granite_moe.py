"""granite-moe-3b-a800m: 40 experts top-8, GQA kv=8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512),
    microbatches=8,
    use_fsdp=False, source="hf:ibm-granite/granite-3.0",
)
