"""whisper-tiny: enc-dec audio backbone; conv frontend is a STUB
(input_specs() supplies precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64,
    encoder_layers=4, encoder_seq=1500,
    microbatches=4,
    use_fsdp=False, source="arXiv:2212.04356",
)
