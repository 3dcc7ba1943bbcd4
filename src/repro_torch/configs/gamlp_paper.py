"""The paper's own GA-MLP configuration (Section V).

Counterpart of ``repro.configs.gamlp_paper``. Not an LM: GA-MLP shapes are
(|V| nodes x K*d features), driven by the graph datasets. The registry
entry lets ``get_arch("gamlp-paper")`` select the paper's model.
"""
from dataclasses import dataclass, field
from typing import Sequence

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class GAMLPConfig:
    n_layers: int = 10
    hidden: int = 1000          # the paper uses 100 / 500 / 1000 / 4000
    k_hops: int = 4             # Psi = {I, A~, A~^2, A~^3}
    activation: str = "relu"
    rho: float = 1.0            # the Fig 2 setting
    nu: float = 1e-2
    # pdADMM-G-Q (Section V-A): Delta = {-1, 0, 1, ..., 20}
    quant_levels: Sequence[int] = field(default=tuple(range(-1, 21)))
    quant_bits: int = 8         # Fig 5 sweeps 8 / 16
    quantize_p: bool = True
    quantize_q: bool = False
    greedy_schedule: Sequence[int] = (2, 5, 10)  # greedy layerwise growth
    fista_iters: int = 15
    epochs: int = 100


CONFIG = ArchConfig(
    name="gamlp-paper", family="gamlp",
    n_layers=10, d_model=1000, n_heads=1, n_kv_heads=1, d_ff=0, vocab=0,
    head_dim=1, source="this paper, Section V",
    shape_skips={s: "GA-MLP is a node-classification model; LM shapes n/a"
                 for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")},
)

GAMLP = GAMLPConfig()
