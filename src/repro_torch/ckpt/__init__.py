"""Checkpoints (counterpart of ``repro.ckpt``)."""
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
