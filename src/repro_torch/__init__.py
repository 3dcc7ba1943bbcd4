"""PyTorch + CUDA port of the pdADMM-G reproduction (``src/repro``).

The layout mirrors the JAX package module for module (``graph/``,
``core/``, ``kernels/``); the JAX package stays the reference the port is
tested against. Every kernel of the reference's Pallas paths is a
hand-written CUDA kernel for Hopper (``kernels/csrc``) with a plain
PyTorch version beside it (``kernels/ref.py``): a CUDA tensor launches the
kernel, a CPU tensor takes the plain version. The LM's training path, like
the reference's, reaches none of them.

Entry points take ``device=``. Left as ``None`` it means the card, and a
host without CUDA raises rather than running on the CPU.
"""
import torch

# The reference runs in full f32. TF32 would keep about three decimal digits
# in every cuBLAS matmul the port leaves to PyTorch (pᵀr, the forward pass),
# so it is switched off for the whole package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` as given, else CUDA.

    Raises when no device was given and CUDA is absent — the port never
    drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
