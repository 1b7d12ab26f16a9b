"""Device resolution: the port runs on CUDA unless the caller asks for the CPU.

There is no fallback: without a card, an entry point given no ``device``
raises instead of carrying on on the CPU.  This is also the one place the
port turns TF32 off.  The forward is fp32 and channel selection is
discrete, so a TF32 convolution (cuDNN's default) would move channel ranks
away from the reference's.
"""

from __future__ import annotations

import torch


def tf32_flags() -> dict[str, bool]:
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` and ``"cuda"`` mean the card, which must be present;
    ``"cpu"`` runs the plain PyTorch versions of every kernel."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU; "
                "pass device='cpu' to run its plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    # fp32 convolutions and matmuls on the card stay full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
