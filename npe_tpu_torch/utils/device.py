"""Device selection for the port's entry points."""

import torch


def resolve_device(device="cuda"):
    """The torch.device to run on. A CUDA device that is not present raises:
    the port never falls back to the CPU on its own; pass device="cpu" to
    run the plain PyTorch path."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return device
