"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Resolve an entry point's ``device=`` argument.

    ``"cuda"`` (the default) needs a card and raises ``RuntimeError``
    without one: nothing moves to the CPU on its own. ``"cpu"`` runs the
    plain PyTorch versions of the kernels, which is what the CPU tests
    ask for. On the card, float32 matrix products are pinned to full
    float32 (no TF32) so a float32 run keeps parity with the JAX
    reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} needs a CUDA card and none is "
                f"available; pass device='cpu' to run the plain versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
