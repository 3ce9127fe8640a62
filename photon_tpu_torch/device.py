"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the card
(``cuda``); the CPU is used only when the caller names it. A request for
CUDA on a host without it raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def require_device(device: str | torch.device | None = None) -> str:
    """The device policy, without opening a CUDA context (for a process
    that hands the device to the nodes it starts): ``None`` → ``cuda``; a
    CUDA device must exist, a CPU device is taken as asked. Returns the
    device's name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return str(dev)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """:func:`require_device`, then a CUDA device without an index gets
    the current one."""
    dev = torch.device(require_device(device))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
