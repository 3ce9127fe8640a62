"""Deterministic fault injection (``photon.chaos``; the port of
``photon_tpu/chaos/``).

Every failure the federation stack claims to survive is an injectable,
seeded event:

- control plane (``federation/tcp.py``): drop, delay, duplicate or
  corrupt an envelope frame (a corrupt frame is refused by the CRC32
  framing);
- object store (``checkpoint/store.py``): slow, partial (a ``.tmp`` file
  never renamed into place) and bit-flipped writes and reads (caught by
  the checkpoint manifest's checksums);
- node process (``federation/node.py``, ``client_runtime.py``): a crash
  at ``pre-fit``, ``mid-fit`` or ``pre-reply`` through ``os._exit``, as
  abrupt as a SIGKILL;
- the fit's payload (a NaN in the shipped copy), the serving scheduler (a
  stall per token stepped) and the fleet router (one replica killed after
  N placements).

Disabled (the default), every hook site is one module-global load and a
``None`` check: no draws, no fault logic. ``photon.chaos`` must stay off
in production configs.
"""

from photon_tpu_torch.chaos.injector import (
    FaultInjector,
    StoreFaultPlan,
    TcpFaultPlan,
    active,
    crash_point,
    install,
    uninstall,
)

__all__ = [
    "FaultInjector",
    "StoreFaultPlan",
    "TcpFaultPlan",
    "active",
    "crash_point",
    "install",
    "uninstall",
]
