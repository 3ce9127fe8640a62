"""Federation layer: the server round loop, node agents, the in-process
driver, the parameter transport and membership (the port of
``photon_tpu/federation``; the multiprocess and TCP drivers, the
collective and async round runners are not ported)."""

from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.driver import Driver, InProcessDriver
from photon_tpu_torch.federation.membership import LivenessTracker
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    ClientState,
    EvaluateIns,
    EvaluateRes,
    FitIns,
    FitRes,
    ParamPointer,
    Query,
)
from photon_tpu_torch.federation.node import NodeAgent
from photon_tpu_torch.federation.server import ServerApp, TooManyFailuresError
from photon_tpu_torch.federation.transport import ParamTransport

__all__ = [
    "ClientRuntime",
    "Driver",
    "InProcessDriver",
    "LivenessTracker",
    "NodeAgent",
    "ServerApp",
    "TooManyFailuresError",
    "ParamTransport",
    "Ack",
    "Broadcast",
    "ClientState",
    "EvaluateIns",
    "EvaluateRes",
    "FitIns",
    "FitRes",
    "ParamPointer",
    "Query",
]
