"""Federation layer: the server round loop, node agents, the in-process,
multiprocess and TCP drivers (``federation.tcp``), the parameter transport
and membership (the port of ``photon_tpu/federation``). The collective and async round
runners live in ``collective_round`` and ``async_round``, imported by
module path."""

from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.driver import Driver, InProcessDriver, MultiprocessDriver
from photon_tpu_torch.federation.membership import LivenessTracker, ReconnectPolicy
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    ClientState,
    Envelope,
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
    "MultiprocessDriver",
    "LivenessTracker",
    "ReconnectPolicy",
    "NodeAgent",
    "ServerApp",
    "TooManyFailuresError",
    "ParamTransport",
    "Ack",
    "Broadcast",
    "ClientState",
    "Envelope",
    "EvaluateIns",
    "EvaluateRes",
    "FitIns",
    "FitRes",
    "ParamPointer",
    "Query",
]
