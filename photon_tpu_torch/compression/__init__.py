"""The uplink wire codec (the port of ``photon_tpu/compression``, host
numpy as there; its jnp quantizer serves the collective plane, which is
not ported).

Clients send ``w_new − w_global`` (``delta.py``), optionally top-k
sparsified (``topk.py``) and blockwise int8 quantized (``quantize.py``),
with per-client error-feedback residuals re-injecting what the lossy
stages dropped (``error_feedback.py``), in a versioned container
(``payload.py``) built by the :class:`Codec` (``codec.py``) under a policy:
``off`` / ``delta`` / ``delta_q8`` / ``delta_topk_q8``. For the same arrays
and residual history the payload bytes equal the JAX package's, so a
compressed pointer written by either package decodes in the other.

:class:`photon_tpu_torch.federation.transport.ParamTransport` applies the
codec to fit results (the uplink); broadcasts stay raw. The server's
strategy decodes one client at a time while it folds.
"""

from photon_tpu_torch.compression.codec import Codec, decode_payload, make_codec, policy_flags
from photon_tpu_torch.compression.error_feedback import ErrorFeedback
from photon_tpu_torch.compression.payload import PAYLOAD_VERSION, CompressedPayload
from photon_tpu_torch.compression.quantize import dequantize_q8, quantize_q8
from photon_tpu_torch.compression.topk import topk_sparsify

POLICIES = ("off", "delta", "delta_q8", "delta_topk_q8")

__all__ = [
    "POLICIES",
    "PAYLOAD_VERSION",
    "Codec",
    "CompressedPayload",
    "ErrorFeedback",
    "decode_payload",
    "dequantize_q8",
    "make_codec",
    "policy_flags",
    "quantize_q8",
    "topk_sparsify",
]
