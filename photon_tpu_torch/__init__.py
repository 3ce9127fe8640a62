"""photon-tpu's serving, centralized and federated training paths in
PyTorch, with hand-written CUDA kernels.

The package mirrors ``photon_tpu``'s module names (``config/``,
``checkpoint/``, ``codec/``, ``data/``, ``metrics/``, ``models/``,
``ops/``, ``optim/``, ``train/``, ``serve/``, ``shm/``, ``strategy/``,
``federation/``, ``centralized.py``, ``federated.py``) so each module's
counterpart is easy to find. It imports ``torch``, numpy, PyYAML (``config/`` reads the
resolved YAML configs that ``photon_tpu`` writes) and the standard library
only: nothing of JAX and nothing of the ``photon_tpu`` package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
