"""photon-tpu's serving, centralized and federated training, per-cohort
LoRA adapters, evaluation, data preparation, checkpoint interop and fault
injection paths in PyTorch, with hand-written CUDA kernels.

The package mirrors ``photon_tpu``'s module names (``adapters/``, ``chaos/``,
``config/``, ``checkpoint/``, ``codec/``, ``data/``, ``eval/``, ``metrics/``,
``models/``, ``native/``, ``ops/``, ``optim/``, ``train/``, ``serve/``, ``shm/``,
``strategy/``, ``federation/``, ``centralized.py``, ``federated.py``) so each module's
counterpart is easy to find. It imports ``torch``, numpy, PyYAML (``config/`` reads the
resolved YAML configs that ``photon_tpu`` writes) and the standard library
only: nothing of JAX and nothing of the ``photon_tpu`` package.
``data/tokenizer.py::load_tokenizer`` imports ``transformers`` when it is
asked for a local Hugging Face tokenizer directory, and only then.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
