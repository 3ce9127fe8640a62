"""Continuous-batching serving plane: paged KV cache, engine, scheduler,
HTTP frontend, and the ``python -m photon_tpu_torch.serve`` entry point."""
