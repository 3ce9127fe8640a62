"""Continuous-batching serving plane: paged KV cache, prefix cache,
per-cohort adapter pool, drafter, engine, scheduler, checkpoint hot-swap,
HTTP frontend, and the ``python -m photon_tpu_torch.serve`` entry point."""
