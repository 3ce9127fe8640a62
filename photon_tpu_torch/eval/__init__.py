"""Evaluation: the ICL gauntlet (llm-foundry's Eval Gauntlet, driven by
photon's ``icl_tasks_config`` / ``eval_gauntlet_config``) and the eval
CLI (``python -m photon_tpu_torch.eval``)."""

from photon_tpu_torch.eval.gauntlet import GauntletConfig, TaskSuite, run_gauntlet_suite
from photon_tpu_torch.eval.icl import ICLTask, evaluate_task, make_logprob_fn, run_gauntlet

__all__ = [
    "GauntletConfig",
    "ICLTask",
    "TaskSuite",
    "evaluate_task",
    "make_logprob_fn",
    "run_gauntlet",
    "run_gauntlet_suite",
]
