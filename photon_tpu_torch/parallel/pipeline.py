"""Pipeline parallelism: the GPipe schedule over the ``pipe`` mesh axis (the
port of ``photon_tpu/parallel/pipeline.py``).

One process drives every stage, as it drives every position of a mesh
(``parallel/mesh.py``):

- **Stages.** Stage ``s`` is a :class:`~photon_tpu_torch.parallel.spmd.
  MeshModel` over the positions whose ``pipe`` index is ``s``: the layer
  axis of the stacked block weights is sharded over ``pipe``
  (``parallel/sharding.py``), so each stage's slab of ``n_layers / pipe``
  layers lives on its positions' devices, and inside a stage ``data``,
  ``fsdp``, ``tensor`` and ``expert`` work as on a mesh without a
  pipeline. The state, the optimizer tree and the checkpoints are a
  single device's (:class:`~photon_tpu_torch.parallel.spmd.MeshTrainState`).
- **Ticks.** At tick ``t`` stage ``s`` runs microbatch ``t − s``: stage 0
  embeds it (``wte``, plus ``wpe`` when the config uses it), the last
  stage runs ``ln_f`` and the (chunked or unchunked) cross entropy, the
  tied head reading the same ``wte``. Activations cross stages with
  ``.to(device)``. The ticks are issued in order, every stage's work of a
  tick before the next tick's, so on several cards the stages' launches
  overlap.
- **Bubble ticks are skipped.** JAX computes the embed and the CE tail on
  every stage at every tick and masks the dead ones (``lax.cond`` crashes
  its partitioner there); a skipped tick does the same arithmetic on the
  live ticks, so the loss and the gradients are unchanged.
- **The MoE aux** counts only real microbatches: each stage's layers add
  their Switch aux for the microbatch they ran.
- **Remat at JAX's two levels** under ``cfg.remat``: each (stage,
  microbatch) forward is a ``checkpoint`` (only the stage-boundary
  activation is kept), and each layer inside it another (the tick's own
  backward recomputes one layer at a time; the stages run the dense
  ``xla`` attention, whose score matrices this bounds).
- **One backward** over the mean of the microbatches' losses. Autograd
  through the ``.to`` moves supplies JAX's ``psum`` over ``pipe`` for the
  parameters every stage reads (``wte``, ``wpe``, ``ln_f``, the head);
  the slab gradients stay on their stage.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from photon_tpu_torch.config.schema import ModelConfig
from photon_tpu_torch.optim.build import Optimizer
from photon_tpu_torch.parallel.mesh import Mesh
from photon_tpu_torch.parallel.spmd import MeshModel, MeshTrainState, finish_step, leaves_of


class Pipeline:
    """The stages of ``mesh``'s ``pipe`` axis and the GPipe schedule of
    ``n_microbatches`` microbatches a batch."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, n_microbatches: int) -> None:
        n_stages = mesh.shape["pipe"]
        if cfg.n_layers % n_stages:
            raise ValueError(f"n_layers={cfg.n_layers} not divisible by pipe={n_stages}")
        self.cfg = cfg
        self.n_micro = n_microbatches
        self.stages = [MeshModel(cfg, mesh, stage=s) for s in range(n_stages)]

    def _micro(self, tokens: dict) -> list[dict]:
        b = next(iter(tokens.values())).shape[0]
        if b % self.n_micro:
            raise ValueError(f"batch {b} not divisible by {self.n_micro} microbatches")
        rows = b // self.n_micro
        return [{d: t[j * rows:(j + 1) * rows] for d, t in tokens.items()}
                for j in range(self.n_micro)]

    def loss(self, params: dict, tokens: dict, loss_chunk_tokens: int) -> torch.Tensor:
        """Mean over the microbatches of each one's mean next-token cross
        entropy plus the weighted MoE aux of every stage that ran it: the
        non-pipelined step's loss with the same microbatches. On the last
        stage's first device."""
        micro = self._micro(tokens)
        n_stages, last = len(self.stages), self.stages[-1]
        w_aux = self.cfg.moe_aux_weight
        held: dict[int, tuple] = {}  # microbatch -> activations between stages
        total = None
        for t in range(self.n_micro + n_stages - 1):
            for s, stage in enumerate(self.stages):
                m = t - s
                if not 0 <= m < self.n_micro:
                    continue  # a bubble tick: nothing to run

                def tick(*xs, stage=stage, s=s, m=m):
                    if s == 0:
                        xs = stage.embed(params, micro[m])
                    xs, aux = stage.blocks(params, xs)
                    if s < n_stages - 1:
                        return (*xs, aux)
                    b, seq = next(iter(micro[m].values())).shape
                    ce = stage.head_ce(params, xs, micro[m], loss_chunk_tokens)
                    return (ce / (b * (seq - 1)) + w_aux * aux,)

                xs = () if s == 0 else tuple(x.to(stage.home[g])
                                             for g, x in zip(stage.home, held.pop(m)))
                if self.cfg.remat:
                    out = checkpoint(tick, *xs, use_reentrant=False)
                else:
                    out = tick(*xs)
                if s < n_stages - 1:
                    *xs, aux = out
                    held[m] = tuple(xs)
                    part = w_aux * aux
                else:
                    part = out[0]
                part = part.to(last.first)
                total = part if total is None else total + part
        return total / self.n_micro

    @torch.no_grad()
    def ce_sum(self, params: dict, tokens: dict, loss_chunk_tokens: int) -> torch.Tensor:
        """The summed cross entropy of the whole batch, stage after stage
        (no microbatches, no MoE aux)."""
        xs = self.stages[0].embed(params, tokens)
        for stage in self.stages:
            xs = tuple(x.to(stage.home[g]) for g, x in zip(stage.home, xs))
            xs, _ = stage.blocks(params, xs)
        return self.stages[-1].head_ce(params, xs, tokens, loss_chunk_tokens)


def make_pipeline_train_step(pipeline: Pipeline, tx: Optimizer,
                             loss_chunk_tokens: int = 2048) -> Callable:
    """The pipelined ``(state, tokens) -> (state, metrics)``, the meshed
    step's contract (``parallel/spmd.py::make_mesh_train_step``): one
    backward over the pipeline's loss, then ``grad_norm``, the optimizer
    and ``param_norm``."""

    def train_step(state: MeshTrainState, tokens: dict):
        leaves = leaves_of(state.params)
        loss = pipeline.loss(state.params, tokens, loss_chunk_tokens)
        grads = list(torch.autograd.grad(loss, [t for _, _, t in leaves]))
        return finish_step(tx, state, leaves, loss.detach(), grads)

    return train_step


def make_pipeline_eval_step(pipeline: Pipeline, loss_chunk_tokens: int = 2048) -> Callable:
    """``(params, tokens) -> (sum_ce, n_tokens)`` through the stages."""

    def eval_step(params: dict, tokens: dict):
        b, seq = next(iter(tokens.values())).shape
        return pipeline.ce_sum(params, tokens, loss_chunk_tokens), b * (seq - 1)

    return eval_step
