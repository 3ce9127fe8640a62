"""ADOPT (Taniguchi et al., 2024) as plain tensor functions over flat dicts.

The port of ``photon_tpu/optim/adopt.py``. ADOPT normalizes each gradient
by the previous second moment and updates in clipped normalized-gradient
space::

    step 0:  v_0 = g_0^2                       (no parameter update)
    step t:  m_t = b1 m_{t-1} + (1 - b1) clip(g_t / max(sqrt(v_{t-1}), eps), c_t)
             update = -lr(t) (m_t + wd p)
             v_t = b2 v_{t-1} + (1 - b2) g_t^2
    with clip bound c_t = max(t, 1)^{1/4}.

The update is one elementwise pass that the JAX package leaves to XLA; it
stays torch ops here. The moments are updated in place.
"""

from __future__ import annotations

import torch


def adopt_update(grads: dict[str, torch.Tensor], m: dict[str, torch.Tensor],
                 v: dict[str, torch.Tensor], params: dict[str, torch.Tensor], *,
                 count: int, lr: float, b1: float = 0.9, b2: float = 0.9999,
                 eps: float = 1.0e-6, weight_decay: float = 0.0) -> dict[str, torch.Tensor]:
    """One ADOPT step over the names of ``grads``. ``count`` is the number
    of updates applied before this one and ``lr`` the schedule's value at
    it. ``m`` and ``v`` (fp32) change in place; returns the updates, in
    each parameter's dtype."""
    clip = max(float(count), 1.0) ** 0.25
    out = {}
    for name, g in grads.items():
        g = g.float()
        if count == 0:
            v[name].copy_(g * g)
            out[name] = torch.zeros_like(params[name])
            continue
        normed = (g / torch.clamp(v[name].sqrt(), min=eps)).clamp_(-clip, clip)
        m[name].mul_(b1).add_(normed, alpha=1.0 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        d = m[name] * -lr
        if weight_decay:
            d = d - (lr * weight_decay) * params[name].float()
        out[name] = d.to(params[name].dtype)
    return out
