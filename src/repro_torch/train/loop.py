"""Train-step factory: gradients → clip → AdamW, with optional gradient
accumulation over microbatches and gradient compression (counterpart of
``repro.train.loop``).

``make_train_step(loss_fn, train_cfg)`` returns ``step(state, batch) →
(state, metrics)``. The state is the reference's tree, ``{"params": …,
"opt": {"m", "v", "step"}, ["err_fb"]}``; its parameters may be a
module's own ``nn.Parameter``s (e.g. ``recsys.param_tree(model)``), and
the step updates them in place, so the module trains with it. Gradients
come from ``torch.autograd.grad`` of ``loss_fn(params, batch) → (loss,
metrics)``; the metrics come back detached.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.train import compression, tree
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: opt_lib.AdamWConfig = opt_lib.AdamWConfig()
    accum_steps: int = 1
    compress_grads: bool = False   # int8 + error feedback on the DP axis


def make_train_state(params, train_cfg: TrainConfig):
    """The train state around ``params``, whose floating-point leaves are
    marked to require gradients (in place: a module's parameters stay its
    own)."""
    for p in tree.leaves(params):
        if p.is_floating_point() and not p.requires_grad:
            p.requires_grad_(True)
    state = {"params": params,
             "opt": opt_lib.init_opt_state_lowp(params, train_cfg.opt)}
    if train_cfg.compress_grads:
        state["err_fb"] = tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def _detached(metrics):
    return {k: v.detach() for k, v in (metrics or {}).items()}


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``; ``grads``
    mirrors ``params`` (zeros for a leaf the loss does not use)."""
    leaves = tree.leaves(params)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), _detached(metrics), tree.unflatten(params, grads)


def compute_grads(loss_fn: Callable, params, batch, accum_steps: int = 1):
    """(grads, metrics). With ``accum_steps`` A > 1 every batch leaf has a
    leading (A, …) axis: the microbatches' gradients are summed in float32
    and divided by A, their metrics averaged."""
    if accum_steps == 1:
        _, metrics, grads = value_and_grad(loss_fn, params, batch)
        return grads, metrics
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree.leaves(params)]
    steps = []
    for a in range(accum_steps):
        mb = tree.tree_map(lambda x: x[a], batch)
        _, metrics, grads = value_and_grad(loss_fn, params, mb)
        for s, g in zip(acc, tree.leaves(grads)):
            s += g
        steps.append(metrics)
        del grads
    grads = tree.unflatten(params, [s / accum_steps for s in acc])
    metrics = {k: torch.stack([m[k] for m in steps]).mean()
               for k in (steps[0] if steps else {})}
    return grads, metrics


def make_train_step(loss_fn: Callable, train_cfg: TrainConfig):
    """loss_fn(params, batch) → (loss, metrics)."""

    def train_step(state, batch):
        grads, metrics = compute_grads(loss_fn, state["params"], batch,
                                       train_cfg.accum_steps)
        if train_cfg.compress_grads:
            grads, state["err_fb"] = compression.compress_decompress(
                grads, state["err_fb"])
        _, _, opt_metrics = opt_lib.apply_updates(
            state["params"], grads, state["opt"], train_cfg.opt)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return state, metrics

    return train_step
