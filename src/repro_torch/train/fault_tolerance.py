"""Fault-tolerant training loop: checkpoint/restart and elastic resume
(counterpart of ``repro.train.fault_tolerance``).

``run_resilient`` wraps a step function with (a) periodic async
checkpoints, (b) restore from the latest checkpoint on failure (a node
crash surfaces as an exception from the step; tests inject them), and (c)
data that is a function of the step counter alone, so a restart replays
the same batches.

The port's train step updates the state in place, so after a failure the
tensors of ``init_state`` hold a half-trained state. A restart copies the
restored state back into them in place (a model whose parameters are in
the state keeps training them); before the first checkpoint it copies
back a host snapshot of the true initial state, taken when the run
starts.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Callable

import torch

from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import tree

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ResilienceConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    max_failures: int = 3


@torch.no_grad()
def _copy_into(dst, src):
    for d, s in zip(tree.leaves(dst), tree.leaves(src)):
        d.copy_(s)
    return dst


def run_resilient(step_fn: Callable, init_state, get_batch: Callable,
                  n_steps: int, cfg: ResilienceConfig, axes_tree=None,
                  fail_hook: Callable | None = None):
    """Run ``n_steps`` of ``step_fn(state, batch) -> (state, metrics)``.

    ``get_batch(step)`` must be deterministic in ``step`` (elastic replay).
    ``fail_hook(step)`` may raise to simulate node failures (tests).
    Returns (final_state, metrics_history, n_failures); each metrics entry
    holds Python floats.
    """
    state = init_state
    start = 0
    initial = None
    latest = ckpt_lib.latest_step(cfg.ckpt_dir)
    if latest is not None:
        state = _copy_into(init_state, ckpt_lib.restore(
            cfg.ckpt_dir, latest, init_state))
        start = latest
        log.info("resumed from step %d", latest)
    else:
        initial = ckpt_lib.host_copy(init_state)

    saver = ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, axes_tree)
    history = []
    failures = 0
    step = start
    while step < n_steps:
        try:
            if fail_hook is not None:
                fail_hook(step)
            batch = get_batch(step)
            state, metrics = step_fn(state, batch)
            step += 1
            history.append({k: float(v) for k, v in metrics.items()})
            if step % cfg.ckpt_every == 0 or step == n_steps:
                saver.save(step, state)
        except Exception as e:  # noqa: BLE001 — any failure triggers restart
            failures += 1
            if failures > cfg.max_failures:
                saver.close()
                raise
            log.warning("step %d failed (%s); restarting from checkpoint",
                        step, e)
            saver._q.join()  # drain pending writes before reading
            latest = ckpt_lib.latest_step(cfg.ckpt_dir)
            if latest is not None:
                restored = ckpt_lib.restore(cfg.ckpt_dir, latest, init_state)
                step = latest
            else:
                restored = initial
                step = 0
            state = _copy_into(init_state, restored)
    saver.close()
    return state, history, failures
