"""Train a reduced LM config for a few hundred steps with checkpoint and
restart.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        --arch gemma2-2b --steps 150 --device cpu

Counterpart of ``examples/train_lm.py``: the same skewed bigram batches
(numpy draws from ``default_rng(step)``), AdamW at lr 1e-3 with 20 warmup
steps, a checkpoint every 100 steps, and the check that the loss falls.
A checkpoint directory that already holds checkpoints is resumed from.
``--device`` defaults to ``cuda`` and raises without it.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib


def make_batch(cfg, batch: int, seq: int, step: int, device=None):
    """A skewed synthetic token stream with a learnable bigram structure:
    each row starts anywhere and steps by 1, 2 or 3."""
    rng = np.random.default_rng(step)
    start = rng.integers(0, cfg.vocab, batch)
    toks = (start[:, None] + np.arange(seq)[None, :] *
            rng.integers(1, 4)) % cfg.vocab
    t = torch.as_tensor(toks.astype(np.int32), device=resolve_device(device))
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def main(argv=None, fail_hook=None) -> dict:
    """Train; ``fail_hook(step)`` is handed to ``run_resilient`` (it may
    raise to inject a failure). Returns the final state, the metrics
    history and the failures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_lm_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).smoke_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = tf.init(cfg, gen, dev)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-3,
                                                        warmup_steps=20))
    state = train_loop.make_train_state(tf.param_tree(model), tc)
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]), tc)

    res = ft.ResilienceConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100)
    state, hist, fails = ft.run_resilient(
        step, state, lambda s: make_batch(cfg, args.batch, args.seq, s, dev),
        args.steps, res, fail_hook=fail_hook)
    print(f"{args.arch}: {len(hist)} steps, loss "
          f"{hist[0]['loss']:.2f} -> {hist[-1]['loss']:.2f} "
          f"({fails} restarts)")
    assert hist[-1]["loss"] < hist[0]["loss"], "loss did not improve"
    return dict(state=state, history=hist, failures=fails)


if __name__ == "__main__":
    main()
