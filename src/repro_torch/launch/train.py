"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Counterpart of ``repro.launch.train``: the same flags and batches, on one
card. It builds the arch's LM (the reduced smoke configuration, as the
reference's ``--smoke-config`` keeps by default), draws the parameters
from seed 0 and drives the fault-tolerant loop (periodic async
checkpoints, restore on failure, data a function of the step alone:
``train.fault_tolerance``). A checkpoint directory that already holds
checkpoints is resumed from. ``--device`` defaults to ``cuda`` and raises
without it; ``--device cpu`` runs on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib


def synth_lm_batch(cfg, batch: int, seq: int, step: int, device=None):
    """Uniform tokens from ``default_rng(step)``, labels the tokens shifted
    by one (the reference's draws, bit for bit)."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int64)
    t = torch.as_tensor(toks.astype(np.int32), device=resolve_device(device))
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def main(argv=None, fail_hook=None) -> dict:
    """Train; ``fail_hook(step)`` is handed to ``run_resilient`` (it may
    raise to inject a failure). Returns the final state, the metrics
    history and the failures."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke-config", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mod = get_arch(args.arch)
    if getattr(mod, "FAMILY", "") != "lm":
        raise SystemExit("train.py drives LM archs; GNN and recsys training "
                         "run through examples/ and the tests")
    cfg = mod.smoke_config() if args.smoke_config else mod.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = tf.init(cfg, gen, dev)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=args.lr))
    state = train_loop.make_train_state(tf.param_tree(model), tc)
    step_fn = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]), tc)

    res_cfg = ft.ResilienceConfig(ckpt_dir=args.ckpt_dir,
                                  ckpt_every=args.ckpt_every)
    t0 = time.time()
    state, history, fails = ft.run_resilient(
        step_fn, state,
        lambda s: synth_lm_batch(cfg, args.batch, args.seq, s, dev),
        args.steps, res_cfg, fail_hook=fail_hook)
    dt = time.time() - t0
    losses = [h.get("loss", float("nan")) for h in history]
    if losses:
        print(f"trained {len(history)} steps in {dt:.1f}s "
              f"({fails} restarts); loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}")
    else:
        print(f"nothing to train: {args.ckpt_dir} already holds step "
              f"{args.steps}")
    return dict(state=state, history=history, failures=fails)


if __name__ == "__main__":
    main()
