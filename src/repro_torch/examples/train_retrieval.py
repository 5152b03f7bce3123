"""Train the two-tower retrieval model on synthetic interactions with the
fault-tolerant loop (async checkpoints + restore on failure), then build an
item index and run a speculative Spec-QP retrieval against it.

    PYTHONPATH=src python -m repro_torch.examples.train_retrieval --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_retrieval \\
        --device cpu

Counterpart of ``examples/train_retrieval.py``: the same batches (numpy
draws from ``default_rng(step)``) and defaults. A checkpoint directory
that already holds checkpoints is resumed from, as in the reference.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.models import recsys
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib


def make_batch(cfg, B, step, device=None):
    rng = np.random.default_rng(step)
    # co-click structure: user bag ids correlate with the positive item id
    pos = rng.integers(0, cfg.item_vocab, B)
    user_ids = (pos[:, None] + rng.integers(0, 5, (B, cfg.user_slots))) \
        % cfg.user_vocab
    user_dense = rng.standard_normal((B, cfg.n_dense_feat))
    item_ids = (pos[:, None] + np.zeros((B, cfg.item_slots), np.int64)) \
        % cfg.item_vocab
    item_dense = rng.standard_normal((B, cfg.n_dense_feat))
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return {
        "user_ids": t(user_ids, i32),
        "user_w": torch.ones((B, cfg.user_slots), device=dev),
        "user_dense": t(user_dense, f32),
        "item_ids": t(item_ids, i32),
        "item_w": torch.ones((B, cfg.item_slots), device=dev),
        "item_dense": t(item_dense, f32),
        "item_logq": torch.zeros((B,), device=dev),
    }


def main(argv=None, fail_hook=None) -> dict:
    """Train, index and retrieve; ``fail_hook(step)`` is handed to
    ``run_resilient`` (it may raise to inject a failure). Returns the
    final state, the metrics history, the failures, the query, the item
    index and the speculative result."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_retrieval_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without it)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("two-tower-retrieval").smoke_config()
    model = recsys.init(cfg, seed=0, device=dev)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=3e-3,
                                                        warmup_steps=20))
    state = train_loop.make_train_state(recsys.param_tree(model), tc)
    step = train_loop.make_train_step(
        lambda p, b: recsys.loss_fn(p, cfg, b), tc)

    res = ft.ResilienceConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100)
    state, history, fails = ft.run_resilient(
        step, state, lambda s: make_batch(cfg, args.batch, s, dev),
        args.steps, res, fail_hook=fail_hook)
    print(f"trained {len(history)} steps ({fails} restarts): "
          f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f}, "
          f"in-batch acc {history[-1]['in_batch_acc']:.2f}")

    # Index 4096 items, retrieve speculatively for one user.
    n_items = 4096
    params = state["params"]
    with torch.no_grad():
        cand = recsys.tower(
            params["item"], cfg,
            torch.as_tensor(np.arange(n_items)[:, None].repeat(
                cfg.item_slots, 1) % cfg.item_vocab, dtype=torch.int32,
                device=dev),
            torch.ones((n_items, cfg.item_slots), device=dev),
            torch.zeros((n_items, cfg.n_dense_feat), device=dev))
        user = make_batch(cfg, 1, 99, dev)
        q = recsys.tower(params["user"], cfg, user["user_ids"],
                         user["user_w"], user["user_dense"])[0]
    s, i, n = recsys.score_candidates(params, cfg, q, cand, 10)
    print(f"speculative retrieval: scored {int(n)}/"
          f"{n_items // cfg.topk_tile} tiles; top-3 items "
          f"{i[:3].tolist()} scores "
          f"{[round(x, 3) for x in s[:3].tolist()]}")
    exact_s, _ = torch.sort(cand @ q, descending=True, stable=True)
    if not torch.allclose(s, exact_s[:10], rtol=1e-5):
        raise AssertionError("speculative scores differ from the exact "
                             "top-k")
    print("speculative result == exact top-k")
    return dict(state=state, history=history, failures=fails, query=q,
                cand=cand, result=(s, i, n))


if __name__ == "__main__":
    main()
