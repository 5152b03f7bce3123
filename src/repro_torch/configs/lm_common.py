"""Cells shared by the LM architectures (counterpart of
``repro.configs.lm_common``): the shapes, the training configuration
``TRAIN_CFG``, the prefill and decode step functions and the smoke run
(one train step, then prefill and decode with the updated parameters).
``make_cell`` stays with the reference: it builds XLA cells.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

TRAIN_CFG = train_loop.TrainConfig(
    opt=opt_lib.AdamWConfig(lr=3e-4, moment_dtype="bfloat16"))


def _prefill(params, tokens, *, cfg, max_seq):
    return tf.prefill(params, cfg, tokens, max_seq)


def _decode(params, token, pos, caches, step, *, cfg):
    return tf.decode_step(params, cfg, token, pos, caches, step)


def smoke_run(cfg: tf.LMConfig, seq: int = 32, batch: int = 2,
              seed: int = 0, device=None):
    """One train step (AdamW at lr 1e-3, as the reference's smoke run) on
    a random batch, then prefill, the greedy token and one decode step
    with the updated parameters, on a reduced config with random weights.
    Returns (train metrics, decode logits (batch, vocab))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = tf.init(cfg, gen, dev)
    tc = train_loop.TrainConfig(opt=opt_lib.AdamWConfig(lr=1e-3))
    state = train_loop.make_train_state(tf.param_tree(model), tc)
    step = train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]), tc)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    state, metrics = step(state, {"tokens": toks,
                                  "labels": torch.roll(toks, -1, 1)})
    with torch.no_grad():
        logits_pf, caches = _prefill(model, toks, cfg=cfg, max_seq=seq + 8)
        nxt = logits_pf[:, -1].argmax(-1).to(torch.int32)
        logits, _ = _decode(model, nxt, torch.full((batch,), seq,
                                                   dtype=torch.int32,
                                                   device=dev),
                            caches, seq, cfg=cfg)
    return metrics, logits
