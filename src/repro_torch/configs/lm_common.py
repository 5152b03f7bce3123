"""Cells shared by the LM architectures (counterpart of
``repro.configs.lm_common``): the shapes, the training configuration
``TRAIN_CFG``, ``make_cell`` (the dry run's train, prefill and decode
cells), the prefill and decode step functions and the smoke run (one
train step, then prefill and decode with the updated parameters).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs import base
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


# The decode cell's caches come from a prompt this long, as the reference's
# do; its step writes ring slot DECODE_STEP % W.
DECODE_PROMPT = 16
DECODE_STEP = 16


def _init(cfg: tf.LMConfig):
    def init(device):
        model = tf.init(cfg, torch.Generator(), device)
        return tf.param_tree(model), tf.param_axes(model)
    return init


def make_cell(arch: str, cfg: tf.LMConfig, shape_name: str,
              train_cfg: train_loop.TrainConfig = TRAIN_CFG) -> base.CellSpec:
    """The (arch × shape) cell: ``train`` is one train step (loss,
    gradients, clip, AdamW) on a (B, S) batch; ``prefill`` the prompt's
    last logits and caches at ``max_seq`` S; ``decode`` one token against
    S-slot caches built from a ``DECODE_PROMPT``-token prompt. Arguments
    are meta tensors, parameters those of ``tf.init`` on the meta device
    with ``tf.param_axes``; a cell's step counter is a Python int."""
    sh = LM_SHAPES[shape_name]
    S, B, kind = sh["seq"], sh["batch"], sh["kind"]
    init_fn = _init(cfg)

    if kind == "train":
        state, state_axes = base.train_state_specs(init_fn, train_cfg)
        step = train_loop.make_train_step(
            lambda p, b: tf.loss_fn(p, cfg, b["tokens"], b["labels"]),
            train_cfg)
        batch = {"tokens": base.spec((B, S), "int32"),
                 "labels": base.spec((B, S), "int32")}
        batch_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        return base.CellSpec(arch, shape_name, kind, step, (state, batch),
                             (state_axes, batch_axes))

    params, p_axes = base.eval_shape_with_axes(init_fn)
    if kind == "prefill":
        fn = partial(_prefill, cfg=cfg, max_seq=S)
        return base.CellSpec(arch, shape_name, kind, fn,
                             (params, base.spec((B, S), "int32")),
                             (p_axes, ("batch", "seq")))

    with torch.no_grad():
        _, caches = tf.prefill(tf._as_model(params), cfg,
                               base.spec((B, DECODE_PROMPT), "int32"),
                               max_seq=S)
    fn = partial(_decode, cfg=cfg)
    return base.CellSpec(
        arch, shape_name, kind, fn,
        (params, base.spec((B,), "int32"), base.spec((B,), "int32"), caches,
         DECODE_STEP),
        (p_axes, ("batch",), ("batch",), base.cache_axes(caches), None))


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
