"""Serving cells shared by the LM architectures (counterpart of
``repro.configs.lm_common``): the shapes, the prefill and decode step
functions and the serving half of the smoke run. The train cell is not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import transformer as tf

LM_SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _prefill(params, tokens, *, cfg, max_seq):
    return tf.prefill(params, cfg, tokens, max_seq)


def _decode(params, token, pos, caches, step, *, cfg):
    return tf.decode_step(params, cfg, token, pos, caches, step)


@torch.no_grad()
def smoke_run(cfg: tf.LMConfig, seq: int = 32, batch: int = 2,
              seed: int = 0, device=None):
    """Prefill a random batch, take the greedy token, one decode step, on
    a reduced config with random weights. Returns the decode logits
    (batch, vocab)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = tf.init(cfg, gen, dev)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         device=dev, dtype=torch.int32)
    logits_pf, caches = _prefill(params, toks, cfg=cfg, max_seq=seq + 8)
    nxt = logits_pf[:, -1].argmax(-1).to(torch.int32)
    logits, _ = _decode(params, nxt, torch.full((batch,), seq,
                                                dtype=torch.int32,
                                                device=dev),
                        caches, seq, cfg=cfg)
    return logits
