"""starcoder2-3b [arXiv:2402.19173]: 30L, d_model 3072, 24H (GQA kv=2), d_ff
12288, vocab 49152 — sliding-window 4096 on every layer, RoPE, plain-GELU
MLP. (As in the reference: RMSNorm in place of LayerNorm.)

Counterpart of ``repro.configs.starcoder2_3b``: the configuration, its
reduced smoke configuration, the dry run's cells (``make_cell``) and the
smoke run (one train step, then serving).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf

ARCH = "starcoder2-3b"
FAMILY = "lm"
SHAPES = list(lm_common.LM_SHAPES)


def config() -> tf.LMConfig:
    return tf.LMConfig(
        name=ARCH, n_layers=30, d_model=3072, n_heads=24, n_kv=2,
        head_dim=128, d_ff=12288, vocab=49_152,
        window_pattern=(4096,), gated_ffn=False, ffn_act="gelu",
        tie_embeddings=True, rope_theta=999_999.0,
        param_dtype="bfloat16", remat="full")


def smoke_config() -> tf.LMConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, window_pattern=(16,), param_dtype="float32",
        compute_dtype="float32", attn_chunk_q=16, attn_chunk_k=16)


def make_cell(shape: str):
    return lm_common.make_cell(ARCH, config(), shape)


def smoke(device=None):
    return lm_common.smoke_run(smoke_config(), device=device)
