"""gemma2-2b [arXiv:2408.00118]: 26L, d_model 2304, 8H (GQA kv=4), d_ff 9216,
vocab 256000 — local(4096):global alternating, attention softcap 50,
GeGLU, sandwich norms. About 2.61 B parameters, 5.23 GB in bf16: one card
holds it whole.

Counterpart of ``repro.configs.gemma2_2b``: the configuration, its reduced
smoke configuration, the dry run's cells (``make_cell``) and the smoke run
(one train step, then serving).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf

ARCH = "gemma2-2b"
FAMILY = "lm"
SHAPES = list(lm_common.LM_SHAPES)


def config() -> tf.LMConfig:
    return tf.LMConfig(
        name=ARCH, n_layers=26, d_model=2304, n_heads=8, n_kv=4,
        head_dim=256, d_ff=9216, vocab=256_000,
        window_pattern=(4096, 0), attn_softcap=50.0, logit_softcap=30.0,
        gated_ffn=True, ffn_act="gelu", post_norms=True, embed_scale=True,
        tie_embeddings=True, rope_theta=10_000.0,
        param_dtype="bfloat16", remat="full")


def smoke_config() -> tf.LMConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, window_pattern=(16, 0), param_dtype="float32",
        compute_dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
        moe_chunk=64)


def make_cell(shape: str):
    return lm_common.make_cell(ARCH, config(), shape)


def smoke(device=None):
    return lm_common.smoke_run(smoke_config(), device=device)
