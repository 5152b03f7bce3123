"""gemma3-27b [hf:google/gemma-3 family]: 62L, d_model 5376, 32H (GQA kv=16)
of 128, d_ff 21504, vocab 262144 — 5:1 local(1024):global, GeGLU, sandwich
norms, tied embeddings.

Counterpart of ``repro.configs.gemma3_27b``, with the reference's
deviations (DESIGN.md): one rope_theta for local and global layers, no
QK-norm. The configuration, its reduced smoke configuration, the dry run's
cells (``make_cell``) and the smoke run (one train step, then serving).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import lm_common
from repro_torch.models import transformer as tf

ARCH = "gemma3-27b"
FAMILY = "lm"
SHAPES = list(lm_common.LM_SHAPES)


def config() -> tf.LMConfig:
    return tf.LMConfig(
        name=ARCH, n_layers=62, d_model=5376, n_heads=32, n_kv=16,
        head_dim=128, d_ff=21504, vocab=262_144,
        window_pattern=(1024, 1024, 1024, 1024, 1024, 0),
        gated_ffn=True, ffn_act="gelu", post_norms=True, embed_scale=True,
        tie_embeddings=True, rope_theta=1_000_000.0,
        param_dtype="bfloat16", remat="full")


def smoke_config() -> tf.LMConfig:
    return dataclasses.replace(
        config(), n_layers=6, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=512, window_pattern=(16, 16, 16, 16, 16, 0),
        param_dtype="float32", compute_dtype="float32",
        attn_chunk_q=16, attn_chunk_k=16)


def make_cell(shape: str):
    return lm_common.make_cell(ARCH, config(), shape)


def smoke(device=None):
    return lm_common.smoke_run(smoke_config(), device=device)
