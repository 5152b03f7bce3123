"""granite-moe-3b-a800m [hf:ibm-granite]: 32L, d_model 1536, 24H (GQA
kv=8) of 64, MoE 40 experts top-8, d_ff_expert 512, vocab 49155. About
3.30 B parameters, 6.60 GB in bf16: one card serves and trains it whole.

Counterpart of ``repro.configs.granite_moe_3b_a800m``: the configuration,
its reduced smoke configuration, the dry run's cells (``make_cell``) and
the smoke run (one train step, then serving). ``shard_experts=False`` is
the reference's mesh choice: 40 experts do not divide the 16-wide model
axis, so every card keeps every expert and the experts' FFN width splits
over ``expert_mlp``. On one card it changes nothing.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import lm_common
from repro_torch.models import moe
from repro_torch.models import transformer as tf

ARCH = "granite-moe-3b-a800m"
FAMILY = "lm"
SHAPES = list(lm_common.LM_SHAPES)
SKIP_SHAPES = {
    "long_500k": "pure full-attention arch (no sliding-window layers); "
                 "skipped per the assignment's full-attention rule.",
}


def config() -> tf.LMConfig:
    return tf.LMConfig(
        name=ARCH, n_layers=32, d_model=1536, n_heads=24, n_kv=8,
        head_dim=64, d_ff=512, vocab=49_155,
        moe=moe.MoEConfig(n_experts=40, top_k=8, d_ff_expert=512,
                          n_shared=0, capacity_factor=1.25,
                          shard_experts=False),
        gated_ffn=True, ffn_act="silu", tie_embeddings=True,
        rope_theta=10_000.0, param_dtype="bfloat16", remat="full",
        moe_chunk=4096)


def smoke_config() -> tf.LMConfig:
    return dataclasses.replace(
        config(), n_layers=3, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=64,
        moe=moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=0,
                          capacity_factor=2.0, shard_experts=False),
        vocab=512, param_dtype="float32", compute_dtype="float32",
        attn_chunk_q=16, attn_chunk_k=16, moe_chunk=64)


def make_cell(shape: str):
    return lm_common.make_cell(ARCH, config(), shape)


def smoke(device=None):
    return lm_common.smoke_run(smoke_config(), device=device)
