"""deepseek-v3-671b [arXiv:2412.19437]: 61L, d_model 7168, 128H, MLA
(q·k 128 + 64, v 128, ranks 1536 / 512), MoE 256 routed (top-8) + 1
shared, d_ff_expert 2048 (dense prefix of 3 layers at 18432), vocab
129280, MTP. About 682.6 B parameters, 1,365 GB in bf16.

Counterpart of ``repro.configs.deepseek_v3_671b``: the configuration, its
reduced smoke configuration, the dry run's cells (``make_cell``: the whole
model over the production mesh, the 256 routed experts one a card) and
the smoke run (one train step, then serving). The whole model is far more
than one card holds, so the card runs two named cuts at the published
widths (every width kept, depth and for training the routed experts
cut): ``serve_card_config`` and ``train_card_config``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import lm_common
from repro_torch.models import attention, moe
from repro_torch.models import transformer as tf

ARCH = "deepseek-v3-671b"
FAMILY = "lm"
SHAPES = list(lm_common.LM_SHAPES)
SKIP_SHAPES = {
    "long_500k": "pure full-span attention arch (MLA compresses the cache "
                 "but every layer still attends to all 524k positions); "
                 "skipped per the assignment's full-attention rule.",
}


def config() -> tf.LMConfig:
    return tf.LMConfig(
        name=ARCH, n_layers=61, d_model=7168, n_heads=128, n_kv=128,
        head_dim=128, d_ff=18432, vocab=129_280,
        mla=attention.MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                                qk_nope_head_dim=128, qk_rope_head_dim=64,
                                v_head_dim=128),
        moe=moe.MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                          n_shared=1, capacity_factor=1.25,
                          shard_experts=True),
        first_dense_layers=3, mtp_depth=1, tie_embeddings=False,
        rope_theta=10_000.0, param_dtype="bfloat16", remat="full",
        moe_chunk=4096)


def smoke_config() -> tf.LMConfig:
    return dataclasses.replace(
        config(), n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=16,
        d_ff=256, vocab=512,
        mla=attention.MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                qk_nope_head_dim=16, qk_rope_head_dim=8,
                                v_head_dim=16),
        moe=moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                          capacity_factor=2.0, shard_experts=True),
        first_dense_layers=1, param_dtype="float32",
        compute_dtype="float32", attn_chunk_q=16, attn_chunk_k=16,
        moe_chunk=64)


def serve_card_config() -> tf.LMConfig:
    """The serving cut for one 80 GB card: 4 layers, the 3 dense-FFN
    layers and 1 MoE layer with all 256 experts, every width as
    published; ``mtp_depth`` 0, since prefill and decode never read the
    MTP module. 15.11 B parameters, 30.2 GB in bf16 (one MoE layer alone
    is 11.3 B); with MTP kept it would be 26.7 B."""
    return dataclasses.replace(config(), n_layers=4, mtp_depth=0)


def train_card_config() -> tf.LMConfig:
    """The training cut for one 80 GB card: 2 layers (1 dense, 1 MoE) and
    the MTP module, the routed experts cut from 256 to 32 (top-8 and the
    shared expert kept), every other width as published. 5.82 B
    parameters: bf16 parameters, gradients and moments (``TRAIN_CFG``)
    take 46.6 GB. With all 256 experts one MoE layer's state alone is
    about 92 GB, more than the card holds."""
    cfg = config()
    return dataclasses.replace(
        cfg, n_layers=2, first_dense_layers=1,
        moe=dataclasses.replace(cfg.moe, n_experts=32))


def make_cell(shape: str):
    return lm_common.make_cell(ARCH, config(), shape)


def smoke(device=None):
    return lm_common.smoke_run(smoke_config(), device=device)
