"""Roofline terms of a dry-run cell on H100s (counterpart of
``repro.launch.analysis``).

    compute term    = flops / peak_flops
    memory term     = bytes / hbm_bw
    collective term = Σ over collectives of wire bytes / the link's rate

all per card. Flops and bytes are one rank's: the dry run counts the ops
each rank runs on its own shards (``launch.dryrun``), where the reference
reads XLA's ``cost_analysis`` of the per-device program. Collective bytes
come from the dry run's record of each collective (its kind, operand and
output bytes, its mesh axis), where the reference parses the optimised HLO.

The link model: a collective takes the slowest link its mesh axis crosses.
Ranks go row-major over the mesh, 8 to a node; a line of ranks along an
axis that stays within one node runs over NVLink (450 GB/s a direction a
card), one that spans nodes over InfiniBand (NDR, 50 GB/s a card). On the
16 × 16 production mesh both axes span nodes (``model`` two, ``data``
sixteen), so every collective is priced at InfiniBand's rate.

Hardware: H100 SXM5, 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM3 (NVIDIA's
data sheet); the reference's are a TPU v5e's.
"""
from __future__ import annotations

import dataclasses

HW = {
    "peak_flops": 989.4e12,     # dense bf16 a card
    "hbm_bw": 3.35e12,          # bytes/s a card
    "nvlink_bw": 450e9,         # bytes/s a card a direction, within a node
    "ib_bw": 50e9,              # bytes/s a card across nodes (NDR 400 Gb/s)
    "cards_per_node": 8,
}

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")


def link_bw(crosses_nodes: bool) -> float:
    return HW["ib_bw"] if crosses_nodes else HW["nvlink_bw"]


def collective_bytes(records) -> dict:
    """Per-card collective traffic from the dry run's records, each
    ``(kind, operand_bytes, output_bytes, crosses_nodes)`` with ``kind`` one
    of ``COLL_OPS``. ``operand`` sums the operands' bytes (the reference's
    definition); ``wire`` applies its traffic model per kind: an all-gather
    moves its output less its operand, an all-reduce twice its operand,
    the others their operand. ``wire_total`` is what the roofline's
    collective term uses, ``wire_nvlink`` the part of it within a node."""
    out = {k: 0 for k in COLL_OPS}
    wire = {k: 0 for k in COLL_OPS}
    count = {k: 0 for k in COLL_OPS}
    nvlink = 0
    for kind, ob, yb, crosses in records:
        out[kind] += ob
        count[kind] += 1
        if kind == "all-gather":
            w = max(yb - ob, 0)
        elif kind == "all-reduce":
            w = 2 * ob
        else:
            w = ob
        wire[kind] += w
        if not crosses:
            nvlink += w
    out["total"] = sum(out[k] for k in COLL_OPS)
    out["wire_total"] = sum(wire[k] for k in COLL_OPS)
    out["wire_nvlink"] = nvlink
    out["wire"] = wire
    out["counts"] = count
    return out


@dataclasses.dataclass
class Roofline:
    """All inputs are PER-CARD quantities except model_flops, which is the
    global 6·N·D figure. ``nvlink_bytes`` is the part of ``coll_bytes``
    that stays within a node; the rest crosses InfiniBand."""

    flops: float
    bytes_accessed: float
    coll_bytes: float            # per-card wire bytes
    n_chips: int
    model_flops: float = 0.0
    nvlink_bytes: float = 0.0

    @property
    def compute_s(self):
        return self.flops / HW["peak_flops"]

    @property
    def memory_s(self):
        return self.bytes_accessed / HW["hbm_bw"]

    @property
    def collective_s(self):
        return (self.nvlink_bytes / HW["nvlink_bw"]
                + (self.coll_bytes - self.nvlink_bytes) / HW["ib_bw"])

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self):
        total = self.flops * self.n_chips
        return self.model_flops / total if total else 0.0

    def row(self):
        return {
            "flops": self.flops, "bytes": self.bytes_accessed,
            "coll_bytes": self.coll_bytes, "chips": self.n_chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
        }


def lm_model_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) with N = active param count."""
    n_active = lm_active_params(cfg)
    tokens = batch * seq if kind != "decode" else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def lm_active_params(cfg) -> float:
    """Active (per-token) parameter count for an LMConfig."""
    D = cfg.d_model
    n = cfg.vocab * D  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab * D
    for (dense, start, count) in cfg.stacks():
        if cfg.mla:
            m = cfg.mla
            attn = (D * m.q_lora_rank
                    + m.q_lora_rank * cfg.n_heads
                    * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * cfg.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + cfg.n_heads * m.v_head_dim * D)
        else:
            attn = D * cfg.n_heads * cfg.head_dim \
                + 2 * D * cfg.n_kv * cfg.head_dim \
                + cfg.n_heads * cfg.head_dim * D
        if dense or cfg.moe is None:
            ff = D * cfg.d_ff * (3 if cfg.gated_ffn else 2)
        else:
            e = cfg.moe
            per_expert = D * e.d_ff_expert * 3
            ff = e.top_k * per_expert + e.n_shared * per_expert \
                + D * e.n_experts  # router
        n += count * (attn + ff)
    return float(n)
