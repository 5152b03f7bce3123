"""Decoder-only LM (counterpart of ``repro.models.transformer``): the
dense configurations (gemma2 / gemma3: local:global alternation, softcaps,
GeGLU, sandwich norms; starcoder2: sliding window, plain GELU), the MoE
ones (granite-moe: every layer's FFN a routed MoE; a dense-FFN prefix
with ``first_dense_layers``) and deepseek-v3 (MLA attention, a dense
prefix, routed and shared experts, MTP). The MoE layers' load-balance aux
is summed over the layers by ``backbone`` and weighted into ``loss_fn``;
prefill and decode drop it, as the reference does.

Layers are an ``nn.ModuleList`` walked in order, where the reference scans
stacked layers. ``loss_fn`` is the causal LM loss through the chunked
cross-entropy, with the reference's ``remat`` per layer (``full``: each
layer under ``torch.utils.checkpoint``; ``dots``: a selective checkpoint
that keeps the matmul outputs; ``none``). ``param_tree`` gives a model's
own parameters as a tree for ``train.loop``, and ``loss_fn`` takes the
model or that tree. ``prefill`` runs a batch of prompts and builds one KV
cache per layer (a W-slot ring for a window-W layer, ``max_seq`` slots for
a global one); ``caches_by_run`` regroups them into the reference's runs.
``decode_step`` writes the caches in place (an MLA layer's holds only
``c_kv``, ``k_rope`` and ``pos``).

With ``mtp_depth`` the model holds an ``MTP`` module (``proj`` and one
extra ``Layer``) and ``loss_fn`` adds the reference's multi-token
prediction term: [the backbone's last hidden state before ``final_norm``
; the embedding of the label] projected, one more layer at window 0, the
LM head against the labels shifted once more. The port runs that layer
under ``cfg.remat`` like the others (the reference keeps it outside
remat: the numbers are the same, the memory less). Prefill and decode
never read it.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import sharding
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as ffnlib

_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    window_pattern: tuple[int, ...] = (0,)   # cycled; 0 = global attention
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    gated_ffn: bool = True
    ffn_act: str = "silu"
    post_norms: bool = False                 # gemma2/3 sandwich norms
    embed_scale: bool = False                # gemma: x *= sqrt(D)
    tie_embeddings: bool = True
    mla: attn.MLAConfig | None = None
    moe: ffnlib.MoEConfig | None = None
    first_dense_layers: int = 0              # deepseek: dense-FFN prefix
    mtp_depth: int = 0
    aux_loss_weight: float = 0.01
    mtp_loss_weight: float = 0.3
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "blocked_causal"
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    remat: str = "full"                      # none | full | dots
    moe_chunk: int = 4096

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def windows(self) -> tuple[int, ...]:
        pat = self.window_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def attn_cfg(self) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.head_dim, rope_theta=self.rope_theta,
            softcap=self.attn_softcap, mla=self.mla,
            attn_chunk_q=self.attn_chunk_q, attn_chunk_k=self.attn_chunk_k)

    def ffn_cfg(self, dense: bool) -> ffnlib.FFNConfig:
        return ffnlib.FFNConfig(
            d_model=self.d_model, d_ff=self.d_ff, gated=self.gated_ffn,
            act=self.ffn_act,
            moe=None if dense else self.moe and dataclasses.replace(
                self.moe, chunk=self.moe_chunk))

    def stacks(self) -> list[tuple[bool, int, int]]:
        """[(is_dense_ffn, start_layer, n_layers)] — uniform layer groups."""
        if self.moe is None:
            return [(True, 0, self.n_layers)]
        out = []
        if self.first_dense_layers:
            out.append((True, 0, self.first_dense_layers))
        out.append((False, self.first_dense_layers,
                    self.n_layers - self.first_dense_layers))
        return out

    def dense_layers(self) -> list[bool]:
        return [d for d, _, n in self.stacks() for _ in range(n)]


class Layer(nn.Module):
    """One block: ``attn_norm``, ``attn``, ``ffn_norm``, ``ffn`` and, with
    ``post_norms``, ``attn_post`` and ``ffn_post``."""

    def __init__(self, attn_norm, attn_p, ffn_norm, ffn_p, attn_post=None,
                 ffn_post=None):
        super().__init__()
        self.attn, self.ffn = attn_p, ffn_p
        for name, w in (("attn_norm", attn_norm), ("ffn_norm", ffn_norm),
                        ("attn_post", attn_post), ("ffn_post", ffn_post)):
            setattr(self, name, None if w is None
                    else nn.Parameter(w, requires_grad=False))


class MTP(nn.Module):
    """The multi-token prediction module: ``proj`` (2·D, D) and one
    ``layer``."""

    def __init__(self, proj, layer: Layer):
        super().__init__()
        self.proj = nn.Parameter(proj, requires_grad=False)
        self.layer = layer


class LM(nn.Module):
    """``embed`` (V, D), ``final_norm`` (D,), optional ``lm_head`` (D, V),
    the blocks in order and, with ``mtp_depth``, ``mtp``."""

    def __init__(self, embed, final_norm, layers, lm_head=None, mtp=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.layers = nn.ModuleList(layers)
        self.mtp = mtp


def init(cfg: LMConfig, generator: torch.Generator, device=None) -> LM:
    """Random parameters drawn in place on ``device`` (CUDA by default)
    with the reference's distributions: normal × 1/√shape[0], the
    embedding normal × 1, norms zero. The numbers differ from
    ``jax.random``'s."""
    dev = resolve_device(device)
    D, pdt = cfg.d_model, cfg.pdtype

    def zeros():
        return torch.zeros((D,), device=dev)

    def layer(dense):
        return Layer(
            zeros(), attn.init(cfg.attn_cfg(), generator, dev, pdt),
            zeros(), ffnlib.init_ffn(cfg.ffn_cfg(dense), generator, dev, pdt),
            zeros() if cfg.post_norms else None,
            zeros() if cfg.post_norms else None)

    embed = ffnlib.normal_((cfg.vocab, D), generator, dev, pdt, scale=1.0)
    lm_head = (None if cfg.tie_embeddings
               else ffnlib.normal_((D, cfg.vocab), generator, dev, pdt))
    layers = [layer(dense) for dense in cfg.dense_layers()]
    mtp = (MTP(ffnlib.normal_((2 * D, D), generator, dev, pdt),
               layer(cfg.moe is None)) if cfg.mtp_depth else None)
    return LM(embed, zeros(), layers, lm_head, mtp)


def _layer_axes(lp: Layer) -> dict:
    axes = {"attn": attn.param_axes(lp.attn),
            "ffn": ffnlib.param_axes(lp.ffn)}
    for name in ("attn_norm", "ffn_norm", "attn_post", "ffn_post"):
        if getattr(lp, name) is not None:
            axes[name] = ("embed",)
    return axes


def param_axes(model: LM) -> dict:
    """The logical axes of each parameter, a tree mirroring
    ``param_tree(model)``: those the reference's ``init`` gives (through
    ``common.param``), without its leading stacked-layers axis, since the
    port keeps a list of layers: dense and MoE layers (deepseek's dense
    prefix and MoE stack alike), GQA and MLA, and the MTP layer."""
    axes = {"embed": ("vocab", "embed_fsdp"), "final_norm": ("embed",)}
    if model.lm_head is not None:
        axes["lm_head"] = ("embed_fsdp", "vocab")
    axes["layers"] = [_layer_axes(lp) for lp in model.layers]
    if model.mtp is not None:
        axes["mtp"] = {"proj": ("embed", "embed_fsdp"),
                       "layer": _layer_axes(model.mtp.layer)}
    return axes


def _embed_table(params):
    return sharding.constrain(params.embed, "vocab", "embed_fsdp")


def _embed(params: LM, cfg: LMConfig, tokens, table=None):
    """The scaled embedding of ``tokens`` from ``table`` (``params.embed``
    by default). Under installed rules the table's FSDP split is gathered
    where it is used and its vocab split stays: each rank looks up the
    ids it holds (DTensor's vocab-parallel embedding)."""
    table = params.embed if table is None else table
    table = sharding.pin_weight(table, "vocab", "embed_fsdp")
    x = F.embedding(tokens.long(), table).to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype)
    return x


def _layer_fwd(lp: Layer, cfg: LMConfig, dense: bool, x, attend):
    """One block → (x, aux, cache); ``attend(h)`` is the block's attention
    on the normed input → (h, the layer's KV cache or None)."""
    h, cache = attend(cm.rms_norm(x, lp.attn_norm, cfg.norm_eps))
    if cfg.post_norms:
        h = cm.rms_norm(h, lp.attn_post, cfg.norm_eps)
    x = x + h
    h = cm.rms_norm(x, lp.ffn_norm, cfg.norm_eps)
    h, aux = ffnlib.ffn(lp.ffn, cfg.ffn_cfg(dense), h)
    if cfg.post_norms:
        h = cm.rms_norm(h, lp.ffn_post, cfg.norm_eps)
    return x + h, aux, cache


def _positions(tokens):
    """(B, S) int32 positions 0..S-1, laid out as ``tokens`` (a sharded
    batch keeps its shards)."""
    S = tokens.shape[1]
    return (torch.zeros_like(tokens, dtype=torch.int32)
            + torch.arange(S, dtype=torch.int32, device=tokens.device))


class _Tree:
    """Attribute access to a ``param_tree``: ``p.layers[0].attn.wq`` is the
    tree's own tensor (so gradients reach its leaves); a key the tree does
    not hold reads None, as the module's absent parameters do."""

    def __init__(self, tree: dict):
        for key, val in tree.items():
            if isinstance(val, dict):
                val = _Tree(val)
            elif isinstance(val, list):
                val = [_Tree(v) for v in val]
            setattr(self, key, val)

    def __getattr__(self, name):
        return None


def param_tree(model: LM) -> dict:
    """The model's own parameters as a tree: ``{"embed", "final_norm",
    ["lm_head"], "layers": [{"attn": {"wq", "wk", "wv", "wo"},
    "attn_norm", "ffn": {"w_in", "w_out", ["w_gate"]}, "ffn_norm",
    ["attn_post", "ffn_post"]}, …], ["mtp": {"proj", "layer": {…}}]}``,
    one entry a layer where the reference stacks them; an MoE layer's
    ``ffn`` is ``{"router", "w_gate", "w_in", "w_out", ["shared": {"w_in",
    "w_out", ["w_gate"]}]}``, an MLA layer's ``attn`` ``{"w_dq", "q_norm",
    "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"}``. A train state
    built on it updates the model in place."""
    def nested(mod):
        out: dict = {}
        for name, p in mod.named_parameters():
            *path, leaf = name.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = p
        return out

    tree = {"embed": model.embed, "final_norm": model.final_norm}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head
    tree["layers"] = [nested(lp) for lp in model.layers]
    if model.mtp is not None:
        tree["mtp"] = nested(model.mtp)
    return tree


def _as_model(params):
    return _Tree(params) if isinstance(params, dict) else params


# Selective checkpoint of remat="dots": keep the matmuls' outputs (the
# reference's checkpoint_dots_with_no_batch_dims), recompute the rest.
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str, *args):
    """``fn(*args)`` under the config's remat policy (only where a
    gradient is being recorded)."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat must be none, full or dots, got {remat!r}")


def backbone(params: LM, cfg: LMConfig, tokens):
    """tokens (B, S) → final hidden states (B, S, D), aux loss (a 0-d f32
    tensor). Each layer runs under ``cfg.remat``."""
    params = _as_model(params)
    x = _embed(params, cfg, tokens, _embed_table(params))
    x = sharding.constrain(x, "batch", "seq", None)
    positions = _positions(tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(lp, dense, w, x):
        x, aux, _ = _layer_fwd(lp, cfg, dense, x, lambda h: (attn.forward(
            lp.attn, cfg.attn_cfg(), h, positions, w, cfg.attn_impl), None))
        return x, aux

    for lp, dense, w in zip(params.layers, cfg.dense_layers(),
                            cfg.windows()):
        x, aux = _remat(functools.partial(layer, lp, dense, w), cfg.remat, x)
        # Sequence-parallel residual stream: the carried activation (and
        # what remat saves of it) is split over model on its seq dim.
        x = sharding.constrain(x, "batch", "act_seq", None)
        aux_total = aux_total + aux
    return x, aux_total


def logits_from_hidden(params: LM, cfg: LMConfig, x):
    """Logits in the hidden states' dtype. No logit softcap here: the
    reference applies it in the loss only."""
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(x.dtype)
    return sharding.constrain(logits, "batch",
                              *(None,) * (logits.dim() - 2), "vocab")


def _lm_head_loss(params, cfg: LMConfig, x, labels):
    # The residual's sequence split is gathered and the head's FSDP split
    # with it, so that the loss's chunks keep their batch split and the
    # logits their vocab split (the reference leaves this to GSPMD).
    x = sharding.constrain(x, "batch", "seq", None)
    x = cm.rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        head = sharding.pin_weight(_embed_table(params), "vocab",
                                   "embed_fsdp").T
    else:
        head = sharding.pin_weight(params.lm_head, "embed_fsdp", "vocab")
    return cm.chunked_cross_entropy(x, head.to(x.dtype), labels,
                                    softcap_val=cfg.logit_softcap)


def _mtp_loss(params, cfg: LMConfig, x, tokens, labels):
    """The reference's MTP term: predict t + 2 from [h_t ; embed(label_t)]
    (h before ``final_norm``, ids < 0 read row 0) through ``mtp.proj``
    and one layer at window 0, against the labels shifted once more (the
    end filled with −1, which the loss ignores). → (mtp_loss, the layer's
    aux)."""
    if params.mtp is None:
        raise ValueError(f"{cfg.name}: mtp_depth is {cfg.mtp_depth} but the "
                         "parameters hold no mtp")
    # The rows of max(labels, 0), looked up as ``_embed`` does (each rank
    # the ids of its vocab shard; an index's gradient, an index_put on
    # split ids, is refused by DTensor), unscaled.
    table = sharding.pin_weight(_embed_table(params), "vocab", "embed_fsdp")
    emb_next = F.embedding(labels.clamp(min=0).long(), table).to(x.dtype)
    emb_next = sharding.constrain(emb_next, "batch", "act_seq", None)
    # The sequence-parallel halves are gathered before the projection, as
    # before the attention's and the MLP's, and its output stays so: a
    # product over (B, S) split by S, or its gradient's, is a flatten that
    # DTensor refuses.
    h = torch.cat([sharding.constrain(t, "batch", "seq", None)
                   for t in (x, emb_next)], -1) @ params.mtp.proj.to(x.dtype)
    h = sharding.constrain(h, "batch", "seq", None)
    positions = _positions(tokens)
    lp = params.mtp.layer

    def layer(h):
        h, aux, _ = _layer_fwd(lp, cfg, cfg.moe is None, h, lambda z: (
            attn.forward(lp.attn, cfg.attn_cfg(), z, positions, 0,
                         cfg.attn_impl), None))
        return h, aux

    h, aux = _remat(layer, cfg.remat, h)
    mtp_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                           -1)], 1)
    return _lm_head_loss(params, cfg, h, mtp_labels), aux


def loss_fn(params, cfg: LMConfig, tokens, labels):
    """Causal LM loss (+ the aux balance loss, 0 for dense FFNs; + the MTP
    term with ``mtp_depth``). tokens / labels (B, S); ``params`` an ``LM``
    or its ``param_tree``. Returns (loss, {"lm_loss", "aux_loss",
    ["mtp_loss"], "loss"}); ``aux_loss`` is the backbone's, as the
    reference reports it, while the total weights the MTP layer's aux
    too."""
    params = _as_model(params)
    x, aux = backbone(params, cfg, tokens)
    loss = _lm_head_loss(params, cfg, x, labels)
    metrics = {"lm_loss": loss, "aux_loss": aux}
    if cfg.mtp_depth:
        mtp_loss, mtp_aux = _mtp_loss(params, cfg, x, tokens, labels)
        aux = aux + mtp_aux
        loss = loss + cfg.mtp_loss_weight * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    total = loss + cfg.aux_loss_weight * aux
    metrics["loss"] = total
    return total, metrics


def _runs(cfg: LMConfig, max_seq: int):
    """RLE runs of (stack_idx, local_start, count, window, cache_len)."""
    wins = cfg.windows()
    runs = []
    for si, (dense, start, count) in enumerate(cfg.stacks()):
        i = 0
        while i < count:
            w = wins[start + i]
            j = i
            while j < count and wins[start + j] == w:
                j += 1
            cache_len = min(w, max_seq) if w > 0 else max_seq
            runs.append((si, i, j - i, w, cache_len))
            i = j
    return runs


def caches_by_run(cfg: LMConfig, caches: list[dict]) -> list[dict]:
    """Per-layer caches → the reference's per-run caches, each array with
    a leading layers axis (the layout of ``repro``'s ``prefill``)."""
    stacks = cfg.stacks()
    out = []
    for si, lo, n, _, _ in _runs(cfg, 1):
        first = stacks[si][1] + lo
        layer = caches[first:first + n]
        out.append({key: torch.stack([c[key] for c in layer])
                    for key in layer[0]})
    return out


def prefill(params: LM, cfg: LMConfig, tokens, max_seq: int):
    """Run the prompt, build per-layer caches. Returns (last_logits
    (B, 1, V), caches)."""
    params = _as_model(params)
    # The reference leaves this layout to GSPMD; it is named here as the
    # backbone names it.
    x = sharding.constrain(_embed(params, cfg, tokens), "batch", "seq", None)
    positions = _positions(tokens)
    caches = []
    for lp, dense, w in zip(params.layers, cfg.dense_layers(),
                            cfg.windows()):
        clen = min(w, max_seq) if w > 0 else max_seq
        x, _, cache = _layer_fwd(lp, cfg, dense, x, lambda h: attn.prefill(
            lp.attn, cfg.attn_cfg(), h, positions, w, cfg.attn_impl, clen))
        caches.append(cache)
    return logits_from_hidden(params, cfg, x[:, -1:]), caches


def decode_step(params: LM, cfg: LMConfig, token, pos, caches, step: int):
    """One decode step. token: (B,) int; pos: (B,) abs position; step: the
    ring-write counter. Writes ``caches`` in place; returns (logits (B, V),
    caches)."""
    params = _as_model(params)
    x = sharding.constrain(_embed(params, cfg, token)[:, None], "batch",
                           "seq", None)     # as in ``prefill``
    for lp, dense, w, cache in zip(params.layers, cfg.dense_layers(),
                                   cfg.windows(), caches):
        x, _, _ = _layer_fwd(lp, cfg, dense, x, lambda h: attn.decode(
            lp.attn, cfg.attn_cfg(), h, pos, w, cache, step))
    return logits_from_hidden(params, cfg, x)[:, 0], caches
