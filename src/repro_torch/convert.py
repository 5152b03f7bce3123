"""Carry a store or parameters built elsewhere (e.g. by the JAX package)
into the port.

The arguments are numpy arrays: the ``TripleStore`` / ``RelaxTable``
fields (the sketch as uint32 words), a two-tower, LM or GAT parameter
tree, or a two-tower or GAT train state. The results are the port's types
on ``device``, so both packages then read the very same data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kg
from repro_torch.core.types import TripleStore, RelaxTable, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import recsys
from repro_torch.models import transformer as tf
from repro_torch.models.gnn import gat
from repro_torch.train import tree


def store_from_numpy(keys, scores, lengths, sorted_keys, stats, sketch,
                     device=None) -> TripleStore:
    sketch = np.asarray(sketch)
    if sketch.dtype != np.uint32:
        raise ValueError(f"sketch must be uint32 words, got {sketch.dtype}")
    return kg.store_from_arrays(
        dict(keys=np.asarray(keys), scores=np.asarray(scores),
             lengths=np.asarray(lengths), sorted_keys=np.asarray(sorted_keys),
             stats=np.asarray(stats), sketch=sketch),
        resolve_device(device))


def relax_from_numpy(ids, weights, device=None) -> RelaxTable:
    dev = resolve_device(device)
    return RelaxTable(
        ids=torch.from_numpy(np.array(ids, dtype=np.int32)).to(dev),
        weights=torch.from_numpy(np.array(weights, dtype=np.float32)).to(dev))


def two_tower_from_numpy(values, cfg: recsys.TwoTowerConfig,
                         device=None) -> recsys.TwoTower:
    """``values`` is ``{"user": {"table", "w0", …}, "item": {…}}`` of
    arrays (the reference's ``recsys.init(...)[0]``)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def tower(v):
        n = len(cfg.tower_mlp)
        if set(v) != {"table"} | {f"w{i}" for i in range(n)}:
            raise ValueError(f"tower keys {sorted(v)} do not match a "
                             f"{n}-layer MLP")
        return recsys.Tower(f32(v["table"]), [f32(v[f"w{i}"])
                                              for i in range(n)])

    return recsys.TwoTower(cfg, tower(values["user"]), tower(values["item"]))


def _tensor(a, dev) -> torch.Tensor:
    """numpy → torch, bit for bit. A bfloat16 array (ml_dtypes, what
    ``np.asarray`` gives for a JAX bf16 array) goes through its int16
    view, which ``torch.from_numpy`` takes."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _keys(name, tree, want):
    if set(tree) != set(want):
        raise ValueError(f"{name} keys {sorted(tree)} do not match the "
                         f"config's {sorted(want)}")


def lm_from_numpy(values, cfg: tf.LMConfig, device=None) -> tf.LM:
    """``values`` is the reference's ``transformer.init(...)[0]`` as numpy
    arrays: ``embed``, ``final_norm``, optional ``lm_head`` and one
    ``stack_<i>`` per layer group, each array with a leading layers axis.
    Raises where the key set does not match ``cfg``."""
    tf._check_supported(cfg)
    dev = resolve_device(device)
    stacks = cfg.stacks()
    _keys("top-level", values,
          {"embed", "final_norm"} | {f"stack_{i}" for i in range(len(stacks))}
          | (set() if cfg.tie_embeddings else {"lm_head"}))
    layer_keys = {"attn_norm", "attn", "ffn_norm", "ffn"} | (
        {"attn_post", "ffn_post"} if cfg.post_norms else set())
    layers = []
    for si, (dense, _, count) in enumerate(stacks):
        st = values[f"stack_{si}"]
        _keys(f"stack_{si}", st, layer_keys)
        _keys(f"stack_{si}.attn", st["attn"], {"wq", "wk", "wv", "wo"})
        _keys(f"stack_{si}.ffn", st["ffn"], {"w_in", "w_out"} | (
            {"w_gate"} if cfg.gated_ffn else set()))
        for i in range(count):
            a, f = st["attn"], st["ffn"]
            layers.append(tf.Layer(
                _tensor(st["attn_norm"][i], dev),
                attn.GQA(*(_tensor(a[n][i], dev)
                           for n in ("wq", "wk", "wv", "wo"))),
                _tensor(st["ffn_norm"][i], dev),
                moe.DenseFFN(_tensor(f["w_in"][i], dev),
                             _tensor(f["w_out"][i], dev),
                             _tensor(f["w_gate"][i], dev)
                             if cfg.gated_ffn else None),
                *((_tensor(st["attn_post"][i], dev),
                   _tensor(st["ffn_post"][i], dev)) if cfg.post_norms
                  else ())))
    return tf.LM(_tensor(values["embed"], dev),
                 _tensor(values["final_norm"], dev), layers,
                 None if cfg.tie_embeddings
                 else _tensor(values["lm_head"], dev))


def gat_from_numpy(values, cfg: gat.GATConfig, device=None):
    """``values`` is the reference's ``gat.init(...)[0]`` as numpy arrays:
    ``{"layer_i": {"w", "a_src", "a_dst"}}``. Raises where a key set or a
    shape does not match ``cfg``."""
    dev = resolve_device(device)
    shapes = gat.layer_shapes(cfg)
    _keys("top-level", values, shapes)
    params = {}
    for name, layer in shapes.items():
        _keys(name, values[name], layer)
        params[name] = {}
        for k, shape in layer.items():
            a = np.asarray(values[name][k], dtype=np.float32)
            if a.shape != shape:
                raise ValueError(f"{name}.{k} has shape {a.shape}, the "
                                 f"config's is {shape}")
            params[name][k] = _tensor(a, dev)
    return params


def train_state_from_numpy(values, cfg, device=None):
    """The reference's train state ``{"params", "opt": {"m", "v", "step"},
    ["err_fb"]}`` as numpy arrays → the port's (``train.loop``'s layout).
    ``cfg`` is a ``TwoTowerConfig`` (params through
    ``two_tower_from_numpy``, returned as its ``param_tree``, so the state
    trains that model) or a ``GATConfig`` (``gat_from_numpy``). Moments
    keep their dtype (float32 or bfloat16, bit for bit); ``step`` is a
    0-d int32."""
    dev = resolve_device(device)
    if isinstance(cfg, recsys.TwoTowerConfig):
        params = recsys.param_tree(
            two_tower_from_numpy(values["params"], cfg, dev))
    elif isinstance(cfg, gat.GATConfig):
        params = gat_from_numpy(values["params"], cfg, dev)
    else:
        raise TypeError(f"no train state for a {type(cfg).__name__}")

    def like_params(v):
        if sorted(name for name, _ in tree.flatten(v)) != sorted(
                name for name, _ in tree.flatten(params)):
            raise ValueError("a moment tree does not match the parameters")
        return tree.tree_map(lambda _, a: _tensor(a, dev), params, v)

    for p in tree.leaves(params):
        p.requires_grad_(True)
    opt = values["opt"]
    state = {"params": params,
             "opt": {"m": like_params(opt["m"]), "v": like_params(opt["v"]),
                     "step": torch.tensor(int(np.asarray(opt["step"])),
                                          dtype=torch.int32, device=dev)}}
    if "err_fb" in values:
        state["err_fb"] = like_params(values["err_fb"])
    return state
