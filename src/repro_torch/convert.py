"""Carry a store or parameters built elsewhere (e.g. by the JAX package)
into the port.

The arguments are numpy arrays: the ``TripleStore`` / ``RelaxTable``
fields (the sketch as uint32 words), a two-tower, LM or GNN (GAT, EGNN,
NequIP, MACE) parameter tree, or a train state of any of them. The
results are the port's types on ``device``, so both packages then read the
very same data.
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
from repro_torch.models.gnn import egnn, gat, mace, nequip
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
    arrays: ``embed``, ``final_norm``, optional ``lm_head``, one
    ``stack_<i>`` per layer group, each array with a leading layers axis,
    and with ``mtp_depth`` ``mtp: {proj, layer}`` (one layer, unstacked).
    A dense stack's ``ffn`` holds ``{w_in, w_out, [w_gate]}``, an MoE
    stack's ``{router, w_gate, w_in, w_out, [shared]}``; a GQA layer's
    ``attn`` ``{wq, wk, wv, wo}``, an MLA layer's ``{w_dq, q_norm, w_uq,
    w_dkv, kv_norm, w_uk, w_uv, wo}``. Raises where a key set does not
    match ``cfg``."""
    dev = resolve_device(device)
    stacks = cfg.stacks()
    _keys("top-level", values,
          {"embed", "final_norm"} | {f"stack_{i}" for i in range(len(stacks))}
          | (set() if cfg.tie_embeddings else {"lm_head"})
          | ({"mtp"} if cfg.mtp_depth else set()))
    layer_keys = {"attn_norm", "attn", "ffn_norm", "ffn"} | (
        {"attn_post", "ffn_post"} if cfg.post_norms else set())
    attn_keys = (set(attn.MLA.NAMES) if cfg.mla
                 else {"wq", "wk", "wv", "wo"})
    dense_keys = {"w_in", "w_out"} | ({"w_gate"} if cfg.gated_ffn
                                       else set())
    moe_keys = {"router", "w_gate", "w_in", "w_out"} | (
        {"shared"} if cfg.moe and cfg.moe.n_shared else set())

    def check_layer(name, lv, dense):
        _keys(name, lv, layer_keys)
        _keys(f"{name}.attn", lv["attn"], attn_keys)
        _keys(f"{name}.ffn", lv["ffn"], dense_keys if dense else moe_keys)
        if not dense and "shared" in moe_keys:
            _keys(f"{name}.ffn.shared", lv["ffn"]["shared"], dense_keys)

    for si, (dense, _, _) in enumerate(stacks):
        check_layer(f"stack_{si}", values[f"stack_{si}"], dense)
    if cfg.mtp_depth:
        _keys("mtp", values["mtp"], {"proj", "layer"})
        check_layer("mtp.layer", values["mtp"]["layer"], cfg.moe is None)

    def dense_ffn(f):
        return moe.DenseFFN(_tensor(f["w_in"], dev), _tensor(f["w_out"], dev),
                            _tensor(f["w_gate"], dev) if cfg.gated_ffn
                            else None)

    def layer(lv, dense):
        a, f = lv["attn"], lv["ffn"]
        ffn = dense_ffn(f) if dense else moe.MoEFFN(
            *(_tensor(f[n], dev) for n in ("router", "w_gate", "w_in",
                                           "w_out")),
            dense_ffn(f["shared"]) if "shared" in f else None,
            cfg.moe.shard_experts)
        block = (attn.MLA(*(_tensor(a[n], dev) for n in attn.MLA.NAMES))
                 if cfg.mla else
                 attn.GQA(*(_tensor(a[n], dev) for n in ("wq", "wk", "wv",
                                                         "wo"))))
        return tf.Layer(
            _tensor(lv["attn_norm"], dev), block,
            _tensor(lv["ffn_norm"], dev), ffn,
            *((_tensor(lv["attn_post"], dev), _tensor(lv["ffn_post"], dev))
              if cfg.post_norms else ()))

    layers = [layer(lv, dense) for lv, dense in zip(
        _lm_layer_tree(values, cfg)["layers"], cfg.dense_layers())]
    mtp = (tf.MTP(_tensor(values["mtp"]["proj"], dev),
                  layer(values["mtp"]["layer"], cfg.moe is None))
           if cfg.mtp_depth else None)
    return tf.LM(_tensor(values["embed"], dev),
                 _tensor(values["final_norm"], dev), layers,
                 None if cfg.tie_embeddings
                 else _tensor(values["lm_head"], dev), mtp)


def _lm_layer_tree(values, cfg: tf.LMConfig) -> dict:
    """The reference's LM tree of arrays, each ``stack_<i>`` leaf with a
    leading layers axis → ``transformer.param_tree``'s layout, one entry a
    layer (views, bit for bit); ``mtp`` as it is."""
    def layer(node, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i]
                for k, v in node.items()}

    stacks = [f"stack_{si}" for si in range(len(cfg.stacks()))]
    if not set(stacks) <= set(values):
        raise ValueError(f"an LM tree needs {stacks}, got {sorted(values)}")
    out = {k: values[k] for k in ("embed", "final_norm", "lm_head", "mtp")
           if k in values}
    out["layers"] = [layer(values[f"stack_{si}"], i)
                     for si, (_, _, count) in enumerate(cfg.stacks())
                     for i in range(count)]
    return out


def _tree_from_numpy(name, values, specs, dev) -> dict:
    """A nested dict of arrays → float32 tensors on ``dev``, checked key
    set by key set and shape by shape against ``specs`` (a nested dict of
    ``(shape, scale)`` leaves, or of shapes)."""
    _keys(name, values, specs)
    out = {}
    for k, spec in specs.items():
        path = f"{name}.{k}" if name != "top-level" else k
        if isinstance(spec, dict):
            out[k] = _tree_from_numpy(path, values[k], spec, dev)
            continue
        shape = spec[0] if isinstance(spec[0], tuple) else spec
        a = np.asarray(values[k], dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"{path} has shape {a.shape}, the config's is "
                             f"{tuple(shape)}")
        out[k] = _tensor(a, dev)
    return out


def gat_from_numpy(values, cfg: gat.GATConfig, device=None):
    """``values`` is the reference's ``gat.init(...)[0]`` as numpy arrays:
    ``{"layer_i": {"w", "a_src", "a_dst"}}``. Raises where a key set or a
    shape does not match ``cfg``."""
    return _tree_from_numpy("top-level", values, gat.layer_shapes(cfg),
                            resolve_device(device))


def egnn_from_numpy(values, cfg: egnn.EGNNConfig, device=None):
    """``values`` is the reference's ``egnn.init(...)[0]`` as numpy arrays:
    ``embed``, ``layer_i.{edge_mlp, coord_mlp, node_mlp}`` and ``head``,
    each ``{"w<k>"}``. Raises where a key set or a shape does not match
    ``cfg``."""
    return _tree_from_numpy("top-level", values, egnn.param_specs(cfg),
                            resolve_device(device))


def nequip_from_numpy(values, cfg: nequip.NequIPConfig, device=None):
    """``values`` is the reference's ``nequip.init(...)[0]`` as numpy
    arrays: ``embed``, ``layer_i.{rad_w0, rad_w1, self_<l>, gate_w}``,
    ``head0`` and ``head1``. Raises where a key set or a shape does not
    match ``cfg``."""
    return _tree_from_numpy("top-level", values, nequip.param_specs(cfg),
                            resolve_device(device))


def mace_from_numpy(values, cfg: mace.MACEConfig, device=None):
    """``values`` is the reference's ``mace.init(...)[0]`` as numpy arrays:
    ``embed``, ``layer_i.{rad_w0, rad_w1, b2_w, b3_w, msg_<l>, res_<l>}``,
    ``head0`` and ``head1``. Raises where a key set or a shape does not
    match ``cfg``."""
    return _tree_from_numpy("top-level", values, mace.param_specs(cfg),
                            resolve_device(device))


_GNN_FROM_NUMPY = {gat.GATConfig: gat_from_numpy,
                   egnn.EGNNConfig: egnn_from_numpy,
                   nequip.NequIPConfig: nequip_from_numpy,
                   mace.MACEConfig: mace_from_numpy}


def train_state_from_numpy(values, cfg, device=None):
    """The reference's train state ``{"params", "opt": {"m", "v", "step"},
    ["err_fb"]}`` as numpy arrays → the port's (``train.loop``'s layout).
    ``cfg`` is a ``TwoTowerConfig`` (params through
    ``two_tower_from_numpy``, returned as its ``param_tree``, so the state
    trains that model), an ``LMConfig`` (``lm_from_numpy``, returned as
    ``transformer.param_tree``: the reference's stacked layers and their
    moments sliced into one entry a layer) or the config of a GNN
    (``gat_from_numpy``, ``egnn_from_numpy``, ``nequip_from_numpy``,
    ``mace_from_numpy``). Moments keep their dtype (float32 or bfloat16,
    bit for bit); ``step`` is a 0-d int32."""
    dev = resolve_device(device)
    layout = None
    if isinstance(cfg, recsys.TwoTowerConfig):
        params = recsys.param_tree(
            two_tower_from_numpy(values["params"], cfg, dev))
    elif isinstance(cfg, tf.LMConfig):
        params = tf.param_tree(lm_from_numpy(values["params"], cfg, dev))
        layout = _lm_layer_tree
    elif type(cfg) in _GNN_FROM_NUMPY:
        params = _GNN_FROM_NUMPY[type(cfg)](values["params"], cfg, dev)
    else:
        raise TypeError(f"no train state for a {type(cfg).__name__}")

    def like_params(v):
        if layout is not None:
            v = layout(v, cfg)
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
