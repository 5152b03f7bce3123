"""The port's logical-axis sharding (``repro_torch.sharding``) against the
JAX package's: the rules' specs on a grid of meshes and sizes, the
reference's own sharding cases, the dense LMs' parameter axes against
``init``'s, and the smoke LMs run for real on a (2, 2) mesh of 4 gloo
ranks (the constrain calls, the attention's custom op and its sharding
rule), equal to the unsharded port and counted collective by collective
like the dry run's fake run of the same cell."""
import copy
import dataclasses
import math
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import sharding as jsharding
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro_torch import sharding
from repro_torch.configs import deepseek_v3_671b, gemma2_2b, gemma3_27b
from repro_torch.configs import granite_moe_3b_a800m, lm_common
from repro_torch.configs import starcoder2_3b
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
DIMS = (1, 2, 3, 4, 7, 8, 16, 24, 32, 256)
NAMES = sorted(jsharding.DEFAULT_RULES) + [None]
ARCHS = {"gemma2-2b": gemma2_2b, "starcoder2-3b": starcoder2_3b,
         "gemma3-27b": gemma3_27b}
# Every LM, for the parameter axes: the MoE stacks, deepseek's dense
# prefix, MLA and the MTP layer beside the dense ones.
ALL_ARCHS = dict(ARCHS, **{"granite-moe-3b-a800m": granite_moe_3b_a800m,
                           "deepseek-v3-671b": deepseek_v3_671b})
# The sharded run: batch 4 over data, 32 tokens; smoke configs have 4
# heads and 2 kv heads, so both mesh axes split something.
GLOO_BATCH, GLOO_SEQ = 4, 32


def _fake_world(size):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


@pytest.fixture(scope="module")
def meshes():
    """A DeviceMesh of each shape over one fake 512-rank process group,
    beside JAX's abstract mesh of the same shape."""
    from torch.distributed.device_mesh import DeviceMesh
    _fake_world(512)
    try:
        out = {shape: (DeviceMesh("cuda", torch.arange(math.prod(shape))
                                  .view(shape), mesh_dim_names=axes),
                       compat.abstract_mesh(shape, axes))
               for shape, axes in MESHES.items()}
        out[(1,)] = (DeviceMesh("cuda", torch.arange(1),
                                mesh_dim_names=("model",)), None)
        yield out
    finally:
        dist.destroy_process_group()


def _jax_spec(names, shape, mesh):
    with jsharding.use_rules(mesh):
        return jsharding.spec(*names, shape=shape)


def _port_spec(names, shape, mesh):
    """The port's spec as a ``PartitionSpec`` (which reads a one-axis
    tuple as that axis)."""
    with sharding.use_rules(mesh):
        return P(*sharding.spec(*names, shape=shape))


@pytest.mark.parametrize("name", NAMES, ids=str)
@pytest.mark.parametrize("mesh_shape", list(MESHES), ids=str)
def test_spec_matches_jax(meshes, mesh_shape, name):
    """One name at every size, and after every other name (the dedupe
    rule: a mesh axis is used once), with and without shapes."""
    mesh, jmesh = meshes[mesh_shape]
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    for d in DIMS:
        assert _port_spec((name,), (d,), mesh) == \
            _jax_spec((name,), (d,), jmesh)
        for first in NAMES:
            names, shape = (first, name), (256, d)
            assert _port_spec(names, shape, mesh) == \
                _jax_spec(names, shape, jmesh), names
    assert _port_spec((name,), None, mesh) == _jax_spec((name,), None, jmesh)


def test_placements_follow_the_spec(meshes):
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = meshes[(2, 16, 16)]
    with sharding.use_rules(mesh):
        assert sharding.sharding("batch", "vocab", shape=(512, 32)) == \
            [Shard(0), Shard(0), Shard(1)]
        assert sharding.sharding("heads", shape=(8,)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("model", "data"),), mesh)


# ----------------------------------------- tests/test_sharding.py, ported

def test_noop_without_mesh():
    sharding.clear()
    x = torch.ones((4, 4))
    assert sharding.constrain(x, "batch", None) is x
    assert sharding.spec("batch") == ()


def test_divisibility_drops_axes(meshes):
    with sharding.use_rules(meshes[(1, 1)][0]):
        s = sharding.spec("heads", shape=(8,))
        assert s == (None,) or s == ("model",)


def test_spec_dedupes_axes(meshes):
    with sharding.use_rules(meshes[(1, 1)][0]):
        s = sharding.spec("batch", "fsdp", shape=(4, 4))
        used = [a for part in s for a in (part if isinstance(part, tuple)
                                          else [part]) if a]
        assert len(used) == len(set(used))


def test_divisibility_16way(meshes):
    with sharding.use_rules(meshes[(1,)][0], dict(sharding.DEFAULT_RULES)):
        assert sharding.spec("heads", shape=(7,)) == ("model",)


def test_tuple_rule_prefix(meshes):
    rules = dict(sharding.DEFAULT_RULES)
    rules["x2"] = ("data", "model")
    with sharding.use_rules(meshes[(2, 2)][0], rules):
        assert sharding.spec("x2", shape=(2,)) == (("data",),)
        assert sharding.spec("x2", shape=(4,)) == (("data", "model"),)
        assert sharding.spec("x2", shape=(3,)) == (None,)


# ------------------------------------------------------- parameter axes

def _jax_layer_axes(axes):
    """JAX's stacked axes → one layer's (the leading axis dropped)."""
    if isinstance(axes, dict):
        return {k: _jax_layer_axes(v) for k, v in axes.items()}
    assert axes[0] == "layers", axes
    return tuple(axes[1:])


def _jax_tree(jp, cfg):
    """JAX's (shapes or axes) tree in the port's ``param_tree`` layout."""
    out = {k: v for k, v in jp.items() if not k.startswith("stack_")}
    out["layers"] = [jp[f"stack_{si}"]
                     for si, (_, _, n) in enumerate(cfg.stacks())
                     for _ in range(n)]
    return out


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_param_axes_match_jax_init(arch, width):
    """Every leaf's axes, shape and dtype: each stack's layers (a dense
    prefix and an MoE stack for deepseek), the MTP layer (not stacked in
    JAX either), the embedding, norms and head."""
    mod = ALL_ARCHS[arch]
    cfg = mod.smoke_config() if width == "smoke" else mod.config()
    jmod = __import__(f"repro.configs.{mod.__name__.split('.')[-1]}",
                      fromlist=["config"])
    jcfg = jmod.smoke_config() if width == "smoke" else jmod.config()
    shapes, axes = jbase.eval_shape_with_axes(
        lambda k: jtf.init(k, jcfg), jax.random.PRNGKey(0))
    model = tf.init(cfg, torch.Generator(), "meta")
    got = tf.param_axes(model)
    want = _jax_tree(axes, cfg)
    want["layers"] = [_jax_layer_axes(a) for a in want["layers"]]
    assert set(got) == set(want)
    assert got == want
    assert len(cfg.stacks()) == (2 if cfg.first_dense_layers else 1)
    assert ("mtp" in got) == bool(cfg.mtp_depth)
    # Shapes and dtypes too, leaf for leaf: the stacked leaves without
    # their layers axis, the rest as they are.
    sh = _jax_tree(shapes, cfg)
    params = tf.param_tree(model)
    for k in ("embed", "final_norm", "lm_head"):
        assert (k in params) == (k in sh)
        if k in params:
            assert tuple(params[k].shape) == sh[k].shape
    parts = [(got["layers"][i], lp, sh["layers"][i], 1)
             for i, lp in enumerate(params["layers"])]
    if cfg.mtp_depth:
        parts.append((got["mtp"], params["mtp"], sh["mtp"], 0))
    for ax_tree, tree, jtree, drop in parts:
        flat = sharding.tree_map_axes(lambda ax, p, s: (p, s), ax_tree, tree,
                                      jtree)
        for p, s in _pairs(flat):
            assert tuple(p.shape) == s.shape[drop:]
            assert str(p.dtype).split(".")[-1] == str(s.dtype)


def _pairs(tree):
    """The leaves of a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _pairs(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _pairs(v)]
    return [tree]


# ------------------------------------------------- the real sharded run

def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _run(model, cfg, toks, labels):
    """Loss, gradients, prefill logits and caches, one decode step and its
    caches; the same calls sharded or not."""
    from torch.distributed.tensor import DTensor
    params = tf.param_tree(model)
    leaves = _pairs(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tf.loss_fn(params, cfg, toks, labels)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits, caches = tf.prefill(model, cfg, toks,
                                    max_seq=toks.shape[1] + 8)
        prefill_caches = [{k: _full(v).clone() for k, v in c.items()}
                          for c in caches]
        B, S = toks.shape
        nxt = _full(logits)[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((B,), S, dtype=torch.int32)
        if isinstance(toks, DTensor):
            nxt, pos = (sharding.distribute(t, ("batch",), toks.device_mesh)
                        for t in (nxt, pos))
        dec, caches = tf.decode_step(model, cfg, nxt, pos, caches, S)
    return {"loss": loss, "grads": grads, "logits": logits,
            "prefill_caches": prefill_caches, "decode": dec,
            "decode_caches": caches}


def _numpy(out):
    def conv(t):
        if isinstance(t, (list, tuple)):
            return [conv(x) for x in t]
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _full(t).detach().float().numpy()
    return conv(out)


def gloo_rank(mesh):
    """Each dense smoke LM unsharded and sharded on the (2, 2) mesh; and
    the collectives the sharded prefill asks for, counted as the dry run
    counts them."""
    from torch.distributed.tensor.experimental import implicit_replication
    dmesh = mesh_lib.make_device_mesh((2, 2), device_type="cpu")
    out = {}
    for arch, mod in ARCHS.items():
        cfg = mod.smoke_config()
        gen = torch.Generator().manual_seed(0)
        model = tf.init(cfg, gen, "cpu")
        toks = torch.randint(0, cfg.vocab, (GLOO_BATCH, GLOO_SEQ),
                             generator=gen, dtype=torch.int32)
        labels = torch.roll(toks, -1, 1)
        ref = _run(copy.deepcopy(model), cfg, toks, labels)
        with sharding.use_rules(dmesh):
            sharded = sharding.distribute(copy.deepcopy(model),
                                          tf.param_axes(model), dmesh)
            t2, l2 = (sharding.distribute(t, ("batch", "seq"), dmesh)
                      for t in (toks, labels))
            with implicit_replication():
                got = _run(sharded, cfg, t2, l2)
                # The dry run's prefill cell: max_seq is the prompt's length.
                log = dryrun.CollectiveLog(dmesh)
                with log, torch.no_grad():
                    tf.prefill(sharded, cfg, t2, max_seq=GLOO_SEQ)
        out[arch] = {"ref": _numpy(ref), "got": _numpy(got),
                     "counts": log.counts()}
    out["dots"] = _remat_dots(dmesh)
    out["gqa"] = _gqa_heads_apart(dmesh)
    return out


def _remat_dots(dmesh):
    """gemma2-2b's smoke loss and gradients under remat "dots" (the
    selective checkpoint that keeps the matmuls), sharded and not."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = dataclasses.replace(gemma2_2b.smoke_config(), remat="dots")
    gen = torch.Generator().manual_seed(1)
    model = tf.init(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (GLOO_BATCH, GLOO_SEQ),
                         generator=gen, dtype=torch.int32)

    labels = torch.roll(toks, -1, 1)

    def loss_grads(m, t, lab):
        leaves = _pairs(tf.param_tree(m))
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = tf.loss_fn(tf.param_tree(m), cfg, t, lab)
        return [loss, *torch.autograd.grad(loss, leaves)]

    ref = loss_grads(copy.deepcopy(model), toks, labels)
    with sharding.use_rules(dmesh), implicit_replication():
        sharded = sharding.distribute(copy.deepcopy(model),
                                      tf.param_axes(model), dmesh)
        got = loss_grads(sharded, *(sharding.distribute(t, ("batch", "seq"),
                                                        dmesh)
                                    for t in (toks, labels)))
    return {"ref": _numpy(ref), "got": _numpy(got)}


def _gqa_heads_apart(dmesh):
    """The attention's custom op where the q heads split over model and the
    kv heads cannot (Hq 4, Hkv 1 on a 2-wide axis): the sharding rule
    gathers q rather than pair a rank's q heads with another's kv."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((2, 4, 24, 16), generator=gen)
    k, v = (torch.randn((2, 1, 24, 16), generator=gen) for _ in range(2))
    want = ops.flash_attention(q, k, v, window=8)
    from torch.distributed.tensor import distribute_tensor
    dq = distribute_tensor(q, dmesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    dk, dv = (distribute_tensor(t, dmesh, [Replicate(), Replicate()],
                                src_data_rank=None) for t in (k, v))
    got = ops.flash_attention(dq, dk, dv, window=8)
    return {"ref": want.numpy(), "got": got.full_tensor().numpy()}


@pytest.fixture(scope="module")
def gloo():
    ranks = mesh_lib.spawn(gloo_rank, (2, 2), backend="gloo", device="cpu")
    return ranks


def _close(got, want, what):
    if isinstance(want, list):
        for g, w in zip(got, want, strict=True):
            _close(g, w, what)
        return
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], f"{what}.{k}")
        return
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


@pytest.mark.parametrize("what", ["loss", "grads", "logits",
                                  "prefill_caches", "decode",
                                  "decode_caches"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_run_equals_unsharded(gloo, arch, what):
    """On every rank: rtol 1e-5, atol 1e-6 of each leaf's largest."""
    for rank in gloo:
        _close(rank[arch]["got"][what], rank[arch]["ref"][what], what)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fake_run_asks_for_the_real_runs_collectives(gloo, meshes, arch,
                                                     monkeypatch):
    """The dry run's fake (2, 2) prefill of the same cell asks for the same
    collectives, kind by kind, as the real gloo run did (an all-to-all
    counted as such, though gloo runs it as a gather)."""
    monkeypatch.setattr(lm_common, "LM_SHAPES", {
        "prefill_32k": dict(seq=GLOO_SEQ, batch=GLOO_BATCH,
                            kind="prefill")})
    cfg = ARCHS[arch].smoke_config()
    mesh = meshes[(2, 2)][0]
    with sharding.use_rules(mesh):
        cell = lm_common.make_cell(arch, cfg, "prefill_32k")
        m = dryrun.measure(cell, mesh)
    fake = dict.fromkeys(gloo[0][arch]["counts"], 0)
    for kind, *_ in m["records"]:
        fake[kind] += 1
    assert fake == gloo[0][arch]["counts"]
    assert sum(fake.values()) > 0
    assert all(r[arch]["counts"] == gloo[0][arch]["counts"] for r in gloo)


@pytest.mark.parametrize("case", ["dots", "gqa"])
def test_remat_dots_and_split_q_heads(gloo, case):
    """remat "dots" keeps its numbers under DTensor; the attention's rule
    with q heads split and kv heads whole equals the unsharded op."""
    for rank in gloo:
        _close(rank[case]["got"], rank[case]["ref"], case)


def test_distribute_places_by_axes(gloo):
    """Every rank ended with the same loss (a replicated scalar)."""
    losses = [r["gemma2-2b"]["got"]["loss"] for r in gloo]
    assert all(np.array_equal(l, losses[0]) for l in losses)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
