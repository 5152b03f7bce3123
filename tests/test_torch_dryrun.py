"""The port's dry run (``repro_torch.configs.base``, ``configs.lm_common``'s,
``configs.gnn_common``'s, ``configs.kg_specqp``'s and
``configs.two_tower_retrieval``'s ``make_cell``, ``launch.analysis``,
``launch.dryrun``) against the JAX package's: every cell argument by
argument (the dense archs', granite's and deepseek's; gat-cora's, EGNN's,
NequIP's and MACE's on the four graph shapes; kg-specqp's two and the
two-tower model's four), their bytes a card on the 16 × 16 mesh, the GNNs'
and the two-tower model's parameter axes, the model flops and active
parameters of every LM, the roofline's arithmetic, a fake (2, 2) run's
flops per rank, ``--all``'s control flow (every cell laid out, none left
"not ported") and the skipped cells' reasons."""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import compat
from repro.configs import base as jbase
from repro import sharding as jsharding
from repro.configs import get_arch as jget_arch
from repro.launch import analysis as janalysis
from repro_torch import sharding
from repro_torch.configs import get_arch, gnn_common, kg_specqp, lm_common
from repro_torch.configs import two_tower_retrieval
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import mesh as mesh_lib

DENSE = ("gemma2-2b", "starcoder2-3b", "gemma3-27b")
MOE = ("granite-moe-3b-a800m", "deepseek-v3-671b")
LMS = DENSE + MOE
GNNS = ("gat-cora", "egnn", "nequip", "mace")
KG, TWO_TOWER = "kg-specqp", "two-tower-retrieval"
SHAPES = tuple(lm_common.LM_SHAPES)
GNN_SHAPES = tuple(gnn_common.GNN_SHAPES)
# Every cell the dry run lays out: the dense archs' four shapes, the MoE
# archs' three (their long_500k is in their SKIP_SHAPES), each GNN's four
# graph shapes, kg-specqp's two and the two-tower model's four.
CELLS = ([(a, s) for a in DENSE for s in SHAPES]
         + [(a, s) for a in MOE for s in SHAPES if s != "long_500k"]
         + [(a, s) for a in GNNS for s in GNN_SHAPES]
         + [(KG, s) for s in kg_specqp.SHAPES]
         + [(TWO_TOWER, s) for s in two_tower_retrieval.SHAPES])
PROD_MESH = ((16, 16), ("data", "model"))


def _unstack_params(tree, cfg):
    """JAX's parameter (or moment) tree → the port's layout: each
    ``stack_<i>`` leaf, (L, ...) with axes ("layers", ...), as L leaves
    without the leading axis. Leaves are (shape, dtype, axes)."""
    out = {k: v for k, v in tree.items() if not k.startswith("stack_")}
    layers = []
    for si, (_, _, n) in enumerate(cfg.stacks()):
        for i in range(n):
            layers.append(jax.tree_util.tree_map(
                lambda l: (l[0][1:], l[1], l[2][1:]), tree[f"stack_{si}"],
                is_leaf=lambda x: isinstance(x, tuple)))
    out["layers"] = layers
    return out


def _jax_leaves(spec_tree, axes_tree):
    return jax.tree_util.tree_map(
        lambda s, a: (tuple(s.shape), str(s.dtype), a), spec_tree, axes_tree,
        is_leaf=lambda x: isinstance(x, tuple) or x is None)


def _port_leaves(arg, axes):
    return sharding.tree_map_axes(
        lambda a, t: (tuple(t.shape), str(t.dtype).split(".")[-1], a),
        axes, arg)


def _decode_caches(jtree, cfg):
    """JAX's per-run stacked caches → one (shape, dtype, axes) a layer."""
    layers = []
    for run in jtree:
        n = next(iter(run.values()))[0][0]
        for _ in range(n):
            layers.append({k: (s[1:], d, a[1:]) for k, (s, d, a)
                           in run.items()})
    return layers


def _jax_graph_leaves(spec, axes):
    """JAX's ``Graph`` of ShapeDtypeStructs and its axes → the port's dict
    of (shape, dtype, axes) by field, None for an absent field."""
    return {f.name: None if getattr(spec, f.name) is None else
            _jax_leaves(getattr(spec, f.name), getattr(axes, f.name))
            for f in dataclasses.fields(spec)}


def _port_graph_leaves(graph, axes):
    return {k: None if t is None else _port_leaves(t, axes[k])
            for k, t in graph.items()}


def _jax_cell(arch, shape):
    """JAX's cell; kg-specqp's needs a mesh installed (its store has one
    shard a device): the 16 × 16 production mesh's abstract twin."""
    if arch != KG:
        return jget_arch(arch).make_cell(shape)
    with jsharding.use_rules(compat.abstract_mesh(*PROD_MESH)):
        return jget_arch(arch).make_cell(shape)


def _port_cell(arch, shape):
    """The port's cell, kg-specqp's on the fake 16 × 16 production mesh
    (the rules installed while it is built)."""
    if arch != KG:
        return get_arch(arch).make_cell(shape)
    with dryrun.fake_world(256):
        with sharding.use_rules(mesh_lib.make_production_mesh()):
            return get_arch(arch).make_cell(shape)


def _jax_fields(obj, axes):
    """A JAX dataclass of specs (TripleStore, RelaxTable) and its axes →
    the port's dict of (shape, dtype, axes) by field; the sketch's uint32
    words are the port's int32 view of them."""
    out = {}
    for f in dataclasses.fields(obj):
        shape, dtype, ax = _jax_leaves(getattr(obj, f.name),
                                       getattr(axes, f.name))
        out[f.name] = (shape, "int32" if dtype == "uint32" else dtype, ax)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_make_cell_matches_jax(arch, shape):
    """Every argument's shape, dtype and axes, leaf for leaf, after the
    port's layout changes: the stacked layers as a list, the decode caches
    one a layer, the decode step a Python int, the graph and kg-specqp's
    store and relaxations dicts of their fields."""
    jcell = _jax_cell(arch, shape)
    cell = _port_cell(arch, shape)
    cfg = get_arch(arch).config()
    assert (cell.arch, cell.shape, cell.kind) == (jcell.arch, jcell.shape,
                                                  jcell.kind)
    if arch == KG:
        want = [_jax_fields(jcell.args[i], jcell.arg_axes[i])
                for i in (0, 1)] + [
            _jax_leaves(jcell.args[i], jcell.arg_axes[i]) for i in (2, 3)]
        assert [_port_leaves(t, a) for t, a in zip(cell.args,
                                                   cell.arg_axes)] == want
        assert cell.static_kwargs == {"trips": kg_specqp.CELL_TRIPS}
        return
    if arch == TWO_TOWER:
        assert [_port_leaves(t, a) for t, a in zip(cell.args,
                                                   cell.arg_axes)] == \
            [_jax_leaves(s, a) for s, a in zip(jcell.args, jcell.arg_axes)]
        return
    if arch in GNNS:
        assert _port_leaves(cell.args[0], cell.arg_axes[0]) == \
            _jax_leaves(jcell.args[0], jcell.arg_axes[0])
        assert _port_graph_leaves(cell.args[1], cell.arg_axes[1]) == \
            _jax_graph_leaves(jcell.args[1], jcell.arg_axes[1])
        return
    want = [_jax_leaves(s, a) for s, a in zip(jcell.args, jcell.arg_axes)]
    got = [_port_leaves(t, a) for t, a in zip(cell.args, cell.arg_axes)
           if not isinstance(t, int)]
    if cell.kind == "train":
        ws = want[0]
        want[0] = {"params": _unstack_params(ws["params"], cfg),
                   "opt": {"m": _unstack_params(ws["opt"]["m"], cfg),
                           "v": _unstack_params(ws["opt"]["v"], cfg),
                           "step": ws["opt"]["step"]}}
    else:
        want[0] = _unstack_params(want[0], cfg)
    if cell.kind == "decode":
        assert cell.args[4] == lm_common.DECODE_STEP
        assert want.pop() == ((), "int32", ())        # JAX's traced step
        want[3] = _decode_caches(want[3], cfg)
    assert got == want


def _jax_card_bytes(jcell, mesh):
    """Σ over JAX's argument leaves of the bytes of one shard under its
    ``sharding.spec``."""
    size = dict(mesh.shape)
    total = 0
    with jsharding.use_rules(mesh):
        for args, axes in zip(jcell.args, jcell.arg_axes):
            ax_leaves = jax.tree_util.tree_leaves(
                axes, is_leaf=lambda x: isinstance(x, tuple) or x is None)
            for a, s in zip(ax_leaves, jax.tree_util.tree_leaves(
                    args, is_leaf=lambda x: x is None), strict=True):
                if s is None:              # a graph's absent field
                    continue
                shape = list(s.shape)
                if isinstance(a, tuple) and len(a) == len(shape):
                    spec = jsharding.spec(*a, shape=tuple(shape))
                    for d, part in enumerate(spec):
                        for ax in (part if isinstance(part, tuple)
                                   else (part,)):
                            if ax is not None:
                                shape[d] //= size[ax]
                total += math.prod(shape) * jnp.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_card_argument_bytes_match_jax(arch, shape):
    jcell = _jax_cell(arch, shape)
    want = _jax_card_bytes(jcell, compat.abstract_mesh(*PROD_MESH))
    if jcell.kind == "decode":
        want -= 4                  # JAX's step is an array, the port's an int
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        with sharding.use_rules(mesh):
            assert get_arch(arch).make_cell(shape).argument_bytes() == want


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", GNNS)
def test_gnn_param_axes_match_jax_init(arch, width):
    """Each GNN's ``param_axes`` is its reference ``init``'s axes tree, and
    ``init``'s shapes and dtypes match leaf for leaf, at the smoke and the
    published widths."""
    mod, jmod = get_arch(arch), jget_arch(arch)
    cfg = mod.smoke_config() if width == "smoke" else mod.config()
    jcfg = jmod.smoke_config() if width == "smoke" else jmod.config()
    shapes, axes = jbase.eval_shape_with_axes(
        lambda k: jmod.model.init(k, jcfg), jax.random.PRNGKey(0))
    got = mod.model.param_axes(cfg)
    assert got == jax.tree_util.tree_map(
        lambda a: a, axes, is_leaf=lambda x: isinstance(x, tuple))
    params = mod.model.init(cfg, torch.Generator(), "meta")
    assert _port_leaves(params, got) == _jax_leaves(shapes, axes)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", LMS)
def test_model_flops_and_active_params_match_jax(arch, shape):
    cfg, jcfg = get_arch(arch).config(), jget_arch(arch).config()
    sh = lm_common.LM_SHAPES[shape]
    assert analysis.lm_active_params(cfg) == \
        janalysis.lm_active_params(jcfg)
    assert analysis.lm_model_flops(cfg, sh["batch"], sh["seq"],
                                   sh["kind"]) == \
        janalysis.lm_model_flops(jcfg, sh["batch"], sh["seq"], sh["kind"])


def test_roofline_arithmetic():
    hw = analysis.HW
    coll = analysis.collective_bytes([
        ("all-gather", 100, 400, True), ("all-reduce", 50, 50, True),
        ("reduce-scatter", 80, 20, False), ("all-to-all", 60, 60, True)])
    assert coll["wire"] == {"all-gather": 300, "all-reduce": 100,
                            "reduce-scatter": 80, "all-to-all": 60,
                            "collective-permute": 0}
    assert coll["wire_total"] == 540 and coll["wire_nvlink"] == 80
    assert coll["total"] == 290
    assert coll["counts"]["all-gather"] == 1
    rl = analysis.Roofline(flops=989.4e12, bytes_accessed=6.7e12,
                           coll_bytes=540e9, n_chips=4,
                           model_flops=2 * 989.4e12,
                           nvlink_bytes=80e9)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.collective_s == pytest.approx(80e9 / hw["nvlink_bw"]
                                            + 460e9 / hw["ib_bw"])
    assert rl.dominant == "collective" and rl.bound_s == rl.collective_s
    assert rl.useful_flops_ratio == pytest.approx(0.5)
    assert set(rl.row()) == {"flops", "bytes", "coll_bytes", "chips",
                             "compute_s", "memory_s", "collective_s",
                             "dominant", "model_flops", "useful_ratio"}


def test_fake_run_flops_per_rank(monkeypatch):
    """gemma2-2b's smoke prefill (B 4, S 32) on a fake (2, 2) mesh: each
    rank's products and attention are a quarter of the cell's (batch over
    data; heads, the MLP and the last token's vocab over model)."""
    monkeypatch.setattr(lm_common, "LM_SHAPES", {
        "prefill_32k": dict(seq=32, batch=4, kind="prefill")})
    cfg = get_arch("gemma2-2b").smoke_config()
    B, S, D, F, V = 4, 32, cfg.d_model, cfg.d_ff, cfg.vocab
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    layer = (2 * B * S * D * (H + 2 * Hkv) * Dh + 2 * B * S * H * Dh * D
             + 3 * 2 * B * S * D * F)
    pairs = {16: 16 * 17 // 2 + 16 * 16, 0: S * (S + 1) // 2}
    attn = sum(4 * Dh * B * H * pairs[w] for w in cfg.windows())
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_device_mesh((2, 2))
        with sharding.use_rules(mesh):
            m = dryrun.measure(lm_common.make_cell("gemma2-2b", cfg,
                                                   "prefill_32k"), mesh)
    by_op = m["cost"]["flops_by_op"]
    assert by_op["repro_torch.flash_attention"] == attn // 4
    assert by_op.get("aten.mm", 0) + by_op.get("aten.bmm", 0) == \
        (cfg.n_layers * layer + 2 * B * D * V) // 4
    assert m["cost"]["flops"] == sum(by_op.values())
    assert m["memory"]["peak_bytes"] >= m["memory"]["argument_bytes"] > 0


def test_ops_that_read_no_data_count_no_bytes():
    """``LocalCost`` counts each op's operands and outputs once, and nothing
    for an op that moves no data: ``prim.device`` (it reads a tensor's
    metadata; counted, it was most of every cell's bytes) and a
    functional collective's wait."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    x = mode.from_tensor(torch.empty((256, 1024)))
    cost = dryrun.LocalCost()
    with mode:
        cost.__enter__()
        try:
            torch.ops.prim.device.default(x)
            torch.ops._c10d_functional.wait_tensor.default(x)
            x + 1
        finally:
            cost.__exit__(None, None, None)
    assert cost.bytes == 2 * x.numel() * 4        # x read, x + 1 written


def _small_cells(monkeypatch):
    """Every LM shape cut to a few tokens, every graph shape to a few
    nodes and edges, and the models to their smoke configs, so ``--all``
    runs its whole control flow in seconds."""
    monkeypatch.setattr(lm_common, "LM_SHAPES", {
        name: dict(sh, seq=32, batch=16) for name, sh in
        lm_common.LM_SHAPES.items()})
    monkeypatch.setattr(gnn_common, "GNN_SHAPES", {
        name: dict(sh, n_nodes=sh.get("n_graphs", 2) * 16,
                   n_edges=sh.get("n_graphs", 2) * 48, d_feat=8)
        for name, sh in gnn_common.GNN_SHAPES.items()})
    for arch in LMS + GNNS + (TWO_TOWER,):
        mod = get_arch(arch)
        small = mod.smoke_config()
        monkeypatch.setattr(mod, "config", lambda small=small: small)
    for name, value in (("N_PATTERNS", 64), ("L_SHARD", 256),
                        ("N_QUERIES", 8)):
        monkeypatch.setattr(kg_specqp, name, value)
    for name, value in (("CELL_BATCH", {"train_batch": 64, "serve_p99": 32,
                                        "serve_bulk": 128}),
                        ("CORPUS", 8192), ("N_CAND_PAD", 65536),
                        ("TILE", 256)):
        monkeypatch.setattr(two_tower_retrieval, name, value)


def test_two_tower_param_axes_match_jax_init():
    """``recsys.param_axes`` is the reference ``init``'s axes tree, and
    ``init``'s shapes and dtypes match leaf for leaf (published widths)."""
    mod, jmod = get_arch(TWO_TOWER), jget_arch(TWO_TOWER)
    shapes, axes = jbase.eval_shape_with_axes(
        lambda k: jmod.model.init(k, jmod.config()), jax.random.PRNGKey(0))
    got = mod.model.param_axes(mod.config())
    assert got == axes
    params = mod.model.param_tree(mod.model.init(mod.config(),
                                                 device="meta"))
    assert _port_leaves(params, got) == _jax_leaves(shapes, axes)


def test_all_writes_ok_and_skipped(monkeypatch, tmp_path, capsys):
    _small_cells(monkeypatch)
    assert dryrun.main(["--all", "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    status = {}
    for f in tmp_path.glob("*.json"):
        r = json.loads(f.read_text())
        status[(r["arch"], r["shape"])] = r["status"]
        assert r["mesh"] == "16x16"
        if r["status"] == "ok":
            assert set(r) >= {"memory", "cost", "collectives",
                              "collective_counts", "roofline"}
            # The reference gives a cell that is not an LM's no model
            # flops.
            assert (r["roofline"]["model_flops"] > 0) == (r["arch"] in LMS)
    assert {k for k, v in status.items() if v == "ok"} == set(CELLS)
    assert len(CELLS) == 40
    assert {k for k, v in status.items() if v == "skipped"} == {
        (a, "long_500k") for a in MOE}
    assert not any("not ported" in line for line in lines)
    assert len(status) == sum(len(get_arch(a).SHAPES) for a in
                              dryrun.all_archs())
    assert len(lines) == len(status)


@pytest.mark.parametrize("arch", MOE)
def test_long_500k_skipped_with_the_references_reason(arch, tmp_path):
    """The reference writes a SKIP_SHAPES cell as skipped with its arch's
    reason, before anything else; so does the port, word for word."""
    reason = jget_arch(arch).SKIP_SHAPES["long_500k"]
    assert get_arch(arch).SKIP_SHAPES == jget_arch(arch).SKIP_SHAPES
    assert dryrun.main(["--arch", arch, "--shape", "long_500k", "--out",
                        str(tmp_path)]) == 0
    r = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert (r["status"], r["reason"], r["mesh"]) == ("skipped", reason,
                                                     "16x16")
    assert set(r) == {"arch", "shape", "mesh", "status", "reason"}


def test_an_error_makes_the_run_fail(monkeypatch, tmp_path):
    _small_cells(monkeypatch)

    def broken(shape):
        raise RuntimeError("boom")

    monkeypatch.setattr(get_arch("starcoder2-3b"), "make_cell", broken)
    assert dryrun.main(["--arch", "starcoder2-3b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 1
    r = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert r["status"] == "error" and "boom" in r["error"]
