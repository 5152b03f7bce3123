"""The port's scale-out against ``repro.core.distributed`` on a (2, 2) mesh.

The JAX side runs once, in a subprocess with 4 host devices (the device
count must be fixed before JAX starts); the port's side runs once, in 4
spawned gloo ranks on the CPU (``launch.mesh.spawn``). Both answer the
same queries over the same hash-partitioned store, and the tests compare:
keys, plan masks and the counters n_pulled, n_answers, n_iters and
n_wasted exactly, scores within rtol 1e-5 (the engine's bar), and the
sharded retrieval's indices and tiles scored exactly, scores within rtol
1e-6. ``shard_workload``'s arrays must be bit-equal to the reference's.
kg-specqp's dry-run cell function (``make_cell``'s, run to the end on the
stores laid over a (2, 2) ``DeviceMesh`` as DTensors, its ``Mesh`` built
from that mesh) is held to the reference's ``make_batched_sharded_fn``
the same way.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import small_workload, TEST_GRID_BINS

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 2)
AXES = ("data", "model")
MODES = ("trinit", "specqp", "specqp_pattern", "join_only")
CARDS = ("exact", "sketch")
COUNTERS = ("n_pulled", "n_answers", "n_iters", "n_wasted")
FIELDS = ("keys", "scores") + COUNTERS + ("relax_mask",)
WL = dict(seed=0, n_queries=8, n_entities=384, list_len=48, n_relax=3)
CFG = dict(block=8, k=5, grid_bins=TEST_GRID_BINS)
# A ring of 2 blocks: deep queries wrap their seen rings on every shard.
CAPPED = dict(CFG, seen_cap=16)
# Retrieval: N rows over 4 ranks of N / 4, tiles of TILE, top-K; "dup"
# copies rank 1's block into rank 2's, so equal scores meet in the merge.
N, D, TILE, K = 4096, 64, 256, 10
RETRIEVAL_CASES = ("random", "clustered", "dup")
# The merge alone: widths of top-k over buffers of many equal scores.
MERGE_KS = (100, 300)

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro import compat, sharding
from repro.configs import kg_specqp, two_tower_retrieval as tt
from repro.core import distributed
from repro.core.types import EngineConfig
from repro.data import kg_synth
sys.path.insert(0, "tests")
from test_torch_distributed import (WL, CFG, CAPPED, MODES, CARDS, FIELDS,
                                    K, TILE, RETRIEVAL_CASES, retrieval_case,
                                    pattern_lists)

wl = kg_synth.tiny_workload(**WL)
mesh = compat.make_mesh((2, 2), ("data", "model"))
skg = distributed.build_sharded_kg(pattern_lists(wl.store), wl.relax, 4)
out = {}

def keep(prefix, res):
    for f in FIELDS:
        out[f"{prefix}/{f}"] = np.asarray(getattr(res, f))

def batched(name, cfg, mode):
    fn = jax.jit(distributed.make_batched_sharded_fn(cfg, mode, mesh))
    keep(name, fn(skg.stores, skg.relax, skg.global_stats,
                  jnp.asarray(wl.queries)))

for card in CARDS:
    cfg = EngineConfig(**CFG, cardinality_mode=card)
    for mode in MODES:
        run = jax.jit(lambda q, mode=mode, cfg=cfg:
                      distributed.run_query_sharded(skg, q, cfg, mode, mesh))
        res = [run(jnp.asarray(q)) for q in wl.queries]
        for f in FIELDS:
            out[f"single/{card}/{mode}/{f}"] = np.stack(
                [np.asarray(getattr(r, f)) for r in res])
        batched(f"batched/{card}/{mode}", cfg, mode)
batched("capped/trinit", EngineConfig(**CAPPED), "trinit")
for mode in ("specqp", "trinit"):
    batched(f"serve_step/{mode}", kg_specqp.ENGINE, mode)

with sharding.use_rules(mesh):
    for case in RETRIEVAL_CASES:
        cand, queries = retrieval_case(case)
        for qi, q in enumerate(queries):
            s, i, n = tt._retrieve(jnp.asarray(q), jnp.asarray(cand), k=K,
                                   tile=TILE)
            out[f"retrieve/{case}/{qi}/scores"] = np.asarray(s)
            out[f"retrieve/{case}/{qi}/ids"] = np.asarray(i)
            out[f"retrieve/{case}/{qi}/tiles"] = np.asarray(n)
np.savez(sys.argv[1], **out)
print("JAX_OK")
"""


def pattern_lists(store):
    """Each pattern's (keys, scores) list of a built store, as the
    reference's own distributed test takes them."""
    keys, scores, lengths = (np.asarray(store.keys), np.asarray(store.scores),
                             np.asarray(store.lengths))
    return [(keys[p, :n], scores[p, :n]) for p, n in enumerate(lengths)]


def retrieval_case(case: str):
    """(corpus (N, D) f32, two queries (D,) f32) for a retrieval case."""
    rng = np.random.default_rng(7)
    mags = (np.repeat(np.geomspace(4.0, 0.1, N // TILE), TILE)[:, None]
            if case == "clustered" else 1.0)
    cand = (rng.standard_normal((N, D)) * mags / np.sqrt(D)).astype(
        np.float32)
    if case == "dup":
        cand[2 * N // 4:3 * N // 4] = cand[N // 4:2 * N // 4]
    return cand, rng.standard_normal((2, D)).astype(np.float32)


def merge_case():
    """(scores (4, 4, 400) f32, ids (4, 4, 400) int64): rank r's buffers
    are [r], with many equal scores and -inf padding, ids global."""
    x = np.random.default_rng(3).integers(0, 3, (4, 4, 400)).astype(
        np.float32)
    x[..., ::7] = -np.inf
    ids = np.broadcast_to(np.arange(4 * 400).reshape(4, 1, 400), x.shape)
    return x, np.ascontiguousarray(ids)


def _np(res):
    return {f: getattr(res, f).cpu().numpy() for f in FIELDS}


STORE_FIELDS = ("keys", "scores", "lengths", "sorted_keys", "stats",
                "sketch")
CELL_SHAPES = {"specqp": "serve_batch", "trinit": "serve_trinit"}


def kg_cells(skg, relax, queries):
    """kg-specqp's cell functions on a (2, 2) ``DeviceMesh`` over this
    rank's process group: the stacked stores, relax, global stats and
    queries laid out by the cells' axes, each cell run to its end (no trip
    bound). Returns {"cell/<mode>/<field>": array}."""
    from repro_torch import sharding
    from repro_torch.configs import kg_specqp
    from repro_torch.launch import mesh as mesh_lib

    dmesh = mesh_lib.make_device_mesh(MESH, AXES, device_type="cpu")
    data = ({f: getattr(skg.stores, f) for f in STORE_FIELDS},
            {"ids": relax.ids, "weights": relax.weights}, skg.global_stats,
            torch.as_tensor(np.asarray(queries), dtype=torch.int32))
    out = {}
    with sharding.use_rules(dmesh):
        for mode, shape in CELL_SHAPES.items():
            cell = kg_specqp.make_cell(shape)
            args = [sharding.distribute(a, ax, dmesh)
                    for a, ax in zip(data, cell.arg_axes)]
            res = cell.fn(*args)
            for f in FIELDS:
                out[f"cell/{mode}/{f}"] = res[f].numpy()
    return out


def port_rank(mesh):
    """Everything the port computes on one rank of the (2, 2) mesh."""
    from repro_torch.configs import kg_specqp, two_tower_retrieval as tt
    from repro_torch.core import distributed
    from repro_torch.core.types import EngineConfig
    from repro_torch.data import kg_synth

    torch.set_num_threads(1)
    wl = kg_synth.tiny_workload(**WL, device="cpu")
    skg = distributed.build_sharded_kg(pattern_lists(wl.store), wl.relax, 4)
    local = distributed.local_shard(skg.stores, mesh)
    out = {"coords": (mesh.coords, mesh.flat_index(),
                      [mesh.axis_index(a) for a in AXES])}

    def batched(name, fn):
        for f, v in _np(fn(local, wl.relax, skg.global_stats,
                           wl.queries)).items():
            out[f"{name}/{f}"] = v

    for card in CARDS:
        cfg = EngineConfig(**CFG, cardinality_mode=card)
        for mode in MODES:
            res = [_np(distributed.run_query_sharded(skg, q, cfg, mode,
                                                     mesh))
                   for q in wl.queries]
            for f in FIELDS:
                out[f"single/{card}/{mode}/{f}"] = np.stack(
                    [r[f] for r in res])
            batched(f"batched/{card}/{mode}",
                    distributed.make_batched_sharded_fn(cfg, mode, mesh))
    batched("capped/trinit", distributed.make_batched_sharded_fn(
        EngineConfig(**CAPPED), "trinit", mesh))
    for mode in ("specqp", "trinit"):
        batched(f"serve_step/{mode}", kg_specqp.serve_step(mesh, mode))
    out.update(kg_cells(skg, wl.relax, wl.queries))

    rows = N // 4
    lo = mesh.flat_index() * rows
    for case in RETRIEVAL_CASES:
        cand, queries = retrieval_case(case)
        block = torch.from_numpy(cand[lo:lo + rows])
        for qi, q in enumerate(queries):
            s, i, n = tt.retrieve(torch.from_numpy(q), block, K, TILE,
                                  mesh=mesh)
            out[f"retrieve/{case}/{qi}/scores"] = s.numpy()
            out[f"retrieve/{case}/{qi}/ids"] = i.numpy()
            out[f"retrieve/{case}/{qi}/tiles"] = n.numpy()

    x, ids = merge_case()
    for k in MERGE_KS:
        s, i = mesh.merge_top_k(torch.from_numpy(x[mesh.rank]),
                                torch.from_numpy(ids[mesh.rank]), k)
        out[f"merge/{k}/scores"], out[f"merge/{k}/ids"] = s.numpy(), i.numpy()

    # The collectives alone: rank r contributes r + 1 along each axis.
    x = torch.tensor([mesh.rank + 1.0, -mesh.rank])
    out["collectives"] = {
        ax: (mesh.psum(x, ax).numpy(), mesh.pmax(x, ax).numpy(),
             mesh.all_gather(x, ax).numpy()) for ax in AXES}
    return out


def failing_rank(mesh):
    if mesh.rank == 2:
        raise ValueError("rank 2 fails")
    # The others wait in a collective that rank 2 never joins.
    mesh.psum(torch.ones(1), "data")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's outputs, the port's outputs by rank), each computed once; the
    JAX subprocess runs while the port's ranks do."""
    from repro_torch.launch import mesh

    path = tmp_path_factory.mktemp("jax") / "out.npz"
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(path)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        port = mesh.spawn(port_rank, MESH, AXES, backend="gloo",
                          device="cpu")
        log, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert "JAX_OK" in log, log
    with np.load(path) as f:
        return dict(f), port


def _check(jax_out, got, prefix, score_rtol=1e-5):
    for f in FIELDS:
        want = jax_out[f"{prefix}/{f}"]
        if f == "scores":
            np.testing.assert_allclose(got[f"{prefix}/{f}"], want,
                                       rtol=score_rtol, err_msg=prefix)
        else:
            np.testing.assert_array_equal(got[f"{prefix}/{f}"], want,
                                          err_msg=f"{prefix} {f}")


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("mode", MODES)
def test_run_query_sharded_matches_jax(both, card, mode):
    jax_out, port = both
    _check(jax_out, port[0], f"single/{card}/{mode}")


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("mode", MODES)
def test_batched_sharded_fn_matches_jax(both, card, mode):
    """Every counter too: n_wasted is each query's lone-lane value (0),
    though the port runs the batch as one queue of one lane a query."""
    jax_out, port = both
    _check(jax_out, port[0], f"batched/{card}/{mode}")


@pytest.mark.parametrize("name", ["capped/trinit", "serve_step/specqp",
                                  "serve_step/trinit"])
def test_capped_rings_and_serve_step_match_jax(both, name):
    """Wrapping seen rings, and ``serve_step`` at kg-specqp's engine
    settings against the reference's ``make_cell`` function."""
    jax_out, port = both
    _check(jax_out, port[0], name)


@pytest.mark.parametrize("mode", list(CELL_SHAPES))
def test_kg_cell_matches_jax(both, mode):
    """kg-specqp's cell function on the DeviceMesh-built ``Mesh`` against
    the reference's ``make_cell`` function (``make_batched_sharded_fn`` at
    the engine settings): keys, masks and the four counters exact (n_wasted
    0), scores within rtol 1e-5, on every rank."""
    jax_out, port = both
    for rank in port:
        for f in FIELDS:
            want, got = jax_out[f"serve_step/{mode}/{f}"], \
                rank[f"cell/{mode}/{f}"]
            if f == "scores":
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)
        assert not rank[f"cell/{mode}/n_wasted"].any()


@pytest.mark.parametrize("case", RETRIEVAL_CASES)
def test_sharded_retrieve_matches_jax(both, case):
    jax_out, port = both
    for qi in range(2):
        p = f"retrieve/{case}/{qi}"
        np.testing.assert_array_equal(port[0][f"{p}/ids"],
                                      jax_out[f"{p}/ids"], err_msg=p)
        assert int(port[0][f"{p}/tiles"]) == int(jax_out[f"{p}/tiles"]), p
        np.testing.assert_allclose(port[0][f"{p}/scores"],
                                   jax_out[f"{p}/scores"], rtol=1e-6,
                                   err_msg=p)
    if case == "dup":
        # Equal scores from ranks 1 and 2 met in the merge, and the
        # reference's two-level order (over "data", then "model") put rank
        # 2's copy first, where one stable sort would not.
        rows = N // 4
        met = [a for qi in range(2)
               for a, b in zip(*[jax_out[f"retrieve/dup/{qi}/ids"][j:]
                                 for j in (0, 1)])
               if 2 * rows <= a < 3 * rows and b == a - rows]
        assert met


def test_every_rank_returns_the_same(both):
    _, port = both
    for rank in port[1:]:
        for key, v in port[0].items():
            if key not in ("coords", "collectives"):
                np.testing.assert_array_equal(rank[key], v, err_msg=key)


def test_mesh_coords_and_collectives(both):
    """Row-major coordinates, and psum / pmax / all_gather over the line
    of ranks along each axis, in axis order."""
    _, port = both
    for r, out in enumerate(port):
        coords, flat, idx = out["coords"]
        assert coords == (r // 2, r % 2) and flat == r and idx == list(coords)
        lines = {"data": [c * 2 + coords[1] for c in range(2)],
                 "model": [coords[0] * 2 + c for c in range(2)]}
        for ax, line in lines.items():
            vals = np.array([[q + 1.0, -q] for q in line])
            s, m, g = out["collectives"][ax]
            np.testing.assert_array_equal(s, vals.sum(0))
            np.testing.assert_array_equal(m, vals.max(0))
            np.testing.assert_array_equal(g, vals)


def test_spawn_reraises_a_failing_rank():
    from repro_torch.launch import mesh

    with pytest.raises(ValueError, match="rank 2 fails"):
        mesh.spawn(failing_rank, MESH, AXES, backend="gloo", device="cpu")


@pytest.mark.parametrize("k", MERGE_KS)
def test_merge_top_k_keeps_lax_tie_order(both, k):
    """Many equal scores and -inf padding: every rank's merge equals the
    reference's two-level one, ``lax.top_k`` over the gathered buffers of
    "data", then of "model" (equal scores in gathered order; ``torch.topk``
    orders them arbitrarily)."""
    import jax

    _, port = both
    x, ids = merge_case()
    lines = []
    for m in range(2):           # over "data": ranks (0, m) and (1, m)
        s, i = jax.lax.top_k(np.concatenate([x[m], x[2 + m]], -1), k)
        lines.append((np.asarray(s), np.take_along_axis(
            np.concatenate([ids[m], ids[2 + m]], -1), np.asarray(i), -1)))
    s, i = jax.lax.top_k(np.concatenate([lines[0][0], lines[1][0]], -1), k)
    want_ids = np.take_along_axis(
        np.concatenate([lines[0][1], lines[1][1]], -1), np.asarray(i), -1)
    for out in port:
        np.testing.assert_array_equal(out[f"merge/{k}/scores"], np.asarray(s))
        np.testing.assert_array_equal(out[f"merge/{k}/ids"], want_ids)


@pytest.mark.parametrize("mode", ("trinit", "specqp", "specqp_pattern"))
def test_sharded_equals_unsharded_under_the_same_masks(both, mode):
    """Independent of the reference: key sets partition over the shards,
    so the sharded batch (rings uncapped) answers as the port's one-device
    engine over the unsharded store does under the same plans."""
    from repro_torch.core import engine
    from repro_torch.core.types import EngineConfig
    from repro_torch.data import kg_synth

    _, port = both
    got = {f: port[0][f"batched/exact/{mode}/{f}"] for f in FIELDS}
    wl = kg_synth.tiny_workload(**WL, device="cpu")
    want = _np(engine.run_query_batch_with_masks(
        wl.store, wl.relax, wl.queries, torch.from_numpy(got["relax_mask"]),
        EngineConfig(**CFG), device="cpu"))
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-6)


def test_mix_hash_matches_jax():
    from repro.core import distributed as jdist
    from repro_torch.core import distributed

    keys = np.random.default_rng(0).integers(0, 2**31 - 1, 10_000)
    for n in (1, 3, 4, 8):
        np.testing.assert_array_equal(distributed.mix_hash(keys, n),
                                      jdist.mix_hash(keys, n))


def _assert_bit_equal(stores, g_stats, jstores, jg_stats):
    for f in ("keys", "scores", "lengths", "sorted_keys", "stats"):
        a, b = getattr(stores, f).numpy(), np.asarray(getattr(jstores, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert (stores.sketch.numpy().view(np.uint32).tobytes()
            == np.asarray(jstores.sketch).tobytes())
    assert g_stats.numpy().tobytes() == np.asarray(jg_stats).tobytes()


@pytest.mark.parametrize("seed,n_shards", [(0, 4), (1, 4), (2, 3)])
def test_shard_workload_bit_equal_to_jax(seed, n_shards):
    from repro.core import distributed as jdist
    from repro_torch.core import distributed

    lists = pattern_lists(small_workload(seed=seed).store)
    _assert_bit_equal(*distributed.shard_workload(lists, n_shards),
                      *jdist.shard_workload(lists, n_shards))


def test_shard_workload_survives_hash_skew():
    """Every key on one shard: the true per-shard maximum sizes the
    stores (the reference's regression test), and the arrays are
    bit-equal to the reference's."""
    from repro.core import distributed as jdist
    from repro_torch.core import distributed

    n_shards = 4
    cand = np.arange(50_000)
    hot = cand[distributed.mix_hash(cand, n_shards) == 0][:256]
    assert len(hot) == 256
    lists = [(hot.astype(np.int32), np.linspace(2.0, 1.0, 256))]
    stores, g_stats = distributed.shard_workload(lists, n_shards)
    lengths = stores.lengths.numpy()
    assert lengths.shape == (n_shards, 1)
    assert int(lengths.sum()) == 256 and int(lengths[0, 0]) == 256
    keys0 = stores.keys.numpy()[0, 0]
    assert set(keys0[keys0 >= 0].tolist()) == set(hot.tolist())
    _assert_bit_equal(stores, g_stats, *jdist.shard_workload(lists,
                                                             n_shards))
