"""The two-tower dry-run cells' functions run for real on a (2, 2) mesh of
4 gloo ranks at smoke widths (``configs.two_tower_retrieval.make_cell``:
the tables split by rows over model, the MLP weights over data and model,
the batch over data, the corpora by rows over both axes), against the
unsharded port on the same numbers:

- ``train_batch``: the loss and every gradient leaf (the vocab-parallel
  bag's table rows and the FSDP weights) within rtol 1e-5 and atol 1e-6 of
  the leaf's largest |value|, and the cell's own train step's loss;
- ``serve_p99`` and ``serve_bulk`` (two chunks of users): the scores
  within that bar and the top-k ids exactly at every place with no
  near-tie (a neighbour within 1e-5 relative): the sharded MLP sums the
  split ``mlp`` columns in another order, which moves a user's scores by
  an ulp or so, enough to swap two that close;
- ``retrieval_cand``: the ids exactly (scores within the bar) against the
  unsharded ``retrieve``, and the tiles scored exactly against the sharded
  ``retrieve`` on the process ``Mesh`` (four shards' local pruning, which
  one unsharded call does not do).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib

MESH, AXES = (2, 2), ("data", "model")
B_TRAIN, B_P99, B_BULK = 16, 8, 8192
CORPUS, TILE, N_QUERIES = 4096, 256, 2


def _batch(cfg, B, rng):
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    f32, i32 = torch.float32, torch.int32
    ids = rng.integers(0, cfg.user_vocab, (B, cfg.user_slots))
    ids[rng.random(ids.shape) < 0.25] = -1
    return {
        "user_ids": t(ids, i32),
        "user_w": t(rng.random((B, cfg.user_slots)), f32),
        "user_dense": t(rng.standard_normal((B, cfg.n_dense_feat)), f32),
        "item_ids": t(rng.integers(0, cfg.item_vocab, (B, cfg.item_slots)),
                      i32),
        "item_w": t(rng.random((B, cfg.item_slots)), f32),
        "item_dense": t(rng.standard_normal((B, cfg.n_dense_feat)), f32),
        "item_logq": t(rng.standard_normal(B) * 0.1, f32),
    }


def _full(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def two_tower_rank(mesh):
    """Each two-tower cell's function sharded on a (2, 2) DeviceMesh, and
    the unsharded port on the same numbers; host arrays by name."""
    from functools import partial

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding
    from repro_torch.configs import two_tower_retrieval as tt
    from repro_torch.models import recsys
    from repro_torch.train import loop, tree

    torch.set_num_threads(1)
    cfg = tt.smoke_config()
    tt.config = lambda: cfg                # this rank's process only
    tt.CELL_BATCH = {"train_batch": B_TRAIN, "serve_p99": B_P99,
                     "serve_bulk": B_BULK}
    tt.CORPUS = tt.N_CAND_PAD = CORPUS
    tt.TILE = TILE
    rng = np.random.default_rng(11)
    dmesh = mesh_lib.make_device_mesh(MESH, AXES, device_type="cpu")
    model = recsys.init(cfg, seed=0, device="cpu")
    params = tree.tree_map(lambda p: p.detach().clone(),
                           recsys.param_tree(model))
    axes = recsys.param_axes(cfg)
    out = {}

    def fresh(sharded):
        p = tree.tree_map(lambda t: t.clone(), params)
        if sharded:
            p = sharding.distribute(p, axes, dmesh)
        for leaf in tree.leaves(p):
            leaf.requires_grad_(True)
        return p

    train = _batch(cfg, B_TRAIN, rng)
    loss_fn = partial(tt._loss, cfg=cfg)
    loss, _, grads = loop.value_and_grad(loss_fn, fresh(False), train)
    out["train/ref"] = [loss.numpy()] + [g.numpy() for g in tree.leaves(grads)]
    state = loop.make_train_state(fresh(False), tt.TRAIN_CFG)
    out["step/ref"] = loop.make_train_step(loss_fn, tt.TRAIN_CFG)(
        state, train)[1]["loss"].numpy()

    corpus = rng.standard_normal((CORPUS, cfg.embed_dim)).astype(np.float32)
    mags = np.repeat(np.geomspace(4.0, 0.1, CORPUS // TILE), TILE)[:, None]
    cands = torch.from_numpy((corpus * mags).astype(np.float32))
    queries = torch.from_numpy(rng.standard_normal(
        (N_QUERIES, cfg.embed_dim)).astype(np.float32))
    serve_batches = {"serve_p99": _batch(cfg, B_P99, rng),
                     "serve_bulk": _batch(cfg, B_BULK, rng)}
    for shape, batch in serve_batches.items():
        s, i = tt.serve(model, batch, torch.from_numpy(corpus))
        out[f"{shape}/ref"] = [s.numpy(), i.numpy()]
    for qi, q in enumerate(queries):
        s, i, n = tt.retrieve(q, cands, tt.TOPK, TILE)
        out[f"retrieve/{qi}/ref"] = [s.numpy(), i.numpy()]
        rows = CORPUS // 4
        lo = mesh.flat_index() * rows
        out[f"retrieve/{qi}/mesh_tiles"] = int(tt.retrieve(
            q, cands[lo:lo + rows].clone(), tt.TOPK, TILE, mesh=mesh)[2])

    with sharding.use_rules(dmesh), implicit_replication():
        cell = tt.make_cell("train_batch")
        dtrain = sharding.distribute(train, cell.arg_axes[1], dmesh)
        loss, _, grads = loop.value_and_grad(loss_fn, fresh(True), dtrain)
        out["train/got"] = [_full(loss)] + [_full(g)
                                            for g in tree.leaves(grads)]
        state = sharding.distribute(
            loop.make_train_state(fresh(False), tt.TRAIN_CFG),
            cell.arg_axes[0], dmesh)
        for leaf in tree.leaves(state["params"]):
            leaf.requires_grad_(True)
        out["step/got"] = _full(cell.fn(state, dtrain)[1]["loss"])
        for shape, batch in serve_batches.items():
            cell = tt.make_cell(shape)
            args = [sharding.distribute(a, ax, dmesh) for a, ax in zip(
                (params, batch, torch.from_numpy(corpus)), cell.arg_axes)]
            out[f"{shape}/got"] = [_full(t) for t in cell.fn(*args)]
        cell = tt.make_cell("retrieval_cand")
        for qi, q in enumerate(queries):
            args = [sharding.distribute(a, ax, dmesh)
                    for a, ax in zip((q, cands), cell.arg_axes)]
            s, i, n = cell.fn(*args)
            out[f"retrieve/{qi}/got"] = [s.numpy(), i.numpy()]
            out[f"retrieve/{qi}/tiles"] = int(n)
    return out


@pytest.fixture(scope="module")
def ranks():
    return mesh_lib.spawn(two_tower_rank, MESH, AXES, backend="gloo",
                          device="cpu")


def _close(got, want, what):
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=what)


def test_train_loss_and_gradients_equal_unsharded(ranks):
    for rank in ranks:
        got, want = rank["train/got"], rank["train/ref"]
        assert len(got) == len(want) == 7            # loss + 2 x 3 leaves
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"leaf {i}")
        _close(rank["step/got"], rank["step/ref"], "the step's loss")


def _clear(scores):
    """The places of each row whose score is more than 1e-5 (relative) from
    both neighbours' (the k-th place's lower neighbour is unknown: never
    clear)."""
    gap = np.abs(scores[:, :-1] - scores[:, 1:]) > 1e-5 * np.abs(
        scores[:, :-1])
    clear = np.zeros_like(scores, bool)
    clear[:, :-1] = gap
    clear[:, 1:-1] &= gap[:, :-1]
    return clear


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_serve_equals_unsharded(ranks, shape):
    for rank in ranks:
        (gs, gi), (ws, wi) = rank[f"{shape}/got"], rank[f"{shape}/ref"]
        assert gi.dtype == np.int32 and gi.shape == wi.shape
        _close(gs, ws, shape)
        clear = _clear(ws)
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(gi[clear], wi[clear])


@pytest.mark.parametrize("qi", range(N_QUERIES))
def test_retrieval_equals_unsharded(ranks, qi):
    for rank in ranks:
        (gs, gi), (ws, wi) = (rank[f"retrieve/{qi}/got"],
                              rank[f"retrieve/{qi}/ref"])
        np.testing.assert_array_equal(gi, wi)
        _close(gs, ws, "scores")
        assert rank[f"retrieve/{qi}/tiles"] == \
            rank[f"retrieve/{qi}/mesh_tiles"]
