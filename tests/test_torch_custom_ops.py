"""The KG and retrieval kernels as PyTorch operators: ``repro_torch::
rank_join_lookup``, ``merge_topk``, ``topk_score_pruned``,
``embedding_bag`` and ``embedding_bag_backward``.

Each passes ``torch.library.opcheck`` on CPU inputs (schema, fake impl,
autograd registration, dynamic-shape tracing); each fake impl gives the
shapes and dtypes of the CPU op's outputs; on the meta device (the dry
run's fake shards on a CPU-only build) ``kernels.ops`` reaches the ops
and runs no plain version; the FLOP formulas are the stated ones, and the
two KG ops, whose work is compares, have none."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.kernels import embedding_bag, merge_topk, ops, rank_join, ref
from repro_torch.kernels import topk_score


def _lookup_args(rng):
    G, N, B = 3, 16, 8
    keys = rng.permutation(64)[:G * N].reshape(G, N).astype(np.int32)
    keys[:, -3:] = -1
    probes = rng.integers(-1, 64, (G, B)).astype(np.int32)
    return (torch.from_numpy(keys),
            torch.from_numpy(rng.random((G, N)).astype(np.float32)),
            torch.from_numpy(probes),
            torch.tensor([N, 5, 0], dtype=torch.int32))


def _merge_args(rng):
    return (torch.from_numpy(rng.integers(0, 99, (2, 3, 8)).astype(np.int32)),
            torch.from_numpy(rng.random((2, 3, 8)).astype(np.float32)), 5)


def _pruned_args(rng):
    cands = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    query = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    return query, cands, ops.block_bounds_cauchy(query, cands, 16), 5, 16


def _bag_args(rng, grad=False):
    table = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 20, (4, 3)).astype(np.int32))
    w = torch.from_numpy(rng.random((4, 3)).astype(np.float32))
    return (table.requires_grad_(grad), ids, w.requires_grad_(grad))


def _bag_backward_args(rng, table_grad=True, weights_grad=True):
    table, ids, w = _bag_args(rng)
    dout = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    return dout, ids, w, table, table_grad, weights_grad


CASES = {
    "rank_join_lookup": (rank_join.lookup_op, _lookup_args),
    "merge_topk": (merge_topk.merge_op, _merge_args),
    "topk_score_pruned": (topk_score.pruned_op, _pruned_args),
    "embedding_bag": (embedding_bag.bag_op, lambda r: _bag_args(r, True)),
    "embedding_bag_backward": (embedding_bag.bag_backward_op,
                               _bag_backward_args),
}


@pytest.mark.parametrize("name", list(CASES))
def test_opcheck(name):
    op, make = CASES[name]
    torch.library.opcheck(op, make(np.random.default_rng(0)))


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("flags", [(True, True), (True, False),
                                   (False, True)])
def test_backward_fake_matches_cpu_for_each_gradient(flags):
    """The backward op returns the gradients asked for, in order, and its
    fake impl the same list."""
    args = _bag_backward_args(np.random.default_rng(1), *flags)
    got = embedding_bag.bag_backward_op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = embedding_bag.bag_backward_op(*args)
    want = [g for g, asked in zip(ref.embedding_bag_backward(
        *args[:4], table_grad=flags[0], weights_grad=flags[1]), flags)
        if asked]
    assert [(t.shape, t.dtype) for t in fake] == \
        [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_fake_impl_matches_cpu_op(name):
    """Outputs' shapes and dtypes under ``FakeTensorMode`` equal the CPU
    op's, and the CPU op's outputs equal the plain version's."""
    op, make = CASES[name]
    args = make(np.random.default_rng(2))
    with torch.no_grad():
        real = _leaves(op(*args))
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode, torch.no_grad():
        fake = _leaves(op(*fake_args))
    assert [(t.shape, t.dtype) for t in fake] == \
        [(t.shape, t.dtype) for t in real]
    plain = {"rank_join_lookup": ref.rank_join_lookup,
             "merge_topk": ref.merge_topk,
             "topk_score_pruned": ref.topk_score_pruned,
             "embedding_bag": ref.embedding_bag}.get(name)
    if plain is not None:
        with torch.no_grad():
            for got, want in zip(real, _leaves(plain(*args))):
                assert torch.equal(got, want)


def test_ops_reach_the_custom_ops_on_meta_tensors():
    """On the meta device (no values) ``kernels.ops`` gives every output's
    shape through the ops' fake impls: no plain version runs and no launch
    is counted."""
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    rng = np.random.default_rng(3)
    ops.reset_launches()
    s, f = ops.rank_join_lookup(*map(meta, _lookup_args(rng)))
    assert (s.shape, s.dtype, f.dtype) == ((3, 8), torch.float32, torch.bool)
    k, v, i = ops.merge_topk(*map(meta, _merge_args(rng)[:2]), 5)
    assert [t.shape for t in (k, v, i)] == [(2, 5)] * 3
    q, c, b, *_ = _pruned_args(rng)
    sc, idx, n = ops.topk_score_pruned(meta(q), meta(c), meta(b), 5, 16)
    assert (sc.shape, idx.dtype, n.shape) == ((5,), torch.int32, ())
    table, ids, w = (meta(t) for t in _bag_args(rng))
    table.requires_grad_(True)
    out = ops.embedding_bag(table, ids, w)
    assert out.shape == (4, 8) and out.device.type == "meta"
    (dtable,) = torch.autograd.grad(out.sum(), table)
    assert dtable.shape == table.shape
    dt, dw = ops.embedding_bag_backward(meta(torch.ones(4, 8)), ids, w, table,
                                        weights_grad=True)
    assert dt.shape == (20, 8) and dw.shape == (4, 3)
    assert set(ops.launches().values()) == {0}


def test_flop_formulas():
    """2·B·S·D for the bag, as much again a gradient for its backward, 2·N·D
    for the pruned retrieval (every tile counted), none for the KG ops."""
    rng = np.random.default_rng(4)
    table, ids, w = _bag_args(rng, grad=True)
    with FlopCounterMode(display=False) as fc:
        out = ops.embedding_bag(table, ids, w)
        out.sum().backward()
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert by_op["repro_torch.embedding_bag"] == 2 * 4 * 3 * 8
    assert by_op["repro_torch.embedding_bag_backward"] == 2 * 2 * 4 * 3 * 8
    with FlopCounterMode(display=False) as fc:
        ops.topk_score_pruned(*_pruned_args(rng))
    assert fc.get_total_flops() == 2 * 64 * 8
    for op in (torch.ops.repro_torch.rank_join_lookup,
               torch.ops.repro_torch.merge_topk):
        assert op not in flop_registry


def test_gradients_through_the_op_equal_the_plain_backward():
    """The forward op's autograd is the backward op: the table's and the
    weights' gradients equal ``ref.embedding_bag_backward``'s."""
    rng = np.random.default_rng(5)
    table, ids, w = _bag_args(rng, grad=True)
    dout = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    got = torch.autograd.grad(ops.embedding_bag(table, ids, w), (table, w),
                              dout)
    want = ref.embedding_bag_backward(dout, ids, w.detach(), table.detach(),
                                      weights_grad=True)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
