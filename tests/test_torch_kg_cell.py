"""kg-specqp's dry-run cell and the executor's bounded trips
(``engine._execute_refill(trips=...)``).

A bounded run at the loop's own trip count equals the loop, every field,
on a continuous-refill queue (lanes < queue) and on a fixed batch: the
selects that splice queries into lanes do what the loop's indexed writes
do. The smoke-size cell runs on fake shards over a fake (2, 2) mesh with
one trip, and the ops it counts equal those of one real trip (every lane
refilled) run on real CPU shards of the same shapes, counted by the same
``LocalCost``: the same FLOP count and the same kernel calls, op for op.
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import TEST_GRID_BINS
from repro_torch import sharding
from repro_torch.configs import kg_specqp
from repro_torch.core import distributed, engine
from repro_torch.core.types import EngineConfig
from repro_torch.data import kg_synth
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

CFG = EngineConfig(block=8, k=5, grid_bins=TEST_GRID_BINS)
FIELDS = ("keys", "scores", "n_pulled", "n_answers", "n_iters", "n_wasted")
WL = dict(n_queries=8, n_entities=384, list_len=48, n_relax=3)


def _workload(seed):
    return kg_synth.tiny_workload(seed=seed, **WL, device="cpu")


def _run_counting_trips(monkeypatch, *args, **kwargs):
    """``engine.execute_queue``'s result and the trips its loop made."""
    trips = [0]
    step = engine._step

    def counted(*a, **k):
        trips[0] += 1
        return step(*a, **k)

    monkeypatch.setattr(engine, "_step", counted)
    res = engine.execute_queue(*args, **kwargs)
    monkeypatch.setattr(engine, "_step", step)
    return res, trips[0]


@pytest.mark.parametrize("lanes", [3, 8])
@pytest.mark.parametrize("mode", ["specqp", "trinit"])
def test_bounded_trips_equal_the_loop_at_its_count(monkeypatch, mode, lanes):
    wl = _workload(1)
    store, relax = wl.store, wl.relax
    pids = torch.as_tensor(np.asarray(wl.queries))
    masks = engine.plan_query_batch(store, relax, pids, CFG, mode, "cpu")
    want, trips = _run_counting_trips(monkeypatch, store, relax, pids, masks,
                                      CFG, lanes, device="cpu")
    assert trips > 1
    got = engine.execute_queue(store, relax, pids, masks, CFG, lanes,
                               device="cpu", trips=trips)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if lanes < len(pids):
        assert int(want.n_wasted.sum()) > 0      # lanes idled: refills ran
    short = engine.execute_queue(store, relax, pids, masks, CFG, lanes,
                                 device="cpu", trips=1)
    assert int(short.n_iters.max()) <= 1


class _KernelCalls(TorchDispatchMode):
    """Every call of the port's custom ops: (name, input shapes, other
    arguments)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "repro_torch":
            self.calls.append((func._opname, tuple(
                tuple(a.shape) if isinstance(a, torch.Tensor) else a
                for a in args)))
        return func(*args, **(kwargs or {}))


def _pattern_lists(store):
    keys, scores, lengths = (store.keys.numpy(), store.scores.numpy(),
                             store.lengths.numpy())
    return [(keys[p, :n], scores[p, :n]) for p, n in enumerate(lengths)]


@pytest.mark.parametrize("shape", kg_specqp.SHAPES)
def test_fake_cell_counts_one_real_trip(monkeypatch, shape):
    wl = _workload(0)
    stores, gstats = distributed.shard_workload(_pattern_lists(wl.store), 4)
    queries = torch.as_tensor(np.asarray(wl.queries), dtype=torch.int32)
    for name, value in (("N_PATTERNS", stores.keys.shape[1]),
                        ("L_SHARD", stores.keys.shape[2]),
                        ("N_RELAX", wl.relax.ids.shape[1]),
                        ("N_QUERIES", queries.shape[0]),
                        ("T_MAX", queries.shape[1])):
        monkeypatch.setattr(kg_specqp, name, value)
    real = ({f: getattr(stores, f) for f in
             ("keys", "scores", "lengths", "sorted_keys", "stats",
              "sketch")},
            {"ids": wl.relax.ids, "weights": wl.relax.weights},
            gstats, queries)
    with dryrun.fake_world(4):
        mesh = mesh_lib.make_device_mesh((2, 2), device_type="cpu")
        with sharding.use_rules(mesh):
            cell = kg_specqp.make_cell(shape)
            for arg, spec in zip(real, cell.args):
                for t, s in zip(*(x.values() if isinstance(x, dict) else (x,)
                                  for x in (arg, spec))):
                    assert (t.shape, t.dtype) == (s.shape, s.dtype)
            fake_calls = _KernelCalls()
            with fake_calls:
                fake = dryrun.measure(cell, mesh)
            args = [sharding.distribute(a, ax, mesh)
                    for a, ax in zip(real, cell.arg_axes)]
            cost, real_calls = dryrun.LocalCost(real=True), _KernelCalls()
            with real_calls, cost, implicit_replication():
                out = cell.fn(*args, **cell.static_kwargs)
    assert cell.static_kwargs == {"trips": 1}
    assert out["keys"].shape == (queries.shape[0], kg_specqp.ENGINE.k)
    assert cost.flops == fake["cost"]["flops"]
    assert dict(cost.flops_by_op) == fake["cost"]["flops_by_op"]
    assert real_calls.calls == fake_calls.calls
    # One trip: one pull and one probe launch over the lanes.
    assert [c[0] for c in real_calls.calls] == ["merge_topk",
                                                "rank_join_lookup"]
