"""The port's ingest: stores bit-equal to the JAX package's for one seed."""
import numpy as np
import pytest
import torch

from repro.core import kg as jkg
from repro.data import kg_synth as jks
from repro_torch import convert
from repro_torch.core import kg, types
from repro_torch.data import kg_synth

# Small tensors: one intra-op thread per test worker keeps the workers of
# a parallel test run from spinning on each other's cores.
torch.set_num_threads(1)

STORE_FIELDS = ("keys", "scores", "lengths", "sorted_keys", "stats")


def _assert_same_workload(jw, tw):
    for f in STORE_FIELDS:
        a, b = np.asarray(getattr(jw.store, f)), getattr(tw.store, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    sketch = np.asarray(jw.store.sketch)
    assert sketch.dtype == np.uint32
    assert tw.store.sketch.dtype == torch.int32
    np.testing.assert_array_equal(sketch.view(np.int32),
                                  tw.store.sketch.numpy())
    np.testing.assert_array_equal(np.asarray(jw.relax.ids),
                                  tw.relax.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jw.relax.weights),
                                  tw.relax.weights.numpy())
    np.testing.assert_array_equal(jw.queries, tw.queries)
    assert (jw.n_entities, jw.name) == (tw.n_entities, tw.name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["xkg_mini", "twitter_mini"])
def test_make_workload_bit_equal(seed, name):
    kw = dict(seed=seed, n_entities=2000, list_len=96, n_queries=5)
    _assert_same_workload(jks.make_workload(name, **kw),
                          kg_synth.make_workload(name, device="cpu", **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tiny_workload_bit_equal(seed):
    _assert_same_workload(jks.tiny_workload(seed=seed),
                          kg_synth.tiny_workload(seed=seed, device="cpu"))


def test_convert_round_trip():
    """A JAX store carried across through numpy equals the port's own
    build, and its tensors give the JAX arrays back (sketch as uint32)."""
    jw = jks.tiny_workload(seed=4)
    tw = kg_synth.tiny_workload(seed=4, device="cpu")
    arrays = {f: np.asarray(getattr(jw.store, f))
              for f in STORE_FIELDS + ("sketch",)}
    store = convert.store_from_numpy(**arrays, device="cpu")
    relax = convert.relax_from_numpy(np.asarray(jw.relax.ids),
                                     np.asarray(jw.relax.weights),
                                     device="cpu")
    for f in STORE_FIELDS + ("sketch",):
        assert torch.equal(getattr(store, f), getattr(tw.store, f)), f
    assert torch.equal(relax.ids, tw.relax.ids)
    assert torch.equal(relax.weights, tw.relax.weights)
    for f, a in arrays.items():
        back = getattr(store, f).numpy()
        if f == "sketch":
            back = back.view(np.uint32)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
    with pytest.raises(ValueError):
        convert.store_from_numpy(**{**arrays, "sketch":
                                    arrays["sketch"].view(np.int32)},
                                 device="cpu")


def test_build_store_matches_jax_and_rejects_duplicates():
    lists = [(np.array([5, 3, 9], np.int32), np.array([1.0, 4.0, 2.0])),
             (np.array([], np.int32), np.array([])),
             (np.array([7], np.int32), np.array([0.0]))]
    js = jkg.build_store(lists, list_len=4)
    ts = kg.build_store(lists, list_len=4, device="cpu")
    for f in STORE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), err_msg=f)
    jr = jkg.build_relax_table(3, {0: [(2, 0.5), (1, 0.9)]})
    tr = kg.build_relax_table(3, {0: [(2, 0.5), (1, 0.9)]}, device="cpu")
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_array_equal(np.asarray(jr.weights), tr.weights.numpy())
    with pytest.raises(ValueError, match="unique"):
        kg.build_store([(np.array([1, 1], np.int32), np.array([1.0, 2.0]))],
                       device="cpu")


def test_no_device_without_cuda_raises(monkeypatch):
    """Entry points default to CUDA and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        types.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        kg_synth.tiny_workload(seed=0)
    assert types.resolve_device("cpu") == torch.device("cpu")
