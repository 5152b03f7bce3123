"""The MoE and MLA LMs sharded: granite-moe-3b-a800m's smoke config (40
experts' layout: every rank keeps every expert, their width split over
``expert_mlp``) and deepseek-v3-671b's (MLA, a dense prefix, the routed
experts split over ``expert``, two a rank, a shared expert, MTP), each run
for real on a (2, 2) mesh of 4 gloo ranks and held to the unsharded port:
loss, gradients, prefill logits and caches, a decode step and its caches
within ``test_torch_sharding``'s bar, the routing (every chunk's experts
and places, so its drops) exact. A capacity case drops assignments and the
sharded run drops the same ones. The dry run's fake (2, 2) prefill asks
for the real run's collectives, and gathers no routed expert's weight.

The full comparison runs the smoke configs with float64 parameters and
activations (``F64``; the router, the attention and the decode's scores
stay float32, as the models have them). In float32 the sharded sums
(granite's experts split by width, each rank's experts' partial sums,
MLA's q norm over split ranks) round differently from the unsharded ones,
and these MoE models are badly conditioned for the bar: moving every
parameter of the unsharded float32 granite smoke model by one part in
10^7 moves its gradients up to 4.5 times the bar (gemma2-2b's: 0.7
times). In float64 those roundings vanish and the bar holds any fault of
the layouts to its size; float32 is held on the prefill, whose logits
and caches meet the bar, and on the routing, which is exact in both."""
import copy
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.configs import deepseek_v3_671b, granite_moe_3b_a800m
from repro_torch.configs import lm_common
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from test_torch_sharding import _close, _numpy, _run

ARCHS = {"granite-moe-3b-a800m": granite_moe_3b_a800m,
         "deepseek-v3-671b": deepseek_v3_671b}
# deepseek's smoke config with 4 routed experts: one a rank on the (2, 2)
# mesh, fewer than top-K, as deepseek's 256 lie on the 16 × 16 one (each
# token's rows on a rank packed into min(K, E_loc) columns).
ONE_EXPERT = "deepseek-v3-671b/1-expert"


def _configs():
    cfgs = {a: m.smoke_config() for a, m in ARCHS.items()}
    ds = cfgs["deepseek-v3-671b"]
    cfgs[ONE_EXPERT] = dataclasses.replace(
        ds, moe=dataclasses.replace(ds.moe, n_experts=4))
    return cfgs
# Batch 4 over data, 32 tokens over model: two chunks of 64 tokens
# (moe_chunk 64), each spread over all four ranks.
GLOO_BATCH, GLOO_SEQ = 4, 32
# The capacity case: granite's smoke widths, one chunk of 4 × 512 = 2048
# tokens (moe_chunk 2048) at capacity factor 1.0, so C = 2048 · 2 / 8 =
# 512, the mean load: the fuller experts drop.
CAP_BATCH, CAP_SEQ = 4, 512
F64 = dict(param_dtype="float64", compute_dtype="float64")


def capacity_config():
    cfg = granite_moe_3b_a800m.smoke_config()
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0),
        moe_chunk=2048, **F64)


@dataclasses.dataclass
class _Routes:
    """Every chunk's experts and places, recorded from ``moe._places`` (its
    calls over whole chunks: those with E bins), one record a chunk,
    sorted: chunks may be batched differently sharded and not, and
    autograd may recompute a layer's chunks in another order."""
    E: int
    records: list = dataclasses.field(default_factory=list)

    def __enter__(self):
        self._orig = orig = moe._places

        def places(bins, n_bins):
            out = orig(bins, n_bins)
            if n_bins == self.E:
                self.records.extend(zip(bins.reshape(-1, *bins.shape[-2:]),
                                        out.reshape(-1, *out.shape[-2:])))
            return out

        moe._places = places
        return self

    def __exit__(self, *exc):
        moe._places = self._orig

    def arrays(self):
        return sorted((torch.stack([i, p]).numpy() for i, p in self.records),
                      key=lambda a: (a.shape, a.tobytes()))


def _model(cfg, seed, B, S):
    gen = torch.Generator().manual_seed(seed)
    model = tf.init(cfg, gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         dtype=torch.int32)
    return model, toks, torch.roll(toks, -1, 1)


def _sharded(model, dmesh, *tensors):
    m = sharding.distribute(copy.deepcopy(model), tf.param_axes(model),
                            dmesh)
    return (m, *(sharding.distribute(t, ("batch", "seq"), dmesh)
                 for t in tensors))


def gloo_rank(mesh):
    """Each MoE smoke LM unsharded and sharded on the (2, 2) mesh, the
    routing of both recorded; the collectives of the sharded prefill; and
    the capacity case's loss, gradients and prefill logits."""
    from torch.distributed.tensor.experimental import implicit_replication
    dmesh = mesh_lib.make_device_mesh((2, 2), device_type="cpu")
    out = {}
    for arch, cfg in _configs().items():
        cfg = dataclasses.replace(cfg, **F64)
        model, toks, labels = _model(cfg, 0, GLOO_BATCH, GLOO_SEQ)
        with _Routes(cfg.moe.n_experts) as want_routes:
            ref = _run(copy.deepcopy(model), cfg, toks, labels)
        with sharding.use_rules(dmesh), implicit_replication():
            sharded, t2, l2 = _sharded(model, dmesh, toks, labels)
            with _Routes(cfg.moe.n_experts) as got_routes:
                got = _run(sharded, cfg, t2, l2)
        out[arch] = {"ref": _numpy(ref), "got": _numpy(got),
                     "routes": (want_routes.arrays(), got_routes.arrays())}
        if arch in ARCHS:
            out[arch + "/f32"] = _prefill_f32(dmesh, ARCHS[arch]
                                              .smoke_config())
    out["capacity"] = _capacity_case(dmesh)
    return out


def _prefill_f32(dmesh, cfg):
    """The smoke config as it is (float32): prefill logits and caches, the
    routing, and the collectives the sharded prefill asks for."""
    from torch.distributed.tensor.experimental import implicit_replication
    model, toks, _ = _model(cfg, 0, GLOO_BATCH, GLOO_SEQ)

    def prefill(m, t):
        # The dry run's prefill cell: max_seq is the prompt's length.
        with torch.no_grad():
            logits, caches = tf.prefill(m, cfg, t, max_seq=GLOO_SEQ)
        return {"logits": logits, "prefill_caches": caches}

    with _Routes(cfg.moe.n_experts) as want_routes:
        ref = prefill(model, toks)
    with sharding.use_rules(dmesh), implicit_replication():
        sharded, t2 = _sharded(model, dmesh, toks)
        log = dryrun.CollectiveLog(dmesh)
        with _Routes(cfg.moe.n_experts) as got_routes, log:
            got = prefill(sharded, t2)
    return {"ref": _numpy(ref), "got": _numpy(got),
            "routes": (want_routes.arrays(), got_routes.arrays()),
            "counts": log.counts()}


def _capacity_case(dmesh):
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = capacity_config()
    model, toks, labels = _model(cfg, 3, CAP_BATCH, CAP_SEQ)

    def run(m, t, lab):
        params = tf.param_tree(m)
        leaves = [p for p in _leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = tf.loss_fn(params, cfg, t, lab)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            logits, _ = tf.prefill(m, cfg, t, max_seq=CAP_SEQ)
        return {"loss": loss, "grads": list(grads), "logits": logits}

    with _Routes(cfg.moe.n_experts) as want_routes:
        ref = run(copy.deepcopy(model), toks, labels)
    with sharding.use_rules(dmesh), implicit_replication():
        sharded, t2, l2 = _sharded(model, dmesh, toks, labels)
        with _Routes(cfg.moe.n_experts) as got_routes:
            got = run(sharded, t2, l2)
    return {"ref": _numpy(ref), "got": _numpy(got),
            "routes": (want_routes.arrays(), got_routes.arrays())}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.fixture(scope="module")
def gloo():
    return mesh_lib.spawn(gloo_rank, (2, 2), backend="gloo", device="cpu")


@pytest.mark.parametrize("what", ["loss", "grads", "logits",
                                  "prefill_caches", "decode",
                                  "decode_caches"])
@pytest.mark.parametrize("arch", list(ARCHS) + [ONE_EXPERT])
def test_sharded_moe_run_equals_unsharded(gloo, arch, what):
    """On every rank: rtol 1e-5, atol 1e-6 of each leaf's largest."""
    for rank in gloo:
        _close(rank[arch]["got"][what], rank[arch]["ref"][what], what)


@pytest.mark.parametrize("what", ["logits", "prefill_caches"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_moe_prefill_equals_unsharded_f32(gloo, arch, what):
    """The float32 smoke configs' prefill, at the same bar."""
    for rank in gloo:
        _close(rank[arch + "/f32"]["got"][what],
               rank[arch + "/f32"]["ref"][what], what)


@pytest.mark.parametrize("arch", [a + s for a in ARCHS for s in ("", "/f32")]
                         + [ONE_EXPERT, "capacity"])
def test_sharded_routing_is_exact(gloo, arch):
    """Every chunk's experts and every assignment's place in its expert's
    queue, in the loss, the gradients' recomputes, prefill and decode:
    equal, so the same assignments are kept and dropped."""
    C = moe.capacity(CAP_BATCH * CAP_SEQ, capacity_config().moe)
    for rank in gloo:
        want, got = rank[arch]["routes"]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if arch == "capacity":
            assert sum((w[1] >= C).sum() for w in want) > 0, \
                "the case drops nothing"


@pytest.mark.parametrize("what", ["loss", "grads", "logits"])
def test_capacity_case_equals_unsharded(gloo, what):
    """The capacity case (one chunk of 2,048 tokens, C = 512, drops) on
    every rank, at the same bar."""
    for rank in gloo:
        _close(rank["capacity"]["got"][what], rank["capacity"]["ref"][what],
               what)


@pytest.fixture(scope="module")
def fake_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield DeviceMesh("cuda", torch.arange(4).view(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_fake_moe_run_asks_for_the_real_runs_collectives(gloo, fake_mesh,
                                                         arch, monkeypatch):
    """The dry run's fake (2, 2) prefill of the same cell asks for the same
    collectives, kind by kind, as the real gloo run; the tokens travel by
    all-gathers and their partial sums come back by reduce-scatters; no
    all-gather reads a routed expert's weights (deepseek's lie two a
    rank, whole)."""
    monkeypatch.setattr(lm_common, "LM_SHAPES", {
        "prefill_32k": dict(seq=GLOO_SEQ, batch=GLOO_BATCH,
                            kind="prefill")})
    cfg = ARCHS[arch].smoke_config()
    with sharding.use_rules(fake_mesh):
        cell = lm_common.make_cell(arch, cfg, "prefill_32k")
        m = dryrun.measure(cell, fake_mesh)
        # The routed experts' weights at their use site, as the MoE pins
        # them: on deepseek's layout no collective at all.
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = cell.lower()[0]
        pins = dryrun.CollectiveLog(fake_mesh)
        with pins:
            for lp in params["layers"]:
                f = lp["ffn"]
                if "router" in f:
                    axes = moe.moe_axes(_moe_module(f, cfg))
                    for k in ("w_gate", "w_in", "w_out"):
                        sharding.pin_weight(f[k], *axes[k])
    real = gloo[0][arch + "/f32"]["counts"]
    fake = dict.fromkeys(real, 0)
    for kind, *_ in m["records"]:
        fake[kind] += 1
    assert fake == real
    assert all(r[arch + "/f32"]["counts"] == real for r in gloo)
    assert fake["all-gather"] > 0 and fake["reduce-scatter"] > 0
    if cfg.moe.shard_experts:
        assert pins.records == []
    else:
        assert len(pins.records) > 0       # granite's FSDP gathers


def _moe_module(f: dict, cfg):
    """An ``MoEFFN`` view of a layer's ffn tree, for its axes."""
    return moe.MoEFFN(f["router"], f["w_gate"], f["w_in"], f["w_out"],
                      shared=None, shard_experts=cfg.moe.shard_experts)

if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
