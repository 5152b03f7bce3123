"""CUDA wrapper of ``csrc/rank_join.cu``: the batched rank-join probe, and
the custom op around it.

Counterpart of ``repro.kernels.rank_join.rank_join_lookup``; the plain
version is ``kernels.ref.rank_join_lookup``. ``rank_join_lookup`` takes
CUDA tensors only. ``lookup_op`` (``repro_torch::rank_join_lookup``) is
the probe as a PyTorch operator, which ``kernels.ops`` calls on any
device: this kernel for CUDA tensors, the plain version for CPU ones, the
output shapes only under ``FakeTensorMode`` or on the meta device (the
dry run's fake shards), without building or loading the library and
without counting a launch. It runs only on a rank's local shards (the
KG engine's body), so it has no DTensor rule; its work is compares, not
float arithmetic, so it has no FLOP formula (the dry run's ``LocalCost``
still counts its bytes).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._checks import check, check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
# Blocks per group (one thread block cluster), each streaming a chunk of the
# live ring; ``kernels.ref.rank_join_lookup_split`` models the same split.
CHUNKS = 8
# The probe table, its filter and the chunks' sums take 84 bytes a probe of
# shared memory beside 17 KB of slot queue and filter (189 KB here).
MAX_PROBES = 2048


def _fn():
    fn = _build.load("rank_join").rank_join_lookup
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def check_args(seen_keys, seen_scores, probe_keys, seen_cnt):
    """Dtype, shape and contiguity the kernel takes → (G, N, B)."""
    if seen_keys.dim() != 2 or probe_keys.dim() != 2:
        raise ValueError("seen_keys and probe_keys must be (G, N) and (G, B)")
    G, N = seen_keys.shape
    B = probe_keys.shape[1]
    check("seen_keys", seen_keys, torch.int32, (G, N))
    check("seen_scores", seen_scores, torch.float32, (G, N))
    check("probe_keys", probe_keys, torch.int32, (G, B))
    check("seen_cnt", seen_cnt, torch.int32, (G,))
    if not 0 < G <= 65535:
        raise ValueError(f"G = {G} groups must be in [1, 65535]")
    if B > MAX_PROBES:
        raise ValueError(f"B = {B} probes exceed the kernel's "
                         f"{MAX_PROBES}-entry shared-memory table")
    return G, N, B


def rank_join_lookup(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
                     probe_keys: torch.Tensor, seen_cnt: torch.Tensor):
    """(G, N) i32, (G, N) f32, (G, B) i32, (G,) i32 →
    (scores (G, B) f32, found (G, B) bool), on the card."""
    G, N, B = check_args(seen_keys, seen_scores, probe_keys, seen_cnt)
    check_cuda(seen_keys, seen_scores, probe_keys, seen_cnt)
    fn = _fn()
    scores = torch.empty((G, B), dtype=torch.float32, device=seen_keys.device)
    found = torch.empty((G, B), dtype=torch.bool, device=seen_keys.device)
    stream = torch.cuda.current_stream(seen_keys.device).cuda_stream
    err = fn(seen_keys.data_ptr(), seen_scores.data_ptr(),
             probe_keys.data_ptr(), seen_cnt.data_ptr(), scores.data_ptr(),
             found.data_ptr(), G, N, B, stream)
    if err:
        raise RuntimeError(f"rank_join_lookup launch failed: CUDA error {err}")
    rank_join_lookup.launches += 1
    return scores, found


rank_join_lookup.launches = 0


@torch.library.custom_op("repro_torch::rank_join_lookup", mutates_args=(),
                         device_types="cpu")
def lookup_op(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
              probe_keys: torch.Tensor,
              seen_cnt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, N) i32, (G, N) f32, (G, B) i32, (G,) i32 → (scores (G, B) f32,
    found (G, B) bool); CPU tensors: the plain version."""
    return _ref.rank_join_lookup(seen_keys, seen_scores, probe_keys,
                                 seen_cnt)


@lookup_op.register_kernel("cuda")
def _lookup_cuda(seen_keys, seen_scores, probe_keys, seen_cnt):
    return rank_join_lookup(seen_keys, seen_scores, probe_keys, seen_cnt)


@lookup_op.register_fake
def _lookup_fake(seen_keys, seen_scores, probe_keys, seen_cnt):
    return (probe_keys.new_empty(probe_keys.shape, dtype=torch.float32),
            probe_keys.new_empty(probe_keys.shape, dtype=torch.bool))
