"""CUDA wrappers of ``csrc/flash_attention.cu`` (the attention forward) and
``csrc/flash_attention_bwd.cu`` (its backward), and the custom ops that
join them.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the plain
versions are ``kernels.ref.flash_attention``, ``flash_attention_fwd_stats``
and ``flash_attention_bwd``, and ``kernels.ops`` chooses between them by
device. These wrappers take bf16 CUDA tensors of head_dim 64, 128, 192 or
256 only (192 is MLA's q·k width, with v padded to it). The inputs may be
strided views, e.g. the model's (B, S, H, D) activations seen as (B, H, S,
D): the kernels read them through their strides, and each output keeps its
input's stride order.

``attention`` goes through the custom op ``repro_torch::flash_attention``
(below): the forward kernel with its lse output for CUDA tensors,
differentiable through the custom op
``repro_torch::flash_attention_backward``, the backward kernel; the plain
twins for CPU tensors; shapes only on the meta device or under
``FakeTensorMode``; and a DTensor sharding rule, so that a sharded model
runs the kernel on each rank's shard. ``flash_attention`` is the same on
CUDA tensors and raises on others. ``flash_attention.launches`` counts
forward launches, ``flash_attention_backward.launches`` backward calls
(each three kernels: the stat pass, dK/dV, dQ).
"""
from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.distributed as dist
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._checks import check_cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
HEAD_DIMS = (64, 128, 192, 256)
# Keys per tile by head_dim and query rows per consumer warpgroup, as
# csrc/flash_attention.cu sets them (Tile<D>, WG_ROWS): the tests and
# chip_smoke.py place their edge cases with them.
TILE_N = {64: 128, 128: 128, 192: 112, 256: 80}
WARPGROUP_ROWS = 64
# csrc/flash_attention_bwd.cu's tiles: keys a dK/dV block by head_dim
# (KvTile<D>::BN), and the q rows and keys of the 64 x 64 tile that each
# consumer warpgroup masks and multiplies (BM) in both passes.
BWD_TILE = {64: 128, 128: 128, 192: 64, 256: 64}
# The dK/dV pass's columns by consumer warpgroup, (first column, count):
# whole 64-column chunks, split where one consumer cannot hold 64 keys x D
# of both dK and dV (dkdv_consumer's c0 and DN).
BWD_COLUMNS = {64: ((0, 64),), 128: ((0, 128),),
               192: ((0, 128), (128, 64)), 256: ((0, 128), (128, 128))}
BWD_ROWS = 64
# q rows of a dQ block (QROWS); the stat scratch is padded to a multiple.
BWD_QROWS = 128


def _fn():
    fn = _build.load("flash_attention").flash_attention_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                   _I, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_bf16
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_P, _F, _I, _I, _F, _P]
    fn.restype = ctypes.c_int
    return fn


def _layout_ok(t: torch.Tensor) -> bool:
    """TMA's and the kernels' rules: a contiguous last axis, the other
    strides multiples of 8, a 16-byte aligned start."""
    return (t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def check_args(q, k, v):
    """Dtype, shapes, strides and alignment the kernel takes →
    (B, Hq, Hkv, Sq, Sk, D)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Hkv, Sk, D) = "
                         f"{(B, Hkv, Sk, D)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
        if not _layout_ok(t):
            raise ValueError(f"{name} must have a contiguous last axis, "
                             "strides that are multiples of 8 and a 16-byte "
                             "aligned start")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError("B and Hq must be at most 65535")
    return B, Hq, Hkv, Sq, Sk, D


def _scale(scale, D):
    return D ** -0.5 if scale is None else scale


def flash_attention_fwd_stats(q, k, v, *, causal: bool = True, window=None,
                              softcap=None, scale=None, stats: bool = True):
    """The forward kernel → (o (B, Hq, Sq, D) bf16, lse (B, Hq, Sq) f32 or
    None). o is the same with lse asked for or not."""
    B, Hq, Hkv, Sq, Sk, D = check_args(q, k, v)
    check_cuda(q, k, v)
    fn = _fn()
    out = torch.empty_like(q)      # q's stride order, or contiguous
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if stats else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D,
             strides, _scale(scale, D), int(causal), int(window or 0),
             float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window=None, softcap=None, scale=None):
    """The backward kernel → (dq, dk, dv) bf16 in q's, k's and v's stride
    order, from the forward's o and lse and the gradient do of o."""
    B, Hq, Hkv, Sq, Sk, D = check_args(q, k, v)
    check_cuda(q, k, v, o, lse, do)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != torch.bfloat16 or t.shape != q.shape:
            raise ValueError(f"{name} must be bfloat16 of q's shape "
                             f"{tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, Hq, Sq)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 {(B, Hq, Sq)}")
    # o comes from the forward kernel; do is whatever autograd hands back.
    if not _layout_ok(o):
        raise ValueError("o must have the forward kernel's layout")
    if not _layout_ok(do):
        do = do.contiguous()
    fn = _bwd_fn()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # Each row's lse * log2 e and delta, rows padded to the dQ block.
    sqp = -(-Sq // BWD_QROWS) * BWD_QROWS
    stat = torch.empty((B, Hq, 2, sqp), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, dq, dk,
                                                     dv)
                                         for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), stat.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Sq, Sk, D, strides,
             _scale(scale, D), int(causal), int(window or 0),
             float(softcap or 0.0), stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


# ---------------------------------------------------------- the custom op
#
# ``repro_torch::flash_attention`` (q, k, v, causal, window, softcap, scale)
# → (o, lse) and ``repro_torch::flash_attention_backward`` (q, k, v, o, lse,
# do, ...) → (dq, dk, dv) are the attention as PyTorch operators: the CUDA
# kernels above for CUDA tensors, their plain twins (``kernels.ref``) for
# CPU ones, shapes only under ``FakeTensorMode`` or on the meta device (the
# fake impls never build or load the library, and count no launch). The
# forward's autograd is the backward op, from the forward's o and lse, as
# the reference's ``_flash`` custom VJP. Each has a FLOP formula (what
# PERF.md's bounds count, ``pair_flops``) and a DTensor sharding rule, so
# that a sharded program (``repro_torch.sharding``) runs the kernel on each
# rank's shard: batch and head shards stay local, anything else is
# redistributed to such a layout first.

# Flops a visible (query, key) pair and head costs: 4·D forward, 10·D
# backward; at D = 192 (MLA's q·k, v padded from 128 to it) the work MLA
# needs, 2·(192 + 128) and 2·(3·192 + 2·128), so the count does not grow
# with the padding.
MLA_PAIR_FLOPS = {192: (640, 1664)}


def pair_flops(D: int, backward: bool = False) -> int:
    fwd, bwd = MLA_PAIR_FLOPS.get(D, (4 * D, 10 * D))
    return bwd if backward else fwd


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of one (batch, head): query i sits at key
    position Sk − Sq + i; causal keys at or before it; with ``window`` W
    the keys in (pos − W, pos]."""
    off = Sk - Sq
    if not causal:
        if not window:
            return Sq * Sk
        return sum(Sk - max(0, min(Sk, off + i - window + 1))
                   for i in range(Sq))
    W = window or max(Sk, 1)

    def upto(x):                 # Σ over positions p in [0, x) of min(p+1, W)
        x = max(x, 0)
        return x * (x + 1) // 2 if x <= W else W * (W + 1) // 2 + (x - W) * W

    return upto(off + Sq) - upto(off)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, softcap: float,
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward → (o, lse); CPU tensors: the plain twin, o laid out in
    q's stride order as the kernel writes it (and the fake impl says)."""
    o, lse = _ref.flash_attention_fwd_stats(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            scale=scale)
    return _like(q, o), lse


def _like(t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` in a new tensor of ``t``'s stride order."""
    return torch.empty_like(t, dtype=values.dtype).copy_(values)


@attention_op.register_kernel("cuda")
def _attention_cuda(q, k, v, causal, window, softcap, scale):
    return flash_attention_fwd_stats(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)


@attention_op.register_fake
def _attention_fake(q, k, v, causal, window, softcap, scale):
    B, Hq, Sq, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, Hq, Sq), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=(), device_types="cpu")
def attention_backward_op(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool, window: int,
        softcap: float, scale: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward → (dq, dk, dv); CPU tensors: the plain twin, each in
    its input's stride order as the kernel writes them."""
    grads = _ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window, softcap=softcap,
                                     scale=scale)
    return tuple(_like(t, g) for t, g in zip((q, k, v), grads))


@attention_backward_op.register_kernel("cuda")
def _attention_backward_cuda(q, k, v, o, lse, do, causal, window, softcap,
                             scale):
    return flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                    window=window, softcap=softcap,
                                    scale=scale)


@attention_backward_op.register_fake
def _attention_backward_fake(q, k, v, o, lse, do, causal, window, softcap,
                             scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, softcap, scale = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, window, softcap, scale)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = attention_backward_op(q, k, v, o, lse, do, *ctx.args)
    return dq, dk, dv, None, None, None, None


attention_op.register_autograd(_backward, setup_context=_setup_context)


def _attention_flops(q_shape, k_shape, _v_shape, causal, window, *_args,
                     backward=False):
    B, Hq, Sq, D = q_shape
    return (B * Hq * visible_pairs(Sq, k_shape[2], causal, window)
            * pair_flops(D, backward))


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _attention_op_flops(q_shape, k_shape, v_shape, causal, window, softcap,
                        scale, out_shape=None, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape, v_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _attention_backward_op_flops(q_shape, k_shape, v_shape, _o, _lse, _do,
                                 causal, window, softcap, scale,
                                 out_shape=None, **kwargs) -> int:
    return _attention_flops(q_shape, k_shape, v_shape, causal, window,
                            backward=True)


def _heads_split_evenly(mesh, Hq: int, Hkv: int) -> bool:
    """Whether every count of head shards the mesh can make (a product of
    its dimensions) that Hkv can take divides both head counts, so that
    each rank's q heads are those of its own kv heads."""
    sizes = list(mesh.shape)
    for r in range(1, len(sizes) + 1):
        for dims in itertools.combinations(sizes, r):
            n = math.prod(dims)
            if n <= Hkv and (Hkv % n or Hq % n):
                return False
    return True


def _attention_layouts(q, k, n_in: int, n_out: int, n_rest: int):
    """One mesh dimension's layouts of the attention ops: all replicated,
    all split by batch, and all split by head where the heads split evenly
    (q, k, v, o, do (B, H, S, D) and lse (B, H, S) alike). A sequence
    shard, or q's heads split where k's cannot be, is redistributed to one
    of these first."""
    from torch.distributed.tensor import Replicate, Shard
    layouts = [Replicate(), Shard(0)]
    if _heads_split_evenly(q.mesh, q.shape[1], k.shape[1]):
        layouts.append(Shard(1))
    return [([p] * n_out, [p] * n_in + [None] * n_rest) for p in layouts]


def _register_sharding():
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _forward_rule(q, k, v, causal, window, softcap, scale):
        return _attention_layouts(q, k, 3, 2, 4)

    @register_sharding(torch.ops.repro_torch.flash_attention_backward.default)
    def _backward_rule(q, k, v, o, lse, do, causal, window, softcap, scale):
        return _attention_layouts(q, k, 6, 3, 4)


if dist.is_available():
    _register_sharding()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) → o (B, Hq, Sq, D), through
    ``repro_torch::flash_attention`` on any device: the kernel for bf16
    CUDA tensors, the plain twin for CPU ones, the shapes for meta or fake
    ones, the DTensor rule for sharded ones; differentiable through the
    backward op."""
    return attention_op(q, k, v, causal, int(window or 0),
                        float(softcap or 0.0), _scale(scale, q.shape[-1]))[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """``attention`` on the card: CUDA tensors only, or raise; bf16 of
    the head_dims the kernel takes."""
    check_cuda(q, k, v)
    return attention(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale)


flash_attention.launches = 0
flash_attention_backward.launches = 0
