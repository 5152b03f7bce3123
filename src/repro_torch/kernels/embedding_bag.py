"""CUDA wrappers of ``csrc/embedding_bag.cu``: the weighted embedding bag
and its backward, and the custom ops that join them.

``embedding_bag`` is the counterpart of
``repro.kernels.embedding_bag.embedding_bag``. ``bag_op``
(``repro_torch::embedding_bag``) is the bag as a PyTorch operator, and
``bag_backward_op`` (``repro_torch::embedding_bag_backward``) its
gradients; the forward's autograd is the backward op. For CUDA tensors
they launch the hand-written kernels: the forward, and the backward
kernel (the table's dense gradient: the live slots grouped by id with a
stable radix sort, then each touched row summed in slot order and written
once, bit-equal to the reference's; and the weights' gradient when asked
for). For CPU tensors they run the plain versions
(``kernels.ref.embedding_bag``, ``kernels.ref.embedding_bag_backward``);
under ``FakeTensorMode`` or on the meta device they give the output shapes
only, without building or loading the library and without counting a
launch. The reference has no VJP for its Pallas kernel and differentiates
its plain version instead. A table split by rows over a mesh runs the op
on each rank's rows (``models.recsys``), so the ops have no DTensor rule;
their FLOP formulas count 2·B·S·D a pass. ``embedding_bag`` and
``embedding_bag_backward`` take CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._checks import check, check_cuda
from repro_torch.kernels.ref import BAG_BINS, BAG_TILE

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _fn():
    fn = _build.load("embedding_bag").embedding_bag
    fn.argtypes = [_P, _P, _P, _P, _LL, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("embedding_bag").embedding_bag_backward
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _P, _LL, _P]
    fn.restype = ctypes.c_int
    return fn


# The table gradient's slot indices are int32 (csrc/embedding_bag.cu).
MAX_SLOTS = 2**31 - 1


def bwd_scratch_bytes(n: int) -> int:
    """Scratch of the table gradient for n = B * S slots, as the C entry
    point's ``embedding_bag_backward_scratch_bytes`` counts it: two key and
    slot buffers, the sorted weights, two (digit, tile) count buffers, the
    digits' totals and the live count, 32 bits each."""
    return 4 * (5 * n + 2 * BAG_BINS * (-(-n // BAG_TILE)) + BAG_BINS + 1)


def check_args(table, ids, weights):
    """Dtype, shape, alignment and sizes the kernel takes → (B, S, D)."""
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError("table and ids must be (V, D) and (B, S)")
    v, d = table.shape
    b, s = ids.shape
    check("table", table, torch.float32, (v, d))
    check("ids", ids, torch.int32, (b, s))
    check("weights", weights, torch.float32, (b, s))
    if d % 4 or table.data_ptr() % 16:
        raise ValueError("the kernel reads 16-byte vectors: D must be a "
                         "multiple of 4 and the table 16-byte aligned")
    return b, s, d


def _forward(table, ids, weights) -> torch.Tensor:
    b, s, d = check_args(table, ids, weights)
    check_cuda(table, ids, weights)
    fn = _fn()
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
             out.data_ptr(), b, s, d, stream)
    if err:
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err}")
    embedding_bag.launches += 1
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(V, D) f32, (B, S) i32, (B, S) f32 → (B, D) f32, on the card
    (CUDA tensors only): ``bag_op``, differentiable in ``table`` and
    ``weights`` through the backward kernel."""
    check_cuda(table, ids, weights)
    return bag_op(table, ids, weights)


embedding_bag.launches = 0


def embedding_bag_backward(dout: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor, table: torch.Tensor, *,
                           table_grad: bool = True,
                           weights_grad: bool = False,
                           out: torch.Tensor | None = None):
    """The bag's gradients from ``dout`` (B, D) f32, on the card:
    (dtable (V, D) or None, dweights (B, S) or None). ``table`` gives V
    and D, and is read for ``dweights`` only. The kernel writes each
    touched row of ``dtable`` once (each row the sum of its slots' products
    in slot order, from 0) and leaves every other row as it is, so ``out``
    (a (V, D) f32, 16-byte aligned) must hold zeros where given; without
    it a new ``torch.zeros`` buffer is filled, outside the kernel. The
    sort's scratch is a ``torch.empty`` buffer of ``bwd_scratch_bytes``."""
    b, s, d = check_args(table, ids, weights)
    check("dout", dout, torch.float32, (b, d))
    if dout.data_ptr() % 16:
        raise ValueError("dout must be 16-byte aligned")
    if table_grad and b * s > MAX_SLOTS:
        raise ValueError(f"B * S = {b * s} slots: the table gradient's "
                         f"slot index is int32 (at most {MAX_SLOTS})")
    if table_grad and out is not None:
        check("out", out, torch.float32, tuple(table.shape))
        if out.data_ptr() % 16:
            raise ValueError("out must be 16-byte aligned")
    check_cuda(dout, ids, weights, table,
               *(() if out is None or not table_grad else (out,)))
    dtable = dweights = scratch = None
    if table_grad:
        dtable = out if out is not None else torch.zeros(
            table.shape, dtype=torch.float32, device=table.device)
        scratch = torch.empty(bwd_scratch_bytes(b * s), dtype=torch.uint8,
                              device=table.device)
    if weights_grad:
        dweights = torch.empty((b, s), dtype=torch.float32,
                               device=table.device)
    if dtable is None and dweights is None:
        return None, None
    fn = _bwd_fn()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(dout.data_ptr(), ids.data_ptr(), weights.data_ptr(),
             table.data_ptr(), None if dtable is None else dtable.data_ptr(),
             None if dweights is None else dweights.data_ptr(), b, s, d,
             table.shape[0], None if scratch is None else scratch.data_ptr(),
             0 if scratch is None else scratch.numel(), stream)
    if err:
        raise RuntimeError(f"embedding_bag_backward launch failed: CUDA "
                           f"error {err}")
    embedding_bag_backward.launches += 1
    return dtable, dweights


embedding_bag_backward.launches = 0


@torch.library.custom_op("repro_torch::embedding_bag", mutates_args=(),
                         device_types="cpu")
def bag_op(table: torch.Tensor, ids: torch.Tensor,
           weights: torch.Tensor) -> torch.Tensor:
    """(V, D) f32, (B, S) i32, (B, S) f32 → (B, D) f32; CPU tensors: the
    plain version."""
    return _ref.embedding_bag(table, ids, weights)


@bag_op.register_kernel("cuda")
def _bag_cuda(table, ids, weights):
    return _forward(table, ids, weights)


@bag_op.register_fake
def _bag_fake(table, ids, weights):
    return table.new_empty((ids.shape[0], table.shape[1]))


@torch.library.custom_op("repro_torch::embedding_bag_backward",
                         mutates_args=(), device_types="cpu")
def bag_backward_op(dout: torch.Tensor, ids: torch.Tensor,
                    weights: torch.Tensor, table: torch.Tensor,
                    table_grad: bool,
                    weights_grad: bool) -> list[torch.Tensor]:
    """The gradients asked for, in this order: dtable (V, D) where
    ``table_grad``, dweights (B, S) where ``weights_grad``; CPU tensors:
    the plain version."""
    grads = _ref.embedding_bag_backward(dout, ids, weights, table,
                                        table_grad=table_grad,
                                        weights_grad=weights_grad)
    return [g for g in grads if g is not None]


@bag_backward_op.register_kernel("cuda")
def _bag_backward_cuda(dout, ids, weights, table, table_grad, weights_grad):
    if dout.data_ptr() % 16:
        dout = dout.clone()
    grads = embedding_bag_backward(dout, ids, weights, table,
                                   table_grad=table_grad,
                                   weights_grad=weights_grad)
    return [g for g in grads if g is not None]


@bag_backward_op.register_fake
def _bag_backward_fake(dout, ids, weights, table, table_grad, weights_grad):
    return ([table.new_empty(table.shape)] if table_grad else []) + (
        [weights.new_empty(weights.shape)] if weights_grad else [])


def _bag_setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _bag_backward(ctx, dout):
    table, ids, weights = ctx.saved_tensors
    table_grad, weights_grad = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
    if not (table_grad or weights_grad):
        return None, None, None
    grads = iter(bag_backward_op(dout.contiguous(), ids, weights, table,
                                 table_grad, weights_grad))
    return (next(grads) if table_grad else None, None,
            next(grads) if weights_grad else None)


bag_op.register_autograd(_bag_backward, setup_context=_bag_setup_context)


@register_flop_formula(torch.ops.repro_torch.embedding_bag)
def _bag_flops(table_shape, ids_shape, weights_shape, out_shape=None,
               **kwargs) -> int:
    """2·B·S·D: a multiply and an add a slot and dimension."""
    b, s = ids_shape
    return 2 * b * s * table_shape[1]


@register_flop_formula(torch.ops.repro_torch.embedding_bag_backward)
def _bag_backward_flops(dout_shape, ids_shape, weights_shape, table_shape,
                        table_grad, weights_grad, out_shape=None,
                        **kwargs) -> int:
    """2·B·S·D for the table's gradient (a weighted row a slot added into
    its id's row) and as much again for the weights' (a dot product a
    slot)."""
    b, s = ids_shape
    return 2 * b * s * table_shape[1] * (int(table_grad) + int(weights_grad))
