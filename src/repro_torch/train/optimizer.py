"""AdamW with global-norm clipping and low-precision moments (counterpart
of ``repro.train.optimizer``).

The reference's formula, not ``torch.optim.AdamW``: linear warmup from
step 1, a clip scale of ``min(1, clip / max(‖g‖, 1e-9))``, bias
corrections ``1 − b^step`` in float32, weight decay added to the step, and
moments stored in ``moment_dtype`` with the maths in float32.

The reference's ``apply_updates`` is pure; this one updates parameters and
moments in place under ``torch.no_grad()``, ``CHUNK`` elements of a leaf
at a time, so a (10 M, 256) table needs no full-size float32 temporaries
(each would take 10 GB). Every element goes through the same operations
in the same order whatever the chunking. The global norm sums the leaves
in JAX's flatten order (``train.tree``), a leaf's square sums chunk by
chunk.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train import tree

# Elements of a leaf updated (or squared and summed) at a time: 2**26
# float32 temporaries are 256 MiB each.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100


def _zeros_like_tree(params, dtype):
    return tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)


def _step0(params) -> torch.Tensor:
    leaves = tree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return torch.zeros((), dtype=torch.int32, device=dev)


def init_opt_state(params):
    return {"m": _zeros_like_tree(params, torch.float32),
            "v": _zeros_like_tree(params, torch.float32),
            "step": _step0(params)}


def init_opt_state_lowp(params, cfg: AdamWConfig):
    dt = getattr(torch, cfg.moment_dtype)
    return {"m": _zeros_like_tree(params, dt),
            "v": _zeros_like_tree(params, dt),
            "step": _step0(params)}


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        yield flat[lo:lo + CHUNK]


@torch.no_grad()
def global_norm(tree_) -> torch.Tensor:
    """√(Σ over the leaves, in JAX's order, of Σ x²) in float32; a 0-d
    tensor on the leaves' device."""
    total = None
    for leaf in tree.leaves(tree_):
        for c in _chunks(leaf.detach().contiguous()):
            s = torch.sum(torch.square(c.float()))
            total = s if total is None else total + s
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return warm * cfg.lr


def _update_chunk(p, g, m, v, scale, lr, bc1, bc2, cfg: AdamWConfig):
    """One chunk of the reference's ``upd``, in place on p, m and v."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    m32 = m.float() * b1
    t = g * (1 - b1)
    m32 += t
    torch.mul(g, 1 - b2, out=t)
    t *= g
    v32 = v.float() * b2
    v32 += t
    del g, t
    m.copy_(m32)
    v.copy_(v32)
    m32 /= bc1                       # mhat
    v32 /= bc2                       # vhat
    v32.sqrt_().add_(cfg.eps)
    delta = m32.div_(v32)
    del v32
    if cfg.weight_decay:
        delta += p.float() * cfg.weight_decay
    delta *= lr
    if p.dtype == torch.float32:
        p -= delta
    else:
        p.copy_(p.float() - delta)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step, in place. Returns (params, opt_state, metrics): the
    same trees, updated, and ``{"grad_norm", "lr"}`` as 0-d tensors."""
    step = opt_state["step"]
    step += 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0 else 1.0)
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                          tree.leaves(opt_state["m"]),
                          tree.leaves(opt_state["v"])):
        for pc, gc, mc, vc in zip(_chunks(p.detach()),
                                  _chunks(g.contiguous()), _chunks(m),
                                  _chunks(v)):
            _update_chunk(pc, gc, mc, vc, scale, lr, bc1, bc2, cfg)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
