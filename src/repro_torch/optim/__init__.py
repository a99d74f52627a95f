"""Minimal optax-style optimizers over nested dicts of tensors.

An ``Optimizer`` is (init, update); ``update`` maps (grads, state, params)
-> (updates, state) where updates are ADDED to params. Provided:

  * ``sgd`` (momentum), ``adamw`` (decoupled weight decay, f32 master)
  * ``constant`` and ``cosine_warmup`` schedules
  * ``clip_by_global_norm`` gradient transform
  * ``masked`` -- freeze subsets of the tree (paper section 3.4's
    freeze-backbone indicator training)

The op order is the reference's (``repro.optim``); ``masked`` hands the
wrapped optimizer the trainable leaves only, so its clip norm covers only
them, as the reference's zeroed frozen gradients do. A tree is a tensor or
a dict of trees; leaves are visited in sorted key order, as JAX flattens
dicts. Everything is functional: new tensors, no in-place update. An
update runs leaf by leaf (the clip scale, the moments and the update of
one leaf together), so no clipped tree or frozen leaf's zero state is
ever held whole: at full width a tree is gigabytes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

Schedule = Callable[[Any], torch.Tensor]      # step -> lr


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *other_leaves)`` over a tree of dicts; ``path`` is
    the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,))
                for k in sorted(tree)}
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest):
    return tree_map_with_path(lambda _, *ls: fn(*ls), tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def path_str(path) -> str:
    """'body/0/wq/s_w'-style string from a key path."""
    return "/".join(str(k) for k in path)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_frac: float = 0.0) -> Schedule:
    def sched(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = end_frac + (1 - end_frac) * 0.5 * (
            1 + torch.cos(_f32(math.pi) * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)
    return sched


# ---------------------------------------------------------------------------
# global-norm clipping
# ---------------------------------------------------------------------------
def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
              for leaf in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda leaf: leaf * scale.to(leaf.dtype), tree), g


def _clipped(grads, max_norm: Optional[float]) -> Callable:
    """leaf -> the leaf as ``clip_by_global_norm`` would return it."""
    if max_norm is None:
        return lambda g: g
    scale = _clip_scale(global_norm(grads), max_norm)
    return lambda g: g * scale.to(g.dtype)


def _unzip(tree, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr, momentum: float = 0.9,
        clip_norm: Optional[float] = None) -> Optimizer:
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        dev = tree_leaves(params)[0].device
        return SGDState(torch.zeros((), dtype=torch.int32, device=dev),
                        tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        clip = _clipped(grads, clip_norm)
        lr_t = sched(state.step)

        def leaf(m, g):
            m = momentum * m + clip(g)
            return m, -lr_t.to(m.dtype) * m

        mom, updates = _unzip(tree_map(leaf, state.momentum, grads), 2)
        return updates, SGDState(state.step + 1, mom)

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = None,
          wd_mask: Optional[Callable] = None) -> Optimizer:
    """AdamW with decoupled weight decay. ``wd_mask(path, leaf) -> bool``
    selects which leaves decay (default: every leaf with ndim >= 2)."""
    sched = lr if callable(lr) else constant(lr)

    def init(params):
        dev = tree_leaves(params)[0].device
        zeros = lambda p: tree_map(                       # noqa: E731
            lambda leaf: torch.zeros(leaf.shape, dtype=torch.float32,
                                     device=leaf.device), p)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          zeros(params), zeros(params))

    def update(grads, state, params):
        clip = _clipped(grads, clip_norm)
        t = state.step + 1
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        lr_t = sched(state.step)

        def leaf(path, g, m_, v_, p):
            g = clip(g).to(torch.float32)
            m_ = b1 * m_ + (1 - b1) * g
            v_ = b2 * v_ + (1 - b2) * g * g
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            decay = wd_mask(path, p) if wd_mask is not None else p.dim() >= 2
            if weight_decay and decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return m_, v_, u.to(p.dtype)

        m, v, updates = _unzip(tree_map_with_path(
            leaf, grads, state.m, state.v, params), 3)
        return updates, AdamWState(t, m, v)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# masking / application
# ---------------------------------------------------------------------------
def indicator_only_mask(path, leaf) -> bool:
    """Trainable = the per-bit indicator banks (scale factors) only."""
    p = path_str(path)
    return p.endswith("s_w") or p.endswith("s_a")


def _select(tree, keep: Callable, path: tuple = ()):
    """The subtree of the leaves where ``keep(path, leaf)``, in the same
    key paths (None where nothing is kept)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            sub = _select(tree[k], keep, path + (k,))
            if sub is not None:
                out[k] = sub
        return out or None
    return tree if keep(path, tree) else None


def masked(opt: Optimizer, trainable: Callable) -> Optimizer:
    """The wrapped optimizer over the leaves where ``trainable(path,
    leaf)`` only (its state and its clip norm cover them alone, as the
    reference's zeroed gradients leave them); every other leaf's update is
    zero (a broadcast zero: a frozen backbone holds no state and no zero
    tree)."""

    def init(params):
        return opt.init(_select(params, trainable))

    def update(grads, state, params):
        sub, state = opt.update(_select(grads, trainable), state,
                                _select(params, trainable))

        def fill(path, g):
            if not trainable(path, g):
                return torch.zeros((), dtype=g.dtype,
                                   device=g.device).expand(g.shape)
            u = sub
            for k in path:
                u = u[k]
            return u

        return tree_map_with_path(fill, grads), state

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
