"""Per-layer kernel dispatch for packed mixed-precision matmuls and for
decode attention over the int8 KV cache.

A ``PackedLinear`` carries its searched bit-widths, so every call site
resolves which execution route serves it:

* ``cuda-w4``    -- int4 weights in the ``nib4`` layout feed the
  ``quant_matmul_w4`` CUDA kernel directly: the packed bytes are the kernel
  operand and the nibbles unpack in its load path.
* ``cuda-int8``  -- any searched width <= 8 lands on a subset of the int8
  grid: codes unpack on every call (the packed bytes are what device memory
  holds), activations quantize on the fly, and the ``quant_matmul`` CUDA
  kernel runs int8 x int8 -> int32.
* ``dequant-fp`` -- dequantize the codes and run the same fp einsum as the
  fake-quant graph, bit for bit; what CPU tensors and layers the kernels
  cannot take run.

Resolution follows the tensors: on a CUDA device a kernel-eligible layer
takes its kernel route (and a kernel that cannot launch raises); on the CPU
everything takes ``dequant-fp``. ``force_route`` pins a route for tests.
Decode attention resolves the same way between ``fused`` (the
``decode_attn_quant`` kernel on the codes) and ``dequant-fp``.

``Counts`` records which route each call took, per op; the engine reads it
to show that no kernel-eligible layer fell through to ``dequant-fp``. After
each fenced prefill and step the engine publishes what its session's
``Counts`` gained into its metrics registry (``publish_routes``:
``dispatch.route.<route>`` per matmul, ``dispatch.decode_attn.<route>``
per attention call) and attributes the measured time to the
``dominant_route``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.quantizer import fake_quant, lsq_grad_scale_factor
from repro_torch.models.quant_layers import einsum_rows
from repro_torch.runtime.packing import PackedLinear


# ---------------------------------------------------------------------------
# route table -- one registry + one force mechanism for every routed op
# ---------------------------------------------------------------------------
class RouteTable:
    """Per-op route registry; ``force_route(op, name)`` pins one for a scope
    (scopes nest; ``None`` restores resolution by device)."""

    def __init__(self, ops: Dict[str, tuple]):
        self.ops = {op: tuple(routes) for op, routes in ops.items()}
        self._forced: Dict[str, List[Optional[str]]] = {
            op: [None] for op in self.ops}

    def routes(self, op: str) -> tuple:
        if op not in self.ops:
            raise ValueError(f"unknown routed op {op!r}: {tuple(self.ops)}")
        return self.ops[op]

    def validate(self, op: str, name: str) -> str:
        routes = self.routes(op)
        if name not in routes:
            raise ValueError(f"unknown {op} route {name!r}: {routes}")
        return name

    def forced(self, op: str) -> Optional[str]:
        return self._forced[op][-1]

    @contextlib.contextmanager
    def force_route(self, op: str, name: Optional[str]):
        """Pin op ``op`` to route ``name`` for the scope (None = auto)."""
        if name is not None:
            self.validate(op, name)
        stack = self._forced[op]
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()


ROUTES = RouteTable({
    "matmul": ("dequant-fp", "cuda-int8", "cuda-w4"),
    "decode_attn": ("fused", "dequant-fp"),
    "kv_layout": ("ring", "paged"),
    # how decode tokens are produced: plain target decode, or
    # self-speculative (the low-bit draft pack proposes, the searched
    # target verifies: launch/engine._spec_round)
    "spec": ("off", "self"),
    # which policy serves: one policy per process, or a bank of pre-packed
    # variants whose active member the admission-time ILP re-solve swaps
    # between batches (launch/elastic.py)
    "elastic": ("off", "bank"),
})


def force_route(op: str, name: Optional[str]):
    return ROUTES.force_route(op, name)


@dataclasses.dataclass
class Counts:
    """Route tallies of one forward scope: ``routes[op][route]`` calls, and
    ``eligible_fp`` -- kernel-eligible matmuls that ran ``dequant-fp``."""
    routes: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {"matmul": {}, "decode_attn": {}})
    eligible_fp: int = 0

    def add(self, op: str, route: str) -> None:
        d = self.routes[op]
        d[route] = d.get(route, 0) + 1


_COUNTS: List[Optional[Counts]] = [None]
# registry counter family of each routed op
_FAMILY = {"matmul": "route", "decode_attn": "decode_attn"}


@contextlib.contextmanager
def counts_scope(counts: Optional[Counts]):
    """Tally the routes taken inside the scope into ``counts`` (None: off)."""
    _COUNTS.append(counts)
    try:
        yield counts
    finally:
        _COUNTS.pop()


def _count(op: str, route: str) -> None:
    if _COUNTS[-1] is not None:
        _COUNTS[-1].add(op, route)


def publish_routes(registry, counts: Counts,
                   seen: Dict[str, Dict[str, int]]) -> None:
    """Add what ``counts`` tallied since ``seen`` (a copy of its earlier
    ``routes``, brought up to date here) to ``registry``'s
    ``dispatch.<family>.<route>`` counters."""
    for op, routes in counts.routes.items():
        done = seen.setdefault(op, {})
        for route, n in routes.items():
            if n > done.get(route, 0):
                registry.counter(f"dispatch.{_FAMILY[op]}.{route}").inc(
                    n - done.get(route, 0))
                done[route] = n


def dominant_route(registry, family: str = "route") -> str:
    """Most-counted ``dispatch.<family>.*`` route in a registry ("fp" when
    nothing was counted): the route the engine attributes its measured
    phase latencies to (``obs.health.attribute_latency``)."""
    prefix = f"dispatch.{family}."
    best, best_count = "fp", 0.0
    for name in getattr(registry, "_metrics", {}):
        if name.startswith(prefix):
            v = registry.value(name)
            if v > best_count:
                best, best_count = name[len(prefix):], v
    return best


# ---------------------------------------------------------------------------
# decode-attention routing (int8 KV cache)
# ---------------------------------------------------------------------------
def decode_attn_route(device: torch.device) -> str:
    """The decode-attention route for ``device``: forced, else ``fused`` on
    a CUDA device and ``dequant-fp`` on the CPU."""
    route = ROUTES.forced("decode_attn")
    if route is None:
        route = "fused" if device.type == "cuda" else "dequant-fp"
    return route


def resolve_decode_attn(device: torch.device) -> str:
    """``decode_attn_route``, counted as one attention call's route."""
    route = decode_attn_route(device)
    _count("decode_attn", route)
    return route


# ---------------------------------------------------------------------------
# activation-code reuse (one quantize per site for wq/wk/wv-style fans)
# ---------------------------------------------------------------------------
_SCOPE: List[Optional[dict]] = [None]


@contextlib.contextmanager
def act_reuse_scope():
    """Memoize quantized activations for the duration of one forward.

    Projections that consume the same hidden state with bit-identical
    quantization parameters (wq/wk/wv, wi/wg) share a ``PackedLinear
    .a_group`` tag; inside this scope ``act_fake_quant``/``act_codes`` cache
    by ``(input identity, a_group)``, so a hit returns exactly the tensor the
    miss computed. Yields a dict whose ``"hits"`` counts elided quantizes.
    """
    scope = {"cache": {}, "hits": 0}
    _SCOPE.append(scope)
    try:
        yield scope
    finally:
        _SCOPE.pop()


def _reuse_lookup(x: torch.Tensor, pl: PackedLinear, tag: str):
    """(cache_key, hit_or_None). The cached entry keeps a reference to the
    input so a recycled id() can never alias."""
    scope = _SCOPE[-1]
    if scope is None or not pl.a_group:
        return None, None
    key = (id(x), pl.a_group, tag)
    entry = scope["cache"].get(key)
    if entry is not None and entry[0] is x:
        scope["hits"] += 1
        return key, entry[1]
    return key, None


def _reuse_store(key, x: torch.Tensor, value):
    if key is not None:
        _SCOPE[-1]["cache"][key] = (x, value)


# ---------------------------------------------------------------------------
# activation quantization
# ---------------------------------------------------------------------------
def _act_scale(x: torch.Tensor, pl: PackedLinear) -> torch.Tensor:
    """The bank scale aligned to the activation: a per-expert ``(E,)``
    scale in the trailing-ones form ``(E, 1, ..., 1)``, exactly
    ``fake_quant_indexed``'s reshape."""
    s = pl.s_a
    if s.dim():
        s = s.reshape(tuple(s.shape) + (1,) * (x.dim() - s.dim()))
    return s


def act_fake_quant(x: torch.Tensor, pl: PackedLinear, ctx) -> torch.Tensor:
    """LSQ fake-quant of activations at the layer's searched a_bits with the
    trained bank scale -- the training graph's op chain (scale floor, LSQ
    grad-scale wrapper, clip bounds, per-expert broadcast), for bitwise
    parity."""
    if not (ctx.enabled and ctx.quantize_acts):
        return x
    key, hit = _reuse_lookup(x, pl, "fake")
    if hit is not None:
        return hit
    qmin, qmax = pl.a_range
    g = lsq_grad_scale_factor(x.numel(), qmax, device=x.device)
    out = fake_quant(x, _act_scale(x, pl), qmin, qmax, grad_scale_factor=g)
    _reuse_store(key, x, out)
    return out


def act_codes(x: torch.Tensor, pl: PackedLinear, ctx):
    """Integer activation codes + scale for the kernel routes: the scale
    floor only, no grad-scale chain. The scale stays a device tensor."""
    key, hit = _reuse_lookup(x, pl, "codes")
    if hit is not None:
        return hit
    qmin, qmax = pl.a_range
    s = torch.clamp(pl.s_a.reshape(()), min=1e-9)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), qmin, qmax)
    out = (q.to(torch.int8), s)
    _reuse_store(key, x, out)
    return out


# ---------------------------------------------------------------------------
# eqn analysis
# ---------------------------------------------------------------------------
def _kernel_form(eqn: str) -> bool:
    """True for ``...k,kn->...n`` einsums: weight (K, N) with the
    contraction on the activation's last dim."""
    try:
        lhs, out = eqn.split("->")
        xs, ws = lhs.split(",")
    except ValueError:
        return False
    return (len(ws) == 2 and xs[-1] == ws[0] and out[-1] == ws[1]
            and ws[1] not in xs)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------
def _impl_dequant_fp(eqn: str, x: torch.Tensor, pl: PackedLinear, ctx
                     ) -> torch.Tensor:
    xq = act_fake_quant(x, pl, ctx).to(ctx.compute_dtype)
    return einsum_rows(eqn, xq, pl.dequant(ctx.compute_dtype))


def _kernel_call(x: torch.Tensor, pl: PackedLinear, ctx, matmul
                 ) -> torch.Tensor:
    xq, s_x = act_codes(x, pl, ctx)
    m2 = xq.reshape(-1, xq.shape[-1])
    out = matmul(m2, s_x)
    return out.reshape(tuple(x.shape[:-1]) + (out.shape[-1],)).to(
        ctx.compute_dtype)


def _impl_cuda_int8(eqn: str, x: torch.Tensor, pl: PackedLinear, ctx
                    ) -> torch.Tensor:
    from repro_torch.kernels import ops
    w_codes = pl.unpack()
    return _kernel_call(x, pl, ctx, lambda m2, s_x: ops.quant_matmul(
        m2, w_codes, s_x, pl.scale[:1]))


def _impl_cuda_w4(eqn: str, x: torch.Tensor, pl: PackedLinear, ctx
                  ) -> torch.Tensor:
    from repro_torch.kernels import ops
    return _kernel_call(x, pl, ctx, lambda m2, s_x: ops.quant_matmul_w4(
        m2, pl.codes, s_x, pl.scale[:1]))


REGISTRY: Dict[str, Callable] = {
    "dequant-fp": _impl_dequant_fp,
    "cuda-int8": _impl_cuda_int8,
    "cuda-w4": _impl_cuda_w4,
}


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------
def kernel_eligible(eqn: str, pl: PackedLinear) -> Optional[str]:
    """The kernel route this (eqn, layer) pair could take, else None (the
    kernels' epilogue takes the per-tensor scale ``pack_linear`` packs; an
    expert stack, rank 3 with a per-expert scale, takes dequant-fp, as in
    the reference, whose expert einsums run outside any Pallas kernel)."""
    if len(pl.shape) != 2 or not _kernel_form(eqn):
        return None
    if not pl.a_signed and pl.a_bits > 7:
        return None     # unsigned 8-bit grid (qmax 255) overflows int8 codes
    if pl.layout == "nib4" and pl.shape[-2] % 2 == 0:
        return "cuda-w4"
    if pl.w_bits <= 8:
        return "cuda-int8"
    return None


def resolve(eqn: str, pl: PackedLinear, device: torch.device) -> str:
    """The route of one packed matmul (see module docstring)."""
    forced = ROUTES.forced("matmul")
    if forced is not None:
        return forced
    if device.type != "cuda":
        return "dequant-fp"
    return kernel_eligible(eqn, pl) or "dequant-fp"


def packed_qeinsum(eqn: str, x: torch.Tensor, pl: PackedLinear, ctx
                   ) -> torch.Tensor:
    """Quantized einsum over a packed weight -- the serving-time counterpart
    of ``quant_layers.qeinsum``."""
    impl = resolve(eqn, pl, x.device)
    _count("matmul", impl)
    if impl == "dequant-fp" and kernel_eligible(eqn, pl) \
            and _COUNTS[-1] is not None:
        _COUNTS[-1].eligible_fp += 1
    return REGISTRY[impl](eqn, x, pl, ctx)
