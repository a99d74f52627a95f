"""Public wrappers around the hand-written CUDA kernels.

A wrapper given CUDA tensors checks them and launches its kernel on the
current stream, or raises; there is no fallback. Given CPU tensors it runs
the kernel's plain version (``kernels.ref``) -- the only way the CPU tests
reach these functions. The training kernels (fake-quant, flash forward)
and ``wkv`` also run their plain versions on CUDA tensors inside
``plain_on_cuda()``, which only tests, ``chip_smoke.py`` and the serve
CLI's fake-quant reference engines (``serve.reference_engine``, which reach
``wkv`` in prefill) enter. ``launches`` counts kernel launches per wrapper
(one per launch, nowhere else), so a run can show that its path went
through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, FrozenSet, List, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches: Dict[str, int] = {"quant_matmul": 0, "quant_matmul_w4": 0,
                            "decode_attn_quant": 0,
                            "decode_attn_quant_paged": 0,
                            "verify_attn_quant": 0,
                            "verify_attn_quant_paged": 0, "fake_quant_fwd": 0,
                            "fake_quant_bwd": 0, "flash_fwd": 0, "wkv": 0}

FQ_THREADS, FQ_MAX_BLOCKS = 256, 2048   # csrc/fake_quant.cu launch shape
# csrc/quant_matmul.cu (int8 and nib4 weights): the split-K route's row
# instances (M <= 16; larger M takes the tensor-core route), output columns
# per block, k rows per block step, and the blocks a launch aims for: two
# waves of the H100's 132 SMs
QMM_ROWS = (1, 2, 3, 4, 8, 16)
QMM_TILE_N, QMM_STEP_K = 64, 32
QMM_TARGET_BLOCKS = 2 * 132
FLASH_TILE = 64                         # csrc/flash_attention.cu q tile
FLASH_HEAD_DIMS = (32, 64, 80, 128, 256)  # the kernel's instances
MAX_TABLE = 4096                        # page-table entries of a slot
# csrc/decode_attn_quant.cu: cache rows per pipeline tile; the blocks a
# launch aims for, four on each of the H100's 132 SMs; query rows per block
ATTN_TILE, ATTN_TARGET_BLOCKS, ATTN_MAX_G = 64, 4 * 132, 8
WKV_CHUNKS, WKV_HEAD_DIMS = (16, 32), (8, 16, 32, 64)  # csrc/wkv.cu instances
TRAIN_KERNELS = ("fake_quant_fwd", "fake_quant_bwd", "flash_fwd")
# the kernels whose plain versions ``plain_on_cuda`` can run on the card
# (the fake-quant reference engines of an rwkv schedule reach ``wkv``)
PLAIN_KERNELS = TRAIN_KERNELS + ("wkv",)
_PLAIN: List[FrozenSet[str]] = [frozenset()]
# int32 scratch per (device, stream) for the kernels that combine splits in
# one launch -- the attention kernels' split tickets, the split-K matmuls'
# tickets and partial sums, wkv's per-head tickets: zeroed once, and every
# launch leaves it zeroed
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
# float32 scratch per (device, stream) for the wkv kernel's chunk states:
# two hd x hd slots a head, which every launch writes before it reads
_WKV_STATES: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"} and len({t.device for t in ts}) == 1:
        return True
    raise ValueError(f"tensors on mixed devices: {sorted(str(t.device) for t in ts)}")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@contextlib.contextmanager
def plain_on_cuda(*names: str):
    """Run the plain versions of the named kernels of ``PLAIN_KERNELS`` (the
    training kernels when none is named) on CUDA tensors for the scope.
    Only tests, ``chip_smoke.py`` and the reference engines of ``serve``
    enter it; no served or trained path does."""
    bad = set(names) - set(PLAIN_KERNELS)
    if bad:
        raise ValueError(f"plain_on_cuda: unknown kernels {sorted(bad)}")
    _PLAIN.append(frozenset(names or TRAIN_KERNELS))
    try:
        yield
    finally:
        _PLAIN.pop()


def _kernel_route(name: str, *ts: torch.Tensor) -> bool:
    """Whether kernel ``name`` of ``PLAIN_KERNELS`` launches: yes on CUDA
    tensors, unless inside ``plain_on_cuda``; CPU tensors take the plain
    versions."""
    return _on_cuda(*ts) and name not in _PLAIN[-1]


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_scalar(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.numel() != 1:
        raise TypeError(f"{name}: expected one float32 element, got "
                        f"{t.dtype} {tuple(t.shape)}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def qmm_split_k(M: int, K: int, N: int) -> int:
    """K rows each block of the split-K matmul route takes (M <= 16), for
    int8 and nib4 weights alike: a multiple of ``QMM_STEP_K``, as many
    steps per split as leave at least ``ceil(QMM_TARGET_BLOCKS / column
    tiles)`` splits (every step its own split when K has fewer), capped by
    the x slab the row instance holds. A nib4 step of 32 k rows is 16
    packed byte rows, so a nib4 block streams half the bytes of an int8
    one over the same k rows; its ring is twice as deep in steps, which
    keeps the bytes in flight. Integer sums are exact in any order, so the
    split never changes a bit."""
    if not 1 <= M <= QMM_ROWS[-1]:
        raise ValueError(f"qmm_split_k: the split-K route takes 1 <= M <= "
                         f"{QMM_ROWS[-1]}, got M={M}")
    mr = next(r for r in QMM_ROWS if r >= M)
    cap = 4096 if mr <= 4 else 16384 // mr    # the instance's x slab rows
    steps = -(-K // QMM_STEP_K)
    want = -(-QMM_TARGET_BLOCKS // -(-N // QMM_TILE_N))
    per = max(1, min(steps // want, cap // QMM_STEP_K))
    return QMM_STEP_K * per


def _qmm(name: str, x_q, w, s_x, s_w, N: int) -> torch.Tensor:
    M, K = x_q.shape
    _check(x_q, "x_q", torch.int8, (M, K))
    _check_scalar(s_x, "s_x")
    _check_scalar(s_w, "s_w")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"{name}: empty operand (M={M}, N={N}, K={K})")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    lib = _build.load("quant_matmul")
    fmt = "w4" if name == "quant_matmul_w4" else "int8"
    ptrs = (x_q.data_ptr(), w.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            out.data_ptr())
    stream = _stream()
    if M > QMM_ROWS[-1]:
        rc = getattr(lib, f"qmm_{fmt}_mma")(*ptrs, M, N, K, stream)
    else:
        n_tiles = -(-N // QMM_TILE_N)
        ws = _tickets(x_q.device, n_tiles + M * N, stream.value)
        rc = getattr(lib, f"qmm_{fmt}_splitk")(
            *ptrs, ws.data_ptr(), ws.data_ptr() + 4 * n_tiles, M, N, K,
            qmm_split_k(M, K, N), stream)
    _raise_on(rc, name)
    launches[name] += 1
    return out


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                 s_w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 with the per-tensor scale
    epilogue ``float(acc) * (s_x * s_w)``; s_x/s_w are one-element f32
    tensors on the operands' device (never host floats). One launch: the
    split-K route for M <= 16 (``qmm_split_k``), tensor cores above."""
    if not _on_cuda(x_q, w_q, s_x, s_w):
        return ref.quant_matmul_ref(x_q, w_q, s_x, s_w)
    K, N = w_q.shape
    _check(w_q, "w_q", torch.int8, (x_q.shape[1], N))
    return _qmm("quant_matmul", x_q, w_q, s_x, s_w, N)


def quant_matmul_w4(x_q: torch.Tensor, w_p: torch.Tensor, s_x: torch.Tensor,
                    s_w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x nib4-packed (K/2, N) uint8 int4 codes -> (M, N) f32.
    K must be even; the nibbles unpack in registers. One launch, routed by
    M as :func:`quant_matmul`: the split-K route with ``qmm_split_k``'s
    rows for M <= 16, tensor cores above."""
    if not _on_cuda(x_q, w_p, s_x, s_w):
        return ref.quant_matmul_w4_ref(x_q, w_p, s_x, s_w)
    K = x_q.shape[1]
    if K % 2:
        raise ValueError(f"quant_matmul_w4: K={K} must be even")
    _check(w_p, "w_p", torch.uint8, (K // 2, w_p.shape[1]))
    return _qmm("quant_matmul_w4", x_q, w_p, s_x, s_w, w_p.shape[1])


def _check_attn_shape(name: str, G: int, hd: int,
                      window: Optional[int]) -> None:
    """The launch shape the decode-attention kernels take (any G)."""
    if hd > 256 or hd % 4:
        raise ValueError(f"{name}: needs hd <= 256 and hd % 4 == 0, "
                         f"got G={G} hd={hd}")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be > 0, got {window}")


def attn_split_rows(B: int, KV: int, Sc: int) -> int:
    """Cache rows each block of the decode-attention kernels takes (L): a
    slot's ``ATTN_TILE``-row tiles spread evenly over at most
    ``ceil(ATTN_TARGET_BLOCKS / (B * KV))`` splits, the launch's block
    target, and at least one tile per split. It depends on
    (B, KV, Sc) only -- never on the number of queries or on the layout --
    so a verify query splits as its one-token launch does, and a paged
    launch as the ring launch on its gathered view (Sc = P * ps): each pair
    agrees bit for bit."""
    n_tiles = max(1, -(-Sc // ATTN_TILE))
    want = -(-ATTN_TARGET_BLOCKS // max(1, B * KV))
    return ATTN_TILE * -(-n_tiles // min(n_tiles, want))


def attn_query_groups(G: int) -> Tuple[int, int]:
    """(groups, rows per group) of a kv head's G query rows in the
    decode-attention kernels: ``ceil(G / ATTN_MAX_G)`` blocks share each
    (slot, kv head, split, query), balanced (the last group may hold
    fewer rows). A row's arithmetic does not depend on its group."""
    n = -(-G // ATTN_MAX_G)
    return n, -(-G // n)


def _cached(cache: Dict[Tuple[int, int], torch.Tensor], dev: torch.device,
            n: int, stream: int, dtype: torch.dtype) -> torch.Tensor:
    """At least ``n`` zeroed elements of ``cache``'s scratch for launches on
    ``stream`` of device ``dev``, allocated (zeroed) only when the cached
    ones are too few."""
    key = (dev.index, stream)
    t = cache.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 1024),), dtype=dtype, device=dev)
        cache[key] = t
    return t


def _tickets(dev: torch.device, n: int, stream: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 (split tickets, and the split-K matmuls'
    partial sums); every launch leaves them zeroed."""
    return _cached(_TICKETS, dev, n, stream, torch.int32)


def _quant_attn(name: str, q: torch.Tensor, kc: torch.Tensor,
                ks: torch.Tensor, vc: torch.Tensor, vs: torch.Tensor,
                pos: torch.Tensor, q_pos: torch.Tensor,
                table: Optional[torch.Tensor], window: Optional[int],
                q_scale: Optional[float] = None) -> torch.Tensor:
    """The four attention wrappers on one launcher: q (B, S, H, hd) with
    q_pos (B, S) for the verify entry points, (B,) with S = 1 for the
    one-token ones; the ring layout when ``table`` is None, else the paged
    one. q is scaled by ``q_scale`` (hd**-0.5 when None): here before the
    plain versions, as the TPU wrappers did, and in the kernel as it loads
    q (the same float32 multiply, so the same bits, without a launch).
    Returns (B, S, H, hd) f32."""
    verify = name.startswith("verify")
    paged = table is not None
    if paged:
        n_pages, ps, KV, hd = kc.shape
        B, P = table.shape
        cache = ((n_pages, ps, KV, hd), (n_pages, ps, KV), (n_pages, ps))
    else:
        B, Sc, KV, hd = kc.shape
        cache = ((B, Sc, KV, hd), (B, Sc, KV), (B, Sc))
    S, H = q.shape[1], q.shape[2]
    G = H // KV
    if q.shape != (B, S, H, hd) or H != KV * G or S < 1 or \
            (not verify and S != 1):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match codes "
                         f"{tuple(kc.shape)}"
                         + (f" and table {tuple(table.shape)}" if paged else ""))
    scale = hd ** -0.5 if q_scale is None else q_scale
    qf = q.reshape(B, S, KV, G, hd).to(torch.float32)
    tensors = (qf, kc, ks, vc, vs, pos, q_pos) + ((table,) if paged else ())
    if not _on_cuda(*tensors):
        qf = qf * scale
        if verify:
            fn = ref.verify_attn_quant_paged_ref if paged \
                else ref.verify_attn_quant_ref
            out = fn(qf, kc, ks, vc, vs, pos, *((table,) if paged else ()),
                     q_pos, window)
        else:
            fn = ref.decode_attn_quant_paged_ref if paged \
                else ref.decode_attn_quant_ref
            out = fn(qf[:, 0], kc, ks, vc, vs, pos,
                     *((table,) if paged else ()), q_pos, window)
        return out.reshape(B, S, H, hd)
    qf = qf.contiguous()
    _check_attn_shape(name, G, hd, window)
    if S > 65535:
        raise ValueError(f"{name}: S={S} exceeds the grid's 65535 queries")
    if paged and (P > MAX_TABLE or n_pages < 1):
        raise ValueError(f"{name}: needs 1 <= n_pages and P <= {MAX_TABLE}, "
                         f"got n_pages={n_pages} P={P}")
    codes, scales, rows = cache
    _check(kc, "k_codes", torch.int8, codes)
    _check(vc, "v_codes", torch.int8, codes)
    _check(ks, "k_scale", torch.float32, scales)
    _check(vs, "v_scale", torch.float32, scales)
    _check(pos, "pos", torch.int32, rows)
    _check(q_pos, "q_pos", torch.int32, (B, S) if verify else (B,))
    if paged:
        _check(table, "page_table", torch.int32, (B, P))
        Sc = P * ps
    if kc.data_ptr() % 4 or vc.data_ptr() % 4:
        raise ValueError(f"{name}: codes must be 4-byte aligned")
    dev = qf.device
    L = attn_split_rows(B, KV, Sc)
    n_split = max(1, -(-Sc // L))
    out = torch.empty((B, S, KV, G, hd), dtype=torch.float32, device=dev)
    # the splits' partials: acc (G, hd) each, then (m, l) of each query row
    part = torch.empty((B * S * KV * n_split * G * (hd + 2),),
                       dtype=torch.float32, device=dev) if n_split > 1 else None
    stream = _stream()
    tickets = _tickets(dev, B * S * KV * attn_query_groups(G)[0],
                       stream.value)
    ptrs = [t.data_ptr() for t in (qf, kc, ks, vc, vs, pos)]
    ptrs += [table.data_ptr()] if paged else []
    ptrs += [q_pos.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), tickets.data_ptr()]
    dims = [B] + ([S] if verify else [])
    dims += [P, ps] if paged else [Sc]
    dims += [KV, G, hd, 0 if window is None else int(window), L]
    rc = getattr(_build.load("decode_attn_quant"), name)(*ptrs, *dims, scale,
                                                         stream)
    _raise_on(rc, name)
    launches[name] += 1
    return out.reshape(B, S, H, hd)


def decode_attn_quant(q: torch.Tensor, k_codes: torch.Tensor,
                      k_scale: torch.Tensor, v_codes: torch.Tensor,
                      v_scale: torch.Tensor, pos: torch.Tensor,
                      q_pos: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """One-token decode attention directly on int8 KV codes.

    q: (B, 1, H, hd) queries; k/v_codes: (B, Sc, KV, hd) int8; k/v_scale:
    (B, Sc, KV) f32 write-time scales; pos: (B, Sc) int32 absolute slot
    positions (-1 = empty); q_pos: (B,) int32. Returns (B, 1, H, hd) f32.
    Rows whose slots are all masked softmax uniformly (finite, discarded by
    the engine)."""
    return _quant_attn("decode_attn_quant", q, k_codes, k_scale, v_codes,
                       v_scale, pos, q_pos, None, window)


def decode_attn_quant_paged(q: torch.Tensor, k_pages: torch.Tensor,
                            k_scale: torch.Tensor, v_pages: torch.Tensor,
                            v_scale: torch.Tensor, page_pos: torch.Tensor,
                            page_table: torch.Tensor, q_pos: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """One-token decode attention over the paged int8 KV layout, gathering
    pages by index inside the kernel (no dense per-slot view is built).

    q: (B, 1, H, hd); k/v_pages: (n_pages, ps, KV, hd) int8; k/v_scale:
    (n_pages, ps, KV) f32; page_pos: (n_pages, ps) int32 (-1 = empty row);
    page_table: (B, P) int32 physical page per logical block (-1 =
    unmapped: the block is masked); q_pos: (B,) int32. Returns (B, 1, H,
    hd) f32, what :func:`decode_attn_quant` gives on the gathered view."""
    return _quant_attn("decode_attn_quant_paged", q, k_pages, k_scale,
                       v_pages, v_scale, page_pos, q_pos, page_table, window)


def verify_attn_quant(q: torch.Tensor, k_codes: torch.Tensor,
                      k_scale: torch.Tensor, v_codes: torch.Tensor,
                      v_scale: torch.Tensor, pos: torch.Tensor,
                      q_pos: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """S-query speculative-verify attention on int8 ring KV codes, one
    launch: q (B, S, H, hd), q_pos (B, S) int32, each query masked by its
    own position; the cache operands as in :func:`decode_attn_quant`.
    Query j equals :func:`decode_attn_quant` at ``q_pos[:, j]`` bit for
    bit. Returns (B, S, H, hd) f32."""
    return _quant_attn("verify_attn_quant", q, k_codes, k_scale, v_codes,
                       v_scale, pos, q_pos, None, window)


def verify_attn_quant_paged(q: torch.Tensor, k_pages: torch.Tensor,
                            k_scale: torch.Tensor, v_pages: torch.Tensor,
                            v_scale: torch.Tensor, page_pos: torch.Tensor,
                            page_table: torch.Tensor, q_pos: torch.Tensor, *,
                            window: Optional[int] = None) -> torch.Tensor:
    """:func:`verify_attn_quant` over the paged layout (operands as in
    :func:`decode_attn_quant_paged`, q (B, S, H, hd), q_pos (B, S)); query
    j equals :func:`decode_attn_quant_paged` at ``q_pos[:, j]`` bit for
    bit."""
    return _quant_attn("verify_attn_quant_paged", q, k_pages, k_scale,
                       v_pages, v_scale, page_pos, q_pos, page_table, window)


# ---------------------------------------------------------------------------
# LSQ fake-quant (training)
# ---------------------------------------------------------------------------
def _fq_blocks(n: int) -> int:
    """Blocks of the fake-quant launch (one ds partial each): four elements
    per thread, at most ``FQ_MAX_BLOCKS`` (a grid-stride loop does the
    rest)."""
    groups = -(-n // 4)
    return max(1, min(FQ_MAX_BLOCKS, -(-groups // FQ_THREADS)))


def fake_quant_fwd(v: torch.Tensor, s: torch.Tensor, qmin: float,
                   qmax: float) -> torch.Tensor:
    """Eq. 1 forward ``round(clip(v / max(s, 1e-9), qmin, qmax)) * s`` on a
    float32 tensor of any shape. ``s`` is one float32 element on ``v``'s
    device: the scale after the floor and the grad-scale chain."""
    if not _kernel_route("fake_quant_fwd", v, s):
        return ref.fake_quant_ref(v, s.reshape(()), qmin, qmax)
    _check(v, "v", torch.float32, v.shape)
    _check_scalar(s, "s")
    out = torch.empty_like(v)
    n = v.numel()
    rc = _build.load("fake_quant").fake_quant_fwd(
        v.data_ptr(), s.data_ptr(), out.data_ptr(), n, float(qmin),
        float(qmax), _fq_blocks(n), _stream())
    _raise_on(rc, "fake_quant_fwd")
    launches["fake_quant_fwd"] += 1
    return out


def fake_quant_bwd(v: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                   qmin: float, qmax: float):
    """LSQ backward of :func:`fake_quant_fwd` for the output gradient
    ``g``: ``(dv, ds)``, ds before the grad-scale factor. The kernel writes
    one ds partial per block and the sum is taken here."""
    if not _kernel_route("fake_quant_bwd", v, s, g):
        return ref.fake_quant_grads_ref(v, s.reshape(()), g, qmin, qmax)
    _check(v, "v", torch.float32, v.shape)
    _check(g, "g", torch.float32, v.shape)
    _check_scalar(s, "s")
    n = v.numel()
    blocks = _fq_blocks(n)
    dv = torch.empty_like(v)
    partials = torch.empty((blocks,), dtype=torch.float32, device=v.device)
    rc = _build.load("fake_quant").fake_quant_bwd(
        v.data_ptr(), s.data_ptr(), g.data_ptr(), dv.data_ptr(),
        partials.data_ptr(), n, float(qmin), float(qmax), blocks, _stream())
    _raise_on(rc, "fake_quant_bwd")
    launches["fake_quant_bwd"] += 1
    return dv, partials.sum()


class _FakeQuant(torch.autograd.Function):
    """LSQ fake-quant whose forward and backward are the kernels (the
    reference's ``kernels/ops.py`` custom VJP)."""

    @staticmethod
    def forward(ctx, v, s, qmin, qmax):
        ctx.save_for_backward(v, s)
        ctx.qmin, ctx.qmax = qmin, qmax
        return fake_quant_fwd(v, s, qmin, qmax)

    @staticmethod
    def backward(ctx, g):
        v, s = ctx.saved_tensors
        dv, ds = fake_quant_bwd(v, s, g.contiguous(), ctx.qmin, ctx.qmax)
        return dv, ds.reshape(s.shape).to(s.dtype), None, None


def fake_quant(v: torch.Tensor, s: torch.Tensor, qmin: float,
               qmax: float) -> torch.Tensor:
    """Differentiable LSQ fake-quant through the kernels. ``s`` is the
    one-element scale after the floor and the grad-scale chain, so autograd
    multiplies ds by the grad-scale factor on the way back to the bank."""
    return _FakeQuant.apply(v, s, qmin, qmax)


# ---------------------------------------------------------------------------
# flash attention forward (training, and prefill of 2048 tokens or more)
# ---------------------------------------------------------------------------
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: Optional[int] = None,
              q_block: int = 512, kv_block: int = 512):
    """Online-softmax GQA self-attention forward. q (B, S, KV, G, hd)
    pre-scaled by hd**-0.5, k/v (B, S, KV, hd). Returns (out (B, S, KV, G,
    hd) f32, lse (B, KV, G, S) f32). The kernel tiles by ``FLASH_TILE``
    rows; ``q_block``/``kv_block`` set the plain version's blocking."""
    B, S, KV, G, hd = q.shape
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd):
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_fwd: window must be > 0, got {window}")
    if not _kernel_route("flash_fwd", q, k, v):
        return ref.flash_fwd_ref(q, k, v, causal=causal, window=window,
                                 q_block=q_block, kv_block=kv_block)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_floating_point():
            raise TypeError(f"flash_fwd: {name} must be floating, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    if S % FLASH_TILE or hd not in FLASH_HEAD_DIMS or B * KV * G > 65535:
        raise ValueError(f"flash_fwd: needs S % {FLASH_TILE} == 0, hd in "
                         f"{FLASH_HEAD_DIMS} and B*KV*G <= 65535, got S={S} "
                         f"hd={hd} B*KV*G={B * KV * G}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_aligned(t, name)
    out = torch.empty((B, S, KV, G, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    rc = _build.load("flash_attention").flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, KV, G, hd, int(causal),
        0 if window is None else int(window), _stream())
    _raise_on(rc, "flash_fwd")
    launches["flash_fwd"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# RWKV6 wkv (prefill of a multiple of the chunk length)
# ---------------------------------------------------------------------------
def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_w: torch.Tensor, u: torch.Tensor,
        state0: Optional[torch.Tensor] = None, chunk: int = 32):
    """Chunked RWKV6 wkv recurrence: r/k/v/log_w (B, S, H, hd) with ``S %
    chunk == 0``, u (H, hd), state0 (B, H, hd, hd) or None (zero state).
    Returns (y (B, S, H, hd), final state (B, H, hd, hd)), the reference's
    ``wkv_chunked``; from zero state y is ``wkv_pallas``'s. The kernel takes
    float32 contiguous 16-byte aligned operands, chunk in ``WKV_CHUNKS`` and
    hd in ``WKV_HEAD_DIMS``; one launch, a block per (batch, head, chunk),
    each chunk's state handed to the next chunk's block through the cached
    scratch (``ref.wkv_chunkpar_ref`` is its decomposition)."""
    B, S, H, hd = r.shape
    ts = (r, k, v, log_w, u) + (() if state0 is None else (state0,))
    if not _kernel_route("wkv", *ts):
        return ref.wkv_chunked_ref(r, k, v, log_w, u, state0, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "wkv: the kernel has no backward yet (RWKV training is a later "
            "slice); call it on tensors that do not require grad")
    if chunk not in WKV_CHUNKS or hd not in WKV_HEAD_DIMS or S < 1 \
            or S % chunk:
        raise ValueError(f"wkv: needs chunk in {WKV_CHUNKS}, hd in "
                         f"{WKV_HEAD_DIMS} and S a positive multiple of the "
                         f"chunk, got chunk={chunk} hd={hd} S={S}")
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (log_w, "log_w")):
        _check(t, name, torch.float32, (B, S, H, hd))
    _check(u, "u", torch.float32, (H, hd))
    if state0 is not None:
        _check(state0, "state0", torch.float32, (B, H, hd, hd))
    for t, name in ((r, "r"), (k, "k"), (v, "v"), (log_w, "log_w"),
                    (state0, "state0")):
        if t is not None:
            _check_aligned(t, name)
    dev = r.device
    y = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    stream = _stream()
    states = _cached(_WKV_STATES, dev, B * H * 2 * hd * hd, stream.value,
                     torch.float32)
    tickets = _tickets(dev, B * H + 2, stream.value)
    rc = _build.load("wkv").wkv(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), None if state0 is None else state0.data_ptr(),
        y.data_ptr(), state.data_ptr(), states.data_ptr(),
        tickets.data_ptr(), B, S, H, hd, chunk, stream)
    _raise_on(rc, "wkv")
    launches["wkv"] += 1
    return y, state
