"""Public wrappers around the hand-written CUDA kernels.

A wrapper given CUDA tensors checks them and launches its kernel on the
current stream, or raises; there is no fallback. Given CPU tensors it runs
the kernel's plain version (``kernels.ref``) -- the only way the CPU tests
reach these functions. ``launches`` counts kernel launches per wrapper (one
per launch, nowhere else), so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

launches: Dict[str, int] = {"quant_matmul": 0, "quant_matmul_w4": 0,
                            "decode_attn_quant": 0}


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


def _check_scalar(t: torch.Tensor, name: str) -> None:
    if t.dtype != torch.float32 or t.numel() != 1:
        raise TypeError(f"{name}: expected one float32 element, got "
                        f"{t.dtype} {tuple(t.shape)}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def _qmm(sym: str, name: str, x_q, w, s_x, s_w, N: int) -> torch.Tensor:
    M, K = x_q.shape
    _check(x_q, "x_q", torch.int8, (M, K))
    _check_scalar(s_x, "s_x")
    _check_scalar(s_w, "s_w")
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"{name}: empty operand (M={M}, N={N}, K={K})")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    fn = getattr(_build.load("quant_matmul"), sym)
    rc = fn(x_q.data_ptr(), w.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
            out.data_ptr(), M, N, K, _stream())
    _raise_on(rc, name)
    launches[name] += 1
    return out


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                 s_w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) f32 with the per-tensor scale
    epilogue ``float(acc) * (s_x * s_w)``; s_x/s_w are one-element f32
    tensors on the operands' device (never host floats)."""
    if not _on_cuda(x_q, w_q, s_x, s_w):
        return ref.quant_matmul_ref(x_q, w_q, s_x, s_w)
    K, N = w_q.shape
    _check(w_q, "w_q", torch.int8, (x_q.shape[1], N))
    return _qmm("qmm_int8", "quant_matmul", x_q, w_q, s_x, s_w, N)


def quant_matmul_w4(x_q: torch.Tensor, w_p: torch.Tensor, s_x: torch.Tensor,
                    s_w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x nib4-packed (K/2, N) uint8 int4 codes -> (M, N) f32.
    K must be even; the nibbles unpack in the kernel's load path."""
    if not _on_cuda(x_q, w_p, s_x, s_w):
        return ref.quant_matmul_w4_ref(x_q, w_p, s_x, s_w)
    K = x_q.shape[1]
    if K % 2:
        raise ValueError(f"quant_matmul_w4: K={K} must be even")
    _check(w_p, "w_p", torch.uint8, (K // 2, w_p.shape[1]))
    return _qmm("qmm_w4", "quant_matmul_w4", x_q, w_p, s_x, s_w, w_p.shape[1])


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
    B, Sc, KV, hd = k_codes.shape
    H = q.shape[2]
    G = H // KV
    if q.shape != (B, 1, H, hd) or H != KV * G:
        raise ValueError(f"decode_attn_quant: q {tuple(q.shape)} does not "
                         f"match codes {tuple(k_codes.shape)}")
    qf = q.reshape(B, KV, G, hd).to(torch.float32) * (hd ** -0.5)
    if not _on_cuda(qf, k_codes, k_scale, v_codes, v_scale, pos, q_pos):
        out = ref.decode_attn_quant_ref(qf, k_codes, k_scale, v_codes,
                                        v_scale, pos, q_pos, window)
        return out.reshape(B, 1, H, hd)
    if G > 8 or hd > 256 or hd % 4:
        raise ValueError(f"decode_attn_quant: needs G <= 8, hd <= 256 and "
                         f"hd % 4 == 0, got G={G} hd={hd}")
    qf = qf.contiguous()
    _check(k_codes, "k_codes", torch.int8, (B, Sc, KV, hd))
    _check(v_codes, "v_codes", torch.int8, (B, Sc, KV, hd))
    _check(k_scale, "k_scale", torch.float32, (B, Sc, KV))
    _check(v_scale, "v_scale", torch.float32, (B, Sc, KV))
    _check(pos, "pos", torch.int32, (B, Sc))
    _check(q_pos, "q_pos", torch.int32, (B,))
    if window is not None and window <= 0:
        raise ValueError(f"decode_attn_quant: window must be > 0, got {window}")
    out = torch.empty((B, KV, G, hd), dtype=torch.float32, device=qf.device)
    fn = _build.load("decode_attn_quant").decode_attn_quant
    rc = fn(qf.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), pos.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), B, Sc, KV, G, hd,
            0 if window is None else int(window), _stream())
    _raise_on(rc, "decode_attn_quant")
    launches["decode_attn_quant"] += 1
    return out.reshape(B, 1, H, hd)
