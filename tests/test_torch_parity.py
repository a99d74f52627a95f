"""The PyTorch port's building blocks against the JAX reference, on the CPU.

The same numpy inputs (seeded) go through ``repro`` and ``repro_torch``.
Quantizer values, scale chains, packed bytes, KV row quantization and the
ring write are held bit for bit (atol 0): they are integer maps or single
IEEE float32 operations in both frameworks.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import quantizer as jq                      # noqa: E402
from repro.runtime import kv_cache as jkv                   # noqa: E402
from repro.runtime import packing as jpk                    # noqa: E402
from repro.runtime import session as jsess                  # noqa: E402
from repro_torch.core import quantizer as tq                # noqa: E402
from repro_torch.kernels import ops                         # noqa: E402
from repro_torch.runtime import kv_cache as tkv             # noqa: E402
from repro_torch.runtime import packing as tpk              # noqa: E402
from repro_torch.runtime import session as tsess            # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.runtime.session, repro_torch.interop, "
            "repro_torch.kernels.ops, repro_torch.launch.train, "
            "repro_torch.core.importance, repro_torch.models.recurrent, "
            "repro_torch.dist, repro_torch.dist.roofline, repro_torch.obs, "
            "repro_torch.obs.calibrate, repro_torch.obs.health, "
            "repro_torch.obs.trace, repro_torch.obs.export, "
            "repro_torch.obs.monitor, repro_torch.checkpoint, "
            "repro_torch.launch.elastic\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_reference_import():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro[ .])",
                     re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    hits = [str(f) for f in files if f.exists() and pat.search(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("with_g", [False, True])
def test_fake_quant_forward_bitwise(bits, with_g):
    r = np.random.default_rng(bits)
    v = r.standard_normal((37, 53)).astype(np.float32)
    s = np.float32(r.uniform(0.01, 0.5))
    qmin, qmax = jq.bit_range(bits, True)
    g_j = jq.lsq_grad_scale_factor(v.size, qmax) if with_g else None
    g_t = tq.lsq_grad_scale_factor(v.size, qmax) if with_g else None
    if with_g:
        _eq(g_j, g_t)
    want = jq.fake_quant(jnp.asarray(v), jnp.asarray(s), qmin, qmax,
                         grad_scale_factor=g_j)
    got = tq.fake_quant(torch.from_numpy(v), torch.tensor(s), qmin, qmax,
                        grad_scale_factor=g_t)
    _eq(want, got)


@pytest.mark.parametrize("numel", [1, 7, 1024 * 2048, 151936 * 1024])
def test_grad_scale_chain_bitwise(numel):
    """effective_weight_scale (floor + the LSQ grad-scale chain) over a range
    of bank values, including ones where the chain is not the identity."""
    r = np.random.default_rng(numel % 1000)
    bank = r.uniform(1e-4, 1.0, size=(64, 5)).astype(np.float32)
    bank[0, 0] = 0.0                      # the 1e-9 floor
    for idx, bits in enumerate((2, 3, 4, 5, 6)):
        _eq(jsess.effective_weight_scale(jnp.asarray(bank), idx, numel, bits),
            tsess.effective_weight_scale(torch.from_numpy(bank), idx, numel,
                                         bits))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("KN", [(37, 19), (64, 48)])
def test_pack_linear_bytes_bitwise(bits, KN):
    r = np.random.default_rng(bits * 100 + KN[0])
    w = (r.standard_normal(KN) * 0.2).astype(np.float32)
    s_w = np.float32(0.2 / 2 ** (bits - 1))
    pj = jpk.pack_linear(jnp.asarray(w), bits, jnp.asarray(s_w), 8,
                         jnp.float32(0.05))
    pt = tpk.pack_linear(torch.from_numpy(w), bits, torch.tensor(s_w), 8,
                         torch.tensor(0.05))
    assert pj.layout == pt.layout
    assert np.asarray(pj.codes).dtype == pt.codes.numpy().dtype
    _eq(pj.codes, pt.codes)
    _eq(pj.scale, pt.scale)
    _eq(pj.unpack(), pt.unpack())
    _eq(pj.dequant(), pt.dequant())
    assert pj.packed_bytes == pt.packed_bytes


def test_bitstream_codec_roundtrip_all_widths():
    r = np.random.default_rng(3)
    for bits in range(1, 9):
        lo, hi = tq.bit_range(bits, True)
        q = r.integers(lo, hi + 1, size=101)
        packed = tpk.pack_codes(torch.from_numpy(q), bits)
        _eq(packed, jpk.pack_codes(jnp.asarray(q), bits))
        _eq(tpk.unpack_codes(packed, bits, q.size), q.astype(np.int8))


def test_quantize_rows_bitwise():
    r = np.random.default_rng(11)
    x = r.standard_normal((3, 9, 2, 16)).astype(np.float32)
    x[0, 0, 1] = 0.0                      # zero row -> eps-floored scale
    x[1, 2, 0] *= 1e-9
    qj, sj = jkv.quantize_rows(jnp.asarray(x))
    qt, st = tkv.quantize_rows(torch.from_numpy(x))
    _eq(qj, qt)
    _eq(sj, st)
    _eq(jkv.fake_quant_kv(jnp.asarray(x)), tkv.fake_quant_kv(torch.from_numpy(x)))


def _caches(r, B, cap, KV, hd, per_slot):
    k = r.integers(-127, 128, size=(B, cap, KV, hd)).astype(np.int8)
    v = r.integers(-127, 128, size=(B, cap, KV, hd)).astype(np.int8)
    ks = r.uniform(0, 1, (B, cap, KV)).astype(np.float32)
    vs = r.uniform(0, 1, (B, cap, KV)).astype(np.float32)
    pos = r.integers(-1, 40, size=(B, cap) if per_slot else (cap,)).astype(np.int32)
    arrs = (k, v, ks, vs, pos)
    return (jkv.QuantKVCache(*map(jnp.asarray, arrs)),
            tkv.QuantKVCache(*map(torch.from_numpy, arrs)))


@pytest.mark.parametrize("per_slot", [True, False])
def test_ring_append_bitwise_with_sentinel_clamp(per_slot):
    r = np.random.default_rng(5 + per_slot)
    B, cap, KV, hd = 4, 6, 2, 8
    cj, ct = _caches(r, B, cap, KV, hd, per_slot)
    tail = ct.k[1, cap - 1].clone() if per_slot else ct.k[:, cap - 1].clone()
    steps = ([np.array([7, -1, 13, 2], np.int32),
              np.array([8, -1, 14, 3], np.int32)]
             if per_slot else [np.int32(13), np.int32(-1), np.int32(14)])
    for pos in steps:
        k_new = r.standard_normal((B, 1, KV, hd)).astype(np.float32)
        v_new = r.standard_normal((B, 1, KV, hd)).astype(np.float32)
        cj = cj.append(jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
        ct = ct.append(torch.from_numpy(k_new), torch.from_numpy(v_new),
                       torch.as_tensor(pos))
        for f in cj._fields:
            _eq(getattr(cj, f), getattr(ct, f))
    # a -1 sentinel write lands on ring index 0, never on the wrapped tail
    if per_slot:
        assert int(ct.pos[1, 0]) == -1
        assert torch.equal(ct.k[1, cap - 1], tail)
    else:
        assert torch.equal(ct.k[:, cap - 1], tail)


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.integers(-128, 128, (4, 32)).astype(np.int8))
    w = torch.from_numpy(r.integers(-128, 128, (32, 16)).astype(np.int8))
    s = torch.tensor(0.5)
    before = dict(ops.launches)
    out = ops.quant_matmul(x, w, s, s)
    assert ops.launches == before         # no kernel launched on the CPU
    want = (x.double() @ w.double()).float() * (s * s)
    assert torch.equal(out, want)


def test_kv_inventory_matches_reference():
    r = np.random.default_rng(2)
    cj, ct = _caches(r, 2, 5, 2, 8, per_slot=True)
    assert cj.inventory() == ct.inventory()


@pytest.mark.parametrize("bits,K,want", [
    (4, 64, "cuda-w4"), (4, 63, "cuda-int8"), (2, 64, "cuda-int8"),
    (3, 64, "cuda-int8"), (6, 37, "cuda-int8"), (8, 64, "cuda-int8")])
def test_kernel_routes_resolve_by_device(bits, K, want):
    """kernel_eligible's rules, and resolution by the tensor's device: a
    CUDA device takes the eligible kernel route, the CPU dequant-fp, and an
    unsigned 8-bit grid never takes a kernel."""
    from repro_torch.runtime import dispatch
    w = torch.randn(K, 24)
    pl = tpk.pack_linear(w, bits, torch.tensor(0.05), 8, torch.tensor(0.1))
    eqn = "bsd,de->bse"
    assert dispatch.resolve(eqn, pl, torch.device("cuda")) == want
    assert dispatch.resolve(eqn, pl, torch.device("cpu")) == "dequant-fp"
    unsigned = tpk.pack_linear(w, bits, torch.tensor(0.05), 8,
                               torch.tensor(0.1), a_signed=False)
    assert dispatch.resolve(eqn, unsigned, torch.device("cuda")) == "dequant-fp"
    assert dispatch.resolve("bnd,ed->bne", pl, torch.device("cuda")) == \
        "dequant-fp"


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_kernel_route_glue_matches_dequant_fp(bits):
    """The kernel routes' host side (activation codes, per-call unpack,
    reshapes) on CPU tensors, where the wrappers run the plain versions:
    the same projection as the dequant-fp route up to float32 rounding of
    the two orders of summation (and, rarely, the grad-scale chain moving
    the activation scale by an ulp)."""
    from repro_torch.models.quant_layers import QuantContext
    from repro_torch.runtime import dispatch
    r = np.random.default_rng(bits)
    w = torch.from_numpy((r.standard_normal((64, 40)) * 0.1).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((2, 3, 64)).astype(np.float32))
    pl = tpk.pack_linear(w, bits, torch.tensor(0.2 / 2 ** (bits - 1)), 6,
                         torch.tensor(0.07))
    ctx = QuantContext.make((2, 3, 4, 5, 6, 8), True,
                            compute_dtype=torch.float32)
    route = dispatch.kernel_eligible("bsd,de->bse", pl)
    counts = dispatch.Counts()
    with dispatch.counts_scope(counts):
        with dispatch.force_route("matmul", route):
            got = dispatch.packed_qeinsum("bsd,de->bse", x, pl, ctx)
        with dispatch.force_route("matmul", "dequant-fp"):
            want = dispatch.packed_qeinsum("bsd,de->bse", x, pl, ctx)
    assert counts.routes["matmul"] == {route: 1, "dequant-fp": 1}
    assert counts.eligible_fp == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
