"""Packed serving past 8 query heads per kv head, port against the JAX
reference, on the CPU.

The decode-attention kernels hold a kv head's query rows in groups of at
most 8 (``csrc/decode_attn_quant.cu``), so the archs whose GQA ratio is
above 8 are held here at their published ratios: StarCoder2-7B (36 / 4
heads, G = 9, with its sliding window), Granite-20B (48 / 1, multi-query,
G = 48) and, as the edge of one group, Yi-9B (32 / 4, G = 8). Widths,
depth and vocabulary are cut to one layer of narrow heads; the ratios
and the window are not (``smoke_config`` would cut G to 4 or less). JAX's
own weights cross over through ``repro_torch.interop``.

Logits are held within 1e-6 (absolute, on logits of magnitude ~1-3: the
float32 sums of the two frameworks run in another order; measured here up
to 7.2e-7), greedy tokens to equality on decisive rows (top-2 margin above
1e-2). Each arch runs twice on the same packed weights. With the searched
activations unquantized (``ctx.quantize_acts`` off in both sessions) the
prefill and every decode step are within 1e-6: this run has no quantizer
that could turn a last-bit difference into a code step, so a wrong op,
head mapping, mask or row moves a step past the bound. With the 2-6-bit
activation quantizers on, a last-bit difference can land an activation on
the other side of a half-integer, and then every logit of that step moves
(by ~0.1 here: one step of Granite's and one of Yi's three decode steps);
so there at most one of the four steps may part by more than 1e-6, and
that step is held to the decisive argmax.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import get_config as j_get                # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import get_config as t_get          # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.kernels import ops                          # noqa: E402
from repro_torch.runtime import dispatch                     # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

LOGIT_ATOL = 1e-6
DECISIVE = 1e-2
# (arch, heads, kv heads, window): the published GQA ratios; the window cut
# to 16 rows so that a 24-token prompt runs past it
ARCHS = [("starcoder2-7b", 36, 4, 16), ("granite-20b", 48, 1, None),
         ("yi-9b", 32, 4, None)]
PROMPT, CAP, DECODE_STEPS = 24, 32, 3


def _cut(get, name, H, KV, window):
    over = dict(n_layers=1, d_model=64, n_heads=H, n_kv_heads=KV,
                head_dim=8, d_ff=96, vocab=256, max_seq_len=128)
    if window is not None:
        over["sliding_window"] = window
    return get(name).scaled(**over)


def _decisive_argmax_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    top2 = np.sort(b, axis=-1)[:, -2:]
    dec = top2[:, 1] - top2[:, 0] > DECISIVE
    np.testing.assert_array_equal(a.argmax(-1)[dec], b.argmax(-1)[dec])
    return int(dec.sum())


def _unquantized_acts(sess):
    """The same packed session with its activations unquantized."""
    out = copy.copy(sess)
    out.ctx = dataclasses.replace(sess.ctx, quantize_acts=False)
    return out


def _reference_logits(js, toks):
    """The reference session's logits of the prefill and of each decode
    step, each step fed the argmax of the step before."""
    j_prefill = jax.jit(lambda p, t: js.prefill(p, {"tokens": t},
                                                prefill_cap=CAP))
    jl, jst = j_prefill(js.params, jnp.asarray(toks)[None])
    out = [np.asarray(jl)]
    jst = js.state_per_slot(jst)
    j_decode = jax.jit(js.decode)
    for step in range(DECODE_STEPS):
        tok = int(out[-1].argmax())
        jl, jst = j_decode(js.params, jnp.asarray([[tok]], jnp.int32),
                           jnp.asarray([PROMPT + step], jnp.int32), jst)
        out.append(np.asarray(jl))
    return out


def _port_logits(ts, toks, want):
    """The port session's logits on the same steps, fed the reference's
    tokens."""
    tl, tst = ts.prefill(ts.params, torch.from_numpy(toks)[None],
                         prefill_cap=CAP)
    out = [np.asarray(tl)]
    tst = ts.state_per_slot(tst)
    for step in range(DECODE_STEPS):
        tok = int(want[step].argmax())
        tl, tst = ts.decode(ts.params, torch.tensor([[tok]], dtype=torch.int32),
                            torch.tensor([PROMPT + step], dtype=torch.int32),
                            tst)
        out.append(np.asarray(tl))
    return out


def _compare(js, ts, toks):
    """{decode-attention route: (max |logit difference| of the prefill and
    of each decode step, decisive rows compared)} over both routes of the
    int8 cache: the kernels' plain versions ("fused", the card's route) and
    "dequant-fp"."""
    want = _reference_logits(js, toks)
    res = {}
    for route in ("fused", "dequant-fp"):
        with dispatch.force_route("decode_attn", route):
            got = _port_logits(ts, toks, want)
        res[route] = ([float(np.abs(g - w).max()) for g, w in zip(got, want)],
                      sum(_decisive_argmax_equal(g, w)
                          for g, w in zip(got, want)))
    return res


@pytest.mark.parametrize("arch,H,KV,window", ARCHS)
def test_packed_session_matches_jax_past_eight_query_heads(arch, H, KV,
                                                           window):
    jcfg = _cut(j_get, arch, H, KV, window)
    tcfg = _cut(t_get, arch, H, KV, window)
    G = H // KV
    assert (tcfg.n_heads // tcfg.n_kv_heads, tcfg.sliding_window) == \
        (G, window)
    assert ops.attn_query_groups(G)[0] == (1 if G <= 8 else -(-G // 8))
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    js = JSess(jcfg, jparams, jpol)
    ts = TSess(tcfg, tparams, TPolicy.from_json(jpol.to_json()))
    assert ts.packed_bytes() == js.packed_bytes()
    toks = np.random.default_rng(H * 10 + KV).integers(
        0, jcfg.vocab, PROMPT).astype(np.int32)

    for route, (diffs, n_dec) in _compare(_unquantized_acts(js),
                                          _unquantized_acts(ts), toks).items():
        assert max(diffs) <= LOGIT_ATOL, (route, diffs)
        assert n_dec >= 2, route
    for route, (diffs, n_dec) in _compare(js, ts, toks).items():
        assert sum(d > LOGIT_ATOL for d in diffs) <= 1, (route, diffs)
        assert n_dec >= 2, route
