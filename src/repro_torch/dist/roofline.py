"""Three-term roofline: compute / HBM / interconnect step-time model.

Copied from the reference package's ``dist/roofline.py`` with its imports
renamed; the default envelope is an NVIDIA H100 SXM5 instead of the
reference's chip. ``report`` takes any per-device cost object with
``flops`` / ``bytes_hbm`` / ``wire_bytes`` (the reference feeds it its
compiled-HLO analyzer, which the port does not have). Each term is an
independent lower bound on step time; their max is the roofline step
time and the arg-max names the bottleneck:

  compute_s     = flops / peak_flops
  memory_s      = bytes_hbm / hbm_bandwidth
  collective_s  = wire_bytes / ici_bandwidth

``useful_ratio`` compares the analytic model flops (from the QLayer MAC
table) against what the compiled graph actually executes — remat,
fake-quant chains and padding all push it below 1 — and ``mfu`` is the
classic model-flops utilization at the roofline step time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware envelope; the defaults are NVIDIA's published
    H100 SXM5 (80 GB HBM3) figures.

    ``peak_flops`` holds the dense int8 tensor-core rate: the packed serving
    path's matmuls are int8 x int8 -> int32 (``quant_matmul`` and the nib4
    kernel feed the same int8 units), so that is the rate its compute term
    competes for. The field keeps the reference's names: ``ici_bytes_s`` is
    the card's NVLink bandwidth (all links) and ``dcn_bytes_s`` one 400 Gb/s
    NDR InfiniBand port, the per-card share of a node's network."""
    name: str = "h100-sxm5"
    peak_flops: float = 1979e12       # int8 dense tensor-core op/s
    hbm_bytes_s: float = 3.35e12      # HBM3 bandwidth
    ici_bytes_s: float = 900e9        # NVLink 4, all links
    dcn_bytes_s: float = 50e9         # one 400 Gb/s NDR port per card
    hbm_bytes: float = 80e9


DEFAULT_CHIP = ChipSpec()


def chip_from_table(table: dict, base: ChipSpec = DEFAULT_CHIP) -> ChipSpec:
    """Build a ``ChipSpec`` from a measured device-table stanza.

    ``table`` is what ``repro_torch.obs.calibrate.calibrate`` emits (the
    serve CLI's ``--chip-table`` reads it back from a json file):
    ``ChipSpec`` field names mapped to measured values, plus bookkeeping
    keys (``source``, ...) that are ignored. Unmeasured fields keep
    ``base``'s envelope, and non-positive measurements are rejected —
    a zero bandwidth would turn every roofline term infinite silently.
    """
    fields = {f.name for f in dataclasses.fields(ChipSpec)}
    updates = {k: v for k, v in table.items() if k in fields}
    for k, v in updates.items():
        if k != "name" and (not isinstance(v, (int, float)) or v <= 0):
            raise ValueError(f"device table {k}={v!r}: measured envelope "
                             "values must be positive numbers")
    return dataclasses.replace(base, **updates)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str                     # compute | memory | collective
    step_time_s: float
    model_flops_total: float
    useful_ratio: float
    mfu: float


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Analytic model flops per step from the QLayer MAC table.

    train: 6 MAC-factors (fwd 2 + bwd 4); prefill/decode: 2. Decode runs
    one token per sequence.
    """
    from repro_torch.models import lm
    macs_per_token = sum(q.macs_per_token * q.n_mats
                         for q in lm.enumerate_qlayers(cfg))
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * macs_per_token * tokens


# ---------------------------------------------------------------------------
# per-step analytic costs (the serving scheduler's hook)
# ---------------------------------------------------------------------------
def decode_step_cost(cfg: ModelConfig, n_slots: int, *,
                     cache_tokens: int = 0, tp_size: int = 1,
                     avg_weight_bits: float = 8.0,
                     kv_bits: float = 16.0,
                     kv_attend: str = "fused",
                     w_bits_total: Optional[float] = None,
                     unique_pages: Optional[int] = None,
                     page_size: int = 0,
                     spec_k: int = 0,
                     draft_w_bits: float = 2.0,
                     chip: ChipSpec = DEFAULT_CHIP) -> dict:
    """Analytic three-term roofline for ONE continuous-batching decode step.

    Unlike ``report`` this needs no compiled HLO — the serving scheduler
    calls it per step shape, so it is built from the QLayer MAC/param table:

      compute_s     2 * macs * n_slots / peak_flops (per chip: megatron
                    row+column parallel splits the matmuls over tp)
      memory_s      (weight bytes + KV-cache bytes actually attended, i.e.
                    cache_tokens rows per slot, both sharded over tp)
                    / hbm_bytes_s — decode re-reads every weight per token,
                    so this term usually dominates
      collective_s  2 activation all-reduces per layer over the tp group
                    (megatron row+column parallel) / ici_bytes_s

    The bytes term is bit-width aware, reflecting the quantized serving
    runtime: ``w_bits_total`` is the exact packed weight-storage bits of a
    searched policy (``MPQPolicy.size_bytes(qlayers) * 8``; falls back to
    ``w_params * avg_weight_bits``), and ``kv_bits`` sizes a cache element
    (16 = bf16, 8 = the int8 KV cache, which also charges its 4-byte
    per-row per-head write-time scales AND the int32 per-slot position
    rows — the same inventory ``runtime.kv_cache.cache_bytes`` measures).

    ``kv_attend`` distinguishes how an int8 cache is *attended* (it is
    ignored for fp caches):

    * ``"fused"``   — the fused decode-attention kernel reads the codes
      directly; cache traffic is codes + scales + pos.
    * ``"dequant"`` — int8 stored but fp-attended: the dequant-fp route
      materializes the dequantized cache in device memory every step,
      adding a bf16 write + read of every cache element on top of the code
      read. This is what the engine pays where the kernel route is off, so
      ``suggest_prefill_chunk`` budgets honestly instead of assuming the
      kernel route.

    ``spec_k > 0`` models ONE self-speculative decode ROUND instead of one
    token-at-a-time step: a ``draft_w_bits``-wide uniform repack of the
    same weights proposes ``spec_k`` tokens autoregressively (the draft
    weight bytes are re-read once per drafted token — that is the whole
    point of drafting low-bit), then the target policy verifies all of
    them in a single batched ``spec_k + 1``-token step (the target weight
    bytes move ONCE for the round, amortized over every verified token).
    Compute runs ``2 * spec_k + 1`` token-passes, the KV cache is attended
    ``spec_k + 1`` times (k draft reads + one batched verify read), and
    the tp all-reduce wire scales the same way. A round can emit up to
    ``spec_k + 1`` tokens, so the modeled win condition is
    ``round.step_s < (accepted + 1) * single.step_s`` — the benches gate
    the memory-bound version of it (``spec_k`` draft reads + one target
    read < ``spec_k`` target reads) on the demo preset.

    ``unique_pages`` + ``page_size`` switch the KV term to the paged
    layout's accounting: shared-prefix pages are physically one allocation,
    so a step touches ``unique_pages * page_size`` cache rows instead of
    ``cache_tokens`` rows per slot — prefix sharing shrinks the modeled KV
    traffic, not just prefill compute. The paged layout also charges the
    int32 slot -> page-list table (read every step to gather, unsharded
    like the pos rows). The pool's host-side free-list/refcount arrays are
    deliberately NOT charged here — they never move over HBM during a
    decode step (``kv_cache.inventory`` does count them, under ``meta``).

    Returns the three terms plus ``step_s``/``dominant`` and the raw
    ``hbm_bytes``/``kv_hbm_bytes``/``wire_bytes`` counters.
    """
    if kv_attend not in ("fused", "dequant"):
        raise ValueError(f"kv_attend must be 'fused' or 'dequant', "
                         f"got {kv_attend!r}")
    paged = unique_pages is not None
    if paged and page_size <= 0:
        raise ValueError("paged KV accounting needs page_size > 0")
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k and not 0 < draft_w_bits <= 8:
        raise ValueError("speculative drafting is a sub-8-bit repack: "
                         f"draft_w_bits must be in (0, 8], got {draft_w_bits}")
    if paged and kv_bits > 8:
        raise ValueError("paged KV pages hold int8 codes: kv_bits must be "
                         f"<= 8, got {kv_bits}")
    from repro_torch.models import lm
    qlayers = lm.enumerate_qlayers(cfg)
    macs = sum(q.macs_per_token * q.n_mats for q in qlayers)
    w_params = sum(q.w_params * q.n_mats for q in qlayers)
    # only self-attention sites hold a token KV cache (recurrent/LRU sites
    # carry O(1) state, cross-attn caches image tokens), and a sliding
    # window caps the rows a cache can hold
    n_kv_layers = sum(1 for s in lm.iter_sites(cfg)
                      if s.kind in ("attn", "dense", "moe"))
    window = lm.attn_window(cfg)
    kv_rows = min(cache_tokens, window) if window else cache_tokens

    tp = max(tp_size, 1)
    compute_s = 2.0 * macs * n_slots / tp / chip.peak_flops
    if w_bits_total is not None:
        w_bytes = (w_bits_total / 8.0) / tp
    else:
        w_bytes = w_params * (avg_weight_bits / 8.0) / tp
    # rows of cache a step actually touches: dense per-slot rows for the
    # ring layout; the pool's unique resident rows for the paged layout
    # (a prefix page shared by k slots is one physical read, not k)
    eff_rows = (unique_pages * page_size if paged
                else float(kv_rows) * n_slots)
    kv_elems = 2.0 * eff_rows * cfg.kv_dim * n_kv_layers
    kv_bytes = kv_elems * (kv_bits / 8.0) / tp
    if kv_bits <= 8:
        # int8 KV: per-row per-head f32 scales and the int32 per-slot
        # position row ride along with the codes (one pos buffer serves
        # both k and v) — matching runtime.kv_cache.cache_bytes
        n_heads_kv = max(cfg.kv_dim // max(cfg.hd, 1), 1)
        kv_bytes += 2.0 * eff_rows * n_heads_kv * n_kv_layers * 4.0 / tp
        # the pos row has no KV-head dim to split over tp: every model
        # shard reads the full position inventory to mask its attention
        kv_bytes += eff_rows * n_kv_layers * 4.0
        if kv_attend == "dequant":
            # int8 stored but fp-attended: the fallback materializes the
            # dequantized cache in HBM each step (bf16 write + read)
            kv_bytes += 2.0 * kv_elems * 2.0 / tp
    if paged:
        # int32 slot -> page-list indirection, gathered every step
        pages_per_slot = -(-max(kv_rows, 1) // page_size)
        kv_bytes += n_slots * pages_per_slot * n_kv_layers * 4.0
    draft_bytes = 0.0
    if spec_k:
        # one speculative ROUND: the draft weights move once per drafted
        # token (k autoregressive passes), the target weights move ONCE
        # for the whole batched (k+1)-token verify, and the KV cache is
        # attended k + 1 times (each draft step + one verify read)
        draft_bytes = spec_k * w_params * (draft_w_bits / 8.0) / tp
        kv_bytes = (spec_k + 1.0) * kv_bytes
        compute_s = (2 * spec_k + 1) * compute_s
    memory_s = (w_bytes + draft_bytes + kv_bytes) / chip.hbm_bytes_s
    wire = (2.0 * 2 * cfg.n_layers * n_slots * cfg.d_model
            * 2 * (tp_size - 1) / max(tp_size, 1)) if tp_size > 1 else 0.0
    wire *= (2 * spec_k + 1) if spec_k else 1
    collective_s = wire / chip.ici_bytes_s

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "step_s": max(terms.values()),
            "dominant": dominant,
            # raw byte counters for the serving benches: per-shard HBM
            # traffic of one decode step (weights + KV, and the KV share
            # alone — the decode-attention bytes gate compares kv_hbm_bytes
            # against the measured cache inventory) and the tp all-reduce
            # wire bytes
            "hbm_bytes": w_bytes + draft_bytes + kv_bytes,
            "kv_hbm_bytes": kv_bytes, "draft_hbm_bytes": draft_bytes,
            "wire_bytes": wire}


def suggest_prefill_chunk(cfg: ModelConfig, n_slots: int, *,
                          cache_tokens: int = 0, tp_size: int = 1,
                          avg_weight_bits: float = 8.0,
                          kv_bits: float = 16.0,
                          kv_attend: str = "fused",
                          w_bits_total: Optional[float] = None,
                          spec_k: int = 0,
                          draft_w_bits: float = 2.0,
                          chip: ChipSpec = DEFAULT_CHIP,
                          min_chunk: int = 16, max_chunk: int = 512) -> int:
    """Prefill-token budget per engine iteration, from the decode roofline.

    A decode step is HBM/ICI-bound: the weights (and tp activations) move
    regardless of how much compute rides along. Prefill tokens are compute
    bound and reuse the same weight traffic, so the headroom between the
    decode step's memory/collective ceiling and its compute term is "free"
    prefill compute. The chunk is that headroom divided by the per-token
    prefill compute time, clamped to [min_chunk, max_chunk] so admission
    neither starves (tiny models: huge headroom) nor stalls decode (big
    models: none).

    ``spec_k > 0`` budgets a self-speculative engine honestly: one
    iteration is then a whole draft-k/verify-once round
    (``decode_step_cost(spec_k=...)``), whose compute term is
    ``2 * spec_k + 1`` token-passes — the headroom that can carry prefill
    per iteration shrinks or grows with the round shape, not with the
    single-token step the engine no longer runs.
    """
    cost = decode_step_cost(cfg, n_slots, cache_tokens=cache_tokens,
                            tp_size=tp_size, avg_weight_bits=avg_weight_bits,
                            kv_bits=kv_bits, kv_attend=kv_attend,
                            w_bits_total=w_bits_total, spec_k=spec_k,
                            draft_w_bits=draft_w_bits, chip=chip)
    ceiling = max(cost["memory_s"], cost["collective_s"])
    headroom_s = max(ceiling - cost["compute_s"], 0.0)
    from repro_torch.models import lm
    macs = sum(q.macs_per_token * q.n_mats for q in lm.enumerate_qlayers(cfg))
    per_token_s = 2.0 * macs / max(tp_size, 1) / chip.peak_flops
    chunk = int(headroom_s / per_token_s) if per_token_s > 0 else max_chunk
    return max(min_chunk, min(max_chunk, chunk))


def report(arch: str, shape: ShapeSpec, mesh_label: str, n_chips: int,
           costs, cfg: Optional[ModelConfig] = None,
           chip: ChipSpec = DEFAULT_CHIP) -> RooflineReport:
    """Build the three-term roofline from a per-device cost object
    (``flops``, ``bytes_hbm``, ``wire_bytes``)."""
    compute_s = costs.flops / chip.peak_flops
    memory_s = costs.bytes_hbm / chip.hbm_bytes_s
    collective_s = costs.wire_bytes / chip.ici_bytes_s
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_time_s = max(terms.values())

    mft = model_flops(cfg, shape) if cfg is not None else 0.0
    executed_total = costs.flops * max(n_chips, 1)
    useful_ratio = mft / executed_total if executed_total else 0.0
    denom = step_time_s * max(n_chips, 1) * chip.peak_flops
    mfu = mft / denom if denom else 0.0

    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_label, n_chips=n_chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, step_time_s=step_time_s,
        model_flops_total=mft, useful_ratio=useful_ratio, mfu=mfu)
