"""Deterministic synthetic data pipeline.

No dataset ships with the repo (DESIGN.md §8), so the pipeline generates
seeded synthetic batches with *learnable structure* (a QAT loss that cannot
go below entropy of noise would make every indicator identical):

* token streams: Zipf unigram base + a first-order Markov "grammar" derived
  from a seeded random transition table + motif copying. CE starts near
  ln(vocab) and drops as the model learns the transitions.
* audio frames: smoothed Gaussian features; labels are a fixed random
  projection argmax of the features — a deterministic learnable mapping.
* vision stub: seeded patch embeddings.

Every sample is generated *state-free* from (seed, step, global_index):
skip-to-any-step is O(1) (straggler/elastic restart needs no replay), and
hosts materialize only their own slice of the global batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig

# input widths of the stub frontends (a copy of ``models.lm.FRONTEND_DIMS``
# in the JAX package, kept here so this module imports no model code)
FRONTEND_DIMS = {"audio_stub": 512, "vision_stub": 1280, "none": 0}


def _rs(*key_ints) -> np.random.Generator:
    # Philox wants a 2- or 4-element key; fold arbitrary ints into 2 words.
    k0 = k1 = np.uint64(0x9E3779B97F4A7C15)
    for i, k in enumerate(key_ints):
        w = np.uint64(k % (2 ** 63))
        if i % 2 == 0:
            k0 = np.uint64((int(k0) * 6364136223846793005 + int(w)) % 2 ** 64)
        else:
            k1 = np.uint64((int(k1) * 1442695040888963407 + int(w)) % 2 ** 64)
    return np.random.Generator(np.random.Philox(key=np.asarray([k0, k1])))


@dataclass(frozen=True)
class DataConfig:
    seed: int = 17
    zipf_a: float = 1.3
    markov_weight: float = 0.7     # prob of following the "grammar"
    n_states: int = 64             # grammar order (transition table rows)


class SyntheticLM:
    """Deterministic synthetic corpus for one ModelConfig."""

    def __init__(self, cfg: ModelConfig, dcfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.dcfg = dcfg
        V = cfg.vocab
        g = _rs(dcfg.seed, 0xC0FFEE)
        # Zipf base distribution over the vocab
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = ranks ** (-dcfg.zipf_a)
        self.base_p = p / p.sum()
        # seeded Markov grammar: state = token % n_states
        self.trans = g.integers(0, V, size=(dcfg.n_states, 8))
        # audio label projection
        if cfg.frontend == "audio_stub":
            self.audio_proj = g.standard_normal(
                (FRONTEND_DIMS["audio_stub"], min(V, 504))).astype(np.float32)

    # -- samples ------------------------------------------------------------
    def _tokens(self, step: int, gidx: int, S: int) -> np.ndarray:
        g = _rs(self.dcfg.seed, step, gidx)
        V = self.cfg.vocab
        base = g.choice(V, size=S + 1, p=self.base_p)
        out = np.empty(S + 1, np.int64)
        out[0] = base[0]
        follow = g.random(S + 1) < self.dcfg.markov_weight
        pick = g.integers(0, self.trans.shape[1], size=S + 1)
        for t in range(1, S + 1):
            if follow[t]:
                out[t] = self.trans[out[t - 1] % self.dcfg.n_states, pick[t]]
            else:
                out[t] = base[t]
        return out[:S].astype(np.int32)

    def _audio(self, step: int, gidx: int, S: int):
        g = _rs(self.dcfg.seed, step, gidx, 0xA0D10)
        F = FRONTEND_DIMS["audio_stub"]
        x = g.standard_normal((S + 4, F)).astype(np.float32)
        x = 0.5 * (x[:S] + x[2:S + 2] + x[4:S + 4])    # temporal smoothing
        labels = (x @ self.audio_proj).argmax(-1).astype(np.int32)
        return x, labels

    def _img(self, step: int, gidx: int):
        g = _rs(self.dcfg.seed, step, gidx, 0x1A6E)
        return g.standard_normal(
            (self.cfg.n_image_tokens, FRONTEND_DIMS["vision_stub"])
        ).astype(np.float32)

    # -- batches ------------------------------------------------------------
    def batch(self, step: int, batch_size: int, seq_len: int, *,
              host_id: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
        assert batch_size % n_hosts == 0, (batch_size, n_hosts)
        per = batch_size // n_hosts
        gidx = range(host_id * per, (host_id + 1) * per)
        cfg = self.cfg
        if cfg.frontend == "audio_stub":
            pairs = [self._audio(step, i, seq_len) for i in gidx]
            return {"feats": np.stack([p[0] for p in pairs]),
                    "labels": np.stack([p[1] for p in pairs])}
        out = {"tokens": np.stack([self._tokens(step, i, seq_len)
                                   for i in gidx])}
        if cfg.family == "vlm":
            out["img"] = np.stack([self._img(step, i) for i in gidx])
        return out

    def batches(self, n_steps: int, batch_size: int, seq_len: int,
                start_step: int = 0, **kw) -> Iterator[Dict[str, np.ndarray]]:
        for s in range(start_step, start_step + n_steps):
            yield self.batch(s, batch_size, seq_len, **kw)
