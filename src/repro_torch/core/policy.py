"""MPQPolicy: the searched per-layer (b_w, b_a) assignment.

The policy is the artifact Eq. 3 produces. It serializes to JSON (deployable
per device, paper §4.3's `z`-device scenario) and converts into the stacked
per-segment bit-index arrays the scanned model consumes.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core import qspec
from repro_torch.core.qspec import QLayer


@dataclass
class MPQPolicy:
    w_bits: Dict[str, int]
    a_bits: Dict[str, int]
    meta: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if set(self.w_bits) != set(self.a_bits):
            raise ValueError("w_bits / a_bits must cover identical layers")

    # -- constructors ------------------------------------------------------
    @staticmethod
    def uniform(qlayers: Sequence[QLayer], bw: int, ba: int | None = None) -> "MPQPolicy":
        ba = bw if ba is None else ba
        return MPQPolicy({q.name: bw for q in qlayers},
                         {q.name: ba for q in qlayers},
                         meta={"kind": "uniform", "bw": bw, "ba": ba})

    @staticmethod
    def from_choice(qlayers: Sequence[QLayer], choice: np.ndarray,
                    bits: Sequence[int], meta=None) -> "MPQPolicy":
        """Decode an MCKP choice column (index into the (bw, ba) product)."""
        n = len(bits)
        w, a = {}, {}
        for q, c in zip(qlayers, choice):
            i, j = divmod(int(c), n)
            w[q.name] = int(bits[i])
            a[q.name] = int(bits[j])
        return MPQPolicy(w, a, meta=dict(meta or {}))

    # -- accounting --------------------------------------------------------
    def bitops(self, qlayers: Sequence[QLayer], n_tokens: int) -> float:
        return qspec.total_bitops(qlayers, self.w_bits, self.a_bits, n_tokens)

    def size_bytes(self, qlayers: Sequence[QLayer],
                   per_shard: int = 1) -> float:
        """Weight-storage bytes of this policy; ``per_shard=tp`` states the
        same accounting per tensor-parallel shard, so an ILP memory budget
        (or the serve smoke's per-chip gate) can be phrased against one
        device's HBM instead of the replicated total."""
        total = qspec.total_size_bytes(qlayers, self.w_bits)
        return total / max(int(per_shard), 1)

    def avg_bits(self) -> Tuple[float, float]:
        return (float(np.mean(list(self.w_bits.values()))),
                float(np.mean(list(self.a_bits.values()))))

    # -- model-facing view -------------------------------------------------
    def bit_index_arrays(self, qlayers: Sequence[QLayer],
                         bits: Sequence[int]) -> Dict[Tuple[str, Tuple[str, ...]], Dict[str, np.ndarray]]:
        """Per stacked-tensor arrays of bank indices, ordered by unit."""
        lut = {int(b): i for i, b in enumerate(bits)}
        out = {}
        for key, group in qspec.group_by_segment(qlayers).items():
            out[key] = {
                "w": np.asarray([lut[self.w_bits[q.name]] for q in group], np.int32),
                "a": np.asarray([lut[self.a_bits[q.name]] for q in group], np.int32),
            }
        return out

    # -- deployment-time validation ----------------------------------------
    def validate(self, qlayers: Sequence[QLayer],
                 bits: Sequence[int] | None = None,
                 family: str | None = None) -> "MPQPolicy":
        """Check this policy covers exactly the model's QLayers (and, when
        ``bits`` is given, only searched bit-widths). A stale policy file —
        renamed layers, different depth, foreign arch — fails loudly here
        instead of silently mis-dispatching in the serving runtime.

        ``family`` is the served indicator-bank fingerprint
        (``runtime.session.bank_fingerprint``): a policy stamped with
        ``meta["indicator_family"]`` from a *different* training fails,
        because its importances — and hence its bit assignment — were
        learned against scales the served checkpoint does not have. An
        unstamped policy passes for back-compat with pre-bank files."""
        names = {q.name for q in qlayers}
        covered = set(self.w_bits) & set(self.a_bits)
        unknown = sorted((set(self.w_bits) | set(self.a_bits)) - names)
        missing = sorted(names - covered)
        problems = []
        if unknown:
            problems.append(f"unknown layer names {unknown[:5]}"
                            + (f" (+{len(unknown) - 5} more)"
                               if len(unknown) > 5 else ""))
        if missing:
            problems.append(f"missing layer names {missing[:5]}"
                            + (f" (+{len(missing) - 5} more)"
                               if len(missing) > 5 else ""))
        if bits is not None:
            allowed = {int(b) for b in bits}
            bad = sorted({b for b in list(self.w_bits.values())
                          + list(self.a_bits.values())
                          if int(b) not in allowed})
            if bad:
                problems.append(f"bit-widths {bad} outside searched set "
                                f"{sorted(allowed)}")
        if family is not None:
            stamp = self.meta.get("indicator_family")
            if stamp is not None and str(stamp) != str(family):
                problems.append(
                    f"indicator-bank family {str(stamp)!r} != the served "
                    f"checkpoint's fingerprint {str(family)!r} (searched "
                    "from a different training)")
        if problems:
            raise ValueError(
                "MPQPolicy does not match this model's layer table: "
                + "; ".join(problems)
                + ". Was the policy searched for a different arch/config?")
        return self

    # -- serialization -----------------------------------------------------
    SCHEMA_VERSION = 1

    def to_json(self) -> str:
        return json.dumps({"schema": self.SCHEMA_VERSION,
                           "w_bits": self.w_bits, "a_bits": self.a_bits,
                           "meta": self.meta}, indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "MPQPolicy":
        d = json.loads(s)
        schema = int(d.get("schema", 0))   # 0 = pre-versioning files
        if schema > MPQPolicy.SCHEMA_VERSION:
            raise ValueError(
                f"MPQPolicy schema {schema} is newer than this build "
                f"supports ({MPQPolicy.SCHEMA_VERSION}); refusing to guess "
                "at its layout")
        return MPQPolicy(dict(d["w_bits"]), dict(d["a_bits"]), d.get("meta", {}))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "MPQPolicy":
        with open(path) as f:
            return MPQPolicy.from_json(f.read())
