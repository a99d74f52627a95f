"""Fault-tolerant checkpointing, in the reference package's on-disk format.

* **Format** -- a step is ``<dir>/step_<n:010d>/`` holding ``arrays.npz``
  (one array per leaf, keyed by its "/"-joined tree path, e.g.
  ``body/0/wq/s_w``, the keys ``interop.params_from_numpy`` reads) and
  ``meta.json``. A checkpoint written by either package restores in the
  other with the same arrays.
* **Atomicity** -- arrays are written to ``<dir>/tmp.<step>``, the meta is
  fsync'd, and the directory is ``os.rename``d to ``step_<n>``: a reader
  never sees a torn checkpoint (a step without ``meta.json`` is not one).
* **Async** -- ``save`` copies every tensor to host numpy before it
  returns, so a train loop that updates its params in place cannot change
  what is written; a writer thread then does the I/O, and ``wait()`` joins
  it and raises its error.
* **Keep-N GC** -- old steps are removed after a successful save.
* **Restore** -- onto the caller's ``device``. The template gives only
  structure, shapes and dtypes, so a shapes-only tree (``lm.init_params``
  on the ``meta`` device) serves. Placing arrays onto a mesh (the
  reference's ``sharding_fn``) waits for the port's distributed layer.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _flatten(tree, pre: str = "") -> Dict[str, np.ndarray]:
    """Host copies (never views of the caller's storage) of a nested dict
    of tensors, keyed by their "/"-joined paths; an empty dict has no
    arrays."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{pre}{k}/"))
        else:
            flat[pre + str(k)] = v.detach().to("cpu", copy=True).numpy()
    return flat


def _unflatten(template, flat: Dict[str, np.ndarray], device=None):
    """``template``'s tree with each leaf replaced by its array from
    ``flat``, cast to the template leaf's dtype, as a tensor on ``device``
    (None: the template leaf's device, the CPU for a ``meta`` leaf)."""
    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = flat[key]
        shape = tuple(node.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                f"template {shape}")
        dev = device
        if dev is None:
            dev = "cpu" if node.device.type == "meta" else node.device
        np_dtype = torch.empty((), dtype=node.dtype).numpy().dtype
        return torch.from_numpy(arr.astype(np_dtype, order="C")).to(dev)

    return build(template, ())


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree, *, meta: Optional[dict] = None,
             blocking: bool = False):
        """Snapshot now (host copies of every leaf), write asynchronously
        (unless blocking)."""
        self.wait()
        flat = _flatten(tree)
        meta = dict(meta or {})
        meta["step"] = int(step)

        def _write():
            try:
                tmp = os.path.join(self.dir, f"tmp.{step}")
                final = os.path.join(self.dir, f"step_{step:010d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)    # atomic publish
                self._gc()
            except BaseException as e:   # surfaced on the next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read ---------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                if os.path.exists(os.path.join(self.dir, name, "meta.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template, *, device=None):
        """``template``'s tree from step ``step``, each array as a tensor on
        ``device`` (None: its template leaf's device, the CPU for a shapes-
        only ``meta`` template)."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat, device)

    def meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:010d}", "meta.json")
        with open(path) as f:
            return json.load(f)


# ---------------------------------------------------------------------------
# serving bundles: params + searched policy in one atomic checkpoint
# ---------------------------------------------------------------------------
def save_serving_bundle(directory: str, step: int, params,
                        policy, *, extra_meta: Optional[dict] = None,
                        solve_report: Optional[Any] = None,
                        keep_n: int = 3) -> None:
    """Checkpoint trained params together with the searched ``MPQPolicy``
    (stored in the step's meta.json), so serving restores a deployable
    (params, policy) pair from one atomic artifact.

    ``solve_report`` (a ``core.ilp.SolveReport``, or its ``to_json()``
    string) rides along as ``meta["solve_report"]``, the ILP audit trail
    ``serve --explain-policy`` renders; when omitted, a report embedded in
    ``policy.meta["solve_report"]`` by ``search_policy`` is promoted into
    the bundle meta. That embedded report is already ``to_json()``'s dict,
    and is stored as it is (the reference calls ``to_json()`` on it and
    fails)."""
    meta = dict(extra_meta or {})
    meta["mpq_policy"] = policy.to_json()
    if solve_report is None:
        solve_report = getattr(policy, "meta", {}).get("solve_report")
    if solve_report is not None:
        meta["solve_report"] = (solve_report
                                if isinstance(solve_report, (str, dict))
                                else solve_report.to_json())
    mgr = CheckpointManager(directory, keep_n=keep_n)
    mgr.save(step, params, meta=meta, blocking=True)


def _bundle_policy_meta(directory: str, step: Optional[int]):
    from repro_torch.core.policy import MPQPolicy

    mgr = CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    meta = mgr.meta(step)
    if "mpq_policy" not in meta:
        raise KeyError(
            f"checkpoint step {step} in {directory!r} has no 'mpq_policy' "
            "meta entry -- not a serving bundle")
    return mgr, step, MPQPolicy.from_json(meta["mpq_policy"]), meta


def peek_serving_policy(directory: str, *, step: Optional[int] = None):
    """Just the ``MPQPolicy`` of a serving bundle (meta.json only, no array
    I/O): deployment code validates a bundle against its model config
    before it pays for the param restore."""
    return _bundle_policy_meta(directory, step)[2]


def load_serving_bundle(directory: str, template, *, step: Optional[int] = None,
                        device=None,
                        validate: Optional[Callable[[Any], Any]] = None):
    """Restore ``(params, policy, meta)`` saved by ``save_serving_bundle``
    (``step=None``: the latest step), the params on ``device``.
    ``validate(policy)`` runs BEFORE the array restore, so a stale or
    foreign bundle fails on the policy's message rather than a missing-
    array error."""
    mgr, step, policy, meta = _bundle_policy_meta(directory, step)
    if validate is not None:
        validate(policy)
    params = mgr.restore(step, template, device=device)
    return params, policy, meta


class StepWatchdog:
    """Straggler detection: tracks step wall-times and flags outliers (a
    step slower than ``threshold`` times the median of the last ``window``
    steps, once eight are seen)."""

    def __init__(self, window: int = 32, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.flags = 0

    def observe(self, dt: float) -> bool:
        hist = self.times[-self.window:]
        slow = bool(hist) and len(hist) >= 8 and \
            dt > self.threshold * float(np.median(hist))
        self.times.append(dt)
        if slow:
            self.flags += 1
        return slow
