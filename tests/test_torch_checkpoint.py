"""Checkpoints and serving bundles, port against the JAX reference, on the
CPU: the reference's checkpoint cases over the port's manager, checkpoints
and bundles crossing between the packages in both directions with the same
arrays, a reference bundle served by the port, and the train CLI's resume.

Arrays cross bit for bit (the format is the reference's ``arrays.npz``);
packed code bytes are held bit for bit; greedy tokens across frameworks on
decisive steps (top-2 margin above 1e-2: float32 matmuls sum in another
order, and a quantization grid can turn an ulp into a code step).
"""
import copy
import os

import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import checkpoint as jckpt                        # noqa: E402
from repro.configs import smoke_config as j_smoke            # noqa: E402
from repro.core import ilp as jilp                           # noqa: E402
from repro.launch import engine as jeng                      # noqa: E402
from repro.launch import serve as jserve                     # noqa: E402
from repro.launch.scheduler import Request as JRequest       # noqa: E402
from repro.models import lm as jlm                           # noqa: E402
from repro.runtime import packing as jpacking                # noqa: E402
from repro.runtime.session import QuantizedSession as JSess  # noqa: E402
from repro_torch import checkpoint as tckpt                  # noqa: E402
from repro_torch import interop                              # noqa: E402
from repro_torch.configs import smoke_config as t_smoke      # noqa: E402
from repro_torch.core.policy import MPQPolicy as TPolicy     # noqa: E402
from repro_torch.launch import engine as teng                # noqa: E402
from repro_torch.launch import serve as tserve               # noqa: E402
from repro_torch.launch import train as ttrain               # noqa: E402
from repro_torch.launch.scheduler import Request as TRequest  # noqa: E402
from repro_torch.models import lm as tlm                     # noqa: E402
from repro_torch.runtime import packing as tpacking          # noqa: E402
from repro_torch.runtime.session import QuantizedSession as TSess  # noqa: E402

DECISIVE = 1e-2


def _tree(x=1.0):
    return {"a": torch.full((4, 3), x), "nested": {"b": torch.arange(5.0)},
            "scalar": torch.tensor(7, dtype=torch.int32)}


def _leaves(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


@pytest.fixture(scope="module")
def world():
    """limpq-demo smoke params from JAX's init (carried across, never
    re-initialised) and the demo mixed policy, in both packages."""
    jcfg, tcfg = j_smoke("limpq-demo"), t_smoke("limpq-demo")
    jparams = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    tparams = interop.params_from_numpy(jckpt._flatten(jparams), "cpu")
    jpol = jserve.demo_mixed_policy(jcfg)
    tpol = TPolicy.from_json(jpol.to_json())
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jpol=jpol, tpol=tpol)


# ---------------------------------------------------------------------------
# the reference's checkpoint cases (tests/test_checkpoint.py), over the port
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=3)
    t = _tree(2.5)
    mgr.save(10, t, meta={"arch": "x"}, blocking=True)
    assert mgr.latest_step() == 10
    got = mgr.restore(10, _tree(0.0))
    for k, v in _leaves(t).items():
        g = _leaves(got)[k]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g, v), k
    assert mgr.meta(10)["arch"] == "x"


def test_async_and_wait(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(1, _tree(1.0))
    mgr.wait()
    assert mgr.latest_step() == 1


def test_keep_n_gc(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=2)
    for s in range(5):
        mgr.save(s, _tree(float(s)), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_atomicity_tmp_never_visible(tmp_path):
    """A step directory without meta.json (a torn write) is not a step."""
    mgr = tckpt.CheckpointManager(str(tmp_path), keep_n=3)
    os.makedirs(tmp_path / "step_0000000099")
    assert mgr.all_steps() == []
    mgr.save(100, _tree(), blocking=True)
    assert mgr.all_steps() == [100]


def test_shape_mismatch_and_missing_array_raise(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(0, _tree(), blocking=True)
    bad = {"a": torch.zeros((2, 2)), "nested": {"b": torch.zeros(5)},
           "scalar": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(0, bad)
    extra = dict(_tree(), more=torch.zeros(1))
    with pytest.raises(KeyError, match="missing array 'more'"):
        mgr.restore(0, extra)


def test_restore_onto_the_callers_device_from_a_shapes_only_template(
        tmp_path):
    """The port's counterpart of the reference's ``sharding_fn`` restore:
    arrays land on the requested device, and a template on the ``meta``
    device (shapes and dtypes only) serves."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    t = _tree(3.0)
    mgr.save(2, t, blocking=True)
    meta = {"a": torch.empty((4, 3), device="meta"),
            "nested": {"b": torch.empty(5, device="meta")},
            "scalar": torch.empty((), dtype=torch.int32, device="meta")}
    got = mgr.restore(2, meta)
    assert got["a"].device.type == "cpu"
    assert got["scalar"].shape == () and got["scalar"].dtype == torch.int32
    got = mgr.restore(2, meta, device=torch.device("cpu"))
    assert torch.equal(got["a"], t["a"]) and int(got["scalar"]) == 7


def test_snapshot_before_return_survives_in_place_updates(tmp_path):
    """save() copies to host before it returns: an in-place update of the
    source afterwards (as a train loop does) must not reach the files."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    t = {"w": torch.ones(8)}
    mgr.save(5, t)                      # async
    t["w"].mul_(0)                      # updated in place
    t["w"] = t["w"] + 3                 # and rebound
    mgr.wait()
    got = mgr.restore(5, {"w": torch.zeros(8)})
    assert torch.equal(got["w"], torch.ones(8))


def test_watchdog_flags_stragglers():
    wd = tckpt.StepWatchdog(window=16, threshold=2.0)
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(0.5)
    assert wd.flags == 1
    mine, ref = tckpt.StepWatchdog(8, 1.5), jckpt.StepWatchdog(8, 1.5)
    times = [0.1, 0.12, 0.09] * 4 + [0.4, 0.1, 0.25, 0.3, 0.14, 0.5]
    flags = [mine.observe(t) for t in times]
    assert flags == [ref.observe(t) for t in times] and any(flags)


def test_async_write_error_surfaces_on_next_wait(tmp_path, monkeypatch):
    mgr = tckpt.CheckpointManager(str(tmp_path))

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.np, "savez", broken)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()
    mgr.wait()                          # raised once, then clear
    assert mgr.all_steps() == []


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_reference_checkpoint_restores_in_the_port(world, tmp_path):
    jmgr = jckpt.CheckpointManager(str(tmp_path))
    jmgr.save(7, world["jparams"], meta={"arch": "limpq-demo"},
              blocking=True)
    tmgr = tckpt.CheckpointManager(str(tmp_path))
    assert tmgr.latest_step() == 7 and tmgr.meta(7)["arch"] == "limpq-demo"
    got = tmgr.restore(7, tlm.init_params(world["tcfg"], device="meta"))
    want = jckpt._flatten(world["jparams"])
    mine = _leaves(got)
    assert set(mine) == set(want)
    for k, arr in want.items():
        assert mine[k].dtype == torch.float32, k
        np.testing.assert_array_equal(mine[k].numpy(), arr, err_msg=k)


def test_port_checkpoint_restores_in_the_reference(world, tmp_path):
    tmgr = tckpt.CheckpointManager(str(tmp_path))
    tmgr.save(3, world["tparams"], blocking=True)
    jmgr = jckpt.CheckpointManager(str(tmp_path))
    got = jmgr.restore(3, world["jparams"])
    want = jckpt._flatten(world["jparams"])
    flat = jckpt._flatten(got)
    assert set(flat) == set(want)
    for k, arr in want.items():
        assert flat[k].dtype == arr.dtype, k
        np.testing.assert_array_equal(flat[k], arr, err_msg=k)
    # the port writes the reference's keys, for the port's own init too
    tmgr.save(4, tlm.init_params(world["tcfg"], seed=1), blocking=True)
    with np.load(tmp_path / "step_0000000004" / "arrays.npz") as z:
        assert set(z.files) == set(want)


def _packed_by_path_port(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, tpacking.PackedLinear):
            out[pre + k] = v
        elif isinstance(v, dict):
            out.update(_packed_by_path_port(v, f"{pre}{k}/"))
    return out


def _packed_by_path_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=jpacking.is_packed)[0]:
        if jpacking.is_packed(leaf):
            out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    return out


def test_reference_bundle_serves_in_the_port(world, tmp_path):
    """A reference ``save_serving_bundle`` through the port's
    ``QuantizedSession.from_checkpoint``: the policy and its solve report
    come back, the packed codes and scales are the reference session's bit
    for bit, and the greedy tokens equal the reference engine's on decisive
    steps. (The reference cannot promote the report a policy embeds: it
    calls ``to_json()`` on that dict. So it is passed as a report.)"""
    jcfg, tcfg = world["jcfg"], world["tcfg"]
    jpol = copy.deepcopy(world["jpol"])
    report = jilp.SolveReport.from_json(jpol.meta.pop("solve_report"))
    with pytest.raises(AttributeError, match="to_json"):
        jckpt.save_serving_bundle(str(tmp_path / "promoted"), 0,
                                  {"w": jnp.zeros(2)}, world["jpol"])
    jckpt.save_serving_bundle(str(tmp_path), 3, world["jparams"], jpol,
                              extra_meta={"arch": jcfg.name},
                              solve_report=report)
    peek = tckpt.peek_serving_policy(str(tmp_path))
    assert peek.w_bits == world["jpol"].w_bits
    assert tckpt.CheckpointManager(str(tmp_path)).meta(3)["solve_report"] \
        == world["jpol"].meta["solve_report"]
    ts = TSess.from_checkpoint(str(tmp_path), tcfg, device="cpu")
    js = JSess(jcfg, world["jparams"], world["jpol"], kv_quant="int8")
    tp, jp = _packed_by_path_port(ts.params), _packed_by_path_jax(js.params)
    assert set(tp) == set(jp) and len(tp) == len(world["tpol"].w_bits)
    for k, pl in tp.items():
        assert (pl.w_bits, pl.layout) == (jp[k].w_bits, jp[k].layout), k
        np.testing.assert_array_equal(pl.codes.numpy(),
                                      np.asarray(jp[k].codes), err_msg=k)
        np.testing.assert_array_equal(pl.scale.numpy(),
                                      np.asarray(jp[k].scale), err_msg=k)
    assert ts.packed_bytes() == js.packed_bytes()

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, 8 + 2 * i).astype(np.int32)
               for i in range(3)]
    gens = [5, 3, 4]
    je = jeng.DecodeEngine(js.params, jcfg, None, js.ctx, adapter=js,
                           ecfg=jeng.EngineConfig(slots=2, cache_len=24,
                                                  prefill_chunk=16,
                                                  kv_quant="int8",
                                                  trace=False))
    je.submit_all([JRequest(i, p, g) for i, (p, g) in
                   enumerate(zip(prompts, gens))])
    jout = je.run()
    te = teng.DecodeEngine(ts.params, tcfg, None, ts.ctx, adapter=ts,
                           device="cpu",
                           ecfg=teng.EngineConfig(slots=2, cache_len=24,
                                                  prefill_chunk=16,
                                                  kv_quant="int8"))
    te.submit_all([TRequest(i, p, g) for i, (p, g) in
                   enumerate(zip(prompts, gens))])
    tout = te.run()
    compared = 0
    for rid, c in tout.items():
        n, miss = teng.decisive_prefix(jout[rid].tokens, c.tokens,
                                       te.margins[rid], DECISIVE)
        assert miss is None, (rid, jout[rid].tokens, c.tokens)
        compared += n
    assert compared >= len(gens)


def test_port_bundle_round_trips_and_serves_as_the_in_memory_session(
        world, tmp_path):
    tcfg = world["tcfg"]
    tckpt.save_serving_bundle(str(tmp_path), 0, world["tparams"],
                              world["tpol"])
    mem = TSess(tcfg, world["tparams"], world["tpol"])
    disk = TSess.from_checkpoint(str(tmp_path), tcfg)
    tp, mp = _packed_by_path_port(disk.params), _packed_by_path_port(
        mem.params)
    assert set(tp) == set(mp)
    for k in tp:
        assert torch.equal(tp[k].codes, mp[k].codes), k
    # and the reference reads the port's bundle
    jparams, jpol, meta = jckpt.load_serving_bundle(
        str(tmp_path), world["jparams"])
    assert jpol.w_bits == world["jpol"].w_bits
    assert meta["solve_report"] == world["tpol"].meta["solve_report"]
    for k, arr in jckpt._flatten(jparams).items():
        np.testing.assert_array_equal(
            arr, jckpt._flatten(world["jparams"])[k], err_msg=k)


def test_from_checkpoint_validates_before_restore(world, tmp_path):
    """A bundle restored against another arch fails with the policy's
    ``validate`` message, before any array is read."""
    tckpt.save_serving_bundle(str(tmp_path), 0, world["tparams"],
                              world["tpol"])
    os.remove(tmp_path / "step_0000000000" / "arrays.npz")
    with pytest.raises(ValueError, match="does not match"):
        TSess.from_checkpoint(str(tmp_path), t_smoke("rwkv6-7b"))
    tckpt.CheckpointManager(str(tmp_path / "plain")).save(
        1, _tree(), blocking=True)
    with pytest.raises(KeyError, match="not a serving bundle"):
        tckpt.peek_serving_policy(str(tmp_path / "plain"))
    with pytest.raises(FileNotFoundError):
        tckpt.peek_serving_policy(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# the train CLI: checkpoints and resume
# ---------------------------------------------------------------------------
def test_train_cli_resumes_at_latest_plus_one_with_the_saved_params(
        tmp_path, capsys):
    d = str(tmp_path / "ckpt")
    argv = ["--smoke", "--device", "cpu", "--mode", "qat", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", d,
            "--ckpt-every", "2"]
    first = ttrain.main(argv + ["--steps", "3"])
    mgr = tckpt.CheckpointManager(d)
    assert mgr.all_steps() == [1, 2]
    assert mgr.meta(2) == {"arch": "limpq-demo-smoke", "mode": "qat",
                           "step": 2}
    capsys.readouterr()
    # nothing left to run: the restored params come back bit for bit
    again = ttrain.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     " not in out
    saved = _leaves(mgr.restore(2, again))
    for k, v in _leaves(first).items():
        assert torch.equal(_leaves(again)[k], v), k
        assert torch.equal(saved[k], v), k
    # one more step: it runs step 3 only, from the saved params
    ttrain.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "step     3" in out and "step     2" not in out
    assert mgr.all_steps() == [1, 2, 3]


def test_train_e2e_example_resumes_after_its_checkpoint(tmp_path, capsys):
    """``examples/train_e2e_torch.py`` on the CPU: importance, search and 4
    QAT steps with a checkpoint every 2; run again to 6 steps, it reads the
    searched policy back, restores step 3 and runs steps 4-5 only."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / \
        "train_e2e_torch.py"
    spec = importlib.util.spec_from_file_location("train_e2e_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt",
              ckpt, "--ckpt-every", "2", "--log-every", "1"]
    mod.main(common + ["--steps", "4"])
    first = capsys.readouterr().out
    assert "phase 2: ILP" in first and "resumed" not in first
    assert all(f"step {s:4d} loss" in first for s in range(4))
    mgr = tckpt.CheckpointManager(ckpt)
    assert mgr.all_steps() == [1, 3]
    saved = tckpt._flatten(mgr.restore(3, tlm.init_params(
        t_smoke("qwen3-0.6b"), seed=1)))
    mod.main(common + ["--steps", "6"])
    second = capsys.readouterr().out
    assert "phases 1-2: the searched policy" in second
    assert "phase 2: ILP" not in second
    assert "resumed from step 3" in second
    assert [f"step {s:4d} loss" in second for s in range(6)] == \
        [False] * 4 + [True] * 2
    assert mgr.all_steps() == [3, 5]
    resumed = tckpt._flatten(mgr.restore(3, tlm.init_params(
        t_smoke("qwen3-0.6b"), seed=1)))
    assert all(np.array_equal(saved[k], resumed[k]) for k in saved)
