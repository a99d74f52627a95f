"""The large decoders through the port's serve CLI on the CPU: the
site-by-site build (``lm.site_source``, ``serve --site-by-site``) of
deepseek-moe-16b, mixtral-8x7b, granite-20b and yi-9b at their smoke
configs, the whole-tree fit check at their full configs (counted on
``meta``, nothing allocated), and their demo policies' bytes.

Exactness: inside the port every comparison is bit for bit (atol 0): the
same seeded draws, packed the same way, give the same codes, scales and
logits whichever way the tree was put together. The demo policy json is
held equal to the JAX package's.
"""
import json

import pytest
import torch
import _torch_threads  # noqa: F401

from repro_torch.configs import get_config as t_get
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.runtime import packing

ARCHS = ["deepseek-moe-16b", "mixtral-8x7b", "granite-20b", "yi-9b"]
# demo_mixed_policy's packed weight bytes at the full configs; no width
# needs padding, so the card packs exactly these
PACKED_BYTES = {"deepseek-moe-16b": 7_967_162_368,
                "mixtral-8x7b": 23_155_703_808,
                "granite-20b": 9_798_942_720,
                "yi-9b": 4_150_001_664}
CARD = 80 * 10 ** 9
SEED = 3


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _leaves(v, f"{pre}/{k}")]
    return [(pre, tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), k


def _assert_packed_equal(a, b):
    la, lb = packing.packed_leaves(a.params), packing.packed_leaves(b.params)
    assert len(la) == len(lb) == len(a.qlayers)
    for pa, pb in zip(la, lb):
        assert torch.equal(pa.codes, pb.codes)
        assert torch.equal(pa.scale, pb.scale)
        assert torch.equal(pa.s_a, pb.s_a)
    assert a.packed_bytes() == b.packed_bytes()


def _whole_tree(cfg, outer, source):
    """The tree ``init_params`` lays out, put together from ``source``'s
    sites: the prefix and suffix sites as they are, each body slot's units
    stacked on a leading axis."""
    tree = {k: v for k, v in outer.items()
            if k not in ("prefix", "body", "suffix")}
    seg = {"prefix": {}, "body": {}, "suffix": {}}
    for site in tlm.iter_sites(cfg):
        name, idx = site.segment.split(".")
        p = source(site)
        if name == "body":
            seg["body"].setdefault(idx, []).append(p)
        else:
            seg[name][idx] = p

    def stack(ps):
        if isinstance(ps[0], dict):
            return {k: stack([p[k] for p in ps]) for k in ps[0]}
        return torch.stack(ps)

    seg["body"] = {k: stack(v) for k, v in seg["body"].items()}
    tree.update(seg)
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_site_source_makes_the_inline_draws(arch):
    """``lm.site_source`` draws what the site-by-site build drew inline:
    the prefix-deep tree at ``seed``, then ``layer_init`` for each other
    site in ``iter_sites`` order from one generator seeded ``seed + 1``,
    each site's params handed to ``prep`` first."""
    cfg = t_smoke(arch)
    seen = []
    outer, source = tlm.site_source(cfg, SEED, "cpu", prep=seen.append)
    n_prefix = len(tlm.build_schedule(cfg).prefix)
    want_outer = tlm.init_params(cfg.scaled(n_layers=n_prefix), seed=SEED,
                                 device="cpu")
    _assert_trees_equal(outer, want_outer)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    n_made = 0
    for site in tlm.iter_sites(cfg):
        got = source(site)
        if site.segment.startswith("prefix."):
            want = tlm.site_params(want_outer, site)
        else:
            want = tlm.layer_init(gen, cfg, site.kind, device="cpu")
            assert got is seen[n_made]
            n_made += 1
        _assert_trees_equal(got, want)
    assert n_made == len(seen) == len(tlm.iter_sites(cfg)) - n_prefix


@pytest.mark.parametrize("arch", ARCHS)
def test_site_by_site_session_equals_the_whole_tree_session(arch):
    """A session packed from ``lm.site_source`` holds the codes, scales,
    activation scales and packed bytes of one packed from the whole tree
    put together from the same sites, and serves the same prefill
    logits."""
    cfg = t_smoke(arch)
    policy = tserve.demo_mixed_policy(cfg)
    outer, source = tlm.site_source(cfg, SEED, "cpu")
    a = tserve.build_session(cfg, outer, policy, site_source=source)
    whole = _whole_tree(cfg, *tlm.site_source(cfg, SEED, "cpu"))
    b = tserve.build_session(cfg, whole, policy)
    _assert_packed_equal(a, b)
    toks = torch.arange(3, 3 + 12)[None] % cfg.vocab
    assert torch.equal(a.prefill(a.params, toks, prefill_cap=32)[0],
                       b.prefill(b.params, toks, prefill_cap=32)[0])


def _cli(arch, *flags):
    return tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--seed", str(SEED), *flags])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_site_by_site_serves_the_site_source_model(arch, capsys):
    """``serve --site-by-site`` passes its ``--compare`` gate and packs
    the model ``lm.site_source`` makes at ``--seed``."""
    res = _cli(arch, "--site-by-site")
    assert "token-identical with fixed batch" in capsys.readouterr().out
    assert res["saved"] >= 0
    cfg = t_smoke(arch)
    outer, source = tlm.site_source(cfg, SEED, "cpu")
    want = tserve.build_session(cfg, outer, tserve.demo_mixed_policy(cfg),
                                site_source=source)
    _assert_packed_equal(res["sess"], want)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "yi-9b"])
def test_cli_without_the_flag_serves_the_whole_tree(arch):
    """Without ``--site-by-site`` the CLI packs ``lm.init_params(cfg,
    seed)``, as before the flag existed; the two builds draw different
    weights."""
    res = _cli(arch)
    cfg = t_smoke(arch)
    want = tserve.build_session(cfg, tlm.init_params(cfg, seed=SEED,
                                                     device="cpu"),
                                tserve.demo_mixed_policy(cfg))
    _assert_packed_equal(res["sess"], want)
    outer, source = tlm.site_source(cfg, SEED, "cpu")
    other = tserve.build_session(cfg, outer, tserve.demo_mixed_policy(cfg),
                                 site_source=source)
    assert not all(torch.equal(x.codes, y.codes) for x, y in zip(
        packing.packed_leaves(res["sess"].params),
        packing.packed_leaves(other.params)))


@pytest.mark.parametrize("flags", [["--check"],
                                   ["--elastic", "--policy", "P.json"],
                                   ["--uniform-bits", "4"]])
def test_site_by_site_refuses_what_needs_the_whole_tree(flags, monkeypatch):
    """Each flag that needs the whole float32 tree exits with its reason
    before anything is built."""
    def no_build(*a, **k):
        raise AssertionError("built params before refusing")

    monkeypatch.setattr(tlm, "init_params", no_build)
    monkeypatch.setattr(tlm, "site_source", no_build)
    with pytest.raises(SystemExit, match=f"{flags[0]} needs the whole "
                                         "float32 tree.*--site-by-site"):
        _cli("yi-9b", "--site-by-site", *flags)


@pytest.mark.parametrize("arch,fits", [
    ("mixtral-8x7b", False), ("deepseek-moe-16b", False),
    ("granite-20b", False), ("qwen3-0.6b", True), ("yi-9b", True)])
def test_whole_tree_fit_check_at_full_width(arch, fits):
    """The whole-tree build at the full configs against an 80 GB card,
    counted on ``meta``: deepseek-moe-16b's 65.5 GB tree fits alone, but
    not with its largest leaf (a 19.9 GB expert stack) drawn again beside
    it."""
    cfg = t_get(arch)
    need = tserve.whole_tree_peak_bytes(cfg)
    assert (need <= CARD) == fits
    if fits:
        tserve.check_whole_tree_fits(cfg, CARD)
    else:
        with pytest.raises(ValueError, match="pass --site-by-site"):
            tserve.check_whole_tree_fits(cfg, CARD)
    if arch == "deepseek-moe-16b":
        tree = tlm.param_count(tlm.init_params(cfg, device="meta")) * 4
        assert tree < CARD < need


@pytest.mark.parametrize("arch", ARCHS)
def test_demo_policy_packed_bytes_at_full_width(arch):
    cfg = t_get(arch)
    policy = tserve.demo_mixed_policy(cfg)
    assert policy.size_bytes(tlm.enumerate_qlayers(cfg)) == \
        PACKED_BYTES[arch]


@pytest.mark.parametrize("arch", ["yi-9b", "granite-20b"])
def test_demo_policy_equals_reference_at_full_width(tmp_path, arch):
    pytest.importorskip("jax")
    from repro.configs import get_config as j_get
    from repro.launch import serve as jserve
    jserve.demo_mixed_policy(j_get(arch)).save(str(tmp_path / "j.json"))
    tserve.demo_mixed_policy(t_get(arch)).save(str(tmp_path / "t.json"))
    j = json.load(open(tmp_path / "j.json"))
    t = json.load(open(tmp_path / "t.json"))
    assert t == j
    assert "solve_report" in t["meta"]
