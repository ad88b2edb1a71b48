"""Port parity for the MoE families: llama4-scout-17b-a16e (GQA 40:8 on
the flash-attention seam, top-1 sigmoid routing, per-row gather-only
dispatch, one shared expert) and deepseek-v2-236b (MLA with naive and
absorbed decode, top-k softmax routing, sort-based global dispatch, a
dense first layer).

Each runs at ``smoke_variant`` size. ``repro``'s parameters are carried
across with ``params_from_numpy`` (or, for one layer, converted leaf by
leaf); inputs are made with numpy and handed to both packages. Routing
is asserted before any output, so that a flipped expert choice shows as
a flip: expert ids equal exactly, router weights and MoE outputs within
1e-5, the load-balance loss within 1e-6, MLA within 1e-4, logits and
``aux`` within 1e-4, greedy tokens identical.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke_variant
from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import ffn as jffn
from repro.models import model as jlm
from repro.models.common import ModelConfig as JModelConfig
from repro.serve import engine as jengine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import model as tlm
from repro_torch.models.common import ModelConfig
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4
MOE_TOL, AUX_TOL = 1e-5, 1e-6
MOE_ARCHS = ["llama4-scout-17b-a16e", "deepseek-v2-236b"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _to_torch(jtree):
    return jax.tree_util.tree_map(_t, jtree)


def _build(arch, seed=0):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_model(request):
    return _build(request.param)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# -- configs ---------------------------------------------------------------

def test_arch_ids_are_repros_but_xlstm():
    assert ARCH_IDS == [a for a in JARCH_IDS if a != "xlstm-1.3b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_configs_and_plans_match_repro(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (smoke_variant(get_config(arch)),
                       jsmoke_variant(jget_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert [dataclasses.astuple(s) for s in tlm.layer_plan(port)] == \
            [dataclasses.astuple(s) for s in jlm.layer_plan(ref)]
        assert port.source


def test_config_fields_as_assigned():
    """tests/test_arch_smoke.py's expectations for the two MoE models."""
    ds, l4 = get_config("deepseek-v2-236b"), get_config("llama4-scout-17b-a16e")
    assert (ds.n_layers, ds.d_model, ds.n_heads, ds.n_kv_heads, ds.d_ff,
            ds.vocab_size) == (60, 5120, 128, 128, 12288, 102400)
    assert (l4.n_layers, l4.d_model, l4.n_heads, l4.n_kv_heads, l4.d_ff,
            l4.vocab_size) == (48, 5120, 40, 8, 8192, 202048)
    assert ds.use_mla and ds.kv_lora_rank == 512 and ds.n_experts == 160
    assert ds.moe_top_k == 6 and ds.n_shared_experts == 2
    assert ds.first_k_dense == 1 and not ds.moe_local_dispatch
    assert l4.n_experts == 16 and l4.moe_top_k == 1
    assert l4.router_type == "sigmoid" and l4.moe_local_dispatch
    for arch in MOE_ARCHS:
        cfg = smoke_variant(get_config(arch))
        assert cfg.n_layers == 2 and cfg.d_model <= 512 and cfg.n_experts <= 4


def test_layer_plan_and_params_tree():
    """deepseek's dense first layer is a list, its MoE layers a stacked
    segment; params_from_numpy checks both."""
    jcfg, jparams, cfg, params = _build("deepseek-v2-236b")
    assert [(s.kind, s.count, s.scanned) for s in tlm.layer_plan(cfg)] == \
        [("moe_dense", 1, False), ("moe", 1, True)]
    dense, moe = params["segments"]
    assert isinstance(dense, list) and len(dense) == 1
    d_ff = cfg.moe_d_ff * (cfg.n_shared_experts + cfg.moe_top_k) \
        if not cfg.d_ff else cfg.d_ff
    assert tuple(dense[0]["ffn"]["w_gate"].shape) == (cfg.d_model, d_ff)
    assert set(dense[0]["attn"]) == set(jparams["segments"][0][0]["attn"])
    assert tuple(moe["moe"]["w_gate"].shape) == (
        1, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert tuple(moe["moe"]["shared"]["w_down"].shape) == (
        1, cfg.moe_d_ff * cfg.n_shared_experts, cfg.d_model)
    mine, ref = [], jax.tree_util.tree_leaves(
        jlm.init_model(jcfg, jax.random.PRNGKey(1)))
    tlm.tree_map(lambda t: mine.append(tuple(t.shape)),
                 tlm.init_model(cfg, torch.Generator().manual_seed(1), CPU))
    assert sorted(mine) == sorted(tuple(leaf.shape) for leaf in ref)

    tree = jax.tree_util.tree_map(np.asarray, jparams)
    with pytest.raises(ValueError, match="list of 1"):
        tlm.params_from_numpy(cfg, dict(tree, segments=[
            tree["segments"][0] * 2, tree["segments"][1]]), CPU)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["segments"][1]["moe"]["w_up"] = bad["segments"][1]["moe"]["w_up"][0]
    with pytest.raises(ValueError, match=r"\['w_up'\]: shape"):
        tlm.params_from_numpy(cfg, bad, CPU)


def test_stacked_init_draws_as_tree_stack():
    cfg = smoke_variant(get_config("llama4-scout-17b-a16e"))

    def layer(gen):
        return lambda: tlm.init_layer(cfg, gen, CPU, "moe")

    got = tlm.stacked_init(layer(torch.Generator().manual_seed(3)), 3)
    gen = torch.Generator().manual_seed(3)
    want = tlm.tree_stack([layer(gen)() for _ in range(3)])
    for g, w in zip(tlm.tree_leaves(got), tlm.tree_leaves(want)):
        assert torch.equal(g, w)


# -- router, load-balance loss, dispatch -----------------------------------

def _mini(**kw):
    base = dict(name="t", arch_type="dense", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64)
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


@pytest.mark.parametrize("router,k", [("softmax", 2), ("softmax", 3),
                                      ("sigmoid", 1)])
def test_router_and_aux_match_repro(router, k):
    cfg, jcfg = _mini(n_experts=8, moe_top_k=k, moe_d_ff=16,
                      router_type=router)
    logits = np.random.default_rng(4).normal(size=(2, 5, 8))
    w, idx = tffn.router_probs(cfg, _t(logits))
    jw, jidx = jffn.router_probs(jcfg, jnp.array(logits, jnp.float32))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, MOE_TOL)
    if router == "softmax":
        _close(w.sum(-1), np.ones((2, 5)), MOE_TOL)
        assert bool((w >= 0).all())
    aux = tffn.aux_load_balance_loss(cfg, _t(logits), idx)
    _close(aux, jffn.aux_load_balance_loss(jcfg, jnp.array(logits,
                                                           jnp.float32),
                                           jidx), AUX_TOL)


def test_router_sigmoid_top1_is_half_at_zero_logits():
    cfg, _ = _mini(n_experts=8, moe_top_k=1, moe_d_ff=16,
                   router_type="sigmoid")
    w, _ = tffn.router_probs(cfg, torch.zeros((3, 8)))
    _close(w, np.full((3, 1), 0.5), 1e-6)


def _moe_pair(seed, **kw):
    cfg, jcfg = _mini(**kw)
    jp = jffn.init_moe(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, _to_torch(jp), jp


def _routing(cfg, jcfg, p, jp, x):
    """Both packages' expert ids for x (B, S, D)."""
    _, idx = tffn.router_probs(cfg, _t(x) @ p["router"])
    _, jidx = jffn.router_probs(jcfg, jnp.array(x, jnp.float32)
                                @ jp["router"])
    return idx.numpy(), np.asarray(jidx)


@pytest.mark.parametrize("dispatch", ["local", "global"])
@pytest.mark.parametrize("router,k,shared,factor", [
    ("softmax", 2, 1, 1.25), ("softmax", 2, 0, 8.0), ("sigmoid", 1, 1, 1.5),
    ("softmax", 3, 2, 0.5)])
def test_moe_dispatch_matches_repro(dispatch, router, k, shared, factor):
    """At factors that drop pairs (0.5, 1.25: which pairs a capacity
    drops follows the top-k order and the stable sort) and one that
    drops none."""
    cfg, jcfg, p, jp = _moe_pair(7, n_experts=4, moe_top_k=k, moe_d_ff=16,
                                 router_type=router, n_shared_experts=shared,
                                 capacity_factor=factor)
    x = np.random.default_rng(8).normal(size=(2, 12, 32))
    idx, jidx = _routing(cfg, jcfg, p, jp, x)
    assert np.array_equal(idx, jidx)
    fn = {"local": (tffn.moe_forward_local, jffn.moe_forward_local),
          "global": (tffn.moe_forward_global, jffn.moe_forward_global)}
    out, aux = fn[dispatch][0](cfg, p, _t(x))
    jout, jaux = fn[dispatch][1](jcfg, jp, jnp.array(x, jnp.float32))
    assert out.shape == (2, 12, 32)
    _close(out, jout, MOE_TOL)
    _close(aux, jaux, AUX_TOL)


def test_moe_capacity_drops_tokens():
    """Capacity factor 0 leaves one slot an expert: at least half the
    tokens are dropped (zero rows without a shared expert), on both
    dispatches, as in repro."""
    cfg, jcfg, p, jp = _moe_pair(0, n_experts=4, moe_top_k=1, moe_d_ff=16,
                                 capacity_factor=0.0)
    assert tffn.capacity(cfg, 8) == 1
    x = np.random.default_rng(5).normal(size=(2, 8, 32))
    for fn, jfn in ((tffn.moe_forward_global, jffn.moe_forward_global),
                    (tffn.moe_forward_local, jffn.moe_forward_local)):
        out, _ = fn(cfg, p, _t(x))
        assert int((out.abs().sum(-1) < 1e-9).sum()) >= 8
        _close(out, jfn(jcfg, jp, jnp.array(x, jnp.float32))[0], MOE_TOL)


def test_moe_local_equals_global_without_drops():
    rng = np.random.default_rng(6)
    for seed in range(3):
        cfg, _, p, _ = _moe_pair(seed, n_experts=4, moe_top_k=2, moe_d_ff=16,
                                 capacity_factor=8.0, n_shared_experts=1)
        x = _t(rng.normal(size=(2, 8, 32)))
        o1, a1 = tffn.moe_forward_global(cfg, p, x)
        o2, a2 = tffn.moe_forward_local(cfg, p, x)
        torch.testing.assert_close(o1, o2, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(a1, a2)


def test_init_moe_shapes_match_repro():
    cfg, jcfg = _mini(n_experts=4, moe_top_k=2, moe_d_ff=16,
                      n_shared_experts=2)
    mine = tffn.init_moe(cfg, torch.Generator().manual_seed(0), CPU)
    ref = jffn.init_moe(jcfg, jax.random.PRNGKey(0))
    assert tlm.tree_map(lambda t: tuple(t.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)


# -- MLA ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg, jparams, cfg, params = _build("deepseek-v2-236b")
    return (jcfg, jparams["segments"][0][0]["attn"], cfg,
            params["segments"][0][0]["attn"])


@pytest.mark.parametrize("window", [0, 5])
def test_mla_full_sequence_matches_repro(mla, window):
    jcfg, jp, cfg, p = mla
    b, s = 2, 12
    x = np.random.default_rng(9).normal(size=(b, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want, _ = jattn.mla_forward(jcfg, jp, jnp.array(x, jnp.float32),
                                jnp.array(pos), window=window)
    got, cache = tattn.mla_forward(cfg, p, _t(x), torch.from_numpy(pos.copy()),
                                   window=window)
    assert cache is None
    _close(got, want)


def _mla_decode(mla, absorb, steps, cache_len, window):
    jcfg, jp, cfg, p = mla
    jcfg, cfg = (c.replace(mla_absorb=absorb) for c in (jcfg, cfg))
    b = 2
    x = np.random.default_rng(10).normal(size=(b, steps, cfg.d_model))
    jcache = jattn.init_mla_cache(jcfg, b, cache_len, jnp.float32)
    cache = tattn.init_mla_cache(cfg, b, cache_len, torch.float32, CPU)
    outs = []
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        jo, jcache = jattn.mla_forward(jcfg, jp, jnp.array(x[:, t:t + 1],
                                                           jnp.float32),
                                       jnp.array(pos), cache=jcache,
                                       window=window)
        o, cache = tattn.mla_forward(cfg, p, _t(x[:, t:t + 1]),
                                     torch.from_numpy(pos), cache=cache,
                                     window=window)
        outs.append((o, jo))
    return outs, cache, jcache


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("cache_len,window", [(8, 0), (4, 4)])
def test_mla_decode_matches_repro(mla, absorb, cache_len, window):
    """Naive and absorbed decode each equal repro's step by step, the
    cache written in place as repro writes it (a wrapping ring at 4)."""
    outs, cache, jcache = _mla_decode(mla, absorb, 6, cache_len, window)
    for o, jo in outs:
        _close(o, jo)
    for name in ("c_kv", "k_rope", "slot_pos", "next_pos"):
        assert np.allclose(cache[name].numpy(), np.asarray(jcache[name]),
                           rtol=TOL, atol=TOL), name


def test_mla_absorbed_equals_naive_in_port(mla):
    naive = _mla_decode(mla, False, 6, 8, 0)[0]
    absorbed = _mla_decode(mla, True, 6, 8, 0)[0]
    for (n, _), (a, _) in zip(naive, absorbed):
        _close(a, n.numpy(), 2e-4)


def test_mla_decode_refuses_more_than_one_token(mla):
    _, _, cfg, p = mla
    cache = tattn.init_mla_cache(cfg, 1, 4, torch.float32, CPU)
    with pytest.raises(ValueError, match="one new token"):
        tattn.mla_forward(cfg, p, torch.zeros((1, 2, cfg.d_model)),
                          torch.zeros((1, 2), dtype=torch.int32), cache=cache)


# -- the models ------------------------------------------------------------

def _port_ids(monkeypatch, cfg, params, toks, use_kernel):
    """Logits, aux and each MoE layer's expert ids of the port's forward."""
    ids, real = [], tffn.router_probs

    def record(c, logits):
        w, idx = real(c, logits)
        ids.append(idx.numpy())
        return w, idx

    monkeypatch.setattr(tffn, "router_probs", record)
    logits, aux = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                              use_kernel=use_kernel)
    monkeypatch.setattr(tffn, "router_probs", real)
    return logits, aux, ids


def _repro_ids(monkeypatch, jcfg, jparams, toks, use_kernel):
    """Each MoE layer's expert ids of repro's forward, run layer by layer
    (its lax.scan would hand the router tracers)."""
    ids, real = [], jffn.router_probs

    def record(c, logits):
        w, idx = real(c, logits)
        ids.append(np.asarray(idx))
        return w, idx

    monkeypatch.setattr(jffn, "router_probs", record)
    b, s = toks.shape
    x = jlm.embed_tokens(jcfg, jparams, {"tokens": jnp.array(toks)})
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    for seg, sp in zip(jlm.layer_plan(jcfg), jparams["segments"]):
        for i in range(seg.count):
            lp = (jax.tree_util.tree_map(lambda a, i=i: a[i], sp)
                  if seg.scanned else sp[i])
            x, _, _ = jblocks.apply_layer(jcfg, lp, x, pos, seg.kind,
                                          window=jcfg.sliding_window,
                                          use_kernel=use_kernel)
    monkeypatch.setattr(jffn, "router_probs", real)
    return ids


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_routing_logits_and_aux_match_repro(monkeypatch, moe_model,
                                                    use_kernel):
    """S 40 passes the smoke window of 32. Expert ids first, layer by
    layer; then logits and aux."""
    jcfg, jparams, cfg, params = moe_model
    b, s = 2, 40
    toks = _tokens(cfg, b, s)
    tfa.reset_launch_counts()
    got, aux, ids = _port_ids(monkeypatch, cfg, params, toks, use_kernel)
    jids = _repro_ids(monkeypatch, jcfg, jparams, toks, use_kernel)
    assert len(ids) == len(jids) == cfg.n_layers - cfg.first_k_dense
    for layer, (i, j) in enumerate(zip(ids, jids)):
        assert np.array_equal(i.reshape(b, s, -1), j.reshape(b, s, -1)), \
            f"layer {layer}: routing differs"
    want, jaux = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)},
                             use_kernel=use_kernel)
    assert got.shape == (b, s, cfg.vocab_size) and float(aux) > 0
    # CPU tensors take the plain version: no kernel launches
    assert tfa.launch_counts()["flash_attention"] == 0
    _close(got, want)
    _close(aux, jaux)


def _decode_steps(cfg, params, toks, steps, window):
    b = toks.shape[0]
    state = tengine.init_state(cfg, b, window=window, device=CPU)
    outs = []
    for t in range(steps):
        lg, state = tengine.serve_step(
            cfg, params, state,
            {"tokens": torch.from_numpy(toks[:, t:t + 1]),
             "positions": torch.full((b, 1), t, dtype=torch.int32)})
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)


def _repro_decode_steps(jcfg, jparams, toks, steps, window):
    b = toks.shape[0]
    state = jengine.init_state(jcfg, b, window=window)
    outs = []
    for t in range(steps):
        lg, state = jengine.serve_step(
            jcfg, jparams, state,
            {"tokens": jnp.array(toks[:, t:t + 1]),
             "positions": jnp.full((b, 1), t, jnp.int32)})
        outs.append(np.asarray(lg[:, 0]))
    return np.stack(outs, 1)


def test_decode_steps_match_repro(moe_model):
    """At the configs' own capacity factor (decode routes B tokens at a
    time, so pairs can drop), step by step."""
    jcfg, jparams, cfg, params = moe_model
    toks = _tokens(cfg, 2, 6, seed=3)
    _close(_decode_steps(cfg, params, toks, 6, 6),
           _repro_decode_steps(jcfg, jparams, toks, 6, 6))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward_at_drop_free_capacity(arch):
    """Token-by-token decode equals the parallel forward through the
    kernel seam once no pair is dropped (capacity_factor = n_experts, as
    tests/test_arch_smoke.py), 2e-3."""
    _, _, cfg, params = _build(arch)
    cfg = cfg.replace(sliding_window=0,
                      capacity_factor=float(cfg.n_experts))
    toks = _tokens(cfg, 2, 8, seed=4)
    full, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                          use_kernel=True)
    _close(_decode_steps(cfg, params, toks, 8, 8), full.numpy(), 2e-3)


def test_mla_absorbed_model_decode_matches_naive_and_repro():
    jcfg, jparams, cfg, params = _build("deepseek-v2-236b")
    cfg, jcfg = (c.replace(sliding_window=0, capacity_factor=16.0)
                 for c in (cfg, jcfg))
    toks = _tokens(cfg, 2, 6, seed=3)
    naive = _decode_steps(cfg.replace(mla_absorb=False), params, toks, 6, 6)
    absorbed = _decode_steps(cfg.replace(mla_absorb=True), params, toks, 6, 6)
    _close(absorbed, naive.numpy(), 2e-4)
    _close(absorbed, _repro_decode_steps(jcfg.replace(mla_absorb=True),
                                         jparams, toks, 6, 6))


def test_greedy_decode_matches_repro(moe_model):
    jcfg, jparams, cfg, params = moe_model
    prompt = _tokens(cfg, 2, 5, seed=5)
    want = jengine.greedy_decode(jcfg, jparams, jnp.array(prompt, jnp.int32),
                                 steps=5)
    got = tengine.greedy_decode(cfg, params, prompt, steps=5, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_launcher_smoke_on_cpu(capsys, arch):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == arch + "-smoke"
    assert line["output_shape"] == [4, 32]
