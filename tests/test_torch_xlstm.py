"""Port parity for xlstm-1.3b: the mLSTM (stabilised parallel form and
O(1) decode step) and sLSTM (cell and the loop over time) against
``repro.models.xlstm`` on numpy-seeded inputs, the first recurrent
steps from ``m = -inf`` compared leaf by leaf, the smoke model's logits,
decode and greedy tokens, and the full-width parameter tree's shapes.

``repro``'s parameters from ``init_model(cfg, PRNGKey(0))`` are carried
across with ``params_from_numpy``. Layers agree within 1e-5, logits
within 1e-4 in fp32; greedy tokens are identical. No test may see a NaN.
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
from repro.models import model as jlm
from repro.models import xlstm as jx
from repro.serve import engine as jengine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve
from repro_torch.models import model as tlm
from repro_torch.models import xlstm as tx
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "xlstm-1.3b"
LAYER_TOL = 1e-5
TOL = 1e-4
# smoke: one stacked group [slstm ; mlstm]; smoke4: two groups
VARIANTS = {"smoke": {}, "smoke4": {"n_layers": 4}}


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _close_state(got, want):
    """Leaf by leaf; ``m`` may be -inf on both sides, nowhere NaN."""
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].detach().numpy()
        w = np.asarray(want[k])
        assert not np.isnan(g).any() and not np.isnan(w).any(), k
        np.testing.assert_allclose(g, w, rtol=LAYER_TOL, atol=LAYER_TOL,
                                   err_msg=k)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    over = VARIANTS[request.param]
    jcfg = jsmoke_variant(jget_config(ARCH), **over)
    cfg = smoke_variant(get_config(ARCH), **over)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


def _layer(models, kind, group=0):
    """The mixer params of the ``kind`` layer of stacked group
    ``group`` in both packages."""
    jcfg, jparams, cfg, params = models
    name = "0_slstm" if kind == "slstm" else "1_mlstm"
    jp = jax.tree_util.tree_map(lambda leaf: leaf[group],
                                jparams["segments"][0][name]["mixer"])
    tp = tlm.tree_index(params["segments"][0][name]["mixer"], group)
    return jcfg, jp, cfg, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("over", [{}, {"n_layers": 4}])
def test_configs_match_repro(over):
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (smoke_variant(get_config(ARCH), **over),
                       jsmoke_variant(jget_config(ARCH), **over))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert [dataclasses.astuple(s) for s in tlm.layer_plan(port)] == \
            [dataclasses.astuple(s) for s in jlm.layer_plan(ref)]
    assert tlm.layer_plan(get_config(ARCH)) == [tlm.Segment(
        "xlstm_group", 6, True, ("slstm",) + ("mlstm",) * 7)]


@pytest.mark.parametrize("every", [0, 2, 8])
def test_is_slstm_layer_matches_repro(every):
    """``is_slstm_layer`` picks repro's layers, and the full config's
    pick is the first layer of each group of its layer plan."""
    port = dataclasses.replace(get_config(ARCH), slstm_every=every)
    ref = dataclasses.replace(jget_config(ARCH), slstm_every=every)
    picks = [tx.is_slstm_layer(port, i) for i in range(port.n_layers)]
    assert picks == [jx.is_slstm_layer(ref, i) for i in range(ref.n_layers)]
    if every == 8:
        seg, = tlm.layer_plan(port)
        kinds = seg.group * seg.count
        assert picks == [k == "slstm" for k in kinds]


def test_layer_plan_needs_whole_groups():
    with pytest.raises(ValueError, match="slstm_every"):
        tlm.layer_plan(smoke_variant(get_config(ARCH), n_layers=3))


def _gates(rng, b, s, h):
    """Input gates over [-3, 3] and forget gates over [-2, 6], so that
    both the forget-dominated and the input-dominated branch of the
    stabiliser's max are taken."""
    return rng.uniform(-3, 3, (b, s, h)), rng.uniform(-2, 6, (b, s, h))


@pytest.mark.parametrize("seed", [0, 1])
def test_mlstm_parallel_matches_repro(seed):
    rng = np.random.default_rng(seed)
    b, s, h, dqk, dv = 2, 24, 4, 8, 16
    q, k = (rng.normal(size=(b, s, h, dqk)) for _ in range(2))
    v = rng.normal(size=(b, s, h, dv))
    i_pre, f_pre = _gates(rng, b, s, h)
    want = jx._mlstm_parallel(*(jnp.array(a, jnp.float32)
                                for a in (q, k, v, i_pre, f_pre)))
    got = tx._mlstm_parallel(*(_t(a) for a in (q, k, v, i_pre, f_pre)))
    _close(got, want, LAYER_TOL)


def test_mlstm_steps_from_minus_inf_match_repro():
    """Four decode steps from the initial state (m = -inf, c = n = 0):
    m, c, n and y against repro's after each step, no NaN."""
    rng = np.random.default_rng(2)
    cfg = smoke_variant(get_config(ARCH), xlstm_qk_dim=8)
    jcfg = jsmoke_variant(jget_config(ARCH), xlstm_qk_dim=8)
    b, (_, h, dqk, dv) = 2, tx.mlstm_dims(cfg)
    jst = jx.init_mlstm_state(jcfg, b)
    st = tx.init_mlstm_state(cfg, b, CPU)
    assert np.isneginf(st["m"].numpy()).all()
    _close_state(st, jst)
    for _ in range(4):
        q, k = (rng.normal(size=(b, h, dqk)) for _ in range(2))
        v = rng.normal(size=(b, h, dv))
        i_pre, f_pre = (g[:, 0] for g in _gates(rng, b, 1, h))
        jy, jst = jx._mlstm_step(jst, *(jnp.array(a, jnp.float32)
                                        for a in (q, k, v, i_pre, f_pre)))
        y, st = tx._mlstm_step(st, *(_t(a) for a in (q, k, v, i_pre, f_pre)))
        _close(y, jy, LAYER_TOL)
        _close_state(st, jst)
        assert np.isfinite(st["m"].numpy()).all()


def test_slstm_cells_from_minus_inf_match_repro(models):
    """Four sLSTM cells from the initial state: c, n, h and m after
    each, no NaN."""
    jcfg, jp, cfg, tp = _layer(models, "slstm")
    b, d = 2, cfg.d_model
    rng = np.random.default_rng(3)
    jst = jx.init_slstm_state(jcfg, b)
    st = tx.init_slstm_state(cfg, b, CPU)
    for _ in range(4):
        zifo = rng.normal(size=(b, 4 * d))
        jst = jx._slstm_cell(jcfg, jp, jst, jnp.array(zifo, jnp.float32))
        st = tx._slstm_cell(cfg, tp, st, _t(zifo))
        _close_state(st, jst)
        assert np.isfinite(st["m"].numpy()).all()


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_layer_forward_and_decode_match_repro(models, kind):
    """The full-sequence forward (sLSTM: the loop over time) and three
    decode steps from the initial state, each against repro's."""
    jcfg, jp, cfg, tp = _layer(models, kind)
    fwd = {"slstm": (jx.slstm_forward, tx.slstm_forward,
                     jx.init_slstm_state, tx.init_slstm_state),
           "mlstm": (jx.mlstm_forward, tx.mlstm_forward,
                     jx.init_mlstm_state, tx.init_mlstm_state)}[kind]
    b, s = 2, 20
    x = np.random.default_rng(4).normal(size=(b, s, cfg.d_model))
    want, _ = fwd[0](jcfg, jp, jnp.array(x, jnp.float32))
    got, st = fwd[1](cfg, tp, _t(x))
    assert st is None
    _close(got, want, LAYER_TOL)
    jst, st = fwd[2](jcfg, b), fwd[3](cfg, b, CPU)
    for t in range(3):
        jy, jst = fwd[0](jcfg, jp, jnp.array(x[:, t:t + 1], jnp.float32),
                         state=jst)
        y, st = fwd[1](cfg, tp, _t(x[:, t:t + 1]), state=st)
        _close(y, jy, LAYER_TOL)
        _close_state(st, jst)
        # decode reproduces the parallel form
        _close(y[:, 0], got[:, t].numpy(), 2e-3)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_decode_refuses_more_than_one_token(models, kind):
    _, _, cfg, tp = _layer(models, kind)
    fwd, init = ((tx.slstm_forward, tx.init_slstm_state) if kind == "slstm"
                 else (tx.mlstm_forward, tx.init_mlstm_state))
    with pytest.raises(ValueError, match="one new token"):
        fwd(cfg, tp, torch.zeros((1, 2, cfg.d_model)), state=init(cfg, 1, CPU))


def test_forward_matches(models):
    jcfg, jparams, cfg, params = models
    toks = _tokens(cfg, 2, 24)
    want, jaux = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)})
    got, aux = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)
    # no kernel on this family: both paths are the same computation
    again, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                           use_kernel=True)
    assert torch.equal(again, got)


def test_decode_steps_and_state_match(models):
    jcfg, jparams, cfg, params = models
    b, steps = 2, 6
    toks = _tokens(cfg, b, steps, seed=3)
    jstate = jengine.init_state(jcfg, b, window=steps)
    state = tengine.init_state(cfg, b, window=steps, device=CPU)
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        jl, jstate = jengine.serve_step(
            jcfg, jparams, jstate, {"tokens": jnp.array(toks[:, t:t + 1]),
                                    "positions": jnp.array(pos)})
        tl, state = tengine.serve_step(
            cfg, params, state, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                 "positions": torch.from_numpy(pos)})
        _close(tl, jl)
    # a group's state: the sLSTM's four leaves and the mLSTM's three
    group = state[0]
    assert sorted(group) == ["0_slstm", "1_mlstm"]
    assert sorted(group["0_slstm"]) == ["c", "h", "m", "n"]
    assert sorted(group["1_mlstm"]) == ["c", "m", "n"]
    mine = []
    tlm.tree_map(lambda t: mine.append(tuple(t.shape)), state)
    assert sorted(mine) == sorted(
        leaf.shape for leaf in jax.tree_util.tree_leaves(jstate))
    leaves = tlm.tree_leaves(state)
    assert all(not torch.isnan(leaf).any() for leaf in leaves)


def test_decode_matches_forward_in_port(models):
    """tests/test_arch_smoke.py's check: token-by-token decode logits
    match the parallel forward within 2e-3."""
    _, _, cfg, params = models
    b, s = 2, 8
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=4))
    full, _ = tlm.forward(cfg, params, {"tokens": toks})
    state = tengine.init_state(cfg, b, window=s, device=CPU)
    outs = []
    for t in range(s):
        lg, state = tengine.serve_step(
            cfg, params, state,
            {"tokens": toks[:, t:t + 1],
             "positions": torch.full((b, 1), t, dtype=torch.int32)})
        outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), full.numpy(), tol=2e-3)


def test_greedy_decode_matches(models):
    jcfg, jparams, cfg, params = models
    prompt = _tokens(cfg, 2, 5, seed=5)
    want = jengine.greedy_decode(jcfg, jparams, jnp.array(prompt, jnp.int32),
                                 steps=5)
    got = tengine.greedy_decode(cfg, params, prompt, steps=5, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_full_width_tree_matches_repro_shapes():
    """init_model on the meta device against jax.eval_shape of repro's:
    the same keys, list lengths and shapes at 48 layers, d 2048."""
    cfg = get_config(ARCH)
    jtree = jax.eval_shape(lambda: jlm.init_model(jget_config(ARCH),
                                                  jax.random.PRNGKey(0)))
    tree = tlm.init_model(cfg, device="meta")
    jshapes = {jax.tree_util.keystr(p): tuple(leaf.shape) for p, leaf in
               jax.tree_util.tree_leaves_with_path(jtree)}
    shapes = []
    tlm.tree_map(lambda t: shapes.append(tuple(t.shape)), tree)
    assert sorted(shapes) == sorted(jshapes.values())
    seg = tree["segments"][0]
    assert seg["0_slstm"]["mixer"]["r_z"].shape == (6, 4, 512, 512)
    assert seg["7_mlstm"]["mixer"]["w_v"].shape == (6, 4096, 4096)
    assert seg["3_mlstm"]["ln1"]["bias"].shape == (6, 2048)
    n = sum(t.numel() for t in tlm.tree_leaves(tree))
    assert n == sum(int(np.prod(s)) for s in jshapes.values())
    # 42 mLSTM layers of 50.37 M, 6 sLSTM of 25.18 M, embedding and head
    # of 103.0 M each: 2.473e9 (9.9 GB in fp32)
    assert 2.47e9 < n < 2.48e9


def test_params_from_numpy_rejects_a_missing_xlstm_leaf(models):
    jcfg, jparams, cfg, _ = models
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    del tree["segments"][0]["0_slstm"]["mixer"]["r_o"]
    with pytest.raises(ValueError, match="r_o"):
        tlm.params_from_numpy(cfg, tree, CPU)


def test_serve_launcher_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "4", "--gen", "3", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["arch"] == "xlstm-1.3b-smoke"
    assert line["output_shape"] == [2, 7]
