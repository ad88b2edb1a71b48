"""Port parity for the zamba2 serving slice: configs, the attention and
Mamba2 layers (each holds a kernel seam), the full-sequence forward with
``use_kernel`` True and False, decode steps and greedy decoding.

``repro``'s parameters from ``init_model(cfg, PRNGKey(0))`` are carried
across with ``params_from_numpy``; inputs are made with numpy and handed
to both packages. On the CPU the port's kernel path runs the kernels'
plain versions and ``repro``'s runs its oracles. Logits agree within
1e-4 in fp32; greedy tokens are identical.
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
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import cache_window as jcache_window
from repro.models import attention as jattn
from repro.models import model as jlm
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.shapes import SHAPES, cache_window
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.kernels.ssd_scan import kernel as tssd
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import model as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4
# smoke: one stacked hybrid group (shared attention + 2 mamba layers);
# smoke5: two stacked groups and one leftover (listed) mamba layer.
VARIANTS = {"smoke": {}, "smoke5": {"n_layers": 5}}


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    over = VARIANTS[request.param]
    jcfg = jsmoke_variant(jget_config("zamba2-1.2b"), **over)
    cfg = smoke_variant(get_config("zamba2-1.2b"), **over)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("over", [{}, {"n_layers": 5}])
def test_configs_match_repro(over):
    for port, ref in ((get_config("zamba2-1.2b"), jget_config("zamba2-1.2b")),
                      (smoke_variant(get_config("zamba2-1.2b"), **over),
                       jsmoke_variant(jget_config("zamba2-1.2b"), **over))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.activation_dtype == getattr(torch, ref.dtype)
        assert [dataclasses.astuple(s) for s in tlm.layer_plan(port)] == \
            [dataclasses.astuple(s) for s in jlm.layer_plan(ref)]
    full = get_config("zamba2-1.2b")
    for shape in SHAPES.values():
        assert dataclasses.astuple(shape) == \
            dataclasses.astuple(JSHAPES[shape.name])
        assert cache_window(full, shape) == \
            jcache_window(jget_config("zamba2-1.2b"), JSHAPES[shape.name])


def test_unported_arch_raises_key_error():
    jget_config("xlstm-1.3b")   # exists in repro
    with pytest.raises(KeyError, match="zamba2-1.2b"):
        get_config("xlstm-1.3b")
    with pytest.raises(ValueError, match="not ported"):
        tlm.layer_plan(get_config("zamba2-1.2b").replace(arch_type="ssm"))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("window", [0, 32, 5])
def test_attention_forward_matches(models, use_flash, window):
    jcfg, jparams, cfg, params = models
    b, s = 2, 32
    x = np.random.default_rng(1).normal(size=(b, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    want, _ = jattn.attention_forward(
        jcfg, jparams["shared_attn"]["attn"], jnp.array(x, jnp.float32),
        jnp.array(pos), window=window, use_flash=use_flash)
    tfa.reset_launch_counts()
    got, cache = tattn.attention_forward(
        cfg, params["shared_attn"]["attn"], _t(x), _t(pos, np.int32),
        window=window, use_flash=use_flash)
    assert cache is None and tfa.launch_counts()["flash_attention"] == 0
    _close(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_matches(models, use_kernel):
    jcfg, jparams, cfg, params = models
    b, s = 2, 32
    x = np.random.default_rng(2).normal(size=(b, s, cfg.d_model))
    li = tlm.layer_plan(cfg)[0].count - 1       # last stacked group
    jp = jax.tree_util.tree_map(lambda l: l[li],
                                jparams["segments"][0]["1_mamba"]["mixer"])
    tp = tlm.tree_index(params["segments"][0]["1_mamba"]["mixer"], li)
    want, _ = jssm.mamba2_forward(jcfg, jp, jnp.array(x, jnp.float32),
                                  use_kernel=use_kernel)
    got, st = tssm.mamba2_forward(cfg, tp, _t(x), use_kernel=use_kernel)
    assert st is None
    _close(got, want)


def test_mamba2_kernel_path_needs_whole_chunks(models):
    _, _, cfg, params = models
    tp = tlm.tree_index(params["segments"][0]["0_mamba"]["mixer"], 0)
    x = torch.zeros((1, 24, cfg.d_model))        # 24 % 16 != 0
    tssm.mamba2_forward(cfg, tp, x)              # plain path: chunk 8
    with pytest.raises(ValueError, match="S = 24, chunk = 16"):
        tssm.mamba2_forward(cfg, tp, x, use_kernel=True)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches(models, use_kernel):
    jcfg, jparams, cfg, params = models
    toks = _tokens(cfg, 2, 32)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)},
                          use_kernel=use_kernel)
    tfa.reset_launch_counts()
    tssd.reset_launch_counts()
    got, aux = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    # CPU tensors take the plain versions: no kernel launches
    assert tfa.launch_counts()["flash_attention"] == 0
    assert tssd.launch_counts()["ssd_scan"] == 0
    _close(got, want)


@pytest.fixture(scope="module")
def grouped():
    """The smoke model with B and C shared by groups of heads: two
    groups of the 16 Mamba2 heads, in both packages."""
    jcfg = jsmoke_variant(jget_config("zamba2-1.2b")).replace(n_ssm_groups=2)
    cfg = smoke_variant(get_config("zamba2-1.2b")).replace(n_ssm_groups=2)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba2_forward_with_groups_matches(grouped, use_kernel):
    """The kernel path hands ssd_scan B and C per group, the plain path
    broadcasts them to the heads; both match repro's layer."""
    jcfg, jparams, cfg, params = grouped
    assert tssm.mamba_dims(cfg)[1:] == (16, 16, 2)
    x = np.random.default_rng(8).normal(size=(2, 32, cfg.d_model))
    jp = jax.tree_util.tree_map(lambda l: l[0],
                                jparams["segments"][0]["0_mamba"]["mixer"])
    tp = tlm.tree_index(params["segments"][0]["0_mamba"]["mixer"], 0)
    want, _ = jssm.mamba2_forward(jcfg, jp, jnp.array(x, jnp.float32),
                                  use_kernel=use_kernel)
    got, _ = tssm.mamba2_forward(cfg, tp, _t(x), use_kernel=use_kernel)
    _close(got, want)


def test_forward_with_groups_matches(grouped):
    jcfg, jparams, cfg, params = grouped
    toks = _tokens(cfg, 2, 32, seed=9)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)},
                          use_kernel=True)
    got, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                         use_kernel=True)
    _close(got, want)


def test_decode_steps_match(models):
    jcfg, jparams, cfg, params = models
    b, steps = 2, 8
    toks = _tokens(cfg, b, steps, seed=3)
    jstate = jengine.init_state(jcfg, b, window=steps)
    state = tengine.init_state(cfg, b, window=steps, device=CPU)
    for t in range(steps):
        pos = np.full((b, 1), t, np.int32)
        jl, jstate = jengine.serve_step(
            jcfg, jparams, jstate,
            {"tokens": jnp.array(toks[:, t:t + 1]), "positions": jnp.array(pos)})
        tl, state = tengine.serve_step(
            cfg, params, state, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                 "positions": torch.from_numpy(pos)})
        _close(tl, jl)
    mine = []
    tlm.tree_map(lambda t: mine.append(tuple(t.shape)), state)
    assert sorted(mine) == sorted(
        l.shape for l in jax.tree_util.tree_leaves(jstate))


def test_decode_matches_forward_in_port(models):
    """Token-by-token decode logits match the parallel forward through
    the kernel seams (2e-3, as tests/test_arch_smoke.py)."""
    _, _, cfg, params = models
    cfg = cfg.replace(sliding_window=0)
    b, s = 2, 16
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=4))
    full, _ = tlm.forward(cfg, params, {"tokens": toks}, use_kernel=True)
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
    prompt = _tokens(cfg, 2, 6, seed=5)
    want = jengine.greedy_decode(jcfg, jparams, jnp.array(prompt, jnp.int32),
                                 steps=6)
    got = tengine.greedy_decode(cfg, params, prompt, steps=6, device=CPU)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_params_from_numpy_checks_every_leaf(models):
    jcfg, jparams, cfg, _ = models
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["shared_attn"]["attn"]["w_q"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match=r"w_q.*\(3, 3\)"):
        tlm.params_from_numpy(cfg, bad, CPU)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        tlm.params_from_numpy(cfg, missing, CPU)
    other = smoke_variant(get_config("zamba2-1.2b"), d_model=128)
    with pytest.raises(ValueError, match="shape"):
        tlm.params_from_numpy(other, tree, CPU)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = smoke_variant(get_config("zamba2-1.2b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_model(cfg)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.greedy_decode(cfg, params, np.zeros((1, 2), np.int64), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.init_state(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-1.2b", "--smoke"])


def test_serve_launcher_on_cpu(capsys):
    serve.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["output_shape"] == [2, 7]
    assert line["arch"] == "zamba2-1.2b-smoke"
