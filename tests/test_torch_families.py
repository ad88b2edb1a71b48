"""Port parity for the families on the dense layer stack: llama3-8b,
phi4-mini-3.8b, qwen1.5-110b (QKV bias), olmo-1b (parameter-free
LayerNorm), qwen2-vl-7b (M-RoPE, patch-embedding splice) and
musicgen-medium (four codebooks, sinusoidal positions, GELU).

Each runs at ``smoke_variant`` size. ``repro``'s parameters from
``init_model(cfg, PRNGKey(0))`` are carried across with
``params_from_numpy``; inputs are made with numpy and handed to both
packages. On the CPU the port's kernel path runs K4's plain version and
``repro``'s runs its oracle. Logits agree within 1e-4 in fp32; greedy
tokens are identical.

Two faults of the reference are kept for parity, and shown here: the
plain path masks by the temporal M-RoPE position while the kernel path
masks by ``arange``, and decode adds the sinusoidal position of 0 to
every token (no ``pos_offset``).
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
from repro.models import common as jcommon
from repro.models import model as jlm
from repro.serve import engine as jengine
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import model as tlm
from repro_torch.serve import engine as tengine

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = 1e-4
FAMILIES = ["llama3-8b", "phi4-mini-3.8b", "qwen1.5-110b", "olmo-1b",
            "qwen2-vl-7b", "musicgen-medium"]
# decode reproduces the forward in these (musicgen's does not: its
# decode adds the sinusoidal position of 0 to every token, as repro's)
DECODE_EQ_FORWARD = [a for a in FAMILIES if a != "musicgen-medium"]


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _build(arch, seed=0, mutate=None):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    if mutate is not None:
        jparams = mutate(jparams)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _build(request.param)


def _tokens(cfg, b, s, seed=0):
    shape = ((b, cfg.n_codebooks, s) if cfg.arch_type == "audio"
             else (b, s))
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _step_positions(cfg, b, t):
    pos = np.full((b, 1), t, np.int32)
    if cfg.pos_type == "mrope":
        pos = np.repeat(pos[:, :, None], 3, axis=-1)
    return pos


def test_registry_lists_ported_archs_in_repros_order():
    assert set(FAMILIES) <= set(ARCH_IDS)
    assert ARCH_IDS == [a for a in JARCH_IDS if a in ARCH_IDS]
    assert sorted(ARCH_IDS) == sorted(
        FAMILIES + ["zamba2-1.2b", "deepseek-v2-236b",
                    "llama4-scout-17b-a16e"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_match_repro(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (smoke_variant(get_config(arch)),
                       jsmoke_variant(jget_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.activation_dtype == getattr(torch, ref.dtype)
        assert [dataclasses.astuple(s) for s in tlm.layer_plan(port)] == \
            [dataclasses.astuple(s) for s in jlm.layer_plan(ref)]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_matches(family, use_kernel):
    """S 40 passes the smoke window of 32, so both paths mask by it."""
    jcfg, jparams, cfg, params = family
    toks = _tokens(cfg, 2, 40)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)},
                          use_kernel=use_kernel)
    tfa.reset_launch_counts()
    got, aux = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    want_shape = ((2, 40, cfg.n_codebooks, cfg.vocab_size)
                  if cfg.arch_type == "audio" else (2, 40, cfg.vocab_size))
    assert got.shape == want_shape and float(aux) == 0.0
    # CPU tensors take the plain version: no kernel launches
    assert tfa.launch_counts()["flash_attention"] == 0
    _close(got, want)


def _decode_both(jcfg, jparams, cfg, params, toks, steps):
    """Step logits of both packages over ``toks[..., :steps]``."""
    b = toks.shape[0]
    jstate = jengine.init_state(jcfg, b, window=steps)
    state = tengine.init_state(cfg, b, window=steps, device=CPU)
    outs = []
    for t in range(steps):
        pos = _step_positions(cfg, b, t)
        cur = toks[..., t:t + 1]
        jl, jstate = jengine.serve_step(
            jcfg, jparams, jstate,
            {"tokens": jnp.array(cur), "positions": jnp.array(pos)})
        tl, state = tengine.serve_step(
            cfg, params, state, {"tokens": torch.from_numpy(cur),
                                 "positions": torch.from_numpy(pos)})
        outs.append((tl, jl))
    return outs, state, jstate


def test_decode_steps_match(family):
    jcfg, jparams, cfg, params = family
    toks = _tokens(cfg, 2, 6, seed=3)
    outs, state, jstate = _decode_both(jcfg, jparams, cfg, params, toks, 6)
    for tl, jl in outs:
        _close(tl, jl)
    mine = []
    tlm.tree_map(lambda t: mine.append(tuple(t.shape)), state)
    assert sorted(mine) == sorted(
        l.shape for l in jax.tree_util.tree_leaves(jstate))


@pytest.mark.parametrize("arch", DECODE_EQ_FORWARD)
def test_decode_matches_forward_in_port(arch):
    """Token-by-token decode logits match the parallel forward through
    the kernel seam (2e-3, as tests/test_arch_smoke.py)."""
    _, _, cfg, params = _build(arch)
    cfg = cfg.replace(sliding_window=0)
    b, s = 2, 12
    toks = torch.from_numpy(_tokens(cfg, b, s, seed=4))
    full, _ = tlm.forward(cfg, params, {"tokens": toks}, use_kernel=True)
    state = tengine.init_state(cfg, b, window=s, device=CPU)
    outs = []
    for t in range(s):
        lg, state = tengine.serve_step(
            cfg, params, state,
            {"tokens": toks[:, t:t + 1],
             "positions": torch.from_numpy(_step_positions(cfg, b, t))})
        outs.append(lg[:, 0])
    _close(torch.stack(outs, 1), full.numpy(), tol=2e-3)


def test_greedy_decode_matches(family):
    jcfg, jparams, cfg, params = family
    prompt = _tokens(cfg, 2, 5, seed=5)
    want = jengine.greedy_decode(jcfg, jparams, jnp.array(prompt, jnp.int32),
                                 steps=5)
    got = tengine.greedy_decode(cfg, params, prompt, steps=5, device=CPU)
    assert got.dtype == torch.int32
    assert got.shape == prompt.shape[:-1] + (10,)
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- qwen2-vl: M-RoPE and the patch splice ---------------------------------

def _vlm_positions(b):
    """Text at 0-3, a 2 x 4 image whose patches share t = 4 (h 4-5,
    w 4-7), then text from 8: (B, 16, 3) as (t, h, w)."""
    rows = [(i, i, i) for i in range(4)]
    rows += [(4, 4 + r, 4 + c) for r in range(2) for c in range(4)]
    rows += [(8 + j,) * 3 for j in range(4)]
    return np.broadcast_to(np.array(rows, np.int32)[None], (b, 16, 3))


def _vlm_inputs(cfg, b, s, image):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    pe = rng.normal(size=(b, s, cfg.d_model))
    mask = np.zeros((b, s), bool)
    mask[:, image] = True
    return toks, pe, mask


def _vlm_forward(jcfg, jparams, cfg, params, inputs, use_kernel):
    toks, pe, mask, pos = inputs
    jbatch = {"tokens": jnp.array(toks), "patch_embeds": jnp.array(pe,
              jnp.float32), "patch_mask": jnp.array(mask),
              "positions": jnp.array(pos)}
    batch = {"tokens": torch.from_numpy(toks), "patch_embeds": _t(pe),
             "patch_mask": torch.from_numpy(mask),
             "positions": torch.from_numpy(np.array(pos))}
    want, _ = jlm.forward(jcfg, jparams, jbatch, use_kernel=use_kernel)
    got, _ = tlm.forward(cfg, params, batch, use_kernel=use_kernel)
    return got, want


def test_vlm_3d_positions_match_repro_on_each_path():
    """Each path equals repro's same path; the two paths differ, because
    the plain path masks by the temporal position (the image's eight
    patches see each other) and the kernel path by arange: repro's
    fault, kept for parity."""
    model = _build("qwen2-vl-7b")
    cfg = model[2]
    toks, pe, mask = _vlm_inputs(cfg, 2, 16, slice(4, 12))
    inputs = (toks, pe, mask, _vlm_positions(2))
    plain, want_plain = _vlm_forward(*model, inputs, use_kernel=False)
    kern, want_kern = _vlm_forward(*model, inputs, use_kernel=True)
    _close(plain, want_plain)
    _close(kern, want_kern)
    assert float((plain - kern).abs().max()) > 1e-2
    # with arange positions the two paths agree
    arange = np.broadcast_to(np.arange(16, dtype=np.int32)[None, :, None],
                             (2, 16, 3))
    plain, _ = _vlm_forward(*model, (toks, pe, mask, arange), False)
    kern, _ = _vlm_forward(*model, (toks, pe, mask, arange), True)
    _close(kern, plain.numpy())


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vlm_patch_embeds_splice(use_kernel):
    model = _build("qwen2-vl-7b")
    cfg, params = model[2], model[3]
    toks, pe, mask = _vlm_inputs(cfg, 2, 24, slice(0, 8))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None, :, None],
                          (2, 24, 3))
    got, want = _vlm_forward(*model, (toks, pe, mask, pos), use_kernel)
    _close(got, want)
    plain, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    # the splice changes the logits from the first patch on
    assert float((got[:, 0] - plain[:, 0]).abs().max()) > 1e-3


def test_apply_mrope_and_sinusoidal_positions_match_repro():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 4, 64))
    pos = _vlm_positions(2)
    want = jcommon.apply_mrope(jnp.array(x, jnp.float32), jnp.array(pos),
                               1e6, (8, 12, 12))
    _close(tcommon.apply_mrope(_t(x), torch.from_numpy(np.array(pos)), 1e6,
                               (8, 12, 12)), want)
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(_t(x), torch.from_numpy(np.array(pos)), 1e6,
                            (8, 12, 8))
    for offset in (0, 5):
        _close(tcommon.sinusoidal_positions(12, 96, offset),
               jcommon.sinusoidal_positions(12, 96, offset))


# -- musicgen: four codebooks, sinusoidal positions -----------------------

def test_audio_from_embeds_matches_repro():
    jcfg, jparams, cfg, params = _build("musicgen-medium")
    emb = np.random.default_rng(8).normal(size=(2, 20, cfg.d_model))
    for use_kernel in (False, True):
        want, _ = jlm.forward(jcfg, jparams,
                              {"embeds": jnp.array(emb, jnp.float32)},
                              use_kernel=use_kernel)
        got, _ = tlm.forward(cfg, params, {"embeds": _t(emb)},
                             use_kernel=use_kernel)
        assert got.shape == (2, 20, cfg.n_codebooks, cfg.vocab_size)
        _close(got, want)


def test_audio_decode_matches_repro_drift_included():
    """Decode equals repro's decode step by step, and both drift from the
    forward after position 0 (the sinusoidal position of 0 is added to
    every decoded token)."""
    jcfg, jparams, cfg, params = _build("musicgen-medium")
    cfg, jcfg = (c.replace(sliding_window=0) for c in (cfg, jcfg))
    toks = _tokens(cfg, 2, 6, seed=9)
    outs, _, _ = _decode_both(jcfg, jparams, cfg, params, toks, 6)
    for tl, jl in outs:
        _close(tl, jl)
    full, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    drift = [float((tl[:, 0] - full[:, t]).abs().max())
             for t, (tl, _) in enumerate(outs)]
    assert drift[0] < 2e-3 and min(drift[1:]) > 1e-2


def test_audio_params_from_numpy_checks_stacked_leaves():
    jcfg, jparams, cfg, params = _build("musicgen-medium")
    assert tuple(params["embed"].shape) == (4, cfg.vocab_size, cfg.d_model)
    assert tuple(params["lm_head"].shape) == (4, cfg.d_model, cfg.vocab_size)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    for name, bad in (("embed", tree["embed"][:3]),
                      ("lm_head", tree["lm_head"][0])):
        wrong = dict(tree, **{name: bad})
        with pytest.raises(ValueError, match=rf"\['{name}'\]: shape"):
            tlm.params_from_numpy(cfg, wrong, CPU)


def test_serve_launcher_audio_prompts_on_cpu(capsys):
    serve.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["output_shape"] == [2, 4, 7]


# -- olmo's parameter-free norm; qwen1.5's QKV bias ------------------------

def test_olmo_norm_has_no_parameters():
    jcfg, jparams, cfg, params = _build("olmo-1b")
    seg = params["segments"][0]
    assert seg["ln1"] == {} and seg["ln2"] == {} and params["final_norm"] == {}
    x = np.random.default_rng(10).normal(size=(2, 8, cfg.d_model)) * 3 + 1
    _close(tcommon.apply_norm(cfg, {}, _t(x)),
           jcommon.apply_norm(jcfg, {}, jnp.array(x, jnp.float32)))


def _nonzero_biases(jparams):
    attn = dict(jparams["segments"][0]["attn"])
    rng = np.random.default_rng(11)
    for name in ("b_q", "b_kv", "b_v"):
        attn[name] = jnp.array(rng.normal(size=attn[name].shape) * 0.5,
                               jnp.float32)
    seg = dict(jparams["segments"][0], attn=attn)
    return dict(jparams, segments=[seg])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_qwen_qkv_bias_nonzero_matches(use_kernel):
    jcfg, jparams, cfg, params = _build("qwen1.5-110b",
                                        mutate=_nonzero_biases)
    assert float(params["segments"][0]["attn"]["b_kv"].abs().min()) > 0
    toks = _tokens(cfg, 2, 16, seed=12)
    want, _ = jlm.forward(jcfg, jparams, {"tokens": jnp.array(toks)},
                          use_kernel=use_kernel)
    got, _ = tlm.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                         use_kernel=use_kernel)
    _close(got, want)
    # the biases matter: zeroing them moves the logits
    zero = tlm.tree_map(lambda t: t, params)
    for name in ("b_q", "b_kv", "b_v"):
        zero["segments"][0]["attn"][name] = torch.zeros_like(
            params["segments"][0]["attn"][name])
    other, _ = tlm.forward(cfg, zero, {"tokens": torch.from_numpy(toks)},
                           use_kernel=use_kernel)
    assert float((other - got).abs().max()) > 1e-3


def test_serve_batch_example_on_cpu(capsys):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples_torch", "serve_batch.py")
    spec = importlib.util.spec_from_file_location("example_serve_batch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 8 requests x 32 new tokens" in out
    assert "sliding-window decode ok: (8, 36)" in out
