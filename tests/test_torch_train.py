"""Port parity for training: AdamW and its schedule, the synthetic data,
checkpoints across the packages, the loss's gradients against
``jax.grad``, the train step and gradient accumulation, and the
launcher. Mirrors tests/test_train_substrate.py (its ``shard_batch``
test is ported in tests/test_torch_launch.py).

``repro``'s parameters from ``init_model(cfg, PRNGKey(0))`` are carried
across with ``params_from_numpy``; batches come from each package's
``synthetic_batches`` with one seed (byte-identical). Gradients agree
within rtol 1e-4 / atol 1e-6, optimizer updates within 1e-6.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke_variant
from repro.models import model as jlm
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optim as joptim
from repro.train import train_step as jts
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as tlm
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.train.data import synthetic_batches
from repro_torch.train.optim import (OptimConfig, adamw_update, global_norm,
                                     init_opt_state, lr_at)
from repro_torch.train.train_step import (cross_entropy, loss_fn,
                                          train_step, train_step_accum,
                                          value_and_grad)

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# one family of each kind the loss treats apart: dense, the xLSTM
# recurrences, Mamba2 with shared attention, MoE (aux loss) with MLA,
# audio (targets (B, K, S))
GRAD_ARCHS = ["olmo-1b", "xlstm-1.3b", "zamba2-1.2b", "deepseek-v2-236b",
              "musicgen-medium"]


def _build(arch, seed=0):
    jcfg = jsmoke_variant(jget_config(arch))
    cfg = smoke_variant(get_config(arch))
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, tlm.params_from_numpy(cfg, tree, CPU)


@pytest.fixture(scope="module")
def tiny():
    return _build("olmo-1b")


def _at(tree, path):
    """The port's leaf at a jax key path."""
    for p in path:
        tree = tree[getattr(p, "key", getattr(p, "idx", None))]
    return tree


def _close_trees(got, want, rtol, atol):
    """Every leaf of repro's ``want`` against the port's at its path."""
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(tlm.tree_leaves(got))
    for path, w in leaves:
        g = _at(got, path)
        np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol,
            err_msg=jax.tree_util.keystr(path))


# -- optimizer ---------------------------------------------------------------

def test_lr_schedule_shape():
    oc = OptimConfig(lr=1.0, warmup_steps=10, total_steps=110,
                     min_lr_ratio=0.1)
    assert float(lr_at(oc, 0)) == pytest.approx(0.0)
    assert float(lr_at(oc, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(oc, 110)) == pytest.approx(0.1, rel=1e-3)
    assert 0.1 < float(lr_at(oc, 60)) < 1.0


@pytest.mark.parametrize("oc", [
    OptimConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1),
    OptimConfig(lr=3e-4, warmup_steps=0, total_steps=100),
    OptimConfig()], ids=["warm10", "nowarm", "default"])
def test_lr_at_equals_repro(oc):
    joc = joptim.OptimConfig(**oc.__dict__)
    steps = np.arange(121, dtype=np.int32)
    want = np.array([float(joptim.lr_at(joc, jnp.array(s))) for s in steps])
    got = lr_at(oc, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_clips_and_decays():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    grads = {"w": torch.full((4, 4), 100.0), "b": torch.full((4,), 100.0)}
    st = init_opt_state(params)
    oc = OptimConfig(lr=0.1, clip_norm=1.0, warmup_steps=0, total_steps=10)
    p1, st1, m = adamw_update(oc, params, grads, st)
    assert float(m["grad_norm"]) > 1.0
    assert int(st1["step"]) == 1 and st1["step"].dtype == torch.int32
    assert not torch.allclose(p1["w"], params["w"])
    assert torch.equal(params["w"], torch.ones((4, 4)))   # left as it was


def _opt_tree(rng):
    """A params tree with a matrix, a 1-D leaf and a stacked 1-D leaf
    (a scanned segment's norm scale, (L, d)), in a list as segments."""
    return {"w": rng.normal(size=(4, 6)), "b": rng.normal(size=(6,)),
            "segments": [{"scale": 1.0 + rng.normal(size=(3, 6)) * 0.1}]}


def test_adamw_update_equals_repro_and_decays_stacked_1d_leaves():
    """Three steps from identical params and grads within 1e-6 of
    repro's. The stacked 1-D leaf has ndim 2, so both packages decay it
    (ROADMAP Queue 3 entry 7: repro's "matrices only" comment says
    otherwise; kept for parity); the 1-D leaf is not decayed."""
    rng = np.random.default_rng(0)
    params_np = _opt_tree(rng)
    oc = OptimConfig(lr=1e-2, warmup_steps=1, total_steps=5, clip_norm=0.5)
    joc = joptim.OptimConfig(**oc.__dict__)
    jp = jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float32),
                                params_np)
    tp = tlm.tree_map(lambda a: torch.tensor(a, dtype=torch.float32),
                      params_np)
    jst, st = joptim.init_opt_state(jp), init_opt_state(tp)
    for i in range(3):
        g_np = _opt_tree(np.random.default_rng(10 + i))
        jg = jax.tree_util.tree_map(lambda a: jnp.array(a, jnp.float32), g_np)
        tg = tlm.tree_map(lambda a: torch.tensor(a, dtype=torch.float32), g_np)
        jp, jst, jm = joptim.adamw_update(joc, jp, jg, jst)
        tp, st, m = adamw_update(oc, tp, tg, st)
        _close_trees(tp, jp, 1e-6, 1e-6)
        _close_trees(st, jst, 1e-6, 1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    # zero grads from a fresh state: the update is lr * weight_decay * p
    # on the decayed leaves and nothing elsewhere
    zeros = tlm.tree_map(torch.zeros_like, tp)
    p2, _, m = adamw_update(oc, tp, zeros, init_opt_state(tp))
    lr = float(m["lr"])
    stacked = tp["segments"][0]["scale"]
    torch.testing.assert_close(p2["segments"][0]["scale"],
                               stacked - lr * oc.weight_decay * stacked)
    torch.testing.assert_close(p2["b"], tp["b"])


def test_cross_entropy_uniform():
    logits = torch.zeros((2, 3, 7))
    tgt = torch.zeros((2, 3), dtype=torch.int32)
    assert float(cross_entropy(logits, tgt)) == pytest.approx(np.log(7),
                                                              rel=1e-5)


def test_cross_entropy_and_global_norm_equal_repro():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 4, 11)) * 3
    tgt = rng.integers(0, 11, (2, 5, 4)).astype(np.int32)
    want = jts.cross_entropy(jnp.array(logits, jnp.float32), jnp.array(tgt))
    got = cross_entropy(torch.tensor(logits, dtype=torch.float32),
                        torch.from_numpy(tgt))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    tree = _opt_tree(rng)
    want = joptim.global_norm(jax.tree_util.tree_map(jnp.array, tree))
    got = global_norm(tlm.tree_map(
        lambda a: torch.tensor(a, dtype=torch.float32), tree))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_global_norm():
    t = {"a": torch.ones((3,)), "b": torch.full((4,), 2.0)}
    assert float(global_norm(t)) == pytest.approx(np.sqrt(3 + 16))


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "musicgen-medium"])
def test_synthetic_batches_byte_identical_to_repro(arch):
    """Text (B, S) and audio (B, K, S) shapes; three batches each."""
    cfg = smoke_variant(get_config(arch))
    jit = jdata.synthetic_batches(jsmoke_variant(jget_config(arch)), 3, 17,
                                  seed=5)
    it = synthetic_batches(cfg, 3, 17, seed=5, device=CPU)
    for _ in range(3):
        want, got = next(jit), next(it)
        for k in ("tokens", "targets"):
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def test_synthetic_data_deterministic(tiny):
    cfg = tiny[2]
    a = next(synthetic_batches(cfg, 2, 8, seed=3, device=CPU))
    b = next(synthetic_batches(cfg, 2, 8, seed=3, device=CPU))
    assert torch.equal(a["tokens"], b["tokens"])
    assert (a["tokens"] < cfg.vocab_size).all()
    # targets are next tokens
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])


# -- checkpoints -------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, tiny):
    cfg, params = tiny[2], tiny[3]
    opt = init_opt_state(params)
    path = os.path.join(tmp_path, "ckpt.npz")
    save_checkpoint(path, params, opt, step=7, meta={"arch": cfg.name})
    zeroed = tlm.tree_map(torch.zeros_like, params)
    p2, o2, meta = load_checkpoint(path, zeroed,
                                   tlm.tree_map(torch.zeros_like, opt))
    assert meta["step"] == 7 and meta["arch"] == cfg.name
    for a, b in zip(tlm.tree_leaves(params), tlm.tree_leaves(p2)):
        assert torch.equal(a, b)
    assert o2["step"].dtype == torch.int32


def test_checkpoints_load_across_the_packages(tmp_path):
    """A checkpoint written by repro loads in the port and one written by
    the port loads in repro, params and optimizer state bit for bit."""
    jcfg, jparams, cfg, params = _build("xlstm-1.3b")
    jopt = joptim.init_opt_state(jparams)
    jopt = {**jopt, "mu": jax.tree_util.tree_map(lambda p: p * 0.5, jparams),
            "step": jnp.array(3, jnp.int32)}
    jpath = os.path.join(tmp_path, "from_repro.npz")
    jckpt.save_checkpoint(jpath, jparams, jopt, step=3, meta={"by": "repro"})
    like = tlm.tree_map(torch.zeros_like, params)
    p, o, meta = load_checkpoint(jpath, like, init_opt_state(like))
    assert meta == {"step": 3, "by": "repro"} and int(o["step"]) == 3
    _close_trees(p, jparams, 0, 0)
    _close_trees(o, jopt, 0, 0)

    tpath = os.path.join(tmp_path, "from_port.npz")
    save_checkpoint(tpath, p, o, step=4, meta={"by": "repro_torch"})
    jlike = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jp2, jo2, jmeta = jckpt.load_checkpoint(
        tpath, jlike, jax.tree_util.tree_map(jnp.zeros_like, jopt))
    assert jmeta == {"step": 4, "by": "repro_torch"}
    _close_trees(p, jp2, 0, 0)
    _close_trees(o, jo2, 0, 0)


def test_load_checkpoint_refuses_another_shape(tmp_path, tiny):
    params = tiny[3]
    path = os.path.join(tmp_path, "ckpt")
    save_checkpoint(path, params)
    like = dict(params, embed=torch.zeros((3, 3)))
    with pytest.raises(ValueError, match="embed"):
        load_checkpoint(path, like)


# -- loss, gradients, steps --------------------------------------------------

@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_fn_grads_match_jax_grad(arch):
    """The grads themselves (Adam's first step is about sign(g), so the
    updated params alone would hide near-zero grads), the loss and its
    parts."""
    jcfg, jparams, cfg, params = _build(arch)
    jbatch = next(jdata.synthetic_batches(jcfg, 2, 16, seed=0))
    batch = next(synthetic_batches(cfg, 2, 16, seed=0, device=CPU))
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jts.loss_fn(jcfg, p, jbatch), has_aux=True)(jparams)
    (loss, m), grads = value_and_grad(cfg, params, batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ce", "aux"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6)
    if cfg.n_experts:
        assert float(m["aux"]) > 0
    assert not any(leaf.requires_grad for leaf in tlm.tree_leaves(params))
    _close_trees(grads, jgrads, GRAD_RTOL, GRAD_ATOL)


def test_train_step_equals_repro(tiny):
    """One step from identical params and batch: metrics and updated
    params and state against repro's."""
    jcfg, jparams, cfg, params = tiny
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    joc = joptim.OptimConfig(**oc.__dict__)
    jbatch = next(jdata.synthetic_batches(jcfg, 2, 16, seed=2))
    batch = next(synthetic_batches(cfg, 2, 16, seed=2, device=CPU))
    jp, jo, jm = jts.train_step(jcfg, joc, jparams,
                                joptim.init_opt_state(jparams), jbatch)
    p, o, m = train_step(cfg, oc, params, init_opt_state(params), batch)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5)
    _close_trees(o, jo, GRAD_RTOL, GRAD_ATOL)
    # Adam's first step moves each param by lr * g / (|g| + eps): where
    # |g| is near eps, the grads' 1e-4 agreement leaves up to a tenth of
    # lr between the updated params
    _close_trees(p, jp, 0, 0.1 * oc.lr)


def test_loss_decreases_over_steps(tiny):
    cfg, params = tiny[2], tiny[3]
    batch = next(synthetic_batches(cfg, batch=2, seq=32, seed=0, device=CPU))
    oc = OptimConfig(lr=3e-3, warmup_steps=0, total_steps=100)
    opt = init_opt_state(params)
    losses = []
    for _ in range(5):
        params, opt, m = train_step(cfg, oc, params, opt, batch)
        losses.append(float(m["ce"]))
    assert losses[-1] < losses[0]


def test_grad_accum_matches_full_batch(tiny):
    cfg, params = tiny[2], tiny[3]
    batch = next(synthetic_batches(cfg, batch=4, seq=16, seed=1, device=CPU))
    oc = OptimConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=1e9)
    opt = init_opt_state(params)
    p_full, _, m_full = train_step(cfg, oc, params, opt, batch)
    p_acc, _, m_acc = train_step_accum(cfg, oc, params, opt, batch, n_micro=2)
    # accumulation-order fp differences propagate through Adam's
    # sqrt(nu) normalization; 5e-4 bounds that comfortably (as repro's)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(tlm.tree_leaves(p_full), tlm.tree_leaves(p_acc)))
    assert diff < 5e-4
    assert float(m_acc["ce"]) == pytest.approx(float(m_full["ce"]), rel=1e-5)
    # the grads themselves: the mean of the micro-batches' grads
    _, g_full = value_and_grad(cfg, params, batch)
    halves = [value_and_grad(cfg, params, {k: v[i:i + 2]
                                           for k, v in batch.items()})[1]
              for i in (0, 2)]
    for gf, g0, g1 in zip(*(tlm.tree_leaves(g) for g in [g_full] + halves)):
        torch.testing.assert_close((g0 + g1) / 2, gf, rtol=1e-4, atol=1e-6)


def test_plain_kernel_path_trains_on_cpu(tiny):
    """On the CPU, use_kernel=True runs the kernels' plain versions, which
    are differentiable: the same grads as the plain path."""
    cfg, params = tiny[2], tiny[3]
    batch = next(synthetic_batches(cfg, 2, 16, seed=4, device=CPU))
    tfa.reset_launch_counts()
    (_, _), g_kernel = value_and_grad(cfg, params, batch, use_kernel=True)
    (_, _), g_plain = value_and_grad(cfg, params, batch)
    assert tfa.launch_counts()["flash_attention"] == 0
    for a, b in zip(tlm.tree_leaves(g_kernel), tlm.tree_leaves(g_plain)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_finite(arch):
    """Port only, every family: one step from the port's own init, the
    loss finite, the grads non-zero and the params changed."""
    cfg = smoke_variant(get_config(arch))
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), CPU)
    batch = next(synthetic_batches(cfg, 2, 16, seed=0, device=CPU))
    oc = OptimConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p1, o1, m = train_step(cfg, oc, params, init_opt_state(params), batch)
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0
    assert max(float((a - b).abs().max()) for a, b in
               zip(tlm.tree_leaves(params), tlm.tree_leaves(p1))) > 0
    assert all(bool(torch.isfinite(t).all()) for t in tlm.tree_leaves(p1))
    loss, _ = loss_fn(cfg, p1, batch)
    assert torch.isfinite(loss)


# -- entry points ------------------------------------------------------------

def test_train_launcher_on_cpu(tmp_path, capsys):
    ckpt = os.path.join(tmp_path, "ckpt.npz")
    history = train_launcher.main([
        "--arch", "olmo-1b", "--smoke", "--steps", "4", "--batch", "2",
        "--seq", "16", "--log-every", "2", "--ckpt", ckpt,
        "--device", "cpu"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [h["step"] for h in lines] == [0, 2, 3] and lines == history
    assert sorted(lines[0]) == ["ce", "elapsed_s", "grad_norm", "lr", "step"]
    assert os.path.exists(ckpt) and os.path.exists(
        os.path.join(tmp_path, "ckpt.meta.json"))


def test_train_launcher_has_no_mesh_flag():
    # --mesh exists now; a mesh larger than the process group it starts
    # (one rank on the CPU) raises and leaves no group behind
    import torch.distributed as dist
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train_launcher.main(["--arch", "olmo-1b", "--smoke", "--mesh", "2x1",
                             "--device", "cpu"])
    assert not dist.is_initialized()


def test_quickstart_example_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "example_quickstart", os.path.join(ROOT, "examples_torch",
                                           "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    history, out = mod.main(["--device", "cpu"])
    assert len(history) == 10 and history[-1] < history[0]
    assert tuple(out.shape) == (1, 16)
    assert "generated:" in capsys.readouterr().out
