"""Port parity for the sequence kernels K4 (flash attention) and K5 (SSD
scan).

The plain PyTorch versions, and the kernel wrappers on CPU tensors
(which run those plain versions), are held against ``repro``'s Pallas
kernels in interpret mode and its jnp oracles, on the same numpy
inputs, at the shapes and tolerances of ``tests/test_kernels.py``. The
CUDA kernels themselves run only on the card (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as fa_kernel
from repro.kernels.flash_attention import ref as fa_ref
from repro.kernels.ssd_scan import kernel as ssd_kernel
from repro.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.flash_attention import kernel as tfa
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.ssd_scan import kernel as tssd
from repro_torch.kernels.ssd_scan import ops as tssd_ops
from repro_torch.kernels.ssd_scan import ref as tssd_ref

torch.set_num_threads(1)

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(arr, dtype):
    """The same values as a jax array and a torch tensor of one type."""
    j = jnp.array(arr, dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(_TORCH[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ flash attn
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s,h,kh,d,bq,bk", [
    (128, 4, 4, 64, 128, 128),    # MHA, single block
    (256, 4, 2, 64, 128, 128),    # GQA 2:1
    (256, 8, 1, 32, 64, 128),     # MQA, mixed blocks
    (192, 2, 2, 128, 128, 64),    # non-multiple seq/block
])
def test_flash_attention_plain_matches_pallas(dtype, s, h, kh, d, bq, bk):
    """Plain version and the CPU wrapper against the Pallas kernel in
    interpret mode and the jnp oracle: 2e-6 in fp32; bf16 compared in
    fp32 at 2e-2 (the two frameworks round the bf16 output alike, but
    the fp32 sums before it differ in order)."""
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.normal(size=(2, s, h, d)), dtype)
    kj, kt = _pair(rng.normal(size=(2, s, kh, d)), dtype)
    vj, vt = _pair(rng.normal(size=(2, s, kh, d)), dtype)
    pallas = fa_kernel.flash_attention(qj, kj, vj, causal=True, block_q=bq,
                                       block_k=bk, interpret=True)
    oracle = fa_ref.attention_reference(qj, kj, vj, causal=True)
    plain = tfa.flash_attention_plain(qt, kt, vt, causal=True)
    wrapped = tfa_ops.flash_attention(qt, kt, vt, causal=True)
    assert plain.dtype == qt.dtype and plain.shape == qt.shape
    tol = 2e-6 if dtype == jnp.float32 else 2e-2
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol,
                                   atol=tol)
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("window", [16, 64, 1])
def test_flash_attention_plain_sliding_window(window):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.normal(size=(1, 128, 2, 32)), jnp.float32)
    kj, kt = _pair(rng.normal(size=(1, 128, 2, 32)), jnp.float32)
    vj, vt = _pair(rng.normal(size=(1, 128, 2, 32)), jnp.float32)
    pallas = fa_kernel.flash_attention(qj, kj, vj, causal=True,
                                       window=window, block_q=64,
                                       block_k=64, interpret=True)
    oracle = fa_ref.attention_reference(qj, kj, vj, causal=True,
                                        window=window)
    plain = tfa_ops.flash_attention(qt, kt, vt, causal=True, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_f32(plain), _f32(want), rtol=2e-6,
                                   atol=2e-6)


def test_flash_attention_cpu_wrapper_launches_nothing():
    q = torch.zeros((1, 8, 2, 32))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, q, q)
    assert tfa.launch_counts() == {"flash_attention": 0}


# -------------------------------------------------------------- ssd scan
def _ssd_inputs(rng, bsz, s, h, p, n, dtype):
    xj, xt = _pair(rng.normal(size=(bsz, s, h, p)), dtype)
    dtj, dtt = _pair(rng.uniform(0.01, 0.2, size=(bsz, s, h)), jnp.float32)
    aj, at = _pair(-rng.uniform(0.5, 2.0, size=(h,)), jnp.float32)
    bj, bt = _pair(rng.normal(size=(bsz, s, h, n)), dtype)
    cj, ct = _pair(rng.normal(size=(bsz, s, h, n)), dtype)
    dj, dt_ = _pair(rng.normal(size=(h,)), jnp.float32)
    return (xj, dtj, aj, bj, cj, dj), (xt, dtt, at, bt, ct, dt_)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s,h,p,n,chunk", [
    (64, 2, 8, 16, 16),
    (128, 3, 16, 8, 32),
    (32, 1, 4, 4, 32),     # single chunk
    (96, 2, 8, 8, 16),     # many chunks
])
def test_ssd_plain_matches_pallas(dtype, s, h, p, n, chunk):
    """y within 1e-5 (5e-2 in bf16) and the final state within 1e-4 of
    the Pallas kernel in interpret mode and of the jnp oracle."""
    rng = np.random.default_rng(3)
    (xj, dtj, aj, bj, cj, dj), (xt, dtt, at, bt, ct, dt_) = _ssd_inputs(
        rng, 2, s, h, p, n, dtype)
    yk, sk = ssd_kernel.ssd_scan_kernel(xj, dtj, aj, bj, cj, d_skip=dj,
                                        chunk=chunk, interpret=True)
    yr, sr = ssd_ref.ssd_reference(xj, dtj, aj, bj, cj, chunk=chunk,
                                   d_skip=dj)
    y, st = tssd.ssd_scan_plain(xt, dtt, at, bt, ct, chunk=chunk,
                                d_skip=dt_)
    yw, sw = tssd_ops.ssd_scan(xt, dtt, at, bt, ct, chunk=chunk, d_skip=dt_)
    assert y.dtype == xt.dtype and st.dtype == torch.float32
    tol = 1e-5 if dtype == jnp.float32 else 5e-2
    for want_y, want_s in ((yk, sk), (yr, sr)):
        np.testing.assert_allclose(_f32(y), _f32(want_y), rtol=tol, atol=tol)
        np.testing.assert_allclose(_f32(st), _f32(want_s), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(yw, y) and torch.equal(sw, st)


def test_ssd_plain_without_d_skip_matches_pallas():
    rng = np.random.default_rng(6)
    (xj, dtj, aj, bj, cj, _), (xt, dtt, at, bt, ct, _) = _ssd_inputs(
        rng, 1, 64, 2, 8, 8, jnp.float32)
    yk, sk = ssd_kernel.ssd_scan_kernel(xj, dtj, aj, bj, cj, chunk=16,
                                        interpret=True)
    y, st = tssd_ops.ssd_scan(xt, dtt, at, bt, ct, chunk=16)
    np.testing.assert_allclose(_f32(y), _f32(yk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(st), _f32(sk), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_ssd_scan_grouped_bc_matches_pallas(groups):
    """B and C per group, (B, S, G, N), through the port's wrapper on the
    CPU, against the Pallas kernel in interpret mode on the same values
    broadcast to the 4 heads with np.repeat: y and the final state within
    1e-5."""
    rng = np.random.default_rng(10 + groups)
    bsz, s, h, p, n, chunk = 2, 64, 4, 8, 16, 16
    x = rng.normal(size=(bsz, s, h, p))
    dt = rng.uniform(0.01, 0.2, size=(bsz, s, h))
    a = -rng.uniform(0.5, 2.0, size=(h,))
    b = rng.normal(size=(bsz, s, groups, n))
    c = rng.normal(size=(bsz, s, groups, n))
    d = rng.normal(size=(h,))
    j = [jnp.array(v, jnp.float32) for v in
         (x, dt, a, np.repeat(b, h // groups, axis=2),
          np.repeat(c, h // groups, axis=2), d)]
    t = [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, a, b, c, d)]
    yk, sk = ssd_kernel.ssd_scan_kernel(*j[:5], d_skip=j[5], chunk=chunk,
                                        interpret=True)
    y, st = tssd_ops.ssd_scan(*t[:5], chunk=chunk, d_skip=t[5])
    assert y.shape == (bsz, s, h, p) and st.shape == (bsz, h, p, n)
    np.testing.assert_allclose(_f32(y), _f32(yk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(st), _f32(sk), rtol=1e-5, atol=1e-5)


def test_ssd_scan_refuses_heads_not_divisible_by_groups():
    x = torch.zeros((1, 32, 4, 8))
    b = torch.zeros((1, 32, 3, 16))
    with pytest.raises(ValueError, match="H % G == 0: H = 4"):
        tssd.ssd_scan(x, torch.zeros((1, 32, 4)), torch.zeros(4), b, b,
                      chunk=16)


def test_ssd_chunk_must_divide_sequence():
    x = torch.zeros((1, 48, 2, 4))
    b = torch.zeros((1, 48, 2, 8))
    with pytest.raises(ValueError, match="48.*32"):
        tssd.ssd_scan(x, torch.zeros((1, 48, 2)), torch.zeros(2), b, b,
                      chunk=32)


def _ssd_f32(seed, B, S, H, P, N, hi=0.3):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, S, H, P)), rng.uniform(0.01, hi, (B, S, H)),
            -rng.uniform(0.5, 2.0, size=(H,)), rng.normal(size=(B, S, H, N)),
            rng.normal(size=(B, S, H, N)))
    return ([jnp.array(a, jnp.float32) for a in arrs],
            [torch.from_numpy(a.astype(np.float32)) for a in arrs])


def test_ssd_chunked_equals_sequential():
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _ssd_f32(4, 1, 48, 2, 4, 8)
    y1, s1 = tssd_ref.ssd_reference(xt, dtt, at, bt, ct, chunk=16)
    y2, s2 = tssd_ref.ssd_sequential_reference(xt, dtt, at, bt, ct)
    np.testing.assert_allclose(_f32(y1), _f32(y2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(s1), _f32(s2), rtol=1e-5, atol=1e-5)
    yj, sj = ssd_ref.ssd_sequential_reference(xj, dtj, aj, bj, cj)
    np.testing.assert_allclose(_f32(y2), _f32(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(s2), _f32(sj), rtol=1e-5, atol=1e-5)


def test_ssd_decode_step_consistent_with_scan():
    """Running ssd_step token by token reproduces the chunked scan, and
    each step matches repro's ssd_step."""
    B, S, H, P, N = 2, 16, 2, 4, 8
    (xj, dtj, aj, bj, cj), (xt, dtt, at, bt, ct) = _ssd_f32(5, B, S, H, P, N)
    y_scan, _ = tssd_ref.ssd_reference(xt, dtt, at, bt, ct, chunk=8)
    st = torch.zeros((B, H, P, N))
    stj = jnp.zeros((B, H, P, N), jnp.float32)
    ys = []
    for t in range(S):
        y, st = tssd_ref.ssd_step(st, xt[:, t], dtt[:, t], at, bt[:, t],
                                  ct[:, t])
        yj, stj = ssd_ref.ssd_step(stj, xj[:, t], dtj[:, t], aj, bj[:, t],
                                   cj[:, t])
        np.testing.assert_allclose(_f32(y), _f32(yj), rtol=1e-6, atol=1e-6)
        ys.append(y)
    np.testing.assert_allclose(_f32(st), _f32(stj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_f32(torch.stack(ys, 1)), _f32(y_scan),
                               rtol=1e-5, atol=1e-5)


def test_segsum_matches_repro():
    rng = np.random.default_rng(7)
    la = rng.normal(size=(3, 12)).astype(np.float32)
    got = tssd_ref.segsum(torch.from_numpy(la)).numpy()
    want = np.asarray(ssd_ref.segsum(jnp.array(la)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
