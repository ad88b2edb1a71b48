"""Port parity for the fitmask kernels and engines.

The plain PyTorch versions of the three kernels, the kernel wrappers on
CPU tensors (which run those plain versions) and every ``repro_torch``
engine on ``device="cpu"`` are held bit-exact against ``repro``'s
Pallas kernels in interpret mode and its numpy oracle
``repro.core.fitmask.fit_mask_multi``, on the same numpy inputs. The
CUDA kernels themselves run only on the card (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fitmask as ref_np
from repro.kernels.fitmask import kernel as pallas
from repro_torch.kernels.fitmask import kernel as tk
from repro_torch.kernels.fitmask import ops as tops
from repro_torch.kernels.fitmask import ref as tref

torch.set_num_threads(1)

CPU_ENGINES = ("cuda", "torch", "ref")


def _grids(seed, bsz, grid, p=0.3):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(bsz,) + tuple(grid)) < p


def _case(seed):
    """Random batch, grid and K boxes with extents up to 8 on 3..7 grids,
    so boxes that fit nowhere or overhang entirely are included."""
    rng = np.random.default_rng(seed)
    bsz = int(rng.integers(1, 4))
    grid = tuple(int(v) for v in rng.integers(3, 8, size=3))
    k = int(rng.integers(1, 7))
    boxes = tuple(tuple(int(v) for v in rng.integers(1, 9, size=3))
                  for _ in range(k))
    return _grids(seed, bsz, grid), boxes


@pytest.mark.parametrize("seed", range(8))
def test_multibox_matches_pallas_and_numpy_oracle(seed):
    occ, boxes = _case(seed)
    want = np.asarray(pallas.fitmask_multibox(jnp.array(occ), boxes,
                                              interpret=True))
    assert (want == ref_np.fit_mask_multi(occ, boxes)).all()
    t = torch.from_numpy(occ)
    outs = {
        "plain": tk.fitmask_multibox_plain(t, boxes),
        "wrapper": tk.fitmask_multibox(t, boxes),
        "unfold": tref.fitmask_multibox_reference(t, boxes),
    }
    for name in CPU_ENGINES:
        outs[name] = tops.get_engine(name, device="cpu").multibox(occ, boxes)
    for name, out in outs.items():
        assert out.dtype == torch.int32, name
        assert out.shape == want.shape, name
        assert (out.numpy() == want).all(), name


@pytest.mark.parametrize("box", [(1, 1, 1), (2, 3, 2), (6, 5, 6), (4, 4, 4),
                                 (7, 1, 1)])
def test_single_box_matches_pallas(box):
    occ = _grids(7, 4, (6, 5, 6), p=0.35)
    want = np.asarray(pallas.fitmask_batched(jnp.array(occ), box,
                                             interpret=True))
    t = torch.from_numpy(occ)
    for out in (tk.fitmask_batched_plain(t, box), tk.fitmask_batched(t, box),
                tops.get_engine("cuda", device="cpu").fitmask(occ, box),
                tref.fitmask_reference(t, box)):
        assert out.dtype == torch.int32
        assert (out.numpy() == want).all()


def test_multibox_k1_equals_single_box():
    t = torch.from_numpy(_grids(7, 4, (6, 5, 6), p=0.35))
    for box in [(1, 1, 1), (2, 3, 2), (6, 5, 6), (4, 4, 4), (7, 1, 1)]:
        multi = tk.fitmask_multibox(t, [box])
        assert multi.shape[1] == 1
        assert torch.equal(multi[:, 0], tk.fitmask_batched(t, box)), box


def test_multibox_empty_box_list():
    t = torch.zeros((2, 4, 4, 4), dtype=torch.bool)
    assert tk.fitmask_multibox_plain(t, []).shape == (2, 0, 4, 4, 4)
    assert tk.fitmask_multibox(t, ()).shape == (2, 0, 4, 4, 4)
    for name in CPU_ENGINES:
        out = tops.get_engine(name, device="cpu").multibox(t, [])
        assert out.shape == (2, 0, 4, 4, 4), name


@pytest.mark.parametrize("seed", range(3))
def test_occupancy_counts_match_pallas(seed):
    occ = _grids(seed, 5, (4, 6, 3), p=0.4)
    want = np.asarray(pallas.occupancy_counts(jnp.array(occ), interpret=True))
    t = torch.from_numpy(occ)
    for out in (tk.occupancy_counts_plain(t), tk.occupancy_counts(t)):
        assert out.dtype == torch.int32
        assert (out.numpy() == want).all()
    free = ref_np.free_counts(occ)
    for name in CPU_ENGINES:
        got = tops.get_engine(name, device="cpu").free_counts(occ)
        assert (got.numpy() == free).all(), name


def test_64_cube_case():
    """The reconfigurable torus's batched per-cube check, by brute force."""
    cubes = _grids(0, 64, (4, 4, 4), p=0.4)
    out = tops.fitmask(cubes, (4, 2, 1), engine="kernel", device="cpu")
    for i in range(64):
        brute = np.zeros((4, 4, 4), np.int32)
        for y in range(3):
            for z in range(4):
                brute[0, y, z] = not cubes[i, :, y:y + 2, z:z + 1].any()
        assert (out[i].numpy() == brute).all()


def test_torch_engine_bucketed_matches_numpy():
    """The tensor engines' bucketed answer (the default two calls) holds
    the numpy engine's fused bool planes and free counts."""
    occ, boxes = _case(11)
    np_planes, np_free = tops.get_engine("numpy").multibox_bucketed(occ, boxes)
    for name in CPU_ENGINES:
        planes, free = tops.get_engine(name, device="cpu").multibox_bucketed(
            occ, boxes)
        assert ((planes.numpy() != 0) == np_planes).all(), name
        assert (free.numpy() == np_free).all(), name


def test_box_table_and_smem_limits():
    with pytest.raises(ValueError):
        tk.box_table([(1, 0, 2)])
    assert tk.box_table([(1, 2, 3)]).dtype == np.int32
    # row words (8 bytes an (x, y) row) and two staging words an item
    assert tk.check_grid((16, 16, 16)) == 8 * 16 * 16 + 16 * 256
    assert tk.check_grid((38, 38, 38)) == 8 * 38 * 38 + 16 * 256
    assert tk.check_grid((64, 64, 64)) == 8 * 64 * 64 + 16 * 256
    with pytest.raises(ValueError, match="at most 64"):
        tk.check_grid((4, 4, 65))
    with pytest.raises(ValueError, match="shared memory"):
        tk.check_grid((200, 200, 1))
    with pytest.raises(ValueError, match="at most 64"):
        tk.launch_plan(1, 4, 4, 65, tk.box_table([(1, 1, 1)]))


# Grids beyond the 37^3 of an int32 integral image in shared memory, with
# the boxes at the edges of the bit-row kernel: one cell, a box as long
# as the row or one longer along z (c = 63, 64, 65 at Z = 64), the whole
# grid, and boxes that overhang on x or y.
LARGE_CASES = [
    ((64, 64, 64), [(1, 1, 1), (1, 1, 63), (2, 3, 64), (1, 1, 65),
                    (64, 64, 64), (65, 1, 1), (3, 5, 7)]),
    ((40, 40, 40), [(1, 1, 1), (1, 1, 39), (40, 40, 40), (1, 41, 1),
                    (7, 3, 40), (20, 20, 41)]),
]


@pytest.mark.parametrize("dims,boxes", LARGE_CASES,
                         ids=["64^3", "40^3"])
def test_plain_versions_match_numpy_oracle_on_large_grids(dims, boxes):
    occ = _grids(5, 1, dims, p=0.002)
    want = ref_np.fit_mask_multi(occ, boxes)
    assert want.any()
    t = torch.from_numpy(occ)
    assert (tk.fitmask_multibox_plain(t, boxes).numpy() == want).all()
    for k, box in enumerate(boxes):
        assert (tk.fitmask_batched_plain(t, box).numpy() == want[:, k]).all()


def _free_runs(o, c, z):
    if c > z:
        return 0
    s = 1
    while s < c:
        t = min(s, c - s)
        o |= o >> t
        s += t
    return ~o & ((1 << (z - c + 1)) - 1)


def _emulate_kernel(occ, boxes, plan):
    """``fitmask_multibox_kernel`` of ``csrc/fitmask.cu`` step by step in
    Python, block by block as ``plan`` cuts the work: row words, the OR
    over the box's rows (direct, staged, or along y by doubling across
    the 32 lanes of a warp), the doubled shift along z, and the stores.
    Every output cell must be written exactly once."""
    bsz, x_, y_, z_ = occ.shape
    xy, kx = x_ * y_, len(boxes) * x_
    flat = occ.reshape(-1)
    out = np.full(flat.size * len(boxes), -1, np.int64)
    for blk in range(plan.blocks):
        g0 = blk // plan.bpg * plan.gpb
        u0 = blk % plan.bpg * plan.upb
        u1 = min(u0 + plan.upb, min(plan.gpb, bsz - g0) * kx)
        n = (u1 - u0) * y_
        rows = [sum(int(flat[(g0 * xy + r) * z_ + z]) << z
                    for z in range(z_))
                for r in range(min(plan.gpb, bsz - g0) * xy)]
        items = []
        for i in range(n):
            u = u0 + i // y_
            g, k, x, y = u // kx, u % kx // x_, u % x_, i % y_
            items.append((g * xy + x * y_ + y, x, y, boxes[k]))
        col = [0] * n        # OR of the a rows along x
        for i, (r, x, y, (a, b, c)) in enumerate(items):
            if x + a <= x_:
                for p in range(a):
                    col[i] |= rows[r + p * y_]
        acc = [0] * n        # OR of the a x b rows
        for i, (r, x, y, (a, b, c)) in enumerate(items):
            if plan.mode == "staged" and y + b <= y_:
                for q in range(b):
                    acc[i] |= col[i + q]
            elif plan.mode == "direct" and x + a <= x_ and y + b <= y_:
                for p in range(a):
                    for q in range(b):
                        acc[i] |= rows[r + p * y_ + q]
        if plan.mode == "shuffle":
            for w0 in range(0, n, 32):       # whole warps, dead lanes too
                lanes = [(col[i], items[i][3][1]) if i < n else (0, 1)
                         for i in range(w0, w0 + 32)]
                o = [v for v, _ in lanes]
                s = [1] * 32
                while any(s[ln] < lanes[ln][1] for ln in range(32)):
                    t = [min(s[ln], lanes[ln][1] - s[ln])
                         if s[ln] < lanes[ln][1] else 0 for ln in range(32)]
                    o = [o[ln] | o[(ln + t[ln]) % 32] for ln in range(32)]
                    s = [s[ln] + t[ln] for ln in range(32)]
                acc[w0:w0 + 32] = o[:n - w0]
        fits = [_free_runs(acc[i], c, z_)
                if x + a <= x_ and y + b <= y_ else 0
                for i, (r, x, y, (a, b, c)) in enumerate(items)]
        d0 = (g0 * kx + u0) * y_ * z_
        for j in range(n * z_):
            assert out[d0 + j] == -1
            out[d0 + j] = (fits[j // z_] >> (j % z_)) & 1
    assert (out >= 0).all()
    return out.reshape((bsz, len(boxes)) + occ.shape[1:])


@pytest.mark.parametrize("mode", tk.OR_MODES)
@pytest.mark.parametrize("seed", range(4))
def test_bit_row_kernel_emulated_matches_plain(seed, mode):
    """The CUDA kernel's arithmetic and its blocks, as launch_plan cuts
    them, on ragged grids (Z 1..9 and 64) and boxes past every edge."""
    rng = np.random.default_rng(100 + seed)
    bsz = int(rng.integers(1, 40))
    dims = tuple(int(v) for v in rng.integers(1, 8, size=3))
    if seed == 2:
        dims = dims[:2] + (64,)
    if mode == "shuffle":
        dims = (dims[0], int(rng.choice([1, 2, 4, 8])), dims[2])
    boxes = [tuple(int(v) for v in rng.integers(1, 9, size=3))
             for _ in range(int(rng.integers(1, 6)))]
    boxes += [(1, 1, dims[2]), (1, 1, dims[2] + 1), (1, 1, 1)]
    occ = rng.uniform(size=(bsz,) + dims) < 0.15
    plan = tk.launch_plan(bsz, *dims, tk.box_table(boxes), mode=mode)
    want = tk.fitmask_multibox_plain(torch.from_numpy(occ), boxes).numpy()
    assert (_emulate_kernel(occ, boxes, plan) == want).all()


def test_launch_plan_at_the_loops_shapes():
    """The placement loop's shapes take the shuffle OR, one item a
    thread, within the grid's shared-memory limit; one 16^3 grid and one
    box is a single block of 256 threads, small grids take blocks of 128.
    Elsewhere boxes of up to 16 rows take the direct OR and larger ones
    the staged OR."""
    for bsz, k, n in [(1, 1, 16), (1, 51, 16), (8, 282, 8), (64, 64, 4),
                      (512, 8, 2)]:
        plan = tk.launch_plan(bsz, n, n, n, tk.box_table([(1, 1, 1)] * k))
        assert plan.mode == "shuffle"
        assert plan.blocks * plan.threads >= bsz * k * n * n
        assert plan.smem <= tk.check_grid((n, n, n))
    one = tk.launch_plan(1, 16, 16, 16, tk.box_table([(2, 3, 4)]))
    assert (one.threads, one.blocks) == (256, 1)
    cubes = tk.launch_plan(64, 4, 4, 4, tk.box_table([(4, 4, 4)]))
    assert cubes.threads == 128
    # the last two boxes overhang the 5 x 6 rows
    small = tk.box_table([(4, 4, 9), (9, 1, 1), (1, 7, 1)])
    assert tk.launch_plan(2, 5, 6, 7, small).mode == "direct"
    big = tk.box_table([(5, 4, 1)])
    assert tk.launch_plan(2, 5, 6, 7, big).mode == "staged"
    with pytest.raises(ValueError, match="32 % Y"):
        tk.launch_plan(2, 5, 6, 7, big, mode="shuffle")


def test_wrappers_reject_other_devices_and_count_no_cpu_launches():
    meta = torch.empty((1, 4, 4, 4), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tk.fitmask_multibox(meta, [(1, 1, 1)])
    with pytest.raises(ValueError):
        tk.occupancy_counts(meta)
    tk.reset_launch_counts()
    t = torch.from_numpy(_grids(3, 2, (4, 4, 4)))
    tk.fitmask_multibox(t, [(1, 2, 1), (2, 2, 2)])
    tk.fitmask_batched(t, (1, 1, 1))
    tk.occupancy_counts(t)
    assert tk.launch_counts() == {"fitmask_multibox": 0,
                                  "fitmask_batched": 0,
                                  "occupancy_counts": 0}
