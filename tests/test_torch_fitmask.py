"""Port parity for the fitmask kernels and engines.

The plain PyTorch versions of the four kernels, the kernel wrappers on
CPU tensors (which run those plain versions) and every ``repro_torch``
engine on ``device="cpu"`` are held bit-exact against ``repro``'s
Pallas kernels in interpret mode, its ``JaxEngine`` and its numpy oracle
``repro.core.fitmask.fit_mask_multi``, on the same numpy inputs. The
CUDA kernels themselves run only on the card (``test_torch_cuda.py``);
here their arithmetic and the way their launches cut the work are
replayed in Python."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fitmask as ref_np
from repro.kernels.fitmask import kernel as pallas
from repro.kernels.fitmask import ops as jops
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
    """The tensor engines' bucketed answer holds the numpy engine's fused
    bool planes and free counts: ``torch`` from one integral image (free
    counts off its corner), ``cuda`` from the fused kernel's plain
    version, both with bool planes; ``ref`` by the default two calls."""
    occ, boxes = _case(11)
    np_planes, np_free = tops.get_engine("numpy").multibox_bucketed(occ, boxes)
    for name in CPU_ENGINES:
        planes, free = tops.get_engine(name, device="cpu").multibox_bucketed(
            occ, boxes)
        if name != "ref":
            assert planes.dtype == torch.bool, name
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
    with pytest.raises(ValueError):
        tk.fitmask_multibox_bucketed(meta, [(1, 1, 1)])
    tk.reset_launch_counts()
    t = torch.from_numpy(_grids(3, 2, (4, 4, 4)))
    tk.fitmask_multibox(t, [(1, 2, 1), (2, 2, 2)])
    tk.fitmask_batched(t, (1, 1, 1))
    tk.occupancy_counts(t)
    tk.fitmask_multibox_bucketed(t, [(1, 2, 1)])
    assert tk.launch_counts() == {"fitmask_multibox": 0,
                                  "fitmask_batched": 0,
                                  "occupancy_counts": 0,
                                  "fitmask_multibox_bucketed": 0}


# -- the fused bucketed query and the occupancy counts ---------------------

def _shapes(n):
    return [(a, b, c) for a in range(1, n + 1) for b in range(1, n + 1)
            for c in range(1, n + 1)]


def _boxes(seed, dims, k):
    """k boxes with extents up to two past the grid's, so that some
    overhang on every axis."""
    rng = np.random.default_rng(seed)
    return [tuple(int(rng.integers(1, d + 3)) for d in dims)
            for _ in range(k)]


# (id, B, grid, boxes, offset): the placement loop's grids, rows of 3, 5
# and 13 cells, a view one grid into its storage (occ[1:]), K = 0, and
# boxes larger than the grid.
BUCKET_CASES = [
    ("2^3", 9, (2, 2, 2), _shapes(2), False),
    ("4^3", 6, (4, 4, 4), _boxes(1, (4, 4, 4), 24), False),
    ("8^3", 3, (8, 8, 8), _boxes(2, (8, 8, 8), 16), False),
    ("16^3", 1, (16, 16, 16), _boxes(3, (16, 16, 16), 8), False),
    ("Z 3", 4, (5, 4, 3), _shapes(3), False),
    ("Z 5", 3, (5, 5, 5), _boxes(4, (5, 5, 5), 12), False),
    ("Z 13", 2, (4, 3, 13), _boxes(5, (4, 3, 13), 10), False),
    ("offset Z 3", 4, (4, 3, 3), _shapes(3), True),
    ("offset 4^3", 5, (4, 4, 4), _boxes(6, (4, 4, 4), 9), True),
    ("K=0", 3, (4, 4, 4), [], False),
    ("oversize", 3, (4, 4, 4), [(5, 1, 1), (1, 6, 1), (1, 1, 9),
                                (17, 17, 17), (4, 4, 4), (2, 3, 4)], False),
]


@pytest.mark.parametrize("label,bsz,dims,boxes,offset", BUCKET_CASES,
                         ids=[c[0] for c in BUCKET_CASES])
def test_bucketed_matches_jax_engine(label, bsz, dims, boxes, offset):
    """The fused query's plain version, its wrapper on the CPU and the
    ``cuda`` and ``torch`` engines against ``repro``'s
    ``JaxEngine.multibox_bucketed`` (bool planes, free counts) and the
    Pallas ``occupancy_counts`` in interpret mode: bit-exact."""
    rng = np.random.default_rng(len(label) * 31 + bsz)
    extra = int(offset)
    dens = rng.uniform(0.0, 0.6, size=(bsz + extra, 1, 1, 1))
    full = rng.uniform(size=(bsz + extra,) + dims) < dens
    occ = full[extra:]
    planes, free = jops.JaxEngine().multibox_bucketed(occ, boxes)
    planes, free = np.asarray(planes), np.asarray(free)
    occupied = np.asarray(pallas.occupancy_counts(jnp.array(occ),
                                                  interpret=True))
    n3 = dims[0] * dims[1] * dims[2]
    assert planes.dtype == bool and planes.shape == (bsz, len(boxes)) + dims
    assert (free == n3 - occupied).all()
    t = torch.from_numpy(full)[extra:]
    assert t.is_contiguous()
    for name, (p, c) in {
            "plain": tk.fitmask_multibox_bucketed_plain(t, boxes),
            "wrapper": tk.fitmask_multibox_bucketed(t, boxes)}.items():
        assert p.dtype == torch.bool and c.dtype == torch.int32, name
        assert p.shape == planes.shape and (p.numpy() == planes).all(), name
        assert (c.numpy() == occupied).all(), name
    for name in ("cuda", "torch"):
        p, f = tops.get_engine(name, device="cpu").multibox_bucketed(t, boxes)
        assert p.dtype == torch.bool and (p.numpy() == planes).all(), name
        assert (f.numpy() == free).all(), name


def test_counts_of_bool_bytes_other_than_one():
    """A bool tensor viewed from uint8 may hold bytes such as 2 and 255:
    every nonzero byte is one occupied cell, in the counts and in the
    planes."""
    rng = np.random.default_rng(9)
    raw = rng.choice(np.array([0, 1, 2, 255], np.uint8), size=(6, 4, 4, 4),
                     p=[0.5, 0.1, 0.2, 0.2])
    t = torch.from_numpy(raw).view(torch.bool)
    want = (raw != 0).reshape(6, -1).sum(1)
    assert (tk.occupancy_counts_plain(t).numpy() == want).all()
    boxes = [(1, 1, 1), (2, 2, 2), (4, 1, 3)]
    planes, counts = tk.fitmask_multibox_bucketed_plain(t, boxes)
    assert (counts.numpy() == want).all()
    assert (planes.numpy() == ref_np.fit_mask_multi(raw != 0, boxes)).all()


def _replay_counts(data, offset, bsz, n, plan):
    """``occupancy_counts_lanes_kernel`` / ``_cluster_kernel`` of
    ``csrc/fitmask.cu`` in Python, thread by thread as ``plan`` cuts the
    work: the loads each thread makes (each on a ``plan.vec`` boundary,
    ``plan.batch`` at a time, those past the grid's end predicated off),
    its sum, the shuffle sums over its aligned lanes, or the warp sums
    that each block of a cluster writes into the first block's shared
    memory, and the stores. Every byte of every grid must be loaded
    exactly once and no byte outside them, and every grid stored once."""
    vec, threads = plan.vec, plan.threads
    assert plan.batch in (1, 2, 4, 8)
    reads = np.zeros(data.size, np.int64)
    out = np.full(bsz, -1, np.int64)

    def load(pos):
        assert pos % vec == 0
        reads[pos:pos + vec] += 1
        return int(np.count_nonzero(data[pos:pos + vec]))

    def strided(base, begin, step):      # count_strided
        acc = 0
        for i in range(begin, n, plan.batch * step):
            acc += sum(load(base + i + k * step) for k in range(plan.batch)
                       if i + k * step < n)
        return acc

    assert threads % 32 == 0 and threads <= tk.THREADS
    if plan.cluster == 0:
        lanes = plan.lanes
        assert 32 % lanes == 0 and plan.blocks * threads >= bsz * lanes
        for w0 in range(0, plan.blocks * threads, 32):     # warp by warp
            ts = range(w0, w0 + 32)
            sums = [strided(offset + (t // lanes) * n, t % lanes * vec,
                            lanes * vec)
                    if t // lanes < bsz else 0 for t in ts]
            off = lanes // 2
            while off:                         # __shfl_xor_sync butterfly
                sums = [sums[ln] + sums[ln ^ off] for ln in range(32)]
                off //= 2
            for ln, t in enumerate(ts):
                if t // lanes < bsz and t % lanes == 0:
                    assert out[t // lanes] == -1
                    out[t // lanes] = sums[ln]
    else:
        cl, warps = plan.cluster, threads // 32
        assert cl <= tk.MAX_CLUSTER and plan.blocks == bsz * cl
        assert cl * warps <= 64          # the first warp's two slots a lane
        for blk0 in range(0, plan.blocks, cl):   # cluster by cluster
            g = blk0 // cl
            slots = {}
            for rank in range(cl):
                for w in range(warps):
                    slots[rank * warps + w] = sum(
                        strided(offset + g * n, (rank * threads + tid) * vec,
                                cl * threads * vec)
                        for tid in range(w * 32, w * 32 + 32))
            assert sorted(slots) == list(range(cl * warps))
            assert out[g] == -1
            out[g] = sum(slots.values())
    assert (reads[offset:offset + bsz * n] == 1).all()
    assert reads.sum() == bsz * n
    assert (out >= 0).all()
    return out


# (B, n, address): every lane count (1 to 32) and load width of the
# lanes kernel, and clusters of 1, 2, 4 and 8 blocks, one that loops
# (70001 single-byte loads over 2048 threads), at aligned and unaligned
# starts.
COUNT_REPLAY_CASES = [
    (512, 8, 0), (64, 64, 0), (8, 512, 0), (1, 4096, 0), (2, 4096, 16),
    (3, 27, 5), (5, 36, 36), (7, 6, 2), (9, 2, 0), (40, 468, 4),
    (33, 100, 8), (5, 32, 0), (6, 128, 0), (2, 38 ** 3, 0),
    (1, 64 ** 3, 0), (2, 300, 3), (2, 40000, 0), (1, 70001, 0),
    (3, 5000, 8), (1, 1, 7),
]


@pytest.mark.parametrize("bsz,n,addr", COUNT_REPLAY_CASES)
def test_counts_kernel_replay_counts_every_byte_once(bsz, n, addr):
    rng = np.random.default_rng(bsz * 7 + n + addr)
    data = rng.choice(np.array([0, 1, 2, 255], np.uint8),
                      size=addr + bsz * n + 16)
    plan = tk.counts_plan(bsz, n, addr)
    assert addr % plan.vec == 0 and n % plan.vec == 0
    got = _replay_counts(data, addr, bsz, n, plan)
    grids = data[addr:addr + bsz * n].reshape(bsz, n)
    want = tk.occupancy_counts_plain(torch.from_numpy(grids).view(torch.bool))
    assert (got == want.numpy()).all()


def test_counts_plan_at_the_loops_shapes():
    """All cubes of the reconfigurable torus (8 x 8^3, 64 x 4^3, 512 x
    2^3) and one or two of them take one or two blocks of shuffles; 16^3
    is one warp; 38^3 and 64^3 take clusters of 4 and 8 blocks."""
    plan = tk.counts_plan
    assert plan(512, 8) == tk.CountPlan(8, 1, 1, 0, 256, 2)
    assert plan(64, 64) == tk.CountPlan(16, 1, 4, 0, 256, 1)
    assert plan(8, 512) == tk.CountPlan(16, 1, 32, 0, 256, 1)
    for n in (8, 64, 512):
        for bsz in (1, 2):
            p = plan(bsz, n)
            assert p.cluster == 0 and p.blocks == 1 and p.batch == 1
            assert p.threads == -(-bsz * p.lanes // 32) * 32 <= 64
    assert plan(1, 4096) == tk.CountPlan(16, 8, 32, 0, 32, 1)
    assert plan(1, 38 ** 3) == tk.CountPlan(8, 8, 0, 4, 256, 4)
    assert plan(2, 64 ** 3) == tk.CountPlan(16, 8, 0, 8, 256, 16)
    assert plan(1, 70001).batch == 8           # 35 loads a thread, looped
    assert plan(3, 468, 4).batch == 4          # 117 loads over 32 lanes
    assert plan(4, 3 * 3 * 3, 36).vec == 1       # occ[1:] of Z 3 grids
    with pytest.raises(ValueError, match="beyond"):
        plan(2 ** 31, 8)


def _emulate_fused_counts(occ, plan):
    """The counts of ``fitmask_multibox_kernel<..., true>``, block part 0
    of each group of grids. One grid in the block: each thread adds the
    popcounts of the row words it loads (rows tid, tid + threads, ...),
    each warp sums its lanes into one int of shared memory, and the
    first warp sums those. Several grids: ``lanes`` threads a grid (the
    power of two at least X·Y, at most 32) sum the popcounts of every
    lanes-th row word of their grid, then shuffle-sum. Every grid is
    stored exactly once."""
    bsz, x_, y_, z_ = occ.shape
    xy, threads = x_ * y_, plan.threads
    ones = [sum(int(v) << z for z, v in enumerate(row)).bit_count()
            for row in occ.reshape(-1, z_)]
    out = np.full(bsz, -1, np.int64)
    lanes = 32 if xy >= 32 else 1 << (xy - 1).bit_length()
    for blk in range(0, plan.blocks, plan.bpg):     # part 0 of each group
        g0 = blk // plan.bpg * plan.gpb
        ng = min(plan.gpb, bsz - g0)
        if ng == 1:
            loaded = [sum(ones[g0 * xy + r] for r in range(tid, xy, threads))
                      for tid in range(threads)]
            warp_ones = [sum(loaded[w:w + 32]) for w in range(0, threads, 32)]
            assert len(warp_ones) * 4 <= tk.COUNT_SMEM and out[g0] == -1
            out[g0] = sum(warp_ones)
            continue
        assert xy * 2 <= threads     # a lane reads at most 4 row words
        for j0 in range(0, ng, threads // lanes):
            for w0 in range(0, threads, 32):
                sums = []
                for tid in range(w0, w0 + 32):
                    j = j0 + tid // lanes
                    sums.append(sum(ones[(g0 + j) * xy + r]
                                    for r in range(tid % lanes, xy, lanes))
                                if j < ng else 0)
                off = lanes // 2
                while off:
                    sums = [sums[ln] + sums[ln ^ off] for ln in range(32)]
                    off //= 2
                for ln, tid in enumerate(range(w0, w0 + 32)):
                    j = j0 + tid // lanes
                    if j < ng and tid % lanes == 0:
                        assert out[g0 + j] == -1
                        out[g0 + j] = sums[ln]
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fused_counts_emulated_match_plain(seed):
    """Several grids a block (K·X·Y below a block), one grid a block and
    several blocks a grid, on grids of 1 to 64 rows and X·Y off a power
    of two."""
    rng = np.random.default_rng(200 + seed)
    bsz = int(rng.integers(1, 60))
    dims = tuple(int(v) for v in rng.integers(1, 9, size=3))
    boxes = [(1, 1, 1)] * int(rng.choice([1, 3, 40]))
    occ = rng.uniform(size=(bsz,) + dims) < 0.4
    plan = tk.launch_plan(bsz, *dims, tk.box_table(boxes))
    want = tk.occupancy_counts_plain(torch.from_numpy(occ)).numpy()
    assert (_emulate_fused_counts(occ, plan) == want).all()


def test_bool_store_spreads_each_bit_to_a_byte():
    """``bytes4`` of ``csrc/fitmask.cu``: byte i of ((b & 15) *
    0x00204081) & 0x01010101 is bit i of b, for every nibble."""
    for b in range(64):
        got = ((b & 15) * 0x00204081) & 0x01010101
        assert got.to_bytes(4, "little") == bytes((b >> i) & 1
                                                  for i in range(4))
