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
    assert tk.check_smem((16, 16, 16)) == 17 ** 3 * 4
    assert tk.check_smem((37, 37, 37)) == 38 ** 3 * 4
    with pytest.raises(ValueError, match="shared memory"):
        tk.check_smem((38, 38, 38))


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
