"""Port parity for the placement layer: engine selection, the mask-query
client, fold enumeration, and whole schedules of all five policies on
every CPU-capable engine of ``repro_torch`` against ``repro``'s numpy
host path, fed one identical trace."""
import warnings

import numpy as np
import pytest
import torch

from repro.core.allocator import make_policy as ref_make_policy
from repro.core.folding import enumerate_folds as ref_enumerate_folds
from repro.core.geometry import JobShape as RefJobShape
from repro.sim.simulator import Simulator as RefSimulator
from repro.traces.generator import TraceConfig as RefTraceConfig
from repro.traces.generator import generate_trace as ref_generate_trace
from repro_torch.core import engineconfig
from repro_torch.core.allocator import make_policy
from repro_torch.core.engineconfig import EngineConfig, set_default_engine
from repro_torch.core.folding import enumerate_folds
from repro_torch.core.geometry import JobShape
from repro_torch.core.maskquery import InlineMaskClient, resolve_mask_client
from repro_torch.kernels.fitmask import kernel as tk
from repro_torch.kernels.fitmask import ops
from repro_torch.sim.job import jobs_from_numpy
from repro_torch.sim.simulator import Simulator

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_selection(monkeypatch):
    monkeypatch.delenv(engineconfig.ENGINE_ENV, raising=False)
    monkeypatch.setattr(engineconfig, "_default_engine", None)
    monkeypatch.setattr(engineconfig, "_env_warned", False)
    yield


# ------------------------------------------------------ engine selection
def test_default_engine_is_cuda_and_aliases_fold():
    assert engineconfig.default_engine_name() == "cuda"
    assert EngineConfig().resolve_name() == "cuda"
    assert EngineConfig(engine="auto").resolve_name() == "cuda"
    assert EngineConfig(engine="kernel").resolve_name() == "cuda"
    assert ops.available_engines() == ("cuda", "numpy", "ref", "torch")
    with pytest.raises(KeyError):
        EngineConfig(engine="pallas").resolve_name()


def test_no_card_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ops, "_INSTANCES", {})
    for name in ("cuda", "torch", "ref"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.get_engine(name)
    with pytest.raises(RuntimeError):
        EngineConfig().get_engine()
    policy = make_policy("rfold", num_xpus=128, cube_n=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        policy.try_place(0, JobShape((2, 2, 1)))
    # asked-for CPU and the host engine both work without a card
    assert ops.get_engine("cuda", device="cpu").device.type == "cpu"
    assert ops.get_engine("numpy").host_free


def test_env_var_is_the_ports_own_and_warns(monkeypatch):
    monkeypatch.setenv("REPRO_FITMASK_ENGINE", "numpy")   # repro's: ignored
    assert EngineConfig().resolve_name() == "cuda"
    monkeypatch.setenv("REPRO_TORCH_FITMASK_ENGINE", "numpy")
    with pytest.warns(DeprecationWarning, match="deprecated"):
        assert EngineConfig().resolve_name() == "numpy"
    with warnings.catch_warnings():
        warnings.simplefilter("error")                    # second use: silent
        assert EngineConfig().resolve_name() == "numpy"
    set_default_engine("torch")                           # beats the env var
    assert ops.default_engine_name() == "torch"
    set_default_engine(None)


def test_failover_chain():
    assert engineconfig.FAILOVER_CHAIN == ("cuda", "torch", "numpy")
    assert engineconfig.failover_candidates("kernel") == ("torch", "numpy")
    assert engineconfig.failover_candidates("ref") == ("numpy",)
    assert engineconfig.failover_candidates("numpy") == ()
    assert engineconfig.failover_candidates("bogus") == ()


def test_engine_config_binds_positionally_as_the_references():
    """``device`` is keyword-only, so ``engine, fleet_size, quorum,
    timeout, max_inflight`` bind by position as in ``repro``."""
    from repro.core.engineconfig import EngineConfig as RefEngineConfig

    assert EngineConfig("numpy", 4).fleet_size == \
        RefEngineConfig("numpy", 4).fleet_size == 4
    args = ("numpy", 4, 0.5, 0.01, 3)
    names = ("engine", "fleet_size", "quorum", "timeout", "max_inflight")
    port, ref = EngineConfig(*args), RefEngineConfig(*args)
    assert [getattr(port, n) for n in names] == \
        [getattr(ref, n) for n in names] == list(args)
    assert port.device is None
    with pytest.raises(TypeError):
        EngineConfig(*args, "cpu")
    cfg = EngineConfig("cuda", 0)          # no device: fleet_size 0
    assert (cfg.fleet_size, cfg.device) == (0, None)
    assert cfg.resolve_name() == "cuda"
    assert cfg.fleet_kwargs()["device"] is None
    # device= by keyword still reaches the engine: the plain versions
    cfg = EngineConfig("cuda", device="cpu")
    eng = cfg.get_engine()
    assert eng.device.type == "cpu"
    occ = np.random.default_rng(1).uniform(size=(2, 4, 4, 4)) < 0.3
    boxes = [(2, 1, 1), (2, 2, 2)]
    tk.reset_launch_counts()
    got = eng.multibox(torch.from_numpy(occ), boxes)
    assert sum(tk.launch_counts().values()) == 0
    assert ((got.numpy() != 0) == (ops.get_engine("numpy").multibox(
        occ, boxes) != 0)).all()


def test_cuda_engine_does_not_pad_shapes():
    eng = ops.get_engine("cuda", device="cpu")
    assert not eng.pads_shapes and not eng.host_free


# ---------------------------------------------------- mask-query client
def test_mask_client_copies_to_host_numpy():
    assert resolve_mask_client("numpy") is None
    cfg = EngineConfig("cuda", device="cpu")
    client = resolve_mask_client(cfg)
    assert isinstance(client, InlineMaskClient)
    assert resolve_mask_client(cfg) is client              # interned
    occ = np.random.default_rng(0).uniform(size=(3, 4, 4, 4)) < 0.3
    boxes = [(1, 2, 3), (2, 2, 2), (5, 1, 1)]
    masks = client.multibox(occ, boxes)
    assert isinstance(masks, np.ndarray)
    assert ((masks != 0) == (ops.get_engine("numpy").multibox(occ, boxes)
                             != 0)).all()
    one = client.multibox(occ, boxes[:1])                  # single-box path
    assert one.shape == (3, 1, 4, 4, 4)
    assert (one[:, 0] == masks[:, 0]).all()
    free = client.free_counts(occ)
    assert isinstance(free, np.ndarray) and free.dtype == np.int64
    assert (free == 64 - occ.reshape(3, -1).sum(1)).all()
    assert client.seconds > 0.0          # host time spent answering


# ------------------------------------------------------------ folding
@pytest.mark.parametrize("dims", [(8, 1, 1), (12, 1, 1), (4, 6, 1),
                                  (8, 8, 1), (4, 4, 4), (6, 4, 2)])
def test_enumerate_folds_matches_reference(dims):
    for max_dim in (None, 8):
        want = ref_enumerate_folds(RefJobShape(dims), max_dim=max_dim)
        got = enumerate_folds(JobShape(dims), max_dim=max_dim)
        assert [(f.job_dims, f.box, f.mapping) for f in got] == \
            [(f.job_dims, f.box, f.mapping) for f in want]


# ------------------------------------------------------------ schedules
POLICIES = [("firstfit", dict(dims=(8, 8, 8))),
            ("folding", dict(dims=(8, 8, 8))),
            ("reconfig", dict(num_xpus=512, cube_n=4)),
            ("rfold", dict(num_xpus=512, cube_n=2)),
            ("rfold_be", dict(num_xpus=512, cube_n=4))]
ENGINES = [EngineConfig("numpy"), EngineConfig("torch", device="cpu"),
           EngineConfig("cuda", device="cpu")]


def _small_trace(seed, n=30):
    return ref_generate_trace(RefTraceConfig(
        num_jobs=n, seed=seed, size_scale=48.0, size_max=512,
        cluster_xpus=512, target_load=1.5, cube4_budget=8))


def port_jobs(ref_jobs):
    """The same trace as the port's jobs, through plain numpy arrays."""
    return jobs_from_numpy(
        np.array([j.job_id for j in ref_jobs]),
        np.array([j.arrival for j in ref_jobs]),
        np.array([j.duration for j in ref_jobs]),
        np.array([j.shape.dims for j in ref_jobs]),
        np.array([j.priority for j in ref_jobs]))


def schedule(res):
    return [(j.job_id, j.start, j.finish, j.dropped, j.slowdown,
             j.placement_meta) for j in res.jobs]


@pytest.mark.parametrize("engine", ENGINES,
                         ids=lambda e: f"{e.engine}-{e.device or 'host'}")
@pytest.mark.parametrize("policy,kw", POLICIES, ids=[p for p, _ in POLICIES])
def test_schedules_match_reference(policy, kw, engine):
    ref_jobs = _small_trace(seed=3)
    want = RefSimulator(ref_make_policy(policy, engine="numpy", **kw),
                        ref_jobs).run()
    got = Simulator(make_policy(policy, engine=engine, **kw),
                    port_jobs(ref_jobs)).run()
    assert schedule(got) == schedule(want)
    assert got.utilization_samples == want.utilization_samples


def test_cuda_engine_on_cpu_launches_no_kernel():
    tk.reset_launch_counts()
    jobs = port_jobs(_small_trace(seed=5, n=15))
    Simulator(make_policy("rfold", num_xpus=512, cube_n=4,
                          engine=EngineConfig("cuda", device="cpu")),
              jobs).run()
    assert sum(tk.launch_counts().values()) == 0
