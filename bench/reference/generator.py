"""Philly-style synthetic trace generation (paper §4).

None of the public ML traces were collected on a torus cluster, so the
paper takes inter-arrival and duration statistics from the Microsoft
Philly trace and overrides the job size with a truncated exponential on
[1, 4096], then generates shapes with the rule of thumb:

  * small jobs (<= 256 XPUs) are mostly 1D or 2D (DP and/or TP),
  * large jobs (> 256) are mostly 2D or 3D,
  * among the factorizations of a size into the chosen class, one is
    picked uniformly at random.

The offline container has no Philly CSV, so inter-arrival is Poisson and
duration lognormal with parameters matching published Philly statistics
(median ~13 min, heavy tail up to days); both are overridable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .geometry import JobShape, factor_pairs, factorizations3
from .job import Job


@dataclass
class TraceConfig:
    num_jobs: int = 300
    seed: int = 0
    # size ~ TruncExp(scale) on [1, 4096]  (paper's override)
    size_scale: float = 256.0
    size_max: int = 4096
    # arrivals ~ Poisson; rate chosen for a target offered load unless
    # mean_interarrival is given explicitly.
    mean_interarrival: Optional[float] = None
    target_load: float = 1.2          # offered load vs 4096 XPUs
    cluster_xpus: int = 4096
    # duration ~ lognormal (Philly-like): median 13 min, sigma 1.4
    duration_median_s: float = 780.0
    duration_sigma: float = 1.4
    # Size-duration correlation (trace-calibration step 3's open
    # question: big jobs run longer in the real Philly trace, the
    # independent samplers ignore it). Sampled through a Gaussian
    # copula, so both marginals are exactly preserved and ``corr = 0``
    # keeps the legacy independent draws byte-identical.
    size_duration_corr: float = 0.0
    # Bursty arrivals: 0 keeps pure Poisson (legacy, byte-identical);
    # > 0 draws inter-arrivals from a two-phase hyperexponential with
    # the same mean (offered load unchanged) but CV > 1 — arrivals
    # clump, stressing queue depth and recovery.
    arrival_burstiness: float = 0.0
    # Multi-tenant priorities: > 1 assigns each job a uniform priority
    # in [0, levels); 1 keeps every job at priority 0 (legacy).
    priority_levels: int = 1
    small_threshold: int = 256
    p_1d_small: float = 0.5           # small: 1D vs 2D
    p_2d_large: float = 0.5           # large: 2D or 3D
    # Calibration knobs (see EXPERIMENTS.md §Paper-val):
    round_even: bool = True           # DP/TP degrees are even in practice
    # The paper reports Reconfig(4^3) JCR = 100%, which implies every
    # generated shape decomposes into at most 64 4^3 cubes; we enforce
    # the same feasibility envelope on the sampled factorization.
    cube4_decomposable: bool = True
    cube4_n: int = 4
    cube4_budget: int = 64

    @classmethod
    def preset(cls, name: str, **overrides) -> "TraceConfig":
        """A named calibration preset with optional field overrides:
        ``TraceConfig.preset("philly", num_jobs=500)``."""
        if name not in TRACE_PRESETS:
            raise KeyError(f"unknown trace preset {name!r}; "
                           f"have {sorted(TRACE_PRESETS)}")
        fields = dict(TRACE_PRESETS[name])
        fields.update(overrides)
        return cls(**fields)


# Named TraceConfig presets (field overrides on top of the defaults).
#
# ``philly`` is the trace-calibration first step (ROADMAP item): the
# paper samples inter-arrival and duration statistics from the
# Microsoft Philly trace (Jeon et al., ATC '19). Our default keeps the
# published ~13-minute median but its lognormal tail (sigma 1.4, so
# mean/median = exp(sigma^2/2) ~ 2.7) is far lighter than Philly's —
# the reported mean runtime is hours against the 13-minute median,
# i.e. mean/median ~ 10, which a lognormal matches at sigma =
# sqrt(2 ln 10) ~ 2.15. Philly's GPU-count distribution also puts most
# of its mass on single-machine (<= 8 GPU) jobs, which the default
# 256-XPU-mean truncated exponential underweights; scale 96 moves the
# small-job mass toward the Philly shares while keeping the paper's
# [1, 4096] support. The measured Table 1 / Fig 4 gaps this preset
# targets are recorded in EXPERIMENTS.md §Paper-scale.
TRACE_PRESETS = {
    "philly": {
        "duration_sigma": 2.15,       # mean/median ~ 10 (Philly-like tail)
        "size_scale": 96.0,           # small-job mass per Philly GPU counts
    },
}


def _trunc_exp_icdf(u: np.ndarray, scale: float, hi: int) -> np.ndarray:
    """Inverse CDF of Exp(scale) truncated to [1, hi] at quantiles
    ``u`` (the shared kernel of the independent and copula samplers)."""
    fmax = 1.0 - math.exp(-hi / scale)
    x = -scale * np.log(1.0 - u * fmax)
    return np.clip(np.ceil(x), 1, hi).astype(np.int64)


def _truncated_exp_sizes(rng: np.random.Generator, n: int, scale: float,
                         hi: int) -> np.ndarray:
    """Inverse-CDF sampling of Exp(scale) truncated to [1, hi]."""
    return _trunc_exp_icdf(rng.uniform(size=n), scale, hi)


def _std_normal_cdf(z: np.ndarray) -> np.ndarray:
    """Φ(z) via math.erf (no scipy in the container)."""
    return np.array([0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
                     for v in np.asarray(z, dtype=np.float64)])


def _correlated_size_duration(rng: np.random.Generator, cfg: "TraceConfig",
                              mu: float):
    """Gaussian-copula joint draw: sizes keep the truncated-exponential
    marginal (via Φ(z₁) pushed through the inverse CDF), durations keep
    the lognormal marginal (exp(μ + σ·z₂)), and corr(z₁, z₂) = ρ sets
    the rank correlation — the Philly-like "big jobs run longer"."""
    rho = float(np.clip(cfg.size_duration_corr, -0.999, 0.999))
    z = rng.standard_normal(size=(cfg.num_jobs, 2))
    z1 = z[:, 0]
    z2 = rho * z1 + math.sqrt(1.0 - rho * rho) * z[:, 1]
    sizes = _trunc_exp_icdf(_std_normal_cdf(z1), cfg.size_scale,
                            cfg.size_max)
    durations = np.exp(mu + cfg.duration_sigma * z2)
    return sizes, durations


def _cube_grid_size(dims, n: int) -> int:
    out = 1
    for d in dims:
        out *= -(-int(d) // n)
    return out


def sample_shape(rng: np.random.Generator, size: int,
                 cfg: TraceConfig) -> JobShape:
    """Paper's shape rule. Dimension sizes are deliberately allowed to
    exceed the static torus extent (that is the point: some shapes are
    incompatible with some clusters), but — matching the paper's
    Reconfig(4^3) JCR of exactly 100 % — every emitted shape decomposes
    into at most 64 4^3 cubes."""
    size = int(size)

    def feasible(dims) -> bool:
        if not cfg.cube4_decomposable:
            return True
        return _cube_grid_size(dims, cfg.cube4_n) <= cfg.cube4_budget

    for _ in range(64):  # resample/bump until a feasible shape exists
        small = size <= cfg.small_threshold
        if small:
            want = "1d" if rng.uniform() < cfg.p_1d_small else "2d"
        else:
            want = "2d" if rng.uniform() < cfg.p_2d_large else "3d"
        if want == "3d":
            triples = [t for t in factorizations3(size)
                       if min(t) > 1 and feasible(t)]
            if triples:
                a, b, c = triples[rng.integers(len(triples))]
                return JobShape((int(a), int(b), int(c)))
            want = "2d"
        if want == "2d":
            pairs = [p for p in factor_pairs(size)
                     if min(p) > 1 and feasible((p[0], p[1], 1))]
            if pairs:
                a, b = pairs[rng.integers(len(pairs))]
                return JobShape((int(a), int(b), 1))
            want = "1d"
        if feasible((size, 1, 1)):
            return JobShape((size, 1, 1))
        size += 2 if cfg.round_even else 1  # bump to a factorable size
    raise RuntimeError(f"no feasible shape for size {size}")


def generate_trace(cfg: TraceConfig) -> List[Job]:
    rng = np.random.default_rng(cfg.seed)
    mu = math.log(cfg.duration_median_s)
    # Every non-default knob below branches so the default draw
    # sequence — and therefore every legacy trace — stays
    # byte-identical (asserted in tests/test_trace_calibration.py).
    if cfg.size_duration_corr != 0.0:
        sizes, durations = _correlated_size_duration(rng, cfg, mu)
    else:
        sizes = _truncated_exp_sizes(rng, cfg.num_jobs, cfg.size_scale,
                                     cfg.size_max)
        durations = None
    if cfg.round_even:
        sizes = np.where(sizes > 1, (sizes + 1) // 2 * 2, sizes)
    if durations is None:
        durations = rng.lognormal(mean=mu, sigma=cfg.duration_sigma,
                                  size=cfg.num_jobs)
    if cfg.mean_interarrival is not None:
        mean_ia = cfg.mean_interarrival
    else:
        # offered load = rate * E[size * duration] / cluster_xpus
        demand = float(np.mean(sizes * durations))
        mean_ia = demand / (cfg.target_load * cfg.cluster_xpus)
    if cfg.arrival_burstiness > 0.0:
        # Two-phase hyperexponential, mean preserved exactly:
        # 0.75·(1-b) + 0.25·(1+3b) = 1.
        b = float(min(cfg.arrival_burstiness, 0.95))
        fast = rng.uniform(size=cfg.num_jobs) < 0.75
        phase_mean = np.where(fast, (1.0 - b) * mean_ia,
                              (1.0 + 3.0 * b) * mean_ia)
        gaps = rng.exponential(1.0, size=cfg.num_jobs) * phase_mean
    else:
        gaps = rng.exponential(mean_ia, size=cfg.num_jobs)
    arrivals = np.cumsum(gaps)
    if cfg.priority_levels > 1:
        priorities = rng.integers(cfg.priority_levels,
                                  size=cfg.num_jobs)
    else:
        priorities = np.zeros(cfg.num_jobs, dtype=np.int64)
    jobs = []
    for i in range(cfg.num_jobs):
        shape = sample_shape(rng, int(sizes[i]), cfg)
        jobs.append(Job(job_id=i, arrival=float(arrivals[i]),
                        duration=float(durations[i]), shape=shape,
                        priority=int(priorities[i])))
    return jobs


def generate_traces(cfg: TraceConfig, runs: int) -> List[List[Job]]:
    out = []
    for r in range(runs):
        c = TraceConfig(**{**cfg.__dict__, "seed": cfg.seed + r})
        out.append(generate_trace(c))
    return out
