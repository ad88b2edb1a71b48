#!/usr/bin/env python3
"""Microbenchmarks on the port: the kernels' plain PyTorch versions, the
allocator and the simulator, at the shapes of
``benchmarks/kernels_bench.py``. Emits ``name,us_per_call,derived`` CSV
rows under the reference's names.

The reference times its jnp references because its Pallas kernels run
only on a TPU. The port's counterparts of those kernels run on the
card, so on a CUDA device every ``*_ref`` row (and the reduce-window
fitmask row) gets a sibling row, at the same shape, for the
hand-written kernel: ``attention_kernel_s*`` (K4, bf16),
``ssd_kernel_chunk*`` (K5, fp32) and ``fitmask_kernel_64cubes`` (K3: K1's
kernel with one box). Each sibling is first held against its plain
row's output (K4 within chip_smoke's bf16 ``FA_TOL``, K5 within its fp32
``SSD_TOL``, the fitmask kernel bit-exact) and raises on a mismatch. K5
refuses a chunk whose output block would keep more than chunk x P = 8192
values in registers: at P = 64 that is chunk 256, whose row says
``refused`` once the refusal is checked. On the CPU no sibling row
appears.

The plain rows run on ``--device`` (default: the card, or the CPU
under ``--engine numpy``); the allocator and simulator rows run on
``--engine`` (default: ``cuda``);
``fitmask_numpy_16cube`` is the host numpy engine wherever the bench
runs. Without a card the default exits non-zero. On the card the three
kernels are built and the CUDA context started before any timed row,
and each timed call ends in ``torch.cuda.synchronize()``.

    python3 benchmarks_torch/kernels_bench.py [--engine cuda] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks_torch.crash_loop import (add_engine_args,  # noqa: E402
                                         engine_from_args)

# The sources of the kernels that have sibling rows.
SOURCES = ("fitmask.cu", "flash_attention.cu", "ssd_scan.cu")
# K5's output block keeps chunk x P values of y in registers
# (src/repro_torch/csrc/ssd_scan.cu); a longer chunk is refused.
SSD_MAX_CHUNK_X_P = 8192


def _time(fn: Callable, iters: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6  # us


def _synced(fn: Callable, device) -> Callable:
    """``fn`` followed by ``torch.cuda.synchronize()`` on a CUDA device
    (the counterpart of ``jax.block_until_ready``); returns its result."""
    import torch

    if device.type != "cuda":
        return fn

    def call():
        out = fn()
        torch.cuda.synchronize(device)
        return out
    return call


def _tolerances():
    """chip_smoke's (atol, rtol) for K4 in bf16 and K5 in fp32."""
    import torch

    import chip_smoke

    return (chip_smoke.FA_TOL[torch.bfloat16],
            chip_smoke.SSD_TOL[torch.float32])


def _check_close(name: str, got, want, tol) -> None:
    import torch

    atol, rtol = tol
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{name}: differs from its plain row by "
                             f"{err} (atol {atol}, rtol {rtol})")


def bench_flash_attention(emit=print, device=None) -> None:
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    device = torch.device(device or "cpu")
    rng = np.random.default_rng(0)
    for s in (256, 1024):
        q, k, v = (torch.from_numpy(rng.normal(size=(1, s, h, 64))).to(
            device=device, dtype=torch.bfloat16) for h in (8, 2, 2))
        flops = 4 * s * s * 8 * 64 / 2  # causal
        plain = _synced(lambda: fa_ref.attention_reference(q, k, v), device)
        us = _time(plain)
        emit(f"attention_ref_s{s},{us:.0f},{flops / us / 1e3:.1f}GFLOPs")
        if device.type != "cuda":
            continue
        kern = _synced(lambda: fa.flash_attention(q, k, v), device)
        _check_close(f"attention_kernel_s{s}", kern(), plain(),
                     _tolerances()[0])
        us = _time(kern)
        emit(f"attention_kernel_s{s},{us:.0f},{flops / us / 1e3:.1f}GFLOPs")


def bench_ssd(emit=print, device=None) -> None:
    import torch

    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    device = torch.device(device or "cpu")
    rng = np.random.default_rng(1)
    B, S, H, P, N = 1, 2048, 8, 64, 64
    f32 = dict(device=device, dtype=torch.float32)
    x = torch.from_numpy(rng.normal(size=(B, S, H, P))).to(**f32)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, S, H))).to(**f32)
    a = torch.from_numpy(-rng.uniform(0.5, 2, (H,))).to(**f32)
    b = torch.from_numpy(rng.normal(size=(B, S, H, N))).to(**f32)
    c = torch.from_numpy(rng.normal(size=(B, S, H, N))).to(**f32)
    for chunk in (64, 256):
        plain = _synced(lambda ch=chunk: ssd_ref.ssd_reference(
            x, dt, a, b, c, chunk=ch)[0], device)
        us = _time(plain)
        emit(f"ssd_chunk{chunk},{us:.0f},{S * B / (us / 1e6) / 1e6:.2f}Mtok/s")
        if device.type != "cuda":
            continue
        kern = _synced(lambda ch=chunk: ssd.ssd_scan(
            x, dt, a, b, c, chunk=ch)[0], device)
        if chunk * P > SSD_MAX_CHUNK_X_P:
            try:
                kern()
            except RuntimeError as e:
                if f"chunk = {chunk}" not in str(e):
                    raise
            else:
                raise AssertionError(f"ssd_kernel_chunk{chunk}: chunk x P = "
                                     f"{chunk * P} was not refused")
            emit(f"ssd_kernel_chunk{chunk},refused,chunk x P = {chunk * P}"
                 f" > {SSD_MAX_CHUNK_X_P}")
            continue
        _check_close(f"ssd_kernel_chunk{chunk}", kern(), plain(),
                     _tolerances()[1])
        us = _time(kern)
        emit(f"ssd_kernel_chunk{chunk},{us:.0f},"
             f"{S * B / (us / 1e6) / 1e6:.2f}Mtok/s")


def bench_fitmask(emit=print, device=None) -> None:
    import torch

    from repro_torch.core import fitmask as np_engine
    from repro_torch.kernels.fitmask import kernel as fit_kernel
    from repro_torch.kernels.fitmask import ref as fit_ref
    device = torch.device(device or "cpu")
    rng = np.random.default_rng(2)
    occ = rng.uniform(size=(16, 16, 16)) < 0.3
    us = _time(lambda: np_engine.fit_mask(occ, (4, 4, 4)), iters=50)
    emit(f"fitmask_numpy_16cube,{us:.0f},{1e6 / us:.0f}searches/s")
    occ_b = torch.from_numpy(rng.uniform(size=(64, 4, 4, 4)) < 0.3).to(
        device)
    plain = _synced(lambda: fit_ref.fitmask_reference(occ_b, (2, 2, 2)),
                    device)
    us = _time(plain, iters=20)
    emit(f"fitmask_reduce_window_64cubes,{us:.0f},batched")
    if device.type != "cuda":
        return
    kern = _synced(lambda: fit_kernel.fitmask_batched(occ_b, (2, 2, 2)),
                   device)
    if not torch.equal(kern(), plain()):
        raise AssertionError("fitmask_kernel_64cubes: differs from the "
                             "reduce-window row")
    us = _time(kern, iters=20)
    emit(f"fitmask_kernel_64cubes,{us:.0f},batched")


def bench_allocator(emit=print, engine=None) -> None:
    from repro_torch.core.allocator import make_policy
    from repro_torch.traces.generator import TraceConfig, generate_trace
    jobs = generate_trace(TraceConfig(num_jobs=60, seed=0))
    for name, kw in (("firstfit", dict(dims=(16, 16, 16))),
                     ("rfold", dict(num_xpus=4096, cube_n=4))):
        pol = make_policy(name, engine=engine, **kw)
        t0 = time.perf_counter()
        placed = sum(1 for j in jobs
                     if pol.try_place(j.job_id, j.shape) is not None)
        dt = time.perf_counter() - t0
        emit(f"alloc_{name},{dt / len(jobs) * 1e6:.0f},"
             f"{placed}/{len(jobs)}placed")


def bench_simulator(emit=print, engine=None) -> None:
    from repro_torch.core.allocator import make_policy
    from repro_torch.sim.simulator import Simulator
    from repro_torch.traces.generator import TraceConfig, generate_trace
    jobs = generate_trace(TraceConfig(num_jobs=150, seed=1))
    pol = make_policy("rfold", num_xpus=4096, cube_n=4, engine=engine)
    t0 = time.perf_counter()
    Simulator(pol, jobs).run()
    dt = time.perf_counter() - t0
    emit(f"sim_rfold_150jobs,{dt * 1e6:.0f},{150 / dt:.0f}jobs/s")


def main(argv=None, emit=print) -> None:
    ap = argparse.ArgumentParser(prog="kernels_bench")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    engine, _ = engine_from_args(ap, args)
    import torch

    device = torch.device(args.device or (
        "cpu" if engine.resolve_name() == "numpy" else "cuda"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("kernels_bench: no CUDA device", file=sys.stderr)
            raise SystemExit(1)
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.kernels import _build
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_build.build, SOURCES))
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    emit("name,us_per_call,derived")
    bench_fitmask(emit, device)
    bench_allocator(emit, engine)
    bench_simulator(emit, engine)
    bench_flash_attention(emit, device)
    bench_ssd(emit, device)


if __name__ == "__main__":
    main()
