"""The port's placement benches against the reference's on the CPU:
``benchmarks_torch/{reconfig_bench,allocator_bench,beyond,kernels_bench,
run}.py`` against ``benchmarks/``'s, on the host ``numpy`` engine and on
the ``cuda`` engine's CPU path (``--engine cuda --device cpu``).

Placements, JCR, aggregates and the CSV rows' names and placements equal
the reference's; times do not (``sim_seconds``, ``placements_per_sec``,
``speedup``, ``us_per_call``). The reference benches run with ``--out
''`` and write nothing.
"""
import builtins
import json
import os

import pytest
import torch

from benchmarks import allocator_bench as ref_alloc
from benchmarks import beyond as ref_beyond
from benchmarks import kernels_bench as ref_kernels
from benchmarks import reconfig_bench as ref_reconfig
from benchmarks_torch import allocator_bench, beyond, kernels_bench
from benchmarks_torch import reconfig_bench
from benchmarks_torch import run as port_run
from repro_torch.core.engineconfig import EngineConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = {"numpy": ["--engine", "numpy"],
           "cuda on cpu": ["--engine", "cuda", "--device", "cpu"]}


def outcome(r):
    """A run's answer, its timing aside."""
    return {"placements": r["placements"], "jcr": r["jcr"]}


@pytest.fixture(scope="module")
def ref_reconfig_12():
    return ref_reconfig.main(["--num-jobs", "12", "--out", ""])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_reconfig_bench_equals_the_reference(ref_reconfig_12, engine):
    got = reconfig_bench.main(["--num-jobs", "12", "--out", ""]
                              + ENGINES[engine])
    want = ref_reconfig_12
    assert got["config"] == want["config"]
    assert list(got["cube_sizes"]) == list(want["cube_sizes"]) == \
        ["8^3", "4^3", "2^3"]
    for cube, w in want["cube_sizes"].items():
        for kind in ("batched", "naive"):
            assert outcome(got["cube_sizes"][cube][kind]) == \
                outcome(w[kind]), (cube, kind)
    head = got["headline"]
    assert head["criterion"] == want["headline"]["criterion"]
    speedups = {k: v["speedup"] for k, v in got["cube_sizes"].items()}
    assert head["speedups"] == speedups
    assert head["pass"] == (all(s > 1.0 for s in speedups.values())
                            and speedups["8^3"] >= 2.0)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_allocator_bench_equals_the_reference(engine):
    args = ["--job-scales", "20", "--skip-naive", "--out", ""]
    got = allocator_bench.main(args + ENGINES[engine])
    want = ref_alloc.main(args)
    assert list(got["policies"]) == list(want["policies"]) == \
        [label for label, _, _ in ref_alloc.POLICIES]
    for label, scales in want["policies"].items():
        assert list(got["policies"][label]) == ["20"]
        assert outcome(got["policies"][label]["20"]) == \
            outcome(scales["20"]), label
    assert got["baseline"] == want["baseline"] == {}


def test_naive_anchor_equals_the_reference():
    kw = dict(num_xpus=4096, cube_n=4)
    got = allocator_bench._run_once("rfold", kw, 20, 100, naive=True,
                                    gated=False, engine="numpy")
    want = ref_alloc._run_once("rfold", kw, 20, 100, naive=True,
                               gated=False)
    assert outcome(got) == outcome(want)
    assert set(got) == set(want)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_beyond_aggregates_equal_the_reference(tmp_path, engine, capsys):
    out = tmp_path / "beyond.json"
    ref_beyond.main(["--runs", "1", "--num-jobs", "30", "--out",
                     str(tmp_path / "ref.json")])
    want_csv = capsys.readouterr().out
    assert beyond.main(["--runs", "1", "--num-jobs", "30", "--out", str(out)]
                       + ENGINES[engine]) is None
    assert capsys.readouterr().out == want_csv
    assert json.loads(out.read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())


def test_kernels_bench_rows_carry_the_references_names(monkeypatch):
    """Each plain path runs once (``_time`` calls it once); the reference's
    rows are named without running its jitted references."""
    monkeypatch.setattr(kernels_bench, "_time",
                        lambda fn, iters=5, warmup=2: (fn(), 1.0)[1])
    monkeypatch.setattr(ref_kernels, "_time",
                        lambda fn, iters=5, warmup=2: 1.0)
    got, want = [], []
    kernels_bench.main(["--engine", "numpy"], emit=got.append)
    ref_kernels.main(emit=want.append)
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    alloc = [r.split(",")[::2] for r in want if r.startswith("alloc_")]
    assert len(alloc) == 2
    assert [r.split(",")[::2] for r in got if r.startswith("alloc_")] == alloc
    assert not any("_kernel_" in r for r in got)


@pytest.mark.parametrize("section", ["bench_fitmask", "bench_flash_attention",
                                     "bench_ssd"])
def test_kernels_bench_sections_run_on_the_card_unless_asked(monkeypatch,
                                                             section):
    """A bare section asks for the card and raises without one, emitting
    nothing; ``device="cpu"`` gives the plain rows under the reference's
    names."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(kernels_bench, section)(rows.append)
    assert rows == []
    monkeypatch.setattr(kernels_bench, "_time",
                        lambda fn, iters=5, warmup=2: (fn(), 1.0)[1])
    monkeypatch.setattr(ref_kernels, "_time",
                        lambda fn, iters=5, warmup=2: 1.0)
    want = []
    getattr(kernels_bench, section)(rows.append, "cpu")
    getattr(ref_kernels, section)(want.append)
    assert [r.split(",")[0] for r in rows] == \
        [r.split(",")[0] for r in want]


def test_kernels_bench_alloc_rows_on_the_cuda_engine_on_cpu():
    got, want = [], []
    kernels_bench.bench_allocator(got.append,
                                  engine=EngineConfig("cuda", device="cpu"))
    ref_kernels.bench_allocator(want.append)
    assert [r.split(",")[::2] for r in got] == \
        [r.split(",")[::2] for r in want]


def test_fitmask_singlepass_rows_carry_numpy_ms(capsys):
    """The single-pass section on the CPU (the wrappers take the plain
    versions there) at two of repro's cells: each row has repro's grid,
    batch and K, the kernels' times from ``timer`` and the numpy
    engine's host time over ``iters`` calls, each held equal to K1."""
    from benchmarks import fitmask_bench as ref_fitmask
    from benchmarks_torch import fitmask_bench
    from repro_torch.kernels.fitmask import kernel

    cells = [((8, 8, 8), 1, 4), ((16, 16, 16), 8, 4)]
    timed = []
    rows = fitmask_bench.singlepass_sweep(
        kernel, torch.device("cpu"), lambda fn: timed.append(fn) or 0.5,
        cells=cells, iters=2)
    assert len(timed) == 2 * len(cells)
    assert [(r["grid"], r["batch"], r["k"]) for r in rows] == \
        [("8x8x8", 1, 4), ("16x16x16", 8, 4)]
    for r, (grid, _, k) in zip(rows, cells):
        assert set(r) == {"grid", "batch", "k", "multibox_ms",
                          "singlepass_ms", "numpy_ms", "speedup"}
        assert r["multibox_ms"] == r["singlepass_ms"] == 0.5
        assert r["speedup"] == 1.0 and r["numpy_ms"] > 0
        assert fitmask_bench.boxes_for(grid, k) == \
            list(ref_fitmask.boxes_for(grid, k))
    out = capsys.readouterr().out
    assert "singlepass,grid,B,K,multibox_ms,singlepass_ms,numpy_ms,speedup" \
        in out and "# headline:" in out


def test_benches_refuse_a_bench_snapshot_and_a_missing_card(capsys):
    for mod in (allocator_bench, reconfig_bench, beyond):
        with pytest.raises(SystemExit):
            mod.main(["--engine", "numpy", "--out", "BENCH_allocator.json"])
    if not torch.cuda.is_available():
        for mod, argv in ((allocator_bench, ["--job-scales", "20",
                                             "--out", ""]),
                          (reconfig_bench, ["--num-jobs", "12", "--out", ""]),
                          (beyond, ["--runs", "1", "--out", ""]),
                          (kernels_bench, [])):
            with pytest.raises(SystemExit) as e:
                mod.main(argv)
            assert e.value.code == 1, mod.__name__
        assert "no CUDA device" in capsys.readouterr().err


def test_run_writes_only_under_experiments(tmp_path, monkeypatch):
    """One quick section on numpy (the crash-loop drill), every other one
    skipped: its JSON lands in ``experiments/`` of the working directory
    and no BENCH_* path is opened for writing."""
    written = []
    real_open = builtins.open

    def spy(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **k)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(builtins, "open", spy)
    port_run.main(["--engine", "numpy"] + [
        f"--skip-{s}" for s in ("paper", "micro", "alloc", "fitmask",
                                "reconfig", "fleet", "service", "chaos",
                                "failover")])
    monkeypatch.undo()
    assert not any(os.path.basename(p).startswith("BENCH_")
                   for p in written), written
    outs = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")
                  if p.is_file())
    assert [str(p) for p in outs] == [
        os.path.join("experiments", "crash_loop_torch_quick.json")]
    assert not [p for p in written if p.startswith(ROOT)], written
