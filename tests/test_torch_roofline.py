"""The port's roofline and report against the reference's on the CPU:
``benchmarks_torch/roofline.py`` on H100 terms
(``repro_torch.launch.perf``) and the parameter counts of all ten
archs; ``benchmarks_torch/report.py``'s tables, which give the
reference's text on the committed BENCH_*.json (read only), and its
dry-run and roofline tables on a dry-run JSON of
``repro_torch.launch.dryrun``."""
import json
import os

import pytest
import torch

from benchmarks import report as ref_report
from benchmarks import roofline as ref_roofline
from benchmarks_torch import report, roofline
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.launch import dryrun
from repro_torch.launch.perf import HBM_BW, NVLINK_BW, PEAK_FLOPS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_roofline_row_math_on_h100_terms():
    """The counterpart of tests/test_system.py's: each term 1.0 s."""
    assert get_config("olmo-1b").dtype == "bfloat16"
    res = {
        "arch": "olmo-1b", "shape": "train_4k", "mesh": "single",
        "chips": 256, "compile_s": 0.0,
        "collectives": {"total_bytes": 450e9},
        "probes": {"extrapolated": {
            "flops": 989e12, "bytes": 3.35e12, "collective_bytes": 450e9}},
    }
    assert (PEAK_FLOPS["bfloat16"], HBM_BW, NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    row = roofline.roofline_row(res, {})
    assert row["t_compute_s"] == pytest.approx(1.0)
    assert row["t_memory_s"] == pytest.approx(1.0)
    assert row["t_collective_s"] == pytest.approx(1.0)
    assert row["useful_ratio"] > 0
    assert set(ref_roofline.roofline_row(res, {})) <= set(row)
    assert set(roofline.SUGGESTIONS) == set(ref_roofline.SUGGESTIONS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_param_counts_equal_the_reference(arch):
    assert roofline.model_param_counts(arch) == \
        ref_roofline.model_param_counts(arch)


@pytest.mark.parametrize("table, args", [
    ("reconfig_table", ("BENCH_reconfig.json",)),
    ("chaos_table", ("BENCH_chaos.json",)),
    ("crash_table", ("BENCH_crash_loop.json",)),
    ("failover_table", ("BENCH_failover.json",)),
    ("service_table", ("BENCH_service.json",)),
    ("fleet_table", ("BENCH_fleet.json",)),
    ("bench_table", ("BENCH_allocator.json", "BENCH_paper_eval.json")),
])
def test_report_tables_equal_the_reference(table, args):
    paths = [os.path.join(ROOT, a) for a in args]
    got = getattr(report, table)(*paths)
    assert got == getattr(ref_report, table)(*paths)
    assert got.count("\n") > 2


def test_paper_table_equals_the_reference(tmp_path):
    """``table1`` without ``table1_deltas``: each falls back to its own
    package's PAPER_TABLE1."""
    res = {"table1": {"FirstFit (16^3)": {"jcr": 0.1},
                      "RFold (4^3)": {"jcr": 0.5}},
           "fig3": {"RFold (4^3)": {"jct_p50": 1.0, "jct_p90": 2.0,
                                    "jct_p99": 3.0}},
           "fig4": {"RFold (4^3)": {"agg": {"util_mean": 0.5,
                                            "util_p50": 0.4,
                                            "util_p90": 0.6}}}}
    path = str(tmp_path / "paper.json")
    with open(path, "w") as f:
        json.dump(res, f)
    got = report.paper_table(path)
    assert got == ref_report.paper_table(path)
    assert "| RFold (4^3) | 100.0 | 50.0 |" in got


def test_fitmask_and_fleet_tables_read_the_ports_keys(tmp_path):
    fit = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "cases": [],
           "sweep": [dict(grid="16x16x16", batch=8, k=4, multibox_ms=0.004,
                          singlepass_ms=0.016, numpy_ms=1.25, speedup=4.0),
                     dict(grid="8x8x8", batch=1, k=1, multibox_ms=0.003,
                          singlepass_ms=0.003, speedup=1.0)],
           "headline": {"criterion": "c", "min_speedup": 4.0,
                        "max_speedup": 4.0, "pass": True}}
    (tmp_path / "fit.json").write_text(json.dumps(fit))
    text = report.fitmask_table(str(tmp_path / "fit.json"))
    assert "| 16x16x16 | 8 | 4 | 0.0040 | 0.0160 | 4.00x | 1.2500 |" in text
    assert "| 8x8x8 | 1 | 1 | 0.0030 | 0.0030 | 1.00x | not measured |" \
        in text
    assert "pass=True" in text and "700.00 W" in text
    with open(os.path.join(ROOT, "BENCH_fleet.json")) as f:
        fleet = json.load(f)
    one = dict(fleet["engine"], max_inflight=1)
    one["broker"] = {k: v for k, v in one["broker"].items()
                     if not k.endswith("pad_waste")}
    fleet.update(engine=[one, dict(one, max_inflight=2)], canary=None,
                 eval={"numpy per task": {"wall_s": [1.0, 2.0],
                                          "identical": True}})
    (tmp_path / "fleet.json").write_text(json.dumps(fleet))
    text = report.fleet_table(str(tmp_path / "fleet.json"))
    assert "K=20, max_inflight 2) |" in text
    assert "Broker (max_inflight 1):" in text and "pad waste" not in text
    assert "| numpy per task | 1.00, 2.00 | True |" in text
    assert "Canary drill" not in text


def test_report_main_reads_only_the_ports_artifacts(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.chdir(tmp_path)
    report.main(["--which", "all"])
    out = capsys.readouterr().out
    assert "0/40 single-pod" in out and "BENCH_" not in out
    assert "(no bench artifacts yet)" in out
    assert all(not p.startswith("BENCH_")
               for paths in report.DEFAULTS.values() for p in paths)


def test_dryrun_and_roofline_tables_on_a_port_dryrun(tmp_path, monkeypatch):
    """``launch.dryrun`` on the 256-rank production mesh (a smoke olmo
    with 16 heads), then ``roofline.main`` and both report tables."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_variant(
        get_config(a), n_heads=16, n_kv_heads=16, head_dim=16))
    dry = tmp_path / "dryrun_torch"
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                        "--mesh", "single", "--out", str(dry),
                        "--device", "cpu"]) == 0
    res = json.loads((dry / "olmo-1b__train_4k__single.json").read_text())
    out = tmp_path / "roofline_torch.json"
    roofline.main(["--dryrun-dir", str(dry), "--out", str(out)])
    (row,) = json.loads(out.read_text())
    ex = res["probes"]["extrapolated"]
    assert row["t_compute_s"] == ex["flops"] / PEAK_FLOPS["bfloat16"]
    assert row["t_memory_s"] == ex["bytes"] / HBM_BW
    assert row["t_collective_s"] == ex["collective_bytes"] / NVLINK_BW
    assert row["dominant"] in ("compute", "memory", "collective")
    text = report.dryrun_table(str(dry))
    assert "| 16x16 trace s |" in text
    assert f"| olmo-1b | train_4k | {res['lower_s']:.0f}s | MISSING |" in text
    assert "1/40 single-pod" in text
    text = report.roofline_table(str(out))
    assert "| olmo-1b | train_4k | %.2f |" % (1e3 * row["t_compute_s"]) \
        in text
    assert f"Dominant-term census: {row['dominant']}: 1" in text
    with pytest.raises(SystemExit):
        roofline.main(["--dryrun-dir", str(dry), "--out",
                       str(tmp_path / "BENCH_roofline.json")])
