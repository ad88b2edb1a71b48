"""The chaos layer's spans and counters (``repro_torch.obs``): a
``node_churn`` run at 512 XPUs counts ``chaos.events`` equal to the
observer's faults plus repairs and ``chaos.evicted`` equal to its
victims; ``chaos.fault`` holds the victim search (``chaos.victims``) and
each victim's replan (``policy.place``); ``chaos.repair`` closes once a
repair; a healthy run enters none of them. The records stay
byte-identical to ``repro``'s, run by run and through fleets."""
import json

import pytest
import torch

from repro_torch import obs
from repro_torch.core.engineconfig import EngineConfig
from repro_torch.eval import EvalRunner, make_tasks, run_task
from repro_torch.sim.scenarios import run_scenario

torch.set_num_threads(1)

CUDA_ON_CPU = EngineConfig("cuda", device="cpu")
TRACE_KW = {"cluster_xpus": 512, "size_scale": 32.0, "size_max": 512}
RFOLD = ("RFold (4^3)", "rfold", {"num_xpus": 512, "cube_n": 4})
FOLDING = ("Folding (8^3)", "folding", {"dims": [8, 8, 8]})


def _delta(fn):
    before = obs.totals()
    out = fn()
    return out, obs.diff(before, obs.totals())


def _beneath(d, parent, name):
    """Count of the span ``name`` entered directly beneath ``parent``."""
    return sum(a["count"] for p, a in d["paths"].items()
               if p.endswith(f"{parent}/{name}"))


def _check_chaos_trace(d, chaos, kill=False):
    c = d["counters"]
    assert c["chaos.events"] == chaos["faults"] + chaos["repairs"]
    assert c.get("chaos.evicted", 0) == chaos["victims"]
    spans = d["spans"]
    assert spans["chaos.fault"]["count"] == chaos["faults"]
    assert spans["chaos.repair"]["count"] == chaos["repairs"]
    assert spans["chaos.victims"]["count"] == chaos["faults"]
    assert spans["chaos.victims"]["parents"] == ["chaos.fault"]
    assert spans["chaos.fault"]["parents"] == spans["chaos.repair"][
        "parents"]
    replans = _beneath(d, "chaos.fault", "policy.place")
    assert replans == (0 if kill else chaos["migrated"] + chaos["preempted"])


@pytest.mark.parametrize("policy", [RFOLD, FOLDING], ids=["rfold", "folding"])
@pytest.mark.parametrize("seed", [0, 4])
def test_counters_equal_the_observer(policy, seed):
    from repro.sim import scenarios as ref_scenarios
    _, name, kw = policy
    rec, d = _delta(lambda: run_scenario(
        "node_churn", policy=name, policy_kw=dict(kw, engine=CUDA_ON_CPU),
        num_jobs=60, seed=seed, trace_kw=TRACE_KW))
    chaos = rec["chaos"]
    assert chaos["faults"] == chaos["repairs"] == 6
    assert chaos["victims"] > 0
    _check_chaos_trace(d, chaos)
    want = ref_scenarios.run_scenario(
        "node_churn", policy=name, policy_kw=dict(kw, engine="numpy"),
        num_jobs=60, seed=seed, trace_kw=TRACE_KW)
    assert json.dumps(rec, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_both_replan_branches_sit_beneath_the_fault_span():
    """Seed 4 at 512 XPUs migrates some victims and re-queues others:
    both outcomes of a replan are inside ``chaos.fault``."""
    rec, d = _delta(lambda: run_scenario(
        "node_churn", policy="rfold",
        policy_kw=dict(RFOLD[2], engine=CUDA_ON_CPU), num_jobs=60, seed=4,
        trace_kw=TRACE_KW))
    chaos = rec["chaos"]
    assert chaos["migrated"] > 0 and chaos["preempted"] > 0
    assert _beneath(d, "chaos.fault", "policy.place") == chaos["victims"]
    fault = d["spans"]["chaos.fault"]
    assert fault["total_s"] >= fault["self_s"] > 0


def test_kill_mode_evicts_without_replans():
    from repro.eval.runner import run_task as ref_run_task
    from repro.eval import make_tasks as ref_make_tasks
    kw = dict(runs=1, num_jobs=60, load=1.5, seed0=100,
              sim_kw={"fault_mode": "kill"}, scenario="node_churn",
              trace_kw=TRACE_KW)
    task = make_tasks([RFOLD], **kw)[0]
    rec, d = _delta(lambda: run_task(task, engine=CUDA_ON_CPU))
    chaos = rec["chaos"]
    assert chaos["killed"] == chaos["victims"] > 0
    _check_chaos_trace(d, chaos, kill=True)
    want = ref_run_task(ref_make_tasks([RFOLD], **kw)[0])
    rec.pop("sim_s"), want.pop("sim_s")
    assert json.dumps(rec, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_healthy_run_enters_no_chaos_span():
    task = make_tasks([RFOLD], 1, 40, 2.0, 7, trace_kw=TRACE_KW)[0]
    _, d = _delta(lambda: run_task(task, engine=CUDA_ON_CPU))
    assert not [n for n in d["spans"] if n.startswith("chaos.")]
    assert not [n for n in d["counters"] if n.startswith("chaos.")]


def test_fleet_trace_carries_the_chaos_counters():
    """Through ``EvalRunner`` fleets (``cuda`` on the CPU) the fleets'
    summed trace counts every run's events and victims, and the records
    equal ``repro.eval``'s, ``sim_s`` aside."""
    from repro.eval.runner import run_task as ref_run_task
    from repro.eval import make_tasks as ref_make_tasks
    kw = dict(runs=2, num_jobs=60, load=2.0, seed0=2**31 + 5,
              scenario="node_churn", trace_kw=TRACE_KW)
    runner = EvalRunner(workers=0, engine=CUDA_ON_CPU)
    records = runner.run(make_tasks([RFOLD], **kw))
    trace = runner.last_stats["fleet"]["trace"]
    total = {k: sum(r["chaos"][k] for r in records)
             for k in ("faults", "repairs", "victims", "migrated",
                       "preempted")}
    assert total["victims"] > 0
    _check_chaos_trace(trace, total)
    assert trace["spans"]["chaos.fault"]["parents"] == ["sim.run"]
    want = [ref_run_task(t) for t in ref_make_tasks([RFOLD], **kw)]
    strip = [{k: v for k, v in r.items() if k != "sim_s"}
             for r in records]
    ref = [{k: v for k, v in r.items() if k != "sim_s"} for r in want]
    assert json.dumps(strip, sort_keys=True) == json.dumps(ref,
                                                           sort_keys=True)
