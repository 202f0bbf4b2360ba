"""Port vs reference: the bench/launch harness. ``repro_torch.harness`` is
held to ``repro.harness`` on the same inputs, with the reference's
topologies mapped to the port's counterparts (``local-cpu`` to
``local-cpu``, ``tpu-pod`` to ``h100-pod``, ``tpu-2pod`` to ``h100-2pod``):
plan expansion, the local executor under a virtual clock with the same
fault schedule, the baseline rules, manifests and ``run_plan`` end to end
must agree, every difference limited to those substitutions (topology
names and keys, the manifest's resource, hosts and command).

Then the reference's own harness cases (``tests/test_harness.py``) on the
port, and the clauses only the port has: a ``cuda`` job with no card fails
as ``unsupported`` and never runs on the CPU; a ``cuda`` attempt
synchronises the card inside its clock; a CUDA out-of-memory error retries
as ``resource``; legacy baselines stay ``cpu:1``; discovery imports only
``bench_torch_*`` modules; the package imports neither JAX nor the
reference.

Run plain (no ``REPRO_FAULT``) everything asserts the healthy path; under
``REPRO_FAULT=harness_job`` (armed for the whole process, which arms both
packages' executors) the matrix-aware soak asserts the degradation
contract, and the targeted tests disarm it and arm their own hits.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.harness as ref
import repro_torch.harness as port
from repro.core import health as ref_health
from repro.serve import VirtualClock as RefClock
from repro.testing import faults as ref_faults
from repro_torch.core import health
from repro_torch.harness import cli, executor, registry
from repro_torch.serve.frontend import VirtualClock
from repro_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's topology names -> the port's counterparts.
TOPO_MAP = {"local-cpu": "local-cpu", "tpu-pod": "h100-pod",
            "tpu-2pod": "h100-2pod"}
KEY_MAP = {ref.TOPOLOGIES[r].key: port.TOPOLOGIES[p].key
           for r, p in TOPO_MAP.items()}
H100_POD = port.TOPOLOGIES["h100-pod"]
LOCAL_CPU = port.TOPOLOGIES["local-cpu"]
PATH_FIELDS = ("log", "artifact", "manifest")


@pytest.fixture(autouse=True)
def _isolate():
    for f, h in ((faults, health), (ref_faults, ref_health)):
        f.reset()
        h.clear_health()
    yield
    for f, h in ((faults, health), (ref_faults, ref_health)):
        f.reset()
        h.clear_health()


@pytest.fixture
def no_fault(monkeypatch):
    """Disarm any process-level REPRO_FAULT (both packages read it)."""
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    faults.reset()
    ref_faults.reset()


@pytest.fixture
def clock():
    return VirtualClock()


@pytest.fixture
def card(monkeypatch):
    """A card that is "present": ``torch.cuda.is_available`` true and
    ``torch.cuda.synchronize`` recorded (it advances a virtual clock by the
    seconds in ``sync_s``, standing in for the card's queued work)."""
    state = {"syncs": 0, "sync_s": 0.0, "clock": None, "raise": None}

    def synchronize(device=None):
        state["syncs"] += 1
        if state["clock"] is not None:
            state["clock"].sleep(state["sync_s"])
        if state["raise"] is not None:
            raise state["raise"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return state


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _topos(h):
    """{reference name: topology} of package ``h`` (its counterparts)."""
    if h is ref:
        return {name: ref.TOPOLOGIES[name] for name in TOPO_MAP}
    return {name: port.TOPOLOGIES[p] for name, p in TOPO_MAP.items()}


def _local(h, clock, run_dir=None, **kw):
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_cap_s", 0.15)
    return h.LocalExecutor(run_dir=run_dir, clock=clock, sleep=clock.sleep,
                           **kw)


def _one_job(h, spec):
    return h.expand([spec]).jobs[0]


def _no_paths(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in PATH_FIELDS}


def _name(job, topo_named: bool) -> str:
    """A job's name built from its fields: bench, config, the topology's
    name where the package's rule names it, then the params."""
    parts = [job.bench] + ([job.config] if job.config is not None else [])
    parts += [job.topology.name] if topo_named else []
    parts += [f"{k}{v}" for k, v in sorted(job.params.items())]
    return "--".join(parts)


# ---------------------------------------------------------------------------
# Parity: plan expansion
# ---------------------------------------------------------------------------

def _kw_fn(config, n, mode="x"):
    return None


def _specs_grid(h, T):
    return [h.RunSpec(bench="grid", fn=_kw_fn, configs=("mixtral", "llama4"),
                      topologies=(T["local-cpu"], T["tpu-pod"]),
                      params={"n": (64, 128)})]


def _specs_ordered(h, T):
    return [h.RunSpec(bench="a", fn=_kw_fn, order=20, smoke=True,
                      topologies=T["local-cpu"], params={"n": 1}),
            h.RunSpec(bench="b", fn=_kw_fn, order=10, configs="c",
                      topologies=T["local-cpu"]),
            h.RunSpec(bench="c", fn=_kw_fn, order=10, smoke=True,
                      topologies=(T["tpu-2pod"],), params={"mode": "fast"})]


def _specs_pods(h, T):
    return [h.RunSpec(bench="pods", fn=_kw_fn, configs=("olmo-1b",),
                      topologies=(T["tpu-pod"], T["tpu-2pod"]),
                      params={"n": (1, 2), "mode": ("a", "b")})]


def _specs_local_only(h, T):
    return [h.RunSpec(bench="solo", fn=lambda: None,
                      topologies=T["local-cpu"], params={"n": (3, 4)})]


EXPAND_CASES = {
    "full_grid": (_specs_grid, {}),
    "ordered": (_specs_ordered, {}),
    "smoke": (_specs_ordered, {"smoke": True}),
    "bench_filter": (_specs_ordered, {"benches": ["b", "c"]}),
    "topology_override": (_specs_ordered, {"topology": "tpu-pod"}),
    "two_pods": (_specs_pods, {}),
    "local_only": (_specs_local_only, {}),
}


@pytest.mark.parametrize("case", sorted(EXPAND_CASES))
def test_expand_parity(case):
    """The same jobs in the same order with the same configs, params and
    call kwargs; names equal but for the topology's name (and whether the
    package's local-topology rule names it); keys mapped."""
    make, kw = EXPAND_CASES[case]
    plans = {}
    for h in (ref, port):
        T = _topos(h)
        kw_h = dict(kw)
        if "topology" in kw_h:
            kw_h["topology"] = T[kw_h["topology"]]
        plans[h] = h.expand(make(h, T), **kw_h)
    rp, pp = plans[ref], plans[port]
    assert len(rp.jobs) == len(pp.jobs) > 0
    assert rp.smoke == pp.smoke
    for rj, pj in zip(rp.jobs, pp.jobs):
        n = len(rj.spec.topologies) if "topology" not in kw else 1
        assert rj.name == _name(rj, rj.topology.key != "cpu:1" or n > 1)
        assert pj.name == _name(pj, pj.topology.key != "cuda:1" or n > 1)
        assert (rj.bench, rj.config, rj.params) == (pj.bench, pj.config,
                                                    pj.params)
        assert TOPO_MAP[rj.topology.name] == pj.topology.name
        assert KEY_MAP[rj.topology.key] == pj.topology.key
        assert {**rj.as_dict(), "name": None, "topology": None} == \
            {**pj.as_dict(), "name": None, "topology": None}
        fn = rj.resolve_fn()
        assert rj.call_kwargs(fn) == pj.call_kwargs(pj.resolve_fn())


# ---------------------------------------------------------------------------
# Parity: the local executor under a virtual clock
# ---------------------------------------------------------------------------

def _exec_case(name):
    """(spec kwargs, fn factory(clock, calls), fault nth or "all" or None)."""
    def plain(clock, calls):
        return lambda: calls.append(1)

    def kw(clock, calls):
        def fn(config, n):
            calls.append((config, n))
        return fn

    def raises(exc):
        def make(clock, calls):
            def fn():
                calls.append(1)
                raise exc
            return fn
        return make

    def slow(durations):
        def make(clock, calls):
            todo = list(durations)

            def fn():
                calls.append(1)
                clock.sleep(todo.pop(0) if len(todo) > 1 else todo[0])
            return fn
        return make

    def flaky_oom(clock, calls):
        def fn():
            calls.append(1)
            if len(calls) == 1:
                raise MemoryError("out of memory")
        return fn

    cases = {
        "clean": (dict(), plain, None),
        "kwargs": (dict(configs=("cfgA",), params={"n": (3,)}), kw, None),
        "fault_once": (dict(), plain, 1),
        "fault_persistent": (dict(max_retries=3), plain, "all"),
        "fault_second_only": (dict(), plain, 2),
        "non_retryable": (dict(), raises(NotImplementedError("no such "
                                                             "backend")),
                          None),
        "runtime_exhausts": (dict(max_retries=1),
                             raises(RuntimeError("kernel failed")), None),
        "resource_then_ok": (dict(), flaky_oom, None),
        "timeout_once": (dict(timeout_s=2.0), slow([10.0, 0.5]), None),
        "timeout_persistent": (dict(timeout_s=2.0), slow([10.0]), None),
        "no_retries": (dict(max_retries=0), plain, "all"),
    }
    return cases[name]


EXEC_CASES = ("clean", "kwargs", "fault_once", "fault_persistent",
              "fault_second_only", "non_retryable", "runtime_exhausts",
              "resource_then_ok", "timeout_once", "timeout_persistent",
              "no_retries")


def _run_exec(h, f, name, tmp_path):
    spec_kw, make, nth = _exec_case(name)
    spec_kw = {"max_retries": 2, "timeout_s": 100.0, **spec_kw}
    clock = RefClock() if h is ref else VirtualClock()
    calls = []
    spec = h.RunSpec(bench=f"job-{name}", fn=make(clock, calls),
                     topologies=_topos(h)["local-cpu"], **spec_kw)
    run_dir = tmp_path / ("ref" if h is ref else "port")
    ex = _local(h, clock, run_dir=run_dir)
    job = _one_job(h, spec)
    if nth is None:
        res = ex.run(job)
    else:
        with f.inject("harness_job", nth=None if nth == "all" else nth):
            res = ex.run(job)
    return job, res, calls, clock()


@pytest.mark.parametrize("name", EXEC_CASES)
def test_local_executor_parity(no_fault, tmp_path, name):
    """The same JobResult (status, attempts, retries, backoffs, failure
    class, detail, timed_out, duration on the virtual clock), the same
    calls and the same virtual time; only the paths differ, and the name
    by the topology the port's rule names (its local topology is the
    card)."""
    r_job, r_res, r_calls, r_t = _run_exec(ref, ref_faults, name, tmp_path)
    p_job, p_res, p_calls, p_t = _run_exec(port, faults, name, tmp_path)
    assert r_res.name == _name(r_job, False)
    assert p_res.name == _name(p_job, True)
    assert {**_no_paths(r_res.as_dict()), "name": None} == \
        {**_no_paths(p_res.as_dict()), "name": None}
    assert r_calls == p_calls
    assert r_t == pytest.approx(p_t)
    assert (r_res.log is None) == (p_res.log is None)
    assert open(r_res.log).read() == open(p_res.log).read()


# ---------------------------------------------------------------------------
# Parity: baselines
# ---------------------------------------------------------------------------

def _base(cpu_speedup=2.0, pod_speedup=None, pod_key="tpu:16x16"):
    topologies = {"cpu:1": {"results": [{"name": "r",
                                         "speedup_x": cpu_speedup}]}}
    if pod_speedup is not None:
        topologies[pod_key] = {"results": [{"name": "r",
                                            "speedup_x": pod_speedup}]}
    return {"bench": "fake", "schema": 2, "topologies": topologies}


def _fresh(speedup, **extra):
    return {"bench": "fake", "results": [{"name": "r", "speedup_x": speedup,
                                          **extra}]}


CHECK_CASES = {
    "ok": ("cpu:1", _fresh(1.9), _base(2.0)),
    "regression": ("cpu:1", _fresh(1.0), _base(2.0)),
    "other_topology_no_trigger": ("cpu:1", _fresh(1.9), _base(2.0, 100.0)),
    "other_topology_no_mask": ("cpu:1", _fresh(1.0), _base(2.0, 100.0)),
    "missing_baseline": ("cpu:1", _fresh(1.0), None),
    "missing_topology": ("cpu:1", _fresh(5.0),
                         {"schema": 2, "topologies": {"tpu:16x16": {
                             "results": [{"name": "r",
                                          "speedup_x": 3.0}]}}}),
    "missing_artifact": ("cpu:1", None, _base(2.0)),
    "missing_row": ("cpu:1", {"results": [{"name": "other",
                                           "speedup_x": 9.0}]}, _base(2.0)),
    "legacy_baseline": ("cpu:1", _fresh(1.5),
                        {"results": [{"name": "r", "speedup_x": 2.0}]}),
    "legacy_fresh_on_pod": ("tpu:16x16", _fresh(1.5), _base(2.0, 3.0)),
    "pod_entry": ("tpu:16x16", {"schema": 2, "topologies": {
        "tpu:16x16": {"results": [{"name": "r", "speedup_x": 2.9}]}}},
        _base(2.0, 3.0)),
    "non_numeric_fresh": ("cpu:1", _fresh("n/a"), _base(2.0)),
}


def _to_port_keys(payload):
    """A payload with the reference's topology keys mapped to the port's."""
    if payload is None or "topologies" not in payload:
        return payload
    return {**payload, "topologies": {KEY_MAP.get(k, k): v for k, v in
                                      payload["topologies"].items()}}


def _rows_to_port_keys(rows):
    """Verdict rows with the reference's topology keys mapped, in the
    ``topology`` field and inside a ``detail`` string."""
    out = []
    for r in rows:
        r = {**r, "topology": KEY_MAP.get(r["topology"], r["topology"])}
        if "detail" in r:
            for k, v in KEY_MAP.items():
                r["detail"] = r["detail"].replace(f"'{k}'", f"'{v}'")
        out.append(r)
    return out


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_artifact_parity(case):
    key, fresh, base = CHECK_CASES[case]
    r_fail, r_checks = ref.check_artifact("BENCH_fake.smoke.json", key,
                                          fresh, base)
    p_fail, p_checks = port.check_artifact(
        "BENCH_fake.smoke.json", KEY_MAP[key], _to_port_keys(fresh),
        _to_port_keys(base))
    assert r_fail == p_fail
    assert _rows_to_port_keys(r_checks) == p_checks


MERGE_CASES = {
    "keeps_other_topology": (_fresh(2.5), "cpu:1", _base(2.0, 100.0)),
    "no_committed": (_fresh(2.5), "cpu:1", None),
    "legacy_committed": (_fresh(2.5), "cpu:1",
                         {"results": [{"name": "r", "speedup_x": 1.0}]}),
    "rehomed_to_pod": (_fresh(4.0, n=8), "tpu:16x16", _base(2.0, 3.0)),
    "fresh_schema2": ({"bench": "fake", "schema": 2, "topologies": {
        "cpu:1": {"results": [{"name": "q", "speedup_y": 7.0}]}}},
        "cpu:1", _base(2.0)),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_and_topology_payloads_parity(case):
    fresh, key, committed = MERGE_CASES[case]
    r = ref.merge_topology_artifact(fresh, key, committed)
    p = port.merge_topology_artifact(_to_port_keys(fresh), KEY_MAP[key],
                                     _to_port_keys(committed))
    assert _to_port_keys(r) == p
    for payload in (fresh, committed or {}):
        assert {KEY_MAP.get(k, k): v for k, v in
                ref.topology_payloads(payload).items()} == \
            port.topology_payloads(_to_port_keys(payload))


def test_legacy_payloads_are_cpu_1_in_both():
    """A schema-1 payload reads as ``cpu:1`` in both packages, though the
    port's local topology is the card (``cuda:1``)."""
    legacy = {"results": [1, 2]}
    assert ref.topology_payloads(legacy) == {"cpu:1": {"results": [1, 2]}}
    assert port.topology_payloads(legacy) == {"cpu:1": {"results": [1, 2]}}
    assert port.LOCAL_TOPOLOGY.key == "cuda:1"
    from repro_torch.harness import baselines
    assert baselines.LEGACY_TOPOLOGY_KEY == "cpu:1"


ROWS = [
    {"name": "a", "n": 64, "speedup_x": 1.5, "t_us": 3.0,
     "speedup_note": "text"},
    {"name": "a", "n": 128},
    {"dist": "zipf", "shape": "4x8", "dtype": "bf16", "e": 8, "m": 4,
     "k": 16, "speedup": 2, "speedup_vs_ref": 1.25},
    {},
]


@pytest.mark.parametrize("i", range(len(ROWS)))
def test_row_key_and_speedup_fields_parity(i):
    row = ROWS[i]
    assert ref.row_key(row) == port.row_key(row)
    assert ref.speedup_fields(row) == port.speedup_fields(row)
    from repro.harness import baselines as rb
    from repro_torch.harness import baselines as pb
    assert rb.key_str(rb.row_key(row)) == pb.key_str(pb.row_key(row))


def test_snapshot_baselines_parity(tmp_path):
    (tmp_path / "BENCH_a.smoke.json").write_text(json.dumps(_base()))
    (tmp_path / "BENCH_b.smoke.json").write_text("not json")
    (tmp_path / "BENCH_c.json").write_text(json.dumps(_base()))
    assert ref.snapshot_baselines(tmp_path) == \
        port.snapshot_baselines(tmp_path)
    assert set(port.snapshot_baselines(tmp_path)) == {"BENCH_a.smoke.json"}


# ---------------------------------------------------------------------------
# Parity: manifests
# ---------------------------------------------------------------------------

MANIFEST_CASES = {
    "pod_config_params": ("tpu-pod", dict(configs=("llama4-scout",),
                                          params={"seq": (4096,)}), False),
    "pod_smoke": ("tpu-pod", dict(), True),
    "two_pod": ("tpu-2pod", dict(params={"n": (8,), "mode": ("fast",)}),
                False),
    "local_cpu": ("local-cpu", dict(configs=("olmo-1b",)), True),
    "no_timeout": ("tpu-pod", dict(timeout_s=None, max_retries=0), False),
}


def _manifest_jobs(case):
    topo, kw, smoke = MANIFEST_CASES[case]
    kw = {"timeout_s": 600.0, "max_retries": 2, **kw}
    jobs = {}
    for h in (ref, port):
        spec = h.RunSpec(bench="ep_sharded", module="benchmarks.bench_ep",
                         topologies=(_topos(h)[topo],), **kw)
        jobs[h] = _one_job(h, spec)
    return jobs[ref], jobs[port], smoke


@pytest.mark.parametrize("case", sorted(MANIFEST_CASES))
def test_job_manifest_parity(case):
    """The port's manifest is the reference's with the listed substitutions
    and nothing else: the resource key and count a host, the hosts
    (completions, parallelism), the command, the topology key (env and
    label) and the job's name."""
    rj, pj, smoke = _manifest_jobs(case)
    want = json.loads(json.dumps(ref.job_manifest(rj, smoke=smoke)))
    spec = want["spec"]
    container = spec["template"]["spec"]["containers"][0]
    limits = container["resources"]["limits"]
    (ref_res,) = limits
    topo = pj.topology
    resource = "nvidia.com/gpu" if topo.backend == "cuda" else "cpu"
    assert ref_res == ("google.com/tpu" if rj.topology.backend == "tpu"
                       else "cpu")
    container["resources"]["limits"] = {
        resource: max(1, topo.devices // topo.hosts)}
    spec["completions"] = spec["parallelism"] = topo.hosts
    assert container["command"][:3] == ["python", "-m", "benchmarks.run"]
    container["command"][2] = "repro_torch.harness"
    for e in container["env"]:
        if e["name"] == "REPRO_BENCH_TOPOLOGY":
            assert e["value"] == rj.topology.key
            e["value"] = topo.key
    want["metadata"]["labels"]["topology"] = executor._k8s_name(topo.key)
    want["metadata"]["name"] = executor._k8s_name(
        f"repro-bench-{pj.name}")
    assert port.job_manifest(pj, smoke=smoke) == want


def test_job_manifest_golden_h100_pod():
    s = port.RunSpec(bench="ep_sharded", module="benchmarks.bench_ep",
                     configs=("llama4-scout",), topologies=(H100_POD,),
                     params={"seq": (4096,)}, timeout_s=600.0, max_retries=2)
    assert port.job_manifest(_one_job(port, s)) == {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": "repro-bench-ep-sharded--llama4-scout--h100-pod--seq4096",
            "labels": {"app": "repro-bench", "bench": "ep-sharded",
                       "topology": "cuda-16x16"},
        },
        "spec": {
            "backoffLimit": 2,
            "completions": 32,
            "parallelism": 32,
            "activeDeadlineSeconds": 600,
            "template": {
                "metadata": {"labels": {"app": "repro-bench"}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "bench",
                        "image": "repro/bench:latest",
                        "command": ["python", "-m", "repro_torch.harness",
                                    "--bench", "ep_sharded"],
                        "env": [
                            {"name": "REPRO_BENCH_TOPOLOGY",
                             "value": "cuda:16x16"},
                            {"name": "REPRO_BENCH_CONFIG",
                             "value": "llama4-scout"},
                            {"name": "REPRO_BENCH_PARAM_SEQ",
                             "value": "4096"},
                        ],
                        "resources": {"limits": {"nvidia.com/gpu": 8}},
                    }],
                },
            },
        },
    }


@pytest.mark.parametrize("topo", ["h100-pod", "h100-2pod"])
def test_manifest_executor_emits_without_running(tmp_path, topo):
    calls = []
    s = port.RunSpec(bench="never", fn=lambda: calls.append(1),
                     topologies=port.TOPOLOGIES[topo])
    res = port.ManifestExecutor(run_dir=tmp_path).run(_one_job(port, s))
    assert res.status == "emitted" and res.attempts == 0 and not calls
    manifest = json.loads(open(res.manifest).read())
    assert manifest["kind"] == "Job"
    t = port.TOPOLOGIES[topo]
    assert manifest["spec"]["parallelism"] == t.hosts
    limits = manifest["spec"]["template"]["spec"]["containers"][0][
        "resources"]["limits"]
    assert limits == {"nvidia.com/gpu": 8}


# ---------------------------------------------------------------------------
# Parity: run_plan end to end
# ---------------------------------------------------------------------------

def _artifact_spec(h, root, speedup):
    def fn():
        (root / "BENCH_fake.smoke.json").write_text(
            json.dumps(_fresh(speedup)))

    return h.RunSpec(bench="fake", fn=fn, artifact="BENCH_fake", smoke=True,
                     order=1, timeout_s=100.0,
                     topologies=_topos(h)["local-cpu"])


def _plan_specs(h, root, speedup):
    T = _topos(h)
    return [
        _artifact_spec(h, root, speedup),
        h.RunSpec(bench="plain", fn=lambda: None, smoke=True, order=2,
                  timeout_s=100.0, topologies=T["local-cpu"]),
        h.RunSpec(bench="sharded", fn=lambda: None, smoke=True, order=3,
                  topologies=(T["tpu-pod"],), timeout_s=100.0),
    ]


def _siblings(h, root, speedup):
    return [h.RunSpec(bench=f"job{i}", fn=lambda: None, smoke=True,
                      order=i, timeout_s=100.0, max_retries=2,
                      topologies=_topos(h)["local-cpu"])
            for i in range(3)]


RUN_PLAN_CASES = {
    "healthy": (_plan_specs, 1.9, {"BENCH_fake.smoke.json":
                                   _base(2.0, 100.0)}, True, None),
    "regression": (_plan_specs, 1.0, {"BENCH_fake.smoke.json":
                                      _base(2.0, 100.0)}, True, None),
    "missing_baseline": (_plan_specs, 5.0, {}, True, None),
    "no_check": (_plan_specs, 1.0, {"BENCH_fake.smoke.json":
                                    _base(2.0)}, False, None),
    "one_poisoned": (_siblings, None, {}, True, (1, 2, 3)),
    "retried": (_siblings, None, {}, True, 1),
}


def _run_plan(h, f, case, root):
    make, speedup, committed, check, nth = RUN_PLAN_CASES[case]
    root.mkdir()
    clock = RefClock() if h is ref else VirtualClock()
    committed = {k: (v if h is ref else _to_port_keys(v))
                 for k, v in committed.items()}
    plan = h.expand(make(h, root, speedup), smoke=True)

    def go():
        return h.run_plan(plan, root=root, run_dir=root / "run",
                          run_id="run-test", check=check,
                          committed_baselines=committed, clock=clock,
                          sleep=clock.sleep)
    if nth is None:
        return go()
    with f.inject("harness_job", nth=nth):
        return go()


@pytest.mark.parametrize("case", sorted(RUN_PLAN_CASES))
def test_run_plan_parity(no_fault, tmp_path, case):
    """Equal counters, job rows (paths, names and keys mapped), regression
    rows, exit codes and health; the rewritten artifacts equal with the
    keys mapped."""
    r = _run_plan(ref, ref_faults, case, tmp_path / "ref")
    p = _run_plan(port, faults, case, tmp_path / "port")
    assert r.counters == p.counters
    assert r.exit_code == p.exit_code and r.failures == p.failures
    assert r.health == p.health == {}
    assert _rows_to_port_keys(r.regressions) == p.regressions
    assert len(r.jobs) == len(p.jobs)
    for rj, pj in zip(r.jobs, p.jobs):
        # These specs declare one topology and no config or params: the
        # port names its local-cpu jobs (its local topology is the card).
        name = (f"{rj['name']}--local-cpu" if rj["topology"] == "cpu:1"
                else rj["name"].replace("tpu-pod", "h100-pod"))
        rj = {**_no_paths(rj), "topology": KEY_MAP[rj["topology"]],
              "name": name}
        assert rj == _no_paths(pj)
    on_disk = json.loads((tmp_path / "port" / "run" /
                          "harness_report.json").read_text())
    assert on_disk["exit_code"] == p.exit_code
    assert on_disk["counters"] == p.counters
    art = "BENCH_fake.smoke.json"
    if (tmp_path / "ref" / art).exists():
        assert _to_port_keys(json.loads((tmp_path / "ref" / art).read_text())) \
            == json.loads((tmp_path / "port" / art).read_text())


# ---------------------------------------------------------------------------
# Parity: the public surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["RunSpec", "Topology", "JobResult",
                                  "HarnessReport", "Job", "Plan"])
def test_dataclass_fields_equal_the_reference(name):
    assert [f.name for f in dataclasses.fields(getattr(ref, name))] == \
        [f.name for f in dataclasses.fields(getattr(port, name))]


def test_public_surface_equals_the_reference():
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert hasattr(port, name), name
    assert set(port.EXECUTORS) == set(ref.EXECUTORS)
    assert port.JOB_STATES == ref.JOB_STATES
    assert port.RETRYABLE_CLASSES == ref.RETRYABLE_CLASSES
    assert port.REGRESSION_TOLERANCE == ref.REGRESSION_TOLERANCE
    assert port.SCHEMA_VERSION == ref.SCHEMA_VERSION
    for mod in ("spec", "registry", "report", "baselines", "executor",
                "runner", "cli"):
        r = __import__(f"repro.harness.{mod}", fromlist=["__all__"])
        p = __import__(f"repro_torch.harness.{mod}", fromlist=["__all__"])
        assert r.__all__ == p.__all__, mod


# ---------------------------------------------------------------------------
# The reference's harness cases on the port
# ---------------------------------------------------------------------------

def _spec(fn=None, bench="job", **kw):
    kw.setdefault("max_retries", 2)
    kw.setdefault("timeout_s", 100.0)
    kw.setdefault("topologies", LOCAL_CPU)
    return port.RunSpec(bench=bench, fn=fn or (lambda: None), **kw)


def test_topology_key_devices_local():
    t = port.Topology(name="two-pod", backend="cuda", mesh=(2, 16, 16),
                      hosts=64)
    assert t.key == "cuda:2x16x16"
    assert t.devices == 512
    assert not t.is_local()
    assert port.LOCAL_TOPOLOGY.key == "cuda:1"
    assert port.LOCAL_TOPOLOGY.name == "local-cuda"
    assert port.LOCAL_TOPOLOGY.is_local() and LOCAL_CPU.is_local()
    assert LOCAL_CPU.key == "cpu:1"
    assert port.Topology(name="one-host", mesh=(8,)).is_local()
    assert {n: (t.key, t.hosts) for n, t in port.TOPOLOGIES.items()} == {
        "local-cuda": ("cuda:1", 1), "local-cpu": ("cpu:1", 1),
        "h100-pod": ("cuda:16x16", 32), "h100-2pod": ("cuda:2x16x16", 64)}


@pytest.mark.parametrize("mesh,hosts", [((), 1), ((0,), 1), ((2, 0), 1),
                                        ((1,), 0)])
def test_topology_rejects_bad_mesh(mesh, hosts):
    with pytest.raises(ValueError):
        port.Topology(name="bad", mesh=mesh, hosts=hosts)


def test_runspec_normalizes_axes():
    s = port.RunSpec(bench="b", fn=lambda: None, configs="only",
                     topologies=port.LOCAL_TOPOLOGY,
                     params={"n": (1, 2), "mode": "fast"})
    assert s.configs == ("only",)
    assert s.topologies == (port.LOCAL_TOPOLOGY,)
    assert s.params == (("mode", ("fast",)), ("n", (1, 2)))
    assert hash(s)


@pytest.mark.parametrize("kw", [dict(bench="b"), dict(bench="", fn=print),
                                dict(bench="b", fn=print, topologies=()),
                                dict(bench="b", fn=print, max_retries=-1)])
def test_runspec_rejects_bad_declarations(kw):
    with pytest.raises(ValueError):
        port.RunSpec(**kw)


def test_expand_unknown_bench_is_loud():
    with pytest.raises(KeyError):
        port.expand([_spec(bench="real")], benches=["typo"])
    with pytest.raises(ValueError):
        port.expand([_spec(bench="dup"), _spec(bench="dup", order=7)])


def test_log_capture_into_run_dir(no_fault, clock, tmp_path):
    def fn():
        print("hello-from-the-job")
        print("to-stderr", file=sys.stderr)

    res = _local(port, clock, run_dir=tmp_path).run(
        _one_job(port, _spec(fn=fn, bench="logged")))
    assert res.status == "completed"
    log = open(res.log).read()
    assert "hello-from-the-job" in log and "to-stderr" in log


@pytest.fixture
def scratch_registry():
    saved = dict(registry.BENCHES)
    yield registry
    registry.BENCHES.clear()
    registry.BENCHES.update(saved)


def test_register_is_idempotent_but_conflicts_raise(scratch_registry):
    s = _spec(bench="once")
    scratch_registry.register_bench(s)
    scratch_registry.register_bench(s)
    with pytest.raises(ValueError):
        scratch_registry.register_bench(_spec(bench="once", order=999))
    assert s in scratch_registry.registered()


def test_committed_smoke_baselines_read_alike():
    """The repo's committed smoke baselines read the same through both
    packages: schema 2, with a ``cpu:1`` entry."""
    snap = port.snapshot_baselines(REPO)
    assert snap == ref.snapshot_baselines(REPO)
    assert len(snap) >= 5
    for name, payload in snap.items():
        assert payload.get("schema") == 2, name
        assert port.topology_payloads(payload)["cpu:1"]["results"], name


def test_job_result_roundtrips_to_dict():
    res = port.JobResult(name="n", bench="b", topology="cuda:1",
                         status="completed", backoffs=(0.05, 0.1))
    d = res.as_dict()
    assert d["backoffs"] == [0.05, 0.1]
    json.dumps(d)


def test_report_counts_failures_and_writes(tmp_path):
    rep = port.HarnessReport(run_id="r", run_dir=str(tmp_path), smoke=True,
                             check=True, tolerance=1.25,
                             counters={"failed": 1, "regression_failures": 2})
    assert rep.failures == 3 and rep.exit_code == 1
    path = rep.write(tmp_path / "sub" / "harness_report.json")
    assert json.loads(path.read_text())["exit_code"] == 1
    assert port.HarnessReport("r", "", False, False, 1.25).exit_code == 0


def test_soak_under_whatever_site_the_matrix_armed(tmp_path):
    """Matrix-aware: under ``REPRO_FAULT=harness_job`` (armed process-wide,
    every hit) every job burns its full retry budget and fails — but the
    run completes, siblings are independent, and the report stays
    conservation-consistent. Unarmed (tier-1), everything completes."""
    site, nth = faults.active()
    clock = VirtualClock()
    specs = [port.RunSpec(bench=f"s{i}", fn=lambda: None, smoke=True,
                          order=i, timeout_s=100.0, max_retries=2,
                          topologies=LOCAL_CPU) for i in range(3)]
    report = port.run_plan(port.expand(specs, smoke=True), root=tmp_path,
                           clock=clock, sleep=clock.sleep)
    c = report.counters
    assert len(report.jobs) == 3
    assert c["jobs"] == c["completed"] + c["failed"] + c["emitted"]
    if site == "harness_job" and nth is None:
        assert all(j["status"] == "failed" for j in report.jobs)
        assert all(j["attempts"] == 3 for j in report.jobs)
        assert c["retries"] == 6
        assert report.exit_code == 1
    elif site is None:
        assert all(j["status"] == "completed" for j in report.jobs)
        assert report.exit_code == 0


def test_run_plan_survives_an_executor_that_raises(no_fault, tmp_path,
                                                   monkeypatch):
    """A job whose executor itself raises is one failed, classified row;
    the run goes on."""
    def boom(self, job):
        raise MemoryError("out of memory while emitting")
    monkeypatch.setattr(port.ManifestExecutor, "run", boom)
    specs = [_spec(bench="a", order=1),
             _spec(bench="b", order=2, topologies=H100_POD)]
    report = port.run_plan(port.expand(specs), root=tmp_path)
    rows = {j["bench"]: j for j in report.jobs}
    assert rows["a"]["status"] == "completed"
    assert rows["b"]["status"] == "failed"
    assert rows["b"]["failure_class"] == "resource"
    assert report.exit_code == 1


# ---------------------------------------------------------------------------
# Port-only clauses
# ---------------------------------------------------------------------------

def test_cuda_job_without_a_card_fails_unsupported(no_fault, no_card,
                                                   tmp_path):
    """A ``local-cuda`` job on a box with no card: failed as
    ``unsupported`` before any attempt, not retried, its callable never
    called, its detail naming the missing device; its sibling on the CPU
    completes."""
    calls = []
    specs = [port.RunSpec(bench="on-card", fn=lambda: calls.append(1),
                          max_retries=3, order=1),
             port.RunSpec(bench="on-cpu", fn=lambda: calls.append(2),
                          order=2, topologies=LOCAL_CPU)]
    clock = VirtualClock()
    report = port.run_plan(port.expand(specs), root=tmp_path,
                           run_dir=tmp_path / "run", clock=clock,
                           sleep=clock.sleep)
    card_row, cpu_row = report.jobs
    assert card_row["name"] == "on-card" and card_row["topology"] == "cuda:1"
    assert card_row["status"] == "failed"
    assert card_row["failure_class"] == "unsupported"
    assert card_row["attempts"] == 0 and card_row["retries"] == 0
    assert card_row["backoffs"] == []
    assert "CUDA" in card_row["detail"] and "CPU" in card_row["detail"]
    assert cpu_row["status"] == "completed"
    assert calls == [2]
    assert clock() == 0.0
    assert report.counters["failed"] == 1 and report.exit_code == 1


def test_cuda_job_with_no_card_never_consumes_a_fault_hit(no_card):
    """No attempt is made, so the ``harness_job`` site is never reached."""
    clock = VirtualClock()
    job = _one_job(port, port.RunSpec(bench="x", fn=lambda: None))
    with faults.inject("harness_job", nth=1):
        res = _local(port, clock).run(job)
        assert faults.hits("harness_job") == 0
    assert res.failure_class == "unsupported"


def test_cuda_attempt_synchronises_inside_its_clock(no_fault, card):
    """The card is synchronised after the callable and before the clock is
    read: ``duration_s`` counts the card's queued work (here 3 virtual
    seconds), and that work counts toward the timeout."""
    clock = VirtualClock()
    card.update(clock=clock, sync_s=3.0)
    order = []

    def fn():
        order.append(card["syncs"])
        clock.sleep(0.5)
    job = _one_job(port, port.RunSpec(bench="k", fn=fn, timeout_s=10.0))
    res = _local(port, clock).run(job)
    assert res.status == "completed"
    assert res.duration_s == pytest.approx(3.5)
    assert order == [0] and card["syncs"] == 1
    clock2 = VirtualClock()
    card.update(clock=clock2, sync_s=3.0, syncs=0)
    slow = _one_job(port, port.RunSpec(bench="k", fn=lambda: None,
                                       timeout_s=2.0, max_retries=1))
    res = _local(port, clock2).run(slow)
    assert res.status == "failed" and res.timed_out
    assert res.failure_class == "timeout" and card["syncs"] == 2


def test_cpu_attempt_never_touches_the_card(no_fault, card):
    job = _one_job(port, _spec())
    res = _local(port, VirtualClock()).run(job)
    assert res.status == "completed" and card["syncs"] == 0


@pytest.mark.parametrize("error,cls,attempts", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "runtime", 3),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "160.00 GiB"), "resource", 3),
    (NotImplementedError("no such kernel"), "unsupported", 1),
])
def test_asynchronous_card_error_lands_in_its_job(no_fault, card, error, cls,
                                                  attempts):
    """An error the synchronise raises (an asynchronous CUDA error) fails
    the attempt that queued the work, classified and retried by class."""
    card["raise"] = error
    clock = VirtualClock()
    res = _local(port, clock).run(_one_job(port, port.RunSpec(
        bench="async", fn=lambda: None, max_retries=2)))
    assert res.status == "failed" and res.failure_class == cls
    assert res.attempts == attempts
    assert type(error).__name__ in res.detail


def test_out_of_memory_is_a_retried_resource_failure(no_fault, tmp_path):
    """``torch.cuda.OutOfMemoryError`` classifies as ``resource`` (its
    message holds "out of memory") and burns the retry budget; only its
    string is kept; the sibling after it completes."""
    def oom():
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 160.00 GiB")
    clock = VirtualClock()
    specs = [_spec(fn=oom, bench="oom", order=1),
             _spec(bench="after", order=2)]
    report = port.run_plan(port.expand(specs), root=tmp_path, clock=clock,
                           sleep=clock.sleep, backoff_base_s=0.05,
                           backoff_cap_s=0.15)
    oom_row, after = report.jobs
    assert oom_row["status"] == "failed"
    assert oom_row["failure_class"] == "resource"
    assert oom_row["attempts"] == 3 and oom_row["retries"] == 2
    assert oom_row["backoffs"] == [0.05, 0.1]
    assert oom_row["detail"].startswith("OutOfMemoryError: CUDA out of memory")
    assert after["status"] == "completed"
    assert report.counters == {**report.counters, "completed": 1,
                               "failed": 1, "retries": 2}


@pytest.mark.parametrize("topo,want", [("local-cpu", "cpu"),
                                       ("local-cuda", "cuda")])
def test_device_parameter_gets_the_topology_backend(no_fault, card, topo,
                                                    want):
    got = {}

    def fn(device, n):
        got.update(device=device, n=n)

    def fn_kw(**kw):
        got.update(kw=kw)

    spec = port.RunSpec(bench="dev", fn=fn, params={"n": 5},
                        topologies=port.TOPOLOGIES[topo])
    job = _one_job(port, spec)
    assert job.call_kwargs(fn) == {"device": want, "n": 5}
    assert job.call_kwargs(fn_kw) == {"n": 5}
    assert _local(port, VirtualClock()).run(job).status == "completed"
    assert got == {"device": want, "n": 5}


def test_routing_runs_one_host_topologies_in_process(no_fault, card,
                                                     tmp_path):
    """``local-cuda`` and ``local-cpu`` run in-process; ``h100-pod`` and
    ``h100-2pod`` emit manifests (the reference runs only ``cpu`` in
    process)."""
    calls = []
    specs = [port.RunSpec(bench=f"t-{name}", fn=lambda: calls.append(1),
                          topologies=t, order=i)
             for i, (name, t) in enumerate(sorted(port.TOPOLOGIES.items()))]
    clock = VirtualClock()
    report = port.run_plan(port.expand(specs), root=tmp_path,
                           run_dir=tmp_path / "run", clock=clock,
                           sleep=clock.sleep)
    by = {j["bench"]: (j["status"], j["executor"]) for j in report.jobs}
    assert by == {"t-h100-2pod": ("emitted", "manifest"),
                  "t-h100-pod": ("emitted", "manifest"),
                  "t-local-cpu": ("completed", "local"),
                  "t-local-cuda": ("completed", "local")}
    assert len(calls) == 2 and card["syncs"] == 1
    assert not ref.TOPOLOGIES["tpu-pod"].is_local()


# --- discovery and the CLI ---------------------------------------------------

def _scratch_benches(tmp_path, monkeypatch, name):
    """A ``benchmarks``-like namespace package ``name``: one
    ``bench_torch_x`` module registering a spec, and a ``bench_ref`` module
    that records it was imported (it must not be)."""
    pkg = tmp_path / name
    pkg.mkdir()
    (pkg / "bench_torch_x.py").write_text(textwrap.dedent("""
        import pathlib
        from repro_torch.harness import LOCAL_TOPOLOGY, TOPOLOGIES, RunSpec
        from repro_torch.harness.registry import register_bench

        def main(device):
            pathlib.Path("ran-x").write_text(device)

        register_bench(RunSpec(bench="x", module=__name__, smoke=True,
                               topologies=(TOPOLOGIES["local-cpu"],)))
    """))
    (pkg / "bench_ref.py").write_text(
        "raise ImportError('a reference bench module was imported')\n")
    (pkg / "helper.py").write_text("X = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    return pkg


def test_cli_lists_and_runs_only_bench_torch_modules(no_fault, tmp_path,
                                                     monkeypatch, capsys,
                                                     scratch_registry):
    name = f"scratch_benches_{os.getpid()}"
    _scratch_benches(tmp_path, monkeypatch, name)
    assert cli.main(["--list"], package=name, root=tmp_path) == 0
    out = capsys.readouterr().out
    assert out.splitlines() == [
        "x  smoke=True  artifact=-  topologies=cpu:1"]
    assert f"{name}.bench_torch_x" in sys.modules
    assert f"{name}.bench_ref" not in sys.modules
    assert f"{name}.helper" not in sys.modules
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--smoke"], package=name, root=tmp_path) == 0
    assert (tmp_path / "ran-x").read_text() == "cpu"
    (run_dir,) = (tmp_path / "results" / "harness").iterdir()
    rep = json.loads((run_dir / "harness_report.json").read_text())
    assert rep["counters"]["completed"] == 1 and rep["exit_code"] == 0
    assert cli.main(["--executor", "manifest", "--topology", "h100-pod",
                     "--run-dir", str(tmp_path / "m")], package=name,
                    root=tmp_path) == 0
    manifest = json.loads((tmp_path / "m" / "manifests" /
                           "x--h100-pod.manifest.json").read_text())
    assert manifest["spec"]["parallelism"] == 32
    assert cli.main(["--bench", "typo"], package=name, root=tmp_path) == 2


def test_cli_prefix_is_a_keyword(no_fault, tmp_path, monkeypatch, capsys,
                                 scratch_registry):
    name = f"scratch_prefix_{os.getpid()}"
    _scratch_benches(tmp_path, monkeypatch, name)
    assert cli.main(["--list"], package=name, prefix="none_",
                    root=tmp_path) == 0
    assert capsys.readouterr().out == ""
    assert registry.discover(name, prefix="bench_torch_")[0].bench == "x"


@pytest.mark.parametrize("argv", [["--check"], ["--check", "--bench", "x"]])
def test_cli_check_requires_smoke(argv):
    assert cli.main(argv) == 2


def test_cli_parser_names_the_port():
    p = cli._parser()
    assert p.prog == "repro_torch.harness"
    topo = next(a for a in p._actions if a.dest == "topology")
    assert sorted(topo.choices) == ["h100-2pod", "h100-pod", "local-cpu",
                                    "local-cuda"]


def test_discover_imports_no_reference_bench(scratch_registry):
    """The repo's ``benchmarks`` namespace holds the reference's
    ``bench_*`` modules, each importing JAX: the port's discovery imports
    none of them."""
    before = {m for m in sys.modules if m.startswith("benchmarks.")}
    specs = registry.discover("benchmarks")
    new = {m for m in sys.modules if m.startswith("benchmarks.")} - before
    assert all(m.startswith("benchmarks.bench_torch_") for m in new), new
    assert all(isinstance(s, port.RunSpec) for s in specs)


def _python(code):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env={"PYTHONPATH": "src:.", "PATH": "/usr/bin:/bin"},
        timeout=120)


def test_harness_imports_no_jax_and_nothing_of_the_reference():
    run = _python(
        "import sys, repro_torch.harness, repro_torch.harness.cli;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')];"
        "assert not bad, bad")
    assert run.returncode == 0, run.stderr


def test_spec_layer_is_pure_data():
    """Importing the package, plan expansion, the baseline rules and
    manifest emission import no torch."""
    run = _python(
        "import sys, tempfile, repro_torch.harness as h;"
        "job = h.expand([h.RunSpec(bench='b', module='m', "
        "topologies=h.TOPOLOGIES['h100-pod'])]).jobs[0];"
        "h.job_manifest(job);"
        "h.ManifestExecutor(run_dir=tempfile.mkdtemp()).run(job);"
        "h.check_artifact('a', 'cuda:1', None, None);"
        "assert 'torch' not in sys.modules, 'torch imported'")
    assert run.returncode == 0, run.stderr


def test_cli_lists_on_a_machine_without_jax():
    """``python -m repro_torch.harness --list`` with JAX and the reference
    unimportable: exit 0."""
    run = _python(
        "import runpy, sys; sys.modules['jax'] = None; "
        "sys.modules['repro'] = None; sys.argv = ['x', '--list']; "
        "runpy.run_module('repro_torch.harness', run_name='__main__')")
    assert run.returncode == 0, run.stderr
    run = _python(
        "import runpy, sys; sys.modules['jax'] = None; "
        "sys.modules['repro'] = None; sys.argv = ['x', '--check']; "
        "runpy.run_module('repro_torch.harness', run_name='__main__')")
    assert run.returncode == 2 and "--check requires --smoke" in run.stderr
