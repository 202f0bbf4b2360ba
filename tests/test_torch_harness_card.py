"""The port's harness on the card, without JAX (the machine with the card
has none; ``tests/test_torch_harness.py`` holds ``repro_torch.harness`` to
the JAX package's harness on the CPU).

  * a ``local-cuda`` job that launches K1 (``gemm_packed_fused_a``) N times
    and returns without waiting: its ``duration_s`` is at least the CUDA
    events' time of those launches (the executor synchronises the card
    inside the attempt's clock);
  * a job that asks for twice the card's memory is retried, then fails as
    ``resource``; the K1 job after it completes;
  * ``harness_job`` injected at the first attempt: the retry converges and
    K1 ran once (the failed attempt failed before its callable).

Every test is ``cuda``: it skips without a card.
"""
import pytest
import torch

from repro_torch import harness
from repro_torch.core import health
from repro_torch.core.tile_format import TileFormat
from repro_torch.kernels import gemm_packed as gp
from repro_torch.kernels import pack as pk
from repro_torch.testing import faults

pytestmark = pytest.mark.cuda

M = K = N = 4096
CALLS = 40


@pytest.fixture(autouse=True)
def _card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.delenv(faults.ENV_FAULT, raising=False)
    faults.reset()
    health.clear_health()
    yield
    faults.reset()
    assert not health.HEALTH


def _k1_operands():
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device="cuda")
         * K ** -0.5).to(torch.bfloat16)
    fmt = TileFormat(bk=128, bn=64, layout="row", dtype="bfloat16")
    return a, pk.pack_b(w, fmt), fmt


def _k1_job(state, calls=CALLS):
    """Launch K1 ``calls`` times between two CUDA events; return without
    synchronising."""
    a, bp, fmt = _k1_operands()
    torch.cuda.synchronize()

    def job(device):
        assert device == "cuda"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = gp.gemm_packed_fused_a.launches
        start.record()
        for _ in range(calls):
            state["out"] = gp.gemm_packed_fused_a(a, bp, N, b_format=fmt)
        end.record()
        state.update(start=start, end=end,
                     launches=gp.gemm_packed_fused_a.launches - before)
    return job, (a, bp, fmt)


def _run(specs, tmp_path, **kw):
    return harness.run_plan(harness.expand(specs), root=tmp_path,
                            run_dir=tmp_path / "run", **kw)


def test_duration_counts_the_k1_launches_it_queued(tmp_path):
    state = {}
    job, (a, bp, fmt) = _k1_job(state)
    report = _run([harness.RunSpec(bench="k1", fn=job, max_retries=0)],
                  tmp_path)
    (row,) = report.jobs
    assert row["status"] == "completed" and row["topology"] == "cuda:1"
    assert state["launches"] == CALLS
    events_ms = state["start"].elapsed_time(state["end"])
    print(f"duration_s {row['duration_s']:.4f} against the events' "
          f"{events_ms / 1e3:.4f} s over {CALLS} K1 launches")
    assert row["duration_s"] >= events_ms / 1e3
    want = gp.gemm_packed_fused_a_plain(a[:64], bp, N, b_format=fmt)
    torch.testing.assert_close(state["out"][:64].float(), want.float(),
                               rtol=2e-2, atol=1e-3)


def test_out_of_memory_retries_then_fails_as_resource(tmp_path):
    total = torch.cuda.get_device_properties(0).total_memory
    calls = []

    def greedy():
        calls.append(1)
        try:
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        finally:
            torch.cuda.empty_cache()

    state = {}
    job, _ = _k1_job(state, calls=2)
    report = _run([harness.RunSpec(bench="greedy", fn=greedy, order=1,
                                   max_retries=2),
                   harness.RunSpec(bench="k1-after", fn=job, order=2)],
                  tmp_path, backoff_base_s=0.01, backoff_cap_s=0.02)
    oom, after = report.jobs
    assert oom["status"] == "failed" and oom["failure_class"] == "resource"
    assert oom["attempts"] == 3 and oom["retries"] == 2 and len(calls) == 3
    assert "out of memory" in oom["detail"].lower()
    assert after["status"] == "completed" and state["launches"] == 2
    assert report.counters["completed"] == 1
    assert report.counters["failed"] == 1
    assert report.health == {}


def test_injected_fault_retry_converges_on_the_card(tmp_path):
    state = {}
    job, _ = _k1_job(state, calls=1)
    with faults.inject("harness_job", nth=1):
        report = _run([harness.RunSpec(bench="flaky", fn=job)], tmp_path,
                      backoff_base_s=0.01)
    (row,) = report.jobs
    assert row["status"] == "completed"
    assert row["attempts"] == 2 and row["retries"] == 1
    assert row["backoffs"] == [0.01]
    assert state["launches"] == 1
    assert report.counters["retries"] == 1 and report.exit_code == 0
