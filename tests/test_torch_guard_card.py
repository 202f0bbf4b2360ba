"""Guarded dispatch on the card, without JAX (the machine with the card has
none): the checks of ``chip_smoke.py``'s phase 9 (a) and (b) at small
shapes, one case a test, on each body the served paths run: K1
``tc_stream`` (a packed bf16 weight at 4 rows) and ``wgmma`` (at 128
rows), K7 (the raw weight at 4 rows), K5 + K1 (the raw weight at 128 rows)
and K2 (a gate / up pair of packed expert stacks at C 8 with counts). For
each: with no fault the auto output is bitwise the named winner's, on the
body the case names, and nothing degrades; on the card the fallback chain
is the winner alone, so ``kernel_compile`` and ``kernel_run`` at every hit
make auto raise naming the spec and the winner, as the named winner
raises, and nothing is recorded; ``pack`` under the
``tiling_packing_fused`` override raises the same way; ``scale_grid`` on
an int8 packed weight under the numerics guard makes auto and the named
``packed_weight`` raise ``NumericsError``. Skips without a card (``cuda``
marker).

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_guard_card.py
"""
import pytest
import torch

import chip_smoke as cs
from repro_torch import models, serve
from repro_torch.core import contraction as ctr
from repro_torch.core import gemm, health, layered
from repro_torch.kernels import gemm_grouped as gg
from repro_torch.kernels import gemm_packed as gp
from repro_torch.kernels import gemm_tiled as gt
from repro_torch.kernels import pack as pk
from repro_torch.testing import faults

SMALL = dict(k=512, n=1024, rows=(4, 128), grouped=(4, 512, 1024, 8))
CASES = ["packed M=4 (K1 tc_stream)", "raw M=4 (K7)",
         "packed M=128 (K1 wgmma)", "raw M=128 (K5 + K1)",
         "grouped pair C=8 (K2)"]
MODULES = dict(ctr=ctr, faults=faults, health=health, gemm=gemm,
               layered=layered, models=models, serve=serve)


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for var in ("REPRO_TORCH_GEMM_STRATEGY", faults.ENV_FAULT,
                health.ENV_NUMERICS_GUARD):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    faults.reset()
    health.clear_health()
    yield
    health.clear_health()


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(len(CASES)), ids=CASES)
def test_cuda_guarded_dispatch_on_each_body(card, index):
    counters = cs.Counters([gp.gemm_packed_fused_a, gg.gemm_grouped_packed_ragged,
                            gg.gemm_grouped_packed, pk.pack_a, pk.pack_b,
                            pk.pack_b_grouped, gt.gemm_tiled])
    case = cs.guard_cases(torch, MODULES, "cuda", **SMALL)[index]
    walked = cs.guard_checks(torch, MODULES, counters, [case])
    ran = walked[case["label"]]
    winner = ctr.dispatch(case["spec"], on_card=True).name
    for site in cs.KERNEL_SITES:
        assert ran[site] == f"{winner} raised InjectedFault, naming the spec"
    assert ("pack" in ran) == case["raw"]
    assert not health.HEALTH


@pytest.mark.cuda
def test_cuda_scale_grid_under_the_numerics_guard(card):
    walked = cs.guard_scale_grid(torch, MODULES, k=SMALL["k"], n=SMALL["n"],
                                 rows=SMALL["rows"])
    assert all(v == {"scale_grid": "packed_weight raised NumericsError, "
                                   "naming the spec"}
               for v in walked.values()) and len(walked) == 2
    assert not health.HEALTH


def test_cases_name_the_bodies_the_routes_pick():
    """On the CPU: each case expects the body that the kernels' own route
    tables give its shapes (TMA-aligned bf16 operands, the planner's
    tiles), so the card test holds the guarded chain on each served body."""
    cases = cs.guard_cases(torch, MODULES, "cpu", **SMALL)
    assert [c["label"].split(" at ")[1] for c in cases] == [
        "M=4", "M=4", "M=128", "M=128", "C=8, counts"]
    bf16 = torch.bfloat16
    pw = next(c for c in cases if not c["raw"])["spec"].b_format
    plan = layered.plan_gemm(1024, SMALL["k"], SMALL["n"], "bfloat16")
    k1 = {m: gp.fused_a_body(bf16, pw, m, scaled=False, tma_ok=True)
          for m in SMALL["rows"]}
    want = [{"gemm_packed_fused_a": {k1[4]: 1}},
            {"gemm_tiled": {gt.tiled_body(bf16, 4, True): 1}},
            {"gemm_packed_fused_a": {k1[128]: 1}},
            {"pack_b": {"tma_copy": 1},
             "gemm_packed_fused_a": {gp.fused_a_body(
                 bf16, plan.b_format, 128, scaled=False, tma_ok=True): 1}},
            {"gemm_grouped_packed_ragged": {gg.grouped_body(
                bf16, cases[-1]["spec"].b_format, 8, scaled=False,
                tma_ok=True): 1}}]
    assert [c["bodies"] for c in cases] == want
    assert [k1[4], k1[128]] == ["tc_stream", "wgmma"]
    assert [c["raw"] for c in cases] == [False, True, False, True, False]
