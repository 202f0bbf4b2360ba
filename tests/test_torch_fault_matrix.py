"""The fault matrix of ``tests/test_fault_matrix.py`` for the port, over the
same eight smoke specs, with the fault site a parameter: ``REPRO_FAULT`` is
set per case (none, ``pack``, ``kernel_compile``, ``kernel_run``, every
hit) through ``monkeypatch``, so the tier-1 run, which arms nothing, runs
every site.

For each spec and site: env / auto dispatch completes; the walk of the
chain recorded in the health registry is the reference's (a kernel site
leaves only the reference lowering standing, ``pack`` a lowering that does
not pack, no fault none); the output is bitwise what the surviving
lowering gives when named with every fault disarmed; and it agrees with
the JAX package under the same fault on the same numpy inputs (both at
their surviving lowerings: under a kernel site the two reference
lowerings) within 1e-5 of max|want| in f32 and 1e-2 in bf16. With no fault
the golden dispatch is unchanged (CPU: dense ``torch_matmul``, grouped
``grouped_einsum``). The ``pack`` site sits only in the per-call packing
lowerings, which CPU auto dispatch never picks, so that site routes
dispatch through the env override (``tiling_packing_fused`` /
``grouped_packed``) in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ContractionSpec as RefSpec
from repro.core import contract as ref_contract
from repro.core import dispatch as ref_dispatch
from repro.core import health as ref_health
from repro.testing import faults as ref_faults
from repro_torch.core import contraction as ctr
from repro_torch.core import health
from repro_torch.core.contraction import ContractionSpec, dispatch
from repro_torch.core.gemm import contract
from repro_torch.testing import faults

SMOKE = [("dense", 64, 64, 64, "float32", False),
         ("dense", 256, 256, 256, "float32", False),
         ("dense", 256, 512, 1024, "bfloat16", False),
         ("dense", 8, 512, 1024, "bfloat16", False),
         ("grouped", 8, 64, 96, 256, "bfloat16", False),
         ("grouped", 8, 64, 256, 96, "bfloat16", True),
         ("grouped", 16, 64, 80, 128, "bfloat16", False),
         ("grouped", 16, 64, 128, 80, "bfloat16", True)]


def _spec(cls, row):
    if row[0] == "dense":
        return cls.dense(*row[1:5])
    return cls.grouped(*row[1:6], counts=row[6])


SMOKE_SPECS = [_spec(ContractionSpec, row) for row in SMOKE]
SITES = [None, "pack", "kernel_compile", "kernel_run"]
PACK_ROUTE = {"dense": "tiling_packing_fused", "grouped": "grouped_packed"}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PORT_ENV, REF_ENV = "REPRO_TORCH_GEMM_STRATEGY", "REPRO_GEMM_STRATEGY"


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    for var in (PORT_ENV, REF_ENV, "REPRO_GEMM_BACKEND", faults.ENV_FAULT,
                health.ENV_NUMERICS_GUARD):
        monkeypatch.delenv(var, raising=False)
    for mod in (faults, ref_faults):
        mod.reset()
    for reg in (health, ref_health):
        reg.clear_health()
    yield
    for mod in (faults, ref_faults):
        mod.reset()
    for reg in (health, ref_health):
        reg.clear_health()


def _operands(spec, seed):
    """numpy operands of the spec: (a, w, counts-or-None)."""
    r = np.random.default_rng(seed)
    if spec.kind == "dense":
        return (r.normal(size=(spec.m, spec.k)),
                r.normal(size=(spec.k, spec.n)), None)
    return (r.normal(size=(spec.e, spec.m, spec.k)),
            r.normal(size=(spec.e, spec.k, spec.n)),
            r.integers(0, spec.m + 1, size=(spec.e,)) if spec.counts
            else None)


def _port(spec, a, w, counts):
    dt = getattr(torch, spec.dtype)
    return (torch.from_numpy(np.asarray(a, np.float32)).to(dt),
            torch.from_numpy(np.asarray(w, np.float32)).to(dt),
            None if counts is None
            else torch.from_numpy(counts).to(torch.int32))


def _ref(spec, a, w, counts):
    dt = jnp.dtype(spec.dtype)
    return (jnp.asarray(a, dt), jnp.asarray(w, dt),
            None if counts is None else jnp.asarray(counts, jnp.int32))


def _walk(records, spec, winner):
    """The lowering that produced the output: the recorded degradations of
    ``spec`` followed from the winner."""
    degr = {r.lowering: r.fallback for r in records
            if r.spec == spec.describe()}
    executed = winner
    while executed in degr:
        executed = degr[executed]
    return degr, executed


@pytest.mark.parametrize("site", SITES, ids=lambda s: s or "none")
@pytest.mark.parametrize("row", range(len(SMOKE)),
                         ids=[s.describe() for s in SMOKE_SPECS])
def test_fault_matrix_degradation_parity(row, site, monkeypatch):
    spec, ref_spec = SMOKE_SPECS[row], _spec(RefSpec, SMOKE[row])
    if site is not None:
        monkeypatch.setenv(faults.ENV_FAULT, site)
    if site == "pack":
        monkeypatch.setenv(PORT_ENV, PACK_ROUTE[spec.kind])
        monkeypatch.setenv(REF_ENV, PACK_ROUTE[spec.kind])
    winner = dispatch(spec).name
    np_ops = _operands(spec, seed=1000 + row)
    a, w, counts = _port(spec, *np_ops)

    faults.reset()
    out = contract(spec, a, w, counts=counts)
    degr, executed = _walk(health.HEALTH.records(), spec, winner)
    if site in ("kernel_compile", "kernel_run"):
        # every sited lowering fails: only the reference lowering survives
        assert degr, f"{site} fault never degraded {winner}"
        assert executed == ctr.REFERENCE_LOWERINGS[spec.kind]
        assert {r.cause for r in health.HEALTH.records()} == {
            faults.FAULT_SITES[site]}
    elif site == "pack":
        # the env-routed packing lowering fails; one that does not pack
        # survives
        assert degr, f"pack fault never degraded {winner}"
        assert executed not in degr and executed != winner
        assert executed not in ("tiling_packing", "tiling_packing_fused",
                                "grouped_packed", "grouped_packed_ragged")
    else:
        assert degr == {} and not health.HEALTH
        assert executed == winner

    # The same fault on the same inputs in the JAX package.
    ra, rw, rc = _ref(ref_spec, *np_ops)
    ref_faults.reset()
    want_ref = ref_contract(ref_spec, ra, rw, counts=rc)
    _, ref_executed = _walk(ref_health.HEALTH.records(), ref_spec,
                            ref_dispatch(ref_spec).name)
    if site in ("kernel_compile", "kernel_run"):
        assert ref_executed == {"dense": "jnp_ref",
                                "grouped": "grouped_jnp_ref"}[spec.kind]
    got = out.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want_ref, jnp.float32))
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= TOL[spec.dtype], (executed, ref_executed, err)

    # Parity: with every fault disarmed, naming the surviving lowering
    # reproduces the guarded output bitwise.
    with monkeypatch.context() as mp:
        mp.delenv(faults.ENV_FAULT, raising=False)
        mp.delenv(PORT_ENV, raising=False)
        faults.reset()
        again = contract(spec, a, w, counts=counts, strategy=executed)
    assert torch.equal(out, again)


@pytest.mark.parametrize("site", ["kernel_compile", "kernel_run"])
@pytest.mark.parametrize("row", [0, 4, 5],
                         ids=[SMOKE_SPECS[i].describe() for i in (0, 4, 5)])
def test_fault_matrix_explicit_strategy_raises(row, site, monkeypatch):
    """An explicit ``strategy=`` never degrades: the injected fault
    raises, and nothing is recorded."""
    spec = SMOKE_SPECS[row]
    a, w, counts = _port(spec, *_operands(spec, seed=2000 + row))
    monkeypatch.setenv(faults.ENV_FAULT, site)
    faults.reset()
    with pytest.raises(faults.InjectedFault):
        contract(spec, a, w, counts=counts, strategy=dispatch(spec).name)
    assert not health.HEALTH


def test_zero_fault_golden_dispatch_unchanged():
    """Without an armed fault the golden CPU dispatch is untouched: the
    guarded layer changes failure behaviour, not choices."""
    want = {"dense": "torch_matmul", "grouped": "grouped_einsum"}
    for spec in SMOKE_SPECS:
        assert dispatch(spec).name == want[spec.kind], spec.describe()
    assert ctr.dispatch_table(SMOKE_SPECS) == {
        s.describe(): want[s.kind] for s in SMOKE_SPECS}
    assert health.health_report() == {}
