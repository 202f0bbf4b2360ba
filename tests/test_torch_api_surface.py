"""API-surface snapshot of the port's ``repro_torch.core``, without JAX (it
runs on the card's machine too): the exported ``__all__``, the facades'
parameter names, the spec fields and the registered lowering names, each
beside the reference's (``tests/test_api_surface.py``) with the port's
documented differences:

- the library proxy ``xla`` is ``torch_matmul``, the reference lowerings
  ``jnp_ref`` / ``grouped_jnp_ref`` are ``torch_ref`` / ``grouped_torch_ref``;
- no facade takes ``backend=``: the operands' device decides, and
  ``dispatch`` / ``resolve_strategy`` take ``on_card`` in its place;
- the planner has no TPU knobs (``vmem_budget``, ``double_buffer``,
  ``layout_a``);
- ``resolve_grouped_strategy`` is exported too.

A change here is an API change: update the snapshot in the same change.
The last test imports the reference and checks the two surfaces differ by
exactly the differences stated here (it skips where JAX is not installed).
"""
import dataclasses
import inspect

import pytest
import torch

import repro_torch.core as core
from repro_torch.core import LOWERINGS, ContractionSpec, EpilogueSpec

EXPECTED_ALL = {
    # declarative surface
    "ContractionSpec", "EpilogueSpec", "EPILOGUE_SPECS", "as_epilogue_spec",
    "contract", "dispatch", "dispatch_table",
    # capability registry
    "Lowering", "LOWERINGS", "register_lowering", "lowerings_for",
    "weight_kind", "is_packed", "as_compute_weight",
    # facades + packed weights
    "matmul", "linear", "grouped_linear", "grouped_silu_gate",
    "PackedWeight", "GroupedPackedWeight", "LayeredGemm",
    # planner
    "GemmPlan", "plan_gemm", "plan_grouped_gemm", "choose_strategy",
    "choose_grouped_strategy", "should_pack",
    # formats
    "TileFormat", "ScaleSpec", "as_tile_format",
    # registry views
    "STRATEGIES", "GROUPED_STRATEGIES", "run_strategy",
    "run_grouped_strategy", "default_backend", "resolve_strategy",
    "resolve_grouped_strategy",
}
PORT_ONLY_NAMES = {"resolve_grouped_strategy"}

EXPECTED_PARAMS = {
    "matmul": ("a", "b", "c", "alpha", "beta", "strategy", "plan",
               "out_dtype", "bias", "epilogue"),
    "linear": ("x", "w", "bias", "strategy", "plan", "out_dtype", "accum",
               "epilogue"),
    "grouped_linear": ("x", "w", "bias", "counts", "occupancy", "strategy",
                       "out_dtype", "epilogue"),
    "grouped_silu_gate": ("x", "wg", "wu", "counts", "occupancy", "strategy",
                          "out_dtype"),
    "contract": ("spec", "a", "w", "w2", "c", "bias", "counts", "alpha",
                 "beta", "strategy", "plan"),
    "dispatch": ("spec", "strategy", "on_card"),
    "resolve_strategy": ("m", "k", "n", "dtype", "strategy", "on_card"),
    "plan_gemm": ("m", "k", "n", "dtype", "b_dtype", "target", "layout_b",
                  "scale_granularity"),
    "plan_grouped_gemm": ("e", "m", "k", "n", "dtype", "b_dtype", "target",
                          "n_b_streams", "layout_b", "scale_granularity"),
}
# parameter -> the functions of the port that add it / the reference's that
# the port drops
PORT_ONLY_PARAMS = {"on_card": ("dispatch", "resolve_strategy")}
REFERENCE_ONLY_PARAMS = {
    "backend": ("matmul", "linear", "grouped_linear", "grouped_silu_gate",
                "contract"),
    "vmem_budget": ("plan_gemm",),
    "double_buffer": ("plan_gemm", "plan_grouped_gemm"),
    "layout_a": ("plan_gemm",),
}

EXPECTED_SPEC_FIELDS = ("kind", "m", "k", "n", "e", "dtype", "out_dtype",
                        "weight", "b_format", "counts", "occupancy", "accum",
                        "epilogue")
EXPECTED_EPILOGUE_FIELDS = ("bias", "activation", "gate_mul")
EXPECTED_LAYERED_FIELDS = ("m", "k", "n", "dtype", "strategy", "epilogue",
                           "plan")

EXPECTED_LOWERINGS = {
    "dense": {"naive", "pluto", "intrinsic", "tiling", "tiling_packing",
              "tiling_packing_fused", "vsx", "torch_matmul", "packed_weight",
              "torch_ref"},
    "grouped": {"grouped_einsum", "grouped_packed", "grouped_packed_ragged",
                "grouped_packed_weight", "grouped_torch_ref"},
}
# reference lowering name -> the port's
RENAMES = {"xla": "torch_matmul", "jnp_ref": "torch_ref",
           "grouped_jnp_ref": "grouped_torch_ref"}


def _params(mod, name):
    return tuple(inspect.signature(getattr(mod, name)).parameters)


def test_public_all_is_stable():
    assert set(core.__all__) == EXPECTED_ALL
    for name in core.__all__:
        assert getattr(core, name) is not None, name


def test_facade_parameter_names_are_stable():
    assert {n: _params(core, n) for n in EXPECTED_PARAMS} == EXPECTED_PARAMS
    for name in ("matmul", "linear", "grouped_linear", "grouped_silu_gate",
                 "contract"):
        assert "backend" not in _params(core, name)


def test_spec_and_layered_fields_are_stable():
    def fields(cls):
        return tuple(f.name for f in dataclasses.fields(cls))
    assert fields(ContractionSpec) == EXPECTED_SPEC_FIELDS
    assert fields(EpilogueSpec) == EXPECTED_EPILOGUE_FIELDS
    assert fields(core.LayeredGemm) == EXPECTED_LAYERED_FIELDS


def test_registered_lowering_names_are_stable():
    got = {kind: {n for n, lw in LOWERINGS.items() if lw.kind == kind}
           for kind in ("dense", "grouped")}
    assert got == EXPECTED_LOWERINGS
    assert set(RENAMES.values()) <= got["dense"] | got["grouped"]
    assert not set(RENAMES) & (got["dense"] | got["grouped"])


def test_default_backend_is_informational():
    """It names the device kind; dispatch reads the operands' device."""
    assert core.default_backend() == ("cuda" if torch.cuda.is_available()
                                      else "cpu")
    assert "backend" not in _params(core, "dispatch")


def test_the_reference_surface_differs_by_the_stated_differences():
    """Against ``repro.core`` itself: the same ``__all__`` but for the
    port's extra export, the same parameters but for the stated ones, the
    same fields and the same lowerings under the stated renames."""
    ref = pytest.importorskip("repro.core")
    assert set(ref.__all__) == EXPECTED_ALL - PORT_ONLY_NAMES
    assert set(ref.__all__) <= set(core.__all__)
    for name in EXPECTED_PARAMS:
        want = [p for p in _params(ref, name)
                if name not in REFERENCE_ONLY_PARAMS.get(p, ())]
        got = [p for p in _params(core, name)
               if name not in PORT_ONLY_PARAMS.get(p, ())]
        assert got == want, name
    assert tuple(f.name for f in dataclasses.fields(ref.ContractionSpec)) \
        == EXPECTED_SPEC_FIELDS
    assert tuple(f.name for f in dataclasses.fields(ref.LayeredGemm)) == \
        EXPECTED_LAYERED_FIELDS[:5] + ("backend",) + EXPECTED_LAYERED_FIELDS[5:]
    for kind in ("dense", "grouped"):
        names = {RENAMES.get(n, n) for n, lw in ref.LOWERINGS.items()
                 if lw.kind == kind}
        assert names == EXPECTED_LOWERINGS[kind]
