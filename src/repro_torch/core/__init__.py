"""Dense-GEMM core of the port: the tile format (``tile_format``), the
Hopper planner (``planner``), the declarative dispatch surface
(``contraction``, ``epilogue``, ``gemm``), the paper's lowering strategies
(``strategy``) and load-time-packed weights (``layered``).

The public names below are all of the reference package's (``repro.core``)
and ``resolve_grouped_strategy``. They resolve on first use: the kernels
import the format and dtype modules of this package, so importing it must
not import the dispatch surface (which imports the kernels) eagerly.
"""
import importlib

_EXPORTS = {
    "contraction": ("ContractionSpec", "Lowering", "LOWERINGS",
                    "as_compute_weight", "default_backend", "dispatch",
                    "dispatch_table", "is_packed", "lowerings_for",
                    "register_lowering", "weight_kind"),
    "epilogue": ("EPILOGUE_SPECS", "EpilogueSpec", "as_epilogue_spec"),
    "gemm": ("contract", "grouped_linear", "grouped_silu_gate", "linear",
             "matmul", "resolve_strategy", "resolve_grouped_strategy",
             "run_strategy", "run_grouped_strategy"),
    "layered": ("GroupedPackedWeight", "LayeredGemm", "PackedWeight"),
    "planner": ("GemmPlan", "choose_grouped_strategy", "choose_strategy",
                "plan_gemm", "plan_grouped_gemm", "should_pack"),
    "strategy": ("GROUPED_STRATEGIES", "STRATEGIES"),
    "tile_format": ("ScaleSpec", "TileFormat", "as_tile_format"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
