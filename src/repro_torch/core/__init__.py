"""Dense-GEMM core of the port: the tile format (``tile_format``), the
Hopper planner (``planner``), the declarative dispatch surface
(``contraction``, ``epilogue``, ``gemm``) and load-time-packed weights
(``layered``). Import from the submodules: the kernels below import the
format and dtype modules, so this package imports nothing eagerly."""
