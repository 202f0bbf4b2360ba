"""Port vs reference: the assigned input shapes and the (arch x shape) cell
grid. The port keeps its own copy of ``repro.configs.shapes`` (it imports
nothing of the reference); the copy must say the same thing."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes


def test_shape_table_equal():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, shape in tshapes.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jshapes.SHAPES[name])
    assert tconfigs.SHAPES is tshapes.SHAPES


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cells_and_skips_equal(arch):
    tcells = [(c.name, s.name, skip) for c, s, skip in
              tshapes.iter_cells([tconfigs.get_config(arch)])]
    jcells = [(c.name, s.name, skip) for c, s, skip in
              jshapes.iter_cells([jconfigs.get_config(arch)])]
    assert tcells == jcells
