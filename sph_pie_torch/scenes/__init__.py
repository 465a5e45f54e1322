from sph_pie_torch.scenes.builders import (
    Scene,
    dam_break_2d,
    dam_break_3d,
    dam_break_3d_periodic,
    emitter_2d,
    lattice_block,
)
from sph_pie_torch.scenes import emitter, obstacles
