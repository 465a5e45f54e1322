from sph_pie_torch.scenes.builders import (
    Scene,
    dam_break_2d,
    dam_break_3d,
    lattice_block,
)
