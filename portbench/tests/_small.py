"""Tiny sizes of the cells for CPU runs of the harness."""

SMALL = {
    "cornell-1080p.train": {"width": 32, "height": 18},
    "cornell-1080p.render": {"width": 32, "height": 18, "spp": 2,
                             "check": {"check_pixels": 96}},
    "terrain-textured-720.blocks": {"width": 24, "height": 24, "spp": 2,
                                    "stage": {"grid": 40},
                                    "check": {"check_pixels": 96}},
    "terrain-textured-720.bvh": {"width": 24, "height": 24, "spp": 2,
                                 "stage": {"grid": 40},
                                 "check": {"check_pixels": 96}},
}


def small(cell):
    """A copy of the cell's tiny overrides."""
    import copy
    return copy.deepcopy(SMALL[cell])
