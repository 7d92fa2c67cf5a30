"""A classifier cell built in memory, named by no file of the benchmark:
the WISKI Dirichlet classifier of the reference code's
``config/model/wiski_gpd.yaml`` (grid 16, grid_bound 1, alpha_eps 0.01,
two classes) on the ``absorb-4096`` mix with ``classes: 2``, measured as
``grid16-absorb`` is. Every piece is data: the configuration is
``wiski-grid16``'s with ``num_outputs``, ``alpha_eps``, the classifier's
factory and no second noise; the mix adds one stream key."""

import copy

from gpbench import spec


def classifier_cell(limits: dict, grid: int = 16, pool: int = None) -> spec.Cell:
    """The cell, with ``limits`` for the numbers ``correct`` compares, at
    ``grid`` points a dimension and, where given, a pool of ``pool``
    points."""
    base = spec.load_cell("grid16-absorb")
    config = copy.deepcopy(base.config)
    config.update(name="wiski-gpd", num_outputs=2, alpha_eps=0.01, inducing_points=grid ** config["input_dim"],
                  likelihood="Dirichlet targets and noises of the labels (Milios et al. 2018), no second noise")
    config["wrapper"].update(factory="online_ski_classifier", grid_size=grid)
    del config["hyper_ranges"]["noise"]
    mix = copy.deepcopy(base.mix)
    mix["stream"]["classes"] = 2
    if pool is not None:
        mix["pool_points"] = pool
    return base._replace(name="wiski-gpd-absorb", config=config, mix=mix, limits=limits)
