"""Typed configuration of the registration tools, copied from
``pctpu/config.py`` (the same frozen dataclasses and reference defaults:
reference/BatchTopPartRegistration.cpp:90-147, 199-239,
reference/BatchWholeRegistration.cpp:311-418)."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class TopFlattenConfig:
    """Top-part extraction (reference/BatchTopPartRegistration.cpp:90-147)."""

    num_grid_x: int = 10
    num_grid_y: int = 10
    max_radius_x: float = 100.0
    max_radius_y: float = 100.0
    min_grid_points: int = 20
    top_fraction: float = 0.2

    @property
    def grid_res_x(self) -> float:
        return 2.0 * self.max_radius_x / self.num_grid_x

    @property
    def grid_res_y(self) -> float:
        return 2.0 * self.max_radius_y / self.num_grid_y


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """Parameters for one ICP stage.  PCL leaves transformation_epsilon = 0
    and euclidean_fitness_epsilon = -inf by default, in which case only
    max_iterations terminates the loop."""

    max_correspondence_distance: float
    max_iterations: int
    transformation_epsilon: float = 0.0
    euclidean_fitness_epsilon: float = -math.inf
    point_to_plane: bool = False


COARSE_ICP = IcpConfig(
    max_correspondence_distance=10.0, max_iterations=10, point_to_plane=True
)
FINE_ICP = IcpConfig(
    max_correspondence_distance=1.0,
    max_iterations=100,
    transformation_epsilon=1e-6,
    euclidean_fitness_epsilon=0.01,
)
# batch_whole_registration's direct 3-D ICP (pctpu/config.py:214-219)
WHOLE_ICP = IcpConfig(
    max_correspondence_distance=4.0,
    max_iterations=200,
    transformation_epsilon=1e-6,
    euclidean_fitness_epsilon=0.001,
)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Two-stage registration config
    (reference/BatchTopPartRegistration.cpp:311-541)."""

    voxel_leaf: float = 0.2
    normal_radius: float = 2.0
    coarse: IcpConfig = COARSE_ICP
    fine: IcpConfig = FINE_ICP
    failure_fitness: float = 1.5
    use_refinement: bool = True


def registration_config_from(d: dict) -> RegistrationConfig:
    """Build the port's config from ``dataclasses.asdict`` of pctpu's
    ``RegistrationConfig`` (how tests feed both packages one config)."""
    d = dict(d)
    d["coarse"] = IcpConfig(**d["coarse"])
    d["fine"] = IcpConfig(**d["fine"])
    return RegistrationConfig(**d)
