"""Typed configuration, copied from ``pctpu/config.py`` (the same frozen
dataclasses and reference defaults): sensor presets
(reference/src/Utility.cpp:92-124), ground marking and the two uint8 BEVs
(reference/BatchMultiBevGen.cpp:119-373), the float BEV of the two
cloud_manip tools, the registration tools
(reference/BatchTopPartRegistration.cpp:90-147, 199-239,
reference/BatchWholeRegistration.cpp:311-418) and keyframe selection."""

from __future__ import annotations

import dataclasses
import enum
import math


class SensorType(enum.Enum):
    """Sensor identifiers (reference/include/Utility.h:22-28)."""

    HDL_32E = "HDL_32E"
    HDL_64E = "HDL_64E"
    OS1_64 = "OS1_64"


@dataclasses.dataclass(frozen=True)
class SensorParams:
    """Cylindrical-projection constants for one LiDAR model
    (reference/include/Utility.h:30-36)."""

    n_scan: int
    horizon_scan: int
    ground_upper_scan: int
    height_res: float

    @property
    def grid_size(self) -> int:
        """Number of cells in the dense (n_scan, horizon_scan) range image."""
        return self.n_scan * self.horizon_scan


_SENSOR_PRESETS = {
    SensorType.HDL_32E: SensorParams(
        n_scan=32, horizon_scan=1056, ground_upper_scan=20, height_res=0.5
    ),
    SensorType.HDL_64E: SensorParams(
        n_scan=64, horizon_scan=2083, ground_upper_scan=50, height_res=0.25
    ),
    SensorType.OS1_64: SensorParams(
        n_scan=64, horizon_scan=1024, ground_upper_scan=31, height_res=1.0
    ),
}


def parse_sensor_type(sensor_str: str) -> SensorType:
    """Parse an argv sensor string by substring match, like the reference
    (reference/src/Utility.cpp:72-89)."""
    for sensor in (SensorType.HDL_32E, SensorType.HDL_64E, SensorType.OS1_64):
        if sensor.value in sensor_str:
            return sensor
    raise ValueError(f"Unknown sensor type: {sensor_str}!")


def get_sensor_params(sensor: SensorType | str) -> SensorParams:
    if isinstance(sensor, str):
        sensor = parse_sensor_type(sensor)
    return _SENSOR_PRESETS[sensor]


@dataclasses.dataclass(frozen=True)
class GroundConfig:
    """Ground-marking constants (reference/BatchMultiBevGen.cpp:119-252):
    the ±``slope_deg`` slope test, the ``grid_rows x grid_cols`` grid of
    ``cell_size`` metre sectors offset by (``offset_x``, ``offset_y``) whose
    average ground heights start from the ``count_epsilon`` count, and the
    ``rooftop_margin`` veto against any 4-neighbour sector's average."""

    slope_deg: float = 10.0
    grid_rows: int = 75
    grid_cols: int = 50
    cell_size: float = 2.0
    offset_x: float = 75.0
    offset_y: float = 50.0
    count_epsilon: float = 0.01
    rooftop_margin: float = 0.30

    def __post_init__(self):
        # the f32-add + f32-divide sector index (ops/ground.py) equals the
        # C++'s f64 division only for power-of-two cell sizes
        if not (self.cell_size > 0 and math.log2(self.cell_size).is_integer()):
            raise ValueError(
                "GroundConfig.cell_size must be a power of two: the "
                "reference's f32/f64 grid-index identity (and the C++ "
                "constant 2.0) only hold for power-of-two cells"
            )


@dataclasses.dataclass(frozen=True)
class MultiBevConfig:
    """Multi-layer occupancy BEV (reference/BatchMultiBevGen.cpp:261-321)."""

    max_range: float = 112.0
    interval: float = 1.0
    num_layers: int = 24
    lidar_to_ground_height: float = 2.0  # in *layer* units (cpp :281)

    @property
    def mat_size(self) -> int:
        return int(self.max_range * 2 / self.interval)


@dataclasses.dataclass(frozen=True)
class SingleBevConfig:
    """Single-layer uint8 height BEV (reference/BatchMultiBevGen.cpp:331-373)."""

    max_range: float = 112.0
    interval: float = 1.0
    lidar_to_ground_height: float = 2.0  # metres here (cpp :345)
    height_scale: float = 4.0

    def __post_init__(self):
        # the C++ multiplies by the double constant 4.0; the all-f32 chain in
        # ops/bev.py is bit-exact only for power-of-two scales
        if not (self.height_scale > 0
                and math.log2(self.height_scale).is_integer()):
            raise ValueError(
                "SingleBevConfig.height_scale must be a power of two for the "
                "reference's f32/f64 height identity (the C++ hardcodes 4.0)"
            )

    @property
    def mat_size(self) -> int:
        return int(self.max_range * 2 / self.interval)


@dataclasses.dataclass(frozen=True)
class FloatBevConfig:
    """Float max-height BEV used by cloud_manip / batch_cloud_manip
    (reference/CloudManip.cpp:79-109, BatchCloudManip.cpp:201-239).

    MAT_SIZE = MAX_RANGE*2/interval + 1 (note the +1, unlike the uint8 BEVs).
    ``filter_ground``: BatchCloudManip skips label==0 points
    (BatchCloudManip.cpp:218) while CloudManip does not (CloudManip.cpp:88).
    """

    max_range: float = 100.0
    interval: float = 1.0
    lidar_to_ground_height: float = 2.0
    filter_ground: bool = True

    @property
    def mat_size(self) -> int:
        return int(self.max_range * 2 / self.interval) + 1


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


@dataclasses.dataclass(frozen=True)
class SelectConfig:
    """Keyframe / major-frame selection intervals
    (reference/KittiPointCloudSelect.cpp:57, BatchMultiBevGen.cpp:502-566)."""

    keyframe_interval: float = 2.0
    major_frame_interval: float = 20.0
    label_weight_epsilon: float = 1e-5
