"""pctpu_torch — the PyTorch/CUDA port of pctpu for NVIDIA Hopper.

The JAX package ``pctpu`` is the reference; this package mirrors its layout
and names (``pctpu_torch.ops.icp`` ↔ ``pctpu.ops.icp`` and so on) and
imports neither ``pctpu`` nor ``jax``: the pure-numpy host code it needs
(PCD I/O, the SE(3) report arithmetic, configuration) is carried over.

Layers:
  pctpu_torch.cloud / .config   data model + typed configuration
  pctpu_torch.geom              host-side SE(3) arithmetic (reports, poses)
  pctpu_torch.io                PCD, PNG, CSV and pose files
  pctpu_torch.ops               torch ops + the hand-written CUDA kernels
  pctpu_torch.pipelines         batch_multi_bev_gen and the sequential and
                                pair-batched registration pipelines
  pctpu_torch.parallel          process groups (strided work lists) and
                                device meshes (data and point sharding)
  pctpu_torch.runtime           loader, writers, stage timing ([TIME]), traces
  pctpu_torch.cli               reference-compatible entry points

Full-f32 rule: reduced-precision products flip nearest-neighbour winners and
corrupt ICP (pctpu pins Precision.HIGHEST for the same reason), so TF32 is
switched off for every matmul and convolution at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from pctpu_torch.cloud import Cloud, from_numpy, make_cloud  # noqa: E402
from pctpu_torch.ops.normals2d import Normal2dEstimation  # noqa: E402
from pctpu_torch.config import (  # noqa: E402
    GroundConfig,
    IcpConfig,
    MultiBevConfig,
    RegistrationConfig,
    SensorParams,
    SingleBevConfig,
    get_sensor_params,
    parse_sensor_type,
    registration_config_from,
)



def __getattr__(name):
    # the PCA2D library facade, imported on first use as pctpu defers it
    if name == "PCA2D":
        from pctpu_torch.ops.pca2d import PCA2D

        return PCA2D
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = [
    "Cloud",
    "GroundConfig",
    "IcpConfig",
    "MultiBevConfig",
    "Normal2dEstimation",
    "PCA2D",
    "RegistrationConfig",
    "SensorParams",
    "SingleBevConfig",
    "from_numpy",
    "get_sensor_params",
    "make_cloud",
    "parse_sensor_type",
    "registration_config_from",
]
