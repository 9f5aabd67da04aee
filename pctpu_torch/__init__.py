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
  pctpu_torch.pipelines         batch_multi_bev_gen and the sequential
                                registration pipelines
  pctpu_torch.runtime           loader, writers, stage timing ([TIME])
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
from pctpu_torch.config import (  # noqa: E402
    IcpConfig,
    RegistrationConfig,
    registration_config_from,
)

__version__ = "0.1.0"

__all__ = [
    "Cloud",
    "IcpConfig",
    "RegistrationConfig",
    "from_numpy",
    "make_cloud",
    "registration_config_from",
]
