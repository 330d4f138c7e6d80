"""LiveVisionKit on PyTorch + CUDA for one NVIDIA H100: the stabilizer
(homography and mesh modes), the FSR scaler (EASU upscale + RCAS sharpen),
the deblocker, CAS, colour conversion and lens correction, with the
streaming runtime and the `lvk-torch` CLI (runtime/).

A port of ``livevisionkit_tpu`` (the JAX reference, which stays beside it):
plain tensor code is PyTorch, and the hot kernels are hand-written CUDA C++
for Hopper (``csrc/``, bound in ``ops/cuda_kernels/``).  Every module keeps
the reference's relative path, so ``vision/optical_flow.py`` here is the
counterpart of ``livevisionkit_tpu/vision/optical_flow.py``.

Tensors on the CPU take each kernel's plain PyTorch version; tensors on a
CUDA device launch the kernel or raise.
"""

import torch

# The DLT and normal-equation solves assume full float32 products; TF32
# keeps about three decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from livevisionkit_tpu_torch.config import (  # noqa: E402
    CASFilterSettings,
    DeblockingFilterSettings,
    FeatureDetectorSettings,
    FrameTrackerSettings,
    MotionEstimationSettings,
    OpticalFlowSettings,
    PathSmootherSettings,
    ScalingFilterSettings,
    StabilizationFilterSettings,
)
from livevisionkit_tpu_torch.data.frame import Frame  # noqa: E402
from livevisionkit_tpu_torch.filters.base import (  # noqa: E402
    CompositeFilter,
    ConversionFilter,
    FrameSpec,
    IdentityFilter,
    VideoFilter,
)
from livevisionkit_tpu_torch.filters.deblocking import DeblockingFilter  # noqa: E402
from livevisionkit_tpu_torch.filters.lens_correction import LensCorrectionFilter  # noqa: E402
from livevisionkit_tpu_torch.filters.scaling import ScalingFilter  # noqa: E402
from livevisionkit_tpu_torch.filters.sharpening import CASFilter  # noqa: E402
from livevisionkit_tpu_torch.filters.stabilization import (  # noqa: E402
    StabilizationFilter,
    flagship_filter,
)
from livevisionkit_tpu_torch.models.homography import Homography  # noqa: E402
from livevisionkit_tpu_torch.models.warp_field import WarpField  # noqa: E402
from livevisionkit_tpu_torch.types import PixelFormat  # noqa: E402
from livevisionkit_tpu_torch.vision.calibration import CameraParameters  # noqa: E402

__all__ = [
    "Frame",
    "PixelFormat",
    "Homography",
    "WarpField",
    "FrameSpec",
    "VideoFilter",
    "IdentityFilter",
    "CompositeFilter",
    "ConversionFilter",
    "StabilizationFilter",
    "DeblockingFilter",
    "ScalingFilter",
    "CASFilter",
    "LensCorrectionFilter",
    "CameraParameters",
    "flagship_filter",
    "FeatureDetectorSettings",
    "OpticalFlowSettings",
    "MotionEstimationSettings",
    "FrameTrackerSettings",
    "PathSmootherSettings",
    "StabilizationFilterSettings",
    "DeblockingFilterSettings",
    "ScalingFilterSettings",
    "CASFilterSettings",
    "__version__",
]
