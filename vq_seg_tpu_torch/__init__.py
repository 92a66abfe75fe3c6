"""vq_seg_tpu_torch: the PyTorch/CUDA port of vq_seg_tpu.

A second package beside the JAX one, which stays as the reference.  Plain
tensor code is PyTorch in NCHW; the fused VQ assignment is a CUDA C++ kernel
for Hopper (``csrc/vq_assign.cu``), built with nvcc at first use.  The
public functions keep the JAX package's layouts: ``Predictor`` takes
(B, H, W, 3) uint8 and returns (B, H, W) uint8, and ``vq_assign`` takes rows
(N, C).  Entry points run on "cuda" unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from vq_seg_tpu_torch.config import Config, load_config

__all__ = ["Config", "load_config", "Predictor", "__version__"]


def __getattr__(name):
    # lazy: serving pulls in the model registry; keep bare config imports light
    if name == "Predictor":
        from vq_seg_tpu_torch.serving import Predictor
        return Predictor
    raise AttributeError(name)
