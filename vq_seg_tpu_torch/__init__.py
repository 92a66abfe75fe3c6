"""vq_seg_tpu_torch: the PyTorch/CUDA port of vq_seg_tpu.

A second package beside the JAX one, which stays as the reference.  Plain
tensor code is PyTorch in NCHW; the fused VQ assignment is a CUDA C++ kernel
for Hopper (``csrc/vq_assign.cu``), built with nvcc at first use.  The
public functions keep the JAX package's layouts: ``Predictor`` takes
(B, H, W, 3) uint8 and returns (B, H, W) uint8, and ``vq_assign`` takes rows
(N, C).  Training goes ``create_cps_state`` -> ``cps_init_phase`` ->
``make_cps_train_step(...)(state, l_img, l_target, ul_img)``.  Entry points
run on "cuda" unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from vq_seg_tpu_torch.config import Config, load_config

_TRAINING = ("CPSTrainState", "create_cps_state", "cps_init_phase", "make_cps_train_step",
             "make_lr_schedule")

__all__ = ["Config", "load_config", "Predictor", "make_loss", *_TRAINING, "__version__"]


def __getattr__(name):
    # lazy: serving and training pull in the model registry; keep bare
    # config imports light
    if name == "Predictor":
        from vq_seg_tpu_torch.serving import Predictor
        return Predictor
    if name == "make_loss":
        from vq_seg_tpu_torch.losses import make_loss
        return make_loss
    if name in _TRAINING:
        from vq_seg_tpu_torch import training
        return getattr(training, name)
    raise AttributeError(name)
