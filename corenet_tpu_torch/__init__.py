"""corenet_tpu_torch: the PyTorch + CUDA port of corenet_tpu for NVIDIA
Hopper (H100), beside the JAX package, which stays the reference.

It follows corenet_tpu's module layout and names, so each module's
counterpart is the file of the same path there:
  csrc/      hand-written CUDA kernels (sm_90a), plain C interfaces
  kernels/   builds csrc/ with nvcc at first use and loads it with ctypes
  ops/       kernel wrappers, each beside its plain PyTorch version
  models/    ResNet-50, BatchRenorm, decoder (with its phase-major
             output), ray-traced skips, losses, the weight bridge from
             the JAX package's variables
  voxel/     bit-packed grids, the packed interior fill, the blocked
             triangle rasterizer
  data/      host-side (numpy) triangle subdivision and padding
  train/     training state and step (on ground-truth grids from the
             batch or voxelized in the step, with the phase loss), the
             on-device ground truth, the voxel → screen matrix, the eval
             forward
  eval/      super-resolution inference

Ported so far: the serving path and the training step, on host ground
truth or on ground truth voxelized in the step by the blocked rasterizer
(with the phase loss for FG_BG), f32, fine (unpacked) execution. Public
functions keep the JAX package's channel-last layouts. Nothing here
imports JAX or corenet_tpu.
"""

__version__ = "0.1.0"

from corenet_tpu_torch.models.corenet import (  # noqa: F401
    CoreNet,
    CoreNetConfig,
    DecoderConfig,
)
