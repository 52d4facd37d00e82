"""corenet_tpu_torch: the PyTorch + CUDA port of corenet_tpu for NVIDIA
Hopper (H100), beside the JAX package, which stays the reference.

It follows corenet_tpu's module layout and names, so each module's
counterpart is the file of the same path there:
  csrc/      hand-written CUDA kernels (sm_90a), plain C interfaces
  kernels/   builds csrc/ with nvcc at first use and loads it with ctypes
  ops/       kernel wrappers, each beside its plain PyTorch version
  models/    ResNet-50, BatchRenorm, decoder, ray-traced skips, losses,
             the weight bridge from the JAX package's variables
  train/     training state and step (on batches that carry their
             ground-truth grid), the voxel → screen matrix, the eval
             forward
  eval/      super-resolution inference

Ported so far: the serving path and the training step on host ground
truth, f32, fine (unpacked) execution. Public functions keep the JAX
package's channel-last layouts. Nothing here imports JAX or corenet_tpu.
"""

__version__ = "0.1.0"

from corenet_tpu_torch.models.corenet import (  # noqa: F401
    CoreNet,
    CoreNetConfig,
    DecoderConfig,
)
