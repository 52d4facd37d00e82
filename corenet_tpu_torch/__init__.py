"""corenet_tpu_torch: the PyTorch + CUDA port of corenet_tpu for NVIDIA
Hopper (H100), beside the JAX package, which stays the reference.

It follows corenet_tpu's module layout and names, so each module's
counterpart is the file of the same path there:
  csrc/      hand-written CUDA kernels (sm_90a), plain C interfaces
  cc/        the native C++ voxelizer and flood fill for ground truth on
             the host, built with g++ at first use
  kernels/   builds csrc/ with nvcc at first use and loads it with ctypes
  ops/       kernel wrappers, each beside its plain PyTorch version
  models/    ResNet-50, BatchRenorm, decoder (fine or space-to-depth
             packed, with its phase-major output), ray-traced skips,
             losses, the weight bridge from the JAX package's variables
  voxel/     bit-packed grids and their interior fill, the blocked
             triangle rasterizer; the general rasterizer, the dense
             interior fill, label composition, ray-parity voxelization
  config/    typed configurations, loaded from JSON5 files or plain dicts
  data/      host side (numpy): scene and mesh NPZ readers, manifest
             datasets and their manager, batch assembly with triangle
             subdivision and padding, the prefetching loader
  train/     training state and step (on ground-truth grids from the
             batch or voxelized in the step, with the phase loss), the
             on-device ground truth, the voxel → screen matrix, the eval
             forward; `.cpt` checkpoints (the JAX package's container and
             a msgpack codec of their own); the training pipeline with its
             checkpoint, summary and recurrent-eval cadences
  eval/      super-resolution inference and its factory; the eval pipeline
             with its metrics and results (confusion matrix, IoU, the
             CSV) and qualitative results (rendered tiles)
  geom/      4x4 transform algebra (numpy)
  viz/       cameras, isosurfaces, artifacts and tiles on the host; the
             mesh rasterizer and voxel raycaster as tensor code on the
             device
  parallel/  data parallelism over processes and the 'space' axis: the
             process group and its (data, space) layout, the
             differentiable all-reduce and halo exchange, gradient
             averaging, host reductions over gloo
  cli/       the train, eval, demo and frozen-graph eval entry points
             (python -m ...), the retry launcher, the dataset and config
             tools, the checkpoint and encoder importers
  utils/     rounding and tiling helpers, local + gs:// file I/O, flags,
             summaries (JSONL, TensorBoard when it imports), PNG bytes,
             the device check, rank-tagged logs and progress, debugging
             summaries

Ported so far: the serving path; the training step, on host ground truth
or on ground truth voxelized in the step (the blocked rasterizer with the
phase loss for FG_BG, the general rasterizer for every other
configuration, ray parity); the eval pipeline from a dataset manifest to
`voxel_metrics.csv` and the qualitative tiles; serving from a `.cpt` file
through the eval and demo CLIs; training through `TrainPipeline` and the
train CLI; the decoder fine or packed (`packed_decoder`, the JAX
package's space-to-depth execution) in each. float32 or bf16 compute
(`compute_dtype`). Training and evaluation data parallel over processes,
one per device (`parallel/`, torch.distributed under torchrun: global
BatchRenorm statistics and loss, averaged gradients, sharded loaders,
rank-0 checkpoints, cross-rank eval metrics), and training with the
decoder's depth sharded over space ranks (`parallel.mesh.create_mesh`,
`CoreNet(depth_shard=...)`: halo exchanges, per-scene loss sums over the
space group). Public functions keep the JAX package's channel-last
layouts.
Ground truth on the host (`gt_mode="host"`: the C++ ops in the loader)
trains as the JAX package's does.
Nothing here imports JAX, corenet_tpu, pandas, msgpack, tensorboard,
tensorflow or h5py at import time; json5, PIL (image decoding),
tensorboard, tensorflow (frozen graphs) and h5py (Keras weights) are
optional.

An eval on the CPU, from a manifest to the mean IoU:

  from corenet_tpu_torch import config
  from corenet_tpu_torch.eval.pipeline import EvalPipeline
  eval_config = config.config_from_dict(config.EvalConfig, {...})
  pipeline = EvalPipeline(eval_config, output_dir, inference_fn,
                          device="cpu")
  mean_iou = pipeline.run_eval(global_step=0)
"""

__version__ = "0.1.0"

from corenet_tpu_torch.models.corenet import (  # noqa: F401
    CoreNet,
    CoreNetConfig,
    DecoderConfig,
)
