"""Training entry point.

Counterpart of corenet_tpu/cli/train.py, with its flags, names and
defaults, plus --device. It loads a TrainPipeline configuration (JSON5,
with -D template values, jq programs and --set overrides), trains from
the newest checkpoint under <output_path>/cpt/ (or from a fresh state),
and runs the configuration's recurrent evals on their schedules. Recovery
is restart-from-last-checkpoint: a second call resumes where the first
stopped.

Usage:
  python -m corenet_tpu_torch.cli.train --config_path=cfg.json5 \\
      [-D key=value ...] [--set path=json ...] [-jq program ...] \\
      [--max_steps=N] [--device=cpu]

On N cards of one machine, one process per card (the configuration's
batch size is per process), under the retry supervisor if wanted:
  python -m corenet_tpu_torch.cli.launch --num_retries=3 -- \\
      python -m torch.distributed.run --standalone --nproc_per_node=N \\
      -m corenet_tpu_torch.cli.train --multihost --config_path=cfg.json5
--multihost joins the process group from torchrun's environment
(parallel/mesh.py: NCCL on cards, gloo with --device=cpu), trains on
cuda:LOCAL_RANK, and logs each rank to <output_path>/logs/.

--space=N lays the processes out as data × N (parallel/mesh.py): the N
space ranks of each data group train one depth slab each of the decoder
on the same batches, and voxelize 1/N of each batch's scenes where N
divides the batch; N must divide the number of processes. Each rank
needs its own process, so --space > 1 comes with --multihost:
  python -m torch.distributed.run --standalone --nproc_per_node=2 \\
      -m corenet_tpu_torch.cli.train --multihost --space=2 ...

--gt_mode=host voxelizes the ground truth with the native C++ ops in the
loader's producer thread, overlapping the step. --compilation_cache_dir
is XLA's and has no effect here. The recurrent evals decode with the fine decoder whatever
--decoder_execution trains (train/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

from corenet_tpu_torch.config import TrainPipeline as TrainPipelineConfig
from corenet_tpu_torch.config import (
    config_to_dict, load_config_file, parse_template_mapping)
from corenet_tpu_torch.parallel import mesh
from corenet_tpu_torch.train.pipeline import RecurrentEvals, TrainPipeline
from corenet_tpu_torch.utils import flags, ui
from corenet_tpu_torch.utils.device import checked_device

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ProgramArgs:
  config_path: str = flags.flag("Path to the JSON5 train pipeline config")
  template_value: List[str] = flags.flag(
      "key=value string template overrides", default=[], short_name="D",
      repeated=True)
  jq_transform: List[str] = flags.flag(
      "jq programs applied to the raw config", default=[], short_name="jq",
      repeated=True)
  set: List[str] = flags.flag(
      "dotted-path structural overrides, e.g. train.max_steps=1000",
      default=[], repeated=True)
  max_steps: int = flags.flag(
      "Overrides config max_steps when >= 0", default=-1)
  multihost: bool = flags.flag(
      "Join the process group from torchrun's environment: one process "
      "per device, data parallel", default=False)
  space: int = flags.flag(
      "Size of the 'space' mesh axis: shards the voxel grid's depth axis"
      " across processes (spatial partitioning of the 3D decoder;"
      " processes / space become the 'data' axis)", default=1)
  gt_mode: str = flags.flag(
      "GT generation: 'device' (in the step) or 'host' (native C++ in the "
      "loader's producer thread)", default="device")
  gt_algorithm: str = flags.flag(
      "'raster' (rasterize + fill) or 'parity' (exact center sampling,"
      " closed meshes)", default="raster")
  compute_dtype: str = flags.flag(
      "'bfloat16' (the default; f32 params/stats/logits/gradients) or"
      " 'float32'", default="bfloat16")
  decoder_execution: str = flags.flag(
      "'fine', 'packed' (the space-to-depth decoder; the same parameters "
      "and checkpoints) or 'auto' (packed where eligible)",
      default="auto")
  phase_loss: str = flags.flag(
      "'auto' (on for eligible FG_BG configs), 'on', or 'off': train the"
      " loss on phase-major final-stage logits", default="auto")
  renorm_ramp_start: int = flags.flag(
      "Step at which the BatchRenorm r/d ramps engage. -1 = the"
      " reference's 5000; 0 engages renorm correction from the first step",
      default=-1)
  profile_dir: str = flags.flag(
      "When set, write a torch.profiler trace (trace.json) of"
      " profile_steps training iterations into this directory; it carries"
      " the program's spans (train.step and its parts, loader.collate)"
      " as named ranges", default="")
  profile_start: int = flags.flag(
      "Loop iteration at which the profiler trace starts", default=20)
  profile_steps: int = flags.flag(
      "Number of iterations to trace", default=10)
  compilation_cache_dir: str = flags.flag(
      "XLA's persistent compilation cache in the JAX package; accepted "
      "and ignored here", default="")
  device: str = flags.flag(
      "Torch device to train on; without a CUDA card pass 'cpu'",
      default="cuda")


def main(argv=None) -> TrainPipeline:
  logging.basicConfig(
      level=logging.INFO,
      format="%(levelname).1s%(asctime)s %(filename)s:%(lineno)d] "
             "%(message)s")
  args = flags.parse_flags(ProgramArgs, argv)
  checked_device(args.device)
  if args.space > 1 and not args.multihost:
    raise ValueError(f"--space={args.space} does not divide the world size "
                     "1: without --multihost one process trains")
  if args.compilation_cache_dir:
    log.info("--compilation_cache_dir=%s has no effect: it is XLA's",
             args.compilation_cache_dir)
  if args.phase_loss not in ("auto", "on", "off"):
    raise ValueError(f"--phase_loss must be auto, on or off, got "
                     f"{args.phase_loss!r}")

  config = load_config_file(
      args.config_path, TrainPipelineConfig,
      jq_transforms=args.jq_transform, set_overrides=args.set,
      template_overrides=parse_template_mapping(args.template_value))

  if not args.multihost:
    return _train(args, config, args.device)
  device = mesh.initialize(device=args.device)
  try:
    ui.initialize_logging(config.output_path)
    return _train(args, config, device)
  finally:
    mesh.shutdown()


def _train(args: ProgramArgs, config, device) -> TrainPipeline:
  layout = mesh.create_mesh(space=args.space)
  pipeline = TrainPipeline(
      config.train, config.output_path, mesh=layout,
      extra_metadata={"train_config": config_to_dict(config.train),
                      "full_config": config_to_dict(config)},
      gt_mode=args.gt_mode, gt_algorithm=args.gt_algorithm,
      compute_dtype=args.compute_dtype,
      decoder_execution=args.decoder_execution,
      phase_loss={"auto": None, "on": True, "off": False}[args.phase_loss],
      renorm_ramp_start=(None if args.renorm_ramp_start < 0
                         else args.renorm_ramp_start),
      device=device)
  evals = RecurrentEvals(config.eval, config.output_path)
  max_steps = args.max_steps if args.max_steps >= 0 else None
  pipeline.run(recurrent_evals=evals, max_steps=max_steps,
               profile_dir=args.profile_dir or None,
               profile_start=args.profile_start,
               profile_steps=args.profile_steps)
  return pipeline


if __name__ == "__main__":
  main()
