"""Checkpoint evaluation entry point.

Counterpart of corenet_tpu/cli/eval.py: loads a `.cpt` checkpoint (written
by either package), rebuilds the training configuration from its
extra_metadata, and runs the recurrent-eval configurations whose names
match --eval_names_regex through the EvalPipeline. Each eval writes
<output_path>/<name>/<step>/voxel_metrics.csv and its `img_*.png` tiles,
and its scalars (per-class IoU, precision, recall, the means) and first
tiles to the summary writer at <output_path>/tb/<name>/ (`scalars.jsonl`,
`rec_<i>_<step>.png`; TensorBoard event files too when
torch.utils.tensorboard imports).

Usage:
  python -m corenet_tpu_torch.cli.eval --checkpoint_path=state.cpt \\
      --output_path=out [--eval_names_regex=.*] [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import logging
import re

from corenet_tpu_torch.config import TrainPipeline as TrainPipelineConfig
from corenet_tpu_torch.config import config_from_dict
from corenet_tpu_torch.eval.pipeline import EvalPipeline
from corenet_tpu_torch.eval.super_resolution import (
    super_resolution_from_model)
from corenet_tpu_torch.models.convert import state_dict_from_jax
from corenet_tpu_torch.models.corenet import CoreNet
from corenet_tpu_torch.train import checkpoint as cpt_lib
from corenet_tpu_torch.train.pipeline import model_config_from_train_config
from corenet_tpu_torch.utils import flags, fs
from corenet_tpu_torch.utils.device import checked_device
from corenet_tpu_torch.utils.summary import SummaryWriter

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ProgramArgs:
  checkpoint_path: str = flags.flag("Path to a .cpt checkpoint")
  output_path: str = flags.flag("Directory for eval results")
  eval_names_regex: str = flags.flag(
      "Only evals whose name fully matches run", default=".*")
  max_scenes: int = flags.flag(
      "Evaluate at most this many scenes per eval (<=0: all)", default=-1)
  packed_inference: bool = flags.flag(
      "Packed (space-to-depth) decoder execution for eligible models: the "
      "same weights, logits within the convolutions' rounding. "
      "--nopacked_inference asks for the fine decoder", default=True)
  batched_offsets: bool = flags.flag(
      "Super-resolution: decode all m^3 offsets as one batch (engages "
      "for <=32^3 natives). --nobatched_offsets decodes them one by one",
      default=True)
  device: str = flags.flag(
      "Torch device to evaluate on; without a CUDA card pass 'cpu'",
      default="cuda")


def load_model(checkpoint_path: str):
  """(CoreNet on the CPU with the checkpoint's weights, the training
  configuration, the classes, the global step) from a `.cpt` file."""
  raw, extra = cpt_lib.decode_state(fs.read_bytes(checkpoint_path))
  full_config = config_from_dict(TrainPipelineConfig, extra["full_config"])
  classes = extra["classes"]
  model = CoreNet(model_config_from_train_config(full_config.train,
                                                 len(classes)))
  model.load_state_dict(state_dict_from_jax(raw.variables))
  return model, full_config, classes, raw.global_step


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(ProgramArgs, argv)
  checked_device(args.device)
  model, full_config, _, global_step = load_model(args.checkpoint_path)
  inference = super_resolution_from_model(
      model, model.state_dict(), model.config.decoder.resolution,
      batch_offsets=None if args.batched_offsets else False,
      packed_execution=args.packed_inference, device=args.device)

  results = {}
  for rec in full_config.eval:
    if not re.fullmatch(args.eval_names_regex, rec.config.name):
      continue
    writer = SummaryWriter(fs.join(args.output_path, "tb", rec.config.name))
    try:
      ep = EvalPipeline(rec.config, args.output_path, inference,
                        summary_writer=writer, device=args.device)
      miou = ep.run_eval(global_step,
                         max_scenes=args.max_scenes if args.max_scenes > 0
                         else None)
    finally:
      writer.close()
    results[rec.config.name] = miou
    log.info("eval %s: mIoU=%s", rec.config.name, miou)
  return results


if __name__ == "__main__":
  main()
