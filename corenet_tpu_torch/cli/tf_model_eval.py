"""Evaluates the paper's frozen TF models through the eval pipeline.

Counterpart of corenet_tpu/cli/tf_model_eval.py, with its flags, plus
--device: the graph runs in TensorFlow on the host (eval/tf_model.py),
and the ground truth, the super-resolution interleave and the metrics on
the device. It writes <output_path>/<eval name>/-1/voxel_metrics.csv.
--compilation_cache_dir is XLA's and has no effect here.

Usage:
  python -m corenet_tpu_torch.cli.tf_model_eval --config_path=cfg.json5 \\
      [-D key=value ...] [--device=cpu]
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

from corenet_tpu_torch.config import (
    TfModelEvalPipeline, load_config_file, parse_template_mapping)
from corenet_tpu_torch.eval.pipeline import EvalPipeline
from corenet_tpu_torch.eval.tf_model import super_resolution_from_tf_model
from corenet_tpu_torch.utils import flags
from corenet_tpu_torch.utils.device import checked_device

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ProgramArgs:
  config_path: str = flags.flag("Path to the TfModelEvalPipeline JSON5")
  template_value: List[str] = flags.flag(
      "key=value string template overrides", default=[], short_name="D",
      repeated=True)
  set: List[str] = flags.flag("dotted-path overrides", default=[],
                              repeated=True)
  max_scenes: int = flags.flag("Max scenes to evaluate (<=0: all)",
                               default=-1)
  compilation_cache_dir: str = flags.flag(
      "Persistent XLA compilation cache directory; '' = the per-user"
      " default, 'none' disables", default="")
  device: str = flags.flag(
      "Torch device for the ground truth and the metrics; without a CUDA "
      "card pass 'cpu'", default="cuda")


def main(argv=None):
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(ProgramArgs, argv)
  device = checked_device(args.device)
  config = load_config_file(
      args.config_path, TfModelEvalPipeline, set_overrides=args.set,
      template_overrides=parse_template_mapping(args.template_value))

  inference = super_resolution_from_tf_model(config.frozen_graph_path,
                                             device=device)
  pipeline = EvalPipeline(config.eval_config, config.output_path, inference,
                          device=device)
  miou = pipeline.run_eval(
      -1, max_scenes=args.max_scenes if args.max_scenes > 0 else None)
  log.info("mIoU: %s", miou)
  return miou


if __name__ == "__main__":
  main()
