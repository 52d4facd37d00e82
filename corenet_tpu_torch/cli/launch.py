"""Supervised launcher with whole-job retry.

Counterpart of corenet_tpu/cli/launch.py, host-only: it runs any command,
and when the command fails it waits and runs the whole command again, up
to --num_retries times, as the original CoreNet's launcher relaunched all
of its per-GPU processes after a failure. Recovery is
restart-from-last-checkpoint: the training pipeline resumes from the
newest checkpoint and re-derives the data-epoch position from the global
step. torchrun starts the processes, one per card; this supervises
torchrun.

Usage:
  python -m corenet_tpu_torch.cli.launch --num_retries=3 \\
      --retry_wait_sec=90 -- \\
      python -m torch.distributed.run --standalone --nproc_per_node=8 \\
      -m corenet_tpu_torch.cli.train --multihost --config_path=cfg.json5
"""

from __future__ import annotations

import dataclasses
import logging
import subprocess
import sys
import time
from typing import List

from corenet_tpu_torch.utils import flags

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ProgramArgs:
  num_retries: int = flags.flag("Relaunches after failure", default=3)
  retry_wait_sec: float = flags.flag("Seconds to wait before a retry",
                                     default=90.0)
  command: List[str] = flags.flag("The command to supervise", default=[],
                                  kind=flags.ArgKind.REMAINDER)


def main(argv=None) -> int:
  """Runs the command until it succeeds or the retries are spent; returns
  its last exit code."""
  logging.basicConfig(level=logging.INFO)
  args = flags.parse_flags(ProgramArgs, argv)
  command = [c for c in args.command if c != "--"]
  if not command:
    raise SystemExit("No command given (pass it after --)")

  attempt = 0
  while True:
    log.info("Launching (attempt %d): %s", attempt + 1, " ".join(command))
    proc = subprocess.run(command, check=False)
    if proc.returncode == 0:
      log.info("Command finished successfully")
      return 0
    attempt += 1
    if attempt > args.num_retries:
      log.error("Command failed with %d after %d attempts; giving up",
                proc.returncode, attempt)
      return proc.returncode
    log.warning("Command failed with %d; retrying in %.0f s (%d/%d)",
                proc.returncode, args.retry_wait_sec, attempt,
                args.num_retries)
    time.sleep(args.retry_wait_sec)


if __name__ == "__main__":
  sys.exit(main())
