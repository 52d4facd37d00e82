"""Runs one cell traced, as benchmark/run.py does, and prints after the
run's result line one more JSON line: where the window's idle device time
and its launches lie by the program's innermost main-thread span, the
share of the launches inside a step or request span, and each span's
milliseconds and each counter per unit (harness/spans.py::breakdown).

  python3 benchmark/harness/span_report.py --workload <cell> --seed <n> \
      --seconds <s>

from the root of a checkout on a machine with the cell's CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv, root: str = ROOT, device: str = "cuda") -> int:
  if root not in sys.path:
    sys.path.insert(0, root)
  from benchmark import run
  from benchmark.harness import spans
  kept = {}
  made = run.Run

  def keep(*args):
    kept["run"] = made(*args)
    return kept["run"]

  run.Run = keep
  try:
    code = run.main(list(argv) + ["--trace", "1"], root=root, device=device)
  finally:
    run.Run = made
  if code == 0 and "run" in kept:
    print(json.dumps({"spans": spans.breakdown(kept["run"])}), flush=True)
  return code


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
