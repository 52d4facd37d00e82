"""The model's share of the chip's peak over the window: the operations
that the window's work requires (benchmark/counts/flops.py) over the
window's length times the peak of the configuration's precision. Reads
`mfu.train` and `mfu.serve`."""


def read(run):
  flops = run.counts.get("model_flops")
  if not flops:
    return None
  return 100.0 * flops / (run.window["window_s"] * run.counts["peak_flops"])
