"""Device milliseconds per unit of the window's work (a training step, a
served request: the driver's `units`) in convolution kernels (forward,
input gradient and weight gradient, whichever library runs them), from
the profiler, by the kernel names below. Reads `conv_ms.train` and
`conv_ms.serve`."""

NAMES = ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "conv3d",
         "Convolution", "winograd", "implicit_gemm", "xmma_")


def is_conv(name: str) -> bool:
  return any(n in name for n in NAMES)


def read(run):
  if run.trace is None or not run.window.get("units"):
    return None
  seconds = run.trace.device_s(is_conv)
  if seconds == 0:
    return None
  return 1e3 * seconds / run.window["units"]
