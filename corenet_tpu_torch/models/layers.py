"""Conv/linear primitives with torch-style shape semantics.

Counterpart of corenet_tpu/models/layers.py. These modules work in
PyTorch's own layout, (N, C, spatial...), and
keep PyTorch's weight layouts: a convolution's weight is
(out, in, spatial...), a transposed convolution's (in, out, spatial...)
with no flip, a linear layer's (out, in). models/convert.py maps the JAX
package's kernels (spatial... + (in, out)) onto them.

`compute_dtype` (None = float32; torch.bfloat16) casts each call's input
and kernel to that dtype, as the JAX modules do; the parameters stay
float32, so autograd's cast gives float32 parameter gradients. The bias
goes in as the JAX layers add it: `Conv` adds the float32 bias to its
bf16 output in float32 and rounds once, `ConvTranspose` and `Linear` add
it cast to the compute dtype.

`packed_io` (3D only) runs a layer on space-to-depth packed activations,
(N, 8·C, D/2, H/2, W/2) in and out (models/packing.py), with the fine
layer's parameters; the bias is tiled over the phases and added in the
compute dtype, as the JAX layers add it there. A fine transposed
convolution runs as torch's `conv_transpose`, the JAX package's
`method="dilated"`; its per-phase lowerings are not ported (ROADMAP.md
§3).

`depth_sharded` (3D; the 'space' axis, parallel/mesh.py) runs a
convolution or a transposed convolution on this space rank's slab of the
depth (dim 2): its depth padding is the neighbouring ranks' boundary
slices (`mesh.halo_exchange`, the halos of `depth_halo`) instead of
zeros, the other axes keep theirs, and the output is the same slab of the
whole grid's output, packed or fine. The convolution keeps the depth
(stride 1, padding k // 2) and the transposed convolution multiplies it
by its stride; `phase_output` shards the phase-major depth.

`reset_parameters(generator)` reproduces the JAX package's initializers:
torch's default U(±1/√fan_in) for kernels and biases, kaiming-normal
(fan_in, relu; truncated at two standard deviations, as flax's
variance_scaling draws it) for the encoder convolutions, and torch's quirk
of counting a transposed convolution's fan_in over its output channels.
Values are drawn on the CPU from a CPU generator and copied, so a seed
gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from corenet_tpu_torch.models import packing
from corenet_tpu_torch.parallel import mesh

IntOrTuple = Union[int, Tuple[int, ...]]

# flax's truncated_normal(-2, 2) has this standard deviation; variance
# scaling divides by it so the truncated draw keeps the requested variance.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def _tuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
  if isinstance(v, int):
    return (v,) * n
  v = tuple(int(x) for x in v)
  if len(v) != n:
    raise ValueError(f"expected {n} values, got {v}")
  return v


@torch.no_grad()
def _uniform_(param: torch.Tensor, bound: float,
              generator: torch.Generator) -> None:
  values = torch.empty(param.shape).uniform_(-bound, bound,
                                             generator=generator)
  param.copy_(values)


@torch.no_grad()
def _kaiming_normal_(param: torch.Tensor, fan_in: int,
                     generator: torch.Generator) -> None:
  std = math.sqrt(2.0 / fan_in) / _TRUNCATED_NORMAL_STD
  values = nn.init.trunc_normal_(torch.empty(param.shape), 0.0, std,
                                 -2 * std, 2 * std, generator=generator)
  param.copy_(values)


def conv_depth_halo(k: int, packed: bool) -> Tuple[int, int]:
  """(below, above): the depth slices (packed cells when `packed`) of the
  neighbouring slabs that a depth-sharded convolution of kernel k, stride
  1 and padding k // 2 reads."""
  return (packing.packed_depth_halo(k, k // 2, False) if packed
          else (k // 2, k // 2))


def conv_transpose_depth_halo(k: int, p: int, s: int, packed: bool
                              ) -> Tuple[int, int]:
  """(below, above) for a depth-sharded transposed convolution of kernel
  k, padding p and stride s (2 when `packed`): fine output n reads the
  inputs i with 0 ≤ n + p − s·i < k."""
  if packed:
    return packing.packed_depth_halo(k, p, True)
  return (k - 1 - p) // s, (p - 1 + s) // s


class Conv(nn.Module):
  """N-d convolution (N = 2 or 3) with symmetric integer padding.

  packed_io (3D, stride 1, padding k // 2): packed input and output
  (models/packing.py::packed_conv). depth_sharded (3D, stride 1, padding
  k // 2 along the depth): the input is a depth slab (module
  docstring)."""

  def __init__(self, in_features: int, features: int,
               kernel_size: IntOrTuple, ndim: int, stride: IntOrTuple = 1,
               padding: IntOrTuple = 0,
               kernel_init_mode: str = "torch_default",
               packed_io: bool = False, depth_sharded: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    if ndim not in (2, 3):
      raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if kernel_init_mode not in ("torch_default", "kaiming_normal"):
      raise ValueError(f"unknown kernel_init_mode {kernel_init_mode!r}")
    k = _tuple(kernel_size, ndim)
    self.ndim = ndim
    self.stride = _tuple(stride, ndim)
    self.padding = _tuple(padding, ndim)
    if packed_io and (ndim != 3 or set(self.stride) != {1} or len(set(k)) != 1
                      or self.padding != (k[0] // 2,) * 3):
      raise ValueError("packed_io needs a 3D convolution of stride 1 with "
                       "a cubic kernel and padding k // 2")
    if depth_sharded and (ndim != 3 or self.stride[0] != 1
                          or 2 * self.padding[0] != k[0] - 1):
      raise ValueError("depth_sharded needs a 3D convolution of stride 1 "
                       "and padding k // 2 along the depth")
    self.packed_io = packed_io
    self.depth_sharded = depth_sharded
    self.depth_halo = conv_depth_halo(k[0], packed_io)
    self.kernel_init_mode = kernel_init_mode
    self.compute_dtype = compute_dtype
    self.fan_in = in_features * math.prod(k)
    self.weight = nn.Parameter(
        torch.empty((features, in_features) + k, device=device))
    self.bias = nn.Parameter(torch.empty(features, device=device))

  def reset_parameters(self, generator: torch.Generator) -> None:
    if self.kernel_init_mode == "kaiming_normal":
      _kaiming_normal_(self.weight, self.fan_in, generator)
    else:
      _uniform_(self.weight, 1.0 / math.sqrt(self.fan_in), generator)
    _uniform_(self.bias, 1.0 / math.sqrt(self.fan_in), generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.packed_io:
      return self._packed(x)
    conv = F.conv2d if self.ndim == 2 else F.conv3d
    padding = self.padding
    if self.compute_dtype is not None:
      x = x.to(self.compute_dtype)
    if self.depth_sharded:
      x = mesh.halo_exchange(x, 2, *self.depth_halo)
      padding = (0,) + padding[1:]
    if self.compute_dtype is None:
      return conv(x, self.weight, self.bias, self.stride, padding)
    y = conv(x, self.weight.to(self.compute_dtype), None, self.stride,
             padding)
    bias = self.bias.view((-1,) + (1,) * self.ndim)
    return (y.float() + bias).to(y.dtype)

  def _packed(self, x: torch.Tensor) -> torch.Tensor:
    # The float32 weight is expanded, then cast with the input (packing.py);
    # the tiled bias is cast after tiling, as the JAX layer casts it.
    bias = self.bias.repeat(8)
    if self.compute_dtype is None:
      return packing.packed_conv(x, self.weight, self.padding[0], bias,
                                 self.depth_sharded)
    y = packing.packed_conv(x.to(self.compute_dtype), self.weight,
                            self.padding[0],
                            depth_sharded=self.depth_sharded)
    return y + bias.to(y.dtype).view(-1, 1, 1, 1)


class ConvTranspose(nn.Module):
  """N-d transposed convolution with torch ConvTransposeNd semantics:
  out = (in − 1)·stride − 2·padding + kernel + output_padding.

  phase_output (3D, stride 2): return the output channel-last in
  phase-major layout, [B, D/2, H/2, W/2, 8·F] with channel order
  (pz, py, px, f), where fine index = 2·coarse + phase per axis, instead
  of (B, F, D, H, W). With packed_io (packed in and out, a cubic kernel,
  stride 2) it is the packed plan's raw output, [B, D/4, H/4, W/4, 64·F]
  in channel order (rm0, rm1, rm2, pz, py, px, f), fine index
  4·coarse + 2·rm + phase per axis. The same parameters either way; the
  JAX package's layouts for consumers that do not depend on voxel order
  (the training loss).

  depth_sharded (3D, an output of stride × the input along the depth): the
  input is a depth slab (module docstring)."""

  def __init__(self, in_features: int, features: int,
               kernel_size: IntOrTuple, ndim: int, stride: IntOrTuple = 1,
               padding: IntOrTuple = 0, output_padding: IntOrTuple = 0,
               phase_output: bool = False, packed_io: bool = False,
               depth_sharded: bool = False,
               compute_dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    if ndim not in (2, 3):
      raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if (phase_output or packed_io) and (
        ndim != 3 or _tuple(stride, ndim) != (2, 2, 2)):
      raise ValueError("phase_output and packed_io need a 3D transposed "
                       "convolution of stride 2")
    k = _tuple(kernel_size, ndim)
    if packed_io and not (len(set(k)) == 1
                          and len(set(_tuple(padding, ndim))) == 1
                          and len(set(_tuple(output_padding, ndim))) == 1):
      raise ValueError("packed_io needs the same kernel, padding and output "
                       "padding on every axis")
    self.ndim = ndim
    self.phase_output = phase_output
    self.packed_io = packed_io
    self.compute_dtype = compute_dtype
    self.stride = _tuple(stride, ndim)
    self.padding = _tuple(padding, ndim)
    self.output_padding = _tuple(output_padding, ndim)
    s, p = self.stride[0], self.padding[0]
    if depth_sharded and (
        ndim != 3 or k[0] + self.output_padding[0] - 2 * p != s):
      raise ValueError("depth_sharded needs a 3D transposed convolution "
                       "whose output depth is stride × its input's")
    self.depth_sharded = depth_sharded
    self.kernel_size = k
    self.depth_halo = conv_transpose_depth_halo(k[0], p, s, packed_io)
    # torch counts a ConvTranspose's fan_in over its output channels.
    self.fan_in = features * math.prod(k)
    self.weight = nn.Parameter(
        torch.empty((in_features, features) + k, device=device))
    self.bias = nn.Parameter(torch.empty(features, device=device))

  def reset_parameters(self, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(self.fan_in)
    _uniform_(self.weight, bound, generator)
    _uniform_(self.bias, bound, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dtype = self.compute_dtype
    xc = x if dtype is None else x.to(dtype)
    if self.packed_io:
      # The float32 weight is expanded, then cast with the input. The bias
      # goes in the convolution (64 phases) in float32 and is added in the
      # compute dtype in bf16, as the JAX layers add it.
      y = packing.packed_conv_transpose(
          xc, self.weight, self.padding[0], self.output_padding[0],
          phase_output=self.phase_output,
          bias=self.bias.repeat(64) if dtype is None else None,
          depth_sharded=self.depth_sharded)
      if dtype is not None:
        reps = 64 if self.phase_output else 8
        y = y + self.bias.repeat(reps).to(dtype).view(-1, 1, 1, 1)
      return y.permute(0, 2, 3, 4, 1) if self.phase_output else y
    weight = self.weight if dtype is None else self.weight.to(dtype)
    bias = self.bias if dtype is None else None
    if self.depth_sharded:
      y = self._depth_sharded(xc, weight, bias)
    else:
      conv_t = F.conv_transpose2d if self.ndim == 2 else F.conv_transpose3d
      y = conv_t(xc, weight, bias, self.stride, self.padding,
                 self.output_padding)
    if dtype is not None:
      y = y + self.bias.to(y.dtype).view((-1,) + (1,) * self.ndim)
    if not self.phase_output:
      return y
    b, f, d, h, w = y.shape
    y = y.reshape(b, f, d // 2, 2, h // 2, 2, w // 2, 2)
    return y.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(
        b, d // 2, h // 2, w // 2, 8 * f)


  def _depth_sharded(self, x, weight, bias):
    """The fine transposed convolution of a depth slab: the input with its
    halos, unpadded along the depth, gives s·lo + p output rows before
    the slab's first and s·(hi − 1) + k − p after its last. torch's
    padding crops both ends alike, up to the layer's own padding, and the
    rest is cut: torch's CPU float32 weight gradient is garbage for some
    pairs of a larger padding and the depth (a padding of 5 at depths 5
    and 6 on one thread)."""
    s, p = self.stride[0], self.padding[0]
    lo, hi = self.depth_halo
    slab = x.shape[2]
    x = mesh.halo_exchange(x, 2, lo, hi)
    below, above = s * lo + p, s * (hi - 1) + self.kernel_size[0] - p
    crop = min(below, above, p)
    y = F.conv_transpose3d(x, weight, bias, self.stride,
                           (crop,) + self.padding[1:],
                           (0,) + self.output_padding[1:])
    return y.narrow(2, below - crop, s * slab)


class Linear(nn.Module):
  """Dense layer with torch's default init."""

  def __init__(self, in_features: int, features: int,
               compute_dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    super().__init__()
    self.compute_dtype = compute_dtype
    self.weight = nn.Parameter(
        torch.empty((features, in_features), device=device))
    self.bias = nn.Parameter(torch.empty(features, device=device))

  def reset_parameters(self, generator: torch.Generator) -> None:
    bound = 1.0 / math.sqrt(self.weight.shape[1])
    _uniform_(self.weight, bound, generator)
    _uniform_(self.bias, bound, generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.compute_dtype is None:
      return F.linear(x, self.weight, self.bias)
    dtype = self.compute_dtype
    # The product is rounded before the bias is added, as `x @ k + b`.
    return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


def max_pool_2d(x: torch.Tensor, kernel: int, stride: int,
                padding: int) -> torch.Tensor:
  """Max pooling over (N, C, H, W); the padding counts as −inf."""
  return F.max_pool2d(x, kernel, stride, padding)
