"""The int8 3x3 SAME convolution of int8 inference (kernel I1), and the
quantization of its operands.

Counterpart of ``_Int8Conv`` in ``osvos_tpu/models/vgg_osvos.py``, which is
XLA's ``lax.conv_general_dilated`` on int8 operands with int32 accumulation,
not a Pallas kernel. For x_q (N, H, W, Cin) int8 NHWC, w_q (Cout, Cin, 3,
3) int8 and per output channel the float32 ``scale`` (x_scale * w_scale, as
the JAX code forms it) and ``bias``,

    acc = sum over (kh, kw, cin) of x_q[n, h + kh - 1, w + kw - 1, cin] * w_q[d, cin, kh, kw]
    y   = bf16(relu(float(acc) * scale[d] + bias[d]))

x_q taken as zero outside the image, acc exact in int32, the multiply and
the add each rounded to float32, y (N, H, W, Cout) bfloat16.

Two entries. ``int8_conv3x3`` takes x_q: on a CUDA tensor it launches the
first kernel of ``osvos_torch/csrc/int8conv.cu`` (``mma.sync``, any shape;
``launches``) on the weight packed by ``pack_weight``. ``int8_conv3x3_q``
takes the bf16 x and its scale and is the model's: at a Hopper shape
(``hopper_takes``: Cin a multiple of 32, Cout of 64) it launches the Hopper
kernel once (``hopper_launches``), which quantizes x in its operand load and
reads the weight packed by ``pack_weight_hopper``; at other shapes it runs
``quantize_activation`` and then ``int8_conv3x3``. The shape alone picks the
path. On a CPU tensor either entry runs its plain version (``*_ref``):
im2col and ``torch._int_mm``, then the same epilogue in eager PyTorch.
There is no fallback from a kernel to a plain version.

The quantization follows the JAX code to the bit: per output channel
``w_scale = max|k| / 127 + 1e-30`` and ``w_q = clip(round(k / w_scale),
-127, 127)``; per tensor ``x_q = clip(round(float32(x) / x_scale), -127,
127)``, with x_scale by one of three rules, which round differently
(``activation_scale``). ``torch.round`` rounds half to even, as
``jnp.round`` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from osvos_torch.ops.kernels.build import launch_stream
from osvos_torch.utils.profiling import count

# Wrapper calls that launched each kernel in this process: the mma.sync
# kernel (``int8_conv3x3``) and the Hopper kernel (``int8_conv3x3_q``).
# While a profiler runs, ``int8_conv3x3_q`` also counts its calls on the
# card by the kernel they took: ``int8.convs_hopper``, ``int8.convs_mma``.
launches = 0
hopper_launches = 0

# csrc/int8conv.cu, the mma.sync kernel: output channels a block, bytes of K
# a piece.
TILE_N = 64
PIECE = 32
# The Hopper kernel: output rows and pixels a tile row, input channels a
# chunk.
HOPPER_ROWS = 4
HOPPER_SEG = 64
HOPPER_CHUNK = 64


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w_q (Cout, Cin, 3, 3) int8, w_scale (Cout,) float32) of a float32
    OIHW weight: symmetric per output channel, the scale over (cin, kh,
    kw), IEEE division."""
    w = weight.float()
    w_scale = w.abs().amax(dim=(1, 2, 3)) / 127.0 + 1e-30
    w_q = torch.round(w / w_scale[:, None, None, None]).clamp_(-127, 127)
    return w_q.to(torch.int8), w_scale


def activation_scale(x: torch.Tensor, static: Optional[float] = None,
                     given: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 0-d float32 x_scale of ``x`` on its device, as ``_Int8Conv``:
    ``given`` (an element of a float32 ``act_scales`` operand) as
    ``float32(given) / 127`` in float32; else ``static`` (a calibrated
    Python float) as ``float32(static / 127)``, divided in float64; else
    dynamic, ``float32(max|x|) / 127 + 1e-30`` in float32."""
    if given is not None:
        return given.to(device=x.device, dtype=torch.float32) / 127.0
    if static is not None:
        return static_scales((static,), x.device)[0]
    return scale_from_max(x.abs().amax().float())


def scale_from_max(m: torch.Tensor) -> torch.Tensor:
    """The dynamic rule's x_scale of a tensor whose max|x| is the float32
    ``m``: ``m / 127 + 1e-30`` in float32."""
    return m / 127.0 + 1e-30


def static_scales(scales, device) -> torch.Tensor:
    """(len(scales),) float32 on ``device``: each calibrated Python float as
    ``float32(static / 127)``, divided in float64."""
    return torch.tensor([s / 127.0 for s in scales], dtype=torch.float32,
                        device=device)


def quantize_activation(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(float32(x) / x_scale), -127, 127)`` as int8."""
    q = x.float().div_(x_scale).round_().clamp_(-127, 127)
    return q.to(torch.int8)


def packed_width(cin: int) -> int:
    """Bytes of a packed weight row: 9 Cin and a piece of 32, rounded up to
    16."""
    return (9 * cin + PIECE + 15) // 16 * 16


def pack_weight(w_q: torch.Tensor) -> torch.Tensor:
    """The kernel's weight operand: (Cout, Cin, 3, 3) int8 as (ceil(Cout /
    64) * 64, ``packed_width(Cin)``) int8 rows, each [kh][kw][cin] from byte
    0, zero past 9 Cin and in the rows past Cout."""
    cout, cin = w_q.shape[:2]
    out = w_q.new_zeros((-(-cout // TILE_N) * TILE_N, packed_width(cin)))
    out[:cout, :9 * cin] = w_q.permute(0, 2, 3, 1).reshape(cout, 9 * cin)
    return out


def hopper_takes(cin: int, cout: int) -> bool:
    """Whether ``int8_conv3x3_q`` takes the Hopper kernel at these widths:
    every trunk conv after the stem at full width."""
    return cin % 32 == 0 and cout % 64 == 0


def hopper_tile_n(cout: int) -> int:
    """Output channels a tile of the Hopper kernel."""
    return 128 if cout % 128 == 0 else 64


def hopper_tile(t: int, n: int, h: int, w: int, cout: int):
    """(image, first row, first pixel, first channel) of the Hopper
    kernel's tile ``t``: the output-channel tile fastest, then the 64-pixel
    row segment, the group of 4 rows and the image."""
    tn = hopper_tile_n(cout)
    segs = -(-w // HOPPER_SEG)
    groups = -(-h // HOPPER_ROWS)
    t, d = divmod(t, cout // tn)
    t, seg = divmod(t, segs)
    img, grp = divmod(t, groups)
    assert img < n
    return img, grp * HOPPER_ROWS, seg * HOPPER_SEG, d * tn


def pack_weight_hopper(w_q: torch.Tensor) -> torch.Tensor:
    """The Hopper kernel's weight operand: (Cout, Cin, 3, 3) int8 as (9,
    Cout, Cin) [kh * 3 + kw][out][in], K-major for each tap."""
    cout, cin = w_q.shape[:2]
    return w_q.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()


def pack_for(w_q: torch.Tensor) -> torch.Tensor:
    """The weight operand of the kernel that ``int8_conv3x3_q`` launches at
    w_q's widths."""
    cout, cin = w_q.shape[:2]
    return pack_weight_hopper(w_q) if hopper_takes(cin, cout) else pack_weight(w_q)


def int8_conv3x3_acc_ref(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The (N, H, W, Cout) int32 accumulators: the nine taps of the
    zero-padded x_q as (N H W, 9 Cin) columns, times the weight as a (9 Cin,
    Cout) column-major matrix, by ``torch._int_mm``. On CUDA that needs N H
    W > 16 and Cin and Cout multiples of 8."""
    n, h, w, c = x_q.shape
    cout = w_q.shape[0]
    xp = F.pad(x_q, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, kh:kh + h, kw:kw + w, :]
                      for kh in range(3) for kw in range(3)], dim=-1)
    wm = w_q.permute(0, 2, 3, 1).reshape(cout, 9 * c).t()
    return torch._int_mm(cols.reshape(-1, 9 * c), wm).reshape(n, h, w, cout)


def int8_conv3x3_ref(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of ``int8_conv3x3``."""
    y = int8_conv3x3_acc_ref(x_q, w_q).float().mul_(scale).add_(bias)
    if relu:
        y = y.relu_()
    return y.to(torch.bfloat16)


def fold_max(max_out: torch.Tensor, y: torch.Tensor) -> None:
    """``max_out`` (a float32 scalar) raised in place to max|y|: for a
    ReLU'd y its max, -0.0 counted as +0.0."""
    torch.maximum(max_out, y.abs().amax().float(), out=max_out)


def int8_conv3x3_q_ref(x: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor, bias: torch.Tensor,
                       relu: bool = True,
                       max_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``int8_conv3x3_q``."""
    y = int8_conv3x3_ref(quantize_activation(x, x_scale), w_q, x_scale * w_scale,
                         bias, relu)
    if max_out is not None:
        fold_max(max_out, y)
    return y


def _check(name: str, t: torch.Tensor, shape, dtype, device,
           entry: str = "int8_conv3x3") -> None:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(
            f"{entry}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")


def int8_conv3x3(x_q: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, relu: bool = True,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """I1: the (N, H, W, Cout) bf16 output of x_q (N, H, W, Cin) int8 NHWC
    and w_q (Cout, Cin, 3, 3) int8, with float32 ``scale`` and ``bias``
    (Cout,). CPU tensors take the plain version; CUDA tensors launch the
    kernel on ``packed`` (``pack_weight(w_q)``, packed here when None)."""
    global launches
    if x_q.device.type == "cpu":
        return int8_conv3x3_ref(x_q, w_q, scale, bias, relu)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: no kernel for {x_q.device}")
    if x_q.dim() != 4 or min(x_q.shape) < 1 or w_q.dim() != 4:
        raise ValueError(f"int8_conv3x3: needs a non-empty NHWC x_q and an OIHW "
                         f"w_q; got {tuple(x_q.shape)} and {tuple(w_q.shape)}")
    n, h, w, cin = x_q.shape
    cout = w_q.shape[0]
    device = x_q.device
    _check("x_q", x_q, x_q.shape, torch.int8, device)
    _check("w_q", w_q, (cout, cin, 3, 3), torch.int8, device)
    _check("scale", scale, (cout,), torch.float32, device)
    _check("bias", bias, (cout,), torch.float32, device)
    if packed is None:
        packed = pack_weight(w_q)
    _check("packed", packed, (-(-cout // TILE_N) * TILE_N, packed_width(cin)),
           torch.int8, device)
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=device)
    with launch_stream(device) as stream:
        err = _entry()(x_q.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                       bias.data_ptr(), y.data_ptr(), n, h, w, cin, cout,
                       int(relu), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv3x3 kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def int8_conv3x3_q(x: torch.Tensor, x_scale: torch.Tensor, w_q: torch.Tensor,
                   w_scale: torch.Tensor, bias: torch.Tensor, relu: bool = True,
                   packed: Optional[torch.Tensor] = None,
                   max_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """I1 of a bf16 x (N, H, W, Cin) NHWC with its 0-d float32 ``x_scale``:
    ``int8_conv3x3(quantize_activation(x, x_scale), w_q, x_scale * w_scale,
    bias, relu)``, bit for bit. With ``max_out`` (a float32 scalar, relu
    True) the max of y is folded into it (``fold_max``). CPU tensors take
    the plain version; CUDA tensors at a Hopper shape launch the Hopper
    kernel once on ``packed`` (``pack_for(w_q)``, packed here when None),
    at other shapes quantize and launch ``int8_conv3x3``."""
    global hopper_launches
    if x.device.type == "cpu":
        return int8_conv3x3_q_ref(x, x_scale, w_q, w_scale, bias, relu, max_out)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3_q: no kernel for {x.device}")
    if x.dim() != 4 or min(x.shape) < 1 or w_q.dim() != 4:
        raise ValueError(f"int8_conv3x3_q: needs a non-empty NHWC x and an "
                         f"OIHW w_q; got {tuple(x.shape)} and {tuple(w_q.shape)}")
    n, h, w, cin = x.shape
    cout = w_q.shape[0]
    device = x.device
    entry = "int8_conv3x3_q"
    _check("x", x, x.shape, torch.bfloat16, device, entry)
    _check("x_scale", x_scale.reshape(()), (), torch.float32, device, entry)
    _check("w_q", w_q, (cout, cin, 3, 3), torch.int8, device, entry)
    _check("w_scale", w_scale, (cout,), torch.float32, device, entry)
    _check("bias", bias, (cout,), torch.float32, device, entry)
    if max_out is not None:
        _check("max_out", max_out.reshape(()), (), torch.float32, device, entry)
        if not relu:
            raise ValueError("int8_conv3x3_q: max_out needs relu=True")
    if not hopper_takes(cin, cout):
        y = int8_conv3x3(quantize_activation(x, x_scale), w_q, x_scale * w_scale,
                         bias, relu=relu, packed=packed)
        count("int8.convs_mma")
        if max_out is not None:
            fold_max(max_out, y)
        return y
    if packed is None:
        packed = pack_weight_hopper(w_q)
    _check("packed", packed, (9, cout, cin), torch.int8, device, entry)
    y = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=device)
    with launch_stream(device) as stream:
        err = _entry_q()(x.data_ptr(), x_scale.data_ptr(), packed.data_ptr(),
                         w_scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                         None if max_out is None else max_out.data_ptr(),
                         n, h, w, cin, cout, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"int8_conv3x3_q kernel launch failed: CUDA error {err}")
    hopper_launches += 1
    count("int8.convs_hopper")
    return y


@functools.lru_cache(maxsize=None)
def _entry_q():
    from osvos_torch.ops.kernels.build import load_library

    fn = load_library("int8conv").osvos_int8_conv3x3_q
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry():
    from osvos_torch.ops.kernels.build import load_library

    fn = load_library("int8conv").osvos_int8_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
