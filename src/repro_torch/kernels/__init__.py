"""Hand-written CUDA kernels for the hot spots, one directory each.

Each kernel directory holds:
  * ``csrc/*.cu`` — the kernel in CUDA C++ for ``sm_90a`` behind a plain C
    interface, built by ``_build`` with ``nvcc`` at first use and loaded
    with ``ctypes``;
  * ``ops.py``    — the public wrapper: argument checks, output allocation,
    the launch and its launch counter;
  * ``ref.py``    — the plain PyTorch version of the same function.

Dispatch rule: a wrapper runs the plain version when its tensors lie on the
CPU and launches the kernel when they lie on a CUDA device.  There is no
switch and no fallback: on a CUDA tensor the kernel runs or the call raises.
The LM kernels have no backward (``refuse_autograd``), on either device.
``stdp_slot`` has none either and refuses a gradient on the card; on the
CPU its plain version differentiates, as the JAX package's per-slot update
does (``stdp_slot.ops.stdp_slot``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# ctypes argument types of the kernels' C entry points.
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

# Element-type codes the LM kernels read and write (``dtype_code``).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_card(*tensors: torch.Tensor | None) -> bool:
    """True if the (non-None) tensors lie on one CUDA device, False if on the
    CPU; raises for mixed or other devices."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"kernel operands must share one device, got "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain version for device {device}")


_LM_ADVICE = ("the JAX package's kernel has none (ROADMAP.md queue 3); "
              "train with attention_impl='xla' or call it under "
              "torch.no_grad()")


def refuse_autograd(name: str, *tensors: torch.Tensor | None,
                    advice: str = _LM_ADVICE) -> None:
    """Raise if a call would need a gradient through kernel ``name``: grad
    mode is on and an operand requires grad.  The JAX package's Pallas
    kernels have no backward (its ``value_and_grad`` through them fails),
    and a ``ctypes`` launch would give an output without ``grad_fn``, so
    the gradient would be cut off without an error.  The plain version
    could differentiate on the CPU, but then one call would give another
    result on each device: both refuse.  Train under
    ``attention_impl="xla"``, as the JAX package does.  ``advice`` ends
    the message; it says what to do instead."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise TypeError(f"{name} has no backward: {advice}")


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' code for ``t``'s element type; raises for other types."""
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"the kernels take float32 or bfloat16, got "
                        f"{t.dtype}")
    return code


@functools.cache
def launcher(stem: str, fn: str, argtypes: tuple):
    """The C entry point ``fn`` of ``csrc/<stem>.cu`` (built at first use),
    with its argument types declared."""
    f = getattr(_build.load(stem), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


ROW_ALIGN = 16                   # bytes: the TMA and cp.async granule


def _row_layout_fault(t: torch.Tensor) -> str | None:
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return f"needs its last dim contiguous, got strides {t.stride()}"
    if any((stride * t.element_size()) % ROW_ALIGN
           for size, stride in zip(t.shape[:-1], t.stride()[:-1])
           if size > 1):
        return (f"needs strides spanning multiples of {ROW_ALIGN} bytes, "
                f"got {t.stride()}")
    if t.data_ptr() % ROW_ALIGN:
        return f"needs a {ROW_ALIGN}-byte aligned base"
    return None


def check_row_layout(t: torch.Tensor, name: str) -> None:
    """The tensor-core bodies copy rows in 16-byte pieces (TMA, cp.async):
    ``t``'s last dim must be contiguous, every other stride of a dim longer
    than 1 must span a multiple of 16 bytes (0 included), and the base must
    be 16-byte aligned.  Raises otherwise; nothing is copied to make a
    tensor fit."""
    fault = _row_layout_fault(t)
    if fault:
        raise ValueError(f"{name} {fault}")


def row_layout_ok(t: torch.Tensor) -> bool:
    """``check_row_layout``'s rule as a test, for a dispatch by layout."""
    return _row_layout_fault(t) is None


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, where every kernel launches."""
    return PTR(torch.cuda.current_stream().cuda_stream)
