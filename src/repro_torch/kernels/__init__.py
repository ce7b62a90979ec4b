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


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, where every kernel launches."""
    return PTR(torch.cuda.current_stream().cuda_stream)
