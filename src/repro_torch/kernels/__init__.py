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

import torch


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
