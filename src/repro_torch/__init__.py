"""PyTorch and CUDA port of the multi-chip emulation (``repro`` is the JAX
reference, which this package never imports).

Entry points take ``device=``: they run on the card (``"cuda"``) unless the
caller asks for ``"cpu"``, and they raise when no card is present instead
of continuing on the CPU.
"""

from __future__ import annotations

import torch

# The chip step's synapse product is float32.  TF32 would keep about three
# decimal digits and move spikes near threshold, so both switches are off
# whatever this PyTorch build defaults to.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise; raises if CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    return device
