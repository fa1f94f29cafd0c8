"""Device resolution for the port's entry points.

Entry points run on the card (``cuda``) unless the caller asks for the
CPU.  A request for ``cuda`` on a machine without one raises: the port
never carries on silently on the CPU.
"""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda``; returns a ``torch.device``."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but CUDA is not available (pass "
            "device='cpu' to run on the CPU)" % str(device))
    return device
