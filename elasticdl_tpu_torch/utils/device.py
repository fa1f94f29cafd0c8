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


def use_float32_numerics():
    """Turn TF32 off for cuDNN convs and CUDA matmuls (process-wide), so
    float32 work on the card computes in float32.  PyTorch leaves TF32
    on for float32 convs by default, which keeps about three digits."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
