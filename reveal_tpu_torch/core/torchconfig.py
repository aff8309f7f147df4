"""PyTorch runtime configuration: the port's counterpart of
``reveal_tpu/core/jaxconfig.py``.

Device choice is always explicit.  ``resolve_device("cuda")`` requires a
card and raises without one; it never quietly picks the CPU.  The CPU is
chosen only by naming it, which is what the tests do.

Integer policy: every device array of the recursion (text, SA, LCP,
segment ids, tables, anchors) is int32, as in the JAX package with x64
off, so arithmetic wraps the same way in both frameworks.  ``torch``
promotes some integer reductions to int64 (``cumsum``, ``sum``); the
port passes ``dtype=INDEX_DTYPE`` where the value is stored back.

Floating point: the slice is integer-only, but float32 matrix products and
convolutions are pinned to full float32 (no TF32) so later float kernels
compare against a stated reference.
"""

from __future__ import annotations

import torch

INDEX_DTYPE = torch.int32


def configure_torch() -> None:
    """Pin float32 matmul/convolution precision (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name) -> torch.device:
    """Map a device name to a ``torch.device``.

    ``"cuda"`` (or ``"cuda:N"``) raises ``RuntimeError`` when no CUDA
    device is visible; ``"cpu"`` must be asked for by name."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False (torch %s); pass device='cpu' to run the plain "
                "torch path on the CPU" % (str(name), torch.__version__)
            )
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (cuda or cpu)" % str(name))
    configure_torch()
    return dev
