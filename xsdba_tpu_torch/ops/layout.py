"""Layout helper of the JAX package's regular-period fast paths.

No module of either package calls it; it is kept for the import path.
"""

from __future__ import annotations

import torch

from ..utils.tensor import as_tensor

__all__ = ["aligned_swap_last2"]


def aligned_swap_last2(x, pad_a: int, pad_b: int):
    """Swap the last two axes, ``[..., A, B] -> [..., B, A]``.

    The JAX package pads both axes to (``pad_a``, ``pad_b``) multiples first
    so that XLA lowers the transpose as a layout change, and crops after it:
    the padding is a layout detail and never reaches the result.  A PyTorch
    transpose needs no padding, so the multiples are accepted and only
    checked; the result is a new contiguous tensor equal to the JAX
    function's output.
    """
    if pad_a < 1 or pad_b < 1:
        raise ValueError(f"pad multiples must be positive, got ({pad_a}, {pad_b})")
    return torch.swapaxes(as_tensor(x), -1, -2).contiguous()
