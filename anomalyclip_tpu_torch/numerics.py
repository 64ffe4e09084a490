"""Numerics policy: the counterpart of ``matmul_precision_for``
(anomalyclip_tpu/models/clip/model.py:37-46).

fp32 compute means true fp32 products. On the card PyTorch runs fp32 matrix
products in full fp32 by default, but runs fp32 convolutions through cuDNN in
TF32, which keeps about three decimal digits and would hit the temporal model's
3x3 convolutions. So fp32 compute turns TF32 off for both, and restores the
previous settings on exit. bf16 compute keeps whatever is set, as the JAX
package keeps XLA's fast default.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """TF32 off for matrix products and cuDNN convolutions, inside the scope."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def matmul_precision_for(compute_dtype: torch.dtype) -> contextlib.AbstractContextManager:
    if compute_dtype == torch.float32:
        return full_fp32()
    return contextlib.nullcontext()
