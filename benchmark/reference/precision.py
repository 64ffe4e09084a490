"""Products of the reference, in fp32 with TF32 off, or in a lower precision
for the control.

``Products("fp32")`` runs every matrix product and convolution in full fp32
(TF32 off for cuBLAS and cuDNN inside ``scope``). ``Products("tf32")`` rounds
both operands of each forward product to TF32 (10 mantissa bits, round to
nearest even) and accumulates in fp32, as the tensor cores' TF32 mode does;
gradients pass the rounding unchanged, so a backward pass differs through its
forward's values alone. ``Products("fp8")`` rounds both operands to fp8 e4m3
with one scale a tensor (its largest magnitude to 448), as fp8 GEMMs take
them. The rounding is explicit, so the control computes the same numbers on
the card and on the CPU.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite e4m3 value


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (ties to even), still stored as fp32."""
    bits = x.detach().float().contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0xFFF + keep) & ~0x1FFF
    return rounded.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> fp8 e4m3 under one scale that takes the largest magnitude to 448, back in fp32."""
    x = x.detach().float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Products:
    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
        self.mode = mode

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp32":
            return x
        rounded = round_tf32(x) if self.mode == "tf32" else round_fp8(x)
        return x + (rounded - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._op(a) @ self._op(b)

    def conv3x3(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return F.conv2d(self._op(x), self._op(w), b.float(), padding=1)

    @contextlib.contextmanager
    def scope(self):
        """TF32 off in cuBLAS and cuDNN, restored on exit."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
