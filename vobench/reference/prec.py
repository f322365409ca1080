"""Arithmetic of the plain reference: float64, or the control's TF32.

The port computes in float32 with TF32 off (``device.setup_device``), so the
control, the reference in the program's place one precision lower, is
float32 with every matrix product's operands rounded to TF32 (10 mantissa
bits, round to nearest even) and accumulated in float32, as a tensor core
does. The rounding is emulated, so the control reads the same on the CPU
and on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (ties to even), still float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Prec(NamedTuple):
    dtype: torch.dtype
    tf32: bool

    def t(self, x) -> torch.Tensor:
        """``x`` as a tensor of this precision."""
        return torch.as_tensor(x).to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def ein(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            ops = tuple(tf32_round(o) for o in ops)
        return torch.einsum(eq, *ops)


F64 = Prec(torch.float64, False)
TF32 = Prec(torch.float32, True)
