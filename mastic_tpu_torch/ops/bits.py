"""32-bit words on torch's signed carriers.

torch's uint32 tensors lack `>>`, `<<`, `+`, `<` and `~` on the CPU, so
the port carries every 32-bit word (AES bit planes, packed masks,
Keccak lane halves, field limbs) as int32 with the same bit pattern,
and every 64-bit Keccak lane as int64.  `^`, `&`, `|`, `~` and `<<`
are bit-exact on both; right shifts here are logical.  The plain
versions and the CUDA kernels use the same carriers, so a tensor goes
to a kernel as it is (the kernel reads int32 as uint32)."""

import torch

I32 = torch.int32
I64 = torch.int64


def shr64(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int64 lanes by n in 0..63 (int or a
    tensor of shift amounts)."""
    if isinstance(n, int):
        if n == 0:
            return x
        return (x >> n) & ((1 << (64 - n)) - 1)
    mask = torch.where(n == 0, torch.full_like(n, -1),
                       (torch.ones_like(n) << (64 - n)) - 1)
    return (x >> n) & mask


def rotl64(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rotate int64 lanes left by a static n."""
    n %= 64
    if n == 0:
        return x
    return (x << n) | shr64(x, 64 - n)
