"""The two primitives of the split-precision emulations: an fp32 value as
bf16 terms, and a product run over the term pairs a kernel issues.  Shared
by tests/test_torch_ssd_split.py (#5, the SSD scan) and
tests/test_torch_ssd_bwd_split.py (#5b, its backward)."""

import torch


def terms(x, n):
    """x (fp32 values) as n bf16-valued fp32 tensors: hi, then what each
    earlier term leaves (a residual of a rounding is exact in fp32)."""
    out, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def products(a, b, eq):
    """sum over the term pairs i + j < max(len(a), len(b)) of einsum(eq,
    a_i, b_j): the products the kernel issues, each exact, summed in fp32."""
    n = max(len(a), len(b))
    acc = None
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j < n:
                z = torch.einsum(eq, x, y)
                acc = z if acc is None else acc + z
    return acc
