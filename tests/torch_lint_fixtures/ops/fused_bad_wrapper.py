"""KNOWN-BAD: a host sync inside a kernel wrapper's forward.

``.cpu()`` in the autograd Function that binds a hand-written kernel waits
for the launch to finish on every call. The clean wrapper beside it stays
silent.
"""

import torch


class FusedBad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x * 2
        ctx.scale = out.max().cpu()
        return out

    @staticmethod
    def backward(ctx, g):
        return g * 2


class FusedClean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * 2
