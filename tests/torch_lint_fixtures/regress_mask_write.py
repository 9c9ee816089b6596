"""REGRESSION: the indexed mask write that waited for the card.

The dense loss on the MoCo queue's path once cleared its self-contrast
mask with ``logits_mask[i, i] = 0`` for a device index ``i``: an
``index_put_`` of a host scalar, which waits for the card on every step.
The port now clears it through a diagonal view.
"""

import torch


class QueueRecipe:
    def loss(self, cfg, ctx):
        n = ctx.n_fea.shape[0]
        logits_mask = torch.ones(n, n, device=ctx.n_fea.device)
        i = torch.arange(n, device=ctx.n_fea.device)
        logits_mask[i, i] = 0
        return (ctx.n_fea @ ctx.n_fea.T * logits_mask).mean(), {}
