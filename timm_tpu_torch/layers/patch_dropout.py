"""Patch (token) dropout (counterpart of timm_tpu/layers/patch_dropout.py).

In training mode each sample keeps ``max(1, int(L (1 - prob)))`` of its L
patch tokens, chosen by an argsort of uniform keys (the first ``num_keep``
positions of the sort), and its prefix tokens; ``ordered`` sorts the kept
indices. The count is exact and static, so the shapes do not change from
step to step and a CUDA graph holds the step.

The keys come from the model's explicit generator (``generator``, set by
``set_drop_generator`` with the drop layers'), through ``layers/recompute.py``
so that a checkpointed recompute keeps the same tokens. JAX draws them from
threefry, which torch cannot reproduce: the kept indices differ from JAX's
for the same seed. What holds instead: given the same keep indices the
outputs are equal, the keep count is exact, and the indices are a function
of the generator's state, so of (seed, step) (ROADMAP section C).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .recompute import draw

__all__ = ['PatchDropout', 'patch_keep_indices']


def patch_keep_indices(keys: torch.Tensor, num_keep: int, ordered: bool = False) -> torch.Tensor:
    """(B, num_keep) indices of the tokens kept, from (B, L) uniform keys."""
    idx = torch.argsort(keys, dim=-1)[:, :num_keep]
    return torch.sort(idx, dim=-1).values if ordered else idx


class PatchDropout(nn.Module):
    draws_masks = True  # set_drop_generator gives it the model's generator

    def __init__(self, prob: float = 0.5, num_prefix_tokens: int = 1, ordered: bool = False,
                 return_indices: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if not 0.0 <= prob < 1.0:
            raise ValueError(f'patch dropout prob {prob} is not in [0, 1)')
        self.prob = prob
        self.num_prefix_tokens = num_prefix_tokens
        self.ordered = ordered
        self.return_indices = return_indices
        self.generator = generator

    def forward(self, x: torch.Tensor):
        """(B, N, C) tokens -> (B, prefix + num_keep, C)."""
        if not self.training or self.prob == 0.0:
            return (x, None) if self.return_indices else x
        if self.generator is None:
            raise RuntimeError(
                'patch dropout in training mode needs a torch.Generator: build the model '
                'with create_model(..., seed=...) or call set_drop_generator(model, generator)')
        prefix, x = x[:, :self.num_prefix_tokens], x[:, self.num_prefix_tokens:]
        B, L = x.shape[:2]
        num_keep = max(1, int(L * (1.0 - self.prob)))
        keep_indices = draw(lambda: patch_keep_indices(
            torch.rand((B, L), generator=self.generator, device=x.device), num_keep,
            self.ordered))
        x = torch.gather(x, 1, keep_indices[..., None].expand(-1, -1, x.shape[-1]))
        if self.num_prefix_tokens:
            x = torch.cat([prefix, x], dim=1)
        return (x, keep_indices) if self.return_indices else x
