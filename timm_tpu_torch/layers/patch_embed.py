"""Image-to-patch embedding (counterpart of timm_tpu/layers/patch_embed.py).

The public layout stays the JAX package's: NHWC images in, (B, N, C) tokens
out. Inside, the image is permuted to NCHW for ``F.conv2d`` with stride equal
to the patch size, which is what PyTorch and cuDNN do best.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .linear import compute_dtype
from .weight_init import lecun_normal_

__all__ = ['PatchEmbed']


def _pair(x: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class PatchEmbed(nn.Module):
    def __init__(
            self,
            img_size: Union[int, Tuple[int, int]] = 224,
            patch_size: Union[int, Tuple[int, int]] = 16,
            in_chans: int = 3,
            embed_dim: int = 768,
            bias: bool = True,
            dtype: Optional[torch.dtype] = None,
            generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.patch_size = _pair(patch_size)
        self.img_size = _pair(img_size)
        self.grid_size = tuple(s // p for s, p in zip(self.img_size, self.patch_size))
        self.num_patches = self.grid_size[0] * self.grid_size[1]
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size, bias=bias)
        lecun_normal_(self.proj.weight, generator=generator)
        if self.proj.bias is not None:
            nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H/p * W/p, embed_dim)."""
        if x.ndim != 4:
            raise ValueError(f'PatchEmbed takes NHWC images; got shape {tuple(x.shape)}')
        H, W = x.shape[1:3]
        if (H, W) != self.img_size:
            raise ValueError(f'Input size ({H},{W}) != model ({self.img_size})')
        ct = compute_dtype(x, self.compute_dtype, self.proj.weight)
        w = self.proj.weight.to(ct)
        b = None if self.proj.bias is None else self.proj.bias.to(ct)
        y = F.conv2d(x.to(ct).permute(0, 3, 1, 2), w, b, stride=self.patch_size)
        return y.flatten(2).transpose(1, 2)
