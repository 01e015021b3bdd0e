"""Image-to-patch embedding (counterpart of timm_tpu/layers/patch_embed.py).

The public layout stays the JAX package's: NHWC images in, (B, N, C) tokens
out. Inside, the image is permuted to NCHW for ``F.conv2d`` with stride equal
to the patch size, which is what PyTorch and cuDNN do best.

``resample_patch_embed`` resizes a patch projection kernel to another patch
size as the JAX package does, with ``jax.image.resize(method='cubic',
antialias=True)``: Keys' cubic kernel with a = -0.5, widened by the
down-sampling factor when the size shrinks, each output's weights
renormalised to sum to one (no edge clamping). ``F.interpolate``'s bicubic
uses a = -0.75 and clamps the edges, so it computes something else. The
(P', P) weight matrices are built once per (P, P') in numpy from JAX's
formula and applied by ``einsum``, so the resize stays differentiable and
can sit inside a captured step while the kernel changes every step.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .linear import compute_dtype
from .weight_init import lecun_normal_

__all__ = ['PatchEmbed', 'resample_patch_embed', 'resample_weight_matrix']


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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 on |x| (jax.image)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def _weight_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    # jax.image's compute_weight_mat in fp32, with scale = out / in and no
    # translation
    f32 = np.float32
    inv_scale = f32(1.0) / f32(out_size / in_size)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _keys_cubic(x.astype(f32)).astype(f32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def resample_weight_matrix(in_size: int, out_size: int) -> torch.Tensor:
    """The (in_size, out_size) fp32 matrix of a 1-d cubic antialiased resize,
    JAX's ``compute_weight_mat``: output j = sum_i x[i] w[i, j]."""
    return torch.from_numpy(_weight_matrix_np(int(in_size), int(out_size)))


def resample_patch_embed(weight: torch.Tensor, new_size: Sequence[int]) -> torch.Tensor:
    """Resize a patch projection kernel's two spatial dims to ``new_size``:
    a Linear's weight over (P, P, C)-flattened patches viewed as (O, P, P,
    C). The resize is in the kernel's dtype, as JAX's."""
    old = weight.shape[1:3]
    if tuple(old) == tuple(new_size):
        return weight
    wh = resample_weight_matrix(old[0], new_size[0]).to(device=weight.device, dtype=weight.dtype)
    ww = resample_weight_matrix(old[1], new_size[1]).to(device=weight.device, dtype=weight.dtype)
    return torch.einsum('ohwi,ha,wb->oabi', weight, wh, ww)
