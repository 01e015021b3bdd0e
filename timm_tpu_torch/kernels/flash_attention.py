"""Flash attention on (B, H, N, D) tensors: a CUDA kernel written by hand for
Hopper, and its plain PyTorch version.

Port of ``timm_tpu/kernels/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces the Pallas ``_fwd_kernel`` and keeps
its rounding points; its header says what bounds it on an H100. Unlike the
JAX package, where the Pallas kernel is opt-in, the kernel *is* the attention
of the port whenever the tensors are on a CUDA device.

The input contract is the JAX one: an optional bool key-padding mask of shape
(B, N) or (B, 1, 1, N), True = valid key; any other mask raises, because the
kernel would silently drop its structure. Multi-head attention only (q, k and
v of one shape), D <= 256; the kernel is built for D in ``KERNEL_HEAD_DIMS``
and bf16, fp16 or fp32.

``flash_attention`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises: there is no fallback. Each kernel
launch adds one to ``flash_attention.launches``.

Gradients: ``flash_attention`` is a ``torch.autograd.Function``. Its
backward is the JAX package's ``_flash_bwd_rule``
(``timm_tpu/kernels/flash_attention.py:161-177``) written in PyTorch: an
exact fp32 recompute of the scores and softmax from the saved q, k, v and
key mask, then dv, dp, ds, dq and dk, each cast to its input's dtype. The
JAX package computes that backward outside any Pallas kernel too (XLA under
``jax.custom_vjp``), so on the card it runs as plain PyTorch here; a
hand-written backward kernel is later speed work.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library

__all__ = ['KERNEL_HEAD_DIMS', 'flash_attention', 'flash_attention_backward',
           'flash_attention_reference', 'kernel_smem_bytes']

KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def flash_attention_reference(q, k, v, mask=None, scale: Optional[float] = None):
    """The kernel's plain version: ``_sdpa`` of the port's attention layer,
    which mirrors the JAX ``_sdpa`` (q*scale in the source dtype, scores,
    mask with the dtype's min, fp32 softmax cast back, product with v)."""
    from ..layers.attention import _sdpa
    return _sdpa(q, k, v, attn_mask=mask, scale=scale)


def _key_padding_mask(q, k, mask):
    """Validate ``mask`` as the JAX wrapper does and return it as (B, Nk)."""
    if mask is None:
        return None
    B, Nk = q.shape[0], k.shape[2]
    if mask.dtype != torch.bool:
        raise ValueError(
            f'flash_attention only supports bool key-padding masks; got dtype {mask.dtype}. '
            'Additive float masks must use the plain attention path.')
    if tuple(mask.shape) not in ((B, Nk), (B, 1, 1, Nk)):
        raise ValueError(
            f'flash_attention only supports key-padding masks of shape {(B, Nk)} or '
            f'{(B, 1, 1, Nk)}; got {tuple(mask.shape)}. Per-query attention masks would be '
            'silently collapsed to their first query row.')
    return mask[:, 0, 0, :] if mask.ndim == 4 else mask


@functools.cache
def _library():
    """The built kernel library with its C signatures declared (once)."""
    lib = load_library('flash_attention').lib
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.timm_flash_attention_fwd.argtypes = (
        [ctypes.c_int, ctypes.c_int] + [p] * 5 + [ctypes.c_int] * 3
        + [i64] * 13 + [ctypes.c_float, p])
    lib.timm_flash_attention_fwd.restype = ctypes.c_int
    lib.timm_flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.timm_flash_attention_smem_bytes.restype = ctypes.c_longlong
    lib.timm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.timm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory one thread block of the kernel takes (builds the
    library if needed)."""
    return int(_library().timm_flash_attention_smem_bytes(_DTYPE_CODES[dtype], head_dim))


def _vector_aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors along D: the last dimension must be
    contiguous and every row must start on a 16-byte boundary. Strided views
    that meet this (the q/k/v of a fused qkv projection) pass as they are."""
    es = t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            (s * es) % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(q, k, v, key_mask, scale: float):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f'flash_attention kernel takes bf16, fp16 or fp32 q/k/v of one dtype; '
            f'got {q.dtype}, {k.dtype}, {v.dtype}')
    B, H, N, D = q.shape
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f'flash_attention kernel is built for head dims {KERNEL_HEAD_DIMS}; got {D}')
    q, k, v = (_vector_aligned(t) for t in (q, k, v))
    # (B, N, H, D) storage viewed as (B, H, N, D): the caller's merge of the
    # heads back into (B, N, H*D) is then a view, not a copy
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    mask_ptr, mask_sb = None, 0
    if key_mask is not None:
        key_mask = key_mask.to(device=q.device).contiguous()
        mask_ptr, mask_sb = key_mask.data_ptr(), key_mask.stride(0)
    scale_t = torch.tensor(scale, dtype=q.dtype).item()  # the TPU kernel rounds scale to q's dtype
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.timm_flash_attention_fwd(
            _DTYPE_CODES[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            B, H, N,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            mask_sb, scale_t, stream)
    if rc != 0:
        reason = 'unsupported dtype/head dim' if rc < 0 else \
            lib.timm_cuda_error_string(rc).decode()
        raise RuntimeError(f'flash_attention kernel launch failed ({rc}): {reason}')
    flash_attention.launches += 1
    return out


def flash_attention_backward(q, k, v, key_mask, scale: float, grad_out):
    """``_flash_bwd_rule`` of the JAX package: dq, dk, dv from an fp32
    recompute of the attention, each cast to its input's dtype."""
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    s = qf @ kf.transpose(-2, -1)
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    gf = grad_out.float()
    dv = p.transpose(-2, -1) @ gf
    dp = gf @ vf.transpose(-2, -1)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = (ds @ kf) * scale
    dk = ds.transpose(-2, -1) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        if q.device.type == 'cpu':
            return flash_attention_reference(
                q, k, v, None if key_mask is None else key_mask[:, None, None, :], scale)
        return _launch(q, k, v, key_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask = ctx.saved_tensors
        # a named range, so a profiler trace can attribute the recompute's kernels
        with torch.profiler.record_function('flash_attention_backward'):
            dq, dk, dv = flash_attention_backward(q, k, v, key_mask, ctx.scale, grad_out)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask=None, scale: Optional[float] = None):
    """(B, H, N, D) attention with an optional bool key-padding mask."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    key_mask = _key_padding_mask(q, k, mask)
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f'flash_attention is multi-head attention only: q, k, v of one (B, H, N, D) '
            f'shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    if q.shape[-1] > 256:
        raise ValueError(f'flash_attention takes head dims up to 256; got {q.shape[-1]}')
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f'q, k, v on different devices: {sorted(map(str, devices))}')
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'flash_attention runs on cuda or cpu tensors; got {q.device}')
    if key_mask is not None:
        key_mask = key_mask.to(device=q.device)
    return _FlashAttention.apply(q, k, v, key_mask, scale)


flash_attention.launches = 0
