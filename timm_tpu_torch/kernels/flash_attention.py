"""Flash attention on (B, H, N, D) tensors: a CUDA kernel written by hand for
Hopper, and its plain PyTorch version.

Port of ``timm_tpu/kernels/flash_attention.py``. The kernel
(``csrc/flash_attention.cu``) replaces the Pallas ``_fwd_kernel``. Unlike the
JAX package, where the Pallas kernel is opt-in, the kernel *is* the attention
of the port whenever the tensors are on a CUDA device.

For bf16 and fp16 it is a register-resident design: each warp owns 16 query
rows, both products run on ``mma.sync`` with S, P and the fp32 accumulator
in registers, and K/V tiles arrive through a ``cp.async`` ring (3 stages at
D <= 64, 2 above) with one barrier a tile. fp32 inputs take a separate
shared-memory kernel with CUDA-core FMAs (no TF32), chosen by dtype. The
least time on an H100 is device memory's: at ViT-B/16's N = 197, D = 64 the
function does some 98 operations a byte, under the tensor cores' ~295; what
holds the kernel above that is latency (2 blocks of 8 warps an SM) more than
any one unit. e^x is computed as 2^(x log2 e) on the special-function unit.

Rounding. It keeps the TPU kernel's rounding points: q * scale rounded to
the input type before the first product, fp32 scores, -1e30 for masked keys
and the ragged tail beyond N, p rounded to v's type, and acc / max(l, 1e-30)
rounded to q's type. Where p is rounded differs: the TPU kernel takes one key
block of min(512, max(128, next_pow2(N))) keys, so for N <= 512 it rounds p
against the row's final max; this kernel walks keys in tiles of 64 (32 at
D = 256) and rounds p against the running max, rescaling the fp32 sum
afterwards, because a warp holds a tile's scores in registers and the whole
key range would leave none for the accumulator. Both stay within the 2e-2
parity tolerance. A query row whose keys are all masked comes out as the
TPU kernel gives it: every key slot of its padded key range gets p = 1, so
the row is the sum of v over the N keys divided by round_up(N, block_k),
block_k = min(512, max(128, next_pow2(N))). The kernel computes fewer slots
and divides such a row by that count in its epilogue; the plain version
puts the same value in place of ``_sdpa``'s mean of v. Neither the ViT
token pad nor a NaFlex batch produces such a row (a class token, or a
sample's first patch, is always a valid key); NaFlexVit's 'symmetric' mask
is run as this kernel's key-padding mask, and its padded query rows are
then overwritten with JAX's value by the attention layer
(``layers/attention.py``).

The input contract is the JAX one: an optional bool key-padding mask of shape
(B, Nk) or (B, 1, 1, Nk), True = valid key; any other mask raises, because
the kernel would silently drop its structure. Multi-head attention: q is
(B, H, Nq, D) and k, v are (B, H, Nk, D), where Nq and Nk may differ (the
'map' pool's latent queries attend to the N tokens), as the TPU kernel's
wrapper pads queries and keys apart. The head dim is any multiple of 8 up
to 256, as the ViT family needs (so400m's 72, ViT-H/14's 80): the kernel is
built for the padded dims ``KERNEL_HEAD_DIMS`` and runs a head dim on the
smallest of them that holds it, zero-filling the pad columns in shared
memory (``kernel_head_dim``); no padded copy is made in Python. bf16, fp16
or fp32.

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
           'flash_attention_reference', 'kernel_head_dim', 'kernel_smem_bytes', 'tpu_key_slots']

# the padded head dims the kernel is built for (csrc/flash_attention.cu
# padded_head_dim)
KERNEL_HEAD_DIMS = (32, 48, 64, 80, 96, 128, 160, 192, 256)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def kernel_head_dim(d: int) -> Optional[int]:
    """The padded head dim the kernel runs a head dim ``d`` on, or None
    where it takes no such ``d`` (not a multiple of 8 up to 256)."""
    if d <= 0 or d % 8 or d > 256:
        return None
    return next(dp for dp in KERNEL_HEAD_DIMS if d <= dp)


def tpu_key_slots(n: int) -> int:
    """The key slots the TPU kernel computes for ``n`` keys: n rounded up
    to its key block, min(512, max(128, next_pow2(n)))."""
    block = min(512, max(128, 1 << (n - 1).bit_length()))
    return -(-n // block) * block


def flash_attention_reference(q, k, v, mask=None, scale: Optional[float] = None):
    """The kernel's plain version: ``_sdpa`` of the port's attention layer,
    which mirrors the JAX ``_sdpa`` (q*scale in the source dtype, scores,
    mask with the dtype's min, fp32 softmax cast back, product with v),
    with the TPU kernel's value where a batch row's keys are all masked:
    the fp32 sum of v over the keys over ``tpu_key_slots(N)``."""
    from ..layers.attention import _sdpa
    # the kernel keeps an fp32 softmax whatever the softmax policy says
    out = _sdpa(q, k, v, attn_mask=mask, scale=scale, softmax_dtype=torch.float32)
    if mask is None:
        return out
    dead = ~mask.reshape(mask.shape[0], -1).any(dim=-1)
    fill = (v.float().sum(dim=-2, keepdim=True) / tpu_key_slots(k.shape[-2])).to(out.dtype)
    return torch.where(dead.view(-1, 1, 1, 1), fill, out)


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
        [ctypes.c_int, ctypes.c_int] + [p] * 5 + [ctypes.c_int] * 4
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


@functools.lru_cache(maxsize=None)
def _rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to q's dtype, as the TPU kernel rounds it."""
    return torch.tensor(scale, dtype=dtype).item()


def _launch(q, k, v, key_mask, scale: float):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise NotImplementedError(
            f'flash_attention kernel takes bf16, fp16 or fp32 q/k/v of one dtype; '
            f'got {q.dtype}, {k.dtype}, {v.dtype}')
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if kernel_head_dim(D) is None:
        raise NotImplementedError(
            f'flash_attention kernel takes head dims that are multiples of 8 up to 256; got {D}')
    q, k, v = (_vector_aligned(t) for t in (q, k, v))
    # (B, Nq, H, D) storage viewed as (B, H, Nq, D): the caller's merge of the
    # heads back into (B, Nq, H*D) is then a view, not a copy
    out = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    mask_ptr, mask_sb = None, 0
    if key_mask is not None:
        key_mask = key_mask.to(device=q.device).contiguous()
        mask_ptr, mask_sb = key_mask.data_ptr(), key_mask.stride(0)
    scale_t = _rounded_scale(scale, q.dtype)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.timm_flash_attention_fwd(
            _DTYPE_CODES[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            B, H, Nq, Nk,
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
    recompute of the attention, each cast to its input's dtype. The (B, H,
    N, N) fp32 scores are freed as soon as p exists and ds is formed in dp's
    storage, so at most three such tensors are alive at once (1.8 GB each
    at B 36, N 1024); the values are those of the out-of-place chain."""
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    s = qf @ kf.transpose(-2, -1)
    if key_mask is not None:
        s.masked_fill_(~key_mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    del s
    gf = grad_out.float()
    dv = p.transpose(-2, -1) @ gf
    dp = gf @ vf.transpose(-2, -1)
    ds = dp.sub_(torch.sum(dp * p, dim=-1, keepdim=True)).mul_(p)
    del dp
    dq = (ds @ kf) * scale
    dk = ds.transpose(-2, -1) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, key_mask, scale: float):
    if q.device.type == 'cpu':
        return flash_attention_reference(
            q, k, v, None if key_mask is None else key_mask[:, None, None, :], scale)
    return _launch(q, k, v, key_mask, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        ctx.save_for_backward(q, k, v, key_mask)
        ctx.scale = scale
        return _forward(q, k, v, key_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask = ctx.saved_tensors
        # a named range, so a profiler trace can attribute the recompute's kernels
        with torch.profiler.record_function('flash_attention_backward'):
            dq, dk, dv = flash_attention_backward(q, k, v, key_mask, ctx.scale, grad_out)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask=None, scale: Optional[float] = None):
    """(B, H, Nq, D) queries over (B, H, Nk, D) keys and values, with an
    optional bool key-padding mask of shape (B, Nk) or (B, 1, 1, Nk)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4
            or (k.shape[0], k.shape[1], k.shape[3]) != (q.shape[0], q.shape[1], q.shape[3])):
        raise ValueError(
            f'flash_attention is multi-head attention only: q (B, H, Nq, D), k and v '
            f'(B, H, Nk, D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    key_mask = _key_padding_mask(q, k, mask)
    if q.shape[-1] > 256:
        raise ValueError(f'flash_attention takes head dims up to 256; got {q.shape[-1]}')
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f'q, k, v on different devices: {sorted(map(str, devices))}')
    if q.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'flash_attention runs on cuda or cpu tensors; got {q.device}')
    if key_mask is not None:
        key_mask = key_mask.to(device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, key_mask, scale)
    # no gradient asked for: the same forward without the autograd node's
    # host time (tens of microseconds, more than the kernel at bucket 1)
    return _forward(q, k, v, key_mask, scale)


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# registry entry: the JAX registry's cases, then the main path's


def _registry_inputs(seed: int = 0, device='cuda', batch: int = 2, heads: int = 2,
                     seq: int = 576, head_dim: int = 64, valid_frac: Optional[float] = 0.8,
                     valid: Optional[int] = None, dtype: str = 'float32',
                     seq_k: Optional[int] = None):
    """q (B, H, seq, D), k and v (B, H, seq_k, D) (seq_k defaults to seq)
    as the JAX registry draws them (standard normal times 0.5, from one
    numpy generator) and a (B, 1, 1, seq_k) key-padding mask: with
    ``valid``, that many valid keys in every row; else with ``valid_frac``
    the JAX registry's prefix of int(seq_k * valid_frac) - 8 i keys in row
    i; with neither, no mask."""
    import numpy as np
    rng = np.random.default_rng(seed)
    seq_k = seq if seq_k is None else seq_k
    shapes = [(batch, heads, n, head_dim) for n in (seq, seq_k, seq_k)]
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32))
               .to(device=device, dtype=getattr(torch, dtype)) for shape in shapes)
    mask = None
    if valid is not None or valid_frac is not None:
        rows = [valid if valid is not None else max(1, int(seq_k * valid_frac) - 8 * i)
                for i in range(batch)]
        mask = torch.from_numpy(np.arange(seq_k)[None, :] < np.asarray(rows)[:, None])
        mask = mask.view(batch, 1, 1, seq_k).to(device)
    return dict(q=q, k=k, v=v, mask=mask)


def _registry_flops(q, k, v, mask):
    """4 keys D operations per query row (two products), over the keys
    this mask keeps, in the inputs' type."""
    B, H, Nq, D = q.shape
    keys = B * k.shape[2] if mask is None else int(mask.sum())
    return 4 * H * Nq * keys * D, str(q.dtype).replace('torch.', '')


# bits of relative precision of the input's type, which the scores (in the
# plain version), p and the output are rounded to; and what covers
# ex2.approx, the fp32 sums and second-order terms beyond them
_PRECISION_BITS = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
_BOUND_SLACK = 1e-4


def _registry_error_bound(out, q, k, v, mask):
    """How far the kernel may stand from the plain version, per element, to
    first order. With e = 2^-bits of the input's type: the plain version
    rounds the scores to that type, each within e/2 of |s|, which moves p
    by up to e max|s| relative (max over the row's valid keys); both round
    p, each within e/2 relative, and the output, each within e/2 |o|. So
    |kernel - plain| <= e ((1 + max|s|) softmax-weighted |v| + |o|) plus
    the slack. Scaled to each output, it holds the kernel far tighter than
    the one parity_tol, which at the long masked cases is about the size of
    a typical output."""
    qf, kf = q.float(), k.float()
    s = (qf * q.shape[-1] ** -0.5) @ kf.transpose(-2, -1)
    if mask is not None:
        s = s.masked_fill(~mask, 0.0)
    s_max = s.abs().amax(dim=-1, keepdim=True)
    del s
    pv_abs = flash_attention_reference(qf, kf, v.float().abs(), mask=mask)
    return 2.0 ** -_PRECISION_BITS[q.dtype] * ((1 + s_max) * pv_abs + out.float().abs()) \
        + _BOUND_SLACK


def _registry_library(q, k, v, mask):
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _register():
    from .registry import KernelCase, KernelSpec, register
    vit = dict(heads=12, seq=197, head_dim=64, valid_frac=None)
    register(KernelSpec(
        name='flash_attention',
        module=__name__,
        regime='every attention of the port on the card: ViT-B/16 serving buckets (N 197, '
               'D 64, bf16 or fp16), key-padding-masked N in {128, 256, 576, 784, 1024} '
               '(the NaFlex buckets), and the ViT family\'s head dims (so400m 72 on 80, '
               'ViT-H/14 80) with the map pool\'s Nq 1 over Nk 256',
        gate='beat the plain attention at every declared case on the card, or be deleted; '
             'the library call is timed beside it and decides nothing',
        parity_tol=2e-2,
        kernel_fn=flash_attention,
        reference_fn=flash_attention_reference,
        make_inputs=_registry_inputs,
        flops=_registry_flops,
        library_fn=_registry_library,
        error_bound=_registry_error_bound,
        cases=(
            KernelCase(name='masked_n576',
                       dry=dict(batch=2, heads=2, seq=576, head_dim=64),
                       live=dict(batch=16, heads=12, seq=576, head_dim=64, dtype='bfloat16'),
                       desc='NaFlex 384px/16 packed bucket (JAX registry)'),
            KernelCase(name='masked_n784',
                       dry=dict(batch=1, heads=2, seq=784, head_dim=64),
                       live=dict(batch=16, heads=12, seq=784, head_dim=64, dtype='bfloat16'),
                       desc='NaFlex 448px/16 packed bucket (JAX registry)'),
            KernelCase(name='masked_n1024',
                       dry=dict(batch=1, heads=1, seq=1024, head_dim=64),
                       live=dict(batch=16, heads=12, seq=1024, head_dim=64, dtype='bfloat16'),
                       desc='NaFlex max packed bucket (JAX registry)'),
            KernelCase(name='vit_b16_bucket64',
                       dry=dict(batch=2, heads=2, seq=197, head_dim=64, valid_frac=None,
                                dtype='bfloat16'),
                       live=dict(batch=64, **vit, dtype='bfloat16'),
                       desc='ViT-B/16 serving bucket 64, the main path'),
            KernelCase(name='vit_b16_bucket64_fp16',
                       dry=dict(batch=2, heads=2, seq=197, head_dim=64, valid_frac=None,
                                dtype='float16'),
                       live=dict(batch=64, **vit, dtype='float16'),
                       desc='the same in fp16'),
            KernelCase(name='vit_b16_bucket1',
                       dry=dict(batch=1, heads=2, seq=197, head_dim=64, valid_frac=None,
                                dtype='bfloat16'),
                       live=dict(batch=1, **vit, dtype='bfloat16'),
                       desc='serving bucket 1: a grid under one wave of blocks'),
            KernelCase(name='keypad_n256',
                       dry=dict(batch=2, heads=2, seq=256, head_dim=64, valid=197,
                                dtype='bfloat16'),
                       live=dict(batch=64, heads=12, seq=256, head_dim=64, valid=197,
                                 dtype='bfloat16'),
                       desc='197 tokens padded to 256 with a key-padding mask'),
            # the NaFlex train step's own shapes, naflexvit_base_patch16_gap at a
            # budget of 36,864 tokens; every row keeps the mean valid count the
            # NaFlex loader gives the seeded 96-640 px images of chip_smoke.py
            # at that bucket (0.972 of 128, 0.989 of 1024)
            KernelCase(name='naflex_n128',
                       dry=dict(batch=2, heads=2, seq=128, head_dim=64, valid=124,
                                dtype='bfloat16'),
                       live=dict(batch=288, heads=12, seq=128, head_dim=64, valid=124,
                                 dtype='bfloat16'),
                       desc='NaFlex train bucket 128 (B 288), key-padded'),
            # its dry arm is fp32, as the JAX registry's masked dry arms are: in
            # bf16 at 1013 valid keys the per-element bound is 0.29 of the mean
            # |output| (the softmax-weighted |v| it scales with does not shrink
            # with N as the output does)
            KernelCase(name='naflex_n1024',
                       dry=dict(batch=1, heads=1, seq=1024, head_dim=64, valid=1013),
                       live=dict(batch=36, heads=12, seq=1024, head_dim=64, valid=1013,
                                 dtype='bfloat16'),
                       desc='NaFlex train bucket 1024 (B 36), key-padded'),
            # the ViT family's head dims beyond the four of the first design:
            # vit_so400m_patch14_siglip_224 (16 heads of 72 on the kernel's
            # padded 80, 256 tokens) at its serving bucket 64, its 'map' pool's
            # single latent query over the 256 tokens, and ViT-H/14 (80)
            KernelCase(name='so400m_b64',
                       dry=dict(batch=2, heads=2, seq=40, head_dim=72, valid_frac=None,
                                dtype='bfloat16'),
                       live=dict(batch=64, heads=16, seq=256, head_dim=72, valid_frac=None,
                                 dtype='bfloat16'),
                       desc='vit_so400m_patch14_siglip_224 serving bucket 64, D 72'),
            KernelCase(name='so400m_map_pool',
                       dry=dict(batch=2, heads=2, seq=1, seq_k=40, head_dim=72, valid_frac=None,
                                dtype='bfloat16'),
                       live=dict(batch=64, heads=16, seq=1, seq_k=256, head_dim=72,
                                 valid_frac=None, dtype='bfloat16'),
                       desc="so400m's 'map' pool: 1 latent query over 256 keys (Nq != Nk)"),
            KernelCase(name='vit_h14_b64',
                       dry=dict(batch=2, heads=2, seq=37, head_dim=80, valid_frac=None,
                                dtype='bfloat16'),
                       live=dict(batch=64, heads=16, seq=257, head_dim=80, valid_frac=None,
                                 dtype='bfloat16'),
                       desc='vit_huge_patch14_224 bucket 64, D 80 (257 tokens, a ragged tile)'),
        ),
    ))


_register()
