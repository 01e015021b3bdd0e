"""One-pass fused AdamW + EMA update on flat buffers: a CUDA kernel written
by hand for Hopper, and its plain PyTorch version.

Port of ``timm_tpu/kernels/fused_adamw.py``. The kernel
(``csrc/fused_adamw.cu``) replaces the Pallas ``_kernel`` (its
``pallas_call`` at :120) and computes what optax's chain computes,
``scale_by_adam -> add_decayed_weights(mask) -> scale_by_learning_rate ->
apply_updates`` plus the EMA lerp, with the same rounding points as that
chain under ``jax.jit``: a bf16 first moment is multiplied by ``b1`` rounded
to bf16 (JAX's weakly typed scalar), a product that is exact in fp32 and
that XLA does not round back to bf16 before the fp32 add, the bias
corrections ``1 - b**(count+1)`` are fp32 from the pre-increment count,
``eps`` is added to ``sqrt(v'/bc2)``, and the decay term is added to the
update before ``-lr``. Device memory bounds it: it reads p, g, m, v and ema
and writes p, m, v and ema once, 36 bytes per parameter (32 with a bf16 m);
its header says how it meets that.

The buffers are flat, 1-D and padded to a multiple of 4 elements; elements
``[0, n_decay)`` take weight decay (the optimizer lays the decayed leaves
out first). p, m, v and ema are updated in place and g is read only. Two
things of the JAX train step happen here because an in-place update cannot
be selected afterwards: ``grad_scale`` (the clip factor) multiplies g, and
``ok`` (a device bool) leaves every buffer untouched when it is false. The
int32 device ``count`` is read for the bias corrections and then advanced by
one, or by ``ok``, so nothing is read back to the host.

``fused_adamw`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises ``NotImplementedError`` outside the
kernel's contract: there is no fallback. Each launch adds one to
``fused_adamw.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ._build import load_library

__all__ = ['fused_adamw', 'fused_adamw_reference']


def _consts(b1: float, b2: float, ema_decay: float):
    """The scalars as the JAX chain rounds them: Python-float differences
    rounded to fp32, b1 rounded to bf16 for a bf16 first moment, and
    1 - d taken in fp32 from the fp32 decay."""
    d = np.float32(ema_decay)
    return dict(one_minus_b1=float(np.float32(1 - b1)), one_minus_b2=float(np.float32(1 - b2)),
                b1_bf16=float(torch.tensor(b1, dtype=torch.bfloat16).float()),
                decay=float(d), one_minus_decay=float(np.float32(1) - d))


def fused_adamw_reference(p, g, m, v, ema, count, *, lr: float, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                          n_decay: int = 0, ema_decay: float = 0.0,
                          grad_scale: Optional[torch.Tensor] = None,
                          ok: Optional[torch.Tensor] = None) -> None:
    """The kernel's plain version: the same update with PyTorch ops, in
    place, one rounding per operation as in the unfused optax chain."""
    c = _consts(b1, b2, ema_decay)
    f32 = torch.float32
    gs = g if grad_scale is None else g * grad_scale.to(f32)
    count_inc = (count + 1).to(f32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32, device=p.device), count_inc)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32, device=p.device), count_inc)
    # a bf16 m meets b1 rounded to bf16; their product is exact in fp32
    b1_m = c['b1_bf16'] if m.dtype == torch.bfloat16 else b1
    bm = m.to(f32) * torch.tensor(b1_m, dtype=f32)
    m_new = torch.tensor(c['one_minus_b1'], dtype=f32) * gs + bm
    v_new = torch.tensor(c['one_minus_b2'], dtype=f32) * (gs * gs) + torch.tensor(b2, dtype=f32) * v
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + torch.tensor(eps, dtype=f32))
    if weight_decay and n_decay:
        u = torch.cat([u[:n_decay] + torch.tensor(weight_decay, dtype=f32) * p[:n_decay],
                       u[n_decay:]])
    p_new = p + torch.tensor(-lr, dtype=f32) * u
    new = [(p, p_new), (m, m_new.to(m.dtype)), (v, v_new)]
    if ema is not None:
        e_new = (ema * torch.tensor(c['decay'], dtype=f32)
                 + p_new * torch.tensor(c['one_minus_decay'], dtype=f32))
        new.append((ema, e_new))
    for old, value in new:
        old.copy_(value if ok is None else torch.where(ok, value, old))
    count.add_(1 if ok is None else ok.to(count.dtype))


@functools.cache
def _library():
    lib = load_library('fused_adamw').lib
    p, i64, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.timm_fused_adamw.argtypes = (
        [p, p, p, ctypes.c_int, p, p, i64, i64] + [f] * 10 + [p, p, p, p])
    lib.timm_fused_adamw.restype = ctypes.c_int
    lib.timm_fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.timm_fused_adamw_error_string.restype = ctypes.c_char_p
    return lib


def _check_contract(p, g, m, v, ema, count, grad_scale, ok, n_decay):
    named = dict(p=p, g=g, m=m, v=v, count=count)
    if ema is not None:
        named['ema'] = ema
    for k, t in (('grad_scale', grad_scale), ('ok', ok)):
        if t is not None:
            named[k] = t
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise NotImplementedError(
            f'fused_adamw kernel: tensors on more than one device: {sorted(map(str, devices))}')
    buffers = [('p', p), ('g', g), ('m', m), ('v', v)] + ([('ema', ema)] if ema is not None else [])
    n = p.numel()
    for k, t in buffers:
        if t.ndim != 1 or t.numel() != n or not t.is_contiguous():
            raise NotImplementedError(
                f'fused_adamw kernel takes flat contiguous buffers of one length; '
                f'{k} has shape {tuple(t.shape)} and strides {t.stride()}')
        want = m.dtype if k == 'm' else torch.float32
        if t.dtype != want or (k == 'm' and want not in (torch.float32, torch.bfloat16)):
            raise NotImplementedError(
                f'fused_adamw kernel takes fp32 p, g, v and ema with an fp32 or bf16 m; '
                f'{k} is {t.dtype}')
        if t.data_ptr() % (8 if t.dtype == torch.bfloat16 else 16):
            raise NotImplementedError(f'fused_adamw kernel: {k} is not 16-byte aligned')
    if n % 4:
        raise NotImplementedError(f'fused_adamw kernel: length {n} is not a multiple of 4')
    if not 0 <= n_decay <= n:
        raise ValueError(f'n_decay {n_decay} outside [0, {n}]')
    if count.dtype != torch.int32 or count.numel() != 1:
        raise NotImplementedError('fused_adamw kernel: count must be one int32 element')
    if grad_scale is not None and (grad_scale.dtype != torch.float32 or grad_scale.numel() != 1):
        raise NotImplementedError('fused_adamw kernel: grad_scale must be one fp32 element')
    if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1):
        raise NotImplementedError('fused_adamw kernel: ok must be one bool element')


def _check_devices_cpu(*tensors):
    if any(t is not None and t.device.type != 'cpu' for t in tensors):
        raise NotImplementedError('fused_adamw: p is on the CPU and another buffer is not')


def _launch(p, g, m, v, ema, count, lr, b1, b2, eps, weight_decay, n_decay, ema_decay,
            grad_scale, ok):
    c = _consts(b1, b2, ema_decay)
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.timm_fused_adamw(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), int(m.dtype == torch.bfloat16),
            v.data_ptr(), None if ema is None else ema.data_ptr(),
            p.numel(), n_decay if weight_decay else 0,
            lr, b1, c['one_minus_b1'], c['b1_bf16'], b2, c['one_minus_b2'], eps, weight_decay,
            c['decay'], c['one_minus_decay'], count.data_ptr(),
            None if grad_scale is None else grad_scale.data_ptr(),
            None if ok is None else ok.data_ptr(), stream)
    if rc != 0:
        reason = 'bad arguments' if rc < 0 else lib.timm_fused_adamw_error_string(rc).decode()
        raise RuntimeError(f'fused_adamw kernel launch failed ({rc}): {reason}')
    fused_adamw.launches += 1
    count.add_(1 if ok is None else ok.to(count.dtype))


def fused_adamw(p, g, m, v, ema, count, *, lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0, n_decay: int = 0,
                ema_decay: float = 0.0, grad_scale: Optional[torch.Tensor] = None,
                ok: Optional[torch.Tensor] = None) -> None:
    """AdamW (+ EMA when ``ema`` is given) over flat buffers, in place."""
    n_decay = int(n_decay)
    if p.device.type == 'cpu':
        _check_devices_cpu(p, g, m, v, ema, count)
        return fused_adamw_reference(
            p, g, m, v, ema, count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            n_decay=n_decay, ema_decay=ema_decay, grad_scale=grad_scale, ok=ok)
    if p.device.type != 'cuda':
        raise NotImplementedError(f'fused_adamw runs on cuda or cpu tensors; got {p.device}')
    _check_contract(p, g, m, v, ema, count, grad_scale, ok, n_decay)
    _launch(p, g, m, v, ema, count, float(lr), float(b1), float(b2), float(eps),
            float(weight_decay), n_decay, float(ema_decay), grad_scale, ok)


fused_adamw.launches = 0
