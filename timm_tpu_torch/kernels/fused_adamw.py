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
one, or by ``ok``, so nothing is read back to the host. ``lr`` and
``ema_decay`` are one-element fp32 tensors on the buffers' device, read by
the kernel when it runs, as the TPU kernel reads them from SMEM: a CUDA
graph that captured the launch takes whatever the host wrote into them
before each replay (the optimizer owns them, ``optim/_optimizers.py``). A
Python float is taken too and copied to the device first, for eager calls;
under a graph capture that copy raises rather than baking the value in.
1 - decay is formed in fp32 from the fp32 decay.

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


def _bf16(x: float) -> float:
    """x rounded to bf16 (to nearest, ties to even), on the host."""
    bits = int(np.float32(x).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


def _consts(b1: float, b2: float):
    """The optimizer's constants as the JAX chain rounds them: Python-float
    differences rounded to fp32, and b1 rounded to bf16 for a bf16 first
    moment."""
    return dict(one_minus_b1=float(np.float32(1 - b1)), one_minus_b2=float(np.float32(1 - b2)),
                b1_bf16=_bf16(b1))


def _scalar(x, device) -> torch.Tensor:
    """A run-time scalar as a one-element fp32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def fused_adamw_reference(p, g, m, v, ema, count, *, lr, b1: float = 0.9,
                          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
                          n_decay: int = 0, ema_decay=0.0,
                          grad_scale: Optional[torch.Tensor] = None,
                          ok: Optional[torch.Tensor] = None) -> None:
    """The kernel's plain version: the same update with PyTorch ops, in
    place, one rounding per operation as in the unfused optax chain; lr
    and ema_decay are read from their tensors as the kernel reads them."""
    c = _consts(b1, b2)
    f32 = torch.float32
    lr = _scalar(lr, p.device).reshape(())
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
    p_new = p + torch.neg(lr) * u
    new = [(p, p_new), (m, m_new.to(m.dtype)), (v, v_new)]
    if ema is not None:
        d = _scalar(ema_decay, p.device).reshape(())
        e_new = ema * d + p_new * (1 - d)
        new.append((ema, e_new))
    for old, value in new:
        old.copy_(value if ok is None else torch.where(ok, value, old))
    count.add_(1 if ok is None else ok.to(count.dtype))


@functools.cache
def _library():
    lib = load_library('fused_adamw').lib
    p, i64, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lib.timm_fused_adamw.argtypes = (
        [p, p, p, ctypes.c_int, p, p, i64, i64] + [f] * 7 + [p] * 6)
    lib.timm_fused_adamw.restype = ctypes.c_int
    lib.timm_fused_adamw_error_string.argtypes = [ctypes.c_int]
    lib.timm_fused_adamw_error_string.restype = ctypes.c_char_p
    return lib


def _check_contract(p, g, m, v, ema, count, lr, ema_decay, grad_scale, ok, n_decay):
    named = dict(p=p, g=g, m=m, v=v, count=count, lr=lr)
    if ema is not None:
        named.update(ema=ema, ema_decay=ema_decay)
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
    for k, t in (('lr', lr), ('ema_decay', ema_decay if ema is not None else None),
                 ('grad_scale', grad_scale)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
            raise NotImplementedError(f'fused_adamw kernel: {k} must be one fp32 element')
    if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1):
        raise NotImplementedError('fused_adamw kernel: ok must be one bool element')


def _check_devices_cpu(*tensors):
    if any(t is not None and t.device.type != 'cpu' for t in tensors):
        raise NotImplementedError('fused_adamw: p is on the CPU and another buffer is not')


def _launch(p, g, m, v, ema, count, lr, b1, b2, eps, weight_decay, n_decay, ema_decay,
            grad_scale, ok):
    c = _consts(b1, b2)
    lib = _library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = lib.timm_fused_adamw(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), int(m.dtype == torch.bfloat16),
            v.data_ptr(), None if ema is None else ema.data_ptr(),
            p.numel(), n_decay if weight_decay else 0,
            b1, c['one_minus_b1'], c['b1_bf16'], b2, c['one_minus_b2'], eps, weight_decay,
            lr.data_ptr(), None if ema is None else ema_decay.data_ptr(), count.data_ptr(),
            None if grad_scale is None else grad_scale.data_ptr(),
            None if ok is None else ok.data_ptr(), stream)
    if rc != 0:
        reason = 'bad arguments' if rc < 0 else lib.timm_fused_adamw_error_string(rc).decode()
        raise RuntimeError(f'fused_adamw kernel launch failed ({rc}): {reason}')
    fused_adamw.launches += 1
    count.add_(1 if ok is None else ok.to(count.dtype))


def fused_adamw(p, g, m, v, ema, count, *, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0, n_decay: int = 0,
                ema_decay=0.0, grad_scale: Optional[torch.Tensor] = None,
                ok: Optional[torch.Tensor] = None) -> None:
    """AdamW (+ EMA when ``ema`` is given) over flat buffers, in place;
    ``lr`` and ``ema_decay`` are one-element fp32 tensors (or floats)."""
    n_decay = int(n_decay)
    if p.device.type == 'cpu':
        _check_devices_cpu(p, g, m, v, ema, count, *(t for t in (lr, ema_decay)
                                                      if isinstance(t, torch.Tensor)))
        return fused_adamw_reference(
            p, g, m, v, ema, count, lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            n_decay=n_decay, ema_decay=ema_decay, grad_scale=grad_scale, ok=ok)
    if p.device.type != 'cuda':
        raise NotImplementedError(f'fused_adamw runs on cuda or cpu tensors; got {p.device}')
    lr = _scalar(lr, p.device)
    ema_decay = _scalar(ema_decay, p.device) if ema is not None else None
    _check_contract(p, g, m, v, ema, count, lr, ema_decay, grad_scale, ok, n_decay)
    _launch(p, g, m, v, ema, count, lr, float(b1), float(b2), float(eps),
            float(weight_decay), n_decay, ema_decay, grad_scale, ok)


fused_adamw.launches = 0


# ---------------------------------------------------------------------------
# registry entry: the JAX registry's cases, then ViT-B/16's and ConvNeXt-B's leaf sets

_ALIGN = 4  # elements: the optimizer starts every leaf on a 16-byte boundary


@functools.cache
def _model_leaves(name: str):
    """(shape, takes weight decay) of each parameter of the port's model
    ``name``, in ``named_parameters`` order, with the optimizer's mask."""
    from ..models import create_model
    from ..optim import param_groups_weight_decay
    model = create_model(name, device='meta')  # shapes only
    mask = param_groups_weight_decay(model)
    return tuple((tuple(p.shape), mask[n]) for n, p in model.named_parameters())


def _registry_inputs(seed: int = 0, device='cuda', sizes=((64, 256), (256,), (8, 8, 32)),
                     decay=None, model: Optional[str] = None, mu_dtype=None):
    """The JAX registry's state at step 3, drawn from one numpy generator
    in its order (m, v, p, g, ema, leaf by leaf), laid out as the optimizer
    lays it out: flat buffers, leaves that take decay first (``decay``, all
    by default; ``model`` takes its leaf set and mask), each padded to 4
    elements."""
    if model is not None:
        sizes, decay = zip(*_model_leaves(model))
    decay = tuple(decay) if decay is not None else (True,) * len(sizes)
    order = [i for i in range(len(sizes)) if decay[i]] + [i for i in range(len(sizes)) if not decay[i]]
    slots, offset, n_decay = {}, 0, 0
    for i in order:
        slots[i] = offset
        offset += -(-int(np.prod(sizes[i])) // _ALIGN) * _ALIGN
        if decay[i]:
            n_decay = offset
    rng = np.random.default_rng(seed)

    def flat(scale, post=None):
        out = np.zeros(offset, np.float32)
        for i, s in enumerate(sizes):
            x = (rng.standard_normal(s) * scale).astype(np.float32).ravel()
            out[slots[i]:slots[i] + x.size] = x if post is None else post(x)
        return torch.from_numpy(out).to(device)

    m = flat(0.01)
    if mu_dtype is not None:
        m = m.to(getattr(torch, mu_dtype))
    v = flat(0.1, lambda x: np.abs(x) * np.float32(1e-3))
    p, g, ema = flat(1.0), flat(0.1), flat(1.0)
    count = torch.tensor(3, dtype=torch.int32, device=device)
    # lr and the EMA decay are device scalars, as the JAX registry passes
    # jnp.asarray scalars
    lr, ema_decay = (torch.tensor(x, dtype=torch.float32, device=device) for x in (0.02, 0.999))
    return dict(p=p, g=g, m=m, v=v, ema=ema, count=count, lr=lr, ema_decay=ema_decay,
                n_decay=n_decay)


def _functional(step):
    """The in-place update as a function: it updates copies of p, m, v, ema
    and the count and returns (p, m, v, ema)."""
    def fn(p, g, m, v, ema, count, **kw):
        p, m, v, ema, count = (t.clone() for t in (p, m, v, ema, count))
        step(p, g, m, v, ema, count, **kw)
        return p, m, v, ema
    return fn


def _registry_flops(p, **_):
    """About 20 fp32 operations an element (the moments, the bias-corrected
    step, decay, the update and the EMA)."""
    return 20 * p.numel(), 'float32'


def _registry_library(p, g, m, v, ema, count, *, lr, ema_decay, n_decay, weight_decay=0.0,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """torch's fused AdamW over the decay and no-decay groups of copies of
    the buffers, then the EMA lerp; it rounds differently (eps and decay
    order), so it is timed only. None for a bf16 m, which it cannot hold."""
    if m.dtype != torch.float32:
        return None
    groups, params, emas = [], [], []
    for part, wd in ((slice(0, n_decay), weight_decay), (slice(n_decay, None), 0.0)):
        if p[part].numel():
            t = torch.nn.Parameter(p[part].clone())
            t.grad = g[part].clone()
            params.append(t)
            groups.append({'params': [t], 'weight_decay': wd})
            emas.append(ema[part].clone())
    opt = torch.optim.AdamW(groups, lr=lr, betas=(b1, b2), eps=eps, fused=True, capturable=True)
    weight = [1 - ema_decay] * len(emas)

    def library_step():
        opt.step()
        torch._foreach_lerp_(emas, params, weight)
    return library_step


def _register():
    from .registry import KernelCase, KernelSpec, register
    mixed = dict(sizes=((64, 256), (256,), (8, 8, 32)), decay=(True, False, True))
    register(KernelSpec(
        name='fused_adamw',
        module=__name__,
        regime='the AdamW + EMA update of every train step on the card: fp32 p, g, v and '
               'ema with an fp32 or bf16 m, streamed once (36 bytes a parameter with an '
               'fp32 m) at ViT-B/16 scale',
        gate='beat the plain update at every declared case on the card, or be deleted; '
             'torch.optim.AdamW(fused=True) + _foreach_lerp_ is timed beside it',
        parity_tol=1e-6,
        kernel_fn=_functional(fused_adamw),
        reference_fn=_functional(fused_adamw_reference),
        kernel_step=fused_adamw,
        reference_step=fused_adamw_reference,
        make_inputs=_registry_inputs,
        flops=_registry_flops,
        library_fn=_registry_library,
        cases=(
            KernelCase(name='fp32',
                       dry=dict(sizes=((64, 256), (256,), (8, 8, 32))),
                       live=dict(sizes=((1024, 4096), (4096, 1024), (1024, 1024), (1024,),
                                        (197, 1024))),
                       statics=dict(weight_decay=0.05),
                       desc='fp32 moments, decayed leaves (JAX registry)'),
            KernelCase(name='mu_bf16',
                       dry=dict(sizes=((64, 256), (256,)), mu_dtype='bfloat16'),
                       live=dict(sizes=((1024, 4096), (4096, 1024), (1024, 1024)),
                                 mu_dtype='bfloat16'),
                       statics=dict(weight_decay=0.05),
                       desc='bf16 first moment (JAX registry)'),
            KernelCase(name='vit_b16',
                       dry=mixed, live=dict(model='vit_base_patch16_224'),
                       statics=dict(weight_decay=0.05),
                       desc="ViT-B/16's leaf set and decay mask, the train step's update"),
            KernelCase(name='vit_b16_mu_bf16',
                       dry=dict(mixed, mu_dtype='bfloat16'),
                       live=dict(model='vit_base_patch16_224', mu_dtype='bfloat16'),
                       statics=dict(weight_decay=0.05),
                       desc='the same with a bf16 first moment'),
            KernelCase(name='convnext_b',
                       dry=mixed, live=dict(model='convnext_base'),
                       statics=dict(weight_decay=0.05),
                       desc="ConvNeXt-B's leaf set and decay mask (344 leaves, every "
                            "ndim <= 1 leaf and bias undecayed), its train step's update"),
        ),
    ))


_register()
