"""Augment path of the PyTorch port against the JAX package on the CPU.

The host samplers (Mixup, RandomErasing) draw the same parameters from the
same seed and epoch as JAX's, and the port's plain augment program (which is
also the plain version of the augment-epilogue kernel, reached here through
``DeviceAugment`` on CPU tensors) matches JAX's XLA program, JAX's Pallas
kernel in interpret mode and JAX's numpy oracle within 1e-6 (the JAX
registry's ``parity_tol``); fp16 and bf16 outputs within one ulp. Batches
are small (B 8 and 7, 32 px). JAX is imported inside the fixture. One
gpu-marked test holds the CUDA kernel against its plain version on the card.
"""
import functools

import numpy as np
import pytest
import torch

from timm_tpu_torch.data import (
    DeviceAugment, DeviceAugmentStage, Mixup, RandomErasing, augment_image_batch,
)
from timm_tpu_torch.kernels import augment_epilogue, augment_epilogue_reference

H = W = 32
C, NC = 3, 10
STATICS = dict(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
               re_mean=(0.485, 0.456, 0.406), num_classes=NC, smoothing=0.1)


@pytest.fixture(scope='module')
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from timm_tpu.data import device_augment
    from timm_tpu.data.mixup import Mixup as JaxMixup
    from timm_tpu.data.random_erasing import RandomErasing as JaxRandomErasing
    from timm_tpu.kernels.augment_epilogue import augment_image_batch_fused
    return types.SimpleNamespace(jax=jax, jnp=jnp, da=device_augment, Mixup=JaxMixup,
                                 RandomErasing=JaxRandomErasing, fused=augment_image_batch_fused)


# ---- samplers ---------------------------------------------------------------

@pytest.mark.parametrize('mode', ['batch', 'elem', 'pair'])
@pytest.mark.parametrize('alphas', [(0.8, 0.0), (0.0, 1.0), (0.5, 0.5)])
def test_mixup_sampler_matches_jax(jx, mode, alphas):
    """Same seed and epoch: the same lam, cutmix flags and boxes, batch after
    batch; the host __call__ agrees within 1e-6."""
    kw = dict(mixup_alpha=alphas[0], cutmix_alpha=alphas[1], mode=mode, label_smoothing=0.1,
              num_classes=NC, seed=33)
    shape = (8, H, W, C)
    port, ref = Mixup(**kw), jx.Mixup(**kw)
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for _ in range(3):
            p, r = port.sample_params(shape), ref.sample_params(shape)
            assert p.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    t = np.arange(8) % NC
    px, py = Mixup(**kw)(x.copy(), t)
    rx, ry = jx.Mixup(**kw)(x.copy(), t)
    np.testing.assert_allclose(px, rx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(py, ry, atol=1e-6, rtol=0)


@pytest.mark.parametrize('mode', ['const', 'rand'])
@pytest.mark.parametrize('count', [1, 2, 3])
def test_random_erasing_sampler_matches_jax(jx, mode, count):
    kw = dict(probability=0.7, mode=mode, min_count=1, max_count=count,
              mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225), seed=5)
    shape = (8, H, W, C)
    port, ref = RandomErasing(**kw), jx.RandomErasing(**kw)
    for epoch in (0, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for _ in range(3):
            p, r = port.sample_params(shape), ref.sample_params(shape)
            assert p.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    np.testing.assert_allclose(RandomErasing(**kw)(x.copy()), jx.RandomErasing(**kw)(x.copy()),
                               atol=1e-6, rtol=0)


# ---- the plain augment program ---------------------------------------------

def _batch(seed, b, k, mix, mode):
    """A uint8 batch and its parameters, as the samplers lay them out:
    (top, left, eh, ew) erase boxes with zero boxes in some slots, per-row
    lam, cutmix flags and (yl, yh, xl, xh) boxes."""
    rng = np.random.default_rng(seed)
    out = {'image': rng.integers(0, 256, (b, H, W, C), dtype=np.uint8),
           'target': rng.integers(0, NC, b)}
    if k:
        boxes = np.zeros((b, k, 4), np.int32)
        for i in range(b):
            for j in range(k):
                if rng.random() < 0.8:
                    eh, ew = rng.integers(1, H // 2, 2)
                    boxes[i, j] = (rng.integers(0, H - eh), rng.integers(0, W - ew), eh, ew)
        out['erase_box'] = boxes
        if mode == 'rand':
            out['erase_fill'] = rng.standard_normal((b, k, C)).astype(np.float32)
    if mix:
        yl, xl = rng.integers(0, H // 2, b), rng.integers(0, W // 2, b)
        out['lam'] = rng.uniform(0.2, 1.0, b).astype(np.float32)
        out['use_cutmix'] = rng.integers(0, 2, b).astype(bool)
        out['bbox'] = np.stack([yl, yl + rng.integers(1, H // 2, b), xl,
                                xl + rng.integers(1, W // 2, b)], 1).astype(np.int32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# (batch, erase boxes, mixup, erase mode): every batch size, box count, mix
# setting and mode of the JAX registry's dry cases and more, odd batches
# included (the middle row is its own partner)
CASES = [(8, 0, True, 'const'), (8, 1, True, 'const'), (7, 3, True, 'const'),
         (8, 1, False, 'const'), (7, 0, False, 'const'), (7, 3, False, 'const'),
         (8, 3, True, 'rand'), (7, 1, False, 'rand')]


@pytest.mark.parametrize('b,k,mix,mode', CASES)
def test_plain_augment_matches_jax(jx, b, k, mix, mode):
    """The port's plain program, and DeviceAugment on CPU tensors (the
    kernel wrapper's plain route for 'const'), against JAX's XLA program,
    JAX's Pallas kernel in interpret mode ('const' only: the kernel's
    regime) and the numpy oracle: images and soft targets within 1e-6."""
    batch = _batch(10 * b + k, b, k, mix, mode)
    kw = dict(STATICS, re_mode=mode)
    x, y = augment_image_batch(_torch(batch), **kw)
    dx, dy = DeviceAugment(STATICS['mean'], STATICS['std'], re_mode=mode,
                           re_mean=STATICS['re_mean'], num_classes=NC, smoothing=0.1)(_torch(batch))
    refs = {'numpy': jx.da.augment_image_batch_np(batch, **kw)}
    jbatch = {key: jx.jnp.asarray(v) for key, v in batch.items()}
    refs['xla'] = jx.jax.jit(functools.partial(jx.da.augment_image_batch, **kw))(jbatch)
    if mode == 'const':
        refs['pallas'] = jx.jax.jit(functools.partial(jx.fused, **kw))(jbatch)
    for name, (rx, ry) in refs.items():
        for px, py in ((x, y), (dx, dy)):
            np.testing.assert_allclose(px.numpy(), np.asarray(rx), atol=1e-6, rtol=0, err_msg=name)
            np.testing.assert_allclose(py.numpy(), np.asarray(ry), atol=1e-6, rtol=0, err_msg=name)
    assert x.dtype == torch.float32 and tuple(x.shape) == (b, H, W, C)


def _ulp(ref, mantissa_bits):
    """One ulp of ref in a format with ``mantissa_bits`` explicit mantissa
    bits, and no less than 1e-6: where the blend cancels to near zero, one
    fp32 ulp of difference before the cast is many ulps of the result."""
    return np.maximum(np.ldexp(1.0, np.frexp(np.abs(ref))[1] - (mantissa_bits + 1)), 1e-6)


@pytest.mark.parametrize('dtype', ['float16', 'bfloat16'])
def test_half_outputs_within_one_ulp_of_jax(jx, dtype):
    batch = _batch(3, 7, 3, True, 'const')
    x, _ = DeviceAugment(STATICS['mean'], STATICS['std'], re_mean=STATICS['re_mean'],
                         num_classes=NC, smoothing=0.1,
                         out_dtype=getattr(torch, dtype))(_torch(batch))
    assert x.dtype == getattr(torch, dtype)
    jbatch = {key: jx.jnp.asarray(v) for key, v in batch.items()}
    rx, _ = jx.jax.jit(functools.partial(jx.da.augment_image_batch, **STATICS,
                                         out_dtype=getattr(jx.jnp, dtype)))(jbatch)
    ref = np.asarray(rx.astype(jx.jnp.float32))
    diff = np.abs(x.float().numpy() - ref)
    assert (diff <= _ulp(ref, 10 if dtype == 'float16' else 7)).all(), diff.max()


def test_identity_values_and_zero_boxes():
    """lam = 1 with no cutmix, zero boxes and K = 0 change nothing: the
    kernel's plain version returns the normalised image itself."""
    batch = _torch(_batch(4, 7, 0, False, 'const'))
    b = 7
    out = augment_epilogue(batch['image'], torch.ones(b), torch.zeros(b, dtype=torch.int32),
                           torch.zeros(b, 4, dtype=torch.int32), torch.zeros(b, 2, 4, dtype=torch.int32),
                           mean=STATICS['mean'], std=STATICS['std'], re_mean=STATICS['re_mean'])
    plain = augment_image_batch(batch, mean=STATICS['mean'], std=STATICS['std'])[0]
    assert torch.equal(out, plain)


def test_unported_modes_raise():
    batch = _torch(_batch(5, 8, 1, True, 'rand'))
    with pytest.raises(NotImplementedError, match='pixel'):
        DeviceAugment(STATICS['mean'], STATICS['std'], re_mode='pixel')
    with pytest.raises(NotImplementedError, match='pixel'):
        augment_image_batch(batch, mean=STATICS['mean'], std=STATICS['std'], re_mode='pixel')
    with pytest.raises(NotImplementedError, match='pixel'):
        DeviceAugmentStage([], STATICS['mean'], STATICS['std'], re_mode='pixel', device='cpu')
    meta = {k: v.to('meta') for k, v in batch.items()}
    with pytest.raises(NotImplementedError, match='rand'):
        DeviceAugment(STATICS['mean'], STATICS['std'], re_mode='rand')(meta)
    with pytest.raises(NotImplementedError, match='cuda or cpu'):
        augment_epilogue(meta['image'], meta['lam'], meta['use_cutmix'], meta['bbox'],
                         meta['erase_box'], mean=STATICS['mean'], std=STATICS['std'])


@pytest.mark.gpu
def test_kernel_on_card_matches_plain():
    """The CUDA kernel against its plain version on the card: fp32 within
    1e-6, fp16 / bf16 within one ulp; odd batches, W*C not a multiple of 4
    (H*W*C a multiple of 4 and not), 1 and 4 channels, K 0 and 3, int32 and
    bool cutmix flags; one launch per call; 'rand', C > 4 and a
    non-contiguous image raise."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(0)
    for b, h, w, c, k, dtype in ((8, 32, 32, 3, 1, torch.float32), (7, 32, 31, 3, 3, torch.bfloat16),
                                 (7, 31, 31, 3, 3, torch.float32), (5, 17, 9, 1, 2, torch.float16),
                                 (4, 16, 16, 4, 0, torch.float32), (1, 8, 8, 3, 1, torch.float32)):
        image = torch.from_numpy(rng.integers(0, 256, (b, h, w, c), dtype=np.uint8)).cuda()
        lam = torch.from_numpy(rng.uniform(0.2, 1, b).astype(np.float32)).cuda()
        cut = torch.from_numpy(rng.integers(0, 2, b).astype(np.int32)).cuda()
        if c == 1:
            cut = cut.bool()
        yl, xl = rng.integers(0, h // 2, b), rng.integers(0, w // 2, b)
        bbox = torch.from_numpy(np.stack([yl, yl + h // 4, xl, xl + w // 4], 1).astype(np.int32)).cuda()
        boxes = np.zeros((b, k, 4), np.int32)
        for i in range(b):
            for j in range(k):
                eh, ew = rng.integers(1, h // 2), rng.integers(1, w // 2)
                boxes[i, j] = (rng.integers(0, h - eh), rng.integers(0, w - ew), eh, ew)
        erase = torch.from_numpy(boxes).cuda()
        kw = dict(mean=(0.5, 0.4, 0.3, 0.2)[:c], std=(0.2, 0.25, 0.3, 0.35)[:c],
                  re_mean=(0.1, 0.2, 0.3, 0.4)[:c], out_dtype=dtype)
        before = augment_epilogue.launches
        out = augment_epilogue(image, lam, cut, bbox, erase, **kw)
        assert augment_epilogue.launches == before + 1
        ref = augment_epilogue_reference(image, lam, cut, bbox, erase, **kw)
        torch.cuda.synchronize()
        o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(o, r, atol=1e-6, rtol=0)
        else:
            assert (np.abs(o - r) <= _ulp(r, 10 if dtype == torch.float16 else 7)).all()
    args = (image, lam, cut, bbox, erase)
    with pytest.raises(NotImplementedError, match='rand'):
        DeviceAugment((0.5,), (0.5,), re_mode='rand')(
            {'image': image, 'target': torch.zeros(b, dtype=torch.int64, device='cuda')})
    wide = torch.zeros(1, 4, 4, 5, dtype=torch.uint8, device='cuda')
    with pytest.raises(NotImplementedError, match='channels'):
        augment_epilogue(wide, *args[1:], mean=(0,) * 5, std=(1,) * 5)
    with pytest.raises(NotImplementedError, match='contiguous'):
        augment_epilogue(image.transpose(1, 2), *args[1:], **kw)
