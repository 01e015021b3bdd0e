"""Augment path of the PyTorch port against the JAX package on the CPU.

The host samplers (Mixup, RandomErasing) draw the same parameters from the
same seed and epoch as JAX's, and the port's plain augment program (which is
also the plain version of the augment-epilogue kernel, reached here through
``DeviceAugment`` on CPU tensors) matches JAX's XLA program, JAX's Pallas
kernel in interpret mode and JAX's numpy oracle within 1e-6 (the JAX
registry's ``parity_tol``) for 'const', 'rand' and 'pixel' erasing, 'pixel'
with JAX's noise canvas fed in; fp16 and bf16 outputs within one ulp. The
port's own 'pixel' noise is held by distribution (JAX's threefry stream
cannot be reproduced) and by its key. Batches are small (B 8 and 7, 32 px).
JAX is imported inside the fixture. The gpu-marked tests hold the CUDA
kernel against its plain version, and the augment program's graph replays
against its eager run, on the card.
"""
import functools

import numpy as np
import pytest
import torch

from timm_tpu_torch.data import (
    DeviceAugment, Mixup, RandomErasing, augment_image_batch, noise_generator_seed, pixel_noise,
)
from timm_tpu_torch.kernels import augment_epilogue, augment_epilogue_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
         (8, 3, True, 'rand'), (7, 1, False, 'rand'), (7, 3, True, 'pixel')]
RE_STD = (0.229, 0.224, 0.225)
NOISE_SEED, NOISE_EPOCH, NOISE_STEP = 11, 2, 5


@pytest.mark.parametrize('b,k,mix,mode', CASES)
def test_plain_augment_matches_jax(jx, b, k, mix, mode):
    """The port's plain program against JAX's XLA program, JAX's Pallas
    kernel in interpret mode ('const' only: the kernel's regime) and the
    numpy oracle ('const', 'rand'): images and soft targets within 1e-6.
    In 'pixel' mode the port's program takes the noise canvas JAX's
    program drew (one jit gives both; a threefry compile takes seconds
    here). DeviceAugment on CPU tensors (the kernel wrapper's plain route
    for 'const') is held to the same references, and in 'pixel' mode to
    the plain program with its own canvas of the same key."""
    batch = _batch(10 * b + k, b, k, mix, mode)
    kw = dict(STATICS, re_mode=mode)
    augment = DeviceAugment(STATICS['mean'], STATICS['std'], re_mode=mode, re_mean=STATICS['re_mean'],
                            re_std=RE_STD, num_classes=NC, smoothing=0.1, noise_seed=NOISE_SEED)
    dx, dy = augment(_torch(batch), epoch=NOISE_EPOCH, step=NOISE_STEP)
    if mode == 'pixel':
        jax_kw = dict(kw, re_std=RE_STD, noise_seed=NOISE_SEED)

        def program(jb):
            canvas = jx.da.pixel_noise((b, H, W, C), NOISE_SEED, jb['noise_epoch'],
                                       jb['noise_step'], STATICS['re_mean'], RE_STD)
            return jx.da.augment_image_batch(jb, **jax_kw), canvas

        jbatch = dict(batch, noise_epoch=np.uint32(NOISE_EPOCH), noise_step=np.uint32(NOISE_STEP))
        ref, canvas = jx.jax.jit(program)({key: jx.jnp.asarray(v) for key, v in jbatch.items()})
        refs = {'xla': ref}
        x, y = augment_image_batch(_torch(batch), **kw, noise=torch.from_numpy(np.array(canvas)))
        gen = torch.Generator().manual_seed(noise_generator_seed(NOISE_SEED, NOISE_EPOCH, NOISE_STEP))
        own = augment_image_batch(_torch(batch), **kw, noise=pixel_noise(
            (b, H, W, C), gen, STATICS['re_mean'], RE_STD))
        assert torch.equal(dx, own[0]) and torch.equal(dy, own[1])
        assert not torch.equal(dx, x)  # the port's noise is its own
    else:
        x, y = augment_image_batch(_torch(batch), **kw)
        refs = {'numpy': jx.da.augment_image_batch_np(batch, **kw)}
        jbatch = {key: jx.jnp.asarray(v) for key, v in batch.items()}
        refs['xla'] = jx.jax.jit(functools.partial(jx.da.augment_image_batch, **kw))(jbatch)
    if mode == 'const':
        refs['pallas'] = jx.jax.jit(functools.partial(jx.fused, **kw))(jbatch)
    for name, (rx, ry) in refs.items():
        for px, py in ((x, y),) + (((dx, dy),) if mode != 'pixel' else ()):
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


def test_pixel_noise_distribution_and_key():
    """The port's 'pixel' canvas on (8, 64, 64, 3): per-channel mean and
    std within 3 sigma of re_mean and re_std; one (seed, epoch, step) gives
    the same canvas, and through DeviceAugment the same batch; another step
    or epoch gives another."""
    shape = (8, 64, 64, 3)
    mean, std = np.asarray(STATICS['re_mean']), np.asarray(RE_STD)

    def canvas(epoch, step):
        gen = torch.Generator().manual_seed(noise_generator_seed(NOISE_SEED, epoch, step))
        return pixel_noise(shape, gen, STATICS['re_mean'], RE_STD)

    noise = canvas(0, 3)
    assert noise.dtype == torch.float32 and tuple(noise.shape) == shape
    n = np.prod(shape[:-1])
    flat = noise.reshape(-1, 3).double().numpy()
    assert (np.abs(flat.mean(0) - mean) <= 3 * std / np.sqrt(n)).all(), flat.mean(0)
    assert (np.abs(flat.std(0) - std) <= 3 * std / np.sqrt(2 * n)).all(), flat.std(0)
    assert torch.equal(noise, canvas(0, 3))
    assert not torch.equal(noise, canvas(0, 4)) and not torch.equal(noise, canvas(1, 3))
    batch = _torch(_batch(6, 8, 2, False, 'const'))
    augment = DeviceAugment(STATICS['mean'], STATICS['std'], re_mode='pixel', re_std=RE_STD,
                            noise_seed=NOISE_SEED)
    first, again = augment(batch, epoch=0, step=3)[0], augment(batch, epoch=0, step=3)[0]
    assert torch.equal(first, again) and not torch.equal(first, augment(batch, epoch=0, step=4)[0])


def test_unported_modes_raise():
    """An unknown erase mode raises, 'pixel' erasing without its canvas
    raises, and the kernel wrapper raises off CUDA and CPU tensors."""
    batch = _torch(_batch(5, 8, 1, True, 'rand'))
    with pytest.raises(ValueError, match='erase mode'):
        DeviceAugment(STATICS['mean'], STATICS['std'], re_mode='noise')
    with pytest.raises(ValueError, match='canvas'):
        augment_image_batch(batch, mean=STATICS['mean'], std=STATICS['std'], re_mode='pixel')
    meta = {k: v.to('meta') for k, v in batch.items()}
    with pytest.raises(NotImplementedError, match='cuda or cpu'):
        augment_epilogue(meta['image'], meta['lam'], meta['use_cutmix'], meta['bbox'],
                         meta['erase_box'], mean=STATICS['mean'], std=STATICS['std'])


@pytest.mark.gpu
def test_kernel_on_card_matches_plain():
    """The CUDA kernel against its plain version on the card: fp32 within
    1e-6, fp16 / bf16 within one ulp; odd batches, W*C not a multiple of 4
    (H*W*C a multiple of 4 and not), 1 and 4 channels, K 0 and 3, int32 and
    bool cutmix flags; one launch per call; 'rand', C > 4 and a
    non-contiguous image raise; 'rand' erasing runs the torch program, no
    kernel."""
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
    before = augment_epilogue.launches
    DeviceAugment((0.5,), (0.5,), re_mode='rand')(
        {'image': image, 'target': torch.zeros(b, dtype=torch.int64, device='cuda')})
    assert augment_epilogue.launches == before
    wide = torch.zeros(1, 4, 4, 5, dtype=torch.uint8, device='cuda')
    with pytest.raises(NotImplementedError, match='channels'):
        augment_epilogue(wide, *args[1:], mean=(0,) * 5, std=(1,) * 5)
    with pytest.raises(NotImplementedError, match='contiguous'):
        augment_epilogue(image.transpose(1, 2), *args[1:], **kw)


def _bits(t):
    """The raw bits of a float tensor, so -0.0 and +0.0 differ."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


# (height, width) of 3-channel images whose H*W*C is a multiple of 16, of
# 4 and not 16, and odd: the kernel reads 16, 4 and 1 bytes a thread
ACCESS_SHAPES = {16: (32, 32), 4: (7, 4), 1: (7, 5)}


def _card_batch(rng, b, h, w, k, mode):
    """A uint8 batch on the card with K erase boxes and per-row mixing:
    'cutmix' every row pastes, 'blend' every row blends, 'lam_one' rows
    cycle through lam == 1 without cutmix, a blend and a paste."""
    image = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    boxes = np.zeros((b, k, 4), np.int32)
    for i in range(b):
        for j in range(k):
            eh, ew = rng.integers(1, h // 2 + 2), rng.integers(1, w // 2 + 2)
            boxes[i, j] = (rng.integers(0, h - eh + 1), rng.integers(0, w - ew + 1), eh, ew)
    lam = rng.uniform(0.2, 1, b).astype(np.float32)
    cut = np.full(b, mode == 'cutmix', np.int32)
    if mode == 'lam_one':
        lam[0::3] = 1.0
        cut[2::3] = 1
    yl, xl = rng.integers(0, h // 2 + 1, b), rng.integers(0, w // 2 + 1, b)
    bbox = np.stack([yl, yl + h // 2, xl, xl + w // 2], 1).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (image, lam, cut, bbox, boxes)]


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['cutmix', 'blend', 'lam_one'])
@pytest.mark.parametrize('width', list(ACCESS_SHAPES))
def test_kernel_bit_identical_on_card(width, mode):
    """The kernel against its plain version on the card, bit for bit in
    fp32 and fp16 out and within one bf16 ulp in bf16, for each access
    width, K in {0, 1, 3} boxes, an odd and an even batch, and cutmix,
    blend and lam == 1 rows, with a fill of -0.0 among them."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels.augment_epilogue import _access_width
    h, w = ACCESS_SHAPES[width]
    rng = np.random.default_rng(width * 10 + len(mode))
    fills = [(0.485, 0.456, 0.406)]
    if mode == 'lam_one':
        fills.append((-0.0, 0.5, 0.25))
    for b in (7, 8):
        for k in (0, 1, 3):
            args = _card_batch(rng, b, h, w, k, mode)
            assert _access_width(args[0]) == width
            for re_mean in fills:
                for dtype in (torch.float32, torch.float16, torch.bfloat16):
                    kw = dict(mean=(0.0, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                              re_mean=re_mean, out_dtype=dtype)
                    before = augment_epilogue.launches
                    out = augment_epilogue(*args, **kw)
                    assert augment_epilogue.launches == before + 1
                    ref = augment_epilogue_reference(*args, **kw)
                    torch.cuda.synchronize()
                    where = f'b {b}, k {k}, fill {re_mean}, {dtype}'
                    if dtype == torch.bfloat16:
                        o, r = out.float().cpu().numpy(), ref.float().cpu().numpy()
                        assert (np.abs(o - r) <= _ulp(r, 7)).all(), where
                    else:
                        assert torch.equal(_bits(out), _bits(ref)), where


def _card_augment_batch(rng, b, mode, size=224, k=1):
    """A uint8 batch at ViT-B/16's size with K erase boxes in 3 of 4 rows,
    'rand' fills, and mixup / cutmix rows, as numpy arrays."""
    batch = _batch(int(rng.integers(1 << 30)), b, 0, True, mode)
    batch['image'] = rng.integers(0, 256, (b, size, size, C), dtype=np.uint8)
    yl, xl = rng.integers(0, size // 2, b), rng.integers(0, size // 2, b)
    batch['bbox'] = np.stack([yl, yl + size // 4, xl, xl + size // 4], 1).astype(np.int32)
    boxes = np.zeros((b, k, 4), np.int32)
    for i in range(0, b, 4):
        for j in range(k):
            for r in (i, i + 1, i + 2):
                if r < b:
                    eh, ew = rng.integers(8, size // 2, 2)
                    boxes[r, j] = (rng.integers(0, size - eh), rng.integers(0, size - ew), eh, ew)
    batch['erase_box'] = boxes
    if mode == 'rand':
        batch['erase_fill'] = rng.standard_normal((b, k, C)).astype(np.float32)
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['const', 'rand', 'pixel'])
def test_augment_graph_replays_equal_eager_program_on_card(mode):
    """The augment program through its graphs (per batch size: a warm-up,
    a capture, a replay) against the program run eagerly on the same
    inputs, bit for bit, at batch 64 and 37; in 'pixel' mode with each
    call's own (epoch, step) key, so every replay redraws its noise, and a
    replay of a key already drawn gives that noise again."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    rng = np.random.default_rng(len(mode))
    augment = DeviceAugment(STATICS['mean'], STATICS['std'], re_mode=mode, re_mean=STATICS['re_mean'],
                            re_std=RE_STD, num_classes=NC, smoothing=0.1, noise_seed=NOISE_SEED,
                            device='cuda')
    keys = [(0, 0), (0, 1), (1, 2), (0, 1)]
    for b in (64, 37):
        first, second = _card_augment_batch(rng, b, mode), _card_augment_batch(rng, b, mode)
        batches = [first, second, second, second]
        outs = [augment(batch, epoch=e, step=s) for batch, (e, s) in zip(batches, keys)]
        for batch, (e, s), (x, y) in zip(batches, keys, outs):
            if augment.generator is not None:
                augment.generator.manual_seed(noise_generator_seed(NOISE_SEED, e, s))
            want_x, want_y = augment._program(
                {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in batch.items()}, mode)
            assert torch.equal(_bits(x), _bits(want_x)) and torch.equal(y, want_y), (b, e, s)
        assert torch.equal(outs[1][0], outs[3][0])
        assert torch.equal(outs[1][0], outs[2][0]) == (mode != 'pixel')
    assert augment.graphs.captures == 2 and augment.graphs.replays == 6
    assert augment.graphs.pool_bytes() > 0
