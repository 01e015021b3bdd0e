"""Input path of the PyTorch port against the JAX package on the CPU:
transforms, data config, the threaded loader's index order and poison
budget, and dataset -> loader -> device augment stage over a folder of PNGs,
held against JAX's augment program on the same uint8 batch and JAX-sampled
parameters. Images are tiny (8 PNGs at 48 px, 32 px crops). JAX is imported
inside the fixture.
"""
import functools
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from timm_tpu_torch.data import Mixup, ThreadedLoader, create_loader, resolve_data_config
from timm_tpu_torch.data.dataset_factory import create_dataset
from timm_tpu_torch.data.transforms_factory import create_transform
from timm_tpu_torch.resilience import TooManyBadSamples

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


@pytest.fixture(scope='module')
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from timm_tpu.data import device_augment, loader, transforms_factory
    from timm_tpu.data.config import resolve_data_config as jax_resolve_data_config
    from timm_tpu.data.mixup import Mixup as JaxMixup
    from timm_tpu.data.random_erasing import RandomErasing as JaxRandomErasing
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, da=device_augment, ThreadedLoader=loader.ThreadedLoader,
        create_transform=transforms_factory.create_transform, Mixup=JaxMixup,
        RandomErasing=JaxRandomErasing, resolve_data_config=jax_resolve_data_config)


def _pil(seed, size=(40, 44)):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))


@pytest.mark.parametrize('crop_mode,interpolation,dtype', [
    ('center', 'bilinear', None), ('squash', 'bicubic', np.uint8), ('border', 'bicubic', None)])
def test_eval_transform_matches_jax(jx, crop_mode, interpolation, dtype):
    kw = dict(is_training=False, crop_pct=0.875, crop_mode=crop_mode,
              interpolation=interpolation, output_dtype=dtype)
    img = _pil(0)
    out = create_transform(32, **kw)(img)
    ref = jx.create_transform(32, **kw)(img)
    assert out.dtype == ref.dtype and out.shape == (32, 32, 3)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize('no_aug', [False, True])
def test_train_transform_matches_jax_under_one_seed(jx, no_aug):
    """Random resized crop with a random interpolation, flips and colour
    jitter (hue included) draw from Python's ``random``: under the same seed
    the port and JAX give the same uint8 image."""
    kw = dict(is_training=True, no_aug=no_aug, interpolation='random', vflip=0.5,
              color_jitter=(0.4, 0.4, 0.4, 0.1), output_dtype=np.uint8)
    port, ref = create_transform(32, **kw), jx.create_transform(32, **kw)
    for seed in range(3):
        img = _pil(seed)
        random.seed(seed)
        out = port(img)
        random.seed(seed)
        np.testing.assert_array_equal(out, ref(img))


def test_resolve_data_config_matches_jax(jx):
    cfg = dict(input_size=(3, 160, 160), interpolation='bicubic', crop_pct=0.95,
               mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    for args in ({}, {'img_size': 96, 'mean': (0.1,), 'crop_pct': 0.8}):
        assert resolve_data_config(args, pretrained_cfg=cfg) == \
            jx.resolve_data_config(args, pretrained_cfg=cfg)


class _Items:
    """A map-style dataset of (tiny image, index) samples; ``bad`` indices
    raise a non-transient error."""

    def __init__(self, n, bad=()):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.bad:
            raise ValueError(f'undecodable sample {i}')
        return np.full((2, 2, 3), i, np.uint8), i


def _targets(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.append([t.tolist() for _, t in loader])
    return out


@pytest.mark.parametrize('order', [
    dict(shuffle=True, drop_last=True), dict(shuffle=True, drop_last=False),
    dict(shuffle=False, drop_last=False), dict(shuffle=True, drop_last=True, num_aug_repeats=3),
    dict(shuffle=True, drop_last=False, process_index=1, process_count=3)])
def test_threaded_loader_order_matches_jax(jx, order):
    """Shuffle per epoch, drop_last, repeated augmentation and the
    per-process shard give JAX's batches with one worker."""
    kw = dict(batch_size=4, is_training=True, num_workers=1, seed=7, **order)
    port, ref = ThreadedLoader(_Items(10), **kw), jx.ThreadedLoader(_Items(10), **kw)
    assert len(port) == len(ref)
    assert _targets(port) == _targets(ref)


def test_threaded_loader_poison_budget_matches_jax(jx, monkeypatch):
    """Bad samples are skipped against the budget as in JAX; past it the
    epoch fails with TooManyBadSamples."""
    kw = dict(batch_size=4, num_workers=1, shuffle=False, seed=0)
    bad = _Items(10, bad=(2, 7))
    assert _targets(ThreadedLoader(bad, **kw), (0,)) == _targets(jx.ThreadedLoader(bad, **kw), (0,))
    monkeypatch.setenv('TIMM_TPU_POISON_BUDGET', '1')
    with pytest.raises(TooManyBadSamples):
        list(ThreadedLoader(bad, **kw))


@pytest.fixture
def image_folder(tmp_path):
    """8 PNGs at 48 px in 2 class folders under train/."""
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(tmp_path / 'train' / f'class{c}')
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)).save(
                tmp_path / 'train' / f'class{c}' / f'{i}.png')
    return str(tmp_path)


def test_folder_loader_device_augment_matches_jax(jx, image_folder):
    """create_dataset + create_loader(device='cpu', device_augment=True,
    device_prefetch=2) over a folder: each batch equals JAX's
    augment_image_batch on the same uint8 batch with parameters drawn by
    JAX's samplers from the same seed and epoch (within 1e-6)."""
    mixup_kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1, num_classes=5, seed=3)
    ds = create_dataset('', image_folder, split='train')
    assert len(ds) == 8 and ds.reader.class_to_idx == {'class0': 0, 'class1': 1}
    stage = create_loader(ds, (3, 32, 32), 8, is_training=True, no_aug=True, re_prob=0.5,
                          mean=MEAN, std=STD, num_workers=1, seed=3, device_augment=True,
                          device_prefetch=2, mixup=Mixup(**mixup_kw), device='cpu')
    jmix = jx.Mixup(**mixup_kw)
    jre = jx.RandomErasing(probability=0.5, mode='const', min_count=1,
                           mean=np.asarray(MEAN, np.float32), std=np.asarray(STD, np.float32), seed=3)
    program = jx.jax.jit(functools.partial(jx.da.augment_image_batch, mean=MEAN, std=STD,
                                           re_mean=MEAN, num_classes=5, smoothing=0.1))
    for epoch in (0, 1):
        stage.set_epoch(epoch)
        (x, y), = list(stage)
        (image, target), = list(stage.loader)  # the same uint8 batch: resize + crop, one worker
        jmix.set_epoch(epoch)
        jre.set_epoch(epoch)
        batch = {'image': image.numpy(), 'target': target.numpy()}
        batch.update(jre.sample_params(image.shape))
        batch.update(jmix.sample_params(image.shape))
        rx, ry = program({k: jx.jnp.asarray(v) for k, v in batch.items()})
        assert image.dtype == torch.uint8 and x.shape == (8, 32, 32, 3) and y.shape == (8, 5)
        np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-6, rtol=0)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-6, rtol=0)


def test_unported_options_raise(image_folder):
    for name in ('wds/x', 'tfds/x', 'hfds/x', 'torch/cifar10'):
        with pytest.raises(NotImplementedError, match='A.5'):
            create_dataset(name, image_folder)
    with pytest.raises(NotImplementedError, match='A.5'):
        create_transform(32, is_training=True, auto_augment='rand-m9-mstd0.5')
    with pytest.raises(NotImplementedError, match='A.5'):
        create_transform(32, auto_augment='augmix-m5')
    ds = create_dataset('', image_folder, split='train')
    with pytest.raises(NotImplementedError, match='A.5'):
        create_loader(ds, (3, 32, 32), 4, is_training=True, num_aug_splits=2)
    with pytest.raises(NotImplementedError, match='A.5'):
        create_loader(iter([]), (3, 32, 32), 4)
    with pytest.raises(ValueError, match='train-path'):
        create_loader(ds, (3, 32, 32), 4, device_augment=True, device='cpu')


def test_importing_the_data_package_does_not_import_pil():
    code = 'import sys, timm_tpu_torch.data; assert "PIL" not in sys.modules'
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_stopping_early_stops_the_loader_threads():
    """Closing the device augment stage mid-epoch closes the prefetcher and
    the threaded loader under it: no worker outlives the iteration."""
    import threading
    import time

    class Slow(_Items):
        def __getitem__(self, i):
            time.sleep(0.002)
            return np.zeros((8, 8, 3), np.uint8), i % 5

    before = threading.active_count()
    stage = create_loader(Slow(400), (3, 8, 8), 8, is_training=True, num_workers=3,
                          device_augment=True, device_prefetch=2, mixup=Mixup(num_classes=5, seed=0),
                          device='cpu')
    stage.dataset  # attribute access falls through the stage and prefetcher to the loader
    it = iter(stage)
    next(it)
    assert threading.active_count() > before
    it.close()
    assert threading.active_count() == before


@pytest.mark.gpu
def test_card_and_cpu_stages_agree(image_folder):
    """The same deterministic loader (one worker, resize and crop) through
    the CUDA-stream prefetcher and the kernel on the card, and through the
    plain stage on the CPU: equal batches, one kernel launch per batch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import augment_epilogue

    def batches(device):
        stage = create_loader(
            create_dataset('', image_folder, split='train'), (3, 32, 32), 4, is_training=True,
            no_aug=True, re_prob=0.5, mean=MEAN, std=STD, num_workers=1, seed=1,
            device_augment=True, device_prefetch=2, device=device,
            mixup=Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, num_classes=5, seed=1))
        out = []
        for epoch in (0, 1):
            stage.set_epoch(epoch)
            out += [(x.cpu(), y.cpu(), x.device.type) for x, y in stage]
        return out

    before = augment_epilogue.launches
    card = batches('cuda')
    assert augment_epilogue.launches == before + len(card) == before + 4
    for (xc, yc, dc), (x, y, d) in zip(card, batches('cpu')):
        assert (dc, d) == ('cuda', 'cpu')
        torch.testing.assert_close(xc, x, atol=1e-6, rtol=0)
        torch.testing.assert_close(yc, y, atol=1e-6, rtol=0)
