"""The augmentation recipe of the PyTorch port against the JAX package on
the CPU: RandAugment, AutoAugment and AugMix (``data/auto_augment.py``),
their place in ``create_transform``, AugMix's split dataset and loader, and
the JSD loss.

With Python's and numpy's global streams seeded alike, every op at two
magnitudes and the three policies give JAX's image bit for bit (32 px
images). Inside loader workers the transforms draw from per-sample streams
(``set_sample_key``): the image is a function of the key alone, whatever
the threads' interleaving. ``JsdCrossEntropy`` is held to JAX's loss within
1e-6 and to ``jax.grad`` within 1e-5. JAX is imported inside fixtures.
"""
import random
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from timm_tpu_torch.data import auto_augment, create_loader
from timm_tpu_torch.data.dataset import AugMixDataset
from timm_tpu_torch.data.dataset_factory import create_dataset
from timm_tpu_torch.data.sample_rng import sample_np_rng, sample_rng, set_sample_key, set_sample_rng
from timm_tpu_torch.data.transforms_factory import create_transform
from timm_tpu_torch.loss import JsdCrossEntropy
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

HPARAMS = dict(translate_const=14, img_mean=(124, 116, 104))
POLICIES = ('rand-m9-mstd0.5-inc1', 'original-mstd0.5', 'augmix-m3-w3')


@pytest.fixture(scope='module')
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from timm_tpu.data import auto_augment as jax_auto_augment
    from timm_tpu.data import transforms_factory
    from timm_tpu.loss import JsdCrossEntropy as JaxJsd
    return types.SimpleNamespace(jax=jax, jnp=jnp, aa=jax_auto_augment, Jsd=JaxJsd,
                                 create_transform=transforms_factory.create_transform)


def _image(seed=0, size=32):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return np.asarray(fn())


def _policy(module, config):
    if config.startswith('rand'):
        return module.rand_augment_transform(config, HPARAMS)
    if config.startswith('augmix'):
        return module.augment_and_mix_transform(config, HPARAMS)
    return module.auto_augment_transform(config, HPARAMS)


@pytest.mark.parametrize('magnitude', [3, 9])
@pytest.mark.parametrize('name', sorted(auto_augment.NAME_TO_OP))
def test_op_matches_jax(jx, name, magnitude):
    """Each op at prob 1, a magnitude with Gaussian noise on it, and its
    random sign, fill and resample draws: JAX's image exactly."""
    img = _image(len(name))
    hp = dict(HPARAMS, magnitude_std=0.5)
    port = auto_augment.AugmentOp(name, prob=1.0, magnitude=magnitude, hparams=hp)
    ref = jx.aa.AugmentOp(name, prob=1.0, magnitude=magnitude, hparams=hp)
    for seed in range(3):
        out = _seeded(lambda: port(img), seed)
        assert out.dtype == np.uint8 and out.shape == (32, 32, 3)
        np.testing.assert_array_equal(out, _seeded(lambda: ref(img), seed), err_msg=f'seed {seed}')


@pytest.mark.parametrize('config', POLICIES)
def test_policy_matches_jax(jx, config):
    port, ref = _policy(auto_augment, config), _policy(jx.aa, config)
    for seed in range(6):
        img = _image(seed)
        np.testing.assert_array_equal(_seeded(lambda: port(img), seed),
                                      _seeded(lambda: ref(img), seed), err_msg=f'seed {seed}')


def test_tables_match_jax(jx):
    assert auto_augment.NAME_TO_OP.keys() == jx.aa.NAME_TO_OP.keys() == \
        auto_augment.LEVEL_TO_ARG.keys()
    assert auto_augment._RAND_TRANSFORMS == jx.aa._RAND_TRANSFORMS
    assert auto_augment._RAND_INCREASING_TRANSFORMS == jx.aa._RAND_INCREASING_TRANSFORMS
    assert auto_augment._AUGMIX_TRANSFORMS == jx.aa._AUGMIX_TRANSFORMS
    for name in ('original', 'v0', '3a'):
        ours, ref = (m.auto_augment_policy(name, HPARAMS) for m in (auto_augment, jx.aa))
        assert [[(o.name, o.prob, o.magnitude) for o in sp] for sp in ours] == \
            [[(o.name, o.prob, o.magnitude) for o in sp] for sp in ref]


def test_streams_are_per_sample_whatever_the_interleaving():
    """Two worker threads, each keying its streams per sample, run
    RandAugment and AugMix many times over with the switch interval near
    zero: each image equals the one its key gives alone on this thread,
    and the global streams are neither read nor advanced."""
    tf = [_policy(auto_augment, c) for c in ('rand-m9-mstd0.5-inc1', 'augmix-m3-w3')]
    img = _image(7)

    def apply(key):
        set_sample_key(key)
        try:
            return [np.asarray(t(img)) for t in tf]
        finally:
            set_sample_rng(None)

    keys = [f'0/0/{e}/{p}' for e in range(2) for p in range(4)]
    alone = {k: apply(k) for k in keys}
    assert not all(np.array_equal(alone[keys[0]][0], alone[k][0]) for k in keys[1:])
    random.seed(1)
    np.random.seed(1)
    globals_before = random.getstate(), np.random.get_state()[1].copy()
    results = {0: [], 1: []}

    def worker(w):
        for _ in range(3):
            for k in keys[w::2]:
                results[w].append((k, apply(k)))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    for w in (0, 1):
        assert len(results[w]) == 12
        for k, imgs in results[w]:
            assert all(np.array_equal(a, b) for a, b in zip(imgs, alone[k])), k
    assert random.getstate() == globals_before[0]
    assert np.array_equal(np.random.get_state()[1], globals_before[1])
    assert sample_rng() is random and sample_np_rng() is np.random


@pytest.mark.parametrize('config', POLICIES)
def test_separate_transform_matches_jax_structure(jx, config):
    """create_transform(auto_augment=..., separate=True): JAX's three
    pipelines, stage for stage, and the augment op's parameters (the
    translate constant and fill from the image size and mean, bicubic when
    asked for); under one seed the three stages give JAX's images."""
    kw = dict(is_training=True, auto_augment=config, interpolation='bicubic', separate=True,
              output_dtype=np.uint8)
    ours, ref = create_transform(32, **kw), jx.create_transform(32, **kw)
    assert isinstance(ours, tuple) and len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        assert [type(t).__name__ for t in a.transforms] == [type(t).__name__ for t in b.transforms]
    aug, jaug = ours[1].transforms[0], ref[1].transforms[0]
    ops = aug.ops if hasattr(aug, 'ops') else [op for sp in aug.policy for op in sp]
    jops = jaug.ops if hasattr(jaug, 'ops') else [op for sp in jaug.policy for op in sp]
    assert [(o.name, o.prob, o.magnitude, o.hparams, o.kwargs) for o in ops] == \
        [(o.name, o.prob, o.magnitude, o.hparams, o.kwargs) for o in jops]
    assert ops[0].hparams['translate_const'] == 14 and ops[0].kwargs['fillcolor'] == (124, 116, 104)
    img = _image(3, size=40)
    for seed in range(2):
        x = _seeded(lambda: ours[2](ours[1](ours[0](img))), seed)
        np.testing.assert_array_equal(x, _seeded(lambda: ref[2](ref[1](ref[0](img))), seed))
    assert [type(t).__name__ for t in create_transform(32, **dict(kw, separate=False)).transforms] \
        == [type(t).__name__ for t in jx.create_transform(32, **dict(kw, separate=False)).transforms]


def test_augmix_loader_collates_split_major(tmp_path):
    """AugMixDataset of 3 splits with create_loader(num_aug_splits=3): each
    batch of 4 samples is 12 images, split-major, the targets tiled; the
    augmented splits differ from the clean one, and a second loader with
    the same seed gives the same batch."""
    rng = np.random.default_rng(0)
    for c in ('a', 'b'):
        (tmp_path / 'train' / c).mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                tmp_path / 'train' / c / f'{i}.png')

    def first_batch(workers):
        ds = AugMixDataset(create_dataset('', str(tmp_path), split='train'), num_splits=3)
        loader = create_loader(ds, (3, 32, 32), 4, is_training=True, num_aug_splits=3,
                               num_workers=workers, auto_augment='augmix-m3-w2', seed=1)
        return next(iter(loader))

    x, t = first_batch(2)
    assert x.shape == (12, 32, 32, 3) and x.dtype == np.float32 and t.shape == (12,)
    assert (t[:4] == t[4:8]).all() and (t[:4] == t[8:]).all()
    assert not np.array_equal(x[:4], x[4:8]) and not np.array_equal(x[:4], x[8:])
    x1, t1 = first_batch(1)
    assert np.array_equal(x, x1) and np.array_equal(t, t1)


@pytest.mark.parametrize('splits', [2, 3])
def test_jsd_loss_and_grads_match_jax(jx, splits):
    rng = np.random.default_rng(splits)
    logits = (rng.standard_normal((4 * splits, 10)) * 3).astype(np.float32)
    target = np.tile(rng.integers(0, 10, 4), splits)
    port = JsdCrossEntropy(num_splits=splits, smoothing=0.1)
    ref = jx.Jsd(num_splits=splits, smoothing=0.1)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = port(x, torch.from_numpy(target))
    loss.backward()
    jt = jx.jnp.asarray(target)
    jloss, jgrad = jx.jax.value_and_grad(lambda z: ref(z, jt))(jx.jnp.asarray(logits))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5)
