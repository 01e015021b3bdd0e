"""NaFlex of the PyTorch port against the JAX package on the CPU: the model
(test_naflexvit: fp32 on every token in both mask modes, 'max' pooling, an
NHWC image with its intermediates, a variable patch size, bf16), the
attention mask, ``resample_patch_embed`` against ``jax.image.resize``, the
loader's batches bit for bit (budget and native modes, mixup / cutmix,
'const' erasing, patch-size choices, the device-augment erase masks), the
device program's 'pixel' fill by distribution and its normalize against
JAX's, three ``NaFlexClassificationTask`` AdamW steps with soft targets
against JAX's task, the JAX task's checkpoint loaded strictly, and the
train driver with ``--naflex-loader`` on the CPU, resumed bit for bit.

JAX is imported inside the fixtures: models are built from their shapes
(``nnx.eval_shape``) with seeded numpy weights and carried across, and run
eagerly. The
``gpu`` tests run on the card: the padded query rows and the key-padded
rows of the flash kernel against the plain version, and bucket graphs
replayed in a random order against eager steps.
"""
import os
import random
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers import SeqPadMask, resample_patch_embed
from timm_tpu_torch.models import convert_jax_checkpoint, load_jax_state_dict
from timm_tpu_torch.models.naflexvit import create_attention_mask
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = 'test_naflexvit'
VALID = (40, 23, 7)        # valid tokens of the 3 rows at L 40
LR = 1e-3


def _seeded(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(shapes.items()):
        scale = k.rpartition('.')[2] == 'scale'
        v = 1.0 + 0.1 * rng.standard_normal(shape) if scale else 0.05 * rng.standard_normal(shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu

    def build(name=NAME, seed=0, **kw):
        """The JAX model ``name`` from its shapes, with seeded weights."""
        abstract = nnx.eval_shape(lambda: timm_tpu.create_model(name, **kw))
        graphdef, params, rest = nnx.split(abstract, nnx.Param, ...)
        shapes = {'.'.join(map(str, k)): tuple(v.get_value().shape)
                  for k, v in nnx.to_flat_state(params)}
        values = _seeded(shapes, seed)
        filled = nnx.from_flat_state({tuple(int(p) if p.isdigit() else p for p in k.split('.')):
                                      nnx.Param(jnp.asarray(v)) for k, v in values.items()})
        model = nnx.merge(graphdef, filled, rest)
        model.eval()
        return model, values

    def features_and_logits(m, d):
        return m.forward_features(d['patches'], d['patch_coord'], d['patch_valid']), m(d)

    # eager: two blocks of 64 channels run faster op by op here than one
    # compile of each program
    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu, build=build,
                                 fwd=features_and_logits, call=lambda m, x: m(x))


def _batch(seed, valid=VALID, seq_len=40, patch_dim=768, num_classes=1000):
    """A dict batch: seeded patches, each row's first n tokens valid on a
    grid 8 wide, the rest zero padding; targets, partner targets and lam."""
    rng = np.random.default_rng(seed)
    B = len(valid)
    patches = rng.standard_normal((B, seq_len, patch_dim)).astype(np.float32)
    coord = np.zeros((B, seq_len, 2), np.int32)
    mask = np.zeros((B, seq_len), bool)
    for i, n in enumerate(valid):
        j = np.arange(n)
        coord[i, :n, 0], coord[i, :n, 1] = j // 8, j % 8
        mask[i, :n] = True
        patches[i, n:] = 0.0
    return {'patches': patches, 'patch_coord': coord, 'patch_valid': mask,
            'target': rng.integers(0, num_classes, B), 'target_b': rng.integers(0, num_classes, B),
            'lam': rng.uniform(0.3, 1.0, B).astype(np.float32)}


def _inputs(batch, lib):
    keys = ('patches', 'patch_coord', 'patch_valid')
    if lib == 'torch':
        return {k: torch.from_numpy(batch[k]) for k in keys}
    return {k: lib.asarray(batch[k]) for k in keys}


def _port(values, dtype=None, **kw):
    tm = timm_tpu_torch.create_model(NAME, device='cpu', dtype=dtype, **kw).eval()
    return load_jax_state_dict(tm, values)


# ---- the model -----------------------------------------------------------------

@pytest.mark.parametrize('mask_mode,pool', [('symmetric', 'avg'), ('key', 'avg'),
                                            ('symmetric', 'max')])
def test_fp32_every_token_matches_jax(jx, mask_mode, pool):
    """Every token of the features, padded ones included, and the logits
    within 1e-5 of JAX's: the padded query rows take JAX's value in
    'symmetric' mode (the mean of v) and attend to the valid keys in 'key'
    mode."""
    kw = dict(mask_mode=mask_mode, global_pool=pool)
    jm, values = jx.build(**kw)
    tm = _port(values, **kw)
    b = _batch(1)
    jf, jl = jx.fwd(jm, _inputs(b, jx.jnp))
    with torch.no_grad():
        d = _inputs(b, 'torch')
        f = tm.forward_features(d['patches'], d['patch_coord'], d['patch_valid'])
        logits = tm(d)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_image_input_variable_patch_size_and_intermediates_match_jax(jx):
    """An NHWC image (patchified, no mask), its forward_intermediates (NHWC
    grids), and a batch of 8 x 8 patches through the resampled projection
    kernel, within 1e-5 of JAX's."""
    jm, values = jx.build()
    tm = _port(values)
    x = np.random.default_rng(2).standard_normal((2, 48, 64, 3)).astype(np.float32)
    small = _batch(3, patch_dim=8 * 8 * 3)
    with torch.no_grad():
        logits = tm(torch.from_numpy(x)).numpy()
        _, inter = tm.forward_intermediates(torch.from_numpy(x), indices=2)
        small_logits = tm(_inputs(small, 'torch')).numpy()
    np.testing.assert_allclose(logits, np.asarray(jx.call(jm, jx.jnp.asarray(x))), atol=1e-5, rtol=0)
    _, jinter = jm.forward_intermediates(jx.jnp.asarray(x), indices=2)
    assert [tuple(t.shape) for t in inter] == [(2, 3, 4, 64)] * 2
    for a, b in zip(inter, jinter):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(small_logits, np.asarray(jx.call(jm, _inputs(small, jx.jnp))),
                               atol=1e-5, rtol=0)


def test_bf16_matches_jax(jx):
    """bf16 compute against JAX bf16: relative L2 <= 2e-2 on the logits."""
    jm, values = jx.build(dtype=jx.jnp.bfloat16)
    tm = _port(values, dtype=torch.bfloat16)
    b = _batch(4)
    with torch.no_grad():
        got = tm(_inputs(b, 'torch')).float().numpy()
    want = np.asarray(jx.call(jm, _inputs(b, jx.jnp)).astype('float32'))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


@pytest.mark.parametrize('symmetric', [True, False])
def test_attention_mask_and_seq_pad_mask(jx, symmetric):
    """create_attention_mask equals JAX's with prefix tokens; a SeqPadMask's
    dense form is that mask, and through the dispatcher on the CPU (the
    flash kernel's plain version, then the padded query rows filled) it
    gives what JAX's plain attention gives with the dense mask."""
    from timm_tpu.layers.attention import _sdpa as jsdpa
    from timm_tpu.models.naflexvit import create_attention_mask as jmask

    from timm_tpu_torch.layers.attention import scaled_dot_product_attention
    valid = _batch(5)['patch_valid']
    want = np.asarray(jmask(jx.jnp.asarray(valid), num_prefix_tokens=2, symmetric=symmetric))
    got = create_attention_mask(torch.from_numpy(valid), num_prefix_tokens=2, symmetric=symmetric)
    assert np.array_equal(got.numpy(), want)
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((3, 2, 40, 16)).astype(np.float32) for _ in range(3))
    mask = SeqPadMask(torch.from_numpy(valid), symmetric)
    out = scaled_dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)), attn_mask=mask)
    ref = np.asarray(jsdpa(*(jx.jnp.asarray(t) for t in (q, k, v)),
                           jx.jnp.asarray(mask.dense().numpy())))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('old,new', [(16, 8), (16, 24), (16, 12), (8, 14)])
def test_resample_patch_embed_matches_jax_image_resize(old, new):
    """The projection kernel resized as jax.image.resize(method='cubic',
    antialias=True) resizes it, down and up: within 1e-6 of JAX's on a
    kernel drawn as the model draws it (std 0.02), and within 1e-6 relative
    of the exact (fp64) resize on a unit-scale kernel, where JAX's own fp32
    contraction lands up to 2e-6 from the exact value."""
    import jax
    import jax.numpy as jnp

    from timm_tpu_torch.layers import resample_weight_matrix
    rng = np.random.default_rng(old * 100 + new)
    kernel = (0.02 * rng.standard_normal((old, old, 3, 5))).astype(np.float32)  # HWIO
    want = np.asarray(jax.image.resize(jnp.asarray(kernel), (new, new, 3, 5), 'cubic',
                                       antialias=True))
    got = resample_patch_embed(torch.from_numpy(kernel).permute(3, 0, 1, 2), (new, new))
    assert tuple(got.shape) == (5, new, new, 3)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want, atol=1e-6, rtol=0)
    unit = rng.standard_normal((old, old, 3, 5)).astype(np.float32)
    w = resample_weight_matrix(old, new).double().numpy()
    exact = np.einsum('hwio,ha,wb->abio', unit.astype(np.float64), w, w)
    got = resample_patch_embed(torch.from_numpy(unit).permute(3, 0, 1, 2),
                               (new, new)).permute(1, 2, 3, 0).double().numpy()
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()


# ---- the loader ----------------------------------------------------------------

@pytest.fixture(scope='module')
def pngs(tmp_path_factory):
    """train/ and validation/ class folders of seeded PNGs, 20-90 px a side."""
    from PIL import Image
    root = tmp_path_factory.mktemp('naflex_pngs')
    rng = np.random.default_rng(0)
    for split, per_class in (('train', 6), ('validation', 2)):
        for c in range(3):
            d = root / split / f'c{c}'
            d.mkdir(parents=True)
            for i in range(per_class):
                h, w = rng.integers(20, 91, 2)
                Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(d / f'{i}.png')
    return str(root)


_LOADERS = {
    'budget_mixup_const': dict(seq_lens=(16, 32, 64), patch_size=8, mixup_alpha=0.8,
                               cutmix_alpha=1.0, re_prob=0.5, re_mode='const'),
    'budget_patch_sizes_device_masks': dict(seq_lens=(16, 32, 64), patch_size=8,
                                            patch_size_choices=(8, 12, 16), re_prob=0.5,
                                            re_mode='pixel', device_augment=True, mixup_alpha=0.8),
    'native_mixup_pixel': dict(seq_lens=(16, 32, 64), patch_size=8, cutmix_alpha=1.0, re_prob=0.5,
                               re_mode='pixel', bucket_mode='native'),
}


def _loader(lib, root, case, **kw):
    if lib == 'torch':
        from timm_tpu_torch.data.dataset_factory import create_dataset
        from timm_tpu_torch.data.naflex_loader import NaFlexLoader
    else:
        from timm_tpu.data import create_dataset
        from timm_tpu.data.naflex_loader import NaFlexLoader
    return NaFlexLoader(create_dataset('', root, split='train'), tokens_per_batch=128,
                        is_training=True, seed=3, **dict(_LOADERS[case], **kw))


def _batches(loader, epoch, hflip_seed=None):
    loader.set_epoch(epoch)
    if hflip_seed is not None:
        random.seed(hflip_seed)  # the JAX loader flips from the global stream
    return list(loader)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k


@pytest.mark.parametrize('case', sorted(_LOADERS))
def test_loader_batches_equal_jax_bit_for_bit(pngs, case):
    """Epoch 0's batches, every array and host scalar, equal the JAX
    loader's: the same PIL resizes and the same draws in the same order
    (its flip stream seeded with the port's flip seed)."""
    state = random.getstate()
    try:
        port = _loader('torch', pngs, case)
        got = _batches(port, 0)
        want = _batches(_loader('jax', pngs, case), 0, hflip_seed=port.hflip_seed(0))
    finally:
        random.setstate(state)
    _assert_batches_equal(got, want)
    if case.startswith('budget_patch'):
        assert {b['patch_size'] for b in got} > {8} and all('erase_mask' in b for b in got)


def test_loader_epoch_is_a_function_of_seed_and_epoch(pngs):
    """Epoch 1 from a fresh loader equals epoch 1 after epoch 0 (the flip
    and erasing streams are reseeded per epoch, ROADMAP C), which is what a
    run resumed mid-epoch regenerates."""
    case = 'budget_mixup_const'
    a = _loader('torch', pngs, case)
    _batches(a, 0)
    _assert_batches_equal(_batches(_loader('torch', pngs, case), 1), _batches(a, 1))


def test_create_naflex_loader_scales_the_budget_with_accumulation(pngs):
    from timm_tpu_torch.data.dataset_factory import create_dataset
    from timm_tpu_torch.data.naflex_loader import calculate_naflex_batch_size, create_naflex_loader
    loader = create_naflex_loader(create_dataset('', pngs, split='train'), patch_size=8,
                                  train_seq_lens=(16, 32), max_seq_len=32, batch_size=2,
                                  grad_accum_steps=2, is_training=True)
    assert loader.tokens_per_batch == 2 * 2 * 32 and loader.batch_divisor == 2
    assert all(b['patches'].shape[0] % 2 == 0 for b in loader)
    assert calculate_naflex_batch_size(36864, 128) == 288
    assert calculate_naflex_batch_size(36864, 1024) == 36


# ---- the device program ----------------------------------------------------------

def test_device_program_normalize_and_pixel_fill():
    """The NaFlex device program on the CPU: the unerased tokens equal
    JAX's normalize bit for bit; 'pixel' fills the erased ones with N(0, 1)
    noise (mean within 0.05 of 0 and std within 0.05 of 1 over about 25k
    values: 8 standard errors, so a wrong scale or shift fails, sampling
    does not) keyed by (seed, epoch, step); the host scalars pass
    through."""
    import jax.numpy as jnp

    from timm_tpu.data.device_augment import augment_naflex_batch as jaug

    from timm_tpu_torch.data import NaFlexDeviceAugment
    rng = np.random.default_rng(7)
    B, L, D = 8, 64, 192
    batch = {'patches': rng.random((B, L, D), dtype=np.float32),
             'patch_valid': np.ones((B, L), bool), 'erase_mask': rng.random((B, L)) < 0.25,
             'seq_len': L}
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    stage = NaFlexDeviceAugment([], mean, std, re_mode='pixel', noise_seed=3, device='cpu')
    out = stage(batch, epoch=1, step=2)
    want = np.asarray(jaug({k: jnp.asarray(v) for k, v in batch.items() if k != 'seq_len'},
                           mean=mean, std=std, re_mode='const')['patches'])
    erased = batch['erase_mask']
    p = out['patches'].numpy()
    assert out['seq_len'] == L and 'erase_mask' not in out
    assert np.array_equal(p[~erased], want[~erased])
    noise = p[erased]
    assert noise.size > 20000 and abs(noise.mean()) < 0.05 and abs(noise.std() - 1.0) < 0.05
    again = stage(batch, epoch=1, step=2)['patches'].numpy()
    other = stage(batch, epoch=1, step=3)['patches'].numpy()
    assert np.array_equal(again, p) and not np.array_equal(other[erased], noise)


# ---- the task and the checkpoint --------------------------------------------------

@pytest.fixture(scope='module')
def task_steps(jx):
    """JAX's NaFlexClassificationTask and the port's from the same weights
    after three AdamW steps (clip 1.0, weight decay 0.05 with the mask,
    soft targets from lam and target_b with smoothing 0.1); the JAX task's
    checkpoint state."""
    from timm_tpu.loss import SoftTargetCrossEntropy as JSoft
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.task import NaFlexClassificationTask as JTask

    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import NaFlexClassificationTask
    jm, values = jx.build()
    jm.train()
    jtask = JTask(jm, optimizer=jopt(jm, opt='adamw', lr=LR, weight_decay=0.05),
                  mesh=create_mesh(jx.jax.devices()[:1]), train_loss_fn=JSoft(), clip_grad=1.0,
                  nonfinite_guard=False, mixup_label_smoothing=0.1)
    tm = _port(values).train()
    task = NaFlexClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05),
        train_loss_fn=SoftTargetCrossEntropy(), clip_grad=1.0, nonfinite_guard=False,
        mixup_label_smoothing=0.1)
    losses = []
    for step in range(1, 4):
        b = _batch(10 + step)
        jmetrics = jtask.train_step({k: jx.jnp.asarray(v) for k, v in b.items()}, lr=LR, step=step)
        metrics = task.train_step(b, lr=LR, step=step)
        losses.append((float(metrics['loss']), float(jmetrics['loss'])))
    return types.SimpleNamespace(losses=losses, task=task, checkpoint=jtask.get_checkpoint_state(),
                                 jstate=jx.timm_tpu.models._helpers.model_state_dict(jm))


def test_three_adamw_steps_match_jax_task(task_steps):
    """Each step's loss within 1e-6 and the parameters after three steps
    within 1e-5 of JAX's."""
    for ours, ref in task_steps.losses:
        assert np.isfinite(ours) and abs(ours - ref) <= 1e-6
    from timm_tpu_torch.models import convert_jax_state_dict
    want = {k: v.numpy() for k, v in convert_jax_state_dict(task_steps.jstate).items()}
    got = {k: v.detach().numpy() for k, v in task_steps.task.model.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)


def test_jax_task_checkpoint_round_trips_strictly(task_steps):
    """The JAX task's checkpoint (weights, m, v, count; NaFlexVit's
    embeds.proj, factorized position tables) through convert_jax_checkpoint
    into a fresh port task, strictly, equal key by key; a missing key
    raises."""
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import NaFlexClassificationTask
    port_state = convert_jax_checkpoint(task_steps.checkpoint)
    tm = timm_tpu_torch.create_model(NAME, device='cpu', seed=5)
    task = NaFlexClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05))
    task.load_checkpoint_state(port_state)
    ours = task.get_checkpoint_state()
    assert int(ours['optimizer.count']) == 3
    assert port_state['state_dict.embeds.proj.weight'].shape == (64, 768)
    assert port_state['state_dict.embeds.pos_embed_y'].shape == (24, 64)
    for k, v in port_state.items():
        if k.startswith(('state_dict.', 'optimizer.mu.', 'optimizer.nu.')):
            assert np.array_equal(ours[k], v), k
    with pytest.raises(KeyError, match='Missing'):
        task.load_checkpoint_state({k: v for k, v in port_state.items()
                                    if k != 'optimizer.nu.embeds.pos_embed_x'})


def test_accumulation_and_ema_evaluation_take_dict_batches():
    """Gradient accumulation splits a dict batch's arrays and leaves its
    host scalars: two microbatches of 2 rows give the step of one batch of
    4 (loss and parameters within 1e-6); the EMA evaluation runs
    eval_forward on the dict with the EMA weights."""
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import NaFlexClassificationTask
    b = _batch(30, valid=(40, 33, 21, 9))
    b['seq_len'] = 40
    out = []
    for accum in (1, 2):
        tm = timm_tpu_torch.create_model(NAME, device='cpu', seed=1)
        task = NaFlexClassificationTask(
            tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05),
            train_loss_fn=SoftTargetCrossEntropy(), mixup_label_smoothing=0.1,
            grad_accum_steps=accum, nonfinite_guard=False)
        task.setup_ema(decay=0.5)
        loss = float(task.train_step(b, lr=LR, step=1)['loss'])
        out.append((loss, task.optimizer.flat_param.clone(), task))
    (l1, p1, _), (l2, p2, task) = out
    assert abs(l1 - l2) <= 1e-6 and float((p1 - p2).abs().max()) <= 1e-6
    task.train_step(b, lr=LR, step=5)  # the EMA now lags the weights
    x = {k: b[k] for k in ('patches', 'patch_coord', 'patch_valid')}
    got = task.eval_step(x, use_ema=True)
    task.model.eval()
    with torch.no_grad():
        want = torch.func.functional_call(task.model, task.ema_params, (_inputs(b, 'torch'),))
        live = task.model(_inputs(b, 'torch'))
    assert torch.equal(got, want) and not torch.equal(got, live)


# ---- the train driver --------------------------------------------------------------

def _train(root, out, experiment, *extra):
    import signal

    from timm_tpu_torch import train
    argv = ['--device', 'cpu', '--data-dir', root, '--model', NAME, '--naflex-loader',
            '--naflex-train-seq-lens', '16', '32', '64', '--naflex-max-seq-len', '32', '-b', '4',
            '--epochs', '2', '--opt', 'adamw', '--lr', '1e-3', '--mixup', '0.8', '--cutmix', '1.0',
            '--reprob', '0.5', '--device-augment', '--model-ema', '--drop-path', '0.1',
            '--output', out, '--experiment', experiment, '--log-interval', '1', *extra]
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return train.main(argv)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def test_train_driver_naflex_resumes_bit_for_bit(pngs, tmp_path):
    """``train --naflex-loader --device cpu`` over the PNGs (buckets 16 /
    32 / 64, mixup, 'pixel' erasing in the device program, EMA): run A;
    run B stopped by SIGTERM after update 2 and resumed with --resume
    auto; the resumed last.npz equals A's bit for bit."""
    import logging
    saved = (random.getstate(), np.random.get_state(), torch.get_rng_state(),
             set(logging.root.handlers), logging.root.level)
    out = str(tmp_path)
    try:
        assert _train(pngs, out, 'a') == 0
        assert _train(pngs, out, 'b', '--fault-inject', 'sigterm@2') == 0
        assert any(n.startswith('recovery-') for n in os.listdir(os.path.join(out, 'b')))
        assert _train(pngs, out, 'b', '--resume', 'auto') == 0
    finally:
        random.setstate(saved[0])
        np.random.set_state(saved[1])
        torch.set_rng_state(saved[2])
        for h in list(logging.root.handlers):
            if h not in saved[3]:
                logging.root.removeHandler(h)
        logging.root.setLevel(saved[4])
    with np.load(os.path.join(out, 'a', 'last.npz')) as a, \
            np.load(os.path.join(out, 'b', 'last.npz')) as b:
        keys = [k for k in a.files if k.startswith(('state_dict', 'optimizer.'))]
        assert set(keys) <= set(b.files) and any(k.startswith('state_dict_ema.') for k in keys)
        for k in keys:
            assert np.array_equal(a[k], b[k]), k


def test_naflex_flags_refuse_distill():
    from timm_tpu_torch import train
    with pytest.raises(ValueError, match='does not compose with --naflex-loader'):
        train.main(['--device', 'cpu', '--naflex-loader', '--distill', 'teacher=x'])


# ---- on the card ---------------------------------------------------------------------

def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize('symmetric', [True, False])
def test_seq_pad_attention_on_card_matches_plain(symmetric):
    """On the card a SeqPadMask runs the flash kernel (one launch, no plain
    attention) and, in 'symmetric' mode, writes the mean of v into the
    padded query rows: valid and padded rows within flash's parity_tol of
    the plain version (``_sdpa`` with the dense mask) at bf16, N 576."""
    _card_or_skip()
    from timm_tpu_torch.kernels import flash_attention, registry
    from timm_tpu_torch.layers.attention import _sdpa, scaled_dot_product_attention
    g = torch.Generator(device='cuda').manual_seed(0)
    q, k, v = [(0.5 * torch.randn(4, 12, 576, 64, generator=g, device='cuda')).to(torch.bfloat16)
               for _ in range(3)]
    valid = torch.arange(576, device='cuda')[None, :] < torch.tensor(
        [[576], [401], [200], [64]], device='cuda')
    mask = SeqPadMask(valid, symmetric)
    before = flash_attention.launches
    out = scaled_dot_product_attention(q, k, v, attn_mask=mask)
    assert flash_attention.launches == before + 1
    plain = _sdpa(q, k, v, mask.dense())
    diff = (out.float() - plain.float()).abs().amax(dim=(1, 3))
    tol = registry.get('flash_attention').parity_tol
    assert float(diff[valid].max()) <= tol and float(diff[~valid].max()) <= tol


@pytest.mark.gpu
def test_bucket_graphs_replay_in_random_order_on_card():
    """test_naflexvit's train step over buckets of three shapes in a random
    order, 9 steps through the graphs (each bucket's warm-up, capture and a
    replay after other buckets ran) against 9 eager steps of the body from
    the same state: every metric and every buffer equal bit for bit."""
    _card_or_skip()
    from timm_tpu_torch.layers.drop import get_drop_generator
    from timm_tpu_torch.loss import SoftTargetCrossEntropy
    from timm_tpu_torch.optim import create_optimizer_v2
    from timm_tpu_torch.task import NaFlexClassificationTask
    shapes = [(8, 16), (4, 32), (2, 64)]
    order = [0, 1, 2, 1, 0, 2, 2, 0, 1]
    batches = [_batch(20 + i, valid=tuple(L - r for r in range(B)), seq_len=L)
               for i, (B, L) in enumerate(shapes[j] for j in order)]
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()} for b in batches]

    def task():
        m = timm_tpu_torch.create_model(NAME, device='cuda', dtype=torch.bfloat16, seed=0,
                                        drop_path_rate=0.1)
        return NaFlexClassificationTask(
            m, optimizer=create_optimizer_v2(m, opt='adamw', lr=LR, weight_decay=0.05),
            train_loss_fn=SoftTargetCrossEntropy(), clip_grad=1.0, mixup_label_smoothing=0.1,
            seed=0)
    runs = []
    for graphed in (False, True):
        t = task()
        metrics = []
        for s, b in enumerate(batches, start=1):
            if graphed:
                metrics.append(t.train_step(b, lr=LR * s, step=s))
            else:
                t.optimizer.set_hyperparams(lr=LR * s, ema_decay=0.0)
                t.model.train()
                metrics.append({k: v.clone() for k, v in t._train_body(b).items()})
        torch.cuda.synchronize()
        opt = t.optimizer
        runs.append((metrics, [opt.flat_param.clone(), opt.m.clone(), opt.v.clone(),
                               opt.count.clone(), get_drop_generator(t.model).get_state()]))
        if graphed:
            assert t.train_graphs.captures == 3 and t.train_graphs.replays == 6
    (m_e, s_e), (m_g, s_g) = runs
    for a, b in zip(m_e, m_g):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(s_e, s_g):
        assert torch.equal(a, b)
