"""ResNet of the PyTorch port against the JAX package on the CPU: the
anti-aliasing layers, ECA, the pooling helpers, five small ResNets that
between them cover every stem, downsample, anti-aliasing, attention, norm
and block variant of the JAX module (fp32 and bf16, eval and train mode,
the running statistics), split BatchNorm, the test-time pool head, one SGD
train step with split BN against JAX's step, strict loading of a JAX task
checkpoint, and the registry; and resnet50 on the card (``gpu`` tests).

The JAX models are built from their shapes (``nnx.eval_shape``) with one
block a stage and narrow stages, given seeded numpy weights and running
statistics (blur pool keeps its binomial filter), and carried across with
``load_jax_state_dict``; every block's last BatchNorm scale is seeded, so no
residual branch is zero as ``zero_init_last`` leaves it. JAX is imported
inside the fixtures and compiles each forward once (``nnx.jit``).
"""
import functools
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers import (
    AvgPool2dAA, BlurPool2d, CecaModule, EcaModule, SplitBatchNormAct2d, TestTimePoolHead,
    apply_test_time_pool, convert_splitbn_model, get_aa_layer, get_attn,
)
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.models import convert_jax_checkpoint, convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.models.resnet import ResNet, avg_pool2d, max_pool2d
from timm_tpu_torch.optim import create_optimizer_v2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_efficientnet import _assert_close, _jax_train_step, _rel

SIZE = 64
NARROW = dict(layers=(1, 1, 1, 1), channels=(32, 32, 64, 64), num_classes=10)
# five small ResNets covering the JAX module's variants between them
VARIANTS = {
    # Bottleneck, 'deep_tiered' stem, avg-pool downsample, ECA, cardinality 32
    'eca_next': ('ecaresnext26t_32x4d', {}),
    # BasicBlock, blur pool (reflect) in the blocks and after a stride-1 stem
    # max pool, output stride 16 (dilated last stage)
    'blur_os16': ('resnetblur18', dict(output_stride=16)),
    # Bottleneck, 'deep' stem, average-pool anti-aliasing, SE
    'aa_se': ('seresnetaa50d', {}),
    # GroupNorm, plain 7x7 stem and 1x1 conv downsample
    'gn': ('resnet50_gn', {}),
    # BasicBlock, the strided-conv stem pool with zero-padded blur, CECA
    'rs_ceca': ('test_resnet', dict(replace_stem_pool=True, aa_layer='blurpc',
                                    block_args=dict(attn_layer='ceca'))),
}


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _blur_filter(shape):
    """JAX's BlurPool2d filter, (k, k, 1, C) of the binomial coefficients."""
    k = shape[0]
    b = np.asarray((np.poly1d((0.5, 0.5)) ** (k - 1)).coeffs, np.float32)
    return np.tile((b[:, None] * b[None, :])[:, :, None, None], (1, 1, 1, shape[3]))


def _seeded(flat_shapes, seed):
    """Seeded values for a JAX ResNet's variables (JAX names and layouts):
    statistics of a BatchNorm's own, weights of order one a layer."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(flat_shapes.items()):
        leaf = key.rpartition('.')[2]
        if leaf == '_kernel':
            v = _blur_filter(shape)
        elif leaf == 'mean':
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'bias':
            v = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 4:  # HWIO: variance scaling 2.0 over fan-in
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[2]))
        elif len(shape) == 3:  # ECA's (k, 1, 1)
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
        else:  # (in, out)
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
        out[key] = v.astype(np.float32)
    return out


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict

    def key_path(k):
        return tuple(int(p) if p.isdigit() else p for p in k.split('.'))

    def build(name, seed=0, values=None, splits=0, **kw):
        """The JAX model from its shapes with seeded (or given) values,
        converted to split BN of ``splits`` when given; (model, values)."""
        def make():
            m = timm_tpu.create_model(name, **kw)
            if splits:
                from timm_tpu.layers import convert_splitbn_model as jconvert
                m = jconvert(m, splits)
            return m
        abstract = nnx.eval_shape(make)
        graphdef, state = nnx.split(abstract)
        flat = {'.'.join(map(str, k)): v for k, v in nnx.to_flat_state(state)
                if 'rngs' not in '.'.join(map(str, k))}
        if values is None:
            values = _seeded({k: tuple(v.get_value().shape) for k, v in flat.items()}, seed)
        filled = nnx.from_flat_state({key_path(k): type(v)(jnp.asarray(values[k]).astype(
            v.get_value().dtype)) for k, v in flat.items()})
        rest = {k: v for k, v in nnx.to_flat_state(state) if 'rngs' in '.'.join(map(str, k))}
        model = nnx.merge(graphdef, filled, nnx.from_flat_state(rest))
        model.eval()
        return model, values

    def features_and_logits(m, x):
        feats = m.forward_features(x)
        return feats, m.forward_head(feats)

    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu,
                                 state=model_state_dict, build=build,
                                 fwd=nnx.jit(features_and_logits),
                                 call=nnx.jit(lambda m, x: m(x)))


def _weights(values):
    """The values ``model_state_dict`` would give: no underscore constants."""
    return {k: v for k, v in values.items() if not any(p.startswith('_') for p in k.split('.'))}


def _port(name, values, dtype=None, splits=0, **kw):
    tm = timm_tpu_torch.create_model(name, device='cpu', dtype=dtype, **kw)
    if splits:
        convert_splitbn_model(tm, splits)
    return load_jax_state_dict(tm.eval(), _weights(values))


def _stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items() if 'running_' in k}


def _jax_stats(jx, model):
    return {k: v.numpy() for k, v in convert_jax_state_dict(jx.state(model)).items()
            if 'running_' in k}


# ---- layers ---------------------------------------------------------------------------

@pytest.mark.parametrize('size', [8, 7])
def test_aa_layers_and_pools_match_jax(jx, size):
    """'blur', 'blurpc' and 'avg' anti-aliasing, ResNet's 'SAME' average pool
    and symmetric max pool on an even and an odd input: fp32 within 1e-6,
    bf16 within 2e-2 (JAX sums its bf16 windows in bf16)."""
    import timm_tpu.layers as jl
    from timm_tpu.models import resnet as jres
    x = np.random.default_rng(size).standard_normal((2, size, size, 6)).astype(np.float32)
    cases = [
        (jl.BlurPool2d(6, rngs=jx.nnx.Rngs(0)), BlurPool2d(6)),
        (jl.get_aa_layer('blurpc')(6, rngs=jx.nnx.Rngs(0)), get_aa_layer('blurpc')(6)),
        (jl.AvgPool2dAA(stride=2), AvgPool2dAA(stride=2)),
        (lambda v: jres.avg_pool2d(v, 2, 2, pad_same=True), lambda v: avg_pool2d(v, 2, 2, True)),
        (lambda v: jres.max_pool2d(v, 3, 2), lambda v: max_pool2d(v, 3, 2)),
        (lambda v: jres.max_pool2d(v, 3, 1), lambda v: max_pool2d(v, 3, 1)),
    ]
    for jfn, tfn in cases:
        for dtype, tol in (('float32', 1e-6), ('bfloat16', 2e-2)):
            ref = np.asarray(jfn(jx.jnp.asarray(x).astype(dtype)).astype('float32'))
            out = tfn(torch.from_numpy(x).to(getattr(torch, dtype)))
            assert out.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    assert get_aa_layer(None) is None and get_aa_layer('avg') is AvgPool2dAA
    assert get_aa_layer(BlurPool2d) is BlurPool2d and get_aa_layer('blur') is BlurPool2d
    with pytest.raises(ValueError, match='Unknown'):
        get_aa_layer('noaa')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', ['eca', 'ceca'])
def test_eca_matches_jax(jx, name, dtype):
    """ECA / CECA by name, the kernel size from the channel count, on
    carried weights: fp32 within 1e-6, bf16 within 2e-2, JAX's output dtype
    (with no module dtype a bf16 input is gated in fp32)."""
    from timm_tpu.layers.create_attn import get_attn as jget
    jt = getattr(jx.jnp, dtype)
    for channels, k, mdtype in ((64, 3, None), (256, 5, jt)):
        jm = jget(name)(channels, dtype=mdtype, rngs=jx.nnx.Rngs(0))
        tm = get_attn(name)(channels, dtype=None if mdtype is None else getattr(torch, dtype))
        assert isinstance(tm, CecaModule if name == 'ceca' else EcaModule)
        assert tm.conv.weight.shape == (1, 1, k)
        w = np.random.default_rng(k).standard_normal((k, 1, 1)).astype(np.float32)
        jm.conv.kernel[...] = jx.jnp.asarray(w)
        load_jax_state_dict(tm, {'conv.kernel': w})
        x = np.random.default_rng(1).standard_normal((2, 3, 3, channels)).astype(np.float32)
        ref = jm(jx.jnp.asarray(x).astype(jt))
        with torch.no_grad():
            out = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
        assert str(out.dtype).split('.')[-1] == str(ref.dtype)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')),
                                   atol=1e-6 if dtype == 'float32' else 2e-2, rtol=0)


# ---- the five ResNets --------------------------------------------------------------------

@pytest.fixture(scope='module')
def fp32_runs(jx):
    """Each variant in fp32, JAX and the port from one set of values (and
    the port in fp64 beside them): an eval forward, three train-mode
    forwards (the statistics move), and an eval forward on the moved
    statistics."""
    runs = {}
    for key, (name, kw) in VARIANTS.items():
        kw = dict(NARROW, **kw)
        jm, values = jx.build(name, seed=len(runs), **kw)
        tm = _port(name, values, **kw)
        t64 = _port(name, values, **kw).double()
        xs = [_images(10 + i) for i in range(4)]
        out = {'jax': [], 'port': [], 'fp64': []}
        for mode, x in [('eval', xs[0])] + [('train', x) for x in xs[1:]] + [('eval', xs[0])]:
            jm.train() if mode == 'train' else jm.eval()
            tm.train(mode == 'train')
            t64.train(mode == 'train')
            out['jax'].append(tuple(np.asarray(a) for a in jx.fwd(jm, jx.jnp.asarray(x))))
            with torch.no_grad():
                for m, what, dt in ((tm, 'port', torch.float32), (t64, 'fp64', torch.float64)):
                    f = m.forward_features(torch.from_numpy(x).to(dt))
                    out[what].append((f.numpy(), m.forward_head(f).numpy()))
        out['stats'] = (_stats(tm), _jax_stats(jx, jm), _stats(t64))
        runs[key] = out
    return runs


@pytest.mark.parametrize('index', [0, 1, 3, 4], ids=['eval', 'train1', 'train3', 'eval_after'])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_fp32_parity(fp32_runs, variant, index):
    """Features and logits within 1e-5 of JAX's (of magnitudes of at least
    1): eval on the seeded statistics, train mode on batch statistics
    (first and third forward), eval again on the statistics they left. In
    train mode JAX's own fp32 forward lands up to 2e-5 of the magnitude
    from the fp64 one (its reductions on this CPU are less exact, and
    BatchNorm over 8 values a channel in the last stage scales that up),
    where the port's stays within 6e-6: so the port is held within 1e-5
    of the fp64 forward, and within 1e-5 of JAX's beyond JAX's own
    distance from it."""
    (jf, jl), (tf, tl) = fp32_runs[variant]['jax'][index], fp32_runs[variant]['port'][index]
    assert tf.shape == jf.shape and tl.shape == (2, 10)
    for ours, ref, exact in zip((tf, tl), (jf, jl), fp32_runs[variant]['fp64'][index]):
        scale = max(1.0, float(np.abs(ref).max()))
        _assert_close(ours, exact, 1e-5)
        assert float(np.abs(ours - ref).max()) <= 1e-5 * scale + float(np.abs(ref - exact).max())


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_fp32_running_statistics_after_three_forwards(fp32_runs, variant):
    """Every running mean and variance after three train-mode forwards
    within 1e-6 of the fp64 forward's (relative to magnitudes of at least
    1), and of JAX's beyond JAX's own distance from it (the statistics of
    a deep layer inherit the error of the features feeding it); GroupNorm
    keeps none."""
    port, ref, exact = fp32_runs[variant]['stats']
    assert set(port) == set(ref) and (bool(port) == (variant != 'gn'))
    for k in ref:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        _assert_close(port[k], exact[k], 1e-6)
        assert float(np.abs(port[k] - ref[k]).max()) <= 1e-6 * scale + float(
            np.abs(ref[k] - exact[k]).max())


@pytest.mark.parametrize('mode', ['eval', 'train'])
@pytest.mark.parametrize('variant', ['eca_next', 'blur_os16', 'aa_se'])
def test_bf16_parity(jx, variant, mode):
    """bf16 compute with bf16 features and logits, as JAX's. Eval mode:
    within relative L2 2e-2 of JAX bf16. Train mode normalises each layer
    by the statistics of this batch (8 values a channel in the last stage),
    which scales each implementation's bf16 rounding up: JAX bf16 itself
    lands up to 3e-2 from the fp32 forward there, and the port, which
    rounds every op's output to bf16 as the card does, up to 3.8e-2 (JAX's
    CPU program rounds fewer intermediates: after the first stem conv,
    BatchNorm and ReLU the port is 5.3e-3 from fp32 and JAX 4.4e-3). So in
    train mode the port is held within 5e-2 of the fp32 forward and of JAX
    bf16."""
    name, kw = VARIANTS[variant]
    kw = dict(NARROW, **kw)
    jm, values = jx.build(name, dtype=jx.jnp.bfloat16, **kw)
    tm = _port(name, values, dtype=torch.bfloat16, **kw).train(mode == 'train')
    jm.train() if mode == 'train' else jm.eval()
    x = _images(1)
    with torch.no_grad():
        tf = tm.forward_features(torch.from_numpy(x))
        tl = tm.forward_head(tf)
    jf, jl = jx.fwd(jm, jx.jnp.asarray(x))
    assert tf.dtype == tl.dtype == torch.bfloat16 and str(jl.dtype) == 'bfloat16'
    ours = [t.float().numpy() for t in (tf, tl)]
    theirs = [np.asarray(a.astype('float32')) for a in (jf, jl)]
    if mode == 'eval':
        assert max(_rel(a, b) for a, b in zip(ours, theirs)) <= 2e-2
        return
    j32, _ = jx.build(name, values=values, **kw)
    j32.train()
    fp32 = [np.asarray(a) for a in jx.fwd(j32, jx.jnp.asarray(x))]
    for a, b, ref in zip(ours, theirs, fp32):
        assert _rel(a, ref) <= 5e-2 and _rel(a, b) <= 5e-2


# ---- split BatchNorm ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_split_bn_matches_jax(jx, dtype):
    """The ECA-ResNeXt variant converted to split BN of 3 in both packages:
    two train forwards on split-major batches of 3 x 2 (each split through
    its own statistics), then eval (primary statistics only). fp32: as
    test_fp32_parity holds them, within 1e-5 of the port's fp64 forward and
    of JAX's beyond JAX's own distance from it, every primary and aux
    statistic likewise within 5e-6 (a split holds 2 samples: the fast
    variance E[x^2] - E[x]^2 in fp32 over so few values leaves the port's
    statistics up to 1.9e-6 from fp64); bf16 within relative L2 2e-2. The converted layers compute in fp32 under a bf16
    model (JAX's ``_convert_one`` builds them with dtype None): the
    features of a bf16 model come out fp32 in both, its logits bf16."""
    name, kw = VARIANTS['eca_next']
    kw = dict(NARROW, **kw)
    jt = getattr(jx.jnp, dtype)
    jm, values = jx.build(name, splits=3, dtype=jt, **kw)
    tm = _port(name, values, dtype=getattr(torch, dtype), splits=3, **kw)
    t64 = _port(name, values, splits=3, **kw).double() if dtype == 'float32' else None
    splits = [m for m in tm.modules() if isinstance(m, SplitBatchNormAct2d)]
    assert len(splits) == 19 and all(len(m.aux_bn) == 2 for m in splits)
    assert not tm.training and not any(m.training for m in splits)
    for i, mode in enumerate(['train', 'train', 'eval']):
        x = _images(20 + i, n=6)
        jm.train() if mode == 'train' else jm.eval()
        tm.train(mode == 'train')
        jf, jl = jx.fwd(jm, jx.jnp.asarray(x))
        with torch.no_grad():
            tf = tm.forward_features(torch.from_numpy(x))
            tl = tm.forward_head(tf)
            if t64 is not None:
                t64.train(mode == 'train')
                f64 = t64.forward_features(torch.from_numpy(x).double())
                exact = (f64.numpy(), t64.forward_head(f64).numpy())
        assert str(tf.dtype).split('.')[-1] == str(jf.dtype) == 'float32'
        assert str(tl.dtype).split('.')[-1] == str(jl.dtype) == dtype
        for i, (a, b) in enumerate(zip((tf, tl), (jf, jl))):
            a, b = a.float().numpy(), np.asarray(b.astype('float32'))
            if dtype == 'float32':
                _assert_close(a, exact[i], 1e-5)
                assert float(np.abs(a - b).max()) <= 1e-5 * max(1.0, float(np.abs(b).max())) \
                    + float(np.abs(b - exact[i]).max())
            else:
                assert _rel(a, b) <= 2e-2
    port, ref = _stats(tm), _jax_stats(jx, jm)
    assert set(port) == set(ref) and sum('aux_bn' in k for k in ref) == 2 * 2 * 19
    if dtype == 'float32':
        exact = _stats(t64)
        for k in ref:
            _assert_close(port[k], exact[k], 5e-6)
            assert float(np.abs(port[k] - ref[k]).max()) <= 5e-6 * max(
                1.0, float(np.abs(ref[k]).max())) + float(np.abs(ref[k] - exact[k]).max())


def test_split_bn_conversion_carries_layers():
    """The conversion copies weights and statistics into every split,
    keeps act and drop, mode and device, and raises on a batch that does
    not split."""
    tm = timm_tpu_torch.create_model('test_resnet', device='cpu', num_classes=5)
    with torch.no_grad():
        tm.bn1.running_mean.fill_(0.3)
        tm.bn1.weight.fill_(1.5)
    act = tm.bn1.act
    convert_splitbn_model(tm, 2)
    assert isinstance(tm.bn1, SplitBatchNormAct2d) and tm.bn1.act is act
    assert isinstance(tm.layer2[0].downsample.bn, SplitBatchNormAct2d)
    assert tm.layer2[0].downsample.bn.act is None
    for bn in (tm.bn1, tm.bn1.aux_bn[0]):
        assert float(bn.running_mean[0]) == pytest.approx(0.3)
        assert float(bn.weight[0].detach()) == 1.5
    assert tm.bn1.momentum == 1.0 - (1.0 - 0.1)
    with pytest.raises(ValueError, match='split'):
        tm.train()(torch.zeros(3, 32, 32, 3))


# ---- test-time pooling ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_test_time_pool_head_matches_jax(jx, dtype):
    """``apply_test_time_pool`` picks the head when the input exceeds the
    default in both dims; the head (pool 2 at stride 1 over a 3x3 map,
    the classifier on each window, mean and max) within 1e-5 / 2e-2."""
    from timm_tpu.layers import TestTimePoolHead as JHead
    name, kw = VARIANTS['aa_se']
    kw = dict(NARROW, **kw)
    jt = getattr(jx.jnp, dtype)
    jm, values = jx.build(name, dtype=jt, **kw)
    tm = _port(name, values, dtype=getattr(torch, dtype), **kw)
    head, used = apply_test_time_pool(tm, {'input_size': (3, 288, 288)})
    assert used and isinstance(head, TestTimePoolHead) and head.original_pool == (7, 7)
    assert apply_test_time_pool(tm, {'input_size': (3, 288, 224)}) == (tm, False)
    assert set(head.state_dict()) == {f'base.{k}' for k in tm.state_dict()}
    head = TestTimePoolHead(tm, original_pool=2)
    x = _images(3, size=96)
    ref = jx.call(JHead(jm, original_pool=2), jx.jnp.asarray(x))
    with torch.no_grad():
        out = head(torch.from_numpy(x))
    assert str(out.dtype).split('.')[-1] == str(ref.dtype) == dtype and out.shape == (2, 10)
    a, b = out.float().numpy(), np.asarray(ref.astype('float32'))
    if dtype == 'float32':
        _assert_close(a, b, 1e-5)
    else:
        assert _rel(a, b) <= 2e-2


# ---- the train step with split BN and the JAX checkpoint ------------------------------------

LR = 0.05


@pytest.fixture(scope='module')
def split_step(jx):
    """One SGD step (Nesterov, momentum 0.9, weight decay 1e-4 as masked
    coupled L2, smoothing 0.1, norm clip 1.0) of the CECA test_resnet converted to split BN
    of 3, on a split-major batch of 3 x 2, in both packages; then the JAX
    task's checkpoint."""
    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.task import ClassificationTask as JTask
    name, kw = VARIANTS['rs_ceca']
    kw = dict(kw, num_classes=10)
    jm, values = jx.build(name, seed=7, splits=3, **kw)
    jm.train()
    opt_kw = dict(opt='sgd', lr=LR, weight_decay=1e-4, momentum=0.9)
    jtask = JTask(jm, optimizer=jopt(jm, **opt_kw), mesh=create_mesh(jx.jax.devices()[:1]),
                  train_loss_fn=JLS(0.1), clip_grad=1.0, nonfinite_guard=False)
    tm = _port(name, values, splits=3, **kw)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, **opt_kw),
        train_loss_fn=LabelSmoothingCrossEntropy(0.1), clip_grad=1.0, nonfinite_guard=False)
    rng = np.random.default_rng(4)
    batch = {'input': _images(30, n=6), 'target': rng.integers(0, 10, 6).astype(np.int32)}
    jout = _jax_train_step(jx, jtask, batch, LR, 1)
    out = task.train_step(batch, lr=LR, step=1)
    sd = {k: v.detach().numpy().copy() for k, v in tm.state_dict().items()}
    ref = {k: v.numpy() for k, v in convert_jax_state_dict(jx.state(jtask.model)).items()}
    return dict(loss=(float(out['loss']), float(jout['loss'])), sd=sd, ref=ref,
                checkpoint=jtask.get_checkpoint_state(), kw=kw, name=name)


def test_split_bn_sgd_step_matches_jax(split_step):
    """Loss within 1e-5; after the step every parameter within 1e-5 of
    JAX's (lr 0.05: a tenth of a thousandth of the step), every primary
    and aux statistic within 1e-5 (of magnitudes of at least 1)."""
    ours, ref = split_step['loss']
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-5
    sd, jsd = split_step['sd'], split_step['ref']
    assert set(sd) == set(jsd) and any('aux_bn.1.running_var' in k for k in sd)
    for k in jsd:
        _assert_close(sd[k], jsd[k], 1e-5)


def test_jax_task_checkpoint_loads_strictly(split_step):
    """The JAX task's checkpoint (weights, primary and aux statistics, SGD's
    trace) loads through convert_jax_checkpoint into a fresh port task
    strictly, the statistics in place; a missing aux statistic raises."""
    state = convert_jax_checkpoint(split_step['checkpoint'])
    assert any(k.startswith('model_state.') and 'aux_bn.0.running_mean' in k for k in state)
    assert any(k.startswith('optimizer.trace.') for k in state)
    tm = timm_tpu_torch.create_model(split_step['name'], device='cpu', seed=5, **split_step['kw'])
    convert_splitbn_model(tm, 3)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='sgd', lr=LR, weight_decay=1e-4))
    buffer = tm.get_buffer('layer1.0.bn1.aux_bn.1.running_var')
    task.load_checkpoint_state(state)
    assert tm.get_buffer('layer1.0.bn1.aux_bn.1.running_var') is buffer
    ours = task.get_checkpoint_state()
    for k in state:
        assert np.array_equal(ours[k], state[k]), k
    with pytest.raises(KeyError, match='Missing'):
        task.load_checkpoint_state({k: v for k, v in state.items()
                                    if k != 'model_state.layer1.0.bn1.aux_bn.1.running_mean'})


# ---- registry and contract -------------------------------------------------------------

def _plain(v):
    """A comparable form of an entrypoint argument: classes and functions by
    name, partials as (name, keywords), dicts and tuples element-wise."""
    if isinstance(v, functools.partial):
        return (_plain(v.func), {k: _plain(a) for k, a in v.keywords.items()})
    if isinstance(v, dict):
        return {k: _plain(a) for k, a in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(_plain(a) for a in v)
    return getattr(v, '__name__', v)


def test_registry_matches_jax(jx, monkeypatch):
    """All 81 entrypoints of the JAX module with their pretrained cfgs, each
    passing the model arguments JAX's passes; every name builds (shapes
    only) with JAX's parameter count on a sample."""
    from timm_tpu.models import _registry as jreg
    from timm_tpu.models import resnet as jres
    from timm_tpu_torch.models import _registry as treg
    from timm_tpu_torch.models import resnet as tres
    names = sorted(n for n, mod in jreg._model_to_module.items() if mod == 'resnet')
    assert len(names) == 81
    assert sorted(n for n, mod in treg._model_to_module.items() if mod == 'resnet') == names
    for tagged in jx.timm_tpu.list_models(names, include_tags=True):
        assert timm_tpu_torch.models.get_pretrained_cfg(tagged).to_dict() == \
            jx.timm_tpu.models.get_pretrained_cfg(tagged).to_dict(), tagged

    def capture(variant, pretrained=False, **kwargs):
        return variant, _plain(kwargs)
    for module in (jres, tres):
        monkeypatch.setattr(module, '_create_resnet', capture)
    for name in names:
        assert treg.model_entrypoint(name)() == jreg.model_entrypoint(name)(), name
    monkeypatch.undo()
    for name in names:
        assert isinstance(timm_tpu_torch.create_model(name, device='meta'), ResNet), name
    for name in ('resnet50', 'resnetrs50', 'ecaresnet26t'):
        jm = jx.nnx.eval_shape(lambda: jx.timm_tpu.create_model(name))
        jn = sum(int(np.prod(v.get_value().shape)) for _, v in
                 jx.nnx.to_flat_state(jx.nnx.state(jm, jx.nnx.Param)))
        tn = sum(p.numel() for p in timm_tpu_torch.create_model(name, device='meta').parameters())
        assert tn == jn, name


def test_resnet50_shape_and_contract():
    """resnet50 uncut on the meta device: 25,557,032 parameters in 161
    leaves, 53 BatchNorms, zero-initialised last scales; the contract."""
    from timm_tpu_torch.layers import BatchNormAct2d
    tm = timm_tpu_torch.create_model('resnet50', device='cpu')
    assert sum(p.numel() for p in tm.parameters()) == 25_557_032
    assert len(list(tm.parameters())) == 161
    assert sum(isinstance(m, BatchNormAct2d) for m in tm.modules()) == 53
    assert all(float(b.bn3.weight.abs().max()) == 0.0 for s in tm._stages() for b in s)
    assert tm.pretrained_cfg.pool_size == (7, 7) and tm.pretrained_cfg.input_size == (3, 224, 224)
    assert tm.get_classifier() is tm.head.fc and tm.num_features == 2048
    feats, inter = tm.eval().forward_intermediates(torch.zeros(1, 64, 64, 3))
    assert [t.shape[-1] for t in inter] == [64, 256, 512, 1024, 2048] and feats.shape[1] == 2
    with pytest.raises(NotImplementedError, match='A.5.7'):
        tm.set_grad_checkpointing()
    with pytest.raises(NotImplementedError, match='A.5.7'):
        timm_tpu_torch.create_model('resnet18', device='meta', features_only=True)
    with pytest.raises(RuntimeError, match='CUDA'):
        if not torch.cuda.is_available():
            timm_tpu_torch.create_model('test_resnet')
        else:
            raise RuntimeError('cuda present')


# ---- on the card ------------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.gpu
def test_resnet_train_replay_matches_eager_on_card():
    """Split-BN resnet50 at batch 3 x 4, bf16, SGD: 3 eager body steps
    against 3 steps of a fresh task through its graph from one state,
    parameters, momentum and every primary and aux statistic bit for bit."""
    dev = _card()
    x = torch.randn(12, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    y = torch.randint(0, 1000, (12,), generator=torch.Generator().manual_seed(1))
    finals = []
    for graphed in (False, True):
        tm = timm_tpu_torch.create_model('resnet50', dtype=torch.bfloat16, seed=0)
        convert_splitbn_model(tm, 3)
        task = timm_tpu_torch.ClassificationTask(tm, optimizer=create_optimizer_v2(
            tm, opt='sgd', lr=0.05, weight_decay=1e-4, momentum=0.9))
        batch = {'input': x.to(dev), 'target': y.to(dev)}
        for step in range(1, 4):
            if graphed:
                task.train_step(batch, lr=0.05, step=step)
            else:
                task.optimizer.set_hyperparams(lr=0.05)
                tm.train()
                task._train_body(batch)
        torch.cuda.synchronize()
        finals.append([t.detach().clone() for t in tm.state_dict().values()]
                      + [task.optimizer.trace.clone()])
    assert all(torch.equal(a, b) for a, b in zip(*finals))


@pytest.mark.gpu
def test_resnet_serve_buckets_on_card():
    """resnet50 bf16 in the engine (eval mode on its running statistics):
    each bucket graph's replay equals the eager forward bit for bit."""
    _card()
    engine = timm_tpu_torch.InferenceEngine(buckets=(1, 4), device='cuda')
    engine.add_model('resnet50', dtype=torch.bfloat16, seed=0)
    res = engine.pool.acquire('resnet50')
    assert not res.model.training
    with torch.inference_mode():
        for b, g in engine.aot_executables('resnet50').items():
            x = torch.from_numpy(_images(b, n=b, size=224))
            assert torch.equal(g.run(x.pin_memory()), res.model(x.cuda()).float())


@pytest.mark.gpu
def test_fused_adamw_resnet50_case_on_card():
    """The registry's resnet50 case of fused_adamw against its plain
    version on the card."""
    _card()
    from timm_tpu_torch.kernels import registry
    spec = registry.get('fused_adamw')
    case = next(c for c in spec.cases if c.name == 'resnet50')
    inputs = spec.make_inputs(device='cuda', **case.live)
    out = spec.kernel_fn(**inputs, **case.statics)
    ref = spec.reference_fn(**inputs, **case.statics)
    for o, r in zip(out, ref):
        scale = max(1.0, float(r.abs().max()))
        assert float((o.float() - r.float()).abs().max()) <= spec.parity_tol * scale


def test_drivers_split_bn_and_test_pool(tmp_path):
    """The train driver with ``--aug-splits 3 --jsd-loss --split-bn`` on
    test_resnet (2 updates on 3 x 4 images from a folder of 8 PNGs): the
    checkpoint holds both aux statistics of every BatchNorm; ``validate``
    evaluates it on the plain model, and with ``--test-pool`` at a size
    above the default wraps it in the pooled head at crop 1.0."""
    from PIL import Image

    from timm_tpu_torch import train, validate
    rng = np.random.default_rng(0)
    for c in range(2):
        (tmp_path / 'data' / f'class{c}').mkdir(parents=True)
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
                tmp_path / 'data' / f'class{c}' / f'{i}.png')
    argv = ['--device', 'cpu', '--data-dir', str(tmp_path / 'data'), '--model', 'test_resnet',
            '--img-size', '32', '--num-classes', '2', '-b', '4', '--epochs', '1', '--workers', '1',
            '--opt', 'sgd', '--lr', '0.05', '--aa', 'augmix-m3-w3', '--aug-splits', '3',
            '--jsd-loss', '--split-bn', '--output', str(tmp_path), '--experiment', 'split']
    assert train.main(argv) == 0
    with np.load(tmp_path / 'split' / 'last.npz') as d:
        assert int(d['optimizer.count']) == 2
        aux = [k for k in d.files if '.aux_bn.' in k and k.startswith('model_state.')]
        assert len(aux) == 2 * 2 * 13  # 13 BatchNorms, 2 aux layers, mean and var
    common = ['--device', 'cpu', '--model', 'test_resnet', '--num-classes', '2', '-b', '4',
              '--workers', '1', '--checkpoint', str(tmp_path / 'split' / 'last.npz'),
              '--split', '', str(tmp_path / 'data')]
    rows = {}
    for name, extra in (('plain', []), ('pool', ['--test-pool', '--img-size', '288'])):
        out = tmp_path / f'{name}.json'
        assert validate.main(common + extra + ['--results-file', str(out),
                                               '--results-format', 'json']) == 0
        rows[name] = __import__('json').loads(out.read_text())[0]
    assert rows['plain']['test_time_pool'] is False and rows['plain']['img_size'] == 160
    assert rows['pool']['test_time_pool'] is True and rows['pool']['crop_pct'] == 1.0
    assert np.isfinite(rows['pool']['loss'])


def test_max_pool_stem_trains_in_bf16(jx):
    """A reference fault the port does not copy: JAX's ``max_pool2d``
    (timm_tpu/models/resnet.py:44-53) pads bf16 input with finfo.min, which
    is not the max monoid's identity, so JAX cannot differentiate it in
    bf16 (and its train step of a max-pool-stem ResNet under bf16 raises).
    The port's pool (``F.max_pool2d``) differentiates in bf16, its gradient
    the one JAX gives in fp32 on the same values."""
    from timm_tpu.models.resnet import max_pool2d as jpool
    jnp = jx.jnp
    x = np.random.default_rng(0).standard_normal((2, 7, 7, 3)).astype(np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    with pytest.raises(ValueError, match='Linearization failed'):
        jx.jax.grad(lambda v: jpool(v.astype(jnp.bfloat16), 3, 2).astype(jnp.float32).sum())(
            jnp.asarray(x))
    ref = np.asarray(jx.jax.grad(lambda v: jpool(v, 3, 2).sum())(jnp.asarray(xb)))
    t = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    max_pool2d(t, 3, 2).float().sum().backward()
    assert t.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.grad.float().numpy(), ref)
