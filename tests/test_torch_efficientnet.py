"""EfficientNet of the PyTorch port against the JAX package on the CPU: the
BatchNorm machinery (running statistics in fp32 and in the bf16 flow), the
norm + act composites, MixedConv2d, CondConv2d, SE and the activations;
test_efficientnet in fp32 and bf16, eval and train mode, on carried
weights; the training task with BatchNorm statistics (an AdamW step with
and without gradient accumulation, the guard's non-finite step, EMA
evaluation, a JAX task checkpoint); the registry; and efficientnetv2_s on
the card.

The JAX models are built from their shapes (``nnx.eval_shape``) and given
seeded numpy weights and running statistics (means of order 0.1, variances
in [0.5, 1.5]), so eval mode normalises with statistics of its own; then
carried across with ``load_jax_state_dict``. JAX is imported inside the
fixtures and compiles each forward once (``nnx.jit``).
"""
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers import (
    BatchNorm2d, BatchNormAct2d, CondConv2d, EffectiveSEModule, FrozenBatchNormAct2d,
    GroupNorm, GroupNorm1, GroupNormAct, LayerNormAct2d, MixedConv2d, SEModule, create_conv2d,
    get_act_fn, get_attn, get_norm_act_layer,
)
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.models import convert_jax_checkpoint, convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.optim import create_optimizer_v2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAME = 'test_efficientnet'
SIZE = 64
LR = 1e-3
# The bias of a norm whose output reaches a train-mode BatchNorm through a
# conv alone has a zero gradient (the BatchNorm removes any shift) but for
# fp32 noise of order 1e-9, which differs between the two implementations.
# Adam's first step is lr * g / (|g| + eps): with eps 1e-8 it turns that
# noise into an update of up to lr, with 1e-6 into one of about 1e-3 * lr.
ADAM_EPS = 1e-6


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_close(out, ref, tol):
    """Max abs difference within ``tol`` times the larger of 1 and the
    reference's largest magnitude. JAX's fp32 reductions on this CPU are
    less exact than torch's (a BatchNorm variance off by 6e-7 of 0.14
    where torch's is off by 5e-8, both against fp64), and train-mode
    BatchNorm over a few samples scales such differences up to the
    features' magnitude."""
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out - ref).max()) <= tol * scale


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _seeded(flat_shapes, seed):
    """Seeded numpy values for a JAX model's parameters and statistics (JAX
    names and layouts)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(flat_shapes.items()):
        leaf = key.rpartition('.')[2]
        if leaf == 'mean':
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'bias':
            v = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 4:  # HWIO conv kernel: variance scaling 2.0 over fan-out
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        elif len(shape) == 2:  # (in, out) kernel
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
        else:
            v = 0.02 * rng.standard_normal(shape)
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

    def set_state(model, values):
        """Copy numpy ``values`` (JAX names) into ``model``'s variables."""
        state = nnx.state(model)
        for path, leaf in nnx.to_flat_state(state):
            k = '.'.join(map(str, path))
            if k in values:
                leaf.set_value(jnp.asarray(values[k]).astype(leaf.get_value().dtype))
        nnx.update(model, state)

    def build(name=NAME, seed=0, values=None, **kw):
        """The JAX model ``name`` from its shapes, with seeded weights and
        statistics (or ``values``); (model, its values)."""
        abstract = nnx.eval_shape(lambda: timm_tpu.create_model(name, **kw))
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
                                 state=model_state_dict, build=build, set_state=set_state,
                                 fwd=nnx.jit(features_and_logits),
                                 call=nnx.jit(lambda m, x: m(x)))


def _port(flat, dtype=None, name=NAME, **kw):
    tm = timm_tpu_torch.create_model(name, device='cpu', dtype=dtype, **kw).eval()
    return load_jax_state_dict(tm, flat)


def _port_stats(model):
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(('running_mean', 'running_var'))}


def _jax_stats(jx, model):
    return {k: v.numpy() for k, v in convert_jax_state_dict(jx.state(model)).items()
            if k.endswith(('running_mean', 'running_var'))}


@pytest.fixture(scope='module')
def fp32_runs(jx):
    """test_efficientnet fp32, JAX and the port from one set of values:
    an eval forward, then three train-mode forwards (the statistics move),
    then an eval forward on the moved statistics."""
    jm, flat = jx.build()
    tm = _port(flat)
    xs = [_images(10 + i) for i in range(4)]
    out = {'jax': [], 'port': []}

    def run(mode, x):
        jm.train() if mode == 'train' else jm.eval()
        tm.train(mode == 'train')
        out['jax'].append(tuple(np.asarray(a) for a in jx.fwd(jm, jx.jnp.asarray(x))))
        with torch.no_grad():
            f = tm.forward_features(torch.from_numpy(x))
            out['port'].append((f.numpy(), tm.forward_head(f).numpy()))
    run('eval', xs[0])
    for x in xs[1:]:
        run('train', x)
    run('eval', xs[0])
    out['stats'] = (_port_stats(tm), _jax_stats(jx, jm))
    return out


@pytest.mark.parametrize('mode,index', [('eval', 0), ('train', 1), ('train', 3),
                                        ('eval_after_train', 4)])
def test_fp32_parity(fp32_runs, mode, index):
    """Features and logits within 1e-5 of JAX's (of magnitudes of at
    least 1): eval mode on the seeded statistics, train mode on batch
    statistics (first and third forward), and eval mode again on the
    statistics the train forwards left."""
    (jf, jl), (tf, tl) = fp32_runs['jax'][index], fp32_runs['port'][index]
    assert tf.shape == (2, 2, 2, 256) and tl.shape == (2, 1000)
    _assert_close(tf, jf, 1e-5)
    _assert_close(tl, jl, 1e-5)


def test_fp32_running_statistics_after_three_forwards(fp32_runs):
    """Every running mean and variance after three train-mode forwards
    within 1e-6 of JAX's (relative to magnitudes of at least 1)."""
    port, ref = fp32_runs['stats']
    assert set(port) == set(ref) and len(port) == 2 * 13  # 13 BatchNorms
    for k in ref:
        _assert_close(port[k], ref[k], 1e-6)


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_bf16_parity(jx, mode):
    """bf16 compute, with bf16 features and logits as JAX's. Eval mode:
    within relative L2 2e-2 of JAX bf16. Train mode normalises each layer
    by the statistics of this batch (8 values a channel in the last
    stage), which scales each implementation's bf16 rounding up: JAX bf16
    itself lands 3e-2 from the fp32 forward there. So in train mode both
    are held to the fp32 forward: the port's logits and features no
    farther from it than 1.25 times JAX bf16's, and within 5e-2."""
    jm, flat = jx.build(dtype=jx.jnp.bfloat16)
    tm = _port(flat, dtype=torch.bfloat16).train(mode == 'train')
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
    j32, _ = jx.build(values=flat)
    j32.train()
    fp32 = [np.asarray(a) for a in jx.fwd(j32, jx.jnp.asarray(x))]
    for a, b, ref in zip(ours, theirs, fp32):
        assert _rel(a, ref) <= min(1.25 * _rel(b, ref), 5e-2)


def test_weight_carry_is_strict(jx, fp32_runs):
    """Running statistics carry as ``running_mean`` / ``running_var`` (no
    ``num_batches_tracked``); every key is used, and a missing statistic
    raises."""
    jm, flat = jx.build(seed=3)
    tm = timm_tpu_torch.create_model(NAME, device='cpu')
    converted = convert_jax_state_dict(flat)
    assert set(converted) == set(tm.state_dict())
    assert not any('num_batches_tracked' in k for k in converted)
    np.testing.assert_array_equal(converted['bn1.running_var'].numpy(), flat['bn1.var'])
    load_jax_state_dict(tm, flat)
    missing = dict(flat)
    missing.pop('blocks.3.0.bn2.mean')
    with pytest.raises(RuntimeError, match='Missing'):
        load_jax_state_dict(tm, missing)


# ---- layers ---------------------------------------------------------------------

def _layer_values(jx, layer, seed):
    """Seeded values for a JAX layer's parameters and statistics, set into
    it; returned under JAX names."""
    flat = jx.state(layer)
    values = _seeded({k: v.shape for k, v in flat.items()}, seed)
    jx.set_state(layer, values)
    return values


def _bn_case(jx, cls_name, dtype, seed=0):
    import timm_tpu.layers as jl
    kw = {} if cls_name == 'BatchNorm2d' else {'act_layer': 'silu'}
    jt = getattr(jx.jnp, dtype)
    jn = getattr(jl, cls_name)(12, momentum=0.1, dtype=jt, rngs=jx.nnx.Rngs(0), **kw)
    values = _layer_values(jx, jn, seed)
    tn = {'BatchNorm2d': BatchNorm2d, 'BatchNormAct2d': BatchNormAct2d}[cls_name](
        12, momentum=0.1, dtype=getattr(torch, dtype), **kw)
    load_jax_state_dict(tn, values)
    return jn, tn


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('cls_name', ['BatchNorm2d', 'BatchNormAct2d'])
def test_batchnorm_matches_jax(jx, cls_name, dtype):
    """Three train-mode forwards then an eval forward on (2, 5, 5, 12)
    inputs, with seeded statistics. fp32: outputs within 1e-5. bf16 (every
    value in bf16 as JAX's): the norm's output bit for bit, the activation
    the port's own (held against JAX's by test_activation_matches_jax, 2-3
    ulps apart in SiLU's sigmoid). The running statistics within 1e-6
    after each forward, in fp32 and in the bf16 flow (the batch statistics
    of bf16 input in fp32, blended in fp32). JAX's activation is taken off
    its layer and applied to the norm's output, so each forward steps its
    statistics once."""
    jn, tn = _bn_case(jx, cls_name, dtype)
    jact, jn.act = getattr(jn, 'act', None), None
    rng = np.random.default_rng(5)
    jt, tt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    for i, mode in enumerate(['train', 'train', 'train', 'eval']):
        x = (0.3 + 1.5 * rng.standard_normal((2, 5, 5, 12))).astype(np.float32)
        jn.train() if mode == 'train' else jn.eval()
        tn.train(mode == 'train')
        ref_norm = jx.call(jn, jx.jnp.asarray(x).astype(jt))
        ref = ref_norm if jact is None else jact(ref_norm)
        with torch.no_grad():
            out = tn(torch.from_numpy(x).to(tt))
        assert str(out.dtype).split('.')[-1] == str(ref.dtype) == dtype
        if dtype == 'float32':
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
        else:
            norm = torch.from_numpy(np.asarray(ref_norm.astype('float32'))).to(tt)
            tact = getattr(tn, 'act', None)
            assert torch.equal(out, norm if tact is None else tact(norm))
        for leaf in ('mean', 'var'):
            np.testing.assert_allclose(getattr(tn, f'running_{leaf}').numpy(),
                                       np.asarray(getattr(jn, leaf)[...]), atol=1e-6, rtol=0)


_NORM_ACTS = {
    'GroupNormAct': (lambda m, **kw: m(12, group_size=4, act_layer='silu', **kw), GroupNormAct),
    'GroupNorm1Act': (lambda m, **kw: m(12, act_layer='relu', **kw), None),
    'LayerNormAct2d': (lambda m, **kw: m(12, act_layer='gelu', **kw), LayerNormAct2d),
    'FrozenBatchNormAct2d': (lambda m, **kw: m(12, act_layer='relu', **kw), FrozenBatchNormAct2d),
    'GroupNorm': (lambda m, **kw: m(12, num_groups=3, **kw), GroupNorm),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', list(_NORM_ACTS))
def test_norm_act_matches_jax(jx, name, dtype):
    """The norm + act composites and GroupNorm on a (2, 5, 5, 12) input
    with seeded parameters: fp32 within 1e-5, bf16 within 2e-2, and the
    output dtype JAX's."""
    import timm_tpu.layers as jl
    from timm_tpu_torch.layers import GroupNorm1Act
    make, cls = _NORM_ACTS[name]
    cls = cls or GroupNorm1Act
    frozen = name == 'FrozenBatchNormAct2d'
    jn = make(getattr(jl, name), rngs=jx.nnx.Rngs(0))
    values = _layer_values(jx, jn, 1)
    tn = make(cls)
    load_jax_state_dict(tn, values)
    x = (0.5 + np.random.default_rng(3).standard_normal((2, 5, 5, 12))).astype(np.float32)
    ref = jx.call(jn, jx.jnp.asarray(x).astype(getattr(jx.jnp, dtype)))
    with torch.no_grad():
        out = tn(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(out.dtype).split('.')[-1] == str(ref.dtype)
    assert frozen or str(ref.dtype) == 'float32'  # no dtype given: JAX promotes to fp32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')),
                               atol=1e-5 if dtype == 'float32' else 2e-2, rtol=0)


def test_norm_factories_build_the_ported_layers():
    assert get_norm_act_layer('batchnorm2d') is BatchNormAct2d
    assert get_norm_act_layer('group_norm1').__name__ == 'GroupNorm1Act'
    assert get_norm_act_layer('batchnorm', act_layer='silu').keywords == {'act_layer': 'silu'}
    assert isinstance(GroupNorm1(8), GroupNorm) and GroupNorm1(8).num_groups == 1
    with pytest.raises(NotImplementedError, match='A.5.9'):
        get_norm_act_layer('evonorms0')
    with pytest.raises(ValueError, match='Unknown'):
        get_norm_act_layer('nonorm')


_CONVS = {
    # (in, out, kernel, stride, padding, depthwise, experts, input size)
    'mixed_dw_k3.5.7_s2': (10, 10, [3, 5, 7], 2, '', True, 0, 9),
    'mixed_pw_k1.1': (12, 18, [1, 1], 1, '', False, 0, 6),
    'mixed_dw_same_k3.5': (8, 8, [3, 5], 2, 'same', True, 0, 8),
    'cond_dw_k3_s2': (8, 8, 3, 2, '', True, 4, 9),
    'cond_pw_k1_same': (6, 10, 1, 1, 'same', False, 3, 5),
    'cond_k3_same_s2': (4, 6, 3, 2, 'same', False, 2, 8),
}


@pytest.mark.parametrize('case', list(_CONVS))
def test_mixed_and_cond_conv_match_jax(jx, case):
    """MixedConv2d (uneven channel splits, one kernel size a split) and
    CondConv2d (per-sample kernels from HWIO-flat expert rows, with a
    bias) against JAX's on seeded weights, within 1e-5; the weights carry
    as they are."""
    from timm_tpu.layers import create_conv2d as jconv
    cin, cout, k, s, pad, dw, experts, size = _CONVS[case]
    jc = jconv(cin, cout, k, stride=s, padding=pad, depthwise=dw, num_experts=experts,
               bias=True, rngs=jx.nnx.Rngs(0))
    values = _layer_values(jx, jc, 2)
    tc = create_conv2d(cin, cout, k, stride=s, padding=pad, depthwise=dw, num_experts=experts,
                       bias=True)
    assert isinstance(tc, CondConv2d if experts else MixedConv2d)
    load_jax_state_dict(tc, values)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    args = (x,) + ((rng.uniform(0, 1, (2, experts)).astype(np.float32),) if experts else ())
    ref = np.asarray(jx.nnx.jit(lambda m, *a: m(*a))(jc, *(jx.jnp.asarray(a) for a in args)))
    with torch.no_grad():
        out = tc(*(torch.from_numpy(a) for a in args)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', ['se', 'ese'])
def test_squeeze_excite_matches_jax(jx, name, dtype):
    """SE (fc, SiLU, fc, sigmoid gate) and effective SE (one fc,
    hard-sigmoid gate) through get_attn, with the model dtype."""
    from timm_tpu.layers import get_attn as jget
    jt, tt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    kw = dict(rd_ratio=0.25, act_layer='silu') if name == 'se' else {}
    jm = jget(name)(16, dtype=jt, rngs=jx.nnx.Rngs(0), **kw)
    values = _layer_values(jx, jm, 3)
    tm = get_attn(name)(16, dtype=tt, **kw)
    assert isinstance(tm, SEModule if name == 'se' else EffectiveSEModule)
    load_jax_state_dict(tm, values)
    x = np.random.default_rng(6).standard_normal((2, 4, 4, 16)).astype(np.float32)
    ref = jx.call(jm, jx.jnp.asarray(x).astype(jt))
    with torch.no_grad():
        out = tm(torch.from_numpy(x).to(tt))
    assert str(out.dtype).split('.')[-1] == str(ref.dtype) == dtype
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')),
                               atol=1e-5 if dtype == 'float32' else 2e-2, rtol=0)
    with pytest.raises(NotImplementedError, match='A.5.9'):
        get_attn('gc')
    from timm_tpu_torch.layers import EcaModule
    assert get_attn('eca') is EcaModule  # ported with the ResNet step


_ACTS = ['relu', 'relu6', 'silu', 'swish', 'sigmoid', 'tanh', 'hard_sigmoid', 'hard_swish',
         'hardswish', 'hardsigmoid', 'mish', 'gelu_tanh', 'quick_gelu']
# the JAX map's names that no ported model selects
_QUEUED_ACTS = ['leaky_relu', 'elu', 'celu', 'selu', 'hard_mish', 'softplus']


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('name', _ACTS)
def test_activation_matches_jax(jx, name, dtype):
    """Each ported activation on 1001 values over [-8, 8]. fp32:
    within 1e-6 of JAX's (of magnitudes of at least 1). bf16: JAX's fp32
    function of the bf16 inputs is the exact value, and the port's largest
    error over the sweep, in bf16 ulps of the exact value, is no larger
    than JAX's own bf16 output's (and than half an ulp where JAX's is
    exact): JAX rounds its bf16 transcendentals and constants in bf16 (its
    sigmoid is 2 ulps off), the port's are
    rounded once from fp32 where torch's are."""
    from timm_tpu.layers.create_act import get_act_fn as jget
    x = np.linspace(-8, 8, 1001).astype(np.float32)
    jt, tt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    xj = jx.jnp.asarray(x).astype(jt)
    ref = np.asarray(jx.jax.jit(jget(name))(xj).astype('float32'))
    out = get_act_fn(name)(torch.from_numpy(x).to(tt)).float().numpy()
    if dtype == 'float32':
        assert np.all(np.abs(out - ref) <= 1e-6 * np.maximum(np.abs(ref), 1.0))
    else:
        exact = np.asarray(jx.jax.jit(jget(name))(xj.astype('float32')))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 2.0 ** -10))) - 7)
        assert np.max(np.abs(out - exact) / ulp) <= max(np.max(np.abs(ref - exact) / ulp), 0.5)
    if name == 'relu':
        with pytest.raises(ValueError, match='Unknown activation'):
            get_act_fn('nonact')


@pytest.mark.parametrize('name', _QUEUED_ACTS)
def test_queued_activation_raises(jx, name):
    """A name of the JAX map that no ported model selects raises citing
    its ROADMAP item, in any case; JAX resolves it."""
    from timm_tpu.layers.create_act import get_act_fn as jget
    assert callable(jget(name))
    for spelling in (name, name.upper()):
        with pytest.raises(NotImplementedError, match='A.5.9'):
            get_act_fn(spelling)

# ---- the training task with running statistics -------------------------------------

def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {'input': _images(seed, n=n), 'target': rng.integers(0, 1000, n).astype(np.int32)}


def _task_pair(jx, accum: int, guard: bool, ema: bool):
    """A JAX task and the port's from one set of values: AdamW (wd 0.05
    with the mask, eps ADAM_EPS), label smoothing 0.1, clip 1.0."""
    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.task import ClassificationTask as JTask
    jm, flat = jx.build(seed=7)
    jm.train()
    jtask = JTask(jm, optimizer=jopt(jm, opt='adamw', lr=LR, weight_decay=0.05, eps=ADAM_EPS),
                  mesh=create_mesh(jx.jax.devices()[:1]), train_loss_fn=JLS(0.1), clip_grad=1.0,
                  grad_accum_steps=accum, nonfinite_guard=guard)
    tm = _port(flat)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05, eps=ADAM_EPS),
        train_loss_fn=LabelSmoothingCrossEntropy(0.1), clip_grad=1.0, grad_accum_steps=accum,
        nonfinite_guard=guard)
    if ema:
        jtask.setup_ema(decay=0.9)
        task.setup_ema(decay=0.9)
    return jtask, task


def _jax_train_step(jx, jtask, batch, lr, step):
    """JAX's train step (timm_tpu/task/task.py ``_build_train_step``) from
    the task's own parts, in its order: the microbatches' gradients with
    the statistics carried from one to the next, averaged; norm clipping;
    the optimizer's update; the guard's select over
    parameters, optimizer state and EMA (not the statistics); the EMA. The
    task's own step cannot run a model with BatchNorm under this flax: its
    ``nnx.merge`` inside ``jax.value_and_grad`` raises TraceContextError
    when BatchNorm writes its statistics. Here flax's ``nnx.value_and_grad``
    takes the gradients and carries the statistics."""
    import optax
    from flax import nnx
    from timm_tpu.resilience import tree_all_finite
    from timm_tpu.utils.clip_grad import dispatch_clip_grad
    from timm_tpu.utils.model_ema import ema_update
    jax, jnp = jx.jax, jx.jnp
    accum, guard = jtask.grad_accum_steps, jtask._nonfinite_guard
    has_ema = jtask.ema_params is not None
    jtask.model.train()  # the task's step is traced in train mode
    # the programs are compiled once for the module: the tasks here share
    # their configuration (loss, optimizer, clip), so the first task's parts
    # serve every task with the same accumulation, guard and EMA
    fns = jx.__dict__.setdefault('step_fns', {})
    if 'grad' not in fns:
        fns['grad'] = nnx.jit(lambda m, mb: nnx.value_and_grad(
            lambda m: jtask.loss_forward(m, mb)[0].astype(jnp.float32))(m))
    grad_fn = fns['grad']
    loss, grads = 0.0, None
    for i in range(accum):
        mb = {k: jnp.asarray(v).reshape(accum, -1, *v.shape[1:])[i] for k, v in batch.items()}
        l_i, g_i = grad_fn(jtask.model, mb)
        loss = loss + l_i
        grads = g_i if grads is None else jax.tree.map(jnp.add, grads, g_i)

    def update(loss, grads, params, opt_state, ema, lr, decay):
        loss = loss / accum
        grads = jax.tree.map(lambda g: g / accum, grads)
        grads, _ = dispatch_clip_grad(grads, jtask.clip_grad, mode='norm')
        updates, new_opt = jtask.optimizer.update(grads, opt_state, params, lr=lr)
        new_params = optax.apply_updates(params, updates)
        ok = tree_all_finite(loss, grads) if guard else jnp.asarray(True)
        select = lambda new, old: jnp.where(ok, new, old)  # noqa: E731
        new_params = jax.tree.map(select, new_params, params)
        new_opt = jax.tree.map(select, new_opt, opt_state)
        if has_ema:
            ema = jax.tree.map(select, ema_update(ema, new_params, decay), ema)
        return loss, new_params, new_opt, ema, ~ok

    update = fns.setdefault(('update', accum, guard, has_ema), jax.jit(update))
    params = nnx.state(jtask.model, nnx.Param)
    decay = jtask.ema.get_decay(step) if has_ema else 0.0
    loss, new_params, jtask.opt_state, ema, bad = update(
        loss, grads, params, jtask.opt_state, jtask.ema_params if has_ema else (),
        jnp.asarray(lr, jnp.float32), jnp.asarray(decay, jnp.float32))
    nnx.update(jtask.model, new_params)
    if has_ema:
        jtask.ema_params = ema
    return {'loss': loss, 'nonfinite': bad}


def _task_state(jx, jtask, task):
    """{what: (port, JAX)} for the parameters, m, v and the statistics, in
    the port's names."""
    from timm_tpu.kernels.fused_adamw import _find_adam_states
    from timm_tpu.utils.serialization import flatten_pytree
    adam = _find_adam_states(jtask.opt_state)[0]
    opt = task.optimizer

    def port_names(flat_jax):
        return {k: v.numpy() for k, v in convert_jax_state_dict(flat_jax).items()}
    sd = {k: v.detach().numpy().copy() for k, v in task.model.state_dict().items()}
    jsd = port_names(jx.state(jtask.model))
    stat = lambda d: {k: v for k, v in d.items() if 'running_' in k}  # noqa: E731
    return {'params': ({k: v for k, v in sd.items() if 'running_' not in k},
                       {k: v for k, v in jsd.items() if 'running_' not in k}),
            'stats': (stat(sd), stat(jsd)),
            'mu': ({k: v.numpy().copy() for k, v in opt.views(opt.m).items()},
                   port_names(flatten_pytree(adam.mu))),
            'nu': ({k: v.numpy().copy() for k, v in opt.views(opt.v).items()},
                   port_names(flatten_pytree(adam.nu)))}


# Parameters after one step: within 5% of the step size. Adam's first step
# is lr * g / (|g| + eps), so a gradient within a few eps of zero carries
# its fp32 noise into the update; the gradients themselves (m and v) are
# held at GRAD_TOL of the model's largest. Against the port's gradients in
# fp64, accumulated over two microbatches of 2, the port's fp32 ones are
# 1.8e-5 of the largest away and JAX's 1.0e-5 (BatchNorm over 8 values a
# channel in the last stage scales rounding up).
PARAM_TOL = 0.05 * LR
GRAD_TOL = 5e-5


def _assert_states_close(states):
    """Parameters within PARAM_TOL; running statistics within 1e-5 (of
    magnitudes of at least 1); m and v within GRAD_TOL of the largest m or
    v of the model (a leaf whose gradient is zero but for noise, a norm's
    bias before a train-mode BatchNorm, has no scale of its own)."""
    for what, (port, ref) in states.items():
        assert set(port) == set(ref) and port, what
        top = max(float(np.abs(v).max()) for v in ref.values())
        for k in ref:
            tol = {'params': PARAM_TOL,
                   'stats': 1e-5 * max(1.0, float(np.abs(ref[k]).max()))}.get(what, GRAD_TOL * top)
            assert np.abs(port[k] - ref[k]).max() <= tol, (what, k)


@pytest.fixture(scope='module')
def guarded_run(jx):
    """The guarded task with EMA 0.9: one AdamW step on a good batch, the
    EMA evaluation after it and the JAX task's checkpoint; then a step on a
    batch with one NaN pixel."""
    jtask, task = _task_pair(jx, accum=1, guard=True, ema=True)
    good = _batch(3)
    # step 2: the EMA's decay is 0 at step 1 (a copy), 0.9 from step 2
    jm = _jax_train_step(jx, jtask, good, LR, 2)
    m = task.train_step(good, lr=LR, step=2)
    out = {'loss': (float(m['loss']), float(jm['loss'])), 'step1': _task_state(jx, jtask, task),
           'checkpoint': jtask.get_checkpoint_state()}
    x = _images(8)
    out['ema_eval'] = (task.eval_step({'input': x}, use_ema=True).numpy(),
                       np.asarray(jtask.eval_step({'input': jx.jnp.asarray(x)}, use_ema=True)),
                       task.eval_step({'input': x}).numpy())
    bad = _batch(4)
    bad['input'][1, 10, 20, 2] = np.nan
    jm = _jax_train_step(jx, jtask, bad, LR, 3)
    m = task.train_step(bad, lr=LR, step=3)
    out['nonfinite'] = (bool(m['nonfinite']), bool(jm['nonfinite']))
    out['step2'] = _task_state(jx, jtask, task)
    out['count'] = int(task.optimizer.count)
    return out


def test_adamw_step_matches_jax_task(guarded_run):
    """Loss within 1e-5, and parameters, running statistics, m and v as
    ``_assert_states_close`` holds them, against JAX's step after one step
    of the guarded task."""
    ours, ref = guarded_run['loss']
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-5
    _assert_states_close(guarded_run['step1'])


def test_accumulated_step_matches_jax_task(jx):
    """Gradient accumulation 2 (two microbatches of 2, the statistics
    updated by each in turn, as JAX's scan carries them) against the JAX
    task, guard off."""
    jtask, task = _task_pair(jx, accum=2, guard=False, ema=False)
    b = _batch(5, n=4)
    jm = _jax_train_step(jx, jtask, b, LR, 1)
    m = task.train_step(b, lr=LR, step=1)
    assert abs(float(m['loss']) - float(jm['loss'])) <= 1e-5
    _assert_states_close(_task_state(jx, jtask, task))


def test_guard_keeps_parameters_but_not_statistics(guarded_run):
    """The NaN batch is skipped: parameters, m, v and the step count stay
    as the good step left them; the running statistics take the NaN batch,
    NaN included, equal to JAX's (its step returns them unconditionally)."""
    assert guarded_run['nonfinite'] == (True, True) and guarded_run['count'] == 1
    s1, s2 = guarded_run['step1'], guarded_run['step2']
    for what in ('params', 'mu', 'nu'):
        for k, v in s1[what][0].items():
            assert np.array_equal(s2[what][0][k], v), (what, k)
    port, ref = s2['stats']
    assert any(np.isnan(v).any() for v in ref.values())
    for k in ref:
        assert np.array_equal(np.isnan(port[k]), np.isnan(ref[k])), k
        ok = ~np.isnan(ref[k])
        assert np.abs(port[k][ok] - ref[k][ok]).max(initial=0.0) <= 1e-5 * max(
            1.0, float(np.abs(ref[k][ok]).max(initial=0.0))), k


def test_ema_evaluation_on_live_statistics(guarded_run):
    """Evaluation with the EMA weights (parameters only) on the live
    model's running statistics, against JAX's; it differs from the live
    weights' evaluation."""
    ema, jax_ema, live = guarded_run['ema_eval']
    _assert_close(ema, jax_ema, 1e-5)
    assert np.abs(ema - live).max() > 1e-3


def test_jax_task_checkpoint_loads_strictly(guarded_run):
    """The JAX task's checkpoint (weights, statistics, EMA, m and v) goes
    through convert_jax_checkpoint into a fresh port task strictly, the
    statistics in place; one missing running statistic raises."""
    port_state = convert_jax_checkpoint(guarded_run['checkpoint'])
    stats = [k for k in port_state if k.startswith('model_state.')]
    assert len(stats) == 2 * 13 and all('.running_' in k for k in stats)
    tm = timm_tpu_torch.create_model(NAME, device='cpu', seed=5)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05))
    task.setup_ema(decay=0.9)
    buffer = tm.get_buffer('bn2.running_var')
    task.load_checkpoint_state(port_state)
    assert tm.get_buffer('bn2.running_var') is buffer
    ours = task.get_checkpoint_state()
    for k in port_state:
        if k.startswith(('state_dict', 'model_state.', 'optimizer.mu.', 'optimizer.nu.')):
            assert np.array_equal(ours[k], port_state[k]), k
    with pytest.raises(KeyError, match='Missing'):
        task.load_checkpoint_state({k: v for k, v in port_state.items()
                                    if k != 'model_state.blocks.4.0.bn1.running_mean'})


# ---- registry and contract -------------------------------------------------------------

_RAISING = {'efficientnet_blur_b0': 'blur pool', 'gc_efficientnetv2_rw_t': "'gc'",
            'test_efficientnet_evos': 'EvoNorm'}


def test_registry_matches_jax(jx, monkeypatch):
    """The JAX module's entrypoints and pretrained cfgs; each passes the
    model arguments JAX's passes (captured at the builder call of both,
    blocks decoded); every name builds (shapes only) but the three whose
    layers are not ported, which raise naming ROADMAP A.5.9."""
    from timm_tpu.models import _registry as jreg
    from timm_tpu.models import efficientnet as jeff
    from timm_tpu_torch.models import efficientnet as teff
    from timm_tpu_torch.models import _registry as treg
    names = sorted(n for n, mod in jreg._model_to_module.items() if mod == 'efficientnet')
    assert len(names) == 119
    assert sorted(n for n, mod in treg._model_to_module.items() if mod == 'efficientnet') == names
    for tagged in jx.timm_tpu.list_models(names, include_tags=True):
        assert timm_tpu_torch.models.get_pretrained_cfg(tagged).to_dict() == \
            jx.timm_tpu.models.get_pretrained_cfg(tagged).to_dict(), tagged

    def capture(variant, pretrained=False, **kwargs):
        def plain(v):
            if isinstance(v, __import__('functools').partial):
                return (v.func.__name__, v.keywords)
            return getattr(v, '__name__', v)
        return variant, {k: plain(v) for k, v in kwargs.items()}
    for module in (jeff, teff):
        monkeypatch.setattr(module, '_create_effnet', capture)
    for name in names:
        assert treg.model_entrypoint(name)() == jreg.model_entrypoint(name)(), name
    monkeypatch.undo()
    for name in names:
        if name in _RAISING:
            with pytest.raises(NotImplementedError, match='A.5.9'):
                timm_tpu_torch.create_model(name, device='meta')
        elif name.startswith(('efficientnetv2_', 'mixnet', 'efficientnet_cc', 'test_')):
            assert isinstance(timm_tpu_torch.create_model(name, device='meta'), teff.EfficientNet)


def test_efficientnetv2_s_shape_and_contract():
    """efficientnetv2_s at full size (shapes only): 21,458,488 parameters
    in 452 leaves, 220 statistics buffers; the contract on test_efficientnet."""
    m = timm_tpu_torch.create_model('efficientnetv2_s', device='meta')
    assert sum(p.numel() for p in m.parameters()) == 21_458_488
    assert len(list(m.parameters())) == 452 and len(list(m.buffers())) == 220
    assert [len(s) for s in m.blocks] == [2, 4, 4, 6, 9, 15] and m.num_features == 1280
    assert m.pretrained_cfg.input_size == (3, 300, 300)
    t = timm_tpu_torch.create_model(NAME, device='cpu', num_classes=7).eval()
    x = torch.from_numpy(_images(4, size=32))
    with torch.no_grad():
        final, inter = t.forward_intermediates(x, indices=[0, -1])
        assert [tuple(i.shape) for i in inter] == [(2, 16, 16, 16), (2, 1, 1, 64)]
        assert torch.equal(final, t.forward_features(x))
        assert t.forward_head(final, pre_logits=True).shape == (2, 256)
    assert t.get_classifier().out_features == 7
    t.reset_classifier(5, 'max')
    with torch.no_grad():
        assert t(x).shape == (2, 5)
    assert t.prune_intermediate_layers([0, 1]) == [0, 1] and len(t.blocks) == 2
    assert t.get_classifier() is None
    t.set_grad_checkpointing(True)
    assert t.grad_checkpointing
    feats = timm_tpu_torch.create_model(NAME, device='meta', features_only=True)
    assert feats.feature_info.channels() == [16, 24, 32, 48, 64]  # JAX's


# ---- on the card ------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_efficientnetv2_s_on_card_matches_cpu():
    """efficientnetv2_s (full width and depth, 300 px) in bf16 on the card
    against the same weights in fp32 on the CPU, batch 2, eval mode:
    relative L2 <= 2e-2."""
    _needs_card()
    x = torch.from_numpy(_images(6, size=300))
    cpu = timm_tpu_torch.create_model('efficientnetv2_s', device='cpu').eval()
    card = timm_tpu_torch.create_model('efficientnetv2_s', device='cuda',
                                       dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        ref = cpu(x).numpy()
        out = card(x.cuda()).float().cpu().numpy()
    assert np.isfinite(out).all() and _rel(out, ref) <= 2e-2


@pytest.mark.gpu
def test_replayed_train_step_equals_eager_with_statistics():
    """test_efficientnet's train step (bf16, AdamW, EMA, drop path 0.2)
    replayed as a CUDA graph against its eager body from one state, three
    steps: parameters, optimizer state, EMA and running statistics bit for
    bit."""
    _needs_card()
    def make():
        m = timm_tpu_torch.create_model(NAME, device='cuda', dtype=torch.bfloat16, seed=0,
                                        drop_path_rate=0.2)
        t = timm_tpu_torch.ClassificationTask(
            m, optimizer=create_optimizer_v2(m, opt='adamw', lr=LR, weight_decay=0.05),
            train_loss_fn=LabelSmoothingCrossEntropy(0.1), clip_grad=1.0, seed=0)
        t.setup_ema(decay=0.9)
        return t
    batches = [{k: torch.from_numpy(v).cuda() for k, v in _batch(20 + i, n=8).items()}
               for i in range(3)]
    eager, graph = make(), make()
    for i, b in enumerate(batches):
        eager.optimizer.set_hyperparams(lr=LR, ema_decay=eager.ema.get_decay(i + 1))
        eager.model.train()
        eager._train_body(b)
        graph.train_step(b, lr=LR, step=i + 1)
    torch.cuda.synchronize()
    # a warm-up (a real step), a capture and its replay, a replay
    assert graph.train_graphs.captures == 1 and graph.train_graphs.replays == 2
    for (k, a), b in zip(eager.model.state_dict().items(), graph.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in ((eager.optimizer.m, graph.optimizer.m), (eager.optimizer.v, graph.optimizer.v),
                 (eager.optimizer.ema, graph.optimizer.ema)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_serve_bucket_replays_equal_eager():
    """The engine's bucket graphs of test_efficientnet (bf16, eval mode on
    its running statistics) equal eager forwards bit for bit."""
    _needs_card()
    engine = timm_tpu_torch.InferenceEngine(buckets=(1, 4), device='cuda')
    engine.add_model(NAME, dtype=torch.bfloat16, seed=0)
    res = engine.pool.acquire(NAME)
    assert not res.model.training
    with torch.inference_mode():
        for b, g in engine.aot_executables(NAME).items():
            x = torch.from_numpy(_images(b, n=b, size=160))
            assert torch.equal(g.run(x.pin_memory()), res.model(x.cuda()).float())


@pytest.mark.gpu
def test_fused_adamw_effnetv2_s_case_on_card():
    """The registry's effnetv2_s case of fused_adamw (efficientnetv2_s's
    leaf set and decay mask) against its plain version on the card."""
    _needs_card()
    from timm_tpu_torch.kernels import registry
    spec = registry.get('fused_adamw')
    case = next(c for c in spec.cases if c.name == 'effnetv2_s')
    inputs = spec.make_inputs(device='cuda', **case.live)
    out = spec.kernel_fn(**inputs, **case.statics)
    ref = spec.reference_fn(**inputs, **case.statics)
    for o, r in zip(out, ref):
        scale = max(1.0, float(r.abs().max()))
        assert float((o.float() - r.float()).abs().max()) <= spec.parity_tol * scale
