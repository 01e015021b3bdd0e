"""ConvNeXt of the PyTorch port against the JAX package on the CPU: the conv
layers, norms, pools, GRN and head; test_convnext2 (LayerNorm, patch stem)
and test_convnext3 (overlap_tiered stem, GRN) in fp32 and bf16 on carried
weights; one AdamW step of the training task; a JAX task checkpoint; the
registry; and convnext_base on the card.

At init every ConvNeXt block is nearly the identity (layer scale 1e-6, GRN
weight and bias 0), so a comparison there would hold whatever the blocks
compute. The JAX models here are built from their shapes
(``nnx.eval_shape``) and given seeded numpy weights instead: layer-scale
gammas in [0.1, 1.0], GRN weight and bias of order 0.1, norm scales near 1,
small biases; then carried across. JAX is imported inside the fixtures and
compiles each model's forward once (``nnx.jit``), which is far cheaper on
this CPU than building and running the models eagerly.
"""
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers import (
    GlobalResponseNorm, LayerNorm, LayerNormFp32, NormMlpClassifierHead, RmsNorm,
    SelectAdaptivePool2d, SimpleNorm, calculate_drop_path_rates, create_conv2d,
    create_norm_layer, get_norm_layer,
)
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.models import convert_jax_checkpoint, convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.optim import create_optimizer_v2
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 64
LR = 1e-3


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _seeded_params(flat_shapes, seed):
    """Seeded numpy values for a JAX model's parameters (JAX names and
    layouts), away from ConvNeXt's near-identity init."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(flat_shapes.items()):
        leaf = key.rpartition('.')[2]
        if key.endswith('ls.gamma'):
            v = rng.uniform(0.1, 1.0, shape)
        elif '.grn.' in key:
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'bias':
            v = 0.02 * rng.standard_normal(shape)
        elif len(shape) == 4:  # HWIO conv kernel: variance scaling 2.0 over fan-out
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
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

    def build(name, seed=0, **kw):
        """The JAX model ``name`` from its shapes, with seeded weights."""
        abstract = nnx.eval_shape(lambda: timm_tpu.create_model(name, **kw))
        graphdef, params, rest = nnx.split(abstract, nnx.Param, ...)
        shapes = {'.'.join(map(str, k)): tuple(v.get_value().shape) for k, v in nnx.to_flat_state(params)}
        values = _seeded_params(shapes, seed)
        filled = nnx.from_flat_state({tuple(int(p) if p.isdigit() else p for p in k.split('.')):
                                      nnx.Param(jnp.asarray(v)) for k, v in values.items()})
        model = nnx.merge(graphdef, filled, rest)
        model.eval()
        return model, values

    def features_and_logits(m, x):
        feats = m.forward_features(x)
        return feats, m.forward_head(feats)

    fwd = nnx.jit(features_and_logits)
    # a layer's forward as one compiled program (cheaper here than eager ops)
    call = nnx.jit(lambda m, x: m(x))
    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu,
                                 state=model_state_dict, build=build, fwd=fwd, call=call)


def _port(name, flat, dtype=None):
    tm = timm_tpu_torch.create_model(name, device='cpu', dtype=dtype).eval()
    return load_jax_state_dict(tm, flat)


_SEEDS = {'test_convnext2': 0, 'test_convnext3': 1}


@pytest.fixture(scope='module')
def pairs(jx):
    """{name: (JAX fp32 model, JAX weights)} for the two test models."""
    return {name: jx.build(name, seed=seed) for name, seed in _SEEDS.items()}


def _jax_out(jx, model, x):
    feats, logits = jx.fwd(model, jx.jnp.asarray(x))
    return feats, logits


@pytest.mark.parametrize('name', ['test_convnext2', 'test_convnext3'])
def test_fp32_parity(jx, pairs, name):
    jm, flat = pairs[name]
    tm = _port(name, flat)
    x = _images(0)
    with torch.no_grad():
        t_feats, t_logits = tm.forward_features(torch.from_numpy(x)), tm(torch.from_numpy(x))
    j_feats, j_logits = (np.asarray(a) for a in _jax_out(jx, jm, x))
    assert t_feats.shape == (2, 2, 2, 128) and t_logits.shape == (2, 1000)
    np.testing.assert_allclose(t_feats.numpy(), j_feats, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['test_convnext2', 'test_convnext3'])
def test_bf16_parity(jx, pairs, name):
    """bf16 compute against JAX bf16 (relative L2 <= 2e-2), with JAX's
    dtypes: the stem's norm returns fp32, the bf16 downsample convs make
    stages 1-3 bf16, the logits are bf16."""
    _, flat = pairs[name]
    jm, _ = jx.build(name, seed=_SEEDS[name], dtype=jx.jnp.bfloat16)
    tm = _port(name, flat, dtype=torch.bfloat16)
    x = _images(1)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        stem = tm._stem(xt)
        stage0 = tm.stages[0](stem)
        t_feats, t_logits = tm.forward_features(xt), tm(xt)
    j_feats, j_logits = _jax_out(jx, jm, x)
    assert stem.dtype == stage0.dtype == torch.float32
    assert t_feats.dtype == torch.bfloat16 and str(j_feats.dtype) == 'bfloat16'
    assert t_logits.dtype == torch.bfloat16 and str(j_logits.dtype) == 'bfloat16'
    assert _rel(t_logits.float().numpy(), np.asarray(j_logits.astype('float32'))) <= 2e-2
    assert _rel(t_feats.float().numpy(), np.asarray(j_feats.astype('float32'))) <= 2e-2


def test_weight_carry_is_strict(jx, pairs):
    """Depthwise (7, 7, 1, C) -> (C, 1, 7, 7), the 2x2 downsample HWIO ->
    OIHW, GRN's weight and bias by their names; every key used, and a
    missing or unexpected key raises."""
    _, flat = pairs['test_convnext3']
    tm = timm_tpu_torch.create_model('test_convnext3', device='cpu')
    converted = convert_jax_state_dict(flat)
    assert set(converted) == set(tm.state_dict())
    dw = 'stages.1.blocks.0.conv_dw'
    assert flat[f'{dw}.kernel'].shape == (7, 7, 1, 64) and converted[f'{dw}.weight'].shape == (64, 1, 7, 7)
    np.testing.assert_array_equal(converted[f'{dw}.weight'].numpy()[5, 0],
                                  flat[f'{dw}.kernel'][:, :, 0, 5])
    ds = 'stages.2.downsample_conv'
    np.testing.assert_array_equal(converted[f'{ds}.weight'].numpy(),
                                  flat[f'{ds}.kernel'].transpose(3, 2, 0, 1))
    grn = 'stages.0.blocks.0.mlp.grn'
    np.testing.assert_array_equal(converted[f'{grn}.weight'].numpy(), flat[f'{grn}.weight'])
    load_jax_state_dict(tm, flat)
    missing = dict(flat)
    missing.pop(f'{grn}.bias')
    with pytest.raises(RuntimeError, match='Missing'):
        load_jax_state_dict(tm, missing)
    with pytest.raises(RuntimeError, match='Unexpected'):
        load_jax_state_dict(tm, dict(flat, **{'stages.0.blocks.0.ls.gamma': np.ones(32, np.float32)}))


# ---- one AdamW step through the training task --------------------------------

@pytest.fixture(scope='module')
def task_step(jx, pairs):
    """The JAX task and the port's, from the same weights, after one AdamW
    step (clip 1.0, label smoothing 0.1, weight decay 0.05 with the mask)
    on one batch of 2 x 64 x 64; and the JAX task's checkpoint state."""
    from timm_tpu.kernels.fused_adamw import _find_adam_states
    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.task import ClassificationTask as JTask
    from timm_tpu.utils.serialization import flatten_pytree

    jm, flat = jx.build('test_convnext2', seed=0)
    jm.train()
    jtask = JTask(jm, optimizer=jopt(jm, opt='adamw', lr=LR, weight_decay=0.05),
                  mesh=create_mesh(jx.jax.devices()[:1]), train_loss_fn=JLS(0.1), clip_grad=1.0,
                  nonfinite_guard=False)
    tm = timm_tpu_torch.create_model('test_convnext2', device='cpu')
    load_jax_state_dict(tm, flat)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05),
        train_loss_fn=LabelSmoothingCrossEntropy(0.1), clip_grad=1.0, nonfinite_guard=False)
    rng = np.random.default_rng(3)
    batch = {'input': _images(3), 'target': rng.integers(0, 1000, 2).astype(np.int32)}
    jmetrics = jtask.train_step({k: jx.jnp.asarray(v) for k, v in batch.items()}, lr=LR, step=1)
    metrics = task.train_step(batch, lr=LR, step=1)
    adam = _find_adam_states(jtask.opt_state)[0]

    def port_names(flat_jax):
        return {k: v.numpy() for k, v in convert_jax_state_dict(flat_jax).items()}
    opt = task.optimizer
    return types.SimpleNamespace(
        loss=(float(metrics['loss']), float(jmetrics['loss'])),
        state={'params': ({k: v.detach().numpy() for k, v in tm.state_dict().items()},
                          port_names(jx.state(jm))),
               'mu': ({k: v.numpy() for k, v in opt.views(opt.m).items()},
                      port_names(flatten_pytree(adam.mu))),
               'nu': ({k: v.numpy() for k, v in opt.views(opt.v).items()},
                      port_names(flatten_pytree(adam.nu)))},
        checkpoint=jtask.get_checkpoint_state(), task=task)


def test_adamw_step_matches_jax_task(task_step):
    """Loss, parameters (max abs) and m, v (max abs over each leaf's
    largest) within 1e-5 of the JAX task's after one step."""
    ours, ref = task_step.loss
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-5
    for what, (port, jax_) in task_step.state.items():
        assert set(port) == set(jax_), what
        for k in jax_:
            scale = 1.0 if what == 'params' else max(float(np.abs(jax_[k]).max()), 1e-30)
            assert np.abs(port[k] - jax_[k]).max() <= 1e-5 * scale, (what, k)


def test_jax_task_checkpoint_loads_strictly(task_step):
    """The JAX task's checkpoint state (weights, m and v, count, lr) goes
    through convert_jax_checkpoint into a fresh port task, strictly, and
    equals it key by key; conv moments are transposed as their kernels."""
    state = task_step.checkpoint
    port_state = convert_jax_checkpoint(state)
    tm = timm_tpu_torch.create_model('test_convnext2', device='cpu', seed=5)
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt='adamw', lr=LR, weight_decay=0.05))
    task.load_checkpoint_state(port_state)
    ours = task.get_checkpoint_state()
    n = len(list(tm.parameters()))
    checked = [k for k in port_state if k.startswith(('state_dict.', 'optimizer.mu.', 'optimizer.nu.'))]
    assert len(checked) == 3 * n and int(ours['optimizer.count']) == 1
    for k in checked:
        assert np.array_equal(ours[k], port_state[k]), k
    key = 'stages.1.blocks.0.conv_dw'
    assert np.array_equal(port_state[f'optimizer.mu.{key}.weight'],
                          state[f'optimizer.inner_state.0.mu.{key}.kernel'].transpose(3, 2, 0, 1))
    with pytest.raises(KeyError, match='Missing'):
        task.load_checkpoint_state({k: v for k, v in port_state.items()
                                    if k != f'optimizer.nu.{key}.bias'})


# ---- registry -------------------------------------------------------------------

def test_registry_matches_jax(jx, monkeypatch):
    """list_models('convnext*') and every pretrained cfg are the JAX
    package's; each entrypoint passes the model arguments JAX's passes
    (captured at the builder call of both); every name builds at full size
    (shapes only); the unported options raise."""
    from timm_tpu.models import convnext as jconvnext
    from timm_tpu_torch.models import convnext as tconvnext
    names = jx.timm_tpu.list_models('convnext*')
    assert timm_tpu_torch.list_models('convnext*') == names and len(names) == 28
    for tagged in jx.timm_tpu.list_models('*convnext*', include_tags=True):
        want = jx.timm_tpu.models.get_pretrained_cfg(tagged).to_dict()
        assert timm_tpu_torch.models.get_pretrained_cfg(tagged).to_dict() == want, tagged

    def capture(variant, pretrained=False, **kwargs):
        return variant, {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
    for module in (jconvnext, tconvnext):
        monkeypatch.setattr(module, '_create_convnext', capture)
    for name in names:
        assert tconvnext.__dict__[name]() == jconvnext.__dict__[name](), name
        assert tconvnext.__dict__[name](norm_eps=1e-3) == jconvnext.__dict__[name](norm_eps=1e-3)
    monkeypatch.undo()
    for name in names:
        assert isinstance(timm_tpu_torch.create_model(name, device='meta'), tconvnext.ConvNeXt)
    base = timm_tpu_torch.create_model('convnext_base', device='meta')
    assert sum(p.numel() for p in base.parameters()) == 88_591_464
    assert len(list(base.parameters())) == 344 and base.no_weight_decay() == set()
    with pytest.raises(NotImplementedError, match='A.5.7'):
        base.set_grad_checkpointing(True)
    with pytest.raises(NotImplementedError, match='A.5.7'):
        timm_tpu_torch.create_model('test_convnext2', device='meta', stage_scan=True)


def test_contract_intermediates_prune_and_reset():
    m = timm_tpu_torch.create_model('test_convnext2', device='cpu', num_classes=7).eval()
    x = torch.from_numpy(_images(4, size=32))
    with torch.no_grad():
        final, inter = m.forward_intermediates(x, indices=[0, -1])
        assert [t.shape for t in inter] == [(2, 8, 8, 32), (2, 1, 1, 128)]
        assert torch.equal(final, m.forward_features(x))
        assert m.forward_head(final, pre_logits=True).shape == (2, 128)
    assert m.get_classifier().out_features == 7
    assert [g for g, _ in m.group_matcher()['blocks']] == [
        r'^stages\.(\d+)\.downsample', r'^stages\.(\d+)\.blocks\.(\d+)', r'^norm_pre']
    m.reset_classifier(5, 'max')
    with torch.no_grad():
        assert m(x).shape == (2, 5)
    with pytest.raises(ValueError, match='NHWC'):
        m.forward_intermediates(x, output_fmt='NCHW')
    assert m.prune_intermediate_layers([0, 1]) == [0, 1] and len(m.stages) == 2
    assert m.get_classifier() is None


# ---- layers ---------------------------------------------------------------------

_CONV_CASES = {
    # (in, out, kernel, stride, padding, dilation, depthwise, input size)
    'symmetric_k3': (4, 6, 3, 1, '', 1, False, 9),
    'valid_k3_s2': (4, 6, 3, 2, 'valid', 1, False, 10),
    'same_k3_s2_even': (4, 6, 3, 2, 'same', 1, False, 10),
    'same_k4_s2_dilated': (4, 6, 4, 2, 'same', 2, False, 11),
    'patch_k4_s4': (3, 8, 4, 4, 0, 1, False, 16),
    'depthwise_k7': (8, 8, 7, 1, '', 1, True, 10),
}


@pytest.mark.parametrize('case', list(_CONV_CASES))
def test_conv2d_matches_jax(jx, case):
    cin, cout, k, s, pad, d, dw, size = _CONV_CASES[case]
    from timm_tpu.layers import create_conv2d as jconv
    rng = np.random.default_rng(len(case))
    jc = jconv(cin, cout, k, stride=s, padding=pad, dilation=d, depthwise=dw, bias=True,
               rngs=jx.nnx.Rngs(0))
    jc.bias.value = jx.jnp.asarray(rng.standard_normal(cout).astype(np.float32))
    tc = create_conv2d(cin, cout, k, stride=s, padding=pad, dilation=d, depthwise=dw, bias=True)
    load_jax_state_dict(tc, jx.state(jc))
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    ref = np.asarray(jx.call(jc, jx.jnp.asarray(x)))
    with torch.no_grad():
        out = tc(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


_NORMS = {'layernorm': (LayerNorm, 'LayerNorm'), 'layernormfp32': (LayerNormFp32, 'LayerNormFp32'),
          'rmsnorm': (RmsNorm, 'RmsNorm'), 'simplenorm': (SimpleNorm, 'SimpleNorm')}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('norm', list(_NORMS))
def test_norms_match_jax(jx, norm, dtype):
    """Output and dtype of each norm on a (2, 5, 5, 16) input, with
    non-trivial affine parameters: fp32 within 1e-5, bf16 within 1e-2."""
    import timm_tpu.layers as jl
    cls, jname = _NORMS[norm]
    assert get_norm_layer(norm) is cls
    jn = getattr(jl, jname)(16, rngs=jx.nnx.Rngs(0))
    rng = np.random.default_rng(7)
    flat = {k: (1.0 + 0.3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in jx.state(jn).items()}
    jx.nnx.update(jn, jx.nnx.from_flat_state(
        {tuple(k.split('.')): jx.nnx.Param(jx.jnp.asarray(v)) for k, v in flat.items()}))
    tn = create_norm_layer(norm, 16)
    load_jax_state_dict(tn, flat)
    x = (1.0 + rng.standard_normal((2, 5, 5, 16))).astype(np.float32)
    jt = getattr(jx.jnp, dtype)
    ref = jx.call(jn, jx.jnp.asarray(x).astype(jt))
    with torch.no_grad():
        out = tn(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(out.dtype).split('.')[-1] == str(ref.dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')),
                               atol=1e-5 if dtype == 'float32' else 1e-2, rtol=0)


def test_norm_factory_raises_for_batchnorm():
    """The batchnorm and groupnorm names, which raised until BatchNorm was
    ported, now build the ported layers (the JAX package's map); an
    unknown name still raises."""
    from timm_tpu_torch.layers import BatchNorm2d, GroupNorm, GroupNorm1
    for name, cls in (('batchnorm', BatchNorm2d), ('batchnorm2d', BatchNorm2d),
                      ('batch_norm1d', BatchNorm2d), ('groupnorm', GroupNorm),
                      ('groupnorm1', GroupNorm1)):
        assert get_norm_layer(name) is cls
        layer = create_norm_layer(name, 32)
        assert isinstance(layer, cls) and layer.weight.shape == (32,)
    assert create_norm_layer('groupnorm', 32).num_groups == 32
    with pytest.raises(ValueError, match='Unknown'):
        get_norm_layer('nonorm')


@pytest.mark.parametrize('pool_type', ['avg', 'max', 'avgmax', 'catavgmax', 'fast', 'fastavgmax', ''])
def test_select_adaptive_pool_matches_jax(jx, pool_type):
    from timm_tpu.layers import SelectAdaptivePool2d as JPool
    x = np.random.default_rng(2).standard_normal((2, 3, 4, 5)).astype(np.float32)
    jp, tp = JPool(pool_type=pool_type, flatten=True), SelectAdaptivePool2d(pool_type=pool_type)
    assert tp.feat_mult() == jp.feat_mult() and tp.is_identity() == jp.is_identity()
    np.testing.assert_allclose(tp(torch.from_numpy(x)).numpy(), np.asarray(jx.call(jp, jx.jnp.asarray(x))),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grn_matches_jax(jx, dtype):
    """GRN with weight and bias of order 0.1; its reduction in fp32."""
    from timm_tpu.layers import GlobalResponseNorm as JGrn
    rng = np.random.default_rng(4)
    jg = JGrn(12)
    flat = {'weight': (0.1 * rng.standard_normal(12)).astype(np.float32),
            'bias': (0.1 * rng.standard_normal(12)).astype(np.float32)}
    jg.weight.value, jg.bias.value = (jx.jnp.asarray(flat[k]) for k in ('weight', 'bias'))
    tg = GlobalResponseNorm(12)
    load_jax_state_dict(tg, flat)
    x = rng.standard_normal((2, 4, 4, 12)).astype(np.float32)
    ref = jx.call(jg, jx.jnp.asarray(x).astype(getattr(jx.jnp, dtype)))
    with torch.no_grad():
        out = tg(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(out.dtype).split('.')[-1] == str(ref.dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')),
                               atol=1e-5 if dtype == 'float32' else 2e-2, rtol=0)


def test_norm_mlp_head_matches_jax(jx, hidden_size=24):
    """Pool, norm, the optional pre-logits fc + tanh, fc; then reset."""
    from timm_tpu.layers import NormMlpClassifierHead as JHead
    jh = JHead(16, 10, hidden_size=hidden_size, rngs=jx.nnx.Rngs(0))
    th = NormMlpClassifierHead(16, 10, hidden_size=hidden_size)
    load_jax_state_dict(th, jx.state(jh))
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 16)).astype(np.float32)
    with torch.no_grad():
        out = th(torch.from_numpy(x)).numpy()
        pre = th(torch.from_numpy(x), pre_logits=True)
    np.testing.assert_allclose(out, np.asarray(jx.call(jh, jx.jnp.asarray(x))), atol=1e-5, rtol=0)
    assert pre.shape == (2, hidden_size or 16)
    th.reset(3, 'max')
    assert th.fc.out_features == 3 and th.global_pool.pool_type == 'max'


def test_stagewise_drop_path_rates_match_jax(jx):
    from timm_tpu.layers import calculate_drop_path_rates as jrates
    for args in ((0.5, [3, 3, 27, 3], True), (0.1, 12, False), (0.2, [2, 1], False)):
        assert calculate_drop_path_rates(*args) == jrates(*args)
    with pytest.raises(ValueError, match='stagewise'):
        calculate_drop_path_rates(0.1, 4, stagewise=True)


# ---- on the card ------------------------------------------------------------------

def _lift_from_init(model, seed=0):
    """Layer-scale gammas in [0.1, 1.0] and GRN weight and bias of order
    0.1, drawn from numpy, copied into ``model`` in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('ls.gamma'):
                p.copy_(torch.from_numpy(rng.uniform(0.1, 1.0, p.shape).astype(np.float32)))
            elif '.grn.' in name:
                p.copy_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    return model


@pytest.mark.gpu
def test_convnext_base_on_card_matches_cpu():
    """convnext_base (full width and depth) in bf16 on the card against the
    same weights in fp32 on the CPU, batch 2: relative L2 <= 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(_images(6, size=224))
    cpu = _lift_from_init(timm_tpu_torch.create_model('convnext_base', device='cpu')).eval()
    card = _lift_from_init(timm_tpu_torch.create_model('convnext_base', device='cuda',
                                                       dtype=torch.bfloat16)).eval()
    with torch.inference_mode():
        ref = cpu(x).numpy()
        out = card(x.cuda()).float().cpu().numpy()
    assert np.isfinite(out).all() and _rel(out, ref) <= 2e-2


@pytest.mark.gpu
def test_convnext_serve_graph_replays_equal_eager():
    """The engine's bucket graphs of test_convnext2 (bf16) equal eager
    forwards bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    engine = timm_tpu_torch.InferenceEngine(buckets=(1, 4), device='cuda')
    engine.add_model('test_convnext2', dtype=torch.bfloat16, seed=0)
    res = engine.pool.acquire('test_convnext2')
    graphs = engine.aot_executables('test_convnext2')
    with torch.inference_mode():
        for b, g in graphs.items():
            x = torch.from_numpy(_images(b, n=b, size=160))
            assert torch.equal(g.run(x.pin_memory()), res.model(x.cuda()).float())
