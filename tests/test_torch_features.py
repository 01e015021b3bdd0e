"""``features_only`` of the PyTorch port against the JAX package on the CPU,
for every ported family: ViT, DeiT, NaFlexVit, ConvNeXt, EfficientNet and
ResNet. ``create_model(..., features_only=True)`` builds ``FeatureGetterNet``
over the model's ``forward_intermediates`` in both packages; on the same
seeded weights (and BatchNorm statistics) the pruned models hold the same
parameters, their feature maps agree within 1e-5 (fp32), and their
``feature_info`` names the same channels and reductions. Plus the wrapper's
own options (``out_indices``, ``return_dict``, ``out_map``, ``norm``,
NLC output) against the model's ``forward_intermediates``.

JAX is imported inside the fixture; the models are narrow fixtures.
"""
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.models import FeatureGetterNet, load_jax_state_dict
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5

# (entrypoint, model arguments, image size, out_indices or None for the default)
_FAMILIES = [
    ('test_vit', dict(img_size=32), 32, (0, 1)),
    ('deit_tiny_distilled_patch16_224', dict(img_size=32, depth=3, embed_dim=48), 32, (1, 2)),
    ('test_naflexvit', dict(depth=5), 32, None),
    ('test_convnext2', {}, 32, None),
    ('test_efficientnet', {}, 64, None),
    ('test_resnet', {}, 64, None),
]


def _seeded(shapes, seed):
    """Seeded values for a JAX model's parameters and statistics."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in sorted(shapes.items()):
        leaf = key.rpartition('.')[2]
        if leaf == 'mean':
            v = 0.1 * rng.standard_normal(shape)
        elif leaf == 'var':
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'gamma':
            v = rng.uniform(0.1, 1.0, shape)
        elif len(shape) == 4:  # HWIO conv kernel
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
        elif len(shape) == 2:
            v = rng.standard_normal(shape) * np.sqrt(1.0 / shape[0])
        else:
            v = 0.02 * rng.standard_normal(shape)
        out[key] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu

    def build(name, seed=0, **kw):
        """The JAX model from its shapes, with seeded weights and statistics."""
        abstract = nnx.eval_shape(lambda: timm_tpu.create_model(name, **kw))
        graphdef, state = nnx.split(abstract)
        flat = {'.'.join(map(str, k)): v for k, v in nnx.to_flat_state(state)
                if 'rngs' not in '.'.join(map(str, k))}
        values = _seeded({k: tuple(v.get_value().shape) for k, v in flat.items()}, seed)
        filled = nnx.from_flat_state({
            tuple(int(p) if p.isdigit() else p for p in k.split('.')):
                type(v)(jnp.asarray(values[k]).astype(v.get_value().dtype))
            for k, v in flat.items()})
        rest = {k: v for k, v in nnx.to_flat_state(state) if 'rngs' in '.'.join(map(str, k))}
        model = nnx.merge(graphdef, filled, nnx.from_flat_state(rest))
        model.eval()
        return model, values

    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, build=build,
                                 call=nnx.jit(lambda m, x: m(x)))


def _x(seed, size):
    return np.random.default_rng(seed).standard_normal((2, size, size, 3)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()) <= TOL


@pytest.mark.parametrize('name,kw,size,out_indices', _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_features_only_matches_jax(jx, name, kw, size, out_indices):
    """features_only on both sides: the same pruned parameters, feature maps
    within 1e-5, and the same feature_info."""
    if out_indices is not None:
        kw = dict(kw, out_indices=out_indices)
    jm, values = jx.build(name, features_only=True, **kw)
    tm = timm_tpu_torch.create_model(name, device='cpu', features_only=True, **kw).eval()
    assert isinstance(tm, FeatureGetterNet)
    load_jax_state_dict(tm, values)
    x = _x(1, size)
    want = jx.call(jm, jx.jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _close(a.numpy(), np.asarray(b))
    if jm.feature_info is None:
        assert tm.feature_info is None
    else:
        assert tm.feature_info.channels() == jm.feature_info.channels()
        assert tm.feature_info.reduction() == jm.feature_info.reduction()
        assert tm.feature_info.module_name() == jm.feature_info.module_name()


def test_feature_getter_options():
    """The wrapper's options over a ViT: its features are the model's
    forward_intermediates at out_indices, named by out_map with
    return_dict, through the final norm with norm=True (which also keeps
    the norm from pruning), and NLC when asked; the model is pruned to its
    last index."""
    base = timm_tpu_torch.create_model('test_vit', device='cpu', img_size=32, seed=3).eval()
    x = torch.from_numpy(_x(2, 32))
    with torch.no_grad():
        want = base.forward_intermediates(x, indices=[0], norm=True, output_fmt='NLC',
                                          intermediates_only=True)
    model = timm_tpu_torch.create_model('test_vit', device='cpu', img_size=32, seed=3).eval()
    feats = FeatureGetterNet(model, out_indices=(0,), norm=True, output_fmt='NLC',
                             return_dict=True, out_map=['first'])
    assert len(feats.model.blocks) == 1 and feats.model.norm is not None
    assert feats.model.head is None
    with torch.no_grad():
        got = feats(x)
    assert list(got) == ['first'] and torch.equal(got['first'], want[0])
    assert feats.feature_info.channels() == [64] and feats.feature_info.reduction() == [16]
    pruned = timm_tpu_torch.create_model('test_vit', device='cpu', img_size=32,
                                         features_only=True, out_indices=(1,))
    assert pruned.model.norm is None and pruned.out_indices == [1]


def test_features_only_default_indices_follow_jax_cfgs():
    """The entrypoints' feature_cfg: ViT's last 3 blocks, ConvNeXt's four
    stages, ResNet's stem and four stages, EfficientNet's stacks 1-5 of a
    7-stack net (JAX's values)."""
    vit = timm_tpu_torch.create_model('vit_base_patch16_224', device='meta', features_only=True)
    assert vit.out_indices == [9, 10, 11] and len(vit.model.blocks) == 12
    conv = timm_tpu_torch.create_model('convnext_atto', device='meta', features_only=True)
    assert conv.feature_info.reduction() == [4, 8, 16, 32]
    res = timm_tpu_torch.create_model('resnet50', device='meta', features_only=True)
    assert res.feature_info.reduction() == [2, 4, 8, 16, 32]
    eff = timm_tpu_torch.create_model('efficientnet_b0', device='meta', features_only=True)
    assert eff.out_indices == [1, 2, 3, 4, 5]
    assert eff.feature_info.reduction() == [4, 8, 16, 16, 32]
