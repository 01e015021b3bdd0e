"""Differential attention of the PyTorch port against the JAX package on the
CPU: the layer in both lambda forms, with masks and qk-norm; a narrow
differential-attention ViT (vit_dwee_patch16_reg1_gap_256 cut to 3 blocks of
64 channels at 64 px: register token, ``no_embed_class``, layer scale) in
fp32, in bf16 and through the token pad; the registered "little" / "wee"
names against the JAX shapes; and attention dropout held by its rate.

JAX is imported inside the fixtures. Its modules are built from their
shapes (``nnx.eval_shape``) and given seeded numpy weights, the layer-scale
gammas and the lambdas away from their near-trivial init, then carried
across.
"""
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.layers import DiffAttention, SeqPadMask
from timm_tpu_torch.models import load_jax_state_dict
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

VIT = 'vit_dwee_patch16_reg1_gap_256'
VIT_KW = dict(img_size=64, depth=3, embed_dim=64, num_heads=2)


def _seeded(shapes, seed):
    """Seeded weights: norm scales near 1, layer-scale gammas in [0.1, 1],
    lambdas of order 0.3, the rest of order 0.05."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(shapes.items()):
        leaf = k.rpartition('.')[2]
        if leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'gamma':
            v = rng.uniform(0.1, 1.0, shape)
        elif leaf.startswith('lambda'):
            v = 0.3 * rng.standard_normal(shape)
        else:
            v = 0.05 * rng.standard_normal(shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu
    from timm_tpu.layers.diff_attention import DiffAttention as JDiffAttention

    def build(factory, seed=0):
        """The JAX module ``factory()`` from its shapes, with seeded weights."""
        abstract = nnx.eval_shape(factory)
        graphdef, params, rest = nnx.split(abstract, nnx.Param, ...)
        shapes = {'.'.join(map(str, k)): tuple(v.get_value().shape)
                  for k, v in nnx.to_flat_state(params)}
        values = _seeded(shapes, seed)
        filled = nnx.from_flat_state({tuple(int(p) if p.isdigit() else p for p in k.split('.')):
                                      nnx.Param(jnp.asarray(v)) for k, v in values.items()})
        module = nnx.merge(graphdef, filled, rest)
        module.eval()
        return module, values

    call = nnx.jit(lambda m, x, mask: m(x, attn_mask=mask))
    fwd = nnx.jit(lambda m, x: m(x))
    # features and logits as one compiled program (cheaper here than eager ops)
    feats = nnx.jit(lambda m, x: (m.forward_features(x), m(x)))
    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu, build=build,
                                 call=call, fwd=fwd, feats=feats,
                                 JDiffAttention=JDiffAttention)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _masks(case):
    """(JAX mask, port mask) of a 'dense' (B, 1, N, N), 'key' (B, 1, 1, N)
    or 'seqpad' ('symmetric' SeqPadMask, its dense mask to JAX) case."""
    valid = np.arange(10)[None, :] < np.array([[10], [6]])
    if case is None:
        return None, None
    if case == 'key':
        m = valid[:, None, None, :]
        return m, torch.from_numpy(m)
    dense = valid[:, None, :, None] & valid[:, None, None, :]
    if case == 'dense':
        return dense, torch.from_numpy(dense)
    return dense, SeqPadMask(torch.from_numpy(valid), True)


@pytest.mark.parametrize('dual_lambda,qk_norm,mask', [
    (False, False, None), (True, False, None), (False, True, 'key'), (True, True, 'dense'),
    (False, False, 'seqpad')])
def test_diff_attention_matches_jax(jx, dual_lambda, qk_norm, mask):
    """The layer against JAX's on the same weights (fp32, <= 1e-5): both
    lambda forms, qk-norm (RmsNorm), a key mask, a per-query mask and a
    SeqPadMask (taken as its dense mask)."""
    kw = dict(num_heads=2, qkv_bias=True, qk_norm=qk_norm, depth=3, dual_lambda=dual_lambda)
    jm, values = jx.build(lambda: jx.JDiffAttention(32, rngs=jx.nnx.Rngs(0), **kw))
    tm = DiffAttention(32, **kw).eval()
    load_jax_state_dict(tm, values)
    assert tm.lambda_init == pytest.approx(0.8 - 0.6 * np.exp(-0.9))
    x = _x(1, (2, 10, 32))
    jmask, tmask = _masks(mask)
    want = np.asarray(jx.call(jm, jx.jnp.asarray(x), None if jmask is None else jx.jnp.asarray(jmask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), attn_mask=tmask).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_attention_dropout_is_held_by_its_rate(monkeypatch):
    """Attention dropout draws its keep mask from the module's generator
    (JAX's threefry numbers are not reproduced, ROADMAP C): the same
    generator state gives the same output, another seed another one, eval
    mode none; at rate 0.5 about half the fp32 probabilities are zeroed and
    the kept ones scaled by 2, JAX's formula."""
    import timm_tpu_torch.layers.diff_attention as da
    seen = []

    def recording(x, rate, training, generator):
        y = da.dropout.__wrapped__(x, rate, training, generator)
        seen.append((x, y))
        return y
    recording.__wrapped__ = da.dropout
    monkeypatch.setattr(da, 'dropout', recording)
    torch.manual_seed(0)
    tm = DiffAttention(32, num_heads=2, attn_drop=0.5).train()
    x = torch.from_numpy(_x(2, (2, 16, 32)))
    tm.attn_drop.generator = torch.Generator().manual_seed(7)
    with torch.no_grad():
        a = tm(x)
        tm.attn_drop.generator.manual_seed(7)
        b = tm(x)
        tm.attn_drop.generator.manual_seed(8)
        c = tm(x)
        ref = tm.eval()(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ref)
    p, y = seen[0]
    assert p.dtype == torch.float32 and y.shape == (2, 4, 16, 16)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.03
    assert torch.equal(y[kept], p[kept] / 0.5)


@pytest.fixture(scope='module')
def vit_pair(jx):
    """The narrow JAX diff ViT with seeded weights, and the port's fp32 and
    bf16 models carrying them (eval mode)."""
    jm, values = jx.build(lambda: jx.timm_tpu.create_model(VIT, **VIT_KW))
    tm = timm_tpu_torch.create_model(VIT, device='cpu', **VIT_KW).eval()
    load_jax_state_dict(tm, values)
    return jm, tm, values


def test_diff_vit_fp32_matches_jax(jx, vit_pair):
    """Features (register token and patches) and logits within 1e-5."""
    jm, tm, _ = vit_pair
    x = _x(3, (2, 64, 64, 3))
    with torch.no_grad():
        feats = tm.forward_features(torch.from_numpy(x)).numpy()
        logits = tm(torch.from_numpy(x)).numpy()
    assert tm.no_embed_class and tuple(tm.pos_embed.shape) == (1, 16, 64) and feats.shape[1] == 17
    jfeats, jlogits = jx.feats(jm, jx.jnp.asarray(x))
    np.testing.assert_allclose(feats, np.asarray(jfeats), atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-5, rtol=0)


def test_diff_vit_bf16_and_token_pad(jx, vit_pair):
    """bf16 compute against JAX bf16 (relative L2 <= 2e-2); and the token
    pad to 24 through DiffAttention's plain mask within 1e-5 of the
    unpadded fp32 model."""
    jm, tm, values = vit_pair
    x = _x(4, (2, 64, 64, 3))
    jb, _ = jx.build(lambda: jx.timm_tpu.create_model(VIT, dtype=jx.jnp.bfloat16, **VIT_KW))
    tb = timm_tpu_torch.create_model(VIT, device='cpu', dtype=torch.bfloat16, **VIT_KW).eval()
    load_jax_state_dict(tb, values)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).float().numpy()
        padded = tm.forward_features(torch.from_numpy(x))
        tm.pad_tokens_to = 24
        try:
            pad_feats = tm.forward_features(torch.from_numpy(x))
        finally:
            tm.pad_tokens_to = None
    want = np.asarray(jx.fwd(jb, jx.jnp.asarray(x)).astype('float32'))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2
    np.testing.assert_allclose(pad_feats.numpy(), padded.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize('name', ['vit_dlittle_patch16_reg1_gap_256', 'vit_little_patch16_reg4_gap_256',
                                  'vit_wee_patch16_reg1_gap_256', 'vit_dwee_patch16_reg1_gap_256'])
def test_registered_little_and_wee_names_match_jax_shapes(jx, name):
    """Each name builds (shapes only, cut to 2 of its 14 blocks) with the
    JAX entrypoint's arguments: every JAX parameter, converted, has the
    port's name and shape; the diff models' blocks carry their depth's
    lambda_init."""
    abstract = jx.nnx.eval_shape(lambda: jx.timm_tpu.create_model(name, depth=2))
    _, params, _ = jx.nnx.split(abstract, jx.nnx.Param, ...)
    from timm_tpu_torch.models._jax_convert import _convert_leaf
    want = {}
    for k, v in jx.nnx.to_flat_state(params):
        # the converter's rule on a stand-in of the leaf's shape (kernels
        # transposed into the port's layout)
        key, value = _convert_leaf('.'.join(map(str, k)),
                                   np.broadcast_to(np.float32(0), v.get_value().shape))
        want[key] = value.shape
    tm = timm_tpu_torch.create_model(name, device='meta', depth=2)
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    assert tm.default_cfg['input_size'] == (3, 256, 256)
    if name.startswith(('vit_dlittle', 'vit_dwee')):
        inits = [blk.attn.lambda_init for blk in tm.blocks]
        assert inits == pytest.approx([0.8 - 0.6 * np.exp(-0.3 * i) for i in range(len(tm.blocks))])
