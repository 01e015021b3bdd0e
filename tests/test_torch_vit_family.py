"""The ViT family of the PyTorch port against the JAX package on the CPU:
every vision_transformer and deit entrypoint's model arguments and
parameter count, one narrow model for each distinct construction (block
function, pool, MLP, activation, norm, token layout, dynamic image size,
DeiT's distillation token) forward and backward on carried weights, the
compute-precision policy, patch dropout, the latent pool, the pos-embed
resample, and the flash kernel's plain version at the ViT family's head
dims and at Nq != Nk; with the card, the kernel itself at those shapes.

JAX is imported inside the fixtures. Its models are built from their shapes
(``nnx.eval_shape``) and given seeded numpy weights, then carried across.
Tolerances: fp32 1e-5 (of magnitudes of at least 1), bf16 2e-2 relative L2.
"""
import functools
import re
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.models import convert_jax_state_dict, load_jax_state_dict
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

FP32_TOL = 1e-5
BF16_REL_L2 = 2e-2


def _seeded(shapes, seed):
    """Seeded weights: norm scales near 1, layer-scale gammas in [0.1, 1],
    the rest of order 0.05 (0.3 for lambdas and latent queries)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in sorted(shapes.items()):
        leaf = k.rpartition('.')[2]
        if leaf == 'scale':
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == 'gamma':
            v = rng.uniform(0.1, 1.0, shape)
        elif leaf.startswith('lambda') or leaf == 'latent':
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

    @nnx.jit
    def fwd_grad(m, x, w):
        """Logits and the gradients of sum(logits * w)."""
        def loss(mm):
            out = mm(x)
            return (out * w).sum(), out
        (_, out), grads = nnx.value_and_grad(loss, has_aux=True)(m)
        return out, grads

    @jax.jit
    def sdpa_and_grads(q, k, v, mask, g):
        """JAX's _sdpa and the gradients of sum(_sdpa * g)."""
        from timm_tpu.layers.attention import _sdpa
        f = lambda a, b, c: _sdpa(a, b, c, attn_mask=mask)  # noqa: E731
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu, build=build,
                                 fwd_grad=fwd_grad,
                                 fwd=nnx.jit(lambda m, x: m(x)), sdpa_and_grads=sdpa_and_grads)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(got, want, tol=FP32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert float(err.max()) <= tol, float(err.max())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- every entrypoint's arguments and parameter count ------------------------------


def _norm_arg(v):
    """A model argument in a form both packages share: a partial as its
    function's name and keywords, a class or function as its name."""
    if isinstance(v, functools.partial):
        return ('partial', _norm_arg(v.func), tuple(_norm_arg(a) for a in v.args),
                tuple(sorted((k, _norm_arg(a)) for k, a in v.keywords.items())))
    if isinstance(v, type) or callable(v):
        return getattr(v, '__name__', repr(v))
    if isinstance(v, (list, tuple)):
        return tuple(_norm_arg(a) for a in v)
    return v


def _entrypoint_names(module_file):
    return re.findall(r'@register_model\ndef (\w+)', open(module_file).read())


def _captured_args(monkeypatch, modules, create_name, names):
    """{name: (variant, normalised kwargs)} of each module's entrypoints
    with ``create_name`` replaced by a function that builds nothing."""
    def capture(variant, pretrained=False, *args, **kwargs):
        return variant, tuple(args), tuple(sorted((k, _norm_arg(v)) for k, v in kwargs.items()))
    out = []
    for module in modules:
        monkeypatch.setattr(module, create_name, capture)
        out.append({n: module.__dict__[n]() for n in names})
    monkeypatch.undo()
    return out


def test_every_entrypoint_passes_jax_model_arguments(monkeypatch):
    """All 157 vision_transformer and 5 deit entrypoints hand their create
    function the JAX entrypoints' arguments, caller kwargs merged the same."""
    import timm_tpu.models.deit as jdeit
    import timm_tpu.models.vision_transformer as jvit
    import timm_tpu_torch.models.deit as tdeit
    import timm_tpu_torch.models.vision_transformer as tvit
    vit_names = _entrypoint_names(jvit.__file__)
    deit_names = _entrypoint_names(jdeit.__file__)
    assert len(vit_names) == 157 and len(deit_names) == 5
    tj, jj = _captured_args(monkeypatch, (tvit, jvit), '_create_vision_transformer', vit_names)
    assert tj == jj
    tj, jj = _captured_args(monkeypatch, (tdeit, jdeit), '_create_deit', deit_names)
    assert tj == jj


def _port_shape(key, shape):
    """(port name, port shape) of a JAX parameter, by the converter's rules
    (kernels transposed: 2-d and 3-d reversed, HWIO to OIHW)."""
    from timm_tpu_torch.models._jax_convert import _convert_leaf
    name, _ = _convert_leaf(key, np.zeros((1,) * len(shape), np.float32))
    if key.endswith('.kernel'):
        shape = tuple(shape[i] for i in ((3, 2, 0, 1) if len(shape) == 4 else
                                         tuple(range(len(shape)))[::-1]))
    return name, tuple(shape)


def test_every_entrypoint_builds_with_jax_parameter_count(jx):
    """Each of the 162 entrypoints builds on the meta device with JAX's
    parameter count. Outside blocks 1 and on, the port's parameters are
    JAX's at depth 1, name for name and shape for shape (by the converter's
    rules), and every further block has block 0's; so the full-depth count
    is JAX's depth-1 count plus a block's for each further block."""
    import timm_tpu.models.deit as jdeit
    import timm_tpu.models.vision_transformer as jvit
    names = _entrypoint_names(jvit.__file__) + _entrypoint_names(jdeit.__file__)
    for name in names:
        abstract = jx.nnx.eval_shape(lambda: jx.timm_tpu.create_model(name, depth=1))
        jshapes = dict(_port_shape('.'.join(map(str, k)), v.get_value().shape)
                       for k, v in jx.nnx.to_flat_state(jx.nnx.state(abstract, jx.nnx.Param)))
        port = timm_tpu_torch.create_model(name, device='meta')
        shapes = {k: tuple(p.shape) for k, p in port.named_parameters()}
        later = re.compile(r'^blocks\.([1-9]\d*)\.')
        assert {k: s for k, s in shapes.items() if not later.match(k)} == jshapes, name
        block0 = {k[len('blocks.0.'):]: s for k, s in jshapes.items() if k.startswith('blocks.0.')}
        for i in range(1, len(port.blocks)):
            assert {k[len(f'blocks.{i}.'):]: s for k, s in shapes.items()
                    if k.startswith(f'blocks.{i}.')} == block0, name
        per_block = sum(int(np.prod(s)) for s in block0.values())
        want = sum(int(np.prod(s)) for s in jshapes.values()) + (len(port.blocks) - 1) * per_block
        assert sum(p.numel() for p in port.parameters()) == want, name


# ---- one narrow model per construction ----------------------------------------------

_NARROW = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2, num_classes=5)
# (name, entrypoint whose construction it takes, its arguments at narrow width)
_CONSTRUCTIONS = [
    ('clip_pre_norm_quick_gelu', 'vit_base_patch32_clip_quickgelu_224', {}),
    ('siglip_map_gelu_tanh', 'vit_base_patch32_siglip_256', {}),
    ('rmsnorm_swiglu_embed_norm', 'aimv2_large_patch14_224', {}),
    ('parallel_scaling_qk_norm', 'vit_base_patch16_xp_224', dict(global_pool='avgmax')),
    ('parallel_things_max', 'vit_small_patch16_18x2_224', dict(global_pool='max')),
    ('res_post_block', 'vit_base_patch16_rpn_224', dict(init_values=0.5)),
    ('diff_parallel_scaling', 'vit_dpwee_patch16_reg1_gap_256', {}),
    ('swiglu_packed_silu', 'vit_giant_patch14_dinov2', {}),
    ('scale_norms', 'beit3_base_patch16_224', {}),
    ('qk_norm_map_reg', 'test_vit3', {}),
    ('no_pos_embed_no_final_norm', 'vit_base_patch16_224', dict(pos_embed='none', final_norm=False)),
    ('fix_init_fc_norm', 'vit_base_patch16_224', dict(fix_init=True, fc_norm=True, global_pool='avg')),
    ('deit_distilled', 'deit_tiny_distilled_patch16_224', {}),
    ('deit3_layer_scale', 'deit3_small_patch16_224', {}),
]


def _pair(jx, entry, dtype=None, seed=0, **kw):
    jm, values = jx.build(lambda: jx.timm_tpu.create_model(
        entry, dtype=None if dtype is None else getattr(jx.jnp, dtype), **kw), seed)
    tm = timm_tpu_torch.create_model(
        entry, device='cpu', dtype=None if dtype is None else getattr(torch, dtype), **kw).eval()
    load_jax_state_dict(tm, values)
    return jm, tm, values


@pytest.mark.parametrize('name,entry,extra', _CONSTRUCTIONS, ids=[c[0] for c in _CONSTRUCTIONS])
def test_construction_forward_and_gradients_match_jax(jx, name, entry, extra):
    """A narrow model of the construction (32 px, patch 8, width 32, two
    blocks) on the same seeded weights: logits and the gradients of every
    parameter (of sum(logits * w)) within 1e-5 of JAX's in fp32."""
    kw = dict(_NARROW, **extra)
    jm, tm, values = _pair(jx, entry, **kw)
    x = _x(1, (2, 32, 32, 3))
    w = _x(2, (2, 5))
    out, grads = jx.fwd_grad(jm, jx.jnp.asarray(x), jx.jnp.asarray(w))
    flat = {'.'.join(map(str, k)): np.asarray(v.get_value())
            for k, v in jx.nnx.to_flat_state(grads)}
    want = {k: v.numpy() for k, v in convert_jax_state_dict(flat).items()}
    got = tm(torch.from_numpy(x))
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), np.asarray(out))
    params = dict(tm.named_parameters())
    assert set(params) == set(want)
    for k, p in params.items():
        _close(p.grad.numpy(), want[k], tol=FP32_TOL)


def test_bf16_siglip_map_model_matches_jax(jx):
    """so400m's construction (no class token, 'map' pool, D 72 heads on the
    flash path's plain version, gelu_tanh-free MLP) in bf16 against JAX's
    bf16 on the same weights, and against its own fp32 (rel L2 2e-2)."""
    kw = dict(img_size=28, patch_size=14, embed_dim=144, depth=2, num_heads=2, num_classes=5)
    jm, tm, _ = _pair(jx, 'vit_so400m_patch14_siglip_224', dtype='bfloat16', **kw)
    x = _x(3, (2, 28, 28, 3))
    want = np.asarray(jx.fwd(jm, jx.jnp.asarray(x).astype(jx.jnp.bfloat16)).astype('float32'))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert tm.blocks[0].attn.head_dim == 72
    assert _rel_l2(got, want) <= BF16_REL_L2


def test_dynamic_img_size_and_pad_match_jax(jx):
    """dynamic_img_size with dynamic_img_pad: an image of another size (the
    position embedding resampled to its grid, the ragged edge padded) and
    forward_intermediates' grid, against JAX in fp32."""
    kw = dict(_NARROW, dynamic_img_size=True, dynamic_img_pad=True)
    jm, tm, _ = _pair(jx, 'vit_base_patch16_224', **kw)
    for size in ((32, 32), (44, 28)):
        x = _x(4, (2,) + size + (3,))
        want = np.asarray(jx.fwd(jm, jx.jnp.asarray(x)))
        with torch.no_grad():
            _close(tm(torch.from_numpy(x)).numpy(), want)
            inter = tm.forward_intermediates(torch.from_numpy(x), indices=1,
                                             intermediates_only=True)
        assert inter[0].shape == (2, -(-size[0] // 8), -(-size[1] // 8), 32)


def test_forward_intermediates_and_prune_match_jax(jx):
    """forward_intermediates at several indices, NHWC and NLC, with the
    prefix tokens and the final norm, and after prune_intermediate_layers,
    against JAX's; the features equal the blocks' outputs."""
    kw = dict(_NARROW, depth=3, reg_tokens=2)
    jm, tm, _ = _pair(jx, 'vit_base_patch16_224', **kw)
    x = _x(5, (2, 32, 32, 3))
    xj, xt = jx.jnp.asarray(x), torch.from_numpy(x)
    for args in (dict(indices=[0, 2]), dict(indices=2, norm=True, output_fmt='NLC'),
                 dict(indices=[-1], return_prefix_tokens=True, stop_early=True)):
        jfinal, jinter = jm.forward_intermediates(xj, **args)
        with torch.no_grad():
            tfinal, tinter = tm.forward_intermediates(xt, **args)
        _close(tfinal.numpy(), np.asarray(jfinal))
        flat_j = [np.asarray(a) for t in jinter for a in (t if isinstance(t, tuple) else (t,))]
        flat_t = [a.numpy() for t in tinter for a in (t if isinstance(t, tuple) else (t,))]
        for a, b in zip(flat_t, flat_j):
            _close(a, b)
    with torch.no_grad():
        blocks_out, h = [], tm._embed(xt, pad_tokens_to=0)[0]
        for blk in tm.blocks:
            h = blk(h)
            blocks_out.append(h)
        inter = tm.forward_intermediates(xt, indices=[0, 1, 2], output_fmt='NLC',
                                         intermediates_only=True)
    for a, b in zip(inter, blocks_out):
        assert torch.equal(a, b[:, 3:])
    assert tm.prune_intermediate_layers([0, 1]) == jm.prune_intermediate_layers([0, 1]) == [0, 1]
    assert len(tm.blocks) == 2 and tm.head is None
    with torch.no_grad():
        _close(tm(xt).numpy(), np.asarray(jx.fwd(jm, xj)))


@pytest.mark.parametrize('new_size', [(16, 16), (48, 40)], ids=['down', 'up'])
def test_set_input_size_resamples_pos_embed_as_jax(jx, new_size):
    """set_input_size resamples the learned position embedding with JAX's
    antialiased cubic weights (down and up), the prefix rows kept."""
    jm, tm, _ = _pair(jx, 'vit_base_patch16_224', **dict(_NARROW, reg_tokens=1))
    jm.set_input_size(img_size=new_size)
    tm.set_input_size(img_size=new_size)
    _close(tm.pos_embed.detach().numpy(), np.asarray(jm.pos_embed[...]))
    x = _x(6, (2,) + new_size + (3,))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), np.asarray(jx.fwd(jm, jx.jnp.asarray(x))))


def test_resample_abs_pos_embed_nhwc_matches_jax(jx):
    from timm_tpu.layers.pos_embed import resample_abs_pos_embed_nhwc as jresample
    from timm_tpu_torch.layers import resample_abs_pos_embed_nhwc
    grid = _x(7, (1, 7, 5, 8))
    want = np.asarray(jresample(jx.jnp.asarray(grid), (10, 3)))
    _close(resample_abs_pos_embed_nhwc(torch.from_numpy(grid), (10, 3)).numpy(), want)


# ---- layers -----------------------------------------------------------------------


def test_latent_pool_matches_jax_with_masks(jx):
    """AttentionPoolLatent (2 latent queries, qk-norm) against JAX's, with no
    mask, a (B, N) key-padding mask, and a SeqPadMask (its keys only)."""
    from timm_tpu.layers.attention_pool import AttentionPoolLatent as JPool
    from timm_tpu_torch.layers import AttentionPoolLatent, SeqPadMask
    kw = dict(num_heads=2, latent_len=2, qk_norm=True, pool_type='avg')
    jm, values = jx.build(lambda: JPool(24, rngs=jx.nnx.Rngs(0), **kw))
    tm = AttentionPoolLatent(24, **kw).eval()
    load_jax_state_dict(tm, values)
    x = _x(8, (3, 9, 24))
    valid = np.arange(9)[None, :] < np.array([[9], [5], [1]])
    want = np.asarray(jm(jx.jnp.asarray(x)))
    want_masked = np.asarray(jm(jx.jnp.asarray(x), attn_mask=jx.jnp.asarray(valid)))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), want)
        _close(tm(torch.from_numpy(x), attn_mask=torch.from_numpy(valid)).numpy(), want_masked)
        seqpad = SeqPadMask(torch.from_numpy(valid), True)
        _close(tm(torch.from_numpy(x), attn_mask=seqpad).numpy(), want_masked)


@pytest.mark.parametrize('cls', ['GluMlp', 'SwiGLU', 'SwiGLUPacked'])
def test_glu_mlps_match_jax(jx, cls):
    """GluMlp (sigmoid gate last), SwiGLU (with a norm) and SwiGLUPacked
    (silu gate first) against JAX's."""
    import timm_tpu.layers.mlp as jmlp
    import timm_tpu_torch.layers.mlp as tmlp
    from timm_tpu.layers import LayerNorm as JLN
    from timm_tpu_torch.layers import LayerNorm
    kw = dict(hidden_features=16, bias=(True, False))
    jkw, tkw = dict(kw), dict(kw)
    if cls == 'SwiGLU':
        jkw['norm_layer'], tkw['norm_layer'] = JLN, LayerNorm
    jm, values = jx.build(lambda: getattr(jmlp, cls)(12, rngs=jx.nnx.Rngs(0), **jkw))
    tm = getattr(tmlp, cls)(12, **tkw).eval()
    load_jax_state_dict(tm, values)
    x = _x(9, (2, 5, 12))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), np.asarray(jm(jx.jnp.asarray(x))))


@pytest.mark.parametrize('policy', ['softmax', 'norm'])
def test_precision_policy_matches_jax(jx, policy):
    """The bf16 softmax and norm-statistics knobs, set by a plain call and
    as a context manager, against JAX's under the same knob (bf16 2e-2),
    the default restored after; off, the fp32 path bit for bit."""
    import timm_tpu.layers.config as jcfg
    from timm_tpu_torch.layers import config as tcfg
    jset = getattr(jcfg, f'set_{policy}_dtype' if policy == 'softmax' else 'set_norm_internal_dtype')
    tset = getattr(tcfg, f'set_{policy}_dtype' if policy == 'softmax' else 'set_norm_internal_dtype')
    read = tcfg.softmax_dtype if policy == 'softmax' else tcfg.norm_internal_dtype
    jm, tm, _ = _pair(jx, 'vit_base_patch16_224', **_NARROW)
    x = _x(10, (2, 32, 32, 3), scale=3.0)
    with torch.no_grad():
        base = tm(torch.from_numpy(x)).numpy()
    with jset('bfloat16'):
        want = np.asarray(jm(jx.jnp.asarray(x)))
    with tset('bfloat16'):
        assert read() == torch.bfloat16
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
    assert read() is None
    tset('bf16')
    try:
        assert read() == torch.bfloat16
    finally:
        tset(None)
    assert _rel_l2(got, want) <= BF16_REL_L2 and not np.array_equal(got, base)
    with torch.no_grad():
        assert np.array_equal(tm(torch.from_numpy(x)).numpy(), base)


def test_patch_dropout_is_held_by_its_indices(jx, monkeypatch):
    """JAX's threefry keys cannot be reproduced (ROADMAP C): given JAX's
    keep indices (the port's index draw replaced by them) the port's output
    equals JAX's; the keep count is exact; the indices are a function of the
    generator's state; eval is the identity."""
    import timm_tpu_torch.layers.patch_dropout as tpd
    from timm_tpu.layers.patch_dropout import PatchDropout as JPD
    from timm_tpu_torch.layers import PatchDropout
    jpd = JPD(0.3, num_prefix_tokens=2, return_indices=True, rngs=jx.nnx.Rngs(dropout=3))
    x = _x(11, (3, 12, 4))
    jout, jidx = jpd(jx.jnp.asarray(x))
    pd = PatchDropout(0.3, num_prefix_tokens=2, return_indices=True,
                      generator=torch.Generator().manual_seed(0)).train()
    with monkeypatch.context() as m:
        m.setattr(tpd, 'patch_keep_indices', lambda *a: torch.from_numpy(np.array(jidx)))
        out, _ = pd(torch.from_numpy(x))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    pd.generator = torch.Generator().manual_seed(0)
    a, ia = pd(torch.from_numpy(x))
    assert ia.shape == (3, max(1, int(10 * 0.7))) and a.shape == (3, 2 + ia.shape[1], 4)
    assert torch.equal(a[:, :2], torch.from_numpy(x[:, :2]))
    pd.generator.manual_seed(0)
    assert torch.equal(pd(torch.from_numpy(x))[1], ia)
    assert not torch.equal(pd(torch.from_numpy(x))[1], ia)
    assert torch.equal(pd.eval()(torch.from_numpy(x))[0], torch.from_numpy(x))


def test_patch_dropout_model_trains_with_its_generator():
    """test_vit4 (dynamic size, patch dropout 0.25): a training forward
    keeps int(L 0.75) tokens, drawn from the model's generator."""
    m = timm_tpu_torch.create_model('test_vit4', device='cpu', seed=0, img_size=64).train()
    assert m.patch_drop.generator is not None
    x = torch.from_numpy(_x(12, (2, 48, 48, 3)))
    feats = m.forward_features(x)
    assert feats.shape == (2, 1 + int(9 * 0.75), 64)
    with torch.no_grad():
        assert m.eval().forward_features(x).shape == (2, 10, 64)


@pytest.mark.parametrize('name', ['gelu_tanh', 'quick_gelu'])
def test_vit_activations_match_jax(jx, name):
    from timm_tpu.layers.create_act import get_act_fn as jget
    from timm_tpu_torch.layers import get_act_fn
    x = np.linspace(-8, 8, 1001).astype(np.float32)
    want = np.asarray(jget(name)(jx.jnp.asarray(x)))
    _close(get_act_fn(name)(torch.from_numpy(x)).numpy(), want, tol=1e-6)


# ---- the flash kernel's plain version at the ViT family's shapes ------------------


def _attn_inputs(B, H, Nq, Nk, D, seed):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(s)).astype(np.float32)
            for s in ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D))]


@pytest.mark.parametrize('Nq,Nk,D', [(17, 17, 48), (17, 17, 72), (9, 9, 80), (9, 9, 88),
                                     (9, 9, 96), (1, 40, 72), (3, 20, 48)])
def test_flash_plain_version_matches_jax_sdpa(jx, Nq, Nk, D):
    """flash_attention (its plain version on the CPU) at the ViT family's
    head dims and at Nq != Nk, unmasked and key-padding masked, against
    JAX's _sdpa (fp32, 1e-5); its backward against JAX's autodiff of
    _sdpa."""
    from timm_tpu_torch.kernels import flash_attention
    q, k, v = _attn_inputs(2, 2, Nq, Nk, D, Nq * Nk + D)
    g = _x(13, q.shape)
    full = np.ones((2, 1, 1, Nk), bool)  # JAX takes it where the port takes no mask
    mask = (np.arange(Nk)[None, :] < np.array([[Nk], [max(1, Nk // 2)]]))[:, None, None, :]
    for m in (None, mask):
        want, jgrads = jx.sdpa_and_grads(*(jx.jnp.asarray(a) for a in (q, k, v)),
                                         jx.jnp.asarray(full if m is None else m),
                                         jx.jnp.asarray(g))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        got = flash_attention(tq, tk, tv, mask=None if m is None else torch.from_numpy(m))
        _close(got.detach().numpy(), np.asarray(want))
        got.backward(torch.from_numpy(g))
        for t, j in zip((tq, tk, tv), jgrads):
            _close(t.grad.numpy(), np.asarray(j))


def test_flash_wrapper_takes_head_dims_in_multiples_of_8():
    from timm_tpu_torch.kernels import KERNEL_HEAD_DIMS, kernel_head_dim
    assert [kernel_head_dim(d) for d in (8, 48, 72, 80, 88, 96, 104, 256)] == \
        [32, 48, 80, 80, 96, 96, 128, 256]
    assert kernel_head_dim(44) is None and kernel_head_dim(264) is None
    assert set(KERNEL_HEAD_DIMS) >= {32, 48, 64, 80, 96, 128, 256}


def _card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize('Nq,Nk,D', [(197, 197, 48), (257, 257, 72), (257, 257, 80),
                                     (100, 100, 88), (197, 197, 96), (1, 256, 72),
                                     (7, 300, 88)])
def test_kernel_matches_plain_at_vit_family_shapes_on_card(dtype, Nq, Nk, D):
    """The CUDA kernel against its plain version on the card at the ViT
    family's head dims (on their padded instances) and at Nq != Nk,
    unmasked and key-padding masked (a fully masked row included), within
    the registry's parity_tol and error_bound."""
    _card()
    from timm_tpu_torch.kernels import flash_attention, flash_attention_reference, registry
    spec = registry.get('flash_attention')
    g = torch.Generator(device='cuda').manual_seed(D + Nq)
    B, H = 3, 4
    q = torch.randn(B, H, Nq, D, generator=g, device='cuda').mul_(0.5).to(dtype)
    kv = torch.randn(B, Nk, 2, H, D, generator=g, device='cuda').mul_(0.5).to(dtype)
    k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)  # strided, as the pool's kv projection
    mask = (torch.arange(Nk, device='cuda')[None, :]
            < torch.tensor([Nk, Nk // 2, 0], device='cuda')[:, None]).view(B, 1, 1, Nk)
    for m in (None, mask):
        with torch.inference_mode():
            got = flash_attention(q, k, v, mask=m)
            want = flash_attention_reference(q, k, v, mask=m)
            torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs()
        assert float(diff.max()) <= spec.parity_tol
        bound = spec.error_bound(want, q=q, k=k, v=v, mask=m)
        assert float((diff / bound.double()).max()) <= 1.0
