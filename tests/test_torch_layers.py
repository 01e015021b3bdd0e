"""Layer parity of the PyTorch port against the JAX package on the CPU.

Each JAX layer is built, its parameters are perturbed from a numpy seed and
carried into the port's layer with ``load_jax_state_dict``; the same numpy
input goes through both. fp32 parity is held to 1e-5 (the two CPU backends
sum in different orders). JAX is imported inside the fixtures.
"""
import numpy as np
import pytest
import torch

from timm_tpu_torch.layers import (
    Attention, DropPath, Dropout, LayerNorm, LayerScale, Mlp, PatchEmbed, gelu,
    global_pool_nlc, softmax_with_policy,
)
from timm_tpu_torch.models import load_jax_state_dict
from timm_tpu_torch.models.vision_transformer import Block

ATOL = 1e-5


@pytest.fixture(scope='module')
def jx():
    """The JAX side: jnp, nnx and the JAX package's layers."""
    import types

    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu.layers as jl
    from timm_tpu.models import vision_transformer as jvit
    from timm_tpu.models._helpers import load_state_dict_into_model, model_state_dict
    return types.SimpleNamespace(jnp=jnp, nnx=nnx, layers=jl, Block=jvit.Block,
                                 load=load_state_dict_into_model, state=model_state_dict)


def _carry(jx, jax_module, torch_module, seed):
    """Perturb the JAX module's parameters from ``seed`` and load the same
    values into both modules."""
    rng = np.random.default_rng(seed)
    sd = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in jx.state(jax_module).items()}
    jx.load(jax_module, sd)
    load_jax_state_dict(torch_module, sd)
    return torch_module.eval()


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _run(jx, module, x, **kw):
    return np.asarray(module(jx.jnp.asarray(x), **kw).astype('float32'))


@torch.no_grad()
def _trun(module, x, **kw):
    return module(torch.from_numpy(x), **kw).float().numpy()


def test_layernorm_parity(jx):
    jm = jx.layers.LayerNorm(48, rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, LayerNorm(48), 0)
    x = _x(1, 2, 7, 48) * 3 + 1
    np.testing.assert_allclose(_trun(tm, x), _run(jx, jm, x), atol=ATOL, rtol=0)


@pytest.mark.parametrize('module_dtype', ['bfloat16', None])
def test_layernorm_bf16_dtype_rules(jx, module_dtype):
    """bf16 input: a bf16 ``dtype`` returns bf16; no dtype promotes to fp32
    with the fp32 parameters, as flax does."""
    jdt = None if module_dtype is None else jx.jnp.bfloat16
    tdt = None if module_dtype is None else torch.bfloat16
    jm = jx.layers.LayerNorm(48, dtype=jdt, rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, LayerNorm(48, dtype=tdt), 2)
    x = _x(3, 2, 7, 48)
    jout = jm(jx.jnp.asarray(x, jx.jnp.bfloat16))
    with torch.no_grad():
        tout = tm(torch.from_numpy(x).to(torch.bfloat16))
    assert str(tout.dtype).split('.')[-1] == str(jout.dtype)
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout.astype('float32')),
                               atol=2e-2, rtol=0)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gelu_parity(jx, dtype):
    from timm_tpu.layers.create_act import gelu as jax_gelu
    x = _x(4, 3, 65) * 4
    out = gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    ref = jax_gelu(jx.jnp.asarray(x, dtype))
    assert out.dtype == getattr(torch, dtype)
    tol = ATOL if dtype == 'float32' else 2e-2
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype('float32')), atol=tol, rtol=0)


def test_mlp_parity(jx):
    jm = jx.layers.Mlp(32, hidden_features=96, rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, Mlp(32, hidden_features=96), 5)
    x = _x(6, 2, 9, 32)
    np.testing.assert_allclose(_trun(tm, x), _run(jx, jm, x), atol=ATOL, rtol=0)


def test_patch_embed_parity(jx):
    """NHWC images in, (B, N, C) tokens out; the conv weight goes HWIO -> OIHW."""
    jm = jx.layers.PatchEmbed(img_size=32, patch_size=8, in_chans=3, embed_dim=48,
                              rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, PatchEmbed(img_size=32, patch_size=8, in_chans=3, embed_dim=48), 7)
    x = _x(8, 2, 32, 32, 3)
    out = _trun(tm, x)
    assert out.shape == (2, 16, 48)
    np.testing.assert_allclose(out, _run(jx, jm, x), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match='Input size'):
        tm(torch.zeros(1, 16, 16, 3))


@pytest.mark.parametrize('masked', [False, True])
def test_attention_parity(jx, masked):
    jm = jx.layers.Attention(64, num_heads=2, qkv_bias=True, rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, Attention(64, num_heads=2, qkv_bias=True), 9)
    x = _x(10, 2, 13, 64)
    mask = None
    if masked:
        mask = np.broadcast_to(np.arange(13)[None, None, None, :] < 9, (2, 1, 1, 13))
    jout = _run(jx, jm, x, attn_mask=None if mask is None else jx.jnp.asarray(mask))
    tout = _trun(tm, x, attn_mask=None if mask is None else torch.from_numpy(mask.copy()))
    np.testing.assert_allclose(tout, jout, atol=ATOL, rtol=0)


def test_block_parity(jx):
    jm = jx.Block(64, num_heads=2, mlp_ratio=3, qkv_bias=True, init_values=0.5, rngs=jx.nnx.Rngs(0))
    tm = _carry(jx, jm, Block(64, num_heads=2, mlp_ratio=3, qkv_bias=True, init_values=0.5), 11)
    x = _x(12, 2, 17, 64)
    np.testing.assert_allclose(_trun(tm, x), _run(jx, jm, x), atol=ATOL, rtol=0)


@pytest.mark.parametrize('pool_type', ['token', 'avg', 'max', 'avgmax'])
@pytest.mark.parametrize('masked', [False, True])
def test_global_pool_nlc_parity(jx, pool_type, masked):
    x = _x(13, 3, 11, 8)
    mask = None
    if masked:
        mask = (np.arange(11)[None, :] < np.array([11, 6, 3])[:, None])[:, None, None, :]
    ref = jx.layers.global_pool_nlc(jx.jnp.asarray(x), pool_type=pool_type, num_prefix_tokens=1,
                                    mask=None if mask is None else jx.jnp.asarray(mask))
    out = global_pool_nlc(torch.from_numpy(x), pool_type=pool_type, num_prefix_tokens=1,
                          mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_softmax_policy_is_fp32(jx):
    x = _x(14, 4, 8, 33) * 8
    out = softmax_with_policy(torch.from_numpy(x).to(torch.bfloat16))
    ref = jx.layers.softmax_with_policy(jx.jnp.asarray(x, jx.jnp.bfloat16))
    assert out.dtype == torch.float32 and str(ref.dtype) == 'float32'
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_regularizers_are_identity_in_eval():
    x = torch.from_numpy(_x(15, 4, 5, 8))
    dp, do = DropPath(0.5).eval(), Dropout(0.5).eval()
    assert torch.equal(dp(x), x) and torch.equal(do(x), x)
    drop = DropPath(0.5, generator=torch.Generator().manual_seed(0)).train()
    assert not torch.equal(drop(torch.ones(64, 1, 1)), torch.ones(64, 1, 1))
    ls = LayerScale(8, init_values=0.25)
    assert torch.allclose(ls(x), x * 0.25)


@pytest.mark.gpu
def test_dispatcher_on_card_takes_the_kernel_or_raises():
    """On CUDA tensors every attention goes to the flash kernel; a call
    outside its contract raises instead of taking a plain path."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import flash_attention
    from timm_tpu_torch.layers import scaled_dot_product_attention
    q = torch.randn(2, 2, 37, 64, device='cuda').to(torch.bfloat16)
    before = flash_attention.launches
    with torch.inference_mode():
        scaled_dot_product_attention(q, q, q)
        scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(2, 37, dtype=torch.bool, device='cuda'))
    assert flash_attention.launches == before + 2
    with pytest.raises(NotImplementedError, match='dropout'):
        scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match='additive'):
        scaled_dot_product_attention(q, q, q, attn_mask=torch.zeros(2, 1, 1, 37, device='cuda'))
    with pytest.raises(NotImplementedError, match='mask of shape'):
        scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(2, 1, 37, 37, dtype=torch.bool,
                                                                   device='cuda'))
    odd = torch.randn(2, 2, 37, 48, device='cuda').to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match='head dims'):
        scaled_dot_product_attention(odd, odd, odd)
