"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs its plain version; it is held against
the JAX ``flash_attention`` (the Pallas kernel, interpreted on the CPU) and
the JAX ``_sdpa``, on the same numpy inputs. The CUDA kernel itself is held
against the plain version by the ``gpu``-marked test, which skips without a
card. JAX is imported inside the fixtures, so that ``pytest -m gpu`` also
collects this file on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from timm_tpu_torch.kernels import KERNEL_HEAD_DIMS, flash_attention, flash_attention_reference
from timm_tpu_torch.kernels._build import NVCC_FLAGS, _digest, nvcc_command

TOL = {'float32': 1e-5, 'bfloat16': 2e-2}


def _inputs(seed, B, H, N, D, valid=None):
    """q, k, v as float32 numpy; ``valid``: per-row count of valid keys."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, N, D)).astype(np.float32) * 0.5 for _ in range(3))
    mask = None if valid is None else np.arange(N)[None, :] < np.asarray(valid)[:, None]
    return q, k, v, mask


@pytest.fixture(scope='module')
def jax_attention():
    import jax.numpy as jnp

    from timm_tpu.kernels.flash_attention import flash_attention as jax_flash
    from timm_tpu.layers.attention import _sdpa as jax_sdpa
    return jnp, jax_flash, jax_sdpa


def _to_np(x):
    return np.asarray(x.astype('float32')) if hasattr(x, 'astype') else x.float().numpy()


# (B, H, N, D, valid keys per batch row or None, mask layout)
CASES = {
    'unmasked_n37_d32': (2, 2, 37, 32, None, None),
    'unmasked_n37_d64': (2, 2, 37, 64, None, None),
    'masked_bn_d64': (2, 2, 37, 64, [30, 37], 'bn'),
    'masked_b11n_d32': (2, 2, 40, 32, [17, 33], 'b11n'),
}


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', list(CASES))
def test_plain_matches_jax_flash_and_sdpa(jax_attention, case, dtype):
    jnp, jax_flash, jax_sdpa = jax_attention
    B, H, N, D, valid, layout = CASES[case]
    q, k, v, mask = _inputs(list(CASES).index(case), B, H, N, D, valid)
    if layout == 'b11n':
        mask = mask[:, None, None, :]
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)

    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, mask=tmask)
    assert flash_attention.launches == before, 'a CPU call must not count as a kernel launch'
    assert out.dtype == tq.dtype and tuple(out.shape) == (B, H, N, D)
    out = _to_np(out)

    ref_flash = _to_np(jax_flash(jq, jk, jv, mask=jmask))
    sdpa_mask = None if jmask is None else (jmask if jmask.ndim == 4 else jmask[:, None, None, :])
    ref_sdpa = _to_np(jax_sdpa(jq, jk, jv, attn_mask=sdpa_mask))
    np.testing.assert_allclose(out, ref_flash, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(out, ref_sdpa, atol=TOL[dtype], rtol=0)


def test_float_mask_rejected_like_jax(jax_attention):
    jnp, jax_flash, _ = jax_attention
    q, k, v, _ = _inputs(0, 2, 2, 16, 32)
    additive = np.zeros((2, 1, 1, 16), np.float32)
    with pytest.raises(ValueError, match='bool key-padding'):
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(additive))
    with pytest.raises(ValueError, match='bool key-padding'):
        flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(additive))


def test_per_query_mask_rejected_like_jax(jax_attention):
    jnp, jax_flash, _ = jax_attention
    q, k, v, _ = _inputs(1, 2, 2, 16, 32)
    per_query = np.ones((2, 1, 16, 16), bool)
    with pytest.raises(ValueError, match='key-padding masks of shape'):
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), mask=jnp.asarray(per_query))
    with pytest.raises(ValueError, match='key-padding masks of shape'):
        flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), mask=torch.from_numpy(per_query))


def test_wrapper_rejects_gqa_wide_heads_and_grad():
    q, k, v, _ = _inputs(2, 2, 4, 16, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    with pytest.raises(ValueError, match='multi-head attention only'):
        flash_attention(tq, tk[:, :2], tv[:, :2])  # grouped-query shapes
    wide = torch.zeros(1, 1, 8, 512)
    with pytest.raises(ValueError, match='up to 256'):
        flash_attention(wide, wide, wide)
    # inputs that require grad are taken: the wrapper is an autograd.Function
    out = flash_attention(tq.requires_grad_(True), tk, tv)
    assert out.grad_fn is not None
    out.sum().backward()
    assert tq.grad.shape == tq.shape


def test_build_targets_sm90a_and_rehashes_on_edit(tmp_path):
    cmd = nvcc_command('nvcc', tmp_path / 'k.cu', tmp_path / 'k.so')
    assert 'arch=compute_90a,code=sm_90a' in cmd and '-shared' in cmd
    assert cmd[-1].endswith('k.cu') and cmd[cmd.index('-o') + 1].endswith('k.so')
    assert set(NVCC_FLAGS) >= {'-O3', '-Xptxas', '-v'}
    src = tmp_path / 'k.cu'
    src.write_text('// a\n')
    first = _digest(src)
    src.write_text('// b\n')
    assert _digest(src) != first


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize('head_dim', KERNEL_HEAD_DIMS)
def test_kernel_matches_plain_on_card(dtype, head_dim):
    """The CUDA kernel against its plain version on the card, unmasked and
    key-padding masked, from strided qkv views as the model passes them."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(head_dim)
    B, H, N = 3, 4, 197
    qkv = torch.randn(B, N, 3, H, head_dim, generator=g, device='cuda').mul_(0.5).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    mask = (torch.arange(N, device='cuda')[None, :]
            < torch.tensor([N, 150, 1], device='cuda')[:, None]).view(B, 1, 1, N)
    tol = 2e-2 if dtype != torch.float32 else 1e-5
    for m in (None, mask):
        before = flash_attention.launches
        out = flash_attention(q, k, v, mask=m)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_reference(q, k, v, mask=m)
        assert out.dtype == dtype and out.shape == q.shape
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, f'max abs err {err} > {tol}'
