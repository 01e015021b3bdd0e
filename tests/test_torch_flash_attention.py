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
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [37, 197, 576])
def test_plain_fully_masked_row_matches_jax_flash(jax_attention, n, dtype):
    """A batch row whose keys are all masked: the plain version gives the
    Pallas kernel's value (interpreted on the CPU), the sum of v over the N
    keys divided by round_up(N, block_k), and the other row matches too;
    within TOL (fp32 1e-5, bf16 2e-2: the two sum v in other orders)."""
    jnp, jax_flash, _ = jax_attention
    q, k, v, mask = _inputs(n, 2, 1, n, 32, valid=[0, n // 2])
    v = v + 1  # a mean far from 0, so sum / slots and the mean differ
    out = _to_np(flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
                                 mask=torch.from_numpy(mask)))
    ref = _to_np(jax_flash(*(jnp.asarray(a, dtype) for a in (q, k, v)), mask=jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, atol=TOL[dtype], rtol=0)
    block = min(512, max(128, 1 << (n - 1).bit_length()))
    slots = -(-n // block) * block
    np.testing.assert_allclose(out[0], np.broadcast_to(
        _to_np(torch.from_numpy(v[0]).to(getattr(torch, dtype))).sum(-2, keepdims=True) / slots,
        out[0].shape), atol=TOL[dtype], rtol=0)


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


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fused_qkv_views(B, N, H, D, dtype, seed, qk_scale=0.5, v_scale=0.5):
    """q, k, v as the strided (B, H, N, D) views of one fused (B, N, 3*H*D)
    projection, as the model's attention passes them: standard normal times
    ``qk_scale`` for q and k, times ``v_scale`` for v."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    qkv = torch.randn(B, N, 3, H * D, generator=g, device='cuda')
    qkv[:, :, :2] *= qk_scale
    qkv[:, :, 2] *= v_scale
    return qkv.to(dtype).view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)


def _plain(q, k, v, mask):
    """The plain version, which takes the key-padding mask as (B, 1, 1, N)."""
    if mask is not None:
        mask = mask.view(mask.shape[0], 1, 1, mask.shape[-1])
    return flash_attention_reference(q, k, v, mask=mask)


def _held_to_plain(q, k, v, mask, tol=2e-2):
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = _plain(q, k, v, mask)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, f'max abs err {err} > {tol}'
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('head_dim', [64, 256])
@pytest.mark.parametrize('n', [1, 37, 197, 200, 257, 577])
def test_kernel_ragged_n_and_masks_on_card(n, head_dim, dtype):
    """The 16-bit kernel against its plain version at ragged N (one key, a
    partial 8-key block, partial tiles, more than 512 keys), from strided
    views of one fused qkv projection, unmasked and with key-padding masks
    of several valid lengths per batch row, some ending inside an 8-key
    block."""
    _card_or_skip()
    B, H = 4, 3
    q, k, v = _fused_qkv_views(B, n, H, head_dim, dtype, seed=n + head_dim)
    assert not q.is_contiguous()
    valid = torch.tensor([n, max(1, n - 3), min(n, 13), min(n, 66)], device='cuda')
    mask = torch.arange(n, device='cuda')[None, :] < valid[:, None]
    for m in (None, mask, mask.view(B, 1, 1, n)):
        _held_to_plain(q, k, v, m)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_kernel_batch_one_on_card(dtype):
    """Batch 1 at ViT-B/16's shape (12 heads, N 197, D 64): the serving
    bucket whose grid is under one wave of blocks."""
    _card_or_skip()
    q, k, v = _fused_qkv_views(1, 197, 12, 64, dtype, seed=1)
    _held_to_plain(q, k, v, None)


# mantissa bits of each 16-bit type, its explicit ones plus the implicit one:
# rounding to it moves a value by at most 2^-bits of its magnitude
_PRECISION_BITS = {torch.bfloat16: 8, torch.float16: 11}


def _fp64_oracle(q, k, v, mask):
    """The kernel's function at its rounding points where they are exact
    (q * scale rounded to q's type), the rest in fp64: the output and the
    softmax-weighted |v| for each query row."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    s = (q * scale).double() @ k.double().transpose(-2, -1)
    if mask is not None:
        s = s.masked_fill(~mask.view(mask.shape[0], 1, 1, mask.shape[-1]), float('-inf'))
    p = torch.softmax(s, dim=-1)
    return p @ v.double(), p @ v.double().abs()


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('head_dim', [64, 128, 256])
@pytest.mark.parametrize('n', [37, 197, 577])
def test_kernel_sharp_scores_on_card(n, head_dim, dtype):
    """Scores spread over several units (q and k standard normal, then twice
    that: score std 1 and 4), so the running max changes from key tile to
    key tile and the alpha rescale of the sum and the accumulator carries
    the result. The plain version rounds the scores to the input type, which
    at such scores moves p by percents; so the kernel is held to an fp64
    oracle instead, within the bound its own roundings allow: p rounded to
    the input type moves the output by at most 2^-bits of the softmax-
    weighted |v|, the final rounding by 2^-bits of |o|, and 1e-4 covers
    ex2.approx, fp32 sums and fp16's subnormal p."""
    _card_or_skip()
    B, H = 4, 3
    valid = torch.tensor([n, max(1, n - 3), min(n, 13), min(n, 66)], device='cuda')
    key_mask = torch.arange(n, device='cuda')[None, :] < valid[:, None]
    for qk_scale in (1.0, 2.0):
        q, k, v = _fused_qkv_views(B, n, H, head_dim, dtype, seed=7 * n + head_dim,
                                   qk_scale=qk_scale, v_scale=1.0)
        for mask in (None, key_mask):
            out = flash_attention(q, k, v, mask=mask)
            torch.cuda.synchronize()
            o, pv_abs = _fp64_oracle(q, k, v, mask)
            bound = 2.0 ** -_PRECISION_BITS[dtype] * (pv_abs + o.abs()) + 1e-4
            excess = ((out.double() - o).abs() / bound).max().item()
            assert excess <= 1.0, (f'qk_scale {qk_scale}, masked {mask is not None}: '
                                   f'error {excess:.3f} times its bound')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize('n', [37, 128, 197])
def test_kernel_fully_masked_row_on_card(n, dtype):
    """A batch row whose keys are all masked comes out finite and as the
    TPU kernel gives it: the sum of v over the N keys divided by
    round_up(N, block_k), block_k = min(512, max(128, next_pow2(N)));
    the plain version gives the same, and the other rows match it too."""
    _card_or_skip()
    B, H, D = 3, 2, 64
    q, k, v = _fused_qkv_views(B, n, H, D, dtype, seed=3 * n)
    v = v + 1  # a mean far from 0, so sum / slots and the mean differ
    mask = torch.ones(B, n, dtype=torch.bool, device='cuda')
    mask[1] = False
    mask[2, n // 2:] = False
    out = flash_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    block = min(512, max(128, 1 << (n - 1).bit_length()))
    slots = -(-n // block) * block
    expected = v[1].float().sum(dim=-2, keepdim=True) / slots  # (H, 1, D)
    tol = 2e-2 if dtype != torch.float32 else 1e-5
    err = (out[1].float() - expected).abs().max().item()
    assert err <= tol, f'fully masked row: max abs err {err}'
    ref = _plain(q, k, v, mask)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, f'max abs err {err}'
