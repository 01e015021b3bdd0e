"""ViT of the PyTorch port against the JAX package on the CPU: the golden
fixture, fp32 and bf16 parity on carried weights, the token pad, weight-carry
strictness, the registry, and the rule that the port imports no JAX.

Models stay small (test_vit at 160 px, vit_tiny_patch16_224 at 64 px). JAX
is imported inside the fixtures.
"""
import ast
import os

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.models import convert_jax_state_dict, load_jax_state_dict
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLDEN = os.path.join(REPO_ROOT, 'tests', 'fixtures', 'vit_tiny_img64_golden.npz')


@pytest.fixture(scope='module')
def jx():
    import types

    import jax
    import jax.numpy as jnp

    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict
    return types.SimpleNamespace(jax=jax, jnp=jnp, create=timm_tpu.create_model,
                                 state=model_state_dict)


def _pair(jx, name, jax_dtype=None, torch_dtype=None, **kw):
    """A JAX model and the port's model carrying its weights (eval mode)."""
    jm = jx.create(name, dtype=jax_dtype, **kw)
    jm.eval()
    tm = timm_tpu_torch.create_model(name, device='cpu', dtype=torch_dtype, **kw).eval()
    load_jax_state_dict(tm, jx.state(jm))
    return jm, tm


def _images(seed, n, size):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@torch.no_grad()
def _t(model, x, fn='forward'):
    return getattr(model, fn)(torch.from_numpy(x)).float().numpy()


def _j(jx, model, x, fn='__call__'):
    return np.asarray(getattr(model, fn)(jx.jnp.asarray(x)).astype('float32'))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_reproduces_vit_tiny_golden_fixture(jx):
    """The fixture was recorded from create_model('vit_tiny_patch16_224',
    img_size=64) with JAX's non-partitionable threefry key derivation, so
    the JAX weights are drawn under that setting and carried over. 1e-4:
    the two CPU backends sum in different orders over 12 blocks."""
    g = np.load(_GOLDEN)
    with jx.jax.threefry_partitionable(False):
        jm = jx.create('vit_tiny_patch16_224', img_size=64)
    tm = timm_tpu_torch.create_model('vit_tiny_patch16_224', img_size=64, device='cpu').eval()
    load_jax_state_dict(tm, jx.state(jm))
    feats = _t(tm, g['x'], 'forward_features')
    logits = _t(tm, g['x'])
    assert feats.shape == (2, 17, 192) and logits.shape == (2, 1000)
    np.testing.assert_allclose(feats, g['feats'], atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits, g['logits'], atol=1e-4, rtol=0)


@pytest.mark.parametrize('name', ['test_vit', 'test_vit2'])
def test_fp32_parity(jx, name):
    jm, tm = _pair(jx, name)
    x = _images(0, 2, 160)
    np.testing.assert_allclose(_t(tm, x, 'forward_features'), _j(jx, jm, x, 'forward_features'),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_t(tm, x), _j(jx, jm, x), atol=1e-5, rtol=0)


@pytest.mark.parametrize('name,size', [('test_vit', 160), ('vit_tiny_patch16_224', 64)])
def test_pad_tokens_to_256_parity(jx, name, size):
    """The token pad threads a (B, 1, 1, 256) key-padding mask through every
    block; against the JAX model with the same pad, and against no pad."""
    jm, tm = _pair(jx, name, img_size=size, pad_tokens_to=256)
    x = _images(1, 2, size)
    padded = _t(tm, x)
    np.testing.assert_allclose(padded, _j(jx, jm, x), atol=1e-5, rtol=0)
    tm.pad_tokens_to = None
    np.testing.assert_allclose(padded, _t(tm, x), atol=1e-5, rtol=0)


@pytest.mark.parametrize('name,size', [('test_vit', 160), ('vit_tiny_patch16_224', 64)])
def test_bf16_parity(jx, name, size):
    """bf16 compute against JAX bf16 (relative L2 <= 2e-2), with the JAX
    model's casts: bf16 logits, fp32 features out of the final norm."""
    jm, tm = _pair(jx, name, jax_dtype=jx.jnp.bfloat16, torch_dtype=torch.bfloat16, img_size=size)
    x = _images(2, 2, size)
    with torch.no_grad():
        t_logits = tm(torch.from_numpy(x))
        t_feats = tm.forward_features(torch.from_numpy(x))
    j_logits = jm(jx.jnp.asarray(x))
    j_feats = jm.forward_features(jx.jnp.asarray(x))
    assert t_logits.dtype == torch.bfloat16 and str(j_logits.dtype) == 'bfloat16'
    assert t_feats.dtype == torch.float32 and str(j_feats.dtype) == 'float32'
    assert _rel(t_logits.float().numpy(), np.asarray(j_logits.astype('float32'))) <= 2e-2
    assert _rel(t_feats.numpy(), np.asarray(j_feats)) <= 2e-2


def test_weight_carry_is_strict(jx):
    """Every key of the JAX state dict is used, and a missing, unexpected or
    misshaped key raises."""
    jm = jx.create('test_vit2')
    flat = jx.state(jm)
    tm = timm_tpu_torch.create_model('test_vit2', device='cpu')
    converted = convert_jax_state_dict(flat)
    assert set(converted) == set(tm.state_dict())
    assert converted['patch_embed.proj.weight'].shape == (64, 3, 16, 16)  # HWIO -> OIHW
    np.testing.assert_array_equal(converted['head.weight'].numpy(), flat['head.kernel'].T)
    np.testing.assert_array_equal(converted['fc_norm.weight'].numpy(), flat['fc_norm.scale'])
    load_jax_state_dict(tm, flat)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), converted[k].numpy())
    missing = dict(flat)
    missing.pop('blocks.1.ls2.gamma')
    with pytest.raises(RuntimeError, match='Missing'):
        load_jax_state_dict(tm, missing)
    with pytest.raises(RuntimeError, match='Unexpected'):
        load_jax_state_dict(tm, dict(flat, extra_token=np.zeros(3, np.float32)))
    with pytest.raises(RuntimeError, match='size mismatch'):
        load_jax_state_dict(tm, dict(flat, pos_embed=np.zeros((1, 5, 64), np.float32)))


def test_registry_and_classifier_contract():
    assert timm_tpu_torch.list_models('vit_*') == [
        'vit_base_patch16_224', 'vit_dlittle_patch16_reg1_gap_256', 'vit_dwee_patch16_reg1_gap_256',
        'vit_little_patch16_reg4_gap_256', 'vit_tiny_patch16_224', 'vit_wee_patch16_reg1_gap_256']
    # resnetv2 is not ported yet (resnet50 is, since the ResNet slice)
    assert timm_tpu_torch.is_model('test_vit.r160_in1k') and not timm_tpu_torch.is_model(
        'resnetv2_50')
    with pytest.raises(RuntimeError, match='Unknown model'):
        timm_tpu_torch.create_model('resnetv2_50', device='cpu')
    m = timm_tpu_torch.create_model('test_vit', num_classes=7, device='cpu')
    assert m.default_cfg['input_size'] == (3, 160, 160) and m.get_classifier().out_features == 7
    m.reset_classifier(0)
    with torch.no_grad():
        assert m(torch.zeros(1, 160, 160, 3)).shape == (1, 64)
    a = timm_tpu_torch.create_model('test_vit', seed=3, device='cpu').state_dict()
    b = timm_tpu_torch.create_model('test_vit', seed=3, device='cpu').state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_entry_points_default_to_cuda():
    """Without device='cpu' the entry points ask for a card and raise where
    there is none; they never carry on on the CPU."""
    if torch.cuda.is_available():
        m = timm_tpu_torch.create_model('test_vit')
        assert next(m.parameters()).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timm_tpu_torch.create_model('test_vit')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timm_tpu_torch.InferenceEngine(buckets=(1,))


_FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'timm_tpu')


def _forbidden_imports(source: str):
    """Absolute imports of JAX or of the JAX package in ``source``. A module
    is matched by its first dotted part, so ``timm_tpu`` and ``timm_tpu.x``
    are caught and ``timm_tpu_torch`` is not."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        bad += [n for n in names if n.split('.')[0] in _FORBIDDEN]
    return bad


def test_import_check_catches_the_prefix_case():
    planted = ('import jax.numpy as jnp\nfrom timm_tpu.layers import x\nimport timm_tpu\n'
               'from timm_tpu_torch.layers import y\nimport timm_tpu_torch\nfrom . import z\n'
               'def f():\n    from flax import nnx\n')
    assert _forbidden_imports(planted) == ['jax.numpy', 'timm_tpu.layers', 'timm_tpu', 'flax']


def test_port_imports_no_jax():
    files = [os.path.join(REPO_ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(REPO_ROOT, 'timm_tpu_torch')):
        files += [os.path.join(dirpath, n) for n in names if n.endswith('.py')]
    assert len(files) > 20
    scanned = {os.path.relpath(os.path.dirname(f), REPO_ROOT) for f in files}
    for sub in ('data', 'kernels', 'layers', 'loss', 'models', 'optim', 'resilience', 'scheduler',
                'serve', 'task', 'utils'):
        assert os.path.join('timm_tpu_torch', sub) in scanned, sub
    offenders = {}
    for f in files:
        with open(f, encoding='utf-8') as fh:
            bad = _forbidden_imports(fh.read())
        if bad:
            offenders[os.path.relpath(f, REPO_ROOT)] = bad
    assert not offenders, offenders


@pytest.mark.gpu
def test_vit_on_card_matches_cpu():
    """The same seeded weights on the card (through the kernel) and on the
    CPU (plain path): fp32 to 1e-4 with TF32 off, bf16 to 2e-2 relative, and
    one kernel launch per block."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(_images(3, 2, 160))
    cpu = timm_tpu_torch.create_model('test_vit', device='cpu').eval()
    card = timm_tpu_torch.create_model('test_vit', device='cuda').eval()
    card_bf16 = timm_tpu_torch.create_model('test_vit', device='cuda', dtype=torch.bfloat16).eval()
    with torch.inference_mode():
        ref = cpu(x).numpy()
        before = flash_attention.launches
        out = card(x.cuda()).cpu().numpy()
        assert flash_attention.launches == before + len(card.blocks)
        out_bf16 = card_bf16(x.cuda()).float().cpu().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    assert _rel(out_bf16, ref) <= 2e-2
