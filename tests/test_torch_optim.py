"""Optimizer, loss, clipping, EMA and schedule of the PyTorch port against
the JAX package on the CPU.

The plain version of the fused AdamW + EMA update is held against JAX's
optax chain (``unfused_adamw_reference``) and the Pallas kernel run
interpreted (``fused_adamw_apply``), on the JAX registry's dry leaf sizes
with a mixed decay mask, for fp32 and bf16 first moments, with and without
the EMA, over 3 steps. The CUDA kernel itself is held against the plain
version by the ``gpu``-marked test, which skips without a card. JAX is
imported inside the fixtures.
"""
import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.kernels import fused_adamw, fused_adamw_reference
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy, SoftTargetCrossEntropy, cross_entropy
from timm_tpu_torch.models import load_jax_state_dict
from timm_tpu_torch.optim import create_optimizer_v2, param_groups_weight_decay
from timm_tpu_torch.scheduler import create_scheduler_v2
from timm_tpu_torch.utils import ModelEmaV3, clip_grad_norm, ema_update
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZES = ((64, 256), (256,), (8, 8, 32))  # the JAX registry's dry case
DECAY = (True, False, True)              # a mixed weight-decay mask
HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05)
LR, EMA_DECAY = 0.02, 0.999


@pytest.fixture(scope='module')
def jx():
    import functools
    import types

    import jax
    import jax.numpy as jnp

    from timm_tpu.kernels import fused_adamw as jfa

    def oracle(fn, mu_bf16, with_ema):
        static = dict(HP, mu_dtype=jnp.bfloat16 if mu_bf16 else None,
                      wd_mask={f'leaf{i}': d for i, d in enumerate(DECAY)})
        return jax.jit(functools.partial(fn, **static)) if with_ema else \
            jax.jit(lambda p, g, m, v, e, c, lr, d: fn(p, g, m, v, None, c, lr, d, **static))

    cache = {}

    def get(name, mu_bf16, with_ema):
        key = (name, mu_bf16, with_ema)
        if key not in cache:
            fn = jfa.unfused_adamw_reference if name == 'optax' else jfa.fused_adamw_apply
            cache[key] = oracle(fn, mu_bf16, with_ema)
        return cache[key]

    return types.SimpleNamespace(jax=jax, jnp=jnp, oracle=get)


def _state(seed, mu_bf16):
    """Leaves of params, grads per step, m, v and ema as numpy, from a seed."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return [(rng.standard_normal(s) * scale).astype(np.float32) for s in SIZES]

    st = dict(p=tree(1.0), m=tree(0.01), v=[np.abs(x) * 1e-3 for x in tree(0.1)], e=tree(1.0),
              grads=[tree(0.1) for _ in range(3)])
    if mu_bf16:  # start from bf16-representable moments in both packages
        st['m'] = [torch.from_numpy(x).bfloat16().float().numpy() for x in st['m']]
    return st


def _flatten(leaves, dtype=torch.float32):
    """Flat port buffer: decayed leaves first, each padded to 4 elements."""
    order = [i for i in range(len(SIZES)) if DECAY[i]] + [i for i in range(len(SIZES)) if not DECAY[i]]
    parts, slots, off, n_decay = [], {}, 0, 0
    for i in order:
        a = torch.from_numpy(np.ascontiguousarray(leaves[i]).ravel())
        pad = -a.numel() % 4
        parts.append(torch.cat([a, torch.zeros(pad)]))
        slots[i] = (off, a.numel())
        off += a.numel() + pad
        if DECAY[i]:
            n_decay = off
    return torch.cat(parts).to(dtype), slots, n_decay


def _unflatten(flat, slots):
    return [flat[slots[i][0]:slots[i][0] + slots[i][1]].float().numpy().reshape(SIZES[i])
            for i in range(len(SIZES))]


def _run_port(st, mu_bf16, with_ema, steps=3):
    p, slots, n_decay = _flatten(st['p'])
    m, _, _ = _flatten(st['m'], torch.bfloat16 if mu_bf16 else torch.float32)
    v, _, _ = _flatten(st['v'])
    e = _flatten(st['e'])[0] if with_ema else None
    count = torch.zeros((), dtype=torch.int32)
    for s in range(steps):
        g, _, _ = _flatten(st['grads'][s])
        fused_adamw(p, g, m, v, e, count, lr=LR, n_decay=n_decay, ema_decay=EMA_DECAY, **HP)
    out = dict(p=_unflatten(p, slots), m=_unflatten(m, slots), v=_unflatten(v, slots),
               count=int(count))
    if with_ema:
        out['e'] = _unflatten(e, slots)
    return out


def _run_jax(jx, name, st, mu_bf16, with_ema, steps=3, lrs=(LR,) * 3, decays=(EMA_DECAY,) * 3):
    jnp = jx.jnp
    fn = jx.oracle(name, mu_bf16, with_ema)

    def tree(leaves, dtype=jnp.float32):
        return {f'leaf{i}': jnp.asarray(x, dtype) for i, x in enumerate(leaves)}

    p, m, v = tree(st['p']), tree(st['m'], jnp.bfloat16 if mu_bf16 else jnp.float32), tree(st['v'])
    e = tree(st['e']) if with_ema else None
    for s in range(steps):
        p, m, v, e = fn(p, tree(st['grads'][s]), m, v, e, jnp.asarray(s, jnp.int32),
                        jnp.asarray(lrs[s], jnp.float32), jnp.asarray(decays[s], jnp.float32))
    leaves = lambda t: [np.asarray(t[f'leaf{i}'].astype(jnp.float32)) for i in range(len(SIZES))]  # noqa: E731
    out = dict(p=leaves(p), m=leaves(m), v=leaves(v))
    if with_ema:
        out['e'] = leaves(e)
    return out


@pytest.mark.parametrize('with_ema', [True, False], ids=['ema', 'no_ema'])
@pytest.mark.parametrize('mu_bf16', [False, True], ids=['mu_fp32', 'mu_bf16'])
@pytest.mark.parametrize('oracle', ['optax', 'pallas_interpret'])
def test_plain_fused_adamw_matches_jax(jx, oracle, mu_bf16, with_ema):
    """3 updates from one state: p, m, v and ema within 1e-6 max abs (the
    JAX registry's parity_tol)."""
    st = _state(0, mu_bf16)
    before = fused_adamw.launches
    port = _run_port(st, mu_bf16, with_ema)
    assert fused_adamw.launches == before, 'a CPU call must not count as a kernel launch'
    assert port['count'] == 3
    ref = _run_jax(jx, oracle, st, mu_bf16, with_ema)
    for k in ref:
        for a, b in zip(port[k], ref[k]):
            assert float(np.abs(a - b).max()) <= 1e-6, k


@pytest.mark.parametrize('mu_bf16', [False, True], ids=['mu_fp32', 'mu_bf16'])
@pytest.mark.parametrize('oracle', ['optax', 'pallas_interpret'])
def test_plain_fused_adamw_reads_lr_and_decay_from_tensors(jx, oracle, mu_bf16):
    """lr and the EMA decay change every step, written into the same two
    fp32 tensors that the update reads (as a graph replay reads them): p,
    m, v and ema within 1e-6 max abs of JAX's, fed the same per-step
    values."""
    lrs, decays = (0.02, 0.005, 0.03), (0.0, 0.5, 0.999)
    st = _state(2, mu_bf16)
    p, slots, n_decay = _flatten(st['p'])
    m = _flatten(st['m'], torch.bfloat16 if mu_bf16 else torch.float32)[0]
    v, e = _flatten(st['v'])[0], _flatten(st['e'])[0]
    count = torch.zeros((), dtype=torch.int32)
    lr_t, decay_t = torch.zeros(()), torch.zeros(())
    for s in range(3):
        lr_t.fill_(lrs[s])
        decay_t.fill_(decays[s])
        fused_adamw_reference(p, _flatten(st['grads'][s])[0], m, v, e, count, lr=lr_t,
                              n_decay=n_decay, ema_decay=decay_t, **HP)
    ref = _run_jax(jx, oracle, st, mu_bf16, True, lrs=lrs, decays=decays)
    port = dict(p=p, m=m, v=v, e=e)
    for k in ref:
        for a, b in zip(_unflatten(port[k], slots), ref[k]):
            assert float(np.abs(a - b).max()) <= 1e-6, k


def test_nan_grad_step_leaves_state_bit_identical():
    st = _state(1, mu_bf16=True)
    p, slots, n_decay = _flatten(st['p'])
    m, v, e = _flatten(st['m'], torch.bfloat16)[0], _flatten(st['v'])[0], _flatten(st['e'])[0]
    count = torch.full((), 7, dtype=torch.int32)
    g = _flatten(st['grads'][0])[0]
    g[5] = float('nan')
    ok = torch.isfinite(g).all()
    before = [t.clone() for t in (p, m, v, e, count)]
    fused_adamw(p, g, m, v, e, count, lr=LR, n_decay=n_decay, ema_decay=EMA_DECAY, ok=ok, **HP)
    for a, b in zip((p, m, v, e, count), before):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fused_adamw(p, _flatten(st['grads'][1])[0], m, v, e, count, lr=LR, n_decay=n_decay,
                ema_decay=0.0, ok=torch.tensor(True), **HP)
    assert int(count) == 8 and torch.equal(e, p)  # decay 0: the EMA syncs to the new params


def test_weight_decay_mask_matches_jax_by_name():
    import jax

    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict
    from timm_tpu.optim import param_groups_weight_decay as jax_groups
    from timm_tpu.utils.serialization import _kp_str
    from timm_tpu_torch.models import convert_jax_state_dict

    jm = timm_tpu.create_model('vit_tiny_patch16_224', img_size=32, num_classes=10)
    jmask = {_kp_str(kp): bool(v) for kp, v in
             jax.tree_util.tree_flatten_with_path(jax_groups(jm, 0.05))[0]}
    # the port's names are the JAX names after the weight-carry renames
    flat = model_state_dict(jm)
    port_name = dict(zip(flat, convert_jax_state_dict(flat)))
    renamed = {port_name[k]: v for k, v in jmask.items()}
    tm = timm_tpu_torch.create_model('vit_tiny_patch16_224', img_size=32, num_classes=10, device='cpu')
    assert param_groups_weight_decay(tm, 0.05) == renamed
    assert renamed['blocks.0.attn.qkv.weight'] and not renamed['pos_embed']
    opt = create_optimizer_v2(tm, opt='adamw', weight_decay=0.05)
    assert opt.decay_mask() == renamed


def test_clip_grad_norm_matches_jax():
    import jax.numpy as jnp

    from timm_tpu.utils import clip_grad_norm as jclip
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in SIZES]
    for max_norm in (1.0, 1e3):
        ours, norm = clip_grad_norm([torch.from_numpy(x) for x in leaves], max_norm)
        ref, jnorm = jclip({i: jnp.asarray(x) for i, x in enumerate(leaves)}, max_norm)
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for i, g in enumerate(ours):
            assert float(np.abs(g.numpy() - np.asarray(ref[i])).max()) <= 1e-6


def test_value_and_adaptive_clipping_match_jax():
    """clip_grad_value, and AGC on the port's (out, in) weights against the
    JAX package's (in, out) kernels of the same values."""
    import jax.numpy as jnp

    from timm_tpu.utils import dispatch_clip_grad as jdispatch
    from timm_tpu_torch.utils import dispatch_clip_grad
    rng = np.random.default_rng(9)
    w = rng.standard_normal((6, 5)).astype(np.float32)        # port layout (out, in)
    b = rng.standard_normal(6).astype(np.float32)
    gw, gb = (rng.standard_normal(x.shape).astype(np.float32) * 0.5 for x in (w, b))
    ours, _ = dispatch_clip_grad([torch.from_numpy(gw), torch.from_numpy(gb)], 0.3, mode='value')
    ref, _ = jdispatch({'w': jnp.asarray(gw), 'b': jnp.asarray(gb)}, 0.3, mode='value')
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref['w']))
    ours, _ = dispatch_clip_grad([torch.from_numpy(gw), torch.from_numpy(gb)], 0.05, mode='agc',
                                 params=[torch.from_numpy(w), torch.from_numpy(b)])
    ref, _ = jdispatch({'w': jnp.asarray(gw.T), 'b': jnp.asarray(gb)}, 0.05, mode='agc',
                       params={'w': jnp.asarray(w.T), 'b': jnp.asarray(b)})
    assert float(np.abs(ours[0].numpy() - np.asarray(ref['w']).T).max()) <= 1e-6
    assert float(np.abs(ours[1].numpy() - np.asarray(ref['b'])).max()) <= 1e-6
    assert not np.allclose(ours[0].numpy(), gw)  # the case clips


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_cross_entropy_matches_jax(dtype):
    import jax.numpy as jnp

    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.loss import SoftTargetCrossEntropy as JST
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 10)) * 3).astype(np.float32)
    target = rng.integers(0, 10, 8)
    soft = rng.dirichlet(np.ones(10), 8).astype(np.float32)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    jl = jnp.asarray(logits, dtype)
    pairs = [
        (LabelSmoothingCrossEntropy(0.1)(tl, torch.from_numpy(target)), JLS(0.1)(jl, jnp.asarray(target))),
        (cross_entropy(tl, torch.from_numpy(target)), JLS(0.0)(jl, jnp.asarray(target))),
        (SoftTargetCrossEntropy()(tl, torch.from_numpy(soft)), JST()(jl, jnp.asarray(soft))),
    ]
    for ours, ref in pairs:
        assert ours.dtype == torch.float32
        assert abs(float(ours) - float(ref)) <= 1e-6


def test_ema_update_and_decay_schedule_match_jax():
    import jax.numpy as jnp

    from timm_tpu.utils import ModelEmaV3 as JEma
    from timm_tpu.utils import ema_update as jema
    rng = np.random.default_rng(4)
    e, p = (rng.standard_normal((16, 8)).astype(np.float32) for _ in range(2))
    for d in (0.0, 0.999, 0.9998):
        ours = ema_update({'w': torch.from_numpy(e)}, {'w': torch.from_numpy(p)}, d)['w']
        ref = jema({'w': jnp.asarray(e)}, {'w': jnp.asarray(p)}, d)['w']
        assert float(np.abs(ours.numpy() - np.asarray(ref)).max()) <= 1e-6
    assert torch.equal(ema_update({'w': torch.from_numpy(e)}, {'w': torch.from_numpy(p)}, 0.0)['w'],
                       torch.from_numpy(p))
    for kw in (dict(decay=0.999), dict(decay=0.9998, use_warmup=True, update_after_step=2)):
        ours, ref = ModelEmaV3(**kw), JEma(**kw)
        assert [ours.get_decay(s) for s in range(12)] == [ref.get_decay(s) for s in range(12)]
    assert ModelEmaV3(decay=0.999).get_decay(1) == 0.0


def test_cosine_warmup_schedule_matches_jax():
    from timm_tpu.scheduler import create_scheduler_v2 as jsched
    kw = dict(base_lr=1e-3, sched='cosine', num_epochs=20, warmup_epochs=5, warmup_lr=1e-6,
              min_lr=1e-5)
    ours, n_ours = create_scheduler_v2(**kw)
    ref, n_ref = jsched(**kw)
    assert n_ours == n_ref
    got = [ours.step(t)[0] for t in range(30)]
    want = [ref.step(t)[0] for t in range(30)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[0] == 1e-6 and got[:6] == sorted(got[:6]) and got[-1] == 1e-5  # warmup, floor
    upd, _ = create_scheduler_v2(**kw, step_on_epochs=False, updates_per_epoch=3)
    jupd, _ = jsched(**kw, step_on_epochs=False, updates_per_epoch=3)
    assert [upd.step_update(t)[0] for t in range(30)] == [jupd.step_update(t)[0] for t in range(30)]
    # the schedules and options the port once refused now give JAX's values
    for sched_kw in (dict(sched='step'), dict(cooldown_epochs=2), dict(warmup_prefix=True),
                     dict(noise=0.5), dict(cycle_limit=2), dict(cycle_mul=2.0), dict(k_decay=2.0)):
        ours, n_ours = create_scheduler_v2(**dict(kw, **sched_kw))
        ref, n_ref2 = jsched(**dict(kw, **sched_kw))
        assert n_ours == n_ref2
        assert [ours.step(t)[0] for t in range(30)] == [ref.step(t)[0] for t in range(30)]
    assert create_scheduler_v2(**kw, cycle_limit=1, noise=None)[1] == n_ref  # defaults pass


def test_sgd_matches_optax_chain(jx):
    """opt='sgd': Nesterov momentum with the JAX factory's coupled, masked L2,
    3 updates on test_vit's leaves."""
    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.utils.serialization import flatten_pytree
    from timm_tpu_torch.models import convert_jax_state_dict
    from flax import nnx

    jax, jnp = jx.jax, jx.jnp
    jm = timm_tpu.create_model('test_vit', num_classes=5)
    tm = timm_tpu_torch.create_model('test_vit', num_classes=5, device='cpu')
    load_jax_state_dict(tm, model_state_dict(jm))
    jo = jopt(jm, opt='sgd', lr=0.1, weight_decay=0.05)
    to = create_optimizer_v2(tm, opt='sgd', lr=0.1, weight_decay=0.05)
    params = nnx.state(jm, nnx.Param)
    state = jo.init(params)
    update = jax.jit(lambda g, s, p, lr: jo.update(g, s, p, lr=lr))
    rng = np.random.default_rng(5)
    tparams = dict(tm.named_parameters())
    for lr in (0.1, 0.05, 0.02):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), params)
        with torch.no_grad():
            for k, v in convert_jax_state_dict(flatten_pytree(grads)).items():
                tparams[k].grad.copy_(v)
        updates, state = update(grads, state, params, jnp.asarray(lr, jnp.float32))
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        to.step(lr=lr)
    nnx.update(jm, params)
    ref = convert_jax_state_dict(model_state_dict(jm))
    for k, v in tm.state_dict().items():
        assert float((v - ref[k]).abs().max()) <= 1e-6, k


def test_factory_raises_for_what_is_not_ported():
    """Every name of the JAX registry is ported now, with every wrapper; an
    unknown name raises, and so does a parameter moved out of the flat
    buffer."""
    tm = timm_tpu_torch.create_model('test_vit', num_classes=5, device='cpu')
    for kw in (dict(opt='adafactor'), dict(opt='adam'), dict(opt='lion'),
               dict(opt='lookahead_lion'), dict(opt='lion', layer_decay=0.75),
               dict(opt='lion', caution=True)):
        create_optimizer_v2(timm_tpu_torch.create_model('test_vit', num_classes=5, device='cpu'),
                            **kw)
    with pytest.raises(ValueError, match='not found'):
        create_optimizer_v2(tm, opt='nosuchopt')
    opt = create_optimizer_v2(tm, opt='adamw', weight_decay=0.05, mu_dtype='bfloat16')
    assert opt.m.dtype == torch.bfloat16 and opt.v.dtype == torch.float32
    # the parameters now live in the flat buffer; moving one breaks the views
    tm.head.weight.data = tm.head.weight.data.clone()
    with pytest.raises(RuntimeError, match='moved or replaced'):
        opt.step()


@pytest.mark.gpu
@pytest.mark.parametrize('mu_bf16', [False, True], ids=['mu_fp32', 'mu_bf16'])
def test_kernel_matches_plain_on_card(mu_bf16):
    """The CUDA kernel against its plain version on the card: 3 updates with
    a clip factor and the EMA within 1e-6 (m within one bf16 ulp), one
    launch per update, and a NaN step that changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    st = _state(6, mu_bf16)
    mdt = torch.bfloat16 if mu_bf16 else torch.float32
    bufs = {}
    for side in ('kernel', 'plain'):
        p, slots, n_decay = _flatten(st['p'])
        bufs[side] = [t.cuda() for t in (p, _flatten(st['m'], mdt)[0], _flatten(st['v'])[0],
                                         _flatten(st['e'])[0], torch.zeros((), dtype=torch.int32))]
    scale = torch.tensor(0.5, device='cuda')
    for s in range(3):
        g = _flatten(st['grads'][s])[0].cuda()
        kp, km, kv, ke, kc = bufs['kernel']
        before = fused_adamw.launches
        fused_adamw(kp, g, km, kv, ke, kc, lr=LR, n_decay=n_decay, ema_decay=EMA_DECAY,
                    grad_scale=scale, **HP)
        assert fused_adamw.launches == before + 1
        rp, rm, rv, re, rc = bufs['plain']
        fused_adamw_reference(rp, g, rm, rv, re, rc, lr=LR, n_decay=n_decay,
                              ema_decay=EMA_DECAY, grad_scale=scale, **HP)
    torch.cuda.synchronize()
    k, r = bufs['kernel'], bufs['plain']
    for i in (0, 2, 3):
        assert float((k[i] - r[i]).abs().max()) <= 1e-6
    ulp = (r[1].float().abs() * 2.0 ** -7).clamp_min(1e-30)
    assert bool(((k[1].float() - r[1].float()).abs() <= (ulp if mu_bf16 else 1e-6)).all())
    assert int(k[4]) == 3
    g = _flatten(st['grads'][0])[0].cuda()
    g[3] = float('inf')
    keep = [t.clone() for t in k]
    fused_adamw(k[0], g, k[1], k[2], k[3], k[4], lr=LR, n_decay=n_decay,
                ok=torch.isfinite(g).all(), **HP)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, keep))
