"""Training breadth of the PyTorch port against the JAX package on the CPU:
Muon (with its Newton-Schulz step and leaf labels), NAdamW, LAMB, MADGRAD,
LaProp and MARS, the lookahead / caution / layer-decay wrappers, every
schedule of the JAX factory, the BCE and asymmetric losses, JAX task
checkpoints of these optimizers loaded strictly, and the train driver with
them.

Each optimizer runs the JAX factory's optax chain (jitted, as the JAX task
runs it) and the port's flat-buffer update on the same seeded numpy
gradients, with the learning rate and the clip factor changing every step
and one step skipped by the non-finite flag; the parameters and the whole
optimizer state (through the JAX checkpoint converter) are held within the
stated tolerance. Muon runs on test_vit at 32 px; the rest, to keep the
JAX compiles short, on a toy model of 8 leaves in both packages: a 2-D
weight of each orientation (in < out, square, in > out), 1-D, 3-D and 4-D
leaves, one the model keeps from weight decay, and a group_matcher. JAX is
imported inside the fixtures.
"""
import os
import types

import numpy as np
import pytest
import torch
from torch import nn

import timm_tpu_torch
from timm_tpu_torch.models import convert_jax_checkpoint, convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.optim import (
    NS_COEFFS, Muon, create_optimizer_v2, orthogonalize_via_newton_schulz, param_groups_layer_decay,
)
from timm_tpu_torch.scheduler import create_scheduler_v2
from timm_tpu_torch.utils.serialization import add_prefix, split_prefix
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_graphs import _NoHostReads, _raiser

WD = 0.05
LRS = (2e-3, 5e-4, 1e-3, 3e-3)       # per step
SCALES = (1.0, 0.5, 0.8, 0.3)        # the clip factor per step
SKIP = 2                             # the step the non-finite flag skips (0-based)


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.utils.serialization import flatten_pytree

    def build(name, seed=0):
        """test_vit at 32 px from its shapes, with seeded numpy weights (no
        JAX random draws, whose first compiles cost seconds here)."""
        abstract = nnx.eval_shape(lambda: timm_tpu.create_model(name, img_size=32, num_classes=5))
        graphdef, params, rest = nnx.split(abstract, nnx.Param, ...)
        rng = np.random.default_rng(seed)
        filled = nnx.from_flat_state({k: nnx.Param(jnp.asarray(
            rng.standard_normal(v.get_value().shape) * 0.1, jnp.float32))
            for k, v in nnx.to_flat_state(params)})
        return nnx.merge(graphdef, filled, rest)

    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, timm_tpu=timm_tpu, jopt=jopt,
                                 model_state_dict=model_state_dict, flatten_pytree=flatten_pytree,
                                 Toy=_jax_toy(nnx, jnp), build=build)


def _group_matcher(coarse=False):
    return dict(stem=r'^conv|pos_embed',
                blocks=[(r'^fc', (0,)), (r'^proj', (1,)), (r'^norm', (99999,))])


class _Toy(nn.Module):
    """The port's half of the toy model (its JAX half is ``jx.Toy``)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 8, 3)
        self.pos_embed = nn.Parameter(torch.zeros(1, 5, 16))
        self.fc = nn.Linear(24, 40)
        self.proj = nn.Linear(40, 40, bias=False)
        self.norm = nn.LayerNorm(40, bias=False)
        self.head = nn.Linear(40, 10, bias=False)

    def no_weight_decay(self):
        return {'pos_embed'}

    group_matcher = staticmethod(_group_matcher)


def _jax_toy(nnx, jnp):
    """The toy model's JAX half: seeded numpy weights in the JAX layout
    (kernels (in, out) and HWIO), no JAX random draws."""
    class Leaves(nnx.Module):
        def __init__(self, rng, **shapes):
            for name, shape in shapes.items():
                scale = 1.0 if name == 'scale' else 0.2
                setattr(self, name, nnx.Param(jnp.asarray(
                    rng.standard_normal(shape) * scale + (name == 'scale'), jnp.float32)))

    class Toy(nnx.Module):
        def __init__(self, seed=0):
            rng = np.random.default_rng(seed)
            self.conv = Leaves(rng, kernel=(3, 3, 4, 8), bias=(8,))
            self.pos_embed = nnx.Param(jnp.asarray(rng.standard_normal((1, 5, 16)) * 0.02,
                                                   jnp.float32))
            self.fc = Leaves(rng, kernel=(24, 40), bias=(40,))
            self.proj = Leaves(rng, kernel=(40, 40))
            self.norm = Leaves(rng, scale=(40,))
            self.head = Leaves(rng, kernel=(40, 10))

        def no_weight_decay(self):
            return {'pos_embed'}

        group_matcher = staticmethod(_group_matcher)
    return Toy


def _models(jx, model='toy', seed=0):
    """The toy model or test_vit at 32 px in both packages, the JAX weights
    carried over."""
    if model == 'toy':
        jm, tm = jx.Toy(seed), _Toy()
    else:
        jm = jx.build(model, seed)
        tm = timm_tpu_torch.create_model(model, img_size=32, num_classes=5, device='cpu')
    load_jax_state_dict(tm, jx.model_state_dict(jm))
    return jm, tm


def _grads(jx, params, seed):
    """Seeded numpy gradients as a JAX tree and as the port's flat buffer
    contents by name."""
    rng = np.random.default_rng(seed)
    g = jx.jax.tree.map(
        lambda x: jx.jnp.asarray(rng.standard_normal(x.shape) * 0.1, jx.jnp.float32), params)
    return g, convert_jax_state_dict(jx.flatten_pytree(g))


class _Pair:
    """One optimizer built by both factories over the same weights."""

    def __init__(self, jx, opt, steps, seed=0, model='toy', **kw):
        self.jx, self.model = jx, model
        self.jm, self.tm = _models(jx, model)
        self.jo = jx.jopt(self.jm, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
        self.to = create_optimizer_v2(self.tm, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
        self.params = jx.nnx.state(self.jm, jx.nnx.Param)
        self.state = self.jo.init(self.params)
        # jitted: one compile a case costs less here than eager JAX's
        # compile of each op at each leaf shape
        self.update = jx.jax.jit(lambda g, s, p, lr: self.jo.update(g, s, p, lr=lr))
        for i in range(steps):
            self.step(i, seed)

    def step(self, i, seed=0, port=True):
        jx, jnp = self.jx, self.jx.jnp
        k = i % len(LRS)
        g, tg = _grads(jx, self.params, seed * 100 + i)
        if i != SKIP:  # JAX's guard keeps the old params and state on a bad step
            g = jx.jax.tree.map(lambda x: x * jnp.float32(SCALES[k]), g)
            updates, self.state = self.update(g, self.state, self.params,
                                              jnp.asarray(LRS[k], jnp.float32))
            self.params = jx.jax.tree.map(lambda p, u: p + u, self.params, updates)
        if port:
            views = self.to.views(self.to.flat_grad)
            with torch.no_grad():
                for name, v in tg.items():
                    views[name].copy_(v)
            self.to.step(lr=LRS[k], grad_scale=torch.tensor(SCALES[k]),
                         ok=torch.tensor(i != SKIP))

    def jax_checkpoint(self):
        """The JAX optimizer state and weights as a task checkpoint's flat dict."""
        self.jx.nnx.update(self.jm, self.params)
        st = add_prefix(self.jx.model_state_dict(self.jm), 'state_dict')
        st.update(self.jx.flatten_pytree(self.state, 'optimizer'))
        return st

    def check_port_resume(self, opt, **kw):
        """The port's own state loads strictly into a fresh optimizer over the
        same weights, and one more step of each is equal bit for bit; the
        JAX state, converted, loads strictly too."""
        model = _models(self.jx, self.model)[1]
        model.load_state_dict(self.tm.state_dict())
        fresh = create_optimizer_v2(model, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
        state = self.to.state_arrays()
        fresh.load_state_arrays(state, strict=True)
        ref = convert_jax_checkpoint(self.jax_checkpoint())
        fresh_jax = create_optimizer_v2(_models(self.jx, self.model)[1], opt=opt, lr=LRS[0],
                                        weight_decay=WD, **kw)
        fresh_jax.load_state_arrays(split_prefix(ref, 'optimizer'), strict=True)
        grad = torch.from_numpy(np.random.default_rng(9).standard_normal(
            fresh.flat_grad.numel(), dtype=np.float32) * 0.1)
        for o in (self.to, fresh):
            o.flat_grad.copy_(grad)
            o.step(lr=LRS[1], grad_scale=torch.tensor(0.7), ok=torch.tensor(True))
        for (name, a), b in zip(self.to.slots().items(), fresh.slots().values()):
            assert torch.equal(a, b), name
        assert torch.equal(self.to.flat_param, fresh.flat_param)

    def max_errors(self):
        """(params, optimizer state) max abs differences; the state compared
        key by key after the JAX state goes through the converter."""
        ref = convert_jax_checkpoint(self.jax_checkpoint())
        ours = add_prefix(self.to.state_arrays(), 'optimizer')
        ours.update(add_prefix({k: v.detach().numpy() for k, v in self.tm.state_dict().items()},
                               'state_dict'))
        assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))[:6]
        err = {}
        for k in ref:
            what = 'params' if k.startswith('state_dict.') else k.split('.')[1]
            d = float(np.abs(np.asarray(ours[k], np.float64) - np.asarray(ref[k], np.float64)).max())
            err[what] = max(err.get(what, 0.0), d)
        return err


# ---- Muon ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(64, 192), (192, 64)])
def test_newton_schulz_matches_optax(jx, shape):
    """The Newton-Schulz orthogonalization against optax's, fp32: relative
    L2 within 1e-5."""
    from optax.contrib._muon import orthogonalize_via_newton_schulz as ref_ns
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(ref_ns(jx.jnp.asarray(x), jx.jnp.asarray(NS_COEFFS, jx.jnp.float32)))
    ours = orthogonalize_via_newton_schulz(torch.from_numpy(x)).numpy()
    assert ours.shape == shape
    assert float(np.linalg.norm(ours - ref) / np.linalg.norm(ref)) <= 1e-5
    # a batch computes what each matrix alone does
    batch = orthogonalize_via_newton_schulz(torch.from_numpy(np.stack([x, 2 * x])))
    assert float((batch[0] - torch.from_numpy(ours)).abs().max()) <= 1e-6


def _port_name(jax_name):
    base, _, leaf = jax_name.rpartition('.')
    return f'{base}.weight' if leaf in ('kernel', 'scale') else jax_name


@pytest.mark.parametrize('model', ['test_vit', 'test_convnext2'])
def test_muon_leaf_labels_match_optax(jx, model):
    """The leaves Muon orthogonalizes (and those it leaves to Adam), by
    name, against the partition of optax's muon state."""
    from timm_tpu.utils.serialization import _kp_str
    nnx = jx.nnx
    kw = dict(img_size=32) if model == 'test_vit' else {}
    jm = nnx.eval_shape(lambda: jx.timm_tpu.create_model(model, num_classes=5, **kw))
    jo = jx.jopt(jm, opt='muon', weight_decay=WD)
    state = jx.jax.eval_shape(jo.init, nnx.state(jm, nnx.Param))
    labels = {}
    for kp, _ in jx.jax.tree_util.tree_flatten_with_path(state)[0]:
        key = _kp_str(kp)
        for part in ('muon', 'adam'):
            marker = f'inner_states.{part}.inner_state.0.mu.'
            if marker in key:
                labels[_port_name(key.split(marker)[1])] = part
    tm = timm_tpu_torch.create_model(model, num_classes=5, device='cpu', **kw)
    opt = create_optimizer_v2(tm, opt='muon', weight_decay=WD)
    assert isinstance(opt, Muon)
    ours = {n: 'muon' for n in opt.muon_leaves} | {n: 'adam' for n in opt.adam_leaves}
    assert ours == labels and 'muon' in labels.values() and 'adam' in labels.values()
    assert set(opt.state_keys()) == {'count', 'learning_rate'} | {f'mu.{n}' for n in ours} | {
        f'nu.{n}' for n in opt.adam_leaves}


@pytest.mark.parametrize('opt,momentum', [('muon', 0.9), ('nadamuon', 0.95)])
def test_muon_matches_jax(jx, opt, momentum):
    """4 steps on test_vit (one skipped) with changing lr and clip factor,
    wd 0.05 under the mask: parameters, mu and nu within 1e-5. ('adamuon'
    is the same factory in both packages: see the plumbing test.)"""
    pair = _Pair(jx, opt, 4, model='test_vit', momentum=momentum)
    assert int(pair.to.count) == 3
    err = pair.max_errors()
    assert set(err) == {'params', 'count', 'learning_rate', 'mu', 'nu'}
    assert max(err.values()) <= 1e-5, err
    pair.check_port_resume(opt, momentum=momentum)
    if opt == 'muon':  # and a JAX Muon task checkpoint continues in the port
        _continue_from_jax_checkpoint(pair, opt, 'test_vit', momentum=momentum)


# ---- NAdamW, LAMB, MADGRAD, LaProp, MARS ------------------------------------------------

@pytest.mark.parametrize('opt,kw,tol', [
    ('nadamw', {}, 1e-6),
    ('nadamw', dict(mu_dtype='bfloat16'), 1e-5),  # one bf16 ulp of m: up to 7.6e-6
    ('lamb', {}, 1e-5),
    ('lamb', dict(mu_dtype='bfloat16'), 1e-5),
    ('madgrad', {}, 1e-6),
    ('madgradw', {}, 1e-6),
    ('laprop', {}, 1e-6),
    ('mars', {}, 1e-5),
    ('mars', dict(mars_type='lion'), 1e-5),
], ids=['nadamw', 'nadamw_bf16', 'lamb', 'lamb_bf16', 'madgrad', 'madgradw', 'laprop', 'mars',
        'mars_lion'])
def test_optimizer_matches_jax(jx, opt, kw, tol):
    """4 steps through both factories (one skipped): parameters and every
    state slot within ``tol`` (1e-5 where a per-leaf norm enters)."""
    pair = _Pair(jx, opt, 4, **kw)
    err = pair.max_errors()
    assert max(err.values()) <= tol, err
    assert int(pair.to.count) == 3
    pair.check_port_resume(opt, **kw)


# ---- wrappers --------------------------------------------------------------------------------

@pytest.mark.parametrize('opt,kw', [
    ('lookahead_adamw', {}),
    ('adamw', dict(caution=True)),
    ('lookahead_nadamw', dict(caution=True, layer_decay=0.75)),
], ids=['lookahead', 'caution', 'lookahead_caution_layer_decay'])
def test_wrappers_match_jax(jx, opt, kw):
    """7 steps (across lookahead's sync at step 6, one skipped):
    parameters, slow weights and the inner state within 1e-6."""
    pair = _Pair(jx, opt, 7, **kw)
    assert not pair.to.fused
    err = pair.max_errors()
    assert ('slow' in err) == opt.startswith('lookahead')
    assert max(err.values()) <= 1e-6, err
    pair.check_port_resume(opt, **kw)


def test_layer_decay_scales_match_jax_by_name(jx):
    """Layer-decay scales and the decay mask by name against JAX's on
    test_vit, and ConvNeXt's layer ids against JAX's grouping of its names."""
    from timm_tpu.models._manipulate import group_with_matcher
    from timm_tpu.optim import param_groups_layer_decay as jgroups
    from timm_tpu.utils.serialization import _kp_str
    from timm_tpu_torch.optim import auto_group_layers
    flat = lambda t: {_port_name(_kp_str(kp)): v for kp, v in  # noqa: E731
                      jx.jax.tree_util.tree_flatten_with_path(t)[0]}
    jm, tm = _models(jx, 'test_vit')
    scales, mask = jgroups(jm, weight_decay=WD, layer_decay=0.65, min_scale=0.1)
    ours, our_mask = param_groups_layer_decay(tm, weight_decay=WD, layer_decay=0.65, min_scale=0.1)
    assert ours == flat(scales) and our_mask == {k: bool(v) for k, v in flat(mask).items()}
    assert len(set(ours.values())) == 4  # stem, 2 blocks, the head
    nnx = jx.nnx
    jm = nnx.eval_shape(lambda: jx.timm_tpu.create_model('test_convnext2', num_classes=5))
    names = list(flat(nnx.state(jm, nnx.Param)))
    ref = group_with_matcher([(n, None) for n in names], jm.group_matcher(), reverse=True)
    tm = timm_tpu_torch.create_model('test_convnext2', num_classes=5, device='meta')
    assert auto_group_layers(tm) == ref and len(set(ref.values())) > 3


def test_new_optimizers_read_nothing_back_to_the_host(monkeypatch):
    """Every new optimizer's step, and the wrappers, under the dispatch mode
    that fails on host reads, with the clip factor and the guard's flag as
    device tensors."""
    cases = [('muon', {}), ('nadamw', {}), ('lamb', dict(mu_dtype='bfloat16')), ('madgrad', {}),
             ('madgradw', {}), ('laprop', {}), ('mars', {}), ('mars', dict(mars_type='lion')),
             ('lookahead_muon', dict(caution=True, layer_decay=0.75))]
    for opt, kw in cases:
        torch.manual_seed(0)
        o = create_optimizer_v2(_Toy(), opt=opt, weight_decay=WD, **kw)
        o.flat_grad.normal_(generator=torch.Generator().manual_seed(0))
        for method in ('numpy', 'tolist', 'cpu', 'item'):
            monkeypatch.setattr(torch.Tensor, method, _raiser(method))
        with _NoHostReads():
            for _ in range(2):
                o.step(lr=1e-3, grad_scale=torch.tensor(0.5), ok=torch.tensor(True))
        monkeypatch.undo()
        assert int(o.count) == 2 and bool(torch.isfinite(o.flat_param).all()), opt


# ---- checkpoints ---------------------------------------------------------------------------------

def _continue_from_jax_checkpoint(pair, opt, model, **kw):
    """The JAX task checkpoint of ``pair`` loads strictly into a fresh port
    task; one more step of each then agrees within 1e-5, and the port's
    own checkpoint gives the keys ``checkpoint_keys`` promises."""
    state = convert_jax_checkpoint(pair.jax_checkpoint())
    tm = _models(pair.jx, model)[1]
    task = timm_tpu_torch.ClassificationTask(
        tm, optimizer=create_optimizer_v2(tm, opt=opt, lr=LRS[0], weight_decay=WD, **kw))
    task.load_checkpoint_state(state, strict=True)
    assert set(task.checkpoint_keys()) - {'_resume.drop_rng_state'} == set(state)
    pair.tm, pair.to = tm, task.optimizer
    pair.step(5)
    err = pair.max_errors()
    assert max(err.values()) <= 1e-5, err
    assert set(task.get_checkpoint_state()) == set(task.checkpoint_keys())


@pytest.mark.parametrize('opt,kw', [('lookahead_adamw', {}), ('nadamw', dict(layer_decay=0.75))])
def test_jax_checkpoint_loads_strictly_and_continues(jx, opt, kw):
    """A JAX task checkpoint after 2 steps (Muon's in the Muon test)."""
    _continue_from_jax_checkpoint(_Pair(jx, opt, 2, **kw), opt, 'toy', **kw)


def test_converter_names_what_it_cannot_place(jx):
    pair = _Pair(jx, 'muon', 0)
    st = pair.jax_checkpoint()
    key = next(k for k in st if k.endswith('ns_coeffs'))
    with pytest.raises(ValueError, match='ns_coeffs'):
        convert_jax_checkpoint(dict(st, **{key: np.float32([3.0, -4.0, 2.0])}))
    with pytest.raises(ValueError, match='optimizer.inner_state.foo'):
        convert_jax_checkpoint(dict(st, **{'optimizer.inner_state.foo': np.zeros(3)}))
    count = next(k for k in st if k.endswith('adam.inner_state.0.count'))
    with pytest.raises(ValueError, match='disagrees'):
        convert_jax_checkpoint(dict(st, **{count: np.int32(5)}))


def test_factory_plumbing_and_what_still_raises():
    """'muon' takes momentum as its beta and ignores eps and betas, as the
    JAX factory; no name of the JAX registry is queued any more (they build
    as the JAX factory's plumbing says: 'adan' takes three betas, 'lion' no
    eps, 'adafactor' an eps it never uses), and an unknown name raises."""
    tm = timm_tpu_torch.create_model('test_vit', img_size=32, num_classes=5, device='cpu')
    opt = create_optimizer_v2(tm, opt='muon', momentum=0.9, eps=1e-3, betas=(0.5, 0.6),
                              mu_dtype='bfloat16')
    assert (opt.beta, opt.b1, opt.b2, opt.eps) == (0.9, 0.9, 0.95, 1e-8)
    for alias in ('adamuon', 'nadamuon'):
        other = create_optimizer_v2(tm, opt=alias, momentum=0.9, weight_decay=WD)
        assert isinstance(other, Muon) and other.muon_leaves == opt.muon_leaves
        assert (other.beta, other.weight_decay) == (0.9, WD)
    opt = create_optimizer_v2(tm, opt='mars', betas=(0.8, 0.9), mars_type='lion', gamma=0.1)
    assert (opt.b1, opt.b2, opt.mars_type, opt.gamma) == (0.8, 0.9, 'lion', 0.1)
    from timm_tpu_torch.optim import SGD, Adafactor, Adam, Adan, Lion
    assert isinstance(create_optimizer_v2(tm, opt='adam'), Adam)
    opt = create_optimizer_v2(tm, opt='adan', betas=(0.9, 0.8, 0.7), eps=1e-6)
    assert isinstance(opt, Adan) and (opt.b1, opt.b2, opt.b3, opt.eps) == (0.9, 0.8, 0.7, 1e-6)
    opt = create_optimizer_v2(tm, opt='lookahead_lion', eps=1e-3, betas=(0.8, 0.9))
    assert isinstance(opt, Lion) and opt.slow is not None and (opt.b1, opt.b2) == (0.8, 0.9)
    assert isinstance(create_optimizer_v2(tm, opt='adafactor', eps=1e-3), Adafactor)
    opt = create_optimizer_v2(tm, opt='lookahead', momentum=0.5)
    assert isinstance(opt, SGD) and opt.trace is None and opt.slow is None
    with pytest.raises(ValueError, match='not found'):
        create_optimizer_v2(tm, opt='nosuchopt')


# ---- schedules -------------------------------------------------------------------------------------

SCHED_CASES = [
    ('cosine', dict(warmup_epochs=3, cooldown_epochs=2, min_lr=1e-5)),
    ('cosine', dict(warmup_epochs=3, warmup_prefix=True, cycle_limit=3, cycle_decay=0.5)),
    ('cosine', dict(cycle_mul=2.0, cycle_limit=3, k_decay=1.5)),
    ('cosine', dict(noise=[0.2, 0.8], noise_pct=0.5, noise_std=0.7, noise_seed=3)),
    ('cosine', dict(noise=0.3, step_on_epochs=False, updates_per_epoch=4, warmup_epochs=1)),
    ('tanh', dict(warmup_epochs=2, cycle_limit=2, cooldown_epochs=3, noise=0.5)),
    ('step', dict(decay_epochs=3, decay_rate=0.5, warmup_epochs=2, noise=[0.1])),
    ('step', dict(decay_epochs=2, step_on_epochs=False, updates_per_epoch=3)),
    ('multistep', dict(decay_milestones=(4, 9), decay_rate=0.3, warmup_epochs=2)),
    ('poly', dict(decay_rate=2.0, warmup_epochs=2, cycle_limit=2, k_decay=0.8, min_lr=1e-6)),
    ('plateau', dict(patience_epochs=1, decay_rate=0.5, warmup_epochs=2, noise=0.4)),
    ('plateau', dict(patience_epochs=2, plateau_mode='min', min_lr=2e-3)),
]


@pytest.mark.parametrize('sched,kw', SCHED_CASES)
def test_schedule_matches_jax(sched, kw):
    """Every schedule and option of the factory against JAX's over t = 0..N,
    per epoch (with a metric for plateau) and per update: within 1e-12, the
    noise from the same random.Random stream."""
    from timm_tpu.scheduler import create_scheduler_v2 as jsched
    kw = dict(dict(base_lr=0.01, sched=sched, num_epochs=12), **kw)
    ours, n_ours = create_scheduler_v2(**kw)
    ref, n_ref = jsched(**kw)
    assert n_ours == n_ref
    metrics = np.random.default_rng(0).permutation(20).tolist() + [5] * 10
    got, want = [], []
    for t in range(30):
        got.append(ours.step(t, metrics[t]) + ours.step_update(t * 3, metrics[t]))
        want.append(ref.step(t, metrics[t]) + ref.step_update(t * 3, metrics[t]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert len({round(x[0], 12) for x in got}) > 1  # the schedule moves


# ---- losses ----------------------------------------------------------------------------------------

def test_bce_and_asymmetric_losses_match_jax(jx):
    from timm_tpu.loss import AsymmetricLossMultiLabel as JAml
    from timm_tpu.loss import AsymmetricLossSingleLabel as JAsl
    from timm_tpu.loss import BinaryCrossEntropy as JBce
    from timm_tpu_torch.loss import (
        AsymmetricLossMultiLabel, AsymmetricLossSingleLabel, BinaryCrossEntropy,
    )
    jnp = jx.jnp
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((8, 10)) * 3).astype(np.float32)
    target = rng.integers(0, 10, 8)
    soft = rng.dirichlet(np.ones(10), 8).astype(np.float32)
    multi = (rng.random((8, 10)) < 0.3).astype(np.float32)
    cases = [(BinaryCrossEntropy, JBce, dict(smoothing=0.1), target),
             (BinaryCrossEntropy, JBce, dict(smoothing=0.1, sum_classes=True), target),
             (BinaryCrossEntropy, JBce, dict(smoothing=0.2, target_threshold=0.05), target),
             (BinaryCrossEntropy, JBce, dict(smoothing=0.0, target_threshold=0.1), soft),
             (BinaryCrossEntropy, JBce, dict(smoothing=0.0, sum_classes=True), soft),
             (AsymmetricLossMultiLabel, JAml, {}, multi),
             (AsymmetricLossMultiLabel, JAml, dict(gamma_neg=2, clip=0.0), multi),
             (AsymmetricLossSingleLabel, JAsl, {}, target),
             (AsymmetricLossSingleLabel, JAsl, dict(eps=0.0, reduction='sum'), target)]
    for port_cls, jax_cls, kw, y in cases:
        for dtype in ('float32', 'bfloat16'):
            x = torch.from_numpy(logits).to(getattr(torch, dtype))
            ours = port_cls(**kw)(x, torch.from_numpy(y))
            ref = jax_cls(**kw)(jnp.asarray(logits, dtype), jnp.asarray(y))
            assert ours.dtype == torch.float32
            assert abs(float(ours) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref))), (port_cls, kw)


# ---- the train driver --------------------------------------------------------------------------------

def test_train_driver_runs_muon_and_resumes_bit_for_bit(tmp_path):
    """``python -m timm_tpu_torch.train --opt muon --sched step --bce-loss
    --layer-decay 0.75 --opt-caution`` from 8 seeded PNGs: 4 updates
    uninterrupted against 2, a SIGTERM, and ``--resume auto``: the last
    checkpoints equal bit for bit."""
    from PIL import Image

    from timm_tpu_torch import train
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(tmp_path / 'data' / f'class{c}')
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
                tmp_path / 'data' / f'class{c}' / f'{i}.png')
    argv = ['--device', 'cpu', '--data-dir', str(tmp_path / 'data'), '--model', 'test_vit',
            '--img-size', '32', '--num-classes', '2', '-b', '4', '--epochs', '2', '--workers', '1',
            '--opt', 'muon', '--lr', '1e-3', '--weight-decay', '0.05', '--sched', 'step',
            '--decay-epochs', '1', '--warmup-epochs', '0', '--bce-loss', '--smoothing', '0.1',
            '--layer-decay', '0.75', '--opt-caution', '--drop-path', '0.1',
            '--output', str(tmp_path)]
    assert train.main(argv + ['--experiment', 'a']) == 0
    assert train.main(argv + ['--experiment', 'b', '--fault-inject', 'sigterm@1']) == 0
    assert 'recovery-0-1.npz' in os.listdir(tmp_path / 'b')
    assert train.main(argv + ['--experiment', 'b', '--resume', 'auto']) == 0
    with np.load(tmp_path / 'a' / 'last.npz') as a, np.load(tmp_path / 'b' / 'last.npz') as b:
        assert set(a.files) == set(b.files) and int(a['optimizer.count']) == 4
        assert any(k.startswith('optimizer.nu.') for k in a.files)
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
    assert not differ, differ[:5]


@pytest.mark.gpu
@pytest.mark.parametrize('opt,kw', [
    ('muon', {}), ('nadamw', {}), ('lamb', dict(mu_dtype='bfloat16')), ('madgrad', {}),
    ('madgradw', {}), ('laprop', {}), ('mars', {}), ('mars', dict(mars_type='lion')),
    ('lookahead_nadamw', dict(caution=True, layer_decay=0.75))])
def test_optimizer_on_card_matches_cpu(opt, kw):
    """Each new optimizer on the card against the CPU from the same weights
    and gradients, 3 steps with a clip factor: parameters and state within
    1e-5 (Muon's fp32 Newton-Schulz products, MARS's and LAMB's per-leaf
    norms sum in another order on the card)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = []
    for device in ('cpu', 'cuda'):
        torch.manual_seed(0)
        opts.append(create_optimizer_v2(_Toy().to(device), opt=opt, weight_decay=WD, **kw))
    rng = np.random.default_rng(5)
    for i in range(3):
        grad = torch.from_numpy(rng.standard_normal(opts[0].flat_grad.numel(),
                                                    dtype=np.float32) * 0.1)
        for o in opts:
            o.flat_grad.copy_(grad.to(o.device))
            o.step(lr=LRS[i], grad_scale=torch.tensor(SCALES[i], device=o.device),
                   ok=torch.tensor(True, device=o.device))
    cpu, card = opts
    assert int(card.count) == 3
    for (name, a), b in zip(cpu.slots().items(), card.slots().values()):
        assert float((a.float() - b.float().cpu()).abs().max()) <= 1e-5, name
    assert float((cpu.flat_param - card.flat_param.cpu()).abs().max()) <= 1e-5
