"""Every optimizer name of the JAX registry in the PyTorch port against the
JAX factory on the CPU, on leaves of test_resnet and test_vit, by their
names and shapes in both packages: the resnet's 7x7 stem, a 3x3 and a 1x1
conv kernel, a 3x3 kernel wide enough for Adafactor to factor, a norm's
scale and bias and the head; the ViT's class token and position embedding
(kept from weight decay), its 16x16 patch conv, a norm and the qkv and fc1
linear kernels with a bias. One model of these 16 leaves serves both
packages, so one JAX compile serves a name (on all 81 leaves of the two
models a compile took 5-10 s a name on one CPU core).

Each name runs 5 steps through both factories with the learning rate and
the clip factor changing every step and one step skipped by the
non-finite flag, weight decay 0.05 under the model's mask (the JAX
factory's coupled L2 for the names whose optax factory takes none); the
parameters and the whole optimizer state, through the JAX checkpoint
converter key by key, are held within the stated tolerance; then the JAX
state loads strictly into a fresh port optimizer and one more step of each
agrees again. Also: the registry's names, the coupled L2, Adafactor's
factored dims on the JAX layout, and that no step reads back to the host.
JAX is imported inside the fixtures.
"""
import types

import numpy as np
import pytest
import torch
from torch import nn

from timm_tpu_torch.models import convert_jax_checkpoint, convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.optim import create_optimizer_v2, list_optimizers
from timm_tpu_torch.utils.serialization import add_prefix, split_prefix
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_graphs import _NoHostReads, _raiser

WD = 0.05
LRS = (2e-3, 5e-4, 1e-3, 3e-3, 1.5e-3, 8e-4)   # per step
SCALES = (1.0, 0.5, 0.8, 0.3, 0.9, 0.6)       # the clip factor per step
SKIP = 2                                      # the step the non-finite flag skips
STEPS = 5

# (name, factory kwargs, tolerance over magnitudes of at least 1): 1e-6,
# but where a per-leaf reduction enters the state (NovoGrad's squared
# gradient norm over up to 49k elements: 1.2e-6 relative between the two
# summation orders; Adafactor's and SM3's row and column means, LAMB's and
# MARS's norms, Muon's Newton-Schulz products), 5e-6 or 1e-5
CASES = [
    ('sgd', {}, 1e-6), ('momentum', {}, 1e-6), ('sgdw', {}, 1e-6), ('sgdp', {}, 1e-6),
    ('lookahead', {}, 1e-6),
    ('adam', {}, 1e-6), ('adamw', {}, 1e-6), ('adamp', {}, 1e-6), ('nadam', {}, 1e-6),
    ('nadamw', {}, 1e-6), ('radam', {}, 1e-6), ('adamax', {}, 1e-6), ('adabelief', {}, 1e-6),
    ('adadelta', {}, 1e-6), ('adagrad', {}, 1e-6), ('adafactor', {}, 1e-5),
    ('adafactorbv', {}, 1e-5), ('adopt', {}, 1e-6), ('adan', dict(betas=(0.9, 0.92, 0.95)), 1e-6),
    ('lamb', {}, 1e-5), ('lars', {}, 1e-6), ('lion', {}, 1e-6), ('novograd', {}, 5e-6),
    ('nvnovograd', {}, 5e-6), ('rmsprop', {}, 1e-6), ('rmsproptf', dict(eps=1e-3), 1e-6),
    ('yogi', {}, 1e-6), ('sm3', {}, 1e-5), ('madgrad', {}, 1e-6), ('madgradw', {}, 1e-6),
    ('laprop', {}, 1e-6), ('mars', {}, 1e-5), ('muon', {}, 1e-5), ('adamuon', {}, 1e-5),
    ('nadamuon', {}, 1e-5),
]


# (path, kind, JAX shape): kernels in the JAX layout, (in, out) and HWIO
LEAVES = [
    ('resnet.conv1', 'conv', (7, 7, 3, 64)),
    ('resnet.bn1', 'norm', (64,)),
    ('resnet.layer1.0.conv1', 'conv', (3, 3, 64, 32)),
    ('resnet.layer2.0.downsample.conv', 'conv', (1, 1, 32, 48)),
    ('resnet.layer4.0.conv2', 'conv', (3, 3, 96, 96)),
    ('resnet.head.fc', 'linear', (96, 5)),
    ('vit.cls_token', 'param', (1, 1, 64)),
    ('vit.pos_embed', 'param', (1, 5, 64)),
    ('vit.patch_embed.proj', 'conv', (16, 16, 3, 64)),
    ('vit.blocks.0.norm1', 'norm', (64,)),
    ('vit.blocks.0.attn.qkv', 'linear', (64, 192)),
    ('vit.blocks.0.mlp.fc1', 'linear', (64, 256)),
]
NO_DECAY = {'vit.pos_embed', 'vit.cls_token'}


def _module_at(root: nn.Module, path: str) -> nn.Module:
    for part in path.split('.'):
        if not hasattr(root, part):
            root.add_module(part, nn.Module())
        root = getattr(root, part)
    return root


class _Both(nn.Module):
    """The port's half of the leaves of ``LEAVES``: conv and linear kernels
    as ``nn.Conv2d`` / ``nn.Linear`` weights (OIHW, (out, in))."""

    def __init__(self):
        super().__init__()
        for path, kind, shape in LEAVES:
            parent, _, name = path.rpartition('.')
            holder = _module_at(self, parent)
            if kind == 'conv':
                m = nn.Conv2d(shape[2], shape[3], shape[:2], bias=path.endswith('proj'))
            elif kind == 'linear':
                m = nn.Linear(*shape)
            elif kind == 'norm':
                m = nn.LayerNorm(shape[0])
            else:
                holder.register_parameter(name, nn.Parameter(torch.zeros(shape)))
                continue
            holder.add_module(name, m)

    def no_weight_decay(self):
        return NO_DECAY


@pytest.fixture(scope='module')
def jx():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from timm_tpu.models._helpers import model_state_dict
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.optim import list_optimizers as jlist
    from timm_tpu.utils.serialization import flatten_pytree

    class Leaves(nnx.Module):
        def __init__(self, rng, **shapes):
            for name, shape in shapes.items():
                v = rng.standard_normal(shape) * (0.1 if name != 'scale' else 0.2)
                setattr(self, name, nnx.Param(jnp.asarray(v + (name == 'scale'), jnp.float32)))

    class Node(nnx.Module):
        pass

    class Both(nnx.Module):
        """The JAX half of ``LEAVES``, seeded numpy values."""

        def __init__(self, seed=0):
            rng = np.random.default_rng(seed)
            for path, kind, shape in LEAVES:
                parent, _, name = path.rpartition('.')
                holder = self
                for part in parent.split('.'):
                    if not hasattr(holder, part):
                        setattr(holder, part, Node())
                    holder = getattr(holder, part)
                if kind == 'conv':
                    extra = dict(bias=(shape[3],)) if path.endswith('proj') else {}
                    setattr(holder, name, Leaves(rng, kernel=shape, **extra))
                elif kind == 'linear':
                    setattr(holder, name, Leaves(rng, kernel=shape, bias=(shape[1],)))
                elif kind == 'norm':
                    setattr(holder, name, Leaves(rng, scale=shape, bias=shape))
                else:
                    setattr(holder, name, nnx.Param(jnp.asarray(
                        rng.standard_normal(shape) * 0.02, jnp.float32)))

        def no_weight_decay(self):
            return NO_DECAY

    return types.SimpleNamespace(jax=jax, jnp=jnp, nnx=nnx, jopt=jopt, jlist=jlist,
                                 model_state_dict=model_state_dict, flatten_pytree=flatten_pytree,
                                 Both=Both)


def _models(jx, seed=0):
    jm, tm = jx.Both(seed), _Both()
    load_jax_state_dict(tm, jx.model_state_dict(jm))
    return jm, tm


class _Pair:
    """One optimizer built by both factories over the same weights, stepped
    on the same seeded gradients."""

    def __init__(self, jx, opt, **kw):
        self.jx, self.opt, self.kw = jx, opt, kw
        self.jm, self.tm = _models(jx)
        self.jo = jx.jopt(self.jm, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
        self.to = create_optimizer_v2(self.tm, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
        self.params = jx.nnx.state(self.jm, jx.nnx.Param)
        self.state = self.jo.init(self.params)
        self.update = jx.jax.jit(lambda g, s, p, lr: self.jo.update(g, s, p, lr=lr))

    def step(self, i, port=True):
        jx, jnp = self.jx, self.jx.jnp
        rng = np.random.default_rng(100 + i)
        g = jx.jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.1, jnp.float32), self.params)
        if i != SKIP:  # JAX's guard keeps the old params and state on a bad step
            gs = jx.jax.tree.map(lambda x: x * jnp.float32(SCALES[i]), g)
            updates, self.state = self.update(gs, self.state, self.params,
                                              jnp.asarray(LRS[i], jnp.float32))
            self.params = jx.jax.tree.map(lambda p, u: p + u, self.params, updates)
        if port:
            views = self.to.views(self.to.flat_grad)
            with torch.no_grad():
                for name, v in convert_jax_state_dict(jx.flatten_pytree(g)).items():
                    views[name].copy_(v)
            self.to.step(lr=LRS[i], grad_scale=torch.tensor(SCALES[i]),
                         ok=torch.tensor(i != SKIP))

    def jax_checkpoint(self):
        self.jx.nnx.update(self.jm, self.params)
        st = add_prefix(self.jx.model_state_dict(self.jm), 'state_dict')
        st.update(self.jx.flatten_pytree(self.state, 'optimizer'))
        return st

    def max_errors(self):
        """{what: max abs difference over magnitudes of at least 1},
        parameters and every state key, the JAX state through the
        converter; the key sets must be equal. (NovoGrad's per-leaf squared
        gradient norms are of order 100, RMSprop-TF's trace of order 3.)"""
        ref = convert_jax_checkpoint(self.jax_checkpoint())
        ours = add_prefix(self.to.state_arrays(), 'optimizer')
        ours.update(add_prefix({k: v.detach().numpy() for k, v in self.tm.state_dict().items()},
                               'state_dict'))
        assert set(ours) == set(ref), sorted(set(ours) ^ set(ref))[:6]
        err = {}
        for k in ref:
            what = 'params' if k.startswith('state_dict.') else k.split('.')[1]
            assert np.shape(ours[k]) == np.shape(ref[k]), k
            r = np.asarray(ref[k], np.float64)
            d = float(np.abs(np.asarray(ours[k], np.float64) - r).max(initial=0.0)) / max(
                1.0, float(np.abs(r).max(initial=0.0)))
            err[what] = max(err.get(what, 0.0), d)
        return err


@pytest.mark.parametrize('opt,kw,tol', CASES, ids=[c[0] for c in CASES])
def test_optimizer_matches_jax_and_loads_its_checkpoint(jx, opt, kw, tol):
    """5 steps (one skipped): parameters and every state key within
    ``tol``; the JAX state then loads strictly into a fresh port optimizer
    over the JAX parameters and a sixth step of each agrees within ``tol``."""
    pair = _Pair(jx, opt, **kw)
    for i in range(STEPS):
        pair.step(i)
    assert int(pair.to.count) == STEPS - 1
    err = pair.max_errors()
    assert max(err.values()) <= tol, err
    # the JAX task checkpoint of this state, into a fresh optimizer
    state = convert_jax_checkpoint(pair.jax_checkpoint())
    tm = _Both()
    tm.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in split_prefix(state, 'state_dict').items()})
    fresh = create_optimizer_v2(tm, opt=opt, lr=LRS[0], weight_decay=WD, **kw)
    fresh.load_state_arrays(split_prefix(state, 'optimizer'), strict=True)
    assert set(fresh.state_keys()) == set(split_prefix(state, 'optimizer'))
    pair.tm, pair.to = tm, fresh
    pair.step(STEPS)
    err = pair.max_errors()
    assert max(err.values()) <= tol, err


def test_registry_matches_jax(jx):
    """``list_optimizers()`` is the JAX registry's, and no name raises."""
    assert list_optimizers() == jx.jlist()
    assert len(list_optimizers()) == 35


def test_coupled_l2_goes_before_the_inner_optimizer():
    """For a name whose JAX factory takes no weight decay, the step with
    weight decay wd equals the step without it on the gradient g + wd * p
    of the leaves the mask decays (and g elsewhere)."""
    for opt in ('adam', 'radam', 'adagrad', 'rmsprop', 'yogi', 'sm3', 'adopt', 'momentum'):
        torch.manual_seed(0)
        a = create_optimizer_v2(_Both(), opt=opt, weight_decay=WD)
        torch.manual_seed(0)
        b = create_optimizer_v2(_Both(), opt=opt, weight_decay=0.0)
        mask = a.decay_mask()
        rng = np.random.default_rng(1)
        pa, pb = a.views(a.flat_param), b.views(b.flat_param)
        with torch.no_grad():
            for name, ga in a.views(a.flat_grad).items():
                g = torch.from_numpy(rng.standard_normal(ga.shape, dtype=np.float32) * 0.1)
                ga.copy_(g)
                b.views(b.flat_grad)[name].copy_(g + WD * pb[name] if mask[name] else g)
        a.step(lr=1e-3)
        b.step(lr=1e-3)
        for name in pa:
            assert torch.equal(pa[name], pb[name]), (opt, name)
        assert any(mask.values()) and not all(mask.values())


def test_adafactor_factors_the_jax_dims(jx):
    """Adafactor's state shapes are optax's on the JAX layout: a factored
    3x3 conv kernel (C_in, C_out >= 32) keeps (3, 3, C) rows and columns,
    a small kernel a full moment, a vector a full moment; JAX's own state
    of these leaves has these shapes."""
    opt = create_optimizer_v2(_Both(), opt='adafactor', weight_decay=WD)
    jm = jx.Both()
    ref = convert_jax_checkpoint(jx.flatten_pytree(jx.jopt(jm, opt='adafactor', weight_decay=WD)
                                                   .init(jx.nnx.state(jm, jx.nnx.Param)),
                                                   'optimizer'))
    assert {k: v.shape for k, v in split_prefix(ref, 'optimizer').items()} == {
        k: np.shape(v) for k, v in opt.state_arrays().items()}
    st = opt.state_arrays()
    assert st['v_row.resnet.layer4.0.conv2.weight'].shape == (3, 3, 96)   # HWIO (3, 3, 96, 96)
    assert st['v_col.resnet.layer4.0.conv2.weight'].shape == (3, 3, 96)
    assert st['v.resnet.layer4.0.conv2.weight'].shape == (1,)
    assert st['v_row.resnet.layer1.0.conv1.weight'].shape == (3, 3, 32)   # (3, 3, 64, 32)
    assert st['v_col.resnet.layer1.0.conv1.weight'].shape == (3, 3, 64)
    assert st['v.resnet.conv1.weight'].shape == (7, 7, 3, 64)             # 7 < 32: full
    assert st['v.resnet.bn1.weight'].shape == (64,)
    assert st['v_row.vit.blocks.0.attn.qkv.weight'].shape == (64,)        # (in 64, out 192)
    assert st['v_col.vit.blocks.0.attn.qkv.weight'].shape == (192,)


def test_new_optimizers_read_nothing_back_to_the_host(monkeypatch):
    """Every name's step under the dispatch mode that fails on host reads,
    with the clip factor and the guard's flag as device tensors."""
    for opt in list_optimizers():
        torch.manual_seed(0)
        o = create_optimizer_v2(_Both(), opt=opt, weight_decay=WD)
        o.flat_grad.normal_(generator=torch.Generator().manual_seed(0))
        for method in ('numpy', 'tolist', 'cpu', 'item'):
            monkeypatch.setattr(torch.Tensor, method, _raiser(method))
        with _NoHostReads():
            for _ in range(2):
                o.step(lr=1e-3, grad_scale=torch.tensor(0.5), ok=torch.tensor(True))
        monkeypatch.undo()
        assert int(o.count) == 2 and bool(torch.isfinite(o.flat_param).all()), opt


@pytest.mark.gpu
@pytest.mark.parametrize('opt', ['rmsproptf', 'adafactor', 'sm3', 'novograd', 'radam', 'adan',
                                 'lars', 'lion', 'adopt'])
def test_optimizer_on_card_matches_cpu(opt):
    """A new name on the card against the CPU from the same weights and
    gradients, 3 steps with a clip factor, TF32 off: parameters and every
    state key within 1e-5 of magnitudes of at least 1 (NovoGrad's squared
    norms are of order 50)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = []
    for device in ('cpu', 'cuda'):
        torch.manual_seed(0)
        opts.append(create_optimizer_v2(_Both().to(device), opt=opt, weight_decay=WD))
    rng = np.random.default_rng(5)
    for i in range(3):
        grad = torch.from_numpy(rng.standard_normal(opts[0].flat_grad.numel(),
                                                    dtype=np.float32) * 0.1)
        for o in opts:
            o.flat_grad.copy_(grad.to(o.device))
            o.step(lr=LRS[i], grad_scale=torch.tensor(SCALES[i], device=o.device),
                   ok=torch.tensor(True, device=o.device))
    cpu, card = (o.state_arrays() for o in opts)
    for k in cpu:
        scale = max(1.0, float(np.abs(cpu[k]).max(initial=0.0)))
        assert float(np.abs(cpu[k] - card[k]).max(initial=0.0)) <= 1e-5 * scale, k
    assert float((opts[0].flat_param - opts[1].flat_param.cpu()).abs().max()) <= 1e-5
