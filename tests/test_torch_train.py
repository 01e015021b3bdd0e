"""Training path of the PyTorch port against the JAX package on the CPU.

- The flash-attention ``autograd.Function``: its gradients against
  ``jax.vjp`` of the JAX ``flash_attention`` (whose backward is the
  ``_flash_bwd_rule`` recompute), unmasked and key-masked, from strided
  q/k/v views of one fused qkv tensor as the model passes them.
- ``drop_path`` against the JAX formula on one shared keep mask.
- The ``dryrun_multichip`` configuration of ``__graft_entry__.py`` in one
  process: vit_tiny_patch16_224 at 32 px, 10 classes, label smoothing 0.1,
  AdamW lr 1e-3 and weight decay 0.05 with the mask, clip 1.0, EMA 0.999,
  batch 4; the JAX weights are carried over, drop_path_rate is 0 (the two
  packages draw from different random streams) and 3 steps run on the same
  batches. Losses, grad norms, step-1 gradients, m and v are compared
  directly; the port's AdamW + EMA is also fed JAX's own gradients, which
  separates the optimizer from the gradients for params and EMA. The JAX
  task runs with its non-finite guard off: on finite steps
  the guard's select changes no value, and its ``where`` over every leaf
  takes most of the JAX step's compile time. The guard is held separately
  against JAX's sentinel functions.
- The non-finite guard: a NaN batch skips the step bit-identically, and K
  consecutive bad steps raise ``NonFiniteError``.

The JAX task is built once per module; JAX is imported inside fixtures.
"""
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.kernels import flash_attention, fused_adamw_reference
from timm_tpu_torch.layers import DropPath, apply_keep_mask, drop_path, set_drop_generator
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.models import convert_jax_state_dict, load_jax_state_dict
from timm_tpu_torch.optim import create_optimizer_v2
from timm_tpu_torch.resilience import NonFiniteError, NonFiniteSentinel
from timm_tpu_torch.task import ClassificationTask
from timm_tpu_torch.utils import clip_scale
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

STEPS = 3
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- flash attention gradients ----------------------------------------------

@pytest.mark.parametrize('masked', [False, True], ids=['unmasked', 'key_masked'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_flash_grads_match_jax_vjp(dtype, masked):
    """fp32 within 1e-5 max abs, bf16 within 2e-2 relative L2."""
    import jax
    import jax.numpy as jnp

    from timm_tpu.kernels.flash_attention import flash_attention as jax_flash
    B, H, N, D = 2, 2, 37, 32
    rng = np.random.default_rng(7)
    qkv = (rng.standard_normal((B, N, 3, H, D)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((B, H, N, D)).astype(np.float32)
    mask = (np.arange(N)[None, :] < np.array([30, N])[:, None]) if masked else None

    tqkv = torch.from_numpy(qkv).to(getattr(torch, dtype)).requires_grad_(True)
    q, k, v = tqkv.permute(2, 0, 3, 1, 4).unbind(0)  # strided views, as in Attention
    out = flash_attention(q, k, v, mask=None if mask is None else torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot).to(out.dtype))
    ours = tqkv.grad.float().permute(2, 0, 3, 1, 4).numpy()  # (3, B, H, N, D)

    jq, jk, jv = (jnp.asarray(qkv[:, :, i].transpose(0, 2, 1, 3), dtype) for i in range(3))
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, mask=jmask), jq, jk, jv)
    ref = np.stack([np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(cot, dtype))])
    assert tqkv.grad.dtype == tqkv.dtype
    if dtype == 'float32':
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    else:
        for i in range(3):
            assert _rel(ours[i], ref[i]) <= 2e-2


# ---- drop path ---------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_drop_path_matches_jax_on_a_shared_mask(dtype):
    """JAX computes where(mask, x / keep_prob, 0) with keep_prob rounded to
    x's dtype. The port's former code multiplied by 1/keep_prob rounded to
    the dtype, 0.5% off in bf16 (3.328125 for JAX's 3.34375 at x = 3)."""
    import jax
    import jax.numpy as jnp

    from timm_tpu.layers.drop import drop_path as jax_drop_path
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((32, 5, 8)) + 3.0).astype(np.float32)
    x[:, 0, 0] = 3.0
    jout = np.asarray(jax_drop_path(jnp.asarray(x, dtype), jax.random.key(1), 0.1).astype(jnp.float32))
    keep = np.abs(jout).reshape(32, -1).max(axis=1) > 0
    assert 0 < keep.sum() < 32  # the key drops some rows and keeps others
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    mask = torch.from_numpy(keep).view(32, 1, 1)
    ours = apply_keep_mask(tx, mask, 0.9).float().numpy()
    assert float(np.abs(ours - jout).max() / np.abs(jout).max()) <= 1e-6
    old = (tx * (mask.to(tx.dtype) / 0.9)).float().numpy()  # the replaced formula
    if dtype == 'bfloat16':
        i = int(np.argmax(keep))
        assert ours[i, 0, 0] == jout[i, 0, 0] == 3.34375 and old[i, 0, 0] == 3.328125
        assert float(np.abs(old - jout).max() / np.abs(jout).max()) > 1e-3


def test_drop_path_draws_from_the_generator():
    x = torch.ones(64, 3, 4)
    a = drop_path(x, 0.5, True, generator=torch.Generator().manual_seed(0))
    b = drop_path(x, 0.5, True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(RuntimeError, match='torch.Generator'):
        DropPath(0.5).train()(x)
    model = timm_tpu_torch.create_model('test_vit', drop_path_rate=0.2, seed=1, device='cpu').train()
    set_drop_generator(model, torch.Generator().manual_seed(3))
    y1 = model(torch.ones(2, 160, 160, 3))
    set_drop_generator(model, torch.Generator().manual_seed(3))
    assert torch.equal(y1, model(torch.ones(2, 160, 160, 3)))


# ---- the dryrun_multichip configuration -------------------------------------

def _batches(n):
    rng = np.random.RandomState(0)
    return [{'input': rng.rand(4, 32, 32, 3).astype(np.float32),
             'target': rng.randint(0, 10, 4).astype(np.int32)} for _ in range(n)]


def _port_task(flat_weights, **task_kw):
    tm = timm_tpu_torch.create_model('vit_tiny_patch16_224', img_size=32, num_classes=10,
                                     drop_path_rate=0.0, device='cpu')
    load_jax_state_dict(tm, flat_weights)
    opt = create_optimizer_v2(tm, opt='adamw', lr=1e-3, weight_decay=0.05)
    task = ClassificationTask(tm, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1),
                              clip_grad=1.0, **task_kw)
    task.setup_ema(decay=0.999)
    return task


@pytest.fixture(scope='module')
def dryrun():
    """Both packages after STEPS steps: per-step metrics, final state and
    each step's clipped gradients as {port name: numpy array}. JAX's are
    read back from its first moment: optax computes mu_t = (1-b1) g_t +
    b1 mu_{t-1}, so g_t = (mu_t - b1 mu_{t-1}) / (1-b1), in fp64."""
    import jax
    import jax.numpy as jnp

    import timm_tpu
    from timm_tpu.kernels.fused_adamw import _find_adam_states
    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.models._helpers import model_state_dict
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.task import ClassificationTask as JTask
    from timm_tpu.utils.serialization import flatten_pytree

    jm = timm_tpu.create_model('vit_tiny_patch16_224', img_size=32, num_classes=10,
                               drop_path_rate=0.0)
    weights = model_state_dict(jm)
    jtask = JTask(jm, optimizer=jopt(jm, opt='adamw', lr=1e-3, weight_decay=0.05),
                  mesh=create_mesh(jax.devices()[:1]), train_loss_fn=JLS(0.1), clip_grad=1.0,
                  nonfinite_guard=False)
    jtask.setup_ema(decay=0.999)
    task = _port_task(weights)
    def port_names(flat):
        return {k: v.numpy() for k, v in convert_jax_state_dict(flat).items()}

    opt = task.optimizer
    jax_metrics, port_metrics, jax_grads, port_grads, emas = [], [], [], [], []
    mu_prev = None
    for step, b in enumerate(_batches(STEPS), start=1):
        jm_ = jtask.train_step({k: jnp.asarray(v) for k, v in b.items()}, lr=LR, step=step)
        jax_metrics.append([float(jm_['loss']), float(jm_['grad_norm'])])
        pm = task.train_step(b, lr=LR, step=step)
        port_metrics.append([float(pm['loss']), float(pm['grad_norm'])])
        emas.append(task.ema.get_decay(step))
        scale = clip_scale(pm['grad_norm'], 1.0)
        port_grads.append({k: (v * scale).numpy() for k, v in opt.views(opt.flat_grad).items()})
        mu = {k: v.astype(np.float64)
              for k, v in port_names(flatten_pytree(_find_adam_states(jtask.opt_state)[0].mu)).items()}
        jax_grads.append({k: ((v if mu_prev is None else v - B1 * mu_prev[k]) / (1 - B1))
                          .astype(np.float32) for k, v in mu.items()})
        mu_prev = mu

    adam = _find_adam_states(jtask.opt_state)[0]
    return types.SimpleNamespace(
        task=task, jtask=jtask, metrics=(np.array(port_metrics), np.array(jax_metrics)),
        state={
            'params': ({k: v.detach().numpy() for k, v in task.model.state_dict().items()},
                       port_names(model_state_dict(jm))),
            'mu': ({k: v.numpy() for k, v in opt.views(opt.m).items()},
                   port_names(flatten_pytree(adam.mu))),
            'nu': ({k: v.numpy() for k, v in opt.views(opt.v).items()},
                   port_names(flatten_pytree(adam.nu))),
            'ema': ({k: v.numpy() for k, v in task.ema_params.items()},
                    port_names(flatten_pytree(jtask.ema_params))),
        },
        count=(int(opt.count), int(adam.count)), start=port_names(weights),
        grads=(port_grads, jax_grads), ema_decays=emas)


def _first_step_gap(dryrun):
    """AdamW's first update moves each parameter by -lr (g / (|g| + eps))
    (+ decay, the same in both): the difference the two packages' own
    step-1 gradients make, per port name."""
    (g_port, *_), (g_jax, *_) = dryrun.grads
    u = {k: [g.astype(np.float64) / (np.abs(g.astype(np.float64)) + EPS) for g in (g_port[k], g_jax[k])]
         for k in g_jax}
    return {k: -LR * (up - uj) for k, (up, uj) in u.items()}


def test_dryrun_losses_and_grad_norms_match_jax(dryrun):
    ours, ref = dryrun.metrics
    assert ours.shape == (STEPS, 2) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    assert dryrun.count == (STEPS, STEPS)


def test_dryrun_first_step_grads_match_jax(dryrun):
    """The clipped gradients of step 1, at the same weights on the same
    batch: within 1e-5 relative L2 on every leaf, and every element within
    1e-5 of its leaf's largest magnitude."""
    (ours, *_), (ref, *_) = dryrun.grads
    assert set(ours) == set(ref)
    print(f'step-1 grads: largest leaf relative L2 {max(_rel(ours[k], ref[k]) for k in ref):.3g}')
    for k in ref:
        assert _rel(ours[k], ref[k]) <= 1e-5, k
        assert np.abs(ours[k] - ref[k]).max() <= 1e-5 * np.abs(ref[k]).max(), k


def test_port_adamw_on_jax_gradients_matches_jax(dryrun):
    """The port's AdamW + EMA fed JAX's own clipped gradients of each step,
    from the same start weights: params and EMA within 1e-6 max abs on
    every element of JAX's after STEPS steps; m and v within 1e-6 of each
    leaf's largest magnitude. What is left of the packages' difference is
    then in the gradients (test_dryrun_state_matches_jax)."""
    opt = dryrun.task.optimizer
    flat = {}
    for name in ('p', 'g', 'm', 'v'):
        flat[name] = torch.zeros_like(opt.flat_param)
    for k, view in opt.views(flat['p']).items():
        view.copy_(torch.from_numpy(dryrun.start[k]))
    ema, count = flat['p'].clone(), torch.zeros((), dtype=torch.int32)
    for g_step, decay in zip(dryrun.grads[1], dryrun.ema_decays):
        for k, view in opt.views(flat['g']).items():
            view.copy_(torch.from_numpy(g_step[k]))
        fused_adamw_reference(flat['p'], flat['g'], flat['m'], flat['v'], ema, count, lr=LR,
                              b1=B1, b2=B2, eps=EPS, weight_decay=0.05, n_decay=opt.n_decay,
                              ema_decay=decay)
    got = {'params': flat['p'], 'mu': flat['m'], 'nu': flat['v'], 'ema': ema}
    for what, buf in got.items():
        ours, ref = {k: v.numpy() for k, v in opt.views(buf).items()}, dryrun.state[what][1]
        scale = {k: 1.0 if what in ('params', 'ema') else np.abs(ref[k]).max() for k in ref}
        print(f'{what} on JAX gradients: max |port - JAX| / scale '
              f'{max(np.abs(ours[k] - ref[k]).max() / scale[k] for k in ref):.3g}')
        for k in ref:
            assert np.abs(ours[k] - ref[k]).max() <= 1e-6 * scale[k], (what, k)


@pytest.mark.parametrize('what', ['params', 'mu', 'nu', 'ema'])
def test_dryrun_state_matches_jax(dryrun, what):
    """The packages' own trajectories after STEPS steps.

    m and v: within 5e-5 relative L2 on every leaf. Steps 2 and 3 take their
    gradients at weights that already differ (below), so m and v differ
    by more than the step-1 gradients' 1e-6.

    Params and EMA: every element within 1e-5, and the update p - p0 within
    1e-5 relative L2, once the difference AdamW's first update makes from
    the two packages' own step-1 gradients is taken out. That update is
    -lr g / (|g| + eps): where |g| is near eps (1e-10 to 1e-8 here, while a
    leaf's largest is about 5e-3), fp32 rounding differences of 1e-10 in g
    change it by up to lr, and move a few dozen of the 5.5 M parameters by
    more than 1e-5. Fed the same gradients, the port's AdamW and EMA agree
    with JAX's to 1e-6 (test_port_adamw_on_jax_gradients_matches_jax)."""
    ours, ref = dryrun.state[what]
    assert set(ours) == set(ref)
    if what in ('mu', 'nu'):
        print(f'{what}: largest leaf relative L2 {max(_rel(ours[k], ref[k]) for k in ref):.3g}')
        for k in ref:
            assert _rel(ours[k], ref[k]) <= 5e-5, k
        return
    gap, start = _first_step_gap(dryrun), dryrun.start
    (g_port, *_), (g_jax, *_) = dryrun.grads
    far = {k: np.abs(ours[k] - ref[k]) > 1e-5 for k in ref}
    g_far = np.concatenate([np.abs(g_jax[k][far[k]]) for k in ref])
    dg_far = np.concatenate([np.abs(g_port[k] - g_jax[k])[far[k]] for k in ref])
    print(f'{what}: {int(sum(f.sum() for f in far.values()))} elements beyond 1e-5, max '
          f'{max(np.abs(ours[k] - ref[k]).max() for k in ref):.3g}; there, step-1 |g| '
          f'{g_far.min() if g_far.size else 0:.3g}-{g_far.max() if g_far.size else 0:.3g} and '
          f'|g_port - g_jax| up to {dg_far.max() if dg_far.size else 0:.3g}; after taking out '
          f'the step-1 gap: max {max(np.abs(ours[k] - ref[k] - gap[k]).max() for k in ref):.3g}')
    for k in ref:
        assert np.abs(ours[k] - ref[k] - gap[k]).max() <= 1e-5, k
    upd = np.concatenate([(ours[k] - gap[k] - start[k]).ravel() for k in ref])
    upd_ref = np.concatenate([(ref[k] - start[k]).ravel() for k in ref])
    assert _rel(upd, upd_ref) <= 1e-5


def test_dryrun_eval_step_with_and_without_ema(dryrun):
    task = dryrun.task
    x = _batches(1)[0]['input']
    live = task.eval_step({'input': x})
    ema = task.eval_step({'input': x}, use_ema=True)
    assert live.shape == ema.shape == (4, 10) and task.model.training
    tm = timm_tpu_torch.create_model('vit_tiny_patch16_224', img_size=32, num_classes=10,
                                     device='cpu').eval()
    tm.load_state_dict(task.ema_params)
    with torch.no_grad():
        assert torch.equal(ema, tm(torch.from_numpy(x)))


# ---- the non-finite guard ----------------------------------------------------

def test_nan_batch_skips_the_step_and_counts_like_jax(dryrun):
    import jax.numpy as jnp

    from timm_tpu.resilience import new_sentinel_state, update_sentinel_state
    task = _port_task({k: v.detach().numpy() for k, v in dryrun.task.model.state_dict().items()},
                      nonfinite_guard=True, nonfinite_tolerance=3)
    opt = task.optimizer
    good, bad = _batches(2)
    bad = dict(bad, input=np.full_like(bad['input'], np.nan))
    jstate = new_sentinel_state()
    task.train_step(good, lr=1e-3, step=1)
    jstate = update_sentinel_state(jstate, jnp.asarray(True))
    before = [t.clone() for t in (opt.flat_param, opt.m, opt.v, opt.ema, opt.count)]
    for step, (b, ok) in enumerate([(bad, False), (bad, False), (good, True), (bad, False)], 2):
        m = task.train_step(b, lr=1e-3, step=step)
        jstate = update_sentinel_state(jstate, jnp.asarray(ok))
        assert [int(m['nonfinite_count']), int(m['nonfinite_total'])] == np.asarray(jstate).tolist()
        assert bool(m['nonfinite']) == (not ok)
        if step == 2:  # the first bad step committed nothing
            after = (opt.flat_param, opt.m, opt.v, opt.ema, opt.count)
            assert all(torch.equal(a, b) for a, b in zip(after, before))
    assert int(opt.count) == 2
    with pytest.raises(NonFiniteError):
        for step in range(6, 9):
            task.train_step(bad, lr=1e-3, step=step)
    assert task.sentinel.consecutive == 3 and step == 7


def test_sentinel_polls_like_jax():
    import jax.numpy as jnp

    from timm_tpu.resilience import NonFiniteError as JErr
    from timm_tpu.resilience import NonFiniteSentinel as JSentinel
    ours, ref = NonFiniteSentinel(tolerance=2, check_every=2), JSentinel(tolerance=2, check_every=2)
    for counts in ([0, 0], [1, 1], [2, 2]):
        raised = []
        for s, state in ((ours, torch.tensor(counts, dtype=torch.int32)),
                         (ref, jnp.asarray(counts, jnp.int32))):
            try:
                raised.append(s.observe(state))
            except (NonFiniteError, JErr):
                raised.append('raised')
        assert raised[0] == raised[1]


def test_grad_accumulation_averages_microbatches(dryrun):
    """grad_accum_steps=2 on a batch of 4 equals the mean of the two halves'
    gradients, and its loss the mean of their losses."""
    weights = {k: v.detach().numpy() for k, v in dryrun.task.model.state_dict().items()}
    b = _batches(1)[0]
    task = _port_task(weights, grad_accum_steps=2, nonfinite_guard=False)
    task.clip_grad = None
    m = task.train_step(b, lr=0.0, step=1)
    halves = []
    for i in range(2):
        t = _port_task(weights, nonfinite_guard=False)
        t.clip_grad = None
        mi = t.train_step({k: v[2 * i:2 * i + 2] for k, v in b.items()}, lr=0.0, step=1)
        halves.append((float(mi['loss']), t.optimizer.flat_grad.clone()))
    assert abs(float(m['loss']) - (halves[0][0] + halves[1][0]) / 2) <= 1e-6
    np.testing.assert_allclose(task.optimizer.flat_grad.numpy(),
                               ((halves[0][1] + halves[1][1]) / 2).numpy(), atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_train_step_on_card_goes_through_the_kernels():
    """ClassificationTask on the card: one fused_adamw launch and one flash
    launch per block each step, and the card's fp32 step (TF32 off) tracks
    the CPU's loss and gradient norm within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from timm_tpu_torch.kernels import fused_adamw
    assert not torch.backends.cuda.matmul.allow_tf32  # PyTorch's default
    out = {}
    for device in ('cpu', 'cuda'):
        tm = timm_tpu_torch.create_model('test_vit', num_classes=10, seed=0, device=device)
        opt = create_optimizer_v2(tm, opt='adamw', lr=1e-3, weight_decay=0.05)
        task = ClassificationTask(tm, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1),
                                  clip_grad=1.0)
        task.setup_ema(decay=0.999)
        rng = np.random.RandomState(0)
        metrics = []
        for step in range(1, 3):
            f0, a0 = flash_attention.launches, fused_adamw.launches
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):  # the patch conv
                m = task.train_step({'input': rng.rand(4, 160, 160, 3).astype(np.float32),
                                     'target': rng.randint(0, 10, 4)}, lr=1e-3, step=step)
            metrics.append([float(m['loss']), float(m['grad_norm'])])
            if device == 'cuda':
                assert fused_adamw.launches - a0 == 1
                assert flash_attention.launches - f0 == len(tm.blocks)
        out[device] = np.array(metrics)
        assert int(opt.count) == 2
    np.testing.assert_allclose(out['cuda'], out['cpu'], rtol=1e-4, atol=0)


def test_normalize_input_and_value_clipping_in_the_task():
    """normalize_input against the JAX task's (fp32 on the device, cast back
    to the input's dtype); clip_mode='value' clips the gradients the update
    reads."""
    import jax.numpy as jnp

    from timm_tpu.task import TrainingTask as JTask
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    x = np.random.default_rng(10).random((2, 160, 160, 3)).astype(np.float32)
    # the JAX method on the statistics its constructor stores, without the
    # model placement a JAX task would do first
    jtask = types.SimpleNamespace(
        _norm_mean=jnp.asarray(mean, jnp.float32).reshape(1, 1, 1, -1),
        _norm_std=jnp.asarray(std, jnp.float32).reshape(1, 1, 1, -1))
    tm = timm_tpu_torch.create_model('test_vit', num_classes=10, device='cpu')
    opt = create_optimizer_v2(tm, opt='adamw', lr=1e-3)
    task = ClassificationTask(tm, optimizer=opt, mean=mean, std=std, clip_grad=1e-4,
                              clip_mode='value')
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = task.normalize_input({'input': torch.from_numpy(x).to(dt)})['input']
        ref = JTask.normalize_input(jtask, {'input': jnp.asarray(x, jdt)})['input']
        assert ours.dtype == dt
        assert float(np.abs(ours.float().numpy() - np.asarray(ref.astype(jnp.float32))).max()) <= 1e-6
    task.train_step({'input': x, 'target': np.array([1, 2])}, lr=1e-3, step=1)
    assert float(opt.flat_grad.abs().max()) == pytest.approx(1e-4)


def test_changing_lr_and_ema_decay_through_device_scalars_match_jax(dryrun):
    """After the dryrun's steps, 5 more under a cosine schedule with 3 warmup
    steps and the EMA's warmup, so lr and the EMA decay change every step:
    each is written into the optimizer's same two device scalars, the
    losses and grad norms stay within 1e-5 of JAX's, and the EMA follows
    ema' = d ema + (1 - d) p' with each step's d within 1e-6. A value
    baked into the step would show here. Runs last: it moves both tasks on."""
    import jax.numpy as jnp

    from timm_tpu_torch.scheduler import create_scheduler_v2
    task, jtask = dryrun.task, dryrun.jtask
    opt = task.optimizer
    task.ema.use_warmup = jtask.ema.use_warmup = True  # host-side in both: no recompile
    sched, _ = create_scheduler_v2(LR, 'cosine', num_epochs=8, warmup_epochs=3, warmup_lr=1e-6)
    ptrs = (opt.lr_t.data_ptr(), opt.ema_decay_t.data_ptr())
    ours, ref, seen = [], [], set()
    for i, b in enumerate(_batches(STEPS + 5)[STEPS:]):
        step = STEPS + 1 + i
        lr = sched.step(i)[0]
        decay = task.ema.get_decay(step)
        ema_before = opt.ema.clone()
        pm = task.train_step(b, lr=lr, step=step)
        assert float(opt.lr_t) == np.float32(lr) and float(opt.ema_decay_t) == np.float32(decay)
        seen.add((float(opt.lr_t), float(opt.ema_decay_t)))
        d = opt.ema_decay_t
        np.testing.assert_allclose(opt.ema.numpy(), (ema_before * d + opt.flat_param * (1 - d)).numpy(),
                                   atol=1e-6, rtol=0)
        ours.append([float(pm['loss']), float(pm['grad_norm'])])
        jm_ = jtask.train_step({k: jnp.asarray(v) for k, v in b.items()}, lr=lr, step=step)
        ref.append([float(jm_['loss']), float(jm_['grad_norm'])])
    assert len(seen) == 5 and (opt.lr_t.data_ptr(), opt.ema_decay_t.data_ptr()) == ptrs
    np.testing.assert_allclose(np.array(ours), np.array(ref), atol=1e-5, rtol=1e-5)
