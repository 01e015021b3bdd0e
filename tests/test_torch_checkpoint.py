"""Checkpoints of the PyTorch port against the JAX package on the CPU.

- A port task (test_vit at 32 px, drop_path 0.1, AdamW, clip, EMA) saved
  after 2 steps and loaded into a fresh task takes a step 3 that is bit for
  bit the uninterrupted step 3: loss, parameters, m, v, EMA, count, and the
  drop-path generator's stream. ``load_opt=False`` loads the weights and
  leaves the optimizer fresh.
- A JAX ClassificationTask checkpoint (AdamW, EMA, clip; written by the JAX
  package's ``atomic_write_npz``) loads into the port exactly after
  conversion, optimizer state included, and the port's step 3 matches JAX's
  step 3 in loss and grad norm within 1e-5.
- The durable layer: JAX's ``verify_checkpoint`` / ``load_verified`` accept
  a file the port wrote and both packages reject a truncated one;
  ``load_with_fallback`` falls back; ``find_checkpoints`` orders a mixed
  directory as JAX's does.
- The same ``save_checkpoint`` / ``save_recovery`` sequence through the
  port's saver and JAX's leaves the same files and returns the same
  (best_metric, best_epoch).

JAX is imported inside fixtures.
"""
import os
import types

import numpy as np
import pytest
import torch

import timm_tpu_torch
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.models import convert_jax_checkpoint, is_jax_checkpoint
from timm_tpu_torch.optim import create_optimizer_v2
from timm_tpu_torch.resilience import (
    CorruptCheckpointError, atomic_write_npz, find_checkpoints, load_verified, load_with_fallback,
    verify_checkpoint,
)
from timm_tpu_torch.task import ClassificationTask
from timm_tpu_torch.utils import CheckpointSaver
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-3


def _batches(n, classes=5, seed=0):
    rng = np.random.RandomState(seed)
    return [{'input': rng.rand(4, 32, 32, 3).astype(np.float32),
             'target': rng.randint(0, classes, 4).astype(np.int64)} for _ in range(n)]


def _port_task(seed, drop_path=0.1, task_seed=3):
    model = timm_tpu_torch.create_model('test_vit', img_size=32, num_classes=5,
                                        drop_path_rate=drop_path, seed=seed, device='cpu')
    opt = create_optimizer_v2(model, opt='adamw', lr=LR, weight_decay=0.05)
    task = ClassificationTask(model, optimizer=opt, train_loss_fn=LabelSmoothingCrossEntropy(0.1),
                              clip_grad=1.0, seed=task_seed, nonfinite_guard=False)
    task.setup_ema(decay=0.99)
    return task


def _opt_state(task):
    opt = task.optimizer
    return [t.clone() for t in (opt.flat_param, opt.m, opt.v, opt.ema, opt.count)]


# ---- the port's own round trip ---------------------------------------------

@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """Two steps, the checkpoint of that point on disk, then step 3 of the
    uninterrupted task."""
    path = str(tmp_path_factory.mktemp('port') / 'step2.npz')
    b1, b2, b3 = _batches(3)
    task = _port_task(seed=0)
    task.train_step(b1, lr=LR, step=1)
    task.train_step(b2, lr=LR, step=2)
    atomic_write_npz(path, task.get_checkpoint_state())
    m3 = task.train_step(b3, lr=LR, step=3)
    return types.SimpleNamespace(path=path, batch=b3, loss=m3['loss'].clone(),
                                 grad_norm=m3['grad_norm'].clone(), state=_opt_state(task))


def test_resume_step_is_bit_identical(port_run):
    """A fresh task (other init seed, other drop generator seed) loaded from
    the step-2 file takes the same step 3, bit for bit."""
    state, _ = load_verified(port_run.path)
    assert '_resume.drop_rng_state' in state and int(state['optimizer.count']) == 2
    task = _port_task(seed=1, task_seed=99)
    params_before = [p.data_ptr() for p in task.model.parameters()]
    task.load_checkpoint_state(state)
    # loaded in place: the parameters are still views of the flat buffer
    assert [p.data_ptr() for p in task.model.parameters()] == params_before
    m3 = task.train_step(port_run.batch, lr=LR, step=3)
    assert torch.equal(m3['loss'], port_run.loss) and torch.equal(m3['grad_norm'], port_run.grad_norm)
    for name, ours, ref in zip(('params', 'm', 'v', 'ema', 'count'), _opt_state(task), port_run.state):
        assert torch.equal(ours, ref), name


def test_resume_without_the_drop_generator_state_diverges(port_run):
    """The generator's state is what makes the step bit for bit: without it
    the drop-path masks of step 3 are drawn from the seed's start."""
    state, _ = load_verified(port_run.path)
    state.pop('_resume.drop_rng_state')
    task = _port_task(seed=1, task_seed=3)
    task.load_checkpoint_state(state)
    m3 = task.train_step(port_run.batch, lr=LR, step=3)
    assert not torch.equal(m3['loss'], port_run.loss)


def test_load_opt_false_keeps_a_fresh_optimizer(port_run):
    state, _ = load_verified(port_run.path)
    task = _port_task(seed=1)
    task.load_checkpoint_state(state, load_opt=False)
    opt = task.optimizer
    weights = {k: v.detach().numpy() for k, v in task.model.named_parameters()}
    assert all(np.array_equal(weights[k], state[f'state_dict.{k}']) for k in weights)
    assert int(opt.count) == 0 and not opt.m.any() and not opt.v.any()
    ema = {k: v.numpy() for k, v in task.ema_params.items()}
    assert all(np.array_equal(ema[k], state[f'state_dict_ema.{k}']) for k in ema)


def test_strict_load_names_the_missing_key(port_run):
    state, _ = load_verified(port_run.path)
    state.pop('optimizer.nu.head.weight')
    task = _port_task(seed=1)
    with pytest.raises(KeyError, match='optimizer.nu.head.weight'):
        task.load_checkpoint_state(state)
    task.load_checkpoint_state(state, strict=False)


# ---- a JAX checkpoint into the port ------------------------------------------

@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A JAX task after 2 steps, its checkpoint written by JAX's
    atomic_write_npz, and its step 3."""
    import jax
    import jax.numpy as jnp

    import timm_tpu
    from timm_tpu.loss import LabelSmoothingCrossEntropy as JLS
    from timm_tpu.optim import create_optimizer_v2 as jopt
    from timm_tpu.parallel import create_mesh
    from timm_tpu.resilience import atomic_write_npz as jax_write
    from timm_tpu.task import ClassificationTask as JTask
    jm = timm_tpu.create_model('test_vit', img_size=32, num_classes=5, drop_path_rate=0.0)
    jtask = JTask(jm, optimizer=jopt(jm, opt='adamw', lr=LR, weight_decay=0.05),
                  mesh=create_mesh(jax.devices()[:1]), train_loss_fn=JLS(0.1), clip_grad=1.0,
                  nonfinite_guard=False)
    jtask.setup_ema(decay=0.99)
    batches = _batches(3, seed=1)
    for step, b in enumerate(batches[:2], start=1):
        jtask.train_step({k: jnp.asarray(v) for k, v in b.items()}, lr=LR, step=step)
    path = str(tmp_path_factory.mktemp('jax') / 'last.npz')
    jax_write(path, dict(jtask.get_checkpoint_state(), epoch=np.asarray(0)))
    m3 = jtask.train_step({k: jnp.asarray(v) for k, v in batches[2].items()}, lr=LR, step=3)
    return types.SimpleNamespace(path=path, batch=batches[2],
                                 metrics=(float(m3['loss']), float(m3['grad_norm'])))


def test_jax_checkpoint_loads_exactly(jax_run):
    state, _ = load_verified(jax_run.path)  # the port's integrity gate on a JAX file
    assert is_jax_checkpoint(state)
    assert any(k.startswith('optimizer.inner_state.0.mu.') for k in state)
    port_state = convert_jax_checkpoint(state)
    task = _port_task(seed=7, drop_path=0.0)
    task.load_checkpoint_state(port_state)
    ours = task.get_checkpoint_state()
    assert int(ours['optimizer.count']) == int(state['optimizer.count']) == 2
    checked = 0
    for key, value in port_state.items():
        if key.startswith(('state_dict.', 'state_dict_ema.', 'optimizer.mu.', 'optimizer.nu.')):
            assert np.array_equal(ours[key], value), key
            checked += 1
    n = len(list(task.model.parameters()))
    assert checked == 4 * n
    # the conversion is the kernel transpose the weights take
    assert np.array_equal(port_state['optimizer.mu.head.weight'],
                          state['optimizer.inner_state.0.mu.head.kernel'].T)


def test_port_step_after_jax_checkpoint_matches_jax(jax_run):
    state, _ = load_verified(jax_run.path)
    task = _port_task(seed=7, drop_path=0.0)
    task.load_checkpoint_state(convert_jax_checkpoint(state))
    m3 = task.train_step(jax_run.batch, lr=LR, step=3)
    np.testing.assert_allclose([float(m3['loss']), float(m3['grad_norm'])], jax_run.metrics,
                               rtol=1e-5, atol=1e-5)


def test_unmapped_jax_key_raises_and_names_itself(jax_run):
    state, _ = load_verified(jax_run.path)
    state['optimizer.inner_state.3.extra'] = np.zeros(2)
    with pytest.raises(ValueError, match='optimizer.inner_state.3.extra'):
        convert_jax_checkpoint(state)


# ---- the durable layer -----------------------------------------------------------

def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {'state_dict.w': rng.standard_normal((3, 4)).astype(np.float32),
            'optimizer.count': np.asarray(5, np.int32), 'epoch': np.asarray(seed)}


def test_jax_verifies_and_loads_a_port_file_and_both_reject_a_torn_one(tmp_path):
    from timm_tpu.resilience import load_verified as jax_load
    from timm_tpu.resilience import verify_checkpoint as jax_verify
    path = str(tmp_path / 'last.npz')
    atomic_write_npz(path, _arrays(1), meta={'epoch': 1})
    assert jax_verify(path) == (True, 'ok') and verify_checkpoint(path) == (True, 'ok')
    jstate, jmeta = jax_load(path)
    assert jmeta == {'epoch': 1} and all(np.array_equal(jstate[k], v) for k, v in _arrays(1).items())
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) // 2)
    assert not jax_verify(path)[0] and not verify_checkpoint(path)[0]
    with pytest.raises(CorruptCheckpointError):
        load_verified(path)


def test_load_with_fallback_takes_the_next_valid_file(tmp_path):
    d = str(tmp_path)
    atomic_write_npz(os.path.join(d, 'checkpoint-0.npz'), _arrays(0), meta={'epoch': 0})
    atomic_write_npz(os.path.join(d, 'last.npz'), _arrays(1), meta={'epoch': 1})
    with open(os.path.join(d, 'last.npz'), 'r+b') as f:
        f.truncate(40)
    state, _, used = load_with_fallback(os.path.join(d, 'last.npz'))
    assert used.endswith('checkpoint-0.npz') and int(state['epoch']) == 0


def test_find_checkpoints_orders_like_jax(tmp_path):
    from timm_tpu.resilience import find_checkpoints as jax_find
    d = str(tmp_path)
    for name, epoch in (('last.npz', 2), ('checkpoint-1.npz', 1), ('checkpoint-2.npz', 2),
                        ('recovery-2-999.npz', 2), ('recovery-2-1000.npz', 2),
                        ('recovery-3-5.npz', 3), ('model_best.npz', 1)):
        atomic_write_npz(os.path.join(d, name), _arrays(epoch), meta={'epoch': epoch})
    ours = [os.path.basename(p) for p in find_checkpoints(d)]
    assert ours == [os.path.basename(p) for p in jax_find(d)]
    assert ours[0] == 'recovery-3-5.npz' and ours.index('recovery-2-1000.npz') < ours.index('recovery-2-999.npz')


# ---- the saver ----------------------------------------------------------------------

class _FakeTask:
    def get_checkpoint_state(self):
        return {'state_dict.w': np.arange(4, dtype=np.float32)}


@pytest.mark.parametrize('decreasing', [False, True], ids=['top1', 'loss'])
def test_saver_sequence_matches_jax(tmp_path, decreasing):
    from timm_tpu.utils import CheckpointSaver as JaxSaver
    args = types.SimpleNamespace(model='test_vit', lr=0.1)
    sequence = [('ckpt', 0, 50.0), ('rec', 1, 3), ('rec', 1, 7), ('rec', 1, 9), ('ckpt', 1, 40.0),
                ('ckpt', 2, 60.0), ('rec', 3, 2), ('ckpt', 3, 55.0), ('ckpt', 4, 45.0)]
    results = {}
    for which, cls in (('port', CheckpointSaver), ('jax', JaxSaver)):
        d = str(tmp_path / which)
        os.makedirs(d)
        # a crash's litter, which the constructor sweeps
        with open(os.path.join(d, '.last.npz.abc.tmp'), 'wb') as f:
            f.write(b'x')
        saver = cls(_FakeTask(), args=args, checkpoint_dir=d, recovery_dir=d,
                    decreasing=decreasing, max_history=2)
        returned = []
        for kind, epoch, x in sequence:
            if kind == 'ckpt':
                returned.append(saver.save_checkpoint(epoch, metric=x))
            else:
                returned.append(os.path.basename(saver.save_recovery(epoch, x)))
        results[which] = (returned, sorted(os.listdir(d)), os.path.basename(saver.find_recovery()))
    assert results['port'] == results['jax']
    assert 'recovery-3-2.npz' not in results['port'][1] and 'last.npz' in results['port'][1]
