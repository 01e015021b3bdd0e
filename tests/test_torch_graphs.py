"""The port's compiled steps (``utils/cuda_graph.py``, ``task/task.py``).

On the CPU the step bodies run eagerly; these tests hold what a CUDA graph
of them needs: the train step's body reads nothing back to the host (a
capture would raise or bake the value in), the sentinel's counters keep
their storage, and each step's metrics are tensors of their own. The
``gpu``-marked tests hold replays against eager steps bit for bit on the
card, and a resume into a fresh task's graph. JAX is imported inside the
tests, so that ``pytest -m gpu`` also collects this file without JAX.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import timm_tpu_torch
from timm_tpu_torch.loss import LabelSmoothingCrossEntropy
from timm_tpu_torch.optim import create_optimizer_v2
from timm_tpu_torch.resilience import new_sentinel_state, update_sentinel_state
from timm_tpu_torch.task import ClassificationTask
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _task(device='cpu', opt='adamw', accum=1, seed=0, drop_path_rate=0.1, loss=None):
    """test_vit at 32 px (2 blocks, 5 tokens), clip 1.0, EMA with warmup,
    the guard on."""
    model = timm_tpu_torch.create_model('test_vit', img_size=32, num_classes=10, seed=seed,
                                        drop_path_rate=drop_path_rate, device=device)
    kw = dict(weight_decay=0.05) if opt == 'adamw' else dict(weight_decay=0.05, momentum=0.9)
    optimizer = create_optimizer_v2(model, opt=opt, lr=1e-3, **kw)
    task = ClassificationTask(model, optimizer=optimizer, grad_accum_steps=accum,
                              train_loss_fn=loss or LabelSmoothingCrossEntropy(0.1), clip_grad=1.0,
                              nonfinite_guard=True, seed=seed)
    task.setup_ema(decay=0.99, warmup=True)
    return task


def _batch(seed, n=4, device='cpu'):
    rng = np.random.default_rng(seed)
    return {'input': torch.from_numpy(rng.random((n, 32, 32, 3), dtype=np.float32)).to(device),
            'target': torch.from_numpy(rng.integers(0, 10, n)).to(device)}


class _NoHostReads(TorchDispatchMode):
    """Fails on what would read a device value back to the host: a scalar
    read (``.item()``, ``float()``, ``bool()``, ``if t:``), an op whose
    output shape depends on the data, a copy to another device."""

    SYNCING = {'aten::_local_scalar_dense', 'aten::nonzero', 'aten::masked_select',
               'aten::_unique2', 'aten::unique_consecutive', 'aten::unique_dim'}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in self.SYNCING:
            raise AssertionError(f'host read in the step body: {name}')
        if name in ('aten::_to_copy', 'aten::copy_'):
            src = args[1] if name == 'aten::copy_' else args[0]
            dst = args[0].device if name == 'aten::copy_' else kwargs.get('device', src.device)
            if isinstance(src, torch.Tensor) and torch.device(dst) != src.device:
                raise AssertionError(f'device copy in the step body: {src.device} -> {dst}')
        return func(*args, **kwargs)


@pytest.mark.parametrize('accum', [1, 2])
def test_train_body_reads_nothing_back_to_the_host(accum, monkeypatch):
    """The body of the train step, as a graph captures it, under a dispatch
    mode that fails on host reads, with ``numpy``, ``tolist`` and ``cpu``
    (which dispatch nothing on the CPU) made to fail too; a negative control
    shows the mode catches a read."""
    task = _task(accum=accum)
    task.optimizer.set_hyperparams(lr=1e-3, ema_decay=task.ema.get_decay(3))
    task.model.train()
    for method in ('numpy', 'tolist', 'cpu', 'item'):
        monkeypatch.setattr(torch.Tensor, method, _raiser(method))
    with _NoHostReads():
        metrics = task._train_body(_batch(0))
        with pytest.raises(AssertionError, match='host read'):
            bool(metrics['loss'] > 0)
    monkeypatch.undo()
    assert set(metrics) == {'loss', 'grad_norm', 'nonfinite', 'nonfinite_count', 'nonfinite_total'}
    assert int(task.optimizer.count) == 1 and np.isfinite(float(metrics['loss']))


@pytest.mark.parametrize('mode', ['const', 'rand', 'pixel'])
def test_augment_program_reads_nothing_back_to_the_host(mode, monkeypatch):
    """The augment program of each erase mode (mixup, 2 erase boxes a row)
    under the same dispatch mode: no host read in the program, the
    epilogue's plain version or the staging."""
    from timm_tpu_torch.data import DeviceAugment
    rng = np.random.default_rng(1)
    b = 6
    batch = {'image': rng.integers(0, 256, (b, 16, 16, 3), dtype=np.uint8),
             'target': rng.integers(0, 10, b), 'lam': rng.uniform(0.2, 1, b).astype(np.float32),
             'use_cutmix': rng.integers(0, 2, b).astype(bool),
             'bbox': np.tile(np.array([[2, 9, 3, 12]], np.int32), (b, 1)),
             'erase_box': np.tile(np.array([[1, 2, 5, 6], [8, 8, 4, 3]], np.int32), (b, 1, 1))}
    if mode == 'rand':
        batch['erase_fill'] = rng.standard_normal((b, 2, 3)).astype(np.float32)
    augment = DeviceAugment((0.5, 0.4, 0.3), (0.2, 0.3, 0.4), re_mode=mode, re_mean=(0.5, 0.4, 0.3),
                            re_std=(0.2, 0.3, 0.4), num_classes=10, smoothing=0.1)
    for method in ('numpy', 'tolist', 'cpu', 'item'):
        monkeypatch.setattr(torch.Tensor, method, _raiser(method))
    with _NoHostReads():
        x, y = augment(batch, epoch=1, step=2)
    monkeypatch.undo()
    assert tuple(x.shape) == (b, 16, 16, 3) and tuple(y.shape) == (b, 10)
    assert bool(torch.isfinite(x).all())


def _raiser(method):
    def fail(*args, **kwargs):
        raise AssertionError(f'host read in the step body: Tensor.{method}')
    return fail


def test_update_sentinel_state_in_place_counts_like_jax():
    import jax.numpy as jnp

    from timm_tpu.resilience import new_sentinel_state as jnew
    from timm_tpu.resilience import update_sentinel_state as jupdate
    state, jstate = new_sentinel_state(), jnew()
    ptr = state.data_ptr()
    for ok in (True, False, False, True, False, False, False, True):
        out = update_sentinel_state(state, torch.tensor(ok))
        jstate = jupdate(jstate, jnp.asarray(ok))
        assert out is state and state.data_ptr() == ptr
        assert state.tolist() == np.asarray(jstate).tolist()


def test_train_step_metrics_are_tensors_of_their_own():
    """Each step returns clones: a later step leaves an earlier step's
    metrics as they were, and none of them is a view of the counters the
    task carries."""
    task = _task()
    bad = _batch(1)
    bad['input'][0, 0, 0, 0] = float('nan')
    first = task.train_step(bad, lr=1e-3, step=1)
    kept = {k: v.clone() for k, v in first.items()}
    second = task.train_step(_batch(2), lr=1e-3, step=2)
    state = task._sentinel_state
    for k, v in first.items():
        torch.testing.assert_close(v, kept[k], rtol=0, atol=0, equal_nan=True)
        assert v.data_ptr() != second[k].data_ptr(), k
        assert v.untyped_storage().data_ptr() != state.untyped_storage().data_ptr(), k
    assert int(first['nonfinite_count']) == 1 and int(second['nonfinite_count']) == 0
    assert int(second['nonfinite_total']) == 1


# ---- on the card --------------------------------------------------------------

def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bit_equal(a, b):
    """torch.equal on the bits, so that NaNs made the same way are equal."""
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def _state(task):
    """Every tensor a train step updates, and the drop generator's state."""
    opt = task.optimizer
    tensors = [opt.flat_param, opt.ema, opt.count, task._sentinel_state] + list(opt.slots().values())
    gen = next(m.generator for m in task.model.modules() if getattr(m, 'generator', None) is not None)
    return [t.clone() for t in tensors] + [gen.get_state()]


def _eager_steps(task, batches, lrs):
    """The train step with its body run eagerly: what the graph replays."""
    out = []
    for step, (b, lr) in enumerate(zip(batches, lrs), start=1):
        task.optimizer.set_hyperparams(lr=lr, ema_decay=task.ema.get_decay(step))
        task.model.train()
        out.append({k: v.clone() for k, v in task._train_body(b).items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('opt,accum', [('adamw', 1), ('adamw', 2), ('sgd', 1), ('muon', 1),
                                       ('nadamw', 1), ('lamb', 1), ('madgrad', 1),
                                       ('laprop', 1), ('mars', 1), ('lookahead_adamw', 1)])
def test_train_replays_equal_eager_steps_on_card(opt, accum):
    """From one state, 6 steps through the graphs (a warm-up, a capture,
    replays) against 6 eager steps of the body: every metric and every
    buffer equal with torch.equal, with lr and the EMA decay changing every
    step and step 4 a non-finite batch the guard skips."""
    _card_or_skip()
    batches = [_batch(10 + i, n=8, device='cuda') for i in range(6)]
    batches[3]['input'][1, 2, 3, 0] = float('nan')
    lrs = [1e-3 * (i + 1) / 6 for i in range(6)]
    runs = []
    for graphed in (False, True):
        task = _task('cuda', opt=opt, accum=accum)
        if graphed:
            metrics = [task.train_step(b, lr=lr, step=s)
                       for s, (b, lr) in enumerate(zip(batches, lrs), start=1)]
            assert task.train_graphs.captures == 1 and task.train_graphs.replays == 5
        else:
            metrics = _eager_steps(task, batches, lrs)
        torch.cuda.synchronize()
        runs.append((metrics, _state(task)))
    (m_eager, s_eager), (m_graph, s_graph) = runs
    for a, b in zip(m_eager, m_graph):
        assert a.keys() == b.keys() and all(_bit_equal(a[k], b[k]) for k in a)
    assert int(m_graph[3]['nonfinite_total']) == 1
    for a, b in zip(s_eager, s_graph):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_eval_replays_equal_eager_forward_on_card():
    """The eval graph, with and without the EMA, equals the eager forward
    bit for bit, at a full and at an odd batch."""
    _card_or_skip()
    task = _task('cuda')
    task.train_step(_batch(0, device='cuda'), lr=1e-3, step=1)
    for n in (8, 5):
        x = _batch(n, n=n, device='cuda')['input']
        for use_ema in (False, True):
            outs = [task.eval_step({'input': x}, use_ema=use_ema) for _ in range(3)]
            task.model.eval()
            with torch.no_grad():
                eager = (torch.func.functional_call(task.model, task.ema_params, (x,))
                         if use_ema else task.model(x))
            task.model.train()
            assert all(torch.equal(o, eager) for o in outs), (n, use_ema)
    assert task.eval_graphs.captures == 4


@pytest.mark.gpu
def test_resume_into_a_fresh_graph_on_card():
    """Steps 1-6 on one task against steps 1-3, a checkpoint, and steps 4-6
    on a fresh task that loaded it (its graph captured after the load):
    the same metrics and state bit for bit."""
    _card_or_skip()
    batches = [_batch(20 + i, n=8, device='cuda') for i in range(6)]
    lrs = [1e-3 * (i + 1) / 6 for i in range(6)]
    whole = _task('cuda')
    m_whole = [whole.train_step(b, lr=lr, step=s) for s, (b, lr) in enumerate(zip(batches, lrs), 1)]
    first = _task('cuda')
    for s in range(3):
        first.train_step(batches[s], lr=lrs[s], step=s + 1)
    ckpt = first.get_checkpoint_state()
    second = _task('cuda', seed=5)
    second.train_step(batches[0], lr=lrs[0], step=1)  # a warm-up before the load
    second.load_checkpoint_state(ckpt)
    second._sentinel_state.copy_(first._sentinel_state)
    m_second = [second.train_step(batches[s], lr=lrs[s], step=s + 1) for s in range(3, 6)]
    assert second.train_graphs.captures == 1 and second.train_graphs.replays == 3
    for a, b in zip(m_whole[3:], m_second):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(_state(whole), _state(second)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_jsd_train_replays_equal_eager_steps_on_card():
    """The JSD loss inside the captured step: 6 steps of 3 splits x 4
    images through the graphs against 6 eager steps of the body, every
    metric and buffer bit for bit."""
    _card_or_skip()
    from timm_tpu_torch.loss import JsdCrossEntropy
    batches = []
    for i in range(6):
        b = _batch(30 + i, n=12, device='cuda')
        b['target'] = b['target'][:4].repeat(3)
        batches.append(b)
    lrs = [1e-3 * (i + 1) / 6 for i in range(6)]
    runs = []
    for graphed in (False, True):
        task = _task('cuda', loss=JsdCrossEntropy(num_splits=3, smoothing=0.1))
        if graphed:
            metrics = [task.train_step(b, lr=lr, step=s)
                       for s, (b, lr) in enumerate(zip(batches, lrs), start=1)]
            assert task.train_graphs.captures == 1 and task.train_graphs.replays == 5
        else:
            metrics = _eager_steps(task, batches, lrs)
        torch.cuda.synchronize()
        runs.append((metrics, _state(task)))
    (m_eager, s_eager), (m_graph, s_graph) = runs
    assert all(np.isfinite(float(m['loss'])) for m in m_graph)
    for a, b in zip(m_eager, m_graph):
        assert a.keys() == b.keys() and all(_bit_equal(a[k], b[k]) for k in a)
    for a, b in zip(s_eager, s_graph):
        assert torch.equal(a, b)
