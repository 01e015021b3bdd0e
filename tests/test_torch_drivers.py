"""The port's drivers (``python -m timm_tpu_torch.train`` / ``validate`` /
``inference`` / ``avg_checkpoints`` / ``clean_checkpoint``) against the
root scripts of the JAX package on the CPU.

- The SIGTERM resume drill of tests/test_resilience.py through the port:
  an uninterrupted run, a run that SIGTERMs itself after update 3 and a
  ``--resume auto`` run end bit for bit equal, with drop path on. The
  three runs are subprocesses on one torch thread: with several threads,
  this CPU build of torch has given results 1e-6 apart in two processes
  running the same steps (3 of 48 drills), which no resume logic can
  reproduce; on one thread every drill was bit for bit.
- Port ``train`` and the root ``train.py`` with the same argv (synthetic
  data, AdamW, EMA, one epoch of 8 updates from the same initial weights,
  eval): summary losses within 1e-4 relative, equal eval top-1, and the
  final parameters within 1e-5 after conversion, at AdamW eps 1e-6. At
  optax's default 1e-8 the same holds once the step-1 gap is taken out:
  AdamW's first update is -lr g / (|g| + eps), and where |g| is near eps,
  fp32 rounding differences of 1e-10 in the two packages' gradients change
  it by up to lr (on one core here one element of 134 k ended 2.5e-5
  apart after 8 updates, 5.8e-6 with the gap out). Each driver's step-1
  gradient comes from a one-update run's first moment, m_1 = (1 - b1) g_1,
  as tests/test_torch_train.py reads JAX's.
- Port ``validate`` on the JAX-written checkpoint matches the root
  ``validate.py`` on a 12-image folder (loss within 1e-5, equal top-1);
  port ``inference`` writes the root ``inference.py``'s top-k rows.
- Port ``avg_checkpoints`` and ``clean_checkpoint`` on the JAX files equal
  the root scripts' outputs after conversion (clean exactly, avg within
  1e-7).

The root scripts run in this process, JAX imported inside fixtures.
"""
import csv
import glob
import importlib.util
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = ['--device', 'cpu', '--synthetic-data', '--model', 'test_vit', '--img-size', '32',
          '-b', '8', '--synthetic-len', '64', '--epochs', '1', '--workers', '1']


@pytest.fixture(autouse=True, scope='module')
def _restore_process_state():
    """The drivers run in this process seed the global RNGs, set JAX's
    global mesh and add logging handlers; put all of it back for the test
    files that run after this one in the same process."""
    import logging
    import random

    import torch

    import timm_tpu.parallel.mesh as jax_mesh
    saved = (random.getstate(), np.random.get_state(), torch.get_rng_state(),
             jax_mesh._GLOBAL_MESH, set(logging.root.handlers), logging.root.level)
    yield
    random.setstate(saved[0])
    np.random.set_state(saved[1])
    torch.set_rng_state(saved[2])
    jax_mesh._GLOBAL_MESH = saved[3]
    for h in list(logging.root.handlers):  # the drivers' console handlers
        if h not in saved[4] and type(h.formatter).__name__ == 'FormatterNoInfo':
            logging.root.removeHandler(h)
    logging.root.setLevel(saved[5])


def _root_script(name):
    spec = importlib.util.spec_from_file_location(f'_root_{name}', os.path.join(REPO_ROOT, f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _call_root_main(name, argv):
    """Run a root script's main() in this process with ``argv``; signal
    handlers it installs are put back."""
    module = _root_script(name)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    old_argv = sys.argv
    sys.argv = [f'{name}.py'] + list(argv)
    try:
        return module, module.main()
    finally:
        sys.argv = old_argv
        for s, h in handlers.items():
            signal.signal(s, h)


def _load(path, prefixes=('state_dict.', 'state_dict_ema.', 'optimizer.')):
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files if k.startswith(prefixes)}


def _summary(path):
    with open(path) as f:
        return next(csv.DictReader(f))


# ---- the SIGTERM drill -------------------------------------------------------------

def _port_train(out_dir, experiment, *extra):
    cmd = [sys.executable, '-m', 'timm_tpu_torch.train', *COMMON,
           '--opt', 'sgd', '--lr', '0.05', '--sched', 'cosine', '--warmup-epochs', '0',
           '--log-interval', '50', '--drop-path', '0.1', '--output', str(out_dir),
           '--experiment', experiment, *extra]
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=240)


def test_sigterm_resume_parity(tmp_path):
    r = _port_train(tmp_path, 'base')
    assert r.returncode == 0, r.stderr[-2000:]
    r = _port_train(tmp_path, 'pre', '--fault-inject', 'sigterm@3')
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'recovery-0-3.npz' in os.listdir(tmp_path / 'pre'), r.stderr[-2000:]
    state = np.load(tmp_path / 'pre' / 'recovery-0-3.npz')
    assert int(state['_resume.num_updates']) == 4 and '_resume.drop_rng_state' in state.files
    r = _port_train(tmp_path, 'pre', '--resume', 'auto')
    assert r.returncode == 0, r.stderr[-2000:]
    assert 'Resumed mid-epoch' in r.stderr

    base = _load(tmp_path / 'base' / 'last.npz')
    resumed = _load(tmp_path / 'pre' / 'last.npz')
    assert set(base) == set(resumed) and any(k.startswith('optimizer.trace.') for k in base)
    mismatched = [k for k in base if not np.array_equal(base[k], resumed[k])]
    assert not mismatched, f'{len(mismatched)} tensors differ after resume: {mismatched[:5]}'
    assert not [n for n in os.listdir(tmp_path / 'pre') if n.startswith('recovery-')]


# ---- port train vs the root train.py ---------------------------------------------------

def _train_both(out, init, suffix, *extra):
    """The root train.py and port train, AdamW with EMA from the same
    initial weights, into ``jax<suffix>`` and ``port<suffix>``."""
    from timm_tpu_torch import train as port_train
    argv = COMMON + ['--num-classes', '10', '--opt', 'adamw', '--lr', '1e-3',
                     '--weight-decay', '0.05', '--clip-grad', '1.0', '--warmup-epochs', '0',
                     '--model-ema', '--model-ema-decay', '0.9', '--no-nonfinite-guard',
                     '--log-interval', '1', '--initial-checkpoint', init, '--output', str(out),
                     *extra]
    _call_root_main('train', argv + ['--experiment', 'jax' + suffix])
    assert port_train.main(argv + ['--experiment', 'port' + suffix]) == 0


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Both drivers, one epoch of 8 AdamW updates with EMA from the same
    JAX-made initial weights; and a 12-image folder."""
    import timm_tpu
    from timm_tpu.models._helpers import model_state_dict, save_state_dict
    out = tmp_path_factory.mktemp('drivers')
    init = str(out / 'init.npz')
    save_state_dict(model_state_dict(timm_tpu.create_model('test_vit', img_size=32, num_classes=10)),
                    init)
    _train_both(out, init, '', '--opt-eps', '1e-6')

    from PIL import Image
    rng = np.random.default_rng(0)
    folder = out / 'images'
    for c in range(2):
        os.makedirs(folder / 'validation' / f'class{c}')
        for i in range(6):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
                folder / 'validation' / f'class{c}' / f'{i}.png')
    return out, init, str(folder)


def _summaries_and_states(out, suffix):
    """Both drivers' summary rows match (losses within 1e-4 relative, equal
    top-1); returns their last.npz states in the port's names."""
    from timm_tpu_torch.models import convert_jax_checkpoint
    jax_row = _summary(out / f'jax{suffix}' / 'summary.csv')
    port_row = _summary(out / f'port{suffix}' / 'summary.csv')
    assert list(jax_row) == list(port_row)
    for key in ('train_loss', 'eval_loss', 'eval_loss_ema'):
        assert abs(float(port_row[key]) - float(jax_row[key])) <= 1e-4 * abs(float(jax_row[key])), key
    assert port_row['eval_top1'] == jax_row['eval_top1']
    assert port_row['eval_top1_ema'] == jax_row['eval_top1_ema']
    jax_state = convert_jax_checkpoint(_load(out / f'jax{suffix}' / 'last.npz'))
    port_state = _load(out / f'port{suffix}' / 'last.npz')
    weights = {k for k in jax_state if k.startswith(('state_dict.', 'state_dict_ema.'))}
    assert weights == {k for k in port_state if k.startswith(('state_dict.', 'state_dict_ema.'))}
    return jax_state, port_state


def test_port_train_matches_root_train(trained):
    out, _, _ = trained
    jax_state, port_state = _summaries_and_states(out, '')
    for k in jax_state:
        if k.startswith(('state_dict.', 'state_dict_ema.')):
            np.testing.assert_allclose(port_state[k], jax_state[k], rtol=0, atol=1e-5, err_msg=k)
    assert int(port_state['optimizer.count']) == int(jax_state['optimizer.count']) == 8


def test_port_train_matches_root_train_at_default_eps(trained):
    """AdamW at eps 1e-8: params within 1e-5 of JAX's once the step-1 gap
    -lr (g_port / (|g_port| + eps) - g_jax / (|g_jax| + eps)) is taken out;
    the EMA, a convex combination of the parameters' trajectories, within
    |gap| + 1e-5."""
    from timm_tpu_torch.models import convert_jax_checkpoint
    out, init, _ = trained
    lr, b1, eps = 1e-3, 0.9, 1e-8
    _train_both(out, init, '_eps_one_update', '--synthetic-len', '8')
    _train_both(out, init, '_eps')
    jax_state, port_state = _summaries_and_states(out, '_eps')
    assert int(port_state['optimizer.count']) == int(jax_state['optimizer.count']) == 8
    first = {'jax': convert_jax_checkpoint(_load(out / 'jax_eps_one_update' / 'last.npz')),
             'port': _load(out / 'port_eps_one_update' / 'last.npz')}
    assert int(first['port']['optimizer.count']) == int(first['jax']['optimizer.count']) == 1
    for k in jax_state:
        if not k.startswith('state_dict.'):
            continue
        name = k[len('state_dict.'):]
        u = [g / (np.abs(g) + eps) for g in
             (first[w][f'optimizer.mu.{name}'].astype(np.float64) / (1 - b1) for w in ('port', 'jax'))]
        gap = -lr * (u[0] - u[1])
        diff = port_state[k].astype(np.float64) - jax_state[k]
        assert np.abs(diff - gap).max() <= 1e-5, k
        ema = f'state_dict_ema.{name}'
        assert (np.abs(port_state[ema].astype(np.float64) - jax_state[ema]) <= np.abs(gap) + 1e-5).all(), ema


def _record_meters(monkeypatch):
    """Make the root validate.py's AverageMeters visible: its loss meter
    is the first one it builds."""
    import timm_tpu.utils
    made = []

    class Recording(timm_tpu.utils.AverageMeter):
        def __init__(self):
            super().__init__()
            made.append(self)
    monkeypatch.setattr(timm_tpu.utils, 'AverageMeter', Recording)
    return made


@pytest.mark.parametrize('use_ema', [False, True], ids=['weights', 'ema'])
def test_port_validate_matches_root_validate(trained, monkeypatch, use_ema):
    from timm_tpu_torch import validate as port_validate
    out, _, folder = trained
    argv = ['--device', 'cpu', '--model', 'test_vit', '--img-size', '32', '--num-classes', '10',
            '--checkpoint', str(out / 'jax' / 'last.npz'), '-b', '8', '--workers', '1', folder]
    argv += ['--use-ema'] if use_ema else []
    root = _root_script('validate')
    made = _record_meters(monkeypatch)
    ref = root.validate(root.parser.parse_args(argv))
    ours = port_validate.validate(port_validate.parser.parse_args(argv))
    assert ours['top1'] == ref['top1'] and ours['top5'] == ref['top5']
    assert abs(ours['loss'] - made[0].avg) <= 1e-5, (ours['loss'], made[0].avg)


def test_port_inference_matches_root_inference(trained, tmp_path):
    from timm_tpu_torch import inference as port_inference
    out, _, folder = trained
    argv = ['--device', 'cpu', '--model', 'test_vit', '--img-size', '32', '--num-classes', '10',
            '--checkpoint', str(out / 'port' / 'last.npz'), '-b', '8', '--workers', '1',
            '--topk', '3', folder]
    assert port_inference.main(argv + ['--output-dir', str(tmp_path / 'port')]) == 0
    # the root script on the same weights, in JAX names
    from timm_tpu_torch.models import load_state_dict
    jax_names = {}
    for k, v in load_state_dict(str(out / 'port' / 'last.npz'), use_ema=False).items():
        base, _, leaf = k.rpartition('.')
        if leaf == 'weight' and v.ndim in (2, 4):
            jax_names[base + '.kernel'] = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        elif leaf == 'weight' and v.ndim == 1:
            jax_names[base + '.scale'] = v
        else:
            jax_names[k] = v
    from timm_tpu.models._helpers import save_state_dict
    jax_file = str(tmp_path / 'jax_names.npz')
    save_state_dict(jax_names, jax_file)
    root_argv = [a if a != str(out / 'port' / 'last.npz') else jax_file for a in argv]
    _call_root_main('inference', root_argv + ['--output-dir', str(tmp_path / 'jax')])
    rows = {}
    for which in ('port', 'jax'):
        with open(tmp_path / which / 'test_vit-results.csv') as f:
            rows[which] = list(csv.DictReader(f))
    assert len(rows['port']) == 12 and list(rows['port'][0]) == list(rows['jax'][0])
    for p, j in zip(rows['port'], rows['jax']):
        assert p['filename'] == j['filename']
        assert [p[f'label_{i}'] for i in range(3)] == [j[f'label_{i}'] for i in range(3)]
        np.testing.assert_allclose([float(p[f'prob_{i}']) for i in range(3)],
                                   [float(j[f'prob_{i}']) for i in range(3)], atol=1e-5)


def test_port_avg_and_clean_match_root_scripts(trained, tmp_path):
    from timm_tpu_torch import avg_checkpoints, clean_checkpoint
    from timm_tpu_torch.models import convert_jax_state_dict, load_state_dict
    out, init, _ = trained
    ckpts = tmp_path / 'ckpts'
    os.makedirs(ckpts)
    shutil.copy(init, ckpts / 'checkpoint-1.npz')
    shutil.copy(out / 'jax' / 'last.npz', ckpts / 'checkpoint-2.npz')
    argv = ['--input', str(ckpts), '-n', '2']
    _call_root_main('avg_checkpoints', argv + ['--output', str(tmp_path / 'jax_avg.npz')])
    assert avg_checkpoints.main(argv + ['--output', str(tmp_path / 'port_avg.npz')]) == 0
    ref = {k: v.numpy() for k, v in convert_jax_state_dict(
        load_state_dict(str(tmp_path / 'jax_avg.npz'), use_ema=False)).items()}
    ours = load_state_dict(str(tmp_path / 'port_avg.npz'))
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-7, err_msg=k)

    argv = ['--checkpoint', str(out / 'jax' / 'last.npz'), '--use-ema']
    _call_root_main('clean_checkpoint', argv + ['--output', str(tmp_path / 'jax_clean.safetensors')])
    assert clean_checkpoint.main(argv + ['--output', str(tmp_path / 'port_clean.safetensors')]) == 0
    (jax_file,) = glob.glob(str(tmp_path / 'jax_clean-*.safetensors'))
    (port_file,) = glob.glob(str(tmp_path / 'port_clean-*.safetensors'))
    ref = {k: v.numpy() for k, v in convert_jax_state_dict(load_state_dict(jax_file)).items()}
    ours = load_state_dict(port_file)
    assert set(ours) == set(ref) and all(np.array_equal(ours[k], ref[k]) for k in ref)


def test_drivers_raise_for_unported_flags_and_without_a_card():
    import torch

    from timm_tpu_torch import inference, train, validate
    for flag, item in (('--fsdp=2', 'A.5.11'), ('--grad-checkpointing', 'A.5.7'),
                       ('--distill=teacher=x', 'A.5.10')):
        with pytest.raises(NotImplementedError, match=item):
            train.main(COMMON + [flag])
    with pytest.raises(ValueError, match='aug-splits'):  # split BN needs the splits
        train.main(COMMON + ['--split-bn'])
    with pytest.raises(ValueError, match='aug-splits'):
        train.main(COMMON + ['--device-augment', '--aug-splits', '3'])
    with pytest.raises(NotImplementedError, match='A.5.4'):
        train.main(COMMON + ['--fault-inject', 'nan_grads@2'])
    with pytest.raises(NotImplementedError, match='A.5.10'):
        validate.main(['--quantize', 'int8', '--device', 'cpu', 'x'])
    with pytest.raises(NotImplementedError, match='A.5.1'):
        inference.main(['--label-type', 'name', '--device', 'cpu', 'x'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            train.main([a for a in COMMON if a not in ('--device', 'cpu')])



def test_train_runs_randaugment_with_augmix_splits_and_jsd(tmp_path):
    """One epoch from a folder of 8 PNGs with ``--aa rand-m2-n1
    --aug-splits 2 --jsd-loss``: 2 updates on 2 x 4 images (the clean
    split and a RandAugment split), a finite JSD loss, a checkpoint."""
    from PIL import Image

    from timm_tpu_torch import train
    rng = np.random.default_rng(0)
    for c in range(2):
        os.makedirs(tmp_path / 'data' / f'class{c}')
        for i in range(4):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
                tmp_path / 'data' / f'class{c}' / f'{i}.png')
    argv = ['--device', 'cpu', '--data-dir', str(tmp_path / 'data'), '--model', 'test_vit',
            '--img-size', '32', '--num-classes', '2', '-b', '4', '--epochs', '1', '--workers', '1',
            '--opt', 'adamw', '--lr', '1e-3', '--aa', 'rand-m2-n1', '--aug-splits', '2',
            '--jsd-loss', '--output', str(tmp_path), '--experiment', 'jsd']
    assert train.main(argv) == 0
    with np.load(tmp_path / 'jsd' / 'last.npz') as d:
        assert int(d['optimizer.count']) == 2
    assert np.isfinite(float(_summary(tmp_path / 'jsd' / 'summary.csv')['train_loss']))


def test_train_grad_accum_flushes_the_partial_group(tmp_path):
    """5 loader batches at --grad-accum-steps 2: two full updates and the
    trailing batch padded into a third, as in the JAX script."""
    from timm_tpu_torch import train
    argv = COMMON + ['--synthetic-len', '40', '--grad-accum-steps', '2', '--opt', 'sgd',
                     '--lr', '0.01', '--output', str(tmp_path), '--experiment', 'accum']
    assert train.main(argv) == 0
    with np.load(tmp_path / 'accum' / 'last.npz') as d:
        assert int(d['optimizer.count']) == 3


@pytest.mark.parametrize('n', [3, 8])
def test_pad_rows_pads_tensors_like_arrays(n):
    """validate and inference pad device-prefetched (tensor) batches: the
    same rows and mask as the numpy path."""
    import torch

    from timm_tpu_torch.serve import pad_rows
    x = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3)
    t = np.arange(n)
    xa, ta, va = pad_rows(x, 8, t)
    xt, tt, vt = pad_rows(torch.from_numpy(x), 8, torch.from_numpy(t))
    assert isinstance(xt, torch.Tensor) and np.array_equal(xt.numpy(), xa)
    assert np.array_equal(tt.numpy(), ta) and np.array_equal(vt, va) and va.sum() == n


def test_accuracy_and_summary_match_jax(tmp_path):
    import torch

    from timm_tpu.utils import accuracy as jax_accuracy
    from timm_tpu.utils import update_summary as jax_summary
    from timm_tpu_torch.utils import accuracy, update_summary
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    logits[:, 3] = logits[:, 7]  # ties break as in JAX's reversed argsort
    target = rng.integers(0, 10, 16)
    assert accuracy(torch.from_numpy(logits), torch.from_numpy(target), topk=(1, 5)) == \
        jax_accuracy(logits, target, topk=(1, 5))
    rows = {}
    for name, fn in (('port', update_summary), ('jax', jax_summary)):
        path = str(tmp_path / f'{name}.csv')
        for epoch in range(2):
            fn(epoch, {'loss': 1.5 - epoch, 'lr': 0.1}, {'loss': 2.0, 'top1': 10.0},
               filename=path, lr=0.1, write_header=epoch == 0)
        with open(path) as f:
            rows[name] = f.read()
    assert rows['port'] == rows['jax']
