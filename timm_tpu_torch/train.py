#!/usr/bin/env python3
"""Training driver of the port: ``python -m timm_tpu_torch.train``.

Counterpart of the root ``train.py`` of the JAX package, with its command
line: the same flags, defaults and two-stage ``--config`` parse. It runs on
``cuda`` unless ``--device cpu`` is given, and raises with no card. On the
card TF32 is off (``_device.use_full_fp32``): an fp32 model's convolutions
and matmuls compute in fp32, as the JAX package's do; ``--amp`` is bf16.

One process, one device. Each update is ``ClassificationTask.train_step``:
for a ViT the flash-attention kernel in every block's forward (a ConvNeXt's
convolutions are cuDNN's, as XLA computes them in JAX), and the fused AdamW +
EMA kernel for the update (``--opt adamw``; ``--fused-update`` requires
that plain AdamW, as the JAX script's does, and otherwise changes nothing,
since the port's plain AdamW step is always that kernel). The other
optimizers (``--opt muon``, 'nadamw', 'lamb', 'madgrad', 'laprop', 'mars',
``lookahead_<name>``, ``--opt-caution``, ``--layer-decay``) update the flat
buffers in plain PyTorch inside the same captured step. Every schedule of
the JAX script runs (``--sched cosine|tanh|step|multistep|plateau|poly``
with cooldown, warmup prefix, noise, cycles and k-decay; plateau steps on
the evaluation metric), and ``--bce-loss`` with ``--bce-sum`` and
``--bce-target-thresh``.
``--naflex-loader`` trains a NaFlexVit (``naflexvit_*``) from token-budget
buckets of variable-resolution images (``data/naflex_loader.py``): one
dict batch of packed patches is one update, the sequence length and batch
size change from batch to batch over ``--naflex-train-seq-lens``, the step
is one CUDA graph per bucket shape, and every attention is the flash
kernel with the batch's key-padding mask; mixup and cutmix are the
loader's variable-size ones, with the soft targets built in
``NaFlexClassificationTask``, and evaluation runs at
``--naflex-max-seq-len``.
With ``--device-augment`` the loader ends in the augment program, one CUDA
graph per batch shape: the augment-epilogue kernel for ``--remode const``,
the torch program for 'rand' and 'pixel' (the default), as in the JAX
package. ``--aa`` takes RandAugment, AutoAugment and AugMix strings;
``--aug-splits N`` with ``--jsd-loss`` trains AugMix with the JSD loss on
host-augmented split batches, and ``--split-bn`` gives every BatchNorm one
set of statistics a split (``layers/split_batchnorm.py``).
Checkpoints are the JAX package's single-file .npz with its SHA-256
manifest (``utils/checkpoint_saver.py``); ``--resume auto`` continues from
the newest valid one, mid-epoch after a SIGTERM, bit for bit on the CPU.

Flags whose feature the port lacks raise ``NotImplementedError`` naming
their ROADMAP item when set away from their defaults (``_UNPORTED``).
``--epoch-repeats``, ``--worker-seeding`` and ``--amp-dtype``, which the
JAX script parses but never reads, raise the same way. One difference from
the JAX script: with ``--device-augment`` the eval batches are normalized
before the eval forward; the JAX script skips that step there (its task's
normalization is off because the augment stage normalizes training
batches), so it evaluates on [0, 1] inputs.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time
from collections import OrderedDict
from datetime import datetime

import numpy as np
import torch

_logger = logging.getLogger('train')


def make_parser():
    parser = argparse.ArgumentParser(description='Training of the PyTorch / CUDA port')
    # dataset
    group = parser.add_argument_group('Dataset parameters')
    group.add_argument('--data-dir', metavar='DIR', default=None, help='path to dataset root')
    group.add_argument('--dataset', metavar='NAME', default='', help='dataset type/scheme')
    group.add_argument('--train-split', metavar='NAME', default='train')
    group.add_argument('--val-split', metavar='NAME', default='validation')
    group.add_argument('--synthetic-data', action='store_true',
                       help='use an on-the-fly synthetic dataset (no --data-dir needed)')
    group.add_argument('--num-classes', type=int, default=None)
    group.add_argument('--class-map', default='', type=str)
    # model
    group = parser.add_argument_group('Model parameters')
    group.add_argument('--model', default='vit_tiny_patch16_224', type=str, metavar='MODEL')
    group.add_argument('--pretrained', action='store_true', default=False)
    group.add_argument('--initial-checkpoint', default='', type=str, metavar='PATH')
    group.add_argument('--resume', default='', type=str, metavar='PATH',
                       help="checkpoint to resume from, or 'auto' to pick the newest valid "
                            "checkpoint/recovery file in the experiment dir (use with --experiment)")
    group.add_argument('--no-resume-opt', action='store_true', default=False)
    group.add_argument('--img-size', type=int, default=None, metavar='N')
    group.add_argument('--in-chans', type=int, default=None, metavar='N')
    group.add_argument('--input-size', default=None, nargs=3, type=int, metavar='N N N')
    group.add_argument('--mean', type=float, nargs='+', default=None, metavar='MEAN')
    group.add_argument('--std', type=float, nargs='+', default=None, metavar='STD')
    group.add_argument('--interpolation', default='', type=str, metavar='NAME')
    group.add_argument('-b', '--batch-size', type=int, default=128, metavar='N')
    group.add_argument('-vb', '--validation-batch-size', type=int, default=None, metavar='N')
    group.add_argument('--model-kwargs', nargs='*', default={}, action=ParseKwargs)
    group.add_argument('--drop', type=float, default=0.0, metavar='PCT')
    group.add_argument('--drop-path', type=float, default=None, metavar='PCT')
    group.add_argument('--grad-accum-steps', type=int, default=1, metavar='N')
    group.add_argument('--grad-checkpointing', action='store_true', default=False)
    group.add_argument('--block-scan', action='store_true', default=False,
                       help='not ported (ROADMAP A.5.7)')
    group.add_argument('--fused-update', action='store_true', default=False,
                       help='requires --opt adamw with no lookahead, caution or layer decay, '
                            "as the JAX script's does; otherwise changes nothing: the port's "
                            'plain AdamW step is always one launch of the fused AdamW + EMA '
                            'CUDA kernel (timm_tpu_torch/kernels/fused_adamw.py)')
    group.add_argument('--distill', default='', type=str, metavar='SPEC',
                       help='not ported (ROADMAP A.5.10)')
    group.add_argument('--device-prefetch', type=int, default=0, metavar='N',
                       help='keep N batches in flight on the device (copies on a side CUDA '
                            'stream, overlapped with the step); 0 disables')
    group.add_argument('--device-augment', action='store_true', default=False,
                       help='run normalize + mixup/cutmix + random-erase on the device (one '
                            'CUDA graph per batch shape: the augment-epilogue kernel for --remode '
                            "const, the torch program for 'rand' and 'pixel'); the host collates "
                            'raw uint8 and only samples augment parameters. Requires '
                            '--grad-accum-steps 1, a real dataset and no --aug-splits; with '
                            '--naflex-loader the host ships [0, 1] patches and the program '
                            'normalizes and fills the erased tokens, one graph per bucket')
    group.add_argument('--naflex-bucket-mode', type=str, default='budget',
                       choices=('budget', 'native'),
                       help='NaFlex seq-len assignment: "budget" schedules random ladder buckets '
                            'under the token budget; "native" puts each image in the smallest '
                            'bucket holding its native grid')
    group.add_argument('--fsdp', type=int, default=0, metavar='N',
                       help='not ported (ROADMAP A.5.11)')
    group.add_argument('--tp', type=int, default=0, metavar='N',
                       help='not ported (ROADMAP A.5.11)')
    group.add_argument('--autotune', action='store_true', default=False,
                       help='not ported (ROADMAP A.5.12)')
    group.add_argument('--autotune-probe-top-k', type=int, default=0, metavar='K',
                       help='not ported (ROADMAP A.5.12)')
    group.add_argument('--amp', action='store_true', default=False,
                       help='bf16 compute (fp32 parameters and optimizer state)')
    group.add_argument('--amp-dtype', default='bfloat16', type=str)
    group.add_argument('--device', default=None, type=str,
                       help="device to run on: 'cuda' (the default) or 'cpu'")
    group.add_argument('--distributed', action='store_true', default=False,
                       help='not ported (ROADMAP A.5.11)')
    # optimizer
    group = parser.add_argument_group('Optimizer parameters')
    group.add_argument('--opt', default='sgd', type=str, metavar='OPTIMIZER')
    group.add_argument('--opt-eps', default=None, type=float, metavar='EPSILON')
    group.add_argument('--opt-betas', default=None, type=float, nargs='+', metavar='BETA')
    group.add_argument('--momentum', type=float, default=0.9, metavar='M')
    group.add_argument('--weight-decay', type=float, default=2e-5)
    group.add_argument('--clip-grad', type=float, default=None, metavar='NORM')
    group.add_argument('--clip-mode', type=str, default='norm')
    group.add_argument('--layer-decay', type=float, default=None)
    group.add_argument('--opt-kwargs', nargs='*', default={}, action=ParseKwargs)
    group.add_argument('--opt-caution', action='store_true', default=False)
    # schedule
    group = parser.add_argument_group('Learning rate schedule parameters')
    group.add_argument('--sched', type=str, default='cosine', metavar='SCHEDULER')
    group.add_argument('--sched-on-updates', action='store_true', default=False)
    group.add_argument('--lr', type=float, default=None, metavar='LR')
    group.add_argument('--lr-base', type=float, default=0.1, metavar='LR')
    group.add_argument('--lr-base-size', type=int, default=256, metavar='DIV')
    group.add_argument('--lr-base-scale', type=str, default='', metavar='SCALE')
    group.add_argument('--lr-noise', type=float, nargs='+', default=None, metavar='pct, pct')
    group.add_argument('--lr-noise-pct', type=float, default=0.67, metavar='PERCENT')
    group.add_argument('--lr-noise-std', type=float, default=1.0, metavar='STDDEV')
    group.add_argument('--lr-cycle-mul', type=float, default=1.0, metavar='MULT')
    group.add_argument('--lr-cycle-decay', type=float, default=0.5, metavar='MULT')
    group.add_argument('--lr-cycle-limit', type=int, default=1, metavar='N')
    group.add_argument('--lr-k-decay', type=float, default=1.0)
    group.add_argument('--warmup-lr', type=float, default=1e-5, metavar='LR')
    group.add_argument('--min-lr', type=float, default=0, metavar='LR')
    group.add_argument('--epochs', type=int, default=300, metavar='N')
    group.add_argument('--epoch-size', type=int, default=0, metavar='N',
                       help='samples per epoch when the loader length is unknown (streaming datasets)')
    group.add_argument('--epoch-repeats', type=float, default=0.0, metavar='N')
    group.add_argument('--start-epoch', default=None, type=int, metavar='N')
    group.add_argument('--decay-milestones', default=[90, 180, 270], type=int, nargs='+', metavar='MILESTONES')
    group.add_argument('--decay-epochs', type=float, default=90, metavar='N')
    group.add_argument('--warmup-epochs', type=int, default=5, metavar='N')
    group.add_argument('--warmup-prefix', action='store_true', default=False)
    group.add_argument('--cooldown-epochs', type=int, default=0, metavar='N')
    group.add_argument('--patience-epochs', type=int, default=10, metavar='N')
    group.add_argument('--decay-rate', '--dr', type=float, default=0.1, metavar='RATE')
    # augmentation / regularization (consumed by the data pipeline)
    group = parser.add_argument_group('Augmentation and regularization parameters')
    group.add_argument('--no-aug', action='store_true', default=False)
    group.add_argument('--scale', type=float, nargs='+', default=[0.08, 1.0], metavar='PCT')
    group.add_argument('--ratio', type=float, nargs='+', default=[3. / 4., 4. / 3.], metavar='RATIO')
    group.add_argument('--hflip', type=float, default=0.5)
    group.add_argument('--vflip', type=float, default=0.0)
    group.add_argument('--color-jitter', type=float, default=0.4, metavar='PCT')
    group.add_argument('--aa', type=str, default=None, metavar='NAME')
    group.add_argument('--reprob', type=float, default=0.0, metavar='PCT')
    group.add_argument('--remode', type=str, default='pixel')
    group.add_argument('--recount', type=int, default=1)
    group.add_argument('--mixup', type=float, default=0.0)
    group.add_argument('--cutmix', type=float, default=0.0)
    group.add_argument('--cutmix-minmax', type=float, nargs='+', default=None)
    group.add_argument('--mixup-prob', type=float, default=1.0)
    group.add_argument('--mixup-switch-prob', type=float, default=0.5)
    group.add_argument('--mixup-mode', type=str, default='batch')
    group.add_argument('--mixup-off-epoch', default=0, type=int, metavar='N')
    group.add_argument('--smoothing', type=float, default=0.1)
    group.add_argument('--train-interpolation', type=str, default='random')
    group.add_argument('--bce-loss', action='store_true', default=False)
    group.add_argument('--bce-sum', action='store_true', default=False)
    group.add_argument('--bce-target-thresh', type=float, default=None)
    group.add_argument('--jsd-loss', action='store_true', default=False)
    group.add_argument('--aug-splits', type=int, default=0,
                       help='Number of augmentation splits (AugMix/JSD; 0 or >=2)')
    group.add_argument('--split-bn', action='store_true',
                       help='Use separate BN statistics per augmentation split')
    # ema
    group = parser.add_argument_group('Model EMA parameters')
    group.add_argument('--model-ema', action='store_true', default=False)
    group.add_argument('--model-ema-decay', type=float, default=0.9998)
    group.add_argument('--model-ema-warmup', action='store_true')
    # misc
    group = parser.add_argument_group('Miscellaneous parameters')
    group.add_argument('--seed', type=int, default=42, metavar='S')
    group.add_argument('--worker-seeding', type=str, default='all')
    group.add_argument('--log-interval', type=int, default=50, metavar='N')
    group.add_argument('--recovery-interval', type=int, default=0, metavar='N')
    group.add_argument('--checkpoint-hist', type=int, default=10, metavar='N')
    group.add_argument('-j', '--workers', type=int, default=4, metavar='N')
    group.add_argument('--output', default='', type=str, metavar='PATH')
    group.add_argument('--experiment', default='', type=str, metavar='NAME')
    group.add_argument('--eval-metric', default='top1', type=str, metavar='EVAL_METRIC')
    group.add_argument('--log-wandb', action='store_true', default=False)
    group.add_argument('--synthetic-len', type=int, default=1024,
                       help='samples per epoch for --synthetic-data')
    # fault tolerance
    group = parser.add_argument_group('Fault tolerance parameters')
    group.add_argument('--fault-inject', default='', type=str, metavar='SPEC',
                       help="arm the fault-injection harness for drills: 'sigterm@N' delivers "
                            'SIGTERM after global update N (timm_tpu_torch/resilience/'
                            'faultinject.py); the other specs are not ported (ROADMAP A.5.4)')
    group.add_argument('--elastic', action='store_true', default=False,
                       help='not ported (ROADMAP A.5.11)')
    group.add_argument('--nonfinite-tolerance', type=int, default=None, metavar='K',
                       help='abort after K consecutive non-finite (NaN/Inf) train steps '
                            '(default: env TIMM_TPU_NONFINITE_TOLERANCE or 3); skipped '
                            'steps commit nothing and are counted in metrics')
    group.add_argument('--no-nonfinite-guard', action='store_true', default=False,
                       help='disable the in-step all-finite check entirely')
    group.add_argument('--nonfinite-rollback', action='store_true', default=False,
                       help='not ported (ROADMAP A.5.11)')
    # NaFlex variable-resolution training
    group = parser.add_argument_group('NaFlex parameters')
    group.add_argument('--naflex-loader', action='store_true', help='token-budget variable-res training')
    group.add_argument('--naflex-train-seq-lens', type=int, nargs='+', default=[128, 256, 576, 784, 1024])
    group.add_argument('--naflex-max-seq-len', type=int, default=576)
    group.add_argument('--naflex-patch-sizes', type=int, nargs='+', default=None,
                       help='patch sizes drawn per batch (budget mode); the projection kernel is '
                            'resampled to each')
    return parser


class ParseKwargs(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, _, v = value.partition('=')
            try:
                kw[key] = json.loads(v)
            except json.JSONDecodeError:
                kw[key] = v
        setattr(namespace, self.dest, kw)


# (flag, its ROADMAP item) for every flag whose feature the port lacks; each
# raises when set away from its default
_UNPORTED = (
    ('pretrained', 'A.5.1: no hub; carry weights with --initial-checkpoint'),
    ('grad_checkpointing', 'A.5.7'), ('block_scan', 'A.5.7'), ('distill', 'A.5.10'),
    ('fsdp', 'A.5.11'), ('tp', 'A.5.11'), ('distributed', 'A.5.11'), ('elastic', 'A.5.11'),
    ('nonfinite_rollback', 'A.5.11'),
    ('autotune', 'A.5.12'), ('autotune_probe_top_k', 'A.5.12'), ('log_wandb', 'A.5.12'),
    ('epoch_repeats', 'A.5.1: the JAX script parses it and never reads it'),
    ('worker_seeding', 'A.5.1: the JAX script parses it and never reads it'),
    ('amp_dtype', 'A.5.7: --amp is bf16; the JAX script parses --amp-dtype and never reads it'),
)


def check_unported(args) -> None:
    """Raise NotImplementedError for the first flag of ``_UNPORTED`` that
    ``args`` (command line or --config) sets away from its default."""
    parser = make_parser()
    for dest, item in _UNPORTED:
        if getattr(args, dest) != parser.get_default(dest):
            flag = '--' + dest.replace('_', '-')
            raise NotImplementedError(f'{flag} is not ported yet (ROADMAP {item})')


def _parse_args(argv=None):
    # two-stage parse: --config YAML sets defaults, the command line overrides
    config_parser = argparse.ArgumentParser(description='Config', add_help=False)
    config_parser.add_argument('-c', '--config', default='', type=str, metavar='FILE')
    args_config, remaining = config_parser.parse_known_args(argv)
    parser = make_parser()
    if args_config.config:
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError('--config needs PyYAML, which is not installed') from e
        with open(args_config.config, 'r') as f:
            parser.set_defaults(**yaml.safe_load(f))
    args = parser.parse_args(remaining)
    # JSON is YAML: args.yaml reads back with yaml.safe_load, and writing it
    # needs no PyYAML
    args_text = json.dumps(vars(args), indent=2, default=str)
    return args, args_text


class SyntheticLoader:
    """Deterministic random image/label batches for smoke runs: the JAX
    script's numpy stream (NHWC float32 in [0, 1), integer labels)."""

    def __init__(self, length, batch_size, img_size, num_classes, seed=0):
        self.length = max(1, length // batch_size)
        self.batch_size = batch_size
        self.img_size = img_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self):
        return self.length

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.length):
            x = rng.rand(self.batch_size, self.img_size, self.img_size, 3).astype(np.float32)
            y = rng.randint(0, self.num_classes, self.batch_size)
            yield x, y


def optimizer_kwargs(args) -> dict:
    """The optimizer factory's arguments from the flags, as the JAX
    package's ``optimizer_kwargs`` reads them."""
    kwargs = dict(opt=args.opt, lr=args.lr, weight_decay=args.weight_decay, momentum=args.momentum)
    if args.opt_eps is not None:
        kwargs['eps'] = args.opt_eps
    if args.opt_betas is not None:
        kwargs['betas'] = args.opt_betas
    if args.layer_decay is not None:
        kwargs['layer_decay'] = args.layer_decay
    kwargs.update(args.opt_kwargs or {})
    if args.opt_caution:
        kwargs['caution'] = True
    return kwargs


def main(argv=None) -> int:
    """Train; returns the exit code (0, or 3 after the non-finite guard's
    abort). A SIGTERM ends the run with a recovery checkpoint and 0."""
    args, args_text = _parse_args(argv)
    if args.naflex_loader and args.distill:
        raise ValueError('--distill does not compose with --naflex-loader '
                         '(the teacher forward expects dense NHWC batches)')
    check_unported(args)

    from ._device import resolve_device, use_full_fp32
    from .data import Mixup, resolve_data_config
    from .data.loader import DevicePrefetcher
    from .loss import (
        BinaryCrossEntropy, JsdCrossEntropy, LabelSmoothingCrossEntropy, SoftTargetCrossEntropy,
    )
    from .models import convert_jax_checkpoint, create_model, is_jax_checkpoint, load_checkpoint
    from .optim import create_optimizer_v2
    from .resilience import (
        FaultInjector, GracefulShutdown, NonFiniteError, TrainingPreempted, load_with_fallback,
        resolve_auto_resume, restore_host_rng,
    )
    from .resilience.durable import atomic_write_bytes
    from .scheduler import create_scheduler_v2, scheduler_kwargs
    from .task import ClassificationTask, NaFlexClassificationTask, Normalize
    from .utils import CheckpointSaver, get_outdir, random_seed, setup_default_logging, update_summary

    if not logging.root.handlers:
        setup_default_logging()
    device = resolve_device(args.device)
    use_full_fp32(device)
    injector = FaultInjector(args.fault_inject)
    random_seed(args.seed, 0)
    _logger.info(f'Training on {device}')

    dtype = torch.bfloat16 if args.amp else None
    model_kwargs = dict(args.model_kwargs)
    if args.drop:
        model_kwargs['drop_rate'] = args.drop
    if args.drop_path is not None:
        model_kwargs['drop_path_rate'] = args.drop_path
    factory_kwargs = dict(num_classes=args.num_classes, in_chans=args.in_chans, dtype=dtype,
                          seed=args.seed, device=device)
    model = None
    if args.img_size is not None:
        try:
            model = create_model(args.model, img_size=args.img_size, **factory_kwargs, **model_kwargs)
        except TypeError as e:
            if 'img_size' not in str(e):
                raise
    if model is None:
        model = create_model(args.model, **factory_kwargs, **model_kwargs)
    if args.initial_checkpoint:
        load_checkpoint(model, args.initial_checkpoint)
    if args.num_classes is None:
        args.num_classes = model.num_classes

    # AugMix splits: each sample comes as (clean, aug1, ...), split-major
    num_aug_splits = 0
    if args.aug_splits > 0:
        if args.aug_splits < 2:
            raise ValueError('--aug-splits: a split of 1 makes no sense')
        num_aug_splits = args.aug_splits
    if args.split_bn:
        # per-split BatchNorm statistics, converted before the optimizer
        # captures the parameters (as the JAX script does)
        if num_aug_splits < 2:
            raise ValueError('--split-bn requires --aug-splits > 1')
        from .layers import convert_splitbn_model
        model = convert_splitbn_model(model, max(num_aug_splits, 2))

    data_config = resolve_data_config(vars(args), model=model, verbose=True)
    img_size = data_config['input_size'][-1]

    # LR from the global batch when --lr is not given
    global_batch_size = args.batch_size * args.grad_accum_steps
    if args.lr is None:
        on = args.opt.lower()
        scale = 'sqrt' if any(o in on for o in ('ada', 'lamb', 'lion')) else 'linear'
        if args.lr_base_scale:
            scale = args.lr_base_scale
        batch_ratio = global_batch_size / args.lr_base_size
        if scale == 'sqrt':
            batch_ratio = batch_ratio ** 0.5
        args.lr = args.lr_base * batch_ratio
        _logger.info(f'LR ({args.lr}) from base ({args.lr_base}) * {scale} batch ratio')

    optimizer = create_optimizer_v2(model, **optimizer_kwargs(args))
    if args.fused_update and not getattr(optimizer, 'fused', False):
        raise ValueError('--fused-update requires a plain adamw optimizer (no lookahead, '
                         f'caution or layer decay); --opt {args.opt} is not one')
    norm_mean, norm_std = data_config['mean'], data_config['std']
    if args.naflex_loader:
        if not args.data_dir:
            raise ValueError('--naflex-loader requires --data-dir')
        norm_mean = norm_std = None  # the NaFlex loader normalizes on the host
    if args.device_augment:
        if args.grad_accum_steps != 1:
            raise ValueError('--device-augment yields device-resident batches; use '
                             '--grad-accum-steps 1')
        if num_aug_splits > 1:
            raise ValueError('--device-augment does not compose with --aug-splits '
                             '(split-batch augmentation collates on host)')
        if not args.naflex_loader and (args.synthetic_data or not args.data_dir):
            raise ValueError('--device-augment needs a real dataset pipeline; '
                             'pass --data-dir (synthetic batches are already floats)')
        # the augment stage normalizes training batches; eval batches are
        # normalized in validate()
        norm_mean = norm_std = None
    task_kwargs = {}
    if args.naflex_loader and (args.mixup > 0 or args.cutmix > 0):
        # smoothing folds into the soft mixed targets
        task_kwargs['mixup_label_smoothing'] = args.smoothing
    task = (NaFlexClassificationTask if args.naflex_loader else ClassificationTask)(
        model,
        optimizer=optimizer,
        grad_accum_steps=args.grad_accum_steps,
        clip_grad=args.clip_grad,
        clip_mode=args.clip_mode,
        mean=norm_mean,
        std=norm_std,
        nonfinite_guard=False if args.no_nonfinite_guard else None,
        nonfinite_tolerance=args.nonfinite_tolerance,
        seed=args.seed,
        **task_kwargs,
    )
    eval_norm = None if norm_mean is not None or args.naflex_loader else \
        Normalize(data_config['mean'], data_config['std'], device)

    if args.jsd_loss:
        if num_aug_splits < 2:
            raise ValueError('--jsd-loss requires --aug-splits > 1')
        train_loss = JsdCrossEntropy(num_splits=num_aug_splits, smoothing=args.smoothing)
    elif args.mixup > 0 or args.cutmix > 0:
        train_loss = BinaryCrossEntropy(
            smoothing=0.0, target_threshold=args.bce_target_thresh, sum_classes=args.bce_sum,
        ) if args.bce_loss else SoftTargetCrossEntropy()
    elif args.smoothing:
        train_loss = BinaryCrossEntropy(
            smoothing=args.smoothing, target_threshold=args.bce_target_thresh,
            sum_classes=args.bce_sum,
        ) if args.bce_loss else LabelSmoothingCrossEntropy(smoothing=args.smoothing)
    else:
        train_loss = LabelSmoothingCrossEntropy(0.0)
    task.train_loss_fn = train_loss

    if args.model_ema:
        task.setup_ema(decay=args.model_ema_decay, warmup=args.model_ema_warmup)

    # data
    if args.naflex_loader:
        from .data.dataset_factory import create_dataset
        from .data.naflex_loader import create_naflex_loader
        patch_size = getattr(getattr(model, 'embeds', None), 'patch_size', 16)
        dataset_train = create_dataset(
            args.dataset, root=args.data_dir, split=args.train_split, is_training=True,
            class_map=args.class_map)
        dataset_eval = create_dataset(
            args.dataset, root=args.data_dir, split=args.val_split, class_map=args.class_map)
        loader_train = create_naflex_loader(
            dataset_train, patch_size=patch_size,
            patch_size_choices=tuple(args.naflex_patch_sizes) if args.naflex_patch_sizes else None,
            train_seq_lens=tuple(args.naflex_train_seq_lens),
            max_seq_len=args.naflex_max_seq_len,
            batch_size=args.batch_size, is_training=True,
            mean=data_config['mean'], std=data_config['std'],
            interpolation=data_config['interpolation'], hflip=args.hflip,
            mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
            mixup_prob=args.mixup_prob, mixup_switch_prob=args.mixup_switch_prob,
            re_prob=args.reprob, re_mode='pixel' if args.remode == 'pixel' else 'const',
            seed=args.seed, grad_accum_steps=args.grad_accum_steps,
            device_augment=args.device_augment, bucket_mode=args.naflex_bucket_mode,
            device_prefetch=args.device_prefetch if args.device_augment else 0, device=device)
        loader_eval = create_naflex_loader(
            dataset_eval, patch_size=patch_size,
            max_seq_len=args.naflex_max_seq_len,
            batch_size=args.validation_batch_size or args.batch_size,
            mean=data_config['mean'], std=data_config['std'],
            interpolation=data_config['interpolation'], seed=args.seed)
        mixup_fn = None  # the NaFlex loader mixes variable-size images itself
    elif args.synthetic_data or not args.data_dir:
        _logger.info('Using synthetic data')
        loader_train = SyntheticLoader(args.synthetic_len, args.batch_size, img_size,
                                       args.num_classes, args.seed)
        loader_eval = SyntheticLoader(max(args.synthetic_len // 4, args.batch_size),
                                      args.validation_batch_size or args.batch_size,
                                      img_size, args.num_classes, args.seed + 1)
        mixup_fn = 'auto'
    else:
        from .data import create_loader
        from .data.dataset_factory import create_dataset
        dataset_train = create_dataset(
            args.dataset, root=args.data_dir, split=args.train_split, is_training=True,
            class_map=args.class_map, num_classes=args.num_classes)
        dataset_eval = create_dataset(
            args.dataset, root=args.data_dir, split=args.val_split, is_training=False,
            class_map=args.class_map, num_classes=args.num_classes)
        if num_aug_splits > 1:
            from .data.dataset import AugMixDataset
            dataset_train = AugMixDataset(dataset_train, num_splits=num_aug_splits)
        train_mixup = None
        if args.device_augment and (args.mixup > 0 or args.cutmix > 0):
            # the parameter sampler only: the pixel and target math runs in
            # the loader's augment stage
            train_mixup = Mixup(
                mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, cutmix_minmax=args.cutmix_minmax,
                prob=args.mixup_prob, switch_prob=args.mixup_switch_prob, mode=args.mixup_mode,
                label_smoothing=args.smoothing, num_classes=args.num_classes, seed=args.seed)
        loader_train = create_loader(
            dataset_train,
            input_size=data_config['input_size'],
            batch_size=args.batch_size,
            is_training=True,
            no_aug=args.no_aug,
            scale=args.scale,
            ratio=args.ratio,
            hflip=args.hflip,
            vflip=args.vflip,
            color_jitter=args.color_jitter,
            auto_augment=args.aa,
            re_prob=args.reprob,
            re_mode=args.remode,
            re_count=args.recount,
            num_aug_splits=num_aug_splits,
            interpolation=args.train_interpolation,
            mean=data_config['mean'],
            std=data_config['std'],
            num_workers=args.workers,
            seed=args.seed,
            device_augment=args.device_augment,
            mixup=train_mixup,
            device_prefetch=args.device_prefetch if args.device_augment else 0,
            device=device,
        )
        loader_eval = create_loader(
            dataset_eval,
            input_size=data_config['input_size'],
            batch_size=args.validation_batch_size or args.batch_size,
            is_training=False,
            interpolation=data_config['interpolation'],
            mean=data_config['mean'],
            std=data_config['std'],
            num_workers=args.workers,
            crop_pct=data_config['crop_pct'],
        )
        mixup_fn = None if args.device_augment else 'auto'

    if mixup_fn == 'auto':
        mixup_fn = None
        if args.mixup > 0 or args.cutmix > 0:
            mixup_fn = Mixup(
                mixup_alpha=args.mixup, cutmix_alpha=args.cutmix, cutmix_minmax=args.cutmix_minmax,
                prob=args.mixup_prob, switch_prob=args.mixup_switch_prob, mode=args.mixup_mode,
                label_smoothing=args.smoothing, num_classes=args.num_classes)

    if args.device_prefetch:
        loader_eval = DevicePrefetcher(loader_eval, size=args.device_prefetch, device=device)
        if not args.device_augment:
            if mixup_fn is None and args.grad_accum_steps == 1:
                loader_train = DevicePrefetcher(loader_train, size=args.device_prefetch,
                                                device=device)
            else:
                _logger.info('--device-prefetch: train loader stays on host '
                             '(mixup or --grad-accum-steps > 1 active); eval loader prefetches')

    steps_per_epoch = len(loader_train)
    if args.naflex_loader:
        # each NaFlex batch is one update: the accumulation splits the
        # accumulation-scaled batch inside the step
        updates_per_epoch = steps_per_epoch
    else:
        updates_per_epoch = (steps_per_epoch + args.grad_accum_steps - 1) // args.grad_accum_steps
    lr_scheduler, num_epochs = create_scheduler_v2(
        base_lr=args.lr,
        **{k: v for k, v in scheduler_kwargs(args).items() if k != 'num_epochs'},
        num_epochs=args.epochs,
        updates_per_epoch=updates_per_epoch,
    )
    start_epoch = 0
    if args.start_epoch is not None:
        start_epoch = args.start_epoch

    # output and saver: made before resume so that `--resume auto` can scan
    # the experiment dir; the saver's constructor sweeps a crash's litter
    exp_name = args.experiment or '-'.join([
        datetime.now().strftime('%Y%m%d-%H%M%S'), args.model, str(img_size)])
    output_dir = get_outdir(args.output if args.output else './output/train', exp_name)
    saver = CheckpointSaver(
        task, args=args, checkpoint_dir=output_dir, recovery_dir=output_dir,
        decreasing=args.eval_metric == 'loss', max_history=args.checkpoint_hist)
    atomic_write_bytes(os.path.join(output_dir, 'args.yaml'), args_text.encode())

    start_batch_idx = 0
    resume_num_updates = None
    resume_path = ''
    if args.resume == 'auto':
        resume_path = resolve_auto_resume(output_dir)
        if not resume_path:
            _logger.info(f'auto-resume: no valid checkpoint under {output_dir}; starting fresh')
    elif args.resume:
        resume_path = args.resume
    if resume_path:
        state, _ck_meta, used_path = load_with_fallback(resume_path, search_dir=output_dir)
        if is_jax_checkpoint(state):
            state = convert_jax_checkpoint(state)
        template = {k for k in task.checkpoint_keys() if not k.startswith('_resume.')}
        loaded = {k for k in state if not k.startswith('_resume.') and k not in ('epoch', 'metric')}
        missing, unexpected = sorted(template - loaded), sorted(loaded - template)
        if missing or unexpected:
            _logger.warning(
                f'Resume state diff: {len(missing)} missing '
                f'{missing[:5] + (["..."] if len(missing) > 5 else [])}, '
                f'{len(unexpected)} unexpected '
                f'{unexpected[:5] + (["..."] if len(unexpected) > 5 else [])}')
        task.load_checkpoint_state(state, strict=False, load_opt=not args.no_resume_opt)
        restore_host_rng(state)
        ck_epoch = int(state['epoch']) if 'epoch' in state else 0
        if state.get('_resume.mid_epoch') is not None and int(state['_resume.mid_epoch']):
            # step-granular recovery: re-enter the same epoch, skip the
            # batches already consumed, continue the update counter
            start_epoch = ck_epoch
            start_batch_idx = int(state['_resume.batches_consumed'])
            if '_resume.batch_size' in state and int(state['_resume.batch_size']) != args.batch_size:
                raise NotImplementedError(
                    f'resuming mid-epoch at batch size {args.batch_size} from a run at '
                    f'{int(state["_resume.batch_size"])}: the loader position conversion is not '
                    'ported yet (ROADMAP A.5.11)')
            resume_num_updates = int(state['_resume.num_updates'])
            _logger.info(
                f'Resumed mid-epoch from {used_path}: epoch {start_epoch}, '
                f'batch {start_batch_idx}, update {resume_num_updates}')
        else:
            if args.start_epoch is None:
                start_epoch = ck_epoch + 1
            _logger.info(f'Resumed from {used_path} at epoch {start_epoch}')

    # prime the scheduler so the first epoch starts at its LR
    if lr_scheduler is not None:
        if args.sched_on_updates:
            lr_scheduler.step_update(resume_num_updates if resume_num_updates is not None
                                     else start_epoch * updates_per_epoch)
        else:
            lr_scheduler.step(start_epoch)
            if resume_num_updates is not None:
                lr_scheduler.step_update(resume_num_updates)

    # SIGTERM / SIGINT set a flag the train loop polls; on preemption a
    # recovery checkpoint is written and the run exits 0
    shutdown = GracefulShutdown().install()
    best_metric = None
    best_epoch = None
    try:
        for epoch in range(start_epoch, num_epochs):
            if shutdown.requested:
                _logger.warning(f'Shutdown requested; stopping before epoch {epoch} '
                                f'(resume with --resume auto)')
                return 0
            if hasattr(loader_train, 'set_epoch'):
                loader_train.set_epoch(epoch)
            if args.mixup_off_epoch and epoch >= args.mixup_off_epoch:
                if mixup_fn is not None:
                    mixup_fn.mixup_enabled = False
                elif getattr(loader_train, 'mixup', None) is not None:
                    loader_train.mixup.mixup_enabled = False
            try:
                train_metrics = train_one_epoch(
                    epoch, task, loader_train, args, lr_scheduler, updates_per_epoch,
                    saver=saver, mixup_fn=mixup_fn, shutdown=shutdown, injector=injector,
                    skip_batches=start_batch_idx if epoch == start_epoch else 0,
                    start_updates=resume_num_updates if epoch == start_epoch else None)
            except TrainingPreempted as e:
                _logger.warning(f'Preempted during epoch {epoch}; recovery checkpoint: '
                                f'{e.recovery_path}. Exiting 0 for reschedule.')
                return 0
            except NonFiniteError as e:
                _logger.error(f'Aborting training: {e}')
                return 3

            eval_metrics = validate(task, loader_eval, args, normalize=eval_norm)
            if task.ema_params is not None:
                ema_metrics = validate(task, loader_eval, args, use_ema=True, normalize=eval_norm)
                eval_metrics.update({f'{k}_ema': v for k, v in ema_metrics.items()})

            update_summary(
                epoch, train_metrics, eval_metrics,
                filename=os.path.join(output_dir, 'summary.csv'),
                lr=train_metrics.get('lr'), write_header=epoch == start_epoch)
            best_metric, best_epoch = saver.save_checkpoint(
                epoch, metric=eval_metrics.get(args.eval_metric))
            if lr_scheduler is not None:
                lr_scheduler.step(epoch + 1, eval_metrics.get(args.eval_metric))
    finally:
        shutdown.uninstall()

    if best_metric is not None:
        _logger.info(f'*** Best metric: {best_metric} (epoch {best_epoch})')
        print(json.dumps({'result': {args.eval_metric: best_metric, 'epoch': best_epoch}}))
    return 0


def _recovery_extras(batches_consumed, num_updates, args=None):
    """Step-granular resume state stored with the task state in a recovery
    checkpoint: loader position, update counter, host RNG streams and the
    batch geometry."""
    from .resilience import capture_host_rng
    extras = {
        '_resume.mid_epoch': np.asarray(1),
        '_resume.batches_consumed': np.asarray(batches_consumed),
        '_resume.num_updates': np.asarray(num_updates),
    }
    if args is not None:
        extras['_resume.batch_size'] = np.asarray(args.batch_size)
        extras['_resume.global_batch'] = np.asarray(args.batch_size * args.grad_accum_steps)
        extras['_resume.device_count'] = np.asarray(1)
        extras['_resume.process_count'] = np.asarray(1)
    extras.update(capture_host_rng())
    return extras


# a NaFlex batch's host scalars, which stay off the step
_NAFLEX_HOST_KEYS = ('seq_len', 'patch_size')


def train_one_epoch(epoch, task, loader, args, lr_scheduler, updates_per_epoch, saver=None,
                    mixup_fn=None, shutdown=None, injector=None, skip_batches=0, start_updates=None):
    from .resilience import TrainingPreempted
    from .utils import AverageMeter
    loss_m = AverageMeter()
    accum = args.grad_accum_steps
    num_updates = start_updates if start_updates is not None else epoch * updates_per_epoch
    lr = lr_scheduler.get_last_lr()[0] if lr_scheduler else args.lr

    def poll_faults_and_shutdown(batch_idx, update_idx):
        """After each committed update: deliver an injected SIGTERM, then
        write a step-granular recovery checkpoint and stop if shutdown was
        requested."""
        if injector and injector.sigterm_at(num_updates - 1):
            _logger.warning(f'[fault-inject] SIGTERM at update {num_updates - 1}')
            os.kill(os.getpid(), signal.SIGTERM)
        if shutdown is not None and shutdown.should_stop(update_idx):
            path = ''
            if saver is not None:
                path = saver.save_recovery(
                    epoch, update_idx,
                    extra_state=_recovery_extras(batch_idx + 1, num_updates, args))
            raise TrainingPreempted(path)

    metrics = {}
    micro_inputs, micro_targets = [], []
    update_idx = skip_batches // accum  # display and recovery cadence carry on after a resume
    samples_since_log = 0
    log_t0 = time.time()
    for batch_idx, batch_data in enumerate(loader):
        if batch_idx < skip_batches:
            continue  # mid-epoch resume: consumed before the preemption
        if isinstance(batch_data, dict):
            # a NaFlex dict batch is one update; its host scalars stay off the
            # step (the model reads the patch size from the patch dim)
            batch = {k: v for k, v in batch_data.items() if k not in _NAFLEX_HOST_KEYS}
            n, seq = int(batch['patches'].shape[0]), f'seq: {batch_data["seq_len"]} '
        else:
            input_b, target_b = batch_data
            if mixup_fn is not None:
                input_b, target_b = mixup_fn(input_b, target_b)
            micro_inputs.append(input_b)
            micro_targets.append(target_b)
            if len(micro_inputs) < accum:
                continue
            if accum > 1:  # host batches: --device-augment needs --grad-accum-steps 1
                input_all = np.concatenate(micro_inputs, axis=0)
                target_all = np.concatenate(micro_targets, axis=0)
            else:
                input_all, target_all = micro_inputs[0], micro_targets[0]
            micro_inputs, micro_targets = [], []
            batch = {'input': input_all, 'target': target_all}
            n, seq = input_all.shape[0], ''
        metrics = task.train_step(batch, lr=lr, step=num_updates)
        num_updates += 1
        samples_since_log += n
        if lr_scheduler is not None:
            lr = lr_scheduler.step_update(num_updates)[0]
        if update_idx % args.log_interval == 0:
            loss_val = float(metrics['loss'])  # the one read-back of a logged step
            if np.isfinite(loss_val):  # a skipped non-finite step must not poison the meter
                loss_m.update(loss_val, n=n)
            elapsed = time.time() - log_t0
            ips = samples_since_log / max(elapsed, 1e-9)
            samples_since_log = 0
            log_t0 = time.time()
            nf = int(metrics['nonfinite_total']) if 'nonfinite_total' in metrics else 0
            _logger.info(
                f'Train: {epoch} [{update_idx:>4d}/{updates_per_epoch}] '
                f'Loss: {loss_m.val:#.3g} ({loss_m.avg:#.3g}) LR: {lr:.3e} '
                f'{seq}{ips:.1f} img/s' + (f' NaN-skipped: {nf}' if nf else ''))
        if saver is not None and args.recovery_interval and (update_idx + 1) % args.recovery_interval == 0:
            saver.save_recovery(epoch, update_idx,
                                extra_state=_recovery_extras(batch_idx + 1, num_updates, args))
        poll_faults_and_shutdown(batch_idx, update_idx)
        update_idx += 1
    if micro_inputs:
        # a trailing partial accumulation group: pad by wrapping samples so
        # the step keeps its batch shape
        input_all = np.concatenate(micro_inputs, axis=0)
        target_all = np.concatenate(micro_targets, axis=0)
        full = accum * micro_inputs[0].shape[0]
        if full > input_all.shape[0]:
            reps = -(-full // input_all.shape[0])
            input_all = np.concatenate([input_all] * (reps + 1), axis=0)[:full]
            target_all = np.concatenate([target_all] * (reps + 1), axis=0)[:full]
        metrics = task.train_step({'input': input_all, 'target': target_all}, lr=lr, step=num_updates)
        num_updates += 1
        if lr_scheduler is not None:
            lr = lr_scheduler.step_update(num_updates)[0]
    out = OrderedDict([('loss', loss_m.avg if loss_m.count else float(metrics.get('loss', 0.0))),
                       ('lr', lr)])
    if metrics and 'nonfinite_total' in metrics:
        out['nonfinite_steps'] = int(metrics['nonfinite_total'])
    return out


@torch.no_grad()
def validate(task, loader, args, use_ema=False, normalize=None):
    """Eval loop: loss, top-1 and top-5 through ``eval_metrics``, as
    ``validate`` computes them. ``normalize`` applies to the input when the
    task does not normalize it."""
    from .utils import AverageMeter, eval_metrics
    loss_m = AverageMeter()
    top1_m = AverageMeter()
    top5_m = AverageMeter()
    for batch_data in loader:
        if isinstance(batch_data, dict):
            target_b = batch_data['target']
            n = int(target_b.shape[0])
            output = task.eval_step({k: v for k, v in batch_data.items()
                                     if k not in _NAFLEX_HOST_KEYS + ('target',)}, use_ema=use_ema)
        else:
            input_b, target_b = batch_data
            if normalize is not None:
                input_b = normalize(input_b)
            n = int(input_b.shape[0])
            if n == 0:
                continue
            output = task.eval_step({'input': input_b}, use_ema=use_ema)
        loss, correct1, correct5, _ = eval_metrics(output, target_b)
        loss_m.update(float(loss), n)
        top1_m.update(float(correct1), n)
        top5_m.update(float(correct5), n)
    return OrderedDict([('loss', float(loss_m.avg)), ('top1', float(top1_m.avg)),
                        ('top5', float(top5_m.avg))])


if __name__ == '__main__':
    sys.exit(main())
