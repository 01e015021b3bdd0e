"""Checkpoint retention and recovery, one process, synchronous
(counterpart of timm_tpu/utils/checkpoint_saver.py).

A checkpoint is one .npz holding the task's flat state
(``TrainingTask.get_checkpoint_state``) with ``epoch`` and ``metric``,
written durably with its SHA-256 manifest (resilience/durable.py) and a
``.json`` args sidecar. Retention: ``last`` always, the top ``max_history``
by metric as ``checkpoint-<epoch>``, and ``model_best``. Recovery files
``recovery-<epoch>-<batch>`` keep the newest two; an end-of-epoch checkpoint
prunes those of its epoch and earlier. The constructor sweeps the litter of
a crash: orphaned temp files and recovery files that fail verification.

The asynchronous writer and the sharded multi-process mode of the JAX
package are not ported (ROADMAP A.5.11) and raise.
"""
from __future__ import annotations

import glob
import logging
import operator
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..resilience import (
    atomic_copy, atomic_write_json, atomic_write_npz, manifest_path, remove_checkpoint_files,
    verify_checkpoint,
)

_logger = logging.getLogger(__name__)

__all__ = ['CheckpointSaver']

_RECOVERY_RE = re.compile(r'-(\d+)-(\d+)\.npz$')


class CheckpointSaver:
    def __init__(
            self,
            task,
            args=None,
            checkpoint_prefix: str = 'checkpoint',
            recovery_prefix: str = 'recovery',
            checkpoint_dir: str = '',
            recovery_dir: str = '',
            decreasing: bool = False,
            max_history: int = 10,
            async_writer=None,
            process_index: int = 0,
            process_count: int = 1,
    ):
        if async_writer is not None:
            raise NotImplementedError('the asynchronous checkpoint writer is not ported yet '
                                      '(ROADMAP A.5.11)')
        if int(process_count) > 1:
            raise NotImplementedError('sharded multi-process checkpoints are not ported yet '
                                      '(ROADMAP A.5.11)')
        self.task = task
        self.args = args
        self.checkpoint_files: List[Tuple[str, float]] = []
        self.best_epoch: Optional[int] = None
        self.best_metric: Optional[float] = None
        self.curr_recovery_file = ''
        self.prev_recovery_file = ''

        self.checkpoint_dir = checkpoint_dir
        self.recovery_dir = recovery_dir
        self.save_prefix = checkpoint_prefix
        self.recovery_prefix = recovery_prefix
        self.extension = '.npz'
        self.decreasing = decreasing
        self.cmp = operator.lt if decreasing else operator.gt
        self.max_history = max_history
        assert self.max_history >= 1
        self._cleanup_startup()

    def _cleanup_startup(self):
        """Sweep what a crash left: orphaned temp files of interrupted atomic
        writes (and the legacy ``tmp.npz``) and recovery files that fail
        integrity verification."""
        for d in {self.checkpoint_dir, self.recovery_dir}:
            if not d or not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                path = os.path.join(d, name)
                if name.endswith('.tmp') or name in ('tmp.npz', 'tmp.json'):
                    _logger.info(f'Removing orphaned checkpoint temp file: {path}')
                    self._unlink(path)
                elif name.startswith(self.recovery_prefix) and name.endswith(self.extension):
                    ok, reason = verify_checkpoint(path)
                    if not ok:
                        _logger.warning(f'Removing corrupt recovery file {path}: {reason}')
                        self._unlink(path)
                        self._unlink(manifest_path(path))

    @staticmethod
    def _unlink(path: str):
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def _save(self, save_path: str, epoch: int, metric: Optional[float] = None,
              extra_state: Optional[Dict[str, np.ndarray]] = None):
        state = self.task.get_checkpoint_state()
        state['epoch'] = np.asarray(epoch)
        if metric is not None:
            state['metric'] = np.asarray(metric)
        if extra_state:
            state.update({k: np.asarray(v) for k, v in extra_state.items()})
        meta = {'epoch': epoch, 'metric': metric}
        if extra_state and '_resume.num_updates' in extra_state:
            meta['num_updates'] = int(np.asarray(extra_state['_resume.num_updates']))
        atomic_write_npz(save_path, state, meta=meta)
        if self.args is not None:
            atomic_write_json(save_path.replace(self.extension, '.json'), {
                'epoch': epoch, 'metric': metric, 'arch': getattr(self.args, 'model', None),
                'args': {k: str(v) for k, v in vars(self.args).items()}})

    def save_checkpoint(self, epoch: int, metric: Optional[float] = None):
        assert epoch >= 0
        last_save_path = os.path.join(self.checkpoint_dir, 'last' + self.extension)
        self._save(last_save_path, epoch, metric)
        # an end-of-epoch checkpoint supersedes any mid-epoch recovery of this
        # or an earlier epoch: drop them so `--resume auto` cannot step back
        self._prune_stale_recovery_files(epoch)
        for attr in ('curr_recovery_file', 'prev_recovery_file'):
            m = _RECOVERY_RE.search(getattr(self, attr) or '')
            if m and int(m.group(1)) <= epoch:
                setattr(self, attr, '')

        worst_file = self.checkpoint_files[-1] if self.checkpoint_files else None
        if len(self.checkpoint_files) < self.max_history or metric is None or self.cmp(metric, worst_file[1]):
            if len(self.checkpoint_files) >= self.max_history:
                self._cleanup_checkpoints(1)
            filename = '-'.join([self.save_prefix, str(epoch)]) + self.extension
            save_path = os.path.join(self.checkpoint_dir, filename)
            atomic_copy(last_save_path, save_path)
            self.checkpoint_files.append((save_path, metric))
            self.checkpoint_files = sorted(
                self.checkpoint_files, key=lambda x: x[1] if x[1] is not None else -float('inf'),
                reverse=not self.decreasing)

            checkpoints_str = 'Current checkpoints:\n'
            for c in self.checkpoint_files:
                checkpoints_str += ' {}\n'.format(c)
            _logger.info(checkpoints_str)

            if metric is not None and (self.best_metric is None or self.cmp(metric, self.best_metric)):
                self.best_epoch = epoch
                self.best_metric = metric
                best_save_path = os.path.join(self.checkpoint_dir, 'model_best' + self.extension)
                atomic_copy(last_save_path, best_save_path)
        return (None, None) if self.best_metric is None else (self.best_metric, self.best_epoch)

    def _cleanup_checkpoints(self, trim: int = 0):
        trim = min(len(self.checkpoint_files), trim)
        delete_index = self.max_history - trim
        if delete_index < 0 or len(self.checkpoint_files) <= delete_index:
            return
        to_delete = self.checkpoint_files[delete_index:]
        self.checkpoint_files = self.checkpoint_files[:delete_index]
        for d in to_delete:
            _logger.debug(f'Cleaning checkpoint: {d}')
            remove_checkpoint_files(d[0])

    def save_recovery(self, epoch: int, batch_idx: int = 0,
                      extra_state: Optional[Dict[str, np.ndarray]] = None) -> str:
        filename = '-'.join([self.recovery_prefix, str(epoch), str(batch_idx)]) + self.extension
        save_path = os.path.join(self.recovery_dir, filename)
        self._save(save_path, epoch, extra_state=extra_state)
        prev = self.prev_recovery_file
        if prev and os.path.exists(prev):
            remove_checkpoint_files(prev)
        self.prev_recovery_file = self.curr_recovery_file
        self.curr_recovery_file = save_path
        return save_path

    def _recovery_files(self) -> List[str]:
        """Recovery files newest first by numeric (epoch, batch_idx)."""
        files = glob.glob(os.path.join(self.recovery_dir, self.recovery_prefix) + '*' + self.extension)

        def key(f):
            m = _RECOVERY_RE.search(f)
            return (int(m.group(1)), int(m.group(2))) if m else (-1, -1)

        return sorted(files, key=key, reverse=True)

    def _prune_stale_recovery_files(self, completed_epoch: int):
        for f in self._recovery_files():
            m = _RECOVERY_RE.search(f)
            if m and int(m.group(1)) <= completed_epoch:
                remove_checkpoint_files(f)

    def find_recovery(self) -> str:
        """The newest recovery checkpoint that passes integrity verification."""
        for f in self._recovery_files():
            ok, reason = verify_checkpoint(f)
            if ok:
                return f
            _logger.warning(f'Skipping invalid recovery checkpoint {f}: {reason}')
        return ''
