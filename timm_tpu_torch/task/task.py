"""Training task (counterpart of timm_tpu/task/task.py), one device, no mesh.

The task owns the model, the optimizer, the EMA schedule and the non-finite
guard, and runs the JAX package's train step in eager PyTorch, in the same
order: gradients (averaged over ``grad_accum_steps`` microbatches), the raw
global ``grad_norm``, clipping, the optimizer update, the guard, the EMA.
Two of those happen inside the optimizer's update, because the update is in
place: the norm clip factor scales the gradients inside the AdamW kernel,
and the guard's device flag leaves parameters, moments, step count and EMA
untouched on a bad step, where JAX selects the old values afterwards. The
EMA itself is a buffer of the optimizer, updated in the same pass. No value
is read back to the host except the guard's counters, which the sentinel
polls as in the JAX package.

Checkpoint state (``get_checkpoint_state`` / ``load_checkpoint_state``) and
sharded placement are not ported yet (ROADMAP §A.5).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..layers.drop import set_drop_generator
from ..resilience import (
    NonFiniteSentinel, guard_enabled, new_sentinel_state, tree_all_finite, update_sentinel_state,
)
from ..utils.clip_grad import clip_scale, dispatch_clip_grad, global_grad_norm
from ..utils.model_ema import ModelEmaV3

__all__ = ['TrainingTask']


class TrainingTask:
    def __init__(
            self,
            model: nn.Module,
            optimizer=None,
            grad_accum_steps: int = 1,
            clip_grad: Optional[float] = None,
            clip_mode: str = 'norm',
            mean=None,
            std=None,
            nonfinite_guard: Optional[bool] = None,
            nonfinite_tolerance: Optional[int] = None,
            seed: Optional[int] = None,
    ):
        """``seed``, when given, reseeds the generator the model's drop-path
        and dropout masks draw from."""
        self.model = model
        self.optimizer = optimizer
        self.grad_accum_steps = max(1, grad_accum_steps)
        self.clip_grad = clip_grad
        self.clip_mode = clip_mode
        self.device = next(model.parameters()).device
        if seed is not None:
            set_drop_generator(model, torch.Generator(device=self.device).manual_seed(int(seed)))
        self._nonfinite_guard = guard_enabled(nonfinite_guard)
        self.sentinel = NonFiniteSentinel(nonfinite_tolerance) if self._nonfinite_guard else None
        self._sentinel_state = new_sentinel_state(self.device) if self._nonfinite_guard else None
        if mean is not None:
            self._norm_mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device).reshape(1, 1, 1, -1)
            self._norm_std = torch.as_tensor(1.0 if std is None else std, dtype=torch.float32,
                                             device=self.device).reshape(1, 1, 1, -1)
        else:
            self._norm_mean = self._norm_std = None
        self.ema: Optional[ModelEmaV3] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None

    # -- overridables --------------------------------------------------------
    def loss_forward(self, model: nn.Module, batch: Dict[str, Any]):
        """Return (loss, output). Subclasses implement the objective."""
        raise NotImplementedError

    def eval_forward(self, model: nn.Module, batch: Dict[str, Any]):
        return model(batch['input'])

    def normalize_input(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """(x - mean) / std in fp32 on the device, cast back to x's dtype."""
        if self._norm_mean is None or 'input' not in batch:
            return batch
        x = batch['input']
        y = (x.float() - self._norm_mean) / self._norm_std
        return dict(batch, input=y if x.dtype == torch.float32 else y.to(x.dtype))

    # -- setup ---------------------------------------------------------------
    def setup_ema(self, decay: float = 0.9999, warmup: bool = False, **kwargs):
        """Start the EMA as a copy of the parameters, kept by the optimizer
        in the layout of its flat buffers; ``ema_params`` maps names to it."""
        if self.optimizer is None:
            raise RuntimeError('setup_ema needs the optimizer: the EMA lives in its buffers')
        self.ema = ModelEmaV3(decay=decay, use_warmup=warmup, **kwargs)
        self.ema_params = self.optimizer.init_ema()

    # -- steps -----------------------------------------------------------------
    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                if not isinstance(v, (int, float)) else v for k, v in batch.items()}

    def train_step(self, batch: Dict[str, Any], lr: float, step: int = 0) -> Dict[str, torch.Tensor]:
        """One optimization step; ``batch['input']`` is NHWC. Returns device
        tensors: ``loss``, ``grad_norm`` and, with the guard on,
        ``nonfinite``, ``nonfinite_count`` and ``nonfinite_total``."""
        if self.optimizer is None:
            raise RuntimeError('TrainingTask.train_step requires an optimizer')
        opt = self.optimizer
        self.model.train()
        batch = self.normalize_input(self._to_device(batch))
        accum = self.grad_accum_steps
        opt.zero_grad()
        if accum > 1:
            # backward sums the microbatch gradients into the flat buffer in
            # order, as the JAX scan adds them; both are then divided by accum
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            for i in range(accum):
                mb = {k: v.reshape(accum, -1, *v.shape[1:])[i]
                      if isinstance(v, torch.Tensor) and v.ndim >= 1 else v
                      for k, v in batch.items()}
                loss_i, _ = self.loss_forward(self.model, mb)
                loss_i.float().backward()
                loss = loss + loss_i.detach().float()
            loss = loss / accum
            grads = opt.sync_grads()
            for g in grads:
                g.div_(accum)
        else:
            loss, _ = self.loss_forward(self.model, batch)
            loss = loss.float()
            loss.backward()
            loss = loss.detach()
            grads = opt.sync_grads()

        grad_norm = global_grad_norm(grads)
        scale = None
        if self.clip_grad is not None:
            if self.clip_mode == 'norm':
                scale = clip_scale(grad_norm, self.clip_grad)  # applied inside the update
            else:
                views = opt.views(opt.flat_grad)
                params = dict(self.model.named_parameters())
                clipped, _ = dispatch_clip_grad(list(views.values()), self.clip_grad,
                                                mode=self.clip_mode,
                                                params=[params[n] for n in views])
                with torch.no_grad():
                    for view, c in zip(views.values(), clipped):
                        view.copy_(c)
        # the guard's flag: the JAX step reduces over loss and the clipped
        # grads; with norm clipping (factor <= 1, NaN from a NaN norm) that
        # is the same flag as over the raw grads
        ok = tree_all_finite(loss, grads) if self._nonfinite_guard else None
        ema_decay = self.ema.get_decay(step) if self.ema is not None else 0.0
        opt.step(lr=lr, grad_scale=scale, ok=ok, ema_decay=ema_decay)

        metrics = {'loss': loss, 'grad_norm': grad_norm}
        if self._nonfinite_guard:
            self._sentinel_state = update_sentinel_state(self._sentinel_state, ok)
            metrics['nonfinite'] = self._sentinel_state[0] > 0
            metrics['nonfinite_count'] = self._sentinel_state[0]
            metrics['nonfinite_total'] = self._sentinel_state[1]
            self.sentinel.observe(self._sentinel_state, step=step)
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any], use_ema: bool = False):
        self.model.eval()
        try:
            batch = self.normalize_input(self._to_device(batch))
            if use_ema and self.ema_params is not None:
                return torch.func.functional_call(
                    self.model, self.ema_params, (batch['input'],), strict=False)
            return self.eval_forward(self.model, batch)
        finally:
            self.model.train()
