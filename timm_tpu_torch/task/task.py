"""Training task (counterpart of timm_tpu/task/task.py), one device, no mesh.

The task owns the model, the optimizer, the EMA schedule and the non-finite
guard, and runs the JAX package's train step in the same order: gradients
(averaged over ``grad_accum_steps`` microbatches), the raw global
``grad_norm``, clipping, the optimizer update, the guard, the EMA. Two of
those happen inside the optimizer's update, because the update is in place:
the norm clip factor scales the gradients inside the update (the AdamW
kernel or the plain optimizers), and the guard's device flag leaves
parameters, optimizer state, step count and EMA untouched on a bad step,
where JAX selects the old values afterwards. The
EMA itself is a buffer of the optimizer, updated in the same pass.

Compiled steps. JAX jits its train and eval steps, always; the port's
counterpart is one CUDA graph per input signature
(``utils/cuda_graph.py``), always on for a task on CUDA. ``train_step`` is
three parts: (a) on the host, the batch is staged into the graph's static
inputs (NumPy batches through pinned memory, device batches by a device
copy) and the learning rate and ``ema.get_decay(step)`` are written into
the optimizer's device scalars; (b) the step body, ``_train_body``, from
``normalize_input`` to the guard's counters, replayed as one graph (on the
CPU it runs eagerly); (c) after the replay, the sentinel polls the counters
on the host and the metrics come back as clones. The first call of an input
signature runs the body eagerly (the warm-up, a real step), the second
captures and replays it, so every call is one step. The body reads nothing
back to the host; the drop-path generator is registered with the graph, so
each replay draws new masks. ``eval_step`` is graphed the same way, one
graph per input signature and ``use_ema``. The graphs hold the addresses of
the parameters and the optimizer's buffers: everything updates in place,
and ``setup_ema`` drops them, as JAX drops its jitted step. Like JAX's,
they bake in the task's configuration (``grad_accum_steps``, clipping).

BatchNorm's running statistics are model state that the forward updates
in place in training mode (``layers/norm.py``), as JAX threads them
through its step: each microbatch of an accumulated step updates them in
turn (JAX's ``lax.scan`` carry), the update is part of the captured graph,
and the guard does not protect them: a non-finite batch leaves parameters,
optimizer state and EMA untouched but its statistics stay, as JAX returns
``new_rest`` unconditionally. The EMA covers parameters only; evaluation
with the EMA weights runs on the live model's statistics, as JAX's does.

Checkpoint state (``get_checkpoint_state`` / ``load_checkpoint_state``) is
the JAX package's single flat dict with its prefixes: ``state_dict.*``,
``state_dict_ema.*``, ``optimizer.*`` and ``model_state.*`` (persistent
buffers: BatchNorm's running statistics) in the port's names and torch
layout (``utils/serialization.py``), plus the drop-path /
dropout generator's state under ``_resume.drop_rng_state``, which JAX does
not need because it keys its dropout streams by step. Loading copies into
the parameters, the running statistics, the optimizer's flat buffers and
scalars and the generator in place, so the graphs survive a resume. ``models/_jax_convert.py`` turns
a JAX task checkpoint into this form. Sharded placement is not ported
(ROADMAP A.5.11).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..layers.drop import get_drop_generator, set_drop_generator
from ..resilience import (
    DROP_RNG_KEY, NonFiniteSentinel, capture_drop_rng, guard_enabled, new_sentinel_state,
    restore_drop_rng, tree_all_finite, update_sentinel_state,
)
from ..utils.serialization import (
    add_prefix, load_module_arrays, module_arrays, persistent_buffers, split_prefix,
)
from ..utils.clip_grad import clip_scale, dispatch_clip_grad, global_grad_norm
from ..utils.cuda_graph import StepGraphs
from ..utils.model_ema import ModelEmaV3

__all__ = ['Normalize', 'TrainingTask']


class Normalize:
    """(x - mean) / std in fp32 on ``device``, cast back to x's dtype; the
    training task's input normalization, shared with the eval drivers."""

    def __init__(self, mean, std, device):
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=device).reshape(1, 1, 1, -1)
        self.std = torch.as_tensor(1.0 if std is None else std, dtype=torch.float32,
                                   device=device).reshape(1, 1, 1, -1)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.mean.device)
        y = (x.float() - self.mean) / self.std
        return y if x.dtype == torch.float32 else y.to(x.dtype)


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
        self._normalize = Normalize(mean, std, self.device) if mean is not None else None
        self.ema: Optional[ModelEmaV3] = None
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        self.train_graphs = StepGraphs(self._train_body, self.device,
                                       generators=self._drop_generators)
        self.eval_graphs = StepGraphs(self._eval_body, self.device)

    def _drop_generators(self) -> List[Optional[torch.Generator]]:
        return [get_drop_generator(self.model)]

    # -- overridables --------------------------------------------------------
    def loss_forward(self, model: nn.Module, batch: Dict[str, Any]):
        """Return (loss, output). Subclasses implement the objective."""
        raise NotImplementedError

    def eval_forward(self, model: nn.Module, batch: Dict[str, Any]):
        return model(batch['input'])

    def normalize_input(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """(x - mean) / std in fp32 on the device, cast back to x's dtype."""
        if self._normalize is None or 'input' not in batch:
            return batch
        return dict(batch, input=self._normalize(batch['input']))

    # -- setup ---------------------------------------------------------------
    def setup_ema(self, decay: float = 0.9999, warmup: bool = False, **kwargs):
        """Start the EMA as a copy of the parameters, kept by the optimizer
        in the layout of its flat buffers; ``ema_params`` maps names to it.
        The EMA's presence is part of the train step: its graphs go."""
        if self.optimizer is None:
            raise RuntimeError('setup_ema needs the optimizer: the EMA lives in its buffers')
        self.ema = ModelEmaV3(decay=decay, use_warmup=warmup, **kwargs)
        self.ema_params = self.optimizer.init_ema()
        self.train_graphs.clear()
        self.eval_graphs.clear()

    # -- steps -----------------------------------------------------------------
    @staticmethod
    def _split(batch: Dict[str, Any]):
        """(arrays and tensors, the other entries as a hashable tuple)."""
        tensors = {k: v for k, v in batch.items() if not isinstance(v, (int, float))}
        return tensors, tuple(sorted((k, v) for k, v in batch.items() if k not in tensors))

    def train_step(self, batch: Dict[str, Any], lr: float, step: int = 0) -> Dict[str, torch.Tensor]:
        """One optimization step; ``batch['input']`` is NHWC. Returns device
        tensors of its own (clones): ``loss``, ``grad_norm`` and, with the
        guard on, ``nonfinite``, ``nonfinite_count`` and ``nonfinite_total``."""
        if self.optimizer is None:
            raise RuntimeError('TrainingTask.train_step requires an optimizer')
        self.optimizer.set_hyperparams(
            lr=lr, ema_decay=self.ema.get_decay(step) if self.ema is not None else 0.0)
        self.model.train()
        tensors, others = self._split(batch)
        metrics = self.train_graphs(tensors, others)
        if self._nonfinite_guard:
            self.sentinel.observe(self._sentinel_state, step=step)
        return metrics

    def _train_body(self, tensors: Dict[str, torch.Tensor], others=()) -> Dict[str, torch.Tensor]:
        """The step on the device, as a CUDA graph captures it: it reads the
        learning rate and EMA decay from the optimizer's device scalars and
        reads nothing back to the host."""
        opt = self.optimizer
        batch = self.normalize_input(dict(tensors, **dict(others)))
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
        opt.step(grad_scale=scale, ok=ok)

        metrics = {'loss': loss, 'grad_norm': grad_norm}
        if self._nonfinite_guard:
            state = update_sentinel_state(self._sentinel_state, ok)
            metrics['nonfinite'] = state[0] > 0
            metrics['nonfinite_count'] = state[0]
            metrics['nonfinite_total'] = state[1]
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, Any], use_ema: bool = False):
        """The model's output on ``batch`` (a clone), with the EMA weights
        when ``use_ema`` and the task has them."""
        self.model.eval()
        try:
            tensors, others = self._split(batch)
            return self.eval_graphs(tensors, others, bool(use_ema and self.ema_params is not None))
        finally:
            self.model.train()

    def _eval_body(self, tensors: Dict[str, torch.Tensor], others=(), use_ema: bool = False):
        batch = self.normalize_input(dict(tensors, **dict(others)))
        if use_ema:
            # eval_forward with the EMA weights in place of the parameters
            return torch.func.functional_call(
                _EvalForward(self, self.model),
                {f'model.{n}': t for n, t in self.ema_params.items()}, (batch,), strict=False)
        return self.eval_forward(self.model, batch)

    # -- checkpoint ------------------------------------------------------------
    def checkpoint_keys(self) -> List[str]:
        """The keys ``get_checkpoint_state`` returns, without copying state."""
        keys = [f'state_dict.{n}' for n, _ in self.model.named_parameters()]
        keys += [f'model_state.{n}' for n in persistent_buffers(self.model)]
        opt = self.optimizer
        if self.ema_params is not None:
            keys += [f'state_dict_ema.{n}' for n in self.ema_params]
        if opt is not None:
            keys += [f'optimizer.{k}' for k in opt.state_keys()]
        if get_drop_generator(self.model) is not None:
            keys.append(DROP_RNG_KEY)
        return keys

    def get_checkpoint_state(self) -> Dict[str, np.ndarray]:
        """The flat checkpoint dict: host copies of the parameters, EMA,
        optimizer state, persistent buffers and drop generator state."""
        params, buffers = module_arrays(self.model)
        state = add_prefix(params, 'state_dict')
        opt = self.optimizer
        if self.ema_params is not None:
            state.update(add_prefix(opt.host_views(opt.ema), 'state_dict_ema'))
        if opt is not None:
            state.update(add_prefix(opt.state_arrays(), 'optimizer'))
        state.update(add_prefix(buffers, 'model_state'))
        state.update(capture_drop_rng(get_drop_generator(self.model)))
        return state

    def load_checkpoint_state(self, state: Mapping[str, np.ndarray], strict: bool = True,
                              load_opt: bool = True):
        """Restore from a flat checkpoint dict, in place. ``strict``: a
        parameter, EMA, optimizer or persistent-buffer entry (BatchNorm's
        running statistics) missing from ``state`` raises (a shape mismatch
        always does). ``load_opt=False`` keeps the optimizer's state as it
        is."""
        load_module_arrays(dict(self.model.named_parameters()), split_prefix(state, 'state_dict'),
                           'state_dict', strict=strict)
        opt = self.optimizer
        if self.ema_params is not None and any(k.startswith('state_dict_ema.') for k in state):
            opt.load_views(opt.ema, split_prefix(state, 'state_dict_ema'), 'state_dict_ema',
                           strict=strict)
        if load_opt and opt is not None and any(k.startswith('optimizer.') for k in state):
            opt.load_state_arrays(split_prefix(state, 'optimizer'), strict=strict)
        load_module_arrays(persistent_buffers(self.model), split_prefix(state, 'model_state'),
                           'model_state', strict=strict)
        restore_drop_rng(state, get_drop_generator(self.model))


class _EvalForward(nn.Module):
    """``task.eval_forward`` as a module over the task's model, so
    ``functional_call`` can swap in the EMA weights (any batch form: dense
    input or a NaFlex dict)."""

    def __init__(self, task: TrainingTask, model: nn.Module):
        super().__init__()
        self._task = task
        self.model = model

    def forward(self, batch):
        return self._task.eval_forward(self.model, batch)
