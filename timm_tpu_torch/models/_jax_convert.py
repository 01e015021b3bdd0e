"""Carry weights and training checkpoints from the JAX package into the port.

Weights: the flat ``{dotted.path: np.ndarray}`` dict that
``timm_tpu.models._helpers.model_state_dict`` produces (or its saved .npz /
.safetensors form). The rules invert timm_tpu/models/_torch_convert.py:

  .kernel (I, O)          -> .weight (O, I)        [transpose]
  .kernel (W, I, O)       -> .weight (O, I, W)     [1-d conv, ECA's]
  .kernel (H, W, I, O)    -> .weight (O, I, H, W)  [conv HWIO -> OIHW]
  .scale                  -> .weight               [norm affine]
  .mean / .var            -> .running_mean / .running_var  [BatchNorm statistics]

Every other name carries over as it is, because the port's module tree
mirrors the JAX package's: MixedConv2d's per-split kernels are
``convs.<i>.kernel`` on both sides, and CondConv2d keeps JAX's layout, its
``weight`` (E, P) of HWIO-flat expert rows and ``bias`` (E, C_out).
NaFlexVit's ``embeds.proj`` is a Linear on both sides (its (P*P*C, D)
kernel transposes as any); its ``embeds.pos_embed_y`` / ``_x`` / ``_grid``,
``cls_token`` and ``reg_token``, and DiffAttention's 0-d ``lambda_a`` /
``lambda_b`` and 1-d ``lambda_q1`` .. ``lambda_k2``, carry over as they
are (its ``sub_norm.scale`` becomes ``sub_norm.weight``).

Task checkpoints (``convert_jax_checkpoint``): the single flat dict of
``timm_tpu.task.TrainingTask.get_checkpoint_state`` becomes the port's
(``task/task.py``). ``state_dict.*``, ``state_dict_ema.*`` and
``model_state.*`` take the weight rules; the optax state maps as

  optimizer.count                           -> optimizer.count
  optimizer.hyperparams.learning_rate       -> optimizer.learning_rate
  optimizer.inner_state.<i...>.count|step   -> optimizer.count (must agree)
  optimizer.inner_state.<i...>.<slot>.<path> -> optimizer.<slot>.<port path>
  optimizer.inner_state.<i...>.exp_avg_lr_1|2 -> optimizer.exp_avg_lr_1|2

where <i...> is chain indices and Muon's partitions
(``inner_states.muon|adam.inner_state``), and <slot> is one of mu, nu,
trace (the Adam family, LAMB, Lion, Muon, NovoGrad, RMSprop, the SGDs,
LARS, SM3), grad_sum_sq, s, x0 (MADGRAD), exp_avg, exp_avg_sq (LaProp,
MARS), last_grad (MARS), m, v, n, g (Adan, whose ``t`` is its count), e_g,
e_x (Adadelta), sum_of_squares (Adagrad) and v_row, v_col, v (Adafactor),
with the moments transposed as their parameters are. Three kinds of state
keep their JAX layout and are only renamed: Adafactor's (a checkpoint with
``v_row`` keys), whose factored moments the port builds on the JAX dims;
SM3's per-dim accumulators ``mu.<path>.<dim>``; and a kernel's per-leaf
scalar or vector (NovoGrad's ``nu``). Muon's ``ns_coeffs`` must be optax's
constants. Lookahead's state ``(inner, slow, count)`` maps its inner state
as above, ``inner_state.1.<path>`` to ``optimizer.slow.<port path>`` and its
count must agree; with layer decay the whole state sits under
``optimizer.0.`` (the scale transform keeps none). ``epoch``, ``metric`` and
``_resume.*`` carry over. A ``model_state.`` key with a component that
starts with an underscore is a constant the JAX module keeps in a variable
(blur pool's filter ``_kernel``), which ``model_state_dict`` leaves out of
the weights too: the port's module makes its own, so it is dropped. Any other
key raises and names itself: no other key is skipped.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..optim._optimizers import NS_COEFFS

__all__ = ['convert_jax_checkpoint', 'convert_jax_state_dict', 'is_jax_checkpoint',
           'load_jax_state_dict']

# an optax inner state key: chain indices and Muon's partitions, then a field
_INNER_RE = re.compile(r'^(?:\d+\.|inner_states\.(?:muon|adam)\.inner_state\.)*(.+)$')
_SLOT_RE = re.compile(
    r'^(mu|nu|trace|grad_sum_sq|s|x0|exp_avg|exp_avg_sq|last_grad|m|v|n|g|e_g|e_x|'
    r'sum_of_squares|v_row|v_col)\.(.+)$')
_JAX_LAYOUT_SLOTS = ('v_row', 'v_col', 'v')  # Adafactor's
_SCALAR_SLOTS = ('exp_avg_lr_1', 'exp_avg_lr_2')
_WEIGHT_PREFIXES = ('state_dict.', 'state_dict_ema.', 'model_state.')


def _as_numpy(a) -> np.ndarray:
    """A numpy array with a dtype torch knows: bf16 (ml_dtypes' or an npz's
    raw 2-byte void) becomes fp32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return a.astype(np.float32)
    if a.dtype.kind == 'V' and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def _convert_leaf(key: str, value, transpose: bool = True) -> Tuple[str, np.ndarray]:
    value = _as_numpy(value)
    base, dot, leaf = key.rpartition('.')
    if leaf.isdigit():  # SM3's accumulator of one dim of the JAX layout
        key, _ = _convert_leaf(base, np.zeros(()), transpose=False)
        return f'{key}.{leaf}', np.ascontiguousarray(value) if value.ndim else value.copy()
    if leaf == 'kernel':
        if not transpose or value.ndim < 2:
            pass
        elif value.ndim in (2, 3):
            value = value.transpose(tuple(range(value.ndim))[::-1])
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f'{key}: no conversion rule for a {value.ndim}-d kernel')
        key = base + dot + 'weight'
    elif leaf == 'scale':
        key = base + dot + 'weight'
    elif leaf in ('mean', 'var'):
        key = base + dot + 'running_' + leaf
    return key, np.ascontiguousarray(value) if value.ndim else value.copy()


def is_jax_checkpoint(flat: Mapping[str, np.ndarray]) -> bool:
    """A JAX package file: ``.kernel`` / ``.scale`` leaves or optax's
    ``optimizer.inner_state`` keys."""
    return any(k.rpartition('.')[2] in ('kernel', 'scale') or k.startswith('optimizer.inner_state.')
               for k in flat)


def convert_jax_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX weights -> {port name: tensor}."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        key, value = _convert_leaf(key, value)
        if key in out:
            raise ValueError(f'two JAX entries map to the port name {key}')
        out[key] = torch.from_numpy(np.array(value))  # a writable, contiguous copy
    return out


def convert_jax_checkpoint(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A JAX task checkpoint -> the port's checkpoint dict (numpy)."""
    out: Dict[str, np.ndarray] = {}
    inner_counts = []

    def put(key, value):
        if key in out:
            raise ValueError(f'two JAX entries map to the port key {key}')
        out[key] = value

    layer_decay = any(k.startswith('optimizer.0.') for k in flat)
    adafactor = any('.v_row.' in k for k in flat if k.startswith('optimizer.'))
    lookahead = any(_optimizer_key(k, layer_decay) == 'optimizer.inner_state.2' for k in flat)

    def put_inner(key, rest, value):
        """An optax inner state entry, ``rest`` after its ``inner_state.``."""
        field = _INNER_RE.match(rest).group(1)
        if field in ('count', 'step', 't'):
            inner_counts.append((key, int(np.asarray(value))))
        elif field == 'ns_coeffs':
            if not np.array_equal(np.asarray(value, np.float32), np.float32(NS_COEFFS)):
                raise ValueError(f'{key} = {np.asarray(value)}: the port runs Muon with '
                                 f'optax\'s coefficients {NS_COEFFS}')
        elif field in _SCALAR_SLOTS:
            put(f'optimizer.{field}', np.asarray(value, np.float32))
        elif _SLOT_RE.match(field):
            slot, path = _SLOT_RE.match(field).groups()
            path, value = _convert_leaf(path, value,
                                        transpose=not (adafactor and slot in _JAX_LAYOUT_SLOTS))
            put(f'optimizer.{slot}.{path}', value)
        else:
            raise ValueError(f'{key}: no rule maps this JAX checkpoint entry into the port')

    for key, value in flat.items():
        okey = _optimizer_key(key, layer_decay)
        if key in ('epoch', 'metric') or key.startswith('_resume.'):
            put(key, np.asarray(value))
        elif key.startswith('model_state.') and any(p.startswith('_') for p in key.split('.')):
            continue  # a module's constant, not state
        elif key.startswith(_WEIGHT_PREFIXES):
            prefix, _, path = key.partition('.')
            path, value = _convert_leaf(path, value)
            put(f'{prefix}.{path}', value)
        elif okey == 'optimizer.count':
            put('optimizer.count', np.asarray(value, np.int32))
        elif okey == 'optimizer.hyperparams.learning_rate':
            put('optimizer.learning_rate', np.asarray(value, np.float32))
        elif lookahead and okey == 'optimizer.inner_state.2':
            inner_counts.append((key, int(np.asarray(value))))
        elif lookahead and okey.startswith('optimizer.inner_state.1.'):
            path, value = _convert_leaf(okey[len('optimizer.inner_state.1.'):], value)
            put(f'optimizer.slow.{path}', value)
        elif lookahead and okey.startswith('optimizer.inner_state.0.'):
            put_inner(key, okey[len('optimizer.inner_state.0.'):], value)
        elif not lookahead and okey.startswith('optimizer.inner_state.'):
            put_inner(key, okey[len('optimizer.inner_state.'):], value)
        else:
            raise ValueError(f'{key}: no rule maps this JAX checkpoint entry into the port')
    for key, count in inner_counts:
        if 'optimizer.count' not in out:
            out['optimizer.count'] = np.asarray(count, np.int32)
        elif int(out['optimizer.count']) != count:
            raise ValueError(f'{key} = {count} disagrees with optimizer.count = '
                             f'{int(out["optimizer.count"])}')
    return out


def _optimizer_key(key: str, layer_decay: bool) -> str:
    """An ``optimizer.`` key with layer decay's chain index taken off (the
    scale transform at index 1 keeps no state)."""
    if layer_decay and key.startswith('optimizer.0.'):
        return 'optimizer.' + key[len('optimizer.0.'):]
    return key


def load_jax_state_dict(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Convert ``flat`` and load it into ``model`` strictly: a missing or an
    unexpected key, or a shape mismatch, raises. Values are copied into the
    model's parameters on their device and dtype."""
    model.load_state_dict(convert_jax_state_dict(flat), strict=True)
    return model
