"""Kernel registry and harness of the PyTorch port against the JAX registry.

On the CPU: the portfolio and its rules; one test per registered case that
holds the port's plain version at the dry arm against the JAX spec's
reference (jitted XLA) on the same numpy inputs, within the spec's
``parity_tol``, and for the cases the JAX registry declares, that the port
draws the very inputs JAX draws; the lint that every module of
``timm_tpu_torch/kernels/`` registers a spec or carries a waiver; and the
verdicts: ``pending`` off the card, ``delete`` for a fake kernel that loses
to its plain version or breaks parity (never timed), on a clock the tests
pass in; and that the flash spec's per-element error bound holds exact
attention and is far tighter than a typical output. The ``gpu``-marked
test holds every kernel to its plain version on the card at every dry and
live case. JAX is imported inside the module-scoped fixture.
"""
import dataclasses
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import timm_tpu_torch.kernels as port_kernels
from timm_tpu_torch.kernels import harness, registry
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

_GRID = harness.parity_cases()
_IDS = [f'{s.name}-{c.name}' for s, c in _GRID]


def test_portfolio_and_duplicate_rejection():
    assert registry.kernel_names() == ('augment_epilogue', 'flash_attention', 'fused_adamw')
    spec = registry.get('fused_adamw')
    assert spec.backends == ('cuda',)
    with pytest.raises(ValueError, match='already registered'):
        registry.register(spec)
    with pytest.raises(ValueError, match='regime is empty'):
        dataclasses.replace(spec, name='empty', cases=())
    with pytest.raises(ValueError, match='parity_tol'):
        dataclasses.replace(spec, name='loose', parity_tol=0.0)
    with pytest.raises(KeyError, match='not registered'):
        registry.get('no_such_kernel')
    counters = registry.launch_counters()
    assert set(counters) == set(registry.kernel_names())
    assert all(isinstance(c.launches, int) for c in counters.values())


def test_jax_case_names_and_shapes_carried():
    """Each port spec declares the JAX spec's cases first, by the same
    names, with the same dry and live shapes and the same tolerance."""
    from timm_tpu.kernels import registry as jreg
    for name in registry.kernel_names():
        port, jax_spec = registry.get(name), jreg.get(name)
        assert port.parity_tol == jax_spec.parity_tol
        for pc, jc in zip(port.cases, jax_spec.cases):
            assert pc.name == jc.name
            for arm in ('dry', 'live'):
                assert getattr(pc, arm) == getattr(jc, arm), (name, pc.name, arm)


# ---- the port's plain versions against the JAX registry's references --------

@pytest.fixture(scope='module')
def jx():
    """The JAX spec of each kernel, its reference jitted, and an adapter
    from the port's inputs to the JAX reference's."""
    import functools
    import types

    import jax
    import jax.numpy as jnp

    from timm_tpu.kernels import registry as jreg

    def jnp_of(t):
        return jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                           str(t.dtype).replace('torch.', ''))

    flash_reference = jax.jit(jreg.get('flash_attention').reference_fn)

    def flash(inputs, statics):
        return [flash_reference(**{k: None if v is None else jnp_of(v) for k, v in inputs.items()})]

    def adamw(inputs, statics):
        """The port's flat buffers as two leaves, split where weight decay
        stops, through JAX's optax chain with the matching mask."""
        spec = jreg.get('fused_adamw')
        nd = inputs['n_decay']
        parts = {k: s for k, s in (('decay', slice(0, nd)), ('rest', slice(nd, None)))
                 if inputs['p'][s].numel()}

        def tree(t):
            return None if t is None else {k: jnp_of(t[s]) for k, s in parts.items()}
        mu_dtype = jnp.bfloat16 if inputs['m'].dtype == torch.bfloat16 else None
        fn = jax.jit(functools.partial(spec.reference_fn, mu_dtype=mu_dtype,
                                       wd_mask={k: k == 'decay' for k in parts}, **statics))
        outs = fn(tree(inputs['p']), tree(inputs['g']), tree(inputs['m']), tree(inputs['v']),
                  tree(inputs['ema']), jnp.asarray(int(inputs['count']), jnp.int32),
                  jnp.asarray(inputs['lr'], jnp.float32),
                  jnp.asarray(inputs['ema_decay'], jnp.float32))
        return [jnp.concatenate([o[k] for k in parts]) for o in outs if o is not None]

    augment_reference = jax.jit(functools.partial(
        jreg.get('augment_epilogue').reference_fn, num_classes=10, smoothing=0.1,
        **registry.get('augment_epilogue').cases[0].statics))

    def augment(inputs, statics):
        assert statics == registry.get('augment_epilogue').cases[0].statics
        batch = {k: jnp_of(v) for k, v in inputs.items()}
        batch['target'] = jnp.zeros(inputs['image'].shape[0], jnp.int32)
        return [augment_reference(batch)[0]]

    return types.SimpleNamespace(jnp=jnp, jreg=jreg, reference={
        'flash_attention': flash, 'fused_adamw': adamw, 'augment_epilogue': augment})


def _jax_inputs_as_port(name, jin):
    """The JAX registry's inputs in the port's form: flat buffers for
    fused_adamw (its JAX cases decay every leaf, each a multiple of 4
    elements), the batch's kernel arguments for augment_epilogue."""
    if name == 'flash_attention':
        return jin
    if name == 'augment_epilogue':
        b = jin['batch']
        return {k: b[k] for k in ('image', 'erase_box', 'lam', 'use_cutmix', 'bbox') if k in b}
    flat = {k: np.concatenate([np.asarray(x.astype('float32')).ravel() for x in jin[j].values()])
            for k, j in (('p', 'params'), ('g', 'grads'), ('m', 'mu'), ('v', 'nu'), ('ema', 'ema'))}
    flat.update(count=jin['count'], lr=jin['lr'], ema_decay=jin['ema_decay'])
    return flat


@pytest.mark.parametrize('spec,case', _GRID, ids=_IDS)
def test_plain_matches_jax_reference(jx, spec, case):
    inputs = spec.make_inputs(seed=0, device='cpu', **case.dry)
    jax_cases = {c.name: c for c in jx.jreg.get(spec.name).cases}
    if case.name in jax_cases:
        jin = _jax_inputs_as_port(spec.name, jx.jreg.get(spec.name).make_inputs(seed=0, **case.dry))
        for k, want in jin.items():  # compared as fp32, which holds every value exactly
            got = inputs[k].float().numpy() if isinstance(inputs[k], torch.Tensor) else \
                np.float32(inputs[k])
            np.testing.assert_array_equal(got, np.asarray(want).astype(np.float32), err_msg=k)
    with torch.no_grad():
        port = registry._leaves(spec.reference_fn(**inputs, **case.statics))
    ref = jx.reference[spec.name](inputs, case.statics)
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.dtype == getattr(torch, str(b.dtype)) and tuple(a.shape) == b.shape
        want = np.asarray(b.astype('float32'), np.float64)
        diff = np.abs(a.double().numpy() - want)
        tol = spec.parity_tol
        if a.dtype == torch.bfloat16:
            # where the fp32 sum of the bf16 first moment's two rounded
            # products is exactly a bf16 tie (optax's separate roundings,
            # which the port keeps), XLA:CPU gives what a fused multiply-add
            # gives, and the two round apart: one bf16 ulp of the JAX value
            tol = np.maximum(tol, np.ldexp(1.0, np.frexp(want)[1] - 8))
        assert (diff <= tol).all(), f'{spec.name}/{case.name}: {diff.max()} > {spec.parity_tol}'


def test_io_bytes_and_bound_from_the_registry():
    """Inputs read once and outputs written once, sized on the meta device;
    the bound is the larger of bytes and operations over the peaks."""
    spec = registry.get('flash_attention')
    case = next(c for c in spec.cases if c.name == 'keypad_n256')
    inputs = spec.make_inputs(device='cpu', **case.dry)
    q = inputs['q']
    assert registry.default_io_bytes(spec, case, inputs) == 4 * q.numel() * 2 + q.shape[0] * 256
    r = registry.roofline(spec, case, inputs)
    assert r['flops'] == 4 * 2 * 256 * 2 * 197 * 64
    assert r['bound_ms'] == pytest.approx(max(r['io_bytes'] / registry.PEAK_BYTES_PER_S,
                                              r['flops'] / registry.PEAK_OPS_PER_S['bfloat16']) * 1e3)
    spec = registry.get('fused_adamw')
    inputs = spec.make_inputs(device='cpu', **spec.cases[0].dry)
    n = inputs['p'].numel()
    # 36 bytes a parameter, the int32 count, and lr and the EMA decay,
    # one fp32 device scalar each
    assert registry.default_io_bytes(spec, spec.cases[0], inputs) == n * 36 + 4 + 2 * 4


_FLASH = registry.get('flash_attention')


@pytest.mark.parametrize('case', _FLASH.cases, ids=[c.name for c in _FLASH.cases])
def test_flash_error_bound_holds_exact_attention(case):
    """Exact attention (fp64, nothing rounded past q * scale) stands within
    the flash spec's per-element bound of the plain version, as a kernel
    that rounds no worse must; and the bound stays under a quarter of a
    typical output, where the one parity_tol does not."""
    inputs = _FLASH.make_inputs(device='cpu', **case.dry)
    q, k, v, mask = (inputs[n] for n in ('q', 'k', 'v', 'mask'))
    with torch.no_grad():
        plain = _FLASH.reference_fn(**inputs)
        bound = _FLASH.error_bound(plain, **inputs).double()
    s = (q * torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)).double() @ \
        k.double().transpose(-2, -1)
    if mask is not None:
        s = s.masked_fill(~mask, float('-inf'))
    exact = torch.softmax(s, dim=-1) @ v.double()
    assert float(((plain.double() - exact).abs() / bound).max()) <= 1.0
    assert float(bound.max()) < 0.25 * float(plain.double().abs().mean()) < _FLASH.parity_tol


# ---- the lint: a kernel module registers a spec or says why not -------------

def _unregistered(directory: Path, registered_modules, package: str):
    """Modules of ``directory`` that register no spec whose ``module`` names
    them and do not open with ``# no-kernel-registry: <reason>`` in their
    first 5 lines."""
    waiver = re.compile(r'#\s*no-kernel-registry:\s*\S')
    out = []
    for path in sorted(directory.glob('*.py')):
        if f'{package}.{path.stem}' in registered_modules:
            continue
        if not any(waiver.match(line) for line in path.read_text().splitlines()[:5]):
            out.append(path.name)
    return out


def test_every_kernel_module_registered_or_waived(tmp_path):
    registered = {s.module for s in registry.all_specs()}
    directory = Path(port_kernels.__file__).parent
    assert _unregistered(directory, registered, port_kernels.__name__) == []
    # the lint bites: a kernel module that registers nothing is flagged
    (tmp_path / 'new_kernel.py').write_text('"""A kernel without a spec."""\n')
    (tmp_path / 'helper.py').write_text('# no-kernel-registry: shared helpers\n')
    assert _unregistered(tmp_path, registered, port_kernels.__name__) == ['new_kernel.py']


# ---- verdicts ------------------------------------------------------------------

def test_verdicts_pending_off_the_card():
    recs = harness.run_kernel_ab(device='cpu', live=False)
    assert [r['kernel'] for r in recs] == list(registry.kernel_names())
    for rec in recs:
        assert rec['parity_ok'] and rec['verdict'] == 'pending', rec
        assert 'cases' not in rec and 'settles the gate' in rec['reason']
        assert len(rec['parity']) == len(registry.get(rec['kernel']).cases)
        line = harness.format_verdict_line(rec)
        assert rec['kernel'] in line and 'PENDING' in line


def _host_timer(fn, graph):
    """The fakes' clock on the CPU: the best of a few host-clock calls."""
    fn()
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _toy_specs():
    """A fake kernel that claims the CPU and equals its plain version but
    drags a chain of matrix products scaled to nothing, and its twin with
    the arms swapped."""
    def make_inputs(seed=0, device='cpu', n=64):
        rng = np.random.default_rng(seed)
        return {'x': torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).to(device)}

    def fast(x):
        return x * 2.0 + 1.0

    def slow(x):
        acc = x
        eye = torch.eye(x.shape[0], dtype=x.dtype)
        for _ in range(30):
            acc = acc @ eye
        return x * 2.0 + 1.0 + acc * 1e-30

    losing = registry.KernelSpec(
        name='toy_losing', module=__name__, regime='nowhere (test fixture)',
        gate='beat the plain version or be deleted', parity_tol=1e-6, kernel_fn=slow,
        reference_fn=fast, make_inputs=make_inputs,
        cases=(registry.KernelCase(name='only', dry=dict(n=64), live=dict(n=64)),),
        backends=('cpu',))
    return losing, dataclasses.replace(losing, name='toy_winning', kernel_fn=fast,
                                       reference_fn=slow)


def test_losing_kernel_gets_delete_winning_twin_keep():
    losing, winning = _toy_specs()
    rec = harness.ab_verdict(losing, live=False, device='cpu', timer=_host_timer)
    assert rec['parity_ok'] and rec['verdict'] == 'delete', rec
    assert 'loses to the plain version' in rec['reason']
    assert rec['cases'][0]['plain_ms'] < rec['cases'][0]['call_ms']
    assert 'DELETE' in harness.format_verdict_line(rec)
    rec = harness.ab_verdict(winning, live=False, device='cpu', timer=_host_timer)
    assert rec['parity_ok'] and rec['verdict'] == 'keep', rec


@pytest.mark.parametrize('broken_fn', [lambda x: x * 2.0 + 1.001,
                                       lambda x: (x * 2.0 + 1.0).index_fill(0, torch.tensor([3]),
                                                                         float('nan'))],
                         ids=['off', 'nan'])
def test_parity_broken_kernel_deleted_without_timing(broken_fn):
    losing, _ = _toy_specs()
    broken = dataclasses.replace(losing, name='toy_broken', kernel_fn=broken_fn)
    rec = harness.ab_verdict(broken, live=False, device='cpu', timer=_no_clock)
    assert rec['verdict'] == 'delete' and not rec['parity_ok']
    assert 'wrong beats slow' in rec['reason']
    assert 'cases' not in rec  # never timed


def _no_clock(fn, graph):
    raise AssertionError('a kernel that fails parity is never timed')


def test_kernel_beyond_its_error_bound_deleted_without_timing():
    """Within parity_tol but beyond the spec's per-element bound is a parity
    failure too; within both, the kernel goes on to be timed."""
    losing, _ = _toy_specs()
    off = dataclasses.replace(losing, name='toy_off', kernel_fn=lambda x: x * 2.0 + 1.0 + 1e-7,
                              error_bound=lambda out, x: torch.full_like(out, 1e-8))
    rec = harness.ab_verdict(off, live=False, device='cpu', timer=_no_clock)
    assert rec['verdict'] == 'delete' and rec['parity_max_err'] <= off.parity_tol
    assert rec['error_over_bound'] > 1.0 and 'error over bound' in rec['reason']
    assert 'cases' not in rec
    within = dataclasses.replace(off, error_bound=lambda out, x: torch.full_like(out, 1e-6))
    rec = harness.ab_verdict(within, live=False, device='cpu', timer=_host_timer)
    assert rec['parity_ok'] and rec['error_over_bound'] <= 1.0 and 'cases' in rec
    assert 'error/bound' in harness.format_verdict_line(rec)


# ---- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize('spec,case', _GRID, ids=_IDS)
def test_parity_on_card(spec, case):
    """The kernel against its plain version on the card, at the dry and
    the live arm, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    counter = registry.launch_counters()[spec.name]
    for live in (False, True):
        before = counter.launches
        rec = harness.parity_check(spec, case, live=live, device='cuda')
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert rec['ok'], rec
