# no-kernel-registry: infrastructure module — consumes the registry, not a kernel
"""Keep-or-delete harness over the kernel registry (counterpart of
``timm_tpu/kernels/harness.py``).

1. **Parity**: ``parity_check`` runs the kernel and its plain version on one
   case's inputs (dry or live arm) on one device and takes the max abs
   difference leaf for leaf, within the spec's ``parity_tol``; where the
   spec gives an ``error_bound``, every element is also held within it
   (``error_over_bound`` <= 1). ``parity_cases()`` is the grid the tests
   parametrize over. On CPU tensors a wrapper takes its plain version, so
   there parity checks the plumbing; on the card it checks the kernel.

2. **Verdicts**: ``ab_verdict`` gives the keep / delete / pending record.
   A parity failure is ``delete`` at once and is never timed (wrong beats
   slow). Off the spec's ``backends`` the verdict is ``pending``, with
   parity still measured. Otherwise the kernel must beat its plain version
   at every declared case or it is ``delete``. The comparison is like for
   like, eager calls against eager calls (``call_ms`` against
   ``plain_ms``): the plain versions create tensors from host values and
   cannot be captured in a CUDA graph. The kernel's device time
   (``kernel_ms``) is taken as PERF.md defines it: CUDA events around
   replays of a CUDA graph that holds 20 calls, so that the wrapper's host
   time stays out. The library call (``library_ms``, the same graph timing)
   and ``vs_library`` = library_ms / kernel_ms are recorded beside the
   verdict and never decide it: a hand-written kernel that is slower than
   the library stays, with its times written down. Each case carries the
   registry's bound (``registry.roofline``: ``io_bytes``, ``flops``,
   ``bound_ms``).

The clock is the card's (``card_timer``); a caller that decides verdicts
elsewhere, as the tests' fake specs on the CPU do, passes its own
``timer``. JAX's harness also counts the jaxpr equations of both arms;
eager PyTorch has no program to count, so there is no counterpart.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import registry
from .registry import KernelCase, KernelSpec, _leaves, roofline

__all__ = ['ab_case', 'ab_verdict', 'card_timer', 'format_verdict_line', 'graph_ms',
           'parity_cases', 'parity_check', 'run_kernel_ab', 'time_ms']


def time_ms(fn: Callable, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of one eager call on the card, from CUDA events around
    ``iters`` calls: the wrapper's host time is in it where it exceeds the
    device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one call: CUDA events around replays of a CUDA graph
    that holds ``per_graph`` calls, so the wrapper's host time (tens of
    microseconds of Python) is left out of a kernel that runs for less."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (per_graph * replays)
    del graph
    return ms


def card_timer(fn: Callable, graph: bool) -> float:
    """The harness's clock: device time from graph replays (``graph``), or
    eager calls with the host time in them."""
    return graph_ms(fn) if graph else time_ms(fn, iters=20)


def parity_cases() -> List[Tuple[KernelSpec, KernelCase]]:
    """Every (spec, case) pair in the registry: the grid of the parity tests."""
    return [(spec, case) for spec in registry.all_specs() for case in spec.cases]


def _inputs(spec: KernelSpec, case: KernelCase, live: bool, device, seed: int) -> Dict:
    return spec.make_inputs(seed=seed, device=device, **(case.live if live else case.dry))


def _on(inputs: Dict, device) -> Dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in inputs.items()}


def parity_check(spec: KernelSpec, case: KernelCase, *, live: bool = False, device='cuda',
                 seed: int = 0, inputs: Optional[Dict] = None) -> Dict:
    """Max abs difference of the kernel and its plain version on one case's
    inputs (``inputs``, else drawn by the spec), leaf for leaf over the
    outputs, in fp64, against ``parity_tol``; with the spec's
    ``error_bound``, also the largest ratio of an element's difference to
    its bound, against 1."""
    if inputs is None:
        inputs = _inputs(spec, case, live, device, seed)
    with torch.no_grad():
        leaves_k = _leaves(spec.kernel_fn(**inputs, **case.statics))
        out_r = spec.reference_fn(**inputs, **case.statics)
        leaves_r = _leaves(out_r)
        bound = (None if spec.error_bound is None
                 else spec.error_bound(out_r, **inputs, **case.statics))
    assert len(leaves_k) == len(leaves_r), (
        f'{spec.name}/{case.name}: kernel and plain outputs disagree '
        f'({len(leaves_k)} vs {len(leaves_r)} leaves)')
    assert bound is None or len(leaves_r) == 1, f'{spec.name}: error_bound takes one output leaf'
    err, over = 0.0, 0.0
    for a, b in zip(leaves_k, leaves_r):
        assert a.shape == b.shape and a.dtype == b.dtype, (
            f'{spec.name}/{case.name}: kernel output {a.dtype}{tuple(a.shape)}, '
            f'plain {b.dtype}{tuple(b.shape)}')
        if a.numel():
            diff = (a.double() - b.double()).abs()
            d = float(diff.max())
            if not d <= err:  # a NaN difference is kept: it fails the tolerance
                err = d
            if bound is not None:
                r = float((diff / bound.double()).max())
                if not r <= over:
                    over = r
    rec = {'kernel': spec.name, 'case': case.name, 'arm': 'live' if live else 'dry',
           'device': torch.device(device).type, 'max_abs_err': err, 'tol': spec.parity_tol,
           'ok': err <= spec.parity_tol}
    if bound is not None:
        rec['error_over_bound'] = over
        rec['ok'] = rec['ok'] and over <= 1.0
    return rec


def ab_case(spec: KernelSpec, case: KernelCase, *, live: bool = True, device='cuda',
            seed: int = 0, timer: Optional[Callable] = None,
            inputs: Optional[Dict] = None) -> Dict:
    """Time the kernel, its plain version and the library call at one case
    (on ``inputs``, else drawn by the spec), with the case's bound from the
    registry. ``timer(fn, graph)`` is the clock, ``card_timer`` by default."""
    device = torch.device(device)
    if timer is None:
        if device.type != 'cuda':
            raise ValueError(f'no clock for {device.type}: pass timer=')
        timer = card_timer
    if inputs is None:
        inputs = _inputs(spec, case, live, device, seed)
    st = case.statics
    kernel = spec.kernel_step or spec.kernel_fn
    plain = spec.reference_step or spec.reference_fn
    rec = {'case': case.name, 'arm': 'live' if live else 'dry', 'device': device.type,
           **roofline(spec, case, inputs)}
    with torch.no_grad():
        library = spec.library_fn(**inputs, **st) if spec.library_fn is not None else None
        rec['kernel_ms'] = timer(lambda: kernel(**inputs, **st), True)
        rec['call_ms'] = timer(lambda: kernel(**inputs, **st), False)
        rec['plain_ms'] = timer(lambda: plain(**inputs, **st), False)
        rec['library_ms'] = timer(library, True) if library is not None else None
    rec['bound_share'] = rec['bound_ms'] / rec['kernel_ms'] if rec['kernel_ms'] else None
    rec['vs_library'] = (rec['library_ms'] / rec['kernel_ms']
                         if rec['library_ms'] is not None and rec['kernel_ms'] else None)
    rec['win'] = bool(rec['call_ms'] < rec['plain_ms'])
    return rec


def ab_verdict(spec: KernelSpec, *, live: bool = True, device='cuda', seed: int = 0,
               timer: Optional[Callable] = None) -> Dict:
    """The keep / delete / pending record of one kernel: parity at every
    case's dry arm (and live arm with ``live``), then the A/B at every case.
    Each case's inputs for the A/B arm are drawn once, on the host, and
    moved to ``device`` for parity and again for the A/B: the same values
    (every spec draws with numpy and then moves), without drawing the main
    path's large leaf sets twice. The cases are drawn side by side in
    threads (numpy's generators release the interpreter lock; each case has
    its own, seeded)."""
    from concurrent.futures import ThreadPoolExecutor
    device = torch.device(device)
    rec: Dict = {'kernel': spec.name, 'regime': spec.regime, 'gate': spec.gate,
                 'backend': device.type, 'backends_claimed': list(spec.backends)}
    with ThreadPoolExecutor(max_workers=min(8, len(spec.cases))) as pool:
        drawn = dict(zip((case.name for case in spec.cases),
                         pool.map(lambda case: _inputs(spec, case, live, 'cpu', seed),
                                  spec.cases)))
    arms = (False, True) if live else (False,)
    parity = [parity_check(spec, case, live=arm, device=device, seed=seed,
                           inputs=_on(drawn[case.name], device) if arm == live else None)
              for case in spec.cases for arm in arms]
    rec['parity'] = parity
    rec['parity_max_err'] = max(p['max_abs_err'] for p in parity)
    rec['parity_tol'] = spec.parity_tol
    rec['parity_ok'] = all(p['ok'] for p in parity)
    if spec.error_bound is not None:
        rec['error_over_bound'] = max(p['error_over_bound'] for p in parity)
    if not rec['parity_ok']:
        rec['verdict'] = 'delete'
        over = (f', error over bound {rec["error_over_bound"]:.3g} (<= 1)'
                if 'error_over_bound' in rec else '')
        rec['reason'] = (f'parity failure: max err {rec["parity_max_err"]:.3g} (tol '
                         f'{spec.parity_tol:.3g}){over}: wrong beats slow')
        return rec
    if device.type not in spec.backends:
        rec['verdict'] = 'pending'
        rec['reason'] = (f'regime claims {"/".join(spec.backends)}; this run is on '
                         f'{device.type} (parity only): a run on the card settles the gate')
        return rec
    rec['cases'] = [ab_case(spec, case, live=live, device=device, seed=seed, timer=timer,
                            inputs=_on(drawn[case.name], device))
                    for case in spec.cases]
    rec['vs_library'] = {c['case']: c['vs_library'] for c in rec['cases']
                         if c['vs_library'] is not None}
    lost = [c['case'] for c in rec['cases'] if not c['win']]
    rec['verdict'] = 'delete' if lost else 'keep'
    rec['reason'] = (f'loses to the plain version at: {", ".join(lost)}' if lost
                     else 'beats the plain version at every declared case')
    return rec


def run_kernel_ab(*, live: bool = True, device='cuda', seed: int = 0,
                  timer: Optional[Callable] = None) -> List[Dict]:
    """One verdict record per registered kernel (sorted by name)."""
    return [ab_verdict(spec, live=live, device=device, seed=seed, timer=timer)
            for spec in registry.all_specs()]


def format_verdict_line(rec: Dict) -> str:
    line = (f"kernel {rec['kernel']}: {rec['verdict'].upper()} "
            f"[parity {rec['parity_max_err']:.2e} <= {rec['parity_tol']:.0e}: "
            f"{'ok' if rec['parity_ok'] else 'FAIL'}")
    if 'error_over_bound' in rec:
        line += f", error/bound {rec['error_over_bound']:.2f} <= 1"
    line += f"] — {rec['reason']}"
    vs = rec.get('vs_library')
    if vs:
        line += ' [vs library: ' + ', '.join(f'{k} {v:.2f}x' for k, v in vs.items()) + ']'
    return line
