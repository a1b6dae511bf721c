"""Probes of GMRES's small least squares inside device ``while`` loops, and Krylov block times, on one CUDA card.

``pysdc_tpu_torch/ops/krylov.py:_lstsq`` solves GMRES's least squares by a Cholesky factor inside each restart,
which the fused lanes capture as the body of a conditional WHILE node holding the Arnoldi loop's node.  This script
holds the forms of that solve against the graph loop, and times the Krylov paths.  Modes (CUDA 12.3+):

    python3 krylov_probe.py graphs KIND
        KIND: chol (cholesky_ex + cholesky_solve), potrf (cholesky_ex), potrs (cholesky_solve) or triangular
        (cholesky_ex + two solve_triangular, the form _lstsq takes).  Four graphs: the solve in the body of a
        one-level device loop, and before, after and inside a loop nested in that body.  Each graph is replayed
        with new inputs and held against the plain loop; prints OK or the error of each.
    python3 krylov_probe.py block [--n N] [--lstsq FORM]
        the fused GMRES block of HeatND N^2 float64 (ShardedController(4), 2 iterations a step) with _lstsq in
        FORM (default cholesky_solve): prints whether its graphs capture, instantiate and replay.
    python3 krylov_probe.py times [--root DIR] [--lstsq FORM] [--kind CG|GMRES] [--eager N]
        CG and GMRES (or --kind): eager at 512^2 (ControllerNonMPI, 2 steps: chip_smoke.py's phase 28) three
        times (--eager N: N times, and no block; --profile: one more under the profiler, which prints its CUDA
        runtime calls and kernels by count), and one block of HeatND 2048^2 float64 (ShardedController(4),
        2 iterations a step: phase 68) on the stage lane and, where the package captures it, the fused lane,
        twice each, CUDA events.  --root imports
        pysdc_tpu_torch from DIR (another commit unpacked with ``git archive``), so that two commits are timed
        in one call, one process each; --lstsq swaps _lstsq for FORM (written: the factor and substitutions
        written out in elementwise operations; cholesky_solve; triangular).

Each line of results starts with GRAPHS, BLOCK or TIME.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback


def lstsq_forms(torch):
    """name -> ``_lstsq(a, b)``: the least squares through the normal equations in each form."""

    def cholesky_solve(a, b):
        ah = a.T.conj()
        L, _ = torch.linalg.cholesky_ex(ah @ a)
        return torch.cholesky_solve((ah @ b).unsqueeze(-1), L).squeeze(-1)

    def triangular(a, b):
        ah = a.T.conj()
        L, _ = torch.linalg.cholesky_ex(ah @ a)
        y = torch.linalg.solve_triangular(L, (ah @ b).unsqueeze(-1), upper=False)
        return torch.linalg.solve_triangular(L.mH, y, upper=True).squeeze(-1)

    def written(a, b):
        ah = a.T.conj()
        g, rhs = ah @ a, ah @ b
        n = g.shape[0]
        L = torch.zeros_like(g)
        for j in range(n):  # g = L L^H, column by column
            row = L[j, :j]
            L[j, j] = torch.sqrt((g[j, j] - (row * row.conj()).sum()).real).to(g.dtype)
            if j + 1 < n:
                L[j + 1:, j] = (g[j + 1:, j] - (L[j + 1:, :j] * row.conj()).sum(-1)) / L[j, j]
        y = torch.zeros_like(rhs)
        for j in range(n):  # L y = rhs
            y[j] = (rhs[j] - (L[j, :j] * y[:j]).sum()) / L[j, j]
        x = torch.zeros_like(rhs)
        for j in reversed(range(n)):  # L^H x = y
            x[j] = (y[j] - (L[j + 1:, j].conj() * x[j + 1:]).sum()) / L[j, j].conj()
        return x

    return dict(cholesky_solve=cholesky_solve, triangular=triangular, written=written)


def graphs(kind):
    import torch

    from pysdc_tpu_torch.ops import graph_loop

    n = 20  # GMRES's restart
    forms = lstsq_forms(torch)

    def system(x):
        a = x[: (n + 1) * n].reshape(n + 1, n) * 0.1 + torch.eye(n + 1, n, dtype=x.dtype, device=x.device)
        return a, x[: n + 1]

    def solve(x):
        a, b = system(x)
        if kind == 'chol':
            return forms['cholesky_solve'](a, b)
        if kind == 'triangular':
            return forms['triangular'](a, b)
        if kind == 'potrf':
            return torch.linalg.cholesky_ex(a.T @ a)[0][:, 0]
        L = torch.eye(n, dtype=x.dtype, device=x.device) * (1 + x[0].abs())
        return torch.cholesky_solve((a.T @ b).unsqueeze(-1), L).squeeze(-1)

    def flag(c):
        return c[1] < c[2]

    for place in ('onelevel', 'before', 'after', 'inner'):
        loop = [graph_loop.plain_while]

        def update(x):
            x = x.clone()
            x[:n] = x[:n] + 1e-3 * solve(x)
            return x

        def inner_body(c):
            x, k, t = c
            if place == 'inner':
                x = update(x)
            return 0.9 * x + 0.01 * torch.sin(x), k + 1, t

        def outer_body(c):
            x, k, t = c
            if place == 'before':
                x = update(x)
            if place != 'onelevel':
                (x, _, _), _ = loop[0](flag, inner_body, (x, torch.zeros_like(t), (k % 3 + 1).to(t.dtype)))
            if place in ('after', 'onelevel'):
                x = update(x)
            return x, k + 1, t

        def run(x, t, how):
            loop[0] = how
            (x, k, _), _ = how(flag, outer_body, (x, torch.zeros_like(t), t))
            return x, k

        graph_loop.prepare('cuda')
        x_in = torch.randn(4096, dtype=torch.float64, device='cuda')
        t_in = torch.full((), 3, dtype=torch.int32, device='cuda')
        run(x_in.clone(), t_in.clone(), graph_loop.plain_while)  # warm-up: plans and handles before the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = run(x_in, t_in, graph_loop.device_while)
            x_in.normal_()
            t_in.fill_(4)
            graph.replay()
            torch.cuda.synchronize()
            want = run(x_in.clone(), t_in.clone(), graph_loop.plain_while)
            print(f'GRAPHS {kind} {place}: OK, trips {int(out[1])} (plain {int(want[1])}), max diff to the plain loop '
                  f'{(out[0] - want[0]).abs().max().item():.3e}', flush=True)
        except Exception as e:  # noqa: BLE001 - report and go on to the next graph
            print(f'GRAPHS {kind} {place}: FAIL {type(e).__name__}: {str(e).splitlines()[0][:200]}', flush=True)


def _heat(torch, kind, n, maxiter):
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    return dict(problem_class=HeatND,
                problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device='cuda',
                                    solver_type=kind, lintol=1e-10),
                sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                level_params=dict(dt=0.01, restol=1e-8), step_params=dict(maxiter=maxiter))


def _swap_lstsq(torch, form):
    if form:
        from pysdc_tpu_torch.ops import krylov

        krylov._lstsq = lstsq_forms(torch)[form]


def block(n, form):
    import torch

    from pysdc_tpu_torch import ShardedController

    _swap_lstsq(torch, form)
    fused = ShardedController(4, {'logger_level': 30}, _heat(torch, 'GMRES', n, 2))
    u0 = fused.MS[0].levels[0].prob.u_exact(0.0)
    try:
        fused.run(u0, 0.0, 0.04, lane='fused')
        fused.run_fused(u0, 0.0, 0.04)
        torch.cuda.synchronize()
        print(f'BLOCK GMRES {n}^2 with _lstsq {form}: captured, instantiated and replayed', flush=True)
    except Exception as e:  # noqa: BLE001 - the point is where it fails
        print(f'BLOCK GMRES {n}^2 with _lstsq {form}: FAIL {type(e).__name__}: {str(e).splitlines()[0][:200]}',
              flush=True)
        traceback.print_exc(limit=6)


def _events_ms(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _profile_counts(torch, fn):
    """The CUDA runtime calls and the kernels of one call of ``fn()``, by count, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    api = {e.key: e.count for e in events if e.key.startswith('cuda')}
    kernels = sum(e.count for e in events if getattr(e, 'device_type', None) == torch.autograd.DeviceType.CUDA)
    ops = sum(e.count for e in events if e.key.startswith('aten::'))
    return ops, kernels, dict(sorted(api.items(), key=lambda kv: -kv[1])[:8])


def times(tag, form, kinds, eager, profiled=False):
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, ShardedController, get_sorted

    _swap_lstsq(torch, form)
    tag = f'{tag} lstsq={form or "as-is"}'
    for kind in kinds:
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, _heat(torch, kind, 512, 20))
        u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
        ctrl.run(u0, 0.0, 0.02)
        runs = [_events_ms(torch, lambda: ctrl.run(u0, 0.0, 0.02)) for _ in range(eager or 3)]
        niter = [v for _, v in get_sorted(runs[-1][1][1], type='niter', sortby='time')]
        print(f'TIME {tag} eager {kind} 512^2 2 steps: {", ".join(f"{ms:.3f}" for ms, _ in runs)} ms, niter {niter}',
              flush=True)
        if profiled:
            ops, kernels, api = _profile_counts(torch, lambda: ctrl.run(u0, 0.0, 0.02))
            print(f'TIME {tag} eager {kind} 512^2 profile: {ops} aten ops, {kernels} kernels and copies on the card, '
                  f'runtime calls {api}', flush=True)
        del ctrl
        if eager:
            continue
        lanes = {}
        for lane in ('stage', 'fused'):
            ctrl = ShardedController(4, {'logger_level': 30}, _heat(torch, kind, 2048, 2))
            u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
            if lane == 'fused' and ctrl.MS[0].levels[0].prob.graph_capture_blocker is not None:
                print(f'TIME {tag} fused {kind}: refused by this package', flush=True)
                continue
            ctrl.run(u0, 0.0, 0.04, lane=lane)  # warm-up (the fused lane captures here)
            again = (lambda: ctrl.run_fused(u0, 0.0, 0.04)) if lane == 'fused' else \
                (lambda: ctrl.run(u0, 0.0, 0.04, lane='stage'))
            runs = [_events_ms(torch, again) for _ in range(2)]
            lanes[lane] = runs[-1][1][0]
            print(f'TIME {tag} {lane} {kind} 2048^2 block of 4 steps: {", ".join(f"{ms:.3f}" for ms, _ in runs)} ms',
                  flush=True)
            del ctrl
            torch.cuda.empty_cache()
        if len(lanes) == 2:
            print(f'TIME {tag} {kind} |uend fused - uend stage| {(lanes["fused"] - lanes["stage"]).abs().max().item():.3e}',
                  flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('mode', choices=('graphs', 'block', 'times'))
    parser.add_argument('kind', nargs='?', choices=('chol', 'potrf', 'potrs', 'triangular'))
    parser.add_argument('--n', type=int, default=256)
    parser.add_argument('--root', default=None, help='import pysdc_tpu_torch from this directory')
    parser.add_argument('--lstsq', choices=('cholesky_solve', 'triangular', 'written'), default=None)
    parser.add_argument('--kind', choices=('CG', 'GMRES'), default=None, help='times: one solver only')
    parser.add_argument('--eager', type=int, default=0, help='times: N eager runs, no block')
    parser.add_argument('--profile', action='store_true', help='times: count runtime calls and kernels of one more')
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print('krylov_probe.py needs a CUDA card', file=sys.stderr)
        return 1
    root = os.path.abspath(args.root or os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import pysdc_tpu_torch

    if not os.path.abspath(pysdc_tpu_torch.__file__).startswith(root + os.sep):
        print(f'pysdc_tpu_torch came from {pysdc_tpu_torch.__file__}, not {root}', file=sys.stderr)
        return 1
    if args.mode == 'graphs':
        graphs(args.kind)
    elif args.mode == 'block':
        block(args.n, args.lstsq or 'cholesky_solve')
    else:
        times(args.root or '.', args.lstsq, (args.kind,) if args.kind else ('GMRES', 'CG'), args.eager, args.profile)
    return 0


if __name__ == '__main__':
    sys.exit(main())
