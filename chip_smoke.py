"""Smoke run of the PyTorch/CUDA port (``pysdc_tpu_torch``) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc`` for ``sm_90a``)::

    python3 chip_smoke.py

It imports nothing of JAX or ``pysdc_tpu``.  Phases, in order; any failure
raises and the script exits nonzero without printing the final line:

1. build   — compile every kernel of the port from ``pysdc_tpu_torch/csrc``,
   one ``nvcc`` per source, all at once.
2. kernels — K1 (``cross_stencil_2d``) against its plain version on the card,
   float32 and float64, several tap tables and shapes, each on the path the
   wrapper picks (bands or general) and with the general path forced.
3. main    — ``ControllerNonMPI`` on HeatND 2048^2 periodic, float32, M=4
   RADAU-RIGHT, QI='LU', dt=0.01, 4 steps of 8 sweeps; the K1 launch count
   must equal what the ``niter`` stats imply, every launch on the bands
   path; ``uend`` against the exact solution and against the same run through
   the plain apply.
4. parity  — HeatND 256^2 float64, restol 1e-10: ``niter`` and ``uend`` on the
   card against the port's CPU run of the same description.
5. times   — the card's copy rate; K1 on both paths (eager, host enqueue,
   CUDA graph), its plain version, a library yardstick and the main-path
   sweep, with CUDA events.
6. sparse kernels — K2 (``dia_spmv``) and K3 (``bsr_spmm``) against their
   plain versions on the card, float32 and float64, on the sparse lane's
   matrices and batch shapes; K3 on the path the wrapper picks (stream or
   general) and with the general path forced.
7. sparse main — ``ControllerNonMPI`` on VarCoeffDiffusion2D 1024^2, float32,
   Dirichlet-0, M=4 RADAU-RIGHT, QI='LU', dt=1e-3, 4 steps of 8 sweeps (the
   PCG lane); the K2 launch count must equal the operator's SpMV count;
   ``uend`` against the same run through the plain rolls.
8. block-sparse path — the M node values of a short 256^2 run applied
   through ``SparseOperator.apply_bsr`` (K3), against the nodes' RHS.
9. sparse parity — float64 on the card against the port's CPU run:
   VarCoeffDiffusion2D 128^2 (equal ``niter``, ``uend`` to 1e-11) and
   HeatND(backend='sparse') 256^2 periodic (against ``u_exact`` and the
   eigen backend; PCG with its exact preconditioner takes <= 2 iterations).
10. sparse times — K2 and K3 (both paths) with their plain versions and
   library yardsticks, one sparse sweep at 1024^2 and its parts.
11. pfasst — ``ControllerNonMPI(8, ...)`` on the two-level PFASST configuration
   of bench.py:512-531 (HeatND 512^2 / 256^2 periodic, float32, 3 / 2 nodes,
   restol 1e-3, burn-in predictor, one block of 8 steps): every step
   converges; the K1 launch count equals the number of operator applies on
   both levels, all on the bands path, at shapes and taps that phase 2
   covered; ``uend`` against the same run through the plain apply (equal
   ``niter``) and against the same run in float64.
12. pfasst parity — float64 on the card against the port's CPU run: PFASST
   128^2 / 64^2 with 4 steps, and two-level MLSDC with ``FFTTransfer``.
13. imex — ``HeatNDForced`` 2048^2 float32 with ``IMEXSweeper`` (M=4, LU), 2
   steps of 8 sweeps; K1 launch count, ``uend`` against the exact solution.
14. multi-level times — one PFASST block by stage (CUDA events and the host
   clock), one restrict and one prolong at 512^2 -> 256^2, the block at
   2048^2 / 1024^2 with 4 steps, and 8 sweeps through ``diagonal_sweeps`` (the
   operator's diagonal basis) against ``update_nodes_k`` (8 ``update_nodes`` calls).
15. fused — the same PFASST block through ``ShardedController(8, ...)``: the
   block controller keeps the 8 steps in tensors with a time axis, and its
   fused lane replays the block as captured CUDA graphs.  ``niter`` equal to
   the stage machine's of phase 11, ``uend`` within 1e-5 of it; K1 launches
   counted, all on the bands path, at shapes that phase 2 covered; the lane
   entry and the stats types of the contract; one graph a block (its PFASST
   loop a device ``while``), no ``cont`` read and one fetch; then the block
   controller's eager stage lane likewise.
16. fused march — 4 blocks of 8 steps at 512^2 / 256^2 (relative residuals,
   so that the decaying solution iterates in every block), and ``HeatNDForced``
   with ``IMEXSweeper`` at 512^2 (single level, 4 steps a block, 3 blocks and
   a tail of 2 steps), each against ``ControllerNonMPI`` on the card: equal
   ``niter`` per step, ``uend`` to 1e-5, no ``cont`` read and one fetch a
   march, which runs under ``set_sync_debug_mode('error')`` from its first
   replay to its fetch.  Times and windows are inputs of the graphs: a frozen
   forcing time would show here.
17. fused parity — float64, ``run_fused`` on the card against the CPU at
   128^2 / 64^2, 4 steps: equal ``niter``, ``uend`` to 1e-11.
18. fused times — the fused block beside the stage machine's of phase 14: ms on
   the card and on the host clock, kernels by the profiler, host reads, idle
   share; the eager stage lane of the block controller; the diagonal-basis
   coarse chain against the serial one; the block at 2048^2 / 1024^2 with its
   peak memory; the serial march of 8 one-step blocks.

19. adaptive kernels — K1 against its plain version at the shapes and taps
   of the adaptive paths (the blocks of 4 steps at 256^2 / 128^2 and 1024^2 /
   512^2, the Allen-Cahn node stacks), float32 and float64, both paths.
20. adaptive — the adaptive production stack of bench.py:621-673 (HeatND 256^2
   / 128^2 periodic, float32, 3 / 2 nodes, ``restol=-1``, ``maxiter=4``,
   ``Adaptivity(e_tol=1e-5, dt_max=0.05, dt_min=1e-4)``, burn-in, 4 steps a
   block) through ``ShardedController.run``: ``lane='auto'`` must take the
   adaptive fused lane, which is held against ``lane='stage'``: equal
   ``niter`` and ``restart`` per step, equal step count, accepted ``dt``
   (to 1e-4 with the serial coarse chain on both lanes, where the two lanes
   do the same arithmetic; with the production ``'diag'`` chain to the float32
   floor of the estimate, stated), ``uend`` to 1e-5; ONE program of three
   graphs over a march of at least three distinct ``dt``; no ``cont`` read,
   one fetch a block; K1 through the wrapper only in warm-up and capture, all
   on bands, at no shape the kernel check did not cover; the stats types of
   the fused-adaptive column of the README's contract.  Then the same at
   1024^2 / 512^2 over at least 4 blocks.
21. adaptive allen-cahn — ``AllenCahnPeriodicSemiImplicitND`` 1024^2 / 512^2
   float32 (eps 0.04), ``IMEXSweeper`` M=3 LU / EE, ``Adaptivity`` with a
   ``StepSizeLimiter``, 4 steps a block, the same gates; and the 20 sweeps of
   bench.py:209-244 at 1024^2, M=4, dt=1e-4 (K1 launches = applies, against
   the plain apply).
22. adaptive parity — float64, the card against the CPU on the adaptive
   lane: VanDerPol with 1 and 4 steps a block, both estimator flavours, and
   Allen-Cahn 32^2 / 16^2: equal ``niter`` and ``restart``, ``dt`` and
   ``uend`` to 1e-10 (Allen-Cahn's ``dt`` to 1e-7: its estimates sit close
   above float64 roundoff).
23. adaptive times — each march by lane: ms on the card and on the host
   clock, kernels and busy time by the profiler, idle share, host reads, ms a
   graph.

24. implicit kernels — K1 against its plain version at the shapes and taps of
   the Newton-Krylov paths (the fully implicit Allen-Cahn operator at 1024^2
   and 128^2, HeatND's CG / GMRES runs), float32 and float64, both paths.
25. implicit — the slice's main path: ``AllenCahnPeriodicND`` 1024^2 float64
   (eps 0.04, newton_tol 1e-10; bench.py:899 and :209 in the fully implicit
   splitting of examples/step_20_allen_cahn_campaign.py:34), ``GenericImplicit``
   M=3 RADAU-RIGHT LU, dt 2e-4, restol 1e-8, maxiter 12, 4 steps, through
   ``ControllerNonMPI``: every step converges, every Newton solve reaches
   newton_tol, the K1 launch count equals the eval_f applies plus what the
   Newton / PCG traces imply (1 + sum(3 + PCG steps computed) a solve), all on
   bands at shapes phase 24 covered; host reads exactly ceil(k / R) + 1 a
   loop; against the same run through the plain apply: equal ``niter`` and
   traces, ``uend`` to 1e-10.
26. implicit parity — the same at 128^2 on the card against the CPU: equal
   ``niter`` and traces, ``uend`` to 1e-11.
27. implicit fused — the 128^2 problem through ``ShardedController(4).run``:
   ``'auto'`` takes the fused lane (Newton and PCG captured as device
   ``while`` loops, run to tolerance) and equals the stage lane (``niter``,
   ``uend`` to 1e-10); a replayed block passes the K1 wrapper 0 times and runs
   as many K1 kernels (profiler) as the stage lane's applies.
28. krylov and spectral — HeatND 512^2 float64 with CG and GMRES (lintol
   1e-10) against the direct solve, and at 128^2 card against CPU (equal counts
   a solve); each spectral model at 64^2 card against CPU; the multi-implicit
   Gray-Scott problems' pointwise Newton.
29. implicit times — one sweep of the main path by kind of work (K1, cuFFT,
   the rest, idle); the sweep at 1024^2 and 128^2 and the 1024^2 sparse sweep
   with ``READ_EVERY`` 1 (the module's value) and 2 in 10 alternating pairs,
   host reads and work a sweep; the 128^2 sweep again with every K1 call
   routed through its ``autograd.Function`` against the bare launch that
   ``cross_stencil_2d`` makes where no gradient is asked, in 10 alternating
   pairs, and one apply at 128^2 both ways (host ms a call).

30. multi-implicit — the slice's main path: the multi-implicit splitting of
   examples/step_20_allen_cahn_campaign.py:65, ``AllenCahnPeriodicMultiImplicitND``
   1024^2 float64 (eps 0.04, newton_tol 1e-10), ``MultiImplicitSweeper`` M=3
   RADAU-RIGHT Q1=Q2=LU, dt 2e-4, restol 1e-8, maxiter 12, 4 steps, through
   ``ControllerNonMPI``: every step converges, every pointwise Newton solve
   reaches newton_tol (below newton_maxiter), the K1 launch count (counts set to 0 just
   before) equals the eval_f applies, all on bands at shapes phase 24 covered;
   against the same run through the plain apply: equal ``niter``, ``uend`` to
   1e-10.
31. multi-implicit parity — the same at 128^2 on the card against the CPU:
   equal ``niter``, ``uend`` to 1e-11.
32. multi-implicit fused — the 128^2 problem through ``ShardedController(4).run``:
   ``'auto'`` takes the fused lane (as the JAX package does) and equals the
   stage lane (``niter``, ``uend`` to 1e-10); a replayed block passes the K1
   wrapper 0 times.
33. rk — ``ESDIRK43`` on HeatND 2048^2 float32 (dt 0.01, 4 steps) and
   ``ARK548L2SA`` on HeatNDForced 2048^2 float32 (2 steps) through
   ``ControllerNonMPI``: K1 launches equal the eval_f calls the tableau implies
   (the predictor's and each stage the sweep evaluates), all on bands;
   ``uend`` against the plain apply and ``u_exact`` to 5e-4 (ARK548L2SA, whose
   end point contracts the stages' ``A u``: to the float32 floor that this
   implies, stated; in float64 to 1e-10 and 5e-4); ESDIRK43 in float64 on the
   card within twice the time error that a float64 CPU run at 256^2 measures.
34. rk parity — float64 card against CPU: ESDIRK43 on HeatND 256^2 to 1e-11,
   all 27 tableaus on Dahlquist (16 complex lambdas, complex128; the IMEX pairs
   on DahlquistIMEX) to 1e-13.
35. rk adaptive — Cash-Karp with ``AdaptivityRK`` on VanDerPol through
   ``ShardedController(1).run``: ``'auto'`` takes the adaptive fused lane, held
   against ``lane='stage'`` and against the CPU (equal steps and restarts,
   accepted ``dt`` to 1e-7, ``uend`` to 1e-10), one program of three graphs
   over every ``dt``; ESDIRK43 with ``AdaptivityRK(e_tol=1e-5)`` on HeatND
   2048^2 float32 (to 1e-3: the float32 estimate is rounding there) and float64
   (to 0.1), steps, restarts, ``dt``, K1 launches; at 256^2 float64 card against
   CPU (``dt`` to 1e-6: the rounding of A u that reaches the estimate, stated).
36. sweepers parity — float64 card against CPU: ``ExplicitSweeper`` on HeatND
   256^2, ``LinearizedImplicitParallel`` in its three configurations on
   Fisher 255 (examples/step_14_sdc_showdown.py:56), each multistep class on
   Logistic, the multi-implicit Gray-Scott classes at 64^2: equal ``niter``,
   ``uend`` to 1e-11.
37. sweeper times — one multi-implicit sweep at 1024^2 by kind of work (K1,
   cuFFT, the pointwise Newton solves, the rest, idle) beside the fully
   implicit sweep; one ESDIRK43 step at 2048^2 beside the main path's sweep.

38. paradiag kernels — K1 on the interleaved real view of complex blocks
   (ParaDiag's state) against the plain complex rolls, complex64 and complex128,
   at the block shapes of phases 39-40 (8 x 3 x 512^2, 8 x 3 x 2048^2, 4 x 3 x
   128^2): the path ``choose_path`` gives the doubled y table (bands or general)
   and the general path forced, with the stated tolerance.
39. paradiag — bench_paradiag's configuration (bench.py:844-870): HeatND 512^2
   periodic float32 (a complex64 block), nu 0.1, freq 4, ``QDiagonalization``
   M=3 RADAU-RIGHT, L=8, alpha 1e-4, dt 0.01, restol 1e-4, maxiter 10, one block
   through ``ParaDiagController.run``: every step reaches restol, the K1 launch
   count (counts set to 0 just before) equals the iterations, each on the path
   phase 38 covered; ``uend`` against ``u_exact``, against the same run through
   the plain apply (equal ``niter``) and against a float64 run on the card.
   Then the same block at 2048^2 (float32 cannot reach restol there: every
   final residual within the stated float32 floor), with its peak memory.
40. paradiag parity — float64 on the card against the port's CPU run: HeatND
   128^2 with L=4, Dahlquist (16 lambdas), VanDerPol (tests/test_paradiag.py:70-77)
   and ``QDiagonalization(ignore_ic=False)`` as a direct collocation solver:
   equal ``niter`` per step, ``uend`` to 1e-11.
41. second order — float64 card against CPU (equal ``niter``, ``uend`` to
   1e-11): ``VerletSweeper`` on ``FermiPastaUlamTsingou`` with 2048 particles,
   50 steps, and its energy drift; ``BorisSDC`` on ``PenningTrap3D`` with one
   particle at two step sizes (the order against the analytic orbit) and with
   1024 particles (the pairwise (3, N, N) Coulomb sum); ``RKN4`` on
   ``HarmonicOscillator``.
42. dae — float64 card against CPU: ``FullyImplicitDAE`` and ``SemiImplicitDAE``
   on ``SimpleDAE``, ``FullyImplicitDAE`` on ``Pendulum2D`` (constraint to 1e-10,
   each component to its stated tolerance), ``EDIRK4DAE``: equal ``niter``,
   ``uend`` to 1e-11, every Newton solve stopped before its maxiter.
43. paradiag times — one ParaDiag iteration at 512^2 and 2048^2: ms on the card
   and the host clock, busy time by kind of kernel (K1, cuFFT, the complex
   products, the rest) and the idle share, and from a CUDA graph of one
   iteration (for timing only: the controller stays eager); bench_paradiag's
   rate figure; the block through ParaDiag beside the same 8 steps through
   ``ControllerNonMPI`` with ``GenericImplicit`` M=3 LU; K1 on the complex64
   block (8, 3, 512, 1024) as float32 against its bound and the complex rolls.

44. resilience — the Resilience campaign on the main path's width: HeatND
   2048^2 periodic float64 (nu 0.1, freq 2), M=4 RADAU-RIGHT LU, dt 0.01,
   restol -1, maxiter 5, 8 steps, through ``ControllerNonMPI``.  K1 against its
   plain version at the path's shapes, float64, on bands; ``HotRod`` without a
   fault: no restart, the largest |e_em - e_ex| recorded and ``HotRod_tol`` set
   at 10 times it; with a ``FaultInjector`` that flips exponent bit 10 at step
   6, iteration 3, the last node, one interior point: the fault happened,
   exactly that step restarts, ``uend`` equals the fault-free run's to 1e-12
   relative; the same fault at iteration 5 without Hot Rod leaves an error
   against ``u_exact`` at least 1e3 times larger; K1 launches equal what
   ``niter`` and the restart imply (and the injector's one evaluation), all on
   bands at the shapes covered.
45. flavours — ``AdaptivityResidual``, ``AdaptivityPolynomialError``,
   ``AdaptivityExtrapolationWithinQ`` and ``AdaptivityCollocation`` (with
   ``AdaptiveCollocation``, M 3 then 4) on the same problem to t = 0.05: against
   the plain apply on the card (equal ``niter`` and restarts, ``dt`` to 1e-8,
   ``uend`` to 1e-11 beyond what the end times' gap explains), at 256^2 on the
   card against the CPU (the same, and every estimate to 1e-10 relative above a
   rounding floor of 1e-13 max|u|); ``LogWork``: ``work_rhs`` is M per sweep.
46. inexactness — ``NewtonInexactness`` on phase 25's fully implicit
   Allen-Cahn path (1024^2 float64): every step converges, ``newton_tol``
   follows ratio x residual after every iteration, K1 launches equal what the
   eval_f applies and the Newton / PCG traces imply; on the block controller's
   stage lane at 128^2 the ``(P,)`` tolerances each sweep reads equal
   ``ControllerNonMPI``'s.
47. switch — ``SwitchEstimator`` on ``Battery``, ``BatteryNCapacitors`` (two
   switches), ``DiscontinuousTestODE`` and ``DiscontinuousTestDAE`` (contact),
   float64 card against CPU: ``t_switch`` to 1e-12, ``nswitches``, step counts,
   ``dt`` and ``uend``; ``ShardedController(4).run`` on ``DiscontinuousTestODE``
   takes the stage lane with the ``(P,)`` ``t_switch`` and equals
   ``ControllerNonMPI(4)`` entry for entry.
48. resilience times — one step of phase 44's run with and without Hot Rod and
   its estimators: ms on the card (CUDA events) and the host clock, busy time
   and idle share (profiler), the estimators' share of the busy time (their
   profiler range), host reads per step.

49. monodomain kernels — K1 against its plain version at the Monodomain paths'
   shapes and taps (the potential plane and the M spread nodes' planes, 2048^2
   and 128^2), float64, on bands and with the general path forced.
50. monodomain — the slice's main path: step 21's ``iteration_comparison``
   (examples/step_21_monodomain_campaign.py:54-79) in 2D at 2048^2 float64:
   ``MonodomainIMEXEXP`` with Hodgkin-Huxley (diff 0.1, L 10) and
   ``IMEXEXPSweeper`` (M=3 RADAU-RIGHT, QI='IE'), dt 0.05, restol 1e-8, maxiter
   50, 4 steps (the stimulus on throughout), beside ``MonodomainIMEX`` with
   ``IMEXSweeper`` (M=3, LU), through ``ControllerNonMPI``: every step
   converges; K1 launches (counts set to 0 just before each run) equal the
   operator applies and sum(2 + M niter), all on bands at shapes phase 49
   covered; ESDC against the same run through the plain apply (equal ``niter``,
   ``uend`` within 10 x steps x dt x 2 n_terms eps sum|c| max|V|); step 21's
   front gate (max|V_esdc - V_imex| below 0.05 max|V|; its niter ratio is
   printed, and gated in phase 51).
51. monodomain parity — float64 card against CPU: the same descriptions at
   128^2 (equal ``niter``, ``uend`` to 1e-11 relative) and step 21's niter gate
   there (ESDC's mean ``niter`` below 1.5 x IMEX's: it holds at step 21's
   resolution, not at 256^2 and up, in the JAX package as in the port), ten
   Tusscher with ESDC at 128^2 for 2 steps, and each ionic model's ``f``,
   ``f_expl``, ``lmbda_exp`` and ``lmbda_yinf_exp`` at (size, 256, 256) to 1e-12
   of each component's largest value (or 4 x the CPU's own change under a 4 eps
   change of the inputs, where the formulas amplify rounding); then the ESDC
   and IMEX descriptions through ``ShardedController(4).run``, whose ``'auto'``
   takes the fused lane (CUDA graphs), against ``ControllerNonMPI(4, ...)`` on
   the card.
52. navier-stokes — ``NavierStokesVorticity2D`` Taylor-Green at 2048^2 float64
   (IMEX M=3 LU, dt 1e-3, restol 1e-10, 4 steps) against ``u_exact`` within
   1e-9 (tests/test_navier_stokes.py:35-40); the random-mode flow at 256^2 card
   against CPU.
53. models parity — float64 card against CPU (equal ``niter``, ``uend`` to 1e-11
   relative): WSCC9 with ``FullyImplicitDAE`` to t = 0.02, ``Quench`` and
   ``QuenchIMEX`` at 128 points, acoustic advection at 512, Boussinesq at
   (150, 20), ``HeatChebyshev1D``, ``Burgers1D``, ``Heat2DChebyshev``,
   ``RayleighBenard`` at (64, 32) for 3 steps and ``RayleighBenard3D`` at
   (16, 16, 8) for 2 steps.
54. monodomain times — one ESDC step and one IMEX step at 2048^2 and one
   Navier-Stokes step at 2048^2: ms on the card (CUDA events) and the host
   clock, busy ms by kind (profiler: cuFFT, the phi tables' range
   ``_lambda_phi_qmat``, the ionic RHS's range, the rest; K1 by CUDA events,
   launches x its ms an apply), idle share, peak memory, the ionic RHS's
   operations an evaluation (a dispatch mode's count; each is one kernel).

55. autograd kernels — K1 under autograd and ``torch.func`` on the card,
   float32 and float64 at 2048^2: the heat table and the 2D periodic advection
   tables (``'center'``: antisymmetric and centred, bands both ways;
   ``'upwind'``: the general path both ways) and the heat table with the general
   path forced: the forward and the adjoint each on the path expected, the
   adjoint identity ``<K u, v> = <u, K^T v>`` within 2 n_terms eps sum|c|
   (max|u| sum|v| + max|v| sum|u|), the adjoint equal to K1 of the mirrored table
   bitwise and to its plain version within 2 n_terms eps sum|c| max|v|, the jvp
   equal to K1 of the tangent bitwise; ``torch.func.vmap(prob.eval_f)`` over 8
   fields equal to the batched apply with exactly one launch; ``gradcheck``
   (fast mode) at 64^2 float64 on both paths; ``jacfwd`` of a 64^2 ``eval_f``
   equal to the dense matrix, in two launches (the primal and all tangents).
56. embedding — the slice's main path: step 26's device-side embedding
   (examples/step_26_embedding_campaign.py:66-92) at the heat path's width,
   HeatND 2048^2 periodic float64, ``GenericImplicit`` M=3 RADAU-RIGHT LU,
   ``make_sdc_step_function(fixed_sweeps=4)``, 10 steps of dt 0.02 in a Python
   loop, MSE against ``forward(u_exact(0))``, from u = 0: one value and
   gradient with K1 launches counted (forward 10 x (2 + 4 x 3) = 140, backward
   130, all on bands); the gradient against the same loss differentiated through
   the plain rolls on the card (relative 1e-10); a directional derivative against
   a central difference (1e-6; the loss is quadratic, so only rounding separates
   them); 5 Adam steps with the loss falling; forward and backward ms (CUDA
   events), K1's share (launches x its ms an apply), peak memory.
57. step 26 — at the example's 48^2 (K1's general path): one value and
   gradient from a seeded point, card against the port's CPU run (gradient
   and loss to 1e-12 relative); the inversion with 300 Adam steps from u = 0
   on the card, its loss below 5e-6 of the first and its log10 reduction
   against the golden ``adjoint_loss_reduction_log10`` through the port's
   ``GoldenStore`` (rtol 0.2; the phase refuses to run while the store's
   write variable is set); ``ControllerAsStepper`` on the example's
   own ``HeatNDForced`` march (128 points, IMEX) against the golden niter and
   error, and the same march at 128^2 (through K1) card against CPU.
58. matrix — ``ControllerMatrixNonMPI`` on HeatND 64^2 periodic float64, 2
   steps, M=3 (each dense matrix 4.5 GiB): the operator by one vmapped K1
   launch on bands; ``niter`` equal to ``ControllerNonMPI``'s, ``uend`` to
   1e-12; the propagation matrix of 5 iterations reproduces the run.
59. logtofile — ``LogToFile`` on the 2048^2 heat path (float32, 2 steps): the
   records read back bitwise, the last one equal to ``uend``; ms a write.
60. linearized — ``LinearizedImplicitParallel`` on HeatND 32^2 float64 (its
   Jacobian by ``jacfwd`` through K1's jvp and vmap rules) card against CPU.

61. mesh halo — ``halo_stencil_apply``, ``halo_cross_apply`` and
   ``halo_cross_apply_batched`` on ``make_mesh(n_space=k, devices=['cuda:0'] * k)``
   for k = 2 and 4, at 2048^2 and 4 x 2048^2, float32 and float64, centred
   tables of radius 1, 2 and 3: one K1 launch a slab, all on bands; against K1
   on the whole field and against the plain halo version (the JAX slices, on
   the CPU) within phase 2's bound 2 n_terms eps sum|c| max|u|; a radius deeper
   than a slab raises before any launch.
62. mesh main — the heat path (HeatND 2048^2 periodic float32, M=4 RADAU-RIGHT
   LU, dt 0.01, 4 steps of 8 sweeps) through ``ShardedController(4).run`` on a
   2 x 2 (time, space) mesh and on a 4-position time mesh of the card (where
   ``'auto'`` must pick the 'owner' chain), and the PFASST block of
   bench.py:512-531 (512^2 / 256^2, 8 steps) on a 4-position time mesh, each
   against the same controller without a mesh: equal ``niter`` and lane,
   ``uend`` within 1e-5 (phase 15's bound; the 2 x 2 mesh against the block
   that also solves by the full complex FFT, as a space-sharded mesh does, and
   within 5e-4 of the half-spectrum one), K1 launches equal to the shards'
   operator applies (one a slab under the halo apply), all on bands; then the
   float64 PFASST block at 128^2 / 64^2 on a 2 x 2 mesh, card against CPU
   (equal ``niter``, ``uend`` to 1e-11).
63. mesh paradiag — bench_paradiag's block (512^2 float32, M=3, L=8, alpha
   1e-4) with its step axis on 8 time positions of the card against the
   unsharded block: equal ``niter``, ``uend`` within phase 39's bound, K1
   launches 8 a iteration (one a shard) on the unsharded block's path.
64. mesh fieldsio — a 2048^2 float32 field sharded over a (4, 2) mesh of the
   card, written slab by slab: byte-equal to the host write.
65. mesh times — each run of phase 62 against the same block without a mesh
   (and, for the 2 x 2 mesh, without a mesh but with the full complex FFT
   solves), on the fused lane that ``run()`` takes and on the stage lane: ms on the
   card (CUDA events) and the host clock, busy time and idle share (profiler),
   copies and gathers a block.  On one card that is what the layout's
   bookkeeping costs, not a scaling figure.
66. graph loop — ``device_while`` (``ops/graph_loop.py``, a CUDA conditional
   WHILE node built into a stream capture, ``csrc/graph_loop.cu``) alone: one
   captured graph of a loop and one of a nested pair, replayed with inputs that
   ask for 0, 1, 37 and more than ``GL_MAXITER`` trips; carry and counter equal
   the plain loop's bit for bit; a replay's ms by trips.
67. sparse fused — the slice's main path: the sparse lane of
   ``bench.py:343-377`` (VarCoeffDiffusion2D 1024^2 float32, M=4 LU, dt 1e-3)
   through ``ShardedController(4).run``, 2 blocks, restol 1e-6, maxiter 8:
   ``'auto'`` takes the fused lane (each PCG solve a device loop with K2
   inside); against ``lane='stage'``: equal ``niter``, ``uend`` within
   SPARSE_FUSED_BOUND; K2 in one replayed block (counted on the card by the
   wrapper at each launch; the profiler's count, which misses the PCG
   node inside the block's node, printed and no larger) equal to the
   stage lane's SpMVs, which its PCG counts imply; no ``cont`` read and one
   fetch a march; ms a block on both lanes, host reads, idle share.
68. krylov fused — HeatND 2048^2 float64 with CG, then GMRES (lintol 1e-10,
   dt 0.01) through ``ShardedController(4).run``, one block cut to 2 iterations
   a step: ``'auto'`` takes the fused lane; against the stage lane equal
   ``niter``, ``uend`` to 1e-10; K1 in a replayed block (counted on the card by
   the wrapper at each launch: the profiler does not see a node inside a node,
   and every solve is a node inside the block loop's) equal to the stage
   lane's applies, all on bands; no ``cont`` read, one fetch a march; ms a
   block on both lanes; K1 in float64 beside ``F.conv2d`` (its library
   yardstick) at (2048, 2048) and (3, 2048, 2048).
69. spectral fused — ``RayleighBenard(nx=256, nz=64)`` float64 (the reference
   class's own resolution), ``IMEXSweeper`` M=3 LU / PIC, dt 0.01, restol -1,
   maxiter 4, through ``ShardedController(4).run``, 2 blocks: ``'auto'`` takes
   the fused lane, one graph a block; against ``lane='stage'`` equal ``niter``,
   ``uend`` to 1e-12 relative; no ``cont`` read, one fetch; the peak device
   memory; the batched solve's kernels by name; ms a block on both lanes and
   the idle share.  First ``ops/linalg.py``'s routes inside a device ``while``
   body, bit for bit against the eager call, and against LAPACK on the CPU to
   ``max(1e-13, 4 eps cond(A))``: random batches and the matrices of phase 72,
   which need pivoting across their halves (the pivoted route from 512 rows).
   Then ``HeatChebyshev1D``, ``Burgers1D`` and ``Heat2DChebyshev`` (phase 53's
   sizes) on the fused lane, card against CPU.
70. linearized fused — phase 60's configuration through
   ``ShardedController(4).run``, one block: the fused lane against the stage
   lane and the CPU (equal ``niter``, ``uend`` to 1e-11); K1 in a replayed block
   (counted on the card) equal to the stage lane's.
71. direct fused — ``HeatND(4095, bc='dirichlet-zero', backend='sparse')``
   (the ``'banded'`` solver) and ``VarCoeffDiffusion2D`` 256^2 with
   ``solver='block_tridiag'``, float64, through ``ShardedController(2).run``,
   one block each: the fused lane against the stage lane and the CPU (equal
   ``niter``, ``uend`` to 1e-12); K2 in a replayed block (counted on the card)
   equal to the stage lane's; ms a block on both lanes.
72. dense LU — both kernels of ``ops/linalg.py``'s pivoted route against
   their plain versions on matrices that need pivoting across their halves
   (RayleighBenard 8x128 and 8x256 modes, HeatChebyshev1D 512, a matrix whose
   leading half is zero): ``lu_panel`` on the first block of 64 columns (the
   same rows, to 1e-12), ``lu_swap_trsm`` at the first, second and last block
   (the same row interchanges, ``U12`` to 1e-12), and on random batches at
   every shape its grid and tiles take: 600 rows (a ragged last block of 24
   columns, a ragged last tile of columns, CTAs that own a ragged number of
   tiles), a batch of 1, a block where no row moves, 1024 rows at a batch of
   12, float32 and complex64 (``U12`` to 1e-5 there); ``Piline``,
   ``BuckConverter`` and ``BatteryNCapacitors`` float64 through
   ``ShardedController(4).run``: the fused lane, one graph a block, against the
   stage lane and the CPU (equal ``niter``, ``uend`` to 1e-12);
   ``RayleighBenard(256, 128)`` float64 (512 rows a mode), 2 blocks: the fused
   lane against the stage lane (equal ``niter``, ``uend`` bitwise equal), no
   ``cont`` read and one fetch, both kernels' launches counted on the card (in
   a replayed block equal to the stage lane's, one of each a block of 64
   columns), ms a block on both lanes; ``RayleighBenard(8, 128)``, one block,
   card against CPU.
73. dense LU times — both kernels at RayleighBenard 256x128's first block
   (complex128) beside their bounds, their plain versions and the torch calls
   they stand for (``lu_factor_ex`` of the panel; the gathers, copies and
   ``solve_triangular`` of the plain version); ``lu_swap_trsm`` at each of the
   route's 8 blocks there, each beside its bound, and their sums; the pivoted
   route at that batch of modes, eager and from a CUDA graph, beside its FP64
   bound and cuSOLVER's ``getrf`` + ``getrs``; at 256 rows beside
   ``_batched_solve``.

Phases 72-73 run right after phase 1, while the card's memory is free: the
graphs and pools of the phases before them in this list keep tens of GiB.
Phase 4 runs right after them (its parity once missed its gate there).

The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2**20

N_MAIN, M_MAIN, DT, N_STEPS, SWEEPS = 2048, 4, 0.01, 4, 8
# fp32 roundoff bounds: this script measured 5.9e-5 and 6.0e-5 on an H100 80GB
# HBM3 at 700 W; each bound leaves about 8x room
UEND_EXACT_BOUND = 5e-4  # |uend - u_exact(0.04)|
UEND_PLAIN_BOUND = 5e-4  # |uend - uend through the plain apply|: the two round differently
PARITY_UEND_TOL = 1e-11  # fp64, card against CPU

# the sparse lane: bench.py's sweep_big configuration (bench.py:343-377)
N_SPARSE, DT_SPARSE = 1024, 1e-3
# float32 roundoff: this script measured 3.0e-6 on an H100 80GB HBM3 at 700 W; the bound leaves 10x room
SPARSE_PLAIN_BOUND = 3e-5  # |uend - uend through the plain rolls|
SPARSE_EIGEN_TOL = 1e-11  # fp64 HeatND 256^2: sparse backend (PCG) against the eigen backend
SPARSE_EXACT_TOL = 1e-6  # fp64 HeatND 256^2: |uend - u_exact(0.04)|, the time-discretization error


# the PFASST lane: bench.py's bench_pfasst_speedup_projected configuration (bench.py:512-531)
N_PFASST, NC_PFASST, P_PFASST, RESTOL_PFASST = 512, 256, 8, 1e-3
# float32 roundoff at max|uend| = 0.081: this script measured |uend(float32) - uend(float64)| = 7.4e-7 on an
# H100 80GB HBM3 at 700 W with equal niter; each bound leaves about 13x room
PFASST_FP64_BOUND = 1e-5  # |uend(float32) - uend(float64)|, both converged to restol 1e-3
PFASST_PLAIN_BOUND = 1e-5  # |uend - uend through the plain apply| in float32, equal niter
N_IMEX, IMEX_STEPS = 2048, 2
# the fused lane: float32 roundoff between the batched block and the step-by-step stage machine (other cuFFT
# batch sizes, sums in another order); this script measured the values it prints on an H100 80GB HBM3 at 700 W
FUSED_STAGE_BOUND = 1e-5  # |uend(fused lane) - uend(stage machine)|, equal niter
MARCH_BLOCKS = 4  # blocks of P_PFASST steps in the multi-block march
N_FORCED, P_FORCED, FORCED_STEPS, M_FORCED = 512, 4, 14, 3  # 3 full blocks and a tail of 2 steps
RESTOL_FORCED = 5e-4  # above the float32 floor of the forced 512^2 residual (about 6e-5: dt * eps * 4 nu / dx^2)
STATS_CONTRACT = {'dt', 'lane', 'niter', 'residual_post_iteration', 'residual_post_step', 'restart'}
# the adaptive lane: bench.py's bench_adaptive_lane configuration (bench.py:621-673), and the same at 1024^2 / 512^2
N_AD, NC_AD, N_AD_BIG, NC_AD_BIG, P_AD, MAXITER_AD = 256, 128, 1024, 512, 4, 4
TEND_AD, TEND_AD_BIG = 16 * DT, 40 * DT  # 3 blocks at 256^2; at least 4 blocks at 1024^2 (dt grows to dt_max)
ADAPTIVE_PARAMS = dict(e_tol=1e-5, dt_max=0.05, dt_min=1e-4)
ADAPTIVE_DT_RTOL = 1e-4  # accepted dt, adaptive fused lane against the stage lane, the same arithmetic on both
# with the 'diag' coarse chain the fused lane's burn-in runs in the operator's diagonal basis and the stage lane's in
# real space: the two round differently, and the estimate |u^4 - u^3| of about 6e-7 at max|u| 0.28 sits 1.5 decades
# above float32 roundoff.  This script measured dt gaps of 1.7e-2 (256^2) and 5.8e-2 (1024^2) on an H100 80GB HBM3
ADAPTIVE_DIAG_DT_RTOL = 0.25
ADAPTIVE_CONTRACT = STATS_CONTRACT | {'timing_run', 'timing_step', 'timing_iteration', 'error_embedded_estimate',
                                      'error_embedded_estimate_post_step'}
# Allen-Cahn, the problem of bench.py:209-244, adaptive over two levels
N_AC, NC_AC, M_AC, DT_AC, TEND_AC = 1024, 512, 3, 2e-4, 6.4e-3
AC_PARAMS = dict(e_tol=1e-5, dt_max=2e-3, dt_min=1e-7)
AC_SWEEPS, AC_SWEEP_M, AC_SWEEP_DT = 20, 4, 1e-4
AC_PLAIN_BOUND = 1e-4  # |u after 20 sweeps - the same through the plain apply|, float32, |u| <= 1
ADAPTIVE_PARITY_TOL = 1e-10  # fp64, card against CPU: dt (relative) and uend
# Allen-Cahn's estimates |u^4 - u^3| of 1e-9 to 1e-7 at |u| = 1 carry the 1e-16 by which cuFFT and the CPU's FFT round
# differently: relative 1e-7 at worst, a fourth of it in dt.  This script measured a dt gap of 3.3e-9 (uend 6.6e-11)
ADAPTIVE_PARITY_DT_TOL_AC = 1e-7
DIAG_SWEEPS_BOUND = 5e-4  # |uend(diagonal_sweeps) - uend(8 x update_nodes)| at 2048^2, the float32 floor above
# the Newton-Krylov slice: the fully implicit Allen-Cahn problem of bench_campaign_ac_1024 (bench.py:899) and
# bench_tpu_allen_cahn (bench.py:209), the 'fully_implicit' entry of examples/step_20_allen_cahn_campaign.py:34, in
# float64: newton_pde's lin_tol of 1e-13 and the newton_tol sit below float32 roundoff at this width
N_FI, M_FI, DT_FI, RESTOL_FI, MAXITER_FI, STEPS_FI, NEWTON_TOL_FI = 1024, 3, 2e-4, 1e-8, 12, 4, 1e-10
NEWTON_MAXITER_FI, LIN_MAXITER_FI = 100, 50  # AllenCahnPeriodicND's default and newton_pde's fixed PCG depth
N_FI_SMALL, P_FI = 128, 4  # card against CPU, and the fused lane (ShardedController(4), one block)
FI_PLAIN_BOUND = 1e-10  # |uend - uend through the plain apply|, float64, equal traces
FI_FUSED_BOUND = 1e-10  # |uend(fused lane) - uend(stage lane)|, float64
# CG / GMRES: HeatND 512^2 periodic float64 with lintol 1e-10 (restol 1e-8: an iterative solve to lintol relative
# leaves a residual floor near lintol); against the direct solve a CPU run measured 2.0e-11 (CG) and 2.7e-13 (GMRES)
N_KRYLOV, N_KRYLOV_PARITY, KRYLOV_LINTOL, KRYLOV_RESTOL, KRYLOV_STEPS = 512, 128, 1e-10, 1e-8, 2
KRYLOV_DIRECT_BOUND = 1e-9
N_SPECTRAL = 64
# the first-order sweepers: the multi-implicit splitting of the fully implicit path's problem (its sizes above), in
# float64 for the same reason (the pointwise Newton's newton_tol of 1e-10 against float32 roundoff of 6e-8 at |u| <= 1)
MI_PLAIN_BOUND = 1e-10  # |uend - uend through the plain apply|, float64, equal niter
MI_FUSED_BOUND = 1e-10  # |uend(fused lane) - uend(stage lane)|, float64
# Runge-Kutta on the main path's problem: ESDIRK43 (4 steps) and ARK548L2SA on HeatNDForced (2 steps) at dt DT
RK_STEPS, RK_IMEX_STEPS, N_RK_PARITY = 4, 2, 256
RK_DAHLQUIST_TOL = 1e-13  # every tableau on Dahlquist, card against CPU
RK_FP64_PLAIN_BOUND = 1e-10  # ARK548L2SA float64 at 2048^2, K1 against the plain apply
VDP_TEND, RK_AD_TEND, RK_AD_TEND_FP32 = 0.5, 0.1, 1e-3  # Cash-Karp on VanDerPol (tests/test_fused.py:363); ESDIRK43
RK_AD_DT_FP32 = 1e-4  # the float32 ESDIRK43 adaptive run's first dt (see phase_rk_adaptive)
RK_DT_RTOL = 1e-7  # accepted dt of the adaptive fused lane against the stage lane and the CPU (tests/test_fused.py)
# card against CPU, ESDIRK43 + AdaptivityRK on HeatND 256^2 float64: the estimate (2.6e-7 at dt 0.01) is the gap
# between two end points of size 1, one of which contracts the stages' f = A u; K1 and the CPU's rolls round f
# differently by 1e-16 times A's row sum (5.2e4 at 256^2), dt * sum|b| = 0.01 of that reaches the gap: 6e-14 of 2.6e-7,
# a fourth of it in dt.  This script measured 1.0e-7 on an H100 80GB HBM3
RK_AD_PARITY_DT_RTOL = 1e-6
DT_EXPLICIT = 5e-6  # ExplicitSweeper on HeatND 256^2: dt |lambda_max| = 0.26, inside explicit SDC's region
# ParaDiag: bench_paradiag's configuration (bench.py:844-870), then the main path's width; card against CPU at 128^2
N_PD, N_PD_BIG, L_PD, M_PD, ALPHA_PD, DT_PD, RESTOL_PD, MAXITER_PD = 512, 2048, 8, 3, 1e-4, 0.01, 1e-4, 10
N_PD_PARITY, L_PD_PARITY = 128, 4
# float32 at 512^2: this script measured |uend - u_exact| 8.2e-7 and 7.4e-7 from float64 at max|uend| 0.08 on an H100
# 80GB HBM3; the rounding of f = A u grows with |A|, as n^2: 1.1e-5 at 2048^2 (the bound scales with it)
PD_EXACT_BOUND = 1e-5  # |uend - u_exact(0.08)|, float32, 512^2; times (n / 512)^2 at n^2
PD_PLAIN_BOUND = 1e-5  # |uend - uend through the plain (complex roll) apply|, float32, equal niter
PD_FP64_BOUND = 1e-5  # |uend(float32) - uend(float64)|, both on the card
# the second-order sweepers: FPUT at the problem's default width, the Penning trap's cloud of charges
N_FPUT, DT_FPUT, STEPS_FPUT = 2048, 1.0, 50
N_PENNING, DT_PENNING, STEPS_PENNING = 1024, 1 / 64, 4
# the index-3 pendulum, card against CPU: positions, velocities, the Lagrange multiplier (rounding amplified by 1/dt^2;
# the port against the JAX package measured 2e-16, 2e-12, 3.8e-9 on the CPU)
PENDULUM_TOLS = (1e-12, 1e-10, 1e-8)
# the Resilience campaign (the reference's projects/Resilience; tests/test_estimators_resilience.py:108) at the main
# path's width: HeatND 2048^2 periodic, M=4 RADAU-RIGHT LU, dt 0.01, restol -1, maxiter 5, 8 steps, in float64: the
# extrapolation estimate contracts f = A u, whose float32 rounding at 2048^2 is about eps 8 nu / dx^2 = 0.4 of max|u|,
# so in float32 Hot Rod would compare two rounding floors.  The fault: exponent bit 10 of one interior point of the
# last node at step 6, iteration 3 (the JAX test's; without Hot Rod at iteration 5, where no sweep can heal it).  A
# point fault diffuses: its peak after the two remaining steps falls as 1/n^2 (this script measured 6.7e-6 at
# 2048^2 on an H100 80GB HBM3).  Each run is held against the fault-free run of the same controllers: against u_exact
# the Hot Rod run's error is that of 4 sweeps (Hot Rod discards the last one), 1.1e-8, and 6.7e-6 is only 614 times it
N_RES, M_RES, DT_RES, MAXITER_RES, STEPS_RES = 2048, 4, 0.01, 5, 8
RES_FAULT_STEP, RES_FAULT_ITER, RES_FAULT_BIT = 6, 3, 10
RES_UEND_RTOL = 1e-12  # |uend(faulted, Hot Rod) - uend(fault-free)| / max|uend|
RES_FAULT_GAIN = 1e3  # what the fault leaves without Hot Rod against what it leaves with it, at least
# the adaptivity flavours on the same problem for FLAVOUR_TEND, then at 256^2 on the card against the CPU.  The
# step sizes come from estimates of about 1e-5 max|u| (e_tol) that a difference of fields of size max|u| gives:
# their rounding floor (EST_FLOOR max|u|, the two applies' summation orders) moves dt by up to 1e-8 relative and the
# end time with it; uend is held to 1e-11 beyond what the end times' gap explains (nu rho max|u| per unit of time)
N_RES_PARITY, FLAVOUR_TEND, FLAVOUR_E_TOL = 256, 0.05, 1e-5
FLAVOUR_DT_RTOL, FLAVOUR_UEND_TOL, FLAVOUR_EST_RTOL, EST_FLOOR = 1e-8, 1e-11, 1e-10, 1e-13
INEXACT_RATIO = 1e-2  # NewtonInexactness on phase 25's path: newton_tol = ratio x residual after each iteration
RESIDUAL_FLOOR = 1e-13  # the rounding gap of a residual between the block's batched sweep and one step's, |u| <= 1
SWITCH_T_TOL, SWITCH_P, SWITCH_BLOCK_TEND = 1e-12, 4, 1.8  # t_switch card against CPU; the block run's size
# the mesh (one controller over positions that all lie on the one card): the halo applies on 2 and 4 space
# positions; the heat path and the PFASST block on meshes against the same block without one (phase 15's bound); the
# float64 PFASST block at 128^2 on a 2 x 2 mesh, card against CPU
MESH_SPACE, MESH_UEND_BOUND, N_MESH_PARITY = (2, 4), 1e-5, 128
BURNIN = {'predict_type': 'pfasst_burnin'}


def _card():
    out = subprocess.run(
        ['nvidia-smi', '-i', '0', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _heat_description(n, dtype, device, restol, maxiter):
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    return dict(
        problem_class=HeatND,
        problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=dtype, device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=M_MAIN, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT, restol=restol),
        step_params=dict(maxiter=maxiter),
    )


def _run(description, plain=False):
    from pysdc_tpu_torch import ControllerNonMPI, get_sorted

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, description)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, N_STEPS * DT)
    return ctrl, prob, uend, [v for _, v in get_sorted(stats, type='niter')]


def _coeff(X, Y):
    """The sparse lane's diffusivity: 0.1 (1 + 0.5 sin 2 pi x cos 2 pi y) (bench.py:271)."""
    return 0.1 * (1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y))


def _sparse_description(n, dtype, device, restol, maxiter, dt=DT_SPARSE):
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D

    return dict(
        problem_class=VarCoeffDiffusion2D,
        problem_params=dict(nvars=(n, n), coeff_fn=_coeff, dtype=dtype, device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=M_MAIN, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=dt, restol=restol),
        step_params=dict(maxiter=maxiter),
    )


def _sparse_run(description, n_steps=N_STEPS, plain=False, trace=None):
    """Run the sparse description from u0 = sin(pi x) sin(pi y); ``trace``
    (a list) receives each PCG solve's iteration count."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, description)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas_dia()
    prob.A.pcg_trace = trace
    X, Y = prob.grids
    u0 = torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    dt = description['level_params']['dt']
    uend, stats = ctrl.run(u0, 0.0, n_steps * dt)
    return ctrl, prob, uend, [v for _, v in get_sorted(stats, type='niter')]


def _row_scale(abs_rows, u):
    """sum|coefficients in a row| (max over rows) times max|u|."""
    return float(abs_rows.max()) * float(u.abs().max())


def _stencil_tolerance(terms, dtype):
    """Worst-case rounding gap between two sums of the same n products taken
    in different orders, relative to sum|c| * max|u|: 2 n eps."""
    import torch

    n_terms = sum(len(offs) for _, offs in terms)
    return 2 * n_terms * torch.finfo(dtype).eps


def _event_ms(fn, reps, warmup=3, host=False):
    """Mean ms per call of ``fn(i)`` over ``reps`` back-to-back calls, timed
    with CUDA events; with ``host=True`` also the host's mean ms to enqueue
    one call (when the two are close, the host holds the card back)."""
    import torch

    for i in range(warmup):
        fn(i)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    host_ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / reps
    return (device_ms, host_ms) if host else device_ms


def _graph_ms(fn, reps):
    """Mean ms per call of ``fn(i)`` with the host out of the way: ``reps``
    calls captured in one CUDA graph, replayed and timed with CUDA events."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(card):
    from pysdc_tpu_torch.ops.kernels.build import SOURCES, build

    start = time.perf_counter()
    built = build()
    for name, info in built.items():
        print(f'build {name}: {info["seconds"]:.2f} s')
        entry = ''
        for line in info['log'].splitlines():
            if 'Compiling entry function' in line:
                entry = line.split("'")[1]
            elif 'Used' in line or ('spill' in line and '0 bytes spill stores, 0 bytes spill loads' not in line):
                print(f'  ptxas: {entry[:96]}: {line.replace("ptxas info    :", "").strip()}')
    print(f'build: {len(built)} of {len(SOURCES)} libraries compiled in {time.perf_counter() - start:.2f} s [{card}]')


def _fd_tables():
    """name -> tap table: the centred tables of orders 2, 4, 6, an asymmetric
    one, the main path's (order 2 with the scale and 1/dx^2 folded in) and
    those of the PFASST path's fine and coarse operators."""
    import torch

    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.fd import get_finite_difference_stencil
    from pysdc_tpu_torch.ops.linop import SeparableFDOperator

    tables = {}
    for order in (2, 4, 6):
        c, s = get_finite_difference_stencil(2, order, 'center')
        axis = (tuple(float(x) for x in c), tuple(int(x) for x in s))
        tables[f'order{order}'] = (axis, axis)
    tables['asymmetric'] = (((0.5, -2.0, 1.5), (-2, -1, 0)), ((1.0,), (1,)))
    per_dim = [dict(size=N_MAIN, dx=1.0 / N_MAIN, derivative=2, order=2, bc='periodic')] * 2
    tables['main'] = SeparableFDOperator(per_dim, scale=0.1)._cross_terms
    for name, n in (('pfasst fine', N_PFASST), ('pfasst coarse', NC_PFASST)):
        prob = HeatND(nvars=(n, n), nu=0.1, freq=4, bc='periodic', dtype=torch.float32, device='cuda')
        tables[name] = prob.A._cross_terms
    return tables


# K1's shapes: the main path's, the PFASST path's (a field and a stack of the
# nodes' fields on either level), the fused lane's (the same with the block's
# time axis behind the node axis: 8 steps of PFASST, 4 of the forced march, 1
# of the serial march), the general path's (odd, narrow), and the
# seams of the bands path: one band wide and a column group wider (float32:
# 128 and 132 columns; float64: 64 and 66), nx that the band's rows do not
# divide, a grid whose rows wrap more than once under order 6, a batch
K1_SHAPES = [(N_MAIN, N_MAIN), (M_MAIN, N_MAIN, N_MAIN), (N_PFASST, N_PFASST), (3, N_PFASST, N_PFASST),
             (NC_PFASST, NC_PFASST), (2, NC_PFASST, NC_PFASST),
             (P_PFASST, N_PFASST, N_PFASST), (3, P_PFASST, N_PFASST, N_PFASST),
             (P_PFASST, NC_PFASST, NC_PFASST), (2, P_PFASST, NC_PFASST, NC_PFASST),
             (P_FORCED, N_FORCED, N_FORCED), (M_FORCED, P_FORCED, N_FORCED, N_FORCED),
             (1, N_PFASST, N_PFASST), (3, 1, N_PFASST, N_PFASST), (17, 33), (16, 16), (1, 4096),
             (64, 128), (64, 132), (40, 64), (40, 66), (100, 256), (4, 128), (3, 5, 64, 256)]


def _k1_both_paths(name, terms, u, expected, tol):
    """K1 on ``u`` against its plain version, on the path the wrapper picks (which must be ``expected``) and with
    the general path forced.  Returns the picked path's largest absolute error and the larger relative error of
    the two (relative to sum|c| * max|u|, held to ``tol``)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, cross_stencil_2d

    want = _roll_cross_2d(u, terms)
    scale = sum(abs(c) for coeff, _ in terms for c in coeff) * u.abs().max().item()
    picked_err, worst = None, 0.0
    for forced in (None, 'general'):
        before = dict(cross_stencil_2d.paths)
        got = cross_stencil_2d(u, terms, path=forced)
        torch.cuda.synchronize()
        ran = [k for k, v in cross_stencil_2d.paths.items() if v != before[k]]
        if ran != [forced or expected]:
            raise AssertionError(f'K1 {name} {u.dtype} {tuple(u.shape)}: path {ran}, expected {forced or expected}')
        err = (got - want).abs().max().item()
        rel = err / scale
        if not (got.shape == u.shape and math.isfinite(err) and rel <= tol):
            raise AssertionError(f'K1 {name} {u.dtype} {tuple(u.shape)} path {ran[0]}: max abs err {err:.3e}, '
                                 f'rel {rel:.3e} > {tol:.3e}')
        picked_err = err if forced is None else picked_err
        worst = max(worst, rel)
    return picked_err, worst


def phase_kernels():
    """K1 against its plain version on the card, on the path the wrapper
    picks and with the general path forced.  Returns the largest absolute
    error at the main path's shape and taps, float32, and at the PFASST
    path's shapes and taps, float32, by level."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import choose_path

    tables = _fd_tables()
    gen = torch.Generator(device='cuda').manual_seed(1234)
    main_err, pfasst_err = None, {'pfasst fine': 0.0, 'pfasst coarse': 0.0}
    pfasst_n = {'pfasst fine': N_PFASST, 'pfasst coarse': NC_PFASST}
    for dtype in (torch.float32, torch.float64):
        itemsize = torch.empty((), dtype=dtype).element_size()
        for name, terms in tables.items():
            tol = _stencil_tolerance(terms, dtype)
            worst = 0.0
            taken = {'bands': [], 'general': []}
            for shape in K1_SHAPES:
                u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
                expected = choose_path(shape, terms, itemsize)
                taken[expected].append(shape)
                err, rel = _k1_both_paths(name, terms, u, expected, tol)
                worst = max(worst, rel)
                if name == 'main' and dtype == torch.float32 and shape == (N_MAIN, N_MAIN):
                    main_err = err
                if dtype == torch.float32 and shape[-2:] == (pfasst_n.get(name),) * 2:
                    pfasst_err[name] = max(pfasst_err[name], err)
            print(f'kernels: K1 {name:10s} {str(dtype):13s} max rel err {worst:.3e} <= tol {tol:.3e}, both on the '
                  f'path picked and with the general path forced; bands: {taken["bands"]}; general: {taken["general"]}')
    if choose_path((N_MAIN, N_MAIN), tables['main'], 4) != 'bands':
        raise AssertionError('K1: the main path\'s shape and taps do not take the bands path')
    print(f'kernels: K1 at the PFASST path\'s shapes and taps, fp32, max abs err by level {pfasst_err}')
    return main_err, pfasst_err


def phase_main(card):
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _heat_description(N_MAIN, torch.float32, 'cuda', restol=-1.0, maxiter=SWEEPS)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    ctrl, prob, uend, niter = _run(desc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = cross_stencil_2d.launches
    # per step: f(u0) and one batched f over the M spread nodes, then M per sweep
    expected = sum(2 + M_MAIN * k for k in niter)
    if len(niter) != N_STEPS or launches != expected:
        raise AssertionError(f'main path: niter {niter}, K1 launches {launches}, expected {expected}')
    if cross_stencil_2d.paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'main path: K1 launches by path {cross_stencil_2d.paths}, expected all on bands')
    if uend.shape != (N_MAIN, N_MAIN) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('main path: uend is not a finite float32 field of the grid shape')
    err_exact = (uend - prob.u_exact(N_STEPS * DT)).abs().max().item()
    if err_exact > UEND_EXACT_BOUND:
        raise AssertionError(f'main path: |uend - u_exact| = {err_exact:.3e} > {UEND_EXACT_BOUND}')

    cross_stencil_2d.launches = 0
    _, _, uend_plain, niter_plain = _run(desc, plain=True)
    diff = (uend - uend_plain).abs().max().item()
    if cross_stencil_2d.launches != 0 or niter_plain != niter or diff > UEND_PLAIN_BOUND:
        raise AssertionError(f'main path vs plain apply: diff {diff:.3e}, niter {niter_plain}, '
                             f'K1 launches {cross_stencil_2d.launches}')
    print(f'main: HeatND {N_MAIN}^2 fp32 M={M_MAIN} LU, {N_STEPS} steps, niter {niter}, '
          f'K1 launches {launches} (= sum(2 + {M_MAIN}*niter), all on the bands path), wall {wall:.3f} s incl. first calls, '
          f'|uend - u_exact| {err_exact:.3e} <= {UEND_EXACT_BOUND}, '
          f'|uend - uend_plain_apply| {diff:.3e} <= {UEND_PLAIN_BOUND} [{card}]')
    return ctrl, launches


def phase_parity():
    import torch

    _, _, u_card, it_card = _run(_heat_description(256, torch.float64, 'cuda', restol=1e-10, maxiter=50))
    _, _, u_cpu, it_cpu = _run(_heat_description(256, torch.float64, 'cpu', restol=1e-10, maxiter=50))
    diff = (u_card.cpu() - u_cpu).abs().max().item()
    if it_card != it_cpu or diff > PARITY_UEND_TOL:
        raise AssertionError(f'parity: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}')
    print(f'parity: HeatND 256^2 fp64 restol 1e-10, niter {it_card} on card and CPU, '
          f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


def _copy_rate(card):
    """The card's own copy rate: ``dst.copy_(src)`` of 128 MB, read and write
    counted.  Not a bound: it says how much of the published memory rate a
    kernel that reads and writes each byte once can see."""
    import torch

    n = 128 * 2**20 // 4
    srcs = [torch.randn(n, device='cuda') for _ in range(2)]
    dsts = [torch.empty(n, device='cuda') for _ in range(2)]
    ms = _event_ms(lambda i: dsts[i % 2].copy_(srcs[i % 2]), 20)
    rate = 2 * n * 4 / (ms * 1e-3)  # bytes read plus bytes written, a second
    print(f'times: copy rate of the card: dst.copy_(src) of 128 MB between 2 x 2 buffers {ms:.4f} ms a copy, '
          f'{rate / 1e9:.1f} GB/s read plus written ({100 * rate / HBM_BYTES_PER_S:.0f}% of the published '
          f'{HBM_BYTES_PER_S / 1e9:.0f} GB/s) [{card}]')


def _three_times(fn, reps):
    """(eager ms on the card, host ms to enqueue one call, ms from a CUDA graph) of ``fn(i)``."""
    eager, host = _event_ms(fn, reps, host=True)
    return eager, host, _graph_ms(fn, reps)


def _time_stencil(shape, terms, card):
    """K1 on both paths, its plain version and the conv2d yardstick at
    ``shape``, float32.  Inputs rotate through enough buffers to exceed the
    50 MB L2 cache.  The keys ``ms`` ... describe the path the wrapper picks."""
    import torch
    import torch.nn.functional as F

    from pysdc_tpu_torch.ops.kernels.stencil import (BAND_ROW_CHOICES, _launch, _roll_cross_2d, band_rows,
                                                     choose_path, cross_stencil_2d)

    gen = torch.Generator(device='cuda').manual_seed(7)
    nbytes = math.prod(shape) * 4
    nbuf = max(2, math.ceil(3 * L2_BYTES / nbytes))
    us = [torch.randn(shape, generator=gen, device='cuda') for _ in range(nbuf)]
    reps = 4 * nbuf

    n_terms = sum(len(o) for _, o in terms)
    numel = math.prod(shape)
    bytes_s = 2 * nbytes / HBM_BYTES_PER_S
    ops_s = 2 * n_terms * numel / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(bytes_s, ops_s)
    bound_by = 'bytes' if bytes_s >= ops_s else 'operations'

    picked = choose_path(shape, terms, 4)
    # picked, other, other, picked: the two paths in turns within this call
    order = [picked] + [p for p in ('bands', 'general') if p != picked] * 2 + [picked]
    runs = {}
    for path in order:
        t = _three_times(lambda i: cross_stencil_2d(us[i % nbuf], terms, path=path), reps)
        runs[path] = t if path not in runs else tuple(min(a, b) for a, b in zip(runs[path], t))
    for path, (eager, host, graph) in runs.items():
        print(f'times: K1 {shape} fp32 path {path:7s}{" (picked)" if path == picked else "":9s}: eager {eager:.4f} ms, '
              f'{host:.4f} ms to enqueue on the host, {graph:.4f} ms from a CUDA graph = '
              f'{2 * nbytes / graph / 1e6:.1f} GB/s, {100 * bound_ms / graph:.0f}% of the bound {bound_ms:.4f} ms '
              f'by {bound_by} (best of two turns) [{card}]')
    if picked == 'bands':
        nb, (nx, ny) = numel // math.prod(shape[-2:]), shape[-2:]
        sweep = {rows: _graph_ms(lambda i: _launch(us[i % nbuf], terms, rows=rows), reps) for rows in BAND_ROW_CHOICES}
        print(f'times: K1 {shape} bands path by rows a warp marches over, ms from a CUDA graph: '
              + ', '.join(f'{rows}: {ms:.4f}' for rows, ms in sweep.items())
              + f'; the wrapper picks {band_rows(nb, nx, ny, 4)} [{card}]')
    plain_ms = _event_ms(lambda i: _roll_cross_2d(us[i % nbuf], terms), reps)

    # yardstick: one cuDNN convolution with the cross-shaped taps on a
    # circularly padded input (TF32 off); the port never calls it
    (cx, ox), (cy, oy) = terms
    rx, ry = max(abs(s) for s in ox), max(abs(s) for s in oy)
    w = torch.zeros((1, 1, 2 * rx + 1, 2 * ry + 1), device='cuda')
    for c, s in zip(cx, ox):
        w[0, 0, rx + s, ry] += c
    for c, s in zip(cy, oy):
        w[0, 0, rx, ry + s] += c
    padded = [F.pad(u.reshape((-1, 1) + shape[-2:]), (ry, ry, rx, rx), mode='circular') for u in us]
    tf32 = torch.backends.cudnn.allow_tf32
    library_default_ms = _event_ms(lambda i: F.conv2d(padded[i % nbuf], w), reps)  # as torch ships: TF32 allowed
    torch.backends.cudnn.allow_tf32 = False
    library_ms = _event_ms(lambda i: F.conv2d(padded[i % nbuf], w), reps)
    library_graph_ms = _graph_ms(lambda i: F.conv2d(padded[i % nbuf], w), reps)
    lib_err = (F.conv2d(padded[0], w).reshape(shape) - cross_stencil_2d(us[0], terms)).abs().max().item()
    torch.backends.cudnn.allow_tf32 = tf32

    ms, enqueue_ms, graph_ms = runs[picked]
    print(f'times: K1 {shape} fp32: plain {plain_ms:.4f} ms, conv2d yardstick with TF32 off {library_ms:.4f} ms eager, '
          f'{library_graph_ms:.4f} ms from a CUDA graph (its max abs diff to K1 {lib_err:.3e}); with '
          f'cudnn.allow_tf32 = {tf32} as torch ships it {library_default_ms:.4f} ms eager [{card}]')
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, path=picked,
                enqueue_ms=enqueue_ms, graph_ms=graph_ms, library_graph_ms=library_graph_ms,
                other_path_graph_ms={p: t[2] for p, t in runs.items() if p != picked})


def phase_times(ctrl, card):
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    lvl = ctrl.MS[0].levels[0]
    terms = lvl.prob.A._cross_terms
    _copy_rate(card)
    k1 = _time_stencil((N_MAIN, N_MAIN), terms, card)
    _time_stencil((M_MAIN, N_MAIN, N_MAIN), terms, card)

    # the parts of one sweep at the main path's shape: a shifted solve
    # (rfftn / divide / irfftn), the node-axis integral, the residual
    rhs = lvl.state.u[1].clone()
    solve_ms = _event_ms(lambda i: lvl.prob.A.solve_shifted(rhs, 0.003), 20)
    integral_ms = _event_ms(lambda i: lvl.integrate(), 20)
    residual_ms = _event_ms(lambda i: lvl.compute_residual(), 20)

    # one main-path sweep: update_nodes + residual, as bench.py's headline counts it
    def sweep(i):
        lvl.update_nodes()
        lvl.compute_residual()

    before = cross_stencil_2d.launches
    sweep_ms, sweep_host_ms = _event_ms(sweep, 10, warmup=2, host=True)
    per_sweep = (cross_stencil_2d.launches - before) / 12
    lvl.prob.A.disable_pallas()
    sweep_plain_ms = _event_ms(sweep, 10, warmup=2)
    lvl.prob.A.enable_pallas()
    nnz_per_sweep = M_MAIN * lvl.prob.A.nnz_per_dof * N_MAIN**2
    rest_ms = sweep_ms - M_MAIN * (k1['ms'] + solve_ms) - integral_ms - residual_ms
    print(f'times: sweep {N_MAIN}^2 fp32 {sweep_ms:.4f} ms on the card, {sweep_host_ms:.4f} ms to enqueue on the host '
          f'({per_sweep:.0f} K1 launches/sweep, {nnz_per_sweep / sweep_ms / 1e6:.3f} Gnnz/s); '
          f'through the plain apply {sweep_plain_ms:.4f} ms [{card}]')
    print(f'times: sweep parts: {M_MAIN} x K1 {M_MAIN * k1["ms"]:.4f} ms, {M_MAIN} x shifted solve '
          f'{M_MAIN * solve_ms:.4f} ms, integral {integral_ms:.4f} ms, residual {residual_ms:.4f} ms, '
          f'rest (Gauss-Seidel updates, stacking) {rest_ms:.4f} ms [{card}]')
    return k1


def _periodic_var_coeff_matrix(n, seed=3):
    """The periodic variable-coefficient 2D 5-point matrix of
    tests/test_sparse.py:615-627, with wrap diagonals at +-(n-1) and +-(n^2-n)."""
    from pysdc_tpu_torch.ops.sparse import CSR

    lap1 = CSR.diags([np.ones(n), -2.0 * np.ones(n), np.ones(n)], [-1, 0, 1], (n, n))
    lap1 = CSR.from_dense(lap1.to_dense() + np.eye(n, k=n - 1) + np.eye(n, k=-(n - 1)))
    eye = CSR.eye(n)
    A2 = lap1.kron(eye) + eye.kron(lap1)
    scale = 1.0 + 0.5 * np.random.default_rng(seed).standard_normal(n * n)
    return CSR.diags([scale], [0], (n * n, n * n)).matmul(A2)


def _k2_matrices():
    """name -> DIA on the card: the sparse lane's matrices."""
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
    from pysdc_tpu_torch.ops.sparse import DIA
    from pysdc_tpu_torch.ops.sparse_op import variable_diffusion_matrix

    n1 = 4099
    a = 1.0 + 0.5 * np.sin(2 * np.pi * np.arange(n1 + 1) / n1)
    return {
        'varcoeff1024': VarCoeffDiffusion2D(nvars=(N_SPARSE, N_SPARSE), coeff_fn=_coeff, device='cuda').A.dia,
        'heat256periodic': HeatND(nvars=(256, 256), nu=0.1, bc='periodic', backend='sparse', device='cuda').A.dia,
        'varcoeff24periodic': DIA.from_csr(_periodic_var_coeff_matrix(24), device='cuda'),
        'periodic1d4099': DIA.from_csr(variable_diffusion_matrix(a, 1.0 / n1, bc='periodic'), device='cuda'),
    }


def _random_bsr(rng, nb, kb, br, bc):
    """Random blocks with column segments at arbitrary element offsets."""
    from pysdc_tpu_torch.ops.sparse import BSR

    ncols = max(nb * br, 4 * bc)
    blocks = rng.standard_normal((nb, kb, br, bc)) / bc
    segs = rng.integers(0, ncols - bc + 1, size=(nb, kb))
    return BSR(blocks, segs, (nb * br, ncols), br, bc, device='cuda')


def _k3_matrices():
    """name -> (BSR on the card, batch widths): bench.py's design point, the
    256^2 stencil through apply_bsr's blocking (with the batch widths at the
    edges of the stream path's template and of the chunking over 8), a random
    128x128 CSR at br=8, and the seams of the stream path: kb = 1, a br that
    a slab's rows (32 float32, 16 float64) do not divide, and a bc whose rows
    are 16-byte multiples in float64 only."""
    from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
    from pysdc_tpu_torch.ops.sparse import BSR, CSR

    rng = np.random.default_rng(1)
    br, ndof = 256, 256 * 256
    nb, kb = ndof // br, 3
    blocks = rng.standard_normal((nb, kb, br, br)) / br
    segs = np.clip(np.arange(nb)[:, None] + np.arange(kb)[None, :] - 1, 0, nb - 1) * br
    design = BSR(blocks, segs, (ndof, ndof), br, br, device='cuda')
    stencil = VarCoeffDiffusion2D(nvars=(256, 256), coeff_fn=_coeff, device='cuda').A
    stencil = BSR.from_csr(stencil.A, 256, 256, device='cuda')
    k = int(128 * 128 * 0.1)
    rand = CSR.from_coo(rng.integers(0, 128, k), rng.integers(0, 128, k), rng.normal(size=k), (128, 128))
    return {
        'design256': (design, (4,)),
        'stencil256': (stencil, (4, 1, 2, 3, 5, 8, 9)),
        'random128br8': (BSR.from_csr(rand, 8, 8, device='cuda'), (5,)),
        'kb1': (_random_bsr(rng, 8, 1, 64, 64), (4,)),
        'br40': (_random_bsr(rng, 6, 2, 40, 64), (4, 9)),
        'bc6': (_random_bsr(rng, 5, 2, 12, 6), (3,)),
    }


def phase_sparse_kernels():
    """K2 and K3 against their plain versions on the card, float32 and
    float64.  Returns the largest absolute errors at the main path's shapes
    (K2: the 1024^2 matrix on one vector; K3: the design point), float32."""
    import torch

    from pysdc_tpu_torch.ops.kernels.bsr import bsr_spmm, choose_path as k3_path
    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv
    from pysdc_tpu_torch.ops.sparse import DIA

    gen = torch.Generator(device='cuda').manual_seed(4321)
    errs = {}
    for name, dia in _k2_matrices().items():
        n, k = dia.shape[0], len(dia.offsets)
        flat = DIA(dia.data, dia.offsets, dia.shape, device='cuda')  # the flat-roll form of the plain version
        rows = dia.data.abs().sum(dim=0)
        for dtype in (torch.float32, torch.float64):
            tol = 2 * k * torch.finfo(dtype).eps
            worst = 0.0
            for batch in ((), (4,), (3, 5)):
                u = torch.randn(batch + (n,), generator=gen, device='cuda', dtype=dtype)
                got = dia_spmv(dia, u)
                torch.cuda.synchronize()
                scale = _row_scale(rows, u)
                for plain in [flat.spmv(u)] + ([dia.spmv(u)] if dia.grid else []):
                    err = (got - plain).abs().max().item()
                    if not (got.shape == u.shape and got.dtype == dtype and math.isfinite(err) and err <= tol * scale):
                        raise AssertionError(f'K2 {name} {dtype} {batch}: max abs err {err:.3e} > {tol * scale:.3e}')
                    worst = max(worst, err / scale)
                    if name == 'varcoeff1024' and dtype == torch.float32 and batch == ():
                        errs['dia_spmv'] = max(errs.get('dia_spmv', 0.0), err)
            print(f'kernels: K2 {name:18s} k={k} {"grid" if dia.grid else "flat"} {str(dtype):13s} '
                  f'max rel err {worst:.3e} <= tol {tol:.3e} over batches (), (4,), (3, 5)')
    for name, (bsr, widths) in _k3_matrices().items():
        dims = nb, kb, br, bc = tuple(bsr.blocks.shape)
        rows = bsr.blocks.abs().sum(dim=(1, 3)).reshape(-1)
        for dtype in (torch.float32, torch.float64):
            tol = 2 * kb * bc * torch.finfo(dtype).eps
            itemsize = torch.empty((), dtype=dtype).element_size()
            worst, taken = 0.0, []
            for B in widths:
                u = torch.randn((bsr.shape[1], B), generator=gen, device='cuda', dtype=dtype)
                want = bsr.spmv(u)
                scale = _row_scale(rows, u)
                expected = k3_path(dims, B, itemsize)
                taken.append(f'B={B}: {expected}')
                for forced in (None, 'general'):
                    before = dict(bsr_spmm.paths)
                    got = bsr_spmm(bsr, u, path=forced)
                    torch.cuda.synchronize()
                    ran = [k for k, v in bsr_spmm.paths.items() if v != before[k]]
                    if ran != [forced or expected]:
                        raise AssertionError(f'K3 {name} {dtype} B={B}: path {ran}, expected {forced or expected}')
                    err = (got - want).abs().max().item()
                    if not (got.shape == want.shape and math.isfinite(err) and err <= tol * scale):
                        raise AssertionError(f'K3 {name} {dtype} B={B} path {ran[0]}: max abs err {err:.3e} > '
                                             f'{tol * scale:.3e}')
                    worst = max(worst, err / scale)
                    if name == 'design256' and dtype == torch.float32 and forced is None:
                        errs['bsr_spmm'] = err
            print(f'kernels: K3 {name:13s} (nb, kb, br, bc)={dims} {str(dtype):13s} max rel err {worst:.3e} <= tol '
                  f'{tol:.3e}, both on the path picked and with the general path forced; picked: {", ".join(taken)}')
    return errs


def phase_sine_kernels(card):
    """The sine kernels (``csrc/sine_solve.cu``) against their plain version and against a float64 solve by the
    sine-transform chain, through ``SeparableFDOperator.solve_shifted`` on the card: several shapes, both dtypes, a
    number and a tensor of shifts; the transform alone (``dst_rows``, the chain's) against its plain version; then
    their time at the PCG preconditioner's shape (4, 1024, 1024) float32 from a CUDA graph, beside the chain's and the
    bound.  Returns the largest error at that shape and the times."""
    import torch

    from pysdc_tpu_torch.ops.kernels.sine import (dst_coefficients, dst_rows, fft_rows, odd_extension, plain_solve,
                                                  sine_solve_2d)
    from pysdc_tpu_torch.ops.linop import SeparableFDOperator

    def operator(nx, ny):
        return SeparableFDOperator([dict(size=nx, dx=1.0 / (nx + 1) / math.sqrt(0.1), derivative=2, order=2,
                                         bc='dirichlet'),
                                    dict(size=ny, dx=1.3 / (ny + 1) / math.sqrt(0.1), derivative=2, order=2,
                                         bc='dirichlet-zero')], scale=0.9)

    def chain(op, u, factor):
        denom = 1.0 - factor * op.scale * op._mat('lam_nd', op._lam_nd, u)
        return op._backward(op._forward(u) / denom).contiguous()

    gen = torch.Generator(device='cuda').manual_seed(2024)
    for shape, dtype in (((4, 1024, 1024), torch.float32), ((3, 7, 1), torch.float64), ((5, 33), torch.float32),
                         ((2, 9, 1024), torch.float64), ((65,), torch.float32)):
        n = shape[-1]
        x = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
        angle = math.pi * torch.arange(1, n + 1, device='cuda', dtype=torch.float64) / (n + 1)
        cs, sn = torch.cos(angle).to(dtype), torch.sin(angle).to(dtype)
        before = dst_rows.launches
        got = dst_rows(x, cs, sn, 0.5)
        want = 0.5 * dst_coefficients(fft_rows(odd_extension(x)), cs, sn)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() / want.abs().max().item()
        tol = 8 * torch.finfo(dtype).eps
        if dst_rows.launches != before + 1 or not err <= tol:
            raise AssertionError(f'sine transform {shape} {dtype}: launches {dst_rows.launches - before}, rel err '
                                 f'{err:.3e} against its plain version > {tol:.3e}')
        print(f'kernels: sine transform {shape} {str(dtype):13s}: rel err {err:.3e} against its plain version '
              f'<= {tol:.3e}')
    out = {}
    for B, nx, ny, dtype, tensor in ((4, 1024, 1024, torch.float32, False), (4, 1024, 1024, torch.float64, True),
                                     (3, 33, 20, torch.float64, True), (2, 70, 45, torch.float32, False),
                                     (5, 17, 64, torch.float32, True), (2, 31, 3, torch.float64, False)):
        op = operator(nx, ny)
        rhs = torch.randn((B, nx, ny), generator=gen, device='cuda', dtype=dtype)
        f = torch.linspace(0.0, 3e-4, B, device='cuda', dtype=dtype) if tensor else 2e-4
        before = sine_solve_2d.launches
        got = op.solve_shifted(rhs, f.reshape(B, 1, 1) if tensor else f)
        torch.cuda.synchronize()
        if sine_solve_2d.launches != before + 1:
            raise AssertionError(f'sine kernels: {B}x{nx}x{ny} did not launch')
        tables = [op._const(f'sine {k}', op._sine_2d[k], dtype, rhs.device) for k in ('lam', 'cs', 'sn')]
        plain = plain_solve(rhs, f, op.scale, op._sine_2d['cx'], *tables)
        ref = chain(op, rhs.double(), f.double().reshape(B, 1, 1) if tensor else f)
        scale = ref.abs().max().item()
        err, err_plain = ((got.double() - ref).abs().max().item() / scale,
                          (got - plain).abs().max().item() / scale)
        tol = 2e-5 if dtype == torch.float32 else 1e-11  # the sweep's rounding grows with the modes' condition
        if not (math.isfinite(err) and err <= tol and err_plain <= tol):
            raise AssertionError(f'sine kernels {B}x{nx}x{ny} {dtype}: rel err {err:.3e} (plain {err_plain:.3e}) '
                                 f'> {tol:.3e}')
        print(f'kernels: sine {B}x{nx}x{ny} {str(dtype):13s} {"tensor" if tensor else "number"} shift: rel err '
              f'{err:.3e} against float64, {err_plain:.3e} against the plain version <= {tol:.3e}')
        if (B, nx, dtype) == (4, 1024, torch.float32):
            out['max_rel_err'] = err
    op = operator(1024, 1024)
    rhs = [torch.rand((4, 1024, 1024), generator=gen, device='cuda') for _ in range(8)]
    ms = _graph_ms(lambda i: op.solve_shifted(rhs[i % 8], 2e-4), 16)
    chain_ms = _graph_ms(lambda i: chain(op, rhs[i % 8], 2e-4), 16)
    bound_ms, bound_by = _bound(2 * 4 * rhs[0].numel(), 0)
    print(f'kernels: sine solve at (4, 1024, 1024) float32 {ms:.4f} ms from a graph ({100 * bound_ms / ms:.1f}% of '
          f'its bound {bound_ms:.4f} ms, {bound_by}); the sine-transform chain {chain_ms:.4f} ms [{card}]')
    out.update(graph_ms=ms, bound_ms=bound_ms, chain_ms=chain_ms)
    return out


def phase_sparse_main(card):
    """The sparse lane's main path.  Returns the controller, the K2 launch count and the sine kernels' (one solve a
    PCG trip: the preconditioner's)."""
    import torch

    from pysdc_tpu_torch.ops import loops
    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv
    from pysdc_tpu_torch.ops.kernels.sine import sine_solve_2d

    desc = _sparse_description(N_SPARSE, torch.float32, 'cuda', restol=-1.0, maxiter=SWEEPS)
    trace = []
    dia_spmv.launches = 0
    sine_solve_2d.launches = 0
    start = time.perf_counter()
    ctrl, prob, uend, niter = _sparse_run(desc, trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dia_spmv.launches
    sine_launches = sine_solve_2d.launches
    # READ_EVERY 1: the loop stops at the trip that converged, so the trips computed are the trips counted
    if loops.READ_EVERY != 1 or sine_launches != prob.A.pcg_steps or sine_launches != sum(trace):
        raise AssertionError(f'sparse main: sine kernel launches {sine_launches}, PCG trips computed '
                             f'{prob.A.pcg_steps}, counted {sum(trace)} (READ_EVERY {loops.READ_EVERY}): the '
                             f'preconditioner solve of each trip has to take the sine kernels')
    # per step: f(u0) and one batched f over the M spread nodes, then M per sweep
    floor = sum(2 + M_MAIN * k for k in niter)
    if len(niter) != N_STEPS or launches != prob.A.spmv_count or launches < floor:
        raise AssertionError(f'sparse main: niter {niter}, K2 launches {launches}, operator SpMVs '
                             f'{prob.A.spmv_count}, at least {floor} expected')
    if prob.A.solver_kind != 'pcg' or len(trace) != M_MAIN * sum(niter):
        raise AssertionError(f'sparse main: solver {prob.A.solver_kind}, {len(trace)} PCG solves')
    if uend.shape != (N_SPARSE, N_SPARSE) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('sparse main: uend is not a finite float32 field of the grid shape')

    dia_spmv.launches = 0
    trace_plain = []
    _, _, uend_plain, niter_plain = _sparse_run(desc, plain=True, trace=trace_plain)
    diff = (uend - uend_plain).abs().max().item()
    if dia_spmv.launches != 0 or niter_plain != niter or diff > SPARSE_PLAIN_BOUND:
        raise AssertionError(f'sparse main vs plain rolls: diff {diff:.3e}, niter {niter_plain}, '
                             f'K2 launches {dia_spmv.launches}')
    print(f'sparse main: VarCoeffDiffusion2D {N_SPARSE}^2 fp32 M={M_MAIN} LU dt={DT_SPARSE}, {N_STEPS} steps, '
          f'niter {niter}, solver {prob.A.solver_kind}, K2 launches {launches} (= operator SpMVs; '
          f'sum(2 + {M_MAIN}*niter) = {floor} of them are eval_f), sine kernel launches {sine_launches} (= PCG '
          f'trips), wall {wall:.3f} s incl. first calls, '
          f'max|uend| {uend.abs().max().item():.6f}, |uend - uend_plain_rolls| {diff:.3e} <= {SPARSE_PLAIN_BOUND} '
          f'[{card}]')
    print(f'sparse main: PCG iterations per solve, in order: {trace}')
    print(f'sparse main: through the plain rolls: {trace_plain}')
    return ctrl, launches, sine_launches


def phase_bsr_path(card):
    """A short sparse run at 256^2, then its M node values through
    ``apply_bsr`` (K3), held against the nodes' RHS (K2's eval_f).  Returns
    the K3 launch count of the apply."""
    import torch

    from pysdc_tpu_torch.ops.kernels.bsr import bsr_spmm

    ctrl, prob, _, _ = _sparse_run(_sparse_description(256, torch.float32, 'cuda', restol=-1.0, maxiter=2),
                                   n_steps=1)
    lvl = ctrl.MS[0].levels[0]
    n = prob.A.n
    U = lvl.u[1:].reshape(M_MAIN, n).T.contiguous()
    bsr_spmm.launches = 0
    bsr_spmm.paths = {'stream': 0, 'general': 0}
    Y = prob.A.apply_bsr(U)
    torch.cuda.synchronize()
    launches = bsr_spmm.launches
    if bsr_spmm.paths != {'stream': launches, 'general': 0}:
        raise AssertionError(f'block-sparse path: K3 launches by path {bsr_spmm.paths}, expected all on stream')
    want = lvl.f[1:].reshape(M_MAIN, n).T
    bsr = prob.A._bsr
    nb, kb, br, bc = bsr.blocks.shape
    tol = 2 * kb * bc * torch.finfo(torch.float32).eps * _row_scale(bsr.blocks.abs().sum(dim=(1, 3)), U)
    err = (Y - want).abs().max().item()
    if launches < 1 or Y.shape != (n, M_MAIN) or not err <= tol:
        raise AssertionError(f'block-sparse path: K3 launches {launches}, max|apply_bsr - f| {err:.3e} > {tol:.3e}')
    print(f'block-sparse path: VarCoeffDiffusion2D 256^2 fp32, the {M_MAIN} node values of a 1-step run through '
          f'apply_bsr (br={br}, kb={kb}): K3 launches {launches} (stream path), max|apply_bsr(U) - f| {err:.3e} <= {tol:.3e} [{card}]')
    return launches


def phase_sparse_parity():
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted

    def varcoeff(device):
        _, _, u, it = _sparse_run(_sparse_description(128, torch.float64, device, restol=1e-10, maxiter=50))
        return u.cpu(), it

    (u_card, it_card), (u_cpu, it_cpu) = varcoeff('cuda'), varcoeff('cpu')
    diff = (u_card - u_cpu).abs().max().item()
    if it_card != it_cpu or diff > PARITY_UEND_TOL:
        raise AssertionError(f'sparse parity: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}')
    print(f'sparse parity: VarCoeffDiffusion2D 128^2 fp64 restol 1e-10, niter {it_card} on card and CPU, '
          f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}')

    def heat(backend, device):
        desc = _heat_description(256, torch.float64, device, restol=1e-10, maxiter=50)
        desc['problem_params']['backend'] = backend
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
        prob = ctrl.MS[0].levels[0].prob
        if backend == 'sparse':
            prob.A.pcg_trace = []
        uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, N_STEPS * DT)
        return uend.cpu(), [v for _, v in get_sorted(stats, type='niter')], prob

    (u_sp, it_sp, p_sp), (u_cpu, it_cpu, _), (u_ei, it_ei, _) = (
        heat('sparse', 'cuda'), heat('sparse', 'cpu'), heat('eigen', 'cuda'))
    err_exact = (u_sp - p_sp.u_exact(N_STEPS * DT).cpu()).abs().max().item()
    d_eigen = (u_sp - u_ei).abs().max().item()
    d_cpu = (u_sp - u_cpu).abs().max().item()
    max_pcg = max(p_sp.A.pcg_trace)
    if not (it_sp == it_cpu == it_ei and p_sp.A.solver_kind == 'pcg' and max_pcg <= 2 and d_eigen <= SPARSE_EIGEN_TOL
            and d_cpu <= PARITY_UEND_TOL and err_exact <= SPARSE_EXACT_TOL):
        raise AssertionError(f'sparse heat parity: niter {it_sp} / cpu {it_cpu} / eigen {it_ei}, PCG iterations '
                             f'<= {max_pcg}, |sparse - eigen| {d_eigen:.3e}, |card - cpu| {d_cpu:.3e}, '
                             f'|uend - u_exact| {err_exact:.3e}')
    print(f'sparse parity: HeatND(backend=sparse) 256^2 periodic fp64 restol 1e-10, niter {it_sp} (= CPU = eigen), '
          f'PCG iterations per solve <= {max_pcg}, |sparse - eigen| {d_eigen:.3e} <= {SPARSE_EIGEN_TOL}, '
          f'|card - CPU| {d_cpu:.3e} <= {PARITY_UEND_TOL}, |uend - u_exact| {err_exact:.3e} <= {SPARSE_EXACT_TOL}')


def _bound(nbytes, flops):
    bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(bytes_s, ops_s), ('bytes' if bytes_s >= ops_s else 'operations')


def _time_dia(dia, csr, B, card):
    """K2, its plain version and a cuSPARSE CSR SpMV/SpMM yardstick at
    ``(B, n)``, float32, inputs (vectors, diagonals, CSR values) rotated past
    the 50 MB L2 cache."""
    import torch

    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv
    from pysdc_tpu_torch.ops.sparse import DIA

    n, k = dia.shape[0], len(dia.offsets)
    shape = (n,) if B == 1 else (B, n)
    nbytes = (k + 2 * B) * n * 4
    nbuf = max(2, math.ceil(3 * L2_BYTES / nbytes))
    gen = torch.Generator(device='cuda').manual_seed(11)
    us = [torch.randn(shape, generator=gen, device='cuda') for _ in range(nbuf)]
    dias = [DIA(dia.data.clone(), dia.offsets, dia.shape, grid=dia.grid, device='cuda') for _ in range(nbuf)]
    reps = 4 * nbuf
    ms, host_ms = _event_ms(lambda i: dia_spmv(dias[i % nbuf], us[i % nbuf]), reps, host=True)
    graph_ms = _graph_ms(lambda i: dia_spmv(dias[i % nbuf], us[i % nbuf]), reps)
    plain_ms = _event_ms(lambda i: dias[i % nbuf].spmv(us[i % nbuf]), reps)

    # yardstick: cuSPARSE CSR SpMV (B=1) or SpMM (B columns) of the same matrix; the port never calls it
    crow = torch.as_tensor(csr.indptr, device='cuda')
    col = torch.as_tensor(csr.indices.astype(np.int64), device='cuda')
    mats = [torch.sparse_csr_tensor(crow, col, torch.as_tensor(csr.data, dtype=torch.float32, device='cuda'),
                                    csr.shape) for _ in range(nbuf)]
    cols = [u.reshape(-1, n).T.contiguous() for u in us]
    library_ms = _event_ms(lambda i: mats[i % nbuf] @ (cols[i % nbuf][:, 0] if B == 1 else cols[i % nbuf]), reps)
    lib = mats[0] @ cols[0]
    lib_err = (lib.T.reshape(shape) - dia_spmv(dias[0], us[0])).abs().max().item()
    bound_ms, bound_by = _bound(nbytes, 2 * csr.nnz * B)
    print(f'times: K2 {shape} fp32 k={k}: {ms:.4f} ms ({host_ms:.4f} ms to enqueue on the host; '
          f'{graph_ms:.4f} ms replayed from a CUDA graph), plain {plain_ms:.4f} ms, cuSPARSE CSR yardstick '
          f'{library_ms:.4f} ms (its max abs diff to K2 {lib_err:.3e}), bound {bound_ms:.4f} ms by {bound_by}, '
          f'{nbytes / ms / 1e6:.1f} GB/s [{card}]')
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                enqueue_ms=host_ms, graph_ms=graph_ms)


def _library_bsr(bsr):
    """The matrix as a torch BSR tensor (duplicate block columns summed), float32."""
    import torch

    nb, kb, br, bc = bsr.blocks.shape
    ncb = bsr.shape[1] // bc
    key = (torch.arange(nb, device='cuda')[:, None] * ncb + bsr.seg_starts.long() // bc).reshape(-1)
    uniq, inv = torch.unique(key, return_inverse=True)
    vals = torch.zeros((uniq.numel(), br, bc), device='cuda').index_add_(
        0, inv, bsr.blocks.reshape(-1, br, bc).float())
    crow = torch.zeros(nb + 1, dtype=torch.int64, device='cuda')
    crow[1:] = torch.cumsum(torch.bincount(uniq // ncb, minlength=nb), 0)
    return torch.sparse_bsr_tensor(crow, uniq % ncb, vals, bsr.shape)


def _time_bsr(name, bsr, B, card):
    """K3 on both paths, its plain version and a torch BSR SpMM yardstick
    (TF32 off) at (N, B), float32.  The keys ``ms`` ... describe the path the
    wrapper picks."""
    import torch

    from pysdc_tpu_torch.ops.kernels.bsr import _launch, bsr_spmm, choose_path, stream_geometry, stream_rows

    dims = nb, kb, br, bc = tuple(bsr.blocks.shape)
    nbytes = (nb * kb * br * bc + (bsr.shape[0] + bsr.shape[1]) * B) * 4
    nbuf = max(2, math.ceil(3 * L2_BYTES / nbytes))
    gen = torch.Generator(device='cuda').manual_seed(12)
    us = [torch.randn((bsr.shape[1], B), generator=gen, device='cuda') for _ in range(nbuf)]
    reps = 4 * nbuf + 10
    bound_ms, bound_by = _bound(nbytes, 2 * nb * kb * br * bc * B)

    picked = choose_path(dims, B, 4)
    # picked, other, other, picked: the two paths in turns within this call
    order = [picked] + [p for p in ('stream', 'general') if p != picked] * 2 + [picked]
    runs = {}
    for path in order:
        t = _three_times(lambda i: bsr_spmm(bsr, us[i % nbuf], path=path), reps)
        runs[path] = t if path not in runs else tuple(min(a, b) for a, b in zip(runs[path], t))
    for path, (eager, host, graph) in runs.items():
        print(f'times: K3 {name} (nb, kb, br, bc)={dims} B={B} fp32 path {path:7s}'
              f'{" (picked)" if path == picked else "":9s}: eager {eager:.4f} ms, {host:.4f} ms to enqueue on the '
              f'host, {graph:.4f} ms from a CUDA graph = {nbytes / graph / 1e6:.1f} GB/s, '
              f'{100 * bound_ms / graph:.0f}% of the bound {bound_ms:.4f} ms by {bound_by} (best of two turns) [{card}]')
    if picked == 'stream':
        most = stream_geometry(dims, B, 4)[0]
        sweep = {n: _graph_ms(lambda i: _launch(bsr, us[i % nbuf], stages=n), reps) for n in range(2, most + 1)}
        print(f'times: K3 {name} stream path by slabs in the ring ({stream_rows(4) * bc * 4 // 1024} KB each), ms from '
              f'a CUDA graph: ' + ', '.join(f'{n}: {ms:.4f}' for n, ms in sweep.items())
              + f'; the wrapper takes {most} [{card}]')
    plain_ms = _event_ms(lambda i: bsr.spmv(us[i % nbuf]), reps)
    try:
        A = _library_bsr(bsr)
        lib_name = 'torch BSR SpMM'
        lib_fn = lambda i: A @ us[i % nbuf]  # noqa: E731
        lib_err = (lib_fn(0) - bsr_spmm(bsr, us[0])).abs().max().item()
    except (RuntimeError, NotImplementedError) as exc:  # the yardstick refuses these shapes
        print(f'times: K3 {name}: torch BSR SpMM refused ({type(exc).__name__}: {str(exc)[:120]}); '
              'yardstick is an einsum over the gathered segments')
        blocks = bsr.blocks_for(us[0])
        idx = bsr.seg_starts.long()[..., None] + torch.arange(bc, device='cuda')
        lib_name = 'einsum over gathered segments'
        lib_fn = lambda i: torch.einsum('nkrc,nkcb->nrb', blocks, us[i % nbuf][idx]).reshape(-1, B)  # noqa: E731
        lib_err = (lib_fn(0) - bsr_spmm(bsr, us[0])).abs().max().item()
    library_ms = _event_ms(lib_fn, reps)
    library_graph_ms = _graph_ms(lib_fn, reps)
    ms, enqueue_ms, graph_ms = runs[picked]
    print(f'times: K3 {name} B={B} fp32: plain {plain_ms:.4f} ms, {lib_name} yardstick {library_ms:.4f} ms eager, '
          f'{library_graph_ms:.4f} ms from a CUDA graph (its max abs diff to K3 {lib_err:.3e}) [{card}]')
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, path=picked,
                enqueue_ms=enqueue_ms, graph_ms=graph_ms, library_graph_ms=library_graph_ms,
                other_path_graph_ms={p: t[2] for p, t in runs.items() if p != picked})


def phase_sparse_times(ctrl, card):
    import torch

    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv

    lvl = ctrl.MS[0].levels[0]
    A = lvl.prob.A
    k2 = _time_dia(A.dia, A.A, 1, card)
    _time_dia(A.dia, A.A, M_MAIN, card)
    k3 = None
    for name, (bsr, widths) in _k3_matrices().items():
        if name in ('design256', 'stencil256'):
            t = _time_bsr(name, bsr, widths[0], card)
            k3 = t if name == 'design256' else k3

    # one main-path sweep (update_nodes + residual) and its parts: CUDA events
    # around every eval_f and every solve_system the sweeps make
    prob = lvl.prob
    spans = {'eval_f': [], 'solve': []}

    def timed(kind, fn):
        def wrapper(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[kind].append((start, end))
            return out
        return wrapper

    def sweep(i):
        lvl.update_nodes()
        lvl.compute_residual()

    n_sweeps = 5
    sweep(0)
    prob.eval_f, prob.solve_system = timed('eval_f', prob.eval_f), timed('solve', prob.solve_system)
    spans['eval_f'].clear(), spans['solve'].clear()
    A.pcg_trace = []
    before = dia_spmv.launches
    sweep_ms, sweep_host_ms = _event_ms(sweep, n_sweeps, warmup=0, host=True)
    per_sweep = (dia_spmv.launches - before) / n_sweeps
    iters = list(A.pcg_trace)
    del prob.eval_f, prob.solve_system
    part_ms = {kind: sum(s.elapsed_time(e) for s, e in pairs) / n_sweeps for kind, pairs in spans.items()}
    integral_ms = _event_ms(lambda i: lvl.integrate(), 20)
    residual_ms = _event_ms(lambda i: lvl.compute_residual(), 20)
    A.disable_pallas_dia()
    sweep_plain_ms = _event_ms(sweep, n_sweeps, warmup=1)
    A.enable_pallas_dia()
    # a cold solve (zero start), as bench.py counts its PCG depth (bench.py:376)
    rhs = lvl.state.u[1].clone()
    cold = []
    cold_ms = _event_ms(lambda i: cold.append(A.solve_shifted_info(rhs, 0.3 * lvl.params.dt)[1]), 3, warmup=1)
    A.pcg_trace = None
    nnz_per_sweep = M_MAIN * A.A.nnz
    rest_ms = sweep_ms - part_ms['eval_f'] - part_ms['solve'] - integral_ms - residual_ms
    print(f'times: sparse sweep {N_SPARSE}^2 fp32 {sweep_ms:.4f} ms on the card, {sweep_host_ms:.4f} ms on the host '
          f'clock ({per_sweep:.1f} K2 launches/sweep, {nnz_per_sweep / sweep_ms / 1e6:.3f} Gnnz/s of eval_f); '
          f'through the plain rolls {sweep_plain_ms:.4f} ms [{card}]')
    print(f'times: sparse sweep parts: {M_MAIN} x eval_f (K2) {part_ms["eval_f"]:.4f} ms, {M_MAIN} x PCG solve '
          f'{part_ms["solve"]:.4f} ms (iterations per solve over the {n_sweeps} sweeps {iters}, one host read per '
          f'iteration plus one), integral {integral_ms:.4f} ms, residual {residual_ms:.4f} ms, rest (Gauss-Seidel '
          f'right-hand sides, stacking) {rest_ms:.4f} ms; a cold PCG solve (x0 = 0, factor 0.3 dt) {cold_ms:.4f} ms '
          f'in {cold[-1]} iterations, {cold[-1] + 1} host reads [{card}]')
    return k2, k3


def _pfasst_description(nf, nc, dtype, device, restol, **over):
    """The two-level description of bench.py:512-531 at ``nf``^2 / ``nc``^2."""
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    desc = dict(
        problem_class=HeatND,
        problem_params=dict(nu=0.1, freq=4, nvars=[(nf, nf), (nc, nc)], bc='periodic', dtype=dtype, device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[3, 2], QI='LU'),
        level_params=dict(restol=restol, dt=DT),
        step_params=dict(maxiter=50),
        space_transfer_params=dict(rorder=2, iorder=6, periodic=True),
    )
    desc.update(over)
    return desc


def _pfasst_controller(description, num_procs):
    from pysdc_tpu_torch import ControllerNonMPI

    return ControllerNonMPI(num_procs, {'logger_level': 30, 'predict_type': 'pfasst_burnin'}, description)


def _block_run(ctrl, n_steps=None):
    """``n_steps`` steps from u_exact(0), by default one block: as many steps
    as the controller has processes.  Returns uend and the per-step niter."""
    from pysdc_tpu_torch import get_sorted

    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, (n_steps or len(ctrl.MS)) * DT)
    return uend, [v for _, v in get_sorted(stats, type='niter', sortby='time')]


def _count_applies(ctrl, shapes):
    """Count the ``apply`` calls of every step's operator, by level; the set
    ``shapes`` receives the shape of every field applied to."""
    counts = {}

    def counted(apply, level):
        def wrapper(u):
            counts[level] += 1
            shapes.add(tuple(u.shape))
            return apply(u)
        return wrapper

    for step in ctrl.MS:
        for lvl in step.levels:
            counts.setdefault(lvl.level_index, 0)
            lvl.prob.A.apply = counted(lvl.prob.A.apply, lvl.level_index)
    return counts


def phase_pfasst(card):
    """The PFASST path at full width.  Returns the controller, the K1 launch count, uend and niter."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = _pfasst_controller(_pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST), P_PFASST)
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, niter = _block_run(ctrl)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = cross_stencil_2d.launches
    if len(niter) != P_PFASST or not all(k < 50 for k in niter):
        raise AssertionError(f'pfasst: niter {niter}: not every one of {P_PFASST} steps converged under maxiter 50')
    if launches != sum(applies.values()) or min(applies.values()) < 1:
        raise AssertionError(f'pfasst: K1 launches {launches}, operator applies by level {applies}')
    if cross_stencil_2d.paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'pfasst: K1 launches by path {cross_stencil_2d.paths}, expected all on bands')
    if uend.shape != (N_PFASST, N_PFASST) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('pfasst: uend is not a finite float32 field of the fine grid shape')
    # the kernel check held K1 against its plain version at exactly these shapes and taps
    tables = _fd_tables()
    taps = [lvl.prob.A._cross_terms for lvl in ctrl.MS[0].levels]
    if not shapes <= set(K1_SHAPES) or taps != [tables['pfasst fine'], tables['pfasst coarse']]:
        raise AssertionError(f'pfasst: K1 ran at shapes {sorted(shapes)} or taps that the kernel check did not cover')

    # the same block through the plain apply (torch.roll) on every level
    plain = _pfasst_controller(_pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST), P_PFASST)
    for step in plain.MS:
        for lvl in step.levels:
            lvl.prob.A.disable_pallas()
    cross_stencil_2d.launches = 0
    uend_plain, niter_plain = _block_run(plain)
    diff_plain = (uend - uend_plain).abs().max().item()
    if cross_stencil_2d.launches != 0 or niter_plain != niter or not diff_plain <= PFASST_PLAIN_BOUND:
        raise AssertionError(f'pfasst vs plain apply: diff {diff_plain:.3e} > {PFASST_PLAIN_BOUND}, niter {niter_plain} '
                             f'against {niter}, K1 launches {cross_stencil_2d.launches}')

    ctrl64 = _pfasst_controller(_pfasst_description(N_PFASST, NC_PFASST, torch.float64, 'cuda', RESTOL_PFASST), P_PFASST)
    uend64, niter64 = _block_run(ctrl64)
    diff = (uend.double() - uend64).abs().max().item()
    if not all(k < 50 for k in niter64) or not diff <= PFASST_FP64_BOUND:
        raise AssertionError(f'pfasst: float64 niter {niter64}, |uend32 - uend64| {diff:.3e} > {PFASST_FP64_BOUND}')
    print(f'pfasst: HeatND {N_PFASST}^2/{NC_PFASST}^2 fp32, 3/2 nodes LU, restol {RESTOL_PFASST}, burn-in, '
          f'{P_PFASST} steps in one block: niter {niter} (float64 on the card: {niter64}), K1 launches {launches} = '
          f'operator applies by level {applies} at shapes {sorted(shapes)}, all on the bands path, wall {wall:.3f} s '
          f'incl. first calls, max|uend| {uend.abs().max().item():.6f}, |uend - uend_plain_apply| {diff_plain:.3e} <= '
          f'{PFASST_PLAIN_BOUND} with equal niter, |uend - uend_float64| {diff:.3e} <= {PFASST_FP64_BOUND} [{card}]')
    return ctrl, launches, uend, niter


def phase_pfasst_parity():
    """Float64, the card against the CPU: PFASST (4 steps) and two-level MLSDC with the FFT transfer."""
    import torch

    from pysdc_tpu_torch.transfer import FFTTransfer

    cases = {
        'PFASST 128^2/64^2, 4 steps, MeshTransfer': (4, {}),
        'MLSDC 128^2/64^2, 1 step at a time, FFTTransfer': (1, dict(space_transfer_class=FFTTransfer,
                                                                  space_transfer_params={})),
    }
    for name, (procs, over) in cases.items():
        runs = {}
        for device in ('cuda', 'cpu'):
            ctrl = _pfasst_controller(_pfasst_description(128, 64, torch.float64, device, 5e-10, **over), procs)
            uend, niter = _block_run(ctrl, n_steps=4)
            runs[device] = (uend.cpu(), niter)
        (u_card, it_card), (u_cpu, it_cpu) = runs['cuda'], runs['cpu']
        diff = (u_card - u_cpu).abs().max().item()
        if it_card != it_cpu or len(it_card) != 4 or not all(k < 50 for k in it_card) or not diff <= PARITY_UEND_TOL:
            raise AssertionError(f'pfasst parity: {name}: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}')
        print(f'pfasst parity: {name}, fp64 restol 5e-10: niter {it_card} on card and CPU, '
              f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


def phase_imex(card):
    """The IMEX path.  Returns the K1 launch count."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, IMEXSweeper, get_sorted
    from pysdc_tpu_torch.models.heat import HeatNDForced
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = dict(
        problem_class=HeatNDForced,
        problem_params=dict(nvars=(N_IMEX, N_IMEX), nu=0.1, freq=2, bc='periodic', dtype=torch.float32, device='cuda'),
        sweeper_class=IMEXSweeper,
        sweeper_params=dict(num_nodes=M_MAIN, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT, restol=-1.0),
        step_params=dict(maxiter=SWEEPS),
    )
    ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, IMEX_STEPS * DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    niter = [v for _, v in get_sorted(stats, type='niter', sortby='time')]
    launches = cross_stencil_2d.launches
    # the implicit part of every eval_f is one apply: per step f(u0) and one
    # batched f over the M spread nodes; QI='LU' takes the sequential branch
    # of the sweeper, one eval_f per node and sweep
    expected = sum(2 + M_MAIN * k for k in niter)
    if niter != [SWEEPS] * IMEX_STEPS or launches != expected:
        raise AssertionError(f'imex: niter {niter}, K1 launches {launches}, expected {expected}')
    if cross_stencil_2d.paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'imex: K1 launches by path {cross_stencil_2d.paths}, expected all on bands')
    if uend.shape != (N_IMEX, N_IMEX) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('imex: uend is not a finite float32 field of the grid shape')
    err = (uend - prob.u_exact(IMEX_STEPS * DT)).abs().max().item()
    if not err <= UEND_EXACT_BOUND:
        raise AssertionError(f'imex: |uend - u_exact| = {err:.3e} > {UEND_EXACT_BOUND}')
    print(f'imex: HeatNDForced {N_IMEX}^2 fp32, IMEXSweeper M={M_MAIN} LU/EE, {IMEX_STEPS} steps, niter {niter}, '
          f'K1 launches {launches} (= sum(2 + {M_MAIN}*niter), all on the bands path), wall {wall:.3f} s incl. first '
          f'calls, |uend - u_exact| {err:.3e} <= {UEND_EXACT_BOUND} [{card}]')
    return launches


STAGES = {'_spread': 'spread', '_predict': 'burn-in predictor', '_check': 'checks', '_fine_sweeps': 'fine sweeps',
          '_restrict_cascade': 'restrict', '_coarse_chain': 'coarse chain', '_prolong_cascade': 'prolong'}


PROFILE_ATTEMPTS = 3  # sessions of one measurement; the card's tracing now and then records no device event at all


def _profiled(fn, cpu=False):
    """``torch.profiler``'s events, averaged by name, over one call of ``fn()`` (the card's, and with ``cpu`` the
    host's too).  A session that recorded no device time is run again, up to PROFILE_ATTEMPTS sessions in all: the
    tracing drops a whole session now and then (twice in the whole script's runs on an H100 80GB HBM3, in a
    different phase each time).  So ``fn`` computes from fixed inputs, and a second session profiles the same call:
    every caller's ``fn`` does (a block or a step from a kept state, a sweep from a kept level state).  A session
    that drops only some events is not caught here: where a figure rests on one kernel, time it by CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if cpu else []) + [ProfilerActivity.CUDA]
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any((getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0.0)) > 0
               for e in events if e.device_type == DeviceType.CUDA):
            if attempt:
                print(f'profiler: {attempt} session(s) recorded no device time; profiled again')
            break
    return events


def _device_busy(fn, top=0):
    """(ms the card spent in kernels and copies, their number) over one call
    of ``fn()``, from ``torch.profiler``'s device trace; the rest of the
    call's time on the card is idle, waiting for the host.  ``top`` prints
    that many kernels, by device time."""
    def device_us(e):
        return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0.0)

    events = _profiled(fn)
    busy_us = sum(device_us(e) for e in events)
    if not busy_us > 0:
        raise AssertionError('times: the profiler saw no device time')
    if top:
        ranked = sorted(events, key=device_us, reverse=True)[:top]
        print('times: kernels by device time, ms (count): '
              + '; '.join(f'{e.key[:70]} {device_us(e) / 1e3:.3f} ({e.count})' for e in ranked))
    return busy_us / 1e3, sum(e.count for e in events)


def _block_by_stage(ctrl, label, card):
    """Run one block three times: first calls, then timed by stage of the
    stage machine (CUDA events around every handler call, the host clock
    beside them), then under the profiler for the card's busy time.  A check
    reads one residual per step on the host, so the card's time of a stage
    can hold the host's time of the one before."""
    import torch

    spans = {name: [] for name in STAGES}
    host = dict.fromkeys(STAGES, 0.0)

    def timed(name, handler):
        def wrapper(running):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            handler(running)
            end.record()
            host[name] += 1e3 * (time.perf_counter() - t0)
            spans[name].append((start, end))
        return wrapper

    _block_run(ctrl)  # first calls: FFT plans, launch plans, coefficient tables
    for name in STAGES:
        setattr(ctrl, name, timed(name, getattr(ctrl, name)))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    uend, niter = _block_run(ctrl)
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    for name in STAGES:
        delattr(ctrl, name)
    if not bool(torch.isfinite(uend).all()):
        raise AssertionError(f'times: {label}: uend is not finite, niter {niter}')
    residual = max(float(step.levels[0].status.residual) for step in ctrl.MS)
    block_ms = start.elapsed_time(end)
    busy_ms, n_kernels = _device_busy(lambda: _block_run(ctrl))
    card_ms = {name: sum(s.elapsed_time(e) for s, e in pairs) for name, pairs in spans.items()}
    rest = block_ms - sum(card_ms.values())
    busy = (f'{busy_ms:.3f} ms busy in {n_kernels} kernels and copies, idle {100 * (1 - busy_ms / block_ms):.0f}% '
            '(profiler, a third run)')
    print(f'times: {label}: one block {block_ms:.3f} ms on the card, {host_ms:.3f} ms on the host clock, {busy}, '
          f'niter {niter}, largest fine residual {residual:.3e}; by stage, ms on the card / ms on the host clock (calls): '
          + ', '.join(f'{STAGES[name]} {card_ms[name]:.3f} / {host[name]:.3f} ({len(spans[name])})' for name in STAGES)
          + f', rest (seeding the block, hooks, stats) {rest:.3f} [{card}]')


def phase_multilevel_times(pfasst_ctrl, heat_ctrl, card):
    import torch

    _block_by_stage(pfasst_ctrl, f'PFASST {N_PFASST}^2/{NC_PFASST}^2 fp32, {P_PFASST} steps', card)

    # one restrict and one prolong between the levels of a step, as the
    # block left them, and the space transfer alone on the node stacks
    step = pfasst_ctrl.MS[0]
    transfer, (fine, coarse) = step.base_transfers[0], step.levels
    space = transfer.space_transfer
    for name, fn in (('BaseTransfer.restrict', lambda i: transfer.restrict()),
                     ('BaseTransfer.prolong', lambda i: transfer.prolong()),
                     (f'MeshTransfer.restrict of {tuple(fine.u.shape)}', lambda i: space.restrict(fine.u)),
                     (f'MeshTransfer.prolong of {tuple(coarse.u[1:].shape)}', lambda i: space.prolong(coarse.u[1:]))):
        ms, host_ms = _event_ms(fn, 20, host=True)
        print(f'times: {name} {N_PFASST}^2 -> {NC_PFASST}^2 fp32: {ms:.4f} ms on the card, {host_ms:.4f} ms to '
              f'enqueue on the host [{card}]')

    # the same block at 2048^2 / 1024^2 with 4 steps.  Its float32 residual
    # stalls above restol 1e-3 (the roundoff of dt * A u at 1/dx^2 = 4.2e6),
    # so the block is held to the iteration profile of the 512^2 run instead:
    # restol -1 and maxiter 1 give the burn-in and one iteration per step
    big = _pfasst_controller(_pfasst_description(2048, 1024, torch.float32, 'cuda', -1.0, step_params=dict(maxiter=1)), 4)
    torch.cuda.reset_peak_memory_stats()
    _block_by_stage(big, 'PFASST 2048^2/1024^2 fp32, 4 steps, one iteration each', card)
    print(f'times: PFASST 2048^2/1024^2: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB [{card}]')
    del big

    # 8 sweeps in the operator's diagonal basis against update_nodes_k (8
    # update_nodes calls), from the spread initial guess
    from pysdc_tpu_torch.ops.diag_sdc import diagonal_sweeps

    lvl = heat_ctrl.MS[0].levels[0]
    prob, sweep = lvl.prob, lvl.sweep
    state = sweep.predict(prob, prob.u_exact(0.0), 0.0, DT)

    def fused(i=0):
        return diagonal_sweeps(prob.diagonalizable_operator, sweep, state, 0.0, DT, SWEEPS)

    def looped(i=0):
        return sweep.update_nodes_k(prob, state, 0.0, DT, SWEEPS)

    diff = (fused().u[-1] - looped().u[-1]).abs().max().item()
    if not diff <= DIAG_SWEEPS_BOUND:
        raise AssertionError(f'times: diagonal_sweeps against {SWEEPS} update_nodes: max|d uend| {diff:.3e}')
    fused_ms, fused_host = _event_ms(fused, 5, warmup=1, host=True)
    loop_ms, loop_host = _event_ms(looped, 5, warmup=1, host=True)
    fused_busy, fused_n = _device_busy(fused)
    loop_busy, loop_n = _device_busy(looped)
    print(f'times: {SWEEPS} sweeps at {N_MAIN}^2 fp32 M={M_MAIN} LU: diagonal_sweeps (diagonal basis) {fused_ms:.4f} ms '
          f'on the card, {fused_host:.4f} ms to enqueue, {fused_busy:.4f} ms busy in {fused_n} kernels (profiler); '
          f'update_nodes_k = {SWEEPS} x update_nodes {loop_ms:.4f} ms, {loop_host:.4f} ms to enqueue, {loop_busy:.4f} ms '
          f'busy in '
          f'{loop_n} kernels; max|d uend| {diff:.3e} <= {DIAG_SWEEPS_BOUND} [{card}]')


def _block_controller(description, num_procs, coarse_mode='auto', **controller_params):
    from pysdc_tpu_torch import ShardedController

    params = {'logger_level': 30, 'predict_type': 'pfasst_burnin', **controller_params}
    return ShardedController(num_procs, params, description, coarse_mode=coarse_mode)


def _niter(stats):
    from pysdc_tpu_torch import get_sorted

    return [v for _, v in get_sorted(stats, type='niter', sortby='time')]


def _counting_launches(phase):
    """``phase`` with K1's, K2's and the dense LU kernels' device-side launch counts armed
    (``cross_stencil_2d.device_count``, ``dia_spmv.device_count``, ``lu_panel.device_count``,
    ``lu_swap_trsm.device_count``, the tensors of :data:`_LAUNCH_COUNTS`): each wrapper adds one on the card at each
    launch, on the launch's stream, so a graph that captured the launch counts it again at every replay, inside
    conditional bodies too, where the profiler sees the kernels of one level of loops but not those of a loop
    inside a loop (a fused block's PCG, a GMRES restart's Arnoldi steps) on an H100 80GB HBM3 with CUDA 12.9.
    Armed for the whole phase, since its first runs capture the graphs; the counters are never freed, because
    those graphs write them."""
    import functools

    @functools.wraps(phase)
    def run(*args):
        import torch

        from pysdc_tpu_torch.ops.kernels.dense_lu import lu_panel, lu_swap_trsm
        from pysdc_tpu_torch.ops.kernels.dia import dia_spmv
        from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

        for name in ('k1', 'k2', 'lu', 'swap'):
            _LAUNCH_COUNTS.setdefault(name, torch.zeros((), dtype=torch.int64, device='cuda'))
        cross_stencil_2d.device_count, dia_spmv.device_count = _LAUNCH_COUNTS['k1'], _LAUNCH_COUNTS['k2']
        lu_panel.device_count, lu_swap_trsm.device_count = _LAUNCH_COUNTS['lu'], _LAUNCH_COUNTS['swap']
        try:
            return phase(*args)
        finally:
            cross_stencil_2d.device_count = dia_spmv.device_count = None
            lu_panel.device_count = lu_swap_trsm.device_count = None

    return run


_LAUNCH_COUNTS = {}  # 'k1', 'k2', 'lu', 'swap': the 0-d int64 launch counters on the card that _counting_launches arms


def _k1_kernels(fn):
    """K1 kernels the card ran over one call of ``fn()``, counted by the profiler: a graph replay launches the
    captured kernels without passing the wrapper, so its count does not see them."""
    return sum(e.count for e in _profiled(fn) if 'cross_stencil' in e.key)


@_counting_launches
def phase_fused(card, uend_stage, niter_stage):
    """The PFASST path through the block controller's fused lane, at full width.  Returns the K1 launch count
    of the wrapper over the first run (warm-up and capture: what the graphs replay)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = _block_controller(_pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST), P_PFASST)
    prob = ctrl.MS[0].levels[0].prob
    u0, Tend = prob.u_exact(0.0), P_PFASST * DT
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, stats = ctrl.run(u0, 0.0, Tend)  # lane='auto': the fused lane
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, reads, applies = cross_stencil_2d.launches, dict(ctrl.host_reads), dict(applies)
    niter = _niter(stats)
    lane = [v for k, v in stats.items() if k.type == 'lane']
    types = {k.type for k in stats}
    diff = (uend - uend_stage).abs().max().item()
    if niter != niter_stage or not diff <= FUSED_STAGE_BOUND:
        raise AssertionError(f'fused: niter {niter} against the stage machine\'s {niter_stage}, |uend_fused - uend_stage| '
                             f'{diff:.3e} > {FUSED_STAGE_BOUND}')
    if lane != ['fused'] or types != STATS_CONTRACT or ctrl.coarse_mode not in ('diag', 'replicated'):
        raise AssertionError(f'fused: lane {lane}, stats types {sorted(types)}, coarse mode {ctrl.coarse_mode}')
    if launches < 1 or launches != sum(applies.values()) or min(applies.values()) < 1:
        raise AssertionError(f'fused: K1 launches {launches}, operator applies by level {applies}')
    if cross_stencil_2d.paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'fused: K1 launches by path {cross_stencil_2d.paths}, expected all on bands')
    if uend.shape != (N_PFASST, N_PFASST) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('fused: uend is not a finite float32 field of the fine grid shape')
    tables = _fd_tables()
    taps = [lvl.prob.A._cross_terms for lvl in ctrl.MS[0].levels]
    if not shapes <= set(K1_SHAPES) or taps != [tables['pfasst fine'], tables['pfasst coarse']]:
        raise AssertionError(f'fused: K1 ran at shapes {sorted(shapes)} or taps that the kernel check did not cover')
    if reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'fused: host reads {reads} for niter {niter}: expected no cont read and one fetch')
    programs = list(ctrl._fused_fn._programs.values())
    if len(programs) != 1 or list(programs[0].graphs) != ['block']:
        raise AssertionError(f'fused: {len(programs)} programs with graphs {[list(p.graphs) for p in programs]}, '
                             f'expected one graph a block')

    # a second run replays the graph: the wrapper launches nothing, the card runs the captured kernels
    cross_stencil_2d.launches = 0
    k1_count = _LAUNCH_COUNTS['k1']
    k1_count.zero_()
    ctrl.run_fused(u0, 0.0, Tend)
    replayed = int(k1_count)
    if cross_stencil_2d.launches != 0 or replayed < 1:
        raise AssertionError(f'fused: the replayed block passed the wrapper {cross_stencil_2d.launches} times and ran '
                             f'{replayed} K1 kernels')
    uend2, stats2 = ctrl.run_fused(u0, 0.0, Tend)
    if _niter(stats2) != niter or not torch.equal(uend2, uend):
        raise AssertionError('fused: a replayed block differs from the first run')

    # the block controller's stage lane: the same batched functions, eager, under the stage machine
    k1_count.zero_()
    uend_st, stats_st = ctrl.run(u0, 0.0, Tend, lane='stage')
    stage_k1 = int(k1_count)
    diff_st = (uend_st - uend_stage).abs().max().item()
    if _niter(stats_st) != niter_stage or not diff_st <= FUSED_STAGE_BOUND:
        raise AssertionError(f'fused: block controller stage lane niter {_niter(stats_st)}, |uend - uend_stage| {diff_st:.3e}')
    if [v for k, v in stats_st.items() if k.type == 'lane'] != ['stage']:
        raise AssertionError('fused: the stage lane did not record itself')
    print(f'fused: ShardedController({P_PFASST}) HeatND {N_PFASST}^2/{NC_PFASST}^2 fp32, 3/2 nodes LU, restol '
          f'{RESTOL_PFASST}, burn-in, one block, coarse chain {ctrl.coarse_mode!r}: lane {lane[0]}, niter {niter} = the '
          f'stage machine\'s, |uend_fused - uend_stage| {diff:.3e} <= {FUSED_STAGE_BOUND}, stats types = the contract\'s '
          f'{sorted(types)}; K1 launches through the wrapper {launches} (warm-up and capture; = operator applies by '
          f'level {applies}) at shapes {sorted(shapes)}, all on the bands path; one graph a block, a replayed block '
          f'passes the wrapper 0 times and runs {replayed} K1 kernels (counted on the card at each launch; the stage lane '
          f'of the block controller launches {stage_k1}); host reads a block {reads}; wall {wall:.3f} s incl. '
          f'warm-up and capture; stage lane of the block controller: niter equal, |uend - uend_stage| {diff_st:.3e} [{card}]')
    return launches


def _forced_description(dtype, device):
    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.models.heat import HeatNDForced

    return dict(
        problem_class=HeatNDForced,
        problem_params=dict(nvars=(N_FORCED, N_FORCED), nu=0.1, freq=2, bc='periodic', dtype=dtype, device=device),
        sweeper_class=IMEXSweeper,
        sweeper_params=dict(num_nodes=M_FORCED, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT, restol=RESTOL_FORCED),
        step_params=dict(maxiter=20),
    )


def phase_fused_march(card):
    """Several blocks through the fused lane against ``ControllerNonMPI`` on the card: the step times and the
    tail block's window are inputs of the graphs, not frozen in them."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d
    from pysdc_tpu_torch.parallel import fused

    # PFASST, 4 blocks of 8 steps.  The solution decays by a factor of 12 a block, so against an absolute restol
    # only the first block would iterate: the residual is taken relative to each step's |u0| (its float32 floor is
    # about 1.5e-4 then), and every block meets the same iteration
    desc = _pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST)
    desc['level_params'] = dict(desc['level_params'], residual_type='full_rel')
    n_steps = MARCH_BLOCKS * P_PFASST
    stage = _pfasst_controller(desc, P_PFASST)
    u_stage, it_stage = _block_run(stage, n_steps)
    block = _block_controller(desc, P_PFASST)
    u0 = block.MS[0].levels[0].prob.u_exact(0.0)
    # run_fused marches under set_sync_debug_mode('error') from its first replay to its fetch: a synchronizing call
    # in between raises.  That the mode raises on this torch, for a read on the host:
    with fused._no_sync(u0.device):
        try:
            u0.sum().item()
        except RuntimeError:
            pass
        else:
            raise AssertionError('fused march: a read on the host did not raise under set_sync_debug_mode(\'error\')')
    u_fused, stats = block.run_fused(u0, 0.0, n_steps * DT)
    diff = (u_fused - u_stage).abs().max().item()
    reads = dict(block.host_reads)
    if _niter(stats) != it_stage or len(it_stage) != n_steps or not diff <= FUSED_STAGE_BOUND:
        raise AssertionError(f'fused march: PFASST niter {_niter(stats)} against {it_stage}, |uend - uend_stage| {diff:.3e}')
    if reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'fused march: host reads over the march {reads}')
    by_block = [it_stage[b * P_PFASST:(b + 1) * P_PFASST] for b in range(MARCH_BLOCKS)]
    if not all(min(block[1:]) >= 1 and max(block) < 50 for block in by_block):
        raise AssertionError(f'fused march: a block holds nothing: niter by block {by_block}, expected at least one '
                             f'iteration in every step but the first of each block')
    print(f'fused march: PFASST {N_PFASST}^2/{NC_PFASST}^2 fp32, relative residuals, {MARCH_BLOCKS} blocks of {P_PFASST} steps '
          f'(every block iterates in every step but its first): niter '
          f'{_niter(stats)} = ControllerNonMPI\'s per step, |uend - uend_stage| {diff:.3e} <= {FUSED_STAGE_BOUND}, host '
          f'reads over the march {reads}, the march under set_sync_debug_mode(\'error\') (which raises on a host read '
          f'here) [{card}]')

    # forced heat equation, IMEX, single level: 3 blocks of 4 steps and a tail of 2
    desc = _forced_description(torch.float32, 'cuda')
    stage = ControllerNonMPI(P_FORCED, {'logger_level': 30}, desc)
    prob = stage.MS[0].levels[0].prob
    Tend = FORCED_STEPS * DT
    u_stage, stats_stage = stage.run(prob.u_exact(0.0), 0.0, Tend)
    block = _block_controller(desc, P_FORCED, predict_type=None)
    shapes = set()
    _count_applies(block, shapes)
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    u_fused, stats = block.run(prob.u_exact(0.0), 0.0, Tend)
    exact = prob.u_exact(Tend)
    err_fused, err_stage = (u_fused - exact).abs().max().item(), (u_stage - exact).abs().max().item()
    diff = (u_fused - u_stage).abs().max().item()
    if _niter(stats) != _niter(stats_stage) or len(_niter(stats)) != FORCED_STEPS or not diff <= FUSED_STAGE_BOUND:
        raise AssertionError(f'fused march: forced niter {_niter(stats)} against {_niter(stats_stage)}, '
                             f'|uend - uend_stage| {diff:.3e}')
    if not err_fused <= err_stage + FUSED_STAGE_BOUND:
        raise AssertionError(f'fused march: forced |uend - u_exact| {err_fused:.3e} worse than the stage machine\'s {err_stage:.3e}')
    if not shapes <= set(K1_SHAPES) or cross_stencil_2d.paths['general'] != 0 \
            or prob.A._cross_terms != _fd_tables()['pfasst fine']:
        raise AssertionError(f'fused march: forced K1 shapes {sorted(shapes)}, by path {cross_stencil_2d.paths}')
    if block.host_reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'fused march: forced, host reads over the march {block.host_reads}')
    times = sorted(round(k.time, 10) for k in stats if k.type == 'niter')
    if times != [round(j * DT, 10) for j in range(FORCED_STEPS)]:
        raise AssertionError(f'fused march: forced step times {times}')
    print(f'fused march: HeatNDForced {N_FORCED}^2 fp32 IMEX M={M_FORCED} LU/EE, restol {RESTOL_FORCED}, single level, '
          f'{FORCED_STEPS} steps = 3 blocks of {P_FORCED} and a tail of 2, lane '
          f'{[v for k, v in stats.items() if k.type == "lane"]}: niter {_niter(stats)} = ControllerNonMPI\'s per step, '
          f'|uend - uend_stage| {diff:.3e} <= {FUSED_STAGE_BOUND}, |uend - u_exact| {err_fused:.3e} (stage machine '
          f'{err_stage:.3e}), host reads over the march {block.host_reads}, programs captured '
          f'{len(block._fused_fn._programs)} [{card}]')


def phase_fused_parity():
    """Float64, ``run_fused`` on the card (graphs) against the CPU (eager pieces)."""
    import torch

    runs = {}
    for device in ('cuda', 'cpu'):
        ctrl = _block_controller(_pfasst_description(128, 64, torch.float64, device, 1e-10), 4)
        uend, stats = ctrl.run_fused(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 4 * DT)
        runs[device] = (uend.cpu(), _niter(stats))
    (u_card, it_card), (u_cpu, it_cpu) = runs['cuda'], runs['cpu']
    diff = (u_card - u_cpu).abs().max().item()
    if it_card != it_cpu or len(it_card) != 4 or not all(k < 50 for k in it_card) or not diff <= PARITY_UEND_TOL:
        raise AssertionError(f'fused parity: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}')
    print(f'fused parity: run_fused PFASST 128^2/64^2, 4 steps, fp64 restol 1e-10: niter {it_card} on card and CPU, '
          f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


def _timed_block(fn, label, card, reads=None, top=0):
    """``fn()`` runs one block (or march): after a first call, CUDA events and the host clock around a second,
    the profiler over a third."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    card_ms = start.elapsed_time(end)
    busy_ms, n_kernels = _device_busy(fn, top)
    print(f'times: {label}: {card_ms:.3f} ms on the card, {host_ms:.3f} ms on the host clock, {busy_ms:.3f} ms busy in '
          f'{n_kernels} kernels and copies, idle {100 * (1 - busy_ms / card_ms):.0f}% (profiler, a third run)'
          + (f', host reads {reads()}' if reads else '') + f' [{card}]')
    return out, card_ms


def phase_fused_times(card):
    import torch

    desc = _pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST)
    Tend = P_PFASST * DT
    results = {}
    # auto, other, other, auto: the two coarse chains in turns within this call
    ctrls = {mode: _block_controller(desc, P_PFASST, coarse_mode=mode) for mode in ('diag', 'replicated')}
    u0 = ctrls['diag'].MS[0].levels[0].prob.u_exact(0.0)
    for mode in ('diag', 'replicated', 'replicated', 'diag'):
        ctrl = ctrls[mode]
        (uend, stats), ms = _timed_block(lambda: ctrl.run_fused(u0, 0.0, Tend),
                                         f'fused PFASST block {N_PFASST}^2/{NC_PFASST}^2 fp32, {P_PFASST} steps, coarse '
                                         f'chain {mode!r}', card, reads=lambda: ctrl.host_reads,
                                         top=0 if results else 12)
        results.setdefault(mode, []).append((ms, _niter(stats), uend))
    (_, it_d, u_d), (_, it_r, u_r) = results['diag'][0], results['replicated'][0]
    diff = (u_d - u_r).abs().max().item()
    if it_d != it_r or not diff <= FUSED_STAGE_BOUND:
        raise AssertionError(f'times: diag chain niter {it_d} against replicated {it_r}, |d uend| {diff:.3e}')
    # the block's one graph on its own: spread, burn-in and the PFASST loop as a device while
    prog = next(iter(ctrls['diag']._fused_fn._programs.values()))
    replay_ms = _event_ms(lambda i: prog.run('block'), 5, warmup=1)
    print(f'times: fused block, coarse chain \'diag\': {replay_ms:.3f} ms a replay of its one graph (CUDA events) '
          f'[{card}]')
    auto = _block_controller(desc, P_PFASST).coarse_mode
    print(f'times: coarse chain of the fused block, ms on the card in turns: diag {[round(r[0], 3) for r in results["diag"]]}, '
          f'replicated {[round(r[0], 3) for r in results["replicated"]]}; equal niter {it_d}, max|d uend| {diff:.3e}; '
          f'coarse_mode=\'auto\' resolves to {auto!r} [{card}]')

    ctrl = ctrls[auto]
    _timed_block(lambda: ctrl.run(u0, 0.0, Tend, lane='stage'),
                 f'block controller, eager stage lane, {N_PFASST}^2/{NC_PFASST}^2 fp32, {P_PFASST} steps', card)
    del ctrls, results

    # the block at 2048^2 / 1024^2 with 4 steps, restol -1 and one iteration a step (float32 cannot reach 1e-3 there)
    big = _block_controller(_pfasst_description(2048, 1024, torch.float32, 'cuda', -1.0, step_params=dict(maxiter=1)), 4)
    u0_big = big.MS[0].levels[0].prob.u_exact(0.0)
    torch.cuda.reset_peak_memory_stats()
    (uend, stats), _ = _timed_block(lambda: big.run_fused(u0_big, 0.0, 4 * DT),
                                    'fused PFASST block 2048^2/1024^2 fp32, 4 steps, one iteration each', card,
                                    reads=lambda: big.host_reads)
    if _niter(stats) != [1] * 4 or not bool(torch.isfinite(uend).all()):
        raise AssertionError(f'times: fused 2048^2/1024^2 niter {_niter(stats)}')
    print(f'times: fused PFASST 2048^2/1024^2: peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB '
          f'(static buffers, the graphs\' pool and the warm-up) [{card}]')
    del big, u0_big

    # the serial march: single level, 8 one-step blocks through build_fused_many
    from pysdc_tpu_torch.parallel.fused import build_fused_block, build_fused_many

    serial_desc = dict(desc, problem_params=dict(desc['problem_params'], nvars=(N_PFASST, N_PFASST)),
                       sweeper_params=dict(desc['sweeper_params'], num_nodes=3))
    serial = _block_controller(serial_desc, 1, predict_type=None)
    many = build_fused_many(serial, build_fused_block(serial))
    starts = DT * np.arange(P_PFASST)

    def march():
        serial.host_reads = {'cont': 0, 'fetch': 0}
        return many(u0, DT, starts)

    (uend, iters, _, _), _ = _timed_block(march,
                                       f'serial march, ShardedController(1), {N_PFASST}^2 fp32, {P_PFASST} one-step blocks',
                                       card, reads=lambda: serial.host_reads)
    print(f'times: serial march niter {iters.reshape(-1).tolist()}, max|uend| {uend.abs().max().item():.6f} [{card}]')


def _entries(stats, kind):
    """The values of the ``kind`` entries in the order the run made them: by time, a rejected step before its repeat."""
    keys = sorted((k for k in stats if k.type == kind), key=lambda k: (k.time, k.num_restarts))
    return [stats[k] for k in keys]


def _adaptive_description(nf, nc, dtype, device):
    """bench.py:621-673 at ``nf``^2 / ``nc``^2: the PFASST description with maxiter-only termination and Adaptivity."""
    from pysdc_tpu_torch.convergence import Adaptivity

    return _pfasst_description(nf, nc, dtype, device, -1.0, step_params=dict(maxiter=MAXITER_AD),
                               convergence_controllers={Adaptivity: dict(ADAPTIVE_PARAMS)})


def _allen_cahn_description(nf, nc, dtype, device, dt=DT_AC, eps=0.04, **adaptivity):
    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.convergence import Adaptivity
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicSemiImplicitND

    return dict(
        problem_class=AllenCahnPeriodicSemiImplicitND,
        problem_params=dict(nvars=[(nf, nf), (nc, nc)], eps=eps, radius=0.25, dtype=dtype, device=device),
        sweeper_class=IMEXSweeper,
        sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=[M_AC], QI='LU', QE='EE'),
        level_params=dict(restol=-1.0, dt=dt),
        step_params=dict(maxiter=MAXITER_AD),
        space_transfer_params=dict(rorder=2, iorder=6, periodic=True),
        convergence_controllers={Adaptivity: dict(adaptivity or AC_PARAMS)},  # dt_min / dt_max: a StepSizeLimiter
    )


def _block_shapes(n, nc, m_fine, m_coarse, serial_chain):
    """K1's shapes on a two-level block of P_AD steps: a block of fields and the node stacks of blocks on either
    level; the serial coarse chain also applies to one coarse field at a time."""
    shapes = {(P_AD, n, n), (m_fine, P_AD, n, n), (P_AD, nc, nc), (m_coarse, P_AD, nc, nc)}
    return shapes | ({(nc, nc)} if serial_chain else set())


def _adaptive_k1_cases():
    """(name, taps, shapes): what the adaptive paths give K1."""
    import torch

    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicSemiImplicitND
    from pysdc_tpu_torch.models.heat import HeatND

    def heat(n):
        return HeatND(nvars=(n, n), nu=0.1, freq=4, bc='periodic', dtype=torch.float32, device='cuda').A._cross_terms

    def allen_cahn(n):
        return AllenCahnPeriodicSemiImplicitND(nvars=(n, n), eps=0.04, dtype=torch.float32, device='cuda').A._cross_terms

    cases = []
    for n, nc in ((N_AD, NC_AD), (N_AD_BIG, NC_AD_BIG)):
        shapes = _block_shapes(n, nc, 3, 2, serial_chain=True)
        cases.append((f'adaptive heat {n}', heat(n), sorted(sh for sh in shapes if sh[-1] == n)))
        cases.append((f'adaptive heat {nc}', heat(nc), sorted(sh for sh in shapes if sh[-1] == nc)))
    shapes = _block_shapes(N_AC, NC_AC, M_AC, M_AC, serial_chain=True)
    cases.append((f'allen-cahn {N_AC}', allen_cahn(N_AC),
                  sorted({sh for sh in shapes if sh[-1] == N_AC} | {(N_AC, N_AC), (AC_SWEEP_M, N_AC, N_AC)})))
    cases.append((f'allen-cahn {NC_AC}', allen_cahn(NC_AC), sorted(sh for sh in shapes if sh[-1] == NC_AC)))
    return cases


def phase_adaptive_kernels():
    """K1 against its plain version at the adaptive paths' shapes and taps, on the path the wrapper picks (bands at
    every one of them) and with the general path forced.  Returns name -> (taps, shapes covered)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import choose_path

    gen = torch.Generator(device='cuda').manual_seed(4321)
    covered = {}
    for name, terms, shapes in _adaptive_k1_cases():
        covered.setdefault(name, (terms, set()))[1].update(shapes)
        for dtype in (torch.float32, torch.float64):
            tol = _stencil_tolerance(terms, dtype)
            itemsize = torch.empty((), dtype=dtype).element_size()
            worst, worst_abs = 0.0, 0.0
            for shape in shapes:
                if choose_path(shape, terms, itemsize) != 'bands':
                    raise AssertionError(f'K1 {name} {dtype} {shape}: the wrapper does not pick the bands path')
                u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
                err, rel = _k1_both_paths(name, terms, u, 'bands', tol)
                worst, worst_abs = max(worst, rel), max(worst_abs, err)
                del u
            print(f'adaptive kernels: K1 {name:18s} {str(dtype):13s} max rel err {worst:.3e} <= tol {tol:.3e} (max abs '
                  f'{worst_abs:.3e} on bands), on bands and with the general path forced, at {shapes}')
    return covered


def _adaptive_against_stage(label, desc, Tend, card, covered, expected_shapes, dt_rtol, coarse_mode='auto',
                            min_blocks=3, replay=True):
    """One adaptive march through ``run()`` (``lane='auto'``) against the block controller's stage lane, with every
    gate of the adaptive lane.  Returns (controller, stage controller, K1 launches of the wrapper, what was printed)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = _block_controller(desc, P_AD, coarse_mode=coarse_mode)
    stage = _block_controller(desc, P_AD, coarse_mode=coarse_mode)
    prob = ctrl.MS[0].levels[0].prob
    u0 = prob.u_exact(0.0)
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, stats = ctrl.run(u0, 0.0, Tend)  # lane='auto': the adaptive fused lane
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, reads, applies = cross_stencil_2d.launches, dict(ctrl.host_reads), dict(applies)
    by_path = dict(cross_stencil_2d.paths)
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')

    lane = [v for k, v in stats.items() if k.type == 'lane']
    types = {k.type for k in stats}
    niter, restart, dts = (_entries(stats, kind) for kind in ('niter', 'restart', 'dt'))
    niter_s, restart_s, dts_s = (_entries(stats_s, kind) for kind in ('niter', 'restart', 'dt'))
    blocks = sum(1 for k in stats if k.type == 'niter' and k.process == 0)
    if lane != ['fused_adaptive'] or [v for k, v in stats_s.items() if k.type == 'lane'] != ['stage']:
        raise AssertionError(f'{label}: lane {lane}: run() did not take the adaptive fused lane')
    if types != ADAPTIVE_CONTRACT:
        raise AssertionError(f'{label}: stats types {sorted(types)} are not the contract\'s {sorted(ADAPTIVE_CONTRACT)}')
    if niter != niter_s or restart != restart_s or len(dts) != len(dts_s) or set(niter) != {MAXITER_AD}:
        raise AssertionError(f'{label}: niter {niter} / restart {restart} against the stage lane\'s {niter_s} / {restart_s}')
    dt_gap = max(abs(a - b) / b for a, b in zip(dts, dts_s))
    diff = (uend - uend_s).abs().max().item()
    if not dt_gap <= dt_rtol or not diff <= FUSED_STAGE_BOUND:
        first = next(i for i, (a, b) in enumerate(zip(dts, dts_s)) if abs(a - b) / b > dt_rtol) if dt_gap > dt_rtol else None
        raise AssertionError(f'{label}: accepted dt differ by {dt_gap:.3e} > {dt_rtol} (first at step {first}): {dts} against '
                             f'{dts_s}; |uend_fused - uend_stage| {diff:.3e}')
    distinct = sorted({float(f'{dt:.6g}') for dt in dts})
    programs = ctrl._fused_adaptive_fn._programs
    graphs = sum(len(prog.graphs) for prog in programs.values())
    if len(programs) != 1 or graphs != 3 or len(distinct) < 3 or blocks < min_blocks:
        raise AssertionError(f'{label}: {len(programs)} programs with {graphs} graphs over {blocks} blocks with dt in {distinct}')
    if reads != {'cont': 0, 'fetch': blocks, 'estimate': len(niter)}:
        raise AssertionError(f'{label}: host reads {reads} over {blocks} blocks of {len(niter)} steps')
    if launches < 1 or launches != sum(applies.values()) or by_path != {'bands': launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches {launches} by path {by_path}, operator applies by level {applies}')
    taps = [lvl.prob.A._cross_terms for lvl in ctrl.MS[0].levels]
    names = [name for name, (terms, _) in covered.items() if terms in taps]
    checked = set().union(*(covered[name][1] for name in names)) if names else set()
    if shapes != expected_shapes or not shapes <= checked or len(names) < len(taps):
        raise AssertionError(f'{label}: K1 ran at shapes {sorted(shapes)}, expected {sorted(expected_shapes)}, the kernel '
                             f'check covered {sorted(checked)} under {names}')
    if uend.shape != prob.shape or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError(f'{label}: uend is not a finite float32 field of the fine grid shape')

    replayed = None
    if replay:  # a second march replays the graphs: the wrapper launches nothing
        cross_stencil_2d.launches = 0
        replayed = _k1_kernels(lambda: ctrl.run(u0, 0.0, Tend))
        uend2, stats2 = ctrl.run(u0, 0.0, Tend)
        if cross_stencil_2d.launches != 0 or replayed < 1 or not torch.equal(uend2, uend) or _entries(stats2, 'dt') != dts:
            raise AssertionError(f'{label}: a replayed march passed the wrapper {cross_stencil_2d.launches} times, ran '
                                 f'{replayed} K1 kernels, or differs from the first')
        if len(programs) != 1:
            raise AssertionError(f'{label}: a second march captured again')
    print(f'{label}, coarse chain {ctrl.coarse_mode!r}: lane {lane[0]}, {len(niter)} steps in {blocks} blocks, niter all '
          f'{MAXITER_AD}, restart {restart} = the stage lane\'s, accepted dt {[float(f"{dt:.5g}") for dt in dts]} within '
          f'{dt_gap:.3e} <= {dt_rtol} of the stage lane\'s, |uend_fused - uend_stage| {diff:.3e} <= {FUSED_STAGE_BOUND} at '
          f'max|uend| {uend.abs().max().item():.3e}; 1 program = 3 graphs over {len(distinct)} distinct dt; host reads '
          f'{reads} (no cont, one fetch a block); K1 through the wrapper {launches} (warm-up and capture; = applies by '
          f'level {applies}) at {sorted(shapes)}, all on bands'
          + (f'; a replayed march passes the wrapper 0 times and runs {replayed} K1 kernels (profiler)' if replay else '')
          + f'; stats types = the contract\'s; wall {wall:.3f} s incl. capture [{card}]')
    return ctrl, stage, launches


def phase_adaptive(card, covered):
    """The adaptive production stack on the heat equation at 256^2 / 128^2 and at 1024^2 / 512^2.  Returns the
    controllers by size for the times and the K1 launch counts."""
    import torch

    out, launches = {}, {}
    for n, nc, Tend, min_blocks in ((N_AD, NC_AD, TEND_AD, 3), (N_AD_BIG, NC_AD_BIG, TEND_AD_BIG, 4)):
        desc = _adaptive_description(n, nc, torch.float32, 'cuda')
        label = f'adaptive: HeatND {n}^2/{nc}^2 fp32, 3/2 nodes LU, maxiter {MAXITER_AD}, Adaptivity {ADAPTIVE_PARAMS}, ' \
                f'burn-in, P={P_AD}, Tend {Tend:g}'
        # the serial coarse chain on both lanes: the same arithmetic, so the accepted dt must agree
        _adaptive_against_stage(label, desc, Tend, card, covered, _block_shapes(n, nc, 3, 2, True), ADAPTIVE_DT_RTOL,
                                coarse_mode='replicated', min_blocks=min_blocks, replay=False)
        # the production configuration: coarse_mode='auto' resolves to the diagonal basis
        ctrl, stage, k1 = _adaptive_against_stage(label, desc, Tend, card, covered, _block_shapes(n, nc, 3, 2, False),
                                                  ADAPTIVE_DIAG_DT_RTOL, min_blocks=min_blocks)
        if ctrl.coarse_mode != 'diag':
            raise AssertionError(f'adaptive: coarse_mode \'auto\' resolved to {ctrl.coarse_mode!r}')
        out[n], launches[n] = (ctrl, stage, Tend), k1
    return out, launches


def phase_adaptive_allen_cahn(card, covered):
    """Allen-Cahn: the adaptive two-level block march, and the 20 sweeps of bench.py:209-244.  Returns the march's
    controllers and the two K1 launch counts."""
    import torch

    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicSemiImplicitND
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _allen_cahn_description(N_AC, NC_AC, torch.float32, 'cuda')
    label = f'adaptive allen-cahn: AllenCahnPeriodicSemiImplicitND {N_AC}^2/{NC_AC}^2 fp32 eps 0.04, IMEX M={M_AC} LU/EE, ' \
            f'maxiter {MAXITER_AD}, Adaptivity {AC_PARAMS} (StepSizeLimiter), burn-in, P={P_AD}, dt0 {DT_AC:g}, Tend {TEND_AC:g}'
    ctrl, stage, march_launches = _adaptive_against_stage(
        label, desc, TEND_AC, card, covered, _block_shapes(N_AC, NC_AC, M_AC, M_AC, True), ADAPTIVE_DT_RTOL, min_blocks=4)
    if 'StepSizeLimiter' not in [type(C).__name__ for C in ctrl.convergence_controllers]:
        raise AssertionError('adaptive allen-cahn: no StepSizeLimiter in the stack')

    # the twin of bench_tpu_allen_cahn: 20 sweeps (update_nodes + residual) from the spread initial guess
    prob = AllenCahnPeriodicSemiImplicitND(nvars=(N_AC, N_AC), eps=0.04, radius=0.25, dtype=torch.float32, device='cuda')
    sweep = IMEXSweeper({'num_nodes': AC_SWEEP_M, 'quad_type': 'RADAU-RIGHT', 'QI': 'LU', 'QE': 'EE'})
    counts, shapes = {'applies': 0}, set()
    apply = prob.A.apply

    def counted(u):
        counts['applies'] += 1
        shapes.add(tuple(u.shape))
        return apply(u)

    def chain(i=0):
        state = sweep.predict(prob, prob.u_exact(0.0), 0.0, AC_SWEEP_DT)
        for _ in range(AC_SWEEPS):
            state = sweep.update_nodes(prob, state, 0.0, AC_SWEEP_DT, 0)
            _, res = sweep.compute_residual(state, AC_SWEEP_DT)
        return state, res

    prob.A.apply = counted
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    state, res = chain()
    torch.cuda.synchronize()
    sweep_launches = cross_stencil_2d.launches
    del prob.A.apply
    expected = 2 + AC_SWEEP_M * AC_SWEEPS  # f(u0) and the batched f over the spread nodes, then M a sweep
    name = f'allen-cahn {N_AC}'
    if sweep_launches != counts['applies'] or sweep_launches != expected \
            or cross_stencil_2d.paths != {'bands': sweep_launches, 'general': 0}:
        raise AssertionError(f'adaptive allen-cahn: sweeps: K1 launches {sweep_launches}, applies {counts["applies"]}, '
                             f'expected {expected}, by path {cross_stencil_2d.paths}')
    if prob.A._cross_terms != covered[name][0] or not shapes <= covered[name][1]:
        raise AssertionError(f'adaptive allen-cahn: sweeps: K1 ran at {sorted(shapes)} or taps the kernel check did not cover')
    prob.A.disable_pallas()
    state_plain, res_plain = chain()
    prob.A.enable_pallas()
    diff = (state.u - state_plain.u).abs().max().item()
    if cross_stencil_2d.launches != sweep_launches or not diff <= AC_PLAIN_BOUND or not math.isfinite(float(res)):
        raise AssertionError(f'adaptive allen-cahn: sweeps against the plain apply: {diff:.3e} > {AC_PLAIN_BOUND}, residual '
                             f'{float(res):.3e}')
    ms, host_ms = _event_ms(chain, 3, warmup=1, host=True)
    prob.A.disable_pallas()
    plain_ms = _event_ms(chain, 3, warmup=1)
    prob.A.enable_pallas()
    nnz_per_sweep = AC_SWEEP_M * 5 * N_AC * N_AC
    print(f'adaptive allen-cahn: {AC_SWEEPS} sweeps at {N_AC}^2 fp32, IMEX M={AC_SWEEP_M} LU/EE, dt {AC_SWEEP_DT:g} '
          f'(bench.py:209-244): K1 launches {sweep_launches} = applies = 2 + {AC_SWEEP_M} a sweep, all on bands, at '
          f'{sorted(shapes)}; residual {float(res):.3e} (plain apply {float(res_plain):.3e}), |u - u_plain_apply| {diff:.3e} <= '
          f'{AC_PLAIN_BOUND}; {ms / AC_SWEEPS:.4f} ms a sweep on the card, {host_ms / AC_SWEEPS:.4f} ms to enqueue on the '
          f'host, {nnz_per_sweep * AC_SWEEPS / ms / 1e6:.3f} Gnnz/s; through the plain apply {plain_ms / AC_SWEEPS:.4f} ms a '
          f'sweep (predict included in each) [{card}]')
    return (ctrl, stage, TEND_AC), march_launches, sweep_launches


def phase_adaptive_parity():
    """Float64, the adaptive lane on the card (graphs, Newton as device loops) against the CPU (eager pieces)."""
    import torch

    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.convergence import Adaptivity
    from pysdc_tpu_torch.models.odes import VanDerPol

    def van_der_pol(device, num_procs, flavor):
        return dict(
            problem_class=VanDerPol,
            problem_params=dict(mu=5.0, u0=(2.0, 0.0), newton_tol=1e-10, dtype=torch.float64, device=device),
            sweeper_class=GenericImplicit,
            sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU'),
            level_params=dict(restol=-1.0, dt=1e-2),
            step_params=dict(maxiter=4 if num_procs == 1 else 7),
            convergence_controllers={Adaptivity: {'e_tol': 1e-7, 'embedded_error_flavor': flavor}},
        )

    cases = {f'VanDerPol P={P} {flavor}': (lambda dev, P=P, flavor=flavor: van_der_pol(dev, P, flavor), P,
                                           dict(mssdc_jac=True, predict_type=None), 0.1)
             for P in (1, 4) for flavor in ('standard', 'linearized')}
    cases['Allen-Cahn 32^2/16^2 P=4'] = (
        lambda dev: _allen_cahn_description(32, 16, torch.float64, dev, dt=1e-3, eps=0.2, e_tol=1e-7, dt_max=5e-3,
                                            dt_min=1e-5), 4, {}, 1e-3)
    for name, (make, num_procs, cp, Tend) in cases.items():
        runs = {}
        for device in ('cuda', 'cpu'):
            ctrl = ShardedController(num_procs, {'logger_level': 30, 'predict_type': 'pfasst_burnin', **cp}, make(device))
            uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
            runs[device] = (uend.cpu(), stats, len(ctrl._fused_adaptive_fn._programs))
        (u_card, s_card, programs), (u_cpu, s_cpu, _) = runs['cuda'], runs['cpu']
        lanes = [v for k, v in s_card.items() if k.type == 'lane'] + [v for k, v in s_cpu.items() if k.type == 'lane']
        niter, restart, dts = (_entries(s_card, kind) for kind in ('niter', 'restart', 'dt'))
        same = niter == _entries(s_cpu, 'niter') and restart == _entries(s_cpu, 'restart') and len(dts) == len(_entries(s_cpu, 'dt'))
        if lanes != ['fused_adaptive'] * 2 or not same or programs != 1:
            raise AssertionError(f'adaptive parity: {name}: lanes {lanes}, niter {niter} / restart {restart} on the card, '
                                 f'{_entries(s_cpu, "niter")} / {_entries(s_cpu, "restart")} on the CPU')
        dt_gap = max(abs(a - b) / b for a, b in zip(dts, _entries(s_cpu, 'dt')))
        diff = (u_card - u_cpu).abs().max().item()
        dt_tol = ADAPTIVE_PARITY_DT_TOL_AC if name.startswith('Allen-Cahn') else ADAPTIVE_PARITY_TOL
        if not dt_gap <= dt_tol or not diff <= ADAPTIVE_PARITY_TOL or sum(restart) < 1:
            raise AssertionError(f'adaptive parity: {name}: dt gap {dt_gap:.3e}, uend diff {diff:.3e}, restarts {sum(restart)}')
        print(f'adaptive parity: {name}, fp64, adaptive fused lane on card and CPU: {len(niter)} steps, niter all '
              f'{niter[0]}, {sum(restart)} restarted steps, {len(set(dts))} distinct dt, equal niter and restart, dt within '
              f'{dt_gap:.3e} <= {dt_tol}, uend within {diff:.3e} <= {ADAPTIVE_PARITY_TOL}; Newton in device loops [1 program]')


def phase_adaptive_times(runs, card):
    """Each adaptive march by lane: the adaptive fused lane (replayed graphs) and the block controller's stage lane."""
    for label, (ctrl, stage, Tend) in runs.items():
        u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
        (_, stats), fused_ms = _timed_block(lambda: ctrl.run(u0, 0.0, Tend), f'adaptive march {label}, adaptive fused lane',
                                            card, reads=lambda: ctrl.host_reads, top=8 if label.startswith('HeatND 256') else 0)
        blocks = ctrl.host_reads['fetch']
        _, stage_ms = _timed_block(lambda: stage.run(u0, 0.0, Tend, lane='stage'),
                                   f'adaptive march {label}, stage lane of the block controller', card)
        prog = next(iter(ctrl._fused_adaptive_fn._programs.values()))
        prog.run('start')
        pieces = {name: _event_ms(lambda i: prog.run(name), 5, warmup=1) for name in ('start', 'check', 'work')}
        replayed = pieces['start'] + MAXITER_AD * (pieces['check'] + pieces['work']) + pieces['check']
        print(f'times: adaptive march {label}: {blocks} blocks of {P_AD} steps ({len(_entries(stats, "niter"))} steps), '
              f'{fused_ms / blocks:.3f} ms a block on the adaptive fused lane against {stage_ms / blocks:.3f} ms on the stage '
              f'lane; by graph, ms a replay: ' + ', '.join(f'{name} {ms:.3f}' for name, ms in pieces.items())
              + f'; a block replays start, {MAXITER_AD} x (check, work), check = {replayed:.3f} ms [{card}]')


# -- the Newton-Krylov slice ---------------------------------------------------------------------------------------
def _implicit_description(n, dtype, device, **problem):
    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND

    return dict(
        problem_class=AllenCahnPeriodicND,
        problem_params=dict(nvars=(n, n), eps=0.04, radius=0.25, newton_tol=NEWTON_TOL_FI, dtype=dtype, device=device,
                            **problem),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=M_FI, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT_FI, restol=RESTOL_FI),
        step_params=dict(maxiter=MAXITER_FI),
    )


def _loop_steps(k, maxiter, R):
    """Iterations a masked loop computes for a count of ``k``: up to the next read, at most ``maxiter``."""
    return min(maxiter, R * math.ceil(k / R))


def _newton_budget(trace, R):
    """(operator applies, host reads) that the Newton solves of ``trace`` make with ``READ_EVERY = R``: per solve
    ``G(u0)``, then per Newton step computed ``G(u)``, ``J(x0)``, one a PCG step computed and ``G`` of the update;
    a loop of ``k`` iterations reads ``ceil(k / R) + 1`` times, a masked Newton step's PCG once."""
    applies = reads = 0
    for k_newton, pcg in trace:
        masked = _loop_steps(k_newton, NEWTON_MAXITER_FI, R) - k_newton
        applies += 1 + sum(3 + _loop_steps(k, LIN_MAXITER_FI, R) for k in pcg) + 3 * masked
        reads += math.ceil(k_newton / R) + 1 + sum(math.ceil(k / R) + 1 for k in pcg) + masked
    return applies, reads


def _implicit_k1_cases():
    """(name, taps, shapes): what the Newton-Krylov paths give K1 (the fused lane's block of P_FI steps, its node
    stacks and one field of the serial chain; the main path's field and node stack; HeatND's CG / GMRES runs)."""
    import torch

    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND
    from pysdc_tpu_torch.models.heat import HeatND

    def taps(cls, n, **kw):
        return cls(nvars=(n, n), dtype=torch.float64, device='cuda', **kw).A._cross_terms

    n, m = N_FI_SMALL, M_FI
    return [
        (f'implicit allen-cahn {N_FI}', taps(AllenCahnPeriodicND, N_FI, eps=0.04), [(N_FI, N_FI), (m, N_FI, N_FI)]),
        (f'implicit allen-cahn {n}', taps(AllenCahnPeriodicND, n, eps=0.04),
         [(n, n), (m, n, n), (P_FI, n, n), (m, P_FI, n, n)]),
        (f'krylov heat {N_KRYLOV}', taps(HeatND, N_KRYLOV, nu=0.1, freq=2, bc='periodic'),
         [(N_KRYLOV, N_KRYLOV), (m, N_KRYLOV, N_KRYLOV)]),
        (f'krylov heat {N_KRYLOV_PARITY}', taps(HeatND, N_KRYLOV_PARITY, nu=0.1, freq=2, bc='periodic'),
         [(N_KRYLOV_PARITY, N_KRYLOV_PARITY), (m, N_KRYLOV_PARITY, N_KRYLOV_PARITY)]),
        (f'krylov fused heat {KRYLOV_FUSED_N}', taps(HeatND, KRYLOV_FUSED_N, nu=0.1, freq=2, bc='periodic'),
         [(KRYLOV_FUSED_N, KRYLOV_FUSED_N), (P_FI, KRYLOV_FUSED_N, KRYLOV_FUSED_N),
          (m, P_FI, KRYLOV_FUSED_N, KRYLOV_FUSED_N)]),
    ]


def phase_implicit_kernels():
    """K1 against its plain version at the Newton-Krylov paths' shapes and taps, float32 and float64, on the bands
    path the wrapper picks and with the general path forced.  Returns name -> (taps, shapes covered)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import choose_path

    gen = torch.Generator(device='cuda').manual_seed(2718)
    covered = {}
    for name, terms, shapes in _implicit_k1_cases():
        covered[name] = (terms, set(shapes))
        for dtype in (torch.float32, torch.float64):
            tol = _stencil_tolerance(terms, dtype)
            itemsize = torch.empty((), dtype=dtype).element_size()
            worst, worst_abs = 0.0, 0.0
            for shape in shapes:
                if choose_path(shape, terms, itemsize) != 'bands':
                    raise AssertionError(f'K1 {name} {dtype} {shape}: the wrapper does not pick the bands path')
                u = torch.rand(shape, generator=gen, device='cuda', dtype=dtype)  # a phase field lies in [0, 1]
                err, rel = _k1_both_paths(name, terms, u, 'bands', tol)
                worst, worst_abs = max(worst, rel), max(worst_abs, err)
            print(f'implicit kernels: K1 {name:24s} {str(dtype):13s} max rel err {worst:.3e} <= tol {tol:.3e} (max abs '
                  f'{worst_abs:.3e} on bands), on bands and with the general path forced, at {shapes}')
    return covered


def _covered_by(covered, terms, shapes, label):
    names = [name for name, (t, _) in covered.items() if t == terms]
    checked = set().union(*(covered[name][1] for name in names)) if names else set()
    if not names or not shapes <= checked:
        raise AssertionError(f'{label}: K1 ran at shapes {sorted(shapes)} or taps the kernel check did not cover '
                             f'({sorted(checked)} under {names})')


def _implicit_run(desc, plain=False):
    """The fully implicit description through ``ControllerNonMPI(1, ...)`` from the initial circle, every operator
    apply counted with its shape.  Returns a namespace of what the gates read."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas()
    prob.solver_trace = []
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    launches0, paths0 = cross_stencil_2d.launches, dict(cross_stencil_2d.paths)
    start = time.perf_counter()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, STEPS_FI * DT_FI)
    if uend.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return SimpleNamespace(
        ctrl=ctrl, prob=prob, uend=uend, wall=wall, shapes=shapes, applies=applies[0], trace=list(prob.solver_trace),
        niter=[v for _, v in get_sorted(stats, type='niter', sortby='time')],
        residuals=[v for _, v in get_sorted(stats, type='residual_post_step', sortby='time')],
        launches=cross_stencil_2d.launches - launches0,
        paths={k: v - paths0[k] for k, v in cross_stencil_2d.paths.items()},
    )


def phase_implicit(card, covered):
    """The slice's main path at full width: the fully implicit Allen-Cahn problem at 1024^2, float64, through
    ``ControllerNonMPI``, with K1 and through the plain apply.  Returns (the K1 run, K1 launches)."""
    import torch

    from pysdc_tpu_torch.ops import loops

    R = loops.READ_EVERY
    desc = _implicit_description(N_FI, torch.float64, 'cuda')
    run = _implicit_run(desc)
    prob, niter, trace = run.prob, run.niter, run.trace
    label = f'implicit: AllenCahnPeriodicND {N_FI}^2 fp64 eps 0.04, newton_tol {NEWTON_TOL_FI:g}, GenericImplicit ' \
            f'M={M_FI} LU, dt {DT_FI:g}, restol {RESTOL_FI:g}, {STEPS_FI} steps'
    if len(niter) != STEPS_FI or not all(0 < k < MAXITER_FI for k in niter) \
            or not all(r <= RESTOL_FI for r in run.residuals):
        raise AssertionError(f'{label}: niter {niter}, final residuals {run.residuals} against restol {RESTOL_FI}')
    if len(trace) != M_FI * sum(niter) or not all(k < NEWTON_MAXITER_FI for k, _ in trace) \
            or not all(1 <= k < LIN_MAXITER_FI for _, pcg in trace for k in pcg):
        raise AssertionError(f'{label}: Newton solves {len(trace)} for niter {niter}, or a solve that did not reach '
                             f'newton_tol / lin_tol: {trace}')
    applies, reads = _newton_budget(trace, R)
    evals = sum(2 + M_FI * k for k in niter)  # per step f(u0) and one batched f over the spread nodes, then M a sweep
    if prob.solver_applies != applies or run.launches != evals + applies or run.applies != run.launches:
        raise AssertionError(f'{label}: K1 launches {run.launches}, operator applies {run.applies}, expected {evals} '
                             f'eval_f + {applies} in the Newton solves (the solves counted {prob.solver_applies})')
    if run.paths != {'bands': run.launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches by path {run.paths}, expected all on bands')
    _covered_by(covered, prob.A._cross_terms, run.shapes, label)
    if prob.host_reads != reads:
        raise AssertionError(f'{label}: host reads {prob.host_reads}, expected {reads} = ceil(k / {R}) + 1 a loop')
    if run.uend.shape != (N_FI, N_FI) or run.uend.dtype != torch.float64 or not bool(torch.isfinite(run.uend).all()):
        raise AssertionError(f'{label}: uend is not a finite float64 field of the grid shape')

    plain = _implicit_run(desc, plain=True)
    diff = (run.uend - plain.uend).abs().max().item()
    if plain.launches != 0 or plain.niter != niter or plain.trace != trace or not diff <= FI_PLAIN_BOUND:
        raise AssertionError(f'{label}: against the plain apply: niter {plain.niter}, traces equal {plain.trace == trace}, '
                             f'|uend - uend_plain| {diff:.3e}, K1 launches {plain.launches}')
    pcg = [k for _, ks in trace for k in ks]
    per_pcg = [math.ceil(k / R) + 1 for k in pcg]
    print(f'{label}: niter {niter}, final residuals {[float(f"{r:.3e}") for r in run.residuals]} <= {RESTOL_FI:g}; '
          f'{len(trace)} Newton solves, Newton iterations per solve {sorted(set(k for k, _ in trace))} (all to newton_tol), '
          f'PCG iterations per Newton step {min(pcg)}-{max(pcg)} (mean {sum(pcg) / len(pcg):.2f}); K1 launches '
          f'{run.launches} = {evals} eval_f + {applies} in the solves (1 + sum(3 + PCG steps computed) a solve, with '
          f'READ_EVERY {R}), all on bands at {sorted(run.shapes)}; host reads {prob.host_reads} = ceil(k/{R}) + 1 a '
          f'loop ({prob.host_reads / sum(niter):.1f} a sweep; a PCG solve {min(per_pcg)}-{max(per_pcg)} reads for '
          f'{min(pcg)}-{max(pcg)} iterations); through the plain apply: niter and every trace '
          f'equal, |uend - uend_plain_apply| {diff:.3e} <= {FI_PLAIN_BOUND}; wall {run.wall:.3f} s (K1) / '
          f'{plain.wall:.3f} s (plain) [{card}]')
    print(f'implicit: Newton and PCG iterations per solve, the first 12 solves: {trace[:12]}')
    return run, run.launches


def phase_implicit_parity():
    """Float64, the fully implicit path at 128^2 on the card against the CPU: equal niter and traces."""
    import torch

    card, cpu = (_implicit_run(_implicit_description(N_FI_SMALL, torch.float64, device)) for device in ('cuda', 'cpu'))
    diff = (card.uend.cpu() - cpu.uend).abs().max().item()
    if card.niter != cpu.niter or card.trace != cpu.trace or not diff <= PARITY_UEND_TOL:
        raise AssertionError(f'implicit parity: niter card {card.niter} cpu {cpu.niter}, traces equal '
                             f'{card.trace == cpu.trace}, uend diff {diff:.3e}')
    print(f'implicit parity: AllenCahnPeriodicND {N_FI_SMALL}^2 fp64, {STEPS_FI} steps: niter {card.niter} and all '
          f'{len(card.trace)} Newton / PCG traces equal on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


@_counting_launches
def phase_implicit_fused(card, covered):
    """The fully implicit path through ``ShardedController(4).run``: ``'auto'`` must take the fused lane (Newton
    and PCG captured as device ``while`` loops, the PCG node inside the Newton node's body, both run to tolerance)
    and agree with the stage lane.  Returns the K1 launches of the wrapper in the first run (warm-up and capture)."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _implicit_description(N_FI_SMALL, torch.float64, 'cuda')
    ctrl = ShardedController(P_FI, {'logger_level': 30}, desc)
    stage = ShardedController(P_FI, {'logger_level': 30}, desc)
    k1_count = _LAUNCH_COUNTS['k1']
    prob = ctrl.MS[0].levels[0].prob
    u0, Tend = prob.u_exact(0.0), STEPS_FI * DT_FI
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, stats = ctrl.run(u0, 0.0, Tend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, by_path, reads = cross_stencil_2d.launches, dict(cross_stencil_2d.paths), dict(ctrl.host_reads)
    sprob = stage.MS[0].levels[0].prob
    sprob.solver_trace = []
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    trace = list(sprob.solver_trace)
    label = f'implicit fused: ShardedController({P_FI}) AllenCahnPeriodicND {N_FI_SMALL}^2 fp64, one block'
    lane = [v for k, v in stats.items() if k.type == 'lane']
    niter, niter_s = _niter(stats), _niter(stats_s)
    diff = (uend - uend_s).abs().max().item()
    newton = [k for k, _ in trace]
    if lane != ['fused'] or niter != niter_s or len(niter) != STEPS_FI or not diff <= FI_FUSED_BOUND \
            or not newton or max(newton) >= NEWTON_MAXITER_FI:
        raise AssertionError(f'{label}: lane {lane}, niter {niter} against the stage lane\'s {niter_s}, |uend_fused - '
                             f'uend_stage| {diff:.3e}, Newton iterations of the stage lane\'s solves {sorted(set(newton))}')
    if launches < 1 or launches != sum(applies.values()) or by_path != {'bands': launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches {launches} by path {by_path}, operator applies {applies}')
    _covered_by(covered, prob.A._cross_terms, shapes, label)
    if reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'{label}: host reads {reads}')
    # a replayed block, and the K1 kernels it runs (the stage lane's applies of the same block)
    cross_stencil_2d.launches = 0
    k1_count.zero_()
    start = time.perf_counter()
    uend2, stats2 = ctrl.run_fused(u0, 0.0, Tend)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - start
    replay_k1 = int(k1_count)
    if cross_stencil_2d.launches != 0 or _niter(stats2) != niter or not torch.equal(uend2, uend):
        raise AssertionError(f'{label}: a replayed block passed the wrapper {cross_stencil_2d.launches} times or '
                             f'differs from the first')
    counted = _count_applies(stage, set())
    k1_count.zero_()
    stage.run(u0, 0.0, Tend, lane='stage')
    stage_applies, stage_k1 = sum(counted.values()), int(k1_count)
    if replay_k1 != stage_applies or stage_k1 != stage_applies:
        raise AssertionError(f'{label}: K1 in a replayed block {replay_k1} (counted on the card at each launch) '
                             f'against the stage lane\'s {stage_applies} applies, of which its count saw {stage_k1}')
    print(f'{label}: lane {lane[0]}, niter {niter} = the stage lane\'s, |uend_fused - uend_stage| {diff:.3e} <= '
          f'{FI_FUSED_BOUND}; Newton and PCG run to tolerance inside the graphs (the stage lane\'s {len(trace)} solves '
          f'took {min(newton)}-{max(newton)} Newton iterations of {min(k for _, p in trace for k in p)}-'
          f'{max(k for _, p in trace for k in p)} PCG iterations); K1 through the wrapper {launches} (warm-up and '
          f'capture; = applies) at {sorted(shapes)}, all on bands; a replayed block passes the wrapper 0 times, runs '
          f'{replay_k1} K1 kernels (counted on the card at each launch: the profiler misses the PCG node inside the Newton '
          f'node) = the stage lane\'s applies, and equals the first bit for bit; host '
          f'reads {reads}; wall {wall:.3f} s incl. capture, {replay_s:.3f} s a replayed block (the capture this '
          f'replaced unrolled 8 Newton x {LIN_MAXITER_FI} PCG iterations a solve: 0.920-1.012 s a block on an H100 '
          f'80GB HBM3 at 700 W) [{card}]')
    return launches


def _krylov_description(n, device, solver_type):
    import torch

    desc = _heat_description(n, torch.float64, device, restol=KRYLOV_RESTOL, maxiter=20)
    desc['problem_params'] = dict(desc['problem_params'], solver_type=solver_type, lintol=KRYLOV_LINTOL)
    desc['sweeper_params'] = dict(desc['sweeper_params'], num_nodes=M_FI)
    return desc


def _krylov_run(n, device, solver_type):
    from pysdc_tpu_torch import ControllerNonMPI, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, _krylov_description(n, device, solver_type))
    prob = ctrl.MS[0].levels[0].prob
    prob.A.krylov_trace = []
    launches = cross_stencil_2d.launches
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, KRYLOV_STEPS * DT)
    return SimpleNamespace(uend=uend.cpu(), niter=[v for _, v in get_sorted(stats, type='niter', sortby='time')],
                           trace=list(prob.A.krylov_trace), reads=prob.A.host_reads,
                           launches=cross_stencil_2d.launches - launches, prob=prob)


def _spectral_cases(device):
    """name -> (problem class, params, dt, steps): each spectral model at N_SPECTRAL^2 (1D: N_SPECTRAL points)."""
    import torch

    from pysdc_tpu_torch import models

    n2 = (N_SPECTRAL, N_SPECTRAL)
    f64 = dict(dtype=torch.float64, device=device)
    return {
        'AdvectionDiffusion1D': (models.AdvectionDiffusion1D, dict(nvars=N_SPECTRAL, **f64), 0.01, 3),
        'Brusselator': (models.Brusselator, dict(nvars=n2, **f64), 0.01, 2),
        'GrayScott': (models.GrayScott, dict(nvars=n2, num_blobs=3, **f64), 1.0, 2),
        'GrayScottLinearIMEX': (models.GrayScottLinearIMEX, dict(nvars=n2, **f64), 1.0, 2),
        'NonlinearSchroedinger': (models.NonlinearSchroedinger, dict(nvars=n2, dtype=torch.complex128, device=device),
                                  0.01, 2),
        'AllenCahnSpectralND': (models.AllenCahnSpectralND, dict(nvars=n2, eps=0.04, dw=-0.5, **f64), 1e-4, 2),
        'AllenCahnSpectralND circle_rand': (models.AllenCahnSpectralND, dict(nvars=n2, eps=0.1, L=2.0,
                                                                            init_type='circle_rand', **f64), 1e-3, 2),
        'AllenCahnSpectralTimeForcing': (models.AllenCahnSpectralTimeForcing, dict(nvars=n2, eps=0.04, **f64), 1e-4, 2),
        'AllenCahn2DSpectral': (models.AllenCahn2DSpectral, dict(nvars=n2, eps=0.04, **f64), 1e-4, 2),
        'AllenCahn2DSpectralStab': (models.AllenCahn2DSpectralStab, dict(nvars=n2, eps=0.04, **f64), 1e-4, 2),
        'AllenCahnTempSpectralND': (models.AllenCahnTempSpectralND, dict(nvars=n2, eps=0.04, dw=-0.5, **f64), 1e-4, 2),
    }


def phase_krylov_spectral(card, covered):
    """CG and GMRES (HeatND 512^2 float64, lintol 1e-10) against the direct solve on the card and, at 128^2,
    against the CPU (equal counts a solve); each spectral model at 64^2 on the card against the CPU.  Returns the
    K1 launches of the CG and GMRES runs at 512^2."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, IMEXSweeper, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    direct = _krylov_run(N_KRYLOV, 'cuda', 'direct')
    launches = 0
    for kind in ('CG', 'GMRES'):
        paths0 = dict(cross_stencil_2d.paths)
        run = _krylov_run(N_KRYLOV, 'cuda', kind)
        diff = (run.uend - direct.uend).abs().max().item()
        n_solves = M_FI * sum(run.niter)
        if run.niter != direct.niter or len(run.trace) != n_solves or not diff <= KRYLOV_DIRECT_BOUND:
            raise AssertionError(f'krylov: HeatND {N_KRYLOV}^2 {kind}: niter {run.niter} against the direct solve\'s '
                                 f'{direct.niter}, {len(run.trace)} solves, |uend - uend_direct| {diff:.3e}')
        # per step f(u0) and the spread, M a sweep; per solve one apply for r0 and one a step computed
        iters = [k for _, k, _ in run.trace]
        by_path = {k: v - paths0[k] for k, v in cross_stencil_2d.paths.items()}
        if by_path != {'bands': run.launches, 'general': 0} or run.launches < n_solves:
            raise AssertionError(f'krylov: {kind}: K1 launches {run.launches} by path {by_path}')
        _covered_by(covered, run.prob.A._cross_terms, {(N_KRYLOV, N_KRYLOV), (M_FI, N_KRYLOV, N_KRYLOV)}, 'krylov')
        # a converged sweep starts each solve from a node value that already meets lintol to roundoff: whether
        # that solve takes 0 or 1 iterations is the card's or the CPU's rounding, so counts are reported, not held
        on_card, on_cpu = (_krylov_run(N_KRYLOV_PARITY, device, kind) for device in ('cuda', 'cpu'))
        pdiff = (on_card.uend - on_cpu.uend).abs().max().item()
        differ = sum(a != b for a, b in zip(on_card.trace, on_cpu.trace))
        if on_card.niter != on_cpu.niter or len(on_card.trace) != len(on_cpu.trace) or not pdiff <= KRYLOV_DIRECT_BOUND:
            raise AssertionError(f'krylov: {kind} {N_KRYLOV_PARITY}^2 card against CPU: niter {on_card.niter} / '
                                 f'{on_cpu.niter}, uend diff {pdiff:.3e}')
        launches += run.launches
        detail = (f'restarts a solve {min(iters)}-{max(iters)}, Arnoldi steps a restart '
                  f'{sorted(set(a for _, _, ar in run.trace for a in ar))}' if kind == 'GMRES'
                  else f'CG iterations a solve {min(iters)}-{max(iters)}')
        print(f'krylov: HeatND {N_KRYLOV}^2 periodic fp64 solver_type={kind!r} lintol {KRYLOV_LINTOL:g}, M={M_FI} LU, '
              f'{KRYLOV_STEPS} steps, restol {KRYLOV_RESTOL:g}: niter {run.niter} = the direct solve\'s, |uend - '
              f'uend_direct| {diff:.3e} <= {KRYLOV_DIRECT_BOUND}; {n_solves} solves, {detail}; host reads {run.reads}; '
              f'K1 launches {run.launches}, all on bands; at {N_KRYLOV_PARITY}^2 card against CPU: niter '
              f'{on_card.niter} equal, {differ} of {len(on_card.trace)} solves with other counts, uend diff {pdiff:.3e} '
              f'<= {KRYLOV_DIRECT_BOUND} [{card}]')

    for name, (cls, params, dt, steps) in _spectral_cases('cuda').items():
        out = []
        for device in ('cuda', 'cpu'):
            desc = dict(problem_class=cls, problem_params=dict(params, device=device), sweeper_class=IMEXSweeper,
                        sweeper_params=dict(num_nodes=M_FI, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
                        level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=20))
            ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
            prob = ctrl.MS[0].levels[0].prob
            u0 = prob.u_exact(0.0)
            uend, stats = ctrl.run(u0, 0.0, steps * dt)
            out.append((u0.cpu(), uend.cpu(), [v for _, v in get_sorted(stats, type='niter', sortby='time')]))
        (u0_card, u_card, it_card), (u0_cpu, u_cpu, it_cpu) = out
        scale = max(1.0, u_cpu.abs().max().item())
        diff = (u_card - u_cpu).abs().max().item()
        moved = (u_cpu - u0_cpu).abs().max().item()
        if it_card != it_cpu or not max(it_card) < 20 or not diff <= PARITY_UEND_TOL * scale or not moved > 1e-8 \
                or u_card.dtype != params['dtype']:
            raise AssertionError(f'spectral: {name}: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}, moved {moved:.3e}')
        print(f'spectral: {name} {tuple(u_card.shape)} {u_card.dtype}, IMEX M={M_FI} LU/EE, dt {dt:g}, {steps} steps: niter '
              f'{it_card} on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL * scale:.1e}')

    # the multi-implicit Gray-Scott problems (their sweeper is ROADMAP item 12): the pointwise Newton on the card
    from pysdc_tpu_torch import models

    for cls in (models.GrayScottMultiImplicit, models.GrayScottMultiImplicitLinear):
        got = []
        for device in ('cuda', 'cpu'):
            prob = cls(nvars=(N_SPECTRAL, N_SPECTRAL), newton_tol=1e-12, dtype=torch.float64, device=device)
            u = prob.u_exact(0.0)
            prob.newton_trace = []
            got.append((prob.solve_system_2(u, 0.5, u, 0.0).cpu(), prob.newton_trace))
        (x_card, it_card), (x_cpu, it_cpu) = got
        diff = (x_card - x_cpu).abs().max().item()
        if it_card != it_cpu or not diff <= PARITY_UEND_TOL:
            raise AssertionError(f'spectral: {cls.__name__}.solve_system_2: Newton {it_card} / {it_cpu}, diff {diff:.3e}')
        print(f'spectral: {cls.__name__} {N_SPECTRAL}^2 fp64 solve_system_2 (pointwise Newton): {it_card} '
              f'iterations on card and CPU, diff {diff:.3e} <= {PARITY_UEND_TOL}')
    return launches


def _kernel_split(fn, products=False):
    """ms the card spent over one call of ``fn()`` by kind of kernel (profiler): K1, cuFFT, with ``products`` the
    dense products (cuBLAS GEMM / GEMV kernels), the rest (elementwise passes, reductions, copies), and the number
    of kernels."""
    def device_us(e):
        return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0.0)

    split = {'K1': 0.0, 'cuFFT': 0.0, 'other': 0.0}
    if products:
        split['products'] = 0.0
    n = 0
    for e in _profiled(fn):
        key = e.key.lower()
        kind = 'K1' if 'cross_stencil' in key else 'cuFFT' if 'fft' in key else 'other'
        if products and kind == 'other' and any(w in key for w in ('gemm', 'gemv', 'cutlass', 'xmma', 'dot_kernel')):
            kind = 'products'
        split[kind] += device_us(e) / 1e3
        n += e.count
    if not sum(split.values()) > 0:
        raise AssertionError('times: the profiler saw no device time')
    return split, n


def _read_every_pairs(fn, counters, pairs=10):
    """``fn()`` timed with ``READ_EVERY`` at its value (1) and at 2, in ``pairs`` pairs of alternating order (CUDA
    events and the host clock, ms a call, 3 calls a sample after one untimed).  ``counters()`` gives two counts so
    far (host reads, and the work the loops computed).  Returns R -> (card ms, host ms, reads a call, work a call)
    per sample, and the module value's wins."""
    from pysdc_tpu_torch.ops import loops

    chosen = loops.READ_EVERY
    other = 2 if chosen == 1 else 1
    samples = {chosen: [], other: []}
    wins = 0
    try:
        for p in range(pairs):
            pair = {}
            for R in ((chosen, other) if p % 2 == 0 else (other, chosen)):
                loops.READ_EVERY = R
                before = counters()
                ms, host_ms = _event_ms(lambda i: fn(), 3, warmup=1, host=True)
                after = counters()
                pair[R] = ms
                samples[R].append((ms, host_ms) + tuple((a - b) / 4 for a, b in zip(after, before)))
            wins += pair[chosen] < pair[other]
    finally:
        loops.READ_EVERY = chosen
    return samples, wins


def _median(xs):
    xs = sorted(xs)
    return 0.5 * (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2])


def _pairs_line(label, samples, wins, card, counted):
    from pysdc_tpu_torch.ops import loops

    parts = []
    for R, rows in samples.items():
        card_ms, host_ms = [r[0] for r in rows], [r[1] for r in rows]
        parts.append(f'READ_EVERY {R}: median {_median(card_ms):.3f} ms on the card ({min(card_ms):.3f}-{max(card_ms):.3f}), '
                     f'{_median(host_ms):.3f} ms host clock, {rows[0][2]:.1f} host reads and {rows[0][3]:.1f} '
                     f'{counted} a call')
    pairs = len(samples[loops.READ_EVERY])
    print(f'times: {label}, {pairs} pairs in alternating order: ' + '; '.join(parts)
          + f'; READ_EVERY {loops.READ_EVERY} faster in {wins} of {pairs} pairs [{card}]')


def _function_route_line(sweep, prob, card, pairs=10):
    """The host cost of routing K1 through ``stencil._CrossStencil`` where no gradient is asked: ``sweep()`` timed
    with every K1 call taking the bare launch (``cross_stencil_2d`` as it is) and with every call forced through the
    Function (``stencil.differentiated`` answering True), in ``pairs`` pairs of alternating order (CUDA events and
    the host clock, 3 calls a sample after one untimed); then one apply on ``prob``'s grid both ways, host ms a
    call over 200 calls."""
    import torch

    from pysdc_tpu_torch.ops.kernels import stencil

    plain_test = stencil.differentiated
    samples = {'bare': [], 'Function': []}
    wins = 0
    try:
        for p in range(pairs):
            pair = {}
            for route in (('bare', 'Function') if p % 2 == 0 else ('Function', 'bare')):
                stencil.differentiated = plain_test if route == 'bare' else (lambda u: True)
                pair[route] = _event_ms(lambda i: sweep(), 3, warmup=1, host=True)
                samples[route].append(pair[route])
            wins += pair['bare'][1] < pair['Function'][1]
    finally:
        stencil.differentiated = plain_test
    u = torch.randn(prob.shape, dtype=prob.dtype, device='cuda')
    terms = prob.A._cross_terms
    one = {'bare': _event_ms(lambda i: stencil._launch(u, terms, None), 200, warmup=20, host=True),
           'Function': _event_ms(lambda i: stencil._CrossStencil.apply(u, terms, None, stencil._launch), 200,
                                 warmup=20, host=True)}
    parts = [f'{route}: median {_median([c for c, _ in rows]):.3f} ms on the card, '
             f'{_median([h for _, h in rows]):.3f} ms host clock ({min(h for _, h in rows):.3f}-'
             f'{max(h for _, h in rows):.3f}); one apply {one[route][0]:.4f} ms on the card, {one[route][1]:.4f} ms '
             f'host' for route, rows in samples.items()]
    print(f'times: implicit sweep {tuple(prob.shape)} fp64, K1 bare against through its autograd.Function, {pairs} '
          f'pairs in alternating order: ' + '; '.join(parts) + f'; bare faster on the host clock in {wins} of '
          f'{pairs} pairs [{card}]')


def phase_implicit_times(implicit, sparse_ctrl, card):
    """One sweep of the main path at 1024^2 from the spread state (the first sweep of a step: Newton from the
    initial value) by kind of work; the sweep at 1024^2 and at 128^2 and the 1024^2 sparse sweep (from its spread
    state: PCG iterates) with READ_EVERY at 1 (the module's value) and at 2, in pairs."""
    import torch

    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND
    from pysdc_tpu_torch.ops import loops

    lvl = implicit.ctrl.MS[0].levels[0]
    prob, sweep = lvl.prob, lvl.sweep
    state0 = sweep.predict(prob, prob.u_exact(0.0), 0.0, DT_FI)

    def one_sweep(prob=prob, sweep=sweep, state0=state0, dt=DT_FI):
        state = sweep.update_nodes(prob, state0, 0.0, dt, 0)
        return sweep.compute_residual(state, dt)[1]

    prob.solver_trace = []
    one_sweep()
    trace = list(prob.solver_trace)
    prob.solver_trace = None
    card_ms, host_ms = _event_ms(lambda i: one_sweep(), 3, warmup=0, host=True)
    split, n_kernels = _kernel_split(one_sweep)
    pcg = [k for _, ks in trace for k in ks]
    steps = sum(_loop_steps(k, LIN_MAXITER_FI, loops.READ_EVERY) + 1 for k in pcg)  # PCG iterations and setups
    print(f'times: implicit sweep {N_FI}^2 fp64 M={M_FI} LU from the spread state: {card_ms:.3f} ms on the card, '
          f'{host_ms:.3f} ms host clock; Newton iterations per solve {[k for k, _ in trace]}, PCG iterations {pcg}; '
          f'by kind (profiler): K1 {split["K1"]:.3f} ms, cuFFT {split["cuFFT"]:.3f} ms, elementwise / reductions / '
          f'copies {split["other"]:.3f} ms, {n_kernels} kernels (about {n_kernels / steps:.0f} a PCG iteration), the '
          f'card idle the rest, {card_ms - sum(split.values()):.3f} ms ({100 * (1 - sum(split.values()) / card_ms):.0f}%: '
          f'the host enqueues the kernels) [{card}]')
    samples, wins = _read_every_pairs(one_sweep, lambda: (prob.host_reads, prob.solver_applies))
    _pairs_line(f'implicit sweep {N_FI}^2 fp64', samples, wins, card, 'operator applies')

    small = AllenCahnPeriodicND(nvars=(N_FI_SMALL, N_FI_SMALL), eps=0.04, newton_tol=NEWTON_TOL_FI,
                                dtype=torch.float64, device='cuda')
    small_sweep = GenericImplicit(dict(num_nodes=M_FI, quad_type='RADAU-RIGHT', QI='LU'))
    small_state = small_sweep.predict(small, small.u_exact(0.0), 0.0, DT_FI)
    samples, wins = _read_every_pairs(lambda: one_sweep(small, small_sweep, small_state),
                                      lambda: (small.host_reads, small.solver_applies))
    _pairs_line(f'implicit sweep {N_FI_SMALL}^2 fp64', samples, wins, card, 'operator applies')
    _function_route_line(lambda: one_sweep(small, small_sweep, small_state), small, card)

    # the 1024^2 sparse sweep (PCG lane, float32) from its spread state, where the PCG solves iterate
    slvl = sparse_ctrl.MS[0].levels[0]
    sprob, ssweep = slvl.prob, slvl.sweep
    X, Y = sprob.grids
    sstate = ssweep.predict(sprob, torch.sin(math.pi * X) * torch.sin(math.pi * Y), 0.0, DT_SPARSE)
    A = sprob.A
    samples, wins = _read_every_pairs(lambda: one_sweep(sprob, ssweep, sstate, DT_SPARSE),
                                      lambda: (A.host_reads, A.pcg_steps))
    _pairs_line(f'sparse sweep {N_SPARSE}^2 fp32 from the spread state', samples, wins, card, 'PCG iterations computed')

# -- the first-order sweepers -----------------------------------------------------------------------------------------
def _multi_implicit_description(n, dtype, device):
    """The multi-implicit splitting of examples/step_20_allen_cahn_campaign.py:65 on the fully implicit path's
    problem and step (bench.py:899 at 1024^2)."""
    from pysdc_tpu_torch import MultiImplicitSweeper
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicMultiImplicitND

    return dict(_implicit_description(n, dtype, device), problem_class=AllenCahnPeriodicMultiImplicitND,
                sweeper_class=MultiImplicitSweeper,
                sweeper_params=dict(num_nodes=M_FI, quad_type='RADAU-RIGHT', Q1='LU', Q2='LU'))


def _pointwise_solves_converged(prob, trace, niter):
    """Every pointwise Newton solve (one a node and sweep) reached newton_tol, and its PCG steps their lin_tol."""
    return (len(trace) == M_FI * sum(niter) and all(k < prob.newton_maxiter for k, _ in trace)
            and all(k < LIN_MAXITER_FI for _, pcg in trace for k in pcg))


def phase_multi_implicit(card, covered):
    """The slice's main path at full width: the multi-implicit Allen-Cahn splitting at 1024^2, float64, through
    ``ControllerNonMPI``, with K1 (the counts set to 0 just before) and through the plain apply.  Returns
    (the K1 run, K1 launches)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _multi_implicit_description(N_FI, torch.float64, 'cuda')
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    run = _implicit_run(desc)
    launches = cross_stencil_2d.launches
    prob, niter, trace = run.prob, run.niter, run.trace
    label = f'multi-implicit: AllenCahnPeriodicMultiImplicitND {N_FI}^2 fp64 eps 0.04, newton_tol {NEWTON_TOL_FI:g}, ' \
            f'MultiImplicitSweeper M={M_FI} Q1=Q2=LU, dt {DT_FI:g}, restol {RESTOL_FI:g}, {STEPS_FI} steps'
    if len(niter) != STEPS_FI or not all(0 < k < MAXITER_FI for k in niter) \
            or not all(r <= RESTOL_FI for r in run.residuals):
        raise AssertionError(f'{label}: niter {niter}, final residuals {run.residuals} against restol {RESTOL_FI}')
    if not _pointwise_solves_converged(prob, trace, niter):
        raise AssertionError(f'{label}: {len(trace)} pointwise Newton solves for niter {niter}, or one that did not '
                             f'reach newton_tol: {trace}')
    evals = sum(2 + M_FI * k for k in niter)  # per step f(u0) and one batched f over the spread nodes, then M a sweep
    if launches != evals or run.applies != launches or run.launches != launches:
        raise AssertionError(f'{label}: K1 launches {launches}, operator applies {run.applies}, expected {evals} eval_f')
    if run.paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches by path {run.paths}, expected all on bands')
    _covered_by(covered, prob.A._cross_terms, run.shapes, label)
    if run.uend.shape != (N_FI, N_FI) or run.uend.dtype != torch.float64 or not bool(torch.isfinite(run.uend).all()):
        raise AssertionError(f'{label}: uend is not a finite float64 field of the grid shape')

    plain = _implicit_run(desc, plain=True)
    diff = (run.uend - plain.uend).abs().max().item()
    if plain.launches != 0 or plain.niter != niter or not diff <= MI_PLAIN_BOUND:
        raise AssertionError(f'{label}: against the plain apply: niter {plain.niter}, |uend - uend_plain| {diff:.3e}, '
                             f'K1 launches {plain.launches}')
    newton = [k for k, _ in trace]
    pcg = [k for _, ks in trace for k in ks]
    print(f'{label}: niter {niter}, final residuals {[float(f"{r:.3e}") for r in run.residuals]} <= {RESTOL_FI:g}; '
          f'{len(trace)} pointwise Newton solves of {min(newton)}-{max(newton)} iterations (all to newton_tol, flag '
          f'clear), PCG iterations a Newton step {min(pcg)}-{max(pcg)} (mean {sum(pcg) / len(pcg):.2f}); K1 launches '
          f'{launches} = {evals} eval_f applies, all on bands at {sorted(run.shapes)}; host reads {prob.host_reads} '
          f'({prob.host_reads / sum(niter):.1f} a sweep); through the plain apply: niter equal, traces equal '
          f'{plain.trace == trace}, |uend - uend_plain_apply| {diff:.3e} <= {MI_PLAIN_BOUND}; wall {run.wall:.3f} s '
          f'(K1) / {plain.wall:.3f} s (plain) [{card}]')
    return run, launches


def phase_multi_implicit_parity():
    """Float64, the multi-implicit path at 128^2 on the card against the CPU: equal niter, uend to 1e-11."""
    import torch

    card, cpu = (_implicit_run(_multi_implicit_description(N_FI_SMALL, torch.float64, device))
                 for device in ('cuda', 'cpu'))
    diff = (card.uend.cpu() - cpu.uend).abs().max().item()
    if card.niter != cpu.niter or not diff <= PARITY_UEND_TOL:
        raise AssertionError(f'multi-implicit parity: niter card {card.niter} cpu {cpu.niter}, uend diff {diff:.3e}')
    print(f'multi-implicit parity: AllenCahnPeriodicMultiImplicitND {N_FI_SMALL}^2 fp64, {STEPS_FI} steps: niter '
          f'{card.niter} on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL}; Newton / PCG traces equal '
          f'{card.trace == cpu.trace} ({len(card.trace)} solves)')


def phase_multi_implicit_fused(card, covered):
    """The multi-implicit path at 128^2 through ``ShardedController(4).run``: ``'auto'`` takes the fused lane, the
    lane the JAX package takes for it (the pointwise Newton and its PCG captured as device ``while`` loops),
    equal to the stage lane.  Returns the K1 launches of the wrapper in the first run (warm-up and capture)."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    desc = _multi_implicit_description(N_FI_SMALL, torch.float64, 'cuda')
    ctrl = ShardedController(P_FI, {'logger_level': 30}, desc)
    stage = ShardedController(P_FI, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    u0, Tend = prob.u_exact(0.0), STEPS_FI * DT_FI
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    start = time.perf_counter()
    uend, stats = ctrl.run(u0, 0.0, Tend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, by_path, reads = cross_stencil_2d.launches, dict(cross_stencil_2d.paths), dict(ctrl.host_reads)
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    label = f'multi-implicit fused: ShardedController({P_FI}) AllenCahnPeriodicMultiImplicitND {N_FI_SMALL}^2 fp64'
    lane = [v for k, v in stats.items() if k.type == 'lane']
    niter, niter_s = _niter(stats), _niter(stats_s)
    diff = (uend - uend_s).abs().max().item()
    if lane != ['fused'] or niter != niter_s or len(niter) != STEPS_FI or not diff <= MI_FUSED_BOUND:
        raise AssertionError(f'{label}: lane {lane}, niter {niter} against the stage lane\'s {niter_s}, |uend_fused - '
                             f'uend_stage| {diff:.3e}')
    if launches < 1 or launches != sum(applies.values()) or by_path != {'bands': launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches {launches} by path {by_path}, operator applies {applies}')
    _covered_by(covered, prob.A._cross_terms, shapes, label)
    cross_stencil_2d.launches = 0
    start = time.perf_counter()
    uend2, stats2 = ctrl.run_fused(u0, 0.0, Tend)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - start
    if cross_stencil_2d.launches != 0 or _niter(stats2) != niter or not torch.equal(uend2, uend):
        raise AssertionError(f'{label}: a replayed block passed the wrapper {cross_stencil_2d.launches} times or '
                             f'differs from the first')
    print(f'{label}: lane {lane[0]} (the JAX package\'s lane for it), niter {niter} = the stage lane\'s, |uend_fused - '
          f'uend_stage| {diff:.3e} <= {MI_FUSED_BOUND}, Newton in device loops; K1 through the wrapper {launches} (warm-up '
          f'and capture; = applies) at {sorted(shapes)}, all on bands; a replayed block passes the wrapper 0 times and '
          f'equals the first bit for bit; host reads {reads}; wall {wall:.3f} s incl. capture, {replay_s:.3f} s a '
          f'replayed block [{card}]')
    return launches


def _rk_description(tableau, n, dtype, device, forced=False, controllers=None, **level):
    from pysdc_tpu_torch.models.heat import HeatND, HeatNDForced
    from pysdc_tpu_torch.sweepers import runge_kutta

    return dict(problem_class=HeatNDForced if forced else HeatND,
                problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=dtype, device=device),
                sweeper_class=getattr(runge_kutta, tableau), sweeper_params={}, level_params=dict(dt=DT, **level),
                step_params=dict(maxiter=1), convergence_controllers=controllers or {})


def _rk_run(desc, Tend, plain=False):
    """The description through ``ControllerNonMPI(1, ...)`` from the exact solution, the K1 launches of the run and
    every operator apply counted with its shape."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas()
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    launches0, paths0 = cross_stencil_2d.launches, dict(cross_stencil_2d.paths)
    start = time.perf_counter()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    if uend.is_cuda:
        torch.cuda.synchronize()
    return SimpleNamespace(
        ctrl=ctrl, prob=prob, uend=uend, stats=stats, shapes=shapes, applies=applies[0],
        wall=time.perf_counter() - start, launches=cross_stencil_2d.launches - launches0,
        paths={k: v - paths0[k] for k, v in cross_stencil_2d.paths.items()},
        dts=[v for _, v in get_sorted(stats, type='dt', sortby='time')],
        restarts=sum(v for _, v in get_sorted(stats, type='restart')),
    )


def _rk_evals(sweep):
    """eval_f calls of one Runge-Kutta step: f(u0) in the predictor and each stage the sweep evaluates
    (runge_kutta.py: every stage but the last of a stiffly accurate tableau without an embedded pair)."""
    from pysdc_tpu_torch.sweepers.runge_kutta import RungeKuttaIMEX

    M = sweep.coll.num_nodes
    if isinstance(sweep, RungeKuttaIMEX):
        return 1 + M
    return 1 + sum(1 for m in range(M) if m < M - 1 or not sweep.coll.globally_stiffly_accurate or sweep.is_embedded())


def phase_rk(card):
    """Runge-Kutta on the main path's problem at full width: ESDIRK43 on HeatND 2048^2 float32 (4 steps) and
    ARK548L2SA on HeatNDForced 2048^2 float32 (2 steps) through ``ControllerNonMPI``.  K1 launches as the tableau
    implies, all on bands at the main path's shape and taps; against the plain apply; against u_exact: the float32
    run within the main path's bound, a float64 run on the card within twice the time error that a float64 CPU run
    at 256^2 measures.  Returns the K1 launches by run."""
    import torch

    main_taps = _fd_tables()['main']
    out = {}
    for tableau, forced, steps in (('ESDIRK43', False, RK_STEPS), ('ARK548L2SA', True, RK_IMEX_STEPS)):
        desc = _rk_description(tableau, N_MAIN, torch.float32, 'cuda', forced=forced)
        run = _rk_run(desc, steps * DT)
        label = f'rk: {tableau} on {type(run.prob).__name__} {N_MAIN}^2 fp32, dt {DT:g}, {steps} steps'
        per_step = _rk_evals(run.ctrl.MS[0].levels[0].sweep)
        if run.launches != steps * per_step or run.applies != run.launches or len(run.dts) != steps:
            raise AssertionError(f'{label}: K1 launches {run.launches}, applies {run.applies}, expected {steps} x '
                                 f'{per_step}; steps {len(run.dts)}')
        if run.paths != {'bands': run.launches, 'general': 0} or not run.shapes <= set(K1_SHAPES) \
                or run.prob.A._cross_terms != main_taps:
            raise AssertionError(f'{label}: K1 by path {run.paths} at {sorted(run.shapes)}')
        if run.uend.dtype != torch.float32 or not bool(torch.isfinite(run.uend).all()):
            raise AssertionError(f'{label}: uend is not a finite float32 field')
        plain = _rk_run(desc, steps * DT, plain=True)
        diff = (run.uend - plain.uend).abs().max().item()
        err = (run.uend - run.prob.u_exact(steps * DT)).abs().max().item()
        bound = UEND_PLAIN_BOUND
        sweep = run.ctrl.MS[0].levels[0].sweep
        if not sweep.coll.globally_stiffly_accurate or forced:
            # an end point that contracts the stages' f = A u carries their rounding, which A amplifies (its largest
            # row sum 8 nu / dx^2 = 3.4e6 at 2048^2 against float32's 1.2e-7): at most dt * sum|b| of it a step
            b = np.abs(np.atleast_2d(sweep.coll.weights)[0]).sum()
            rows = sum(abs(c) for coeff, _ in run.prob.A._cross_terms for c in coeff)
            floor = steps * DT * b * rows * torch.finfo(torch.float32).eps * run.prob.u_exact(0.0).abs().max().item()
            bound = max(bound, floor)
        if plain.launches != 0 or not diff <= bound or not err <= max(bound, UEND_EXACT_BOUND):
            raise AssertionError(f'{label}: |uend - uend_plain| {diff:.3e}, |uend - u_exact| {err:.3e}, bound {bound:.3e}')
        line = (f'{label}: K1 launches {run.launches} = {steps} x {per_step} (the predictor\'s f(u0) and the stages '
                f'the tableau evaluates), all on bands at {sorted(run.shapes)}; |uend - uend_plain_apply| {diff:.3e} <= '
                f'{bound:.3e}, |uend - u_exact| {err:.3e} <= {max(bound, UEND_EXACT_BOUND):.3e}'
                + (' (the float32 floor of an end point that contracts A u: steps dt sum|b| rowsum(A) eps max|u0|)'
                   if bound > UEND_PLAIN_BOUND else '') + f'; wall {run.wall:.3f} s (K1) / {plain.wall:.3f} s (plain)')
        if forced:
            # the same in float64 on the card: the plain apply to roundoff, u_exact to the space error
            big = _rk_run(_rk_description(tableau, N_MAIN, torch.float64, 'cuda', forced=True), steps * DT)
            big_plain = _rk_run(_rk_description(tableau, N_MAIN, torch.float64, 'cuda', forced=True), steps * DT,
                                plain=True)
            d64 = (big.uend - big_plain.uend).abs().max().item()
            e64 = (big.uend - big.prob.u_exact(steps * DT)).abs().max().item()
            if not d64 <= RK_FP64_PLAIN_BOUND or not e64 <= UEND_EXACT_BOUND:
                raise AssertionError(f'{label}: float64 |uend - uend_plain| {d64:.3e}, |uend - u_exact| {e64:.3e}')
            line += (f'; float64 on the card: |uend - uend_plain_apply| {d64:.3e} <= {RK_FP64_PLAIN_BOUND}, |uend - '
                     f'u_exact| {e64:.3e} <= {UEND_EXACT_BOUND}')
        else:
            # the time error alone: float64, where the discrete-eigenvalue u_exact leaves nothing else
            small = _rk_run(_rk_description(tableau, N_RK_PARITY, torch.float64, 'cpu'), steps * DT)
            time_err = (small.uend - small.prob.u_exact(steps * DT)).abs().max().item()
            big = _rk_run(_rk_description(tableau, N_MAIN, torch.float64, 'cuda'), steps * DT)
            err64 = (big.uend - big.prob.u_exact(steps * DT)).abs().max().item()
            if not 0 < err64 <= 2 * time_err:
                raise AssertionError(f'{label}: float64 |uend - u_exact| {err64:.3e} against 2 x the time error '
                                     f'{time_err:.3e} (float64 CPU, {N_RK_PARITY}^2)')
            line += (f'; float64 on the card {err64:.3e} <= 2 x {time_err:.3e}, the time error a float64 CPU run at '
                     f'{N_RK_PARITY}^2 measures')
        print(line + f' [{card}]')
        out[tableau] = run.launches
    return out


def _dahlquist_rk(tableau, device):
    """The tableau on Dahlquist (16 complex lambdas in the left half-plane, complex128; DahlquistIMEX for the IMEX
    pairs), 3 steps of 0.1: uend on the host."""
    from pysdc_tpu_torch import ControllerNonMPI
    from pysdc_tpu_torch.models.dahlquist import Dahlquist, DahlquistIMEX
    from pysdc_tpu_torch.sweepers import runge_kutta

    rng = np.random.default_rng(16)
    lam = rng.uniform(-4, 0, 16) + 1j * rng.uniform(-4, 4, 16)
    cls = getattr(runge_kutta, tableau)
    if issubclass(cls, runge_kutta.RungeKuttaIMEX):
        problem, params = DahlquistIMEX, dict(lambdas_implicit=lam, lambdas_explicit=0.25j * np.ones(16))
    else:
        problem, params = Dahlquist, dict(lambdas=lam)
    desc = dict(problem_class=problem, problem_params=dict(params, device=device), sweeper_class=cls,
                sweeper_params={}, level_params=dict(dt=0.1), step_params=dict(maxiter=1))
    ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
    uend, _ = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.3)
    return uend.cpu()


def phase_rk_parity():
    """Float64 card against CPU: ESDIRK43 on HeatND 256^2 (4 steps) to 1e-11, every tableau on Dahlquist to 1e-13."""
    import inspect

    import torch

    from pysdc_tpu_torch.sweepers import runge_kutta

    card, cpu = (_rk_run(_rk_description('ESDIRK43', N_RK_PARITY, torch.float64, device), RK_STEPS * DT)
                 for device in ('cuda', 'cpu'))
    diff = (card.uend.cpu() - cpu.uend).abs().max().item()
    if not diff <= PARITY_UEND_TOL:
        raise AssertionError(f'rk parity: ESDIRK43 HeatND {N_RK_PARITY}^2 uend diff {diff:.3e}')
    names = sorted(name for name, cls in vars(runge_kutta).items()
                   if inspect.isclass(cls) and issubclass(cls, runge_kutta.RungeKutta)
                   and cls.__module__ == runge_kutta.__name__
                   and cls not in (runge_kutta.RungeKutta, runge_kutta.RungeKuttaIMEX))
    worst = 0.0
    for name in names:
        got, want = _dahlquist_rk(name, 'cuda'), _dahlquist_rk(name, 'cpu')
        d = (got - want).abs().max().item()
        if got.dtype != torch.complex128 or not d <= RK_DAHLQUIST_TOL:
            raise AssertionError(f'rk parity: {name} on Dahlquist: card against CPU {d:.3e}, dtype {got.dtype}')
        worst = max(worst, d)
    print(f'rk parity: ESDIRK43 HeatND {N_RK_PARITY}^2 fp64, {RK_STEPS} steps: uend diff {diff:.3e} <= '
          f'{PARITY_UEND_TOL}; all {len(names)} tableaus on Dahlquist (16 complex lambdas, complex128; the IMEX pairs '
          f'on DahlquistIMEX), 3 steps: card against CPU at most {worst:.3e} <= {RK_DAHLQUIST_TOL}')


def _vdp_cash_karp(device):
    from pysdc_tpu_torch.convergence.adaptivity import AdaptivityRK
    from pysdc_tpu_torch.models.odes import VanDerPol
    from pysdc_tpu_torch.sweepers.runge_kutta import Cash_Karp

    return dict(problem_class=VanDerPol, problem_params=dict(mu=5.0, u0=(2.0, 0.0), newton_tol=1e-10, device=device),
                sweeper_class=Cash_Karp, sweeper_params={}, level_params=dict(dt=1e-2, restol=-1.0),
                step_params=dict(maxiter=1), convergence_controllers={AdaptivityRK: dict(e_tol=1e-7, update_order=5)})


def phase_rk_adaptive(card):
    """Embedded-RK adaptivity on both lanes: Cash-Karp with ``AdaptivityRK`` on VanDerPol (tests/test_fused.py:363)
    through ``ShardedController(1).run`` ('auto' -> 'fused_adaptive') against ``lane='stage'`` and against the CPU;
    then ESDIRK43 with ``AdaptivityRK`` on HeatND 2048^2 float32 and float64 through ``ControllerNonMPI``, and at
    256^2 float64 card against CPU.  Returns the K1 launches of the 2048^2 runs."""
    import torch

    from pysdc_tpu_torch import ShardedController, get_sorted
    from pysdc_tpu_torch.convergence.adaptivity import AdaptivityRK

    def march(device, lane):
        ctrl = ShardedController(1, {'logger_level': 30}, _vdp_cash_karp(device))
        start = time.perf_counter()
        uend, stats = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, VDP_TEND, lane=lane)
        wall = time.perf_counter() - start
        return SimpleNamespace(ctrl=ctrl, uend=uend.cpu(), wall=wall,
                               lane=[v for k, v in stats.items() if k.type == 'lane'],
                               dts=[v for _, v in get_sorted(stats, type='dt', sortby='time')],
                               restarts=sum(v for _, v in get_sorted(stats, type='restart')))

    launches = 0
    fused_run, stage_run, cpu_run = march('cuda', 'auto'), march('cuda', 'stage'), march('cpu', 'auto')
    label = f'rk adaptive: Cash_Karp + AdaptivityRK(e_tol 1e-7, order 5) on VanDerPol fp64, dt0 1e-2, Tend {VDP_TEND}'
    for name, other in (('stage lane', stage_run), ('CPU', cpu_run)):
        rel = max(abs(a - b) / b for a, b in zip(fused_run.dts, other.dts)) if len(other.dts) == len(fused_run.dts) else 1
        diff = (fused_run.uend - other.uend).abs().max().item()
        if other.restarts != fused_run.restarts or not rel <= RK_DT_RTOL or not diff <= ADAPTIVE_PARITY_TOL:
            raise AssertionError(f'{label}: against the {name}: steps {len(other.dts)} / {len(fused_run.dts)}, restarts '
                                 f'{other.restarts} / {fused_run.restarts}, dt rel {rel:.3e}, uend {diff:.3e}')
        print(f'{label}: the adaptive fused lane against the {name}: {len(fused_run.dts)} steps, {fused_run.restarts} '
              f'restarts, accepted dt to {rel:.3e} <= {RK_DT_RTOL} relative, uend {diff:.3e} <= {ADAPTIVE_PARITY_TOL}')
    programs = fused_run.ctrl._fused_adaptive_fn._programs
    graphs = len(next(iter(programs.values())).graphs)
    distinct = len({round(dt, 12) for dt in fused_run.dts})
    if fused_run.lane != ['fused_adaptive'] or stage_run.lane != ['stage'] or len(programs) != 1 or graphs != 3 \
            or distinct < 3:
        raise AssertionError(f'{label}: lane {fused_run.lane}, {len(programs)} programs of {graphs} graphs over '
                             f'{distinct} step sizes')
    print(f'{label}: \'auto\' took {fused_run.lane[0]}: one program of {graphs} graphs over {distinct} step sizes; wall '
          f'{fused_run.wall:.3f} s (fused adaptive, capture included) / {stage_run.wall:.3f} s (stage) [{card}]')

    # float32 at 2048^2: the secondary end point contracts f = A u, whose rounding A amplifies (|A| ~ 8 nu / dx^2 =
    # 3.4e6): the estimate is then about 0.9 dt, rounding and no time error (float64: 2.6e-7 at dt 0.01), and the
    # controller drives dt to about 8e-6.  From dt 0.01 it needs more than the 10 restarts of a step that
    # BasicRestarting allows (each takes the gap a quarter of the way in log dt), so that run starts at 1e-4, and a
    # short horizon keeps it to some hundred steps
    ad = {AdaptivityRK: dict(e_tol=1e-5, update_order=4)}
    lines = []
    for dtype, dt0, Tend in ((torch.float32, RK_AD_DT_FP32, RK_AD_TEND_FP32), (torch.float64, DT, RK_AD_TEND)):
        desc = _rk_description('ESDIRK43', N_MAIN, dtype, 'cuda', controllers=ad, restol=-1.0)
        desc['level_params']['dt'] = dt0
        run = _rk_run(desc, Tend)
        per_step = _rk_evals(run.ctrl.MS[0].levels[0].sweep)
        # every attempt, restarted ones included, logs its dt and runs the whole tableau
        if run.launches != per_step * len(run.dts) or run.paths != {'bands': run.launches, 'general': 0} \
                or not bool(torch.isfinite(run.uend).all()):
            raise AssertionError(f'rk adaptive: ESDIRK43 {N_MAIN}^2 {dtype}: K1 launches {run.launches} by path '
                                 f'{run.paths}, {len(run.dts)} steps and {run.restarts} restarts')
        launches += run.launches
        shown = [float(f'{d:.4e}') for d in run.dts]
        lines.append(f'{str(dtype)[6:]} from dt {dt0:g} to Tend {Tend:g}: {len(run.dts)} attempts, {run.restarts} restarts, dt '
                     f'{shown if len(shown) <= 12 else shown[:6] + ["..."] + shown[-3:]}, K1 launches {run.launches} = '
                     f'{len(run.dts)} x {per_step}, all on bands, wall {run.wall:.3f} s')
    small = {device: _rk_run(_rk_description('ESDIRK43', N_RK_PARITY, torch.float64, device, controllers=ad,
                                             restol=-1.0), RK_AD_TEND) for device in ('cuda', 'cpu')}
    a, b = small['cuda'], small['cpu']
    rel = max(abs(x - y) / y for x, y in zip(a.dts, b.dts)) if len(a.dts) == len(b.dts) else 1
    if a.restarts != b.restarts or not rel <= RK_AD_PARITY_DT_RTOL:
        raise AssertionError(f'rk adaptive: ESDIRK43 {N_RK_PARITY}^2 fp64 card against CPU: steps {len(a.dts)} / '
                             f'{len(b.dts)}, restarts {a.restarts} / {b.restarts}, dt rel {rel:.3e}')
    print(f'rk adaptive: ESDIRK43 + AdaptivityRK(e_tol 1e-5, order 4) on HeatND {N_MAIN}^2: '
          + '; '.join(lines) + f'; at {N_RK_PARITY}^2 fp64 card against CPU: {len(a.dts)} attempts, {a.restarts} '
          f'restarts, dt to {rel:.3e} <= {RK_AD_PARITY_DT_RTOL} relative [{card}]')
    return launches


def phase_sweepers_parity():
    """Float64 card against CPU for the remaining sweepers: equal niter, uend to 1e-11."""
    import torch

    from pysdc_tpu_torch import ExplicitSweeper, LinearizedImplicitParallel, MultiImplicitSweeper, models
    from pysdc_tpu_torch.sweepers import multistep

    radau = dict(num_nodes=M_FI, quad_type='RADAU-RIGHT')
    fisher = dict(nvars=255, nu=1.0, lambda0=2.0, newton_tol=1e-11)
    cases = {
        f'ExplicitSweeper HeatND {N_RK_PARITY}^2': (
            models.HeatND, dict(nvars=(N_RK_PARITY, N_RK_PARITY), nu=0.1, freq=2, bc='periodic'), ExplicitSweeper,
            radau, dict(dt=DT_EXPLICIT, restol=1e-10), 30, 2 * DT_EXPLICIT),
    }
    for cfg in (dict(jacobian=0, basis='Q'), dict(jacobian=0, basis='QI', QI='LU'),
                dict(jacobian='per_node', basis='QI', QI='LU')):
        cases[f'LinearizedImplicitParallel {cfg} Fisher 255'] = (
            models.GeneralizedFisher1D, fisher, LinearizedImplicitParallel, dict(radau, **cfg),
            dict(dt=0.01, restol=1e-10), 50, 0.1)
    for name in ('AdamsBashforthExplicit1Step', 'BackwardEulerMultiStep', 'AdamsMoultonImplicit1Step',
                 'AdamsMoultonImplicit2Step'):
        cases[f'{name} Logistic'] = (models.Logistic, dict(u0=0.5, lam=2.0, newton_tol=1e-14),
                                     getattr(multistep, name), {}, dict(dt=0.1), 1, 1.0)
    for cls in (models.GrayScottMultiImplicit, models.GrayScottMultiImplicitLinear):
        cases[f'{cls.__name__} {N_SPECTRAL}^2'] = (
            cls, dict(nvars=(N_SPECTRAL, N_SPECTRAL), newton_tol=1e-11), MultiImplicitSweeper,
            dict(radau, Q1='LU', Q2='LU'), dict(dt=1.0, restol=1e-9), 50, 4.0)
    threads = torch.get_num_threads()
    # small systems: one CPU thread is enough, and a multithreaded complex LU of torch's CPU LAPACK (the linearized
    # sweeper's solves) has been seen to stall
    torch.set_num_threads(1)
    try:
        for label, case in cases.items():
            _sweeper_parity(label, *case)
    finally:
        torch.set_num_threads(threads)


def _sweeper_parity(label, problem, params, sweeper, sweeper_params, level, maxiter, Tend):
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted

    out = []
    for device in ('cuda', 'cpu'):
        desc = dict(problem_class=problem, problem_params=dict(params, dtype=torch.float64, device=device),
                    sweeper_class=sweeper, sweeper_params=sweeper_params, level_params=level,
                    step_params=dict(maxiter=maxiter))
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
        prob = ctrl.MS[0].levels[0].prob
        uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
        out.append((uend.cpu(), [v for _, v in get_sorted(stats, type='niter', sortby='time')], prob.u_exact(0.0).cpu()))
    (u_card, it_card, u0), (u_cpu, it_cpu, _) = out
    diff = (u_card - u_cpu).abs().max().item()
    moved = (u_cpu - u0).abs().max().item()
    if it_card != it_cpu or not diff <= PARITY_UEND_TOL or not moved > 1e-8 or not bool(torch.isfinite(u_card).all()):
        raise AssertionError(f'sweepers parity: {label}: niter card {it_card} cpu {it_cpu}, uend diff {diff:.3e}, '
                             f'moved {moved:.3e}')
    print(f'sweepers parity: {label} fp64: niter {it_card[:6]}{"..." if len(it_card) > 6 else ""} '
          f'({len(it_card)} steps) on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL}')


def phase_sweeper_times(mi_run, main_ctrl, card):
    """One multi-implicit sweep at 1024^2 from the spread state, by kind of work (K1, cuFFT, the pointwise Newton's
    passes, the rest, idle), beside the fully implicit sweep of the same problem; one ESDIRK43 step at 2048^2
    float32 beside the main path's GenericImplicit sweep."""
    import torch

    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.allen_cahn import AllenCahnPeriodicND
    from pysdc_tpu_torch.sweepers.runge_kutta import ESDIRK43

    def sweep_of(prob, sweep):
        state0 = sweep.predict(prob, prob.u_exact(0.0), 0.0, DT_FI)

        def one():
            state = sweep.update_nodes(prob, state0, 0.0, DT_FI, 0)
            return sweep.compute_residual(state, DT_FI)[1]
        return one

    lvl = mi_run.ctrl.MS[0].levels[0]
    prob, sweep = lvl.prob, lvl.sweep
    one = sweep_of(prob, sweep)
    # the pointwise Newton solves of one sweep, replayed alone from the arguments the sweep gave them
    calls = []
    solve_2 = prob.solve_system_2
    prob.solve_system_2 = lambda *args: calls.append(args) or solve_2(*args)
    prob.solver_trace = []
    one()
    prob.solve_system_2 = solve_2
    trace, prob.solver_trace = list(prob.solver_trace), None
    reads0 = prob.host_reads
    card_ms, host_ms = _event_ms(lambda i: one(), 3, warmup=0, host=True)
    reads = (prob.host_reads - reads0) / 3
    split, n_kernels = _kernel_split(one)
    newton, n_newton = _kernel_split(lambda: [solve_2(*args) for args in calls])
    busy = sum(split.values())
    pcg = [k for _, ks in trace for k in ks]
    print(f'times: multi-implicit sweep {N_FI}^2 fp64 M={M_FI} Q1=Q2=LU from the spread state: {card_ms:.3f} ms on '
          f'the card, {host_ms:.3f} ms host clock, {n_kernels} kernels, {reads:.0f} host reads; pointwise Newton '
          f'iterations per solve {[k for k, _ in trace]}, PCG iterations {pcg}; by kind (profiler): K1 '
          f'{split["K1"]:.3f} ms, cuFFT {split["cuFFT"]:.3f} ms, the pointwise Newton solves {newton["other"]:.3f} ms '
          f'in {n_newton} kernels, the rest {split["other"] - newton["other"]:.3f} ms; idle {card_ms - busy:.3f} ms '
          f'({100 * (1 - busy / card_ms):.0f}%) [{card}]')

    fi = AllenCahnPeriodicND(nvars=(N_FI, N_FI), eps=0.04, newton_tol=NEWTON_TOL_FI, dtype=torch.float64, device='cuda')
    fi_one = sweep_of(fi, GenericImplicit(dict(num_nodes=M_FI, quad_type='RADAU-RIGHT', QI='LU')))
    fi_one()
    reads0 = fi.host_reads
    fi_ms, fi_host = _event_ms(lambda i: fi_one(), 3, warmup=0, host=True)
    fi_split, fi_kernels = _kernel_split(fi_one)
    fi_busy = sum(fi_split.values())
    print(f'times: beside it, the fully implicit sweep of the same problem (GenericImplicit M={M_FI} LU, Newton-PCG): '
          f'{fi_ms:.3f} ms on the card, {fi_host:.3f} ms host clock, {fi_kernels} kernels, '
          f'{(fi.host_reads - reads0) / 3:.0f} host reads; K1 {fi_split["K1"]:.3f}, cuFFT {fi_split["cuFFT"]:.3f}, '
          f'the rest {fi_split["other"]:.3f} ms; idle {100 * (1 - fi_busy / fi_ms):.0f}% [{card}]')

    # one ESDIRK43 step at 2048^2 float32 (predictor, the stages, the end points) beside a main-path sweep
    heat = main_ctrl.MS[0].levels[0].prob
    rk = ESDIRK43({})
    u0 = heat.u_exact(0.0)

    def rk_step():
        state = rk.predict(heat, u0, 0.0, DT)
        state = rk.update_nodes(heat, state, 0.0, DT)
        return rk.compute_end_point_with_secondary(state, 0.0, DT)

    rk_ms, rk_host = _event_ms(lambda i: rk_step(), 10, warmup=2, host=True)
    rk_split, rk_kernels = _kernel_split(rk_step)
    lvl = main_ctrl.MS[0].levels[0]
    main_state = lvl.state

    def main_sweep():  # from the state the run left each time, so that a call may be profiled again
        lvl.state = main_state
        lvl.update_nodes()
        lvl.compute_residual()

    main_ms, main_host = _event_ms(lambda i: main_sweep(), 10, warmup=2, host=True)
    main_split, main_kernels = _kernel_split(main_sweep)
    print(f'times: one ESDIRK43 step HeatND {N_MAIN}^2 fp32 (6 stages, 5 shifted solves, 7 K1 applies): {rk_ms:.4f} ms '
          f'on the card, {rk_host:.4f} ms host clock, {rk_kernels} kernels (K1 {rk_split["K1"]:.4f}, cuFFT '
          f'{rk_split["cuFFT"]:.4f}, the rest {rk_split["other"]:.4f} ms); the main path\'s GenericImplicit sweep '
          f'(M={M_MAIN} LU, update_nodes + residual): {main_ms:.4f} ms on the card, {main_host:.4f} ms host clock, '
          f'{main_kernels} kernels (K1 {main_split["K1"]:.4f}, cuFFT {main_split["cuFFT"]:.4f}, the rest '
          f'{main_split["other"]:.4f} ms) [{card}]')


# -- ParaDiag (all-at-once diagonalization in time), the second-order and the DAE sweepers --------------------------
def _paradiag_description(n, dtype, device, restol=RESTOL_PD, maxiter=MAXITER_PD, dt=DT_PD, freq=4):
    """bench_paradiag (bench.py:844-870) at ``n``^2: HeatND periodic, nu 0.1, QDiagonalization M=3 RADAU-RIGHT."""
    from pysdc_tpu_torch import QDiagonalization
    from pysdc_tpu_torch.models.heat import HeatND

    return dict(problem_class=HeatND,
                problem_params=dict(nvars=(n, n), nu=0.1, freq=freq, bc='periodic', dtype=dtype, device=device),
                sweeper_class=QDiagonalization, sweeper_params=dict(num_nodes=M_PD, quad_type='RADAU-RIGHT'),
                level_params=dict(dt=dt, restol=restol), step_params=dict(maxiter=maxiter))


def _paradiag_run(desc, L=L_PD, alpha=ALPHA_PD, plain=False, n_blocks=1, mesh=None):
    """``ParaDiagController(L, mesh=mesh).run`` over ``n_blocks`` blocks from ``u_exact(0)``, the K1 counts set to 0
    just before the run: niter, the final residual of each step, the K1 launches by path, ``uend``."""
    from pysdc_tpu_torch import ParaDiagController, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ParaDiagController(L, {'logger_level': 30, 'alpha': alpha}, desc, mesh=mesh)
    prob = ctrl.template.levels[0].prob
    if plain:
        prob.A.disable_pallas()
    u0 = prob.u_exact(0.0)
    Tend = n_blocks * L * desc['level_params']['dt']
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    uend, stats = ctrl.run(u0, 0.0, Tend)
    return SimpleNamespace(ctrl=ctrl, prob=prob, uend=uend, Tend=Tend, niter=_niter(stats),
                           residuals=[v for _, v in get_sorted(stats, type='residual_post_step', sortby='time')],
                           launches=cross_stencil_2d.launches, paths=dict(cross_stencil_2d.paths))


def _paradiag_k1_cases():
    """(label, block shape, taps) of K1's complex route: the bench's block at 512^2 and 2048^2, the parity block."""
    import torch

    from pysdc_tpu_torch.models.heat import HeatND

    cases = []
    for n, L in ((N_PD, L_PD), (N_PD_BIG, L_PD), (N_PD_PARITY, L_PD_PARITY)):
        terms = HeatND(nvars=(n, n), nu=0.1, freq=4, bc='periodic', dtype=torch.float32, device='cuda').A._cross_terms
        cases.append((f'{n}^2', (L, M_PD, n, n), terms))
    return cases


def phase_paradiag_kernels():
    """K1 on the interleaved real view of complex fields against the plain complex rolls, complex64 and complex128,
    at ParaDiag's block shapes: the path the wrapper picks (which must be the one ``choose_path`` gives the doubled
    table) and the general path forced.  Returns the (view shape, taps) pairs covered, with their path."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import choose_path, interleaved_terms

    gen = torch.Generator(device='cuda').manual_seed(99)
    covered = {}
    for label, shape, terms in _paradiag_k1_cases():
        doubled = interleaved_terms(terms)
        view = shape[:-1] + (2 * shape[-1],)
        for dtype in (torch.complex64, torch.complex128):
            real = torch.float32 if dtype == torch.complex64 else torch.float64
            itemsize = torch.empty((), dtype=real).element_size()
            u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
            expected = choose_path(view, doubled, itemsize)
            tol = _stencil_tolerance(doubled, real)
            err, rel = _k1_both_paths(f'paradiag {label}', terms, u, expected, tol)
            covered[(view, real, doubled)] = expected
            print(f'paradiag kernels: K1 on the interleaved view of a {str(dtype)[6:]} block {shape} -> {real} {view}, '
                  f'y taps {doubled[1][1]}: path {expected}, max abs err {err:.3e}, max rel err {rel:.3e} <= tol '
                  f'{tol:.3e} (both paths)')
            del u
    torch.cuda.empty_cache()
    return covered


def _check_paradiag_k1(run, label, covered, dtype):
    """Every K1 launch of a ParaDiag run: one an iteration, on the path phase 38 covered for its block."""
    from pysdc_tpu_torch.ops.kernels.stencil import interleaved_terms

    its = run.niter[0]
    if any(k != its for k in run.niter) or run.launches != its:
        raise AssertionError(f'{label}: niter {run.niter}, K1 launches {run.launches}, expected one an iteration')
    shape = (L_PD, M_PD) + tuple(run.prob.shape)
    key = (shape[:-1] + (2 * shape[-1],), dtype, interleaved_terms(run.prob.A._cross_terms))
    path = covered.get(key)
    if path is None or run.paths != {**{'bands': 0, 'general': 0}, path: its}:
        raise AssertionError(f'{label}: K1 launches by path {run.paths}, phase 38 covered {path} for this block')
    return path


def phase_paradiag(card, covered):
    """bench_paradiag's block at 512^2 float32 (complex64 block) through ``ParaDiagController.run``, against the plain
    apply, u_exact and a float64 run; then the same block at 2048^2."""
    import torch

    desc = _paradiag_description(N_PD, torch.float32, 'cuda')
    torch.cuda.synchronize()
    start = time.perf_counter()
    run = _paradiag_run(desc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    path = _check_paradiag_k1(run, f'paradiag {N_PD}^2', covered, torch.float32)
    if not all(r <= RESTOL_PD for r in run.residuals) or len(run.residuals) != L_PD:
        raise AssertionError(f'paradiag {N_PD}^2: final residuals {run.residuals} above restol {RESTOL_PD}')
    uend = run.uend
    if uend.shape != (N_PD, N_PD) or uend.dtype != torch.float32 or not bool(torch.isfinite(uend).all()):
        raise AssertionError('paradiag: uend is not a finite float32 field of the grid shape')
    err = (uend - run.prob.u_exact(run.Tend)).abs().max().item()
    plain = _paradiag_run(desc, plain=True)
    diff_plain = (uend - plain.uend).abs().max().item()
    fp64 = _paradiag_run(_paradiag_description(N_PD, torch.float64, 'cuda'))
    diff64 = (uend.double() - fp64.uend).abs().max().item()
    if plain.launches != 0 or plain.niter != run.niter or not diff_plain <= PD_PLAIN_BOUND:
        raise AssertionError(f'paradiag vs plain apply: niter {plain.niter} / {run.niter}, uend diff {diff_plain:.3e}, '
                             f'K1 launches {plain.launches}')
    if not err <= PD_EXACT_BOUND or not diff64 <= PD_FP64_BOUND or not all(r <= RESTOL_PD for r in fp64.residuals):
        raise AssertionError(f'paradiag: |uend - u_exact| {err:.3e}, |uend - uend fp64| {diff64:.3e}, fp64 residuals '
                             f'{fp64.residuals}')
    print(f'paradiag: HeatND {N_PD}^2 fp32 (complex64 block {(L_PD, M_PD, N_PD, N_PD)}), L={L_PD} M={M_PD} alpha '
          f'{ALPHA_PD} dt {DT_PD}, one block: niter {run.niter}, final residuals max {max(run.residuals):.3e} <= restol '
          f'{RESTOL_PD}, K1 launches {run.launches} = iterations, all on {path}; wall {wall:.3f} s incl. first calls; '
          f'|uend - u_exact| {err:.3e} <= {PD_EXACT_BOUND} (max|uend| {uend.abs().max().item():.4f}); through the plain '
          f'apply niter {plain.niter}, uend diff {diff_plain:.3e} <= {PD_PLAIN_BOUND}; float64 on the card niter '
          f'{fp64.niter}, uend diff {diff64:.3e} <= {PD_FP64_BOUND} [{card}]')

    # the main path's width: float32 at 2048^2 sits above restol (the floor of f = A u's rounding, stated)
    del plain, fp64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**20
    big = _paradiag_run(_paradiag_description(N_PD_BIG, torch.float32, 'cuda'))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    big_path = _check_paradiag_k1(big, f'paradiag {N_PD_BIG}^2', covered, torch.float32)
    floor = _paradiag_floor(big.prob, torch.float32)
    err_big = (big.uend - big.prob.u_exact(big.Tend)).abs().max().item()
    exact_bound = PD_EXACT_BOUND * (N_PD_BIG / N_PD) ** 2
    if not all(r <= max(RESTOL_PD, floor) for r in big.residuals) or not err_big <= exact_bound:
        raise AssertionError(f'paradiag {N_PD_BIG}^2: final residuals {big.residuals} (floor {floor:.3e}), '
                             f'|uend - u_exact| {err_big:.3e}')
    print(f'paradiag: HeatND {N_PD_BIG}^2 fp32, one block: niter {big.niter}, final residuals '
          f'{[float(f"{r:.3e}") for r in big.residuals]} <= max(restol, the float32 floor dt sum|c| eps max|u0| = '
          f'{floor:.3e}), K1 launches {big.launches} = iterations, all on {big_path}; |uend - u_exact| {err_big:.3e} '
          f'<= {exact_bound:.1e} (the 512^2 bound times (n / 512)^2); peak memory {peak:.0f} MiB, {peak - before:.0f} '
          f'MiB above what the script held before the run [{card}]')
    by_path = {f'paradiag {N_PD}': run.launches, f'paradiag {N_PD_BIG}': big.launches}
    return run, big, by_path


def _paradiag_floor(prob, dtype):
    """The residual's float32 floor of a ParaDiag block from u_exact(0): f = A u rounds by sum|c| eps max|u|, and
    reaches the residual through dt Q (row sums at most 1)."""
    import torch

    terms = prob.A._cross_terms
    return DT_PD * sum(abs(c) for coeff, _ in terms for c in coeff) * torch.finfo(dtype).eps * \
        prob.u_exact(0.0).abs().max().item()


def _parity_pair(label, make, check):
    """``make(device)`` on the card and on the CPU (one thread: complex LU), then ``check(card_out, cpu_out)``."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = [make(device) for device in ('cuda', 'cpu')]
    finally:
        torch.set_num_threads(threads)
    return check(label, *out)


def phase_paradiag_parity():
    """Float64 ParaDiag on the card against the port's CPU run: HeatND 128^2 with L=4, Dahlquist (16 lambdas),
    VanDerPol (tests/test_paradiag.py:70-77), and QDiagonalization(ignore_ic=False) as a direct collocation solver."""
    import torch

    from pysdc_tpu_torch import QDiagonalization
    from pysdc_tpu_torch.models.dahlquist import Dahlquist
    from pysdc_tpu_torch.models.odes import VanDerPol

    def desc(problem_class, params, dt, maxiter):
        return dict(problem_class=problem_class, problem_params=params, sweeper_class=QDiagonalization,
                    sweeper_params=dict(num_nodes=M_PD, quad_type='RADAU-RIGHT'),
                    level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=maxiter))

    cases = {
        f'HeatND {N_PD_PARITY}^2 L={L_PD_PARITY}': (lambda device: _paradiag_description(
            N_PD_PARITY, torch.float64, device, restol=1e-10, maxiter=20, freq=2), L_PD_PARITY, 1e-4, 2),
        'Dahlquist 16 lambdas': (lambda device: desc(Dahlquist, dict(lambdas=np.linspace(-8, -0.2, 16), u0=1.0,
                                                                     device=device), 0.1, 20), 4, 1e-4, 1),
        'VanDerPol mu=1': (lambda device: desc(VanDerPol, dict(mu=1.0, u0=(2.0, 0.0), newton_tol=1e-12, device=device),
                                               0.02, 50), 4, 1e-3, 5),
    }

    def check(label, card_run, cpu_run):
        diff = (card_run.uend.cpu() - cpu_run.uend).abs().max().item()
        if card_run.niter != cpu_run.niter or not diff <= PARITY_UEND_TOL or len(card_run.niter) < 4:
            raise AssertionError(f'paradiag parity {label}: niter card {card_run.niter} cpu {cpu_run.niter}, uend diff '
                                 f'{diff:.3e}')
        print(f'paradiag parity: {label} fp64: niter {card_run.niter[:8]}{"..." if len(card_run.niter) > 8 else ""} '
              f'({len(card_run.niter)} steps) on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL}')

    for label, (make, L, alpha, blocks) in cases.items():
        _parity_pair(label, lambda device: _paradiag_run(make(device), L=L, alpha=alpha, n_blocks=blocks), check)

    # SDC mode: one update solves the collocation problem directly
    from pysdc_tpu_torch.core.level import Level
    from pysdc_tpu_torch.models.heat import HeatND

    def direct(device):
        prob = HeatND(nvars=(N_PD_PARITY, N_PD_PARITY), nu=0.1, freq=2, bc='periodic', dtype=torch.float64,
                      device=device)
        lvl = Level(prob, QDiagonalization(dict(num_nodes=M_PD, quad_type='RADAU-RIGHT', ignore_ic=False)),
                    dict(dt=0.05, restol=1e-12))
        lvl.status.time = 0.0
        lvl.predict(prob.u_exact(0.0))
        lvl.update_nodes()
        lvl.compute_residual()
        return lvl.u.cpu(), float(lvl.status.residual)

    def check_direct(label, card_out, cpu_out):
        diff = (card_out[0] - cpu_out[0]).abs().max().item()
        if not (card_out[1] < 1e-12 and cpu_out[1] < 1e-12 and diff <= PARITY_UEND_TOL):
            raise AssertionError(f'paradiag parity {label}: residuals {card_out[1]:.3e} / {cpu_out[1]:.3e}, '
                                 f'node values {diff:.3e} apart')
        print(f'paradiag parity: {label} fp64: residual after one update {card_out[1]:.3e} (card), {cpu_out[1]:.3e} '
              f'(CPU) < 1e-12, node values {diff:.3e} apart <= {PARITY_UEND_TOL}')

    _parity_pair(f'QDiagonalization(ignore_ic=False) HeatND {N_PD_PARITY}^2', direct, check_direct)


def _nonmpi_pair(problem, params, sweeper, sweeper_params, level, maxiter, Tend, u0=None, t0=0.0):
    """``ControllerNonMPI(1)`` float64 on the card and on the CPU from the same initial state (``u0(device)`` or
    ``u_exact(t0)``) to ``Tend``: niter per step and the final state of each (a problem with a ``newton_trace``
    records its Newton iterations)."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI

    out = {}
    for device in ('cuda', 'cpu'):
        desc = dict(problem_class=problem, problem_params=dict(params, dtype=torch.float64, device=device),
                    sweeper_class=sweeper, sweeper_params=sweeper_params, level_params=level,
                    step_params=dict(maxiter=maxiter))
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
        prob = ctrl.MS[0].levels[0].prob
        if hasattr(prob, 'newton_trace'):
            prob.newton_trace = []
        start = prob.u_exact(t0) if u0 is None else u0(device)
        uend, stats = ctrl.run(start, t0, Tend)
        out[device] = SimpleNamespace(prob=prob, u0=start, uend=uend, niter=_niter(stats))
    return out['cuda'], out['cpu']


def _leaves(x):
    return tuple(x) if isinstance(x, tuple) else (x,)


def _state_diff(a, b):
    return max((x.cpu() - y.cpu()).abs().max().item() for x, y in zip(_leaves(a), _leaves(b)))


def phase_second_order(card):
    """Float64 card against CPU: Verlet on FPUT (2048 particles, the problem's default, with its energy drift), Boris
    on the Penning trap with 1 particle (the order run of examples/step_19_second_order_sdc.py:123-140) and with
    1024 (the pairwise (3, N, N) Coulomb sum on the card), RKN4 on the harmonic oscillator."""
    import torch

    from pysdc_tpu_torch.models import particles
    from pysdc_tpu_torch.sweepers.boris import BorisSDC
    from pysdc_tpu_torch.sweepers.rkn import RKN4
    from pysdc_tpu_torch.sweepers.verlet import VerletSweeper

    def gate(label, card_run, cpu_run, tol=PARITY_UEND_TOL):
        diff = _state_diff(card_run.uend, cpu_run.uend)
        scale = max(x.abs().max().item() for x in _leaves(cpu_run.uend))
        if card_run.niter != cpu_run.niter or not diff <= tol * max(1.0, scale) or not all(
                bool(torch.isfinite(x).all()) for x in _leaves(card_run.uend)):
            raise AssertionError(f'second order {label}: niter card {card_run.niter[:8]} cpu {cpu_run.niter[:8]}, '
                                 f'uend diff {diff:.3e}')
        return diff

    lobatto = dict(num_nodes=3, quad_type='LOBATTO')
    t0 = time.perf_counter()
    card_run, cpu_run = _nonmpi_pair(particles.FermiPastaUlamTsingou, dict(npart=N_FPUT), VerletSweeper,
                                     dict(num_nodes=3), dict(dt=DT_FPUT, restol=1e-12), 20, STEPS_FPUT * DT_FPUT)
    wall = time.perf_counter() - t0
    diff = gate('FPUT', card_run, cpu_run)
    H0 = card_run.prob.eval_hamiltonian(card_run.u0).item()
    H1 = card_run.prob.eval_hamiltonian(card_run.uend).item()
    print(f'second order: VerletSweeper M=3 Lobatto on FermiPastaUlamTsingou npart={N_FPUT} fp64, {STEPS_FPUT} steps of '
          f'dt {DT_FPUT}: niter {sorted(set(card_run.niter))} on card and CPU, uend diff {diff:.3e} <= '
          f'{PARITY_UEND_TOL}; energy drift |H(T) - H(0)| / |H(0)| = {abs(H1 - H0) / abs(H0):.3e}; {wall:.1f} s '
          f'for both runs [{card}]')

    errs = []
    for dt in (1 / 64, 1 / 128):
        card_run, cpu_run = _nonmpi_pair(particles.PenningTrap3D, dict(nparts=1), BorisSDC, lobatto,
                                         dict(dt=dt, restol=1e-12), 20, 0.5)
        diff = gate(f'Penning trap 1 particle dt {dt}', card_run, cpu_run)
        ex = card_run.prob.u_exact(0.5)
        errs.append(_state_diff(card_run.uend, ex))
    order = math.log(errs[0] / errs[1]) / math.log(2)
    if not order > 3.3:
        raise AssertionError(f'second order: Boris-SDC order {order:.2f} (errors {errs}) <= 3.3')
    print(f'second order: BorisSDC M=3 Lobatto on PenningTrap3D, 1 particle, dt 1/64 and 1/128 to t 0.5: niter equal '
          f'on card and CPU, uend diff {diff:.3e}; errors against the analytic orbit {errs[0]:.3e}, {errs[1]:.3e}: '
          f'order {order:.2f} > 3.3')

    def cloud(device):
        gen = torch.Generator().manual_seed(2024)
        pos = 4.0 * (2 * torch.rand((3, N_PENNING), generator=gen, dtype=torch.float64) - 1)
        vel = torch.randn((3, N_PENNING), generator=gen, dtype=torch.float64)
        return particles.Particles(pos.to(device), vel.to(device))

    t0 = time.perf_counter()
    card_run, cpu_run = _nonmpi_pair(particles.PenningTrap3D, dict(nparts=N_PENNING), BorisSDC,
                                     lobatto, dict(dt=DT_PENNING, restol=1e-10), 20, STEPS_PENNING * DT_PENNING,
                                     u0=cloud)
    wall = time.perf_counter() - t0
    diff = gate(f'Penning trap {N_PENNING} particles', card_run, cpu_run)
    print(f'second order: BorisSDC on PenningTrap3D with {N_PENNING} particles (the (3, N, N) Coulomb sum on the card), '
          f'{STEPS_PENNING} steps of dt {DT_PENNING}: niter {card_run.niter} on card and CPU, uend diff {diff:.3e}; '
          f'{wall:.1f} s for both runs [{card}]')

    card_run, cpu_run = _nonmpi_pair(particles.HarmonicOscillator, dict(k=1.0, mu=0.0), RKN4, {},
                                     dict(dt=1 / 16, restol=-1), 1, 2.0)
    diff = gate('RKN4', card_run, cpu_run)
    err = _state_diff(card_run.uend, card_run.prob.u_exact(2.0))
    print(f'second order: RKN4 on HarmonicOscillator, 32 steps of dt 1/16: uend diff card-CPU {diff:.3e} <= '
          f'{PARITY_UEND_TOL}, error against the exact orbit {err:.3e}')


def phase_dae(card):
    """Float64 card against CPU: FullyImplicitDAE and SemiImplicitDAE on SimpleDAE, FullyImplicitDAE on Pendulum2D,
    EDIRK4DAE on DiscontinuousTestDAE; every Newton solve stopped before its maxiter, no failure flag."""
    import torch

    from pysdc_tpu_torch.models import dae_problems
    from pysdc_tpu_torch.sweepers import dae

    cases = {
        'FullyImplicitDAE SimpleDAE': (dae_problems.SimpleDAE, dict(newton_tol=1e-12), dae.FullyImplicitDAE,
                                       dict(num_nodes=3, QI='IE'), dict(dt=0.05, restol=1e-11), 40, 0.2),
        'SemiImplicitDAE SimpleDAE': (dae_problems.SimpleDAE, dict(newton_tol=1e-12), dae.SemiImplicitDAE,
                                      dict(num_nodes=3, QI='IE'), dict(dt=0.05, restol=1e-11), 40, 0.2),
        'FullyImplicitDAE Pendulum2D': (dae_problems.Pendulum2D, dict(newton_tol=1e-12), dae.FullyImplicitDAE,
                                        dict(num_nodes=3, QI='IE'), dict(dt=0.01, restol=1e-8), 50, 0.05),
        'EDIRK4DAE DiscontinuousTestDAE': (dae_problems.DiscontinuousTestDAE, dict(newton_tol=1e-13), dae.EDIRK4DAE,
                                           {}, dict(dt=0.2), 1, 0.8),
    }
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for label, (problem, params, sweeper, sweeper_params, level, maxiter, span) in cases.items():
            t_start = 1.0 if problem is dae_problems.DiscontinuousTestDAE else 0.0
            t0 = time.perf_counter()
            card_run, cpu_run = _nonmpi_pair(problem, params, sweeper, sweeper_params, level, maxiter,
                                             t_start + span, t0=t_start)
            wall = time.perf_counter() - t0
            card_run.uend = card_run.uend.cpu()
            diff = (card_run.uend - cpu_run.uend).abs().max().item()
            newton = [k for counts in card_run.prob.newton_trace for k in counts]
            converged = bool(newton) and max(newton) < card_run.prob.newton_maxiter
            if 'Pendulum' in label:
                u = card_run.uend
                parts = [(card_run.uend[s] - cpu_run.uend[s]).abs().max().item() for s in (slice(0, 2), slice(2, 4),
                                                                                           slice(4, 5))]
                constraint = abs(u[0].item() ** 2 + u[1].item() ** 2 - 1.0)
                ok = all(p <= tol for p, tol in zip(parts, PENDULUM_TOLS)) and constraint < 1e-10
                detail = (f'positions / velocities / multiplier {parts[0]:.3e} / {parts[1]:.3e} / {parts[2]:.3e} <= '
                          f'{PENDULUM_TOLS} (the multiplier carries the rounding amplified by 1/dt^2), constraint '
                          f'{constraint:.3e} < 1e-10')
            else:
                ok = diff <= PARITY_UEND_TOL * max(1.0, cpu_run.uend.abs().max().item())
                detail = f'uend diff {diff:.3e} <= {PARITY_UEND_TOL}'
            if card_run.niter != cpu_run.niter or not ok or not converged:
                raise AssertionError(f'dae {label}: niter card {card_run.niter} cpu {cpu_run.niter}, {detail}, '
                                     f'Newton iterations max {max(newton) if newton else None}')
            print(f'dae: {label} fp64: niter {card_run.niter} on card and CPU, {detail}; {len(newton)} Newton solves '
                  f'of {min(newton)}-{max(newton)} iterations, each below newton_maxiter; {wall:.1f} s for both runs '
                  f'[{card}]')
    finally:
        torch.set_num_threads(threads)


def phase_paradiag_times(pd, pd_big, card):
    """One ParaDiag iteration at 512^2 and 2048^2: ms on the card (CUDA events) and on the host clock, busy time by
    kind of kernel (profiler) and the idle share, and from a CUDA graph of one iteration; bench_paradiag's rate;
    K1 at (8, 3, 512, 1024) float32 against its bound and the complex rolls; the same 8 steps through serial SDC."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit
    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, interleaved_terms

    for run in (pd, pd_big):
        ctrl, prob = run.ctrl, run.prob
        n = prob.shape[0]
        u0 = prob.u_exact(0.0)
        t_arr = DT_PD * np.arange(L_PD)
        u = ctrl._predict(u0)
        u, _ = ctrl._iteration(u, u0, t_arr, DT_PD)  # an iterate of the block, not the spread state

        def one(i):
            return ctrl._iteration(u, u0, t_arr, DT_PD)

        card_ms, host_ms = _event_ms(one, 10, warmup=2, host=True)
        _device_busy(lambda: one(0), top=8)
        # the profiler drops K1's launch from some sessions (a kernel launched through ctypes by the library's own
        # CUDA runtime; seen on the card at 512^2 and, in every session, at 2048^2): the fuller of two sessions,
        # and K1's time from CUDA events on the same block where the profiler did not see it
        split, n_kernels = max((_kernel_split(lambda: one(0), products=True) for _ in range(2)),
                               key=lambda sk: sum(sk[0].values()))
        k1_seen = split['K1'] > 0
        if not k1_seen:
            split['K1'] = _event_ms(lambda i: prob.A.apply(u), 10)
            n_kernels += 1
        busy = sum(split.values())
        graph_ms = _graph_ms(one, 5)
        rate = L_PD * M_PD * 5 * n * n / (card_ms * 1e-3) / 1e9
        print(f'paradiag times: one iteration, HeatND {n}^2 fp32 (complex64 block {(L_PD, M_PD, n, n)}, '
              f'{L_PD * M_PD * n * n * 8 / 1e6:.0f} MB): {card_ms:.4f} ms on the card, {host_ms:.4f} ms host clock, '
              f'{graph_ms:.4f} ms from a CUDA graph; {n_kernels} kernels, busy {busy:.4f} ms: K1 {split["K1"]:.4f}'
              f'{"" if k1_seen else " (CUDA events: not in the profile)"}, '
              f'cuFFT {split["cuFFT"]:.4f}, complex products {split["products"]:.4f}, the rest {split["other"]:.4f}; '
              f'idle {card_ms - busy:.4f} ms ({100 * (1 - busy / card_ms):.0f}%); bench_paradiag\'s rate L M 5 n^2 / '
              f'iteration = {rate:.2f} Gnnz/s eager, {rate * card_ms / graph_ms:.2f} from the graph [{card}]')

        # the whole block through ParaDiag beside the same 8 steps through serial SDC (GenericImplicit M=3 LU)
        block_ms, block_host = _event_ms(lambda i: ctrl.run(u0, 0.0, L_PD * DT_PD), 2, warmup=1, host=True)
        desc = _paradiag_description(n, torch.float32, 'cuda', maxiter=50)
        desc.update(sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=M_PD, quad_type='RADAU-RIGHT',
                                                                       QI='LU'))
        serial = ControllerNonMPI(1, {'logger_level': 30}, desc)
        out = {}

        def serial_run(i):
            out['uend'], out['stats'] = serial.run(u0, 0.0, L_PD * DT_PD)

        serial_ms, serial_host = _event_ms(serial_run, 2, warmup=1, host=True)
        niter = _niter(out['stats'])
        res = [v for k, v in out['stats'].items() if k.type == 'residual_post_step']
        print(f'paradiag times: the block of {L_PD} steps at {n}^2: ParaDiag {block_ms:.3f} ms on the card, '
              f'{block_host:.3f} host clock ({run.niter[0]} iterations); the same steps through ControllerNonMPI '
              f'(GenericImplicit M={M_PD} LU, restol {RESTOL_PD}, maxiter 50): {serial_ms:.3f} ms on the card, '
              f'{serial_host:.3f} host clock, niter {niter}, final residuals max {max(res):.3e}, uend '
              f'{(out["uend"] - run.uend).abs().max().item():.3e} from ParaDiag\'s [{card}]')
        del u
        torch.cuda.empty_cache()

    # float64 at 512^2, where both reach restol (float32 serial SDC stalls at its floor on the first steps)
    fp64 = _paradiag_run(_paradiag_description(N_PD, torch.float64, 'cuda'))
    u0 = fp64.prob.u_exact(0.0)
    block_ms, _ = _event_ms(lambda i: fp64.ctrl.run(u0, 0.0, L_PD * DT_PD), 2, warmup=1, host=True)
    desc = _paradiag_description(N_PD, torch.float64, 'cuda', maxiter=50)
    desc.update(sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=M_PD, quad_type='RADAU-RIGHT', QI='LU'))
    serial = ControllerNonMPI(1, {'logger_level': 30}, desc)
    out = {}

    def serial_run(i):
        out['uend'], out['stats'] = serial.run(u0, 0.0, L_PD * DT_PD)

    serial_ms, _ = _event_ms(serial_run, 2, warmup=1, host=True)
    print(f'paradiag times: float64 at {N_PD}^2: ParaDiag\'s block {block_ms:.3f} ms ({fp64.niter[0]} iterations) '
          f'against serial SDC {serial_ms:.3f} ms (niter {_niter(out["stats"])}), uend '
          f'{(out["uend"] - fp64.uend).abs().max().item():.3e} apart [{card}]')
    del fp64, serial, out
    torch.cuda.empty_cache()

    # K1 on the interleaved view at (8, 3, 512, 1024) float32 against its bound and the complex rolls it replaces
    terms = pd.prob.A._cross_terms
    k1 = _time_stencil((L_PD, M_PD, N_PD, 2 * N_PD), interleaved_terms(terms), card)
    gen = torch.Generator(device='cuda').manual_seed(5)
    us = [torch.randn((L_PD, M_PD, N_PD, N_PD), generator=gen, device='cuda', dtype=torch.complex64) for _ in range(3)]
    rolls_ms = _event_ms(lambda i: _roll_cross_2d(us[i % 3], terms), 12)
    print(f'paradiag times: K1 on the complex64 block {(L_PD, M_PD, N_PD, N_PD)} as its float32 view '
          f'{(L_PD, M_PD, N_PD, 2 * N_PD)}: {k1["graph_ms"]:.4f} ms from a CUDA graph, {k1["ms"]:.4f} eager, bound '
          f'{k1["bound_ms"]:.4f} ms by {k1["bound_by"]} ({100 * k1["bound_ms"] / k1["graph_ms"]:.0f}%); the complex '
          f'rolls it replaces {rolls_ms:.4f} ms eager ({rolls_ms / k1["ms"]:.1f}x) [{card}]')


# -- the remaining convergence controllers, resilience and observability (phases 44-48) -------------------------------

def _k1_check(name, terms, shapes, dtype, seed, label='resilience kernels'):
    """K1 against its plain version at ``shapes`` in ``dtype``, on the bands path the wrapper picks and with the
    general path forced; returns ``{name: (terms, shapes)}`` for :func:`_covered_by`."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import choose_path

    gen = torch.Generator(device='cuda').manual_seed(seed)
    tol = _stencil_tolerance(terms, dtype)
    itemsize = torch.empty((), dtype=dtype).element_size()
    worst, worst_abs = 0.0, 0.0
    for shape in shapes:
        if choose_path(shape, terms, itemsize) != 'bands':
            raise AssertionError(f'K1 {name} {dtype} {shape}: the wrapper does not pick the bands path')
        u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
        err, rel = _k1_both_paths(name, terms, u, 'bands', tol)
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    print(f'{label}: K1 {name} {dtype} max rel err {worst:.3e} <= tol {tol:.3e} (max abs {worst_abs:.3e} on '
          f'bands), on bands and with the general path forced, at {shapes}')
    return {name: (terms, set(shapes))}


def _resilience_description(n, device, controllers=None, num_nodes=M_RES, restol=-1.0, maxiter=MAXITER_RES):
    import torch

    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND

    return dict(
        problem_class=HeatND,
        problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device=device),
        sweeper_class=GenericImplicit,
        sweeper_params=dict(num_nodes=num_nodes, quad_type='RADAU-RIGHT', QI='LU'),
        level_params=dict(dt=DT_RES, restol=restol),
        step_params=dict(maxiter=maxiter),
        convergence_controllers=controllers or {},
    )


def _heat_run(desc, Tend, plain=False, hooks=(), before=None):
    """``desc`` through ``ControllerNonMPI(1, ...)`` from ``u_exact(0)`` to ``Tend``, every operator apply counted
    with its shape and K1's launches by path (its counts set to 0 just before the run and read just after);
    ``before(ctrl)`` may wrap what the gates read.  Returns a namespace
    (stats entries of every attempt, restarted ones included)."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ControllerNonMPI(1, {'logger_level': 30, 'hook_class': list(hooks)}, desc)
    prob = ctrl.MS[0].levels[0].prob
    if plain:
        prob.A.disable_pallas()
    extra = before(ctrl) if before else None
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, Tend)
    if uend.is_cuda:
        torch.cuda.synchronize()

    def entries(kind):
        return [(round(float(t), 12), v) for t, v in get_sorted(stats, type=kind, sortby='time', recomputed=None)]

    return SimpleNamespace(
        ctrl=ctrl, prob=prob, uend=uend, stats=stats, entries=entries, extra=extra, shapes=shapes,
        applies=applies[0], niter=entries('niter'), restarts=entries('restart'), dts=entries('dt'),
        launches=cross_stencil_2d.launches, paths=dict(cross_stencil_2d.paths),
    )


def _hotrod_deltas(ctrl):
    """Wrap the run's ``HotRod`` so that every check it makes records ``|e_em - e_ex|``; returns the list."""
    from pysdc_tpu_torch.convergence import HotRod

    deltas = []
    for C in ctrl.convergence_controllers:
        if isinstance(C, HotRod):
            check = C.determine_restart

            def recording(controller, S, check=check, **kwargs):
                status = S.levels[0].status
                e_ex = getattr(status, 'error_extrapolation_estimate', None)
                e_em = getattr(status, 'error_embedded_estimate', None)
                if S.status.iter >= S.params.maxiter and e_ex is not None and e_em is not None:
                    deltas.append((round(float(S.time), 12), abs(e_ex - e_em)))
                return check(controller, S, **kwargs)

            C.determine_restart = recording
    return deltas


def _with_fault(iteration, n):
    """A ``before`` hook that injects phase 44's fault at ``iteration``: exponent bit 10 of the last node's value at
    the interior point (n/4, n/4), where |u| is largest (the flip divides it by 4); returns the injector."""
    def before(ctrl):
        from pysdc_tpu_torch.resilience.fault_injection import Fault, FaultInjector

        injector = FaultInjector()
        injector.add_fault(Fault(timestep=RES_FAULT_STEP, iteration=iteration, node=M_RES,
                                 problem_pos=(n // 4, n // 4), bit=RES_FAULT_BIT))
        ctrl.hooks.append(injector)
        return injector
    return before


def _expected_launches(run, M):
    """K1 launches a run of ``GenericImplicit`` with LU implies: per attempt f(u0) and one batched f over the M
    spread nodes, then M per sweep (one node at a time)."""
    return sum(2 + M * k for _, k in run.niter)


def phase_resilience(card):
    """The Resilience campaign on the main path's width (module docstring, phase 44).  Returns (the fault-free Hot Rod
    run, Hot Rod's tolerance, K1 launches of the Hot Rod runs, the kernel coverage)."""
    import torch

    from pysdc_tpu_torch.convergence import HotRod
    from pysdc_tpu_torch.models.heat import HeatND

    n, M, Tend = N_RES, M_RES, STEPS_RES * DT_RES
    terms = HeatND(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device='cuda').A._cross_terms
    covered = _k1_check(f'heat {n}', terms, [(n, n), (M - 1, n, n), (M, n, n), (M + 1, n, n)], torch.float64, 4242)
    label = f'resilience: HeatND {n}^2 periodic fp64 M={M} RADAU-RIGHT LU, dt {DT_RES:g}, restol -1, maxiter ' \
            f'{MAXITER_RES}, {STEPS_RES} steps, Hot Rod'
    clean = _heat_run(_resilience_description(n, 'cuda', {HotRod: {}}), Tend, before=_hotrod_deltas)
    deltas = clean.extra
    if any(v for _, v in clean.restarts) or len(deltas) < STEPS_RES - 4 or not all(math.isfinite(d) for _, d in deltas):
        raise AssertionError(f'{label}: fault-free run restarted {clean.restarts} or Hot Rod saw deltas {deltas}')
    tol = 10 * max(d for _, d in deltas)
    print(f'{label}: fault-free, no restart; Hot Rod checks at t = {[t for t, _ in deltas]}, |e_em - e_ex| '
          f'{[float(f"{d:.3e}") for _, d in deltas]}: HotRod_tol = 10 x the largest = {tol:.3e}')

    faulted = _heat_run(_resilience_description(n, 'cuda', {HotRod: {'HotRod_tol': tol}}), Tend,
                        before=_with_fault(RES_FAULT_ITER, n))
    injector = faulted.extra
    step_times = sorted({t for t, _ in clean.niter})
    restarted = [t for t, v in faulted.restarts if v]
    scale = clean.uend.abs().max().item()
    diff = (faulted.uend - clean.uend).abs().max().item()
    if not injector.faults[0].happened or restarted != [step_times[RES_FAULT_STEP - 1]] \
            or not diff <= RES_UEND_RTOL * scale:
        raise AssertionError(f'{label}: fault happened {injector.faults[0].happened}, restarted steps {restarted} '
                             f'(expected step {RES_FAULT_STEP} at t = {step_times[RES_FAULT_STEP - 1]}), '
                             f'|uend - uend(fault-free)| {diff:.3e} against {RES_UEND_RTOL} x {scale:.3e}')
    # what the fault leaves: each run against the fault-free run of the same controllers (Hot Rod discards the last
    # sweep, so against u_exact the two configurations differ by that sweep's order before any fault)
    plain_clean = _heat_run(_resilience_description(n, 'cuda'), Tend)
    without = _heat_run(_resilience_description(n, 'cuda'), Tend, before=_with_fault(MAXITER_RES, n))
    err_without = (without.uend - plain_clean.uend).abs().max().item()
    exact = clean.prob.u_exact(Tend)
    exact_errs = [(run.uend - exact).abs().max().item() for run in (faulted, plain_clean, without)]
    if not without.extra.faults[0].happened or not err_without >= RES_FAULT_GAIN * max(diff, RES_UEND_RTOL * scale):
        raise AssertionError(f'{label}: without Hot Rod the fault leaves {err_without:.3e} against the fault-free run, '
                             f'with it {diff:.3e}: not {RES_FAULT_GAIN:g} x larger')
    for run, what in ((clean, 'fault-free'), (faulted, 'faulted')):
        # and the injector's one evaluation of f at the corrupted node
        expected = _expected_launches(run, M) + (1 if what == 'faulted' else 0)
        if run.launches != expected or run.applies != run.launches or run.paths != {'bands': expected, 'general': 0}:
            raise AssertionError(f'{label} ({what}): K1 launches {run.launches} by path {run.paths}, operator applies '
                                 f'{run.applies}, expected {expected} from niter {run.niter}')
        _covered_by(covered, terms, run.shapes, f'{label} ({what})')
    if faulted.uend.shape != (n, n) or faulted.uend.dtype != torch.float64 or not bool(torch.isfinite(faulted.uend).all()):
        raise AssertionError(f'{label}: uend is not a finite float64 field of the grid shape')
    print(f'{label}: exponent bit {RES_FAULT_BIT} flipped at step {RES_FAULT_STEP}, iteration {RES_FAULT_ITER}, node '
          f'{M}, point {injector.faults[0].problem_pos}: Hot Rod restarted exactly that step (t = {restarted}), niter '
          f'{[k for _, k in faulted.niter]}; |uend - uend(fault-free)| {diff:.3e} <= {RES_UEND_RTOL} x max|u|; the '
          f'fault at iteration {MAXITER_RES} without Hot Rod leaves {err_without:.3e} against its fault-free run (>= '
          f'{RES_FAULT_GAIN:g} x); |uend - u_exact| {exact_errs[0]:.3e} with Hot Rod (its last sweep discarded), '
          f'{exact_errs[1]:.3e} fault-free and {exact_errs[2]:.3e} faulted without it; K1 launches {clean.launches} / {faulted.launches} (fault-free / '
          f'faulted) = sum(2 + {M} niter) a step attempt (+1: the injector\'s f at the node), all on bands at '
          f'{sorted(faulted.shapes)} [{card}]')
    return clean, tol, clean.launches + faulted.launches, covered


def _flavour_controllers(name):
    """(convergence controllers, restol, maxiter) of an adaptivity flavour of phase 45."""
    from pysdc_tpu_torch import convergence as conv

    return {
        'AdaptivityResidual': ({conv.AdaptivityResidual: dict(e_tol=2.4e-9, max_restol=1e-9)}, -1.0, 4),
        'AdaptivityPolynomialError': ({conv.AdaptivityPolynomialError: dict(e_tol=FLAVOUR_E_TOL)}, 1e-10, 30),
        'AdaptivityExtrapolationWithinQ': ({conv.AdaptivityExtrapolationWithinQ: dict(e_tol=FLAVOUR_E_TOL)},
                                           1e-10, 30),
        'AdaptivityCollocation': ({conv.AdaptivityCollocation: dict(
            e_tol=FLAVOUR_E_TOL, adaptive_coll_params=dict(num_nodes=[M_RES - 1, M_RES]))}, 1e-10, 30),
    }[name]


FLAVOURS = ('AdaptivityResidual', 'AdaptivityPolynomialError', 'AdaptivityExtrapolationWithinQ', 'AdaptivityCollocation')
ESTIMATES = ('error_embedded_estimate_post_step', 'error_extrapolation_estimate')


def _flavour_run(name, n, device, plain=False):
    from pysdc_tpu_torch.hooks.logging_hooks import LogWork

    controllers, restol, maxiter = _flavour_controllers(name)
    desc = _resilience_description(n, device, controllers, restol=restol, maxiter=maxiter)
    return _heat_run(desc, FLAVOUR_TEND, plain=plain, hooks=(LogWork,))


def _same_flavour_run(label, got, want, est_rtol=None):
    """niter and restarts equal, dt to FLAVOUR_DT_RTOL, uend to FLAVOUR_UEND_TOL beyond what the runs' different end
    times explain (the mode decays at nu rho), with ``est_rtol`` every estimate (above the rounding floor EST_FLOOR
    max|u|); returns the uend difference and the estimates' largest relative difference."""
    def values(run, kind):
        return [v for _, v in run.entries(kind)]

    ok = [k for _, k in got.niter] == [k for _, k in want.niter] and values(got, 'restart') == values(want, 'restart')
    dts_g, dts_w = values(got, 'dt'), values(want, 'dt')
    ok = ok and len(dts_g) == len(dts_w) and all(abs(a - b) <= FLAVOUR_DT_RTOL * b for a, b in zip(dts_g, dts_w))
    diff = (got.uend.cpu() - want.uend.cpu()).abs().max().item()
    scale = want.uend.abs().max().item()
    shift = abs((got.niter[-1][0] + dts_g[-1]) - (want.niter[-1][0] + dts_w[-1])) if ok else 0.0
    rate = want.prob.nu * want.prob._rho()
    worst = 0.0
    if est_rtol is not None:
        for kind in ESTIMATES:
            a, b = values(got, kind), values(want, kind)
            ok = ok and len(a) == len(b) and all(abs(x - y) <= est_rtol * abs(y) + EST_FLOOR * scale
                                                 for x, y in zip(a, b))
            worst = max([worst] + [abs(x - y) / abs(y) for x, y in zip(a, b) if y])
    if not ok or not diff <= FLAVOUR_UEND_TOL + rate * shift * scale:
        raise AssertionError(f'{label}: niter {got.niter} / {want.niter}, restarts {got.restarts} / {want.restarts}, '
                             f'dt {dts_g} / {dts_w}, |uend diff| {diff:.3e} (end times {shift:.3e} apart), '
                             f'estimates {worst:.3e}')
    return diff, shift, worst


def phase_flavours(card, covered):
    """Phase 45: the estimators and adaptivity flavours on HeatND 2048^2 float64 with K1 against the plain apply,
    at 256^2 on the card against the CPU, and LogWork's counts.  Returns K1's launches."""
    import torch

    from pysdc_tpu_torch.models.heat import HeatND

    n = N_RES
    terms = HeatND(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device='cuda').A._cross_terms
    launches = 0
    for name in FLAVOURS:
        label = f'flavours: {name} on HeatND {n}^2 fp64 M={M_RES} LU, dt {DT_RES:g} to {FLAVOUR_TEND:g}'
        run = _flavour_run(name, n, 'cuda')
        plain = _flavour_run(name, n, 'cuda', plain=True)
        if run.launches != run.applies or run.paths != {'bands': run.launches, 'general': 0} or plain.launches:
            raise AssertionError(f'{label}: K1 launches {run.launches} by path {run.paths}, operator applies '
                                 f'{run.applies}; through the plain apply {plain.launches}')
        _covered_by(covered, terms, run.shapes, label)
        diff, shift, _ = _same_flavour_run(f'{label}, K1 against the plain apply', run, plain)
        dts = [v for _, v in run.entries('dt')]
        if name != 'AdaptivityResidual' and len({round(d, 12) for d in dts}) < 2:
            raise AssertionError(f'{label}: dt never changed: {dts}')
        launches += run.launches
        card_small, cpu_small = (_flavour_run(name, N_RES_PARITY, device) for device in ('cuda', 'cpu'))
        diff_small, shift_small, est = _same_flavour_run(f'{label}: {N_RES_PARITY}^2 card against CPU', card_small,
                                                         cpu_small, FLAVOUR_EST_RTOL)
        print(f'{label}: niter {[k for _, k in run.niter]}, restarts {sum(v for _, v in run.restarts)}, dt '
              f'{[float(f"{d:.6g}") for d in dts]}; against the plain apply: equal niter and restarts, dt to '
              f'{FLAVOUR_DT_RTOL:g}, |uend diff| {diff:.3e} <= {FLAVOUR_UEND_TOL} + nu rho max|u| x the end times\' gap '
              f'{shift:.3e}; K1 launches {run.launches} (= the '
              f'operator applies), all on bands at {sorted(run.shapes)}; at {N_RES_PARITY}^2 card against CPU: equal '
              f'niter, restarts, dt, estimates to {est:.3e} relative (<= {FLAVOUR_EST_RTOL:g} above {EST_FLOOR:g} '
              f'max|u|), |uend diff| {diff_small:.3e} (end times {shift_small:.3e} apart) [{card}]')
        if name == 'AdaptivityPolynomialError':
            work = run.entries('work_rhs')
            if sorted(run.prob.work_counters) != ['rhs'] or [v for _, v in work] != [M_RES * k for _, k in run.niter]:
                raise AssertionError(f'{label}: LogWork work_rhs {work} for niter {run.niter}, counters '
                                     f'{sorted(run.prob.work_counters)}')
            print(f'flavours: LogWork on the heat path: work_rhs {[v for _, v in work]} = {M_RES} x niter per step '
                  f'(the direct solve registers no solver counter, as in the JAX package)')
    return launches


def phase_inexactness(card, covered):
    """Phase 46: NewtonInexactness on phase 25's fully implicit Allen-Cahn path, then on the block controller's stage
    lane at 128^2 against ``ControllerNonMPI``.  Returns K1's launches of the 1024^2 run."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, ShardedController, get_sorted
    from pysdc_tpu_torch.convergence import NewtonInexactness
    from pysdc_tpu_torch.core.hooks import Hooks
    from pysdc_tpu_torch.ops import loops
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    R = loops.READ_EVERY
    params = dict(ratio=INEXACT_RATIO)
    desc = dict(_implicit_description(N_FI, torch.float64, 'cuda'), convergence_controllers={NewtonInexactness: params})
    label = f'inexactness: AllenCahnPeriodicND {N_FI}^2 fp64, NewtonInexactness(ratio {INEXACT_RATIO:g}), ' \
            f'GenericImplicit M={M_FI} LU, restol {RESTOL_FI:g}, {STEPS_FI} steps'
    ctrl = ControllerNonMPI(1, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    prob.solver_trace = []
    policy = next(C for C in ctrl.convergence_controllers if isinstance(C, NewtonInexactness))
    set_by_policy = []
    original = policy.set_tolerance

    def recording(lvl, tol):
        set_by_policy.append((float(lvl.status.residual), tol))
        return original(lvl, tol)

    policy.set_tolerance = recording
    shapes = set()
    applies = _count_applies(ctrl, shapes)
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, STEPS_FI * DT_FI)
    torch.cuda.synchronize()
    launches, paths = cross_stencil_2d.launches, dict(cross_stencil_2d.paths)
    niter = [v for _, v in get_sorted(stats, type='niter', sortby='time')]
    residuals = [v for _, v in get_sorted(stats, type='residual_post_step', sortby='time')]
    trace = list(prob.solver_trace)
    rule = [max(min(res * INEXACT_RATIO, policy.params.max_tol), policy.params.min_tol) for res, _ in set_by_policy]
    if len(niter) != STEPS_FI or not all(r <= RESTOL_FI for r in residuals) \
            or [tol for _, tol in set_by_policy] != rule or len(set_by_policy) != sum(niter) + len(niter):
        raise AssertionError(f'{label}: niter {niter}, final residuals {residuals}, tolerances {set_by_policy}')
    budget, _ = _newton_budget(trace, R)
    evals = sum(2 + M_FI * k for k in niter)
    if prob.solver_applies != budget or launches != evals + budget or applies[0] != launches \
            or paths != {'bands': launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches {launches} by path {paths}, applies {applies[0]}, expected {evals} '
                             f'eval_f + {budget} in the Newton solves ({prob.solver_applies} counted)')
    _covered_by(covered, prob.A._cross_terms, shapes, label)
    newton = [k for k, _ in trace]
    print(f'{label}: niter {niter}, final residuals {[float(f"{r:.3e}") for r in residuals]} <= {RESTOL_FI:g}; '
          f'newton_tol after each iteration (the predictor\'s check included) = max(min({INEXACT_RATIO:g} x residual, '
          f'max_tol), min_tol), '
          f'{[float(f"{t:.2e}") for _, t in set_by_policy]}; Newton iterations per solve {min(newton)}-{max(newton)}; '
          f'K1 launches {launches} = {evals} eval_f + '
          f'{budget} in the solves, all on bands at {sorted(shapes)} [{card}]')

    # the block controller's stage lane: the (P,) tolerances each sweep reads, against ControllerNonMPI(P)'s
    class Tolerances(Hooks):
        def pre_sweep(self, step, level_number):
            super().pre_sweep(step, level_number)
            lvl = step.levels[level_number]
            self.add_to_stats(process=step.status.slot, time=lvl.time, level=level_number, iter=step.status.iter,
                              sweep=lvl.status.sweep, type='newton_tol', value=float(lvl.prob.newton_tol))

    small = dict(_implicit_description(N_FI_SMALL, torch.float64, 'cuda'),
                 convergence_controllers={NewtonInexactness: params})
    Tend = P_FI * DT_FI
    serial = ControllerNonMPI(P_FI, {'logger_level': 30, 'hook_class': Tolerances}, small)
    u0 = serial.MS[0].levels[0].prob.u_exact(0.0)
    want_u, want = serial.run(u0, 0.0, Tend)
    block = ShardedController(P_FI, {'logger_level': 30, 'hook_class': Tolerances}, small)
    handed = []
    overrides = block._block_overrides

    def spy(lvl_idx):
        ov = overrides(lvl_idx)
        handed.append(ov['newton_tol'].tolist())
        if ov['newton_tol'].shape != (P_FI,) or ov['newton_tol'].dtype != torch.float64:
            raise AssertionError(f'inexactness: the block hands newton_tol as {ov["newton_tol"]}')
        return ov

    block._block_overrides = spy
    got_u, got = block.run(u0, 0.0, Tend, lane='stage')
    tol_w = {k: v for k, v in want.items() if k.type == 'newton_tol'}
    tol_g = {k: v for k, v in got.items() if k.type == 'newton_tol'}
    niter_w, niter_g = _niter(want), _niter(got)
    diff = (got_u - want_u).abs().max().item()
    # the two lanes round a residual differently by up to a few 1e-16 (|u| <= 1): ratio x RESIDUAL_FLOOR of a tolerance
    close = set(tol_w) == set(tol_g) and all(abs(tol_g[k] - v) <= 1e-9 * v + INEXACT_RATIO * RESIDUAL_FLOOR
                                             for k, v in tol_w.items())
    worst = max(abs(tol_g[k] - v) / v for k, v in tol_w.items()) if close else None
    if not close or niter_w != niter_g or not diff <= FI_FUSED_BOUND or len({tuple(h) for h in handed}) < 3:
        raise AssertionError(f'inexactness: stage lane at {N_FI_SMALL}^2: niter {niter_g} / {niter_w}, tolerances equal '
                             f'{close}, |uend diff| {diff:.3e}, (P,) tolerances handed {handed[:4]}')
    print(f'inexactness: ShardedController({P_FI}) stage lane at {N_FI_SMALL}^2 against ControllerNonMPI({P_FI}): '
          f'niter {niter_g}, every step\'s newton_tol at every sweep equal ({len(tol_g)} entries, largest relative '
          f'difference {worst:.1e}, within 1e-9 relative + {INEXACT_RATIO:g} x {RESIDUAL_FLOOR:g}), handed to '
          f'the batched Newton as ({P_FI},) float64 tensors ({len(handed)} sweeps, e.g. '
          f'{[float(f"{t:.2e}") for t in handed[len(handed) // 2]]}), |uend diff| {diff:.3e} <= {FI_FUSED_BOUND} '
          f'[{card}]')
    return launches


def _switch_cases():
    """label -> (problem, params, sweeper, sweeper params, level params, maxiter, t0, Tend, controllers)."""
    from pysdc_tpu_torch import GenericImplicit, IMEXSweeper
    from pysdc_tpu_torch.convergence import BasicRestarting, SwitchEstimator
    from pysdc_tpu_torch.models import dae_problems, odes, power_electronics
    from pysdc_tpu_torch.sweepers.dae import FullyImplicitDAE

    se = {SwitchEstimator: {}}
    return {
        'Battery': (power_electronics.Battery, {}, IMEXSweeper, dict(num_nodes=4, QI='LU'),
                    dict(dt=0.01, restol=1e-12), 10, 0.0, 0.5, se),
        'BatteryNCapacitors': (power_electronics.BatteryNCapacitors, dict(ncapacitors=2), IMEXSweeper,
                               dict(num_nodes=4, QI='LU'), dict(dt=0.01, restol=1e-12), 10, 0.0, 0.6, se),
        'DiscontinuousTestODE': (odes.DiscontinuousTestODE, {}, GenericImplicit, dict(num_nodes=3, QI='IE'),
                                 dict(dt=0.05, restol=1e-12), 10, 0.0, 2.0, se),
        'DiscontinuousTestDAE (contact)': (
            dae_problems.DiscontinuousTestDAE, dict(newton_tol=1e-6), FullyImplicitDAE, dict(num_nodes=4, QI='LU'),
            dict(dt=0.02, restol=1e-8), 5, 4.6, 4.62,
            {SwitchEstimator: {'tol': 1e-6, 'alpha': 0.97, 'contact_tol': 0.5},
             BasicRestarting: {'max_restarts': 20, 'crash_after_max_restarts': False}}),
    }


def _switch_run(case, device, num_procs=1, sharded=False, Tend=None):
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, ShardedController, get_sorted

    problem, params, sweeper, sweeper_params, level, maxiter, t0, t_end, controllers = case
    desc = dict(problem_class=problem, problem_params=dict(params, dtype=torch.float64, device=device),
                sweeper_class=sweeper, sweeper_params=sweeper_params, level_params=level,
                step_params=dict(maxiter=maxiter), convergence_controllers=controllers)
    cls = ShardedController if sharded else ControllerNonMPI
    ctrl = cls(num_procs, {'logger_level': 30}, desc)
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(t0), t0, Tend or t_end)
    probs = [S.levels[0].prob for S in ctrl.MS]
    return SimpleNamespace(ctrl=ctrl, uend=uend.cpu(), stats=stats, t_switch=[float(p.t_switch) for p in probs],
                           nswitches=[p.nswitches for p in probs],
                           niter=[(round(t, 12), k) for t, k in get_sorted(stats, type='niter', recomputed=None)],
                           dts=[v for _, v in get_sorted(stats, type='dt', recomputed=None)])


def _same_switch_run(label, got, want):
    diff = (got.uend - want.uend).abs().max().item()
    ts = max((abs(a - b) for a, b in zip(got.t_switch, want.t_switch) if math.isfinite(b)), default=0.0)
    ok = got.niter == want.niter and got.nswitches == want.nswitches and len(got.dts) == len(want.dts)
    ok = ok and all(math.isinf(a) == math.isinf(b) for a, b in zip(got.t_switch, want.t_switch))
    ok = ok and all(abs(a - b) <= 1e-12 * max(1.0, abs(b)) for a, b in zip(got.dts, want.dts))
    if not ok or not ts <= SWITCH_T_TOL or not diff <= PARITY_UEND_TOL * max(1.0, want.uend.abs().max().item()):
        raise AssertionError(f'{label}: niter {got.niter} / {want.niter}, nswitches {got.nswitches} / {want.nswitches}, '
                             f't_switch {got.t_switch} / {want.t_switch}, |uend diff| {diff:.3e}')
    return diff, ts


def phase_switch(card):
    """Phase 47: the switch estimator and the power-electronics problems, float64 card against CPU; the block
    controller's stage lane with the (P,) t_switch against ControllerNonMPI on the card."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for label, case in _switch_cases().items():
            t0 = time.perf_counter()
            on_card, on_cpu = _switch_run(case, 'cuda'), _switch_run(case, 'cpu')
            diff, ts = _same_switch_run(f'switch: {label}', on_card, on_cpu)
            print(f'switch: {label} fp64 with SwitchEstimator: {len(on_card.niter)} step attempts, nswitches '
                  f'{on_card.nswitches[0]}, t_switch {on_card.t_switch[0]:.15g} (card) - CPU {ts:.3e} <= '
                  f'{SWITCH_T_TOL:g}, equal niter and dt, |uend diff| {diff:.3e}; '
                  f'{time.perf_counter() - t0:.1f} s for both runs [{card}]')
    finally:
        torch.set_num_threads(threads)
    case = _switch_cases()['DiscontinuousTestODE']
    serial = _switch_run(case, 'cuda', num_procs=SWITCH_P, Tend=SWITCH_BLOCK_TEND)
    block = _switch_run(case, 'cuda', num_procs=SWITCH_P, sharded=True, Tend=SWITCH_BLOCK_TEND)
    lanes = {v for k, v in block.stats.items() if k.type == 'lane'}
    diff, ts = _same_switch_run('switch: ShardedController stage lane', block, serial)
    kinds = sorted({k.type for k in serial.stats if not k.type.startswith('timing')})
    for kind in kinds:
        w = sorted((k, v) for k, v in serial.stats.items() if k.type == kind)
        g = sorted((k, v) for k, v in block.stats.items() if k.type == kind)
        if [k for k, _ in w] != [k for k, _ in g] or not all(
                a == b if not isinstance(a, float) else abs(a - b) <= 1e-12 * max(1.0, abs(a)) for (_, a), (_, b) in
                zip(w, g)):
            raise AssertionError(f'switch: ShardedController({SWITCH_P}) stage lane: stats {kind} differ')
    if lanes != {'stage'} or not any(math.isfinite(t) for t in block.t_switch):
        raise AssertionError(f'switch: ShardedController({SWITCH_P}) took lanes {lanes}, t_switch {block.t_switch}')
    print(f'switch: ShardedController({SWITCH_P}).run on DiscontinuousTestODE to {SWITCH_BLOCK_TEND:g}: lane "stage" '
          f'(the fused lanes refuse SwitchEstimator by name), t_switch per step {block.t_switch} handed to the batched '
          f'functions as a ({SWITCH_P},) float64 tensor; every stats entry ({", ".join(kinds)}) equal to '
          f'ControllerNonMPI({SWITCH_P})\'s, |uend diff| {diff:.3e} [{card}]')


class _ReadCounter:
    """Counts the host reads of device scalars (``item``, ``float``, ``bool`` of a tensor) while active, with those
    made inside an estimator apart."""

    def __init__(self):
        import torch

        self.total = self.estimators = 0
        self.in_estimator = False
        self._saved = {name: getattr(torch.Tensor, name) for name in ('item', '__float__', '__bool__')}

    def __enter__(self):
        import torch

        for name, fn in self._saved.items():
            def counted(t, *args, fn=fn, **kwargs):
                if t.is_cuda:
                    self.total += 1
                    self.estimators += self.in_estimator
                return fn(t, *args, **kwargs)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        import torch

        for name, fn in self._saved.items():
            setattr(torch.Tensor, name, fn)


def _annotate_estimators(ctrl, reads=None):
    """Run the estimators and Hot Rod of ``ctrl`` under a ``torch.profiler`` range named 'estimators' (and mark them
    for ``reads``)."""
    import torch

    from pysdc_tpu_torch.convergence import EstimateEmbeddedError, EstimateExtrapolationErrorNonMPI, HotRod

    for C in ctrl.convergence_controllers:
        if isinstance(C, (EstimateEmbeddedError, EstimateExtrapolationErrorNonMPI, HotRod)):
            for name in ('post_iteration_processing', 'determine_restart'):
                fn = getattr(C, name)

                def wrapped(*args, fn=fn, **kwargs):
                    if reads is not None:
                        reads.in_estimator = True
                    try:
                        with torch.profiler.record_function('estimators'):
                            return fn(*args, **kwargs)
                    finally:
                        if reads is not None:
                            reads.in_estimator = False
                setattr(C, name, wrapped)


def phase_resilience_times(hotrod_tol, card):
    """Phase 48: one step of phase 44's run with and without Hot Rod and its estimators.  The extrapolation estimate
    needs the four previous steps stored, so each controller first runs five steps; then step 6 is timed (CUDA events
    and the host clock), step 7 runs under the profiler (busy time, idle share, the estimators' share of the busy time
    by their profiler range) and step 8 counts the host reads."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pysdc_tpu_torch import ControllerNonMPI
    from pysdc_tpu_torch.convergence import HotRod

    def device_us(e, own=True):
        if own:
            return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0.0)
        return getattr(e, 'device_time_total', None) or getattr(e, 'cuda_time_total', 0.0)

    results = {}
    for label, controllers in (('with Hot Rod', {HotRod: {'HotRod_tol': hotrod_tol}}), ('without', {})):
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, _resilience_description(N_RES, 'cuda', controllers))
        reads = _ReadCounter()
        _annotate_estimators(ctrl, reads)
        u = ctrl.MS[0].levels[0].prob.u_exact(0.0)
        u, _ = ctrl.run(u, 0.0, 5 * DT_RES)
        t = 5 * DT_RES
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        u, _ = ctrl.run(u, t, t + DT_RES)
        end.record()
        torch.cuda.synchronize()
        host_ms, card_ms = 1e3 * (time.perf_counter() - h0), start.elapsed_time(end)
        t += DT_RES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            u, _ = ctrl.run(u, t, t + DT_RES)
            torch.cuda.synchronize()
        t += DT_RES
        events = prof.key_averages()
        # the kernels and copies themselves (the host ops that launched them carry the same time again)
        busy_ms = sum(device_us(e) for e in events if e.device_type == DeviceType.CUDA) / 1e3
        if not busy_ms > 0:
            raise AssertionError('resilience times: the profiler saw no device time')
        est_ms = sum(device_us(e, own=False) for e in events if e.key == 'estimators') / 1e3
        with reads:
            u, _ = ctrl.run(u, t, t + DT_RES)
        results[label] = (card_ms, host_ms, busy_ms, est_ms, reads.total, reads.estimators)
    (c1, h1, b1, e1, r1, re1), (c0, h0_, b0, _, r0, _) = results['with Hot Rod'], results['without']
    print(f'resilience times: one step of HeatND {N_RES}^2 fp64 M={M_RES} LU, {MAXITER_RES} sweeps: with Hot Rod and '
          f'its estimators {c1:.3f} ms on the card, {h1:.3f} ms on the host clock, {b1:.3f} ms busy (idle '
          f'{100 * (1 - b1 / c1):.0f}%), the estimators\' range {e1:.3f} ms of the busy time ({100 * e1 / b1:.1f}%), '
          f'{r1} host reads ({re1} of them the estimators\'); without: {c0:.3f} ms on the card, {h0_:.3f} ms on the '
          f'host clock, {b0:.3f} ms busy (idle {100 * (1 - b0 / c0):.0f}%), {r0} host reads; Hot Rod costs '
          f'{c1 / c0:.2f}x on the card [{card}]')
    return results



# -- exponential SDC on the Monodomain equation, the FD/FFT, circuit and spectral models (phases 49-54) ----------------
# the Monodomain path: step 21's iteration_comparison (examples/step_21_monodomain_campaign.py:54-79) in 2D at the heat
# path's width, Hodgkin-Huxley, float64 (restol 1e-8 sits below float32 roundoff of V ~ 75: 4.5e-6)
N_MONO, M_MONO, DT_MONO, STEPS_MONO, RESTOL_MONO, MAXITER_MONO = 2048, 3, 0.05, 4, 1e-8, 50
STEP21_NITER_RATIO, STEP21_FRONT = 1.5, 0.05  # mean niter ESDC / IMEX below; max|V_esdc - V_imex| / max|V| below
# step 21's niter gate holds in 2D at its own resolution (128^2: 11.25 against 8.75 sweeps), not at 256^2 and up, in
# the JAX package as in the port (256^2 on the CPU: 14.5 against 8.75, equal counts in both packages): QI='IE'
# preconditions the stiff diffusion (dt lambda_max = -1700 at 2048^2) worse than the IMEX run's LU; phase 51 holds it
# at 128^2, phase 50 holds the front agreement and reports the ratio
N_MONO_PARITY, N_IONIC, DT_TT = 128, 256, 0.02  # card against CPU; the ionic models' field; ten Tusscher's dt
IONIC_RTOL = 1e-12  # each ionic model, card against CPU, relative to each component's largest value (or the
# stated floor of phase 51 where a formula amplifies rounding)
MODELS_RTOL = 1e-11  # every parity of phases 51-53, relative to max|uend| (or the floor a case states)
# Navier-Stokes: Taylor-Green at the main path's width, tests/test_navier_stokes.py:35-40's bound against u_exact
N_NS, DT_NS, STEPS_NS, RESTOL_NS, NS_EXACT_BOUND, N_NS_PARITY = 2048, 1e-3, 4, 1e-10, 1e-9, 256


def _mono_description(n, device, esdc=True, model='hodgkinhuxley', dt=DT_MONO, **problem):
    import torch

    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.models.monodomain import MonodomainIMEX, MonodomainIMEXEXP
    from pysdc_tpu_torch.sweepers import IMEXEXPSweeper

    return dict(
        problem_class=MonodomainIMEXEXP if esdc else MonodomainIMEX,
        problem_params=dict(nvars=(n, n), ionic_model=model, diff=0.1, L=10.0, dtype=torch.float64, device=device,
                            **problem),
        sweeper_class=IMEXEXPSweeper if esdc else IMEXSweeper,
        sweeper_params=dict(num_nodes=M_MONO, quad_type='RADAU-RIGHT', QI='IE' if esdc else 'LU'),
        level_params=dict(dt=dt, restol=RESTOL_MONO),
        step_params=dict(maxiter=MAXITER_MONO),
    )


def _mono_run(desc, steps, plain=False):
    """``desc`` through :func:`_heat_run` for ``steps`` steps (K1's counts set to 0 just before the run and read
    just after, every operator apply counted with its shape), with ``niter`` as the list of counts and the wall time."""
    start = time.perf_counter()
    run = _heat_run(desc, steps * desc['level_params']['dt'], plain=plain)
    run.wall = time.perf_counter() - start
    run.niter = [k for _, k in run.niter]
    return run


def phase_monodomain_kernels():
    """Phase 49: K1 against its plain version at the Monodomain paths' shapes and taps (the potential plane and the
    M spread nodes' planes, 2048^2 and 128^2), float64, on bands and with the general path forced."""
    import torch

    from pysdc_tpu_torch.models.monodomain import MonodomainIMEXEXP

    covered = {}
    for n in sorted({N_MONO, N_MONO_PARITY}):
        terms = MonodomainIMEXEXP(nvars=(n, n), dtype=torch.float64, device='cuda').A._cross_terms
        covered.update(_k1_check(f'monodomain {n}', terms, [(n, n), (M_MONO, n, n)], torch.float64, 4900 + n,
                                 label='monodomain kernels'))
    return covered


def phase_monodomain(card, covered):
    """Phase 50, the slice's main path (module docstring).  Returns the K1 launches of the ESDC and IMEX runs."""
    import torch

    label = f'monodomain: HH {N_MONO}^2 fp64, dt {DT_MONO}, restol {RESTOL_MONO:g}, {STEPS_MONO} steps'
    runs = {}
    for name, esdc in (('esdc', True), ('imex', False)):
        run = runs[name] = _mono_run(_mono_description(N_MONO, 'cuda', esdc=esdc), STEPS_MONO)
        expected = sum(2 + M_MONO * k for k in run.niter)  # f(u0), one batched f over the spread nodes, M a sweep
        if len(run.niter) != STEPS_MONO or max(run.niter) >= MAXITER_MONO:
            raise AssertionError(f'{label} {name}: niter {run.niter}, not every step converged')
        if run.launches != expected or run.applies != expected or run.paths != {'bands': expected, 'general': 0}:
            raise AssertionError(f'{label} {name}: K1 launches {run.launches} by path {run.paths}, operator applies '
                                 f'{run.applies}, expected {expected} from niter {run.niter}')
        _covered_by(covered, run.prob.A._cross_terms, run.shapes, f'{label} {name}')
        u = run.uend
        if u.shape != (4, N_MONO, N_MONO) or u.dtype != torch.float64 or not bool(torch.isfinite(u).all()):
            raise AssertionError(f'{label} {name}: uend is not a finite float64 field of the state shape')
    esdc, imex = runs['esdc'], runs['imex']
    # K1 against the plain apply: each apply differs by at most 2 n_terms eps sum|c| max|V|, and a step integrates f
    # over dt, so the steps' end values move by at most steps dt times that (10x room)
    terms = esdc.prob.A._cross_terms
    n_terms = sum(len(offs) for _, offs in terms)
    sum_c = sum(abs(c) for coeff, _ in terms for c in coeff)
    v_max = max(esdc.uend[0].abs().max().item(), esdc.prob.u_exact(0.0)[0].abs().max().item())
    per_apply = 2 * n_terms * torch.finfo(torch.float64).eps * sum_c * v_max
    tol = 10 * STEPS_MONO * DT_MONO * per_apply
    plain = _mono_run(_mono_description(N_MONO, 'cuda'), STEPS_MONO, plain=True)
    diff = (plain.uend - esdc.uend).abs().max().item()
    if plain.launches != 0 or plain.niter != esdc.niter or not diff <= tol:
        raise AssertionError(f'{label} esdc against the plain apply: niter {plain.niter} / {esdc.niter}, K1 launches '
                             f'{plain.launches}, |uend - uend_plain| {diff:.3e} > {tol:.3e}')
    del plain
    mean_e, mean_i = float(np.mean(esdc.niter)), float(np.mean(imex.niter))
    front = (esdc.uend[0] - imex.uend[0]).abs().max().item()
    v_scale = imex.uend[0].abs().max().item()
    if not front < STEP21_FRONT * v_scale:
        raise AssertionError(f'{label}: step 21\'s front gate: max|V_esdc - V_imex| {front:.3e} against {STEP21_FRONT} '
                             f'x {v_scale:.1f}')
    print(f'{label}: ESDC (IMEXEXPSweeper M={M_MONO} IE) niter {esdc.niter}, IMEX (IMEXSweeper M={M_MONO} LU) niter '
          f'{imex.niter}; K1 launches {esdc.launches} / {imex.launches} = sum(2 + {M_MONO} niter), all on bands at '
          f'{sorted(esdc.shapes | imex.shapes)}; ESDC against the plain apply: equal niter, |uend - uend_plain| '
          f'{diff:.3e} <= {tol:.3e} (10 x {STEPS_MONO} steps x dt x 2 n_terms eps sum|c| max|V| = {per_apply:.3e} an '
          f'apply); step 21: max|V_esdc - V_imex| {front:.3e} < {STEP21_FRONT} x max|V| {v_scale:.1f}, mean niter '
          f'{mean_e:.2f} against {mean_i:.2f} ({mean_e / mean_i:.2f}x; its 1.5x gate is phase 51\'s, at 128^2); '
          f'wall {esdc.wall:.2f} / {imex.wall:.2f} s incl. first '
          f'calls [{card}]')
    return {'esdc': esdc.launches, 'imex': imex.launches}


def _rel_err(got, want):
    return (got.cpu() - want.cpu()).abs().max().item() / max(want.abs().max().item(), 1e-300)


def phase_monodomain_parity():
    """Phase 51: float64 card against the port's CPU run: the Monodomain path at 128^2 (ESDC and IMEX, 4 steps), ten
    Tusscher with ESDC (2 steps, tests/test_monodomain.py:218's setup), and each ionic model's four functions at
    (size, 256, 256)."""
    import torch

    from pysdc_tpu_torch.models.ionic import TORCH_MODELS

    niter = {}
    for name, desc, steps in (
            ('HH ESDC', lambda d: _mono_description(N_MONO_PARITY, d), STEPS_MONO),
            ('HH IMEX', lambda d: _mono_description(N_MONO_PARITY, d, esdc=False), STEPS_MONO),
            ('ten Tusscher ESDC', lambda d: _mono_description(N_MONO_PARITY, d, model='tentusscher', dt=DT_TT,
                                                              stim_ampl=40.0), 2)):
        card_run, cpu_run = _mono_run(desc('cuda'), steps), _mono_run(desc('cpu'), steps)
        err = _rel_err(card_run.uend, cpu_run.uend)
        if card_run.niter != cpu_run.niter or not err <= MODELS_RTOL:
            raise AssertionError(f'monodomain parity {name} {N_MONO_PARITY}^2: niter card {card_run.niter} cpu '
                                 f'{cpu_run.niter}, uend rel diff {err:.3e} > {MODELS_RTOL}')
        niter[name] = card_run.niter
        print(f'monodomain parity: {name} {N_MONO_PARITY}^2 fp64, {steps} steps, niter {card_run.niter} on card and '
              f'CPU, uend rel diff {err:.3e} <= {MODELS_RTOL}')
    mean_e, mean_i = float(np.mean(niter['HH ESDC'])), float(np.mean(niter['HH IMEX']))
    if not mean_e < STEP21_NITER_RATIO * mean_i:
        raise AssertionError(f'monodomain parity: step 21\'s niter gate at {N_MONO_PARITY}^2: mean niter ESDC '
                             f'{mean_e:.2f} against IMEX {mean_i:.2f}')
    print(f'monodomain parity: step 21\'s niter gate at {N_MONO_PARITY}^2: mean niter ESDC {mean_e:.2f} < '
          f'{STEP21_NITER_RATIO} x IMEX {mean_i:.2f}')
    # the block controller, which the JAX package runs on these problems: 'auto' takes the fused lane (the sweeps
    # captured as CUDA graphs on the card) and equals the step-by-step run of the same 4 steps
    from pysdc_tpu_torch import ControllerNonMPI, ShardedController

    for name, esdc in (('ESDC', True), ('IMEX', False)):
        desc = _mono_description(N_MONO_PARITY, 'cuda', esdc=esdc)
        serial = ControllerNonMPI(4, {'logger_level': 30}, desc)
        u0 = serial.MS[0].levels[0].prob.u_exact(0.0)
        want, want_stats = serial.run(u0, 0.0, 4 * DT_MONO)
        block = ShardedController(4, {'logger_level': 30}, desc)
        got, stats = block.run(u0, 0.0, 4 * DT_MONO)
        lanes = [v for k, v in stats.items() if k.type == 'lane']
        err = _rel_err(got, want)
        if lanes != ['fused'] or _niter(stats) != _niter(want_stats) or not err <= MODELS_RTOL:
            raise AssertionError(f'monodomain {name} {N_MONO_PARITY}^2 through ShardedController(4).run: lanes {lanes}, '
                                 f'niter {_niter(stats)} against {_niter(want_stats)}, uend rel diff {err:.3e}')
        print(f'monodomain parity: {name} {N_MONO_PARITY}^2 through ShardedController(4).run: lane {lanes[0]} (CUDA '
              f'graphs), niter {_niter(stats)} equal to ControllerNonMPI(4)\'s on the card, uend rel diff {err:.3e} <= '
              f'{MODELS_RTOL}, host reads {dict(block.host_reads)}')
    rng = np.random.default_rng(51)
    worst = {}
    for name, cls in TORCH_MODELS.items():
        model = cls()
        y0 = model.initial_values().numpy()
        y = y0[:, None, None] * (1.0 + 0.05 * rng.standard_normal((model.size, N_IONIC, N_IONIC)))
        y[0] = rng.uniform(-90.0, 40.0, (N_IONIC, N_IONIC))  # V through every rate branch
        if model.size > 4:
            y[1:] = np.abs(y[1:]) + 1e-6  # gates and concentrations stay positive
        out = {}
        # the CPU's own sensitivity: its results again with every input moved by 4 eps relative.  Where a formula
        # amplifies rounding (Courtemanche's removable singularities x / (1 - e^-x) at six voltages, near which an
        # ulp of exp is worth eps / |x|), the card's and the CPU's exp and log, an ulp apart, differ by as much
        for key, inputs in (('cuda', y), ('cpu', y), ('probe', y * (1.0 + 4 * np.finfo(float).eps))):
            t = torch.as_tensor(inputs, device='cpu' if key == 'probe' else key)
            out[key] = [model.f(t), model.f_expl(t), model.lmbda_exp(t), *model.lmbda_yinf_exp(t)]
        errs, floors = [], []
        for got, want, moved in zip(out['cuda'], out['cpu'], out['probe']):
            scale = want.abs().flatten(1).amax(dim=1).clamp_min(1e-300).reshape((-1, 1, 1))
            errs.append(((got.cpu() - want) / scale).abs().max().item())
            floors.append(max(IONIC_RTOL, 4 * ((moved - want) / scale).abs().max().item()))
        worst[name] = (max(errs), max(floors))
        if not all(e <= f for e, f in zip(errs, floors)):
            raise AssertionError(f'ionic {name}: f, f_expl, lmbda_exp, lambda / y_inf card against CPU: {errs} > '
                                 f'{floors} (relative to each component\'s largest value)')
    print(f'monodomain parity: the ionic models\' f, f_expl, lmbda_exp and lmbda_yinf_exp at (size, {N_IONIC}, '
          f'{N_IONIC}) fp64, card against CPU, worst error relative to each component\'s largest value against its '
          f'floor (the larger of {IONIC_RTOL} and 4 x what a 4 eps change of the inputs moves the CPU\'s result): '
          + ', '.join(f'{k} {e:.2e} <= {f:.2e}' for k, (e, f) in worst.items()))


def phase_navier_stokes(card):
    """Phase 52: Taylor-Green at 2048^2 float64 (IMEX M=3 LU, dt 1e-3, restol 1e-10, 4 steps) against ``u_exact``;
    the random-mode flow at 256^2 card against CPU."""
    import torch

    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.models.navier_stokes import NavierStokesVorticity2D

    from pysdc_tpu_torch import ControllerNonMPI

    sp = dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE')
    ctrl = ControllerNonMPI(1, {'logger_level': 30}, dict(
        problem_class=NavierStokesVorticity2D,
        problem_params=dict(nvars=(N_NS, N_NS), nu=1e-2, dtype=torch.float64, device='cuda'), sweeper_class=IMEXSweeper,
        sweeper_params=sp, level_params=dict(dt=DT_NS, restol=RESTOL_NS), step_params=dict(maxiter=30)))
    prob = ctrl.MS[0].levels[0].prob
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, STEPS_NS * DT_NS)
    niter = _niter(stats)
    err = (uend - prob.u_exact(STEPS_NS * DT_NS)).abs().max().item()
    if len(niter) != STEPS_NS or max(niter) >= 30 or not err <= NS_EXACT_BOUND:
        raise AssertionError(f'navier-stokes {N_NS}^2: niter {niter}, |uend - u_exact| {err:.3e} > {NS_EXACT_BOUND}')
    params = dict(nvars=(N_NS_PARITY, N_NS_PARITY), nu=5e-3)
    level = dict(dt=0.02, restol=1e-9)
    on_card, on_cpu = _nonmpi_pair(NavierStokesVorticity2D, params, IMEXSweeper, sp, level, 30, 3 * 0.02,
                             u0=lambda d: NavierStokesVorticity2D(**params, dtype=torch.float64, device=d).u_exact(
                                 0.0, kind='random'))
    rel = _rel_err(on_card.uend, on_cpu.uend)
    if on_card.niter != on_cpu.niter or not rel <= MODELS_RTOL:
        raise AssertionError(f'navier-stokes random {N_NS_PARITY}^2: niter card {on_card.niter} cpu {on_cpu.niter}, uend '
                             f'rel diff {rel:.3e} > {MODELS_RTOL}')
    print(f'navier-stokes: Taylor-Green {N_NS}^2 fp64 IMEX M=3 LU dt {DT_NS:g} restol {RESTOL_NS:g}, {STEPS_NS} '
          f'steps, niter {niter}, |uend - u_exact| {err:.3e} <= {NS_EXACT_BOUND}; random modes {N_NS_PARITY}^2, 3 '
          f'steps, niter {on_card.niter} on card and CPU, uend rel diff {rel:.3e} <= {MODELS_RTOL} [{card}]')


def _model_cases():
    """name -> (problem class, params, sweeper class, sweeper params, level params, maxiter, Tend): the other models
    at their JAX tests' sizes or smaller (tests/test_wscc9_rdc.py:58, tests/test_quench_boussinesq.py:13-116,
    tests/test_more_components.py:131, tests/test_spectral.py:46-256)."""
    from pysdc_tpu_torch import GenericImplicit, IMEXSweeper
    from pysdc_tpu_torch import models
    from pysdc_tpu_torch.sweepers.dae import FullyImplicitDAE

    lu, imex = dict(num_nodes=3, QI='LU'), dict(num_nodes=3, QI='LU', QE='EE')
    pic = dict(num_nodes=3, QI='LU', QE='PIC')
    return {
        'WSCC9 FullyImplicitDAE': (models.WSCC9BusSystem, dict(newton_tol=1e-9), FullyImplicitDAE,
                                   dict(num_nodes=2, QI='IE'), dict(dt=0.01, restol=5e-9), 40, 0.02),
        'Quench 128': (models.Quench, dict(nvars=128), GenericImplicit, lu, dict(dt=10.0, restol=1e-8), 20, 30.0),
        'QuenchIMEX 128': (models.QuenchIMEX, dict(nvars=128), IMEXSweeper, imex, dict(dt=5.0, restol=1e-10), 25,
                           20.0),
        'acoustic 512': (models.AcousticAdvection1D, dict(nvars=512, cs=1.0, cadv=0.1, waveno=5), IMEXSweeper, imex,
                         dict(dt=1 / 256, restol=1e-11), 20, 4 / 256),
        'Boussinesq (150, 20)': (models.Boussinesq2DIMEX, dict(nvars=(150, 20)), IMEXSweeper, imex,
                                 dict(dt=1.0, restol=1e-11), 15, 3.0),
        'HeatChebyshev1D 32': (models.HeatChebyshev1D, dict(nvars=32), GenericImplicit, lu,
                               dict(dt=0.05, restol=1e-11), 30, 0.1),
        'Burgers1D 48': (models.Burgers1D, dict(nvars=48), IMEXSweeper, imex, dict(dt=0.01, restol=-1.0), 6, 0.02),
        'Heat2DChebyshev 24^2': (models.Heat2DChebyshev, dict(nx=24, nz=24), GenericImplicit, lu,
                                 dict(dt=0.05, restol=-1.0), 6, 0.1),
        'RayleighBenard (64, 32)': (models.RayleighBenard, dict(nx=64, nz=32), IMEXSweeper, pic,
                                    dict(dt=0.02, restol=-1.0), 4, 0.06),
        'RayleighBenard3D (16, 16, 8)': (models.RayleighBenard3D, dict(nx=16, ny=16, nz=8, Rayleigh=2e4),
                                         IMEXSweeper, dict(pic, num_nodes=2), dict(dt=0.05, restol=-1.0), 4, 0.1),
    }


def phase_models_parity():
    """Phase 53: every other new model, float64 card against CPU through ``ControllerNonMPI(1, ...)``: equal
    ``niter``, ``uend`` to MODELS_RTOL relative.  Every case runs before the phase judges, so one run shows them all."""
    failed, lines = [], []
    for name, (problem, params, sweeper, sp, level, maxiter, Tend) in _model_cases().items():
        start = time.perf_counter()
        card, cpu = _nonmpi_pair(problem, params, sweeper, sp, level, maxiter, Tend)
        rel = _rel_err(card.uend, cpu.uend)
        ok = card.niter == cpu.niter and rel <= MODELS_RTOL and bool(card.uend.isfinite().all())
        lines.append(f'{name}: niter {card.niter}{"" if card.niter == cpu.niter else f" (CPU {cpu.niter})"}, uend rel '
                     f'diff {rel:.3e} ({time.perf_counter() - start:.1f} s)')
        if not ok:
            failed.append(name)
    print('models parity: fp64 card against CPU: ' + '; '.join(lines))
    if failed:
        raise AssertionError(f'models parity: {failed} differ beyond equal niter and {MODELS_RTOL}')


def _spans(ranges):
    """Wrap the methods of ``ranges`` (label -> [(object, method names)]) so that each call records a pair of CUDA
    events; returns label -> the list of pairs, and a function that takes the wrappers away."""
    import torch

    spans = {label: [] for label in ranges}
    wrapped = []
    for label, targets in ranges.items():
        for obj, names in targets:
            for name in names:
                fn = getattr(obj, name)

                def timed(*args, fn=fn, out=spans[label], **kwargs):
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    result = fn(*args, **kwargs)
                    end.record()
                    out.append((start, end))
                    return result
                setattr(obj, name, timed)
                wrapped.append((obj, name))

    def restore():
        for obj, name in wrapped:
            delattr(obj, name)
    return spans, restore


def _launched_ops(fn):
    """The operations that are not views among the ATen operations of one call of ``fn()`` (each an elementwise kernel
    on the card for the ionic models), counted by a dispatch mode: exact, where the profiler drops events."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _cuda_events(fn):
    """The device's events (kernels and copies), averaged by name, over one call of ``fn()``, from a profiler that
    traces the CPU and the card (:func:`_profiled`)."""
    from torch.autograd import DeviceType

    return [e for e in _profiled(fn, cpu=True) if e.device_type == DeviceType.CUDA]


def _step_times(ctrl, u, t, dt, ranges=None):
    """One step of ``ctrl`` from ``(u, t)`` after one untimed step: ms on the card (CUDA events) and the host clock,
    its niter and peak memory, and the card's ms in each range of ``ranges`` (CUDA events around every call of its
    methods); then the same step again from the same state under the profiler: busy ms and kernels, cuFFT's ms."""
    import torch

    from pysdc_tpu_torch import get_sorted

    def device_us(e):
        return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0.0)

    u, _ = ctrl.run(u, t, t + dt)
    t += dt
    spans, restore = _spans(ranges or {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    start.record()
    _, stats = ctrl.run(u, t, t + dt)
    end.record()
    torch.cuda.synchronize()
    host_ms, card_ms = 1e3 * (time.perf_counter() - h0), start.elapsed_time(end)
    restore()
    peak = torch.cuda.max_memory_allocated() / 2**20
    niter = [v for _, v in get_sorted(stats, type='niter')]
    split = {label: sum(a.elapsed_time(b) for a, b in pairs) for label, pairs in spans.items()}
    holder = {}

    def step():
        holder['stats'] = ctrl.run(u, t, t + dt)[1]

    kernels = _cuda_events(step)
    stats = holder['stats']
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    if not busy_ms > 0:
        raise AssertionError('monodomain times: the profiler saw no device time')
    profiled = dict(cuFFT=sum(device_us(e) for e in kernels if 'fft' in e.key.lower()) / 1e3,
                    K1=sum(device_us(e) for e in kernels if 'cross_stencil' in e.key.lower()) / 1e3)
    return SimpleNamespace(card_ms=card_ms, host_ms=host_ms, peak_mib=peak, niter=niter, busy_ms=busy_ms,
                           kernels=sum(e.count for e in kernels), split=split, profiled=profiled,
                           profiled_niter=[v for _, v in get_sorted(stats, type='niter')])


def phase_monodomain_times(card):
    """Phase 54: one step of the ESDC and of the IMEX path at 2048^2 and one Navier-Stokes step at 2048^2 (module
    docstring): ms on the card and the host clock; the card's ms in the phi tables (``_lambda_qmat`` and
    ``_lambda_phi_one``) and in the
    ionic RHS (CUDA events around each call); from the profiler over the same step, busy ms, kernels and cuFFT's ms;
    K1 by CUDA events (launches x its ms an apply); the rest, the idle share, peak memory, and the ionic RHS's
    operations an evaluation (each an elementwise kernel)."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, IMEXSweeper
    from pysdc_tpu_torch.models.navier_stokes import NavierStokesVorticity2D
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    results = {}
    for name, esdc in (('ESDC', True), ('IMEX', False)):
        ctrl = ControllerNonMPI(1, {'logger_level': 30}, _mono_description(N_MONO, 'cuda', esdc=esdc))
        prob, sweep = ctrl.MS[0].levels[0].prob, ctrl.MS[0].levels[0].sweep
        ionic = ('f_expl', 'lmbda_yinf_exp') if esdc else ('f',)
        ranges = {'ionic RHS': [(prob.model, ionic)]}
        if esdc:
            ranges['phi tables'] = [(sweep, ('_lambda_qmat', '_lambda_phi_one'))]
        y = prob.u_exact(0.0)
        evaluation = lambda: [getattr(prob.model, f)(y) for f in ionic]  # noqa: E731
        per_eval = (_launched_ops(evaluation), sum(e.count for e in _cuda_events(evaluation)))
        terms = prob.A._cross_terms
        v = y[0].contiguous()
        k1_ms = _event_ms(lambda i: cross_stencil_2d(v, terms), 20)
        vs = torch.stack([v] * M_MONO)
        k1_batch_ms = _event_ms(lambda i: cross_stencil_2d(vs, terms), 20)
        u = ctrl.run(y, 0.0, DT_MONO)[0]
        r = _step_times(ctrl, u, DT_MONO, DT_MONO, ranges=ranges)
        # the step's applies: f(u0), the spread's one over M planes, M a sweep
        r.split['K1'] = sum(k1_batch_ms + (1 + M_MONO * k) * k1_ms for k in r.niter)
        r.per_eval, r.k1_ms, r.k1_batch_ms = per_eval, k1_ms, k1_batch_ms
        results[name] = r
        del ctrl, prob, sweep, y, v, vs, u
        torch.cuda.empty_cache()
    ns = ControllerNonMPI(1, {'logger_level': 30}, dict(
        problem_class=NavierStokesVorticity2D,
        problem_params=dict(nvars=(N_NS, N_NS), nu=1e-2, dtype=torch.float64, device='cuda'),
        sweeper_class=IMEXSweeper, sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
        level_params=dict(dt=DT_NS, restol=RESTOL_NS), step_params=dict(maxiter=30)))
    results['Navier-Stokes'] = _step_times(ns, ns.MS[0].levels[0].prob.u_exact(0.0), 0.0, DT_NS)
    for name, r in results.items():
        parts = dict(r.split, cuFFT=r.profiled['cuFFT'])
        # the profiler's busy time holds K1 as far as it saw it: K1 by CUDA events in its place
        busy = r.busy_ms - r.profiled['K1'] + parts.get('K1', 0.0)
        parts['rest'] = busy - sum(parts.values())
        extra = ''
        if name != 'Navier-Stokes':
            extra = (f'; K1 {r.k1_ms:.4f} ms an apply at ({N_MONO}, {N_MONO}), {r.k1_batch_ms:.4f} ms at ({M_MONO}, '
                     f'{N_MONO}, {N_MONO}) (CUDA events; the profiler saw {r.profiled["K1"]:.3f} ms of it); the ionic '
                     f'RHS launches {r.per_eval[0]} operations an evaluation (a dispatch mode\'s count; the profiler saw '
                     f'{r.per_eval[1]} kernels)')
        print(f'monodomain times: one {name} step at {N_NS if name == "Navier-Stokes" else N_MONO}^2 fp64 (niter '
              f'{r.niter}, profiled again {r.profiled_niter}): {r.card_ms:.3f} ms on the card, {r.host_ms:.3f} ms on '
              f'the host clock; busy {busy:.3f} ms in {r.kernels} kernels (the profiler\'s, K1 by CUDA events; idle '
              f'{100 * (1 - busy / r.card_ms):.0f}%); the card\'s ms by kind: '
              + ', '.join(f'{k} {v:.3f} ({100 * v / r.card_ms:.1f}%)' for k, v in parts.items())
              + f'; peak memory {r.peak_mib:.0f} MiB{extra} [{card}]')
    return results


# -- differentiating through the integrator (phases 55-60) ---------------------------------------------------------
N_EMB, M_EMB, DT_EMB, STEPS_EMB, SWEEPS_EMB = 2048, 3, 0.02, 10, 4  # step 26's embedding at the heat path's width
ADAM_EMB, LR_EMB = 5, 0.2  # Adam steps at 2048^2 and the example's learning rate
N_S26, STEPS_S26, SWEEPS_S26, ADAM_S26, LR_S26 = 48, 10, 4, 300, 0.2  # examples/step_26_embedding_campaign.py:68
N_GRADCHECK, N_MATRIX, STEPS_MATRIX, MAXITER_MATRIX = 64, 64, 2, 5
N_LINEARIZED = 32
# max|grad(K1) - grad(plain rolls)| / max|grad|, float64 at 2048^2: only the order of the taps' sums differs, in 270
# applies; this script measured 4.5e-13 on an H100 80GB HBM3 at 700 W, and the gate leaves 200x
EMB_GRAD_PLAIN_RTOL = 1e-10
EMB_FD_RTOL = 1e-6  # central difference of the quadratic loss against <grad, d>: only rounding separates the two
# step 26 at 48^2, one value_and_grad card against CPU: max|grad(card) - grad(CPU)| / max|grad(CPU)|, and the losses'
# gap; K1's general path against the CPU's rolls over 10 steps x 4 sweeps, only the order of the taps' sums differs
S26_GRAD_RTOL = 1e-12
MATRIX_TOL = 1e-12  # fp64 64^2: |uend(matrix) - uend(ControllerNonMPI)|, and the propagation matrix's |u| gap


def _emb_problem(n, device, dtype):
    import torch

    from pysdc_tpu_torch import GenericImplicit
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.utils.embedding import make_sdc_step_function

    prob = HeatND(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=getattr(torch, dtype), device=device)
    sweep = GenericImplicit({'num_nodes': M_EMB, 'quad_type': 'RADAU-RIGHT', 'QI': 'LU'})
    return prob, make_sdc_step_function(prob, sweep, fixed_sweeps=SWEEPS_EMB)


def _emb_loss(step, target, steps=STEPS_EMB, dt=DT_EMB):
    """Step 26's loss: ``steps`` SDC steps of ``dt`` in a Python loop, MSE against ``target``."""
    import torch

    def forward(u):
        t = 0.0
        for _ in range(steps):
            u, t = step(u, t, dt), t + dt
        return u

    def loss(u):
        return torch.mean((forward(u) - target) ** 2)

    return forward, loss


def _value_and_grad(loss, u):
    x = u.detach().clone().requires_grad_()
    value = loss(x)
    value.backward()
    return value.detach(), x.grad


def _adam(loss, u0, steps, lr):
    """``steps`` of ``torch.optim.Adam`` (optax.adam's defaults) on ``loss`` from ``u0``: the losses before each
    step, and the final iterate."""
    import torch

    u = u0.detach().clone().requires_grad_()
    opt = torch.optim.Adam([u], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        value = loss(u)
        value.backward()
        opt.step()
        losses.append(float(value.detach()))
    return losses, u.detach()


def phase_autograd_kernels(card):
    """Phase 55: K1 under autograd and ``torch.func`` on the card, float32 and float64, on both paths (module
    docstring)."""
    import torch

    from pysdc_tpu_torch.models.advection import AdvectionND
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, choose_path, cross_stencil_2d, mirrored_terms

    n = N_EMB
    heat = HeatND(nvars=(n, n), nu=0.1, freq=2, bc='periodic', device='cpu').A._cross_terms
    centre = AdvectionND(nvars=(n, n), stencil_type='center', device='cpu').A._cross_terms
    upwind = AdvectionND(nvars=(n, n), stencil_type='upwind', device='cpu').A._cross_terms
    cases = [('heat', heat, None, 'bands'), ('advection center', centre, None, 'bands'),
             ('advection upwind', upwind, None, 'general'), ('heat, general forced', heat, 'general', 'general')]
    gen = torch.Generator(device='cuda').manual_seed(55)
    for dtype in (torch.float32, torch.float64):
        tol = None
        for name, terms, forced, path in cases:
            tol = _stencil_tolerance(terms, dtype)
            sum_c = sum(abs(c) for coeff, _ in terms for c in coeff)
            u, v, w = (torch.randn((n, n), generator=gen, device='cuda', dtype=dtype) for _ in range(3))
            x = u.clone().requires_grad_()
            before = dict(cross_stencil_2d.paths)
            y = cross_stencil_2d(x, terms, path=forced)
            (y * v).sum().backward()
            torch.cuda.synchronize()
            ran = {k: cross_stencil_2d.paths[k] - before[k] for k in before}
            back = choose_path((n, n), mirrored_terms(terms), u.element_size())
            if ran != {p: (p == path) + (p == back) for p in ran}:
                raise AssertionError(f'autograd kernels: K1 {name} {dtype}: launches by path {ran}, expected the '
                                     f'forward on {path} and the adjoint on {back}')
            lhs = float((y.detach().double() * v.double()).sum())
            rhs = float((u.double() * x.grad.double()).sum())
            bound = tol * sum_c * (float(u.abs().max()) * float(v.abs().sum()) + float(v.abs().max()) *
                                   float(u.abs().sum()))
            if not abs(lhs - rhs) <= bound:
                raise AssertionError(f'autograd kernels: K1 {name} {dtype}: <K u, v> - <u, K^T v> = {lhs - rhs:.3e}, '
                                     f'bound {bound:.3e}')
            mirror = cross_stencil_2d(v, mirrored_terms(terms))
            plain_err = float((x.grad - _roll_cross_2d(v, mirrored_terms(terms))).abs().max())
            if not (torch.equal(x.grad, mirror) and plain_err <= tol * sum_c * float(v.abs().max())):
                raise AssertionError(f'autograd kernels: K1 {name} {dtype}: the adjoint differs from K1 of the '
                                     f'mirrored table or from its plain version ({plain_err:.3e})')
            _, tangent = torch.func.jvp(lambda a: cross_stencil_2d(a, terms, path=forced), (u,), (w,))
            if not torch.equal(tangent, cross_stencil_2d(w, terms)):
                raise AssertionError(f'autograd kernels: K1 {name} {dtype}: the jvp is not K1 of the tangent')
            print(f'autograd kernels: K1 {name} {dtype} {n}^2: forward on {path}, adjoint on {back}; <K u, v> - '
                  f'<u, K^T v> = {lhs - rhs:.3e} (bound {bound:.3e} = 2 n_terms eps sum|c| (max|u| sum|v| + '
                  f'max|v| sum|u|)); adjoint against the plain mirrored rolls {plain_err:.3e}; jvp = K1 of the '
                  f'tangent, bitwise')
        # vmap of eval_f over 8 fields: one launch of the (8, n, n) batch
        prob = HeatND(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=dtype, device='cuda')
        batch = torch.randn((8, n, n), generator=gen, device='cuda', dtype=dtype)
        want = prob.eval_f(batch, 0.0)
        cross_stencil_2d.launches = 0
        got = torch.func.vmap(lambda f: prob.eval_f(f, 0.0))(batch)
        torch.cuda.synchronize()
        if cross_stencil_2d.launches != 1 or not torch.equal(got, want):
            raise AssertionError(f'autograd kernels: vmap of eval_f over 8 fields {dtype}: '
                                 f'{cross_stencil_2d.launches} launches, equal to the batched apply: '
                                 f'{torch.equal(got, want)}')
        print(f'autograd kernels: torch.func.vmap(prob.eval_f) over 8 fields {n}^2 {dtype}: 1 launch, equal to the '
              f'batched apply bitwise')

    # gradcheck and jacfwd at 64^2 float64 (a float64 row of 64 columns is one band)
    m = N_GRADCHECK
    for name, make in (('heat', lambda: HeatND(nvars=(m, m), nu=0.1, freq=2, bc='periodic', device='cpu')),
                       ('advection upwind', lambda: AdvectionND(nvars=(m, m), stencil_type='upwind', device='cpu'))):
        terms = make().A._cross_terms
        path = choose_path((m, m), terms, 8)
        u = torch.randn((m, m), generator=gen, device='cuda', dtype=torch.float64, requires_grad=True)
        if not torch.autograd.gradcheck(lambda a: cross_stencil_2d(a, terms), (u,), fast_mode=True):
            raise AssertionError(f'autograd kernels: gradcheck of K1 {name} {m}^2 failed')
        print(f'autograd kernels: gradcheck (fast_mode) of K1 {name} {m}^2 float64 on {path}: passed')
    prob = HeatND(nvars=(m, m), nu=0.1, freq=2, bc='periodic', dtype=torch.float64, device='cuda')
    terms = prob.A._cross_terms
    u = torch.randn((m * m,), generator=gen, device='cuda', dtype=torch.float64)
    cross_stencil_2d.launches = 0
    J = torch.func.jacfwd(lambda a: prob.eval_f(a.reshape(m, m), 0.0).reshape(-1))(u)
    torch.cuda.synchronize()
    launches = cross_stencil_2d.launches
    eye = torch.eye(m * m, dtype=torch.float64, device='cuda').reshape(m * m, m, m)
    dense = _roll_cross_2d(eye, terms).reshape(m * m, m * m).T
    err = float((J - dense).abs().max())
    tol = _stencil_tolerance(terms, torch.float64) * sum(abs(c) for coeff, _ in terms for c in coeff)
    if launches != 2 or not err <= tol:
        raise AssertionError(f'autograd kernels: jacfwd of eval_f {m}^2: {launches} launches, |J - dense| {err:.3e} '
                             f'(tol {tol:.3e})')
    print(f'autograd kernels: jacfwd of eval_f {m}^2 float64: 2 launches (the primal and one of all {m * m} '
          f'tangents), |J - dense matrix| {err:.3e} <= {tol:.3e} [{card}]')


def phase_embedding(card):
    """Phase 56: the slice's main path, step 26's device-side embedding at 2048^2 float64 (module docstring)."""
    import torch

    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    prob, step = _emb_problem(N_EMB, 'cuda', 'float64')
    with torch.no_grad():
        forward, _ = _emb_loss(step, None)
        target = forward(prob.u_exact(0.0))
    _, loss = _emb_loss(step, target)
    u0 = torch.zeros_like(target)
    fwd_expected = STEPS_EMB * (2 + SWEEPS_EMB * M_EMB)
    bwd_expected = STEPS_EMB * (2 + SWEEPS_EMB * M_EMB - 1)

    # the main path: one value_and_grad, forward and backward counted apart
    torch.cuda.synchronize()
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    x = u0.clone().requires_grad_()
    value = loss(x)
    torch.cuda.synchronize()
    fwd_launches = cross_stencil_2d.launches
    value.backward()
    torch.cuda.synchronize()
    bwd_launches = cross_stencil_2d.launches - fwd_launches
    paths = dict(cross_stencil_2d.paths)
    grad = x.grad
    print(f'embedding: K1 launches of one value_and_grad at {N_EMB}^2 float64: forward {fwd_launches} (expected '
          f'{STEPS_EMB} steps x (2 in the predictor + {SWEEPS_EMB} sweeps x M={M_EMB}) = {fwd_expected}), backward '
          f'{bwd_launches} (expected {bwd_expected}: every forward apply but the last node\'s f of each step\'s last '
          f'sweep, which nothing reads; the predictor\'s f at the left end gets a zero gradient and is launched too), '
          f'by path {paths}')
    if fwd_launches != fwd_expected or bwd_launches != bwd_expected or paths['general'] != 0:
        raise AssertionError('embedding: K1 launches differ from what the sweeps imply, or left the bands path')
    if not (torch.isfinite(grad).all() and float(grad.abs().max()) > 0):
        raise AssertionError('embedding: the gradient is not finite or is zero')

    # the same loss differentiated through the plain version (rolls) on the card
    prob.A.disable_pallas()
    before = cross_stencil_2d.launches
    value_plain, grad_plain = _value_and_grad(loss, u0)
    prob.A.enable_pallas()
    if cross_stencil_2d.launches != before:
        raise AssertionError('embedding: the plain run launched K1')
    scale = float(grad_plain.abs().max())
    grad_rel = float((grad - grad_plain).abs().max()) / scale
    value_rel = abs(float(value.detach()) - float(value_plain)) / float(value_plain)
    print(f'embedding: gradient through K1 against the plain rolls on the card: max rel {grad_rel:.3e} (gate '
          f'{EMB_GRAD_PLAIN_RTOL:.0e}), loss rel {value_rel:.3e}, max|grad| {scale:.3e}')
    if not (grad_rel <= EMB_GRAD_PLAIN_RTOL and value_rel <= EMB_GRAD_PLAIN_RTOL):
        raise AssertionError('embedding: the gradient through K1 differs from the plain version\'s')

    # a directional derivative against a central difference (the loss is quadratic in u: exact up to rounding)
    gen = torch.Generator(device='cuda').manual_seed(56)
    d = torch.randn(u0.shape, generator=gen, device='cuda', dtype=u0.dtype)
    h = 1e-2
    with torch.no_grad():
        fd = (float(loss(u0 + h * d)) - float(loss(u0 - h * d))) / (2 * h)
    directional = float((grad * d).sum())
    fd_rel = abs(fd - directional) / abs(directional)
    print(f'embedding: <grad, d> = {directional:.12e}, central difference (h {h}) {fd:.12e}, rel {fd_rel:.3e} '
          f'(gate {EMB_FD_RTOL:.0e})')
    if not fd_rel <= EMB_FD_RTOL:
        raise AssertionError('embedding: the directional derivative disagrees with the central difference')

    # a few Adam steps: the loss falls
    losses, _ = _adam(loss, u0, ADAM_EMB, LR_EMB)
    print(f'embedding: {ADAM_EMB} Adam steps (lr {LR_EMB}): losses {[f"{v:.6e}" for v in losses]}')
    if not losses[-1] < losses[0]:
        raise AssertionError('embedding: the loss did not fall under Adam')

    # times: forward and backward by CUDA events (best of 3 after the runs above), K1's share, peak memory
    k1_one = _event_ms(lambda i: cross_stencil_2d(target, prob.A._cross_terms), 20)
    nodes = target.unsqueeze(0).repeat(M_EMB, 1, 1)
    k1_nodes = _event_ms(lambda i: cross_stencil_2d(nodes, prob.A._cross_terms), 20)
    best = None
    for _ in range(3):
        x = u0.clone().requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h0 = time.perf_counter()
        events[0].record()
        value = loss(x)
        events[1].record()
        value.backward()
        events[2].record()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - h0)
        run = (events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2]), host_ms,
               torch.cuda.max_memory_allocated() / 2**20)
        best = run if best is None or sum(run[:2]) < sum(best[:2]) else best
    fwd_ms, bwd_ms, host_ms, peak = best
    k1_fwd = STEPS_EMB * (k1_nodes + (1 + SWEEPS_EMB * M_EMB) * k1_one)
    k1_bwd = STEPS_EMB * (k1_nodes + SWEEPS_EMB * M_EMB * k1_one)
    print(f'embedding times: one value_and_grad at {N_EMB}^2 float64 ({STEPS_EMB} steps x {SWEEPS_EMB} sweeps, M='
          f'{M_EMB}): forward {fwd_ms:.3f} ms, backward {bwd_ms:.3f} ms on the card (CUDA events, best of 3), '
          f'{host_ms:.3f} ms on the host clock; K1 an apply {k1_one:.4f} ms at ({N_EMB}, {N_EMB}), {k1_nodes:.4f} ms '
          f'at ({M_EMB}, {N_EMB}, {N_EMB}) -> K1 {k1_fwd:.3f} ms of the forward ({100 * k1_fwd / fwd_ms:.1f}%), '
          f'{k1_bwd:.3f} ms of the backward ({100 * k1_bwd / bwd_ms:.1f}%); peak {peak:.0f} MiB [{card}]')
    return dict(forward=fwd_launches, backward=bwd_launches)


def phase_step26(card):
    """Phase 57: step 26 at the example's own sizes on the card (module docstring)."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, get_sorted
    from pysdc_tpu_torch.models.heat import HeatNDForced
    from pysdc_tpu_torch.ops.kernels.stencil import choose_path, cross_stencil_2d
    from pysdc_tpu_torch.sweepers.imex import IMEXSweeper
    from pysdc_tpu_torch.utils.embedding import ControllerAsStepper
    from pysdc_tpu_torch.utils.golden import GoldenStore

    store = GoldenStore(Path(__file__).resolve().parent / 'examples' / 'golden' / 'step_26_embedding.json')
    if store.writing:
        raise AssertionError(f'step 26: {GoldenStore.WRITE_ENV} is set, so the golden gates would record instead '
                             f'of checking; unset it')

    # K1's general path, forward and adjoint, at the example's size: one value_and_grad at a seeded point, card
    # against the CPU's plain rolls
    point = torch.as_tensor(np.random.default_rng(57).standard_normal((N_S26, N_S26)), dtype=torch.float64)
    grads, losses_by_device = {}, {}
    for device in ('cuda', 'cpu'):
        prob, step = _emb_problem(N_S26, device, 'float64')
        with torch.no_grad():
            forward, _ = _emb_loss(step, None, STEPS_S26)
            target = forward(prob.u_exact(0.0))
        _, losses_by_device[device] = _emb_loss(step, target, STEPS_S26)
        cross_stencil_2d.launches = 0
        cross_stencil_2d.paths = {'bands': 0, 'general': 0}
        value, grad = _value_and_grad(losses_by_device[device], point.to(device))
        grads[device] = (float(value), grad.cpu(), cross_stencil_2d.launches, dict(cross_stencil_2d.paths))
    (value, grad, vg_launches, vg_paths), (value_cpu, grad_cpu, _, _) = grads['cuda'], grads['cpu']
    grad_rel = float((grad - grad_cpu).abs().max()) / float(grad_cpu.abs().max())
    value_rel = abs(value - value_cpu) / value_cpu
    print(f'step 26: one value_and_grad at {N_S26}^2 float64 from a seeded point, card against CPU: gradient max rel '
          f'{grad_rel:.3e}, loss rel {value_rel:.3e} (gate {S26_GRAD_RTOL:.0e}), {vg_launches} K1 launches by path '
          f'{vg_paths}')
    if choose_path((N_S26, N_S26), _emb_problem(N_S26, 'cpu', 'float64')[0].A._cross_terms, 8) != 'general' or \
            vg_paths['bands'] != 0 or vg_launches == 0:
        raise AssertionError('step 26: the 48^2 value_and_grad did not run on the general path of K1')
    if not (grad_rel <= S26_GRAD_RTOL and value_rel <= S26_GRAD_RTOL):
        raise AssertionError('step 26: the card\'s gradient differs from the CPU\'s')

    # the example's inversion on the card from u = 0: 300 Adam steps, held to the golden file and to the example's
    # convergence
    loss = losses_by_device['cuda']
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    t0 = time.perf_counter()
    losses, u = _adam(loss, torch.zeros((N_S26, N_S26), dtype=torch.float64, device='cuda'), ADAM_S26, LR_S26)
    with torch.no_grad():
        lT = float(loss(u))
    seconds = time.perf_counter() - t0
    inversion_launches, paths, l0 = cross_stencil_2d.launches, dict(cross_stencil_2d.paths), losses[0]
    reduction = math.log10(l0 / lT)
    print(f'step 26: inversion at {N_S26}^2 float64, {ADAM_S26} Adam steps (lr {LR_S26}) through {STEPS_S26} SDC steps '
          f'x {SWEEPS_S26} sweeps: loss {l0:.6e} -> {lT:.6e} on the card ({seconds:.1f} s, {inversion_launches} K1 '
          f'launches by path {paths}); log10 reduction {reduction:.6f}')
    if paths['bands'] != 0 or inversion_launches == 0:
        raise AssertionError('step 26: the 48^2 inversion did not run on the general path of K1')
    if not lT < 5e-6 * l0:
        raise AssertionError('step 26: the gradient through the integrator did not converge')
    store.check('adjoint_loss_reduction_log10', [reduction], rtol=0.2)

    # the host-side march: the example's own configuration (1D, 128 points) against the golden file, then the same
    # at 128^2 (its operator on K1) card against CPU
    for nvars in (128, (128, 128)):
        marches = {}
        for device in ('cuda', 'cpu'):
            desc = dict(problem_class=HeatNDForced,
                        problem_params=dict(nu=0.1, freq=2, nvars=nvars, bc='periodic', device=device),
                        sweeper_class=IMEXSweeper, sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=3, QI='LU'),
                        level_params=dict(restol=1e-10, dt=0.05), step_params=dict(maxiter=20))
            stepper = ControllerAsStepper(ControllerNonMPI, desc, {'logger_level': 40}, 0.05)
            P = stepper.controller.MS[0].levels[0].prob
            cross_stencil_2d.launches = 0
            u, t = P.u_exact(0.0), 0.0
            for _ in range(8):
                u = stepper.apply(u, t)
                t += 0.05
            marches[device] = ([v for _, v in get_sorted(stepper.stats, type='niter')],
                               float((u - P.u_exact(t)).abs().max()), u.cpu(), cross_stencil_2d.launches)
        (iters, err, u_card, launches), (iters_cpu, _, u_cpu, _) = marches['cuda'], marches['cpu']
        gap = float((u_card - u_cpu).abs().max())
        print(f'step 26: host-side march HeatNDForced {nvars} IMEX, 8 applies: niter {iters} (CPU {iters_cpu}), err '
              f'{err:.6e}, card against CPU {gap:.3e}, K1 launches {launches}')
        if iters != iters_cpu or not gap <= 1e-11 * float(u_cpu.abs().max()):
            raise AssertionError(f'step 26: the host-side march {nvars} differs between the card and the CPU')
        if nvars == 128:
            store.check('host_march_niter', iters)
            store.check('host_march_err', [err], rtol=1e-6, atol=1e-12)
        elif launches == 0:
            raise AssertionError('step 26: the 128^2 march did not go through K1')
    print(f'step 26: golden gates of examples/golden/step_26_embedding.json hold for the port on the card [{card}]')
    return dict(inversion=inversion_launches, march=launches)


def phase_matrix(card):
    """Phase 58: the matrix controller through vmapped K1 (module docstring)."""
    import gc

    import torch

    from pysdc_tpu_torch import ControllerNonMPI, GenericImplicit, get_sorted
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d
    from pysdc_tpu_torch.parallel.matrix_controller import ControllerMatrixNonMPI

    n, steps = N_MATRIX, STEPS_MATRIX
    nbig = steps * M_EMB * n * n
    print(f'matrix: HeatND {n}^2 periodic float64, {steps} steps, M={M_EMB}: each dense block matrix is '
          f'({steps} x {M_EMB} x {n * n})^2 x 8 B = {nbig**2 * 8 / 2**30:.2f} GiB')

    def desc(restol, maxiter):
        return dict(problem_class=HeatND,
                    problem_params=dict(nvars=(n, n), nu=0.1, freq=2, bc='periodic', dtype=torch.float64,
                                        device='cuda'),
                    sweeper_class=GenericImplicit,
                    sweeper_params=dict(quad_type='RADAU-RIGHT', num_nodes=M_EMB, QI='LU', initial_guess='spread'),
                    level_params=dict(restol=restol, dt=0.01), step_params=dict(maxiter=maxiter))

    cp = {'logger_level': 40, 'all_to_done': True, 'mssdc_jac': True}
    launches = {}
    for restol, maxiter in ((1e-10, 50), (-1.0, MAXITER_MATRIX)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cross_stencil_2d.launches = 0
        cross_stencil_2d.paths = {'bands': 0, 'general': 0}
        t0 = time.perf_counter()
        cm = ControllerMatrixNonMPI(steps, cp, desc(restol, maxiter))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches[restol] = (cross_stencil_2d.launches, dict(cross_stencil_2d.paths))
        if launches[restol][0] != 1 or launches[restol][1]['bands'] != 1:
            raise AssertionError(f'matrix: dense_from_apply took {launches[restol]} K1 launches, expected one on bands')
        P = cm.MS[0].levels[0].prob
        u0 = P.u_exact(0.0)
        um, sm = cm.run(u0, 0.0, steps * 0.01)
        niter_m = [v for _, v in get_sorted(sm, type='niter')]
        if restol > 0:
            us, ss = ControllerNonMPI(steps, cp, desc(restol, maxiter)).run(u0, 0.0, steps * 0.01)
            niter_s = [v for _, v in get_sorted(ss, type='niter')]
            gap = float((um - us).abs().max())
            print(f'matrix: built in {build_s:.2f} s (A by one vmapped K1 launch of ({n * n}, {n}, {n}) on bands), '
                  f'niter {niter_m} against ControllerNonMPI {niter_s}, |uend gap| {gap:.3e}, peak '
                  f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
            if niter_m != niter_s or not gap <= MATRIX_TOL:
                raise AssertionError('matrix: the matrix controller differs from ControllerNonMPI')
        else:
            t0 = time.perf_counter()
            mat = cm.build_propagation_matrix(niter=MAXITER_MATRIX)
            torch.cuda.synchronize()
            gap = float((mat @ u0.reshape(-1) - um.reshape(-1)).abs().max())
            print(f'matrix: propagation matrix for {MAXITER_MATRIX} iterations in {time.perf_counter() - t0:.2f} s, '
                  f'niter {niter_m}, |mat u0 - uend| {gap:.3e}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} '
                  f'GiB [{card}]')
            if niter_m != [MAXITER_MATRIX] * steps or not gap <= MATRIX_TOL:
                raise AssertionError('matrix: the propagation matrix does not reproduce the run')
            del mat
        del cm
        gc.collect()
        torch.cuda.empty_cache()
    return launches[1e-10][0]


def phase_logtofile(card):
    """Phase 59: ``LogToFile`` on the 2048^2 heat path (module docstring)."""
    import tempfile

    import torch

    from pysdc_tpu_torch import ControllerNonMPI
    from pysdc_tpu_torch.utils.fieldsio import FieldsIO, LogToFile

    desc = _heat_description(N_MAIN, torch.float32, 'cuda', restol=-1.0, maxiter=4)
    with tempfile.TemporaryDirectory() as folder:
        probe = ControllerNonMPI(1, {'logger_level': 40}, desc).MS[0].levels[0].prob
        logger = LogToFile(folder, probe)
        written = []
        add = logger.io.addField

        def timed(t, field):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            add(t, field)
            written.append((1e3 * (time.perf_counter() - t0), field.detach().cpu().clone()))

        logger.io.addField = timed
        ctrl = ControllerNonMPI(1, {'logger_level': 40, 'hook_class': [logger.hook_class]}, desc)
        uend, _ = ctrl.run(probe.u_exact(0.0), 0.0, 2 * DT)
        back = FieldsIO.fromFile(logger.file_name)
        if back.nFields != 2:
            raise AssertionError(f'logtofile: {back.nFields} records, expected 2')
        for i, (_, field) in enumerate(written):
            t, data = back.readField(i)
            if not (abs(t - (i + 1) * DT) < 1e-12 and np.array_equal(data.reshape(field.shape), field.numpy())):
                raise AssertionError(f'logtofile: record {i} does not read back bitwise')
        if not np.array_equal(back.readField(-1)[1].reshape(uend.shape), uend.cpu().numpy()):
            raise AssertionError('logtofile: the last record is not uend')
        size = Path(logger.file_name).stat().st_size
    ms = [w for w, _ in written]
    print(f'logtofile: {len(written)} records of {N_MAIN}^2 float32 read back bitwise; a write (copy to the host and '
          f'append) {ms[0]:.2f} / {ms[1]:.2f} ms, file {size / 2**20:.1f} MiB [{card}]')


def phase_linearized(card):
    """Phase 60: ``LinearizedImplicitParallel`` on a K1 problem runs through ``jacfwd`` (module docstring)."""
    import torch

    from pysdc_tpu_torch import ControllerNonMPI, LinearizedImplicitParallel, get_sorted
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    runs = {}
    for device in ('cuda', 'cpu'):
        desc = dict(problem_class=HeatND,
                    problem_params=dict(nvars=(N_LINEARIZED, N_LINEARIZED), nu=0.1, freq=2, bc='periodic',
                                        dtype=torch.float64, device=device),
                    sweeper_class=LinearizedImplicitParallel,
                    sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', jacobian=0, basis='Q'),
                    level_params=dict(dt=0.01, restol=1e-10), step_params=dict(maxiter=20))
        ctrl = ControllerNonMPI(1, {'logger_level': 40}, desc)
        prob = ctrl.MS[0].levels[0].prob
        cross_stencil_2d.launches = 0
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # a multithreaded complex solve of this CPU torch can hang (MKL)
        try:
            uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, 0.02)
        finally:
            torch.set_num_threads(threads)
        runs[device] = ([v for _, v in get_sorted(stats, type='niter')], uend.cpu(), cross_stencil_2d.launches,
                        float((uend - prob.u_exact(0.02)).abs().max()))
    (niter, u_card, launches, err), (niter_cpu, u_cpu, _, _) = runs['cuda'], runs['cpu']
    gap = float((u_card - u_cpu).abs().max())
    print(f'linearized: LinearizedImplicitParallel on HeatND {N_LINEARIZED}^2 float64 (Jacobian by jacfwd through K1): '
          f'niter {niter} (CPU {niter_cpu}), card against CPU {gap:.3e}, err {err:.3e}, {launches} K1 launches [{card}]')
    if niter != niter_cpu or not gap <= 1e-11 or launches == 0:
        raise AssertionError('linearized: the card\'s run differs from the CPU\'s or launched no K1')
    return launches


def _mesh_of(n_time=1, n_space=1, n_node=1, device='cuda:0'):
    """A mesh of positions that all lie on ``device``: the one card stands in for as many as the mesh has."""
    from pysdc_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_time=n_time, n_space=n_space, n_node=n_node, devices=[device] * (n_time * n_space * n_node))


def phase_mesh_halo(card):
    """The three halo applies on meshes of 2 and 4 space positions of the card, against K1 on the whole field and the
    plain halo version (the JAX slices, on the CPU).  Returns the K1 launches and the largest error against K1."""
    import torch

    from pysdc_tpu_torch.ops import halo
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    tables = _fd_tables()
    gen = torch.Generator(device='cuda').manual_seed(2024)
    five = (-4.0, 1.0, 1.5)  # c0, cx, cy of the 5-point apply
    launches, worst_abs, worst = 0, 0.0, {}
    for k in MESH_SPACE:
        mesh, cpu_mesh = _mesh_of(n_space=k), _mesh_of(n_space=k, device='cpu')
        for dtype in (torch.float32, torch.float64):
            for order in (2, 4, 6):
                terms = tables[f'order{order}']
                for shape in ((N_MAIN, N_MAIN), (M_MAIN, N_MAIN, N_MAIN)):
                    u = torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
                    cases = [('batched', terms, lambda x, m: halo.halo_cross_apply_batched(x, m, terms))]
                    if len(shape) == 2:
                        cases.append(('cross', terms, lambda x, m: halo.halo_cross_apply(x, m, terms)))
                        if order == 2:
                            cases.append(('5-point', halo._five_point_terms(*five),
                                          lambda x, m: halo.halo_stencil_apply(x, m, *five)))
                    for name, t, fn in cases:
                        tol = _stencil_tolerance(t, dtype)
                        scale = sum(abs(c) for coeff, _ in t for c in coeff) * u.abs().max().item()
                        whole = cross_stencil_2d(u, t)
                        before, bands = cross_stencil_2d.launches, cross_stencil_2d.paths['bands']
                        got = fn(u, mesh)
                        torch.cuda.synchronize()
                        n, n_bands = cross_stencil_2d.launches - before, cross_stencil_2d.paths['bands'] - bands
                        if n != k or n_bands != k:
                            raise AssertionError(f'mesh halo {name} {dtype} {shape} on {k} positions: {n} K1 launches, '
                                                 f'{n_bands} on bands, expected {k} and {k}')
                        launches += n
                        err_k1 = (got - whole).abs().max().item()
                        err_plain = (got.cpu() - fn(u.cpu(), cpu_mesh)).abs().max().item()
                        rel = max(err_k1, err_plain) / scale
                        if got.shape != u.shape or not (math.isfinite(rel) and rel <= tol):
                            raise AssertionError(f'mesh halo {name} order {order} {dtype} {shape} on {k} positions: '
                                                 f'|halo - K1| {err_k1:.3e}, |halo - plain| {err_plain:.3e}, rel '
                                                 f'{rel:.3e} > {tol:.3e}')
                        key = (name, str(dtype))
                        worst[key] = max(worst.get(key, 0.0), rel)
                        if dtype == torch.float32:
                            worst_abs = max(worst_abs, err_k1)
    # a radius deeper than a slab raises, before any launch
    before = cross_stencil_2d.launches
    for fn in (halo.halo_cross_apply_batched, halo.halo_cross_apply):
        try:
            fn(torch.zeros((8, N_MAIN), device='cuda'), _mesh_of(n_space=4), tables['order6'])
        except ValueError as err:
            if 'exceeds local shard size 2' not in str(err):
                raise
        else:
            raise AssertionError('mesh halo: a stencil radius of 3 on slabs of 2 rows did not raise')
    if cross_stencil_2d.launches != before:
        raise AssertionError('mesh halo: a refused apply launched K1')
    print(f'mesh halo: the three halo applies on {list(MESH_SPACE)} space positions of the card, {N_MAIN}^2 and '
          f'{M_MAIN} x {N_MAIN}^2, float32 and float64, centred tables of radius 1-3: one K1 launch a slab, all on '
          f'bands ({launches} launches); max rel err against K1 on the whole field and the plain halo version on the '
          f'CPU by apply and dtype {({f"{a} {b[6:]}": float(f"{v:.3e}") for (a, b), v in worst.items()})} <= 2 '
          f'n_terms eps sum|c| max|u|; radius 3 on 2-row slabs raises [{card}]')
    return launches, worst_abs


def _mesh_run(desc, num_procs, mesh, lane='auto', coarse_mode='auto', n_blocks=1, full_fft=False,
              **controller_params):
    """``n_blocks`` blocks through ``ShardedController(num_procs, mesh=mesh).run``, the counts set to 0 just before:
    uend, niter, lane, K1 launches (by path), operator applies, halo slabs and the mesh's copies and gathers.
    ``full_fft`` takes the full complex FFT solves that a space-sharded mesh sets (``disable_rfft``) without one."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops import halo
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    ctrl = ShardedController(num_procs, {'logger_level': 30, **controller_params}, desc, mesh=mesh,
                             coarse_mode=coarse_mode)
    prob = ctrl.MS[0].levels[0].prob
    if full_fft:
        for step in ctrl.MS:
            for lvl in step.levels:
                lvl.prob.A.disable_rfft()
    applies = _count_applies(ctrl, set())
    dt = desc['level_params']['dt']
    cross_stencil_2d.launches = 0
    cross_stencil_2d.paths = {'bands': 0, 'general': 0}
    halo.halo_cross_apply_batched.shard_applies = 0
    if mesh is not None:
        mesh.reset_traffic()
    uend, stats = ctrl.run(prob.u_exact(0.0), 0.0, n_blocks * num_procs * dt, lane=lane)
    torch.cuda.synchronize()
    return SimpleNamespace(ctrl=ctrl, uend=uend, niter=_niter(stats), lane=[v for k, v in stats.items() if
                                                                             k.type == 'lane'],
                           launches=cross_stencil_2d.launches, paths=dict(cross_stencil_2d.paths),
                           applies=sum(applies.values()), slabs=halo.halo_cross_apply_batched.shard_applies,
                           traffic=dict(mesh.traffic) if mesh is not None else None)


def _mesh_gate(label, run, ref, bound, card):
    """A mesh run against the same block without a mesh: equal niter, uend within ``bound``, K1 launches equal to
    the shards' applies (a slab each under the halo apply), all on bands."""
    import torch

    mesh = run.ctrl.mesh
    halo_on = run.ctrl.MS[0].levels[0].prob.A._halo is not None
    n_space = mesh.shape['space'] if halo_on else 1
    diff = (run.uend - ref.uend).abs().max().item()
    if run.niter != ref.niter or not diff <= bound:
        raise AssertionError(f'{label}: niter {run.niter} against {ref.niter} without a mesh, |d uend| {diff:.3e} > '
                             f'{bound}')
    if run.lane != ref.lane or run.uend.shape != ref.uend.shape or not bool(torch.isfinite(run.uend).all()):
        raise AssertionError(f'{label}: lane {run.lane} against {ref.lane}, or uend not finite of the grid shape')
    if run.launches < 1 or run.launches != run.applies * n_space or run.paths != {'bands': run.launches, 'general': 0}:
        raise AssertionError(f'{label}: K1 launches {run.launches} by path {run.paths}, operator applies {run.applies} '
                             f'x {n_space} slabs')
    if halo_on and run.slabs != run.launches:
        raise AssertionError(f'{label}: {run.slabs} halo slabs against {run.launches} K1 launches')
    if run.lane == ['fused'] and run.ctrl.host_reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'{label}: host reads of the fused march {run.ctrl.host_reads}')
    print(f'{label}: mesh {dict(mesh.shape)} on one card, coarse chain {run.ctrl.coarse_mode!r}, lane {run.lane[0]}: '
          f'niter {run.niter} = without a mesh, |uend - uend without a mesh| {diff:.3e} <= {bound}; K1 launches '
          f'{run.launches} = {run.applies} operator applies x {n_space} slab(s), all on bands; copies and gathers '
          f'{run.traffic} ' + (f'(warm-up and capture of the fused lane), host reads {run.ctrl.host_reads} '
                               if run.lane == ['fused'] else '')
          + f'[{card}]')


def phase_mesh_main(card):
    """The heat path (2048^2 float32, M=4 LU, dt 0.01) through ``ShardedController(4)`` on a 2 x 2 (time, space) mesh
    and a 4-position time mesh of the card, the PFASST block of bench.py:512-531 on a 4-position time mesh, each
    against the same block without a mesh; the float64 PFASST block at 128^2 on a 2 x 2 mesh, card against CPU.
    Returns the runs (for the times) and the K1 launches by path."""
    import torch

    heat = _heat_description(N_MAIN, torch.float32, 'cuda', restol=-1.0, maxiter=SWEEPS)
    ref = _mesh_run(heat, 4, None)
    runs, launches = {}, {}
    for shape in ((2, 1, 2), (4, 1, 1)):
        n_time, _, n_space = shape
        run = _mesh_run(heat, 4, _mesh_of(n_time=n_time, n_space=n_space))
        # a space-sharded mesh solves by the full complex FFT (as the JAX package's): the block without a mesh
        # that does the same arithmetic is the one held to the bound; the half-spectrum one rounds differently
        same = _mesh_run(heat, 4, None, full_fft=True) if n_space > 1 else ref
        _mesh_gate(f'mesh main: HeatND {N_MAIN}^2 fp32 M={M_MAIN} LU, 4 steps of {SWEEPS} sweeps', run, same,
                   MESH_UEND_BOUND, card)
        if n_space > 1:
            diff = (run.uend - ref.uend).abs().max().item()
            if run.niter != ref.niter or not diff <= UEND_PLAIN_BOUND:
                raise AssertionError(f'mesh main: against the half-spectrum solves niter {ref.niter}, |d uend| '
                                     f'{diff:.3e} > {UEND_PLAIN_BOUND}')
            print(f'mesh main: the 2 x 2 mesh against the block without a mesh that solves by the half-spectrum FFT: '
                  f'niter equal, |d uend| {diff:.3e} <= {UEND_PLAIN_BOUND} (the two round differently) [{card}]')
        if n_space == 1 and run.ctrl.coarse_mode != 'owner':
            raise AssertionError(f'mesh main: coarse_mode \'auto\' gave {run.ctrl.coarse_mode!r} on a time-only mesh')
        if n_space > 1 and run.ctrl.MS[0].levels[0].prob.A._halo is None:
            raise AssertionError('mesh main: no halo apply on a time x space mesh')
        runs[f'heat {shape}'] = (heat, 4, run, ref)
        launches[f'mesh heat {n_time}x{n_space}'] = run.launches

    pfasst = _pfasst_description(N_PFASST, NC_PFASST, torch.float32, 'cuda', RESTOL_PFASST)
    ref_p = _mesh_run(pfasst, P_PFASST, None, **BURNIN)
    run_p = _mesh_run(pfasst, P_PFASST, _mesh_of(n_time=4), **BURNIN)
    if run_p.ctrl.coarse_mode != 'owner' or not all(k < 50 for k in run_p.niter):
        raise AssertionError(f'mesh main: PFASST coarse mode {run_p.ctrl.coarse_mode!r}, niter {run_p.niter}')
    _mesh_gate(f'mesh main: PFASST HeatND {N_PFASST}^2/{NC_PFASST}^2 fp32, burn-in, {P_PFASST} steps', run_p, ref_p,
               MESH_UEND_BOUND, card)
    runs['pfasst (4, 1, 1)'] = (pfasst, P_PFASST, run_p, ref_p)
    launches['mesh pfasst 4x1'] = run_p.launches

    # float64 on a 2 x 2 mesh: the halo applies launch K1 on the card and take the slices on the CPU
    got = {}
    for where, device in (('card', 'cuda'), ('host', 'cpu')):
        desc = _pfasst_description(N_MESH_PARITY, N_MESH_PARITY // 2, torch.float64, device, 5e-10)
        got[where] = _mesh_run(desc, 4, _mesh_of(n_time=2, n_space=2, device=device), lane='stage', **BURNIN)
    on_card, on_host = got['card'], got['host']
    diff = (on_card.uend.cpu() - on_host.uend).abs().max().item()
    if (on_card.niter != on_host.niter or not diff <= PARITY_UEND_TOL or on_card.slabs < 1
            or on_card.launches != on_card.slabs):
        raise AssertionError(f'mesh parity: niter card {on_card.niter} cpu {on_host.niter}, uend diff {diff:.3e}, K1 '
                             f'launches {on_card.launches}, halo slabs {on_card.slabs}')
    launches['mesh parity 2x2'] = on_card.launches
    print(f'mesh parity: PFASST {N_MESH_PARITY}^2/{N_MESH_PARITY // 2}^2 fp64 restol 5e-10 on a 2 x 2 (time, space) '
          f'mesh, stage lane: niter {on_card.niter} on card and CPU, uend diff {diff:.3e} <= {PARITY_UEND_TOL}; on '
          f'the card {on_card.launches} K1 launches = halo slabs [{card}]')
    return runs, launches


def phase_mesh_paradiag(card):
    """bench_paradiag's block (512^2 float32, M=3, L=8, alpha 1e-4) with its step axis on 8 time positions of the
    card, against the unsharded block.  Returns the K1 launches."""
    import torch

    desc = _paradiag_description(N_PD, torch.float32, 'cuda')
    ref = _paradiag_run(desc)
    run = _paradiag_run(desc, mesh=_mesh_of(n_time=L_PD))
    diff = (run.uend - ref.uend).abs().max().item()
    its = run.niter[0]
    if not run.ctrl._time_sharded or run.niter != ref.niter or not diff <= PD_PLAIN_BOUND:
        raise AssertionError(f'mesh paradiag: niter {run.niter} against {ref.niter}, |d uend| {diff:.3e}')
    if not all(r <= RESTOL_PD for r in run.residuals) or run.launches != L_PD * its:
        raise AssertionError(f'mesh paradiag: residuals {run.residuals}, K1 launches {run.launches} for {its} iterations')
    if [p for p, v in run.paths.items() if v] != [p for p, v in ref.paths.items() if v]:
        raise AssertionError(f'mesh paradiag: K1 paths {run.paths} against {ref.paths} unsharded')
    print(f'mesh paradiag: HeatND {N_PD}^2 fp32, L={L_PD} M={M_PD} alpha {ALPHA_PD}, the block on {L_PD} time '
          f'positions of the card: niter {run.niter} = unsharded, |uend - uend unsharded| {diff:.3e} <= {PD_PLAIN_BOUND}, '
          f'K1 launches {run.launches} = {L_PD} shards x {its} iterations, on {run.paths} [{card}]')
    # one iteration each way, from the same block (eager: the controller reads its norms once an iteration)
    t_arr = np.arange(L_PD) * DT_PD
    for label, ctrl in (('unsharded', ref.ctrl), (f'on {L_PD} time positions', run.ctrl)):
        u0 = ref.prob.u_exact(0.0)
        u = ctrl._predict(u0)
        step = ctrl._iteration_sharded if ctrl._time_sharded else ctrl._iteration
        if ctrl._time_sharded:
            ctrl.mesh.reset_traffic()
        step(u, u0, t_arr, DT_PD)
        traffic = dict(ctrl.mesh.traffic) if ctrl._time_sharded else None
        _timed_block(lambda: step(u, u0, t_arr, DT_PD), f'mesh paradiag: one iteration {label}', card)
        if ctrl._time_sharded:
            print(f'times: mesh paradiag: copies and gathers an iteration {traffic}')
    return run.launches


def phase_mesh_fieldsio(card):
    """A 2048^2 float32 field sharded over a (4, 2) mesh of the card, written slab by slab, against a host write."""
    import tempfile

    import torch

    from pysdc_tpu_torch.parallel import mesh as meshlib
    from pysdc_tpu_torch.utils.fieldsio import Rectilinear

    mesh = meshlib.Mesh(np.asarray([torch.device('cuda', 0)] * 8, dtype=object).reshape(4, 2), ('a', 'b'))
    u = torch.randn((N_MAIN, N_MAIN), generator=torch.Generator(device='cuda').manual_seed(7), device='cuda')
    sharded = meshlib.device_put(u, meshlib.NamedSharding(mesh, meshlib.PartitionSpec('a', 'b')))
    coords = [np.arange(N_MAIN, dtype=float)] * 2
    with tempfile.TemporaryDirectory() as tmp:
        files = {}
        for name, field in (('sharded', sharded), ('host', u.cpu().numpy())):
            io = Rectilinear(np.float32, str(Path(tmp) / f'{name}.pysdc'))
            io.setHeader(nVar=1, coords=coords)
            io.initialize()
            start = time.perf_counter()
            io.addField(0.25, field)
            files[name] = (Path(io.file_name).read_bytes(), 1e3 * (time.perf_counter() - start))
    if files['sharded'][0] != files['host'][0]:
        raise AssertionError('mesh fieldsio: the sharded write differs from the host write')
    print(f'mesh fieldsio: a {N_MAIN}^2 fp32 field on a (4, 2) mesh of the card, {len(sharded.addressable_shards)} '
          f'slabs of {tuple(sharded.addressable_shards[0].data.shape)}, written slab by slab: byte-equal to the host '
          f'write ({len(files["host"][0])} bytes); ms a record, sharded {files["sharded"][1]:.1f}, host '
          f'{files["host"][1]:.1f} (host clock, the copy to the host included) [{card}]')


def phase_mesh_times(runs, card):
    """Each mesh run of phase 62 against the same block without a mesh: ms on the card (CUDA events) and the host
    clock, busy time and idle share (profiler), on the fused lane that ``run()`` takes and on the stage lane; the
    copies and gathers a block.  On one card this is the cost of the layout's bookkeeping, not a scaling figure."""
    import torch

    from pysdc_tpu_torch import ShardedController

    for label, (desc, num_procs, run, ref) in runs.items():
        cp = {'logger_level': 30, **(BURNIN if label.startswith('pfasst') else {})}
        # a space-sharded mesh solves by the full complex FFT: the block without a mesh that does the same tells
        # the halo's cost from the solves'
        variants = [('no mesh', None), ('mesh', run.ctrl.mesh)]
        if run.ctrl.mesh.shape['space'] > 1:
            variants.insert(1, ('no mesh, full complex FFT', None))
        for lane in ('auto', 'stage'):
            times = {}
            for name, mesh in variants:
                ctrl = ShardedController(num_procs, cp, desc, mesh=mesh)
                prob = ctrl.MS[0].levels[0].prob
                if name.endswith('FFT'):
                    for lvl in ctrl.MS[0].levels:
                        lvl.prob.A.disable_rfft()
                u0, Tend = prob.u_exact(0.0), num_procs * desc['level_params']['dt']
                if mesh is not None:
                    mesh.reset_traffic()
                ctrl.run(u0, 0.0, Tend, lane=lane)
                # one block (on the fused lane the graphs replay its copies unseen)
                traffic = dict(mesh.traffic) if mesh is not None else None
                _, times[name] = _timed_block(lambda: ctrl.run(u0, 0.0, Tend, lane=lane),
                                              f'mesh {label} {name}, lane {lane!r}', card)
                if mesh is not None and lane == 'stage':
                    print(f'times: mesh {label}, stage lane: copies and gathers a block {traffic}')
                del ctrl
                torch.cuda.empty_cache()
            full = times.get('no mesh, full complex FFT')
            print(f'times: mesh {label}, lane {lane!r}: {times["mesh"]:.3f} ms with the mesh against '
                  f'{times["no mesh"]:.3f} ms without, x{times["mesh"] / times["no mesh"]:.3f} on one card'
                  + (f'; without a mesh but with its full complex FFT solves {full:.3f} ms, the mesh '
                     f'x{times["mesh"] / full:.3f} of that' if full else '') + f' [{card}]')


# -- the device loop (conditional WHILE graph nodes) and the fused lanes' iterative solves -------------------------
GL_N, GL_MAXITER = 4096, 200  # the graph-loop phase's carry (float64) and its trip cap
GL_TRIPS = (0, 1, 37, GL_MAXITER + 50)  # asked trip counts: the last one stops at GL_MAXITER


def _gl_loop(loop):
    """A loop of ``min(t, GL_MAXITER)`` trips over ``(x, k, t)`` (float64 field, int32 counter, int32 target) and a
    nested pair (an outer loop whose every trip runs an inner loop of a data-dependent trip count): the same
    functions, run by ``loop`` (``device_while`` or ``plain_while``), build the captured graph and the plain loop."""
    import torch

    def flag(c):
        return (c[1] < c[2]) & (c[1] < GL_MAXITER)

    def body(c):
        x, k, t = c
        return 0.5 * x + torch.sin(x) + k.to(x.dtype) * 1e-3, k + 1, t

    def single(x, t):
        (x, k, _), trips = loop(flag, body, (x, torch.zeros_like(t), t))
        return x, k, trips

    def outer_body(c):
        x, k, t = c
        inner_t = (k % 5 + (x[0] > 0).to(k.dtype) * 3).to(t.dtype)  # 0-7 trips, decided on the device
        (y, j, _), _ = loop(flag, body, (x, torch.zeros_like(t), inner_t))
        return 0.25 * y + x / (1 + j.to(x.dtype)), k + 1, t

    def nested(x, t):
        (x, k, _), trips = loop(flag, outer_body, (x, torch.zeros_like(t), t))
        return x, k, trips

    return single, nested


def phase_graph_loop(card):
    """``device_while`` alone: one captured graph per loop (single, nested pair), replayed with inputs that ask
    for 0, 1, 37 and more than ``GL_MAXITER`` trips; the carry and the counter equal the plain loop's (a Python loop
    that reads the flag each trip) bit for bit.  Times a replay and the plain loop.  Returns the per-trip cost."""
    import torch

    from pysdc_tpu_torch.ops import graph_loop

    runtime, driver = graph_loop.versions()
    graph_loop.prepare('cuda')
    gen = torch.Generator(device='cuda').manual_seed(7)
    x_in = torch.empty(GL_N, dtype=torch.float64, device='cuda')
    t_in = torch.zeros((), dtype=torch.int32, device='cuda')
    captured, plain = _gl_loop(graph_loop.device_while), _gl_loop(graph_loop.plain_while)
    nodes0 = graph_loop.device_while.nodes
    graphs, outs = {}, {}
    for name, fn in zip(('single', 'nested'), captured):
        x_in.normal_(generator=gen)
        t_in.fill_(3)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dict(zip(('single', 'nested'), plain))[name](x_in.clone(), t_in.clone())  # warm-up, eager
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            x, k, trips = fn(x_in, t_in)
        if trips is not None:
            raise AssertionError(f'graph loop: a captured loop reported {trips} trips on the host')
        graphs[name], outs[name] = graph, (x, k)
    nodes = graph_loop.device_while.nodes - nodes0
    if nodes != 3:
        raise AssertionError(f'graph loop: {nodes} conditional nodes built, expected 3 (single, nested outer, inner)')
    checked = []
    for name, fn in zip(('single', 'nested'), plain):
        asks = GL_TRIPS if name == 'single' else (0, 1, 9)
        for ask in asks:
            x_in.normal_(generator=gen)
            t_in.fill_(ask)
            graphs[name].replay()
            torch.cuda.synchronize()
            x, k = (v.clone() for v in outs[name])
            want_x, want_k, trips = fn(x_in.clone(), t_in.clone())
            expected = min(ask, GL_MAXITER)
            if trips != expected or int(k) != expected or int(want_k) != expected or not torch.equal(x, want_x):
                raise AssertionError(f'graph loop: {name}, {ask} trips asked: replay counter {int(k)}, plain '
                                     f'{int(want_k)} in {trips} trips (expected {expected}), carry equal '
                                     f'{torch.equal(x, want_x)}, max diff {(x - want_x).abs().max().item():.3e}')
            checked.append(f'{name} {ask}->{expected}')

    def replay_ms(name, ask, reps=20):
        t_in.fill_(ask)
        return _event_ms(lambda i: graphs[name].replay(), reps)

    ms = {ask: replay_ms('single', ask) for ask in (1, 37, GL_MAXITER)}
    per_trip_us = 1e3 * (ms[GL_MAXITER] - ms[1]) / (GL_MAXITER - 1)
    t_in.fill_(37)
    plain_ms = _event_ms(lambda i: plain[0](x_in.clone(), t_in.clone()), 5)
    print(f'graph loop: CUDA runtime {runtime}, driver {driver}; {nodes} conditional WHILE nodes (one nested); the '
          f'replayed carry and counter equal the plain loop bit for bit in {len(checked)} cases ({", ".join(checked)}); '
          f'host reads of a replay 0; a replay of 1 / 37 / {GL_MAXITER} trips {ms[1]:.4f} / {ms[37]:.4f} / '
          f'{ms[GL_MAXITER]:.4f} ms ({per_trip_us:.2f} us a trip of 4 small kernels and the node), the plain loop of '
          f'37 trips {plain_ms:.4f} ms (37 host reads) [{card}]')
    return per_trip_us


# the sparse lane of bench.py:343-377 through the block controller (the slice's main path): one block is P_SF steps
P_SF, BLOCKS_SF, RESTOL_SF, MAXITER_SF = 4, 2, 1e-6, 8
# |uend(fused) - uend(stage)|, float32: both lanes run K2 and the same PCG.  Phase 7 measured the K2-against-rolls
# PCG gap on this path at 3.0e-6 (an H100 80GB HBM3 at 700 W); a different order of the same float32 sums can move
# uend no further than another SpMV route does, so the bound keeps that gap's 10x room (SPARSE_PLAIN_BOUND's)
SPARSE_FUSED_BOUND = 3e-5
# HeatND CG / GMRES through ShardedController(4), float64, one block cut to KRYLOV_FUSED_MAXITER iterations a step:
# a GMRES block of 8 iterations took 16.5 s replayed and 24 s on the stage lane (up to 47 restarts a solve) on an
# H100 80GB HBM3 at 700 W, and the phase runs each lane twice
KRYLOV_FUSED_N, KRYLOV_FUSED_BOUND, KRYLOV_FUSED_MAXITER = 2048, 1e-10, 2
# the profiler sees the kernels of one level of device loops, and drops some now and then (on an H100 80GB HBM3 at
# 700 W it saw 115 to 122 of the 122 K2 kernels of a sparse fused block whose PCG loops were one level deep), never
# those of a loop inside a loop: since the block's own loop is a device while, a block's PCG, CG and GMRES launches are
# nodes inside its node, and the launch counts inside graphs are the card's own (_counting_launches); the profiler's
# count is printed beside them and may not exceed them


def _sin_field(prob):
    import torch

    X, Y = prob.grids
    return torch.sin(math.pi * X) * torch.sin(math.pi * Y)


def _kernels_named(fn, name):
    """Kernels whose name holds ``name`` that the card ran over one call of ``fn()``, counted by the profiler."""
    return sum(e.count for e in _profiled(fn) if name in e.key)


@_counting_launches
def phase_sparse_fused(card):
    """The slice's main path: the sparse lane (VarCoeffDiffusion2D 1024^2 float32, M=4 LU, dt 1e-3) through
    ``ShardedController(4).run``, 2 blocks: ``'auto'`` takes the fused lane, whose graphs hold every PCG solve as a
    device ``while`` loop with K2 inside; against ``lane='stage'``: equal ``niter``, ``uend`` within
    SPARSE_FUSED_BOUND.  K2 in one replayed block (counted on the card at each launch; the profiler's count, which
    misses the PCG node inside the block loop's node, printed and no larger) equals the stage lane's SpMVs for the
    same block, which its PCG counts imply; no ``cont`` read and one fetch a march.
    Times a block on both lanes.  Returns the K2 launches through the wrapper (warm-up and capture) and the K2
    kernels of one replayed block."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv

    desc = _sparse_description(N_SPARSE, torch.float32, 'cuda', restol=RESTOL_SF, maxiter=MAXITER_SF)
    Tend, block = BLOCKS_SF * P_SF * DT_SPARSE, P_SF * DT_SPARSE
    label = (f'sparse fused: ShardedController({P_SF}) VarCoeffDiffusion2D {N_SPARSE}^2 fp32 M={M_MAIN} LU dt '
             f'{DT_SPARSE:g}, restol {RESTOL_SF:g}, maxiter {MAXITER_SF}, {BLOCKS_SF} blocks')
    fused, stage = (ShardedController(P_SF, {'logger_level': 30}, desc) for _ in range(2))
    k2_count = _LAUNCH_COUNTS['k2']
    u0 = _sin_field(fused.MS[0].levels[0].prob)
    dia_spmv.launches = 0
    start = time.perf_counter()
    uend, stats = fused.run(u0, 0.0, Tend)  # warm-up, capture, the replayed march
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, march_reads = dia_spmv.launches, dict(fused.host_reads)
    start = time.perf_counter()
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    lane, lane_s = ([v for k, v in st.items() if k.type == 'lane'] for st in (stats, stats_s))
    niter, niter_s = _niter(stats), _niter(stats_s)
    diff = (uend - uend_s).abs().max().item()
    op = fused.MS[0].levels[0].prob.A
    if lane != ['fused'] or lane_s != ['stage'] or niter != niter_s or len(niter) != BLOCKS_SF * P_SF \
            or not diff <= SPARSE_FUSED_BOUND or op.solver_kind != 'pcg':
        raise AssertionError(f'{label}: lanes {lane} / {lane_s}, niter {niter} against {niter_s}, |uend_fused - '
                             f'uend_stage| {diff:.3e}, solver {op.solver_kind}')
    if march_reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'{label}: host reads {march_reads}')

    # one block on each lane from the same u0: K2 in the replay against the stage lane's SpMVs
    rop = stage.MS[0].levels[0].prob.A
    trace, spmvs, solves, steps = [], rop.spmv_count, rop.pcg_solves, rop.pcg_steps
    rop.pcg_trace = trace
    dia_spmv.launches = 0
    k2_count.zero_()
    stage.run(u0, 0.0, block, lane='stage')
    torch.cuda.synchronize()
    stage_k2, stage_counted, spmvs = dia_spmv.launches, int(k2_count), rop.spmv_count - spmvs
    solves, steps = (rop.pcg_solves - solves) // P_SF, rop.pcg_steps - steps
    dia_spmv.launches = 0
    k2_count.zero_()
    fused.run_fused(u0, 0.0, block)  # the one-block march replays the same program
    torch.cuda.synchronize()
    device_k2, through_wrapper = int(k2_count), dia_spmv.launches
    profiled_k2 = _kernels_named(lambda: fused.run_fused(u0, 0.0, block), 'dia_spmv')
    implied = spmvs - solves - steps  # eval_f's and the residuals': the rest are one r0 a solve and one a PCG trip
    unrolled = implied + solves * (1 + 1000)  # every solve as its maxiter masked iterations, the pre-loop capture
    groups = [max(trace[i:i + P_SF]) for i in range(0, len(trace), P_SF)]
    if stage_k2 != spmvs or stage_counted != stage_k2 or device_k2 != stage_k2 or through_wrapper != 0 \
            or sum(groups) != steps or profiled_k2 > device_k2:
        raise AssertionError(f'{label}: K2 in one replayed block {device_k2} (counted on the card at each launch), '
                             f'{profiled_k2} (profiler), through the wrapper {through_wrapper}; the stage lane\'s block '
                             f'{stage_k2} launches ({stage_counted} counted on the card), {spmvs} SpMVs = {implied} + '
                             f'{solves} solves x (1 r0) + {steps} PCG trips (the trace\'s largest count a solve: '
                             f'{sum(groups)})')
    print(f'{label}: lane {lane[0]} (stage lane on request), niter {niter} on both, |uend_fused - uend_stage| '
          f'{diff:.3e} <= {SPARSE_FUSED_BOUND}; host reads {march_reads} a march; K2 in one replayed block '
          f'{device_k2} (counted on the card at each launch; the profiler saw {profiled_k2}, not the PCG node inside '
          f'the block\'s node; 0 through the wrapper) = the stage lane\'s '
          f'{stage_k2} SpMVs = {implied} eval_f / residual + {solves} solves x 1 r0 + {steps} PCG trips (per solve the '
          f'largest of the {P_SF} steps\' counts, {min(trace)}-{max(trace)}), against {unrolled} were each solve '
          f'unrolled to its maxiter; wall of the march {wall:.3f} s (capture included) / {wall_s:.3f} s stage [{card}]')

    reads = {}

    def stage_block():
        r0 = rop.host_reads
        out = stage.run(u0, 0.0, block, lane='stage')
        reads['stage'] = rop.host_reads - r0
        return out

    _, fused_ms = _timed_block(lambda: fused.run_fused(u0, 0.0, block), 'sparse fused block', card,
                               reads=lambda: dict(fused.host_reads))
    _, stage_ms = _timed_block(stage_block, 'sparse stage block', card, reads=lambda: f'{reads["stage"]} in the PCG loops')
    print(f'times: sparse {N_SPARSE}^2 fp32 block of {P_SF} steps: fused {fused_ms:.3f} ms against stage {stage_ms:.3f} '
          f'ms (x{stage_ms / fused_ms:.2f}) [{card}]')
    return launches, device_k2


def _krylov_fused_description(solver_type):
    import torch

    desc = _heat_description(KRYLOV_FUSED_N, torch.float64, 'cuda', restol=KRYLOV_RESTOL, maxiter=KRYLOV_FUSED_MAXITER)
    desc['problem_params'] = dict(desc['problem_params'], solver_type=solver_type, lintol=KRYLOV_LINTOL)
    desc['sweeper_params'] = dict(desc['sweeper_params'], num_nodes=M_FI)
    return desc


@_counting_launches
def phase_krylov_fused(card, covered):
    """HeatND 2048^2 float64 with ``solver_type`` CG, then GMRES (lintol and dt of phase 28) through
    ``ShardedController(4).run``, one block of KRYLOV_FUSED_MAXITER iterations a step: ``'auto'`` takes the fused
    lane (each solve a device ``while``, a GMRES restart's Arnoldi loop a node inside the restart loop's), against
    ``lane='stage'``: equal ``niter``, ``uend`` within KRYLOV_FUSED_BOUND.  K1 in a replayed block (counted on the
    card at each launch: every solve is a node inside the block loop's node, which the profiler does not see)
    equals the stage lane's applies, all on bands; no ``cont`` read and one fetch a march.  ms a block on both lanes (CUDA events; a block of
    GMRES costs seconds, so each lane runs it as few times as the gates need).  Returns the K1 launches through
    the wrapper (warm-up and capture) by kind, and the float64 yardstick of K1."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    launches = {}
    Tend = P_FI * DT
    for kind in ('CG', 'GMRES'):
        desc = _krylov_fused_description(kind)
        label = (f'krylov fused: ShardedController({P_FI}) HeatND {KRYLOV_FUSED_N}^2 periodic fp64 '
                 f'solver_type={kind!r} lintol {KRYLOV_LINTOL:g}, M={M_FI} LU, dt {DT:g}, one block')
        fused, stage = (ShardedController(P_FI, {'logger_level': 30}, desc) for _ in range(2))
        k1_count = _LAUNCH_COUNTS['k1']
        shapes = set()
        applies = _count_applies(stage, shapes)
        prob = stage.MS[0].levels[0].prob
        prob.A.krylov_trace = []
        u0 = prob.u_exact(0.0)
        cross_stencil_2d.launches = 0
        cross_stencil_2d.paths = {'bands': 0, 'general': 0}
        start = time.perf_counter()
        uend, stats = fused.run(u0, 0.0, Tend)  # warm-up, capture, the first replayed march
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches[kind] = cross_stencil_2d.launches
        reads = dict(fused.host_reads)
        cross_stencil_2d.launches = 0
        k1_count.zero_()
        reads0 = prob.A.host_reads
        stage_ms, (uend_s, stats_s) = _events_ms(lambda: stage.run(u0, 0.0, Tend, lane='stage'))
        stage_k1, stage_counted, stage_reads = cross_stencil_2d.launches, int(k1_count), prob.A.host_reads - reads0
        by_path = dict(cross_stencil_2d.paths)
        lane = [v for k, v in stats.items() if k.type == 'lane']
        niter, niter_s = _niter(stats), _niter(stats_s)
        diff = (uend - uend_s).abs().max().item()
        if lane != ['fused'] or niter != niter_s or len(niter) != P_FI or not diff <= KRYLOV_FUSED_BOUND \
                or by_path != {'bands': launches[kind] + stage_k1, 'general': 0}:
            raise AssertionError(f'{label}: lane {lane}, niter {niter} against {niter_s}, |uend_fused - uend_stage| '
                                 f'{diff:.3e}, K1 by path {by_path}')
        _covered_by(covered, prob.A._cross_terms, shapes, label)
        # one replayed block, timed, its K1 counted on the device (and for CG by the profiler in one more)
        k1_count.zero_()
        cross_stencil_2d.launches = 0
        fused_ms, (uend2, _) = _events_ms(lambda: fused.run_fused(u0, 0.0, Tend))
        device_k1, through_wrapper = int(k1_count), cross_stencil_2d.launches
        # every solve is a node inside the block loop's body: the profiler does not see its kernels
        if reads != {'cont': 0, 'fetch': 1} or through_wrapper != 0 or device_k1 != stage_k1 or stage_counted != stage_k1 \
                or stage_k1 != sum(applies.values()) or not torch.equal(uend2, uend):
            raise AssertionError(f'{label}: host reads {reads}, K1 in a replayed block {device_k1} (counted on the '
                                 f'card at each launch), through the wrapper {through_wrapper}; the stage lane\'s '
                                 f'block {stage_k1} launches, {stage_counted} counted on the card, applies {applies}; '
                                 f'the replay equals the first march {torch.equal(uend2, uend)}')
        trace = list(prob.A.krylov_trace)
        iters = [k for _, k, _ in trace]
        profiled = 'not run over nested nodes'
        detail = (f'restarts a solve {min(iters)}-{max(iters)}, Arnoldi steps a restart '
                  f'{sorted(set(a for _, _, ar in trace for a in ar))}' if kind == 'GMRES'
                  else f'CG iterations a solve {min(iters)}-{max(iters)}')
        print(f'{label}: lane {lane[0]}, niter {niter} = the stage lane\'s, |uend_fused - uend_stage| {diff:.3e} <= '
              f'{KRYLOV_FUSED_BOUND}; {len(trace)} solves (one a step, node and iteration), {detail}; K1 in a replayed '
              f'block {device_k1} (counted on the card at each launch; profiler {profiled}) = the stage lane\'s applies, all on bands at '
              f'{sorted(shapes)}; host reads {reads} fused against {stage_reads} in the stage lane\'s {kind} loops; '
              f'wall {wall:.3f} s for the first fused march (capture included) [{card}]')
        print(f'times: krylov {kind} {KRYLOV_FUSED_N}^2 fp64 block of {P_FI} steps: fused {fused_ms:.3f} ms (a replay) '
              f'against stage {stage_ms:.3f} ms (x{stage_ms / fused_ms:.2f}), CUDA events [{card}]')
        del fused, stage
        torch.cuda.empty_cache()
    launches['float64 yardstick'] = _k1_float64_library(card)
    return launches


def _events_ms(fn):
    """(ms on the card by CUDA events, result) of one call of ``fn()``."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _k1_float64_library(card):
    """K1 in float64 at (2048, 2048) and (3, 2048, 2048) beside its library yardstick (``F.conv2d`` on a
    circularly padded input) and its plain version, CUDA events, inputs rotated past the L2 cache."""
    import torch
    import torch.nn.functional as F

    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.kernels.stencil import _roll_cross_2d, cross_stencil_2d

    terms = HeatND(nvars=(64, 64), nu=0.1, bc='periodic', dtype=torch.float64, device='cuda').A._cross_terms
    (cx, ox), (cy, oy) = terms
    rx, ry = max(abs(o) for o in ox), max(abs(o) for o in oy)
    w = torch.zeros((1, 1, 2 * rx + 1, 2 * ry + 1), dtype=torch.float64, device='cuda')
    for c, o in zip(cx, ox):
        w[0, 0, rx + o, ry] += c
    for c, o in zip(cy, oy):
        w[0, 0, rx, ry + o] += c
    gen = torch.Generator(device='cuda').manual_seed(11)
    out = {}
    for shape in ((2048, 2048), (3, 2048, 2048)):
        nbytes = math.prod(shape) * 8
        nbuf = max(2, math.ceil(3 * L2_BYTES / nbytes))
        us = [torch.randn(shape, generator=gen, dtype=torch.float64, device='cuda') for _ in range(nbuf)]
        padded = [F.pad(u.reshape((-1, 1) + shape[-2:]), (ry, ry, rx, rx), mode='circular') for u in us]
        reps = 4 * nbuf
        k1_ms = _event_ms(lambda i: cross_stencil_2d(us[i % nbuf], terms), reps)
        lib_ms = _event_ms(lambda i: F.conv2d(padded[i % nbuf], w), reps)
        plain_ms = _event_ms(lambda i: _roll_cross_2d(us[i % nbuf], terms), reps)
        lib_err = (F.conv2d(padded[0], w).reshape(shape) - cross_stencil_2d(us[0], terms)).abs().max().item()
        bound_ms = 1e3 * 2 * nbytes / HBM_BYTES_PER_S
        out[str(shape)] = dict(ms=k1_ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=bound_ms)
        print(f'times: K1 {shape} fp64: {k1_ms:.4f} ms eager ({100 * bound_ms / k1_ms:.0f}% of its bytes bound '
              f'{bound_ms:.4f} ms), plain {plain_ms:.4f} ms, library yardstick F.conv2d (float64, circular pad) '
              f'{lib_ms:.4f} ms (max abs diff to K1 {lib_err:.3e}) [{card}]')
        del us, padded
    return out


# -- the fused lanes as the JAX package's: spectral problems, the linearized sweeper, the direct sparse solves -----------
# Rayleigh-Benard at the reference class's own resolution (RayleighBenard.py: nx=256, nz=64), float64, IMEX M=3 LU / PIC,
# dt 0.01, restol -1, maxiter 4, through ShardedController(4), 2 blocks
RBC_FUSED = dict(nx=256, nz=64, Rayleigh=2e6, Prandtl=1)
P_RBC, BLOCKS_RBC, DT_RBC, MAXITER_RBC = 4, 2, 0.01, 4
SPECTRAL_FUSED_RTOL = 1e-12  # |uend(fused) - uend(stage)| / max|uend(stage)|, float64, the same library on both
SPECTRAL_SMALL = ('HeatChebyshev1D 32', 'Burgers1D 48', 'Heat2DChebyshev 24^2')  # _model_cases, card against CPU
LINEARIZED_FUSED_BOUND = 1e-11  # float64 HeatND 32^2: fused against stage, and card against CPU
# the direct sparse solves: HeatND 1D Dirichlet-0 through the 'banded' solver, VarCoeffDiffusion2D through block CR
DIRECT_FUSED = {
    'HeatND 4095 banded': (4095, 0.01),
    'VarCoeffDiffusion2D 256^2 block_tridiag': ((256, 256), 1e-3),
}
DIRECT_FUSED_BOUND = 1e-12  # float64, fields of size <= 1
# steps a block of phase 71 (4 until PR 16): each step assembles its own operator on the host, and the CPU leg runs
# on one thread, so the phase's time grows with its depth; cut to keep the whole script near half its limit
P_DIRECT = 2


@contextlib.contextmanager
def _one_cpu_thread():
    """The CPU legs of phases 70-71 on one thread: on an H100's host the CPU torch's LAPACK (MKL) has hung in a
    multithreaded complex solve (phase 60) and in a multithreaded batched float64 inverse (block CR's factors of
    a VarCoeffDiffusion2D 256^2 problem, after phase 70's single-threaded solves)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _rbc_description(device):
    import torch

    from pysdc_tpu_torch import IMEXSweeper
    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard

    return dict(problem_class=RayleighBenard, problem_params=dict(RBC_FUSED, dtype=torch.float64, device=device),
                sweeper_class=IMEXSweeper, sweeper_params=dict(num_nodes=3, QI='LU', QE='PIC'),
                level_params=dict(dt=DT_RBC, restol=-1.0), step_params=dict(maxiter=MAXITER_RBC))


def _lane(stats):
    return [v for k, v in stats.items() if k.type == 'lane']


def _one_graph_a_block(ctrl, label):
    programs = list(ctrl._fused_fn._programs.values())
    if len(programs) != 1 or list(programs[0].graphs) != ['block']:
        raise AssertionError(f'{label}: programs {[list(p.graphs) for p in programs]}, expected one graph a block')


# (dtype, batch, rows) of the dense solves held inside a device while loop's body: each route of ops/linalg.py (a
# batch padded onto cuBLAS's batched LU, one matrix, one or two systems, the pivoted blocked LU from 512 rows on);
# random matrices plus 2 n I; beside them the matrices of LU_PIVOTING_CASES, which need pivoting across their halves
LINALG_LOOP_CASES = (('complex128', 2, 32), ('complex128', 2, 64), ('complex128', 1, 600), ('complex128', 12, 1024),
                     ('complex128', 1024, 256), ('float64', 2048, 2), ('float64', 128, 256), ('float64', 1, 512),
                     ('float32', 3, 520))


def _linalg_in_a_loop(card):
    """``ops/linalg.py``'s solve (and inverse) inside the body of a device ``while`` of 2 trips, captured and
    replayed, equal bit for bit to the eager call: what a fused block's loop needs of the dense solves.  Each case
    is also held against LAPACK on the CPU (float64 and complex128; the first two matrices of a random case, every
    matrix of a pivoting case) to the CPU test's gate, ``max(1e-13, 4 eps cond(A))``."""
    import torch

    from pysdc_tpu_torch.ops import graph_loop, linalg

    graph_loop.prepare(torch.device('cuda'))
    gen = torch.Generator(device='cuda').manual_seed(5)
    cases = []
    for dtype_name, batch, n in LINALG_LOOP_CASES:
        dtype = getattr(torch, dtype_name)
        A = torch.randn((batch, n, n), dtype=dtype, device='cuda', generator=gen) \
            + 2 * n * torch.eye(n, dtype=dtype, device='cuda')
        cases.append((f'{dtype_name} ({batch}, {n}, {n})', A, torch.randn((batch, n, 1), dtype=dtype, device='cuda',
                                                                            generator=gen)))
    for name, factor in LU_PIVOTING_CASES:
        A, B = _pivoting_matrix(name, factor)
        cases.append((f'{name} {tuple(A.shape)}', A.cuda(), B.cuda()))
    lines = []
    for i, (label, A, B) in enumerate(cases):
        n = A.shape[-1]
        for name, op, args in (('solve', linalg.solve, (A, B)), ('inv', linalg.inv, (A,))):
            if name == 'inv' and (n > 256 and A.shape[0] > 1 or n > 600):
                continue
            want = op(*args)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                op(*args)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                (trips, got), _ = graph_loop.device_while(
                    lambda c: c[0] < 2, lambda c: (c[0] + 1, op(*args)),
                    (torch.zeros((), dtype=torch.int64, device='cuda'), torch.zeros_like(want)))
            graph.replay()
            torch.cuda.synchronize()
            if int(trips) != 2 or not torch.equal(got, want):
                raise AssertionError(f'spectral fused: linalg.{name} {label} in a device while body: {int(trips)} '
                                     f'trips, |got - eager| {(got - want).abs().max().item():.3e}')
            del graph
        count = 2 if i < len(LINALG_LOOP_CASES) else A.shape[0]  # every matrix of a pivoting case
        head = A[:count].cpu().to(torch.complex128 if A.is_complex() else torch.float64)
        bound, _ = _lapack_bound(head)
        with _one_cpu_thread():
            want = torch.linalg.solve(head, B[:count].cpu().to(head.dtype))
        rel = _rel_err(linalg.solve(A[:count], B[:count]), want)
        if A.dtype in (torch.float64, torch.complex128) and not rel <= bound:
            raise AssertionError(f'spectral fused: linalg.solve {label} against LAPACK: {rel:.3e} > {bound:.3e}')
        lines.append(f'{label} (LAPACK {rel:.1e})')
    print(f'spectral fused: ops/linalg.py inside a device while body, captured and replayed, bit for bit the eager '
          f'call (solve, and inv up to 600 rows): {"; ".join(lines)} [{card}]')


def phase_spectral_fused(card):
    """Rayleigh-Benard (256, 64) float64 through ``ShardedController(4).run``, 2 blocks: ``'auto'`` takes the fused
    lane, one graph a block, equal ``niter`` and ``uend`` within SPECTRAL_FUSED_RTOL of ``lane='stage'``, no ``cont``
    read and one fetch (first, ``ops/linalg.py`` inside a device ``while`` body at LINALG_LOOP_CASES); the peak device memory; the kernels of the batched solve over the modes; ms a block on both
    lanes (CUDA events) and the idle share.  Then the smaller spectral problems on the fused lane, card against
    CPU (equal ``niter``, ``uend`` within MODELS_RTOL)."""
    import torch

    from pysdc_tpu_torch import ShardedController

    _linalg_in_a_loop(card)
    desc = _rbc_description('cuda')
    Tend, block = BLOCKS_RBC * P_RBC * DT_RBC, P_RBC * DT_RBC
    label = (f'spectral fused: ShardedController({P_RBC}) RayleighBenard {RBC_FUSED["nx"]}x{RBC_FUSED["nz"]} fp64 IMEX '
             f'M=3 LU/PIC dt {DT_RBC:g}, restol -1, maxiter {MAXITER_RBC}, {BLOCKS_RBC} blocks')
    fused = stage = ShardedController(P_RBC, {'logger_level': 30}, desc)  # one controller runs both lanes
    u0 = fused.MS[0].levels[0].prob.u_exact(0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    uend, stats = fused.run(u0, 0.0, Tend)  # lane 'auto': warm-up, capture, the march
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 2**20
    reads = dict(fused.host_reads)
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    niter, niter_s = _niter(stats), _niter(stats_s)
    rel = ((uend - uend_s).abs().max() / uend_s.abs().max()).item()
    if _lane(stats) != ['fused'] or _lane(stats_s) != ['stage'] or niter != niter_s \
            or len(niter) != BLOCKS_RBC * P_RBC or not rel <= SPECTRAL_FUSED_RTOL or not bool(uend.isfinite().all()):
        raise AssertionError(f'{label}: lanes {_lane(stats)} / {_lane(stats_s)}, niter {niter} against {niter_s}, '
                             f'|uend_fused - uend_stage| / max|uend_stage| {rel:.3e}')
    if reads != {'cont': 0, 'fetch': 1}:
        raise AssertionError(f'{label}: host reads {reads}')
    _one_graph_a_block(fused, label)
    print(f'{label}: lane {_lane(stats)[0]} under \'auto\', one graph a block, niter {niter} = the stage lane\'s, '
          f'|uend_fused - uend_stage| / max|uend_stage| {rel:.3e} <= {SPECTRAL_FUSED_RTOL}; host reads {reads}; peak '
          f'device memory {peak:.0f} MiB (warm-up, capture and march); wall {wall:.3f} s with the capture [{card}]')

    # the batched solve over the modes: one node's shift, the block's 4 steps
    prob = fused.MS[0].levels[0].prob
    rhs = u0.unsqueeze(0).expand((P_RBC,) + tuple(u0.shape)).contiguous()
    shift = torch.tensor(0.3 * DT_RBC, dtype=torch.float64, device='cuda')
    print(f'spectral fused: the batched solve over the {RBC_FUSED["nx"]} modes x {P_RBC} steps of one node '
          f'(ops/linalg.py, torch asked for cuSOLVER), kernels by device time:')
    _device_busy(lambda: prob.solve_system(rhs, shift, rhs, 0.0), top=8)

    _, fused_ms = _timed_block(lambda: fused.run_fused(u0, 0.0, block), 'spectral fused block', card,
                               reads=lambda: dict(fused.host_reads))
    _, stage_ms = _timed_block(lambda: stage.run(u0, 0.0, block, lane='stage'), 'spectral stage block', card)
    print(f'times: RayleighBenard {RBC_FUSED["nx"]}x{RBC_FUSED["nz"]} fp64 block of {P_RBC} steps: fused {fused_ms:.3f} '
          f'ms against stage {stage_ms:.3f} ms (x{stage_ms / fused_ms:.2f}), CUDA events [{card}]')
    del fused, stage
    torch.cuda.empty_cache()

    cases = _model_cases()
    lines = []
    for name in SPECTRAL_SMALL:
        problem, params, sweeper, sp, level, maxiter, Tend = cases[name]
        runs = {}
        for device in ('cuda', 'cpu'):
            desc = dict(problem_class=problem, problem_params=dict(params, dtype=torch.float64, device=device),
                        sweeper_class=sweeper, sweeper_params=sp, level_params=level, step_params=dict(maxiter=maxiter))
            ctrl = ShardedController(2, {'logger_level': 30}, desc)
            u, st = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
            runs[device] = (u.cpu(), _niter(st), _lane(st), dict(ctrl.host_reads))
        (u_card, it_card, lane_card, reads_card), (u_cpu, it_cpu, lane_cpu, _) = runs['cuda'], runs['cpu']
        rel = _rel_err(u_card, u_cpu)
        if lane_card != lane_cpu or lane_card != ['fused'] or it_card != it_cpu or not rel <= MODELS_RTOL \
                or reads_card != {'cont': 0, 'fetch': 1}:
            raise AssertionError(f'spectral fused: {name} lanes {lane_card} / {lane_cpu}, niter {it_card} against the '
                                 f'CPU\'s {it_cpu}, uend rel diff {rel:.3e}, host reads {reads_card}')
        lines.append(f'{name}: niter {it_card}, uend rel diff {rel:.3e}')
    print(f'spectral fused: ShardedController(2) fp64 on the fused lane, card against CPU (MODELS_RTOL {MODELS_RTOL}): '
          + '; '.join(lines) + f' [{card}]')


@_counting_launches
def phase_linearized_fused(card):
    """Phase 60's configuration (``LinearizedImplicitParallel`` on HeatND 32^2 float64, the Jacobian by ``jacfwd``
    through K1) through ``ShardedController(4).run``, one block: ``'auto'`` takes the fused lane, one graph a block,
    equal ``niter`` and ``uend`` within LINEARIZED_FUSED_BOUND of the stage lane and of the CPU's fused run; K1 in
    a replayed block (counted on the card) equals the stage lane's (counted the same way).  Returns the K1
    launches through the wrapper (warm-up and capture)."""
    import torch

    from pysdc_tpu_torch import LinearizedImplicitParallel, ShardedController
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

    def description(device):
        return dict(problem_class=HeatND,
                    problem_params=dict(nvars=(N_LINEARIZED, N_LINEARIZED), nu=0.1, freq=2, bc='periodic',
                                        dtype=torch.float64, device=device),
                    sweeper_class=LinearizedImplicitParallel,
                    sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', jacobian=0, basis='Q'),
                    level_params=dict(dt=0.01, restol=1e-10), step_params=dict(maxiter=20))

    label = f'linearized fused: ShardedController(4) LinearizedImplicitParallel HeatND {N_LINEARIZED}^2 fp64, one block'
    k1_count = _LAUNCH_COUNTS['k1']
    fused = stage = ShardedController(4, {'logger_level': 30}, description('cuda'))  # one controller, both lanes
    u0, Tend = fused.MS[0].levels[0].prob.u_exact(0.0), 0.04
    cross_stencil_2d.launches = 0
    uend, stats = fused.run(u0, 0.0, Tend)
    launches, reads = cross_stencil_2d.launches, dict(fused.host_reads)
    k1_count.zero_()
    cross_stencil_2d.launches = 0
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    stage_k1, stage_launches = int(k1_count), cross_stencil_2d.launches
    k1_count.zero_()
    cross_stencil_2d.launches = 0
    uend_r, _ = fused.run_fused(u0, 0.0, Tend)
    replay_k1, through_wrapper = int(k1_count), cross_stencil_2d.launches
    with _one_cpu_thread():
        cpu = ShardedController(4, {'logger_level': 30}, description('cpu'))
        uend_c, stats_c = cpu.run(cpu.MS[0].levels[0].prob.u_exact(0.0), 0.0, Tend)
    niter, niter_s, niter_c = _niter(stats), _niter(stats_s), _niter(stats_c)
    diff, gap = (uend - uend_s).abs().max().item(), (uend.cpu() - uend_c).abs().max().item()
    if _lane(stats) != ['fused'] or _lane(stats_c) != ['fused'] or niter != niter_s or niter != niter_c \
            or len(niter) != 4 or not diff <= LINEARIZED_FUSED_BOUND or not gap <= LINEARIZED_FUSED_BOUND:
        raise AssertionError(f'{label}: lanes {_lane(stats)} / CPU {_lane(stats_c)}, niter {niter}, stage {niter_s}, '
                             f'CPU {niter_c}; |uend_fused - uend_stage| {diff:.3e}, card against CPU {gap:.3e}')
    if reads != {'cont': 0, 'fetch': 1} or launches < 1 or through_wrapper != 0 or replay_k1 != stage_k1 \
            or stage_k1 != stage_launches or not torch.equal(uend_r, uend):
        raise AssertionError(f'{label}: host reads {reads}; K1 in a replayed block {replay_k1} (counted on the card), '
                             f'through the wrapper {through_wrapper}; the stage lane\'s {stage_k1} (counted on the card) '
                             f'of {stage_launches} launches; the replay equals the first {torch.equal(uend_r, uend)}')
    _one_graph_a_block(fused, label)
    print(f'{label}: lane fused under \'auto\', one graph a block, niter {niter} = the stage lane\'s = the CPU\'s, '
          f'|uend_fused - uend_stage| {diff:.3e}, card against CPU {gap:.3e} <= {LINEARIZED_FUSED_BOUND}; host reads '
          f'{reads}; K1 in a replayed block {replay_k1} (counted on the card at each launch; 0 through the wrapper) = '
          f'the stage lane\'s {stage_k1}; {launches} through the wrapper in warm-up and capture [{card}]')
    return launches


@_counting_launches
def phase_direct_fused(card):
    """The direct sparse solves with the fused lane's device ``dt``: HeatND 4095 Dirichlet-0 (``'banded'``, as
    block CR over 2 x 2 blocks) and VarCoeffDiffusion2D 256^2 (``'block_tridiag'``, prepared, with its refinement
    loop) float64 through ``ShardedController(P_DIRECT).run``, one block each: ``'auto'`` takes the fused lane, one
    graph a block, equal ``niter`` and ``uend`` within DIRECT_FUSED_BOUND of the stage lane and of the CPU's fused run;
    K2 in a replayed block (counted on the card) equals the stage lane's.  Returns the K2 launches through the wrapper
    (warm-up and capture)."""
    import torch

    from pysdc_tpu_torch import GenericImplicit, ShardedController
    from pysdc_tpu_torch.models.heat import HeatND
    from pysdc_tpu_torch.models.var_diffusion import VarCoeffDiffusion2D
    from pysdc_tpu_torch.ops.kernels.dia import dia_spmv

    k2_count = _LAUNCH_COUNTS['k2']
    total = 0
    for name, (nvars, dt) in DIRECT_FUSED.items():
        def description(device):
            if isinstance(nvars, int):
                problem = HeatND
                params = dict(nvars=nvars, nu=0.1, freq=2, bc='dirichlet-zero', backend='sparse')
            else:
                problem = VarCoeffDiffusion2D
                params = dict(nvars=nvars, coeff_fn=_coeff, solver='block_tridiag')
            return dict(problem_class=problem, problem_params=dict(params, dtype=torch.float64, device=device),
                        sweeper_class=GenericImplicit, sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU'),
                        level_params=dict(dt=dt, restol=1e-10), step_params=dict(maxiter=20))

        def start(ctrl):
            prob = ctrl.MS[0].levels[0].prob
            return prob.u_exact(0.0) if isinstance(nvars, int) else _sin_field(prob)

        label = f'direct fused: ShardedController({P_DIRECT}) {name} fp64 M=3 LU dt {dt:g}, one block'
        # one controller runs both lanes: each step assembles its own operator (and HeatND its preconditioner's
        # 4095 x 4095 eigenbasis), which costs seconds of host time
        fused = stage = ShardedController(P_DIRECT, {'logger_level': 30}, description('cuda'))
        u0, Tend = start(fused), P_DIRECT * dt
        dia_spmv.launches = 0
        start_t = time.perf_counter()
        uend, stats = fused.run(u0, 0.0, Tend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start_t
        launches, reads = dia_spmv.launches, dict(fused.host_reads)
        k2_count.zero_()
        dia_spmv.launches = 0
        uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
        stage_k2, stage_launches = int(k2_count), dia_spmv.launches
        k2_count.zero_()
        dia_spmv.launches = 0
        fused_ms, (uend_r, _) = _events_ms(lambda: fused.run_fused(u0, 0.0, Tend))
        replay_k2, through_wrapper = int(k2_count), dia_spmv.launches
        stage_ms, _ = _events_ms(lambda: stage.run(u0, 0.0, Tend, lane='stage'))
        with _one_cpu_thread():
            cpu = ShardedController(P_DIRECT, {'logger_level': 30}, description('cpu'))
            uend_c, stats_c = cpu.run(start(cpu), 0.0, Tend)
        niter, niter_s, niter_c = _niter(stats), _niter(stats_s), _niter(stats_c)
        diff, gap = (uend - uend_s).abs().max().item(), (uend.cpu() - uend_c).abs().max().item()
        kind = fused.MS[0].levels[0].prob.A.solver_kind
        if _lane(stats) != ['fused'] or _lane(stats_c) != ['fused'] or niter != niter_s or niter != niter_c \
                or len(niter) != P_DIRECT or max(niter) >= 20 or not diff <= DIRECT_FUSED_BOUND \
                or not gap <= DIRECT_FUSED_BOUND or kind != name.split()[-1]:
            raise AssertionError(f'{label}: solver {kind}, lanes {_lane(stats)} / CPU {_lane(stats_c)}, niter {niter}, '
                                 f'stage {niter_s}, CPU {niter_c}; |uend_fused - uend_stage| {diff:.3e}, card against '
                                 f'CPU {gap:.3e}')
        if reads != {'cont': 0, 'fetch': 1} or launches < 1 or through_wrapper != 0 or replay_k2 != stage_k2 \
                or stage_k2 != stage_launches or not torch.equal(uend_r, uend):
            raise AssertionError(f'{label}: host reads {reads}; K2 in a replayed block {replay_k2} (counted on the '
                                 f'card), through the wrapper {through_wrapper}; the stage lane\'s {stage_k2} (counted '
                                 f'on the card) of {stage_launches} launches; the replay equals the first '
                                 f'{torch.equal(uend_r, uend)}')
        _one_graph_a_block(fused, label)
        total += launches
        print(f'{label}: solver {kind}, lane fused under \'auto\', one graph a block, niter {niter} = the stage '
              f'lane\'s = the CPU\'s, |uend_fused - uend_stage| {diff:.3e}, card against CPU {gap:.3e} <= '
              f'{DIRECT_FUSED_BOUND}; host reads {reads}; K2 in a replayed block {replay_k2} (counted on the card at each '
              f'launch; 0 through the wrapper) = the stage lane\'s {stage_k2}; {launches} K2 launches through the '
              f'wrapper in warm-up and capture; wall {wall:.3f} s with the capture [{card}]')
        print(f'times: {name} fp64 block of {P_DIRECT} steps: fused {fused_ms:.3f} ms (a replay) against stage '
              f'{stage_ms:.3f} ms '
              f'(x{stage_ms / fused_ms:.2f}), CUDA events [{card}]')
        del fused, stage
        torch.cuda.empty_cache()
    return total


# -- the dense solves from 512 rows on: the pivoted blocked LU, its panel kernel, and the circuit problems -------------
# (phases 72-73; main() runs them right after the build, while the card's memory is free)
# NVIDIA H100 SXM data sheet, 700 W: FP64 with the tensor cores (cuBLAS's DGEMM / ZGEMM take them; 34e12 without)
FP64_FLOP_PER_S = 67e12
# Rayleigh-Benard at twice the reference class's vertical resolution: 4 x 128 = 512 coupled rows a Fourier mode, the
# first size whose solves take the pivoted route; the rest as phase 69
RBC_LU = dict(nx=256, nz=128, Rayleigh=2e6, Prandtl=1)
BLOCKS_RBC_LU = 2
# RayleighBenard 8x128 card against CPU, relative to max|uend|: its modes' operators have cond up to 1e8 (factor
# 1e-3), so two backward-stable solves of one system may differ by 4 eps cond ~ 1e-7 relative
RBC_LU_CPU_RTOL = 1e-7
RBC_LU_SMALL = dict(nx=8, nz=128, Rayleigh=2e6, Prandtl=1)  # one block, card against CPU
# the circuit problems of the fused lane (float64, IMEX M=3 RADAU-RIGHT LU / EE, dt 0.05, restol 1e-10, 2 blocks of 4);
# the buck converter at fsw 7, so that no node time lands on a switching instant (tests/test_torch_circuits_fused.py)
CIRCUITS = {'Piline': {}, 'BuckConverter': dict(fsw=7.0), 'BatteryNCapacitors': dict(ncapacitors=2)}
CIRCUIT_BOUND = 1e-12  # float64, absolute; fields of size <= 10
# (name, factor): the matrices of the pivoted route's checks that need pivoting across the whole matrix
LU_PIVOTING_CASES = (('RayleighBenard 8x128 modes', 1e-2), ('RayleighBenard 8x256 modes', 1e-3),
                     ('HeatChebyshev1D 512', 1e-2), ('zero leading block 512', None))


def _pivoting_matrix(name, factor):
    """A matrix (batch, n, n) on the CPU that needs pivoting across its halves, and a right-hand side: a spectral
    problem's shifted operator with its tau rows, as ``TensorProductSpectral.solve_shifted`` builds it, or
    ``[[0, I + N1], [I + N2, N3]]`` (each N 0.1 x a Gaussian, numpy seed 1) of 512 rows."""
    import torch

    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard
    from pysdc_tpu_torch.models.spectral_problems import HeatChebyshev1D

    rng = np.random.default_rng(1)
    if factor is None:
        h = 256
        N1, N2, N3 = (0.1 * rng.standard_normal((h, h)) for _ in range(3))
        A = torch.as_tensor(np.block([[np.zeros((h, h)), np.eye(h) + N1], [np.eye(h) + N2, N3]])).unsqueeze(0)
    else:
        prob = (HeatChebyshev1D(nvars=512, device='cpu') if name.startswith('Heat')
                else RayleighBenard(nx=8, nz=int(name.split('x')[1].split()[0]), device='cpu'))
        spec = prob.spec
        like = torch.zeros((1,), dtype=torch.complex128)
        keep = torch.as_tensor(spec.keep_mask)
        A = (spec._dev('M_all', like) + factor * spec._dev('L_all', like)) * keep[:, :, None] \
            + spec._dev('bc_rows', like)
    B = torch.as_tensor(rng.standard_normal(tuple(A.shape[:-1]) + (2,))).to(A.dtype)
    return A, B


def _lapack_bound(A):
    """The CPU test's gate: two backward-stable solves differ by up to a few eps x cond(A)."""
    import torch

    with _one_cpu_thread():
        cond = float(torch.linalg.cond(A).max())
    return max(1e-13, 4 * torch.finfo(torch.float64).eps * cond), cond


def _kernel_checks(card):
    """Both kernels of the dense LU on each matrix of LU_PIVOTING_CASES against their plain versions on the same
    inputs on the card: ``lu_panel`` on the first block of BLOCK columns (LAPACK's ``getrf`` of the panel: the same
    rows, the factors to 1e-12 of their largest entry), and ``lu_swap_trsm`` on the blocks at columns 0 (right of
    the panel only), BLOCK (both sides) and n - BLOCK (left only), each block's panel factored first by the plain
    version (the row interchanges bit for bit, ``U12`` to 1e-12 of its largest entry).  Phase 69 holds the whole
    route on these matrices against LAPACK.  Returns the largest difference of each kernel."""
    import torch

    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import dense_lu

    worst, lines, jb = {'lu_panel': 0.0, 'lu_swap_trsm': 0.0}, [], linalg.BLOCK
    for name, factor in LU_PIVOTING_CASES:
        A, _ = _pivoting_matrix(name, factor)
        A = A.cuda()
        n = A.shape[-1]
        panel = A[:, :, :jb].clone()
        plain = panel.clone()
        perm = dense_lu.lu_panel(panel)
        plain_perm = dense_lu.plain_panel(plain)
        err = (panel - plain).abs().max().item()
        same_rows = torch.equal(perm, plain_perm)
        if not same_rows or not err <= 1e-12 * plain.abs().max().item():
            raise AssertionError(f'dense LU: lu_panel on {name} {tuple(panel.shape)} against its plain version: rows '
                                 f'equal {same_rows}, max abs diff {err:.3e}')
        worst['lu_panel'] = max(worst['lu_panel'], err)
        swaps = []
        for j in (0, jb, n - jb):
            base = A.clone()
            rows = dense_lu.plain_panel(base[:, j:, j:j + jb])
            got, want = base.clone(), base.clone()
            dense_lu.lu_swap_trsm(got, j, jb, rows)
            dense_lu.plain_swap_trsm(want, j, jb, rows)
            swapped = torch.equal(got[:, :, :j + jb], want[:, :, :j + jb]) and torch.equal(got[:, j + jb:],
                                                                                          want[:, j + jb:])
            diff = (got - want).abs().max().item()
            scale = want[:, j:j + jb, j + jb:].abs().max().item() if j + jb < n else 0.0
            if not swapped or not diff <= 1e-12 * scale:
                raise AssertionError(f'dense LU: lu_swap_trsm on {name} block {j} against its plain version: row '
                                     f'interchanges equal {swapped}, max abs diff {diff:.3e} (U12 up to {scale:.3e})')
            worst['lu_swap_trsm'] = max(worst['lu_swap_trsm'], diff)
            swaps.append(f'{j}: {int((rows != torch.arange(n - j, device=rows.device)).sum(-1).max())} rows moved, '
                         f'{diff:.1e}')
        lines.append(f'{name} {tuple(A.shape)}: lu_panel {err:.1e}; lu_swap_trsm at block {", ".join(swaps)}')
    print(f'dense LU: both kernels against their plain versions on matrices that need pivoting (lu_panel the same '
          f'rows, lu_swap_trsm the same row interchanges; max abs diff): {"; ".join(lines)} [{card}]')
    _float_kernel_checks(card)
    worst['lu_swap_trsm'] = max(worst['lu_swap_trsm'], _swap_shape_checks(card))
    return worst


# lu_swap_trsm's shapes beyond the route's 512 rows at a batch of 256 (name, dtype, batch, rows, blocks, diagonal
# added): every path its grid and tiles take
SWAP_SHAPES = (('600 rows', 'complex128', 12, 600, None, 0.0), ('600 rows', 'float64', 12, 600, None, 0.0),
               ('a batch of 1', 'complex128', 1, 512, (0, 64, 448), 0.0),
               ('no row moves', 'complex128', 4, 512, (0, 64, 448), 4096.0),
               ('1024 rows, phase 70\'s batch', 'complex128', 12, 1024, None, 0.0),
               ('1024 rows', 'float32', 12, 1024, (0, 64, 960), 0.0),
               ('1024 rows', 'complex64', 12, 1024, (0, 64, 960), 0.0))


def _swap_shape_checks(card):
    """``lu_swap_trsm`` against its plain version on random batches at each shape of SWAP_SHAPES, at each block
    named (every block of the matrix where none is), each block's panel factored first by the plain version: the
    row interchanges bit for bit (every entry but ``U12``), ``U12`` to 1e-12 of its largest entry (FLOAT_LU_TOL for
    float32 and complex64).  Prints, for each shape, the blocks' rows moved and their ragged parts (the last block's
    width, a partial tile of columns, CTAs that own fewer tiles than the others); returns the largest difference of
    the float64 types."""
    import torch

    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import dense_lu

    gen, worst, lines = torch.Generator(device='cuda').manual_seed(19), 0.0, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, dtype_name, b, n, blocks, diagonal in SWAP_SHAPES:
        dtype = getattr(torch, dtype_name)
        tol = FLOAT_LU_TOL if dtype in (torch.float32, torch.complex64) else 1e-12
        A = torch.randn((b, n, n), dtype=dtype, device='cuda', generator=gen) \
            + diagonal * torch.eye(n, dtype=dtype, device='cuda')
        moved, ragged, largest = [], set(), 0.0
        for j in blocks or range(0, n, linalg.BLOCK):
            jb = min(linalg.BLOCK, n - j)
            base = A.clone()
            rows = dense_lu.plain_panel(base[:, j:, j:j + jb])
            got, want = base.clone(), base.clone()
            dense_lu.lu_swap_trsm(got, j, jb, rows)
            dense_lu.plain_swap_trsm(want, j, jb, rows)
            u12 = (slice(None), slice(j, j + jb), slice(j + jb, None))
            diff = (got[u12] - want[u12]).abs().max().item() if j + jb < n else 0.0
            scale = want[u12].abs().max().item() if j + jb < n else 0.0
            got[u12], want[u12] = 0, 0
            swapped = torch.equal(got, want)
            if not swapped or not diff <= tol * scale:
                raise AssertionError(f'dense LU: lu_swap_trsm on {name} {dtype_name} ({b}, {n}, {n}) block {j} '
                                     f'(width {jb}) against its plain version: row interchanges equal {swapped}, U12 '
                                     f'max abs diff {diff:.3e} (U12 up to {scale:.3e})')
            largest = max(largest, diff / scale if scale else 0.0)
            if dtype in (torch.float64, torch.complex128):
                worst = max(worst, diff)
            moved.append(int((rows != torch.arange(n - j, device=rows.device)).sum(-1).max()))
            left, right, per_cta, _ = dense_lu.swap_grid(n, n, j, jb, b, A.element_size(), sms)
            if jb < linalg.BLOCK:
                ragged.add(f'a last block of {jb} columns')
            if (n - j - jb) % dense_lu.SWAP_TILE:
                ragged.add(f'a last tile of {(n - j - jb) % dense_lu.SWAP_TILE} columns')
            if (left + right) % per_cta:
                ragged.add(f'CTAs of {per_cta} tiles and one of {(left + right) % per_cta}')
        lines.append(f'{name} {dtype_name} ({b}, {n}, {n}): rows moved a matrix {min(moved)}-{max(moved)} over '
                     f'{len(moved)} blocks, U12 within {largest:.1e} of its largest entry'
                     + (f' ({", ".join(sorted(ragged))})' if ragged else ''))
    for needed in (' 0-0 ', 'a last block of', 'a last tile of', 'CTAs of'):
        if not any(needed in line for line in lines):
            raise AssertionError(f'dense LU: lu_swap_trsm\'s shape checks missed {needed!r}: {lines}')
    print(f'dense LU: lu_swap_trsm against its plain version at its other shapes (the same row interchanges, U12 to '
          f'1e-12 of its largest entry, {FLOAT_LU_TOL} for the float types): {"; ".join(lines)} [{card}]')
    return worst


# float32 and complex64 at 1024 rows: sub-panels of 32 and 16 columns, so lu_panel's products take the CUDA cores (the
# float64 types take the tensor cores); float32 rounding (6e-8) grown by the elimination, stated relative to max|A|
FLOAT_LU_TOL = 1e-5


def _float_kernel_checks(card):
    """Both kernels on random (4, 1024, 1024) float32 and complex64 matrices: ``lu_panel`` on the first block of
    BLOCK columns factors ``A[perm] = L U`` with ``|L| <= 1`` (``sqrt(2)`` complex: the pivot has the largest
    ``|re| + |im|``) to FLOAT_LU_TOL (its pivots may part from LAPACK's on
    near ties at this rounding, so the factors are held to the matrix, not to the plain version's); ``lu_swap_trsm``
    at the second block against its plain version (the row interchanges bit for bit, ``U12`` to FLOAT_LU_TOL of its
    largest entry)."""
    import torch

    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import dense_lu

    gen, jb, lines = torch.Generator(device='cuda').manual_seed(17), linalg.BLOCK, []
    for dtype in (torch.float32, torch.complex64):
        A = torch.randn((4, 1024, 1024), dtype=dtype, device='cuda', generator=gen)
        panel = A[:, :, :jb].clone()
        perm = dense_lu.lu_panel(panel)
        L = torch.tril(panel, -1) + torch.eye(1024, jb, dtype=dtype, device='cuda')
        U = torch.triu(panel[:, :jb])
        gap = (A[:, :, :jb].gather(1, perm.unsqueeze(-1).expand(-1, -1, jb)) - L @ U).abs().max().item()
        scale, l_bound = A.abs().max().item(), (2 ** 0.5 if A.is_complex() else 1.0) * (1 + FLOAT_LU_TOL)
        rows = dense_lu.plain_panel(A[:, jb:, jb:2 * jb])
        got, want = A.clone(), A.clone()
        dense_lu.lu_swap_trsm(got, jb, jb, rows)
        dense_lu.plain_swap_trsm(want, jb, jb, rows)
        diff = (got - want).abs().max().item()
        swapped = torch.equal(got[:, 2 * jb:], want[:, 2 * jb:]) \
            and torch.equal(got[:, :, :2 * jb], want[:, :, :2 * jb])
        if not gap <= FLOAT_LU_TOL * scale or not L.abs().max().item() <= l_bound or not swapped \
                or not diff <= FLOAT_LU_TOL * want[:, jb:2 * jb, 2 * jb:].abs().max().item():
            raise AssertionError(f'dense LU: {dtype} (4, 1024, 1024): lu_panel |A[perm] - L U| {gap:.3e} (max|A| '
                                 f'{scale:.3e}), max|L| {L.abs().max().item():.3e}; lu_swap_trsm row interchanges '
                                 f'equal {swapped}, max abs diff {diff:.3e}')
        lines.append(f'{dtype}: lu_panel |A[perm] - L U| {gap:.1e}, lu_swap_trsm {diff:.1e}')
    print(f'dense LU: float kernels at (4, 1024, 1024), sub-panels of '
          f'{dense_lu.panel_width(1024, 4)} / {dense_lu.panel_width(1024, 8)} columns: {"; ".join(lines)} '
          f'(bound {FLOAT_LU_TOL} relative) [{card}]')


def _rbc_lu_description(params, device):
    import torch

    return dict(_rbc_description(device), problem_params=dict(params, dtype=torch.float64, device=device))


def _circuits_fused(card):
    """``Piline``, ``BuckConverter`` and ``BatteryNCapacitors`` float64 through ``ShardedController(4).run``, 2 blocks:
    ``'auto'`` takes the fused lane, one graph a block, no ``cont`` read and one fetch; equal ``niter`` and ``uend``
    within CIRCUIT_BOUND of ``lane='stage'`` and of the CPU's fused run."""
    import torch

    from pysdc_tpu_torch import IMEXSweeper, ShardedController
    from pysdc_tpu_torch.models import power_electronics

    lines = []
    for name, params in CIRCUITS.items():
        def description(device):
            return dict(problem_class=getattr(power_electronics, name),
                        problem_params=dict(params, dtype=torch.float64, device=device), sweeper_class=IMEXSweeper,
                        sweeper_params=dict(num_nodes=3, quad_type='RADAU-RIGHT', QI='LU', QE='EE'),
                        level_params=dict(dt=0.05, restol=1e-10), step_params=dict(maxiter=20))

        label = f'dense LU: ShardedController(4) {name} fp64 IMEX M=3 LU / EE dt 0.05, 2 blocks'
        fused = stage = ShardedController(4, {'logger_level': 30}, description('cuda'))  # one controller, both lanes
        u0 = fused.MS[0].levels[0].prob.u_exact(0.0)
        uend, stats = fused.run(u0, 0.0, 0.4)
        reads = dict(fused.host_reads)
        uend_s, stats_s = stage.run(u0, 0.0, 0.4, lane='stage')
        with _one_cpu_thread():
            cpu = ShardedController(4, {'logger_level': 30}, description('cpu'))
            uend_c, stats_c = cpu.run(cpu.MS[0].levels[0].prob.u_exact(0.0), 0.0, 0.4)
        niter, niter_s, niter_c = _niter(stats), _niter(stats_s), _niter(stats_c)
        diff, gap = (uend - uend_s).abs().max().item(), (uend.cpu() - uend_c).abs().max().item()
        if _lane(stats) != ['fused'] or _lane(stats_s) != ['stage'] or _lane(stats_c) != ['fused'] \
                or niter != niter_s or niter != niter_c or len(niter) != 8 or not diff <= CIRCUIT_BOUND \
                or not gap <= CIRCUIT_BOUND or reads != {'cont': 0, 'fetch': 1}:
            raise AssertionError(f'{label}: lanes {_lane(stats)} / {_lane(stats_s)} / CPU {_lane(stats_c)}, niter {niter}, '
                                 f'stage {niter_s}, CPU {niter_c}; |uend_fused - uend_stage| {diff:.3e}, card against '
                                 f'CPU {gap:.3e}; host reads {reads}')
        _one_graph_a_block(fused, label)
        lines.append(f'{name}: niter {niter}, |fused - stage| {diff:.1e}, card against CPU {gap:.1e}')
    print(f'dense LU: the circuit problems through ShardedController(4) fp64, lane fused under \'auto\', one graph a '
          f'block, host reads {{cont: 0, fetch: 1}}, equal niter (stage, CPU), bound {CIRCUIT_BOUND}: '
          + '; '.join(lines) + f' [{card}]')


@_counting_launches
def phase_dense_lu(card):
    """Phase 72: both kernels of the dense LU against their plain versions on matrices that need pivoting; the
    circuit problems on the fused lane; ``RayleighBenard(256, 128)`` float64 (512 rows a mode: the pivoted route)
    through ``ShardedController(4).run``, 2 blocks: ``'auto'`` takes the fused lane, one graph a block, equal
    ``niter`` and ``uend`` bitwise equal to ``lane='stage'``'s (the same kernels and calls on both lanes), no ``cont``
    read and one fetch, each kernel's launches (counted on the card) in the run: one of each a block of 64 columns of
    each node's LU, made once in the warm-up (``ops/spectral.py`` keeps a node's LU while its shift holds), none in a
    replayed block and none in the stage lane's block; ms a block on both lanes; ``RayleighBenard(8, 128)``, one
    block, card against CPU.  Returns each kernel's launches on the main path (the fused run, counted on the card)
    and in a replayed block, and its largest difference from its plain version."""
    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.ops.kernels.dense_lu import lu_panel, lu_swap_trsm

    worst = _kernel_checks(card)
    _circuits_fused(card)

    kernels = {'lu_panel': (lu_panel, _LAUNCH_COUNTS['lu']), 'lu_swap_trsm': (lu_swap_trsm, _LAUNCH_COUNTS['swap'])}

    def counted():
        """(on the card, through the wrappers) of each kernel since the last call, the counts then set to 0"""
        out = {name: (int(count), fn.launches) for name, (fn, count) in kernels.items()}
        for fn, count in kernels.values():
            count.zero_()
            fn.launches = 0
        return out

    label = (f'dense LU: ShardedController({P_RBC}) RayleighBenard {RBC_LU["nx"]}x{RBC_LU["nz"]} fp64 IMEX M=3 LU/PIC '
             f'dt {DT_RBC:g}, restol -1, maxiter {MAXITER_RBC}, {BLOCKS_RBC_LU} blocks')
    Tend, block = BLOCKS_RBC_LU * P_RBC * DT_RBC, P_RBC * DT_RBC
    fused = stage = ShardedController(P_RBC, {'logger_level': 30}, _rbc_lu_description(RBC_LU, 'cuda'))
    u0 = fused.MS[0].levels[0].prob.u_exact(0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counted()
    start = time.perf_counter()
    uend, stats = fused.run(u0, 0.0, Tend)  # the main path: warm-up, capture, the march
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    main = counted()
    peak = torch.cuda.max_memory_allocated() / 2**20
    reads = dict(fused.host_reads)
    uend_s, stats_s = stage.run(u0, 0.0, Tend, lane='stage')
    niter, niter_s = _niter(stats), _niter(stats_s)
    rel = _rel_err(uend, uend_s)
    if _lane(stats) != ['fused'] or _lane(stats_s) != ['stage'] or niter != niter_s \
            or len(niter) != BLOCKS_RBC_LU * P_RBC or not torch.equal(uend, uend_s) or not bool(uend.isfinite().all()):
        raise AssertionError(f'{label}: lanes {_lane(stats)} / {_lane(stats_s)}, niter {niter} against {niter_s}, '
                             f'|uend_fused - uend_stage| / max|uend_stage| {rel:.3e}')
    node_lus = 8 * 3  # 8 blocks of 64 columns in each of the 3 nodes' LUs
    if reads != {'cont': 0, 'fetch': 1} or any(card_count != node_lus for card_count, _ in main.values()):
        raise AssertionError(f'{label}: host reads {reads}, kernel launches in the run (on the card, through the '
                             f'wrapper) {main}, expected {node_lus} on the card')
    _one_graph_a_block(fused, label)
    counted()
    fused_ms, (uend_r, _) = _events_ms(lambda: fused.run_fused(u0, 0.0, block))
    replay = counted()
    stage_ms, _ = _events_ms(lambda: stage.run(u0, 0.0, block, lane='stage'))
    stage_counts = counted()
    for name in kernels:
        (replayed, through_wrapper), (on_card, stage_wrapper) = replay[name], stage_counts[name]
        if through_wrapper != 0 or replayed != 0 or on_card != 0 or stage_wrapper != 0:
            raise AssertionError(f'{label}: {name} in a replayed block {replayed} (counted on the card), through the '
                                 f'wrapper {through_wrapper}; the stage lane\'s block {on_card} (counted on the card) '
                                 f'of {stage_wrapper} launches; expected none: each node\'s LU is kept')
    print(f'{label}: lane fused under \'auto\', one graph a block, niter {niter} = the stage lane\'s, '
          f'uend bitwise equal to the stage lane\'s; host reads {reads}; '
          + '; '.join(f'{name} {main[name][0]} launches in the run (counted on the card; {main[name][1]} through the '
                      f'wrapper in warm-up and capture), {replay[name][0]} in a replayed block, the stage lane\'s '
                      f'{stage_counts[name][0]}' for name in kernels)
          + f' (one of each a block of 64 columns of each node\'s LU, made once); peak device memory {peak:.0f} MiB; '
          f'wall {wall:.3f} s with the capture [{card}]')
    print(f'times: RayleighBenard {RBC_LU["nx"]}x{RBC_LU["nz"]} fp64 block of {P_RBC} steps: fused {fused_ms:.3f} ms '
          f'(a replay) against stage {stage_ms:.3f} ms (x{stage_ms / fused_ms:.2f}), CUDA events [{card}]')
    del fused, stage
    torch.cuda.empty_cache()

    runs = {}
    for device in ('cuda', 'cpu'):
        with _one_cpu_thread():
            ctrl = ShardedController(P_RBC, {'logger_level': 30}, _rbc_lu_description(RBC_LU_SMALL, device))
            u, st = ctrl.run(ctrl.MS[0].levels[0].prob.u_exact(0.0), 0.0, block)
        runs[device] = (u.cpu(), _niter(st), _lane(st))
    (u_card, it_card, lane_card), (u_cpu, it_cpu, lane_cpu) = runs['cuda'], runs['cpu']
    rel = _rel_err(u_card, u_cpu)
    if lane_card != lane_cpu or lane_card != ['fused'] or it_card != it_cpu or not rel <= RBC_LU_CPU_RTOL:
        raise AssertionError(f'dense LU: RayleighBenard 8x128 lanes {lane_card} / {lane_cpu}, niter {it_card} against '
                             f'the CPU\'s {it_cpu}, uend rel diff {rel:.3e}')
    print(f'dense LU: ShardedController({P_RBC}) RayleighBenard 8x128 fp64, one block on the fused lane, card against '
          f'CPU: niter {it_card}, uend rel diff {rel:.3e} <= {RBC_LU_CPU_RTOL} [{card}]')
    return {name: dict(main=main[name][0], replayed_block=replay[name][0]) for name in kernels}, worst


def _swap_trsm_work(rows, n, j, jb, itemsize):
    """(bytes, flops, rows moved) ``lu_swap_trsm`` must move and compute at block ``j`` of ``(b, n, n)`` matrices with
    this run's permutation ``rows`` (b, n - j), each byte once: in each matrix the moved rows read and written in the
    columns left of the panel, the union of the moved rows and the top ``jb`` rows (``A12``) read and written in the
    columns right of it, ``L11``'s strict lower triangle read once, the permutation read; ``jb^2 / 2`` multiply-adds
    a column right of the panel (8 flops each complex, 2 real)."""
    import torch

    b = rows.shape[0]
    index = torch.arange(n - j, device=rows.device)
    moved_mask = rows != index
    moved = int(moved_mask.sum())
    left, right = j, n - j - jb
    union = int((moved_mask | (index < jb)).sum()) if right else 0
    elements = 2 * moved * left + 2 * union * right + (b * jb * (jb - 1) // 2 if right else 0)
    nbytes = elements * itemsize + rows.numel() * 8
    return nbytes, (8 if itemsize == 16 else 2) * b * right * jb * (jb - 1) // 2, moved


def swap_block_times(A, card):
    """``lu_swap_trsm`` at each block of the route on ``A`` (``(b, n, n)`` on the card, left as it is), as the route
    leaves the matrix there (each panel by ``lu_panel``, each trailing update by ``baddbmm_``): ms a launch (CUDA
    events, the launch repeated in place on that block's matrix: the same rows move at every call) beside its bound
    from :func:`_swap_trsm_work`.  Prints each block and the sums; returns ``(j, ms, bound_ms, bound_by, bytes,
    flops, rows moved)`` a block.  ``lu_probe.py swap`` runs it on another commit's package."""
    import torch

    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import dense_lu

    b, n = A.shape[0], A.shape[-1]
    work, out = A.clone(), []
    for j in range(0, n, linalg.BLOCK):
        jb = min(linalg.BLOCK, n - j)
        rows = dense_lu.lu_panel(work[:, j:, j:j + jb])
        before = work.clone()
        ms = _event_ms(lambda i: dense_lu.lu_swap_trsm(work, j, jb, rows), 10)
        work.copy_(before)
        del before
        dense_lu.lu_swap_trsm(work, j, jb, rows)
        nbytes, flops, moved = _swap_trsm_work(rows, n, j, jb, A.element_size())
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S)
        out.append((j, ms, bound, 'bytes' if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOP_PER_S else 'operations',
                    nbytes, flops, moved))
        if j + jb < n:
            work[:, j + jb:, j + jb:].baddbmm_(work[:, j + jb:, j:j + jb], work[:, j:j + jb, j + jb:], alpha=-1)
    del work
    torch.cuda.empty_cache()
    ms, bound = sum(block[1] for block in out), sum(block[2] for block in out)
    print(f'times: lu_swap_trsm at each block of the route, ({b}, {n}, {n}) {A.dtype}: '
          + '; '.join(f'block {j}: {t:.4f} ms against {bd:.4f} ms ({by}, {nb / 1e6:.1f} MB, {mv} rows moved)'
                      for j, t, bd, by, nb, _, mv in out)
          + f'; the {len(out)} launches {ms:.4f} ms against their bounds\' {bound:.4f} ms ({bound / ms:.0%}) [{card}]')
    return out


def phase_dense_lu_times(card):
    """Phase 73: both kernels at the main path's first block (RayleighBenard 256x128's modes, complex128, columns
    0..BLOCK) beside their bounds, their plain versions and the torch calls they stand for (``lu_factor_ex`` of the
    panel; the plain version's gather, ``copy_`` and ``solve_triangular``); the pivoted route at the main path's
    batch of modes, eager and from a CUDA graph, beside its bound and cuSOLVER's ``getrf`` + ``getrs``; at 256 rows
    beside ``_batched_solve``.  CUDA events.  Returns each kernel's numbers for the ``kernels`` line."""
    import torch

    from pysdc_tpu_torch.models.rayleigh_benard import RayleighBenard
    from pysdc_tpu_torch.ops import linalg
    from pysdc_tpu_torch.ops.kernels import dense_lu

    spec = RayleighBenard(**RBC_LU, dtype=torch.float64, device='cuda').spec
    like = torch.zeros((1,), dtype=torch.complex128, device='cuda')
    keep = torch.as_tensor(spec.keep_mask, device='cuda')
    A = (spec._dev('M_all', like) + 0.3 * DT_RBC * spec._dev('L_all', like)) * keep[:, :, None] \
        + spec._dev('bc_rows', like)
    del spec
    b, n = A.shape[0], A.shape[-1]
    w = linalg.BLOCK
    gen = torch.Generator(device='cuda').manual_seed(13)
    B = torch.randn((P_RBC, b, n, 1), dtype=torch.complex128, device='cuda', generator=gen)
    work = A.clone()
    panel = work[:, :, :w]
    lu_ms = _event_ms(lambda i: dense_lu.lu_panel(panel.copy_(A[:, :, :w])), 10)
    copy_ms = _event_ms(lambda i: panel.copy_(A[:, :, :w]), 10)
    plain_ms = _event_ms(lambda i: dense_lu.plain_panel(panel.copy_(A[:, :, :w])), 3, warmup=1) - copy_ms
    library_ms = _event_ms(lambda i: torch.linalg.lu_factor_ex(A[:, :, :w]), 3, warmup=1)
    with linalg._cusolver(A):
        cusolver_panel_ms = _event_ms(lambda i: torch.linalg.lu_factor_ex(A[:, :, :w]), 3, warmup=1)
    lu_ms -= copy_ms
    got = panel.copy_(A[:, :, :w])
    perm = dense_lu.lu_panel(got)
    plain = A[:, :, :w].clone()
    plain_perm = dense_lu.plain_panel(plain)
    err = (got - plain).abs().max().item()
    if not torch.equal(perm, plain_perm) or not err <= 1e-12 * plain.abs().max().item():
        raise AssertionError(f'dense LU: lu_panel at ({b}, {n}, {w}) complex128 against its plain version: rows '
                             f'equal {torch.equal(perm, plain_perm)}, max abs diff {err:.3e}')
    ws = dense_lu.panel_width(n, A.element_size())
    steps = sum((n - k) * (w - k) for k in range(w))
    flops = 8 * b * steps
    nbytes = 2 * b * n * w * 16 + b * n * 8
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S)
    bound_by = 'bytes' if nbytes / HBM_BYTES_PER_S >= flops / FP64_FLOP_PER_S else 'operations'
    print(f'times: lu_panel at ({b}, {n}, {w}) complex128 (RayleighBenard {RBC_LU["nx"]}x{RBC_LU["nz"]}\'s first '
          f'block, sub-panels of {ws} columns, one launch): {lu_ms:.4f} ms against its bound {bound_ms:.4f} ms '
          f'({bound_by}: '
          f'{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); plain version (lu_factor_ex, the permutation) '
          f'{plain_ms:.4f} ms; library torch.linalg.lu_factor_ex of the panel {library_ms:.4f} ms (asked for cuSOLVER: '
          f'{cusolver_panel_ms:.4f} ms, one getrf a matrix); max abs diff to the plain version {err:.3e}, the same '
          f'rows [{card}]')
    panel_numbers = dict(ms=lu_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                         max_abs_err=err, shape=[b, n, w], sub_panel_width=ws)

    # lu_swap_trsm at the same block (the rows the panel moved, in the rest of the matrix, and U12), then at each
    # block of the route
    factored = A.clone()
    rows = dense_lu.lu_panel(factored[:, :, :w])
    work.copy_(factored)
    swap_plain_ms = _event_ms(lambda i: dense_lu.plain_swap_trsm(work, 0, w, rows), 3, warmup=1)
    got = work.copy_(factored)
    dense_lu.lu_swap_trsm(got, 0, w, rows)
    want = factored.clone()
    dense_lu.plain_swap_trsm(want, 0, w, rows)
    swap_err = (got - want).abs().max().item()
    if not torch.equal(got[:, w:], want[:, w:]) or not swap_err <= 1e-12 * want[:, :w, w:].abs().max().item():
        raise AssertionError(f'dense LU: lu_swap_trsm at ({b}, {n}, {n}) block 0 against its plain version: rows '
                             f'{w}.. equal {torch.equal(got[:, w:], want[:, w:])}, max abs diff {swap_err:.3e}')
    del work, panel, got, plain, factored, want
    blocks = swap_block_times(A, card)
    swap_ms, swap_bound, swap_by, swap_bytes, swap_flops, moved = blocks[0][1:]
    print(f'times: lu_swap_trsm at ({b}, {n}, {n}) complex128 block 0 (width {w}, {moved} rows moved in all): '
          f'{swap_ms:.4f} ms against its bound {swap_bound:.4f} ms ({swap_by}: {swap_bytes / 1e6:.1f} MB, '
          f'{swap_flops / 1e9:.2f} GFLOP); plain version, the torch calls it stands for (gather and copy_ of each '
          f'side, solve_triangular) {swap_plain_ms:.4f} ms; max abs diff to the plain version {swap_err:.3e} [{card}]')
    swap_numbers = dict(ms=swap_ms, plain_ms=swap_plain_ms, bound_ms=swap_bound, bound_by=swap_by, library_ms=None,
                        torch_calls_ms=swap_plain_ms, max_abs_err=swap_err, shape=[b, n, n], block=[0, w],
                        rows_moved=moved, route_blocks_ms=[block[1] for block in blocks],
                        route_blocks_bound_ms=[block[2] for block in blocks],
                        route_sum_ms=sum(block[1] for block in blocks),
                        route_sum_bound_ms=sum(block[2] for block in blocks))

    # the whole route at the main path's batch: A (modes, n, n), the right-hand sides of a block's steps
    route_ms = _event_ms(lambda i: linalg.solve(A, B), 3, warmup=1)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        linalg.solve(A, B)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        linalg.solve(A, B)
    route_graph_ms = _event_ms(lambda i: graph.replay(), 3, warmup=1)
    del graph
    rhs = B.permute(1, 2, 0, 3).reshape(b, n, P_RBC)

    def cusolver():
        with linalg._cusolver(A):
            LU, pivots, _ = torch.linalg.lu_factor_ex(A)
            return torch.linalg.lu_solve(LU, pivots, rhs)

    cusolver_ms = _event_ms(lambda i: cusolver(), 2, warmup=1)

    def library_panel(panel):
        """Library route (a): the panel by ``lu_factor_ex`` with torch asked for cuSOLVER (``getrf`` of each tall
        panel, one matrix at a time), which a conditional body holds too."""
        with linalg._cusolver(panel):
            return dense_lu.plain_panel(panel)

    linalg.lu_panel = library_panel
    try:
        library_route_ms = _event_ms(lambda i: linalg.solve(A, B), 1, warmup=1)
    finally:
        linalg.lu_panel = dense_lu.lu_panel
    rel = _rel_err(linalg.solve(A, B).permute(1, 2, 0, 3).reshape(b, n, P_RBC), cusolver())
    route_flops = b * (8 / 3 * n ** 3 + 8 * n * n * P_RBC)
    route_bytes = (A.numel() + 2 * B.numel()) * 16
    route_bound = 1e3 * max(route_flops / FP64_FLOP_PER_S, route_bytes / HBM_BYTES_PER_S)
    print(f'times: the pivoted route (ops/linalg.py) at RayleighBenard {RBC_LU["nx"]}x{RBC_LU["nz"]}\'s modes, A ({b}, '
          f'{n}, {n}) complex128, B {tuple(B.shape)}: {route_ms:.3f} ms eager, {route_graph_ms:.3f} ms from a CUDA graph, '
          f'against its bound {route_bound:.3f} ms (operations: {route_flops / 1e9:.1f} GFLOP at FP64 '
          f'{FP64_FLOP_PER_S / 1e12:.0f} TFLOP/s); cuSOLVER getrf + getrs outside any graph {cusolver_ms:.3f} ms '
          f'(rel diff {rel:.2e}); the same route with its panels by cuSOLVER\'s getrf (library route (a)) '
          f'{library_route_ms:.3f} ms [{card}]')
    del A, B, rhs
    torch.cuda.empty_cache()

    A2 = torch.randn((b, 256, 256), dtype=torch.complex128, device='cuda', generator=gen) \
        + 512 * torch.eye(256, dtype=torch.complex128, device='cuda')
    B2 = torch.randn((P_RBC, b, 256, 1), dtype=torch.complex128, device='cuda', generator=gen)
    batched_ms = _event_ms(lambda i: linalg._batched_solve(A2, B2), 3, warmup=1)
    pivoted_ms = _event_ms(lambda i: linalg._pivoted_solve(A2, B2), 3, warmup=1)
    print(f'times: at 256 rows ({b} matrices complex128, B {tuple(B2.shape)}): _batched_solve (cuBLAS\'s batched LU, the '
          f'route below 512 rows) {batched_ms:.3f} ms, _pivoted_solve {pivoted_ms:.3f} ms [{card}]')
    route = dict(route_ms=route_ms, route_graph_ms=route_graph_ms, route_bound_ms=route_bound,
                 route_cusolver_ms=cusolver_ms, route_with_library_panels_ms=library_route_ms)
    return dict(panel_numbers, **route), swap_numbers


# (phase 74) each node's LU of the spectral shifted solve kept on the card (ops/spectral.py): RayleighBenard 256x128
# (512 rows a mode, the pivoted route) and 256x64 (cuBLAS's batched LU), float64, through ShardedController(4)'s fused
# lane; a second dt makes each node's LU again inside the replayed block graph
RBC_SLOTS = (dict(nx=256, nz=128, Rayleigh=2e6, Prandtl=1), dict(nx=256, nz=64, Rayleigh=2e6, Prandtl=1))
DT_RBC_SLOTS = 1.5 * DT_RBC


def _slot_marches(params, kept):
    """Three marches of BLOCKS_RBC_LU blocks of RayleighBenard ``params`` through a fresh ``ShardedController(4)``
    while tracing is on: at DT_RBC twice, then at DT_RBC_SLOTS.  ``kept`` False makes the problem's solves name no
    node (the route that factors at every solve).  Returns ``(uends, niters, refreshes, slot solves, lu_panel launches
    counted on the card)`` a march, the ms of a replayed block at DT_RBC_SLOTS without tracing (CUDA events) and the
    peak device memory in MiB."""
    import gc

    import torch

    from pysdc_tpu_torch import ShardedController
    from pysdc_tpu_torch.utils import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctrl = ShardedController(P_RBC, {'logger_level': 30}, _rbc_lu_description(params, 'cuda'))
    if not kept:
        for step in ctrl.MS:
            for lvl in step.levels:
                lvl.prob.accepts_node_index = False
    u0 = ctrl.MS[0].levels[0].prob.u_exact(0.0)
    lu = _LAUNCH_COUNTS['lu']
    out = []
    trace.enable('cuda')
    try:
        for dt in (DT_RBC, DT_RBC, DT_RBC_SLOTS):
            ctrl.MS[0].levels[0].params.dt = dt
            before = dict(trace.record().counters)
            lu.zero_()
            uend, stats = ctrl.run(u0, 0.0, BLOCKS_RBC_LU * P_RBC * dt)
            after = trace.record().counters
            out.append((uend, _niter(stats), *(after.get(k, 0) - before.get(k, 0)
                                               for k in ('spectral.refreshes', 'spectral.slot_solves')), int(lu)))
    finally:
        trace.disable()
    ctrl.run_fused(u0, 0.0, P_RBC * DT_RBC_SLOTS)  # the untraced program captured
    block_ms, _ = _events_ms(lambda: ctrl.run_fused(u0, 0.0, P_RBC * DT_RBC_SLOTS))
    peak = torch.cuda.max_memory_allocated() / 2**20
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    return [tuple(m[i] for m in out) for i in range(5)], block_ms, peak


@_counting_launches
def phase_spectral_slots(card):
    """Phase 74: RayleighBenard 256x128 and 256x64 float64 through ``ShardedController(4)``'s fused lane, the problem's
    node solves keeping each node's LU (``ops/spectral.py``) against the same marches whose solves name no node:
    ``niter`` equal and ``uend`` bitwise equal in each march; ``spectral.refreshes`` 3 in the first march (the warm-up
    makes the 3 nodes' LUs), 0 in the next at the same dt and 3 at a new dt (made inside the replayed graph, in the
    device ``while`` of each node's check); at 512 rows ``lu_panel`` launched 8 times a refresh (counted on the
    card) and never otherwise; ms of a replayed block on both routes (CUDA events) and peak device memory."""
    import torch

    from pysdc_tpu_torch.ops import linalg

    lines = []
    for params in RBC_SLOTS:
        label = (f'spectral slots: ShardedController({P_RBC}) RayleighBenard {params["nx"]}x{params["nz"]} fp64 IMEX M=3 '
                 f'LU/PIC dt {DT_RBC:g}, {DT_RBC:g}, {DT_RBC_SLOTS:g}, {BLOCKS_RBC_LU} blocks a march')
        (uends, niters, refreshes, solves, launches), kept_ms, kept_peak = _slot_marches(params, True)
        (uends_f, niters_f, refreshes_f, _, launches_f), fresh_ms, fresh_peak = _slot_marches(params, False)
        panel_blocks = 4 * params['nz'] // linalg.BLOCK if 4 * params['nz'] >= linalg.PIVOTED_FROM else 0
        same = [bool(torch.equal(a, b)) for a, b in zip(uends, uends_f)]
        if niters != niters_f or not all(same) or list(refreshes) != [3, 0, 3] or min(solves) < 1 \
                or any(refreshes_f) or list(launches) != [3 * panel_blocks, 0, 3 * panel_blocks]:
            raise AssertionError(f'{label}: niter {niters} against {niters_f}, uend bitwise equal {same}, refreshes '
                                 f'{refreshes} (the route without nodes {refreshes_f}), slot solves {solves}, lu_panel '
                                 f'launches on the card {launches}, expected [{3 * panel_blocks}, 0, '
                                 f'{3 * panel_blocks}]')
        lines.append(f'{params["nx"]}x{params["nz"]}: niter {niters[0]} in each march, uend bitwise equal, refreshes '
                     f'{list(refreshes)}, slot solves {list(solves)}, lu_panel launches on the card {list(launches)} '
                     f'(the route without nodes {list(launches_f)}); a replayed block {kept_ms:.3f} ms against '
                     f'{fresh_ms:.3f} ms without nodes (x{fresh_ms / kept_ms:.2f}); peak device memory '
                     f'{kept_peak:.0f} MiB against {fresh_peak:.0f} MiB')
    print(f'spectral slots: each node\'s LU kept on the card, refreshed in the graph when dt changes: '
          + '; '.join(lines) + f' [{card}]')


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA card (torch.cuda.is_available() is False)', file=sys.stderr)
        return 1
    card = _card()
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} [{card}]')
    t_start = time.perf_counter()

    def phase(fn, *args):
        """Run one phase and say how long it took and where the script stands."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f'phase {fn.__name__[6:]}: {now - t0:.1f} s, {now - t_start:.1f} s since the start')
        return out

    phase(phase_build, card)
    # phases 72-73 first: RayleighBenard 256x128 needs GiBs that the graphs and pools of the later phases keep; phase
    # 4 right after them, where its parity once read 4.574e-10 against its 1e-11 gate (ROADMAP queue 3)
    lu_launches, lu_err = phase(phase_dense_lu, card)
    lu, swap = phase(phase_dense_lu_times, card)
    phase(phase_spectral_slots, card)
    phase(phase_parity)
    main_err, pfasst_err = phase(phase_kernels)
    ctrl, launches = phase(phase_main, card)
    k1 = phase(phase_times, ctrl, card)
    sparse_errs = phase(phase_sparse_kernels)
    sine = phase(phase_sine_kernels, card)
    sparse_ctrl, k2_launches, sine_launches = phase(phase_sparse_main, card)
    k3_launches = phase(phase_bsr_path, card)
    phase(phase_sparse_parity)
    k2, k3 = phase(phase_sparse_times, sparse_ctrl, card)
    pfasst_ctrl, pfasst_launches, pfasst_uend, pfasst_niter = phase(phase_pfasst, card)
    phase(phase_pfasst_parity)
    imex_launches = phase(phase_imex, card)
    phase(phase_multilevel_times, pfasst_ctrl, ctrl, card)
    fused_launches = phase(phase_fused, card, pfasst_uend, pfasst_niter)
    phase(phase_fused_march, card)
    phase(phase_fused_parity)
    phase(phase_fused_times, card)
    covered = phase(phase_adaptive_kernels)
    adaptive_runs, adaptive_launches = phase(phase_adaptive, card, covered)
    ac_run, ac_launches, ac_sweep_launches = phase(phase_adaptive_allen_cahn, card, covered)
    phase(phase_adaptive_parity)
    phase(phase_adaptive_times, {f'HeatND {N_AD}^2/{NC_AD}^2': adaptive_runs[N_AD],
                                 f'HeatND {N_AD_BIG}^2/{NC_AD_BIG}^2': adaptive_runs[N_AD_BIG],
                                 f'Allen-Cahn {N_AC}^2/{NC_AC}^2': ac_run}, card)
    covered_fi = phase(phase_implicit_kernels)
    implicit, implicit_launches = phase(phase_implicit, card, covered_fi)
    phase(phase_implicit_parity)
    implicit_fused_launches = phase(phase_implicit_fused, card, covered_fi)
    krylov_launches = phase(phase_krylov_spectral, card, covered_fi)
    phase(phase_implicit_times, implicit, sparse_ctrl, card)
    mi_run, mi_launches = phase(phase_multi_implicit, card, covered_fi)
    phase(phase_multi_implicit_parity)
    mi_fused_launches = phase(phase_multi_implicit_fused, card, covered_fi)
    rk_launches = phase(phase_rk, card)
    phase(phase_rk_parity)
    rk_adaptive_launches = phase(phase_rk_adaptive, card)
    phase(phase_sweepers_parity)
    phase(phase_sweeper_times, mi_run, ctrl, card)
    covered_pd = phase(phase_paradiag_kernels)
    pd_run, pd_big, pd_launches = phase(phase_paradiag, card, covered_pd)
    phase(phase_paradiag_parity)
    phase(phase_second_order, card)
    phase(phase_dae, card)
    phase(phase_paradiag_times, pd_run, pd_big, card)
    clean_res, hotrod_tol, res_launches, covered_res = phase(phase_resilience, card)
    flavour_launches = phase(phase_flavours, card, covered_res)
    inexact_launches = phase(phase_inexactness, card, covered_fi)
    phase(phase_switch, card)
    phase(phase_resilience_times, hotrod_tol, card)
    covered_mono = phase(phase_monodomain_kernels)
    mono_launches = phase(phase_monodomain, card, covered_mono)
    phase(phase_monodomain_parity)
    phase(phase_navier_stokes, card)
    phase(phase_models_parity)
    phase(phase_monodomain_times, card)
    phase(phase_autograd_kernels, card)
    emb_launches = phase(phase_embedding, card)
    s26_launches = phase(phase_step26, card)
    matrix_launches = phase(phase_matrix, card)
    phase(phase_logtofile, card)
    linearized_launches = phase(phase_linearized, card)
    phase(phase_mesh_halo, card)
    mesh_runs, mesh_launches = phase(phase_mesh_main, card)
    mesh_pd_launches = phase(phase_mesh_paradiag, card)
    phase(phase_mesh_fieldsio, card)
    phase(phase_mesh_times, mesh_runs, card)
    phase(phase_graph_loop, card)
    sparse_fused_launches, sparse_fused_replay = phase(phase_sparse_fused, card)
    krylov_fused = phase(phase_krylov_fused, card, covered_fi)
    phase(phase_spectral_fused, card)
    linearized_fused_launches = phase(phase_linearized_fused, card)
    direct_fused_launches = phase(phase_direct_fused, card)

    by_path = {'heat': launches, 'pfasst': pfasst_launches, 'imex': imex_launches, 'fused': fused_launches,
               f'adaptive {N_AD}': adaptive_launches[N_AD], f'adaptive {N_AD_BIG}': adaptive_launches[N_AD_BIG],
               'adaptive allen-cahn': ac_launches, 'allen-cahn sweeps': ac_sweep_launches,
               'implicit allen-cahn': implicit_launches, 'implicit fused': implicit_fused_launches,
               'krylov': krylov_launches, 'multi-implicit allen-cahn': mi_launches,
               'multi-implicit fused': mi_fused_launches, 'rk ESDIRK43': rk_launches['ESDIRK43'],
               'rk ARK548L2SA': rk_launches['ARK548L2SA'], 'rk adaptive': rk_adaptive_launches,
               'paradiag': sum(pd_launches.values()), 'resilience': res_launches,
               'adaptivity flavours': flavour_launches, 'inexactness': inexact_launches,
               'monodomain esdc': mono_launches['esdc'], 'monodomain imex': mono_launches['imex'],
               'embedding forward': emb_launches['forward'], 'embedding backward': emb_launches['backward'],
               'step 26 inversion 48^2': s26_launches['inversion'], 'step 26 march 128^2': s26_launches['march'],
               'matrix vmap': matrix_launches,
               'linearized jacfwd': linearized_launches, 'linearized fused': linearized_fused_launches,
               **mesh_launches, 'mesh paradiag': mesh_pd_launches,
               'krylov fused CG': krylov_fused['CG'], 'krylov fused GMRES': krylov_fused['GMRES']}
    k2_by_path = {'sparse': k2_launches, 'sparse fused': sparse_fused_launches, 'direct fused': direct_fused_launches}
    kernels = [
        dict(name='cross_stencil_2d', route='cuda', source='pysdc_tpu_torch/csrc/cross_stencil.cu',
             replaces='pysdc_tpu/ops/pallas/stencil.py:169', launches=sum(by_path.values()),
             launches_by_path=by_path, max_abs_err=main_err, max_abs_err_pfasst=pfasst_err,
             float64_library=krylov_fused['float64 yardstick'], **k1),
        dict(name='dia_spmv', route='cuda', source='pysdc_tpu_torch/csrc/dia_spmv.cu',
             replaces='pysdc_tpu/ops/pallas/dia.py:144', launches=sum(k2_by_path.values()),
             launches_by_path=k2_by_path, replayed_in_one_sparse_fused_block=sparse_fused_replay,
             max_abs_err=sparse_errs['dia_spmv'], **k2),
        dict(name='bsr_spmm', route='cuda', source='pysdc_tpu_torch/csrc/bsr_spmm.cu',
             replaces='pysdc_tpu/ops/pallas/spmv.py:29', launches=k3_launches,
             max_abs_err=sparse_errs['bsr_spmm'], **k3),
        dict(name='sine_solve', route='cuda', source='pysdc_tpu_torch/csrc/sine_solve.cu',
             replaces='none: the JAX package solves by dense eigen products (pysdc_tpu/ops/linop.py)', tpu_twin=False,
             launches=sine_launches, **sine),
        dict(name='lu_panel', route='cuda', source='pysdc_tpu_torch/csrc/dense_lu.cu',
             replaces='none: no TPU kernel (XLA computes the LU of jnp.linalg.solve, pysdc_tpu/ops/spectral.py:565)',
             tpu_twin=False, launches=lu_launches['lu_panel']['main'],
             launches_in_a_replayed_block=lu_launches['lu_panel']['replayed_block'],
             max_abs_err_pivoting_cases=lu_err['lu_panel'], **lu),
        dict(name='lu_swap_trsm', route='cuda', source='pysdc_tpu_torch/csrc/dense_lu.cu',
             replaces='none: no TPU kernel (XLA computes the LU of jnp.linalg.solve, pysdc_tpu/ops/spectral.py:565)',
             tpu_twin=False, launches=lu_launches['lu_swap_trsm']['main'],
             launches_in_a_replayed_block=lu_launches['lu_swap_trsm']['replayed_block'],
             max_abs_err_pivoting_cases=lu_err['lu_swap_trsm'], **swap),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
