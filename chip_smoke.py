"""Drives the PyTorch/CUDA port on one GPU and checks it end to end.

    python3 chip_smoke.py [--baseline-source FILE] [--previous-source FILE]

Phases (any failure raises and exits non-zero):
1. Prints the card (``nvidia-smi`` name and power limit) and builds the CUDA
   kernels from ``vizier_tpu_torch/csrc`` (timed, with ptxas' register report).
2. Holds K1 (``matern52_ard_fwd``) and K2 (``matern52_ard_bwd``) against their
   plain PyTorch versions on the card, printing the tile each case gets: the
   exact path's masked Gram (1000 valid rows padded to 1024, noise diagonal)
   and its masked cross kernels (the sweep's 50 queries and the PE
   conditioning's 1024 rows against the data), the sparse path's Knm (both
   row masks; 6 and 3 restarts), Kmm (diagonal value 1e-4, which must give
   amp^2 + 1e-4 bit for bit), per-pick Knm and Kmm over 133 ragged slots and
   its predict shapes, ragged shapes, masked dims with batched x1, Dc=0 with
   Ds>0, and Dc=80. K2 runs in each mode (parameters with both sides'
   feature gradients; the feature kernel alone; a Gram's parameters alone),
   each twice with bit-identical results, the feature kernel giving the same
   floats with and without the parameters; the Gram's two triangles must be
   bit-identical. Then every tile shape is forced in turn at each cross
   shape of both paths, checked the same way and timed, so no tile that
   either path can take goes unchecked.
3. Times each kernel at the Gram and the cross shapes of both paths by device
   time (CUDA events around the replay of a CUDA graph of back-to-back
   launches, so the host's enqueue rate drops out), beside the wrapper's host
   time per call, its plain version, the nearest PyTorch call
   (``torch.cdist`` with exact differences + elementwise Matern + masks) and
   its bound. With ``--baseline-source`` (a copy of commit a3a3a6f's
   kernels, ``git show a3a3a6f:vizier_tpu_torch/csrc/matern52.cu``, whose
   unmasked interface is the one it binds) it builds that file into a
   temporary directory and times its kernels the same way in the same run.
4. The exact main path through the designer entry points: a
   ``VizierGPUCBPEBandit`` on a 20-D float space takes bench.py's 1000
   synthetic completed trials and serves one ``suggest(count=5)`` request
   (``_REQUESTS``; two before the algorithms phase joined the script),
   completing the suggestions. Launch counts are reset just
   before and read just after; both kernels, K1's Gram and cross modes
   and K2's Gram mode must have run. Suggestions finite and in bounds, every
   trained Cholesky finite, the trained posterior's predictions on the card
   against the port's plain CPU path at the same parameters (the trained
   ones and unit-scale ones). Then profiles one more request.
5. The service-configured DEFAULT: the same designer with
   ``surrogate=SurrogateConfig()``, ``warm_ard_restarts=1`` on the same study
   serves one ``suggest(count=5)`` through the sparse SGPR surrogate (a
   cold train; two requests before the service-reliability phase joined the
   script), with its own launch counts (K1 and K2 in both their Gram and
   cross modes), the same output checks, k-center picks and predictions
   against the CPU plain path, the k-center loop's launches and time, and
   one more profiled request (a warm train). Then one sparse
   ``suggest(count=1)`` of ``VizierGPBandit`` (GAUSSIAN_PROCESS_BANDIT).
6. Multi-objective studies: DTLZ2 with two objectives (both MINIMIZE; the
   port's ``MultiObjectiveExperimenter.dtlz``, its study's checksum printed)
   at 1000 completed trials drawn uniformly from [0, 1]^20 with seed 0. The
   DEFAULT as the service builds it (``SurrogateConfig()``,
   ``warm_ard_restarts=1``) serves one ``suggest(count=5)``, one GP per
   objective (a cold train; two requests before the service-reliability
   phase joined the script), with its launch counts (K1
   Gram and cross, K2 Gram), the mode staying exact, every per-metric
   Cholesky finite, each metric's predictions and the pick's HV-scalarized
   and PE scores against the CPU plain path, and one profiled request. Then
   the SEPARABLE multi-task variant serves one request (joint Cholesky
   finite, per-task predictions against the CPU, the learned task
   correlation printed), GAUSSIAN_PROCESS_BANDIT one multi-objective
   ``suggest(count=1)``, and the Pareto ops run over the study's 1010
   completed trials on the card against the CPU. The kernel checks, tile
   comparisons and timings of phases 2-3 include this phase's shapes.
7. The service's suggest path, as the Pythia process runs it: the port's
   ``service/policy_factory.py`` -> ``CachedDesignerStatePolicy`` ->
   ``ServingRuntime`` -> ``BatchExecutor``, one ``InRamPolicySupporter`` per
   study and 8 threads calling ``policy.suggest(SuggestRequest(count=5))``
   at once. serving-exact: 8 studies of bench.py's 20-D objective (seed =
   study index) with 480 + 2i completed trials (the 512-row bucket, below
   the sparse threshold): one cold flush and one warm one through
   ``UCBPEProgram``, the picks completed between rounds, then one
   GAUSSIAN_PROCESS_BANDIT round of ``suggest(count=1)`` through
   ``GPBanditProgram``. serving-sparse: the same at 1000 + 2i trials (the
   1024 bucket, SGPR with 128 k-center inducing points) through
   ``UCBPESparseProgram`` (two rounds) and ``GPBanditSparseProgram``. Each
   round must be one flush of occupancy 8 with no fallback and no slot
   error; suggestions finite and in bounds; every trained factor finite.
   The first round is served again with batching off (the first 2 studies,
   ``_REFERENCE_STUDIES``, one after another): the throughput reference and
   the parity reference (each of those slots' trained NLL; every slot's
   posterior at unit-scale parameters computed in the stacked batch and
   alone). Prints flushes, occupancy, wall time per
   flush and request, throughput on and off, K1/K2 launches per flush
   against the 8 sequential requests', the device busy and idle share of one
   profiled flush and of one profiled sequential request, and the peak
   device memory above the phase's baseline. The batched rounds run at a
   2 s flush window (``_SERVE_WINDOW_MS``); serving-exact ends with one more
   cold round of the same 8 studies at ``ServingConfig()`` itself (4 ms),
   whose flushes, occupancy and wall time are printed, not gated (its
   suggestions are checked, and it must have no fallback or slot error).
   The kernel checks and timings of phases 2-3 include the flushes' grouped
   shapes (a study's rows, codes and masks per group of restarts, and each
   pick's re-conditioning).
8. Regret parity, the DEFAULT designer against the JAX package's 5-seed
   reference (``budget_ab_r5.json``'s ``first_pick_full`` rows) through the
   port's benchmark layer (``vizier_tpu_torch/benchmarks/regret.py``):
   Sphere20d, Rastrigin20d and Branin2d (``shifted_bbob_instance``), seeds
   1-5, 150 trials, batch 10, 25 000 acquisition evaluations, each
   function's 5 studies advancing in lockstep through one ``BatchExecutor``
   (8 slots, 2 s window): every round after the seed round must be one flush
   of all 5, with no fallback or slot error, every suggestion finite and in
   bounds. Prints each run's final regret beside the reference's, the
   medians and the exact one-sided Mann-Whitney p, and fails if p < 0.01 on
   Sphere20d or Rastrigin20d or Branin2d's median is above 1e-3; prints the
   wall time per round, flushes and occupancy, ``gp.posterior_cholesky``'s
   float64 refactors and K1/K2 launches per function, and the peak device
   memory above the phase's baseline. Then the runner entry point on one
   study (Branin2d seed 1 through ``BenchmarkState`` ->
   ``InRamDesignerPolicy`` -> ``BenchmarkRunner``, the same Branin gate),
   and regret_suite.py's GAUSSIAN_PROCESS_BANDIT on Branin (seed 1: its
   best below that seed's random best in ``regret_suite_r5.json``),
   DEFAULT on the mixed space (above the reference-random median of
   ``regret_report_r4.json``) and the bandit on ZDT1 (final hypervolume
   finite and positive, printed beside the JAX run's). The kernel checks,
   tile comparisons and timings of phases 2-3 include this phase's shapes.
9. gp-surface: the GP designers' remaining single-objective surface on
   bench.py's study (1000 trials x 20-D), each step a request through the
   designers' entry points with its launches by mode and wall printed:
   ``VizierGPBandit(acquisition="pi")`` ``suggest(1)``; joint qEI
   (``acquisition="qei"``, ``surrogate=SurrogateConfig()``) ``suggest(5)``,
   kind ``qei_joint``, on the exact posterior though the study is past the
   sparse threshold, exactly one K1 cross (k*) launch per sweep iteration,
   profiled (device busy, idle share, the Cholesky kernels' time), its
   winning batch's qEI and a pool of 50 batches' qEI recomputed on the CPU
   with the same normals, ``predict_joint`` against the CPU, and LCB / LogEI
   / PI / Sample / the q-acquisitions / MES at the sweep's shape against the
   CPU; ``predict`` and ``sample(1000)`` at 100 points with no Gram launch
   and no train; UCB-PE's set acquisition ``suggest(5)`` (one pick, then a
   set of four whose log-determinant score is recomputed on the CPU); UCB-PE
   with the corner ``prior_acquisition`` (every pick near the corner);
   transfer through ``set_priors`` (two 1000-trial prior studies of a
   shifted objective under a 100-trial one: three exact levels at 1024,
   1024 and 128 rows, the winning stacked UCB recomputed on the CPU); the
   exact DEFAULT with ``ard_optimizer=AdamOptimizer()``. Then K1/K2 at every
   launch layout the phase recorded, each tile forced in turn.
10. algorithms: the service's other algorithms and the wrappers, through
   the entry points a user calls. The port's ``DefaultPolicyFactory`` with
   an ``InRamPolicySupporter`` per route serves two ``SuggestRequest(count=5)``
   (picks completed in between) for RANDOM_SEARCH, QUASI_RANDOM_SEARCH,
   GRID_SEARCH, EAGLE_STRATEGY and CMA_ES on bench.py's study (1000 x 20-D),
   SHUFFLED_GRID_SEARCH on a 6-D study of the same objective (at 20-D the
   shuffled grid, 10^20 points, cannot be built, ROADMAP C12), NSGA2 on
   phase 6's DTLZ2 study and BOCS and HARMONICA on a 20-bit study (100
   trials of a seeded sparse quadratic); every suggestion feasible, and each
   serializable route's second request loads the state the first wrote.
   NSGA2's survival ranking over the DTLZ2 study's 1010 trials on the card
   against the CPU plain path (layers, crowding bit for bit, the surviving
   order). ``ScalarizingDesigner`` (Chebyshev, the GP bandit on the card) on
   the DTLZ2 study: scalarized labels bit-identical to the CPU's, one
   ``suggest(1)`` with its launches by mode, the inner posterior against the
   CPU (unit-scale parameters within 5e-3, trained ones printed).
   ``scheduled_gp_ucb_pe`` and ``UnsafeAsInfeasibleDesigner`` (the DEFAULT
   inside, one safety metric) at 150 x 20-D, two ``suggest(5)`` each, the
   picks completed and fed back: the scheduled values and rebuilds printed, the unsafe trials (and only they)
   reaching the inner designer as infeasible. regret_suite.py's baselines
   (Random/Branin, Eagle/Sphere20d and Rastrigin20d, NSGA2/ZDT1), seeds 1-5,
   each held to ``regret_suite_baselines_5seed.json`` by the exact one-sided
   rank test (fail at p < 0.01), each seed's value printed beside the
   reference's. Then K1/K2 at every launch layout the phase recorded, each
   tile forced in turn.
11. algorithm extras: ``LBFGSBOptimizer()`` (16 restarts, 50 iterations)
   maximizes the UCB with its trust region over the exact path's trained
   DEFAULT (phase 4's cached fit, no retrain), its gradient with respect to
   the query points through K2's feature kernel: points in [0, 1]^20, the 5
   best scores recomputed on the CPU (5e-3 x max(1, |cpu|)), the loss
   gradient at the 16 starting points against the CPU plain autograd
   (1e-3 relative), every K2 launch the feature kernel alone
   (``features_only`` mode: the GP's parameters are constants), its layout
   held to the plain version in both K2 modes and timed alone, with the
   parameters and parameters only, beside the plain versions, the library
   form (``torch.cdist`` + ``torch.baddbmm``) and both bounds; the eagle
   sweep's best UCB at the same state printed beside it. ``DesignerAsOptimizer`` with
   the eagle designer over the same score (20 rounds x 10). The median and
   regression early-stopping rules through ``InRamPolicySupporter`` on a
   learning-curve study (300 trials x 100 steps, 8 parameters, 250
   completed): the regression rule's second poll reuses its fit, every trial
   it stops is predicted below the completed median, and a second run gives
   the same decisions. The eagle meta-learning designer on bench.py's study
   through INITIALIZE, TUNE and USE_BEST_PARAMS (6 rounds of
   ``suggest(10)``). ``EnsembleDesigner`` (EXP3-IX) over Random, Eagle and
   the DEFAULT on the regret cell's shifted Sphere20d at 150 trials (4
   rounds of ``suggest(5)``, the arms and the DEFAULT arm's launches
   printed). Then K1/K2 at every launch layout the phase recorded. Phase 4's
   request and phase 5's GAUSSIAN_PROCESS_BANDIT ``suggest(1)`` run under
   ``utils/profiler.collect_events()``; their phase timers are printed and
   must hold the JAX designers' names (the DEFAULT: train_gp,
   acquisition_optimizer, best_candidates_to_trials; the bandit also
   convert_trials).
12. service-reliability: the serving runtime's coalescer, circuit breakers,
   deadline and quasi-random fallback (``ServingRuntime.guarded_suggest``,
   the order the gRPC Pythia servicer serves in, without protobuf) around
   the DEFAULT on the card at bench.py's study: 8 threads coalesced onto one
   designer computation with 8 equal answers; a study whose computation is
   made to raise 3 times opens its breaker, is served stamped fallbacks equal
   to the host's for the same study name and frontier, and a half-open probe
   (the DEFAULT on the card) closes it; an expired deadline is refused before
   dispatch. The fallback and short-circuit counters must equal the injected
   cases, and every other request must be served by the designer. Then
   K1/K2 at every launch layout the phase recorded.
13. service-planes: the serving runtime's opt-in planes armed together in one
   ``ServingRuntime`` around the DEFAULT on the card at bench.py's study
   (``run_service_planes_phase``, protobuf-free as phase 12): tenant a's live
   ``suggest(5)`` admitted at ``max_inflight=1`` while tenant b is shed with
   its retry-after hint, the state machine escalating to DEGRADED and a
   low-weight tenant served stamped quasi-random points (no launch, counters
   equal to the injected cases); the completion's speculative job on the
   executor's deferrable lane parks exactly one batch (a failed, dropped or
   empty job fails the run), the next ``suggest(5)`` is served from it stamped
   ``speculative=hit`` with 0 launches under 50 ms, and a moved frontier
   refuses the slot; an SLO breach's black-box dump with exemplar traces, the
   flight recorder's events in order, the ``vizier_slo_*`` / speculative /
   admission series, a fleet dump read back. Then K1/K2 at every launch
   layout of its two designer computations.
14. fleet: the fleet's routing onto one shared runtime, as the in-process
   compute tier serves it (``run_fleet_phase``). The port's ``StudyRouter``
   (``distributed/routing.py``, rendezvous hashing) places 8 studies of
   serving-exact's shape (480 + 2i trials x 20-D, the DEFAULT, exact GP)
   on 4 frontend ids; each frontend's handler threads send its own studies'
   ``suggest(5)`` into ONE ``ServingRuntime`` (2 s window): one flush of
   occupancy 8 with no fallback or slot error, 8 cold trains. The picks are
   completed; one frontend is marked down: exactly its studies move, each to
   the frontend ``rendezvous_weight`` ranks next, and their next
   ``suggest(5)``, sent by those successors, trains warm from the shared
   designer cache (warm trains = the moved count, no cold train). Marked up
   again, every study's owner is the one before the kill. Suggestions finite
   and in bounds. The phase imports no protobuf: the fleet's gRPC,
   protobuf, WAL and replica-manager halves are held to the JAX package on
   the CPU only (``tests/test_torch_fleet*.py``).
15. loadgen: the loadgen engine (``vizier_tpu_torch/loadgen/``) at
   ``soak_config()`` whose fingerprint must equal the JAX package's
   (``_SOAK_FINGERPRINT``): its 1000 studies, 4334 trials (dim 2, Zipf
   budgets 1-16, the tenant and kind mixes, concurrency 8, think time
   0.15 s, the trimmed GP economics) through ``driver.run(...,
   transport="runtime")``: ``LoadgenPolicyFactory`` and one ``ServingRuntime``
   under ``scenario_env``'s planes (batching, speculation, SLO, admission,
   recorder; the mesh plane: one placement on the one card), each study's trials in an
   ``InRamPolicySupporter``, no protobuf; then the parity cohort's
   sequential reference arm and its gated-off arm. ``report.build_report``
   over the three: every assertion that needs no replica must pass (zero
   lost studies, all kinds served, fallback rate, speculative hits, SLO,
   shed rate, regret parity, bit-identity when gated off); the replica
   events and failover are printed as not run on the card (the replicas
   target needs protobuf; held on the CPU). The chaos window strikes the GP
   designers through ``ChaosDesigner``: every fallback and slot error must
   be one injected strike. The GP studies' ARD steps replay captured CUDA
   graphs (``optimizers/graphs.py``, ``AdamOptimizer(cuda_graph=True)``):
   none may fail to capture. Then K1/K2 at every launch layout it recorded,
   and one soak-layout ARD train eager and graphed on the same inputs (the
   two results within rtol 1e-4, atol 1e-5; each one's wall).
16. testing: ``SimpleKDConvergenceTester`` at the JAX gates' parameters
   (GP bandit 40 trials, batch 5, within 0.6, seed 1; GP-UCB-PE within
   0.8), ``SimpleRegretComparisonTester`` (GP bandit vs random on the 4-D
   Sphere shifted by [1, -2, 0.5, 2.5], 25 trials x 2 repeats, tolerance
   0.0), the designers on CUDA; ``testing/chaos_flushes.py``'s strikes
   through the ``BatchExecutor``: a per-slot strike degrades only its slot
   (the others equal an unstruck flush), a device-program strike runs the
   whole-batch sequential fallback, the counters equal the injected
   strikes. Then K1/K2 at every launch layout it recorded (SimpleKD's
   mixed layout among them).
17. benchmarks: the GP designers on CUDA over the benchmark slice's spaces,
   each through ``BenchmarkState`` -> ``InRamDesignerPolicy`` ->
   ``BenchmarkRunner`` (``_BENCH_ROUNDS`` rounds of ``GenerateAndEvaluate(5)``,
   the experimenters' own spaces uncut): the DEFAULT on NASBench-101 over
   ``synthetic_nasbench101``'s table (21 bools + 5 ops, no continuous
   feature), ``PestControlExperimenter`` (25 stages x 5 choices) and
   ``MAXSATExperimenter`` on a synthetic 60-variable WCNF; the GP bandit on
   ``SparseExperimenter.create_default`` with 20 placeholder floats around
   the regret cell's shifted Sphere20d (40 floats); the DEFAULT on the
   permuting, normalizing and sign-flip wrappers around discretized BBOB
   functions. Every trial completes (feasible or infeasible) with its
   parameters inside the space; each study's trained posterior is held to
   the CPU plain path (``_check_posterior_against_cpu``, 5e-3, at unit-scale
   and at the trained parameters). ``PredictorExperimenter`` over the
   sparse Sphere's GP bandit is the objective of a random-designer run: its
   values must equal the bandit's ``predict`` means for the same rng. Random
   baselines on the three combinatorial problems, then the analyzers over
   every state: best-so-far and ``MultiMetricCurveConverter`` curves,
   ``build_convergence_curve`` of each DEFAULT curve against its baseline,
   the record analyzer's comparison scores and the exploration scores.
   Then K1/K2 at every launch layout it recorded, and the largest Gram and
   cross layout of each (Dc, Ds) timed.
18. tooling, last in the ``loadgen`` worker: (a) device-phase timing
   (``observability/device_timing.py``, CUDA events on the current stream)
   of the DEFAULT at full width, bench.py's study (1000 trials x 20 floats,
   ``suggest(5)``, the picks completed in between, the whole 75 000-evaluation
   sweep) over two requests: each phase's mode, host ms and event ms
   printed; the first request's phases are ``compile``, the second's
   ``execute``, every event time within its host wall, train plus
   acquisition within the request's wall; (b) prewarm: a ``ServingRuntime``
   with batching, ``batching_prewarm`` and ``compilation_cache_dir`` on
   prewarms the soak's 2-D layout and serving-exact's 20-D layout up to
   ``batching_prewarm_max_trials`` (32) with the soak's designer economics
   (Adam ARD steps captured as CUDA graphs); the report rows, then per
   layout one live flush of 4 studies, which must capture no graph, its wall
   beside the same flush after the graphs are dropped (a bucket not
   prewarmed, same shapes, same process), the flush's program phase, and
   the kernel library built into and reloaded from the cache directory;
   (c) one soak-layout serving flush with coalescing and speculation through
   the loadgen's runtime transport under ``debug_locks.instrument()``: no
   observed lock edge may be missing from the static graph; (d)
   ``python -m vizier_tpu_torch.analysis`` with no finding outside its
   baseline, and the ``run_benchmark`` demo at its defaults.
19. mesh, last in the ``loadgen`` worker: the single-host mesh
   (``parallel/mesh.py``, ``parallel/__init__.py``). (a) The DEFAULT with
   ``use_mesh=True`` on the card's own device list at bench.py's study
   (1000 trials x 20 floats, the 75 000-evaluation sweep, one
   ``suggest(5)``): one placement, the restarts rounded to the mesh (4 on
   one device), one pool per pick's sweep, the posterior within 5e-3 of the
   CPU plain path, K1/K2 launched. (b) ``train_gp_sharded`` and
   ``maximize_acquisition_sharded`` on a 4-entry mesh of the one card
   (``local_devices`` patched for this part alone, said in its line) at
   that study, from fixed injected inits and pool seeds, against the
   unsharded train and the pools run one after another (5 000
   evaluations a pool: cut from 75 000 so eight sweeps fit the phase):
   the trained NLL and the top scores and features within 1e-3 (the chosen
   parameters printed: one restart per chunk rounds otherwise, C6); and the
   chosen parameters within 1e-5 relative of the unsharded optimizer run
   once per restart row (four batch-1 calls at the same inits, selected as
   one call selects), which holds the split, gather and selection apart
   from batch-size rounding. (c) serving-exact's 8 studies (480 + 2i trials x 20-D, the
   service DEFAULT) through a ``ServingRuntime`` with
   ``MeshConfig(enabled=True)``: one flush of occupancy 8 on ``mesh0`` run by
   the scheduler thread (no worker), each slot's suggestions equal to the
   same studies' mesh-off flush (the same padded batch of 8) and its trained
   NLL within 1e-3; both walls printed. (d) the same at
   ``shard_devices=4`` on the 4-entry logical mesh: the flush padded by
   ``pad_to`` and split into 4 chunks of 2, each slot's trained NLL within
   1e-3 of the mesh-off flush's (the per-device batch is 2, not 8: C6), its
   suggestions finite and in bounds, 0 CUDA-graph capture failures.
20. Prints one ``{"kernels": [...]}`` line (``launches``: the lockstep regret
   run's; every path's, the gp-surface, algorithms, algorithm-extras,
   service-reliability, service-planes, fleet, loadgen, testing,
   benchmarks, tooling and mesh steps' included, by mode; K2's
   ``feature_gradient`` at the L-BFGS-B layout: the feature kernel alone,
   with the parameters, its library form and bounds), the card line again,
   and as the last line ``{"ok": true, "device": {...}}``.

The phases are host-bound, so phases 7-9 and 14-19 run in three worker
processes on the same card (``_WORKER_PHASES``: this script with ``--worker``), started
once phases 2-3 have checked and timed the kernels on an idle card, beside
the main process's phases 4-6 and 10-13. Phase 15 measures a serving
plane's latency and speculative hits, which other processes' launches on
the card and the host distort, so its worker starts alone and the others,
and the main process's phases, start when phase 15 has ended. The main process prints each
worker's log when its own phases are done and times phase 11's K2 feature
layout after the workers end. A worker that fails, or runs past
``_WORKER_LIMIT_S``, fails the run.

With ``--previous-source FILE`` (the kernel source of commit 997e03e, ``git
show 997e03e:vizier_tpu_torch/csrc/matern52.cu``), it also builds that file
and checks that today's shared-input launches give the same floats, bit for
bit, as that source's at every ungrouped case of phase 2 (K1, and K2's
parameter gradients with and without the feature gradients); the feature
gradients, whose pair sums the redesigned feature kernel takes in another
order, are held to that source's within the K2 tolerance.

Exits non-zero without a result when no GPU is visible or when run outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 outside the
# tensor cores. A card set below 700 W runs slower; its limit is printed.
_HBM_BYTES_PER_S = 3.35e12
_FP32_FLOPS = 67e12
_SQRT5 = 2.2360679774997896

# Tolerances of the kernel checks. K1 and K2's feature gradients: max
# |kernel - plain| over max |plain| of each output; the >64-D plain forward
# uses the ||a||^2 - 2ab + ||b||^2 expansion, whose float32 cancellation the
# kernel's exact differences do not have. K2's parameter gradients
# (amplitude, inverse length scales), each part and each entry on its own:
# |kernel - plain| over the sum of the magnitudes of that entry's terms,
# which bounds what float32 sums in another order can differ by. A gradient
# that cancels to far below its terms (a 37-term sum at N=1, M=37) is then
# not held to its own small value, and one that does not cancel is held to
# 1e-4 of itself.
_FWD_TOL = 1e-5
_FWD_WIDE_TOL = 1e-3
_BWD_TOL = 1e-4
# Posterior mean/stddev (warped label units, ~N(0, 1)) on the card against
# the CPU at 1000 trained rows: both factor a float32 Gram whose noise
# variance is ~1e-4 of its diagonal, in different orders, and the condition
# number amplifies the rounding (5.7e-4 measured on an H100).
_PREDICT_TOL = 5e-3
# The multi-objective pick's scores (HV-scalarized UCB, PE) on the card
# against the CPU plain path at the same factorizations: max |card - cpu|
# over max |cpu|. The cumulative hypervolume with the same directions: max
# |card - cpu| / cpu per prefix.
_SCORE_TOL = 1e-4
_HV_TOL = 1e-5

# The main path's shapes at 1000 trials x 20-D (padded to 1024 rows): the
# masked ARD Gram over 4 restarts + the warm row, and the sweep's pool of 50
# queries against the masked data rows.
_GRAM = "gram B=5 N=M=1024 (1000 valid) Dc=20 Ds=0"
_CROSS = "cross B=1 N=50 M=1024 (1000 valid) Dc=20 Ds=0"
# _pe_conditioning's predict at every row of the data and pending points:
# separate tensors, so not the symmetric Gram.
_PE_CROSS = "cross B=1 N=M=1024 (1000 valid) Dc=20 Ds=0"
# The sparse surrogate's shapes at the same study (SurrogateConfig's 128
# inducing points, 5 picks per request): its collapsed-bound train builds Knm
# (both row masks) and Kmm (Gram, diagonal value 1e-4) for 6 restarts when
# cold (4 random + heuristic + warm row) and 3 when warm (1 + heuristic +
# warm); each pick re-conditions over the all-points rows (1000 + pending)
# and 128 + 5 inducing slots (the trained ones + one Nyström spare per
# pick); the PE conditioning predicts the trained posterior at every
# all-points row; the sweep scores 50 queries against 128 and 133 slots.
_SPARSE_KNM_COLD = "sparse Knm B=6 N=1024 (1000 valid) M=128 Dc=20"
_SPARSE_KNM_WARM = "sparse Knm B=3 N=1024 (1000 valid) M=128 Dc=20"
_SPARSE_KMM_COLD = "sparse Kmm gram B=6 N=M=128 diag 1e-4 Dc=20"
_SPARSE_KMM_WARM = "sparse Kmm gram B=3 N=M=128 diag 1e-4 Dc=20"
_SPARSE_KNM_PICK = "sparse per-pick Knm B=1 N=1024 (1003 valid) M=133 (130 valid) Dc=20"
_SPARSE_KMM_PICK = "sparse per-pick Kmm gram B=1 N=M=133 (130 valid) diag 1e-4 Dc=20"
_SPARSE_PE = "sparse PE conditioning cross B=1 N=1024 M=128 Dc=20"
_SPARSE_SWEEP = "sparse sweep cross B=1 N=50 M=128 Dc=20"
_SPARSE_SWEEP_AUG = "sparse sweep cross B=1 N=50 M=133 (130 valid) Dc=20"
_SPARSE_ONE = "sparse one-query cross B=1 N=1 M=128 Dc=20"
_SPARSE_CROSS_CASES = [
    (_SPARSE_KNM_COLD, dict(b=6, n=1024, m=128, dc=20, ds=0, valid1=1000, valid=128)),
    (_SPARSE_KNM_WARM, dict(b=3, n=1024, m=128, dc=20, ds=0, valid1=1000, valid=128)),
    (_SPARSE_KNM_PICK, dict(b=1, n=1024, m=133, dc=20, ds=0, valid1=1003, valid=130)),
    (_SPARSE_PE, dict(b=1, n=1024, m=128, dc=20, ds=0, valid=128)),
    (_SPARSE_SWEEP, dict(b=1, n=50, m=128, dc=20, ds=0, valid=128)),
    (_SPARSE_SWEEP_AUG, dict(b=1, n=50, m=133, dc=20, ds=0, valid=130)),
    (_SPARSE_ONE, dict(b=1, n=1, m=128, dc=20, ds=0, valid=128)),
]
_SPARSE_CASES = _SPARSE_CROSS_CASES + [
    (_SPARSE_KMM_COLD, dict(b=6, n=128, m=128, dc=20, ds=0, same=True, valid=128, jitter=1e-4)),
    (_SPARSE_KMM_WARM, dict(b=3, n=128, m=128, dc=20, ds=0, same=True, valid=128, jitter=1e-4)),
    ("sparse Kmm gram B=1 N=M=128 diag 1e-4 Dc=20",
     dict(b=1, n=128, m=128, dc=20, ds=0, same=True, valid=128, jitter=1e-4)),
    (_SPARSE_KMM_PICK, dict(b=1, n=133, m=133, dc=20, ds=0, same=True, valid=130, jitter=1e-4)),
]
# The multi-objective phase's shapes (DTLZ2, two objectives, 1000 trials x
# 20-D, the service's DEFAULT: SurrogateConfig(), warm_ard_restarts=1). Each
# metric trains its own GP: cold at the exact path's Gram (B=5), warm at B=2
# (1 restart + the warm row) over 1005 and 1010 valid rows; each metric's
# PE conditioning and sweep predict at B=1 (ensemble 1). GAUSSIAN_PROCESS_
# BANDIT trains each metric cold at B=4 (no warm row) over 1015 rows. The
# SEPARABLE multi-task GP builds Kx as K1's Gram without masks or diagonal
# (the task mask is applied to the Kronecker product) at B=4 restarts, and
# B=1 when each pick re-conditions; its k* is an unmasked cross at 1, 50
# (the sweep) and 1024 (the PE conditioning) queries.
_MO_GRAM_WARM = "multi-objective warm gram B=2 N=M=1024 (1005 valid) Dc=20"
_MO_PE = "multi-objective PE conditioning cross B=1 N=M=1024 (1010 valid) Dc=20"
_MO_SWEEP = "multi-objective sweep cross B=1 N=50 M=1024 (1010 valid) Dc=20"
_MO_BANDIT_GRAM = "multi-objective bandit gram B=4 N=M=1024 (1015 valid) Dc=20"
_MT_KX = "multi-task Kx gram B=4 N=M=1024 unmasked Dc=20"
_MT_KX_PICK = "multi-task per-pick Kx gram B=1 N=M=1024 unmasked Dc=20"
_MT_KSTAR = "multi-task sweep k* cross B=1 N=50 M=1024 unmasked Dc=20"
_MT_KSTAR_PE = "multi-task PE k* cross B=1 N=M=1024 unmasked Dc=20"
_MT_KSTAR_ONE = "multi-task one-query k* cross B=1 N=1 M=1024 unmasked Dc=20"
_MO_CROSS_CASES = [
    (_MO_PE, dict(b=1, n=1024, m=1024, dc=20, ds=0, valid=1010)),
    (_MO_SWEEP, dict(b=1, n=50, m=1024, dc=20, ds=0, valid=1010)),
    (_MT_KSTAR_ONE, dict(b=1, n=1, m=1024, dc=20, ds=0)),
    (_MT_KSTAR, dict(b=1, n=50, m=1024, dc=20, ds=0)),
    (_MT_KSTAR_PE, dict(b=1, n=1024, m=1024, dc=20, ds=0)),
]
_MO_CASES = _MO_CROSS_CASES + [
    (_MO_GRAM_WARM, dict(b=2, n=1024, m=1024, dc=20, ds=0, same=True, valid=1005)),
    (_MO_BANDIT_GRAM, dict(b=4, n=1024, m=1024, dc=20, ds=0, same=True, valid=1015)),
    (_MT_KX, dict(b=4, n=1024, m=1024, dc=20, ds=0, same=True)),
    (_MT_KX_PICK, dict(b=1, n=1024, m=1024, dc=20, ds=0, same=True)),
]
# The serving phases' flushes: 8 studies in one batch, each study's rows,
# codes and masks one group of the batch. serving-exact (480 + 2i valid rows
# of 512): the cold train's Gram over 4 restarts + the warm row, the warm
# train's over 1 + the warm row, the PE conditioning's all-points rows
# against each study's data and the sweep's 50 queries, and each pick's
# all-points Gram (one member per study, 480 + 2i + pending valid rows).
# serving-sparse (1000 + 2i valid rows of 1024, 128 inducing points): Knm
# over 6 (cold) and 3 (warm) restarts, Kmm, and the sweep's k* against
# 128 + 5 slots; each pick's re-conditioning over the all-points rows
# (1000 + 2i + pending) and 128 + 5 slots (128 + the study's augments
# valid), its Kmm, and the PE conditioning's k* at the 1024 all-points rows.
_FLUSH_GRAM_COLD = "flush exact cold gram B=8x5 N=M=512 (480-494 valid) Dc=20"
_FLUSH_GRAM_WARM = "flush exact warm gram B=8x2 N=M=512 (480-494 valid) Dc=20"
_FLUSH_PE = "flush exact PE cross B=8 N=M=512 (480-494 valid) Dc=20"
_FLUSH_SWEEP = "flush exact sweep cross B=8 N=50 M=512 (480-494 valid) Dc=20"
_FLUSH_KNM_COLD = "flush sparse Knm B=8x6 N=1024 (1000-1014 valid) M=128 Dc=20"
_FLUSH_KNM_WARM = "flush sparse Knm B=8x3 N=1024 (1000-1014 valid) M=128 Dc=20"
_FLUSH_KMM = "flush sparse Kmm gram B=8x6 N=M=128 diag 1e-4 Dc=20"
_FLUSH_KSTAR = "flush sparse k* cross B=8 N=50 M=133 (130 valid) Dc=20"
_FLUSH_GRAM_PICK = "flush exact per-pick all-points gram B=8 N=M=512 (483-497 valid) Dc=20"
_FLUSH_KNM_PICK = "flush sparse per-pick Knm B=8 N=1024 (1003-1017 valid) M=133 (128-133 valid) Dc=20"
_FLUSH_KMM_PICK = "flush sparse per-pick Kmm gram B=8 N=M=133 (130 valid) diag 1e-4 Dc=20"
_FLUSH_SPARSE_PE = "flush sparse PE k* cross B=8 N=1024 M=128 Dc=20"
_FLUSH_CAT = "flush categorical-only gram B=4x2 N=M=200 (190-196 valid) Dc=0 Ds=5"
_FLUSH_CROSS_CASES = [
    (_FLUSH_PE, dict(b=8, n=512, m=512, dc=20, ds=0, valid=480, step=2, studies=8)),
    (_FLUSH_SWEEP, dict(b=8, n=50, m=512, dc=20, ds=0, valid=480, step=2, studies=8)),
    (_FLUSH_KNM_COLD, dict(b=48, n=1024, m=128, dc=20, ds=0, valid1=1000, step1=2, valid=128,
                           studies=8)),
    (_FLUSH_KNM_WARM, dict(b=24, n=1024, m=128, dc=20, ds=0, valid1=1000, step1=2, valid=128,
                           studies=8)),
    (_FLUSH_KSTAR, dict(b=8, n=50, m=133, dc=20, ds=0, valid=130, studies=8)),
    (_FLUSH_KNM_PICK, dict(b=8, n=1024, m=133, dc=20, ds=0, valid1=1003, step1=2, valid=128,
                           step=1, studies=8)),
    (_FLUSH_SPARSE_PE, dict(b=8, n=1024, m=128, dc=20, ds=0, valid=128, studies=8)),
]
_FLUSH_CASES = _FLUSH_CROSS_CASES + [
    (_FLUSH_GRAM_COLD, dict(b=40, n=512, m=512, dc=20, ds=0, same=True, valid=480, step=2,
                            studies=8)),
    (_FLUSH_GRAM_WARM, dict(b=16, n=512, m=512, dc=20, ds=0, same=True, valid=480, step=2,
                            studies=8)),
    (_FLUSH_KMM, dict(b=48, n=128, m=128, dc=20, ds=0, same=True, valid=128, jitter=1e-4,
                      studies=8)),
    (_FLUSH_GRAM_PICK, dict(b=8, n=512, m=512, dc=20, ds=0, same=True, valid=483, step=2,
                            studies=8)),
    (_FLUSH_KMM_PICK, dict(b=8, n=133, m=133, dc=20, ds=0, same=True, valid=130, jitter=1e-4,
                           studies=8)),
    (_FLUSH_CAT, dict(b=8, n=200, m=200, dc=0, ds=5, same=True, valid=190, step=2, studies=4)),
]
# The regret phase's shapes. Lockstep: a function's 5 seeds flush together,
# padded to the executor's 8 slots with copies of slot 0, each slot at the
# round's n = 10r completed trials; rows are padded to the next power of two
# (16 at n = 10, 32 at 20-30, ..., 256 at 130-140), the all-points rows to
# pad(n + 10) with n to n + 9 valid as the picks go in. Each flush trains
# over 4 restarts + the warm row (B = 8 x 5), re-conditions each pick on the
# all-points Gram (B = 8), runs the PE conditioning's all-points queries and
# the sweep's 50 (and the one-query predict) against the data: Dc = 20
# (Sphere20d, Rastrigin20d) and Dc = 2 (Branin2d), at the first rounds (10
# and 20 trials) and the last (120 and 140). The mixed-space DEFAULT runs
# alone (B = 5 and 1) at Dc = 2 with Ds = 1 (the integer is continuous, the
# categorical one code), the GP bandit on Branin alone (B = 5 and 1, its
# sweep at B = 1 against up to 32 rows, 30 valid) and on ZDT1 at Dc = 6 (the
# per-metric Grams at B = 4, the sweep at B = 1 against 64 rows, 55 valid).
# These lists are worked out from the code; the phase itself records the
# layout of every launch it makes (kernels.LAUNCH_SHAPES) and holds each one
# to the plain version afterwards (check_recorded_shapes).
_REGRET_GRAM = "regret cold gram B=8x5 N=M=256 (140 valid) Dc=20"
_REGRET_GRAM_2D = "regret cold gram B=8x5 N=M=16 (10 valid) Dc=2"
_REGRET_PICK = "regret per-pick all-points gram B=8 N=M=256 (149 valid) Dc=20"
_REGRET_PICK_2D = "regret per-pick all-points gram B=8 N=M=32 (29 valid) Dc=2"
_REGRET_PE = "regret PE cross B=8 N=M=256 (140 valid) Dc=20"
_REGRET_PE_128 = "regret PE cross B=8 N=256 M=128 (120 valid) Dc=20"
_REGRET_PE_2D = "regret PE cross B=8 N=32 M=16 (10 valid) Dc=2"
_REGRET_SWEEP = "regret sweep cross B=8 N=50 M=256 (145 valid) Dc=20"
_REGRET_SWEEP_2D = "regret sweep cross B=8 N=50 M=32 (20 valid) Dc=2"
_REGRET_ONE_2D = "regret one-query cross B=8 N=1 M=32 (20 valid) Dc=2"
_MIXED_GRAM = "mixed-space gram B=5 N=M=32 (27 valid) Dc=2 Ds=1"
_MIXED_SWEEP = "mixed-space sweep cross B=1 N=50 M=32 (29 valid) Dc=2 Ds=1"
_ZDT_GRAM = "ZDT1 bandit gram B=4 N=M=64 (55 valid) Dc=6"
_ZDT_SWEEP = "ZDT1 bandit sweep cross B=1 N=50 M=64 (55 valid) Dc=6"
_BANDIT_SWEEP_2D = "Branin bandit sweep cross B=1 N=50 M=32 (30 valid) Dc=2"
_REGRET_CROSS_CASES = [
    (_REGRET_PE, dict(b=8, n=256, m=256, dc=20, ds=0, valid=140, studies=8)),
    (_REGRET_PE_128, dict(b=8, n=256, m=128, dc=20, ds=0, valid=120, studies=8)),
    (_REGRET_PE_2D, dict(b=8, n=32, m=16, dc=2, ds=0, valid=10, studies=8)),
    (_REGRET_SWEEP, dict(b=8, n=50, m=256, dc=20, ds=0, valid=145, studies=8)),
    (_REGRET_SWEEP_2D, dict(b=8, n=50, m=32, dc=2, ds=0, valid=20, studies=8)),
    (_REGRET_ONE_2D, dict(b=8, n=1, m=32, dc=2, ds=0, valid=20, studies=8)),
    (_MIXED_SWEEP, dict(b=1, n=50, m=32, dc=2, ds=1, valid=29)),
    (_ZDT_SWEEP, dict(b=1, n=50, m=64, dc=6, ds=0, valid=55)),
    (_BANDIT_SWEEP_2D, dict(b=1, n=50, m=32, dc=2, ds=0, valid=30)),
]
_REGRET_CASES = _REGRET_CROSS_CASES + [
    (_REGRET_GRAM, dict(b=40, n=256, m=256, dc=20, ds=0, same=True, valid=140, studies=8)),
    ("regret cold gram B=8x5 N=M=128 (120 valid) Dc=20",
     dict(b=40, n=128, m=128, dc=20, ds=0, same=True, valid=120, studies=8)),
    (_REGRET_GRAM_2D, dict(b=40, n=16, m=16, dc=2, ds=0, same=True, valid=10, studies=8)),
    ("regret cold gram B=8x5 N=M=256 (140 valid) Dc=2",
     dict(b=40, n=256, m=256, dc=2, ds=0, same=True, valid=140, studies=8)),
    (_REGRET_PICK, dict(b=8, n=256, m=256, dc=20, ds=0, same=True, valid=149, studies=8)),
    (_REGRET_PICK_2D, dict(b=8, n=32, m=32, dc=2, ds=0, same=True, valid=29, studies=8)),
    (_MIXED_GRAM, dict(b=5, n=32, m=32, dc=2, ds=1, same=True, valid=27)),
    (_ZDT_GRAM, dict(b=4, n=64, m=64, dc=6, ds=0, same=True, valid=55)),
]
# The gp-surface phase's shapes at 1000 x 20-D: joint qEI's k* over a pool of
# 50 batches of 5 (250 points) and set-PE's (50 sets of 4) against the data
# rows, their K(q, q) blocks (candidate p is group p of the batch), and the
# stacked residual's 100-trial level (its Gram over 4 restarts, its sweep).
# The phase also records its launches' layouts and holds each one to the
# plain version (check_recorded_shapes).
_QEI_KSTAR = "gp-surface qEI k* cross B=1 N=250 M=1024 (1000 valid) Dc=20"
_QEI_KQQ = "gp-surface qEI K(q,q) gram B=50 grouped N=M=5 unmasked Dc=20"
_SET_PE_KSTAR = "gp-surface set-PE k* cross B=1 N=200 M=1024 (1006 valid) Dc=20"
_SET_PE_KQQ = "gp-surface set-PE K(q,q) gram B=50 grouped N=M=4 unmasked Dc=20"
_STACK_GRAM = "gp-surface stacked level gram B=4 N=M=128 (100 valid) Dc=20"
_STACK_SWEEP = "gp-surface stacked level sweep cross B=1 N=50 M=128 (100 valid) Dc=20"
# The algorithm-extras phase's L-BFGS-B: its 16 restarts' query points
# against the exact path's data rows, whose gradient is K2's feature side.
_LBFGSB_FEATURES = "lbfgsb features cross B=1 N=16 M=1024 (1000 valid) Dc=20"
_SURFACE_CROSS_CASES = [
    (_QEI_KSTAR, dict(b=1, n=250, m=1024, dc=20, ds=0, valid=1000)),
    (_SET_PE_KSTAR, dict(b=1, n=200, m=1024, dc=20, ds=0, valid=1006)),
    (_STACK_SWEEP, dict(b=1, n=50, m=128, dc=20, ds=0, valid=100)),
    (_LBFGSB_FEATURES, dict(b=1, n=16, m=1024, dc=20, ds=0, valid=1000)),
]
_SURFACE_CASES = _SURFACE_CROSS_CASES + [
    (_QEI_KQQ, dict(b=50, n=5, m=5, dc=20, ds=0, same=True, studies=50)),
    (_SET_PE_KQQ, dict(b=50, n=4, m=4, dc=20, ds=0, same=True, studies=50)),
    (_STACK_GRAM, dict(b=4, n=128, m=128, dc=20, ds=0, same=True, valid=100)),
]
_TIMED = (_GRAM, _CROSS, _PE_CROSS, _SPARSE_KNM_COLD, _SPARSE_KNM_WARM, _SPARSE_KMM_COLD,
          _SPARSE_KMM_WARM, _SPARSE_KNM_PICK, _SPARSE_KMM_PICK, _SPARSE_PE, _SPARSE_SWEEP,
          _SPARSE_SWEEP_AUG, _MO_GRAM_WARM, _MO_PE, _MO_SWEEP, _MO_BANDIT_GRAM, _MT_KX, _MT_KX_PICK,
          _MT_KSTAR, _MT_KSTAR_PE, _MT_KSTAR_ONE, _FLUSH_GRAM_COLD, _FLUSH_GRAM_WARM, _FLUSH_PE, _FLUSH_SWEEP,
          _FLUSH_KNM_COLD, _FLUSH_KNM_WARM, _FLUSH_KMM, _FLUSH_KSTAR, _FLUSH_GRAM_PICK,
          _FLUSH_KNM_PICK, _FLUSH_KMM_PICK, _FLUSH_SPARSE_PE, _REGRET_GRAM, _REGRET_GRAM_2D,
          _REGRET_PICK, _REGRET_PICK_2D, _REGRET_PE, _REGRET_PE_2D, _REGRET_SWEEP,
          _REGRET_SWEEP_2D, _REGRET_ONE_2D, _MIXED_GRAM, _MIXED_SWEEP, _ZDT_GRAM, _ZDT_SWEEP,
          _BANDIT_SWEEP_2D, _QEI_KSTAR, _QEI_KQQ, _SET_PE_KSTAR, _SET_PE_KQQ, _STACK_GRAM,
          _STACK_SWEEP)
_CASES = [
    (_GRAM, dict(b=5, n=1024, m=1024, dc=20, ds=0, same=True, valid=1000)),
    (_CROSS, dict(b=1, n=50, m=1024, dc=20, ds=0, valid=1000)),
    (_PE_CROSS, dict(b=1, n=1024, m=1024, dc=20, ds=0, valid=1000)),
    ("gram B=1 N=M=1024 (1000 valid) Dc=20", dict(b=1, n=1024, m=1024, dc=20, ds=0, same=True,
                                                   valid=1000)),
    ("ragged B=1 N=1 M=37 Dc=20", dict(b=1, n=1, m=37, dc=20, ds=0)),
    ("ragged B=5 N=300 M=1000 Dc=20 Ds=2", dict(b=5, n=300, m=1000, dc=20, ds=2)),
    ("mixed B=2 N=M=300 Dc=8 Ds=4 masked dims, batched x1",
     dict(b=2, n=300, m=300, dc=8, ds=4, masked_dims=True, batched_x1=True)),
    ("categorical B=2 N=M=200 Dc=0 Ds=5 gram (190 valid)",
     dict(b=2, n=200, m=200, dc=0, ds=5, same=True, valid=190)),
    ("wide B=2 N=M=256 Dc=80", dict(b=2, n=256, m=256, dc=80, ds=0)),
    ("wide gram B=2 N=M=256 Dc=80 (250 valid)",
     dict(b=2, n=256, m=256, dc=80, ds=0, same=True, valid=250)),
] + _SPARSE_CASES + _MO_CASES + _FLUSH_CASES + _REGRET_CASES + _SURFACE_CASES
# The cross kernels of both paths: the exact path's, B=1 against the 1024
# data rows (1000 real): one pick's predict, the sweep's pool and the PE
# conditioning; and the sparse path's. Every tile shape is checked and timed
# at each (matern52_force_tile).
_TILE_CASES = [
    (f"cross B=1 N={q} M=1024 (1000 valid) Dc=20", dict(b=1, n=q, m=1024, dc=20, ds=0, valid=1000))
    for q in (1, 50, 1024)
] + (_SPARSE_CROSS_CASES + _MO_CROSS_CASES + _FLUSH_CROSS_CASES + _REGRET_CROSS_CASES
     + _SURFACE_CROSS_CASES)
_TILE_KINDS = {0: "big", 1: "tiny"}

_REPLACES = (
    "JAX package models/kernels.py:85 matern52_ard (an XLA fusion on the TPU; its Pallas "
    "kernel ops/matern_pallas.py was removed in d3abbcb) with models/gp.py:189 _masked_gram"
)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, launches: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``launches`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events. The replay issues
    the kernels without the host, so short launches are not timed by the
    host's enqueue rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (launches * replays)
    del graph
    return ms


def _host_us(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn`` (its enqueue, no synchronisation)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - start
    torch.cuda.synchronize()
    return host / calls * 1e6


def _rel_err(got, want) -> float:
    scale = float(torch.max(torch.abs(want))) if want.numel() else 1.0
    err = float(torch.max(torch.abs(got - want))) if want.numel() else 0.0
    return err / max(scale, 1e-30), err


def _case(gen, b, n, m, dc, ds, *, same=False, masked_dims=False, batched_x1=False, valid=None,
          valid1=None, jitter=None, studies=None, step=0, step1=0):
    """Random kernel inputs on the card: (args, masks). A Gram (``same``) with
    ``valid`` rows gets one row mask on both sides and a noise diagonal (the
    constant ``jitter`` where given, as Kmm); a cross case with ``valid``
    masks its second side, as predict does, and with ``valid1`` its first
    side too, as Knm does. With ``studies`` S (a flush) every input has one
    block per study, the b members are S groups of b / S, and study s has
    ``valid + step * s`` valid rows (``valid1 + step1 * s`` on the first
    side)."""
    dev = "cuda"
    lead = () if studies is None else (studies,)
    x1 = torch.rand(((b,) if batched_x1 else lead) + (n, dc), generator=gen, device=dev)
    x2 = x1 if same else torch.rand(lead + (m, dc), generator=gen, device=dev)
    z1 = torch.randint(0, 3, lead + (n, ds), generator=gen, device=dev, dtype=torch.int32)
    z2 = z1 if same else torch.randint(0, 3, lead + (m, ds), generator=gen, device=dev,
                                       dtype=torch.int32)

    def rows(count, first, per_study):
        if studies is None:
            return torch.arange(count, device=dev) < first
        limit = first + per_study * torch.arange(studies, device=dev)
        return torch.arange(count, device=dev)[None, :] < limit[:, None]

    amp = 0.5 + torch.rand((b,), generator=gen, device=dev)
    inv = 1.0 / (0.3 + 1.7 * torch.rand((b, dc), generator=gen, device=dev))
    inv_sq = 1.0 / (0.3 + 1.7 * torch.rand((b, ds), generator=gen, device=dev)) ** 2
    if masked_dims:
        inv[:, dc // 2:] = 0.0
        inv_sq[:, ds // 2:] = 0.0
    args = (x1, z1, x2, z2, amp, inv.contiguous(), inv_sq.contiguous())
    masks = (None, None, None)
    if valid is not None and same:
        mask = rows(n, valid, step)
        if jitter is not None:
            diag = torch.full((b,), jitter, device=dev)
        else:
            noise = 0.05 + 0.1 * torch.rand((b,), generator=gen, device=dev)
            diag = noise * noise + 1e-5
        masks = (mask, mask, diag)
    elif valid is not None:
        mask1 = None if valid1 is None else rows(n, valid1, step1)
        masks = (mask1, rows(m, valid, step), None)
    return args, masks


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if t is not None and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
    return total


def _param_term_sums(kernels, grad, args, masks):
    """Per entry of K2's parameter gradients, the sum of its terms'
    magnitudes: the plain version at |grad|. Each term is grad times a factor
    of one sign (amplitude > 0, Matern > 0, inverse scales >= 0), so at |grad|
    the terms add up without cancelling."""
    return [torch.abs(g) for g in
            kernels.matern52_ard_bwd_plain(torch.abs(grad), *args, *masks[:2])[:3]]


# K2's modes in _check_case: parameters and both sides' features (the
# parameter kernel on all ordered pairs, then the feature kernel), the
# feature kernel alone (parameters held constant), and for a Gram the
# parameters alone (the symmetric path).
_K2_RUNS = {"features": dict(need_x1=True, need_x2=True),
            "features only": dict(need_params=False, need_x1=True, need_x2=True),
            "symmetric": dict()}


def _check_case(kernels, gen, name, args, masks, *, same, dc, verbose=True):
    """K1 and K2 against their plain versions at one input; raises on a
    disagreement. Each K2 mode runs twice and must give the same floats both
    times, and the feature kernel the same floats with and without the
    parameters. Returns (incoming gradient, K1 max abs err, K2 max abs err)."""
    say = print if verbose else (lambda *_: None)
    got = kernels.matern52_ard_fwd_cuda(*args, *masks)
    want = kernels.matern52_ard_fwd_plain(*args, *masks)
    torch.cuda.synchronize()
    rel, fwd_err = _rel_err(got, want)
    tol = _FWD_WIDE_TOL if dc > 64 else _FWD_TOL
    say(f"K1 {name}: max_abs_err={fwd_err:.3e} max_rel_err={rel:.3e} (tol {tol})")
    if not rel <= tol:
        raise AssertionError(f"K1 disagrees with its plain version at {name}")
    if same and not torch.equal(got, got.transpose(-1, -2)):
        raise AssertionError(f"K1's Gram triangles differ at {name}")
    grad = torch.randn(got.shape, generator=gen, device="cuda")
    want_g = kernels.matern52_ard_bwd_plain(grad, *args, *masks[:2])
    term_sums = _param_term_sums(kernels, grad, args, masks)
    bwd_err = 0.0
    outputs = {}
    for mode, run in _K2_RUNS.items():
        if mode == "symmetric" and not same:
            continue
        got_g = kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2], **run)
        again = kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2], **run)
        torch.cuda.synchronize()
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got_g, again)):
            raise AssertionError(f"K2 ({mode}) is not deterministic at {name}")
        outputs[mode] = got_g
        worst_rel = 0.0
        for i, (label, a, b) in enumerate(
                zip(("amp", "inv_cont", "inv_sq_cat", "x1", "x2"), got_g, want_g)):
            if a is None or b.numel() == 0:
                continue
            if i < 3:
                e = float(torch.max(torch.abs(a - b)))
                r = float(torch.max(torch.abs(a - b) / torch.clamp(term_sums[i], min=1e-30)))
                measure = "rel to sum|terms|"
            else:
                r, e = _rel_err(a, b)
                measure = "rel"
            worst_rel, bwd_err = max(worst_rel, r), max(bwd_err, e)
            say(f"K2 {name} {mode} d/{label}: "
                  f"max_abs_err={e:.3e} max_{measure}_err={r:.3e} (tol {_BWD_TOL})")
        if not worst_rel <= _BWD_TOL:
            raise AssertionError(f"K2 ({mode}) disagrees with its plain version at {name}")
    alone, full = outputs["features only"], outputs["features"]
    if any(g is not None for g in alone[:3]) or not all(
            torch.equal(a, b) for a, b in zip(full[3:], alone[3:])):
        raise AssertionError(f"K2's feature kernel differs with and without the parameters at "
                             f"{name}")
    return grad, fwd_err, bwd_err


def _check_kmm_diagonal(kernels, name, args, masks, valid):
    """Kmm's valid diagonal is bitwise amp² + jitter (the reference replaces
    the diagonal with it), as on the CPU; its padded diagonal is 1."""
    amp, jitter = args[4], masks[2]
    diag = torch.diagonal(kernels.matern52_ard_fwd_cuda(*args, *masks), dim1=-2, dim2=-1)
    cpu = kernels.matern52_ard_fwd_plain(*(a.cpu() for a in args), *(m.cpu() for m in masks))
    want = (amp * amp + jitter)[:, None].expand(-1, valid)
    if not (torch.equal(diag[:, :valid], want) and bool(torch.all(diag[:, valid:] == 1.0))
            and torch.equal(diag.cpu(), torch.diagonal(cpu, dim1=-2, dim2=-1))):
        raise AssertionError(f"K1's Kmm diagonal is not amp^2 + jitter bit for bit at {name}")
    print(f"K1 {name}: diagonal bitwise amp^2 + {float(jitter[0]):g} on {valid} valid slots, "
          f"1 on the padded ones, equal to the CPU's")


def check_kernels(kernels, lib):
    """Phase 2: K1/K2 against their plain versions; returns the inputs of the
    shapes that phase 3 times."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {}
    for name, spec in _CASES:
        args, masks = _case(gen, **spec)
        same = spec.get("same", False)
        tiles = [f"K1 {_occupancy(lib, 0, args, int(same))}",
                 f"K2 with feature gradients {_occupancy(lib, 1, args, 0)}"]
        if same:
            tiles.append(f"K2 symmetric {_occupancy(lib, 1, args, 1)}")
        print(f"tiles {name}: " + "; ".join(tiles))
        grad, fwd_err, bwd_err = _check_case(kernels, gen, name, args, masks, same=same,
                                             dc=spec["dc"])
        if spec.get("jitter") is not None:
            _check_kmm_diagonal(kernels, name, args, masks, spec["valid"])
        if name in _TIMED:
            timed[name] = (args, masks, grad, fwd_err, bwd_err)
    print("K2 repeated calls bit-identical in every mode at every shape; Gram triangles "
          "bit-identical")
    return timed


def compare_tiles(kernels, lib):
    """Phase 2, last part: each tile shape forced in turn at each cross shape
    of the main path, held to the plain version and timed by device time.
    Returns {shape: {"chosen": tile, tile: {"fwd_ms", "bwd_ms"}}}."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for shape, spec in _TILE_CASES:
        args, masks = _case(gen, **spec)
        row = {"chosen": _occupancy(lib, 0, args, 0)}
        for kind, tile in _TILE_KINDS.items():
            status = lib.matern52_force_tile(kind)
            if status:
                raise RuntimeError(f"matern52_force_tile({kind}): CUDA error {status}")
            try:
                grad, _, _ = _check_case(kernels, gen, f"{shape} [{tile} tile forced]", args,
                                         masks, same=False, dc=20)
                row[tile] = dict(
                    occupancy=_occupancy(lib, 0, args, 0),
                    fwd_ms=_device_ms(lambda: kernels.matern52_ard_fwd_cuda(*args, *masks)),
                    bwd_ms=_device_ms(
                        lambda: kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2])),
                )
            finally:
                lib.matern52_force_tile(-1)
            print(f"tile {tile} at {shape}: {row[tile]['occupancy']}; device K1 "
                  f"{row[tile]['fwd_ms']:.5f} ms/launch, K2 {row[tile]['bwd_ms']:.5f} ms/launch")
        print(f"tile chosen at {shape}: {row['chosen']}")
        rows[shape] = row
    return rows


def _case_at(gen, shape, device="cuda"):
    """Random kernel inputs at a recorded launch layout (kernels.LaunchShape):
    each input with the leading axis the launch gave it, one storage and mask
    on both sides of a Gram, and ragged row masks (block s of a mask over r
    rows has max(r - 1 - s, 1) valid)."""
    def lead(size):
        return (size,) if size else ()

    def codes(size, rows):
        return torch.randint(0, 3, lead(size) + (rows, shape.ds), generator=gen, device=device,
                             dtype=torch.int32)

    def mask(size, rows):
        if size is None:
            return None
        valid = torch.clamp(rows - 1 - torch.arange(max(size, 1), device=device), min=1)
        out = torch.arange(rows, device=device)[None, :] < valid[:, None]
        return out if size else out[0]

    x1 = torch.rand(lead(shape.x1) + (shape.n, shape.dc), generator=gen, device=device)
    z1 = codes(shape.z1, shape.n)
    mask1 = mask(shape.mask1, shape.n)
    if shape.symmetric:
        x2, z2, mask2 = x1, z1, mask1
    else:
        x2 = torch.rand(lead(shape.x2) + (shape.m, shape.dc), generator=gen, device=device)
        z2, mask2 = codes(shape.z2, shape.m), mask(shape.mask2, shape.m)
    b = shape.batch
    amp = 0.5 + torch.rand((b,), generator=gen, device=device)
    inv = 1.0 / (0.3 + 1.7 * torch.rand((b, shape.dc), generator=gen, device=device))
    inv_sq = 1.0 / (0.3 + 1.7 * torch.rand((b, shape.ds), generator=gen, device=device)) ** 2
    diag = None
    if shape.diag:
        noise = 0.05 + 0.1 * torch.rand((b,), generator=gen, device=device)
        diag = noise * noise + 1e-5
    return (x1, z1, x2, z2, amp, inv, inv_sq), (mask1, mask2, diag)


def check_recorded_shapes(kernels, lib, recorded, label: str) -> dict:
    """K1 and K2 against their plain versions at every launch layout a run
    recorded, at the tile the shape chooses and with each tile forced in
    turn; raises on a disagreement. Returns the counts and worst errors."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = sorted({shape for _, shape in recorded}, key=repr)
    worst = dict(layouts=len(shapes), launch_kinds=len(recorded), k1_max_abs_err=0.0,
                 k2_max_abs_err=0.0)
    for shape in shapes:
        args, masks = _case_at(gen, shape)
        for kind in (-1, *_TILE_KINDS):
            status = lib.matern52_force_tile(kind)
            if status:
                raise RuntimeError(f"matern52_force_tile({kind}): CUDA error {status}")
            try:
                _, fwd_err, bwd_err = _check_case(
                    kernels, gen, f"{label} {shape} tile {kind}", args, masks,
                    same=bool(shape.symmetric), dc=shape.dc, verbose=False)
            finally:
                lib.matern52_force_tile(-1)
            worst["k1_max_abs_err"] = max(worst["k1_max_abs_err"], fwd_err)
            worst["k2_max_abs_err"] = max(worst["k2_max_abs_err"], bwd_err)
        print(f"{label} layout held to the plain version at every tile: {shape}")
    print(f"{label}: K1/K2 within tolerance of their plain versions at all {len(shapes)} "
          f"recorded launch layouts ({len(recorded)} (kernel, layout) pairs), each tile "
          f"forced in turn; worst abs err K1 {worst['k1_max_abs_err']:.3e}, K2 "
          f"{worst['k2_max_abs_err']:.3e}")
    return worst


def _bound(nbytes: int, ops: int):
    t_bytes = nbytes / _HBM_BYTES_PER_S * 1e3
    t_ops = ops / _FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _work(args, masks, grad):
    """(bytes, operations) that K1 and K2 need at these inputs: each input
    read once, each output written once; operations on the distinct pairs
    (N(N+1)/2 per batch member for a Gram). The rows are scaled by the
    inverse length scales once (one multiply per row and dim); then each
    (pair, dim) is a subtract and an FMA forward (3 operations), and a
    subtract, a square, an add and an FMA backward (5); each categorical dim
    is a compare and a select-add forward (2), 4 backward; the Matern, the
    amplitude and the masks cost ~12 per pair forward, ~17 backward."""
    x1, z1, x2, z2, amp, inv, inv_sq = args
    b, n, m, dc, ds = amp.shape[0], x1.shape[-2], x2.shape[-2], inv.shape[1], inv_sq.shape[1]
    same = x2 is x1
    pairs = b * (n * (n + 1) // 2 if same else n * m)
    prescale = b * (n + (0 if same else m)) * dc
    fwd_bytes = _nbytes(args + masks) + 4 * b * n * m
    fwd_ops = pairs * (3 * dc + 2 * ds + 12) + prescale
    bwd_bytes = _nbytes(args + masks[:2] + (grad,)) + 4 * b * (1 + dc + ds)
    bwd_ops = pairs * (5 * dc + 4 * ds + 17) + prescale
    return (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)


def _library_fn(kernels, args, masks):
    """One PyTorch call for the distance with exact differences (torch.cdist
    without the matmul expansion), then the elementwise Matern and masks."""
    x1, z1, x2, z2, amp, inv, inv_sq = args
    # A flush's grouped rows and masks are repeated to one block per member
    # first: torch.cdist has no group axis.
    b = amp.shape[0]
    s = kernels.group_count(b, x1, z1, x2, z2, *masks[:2], base_dims=(2, 2, 2, 2, 1, 1))
    x1m = kernels.per_member(x1, s, b, 2)
    x2m = x1m if x2 is x1 else kernels.per_member(x2, s, b, 2)
    masks = tuple(kernels.per_member(m, s, b, 1) for m in masks[:2]) + masks[2:]

    def library():
        a = x1m * inv[:, None, :]
        c = a if x2 is x1 else x2m * inv[:, None, :]
        d = torch.cdist(a, c, compute_mode="donot_use_mm_for_euclid_dist")
        return kernels.apply_masks((amp * amp)[:, None, None] * kernels.matern52(d * d), *masks)

    return library


def _occupancy(lib, kernel: int, args, sym: int) -> str:
    """The tile shape these inputs get (``sym``: the symmetric Gram path) and
    its resident blocks per SM."""
    x1, z1, x2, z2, amp = args[:5]
    tn, tm, threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    blocks = lib.matern52_occupancy(kernel, amp.shape[0], x1.shape[-2], x2.shape[-2], sym,
                                    ctypes.byref(tn), ctypes.byref(tm), ctypes.byref(threads))
    if blocks <= 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-blocks}")
    return (f"{tn.value}x{tm.value} tile, {threads.value} threads, {blocks} blocks/SM "
            f"({blocks * threads.value // 32} warps)")


def time_kernels(kernels, timed):
    """Phase 3: device ms, host us, plain ms, library ms and bound per shape."""
    from vizier_tpu_torch.ops import native

    rows = {}
    for shape, (args, masks, grad, fwd_err, bwd_err) in timed.items():
        (fb, fo), (bb, bo) = _work(args, masks, grad)
        fwd = lambda: kernels.matern52_ard_fwd_cuda(*args, *masks)  # noqa: E731
        bwd = lambda: kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2])  # noqa: E731
        rows[shape] = {
            "fwd": dict(
                ms=_device_ms(fwd), host_us=_host_us(fwd),
                plain_ms=_device_ms(lambda: kernels.matern52_ard_fwd_plain(*args, *masks), 3, 2),
                library_ms=_device_ms(_library_fn(kernels, args, masks)),
                bound=_bound(fb, fo), max_abs_err=fwd_err),
            "bwd": dict(
                ms=_device_ms(bwd), host_us=_host_us(bwd),
                plain_ms=_device_ms(
                    lambda: kernels.matern52_ard_bwd_plain(grad, *args, *masks[:2]), 3, 2),
                library_ms=None, bound=_bound(bb, bo), max_abs_err=bwd_err),
        }
        for kernel, key in enumerate(("fwd", "bwd")):
            r = rows[shape][key]
            r["occupancy"] = _occupancy(native.library(), kernel, args, int(args[2] is args[0]))
            print(f"matern52_ard_{key} [{shape}]: {r['occupancy']}")
            print(f"matern52_ard_{key} [{shape}]: device {r['ms']:.5f} ms/launch, host "
                  f"{r['host_us']:.1f} us/call, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 5)}"
                  f" ms, bound {r['bound'][0]:.5f} ms by {r['bound'][1]} "
                  f"({r['ms'] / r['bound'][0]:.1f}x)")
    return rows


def _load_baseline(path: str):
    """Commit a3a3a6f's matern52.cu, built into a temporary directory. The
    binding below is that source's interface (no masks, diagonal or symmetric
    flag); a source with another interface needs its own."""
    from vizier_tpu_torch.ops import native

    build_dir = pathlib.Path(tempfile.mkdtemp(prefix="matern52_baseline_"))
    lib = native.build(pathlib.Path(path).resolve(), build_dir)
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.matern52_bwd_num_blocks.argtypes = [i, i]
    lib.matern52_bwd_num_blocks.restype = i
    lib.matern52_ard_fwd.argtypes = [p] * 7 + [l, l] + [i] * 5 + [p, p]
    lib.matern52_ard_fwd.restype = i
    lib.matern52_ard_bwd.argtypes = [p] * 8 + [l, l] + [i] * 5 + [p] * 6
    lib.matern52_ard_bwd.restype = i
    print(f"baseline {path}: built in {lib.build_seconds:.1f} s")
    return lib


def time_baseline(kernels, lib, timed):
    """The earlier kernels at the timed shapes, by the same method: the kernel
    alone, and (forward) with the masking passes the earlier callers ran
    around it (torch.where, diag_embed and add)."""
    rows = {}
    for shape, (args, masks, grad, _, _) in timed.items():
        x1, z1, x2, z2, amp, inv, inv_sq = args
        if _grouped(args, masks):
            continue  # that source has no group axis
        b, n, m, dc, ds = amp.shape[0], x1.shape[-2], x2.shape[-2], inv.shape[1], inv_sq.shape[1]
        s1 = n * dc if x1.dim() == 3 else 0
        s2 = m * dc if x2.dim() == 3 else 0
        ptrs = [t.data_ptr() for t in args]
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

        def fwd():
            out = torch.empty((b, n, m), device="cuda")
            status = lib.matern52_ard_fwd(*ptrs, s1, s2, b, n, m, dc, ds, out.data_ptr(), stream())
            if status:
                raise RuntimeError(f"baseline fwd: CUDA error {status}")
            return out

        def bwd():
            g = lib.matern52_bwd_num_blocks(n, m)
            grads = torch.empty((b, 1 + dc + ds), device="cuda")
            partials = torch.empty((b, max(g, 1), 1 + dc + ds), device="cuda")
            status = lib.matern52_ard_bwd(grad.data_ptr(), *ptrs, s1, s2, b, n, m, dc, ds,
                                          grads.data_ptr(), partials.data_ptr(), None, None,
                                          None, stream())
            if status:
                raise RuntimeError(f"baseline bwd: CUDA error {status}")
            return grads

        rel, err = _rel_err(fwd(), kernels.matern52_ard_fwd_plain(*args))
        if not rel <= _FWD_TOL:
            raise AssertionError(f"baseline K1 disagrees with the plain version at {shape}")
        rows[shape] = dict(
            fwd_ms=_device_ms(fwd),
            fwd_masked_ms=_device_ms(lambda: kernels.apply_masks(fwd(), *masks)),
            bwd_ms=_device_ms(bwd),
        )
        print(f"baseline [{shape}]: K1 {rows[shape]['fwd_ms']:.5f} ms/launch, K1 + masking "
              f"{rows[shape]['fwd_masked_ms']:.5f} ms, K2 {rows[shape]['bwd_ms']:.5f} ms/launch "
              f"(device time; K1 max_abs_err {err:.2e} vs plain)")
    return rows


def _grouped(args, masks) -> bool:
    """Whether a case holds a flush's per-study blocks (a group axis)."""
    x1, z1, x2, z2 = args[:4]
    return (z1.dim() == 3 or (x2.dim() == 3 and x2 is not x1 and x1.dim() == 3)
            or any(m is not None and m.dim() == 2 for m in masks[:2]))


def _load_previous(path: str):
    """The kernels of commit 997e03e (shared inputs only: no group strides),
    built into a temporary directory and bound with that source's interface."""
    from vizier_tpu_torch.ops import native

    build_dir = pathlib.Path(tempfile.mkdtemp(prefix="matern52_previous_"))
    lib = native.build(pathlib.Path(path).resolve(), build_dir)
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.matern52_bwd_num_blocks.argtypes = [i] * 4
    lib.matern52_bwd_num_blocks.restype = i
    lib.matern52_ard_fwd.argtypes = [p] * 10 + [l, l] + [i] * 6 + [p, p]
    lib.matern52_ard_fwd.restype = i
    lib.matern52_ard_bwd.argtypes = [p] * 10 + [l, l] + [i] * 6 + [p] * 6
    lib.matern52_ard_bwd.restype = i
    print(f"previous kernels {path}: built in {lib.build_seconds:.1f} s")
    return lib


def check_previous_bit_identity(kernels, lib):
    """Every ungrouped case of phase 2 through the previous source's kernels
    and today's: K1's output and K2's parameter gradients must be the same
    floats, bit for bit (the group strides are 0 and the group size 1), with
    and without the feature gradients. The feature gradients sum their pairs
    in another order since the feature kernel's redesign, so they are held to
    the previous source's within _BWD_TOL of their largest entry."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    checked, worst = 0, 0.0
    for name, spec in _CASES:
        args, masks = _case(gen, **spec)
        if _grouped(args, masks):
            continue
        x1, z1, x2, z2, amp, inv, inv_sq = args
        b, n, m, dc, ds = amp.shape[0], x1.shape[-2], x2.shape[-2], inv.shape[1], inv_sq.shape[1]
        s1 = n * dc if x1.dim() == 3 else 0
        s2 = m * dc if x2.dim() == 3 else 0
        sym = int(x2 is x1)
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((b, n, m), device="cuda")
        status = lib.matern52_ard_fwd(*(ptr(t) for t in args + masks), s1, s2, b, n, m, dc, ds,
                                      sym, out.data_ptr(), stream)
        if status:
            raise RuntimeError(f"previous K1: CUDA error {status}")
        now = kernels.matern52_ard_fwd_cuda(*args, *masks)
        grad = torch.randn((b, n, m), generator=gen, device="cuda")

        def previous_bwd(features: bool):
            """The previous source's K2: (grads, gx1, gx2); with features on
            all ordered pairs through its [B, N, M] scratch."""
            tiles = 0 if features else sym
            blocks = lib.matern52_bwd_num_blocks(b, n, m, tiles)
            grads = torch.empty((b, 1 + dc + ds), device="cuda")
            partials = torch.empty((b, max(blocks, 1), 1 + dc + ds), device="cuda")
            w, gx1, gx2 = ((torch.empty((b, n, m), device="cuda"), torch.empty_like(x1),
                            torch.empty_like(x2)) if features else (None, None, None))
            status = lib.matern52_ard_bwd(grad.data_ptr(), *(ptr(t) for t in args + masks[:2]),
                                          s1, s2, b, n, m, dc, ds, tiles, grads.data_ptr(),
                                          partials.data_ptr(), ptr(w), ptr(gx1), ptr(gx2), stream)
            if status:
                raise RuntimeError(f"previous K2: CUDA error {status}")
            return grads, gx1, gx2

        def params_equal(grads, now_g):
            return (torch.equal(grads[:, 0], now_g[0])
                    and torch.equal(grads[:, 1 : 1 + dc], now_g[1])
                    and torch.equal(grads[:, 1 + dc:], now_g[2]))

        grads, _, _ = previous_bwd(False)
        same = torch.equal(out, now) and params_equal(
            grads, kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2]))
        feature_errs = []
        if dc > 0:
            grads, gx1, gx2 = previous_bwd(True)
            now_g = kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2], need_x1=True,
                                                  need_x2=True)
            same = same and params_equal(grads, now_g)
            feature_errs = [_rel_err(now_g[3], gx1)[0], _rel_err(now_g[4], gx2)[0]]
            worst = max(worst, *feature_errs)
        print(f"previous vs today's kernels [{name}]: K1 and K2's parameters "
              f"{'bit-identical' if same else 'DIFFERENT'}; feature gradients' max rel err "
              f"{[f'{e:.3e}' for e in feature_errs]} (tol {_BWD_TOL})")
        if not same:
            raise AssertionError(f"today's shared-input launch differs from 997e03e's at {name}")
        if not all(e <= _BWD_TOL for e in feature_errs):
            raise AssertionError(f"today's feature gradients disagree with 997e03e's at {name}")
        checked += 1
    print(f"today's shared-input K1 and K2 parameter launches bit-identical to 997e03e's at "
          f"{checked} cases, with and without features; feature gradients within {_BWD_TOL} "
          f"(worst {worst:.3e})")


def _bench_trials(vz, num_trials: int, dim: int):
    """bench.py's synthetic study: uniform x, y = -|x - 0.5|^2 + 0.1 noise."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(num_trials, dim)).astype(np.float32)
    y_raw = -np.sum((x - 0.5) ** 2, axis=1) + 0.1 * rng.normal(size=num_trials)
    trials = []
    for i in range(num_trials):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[i, j]) for j in range(dim)})
        t.complete(vz.Measurement(metrics={"obj": float(y_raw[i])}))
        trials.append(t)
    return trials


_DIM, _NUM_TRIALS, _COUNT = 20, 1000, 5
# suggest(count=5) requests of each designer path (phases 4-6) before its
# profiled one: one each. The exact path's was two before the algorithms
# phase joined the script (its warm train runs in serving-exact's second
# round), the sparse and multi-objective paths' two before the
# service-reliability phase did (their profiled request is their warm one).
_REQUESTS = 1


def _bench_problem(vz):
    problem = vz.ProblemStatement()
    for j in range(_DIM):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE)
    )
    return problem


def _bench_objective(values: np.ndarray) -> dict:
    return {"obj": float(-np.sum((values - 0.5) ** 2))}


def _serve(vz, kernels, designer, check_state, kind: str, requests: int = _REQUESTS, trials=None,
           evaluate=_bench_objective, split_train: bool = False):
    """``requests`` suggest(count=5) requests on a study (bench.py's unless
    ``trials`` is given), each request's picks completed through
    ``evaluate`` before the next; ``check_state(request)`` checks the trained
    state after each. Returns (latencies in s, that path's launches by mode,
    peak device memory above what was allocated before the path, the
    completed picks), with the launch counts and the peak reset just before
    the first request. With ``split_train`` (the multi-objective path) each
    request's ARD train runs first (``_train_states_me``, which the suggest
    then reuses) so its share is printed; a single-objective suggest trains
    inside its compute-IR program."""
    trials = _bench_trials(vz, _NUM_TRIALS, _DIM) if trials is None else trials
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    designer.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    latencies, picks, next_id = [], [], len(trials) + 1
    for request in range(requests):
        start = time.perf_counter()
        if split_train:
            designer._train_states_me()
            torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        suggestions = designer.suggest(count=_COUNT)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - start)
        if len(suggestions) != _COUNT:
            raise AssertionError(f"{kind} request {request}: {len(suggestions)} suggestions")
        check_state(request)
        completed = []
        for s in suggestions:
            values = np.array([s.parameters.get_value(f"x{j}") for j in range(_DIM)], float)
            if not (np.all(np.isfinite(values)) and np.all((values >= 0.0) & (values <= 1.0))):
                raise AssertionError(f"{kind} request {request}: suggestion out of bounds {values}")
            t = s.to_trial(next_id)
            next_id += 1
            t.complete(vz.Measurement(metrics=evaluate(values)))
            completed.append(t)
        ns = suggestions[0].metadata.ns("gp_ucb_pe")
        train = f"ARD train {train_s * 1e3:.1f} ms" if split_train else "ARD train inside"
        print(f"{kind} request {request}: suggest(count={_COUNT}) {latencies[-1] * 1e3:.1f} ms "
              f"({train}), first acquisition {ns['acquisition']} "
              f"(use_ucb {ns['use_ucb']}, mean {ns.ns('prediction_in_warped_y_space')['mean']})")
        designer.update(vz.CompletedTrials(completed), vz.ActiveTrials())
        picks.extend(completed)
    torch.cuda.synchronize()
    by_mode = {name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
    return latencies, by_mode, torch.cuda.max_memory_allocated() - before, picks


# The JAX package's phase timers (utils/profiler.timeit) of the GP designers'
# single-objective suggest: the DEFAULT times its ARD train, its sweeps and
# its decode; GAUSSIAN_PROCESS_BANDIT times its encode as well.
_UCB_PE_PHASES = ("train_gp", "acquisition_optimizer", "best_candidates_to_trials")
_BANDIT_PHASES = ("convert_trials",) + _UCB_PE_PHASES


def _phase_timers(events, required, label: str) -> dict:
    """{phase: [ms, ...]} of the events a request recorded; raises unless
    each required phase is there."""
    from vizier_tpu_torch.utils import profiler

    latencies = {name: [d.total_seconds() * 1e3 for d in durations]
                 for name, durations in profiler.get_latencies_dict(events).items()}
    print(f"{label} phase timers (ms): "
          f"{ {name: [round(ms, 1) for ms in v] for name, v in latencies.items()} }")
    missing = [name for name in required if name not in latencies]
    if missing:
        raise AssertionError(f"{label}: phase timers {missing} missing from {sorted(latencies)}")
    return latencies


def _require_modes(by_mode, required, path: str):
    for name, mode in required:
        if by_mode[name][mode] <= 0:
            raise AssertionError(f"{name} was not launched in its {mode} mode on the {path}")


def run_main_path(vz, gp_ucb_pe, kernels, gp_lib, multitask_gp):
    """Phase 4: ``_REQUESTS`` suggest(count=5) at 1000 trials x 20-D."""
    designer = gp_ucb_pe.VizierGPUCBPEBandit(_bench_problem(vz), rng_seed=0)
    states = []

    def check_state(request):
        (state,) = designer._cached_states[0]
        states.append(state)
        if not bool(torch.isfinite(state.chol).all()):
            raise AssertionError(f"request {request}: non-finite Cholesky factor")

    from vizier_tpu_torch.utils import profiler

    with profiler.collect_events() as events:
        latencies, by_mode, peak, _ = _serve(vz, kernels, designer, check_state, "exact")
    timers = _phase_timers(events, _UCB_PE_PHASES, "exact request")
    launches = {name: sum(modes.values()) for name, modes in by_mode.items()}
    print(f"main path: latencies_ms={[round(t * 1e3, 1) for t in latencies]} "
          f"peak_memory_bytes={peak} launches={launches} by_mode={by_mode}")
    for name, count_ in launches.items():
        if count_ <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    # _masked_gram goes through K1's Gram mode (and K2's), predict through
    # K1's masked cross mode.
    _require_modes(by_mode, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                             ("matern52_ard_bwd", "gram")), "main path")
    _check_posterior_against_cpu("exact", states[-1], kernels, gp_lib, multitask_gp,
                                 hold_trained=True)
    return designer, launches, by_mode, timers


def run_sparse_path(vz, gp_ucb_pe, gp_bandit, kernels, sparse_gp, surrogates):
    """Phase 5: the service-configured DEFAULT (``SurrogateConfig()``, warm
    ARD with one warm restart) serves ``_REQUESTS`` suggest(count=5) on the
    same study, which is past the 512-trial threshold: one cold sparse train
    (the profiled request after it is the warm one). Then
    GAUSSIAN_PROCESS_BANDIT's sparse suggest."""
    designer = gp_ucb_pe.VizierGPUCBPEBandit(
        _bench_problem(vz), rng_seed=0, surrogate=surrogates.SurrogateConfig(),
        use_warm_start_ard=True, warm_ard_restarts=1,
    )
    states = []

    def check_state(request):
        state = designer.sparse_inducing_state()
        states.append(state)
        chol, chol_b, _, _, _, info = state.model._factorize(state.params, state.sdata)
        finite = all(bool(torch.isfinite(t).all()) for t in (chol, chol_b, state.w, state.linv,
                                                             state.lb_linv))
        if not finite or bool(torch.any(info != 0)):
            raise AssertionError(f"sparse request {request}: failed or non-finite Cholesky")

    latencies, by_mode, peak, _ = _serve(vz, kernels, designer, check_state, "sparse")
    launches = {name: sum(modes.values()) for name, modes in by_mode.items()}
    print(f"sparse path: latencies_ms={[round(t * 1e3, 1) for t in latencies]} "
          f"peak_memory_bytes={peak} launches={launches} by_mode={by_mode} "
          f"surrogate_mode={designer.surrogate_mode} surrogate_counts={designer.surrogate_counts} "
          f"ard_train_counts={designer.ard_train_counts}")
    if (designer.surrogate_mode != "sparse"
            or designer.surrogate_counts["sparse_suggests"] != _REQUESTS):
        raise AssertionError(f"the sparse path did not serve {_REQUESTS} sparse suggests: "
                             f"{designer.surrogate_mode} {designer.surrogate_counts}")
    if designer.ard_train_counts != {"cold": 1, "warm": _REQUESTS - 1}:
        raise AssertionError(f"sparse path trains {designer.ard_train_counts}, "
                             f"expected one cold and the rest warm")
    # Kmm through K1's and K2's Gram modes, Knm through their cross modes,
    # k* through K1's cross mode.
    _require_modes(by_mode, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                             ("matern52_ard_bwd", "gram"), ("matern52_ard_bwd", "cross")),
                   "sparse path")
    _check_sparse_against_cpu(states[-1], kernels, sparse_gp)
    _profile_kcenter(sparse_gp, states[-1])

    bandit = gp_bandit.VizierGPBandit(
        _bench_problem(vz), rng_seed=0, surrogate=surrogates.SurrogateConfig(),
        use_warm_start_ard=True, warm_ard_restarts=1,
    )
    bandit.update(vz.CompletedTrials(_bench_trials(vz, _NUM_TRIALS, _DIM)))
    from vizier_tpu_torch.utils import profiler

    with profiler.collect_events() as events:
        start = time.perf_counter()
        (suggestion,) = bandit.suggest(count=1)
        torch.cuda.synchronize()
        bandit_s = time.perf_counter() - start
    timers = _phase_timers(
        events, _BANDIT_PHASES, "GAUSSIAN_PROCESS_BANDIT sparse suggest(count=1)")
    values = np.array([suggestion.parameters.get_value(f"x{j}") for j in range(_DIM)], float)
    if (bandit.surrogate_mode != "sparse" or bandit.surrogate_counts["sparse_suggests"] != 1
            or not np.all((values >= 0.0) & (values <= 1.0))):
        raise AssertionError(f"GAUSSIAN_PROCESS_BANDIT's sparse suggest failed: "
                             f"{bandit.surrogate_mode} {bandit.surrogate_counts} {values}")
    print(f"GAUSSIAN_PROCESS_BANDIT sparse suggest(count=1): {bandit_s * 1e3:.1f} ms, "
          f"kind {suggestion.metadata.ns('gp_bandit')['acquisition_kind']}, "
          f"ard_train_counts={bandit.ard_train_counts}")
    return designer, launches, by_mode, timers


def _dtlz2_experimenter():
    """The port's DTLZ2 with two objectives (both MINIMIZE) on [0, 1]^20
    (``benchmarks/experimenters/synthetic/multiobjective.py``, held to the
    JAX package's by a CPU test)."""
    from vizier_tpu_torch.benchmarks.experimenters.synthetic import multiobjective

    return multiobjective.MultiObjectiveExperimenter.dtlz("dtlz2", dimension=_DIM, num_objectives=2)


def _dtlz2_study(vz):
    """(problem, 1000 completed trials drawn uniformly from [0, 1]^20 with
    seed 0, evaluated by the port's DTLZ2 experimenter)."""
    exp = _dtlz2_experimenter()
    x = np.random.default_rng(0).uniform(size=(_NUM_TRIALS, _DIM))
    trials = [vz.Trial(id=i + 1, parameters={f"x{j}": float(x[i, j]) for j in range(_DIM)})
              for i in range(_NUM_TRIALS)]
    exp.evaluate(trials)
    return exp.problem_statement(), trials


def _study_checksum(trials, problem) -> str:
    """The first 16 hex digits of the SHA-256 of the trials' points and
    labels (float64, one row per trial): the same study gives the same
    checksum on any machine."""
    rows = [[t.parameters.get_value(f"x{j}") for j in range(_DIM)]
            + [t.final_measurement.metrics[m.name].value for m in problem.metric_information]
            for t in trials]
    return hashlib.sha256(np.asarray(rows, dtype=np.float64).tobytes()).hexdigest()[:16]


_GP_DATA_FIELDS = ("continuous", "categorical", "labels", "row_mask", "cont_dim_mask",
                   "cat_dim_mask")


def _cpu_data(data, gp_lib, multitask_gp):
    """A ``GPData`` or ``MultiTaskData`` copied to the CPU."""
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    if isinstance(data, multitask_gp.MultiTaskData):
        return multitask_gp.MultiTaskData(
            features_data=_cpu_data(data.features_data, gp_lib, multitask_gp),
            task_labels=cpu(data.task_labels), task_mask=cpu(data.task_mask))
    return gp_lib.GPData(**{f: cpu(getattr(data, f)) for f in _GP_DATA_FIELDS})


def _cpu_state(state, gp_lib, multitask_gp):
    """A copy of an exact or multi-task posterior, its factorization included,
    on the CPU."""
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    return dataclasses.replace(
        state, model=dataclasses.replace(state.model, device="cpu"),
        params={k: cpu(v) for k, v in state.params.items()},
        data=_cpu_data(state.data, gp_lib, multitask_gp),
        chol=cpu(state.chol), alpha=cpu(state.alpha), linv=cpu(state.linv))


def _unit_scale(params):
    """The parameters at unit scales, as the sparse check uses them:
    amplitude 1, length scales 1, noise 0.1 (task parameters kept)."""
    unit = {"amplitude": 1.0, "noise_stddev": 0.1, "continuous_length_scales": 1.0,
            "categorical_length_scales": 1.0}
    return {k: torch.full_like(v, unit[k]) if k in unit else v for k, v in params.items()}


def _float64_predict(state, query, kernels):
    """An exact posterior's mean and stddev ([B, Q]) factored and solved in
    float64 on the CPU, from the float32 Gram and k* of its parameters."""
    model, p, data = state.model, state.params, state.data
    gram = model._masked_gram(p, data).double()
    k_star = model._kernel(p, query, data.features(), data, row_mask2=data.row_mask).double()
    chol = torch.linalg.cholesky(gram)
    alpha = torch.cholesky_solve(data.labels.double().expand(gram.shape[0], -1)[..., None], chol)
    v = torch.linalg.solve_triangular(chol, k_star.transpose(-1, -2), upper=False)
    var = (p["amplitude"].double() ** 2)[:, None] - torch.sum(v * v, dim=-2)
    return (k_star @ alpha)[..., 0], torch.sqrt(torch.clamp(var, min=1e-12))


def _check_posterior_against_cpu(label, state, kernels, gp_lib, multitask_gp,
                                 hold_trained: bool = False, query=None):
    """A trained exact (one metric) or multi-task posterior's predictions at
    64 queries on the card against the port's plain CPU path, at the same
    parameters on both sides:
    - at unit-scale parameters (``_unit_scale``), factored on each side: the
      whole posterior, within _PREDICT_TOL;
    - at the trained parameters, with the card's factorization copied to the
      CPU and factored on each side, beside each side's distance to the
      float64 posterior (exact posteriors) and the Gram's condition number:
      factored on each side, within _PREDICT_TOL where ``hold_trained``
      (bench.py's noisy study), printed otherwise. A noiseless study trains
      the noise to its floor, where the condition number exceeds float32's
      reach: every float32 factorization, the CPU's too, is then off the
      float64 one by a few 1e-3, and the mean, a cancelling sum of large
      alpha terms, differs by ~1e-3 even from one factorization (PERF.md,
      the multi-objective finding).
    ``query`` (CPU ``MixedFeatures``) replaces the 64 points in [0, 1]^20."""
    if query is None:
        query = kernels.MixedFeatures(
            torch.rand((64, _DIM), generator=torch.Generator().manual_seed(1)),
            torch.zeros((64, 0), dtype=torch.int32))
    card_q = kernels.MixedFeatures(query.continuous.cuda(), query.categorical.cuda())
    cpu_q = query
    predict = lambda s, q: gp_lib.EnsemblePredictive(s).predict(q)  # noqa: E731
    cpu_state = _cpu_state(state, gp_lib, multitask_gp)
    cpu_model = cpu_state.model

    def diff(a, b):
        return max(float(torch.max(torch.abs(x.detach().cpu().double() - y.double())))
                   for x, y in zip(a, b))

    card = predict(state, card_q)
    same = diff(card, predict(cpu_state, cpu_q))
    unit = _unit_scale(state.params)
    unit_err = diff(predict(state.model.precompute_constrained(unit, state.data), card_q),
                    predict(cpu_model.precompute_constrained(
                        {k: v.cpu() for k, v in unit.items()}, cpu_state.data), cpu_q))
    refactored = predict(cpu_model.precompute_constrained(cpu_state.params, cpu_state.data), cpu_q)
    note = f"refactored on each side {diff(card, refactored):.3e}"
    if isinstance(state, gp_lib.GPState):
        truth = [t.mean(0) for t in _float64_predict(cpu_state, cpu_q, kernels)]
        eig = torch.linalg.eigvalsh(cpu_model._masked_gram(cpu_state.params, cpu_state.data)[0]
                                    .double())
        note += (f" (card to float64 {diff(card, truth):.3e}, CPU float32 to float64 "
                 f"{diff(refactored, truth):.3e}; Gram condition {float(eig[-1] / eig[0]):.3g})")
    trained_err = diff(card, refactored)
    held = f"(tol {_PREDICT_TOL})" if hold_trained else "(not held to a tolerance)"
    print(f"{label} predict on the card vs CPU plain path, max_abs_err over mean and stddev: "
          f"unit-scale parameters {unit_err:.3e} (tol {_PREDICT_TOL}); trained parameters "
          f"{held}: same factorization {same:.3e}, {note}")
    worst = max(unit_err, trained_err) if hold_trained else unit_err
    if not (worst <= _PREDICT_TOL and math.isfinite(same + unit_err + trained_err)):
        raise AssertionError(f"{label} predict on the card disagrees with the CPU plain path")


def _check_scores_against_cpu(designer, gp_ucb_pe, kernels, gp_lib, acquisitions, pareto,
                              multitask_gp, unit_scale):
    """The multi-objective pick's HV-scalarized UCB and PE scores at 256
    query points on the card against the port's CPU plain path, with the
    same directions, at the same factorizations of the completed and the
    all-points posteriors: the kernels, the predictions, the threshold, the
    floor, the scalarization and the penalty are computed on each side. At
    the trained parameters the differences are printed; at unit-scale
    parameters (``unit_scale``) they are held to _SCORE_TOL."""
    states, datas = designer._train_states_me()
    if unit_scale:
        states = [s.model.precompute_constrained(_unit_scale(s.params), s.data) for s in states]
    cfg = designer.config
    all_data = designer._all_points_data(_COUNT)
    pe_params, _, _ = gp_ucb_pe._pe_conditioning(states, all_data, cfg)
    states_all = [designer._model.precompute_constrained(p, all_data) for p in pe_params]
    weights = pareto.draw_directions(torch.Generator().manual_seed(3), cfg.num_scalarizations,
                                     len(datas))
    query = torch.rand((256, _DIM), generator=torch.Generator().manual_seed(4))

    def scores(states, states_all, all_data, datas, device):
        _, _, threshold = gp_ucb_pe._pe_conditioning(states, all_data, cfg)
        labels = torch.stack([d.labels for d in datas])
        ref = acquisitions.get_reference_point(labels, datas[0].row_mask)
        inv_w = 1.0 / torch.clamp(weights.to(device), min=1e-6)
        hv = (inv_w, ref, gp_ucb_pe._hv_floor(inv_w, ref, labels, datas[0].row_mask))
        trust = acquisitions.TrustRegion.from_data(all_data)
        feats = kernels.MixedFeatures(query.to(device),
                                      torch.zeros((256, 0), dtype=torch.int32, device=device))
        return [gp_ucb_pe._score_fn(states, states_all, cfg, torch.tensor(flag, device=device),
                                    threshold, hv, trust)(feats).cpu()
                for flag in (True, False)]

    card = scores(states, states_all, all_data, datas, torch.device("cuda"))
    cpu_states = [_cpu_state(s, gp_lib, multitask_gp) for s in states]
    cpu_all = [_cpu_state(s, gp_lib, multitask_gp) for s in states_all]
    cpu = scores(cpu_states, cpu_all, cpu_all[0].data, [s.data for s in cpu_states],
                 torch.device("cpu"))
    at = "unit-scale parameters" if unit_scale else "trained parameters"
    for label, got, want in zip(("HV-scalarized UCB", "PE"), card, cpu):
        rel, err = _rel_err(got, want)
        gate = f"tol {_SCORE_TOL}" if unit_scale else "not held to a tolerance"
        print(f"multi-objective {label} scores at 256 queries on the card vs CPU plain path, {at}: "
              f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ({gate}; "
              f"range {float(want.min()):.4g}..{float(want.max()):.4g})")
        if not bool(torch.isfinite(got).all()) or (unit_scale and not rel <= _SCORE_TOL):
            raise AssertionError(f"multi-objective {label} scores disagree with the CPU plain path")


def _task_correlation(state) -> float:
    """The learned task correlation B[0,1]/sqrt(B[0,0]B[1,1]) of a multi-task
    posterior's first member."""
    b = state.model._task_cov(state.params)[0]
    return float(b[0, 1] / torch.sqrt(b[0, 0] * b[1, 1]))


def _check_pareto(pareto, trials, names):
    """Pareto ops over the study's completed trials on the card against the
    CPU: the frontier mask and the ranks identical, the cumulative
    hypervolume with the same directions within _HV_TOL relative. Prints the
    frontier's size and the hypervolume after each request."""
    f = np.array([[t.final_measurement.metrics[k].value for k in names] for t in trials])
    points = torch.tensor(-f, dtype=torch.float32)  # MAXIMIZE convention
    first = points[:_NUM_TRIALS]
    origin = first.amin(0) - 0.1 * (first.amax(0) - first.amin(0))
    shifted = torch.clamp(points - origin, min=0.0)
    directions = pareto.draw_directions(torch.Generator().manual_seed(0), 1000, 2)
    frontier = pareto.is_frontier(points)
    rank = pareto.pareto_rank(points)
    hv = pareto.cum_hypervolume_origin(shifted, directions)
    start = time.perf_counter()
    frontier_g = pareto.is_frontier(points.cuda())
    rank_g = pareto.pareto_rank(points.cuda())
    hv_g = pareto.cum_hypervolume_origin(shifted.cuda(), directions.cuda())
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - start) * 1e3
    hv_rel = float(torch.max(torch.abs(hv_g.cpu() - hv) / torch.clamp(hv, min=1e-30)))
    same = torch.equal(frontier_g.cpu(), frontier) and torch.equal(rank_g.cpu(), rank)
    after = {n: float(hv[n - 1]) for n in range(_NUM_TRIALS, len(trials) + 1, _COUNT)}
    print(f"Pareto ops over {len(trials)} trials on the card ({card_ms:.1f} ms) vs CPU: frontier "
          f"and ranks {'identical' if same else 'DIFFERENT'}, frontier size "
          f"{int(frontier.sum())}, max rank {int(rank.max())}; cumulative hypervolume "
          f"max_rel_err={hv_rel:.3e} (tol {_HV_TOL}); hypervolume after 1000 trials and after "
          f"each request: {after}")
    if not (same and hv_rel <= _HV_TOL):
        raise AssertionError("Pareto ops on the card disagree with the CPU")


def run_multiobjective_path(vz, gp_ucb_pe, gp_bandit, kernels, gp_lib, surrogates, acquisitions,
                            multitask_gp, pareto):
    """Phase 6: DTLZ2 with two objectives at 1000 trials x 20-D. The DEFAULT
    as the service builds it serves ``_REQUESTS`` suggest(count=5) (one cold
    train, and the profiled request after it a warm one; the mode stays
    exact: multi-objective studies do not go sparse), then the SEPARABLE multi-task variant and
    GAUSSIAN_PROCESS_BANDIT serve one request each on the same study, and the
    Pareto ops run over its completed trials. Returns {path: launches by
    mode}."""
    service = dict(rng_seed=0, surrogate=surrogates.SurrogateConfig(), use_warm_start_ard=True,
                   warm_ard_restarts=1)
    problem, trials = _dtlz2_study(vz)
    print(f"multi-objective study: {len(trials)} trials of the port's DTLZ2 experimenter, "
          f"checksum of points and labels {_study_checksum(trials, problem)}")
    experimenter = _dtlz2_experimenter()

    def evaluate(values):
        trial = vz.Trial(parameters={f"x{j}": float(v) for j, v in enumerate(values)})
        experimenter.evaluate([trial])
        return {name: m.value for name, m in trial.final_measurement.metrics.items()}

    designer = gp_ucb_pe.VizierGPUCBPEBandit(problem, **service)
    states_seen = []

    def check_state(request):
        states, datas = designer._cached_states
        states_seen.append(states)
        if len(states) != 2 or not all(bool(torch.isfinite(s.chol).all()) for s in states):
            raise AssertionError(f"multi-objective request {request}: non-finite Cholesky factor")
        if designer.surrogate_mode != "exact":
            raise AssertionError(f"multi-objective request {request}: went {designer.surrogate_mode}")

    latencies, by_mode, peak, picks = _serve(vz, kernels, designer, check_state, "multi-objective",
                                             trials=trials, evaluate=evaluate,
                                             split_train=True)
    launches = {name: sum(modes.values()) for name, modes in by_mode.items()}
    print(f"multi-objective path: latencies_ms={[round(t * 1e3, 1) for t in latencies]} "
          f"peak_memory_bytes={peak} launches={launches} by_mode={by_mode} "
          f"surrogate_mode={designer.surrogate_mode} ard_train_counts={designer.ard_train_counts}")
    if designer.ard_train_counts != {"cold": 1, "warm": _REQUESTS - 1}:
        raise AssertionError(f"multi-objective trains {designer.ard_train_counts}, "
                             f"expected one cold and the rest warm")
    _require_modes(by_mode, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                             ("matern52_ard_bwd", "gram")), "multi-objective path")
    profile_request(designer, "multi-objective", split_train=True)
    for metric, state in enumerate(states_seen[-1]):
        _check_posterior_against_cpu(f"metric {metric}", state, kernels, gp_lib, multitask_gp)
    for unit_scale in (False, True):
        _check_scores_against_cpu(designer, gp_ucb_pe, kernels, gp_lib, acquisitions, pareto,
                                  multitask_gp, unit_scale)
    paths = {"multi_objective": by_mode}
    study = trials + picks

    mt = gp_ucb_pe.VizierGPUCBPEBandit(
        problem, config=gp_ucb_pe.UCBPEConfig(multitask_type=gp_ucb_pe.MultiTaskType.SEPARABLE),
        **service)
    mt.update(vz.CompletedTrials(study), vz.ActiveTrials())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    mt._train_states_me()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - start
    suggestions = mt.suggest(count=_COUNT)
    torch.cuda.synchronize()
    mt_s = time.perf_counter() - start
    mt_peak = torch.cuda.max_memory_allocated() - before
    paths["multi_task"] = {name: dict(m) for name, m in kernels.LAUNCHES_BY_MODE.items()}
    state = mt._cached_states[0]
    if not isinstance(state, multitask_gp.MultiTaskGPState) or not bool(torch.isfinite(state.chol).all()):
        raise AssertionError("SEPARABLE: no finite joint Cholesky factor")
    _check_suggestions(suggestions, "SEPARABLE")
    print(f"SEPARABLE multi-task suggest(count={_COUNT}) on {len(study)} trials: {mt_s * 1e3:.1f} ms "
          f"(ARD train {train_s * 1e3:.1f} ms, joint Gram {tuple(state.chol.shape)}, peak memory "
          f"{mt_peak} B above baseline), launches by mode {paths['multi_task']}, learned task "
          f"correlation B01/sqrt(B00 B11) = {_task_correlation(state):.4f}, first acquisition "
          f"{suggestions[0].metadata.ns('gp_ucb_pe')['acquisition']}")
    start = time.perf_counter()
    _check_posterior_against_cpu("SEPARABLE per-task", state, kernels, gp_lib, multitask_gp)
    print(f"(multi-task check on the CPU: {time.perf_counter() - start:.1f} s)")
    _require_modes(paths["multi_task"], (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "other"),
                                         ("matern52_ard_bwd", "gram")), "multi-task path")

    bandit = gp_bandit.VizierGPBandit(problem, **service)
    bandit.update(vz.CompletedTrials(study))
    kernels.reset_launch_counts()
    start = time.perf_counter()
    (suggestion,) = bandit.suggest(count=1)
    torch.cuda.synchronize()
    bandit_s = time.perf_counter() - start
    paths["gp_bandit_multi_objective"] = {
        name: dict(m) for name, m in kernels.LAUNCHES_BY_MODE.items()}
    kind = suggestion.metadata.ns("gp_bandit")["acquisition_kind"]
    _check_suggestions([suggestion], "GAUSSIAN_PROCESS_BANDIT")
    print(f"GAUSSIAN_PROCESS_BANDIT multi-objective suggest(count=1): {bandit_s * 1e3:.1f} ms, "
          f"kind {kind}, ard_train_counts={bandit.ard_train_counts}, launches by mode "
          f"{paths['gp_bandit_multi_objective']}")
    if kind != "hv_scalarized_ucb" or bandit.surrogate_mode != "exact":
        raise AssertionError(f"GAUSSIAN_PROCESS_BANDIT multi-objective: {kind} {bandit.surrogate_mode}")
    _require_modes(paths["gp_bandit_multi_objective"], (
        ("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
        ("matern52_ard_bwd", "gram")), "GAUSSIAN_PROCESS_BANDIT multi-objective path")

    _check_pareto(pareto, study, [m.name for m in problem.metric_information])
    return paths


def _check_suggestions(suggestions, kind: str) -> None:
    for s in suggestions:
        values = np.array([s.parameters.get_value(f"x{j}") for j in range(_DIM)], float)
        if not (np.all(np.isfinite(values)) and np.all((values >= 0.0) & (values <= 1.0))):
            raise AssertionError(f"{kind}: suggestion out of bounds {values}")


def _check_sparse_against_cpu(state, kernels, sparse_gp):
    """The k-center inducing set and the sparse posterior on the card against
    the port's plain CPU path on the same data and parameters."""
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    data = dataclasses.replace(state.sdata.data, **{f: cpu(getattr(state.sdata.data, f)) for f in (
        "continuous", "categorical", "labels", "row_mask", "cont_dim_mask", "cat_dim_mask")})
    cpu_sdata = sparse_gp.select_inducing_kcenter(data, state.model.num_inducing)
    same = torch.equal(cpu_sdata.inducing_indices, cpu(state.sdata.inducing_indices))
    print(f"k-center on the card vs CPU plain path: {state.model.num_inducing} indices "
          f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("k-center picks on the card differ from the CPU plain path")
    gen = torch.Generator(device="cuda").manual_seed(1)
    query = torch.rand((64, data.continuous.shape[1]), generator=gen, device="cuda")
    feats = kernels.MixedFeatures(query, torch.zeros((64, 0), dtype=torch.int32, device="cuda"))
    cpu_model = dataclasses.replace(
        state.model, base=dataclasses.replace(state.model.base, device="cpu"))
    # The trained parameters, and unit scales (amplitude 1, length scales 1,
    # noise 0.1): the trained amplitude can sit near its lower clip, where
    # every prediction is small.
    unit = {k: torch.full_like(v, 0.1 if k == "noise_stddev" else 1.0)
            for k, v in state.params.items()}
    for label, params in (("trained", state.params), ("unit-scale", unit)):
        card_state = state.model.precompute_constrained(params, state.sdata)
        mean, std = sparse_gp.SparseEnsemblePredictive(card_state).predict(feats)
        cpu_state = cpu_model.precompute_constrained({k: cpu(v) for k, v in params.items()},
                                                     cpu_sdata)
        mean_c, std_c = sparse_gp.SparseEnsemblePredictive(cpu_state).predict(
            kernels.MixedFeatures(cpu(query), cpu(feats.categorical)))
        err_mean = float(torch.max(torch.abs(cpu(mean) - mean_c)))
        err_std = float(torch.max(torch.abs(cpu(std) - std_c)))
        print(f"sparse predict on the card vs CPU plain path, {label} parameters "
              f"(amplitude {float(params['amplitude'][0]):.4g}): max_abs_err mean={err_mean:.3e} "
              f"stddev={err_std:.3e} (tol {_PREDICT_TOL})")
        if not (max(err_mean, err_std) <= _PREDICT_TOL and math.isfinite(err_mean + err_std)):
            raise AssertionError("sparse predict on the card disagrees with the CPU plain path")


def _profile_kcenter(sparse_gp, state):
    """Prints one k-center selection's (the sparse train's first step, a
    plain PyTorch loop) device launches, device time and wall time at the
    trained state's data."""
    from torch.profiler import ProfilerActivity, profile

    data, m = state.sdata.data, state.model.num_inducing
    sparse_gp.select_inducing_kcenter(data, m)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sparse_gp.select_inducing_kcenter(data, m)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    totals = _device_activity(prof)
    print(f"k-center selection of {m} of {data.num_rows} rows (once per sparse train): "
          f"{sum(n for n, _ in totals.values())} device launches, device "
          f"{sum(us for _, us in totals.values()) / 1e3:.3f} ms, wall {wall_ms:.1f} ms "
          f"(profiler on)")


def _device_activity(prof) -> dict:
    """{name: [launches, device us]} of a profile's device activity (kernels,
    copies, fills), summed from its raw Kineto events. ``key_averages`` gives
    the same sums but builds a Python object per event, which takes minutes
    at the ~500 000 launches of one request."""
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0:
            entry = totals.setdefault(e.name(), [0, 0.0])
            entry[0] += 1
            entry[1] += e.duration_ns() / 1e3
    return totals


def profile_request(designer, kind: str, count: int = 5, split_train: bool = False):
    """One more request after a path's others, under torch.profiler: device
    busy time by kernel and the device's idle share of the request's wall
    time; with ``split_train`` split into ARD training and the rest (pick
    loop, sweeps, decode)."""
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: recording every host op too multiplies the
    # trace's size and its post-processing time.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        if split_train:
            designer._train_states_me()
            torch.cuda.synchronize()
        train_s = time.perf_counter() - start
        designer.suggest(count=count)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - start
    totals = _device_activity(prof)
    busy_us = sum(us for _, us in totals.values())
    print(f"profiled {kind} request: wall {wall_s * 1e3:.1f} ms = ARD train {train_s * 1e3:.1f} ms "
          f"+ picks/sweeps/decode {(wall_s - train_s) * 1e3:.1f} ms (profiler on)")
    print(f"profiled {kind} request: device busy {busy_us / 1e3:.1f} ms, idle share "
          f"{1.0 - busy_us / 1e6 / wall_s:.3f}, {sum(n for n, _ in totals.values())} kernel launches")
    for name, (n, us) in sorted(totals.items(), key=lambda kv: kv[1][1], reverse=True)[:12]:
        print(f"  {us / 1e3:9.2f} ms {n:7d}x  {name[:90]}")


# -- the service's suggest path: policy factory -> cache -> executor ----------

_SERVE_STUDIES = 8
# Studies of round 0 served again with batching off (the throughput and
# parity reference), one after another: 2 of the 8 since the algorithms
# phase joined the script (4 before it).
_REFERENCE_STUDIES = 2
# Study i starts with base + 2i completed trials: all 8 share one padding
# bucket (512 rows exact, below the 512-trial sparse threshold; 1024 sparse).
_SERVE_TRIALS = {"exact": 480, "sparse": 1000}
# Batched rounds: cold, then warm (profiled); exact had a second warm round
# before the algorithms phase joined the script.
_SERVE_ROUNDS = {"exact": 2, "sparse": 2}
# A study's trained NLL served in a flush against the same study served
# alone (batching off): |flush - alone| <= _NLL_TOL * max(1, |alone|). Both
# train from the same seeds; batched and single Choleskys round differently,
# which L-BFGS carries into its iterates.
_NLL_TOL = 1e-3
# A study's posterior at unit-scale parameters computed in the stacked batch
# against computed alone: max |batch - alone| (mean and stddev).
_SERVE_PREDICT_TOL = 1e-4
# The flush window of the serving phases' batched rounds, in place of
# ServingConfig()'s 4 ms: the 8 concurrent requests reach the executor tens
# to hundreds of ms apart (each thread's policy lookup, designer update and
# trial encoding take the interpreter lock in turn), so at 4 ms they would
# not meet. A full bucket (8) flushes at once either way. One more
# serving-exact round runs at ServingConfig() itself and prints what the
# default window gives, without a gate on its flushes.
_SERVE_WINDOW_MS = 2000.0


def _serving_config(study_config_lib, vz, algorithm: str):
    config = study_config_lib.StudyConfig(algorithm=algorithm)
    for j in range(_DIM):
        config.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    config.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    return config


def _serving_trials(vz, study: int, num_trials: int):
    """bench.py's objective, y = -|x - 0.5|^2 + 0.1 noise, seed = study."""
    rng = np.random.default_rng(study)
    x = rng.uniform(size=(num_trials, _DIM)).astype(np.float32)
    y = -np.sum((x - 0.5) ** 2, axis=1) + 0.1 * rng.normal(size=num_trials)
    trials = []
    for i in range(num_trials):
        t = vz.Trial(parameters={f"x{j}": float(x[i, j]) for j in range(_DIM)})
        t.complete(vz.Measurement(metrics={"obj": float(y[i])}))
        trials.append(t)
    return trials


class _Fleet:
    """8 studies, one InRamPolicySupporter each, served through the port's
    policy factory by one ServingRuntime."""

    def __init__(self, mods, runtime, algorithm: str, base_trials: int, name: str):
        vz, study_config_lib, lps, policy_factory = (
            mods["vz"], mods["study_config"], mods["lps"], mods["policy_factory"])
        self.runtime = runtime
        self.factory = policy_factory.DefaultPolicyFactory(runtime)
        self.policy_lib = mods["policy"]
        self.vz = vz
        self.studies = []
        for i in range(_SERVE_STUDIES):
            config = _serving_config(study_config_lib, vz, algorithm)
            supporter = lps.InRamPolicySupporter(config, study_guid=f"{name}-{i}")
            supporter.AddTrials(_serving_trials(vz, i, base_trials + 2 * i))
            self.studies.append((config, supporter, f"{name}-{i}"))

    def _suggest(self, i: int, count: int):
        config, supporter, study_name = self.studies[i]
        policy = self.factory(config, config.algorithm, supporter, study_name)
        request = self.policy_lib.SuggestRequest(
            study_descriptor=supporter.study_descriptor(), count=count)
        return policy.suggest(request).suggestions

    def round(self, count: int, concurrent: bool, profile_first: bool = False,
              studies: int = _SERVE_STUDIES):
        """One request per study: all at once on 8 threads, or the first
        ``studies`` one after another. Returns (suggestions per study, wall
        seconds, profiled (busy us, wall s, launches) of study 0's request
        when asked)."""
        results = [None] * studies
        errors = []
        profiled = None
        torch.cuda.synchronize()
        start = time.perf_counter()
        if concurrent:
            barrier = threading.Barrier(_SERVE_STUDIES)

            def run(i):
                try:
                    barrier.wait()
                    results[i] = self._suggest(i, count)
                except BaseException as e:  # surfaced below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(_SERVE_STUDIES)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i in range(studies):
                if profile_first and i == 0:
                    from torch.profiler import ProfilerActivity, profile

                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        results[i] = self._suggest(i, count)
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                    totals = _device_activity(prof)
                    profiled = (sum(us for _, us in totals.values()), wall,
                                sum(n for n, _ in totals.values()))
                else:
                    results[i] = self._suggest(i, count)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        if errors:
            raise errors[0]
        return results, wall, profiled

    def complete(self, results):
        """Adds each study's picks as trials and completes them."""
        for (_, supporter, _), suggestions in zip(self.studies, results):
            for t in supporter.AddSuggestions(suggestions):
                values = np.array([t.parameters.get_value(f"x{j}") for j in range(_DIM)], float)
                t.complete(self.vz.Measurement(metrics=_bench_objective(values)))

    def designer(self, i: int):
        return self.runtime.designer_cache.peek(self.studies[i][2], touch=False).designer


def _check_round(results, count: int, label: str):
    for i, suggestions in enumerate(results):
        if suggestions is None or len(suggestions) != count:
            raise AssertionError(f"{label}: study {i} got {suggestions}")
        _check_suggestions(suggestions, f"{label} study {i}")


def _check_factors(fleet, label: str, sparse: bool):
    """Every study's trained factors finite (sparse: both Choleskys, info 0)."""
    for i in range(_SERVE_STUDIES):
        d = fleet.designer(i)
        if sparse:
            state = d.sparse_inducing_state()
            chol, chol_b, _, _, _, info = state.model._factorize(state.params, state.sdata)
            ok = all(bool(torch.isfinite(t).all()) for t in (chol, chol_b, state.w, state.linv))
            ok = ok and not bool(torch.any(info != 0))
        else:
            (state,), _ = d._cached_states
            ok = bool(torch.isfinite(state.chol).all())
        if not ok:
            raise AssertionError(f"{label}: study {i}'s trained factor is not finite")


def _trained_state(designer, sparse: bool):
    if sparse:
        return designer.sparse_inducing_state()
    (state,), _ = designer._cached_states
    return state


def _check_serving_parity(fleet, reference, sparse: bool, batch_executor, gp_lib, kernels,
                          label: str):
    """Each study served alone (the reference's) against the same study
    served in the flush: the same data; trained NLLs within _NLL_TOL; the
    posterior at unit-scale parameters computed in the stacked batch of 8
    against alone."""
    worst_nll, worst_pred = 0.0, 0.0
    datas, states = [], []
    for i in range(_SERVE_STUDIES):
        flush_state = _trained_state(fleet.designer(i), sparse)
        fd = flush_state.sdata if sparse else flush_state.data
        datas.append(fd)
        states.append(flush_state)
        if i >= _REFERENCE_STUDIES:  # not served with batching off
            continue
        alone_state = _trained_state(reference.designer(i), sparse)
        ad = alone_state.sdata if sparse else alone_state.data
        for a, b in zip(batch_executor.tree_leaves(fd), batch_executor.tree_leaves(ad)):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: study {i}'s data differs between the runs")
        model = flush_state.model
        coll = model.param_collection()
        nll = [float(s.model.neg_log_likelihood(coll.unconstrain(s.params), d)[0])
               for s, d in ((flush_state, fd), (alone_state, ad))]
        err = abs(nll[0] - nll[1]) / max(1.0, abs(nll[1]))
        worst_nll = max(worst_nll, err)
        print(f"{label} study {i}: trained NLL flush {nll[0]:.6f} alone {nll[1]:.6f} "
              f"(rel {err:.2e}, tol {_NLL_TOL})")
        if not err <= _NLL_TOL:
            raise AssertionError(f"{label}: study {i}'s trained NLL differs from batching off")
    model = states[0].model
    unit = {k: torch.full_like(v[:1], 0.1 if k == "noise_stddev" else 1.0)
            for k, v in states[0].params.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    query = torch.rand((_SERVE_STUDIES, 64, _DIM), generator=gen, device="cuda")
    cat = torch.zeros((_SERVE_STUDIES, 64, 0), dtype=torch.int32, device="cuda")
    stacked = batch_executor.stack_pytrees(datas)
    unit8 = {k: v.expand(_SERVE_STUDIES, *v.shape[1:]).contiguous() for k, v in unit.items()}
    batch_state = model.precompute_constrained(unit8, stacked)
    mean_b, std_b = gp_lib.EnsemblePredictive(batch_state, studies=_SERVE_STUDIES).predict(
        kernels.MixedFeatures(query, cat))
    for i, d in enumerate(datas):
        alone = model.precompute_constrained(unit, d)
        mean_a, std_a = gp_lib.EnsemblePredictive(alone).predict(
            kernels.MixedFeatures(query[i], cat[i]))
        err = max(float(torch.max(torch.abs(mean_b[i] - mean_a))),
                  float(torch.max(torch.abs(std_b[i] - std_a))))
        worst_pred = max(worst_pred, err)
    print(f"{label}: posterior at unit-scale parameters, stacked batch of 8 vs each study alone: "
          f"max_abs_err {worst_pred:.3e} (tol {_SERVE_PREDICT_TOL}); worst trained-NLL rel "
          f"{worst_nll:.2e}")
    if not worst_pred <= _SERVE_PREDICT_TOL:
        raise AssertionError(f"{label}: batched posterior differs from the study alone")
    return worst_nll, worst_pred


def run_serving_phase(kind: str, mods, kernels):
    """Phase 7: the service's suggest path over 8 studies (see the module
    docstring). Returns the phase's launches by mode and its figures."""
    serving, batch_executor, gp_lib = mods["serving"], mods["batch_executor"], mods["gp"]
    sparse = kind == "sparse"
    base, rounds = _SERVE_TRIALS[kind], _SERVE_ROUNDS[kind]
    label = f"serving-{kind}"
    config = dataclasses.replace(serving.ServingConfig(), batch_max_wait_ms=_SERVE_WINDOW_MS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before_bytes = torch.cuda.memory_allocated()
    runtime = serving.ServingRuntime(config)
    fleet = _Fleet(mods, runtime, "DEFAULT", base, label)
    reference_runtime = serving.ServingRuntime(dataclasses.replace(config, batching=False))
    reference = _Fleet(mods, reference_runtime, "DEFAULT", base, f"{label}-alone")
    kernels.reset_launch_counts()
    # The batched rounds' launches (the main path's count); the batching-off
    # reference and the default-window round are counted apart.
    phase_counts = {name: {m: 0 for m in modes} for name, modes in kernels.LAUNCHES_BY_MODE.items()}

    def take_counts(batched: bool = True):
        counts = {name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
        for name, modes in counts.items():
            for m, n in modes.items():
                phase_counts[name][m] += n if batched else 0
        kernels.reset_launch_counts()
        return counts

    figures = {"rounds": []}
    for r in range(rounds):
        stats_before = runtime.stats.snapshot()
        profile = r == rounds - 1
        if profile:
            from torch.profiler import ProfilerActivity, profile as profiler

            with profiler(activities=[ProfilerActivity.CUDA]) as prof:
                results, wall, _ = fleet.round(_COUNT, concurrent=True)
            totals = _device_activity(prof)
            busy = sum(us for _, us in totals.values())
            flush_profile = dict(busy_ms=busy / 1e3, wall_ms=wall * 1e3,
                                 idle=1.0 - busy / 1e6 / wall,
                                 launches=sum(n for n, _ in totals.values()))
            for name, (n, us) in sorted(totals.items(), key=lambda kv: kv[1][1],
                                        reverse=True)[:8]:
                print(f"  flush {us / 1e3:9.2f} ms {n:7d}x  {name[:90]}")
        else:
            results, wall, _ = fleet.round(_COUNT, concurrent=True)
        counts = take_counts()
        stats = {k: runtime.stats.get(k) - stats_before[k] for k in (
            "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
            "warm_trains", "cold_trains", "sparse_suggests")}
        _check_round(results, _COUNT, f"{label} round {r}")
        _check_factors(fleet, f"{label} round {r}", sparse)
        occupancy = stats["batched_suggests"] / max(stats["batch_flushes"], 1)
        row = dict(round=r, wall_ms=wall * 1e3, stats=stats, occupancy=occupancy,
                   launches=counts, suggestions_per_s=_SERVE_STUDIES * _COUNT / wall)
        print(f"{label} round {r} (batching on): {stats}, occupancy {occupancy:.1f}, flush wall "
              f"{wall * 1e3:.1f} ms, {wall * 1e3:.1f} ms per request (8 concurrent), "
              f"{row['suggestions_per_s']:.2f} suggestions/s, launches {counts}")
        if profile:
            row["profile"] = flush_profile
            print(f"{label} round {r} profiled flush: device busy {flush_profile['busy_ms']:.1f} ms "
                  f"of {flush_profile['wall_ms']:.1f} ms, idle share {flush_profile['idle']:.3f}, "
                  f"{flush_profile['launches']} device launches (profiler on)")
        if (stats["batch_flushes"] != 1 or stats["batched_suggests"] != _SERVE_STUDIES
                or stats["batch_fallbacks"] or stats["batch_slot_errors"]):
            raise AssertionError(f"{label} round {r}: not one flush of occupancy 8 without "
                                 f"fallback or slot error: {stats}")
        if r == 0:
            ref_results, ref_wall, ref_profile = reference.round(
                _COUNT, concurrent=False, profile_first=True, studies=_REFERENCE_STUDIES)
            ref_counts = take_counts(batched=False)
            figures["launches_batching_off"] = ref_counts
            _check_round(ref_results, _COUNT, f"{label} batching off")
            if reference_runtime.batch_executor is not None:
                raise AssertionError("the reference runtime batches")
            busy_us, one_wall, one_launches = ref_profile
            row["batching_off"] = dict(
                wall_ms=ref_wall * 1e3, studies=_REFERENCE_STUDIES, launches=ref_counts,
                suggestions_per_s=_REFERENCE_STUDIES * _COUNT / ref_wall,
                profiled_request=dict(busy_ms=busy_us / 1e3, wall_ms=one_wall * 1e3,
                                      idle=1.0 - busy_us / 1e6 / one_wall, launches=one_launches))
            # Per request: the flush's launches over 8 requests' at the
            # reference's rate.
            ratio = {name: (sum(counts[name].values()) / max(
                sum(ref_counts[name].values()) * _SERVE_STUDIES / _REFERENCE_STUDIES, 1))
                for name in counts}
            print(f"{label} round 0 (batching off, the first {_REFERENCE_STUDIES} studies one "
                  f"after another): {ref_wall * 1e3:.1f} ms, "
                  f"{ref_wall * 1e3 / _REFERENCE_STUDIES:.1f} ms per request, "
                  f"{row['batching_off']['suggestions_per_s']:.2f} suggestions/s; launches "
                  f"{ref_counts}; flush launches / 8 sequential requests' launches (at the "
                  f"reference's per-request count) {ratio}; "
                  f"throughput on/off {row['suggestions_per_s'] / row['batching_off']['suggestions_per_s']:.2f}x")
            print(f"{label} profiled sequential request (batching off): device busy "
                  f"{busy_us / 1e3:.1f} ms of {one_wall * 1e3:.1f} ms, idle share "
                  f"{1.0 - busy_us / 1e6 / one_wall:.3f}, {one_launches} device launches "
                  f"(profiler on)")
            row["parity"] = _check_serving_parity(fleet, reference, sparse, batch_executor,
                                                  gp_lib, kernels, f"{label} round 0")
        figures["rounds"].append(row)
        fleet.complete(results)
        if stats["cold_trains" if r == 0 else "warm_trains"] != _SERVE_STUDIES:
            raise AssertionError(f"{label} round {r}: trains {stats}")
        if sparse and stats["sparse_suggests"] != _SERVE_STUDIES:
            raise AssertionError(f"{label} round {r}: not sparse: {stats}")

    # GAUSSIAN_PROCESS_BANDIT: suggest(count=1) for 8 studies at the same sizes.
    bandit = _Fleet(mods, runtime, "GAUSSIAN_PROCESS_BANDIT", base, f"{label}-bandit")
    stats_before = runtime.stats.snapshot()
    results, wall, _ = bandit.round(1, concurrent=True)
    counts = take_counts()
    stats = {k: runtime.stats.get(k) - stats_before[k] for k in (
        "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
        "sparse_suggests")}
    _check_round(results, 1, f"{label} bandit")
    kinds = {r[0].metadata.ns("gp_bandit")["acquisition_kind"] for r in results}
    print(f"{label} GAUSSIAN_PROCESS_BANDIT round (suggest(count=1)): {stats}, flush wall "
          f"{wall * 1e3:.1f} ms, kinds {sorted(kinds)}, launches {counts}")
    if (stats["batch_flushes"] != 1 or stats["batched_suggests"] != _SERVE_STUDIES
            or stats["batch_fallbacks"] or stats["batch_slot_errors"]
            or kinds != {"ucb+sparse" if sparse else "ucb"}):
        raise AssertionError(f"{label} GAUSSIAN_PROCESS_BANDIT round: {stats} {kinds}")
    figures["bandit"] = dict(wall_ms=wall * 1e3, stats=stats, launches=counts)
    figures["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - before_bytes
    print(f"{label}: peak device memory {figures['peak_memory_bytes']} B above the phase's "
          f"baseline; launches over the batched rounds {phase_counts}")
    _require_modes(phase_counts, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                  ("matern52_ard_bwd", "gram")), label)
    if sparse:
        _require_modes(phase_counts, (("matern52_ard_bwd", "cross"),), label)
    runtime.shutdown()
    reference_runtime.shutdown()
    if not sparse:
        figures["default_window"] = _default_window_round(mods, base, label, take_counts)
    return phase_counts, figures


def _default_window_round(mods, base: int, label: str, take_counts) -> dict:
    """One cold round of the phase's 8 studies at ``ServingConfig()`` (its
    4 ms flush window): prints the flushes and occupancy that window gives
    under this concurrent load, and the wall time. Only the suggestions, the
    fallbacks and the slot errors are held."""
    serving = mods["serving"]
    runtime = serving.ServingRuntime(serving.ServingConfig())
    fleet = _Fleet(mods, runtime, "DEFAULT", base, f"{label}-default-window")
    before = runtime.stats.snapshot()
    results, wall, _ = fleet.round(_COUNT, concurrent=True)
    counts = take_counts(batched=False)
    stats = {k: runtime.stats.get(k) - before[k] for k in (
        "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
        "cold_trains")}
    runtime.shutdown()
    _check_round(results, _COUNT, f"{label} default window")
    sequential = _SERVE_STUDIES - stats["batched_suggests"]
    occupancy = stats["batched_suggests"] / max(stats["batch_flushes"] - sequential, 1)
    print(f"{label} round at ServingConfig() (batch_max_wait_ms "
          f"{serving.ServingConfig().batch_max_wait_ms}, 8 concurrent, cold): {stats}, "
          f"{sequential} requests served alone, occupancy of the batched flushes "
          f"{occupancy:.2f}, wall {wall * 1e3:.1f} ms, "
          f"{_SERVE_STUDIES * _COUNT / wall:.2f} suggestions/s, launches {counts} (not gated)")
    if stats["batch_fallbacks"] or stats["batch_slot_errors"]:
        raise AssertionError(f"{label} default window: fallback or slot error: {stats}")
    return dict(wall_ms=wall * 1e3, stats=stats, served_alone=sequential,
                batched_occupancy=occupancy, suggestions_per_s=_SERVE_STUDIES * _COUNT / wall,
                launches=counts)


# -- regret: the DEFAULT designer against the JAX package's 5-seed reference --


def _repo_json(name: str) -> dict:
    return json.loads((pathlib.Path(__file__).resolve().parent / name).read_text())


def _path_launches(kernels, fn):
    """``fn()`` with the launch counts set to 0 just before and read just after."""
    kernels.reset_launch_counts()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start, {
        name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}


def run_regret_phase(kernels, lib):
    """Phase 8: regret parity. The DEFAULT designer in lockstep at the
    reference's configuration, the runner entry point on one Branin2d study,
    and the GP-bandit, mixed-space and two-objective configs of
    regret_suite.py; then K1/K2 at every launch layout these runs made.
    Returns ({path: launches by mode}, figures)."""
    from vizier_tpu_torch.benchmarks import regret

    failures, paths = [], {}
    kernels.LAUNCH_SHAPES = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    report = regret.run("lockstep", device="cuda")  # sets the launch counts to 0 first
    peak = torch.cuda.max_memory_allocated() - before
    paths["regret_lockstep"] = report["launches_by_mode"]
    # A flush trains through K1's Gram mode and K2, predicts through K1's
    # masked cross mode.
    _require_modes(paths["regret_lockstep"], (("matern52_ard_fwd", "gram"),
                                              ("matern52_ard_fwd", "cross"),
                                              ("matern52_ard_bwd", "gram")), "regret lockstep")
    report["parity"] = regret.parity(report)
    report["peak_memory_bytes"] = peak
    for key, row in report["parity"].items():
        print(f"regret {key}: port {[round(v, 4) for v in row['port']]} (median "
              f"{row['port_median']:.6g}) vs reference {row['reference']} (median "
              f"{row['reference_median']:.6g}); one-sided exact Mann-Whitney p "
              f"{row['p']:.4f}; gate {row['gate']}: {'held' if row['passed'] else 'FAILED'}")
        if not row["passed"]:
            failures.append(f"{key} parity")
    for name, f in report["by_function"].items():
        ex = f["executor"]
        gp_rounds = ex["rounds"][1:]  # after the seed round, which runs inline
        print(f"regret lockstep {name}: {f['wall_s']:.1f} s; flushes {ex['batch_flushes']}, "
              f"batched suggests {ex['batched_suggests']}, occupancy {ex['occupancy']:.2f}, "
              f"fallbacks {ex['batch_fallbacks']}, slot errors {ex['batch_slot_errors']}; "
              f"float64 refactors {f['float64_refactors']}; launches {f['launches_by_mode']}")
        print(f"regret lockstep {name} wall per round (s): "
              f"{[round(r['wall_s'], 3) for r in ex['rounds']]}")
        if ex["batch_fallbacks"] or ex["batch_slot_errors"] or any(
                r["batch_flushes"] != 1 or r["batched_suggests"] != len(report["seeds"])
                for r in gp_rounds):
            failures.append(f"{name}: not one flush of every seed per round, or a fallback "
                            f"or slot error")
    print(f"regret lockstep: {report['wall_s']:.1f} s for {len(report['run_wall_s'])} runs, "
          f"peak device memory {peak} B above the phase's baseline, launches "
          f"{report['launches_by_mode']}")

    seq, _, paths["regret_sequential"] = _path_launches(kernels, lambda: regret.run(
        "sequential", functions=(("Branin", 2),), seeds=(1,), device="cuda"))
    branin = seq["per_run"]["Branin2d:first_pick_full"][0]
    print(f"regret runner entry point (BenchmarkState -> InRamDesignerPolicy -> "
          f"BenchmarkRunner, Branin2d seed 1): final regret {branin:.6g} (gate <= "
          f"{regret.BRANIN_MEDIAN_LIMIT}), wall per suggest round (s) "
          f"{[round(t, 3) for t in seq['round_wall_s']['Branin2d:1']]}, float64 refactors "
          f"{seq['by_function']['Branin2d']['float64_refactors']}")
    if not branin <= regret.BRANIN_MEDIAN_LIMIT:
        failures.append("runner entry point Branin2d regret")

    suite = _repo_json("regret_suite_r5.json")
    bandit = suite["branin_gp_ucb"]
    figures = {"branin_gp_ucb": [], "sequential": dict(regret=branin, wall_s=seq["wall_s"])}
    launches = []
    # Seed 1 of the reference's two (seed 2 too before the algorithms phase
    # joined the script).
    for seed, ref_best, ref_random in zip((1,), bandit["best"], bandit["baseline_random"]):
        best, wall, counts = _path_launches(kernels, lambda: regret.branin_gp_ucb(seed))
        launches.append(counts)
        figures["branin_gp_ucb"].append(dict(seed=seed, best=best, wall_s=wall))
        print(f"regret branin_gp_ucb seed {seed}: best {best:.6g} (optimum 0.397887) vs "
              f"reference {ref_best:.6g}, random {ref_random:.6g}; {wall:.1f} s")
        if not best < ref_random:
            failures.append(f"branin_gp_ucb seed {seed} not below random")
    paths["regret_branin_gp_ucb"] = {name: {m: sum(c[name][m] for c in launches) for m in modes}
                                     for name, modes in launches[0].items()}

    mixed, wall, paths["regret_mixed_default_ucbpe"] = _path_launches(
        kernels, lambda: regret.mixed_default_ucbpe(1))
    rows = _repo_json("regret_report_r4.json")["configs"]["mixed_space_default"]["rows"]
    random_median = next(r["objective_final_median"] for r in rows if r["algorithm"] == "ref-random")
    figures["mixed_default_ucbpe"] = dict(best=mixed, wall_s=wall)
    print(f"regret mixed_default_ucbpe seed 1: best {mixed:.7g} (optimum 1.05) vs reference "
          f"{suite['mixed_default_ucbpe']['best'][0]:.7g}, reference-random median "
          f"{random_median:.6g}; {wall:.1f} s")
    if not mixed > random_median:
        failures.append("mixed_default_ucbpe not above the random median")

    (hv, _), wall, paths["regret_zdt1_gp_hv_ucb"] = _path_launches(
        kernels, lambda: regret.zdt1_gp_hv_ucb())
    figures["zdt1_gp_hv_ucb"] = dict(hypervolume=hv, wall_s=wall)
    print(f"regret zdt1_hypervolume gp_hv_ucb: final hypervolume {hv:.6g} (reference point "
          f"(-1.1, -6.0)) vs the JAX run's {suite['zdt1_hypervolume']['gp_hv_ucb']:.6g}; "
          f"{wall:.1f} s")
    if not (math.isfinite(hv) and hv > 0.0):
        failures.append("zdt1 hypervolume not finite and positive")

    figures["lockstep"] = {k: report[k] for k in (
        "median_final_regret", "wall_s", "peak_memory_bytes")}
    figures["lockstep"]["by_function"] = {name: dict(
        wall_s=f["wall_s"], float64_refactors=f["float64_refactors"],
        flushes=f["executor"]["batch_flushes"], occupancy=f["executor"]["occupancy"],
        round_wall_s=[r["wall_s"] for r in f["executor"]["rounds"]])
        for name, f in report["by_function"].items()}
    figures["parity"] = {k: dict(port=r["port"], p=r["p"], passed=r["passed"])
                         for k, r in report["parity"].items()}
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded, "regret phase")
    if failures:
        raise AssertionError(f"regret phase: {failures}")
    return paths, figures


# -- gp-surface: the GP designers' remaining single-objective surface --------

# A winning score (joint qEI, set-PE, the stacked UCB) recomputed on the CPU
# from the card's posteriors copied there, the same draws and the decoded
# suggestions: |card - cpu| <= tol * max(1, |cpu|). The posterior gate's
# tolerance: the decode/encode round trip moves each point by ~1e-7, and the
# card's and the CPU's float32 sums differ in order.
_SURFACE_SCORE_TOL = 5e-3
# The new acquisitions at the sweep's shapes on the card against the CPU on
# the same means, stddevs and draws: rtol and atol (LogEI: rtol 1e-4, its
# log_ndtr differing in the last digits between the devices).
_ACQ_RTOL, _ACQ_ATOL = 1e-5, 1e-6
_QEI_ITERATIONS = 75_000 // 50  # the sweep: 75 000 evaluations, pools of 50


def _shifted_trials(vz, num_trials: int, seed: int):
    """A prior study: bench.py's objective with its optimum moved by a
    seeded offset (normal, 0.05 per dimension), uniform x."""
    rng = np.random.default_rng(seed)
    offset = rng.normal(scale=0.05, size=_DIM)
    x = rng.uniform(size=(num_trials, _DIM)).astype(np.float32)
    y = -np.sum((x - 0.5 - offset) ** 2, axis=1) + 0.1 * rng.normal(size=num_trials)
    trials = []
    for i in range(num_trials):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(x[i, j]) for j in range(_DIM)})
        t.complete(vz.Measurement(metrics={"obj": float(y[i])}))
        trials.append(t)
    return trials


def _corner_prior(query):
    """The JAX package's test prior (tests/designers/test_gp_ucb_pe.py):
    an overwhelming preference for the all-ones corner of scaled space."""
    return -1e4 * torch.sum((query.continuous - 1.0) ** 2, dim=-1)


def _score_close(label: str, card: float, cpu: float) -> float:
    err = abs(card - cpu) / max(1.0, abs(cpu))
    print(f"{label}: card {card:.6g}, recomputed on the CPU {cpu:.6g} "
          f"(rel {err:.2e}, tol {_SURFACE_SCORE_TOL})")
    if not err <= _SURFACE_SCORE_TOL:
        raise AssertionError(f"{label}: the card's score disagrees with the CPU")
    return err


def _check_acquisitions_against_cpu(acquisitions, kernels, predictive, best_label):
    """LCB, LogEI, PI, Sample, the q-acquisitions and MES at the sweep's
    shape (a pool of 50) on the card against the CPU, on the same means,
    stddevs and draws."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    query = kernels.MixedFeatures(torch.rand((50, _DIM), generator=gen, device="cuda"),
                                  torch.zeros((50, 0), dtype=torch.int32, device="cuda"))
    mean, std = predictive.predict(query)
    per_member = predictive.predict_per_member(query)
    eps = torch.randn((32,) + per_member[0].shape, generator=gen, device="cuda")
    u = torch.rand((16,), generator=gen, device="cuda").clamp(min=1e-6)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    worst = {}

    def both(name, fn, args, rtol=_ACQ_RTOL):
        got, want = fn(*args), fn(*(cpu(a) if isinstance(a, torch.Tensor) else a for a in args))
        err = float(torch.max(torch.abs(cpu(got) - want) / (_ACQ_ATOL + rtol * torch.abs(want))))
        worst[name] = err
        if not (err <= 1.0 and bool(torch.isfinite(got).all())):
            raise AssertionError(f"gp-surface {name} on the card disagrees with the CPU")

    both("LCB", acquisitions.LCB(), (mean, std, best_label))
    both("PI", acquisitions.PI(), (mean, std, best_label))
    # A label far above the posterior puts z deep in LogEI's tail regimes.
    for shift in (0.0, 3.0, 30.0):
        both(f"LogEI (best + {shift:g})", acquisitions.LogEI(), (mean, std, best_label + shift),
             rtol=1e-4)
    both("Sample", acquisitions.Sample.apply, (mean, std, eps[0, 0]))
    for kind in ("qei", "qpi", "qucb"):
        both(kind, lambda m, s, e, b: acquisitions.q_acquisition(m, s, e, best_label=b, kind=kind),
             (*per_member, eps, best_label))

    class Fixed:
        def __init__(self, m, s):
            self.m, self.s = m, s

        def predict(self, query):
            return self.m, self.s

    both("MES", lambda m, s, uu: acquisitions.MaxValueEntropySearch.from_predictive(
        Fixed(m, s), None, uu)(m, s, None), (mean, std, u))
    print(f"gp-surface acquisitions at a pool of 50 on the card vs the CPU, worst |err| / "
          f"({_ACQ_ATOL} + rtol |cpu|) (<= 1 passes): "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    return worst


def run_gp_surface_phase(kernels, lib):
    """Phase 9: the GP designers' remaining single-objective surface at
    bench.py's study (1000 trials x 20-D), through the designers' entry
    points: PI, joint qEI, UCB-PE's set acquisition and prior_acquisition,
    transfer priors, the Adam ARD optimizer, and predict/sample; then K1/K2
    at every launch layout these steps made. Returns ({path: launches by
    mode}, figures)."""
    import copy

    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch import surrogates
    from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import multitask_gp
    from vizier_tpu_torch.models import stacked_residual
    from vizier_tpu_torch.optimizers import eagle as eagle_lib
    from vizier_tpu_torch.optimizers import lbfgs
    from vizier_tpu_torch.optimizers import vectorized as vectorized_lib

    problem, trials = _bench_problem(vz), _bench_trials(vz, _NUM_TRIALS, _DIM)
    to_cpu = lambda state: _cpu_state(state, gp_lib, multitask_gp)  # noqa: E731
    cpu_data = lambda data: _cpu_data(data, gp_lib, multitask_gp)  # noqa: E731
    paths, figures = {}, {"steps": {}}
    kernels.LAUNCH_SHAPES = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    phase_start = time.perf_counter()

    def request(step, designer, count, kind, ns="gp_bandit"):
        kernels.reset_launch_counts()
        start = time.perf_counter()
        suggestions = designer.suggest(count=count)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        paths[f"gp_surface_{step}"] = counts = {
            name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
        _check_suggestions(suggestions, f"gp-surface {step}")
        kinds = [s.metadata.ns(ns).get("acquisition_kind", "ucb_pe") for s in suggestions]
        values = [float(s.metadata.ns(ns)["acquisition"]) for s in suggestions]
        print(f"gp-surface {step}: suggest(count={count}) {wall * 1e3:.1f} ms, kinds {kinds}, "
              f"acquisition {values}, ard_train_counts {designer.ard_train_counts}, launches "
              f"by mode {counts}")
        if len(suggestions) != count or not all(math.isfinite(v) for v in values) or (
                kind is not None and kinds != [kind] * count):
            raise AssertionError(f"gp-surface {step}: {kinds} {values}")
        figures["steps"][step] = dict(wall_ms=wall * 1e3, launches=counts, kinds=kinds)
        return suggestions

    # 1. PI.
    pi = gp_bandit.VizierGPBandit(problem, acquisition="pi", rng_seed=0)
    pi.update(vz.CompletedTrials(trials))
    request("pi", pi, 1, "pi")

    # 2. Joint qEI, with the service's surrogate config: the auto-switch
    # flips the 1000-trial study sparse, and the q-batch stays exact.
    qei = gp_bandit.VizierGPBandit(problem, acquisition="qei", rng_seed=0,
                                   surrogate=surrogates.SurrogateConfig())
    qei.update(vz.CompletedTrials(trials))
    seeds = copy.deepcopy(qei._seed_stream)
    batch = request("qei", qei, _COUNT, "qei_joint")
    counts = paths["gp_surface_qei"]["matern52_ard_fwd"]
    per_iteration = counts["cross"] / _QEI_ITERATIONS
    state = qei._last_predictive.states
    print(f"gp-surface qei: K1 launches per sweep iteration: k* (cross) {per_iteration:.3f}, "
          f"all modes {sum(counts.values()) / _QEI_ITERATIONS:.3f} over {_QEI_ITERATIONS} "
          f"iterations; surrogate_mode {qei.surrogate_mode}, surrogate_counts "
          f"{qei.surrogate_counts}")
    if (per_iteration != 1.0 or not isinstance(state, gp_lib.GPState)
            or qei.surrogate_counts["sparse_suggests"] != 0):
        raise AssertionError("gp-surface qei: not one k* launch per sweep iteration on the "
                             "exact posterior")
    # One more joint-qEI sweep over the trained posterior, profiled alone:
    # its only factorizations are the [50, E, 5, 5] Choleskys.
    from torch.profiler import ProfilerActivity, profile

    vec_opt = vectorized_lib.VectorizedOptimizer(
        eagle_lib.VectorizedEagleStrategy(num_continuous=_DIM * _COUNT, category_sizes=()),
        device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        gp_bandit._maximize_q_batch(
            vec_opt, state, acquisitions.get_best_labels(state.data.labels, state.data.row_mask),
            acquisitions.TrustRegion.from_data(state.data),
            torch.Generator(device="cuda").manual_seed(8), _COUNT, 16,
            gp_bandit._prior_features_from_data(state.data))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    totals = _device_activity(prof)
    busy = sum(us for _, us in totals.values())
    chol = sum(us for name, (_, us) in totals.items() if "potrf" in name.lower()
               or "chol" in name.lower())
    figures["qei_sweep_profile"] = dict(
        wall_ms=wall * 1e3, busy_ms=busy / 1e3, idle=1.0 - busy / 1e6 / wall,
        cholesky_ms=chol / 1e3, launches=sum(n for n, _ in totals.values()))
    print(f"gp-surface qei sweep alone, profiled (profiler on): {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms, idle share {figures['qei_sweep_profile']['idle']:.3f}, the "
          f"[50, E, {_COUNT}, {_COUNT}] Choleskys {chol / 1e3:.1f} ms ({chol / max(busy, 1e-9):.3f} "
          f"of busy), {figures['qei_sweep_profile']['launches']} device launches")
    for name, (n, us) in sorted(totals.items(), key=lambda kv: kv[1][1], reverse=True)[:8]:
        print(f"  {us / 1e3:9.2f} ms {n:7d}x  {name[:90]}")
    # The winning batch's qEI on the CPU: the sweep's normals regenerated
    # from the acquisition phase's seed (the second of the suggest's two).
    seeds.integers(0, 2**62, dtype=np.int64)
    acq_gen = torch.Generator(device="cuda").manual_seed(int(seeds.integers(0, 2**62,
                                                                            dtype=np.int64)))
    eps = torch.randn((16, state.alpha.shape[0], _COUNT), generator=acq_gen, device="cuda")
    cpu_state = to_cpu(state)
    winner = qei._encode_suggestions(batch)
    query = kernels.MixedFeatures(winner.continuous.cpu()[None], winner.categorical.cpu()[None])
    data = cpu_state.data
    best = acquisitions.get_best_labels(data.labels, data.row_mask)
    figures["qei_score_rel_err"] = _score_close("gp-surface qei winning batch", float(
        batch[0].metadata.ns("gp_bandit")["acquisition"]), float(gp_bandit.qei_joint_scores(
            cpu_state, query, eps.cpu(), best, acquisitions.TrustRegion.from_data(data))[0]))
    # A pool of 50 batches, half of them the best observed points jittered
    # (non-zero improvement), half uniform: qEI and predict_joint on the
    # card against the CPU plain path at the same factorization.
    gen = torch.Generator(device="cuda").manual_seed(6)
    top = gp_bandit._prior_features_from_data(state.data).continuous[:_COUNT]
    near = torch.clamp(top + 0.02 * torch.randn((25, _COUNT, _DIM), generator=gen,
                                                device="cuda"), 0.0, 1.0)
    pool = kernels.MixedFeatures(
        torch.cat([near, torch.rand((25, _COUNT, _DIM), generator=gen, device="cuda")]),
        torch.zeros((50, _COUNT, 0), dtype=torch.int32, device="cuda"))
    host_pool = kernels.MixedFeatures(*(t.cpu() for t in pool))
    card_qei = gp_bandit.qei_joint_scores(state, pool, eps, best.cuda(),
                                          acquisitions.TrustRegion.from_data(state.data))
    host_qei = gp_bandit.qei_joint_scores(cpu_state, host_pool, eps.cpu(), best,
                                          acquisitions.TrustRegion.from_data(data))
    qei_err = float(torch.max(torch.abs(card_qei.cpu() - host_qei)
                              / torch.clamp(torch.abs(host_qei), min=1.0)))
    figures["qei_pool_rel_err"] = qei_err
    print(f"gp-surface qEI of a pool of 50 batches on the card vs the CPU: rel err {qei_err:.2e} "
          f"(tol {_SURFACE_SCORE_TOL}); {int((host_qei > 0).sum())} of 50 positive, max "
          f"{float(host_qei.max()):.4g}")
    if not qei_err <= _SURFACE_SCORE_TOL:
        raise AssertionError("gp-surface qEI scores on the card disagree with the CPU")
    card = state.predict_joint(pool)
    host = cpu_state.predict_joint(host_pool)
    joint_err = max(float(torch.max(torch.abs(a.cpu() - b))) for a, b in zip(card, host))
    figures["predict_joint_max_abs_err"] = joint_err
    print(f"gp-surface predict_joint [50 candidates x {_COUNT}] on the card vs the CPU plain "
          f"path at the trained parameters: max_abs_err {joint_err:.3e} (tol {_PREDICT_TOL})")
    if not joint_err <= _PREDICT_TOL:
        raise AssertionError("gp-surface predict_joint on the card disagrees with the CPU")
    figures["acquisitions"] = _check_acquisitions_against_cpu(
        acquisitions, kernels, qei._last_predictive,
        acquisitions.get_best_labels(state.data.labels, state.data.row_mask))

    # 7 (after 2). predict and sample at 100 suggestions: no retrain.
    rng = np.random.default_rng(7)
    points = [vz.TrialSuggestion(parameters={f"x{j}": float(v) for j, v in enumerate(row)})
              for row in rng.uniform(size=(100, _DIM))]
    trains = qei.ard_train_counts
    kernels.reset_launch_counts()
    start = time.perf_counter()
    prediction = qei.predict(points, rng=np.random.default_rng(0))
    samples = qei.sample(points, rng=np.random.default_rng(1), num_samples=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    paths["gp_surface_predict"] = counts = {
        name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
    labels = np.array([t.final_measurement.metrics["obj"].value for t in trials])
    print(f"gp-surface predict + sample(1000) at 100 suggestions: {wall * 1e3:.1f} ms, launches "
          f"{counts}, mean of means {float(np.mean(prediction.mean)):.4f} (labels "
          f"{labels.min():.3f}..{labels.max():.3f}), samples {samples.shape}")
    if (counts["matern52_ard_fwd"]["gram"] or qei.ard_train_counts != trains
            or prediction.mean.shape != (100,) or samples.shape != (1000, 100)
            or not np.all(np.isfinite(samples))):
        raise AssertionError("gp-surface predict/sample retrained or gave bad values")
    figures["steps"]["predict"] = dict(wall_ms=wall * 1e3, launches=counts)

    # 3. UCB-PE with the set acquisition: one pick, then a set of four.
    config = gp_ucb_pe.UCBPEConfig(optimize_set_acquisition_for_exploration=True)
    set_pe = gp_ucb_pe.VizierGPUCBPEBandit(problem, config=config, rng_seed=0)
    set_pe.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    fresh = set_pe._has_new_completed_trials()
    picks = request("set_pe", set_pe, _COUNT, None, ns="gp_ucb_pe")
    values = [float(s.metadata.ns("gp_ucb_pe")["acquisition"]) for s in picks]
    if not fresh or len(set(values[1:])) != 1:
        raise AssertionError(f"gp-surface set_pe: not one pick and one set: {values}")
    (state,), _ = set_pe._cached_states
    cpu_state = to_cpu(state)
    all_data = cpu_data(set_pe._all_points_data(_COUNT))
    first = set_pe._encode_suggestions(picks[:1])
    all_data = gp_ucb_pe._append_row(all_data, kernels.MixedFeatures(
        first.continuous.cpu(), first.categorical.cpu()))
    pe_params, _, threshold = gp_ucb_pe._pe_conditioning([cpu_state], all_data, config)
    state_all = cpu_state.model.precompute_constrained(pe_params[0], all_data)
    members = set_pe._encode_suggestions(picks[1:])
    figures["set_pe_score_rel_err"] = _score_close(
        "gp-surface set-PE winning set", values[1], float(
        gp_ucb_pe.set_pe_scores(
            cpu_state, state_all, kernels.MixedFeatures(members.continuous.cpu()[None],
                                                        members.categorical.cpu()[None]),
            threshold[0], config, acquisitions.TrustRegion.from_data(all_data))[0]))

    # 4. UCB-PE with a prior over the space.
    prior = gp_ucb_pe.VizierGPUCBPEBandit(problem, prior_acquisition=_corner_prior, rng_seed=0)
    prior.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    corner = request("prior_acquisition", prior, _COUNT, None, ns="gp_ucb_pe")
    means = [float(np.mean([s.parameters.get_value(f"x{j}") for j in range(_DIM)]))
             for s in corner]
    print(f"gp-surface prior_acquisition: each suggestion's mean coordinate {means} (the prior's "
          f"corner is 1)")
    if not min(means) > 0.8:
        raise AssertionError("gp-surface prior_acquisition: suggestions away from the corner")

    # 5. Transfer: two 1000-trial prior studies under a 100-trial one.
    current = _bench_trials(vz, 100, _DIM)
    transfer = gp_bandit.VizierGPBandit(problem, rng_seed=0)
    transfer.update(vz.CompletedTrials(current))
    transfer.set_priors([_shifted_trials(vz, _NUM_TRIALS, seed) for seed in (11, 12)])
    (pick,) = request("priors", transfer, 1, "ucb+priors")
    stack = transfer._last_predictive
    rows = [level.data.num_rows for level in stack.levels]
    pad = transfer._converter.padding.pad_trials
    if rows != [pad(_NUM_TRIALS)] * 2 + [pad(len(current))] or not all(bool(torch.isfinite(level.chol).all())
                                            for level in stack.levels):
        raise AssertionError(f"gp-surface priors: levels of {rows} rows, or a non-finite factor")
    data = gp_lib.GPData.from_model_data(transfer._warped_model_data(), torch.device("cpu"))
    scoring = acquisitions.ScoringFunction(
        predictive=stacked_residual.StackedResidualGP(tuple(to_cpu(l) for l in stack.levels)),
        acquisition=acquisitions.UCB(transfer.ucb_coefficient),
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
        trust_region=acquisitions.TrustRegion.from_data(data))
    x = transfer._encode_suggestions([pick])
    figures["stacked_score_rel_err"] = _score_close("gp-surface stacked UCB winning point", float(
        pick.metadata.ns("gp_bandit")["acquisition"]), float(scoring.score(
            kernels.MixedFeatures(x.continuous.cpu(), x.categorical.cpu()))[0]))

    # 6. The exact DEFAULT with Adam as its ARD optimizer.
    adam = gp_ucb_pe.VizierGPUCBPEBandit(problem, rng_seed=0, ard_optimizer=lbfgs.AdamOptimizer())
    adam.update(vz.CompletedTrials(trials), vz.ActiveTrials())
    request("adam", adam, _COUNT, None, ns="gp_ucb_pe")
    (state,), (data,) = adam._cached_states
    nll = adam._model.neg_log_likelihood(
        adam._model.param_collection().unconstrain(state.params), data)
    print(f"gp-surface adam: trained NLL {float(nll[0]):.4f}, parameters "
          f"{ {k: [round(float(x), 4) for x in v.reshape(-1)[:4]] for k, v in state.params.items()} }")
    if not (bool(torch.isfinite(state.chol).all()) and math.isfinite(float(nll[0]))
            and paths["gp_surface_adam"]["matern52_ard_bwd"]["gram"] >= 200):
        raise AssertionError("gp-surface adam: non-finite fit, or fewer than 200 Adam steps")

    figures["wall_s"] = time.perf_counter() - phase_start
    figures["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - before
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded, "gp-surface phase")
    print(f"gp-surface phase: {figures['wall_s']:.1f} s, peak device memory "
          f"{figures['peak_memory_bytes']} B above the phase's baseline; {_card_line()}")
    return paths, figures


# -- algorithms: the service's other algorithms, and the wrappers -------------

# The binary study of BOCS and HARMONICA: 20 two-value categoricals, 100
# completed trials of a seeded sparse quadratic (BOCS's paper's setting).
_BITS, _BINARY_TRIALS = 20, 100
# The regret phase's shape for the wrappers: 150 trials x 20-D.
_WRAPPER_TRIALS = 150
# suggest(5) requests of the scheduled and safety wrappers, each request's
# picks completed and fed back.
_WRAPPER_REQUESTS = 2
# At 20-D the shuffled grid would be a permutation of 10^20 points, which
# neither package can build (ROADMAP C12): it runs on a 6-D study.
_SHUFFLED_GRID_DIM = 6
_ROUTES = ("RANDOM_SEARCH", "QUASI_RANDOM_SEARCH", "GRID_SEARCH", "SHUFFLED_GRID_SEARCH",
           "EAGLE_STRATEGY", "CMA_ES", "NSGA2", "BOCS", "HARMONICA")
_SERIALIZABLE_ROUTES = ("QUASI_RANDOM_SEARCH", "GRID_SEARCH", "SHUFFLED_GRID_SEARCH",
                        "EAGLE_STRATEGY", "NSGA2")


def _binary_study(vz):
    """(problem, trials, complete(trial)): 20 two-value categoricals,
    y = b'x + x'Qx with 20 seeded nonzero pair weights in Q, MINIMIZE."""
    rng = np.random.default_rng(0)
    linear = rng.normal(size=_BITS)
    pairs = [tuple(sorted(rng.choice(_BITS, size=2, replace=False))) for _ in range(20)]
    weights = rng.normal(size=len(pairs)) * 2.0
    problem = vz.ProblemStatement()
    for i in range(_BITS):
        problem.search_space.root.add_categorical_param(f"b{i}", ["0", "1"])
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MINIMIZE))

    def value(bits) -> float:
        return float(linear @ bits + sum(w * bits[i] * bits[j] for (i, j), w in zip(pairs, weights)))

    trials = []
    for i, bits in enumerate(rng.integers(0, 2, size=(_BINARY_TRIALS, _BITS))):
        t = vz.Trial(id=i + 1, parameters={f"b{j}": str(b) for j, b in enumerate(bits)})
        t.complete(vz.Measurement(metrics={"obj": value(bits)}))
        trials.append(t)
    return problem, trials, lambda t: t.complete(vz.Measurement(metrics={"obj": value(np.array(
        [int(t.parameters.get_value(f"b{j}")) for j in range(_BITS)]))}))


def _route_study(vz, name: str):
    """(problem, completed trials, complete(trial)) of a route."""
    if name == "NSGA2":
        problem, trials = _dtlz2_study(vz)
        exp = _dtlz2_experimenter()
        return problem, trials, lambda t: exp.evaluate([t])
    if name in ("BOCS", "HARMONICA"):
        return _binary_study(vz)
    dim = _SHUFFLED_GRID_DIM if name == "SHUFFLED_GRID_SEARCH" else _DIM
    problem = vz.ProblemStatement()
    for j in range(dim):
        problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    trials = _bench_trials(vz, _NUM_TRIALS, dim)
    return problem, trials, lambda t: t.complete(vz.Measurement(metrics=_bench_objective(
        np.array([t.parameters.get_value(f"x{j}") for j in range(dim)]))))


def _serve_route(mods, kernels, name: str) -> dict:
    """Two SuggestRequest(count=5) of one route through the factory, the
    picks completed in between; the serializable routes must load, on the
    second request, the state the first wrote into the study."""
    from vizier_tpu_torch.benchmarks import regret

    vz, sc, lps = mods["vz"], mods["study_config"], mods["lps"]
    problem, trials, complete = _route_study(vz, name)
    supporter = lps.InRamPolicySupporter(sc.StudyConfig.from_problem(problem))
    supporter.AddTrials(trials)
    factory = mods["policy_factory"].DefaultPolicyFactory(device="cuda")
    policy = factory(problem, name, supporter, f"algorithms-{name}")
    restored = []
    if name in _SERIALIZABLE_ROUTES:
        make = policy._make_or_restore_designer

        def spy(p, state):
            designer = make(p, state)
            restored.append(state is not None)
            return designer
        policy._make_or_restore_designer = spy
    walls = []
    kernels.reset_launch_counts()
    for _ in range(2):
        start = time.perf_counter()
        new = supporter.SuggestTrials(policy, _COUNT)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        if len(new) != _COUNT:
            raise AssertionError(f"algorithms {name}: {len(new)} suggestions, not {_COUNT}")
        regret.check_suggestions(new, problem, f"algorithms {name}")
        for t in new:
            complete(t)
    launches = {k: dict(v) for k, v in kernels.LAUNCHES_BY_MODE.items()}
    state = supporter.GetStudyConfig().metadata.ns("designer_policy_v0").get("designer")
    print(f"algorithms route {name} ({type(policy).__name__}): suggest(count={_COUNT}) x2 "
          f"{[round(w * 1e3, 1) for w in walls]} ms over {len(trials)} completed trials; state "
          f"restored on the second request: {restored or 'stateless'}; state "
          f"{len(state or '')} chars; launches {launches}")
    if name in _SERIALIZABLE_ROUTES and (restored != [False, True] or not state):
        raise AssertionError(f"algorithms {name}: the second request did not load the state "
                             f"the first wrote ({restored})")
    return dict(wall_ms=[w * 1e3 for w in walls], policy=type(policy).__name__,
                restored=restored, launches=launches, supporter=supporter, problem=problem)


def run_algorithms_phase(kernels, lib, mods):
    """Phase 10: the service's algorithms besides the GP bandits, through the
    port's policy factory; NSGA2's survival on the card against the CPU; the
    scalarizing, scheduled and safety wrappers around the GP designers; and
    regret_suite.py's baselines against the JAX package's 5-seed runs. Then
    K1/K2 at every launch layout the phase made. Returns ({path: launches by
    mode}, figures)."""
    from vizier_tpu_torch.benchmarks import regret
    from vizier_tpu_torch.converters import core as converters
    from vizier_tpu_torch.designers import evolution, gp_ucb_pe
    from vizier_tpu_torch.designers import scalarizing_designer, scheduled_designer
    from vizier_tpu_torch.designers import unsafe_as_infeasible_designer
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import multitask_gp

    vz = mods["vz"]
    paths, figures = {}, {"routes": {}}
    kernels.LAUNCH_SHAPES = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    phase_start = time.perf_counter()

    # 1. The factory's routes.
    served = {}
    for name in _ROUTES:
        served[name] = _serve_route(mods, kernels, name)
        paths[f"algorithms_{name.lower()}"] = served[name].pop("launches")
        figures["routes"][name] = {k: served[name][k] for k in ("wall_ms", "policy", "restored")}

    # 2. NSGA2's survival ranking on the card against the CPU plain path,
    # over the DTLZ2 study's 1010 completed trials.
    nsga2 = served["NSGA2"]
    completed = nsga2["supporter"].GetTrials(status_matches=vz.TrialStatus.COMPLETED)
    metrics = nsga2["problem"].metric_information
    objectives = converters.MetricsEncoder(metrics).encode(completed)
    evolution.survival_ranking(objectives, torch.device("cuda"))  # warm
    start = time.perf_counter()
    card_layers, card_crowding = evolution.survival_ranking(objectives, torch.device("cuda"))
    card_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    cpu_layers, cpu_crowding = evolution.survival_ranking(objectives, torch.device("cpu"))
    cpu_ms = (time.perf_counter() - start) * 1e3
    same_order = bool(np.array_equal(np.lexsort((-card_crowding, card_layers)),
                                     np.lexsort((-cpu_crowding, cpu_layers))))
    figures["nsga2_survival"] = dict(
        rows=len(completed), fronts=int(card_layers.max()) + 1, card_ms=card_ms, cpu_ms=cpu_ms,
        layers_identical=bool(np.array_equal(card_layers, cpu_layers)),
        crowding_bit_identical=card_crowding.tobytes() == cpu_crowding.tobytes(),
        order_identical=same_order)
    print(f"algorithms NSGA2 survival ranking over {len(completed)} DTLZ2 trials: "
          f"{figures['nsga2_survival']['fronts']} fronts; card {card_ms:.2f} ms, CPU plain "
          f"{cpu_ms:.2f} ms; layers identical {figures['nsga2_survival']['layers_identical']}, "
          f"crowding bit-identical {figures['nsga2_survival']['crowding_bit_identical']}, "
          f"surviving order identical {same_order}")
    if not (figures["nsga2_survival"]["layers_identical"] and same_order
            and figures["nsga2_survival"]["crowding_bit_identical"]):
        raise AssertionError("algorithms: NSGA2's survival on the card differs from the CPU")

    # 3. The scalarizing wrapper (default Chebyshev, the GP bandit inside) on
    # the DTLZ2 study.
    problem, trials = _dtlz2_study(vz)
    wrapper = scalarizing_designer.ScalarizingDesigner(problem, seed=0, device="cuda")
    wrapper.update(vz.CompletedTrials(trials))
    rows = converters.MetricsEncoder(problem.metric_information).encode(trials)
    card_labels = wrapper.scalarize(rows)
    cpu_labels = wrapper.scalarization(torch.from_numpy(rows.astype(np.float32))).numpy()
    kernels.reset_launch_counts()
    start = time.perf_counter()
    (pick,) = wrapper.suggest(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    paths["algorithms_scalarizing"] = counts = {
        k: dict(v) for k, v in kernels.LAUNCHES_BY_MODE.items()}
    _check_suggestions([pick], "algorithms scalarizing")
    figures["scalarizing"] = dict(wall_ms=wall * 1e3, launches=counts,
                                  labels_bit_identical=card_labels.tobytes() == cpu_labels.tobytes())
    print(f"algorithms ScalarizingDesigner (Chebyshev over {len(trials)} DTLZ2 trials, inner "
          f"VizierGPBandit on the card): suggest(1) {wall * 1e3:.1f} ms, launches by mode "
          f"{counts}; scalarized labels on the card bit-identical to the CPU's "
          f"{figures['scalarizing']['labels_bit_identical']}")
    if not figures["scalarizing"]["labels_bit_identical"]:
        raise AssertionError("algorithms: scalarized labels on the card differ from the CPU's")
    _require_modes(counts, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                            ("matern52_ard_bwd", "gram")), "algorithms scalarizing")
    _check_posterior_against_cpu("algorithms scalarizing inner GP",
                                 wrapper._inner._last_predictive.states, kernels, gp_lib,
                                 multitask_gp)

    # 4. The scheduled DEFAULT and the safety wrapper at 150 x 20-D.
    base = _bench_trials(vz, _WRAPPER_TRIALS, _DIM)

    def requests(step, designer, evaluate):
        """``_WRAPPER_REQUESTS`` suggest(5), each one's picks completed and fed
        back through ``update``; returns the walls, the launches by mode and
        the completed picks."""
        walls, done = [], []
        kernels.reset_launch_counts()
        tid = _WRAPPER_TRIALS
        for _ in range(_WRAPPER_REQUESTS):
            start = time.perf_counter()
            batch = designer.suggest(_COUNT)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            _check_suggestions(batch, f"algorithms {step}")
            new = []
            for s in batch:
                tid += 1
                t = s.to_trial(tid)
                t.complete(vz.Measurement(metrics=evaluate(np.array(
                    [t.parameters.get_value(f"x{j}") for j in range(_DIM)]))))
                new.append(t)
            designer.update(vz.CompletedTrials(new), vz.ActiveTrials())
            done.extend(new)
        paths[f"algorithms_{step}"] = counts = {
            k: dict(v) for k, v in kernels.LAUNCHES_BY_MODE.items()}
        return walls, counts, done

    scheduled = scheduled_designer.scheduled_gp_ucb_pe(
        _bench_problem(vz), expected_total_num_trials=2 * _WRAPPER_TRIALS, seed=0, device="cuda")
    rebuilds = []
    make = scheduled.designer_factory

    def logged(p, **values):
        rebuilds.append(dict(values))
        return make(p, **values)
    scheduled.designer_factory = logged
    scheduled.update(vz.CompletedTrials(base), vz.ActiveTrials())
    walls, counts, _ = requests("scheduled_gp_ucb_pe", scheduled, _bench_objective)
    config = scheduled._designer.config
    figures["scheduled_gp_ucb_pe"] = dict(wall_ms=[w * 1e3 for w in walls], rebuilds=rebuilds,
                                          launches=counts)
    print(f"algorithms scheduled_gp_ucb_pe at {_WRAPPER_TRIALS} x {_DIM}-D: suggest(count="
          f"{_COUNT}) x{_WRAPPER_REQUESTS} {[round(w * 1e3, 1) for w in walls]} ms; rebuilds "
          f"(scheduled values) "
          f"{[{k: round(v, 4) for k, v in r.items()} for r in rebuilds]}; the designer's "
          f"coefficients ucb {config.ucb_coefficient}, explore "
          f"{config.explore_region_ucb_coefficient}; launches {counts}")
    if not rebuilds or config.ucb_coefficient != round(rebuilds[-1]["ucb_coefficient"], 2):
        raise AssertionError("algorithms scheduled_gp_ucb_pe: no rebuild, or coefficients off "
                             "the schedule")

    safe_problem = _bench_problem(vz)
    safe_problem.metric_information.append(vz.MetricInformation(
        name="safety", goal=vz.ObjectiveMetricGoal.MAXIMIZE, safety_threshold=0.0))
    safe_metrics = lambda x: dict(_bench_objective(x), safety=float(x[0] - 0.2))  # noqa: E731
    unsafe_base = []
    for t in base:
        x = np.array([t.parameters.get_value(f"x{j}") for j in range(_DIM)])
        u = vz.Trial(id=t.id, parameters=t.parameters)
        u.complete(vz.Measurement(metrics=safe_metrics(x)))
        unsafe_base.append(u)
    safety = unsafe_as_infeasible_designer.UnsafeAsInfeasibleDesigner(
        safe_problem, designer_factory=lambda p, **kw: gp_ucb_pe.VizierGPUCBPEBandit(
            p, rng_seed=0, device="cuda"))
    seen = []
    inner_update = safety._inner.update

    def record(completed, all_active=vz.ActiveTrials()):
        seen.extend(completed.trials)
        inner_update(completed, all_active)
    safety._inner.update = record
    safety.update(vz.CompletedTrials(unsafe_base), vz.ActiveTrials())
    walls, counts, picked = requests("unsafe_as_infeasible", safety, safe_metrics)
    given = {t.id: t for t in unsafe_base + picked}
    unsafe = {i for i, t in given.items() if t.final_measurement.metrics["safety"].value < 0.0}
    infeasible = {t.id for t in seen if t.infeasible}
    figures["unsafe_as_infeasible"] = dict(wall_ms=[w * 1e3 for w in walls], launches=counts,
                                           trials=len(seen), unsafe=len(unsafe),
                                           infeasible_seen=len(infeasible))
    print(f"algorithms UnsafeAsInfeasibleDesigner (inner DEFAULT) at {_WRAPPER_TRIALS} x "
          f"{_DIM}-D: suggest(count={_COUNT}) x{_WRAPPER_REQUESTS} "
          f"{[round(w * 1e3, 1) for w in walls]} ms; the "
          f"inner designer saw {len(seen)} trials, {len(infeasible)} of them infeasible, the "
          f"{len(unsafe)} unsafe ones; launches {counts}")
    if not unsafe or infeasible != unsafe or len(seen) != len(given):
        raise AssertionError("algorithms: the unsafe trials, and only they, must reach the "
                             "inner designer as infeasible")

    # 5. regret_suite.py's baselines, seeds 1-5, against the JAX package's.
    values, baseline_walls = {}, {}
    for name, (run, _) in regret.BASELINES.items():
        start = time.perf_counter()
        values[name] = [run(seed, "cuda") for seed in (1, 2, 3, 4, 5)]
        baseline_walls[name] = time.perf_counter() - start
    parity = regret.baseline_parity(values)
    failures = []
    for name, row in parity.items():
        print(f"algorithms baseline {name}: port {row['port']} vs reference {row['reference']}; "
              f"largest |port - reference| {row['max_abs_diff']:.3g}; one-sided exact "
              f"Mann-Whitney p {row['p']:.4f}; gate {row['gate']}: "
              f"{'held' if row['passed'] else 'FAILED'}; {baseline_walls[name]:.1f} s")
        if not row["passed"]:
            failures.append(name)
    figures["baselines"] = {name: dict(port=row["port"], p=row["p"], passed=row["passed"],
                                       max_abs_diff=row["max_abs_diff"],
                                       wall_s=baseline_walls[name])
                            for name, row in parity.items()}
    if failures:
        raise AssertionError(f"algorithms baselines worse than the JAX reference: {failures}")

    figures["wall_s"] = time.perf_counter() - phase_start
    figures["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - before
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded,
                                                        "algorithms phase")
    print(f"algorithms phase: {figures['wall_s']:.1f} s, peak device memory "
          f"{figures['peak_memory_bytes']} B above the phase's baseline; {_card_line()}")
    return paths, figures


# -- the algorithm extras: L-BFGS-B, early stopping, ensemble, meta-learning ----

# The learning-curve study of the early-stopping rules: 8 parameters, 100
# steps, 250 of 300 trials completed, 50 active at 10-90% of their steps.
_CURVE_PARAMS, _CURVE_STEPS, _CURVE_TRIALS, _CURVE_DONE = 8, 100, 300, 250
# The eagle meta-learning run on bench.py's study: one 10-trial tuning
# round from 1010 completed trials, the best coefficients from 1040.
_META_ROUNDS, _META_COUNT = 6, 10
_META_STATES = ["INITIALIZE", "TUNE", "TUNE", "TUNE", "USE_BEST_PARAMS", "USE_BEST_PARAMS"]
# The ensemble's study: the regret cell's shifted Sphere20d (seed 1) at 150
# uniformly drawn trials; 4 rounds of suggest(5).
_ENSEMBLE_TRIALS, _ENSEMBLE_ROUNDS = 150, 4
# The L-BFGS-B loss gradient on the card against the CPU plain autograd:
# max |card - cpu| over max |cpu|.
_LBFGSB_GRAD_TOL = 1e-3


def _features_work(args, masks, grad):
    """(bytes, operations) of K2 with the first side's feature gradient:
    _work's parameter gradients, plus the feature output written once and,
    per (pair, dim), a subtract and two multiply-adds."""
    x1, inv = args[0], args[5]
    _, (nbytes, ops) = _work(args, masks, grad)
    b, n, m, dc = inv.shape[0], x1.shape[-2], args[2].shape[-2], inv.shape[1]
    return nbytes + x1.numel() * 4, ops + b * n * m * 3 * dc


def _features_only_work(args, masks, grad):
    """(bytes, operations) of K2's feature kernel alone for the first side:
    every input and the incoming gradient read once, the feature output
    written once; per pair and continuous dim a subtract, a multiply and an
    FMA for r^2 and a multiply and an FMA for the sum (5), per categorical
    dim a compare and an add (2), ~17 for r, the Matern factor and the
    mask."""
    x1, z1, x2, z2, amp, inv, inv_sq = args
    b, n, m, dc, ds = amp.shape[0], x1.shape[-2], x2.shape[-2], inv.shape[1], inv_sq.shape[1]
    nbytes = _nbytes(args + masks[:2] + (grad,)) + x1.numel() * 4
    return nbytes, b * n * m * (5 * dc + 2 * ds + 17)


def _library_features_fn(args, masks, grad):
    """The feature gradient of the first side in PyTorch calls, for a shared
    x1 at B=1 with x2's rows masked (L-BFGS-B's layout): r by torch.cdist with
    exact differences, dL/d(r^2) elementwise, then the expansion
    2 inv^2 (x1 sum_m w - w @ x2) as one torch.baddbmm. The port never calls
    it (the kernel keeps exact differences, ROADMAP C2)."""
    x1, _, x2, _, amp, inv, _ = args
    mask2 = masks[1]

    def library():
        r = torch.cdist((x1 * inv)[None], (x2 * inv)[None],
                        compute_mode="donot_use_mm_for_euclid_dist")
        a2 = (amp * amp)[:, None, None]
        w = grad * a2 * (-5.0 / 6.0) * (1.0 + _SQRT5 * r) * torch.exp(-_SQRT5 * r)
        w = torch.where(mask2[None, None, :], w, torch.zeros_like(w))
        gx = torch.baddbmm(x1[None] * w.sum(-1, keepdim=True), w, x2[None], alpha=-1)
        return (gx * (2.0 * inv * inv)[:, None, :])[0]

    return library


def _curve_study(vz):
    """(problem, trials): y_t = f(x)·(1 − e^(−t/τ(x))) + 0.01·noise over
    _CURVE_STEPS steps, f and τ seeded functions of the parameters; the
    first _CURVE_DONE trials completed, the others active."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(_CURVE_TRIALS, _CURVE_PARAMS))
    final = 1.0 - 4.0 * np.mean((x - 0.4) ** 2, axis=1)
    tau = 5.0 + 30.0 * x[:, 1]
    progress = np.linspace(0.1, 0.9, _CURVE_TRIALS - _CURVE_DONE)
    noise = 0.01 * rng.normal(size=(_CURVE_TRIALS, _CURVE_STEPS))
    problem = vz.ProblemStatement()
    for j in range(_CURVE_PARAMS):
        problem.search_space.root.add_float_param(f"p{j}", 0.0, 1.0)
    problem.metric_information.append(
        vz.MetricInformation(name="acc", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
    trials = []
    for i in range(_CURVE_TRIALS):
        t = vz.Trial(id=i + 1, parameters={f"p{j}": float(x[i, j]) for j in range(_CURVE_PARAMS)})
        steps = (_CURVE_STEPS if i < _CURVE_DONE
                 else max(1, int(progress[i - _CURVE_DONE] * _CURVE_STEPS)))
        for step in range(1, steps + 1):
            value = final[i] * (1.0 - np.exp(-step / tau[i])) + noise[i, step - 1]
            t.measurements.append(vz.Measurement(metrics={"acc": float(value)}, steps=step))
        if i < _CURVE_DONE:
            t.complete(vz.Measurement(
                metrics={"acc": t.measurements[-1].metrics["acc"].value}, steps=_CURVE_STEPS))
        trials.append(t)
    return problem, trials


def _early_stop_rules(mods):
    """Both rules polled through an InRamPolicySupporter each, on a fresh
    copy of the curve study, the regression rule twice (its second poll
    must reuse its fit and decide the same). Returns ({rule: decisions},
    {rule: poll walls in s}, (the regression policy, its study's trials))."""
    from vizier_tpu_torch.algorithms import early_stopping

    vz, sc, lps = mods["vz"], mods["study_config"], mods["lps"]
    rules = {
        "median": lambda s: early_stopping.MedianEarlyStopPolicy(s, use_steps=True,
                                                                 min_num_trials=5),
        "regression": lambda s: early_stopping.RegressionEarlyStopPolicy(s, min_num_trials=10),
    }
    decisions, walls = {}, {}
    for rule, make in rules.items():
        problem, trials = _curve_study(vz)
        supporter = lps.InRamPolicySupporter(sc.StudyConfig.from_problem(problem))
        supporter.AddTrials(trials)
        policy = make(supporter)
        polls, fits = [], []
        for _ in range(2 if rule == "regression" else 1):
            start = time.perf_counter()
            result = supporter.EarlyStopTrials(policy)
            walls.setdefault(rule, []).append(time.perf_counter() - start)
            polls.append([(d.id, d.should_stop) for d in result.decisions])
            fits.append(getattr(policy, "_regressor", None))
        if polls[-1] != polls[0] or fits[-1] is not fits[0]:
            raise AssertionError(f"algorithm extras: the {rule} rule's second poll did not "
                                 f"reuse its fit or changed its decisions")
        decisions[rule] = polls[0]
    return decisions, walls, (policy, supporter.GetTrials())


def run_algorithm_extras_phase(kernels, lib, mods, designer):
    """Phase 11: the algorithm layer's last modules on the card. L-BFGS-B
    over the exact path's trained DEFAULT (``designer``'s cached fit, no
    retrain) through K1 and K2's feature gradient, held to the CPU;
    ``DesignerAsOptimizer`` with the eagle designer over the same score; the
    median and regression early-stopping rules on a learning-curve study;
    the eagle meta-learning designer on bench.py's study; the ensemble
    designer over Random, Eagle and the DEFAULT. Then K1/K2 at every launch
    layout the phase made. Returns ({path: launches by mode}, figures, a function that
    times K2's feature gradient at the L-BFGS-B layout into the figures)."""
    from torch.profiler import ProfilerActivity, profile

    from vizier_tpu_torch.benchmarks import regret
    from vizier_tpu_torch.benchmarks.experimenters import experimenter_factory
    from vizier_tpu_torch.designers import eagle_meta_learning, eagle_strategy, ensemble
    from vizier_tpu_torch.designers import gp_ucb_pe, meta_learning
    from vizier_tpu_torch.designers import random as random_designer
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import multitask_gp
    from vizier_tpu_torch.optimizers import lbfgsb_optimizer

    vz = mods["vz"]
    paths, figures = {}, {}
    kernels.LAUNCH_SHAPES = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    phase_start = time.perf_counter()

    # 1. L-BFGS-B over the DEFAULT's UCB with its trust region, on the fit
    # the exact path's last (profiled) request cached.
    if designer._cached_states is None:
        raise AssertionError("algorithm extras: the exact path left no trained fit")
    (state,), (data,) = designer._cached_states

    def scoring_on(st, dt):
        return acquisitions.ScoringFunction(
            predictive=gp_lib.EnsemblePredictive(st),
            acquisition=acquisitions.UCB(designer.config.ucb_coefficient),
            best_label=acquisitions.get_best_labels(dt.labels, dt.row_mask),
            trust_region=acquisitions.TrustRegion.from_data(dt))

    scoring = scoring_on(state, data)
    cpu_state = _cpu_state(state, gp_lib, multitask_gp)
    cpu_scoring = scoring_on(cpu_state, cpu_state.data)
    opt = lbfgsb_optimizer.LBFGSBOptimizer()
    z0 = opt.restart_draws(torch.Generator(device="cuda").manual_seed(0), _DIM)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = opt(scoring.score, num_continuous=_DIM, count=_COUNT, z0=z0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    paths["algorithm_extras_lbfgsb"] = counts = {
        k: dict(v) for k, v in kernels.LAUNCHES_BY_MODE.items()}
    points = result.features.continuous.cpu()
    if not (bool(torch.isfinite(points).all()) and bool(((points >= 0) & (points <= 1)).all())):
        raise AssertionError(f"algorithm extras: L-BFGS-B points outside [0, 1]^{_DIM}")
    cpu_scores = cpu_scoring.score(kernels.MixedFeatures(
        points, torch.zeros((_COUNT, 0), dtype=torch.int32)))
    score_errs = [_score_close(f"algorithm extras L-BFGS-B point {i}", float(card), float(cpu))
                  for i, (card, cpu) in enumerate(zip(result.scores.cpu(), cpu_scores))]
    grads = {}
    for where, fn, z in (("card", scoring.score, z0), ("cpu", cpu_scoring.score, z0.cpu())):
        zz = z.clone().requires_grad_(True)
        (grads[where],) = torch.autograd.grad(opt.loss_fn(fn)(zz).sum(), zz)
    grad_rel, grad_err = _rel_err(grads["card"].cpu(), grads["cpu"])
    print(f"algorithm extras L-BFGS-B loss gradient at the {opt.num_restarts} starting points, "
          f"card vs CPU plain autograd: max_abs_err={grad_err:.3e} max_rel_err={grad_rel:.3e} "
          f"(tol {_LBFGSB_GRAD_TOL})")
    if not grad_rel <= _LBFGSB_GRAD_TOL:
        raise AssertionError("algorithm extras: the L-BFGS-B gradient on the card disagrees "
                             "with the CPU plain path")
    # The GP's parameters are constants here: every K2 launch must be the
    # feature kernel alone.
    k2_modes = counts["matern52_ard_bwd"]
    if k2_modes["features_only"] <= 0 or sum(k2_modes.values()) != k2_modes["features_only"]:
        raise AssertionError(f"algorithm extras: L-BFGS-B's K2 launches were not all the "
                             f"feature kernel alone: {k2_modes}")
    # One more run, profiled: eager launches and the device time of each of
    # K2's kernels (the feature kernel only, on this path).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt(scoring.score, num_continuous=_DIM, count=_COUNT, z0=z0)
        torch.cuda.synchronize()
    totals = _device_activity(prof)
    k2_ms = {name: round(us / 1e3, 4) for name, (_, us) in totals.items()
             if "matern52_bwd" in name}
    busy_ms = sum(us for _, us in totals.values()) / 1e3
    eager = sum(n for n, _ in totals.values())
    # The eagle sweep's best UCB at the same state, for comparison only.
    start = time.perf_counter()
    sweep = designer._vec_opt(scoring.score, torch.Generator(device="cuda").manual_seed(0),
                              count=1)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - start
    figures["lbfgsb"] = dict(
        wall_ms=wall * 1e3, launches=counts, scores=[float(v) for v in result.scores],
        max_score_err=max(score_errs), grad_max_rel_err=grad_rel, eager_launches=eager,
        device_busy_ms=busy_ms, k2_kernels_ms=k2_ms, eagle_best_ucb=float(sweep.scores[0]),
        eagle_wall_ms=sweep_wall * 1e3)
    print(f"algorithm extras L-BFGS-B ({opt.num_restarts} restarts, maxiter {opt.maxiter}) over "
          f"the exact path's trained UCB: {wall * 1e3:.1f} ms, best {_COUNT} scores "
          f"{[round(v, 5) for v in figures['lbfgsb']['scores']]}, launches by mode {counts}; "
          f"profiled: {eager} device launches, device busy {busy_ms:.1f} ms, K2's kernels (ms) "
          f"{k2_ms}; eagle sweep's best UCB at the same state {float(sweep.scores[0]):.5f} "
          f"({sweep_wall * 1e3:.1f} ms)")

    # K2 at the L-BFGS-B layout: the feature kernel alone (what the path
    # launches), with the parameters, parameters only, the plain versions and
    # the library form.
    gen = torch.Generator(device="cuda").manual_seed(6)
    mask2 = state.data.row_mask
    args = (torch.rand((opt.num_restarts, _DIM), generator=gen, device="cuda"),
            torch.zeros((opt.num_restarts, 0), dtype=torch.int32, device="cuda"),
            state.data.continuous, state.data.categorical,
            state.params["amplitude"].contiguous(),
            (1.0 / state.params["continuous_length_scales"]).contiguous(),
            torch.zeros((1, 0), device="cuda"))
    masks = (None, mask2, None)
    grad = torch.randn((1, opt.num_restarts, mask2.shape[0]), generator=gen, device="cuda")
    want = kernels.matern52_ard_features_plain(grad, *args, *masks[:2], need_x2=False)[0]
    feature_errs = {}
    for mode, run in (("features", dict(need_x1=True)),
                      ("features only", dict(need_params=False, need_x1=True))):
        got, again = (kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2], **run)[3]
                      for _ in range(2))
        rel, feature_errs[mode] = _rel_err(got, want)
        print(f"K2 ({mode}) feature gradient at {_LBFGSB_FEATURES}: max_abs_err "
              f"{feature_errs[mode]:.3e} (rel {rel:.3e}, tol {_BWD_TOL}), repeat "
              f"{'bit-identical' if torch.equal(got, again) else 'DIFFERENT'}")
        if not (rel <= _BWD_TOL and torch.equal(got, again)):
            raise AssertionError(f"K2's feature gradient ({mode}) disagrees with its plain "
                                 f"version or between runs at {_LBFGSB_FEATURES}")
    library = _library_features_fn(args, masks, grad)
    library_rel, library_err = _rel_err(library(), want)
    if not library_rel <= _FWD_WIDE_TOL:
        raise AssertionError(f"the library form of the feature gradient disagrees with the "
                             f"plain version at {_LBFGSB_FEATURES}: rel {library_rel:.3e}")
    nbytes, ops = _features_work(args, masks, grad)
    only_bytes, only_ops = _features_only_work(args, masks, grad)
    figures["k2_features"] = dict(
        shape=_LBFGSB_FEATURES, launches=k2_modes["features_only"],
        max_abs_err=feature_errs["features only"],
        max_abs_err_with_params=feature_errs["features"], library_max_abs_err=library_err,
        bound=_bound(nbytes, ops), features_only_bound=_bound(only_bytes, only_ops))

    def time_features():
        """Times K2 at this layout; called once the worker processes have
        ended, so the card runs nothing else."""
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: the library form would not be float32")
        k2f = figures["k2_features"]
        k2f.update(
            features_only_ms=_device_ms(lambda: kernels.matern52_ard_bwd_cuda(
                grad, *args, *masks[:2], need_params=False, need_x1=True)),
            ms=_device_ms(lambda: kernels.matern52_ard_bwd_cuda(grad, *args, *masks[:2],
                                                                need_x1=True)),
            params_only_ms=_device_ms(lambda: kernels.matern52_ard_bwd_cuda(grad, *args,
                                                                            *masks[:2])),
            library_ms=_device_ms(library),
            features_only_plain_ms=_device_ms(lambda: kernels.matern52_ard_features_plain(
                grad, *args, *masks[:2], need_x2=False), 3, 2),
            plain_ms=_device_ms(lambda: kernels.matern52_ard_bwd_plain(grad, *args, *masks[:2]),
                                3, 2))
        (bound, by), (only_bound, only_by) = k2f["bound"], k2f["features_only_bound"]
        print(f"matern52_ard_bwd feature kernel alone [{_LBFGSB_FEATURES}]: device "
              f"{k2f['features_only_ms']:.5f} ms/launch, plain "
              f"{k2f['features_only_plain_ms']:.4f} ms, library (cdist + baddbmm) "
              f"{k2f['library_ms']:.5f} ms, bound {only_bound:.6f} ms by {only_by} "
              f"({k2f['features_only_ms'] / only_bound:.0f}x); {k2f['launches']} launches on the "
              f"L-BFGS-B path")
        print(f"matern52_ard_bwd with parameters and feature gradient [{_LBFGSB_FEATURES}]: "
              f"device {k2f['ms']:.5f} ms/launch (parameters only {k2f['params_only_ms']:.5f}), "
              f"plain {k2f['plain_ms']:.4f} ms, bound {bound:.6f} ms by {by}")

    # 2. DesignerAsOptimizer: the eagle designer's mini-study over the score.
    def score_suggestions(suggestions):
        return [float(v) for v in scoring.score(designer._encode_suggestions(suggestions)).cpu()]

    as_opt = lbfgsb_optimizer.DesignerAsOptimizer(
        lambda p: eagle_strategy.EagleStrategyDesigner(p, seed=0))
    start = time.perf_counter()
    best = as_opt.optimize(score_suggestions, designer.problem, count=_COUNT)
    as_wall = time.perf_counter() - start
    regret.check_suggestions(best, designer.problem, "algorithm extras DesignerAsOptimizer")
    figures["designer_as_optimizer"] = dict(
        wall_ms=as_wall * 1e3, best_score=score_suggestions(best[:1])[0],
        evaluations=as_opt.num_rounds * as_opt.batch_size + 1)
    print(f"algorithm extras DesignerAsOptimizer (EagleStrategyDesigner, {as_opt.num_rounds} "
          f"rounds x {as_opt.batch_size}): {as_wall * 1e3:.1f} ms, best UCB "
          f"{figures['designer_as_optimizer']['best_score']:.5f}")

    # 3. The early-stopping rules, twice each on fresh supporters.
    decisions, walls, (policy, trials) = _early_stop_rules(mods)
    again, _, _ = _early_stop_rules(mods)
    if again != decisions:
        raise AssertionError("algorithm extras: the early-stopping decisions differ between "
                             "two runs of the same rules")
    completed = [t for t in trials if t.is_completed]
    median = float(np.median([t.final_measurement.metrics["acc"].value for t in completed]))
    stopped = {tid for tid, stop in decisions["regression"] if stop}
    for t in trials:
        if t.id in stopped and not policy._regressor.predict(t) < median:
            raise AssertionError(f"algorithm extras: trial {t.id} stopped with a predicted "
                                 f"final at or above the completed median {median}")
    figures["early_stopping"] = {
        rule: dict(polled=len(d), stopped=sum(stop for _, stop in d),
                   poll_ms=[w * 1e3 for w in walls[rule]]) for rule, d in decisions.items()}
    print(f"algorithm extras early stopping ({_CURVE_DONE} completed and "
          f"{_CURVE_TRIALS - _CURVE_DONE} active trials x {_CURVE_STEPS} steps): "
          f"{figures['early_stopping']}; regression's second poll reused its fit; both rules' "
          f"decisions equal on a second run")

    # 4. Eagle meta-learning on bench.py's study.
    meta = eagle_meta_learning.eagle_meta_learning_designer(
        _bench_problem(vz), config=meta_learning.MetaLearningConfig(
            tuning_interval=10, tuning_min_num_trials=_NUM_TRIALS + 10,
            tuning_max_num_trials=_NUM_TRIALS + 40), seed=0)
    meta.update(vz.CompletedTrials(_bench_trials(vz, _NUM_TRIALS, _DIM)), vz.ActiveTrials())
    states, meta_walls, next_id = [], [], _NUM_TRIALS + 1
    for _ in range(_META_ROUNDS):
        states.append(meta.state)
        start = time.perf_counter()
        batch = meta.suggest(_META_COUNT)
        meta_walls.append(time.perf_counter() - start)
        _check_suggestions(batch, "algorithm extras meta-learning")
        done = []
        for s in batch:
            t = s.to_trial(next_id)
            next_id += 1
            t.complete(vz.Measurement(metrics=_bench_objective(np.array(
                [t.parameters.get_value(f"x{j}") for j in range(_DIM)]))))
            done.append(t)
        meta.update(vz.CompletedTrials(done), vz.ActiveTrials())
    figures["meta_learning"] = dict(states=states, wall_ms=[w * 1e3 for w in meta_walls],
                                    meta_trials=len(meta._meta_trials))
    print(f"algorithm extras eagle meta-learning: states {states}, suggest({_META_COUNT}) walls "
          f"{[round(w * 1e3, 1) for w in meta_walls]} ms, {len(meta._meta_trials)} scored "
          f"coefficient sets")
    if states != _META_STATES:
        raise AssertionError(f"algorithm extras: meta-learning states {states}, not "
                             f"{_META_STATES}")

    # 5. The ensemble over Random, Eagle and the DEFAULT on shifted Sphere20d.
    exp = experimenter_factory.shifted_bbob_instance("Sphere", 1, dim=_DIM)
    problem = exp.problem_statement()
    rng = np.random.default_rng(1)
    base = []
    for i in range(_ENSEMBLE_TRIALS):
        base.append(vz.Trial(id=i + 1, parameters={
            c.name: float(rng.uniform(*c.bounds)) for c in problem.search_space.parameters}))
    exp.evaluate(base)
    # The DEFAULT is arm 0: while no pick beats the incumbent the arms stay
    # equally likely, and seed 0's first four draws are arms 1, 0, 0, 0 (with
    # Random first, the DEFAULT would never be drawn).
    arms = {"default": gp_ucb_pe.VizierGPUCBPEBandit(problem, rng_seed=1),
            "random": random_designer.RandomDesigner(problem.search_space, seed=1),
            "eagle": eagle_strategy.EagleStrategyDesigner(problem, seed=1)}
    ens = ensemble.EnsembleDesigner(problem, designers=arms, seed=0)
    ens.update(vz.CompletedTrials(base), vz.ActiveTrials())
    sequence, ens_walls, gp_counts, next_id = [], [], {}, _ENSEMBLE_TRIALS + 1
    for _ in range(_ENSEMBLE_ROUNDS):
        kernels.reset_launch_counts()
        start = time.perf_counter()
        batch = ens.suggest(_COUNT)
        torch.cuda.synchronize()
        ens_walls.append(time.perf_counter() - start)
        arm = batch[0].metadata.ns("ensemble")["expert"]
        sequence.append(arm)
        if arm == "default":
            for name, modes in kernels.LAUNCHES_BY_MODE.items():
                for mode, n in modes.items():
                    gp_counts.setdefault(name, {}).setdefault(mode, 0)
                    gp_counts[name][mode] += n
        done = [s.to_trial(next_id + i) for i, s in enumerate(batch)]
        next_id += len(done)
        regret.check_suggestions(done, problem, f"algorithm extras ensemble arm {arm}")
        exp.evaluate(done)
        ens.update(vz.CompletedTrials(done), vz.ActiveTrials())
    paths["algorithm_extras_ensemble_gp_arm"] = gp_counts or {
        k: {m: 0 for m in v} for k, v in kernels.LAUNCHES_BY_MODE.items()}
    figures["ensemble"] = dict(arms=sequence, wall_ms=[w * 1e3 for w in ens_walls],
                               gp_arm_launches=gp_counts,
                               probabilities=[float(p) for p in ens.design.probabilities])
    print(f"algorithm extras EnsembleDesigner (EXP3-IX, seed 0) on shifted Sphere20d at "
          f"{_ENSEMBLE_TRIALS} trials: arms {sequence}, suggest({_COUNT}) walls "
          f"{[round(w * 1e3, 1) for w in ens_walls]} ms, the DEFAULT arm's launches "
          f"{gp_counts}, final arm probabilities "
          f"{[round(p, 4) for p in figures['ensemble']['probabilities']]}")

    figures["wall_s"] = time.perf_counter() - phase_start
    figures["peak_memory_bytes"] = torch.cuda.max_memory_allocated() - before
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded,
                                                        "algorithm extras phase")
    print(f"algorithm extras phase: {figures['wall_s']:.1f} s, peak device memory "
          f"{figures['peak_memory_bytes']} B above the phase's baseline; {_card_line()}")
    return paths, figures, time_features



# The service-reliability phase: the objects the port's serving runtime owns
# since the service layer was ported (the coalescer, the per-study circuit
# breakers, the deadline and the seeded quasi-random fallback), driven without
# protobuf around the DEFAULT policy on the card, through the same runtime and
# factory path as the serving phases, at bench.py's study (1000 trials x 20
# floats, so the runtime's SurrogateConfig puts the DEFAULT on its sparse
# path). The gRPC servicers that wrap them are held to the JAX package on the
# CPU only: the GPU machine has neither grpc nor protobuf.
_SVC_THREADS = 8
_SVC_FAILURES = 3  # ReliabilityConfig().breaker_failure_threshold
_SVC_COOLDOWN_S = 1.0
# Trial data seeds of the two studies (_serving_trials' rng seed).
_SVC_SEEDS = {"coalesced": 101, "breaker": 102}


def run_service_reliability_phase(kernels, lib, mods):
    """Phase 12: the serving runtime's reliability objects on the card.

    1. Coalescing: 8 threads ask one study's DEFAULT policy for
       ``suggest(5)`` at one frontier through ``runtime.coalescer.coalesce``,
       keyed as the Pythia servicer keys (``coalescer.suggest_key``), each
       computation through ``runtime.guarded_suggest`` as the servicer's.
       Exactly one designer computation (1 leader, 7 followers) and 8 equal
       suggestion sets, none stamped as a fallback.
    2. Breaker and fallback: a second study's computation is made to raise
       ``_SVC_FAILURES`` times (each degrades to 5 stamped quasi-random
       suggestions); the breaker opens; the next request is short-circuited
       without a computation and served 5 stamped suggestions equal, value for
       value, to ``suggest_fallback`` recomputed on the host for the same
       study name and frontier; after the cooldown a half-open probe runs the
       real DEFAULT on the card and closes the breaker.
    3. Deadline: a budget shorter than the wait before dispatch raises the
       typed error at ``check`` and ends the request before dispatch, with no
       computation and no kernel launch.
    The fallback, short-circuit, failure and deadline counters must equal the
    injected cases exactly, and every request not meant to fail must be
    served by the designer: a DEFAULT that fails on the device fails the run.
    Then K1/K2 at every launch layout the phase recorded. Returns ({path:
    launches by mode}, figures)."""
    from vizier_tpu_torch import reliability
    from vizier_tpu_torch.serving import coalescer as coalescer_lib

    vz, serving, policy_lib = mods["vz"], mods["serving"], mods["policy"]
    paths, figures = {}, {}
    kernels.LAUNCH_SHAPES = set()
    phase_start = time.perf_counter()
    runtime = serving.ServingRuntime(
        serving.ServingConfig(),
        reliability=reliability.ReliabilityConfig(breaker_cooldown_secs=_SVC_COOLDOWN_S))
    factory = mods["policy_factory"].DefaultPolicyFactory(runtime, device="cuda")
    computations = []

    def study(kind):
        name = f"owners/smoke/studies/service-{kind}"
        config = _serving_config(mods["study_config"], vz, "DEFAULT")
        supporter = mods["lps"].InRamPolicySupporter(config, study_guid=name)
        supporter.AddTrials(_serving_trials(vz, _SVC_SEEDS[kind], _NUM_TRIALS))
        return name, config, supporter

    def request(name, config, supporter, *, inject=False, deadline=None):
        """One suggest(5) as the Pythia servicer computes it."""
        descriptor = supporter.study_descriptor()

        def compute():
            computations.append(name)
            if inject:
                raise RuntimeError("injected designer failure")
            policy = factory(config, config.algorithm, supporter, name)
            return policy.suggest(
                policy_lib.SuggestRequest(study_descriptor=descriptor, count=_COUNT))

        def fallback(reason):
            return reliability.suggest_fallback(
                config.to_problem(), _COUNT, study_name=name,
                max_trial_id=descriptor.max_trial_id, reason=reason)

        return runtime.guarded_suggest(name, compute, fallback, deadline)

    def served(outcome, label):
        """The designer's suggestions; raises on an error or a fallback."""
        if outcome.error is not None or outcome.decision is None:
            raise AssertionError(f"service-reliability {label}: not served by the designer: "
                                 f"error {outcome.error!r}, {len(outcome.fallbacks)} fallbacks")
        suggestions = outcome.decision.suggestions
        if len(suggestions) != _COUNT:
            raise AssertionError(f"service-reliability {label}: {len(suggestions)} suggestions")
        _check_suggestions(suggestions, f"service-reliability {label}")
        if any(reliability.is_fallback_suggestion(s.metadata) for s in suggestions):
            raise AssertionError(f"service-reliability {label}: a fallback stamp")
        return suggestions

    def values(suggestions):
        return [[s.parameters.get_value(f"x{j}") for j in range(_DIM)] for s in suggestions]

    # 1. Coalescing.
    coalesced_study = study("coalesced")
    name, config, supporter = coalesced_study
    key = coalescer_lib.suggest_key(
        name, hashlib.sha1(repr(config.search_space.parameter_names()).encode()).hexdigest()[:16],
        config.algorithm, supporter.study_descriptor().max_trial_id, _COUNT)
    outs, errors = [None] * _SVC_THREADS, []
    barrier = threading.Barrier(_SVC_THREADS)

    def run(i):
        try:
            barrier.wait()
            outs[i] = runtime.coalescer.coalesce(
                key, lambda: request(name, config, supporter), span_name="pythia.suggest_compute")
        except BaseException as e:  # surfaced below
            errors.append(e)

    def coalesced():
        threads = [threading.Thread(target=run, args=(i,)) for i in range(_SVC_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    before = runtime.stats.snapshot()
    _, wall, launches = _path_launches(kernels, coalesced)
    if errors:
        raise errors[0]
    after = runtime.stats.snapshot()
    delta = {k: after[k] - before[k] for k in ("coalesced_requests", "coalesced_computations",
                                               "cold_trains", "warm_trains")}
    sets = [values(served(out, f"coalesced request {i}")) for i, out in enumerate(outs)]
    if computations != [name] or delta["coalesced_requests"] != _SVC_THREADS - 1 or (
            delta["coalesced_computations"] != 1):
        raise AssertionError(f"service-reliability: {_SVC_THREADS} coalesced requests made "
                             f"computations {computations}, counters {delta}")
    if any(v != sets[0] for v in sets):
        raise AssertionError("service-reliability: the coalesced answers differ")
    paths["service_reliability_coalesced"] = launches
    figures["coalesced"] = dict(wall_ms=wall * 1e3, counters=delta, launches=launches)
    print(f"service-reliability coalescing: {_SVC_THREADS} threads, suggest(count={_COUNT}) at "
          f"{_NUM_TRIALS} trials x {_DIM}-D, wall {wall * 1e3:.1f} ms, 1 designer computation "
          f"(leader 1, followers {delta['coalesced_requests']}), trains cold "
          f"{delta['cold_trains']} warm {delta['warm_trains']}, {_SVC_THREADS} equal answers, no "
          f"fallback stamp; the leader's launches {launches}")

    # 2. Breaker and fallback.
    name, config, supporter = study("breaker")
    breaker = runtime.breakers.get(name)
    transitions = [breaker.state]
    before = runtime.stats.snapshot()
    computations.clear()
    for k in range(_SVC_FAILURES):
        out = request(name, config, supporter, inject=True)
        transitions.append(breaker.state)
        if out.error is not None or len(out.fallbacks) != _COUNT or not all(
                s.metadata.ns("reliability").get("fallback_reason") == "designer_error:RuntimeError"
                for s in out.fallbacks):
            raise AssertionError(f"service-reliability: injected failure {k} was not degraded "
                                 f"to {_COUNT} stamped fallbacks: {out}")
    if breaker.state != "open" or len(computations) != _SVC_FAILURES:
        raise AssertionError(f"service-reliability: after {_SVC_FAILURES} failures the breaker "
                             f"is {breaker.state}, computations {len(computations)}")
    out = request(name, config, supporter)
    max_id = supporter.study_descriptor().max_trial_id
    host = reliability.suggest_fallback(config.to_problem(), _COUNT, study_name=name,
                                        max_trial_id=max_id, reason="circuit_open")
    if len(computations) != _SVC_FAILURES or out.decision is not None or not all(
            reliability.is_fallback_suggestion(s.metadata) for s in out.fallbacks) or (
            values(out.fallbacks) != values(host)):
        raise AssertionError("service-reliability: the open circuit did not short-circuit to "
                             "the host's stamped fallback suggestions")
    time.sleep(_SVC_COOLDOWN_S)
    probe, probe_wall, probe_launches = _path_launches(kernels, lambda: request(
        name, config, supporter))
    transitions.append(breaker.state)
    served(probe, "half-open probe")
    after = runtime.stats.snapshot()
    counters = {k: after[k] - before[k] for k in (
        "designer_failures", "fallbacks", "breaker_short_circuits", "breaker_open_transitions",
        "breaker_half_open_transitions", "breaker_close_transitions")}
    want = {"designer_failures": _SVC_FAILURES, "fallbacks": (_SVC_FAILURES + 1) * _COUNT,
            "breaker_short_circuits": 1, "breaker_open_transitions": 1,
            "breaker_half_open_transitions": 1, "breaker_close_transitions": 1}
    if counters != want or breaker.state != "closed":
        raise AssertionError(f"service-reliability: breaker counters {counters}, want {want}; "
                             f"state {breaker.state}")
    coalesced_total = sum(sum(m.values()) for m in launches.values())
    probe_total = sum(sum(m.values()) for m in probe_launches.values())
    if not 0 < coalesced_total <= 1.5 * probe_total:
        raise AssertionError(f"service-reliability: the coalesced run launched {coalesced_total} "
                             f"kernels against one request's {probe_total}")
    paths["service_reliability_probe"] = probe_launches
    figures["breaker"] = dict(transitions=transitions, counters=counters,
                              probe_wall_ms=probe_wall * 1e3, probe_launches=probe_launches,
                              fallback_values_equal_host=True)
    print(f"service-reliability breaker: states {transitions}; counters {counters}; the open "
          f"circuit served {_COUNT} stamped fallbacks equal to the host's at max_trial_id "
          f"{max_id}; the half-open probe (the DEFAULT on the card) {probe_wall * 1e3:.1f} ms, "
          f"launches {probe_launches}; K1+K2 launches coalesced {coalesced_total} vs one "
          f"request {probe_total}")

    # 3. Deadline.
    name, config, supporter = coalesced_study
    deadline = reliability.Deadline.from_budget(0.05)
    time.sleep(0.1)
    try:
        deadline.check("smoke")
        raise AssertionError("service-reliability: an expired deadline did not raise at check")
    except reliability.DeadlineExceededError:
        pass
    before = runtime.stats.snapshot()
    computations.clear()
    out, _, dl_launches = _path_launches(kernels, lambda: request(
        name, config, supporter, deadline=deadline))
    after = runtime.stats.snapshot()
    dispatched = sum(sum(m.values()) for m in dl_launches.values())
    if not isinstance(out.error, reliability.DeadlineExceededError) or computations or dispatched or (
            after["deadline_exceeded"] - before["deadline_exceeded"] != 1) or out.fallbacks:
        raise AssertionError(f"service-reliability: the expired deadline was not refused before "
                             f"dispatch: {out}, computations {computations}, launches {dispatched}")
    figures["deadline"] = dict(error=str(out.error).splitlines()[0])
    print(f"service-reliability deadline: {str(out.error).splitlines()[0]} (no computation, no "
          f"launch)")

    # Nothing else was served by the fallback: only the injected cases.
    totals = runtime.snapshot()
    if totals["fallbacks"] != (_SVC_FAILURES + 1) * _COUNT or totals["designer_failures"] != (
            _SVC_FAILURES) or totals["breaker_short_circuits"] != 1:
        raise AssertionError(f"service-reliability: fallbacks beyond the injected cases: {totals}")
    runtime.shutdown()
    figures["wall_s"] = time.perf_counter() - phase_start
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded,
                                                        "service-reliability phase")
    print(f"service-reliability phase: {figures['wall_s']:.1f} s; {_card_line()}")
    return paths, figures


# The service-planes phase: the serving runtime's opt-in planes, armed
# together in one ServingRuntime around the DEFAULT on the card, at the
# service-reliability phase's study shape (bench.py's 1000 trials x 20 floats
# from _serving_trials, so SurrogateConfig() puts the DEFAULT on its sparse
# path), through the protobuf-free entries the gRPC Pythia servicer adapts.
# Two designer computations in all: tenant a's cold live request and the
# speculative job that parks its next batch.
_PLANES_SEED = 103
_PLANES_STUDY = "owners/a/studies/service-planes"
_PLANES_SHED_STUDY = "owners/b/studies/service-planes"
_PLANES_LOW_STUDY = "owners/low/studies/service-planes"
# Tenant b is shed while a holds the only slot: three sheds escalate the
# overload state machine to DEGRADED (min_decisions 4, degrade_rate 0.5),
# then "low" (weight 0.5, under the degraded floor 1.0) is served the stamped
# quasi-random fallback, b is shed once more, and "low" is degraded once more
# after a's computation, with its launches counted.
_PLANES_SHEDS_BEFORE, _PLANES_SHEDS_AFTER = 3, 1
_PLANES_HIT_WALL_S = 0.05
_PLANES_SLO_P99_MS = 1000.0


def run_service_planes_phase(kernels, lib, mods):
    """Phase 13: admission, speculative pre-compute, the SLO engine and the
    flight recorder on the card, through one ``ServingRuntime`` and
    ``DefaultPolicyFactory(device="cuda")``.

    1. Admission (``max_inflight=1``): tenant a's live ``suggest(5)`` is
       admitted; while it holds the slot, tenant b's requests are shed with
       ``AdmissionShedError`` and its retry-after hint, three sheds escalate
       the state machine to DEGRADED, and the low-weight tenant is served 5
       stamped quasi-random points equal to the host's. No shed or degraded
       request computes or launches a kernel; every counter equals the
       injected cases.
    2. Speculation: the 5 picks are completed and the completion enqueues one
       speculative job, which runs on the executor's deferrable lane (a warm
       sparse computation on the card). After ``wait_idle`` exactly one batch
       is parked and none failed, was superseded or dropped: a speculative
       failure fails the run. The next ``suggest(5)`` at that frontier is
       served from the slot, stamped ``speculative=hit``, equal to the parked
       batch, with 0 launches and a host wall under 50 ms. The served batch
       is parked again and one more completion moves the frontier:
       ``try_serve`` refuses the stale slot and drops it.
    3. SLO and recorder: a p99 objective of 1 s, which the cold request
       misses, breaches; the black-box dump holds the exemplar trace ids with
       their spans, the recorder rings and a metrics snapshot. The recorder
       holds, in time order, the suggest served, the job's ``batch_flush``,
       the speculation parked and the speculation served.
       ``prometheus_text()`` holds the ``vizier_slo_*``, speculative and
       admission series; ``fleet.dump_process`` writes the three files and
       ``fleet.load_fleet_dir`` reads them back.
    Then K1/K2 at every launch layout the phase recorded. Returns ({path:
    launches by mode}, figures)."""
    from vizier_tpu_torch import reliability
    from vizier_tpu_torch.observability import fleet
    from vizier_tpu_torch.observability import flight_recorder
    from vizier_tpu_torch.observability import slo
    from vizier_tpu_torch.observability import tracing
    from vizier_tpu_torch.serving import admission
    from vizier_tpu_torch.serving import runtime as runtime_lib
    from vizier_tpu_torch.serving import speculative

    vz, serving, policy_lib = mods["vz"], mods["serving"], mods["policy"]
    paths, figures = {}, {}
    kernels.LAUNCH_SHAPES = set()
    phase_start = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="service-planes-")
    # The recorder switch, as a deployment sets it; restored at the end.
    switch = os.environ.get("VIZIER_TORCH_FLIGHT_RECORDER")
    os.environ["VIZIER_TORCH_FLIGHT_RECORDER"] = "1"
    previous_recorder = flight_recorder.set_recorder(None)
    recorder = flight_recorder.get_recorder()
    tracer = tracing.get_tracer()
    runtime = serving.ServingRuntime(
        serving.ServingConfig(),
        # The first request crosses exact -> sparse, and the crossover
        # forgets the study's recent counts: the job speculates the
        # default count, the client's.
        speculative=speculative.SpeculativeConfig(speculative=True, default_count=_COUNT),
        admission=admission.AdmissionConfig(
            enabled=True, max_inflight=1, tenant_inflight=1, weights=(("low", 0.5),),
            window_s=600.0, min_decisions=4),
        slo=slo.SloConfig(enabled=True, windows=(60.0,), eval_interval_s=0.0,
                          suggest_p99_ms=_PLANES_SLO_P99_MS, min_samples=1,
                          dump_dir=os.path.join(workdir, "blackbox")))
    if not (recorder.enabled and runtime.flight_recorder is recorder and runtime.admission
            and runtime.speculative_engine and runtime.slo_engine):
        raise AssertionError("service-planes: a plane was not built")
    factory = mods["policy_factory"].DefaultPolicyFactory(runtime, device="cuda")
    config = _serving_config(mods["study_config"], vz, "DEFAULT")
    supporter = mods["lps"].InRamPolicySupporter(config, study_guid=_PLANES_STUDY)
    supporter.AddTrials(_serving_trials(vz, _PLANES_SEED, _NUM_TRIALS))
    spec_bytes = repr(config).encode()
    injected, computations = [], []

    def fallback_for(name):
        def fallback(reason):
            return reliability.suggest_fallback(
                config.to_problem(), _COUNT, study_name=name,
                max_trial_id=supporter.study_descriptor().max_trial_id, reason=reason)
        return fallback

    def refused(name):
        def live():
            raise AssertionError(f"service-planes: {name} was computed past the admission gate")
        return live

    def inject(tenant_study, times):
        for _ in range(times):
            injected.append((tenant_study, runtime.admitted_suggest(
                tenant_study, refused(tenant_study), fallback_for(tenant_study))))

    def compute(count):
        """Tenant a's designer computation; the live request's first injects
        the other tenants' requests while it holds the admission slot."""
        if not speculative.in_speculative_compute() and not injected:
            before = sum(sum(m.values()) for m in kernels.LAUNCHES_BY_MODE.values())
            inject(_PLANES_SHED_STUDY, _PLANES_SHEDS_BEFORE)
            inject(_PLANES_LOW_STUDY, 1)
            inject(_PLANES_SHED_STUDY, _PLANES_SHEDS_AFTER)
            torch.cuda.synchronize()
            figures["launches_while_gated"] = sum(
                sum(m.values()) for m in kernels.LAUNCHES_BY_MODE.values()) - before
        computations.append("speculative" if speculative.in_speculative_compute() else "live")
        descriptor = supporter.study_descriptor()
        return factory(config, config.algorithm, supporter, _PLANES_STUDY).suggest(
            policy_lib.SuggestRequest(study_descriptor=descriptor, count=count))

    def live(count=_COUNT):
        """The Pythia servicer's order below the speculative check."""
        fallback = fallback_for(_PLANES_STUDY)
        return runtime.admitted_suggest(_PLANES_STUDY, lambda: runtime.guarded_suggest(
            _PLANES_STUDY, lambda: compute(count), fallback), fallback)

    def frontier():
        trials = supporter.GetTrials()
        return speculative.make_fingerprint(
            spec_bytes, [t.id for t in trials if t.status == vz.TrialStatus.COMPLETED],
            [t.id for t in trials if t.status == vz.TrialStatus.ACTIVE])

    runtime.bind_speculative(
        lambda study: (frontier(), supporter.study_descriptor().max_trial_id),
        lambda study, count, max_trial_id: live(count), runtime_lib.accept_guarded)

    def request():
        """One Pythia suggest: its span, the speculative check, its latency
        observation and the service hop's recorder event."""
        start = time.perf_counter()
        with tracer.span("pythia.suggest", study=_PLANES_STUDY, count=_COUNT) as span:
            out = runtime.speculative_suggest(
                _PLANES_STUDY, _COUNT, frontier, live, runtime_lib.stamp_speculative_hit,
                lambda o: o.error is None)
            trace_id = getattr(span, "trace_id", None)
        elapsed = time.perf_counter() - start
        runtime.observe_suggest_latency("pythia", elapsed, trace_id=trace_id)
        recorder.record(_PLANES_STUDY, "suggest", trace_id=trace_id, duration_secs=round(
            elapsed, 6), error=out.error is not None)
        return out

    def complete(suggestions):
        for s in suggestions:
            t = s.to_trial()
            x = np.array([s.parameters.get_value(f"x{j}") for j in range(_DIM)])
            t.complete(vz.Measurement(metrics=_bench_objective(x)))
            supporter.AddTrials([t])

    def launches_total(launches):
        return sum(sum(m.values()) for m in launches.values())

    # 1. Admission around the live request.
    cold, cold_wall, cold_launches = _path_launches(kernels, request)
    if cold.error is not None or cold.decision is None or len(cold.suggestions) != _COUNT:
        raise AssertionError(f"service-planes: the live request was not served: {cold.error!r}")
    _check_suggestions(cold.suggestions, "service-planes live")
    if any(reliability.is_fallback_suggestion(s.metadata) for s in cold.suggestions):
        raise AssertionError("service-planes: the live request carries a fallback stamp")
    sheds = [o for n, o in injected if n == _PLANES_SHED_STUDY]
    low = [o for n, o in injected if n == _PLANES_LOW_STUDY]
    late_low, late_wall, late_launches = _path_launches(kernels, lambda: runtime.admitted_suggest(
        _PLANES_LOW_STUDY, refused(_PLANES_LOW_STUDY), fallback_for(_PLANES_LOW_STUDY)))
    low.append(late_low)
    host = reliability.suggest_fallback(config.to_problem(), _COUNT, study_name=_PLANES_LOW_STUDY,
                                        max_trial_id=supporter.study_descriptor().max_trial_id,
                                        reason="admission_degraded")
    for out in sheds:
        if not isinstance(out.error, admission.AdmissionShedError) or (
                "retry_after_ms=50" not in str(out.error)) or out.fallbacks:
            raise AssertionError(f"service-planes: tenant b was not shed: {out}")
    for out in low:
        if out.error is not None or [s.parameters.as_dict() for s in out.fallbacks] != [
                s.parameters.as_dict() for s in host] or not all(
                s.metadata.ns(admission.ADMISSION_NAMESPACE).get(admission.ADMISSION_KEY)
                == admission.ADMISSION_VALUE and reliability.is_fallback_suggestion(s.metadata)
                for s in out.fallbacks):
            raise AssertionError(f"service-planes: the low tenant was not degraded: {out}")
    snapshot = runtime.admission_snapshot()
    want_sheds = _PLANES_SHEDS_BEFORE + _PLANES_SHEDS_AFTER
    counters = runtime.snapshot()
    if computations != ["live"] or figures["launches_while_gated"] or launches_total(
            late_launches) or snapshot["sheds_by_tenant"] != {"b": {"inflight_total": want_sheds}} or (
            snapshot["degraded_by_tenant"] != {"low": 2}) or snapshot["admits_by_tenant"] != {"a": 1} or (
            snapshot["state"] != "degraded") or [(t["from"], t["to"]) for t in snapshot[
                "transitions"]] != [("healthy", "shedding"), ("shedding", "degraded")] or (
            counters["admission_sheds"] != want_sheds) or counters["admission_degraded"] != 2 or (
            counters["fallbacks"] != 2 * _COUNT) or counters["designer_failures"]:
        raise AssertionError(f"service-planes: admission counters {snapshot}, {counters}, "
                             f"computations {computations}, launches while gated "
                             f"{figures['launches_while_gated']}, late degrade "
                             f"{launches_total(late_launches)}")
    _require_modes(cold_launches, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                   ("matern52_ard_bwd", "gram")), "service-planes live request")
    paths["service_planes_live"] = cold_launches
    figures["admission"] = dict(
        live_wall_ms=cold_wall * 1e3, live_launches=cold_launches, sheds=want_sheds,
        degraded=2, retry_after=str(sheds[0].error).splitlines()[0],
        transitions=snapshot["transitions"], degraded_launches=launches_total(late_launches))
    print(f"service-planes admission: tenant a's live suggest(count={_COUNT}) at {_NUM_TRIALS} "
          f"trials x {_DIM}-D {cold_wall * 1e3:.1f} ms, launches {cold_launches}; while it held "
          f"the only slot tenant b was shed {want_sheds} times ({str(sheds[0].error).splitlines()[0]}"
          f"), states {[t['to'] for t in snapshot['transitions']]}, the low tenant degraded "
          f"twice to {_COUNT} stamped points equal to the host's; launches while gated "
          f"{figures['launches_while_gated']}, late degrade {launches_total(late_launches)}")

    # 2. Speculation.
    complete(cold.suggestions)
    engine = runtime.speculative_engine

    def speculate():
        runtime.notify_trial_event(_PLANES_STUDY)
        return engine.wait_idle(600.0)

    idle, spec_wall, spec_launches = _path_launches(kernels, speculate)
    counters = runtime.snapshot()
    events = runtime.metrics.get("vizier_speculative_events").series_values()
    stored = events.get((("outcome", "stored"),), 0.0)
    entry = runtime.designer_cache.peek(_PLANES_STUDY, touch=False)
    parked = getattr(entry, "speculative", None)
    if not idle or parked is None or computations != ["live", "speculative"] or (
            counters["speculative_precomputes"] != 1) or counters["speculative_errors"] or (
            counters["speculative_cancelled"]) or stored != 1 or parked.count != _COUNT or (
            parked.fingerprint != frontier()) or runtime_lib.accept_guarded(parked.response) != _COUNT:
        raise AssertionError(f"service-planes: the speculative job did not park exactly one "
                             f"batch of {_COUNT} at the current frontier: idle {idle}, parked "
                             f"{parked and (parked.count, parked.fingerprint == frontier())}, "
                             f"computations {computations}, counters {counters}, events {events}")
    _check_suggestions(parked.response.suggestions, "service-planes speculative")
    _require_modes(spec_launches, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                   ("matern52_ard_bwd", "gram")), "service-planes speculative job")
    hit, hit_wall, hit_launches = _path_launches(kernels, request)
    served = [s.parameters.as_dict() for s in hit.suggestions]
    if hit.error is not None or launches_total(hit_launches) or hit_wall >= _PLANES_HIT_WALL_S or (
            served != [s.parameters.as_dict() for s in parked.response.suggestions]) or not all(
            s.metadata.ns(speculative.SPECULATIVE_NAMESPACE).get(speculative.SPECULATIVE_KEY)
            == speculative.SPECULATIVE_HIT_VALUE for s in hit.suggestions) or (
            runtime.snapshot()["speculative_hits"] != 1) or computations != ["live", "speculative"]:
        raise AssertionError(f"service-planes: the next suggest was not a stamped hit with no "
                             f"launch under {_PLANES_HIT_WALL_S * 1e3:.0f} ms: wall "
                             f"{hit_wall * 1e3:.2f} ms, launches {hit_launches}")
    # Re-park the served batch (the engine's slot swap), then move the
    # frontier by one completion: the serve-time fingerprint check refuses it.
    with engine._serve_lock:
        entry.speculative = parked
    complete(hit.suggestions[:1])
    stale, outcome = engine.try_serve(_PLANES_STUDY, _COUNT, frontier())
    if stale is not None or outcome != "miss" or entry.speculative is not None:
        raise AssertionError(f"service-planes: the stale slot was served ({outcome})")
    paths["service_planes_speculative"] = spec_launches
    figures["speculative"] = dict(
        job_wall_ms=spec_wall * 1e3, job_launches=spec_launches, hit_wall_ms=hit_wall * 1e3,
        hit_launches=launches_total(hit_launches), stale_outcome=outcome,
        counters={k: v for k, v in runtime.snapshot().items() if k.startswith("speculative_")})
    print(f"service-planes speculation: the completion's job ran on the deferrable lane "
          f"{spec_wall * 1e3:.1f} ms (notify to idle), launches {spec_launches}, parked 1 batch "
          f"of {parked.count}; the next suggest was a stamped hit in {hit_wall * 1e3:.3f} ms "
          f"with {launches_total(hit_launches)} launches, equal to the parked batch; after one "
          f"more completion try_serve gave {outcome!r} and dropped the slot; counters "
          f"{figures['speculative']['counters']}")

    # 3. SLO, recorder, metrics, fleet dump.
    report = runtime.slo_report()
    breaching = report["breaching"]
    if "suggest_p99:pythia" not in breaching or not report["dumps"]:
        raise AssertionError(f"service-planes: the p99 objective did not breach: {report}")
    with open(report["dumps"][0]) as f:
        dump = json.load(f)
    trace_ids = sorted(dump["exemplar_traces"])
    if not trace_ids or not all(dump["exemplar_traces"][t] for t in trace_ids) or not dump[
            "flight_recorder"].get(_PLANES_STUDY) or "vizier_suggest_latency_seconds" not in dump[
            "metrics"]:
        raise AssertionError(f"service-planes: the black-box dump is missing parts: "
                             f"{sorted(dump)}, exemplar traces {trace_ids}")
    timeline = [e for e in recorder.events() if (e["study"] == _PLANES_STUDY and e["kind"] in (
        "suggest", "speculation")) or e["kind"] == "batch_flush"]
    marks = [("suggest", None), ("batch_flush", None), ("speculation", "stored"),
             ("speculation", "hit")]
    position = 0
    for e in timeline:
        kind, outcome = marks[position]
        if e["kind"] == kind and (outcome is None or e.get("attributes", {}).get(
                "outcome") == outcome):
            position += 1
            if position == len(marks):
                break
    if position != len(marks):
        raise AssertionError(f"service-planes: the recorder's events are out of order: "
                             f"{[(e['kind'], e.get('attributes', {}).get('outcome')) for e in timeline]}")
    text = runtime.prometheus_text()
    series = ("vizier_slo_burn_rate", "vizier_slo_breached", "vizier_speculative_events_total",
              "vizier_speculative_suggest_latency_seconds", "vizier_serving_speculative_hits_total",
              "vizier_admission_decisions_total", "vizier_admission_state",
              "vizier_serving_admission_sheds_total")
    missing = [name for name in series if name not in text]
    written = fleet.dump_process(os.path.join(workdir, "fleet"), "card", tracer=tracer,
                                 registry=runtime.metrics, recorder=recorder)
    loaded = fleet.load_fleet_dir(os.path.join(workdir, "fleet"))
    report_fleet = fleet.fleet_report(os.path.join(workdir, "fleet"))
    if missing or sorted(written) != ["metrics", "recorder", "spans"] or not loaded["spans"].get(
            "card") or len(loaded["recorder"].get("card", [])) != len(recorder.events()) or (
            "vizier_slo_burn_rate" not in report_fleet["slo"]):
        raise AssertionError(f"service-planes: metrics or fleet dump incomplete: missing "
                             f"{missing}, written {sorted(written)}")
    figures["slo"] = dict(breaching=breaching, dump_keys=sorted(dump),
                          exemplar_traces=len(trace_ids),
                          exemplar_spans=sum(len(v) for v in dump["exemplar_traces"].values()))
    figures["recorder"] = dict(events=len(recorder.events()), studies=recorder.studies(),
                               fleet_files=sorted(written), fleet_spans=report_fleet["spans"])
    print(f"service-planes SLO: breaching {breaching}; black-box dump with "
          f"{len(trace_ids)} exemplar traces ({figures['slo']['exemplar_spans']} spans), the "
          f"recorder's {len(dump['flight_recorder'])} rings and a metrics snapshot; recorder "
          f"{len(recorder.events())} events in order suggest, batch_flush, parked, served; "
          f"fleet dump {sorted(written)} read back ({report_fleet['spans']} spans)")

    runtime.shutdown()
    flight_recorder.set_recorder(previous_recorder)
    if switch is None:
        os.environ.pop("VIZIER_TORCH_FLIGHT_RECORDER", None)
    else:
        os.environ["VIZIER_TORCH_FLIGHT_RECORDER"] = switch
    figures["wall_s"] = time.perf_counter() - phase_start
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded_layouts"] = check_recorded_shapes(kernels, lib, recorded,
                                                        "service-planes phase")
    print(f"service-planes phase: {figures['wall_s']:.1f} s; {_card_line()}")
    return paths, figures


# -- the fleet: rendezvous routing onto one shared runtime ----------------------

# 4 frontend ids of the in-process tier (``ReplicaManager``'s replica ids), 8
# studies of serving-exact's shape routed over them by the port's StudyRouter.
_FLEET_FRONTENDS = tuple(f"replica-{i}" for i in range(4))
_FLEET_STUDY = "owners/fleet/studies/s"


def _fleet_requests(fleet, router, studies, count: int) -> tuple:
    """Each owning frontend sends its studies' ``suggest(count)`` into the one
    shared runtime, one handler thread per request (as a frontend's gRPC
    workers would). Returns (suggestions by study index, wall seconds,
    {frontend: [study indices]})."""
    by_frontend = {}
    for i in studies:
        by_frontend.setdefault(router.replica_for(fleet.studies[i][2]), []).append(i)
    results, errors = {}, []

    def frontend(own):
        handlers = [threading.Thread(target=handle, args=(i,)) for i in own]
        for t in handlers:
            t.start()
        for t in handlers:
            t.join()

    def handle(i):
        try:
            results[i] = fleet._suggest(i, count)
        except BaseException as e:  # surfaced below
            errors.append(e)

    torch.cuda.synchronize()
    start = time.perf_counter()
    threads = [threading.Thread(target=frontend, args=(own,)) for own in by_frontend.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if errors:
        raise errors[0]
    return results, wall, by_frontend


def run_fleet_phase(mods, kernels):
    """Phase 14: the fleet's routing onto one shared runtime (see the module
    docstring). Returns ({path: launches by mode}, figures)."""
    from vizier_tpu_torch.distributed import routing

    serving = mods["serving"]
    label = "fleet"
    phase_start = time.perf_counter()
    config = dataclasses.replace(serving.ServingConfig(), batch_max_wait_ms=_SERVE_WINDOW_MS)
    runtime = serving.ServingRuntime(config)
    fleet = _Fleet(mods, runtime, "DEFAULT", _SERVE_TRIALS["exact"], _FLEET_STUDY)
    names = [name for _, _, name in fleet.studies]
    router = routing.StudyRouter(_FLEET_FRONTENDS)
    owners = {name: router.replica_for(name) for name in names}
    paths, figures = {}, {"owners": owners}
    stat_keys = ("batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
                 "warm_trains", "cold_trains")

    def served(studies, count, path):
        before = runtime.stats.snapshot()
        (results, wall, by_frontend), _, launches = _path_launches(
            kernels, lambda: _fleet_requests(fleet, router, studies, count))
        stats = {k: runtime.stats.get(k) - before[k] for k in stat_keys}
        ordered = [results[i] for i in studies]
        _check_round(ordered, count, f"{label} {path}")
        paths[f"fleet_{path}"] = launches
        occupancy = stats["batched_suggests"] / max(stats["batch_flushes"], 1)
        row = dict(wall_ms=wall * 1e3, stats=stats, occupancy=occupancy, launches=launches,
                   frontends={f: [names[i] for i in own] for f, own in by_frontend.items()})
        print(f"{label} {path}: {len(studies)} x suggest(count={count}) from frontends "
              f"{ {f: len(own) for f, own in sorted(by_frontend.items())} } into one runtime: "
              f"{stats}, occupancy {occupancy:.1f}, wall {wall * 1e3:.1f} ms, launches {launches}")
        return ordered, stats, row

    # Round 1: every frontend's studies at once -> one flush of occupancy 8.
    results, stats, figures["round1"] = served(range(_SERVE_STUDIES), _COUNT, "round1")
    if (stats["batch_flushes"] != 1 or stats["batched_suggests"] != _SERVE_STUDIES
            or stats["batch_fallbacks"] or stats["batch_slot_errors"]
            or stats["cold_trains"] != _SERVE_STUDIES):
        raise AssertionError(f"{label} round 1: not one flush of occupancy {_SERVE_STUDIES} "
                             f"without fallback or slot error: {stats}")
    fleet.complete(results)

    # Kill: the frontend that owns the most studies (the lowest id on a tie).
    counts = {f: sum(o == f for o in owners.values()) for f in _FLEET_FRONTENDS}
    victim = max(_FLEET_FRONTENDS, key=lambda f: (counts[f], -_FLEET_FRONTENDS.index(f)))
    if not counts[victim]:
        raise AssertionError(f"{label}: no frontend owns a study: {owners}")
    if not router.mark_down(victim):
        raise AssertionError(f"{label}: {victim} was already down")
    after = {name: router.replica_for(name) for name in names}
    moved = sorted(name for name in names if after[name] != owners[name])
    want = {}
    for name in names:
        if owners[name] == victim:
            ranked = sorted(_FLEET_FRONTENDS, key=lambda f: routing.rendezvous_weight(f, name),
                            reverse=True)
            want[name] = next(f for f in ranked if f != victim)
    if moved != sorted(want) or any(after[name] != want[name] for name in moved):
        raise AssertionError(f"{label}: marking {victim} down moved {moved} to "
                             f"{ {n: after[n] for n in moved} }; want exactly its studies on "
                             f"their rendezvous successors {want}")
    figures["kill"] = dict(victim=victim, moved={n: [owners[n], after[n]] for n in moved})
    print(f"{label} kill: {victim} marked down; moved exactly its {len(moved)} studies, each to "
          f"its next rendezvous choice: { {n.rsplit('/', 1)[1]: after[n] for n in moved} }")

    moved_idx = [names.index(n) for n in moved]
    _, stats, figures["moved"] = served(moved_idx, _COUNT, "moved")
    if stats["warm_trains"] != len(moved) or stats["cold_trains"] or (
            stats["batch_fallbacks"] or stats["batch_slot_errors"]):
        raise AssertionError(f"{label}: the moved studies' requests did not all train warm from "
                             f"the shared designer cache: {stats}")

    # Revive: every study's owner is the one it had before the kill.
    if not router.mark_up(victim):
        raise AssertionError(f"{label}: {victim} was not down")
    revived = {name: router.replica_for(name) for name in names}
    if revived != owners:
        raise AssertionError(f"{label}: owners after the revive {revived} != before {owners}")
    runtime.shutdown()
    total = {name: sum(sum(p[name].values()) for p in paths.values())
             for name in kernels.LAUNCHES_BY_MODE}
    _require_modes(paths["fleet_round1"], (("matern52_ard_fwd", "gram"),
                                           ("matern52_ard_fwd", "cross"),
                                           ("matern52_ard_bwd", "gram")), f"{label} round 1")
    figures["wall_s"] = time.perf_counter() - phase_start
    figures["launches"] = total
    print(f"{label} revive: {victim} marked up, all {len(names)} owners as before the kill; "
          f"phase {figures['wall_s']:.1f} s, K1/K2 launches {total}; {_card_line()}")
    return paths, figures


# -- loadgen and testing (phases 15-16) -----------------------------------------

# The JAX package's soak_config() expansion (seed 0, 1000 studies, 4334
# trials); tests/test_torch_loadgen.py pins it against the live JAX expansion.
_SOAK_FINGERPRINT = "9e86d4650ea5e34e059723653de33f403895b334622f4afce6b215e4e334b47c"
# The report's assertions that need no replica: each must hold on the card.
# The replica events and failover need the replicas target, which needs
# protobuf: they are held on the CPU (tests/test_torch_loadgen_soak.py).
_LOADGEN_REQUIRED = ("zero_lost_studies", "all_kinds_served", "fallback_rate_bounded",
                     "speculative_hits", "slo_evaluated", "shed_rate_bounded",
                     "regret_parity", "bit_identical_when_gated")


def _by_shape_row(r) -> dict:
    """One kernel's ``time_kernels`` row in the ``kernels`` line's form."""
    return dict(ms=r["ms"], host_us=r["host_us"], plain_ms=r["plain_ms"],
                library_ms=r["library_ms"], bound_ms=r["bound"][0], bound_by=r["bound"][1],
                max_abs_err=r["max_abs_err"], occupancy=r["occupancy"])


def _time_recorded(kernels, recorded, label: str, per_layout: bool = False) -> dict:
    """K1 and K2 timed as phase 3 times them (checked first) at the recorded
    K1 Gram and cross layouts with the most pairs: a phase's largest
    launches, or with ``per_layout`` those of each recorded (Dc, Ds).
    Another process shares the card meanwhile."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = {shape for name, shape in recorded if name == "matern52_ard_fwd"}
    groups = sorted({(s.dc, s.ds) for s in shapes}) if per_layout else [None]
    timed = {}
    for (kind, symmetric), group in ((k, g) for k in (("gram", True), ("cross", False))
                                     for g in groups):
        pool = [s for s in shapes if bool(s.symmetric) == symmetric
                and group in (None, (s.dc, s.ds))]
        if not pool:
            continue
        shape = max(pool, key=lambda s: (s.batch * s.n * s.m, repr(s)))
        name = f"{label} {kind} {shape}"
        args, masks = _case_at(gen, shape)
        grad, fwd_err, bwd_err = _check_case(kernels, gen, name, args, masks,
                                             same=symmetric, dc=shape.dc, verbose=False)
        timed[name] = (args, masks, grad, fwd_err, bwd_err)
    rows = time_kernels(kernels, timed)
    return {name: {key: _by_shape_row(r[key]) for key in ("fwd", "bwd")}
            for name, r in rows.items()}


def _chaos_accounting(engine, label: str) -> dict:
    """Every fallback and slot error of the engine arm is one injected
    designer strike: the monkey strikes only inside the chaos window, so a
    failed GP computation outside it, which the quasi-random fallback would
    hide, breaks these equalities. (The runtime's ``fallbacks`` counter also
    counts a struck speculative job's, which is never parked or served.)"""
    faults = {site: c["faults"] for site, c in engine.chaos_counts.items()}
    stats = engine.serving_stats
    served = [r for r in engine.records if r.op == "suggest" and r.error is None]
    struck = sum(faults.get(f"designer.{s}", 0)
                 for s in ("suggest", "batch_prepare", "batch_finalize"))
    slot_faults = faults.get("designer.batch_prepare", 0) + faults.get("designer.batch_finalize", 0)
    keys = ("designer_failures", "fallbacks", "breaker_short_circuits", "admission_degraded",
            "batch_slot_errors", "batch_fallbacks")
    row = dict(faults=faults, served_fallbacks=sum(1 for r in served if r.fallback),
               baseline_fallbacks=sum(1 for r in served if r.fallback
                                      and r.kind in ("random", "quasi_random")),
               **{k: stats[k] for k in keys})
    ok = (stats["designer_failures"] == struck
          and stats["fallbacks"] == (struck + stats["breaker_short_circuits"]
                                     + stats["admission_degraded"])
          and row["served_fallbacks"] <= stats["fallbacks"]
          and stats["batch_slot_errors"] == slot_faults
          and (stats["batch_fallbacks"] == 0) == (faults.get("designer.batch_execute", 0) == 0)
          and row["baseline_fallbacks"] == 0)
    print(f"{label} chaos window: {row}")
    if not ok:
        raise AssertionError(f"{label}: a fallback or slot error not explained by an injected "
                             f"strike: {row}")
    return row


def _ard_graph_check(label: str) -> dict:
    """One ARD train at a soak layout (2-D, 16 padded rows of which 10 are
    real, a warm row and 2 restarts, Adam for 10 steps), eager and through
    captured CUDA graphs (``optimizers/graphs.py``) on the same inputs: the
    largest difference between the two results (under capture the loss
    solves with triangular solves, so they differ by rounding) and each
    one's wall per train."""
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.optimizers import graphs, lbfgs

    model = gp_lib.VizierGaussianProcess(num_continuous=2, num_categorical=0, device="cuda")
    gen = torch.Generator().manual_seed(0)
    n, valid = 16, 10
    rows = torch.arange(n) < valid
    data = gp_lib.GPData(
        continuous=torch.rand((n, 2), generator=gen).cuda(),
        categorical=torch.zeros((n, 0), dtype=torch.int32).cuda(),
        labels=torch.where(rows, torch.randn(n, generator=gen), torch.zeros(n)).cuda(),
        row_mask=rows.cuda(), cont_dim_mask=torch.ones(2, dtype=torch.bool).cuda(),
        cat_dim_mask=torch.ones(0, dtype=torch.bool).cuda())
    inits = model.param_collection().batch_random_init_unconstrained(
        torch.Generator(device="cuda").manual_seed(0), 3)
    loss = graphs.BoundLoss(model.neg_log_likelihood, data)
    eager = lbfgs.AdamOptimizer(maxiter=10, device="cuda")
    graphed = dataclasses.replace(eager, cuda_graph=True)
    want, got = eager(loss, inits), graphed(loss, inits)
    pairs = [(got.params[k], want.params[k]) for k in want.params] + [(got.losses, want.losses)]
    err = max(float((g - w).abs().max()) for g, w in pairs)
    if not all(torch.allclose(g, w, rtol=1e-4, atol=1e-5) for g, w in pairs):
        raise AssertionError(f"{label}: the graphed ARD train differs from the eager one by "
                             f"{err} (rtol 1e-4, atol 1e-5)")

    def wall_ms(opt, reps=20):
        opt(loss, inits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            opt(loss, inits)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = dict(max_abs_err=err, eager_ms=wall_ms(eager), graphed_ms=wall_ms(graphed))
    print(f"{label}: one soak-layout ARD train (Adam 10 steps, 3 restarts, 16 rows): eager "
          f"{out['eager_ms']:.3f} ms, graphed {out['graphed_ms']:.3f} ms, max abs diff "
          f"{err:.3e}; {_card_line()}")
    return out


def run_loadgen_phase(kernels, lib):
    """Phase 15: the loadgen engine at soak_config() (see the module
    docstring). Returns ({path: launches by mode}, figures)."""
    from vizier_tpu_torch.loadgen import driver, models, report
    from vizier_tpu_torch.optimizers import graphs as graphs_lib

    label = "loadgen"
    phase_start = time.perf_counter()
    kernels.LAUNCH_SHAPES = set()
    scenario = models.build_scenario(models.soak_config())
    fingerprint = scenario.fingerprint()
    if fingerprint != _SOAK_FINGERPRINT:
        raise AssertionError(f"{label}: soak_config() expands to {fingerprint}, the JAX "
                             f"package's to {_SOAK_FINGERPRINT}")
    print(f"{label}: soak_config() fingerprint {fingerprint} (the JAX package's); driving "
          f"{scenario.summary()}")
    from vizier_tpu_torch.parallel import batch_executor as executor_lib

    # The executor's busy time in the engine arm: every flush's wall on its
    # scheduler thread (the share of the arm's wall says how saturated the
    # one computation at a time is).
    flush_walls, execute = [], executor_lib.BatchExecutor._execute

    def timed_execute(self, key, slots, reason, placement=None):
        t0 = time.perf_counter()
        try:
            return execute(self, key, slots, reason, placement)
        finally:
            flush_walls.append(time.perf_counter() - t0)

    paths, walls, arms = {}, {}, {}
    for arm, fn in (("engine", driver.run), ("reference", driver.run_reference),
                    ("gated_off", driver.run_gated_off)):
        executor_lib.BatchExecutor._execute = timed_execute if arm == "engine" else execute
        try:
            arms[arm], walls[arm], paths[f"loadgen_{arm}"] = _path_launches(
                kernels, lambda: fn(scenario, device="cuda", transport="runtime"))
        finally:
            executor_lib.BatchExecutor._execute = execute
        print(f"{label} {arm} arm: {len(arms[arm].outcomes)} studies in {walls[arm]:.1f} s, "
              f"launches {paths[f'loadgen_{arm}']}")
    engine = arms["engine"]
    rep = report.build_report(scenario, engine, arms["reference"], arms["gated_off"],
                              stamps={"device": torch.cuda.get_device_name(0),
                                      "card": _card_line(), "mesh": engine.mesh})
    for row in rep["assertions"]:
        if row["name"] in _LOADGEN_REQUIRED:
            print(f"{label} [{'ok' if row['ok'] else 'FAIL'}] {row['name']}: {row['detail']}")
        else:
            print(f"{label} [not run on the card: needs the replicas target and protobuf] "
                  f"{row['name']}: {row['detail']}")
    verdicts = {row["name"]: row["ok"] for row in rep["assertions"]}
    # Raised after the phase's other checks and figures, so a failed
    # assertion still leaves the phase's numbers in the log.
    failed = [name for name in _LOADGEN_REQUIRED if not verdicts.get(name)]
    skipped = sorted({e["kind"] for e in engine.events_fired if "skipped" in e})
    chaos = _chaos_accounting(engine, label)
    by_kind = rep["outcomes"]["by_kind"]
    figures = dict(
        fingerprint=fingerprint, studies=len(scenario.studies), trials=scenario.total_trials,
        walls_s=walls, mesh=engine.mesh, events_skipped=skipped,
        events_fired=[e["kind"] for e in engine.events_fired if "skipped" not in e],
        gp_hit_rate=rep["speculative"]["gp_hit_rate"], hits=rep["speculative"]["hits"],
        fallback_rate=round(sum(r["fallbacks"] for r in by_kind.values()) / max(
            1, sum(r["suggests"] - r["errors"] for r in by_kind.values())), 4),
        shed_rate=rep["admission"]["shed_rate"], parity_p=rep["parity"]["ranksum_p"],
        bit_identity=rep["bit_identity"]["studies_compared"],
        p99_ms={kind: row["latency"]["p99_ms"] for kind, row in by_kind.items()},
        p50_ms={kind: row["latency"]["p50_ms"] for kind, row in by_kind.items()},
        achieved_trials_per_s=rep["traffic"]["achieved_trials_per_s"],
        executor_busy_s=sum(flush_walls),
        executor_busy_share=sum(flush_walls) / walls["engine"],
        flush_ms_p50=float(np.percentile(flush_walls, 50)) * 1e3 if flush_walls else None,
        serving={k: engine.serving_stats[k] for k in (
            "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
            "cold_trains", "warm_trains", "sparse_suggests", "surrogate_crossovers",
            "coalesced_requests", "deadline_exceeded", "speculative_hits",
            "speculative_misses", "speculative_precomputes", "speculative_cancelled",
            "speculative_errors", "fallbacks", "admission_sheds")},
        chaos=chaos, slo_breaching=rep["slo"].get("breaching", []),
        launches={arm: sum(sum(m.values()) for m in paths[f"loadgen_{arm}"].values())
                  for arm in arms},
        ard_graphs=dict(graphs_lib.STATS))
    for name in models.GP_KINDS:
        if by_kind.get(name, {}).get("suggests", 0) - by_kind.get(name, {}).get("errors", 0) <= 0:
            raise AssertionError(f"{label}: kind {name} was not served")
    _require_modes(paths["loadgen_engine"], (("matern52_ard_fwd", "gram"),
                                             ("matern52_ard_fwd", "cross"),
                                             ("matern52_ard_bwd", "gram")), f"{label} engine")
    if figures["ard_graphs"]["failures"] or not figures["ard_graphs"]["served"]:
        raise AssertionError(f"{label}: the ARD loop was not replayed from captured graphs: "
                             f"{figures['ard_graphs']}")
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded"] = check_recorded_shapes(kernels, lib, recorded, label)
    figures["timed"] = _time_recorded(kernels, recorded, label)
    figures["ard_graph"] = _ard_graph_check(label)
    figures["wall_s"] = time.perf_counter() - phase_start
    print(f"{label}: {json.dumps({k: figures[k] for k in ('gp_hit_rate', 'fallback_rate', 'shed_rate', 'p99_ms', 'parity_p', 'executor_busy_share', 'flush_ms_p50', 'ard_graphs')})}; "
          f"phase {figures['wall_s']:.1f} s; {_card_line()}")
    if failed:
        print(f"{label} figures: {json.dumps(figures)}")
        raise AssertionError(f"{label}: report assertions failed or missing: {failed}")
    return paths, figures


def _simplekd_factories():
    from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit
    from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit
    from vizier_tpu_torch.optimizers.lbfgs import AdamOptimizer

    ard = AdamOptimizer(maxiter=40, device="cuda")

    def gp(problem, seed=None, **kw):
        return VizierGPBandit(problem, rng_seed=seed or 0, max_acquisition_evaluations=1500,
                              ard_restarts=4, ard_optimizer=ard, num_seed_trials=5,
                              device="cuda")

    def ucb_pe(problem, seed=None, **kw):
        return VizierGPUCBPEBandit(problem, rng_seed=seed or 0, max_acquisition_evaluations=800,
                                   ard_restarts=4, ard_optimizer=ard, num_seed_trials=5,
                                   device="cuda")

    return gp, ucb_pe


def run_testing_phase(kernels, lib):
    """Phase 16: the designers' convergence gates and the chaos strikes on
    the card (see the module docstring). Returns ({path: launches by mode},
    figures)."""
    from vizier_tpu_torch.benchmarks import NumpyExperimenter, bbob_problem
    from vizier_tpu_torch.benchmarks.experimenters import wrappers
    from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob
    from vizier_tpu_torch.designers.random import RandomDesigner
    from vizier_tpu_torch.testing import chaos_flushes, comparator_runner, simplekd_runner

    label = "testing"
    phase_start = time.perf_counter()
    kernels.LAUNCH_SHAPES = set()
    gp, ucb_pe = _simplekd_factories()
    paths, figures = {}, {}
    for name, factory, max_abs_error in (("gp_bandit", gp, 0.6), ("gp_ucb_pe", ucb_pe, 0.8)):
        tester = simplekd_runner.SimpleKDConvergenceTester(
            num_trials=40, batch_size=5, max_abs_error=max_abs_error, seed=1)
        best, wall, paths[f"simplekd_{name}"] = _path_launches(
            kernels, lambda: tester.assert_converges(factory))
        figures[f"simplekd_{name}"] = dict(best=best, max_abs_error=max_abs_error, wall_s=wall)
        print(f"{label} SimpleKD {name}: best {best:.4f} within {max_abs_error} of the optimum "
              f"0.0 (40 trials, batch 5, seed 1), {wall:.1f} s, launches "
              f"{paths[f'simplekd_{name}']}")
    experimenter = wrappers.ShiftingExperimenter(
        NumpyExperimenter(bbob.Sphere, bbob_problem(4)), shift=np.array([1.0, -2.0, 0.5, 2.5]))
    tester = comparator_runner.SimpleRegretComparisonTester(
        num_trials=25, num_repeats=2, tolerance=0.0)
    _, wall, paths["regret_comparison"] = _path_launches(
        kernels, lambda: tester.assert_better_simple_regret(
            experimenter, candidate_factory=gp,
            baseline_factory=lambda p, **kw: RandomDesigner(p.search_space,
                                                           seed=kw.get("seed", 0))))
    figures["regret_comparison"] = dict(wall_s=wall)
    print(f"{label} SimpleRegretComparisonTester: GP bandit not worse than random on the "
          f"4-D Sphere shifted by [1, -2, 0.5, 2.5] (25 trials x 2 repeats, tolerance 0.0), "
          f"{wall:.1f} s, launches {paths['regret_comparison']}")
    for name, fn in (("per_slot_strike", chaos_flushes.per_slot_strike),
                     ("device_program_strike", chaos_flushes.device_program_strike)):
        out, wall, paths[f"chaos_{name}"] = _path_launches(kernels, lambda: fn("cuda"))
        if not all(out["equal"]):
            raise AssertionError(f"{label} {name}: the unstruck slots differ: {out}")
        counters = {k: out["counters"][k] for k in ("batch_flushes", "batched_suggests",
                                                    "batch_fallbacks", "batch_slot_errors")}
        figures[name] = dict(faults=out["faults"], counters=counters, wall_s=wall)
        print(f"{label} {name}: {out['faults']} injected strike, counters {counters}, the "
              f"other slots equal their unstruck suggestions, {wall:.1f} s")
    for path in ("simplekd_gp_bandit", "simplekd_gp_ucb_pe"):
        _require_modes(paths[path], (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                     ("matern52_ard_bwd", "gram")), f"{label} {path}")
    recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
    figures["recorded"] = check_recorded_shapes(kernels, lib, recorded, label)
    figures["timed"] = _time_recorded(kernels, recorded, label)
    figures["wall_s"] = time.perf_counter() - phase_start
    print(f"{label}: phase {figures['wall_s']:.1f} s; {_card_line()}")
    return paths, figures

# -- phase 17: the benchmark slice ---------------------------------------------

# Rounds of GenerateAndEvaluate(5) per study: a depth cut (the spaces are the
# experimenters' own). The first round is the designers' quasi-random seed.
_BENCH_ROUNDS = 5
_BENCH_BATCH = 5
# Acquisition evaluations per pick (the designers' default is 75 000, which
# would make each pick a ~7 s host-bound sweep at any trial count).
_BENCH_EVALS = 2_000
_BENCH_PREDICTOR_SEED = 7


def _discretized(fn: str):
    """A 4-D BBOB function on 11 feasible values per coordinate."""
    from vizier_tpu_torch.benchmarks import NumpyExperimenter, bbob_problem
    from vizier_tpu_torch.benchmarks.experimenters import wrappers
    from vizier_tpu_torch.benchmarks.experimenters.synthetic import bbob

    grid = np.linspace(-5.0, 5.0, 11).tolist()
    return wrappers.DiscretizingExperimenter(
        NumpyExperimenter(getattr(bbob, fn), bbob_problem(4)), {f"x{i}": grid for i in range(4)})


def _benchmark_studies():
    """[(name, experimenter, algorithm)] of the phase's GP studies."""
    from vizier_tpu_torch.benchmarks.experimenters import combinatorial, experimenter_factory
    from vizier_tpu_torch.benchmarks.experimenters import nasbench101, wrappers

    api, _ = nasbench101.synthetic_nasbench101(num_cells=64, seed=0)
    wcnf = combinatorial.random_wcnf(60, 200, np.random.default_rng(0))
    sphere = experimenter_factory.shifted_bbob_instance("Sphere", 1, dim=20)
    return [
        ("nasbench101", nasbench101.NASBench101Experimenter(api), "DEFAULT"),
        ("pest_control", combinatorial.PestControlExperimenter(seed=0), "DEFAULT"),
        ("maxsat60", combinatorial.MAXSATExperimenter(wcnf), "DEFAULT"),
        ("sparse_sphere20", wrappers.SparseExperimenter.create_default(sphere, num_float=20),
         "GAUSSIAN_PROCESS_BANDIT"),
        ("permuting_rastrigin4", wrappers.PermutingExperimenter(
            _discretized("Rastrigin"), [f"x{i}" for i in range(4)], seed=0), "DEFAULT"),
        ("normalizing_rosenbrock4",
         wrappers.NormalizingExperimenter(_discretized("Rosenbrock"), seed=0), "DEFAULT"),
        ("sign_flip_sphere4", wrappers.SignFlipExperimenter(_discretized("Sphere")), "DEFAULT"),
    ]


def _bench_factory(algorithm: str, device: str):
    from vizier_tpu_torch.designers.gp_bandit import VizierGPBandit
    from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit

    cls = VizierGPUCBPEBandit if algorithm == "DEFAULT" else VizierGPBandit

    def make(problem, seed=None, **kw):
        return cls(problem, rng_seed=seed or 0, num_seed_trials=_BENCH_BATCH,
                   max_acquisition_evaluations=_BENCH_EVALS, device=device)

    return make


def _check_benchmark_trials(state, label: str, rounds: int) -> list:
    """Every trial completed, feasible or infeasible, its parameters inside
    the space. Returns the trials."""
    space = state.experimenter.problem_statement().search_space
    trials = state.algorithm.supporter.GetTrials()
    if len(trials) != rounds * _BENCH_BATCH:
        raise AssertionError(f"{label}: {len(trials)} trials, expected {rounds * _BENCH_BATCH}")
    for t in trials:
        if not t.is_completed or (t.final_measurement is None and not t.infeasibility_reason):
            raise AssertionError(f"{label}: trial {t.id} not completed")
        names = set(t.parameters)
        if names != set(space.parameter_names()) or not all(
                space.get(n).contains(t.parameters[n].value) for n in names):
            raise AssertionError(f"{label}: trial {t.id} outside its space: "
                                 f"{t.parameters.as_dict()}")
    return trials


def _trained_posterior(designer):
    """The designer's last trained exact posterior (one metric)."""
    from vizier_tpu_torch.designers.gp_ucb_pe import VizierGPUCBPEBandit

    if isinstance(designer, VizierGPUCBPEBandit):
        (state,), _ = designer._cached_states
        return state
    return designer._last_predictive.states


def _layout_query(state, kernels):
    """64 CPU query points at the posterior's layout: uniform continuous
    features, categorical indices in 0..4."""
    gen = torch.Generator().manual_seed(1)
    dc, ds = state.data.continuous.shape[-1], state.data.categorical.shape[-1]
    return kernels.MixedFeatures(torch.rand((64, dc), generator=gen),
                                 torch.randint(0, 5, (64, ds), generator=gen, dtype=torch.int32))


def run_benchmarks_phase(kernels, lib, device: str = "cuda"):
    """Phase 17: the GP designers over the benchmark slice's spaces, the
    PredictorExperimenter and the analyzers (see the module docstring).
    Returns ({path: launches by mode}, figures). ``device="cpu"`` runs the
    host path alone, without the card's checks."""
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.benchmarks import BenchmarkRunner, BenchmarkState, GenerateAndEvaluate
    from vizier_tpu_torch.benchmarks.analyzers import convergence_curve as cc
    from vizier_tpu_torch.benchmarks.analyzers import exploration_score, state_analyzer
    from vizier_tpu_torch.benchmarks.experimenters import surrogates
    from vizier_tpu_torch.designers.random import RandomDesigner
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import multitask_gp

    label = "benchmarks"
    on_card = device == "cuda"
    phase_start = time.perf_counter()
    kernels.LAUNCH_SHAPES = set()
    paths, figures, states = {}, {}, {}
    runner = BenchmarkRunner([GenerateAndEvaluate(_BENCH_BATCH)], num_repeats=_BENCH_ROUNDS)
    for name, experimenter, algorithm in _benchmark_studies():
        state = BenchmarkState.from_designer_factory(experimenter,
                                                     _bench_factory(algorithm, device))
        _, wall, paths[name] = _path_launches(kernels, lambda: runner.run(state))
        trials = _check_benchmark_trials(state, f"{label} {name}", _BENCH_ROUNDS)
        designer = state.algorithm.policy._designer
        posterior = _trained_posterior(designer)
        dc = int(posterior.data.cont_dim_mask.sum())
        ds = int(posterior.data.cat_dim_mask.sum())
        feasible = sum(t.final_measurement is not None for t in trials)
        print(f"{label} {name}: {algorithm} on {device}, {len(trials)} trials ({feasible} feasible) "
              f"in {_BENCH_ROUNDS} rounds of {_BENCH_BATCH}, layout Dc={dc} Ds={ds}, "
              f"{wall:.1f} s, launches {paths[name]}")
        if on_card:
            _check_posterior_against_cpu(f"{label} {name}", posterior, kernels, gp_lib,
                                         multitask_gp, hold_trained=True,
                                         query=_layout_query(posterior, kernels))
            _require_modes(paths[name], (("matern52_ard_fwd", "gram"),
                                         ("matern52_ard_fwd", "cross"),
                                         ("matern52_ard_bwd", "gram")), f"{label} {name}")
        states[name] = state
        figures[name] = dict(algorithm=algorithm, dc=dc, ds=ds, trials=len(trials),
                             feasible=feasible, wall_s=wall)

    # The sparse Sphere's trained GP bandit as the objective of a random run.
    bandit_state = states["sparse_sphere20"]
    bandit = bandit_state.algorithm.policy._designer
    problem = bandit_state.experimenter.problem_statement()
    predictor_state = BenchmarkState.from_designer_factory(
        surrogates.PredictorExperimenter(bandit, problem, seed=_BENCH_PREDICTOR_SEED),
        lambda p, **kw: RandomDesigner(p.search_space, seed=3))
    _, wall, paths["predictor_random"] = _path_launches(
        kernels, lambda: BenchmarkRunner([GenerateAndEvaluate(_BENCH_BATCH)],
                                         num_repeats=3).run(predictor_state))
    trials = _check_benchmark_trials(predictor_state, f"{label} predictor", 3)
    rng = np.random.default_rng(_BENCH_PREDICTOR_SEED)
    metric = problem.metric_information.item().name
    for r in range(3):
        batch = sorted(trials, key=lambda t: t.id)[r * _BENCH_BATCH:(r + 1) * _BENCH_BATCH]
        want = np.asarray(bandit.predict(
            [vz.TrialSuggestion(parameters=t.parameters) for t in batch], rng).mean).reshape(-1)
        got = np.array([t.final_measurement.metrics[metric].value for t in batch])
        if not (np.array_equal(got, want) and np.all(np.isfinite(got))):
            raise AssertionError(f"{label} predictor: values {got} differ from predict's "
                                 f"means {want}")
    figures["predictor_random"] = dict(trials=len(trials), wall_s=wall,
                                       best=float(min(t.final_measurement.metrics[metric].value
                                                      for t in trials)))
    print(f"{label} PredictorExperimenter over the sparse Sphere's GP bandit as the objective "
          f"of a random run: 15 values equal predict's means for the same rng, {wall:.2f} s, "
          f"launches {paths['predictor_random']}")

    # Random baselines on the combinatorial problems, then the analyzers.
    combinatorial_names = ("nasbench101", "pest_control", "maxsat60")
    baselines = {}
    for name in combinatorial_names:
        experimenter = states[name].experimenter
        baselines[name] = BenchmarkState.from_designer_factory(
            experimenter, lambda p, **kw: RandomDesigner(p.search_space, seed=1))
        runner.run(baselines[name])
        _check_benchmark_trials(baselines[name], f"{label} {name} random", _BENCH_ROUNDS)
    records = state_analyzer.BenchmarkStateAnalyzer.to_records(
        [states[n] for n in combinatorial_names] + [baselines[n] for n in combinatorial_names],
        algorithm_names=["default"] * 3 + ["random"] * 3)
    plot_records, analysis = [], {}
    for name in combinatorial_names:
        curves = {}
        for algorithm, state in (("default", states[name]), ("random", baselines[name])):
            done = state.algorithm.supporter.GetTrials()
            problem = state.experimenter.problem_statement()
            curve = cc.MultiMetricCurveConverter.from_metrics_config(
                problem.metric_information, flip_signs_for_min=True).convert(done)
            plain = cc.ConvergenceCurveConverter(problem.metric_information.item(),
                                                 flip_signs_for_min=True).convert(done)
            ys = curve.ys[0]
            if not np.array_equal(curve.ys, plain.ys) or np.any(ys[1:] < ys[:-1]):
                raise AssertionError(f"{label} {name} {algorithm}: curves disagree or fall")
            curves[algorithm] = curve
            plot_records.append(state_analyzer.BenchmarkRecord(
                algorithm=algorithm, experimenter_metadata={"name": name},
                plot_elements={"objective": state_analyzer.PlotElement(curve=curve)}))
        finite = lambda ys: [float(v) for v in ys if np.isfinite(v)]  # noqa: E731
        relative = cc.build_convergence_curve(finite(curves["random"].ys[0]),
                                              finite(curves["default"].ys[0]))
        entropies = {}
        for algorithm, state in (("default", states[name]), ("random", baselines[name])):
            study = vz.ProblemAndTrials(problem=state.experimenter.problem_statement(),
                                        trials=state.algorithm.supporter.GetTrials())
            entropies[algorithm] = exploration_score.compute_average_marginal_parameter_entropy(
                {algorithm: {name: {0: study}}})
        if not all(np.isfinite(v) and v > 0 for v in entropies.values()):
            raise AssertionError(f"{label} {name}: exploration scores {entropies}")
        analysis[name] = dict(
            best_default=float(curves["default"].ys[0, -1]),
            best_random=float(curves["random"].ys[0, -1]),
            relative_convergence=relative, entropy=entropies)
    scored = state_analyzer.BenchmarkRecordAnalyzer.add_comparison_metrics(plot_records, "random")
    for row in state_analyzer.BenchmarkRecordAnalyzer.summarize(scored):
        if row["algorithm"] == "default":
            analysis[row["experimenter"].split("=")[1]]["scores_vs_random"] = {
                k: v for k, v in row.items() if k.endswith("_vs_random")}
    if len(records) != 6 or not all(r["num_trials"] == 25 for r in records):
        raise AssertionError(f"{label}: state records {records}")
    figures["analysis"] = analysis
    print(f"{label} analyzers over the DEFAULT and random states (best-so-far, flipped for "
          f"MINIMIZE; build_convergence_curve of the DEFAULT against random; marginal "
          f"entropies in nats): {json.dumps(analysis, default=float)}")
    if on_card:
        recorded, kernels.LAUNCH_SHAPES = kernels.LAUNCH_SHAPES, None
        figures["recorded"] = check_recorded_shapes(kernels, lib, recorded, label)
        figures["timed"] = _time_recorded(kernels, recorded, label, per_layout=True)
    kernels.LAUNCH_SHAPES = None
    figures["wall_s"] = time.perf_counter() - phase_start
    print(f"{label}: phase {figures['wall_s']:.1f} s; "
          f"{_card_line() if on_card else 'host path alone, on the CPU'}")
    return paths, figures

# -- tooling: device-phase timing, prewarm, debug locks, the suite ---------------

_ROOT = pathlib.Path(__file__).resolve().parent
# The prewarm walk's live flushes: studies per flush (the executor's
# ``batch_max_size``) and their completed trials (inside the 16-row bucket).
_PREWARM_STUDIES = 4
_PREWARM_TRIALS = (10, 11, 12, 13)


def _default_device_phases(kernels, vz) -> tuple:
    """(a): two DEFAULT requests at full width with device-phase timing on.
    Returns (launches by mode, figures)."""
    from vizier_tpu_torch.designers import gp_ucb_pe
    from vizier_tpu_torch.observability import config as obs_config
    from vizier_tpu_torch.observability import device_timing

    label = "tooling device phases"
    device_timing.set_config(obs_config.ObservabilityConfig())
    # The worker's earlier phases ran these names at the soak's layout; the
    # DEFAULT at full width starts its own first-run (compile) record.
    device_timing.reset_compile_tracking()
    designer = gp_ucb_pe.default_factory(_bench_problem(vz), seed=0, device="cuda")
    latencies, by_mode, _, _ = _serve(vz, kernels, designer, lambda request: None, label,
                                      requests=2)
    rows = [r for r in device_timing.recent() if r[0].startswith("gp_ucb_pe.")]
    want = [("gp_ucb_pe.train_gp", "compile"), ("gp_ucb_pe.acquisition", "compile"),
            ("gp_ucb_pe.train_gp", "execute"), ("gp_ucb_pe.acquisition", "execute")]
    for name, mode, host, event in rows:
        print(f"{label}: {name} mode={mode} host {host:.1f} ms, CUDA events {event:.1f} ms; "
              f"{_card_line()}")
    if [(name, mode) for name, mode, _, _ in rows] != want:
        raise AssertionError(f"{label}: phases {rows}, want {want}")
    late = [r for r in rows if not 0.0 < r[3] <= r[2]]
    if late:
        raise AssertionError(f"{label}: event time not within its host wall: {late}")
    for request, wall in enumerate(latencies):
        train, acquisition = rows[2 * request], rows[2 * request + 1]
        if train[2] + acquisition[2] > wall * 1e3:
            raise AssertionError(
                f"{label} request {request}: train {train[2]:.1f} + acquisition "
                f"{acquisition[2]:.1f} ms exceed the request's {wall * 1e3:.1f} ms")
    return by_mode, dict(requests_ms=[w * 1e3 for w in latencies],
                         phases=[dict(name=n, mode=m, host_ms=h, event_ms=e)
                                 for n, m, h, e in rows])


def _prewarm_trials(vz, dim: int, num_trials: int, seed: int):
    rng = np.random.default_rng(seed)
    trials = []
    for i in range(num_trials):
        t = vz.Trial(id=i + 1, parameters={f"x{j}": float(rng.random()) for j in range(dim)})
        t.complete(vz.Measurement(metrics={"obj": float(rng.normal())}))
        trials.append(t)
    return trials


def _live_flush(runtime, factory, problem, vz, dim: int) -> tuple:
    """One flush of ``_PREWARM_STUDIES`` fresh studies (10-13 completed
    trials: the 16-row bucket) through the runtime's executor, one thread
    per study. Returns (wall s, graph captures it made)."""
    from vizier_tpu_torch.optimizers import graphs

    designers = []
    for s, n in enumerate(_PREWARM_TRIALS):
        d = factory(problem)
        d.update(vz.CompletedTrials(_prewarm_trials(vz, dim, n, seed=s)), vz.ActiveTrials())
        designers.append(d)
    out, errors = [None] * len(designers), []

    def run(i):
        try:
            out[i] = runtime.batch_executor.suggest(designers[i], 1)
        except Exception as e:  # raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(designers))]
    captures = graphs.STATS["captures"]
    flushes = runtime.snapshot()["batch_flushes"]
    start = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    if errors or not all(o is not None and len(o) == 1 for o in out):
        raise AssertionError(f"live flush at {dim}-D: {errors or out}")
    if runtime.snapshot()["batch_flushes"] - flushes != 1:
        raise AssertionError(f"live flush at {dim}-D: {runtime.snapshot()['batch_flushes'] - flushes}"
                             " flushes, want one")
    return wall, graphs.STATS["captures"] - captures


def _prewarm_check(kernels, vz, models) -> tuple:
    """(b): prewarm over the soak's and serving-exact's layouts, the first
    live flush after it and the same flush with the graphs dropped, and the
    compile cache. Returns (launches by mode, figures)."""
    from vizier_tpu_torch.designers import gp_ucb_pe
    from vizier_tpu_torch.observability import device_timing
    from vizier_tpu_torch.ops import native
    from vizier_tpu_torch.optimizers import graphs
    from vizier_tpu_torch.optimizers import lbfgs
    from vizier_tpu_torch.serving import config as serving_config
    from vizier_tpu_torch.serving import runtime as runtime_lib

    label = "tooling prewarm"
    soak = models.soak_config()
    cache_dir = _ROOT / "build" / "vizier_tpu_torch_compile_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)
    config = serving_config.ServingConfig(
        batching_prewarm=True, batch_max_size=_PREWARM_STUDIES, batch_max_wait_ms=2000.0,
        compilation_cache_dir=str(cache_dir))
    figures = dict(layouts={})
    kernels.reset_launch_counts()
    runtime = runtime_lib.ServingRuntime(config)
    try:
        # The compile cache: the kernel library built into the directory the
        # config names, then found there by the next load.
        cold = native.build(native._SOURCE, native.build_dir())
        warm = native.build(native._SOURCE, native.build_dir())
        built = sorted(p.name for p in native.build_dir().glob("*.so"))
        print(f"{label}: compilation_cache_dir -> {native.build_dir()} ({built}); build into "
              f"it {cold.build_seconds:.2f} s, load from it {warm.build_seconds:.3f} s")
        if native.build_dir() != cache_dir.resolve() or not built or warm.build_log:
            raise AssertionError(f"{label}: the kernel library did not build into and load "
                                 f"from {cache_dir}")
        figures.update(cache_dir=str(native.build_dir()), cache_build_s=cold.build_seconds,
                       cache_load_s=warm.build_seconds)

        def factory(p):
            # The soak's designer economics (LoadgenPolicyFactory): Adam ARD
            # steps captured once per layout and replayed.
            return gp_ucb_pe.VizierGPUCBPEBandit(
                p, rng_seed=0, device="cuda", ard_restarts=soak.ard_restarts,
                max_acquisition_evaluations=soak.acquisition_evals, warm_start_min_trials=0,
                ard_optimizer=lbfgs.AdamOptimizer(maxiter=soak.ard_maxiter, device="cuda",
                                                  cuda_graph=True))

        graphs.clear()
        for name, dim in (("soak", soak.dim), ("serving_exact", _DIM)):
            problem = vz.ProblemStatement()
            for j in range(dim):
                problem.search_space.root.add_float_param(f"x{j}", 0.0, 1.0)
            problem.metric_information.append(
                vz.MetricInformation(name="obj", goal=vz.ObjectiveMetricGoal.MAXIMIZE))
            rows = runtime.prewarm_batching(problem, factory)
            for row in rows:
                print(f"{label} {name} ({dim}-D): {row}")
            if not rows or not all(r["status"] == "ok" and r["captures"] > 0 for r in rows):
                raise AssertionError(f"{label} {name}: a prewarm step failed or captured "
                                     f"nothing: {rows}")
            prewarmed_s, prewarmed_captures = _live_flush(runtime, factory, problem, vz, dim)
            phase = [r for r in device_timing.recent() if r[0].endswith("suggest_batched")][-1]
            graphs.clear()
            cold_s, cold_captures = _live_flush(runtime, factory, problem, vz, dim)
            print(f"{label} {name} ({dim}-D): first live flush of {_PREWARM_STUDIES} studies "
                  f"after prewarm {prewarmed_s * 1e3:.1f} ms with {prewarmed_captures} new graph "
                  f"captures; the same flush with no graph prewarmed {cold_s * 1e3:.1f} ms with "
                  f"{cold_captures} captures; the flush's program phase {phase[0]} "
                  f"mode={phase[1]} host {phase[2]:.1f} ms, CUDA events {phase[3]:.1f} ms; "
                  f"{_card_line()}")
            if prewarmed_captures != 0 or cold_captures <= 0:
                raise AssertionError(f"{label} {name}: captures after prewarm "
                                     f"{prewarmed_captures} (want 0), without {cold_captures}")
            if not 0.0 < phase[3] <= phase[2]:
                raise AssertionError(f"{label} {name}: program phase {phase}")
            figures["layouts"][name] = dict(
                dim=dim, rows=rows, prewarmed_flush_ms=prewarmed_s * 1e3,
                prewarmed_captures=prewarmed_captures, cold_flush_ms=cold_s * 1e3,
                cold_captures=cold_captures,
                program_phase=dict(name=phase[0], mode=phase[1], host_ms=phase[2],
                                   event_ms=phase[3]))
    finally:
        runtime.shutdown()
        native.set_build_dir(None)
    by_mode = {name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
    figures["graph_stats"] = dict(graphs.STATS)
    return by_mode, figures


def _debug_locks_check(kernels, vz, models) -> tuple:
    """(c): one soak-layout serving flush with coalescing and speculation
    through the loadgen's runtime transport, every lock it builds recorded
    (``debug_locks.instrument``), each observed edge held to the static lock
    graph. Returns (launches by mode, figures)."""
    import concurrent.futures.thread  # noqa: F401  (imported before the locks are patched)

    from unittest import mock

    from vizier_tpu_torch.analysis import baseline as baseline_lib
    from vizier_tpu_torch.analysis import common as analysis_common
    from vizier_tpu_torch.analysis import debug_locks, lock_order
    from vizier_tpu_torch.analysis import suite as analysis_suite
    from vizier_tpu_torch.loadgen import driver
    from vizier_tpu_torch.reliability import ReliabilityConfig

    label = "tooling debug locks"
    static = lock_order.run(analysis_common.Project(
        [str(_ROOT / "vizier_tpu_torch"), str(_ROOT / "chip_smoke.py")], rel_to=str(_ROOT)))
    scenario = models.build_scenario(models.soak_config())
    specs = [s for s in scenario.studies if s.algorithm == "DEFAULT"][:_PREWARM_STUDIES]
    factory = driver.LoadgenPolicyFactory(scenario, device="cuda")
    reliability = ReliabilityConfig()
    switches = {"VIZIER_TORCH_SPECULATIVE": "1", "VIZIER_TORCH_SERVING_COALESCING": "1",
                "VIZIER_TORCH_BATCHING": "1", "VIZIER_TORCH_BATCH_MAX_WAIT_MS": "2000"}
    accepted = {e.key for e in baseline_lib.load_baseline(
        str(_ROOT / analysis_suite.DEFAULT_BASELINE)).entries if e.pass_name == "debug_locks"}
    kernels.reset_launch_counts()
    with mock.patch.dict(os.environ, switches):
        with debug_locks.instrument() as obs:
            target = driver._RuntimeTarget(scenario, reliability, factory, "cuda")
            try:
                clients = []
                for s, spec in enumerate(specs):
                    client = target.open_study(
                        spec, driver._study_config(spec, scenario.config.dim), reliability, None)
                    for trial in _prewarm_trials(vz, scenario.config.dim, _PREWARM_TRIALS[s], s):
                        made = client.create_trial(vz.Trial(parameters=trial.parameters))
                        client.complete_trial(made.id, trial.final_measurement)
                    clients.append(client)

                def round_(count: int) -> list:
                    out = [None] * len(clients)

                    def run(i):
                        out[i] = clients[i].get_suggestions(count)

                    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(clients))]
                    for th in threads:
                        th.start()
                    for th in threads:
                        th.join(timeout=300)
                    return out

                flushes = []
                for r in range(2):
                    before = target.runtime.snapshot()["batch_flushes"]
                    picks = round_(1)
                    flushes.append(target.runtime.snapshot()["batch_flushes"] - before)
                    if not all(p and len(p) == 1 for p in picks):
                        raise AssertionError(f"{label} round {r}: {picks}")
                    for client, (trial,) in zip(clients, picks):
                        client.complete_trial(trial.id, vz.Measurement(metrics={"obj": 0.5}))
                    # The completions arm speculative jobs on the deferrable lane.
                    deadline = time.time() + 30
                    while (target.runtime.snapshot()["speculative_precomputes"]
                           < len(clients) * (r + 1) and time.time() < deadline):
                        time.sleep(0.05)
                stats = target.runtime.snapshot()
            finally:
                target.runtime.shutdown()
    by_mode = {name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
    check = debug_locks.check_against_static(obs, static, str(_ROOT))
    missing = sorted({(a, b) for a, b, _ in check.missing_static})
    figures = dict(
        acquisitions=obs.acquisitions, observed_edges=len(obs.edges),
        confirmed=sorted(set(check.confirmed)), unmapped_sites=len(check.unmapped_sites),
        baselined=[pair for pair in missing
                   if f"runtime-edge-not-in-static-graph:{pair[0]}->{pair[1]}" in accepted],
        missing=[pair for pair in missing
                 if f"runtime-edge-not-in-static-graph:{pair[0]}->{pair[1]}" not in accepted],
        flushes=flushes, serving={k: stats[k] for k in (
            "batch_flushes", "batched_suggests", "coalesced_requests", "speculative_hits",
            "speculative_precomputes", "speculative_misses")})
    print(f"{label}: {obs.acquisitions} acquisitions, {len(obs.edges)} observed edges, "
          f"{len(figures['confirmed'])} confirmed in the static graph "
          f"({len(static.edges)} edges), {figures['unmapped_sites']} unmapped sites, "
          f"{len(figures['baselined'])} in the baseline {figures['baselined']}, "
          f"{len(figures['missing'])} missing from both: {figures['missing']}; serving "
          f"{figures['serving']}, flushes per round {flushes}")
    if figures["missing"]:
        raise AssertionError(f"{label}: observed lock edges missing from the static graph "
                             f"and the baseline: {figures['missing']}")
    if not figures["confirmed"] or stats["speculative_precomputes"] <= 0:
        raise AssertionError(f"{label}: the flush exercised no lock edge or no speculation")
    return by_mode, figures


def _suite_and_demo(kernels) -> tuple:
    """(d): the analysis suite's command line on this machine, then the
    ``run_benchmark`` demo at its defaults. Returns (launches by mode,
    figures)."""
    from vizier_tpu_torch.demos import run_benchmark

    label = "tooling suite"
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vizier_tpu_torch.analysis"], cwd=_ROOT,
                          capture_output=True, text=True, timeout=300)
    suite_s = time.perf_counter() - start
    print(proc.stdout.strip())
    if proc.returncode != 0:
        print(proc.stderr.strip(), file=sys.stderr)
        raise AssertionError(f"{label}: python -m vizier_tpu_torch.analysis exit "
                             f"{proc.returncode}")
    best, wall, by_mode = _path_launches(kernels, lambda: run_benchmark.main([]))
    print(f"tooling demo: run_benchmark at its defaults (Sphere 4-D, 30 trials x 2 repeats, "
          f"cuda) in {wall:.1f} s: best {best}; {_card_line()}")
    if sorted(best) != ["gp_ucb", "quasirandom", "random"] or not all(
            len(v) == 2 and all(np.isfinite(v)) for v in best.values()):
        raise AssertionError(f"tooling demo: {best}")
    return by_mode, dict(suite_s=suite_s, suite_report=proc.stdout.strip().splitlines()[-2],
                         demo_s=wall, demo_best=best)


def run_tooling_phase(kernels, lib):
    """Phase 18: device-phase timing, prewarm and the compile cache, debug
    locks, the analysis suite and the benchmark demo (see the module
    docstring). Returns ({path: launches by mode}, figures)."""
    del lib
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.loadgen import models

    phase_start = time.perf_counter()
    paths, figures = {}, {}
    paths["tooling_default"], figures["device_phases"] = _default_device_phases(kernels, vz)
    paths["tooling_prewarm"], figures["prewarm"] = _prewarm_check(kernels, vz, models)
    paths["tooling_debug_locks"], figures["debug_locks"] = _debug_locks_check(kernels, vz, models)
    paths["tooling_demo"], figures["suite"] = _suite_and_demo(kernels)
    for path in ("tooling_default", "tooling_prewarm", "tooling_debug_locks", "tooling_demo"):
        _require_modes(paths[path], (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                     ("matern52_ard_bwd", "gram")), path)
    figures["wall_s"] = time.perf_counter() - phase_start
    print(f"tooling: phase {figures['wall_s']:.1f} s; {_card_line()}")
    return paths, figures

# -- phase 19: the single-host mesh ---------------------------------------------

# Parts (b) and (d) run on a mesh of this many entries of the one card.
_MESH_LOGICAL = 4
# Part (b)'s pool budget, cut from 75 000: its 4 pools run twice (sharded,
# then one after another).
_MESH_SWEEP_EVALS = 5_000
# Part (b): sharded against unsharded, |difference| relative to
# max(1, |value|): the trained NLL (chunks of one restart round otherwise
# than one batch of four, C6, and L-BFGS carries that into its iterates: on
# a flat optimum the chosen parameters move by a few 1e-2, printed) and the
# sweep's top scores and features.
_MESH_TOL = 1e-3
# Part (b): the sharded train's chosen parameters against the unsharded
# optimizer run once per restart row (batch 1, as each chunk), relative to
# the largest parameter.
_MESH_ROW_TOL = 1e-5


@contextlib.contextmanager
def _logical_devices(n: int):
    """The port's device list as ``n`` entries of cuda:0, inside the block."""
    from vizier_tpu_torch import parallel
    from vizier_tpu_torch.parallel import mesh as mesh_lib

    saved = mesh_lib.local_devices, parallel.local_devices

    def devices(device="cuda"):
        del device
        return [torch.device("cuda", 0)] * n

    mesh_lib.local_devices = parallel.local_devices = devices
    print(f"mesh: local_devices patched to {n} entries of cuda:0 for this part alone")
    try:
        yield
    finally:
        mesh_lib.local_devices, parallel.local_devices = saved


def _mesh_default(kernels, vz) -> tuple:
    """(a) The DEFAULT with ``use_mesh=True`` on the card's device list."""
    from vizier_tpu_torch import parallel
    from vizier_tpu_torch.designers import gp_ucb_pe
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import multitask_gp
    from vizier_tpu_torch.parallel import mesh as mesh_lib

    placements = mesh_lib.build_placements(mesh_lib.MeshConfig(enabled=True))
    designer = gp_ucb_pe.VizierGPUCBPEBandit(_bench_problem(vz), rng_seed=0, use_mesh=True)
    calls = {"restarts": [], "pools": []}
    real_train, real_sweep = parallel.train_gp_sharded, parallel.maximize_score_fn_sharded

    def train(*args, **kwargs):
        calls["restarts"].append(args[4])
        return real_train(*args, **kwargs)

    def sweep(*args, **kwargs):
        calls["pools"].append(args[4])
        return real_sweep(*args, **kwargs)

    states = []

    def check_state(request):
        (state,) = designer._cached_states[0]
        states.append(state)
        if not bool(torch.isfinite(state.chol).all()):
            raise AssertionError(f"mesh DEFAULT request {request}: non-finite Cholesky factor")

    parallel.train_gp_sharded, parallel.maximize_score_fn_sharded = train, sweep
    try:
        latencies, by_mode, peak, _ = _serve(vz, kernels, designer, check_state, "mesh DEFAULT")
    finally:
        parallel.train_gp_sharded, parallel.maximize_score_fn_sharded = real_train, real_sweep
    print(f"mesh (a): {len(placements)} placement(s) {[p.describe() for p in placements]}, "
          f"designer mesh {designer._mesh.devices}, restarts per train {calls['restarts']} "
          f"(ard_restarts {designer.ard_restarts}), pools per sweep {calls['pools']}, "
          f"suggest(5) {latencies[0] * 1e3:.1f} ms, peak {peak} B, launches {by_mode}")
    if len(placements) != 1 or designer._mesh.size != 1:
        raise AssertionError("mesh (a): one card must be one placement and a mesh of one")
    if calls["restarts"] != [designer._mesh_restarts(designer.ard_restarts)]:
        raise AssertionError(f"mesh (a): restarts {calls['restarts']}")
    if not calls["pools"] or set(calls["pools"]) != {1}:
        raise AssertionError(f"mesh (a): pools per sweep {calls['pools']}")
    _require_modes(by_mode, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                             ("matern52_ard_bwd", "gram")), "mesh DEFAULT")
    _check_posterior_against_cpu("mesh DEFAULT", states[-1], kernels, gp_lib, multitask_gp,
                                 hold_trained=True)
    return by_mode, dict(wall_ms=latencies[0] * 1e3, restarts=calls["restarts"],
                         pools=calls["pools"], placements=len(placements))


def _mesh_sharded_vs_unsharded(kernels, vz) -> tuple:
    """(b) The sharded train and sweep on the logical mesh against the
    unsharded ones, at bench.py's study, from fixed inits and pool seeds."""
    from vizier_tpu_torch import parallel
    from vizier_tpu_torch.designers import gp_ucb_pe
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.optimizers import graphs as graphs_lib
    from vizier_tpu_torch.optimizers import lbfgs
    from vizier_tpu_torch.optimizers import vectorized

    encoder = gp_ucb_pe.VizierGPUCBPEBandit(_bench_problem(vz), rng_seed=0)
    encoder.update(vz.CompletedTrials(_bench_trials(vz, _NUM_TRIALS, _DIM)))
    cuda = torch.device("cuda", 0)
    data = gp_lib.GPData.from_model_data(encoder._warped_model_data(), cuda)
    model, optimizer = encoder._model, encoder._ard
    restarts = _MESH_LOGICAL
    inits = model.param_collection().batch_random_init_unconstrained(
        torch.Generator(device=cuda).manual_seed(0), restarts)
    with _logical_devices(_MESH_LOGICAL):
        mesh = parallel.create_mesh()
    sharded, train_s, train_launches = _path_launches(kernels, lambda: parallel.train_gp_sharded(
        model, optimizer, data, None, restarts, 1, mesh, inits=inits))
    t0 = time.perf_counter()
    whole = optimizer(graphs_lib.BoundLoss(model.neg_log_likelihood, data), inits, best_n=1)
    alone = model.precompute(whole.params, data)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    scale = max(float(torch.max(torch.abs(v))) for v in alone.params.values())
    param_err = max(float(torch.max(torch.abs(sharded.params[k] - v))) for k, v in
                    alone.params.items()) / scale
    # The witness: each restart row alone through the unsharded optimizer,
    # the rows then selected as one call selects them.
    t0 = time.perf_counter()
    rows = [optimizer(graphs_lib.BoundLoss(model.neg_log_likelihood, data),
                      {k: v[i:i + 1] for k, v in inits.items()}, best_n=1)
            for i in range(restarts)]
    per_row = model.precompute(lbfgs._select_best(
        {k: torch.cat([r.params[k] for r in rows]) for k in rows[0].params},
        torch.cat([r.losses for r in rows]), 1).params, data)
    torch.cuda.synchronize()
    rows_s = time.perf_counter() - t0
    row_err = max(float(torch.max(torch.abs(sharded.params[k] - v))) for k, v in
                  per_row.params.items()) / scale
    coll = model.param_collection()
    nll = [float(model.neg_log_likelihood(coll.unconstrain(s.params), data)[0])
           for s in (sharded, alone)]
    nll_err = abs(nll[0] - nll[1]) / max(1.0, abs(nll[1]))
    scoring = acquisitions.ScoringFunction(
        predictive=gp_lib.EnsemblePredictive(alone), acquisition=acquisitions.UCB(1.8),
        best_label=acquisitions.get_best_labels(data.labels, data.row_mask),
        trust_region=acquisitions.TrustRegion.from_data(data))
    vec = vectorized.VectorizedOptimizer(encoder._vec_opt.strategy,
                                         max_evaluations=_MESH_SWEEP_EVALS)

    def generators():
        return [torch.Generator(device=cuda).manual_seed(i) for i in range(_MESH_LOGICAL)]

    pooled, sweep_s, sweep_launches = _path_launches(
        kernels, lambda: parallel.maximize_acquisition_sharded(
            vec, scoring, generators(), _COUNT, _MESH_LOGICAL, mesh))
    t0 = time.perf_counter()
    one_by_one = [vec(scoring.score, g, count=_COUNT) for g in generators()]
    scores = torch.cat([r.scores for r in one_by_one])
    top = torch.sort(scores, descending=True, stable=True).indices[:_COUNT]
    want_scores = scores[top]
    want_cont = torch.cat([r.features.continuous for r in one_by_one])[top]
    torch.cuda.synchronize()
    pools_s = time.perf_counter() - t0
    score_err = float(torch.max(torch.abs(pooled.scores - want_scores))) / max(
        1.0, float(torch.max(torch.abs(want_scores))))
    feature_err = float(torch.max(torch.abs(pooled.features.continuous - want_cont)))
    print(f"mesh (b): {_MESH_LOGICAL}-entry mesh of the card: sharded train {train_s * 1e3:.1f} ms "
          f"against unsharded {whole_s * 1e3:.1f} ms, chosen params max rel err {param_err:.3e}, "
          f"(not held), NLL {nll[0]:.6f} / {nll[1]:.6f} (rel {nll_err:.2e}); against the "
          f"unsharded optimizer once per row ({rows_s * 1e3:.1f} ms) chosen params max rel err "
          f"{row_err:.3e} (tol {_MESH_ROW_TOL}); {_MESH_LOGICAL} "
          f"pools of "
          f"{_MESH_SWEEP_EVALS} evaluations sharded {sweep_s * 1e3:.1f} ms against one after "
          f"another {pools_s * 1e3:.1f} ms, top {_COUNT} scores max rel err {score_err:.3e}, "
          f"features max abs err {feature_err:.3e} (tol {_MESH_TOL})")
    if not max(nll_err, score_err, feature_err) <= _MESH_TOL:
        raise AssertionError("mesh (b): the sharded train or sweep differs from the unsharded one")
    if not row_err <= _MESH_ROW_TOL:
        raise AssertionError("mesh (b): the sharded train differs from its restarts run one by one")
    by_mode = {name: {m: train_launches[name][m] + sweep_launches[name][m]
                      for m in train_launches[name]} for name in train_launches}
    _require_modes(by_mode, (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                             ("matern52_ard_bwd", "gram")), "mesh sharded train and sweep")
    return by_mode, dict(train_ms=train_s * 1e3, unsharded_train_ms=whole_s * 1e3,
                         sweep_ms=sweep_s * 1e3, pools_one_by_one_ms=pools_s * 1e3,
                         param_err=param_err, nll_err=nll_err, score_err=score_err,
                         rows_one_by_one_ms=rows_s * 1e3, row_param_err=row_err,
                         feature_err=feature_err)


def _mesh_round(mods, kernels, mesh_config, label: str, logical: bool = False):
    """Serving-exact's 8 studies, fresh, through one runtime with
    ``mesh_config``: (results, wall s, launches by mode, runtime stats delta,
    the fleet, graph-capture failures, the executor's chunks per flush)."""
    from vizier_tpu_torch.optimizers import graphs as graphs_lib

    serving, batch_executor = mods["serving"], mods["batch_executor"]
    config = dataclasses.replace(serving.ServingConfig(), batch_max_wait_ms=_SERVE_WINDOW_MS)
    with _logical_devices(_MESH_LOGICAL) if logical else contextlib.nullcontext():
        runtime = serving.ServingRuntime(config, mesh=mesh_config)
    fleet = _Fleet(mods, runtime, "DEFAULT", _SERVE_TRIALS["exact"], label)
    chunks = []
    real_place = batch_executor.place_batch

    def place(tree, placement=None):
        out = real_place(tree, placement)
        chunks.append([len(batch_executor.tree_leaves(c)[0]) for c in out])
        return out

    failures = graphs_lib.STATS["failures"]
    batch_executor.place_batch = place
    try:
        kernels.reset_launch_counts()
        (results, wall, _) = fleet.round(_COUNT, concurrent=True)
        torch.cuda.synchronize()
        by_mode = {name: dict(modes) for name, modes in kernels.LAUNCHES_BY_MODE.items()}
    finally:
        batch_executor.place_batch = real_place
    stats = {k: runtime.stats.get(k) for k in (
        "batch_flushes", "batched_suggests", "batch_fallbacks", "batch_slot_errors",
        "mesh_flushes")}
    _check_round(results, _COUNT, label)
    executor = runtime.batch_executor
    out = dict(results=results, wall=wall, by_mode=by_mode, stats=stats, fleet=fleet,
               failures=graphs_lib.STATS["failures"] - failures, chunks=chunks,
               placements=executor.placements(), workers=len(executor._workers),
               flush_counts=executor.placement_flush_counts())
    print(f"{label}: one round of 8 concurrent suggest({_COUNT}) {wall * 1e3:.1f} ms, {stats}, "
          f"placements {[p.describe() for p in out['placements']]}, worker threads "
          f"{out['workers']}, flushes per placement {out['flush_counts']}, rows per chunk "
          f"{chunks}, graph capture failures {out['failures']}, launches {by_mode}")
    if (stats["batch_flushes"] != 1 or stats["batched_suggests"] != _SERVE_STUDIES
            or stats["batch_fallbacks"] or stats["batch_slot_errors"]):
        raise AssertionError(f"{label}: not one flush of occupancy 8: {stats}")
    runtime.shutdown()
    return out


def _mesh_slot_parity(reference, got, label: str, exact: bool) -> dict:
    """Each slot of ``got`` against the same study in ``reference``: its
    trained NLL within _NLL_TOL; with ``exact`` its suggestions equal."""
    worst, equal = 0.0, 0
    for i in range(_SERVE_STUDIES):
        states = [_trained_state(run["fleet"].designer(i), False) for run in (got, reference)]
        coll = states[0].model.param_collection()
        nll = [float(s.model.neg_log_likelihood(coll.unconstrain(s.params), s.data)[0])
               for s in states]
        worst = max(worst, abs(nll[0] - nll[1]) / max(1.0, abs(nll[1])))
        same = ([s.parameters.as_dict() for s in got["results"][i]]
                == [s.parameters.as_dict() for s in reference["results"][i]])
        equal += int(same)
    print(f"{label}: slots with suggestions equal to the mesh-off flush's {equal}/"
          f"{_SERVE_STUDIES}; worst trained-NLL rel {worst:.2e} (tol {_NLL_TOL})")
    if not worst <= _NLL_TOL or (exact and equal != _SERVE_STUDIES):
        raise AssertionError(f"{label}: slot parity with the mesh-off flush does not hold")
    return dict(equal_slots=equal, worst_nll_rel=worst)


def run_mesh_phase(kernels, lib):
    """Phase 19: the single-host mesh (see the module docstring). Returns
    ({path: launches by mode}, figures)."""
    del lib
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch.parallel import mesh as mesh_lib

    mods = _phase_modules()
    phase_start = time.perf_counter()
    paths, figures = {}, {}
    paths["mesh_default"], figures["default"] = _mesh_default(kernels, vz)
    paths["mesh_sharded"], figures["sharded"] = _mesh_sharded_vs_unsharded(kernels, vz)
    off = _mesh_round(mods, kernels, mesh_lib.MeshConfig(), "mesh (c) mesh off")
    one = _mesh_round(mods, kernels, mesh_lib.MeshConfig(enabled=True), "mesh (c) one placement")
    if (len(one["placements"]) != 1 or one["workers"] or one["flush_counts"] != {"mesh0": 1}
            or one["stats"]["mesh_flushes"] != 1 or one["chunks"] != [[8]]):
        raise AssertionError("mesh (c): not one flush on mesh0 run by the scheduler thread")
    logical = _mesh_round(mods, kernels, mesh_lib.MeshConfig(enabled=True, shard_devices=4),
                          "mesh (d) 4-entry logical mesh", logical=True)
    (placement,) = logical["placements"]
    if (placement.num_devices != _MESH_LOGICAL or placement.pad_to(_SERVE_STUDIES, 8) != 8
            or logical["chunks"] != [[2] * _MESH_LOGICAL] or logical["failures"]):
        raise AssertionError("mesh (d): not one padded flush split over the 4 entries")
    figures["executor"] = dict(
        off_wall_ms=off["wall"] * 1e3, one_placement_wall_ms=one["wall"] * 1e3,
        logical_wall_ms=logical["wall"] * 1e3, chunks=logical["chunks"],
        capture_failures=logical["failures"],
        one_placement=_mesh_slot_parity(off, one, "mesh (c) one placement", exact=True),
        logical=_mesh_slot_parity(off, logical, "mesh (d) 4-entry logical mesh", exact=False))
    for name, run in (("off", off), ("one", one), ("logical", logical)):
        paths[f"mesh_executor_{name}"] = run["by_mode"]
        _require_modes(run["by_mode"], (("matern52_ard_fwd", "gram"), ("matern52_ard_fwd", "cross"),
                                        ("matern52_ard_bwd", "gram")), f"mesh executor {name}")
    figures["wall_s"] = time.perf_counter() - phase_start
    print(f"mesh: phase {figures['wall_s']:.1f} s; {_card_line()}")
    return paths, figures

# -- worker processes ----------------------------------------------------------

# The phases are host-bound (PERF.md §5): the card idles while one Python
# thread feeds it. So once the kernels are built, checked and timed on an
# otherwise idle card, the phases that need nothing of the main path run in
# worker processes on the same card, this script again with ``--worker``,
# beside the main process's phases. A worker resets and reads its own launch
# counts around each path, as the main process does, writes its lines to a log
# the main process prints when it has finished, and its paths and figures to a
# JSON file. A worker that fails fails the run.
_WORKER_PHASES = {
    "regret": ("regret",),
    "serving": ("serving_exact", "serving_sparse", "gp_surface", "fleet"),
    "loadgen": ("loadgen", "testing", "benchmarks", "tooling", "mesh"),
}
# Seconds from the phases' start after which a worker still running is
# stopped and the run fails, inside the script's 1 200 s limit.
_WORKER_LIMIT_S = 1050.0


def _mark(start: float, label: str) -> None:
    print(f"[{time.time() - start:.1f} s] {label}", flush=True)


def _phase_modules() -> dict:
    from vizier_tpu_torch import pyvizier as vz
    from vizier_tpu_torch import serving
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.parallel import batch_executor
    from vizier_tpu_torch.pythia import local_policy_supporters
    from vizier_tpu_torch.pythia import policy as policy_lib
    from vizier_tpu_torch.pyvizier import study_config
    from vizier_tpu_torch.service import policy_factory

    return dict(vz=vz, study_config=study_config, lps=local_policy_supporters,
                policy_factory=policy_factory, policy=policy_lib, serving=serving,
                batch_executor=batch_executor, gp=gp_lib)


def _run_worker_phase(phase: str, kernels, lib, mods):
    """(launches by mode, figures) of one of ``_WORKER_PHASES``' phases."""
    if phase.startswith("serving_"):
        return run_serving_phase(phase.split("_", 1)[1], mods, kernels)
    if phase == "regret":
        return run_regret_phase(kernels, lib)
    if phase == "gp_surface":
        return run_gp_surface_phase(kernels, lib)
    if phase == "fleet":
        return run_fleet_phase(mods, kernels)
    if phase == "loadgen":
        return run_loadgen_phase(kernels, lib)
    if phase == "testing":
        return run_testing_phase(kernels, lib)
    if phase == "benchmarks":
        return run_benchmarks_phase(kernels, lib)
    if phase == "tooling":
        return run_tooling_phase(kernels, lib)
    if phase == "mesh":
        return run_mesh_phase(kernels, lib)
    raise ValueError(f"unknown phase {phase!r}")


def run_worker(name: str, result: str, start: float) -> int:
    """A worker process: runs ``_WORKER_PHASES[name]`` and writes
    {phase: {"paths": ..., "figures": ...}} to ``result``."""
    from vizier_tpu_torch import device as device_lib
    from vizier_tpu_torch.models import kernels
    from vizier_tpu_torch.ops import native

    device_lib.resolve("cuda")
    lib = native.library()  # built by the main process: loaded as it is
    mods = _phase_modules()
    out, failed = {}, []
    for phase in _WORKER_PHASES[name]:
        # A failed phase does not stop the worker's later ones: each is
        # checked and reported, and the worker exits 1 after the last.
        try:
            paths, figures = _run_worker_phase(phase, kernels, lib, mods)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
            _mark(start, f"{phase.replace('_', '-')} phase FAILED (worker {name})")
            continue
        finally:
            pathlib.Path(f"{result}.{phase}.ended").touch()
        out[phase] = dict(paths=paths, figures=figures)
        _mark(start, f"{phase.replace('_', '-')} phase done (worker {name})")
    pathlib.Path(result).write_text(json.dumps(out))
    return 1 if failed else 0


def _start_workers(tmp: str, start: float, names) -> dict:
    workers = {}
    for name in names:
        files = {kind: os.path.join(tmp, f"{name}.{kind}") for kind in ("out", "err", "json")}
        with open(files["out"], "w") as out, open(files["err"], "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", name,
                 "--result", files["json"], "--start", repr(start)],
                stdout=out, stderr=err, stdin=subprocess.DEVNULL)
        workers[name] = (proc, files)
    return workers


def _await_phase(worker, phase: str, start: float) -> None:
    """Waits until ``worker`` has ended ``phase`` (done or failed), has
    exited, or has run out of time."""
    proc, files = worker
    ended = pathlib.Path(f"{files['json']}.{phase}.ended")
    while not ended.exists() and proc.poll() is None and time.time() < start + _WORKER_LIMIT_S:
        time.sleep(0.2)


def _join_workers(workers: dict, start: float) -> dict:
    """Waits for every worker, prints its log, and returns {phase: {"paths",
    "figures"}} over all of them; raises if one failed or ran out of time."""
    results, failed = {}, []
    for name, (proc, files) in workers.items():
        try:
            rc = proc.wait(timeout=max(1.0, start + _WORKER_LIMIT_S - time.time()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = f"stopped after {_WORKER_LIMIT_S:.0f} s"
        print(f"-- worker {name} ({', '.join(_WORKER_PHASES[name])}): exit {rc} --")
        print(pathlib.Path(files["out"]).read_text(), end="", flush=True)
        sys.stderr.write(pathlib.Path(files["err"]).read_text())
        if rc != 0:
            failed.append(f"{name}: exit {rc}")
            continue
        results.update(json.loads(pathlib.Path(files["json"]).read_text()))
    if failed:
        raise AssertionError(f"worker processes failed: {failed}")
    return results


def _stop_workers(workers: dict) -> None:
    for proc, _ in workers.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline-source", default=None,
                        help="commit a3a3a6f's matern52.cu, to time beside the current kernels")
    parser.add_argument("--previous-source", default=None,
                        help="commit 997e03e's matern52.cu: today's shared-input launches must "
                             "give its floats bit for bit")
    parser.add_argument("--worker", choices=sorted(_WORKER_PHASES), default=None,
                        help="run as one of the main process's worker processes")
    parser.add_argument("--result", default=None, help="a worker's JSON result file")
    parser.add_argument("--start", type=float, default=None,
                        help="the main process's phase clock (time.time()) for a worker's marks")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if opts.worker:
        return run_worker(opts.worker, opts.result, opts.start)
    from vizier_tpu_torch import device as device_lib
    from vizier_tpu_torch import surrogates
    from vizier_tpu_torch.designers import gp_bandit, gp_ucb_pe
    from vizier_tpu_torch.designers.gp import acquisitions
    from vizier_tpu_torch.models import gp as gp_lib
    from vizier_tpu_torch.models import kernels
    from vizier_tpu_torch.models import multitask_gp
    from vizier_tpu_torch.ops import native
    from vizier_tpu_torch.ops import pareto
    from vizier_tpu_torch.surrogates import sparse_gp

    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    device_lib.resolve("cuda")
    lib = native.library()
    print(f"kernel build: {lib.build_seconds:.1f} s")
    print(lib.build_log.strip())

    start = time.time()
    timed = check_kernels(kernels, lib)
    if opts.previous_source:
        check_previous_bit_identity(kernels, _load_previous(opts.previous_source))
    tiles = compare_tiles(kernels, lib)
    _mark(start, "kernel checks done")
    timing = time_kernels(kernels, timed)
    baseline = None
    if opts.baseline_source:
        baseline = time_baseline(kernels, _load_baseline(opts.baseline_source), timed)
    _mark(start, "kernel timing done")

    mods = _phase_modules()
    vz = mods["vz"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_workers_") as tmp:
        # The loadgen phase measures a serving plane's latency and
        # speculative hits: it has the card and the host to itself, and the
        # other workers and this process's phases start once it has ended.
        workers = _start_workers(tmp, start, ("loadgen",))
        try:
            _await_phase(workers["loadgen"], "loadgen", start)
            _mark(start, "loadgen phase ended; starting the other workers")
            workers.update(_start_workers(
                tmp, start, [name for name in _WORKER_PHASES if name != "loadgen"]))
            designer, launches, by_mode, exact_timers = run_main_path(
                vz, gp_ucb_pe, kernels, gp_lib, multitask_gp)
            _mark(start, "main path done")
            profile_request(designer, "exact")
            _mark(start, "profiled request done")
            sparse_designer, sparse_launches, sparse_by_mode, bandit_timers = run_sparse_path(
                vz, gp_ucb_pe, gp_bandit, kernels, sparse_gp, surrogates)
            _mark(start, "sparse path done")
            profile_request(sparse_designer, "sparse")
            _mark(start, "profiled sparse request done")
            mo_paths = run_multiobjective_path(vz, gp_ucb_pe, gp_bandit, kernels, gp_lib,
                                               surrogates, acquisitions, multitask_gp, pareto)
            _mark(start, "multi-objective path done")
            algorithm_paths, algorithm_figures = run_algorithms_phase(kernels, lib, mods)
            _mark(start, "algorithms phase done")
            print(json.dumps({"algorithms": algorithm_figures}))
            extras_paths, extras_figures, time_features = run_algorithm_extras_phase(
                kernels, lib, mods, designer)
            _mark(start, "algorithm extras phase done")
            extras_figures["phase_timers_ms"] = {"exact_request": exact_timers,
                                                 "gp_bandit_sparse_suggest": bandit_timers}
            service_paths, service_figures = run_service_reliability_phase(kernels, lib, mods)
            _mark(start, "service-reliability phase done")
            print(json.dumps({"service_reliability": service_figures}))
            planes_paths, planes_figures = run_service_planes_phase(kernels, lib, mods)
            _mark(start, "service-planes phase done")
            print(json.dumps({"service_planes": planes_figures}))
            done = _join_workers(workers, start)
        finally:
            _stop_workers(workers)
    _mark(start, "worker phases done")
    time_features()
    print(json.dumps({"algorithm_extras": extras_figures}))
    serving_paths, serving_figures = {}, {}
    for kind in ("exact", "sparse"):
        serving_paths[f"serving_{kind}"] = done[f"serving_{kind}"]["paths"]
        serving_figures[kind] = done[f"serving_{kind}"]["figures"]
    print(json.dumps({"serving": serving_figures}))
    regret_paths, regret_figures = done["regret"]["paths"], done["regret"]["figures"]
    print(json.dumps({"regret": regret_figures}))
    surface_paths = done["gp_surface"]["paths"]
    print(json.dumps({"gp_surface": done["gp_surface"]["figures"]}))
    fleet_paths = done["fleet"]["paths"]
    print(json.dumps({"fleet": done["fleet"]["figures"]}))
    slice_paths = {**done["loadgen"]["paths"], **done["testing"]["paths"],
                   **done["benchmarks"]["paths"], **done["tooling"]["paths"],
                   **done["mesh"]["paths"]}
    print(json.dumps({"loadgen": done["loadgen"]["figures"]}))
    print(json.dumps({"testing": done["testing"]["figures"]}))
    print(json.dumps({"benchmarks": done["benchmarks"]["figures"]}))
    print(json.dumps({"tooling": done["tooling"]["figures"]}, default=float))
    print(json.dumps({"mesh": done["mesh"]["figures"]}, default=float))

    # One JSON row per kernel, at the shape that carries most of its launches
    # on this slice's main path, the regret phase's lockstep flushes (K1: the
    # sweep cross kernel at the last rounds' 256 rows; K2: the cold Gram
    # there), with every timed shape under "by_shape". "launches" is the
    # lockstep run's count; every path's is under "launches_by_mode_by_path".
    headline = {"fwd": _REGRET_SWEEP, "bwd": _REGRET_GRAM}
    main_launches = {name: sum(regret_paths["regret_lockstep"][name].values())
                     for name in ("matern52_ard_fwd", "matern52_ard_bwd")}
    rows = []
    for key, name in (("fwd", "matern52_ard_fwd"), ("bwd", "matern52_ard_bwd")):
        by_shape = {}
        for shape, t in timing.items():
            by_shape[shape] = _by_shape_row(t[key])
            if baseline is not None:
                by_shape[shape]["baseline_ms"] = baseline[shape][f"{key}_ms"]
                if key == "fwd":
                    by_shape[shape]["baseline_with_masking_ms"] = baseline[shape]["fwd_masked_ms"]
        for phase in ("loadgen", "testing", "benchmarks"):
            for shape, row in done[phase]["figures"]["timed"].items():
                by_shape[shape] = row[key]
        head = by_shape[headline[key]]
        rows.append({
            "name": name, "route": "cuda", "source": "vizier_tpu_torch/csrc/matern52.cu",
            "replaces": _REPLACES, "launches": main_launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": headline[key], "host_us": head["host_us"],
            "launches_by_mode": regret_paths["regret_lockstep"][name],
            "launches_sparse_path": sparse_launches[name],
            "launches_by_mode_sparse_path": sparse_by_mode[name],
            # The batching-off reference's 8 sequential requests, apart.
            "launches_serving_batching_off": {
                kind: sum(figures["launches_batching_off"][name].values())
                for kind, figures in serving_figures.items()},
            "launches_by_mode_by_path": {
                "exact": by_mode[name], "sparse": sparse_by_mode[name],
                **{path: modes[name] for path, modes in mo_paths.items()},
                **{path: modes[name] for path, modes in serving_paths.items()},
                **{path: modes[name] for path, modes in regret_paths.items()},
                **{path: modes[name] for path, modes in surface_paths.items()},
                **{path: modes[name] for path, modes in algorithm_paths.items()},
                **{path: modes[name] for path, modes in extras_paths.items()},
                **{path: modes[name] for path, modes in service_paths.items()},
                **{path: modes[name] for path, modes in planes_paths.items()},
                **{path: modes[name] for path, modes in fleet_paths.items()},
                **{path: modes[name] for path, modes in slice_paths.items()}},
            "launches_algorithms_phase": sum(
                sum(modes[name].values()) for modes in algorithm_paths.values()),
            "launches_algorithm_extras_phase": sum(
                sum(modes[name].values()) for modes in extras_paths.values()),
            "launches_fleet_phase": sum(
                sum(modes[name].values()) for modes in fleet_paths.values()),
            "launches_loadgen_phase": sum(
                sum(done["loadgen"]["paths"][path][name].values())
                for path in done["loadgen"]["paths"]),
            "launches_testing_phase": sum(
                sum(done["testing"]["paths"][path][name].values())
                for path in done["testing"]["paths"]),
            "launches_benchmarks_phase": sum(
                sum(done["benchmarks"]["paths"][path][name].values())
                for path in done["benchmarks"]["paths"]),
            "launches_tooling_phase": sum(
                sum(done["tooling"]["paths"][path][name].values())
                for path in done["tooling"]["paths"]),
            "launches_mesh_phase": sum(
                sum(done["mesh"]["paths"][path][name].values())
                for path in done["mesh"]["paths"]),
            "by_shape": by_shape,
            "tiles_at_cross_shapes": {
                shape: {"chosen": row["chosen"], **{
                    tile: row[tile][f"{key}_ms"] for tile in _TILE_KINDS.values()}}
                for shape, row in tiles.items()},
        })
    # K2's feature kernel, which L-BFGS-B's path launches alone, at its
    # layout ("ms", "plain_ms", "bound_ms": that launch); beside it K2 with
    # the parameters too, and parameters only.
    k2f = extras_figures["k2_features"]
    rows[1]["feature_gradient"] = {
        "shape": k2f["shape"], "launches": k2f["launches"], "ms": k2f["features_only_ms"],
        "plain_ms": k2f["features_only_plain_ms"], "bound_ms": k2f["features_only_bound"][0],
        "bound_by": k2f["features_only_bound"][1], "library_ms": k2f["library_ms"],
        "max_abs_err": k2f["max_abs_err"], "with_params_ms": k2f["ms"],
        "with_params_plain_ms": k2f["plain_ms"], "with_params_bound_ms": k2f["bound"][0],
        "with_params_bound_by": k2f["bound"][1], "params_only_ms": k2f["params_only_ms"]}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
