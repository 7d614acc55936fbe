#!/usr/bin/env python3
"""Runs gpy_tpu_torch on one CUDA card and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  -- torch and CUDA versions, the card's name and power limit,
                the host's CPU model and clock, and the host's dispatch
                floor: us to enqueue one tiny operation, and one launch
                with its read back;
  2. build   -- every csrc/*.cu compiled with nvcc (all at once), seconds;
  3. kernels -- each kernel against its plain torch version on the card,
                forward and backward, float32 and float64;
  4. slice   -- the exact-GP main path at bench.py's N=8192 D=8 RBF-ARD
                configuration in float32: log_likelihood, objective and
                gradient, optimize(max_iters=5), predict and
                predict_quantiles on 2048 new points, with the launch
                counters read around it and an float64 twin as reference;
  5. times   -- CUDA-event times of each kernel beside its plain version and
                its bound, objective+gradient and predict times;
  6. profile -- device time by kernel over one objective+gradient;
  7. kernels_fused -- the fused Gram-matvec (B5) against its plain twin for
                the four families, the three accum modes and 38 shapes
                (four of them the wide kernel's, R > 16; 25 at D > 8, R <=
                16: the cross-term kernel at D = 9, 12, 20, 33 by R = 1, 9,
                16, square and rectangular, and D = 72 past its cap; and on
                unaligned views), the wide kernel's and the cross-term
                kernel's second launches bit for bit against their first,
                K_ii exactly v on square calls of the cross-term kernel,
                the sharded slab's rows at D = 12 bit for bit against the
                square product's,
                and its gradient moments (B6, through the autograd
                Function) against autograd of the plain twin for the four
                families at D = 1, 4, 8, 12 by R = 1, 9, 16 and two ragged
                N, the mma kernel's domain (R = 17, 64 and 72; D = 20, 33,
                72 and 127; ragged N at D = 12 and R = 17), and on
                unaligned views;
  8. iterative -- the iterative exact-GP main path at bench.py's N=50,000
                D=4 configuration in float32, two models: fused=True,
                materialize=False (B5/B6) and the default materialized
                Gram (B1, fast_grad): log_likelihood, objective and
                gradient, predict on 256 new points, optimize(max_iters=2),
                predict and predict_quantiles, launch counters read
                around each step, a float64 materialized twin at the
                same probes as reference, the exact NLML (float64
                Cholesky) at the start and after optimize, and the fused
                model's predict variance against its CG through the
                float64 plain twin;
  9. iterative_times -- B5 at N=50,000 by the profiler's device time and
                by CUDA events (R = 9, 16, 256, 1, 17, 64, 1024), B6 (and
                its reduce) by
                the profiler's device time and by events (R = 9, and the
                mma kernel at R = 17 on signed inputs, a second launch bit
                for bit and its own limit), each
                beside its plain twin and bounds, each kernel's error there
                checked against its plain twin, NLML+gradient and predict
                times of both models, the materialized matvec's matmul;
 10. iterative_profile -- device time by kernel over one NLML+gradient of
                each model;
 11. iterative_d12 -- the same configuration at D=12 (X ~ U[0,10)^12, an
                ARD RBF from lengthscale 3.0), fused: the user's steps with
                the launch counters (49 B5 launches and one B6 an
                objective_and_grad, B5's under the cross-term kernel's
                profiler name, B6's under its mma kernel's), float32
                against a float64 materialized twin at the same probes
                (NLML and 14 gradient entries), the NLML+gradient and
                predict times, the cross-term kernel, the tensor-core
                kernel (R = 256) and B6's mma kernel (R = 9, on signed
                inputs, a second launch bit for bit and its own limit) at
                N=50,000, D=12;
 12. kernels_chol -- the batched block Cholesky B2/B3 against its plain twin
                at every batch the main path gives it (C = 2, 4, 8, 16)
                and at 1, 32 and 64, float32 and float64; B4 (chol + inverse)
                likewise; NaN isolation of a non-SPD element in both; the
                blocked routines (left-looking, right-looking version 1
                and 2, recursive with B4 leaves) at (8|16, 1000, 1000) float32
                against a float64 factorization, launches counted; B2/B3's
                bad pivots inside, between and after its 16-column panels
                against the twin's first NaN column;
 13. hmc      -- the batched main path at bench.py's HMC stage (N=1000, D=2,
                RBF, noise 0.1, float32, stepsize 0.02, 10 leapfrog steps,
                40 samples) for 1, 2, 4, 8 and 16 chains: one warm
                sample(), then a timed one with the launch counters read
                around it (8 B2/B3 launches per evaluation for C >= 2, 0 at
                C = 1), samples/s and acceptance; the batched logp and
                gradient at the 16 chains' final states against the
                unbatched path and a float64 twin; one HMC_shortcut run;
 14. restarts -- optimize_restarts(parallel=True) with 16 restarts on the
                same model, against L-BFGS-B;
 15. chol_times -- B2/B3 and B4 at (C, 128, 128), C = 2, 4, 8, 16, float32
                and float64, by the profiler's device time and by CUDA
                events, each beside its plain twin, its bound and the
                library (batched torch.linalg.cholesky; for B4 with
                solve_triangular); the three blocked routines and the
                library at (C, 1000, 1000) float32, C = 2, 4, 8, 16: device
                time, wall time and B2/B4 launches per call;
 16. hmc_profile -- device time by kernel over one batched logp+gradient at
                8 chains;
 17. svgp     -- the SVGP flagship at bench.py:355-394's configuration,
                uncut (N=100,000, M=512, D=8, B=4096, RBF-ARD, noise 0.1,
                float32, fit(step_size=1e-2, natgrad_step_size=0.1)): B1
                against its twin and timed at (512, 512, 8) and (512, 4096,
                8); two fit(iters=100) with the counters read around the
                first (2 B1 launches a step); after them, on one fixed
                minibatch, the ELBO and each leaf's gradient, of the
                model's ELBO and of the natural-gradient step's objective,
                against a float64 twin, and the same with every matmul in
                TF32 and with Kmn in bfloat16, each of which must exceed
                a limit; fit(iters=500) timed three times (steps/s, ms a step); no more host syncs
                in fit(iters=10) than in fit(iters=5); whiten=True and
                use_natgrad=False, 20 steps each; predict on 2048 points;
                the collapsed-bound oracles in float64 against
                SparseGPRegression;
 18. svgp_profile -- device operations a step, the idle share and the top
                device operations over one fit(iters=20);
 19. sparse_gp -- BASELINE config 2: the SVGP phase's data at N=50,000,
                M=512, D=8, float32. B1 against its twin and timed at
                (50000, 512, 8) and (512, 2048, 8); one NLML+gradient of
                SparseGPRegression with VarDTC, FITC, DTC, PEP(0.5) and
                VarDTC_minibatch(2048), and of RBF + Linear + Bias under
                VarDTC, each with the counters read around it (2 B1
                launches; 26 for the minibatch bound), timed, profiled
                (device ms, device operations, idle share) and against a
                float64 twin; in float64, PEP(1) = FITC, minibatch = VarDTC
                (bound and woodbury vector), and a heteroscedastic
                likelihood at equal variances = the Gaussian;
 20. sparse_optimize -- optimize(max_iters=100) of VarDTC and FITC, each
                in float32 and in float64 from the same start: seconds,
                evaluations, ms and host syncs an evaluation, scipy's
                message, B1 launches, NLML at the start and the end (and
                float64's at both), predict at 2048 points before and
                after, posterior cached and building it;
 21. sparse_md -- SparseGPRegressionMD on the same rows over 4 outputs:
                one NLML+gradient as in sparse_gp, and in float64 its bound
                against the sum of the outputs' own VarDTC bounds;
 22. classification -- BASELINE config 3 at bench.py:656-752's shapes: the
                banana set (N=2048, D=2, float32, RBF), GPClassification
                (EP) and GPClassificationLaplace. B1 against its twin and
                timed at (2048, 2048, 2) and (512, 4096, 2); for each
                model one NLML+gradient with the counters read around it
                (1 B1 launch), timed, profiled, its host syncs, its sweeps
                or Newton steps and a float64 twin; ms a sweep or a Newton
                step by bench's two-length differencing; optimize(max_iters
                =20) from the default start (seconds, evaluations, NLML
                before and after in float32 and float64, held-out accuracy
                on a second draw, predict ms); mean |p_EP - p_Laplace|;
 23. epdtc    -- EPDTC at N=4096, M=512 (Z by a permutation, bench.py:
                757-762): one NLML+gradient as above (2 B1 launches), then
                SparseGPClassification on the same data and Z,
                fit(iters=100) with the counters read around it (2 B1
                launches a step), steps/s;
 24. coreg    -- BASELINE config 4's multi-output half at bench.py:645-654's
                shapes (4 outputs x 1000 points, D=1, float32): B1 against
                its twin and timed at (4000, 4000, 1), (1000, 4000, 1) and
                (1024, 1024, 1); GPCoregionalizedRegression (ICM(RBF(1)),
                rank 1) one NLML+gradient with the counters read around it
                (1 B1 launch), timed, profiled, its host syncs and a float64
                twin; optimize(max_iters=20) in float32 and float64 from one
                start (seconds, evaluations, NLML before and after, predict
                RMSE against sin(x + i) at 1000 new points of each output,
                predict ms); SparseGPCoregionalizedRegression (M=200, 2 B1
                launches) and GPOffsetRegression (outputs 0 and 1 as two
                clusters, 1 B1 launch) one NLML+gradient each; in float64,
                the sparse bound with Z = X below the exact one by no more
                than Kmm's jitter allows, and ICM with W = 0 as 4
                independent GPRegressions;
 25. multioutput -- MultioutputGP at bench.py:821-830's 512 f + 512 f'
                ([RBF(1), DiffKern(RBF, 0)], one base, Gaussian(1e-2)
                twice): one NLML+gradient as above (1 B1 launch, the f-f
                block), optimize(max_iters=20) in float32 and float64,
                predict RMSE of f and f' at 256 points, the derivative
                blocks in float64 against RBF's closed forms; then
                [Gaussian(0.1), Bernoulli()] under EP, one NLML+gradient (2
                B1 launches) with its sweeps;
 26. gplvm    -- BASELINE config 5's first half at bench.py:627-642's shape
                (Y = N(0,1)^{1000x3} N(0,1)^{3x12} + 0.1 eps, float32): B1
                against its twin and timed at (30, 30, 10), (1000, 1000,
                10), (30, 1000, 10), (64, 64, 2) and (64, 1000, 2);
                BayesianGPLVM(Y, 10, num_inducing=30), GPLVM, SparseGPLVM,
                MRD over columns 0-5 and 6-11, SSGPLVM and
                BayesianGPLVMMiniBatch with 10% of Y missing, one
                NLML+gradient each with the counters read around it (1 B1
                launch, Kmm; 2 for SparseGPLVM and MRD), timed, profiled
                and against a float64 twin (BayesianGPLVM's host syncs
                too); optimize(optimizer="adam", max_iters=200,
                step_size=5e-3) after one warm-up call, three times (steps/s
                best and median; 200 B1 launches); BayesianGPLVM at
                N=50,000, M=128: NLML+gradient ms and peak device memory
                against the 3.3 GB of a materialized psi2; in float64,
                S -> 0 against SparseGPRegression's VarDTC bound at X = the
                mean, SSGPLVM at gamma -> 1 against BayesianGPLVM, and the
                streamed psi2 against the summed psi2n;
 27. sparse_hmc -- the batched sparse bound: bench.py:847-853's HMC data as
                SparseGPRegression(num_inducing=64), HMC (stepsize 0.02,
                10 leapfrog steps, 40 samples) in float64 at 1, 2, 4, 8
                and 16 chains (samples x chains per second, acceptance
                above 0.5, 2 B1 launches a chain an evaluation) and in
                float32 at 16 (it accepts nothing at this Kmm, as the
                reference's float32 chains do); the batched logp and
                gradient against the unbatched path at the float32
                chains' final states (float64, and float32 against its
                unbatched path's own error) and at the float64 chains'
                (float64), with cond(Kmm) at each;
                optimize_restarts(parallel=True) with 16 restarts in
                float32 and in float64 (checked) beside L-BFGS-B.
 28. lvmogp   -- GPMultioutRegression at bench.py:832-839's shape (400 rows x
                8 outputs, Xr_dim=2, (Mc, Mr) = (32, 4), init="rand",
                float32): B1 against its twin and timed at the LVMOGP's
                shapes; one ELBO+gradient with the counters read around it
                (3 B1 launches: K(Zc), K(X, Zc), K(Zr)), timed, profiled,
                its host syncs and a float64 twin; optimize_auto(200)
                (seconds, evaluations, B1 launches, the bound before and
                after, predict RMSE against the noiseless targets);
                GPMultioutRegressionMD with 10% of the entries dropped and a
                noise per output, one ELBO+gradient as above; in float64,
                the missing-data bound with every entry observed against
                the full bound; the scale point 20,000 x 50 at (100, 10):
                ELBO+gradient ms;
 29. tp       -- TPRegression at bench.py:815-819's shape (N=2048, D=2,
                deg_free=4, the default RBF, no noise term): one
                NLML+gradient as above (1 B1 launch), predict ms, the
                jitter jitchol needed in float32 and float64 (recorded:
                the two factor differently jittered matrices), and RBF +
                White(0.01) float32 against float64 (held);
 30. optimizers -- adam, adagrad, rmsprop, adadelta, rprop and
                lbfgs_device for 100 iterations on bench.py's HMC data
                (N=1000, D=2, noise 0.1) in float32 and float64: seconds,
                evaluations, host syncs an iteration beside those of the
                objective alone, the end NLML and as float64 reads it; 16
                parallel restarts x 100 steps under each optax rule with
                the counters read around them (8 B2/B3 and 16 B1 launches
                an evaluation); lbfgs_device against lbfgsb on the N=8192
                dense slice, max_iters=30;
 31. gp_surface -- the N=8192 dense slice with normalizer=True and a Linear
                mean function: NLML+gradient against the plain model in
                turns, predictive_gradients at 2048 points,
                posterior_samples_f(size=10, full_cov=True) at 512,
                log_predictive_density at 2048; SVGP with a Linear mean
                function against the plain SVGP at bench.py's SVGP shape,
                fit(iters=200) steps/s in turns; infer_newX(variational=
                False) for 16 new rows on GPLVM at bench.py's N=1000,
                D=12, Q=10.
 32. state_space -- StateSpace at bench.py:764-777's Kalman stage, uncut
                (N=20,000 sorted U(0, 100) times, y = sin(x/3) + 0.2 eps,
                float32, the default Matern32(1), noise 0.1): one
                NLML+gradient of the sequential engine (timed with repeats
                at N=2,000 first) and of the chunked parallel one (best and
                median of 3), each with the counters read around it (no
                kernel of csrc/ on this path), profiled (device operations
                and ms, idle share; the sequential engine at N=2,000), its
                host syncs and a float64 twin; the speedup; parallel against
                sequential in float64; predict at 2048 new points (22,048
                merged steps) with the parallel engine; in float64 on 2048
                points each engine's NLML and the latent predict at 256
                against the dense GPRegression with Matern32; the
                square-root filter's stress case (N=20,000, Matern52(l=1e4,
                v=1e3) + Matern32, noise 1e-8: the plain filter's NLML in
                float64 and float32, the stable one's in float32, within 15%
                of float64); the C++ engine on the host in float64 against
                the sequential filter; two rows through the batched
                objective of the parallel StateSpace (N=2,000) and of
                TPRegression (N=2048) against unbatched evaluation.
 33. longtail -- bench.py:784-813's long-tail stage, uncut, float32 with a
                float64 twin: GPKroneckerGaussianRegression on the 32 x 24
                grid (2 B1 launches an NLML+gradient) and GPRegressionGrid
                on 16 x 12 x 10 (3), each with one NLML+gradient as above,
                best and median of 3, predict over a new grid, and in
                float64 the NLML, gradient and latent predict against the
                dense GPRegression on the product kernel (ROADMAP C(w));
                WarpedGP (TanhFunction(3)) and InputWarpedGP at N=1000,
                D=2 (1): one NLML+gradient, predict (the Gauss-Hermite mean,
                the median, predict_quantiles) at 1000 points, two batched
                rows against unbatched evaluation in float64;
                GPVariationalGaussianApproximation on the banana set
                (N=2048, Bernoulli; 1): one ELBO+gradient, optimize(
                max_iters=50) in float64 (the objective must fall;
                held-out accuracy recorded); each long-tail kernel in a
                GPRegression at N=1000: one NLML+gradient against float64
                (4 B1 launches for Symmetric, SplitKern and DEtime over an
                RBF, 1 for GridRBF).
 34. lfm_symbolic -- the latent-force models and the symbolic kernel and
                likelihood at shapes chosen here (bench.py has none): T
                times an output on linspace(0.1, 10), R forces
                sin((q+1) t/2 + phi_q), two of them driving each output;
                GPRegression over EQ_ODE2 at 4 outputs x 250 times, rank 2,
                float64: one NLML+gradient (best and median of 3, device
                operations and ms, idle share, host syncs, index-column
                reads, peak device memory), predict at 4 x 100 new times,
                Kdiag_per_force against diag(K), K + noise I positive
                definite, the card against the port's CPU evaluation on a
                4 x 50 subset, the float32 / complex64 reading (recorded);
                SparseGPRegression over EQ_ODE1 at 20 x 100, rank 3, M=60:
                one NLML+gradient, optimize(max_iters=20) (the bound must
                rise); IBPLFM at 20 x 100, R=5, M=50: one NLML+gradient,
                two batched rows against unbatched evaluation, optimize(
                max_iters=100) with its gates; ODE_UY, ODE_UYC and ODE_t
                over 500 U/Y pairs and ODE_st on a 25 x 20 (t, x) grid: one
                float32 NLML+gradient against float64 each, and ODE_UY at
                T = 1000 in float64 against central differences (ROADMAP
                C(ab)); the symbolic kernel at bench.py:847-853's HMC data
                against RBF(2) (and with sqrt(2) log(2) constants), and the
                symbolic Student-t (nu = 4) under Laplace against
                StudentT(deg_free=4) in float64, float32 against float64,
                optimize(max_iters=20) (1 B1 launch an NLML+gradient).
 35. surface  -- the host-side surface on the card: every function of
                gpy_tpu_torch.examples at its own defaults with
                optimize=True, in the package's default dtype (float64),
                the cuts of EXAMPLE_CUTS and EXAMPLE_MAX_ITERS listed in
                the record, plus
                large_scale_iterative_regression(fused=True): seconds,
                the objective at the end and the B1, B5 and B6 launches
                of each (B5 and B6 > 0 on the two fused examples); B1
                against its twin at every (N, M, D, dtype) the examples
                launched it with, B5 and B6 at matrix_free_exact_gp's
                N=3000, D=2, R=9; save_model and gpy_tpu_torch.load of the
                dense slice (float32), big_data_svgp's fitted SVGP
                (N=200,000), a float64 EP classifier on the banana set
                (N=2048, converged sites), bench's MultioutputGP with a
                shared kernel (float32), tied_lengthscales' model and a
                GPRegression over a symbolic kernel: seconds to save and
                load, file MB, NLML, gradient and predict at 2048 points
                bit-equal after the load, no EP sweep after the load, and
                a load on the CPU against the card (the dense slice
                without its gradient); plot_fit and
                plot_density of a float32 GPRegression at N=2048
                (resolution 200) and plot_latent and plot_magnification
                of config 5's BayesianGPLVM (N=1000, Q=10, M=30) through
                the recording backend, ms each and every array against
                the float64 CPU model; profiling.trace around five
                NLML+gradients of the dense slice (the Chrome trace must
                name B1's kernel), StepTimer's median against the step's
                CUDA-event time, and profile_objective's summary.
 36. parallel -- sharding (gpy_tpu_torch.parallel). (a) On a 1-rank NCCL
                make_mesh() over cuda:0, float32: sharded_svgp_train_step at
                the svgp phase's shape (N=100,000, M=512, D=8, batches of
                B=4096 rows), plain and whitened, 20 steps against the
                serial Adam step from the same raw start;
                sharded_iterative_nlml_grad(fused=True) at the iterative
                phase's N=50,000 against the fused model at the same
                probes; sharded_vardtc_elbo_and_grad at N=50,000, M=512
                against the serial bound's float64 twin; HMC.sample(mesh=)
                with 16 chains and optimize_restarts(parallel=True, mesh=)
                with 16 restarts at the hmc phase's data against the
                unsharded calls. Each: ms a step or evaluation beside the
                serial path's, the collectives and their bytes, B1, B5 and
                B2/B3 launches read around it, NCCL's kernels and device ms
                from the profiler. B5 at the slabs (N/k, N), k = 1 and 4,
                against its twin. (b) 4 spawned gloo ranks sharing cuda:0,
                float64, at tests/test_torch_parallel.py's shapes x 8: every
                sharded program on the 1-D and the 2 x 2 mesh against the
                serial path on the card (rel 1e-10), every rank's exit code
                checked.
Then the {"kernels": [...]} line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero without the last line; so does a run without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores, and float64 on them (DMMA, the card's fastest float64 rate;
# 34 TF/s outside them)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# dense TF32 on the tensor cores (the same data sheet)
PEAK_TF32_TC = 495e12

SLICE_N, SLICE_D, N_PRED = 8192, 8, 2048

# bench.py:456-485: the iterative exact GP at N=50k (CG + SLQ)
ITER_N, ITER_D, ITER_PRED = 50_000, 4, 256
ITER_OPTS = {"max_cg": 48, "n_probes": 8, "block": 2048}
FAMILIES = {"RBF": 0, "Matern32": 1, "Matern52": 2, "Exponential": 3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0 and r.stdout.strip(), f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def host_record() -> dict:
    """The host the card is driven from: its CPU model (lscpu, else
    /proc/cpuinfo) and clock (/proc/cpuinfo) and its dispatch floor, as
    bench.py's measure_dispatch_floor records it (bench.py:131): the
    microseconds to enqueue one tiny operation, over 2000 of them, and the
    best of 20 launches each read back. Host-bound paths vary with these."""
    import platform

    import torch

    model, mhz = None, []
    try:
        r = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30)
        for line in r.stdout.splitlines():
            key, _, val = line.partition(":")
            if key.strip() == "Model name":
                model = val.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key.strip() == "model name" and model is None:
                    model = val.strip()
                elif key.strip() == "cpu MHz":
                    mhz.append(float(val))
    except OSError:
        pass
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    enqueue_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(20):
        t0 = time.perf_counter()
        x.add_(1.0)
        x.item()
        best = min(best, time.perf_counter() - t0)
    return {"cpu": model, "machine": platform.machine(),
            "cpu_mhz_mean": sum(mhz) / len(mhz) if mhz else None,
            "cpu_count": os.cpu_count(), "enqueue_us_per_op": enqueue_us,
            "launch_and_read_us": best * 1e6}


def build_kernels(_build) -> dict:
    """Compile every CUDA source at once, one nvcc each."""
    names = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        futures = {n: ex.submit(_build.build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}


def cuda_ms(fn, reps=20, warmup=3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(kernel_fn, library_fn=None, reps=50, warmup=3, kernel="block_chol_kernel<",
              per_call=1):
    """Device time per call from torch.profiler, for a function that launches
    `per_call` kernels whose name contains `kernel` (B2's by default), and
    optionally a library call: `reps` calls of each in turn, each kernel's
    self time summed and divided by the calls recorded, the launches of
    `kernel` the profiler recorded over `per_call`. At tens of microseconds a
    call, `cuda_ms` can read the host's enqueue time of the Python wrapper
    instead of the kernel; this clock cannot. Counting the recorded
    launches, not reps, keeps it right when the profiler drops device
    events: on an H100, late in a long process, sessions lost their first
    launches. Where a call launches more than one kernel a lost call is not
    lost evenly, so a session that lost more than one call's launches of
    `kernel` is run again, up to five in all, and the fullest is taken.
    Returns (ms of `kernel`, ms of every other kernel, other kernels per
    call, calls recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        kernel_fn()
        if library_fn is not None:
            library_fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                kernel_fn()
                if library_fn is not None:
                    library_fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in rows if kernel in e.key]
        if len(ours) == 1 and (best is None or ours[0].count > best[1][0].count):
            best = (rows, ours)
        if len(ours) == 1 and ours[0].count >= (reps - 1) * per_call:
            break
    if best is None or 5 * best[1][0].count < reps * per_call:
        raise RuntimeError(f"chip_smoke check failed: torch.profiler recorded fewer than "
                           f"{reps * per_call // 5} of {reps * per_call} {kernel} launches "
                           f"in five sessions")
    rows, ours = best
    n = ours[0].count / per_call
    others = [e for e in rows if e is not ours[0]]
    return (ours[0].self_device_time_total / n / 1e3,
            sum(e.self_device_time_total for e in others) / n / 1e3,
            sum(e.count for e in others) / n, n)


def host_ms(fn, reps=5, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def rbf_gram_bound(N, M, D, dtype_name):
    """Least time for the Gram on the card: each input read once and K written
    once over the memory rate, or ~3D+3 operations per entry (D subtractions,
    D fused multiply-adds, scale, exp, multiply) over the peak rate."""
    isz = 4 if dtype_name == "float32" else 8
    t_bytes = isz * (N * D + M * D + 1 + N * M) / PEAK_BYTES_S
    t_ops = N * M * (3 * D + 3) / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rbf_inputs(N, M, D, dtype, seed):
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    X = torch.tensor(g.random((N, D)) * 4.0, dtype=dtype, device="cuda")
    X2 = X if N == M else torch.tensor(g.random((M, D)) * 4.0, dtype=dtype, device="cuda")
    # lengthscales ~ sqrt(D) keep r2 of order 1..10, so K spans (0, v]
    ls = torch.tensor(math.sqrt(D) * (0.7 + 0.6 * g.random(D)), dtype=dtype, device="cuda")
    v = torch.tensor(1.7, dtype=dtype, device="cuda")
    # a positive cotangent: the v and lengthscale gradients are then sums of
    # same-signed terms, so their float32 rounding is not amplified by
    # cancellation (a random-sign cotangent makes it ~1e-4 at 1024^2 terms)
    G = torch.tensor(0.5 + g.random((N, M)), dtype=dtype, device="cuda")
    return X, X2, ls, v, G


def check_rbf_gram(rg, N, M, D, dtype):
    """The CUDA kernel against rbf_gram_plain on the same inputs."""
    import torch

    name = str(dtype).replace("torch.", "")
    X, X2, ls, v, G = rbf_inputs(N, M, D, dtype, seed=N + M + D)
    square = X2 is X
    Xs = X / ls
    X2s = Xs if square else X2 / ls
    K = rg.rbf_gram_cuda(Xs, X2s, v)
    Kp = rg.rbf_gram_plain(Xs, X2s, v)
    torch.cuda.synchronize()
    err = float((K - Kp).abs().max())
    tol_fwd = (1e-5 if dtype == torch.float32 else 1e-12) * float(v)
    check(torch.isfinite(K).all(), f"rbf_gram {N}x{M}x{D} {name}: non-finite output")
    check(err <= tol_fwd, f"rbf_gram {N}x{M}x{D} {name}: forward max err {err} > {tol_fwd}")
    if square:
        check(torch.equal(torch.diagonal(K), v.expand(N)),
              f"rbf_gram {N}x{M}x{D} {name}: square diagonal is not exactly v")

    def grads(use_kernel):
        leaves = [t.detach().clone().requires_grad_(True) for t in (X, X2, ls, v)]
        x, x2, l, vv = leaves
        if use_kernel:
            Kg = rg.rbf_gram(x, None if square else x2, vv, l)
        else:
            xs = x / l
            Kg = rg.rbf_gram_plain(xs, xs if square else x2 / l, vv)
        wrt = [x, l, vv] if square else [x, x2, l, vv]
        return torch.autograd.grad(torch.sum(G * Kg), wrt)

    labels = ["dX", "dls", "dv"] if square else ["dX", "dX2", "dls", "dv"]
    tol_bwd = 1e-4 if dtype == torch.float32 else 1e-10
    bwd = {}
    for lab, a, b in zip(labels, grads(True), grads(False)):
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        bwd[lab] = rel
        check(math.isfinite(rel) and rel <= tol_bwd,
              f"rbf_gram {N}x{M}x{D} {name}: backward {lab} rel err {rel} > {tol_bwd}")
    return {"N": N, "M": M, "D": D, "dtype": name, "max_abs_err": err, "tol": tol_fwd,
            "bwd_rel_err": bwd, "bwd_tol": tol_bwd, "exact_diag": square}


def slice_data(seed=0):
    """bench.py:415-419: X ~ U[0,4)^8, Y = sin(X[:, :1]) + 0.1 eps, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.random((SLICE_N, SLICE_D)).astype(np.float32) * 4.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((SLICE_N, 1))).astype(np.float32)
    Xs = rng.random((N_PRED, SLICE_D)).astype(np.float32) * 4.0
    return X, Y, Xs


def build_model(X, Y, dtype):
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPRegression

    return GPRegression(X, Y, RBF(SLICE_D, ARD=True, device="cuda", dtype=dtype),
                        noise_var=0.1, device="cuda", dtype=dtype)


def run_slice(rg):
    """The main path, driven once through the user's entry points."""
    import numpy as np
    import torch

    X, Y, Xs = slice_data()
    m = build_model(X, Y, torch.float32)
    counts = []
    rg.launches = 0
    t0 = time.perf_counter()
    ll0 = m.log_likelihood().item()
    counts.append(rg.launches)
    x0 = m.optimizer_array
    f0, g0 = m._objective_and_grad(x0)
    counts.append(rg.launches)
    res = m.optimize(max_iters=5)
    counts.append(rg.launches)
    mu, var = m.predict(Xs)
    counts.append(rg.launches)
    q_lo, q_hi = m.predict_quantiles(Xs)
    counts.append(rg.launches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rg.launches

    steps = ["log_likelihood", "objective_and_grad", "optimize", "predict", "predict_quantiles"]
    for i, step in enumerate(steps):
        check(counts[i] > (counts[i - 1] if i else 0), f"slice: {step} launched no rbf_gram kernel")
    check(math.isfinite(ll0) and math.isfinite(f0) and np.isfinite(g0).all(), "slice: non-finite NLML or gradient")
    check(res.f_opt < f0, f"slice: optimize did not lower the NLML ({f0} -> {res.f_opt})")
    for name, a in (("mean", mu), ("variance", var), ("q2.5", q_lo), ("q97.5", q_hi)):
        check(a.shape == (N_PRED, 1) and np.isfinite(a).all(), f"slice: predicted {name} is not finite (N*, 1)")
    check((var > 0).all() and (q_lo < mu).all() and (mu < q_hi).all(), "slice: predictive intervals out of order")
    truth = np.sin(Xs[:, :1])
    rmse = float(np.sqrt(np.mean((mu - truth) ** 2)))
    check(rmse < float(np.std(truth)), f"slice: predictive RMSE {rmse} is no better than the mean")

    # float64 twin at the same initial parameters: the float32 run's reference
    m64 = build_model(X, Y, torch.float64)
    f64, g64 = m64._objective_and_grad(x0)
    nlml_rel = abs(f0 - f64) / abs(f64)
    grad_rel = float(np.max(np.abs(g0 - g64)) / np.max(np.abs(g64)))
    # ~10x and ~20x the readings on an H100 (NLML 3.5e-6, gradient 4.5e-6),
    # so a TF32 product slipping onto the path (~1e-3) fails here
    check(nlml_rel <= 5e-5, f"slice: float32 NLML {f0} vs float64 {f64}: rel {nlml_rel} > 5e-5")
    check(grad_rel <= 1e-4, f"slice: float32 gradient vs float64: rel {grad_rel} > 1e-4")
    del m64
    return m, Xs, {
        "phase": "slice", "N": SLICE_N, "D": SLICE_D, "dtype": "float32", "launches": launches,
        "launches_after_each_step": dict(zip(steps, counts)), "nlml0": f0, "nlml_after_5": res.f_opt,
        "optimizer_status": res.status, "n_pred": N_PRED, "pred_rmse_vs_sin": rmse,
        "nlml_f64": f64, "nlml_rel_f32_vs_f64": nlml_rel, "grad_rel_f32_vs_f64": grad_rel,
        "seconds": wall,
    }


def time_rbf_gram(rg, N, M, D):
    """B1 at (N, M, D) float32: CUDA-event time (`ms`) and the profiler's
    device time a launch (`device_ms`; at ~10 us the event clock reads the
    wrapper's enqueue), beside the plain twin and the bound."""
    import torch

    X, X2, ls, v, _ = rbf_inputs(N, M, D, torch.float32, seed=7)
    Xs = (X / ls).contiguous()
    X2s = Xs if X2 is X else (X2 / ls).contiguous()
    ms = cuda_ms(lambda: rg.rbf_gram_cuda(Xs, X2s, v))
    dev_ms = device_ms(lambda: rg.rbf_gram_cuda(Xs, X2s, v), kernel="rbf_gram_kernel")[0]
    plain_ms = cuda_ms(lambda: rg.rbf_gram_plain(Xs, X2s, v))
    err = float((rg.rbf_gram_cuda(Xs, X2s, v) - rg.rbf_gram_plain(Xs, X2s, v)).abs().max())
    bound_ms, bound_by = rbf_gram_bound(N, M, D, "float32")
    return {"N": N, "M": M, "D": D, "dtype": "float32", "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, "library_ms": None}


def profile_objective(m, x, what=f"one objective_and_grad, N={SLICE_N} float32"):
    """Device time by kernel over one objective+gradient evaluation, from
    torch.profiler; the idle share is 1 - device time / host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    m._objective_and_grad(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m._objective_and_grad(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(r[0] for r in rows)
    return {"phase": "profile", "what": what,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms, "device_ops": sum(r[2] for r in rows),
            "top": [{"kernel": k[:90], "device_ms": ms, "count": c} for ms, k, c in rows[:12]]}


# --- the fused Gram-matvec (B5) and its gradient moments (B6) ---------------

# the kernel against its plain twin, both float32 on the card, max error
# relative to max|ref|; every accum mode runs the same contraction (FFMA at
# R <= 16, 3xTF32 with per-tile promotion above). ~10x the readings on an
# H100 (forward 2.6e-6, gradient moments 1.7e-7)
FUSED_FWD_TOL = 3e-5
FUSED_BWD_TOL = 2e-6
# the same at the main path's N=50,000, D=4: B5 by R against the float32
# plain twin, B6 against the float64 plain twin. ~10x the readings on an
# H100 (B5 2.6e-6 at R=9, 1.45e-5 at R=256 (the FFMA wide kernel), 3.2e-6 at
# R=1; B6 8.7e-8); R=16 takes R=9's limit. R=17, 64 and 1024 run the
# tensor-core kernel: 3.1e-6, 2.8e-6 and 2.6e-6 (2.9e-6 at R=256)
FUSED_FWD_TOL_50K = {9: 3e-5, 256: 1.5e-4, 1: 3e-5, 16: 3e-5, 17: 3e-5, 64: 3e-5, 1024: 3e-5}
FUSED_BWD_TOL_50K = 1e-6
# B6's mma kernel (D > 8 or R > 16) at N=50,000 on signed G and V against
# the float64 plain twin, by (D, R), relative to max|ref|: ~10x the
# readings on an H100 (1.24e-7 at D=12, R=9 and 2.85e-7 at D=4, R=17; the
# chunk kernel it replaced read 6.0e-8 and 1.33e-7)
MOMENTS_MMA_TOL_50K = {(12, 9): 1.2e-6, (4, 17): 3e-6}


def fused_inputs(N, M, D, R, seed, positive=False):
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    dev = "cuda"
    X = torch.tensor(g.random((N, D)) * 4.0, dtype=torch.float32, device=dev)
    X2 = None if M is None else torch.tensor(g.random((M, D)) * 4.0, dtype=torch.float32,
                                             device=dev)
    rows = N if M is None else M
    shape = (rows,) if R is None else (rows, R)
    V = g.random(shape) + 0.5 if positive else g.standard_normal(shape)
    V = torch.tensor(V, dtype=torch.float32, device=dev)
    ls = torch.tensor(math.sqrt(D) * (0.7 + 0.6 * g.random(D)), dtype=torch.float32, device=dev)
    v = torch.tensor(1.3, dtype=torch.float32, device=dev)
    return X, X2, V, ls, v


def check_fused_matvec(fm, family, accum, shape):
    """B5 through the public wrapper against stationary_gram_matvec_plain."""
    import torch

    label, N, M, D, R = shape
    X, X2, V, ls, v = fused_inputs(N, M, D, R, seed=N + D + (R or 1) + 7 * family)
    out = fm.stationary_gram_matvec_fused(X, V, v, ls, family=family, X2=X2, accum=accum)
    Xs = X / ls
    X2s = Xs if X2 is None else X2 / ls
    V2 = V if V.ndim == 2 else V[:, None]
    ref = fm.stationary_gram_matvec_plain(Xs, X2s, V2, v.reshape(1), family)
    ref = ref if V.ndim == 2 else ref[:, 0]
    torch.cuda.synchronize()
    check(out.shape == ref.shape and torch.isfinite(out).all(),
          f"gram_matvec_fused {label} family {family}: bad shape or non-finite output")
    rel = float((out - ref).abs().max() / ref.abs().max())
    check(rel <= FUSED_FWD_TOL, f"gram_matvec_fused {label} family {family} {accum}: "
                                f"rel err {rel} > {FUSED_FWD_TOL}")
    return rel, float((out - ref).abs().max())


def check_fused_moments(fm, family, D, N=4096, R=9):
    """B6, through the autograd Function of the fused matvec, against
    autograd of the plain twin: dvariance, dlengthscale (ARD), dnoise.
    Positive V and cotangent keep the sums free of cancellation, so the
    comparison measures the kernel and not float32 cancellation."""
    import torch

    shift = D + family + 32 * (R % 9) + (4096 - N)  # N=4096, R=9: the original seeds
    X, _, V, ls, v = fused_inputs(N, None, D, R, seed=100 + shift, positive=True)
    _, _, G, _, _ = fused_inputs(N, None, D, R, seed=200 + shift, positive=True)
    noise = torch.full((N,), 0.1, dtype=torch.float32, device="cuda")

    def grads(use_kernel):
        vv, ll, nn = (t.detach().clone().requires_grad_(True) for t in (v, ls, noise))
        if use_kernel:
            y = fm.stationary_gram_matvec_fused_diff(X, V, vv, ll, nn, family, "exact")
        else:
            Xs = X / ll
            y = fm.stationary_gram_matvec_plain(Xs, Xs, V, vv, family) + nn[:, None] * V
        return torch.autograd.grad(torch.sum(G * y), [vv, ll, nn])

    before = fm.moments_launches
    got = grads(True)
    check(fm.moments_launches == before + 1, "gram_moments: not one launch per backward")
    rels = {}
    for lab, a, b in zip(("dvariance", "dlengthscale", "dnoise"), got, grads(False)):
        rel = float((a - b).abs().max() / b.abs().max())
        rels[lab] = rel
        check(math.isfinite(rel) and rel <= FUSED_BWD_TOL,
              f"gram_moments family {family} N={N} D={D} R={R}: {lab} rel err {rel} "
              f"> {FUSED_BWD_TOL}")
    return rels


def check_fused_unaligned(fm):
    """B5 and B6 on X2s and V whose data are not 16-byte aligned (row-offset
    views at 12 and 36 bytes): the wrappers copy them before the kernels'
    16-byte copies read them. B6 (X2s as its X) is held to the float64
    twin."""
    import numpy as np
    import torch

    g = np.random.default_rng(77)
    N, D, R = 2049, 3, 9
    Xb = torch.tensor(g.random((N + 1, D)) * 2.0, dtype=torch.float32, device="cuda")
    Vb = torch.tensor(g.standard_normal((N + 1, R)), dtype=torch.float32, device="cuda")
    Xs, X2s, V = Xb[:-1], Xb[1:], Vb[1:]
    v = torch.full((1,), 1.3, dtype=torch.float32, device="cuda")
    check(X2s.data_ptr() % 16 != 0 and V.data_ptr() % 16 != 0, "unaligned: the views are aligned")
    out = fm.stationary_gram_matvec_cuda(Xs, X2s, V, v, 0)
    ref = fm.stationary_gram_matvec_plain(Xs, X2s, V, v, 0)
    rel = float((out - ref).abs().max() / ref.abs().max())
    check(rel <= FUSED_FWD_TOL, f"gram_matvec_fused unaligned views: rel err {rel}")
    G = Vb[:-1]
    mom = fm.gram_moments_cuda(X2s, G, V, v, 0)
    ref = fm.gram_moments_plain(X2s.double(), G.double(), V.double(), v.double(), 0)
    mrel = float((mom - ref).abs().max() / ref.abs().max())
    check(mrel <= FUSED_BWD_TOL, f"gram_moments unaligned views: rel err {mrel}")
    # the cross-term kernel (D = 12, R = 9): rows, columns and V all views
    # at 52-, 4- and 4-byte offsets into flat buffers, Xs's row i X2s's row
    # i + 1 (diag_offset 1)
    Xb = torch.tensor(g.random(N * 12 + 13) - 0.5, dtype=torch.float32, device="cuda")
    Vb = torch.tensor(g.standard_normal(N * R + 1), dtype=torch.float32, device="cuda")
    Xs, X2s = Xb[13:].reshape(N, 12), Xb[1:1 + N * 12].reshape(N, 12)
    V = Vb[1:].reshape(N, R)
    check(Xs.data_ptr() % 16 != 0 and X2s.data_ptr() % 16 != 0 and V.data_ptr() % 16 != 0,
          "unaligned: the D=12 views are aligned")
    out = fm.stationary_gram_matvec_cuda(Xs, X2s, V, v, 0, diag_offset=1)
    ref = fm.stationary_gram_matvec_plain(Xs, X2s, V, v, 0, diag_offset=1)
    crel = float((out - ref).abs().max() / ref.abs().max())
    check(crel <= FUSED_FWD_TOL, f"gram_matvec_fused cross kernel unaligned views: rel err {crel}")
    return {"gram_matvec_fused": rel, "gram_moments": mrel, "gram_matvec_fused_d12": crel}


# the wide kernel's edges (R > 16, the tensor cores): R = 17 (4-byte copies
# of V, most of a 128-column chunk zero), 64, ragged rows, columns and R one
# past two 128-column chunks, D > 8 at a wide R
WIDE_SHAPES = [("wide_r17", 2048, None, 4, 17), ("wide_r64", 2048, None, 4, 64),
               ("wide_r257_rect", 2047, 3001, 4, 257), ("wide_r2048_d12", 2047, 3001, 12, 2048)]


def check_wide_repeat(fm):
    """A second launch of the wide kernel at (4096, 4, 256) equals the
    first bit for bit (each output entry is written once, no atomics)."""
    import torch

    X, _, V, ls, v = fused_inputs(4096, None, 4, 256, seed=41)
    Xs = (X / ls).contiguous()
    a = fm.stationary_gram_matvec_cuda(Xs, Xs, V, v.reshape(1), 0)
    b = fm.stationary_gram_matvec_cuda(Xs, Xs, V, v.reshape(1), 0)
    check(bool(torch.equal(a, b)), "gram_matvec_fused wide: two launches on the same inputs differ")
    return True


# the cross-term kernel's shapes (8 < D <= 64, R <= 16): D past one and
# several 8-dimension steps (9, 12, 20, 33) by its R chunks 1, 9 and 16,
# square (N = 2049: a ragged last block and tile) and rectangular, ragged
# both ways; D = 72 at R = 9 goes past the kernel's cap to the tensor-core one
CROSS_SHAPES = [(f"cross_d{D}_r{R}_{kind}", N, M, D, R) for D in (9, 12, 20, 33)
                for R in (1, 9, 16) for kind, N, M in (("square", 2049, None),
                                                      ("rect", 2047, 3001))] + [
    ("past_cross_d72_r9", 2047, 3001, 72, 9)]
CROSS_B5_INSTANCE = "gram_matvec_cross_kernelILi0ELi9ELi2EE"
CROSS_B5_KERNEL = "gram_matvec_cross_kernel<"
# the sharded slab's rows at D = 12: N over PAR_SLABS ranks, the first rows
# at 0, 2000, 4000, 6000 (not block-aligned)
CROSS_SLAB_N, PAR_SLABS = 8000, 4


def check_cross(fm):
    """The cross-term kernel beyond its twin: a second launch bit for bit;
    K_ii exactly v (V = columns o .. o + 15 of the identity gives out[o + c,
    c] = K_(o+c)(o+c), for every family at D = 12, R = 16); the sharded
    slab (parallel/iterative.py's _slab, diag_offset = its first row) equal
    to the square product's rows bit for bit, and without the offset the
    difference it would make."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.parallel.iterative import _slab

    X, _, V, ls, v = fused_inputs(4096, None, 12, 9, seed=43)
    a = fm.stationary_gram_matvec_fused(X, V, v, ls)
    b = fm.stationary_gram_matvec_fused(X, V, v, ls)
    check(bool(torch.equal(a, b)), "gram_matvec_fused cross kernel: two launches differ")
    diag = {}
    N = 3001
    for fname, fam in FAMILIES.items():
        X, _, _, ls, v = fused_inputs(N, None, 12, 16, seed=44 + fam)
        for o in (0, 1000, N - 16):
            E = torch.zeros((N, 16), dtype=torch.float32, device="cuda")
            E[o + torch.arange(16), torch.arange(16)] = 1.0
            out = fm.stationary_gram_matvec_fused(X, E, v, ls, family=fam)
            kii = out[o + torch.arange(16, device="cuda"), torch.arange(16, device="cuda")]
            check(bool((kii == v).all()),
                  f"gram_matvec_fused cross kernel {fname}: K_ii at rows {o}.. is not v: "
                  f"{(kii - v).abs().max().item()}")
        diag[fname] = True
    g = np.random.default_rng(45)
    Xn = torch.tensor(g.random((CROSS_SLAB_N, 12)) * 10.0, dtype=torch.float32, device="cuda")
    Vn = torch.tensor(g.standard_normal((CROSS_SLAB_N, 9)), dtype=torch.float32, device="cuda")
    kern = RBF(12, ARD=True, lengthscale=3.0, device="cuda", dtype=torch.float32)
    full = fm.kern_gram_matvec_fused(kern, Xn, Vn)
    step = CROSS_SLAB_N // PAR_SLABS
    slabs, off = [], []
    for i0 in range(0, CROSS_SLAB_N, step):
        sl = _slab(kern, Xn, Vn, i0, i0 + step, 2048, True, "f32x3")
        slabs.append(bool(torch.equal(sl, full[i0:i0 + step])))
        bare = fm.kern_gram_matvec_fused(kern, Xn[i0:i0 + step], Vn, X2=Xn)
        off.append(float((bare - full[i0:i0 + step]).abs().max() / full.abs().max()))
    check(all(slabs), f"gram_matvec_fused cross kernel: sharded slabs differ from the square "
                      f"product's rows: {slabs}")
    return {"repeats_bit_for_bit": True, "k_ii_exactly_v": diag,
            "slab_rows_bit_equal": slabs, "slab_first_rows": list(range(0, CROSS_SLAB_N, step)),
            "slab_without_diag_offset_rel_diff": off}


# B6's shapes (N, D, R): the register-tile kernel at D = 1, 4, 8 (DMAX 4
# and 8) by its R chunks 1, 9, 16, and ragged N; the mma kernel at D = 12
# (DMAX 12), at R > 16 (DMAX 4 and 12, R = 64 its widest launch), in two
# passes (D = 20, 33, 72; 127 at R = 1, the widest D), ragged N, and DMAX 8
# at R = 72, two launches summed into the same rows
MOMENT_SHAPES = [(4096, D, R) for D in (1, 4, 8, 12) for R in (1, 9, 16)] + [
    (2047, 4, 9), (2047, 8, 16),
    (4096, 4, 17), (4096, 12, 64), (4096, 20, 9), (4096, 33, 16), (4096, 72, 9),
    (4096, 127, 1), (2047, 12, 9), (2047, 4, 17), (2047, 8, 72)]


def run_fused_checks(fm):
    shapes = [("square", 4096, None, 4, 9), ("ragged_vector", 3001, None, 4, None),
              ("narrow_r4", 2048, None, 4, 4), ("r_chunks", 2048, None, 4, 130),
              ("wide_d12", 2048, None, 12, 9), ("rectangular", 2048, 3000, 4, 9),
              # the register-tile kernel's edges: D=1 with a ragged last
              # tile, DMAX=8 at the widest R, ragged rows, columns and R
              ("d1", 2049, None, 1, 9), ("d8_r16", 2048, None, 8, 16),
              ("ragged_rect", 2047, 3001, 4, 9)] + WIDE_SHAPES + CROSS_SHAPES
    fwd, worst, cross_worst = [], 0.0, 0.0
    for fname, fam in FAMILIES.items():
        for accum in ("exact", "f32x3", "fast"):
            for shape in shapes:
                rel, err = check_fused_matvec(fm, fam, accum, shape)
                worst = max(worst, err)
                if shape in CROSS_SHAPES[:-1] or shape[0] == "wide_d12":
                    cross_worst = max(cross_worst, err)
                fwd.append({"family": fname, "accum": accum, "shape": shape[0], "rel_err": rel})
    bwd = [{"family": fname, "N": N, "D": D, "R": R,
            "rel_err": check_fused_moments(fm, fam, D, N=N, R=R)}
           for fname, fam in FAMILIES.items() for N, D, R in MOMENT_SHAPES]
    return {"phase": "kernels_fused", "gram_matvec_fused": fwd, "fwd_tol": FUSED_FWD_TOL,
            "wide_repeats_bit_for_bit": check_wide_repeat(fm), "cross": check_cross(fm),
            "unaligned_views_rel_err": check_fused_unaligned(fm),
            "gram_moments": bwd, "bwd_tol": FUSED_BWD_TOL,
            "max_fwd_rel_err": max(r["rel_err"] for r in fwd), "cross_max_abs_err": cross_worst,
            "max_bwd_rel_err": max(max(r["rel_err"].values()) for r in bwd)}, worst


# --- the iterative exact-GP slice at N=50k ----------------------------------

# the float32 fused model against the float64 materialized model at the same
# probes (relative; the gradient max-abs relative): ~10x the readings on an
# H100 (NLML 2.1e-5, gradient 1.5e-3). 48 CG steps do not converge here, so
# float32 rounding moves the Krylov trajectory
ITER_NLML_TOL = 2e-4
ITER_GRAD_TOL = 2e-2
# the float64 estimate against the exact NLML (float64 Cholesky) at the start
ITER_SLQ_TOL = 0.1
# the fused float32 model's predictive (latent) variance at the 256 points,
# at the start parameters, against the same posterior's CG solved through
# the float64 plain twin: max error relative to max|var|, ~10x the reading
# on an H100 (2.2e-3; B5's wide kernel, R = 256, in all 48 products; 48 CG
# steps are not converged here, so float32 rounding moves the solve)
ITER_PRED_VAR_TOL = 2e-2


def iterative_data(seed=0):
    """bench.py:463-467: X ~ U[0,10)^4, Y = sin(x_1) + 0.1 eps, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.random((ITER_N, ITER_D)).astype(np.float32) * 10.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((ITER_N, 1))).astype(np.float32)
    Xs = rng.random((ITER_PRED, ITER_D)).astype(np.float32) * 10.0
    return X, Y, Xs


def iterative_model(X, Y, dtype, fused):
    """bench.py's two N=50k models: the default (materialize="auto") and
    fused=True, materialize=False; RBF (not ARD), noise 0.1."""
    from gpy_tpu_torch.inference import IterativeGaussianInference
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPRegression

    opts = dict(ITER_OPTS, materialize=False, fused=True) if fused else dict(ITER_OPTS)
    return GPRegression(X, Y, RBF(ITER_D, device="cuda", dtype=dtype), noise_var=0.1,
                        inference_method=IterativeGaussianInference(**opts), device="cuda",
                        dtype=dtype)


def counters():
    """Every kernel's launch count (each wrapper adds one where it launches)."""
    from gpy_tpu_torch.ops import block_chol as bc
    from gpy_tpu_torch.ops import gram_matvec_fused as fm
    from gpy_tpu_torch.ops import rbf_gram as rg

    return {"rbf_gram": rg.launches, "gram_matvec_fused": fm.matvec_launches,
            "gram_moments": fm.moments_launches, "block_chol": bc.launches,
            "block_chol_inv": bc.inv_launches}


def reset_counters():
    from gpy_tpu_torch.ops import block_chol as bc
    from gpy_tpu_torch.ops import gram_matvec_fused as fm
    from gpy_tpu_torch.ops import rbf_gram as rg

    rg.launches = fm.matvec_launches = fm.moments_launches = 0
    bc.launches = bc.inv_launches = 0


def drive_iterative(m, Xs, check_rmse=True):
    """The user's steps on one model, the launch counters read around each.

    The predictive RMSE is checked at the starting parameters (the first
    predict), unless check_rmse is False (then recorded only). After optimize(max_iters=2) it is recorded, not checked: two
    L-BFGS-B steps take the noise variance from 0.1 to ~1e-4 and the
    lengthscale to ~4, where 48 CG steps are far from converged and the SLQ
    estimate of the NLML (~-1.3e5) is a bias the optimizer follows; the
    reference computes the same estimator, and both models here follow it."""
    import numpy as np
    import torch

    steps, marks = ["log_likelihood", "objective_and_grad", "predict_at_start", "optimize",
                    "predict", "predict_quantiles"], []
    truth = np.sin(Xs[:, :1])
    t0 = time.perf_counter()
    ll0 = m.log_likelihood().item()
    marks.append(counters())
    x0 = m.optimizer_array
    f0, g0 = m._objective_and_grad(x0)
    marks.append(counters())
    mu0, _ = m.predict(Xs)
    marks.append(counters())
    res = m.optimize(max_iters=2)
    marks.append(counters())
    mu, var = m.predict(Xs)
    marks.append(counters())
    q_lo, q_hi = m.predict_quantiles(Xs)
    marks.append(counters())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = {}
    prev = {k: 0 for k in marks[0]}
    for step, mark in zip(steps, marks):
        per_step[step] = {k: mark[k] - prev[k] for k in mark}
        prev = mark
    check(math.isfinite(ll0) and math.isfinite(f0) and np.isfinite(g0).all(),
          "iterative: non-finite NLML or gradient")
    # on the SLQ estimate only: at these parameters it is biased low, and the
    # exact NLML after optimize is recorded, not checked (run_iterative)
    check(res.f_opt < f0, f"iterative: optimize did not lower the NLML ({f0} -> {res.f_opt})")
    for name, a in (("mean at start", mu0), ("mean", mu), ("variance", var), ("q2.5", q_lo),
                    ("q97.5", q_hi)):
        check(a.shape == (ITER_PRED, 1) and np.isfinite(a).all(),
              f"iterative: predicted {name} is not finite (N*, 1)")
    check((var > 0).all() and (q_lo < mu).all() and (mu < q_hi).all(),
          "iterative: predictive intervals out of order")
    rmse0 = float(np.sqrt(np.mean((mu0 - truth) ** 2)))
    check(not check_rmse or rmse0 < float(np.std(truth)),
          f"iterative: predictive RMSE {rmse0} at the start is no better than the mean")
    return {"x0": x0, "f0": f0, "g0": g0, "nlml_after_2": res.f_opt, "status": res.status,
            "optimize_checked_on_estimate_only": True,
            "params_after_2": m.param_array.tolist(), "launches_per_step": per_step,
            "launches": marks[-1], "pred_rmse_vs_sin_at_start": rmse0,
            "pred_rmse_vs_sin_after_2": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "std_sin": float(np.std(truth)), "seconds": wall}


def exact_nlml_f64(X, Y, params):
    """-log p(Y) by a float64 Cholesky of the whole Gram: what the CG + SLQ
    estimate approximates. params = (variance, lengthscale, noise) of the
    non-ARD RBF model; the noise gets the iterative path's 1e-6. Peak
    device memory ~40 GB (the Gram and its factor)."""
    import torch
    from gpy_tpu_torch.kern import RBF

    v, ls, noise = (float(p) for p in params)
    Xt = torch.tensor(X, dtype=torch.float64, device="cuda")
    Yt = torch.tensor(Y, dtype=torch.float64, device="cuda")
    with torch.no_grad():
        K = RBF(ITER_D, variance=v, lengthscale=ls, device="cuda", dtype=torch.float64).K(Xt)
        K.diagonal().add_(noise + 1e-6)
        L, info = torch.linalg.cholesky_ex(K)
        del K
        check(int(info) == 0, "exact NLML: the float64 Gram is not positive definite")
        alpha = torch.cholesky_solve(Yt, L)
        nlml = 0.5 * (float(torch.sum(Yt * alpha))
                      + 2.0 * float(torch.sum(torch.log(torch.diagonal(L))))
                      + ITER_N * math.log(2 * math.pi))
    del L, alpha
    torch.cuda.empty_cache()
    return nlml


def run_iterative():
    """The iterative main path, each model driven with the counters set to 0
    just before it and read just after."""
    import numpy as np
    import torch

    X, Y, Xs = iterative_data()
    rec, models = {"phase": "iterative", "N": ITER_N, "D": ITER_D, "n_pred": ITER_PRED,
                   "options": ITER_OPTS, "dtype": "float32"}, {}
    for tag, fused in (("fused", True), ("auto", False)):
        m = iterative_model(X, Y, torch.float32, fused)
        reset_counters()
        r = drive_iterative(m, Xs)
        models[tag] = (m, r)
        rec[tag] = {k: v for k, v in r.items() if k not in ("x0", "g0")}
        torch.cuda.empty_cache()
    fused_steps = rec["fused"]["launches_per_step"]
    for step, c in fused_steps.items():
        check(c["gram_matvec_fused"] > 0, f"iterative fused: {step} launched no gram_matvec_fused")
    check(fused_steps["objective_and_grad"]["gram_moments"] == 1,
          "iterative fused: objective_and_grad did not launch gram_moments once")
    for step, c in rec["auto"]["launches_per_step"].items():
        check(c["rbf_gram"] > 0, f"iterative auto: {step} launched no rbf_gram")
    check(rec["auto"]["launches"]["gram_matvec_fused"] == 0, "iterative auto: launched B5")

    # float64 materialized twin at the fused model's initial parameters and
    # the same probes (one torch.Generator seed on the same device)
    m64 = iterative_model(X, Y, torch.float64, fused=False)
    f64, g64 = m64._objective_and_grad(models["fused"][1]["x0"])
    del m64
    torch.cuda.empty_cache()
    for tag in ("fused", "auto"):
        r = models[tag][1]
        nlml_rel = abs(r["f0"] - f64) / abs(f64)
        grad_rel = float(np.max(np.abs(r["g0"] - g64)) / np.max(np.abs(g64)))
        rec[tag]["nlml_rel_vs_f64"] = nlml_rel
        rec[tag]["grad_rel_vs_f64"] = grad_rel
    rec["nlml_f64"], rec["grad_f64"] = f64, g64.tolist()
    rec["limits"] = {"nlml_rel": ITER_NLML_TOL, "grad_rel": ITER_GRAD_TOL}
    check(rec["fused"]["nlml_rel_vs_f64"] <= ITER_NLML_TOL,
          f"iterative: fused float32 NLML vs float64: rel {rec['fused']['nlml_rel_vs_f64']}")
    check(rec["fused"]["grad_rel_vs_f64"] <= ITER_GRAD_TOL,
          f"iterative: fused float32 gradient vs float64: rel {rec['fused']['grad_rel_vs_f64']}")

    # the estimator against the exact NLML (float64 Cholesky), at the start
    # and where two optimizer steps took the fused model
    exact0 = exact_nlml_f64(X, Y, (1.0, 1.0, 0.1))
    exact2 = exact_nlml_f64(X, Y, rec["fused"]["params_after_2"])
    rec["exact_nlml_f64_at_start"] = exact0
    rec["slq_rel_err_at_start"] = abs(f64 - exact0) / abs(exact0)
    rec["exact_nlml_f64_after_2"] = exact2
    rec["slq_rel_err_after_2"] = abs(rec["fused"]["nlml_after_2"] - exact2) / abs(exact2)
    # at the start the 8-probe, 48-step estimate read 2.7% above the exact
    # value on an H100; the limit catches a wrong logdet or quadratic term,
    # not the estimator's own error. After optimize the estimate is not
    # checked: it is far below the exact NLML there (PERF.md)
    rec["limits"]["slq_rel_err_at_start"] = ITER_SLQ_TOL
    check(rec["slq_rel_err_at_start"] <= ITER_SLQ_TOL,
          f"iterative: SLQ NLML {f64} vs exact {exact0}: rel {rec['slq_rel_err_at_start']}")
    rec["predict_var_vs_f64"] = predict_var_vs_f64(X, Y, Xs)
    return models, Xs, rec


def predict_var_vs_f64(X, Y, Xs):
    """The fused float32 model's predictive (latent) variance at Xs, at the
    start parameters, against the same posterior (noise, kernel, CG steps)
    with every product of its CG through the float64 plain twin and K(X,
    Xs) in float64: the wide kernel (R = n*) on the predict path."""
    import torch
    from gpy_tpu_torch.inference.iterative import cg_batched
    from gpy_tpu_torch.ops import gram_matvec_fused as fm

    m = iterative_model(X, Y, torch.float32, fused=True)
    Xn = torch.tensor(Xs, dtype=torch.float32, device="cuda")
    post = m.posterior
    before = fm.matvec_launches
    _, var32 = m._raw_predict(Xn)
    launches = fm.matvec_launches - before
    with torch.no_grad():
        v = m.kern.variance.values.detach().double().reshape(1)
        ls = m.kern.lengthscale.values.detach().double()
        Xa, Xb = m.X.double() / ls, Xn.double() / ls
        noise = post._noise.double()
        Kx = fm._k_of_r2(0, fm._direct_r2(Xa, Xb), v)
        sol = cg_batched(lambda V: fm.stationary_gram_matvec_plain(Xa, Xa, V, v, 0)
                         + noise[:, None] * V, Kx, maxiter=post.max_cg)[0]
        var64 = torch.clamp_min(v - torch.sum(Kx * sol, dim=0), 1e-12)[:, None]
    check(var32.shape == var64.shape and bool(torch.isfinite(var32).all()),
          "iterative predict: non-finite or misshapen variance")
    rel = float((var32.double() - var64).abs().max() / var64.abs().max())
    check(rel <= ITER_PRED_VAR_TOL,
          f"iterative predict variance vs float64 twin: rel {rel} > {ITER_PRED_VAR_TOL}")
    del m, Kx, sol
    torch.cuda.empty_cache()
    return {"n_pred": len(Xs), "max_cg": post.max_cg, "b5_launches": launches,
            "rel_err": rel, "rel_tol": ITER_PRED_VAR_TOL,
            "max_elementwise_rel_err": float(((var32.double() - var64).abs() / var64).max()),
            "var_range_f64": [float(var64.min()), float(var64.max())]}


def fused_matvec_bounds(N, M, D, R):
    """Least time for B5 (float32). `bound_ms`: the inputs read and the
    output written once over the memory rate (`bytes_ms`), or (3D+3)
    operations per Gram entry for K and 2R for the contraction over the
    float32 peak, whichever is longer. `bound_tc_ms`: the same work with the
    contraction on the tensor cores, the longest of the bytes, K's 3D+3 at
    the float32 peak and 3 passes (3xTF32) of 2R at the TF32 peak."""
    t_bytes = 4 * (N * D + M * D + M * R + N * R + 1) / PEAK_BYTES_S
    t_ops = N * M * (3 * D + 3 + 2 * R) / PEAK_FLOPS["float32"]
    tc = {"bytes": t_bytes, "operations": N * M * (3 * D + 3) / PEAK_FLOPS["float32"],
          "tensor_cores": N * M * 2 * R * 3 / PEAK_TF32_TC}
    tc_by = max(tc, key=tc.get)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_tc_ms": tc[tc_by] * 1e3, "bound_tc_by": tc_by, "bytes_ms": t_bytes * 1e3}


def cross_matvec_bounds(N, M, D, R):
    """Least time for B5's cross-term kernel (float32, 8 < D <= 64, R <=
    16), the longest of: the bytes (fused_matvec_bounds'); the cross term's
    3 passes of 2 D_pad TF32 operations an entry (D_pad: D up to a multiple
    of 8) at the TF32 peak; the SIMT operations that remain, 2R for the
    contraction and 4 for r2 and K (the accumulator's start, the clamp, the
    exp, the multiply by v), at the float32 peak. `bound_direct_ms`: the
    direct form's (3D+3) + 2R an entry at the float32 peak
    (fused_matvec_bounds' `bound_ms`)."""
    base = fused_matvec_bounds(N, M, D, R)
    t = {"bytes": base["bytes_ms"] / 1e3,
         "operations": N * M * (2 * R + 4) / PEAK_FLOPS["float32"],
         "tensor_cores": N * M * 3 * 2 * (-(-D // 8) * 8) / PEAK_TF32_TC}
    by = max(t, key=t.get)
    return {"bound_ms": t[by] * 1e3, "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_cross_by": by, "bound_simt_ms": t["operations"] * 1e3,
            "bound_tensor_cores_ms": t["tensor_cores"] * 1e3,
            "bound_direct_ms": base["bound_ms"], "bound_direct_by": base["bound_by"],
            "bytes_ms": base["bytes_ms"]}


# the main path's B5 and B6 instances: RBF, R chunk 9, DMAX 4; B5's wide
# instance (R > 16: a predict's CG at D = 4), RBF, DMAX 4; B6's kernel by
# the profiler's name
MAIN_B5_INSTANCE = "gram_matvec_tile_kernelILi0ELi9ELi4E"
WIDE_B5_INSTANCE = "gram_matvec_tc_kernelILi0ELi4E"
MAIN_B6_INSTANCE = "gram_moments_tile_kernelILi0ELi9ELi4E"
B6_KERNEL = "gram_moments_tile_kernel<"
# B6's mma kernel (D > 8 or R > 16) by the profiler's name, and its instance
# on the D=12 path (RBF, DMAX 12, two k-steps of R)
B6_CHUNK_KERNEL = "gram_moments_mma_kernel<"
CHUNK_B6_INSTANCE = "gram_moments_mma_kernelILi0ELi12ELi2EE"
# the widest D the cross-term kernel takes (kCrossMaxD)
CROSS_MAX_D = 64


def ptxas_of(report, instance):
    """ptxas' lines (registers, spills) for the kernel whose mangled name
    holds `instance`, from nvcc's -Xptxas -v report."""
    lines, keep = [], False
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            keep = instance in ln
        elif keep and ("registers" in ln or "spill" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


def gram_moments_bound(N, D, R):
    """Least time for B6 (float32): X, G and V read once and D+1 moments
    written over the memory rate, or per Gram entry 2R operations for W,
    3D+3 for K, 2 for the two weights and 3D for the moments."""
    t_bytes = (4 * (N * D + 2 * N * R + 1) + 8 * (D + 1)) / PEAK_BYTES_S
    t_ops = N * N * (2 * R + 6 * D + 5) / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gram_moments_bounds(N, D, R):
    """Least time for B6's mma kernel (float32), the longest of: the bytes
    (gram_moments_bound's); W's 3 passes of 2R TF32 operations an entry at
    the TF32 peak; the SIMT operations that remain, 4D + 7 an entry (each
    dimension's difference, square, sum into r2 and moment; the weights) at
    the float32 peak. `bound_mma_by` names the longest of the three;
    `bound_all_simt_ms`: gram_moments_bound's count, W in FFMA, the table's
    second yardstick."""
    t = {"bytes": (4 * (N * D + 2 * N * R + 1) + 8 * (D + 1)) / PEAK_BYTES_S,
         "operations": N * N * (4 * D + 7) / PEAK_FLOPS["float32"],
         "tensor_cores": N * N * 3 * 2 * R / PEAK_TF32_TC}
    by = max(t, key=t.get)
    all_simt_ms, all_simt_by = gram_moments_bound(N, D, R)
    return {"bound_ms": t[by] * 1e3, "bound_by": "bytes" if by == "bytes" else "operations",
            "bound_mma_by": by, "bound_simt_ms": t["operations"] * 1e3,
            "bound_tensor_cores_ms": t["tensor_cores"] * 1e3,
            "bound_all_simt_ms": all_simt_ms, "bound_all_simt_by": all_simt_by}


def time_fused(fm, R, reps, plain_reps, D=ITER_D):
    """B5 at N=50,000 (D=4 unless given), square (diag_offset 0), on inputs
    centred as the wrapper centres them above D = 8: the profiler's device
    time per launch (`ms`) beside the event time, the plain twin's time,
    its error and bounds (the cross-term kernel's, 8 < D <= 64 and R <= 16,
    by cross_matvec_bounds)."""
    import torch

    X, _, V, ls, v = fused_inputs(ITER_N, None, D, R, seed=11)
    Xs = fm._centred(X / ls, X / ls)[0].contiguous()
    v1 = v.reshape(1)

    def run():
        return fm.stationary_gram_matvec_cuda(Xs, Xs, V, v1, 0, diag_offset=0)

    ms = device_ms(run, reps=reps, warmup=1, kernel="gram_matvec")[0]
    event_ms = cuda_ms(run, reps=reps, warmup=1)
    plain_ms = cuda_ms(lambda: fm.stationary_gram_matvec_plain(Xs, Xs, V, v1, 0, 0),
                       reps=plain_reps, warmup=1)
    out = run()
    ref = fm.stationary_gram_matvec_plain(Xs, Xs, V, v1, 0, 0)
    check(torch.isfinite(out).all(), f"gram_matvec_fused N={ITER_N} D={D} R={R}: non-finite output")
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    tol = FUSED_FWD_TOL_50K[R]
    check(rel <= tol, f"gram_matvec_fused N={ITER_N} D={D} R={R}: rel err {rel} > {tol}")
    bounds = (cross_matvec_bounds if 8 < D <= CROSS_MAX_D and R <= 16 else fused_matvec_bounds)
    return {"N": ITER_N, "D": D, "R": R, "dtype": "float32", "ms": ms,
            "event_ms": event_ms, "plain_ms": plain_ms,
            **bounds(ITER_N, ITER_N, D, R), "max_abs_err": err,
            "rel_err": rel, "rel_tol": tol, "library_ms": None}


def time_moments(fm, R=9, D=ITER_D):
    """B6 at N=50,000 (D=4 unless given) on signed G and V: the profiler's
    device time per launch of its kernel (`ms`; the register-tile kernel,
    or the mma kernel at D > 8 or R > 16) and of its reduce (`reduce_ms`)
    beside the event time of the two (`event_ms`), the plain twin's time, a
    second launch bit for bit, its error against the float64 twin within
    FUSED_BWD_TOL_50K (the mma kernel: MOMENTS_MMA_TOL_50K) and its
    bounds."""
    import torch

    mma = D > 8 or R > 16
    X, _, V, ls, v = fused_inputs(ITER_N, None, D, R, seed=12)
    _, _, G, _, _ = fused_inputs(ITER_N, None, D, R, seed=13)
    Xs = (X / ls).contiguous()
    v1 = v.reshape(1)

    def run():
        return fm.gram_moments_cuda(Xs, G, V, v1, 0)

    ms, reduce_ms, _, _ = device_ms(run, reps=10, warmup=1,
                                    kernel=B6_CHUNK_KERNEL if mma else B6_KERNEL)
    event_ms = cuda_ms(run, reps=10, warmup=1)
    plain_ms = cuda_ms(lambda: fm.gram_moments_plain(Xs, G, V, v1, 0), reps=2, warmup=1)
    a = fm.gram_moments_cuda(Xs, G, V, v1, 0)
    check(torch.equal(a, fm.gram_moments_cuda(Xs, G, V, v1, 0)),
          "gram_moments: two launches on the same inputs differ")
    b = fm.gram_moments_plain(Xs.double(), G.double(), V.double(), v1.double(), 0)
    check(torch.isfinite(a).all(), f"gram_moments N={ITER_N}: non-finite moments")
    err = float((a - b).abs().max())
    rel = err / float(b.abs().max())
    tol = MOMENTS_MMA_TOL_50K[(D, R)] if mma else FUSED_BWD_TOL_50K
    check(rel <= tol, f"gram_moments N={ITER_N} D={D} R={R}: rel err {rel} vs float64 plain > {tol}")
    bounds = (gram_moments_bounds(ITER_N, D, R) if mma
              else dict(zip(("bound_ms", "bound_by"), gram_moments_bound(ITER_N, D, R))))
    return {"N": ITER_N, "D": D, "R": R, "dtype": "float32", "ms": ms,
            "kernel": B6_CHUNK_KERNEL if mma else B6_KERNEL,
            "reduce_ms": reduce_ms, "event_ms": event_ms, "plain_ms": plain_ms,
            **bounds, "repeats_bit_for_bit": True,
            "max_abs_err_vs_f64_plain": err, "rel_err": rel, "rel_tol": tol,
            "max_elementwise_rel_err_vs_f64_plain": float(((a - b).abs() / b.abs()).max()),
            "library_ms": None}


def iterative_times(models, Xs, fm, smi):
    import torch

    rec = {"phase": "iterative_times", "nvidia_smi": smi,
           "gram_matvec_fused": [time_fused(fm, 9, reps=20, plain_reps=3),
                                 time_fused(fm, 16, reps=20, plain_reps=1),
                                 time_fused(fm, 256, reps=10, plain_reps=2),
                                 time_fused(fm, 1, reps=10, plain_reps=2),
                                 time_fused(fm, 17, reps=10, plain_reps=1),
                                 time_fused(fm, 64, reps=10, plain_reps=1),
                                 time_fused(fm, 1024, reps=5, plain_reps=1)],
           "gram_matvec_fused_timing": "ms: torch.profiler device time per launch; "
                                       "event_ms: CUDA events over the same launches",
           "gram_moments": [time_moments(fm), time_moments(fm, 17)]}
    torch.cuda.empty_cache()
    for tag, (m, _) in models.items():
        x = m.optimizer_array
        reset_counters()
        rec[f"objective_and_grad_ms_{tag}"] = host_ms(lambda: m._objective_and_grad(x),
                                                      reps=3, warmup=1)
        rec[f"launches_per_objective_and_grad_{tag}"] = {
            k: c / 4 for k, c in counters().items()}
        m.predict(Xs)  # the posterior at these parameters is cached from here on
        rec[f"predict_ms_n{ITER_PRED}_posterior_cached_{tag}"] = host_ms(
            lambda: m.predict(Xs), reps=2, warmup=0)
    # the materialized path's CG product, for context: (P, P) f32 @ (P, 9)
    from gpy_tpu_torch.ops.gram_matvec import gram_materialize

    m = models["auto"][0]
    with torch.no_grad():
        K, P = gram_materialize(m.kern, m.X, noise=torch.full((ITER_N,), 0.1, device="cuda"),
                                block=ITER_OPTS["block"])
        V = torch.randn((P, 9), device="cuda")
        rec["materialized_matvec_matmul_ms"] = cuda_ms(lambda: torch.matmul(K, V), reps=10)
        rec["materialized_gram_gib"] = K.numel() * K.element_size() / 2**30
    del K, V
    torch.cuda.empty_cache()
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return rec


# --- the iterative exact GP at D = 12 (B5's cross-term kernel) --------------

# bench.py:456-483's N=50k iterative configuration (ITER_OPTS, fused,
# materialize=False, noise 0.1, Y = sin(x_1) + 0.1 eps, float32) on 12
# input dimensions, X ~ U[0,10)^12, with an ARD RBF whose lengthscales start
# at 3.0: no more diagonal a Gram than the D=4 model's at lengthscale 1
D12, D12_LS = 12, 3.0


def d12_data(seed=0):
    """X ~ U[0,10)^12, Y = sin(x_1) + 0.1 eps, float32; ITER_PRED new points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.random((ITER_N, D12)).astype(np.float32) * 10.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((ITER_N, 1))).astype(np.float32)
    Xs = rng.random((ITER_PRED, D12)).astype(np.float32) * 10.0
    return X, Y, Xs


def d12_model(X, Y, dtype, fused):
    """GPRegression over RBF(12, ARD=True, lengthscale=3.0), noise 0.1, with
    ITER_OPTS: fused=True, materialize=False, or the default
    (materialize="auto", the Gram materialized at N=50,000)."""
    from gpy_tpu_torch.inference import IterativeGaussianInference
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPRegression

    opts = dict(ITER_OPTS, materialize=False, fused=True) if fused else dict(ITER_OPTS)
    return GPRegression(X, Y, RBF(D12, ARD=True, lengthscale=D12_LS, device="cuda", dtype=dtype),
                        noise_var=0.1, inference_method=IterativeGaussianInference(**opts),
                        device="cuda", dtype=dtype)


def launches_by_name(fn, expect):
    """Launches of the kernels whose profiler names hold each key of
    `expect` over one call of fn (torch.profiler). A session that lost
    device events is run again, up to five in all, and the fullest kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    best = None
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        got = {name: sum(e.count for e in rows if name in e.key) for name in expect}
        if best is None or sum(got.values()) > sum(best.values()):
            best = got
        if best == expect:
            break
    return best


def run_iterative_d12(fm, smi):
    """The fused iterative exact GP at D = 12, the main path of B5's
    cross-term kernel: drive_iterative on the float32 model with the
    counters set to 0 just before it (its predictive RMSE recorded, not
    checked); each objective_and_grad 49 B5 launches (48 CG products, the
    surrogate's forward) and one B6, all 49 under the cross-term kernel's
    profiler name and B6's under its chunk kernel's; the float32 NLML and
    its 14 gradient entries against a float64 materialized twin at the same
    probes (ITER_NLML_TOL, ITER_GRAD_TOL); the NLML+gradient and the predict
    at 256 points (48 launches of B5's tensor-core kernel, DMAX 0) timed;
    the cross-term kernel (R = 9) and the tensor-core one (R = 256) at
    N=50,000, D=12 by device time beside their twins and bounds."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    X, Y, Xs = d12_data()
    m = d12_model(X, Y, torch.float32, fused=True)
    reset_counters()
    r = drive_iterative(m, Xs, check_rmse=False)
    steps = r["launches_per_step"]
    for step, c in steps.items():
        check(c["gram_matvec_fused"] > 0, f"iterative D=12: {step} launched no gram_matvec_fused")
    og = steps["objective_and_grad"]
    per_eval = {CROSS_B5_KERNEL: ITER_OPTS["max_cg"] + 1, B6_CHUNK_KERNEL: 1}
    check(og["gram_matvec_fused"] == per_eval[CROSS_B5_KERNEL] and og["gram_moments"] == 1,
          f"iterative D=12: objective_and_grad launched {og}, not 49 B5 and 1 B6")
    rec = {"phase": "iterative_d12", "N": ITER_N, "D": D12, "lengthscale_start": D12_LS,
           "n_pred": ITER_PRED, "options": ITER_OPTS, "dtype": "float32", "fused": True,
           "drive": {k: v for k, v in r.items() if k not in ("x0", "g0")},
           # the steps that run B5 at R <= 16 only: every launch is the
           # cross-term kernel's (a predict's also run its R = 256 CG)
           "cross_launches": sum(steps[k]["gram_matvec_fused"]
                                 for k in ("log_likelihood", "objective_and_grad", "optimize"))}
    x0 = r["x0"]
    m64 = d12_model(X, Y, torch.float64, fused=False)
    f64, g64 = m64._objective_and_grad(x0)
    del m64
    torch.cuda.empty_cache()
    check(len(g64) == D12 + 2 and len(r["g0"]) == D12 + 2, "iterative D=12: not 14 gradient entries")
    rec["nlml_rel_vs_f64"] = abs(r["f0"] - f64) / abs(f64)
    rec["grad_rel_vs_f64"] = float(np.max(np.abs(r["g0"] - g64)) / np.max(np.abs(g64)))
    rec["grad_rel_vs_f64_by_entry"] = (np.abs(r["g0"] - g64) / np.abs(g64)).tolist()
    rec["nlml_f32"], rec["nlml_f64"], rec["grad_f64"] = r["f0"], f64, g64.tolist()
    rec["limits"] = {"nlml_rel": ITER_NLML_TOL, "grad_rel": ITER_GRAD_TOL}
    rec["launches_by_profiler_name"] = launches_by_name(lambda: m._objective_and_grad(x0), per_eval)
    rec["objective_and_grad_ms"] = host_ms(lambda: m._objective_and_grad(x0), reps=3, warmup=1)
    m.predict(Xs)  # the posterior at x0 is cached from here on
    rec["predict_ms_posterior_cached"] = host_ms(lambda: m.predict(Xs), reps=2, warmup=0)
    rec["profile"] = profile_objective(m, x0, what=f"one objective_and_grad, iterative fused, "
                                                   f"N={ITER_N}, D={D12} float32")
    del m
    torch.cuda.empty_cache()
    rec["cross_kernel"] = time_fused(fm, 9, reps=10, plain_reps=1, D=D12)
    rec["wide_kernel_r256"] = time_fused(fm, 256, reps=5, plain_reps=1, D=D12)
    torch.cuda.empty_cache()
    rec["moments_kernel"] = time_moments(fm, 9, D=D12)
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    rec["nvidia_smi"] = smi
    emit(rec)  # before the limits below, so that a failing run still shows its readings
    check(rec["nlml_rel_vs_f64"] <= ITER_NLML_TOL,
          f"iterative D=12: float32 NLML vs float64: rel {rec['nlml_rel_vs_f64']}")
    check(rec["grad_rel_vs_f64"] <= ITER_GRAD_TOL,
          f"iterative D=12: float32 gradient vs float64: rel {rec['grad_rel_vs_f64']}")
    check(rec["launches_by_profiler_name"] == per_eval,
          f"iterative D=12: objective_and_grad's kernels by name {rec['launches_by_profiler_name']}, "
          f"not {per_eval}")
    return rec


# --- the batched exact GP: block Cholesky (B2/B3, B4), HMC, restarts --------

# bench.py:847-889: HMC over the 3 hyperparameters of an exact GP at N=1000
HMC_N, HMC_D, HMC_SAMPLES, HMC_LEAPFROG, HMC_STEP = 1000, 2, 40, 10, 2e-2
HMC_CHAINS = (1, 2, 4, 8, 16)
HMC_RESTARTS = 16
CHOL_BLOCK = 128
# the batches the HMC chains and the restarts hand B2/B3, timed in chol_times
CHOL_TIME_BATCHES = (2, 4, 8, 16)
# the batches B4 is checked at
CHOL_INV_BATCHES = (2, 8, 16)


def chol_batches(bc):
    """Every batch C the main path hands B2/B3 (the chains of 2 and more,
    the parallel restarts), with 1, 32 and the batched rule's gate
    `bc.MAX_BATCH` (64): the kernels are checked at each of them."""
    return sorted({1, 32, HMC_RESTARTS, bc.MAX_BATCH} | {C for C in HMC_CHAINS if C >= 2})


def block_columns():
    """B2/B3 launches per batched factorization: n padded to 128s."""
    return -(-HMC_N // CHOL_BLOCK)
# the kernels against their plain twins on the card, max abs error (inputs
# G G' + 128 I, entries ~10): ~10x the first readings on an H100 (B2 f32
# 1.9e-6, f64 3.6e-15; B4's L^-1 f32 1.5e-8, f64 2.8e-17; |L^-1 L - I| f32
# 6.9e-8, f64 1.8e-16)
CHOL_TOL = {"float32": 2e-5, "float64": 4e-14}
CHOL_INV_TOL = {"float32": 1.5e-7, "float64": 3e-16}
CHOL_RESID_TOL = {"float32": 1e-6, "float64": 2e-15}


def chol_inputs(C, n, dtype, seed, rank=40):
    """C SPD (n, n) matrices G G' + n I, made on the CPU from a seed."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    G = torch.randn(C, n, rank, generator=g, dtype=torch.float64)
    return (G @ G.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64)).to(
        dtype=dtype, device="cuda")


def check_block_chol(bc, C, dtype):
    import torch

    name = str(dtype).replace("torch.", "")
    A = chol_inputs(C, CHOL_BLOCK, dtype, seed=C)
    L = bc.block_chol_cuda(A)
    Lp = bc.block_chol_plain(A)
    torch.cuda.synchronize()
    err = float((L - Lp).abs().max())
    check(torch.isfinite(L).all(), f"block_chol C={C} {name}: non-finite factor of SPD input")
    check(err <= CHOL_TOL[name], f"block_chol C={C} {name}: max err {err} > {CHOL_TOL[name]}")
    check(torch.equal(L, torch.tril(L)), f"block_chol C={C} {name}: entries above the diagonal")
    check(torch.equal(L, bc.block_chol_cuda(A)), f"block_chol C={C} {name}: two launches differ")
    return {"C": C, "dtype": name, "max_abs_err": err, "tol": CHOL_TOL[name]}


def check_block_chol_inv(bc, C, dtype):
    """B4 against its plain twin: L within CHOL_TOL, L^-1 within
    CHOL_INV_TOL, |L^-1 L - I| within CHOL_RESID_TOL; both outputs exactly
    zero above the diagonal, equal bits from two launches, and L bit-equal
    to B2/B3's (the kernels share their factor)."""
    import torch

    name = str(dtype).replace("torch.", "")
    A = chol_inputs(C, CHOL_BLOCK, dtype, seed=99 + C)
    L, Li = bc.block_chol_inv_cuda(A)
    Lp, Lip = bc.block_chol_inv_plain(A)
    torch.cuda.synchronize()
    err_l = float((L - Lp).abs().max())
    err_li = float((Li - Lip).abs().max())
    eye = torch.eye(CHOL_BLOCK, dtype=torch.float64, device="cuda")
    resid = float((Li.double() @ L.double() - eye).abs().max())
    label = f"block_chol_inv C={C} {name}"
    check(err_l <= CHOL_TOL[name], f"{label}: L err {err_l}")
    check(err_li <= CHOL_INV_TOL[name], f"{label}: L^-1 err {err_li}")
    check(resid <= CHOL_RESID_TOL[name], f"{label}: |L^-1 L - I| {resid}")
    check(torch.equal(L, torch.tril(L)) and torch.equal(Li, torch.tril(Li)),
          f"{label}: entries above a diagonal")
    L2, Li2 = bc.block_chol_inv_cuda(A)
    check(torch.equal(L, L2) and torch.equal(Li, Li2), f"{label}: two launches differ")
    check(torch.equal(L, bc.block_chol_cuda(A)), f"{label}: L differs from block_chol's")
    return {"C": C, "dtype": name, "max_abs_err": err_l, "inv_max_abs_err": err_li,
            "inv_resid": resid, "tol": [CHOL_TOL[name], CHOL_INV_TOL[name], CHOL_RESID_TOL[name]]}


def rank_deficient_block(n, rank, dtype, seed):
    """M M' with M = [L1; R] (n x rank): L1 the factor of a well-conditioned
    rank x rank SPD matrix, R random. Its first `rank` pivots are L1's
    squared diagonal and the Schur complement of the rest is 0 up to
    rounding (~3e-6 here in float32). Entry [rank, rank] (~rank) less 1
    stays positive, but pivot `rank` becomes -1: the bad pivot appears
    only through the updates of the columns before it."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    G = torch.randn(rank, 40, generator=g, dtype=torch.float64)
    L1 = torch.linalg.cholesky(G @ G.T + rank * torch.eye(rank, dtype=torch.float64))
    M = torch.cat([L1, torch.randn(n - rank, rank, generator=g, dtype=torch.float64)])
    A = M @ M.T
    A[rank, rank] -= 1.0
    return A.to(dtype=dtype, device="cuda")


def first_nan_column(L) -> int:
    """The first column of L that holds a NaN (its width when none does)."""
    cols = L.isnan().any(0).nonzero().flatten().tolist()
    return int(cols[0]) if cols else L.shape[-1]


def first_nan_row(L) -> int:
    return first_nan_column(L.transpose(-1, -2))


# B2/B3's bad pivots: a diagonal entry set to -5 inside the first 16-column
# panel, on the first panel boundary, and in the last panel; then a pivot
# that turns negative only through the trailing updates (column 100, in the
# seventh panel)
NAN_PIVOTS = (10, 16, 120)
NAN_RANK = 100


def check_nan_isolation(bc, dtype):
    """A bad pivot in element 3 of 8, for each case of NAN_PIVOTS and the
    rank-deficient block, through B2/B3 (L) and B4 (L and L^-1): NaN only
    in element 3; its NaN entries and its first NaN row and column the
    plain twin's (L's first NaN row and column the pivot's, L^-1's first
    NaN row too); L's columns before the pivot within CHOL_TOL of the twin
    and, for an injected pivot, bit-equal to the clean run's, as are L^-1's
    rows before it; exact zeros above every diagonal; the other seven
    elements bit-equal to a clean run."""
    import torch

    name = str(dtype).replace("torch.", "")
    A = chol_inputs(8, CHOL_BLOCK, dtype, seed=77)
    others = (0, 1, 2, 4, 5, 6, 7)
    kernels = {"block_chol": (lambda X: (bc.block_chol_cuda(X),),
                              lambda X: (bc.block_chol_plain(X),)),
               "block_chol_inv": (bc.block_chol_inv_cuda, bc.block_chol_inv_plain)}
    clean = {k: run(A) for k, (run, _) in kernels.items()}
    cases = {k: [] for k in kernels}
    for col in NAN_PIVOTS + (NAN_RANK,):
        bad = A.clone()
        if col == NAN_RANK:
            bad[3] = rank_deficient_block(CHOL_BLOCK, NAN_RANK, dtype, seed=78)
        else:
            bad[3, col, col] = -5.0
        for kname, (run, twin) in kernels.items():
            outs, refs = run(bad), twin(bad)
            torch.cuda.synchronize()
            label = f"{kname} {name} bad pivot at {col}"
            firsts = []
            for which, X, Xp, Xc in zip(("L", "L^-1"), outs, refs, clean[kname]):
                lab = f"{label}, {which}"
                nan = X.isnan().flatten(1).any(1).tolist()
                check(nan == [c == 3 for c in range(8)], f"{lab}: NaN in elements {nan}")
                first = (first_nan_row(X[3]), first_nan_column(X[3]))
                twin_first = (first_nan_row(Xp[3]), first_nan_column(Xp[3]))
                check(first == twin_first and first[0] == col,
                      f"{lab}: first NaN row and column {first}, twin {twin_first}")
                check(torch.equal(X[3].isnan(), Xp[3].isnan()),
                      f"{lab}: NaN entries differ from twin")
                check(bool((torch.triu(X, 1) == 0).all()), f"{lab}: entries above the diagonal")
                for c in others:
                    check(torch.equal(X[c], Xc[c]), f"{lab}: element {c} changed")
                firsts.append(first)
            L, Lp, Lc = outs[0], refs[0], clean[kname][0]
            check(firsts[0][1] == col, f"{label}: first NaN column of L {firsts[0][1]}")
            err = float((L[3, :, :col] - Lp[3, :, :col]).abs().max())
            check(err <= CHOL_TOL[name], f"{label}: columns before it differ from twin by {err}")
            if col != NAN_RANK:
                check(torch.equal(L[3, :, :col], Lc[3, :, :col]),
                      f"{label}: columns before it differ from the clean run")
                if len(outs) == 2:
                    check(torch.equal(outs[1][3, :col], clean[kname][1][3, :col]),
                          f"{label}: rows of L^-1 before it differ from the clean run")
            cases[kname].append({
                "column": col, "first_nan_row_column": firsts, "pre_nan_err_vs_twin": err,
                "kind": "rank-deficient" if col == NAN_RANK else "diagonal set to -5"})
    return {"dtype": name, "bad_element": 3, **cases}


def hmc_data(seed=0):
    """bench.py:851-854: X ~ U[0,4)^2, Y = sin(x_1) + 0.1 eps, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.random((HMC_N, HMC_D)).astype(np.float32) * 4.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((HMC_N, 1))).astype(np.float32)
    return X, Y


def hmc_model(X, Y, dtype):
    """bench.py:855: GPRegression(X, Y, noise_var=0.1), the default RBF."""
    from gpy_tpu_torch.models import GPRegression

    return GPRegression(X, Y, noise_var=0.1, device="cuda", dtype=dtype)


def batch_grams(m, C, seed):
    """C noisy Grams of the HMC model at parameters jittered around its
    point (what one batched evaluation factors), built on the card."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    x0 = m.get_flat_raw()
    flats = x0[None] + 0.2 * torch.randn((C, x0.numel()), generator=g, dtype=x0.dtype).to("cuda")
    with torch.no_grad():
        Ks = []
        for row in flats:
            with m.bind_flat_raw(row):
                Ks.append(m.inference_method.noisy_gram(m.kern, m.X, m.likelihood))
        return torch.stack(Ks)


# the blocked routines on the HMC model's Grams at (C, 1000, 1000) float32
# against float64: ~10x the first readings on an H100 (factor 1.32e-5
# relative to max|L|, |L^-1 L - I| 2.7e-6)
BLOCKED_REL_TOL = 1.5e-4
BLOCKED_RESID_TOL = 3e-5


def check_blocked(bc, m):
    """The three blocked routines on the HMC model's Grams at (8, 1000, 1000)
    and (16, 1000, 1000) float32 against a float64 torch.linalg
    factorization; the B4 path (batched_chol_inv(version=1)) read with its
    counters."""
    import torch

    out, b4_launches = [], 0
    for C in (8, 16):
        K = batch_grams(m, C, seed=C)
        L64 = torch.linalg.cholesky(K.double())
        eye = torch.eye(HMC_N, dtype=torch.float64, device="cuda")
        for name, fn in (("ll", bc.batched_chol_inv_ll),
                         ("v1", lambda k: bc.batched_chol_inv(k, version=1)),
                         ("v2", lambda k: bc.batched_chol_inv(k, version=2))):
            reset_counters()
            L, Li = fn(K)
            torch.cuda.synchronize()
            launched = counters()
            if name == "v1":
                b4_launches += launched["block_chol_inv"]
            rel = float((L.double() - L64).abs().max() / L64.abs().max())
            resid = float((Li.double() @ L.double() - eye).abs().max())
            check(torch.isfinite(L).all() and torch.isfinite(Li).all(),
                  f"blocked {name} C={C}: non-finite factor")
            kernel = "block_chol_inv" if name == "v1" else "block_chol"
            check(launched[kernel] == block_columns(),
                  f"blocked {name} C={C}: {launched[kernel]} {kernel} launches")
            check(rel <= BLOCKED_REL_TOL and resid <= BLOCKED_RESID_TOL,
                  f"blocked {name} C={C}: rel err {rel}, |L^-1 L - I| {resid}")
            out.append({"routine": name, "C": C, "rel_err_vs_f64": rel, "inv_resid": resid,
                        "launches": launched})
    return out, b4_launches


def run_kernels_chol(bc, m):
    import torch

    rec = {"phase": "kernels_chol",
           "block_chol": [check_block_chol(bc, C, dt) for dt in (torch.float32, torch.float64)
                          for C in chol_batches(bc)],
           "block_chol_inv": [check_block_chol_inv(bc, C, dt)
                              for dt in (torch.float32, torch.float64) for C in CHOL_INV_BATCHES],
           "nan_isolation": [check_nan_isolation(bc, dt) for dt in (torch.float32, torch.float64)]}
    rec["blocked"], b4_path_launches = check_blocked(bc, m)
    # rec_block_chol_inv: B4 leaves of an identity-padded (8, 1024, 1024) batch
    K = batch_grams(m, 8, seed=3)
    Kp = torch.zeros((8, 1024, 1024), dtype=K.dtype, device="cuda")
    Kp[:, :HMC_N, :HMC_N] = K
    Kp[:, HMC_N:, HMC_N:] = torch.eye(1024 - HMC_N, dtype=K.dtype, device="cuda")
    reset_counters()
    L, _ = bc.rec_block_chol_inv(Kp)
    torch.cuda.synchronize()
    b4_path_launches += bc.inv_launches
    L64 = torch.linalg.cholesky(K.double())
    rel = float((L[:, :HMC_N, :HMC_N].double() - L64).abs().max() / L64.abs().max())
    check(bc.inv_launches == 8 and rel <= BLOCKED_REL_TOL,
          f"rec_block_chol_inv: {bc.inv_launches} launches, rel err {rel}")
    rec["rec_block_chol_inv"] = {"C": 8, "n": 1024, "launches": 8, "rel_err_vs_f64": rel}
    rec["blocked_limits"] = {"rel_err_vs_f64": BLOCKED_REL_TOL, "inv_resid": BLOCKED_RESID_TOL}
    worst = {k: max(r["max_abs_err"] for r in rec[k] if r["dtype"] == "float32")
             for k in ("block_chol", "block_chol_inv")}
    return rec, worst, b4_path_launches


def raw_from_constrained(m, vals):
    """Raw vectors (..., P) from constrained samples, by each free entry's
    inverse transform."""
    import torch

    cols, i = [], 0
    for _, mod, n in m._free_entries():
        sz = mod._parameters[n].numel()
        tr = mod._specs[n].transform
        block = torch.as_tensor(vals[..., i:i + sz], dtype=torch.float64)
        cols.append(tr.inverse(block) if tr is not None else block)
        i += sz
    return torch.cat(cols, -1)


# the batched logp and gradient at the 16 chains' final states against the
# unbatched path (B2's blocked factorization against cuSOLVER), relative to
# max|.|: in float64, where the two must agree to rounding, and in float32,
# where both carry the float32 error of a Gram whose condition number is
# ~1e5 at the posterior's noise (~0.01); the float32 batched path is also
# held against the float64 one. ~10x the first readings on an H100 (PERF.md)
HMC_REL_TOL = {"f64_logp_vs_unbatched": 2e-12, "f64_grad_vs_unbatched": 6e-11,
               "f32_logp_vs_unbatched": 7e-4, "f32_grad_vs_unbatched": 2.5e-2,
               "f32_logp_vs_f64": 1.3e-3, "f32_grad_vs_f64": 6.5e-2}


def logp_rel_errors(hmc, h64, raw):
    """Relative errors of the batched logp and gradient at the raw states."""
    import torch
    from gpy_tpu_torch.core.model import value_and_grad

    def both(h, x):
        vb, gb = value_and_grad(h._logp, x)
        per_row = [value_and_grad(h._logp, x[c]) for c in range(x.shape[0])]
        vu = torch.stack([r[0] for r in per_row])
        gu = torch.stack([r[1] for r in per_row])
        return vb.double(), gb.double(), vu.double(), gu.double()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    vb32, gb32, vu32, gu32 = both(hmc, raw.to(device="cuda", dtype=torch.float32))
    vb64, gb64, vu64, gu64 = both(h64, raw.to("cuda"))
    return {"f64_logp_vs_unbatched": rel(vb64, vu64), "f64_grad_vs_unbatched": rel(gb64, gu64),
            "f32_logp_vs_unbatched": rel(vb32, vu32), "f32_grad_vs_unbatched": rel(gb32, gu32),
            "f32_logp_vs_f64": rel(vb32, vb64), "f32_grad_vs_f64": rel(gb32, gb64),
            "f32_unbatched_logp_vs_f64": rel(vu32, vb64),
            "f32_unbatched_grad_vs_f64": rel(gu32, gb64)}


def run_hmc(m, X, Y):
    """The main path: HMC(m).sample(num_chains=C) at bench's configuration,
    the counters set to 0 just before each timed sample() and read just
    after."""
    import numpy as np
    import torch
    from gpy_tpu_torch import mcmc

    hmc = mcmc.HMC(m, stepsize=HMC_STEP, num_leapfrog=HMC_LEAPFROG)
    evals = HMC_SAMPLES * (1 + HMC_LEAPFROG)
    per_chain, launches = {}, {"rbf_gram": 0, "block_chol": 0, "block_chol_inv": 0}
    finals = {}
    for C in HMC_CHAINS:
        hmc.sample(num_samples=HMC_SAMPLES, num_chains=C, seed=0)  # warm
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = hmc.sample(num_samples=HMC_SAMPLES, num_chains=C, seed=3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = counters()
        for k in launches:
            launches[k] += c[k]
        check(np.isfinite(s).all() and s.shape == ((HMC_SAMPLES, 3) if C == 1
                                                   else (C, HMC_SAMPLES, 3)),
              f"hmc C={C}: samples not finite or of the wrong shape")
        if C == 1:
            check(c["block_chol"] == 0, f"hmc C=1: {c['block_chol']} block_chol launches")
            probes = 0
        else:
            nb = block_columns()
            extra = c["block_chol"] - nb * evals
            check(extra >= 0 and extra % nb == 0,
                  f"hmc C={C}: {c['block_chol']} block_chol launches for {evals} evaluations")
            probes = extra // nb
        check(c["rbf_gram"] == C * evals, f"hmc C={C}: {c['rbf_gram']} rbf_gram launches")
        check(c["block_chol_inv"] == 0, f"hmc C={C}: B4 launched on the main path")
        per_chain[str(C)] = {"samples_per_s": HMC_SAMPLES * C / dt, "seconds": dt,
                             "accept_rate": hmc._accept_rate, "evaluations": evals,
                             "launches": c, "ladder_factorizations": probes}
        finals[C] = s[-1] if C == 1 else s[:, -1]

    # logp and gradient at the 16 chains' final states
    m64 = hmc_model(X, Y, torch.float64)
    h64 = mcmc.HMC(m64, stepsize=HMC_STEP, num_leapfrog=HMC_LEAPFROG)
    rel = logp_rel_errors(hmc, h64, raw_from_constrained(m, finals[16]))

    # HMC_shortcut at 8 chains, from the L-BFGS-B optimum (as the reference's
    # test starts it): far from it, at the model's initial point, every
    # trajectory's energy moves by more than the shortcut's 3 units and is
    # cut, which is the reference's rule and leaves nothing accepted
    mo = hmc_model(X, Y, torch.float32)
    mo.optimize()
    hs = mcmc.HMC_shortcut(mo, stepsize=HMC_STEP, num_leapfrog=HMC_LEAPFROG)
    reset_counters()
    t0 = time.perf_counter()
    ss = hs.sample(num_samples=10, num_chains=8, seed=5)
    short = {"C": 8, "num_samples": 10, "seconds": time.perf_counter() - t0,
             "accept_rate": hs._accept_rate, "launches": counters()}
    check(np.isfinite(ss).all() and ss.shape == (8, 10, 3), "hmc_shortcut: bad samples")
    check(hs._accept_rate > 0.5, f"hmc_shortcut: acceptance {hs._accept_rate} at the optimum")
    check(short["launches"]["block_chol"] >= block_columns() * 10 * (1 + HMC_LEAPFROG),
          "hmc_shortcut: fewer block_chol launches than evaluations x block columns")
    del m64, h64, mo, hs
    torch.cuda.empty_cache()
    rec = {"phase": "hmc", "N": HMC_N, "D": HMC_D, "dtype": "float32",
           "num_samples": HMC_SAMPLES, "num_leapfrog": HMC_LEAPFROG, "stepsize": HMC_STEP,
           "by_chains": per_chain, "launches": launches,
           "final_state_rel": rel, "limits": HMC_REL_TOL, "hmc_shortcut": short}
    emit(rec)  # before the limits below, so that a failing run still shows its readings
    for k, tol in HMC_REL_TOL.items():
        check(rel[k] <= tol, f"hmc: logp/gradient at the final states: {k} {rel[k]} > {tol}")
    return hmc, rec


def run_restarts(X, Y):
    """optimize_restarts(parallel=True) at C = 16 on the HMC model; the kept
    objective against the L-BFGS-B optimum + 2 (tests/test_module.py:143-157)."""
    import torch

    m = hmc_model(X, Y, torch.float32)
    reset_counters()
    t0 = time.perf_counter()
    res = m.optimize_restarts(parallel=True, num_restarts=HMC_RESTARTS, max_iters=100,
                              step_size=0.03, seed=0, verbose=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = counters()
    kept = float(m.objective_function().detach())
    m2 = hmc_model(X, Y, torch.float32)
    m2.optimize()
    opt = float(m2.objective_function().detach())
    evals, nb = 100 + 1, block_columns()  # the Adam steps and the end objectives
    extra = launched["block_chol"] - nb * evals
    check(extra >= 0 and extra % nb == 0,
          f"restarts: {launched['block_chol']} block_chol launches for {evals} evaluations")
    check(kept <= opt + 2.0, f"restarts: kept objective {kept} > L-BFGS-B {opt} + 2")
    return {"phase": "restarts", "num_restarts": HMC_RESTARTS, "max_iters": 100,
            "step_size": 0.03, "seconds": dt, "launches": launched, "evaluations": evals,
            "ladder_factorizations": extra // nb,
            "objectives": [r.f_opt for r in res], "kept": kept, "lbfgsb_optimum": opt}


def chol_bound(C, n, dtype_name, outputs):
    """Least time on the card: A's lower triangle (all the kernels read)
    read and `outputs` (n, n) results written once over the memory rate, or
    C n^3/3 operations per output (the factor's n^3/6 multiply-adds; the
    triangular inverse's as many, as LAPACK counts potrf and trtri) over
    the peak rate."""
    isz = 4 if dtype_name == "float32" else 8
    t_bytes = isz * C * (n * (n + 1) // 2 + outputs * n * n) / PEAK_BYTES_S
    t_ops = outputs * C * n ** 3 / 3 / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_block_chol(bc, C, dtype):
    """B2/B3 at (C, 128, 128): the profiler's device time per launch
    (`ms`) beside the event time of back-to-back calls, and the same two
    clocks for batched torch.linalg.cholesky on the same inputs."""
    import torch

    name = str(dtype).replace("torch.", "")
    A = chol_inputs(C, CHOL_BLOCK, dtype, seed=5 + C)
    bound, by = chol_bound(C, CHOL_BLOCK, name, 1)
    ms, lib_ms, lib_kernels, recorded = device_ms(lambda: bc.block_chol_cuda(A),
                                                  lambda: torch.linalg.cholesky(A))
    return {"C": C, "n": CHOL_BLOCK, "dtype": name, "ms": ms,
            "event_ms": cuda_ms(lambda: bc.block_chol_cuda(A), reps=50),
            "plain_ms": cuda_ms(lambda: bc.block_chol_plain(A), reps=3, warmup=1),
            "library_ms": lib_ms, "library_kernels_per_call": lib_kernels,
            "library_event_ms": cuda_ms(lambda: torch.linalg.cholesky(A), reps=50),
            "profiled_calls": recorded,
            "library": "torch.linalg.cholesky (batched)", "bound_ms": bound, "bound_by": by}


def chol_inv_library(A):
    """(L, L^-1) by two PyTorch calls: B4's yardstick, never called by the port."""
    import torch

    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


B4_KERNEL = "block_chol_inv_kernel<"


def time_block_chol_inv(bc, C, dtype):
    """B4 at (C, 128, 128): the profiler's device time per launch (`ms`)
    beside the event time, and the same two clocks for `chol_inv_library`
    on the same inputs."""
    name = str(dtype).replace("torch.", "")
    A = chol_inputs(C, CHOL_BLOCK, dtype, seed=5 + C)
    bound, by = chol_bound(C, CHOL_BLOCK, name, 2)
    ms, lib_ms, lib_kernels, recorded = device_ms(lambda: bc.block_chol_inv_cuda(A),
                                                  lambda: chol_inv_library(A), kernel=B4_KERNEL)
    return {"C": C, "n": CHOL_BLOCK, "dtype": name, "ms": ms,
            "event_ms": cuda_ms(lambda: bc.block_chol_inv_cuda(A), reps=50),
            "plain_ms": cuda_ms(lambda: bc.block_chol_inv_plain(A), reps=3, warmup=1),
            "library_ms": lib_ms, "library_kernels_per_call": lib_kernels,
            "library_event_ms": cuda_ms(lambda: chol_inv_library(A), reps=50),
            "profiled_calls": recorded,
            "library": "torch.linalg.cholesky + torch.linalg.solve_triangular (two calls)",
            "bound_ms": bound, "bound_by": by}


def time_blocked(fn, K, kernel, per_call):
    """One blocked factorization fn(K), which launches `per_call` kernels
    named `kernel`: device time per call (`device_ms`, every kernel
    summed), device kernels per call, and the wall time of a call ending in
    a synchronize."""
    ms, rest_ms, rest_kernels, calls = device_ms(lambda: fn(K), reps=10, warmup=2,
                                                 kernel=kernel, per_call=per_call)
    return {"device_ms": ms + rest_ms, "device_kernels_per_call": per_call + rest_kernels,
            "profiled_calls": calls, "wall_ms": host_ms(lambda: fn(K), reps=5, warmup=1)}


def time_blocked_library(bc, K):
    """`time_blocked` for `chol_inv_library(K)`, which launches none of the
    port's kernels: a B2 launch on one (128, 128) block before each call
    counts the calls, and its own time is left out."""
    marker = chol_inputs(1, CHOL_BLOCK, K.dtype, seed=4)
    _, ms, kernels, calls = device_ms(lambda: bc.block_chol_cuda(marker),
                                      lambda: chol_inv_library(K), reps=10, warmup=2)
    return {"device_ms": ms, "device_kernels_per_call": kernels, "profiled_calls": calls,
            "wall_ms": host_ms(lambda: chol_inv_library(K), reps=5, warmup=1)}


def blocked_times(bc, m, C):
    """The three blocked routines and the library on one (C, 1000, 1000)
    float32 batch of the HMC model's Grams: device and wall time per call,
    and the launches of B2 and B4 in one call."""
    K = batch_grams(m, C, seed=21 + C)
    out = {"C": C, "n": HMC_N, "dtype": "float32"}
    for name, fn, kernel in (
            ("v1", lambda k: bc.batched_chol_inv(k, version=1), B4_KERNEL),
            ("v2", lambda k: bc.batched_chol_inv(k, version=2), "block_chol_kernel<"),
            ("ll", bc.batched_chol_inv_ll, "block_chol_kernel<")):
        reset_counters()
        fn(K)
        launched = counters()
        out[name] = {**time_blocked(fn, K, kernel, per_call=block_columns()),
                     "launches": {k: launched[k] for k in ("block_chol", "block_chol_inv")}}
    out["library"] = time_blocked_library(bc, K)
    return out


def chol_times(bc, m, smi):
    import torch

    dts = (torch.float32, torch.float64)
    return {"phase": "chol_times", "nvidia_smi": smi,
            "block_chol": [time_block_chol(bc, C, dt) for dt in dts for C in CHOL_TIME_BATCHES],
            "block_chol_inv": [time_block_chol_inv(bc, C, dt) for dt in dts
                               for C in CHOL_TIME_BATCHES],
            "timing": "ms and library_ms: torch.profiler device time per call; "
                      "event_ms and library_event_ms: CUDA events over 50 calls",
            "blocked": [blocked_times(bc, m, C) for C in CHOL_TIME_BATCHES],
            "blocked_timing": "device_ms: torch.profiler device time per call, all kernels; "
                              "wall_ms: host clock to a synchronize, median of 5; "
                              "library: torch.linalg.cholesky + solve_triangular"}


def profile_hmc_eval(hmc, C=8):
    """Device time by kernel and the idle share over one batched
    logp+gradient at C chains (one HMC leapfrog evaluation)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from gpy_tpu_torch.core.model import value_and_grad

    g = torch.Generator(device="cpu").manual_seed(8)
    x0 = hmc.model.get_flat_raw()
    x = x0[None] + 0.05 * torch.randn((C, x0.numel()), generator=g, dtype=x0.dtype).to("cuda")
    value_and_grad(hmc._logp, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value_and_grad(hmc._logp, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    device_ms = sum(r[0] for r in rows)
    host_eval_ms = host_ms(lambda: value_and_grad(hmc._logp, x), reps=5, warmup=1)
    return {"phase": "hmc_profile", "what": f"one batched logp+gradient, C={C}, N={HMC_N} float32",
            "wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms, "kernel_launches": sum(r[2] for r in rows), "eval_ms_unprofiled": host_eval_ms,
            "top": [{"kernel": k[:90], "device_ms": ms, "count": c} for ms, k, c in rows[:15]]}


# --- the SVGP flagship (bench.py:355-394) and the collapsed bound -------------

SVGP_N, SVGP_M, SVGP_D, SVGP_B = 100_000, 512, 8, 4096
SVGP_FIT = {"batchsize": SVGP_B, "step_size": 1e-2, "natgrad_step_size": 0.1}
SVGP_WARM, SVGP_STEPS, SVGP_REPS, SVGP_PROFILE_STEPS, SVGP_SIDE_STEPS = 100, 500, 3, 20, 20
SVGP_PRED, SPARSE_N, SPARSE_PRED = 2048, 50_000, 2048
# the SVGP after the warm-up fit, float32 against a float64 twin at the same
# raw parameters and minibatch: the objective relative, each leaf's gradient
# as max|diff| / max|ref|. "elbo" is the model's ELBO (q(u) by its flat
# Cholesky), "natgrad" the natural-gradient step's objective (q(u) by S).
# ~10x the first readings on an H100 (value 1.8e-6; Z, q_u_mean and q(u)'s
# factor 1.5-1.9e-3, S 2.1e-4; the hyperparameters 1.2e-6-1.9e-5); every
# float32 matmul in TF32 read 3.4e-3 and 0.03-0.85, Kmn in bfloat16 more
SVGP_F32_TOL = {
    "elbo": {"value": 1.8e-5, "Z": 1.5e-2, "q_u_mean": 1.9e-2, "q_u_chol": 1.5e-2,
             "kern.variance": 1.2e-5, "kern.lengthscale": 1.5e-4, "likelihood.variance": 2e-5},
    "natgrad": {"value": 1.8e-5, "Z": 1.5e-2, "q_u_mean": 1.9e-2, "S": 2.1e-3,
                "kern.variance": 2.6e-5, "kern.lengthscale": 1.9e-4, "likelihood.variance": 1.9e-5},
}
# the collapsed-bound oracles of tests/test_svgp.py:70-86 and :198-215
COLLAPSED_TOL = {"one_natgrad_step": 1e-4, "ill_conditioned_M20": 1e-5}


def svgp_data(N=SVGP_N, seed=0):
    """bench.py:357-361: X ~ U[0,4)^8, Y = sin(x_1) + 0.1 eps, Z = M rows of
    X by a permutation, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.random((N, SVGP_D)).astype(np.float32) * 4.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))).astype(np.float32)
    Z = X[rng.permutation(N)[:SVGP_M]].copy()
    return X, Y, Z


def svgp_model(X, Y, Z, dtype, D=SVGP_D, noise=0.1):
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Gaussian
    from gpy_tpu_torch.models import SVGP

    return SVGP(X, Y, Z, RBF(D, ARD=True, device="cuda", dtype=dtype),
                Gaussian(variance=noise, device="cuda", dtype=dtype), device="cuda", dtype=dtype)


def timed_fit(m, iters, **kw):
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = m.fit(iters=iters, **dict(SVGP_FIT, **kw))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(tr.shape == (iters,) and np.isfinite(tr).all(), f"svgp fit {kw}: non-finite ELBO trace")
    return tr, dt


def host_syncs(fn) -> list:
    """The synchronizing CUDA operations in one call of fn, by torch's sync
    debug mode: one "file:line" of the call that synchronized each."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def with_host_syncs(rec, m):
    """rec with the synchronizing CUDA operations of one NLML+gradient of m
    at its parameters: their count and their sites."""
    x = m.optimizer_array
    syncs = host_syncs(lambda: m._objective_and_grad(x))
    rec.update({"host_syncs_per_evaluation": len(syncs), "host_sync_sites": sorted(set(syncs))})
    return rec


def fit_host_syncs(m, iters):
    """Synchronizing CUDA operations in one fit(iters=...). A count that does
    not grow from 5 steps to 10 shows that the step loop reads nothing back
    to the host: the fit's boundaries do (the packing's index copies, the
    trace), and the first call in a process makes one more (an H100 read 6,
    then 5)."""
    return len(host_syncs(lambda: m.fit(iters=iters, **SVGP_FIT)))


def rel_errors(f32, g32, f64, g64):
    import numpy as np

    return abs(f32 - f64) / abs(f64), float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))


def svgp_objective(m, idx, form):
    """The objective on the rows `idx` (the data term scaled to N) and its
    gradient by leaf. form "elbo": the model's ELBO, the leaves its raw
    parameters; "natgrad": the natural-gradient step's objective
    (svgp_elbo_parts_S at S = L L'), the leaves the hyperparameters, Z,
    q_u_mean and S, as `SVGP.fit` differentiates it."""
    import torch
    from gpy_tpu_torch.core.svgp import _logdet_factor, _sym
    from gpy_tpu_torch.inference.svgp import svgp_elbo_parts_S
    from gpy_tpu_torch.util.choleskies import flat_to_triang

    Xb, Yb = m.X[idx], m.Y_normalized[idx]
    scale = m.num_data / len(idx)
    leaves = {p: mod._parameters[n].detach().clone().requires_grad_(True)
              for p, mod, n in m._free_entries()}
    if form == "natgrad":
        L = flat_to_triang(leaves.pop("q_u_chol").detach(), m.num_inducing)
        S = (L @ L.transpose(1, 2)).requires_grad_(True)
        with m.bind_raw_dict(leaves):
            datafit, kl = svgp_elbo_parts_S(m.kern, Xb, m.Z.values, m.likelihood, Yb,
                                            leaves["q_u_mean"], _sym(S), _logdet_factor(L),
                                            None, scale)
        leaves["S"] = S
    else:
        with m.bind_raw_dict(leaves):
            datafit, kl = m._elbo_parts(Xb, Yb, scale)
    val = datafit - kl
    grads = torch.autograd.grad(val, list(leaves.values()))
    return float(val.detach()), {k: g.double().cpu().numpy() for k, g in zip(leaves, grads)}


def leaf_errors(got, ref):
    import numpy as np

    (v, g), (v_ref, g_ref) = got, ref
    out = {"value": abs(v - v_ref) / abs(v_ref)}
    out.update({k: float(np.max(np.abs(g[k] - g_ref[k])) / np.max(np.abs(g_ref[k])))
                for k in g_ref})
    return out


def svgp_f32_vs_f64(m32, X, Y, Z):
    """Both objectives of `svgp_objective` on one fixed minibatch, at the
    float32 model's parameters after the warm-up fit (q(u) away from the
    prior, so both read Kmn, C = Lmm^-1 Kmn and Kmm's factor), against a
    float64 twin at the same raw parameters. Then the float32 model again
    with two lower-precision C paths, which the limits must catch: every
    float32 matmul in TF32, and Kmn rounded to bfloat16 (the cross Gram
    feeds only C)."""
    import numpy as np
    import torch

    idx = torch.as_tensor(np.random.default_rng(1).permutation(SVGP_N)[:SVGP_B], device="cuda")
    m64 = svgp_model(X, Y, Z, torch.float64)
    m64.set_flat_raw(m32.get_flat_raw().double())
    kern_K = m32.kern.K

    def kmn_bf16(X, X2=None):
        K = kern_K(X, X2)
        return K if X2 is None else K.to(torch.bfloat16).to(K.dtype)

    errs, low = {}, {"tf32": {}, "kmn_bf16": {}}
    for form in SVGP_F32_TOL:
        ref = svgp_objective(m64, idx, form)
        errs[form] = leaf_errors(svgp_objective(m32, idx, form), ref)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            low["tf32"][form] = leaf_errors(svgp_objective(m32, idx, form), ref)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        m32.kern.K = kmn_bf16  # the instance attribute shadows the method
        try:
            low["kmn_bf16"][form] = leaf_errors(svgp_objective(m32, idx, form), ref)
        finally:
            del m32.kern.K
    return errs, low


def collapsed_oracles():
    """On the card in float64: one natural-gradient step at lr = 1 and full
    batch lands on the collapsed VarDTC bound (tests/test_svgp.py:70-86);
    400 steps reach it at M=20 with cond(Kmm) ~ 1e16, whitened or not
    (:198-215). Both against the port's own SparseGPRegression."""
    import numpy as np
    import torch
    from gpy_tpu_torch.models import SparseGPRegression

    f64 = torch.float64
    rng = np.random.default_rng(11)
    X = np.linspace(0, 5, 20).reshape(20, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((20, 1))
    Z = X[::3].copy()
    m = svgp_model(X, Y, Z, f64, D=1)
    before = m.log_likelihood().item()
    m.fit(iters=1, batchsize=20, step_size=0.0, natgrad_step_size=1.0, seed=0)
    mid = m.log_likelihood().item()
    m.fit(iters=1, batchsize=20, step_size=0.0, natgrad_step_size=1.0, seed=1)
    after = m.log_likelihood().item()
    sp = SparseGPRegression(X, Y, Z=Z.copy(), noise_var=0.1, device="cuda", dtype=f64)
    collapsed = sp.log_likelihood().item()
    check(mid > before, f"collapsed oracle: one natgrad step did not raise the ELBO ({before} -> {mid})")
    check(abs(after - mid) < 1e-5 * max(1.0, abs(mid)), f"collapsed oracle: a second step moved {mid} -> {after}")
    rec = {"one_natgrad_step": {"elbo": after, "collapsed": collapsed,
                                "abs_err": abs(after - collapsed)}}
    X = np.linspace(0, 5, 120).reshape(120, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((120, 1))
    Z = X[::6].copy()
    sp = SparseGPRegression(X, Y, Z=Z.copy(), device="cuda", dtype=f64)
    sp.likelihood.variance.set_value(0.2)
    collapsed = sp.log_likelihood().item()
    errs = {}
    for whiten in (False, True):
        m = svgp_model(X, Y, Z, f64, D=1, noise=0.2)
        m.fit(iters=400, batchsize=120, step_size=0.0, natgrad_step_size=0.5, whiten=whiten, seed=0)
        errs["whitened" if whiten else "unwhitened"] = abs(m.log_likelihood().item() - collapsed)
    rec["ill_conditioned_M20"] = {"collapsed": collapsed, "abs_err": errs}
    for k, tol in COLLAPSED_TOL.items():
        err = rec[k]["abs_err"]
        worst = max(err.values()) if isinstance(err, dict) else err
        check(worst <= tol, f"collapsed oracle {k}: |ELBO - bound| {worst} > {tol}")
    return rec


def profile_svgp(m, rg, steps=SVGP_PROFILE_STEPS):
    """Device time by operation, device operations a step and the idle share
    over one fit(iters=steps) (its init and write-back included), and B1's
    launches a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    m.fit(iters=steps, **SVGP_FIT)
    torch.cuda.synchronize()
    before = rg.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m.fit(iters=steps, **SVGP_FIT)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    b1 = (rg.launches - before) / steps
    # the optimizer's record_function range is on the device timeline too,
    # spanning kernels that have their own rows: it is left out of the sums
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("Optimizer.")), reverse=True)
    device_ms = sum(r[0] for r in rows)
    check(device_ms > 0, "svgp_profile: the profiler recorded no device time")
    return {"phase": "svgp_profile", "what": f"one fit(iters={steps}) at N={SVGP_N}, M={SVGP_M}, "
            f"B={SVGP_B} float32, init and write-back included",
            "wall_ms_per_step": wall_ms / steps, "device_ms_per_step": device_ms / steps,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "device_ops_per_step": sum(r[2] for r in rows) / steps,
            "rbf_gram_launches_per_step": b1,
            "top": [{"op": k[:90], "device_ms_per_step": ms / steps, "count": c}
                    for ms, k, c in rows[:15]]}


# --- the collapsed sparse GPs at BASELINE config 2's scale ------------------

# SparseGPRegression on svgp_data at N=50,000, M=512, D=8: each collapsed
# method and its B1 launches an evaluation, Kmm and Kmn (K(X, Z) for the
# PEP family), or Kmm and one K(Z, xb) a chunk of 2048 rows
SPARSE_BATCH, SPARSE_OPT_ITERS, MD_OUTPUTS = 2048, 100, 4
SPARSE_B1 = {"vardtc": 2, "fitc": 2, "dtc": 2, "pep": 2,
             "minibatch": 1 + -(-SPARSE_N // SPARSE_BATCH)}
# float32 against a float64 twin at the same raw parameters, the start's
# (NLML relative, gradient as max|diff| / max|ref|): ~10x the readings on an
# H100 (VarDTC 2.1e-7 / 4.9e-7, FITC 2.6e-7 / 1.07e-6, DTC
# 1.23e-5 / 1.59e-5 (its bound, 9156, is the smallest), PEP(0.5) 1.6e-7 /
# 8.1e-7, the minibatch bound 2.5e-9 / 1.6e-7, MD 6.4e-7 / 1.57e-6, RBF +
# Linear + Bias 5.9e-5 / 8.4e-5). The minibatch NLML read within one float32
# rounding of float64 (half an ulp of 218309 is 3.6e-8): its limit is ~15
# ulps, not 10x a reading below float32's resolution
SPARSE_REL_TOL = {
    "vardtc": {"nlml": 2e-6, "grad": 5e-6},
    "fitc": {"nlml": 2.6e-6, "grad": 1.1e-5},
    "dtc": {"nlml": 1.2e-4, "grad": 1.6e-4},
    "pep": {"nlml": 1.6e-6, "grad": 8.1e-6},
    "minibatch": {"nlml": 5e-7, "grad": 1.6e-6},
    "md": {"nlml": 6.4e-6, "grad": 1.6e-5},
    "rbf_linear_bias": {"nlml": 5.9e-4, "grad": 8.4e-4},
}
# identities on the card in float64: PEP(1) is FITC, the minibatch bound is
# VarDTC's (bound, and woodbury vector as max|diff| / max|ref|), a
# heteroscedastic likelihood at equal variances is the Gaussian, and the
# missing-data bound is the sum of the outputs' own (the reference's limit,
# tests/test_svi_multiout.py:203-221). The woodbury vectors read 6.1e-14
# apart on an H100, the limit ~10x; the bounds read equal
SPARSE_EXACT_TOL = {"pep1_vs_fitc": 1e-12, "minibatch_vs_vardtc": 1e-10,
                    "minibatch_vs_vardtc_woodbury_vector": 6e-13,
                    "heteroscedastic_vs_gaussian": 1e-12, "md_vs_sum_of_outputs": 1e-8}


def sparse_model(X, Y, dtype, infer="vardtc", kernel=None, pep_alpha=0.5):
    from gpy_tpu_torch.inference import VarDTC_minibatch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import SparseGPRegression

    if infer == "minibatch":
        infer = VarDTC_minibatch(batchsize=SPARSE_BATCH)
    if kernel is None:
        kernel = RBF(SVGP_D, ARD=True, device="cuda", dtype=dtype)
    return SparseGPRegression(X, Y, kernel=kernel, num_inducing=SVGP_M, noise_var=0.1,
                              infer=infer, pep_alpha=pep_alpha, device="cuda", dtype=dtype)


def bound_at(m, x) -> float:
    import torch

    m.set_flat_raw(x)
    with torch.no_grad():
        return m.log_likelihood().item()


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def one_evaluation(m, m64_fn, what):
    """One float32 NLML+gradient of `m` with the counters set to 0 just
    before it and read just after, its time, its profile, and a float64 twin
    (built by m64_fn) at the same raw parameters, timed too. Returns
    (record, twin)."""
    import numpy as np

    x = m.optimizer_array
    reset_counters()
    f, g = m._objective_and_grad(x)
    launches = counters()
    ms = host_ms(lambda: m._objective_and_grad(x), reps=5, warmup=1)
    prof = profile_objective(m, x, what=f"one objective_and_grad, {what}")
    m64 = m64_fn()
    f64, g64 = m64._objective_and_grad(x)
    ms64 = host_ms(lambda: m64._objective_and_grad(x), reps=3, warmup=1)
    nlml_rel, grad_rel = rel_errors(f, g, f64, g64)
    check(all(math.isfinite(v) for v in (f, f64)) and np.isfinite(g).all()
          and np.isfinite(g64).all(), f"{what}: non-finite NLML or gradient")
    check(all(v == 0 for k, v in launches.items() if k != "rbf_gram"),
          f"{what}: unexpected launches {launches}")
    return {"objective_and_grad_ms": ms, "objective_and_grad_ms_f64": ms64,
            "rbf_gram_launches": launches["rbf_gram"],
            "nlml": f, "nlml_f64": f64, "nlml_rel_f32_vs_f64": nlml_rel,
            "grad_rel_f32_vs_f64": grad_rel, "profile_device_ms": prof["device_ms"],
            "profile_wall_ms": prof["wall_ms"], "device_ops": prof["device_ops"],
            "device_idle_share": prof["device_idle_share"], "top": prof["top"][:6]}, m64


def run_sparse_gp(X, Y):
    """Each collapsed method's NLML+gradient at N=50k float32 (one_evaluation),
    RBF + Linear + Bias under VarDTC, and the float64 identities."""
    import numpy as np
    import torch
    from gpy_tpu_torch.core.sparse_gp import SparseGP
    from gpy_tpu_torch.kern import RBF, Bias, Linear
    from gpy_tpu_torch.likelihoods import HeteroscedasticGaussian
    from gpy_tpu_torch.models.sparse_gp_regression import _default_Z

    f64 = torch.float64
    recs, twins = {}, {}
    for name in SPARSE_B1:
        m = sparse_model(X, Y, torch.float32, name)
        recs[name], m64 = one_evaluation(m, lambda: sparse_model(X, Y, f64, name),
                                         f"sparse_gp {name}, N={SPARSE_N} float32")
        if name in ("vardtc", "minibatch", "fitc"):
            twins[name] = m64
        del m, m64
        torch.cuda.empty_cache()

    def rbf_linear_bias(dtype):
        kw = dict(device="cuda", dtype=dtype)
        return RBF(SVGP_D, ARD=True, **kw) + Linear(SVGP_D, ARD=True, **kw) + Bias(SVGP_D, **kw)

    m = sparse_model(X, Y, torch.float32, kernel=rbf_linear_bias(torch.float32))
    recs["rbf_linear_bias"], m64 = one_evaluation(
        m, lambda: sparse_model(X, Y, f64, kernel=rbf_linear_bias(f64)),
        f"sparse_gp RBF+Linear+Bias (VarDTC), N={SPARSE_N} float32")
    del m, m64

    x = twins["fitc"].optimizer_array
    exact = {"pep1_vs_fitc": rel(bound_at(sparse_model(X, Y, f64, "pep", pep_alpha=1.0), x),
                                 bound_at(twins["fitc"], x))}
    v, mb = twins["vardtc"], twins["minibatch"]  # both at the float32 start's raw values
    exact["minibatch_vs_vardtc"] = rel(bound_at(mb, x), bound_at(v, x))
    wv, wv_mb = v.posterior.woodbury_vector, mb.posterior.woodbury_vector
    exact["minibatch_vs_vardtc_woodbury_vector"] = float((wv_mb - wv).abs().max() / wv.abs().max())
    del twins, v, mb
    # both fresh, at the same float64 initial values
    md = {"output_index": np.arange(SPARSE_N).reshape(-1, 1)}
    het = SparseGP(X, Y, _default_Z(X, SVGP_M), RBF(SVGP_D, ARD=True, device="cuda", dtype=f64),
                   HeteroscedasticGaussian(md, variance=0.1, device="cuda", dtype=f64),
                   Y_metadata=md, device="cuda", dtype=f64)
    with torch.no_grad():
        exact["heteroscedastic_vs_gaussian"] = rel(het.log_likelihood().item(),
                                                   sparse_model(X, Y, f64).log_likelihood().item())
    torch.cuda.empty_cache()
    return {"phase": "sparse_gp", "N": SPARSE_N, "M": SVGP_M, "D": SVGP_D, "dtype": "float32",
            "batchsize": SPARSE_BATCH, "pep_alpha": 0.5, "methods": recs,
            "rbf_gram_launches_expected": dict(SPARSE_B1, rbf_linear_bias=2),
            "f32_limits": SPARSE_REL_TOL, "float64_identities": exact,
            "float64_identity_limits": SPARSE_EXACT_TOL}


def counted_evaluations(m):
    """Wraps m._objective_and_grad with an instance attribute that counts
    its calls; returns the list holding the count."""
    evals = [0]
    inner = m._objective_and_grad

    def counted(x):
        evals[0] += 1
        return inner(x)

    m._objective_and_grad = counted
    return evals


def timed_optimize(m, max_iters):
    """m.optimize(max_iters=...) with the evaluations counted (an instance
    attribute shadows _objective_and_grad) and the launch counters set to 0
    just before it and read just after: (result, evaluations, wall seconds,
    launches)."""
    import torch

    evals = counted_evaluations(m)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = m.optimize(max_iters=max_iters)
        torch.cuda.synchronize()
    finally:
        del m._objective_and_grad
    return res, evals[0], time.perf_counter() - t0, counters()


def optimize_run(m, Xs, x0, f64_at):
    """m.optimize(max_iters=100) from the raw vector x0: wall seconds,
    evaluations (counted by an instance attribute that shadows
    _objective_and_grad), ms an evaluation, host syncs of one evaluation
    (torch's sync debug mode), scipy's message, B1 launches with the
    counters set to 0 just before the run and read just after, the NLML at
    the start and the end, the float64 objective at both (f64_at), and
    predict at the held-out Xs before and after, RMSE against sin(x_1),
    the posterior cached and building it."""
    import numpy as np

    truth = np.sin(Xs[:, :1])
    f0, _ = m._objective_and_grad(x0)
    mu0, _ = m.predict(Xs)
    syncs = host_syncs(lambda: m._objective_and_grad(x0))
    res, evals, wall, launches = timed_optimize(m, SPARSE_OPT_ITERS)
    x1 = m.optimizer_array
    f1, g1 = m._objective_and_grad(x1)
    mu1, var1 = m.predict(Xs)

    def predict_cold():
        m._posterior_cache = None
        m.predict(Xs)

    predict_ms = host_ms(lambda: m.predict(Xs), reps=10, warmup=2)
    predict_cold_ms = host_ms(predict_cold, reps=5, warmup=1)
    check(all(v == 0 for k, v in launches.items() if k != "rbf_gram"),
          f"sparse_optimize: unexpected launches {launches}")
    return {
        "dtype": str(m.dtype).replace("torch.", ""), "seconds": wall, "evaluations": evals,
        "iterations": res.n_iters, "ms_per_evaluation": wall / evals * 1e3,
        "host_syncs_per_evaluation": len(syncs), "host_sync_sites": sorted(set(syncs)),
        "scipy_message": res.status, "success": res.success,
        "rbf_gram_launches": launches["rbf_gram"], "nlml_start": f0, "nlml_end": f1,
        "nlml_start_f64": f64_at(x0), "nlml_end_f64": f64_at(x1),
        "kern_variance_end": float(m.kern.variance), "noise_end": float(m.likelihood.variance),
        "lengthscale_end": m.kern.lengthscale.numpy().tolist(),
        "pred_rmse_vs_sin_start": float(np.sqrt(np.mean((mu0 - truth) ** 2))),
        "pred_rmse_vs_sin_end": float(np.sqrt(np.mean((mu1 - truth) ** 2))),
        "predict_ms_posterior_cached": predict_ms, "predict_ms_with_posterior": predict_cold_ms,
        "finite": bool(math.isfinite(f1) and np.isfinite(g1).all() and np.isfinite(mu1).all()
                       and np.isfinite(var1).all() and (var1 > 0).all()),
    }


def run_sparse_optimize(X, Y, Xs):
    """optimize(max_iters=100) of VarDTC and FITC on the card (optimize_run),
    each in float32 and in float64 from the same start, the float32 start's
    raw vector."""
    import torch

    out = {}
    for name in ("vardtc", "fitc"):
        m64 = sparse_model(X, Y, torch.float64, name)

        def f64_at(x):
            return m64._objective_and_grad(x)[0]

        m = sparse_model(X, Y, torch.float32, name)
        x0 = m.optimizer_array
        out[f"{name}_float32"] = optimize_run(m, Xs, x0, f64_at)
        del m
        out[f"{name}_float64"] = optimize_run(sparse_model(X, Y, torch.float64, name), Xs, x0,
                                              f64_at)
        del m64
        torch.cuda.empty_cache()
    return {"phase": "sparse_optimize", "N": SPARSE_N, "M": SVGP_M, "D": SVGP_D,
            "max_iters": SPARSE_OPT_ITERS, "n_pred": len(Xs), "runs": out}


def run_sparse_md(X, Y):
    """SparseGPRegressionMD on the same rows split over 4 outputs by indexD,
    Z shared: one float32 NLML+gradient (one_evaluation), and in float64 its
    bound against the sum of the 4 outputs' own VarDTC bounds."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import SparseGPRegression, SparseGPRegressionMD
    from gpy_tpu_torch.models.sparse_gp_regression import _default_Z

    idx = np.random.default_rng(3).integers(0, MD_OUTPUTS, SPARSE_N)
    Z = _default_Z(X, SVGP_M)

    def md_model(dtype):
        m = SparseGPRegressionMD(X, Y[:, 0], idx, kernel=RBF(SVGP_D, ARD=True, device="cuda",
                                                             dtype=dtype),
                                 Z=Z, device="cuda", dtype=dtype)
        m.likelihood.variance = 0.1
        return m

    rec, m64 = one_evaluation(md_model(torch.float32), lambda: md_model(torch.float64),
                              f"sparse_md, N={SPARSE_N}, {MD_OUTPUTS} outputs float32")
    del m64
    torch.cuda.empty_cache()
    with torch.no_grad():  # both fresh, at the same float64 initial values
        bound = md_model(torch.float64).log_likelihood().item()
        parts = [SparseGPRegression(X[idx == d], Y[idx == d], kernel=RBF(
            SVGP_D, ARD=True, device="cuda", dtype=torch.float64), Z=Z, noise_var=0.1,
            device="cuda", dtype=torch.float64).log_likelihood().item() for d in range(MD_OUTPUTS)]
    rec.update({"phase": "sparse_md", "N": SPARSE_N, "M": SVGP_M, "D": SVGP_D,
                "outputs": MD_OUTPUTS, "rows_per_output": np.bincount(idx).tolist(),
                "dtype": "float32", "bound_f64": bound, "sum_of_output_bounds_f64": sum(parts),
                "md_vs_sum_of_outputs": rel(bound, sum(parts))})
    return rec


def run_sparse(rg, smi):
    """BASELINE config 2 on the card: B1 checked and timed at the collapsed
    family's new shapes, then the sparse_gp, sparse_optimize and sparse_md
    phases. Every record is printed before the limits are applied, so that a
    failing run still shows its readings. Returns B1's launches on these
    paths, its checks and its times."""
    import numpy as np
    import torch

    shapes = ((SPARSE_N, SVGP_M, SVGP_D), (SVGP_M, SPARSE_BATCH, SVGP_D))
    b1_checks = [check_rbf_gram(rg, *s, dt) for s in shapes
                 for dt in (torch.float32, torch.float64)]
    b1_times = [time_rbf_gram(rg, *s) for s in shapes]
    torch.cuda.empty_cache()
    X, Y, _ = svgp_data(N=SPARSE_N)
    Xs = np.random.default_rng(2).random((SPARSE_PRED, SVGP_D)).astype(np.float32) * 4.0
    sp = run_sparse_gp(X, Y)
    sp.update({"rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times, "nvidia_smi": smi})
    emit(sp)
    opt = run_sparse_optimize(X, Y, Xs)
    opt["nvidia_smi"] = smi
    emit(opt)
    md = run_sparse_md(X, Y)
    md["nvidia_smi"] = smi
    emit(md)

    f32 = dict(sp["methods"], md=md)
    for name, tols in SPARSE_REL_TOL.items():
        for k, tol in tols.items():
            v = f32[name][f"{k}_rel_f32_vs_f64"]
            check(v <= tol, f"sparse {name}: float32 vs float64 {k}: rel {v} > {tol}")
    for name, want in dict(SPARSE_B1, rbf_linear_bias=2).items():
        got = sp["methods"][name]["rbf_gram_launches"]
        check(got == want, f"sparse_gp {name}: {got} rbf_gram launches an evaluation, not {want}")
    check(md["rbf_gram_launches"] == 2, f"sparse_md: {md['rbf_gram_launches']} rbf_gram launches")
    identities = dict(sp["float64_identities"], md_vs_sum_of_outputs=md["md_vs_sum_of_outputs"])
    for k, tol in SPARSE_EXACT_TOL.items():
        check(identities[k] <= tol, f"sparse float64 identity {k}: rel {identities[k]} > {tol}")
    for name, r in opt["runs"].items():
        check(r["finite"], f"sparse_optimize {name}: non-finite NLML, gradient or prediction")
        # fallen as float64 evaluates it: at N=50k float32's own value at the
        # end can be far off, where Kmm is too ill-conditioned for float32
        check(r["nlml_end_f64"] < r["nlml_start_f64"] and r["nlml_end"] < r["nlml_start"],
              f"sparse_optimize {name}: the objective did not fall ({r['nlml_start_f64']} -> "
              f"{r['nlml_end_f64']} in float64, {r['nlml_start']} -> {r['nlml_end']})")
        check(r["rbf_gram_launches"] == 2 * r["evaluations"],
              f"sparse_optimize {name}: {r['rbf_gram_launches']} rbf_gram launches in "
              f"{r['evaluations']} evaluations")
        if r["dtype"] == "float64":
            check(r["pred_rmse_vs_sin_end"] < r["pred_rmse_vs_sin_start"],
                  f"sparse_optimize {name}: the fitted model predicts worse than the start")
    launches = sum(r["rbf_gram_launches"] for r in
                   list(sp["methods"].values()) + list(opt["runs"].values()) + [md])
    return {"launches": launches, "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


# --- non-Gaussian inference: GP classification (BASELINE config 3) ----------

# bench.py:656-762: EP and Laplace at N=2048 on the banana set, D=2, RBF,
# float32; EPDTC at N=4096 with M=512 inducing rows by a permutation
CLS_N, CLS_D, EPDTC_N, EPDTC_M = 2048, 2, 4096, 512
CLS_OPT_ITERS, CLS_FIT_ITERS = 20, 100
# bench.py's two-length differencing: epsilon=0 (tol=0) at these two counts
CLS_SWEEPS, CLS_NEWTON = (4, 20), (2, 10)
# float32 against a float64 twin at the same raw parameters, the start's
# (NLML relative, gradient as max|diff| / max|ref|): ~10x the first readings
# on an H100 (EP 2.79e-5 / 1.28e-5, its float32 sites stopping after 31
# sweeps where float64's stop after 24; Laplace 2.9e-7 / 1.14e-4; EPDTC
# 8.1e-7 / 1.64e-4)
CLS_REL_TOL = {
    "ep": {"nlml": 2.8e-4, "grad": 1.3e-4},
    "laplace": {"nlml": 3e-6, "grad": 1.2e-3},
    "epdtc": {"nlml": 8e-6, "grad": 1.7e-3},
}
# EP and Laplace approximate one posterior: at the start's hyperparameters,
# mean |p_EP - p_Laplace| on the held-out draw below the reference's limit
# (tests/test_inference_approx.py:68-71)
CLS_EP_VS_LAPLACE = 0.12
# the float64 fits classify the held-out draw of the banana set (its two
# crescents overlap little)
CLS_F64_ACCURACY = 0.95


def banana(rng, n):
    """bench.py:669-678: two interleaved crescents, float32, Y in {0, 1}."""
    import numpy as np

    th = rng.uniform(0, np.pi, n).astype(np.float32)
    rr = (2.0 + 0.25 * rng.standard_normal(n)).astype(np.float32)
    c = rng.integers(0, 2, n)
    x1 = np.where(c, rr * np.cos(th), 1.0 - rr * np.cos(th))
    x2 = np.where(c, rr * np.sin(th) - 0.5, 0.5 - rr * np.sin(th))
    return np.stack([x1, x2], 1).astype(np.float32), c.reshape(-1, 1).astype(np.float32)


def cls_model(X, Y, dtype, method):
    """GPClassification (EP) or GPClassificationLaplace with bench.py's
    default RBF(2)."""
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPClassification, GPClassificationLaplace

    cls = GPClassification if method == "ep" else GPClassificationLaplace
    return cls(X, Y, kernel=RBF(CLS_D, device="cuda", dtype=dtype), device="cuda", dtype=dtype)


def epdtc_model(X, Y, Z, dtype):
    from gpy_tpu_torch.core.sparse_gp import SparseGP
    from gpy_tpu_torch.inference import EPDTC
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Bernoulli

    return SparseGP(X, Y, Z, RBF(CLS_D, device="cuda", dtype=dtype),
                    Bernoulli(device="cuda", dtype=dtype), inference_method=EPDTC(),
                    device="cuda", dtype=dtype)


def loop_count(inf):
    """The last evaluation's EP sweeps (EP, EPDTC) or Newton steps (Laplace)."""
    return inf.last_sweeps if hasattr(inf, "last_sweeps") else inf.last_newton_steps


def loop_record(m, m64):
    """The site loop's sweeps or the Newton steps of the last evaluation,
    float32 and its float64 twin, and the last change each read against its
    stopping rule."""
    inf, inf64 = m.inference_method, m64.inference_method
    key = "sweeps" if hasattr(inf, "last_sweeps") else "newton_steps"
    count = loop_count(inf)
    return {key: count, f"{key}_f64": loop_count(inf64), "max_iters": inf.max_iters,
            "last_change": float(inf.last_change), "last_change_f64": float(inf64.last_change),
            "stop_below": getattr(inf, "epsilon", getattr(inf, "tol", None)),
            "ran_to_max_iters": count >= inf.max_iters}


def iteration_ms(m, method):
    """ms a sweep (EP) or a Newton step (Laplace) at the model's K by
    bench.py's two-length differencing (bench.py:700-752): the loop with
    epsilon=0 (tol=0) at two counts, timed, the difference over the
    iterations each ran (a Laplace search may stop early at an exact zero
    change)."""
    import torch
    from gpy_tpu_torch.inference import EP, Laplace

    with torch.no_grad():
        K = m.kern.K(m.X) + 1e-8 * torch.eye(m.num_data, dtype=m.dtype, device=m.device)
    lik, Y = m.likelihood, m.Y
    if method == "ep":
        runs = {k: (lambda k=k: EP(epsilon=0.0, max_iters=k)._converge_sites(K, lik, Y, None)[2])
                for k in CLS_SWEEPS}
    else:
        f0 = torch.zeros_like(Y)
        runs = {k: (lambda k=k: Laplace(tol=0.0, max_iters=k)._find_mode(K, lik, Y, None, f0)[1])
                for k in CLS_NEWTON}
    its = {k: f() for k, f in runs.items()}
    ms = {k: host_ms(f, reps=3, warmup=1) for k, f in runs.items()}
    lo, hi = sorted(runs)
    per = (ms[hi] - ms[lo]) / (its[hi] - its[lo]) if its[hi] > its[lo] else None
    return {"iterations_run": its, "loop_ms": ms, "ms_per_iteration": per}


def cls_optimize(m, Xte, Yte, f64_at):
    """optimize(max_iters=CLS_OPT_ITERS) from the default start: seconds,
    evaluations, B1 launches, the NLML before and after (the model's own,
    and float64's at both raw vectors by f64_at), the loop count and last
    change of the last evaluation, held-out accuracy before and after,
    predict ms. The
    predictions before it are returned too, for the EP-Laplace check."""
    import numpy as np
    from gpy_tpu_torch.core.module import Param

    x0 = m.optimizer_array
    f0, _ = m._objective_and_grad(x0)
    p0 = m.predict(Xte)[0]
    res, evals, wall, launches = timed_optimize(m, CLS_OPT_ITERS)
    x1 = m.optimizer_array
    loops, change = loop_count(m.inference_method), float(m.inference_method.last_change)
    f64_start, f64_end = f64_at(x0), f64_at(x1)
    f1, g1 = m._objective_and_grad(x1)  # f64_at may be the model's own
    p1, var1 = m.predict(Xte)

    def predict_cold():
        m._posterior_cache = None
        m.predict(Xte)

    check(all(v == 0 for k, v in launches.items() if k != "rbf_gram"),
          f"classification optimize: unexpected launches {launches}")
    return {
        "seconds": wall, "evaluations": evals, "iterations": res.n_iters,
        "ms_per_evaluation": wall / evals * 1e3, "scipy_message": res.status,
        "rbf_gram_launches": launches["rbf_gram"], "nlml_start": f0, "nlml_end": f1,
        "nlml_start_f64": f64_start, "nlml_end_f64": f64_end,
        "loop_count_last_evaluation": loops, "last_change_last_evaluation": change,
        "params_end": {p: Param(mod, n).numpy().tolist() for p, mod, n in m.named_params()},
        "heldout_accuracy_start": float(np.mean((p0 > 0.5) == (Yte > 0.5))),
        "heldout_accuracy_end": float(np.mean((p1 > 0.5) == (Yte > 0.5))),
        "predict_ms_posterior_cached": host_ms(lambda: m.predict(Xte), reps=10, warmup=2),
        "predict_ms_with_posterior": host_ms(predict_cold, reps=3, warmup=1),
        "finite": bool(math.isfinite(f1) and np.isfinite(g1).all() and np.isfinite(p1).all()
                       and np.isfinite(var1).all()),
        "p_heldout_start": p0,
    }


def run_classification(X, Y, Xte, Yte):
    """EP (GPClassification) and Laplace (GPClassificationLaplace) at N=2048:
    one float32 NLML+gradient each (one_evaluation) with its host syncs and
    loop count, the cost of a sweep or a Newton step, and an optimize in
    float32 and in its float64 twin from the same start."""
    import numpy as np
    import torch

    recs, p = {}, {}
    for method in ("ep", "laplace"):
        m = cls_model(X, Y, torch.float32, method)
        x = m.optimizer_array
        rec, m64 = one_evaluation(m, lambda: cls_model(X, Y, torch.float64, method),
                                  f"classification {method}, N={CLS_N} float32")
        rec.update(loop_record(m, m64))
        with_host_syncs(rec, m)
        rec.update(iteration_ms(m, method))

        def f64_at(xx):
            return m64._objective_and_grad(xx)[0]

        rec["optimize"] = opt = cls_optimize(m, Xte, Yte, f64_at)
        p[method] = opt.pop("p_heldout_start")
        m64.set_flat_raw(x)
        rec["optimize_f64"] = cls_optimize(m64, Xte, Yte, f64_at)
        rec["optimize_f64"].pop("p_heldout_start")
        recs[method] = rec
        del m, m64
        torch.cuda.empty_cache()
    return {"phase": "classification", "N": CLS_N, "D": CLS_D, "dtype": "float32",
            "kernel": "RBF(2), variance 1, lengthscale 1 at the start", "methods": recs,
            "mean_abs_p_ep_vs_laplace_at_start": float(np.mean(np.abs(p["ep"] - p["laplace"]))),
            "f32_limits": {k: CLS_REL_TOL[k] for k in ("ep", "laplace")}}


def run_sparse_classification(X, Y, Z):
    """EPDTC at N=4096, M=512 (one_evaluation, its sweeps and host syncs),
    then SparseGPClassification (the SVGP bound with Bernoulli's quadrature)
    on the same data and Z: fit(iters=100) with the counters set to 0 just
    before it and read just after, then timed again. In float64: in float32
    its constructor's Cholesky of K(Z) + 1e-6 I, which starts q(u) at the
    prior, fails on these 512 rows of a 2-D set at lengthscale 1 (the
    reference's constructor computes the same)."""
    import numpy as np
    import torch
    from gpy_tpu_torch.models import SparseGPClassification

    m = epdtc_model(X, Y, Z, torch.float32)
    x = m.optimizer_array
    rec, m64 = one_evaluation(m, lambda: epdtc_model(X, Y, Z, torch.float64),
                              f"epdtc, N={EPDTC_N}, M={EPDTC_M} float32")
    rec.update(loop_record(m, m64))
    rec["host_syncs_per_evaluation"] = len(host_syncs(lambda: m._objective_and_grad(x)))
    del m, m64
    torch.cuda.empty_cache()

    sm = SparseGPClassification(X, Y, Z=Z, device="cuda", dtype=torch.float64)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr0 = sm.fit(iters=CLS_FIT_ITERS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr1 = sm.fit(iters=CLS_FIT_ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec.update({"phase": "epdtc", "N": EPDTC_N, "M": EPDTC_M, "D": CLS_D, "dtype": "float32",
                "f32_limits": CLS_REL_TOL["epdtc"], "sparse_gp_classification": {
                    "dtype": "float64", "batchsize": min(256, EPDTC_N), "iters": CLS_FIT_ITERS,
                    "first_fit_seconds": first_s, "steps_per_s": CLS_FIT_ITERS / dt,
                    "ms_per_step": dt / CLS_FIT_ITERS * 1e3, "launches": launches,
                    "elbo_first": float(tr0[0]), "elbo_last": float(tr1[-1]),
                    "finite": bool(np.isfinite(tr0).all() and np.isfinite(tr1).all())}})
    del sm
    torch.cuda.empty_cache()
    return rec


def run_cls(rg, smi):
    """BASELINE config 3 on the card: B1 checked and timed at the
    classification shapes, then the classification and epdtc phases. Every
    record is printed before the limits are applied. Returns B1's launches
    on these paths, its checks and its times."""
    import numpy as np
    import torch

    shapes = ((CLS_N, CLS_N, CLS_D), (EPDTC_M, EPDTC_N, CLS_D))
    b1_checks = [check_rbf_gram(rg, *s, dt) for s in shapes
                 for dt in (torch.float32, torch.float64)]
    b1_times = [time_rbf_gram(rg, *s) for s in shapes]
    rng = np.random.default_rng(0)
    X, Y = banana(rng, CLS_N)
    Xte, Yte = banana(rng, CLS_N)  # a second draw, held out
    X4, Y4 = banana(rng, EPDTC_N)
    Z = X4[rng.permutation(EPDTC_N)[:EPDTC_M]].copy()  # bench.py:757-762

    cls = run_classification(X, Y, Xte, Yte)
    cls.update({"rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times, "nvidia_smi": smi})
    emit(cls)
    sp = run_sparse_classification(X4, Y4, Z)
    sp["nvidia_smi"] = smi
    emit(sp)

    f32 = dict(cls["methods"], epdtc=sp)
    for name, tols in CLS_REL_TOL.items():
        for k, tol in tols.items():
            v = f32[name][f"{k}_rel_f32_vs_f64"]
            check(v <= tol, f"classification {name}: float32 vs float64 {k}: rel {v} > {tol}")
    for name, want in (("ep", 1), ("laplace", 1), ("epdtc", 2)):
        got = f32[name]["rbf_gram_launches"]
        check(got == want, f"classification {name}: {got} rbf_gram launches an evaluation, "
                           f"not {want}")
    for name, r in cls["methods"].items():
        for run in ("optimize", "optimize_f64"):
            o = r[run]
            what = f"classification {name} {run}"
            check(o["finite"], f"{what}: non-finite NLML, gradient or prediction")
            check(o["nlml_end_f64"] < o["nlml_start_f64"],
                  f"{what}: the NLML did not fall as float64 evaluates it "
                  f"({o['nlml_start_f64']} -> {o['nlml_end_f64']})")
            check(o["rbf_gram_launches"] == o["evaluations"],
                  f"{what}: {o['rbf_gram_launches']} rbf_gram launches in "
                  f"{o['evaluations']} evaluations")
        acc = r["optimize_f64"]["heldout_accuracy_end"]
        check(acc > CLS_F64_ACCURACY, f"classification {name}: the float64 fit's held-out "
                                      f"accuracy {acc} <= {CLS_F64_ACCURACY}")
    d = cls["mean_abs_p_ep_vs_laplace_at_start"]
    check(d < CLS_EP_VS_LAPLACE, f"classification: mean |p_EP - p_Laplace| {d} >= "
                                 f"{CLS_EP_VS_LAPLACE}")
    s = sp["sparse_gp_classification"]
    check(s["finite"] and s["elbo_last"] > s["elbo_first"],
          f"sparse_gp_classification: the ELBO did not rise ({s['elbo_first']} -> "
          f"{s['elbo_last']})")
    check(s["launches"]["rbf_gram"] == 2 * CLS_FIT_ITERS
          and all(v == 0 for k, v in s["launches"].items() if k != "rbf_gram"),
          f"sparse_gp_classification: launches {s['launches']} in {CLS_FIT_ITERS} steps, "
          "not 2 rbf_gram a step")
    launches = (sum(r["rbf_gram_launches"] + r["optimize"]["rbf_gram_launches"]
                    + r["optimize_f64"]["rbf_gram_launches"] for r in cls["methods"].values())
                + sp["rbf_gram_launches"] + s["launches"]["rbf_gram"])
    return {"launches": launches, "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


# --- multi-output GPs (BASELINE config 4, second half) ----------------------

# bench.py:645-654: GPCoregionalizedRegression over 4 outputs x 1000 points,
# D=1, x ~ 10 U[0,1) sorted, y = sin(x + i) + 0.1 eps, the default
# ICM(RBF(1)) of rank 1 (W drawn from numpy's global generator, seeded) and
# 4 Gaussian noises; the sparse form with 200 inducing rows (the
# reference's permutation); GPOffsetRegression on outputs 0 and 1 as two
# clusters. bench.py:821-830: MultioutputGP over 512 f + 512 f' on [0, 4]
COREG_P, COREG_N, COREG_M, COREG_SEED, COREG_OPT_ITERS = 4, 1000, 200, 0, 20
COREG_ORACLE_ROWS = 100
MO_N, MO_PRED = 512, 256
# float32 against a float64 twin at the same raw parameters, the start's
# (NLML relative, gradient as max|diff| / max|ref|): ~10x the first
# readings on an H100 (GPCR 2.6e-7 / 2.7e-6; the sparse form 1.3e-4 / 3.9e-2,
# its 200 x 200 Kmm of 1-D rows factoring in float32 only after jitchol's
# ladder; offset 1.0e-6 / 1.2e-5; MultioutputGP 2.2e-6 / 2.8e-5; under EP
# 1.05e-3 / 7.9e-4, its float32 sites running to max_iters=60 where
# float64's stop after 16)
COREG_REL_TOL = {
    "gpcr": {"nlml": 2.6e-6, "grad": 2.7e-5},
    "sparse_gpcr": {"nlml": 1.3e-3, "grad": 0.39},
    "offset": {"nlml": 1e-5, "grad": 1.2e-4},
    "multioutput": {"nlml": 2.2e-5, "grad": 2.8e-4},
    "multioutput_ep": {"nlml": 1.1e-2, "grad": 7.9e-3},
}
# B1 launches an NLML+gradient: the f-f block is the only Gram kernel call
# of an ICM or a MultioutputGP K; Kmm and Kmn; one Gram per kernel of the
# [Gaussian, Bernoulli] model (independent outputs)
COREG_B1 = {"gpcr": 1, "sparse_gpcr": 2, "offset": 1, "multioutput": 1, "multioutput_ep": 2}
# float64 identities on the card: ICM with W = 0 is 4 independent GPs; the
# derivative blocks are RBF's closed forms (max|diff| / max|ref|); with Z = X
# on the first 100 rows of each output the sparse bound is the dense log
# marginal but for Kmm's jitter (it read 6.7e-9 apart on an H100)
COREG_EXACT_TOL = {"icm_w0_vs_independent": 1e-10, "cov_f_df": 1e-10, "cov_df_df": 1e-10,
                   "sparse_z_eq_x_rel": 1e-8}
# the reference's limits: the zoo's coregionalized fit (tests/test_models_
# zoo.py:73) and the fit of f and f' (tests/test_multioutput_missing.py:58-61)
COREG_F64_RMSE, MO_F64_RMSE = 0.5, {"f": 0.05, "df": 0.1}


def coreg_data(seed=COREG_SEED):
    """bench.py:648-651, float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    Xl = [np.sort(rng.random((COREG_N, 1)).astype(np.float32) * 10, 0) for _ in range(COREG_P)]
    Yl = [np.sin(Xc + i) + 0.1 * rng.standard_normal(Xc.shape).astype(np.float32)
          for i, Xc in enumerate(Xl)]
    return Xl, Yl


def coreg_model(Xl, Yl, dtype, sparse=False, **kw):
    """GPCoregionalizedRegression (or the sparse form) with numpy's global
    generator seeded first, so every twin draws the same default W."""
    import numpy as np
    from gpy_tpu_torch.models import GPCoregionalizedRegression, SparseGPCoregionalizedRegression

    np.random.seed(COREG_SEED)
    if sparse:
        return SparseGPCoregionalizedRegression(Xl, Yl, num_inducing=COREG_M, device="cuda",
                                                dtype=dtype, **kw)
    return GPCoregionalizedRegression(Xl, Yl, device="cuda", dtype=dtype, **kw)


def offset_model(Xl, Yl, dtype):
    """GPOffsetRegression on outputs 0 and 1 as clusters 0 and 1."""
    import numpy as np
    from gpy_tpu_torch.models import GPOffsetRegression

    X = np.vstack([np.hstack([Xl[c], np.full_like(Xl[c], c)]) for c in (0, 1)])
    return GPOffsetRegression(X, np.vstack(Yl[:2]), device="cuda", dtype=dtype)


def fit_run(m, f64_at, predict_rmse):
    """optimize(max_iters=COREG_OPT_ITERS) from the model's start: seconds, evaluations,
    B1 launches (counters set to 0 just before and read just after), the
    NLML before and after (the model's own and float64's by f64_at) and
    predict_rmse(m) -> ({name: RMSE}, predict ms) before and after."""
    import numpy as np

    x0 = m.optimizer_array
    f0, _ = m._objective_and_grad(x0)
    rmse0, _ = predict_rmse(m)
    res, evals, wall, launches = timed_optimize(m, COREG_OPT_ITERS)
    x1 = m.optimizer_array
    f64_start, f64_end = f64_at(x0), f64_at(x1)
    f1, g1 = m._objective_and_grad(x1)  # f64_at may be the model's own
    rmse1, predict_ms = predict_rmse(m)
    check(all(v == 0 for k, v in launches.items() if k != "rbf_gram"),
          f"multi-output optimize: unexpected launches {launches}")
    return {"dtype": str(m.dtype).replace("torch.", ""), "seconds": wall, "evaluations": evals,
            "iterations": res.n_iters, "ms_per_evaluation": wall / evals * 1e3,
            "scipy_message": res.status, "rbf_gram_launches": launches["rbf_gram"],
            "nlml_start": f0, "nlml_end": f1, "nlml_start_f64": f64_start,
            "nlml_end_f64": f64_end, "pred_rmse_start": rmse0, "pred_rmse_end": rmse1,
            "predict_ms_posterior_cached": predict_ms,
            "finite": bool(math.isfinite(f1) and np.isfinite(g1).all()
                           and all(math.isfinite(v) for v in rmse1.values()))}


def coreg_rmse(Xte):
    """predict_rmse for a coregionalized model: 1000 new points of each
    output, one predict call per output with its Y_metadata, RMSE against
    sin(x + i); predict ms of one call (posterior cached)."""
    import numpy as np

    def run(m):
        out = {}
        for i, xs in enumerate(Xte):
            Xs = np.hstack([xs, np.full_like(xs, i)])
            md = {"output_index": np.full((len(xs), 1), i)}
            mu, var = m.predict(Xs, Y_metadata=md)
            ok = np.isfinite(mu).all() and np.isfinite(var).all() and (var > 0).all()
            out[f"output{i}"] = float(np.sqrt(np.mean((mu - np.sin(xs + i)) ** 2))) if ok \
                else math.nan
        Xs0 = np.hstack([Xte[0], np.zeros_like(Xte[0])])
        md0 = {"output_index": np.zeros((len(Xte[0]), 1), dtype=int)}
        return out, host_ms(lambda: m.predict(Xs0, Y_metadata=md0), reps=10, warmup=2)
    return run


def run_coreg(Xl, Yl):
    """GPCoregionalizedRegression at bench.py's N=4 x 1000: one float32
    NLML+gradient (one_evaluation) with its host syncs, optimize in float32
    and in its float64 twin from one start, predict; the sparse form and
    GPOffsetRegression one NLML+gradient each; the float64 oracles."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Gaussian
    from gpy_tpu_torch.models import GPRegression
    from gpy_tpu_torch.util.multioutput import ICM

    f64 = torch.float64
    rng = np.random.default_rng(COREG_SEED + 1)
    Xte = [np.sort(rng.random((COREG_N, 1)).astype(np.float32) * 10, 0) for _ in range(COREG_P)]
    recs = {}
    m = coreg_model(Xl, Yl, torch.float32)
    rec, m64 = one_evaluation(m, lambda: coreg_model(Xl, Yl, f64),
                              f"coreg gpcr, N={COREG_P}x{COREG_N} float32")
    recs["gpcr"] = with_host_syncs(rec, m)
    x = m.optimizer_array

    def f64_at(xx):
        return m64._objective_and_grad(xx)[0]

    rec["optimize"] = fit_run(m, f64_at, coreg_rmse(Xte))
    m64.set_flat_raw(x)
    rec["optimize_f64"] = fit_run(m64, f64_at, coreg_rmse(Xte))
    del m, m64
    torch.cuda.empty_cache()

    m = coreg_model(Xl, Yl, torch.float32, sparse=True)
    rec, _ = one_evaluation(m, lambda: coreg_model(Xl, Yl, f64, sparse=True),
                            f"coreg sparse_gpcr, N={COREG_P}x{COREG_N}, M={COREG_M} float32")
    recs["sparse_gpcr"] = with_host_syncs(rec, m)
    m = offset_model(Xl, Yl, torch.float32)
    rec, _ = one_evaluation(m, lambda: offset_model(Xl, Yl, f64),
                            f"coreg offset, N=2x{COREG_N} float32")
    recs["offset"] = with_host_syncs(rec, m)
    del m
    torch.cuda.empty_cache()

    # float64 oracles: with Z = X (the first rows of each output) the
    # collapsed bound lies below the exact log marginal by Kmm's jitter only
    Xs_, Ys_ = [X[:COREG_ORACLE_ROWS] for X in Xl], [Y[:COREG_ORACLE_ROWS] for Y in Yl]
    dense = coreg_model(Xs_, Ys_, f64)
    sparse = coreg_model(Xs_, Ys_, f64, sparse=True, Z_list=Xs_)
    with torch.no_grad():
        ll_dense, ll_sparse = dense.log_likelihood().item(), sparse.log_likelihood().item()
    noise = [float(lik.variance) for lik in dense.likelihood.likelihoods_list]
    exact = {"sparse_z_eq_x_gap": ll_dense - ll_sparse,
             "sparse_z_eq_x_gap_bound": jitter_gap_bound(np.vstack(Ys_), noise),
             "sparse_z_eq_x_rel": rel(ll_sparse, ll_dense)}
    # W = 0: B = diag(kappa), so the outputs are independent GPs with RBF
    # variance v * kappa_i and their own noise
    kappa, noises, v, ls = [0.5, 0.8, 1.1, 1.4], [0.01, 0.02, 0.04, 0.08], 1.3, 0.8
    kern = ICM(1, COREG_P, RBF(1, variance=v, lengthscale=ls, device="cuda", dtype=f64),
               W=np.zeros((COREG_P, 1)), kappa=kappa)
    liks = [Gaussian(variance=s, device="cuda", dtype=f64) for s in noises]
    icm = coreg_model(Xl, Yl, f64, kernel=kern, likelihoods_list=liks)
    with torch.no_grad():
        ll_icm = icm.log_likelihood().item()
        ll_sum = sum(GPRegression(X, Y, RBF(1, variance=v * k, lengthscale=ls, device="cuda",
                                            dtype=f64), noise_var=s, device="cuda",
                                  dtype=f64).log_likelihood().item()
                     for X, Y, k, s in zip(Xl, Yl, kappa, noises))
    exact["icm_w0_vs_independent"] = rel(ll_icm, ll_sum)
    del dense, sparse, icm
    torch.cuda.empty_cache()
    return {"phase": "coreg", "outputs": COREG_P, "N_per_output": COREG_N, "M": COREG_M,
            "dtype": "float32", "kernel": "ICM(RBF(1)), W_rank=1, default start",
            "models": recs, "f32_limits": {k: COREG_REL_TOL[k] for k in recs},
            "rbf_gram_launches_expected": {k: COREG_B1[k] for k in recs},
            "float64_identities": exact}


def mo_model(dtype, likelihoods=("gaussian", "gaussian")):
    """bench.py:821-830: MultioutputGP over 512 points of f = sin and 512 of
    f' = cos on [0, 4], [RBF(1), DiffKern(RBF, 0)] sharing one base,
    Gaussian(1e-2) twice; or [Gaussian(0.1), Bernoulli()] over f and the
    classes of sin(2x) + 0.3 eps, one RBF(1) each (EP)."""
    import numpy as np
    from gpy_tpu_torch.kern import RBF, DiffKern
    from gpy_tpu_torch.likelihoods import Bernoulli, Gaussian
    from gpy_tpu_torch.models import MultioutputGP

    kw = {"device": "cuda", "dtype": dtype}
    X = np.linspace(0, 4, MO_N).reshape(-1, 1).astype(np.float32)
    if likelihoods == ("gaussian", "gaussian"):
        base = RBF(1, **kw)
        return MultioutputGP([X, X], [np.sin(X), np.cos(X)], [base, DiffKern(base, 0, **kw)],
                             [Gaussian(variance=1e-2, **kw), Gaussian(variance=1e-2, **kw)], **kw)
    rng = np.random.default_rng(3)
    Y0 = np.sin(X) + 0.1 * rng.standard_normal(X.shape).astype(np.float32)
    Y1 = (np.sin(2 * X) + 0.3 * rng.standard_normal(X.shape) > 0).astype(np.float32)
    return MultioutputGP([X, X], [Y0, Y1], [RBF(1, **kw), RBF(1, **kw)],
                         [Gaussian(variance=0.1, **kw), Bernoulli(**kw)], **kw)


def mo_rmse(m):
    """predict_rmse for the derivative model: f and f' at 256 new points,
    RMSE against sin and cos; predict ms of one call (posterior cached)."""
    import numpy as np
    from gpy_tpu_torch.util.multioutput import build_XY

    xs = np.linspace(0.05, 3.95, MO_PRED).reshape(-1, 1)
    out = {}
    for name, j, truth in (("f", 0, np.sin(xs)), ("df", 1, np.cos(xs))):
        mu, var = m.predict(build_XY([xs], index=[j])[0])
        ok = np.isfinite(mu).all() and np.isfinite(var).all() and (var > 0).all()
        out[name] = float(np.sqrt(np.mean((mu - truth) ** 2))) if ok else math.nan
    Xs = build_XY([xs], index=[0])[0]
    return out, host_ms(lambda: m.predict(Xs), reps=10, warmup=2)


def run_multioutput():
    """MultioutputGP at bench.py's 512 f + 512 f': one float32 NLML+gradient
    (one_evaluation) with its host syncs, optimize in float32 and its
    float64 twin from one start, predict of f and f'; the derivative blocks
    in float64 against RBF's closed forms; the [Gaussian, Bernoulli] model
    under EP, one NLML+gradient with its sweeps."""
    import torch

    f64 = torch.float64
    m = mo_model(torch.float32)
    rec, m64 = one_evaluation(m, lambda: mo_model(f64),
                              f"multioutput, {MO_N} f + {MO_N} f' float32")
    recs = {"multioutput": with_host_syncs(rec, m)}
    x = m.optimizer_array

    def f64_at(xx):
        return m64._objective_and_grad(xx)[0]

    rec["optimize"] = fit_run(m, f64_at, mo_rmse)
    m64.set_flat_raw(x)
    rec["optimize_f64"] = fit_run(m64, f64_at, mo_rmse)

    # the derivative blocks at the float64 fit's parameters against RBF's
    # closed forms: cov(f(x), f'(x')) = dk/dx' = (v / l^2) d exp(-d^2 / 2l^2)
    # and cov(f', f'') = (v / l^2)(1 - d^2 / l^2) exp(-d^2 / 2l^2), d = x - x'
    with torch.no_grad():
        K = m64.kern.K(m64.X)
        base = m64.kern.parts[0]
        v, ls = float(base.variance), float(base.lengthscale)
        x = m64.X[:MO_N, 0]
        d = x[:, None] - x[None, :]
        e = v * torch.exp(-0.5 * d**2 / ls**2)
        closed = {"cov_f_df": (K[:MO_N, MO_N:], e * d / ls**2),
                  "cov_df_df": (K[MO_N:, MO_N:], e / ls**2 * (1 - d**2 / ls**2))}
    exact = {k: float((a - b).abs().max() / b.abs().max()) for k, (a, b) in closed.items()}
    del m, m64, K
    torch.cuda.empty_cache()

    m = mo_model(torch.float32, ("gaussian", "bernoulli"))
    rec, m64 = one_evaluation(m, lambda: mo_model(f64, ("gaussian", "bernoulli")),
                              f"multioutput EP, {MO_N} + {MO_N} float32")
    rec.update(loop_record(m, m64))
    recs["multioutput_ep"] = with_host_syncs(rec, m)
    del m, m64
    torch.cuda.empty_cache()
    return {"phase": "multioutput", "N": 2 * MO_N, "dtype": "float32",
            "kernel": "[RBF(1), DiffKern(RBF, 0)], one base; EP: [RBF(1), RBF(1)]",
            "models": recs, "f32_limits": {k: COREG_REL_TOL[k] for k in recs},
            "rbf_gram_launches_expected": {k: COREG_B1[k] for k in recs},
            "float64_identities": exact}


def jitter_gap_bound(Y, noise):
    """How far the collapsed bound with Z = X may lie below the exact log
    marginal: VarDTC factors Kmm + 1e-6 I, so K - Q is below 1e-6 I, which
    moves the trace term by at most 1e-6 N / (2 s2_min) and the Gaussian
    term by at most 1e-6 (N / s2_min + |y|^2 / s2_min^2) / 2."""
    import numpy as np
    from gpy_tpu_torch.inference.var_dtc import CONST_JITTER

    s2 = float(np.min(noise))
    return CONST_JITTER * (Y.shape[0] / s2 + float(np.sum(Y**2)) / (2 * s2**2))


def run_multi(rg, smi):
    """BASELINE config 4's multi-output half on the card: B1 checked and
    timed at the multi-output shapes, then the coreg and multioutput
    phases. Every record is printed before the limits are applied. Returns
    B1's launches on each phase's path, its checks and its times."""
    import torch

    shapes = ((COREG_P * COREG_N, COREG_P * COREG_N, 1), (COREG_N, COREG_P * COREG_N, 1),
              (2 * MO_N, 2 * MO_N, 1))
    t0 = time.perf_counter()
    b1_checks = [check_rbf_gram(rg, *s, dt) for s in shapes
                 for dt in (torch.float32, torch.float64)]
    b1_times = [time_rbf_gram(rg, *s) for s in shapes]
    b1_seconds = time.perf_counter() - t0
    Xl, Yl = coreg_data()
    t0 = time.perf_counter()
    co = run_coreg(Xl, Yl)
    co.update({"seconds": time.perf_counter() - t0, "rbf_gram_seconds": b1_seconds,
               "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times, "nvidia_smi": smi})
    emit(co)
    t0 = time.perf_counter()
    mo = run_multioutput()
    mo.update({"seconds": time.perf_counter() - t0, "nvidia_smi": smi})
    emit(mo)

    models = dict(co["models"], **mo["models"])
    for name, tols in COREG_REL_TOL.items():
        for k, tol in tols.items():
            v = models[name][f"{k}_rel_f32_vs_f64"]
            check(v <= tol, f"{name}: float32 vs float64 {k}: rel {v} > {tol}")
    for name, want in COREG_B1.items():
        got = models[name]["rbf_gram_launches"]
        check(got == want, f"{name}: {got} rbf_gram launches an evaluation, not {want}")
    for name in ("gpcr", "multioutput"):
        for run in ("optimize", "optimize_f64"):
            o = models[name][run]
            what = f"{name} {run}"
            check(o["finite"], f"{what}: non-finite NLML, gradient or prediction")
            check(o["nlml_end_f64"] < o["nlml_start_f64"],
                  f"{what}: the NLML did not fall as float64 evaluates it "
                  f"({o['nlml_start_f64']} -> {o['nlml_end_f64']})")
            check(o["rbf_gram_launches"] == o["evaluations"],
                  f"{what}: {o['rbf_gram_launches']} rbf_gram launches in "
                  f"{o['evaluations']} evaluations")
    rmse = models["gpcr"]["optimize_f64"]["pred_rmse_end"]
    check(max(rmse.values()) < COREG_F64_RMSE,
          f"gpcr: the float64 fit's predict RMSE {rmse} not below {COREG_F64_RMSE}")
    rmse = models["multioutput"]["optimize_f64"]["pred_rmse_end"]
    check(all(rmse[k] < lim for k, lim in MO_F64_RMSE.items()),
          f"multioutput: the float64 fit's predict RMSE {rmse} not below {MO_F64_RMSE}")
    identities = dict(co["float64_identities"], **mo["float64_identities"])
    for k, tol in COREG_EXACT_TOL.items():
        check(identities[k] <= tol, f"multi-output float64 identity {k}: {identities[k]} > {tol}")
    gap = identities["sparse_z_eq_x_gap"]
    check(0.0 <= gap <= identities["sparse_z_eq_x_gap_bound"],
          f"sparse_gpcr with Z = X: the bound is {gap} below the exact log marginal, outside "
          f"[0, {identities['sparse_z_eq_x_gap_bound']}]")
    launches_co = (sum(r["rbf_gram_launches"] for r in co["models"].values())
                   + sum(co["models"]["gpcr"][r]["rbf_gram_launches"]
                         for r in ("optimize", "optimize_f64")))
    launches_mo = (sum(r["rbf_gram_launches"] for r in mo["models"].values())
                   + sum(mo["models"]["multioutput"][r]["rbf_gram_launches"]
                         for r in ("optimize", "optimize_f64")))
    return {"launches_coreg": launches_co, "launches_multioutput": launches_mo,
            "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


# --- latent-variable models and sparse HMC (BASELINE config 5) ---------------

# bench.py:627-642: BayesianGPLVM(Y, 10, num_inducing=30) on Y = N(0,1)^{1000x3}
# N(0,1)^{3x12} + 0.1 eps, Adam at 5e-3, 200 steps a call; the streaming check
# at a shape picked for it (an (N, M, M) float32 psi2 would be 3.3 GB)
LV_N, LV_D, LV_Q, LV_M, LV_ADAM_ITERS, LV_STEP = 1000, 12, 10, 30, 200, 5e-3
LV_STREAM_N, LV_STREAM_M = 50_000, 128
# B1 launches an evaluation: Kmm only for the psi-statistics bounds (one a
# view for MRD), K(X) for GPLVM, Kmm and Kmn for SparseGPLVM
LV_B1 = {"bgplvm": 1, "gplvm": 1, "sparse_gplvm": 2, "mrd": 2, "ssgplvm": 1,
         "bgplvm_minibatch_nan": 1}
# float32 against a float64 twin at the start's raw parameters (NLML
# relative, gradient as max|diff| / max|ref|): ~10x the readings on an H100,
# equal in two calls (BayesianGPLVM 1.0e-8 / 5.5e-8, GPLVM 4.1e-8 /
# 1.7e-6, SparseGPLVM 2.7e-8 / 6.1e-8, MRD 7.7e-8 / 5.7e-8, SSGPLVM 6.4e-8
# / 7.5e-8, the missing-data model 2.7e-8 / 1.9e-8)
LV_REL_TOL = {
    "bgplvm": {"nlml": 1e-7, "grad": 5.5e-7},
    "gplvm": {"nlml": 4.1e-7, "grad": 1.7e-5},
    "sparse_gplvm": {"nlml": 2.7e-7, "grad": 6.1e-7},
    "mrd": {"nlml": 7.7e-7, "grad": 5.7e-7},
    "ssgplvm": {"nlml": 6.4e-7, "grad": 7.5e-7},
    "bgplvm_minibatch_nan": {"nlml": 2.7e-7, "grad": 1.9e-7},
}
# float64 identities on the card: BayesianGPLVM at S = 1e-10 against
# SparseGPRegression's VarDTC bound at X = the mean (before the KL); SSGPLVM
# at gamma = 1 - 1e-10 against BayesianGPLVM (before the KL); the streamed
# psi2 against the summed psi2n at N = 1000. ~10x the readings on an H100
# (1.06e-11, 2.0e-12, 1.7e-16)
LV_EXACT_TOL = {"bgplvm_s0_vs_vardtc": 1.1e-10, "ssgplvm_gamma1_vs_bgplvm": 2e-11,
                "streamed_psi2_vs_psi2n": 1.7e-15}
# the sparse HMC stage: bench.py:847-853's data as SparseGPRegression(M=64),
# its chains in float64: Kmm of 64 rows in 2-D at lengthscale 1 is too
# ill-conditioned for float32, whose leapfrog trajectories diverge and
# accept nothing, in the port as in the reference (hmc_f32_witness.py on
# the CPU: acceptance 0.0 in both, 0.98 in float64). The float64 chains'
# acceptance must exceed SHMC_MIN_ACCEPT at every chain count (readings
# 0.984-0.988 on an H100). The batched logp and gradient against the
# unbatched path, relative to max|.|:
# - at the float32 chains' final states (their jittered starts): float64
#   within SHMC_F64_REL_TOL["start"] (~10x the readings on an H100,
#   3.1e-12 / 2.3e-11); float32's batched error against float64 within
#   SHMC_F32_VS_UNBATCHED times the unbatched float32 path's own
#   (readings 8.0e-3 / 3.5e-2 against 7.7e-3 / 2.3e-2);
# - at the 16 float64 chains' final states, where the noise has fallen
#   to ~0.01 and cond(Kmm) is 1e7-1e8: float64 within
#   SHMC_F64_REL_TOL["final"] (~10x the readings, 4.6e-11 / 1.4e-7: the
#   batched and the single factorization round differently and the
#   gradient amplifies it). float32 cannot evaluate these states (off
#   float64 by more than 100%): recorded, not held.
SHMC_M = 64
SHMC_F64_REL_TOL = {"start": {"logp": 3.1e-11, "grad": 2.3e-10},
                    "final": {"logp": 4.6e-10, "grad": 1.4e-6}}
SHMC_F32_VS_UNBATCHED = 2.0
SHMC_MIN_ACCEPT = 0.5


def lv_data(N=None, seed=0):
    import numpy as np

    N = LV_N if N is None else N
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, 3)) @ rng.standard_normal((3, LV_D))
            + 0.1 * rng.standard_normal((N, LV_D))).astype(np.float32)


def lv_model(name, Y, dtype, **kw):
    import numpy as np
    from gpy_tpu_torch import models as T

    c = dict(device="cuda", dtype=dtype)
    if name == "bgplvm":
        return T.BayesianGPLVM(Y, LV_Q, num_inducing=LV_M, **kw, **c)
    if name == "gplvm":
        return T.GPLVM(Y, LV_Q, **c)
    if name == "sparse_gplvm":
        return T.SparseGPLVM(Y, LV_Q, num_inducing=LV_M, **c)
    if name == "mrd":
        return T.MRD([Y[:, :6], Y[:, 6:]], LV_Q, num_inducing=LV_M, **c)
    if name == "ssgplvm":
        return T.SSGPLVM(Y, LV_Q, num_inducing=LV_M, **kw, **c)
    Yn = Y.copy()
    Yn[np.random.default_rng(5).random(Y.shape) < 0.1] = np.nan
    return T.BayesianGPLVMMiniBatch(Yn, LV_Q, num_inducing=LV_M, **c)


def timed_adam(m, iters):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.optimize(optimizer="adam", max_iters=iters, step_size=LV_STEP)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def lv_identities(Y):
    """The float64 identities of LV_EXACT_TOL at N = 1000."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.kern.psi_comp import psi2_weighted
    from gpy_tpu_torch.models import SparseGPRegression

    f64 = torch.float64
    out = {}
    mb = lv_model("bgplvm", Y, f64, X_variance=np.full((LV_N, LV_Q), 1e-10))
    with torch.no_grad():
        bq = (mb.log_likelihood() + mb.qX.KL()).item()
        ms = SparseGPRegression(mb.qX.mean.numpy(), Y, Z=mb.Z.numpy(),
                                kernel=RBF(LV_Q, ARD=True, device="cuda", dtype=f64),
                                noise_var=1.0, device="cuda", dtype=f64)
        out["bgplvm_s0_vs_vardtc"] = rel(bq, ms.log_likelihood().item())
        mg = lv_model("bgplvm", Y, f64)
        mss = lv_model("ssgplvm", Y, f64, X_variance=mg.qX.variance.numpy(),
                       Gamma=np.full((LV_N, LV_Q), 1.0 - 1e-10))
        mss.likelihood.variance = 1.0
        out["ssgplvm_gamma1_vs_bgplvm"] = rel((mss.log_likelihood() + mss.qX.KL(mss.pi)).item(),
                                              (mg.log_likelihood() + mg.qX.KL()).item())
        W = torch.ones(LV_N, dtype=f64, device="cuda")
        streamed = psi2_weighted(mg.kern, mg.Z.values, mg.qX, W)
        summed = torch.einsum("n,nmk->mk", W, mg.kern.psi2n(mg.Z.values, mg.qX))
        out["streamed_psi2_vs_psi2n"] = float((streamed - summed).abs().max()
                                              / summed.abs().max())
    return out


def lv_streaming():
    """BayesianGPLVM NLML+gradient at N=50,000, M=128 in float32: its time
    and the peak device memory over it, beside the size of a materialized
    (N, M, M) psi2."""
    import numpy as np
    import torch
    from gpy_tpu_torch import models as T

    Y = lv_data(LV_STREAM_N, seed=1)
    m = T.BayesianGPLVM(Y, LV_Q, num_inducing=LV_STREAM_M, device="cuda", dtype=torch.float32)
    x = m.optimizer_array
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f, g = m._objective_and_grad(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = host_ms(lambda: m._objective_and_grad(x), reps=3, warmup=0)
    check(math.isfinite(f) and np.isfinite(g).all(), "gplvm streaming: non-finite NLML or gradient")
    psi2_gib = LV_STREAM_N * LV_STREAM_M**2 * 4 / 2**30
    del m
    torch.cuda.empty_cache()
    return {"N": LV_STREAM_N, "M": LV_STREAM_M, "Q": LV_Q, "D": LV_D, "dtype": "float32",
            "objective_and_grad_ms": ms, "nlml": f,
            "peak_mem_gib": peak / 2**30, "peak_above_start_gib": (peak - base) / 2**30,
            "materialized_psi2_gib": psi2_gib}


def run_gplvm(rg, smi):
    """BASELINE config 5's first half: BayesianGPLVM at bench.py's shape
    (Adam steps/s, one NLML+gradient with its counters, profile, host syncs
    and a float64 twin), GPLVM, SparseGPLVM, MRD, SSGPLVM and the
    missing-data BayesianGPLVMMiniBatch at the same Y, the streaming check
    and the float64 identities."""
    import torch

    Y = lv_data()
    recs = {}
    for name in LV_B1:
        m = lv_model(name, Y, torch.float32)
        recs[name], _ = one_evaluation(m, lambda: lv_model(name, Y, torch.float64),
                                       f"gplvm {name}, N={LV_N} float32")
        if name == "bgplvm":
            with_host_syncs(recs[name], m)
        del m
        torch.cuda.empty_cache()
    m = lv_model("bgplvm", Y, torch.float32)
    f0 = m._objective_and_grad(m.optimizer_array)[0]
    timed_adam(m, LV_ADAM_ITERS)  # warm-up
    times, launches, res = [], None, None
    for i in range(3):
        reset_counters()
        res, dt = timed_adam(m, LV_ADAM_ITERS)
        if i == 0:
            launches = counters()
        times.append(dt)
    f1 = m._objective_and_grad(m.optimizer_array)[0]
    times.sort()
    del m
    torch.cuda.empty_cache()
    adam = {"iters": LV_ADAM_ITERS, "step_size": LV_STEP, "seconds": times,
            "steps_per_s_best": LV_ADAM_ITERS / times[0],
            "steps_per_s_median": LV_ADAM_ITERS / times[1], "launches": launches,
            "nlml_start": f0, "nlml_after_800_steps": f1, "f_opt_last": res.f_opt}
    stream = lv_streaming()
    ident = lv_identities(Y)
    return {"phase": "gplvm", "N": LV_N, "D": LV_D, "Q": LV_Q, "M": LV_M, "dtype": "float32",
            "models": recs, "adam": adam, "streaming": stream, "float64_identities": ident,
            "rbf_gram_launches_expected": LV_B1, "f32_limits": LV_REL_TOL,
            "float64_identity_limits": LV_EXACT_TOL, "nvidia_smi": smi}


def run_sparse_hmc(smi):
    """The batched sparse bound: HMC chains over SparseGPRegression(M=64) at
    bench.py's HMC data, in float64 at 1 to 16 chains and in float32 at 16,
    the counters set to 0 just before each timed sample() and read just
    after; the batched logp and gradient at the 16 float64 chains' final
    states against the unbatched path (float64 and float32); 16 parallel
    restarts."""
    import numpy as np
    import torch
    from gpy_tpu_torch import mcmc
    from gpy_tpu_torch.models import SparseGPRegression

    X, Y = hmc_data()

    def model(dtype):
        return SparseGPRegression(X, Y, num_inducing=SHMC_M, noise_var=0.1, device="cuda",
                                  dtype=dtype)

    evals = HMC_SAMPLES * (1 + HMC_LEAPFROG)

    def chains(m, counts, tag):
        hmc = mcmc.HMC(m, stepsize=HMC_STEP, num_leapfrog=HMC_LEAPFROG)
        P = m.num_free_params
        per_chain, finals, b1 = {}, {}, 0
        for C in counts:
            hmc.sample(num_samples=2, num_chains=C, seed=0)  # warm
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = hmc.sample(num_samples=HMC_SAMPLES, num_chains=C, seed=3)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            c = counters()
            b1 += c["rbf_gram"]
            check(np.isfinite(s).all() and s.shape == ((HMC_SAMPLES, P) if C == 1
                                                       else (C, HMC_SAMPLES, P)),
                  f"sparse_hmc {tag} C={C}: samples not finite or of the wrong shape")
            check(c["rbf_gram"] == 2 * C * evals,
                  f"sparse_hmc {tag} C={C}: {c['rbf_gram']} rbf_gram launches for {evals} "
                  "evaluations")
            check(all(v == 0 for k, v in c.items() if k != "rbf_gram"),
                  f"sparse_hmc {tag} C={C}: unexpected launches {c}")
            per_chain[str(C)] = {"samples_x_chains_per_s": HMC_SAMPLES * C / dt,
                                 "seconds": dt, "accept_rate": hmc._accept_rate,
                                 "evaluations": evals,
                                 "rbf_gram_launches_per_evaluation": c["rbf_gram"] / evals,
                                 "launches": c}
            finals[C] = s[-1] if C == 1 else s[:, -1]
        return hmc, per_chain, finals, b1

    def kmm_cond(raw):
        """min and max of cond(Kmm + jitter) over the rows of `raw`, float64."""
        from gpy_tpu_torch.inference.var_dtc import CONST_JITTER

        eye = torch.eye(SHMC_M, dtype=torch.float64, device="cuda")
        with torch.no_grad():
            conds = []
            for r in raw.to("cuda"):
                with m64.bind_flat_raw(r):
                    ev = torch.linalg.eigvalsh((m64.kern.K(m64.Z.values)
                                                + CONST_JITTER * eye).cpu())
                    conds.append((ev[-1] / ev[0]).item())
        return [min(conds), max(conds)]

    m64 = model(torch.float64)
    h64, per64, finals64, b1 = chains(m64, HMC_CHAINS, "float64")
    m32 = model(torch.float32)
    h32, per32, finals32, b = chains(m32, (HMC_CHAINS[-1],), "float32")
    b1 += b
    relerr = {}
    for at, fin in (("start", finals32), ("final", finals64)):
        raw = raw_from_constrained(m64, fin[HMC_CHAINS[-1]])
        relerr[at] = {**logp_rel_errors(h32, h64, raw), "kmm_cond": kmm_cond(raw)}
    del m64, h64, m32, h32
    torch.cuda.empty_cache()

    # 16 parallel restarts, float32 and float64 from the same inits: Z is
    # free (128 of the 131 parameters), and float32 Adam can walk Kmm past
    # what float32 factors (PERF.md: the collapsed bounds' float32 fit), so
    # the restarts are judged in float64 and float32's kept point is read
    # again in float64
    restarts = {}
    for dtype in (torch.float32, torch.float64):
        mr = model(dtype)
        f_start = float(mr.objective_function().detach())
        reset_counters()
        t0 = time.perf_counter()
        res = mr.optimize_restarts(parallel=True, num_restarts=HMC_RESTARTS, max_iters=100,
                                   step_size=0.03, seed=0, verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = counters()
        b1 += launched["rbf_gram"]
        kept = float(mr.objective_function().detach())
        m64 = model(torch.float64)
        m64.set_flat_raw(mr.get_flat_raw().double())
        kept_f64 = float(m64.objective_function().detach())
        restarts[str(dtype).replace("torch.", "")] = {
            "num_restarts": HMC_RESTARTS, "max_iters": 100, "step_size": 0.03, "seconds": dt,
            "launches": launched, "objective_start": f_start, "kept": kept,
            "kept_in_float64": kept_f64, "objectives": [r.f_opt for r in res]}
        del mr
    m64.optimize()  # L-BFGS-B in float64 from the kept restart: how far Adam stopped short
    restarts["float64"]["lbfgsb_from_kept"] = float(m64.objective_function().detach())
    del m64
    torch.cuda.empty_cache()
    return {"phase": "sparse_hmc", "N": HMC_N, "D": HMC_D, "M": SHMC_M, "dtype": "float64",
            "num_samples": HMC_SAMPLES, "num_leapfrog": HMC_LEAPFROG, "stepsize": HMC_STEP,
            "by_chains": per64, "float32_chains": per32, "batched_vs_unbatched": relerr,
            "limits": {"float64": SHMC_F64_REL_TOL,
                       "f32_vs_unbatched_factor": SHMC_F32_VS_UNBATCHED,
                       "min_accept_float64": SHMC_MIN_ACCEPT},
            "restarts": restarts, "rbf_gram_launches": b1, "nvidia_smi": smi}


def run_latent(rg, smi):
    """BASELINE config 5 on the card: B1 checked and timed at the latent
    models' shapes, then the gplvm and sparse_hmc phases. Every record is
    printed before the limits are applied. Returns B1's launches on these
    paths, its checks and its times."""
    import torch

    shapes = ((LV_M, LV_M, LV_Q), (LV_N, LV_N, LV_Q), (LV_M, LV_N, LV_Q),
              (SHMC_M, SHMC_M, HMC_D), (SHMC_M, HMC_N, HMC_D))
    t0 = time.perf_counter()
    b1_checks = [check_rbf_gram(rg, *s, dt) for s in shapes
                 for dt in (torch.float32, torch.float64)]
    b1_times = [time_rbf_gram(rg, *s) for s in shapes]
    b1_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    lv = run_gplvm(rg, smi)
    lv.update({"seconds": time.perf_counter() - t0, "rbf_gram_seconds": b1_seconds,
               "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times})
    emit(lv)
    t0 = time.perf_counter()
    sh = run_sparse_hmc(smi)
    sh["seconds"] = time.perf_counter() - t0
    emit(sh)

    for name, tols in LV_REL_TOL.items():
        for k, tol in tols.items():
            v = lv["models"][name][f"{k}_rel_f32_vs_f64"]
            check(v <= tol, f"gplvm {name}: float32 vs float64 {k}: rel {v} > {tol}")
    for name, want in LV_B1.items():
        got = lv["models"][name]["rbf_gram_launches"]
        check(got == want, f"gplvm {name}: {got} rbf_gram launches an evaluation, not {want}")
    adam = lv["adam"]
    check(adam["launches"]["rbf_gram"] == LV_ADAM_ITERS
          and all(v == 0 for k, v in adam["launches"].items() if k != "rbf_gram"),
          f"gplvm adam: launches {adam['launches']} in {LV_ADAM_ITERS} steps, not one B1 a step")
    check(adam["nlml_after_800_steps"] < adam["nlml_start"],
          f"gplvm adam: the objective did not fall ({adam['nlml_start']} -> "
          f"{adam['nlml_after_800_steps']})")
    st = lv["streaming"]
    check(st["peak_mem_gib"] < 0.5 * st["materialized_psi2_gib"],
          f"gplvm streaming: peak {st['peak_mem_gib']} GiB is not well under the "
          f"{st['materialized_psi2_gib']} GiB of a materialized psi2")
    for k, tol in LV_EXACT_TOL.items():
        v = lv["float64_identities"][k]
        check(v <= tol, f"gplvm float64 identity {k}: rel {v} > {tol}")
    for at, tols in SHMC_F64_REL_TOL.items():
        for q, tol in tols.items():
            v = sh["batched_vs_unbatched"][at][f"f64_{q}_vs_unbatched"]
            check(v <= tol, f"sparse_hmc: float64 batched vs unbatched {q} at the {at} "
                  f"states: rel {v} > {tol}")
    for q in ("logp", "grad"):
        v = sh["batched_vs_unbatched"]["start"][f"f32_{q}_vs_f64"]
        own = sh["batched_vs_unbatched"]["start"][f"f32_unbatched_{q}_vs_f64"]
        check(v <= SHMC_F32_VS_UNBATCHED * own,
              f"sparse_hmc: the float32 batched {q} is off float64 by {v}, more than "
              f"{SHMC_F32_VS_UNBATCHED} x the unbatched float32 path's {own}")
    for C, r in sh["by_chains"].items():
        check(r["accept_rate"] > SHMC_MIN_ACCEPT,
              f"sparse_hmc float64 C={C}: acceptance {r['accept_rate']}")
    for name, r in sh["restarts"].items():
        launched = r["launches"]
        check(launched["rbf_gram"] == 2 * HMC_RESTARTS * 101
              and all(v == 0 for k, v in launched.items() if k != "rbf_gram"),
              f"sparse restarts {name}: launches {launched}, not 2 B1 a row an evaluation")
    r = sh["restarts"]["float64"]
    finite = [f for f in r["objectives"] if math.isfinite(f)]
    check(finite and r["kept"] < r["objective_start"]
          and abs(r["kept"] - min(finite)) <= 1e-6 * abs(r["kept"]),
          f"sparse restarts float64: kept {r['kept']}, start {r['objective_start']}, "
          f"restarts {r['objectives']}")
    launches_lv = (sum(r["rbf_gram_launches"] for r in lv["models"].values())
                   + adam["launches"]["rbf_gram"])
    return {"launches_gplvm": launches_lv, "launches_sparse_hmc": sh["rbf_gram_launches"],
            "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


# --- slice 15: LVMOGP, the Student-t process, the optimizers, the GP surface --

# bench.py:832-839: LVMOGP at 400 rows x 8 outputs, Xr_dim=2, (Mc, Mr) =
# (32, 4), init="rand"; its scale point, chosen here: 20,000 x 50, (100, 10)
LVM_N, LVM_D, LVM_XR, LVM_M = 400, 8, 2, (32, 4)
LVM_SCALE_N, LVM_SCALE_D, LVM_SCALE_M = 20_000, 50, (100, 10)
LVM_AUTO_ITERS, LVM_MISSING = 200, 0.1
# bench.py:815-819: TPRegression at N=2048, D=2, deg_free=4
TP_N, TP_D, TP_NU, TP_WHITE = 2048, 2, 4.0, 0.01
# the optimizers on bench.py's HMC data (N=1000, D=2, noise 0.1)
OPT_NAMES = ("adam", "adagrad", "rmsprop", "adadelta", "rprop", "lbfgs_device")
OPT_RULES = ("adam", "adagrad", "rmsprop", "adadelta", "rprop")
OPT_ITERS, OPT_STEP, OPT_SLICE_ITERS = 100, 0.03, 30
# the GP surface on the N=8192 dense slice; infer_newX on bench.py's GPLVM
SURF_GRAD_N, SURF_SAMPLE_N, SURF_SAMPLES, SURF_LPD_N = 2048, 512, 10, 2048
SURF_SVGP_ITERS, SURF_NEWX = 200, 16
# B1 launches an evaluation: LVMOGP K(Zc), K(Xc, Zc), K(Zr); TP K(X)
LVM_B1, TP_B1 = 3, 1
# LVMOGP float32 against a float64 twin at the init="rand" start, rel NLML /
# max-relative gradient: ~10x the readings on an H100 (full 2.5e-5 /
# 3.0e-3, missing data with a noise per output 6.4e-5 / 3.4e-2); and the
# float64 identity, the missing-data bound with every entry observed
# against the full bound (reading 1.1e-16)
LVM_F32_TOL = {"evaluation": {"nlml": 2.5e-4, "grad": 3e-2},
               "missing_data": {"nlml": 6.4e-4, "grad": 0.34}}
LVM_EXACT_TOL = {"md_all_observed_vs_full": 1.2e-15}
# TPRegression with RBF + White(0.01), float32 against float64: ~10x the
# readings on an H100 (1.3e-5 / 1.8e-3)
TP_F32_TOL = {"nlml": 1.3e-4, "grad": 1.8e-2}


def lvmogp_data(N=None, D=None, seed=0):
    """bench.py:832-836: X = linspace(0, 5, N), Y_d = w_d sin(x) + 0.05 eps
    with w = linspace(0.5, 1.5, D), float32; and the noiseless targets."""
    import numpy as np

    N, D = N or LVM_N, D or LVM_D
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 5, N).reshape(-1, 1).astype(np.float32)
    F = np.hstack([np.sin(X) * w for w in np.linspace(0.5, 1.5, D)]).astype(np.float32)
    Y = F + 0.05 * rng.standard_normal(F.shape).astype(np.float32)
    return X, Y, F


def lvmogp_model(X, Y, dtype, M=None, md=None, **kw):
    """GPMultioutRegression(X, Y, Xr_dim=2, init="rand"), or with md = (keep
    mask) the missing-data model on the kept entries of Y, stacked."""
    import numpy as np
    from gpy_tpu_torch import models as T

    c = dict(num_inducing=M or LVM_M, init="rand", device="cuda", dtype=dtype, **kw)
    if md is None:
        return T.GPMultioutRegression(X, Y, LVM_XR, **c)
    N, D = Y.shape
    idx = np.repeat(np.arange(D), N)
    Xs, Ys = np.tile(X, (D, 1)), Y.T.reshape(-1, 1)
    return T.GPMultioutRegressionMD(Xs[md], Ys[md], idx[md], LVM_XR, **c)


def run_lvmogp(rg, smi):
    """LVMOGP at bench.py's shape: one ELBO+gradient with the counters and
    a float64 twin (one_evaluation), its host syncs; optimize_auto(200):
    seconds, evaluations, B1 launches, the bound before and after, predict
    RMSE against the noiseless targets; the missing-data model with 10% of
    the entries dropped and a noise per output, evaluated likewise; the
    float64 identity; the scale point's ELBO+gradient."""
    import numpy as np
    import torch

    f32, f64 = torch.float32, torch.float64
    b1_checks = [check_rbf_gram(rg, *s, f32) for s in
                 ((LVM_M[0], LVM_M[0], 1), (LVM_N, LVM_M[0], 1), (LVM_M[1], LVM_M[1], LVM_XR))]
    b1_times = [time_rbf_gram(rg, LVM_N, LVM_M[0], 1),
                time_rbf_gram(rg, LVM_SCALE_N, LVM_SCALE_M[0], 1)]
    X, Y, F = lvmogp_data()
    m = lvmogp_model(X, Y, f32)
    rec, m64 = one_evaluation(m, lambda: lvmogp_model(X, Y, f64),
                              f"lvmogp, {LVM_N} x {LVM_D} float32")
    with_host_syncs(rec, m)
    del m64
    x0 = m.optimizer_array
    evals = counted_evaluations(m)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        first, second = m.optimize_auto(max_iters=LVM_AUTO_ITERS)
        torch.cuda.synchronize()
    finally:
        del m._objective_and_grad
    auto_s = time.perf_counter() - t0
    auto_launches = counters()
    f_end = m._objective_and_grad(m.optimizer_array)[0]
    Xs = np.linspace(0, 5, 200).reshape(-1, 1).astype(np.float32)
    truth = np.hstack([np.sin(Xs) * w for w in np.linspace(0.5, 1.5, LVM_D)])
    mu, var = m.predict(Xs)
    m.set_flat_raw(x0)
    mu0, _ = m.predict(Xs)
    predict_ms = host_ms(lambda: m.predict(Xs), reps=5, warmup=1)
    auto = {"max_iters": LVM_AUTO_ITERS, "seconds": auto_s, "evaluations": evals[0],
            "rbf_gram_launches": auto_launches["rbf_gram"], "launches": auto_launches,
            "elbo_start": -rec["nlml"], "elbo_end": -f_end,
            "scipy_messages": [first.status, second.status],
            "pred_rmse_start": float(np.sqrt(np.mean((mu0 - truth) ** 2))),
            "pred_rmse_end": float(np.sqrt(np.mean((mu - truth) ** 2))),
            "pred_finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                                and (var > 0).all()),
            "predict_ms_200": predict_ms}
    del m
    torch.cuda.empty_cache()

    keep = np.random.default_rng(4).random(LVM_N * LVM_D) >= LVM_MISSING
    m = lvmogp_model(X, Y, f32, md=keep, heter_noise=True)
    md_rec, _ = one_evaluation(m, lambda: lvmogp_model(X, Y, f64, md=keep, heter_noise=True),
                               f"lvmogp missing data, {int(keep.sum())} entries float32")
    with_host_syncs(md_rec, m)
    md_rec.update({"entries": int(keep.sum()), "heter_noise": True})
    del m

    full = lvmogp_model(X, Y, f64)
    allmd = lvmogp_model(X, Y, f64, md=np.ones(LVM_N * LVM_D, dtype=bool))
    allmd.set_flat_raw(full.optimizer_array)
    with torch.no_grad():
        ident = {"md_all_observed_vs_full": rel(allmd.log_likelihood().item(),
                                                full.log_likelihood().item())}
    del full, allmd

    Xb, Yb, _ = lvmogp_data(LVM_SCALE_N, LVM_SCALE_D, seed=1)
    mb = lvmogp_model(Xb, Yb, f32, M=LVM_SCALE_M)
    xb = mb.optimizer_array
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    fb, gb = mb._objective_and_grad(xb)
    scale_launches = counters()["rbf_gram"]
    scale = {"N": LVM_SCALE_N, "D": LVM_SCALE_D, "num_inducing": list(LVM_SCALE_M),
             "dtype": "float32", "objective_and_grad_ms": host_ms(
                 lambda: mb._objective_and_grad(xb), reps=5, warmup=1),
             "nlml": fb, "finite": bool(math.isfinite(fb) and np.isfinite(gb).all()),
             "rbf_gram_launches": scale_launches,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del mb
    torch.cuda.empty_cache()
    return {"phase": "lvmogp", "N": LVM_N, "D": LVM_D, "Xr_dim": LVM_XR,
            "num_inducing": list(LVM_M), "dtype": "float32", "init": "rand",
            "evaluation": rec, "optimize_auto": auto, "missing_data": md_rec,
            "float64_identities": ident, "float64_identity_limits": LVM_EXACT_TOL,
            "scale_point": scale, "rbf_gram_launches_expected": LVM_B1,
            "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times, "nvidia_smi": smi}


def tp_model(X, Y, dtype, white=None):
    """bench.py's TPRegression(X, Y, deg_free=4) with its default RBF, or
    with RBF + White(white), a noise term."""
    from gpy_tpu_torch.kern import RBF, White
    from gpy_tpu_torch.models import TPRegression

    c = dict(device="cuda", dtype=dtype)
    kern = None if white is None else RBF(TP_D, **c) + White(TP_D, variance=white, **c)
    return TPRegression(X, Y, kernel=kern, deg_free=TP_NU, **c)


def run_tp(rg, smi):
    """TPRegression at bench.py's shape (the default RBF, no noise term): one
    NLML+gradient with the counters and a float64 twin, predict ms at 2048
    points, and the jitter jitchol added to K + 1e-8 I in each precision.
    Without a noise term float32 and float64 factor differently jittered
    matrices, so their agreement is recorded, not held; the limits hold
    RBF + White(0.01), where no ladder runs, float32 against float64."""
    import numpy as np
    import torch
    from gpy_tpu_torch.util.linalg import chol_jitter_used

    b1_checks = [check_rbf_gram(rg, TP_N, TP_N, TP_D, torch.float32)]
    b1_times = [time_rbf_gram(rg, TP_N, TP_N, TP_D)]
    rng = np.random.default_rng(0)
    X = rng.random((TP_N, TP_D)).astype(np.float32) * 4.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((TP_N, 1))).astype(np.float32)
    Xs = rng.random((N_PRED, TP_D)).astype(np.float32) * 4.0
    m = tp_model(X, Y, torch.float32)
    rec, m64 = one_evaluation(m, lambda: tp_model(X, Y, torch.float64),
                              f"tp, N={TP_N} float32")
    with_host_syncs(rec, m)
    jitter = {}
    for name, mm in (("float32", m), ("float64", m64)):
        with torch.no_grad():
            K = mm.kern.K(mm.X)
            K = K + 1e-8 * torch.eye(TP_N, dtype=K.dtype, device=K.device)
            jitter[name] = float(chol_jitter_used(K)[1])
    mu, var = m.predict(Xs)
    mu64, var64 = m64.predict(Xs)
    q = m.predict_quantiles(Xs)
    rec.update({"predict_ms": host_ms(lambda: m.predict(Xs), reps=5, warmup=1),
                "predict_host_syncs": len(host_syncs(lambda: m.predict(Xs))),
                "jitter_added": jitter,
                "predict_mean_rel_f32_vs_f64": float(np.max(np.abs(mu - mu64))
                                                     / np.max(np.abs(mu64))),
                "predict_var_rel_f32_vs_f64": float(np.max(np.abs(var - var64))
                                                    / np.max(np.abs(var64))),
                "predict_finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                                       and (var > 0).all() and np.isfinite(q).all()),
                "pred_rmse_vs_sin": float(np.sqrt(np.mean((mu - np.sin(Xs[:, :1])) ** 2)))})
    del m, m64
    mw = tp_model(X, Y, torch.float32, white=TP_WHITE)
    held, _ = one_evaluation(mw, lambda: tp_model(X, Y, torch.float64, white=TP_WHITE),
                             f"tp RBF + White({TP_WHITE}), N={TP_N} float32")
    rec["rbf_plus_white"] = held
    del mw
    torch.cuda.empty_cache()
    return {"phase": "tp", "N": TP_N, "D": TP_D, "deg_free": TP_NU, "dtype": "float32",
            "evaluation": rec, "rbf_gram_launches_expected": TP_B1,
            "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times, "nvidia_smi": smi}


def optimizer_run(opt, dtype, X, Y, f64_at):
    """optimize(optimizer=opt, max_iters=OPT_ITERS) of the HMC model from its
    default start: seconds, evaluations, host syncs an iteration (those of a
    10-step run less those of a 5-step run, over 5) beside those of one
    evaluation of the objective as the loops evaluate it (value_and_grad,
    no read to the host but the jitter ladder's test), the end NLML and as
    float64 reads it at the same raw vector."""
    import torch
    from gpy_tpu_torch.core.model import value_and_grad

    def run(iters):
        m = hmc_model(X, Y, dtype)
        return m, m.optimize(optimizer=opt, max_iters=iters, step_size=OPT_STEP)

    syncs = [len(host_syncs(lambda: run(n))) for n in (5, 10)]
    m = hmc_model(X, Y, dtype)
    x0 = m.optimizer_array
    per_eval = len(host_syncs(lambda: value_and_grad(m._flat_objective, m.get_flat_raw())))
    f0 = m._objective_and_grad(x0)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = m.optimize(optimizer=opt, max_iters=OPT_ITERS, step_size=OPT_STEP)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    x = m.optimizer_array
    return {"optimizer": opt, "dtype": str(dtype).replace("torch.", ""), "seconds": dt,
            "iterations": res.n_iters, "evaluations": res.n_evals,
            "host_syncs_per_iteration": (syncs[1] - syncs[0]) / 5.0,
            "host_syncs_per_evaluation": per_eval,
            "host_syncs_5_and_10_iterations": syncs, "status": res.status,
            "nlml_start": f0, "nlml_end": m._objective_and_grad(x)[0],
            "nlml_end_f64": f64_at(x)}


def run_optimizers(smi):
    """Each optimizer for OPT_ITERS iterations in float32 and float64 on
    bench.py's HMC data; 16 parallel restarts x OPT_ITERS steps under each
    optax rule with the counters set to 0 just before and read just after
    (8 B2 launches and 16 B1 an evaluation); lbfgs_device against lbfgsb on
    the N=8192 dense slice, max_iters=30."""
    import torch

    X, Y = hmc_data()
    m64 = hmc_model(X, Y, torch.float64)

    def f64_at(x):
        m64.set_flat_raw(x)
        with torch.no_grad():
            return m64.objective_function().item()

    runs = [optimizer_run(opt, dt, X, Y, f64_at) for opt in OPT_NAMES
            for dt in (torch.float32, torch.float64)]
    restarts, b2 = {}, 0
    for opt in OPT_RULES:
        m = hmc_model(X, Y, torch.float32)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.optimize_restarts(parallel=True, num_restarts=HMC_RESTARTS, max_iters=OPT_ITERS,
                                  step_size=OPT_STEP, seed=0, verbose=False, optimizer=opt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = counters()
        b2 += launched["block_chol"]
        restarts[opt] = {"seconds": dt, "launches": launched,
                         "objectives": [r.f_opt for r in res],
                         "kept": m.objective_function().item(), "kept_f64": f64_at(
                             m.optimizer_array)}
    del m64
    Xd, Yd, _ = slice_data()
    dense = {}
    for opt in ("lbfgsb", "lbfgs_device"):
        m = build_model(Xd, Yd, torch.float32)
        evals = counted_evaluations(m) if opt == "lbfgsb" else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            res = m.optimize(optimizer=opt, max_iters=OPT_SLICE_ITERS)
            torch.cuda.synchronize()
        finally:
            if evals is not None:
                del m._objective_and_grad
        dense.setdefault(opt, []).append({
            "seconds": time.perf_counter() - t0, "iterations": res.n_iters,
            "evaluations": evals[0] if evals is not None else res.n_evals,
            "nlml_end": m._objective_and_grad(m.optimizer_array)[0], "status": res.status})
        del m
        torch.cuda.empty_cache()
    return {"phase": "optimizers", "N": HMC_N, "D": HMC_D, "noise": 0.1, "max_iters": OPT_ITERS,
            "step_size": OPT_STEP, "runs": runs, "restarts": restarts,
            "num_restarts": HMC_RESTARTS, "block_chol_launches": b2,
            "dense_slice": {"N": SLICE_N, "D": SLICE_D, "max_iters": OPT_SLICE_ITERS,
                            "dtype": "float32", "turns": dense},
            "nvidia_smi": smi}


def surface_model(X, Y, dtype, surface):
    """The dense slice's GPRegression, with normalizer=True and a Linear
    mean function when `surface`."""
    import numpy as np
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.mappings import Linear
    from gpy_tpu_torch.models import GPRegression

    c = dict(device="cuda", dtype=dtype)
    mf = None
    if surface:
        np.random.seed(0)  # Linear draws its weights from numpy's global generator
        mf = Linear(SLICE_D, 1, **c)
    return GPRegression(X, Y, RBF(SLICE_D, ARD=True, **c), noise_var=0.1, normalizer=surface,
                        mean_function=mf, **c)


def run_gp_surface(smi):
    """The GP surface on the N=8192 dense slice with normalizer=True and a
    Linear mean function: NLML+gradient against the plain model in turns,
    predictive_gradients, posterior_samples_f and log_predictive_density;
    SVGP with a Linear mean function against the plain SVGP at bench.py's
    SVGP shape (fit steps/s, in turns); infer_newX(variational=False) on
    GPLVM at bench.py's N=1000, D=12, Q=10."""
    import numpy as np
    import torch
    from gpy_tpu_torch import models as T
    from gpy_tpu_torch.mappings import Linear

    f32 = torch.float32
    X, Y, Xs = slice_data()
    Y = (3.0 + 2.0 * Y).astype(np.float32)  # an offset and a scale for the normalizer
    ms = {True: surface_model(X, Y, f32, True), False: surface_model(X, Y, f32, False)}
    xs = {k: m.optimizer_array for k, m in ms.items()}
    turns = {True: [], False: []}
    for k in (False, True, True, False):
        turns[k].append(host_ms(lambda: ms[k]._objective_and_grad(xs[k]), reps=3, warmup=1))
    m = ms[True]
    f, g = m._objective_and_grad(xs[True])
    reset_counters()
    dmu, dvar = m.predictive_gradients(Xs[:SURF_GRAD_N])
    grad_launches = counters()["rbf_gram"]
    grad_ms = host_ms(lambda: m.predictive_gradients(Xs[:SURF_GRAD_N]), reps=3, warmup=0)
    fs = m.posterior_samples_f(Xs[:SURF_SAMPLE_N], size=SURF_SAMPLES, full_cov=True)
    sample_ms = host_ms(lambda: m.posterior_samples_f(Xs[:SURF_SAMPLE_N], size=SURF_SAMPLES,
                                                      full_cov=True), reps=3, warmup=0)
    y_test = (3.0 + 2.0 * np.sin(Xs[:SURF_LPD_N, :1])).astype(np.float32)
    lpd = m.log_predictive_density(Xs[:SURF_LPD_N], y_test)
    lpd_ms = host_ms(lambda: m.log_predictive_density(Xs[:SURF_LPD_N], y_test), reps=3, warmup=0)
    dense = {"N": SLICE_N, "D": SLICE_D, "dtype": "float32", "normalizer": "Standardize",
             "mean_function": "Linear", "objective_and_grad_ms_surface": turns[True],
             "objective_and_grad_ms_plain": turns[False], "nlml": f,
             "finite": bool(math.isfinite(f) and np.isfinite(g).all()),
             "predictive_gradients_ms": grad_ms, "predictive_gradients_n": SURF_GRAD_N,
             "predictive_gradients_rbf_gram_launches": grad_launches,
             "predictive_gradients_finite": bool(np.isfinite(dmu).all()
                                                 and np.isfinite(dvar).all()),
             "posterior_samples_f_ms": sample_ms, "posterior_samples_n": SURF_SAMPLE_N,
             "posterior_samples_size": SURF_SAMPLES,
             "posterior_samples_finite": bool(np.isfinite(fs).all()),
             "log_predictive_density_ms": lpd_ms, "log_predictive_density_n": SURF_LPD_N,
             "log_predictive_density_mean": float(np.mean(lpd)),
             "log_predictive_density_finite": bool(np.isfinite(lpd).all())}
    del ms, m
    torch.cuda.empty_cache()

    Xv, Yv, Z = svgp_data()
    svgp = {}
    for mean in (False, True, True, False):
        sm = svgp_model(Xv, Yv, Z, f32)
        if mean:
            np.random.seed(0)
            sm = T.SVGP(Xv, Yv, Z, sm.kern, sm.likelihood,
                        mean_function=Linear(SVGP_D, 1, device="cuda", dtype=f32),
                        device="cuda", dtype=f32)
        timed_fit(sm, 20)
        tr, dt = timed_fit(sm, SURF_SVGP_ITERS)
        svgp.setdefault("linear_mean" if mean else "plain", []).append(
            {"steps_per_s": SURF_SVGP_ITERS / dt, "elbo_last": float(tr[-1])})
        del sm
    torch.cuda.empty_cache()

    Yl = lv_data()
    gl = T.GPLVM(Yl, LV_Q, device="cuda", dtype=f32)
    Ynew = lv_data(SURF_NEWX, seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Xnew, val = gl.infer_newX(Ynew, variational=False)
    torch.cuda.synchronize()
    newx = {"N": LV_N, "D": LV_D, "Q": LV_Q, "new_rows": SURF_NEWX, "dtype": "float32",
            "seconds": time.perf_counter() - t0, "iterations": gl._infer_newX_iters,
            "value": val, "host_syncs": len(host_syncs(lambda: gl.infer_newX(Ynew))),
            "finite": bool(np.isfinite(Xnew).all() and math.isfinite(val))}
    del gl
    torch.cuda.empty_cache()
    return {"phase": "gp_surface", "dense": dense, "svgp": svgp, "svgp_iters": SURF_SVGP_ITERS,
            "infer_newX": newx, "nvidia_smi": smi}


def run_slice15(rg, smi):
    """The lvmogp, tp, optimizers and gp_surface phases, each record printed
    before its limits are applied. Returns B1's and B2/B3's launches on
    these paths, B1's checks and its times."""
    recs = {}
    for name, fn in (("lvmogp", lambda: run_lvmogp(rg, smi)), ("tp", lambda: run_tp(rg, smi)),
                     ("optimizers", lambda: run_optimizers(smi)),
                     ("gp_surface", lambda: run_gp_surface(smi))):
        t0 = time.perf_counter()
        recs[name] = fn()
        recs[name]["seconds"] = time.perf_counter() - t0
        emit(recs[name])

    lv = recs["lvmogp"]
    for what, tols in LVM_F32_TOL.items():
        r = lv[what]
        check(r["rbf_gram_launches"] == LVM_B1,
              f"lvmogp {what}: {r['rbf_gram_launches']} B1 launches an evaluation, not {LVM_B1}")
        for k, tol in tols.items():
            check(r[f"{k}_rel_f32_vs_f64"] <= tol,
                  f"lvmogp {what}: float32 vs float64 {k} rel {r[f'{k}_rel_f32_vs_f64']} > {tol}")
    auto = lv["optimize_auto"]
    check(auto["rbf_gram_launches"] == LVM_B1 * auto["evaluations"]
          and all(v == 0 for k, v in auto["launches"].items() if k != "rbf_gram"),
          f"lvmogp optimize_auto: launches {auto['launches']} for {auto['evaluations']} evaluations")
    check(auto["elbo_end"] > auto["elbo_start"] and auto["pred_finite"]
          and auto["pred_rmse_end"] < auto["pred_rmse_start"],
          f"lvmogp optimize_auto: the bound or the predictions did not improve: {auto}")
    for k, tol in LVM_EXACT_TOL.items():
        check(lv["float64_identities"][k] <= tol,
              f"lvmogp float64 identity {k}: rel {lv['float64_identities'][k]} > {tol}")
    check(lv["scale_point"]["finite"] and lv["scale_point"]["rbf_gram_launches"] == LVM_B1,
          f"lvmogp scale point: {lv['scale_point']}")

    tp = recs["tp"]["evaluation"]
    check(tp["rbf_gram_launches"] == TP_B1, f"tp: {tp['rbf_gram_launches']} B1 launches")
    check(tp["predict_finite"], "tp: non-finite or non-positive predictions")
    for k, tol in TP_F32_TOL.items():
        v = tp["rbf_plus_white"][f"{k}_rel_f32_vs_f64"]
        check(v <= tol, f"tp RBF + White: float32 vs float64 {k} rel {v} > {tol}")

    op = recs["optimizers"]
    for r in op["runs"]:
        check(math.isfinite(r["nlml_end"]) and r["nlml_end"] < r["nlml_start"],
              f"optimizers {r['optimizer']} {r['dtype']}: NLML {r['nlml_start']} -> "
              f"{r['nlml_end']}")
        check(r["optimizer"] == "lbfgs_device"
              or r["host_syncs_per_iteration"] == r["host_syncs_per_evaluation"],
              f"optimizers {r['optimizer']} {r['dtype']}: {r['host_syncs_per_iteration']} host "
              f"syncs an iteration, the objective's own {r['host_syncs_per_evaluation']}: the "
              "loop reads back more than its objective")
    nb = block_columns()
    for opt, r in op["restarts"].items():
        launched, evals = r["launches"], OPT_ITERS + 1
        check(launched["rbf_gram"] == HMC_RESTARTS * evals
              and launched["block_chol"] >= nb * evals
              and (launched["block_chol"] - nb * evals) % nb == 0,
              f"optimizers restarts {opt}: launches {launched} for {evals} evaluations")
        check(math.isfinite(r["kept"]) and r["kept"] <= min(
            x["nlml_start"] for x in op["runs"]), f"optimizers restarts {opt}: kept {r['kept']}")
    dense = op["dense_slice"]["turns"]
    for opt, rs in dense.items():
        check(all(math.isfinite(r["nlml_end"]) for r in rs),
              f"optimizers dense slice {opt}: non-finite NLML")

    sf = recs["gp_surface"]
    d = sf["dense"]
    check(d["finite"] and d["predictive_gradients_finite"] and d["posterior_samples_finite"]
          and d["log_predictive_density_finite"], f"gp_surface: non-finite output {d}")
    for k, rs in sf["svgp"].items():
        check(all(math.isfinite(r["elbo_last"]) for r in rs), f"gp_surface svgp {k}: {rs}")
    check(sf["infer_newX"]["finite"], f"gp_surface infer_newX: {sf['infer_newX']}")

    b1 = (lv["evaluation"]["rbf_gram_launches"] + auto["rbf_gram_launches"]
          + lv["missing_data"]["rbf_gram_launches"] + lv["scale_point"]["rbf_gram_launches"]
          + tp["rbf_gram_launches"] + tp["rbf_plus_white"]["rbf_gram_launches"] + sum(r["launches"]["rbf_gram"]
                                          for r in op["restarts"].values())
          + d["predictive_gradients_rbf_gram_launches"])
    return {"launches_rbf_gram": b1, "launches_block_chol": op["block_chol_launches"],
            "rbf_gram_checks": lv["rbf_gram_checks"] + recs["tp"]["rbf_gram_checks"],
            "rbf_gram_times": lv["rbf_gram_times"] + recs["tp"]["rbf_gram_times"]}


# --- state space: the Kalman stage of bench.py:764-777 ----------------------

# N=20,000 sorted U(0, 100) times, y = sin(x/3) + 0.2 eps, float32, the
# default Matern32(1), noise 0.1; the sequential engine timed with repeats
# at bench.py's SMOKE size first
SS_N, SS_SMOKE_N, SS_PRED, SS_NOISE = 20_000, 2_000, 2048, 0.1
# the sequential engine is profiled at N=500: its operations a step do not
# depend on N, and at N=2,000 its profile held ~106,000 device events
SS_PROFILE_SEQ_N = 500
SS_DENSE_N, SS_DENSE_PRED = 2048, 256
# the square-root filter's stress case (tests/test_state_space.py:260-282)
SS_STRESS_N, SS_STRESS_NOISE, SS_STRESS_REL = 20_000, 1e-8, 0.15
# float32 against a float64 twin at N=20,000 (NLML relative, gradient
# max|diff| / max|ref|; ~10x the readings on an H100, both engines: NLML
# 1.2e-4, the cancellation in Q = Pinf - A Pinf A' at dt/l ~ 0.005,
# gradient 3.6e-6 and 6.5e-6), parallel against sequential in float64, the
# Kalman NLML against the dense GP's in float64 (its inference adds 1e-8 to
# the noise, which the Kalman model is given), the C++ engine against the
# sequential filter, and rows through the batched objective against
# unbatched evaluation (the same arithmetic)
SS_F32_TOL = {"nlml": 1.2e-3, "grad": 6.5e-5}
SS_EXACT_TOL = {"parallel_vs_sequential_f64": 1e-10, "dense_nlml": 1e-8,
                "dense_predict_mean": 1e-8, "dense_predict_var": 1e-8,
                "cpp_vs_scan_f64": 1e-10, "batched_rows": 1e-10}


def ss_data(n, seed=0):
    """bench.py:766-771's Kalman data at n points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 100, n)).astype(np.float32)
    Y = (np.sin(X / 3.0) + 0.2 * rng.standard_normal(n)).astype(np.float32)
    return X, Y


def ss_model(X, Y, dtype, **kw):
    from gpy_tpu_torch.models import StateSpace

    return StateSpace(X, Y, noise_var=kw.pop("noise_var", SS_NOISE), device="cuda",
                      dtype=dtype, **kw)


def ss_evaluation(m, reps):
    """One NLML+gradient with the counters set to 0 just before it and read
    just after (no kernel of csrc/ is on this path), then `reps` more,
    each timed: (objective, gradient, launches, ms of each)."""
    import torch

    x = m.optimizer_array
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f, g = m._objective_and_grad(x)
    torch.cuda.synchronize()
    times = [(time.perf_counter() - t0) * 1e3]
    launches = counters()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m._objective_and_grad(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(v == 0 for v in launches.values()), f"state space: launches {launches}")
    return f, g, launches, times


def ss_engine(X, Y, Xs, parallel):
    """One engine at N=20,000: NLML+gradient ms (the sequential engine once,
    after two at N=2,000; the parallel one best and median of 3), the
    profile (device operations and ms, idle share) and host syncs (the
    sequential engine's at N=500 and N=2,000, where its loop is the same),
    and a
    float64 twin. Returns (record, (float64 objective, gradient, the raw
    vector they were taken at))."""
    import numpy as np
    import torch

    m = ss_model(X, Y, torch.float32, parallel=parallel)
    rec = {"engine": "parallel" if parallel else "sequential"}
    if parallel:
        f, g, launches, times = ss_evaluation(m, 3)
        prof = profile_objective(m, m.optimizer_array,
                                 what=f"one objective_and_grad, parallel, N={SS_N} float32")
        syncs = host_syncs(lambda: m._objective_and_grad(m.optimizer_array))
        rec.update({"ms_best": min(times[1:]), "ms_median": sorted(times[1:])[1],
                    "ms_first": times[0], "profile_n": SS_N})
    else:
        Xm, Ym = ss_data(SS_SMOKE_N)
        small = ss_model(Xm, Ym, torch.float32)
        _, _, _, t_small = ss_evaluation(small, 1)
        syncs = host_syncs(lambda: small._objective_and_grad(small.optimizer_array))
        Xp, Yp = ss_data(SS_PROFILE_SEQ_N)
        tiny = ss_model(Xp, Yp, torch.float32)
        prof = profile_objective(tiny, tiny.optimizer_array,
                                 what=f"one objective_and_grad, sequential, "
                                      f"N={SS_PROFILE_SEQ_N} float32")
        del small, tiny
        f, g, launches, times = ss_evaluation(m, 0)
        rec.update({"ms_n2000": t_small[1:], "ms_n2000_first": t_small[0], "ms": times[0],
                    "profile_n": SS_PROFILE_SEQ_N})
    m64 = ss_model(X, Y, torch.float64, parallel=parallel)
    t0 = time.perf_counter()
    f64, g64 = m64._objective_and_grad(m.optimizer_array)
    torch.cuda.synchronize()
    ms64 = (time.perf_counter() - t0) * 1e3
    nlml_rel, grad_rel = rel_errors(f, g, f64, g64)
    check(all(math.isfinite(v) for v in (f, f64)) and np.isfinite(g).all()
          and np.isfinite(g64).all(), f"state space {rec['engine']}: non-finite NLML or gradient")
    rec.update({"nlml": f, "nlml_f64": f64, "nlml_rel_f32_vs_f64": nlml_rel,
                "grad_rel_f32_vs_f64": grad_rel, "ms_f64": ms64, "launches": launches,
                "device_ms": prof["device_ms"], "profile_wall_ms": prof["wall_ms"],
                "device_ops": prof["device_ops"], "device_idle_share": prof["device_idle_share"],
                "top": prof["top"][:6], "host_syncs_per_evaluation": len(syncs),
                "host_sync_sites": sorted(set(syncs))})
    if parallel:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mu, var = m.predict(Xs)
        predict_ms = (time.perf_counter() - t0) * 1e3
        rec.update({"predict_n": len(Xs), "predict_steps": len(X) + len(Xs),
                    "predict_ms": predict_ms,
                    "predict_host_syncs": len(host_syncs(lambda: m.predict(Xs))),
                    "predict_finite": bool(np.isfinite(mu).all() and (var > 0).all()),
                    "predict_rmse_vs_sin": float(np.sqrt(np.mean(
                        (mu[:, 0] - np.sin(Xs / 3.0)) ** 2)))})
    x = m.optimizer_array
    del m, m64
    torch.cuda.empty_cache()
    return rec, (f64, g64, x)


def ss_dense_identity():
    """In float64 on 2048 points of the Kalman data: each engine's NLML
    against the dense GPRegression with Matern32 (the Kalman noise is the
    dense inference's noise + 1e-8), and the parallel engine's latent
    predict at 256 points against the dense one's."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import Matern32
    from gpy_tpu_torch.models import GPRegression

    X, Y = ss_data(SS_DENSE_N)
    f64 = torch.float64
    dense = GPRegression(X[:, None].astype(np.float64), Y[:, None].astype(np.float64),
                         Matern32(1, device="cuda", dtype=f64), noise_var=SS_NOISE,
                         device="cuda", dtype=f64)
    with torch.no_grad():
        d_ll = dense.log_likelihood().item()
    Xs = np.sort(np.random.default_rng(1).uniform(0, 100, SS_DENSE_PRED))
    mu_d, var_d = dense.predict(Xs[:, None], include_likelihood=False)
    rec = {"N": SS_DENSE_N, "dtype": "float64", "dense_nlml": -d_ll}
    for parallel in (False, True):
        m = ss_model(X, Y, f64, parallel=parallel, noise_var=SS_NOISE + 1e-8)
        with torch.no_grad():
            ll = m.log_likelihood().item()
        rec[f"nlml_rel_{'parallel' if parallel else 'sequential'}"] = abs(ll - d_ll) / abs(d_ll)
        if parallel:
            mu, var = m.predict(Xs, include_likelihood=False)
            rec["predict_mean_max_abs"] = float(np.max(np.abs(mu - mu_d)))
            rec["predict_var_max_abs"] = float(np.max(np.abs(var - var_d)))
    del dense, m
    torch.cuda.empty_cache()
    return rec


def ss_stress():
    """tests/test_state_space.py:260-282 at N=20,000: Matern52(l=1e4, v=1e3)
    + Matern32(l=1, v=0.5), noise 1e-8. The float64 NLML (by the parallel
    engine, which gives the sequential one's in float64), the sequential
    filter's in float32 and the square-root filter's in float32, each
    forward only, timed."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import Matern32, Matern52

    rg = np.random.default_rng(1)
    X = np.sort(rg.uniform(0, 10.0, SS_STRESS_N))
    Y = np.sin(2 * np.pi * X / 5.0) + 0.05 * rg.standard_normal(SS_STRESS_N)
    rec = {"N": SS_STRESS_N, "noise": SS_STRESS_NOISE}
    for tag, dtype, kw in (("plain_f64", torch.float64, dict(parallel=True)),
                           ("plain_f32", torch.float32, {}),
                           ("stable_f32", torch.float32, dict(stable=True))):
        c = dict(device="cuda", dtype=dtype)
        kern = Matern52(1, lengthscale=1e4, variance=1e3, **c) + Matern32(1, lengthscale=1.0,
                                                                         variance=0.5, **c)
        m = ss_model(X, Y, dtype, kernel=kern, noise_var=SS_STRESS_NOISE, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            ll = m.log_likelihood().item()
        rec[f"nlml_{tag}"] = -ll
        rec[f"ms_{tag}"] = (time.perf_counter() - t0) * 1e3
        del m
    rec["plain_f32_finite"] = math.isfinite(rec["nlml_plain_f32"])
    rec["stable_f32_rel_vs_f64"] = (abs(rec["nlml_stable_f32"] - rec["nlml_plain_f64"])
                                    / abs(rec["nlml_plain_f64"]))
    torch.cuda.empty_cache()
    return rec


def ss_batched_rows():
    """Two rows through _batched_objective_and_grad, each against its
    unbatched evaluation, float64: the parallel StateSpace at N=2,000 and
    TPRegression at N=2048 (ROADMAP C(u)); TP's B1 launches counted."""
    import numpy as np
    import torch
    from gpy_tpu_torch.core.model import value_and_grad

    X, Y = ss_data(SS_SMOKE_N)
    rng = np.random.default_rng(0)
    Xt = rng.random((TP_N, TP_D)) * 4.0
    Yt = np.sin(Xt[:, :1]) + 0.1 * rng.standard_normal((TP_N, 1))
    rec = {}
    for name, m in (("state_space_parallel", ss_model(X, Y, torch.float64, parallel=True)),
                    ("tp", tp_model(Xt, Yt, torch.float64))):
        x0 = m.get_flat_raw()
        rows = x0[None] + 0.05 * torch.as_tensor(rng.standard_normal((2, x0.numel())),
                                                 dtype=x0.dtype, device=x0.device)
        reset_counters()
        v, g = m._batched_objective_and_grad(rows)
        launches = counters()
        err = 0.0
        for c in range(2):
            vc, gc = value_and_grad(m._flat_objective, rows[c])
            err = max(err, abs(v[c].item() - vc.item()) / abs(vc.item()),
                      (torch.max(torch.abs(g[c] - gc)) / torch.max(torch.abs(gc))).item())
        rec[name] = {"rows": 2, "max_rel": err, "launches": launches}
        del m
    torch.cuda.empty_cache()
    return rec


def run_state_space(smi):
    """The state_space phase (bench.py:764-777 at N=20,000): both engines'
    NLML+gradient, predict, the dense identity, the square-root filter's
    stress case, the C++ engine and C(u)'s batched rows. Returns the B1
    launches of the TP rows."""
    import numpy as np
    import torch

    t_start = time.perf_counter()
    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        return out

    X, Y = ss_data(SS_N)
    Xs = np.sort(np.random.default_rng(2).uniform(0, 100, SS_PRED)).astype(np.float32)
    seq, (f64s, g64s, x) = timed("sequential", lambda: ss_engine(X, Y, Xs, parallel=False))
    par, (f64p, g64p, _) = timed("parallel", lambda: ss_engine(X, Y, Xs, parallel=True))
    par_vs_seq = max(abs(f64p - f64s) / abs(f64s),
                     float(np.max(np.abs(g64p - g64s)) / np.max(np.abs(g64s))))
    # the C++ engine on the host, float64, against the sequential filter's
    # float64 NLML at the same parameters
    mc = ss_model(X, Y, torch.float64, engine="cpp")
    mc.set_flat_raw(x)
    mc.log_likelihood()  # builds csrc/kalman.cpp with g++ at first use
    t0 = time.perf_counter()
    nlml_cpp = -mc.log_likelihood().item()
    cpp = {"N": SS_N, "dtype": "float64", "host_seconds": time.perf_counter() - t0,
           "nlml": nlml_cpp, "rel_vs_sequential_f64": abs(nlml_cpp - f64s) / abs(f64s)}
    del mc
    rec = {"phase": "state_space", "N": SS_N, "dtype": "float32", "kernel": "Matern32(1)",
           "noise": SS_NOISE, "sequential": seq, "parallel": par,
           "speedup_parallel_vs_sequential": seq["ms"] / par["ms_best"],
           "parallel_vs_sequential_f64_rel": par_vs_seq,
           "dense_identity": timed("dense_identity", ss_dense_identity),
           "stress": timed("stress", ss_stress), "cpp": cpp,
           "batched_rows": timed("batched_rows", ss_batched_rows), "nvidia_smi": smi}
    rec["seconds"] = time.perf_counter() - t_start
    rec["part_seconds"] = parts
    emit(rec)

    for e in (seq, par):
        for k, tol in SS_F32_TOL.items():
            check(e[f"{k}_rel_f32_vs_f64"] <= tol, f"state space {e['engine']}: float32 vs "
                  f"float64 {k} rel {e[f'{k}_rel_f32_vs_f64']} > {tol}")
    check(par["predict_finite"], "state space: non-finite or non-positive predictions")
    ex = rec["dense_identity"]
    got = {"parallel_vs_sequential_f64": par_vs_seq,
           "dense_nlml": max(ex["nlml_rel_sequential"], ex["nlml_rel_parallel"]),
           "dense_predict_mean": ex["predict_mean_max_abs"],
           "dense_predict_var": ex["predict_var_max_abs"],
           "cpp_vs_scan_f64": cpp["rel_vs_sequential_f64"],
           "batched_rows": max(r["max_rel"] for r in rec["batched_rows"].values())}
    for k, tol in SS_EXACT_TOL.items():
        check(got[k] <= tol, f"state space {k}: {got[k]} > {tol}")
    st = rec["stress"]
    check(math.isfinite(st["nlml_stable_f32"]) and st["stable_f32_rel_vs_f64"] < SS_STRESS_REL,
          f"state space stress: the square-root filter read {st['nlml_stable_f32']} against "
          f"float64's {st['nlml_plain_f64']}")
    tp_rows = rec["batched_rows"]["tp"]["launches"]
    check(tp_rows["rbf_gram"] == 2 * TP_B1 and rec["batched_rows"]["state_space_parallel"][
        "launches"]["rbf_gram"] == 0, f"state space batched rows: launches {rec['batched_rows']}")
    return {"launches_rbf_gram": tp_rows["rbf_gram"]}


# --- the long tail: bench.py:784-813 ----------------------------------------

# bench.py:793-800: GPKroneckerGaussianRegression on a 32 x 24 grid (X1 =
# linspace(0, 3), X2 = linspace(0, 2), RBF(1) x 2, noise 0.05), predicted
# over a 64 x 48 grid; :802-807: GPRegressionGrid on 16 x 12 x 10 axes on
# linspace(0, 3), Y ~ N(0, 1), noise 0.5, predicted over 20 x 15 x 12;
# :809-813: WarpedGP at N=1000, D=2, the default TanhFunction(3), with
# InputWarpedGP on the same data; GPVariationalGaussianApproximation on
# the banana set (BASELINE config 3's data, N=2048, RBF(2), Bernoulli)
LT_KRON, LT_KRON_NOISE, LT_KRON_PRED = (32, 24), 0.05, (64, 48)
LT_GRID, LT_GRID_NOISE, LT_GRID_PRED = (16, 12, 10), 0.5, (20, 15, 12)
LT_WARP_N, LT_WARP_D = 1000, 2
LT_VG_N, LT_VG_ITERS = 2048, 50
LT_KERN_N = 1000
LT_DENSE_JITTER = 1e-8  # exact inference adds it to the noise (inference/exact.py)
# B1 launches an NLML+gradient: one K per RBF axis; one K for the warped GPs
# and VarGauss; four for Symmetric(RBF), SplitKern(RBF) and DEtime (the
# square Gram and the three crosses), one for GridRBF, none for the others
LT_B1 = {"kronecker": 2, "grid": 3, "warped": 1, "input_warped": 1, "var_gauss": 1}
LT_KERN_B1 = {"Symmetric-even": 4, "Symmetric-odd": 4, "SplitKern": 4, "DEtime": 4,
              "GridRBF": 1}
# float32 against a float64 twin at the start, rel NLML / max-relative
# gradient: ~10x the readings on an H100 (Kronecker 1.8e-6 / 1.9e-6, grid
# 3.8e-7 / 2.0e-6, WarpedGP 4.1e-8 / 5.4e-7, InputWarpedGP 2.7e-8 /
# 3.3e-7, VarGauss 8.4e-7 / 2.9e-7; the kernel models 7e-9-2.8e-3 /
# 2.6e-6-3.9e-3, the basis-function and Symmetric models' K ill-conditioned
# at N=1000: cond 6e3-6e5 with the noise 0.1)
LT_F32_TOL = {"kronecker": {"nlml": 2e-5, "grad": 2e-5}, "grid": {"nlml": 4e-6, "grad": 2e-5},
              "warped": {"nlml": 5e-7, "grad": 6e-6},
              "input_warped": {"nlml": 3e-7, "grad": 4e-6},
              "var_gauss": {"nlml": 9e-6, "grad": 3e-6}}
LT_KERN_F32_TOL = {
    "PolynomialBasisFuncKernel": (2.8e-2, 2e-2), "LinearSlopeBasisFuncKernel": (2.4e-3, 5.8e-3),
    "ChangePointBasisFuncKernel": (6.3e-4, 1.5e-3), "DomainKernel": (5.5e-4, 2.2e-3),
    "LogisticBasisFuncKernel": (4e-5, 1.7e-4), "Integral": (4.4e-6, 3.9e-5),
    "Integral_Limits": (1.3e-6, 3.3e-5), "Multidimensional_Integral_Limits": (7e-8, 3.6e-5),
    "Symmetric-even": (3.7e-3, 4e-2), "Symmetric-odd": (5.8e-4, 1.5e-3),
    "SplitKern": (4.4e-6, 8.7e-5), "DEtime": (1.2e-6, 5.8e-5), "GridRBF": (8.8e-6, 2.6e-5)}
# float64 on the card: the grid models against the dense GP on the product
# kernel (ROADMAP C(w): NLML, gradient, latent predict), and batched rows
# against unbatched evaluation (the same arithmetic)
LT_EXACT_TOL = {"dense_nlml": 1e-10, "dense_grad": 1e-8, "dense_predict": 1e-8,
                "batched_rows": 1e-10}


def lt_best_median(fn, reps=3):
    """Best and median ms of `reps` calls, each after a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[0], times[len(times) // 2]


def lt_evaluation(m, m64_fn, what):
    """one_evaluation with the host syncs and the best and median of 3
    timed NLML+gradients."""
    rec, m64 = one_evaluation(m, m64_fn, what)
    with_host_syncs(rec, m)
    x = m.optimizer_array
    rec["ms_best"], rec["ms_median"] = lt_best_median(lambda: m._objective_and_grad(x))
    return rec, m64


def lt_kron_data():
    """bench.py:793-797, float32."""
    import numpy as np

    rng = np.random.default_rng(0)
    n1, n2 = LT_KRON
    X1 = np.linspace(0, 3, n1).reshape(-1, 1).astype(np.float32)
    X2 = np.linspace(0, 2, n2).reshape(-1, 1).astype(np.float32)
    Y = (np.sin(X1) @ np.cos(X2).T + 0.05 * rng.standard_normal((n1, n2))).astype(np.float32)
    return [X1, X2], Y


def lt_grid_data():
    """bench.py:802-806, float32."""
    import numpy as np

    rng = np.random.default_rng(0)
    Xs = [np.linspace(0, 3, n).reshape(-1, 1).astype(np.float32) for n in LT_GRID]
    return Xs, rng.standard_normal(LT_GRID).astype(np.float32)


def lt_grid_model(kind, axes, Y, dtype, noise):
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPKroneckerGaussianRegression, GPRegressionGrid

    c = dict(device="cuda", dtype=dtype)
    if kind == "kronecker":
        return GPKroneckerGaussianRegression(axes[0], axes[1], Y, RBF(1, **c), RBF(1, **c),
                                             noise_var=noise, **c)
    return GPRegressionGrid(axes, Y, noise_var=noise, **c)


def lt_dense(axes, Y, noise):
    """The dense GPRegression on the product of one RBF(1) per axis over
    every grid point, float64, with the noise less the jitter exact
    inference adds; and the points."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import GPRegression

    c = dict(device="cuda", dtype=torch.float64)
    pts = np.stack(np.meshgrid(*[a[:, 0] for a in axes], indexing="ij"), -1).reshape(
        -1, len(axes)).astype(np.float64)
    k = RBF(1, active_dims=[0], **c)
    for d in range(1, len(axes)):
        k = k * RBF(1, active_dims=[d], **c)
    return GPRegression(pts, np.asarray(Y, dtype=np.float64).reshape(-1, 1), k,
                        noise_var=noise - LT_DENSE_JITTER, **c)


def lt_grid_vs_dense(kind, axes, Y, noise, pred_axes):
    """ROADMAP C(w) on the card, float64: the grid model's NLML and gradient
    against the dense GP's (the kernel gradients by raw parameter, the
    noise's with respect to its value), and its predict over a new grid
    against the dense model's latent predict plus the noise."""
    import numpy as np
    import torch

    m = lt_grid_model(kind, axes, Y, torch.float64, noise)
    md = lt_dense(axes, Y, noise)
    f, g = m._objective_and_grad(m.optimizer_array)
    fd, gd = md._objective_and_grad(md.optimizer_array)

    def sig(mod, path):
        return torch.sigmoid(mod.get_raw_dict()[path]).item()

    got = np.append(g[1:], g[0] / sig(m, "noise_var"))
    ref = np.append(gd[:-1], gd[-1] / sig(md, "likelihood.variance"))
    mu, var = m.predict(*pred_axes) if kind == "kronecker" else m.predict(pred_axes)
    pts = np.stack(np.meshgrid(*[a[:, 0] for a in pred_axes], indexing="ij"), -1).reshape(
        -1, len(pred_axes))
    mud, vard = md.predict(pts, include_likelihood=False)
    vard = vard + noise
    out = {"points": int(np.prod(Y.shape)), "nlml_rel": abs(f - fd) / abs(fd),
           "grad_rel": float(np.max(np.abs(got - ref)) / np.max(np.abs(ref))),
           "predict_points": int(pts.shape[0]),
           "predict_rel": max(float(np.max(np.abs(mu.reshape(-1) - mud[:, 0]))
                                    / np.max(np.abs(mud))),
                              float(np.max(np.abs(var.reshape(-1) - vard[:, 0]))
                                    / np.max(np.abs(vard)))),
           "grad": got.tolist(), "grad_dense": ref.tolist()}
    del m, md
    torch.cuda.empty_cache()
    return out


def lt_grid_phase(kind):
    """One grid model at bench.py's shape: one NLML+gradient with the
    counters, best and median of 3, the profile, host syncs and a float64
    twin; predict over the new grid (ms, float32 against float64); the
    float64 identity with the dense GP."""
    import numpy as np
    import torch

    axes, Y = lt_kron_data() if kind == "kronecker" else lt_grid_data()
    noise = LT_KRON_NOISE if kind == "kronecker" else LT_GRID_NOISE
    sizes = LT_KRON_PRED if kind == "kronecker" else LT_GRID_PRED
    pred_axes = [np.linspace(0, 3 if d == 0 or kind == "grid" else 2, n).reshape(-1, 1).astype(
        np.float32) for d, n in enumerate(sizes)]
    m = lt_grid_model(kind, axes, Y, torch.float32, noise)
    rec, m64 = lt_evaluation(m, lambda: lt_grid_model(kind, axes, Y, torch.float64, noise),
                             f"{kind} {'x'.join(map(str, Y.shape))} float32")

    def pred(mm):
        return mm.predict(*pred_axes) if kind == "kronecker" else mm.predict(pred_axes)

    mu, var = pred(m)
    mu64, var64 = pred(m64)
    rec.update({"shape": list(Y.shape), "noise": noise, "predict_grid": list(sizes),
                "predict_ms": host_ms(lambda: pred(m), reps=5, warmup=1),
                "predict_finite": bool(np.isfinite(mu).all() and (var > 0).all()),
                "predict_mean_rel_f32_vs_f64": float(np.max(np.abs(mu - mu64))
                                                     / np.max(np.abs(mu64))),
                "predict_var_rel_f32_vs_f64": float(np.max(np.abs(var - var64))
                                                    / np.max(np.abs(var64)))})
    del m, m64
    torch.cuda.empty_cache()
    rec["dense_f64"] = lt_grid_vs_dense(kind, axes, Y, noise, pred_axes)
    return rec


def lt_batched_rows(m):
    """Two rows through _batched_objective_and_grad against unbatched
    evaluation (float64): max relative error and the launches of the
    batched call."""
    import numpy as np
    import torch
    from gpy_tpu_torch.core.model import value_and_grad

    x0 = m.get_flat_raw()
    rows = x0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((2, x0.numel())), dtype=x0.dtype,
        device=x0.device)
    reset_counters()
    v, g = m._batched_objective_and_grad(rows)
    launches = counters()
    err = 0.0
    for c in range(2):
        vc, gc = value_and_grad(m._flat_objective, rows[c])
        err = max(err, abs(v[c].item() - vc.item()) / abs(vc.item()),
                  (torch.max(torch.abs(g[c] - gc)) / torch.max(torch.abs(gc))).item())
    return {"rows": 2, "max_rel": err, "launches": launches}


def lt_warped_phase(kind):
    """WarpedGP or InputWarpedGP at bench.py:809-813's data: one
    NLML+gradient as lt_evaluation; predict at 1000 new points (WarpedGP:
    the Gauss-Hermite mean, the median and predict_quantiles), ms; two
    batched rows against unbatched evaluation in float64."""
    import numpy as np
    import torch
    from gpy_tpu_torch.models import InputWarpedGP, WarpedGP

    rng = np.random.default_rng(0)
    X = (rng.random((LT_WARP_N, LT_WARP_D)) * 4.0).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((LT_WARP_N, 1))).astype(np.float32)
    Xs = (rng.random((LT_WARP_N, LT_WARP_D)) * 4.0).astype(np.float32)
    cls = WarpedGP if kind == "warped" else InputWarpedGP

    def make(dtype):
        return cls(X, Y, device="cuda", dtype=dtype)

    m = make(torch.float32)
    rec, m64 = lt_evaluation(m, lambda: make(torch.float64), f"{kind}, N={LT_WARP_N} float32")
    mu, var = m.predict(Xs)
    mu64, _ = m64.predict(Xs)
    rec.update({"predict_ms": host_ms(lambda: m.predict(Xs), reps=3, warmup=1),
                "predict_mean_rel_f32_vs_f64": float(np.max(np.abs(mu - mu64))
                                                     / np.max(np.abs(mu64))),
                "pred_rmse_vs_sin": float(np.sqrt(np.mean((mu - np.sin(Xs[:, :1])) ** 2)))})
    finite = [mu, var]
    if kind == "warped":
        med = m.predict(Xs, median=True)
        q = m.predict_quantiles(Xs)
        finite += list(med) + list(q)
        rec.update({"predict_median_ms": host_ms(lambda: m.predict(Xs, median=True), reps=3,
                                                 warmup=1),
                    "predict_quantiles_ms": host_ms(lambda: m.predict_quantiles(Xs), reps=3,
                                                    warmup=1),
                    "quantiles_ordered": bool(np.all(q[0] <= q[1]))})
    rec["predict_finite"] = bool(all(np.isfinite(a).all() for a in finite) and (var > 0).all())
    rec["batched_rows_f64"] = lt_batched_rows(m64)
    del m, m64
    torch.cuda.empty_cache()
    return rec


def lt_var_gauss_phase():
    """GPVariationalGaussianApproximation on the banana set: one
    ELBO+gradient as lt_evaluation; optimize(max_iters=50) in float64 from
    the default start (seconds, evaluations, launches, the objective before
    and after, held-out accuracy on a second draw)."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Bernoulli
    from gpy_tpu_torch.models import GPVariationalGaussianApproximation

    X, Y = banana(np.random.default_rng(0), LT_VG_N)
    Xte, Yte = banana(np.random.default_rng(1), LT_VG_N)

    def make(dtype):
        c = dict(device="cuda", dtype=dtype)
        return GPVariationalGaussianApproximation(X, Y, RBF(2, **c), Bernoulli(**c), **c)

    m = make(torch.float32)
    rec, m64 = lt_evaluation(m, lambda: make(torch.float64), f"var_gauss, N={LT_VG_N} float32")
    del m
    f0 = m64._objective_and_grad(m64.optimizer_array)[0]
    p0, _ = m64.predict(Xte)
    res, evals, secs, launches = timed_optimize(m64, LT_VG_ITERS)
    f1 = m64._objective_and_grad(m64.optimizer_array)[0]
    p1, _ = m64.predict(Xte)
    rec["optimize_f64"] = {
        "max_iters": LT_VG_ITERS, "seconds": secs, "evaluations": evals,
        "rbf_gram_launches": launches["rbf_gram"], "objective_start": f0, "objective_end": f1,
        "scipy_message": res.status,
        "heldout_accuracy_start": float(np.mean((p0 > 0.5) == (Yte > 0.5))),
        "heldout_accuracy_end": float(np.mean((p1 > 0.5) == (Yte > 0.5)))}
    del m64
    torch.cuda.empty_cache()
    return rec


def lt_kernel_models(dtype):
    """(name, GPRegression) for each long-tail kernel at N=1000 on 1-D
    inputs: [t, s] = [x + 0.1, x] bins for Integral_Limits, two such pairs
    for Multidimensional_Integral_Limits, [x, domain index] for SplitKern
    and DEtime."""
    import numpy as np
    import gpy_tpu_torch.kern as tk
    from gpy_tpu_torch.models import GPRegression

    rng = np.random.default_rng(0)
    x = np.sort(rng.random((LT_KERN_N, 1)) * 4.0, axis=0)
    x2 = rng.random((LT_KERN_N, 1)) * 4.0
    Y = np.sin(x) + 0.1 * rng.standard_normal((LT_KERN_N, 1))
    idx = (rng.random((LT_KERN_N, 1)) < 0.5).astype(np.float64)
    c = dict(device="cuda", dtype=dtype)
    bins = np.hstack([x + 0.1, x])
    cases = [
        ("PolynomialBasisFuncKernel", tk.PolynomialBasisFuncKernel(1, 2, **c), x),
        ("LinearSlopeBasisFuncKernel", tk.LinearSlopeBasisFuncKernel(1, 1.0, 3.0, **c), x),
        ("ChangePointBasisFuncKernel", tk.ChangePointBasisFuncKernel(1, 2.0, **c), x),
        ("DomainKernel", tk.DomainKernel(1, 1.0, 3.0, **c), x),
        ("LogisticBasisFuncKernel", tk.LogisticBasisFuncKernel(1, [2.0], **c), x),
        ("Integral", tk.Integral(1, **c), x),
        ("Integral_Limits", tk.Integral_Limits(2, **c), bins),
        ("Multidimensional_Integral_Limits", tk.Multidimensional_Integral_Limits(4, **c),
         np.hstack([bins, x2 + 0.1, x2])),
        ("Symmetric-even", tk.Symmetric(tk.RBF(1, **c), [[-1.0]], "even"), x - 2.0),
        ("Symmetric-odd", tk.Symmetric(tk.RBF(1, **c), [[-1.0]], "odd"), x - 2.0),
        ("SplitKern", tk.SplitKern(tk.RBF(1, lengthscale=0.5, **c), 1.0), np.hstack([x, idx])),
        ("DEtime", tk.DEtime(Xd=2.0, **c), np.hstack([x, idx])),
        ("GridRBF", tk.GridRBF(1, **c), x)]
    return [(name, GPRegression(X, Y, k, noise_var=0.1, **c)) for name, k, X in cases]


def lt_kernels_phase():
    """Each long-tail kernel in a GPRegression at N=1000: one NLML+gradient
    with the counters, its time and a float64 twin (one_evaluation)."""
    import torch

    twins = dict(lt_kernel_models(torch.float64))
    out = {}
    for name, m in lt_kernel_models(torch.float32):
        rec, _ = one_evaluation(m, lambda: twins[name], f"{name} in GPRegression, "
                                f"N={LT_KERN_N} float32")
        out[name] = {k: rec[k] for k in ("objective_and_grad_ms", "rbf_gram_launches", "nlml",
                                         "nlml_rel_f32_vs_f64", "grad_rel_f32_vs_f64",
                                         "device_ops", "device_idle_share")}
    del twins
    torch.cuda.empty_cache()
    return out


def run_longtail(rg, smi):
    """The longtail phase: B1 against its twin at the phase's shapes and
    timed at two of them; the grid models, the warped GPs, VarGauss and
    the long-tail kernels, each record's limits applied after the phase's
    record is printed. Returns B1's launches on these paths, its checks and
    its times."""
    import torch

    t_start = time.perf_counter()
    parts = {}
    b1_checks = [check_rbf_gram(rg, n, n, 1, torch.float32)
                 for n in sorted(set(LT_KRON + LT_GRID), reverse=True)]
    b1_checks += [check_rbf_gram(rg, n, n, d, torch.float32)
                  for n, d in ((LT_WARP_N, LT_WARP_D), (LT_VG_N, 2), (LT_KERN_N, 1))]
    b1_times = [time_rbf_gram(rg, LT_KRON[0], LT_KRON[0], 1),
                time_rbf_gram(rg, LT_WARP_N, LT_WARP_N, LT_WARP_D)]

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        return out

    rec = {"phase": "longtail", "dtype": "float32",
           "kronecker": timed("kronecker", lambda: lt_grid_phase("kronecker")),
           "grid": timed("grid", lambda: lt_grid_phase("grid")),
           "warped": timed("warped", lambda: lt_warped_phase("warped")),
           "input_warped": timed("input_warped", lambda: lt_warped_phase("input_warped")),
           "var_gauss": timed("var_gauss", lt_var_gauss_phase),
           "kernels": timed("kernels", lt_kernels_phase),
           "rbf_gram_launches_expected": {"models": LT_B1, "kernels": LT_KERN_B1},
           "f32_limits": {"models": LT_F32_TOL, "kernels": LT_KERN_F32_TOL},
           "float64_limits": LT_EXACT_TOL, "rbf_gram_checks": b1_checks,
           "rbf_gram_times": b1_times, "nvidia_smi": smi}
    rec["seconds"] = time.perf_counter() - t_start
    rec["part_seconds"] = parts
    emit(rec)

    for name in LT_B1:
        r = rec[name]
        check(r["rbf_gram_launches"] == LT_B1[name],
              f"longtail {name}: {r['rbf_gram_launches']} B1 launches, not {LT_B1[name]}")
        for k, tol in LT_F32_TOL[name].items():
            check(r[f"{k}_rel_f32_vs_f64"] <= tol,
                  f"longtail {name}: float32 vs float64 {k} rel {r[f'{k}_rel_f32_vs_f64']} > "
                  f"{tol}")
    for name in ("kronecker", "grid"):
        d = rec[name]["dense_f64"]
        check(rec[name]["predict_finite"], f"longtail {name}: non-finite or non-positive predict")
        for k in ("nlml", "grad", "predict"):
            check(d[f"{k}_rel"] <= LT_EXACT_TOL[f"dense_{k}"],
                  f"longtail {name}: float64 {k} against the dense GP rel {d[f'{k}_rel']} > "
                  f"{LT_EXACT_TOL[f'dense_{k}']} (ROADMAP C(w))")
    for name in ("warped", "input_warped"):
        r = rec[name]
        check(r["predict_finite"], f"longtail {name}: non-finite or non-positive predict")
        check(r["batched_rows_f64"]["max_rel"] <= LT_EXACT_TOL["batched_rows"]
              and r["batched_rows_f64"]["launches"]["rbf_gram"] == 2 * LT_B1[name],
              f"longtail {name} batched rows: {r['batched_rows_f64']}")
    check(rec["warped"]["quantiles_ordered"], "longtail warped: quantiles out of order")
    vg = rec["var_gauss"]["optimize_f64"]
    check(vg["objective_end"] < vg["objective_start"]
          and vg["rbf_gram_launches"] == LT_B1["var_gauss"] * vg["evaluations"],
          f"longtail var_gauss optimize: {vg}")
    for name, r in rec["kernels"].items():
        check(r["rbf_gram_launches"] == LT_KERN_B1.get(name, 0),
              f"longtail kernel {name}: {r['rbf_gram_launches']} B1 launches")
        for k, tol in zip(("nlml", "grad"), LT_KERN_F32_TOL[name]):
            check(r[f"{k}_rel_f32_vs_f64"] <= tol,
                  f"longtail kernel {name}: float32 vs float64 {k} rel "
                  f"{r[f'{k}_rel_f32_vs_f64']} > {tol}")
    b1 = (sum(rec[n]["rbf_gram_launches"] for n in LT_B1)
          + sum(r["rbf_gram_launches"] for r in rec["kernels"].values()))
    return {"launches_rbf_gram": b1, "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


# --- latent-force and symbolic models: A15's rest ----------------------------

# bench.py and BASELINE.json have no shape for these families; chosen here as
# the workloads latent-force models are used on, a few hundred frames by
# tens of outputs (motion-capture joint angles, gene-expression time
# courses). T times an output on linspace(0.1, 10, T); R latent forces
# sin((q+1) t/2 + phi_q); y_d = sum_q S_dq u_q + 0.05 eps, S ~ N(0, 1) with
# all but 2 forces of each output zeroed. The wofz-based models (EQ_ODE2,
# IBPLFM) run in float64 (ROADMAP C(c)), their float32 / complex64 reading
# recorded, not held; so is EQ_ODE1's.
LFM2_D, LFM2_T, LFM2_R, LFM2_PRED, LFM2_SUB = 4, 250, 2, 100, 50
LFM1_D, LFM1_T, LFM1_R, LFM1_MZ, LFM1_ITERS = 20, 100, 3, 20, 20
IBP_D, IBP_T, IBP_R, IBP_M, IBP_ITERS = 20, 100, 5, 50, 100
UY_PAIRS, UY_LONG_T, ST_GRID = 500, 1000.0, (25, 20)
# the identities held in float64 on the card: the card against the port's
# CPU evaluation on a 4 x 50 subset, Kdiag_per_force against diag(K), rows
# through the batched objective against unbatched evaluation, ODE_UY's
# gradient at T = 1000 against central differences (C(ab)), the symbolic
# kernel against RBF(2) and the symbolic Student-t against StudentT
LFM_EXACT_TOL = {"cpu_vs_card": 1e-10, "kdiag": 1e-10, "batched_rows": 1e-10,
                 "uy_central_differences": 1e-6, "symbolic_vs_rbf": 1e-12,
                 "symbolic_vs_studentt": 1e-10}
# float32 against a float64 twin, rel NLML / max-relative gradient, held for
# the ODE_UY family and the symbolic Student-t: ~10x the readings on an H100
# (ODE_UY 4.1e-4 / 1.7e-4, ODE_UYC 6.1e-5 / 4.6e-5, ODE_t 5.0e-6 / 1.1e-5,
# ODE_st 3.9e-5 / 1.2e-5, the symbolic Student-t 9.2e-7 / 4.8e-6)
LFM_F32_TOL = {"ode_uy": (4e-3, 2e-3), "ode_uyc": (6e-4, 5e-4), "ode_t": (5e-5, 1.2e-4),
               "ode_st": (4e-4, 1.2e-4), "symbolic_lik": (1e-5, 5e-5)}
# B1 launches an NLML+gradient: the RBF twin of the symbolic kernel and the
# symbolic likelihood's Laplace model one each; the ODE models, IBPLFM and
# Symbolic none
LFM_B1 = {"symbolic_rbf_twin": 1, "symbolic_lik": 1}


def lfm_data(D, T, R, seed):
    """X = [t, output] rows, Y (D*T, 1), the mixing S (D, R) with all but 2
    forces of each output zeroed (every force kept where R <= 2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.1, 10.0, T)
    phi = rng.uniform(0.0, 2 * np.pi, R)
    U = np.sin((np.arange(R)[:, None] + 1) * t[None, :] / 2 + phi[:, None])
    S = rng.standard_normal((D, R))
    if R > 2:
        for d in range(D):
            S[d, rng.permutation(R)[2:]] = 0.0
    Y = S @ U + 0.05 * rng.standard_normal((D, T))
    X = np.vstack([np.stack([t, np.full(T, float(d))], 1) for d in range(D)])
    return X, Y.reshape(-1, 1), S


def lfm_evaluation(m, what, reps=3):
    """One NLML+gradient of m with the counters set to 0 just before it and
    read just after, the peak device memory it took, the index-column host
    reads it made, best and median of `reps` timed ones, its profile and its
    host syncs. Returns (record, objective, gradient)."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import eq_ode1

    x = m.optimizer_array
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reads = eq_ode1.index_reads
    reset_counters()
    t0 = time.perf_counter()
    f, g = m._objective_and_grad(x)
    launches = counters()
    torch.cuda.synchronize()
    rec = {"nlml": f, "first_call_ms": (time.perf_counter() - t0) * 1e3, "launches": launches,
           "index_reads": eq_ode1.index_reads - reads,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_mem_above_start_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    check(math.isfinite(f) and np.isfinite(g).all(), f"{what}: non-finite NLML or gradient")
    rec["ms_best"], rec["ms_median"] = lt_best_median(lambda: m._objective_and_grad(x), reps)
    prof = profile_objective(m, x, what=f"one objective_and_grad, {what}")
    rec.update({"device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
                "device_ops": prof["device_ops"], "device_idle_share": prof["device_idle_share"],
                "top": prof["top"][:6]})
    with_host_syncs(rec, m)
    return rec, f, g


def f32_reading(build, x, f64, g64):
    """rel NLML and max-relative gradient of the float32 model `build()` at
    the raw vector x against the float64 (f64, g64)."""
    import numpy as np

    m32 = build()
    f32, g32 = m32._objective_and_grad(x.astype(np.float32))
    nlml_rel, grad_rel = rel_errors(f32, g32, f64, g64)
    return {"nlml_f32": f32, "nlml_rel_f32_vs_f64": nlml_rel, "grad_rel_f32_vs_f64": grad_rel}


def lfm_eq_ode2_phase():
    """GPRegression over EQ_ODE2 at 4 outputs x 250 times, rank 2, float64:
    one NLML+gradient (lfm_evaluation), predict at 4 x 100 new times,
    Kdiag_per_force against diag(K), K + noise I positive definite, the
    card against the port's CPU evaluation on a 4 x 50 subset, and the
    float32 reading."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import EQ_ODE2
    from gpy_tpu_torch.models import GPRegression

    X, Y, _ = lfm_data(LFM2_D, LFM2_T, LFM2_R, seed=2)

    def make(X, Y, device="cuda", dtype=torch.float64):
        c = dict(device=device, dtype=dtype)
        return GPRegression(X, Y, EQ_ODE2(output_dim=LFM2_D, rank=LFM2_R, **c), noise_var=0.1, **c)

    m = make(X, Y)
    rec, f, g = lfm_evaluation(m, f"EQ_ODE2 GPRegression, N={len(X)} float64")
    x = m.optimizer_array
    ts = np.linspace(0.2, 9.8, LFM2_PRED)
    Xs = np.vstack([np.stack([ts, np.full_like(ts, d)], 1) for d in range(LFM2_D)])
    t0 = time.perf_counter()
    mu, var = m.predict(Xs)
    torch.cuda.synchronize()
    rec["predict_ms"] = (time.perf_counter() - t0) * 1e3
    rec["predict_finite"] = bool(np.isfinite(mu).all() and np.isfinite(var).all() and (var > 0).all())
    Xt = m.X
    with torch.no_grad():
        K = m.kern.K(Xt)
        kd = m.kern.Kdiag(Xt)
        dK = torch.diagonal(K)
        rec["kdiag_rel"] = float((kd - dK).abs().max() / dK.abs().max())
        Ky = K + float(m.likelihood.variance) * torch.eye(len(X), dtype=K.dtype, device=K.device)
        rec["noisy_gram_pd"] = int(torch.linalg.cholesky_ex(Ky).info) == 0
        rec["K_min_eig"] = float(torch.linalg.eigvalsh(0.5 * (K + K.T)).min())
        rec["K_asymmetry"] = float((K - K.T).abs().max() / K.abs().max())
    del K, Ky
    sub = np.concatenate([np.arange(d * LFM2_T, d * LFM2_T + LFM2_T, LFM2_T // LFM2_SUB)
                          for d in range(LFM2_D)])
    m_card, m_cpu = make(X[sub], Y[sub]), make(X[sub], Y[sub], device="cpu")
    fc, gc = m_card._objective_and_grad(x)
    t0 = time.perf_counter()
    fh, gh = m_cpu._objective_and_grad(x)
    rec["cpu_vs_card"] = {"rows": len(sub), "cpu_seconds": time.perf_counter() - t0,
                          "nlml_rel": abs(fc - fh) / abs(fh),
                          "grad_rel": float(np.max(np.abs(gc - gh)) / np.max(np.abs(gh)))}
    rec["float32"] = f32_reading(lambda: make(X, Y, dtype=torch.float32), x, f, g)
    del m, m_card, m_cpu
    torch.cuda.empty_cache()
    return rec


def lfm_eq_ode1_phase():
    """SparseGPRegression over EQ_ODE1 at 20 outputs x 100 times, rank 3, Z
    = 20 inducing times a force on the latent-force rows (M = 60), float64:
    one NLML+gradient, optimize(max_iters=20) (the reference raises there,
    C(ad)), the float32 reading."""
    import numpy as np
    import torch
    from gpy_tpu_torch.kern import EQ_ODE1
    from gpy_tpu_torch.models import SparseGPRegression

    X, Y, _ = lfm_data(LFM1_D, LFM1_T, LFM1_R, seed=1)
    tz = np.linspace(0.1, 10.0, LFM1_MZ)
    Z = np.vstack([np.stack([tz, np.full_like(tz, LFM1_D + q)], 1) for q in range(LFM1_R)])

    def make(dtype=torch.float64):
        c = dict(device="cuda", dtype=dtype)
        return SparseGPRegression(X, Y, Z=Z, kernel=EQ_ODE1(output_dim=LFM1_D, rank=LFM1_R, **c),
                                  noise_var=0.1, **c)

    m = make()
    rec, f, g = lfm_evaluation(m, f"EQ_ODE1 SparseGPRegression, N={len(X)}, M={len(Z)} float64")
    x = m.optimizer_array
    rec["float32"] = f32_reading(lambda: make(torch.float32), x, f, g)
    res, evals, secs, _ = timed_optimize(m, LFM1_ITERS)
    f1 = m._objective_and_grad(m.optimizer_array)[0]
    rec["optimize"] = {"max_iters": LFM1_ITERS, "seconds": secs, "evaluations": evals,
                       "nlml_start": f, "nlml_end": f1, "scipy_message": res.status}
    del m
    torch.cuda.empty_cache()
    return rec


def lfm_ibp_phase():
    """IBPLFM at 20 outputs x 100 times, R = 5, num_inducing=50, float64:
    one NLML+gradient, two rows through the batched objective against
    unbatched evaluation (the gated bound, not VarDTC's), optimize(
    max_iters=100) with the gates it finds, the float32 reading."""
    import numpy as np
    import torch
    from gpy_tpu_torch.models import IBPLFM

    X, Y, S = lfm_data(IBP_D, IBP_T, IBP_R, seed=3)

    def make(dtype=torch.float64):
        return IBPLFM(X, Y, input_dim=2, output_dim=IBP_D, rank=IBP_R, num_inducing=IBP_M,
                      device="cuda", dtype=dtype)

    m = make()
    rec, f, g = lfm_evaluation(m, f"IBPLFM, N={len(X)}, R={IBP_R}, M={IBP_M} float64")
    x = m.optimizer_array
    rec["float32"] = f32_reading(lambda: make(torch.float32), x, f, g)
    rec["batched_rows_f64"] = lt_batched_rows(m)
    m.set_flat_raw(x)
    res, evals, secs, _ = timed_optimize(m, IBP_ITERS)
    f1 = m._objective_and_grad(m.optimizer_array)[0]
    gates = m.gates
    drives = S != 0.0
    top2 = np.argsort(-gates, axis=1)[:, :2]
    hit = sum(int(drives[d, q]) for d in range(IBP_D) for q in top2[d])
    rec["optimize"] = {
        "max_iters": IBP_ITERS, "seconds": secs, "evaluations": evals, "nlml_start": f,
        "nlml_end": f1, "scipy_message": res.status, "gates": gates.round(4).tolist(),
        "open_gates_per_output_mean": float(np.mean(np.sum(gates > 0.5, axis=1))),
        "true_forces_among_two_largest_gates_share": hit / (2 * IBP_D),
        "note": "the learned forces are identified up to a permutation; the share matches "
                "force indices literally"}
    del m
    torch.cuda.empty_cache()
    return rec


def uy_data(T_end, seed=0):
    """UY_PAIRS times on linspace(0, T_end): U = sin t, Y the response of
    dy/dt + y = U from y(0) = 0, each plus 0.05 eps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, T_end, UY_PAIRS)[:, None]
    y = (np.sin(t) - np.cos(t) + np.exp(-t)) / 2
    return t, np.sin(t) + 0.05 * rng.standard_normal(t.shape), y + 0.05 * rng.standard_normal(t.shape)


def uy_models(dtype, T_end=10.0):
    """GPRegression over ODE_UY, ODE_UYC and ODE_t on the U/Y pairs (U rows
    index 0 for ODE_UY and ODE_UYC, 1 for ODE_t) and over ODE_st on a 25 x
    20 (t, x) grid with both indices."""
    import numpy as np
    import gpy_tpu_torch.kern as tk
    from gpy_tpu_torch.models import GPRegression

    c = dict(device="cuda", dtype=dtype)
    t, u, y = uy_data(T_end)
    z, o = np.zeros_like(t), np.ones_like(t)
    X_uy = np.vstack([np.hstack([t, z]), np.hstack([t, o])])
    X_t = np.vstack([np.hstack([t, o]), np.hstack([t, z])])
    UY = np.vstack([u, y])
    tg, xg = np.meshgrid(np.linspace(0, 3, ST_GRID[0]), np.linspace(0, 2, ST_GRID[1]), indexing="ij")
    tg, xg = tg.reshape(-1, 1), xg.reshape(-1, 1)
    ust = np.sin(tg) * np.cos(xg)
    X_st = np.vstack([np.hstack([tg, xg, np.zeros_like(tg)]), np.hstack([tg, xg, np.ones_like(tg)])])
    Y_st = np.vstack([ust, ust + 0.5 * np.cos(tg) * np.cos(xg)])
    return {"ode_uy": GPRegression(X_uy, UY, tk.ODE_UY(2, **c), noise_var=0.1, **c),
            "ode_uyc": GPRegression(X_uy, UY, tk.ODE_UYC(2, **c), noise_var=0.1, **c),
            "ode_t": GPRegression(X_t, UY, tk.ODE_t(2, **c), noise_var=0.1, **c),
            "ode_st": GPRegression(X_st, Y_st, tk.ODE_st(3, **c), noise_var=0.1, **c)}


def lfm_uy_phase():
    """Each ODE_UY-family model: one float32 NLML+gradient against a float64
    twin (one_evaluation) with its host syncs; ODE_UY at T = 1000 in
    float64: every gradient entry finite and equal to central differences of
    the NLML (C(ab))."""
    import numpy as np
    import torch

    twins = uy_models(torch.float64)
    out = {}
    for name, m in uy_models(torch.float32).items():
        rec, _ = one_evaluation(m, lambda: twins[name], f"{name} GPRegression, "
                                f"N={m.num_data} float32")
        out[name] = with_host_syncs({k: rec[k] for k in (
            "objective_and_grad_ms", "objective_and_grad_ms_f64", "rbf_gram_launches", "nlml",
            "nlml_rel_f32_vs_f64", "grad_rel_f32_vs_f64", "device_ops", "device_idle_share")}, m)
    del twins
    m = uy_models(torch.float64, UY_LONG_T)["ode_uy"]
    x = m.optimizer_array
    f, g = m._objective_and_grad(x)
    h = 1e-5
    fd = np.array([(m._objective_and_grad(x + h * e)[0] - m._objective_and_grad(x - h * e)[0])
                   / (2 * h) for e in np.eye(x.size)])
    out["ode_uy_long_range_f64"] = {
        "T": UY_LONG_T, "rows": m.num_data, "nlml": f, "grad": g.tolist(),
        "grad_finite": bool(np.isfinite(g).all()),
        "rel_vs_central_differences": float(np.max(np.abs(g - fd)) / np.max(np.abs(g)))}
    torch.cuda.empty_cache()
    return out


def _sym_kernel_exprs():
    """The RBF of RBF(2) as a sympy expression, and the same times
    sqrt(2) log(2), whose constants torch's functions refuse as numbers."""
    import sympy

    x0, x1, z0, z1, v, l = sympy.symbols("x_0 x_1 z_0 z_1 v l")
    rbf = v * sympy.exp(-((x0 - z0) ** 2 + (x1 - z1) ** 2) / (2 * l ** 2))
    return rbf, sympy.sqrt(2) * sympy.log(2) * rbf


def _student_t_logpdf():
    """log of the Student-t density with a literal nu = 4 and scale s."""
    import sympy

    f, y = sympy.symbols("f y")
    s = sympy.Symbol("s", positive=True)
    nu = sympy.Integer(4)
    return (sympy.loggamma((nu + 1) / 2) - sympy.loggamma(nu / 2)
            - sympy.log(nu * sympy.pi * s) / 2
            - (nu + 1) / 2 * sympy.log(1 + (y - f) ** 2 / (nu * s)))


def lfm_symbolic_phase():
    """The symbolic kernel in a GPRegression at bench.py:847-853's HMC data
    (N=1000, D=2) against the port's RBF(2) at the same parameters (float64,
    NLML and gradient), its constant-carrying variant against RBF(2) with
    the variance scaled, and each model's NLML+gradient ms; the symbolic
    Student-t (nu = 4) under Laplace with RBF on the same data with 5% of Y
    replaced by outliers, against StudentT(deg_free=4) (float64), float32
    against float64, optimize(max_iters=20) in float64."""
    import numpy as np
    import torch
    from gpy_tpu_torch.core.gp import GP
    from gpy_tpu_torch.inference.laplace import Laplace
    from gpy_tpu_torch.kern import RBF, Symbolic
    from gpy_tpu_torch.likelihoods import StudentT, SymbolicLikelihood
    from gpy_tpu_torch.models import GPRegression

    X, Y = hmc_data()
    c64 = dict(device="cuda", dtype=torch.float64)
    rbf_expr, const_expr = _sym_kernel_exprs()
    v, l = 1.3, 0.7
    scale = float(np.sqrt(2) * np.log(2))
    out = {}
    m_rbf = GPRegression(X, Y, RBF(2, variance=v, lengthscale=l, **c64), noise_var=0.1, **c64)
    x_rbf = m_rbf.optimizer_array
    f_rbf, g_rbf = m_rbf._objective_and_grad(x_rbf)
    reset_counters()
    m_rbf._objective_and_grad(x_rbf)
    b1_rbf = counters()["rbf_gram"]
    out["rbf_twin"] = {"nlml": f_rbf, "rbf_gram_launches": b1_rbf,
                       "ms_best_median": lt_best_median(lambda: m_rbf._objective_and_grad(x_rbf))}
    for name, expr, twin_v in (("symbolic", rbf_expr, v), ("symbolic_constants", const_expr,
                                                            v * scale)):
        ms = GPRegression(X, Y, Symbolic(2, k=expr, parameters={"v": v, "l": l}, **c64),
                          noise_var=0.1, **c64)
        xs = ms.optimizer_array  # [l, v, noise]: the parameters sorted by name
        reset_counters()
        fs, gs = ms._objective_and_grad(xs)
        launches = counters()
        if twin_v == v:
            ft, gt = f_rbf, g_rbf
        else:
            mt = GPRegression(X, Y, RBF(2, variance=twin_v, lengthscale=l, **c64), noise_var=0.1,
                              **c64)
            ft, gt = mt._objective_and_grad(mt.optimizer_array)
            del mt
        # the twin's [variance, lengthscale, noise] as the symbolic model's [l, v, noise]; v's
        # raw gradient through Logexp (dv/draw = 1 - e^{-v}) and the scale
        gt = gt[[1, 0, 2]]
        gt[1] *= (twin_v / v) * (-math.expm1(-v)) / (-math.expm1(-twin_v))
        out[name] = {"nlml": fs, "launches": launches,
                     "nlml_rel_vs_rbf": abs(fs - ft) / abs(ft),
                     "grad_rel_vs_rbf": float(np.max(np.abs(gs - gt)) / np.max(np.abs(gt))),
                     "ms_best_median": lt_best_median(lambda: ms._objective_and_grad(xs))}
        del ms
    # the symbolic Student-t under Laplace
    rng = np.random.default_rng(4)
    Yo = Y.astype(np.float64).copy()
    idx = rng.permutation(len(Yo))[: len(Yo) // 20]
    Yo[idx] = rng.uniform(-3.0, 3.0, (len(idx), 1))

    def make(lik_kind, dtype):
        c = dict(device="cuda", dtype=dtype)
        lik = (SymbolicLikelihood(_student_t_logpdf(), parameters={"s": 0.1}, **c)
               if lik_kind == "symbolic" else StudentT(deg_free=4.0, sigma2=0.1, **c))
        return GP(X, Yo, RBF(2, **c), lik, inference_method=Laplace(), **c)

    m = make("symbolic", torch.float64)
    rec, f, g = lfm_evaluation(m, f"symbolic Student-t under Laplace, N={len(X)} float64")
    x = m.optimizer_array
    ft, gt = make("studentt", torch.float64)._objective_and_grad(x)
    rec["nlml_rel_vs_studentt"] = abs(f - ft) / abs(ft)
    rec["grad_rel_vs_studentt"] = float(np.max(np.abs(g - gt)) / np.max(np.abs(gt)))
    rec["float32"] = f32_reading(lambda: make("symbolic", torch.float32), x, f, g)
    res, evals, secs, launches = timed_optimize(m, 20)
    f1 = m._objective_and_grad(m.optimizer_array)[0]
    rec["optimize_f64"] = {"max_iters": 20, "seconds": secs, "evaluations": evals,
                           "rbf_gram_launches": launches["rbf_gram"], "nlml_start": f,
                           "nlml_end": f1, "scipy_message": res.status}
    out["symbolic_lik"] = rec
    del m, m_rbf
    torch.cuda.empty_cache()
    return out


def run_lfm_symbolic(rg, smi):
    """The lfm_symbolic phase: B1 against its twin at the symbolic models'
    shape; EQ_ODE2 dense, EQ_ODE1 sparse, IBPLFM, the ODE_UY family, the
    symbolic kernel and likelihood, each record's limits applied after the
    phase's record is printed. Returns B1's launches on these paths, its
    checks and its times."""
    import torch

    t_start = time.perf_counter()
    parts = {}
    b1_checks = [check_rbf_gram(rg, HMC_N, HMC_N, HMC_D, dt) for dt in (torch.float32,
                                                                        torch.float64)]
    b1_times = [time_rbf_gram(rg, HMC_N, HMC_N, HMC_D)]

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        parts[name] = time.perf_counter() - t0
        return out

    rec = {"phase": "lfm_symbolic", "dtype": "float64 (float32 readings beside)",
           "eq_ode2": timed("eq_ode2", lfm_eq_ode2_phase),
           "eq_ode1": timed("eq_ode1", lfm_eq_ode1_phase),
           "ibplfm": timed("ibplfm", lfm_ibp_phase),
           "ode_uy_family": timed("ode_uy_family", lfm_uy_phase),
           "symbolic": timed("symbolic", lfm_symbolic_phase),
           "exact_limits": LFM_EXACT_TOL, "f32_limits": LFM_F32_TOL,
           "rbf_gram_launches_expected": LFM_B1, "rbf_gram_checks": b1_checks,
           "rbf_gram_times": b1_times, "nvidia_smi": smi}
    rec["seconds"] = time.perf_counter() - t_start
    rec["part_seconds"] = parts
    emit(rec)

    e2, e1, ibp = rec["eq_ode2"], rec["eq_ode1"], rec["ibplfm"]
    for name, r in (("eq_ode2", e2), ("eq_ode1", e1), ("ibplfm", ibp)):
        check(all(v == 0 for v in r["launches"].values()),
              f"lfm {name}: launches of the port's kernels {r['launches']}")
    check(e2["predict_finite"], "lfm eq_ode2: non-finite or non-positive predict")
    check(e2["kdiag_rel"] <= LFM_EXACT_TOL["kdiag"],
          f"lfm eq_ode2: Kdiag_per_force against diag(K) rel {e2['kdiag_rel']}")
    check(e2["noisy_gram_pd"], "lfm eq_ode2: K + noise I is not positive definite")
    cc = e2["cpu_vs_card"]
    check(max(cc["nlml_rel"], cc["grad_rel"]) <= LFM_EXACT_TOL["cpu_vs_card"],
          f"lfm eq_ode2: the card against the CPU {cc}")
    for name, r in (("eq_ode1", e1), ("ibplfm", ibp)):
        o = r["optimize"]
        check(o["nlml_end"] < o["nlml_start"], f"lfm {name} optimize: the bound fell {o}")
    br = ibp["batched_rows_f64"]
    check(br["max_rel"] <= LFM_EXACT_TOL["batched_rows"] and all(
        v == 0 for v in br["launches"].values()), f"lfm ibplfm batched rows: {br}")
    fam = rec["ode_uy_family"]
    for name in ("ode_uy", "ode_uyc", "ode_t", "ode_st"):
        r = fam[name]
        check(r["rbf_gram_launches"] == 0, f"lfm {name}: {r['rbf_gram_launches']} B1 launches")
        for k, tol in zip(("nlml", "grad"), LFM_F32_TOL[name]):
            check(r[f"{k}_rel_f32_vs_f64"] <= tol,
                  f"lfm {name}: float32 vs float64 {k} rel {r[f'{k}_rel_f32_vs_f64']} > {tol}")
    lr = fam["ode_uy_long_range_f64"]
    check(lr["grad_finite"] and lr["rel_vs_central_differences"]
          <= LFM_EXACT_TOL["uy_central_differences"], f"lfm ode_uy at T = {UY_LONG_T}: {lr}")
    sym = rec["symbolic"]
    check(sym["rbf_twin"]["rbf_gram_launches"] == LFM_B1["symbolic_rbf_twin"],
          f"lfm symbolic: the RBF twin made {sym['rbf_twin']['rbf_gram_launches']} B1 launches")
    for name in ("symbolic", "symbolic_constants"):
        r = sym[name]
        check(all(v == 0 for v in r["launches"].values()), f"lfm {name}: launches {r['launches']}")
        check(max(r["nlml_rel_vs_rbf"], r["grad_rel_vs_rbf"]) <= LFM_EXACT_TOL["symbolic_vs_rbf"],
              f"lfm {name} against RBF(2): {r}")
    sl = sym["symbolic_lik"]
    check(sl["launches"]["rbf_gram"] == LFM_B1["symbolic_lik"],
          f"lfm symbolic likelihood: {sl['launches']['rbf_gram']} B1 launches")
    check(max(sl["nlml_rel_vs_studentt"], sl["grad_rel_vs_studentt"])
          <= LFM_EXACT_TOL["symbolic_vs_studentt"], "lfm symbolic likelihood against StudentT: "
          f"{sl['nlml_rel_vs_studentt']}, {sl['grad_rel_vs_studentt']}")
    for k, tol in zip(("nlml", "grad"), LFM_F32_TOL["symbolic_lik"]):
        v = sl["float32"][f"{k}_rel_f32_vs_f64"]
        check(v <= tol, f"lfm symbolic likelihood: float32 vs float64 {k} rel {v} > {tol}")
    o = sl["optimize_f64"]
    check(o["nlml_end"] < o["nlml_start"]
          and o["rbf_gram_launches"] == LFM_B1["symbolic_lik"] * o["evaluations"],
          f"lfm symbolic likelihood optimize: {o}")
    b1 = (sym["rbf_twin"]["rbf_gram_launches"] + sl["launches"]["rbf_gram"]
          + o["rbf_gram_launches"])
    return {"launches_rbf_gram": b1, "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times}


def run_svgp(rg, smi):
    """The flagship main path: SVGP.fit at bench.py's configuration, uncut.
    bench.py's warm-up (two fit(iters=100)) with the counters set to 0 just
    before the first and read just after (2 B1 launches a step: Kmm and
    Kmn), then fit(iters=500) timed SVGP_REPS times; the profile, the
    float64 twin, the collapsed-bound oracles, the whitened and plain
    steps, and predict."""
    import numpy as np
    import torch

    b1_checks = [check_rbf_gram(rg, SVGP_M, SVGP_M, SVGP_D, torch.float32),
                 check_rbf_gram(rg, SVGP_M, SVGP_B, SVGP_D, torch.float32)]
    b1_times = [time_rbf_gram(rg, SVGP_M, n, SVGP_D) for n in (SVGP_M, SVGP_B)]

    X, Y, Z = svgp_data()
    m = svgp_model(X, Y, Z, torch.float32)
    reset_counters()
    tr0, first_s = timed_fit(m, SVGP_WARM)
    launches = counters()
    check(launches["rbf_gram"] == 2 * SVGP_WARM,
          f"svgp: {launches['rbf_gram']} rbf_gram launches in {SVGP_WARM} steps, not 2 a step")
    check(all(v == 0 for k, v in launches.items() if k != "rbf_gram"),
          f"svgp: unexpected launches {launches}")
    check(tr0[-1] > tr0[0], f"svgp: the ELBO fell over the first fit ({tr0[0]} -> {tr0[-1]})")
    timed_fit(m, SVGP_WARM)
    f32_errs, low_errs = svgp_f32_vs_f64(m, X, Y, Z)
    torch.cuda.empty_cache()
    times, last = [], None
    for _ in range(SVGP_REPS):
        last, dt = timed_fit(m, SVGP_STEPS)
        times.append(dt)
    check(last[-1] > tr0[0], f"svgp: the ELBO fell over the run ({tr0[0]} -> {last[-1]})")
    times.sort()
    syncs = {n: fit_host_syncs(m, n) for n in (5, 10)}
    check(syncs[10] <= syncs[5], f"svgp: host syncs grow with the steps of fit: {syncs}")
    prof = profile_svgp(m, rg)

    Xs = np.random.default_rng(2).random((SVGP_PRED, SVGP_D)).astype(np.float32) * 4.0
    mu, var = m.predict(Xs)
    check(mu.shape == var.shape == (SVGP_PRED, 1) and np.isfinite(mu).all()
          and np.isfinite(var).all() and (var > 0).all(), "svgp: bad predictions")
    truth = np.sin(Xs[:, :1])
    rmse = float(np.sqrt(np.mean((mu - truth) ** 2)))
    check(rmse < float(np.std(truth)), f"svgp: predictive RMSE {rmse} is no better than the mean")

    def predict_cold():
        m._posterior_cache = None
        m.predict(Xs)

    predict_ms = host_ms(lambda: m.predict(Xs), reps=10, warmup=2)
    predict_cold_ms = host_ms(predict_cold, reps=5, warmup=1)
    del m
    torch.cuda.empty_cache()

    side = {}
    for label, kw in (("whiten", {"whiten": True}), ("plain", {"use_natgrad": False})):
        ms = svgp_model(X, Y, Z, torch.float32)
        before = rg.launches
        tr, _ = timed_fit(ms, SVGP_SIDE_STEPS, **kw)
        b1 = rg.launches - before
        _, dt = timed_fit(ms, SVGP_SIDE_STEPS, **kw)
        side[label] = {"steps_per_s": SVGP_SIDE_STEPS / dt, "elbo_first": float(tr[0]),
                       "elbo_last": float(tr[-1]), "rbf_gram_launches": b1}
        del ms
    torch.cuda.empty_cache()
    oracles = collapsed_oracles()
    torch.cuda.empty_cache()

    rec = {"phase": "svgp", "N": SVGP_N, "M": SVGP_M, "D": SVGP_D, "B": SVGP_B,
           "dtype": "float32", "fit": SVGP_FIT, "steps_timed": SVGP_STEPS,
           "steps_per_s_best": SVGP_STEPS / times[0],
           "steps_per_s_median": SVGP_STEPS / times[len(times) // 2],
           "ms_per_step_best": times[0] / SVGP_STEPS * 1e3,
           "ms_per_step_median": times[len(times) // 2] / SVGP_STEPS * 1e3,
           "fit_seconds": times, "first_fit_seconds": first_s, "launches": launches,
           "rbf_gram_launches_per_step": launches["rbf_gram"] / SVGP_WARM,
           "elbo_first": float(tr0[0]), "elbo_after_warmup": float(tr0[-1]),
           "elbo_last": float(last[-1]),
           "host_syncs_per_fit": syncs,
           "device_ops_per_step": prof["device_ops_per_step"],
           "device_idle_share": prof["device_idle_share"],
           "f32_vs_f64_after_warmup": f32_errs, "f32_limits": SVGP_F32_TOL,
           "lower_precision_c_vs_f64": low_errs, "collapsed": oracles, "collapsed_limits": COLLAPSED_TOL,
           "side_paths": side, "n_pred": SVGP_PRED, "pred_rmse_vs_sin": rmse,
           "predict_ms_posterior_cached": predict_ms, "predict_ms_with_posterior": predict_cold_ms,
           "rbf_gram_checks": b1_checks, "rbf_gram_times": b1_times,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "nvidia_smi": smi}
    emit(rec)  # before the limits below, so that a failing run still shows its readings
    emit(prof)
    for form, tols in SVGP_F32_TOL.items():
        for k, tol in tols.items():
            v = f32_errs[form][k]
            check(v <= tol, f"svgp: float32 vs float64, {form} {k}: rel {v} > {tol}")
        for how, e in low_errs.items():
            check(any(e[form][k] > tol for k, tol in tols.items()),
                  f"svgp: the {form} limits pass a {how} C: {e[form]}")
    return rec


# --- the surface: save and load, the examples, plots and the profiler ------

# each example function of gpy_tpu_torch.examples, at its own defaults with
# optimize=True on the card, in the package's default dtype (float64); the
# keyword cuts that keep the phase near its budget are listed in
# EXAMPLE_CUTS and in the record: the state-space examples' sequential
# Kalman filter takes ~0.37 ms a time step on the host, so their fits took
# 6.8, 12.3 and 73.9 s uncut (N=300, 200, 2000 by 100 iterations), and
# toy_heaviside's EP fit (60 sweeps an evaluation) 10.1 s at 100 and 10.2
# s at 20 iterations (NVIDIA H100 80GB HBM3, 700.00 W). big_data_svgp
# (N=200,000, 300 steps), matrix_free_exact_gp (n=3000, fused) and
# large_scale_iterative_regression (N=20,000) run uncut; the last runs twice, at its default (the
# materialized Gram below 50,000 rows: B1) and with fused=True (B5 and B6).
# Every other example whose max_iters defaults above EXAMPLE_MAX_ITERS runs
# at EXAMPLE_MAX_ITERS: at their defaults the examples took 92 s of a
# 120.7 s phase on that card, over its ~90 s budget.
EXAMPLE_CUTS = {"state_space.matern_kalman_1d": {"max_iters": 5},
                "state_space.sum_kernel_kalman": {"max_iters": 10},
                "state_space.state_space_example": {"n": 500, "max_iters": 10},
                "classification.toy_heaviside": {"max_iters": 5}}
EXAMPLE_MAX_ITERS = 50
EXAMPLE_EXTRA = [("regression", "large_scale_iterative_regression", {"fused": True})]
FUSED_EXAMPLES = ("advanced.matrix_free_exact_gp",
                  "regression.large_scale_iterative_regression[fused=True]")
# a loaded model read on the CPU against the card: the float32 models within
# the dense slice's float32-vs-float64 limits, the float64 models within
# LFM_EXACT_TOL's cpu_vs_card limit, predict in float64 ~10x the fitted
# SVGP's reading (4.4e-10 on an H100: its Kmm's factor). NLML
# relative, predict as max |diff| / max |ref|, the gradient as max |diff| /
# max(max |ref|, 1): at a fitted model's optimum the gradient is rounding
# noise, which the two devices round differently
SAVE_CPU_TOL = {"float32": {"nlml": 5e-5, "grad": 1e-4, "predict": 1e-4},
                "float64": {"nlml": 1e-10, "grad": 1e-10, "predict": 5e-9}}
# plot arrays recorded on the card in float32 against the same model's on
# the CPU in float64 (max |diff| / max |ref| per array): ~10x the readings
# (on an H100: fit 4.1e-5, density 2.1e-5, latent 1.1e-7,
# magnification 9.4e-4, whose Jacobian differences float32 predictions)
PLOT_F32_TOL = {"fit": 4e-4, "density": 2e-4, "latent": 1.2e-6, "magnification": 1e-2}
SURF_PLOT_N, SURF_PLOT_RES = 2048, 200
SURF_N_PRED = 2048
SURF_TRACE_STEPS = 5


def _example_functions():
    import inspect

    import gpy_tpu_torch.examples as ex

    out = []
    for modname in ex.__all__:
        mod = getattr(ex, modname)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if not name.startswith("_") and fn.__module__ == mod.__name__:
                out.append((modname, name, {}))
    return out + EXAMPLE_EXTRA


def _returned_models(out):
    if hasattr(out, "log_likelihood"):
        return [out]
    if isinstance(out, (list, tuple)):
        return [m for o in out for m in _returned_models(o)]
    return []


class _B1Shapes:
    """Records the (N, M, D, dtype) of every B1 launch while installed, by
    wrapping the module's launcher (its own counter still counts)."""

    def __init__(self, rg):
        self.rg, self.real, self.shapes = rg, rg.rbf_gram_cuda, set()

    def __enter__(self):
        def launch(Xs, X2s, v):
            self.shapes.add((Xs.shape[0], X2s.shape[0], Xs.shape[1],
                             str(Xs.dtype).replace("torch.", "")))
            return self.real(Xs, X2s, v)

        self.rg.rbf_gram_cuda = launch
        return self

    def __exit__(self, *exc):
        self.rg.rbf_gram_cuda = self.real


def surface_examples(rg):
    """Every example on the card with the counters read around it."""
    import contextlib
    import io
    import inspect

    import numpy as np
    import torch

    import gpy_tpu_torch.examples as ex

    recs, keep = [], {}
    with _B1Shapes(rg) as shapes:
        for modname, name, extra in _example_functions():
            fn = getattr(getattr(ex, modname), name)
            params = inspect.signature(fn).parameters
            cuts = dict(EXAMPLE_CUTS.get(f"{modname}.{name}", {}))
            if ("max_iters" in params and "max_iters" not in cuts
                    and params["max_iters"].default > EXAMPLE_MAX_ITERS):
                cuts["max_iters"] = EXAMPLE_MAX_ITERS
            kw = dict(extra, **cuts)
            if "device" in params:
                kw["device"] = "cuda"
            if "optimize" in params:
                kw["optimize"] = True
            label = f"{modname}.{name}" + "".join(f"[{k}={v}]" for k, v in extra.items())
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = fn(**kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = counters()
            models = _returned_models(out)
            objs = [m.objective_function().item() for m in models]
            rec = {"example": label, "seconds": secs, "objective_end": objs, "cuts": cuts,
                   "launches": {k: launches[k] for k in ("rbf_gram", "gram_matvec_fused",
                                                         "gram_moments")}}
            if name == "boston_example":
                rec["rmse"] = {k: float(np.mean(v)) for k, v in out.items()}
            elif name == "stick_play":
                rec["data_shape"] = list(np.shape(out))
            else:
                rec["models"] = len(models)
            recs.append(rec)
            if name in ("big_data_svgp", "tied_lengthscales",
                        "multioutput_gp_with_derivative_observations"):
                keep[name] = models[0]
            del out, models
    torch.cuda.empty_cache()
    return recs, sorted(shapes.shapes), keep


def _readings(m, Xs, Y_metadata=None):
    """(objective, flat gradient, predictive mean, variance) as numpy."""
    import numpy as np

    f, g = m._objective_and_grad(m.optimizer_array)
    mu, var = m.predict(Xs, Y_metadata=Y_metadata)
    return np.float64(f), g, mu, var


def _rel_max(a, b):
    import numpy as np

    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def surface_save_load(models):
    """Each (name, model, Xs, Y_metadata, cpu_grad) through save_model and
    gpy_tpu_torch.load: bit-equal on the card, within SAVE_CPU_TOL on the CPU
    (the gradient only where cpu_grad: the dense slice's backward through an
    8192-row float32 Cholesky took ~7 of the CPU load's 10.3 s); the EP
    model predicts from its stored sites."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    import gpy_tpu_torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    out = {}
    try:
        for name, m, Xs, md, cpu_grad in models:
            before = _readings(m, Xs, md)
            again = _readings(m, Xs, md)
            repeatable = all(np.array_equal(a, b) for a, b in zip(before, again))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = m.save_model(os.path.join(tmp, name))
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            m2 = gpy_tpu_torch.load(path)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            ep = getattr(m2, "inference_method", None)
            if hasattr(ep, "_site_cache"):
                ep.last_sweeps = None
            after = _readings(m2, Xs, md)
            sweeps = None if not hasattr(ep, "_site_cache") else ep.last_sweeps
            bit_equal = [bool(np.array_equal(a, b)) for a, b in zip(after, before)]
            on_card = all(p.is_cuda for p in m2.parameters())
            del m2
            mc = gpy_tpu_torch.load(path, device="cpu")
            t0 = time.perf_counter()
            if cpu_grad:
                cpu = _readings(mc, Xs, md)
            else:
                with torch.no_grad():
                    f_cpu = mc.objective_function().item()
                cpu = (np.float64(f_cpu), None, *mc.predict(Xs, Y_metadata=md))
            t_cpu = time.perf_counter() - t0
            dt = str(m.dtype if hasattr(m, "dtype") else m._first_param().dtype)
            tol = dict(SAVE_CPU_TOL[dt.replace("torch.", "")])
            gscale = max(float(np.max(np.abs(before[1]))), 1.0)
            cpu_rel = {"nlml": _rel_max(cpu[0], before[0]),
                       "predict": max(_rel_max(cpu[2], before[2]), _rel_max(cpu[3], before[3]))}
            if cpu_grad:
                cpu_rel["grad"] = float(np.max(np.abs(cpu[1] - before[1]))) / gscale
            else:
                del tol["grad"]
            del mc
            out[name] = {"dtype": dt, "file_mb": os.path.getsize(path) / 2**20,
                         "save_seconds": t_save, "load_seconds": t_load,
                         "original_repeatable": repeatable,
                         "bit_equal_nlml_grad_mean_var": bit_equal,
                         "loaded_on_card": on_card, "ep_sweeps_after_load": sweeps,
                         "max_abs_grad": gscale, "cpu_vs_card_rel": cpu_rel,
                         "cpu_limits": tol, "cpu_seconds": t_cpu}
            os.remove(path)
    finally:
        shutil.rmtree(tmp)
    return out


def _flat_plot(canvas):
    import numpy as np

    return {f"{i:02d}_{name}_{k}": v for i, (name, d) in enumerate(canvas)
            for k, v in d.items() if isinstance(v, np.ndarray) and v.dtype.kind in "fiub"}


def surface_plots():
    """plot_fit and plot_density of a float32 GPRegression at N=2048 and
    plot_latent and plot_magnification of config 5's BayesianGPLVM through
    the recording backend: ms each, and each array against the float64 CPU
    model at the card model's parameters."""
    import numpy as np
    import torch

    import gpy_tpu_torch.plotting as tplt
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.models import BayesianGPLVM, GPRegression
    from gpy_tpu_torch.plotting import gpy_plot as gp
    from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

    rng = np.random.default_rng(11)
    X = np.sort(rng.random((SURF_PLOT_N, 1)) * 10.0, axis=0).astype(np.float32)
    Y = (np.sin(X) + 0.2 * rng.standard_normal(X.shape)).astype(np.float32)
    Yl = lv_data()

    def models(dev, dt, like=None):
        reg = GPRegression(X, Y, RBF(1, device=dev, dtype=dt), noise_var=0.04, device=dev,
                           dtype=dt)
        lvm = BayesianGPLVM(Yl, LV_Q, num_inducing=LV_M, device=dev, dtype=dt)
        if like is not None:
            for m, ref in zip((reg, lvm), like):
                load_raw_params(m, raw_params_numpy(ref))
        return reg, lvm

    def draw(reg, lvm, timed):
        out, ms = {}, {}
        for name, fn in (("fit", lambda: gp.plot_fit(reg, resolution=SURF_PLOT_RES)),
                         ("density", lambda: gp.plot_density(reg, resolution=SURF_PLOT_RES)),
                         ("latent", lambda: gp.plot_latent(lvm)),
                         ("magnification", lambda: gp.plot_magnification(lvm))):
            if timed:
                fn()  # the posterior and first-use allocations, untimed
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = _flat_plot(fn())
            ms[name] = (time.perf_counter() - t0) * 1e3
        return out, ms

    prev = tplt._library_name[0]
    tplt.change_plotting_library("recording")
    try:
        card = models("cuda", torch.float32)
        got, ms = draw(*card, timed=True)
        want, _ = draw(*models("cpu", torch.float64, like=card), timed=False)
    finally:
        tplt.change_plotting_library(prev)
    rel = {}
    for plot, arrays in want.items():
        check(set(got[plot]) == set(arrays), f"surface plot {plot}: other primitives on the card")
        rel[plot] = max(_rel_max(got[plot][k], arrays[k]) for k in arrays)
    return {"ms": ms, "rel_vs_cpu_f64": rel, "limit": PLOT_F32_TOL, "N_fit": SURF_PLOT_N,
            "resolution_fit": SURF_PLOT_RES, "latent": {"N": LV_N, "Q": LV_Q, "M": LV_M,
                                                        "D": LV_D, "resolution": 60}}


def surface_profile(m):
    """profiling.trace around NLML+gradient steps (the Chrome trace must name
    B1's kernel); StepTimer's median of that step against its CUDA-event
    device time; profile_objective's summary."""
    import glob
    import json as _json
    import shutil
    import tempfile

    import torch

    from gpy_tpu_torch.util import profiling

    params = m._free_parameters()

    def step():
        f = m.objective_function()
        return torch.autograd.grad(f, params)

    step()
    torch.cuda.synchronize()
    # late in a long process the profiler drops a session's first device
    # events (device_ms): SURF_TRACE_STEPS steps a session, up to five
    # sessions until the trace holds a B1 launch
    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        for session in range(1, 6):
            with profiling.trace(logdir):
                for _ in range(SURF_TRACE_STEPS):
                    with profiling.annotate("nlml_and_grad"):
                        g = step()
                torch.cuda.synchronize()
            path = max(glob.glob(os.path.join(logdir, "*.json")), key=os.path.getmtime)
            events = _json.load(open(path))["traceEvents"]
            names = {e.get("name", "") for e in events}
            b1_events = sum("rbf_gram_kernel" in e.get("name", "") for e in events
                            if e.get("cat") == "kernel")
            if b1_events:
                break
        trace_mb = os.path.getsize(path) / 2**20
    finally:
        shutil.rmtree(logdir)
    b1_in_trace = b1_events > 0
    timer = profiling.StepTimer()
    event_ms = []
    for _ in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with timer.step() as t:
            start.record()
            g = step()
            end.record()
            t.sync_target = g[0]
        event_ms.append(start.elapsed_time(end))
    event_ms.sort()
    summary = timer.summary()
    prof = profiling.profile_objective(m, n_calls=5)
    return {"b1_kernel_in_trace": b1_in_trace, "annotation_in_trace": "nlml_and_grad" in names,
            "trace_sessions": session, "steps_traced": SURF_TRACE_STEPS,
            "b1_kernel_events_in_trace": b1_events, "trace_mb": trace_mb, "step_timer": summary, "cuda_event_ms_median": event_ms[3],
            "profile_objective": prof}


def surface_limits(rec):
    """The surface phase's checks, applied after its record is printed."""
    for r in rec["examples"]:
        check(all(math.isfinite(v) for v in r["objective_end"]),
              f"surface {r['example']}: objective {r['objective_end']}")
        check(r["example"].endswith(("boston_example", "stick_play")) or r.get("models", 0) > 0,
              f"surface {r['example']}: returned no model")
    for label in FUSED_EXAMPLES:
        r = next(r for r in rec["examples"] if r["example"] == label)
        check(r["launches"]["gram_matvec_fused"] > 0 and r["launches"]["gram_moments"] > 0,
              f"surface {label}: B5/B6 launches {r['launches']}")
    for name, r in rec["save_load"].items():
        check(r["loaded_on_card"], f"surface save/load {name}: loaded off the card")
        check(all(r["bit_equal_nlml_grad_mean_var"]),
              f"surface save/load {name}: not bit-equal {r['bit_equal_nlml_grad_mean_var']} "
              f"(original repeatable: {r['original_repeatable']})")
        check(all(r["cpu_vs_card_rel"][k] <= r["cpu_limits"][k] for k in r["cpu_limits"]),
              f"surface save/load {name}: the CPU load against the card {r['cpu_vs_card_rel']}")
    sweeps = rec["save_load"]["ep_banana_f64"]["ep_sweeps_after_load"]
    check(sweeps is None, f"surface save/load: the loaded EP model ran {sweeps} sweeps")
    rel = rec["plots"]["rel_vs_cpu_f64"]
    check(all(v <= PLOT_F32_TOL[k] for k, v in rel.items()),
          f"surface plots: float32 card against float64 CPU {rel} > {PLOT_F32_TOL}")
    prof = rec["profiling"]
    check(prof["b1_kernel_in_trace"], "surface profile: the Chrome trace names no rbf_gram_kernel")
    check(prof["step_timer"]["p50_ms"] >= prof["cuda_event_ms_median"],
          f"surface profile: StepTimer median {prof['step_timer']['p50_ms']} ms < CUDA-event "
          f"{prof['cuda_event_ms_median']} ms: the timer did not wait for the card")


def run_surface(rg, fm, smi):
    """The surface phase: the examples, B1 at their shapes and B5/B6 at
    matrix_free_exact_gp's, save and load, plots and the profiler."""
    import numpy as np
    import torch

    from gpy_tpu_torch.kern import RBF, Symbolic
    from gpy_tpu_torch.models import GPRegression

    t_start = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    examples, shapes, keep = surface_examples(rg)
    parts["examples"] = time.perf_counter() - t0
    totals = {k: sum(r["launches"][k] for r in examples)
              for k in ("rbf_gram", "gram_matvec_fused", "gram_moments")}

    t0 = time.perf_counter()
    dt = {"float32": torch.float32, "float64": torch.float64}
    b1_checks = [check_rbf_gram(rg, N, M, D, dt[d]) for N, M, D, d in shapes]
    torch.cuda.empty_cache()
    b5 = check_fused_matvec(fm, FAMILIES["RBF"], "f32x3", ("matrix_free_exact_gp", 3000, None,
                                                           2, 9))
    b6 = check_fused_moments(fm, FAMILIES["RBF"], 2, N=3000, R=9)
    parts["kernel_checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    X, Y, _ = slice_data()
    dense = build_model(X, Y, torch.float32)
    Xd = rng.random((SURF_N_PRED, SLICE_D)).astype(np.float32) * 4.0
    Xb, Yb = banana(np.random.default_rng(0), CLS_N)
    ep = cls_model(Xb, Yb, torch.float64, "ep")
    ep.log_likelihood()  # converged sites
    Xt = np.linspace(-1.0, 5.0, SURF_N_PRED).reshape(-1, 1)
    import sympy

    x, z, v, ell = sympy.symbols("x z v ell")
    Xsym = np.sort(rng.random((500, 1)) * 6.0, axis=0)
    sym = GPRegression(Xsym, np.sin(Xsym) + 0.1 * rng.standard_normal(Xsym.shape),
                       Symbolic(1, k=v * sympy.exp(-(x - z) ** 2 / (2 * ell ** 2)),
                                parameters={"v": 1.0, "ell": 0.7}, device="cuda"),
                       device="cuda")
    svgp = keep["big_data_svgp"]
    mogp = mo_model(torch.float32)
    mo_md = {"output_index": np.arange(SURF_N_PRED) % 2}
    save = surface_save_load([
        ("dense_slice_f32", dense, Xd, None, False),
        ("big_data_svgp", svgp, rng.random((SURF_N_PRED, 4)) * 4.0, None, True),
        ("ep_banana_f64", ep, rng.random((SURF_N_PRED, 2)) * 4.0 - 1.0, None, True),
        ("multioutput_shared_kernel_f32", mogp,
         np.hstack([np.linspace(0, 4, SURF_N_PRED)[:, None], mo_md["output_index"][:, None]]),
         mo_md, True),
        ("tied_lengthscales", keep["tied_lengthscales"], Xt * 1.6, None, True),
        ("symbolic_kernel", sym, Xt, None, True),
    ])
    parts["save_load"] = time.perf_counter() - t0
    del ep, sym, svgp, mogp, keep
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    plots = surface_plots()
    parts["plots"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reset_counters()
    prof = surface_profile(dense)
    parts["profile"] = time.perf_counter() - t0
    del dense
    torch.cuda.empty_cache()

    rec = {"phase": "surface", "examples_dtype": "float64 (the package default)",
           "examples": examples, "example_launches": totals,
           "rbf_gram_checks": b1_checks, "b1_shapes": [list(s) for s in shapes],
           "gram_matvec_fused_check": {"shape": "N=3000, D=2, R=9", "rel_err": b5[0],
                                       "max_abs_err": b5[1], "tol": FUSED_FWD_TOL},
           "gram_moments_check": {"shape": "N=3000, D=2, R=9", "rel_err": b6,
                                  "tol": FUSED_BWD_TOL},
           "save_load": save, "plots": plots, "profiling": prof,
           "seconds": time.perf_counter() - t_start, "part_seconds": parts, "nvidia_smi": smi}
    emit(rec)  # before the limits below, so that a failing run still shows its readings
    surface_limits(rec)
    return {"launches_rbf_gram": totals["rbf_gram"],
            "launches_gram_matvec_fused": totals["gram_matvec_fused"],
            "launches_gram_moments": totals["gram_moments"], "rbf_gram_checks": b1_checks,
            "b5_max_abs_err": b5[1]}


# --- A16: sharding over a mesh (gpy_tpu_torch.parallel) ------------------------

# (a) runs on a 1-rank NCCL mesh over cuda:0 at full width, float32; (b) in
# PAR_RANKS spawned gloo ranks sharing cuda:0, float64, at the CPU tests'
# shapes (tests/test_torch_parallel.py) x PAR_SCALE
PAR_STEPS = 20
# the sharded SVGP step's ELBO trajectory against the serial step's from the
# same raw start, float32 (one rank: the all_reduce adds nothing, the two
# paths round differently)
PAR_SVGP_REL_TOL = 1e-4
PAR_HMC_CHAINS, PAR_HMC_SAMPLES = 16, 10
PAR_RESTARTS, PAR_RESTART_ITERS = 16, 50
PAR_RANKS, PAR_SCALE = 4, 8
# (b): every sharded value and gradient against the serial path on the card
PAR_RANK_TOL = 1e-10
PAR_RANK_TIMEOUT_S = 300


def par_collectives():
    from gpy_tpu_torch.parallel import mesh as pm

    return dict(pm.counts)


def par_profile(fn):
    """Device kernels of one call of fn by torch.profiler: NCCL's (names
    with "nccl"), their count and device ms, and every kernel's ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    nccl = [e for e in rows if "nccl" in e.key.lower()]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "nccl_kernels": sum(e.count for e in nccl),
            "nccl_device_ms": sum(e.self_device_time_total for e in nccl) / 1e3,
            "nccl_names": sorted({e.key[:70] for e in nccl}),
            "top": [{"kernel": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def par_timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def par_serial_svgp_step(m, whiten, step_size):
    """The serial Adam step the sharded one is held to: the model's own ELBO
    (its `_elbo_parts`; whitened, the sharded path's local ELBO at one
    shard) on the batch, autograd, optax.adam's rule, no collective."""
    import torch
    from gpy_tpu_torch.core.optim import optax_rule
    from gpy_tpu_torch.parallel.svgp import _local_elbo

    adam = optax_rule("adam", step_size)

    def step(raw, state, Xb, Yb, wb):
        leaves = {n: v.detach().clone().requires_grad_(True) for n, v in raw.items()}
        with m.bind_raw_dict(leaves):
            if whiten:
                val = _local_elbo(m, Xb, Yb, wb, 1, True)
            else:
                datafit, kl = m._elbo_parts(Xb, Yb)
                val = datafit - kl + m.log_prior()
        grads = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
        new_raw, new_state = {}, {}
        for (n, x), g in zip(raw.items(), grads):
            u, new_state[n] = adam.update(-(torch.zeros_like(x) if g is None else g), state[n])
            new_raw[n] = x + u
        return new_raw, new_state, val.detach()

    return step


def par_svgp(mesh, whiten):
    """sharded_svgp_train_step at bench.py's SVGP shape, PAR_STEPS steps on
    batches of SVGP_B rows, against the serial step from the same start."""
    import numpy as np
    import torch
    from gpy_tpu_torch.parallel import mesh as pm
    from gpy_tpu_torch.parallel import sharded_svgp_train_step

    X, Y, Z = svgp_data()
    m = svgp_model(X, Y, Z, torch.float32)
    step, (raw0, state0), shard = sharded_svgp_train_step(m, mesh, step_size=1e-2, whiten=whiten)
    Xd = torch.tensor(X, device="cuda")
    Yd = torch.tensor(Y, device="cuda")
    wb = torch.ones(SVGP_B, device="cuda")
    batches = [(shard(Xd[i * SVGP_B:(i + 1) * SVGP_B]), shard(Yd[i * SVGP_B:(i + 1) * SVGP_B]),
                shard(wb)) for i in range(PAR_STEPS)]
    n_raw = sum(v.numel() for v in raw0.values())

    def run(fn):
        raw, state, vals = raw0, state0, []
        for Xb, Yb, w in batches:
            raw, state, v = fn(raw, state, Xb, Yb, w)
            vals.append(v)
        return torch.stack(vals).double().cpu().numpy()

    run(step)  # warm
    reset_counters()
    pm.reset_counts()
    sharded, dt = par_timed(lambda: run(step))
    launches, coll = counters(), par_collectives()
    serial_step = par_serial_svgp_step(m, whiten, 1e-2)
    run(serial_step)
    serial, dt_serial = par_timed(lambda: run(serial_step))
    prof = par_profile(lambda: step(raw0, state0, *batches[0]))
    rel = float(np.max(np.abs(sharded - serial) / np.abs(serial)))
    rec = {"whiten": whiten, "steps": PAR_STEPS, "n_raw": n_raw,
           "ms_per_step": dt / PAR_STEPS * 1e3, "steps_per_s": PAR_STEPS / dt,
           "serial_ms_per_step": dt_serial / PAR_STEPS * 1e3,
           "serial_steps_per_s": PAR_STEPS / dt_serial,
           "elbo_first_last": [float(sharded[0]), float(sharded[-1])],
           "rel_vs_serial": rel, "launches": launches, "collectives": coll,
           "payload_bytes_per_step": coll["all_reduce_bytes"] / PAR_STEPS, "profile_one_step": prof}
    check(np.isfinite(sharded).all() and sharded[-1] > sharded[0],
          f"parallel svgp whiten={whiten}: the ELBO did not rise: {sharded[0]} -> {sharded[-1]}")
    check(rel <= PAR_SVGP_REL_TOL, f"parallel svgp whiten={whiten}: sharded vs serial rel {rel}")
    check(coll["all_reduce"] == PAR_STEPS and coll["all_reduce_elements"] == PAR_STEPS * (n_raw + 1)
          and coll["all_gather"] == 0, f"parallel svgp whiten={whiten}: collectives {coll}")
    check(launches["rbf_gram"] == 2 * PAR_STEPS,
          f"parallel svgp whiten={whiten}: {launches['rbf_gram']} B1 launches")
    return rec


def par_iterative(mesh):
    """sharded_iterative_nlml_grad(fused=True) at bench.py's N=50,000 against
    the port's fused iterative model at the same probes."""
    import numpy as np
    import torch
    from gpy_tpu_torch.parallel import mesh as pm
    from gpy_tpu_torch.parallel import sharded_iterative_nlml_grad

    X, Y, _ = iterative_data()
    m = iterative_model(X, Y, torch.float32, fused=True)
    Zp = m.inference_method._rademacher(ITER_N, torch.float32, torch.device("cuda"))
    m.inference_method._rademacher = lambda n, dtype, device: Zp
    fn = sharded_iterative_nlml_grad(mesh, m, fused=True, **ITER_OPTS)
    fn.inference._rademacher = lambda n, dtype, device: Zp
    x = m.get_flat_raw()
    fn(x)  # warm
    reset_counters()
    pm.reset_counts()
    (v, g), dt = par_timed(lambda: fn(x))
    launches, coll = counters(), par_collectives()
    m._objective_and_grad(x.cpu().numpy())
    reset_counters()
    (vs, gs), dt_serial = par_timed(lambda: m._objective_and_grad(x.cpu().numpy()))
    serial_launches = counters()
    prof = par_profile(lambda: fn(x))
    g = g.double().cpu().numpy()
    nlml_rel = abs(float(v) - vs) / abs(vs)
    grad_rel = float(np.max(np.abs(g - gs)) / np.max(np.abs(gs)))
    rec = {"N": ITER_N, "D": ITER_D, **ITER_OPTS, "fused": True,
           "ms_per_evaluation": dt * 1e3, "serial_ms_per_evaluation": dt_serial * 1e3,
           "nlml_rel_vs_serial": nlml_rel, "grad_rel_vs_serial": grad_rel,
           "limits": [ITER_NLML_TOL, ITER_GRAD_TOL], "launches": launches,
           "serial_launches": serial_launches, "collectives": coll,
           "payload_bytes_per_evaluation": coll["all_reduce_bytes"] + coll["all_gather_bytes"],
           "profile_one_evaluation": prof}
    check(nlml_rel <= ITER_NLML_TOL and grad_rel <= ITER_GRAD_TOL,
          f"parallel iterative: rel NLML {nlml_rel}, gradient {grad_rel} against the serial model")
    check(launches["gram_matvec_fused"] == ITER_OPTS["max_cg"] and launches["gram_moments"] == 0
          and launches["rbf_gram"] > 0, f"parallel iterative: launches {launches}")
    check(coll["all_gather"] == ITER_OPTS["max_cg"] and coll["all_reduce"] == 1,
          f"parallel iterative: collectives {coll}")
    return rec


def par_vardtc(mesh):
    """sharded_vardtc_elbo_and_grad at N=50,000, M=512 float32 against the
    serial VarDTC bound's float64 twin (SPARSE_REL_TOL's VarDTC row) and
    its float32 model."""
    import numpy as np
    import torch
    from gpy_tpu_torch.parallel import mesh as pm
    from gpy_tpu_torch.parallel import sharded_vardtc_elbo_and_grad

    X, Y, _ = svgp_data(N=SPARSE_N)
    m = sparse_model(X, Y, torch.float32)

    def flat(g):
        return np.concatenate([g[n].double().cpu().numpy().reshape(-1) for n in sorted(g)])

    sharded_vardtc_elbo_and_grad(m, mesh)  # warm
    reset_counters()
    pm.reset_counts()
    (v, g), dt = par_timed(lambda: sharded_vardtc_elbo_and_grad(m, mesh))
    launches, coll = counters(), par_collectives()
    prof = par_profile(lambda: sharded_vardtc_elbo_and_grad(m, mesh))
    x = m.optimizer_array
    m._objective_and_grad(x)
    (_, _), dt_serial = par_timed(lambda: m._objective_and_grad(x))
    out = {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        ms = m if dtype == torch.float32 else sparse_model(X, Y, dtype)
        ms.set_raw_dict({n: p.double() for n, p in m.get_raw_dict().items()})
        raw = {n: p.clone().requires_grad_(True) for n, p in ms.get_raw_dict(True).items()}
        with ms.bind_raw_dict(raw):
            vs = ms.log_likelihood() + ms.log_prior()
        gs = dict(zip(raw, torch.autograd.grad(vs, list(raw.values()))))
        out[tag] = (abs(float(v) - vs.item()) / abs(vs.item()),
                    float(np.max(np.abs(flat(g) - flat(gs))) / np.max(np.abs(flat(gs)))))
    tol = SPARSE_REL_TOL["vardtc"]
    rec = {"N": SPARSE_N, "M": SVGP_M, "D": SVGP_D, "ms_per_evaluation": dt * 1e3,
           "serial_ms_per_evaluation": dt_serial * 1e3,
           "rel_vs_serial_f64": out["f64"], "rel_vs_serial_f32": out["f32"],
           "limits": [tol["nlml"], tol["grad"]], "launches": launches, "collectives": coll,
           "payload_bytes_per_evaluation": coll["all_reduce_bytes"],
           "profile_one_evaluation": prof}
    check(out["f64"][0] <= tol["nlml"] and out["f64"][1] <= tol["grad"],
          f"parallel vardtc: rel {out['f64']} against the float64 serial bound")
    check(coll["all_reduce"] == 2 and launches["rbf_gram"] == 2,
          f"parallel vardtc: collectives {coll}, launches {launches}")
    return rec


def par_hmc(mesh):
    """HMC.sample(mesh=...) with 16 chains at bench.py's N=1000 HMC data
    against the unsharded call."""
    import numpy as np
    import torch
    from gpy_tpu_torch import mcmc
    from gpy_tpu_torch.parallel import mesh as pm

    Xh, Yh = hmc_data()
    m = hmc_model(Xh, Yh, torch.float32)
    hmc = mcmc.HMC(m, stepsize=HMC_STEP, num_leapfrog=HMC_LEAPFROG)
    kw = dict(num_samples=PAR_HMC_SAMPLES, num_chains=PAR_HMC_CHAINS, seed=3)
    reset_counters()
    pm.reset_counts()
    s, dt = par_timed(lambda: hmc.sample(mesh=mesh, **kw))
    launches, coll, rate = counters(), par_collectives(), hmc._accept_rate
    whole, dt_whole = par_timed(lambda: hmc.sample(**kw))
    rel = float(np.max(np.abs(s - whole) / np.maximum(np.abs(whole), 1e-30)))
    evals = PAR_HMC_SAMPLES * (1 + HMC_LEAPFROG)
    rec = {"chains": PAR_HMC_CHAINS, "num_samples": PAR_HMC_SAMPLES, "seconds": dt,
           "samples_per_s": PAR_HMC_SAMPLES * PAR_HMC_CHAINS / dt,
           "unsharded_samples_per_s": PAR_HMC_SAMPLES * PAR_HMC_CHAINS / dt_whole,
           "accept_rate": rate, "rel_vs_unsharded": rel, "launches": launches,
           "collectives": coll}
    rate_rel = abs(rate - hmc._accept_rate) / hmc._accept_rate
    rec["accept_rate_rel_vs_unsharded"] = rate_rel
    check(s.shape == whole.shape and rel <= 1e-6 and rate_rel <= 1e-6,
          f"parallel hmc: sharded samples rel {rel}, acceptance rel {rate_rel} against the "
          f"unsharded call")
    check(launches["block_chol"] >= block_columns() * evals and coll["all_gather"] == 1,
          f"parallel hmc: launches {launches}, collectives {coll}")
    return rec


def par_restarts(mesh):
    """optimize_restarts(parallel=True, mesh=...) with 16 restarts on the
    HMC model against the unsharded call."""
    import numpy as np
    import torch
    from gpy_tpu_torch.parallel import mesh as pm

    Xh, Yh = hmc_data()
    kw = dict(num_restarts=PAR_RESTARTS, parallel=True, max_iters=PAR_RESTART_ITERS,
              step_size=0.03, seed=0, verbose=False)
    m = hmc_model(Xh, Yh, torch.float32)
    reset_counters()
    pm.reset_counts()
    res, dt = par_timed(lambda: m.optimize_restarts(mesh=mesh, **kw))
    launches, coll = counters(), par_collectives()
    m2 = hmc_model(Xh, Yh, torch.float32)
    res2, dt2 = par_timed(lambda: m2.optimize_restarts(**kw))
    f, f2 = np.array([r.f_opt for r in res]), np.array([r.f_opt for r in res2])
    rel = float(np.max(np.abs(f - f2) / np.abs(f2)))
    rec = {"restarts": PAR_RESTARTS, "max_iters": PAR_RESTART_ITERS, "seconds": dt,
           "unsharded_seconds": dt2, "best": float(f.min()), "rel_vs_unsharded": rel,
           "launches": launches, "collectives": coll}
    check(rel <= 1e-6, f"parallel restarts: objectives rel {rel} against the unsharded call")
    check(launches["block_chol"] >= block_columns() * (PAR_RESTART_ITERS + 1)
          and coll["all_gather"] == 1, f"parallel restarts: launches {launches}, {coll}")
    return rec


# (b) -- the ranks: float64 on the card, sharded against serial

def par_rank_serial(m):
    import torch

    raw = {k: v.clone().requires_grad_(True) for k, v in m.get_raw_dict(free_only=True).items()}
    with m.bind_raw_dict(raw):
        v = m.log_likelihood() + m.log_prior()
    g = torch.autograd.grad(v, list(raw.values()), allow_unused=True)
    return v.item(), {k: torch.zeros_like(r) if gi is None else gi
                      for (k, r), gi in zip(raw.items(), g)}


def par_rank_rel(val, grads, sv, sg):
    """[value rel, max over the raw names of max|grad diff| / max|grad|] of a
    sharded result against the serial one."""
    import torch

    if set(grads) != set(sg):
        return [math.inf, math.inf]
    return [abs(float(val) - sv) / abs(sv),
            max(float(torch.max(torch.abs(grads[k] - sg[k]))
                      / max(float(torch.max(torch.abs(sg[k]))), 1e-300)) for k in sg)]


def par_rank_cases(rank):
    """Every sharded program of gpy_tpu_torch.parallel on the 1-D and the
    2 x 2 mesh of the ranks, each rank's shards on cuda:0, float64, at the
    CPU tests' shapes x PAR_SCALE, against the serial path on the card."""
    import numpy as np
    import torch
    from gpy_tpu_torch import mcmc, parallel
    from gpy_tpu_torch.kern import RBF
    from gpy_tpu_torch.likelihoods import Gaussian
    from gpy_tpu_torch.models import (BayesianGPLVM, GPMultioutRegression,
                                      GPMultioutRegressionMD, GPRegression, SparseGPRegression,
                                      SVGP)
    from gpy_tpu_torch.inference import IterativeGaussianInference
    from gpy_tpu_torch.parallel import mesh as pm

    f64 = dict(device="cuda", dtype=torch.float64)
    meshes = {"1d": (parallel.make_mesh(), "data"),
              "2d": (parallel.make_mesh_2d(2, 2), ("dcn", "ici"))}
    S = PAR_SCALE
    out = {}
    rng = np.random.default_rng(5)
    n = 48 * S
    X = np.linspace(0, 5, n).reshape(n, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((n, 1))
    for kind, (mesh, ax) in meshes.items():
        # 8 inducing inputs, as the CPU test: 64 on [0, 5] make Kmm too
        # ill-conditioned for a 1e-10 gradient (2e-8 read on the card)
        m = SVGP(X, Y, X[::6 * S].copy(), RBF(1, **f64), Gaussian(variance=0.2, **f64), **f64)
        m.set_raw_dict({"q_u_mean": 0.3 * rng.standard_normal((m.Z.shape[0], 1))})
        Xp, Yp, w = parallel.pad_rows_to_multiple(X[:-3], Y[:-3], PAR_RANKS)
        m2 = SVGP(X[:-3], Y[:-3], X[::6 * S].copy(), RBF(1, **f64),
                  Gaussian(variance=0.2, **f64), **f64)
        m2.set_raw_dict(m.get_raw_dict())
        val, g = parallel.data_parallel_elbo_and_grad(m2, mesh, Xp, Yp, w, axis_name=ax)
        out[f"svgp_elbo_{kind}_padded"] = par_rank_rel(val, g, *par_rank_serial(m2))
        step, (raw, state), shard = parallel.sharded_svgp_train_step(m, mesh, 5e-2, ax)
        Xs, Ys, ws = shard(X), shard(Y), shard(np.ones(n))
        pm.reset_counts()
        vals = []
        for _ in range(5):
            raw, state, v = step(raw, state, Xs, Ys, ws)
            vals.append(float(v))
        c = par_collectives()
        n_raw = sum(t.numel() for t in raw.values())
        axes = 1 if kind == "1d" else 2
        check(c["all_reduce"] == 5 * axes and c["all_reduce_elements"] == 5 * axes * (n_raw + 1)
              and vals[-1] > vals[0], f"parallel ranks train step {kind}: {c}, {vals}")
        out[f"train_step_{kind}_first_elbo"] = [abs(vals[0] - par_rank_serial(m)[0])
                                                / abs(vals[0])]
    # the Gram product: blockwise float64 against dense; B5's slab (float32)
    rng = np.random.default_rng(0)
    N = 64 * PAR_RANKS * S
    k = RBF(3, variance=0.9, lengthscale=1.1, **f64)
    Xg = torch.tensor(rng.uniform(0, 5, (N, 3)), **f64)
    V = torch.tensor(rng.standard_normal((N, 4)), **f64)
    noise = torch.full((N,), 0.2, **f64)
    with torch.no_grad():
        dense = (k.K(Xg) + torch.diag(noise)) @ V
    for kind, (mesh, ax) in meshes.items():
        got = parallel.sharded_gram_matvec(mesh, k, Xg, V, noise=noise, block=64 * S,
                                           axis_name=ax)
        out[f"gram_matvec_{kind}"] = [float(torch.max(torch.abs(got - dense))
                                            / torch.max(torch.abs(dense)))]
        fused = parallel.sharded_gram_matvec(mesh, k, Xg, V, noise=noise, axis_name=ax,
                                             fused=True)
        out[f"b5_slab_{kind}"] = float(torch.max(torch.abs(fused - dense))
                                       / torch.max(torch.abs(dense)))
        check(out[f"b5_slab_{kind}"] <= FUSED_FWD_TOL,
              f"parallel ranks B5 slab {kind}: {out[f'b5_slab_{kind}']}")
    # the iterative NLML, blockwise float64, probes of the serial model. At
    # N=1280 CG converges by ~20 steps; past it the SLQ coefficients are
    # rounding noise, and a product rounded differently (a rank's slab
    # against the whole Gram's blocks) moves the estimate by ~1e-5 (a 1e-16
    # relative perturbation of each product does so on the CPU): held at
    # max_cg=10, recorded at the CPU test's 60
    rng = np.random.default_rng(1)
    N = 40 * PAR_RANKS * S
    Xi = rng.uniform(0, 8, (N, 2))
    Yi = np.sin(Xi[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    for max_cg in (10, 60):
        inf = IterativeGaussianInference(max_cg=max_cg, n_probes=8, block=64 * S, seed=0,
                                         materialize=False)
        mi = GPRegression(Xi, Yi, RBF(2, 1.1, 1.4, **f64), noise_var=0.1, inference_method=inf,
                          **f64)
        x = mi.get_flat_raw()
        sv, sg = mi._objective_and_grad(x)
        for kind, (mesh, ax) in meshes.items():
            fn = parallel.sharded_iterative_nlml_grad(mesh, mi, max_cg=max_cg, n_probes=8,
                                                      block=64 * S, seed=0, axis_name=ax)
            v, g = fn(x)
            g = g.cpu().numpy()
            rel = [abs(float(v) - sv) / abs(sv),
                   float(np.max(np.abs(g - sg)) / np.max(np.abs(sg)))]
            # a list is held to PAR_RANK_TOL, a tuple recorded
            out[f"iterative_{kind}_max_cg{max_cg}"] = rel if max_cg == 10 else tuple(rel)
    # VarDTC (padded rows), BGPLVM, LVMOGP and its missing-data bound
    rng = np.random.default_rng(7)
    N, M = 83 * S, 9 * 4
    Xv = rng.random((N, 3)) * 5.0
    Yv = np.concatenate([np.sin(Xv[:, :1]), np.cos(Xv[:, :1])], 1) \
        + 0.1 * rng.standard_normal((N, 2))
    mv = SparseGPRegression(Xv, Yv, num_inducing=M, Z=Xv[:M].copy(), **f64)
    for kind, (mesh, ax) in meshes.items():
        pm.reset_counts()
        val, g = parallel.sharded_vardtc_elbo_and_grad(mv, mesh, axis_name=ax)
        check(par_collectives()["all_reduce"] == 2 * (1 if kind == "1d" else 2),
              f"parallel ranks vardtc {kind}: collectives {par_collectives()}")
        out[f"vardtc_{kind}"] = par_rank_rel(val, g, *par_rank_serial(mv))
    rng = np.random.default_rng(8)
    N = 43 * S
    Yb = rng.standard_normal((N, 2)) @ rng.standard_normal((2, 4)) \
        + 0.1 * rng.standard_normal((N, 4))
    mb = BayesianGPLVM(Yb, 3, num_inducing=7 * 4, **f64)
    for kind, (mesh, ax) in meshes.items():
        val, g = parallel.sharded_bgplvm_elbo_and_grad(mb, mesh, axis_name=ax)
        out[f"bgplvm_{kind}"] = par_rank_rel(val, g, *par_rank_serial(mb))
    rng = np.random.default_rng(11)
    n, d = 21 * S, 5
    Xm = np.linspace(0, 5, n).reshape(-1, 1)
    Ym = np.hstack([np.sin(Xm) * wgt for wgt in np.linspace(0.5, 1.5, d)]) \
        + 0.05 * rng.standard_normal((n, d))
    mm = GPMultioutRegression(Xm, Ym, Xr_dim=2, num_inducing=(6 * 2, 2), init="rand", **f64)
    idx = np.repeat(np.arange(4), 9 * S)
    Xd = np.linspace(0, 5, idx.size).reshape(-1, 1)
    Yd = np.sin(Xd) * (0.5 + 0.3 * idx[:, None]) + 0.05 * rng.standard_normal((idx.size, 1))
    md = GPMultioutRegressionMD(Xd, Yd, idx, Xr_dim=2, num_inducing=(6 * 2, 2), init="rand",
                                heter_noise=True, **f64)
    for kind, (mesh, ax) in meshes.items():
        val, g = parallel.sharded_svi_multiout_elbo_and_grad(mm, mesh, axis_name=ax)
        out[f"svi_multiout_{kind}"] = par_rank_rel(val, g, *par_rank_serial(mm))
        val, g = parallel.sharded_svi_multiout_md_elbo_and_grad(md, mesh, axis_name=ax)
        out[f"svi_multiout_md_{kind}"] = par_rank_rel(val, g, *par_rank_serial(md))
    # HMC chains and parallel restarts split over the mesh (B2/B3 at N=320)
    rng = np.random.default_rng(4)
    Xh = rng.random((40 * S, 1)) * 4.0
    Yh = np.sin(Xh) + 0.1 * rng.standard_normal(Xh.shape)
    mh = GPRegression(Xh, Yh, **f64)
    x0 = mh.get_flat_raw().clone()
    hmc = mcmc.HMC(mh, stepsize=0.05, num_leapfrog=5)
    whole = hmc.sample(num_samples=10, num_chains=8, seed=1)
    kw = dict(num_restarts=8, parallel=True, max_iters=30, step_size=5e-2, seed=0,
              verbose=False)
    rr = mh.optimize_restarts(**kw)  # keeps its best point: each call starts from x0
    for kind, (mesh, _) in meshes.items():
        mh.set_flat_raw(x0)
        s = hmc.sample(num_samples=10, num_chains=8, seed=1, mesh=mesh)
        out[f"hmc_{kind}"] = [float(np.max(np.abs(s - whole) / np.abs(whole)))]
        r = mh.optimize_restarts(mesh=mesh, **kw)
        out[f"restarts_{kind}"] = [max(abs(a.f_opt - b.f_opt) / abs(b.f_opt)
                                       for a, b in zip(r, rr))]
    # every reading against the serial path: lists of relative errors
    out["over_limit"] = sorted(k for k, v in out.items()
                               if isinstance(v, list) and max(v) > PAR_RANK_TOL)
    out["launches"] = counters()
    return out


def par_rank_main(rank, init_file, q):
    """One of the PAR_RANKS gloo ranks: its cases, then its result on q."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=PAR_RANKS,
                            timeout=datetime.timedelta(seconds=PAR_RANK_TIMEOUT_S))
    try:
        t0 = time.perf_counter()
        out = par_rank_cases(rank)
        out["seconds"] = time.perf_counter() - t0
        q.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- sent to the parent, which fails the phase
        q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def par_ranks():
    """Spawn the gloo ranks (the parent has CUDA up: spawn, not fork; the
    kernels are built already, so no rank starts nvcc) and check every
    rank's result and exit code."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = os.path.join(tempfile.mkdtemp(prefix="gloo_"), "rendezvous")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=par_rank_main, args=(r, init, q)) for r in range(PAR_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < PAR_RANKS:
            rank, ok, out = q.get(timeout=PAR_RANK_TIMEOUT_S)
            got[rank] = (ok, out)
    except queue.Empty:
        pass
    for p in procs:
        p.join(60)
        if p.is_alive():
            p.kill()
            p.join()
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    check(not failed, f"parallel ranks failed: {failed}")
    check(len(got) == PAR_RANKS and all(p.exitcode == 0 for p in procs),
          f"parallel ranks: results from {sorted(got)}, exit codes "
          f"{[p.exitcode for p in procs]}")
    rec = dict(got[0][1])
    rec["seconds_with_spawn"] = time.perf_counter() - t0
    rec["rank_seconds"] = [got[r][1]["seconds"] for r in range(PAR_RANKS)]
    rec["over_limit_by_rank"] = [got[r][1]["over_limit"] for r in range(PAR_RANKS)]
    return rec


def run_parallel(fm, smi):
    """The parallel phase: (a) a 1-rank NCCL mesh over cuda:0 at full width,
    (b) PAR_RANKS gloo ranks sharing cuda:0 in float64, and B5's slab at
    the shapes this path gives it."""
    import torch
    import torch.distributed as dist
    from gpy_tpu_torch.parallel import make_mesh

    t_start = time.perf_counter()
    parts = {}
    mesh = make_mesh()
    check(dist.get_backend() == "nccl" and mesh.size() == 1, "parallel: not a 1-rank NCCL mesh")
    rec = {"phase": "parallel", "mesh": "1-rank NCCL, cuda:0", "dtype": "float32"}
    # each reading's counts are read around its own run; the launches of the
    # comparisons against serial or unsharded paths are not among them
    main_launches = {"rbf_gram": 0, "gram_matvec_fused": 0, "block_chol": 0}
    for name, fn in (("svgp_train_step", lambda: par_svgp(mesh, False)),
                     ("svgp_train_step_whitened", lambda: par_svgp(mesh, True)),
                     ("iterative_fused", lambda: par_iterative(mesh)),
                     ("vardtc", lambda: par_vardtc(mesh)),
                     ("hmc", lambda: par_hmc(mesh)),
                     ("restarts", lambda: par_restarts(mesh))):
        t0 = time.perf_counter()
        rec[name] = fn()
        parts[name] = time.perf_counter() - t0
        emit({"phase": "parallel_part", "part": name, **rec[name]})
        for k in main_launches:
            main_launches[k] += rec[name]["launches"][k]
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["b5_slab_checks"] = []
    for k in (1, PAR_RANKS):  # a rank's slab (N/k, N) of the sharded product
        rel, err = check_fused_matvec(fm, FAMILIES["RBF"], "f32x3",
                                      (f"slab_k{k}", ITER_N // k, ITER_N, ITER_D, 9))
        rec["b5_slab_checks"].append({"shape": f"({ITER_N // k}, {ITER_N}) D={ITER_D} R=9",
                                      "rel_err": rel, "max_abs_err": err, "tol": FUSED_FWD_TOL})
    parts["b5_slab_checks"] = time.perf_counter() - t0
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["gloo_ranks"] = par_ranks()
    parts["gloo_ranks"] = time.perf_counter() - t0
    rec.update(main_path_launches=main_launches, seconds=time.perf_counter() - t_start,
               part_seconds=parts, nvidia_smi=smi)
    emit(rec)  # before the limit below, so that a failing run still shows its readings
    check(not any(rec["gloo_ranks"]["over_limit_by_rank"]),
          f"parallel ranks: sharded against serial above {PAR_RANK_TOL}: "
          f"{rec['gloo_ranks']['over_limit_by_rank']}")
    return {"launches": main_launches,
            "b5_max_abs_err": max(c["max_abs_err"] for c in rec["b5_slab_checks"])}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from gpy_tpu_torch.ops import _build
    from gpy_tpu_torch.ops import block_chol as bc
    from gpy_tpu_torch.ops import gram_matvec_fused as fm
    from gpy_tpu_torch.ops import rbf_gram as rg

    smi = nvidia_smi_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "host": host_record(), "nvidia_smi": smi})

    t0 = time.perf_counter()
    reports = build_kernels(_build)
    ptxas = {n: [ln.strip() for ln in r.splitlines() if "registers" in ln or "spill" in ln]
             for n, r in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(reports),
          "ptxas": ptxas})
    checks = []
    for dtype in (torch.float32, torch.float64):
        for N, M, D in ((1024, 1024, 1), (8192, 8192, 8), (1000, 777, 16), (2048, 512, 16)):
            checks.append(check_rbf_gram(rg, N, M, D, dtype))
            torch.cuda.empty_cache()
    emit({"phase": "kernels", "rbf_gram": checks})

    m, Xs, slice_rec = run_slice(rg)
    emit(slice_rec)
    torch.cuda.empty_cache()

    gram = [time_rbf_gram(rg, SLICE_N, SLICE_N, D) for D in (8, 16)]
    x = m.optimizer_array
    before = rg.launches
    objgrad_ms = host_ms(lambda: m._objective_and_grad(x), reps=5, warmup=2)
    per_eval = (rg.launches - before) / 7

    def predict_cold():
        m._posterior_cache = None
        m.predict(Xs)

    predict_cold_ms = host_ms(predict_cold, reps=5, warmup=1)
    predict_ms = host_ms(lambda: m.predict(Xs), reps=10, warmup=2)
    emit({"phase": "times", "rbf_gram": gram, "objective_and_grad_ms_n8192": objgrad_ms,
          "rbf_gram_launches_per_objective_and_grad": per_eval,
          "predict_ms_n2048_posterior_cached": predict_ms,
          "predict_ms_n2048_with_posterior": predict_cold_ms,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "nvidia_smi": smi})

    emit(profile_objective(m, x))
    del m
    torch.cuda.empty_cache()

    fused_rec, fused_err = run_fused_checks(fm)
    emit(fused_rec)
    torch.cuda.empty_cache()

    models, Xi, iter_rec = run_iterative()
    emit(iter_rec)
    itimes = iterative_times(models, Xi, fm, smi)
    emit(itimes)
    for tag, (mi, _) in models.items():
        emit(profile_objective(mi, mi.optimizer_array,
                               what=f"one objective_and_grad, iterative {tag}, N={ITER_N} float32"))

    del models, mi
    torch.cuda.empty_cache()

    # the iterative exact GP at D = 12: B5's cross-term kernel
    d12 = run_iterative_d12(fm, smi)

    # the batched exact GP (bench.py's HMC stage)
    Xh, Yh = hmc_data()
    mh = hmc_model(Xh, Yh, torch.float32)
    chol_rec, chol_err, b4_path_launches = run_kernels_chol(bc, mh)
    emit(chol_rec)
    hmc, hmc_rec = run_hmc(mh, Xh, Yh)
    emit(run_restarts(Xh, Yh))
    ctimes = chol_times(bc, mh, smi)
    emit(ctimes)
    emit(profile_hmc_eval(hmc))
    del hmc, mh
    torch.cuda.empty_cache()

    # the SVGP flagship (bench.py's first number), then the collapsed sparse
    # GPs at BASELINE config 2's scale
    svgp_rec = run_svgp(rg, smi)
    sparse_rec = run_sparse(rg, smi)
    # non-Gaussian inference at BASELINE config 3's shapes
    cls_rec = run_cls(rg, smi)
    # multi-output GPs, BASELINE config 4's second half
    multi_rec = run_multi(rg, smi)
    # latent-variable models and sparse HMC, BASELINE config 5
    latent_rec = run_latent(rg, smi)
    # LVMOGP, the Student-t process, the optimizers and the GP surface
    s15_rec = run_slice15(rg, smi)
    # state space (Kalman filters), bench.py's Kalman stage
    ss_rec = run_state_space(smi)
    # the long tail's model families, bench.py's long-tail stage
    lt_rec = run_longtail(rg, smi)
    # the latent-force models and the symbolic kernel and likelihood
    lfm_rec = run_lfm_symbolic(rg, smi)
    # the surface: the examples, save and load, plots and the profiler
    surf_rec = run_surface(rg, fm, smi)
    # sharding: a 1-rank NCCL mesh at full width, 4 gloo ranks on the card
    par_rec = run_parallel(fm, smi)

    main_shape = gram[0]
    mv, mom = itimes["gram_matvec_fused"][0], itimes["gram_moments"][0]
    mom_mma = [itimes["gram_moments"][1], d12["moments_kernel"]]
    b2, b4 = (next(r for r in ctimes[k] if r["C"] == 8 and r["dtype"] == "float32")
              for k in ("block_chol", "block_chol_inv"))
    mv_all = itimes["gram_matvec_fused"]
    wide = {t["R"]: t for t in mv_all if t["R"] > 16}
    emit({"kernels": [{
        "name": "rbf_gram", "route": "cuda", "source": "gpy_tpu_torch/csrc/rbf_gram.cu",
        "replaces": "gpy_tpu/ops/pallas_gram.py:55",
        "launches": slice_rec["launches"] + sum(iter_rec[t]["launches"]["rbf_gram"]
                                                for t in ("fused", "auto"))
        + hmc_rec["launches"]["rbf_gram"] + svgp_rec["launches"]["rbf_gram"]
        + sparse_rec["launches"] + cls_rec["launches"] + multi_rec["launches_coreg"]
        + multi_rec["launches_multioutput"] + latent_rec["launches_gplvm"]
        + latent_rec["launches_sparse_hmc"] + s15_rec["launches_rbf_gram"]
        + ss_rec["launches_rbf_gram"] + lt_rec["launches_rbf_gram"]
        + lfm_rec["launches_rbf_gram"] + surf_rec["launches_rbf_gram"]
        + par_rec["launches"]["rbf_gram"],
        "launches_svgp": svgp_rec["launches"]["rbf_gram"],
        "launches_sparse": sparse_rec["launches"],
        "launches_classification": cls_rec["launches"],
        "launches_coreg": multi_rec["launches_coreg"],
        "launches_multioutput": multi_rec["launches_multioutput"],
        "launches_gplvm": latent_rec["launches_gplvm"],
        "launches_sparse_hmc": latent_rec["launches_sparse_hmc"],
        "launches_slice15": s15_rec["launches_rbf_gram"],
        "launches_state_space": ss_rec["launches_rbf_gram"],
        "launches_longtail": lt_rec["launches_rbf_gram"],
        "launches_lfm_symbolic": lfm_rec["launches_rbf_gram"],
        "launches_surface": surf_rec["launches_rbf_gram"],
        "launches_parallel": par_rec["launches"]["rbf_gram"],
        "max_abs_err": max(c["max_abs_err"] for c in checks + svgp_rec["rbf_gram_checks"]
                           + sparse_rec["rbf_gram_checks"] + cls_rec["rbf_gram_checks"]
                           + multi_rec["rbf_gram_checks"] + latent_rec["rbf_gram_checks"]
                           + s15_rec["rbf_gram_checks"] + lt_rec["rbf_gram_checks"]
                           + lfm_rec["rbf_gram_checks"] + surf_rec["rbf_gram_checks"]
                           if c["dtype"] == "float32"),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "svgp_shapes": svgp_rec["rbf_gram_times"], "sparse_shapes": sparse_rec["rbf_gram_times"],
        "classification_shapes": cls_rec["rbf_gram_times"],
        "multi_output_shapes": multi_rec["rbf_gram_times"],
        "latent_shapes": latent_rec["rbf_gram_times"],
        "slice15_shapes": s15_rec["rbf_gram_times"],
        "longtail_shapes": lt_rec["rbf_gram_times"],
        "lfm_symbolic_shapes": lfm_rec["rbf_gram_times"],
    }, {
        "name": "gram_matvec_fused", "route": "cuda",
        "source": "gpy_tpu_torch/csrc/gram_matvec_fused.cu",
        "replaces": "gpy_tpu/ops/pallas_gram_matvec.py:71",
        "launches": iter_rec["fused"]["launches"]["gram_matvec_fused"]
        + d12["drive"]["launches"]["gram_matvec_fused"]
        + surf_rec["launches_gram_matvec_fused"] + par_rec["launches"]["gram_matvec_fused"],
        "launches_iterative": iter_rec["fused"]["launches"]["gram_matvec_fused"],
        "launches_iterative_d12": d12["drive"]["launches"]["gram_matvec_fused"],
        "launches_surface": surf_rec["launches_gram_matvec_fused"],
        "launches_parallel": par_rec["launches"]["gram_matvec_fused"],
        "max_abs_err": max([fused_err, surf_rec["b5_max_abs_err"], par_rec["b5_max_abs_err"]]
                           + [t["max_abs_err"] for t in mv_all]),
        "main_path_rel_err": {f"R{t['R']}": t["rel_err"] for t in mv_all},
        "main_path_rel_tol": {f"R{t['R']}": t["rel_tol"] for t in mv_all},
        "shape": f"N={ITER_N}, D={ITER_D}, R=9", "ms": mv["ms"],
        "event_ms": mv["event_ms"], "plain_ms": mv["plain_ms"],
        "bound_ms": mv["bound_ms"], "bound_by": mv["bound_by"],
        "bound_tc_ms": mv["bound_tc_ms"], "bound_tc_by": mv["bound_tc_by"],
        "ptxas": ptxas_of(reports["gram_matvec_fused"], MAIN_B5_INSTANCE), "library_ms": None,
        "wide": {"kernel": WIDE_B5_INSTANCE, "route": "wgmma m64n128k8 TF32, 3 passes",
                 "shape": f"N={ITER_N}, D={ITER_D}, R=256 (predict at {ITER_PRED} points)",
                 "ms": wide[256]["ms"], "event_ms": wide[256]["event_ms"],
                 "plain_ms": wide[256]["plain_ms"], "bound_ms": wide[256]["bound_ms"],
                 "bound_by": wide[256]["bound_by"], "bound_tc_ms": wide[256]["bound_tc_ms"],
                 "bound_tc_by": wide[256]["bound_tc_by"],
                 "ms_by_R": {f"R{R}": t["ms"] for R, t in wide.items()},
                 "bound_tc_ms_by_R": {f"R{R}": t["bound_tc_ms"] for R, t in wide.items()},
                 "launches_per_predict": iter_rec["predict_var_vs_f64"]["b5_launches"],
                 "predict_var_rel_err_vs_f64": iter_rec["predict_var_vs_f64"]["rel_err"],
                 "ptxas": ptxas_of(reports["gram_matvec_fused"], WIDE_B5_INSTANCE)},
    }, {
        "name": "gram_matvec_fused_cross", "route": "cuda",
        "source": "gpy_tpu_torch/csrc/gram_matvec_fused.cu",
        "replaces": "gpy_tpu/ops/pallas_gram_matvec.py:71",
        "kernel": CROSS_B5_INSTANCE, "route_detail": "mma.sync m16n8k8 TF32, 3 passes (cross term)",
        "launches": d12["cross_launches"],
        "launches_per_objective_and_grad_by_name": d12["launches_by_profiler_name"],
        "max_abs_err": max(fused_rec["cross_max_abs_err"], d12["cross_kernel"]["max_abs_err"]),
        "main_path_rel_err": d12["cross_kernel"]["rel_err"],
        "main_path_rel_tol": d12["cross_kernel"]["rel_tol"],
        "shape": f"N={ITER_N}, D={D12}, R=9", "ms": d12["cross_kernel"]["ms"],
        "event_ms": d12["cross_kernel"]["event_ms"], "plain_ms": d12["cross_kernel"]["plain_ms"],
        "bound_ms": d12["cross_kernel"]["bound_ms"], "bound_by": d12["cross_kernel"]["bound_by"],
        "bound_direct_ms": d12["cross_kernel"]["bound_direct_ms"],
        "ptxas": ptxas_of(reports["gram_matvec_fused"], CROSS_B5_INSTANCE), "library_ms": None,
        "nlml_rel_vs_f64_d12": d12["nlml_rel_vs_f64"], "grad_rel_vs_f64_d12": d12["grad_rel_vs_f64"],
    }, {
        "name": "gram_moments", "route": "cuda",
        "source": "gpy_tpu_torch/csrc/gram_matvec_fused.cu",
        "replaces": "gpy_tpu/ops/pallas_gram_matvec.py:269",
        "launches": iter_rec["fused"]["launches"]["gram_moments"]
        + surf_rec["launches_gram_moments"],
        "launches_iterative": iter_rec["fused"]["launches"]["gram_moments"],
        "launches_surface": surf_rec["launches_gram_moments"],
        "max_abs_err": mom["max_abs_err_vs_f64_plain"], "main_path_rel_err": mom["rel_err"],
        "main_path_rel_tol": FUSED_BWD_TOL_50K, "shape": f"N={ITER_N}, D={ITER_D}, R=9",
        "ms": mom["ms"], "reduce_ms": mom["reduce_ms"], "event_ms": mom["event_ms"],
        "plain_ms": mom["plain_ms"], "bound_ms": mom["bound_ms"], "bound_by": mom["bound_by"],
        "ptxas": ptxas_of(reports["gram_matvec_fused"], MAIN_B6_INSTANCE), "library_ms": None,
    }, {
        "name": "gram_moments_mma", "route": "cuda",
        "source": "gpy_tpu_torch/csrc/gram_matvec_fused.cu",
        "replaces": "gpy_tpu/ops/pallas_gram_matvec.py:269",
        "kernel": CHUNK_B6_INSTANCE, "route_detail": "mma.sync m16n8k8 TF32, 3 passes (W)",
        "launches": d12["drive"]["launches"]["gram_moments"],
        "launches_per_objective_and_grad_by_name": d12["launches_by_profiler_name"],
        "max_abs_err": max(mm["max_abs_err_vs_f64_plain"] for mm in mom_mma),
        "main_path_rel_err": d12["moments_kernel"]["rel_err"],
        "main_path_rel_tol": d12["moments_kernel"]["rel_tol"],
        "rel_err_d4_r17": itimes["gram_moments"][1]["rel_err"],
        "shape": f"N={ITER_N}, D={D12}, R=9", "ms": d12["moments_kernel"]["ms"],
        "reduce_ms": d12["moments_kernel"]["reduce_ms"],
        "event_ms": d12["moments_kernel"]["event_ms"],
        "plain_ms": d12["moments_kernel"]["plain_ms"],
        "bound_ms": d12["moments_kernel"]["bound_ms"], "bound_by": d12["moments_kernel"]["bound_by"],
        "bound_all_simt_ms": d12["moments_kernel"]["bound_all_simt_ms"],
        "ms_d4_r17": itimes["gram_moments"][1]["ms"],
        "ptxas": ptxas_of(reports["gram_matvec_fused"], CHUNK_B6_INSTANCE), "library_ms": None,
    }, {
        "name": "block_chol", "route": "cuda", "source": "gpy_tpu_torch/csrc/block_chol.cu",
        "replaces": "gpy_tpu/ops/pallas_chol.py:123 (_block_kernel_v2) and :175 "
                    "(_block_kernel_v2_multi)",
        "launches": hmc_rec["launches"]["block_chol"] + s15_rec["launches_block_chol"]
        + par_rec["launches"]["block_chol"],
        "launches_hmc": hmc_rec["launches"]["block_chol"],
        "launches_optimizer_restarts": s15_rec["launches_block_chol"],
        "launches_parallel": par_rec["launches"]["block_chol"],
        "max_abs_err": chol_err["block_chol"],
        "shape": "(8, 128, 128) float32", "ms": b2["ms"], "plain_ms": b2["plain_ms"],
        "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
        "library_ms": b2["library_ms"], "library": b2["library"],
        "timing": "ms and library_ms are torch.profiler device time per call; "
                  f"event_ms {b2['event_ms']}, library_event_ms {b2['library_event_ms']}",
    }, {
        "name": "block_chol_inv", "route": "cuda", "source": "gpy_tpu_torch/csrc/block_chol.cu",
        "replaces": "gpy_tpu/ops/pallas_chol.py:64 (_block_kernel)",
        "launches": b4_path_launches,
        "launches_path": "batched_chol_inv(version=1) and rec_block_chol_inv in kernels_chol; "
                         "0 on the HMC path",
        "max_abs_err": chol_err["block_chol_inv"],
        "shape": "(8, 128, 128) float32", "ms": b4["ms"], "event_ms": b4["event_ms"],
        "plain_ms": b4["plain_ms"], "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
        "library_ms": b4["library_ms"], "library": b4["library"],
        "timing": "ms and library_ms are torch.profiler device time per call; "
                  f"library_event_ms {b4['library_event_ms']}",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
