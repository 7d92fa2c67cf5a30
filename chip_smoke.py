"""Smoke run of the PyTorch/CUDA port (online_gp_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which raises (exit code 1, no final ok line) on failure:

1. The card's name and power limit (nvidia-smi), TF32 off, and a build of
   every CUDA source under online_gp_torch/csrc with nvcc.
2. Each kernel (K2 rank1_apply, K1 blocked_chunk, K3 pred_chunk) against
   its plain PyTorch version on the card, on the same inputs, at m=900
   and k=128, for Bd=1 and Bd=2: K2 and one K1 chunk to 1e-5, a 4-chunk
   K1 stream to 2e-4, K3 to 2e-4 (allclose: |a-b| <= tol + tol*|b|); K1
   and K3 bitwise the same on a second call. Outside the one-cluster
   envelope: one K1 chunk at m=2,500 (a 50x50 grid), on G = 3 clusters
   of 8 (the grid recursion kernel), to 1e-5, and one K3 chunk of k=512
   at m=900, its recursion spread over the card, to 2e-4. Each
   kernel's device time (torch.profiler, summed over its CUDA
   kernels, with each one's share), its wrapper's time between CUDA
   events (host issue included), its plain version's time, one PyTorch
   library call's (a yardstick the port never calls) and the least time
   the card could take for the same work. The K1 and K3 cluster
   recursions are rows of their own: their device time within the chunk,
   the plain recursion's time, their bound, and the chunk's error (the
   wrappers return no factors). Then the host ops of 16 single-point
   wiski_condition calls.
3. The WISKI serving path at the width of bench.py's configuration: 2-D
   inputs, a 30x30 grid (m=900), RBF, one output, learned second noise,
   256 seed points, slim state. wiski_stream of 16,384 points (K1), 256
   single-point wiski_condition calls (K2) and prediction caches (Q on K6)
   plus predict on 1,024 held-out points, each of these two host-bound
   metrics 7 times after a warm-up (median and min-max spread),
   wiski_prequential_stream of 4,096 points (K3 and K1). The launch
   counters are zeroed just before and read just after; each kernel must
   have launched, every K1 and K3 chunk with its recursion on one cluster
   of 8 (none on G > 1 clusters or 16 blocks). Then a short profiled
   pass of both
   streams: torch.profiler must record the cluster recursion kernels and
   no other recursion kernel. Gates: the stream's
   roots match the plain root update over a 256-point prefix to within
   1e-3 * scale (bench.py's gate), the predictions are finite, and the
   decomposition check's inverse_root_err is finite.
4. The remaining kernels' entry points at m=900, fed from WISKI states of
   phase 3's model. The launch counters are zeroed just before and read
   just after this path:
   - K4 (fused_root_cache_update): 256 single-point dense-v updates
     v = W_x/sqrt(noise) on full wiski_init states at Bd=1 and Bd=2 and on
     the slim Bd=1 state, against the plain root_cache_update: roots within
     1e-3 * scale, A to 1e-5, wiski_check_decomposition's errors finite.
   - K5 (blocked_chunk with sub=32 and with mode="coord"): a 4-chunk stream
     of k=128 on phase 3's final roots, against blocked_chunk_plain with
     the same options, to 2e-4; every sub chunk on the fused cluster kernel.
   - K6 (blocked_cholesky): Q = I + L^T Kuu_hat L of phase 3's final state,
     against its plain version and torch.linalg.cholesky: relative max
     error <= 5e-4, strict upper triangle exactly 0.
   Then each kernel against its plain version on synthetic inputs, with
   times as in phase 2: K4 one update to 1e-5 and bitwise the same on a
   second call (Bd=1, Bd=2 with p=0 an exact no-op, slim Bd=1; and one at
   m=1,100, where the row kernel loops over a row); K5 one
   chunk to 1e-5, bitwise the same on a second call, and a 4-chunk stream
   to 2e-4 at Bd=1 and 2, with each variant's distance to flat K1 and K1
   flat's device time on the same inputs, one sub chunk at m=1,089 (fused,
   near the envelope's edge; also bitwise) and one at m=2,500 (outside it,
   one sub-block at a time, each on one cluster) to 1e-5;
   K6 on SPD batches at m = 900, 1,000 and
   130 for Bd = 1 and 4 and on a (2, 2, 900, 900) batch, against its plain
   version and torch.linalg.cholesky to atol 2e-5, rtol 1e-4, bitwise the
   same on a second call, strict upper triangle exactly 0, its failure flag
   clear.
   K4 and K6 report their device span per call as `ms` (device_span_ms:
   first CUDA activity to last, with the call queued behind a spin kernel),
   the time of a call whose kernels overlap by programmatic dependent
   launch. K6 is timed with that launch off too, beside the spans of
   torch.linalg.cholesky and torch.linalg.cholesky_ex. K6's times are of
   blocked_cholesky_ex, the entry with the failure flag.
5. The training path through the port's OnlineSKIRegression at bench.py's
   full-update configuration (bench.py:255-300): LinearStem(2, 2), 30x30
   grid, RBF, one output, learned second noise, slim state, lr 1e-2, 256
   seed points; depth cut to a 5-epoch fit, 64 update() calls at q = 1
   and 8 at q = 32, then one hyper_step, predict and prequential of 1,024
   points and absorb of 4,096. The launch counters are zeroed just before
   and read just after: K6 must factor Q on every update() and the
   hyper_step, K2 launch once per q = 1 update, K1 and K3 launch (on
   clusters). A CPU twin (convert) runs the first 8 updates from the same
   params and state: params within 1e-3, roots within 1e-3 * scale. Every
   loss, mll_value() and the predictions finite. Then K6's flag on the
   card (Q with one eigenvalue set to -1: NaN from spd_cholesky where
   cholesky_ex fails, the SPD Q beside it as alone to 1e-6), the hyper
   step's gradient at float32 (the closed form against autograd through
   torch.linalg.cholesky to 1e-2 of each leaf's largest entry, both beside
   a float64 reference) with the device time of its forward and of each
   backward, fit(num_epochs=1) timed 7 times after a warm-up, and a
   torch.profiler breakdown of 4 update() calls (device idle share, kernels
   by device time, host ops by self CPU time). update() rates are medians
   and spreads over the calls after the first.

6. The large-grid regime at m = 4,096 (a 64x64 grid, bench.py:474-640):
   - K1 (one chunk of k = 128), K2 (16 calls), K3 (one chunk) and K6 (Q of
     a state of the model) against their plain versions on the card, K1's
     recursion on G = 4 clusters of 8 (chunk_recursion_grid_kernel) and
     K3's on one cluster of 16 blocks (checked by their counters), at
     phase 2's tolerances (K1 and K2 1e-5, K3 2e-4; K6 5e-4 relative, as
     phase 4's Q), K1 and K3 bitwise the same on a second call, with device
     times, bounds and library yardsticks as in phases 2 and 4. Beside
     them (printed, not in the kernels line): the card's capacity for
     those clusters (cudaOccupancyMaxActiveClusters), K1 and K3 at Bd = 2,
     and one K1 chunk at each edge of the G <= 4 grid envelope (m = 1,121,
     the first on G = 2; 4,480, the last on G = 4; 4,481, the first on
     G = 5) and one K3 chunk at each edge of the 16-block one (3,137;
     6,016; 6,017, spread over the card), each against its plain
     version, bitwise on a second call, with its device time and bound;
     K6 on SPD matrices at m = 2,048, 2,049 and 4,097 and at Bd = 2,
     m = 4,096, as Q's check. K6's stage kernels and their launches come
     from its plan (cuda_chol.cholesky_plan); every K6 check also holds the
     factor with look-ahead on bitwise to the one with it off, and times
     both (la_on_ms, la_off_ms) and the stages alone (trailing_ms,
     factor_ms, solve_ms), here and on phase 12's Q at m = 1,936 and
     4,096.
   - The iterative hyper step at bench_iterative_hyper_step's
     configuration: RBF, learned second noise, 1,024 seed points,
     max_cholesky_size 2,048, use_toeplitz. Gate first: the CG/SLQ MLL
     against the dense one (max_cholesky_size 2m, Q on K6) to rel 5e-2, the
     loss finite. Then 10 Adam steps, repeated: hyper steps/s (median and
     spread), the peak device memory, and one step under torch.profiler
     (launches, device idle share).
   - The rank-capped stream at bench_lowrank_stream's configuration (rank
     512, 256 seed points, 64 chunks of 256 with compressions firing).
     Gate first: in the exact regime the posterior mean matches a dense SKI
     oracle (float64) to 3e-3 * max(scale, 1). Then points/s (median and
     spread).
   - The wrappers through their entry points, with the launch counters
     zeroed just before and read just after: OnlineSKIRegression
     (LinearStem(2, 2), grid_size=64: dense, iterative GP step by default):
     16 update()s at q = 1, predict of 1,024, prequential of 512, absorb of
     1,024 (K2, K6, K3 and K1, every K1 chunk's recursion on G >= 2
     clusters and every K3 chunk's on 16 blocks, by the counters); the same
     with low_rank=512, and grid_size=128 (m = 16,384, routed to the
     rank-capped core): 16 updates and a predict each. Each has a CPU twin
     (the dense one runs the first update, the others the first 2): params
     within 1e-3, predictions within 1e-3 * scale. ms a call and kernel
     launches a call.

7. Dirichlet classification through the port's OnlineSKIClassifier:
   (a) the experiment layer's wiski_gpd model (IdentityStem(2), grid 16,
   m = 256, 2 classes, alpha_eps 0.01, lr 0.05) on banana_dataset(n=1200,
   seed=0): a 30-epoch fit on 100 points, set_lr(0.01), 400 streamed
   predict-then-update() calls at q = 1 (gates, the reference's: cumulative
   accuracy >= 0.70, test accuracy >= 0.75), then an absorb of the rest of
   the training split; (b) LinearStem(2, 2), grid 30 (m = 900), 2 classes,
   256 seed points: 64 update()s at q = 1, 8 at q = 32, a predict of
   1,024 and an absorb of 4,096, with a CPU twin over the first 8 updates
   (params within 1e-3, roots within 1e-3 * scale). In both the counters
   are zeroed just before and read just after: K2 once per q = 1 update,
   K6 on every update, K1 in absorb on its cluster recursion at Bd = 2.
   (c) the rank-capped classifier at grid 72 (m = 5,184, routed) with
   low_rank=256: a 30-epoch fit on 200 points, 30 updates at q = 4, test
   accuracy >= 0.8. (d) wiski_fantasize (F = 3, q = 2) and the
   differentiable route (detach_interp=False: condition at q = 1 and 2,
   stream and prequential of 16) with gradients with respect to x on (b)'s
   CUDA state, against CPU twins (values within 1e-3 * scale, gradients
   within 1e-2 of their largest entry); K1, K2 and K3 must not launch and
   the base state must come back bitwise. (e) K2, K1 and K6 at Bd = 2 on
   the states of (a) and (b) (m = 256 and 900) against their plain
   versions at phase 2's and phase 4's tolerances, with device times,
   bounds and yardsticks. update() ms, predict ms and absorb points/s are
   printed (medians and spreads).

8. The online baselines at the widths of the experiment presets
   (online_gp_tpu/experiments/config.py:24-50), each with an IdentityStem
   on CUDA tensors: exact_gp_regression, svgp_regression (256 inducing
   points, closed_form, streaming, betas 1e-3), sgpr_regression (256
   inducing points, jitter 1e-4), localgp_regression (64 experts x 256
   points) on streaming_friedman(n=4000, num_dims=5); exact_gpd and
   svgp_classification (256 inducing points) on banana_dataset(n=1200).
   Each starts on the first 5% of its training stream, fits 20 epochs,
   then runs 128 prequential steps at batch 1 (evaluate the point, then
   update()) and the test set. Gates: every loss and prediction finite;
   a CPU twin (convert) runs 8 stream steps from the state after the
   first update: params within 1e-3 of max(scale, 1), predictions within
   1e-3 of their scale (where one is missed, a float64 CPU twin runs the
   same steps, and twice the CPU's own float32-to-float64 distance is
   added to the bound), labels the same but near p = 0.5; and the JAX package's quality bars
   (tests/regression/test_baseline_models.py:33-138) at their own
   configurations. Printed: update() ms (median, spread over the calls
   after the first), predict ms of the test set, fit ms, test RMSE and NLL
   or accuracy, and one update() under torch.profiler (CUDA kernel ms and
   launches, the device's idle share, scalar readbacks and device-to-host
   copies). The baselines run no kernel of the port (the JAX ones reach
   no pl.pallas_call): the launch counters must stay at 0.

9. BayesOpt and active learning through the port's entry points at the
   JAX package's default widths (depth cut to a few steps): (a)
   ``run_bayesopt`` (Ackley, dim 3, grid 10: m = 1,000, the reference
   surrogate: Matern-5/2 with Gamma priors, 10 initial points, 50 Adam
   refit steps), UCB for 4 steps, then one step each of EI, NEI, KG, MVES
   and UCB at batch_size=4, KG at q = 1, and UCB with
   fit_method="lbfgs"; (b) ``run_active_learning`` on
   malaria_dataset(n=2500) at the reference's 30x30 grid (m = 900), WISKI
   and exact, 3 steps each; (c) ``run_mpv_osvgp`` at 64 inducing points,
   3 steps. The counters are zeroed before each run and read after it: at
   q = 1 K2 launches once per condition and K6 on every refit step (51 a
   UCB step: 50 refit forwards and the acquisition's caches); at q = 4 K2
   does not launch (the plain dense update, as in JAX); the exact arm and
   MPV launch nothing. Gates: the best-so-far monotone with the last at
   least the first; the active-learning variance contracts (MPV's does not
   grow); finite RMSE and acquisition values; a CPU twin of one BO step
   from the card's state (the refit's params within 1e-3 of max(scale, 1),
   UCB and EI at 16 fixed points within 1e-3 of their largest value, the
   roots after a condition within 1e-3 * scale); K2 (16 calls) and K6 (Q)
   on the BO state at m = 1,000 against their plain versions at phase 2's
   and phase 4's tolerances. Printed: fit, acquisition and condition times
   per step (median and spread), one UCB step under torch.profiler
   (launches, device idle share), the peak device memory of each q = 4 step
   and of KG at q = 1.

10. The experiment drivers through their entry points at the presets'
   widths (online_gp_tpu/experiments/config.py), depth cut, each window
   with the counters zeroed just before and read just after; the native
   stream loader must have built (g++). (a) ``regression_trial`` at
   model=wiski_gp_regression dataset=skillcraft (its flagged surrogate:
   19 inputs) stem=linear (2 features, grid 16^2 = 256), batch_size 1,
   20 batch epochs, 256 streamed steps: the online_metrics schema of the
   JAX driver, every value finite, K2 and K6 launched; its final_state
   loaded into a fresh wrapper on the card reproduces test RMSE and NLL
   to 1e-6; a CPU twin of 32 stream steps from the card's models after
   the fit (saved and loaded) agrees within 1e-3 of each column's largest
   value (regret: of its terms'), step_time aside. (b) the same with
   stream_mode=fused, two segments of 512: K3 launched, points/s printed,
   the checkpoint resumes to 1e-6, and on the resumed wrapper's state and
   caches K2, K1, K3 and K6 at the drivers' shapes (Bd = 1, m = 256)
   against their plain versions (rows ``...@drv-m256``).
   (c) ``classification_trial`` at model=wiski_gpd dataset=banana stem=eye,
   30 epochs, 200 steps: test accuracy >= 0.7, K2 and K6 launched, the
   checkpoint resumes to 1e-6. (d) ``fixed_noise_regression.run(arm=
   "both")`` at its grid of 30 (m = 900) on the synthetic malaria field,
   50 steps: each arm's median condition and MLL ms and cond_speedup,
   finite RMSE, K2 and K6 launched. (e) ``run_sweep(2, "seq")`` on
   friedman cut as (a). Printed: seconds per window, step ms (median and
   spread over the logged steps), fused points/s, classifier step ms,
   beside the card's name and power limit.

11. The parallel layer (online_gp_torch/parallel, run_sweep's mode=mesh),
   its prints beside the card's name and power limit and its seconds.
   (a) ``run_sweep(8, "mesh", ...)`` at model=wiski_gp_regression
   dataset=skillcraft (the flagged surrogate) stem=linear (2 features,
   grid 16^2 = 256), batch_size 1, 20 batch epochs, 256 streamed steps, in
   this process (a NCCL world of one), the counters zeroed just before and
   read just after: K2 exactly once a step, at Bd = 8 (the trials folded
   into the output batch), K6 on every step's caches and Q, every pretrain
   epoch's Q and the held-out caches (2 x 256 + 20 + 1), all at
   (8, 256, 256); every trial's online_metrics in the JAX sweep's schema
   (batch_rmse, batch_nll and regret NaN, test_rmse and test_nll on the
   last row), every other value finite. Batching: dataset=friedman in 2-D,
   stem=eye, grid 16^2, 64 steps at T = 8 and at T = 2: trials 0 and 1
   agree within 1e-4 of each column's largest value; a CPU twin of the
   T = 2 run within 1e-3 (step_time aside). (b) ``run_sweep(4, "mesh",
   ...)`` at model=wiski_gpd dataset=banana stem=eye, 30 epochs, 200
   steps: every trial's test accuracy >= 0.7, K2 at Bd = 8 (4 trials x 2
   classes), K6 launched. (c) two gloo ranks spawned on this card
   (``parallel.launch.spawn_ranks``, a FileStore under build/): at m = 900
   (phase 3's model, rows 450 a rank, 4,096 points in chunks of 128, the
   recursions on one cluster of 8) and m = 4,096 (rows 2,048, 512 points,
   K1's recursion on G = 4 clusters, K3's on 16 blocks),
   ``sharded_stream_blocked`` against the
   single-device ``wiski_stream`` (K1) and over a 256-point prefix against
   the plain per-point update, each rank's rows within 1e-3 * max(scale,
   1) (bench.py's gate), and ``sharded_pred_stream_blocked`` against the
   single-device K3 stream, caches and moments to 2e-4; in each rank the
   stage counters, zeroed just before and read just after, show every
   stage once a chunk, the recursions on the clusters of their plans.
   (d) on the same two
   ranks, ``localgp_experts_step`` at the localgp_regression preset's 256
   points an expert, 8 experts (4 a rank), against the one-process step:
   loss, params, mixture mean and variance within 1e-5 (allclose). (e)
   each stage wrapper (chunk_gather_rows, chunk_factors, chunk_apply_rows,
   pred_gather_rows, pred_factors, pred_apply_rows) on rank 0's rows of
   (c)'s inputs at both sizes, one chunk, against its plain version (K1's
   at 1e-5, K3's at 2e-4, the absolute part of each output's scale), and
   K2 (16 calls) and K6 (Q) on a trial-batched state of (a)'s
   configuration (Bd = 8, m = 256) at phase 10's tolerances, with device
   times, wrapper times, plain times, bounds and yardsticks (bmm and
   baddbmm of the same products; none for the recursions). Printed: the
   sweeps' seconds, trials/s, step ms for all trials and trial-steps/s,
   each rank's sharded updates/s and points/s beside the single-device
   run's, the expert step's ms.
12. The slice that finishes the port. (a) Grid-sharded WISKI on two gloo
   ranks sharing the card, at bench.py's configuration (30 x 30, m = 900,
   RBF, learned second noise, 256 seed points) and on a 44 x 44 grid
   (m = 1,936), the state whole (the Gram kept): each rank row-shards it
   (``parallel.shard_wiski_state``) and runs, with
   ``SolverConfig(grid_shard_axis="tp")``, one hyper step (MLL, its
   gradient through autograd, Adam), 64 single-point ``wiski_condition``
   calls (K2's row-shard entry) and caches + predict of 1,024 points (Q on
   K6), against the single-device run of the same calls (closed-form
   gradient, K2, K6) and its float64 twin on the CPU: mll within 1e-5
   relative, gradients within 1e-4 of each leaf's largest entry (against
   the single device's gradient through autograd, the sharded MLL's own
   method; the closed form's distance printed), the roots, inverse roots,
   Gram and wty (gathered) within 1e-5 * max(scale, 1), mean within 1e-5
   and var within 1e-4 of their largest magnitude, each bar raised to twice
   the single device's own distance from the float64 twin where float32
   cannot resolve it (phase 8's rule); each rank's counters, zeroed just
   before and read just after, show K2's row-shard entry 64 times, K6 once
   and K2 never; each rank holds half the state's bytes. Printed: hyper
   step ms, condition updates/s and caches + predict ms a rank beside the
   single device's, and the bytes. (b) K2's row-shard entry
   (``rank1_apply_rows``, 16 calls) on rank 0's rows of (a)'s seed state
   at both sizes against ``rank1_apply_rows_plain`` to 1e-5 (the absolute
   part times the roots' scale, at least 1, as phases 9 to 11), with device
   time, wrapper and plain times, the bytes bound and ``mv`` + ``addr_``
   on the shard as yardstick; K6 on (a)'s Q (``check_k6``); and K2 at
   rows = m through ``rank1_apply`` and ``rank1_apply_rows`` on phase 3's
   roots, bitwise equal. (c) The three baseline mesh sweeps
   (svgp_regression and sgpr_regression on friedman, svgp_classification
   on banana, eye stem, 256 inducing points, 10 epochs, 32 steps), T = 8
   in this process and split over the two ranks: per-trial results within
   1e-5 of each column's largest magnitude, every kernel counter 0;
   printed: seconds and trial-steps/s. (d)
   ``parallel.dryrun_multichip(2, "cuda")``: every arm within 1e-5 of its
   one-process run. (e) (a)'s conditioned m = 1,936 state saved with
   ``backend="dcp"`` from both ranks and loaded whole in this process,
   bitwise the gathered state, with save and load ms. (f) Grid-sharded
   WISKI past ``max_cholesky_size`` on the same two ranks, at bench.py's
   iterative configuration (64 x 64, m = 4,096, RBF, learned second noise,
   1,024 seed points, ``use_toeplitz``, ``max_cholesky_size=2048``, 32
   probes): after a warm-up of the same calls at short counts, one hyper
   step on the CG/SLQ MLL (its gradient, Adam; probes from one seeded
   generator), 16 single-point ``wiski_condition`` calls (K2's row-shard
   entry), caches + predict of 1,024 points under ``fast_pred_var`` (LOVE
   at rank 512, Q on K6) and predict under ``fast_pred_samples`` on those
   caches (the Lanczos root of rank 512), against the single-device run of
   the same calls and its float64 twin on the CPU, at (a)'s bars (the
   sampling path's mean and var at the mean's and var's); each rank's
   counters show K2's row-shard entry 16 times, K6 once and K2 never; each
   rank holds half the state's bytes; K2's row-shard entry and K6 checked
   as in (b) at m = 4,096 (rows ``...@gs-m4096-d2``). Printed: each rank's
   hyper step seconds, conditions/s, caches + predict ms, sampling predict
   ms and bytes beside the single device's.

13. K1's and K3's applies (the last stage of every K1, K5 and K3 chunk).
   First the main path's window at m = 900 on copies of phase 3's final
   state: wiski_stream of 1,024 points and the prequential stream of 512,
   the counters zeroed just before and read just after; every chunk must
   end in K1's cluster apply or K3's apply (``chunk_apply_plan.launches``,
   ``pred_apply_plan.launches``). Then ``chunk_apply_rows`` and
   ``pred_apply_rows`` on rows = m and m / 2 of roots and caches of Bd = 1
   and 2 outputs at m = 256, 900 and 4,096, k = 128, with the factors of
   one chunk from the plain recursions; K1's also at k = 32 (K5 sub's
   per-sub-block rank) and k = 1,024 (the tiled kernels, the shape rule's
   other branch) at m = 900. Each call is a window of its own (one launch
   of the kernel its plan names), then held against its plain version (K1
   within 1e-5 of each output's largest magnitude, at least 1; K3
   allclose at 2e-4) and bitwise the same on a second call, with device
   time (torch.profiler), wrapper time, plain time, the baddbmm
   yardstick and the bound (8 rows m k flops for K1, 2 rows m k for K3,
   or the bytes, whichever is longer). Every path window of phases 3-13
   (both ranks' in phase 11) counts its applies by shape (Bd, rows, m, k);
   a timed shape's row carries those windows' launches, and a shape that
   no path window runs (only this phase's checks) is printed and left out
   of the kernels line.

14. Every grid size the JAX package streams, at k = 128 and P = 16 (K1's
   and K3's recursions spread over the card past their cluster envelopes,
   and every kernel past 2^31 elements), the inputs made on the card from
   seeded generators (roots I + 0.01 N / sqrt(m); caches G G^T / 64 +
   0.1 I), each size freed before the next. (a) K1 (blocked_chunk) and
   chunk_factors at m = 4,481, 8,192, 16,384, 32,400 and 46,656 and at
   Bd = 2 at 16,384: the recursion against chunk_factors_plain and the
   chunk against blocked_chunk_plain (past m = 32,400, whose plain copy
   does not fit beside the roots, 256 rows of the chunk and
   chunk_apply_rows on them against the plain apply of the plain factors)
   at 1e-5 of the scale, bitwise the same on a second call, on the route
   named for each size (G = 5 and 8 clusters at 4,481 and 8,192, spread
   over the card from 16,384): planned so, and taken so by the counters
   (cluster, grid-cluster and spread launches). (b) K3 (pred_chunk) and
   pred_factors at m = 6,017, 16,384 and 65,536 (each spread) at 2e-4
   (past 16,384, 256 rows of C and mu, pred_apply_rows on them and the
   moments against the plain factors). (c) K2 through 16 single-point
   wiski_condition calls on a 216 x 216 grid (m = 46,656), each against
   rank1_apply_plain at 1e-5 of the scale, and K6 on an SPD Q at m =
   46,656 against torch.linalg.cholesky (5e-4 relative), bitwise on a
   second call, its failure flag clear. (d) The functional path at
   m = 16,384 (a 128 x 128 grid, the dense core): wiski_init of 256
   points, wiski_stream of 4,096, wiski_prediction_caches and
   wiski_prequential_stream of 1,024, the counters zeroed just before and
   read just after (every K1 and K3 chunk spread over the card, K6 on Q),
   against the same calls on the plain chunk forms (detach_interp=False,
   on the card): roots within 1e-3 of the scale, moments and caches at
   2e-4. (e) sharded_stream_blocked at m = 46,656 and
   sharded_pred_stream_blocked at m = 65,536, 8 chunks each, on two gloo
   ranks sharing the card (each drawing its own rows from the seeds),
   against the single device's streams run first (sampled rows, mu and the
   moments kept on the host), each rank's stage counters zeroed just
   before and read just after. Printed: device times (torch.profiler) with
   the chunk's stages, wrapper, plain and library times (baddbmm of the
   applies, torch.linalg.cholesky), bounds (chunk_bound, pred_bound,
   chol_bound, rank1_bound) and peak device memory a size.

It prints the kernels as one JSON line (``launches``: the sum over the
path windows of phases 3, 4, 5, 6, 7, 9, 10, 11, 12, 13 and 14, phase 8
launching none; rows ``...@m4096``: phase 6's
kernel checks, with phase 6's launches; rows ``...@cls-m256-bd2`` and
``...@cls-m900-bd2``: phase 7's kernel checks, with the launches of the
windows of (a) and (b); rows ``...@bo-m1000``: phase 9's kernel checks,
with the launches of its windows; rows ``...@drv-m256``: phase 10's
kernel checks, with the launches of its windows; rows
``...@tp-m900-d2`` and ``...@tp-m4096-d2``: phase 11's stage checks, with
the launches of both ranks at that size; rows ``...@sweep-m256-bd8``:
phase 11's K2 and K6 checks, with the launches of its sweep windows; rows
``...@gs-m900-d2``, ``...@gs-m1936-d2`` and ``...@gs-m4096-d2``: phase 12's
K2 row-shard and K6 checks, with the launches of both ranks in (a) or (f)
at that size; rows ``chunk_recursion_spread@m16384`` and
``pred_recursion_spread@m16384``: phase 14's recursions at (d)'s width,
with (d)'s spread launches, and ``chunk_factors@m46656-d2`` and
``pred_factors@m65536-d2``: its recursions at (e)'s widths, with both
ranks' spread launches in (e); phase 12's
single-device runs add to the K2 and K6 sums; rows ``chunk_apply@m{m}-r{rows}-bd{Bd}[-k{k}]``
and ``pred_apply@...``: phase 13's applies at the shapes a path window
ran, with the launches of those windows at that shape), then
the card's name and power limit, and last {"ok": true, "device": {...}}.
It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import csv
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from online_gp_torch import DEFAULT_CONFIG, SolverConfig, convert
from online_gp_torch.api import (
    IdentityStem,
    LinearStem,
    OnlineExactClassifier,
    OnlineExactRegression,
    OnlineLocalGPRegression,
    OnlineSGPRegression,
    OnlineSKIClassifier,
    OnlineSKILowRankClassifier,
    OnlineSKILowRankRegression,
    OnlineSKIRegression,
    OnlineSVGPClassifier,
    OnlineSVGPRegression,
)
from online_gp_torch.bayesopt import acquisitions as bo_acq
from online_gp_torch.bayesopt import loop as bo_loop
from online_gp_torch.bayesopt.active_learning import run_active_learning
from online_gp_torch.bayesopt.mpv_osvgp import run_mpv_osvgp
from online_gp_torch.bayesopt.optimize import optimize_acqf, sobol_raw_init
from online_gp_torch.data import banana_dataset, streaming_friedman
from online_gp_torch.experiments import config as exp_config
from online_gp_torch.experiments import fixed_noise_regression
from online_gp_torch.experiments.classification import classification_trial
from online_gp_torch.experiments.common import build_model, load_dataset
from online_gp_torch.experiments.regression import online_regression, prepare_trial, regression_trial
from online_gp_torch.experiments.sweep import run_sweep
from online_gp_torch.kernels.base import RBFKernel
from online_gp_torch.logging import CSVLogger
from online_gp_torch.kernels.grid_kernel import grid_kuu_dense
from online_gp_torch.models.wiski import (
    WiskiModel,
    WiskiState,
    wiski_check_decomposition,
    wiski_condition,
    wiski_fantasize,
    wiski_init,
    wiski_mll,
    wiski_predict,
    wiski_prediction_caches,
    wiski_prequential_stream,
    wiski_slim,
    wiski_stream,
)
from online_gp_torch.native import native_available
from online_gp_torch.models.wiski_lowrank import (
    WiskiLowRankModel,
    wiski_lowrank_condition,
    wiski_lowrank_init,
    wiski_lowrank_predict,
)
from online_gp_torch.ops import _build, cuda_chol, cuda_pred_stream, cuda_root_update
from online_gp_torch.ops.cuda_chol import blocked_cholesky, blocked_cholesky_ex, blocked_cholesky_plain
from online_gp_torch.ops.cuda_pred_stream import (
    pred_apply_plan,
    pred_chunk,
    pred_chunk_stencil_plain,
    pred_cluster_plan,
)
from online_gp_torch.ops.cuda_root_update import (
    blocked_chunk,
    blocked_chunk_plain,
    chunk_apply_plan,
    chunk_cluster_plan,
    fused_root_cache_update,
    rank1_apply,
    rank1_apply_plain,
    rank1_update,
    rank1_update_plain,
    shard_stencil,
)
from online_gp_torch.ops.chol import spd_cholesky
from online_gp_torch.ops.grid import Grid
from online_gp_torch.ops.interp import dense_w, interp_coeffs
from online_gp_torch.ops.precision import assert_true_f32, f32_matmul_precision
from online_gp_torch.ops.pred_stream import pred_chunk_factors, pred_stream_blocked
from online_gp_torch.ops.root_update import (
    RootCache,
    blocked_factors,
    blocked_factors_coord,
    blocked_factors_sub,
    root_cache_update,
    roots_stream_blocked,
    stencil_rows,
)
from online_gp_torch.parallel.launch import spawn_ranks
from online_gp_torch.utils.checkpoint import load_wrapper, save_wrapper
from online_gp_torch.utils.optim import adam_init, adam_update, tree_leaves, tree_rebuild

SEED = 0
M_SIDE = 30  # bench.py: 30x30 grid, m = 900
K = 128  # chunk rank of wiski_stream and the prequential stream
N_SEED, N_STREAM, N_COND, N_TEST, N_PREQ = 256, 16384, 256, 1024, 4096
TIMING_REPS = 20
# a host-bound metric (a loop of small launches, a host clock around
# synchronised work) is taken HOST_REPEATS times after one warm-up, and its
# median and min-max spread are printed: one run of it spread wider than
# any gap between two versions
HOST_REPEATS = 7
# a profile window opens this long before its first launch: without it,
# torch.profiler on an H100 lost the records of a window's first launches
# in up to 2% of windows (profiler_records.py)
PROFILE_PAD_S = 0.05
PROFILE_ATTEMPTS = 3
PROFILE_EXTRA_CALLS = 5  # device_ms, device_span_ms: calls a window runs before those it counts
# device_span_ms: the spin queued before each call it times (~1 ms on an
# H100), and the idle gap that splits one call from the next
SPIN_CYCLES = 2_000_000
SPAN_SPLIT_US = 250.0
N_K4 = 256  # phase 4: dense-v updates per K4 state
SUB = 32  # phase 4: K5's sub-block size
VARIANTS = {"blocked_chunk_sub": dict(sub=SUB), "blocked_chunk_coord": dict(mode="coord")}
CHOL_BLOCK = 128
CHOL_SIZES = (900, 1000, 130)  # phase 4: K6 at m = 900 (4-column last panel), 1,000, 130
CHOL_BATCHES = (1, 4)
OUTSIDE_SIDE = 50  # phase 2: a K1 chunk at m = 2,500, outside one cluster's envelope (on G = 3)
SUB_EDGE_SIDE = 33  # phase 4: a K5-sub chunk at m = 1,089, near the envelope's edge
OUTSIDE_K3 = 512  # phase 2: a K3 chunk of k = 512 at m = 900, outside it
ROWS_OUTSIDE_REGS_M = 1100  # phase 4: K4 where its row kernel cannot hold a row in registers
# phase 5: bench.py's full-update arms (bench.py:255-300) through the wrapper,
# depth cut to 5 fit epochs and 64 + 8 updates
TRAIN_LR = 1e-2
FIT_EPOCHS = 5
N_UPD1, N_UPD32, N_TWIN, N_ABSORB = 64, 8, 8, 4096
TWIN_PARAM_TOL = 1e-3  # a tenth of one Adam step at TRAIN_LR
HYPER_GRAD_RTOL = 1e-2  # float32 gradients of an O(n) objective, against the leaf's largest entry
LOG_2PI = 1.8378770664093453
# phase 6: bench.py's m = 4,096 arms (bench.py:474-640) and the wrappers at
# that width
M6_SIDE = 64  # a 64x64 grid, m = 4,096
N_SEED6 = 1024  # bench_iterative_hyper_step's seed points
N_K2_6 = 16  # K2 calls checked at m = 4,096
PLAIN_REPS6 = 3  # timing repeats of the plain versions at m = 4,096
# phase 6: the edges of K1's grid envelope at k = 128 (1,120: the last m on
# one cluster, by the carried kernel; 1,121: the first on G = 2 clusters;
# 4,480: the last on G = 4; 4,481: the first on G = 5, where the port's
# first design ran the recursion on one block) and of K3's 16-block one
# (3,137: the first on 16 blocks; 6,016: the last; 6,017: the first spread
# over the card), each with the route (route_name) it must take
K1_EDGES = {1120: "cluster", 1121: "grid", 4480: "grid", 4481: "grid"}  # m -> the route of K1's recursion there
K3_EDGES = {3137: "wide", 6016: "wide", 6017: "spread"}
# phase 6: K6 (Bd, m) where its panels turn ragged or its plan changes
# (2,048: 16 whole panels; 2,049 and 4,097: a last panel of one column)
# and Bd = 2 at 4,096
K6_EDGES = ((1, 2048), (1, 2049), (1, 4097), (2, 4096))
HYPER_LR, HYPER_STEPS, HYPER_REPEATS = 1e-2, 10, 3
ITER_GATE_REL = 5e-2  # bench.py:611
LR_RANK, LR_SEED, LR_CHUNK, LR_CHUNKS, LR_REPEATS = 512, 256, 256, 64, 3
LR_GATE = 3e-3  # bench.py:536, times max(scale, 1)
N_WRAP_SEED, N_WRAP_UPD, N_PREQ6, N_ABSORB6 = 256, 16, 512, 1024
BIG_SIDE = 128  # m = 16,384: above DENSE_GRID_LIMIT, routed to the rank-capped core
# phase 7: Dirichlet classification through OnlineSKIClassifier
CLS_ALPHA_EPS = 0.01
# (a) the experiment layer's wiski_gpd model (online_gp_tpu/experiments/config.py:45-46), as
# tests/classification/test_ski_classifier.py::test_online_eye_stem runs it, with its gates (:94-95)
GPD_N, GPD_SIDE, GPD_LR, GPD_INIT, GPD_EPOCHS, GPD_STREAM_LR, GPD_STREAM = 1200, 16, 0.05, 100, 30, 0.01, 400
GPD_CUM_GATE, GPD_TEST_GATE = 0.70, 0.75
# (b) the dense classifier's default width (grid 30, m = 900): banana points, depth cut
CLS_N, CLS_SEED_PTS, CLS_UPD1, CLS_UPD32, CLS_TWIN, CLS_PRED, CLS_ABSORB = 8000, 256, 64, 8, 8, 1024, 4096
# (c) tests/classification/test_lowrank_classifier.py:22-35, with its gate
LRC_SIDE, LRC_RANK, LRC_INIT, LRC_EPOCHS, LRC_UPDATES, LRC_GATE = 72, 256, 200, 30, 30, 0.8
N_FANT, Q_FANT = 3, 2  # (d) fantasies and points per fantasy
# phase 8: the online baselines at the experiment presets' widths
# (online_gp_tpu/experiments/config.py:24-50; num_update_steps = batch size 1), IdentityStem
BASE_N, BASE_DIMS, BASE_CLS_N = 4000, 5, 1200  # streaming_friedman (3,600 / 400), banana_dataset (960 / 240)
# the stream cut from 256 to 128 steps to keep phase 8 near a minute (77 s at 256 on a slow host)
BASE_INIT_RATIO, BASE_FIT_EPOCHS, BASE_STREAM, BASE_TWIN = 0.05, 20, 128, 8
BASE_TWIN_RTOL = 1e-3  # params against max(scale, 1), predictions against their scale
BASE_PRESETS = {
    "exact_gp_regression": (OnlineExactRegression, "regression", dict(lr=1e-2)),
    "svgp_regression": (OnlineSVGPRegression, "regression", dict(
        num_inducing=256, lr=1e-2, streaming=True, prior_beta=1e-3, online_beta=1e-3, num_update_steps=1,
        variational_mode="closed_form")),
    "sgpr_regression": (OnlineSGPRegression, "regression", dict(
        num_inducing=256, lr=1e-2, num_update_steps=1, jitter=1e-4)),
    "localgp_regression": (OnlineLocalGPRegression, "regression", dict(
        lr=1e-2, max_data_per_model=256, max_experts=64)),
    "exact_gpd": (OnlineExactClassifier, "classification", dict(alpha_eps=0.01, lr=1e-2)),
    "svgp_classification": (OnlineSVGPClassifier, "classification", dict(
        num_inducing=256, lr=1e-2, prior_beta=1e-3, online_beta=1e-3, num_update_steps=1)),
}
# phase 9: BayesOpt and active learning at the JAX package's default widths
# (online_gp_tpu/bayesopt/loop.py:133-150, active_learning.py:44-60,
# mpv_osvgp.py:36-48); depth cut to a few steps each
BO_UCB_STEPS, BO_Q, AL_STEPS, MPV_STEPS = 4, 4, 3, 3
BO_TWIN_PTS = 16  # fixed points the acquisition is compared at
BO_TWIN_RTOL = 1e-3  # params against max(scale, 1), acquisition values relative, roots against their scale
BO_K2_CALLS = 16
# phase 10: the experiment layer's drivers at the presets' widths
# (online_gp_tpu/experiments/config.py), depth cut; their logs and
# checkpoints go under build/ (git-ignored), their own prints to a file there
DRIVER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_drivers"
ONLINE_METRICS = ["step", "stem_loss", "gp_loss", "batch_rmse", "batch_nll", "online_rmse", "online_nll", "regret",
                  "test_rmse", "test_nll", "noise", "step_time"]
CLS_ONLINE_METRICS = ["step", "stem_loss", "gp_loss", "online_acc", "batch_acc", "regret", "test_acc", "step_time"]
# (a) skillcraft's surrogate (no skillcraft files in the repo): 19 inputs -> 2
# features, grid 16^2 = 256, batch_size 1; 16 logged steps give the step times
REG_ARGS = ["model=wiski_gp_regression", "dataset=skillcraft", "stem=linear", "num_batch_epochs=20",
            "logging_freq=16"]
REG_STREAM, REG_TWIN_STREAM = 256, 32
# (b) stream_mode=fused, two segments of 512 points
FUSED_ARGS = REG_ARGS[:-1] + ["stream_mode=fused", "logging_freq=512", "max_stream=1024"]
# (c) tests/experiments/test_drivers.py's classification configuration, deeper; its bar
CLS_DRIVER_ARGS = ["model=wiski_gpd", "dataset=banana", "stem=eye", "num_batch_epochs=30", "max_stream=200",
                   "logging_freq=10"]
CLS_DRIVER_GATE = 0.7
FIXED_NOISE_KW = dict(num_steps=50, eval_every=25)  # (d) at run()'s default grid of 30 (m = 900)
SWEEP_ARGS = ["model=wiski_gp_regression", "dataset=friedman", "stem=linear", "num_batch_epochs=20",
              "max_stream=256", "logging_freq=16"]  # (e)
DRIVER_TWIN_RTOL = 1e-3  # of each column's largest magnitude (regret: of its two terms')
RESUME_TOL = 1e-6

# (device memory bytes/s, f32 flop/s outside the tensor cores), NVIDIA data
# sheets, dense, at the full power limit
PEAKS = {
    "H100 SXM": (3.35e12, 67e12),
    "H100 PCIe": (2.0e12, 51e12),
}


def card_peaks(name: str):
    """The data-sheet peaks of the card; raises for a part not in PEAKS
    (the SXM part reports itself as e.g. "NVIDIA H100 80GB HBM3")."""
    if "H100" not in name or "NVL" in name:
        raise ValueError(f"no peak rates for {name!r}; the bound needs one of {sorted(PEAKS)}")
    part = "H100 PCIe" if "PCIe" in name else "H100 SXM"
    return part, PEAKS[part]


def bound_ms(nbytes: float, flops: float, peaks):
    t_bytes, t_ops = nbytes / peaks[0], flops / peaks[1]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rank1_bound(Bd, m, peaks):
    """K2: L and B read and written, p read; two matvecs and two outer products."""
    return bound_ms(4 * (4 * Bd * m * m + Bd * m), Bd * (8 * m * m + 4 * m), peaks)


def chunk_bound(Bd, m, k, P, peaks):
    """K1: L and B read and written, the stencil read; the gather, the
    recursion (10 t m flops at step t) and the two rank-k applies."""
    return bound_ms(4 * (4 * Bd * m * m + Bd * k * P + k * P),
                    Bd * (2 * k * P * m + 5 * k * (k - 1) * m + 8 * m * m * k), peaks)


def pred_bound(Bd, m, k, P, peaks):
    """K3: C is symmetric, so C -= Z^T Z needs only its m (m + 1) / 2
    distinct entries read and written, at 2 k flops each (a SYRK)."""
    nbytes = 4 * (Bd * m * (m + 1) + 2 * Bd * m + 4 * Bd * k) + 8 * k * P
    return bound_ms(nbytes, Bd * (2 * k * P * m + k * (k - 1) * m + m * (m + 1) * k + 2 * m * k), peaks)


def chol_bound(Bd, m, peaks):
    """K6: Q read, L written; m^3 / 3 flops a matrix."""
    return bound_ms(4 * 2 * Bd * m * m, Bd * m**3 / 3, peaks)


def k6_plan(Bd, m, dev, lookahead=None):
    """K6's plan for (Bd, m, m) on this card (cuda_chol.cholesky_plan)."""
    return cuda_chol.cholesky_plan(m, Bd, _build.card_sms(dev), lookahead)


def k6_trailing_ms(stages):
    """The trailing update's share of a K6 call's kernel times."""
    return sum(ms for k, ms in stages.items() if k in cuda_chol.TRAIL_KERNELS.values())


def k6_route(plan):
    """K6's route at a plan: its panels and each trailing tile's count."""
    tiles = collections.Counter(pp.tile for pp in plan.panels)
    return (f"{len(plan.panels) + 1} panels of {CHOL_BLOCK}; trailing tiles "
            + ", ".join(f"{t} x {t} on {c}" for t, c in sorted(tiles.items(), reverse=True))
            + (" panels, look-ahead (next block on " + ", ".join(sorted({str(pp.next_tile) for pp in plan.panels}))
               + ")" if plan.lookahead else " panels"))


def rank1_library(L, B, p):
    """K2's yardstick: torch.mv and Tensor.addr_ per output."""
    s2 = torch.sum(p * p, dim=-1)
    s = torch.sqrt(s2)
    u = p / torch.clamp(s, min=1e-20)[:, None]
    c, d = torch.sqrt(s2 + 1) - 1, 1 / torch.sqrt(s2 + 1) - 1
    for b in range(L.shape[0]):
        L[b].addr_(torch.mv(L[b], u[b]) * c[b], u[b])
        B[b].addr_(torch.mv(B[b], u[b]) * d[b], u[b])


def chunk_library(U, Pm, R):
    """K1's yardstick: a chunk's applies, from the plain recursion's U, P, R,
    as baddbmm."""
    def library(L, B):
        L.baddbmm_(torch.bmm(L, R.mT), U)
        B.baddbmm_(torch.bmm(B, Pm.mT), U)

    return library


def pred_library(Zf, rf):
    """K3's yardstick: a chunk's applies, from the plain recursion's Z and r."""
    def library(C, mu):
        C.baddbmm_(Zf.mT, Zf, alpha=-1.0)
        mu.add_(torch.bmm(Zf.mT, rf[..., None])[..., 0])

    return library


def k1_apply_kernels(k, rows, m):
    """The CUDA kernels of K1's apply at (k, rows, m), with their launches
    a call: the cluster kernel where chunk_apply_plan holds the shape, else
    the two tiled kernels."""
    if chunk_apply_plan(k, rows, m) is not None:
        return {"chunk_apply_cluster_kernel": 1}
    return {"chunk_apply_t_kernel": 1, "chunk_apply_x_kernel": 1}


def k3_apply_kernels(Bd, rows, m):
    """The CUDA kernel of K3's apply at (Bd, rows, m) on card 0: its tile
    height's."""
    return {f"pred_apply{k3_apply_plan(Bd, rows, m).tile_rows}_kernel": 1}


def k3_apply_plan(Bd, rows, m):
    return pred_apply_plan(Bd, rows, m, _build.card_sms(torch.device("cuda", 0)))


def time_ms(fn, make_args, reps=TIMING_REPS):
    """Mean time of fn(*make_args()) between two CUDA events; the inputs
    are made fresh (outside the timed span) since the kernels update
    them in place. For a call of a few microseconds of device work this
    is the host's time to issue it, not the device's."""
    for _ in range(2):
        fn(*make_args())
    spans = []
    for _ in range(reps):
        args = make_args()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def profile_window(fn, make_args, kernels, reps, pad_s=PROFILE_PAD_S):
    """One torch.profiler window over reps calls of fn(*make_args()),
    opened pad_s seconds before the first launch. Returns the profiler and
    {kernel: (records, device us)} for the named kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(reps):
            fn(*make_args())
        torch.cuda.synchronize()
    records = dict.fromkeys(kernels, (0, 0.0))
    for ev in prof.key_averages():
        for kname in kernels:
            if f"::{kname}(" in ev.key:
                records[kname] = (ev.count, ev.self_device_time_total)
    return prof, records


def device_ms(fn, make_args, kernels, reps=TIMING_REPS):
    """Mean device time per call of fn(*make_args()), summed over the named
    CUDA kernels from torch.profiler, and each kernel's share. The inputs
    are made fresh before each call, as in time_ms; the copies that makes
    are other kernels and are not counted. ``kernels`` maps each CUDA
    kernel's name to its launches per call. Each window runs
    PROFILE_EXTRA_CALLS calls more than it counts, first, and the time is
    the mean over each kernel's last reps x launches records: torch.profiler
    may lose the records of a window's first launches even after the pad
    (on an H100, three windows in a row lost the first 3 of K2's 20 at
    m = 256, and three in a row the first 6 of its 25 on phase 9's state).
    A window that kept fewer is printed and profiled again, with as many
    more calls first as the short window lost, up to PROFILE_ATTEMPTS
    windows, and then this raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())
    torch.cuda.synchronize()
    extra = PROFILE_EXTRA_CALLS
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps + extra):
                fn(*make_args())
            torch.cuda.synchronize()
        records = {k: sorted((e.time_range.start, e.time_range.end - e.time_range.start) for e in prof.events()
                             if e.device_type == DeviceType.CUDA and f"::{k}(" in e.name) for k in kernels}
        short = {k: len(v) for k, v in records.items() if len(v) < reps * kernels[k]}
        if not short:
            per_kernel = {k: sum(d for _, d in v[-reps * kernels[k]:]) / reps / 1e3 for k, v in records.items()}
            return sum(per_kernel.values()), per_kernel
        want = {k: reps * kernels[k] for k in short}
        lost = max(-(-((reps + extra) * kernels[k] - n) // kernels[k]) for k, n in short.items())
        print(f"  torch.profiler recorded {short} launches of at least {want} ({reps + extra} calls); "
              f"profiling again with {lost} calls more first")
        extra += lost
    raise AssertionError(f"no profile of {PROFILE_ATTEMPTS} recorded every launch of {sorted(kernels)}")


def device_span_ms(fn, make_args, kernels=None, reps=TIMING_REPS):
    """(mean device span, {kernel: mean summed duration}) per call of
    fn(*make_args()). The span runs from the start of the call's first
    CUDA activity to the end of its last (torch.profiler). A spin kernel
    (torch.cuda._sleep, SPIN_CYCLES) runs on the stream just before each
    call, so every launch of the call is queued before the device reaches
    it: the span is the device's time for the call, not the host's time to
    issue it. For kernels launched with programmatic dependent launch this
    is the call's device time; their summed durations also count the time
    a kernel sat scheduled, waiting on the one before. ``kernels`` maps the CUDA kernels to count
    to their launches per call (the copies make_args makes are other
    kernels); None counts every CUDA activity of the window but the spin,
    and then make_args must launch nothing. Each window runs
    PROFILE_EXTRA_CALLS calls more than it counts, first, and keeps the
    last reps: torch.profiler may lose the records of a window's first
    launches even after the pad (on an H100, three windows in a row lost
    one of K6's 23 records at m = 900; others lost two whole calls of K6
    at m = 256). A window
    whose kept calls were not each recorded whole is printed and profiled
    again, up to PROFILE_ATTEMPTS windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*make_args())
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps + PROFILE_EXTRA_CALLS):
                args = make_args()
                torch.cuda.synchronize()
                torch.cuda._sleep(SPIN_CYCLES)
                fn(*args)
                torch.cuda.synchronize()
        events = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
            and (kernels is None or any(f"::{k}(" in e.name for k in kernels)))
        calls = []  # [start, end, activities] per call, split where a spin stood between
        for start, end, _ in events:
            if calls and start - calls[-1][1] < SPAN_SPLIT_US:
                calls[-1][1] = max(calls[-1][1], end)
                calls[-1][2] += 1
            else:
                calls.append([start, end, 1])
        kept = calls[-reps:]  # the window's first calls are dropped (or lost in part)
        if kernels is None:  # no count per call to check: no call may have split
            whole = len(calls) <= reps + PROFILE_EXTRA_CALLS
        else:
            whole = all(n == sum(kernels.values()) for _, _, n in kept)
        if len(calls) >= reps and whole:
            stages = {k: sum(end - start for start, end, name in events
                             if start >= kept[0][0] and f"::{k}(" in name) / reps / 1e3
                      for k in kernels or {}}
            return sum(end - start for start, end, _ in kept) / reps / 1e3, stages
        print(f"  torch.profiler recorded {len(calls)} calls of {reps} + {PROFILE_EXTRA_CALLS} "
              f"(activities per call {[n for _, _, n in calls]}); profiling again")
    raise AssertionError(f"no profile of {PROFILE_ATTEMPTS} recorded every call of {fn}")


def max_err(got, want, tol, what, atol=None):
    """max |got - want| over the pairs; raises unless allclose at rtol tol
    and atol ``atol`` (tol by default)."""
    atol = tol if atol is None else atol
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite kernel output")
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > atol + tol * w.abs()).any()):
            raise AssertionError(f"{what}: max abs err {float(diff.max()):.3e} exceeds tol {tol:g} (atol {atol:g})")
    return worst


def clone_all(*ts):
    return tuple(t.clone() for t in ts)


# the launch counters of the main-path kernels (K2, K1, K3, K6), zeroed just
# before a path window and read just after
COUNTED = [(rank1_apply, "launches"), (blocked_chunk, "launches"), (blocked_chunk, "cluster_launches"),
           (blocked_chunk, "grid_cluster_launches"), (pred_chunk, "launches"), (pred_chunk, "cluster_launches"),
           (pred_chunk, "wide_cluster_launches"), (blocked_cholesky, "launches")]


def zero_counters():
    for wrapper, attr in COUNTED:
        setattr(wrapper, attr, 0)
    zero_apply_counters()


def read_counters():
    return {"rank1_apply": rank1_apply.launches, "blocked_chunk": blocked_chunk.launches,
            "chunk_recursion_cluster": blocked_chunk.cluster_launches, "pred_chunk": pred_chunk.launches,
            "pred_recursion_cluster": pred_chunk.cluster_launches, "blocked_cholesky": blocked_cholesky.launches}


# K1's and K3's applies (the last stage of every chunk) counted by shape,
# zeroed with the counters above; PATH_APPLIES sums the path windows',
# (name, Bd, rows, m, k) -> launches, for phase 13's rows
PATH_APPLIES = collections.Counter()


def zero_apply_counters():
    chunk_apply_plan.launches = chunk_apply_plan.tiled_launches = pred_apply_plan.launches = 0
    chunk_apply_plan.shapes.clear()
    pred_apply_plan.shapes.clear()


def read_apply_counters():
    return {"chunk_apply_cluster": chunk_apply_plan.launches, "chunk_apply_tiled": chunk_apply_plan.tiled_launches,
            "pred_apply": pred_apply_plan.launches}


def read_apply_shapes():
    """The applies launched since the counters were zeroed, by (name, Bd,
    rows, m, k)."""
    out = {("chunk_apply", *shape): n for shape, n in chunk_apply_plan.shapes.items()}
    out.update({("pred_apply", *shape): n for shape, n in pred_apply_plan.shapes.items()})
    return out


def read_window():
    """read_counters() at the end of a path window; the window's applies
    by shape go into PATH_APPLIES."""
    PATH_APPLIES.update(read_apply_shapes())
    return read_counters()


# --------------------------------------------------------------------------
# inputs at the main path's shapes
# --------------------------------------------------------------------------


def bench_model(dev):
    grid = Grid.create([(-1.1, 1.1)] * 2, M_SIDE, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    return model, model.init_params(2)


def synthetic_roots(rng, Bd, m, dev):
    """(L, B) of the well-conditioned A = W W^T/m + I, as the JAX package's
    kernel tests build them (tests/ops/test_pallas_batched.py)."""
    W = torch.tensor(rng.normal(size=(Bd, m, m)), device=dev)
    A = W @ W.mT / m + torch.eye(m, dtype=W.dtype, device=dev)
    L = torch.linalg.cholesky(A)
    B = torch.linalg.solve_triangular(L.mT, torch.eye(m, dtype=W.dtype, device=dev), upper=True)
    return L.float().contiguous(), B.float().contiguous()


def stencil(rng, grid, n, dev):
    x = torch.tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32, device=dev)
    idx, w = interp_coeffs(grid, x)
    return x, idx.to(torch.int32).contiguous(), w.contiguous()


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------


def check_rank1(rng, grid, peaks, dev):
    m = grid.num_points
    out = {}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 1, dev)
        p = torch.einsum("p,bpm->bm", w[0], B[:, idx[0].long()]).contiguous()
        if Bd == 2:
            p[1] = 0.0  # p = 0 is an exact no-op
        want = rank1_apply_plain(L, B, p)
        got = rank1_apply(*clone_all(L, B), p)
        torch.cuda.synchronize()
        err = max_err(got, want, 1e-5, f"rank1_apply Bd={Bd}")
        if Bd == 2 and not (torch.equal(got[0][1], L[1]) and torch.equal(got[1][1], B[1])):
            raise AssertionError("rank1_apply: p = 0 changed the roots")

        make = lambda: (*clone_all(L, B), p)
        bms, by = rank1_bound(Bd, m, peaks)
        ms, stages = device_ms(rank1_apply, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1})
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(rank1_apply, make),
            plain_ms=time_ms(rank1_apply_plain, make), library_ms=time_ms(rank1_library, make),
            bound_ms=bms, bound_by=by,
        )
    return out


def plain_stream(L, B, idx, wv, k, **kw):
    for c in range(idx.shape[0] // k):
        L, B = blocked_chunk_plain(L, B, idx[c * k : (c + 1) * k], wv[:, c * k : (c + 1) * k], **kw)
    return L, B


def check_blocked_chunk(rng, grid, peaks, dev):
    """K1 against its plain version; returns the chunk's results and its
    one-cluster recursion's (chunk_recursion_carried_kernel within the
    chunk at m = 900)."""
    m = grid.num_points
    plan, recursion = k1_route(K, m, "cluster")
    out, rec = {}, {}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 4 * K, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        i1, wv1 = idx[:K].contiguous(), wv[:, :K].contiguous()
        want = blocked_chunk_plain(L, B, i1, wv1)
        got = blocked_chunk(*clone_all(L, B), i1, wv1)
        again = blocked_chunk(*clone_all(L, B), i1, wv1)
        torch.cuda.synchronize()
        err = max_err(got, want, 1e-5, f"blocked_chunk Bd={Bd}")
        bitwise(got, again, f"blocked_chunk Bd={Bd}")
        want_s = plain_stream(L, B, idx, wv, K)
        Lk, Bk = clone_all(L, B)
        for c in range(4):
            Lk, Bk = blocked_chunk(Lk, Bk, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous())
        torch.cuda.synchronize()
        err_stream = max_err((Lk, Bk), want_s, 2e-4, f"blocked_chunk 4-chunk stream Bd={Bd}")

        # the yardstick applies this chunk's U, P, R from the plain recursion
        p0 = torch.einsum("bkp,bkpm->bkm", wv1, B[:, i1.long()])
        library = chunk_library(*blocked_factors(p0))
        make = lambda: (*clone_all(L, B), i1, wv1)
        bms, by = chunk_bound(Bd, m, K, idx.shape[1], peaks)
        ms, stages = device_ms(blocked_chunk, make, {
            "chunk_gather_kernel": 1, recursion: 1, **k1_apply_kernels(K, m, m)})
        out[Bd] = dict(
            max_abs_err=err, stream_max_abs_err=err_stream, ms=ms, stages_ms=stages,
            wrapper_ms=time_ms(blocked_chunk, make), plain_ms=time_ms(blocked_chunk_plain, make),
            library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
        )
        # a, p, U p, P^T g, R^T g: 10 t m flops at step t; p0 in, U, P, R out
        bms, by = bound_ms(4 * 4 * Bd * K * m, Bd * 5 * K * (K - 1) * m, peaks)
        rec[Bd] = dict(
            max_abs_err=err, ms=stages[recursion], kernel=recursion, cluster=plan.cluster,
            shared_bytes=plan.shared_bytes, plain_ms=time_ms(blocked_factors, lambda: (p0,)),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
    out["outside"] = check_chunk_outside_envelope(rng, dev)
    return out, rec


def route_name(plan):
    """A recursion plan's route: "cluster" (one cluster of 8 blocks an
    output), "wide" (one of 16), "grid" (G >= 2 clusters of 8) or "spread"
    (over the card)."""
    if isinstance(plan, _build.SpreadPlan):
        return "spread"
    if plan.clusters > 1:
        return "grid"
    return "wide" if plan.cluster == 16 else "cluster"


def expect_route(plan, expect, what):
    """Raise unless the wrappers' planner took the route ``expect`` the
    caller names for this shape (route_name)."""
    if route_name(plan) != expect:
        raise AssertionError(f"{what} was expected on the {expect} route; the wrappers' planner takes the "
                             f"{recursion_route(plan)}")


def k1_route(k, m, expect):
    """(plan, CUDA kernel) of K1's recursion at (k, m) on card 0, as the
    wrappers take it for a flat chunk, after checking that this is the
    route ``expect``: one cluster of 8 ("cluster", the carried kernel),
    G >= 2 of them ("grid", the grid kernel) or spread over the card
    ("spread")."""
    plan = _build.route(cuda_root_update._root_update_lib(), cuda_root_update.K1, 1, k, m, torch.device("cuda", 0)).plan
    expect_route(plan, expect, f"K1's recursion at (k={k}, m={m})")
    if expect == "spread":
        return plan, f"chunk_recursion_spread_kernel<{plan.slices}>"
    return plan, "chunk_recursion_carried_kernel" if expect == "cluster" else "chunk_recursion_grid_kernel"


def k3_route(k, m, P, expect):
    """(plan, CUDA kernel) of K3's recursion at (k, m, P) on card 0, after
    checking that this is the route ``expect``: one cluster of 8
    ("cluster") or of 16 ("wide"), or spread over the card ("spread")."""
    plan = _build.route(cuda_pred_stream._pred_stream_lib(), cuda_pred_stream.K3, 1, k, m, torch.device("cuda", 0),
                        P).plan
    expect_route(plan, expect, f"K3's recursion at (k={k}, m={m}, P={P})")
    if expect == "spread":
        return plan, f"pred_recursion_spread_kernel<{plan.slices}>"
    return plan, "pred_recursion_cluster_kernel"


def recursion_route(plan):
    """A recursion plan in words."""
    if isinstance(plan, _build.SpreadPlan):
        return (f"recursion spread over {plan.clusters} clusters of {plan.cluster} blocks, {plan.cols} columns, "
                f"{plan.slices} slices and {plan.shared_bytes} bytes a block")
    return (f"recursion on {plan.clusters} cluster{'s' * (plan.clusters > 1)} of {plan.cluster} blocks, "
            f"{plan.cols} columns and {plan.shared_bytes} bytes a block")


def check_chunk_outside_envelope(rng, dev):
    """One K1 chunk at a shape one cluster does not hold (OUTSIDE_SIDE^2
    grid, k = K): it runs the grid recursion kernel on G > 1 clusters of 8,
    against the plain version."""
    grid = Grid.create([(-1.1, 1.1)] * 2, OUTSIDE_SIDE, device=dev)
    m = grid.num_points
    plan = chunk_cluster_plan(K, m)
    if plan is None or plan.clusters < 2:
        raise AssertionError(f"(k={K}, m={m}) was meant to lie outside one cluster's envelope, on G > 1 clusters")
    L, B = synthetic_roots(rng, 1, m, dev)
    _, idx, w = stencil(rng, grid, K, dev)
    wv = w[None].contiguous()
    before = (blocked_chunk.launches, blocked_chunk.cluster_launches, blocked_chunk.grid_cluster_launches)
    got = blocked_chunk(*clone_all(L, B), idx, wv)
    torch.cuda.synchronize()
    if (blocked_chunk.launches - before[0], blocked_chunk.cluster_launches - before[1],
            blocked_chunk.grid_cluster_launches - before[2]) != (1, 1, 1):
        raise AssertionError(f"blocked_chunk at m={m} did not take the grid recursion")
    err = max_err(got, blocked_chunk_plain(L, B, idx, wv), 1e-5, f"blocked_chunk m={m}")
    make = lambda: (*clone_all(L, B), idx, wv)
    ms, stages = device_ms(blocked_chunk, make, {
        "chunk_gather_kernel": 1, "chunk_recursion_grid_kernel": 1, **k1_apply_kernels(K, m, m)})
    return dict(m=m, k=K, max_abs_err=err, ms=ms, stages_ms=stages, route=recursion_route(plan))


def bitwise(got, again, what):
    """Raise unless two calls on the same inputs gave identical outputs."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: two calls on the same inputs differ")


def check_pred_chunk(rng, grid, model, params, peaks, dev):
    """K3 against its plain version; returns the chunk's results and its
    cluster recursion's (pred_recursion_cluster_kernel within the chunk)."""
    m = grid.num_points
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_init(model, x0, y0, torch.ones_like(y0))
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    out, rec = {}, {}
    for Bd in (1, 2):
        C = torch.cat([cov_cache, 0.9 * cov_cache])[:Bd].contiguous()
        mu = torch.cat([mean_cache[..., 0], -mean_cache[..., 0]])[:Bd].contiguous()
        x, idx, w = stencil(rng, grid, K, dev)
        y = (torch.sin(3 * x[:, 0])[None] * torch.tensor([1.0, 0.5][:Bd], device=dev)[:, None]).contiguous()
        nz = torch.ones((Bd, K), device=dev)
        want = pred_chunk_stencil_plain(C, mu, idx, w, y, nz)
        got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        again = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        torch.cuda.synchronize()
        err = max_err(got, want, 2e-4, f"pred_chunk Bd={Bd}")
        bitwise(got, again, f"pred_chunk Bd={Bd}")

        # the yardstick applies this chunk's Z and r from the plain recursion
        S = stencil_rows(idx, w, m)
        plain_args = (S, S @ C, mu @ S.mT, y, nz)
        library = pred_library(*pred_chunk_factors(*plain_args)[:2])
        make = lambda: (*clone_all(C, mu), idx, w, y, nz)
        P = idx.shape[1]
        bms, by = pred_bound(Bd, m, K, P, peaks)
        ms, stages = device_ms(pred_chunk, make, {"pred_gather_kernel": 1, "pred_recursion_cluster_kernel": 1,
                                                  **k3_apply_kernels(Bd, m, m)})
        out[Bd] = dict(
            max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(pred_chunk, make),
            plain_ms=time_ms(pred_chunk_stencil_plain, make),
            library_ms=time_ms(library, lambda: clone_all(C, mu)), bound_ms=bms, bound_by=by,
        )
        # a: 2 t P, ct: 2 t m flops at step t; c0w in, Z out
        bms, by = bound_ms(4 * (2 * Bd * K * m + 5 * Bd * K) + 8 * K * P, Bd * K * (K - 1) * (m + P), peaks)
        plan = pred_cluster_plan(K, m, P)
        rec[Bd] = dict(
            max_abs_err=err, ms=stages["pred_recursion_cluster_kernel"], cluster=plan.cluster,
            shared_bytes=plan.shared_bytes, plain_ms=time_ms(pred_chunk_factors, lambda: plain_args),
            library_ms=None, bound_ms=bms, bound_by=by,
        )
    out["outside"] = check_pred_chunk_outside_envelope(rng, grid, cov_cache, mean_cache[..., 0], dev)
    return out, rec


def check_pred_chunk_outside_envelope(rng, grid, C, mu, dev):
    """One K3 chunk at a shape no cluster holds (k = OUTSIDE_K3 at the main
    path's m): its recursion runs spread over the card, against the plain
    version."""
    m = grid.num_points
    x, idx, w = stencil(rng, grid, OUTSIDE_K3, dev)
    if pred_cluster_plan(OUTSIDE_K3, m, idx.shape[1]) is not None:
        raise AssertionError(f"(k={OUTSIDE_K3}, m={m}) was meant to lie outside the cluster envelope")
    C, mu = C.contiguous(), mu.contiguous()
    y = torch.sin(3 * x[:, 0])[None].contiguous()
    nz = torch.ones((1, OUTSIDE_K3), device=dev)
    before = (pred_chunk.launches, pred_chunk.cluster_launches, pred_chunk.spread_launches)
    got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    torch.cuda.synchronize()
    if (pred_chunk.launches - before[0], pred_chunk.cluster_launches - before[1],
            pred_chunk.spread_launches - before[2]) != (1, 0, 1):
        raise AssertionError(f"pred_chunk at k={OUTSIDE_K3} did not take the spread recursion")
    err = max_err(got, pred_chunk_stencil_plain(C, mu, idx, w, y, nz), 2e-4, f"pred_chunk k={OUTSIDE_K3}")
    make = lambda: (*clone_all(C, mu), idx, w, y, nz)
    plan, recursion = k3_route(OUTSIDE_K3, m, idx.shape[1], "spread")
    ms, stages = device_ms(pred_chunk, make, {
        "pred_gather_kernel": 1, recursion: 1, **k3_apply_kernels(1, m, m)})
    return dict(m=m, k=OUTSIDE_K3, max_abs_err=err, ms=ms, stages_ms=stages, route=recursion_route(plan))


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------


def plain_prefix_roots(model, roots, xs, ns):
    """bench.py's gate oracle: one plain dense rank-1 root update per point."""
    m = model.grid.num_points
    for i in range(xs.shape[0]):
        idx, w = interp_coeffs(model.grid, xs[i : i + 1], detach=True)
        v = dense_w(idx, w, m)[None] / torch.sqrt(torch.clamp(ns[i : i + 1], min=1e-7)).T[:, None, :]
        roots = root_cache_update(roots, v)
    return roots


def main_path(rng, model, params, card, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_slim(wiski_init(model, x0, y0, torch.ones_like(y0)))

    def points(n):
        x = torch.tensor(rng.uniform(-1, 1, (n, 2)), **f32)
        y = torch.sin(3 * x[:, :1])
        return x, y, torch.ones_like(y)

    xs, ys, ns = points(N_STREAM)
    xc, yc, nc = points(N_COND * (1 + HOST_REPEATS))
    xt, _, _ = points(N_TEST)
    xp, yp, npr = points(N_PREQ)
    gate_roots = RootCache(None, state.roots.root.clone(), state.roots.inv_root.clone())
    torch.cuda.synchronize()

    wrappers = (rank1_apply, blocked_chunk, pred_chunk, blocked_cholesky)  # K6: Q of the prediction caches
    for wrapper in wrappers:
        wrapper.launches = 0
    blocked_chunk.cluster_launches = pred_chunk.cluster_launches = 0
    blocked_chunk.grid_cluster_launches = pred_chunk.wide_cluster_launches = 0
    zero_apply_counters()
    t0 = time.perf_counter()
    state = wiski_stream(model, state, xs, ys, ns, block_size=K)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cond_s = []  # the 256-call loop, one warm-up and HOST_REPEATS timed
    for rep in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        for i in range(rep * N_COND, (rep + 1) * N_COND):
            state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], nc[i : i + 1])
        torch.cuda.synchronize()
        cond_s.append(time.perf_counter() - r0)
    pred_s = []  # caches + predict, the same
    for _ in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        caches = wiski_prediction_caches(model, params, state)
        mean, var = wiski_predict(model, params, state, xt, caches=caches)
        torch.cuda.synchronize()
        pred_s.append(time.perf_counter() - r0)
    t3 = time.perf_counter()
    state, caches, pm, pv = wiski_prequential_stream(model, params, state, caches, xp, yp, npr, block_size=K)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    launches = {w.__name__: w.launches for w in wrappers}
    launches["chunk_recursion_cluster"] = blocked_chunk.cluster_launches
    launches["pred_recursion_cluster"] = pred_chunk.cluster_launches
    PATH_APPLIES.update(read_apply_shapes())

    print(f"main path on {card}:")
    print(f"  wiski_stream {N_STREAM} points, block {K}: {N_STREAM / (t1 - t0):.1f} updates/s ({t1 - t0:.4f} s)")
    rates = [N_COND / t for t in cond_s[1:]]
    print(f"  wiski_condition x{N_COND}, {HOST_REPEATS} repeats after a warm-up: median "
          f"{np.median(rates):.1f} updates/s, spread {min(rates):.1f}-{max(rates):.1f}")
    print(f"  prediction caches + predict {N_TEST} points, {HOST_REPEATS} repeats after a warm-up: median "
          f"{np.median(pred_s[1:]):.5f} s, spread {min(pred_s[1:]):.5f}-{max(pred_s[1:]):.5f}")
    print(f"  wiski_prequential_stream {N_PREQ} points: {N_PREQ / (t4 - t3):.1f} points/s ({t4 - t3:.4f} s)")
    print(f"  kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if (launches["chunk_recursion_cluster"], launches["pred_recursion_cluster"]) != (
            launches["blocked_chunk"], launches["pred_chunk"]):
        raise AssertionError("a chunk of the main path at m = 900 did not run its recursion on a cluster")
    if blocked_chunk.grid_cluster_launches or pred_chunk.wide_cluster_launches:
        raise AssertionError("a chunk of the main path at m = 900 left its one cluster of 8 (K1: the carried kernel)")

    if tuple(mean.shape) != (1, N_TEST) or tuple(var.shape) != (1, N_TEST):
        raise AssertionError(f"predict shapes {tuple(mean.shape)}, {tuple(var.shape)}")
    for name, t in [("mean", mean), ("var", var), ("pred_mean", pm), ("pred_var", pv)]:
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {name}")
    rmse = float(torch.sqrt(torch.mean((mean[0] - torch.sin(3 * xt[:, 0])) ** 2)))
    preq_rmse = float(torch.sqrt(torch.mean((pm[0] - yp[:, 0]) ** 2)))
    print(f"  held-out RMSE vs sin(3 x0): {rmse:.6f}; prequential RMSE: {preq_rmse:.6f}")
    if not rmse < 0.1:
        raise AssertionError(f"held-out RMSE {rmse} is not below 0.1")

    # bench.py's gate: the blocked stream (K1) against the plain per-point
    # root update over a 256-point prefix
    n_check = 256
    checked = wiski_stream(model, state._replace(roots=RootCache(None, gate_roots.root.clone(), gate_roots.inv_root.clone())),
                           xs[:n_check], ys[:n_check], ns[:n_check], block_size=K)
    oracle = plain_prefix_roots(model, gate_roots, xs[:n_check], ns[:n_check])
    err = float((checked.roots.root - oracle.root).abs().max())
    scale = float(oracle.root.abs().max())
    inv_err = float((checked.roots.inv_root - oracle.inv_root).abs().max())
    print(f"  prefix gate: root err {err:.3e} (scale {scale:.3e}), inverse root err {inv_err:.3e}")
    if not err <= 1e-3 * max(scale, 1.0):
        raise AssertionError(f"stream/plain root drift {err:.3e} over {n_check} updates")
    check = wiski_check_decomposition(state)
    inv_root_err = float(check["inverse_root_err"].max())
    print(f"  wiski_check_decomposition inverse_root_err: {inv_root_err:.6e}")
    if not math.isfinite(inv_root_err):
        raise AssertionError("inverse_root_err is not finite")
    profile_main_path(model, params, state, caches, (xs, ys, ns), (xp, yp, npr))
    return launches, state


def profile_main_path(model, params, state, caches, stream, preq, n=2 * K):
    """The CUDA kernels torch.profiler records over a short pass of the
    main path's streams (n points of each) on copies of its final state:
    the one-cluster recursions run (K1's by the carried kernel), and no
    other recursion kernel (K1's cluster, grid or spread kernel, K3's
    spread kernel) does."""
    from torch.profiler import ProfilerActivity, profile

    copy = lambda st: st._replace(roots=RootCache(None, st.roots.root.clone(), st.roots.inv_root.clone()))
    caches = tuple(c.clone() for c in caches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        wiski_stream(model, copy(state), *(a[:n] for a in stream), block_size=K)
        wiski_prequential_stream(model, params, copy(state), caches, *(a[:n] for a in preq), block_size=K)
        torch.cuda.synchronize()
    counts = {}
    for ev in prof.key_averages():
        hit = re.search(r"::((?:chunk|pred)_recursion_\w+(?:<\d+>)?)\(", ev.key)
        if hit:
            counts[hit.group(1)] = counts.get(hit.group(1), 0) + ev.count
    print(f"  recursion kernels recorded over {n} + {n} main-path points: {json.dumps(counts)}")
    if not (counts.get("chunk_recursion_carried_kernel") and counts.get("pred_recursion_cluster_kernel")):
        raise AssertionError("torch.profiler recorded no one-cluster recursion on the main path")
    others = sorted(set(counts) - {"chunk_recursion_carried_kernel", "pred_recursion_cluster_kernel"})
    if others:
        raise AssertionError(f"the main path at m = 900 launched recursion kernels off one cluster: {others}")


def profile_condition(rng, model, dev):
    """The host ops of a short per-point wiski_condition loop, from
    torch.profiler (its host time against its device time)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_slim(wiski_init(model, x0, y0, torch.ones_like(y0)))
    n = 16
    xc = torch.tensor(rng.uniform(-1, 1, (n + 1, 2)), dtype=torch.float32, device=dev)
    yc = torch.sin(3 * xc[:, :1])
    state = wiski_condition(model, state, xc[n:], yc[n:], torch.ones_like(yc[n:]))
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for i in range(n):
            state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], torch.ones_like(yc[i : i + 1]))
        torch.cuda.synchronize()
    print(f"wiski_condition x{n}, host ops by self CPU time:")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


# --------------------------------------------------------------------------
# phase 4: the remaining kernels' entry points at m = 900
# --------------------------------------------------------------------------


def dense_updates(grid, x, noise):
    """(n, Bd, m, 1) dense update vectors v = W_x/sqrt(noise), one per point,
    as plain_prefix_roots builds them; noise is (n, Bd)."""
    idx, w = interp_coeffs(grid, x, detach=True)
    W = dense_w(idx, w, grid.num_points)  # (m, n)
    v = W.T[:, None, :] / torch.sqrt(torch.clamp(noise, min=1e-7))[:, :, None]
    return v[..., None].contiguous()


def rel_max_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def q_matrix(model, params, state):
    """Q = I + L^T Kuu_hat L of a WISKI state, Kuu_hat = K_uu / s2 (the
    learned second noise, where the model has one), as the MLL and the
    prediction caches form it."""
    Kuu = grid_kuu_dense(model.kernel, params["kernel"], model.grid).detach()
    if model.learn_additional_noise:
        Kuu = Kuu / torch.exp(params["raw_second_noise"].detach())[:, None, None]
    L = state.roots.root
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return (eye + L.mT @ (Kuu @ L)).contiguous()


def remaining_path(rng, model, params, final_state, card, dev):
    """Phase 4's path: K4, K5 and K6 through their entry points on WISKI
    states at the bench width. Returns the launch counts of this path."""
    f32 = dict(dtype=torch.float32, device=dev)
    grid = model.grid
    m = grid.num_points
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    model2 = WiskiModel(RBFKernel(), grid, num_outputs=2, learn_additional_noise=True)
    noise2 = torch.tensor([1.0, 0.5], **f32).expand(N_SEED, 2).contiguous()
    full1 = wiski_init(model, x0, y0, torch.ones_like(y0))
    full2 = wiski_init(model2, x0, y0 * torch.tensor([1.0, 0.5], **f32), noise2)
    xk = torch.tensor(rng.uniform(-1, 1, (N_K4, 2)), **f32)
    v1 = dense_updates(grid, xk, torch.ones((N_K4, 1), **f32))
    k4_cases = {
        "full Bd=1": (full1, v1),
        "full Bd=2": (full2, dense_updates(grid, xk, noise2[:1].expand(N_K4, 2))),
        "slim Bd=1": (wiski_slim(full1), v1),
    }
    x5 = torch.tensor(rng.uniform(-1, 1, (4 * K, 2)), **f32)
    idx5, w5 = interp_coeffs(grid, x5, detach=True)
    idx5 = idx5.to(torch.int32).contiguous()
    wv5 = w5[None].contiguous()  # noise 1
    Q = q_matrix(model, params, final_state)
    starts = {name: RootCache(*(None if t is None else t.clone() for t in st.roots)) for name, (st, _) in k4_cases.items()}
    k5_start = (final_state.roots.root.clone(), final_state.roots.inv_root.clone())
    torch.cuda.synchronize()

    counters = [(rank1_update, "launches"), (blocked_chunk, "sub_launches"), (blocked_chunk, "sub_cluster_launches"),
                (blocked_chunk, "coord_launches"), (blocked_cholesky, "launches")]
    for wrapper, attr in counters:
        setattr(wrapper, attr, 0)
    zero_apply_counters()
    t0 = time.perf_counter()
    k4_out = {}
    for name, (_, vs) in k4_cases.items():
        roots = RootCache(*(None if t is None else t.clone() for t in starts[name]))
        for i in range(N_K4):
            roots = fused_root_cache_update(roots, vs[i])
        k4_out[name] = roots
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    k5_out = {}
    for kname, kw in VARIANTS.items():
        Lk, Bk = (t.clone() for t in k5_start)
        for c in range(4):
            rows = slice(c * K, (c + 1) * K)
            Lk, Bk = blocked_chunk(Lk, Bk, idx5[rows].contiguous(), wv5[:, rows].contiguous(), **kw)
        k5_out[kname] = (Lk, Bk)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    Lq = blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {
        "rank1_update": rank1_update.launches,
        "blocked_chunk_sub": blocked_chunk.sub_launches,
        "chunk_sub_cluster": blocked_chunk.sub_cluster_launches,
        "blocked_chunk_coord": blocked_chunk.coord_launches,
        "blocked_cholesky": blocked_cholesky.launches,
    }
    PATH_APPLIES.update(read_apply_shapes())

    print(f"remaining kernels' entry points on {card}:")
    print(f"  fused_root_cache_update: 3 x {N_K4} dense-v updates in {t1 - t0:.4f} s")
    print(f"  blocked_chunk sub={SUB} and coord: 2 x 4 chunks of {K} in {t2 - t1:.4f} s")
    print(f"  blocked_cholesky of Q (m={m}, block {CHOL_BLOCK}): {t3 - t2:.4f} s")
    print(f"  kernel launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"phase 4 never launched {name}")
    if launches["chunk_sub_cluster"] != launches["blocked_chunk_sub"]:
        raise AssertionError(f"a K5-sub chunk at m = {m} did not run on the fused cluster kernel")

    for name, (st, vs) in k4_cases.items():
        oracle = starts[name]
        for i in range(N_K4):
            oracle = root_cache_update(oracle, vs[i])
        got = k4_out[name]
        scale = float(oracle.root.abs().max())
        err = float((got.root - oracle.root).abs().max())
        inv_err = float((got.inv_root - oracle.inv_root).abs().max())
        inv_scale = float(oracle.inv_root.abs().max())
        print(f"  K4 {name}: root err {err:.3e} (scale {scale:.3e}), inverse root err {inv_err:.3e} (scale {inv_scale:.3e})")
        if not (err <= 1e-3 * max(scale, 1.0) and inv_err <= 1e-3 * max(inv_scale, 1.0)):
            raise AssertionError(f"K4 {name}: roots drift from the plain update over {N_K4} updates")
        if oracle.mat is None:
            if got.mat is not None:
                raise AssertionError(f"K4 {name}: a slim cache came back with a Gram accumulator")
        else:
            print(f"  K4 {name}: A max abs err {max_err((got.mat,), (oracle.mat,), 1e-5, f'K4 {name} A'):.3e}")
        check = wiski_check_decomposition(st._replace(roots=got))
        errs = {key: float(val.max()) for key, val in check.items()}
        print(f"  K4 {name}: wiski_check_decomposition {json.dumps(errs)}")
        finite = [v for key, v in errs.items() if oracle.mat is not None or key == "inverse_root_err"]
        if not all(math.isfinite(v) for v in finite):
            raise AssertionError(f"K4 {name}: non-finite decomposition error")

    flat = plain_stream(*k5_start, idx5, wv5, K)
    for kname, kw in VARIANTS.items():
        want = plain_stream(*k5_start, idx5, wv5, K, **kw)
        err = max_err(k5_out[kname], want, 2e-4, f"{kname} 4-chunk stream on the final state")
        dist = max(float((a - b).abs().max()) for a, b in zip(k5_out[kname], flat))
        print(f"  {kname}: 4-chunk stream max abs err {err:.3e} vs plain, {dist:.3e} from the flat plain stream")

    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    lib = torch.linalg.cholesky(Q)
    e_plain, e_lib = rel_max_err(Lq, want), rel_max_err(Lq, lib)
    print(f"  K6 on Q: relative max err {e_plain:.3e} vs plain, {e_lib:.3e} vs torch.linalg.cholesky")
    if not (e_plain <= 5e-4 and e_lib <= 5e-4):
        raise AssertionError("K6 on Q exceeds the 5e-4 relative bound")
    if not bool((torch.triu(Lq, 1) == 0).all()):
        raise AssertionError("K6: the strict upper triangle is not exactly 0")
    return launches, Q


def check_rank1_update(rng, grid, peaks, dev):
    m = grid.num_points
    out = {}
    for label, Bd, slim in ((1, 1, False), (2, 2, False), ("slim Bd=1", 1, True)):
        L, B = synthetic_roots(rng, Bd, m, dev)
        A = None if slim else (L @ L.mT).contiguous()
        x = torch.tensor(rng.uniform(-1, 1, (1, 2)), dtype=torch.float32, device=dev)
        v = dense_updates(grid, x, torch.ones((1, Bd), device=dev))[0]
        if Bd == 2:
            v[1] = 0.0  # p = 0 is an exact no-op
        clone = lambda: (L.clone(), B.clone(), None if A is None else A.clone(), v)
        want = rank1_update_plain(L, B, A, v)
        got = rank1_update(*clone())
        again = rank1_update(*clone())
        torch.cuda.synchronize()
        pairs = [(g, w) for g, w in zip(got, want) if w is not None]
        err = max_err([g for g, _ in pairs], [w for _, w in pairs], 1e-5, f"rank1_update {label}")
        bitwise([g for g in got if g is not None], [a for a in again if a is not None], f"rank1_update {label}")
        if Bd == 2 and not (torch.equal(got[0][1], L[1]) and torch.equal(got[1][1], B[1]) and torch.equal(got[2][1], A[1])):
            raise AssertionError("rank1_update: v = 0 changed the state")

        def library(L, B, A, v):
            for b in range(L.shape[0]):
                vb = v[b, :, 0]
                p = torch.mv(B[b].T, vb)
                s2 = torch.dot(p, p)
                u = p / torch.clamp(torch.sqrt(s2), min=1e-20)
                L[b].addr_(torch.mv(L[b], u) * (torch.sqrt(s2 + 1) - 1), u)
                B[b].addr_(torch.mv(B[b], u) * (1 / torch.sqrt(s2 + 1) - 1), u)
                if A is not None:
                    A[b].addr_(vb, vb)

        nbytes = 4 * ((4 if slim else 6) * Bd * m * m + Bd * m)
        flops = Bd * ((10 if slim else 12) * m * m + 6 * m)
        bms, by = bound_ms(nbytes, flops, peaks)
        ms, stages = device_span_ms(rank1_update, clone, {"rank1_p_kernel": 1, "rank1_rows_kernel": 1})
        out[label] = dict(
            max_abs_err=err, ms=ms, kernel_sum_ms=sum(stages.values()), stages_ms=stages,
            wrapper_ms=time_ms(rank1_update, clone),
            plain_ms=time_ms(rank1_update_plain, clone), library_ms=time_ms(library, clone),
            bound_ms=bms, bound_by=by,
        )
    # above m = 1,024 the row kernel (K4's and K2's) loops over a row
    # instead of holding it in registers
    m2 = ROWS_OUTSIDE_REGS_M
    L, B = synthetic_roots(rng, 1, m2, dev)
    A = (L @ L.mT).contiguous()
    v = torch.tensor(rng.normal(size=(1, m2, 1)), dtype=torch.float32, device=dev)
    got = rank1_update(L.clone(), B.clone(), A.clone(), v)
    torch.cuda.synchronize()
    err = max_err(got, rank1_update_plain(L, B, A, v), 1e-5, f"rank1_update m={m2}")
    out[f"rows outside registers (m={m2})"] = dict(max_abs_err=err)
    return out


def check_chunk_variants(rng, grid, peaks, dev):
    """K5 (sub=SUB and coord) against its plain version at m = 900, Bd = 1
    and 2: one chunk to 1e-5, bitwise the same on a second call, a 4-chunk
    stream to 2e-4, the distance to flat K1, and device times with K1
    flat's beside them on the same inputs (flat_ms). The profiled kernel
    counts hold the design: sub is one gather, the fused cluster kernel and
    one apply, with no correction GEMM and no per-sub-block recursion; coord
    is the gather, M, its recursion, one rebuild GEMM and one apply. Then a
    K5-sub chunk on each side of the fused kernel's envelope edge."""
    m = grid.num_points
    apply = k1_apply_kernels(K, m, m)
    profile_kernels = {
        "blocked_chunk_sub": {"chunk_gather_kernel": 1, "chunk_sub_cluster_kernel": 1, **apply,
                              "batched_gemm_kernel": 0, "chunk_recursion_carried_kernel": 0},
        "blocked_chunk_coord": {"chunk_gather_kernel": 1, "coord_gram_kernel": 1, "coord_recursion_kernel": 1,
                                "batched_gemm_kernel": 1, **apply},
    }
    flat_kernels = {"chunk_gather_kernel": 1, k1_route(K, m, "cluster")[1]: 1, **apply}
    nb = K // SUB
    out = {kname: {} for kname in VARIANTS}
    for Bd in (1, 2):
        L, B = synthetic_roots(rng, Bd, m, dev)
        _, idx, w = stencil(rng, grid, 4 * K, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        i1, wv1 = idx[:K].contiguous(), wv[:, :K].contiguous()
        flat1 = blocked_chunk(*clone_all(L, B), i1, wv1)
        flat_s = clone_all(L, B)
        for c in range(4):
            flat_s = blocked_chunk(*flat_s, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous())
        make = lambda: (*clone_all(L, B), i1, wv1)
        flat_ms, _ = device_ms(blocked_chunk, make, flat_kernels)
        check_sub_kernel_at_sub_k(L, B, i1, wv1)
        p0 = torch.einsum("bkp,bkpm->bkm", wv1, B[:, i1.long()])
        for kname, kw in VARIANTS.items():
            want = blocked_chunk_plain(L, B, i1, wv1, **kw)
            before = blocked_chunk.sub_cluster_launches
            got = blocked_chunk(*clone_all(L, B), i1, wv1, **kw)
            again = blocked_chunk(*clone_all(L, B), i1, wv1, **kw)
            torch.cuda.synchronize()
            if kname == "blocked_chunk_sub" and blocked_chunk.sub_cluster_launches - before != 2:
                raise AssertionError(f"{kname} at m={m} did not take the fused cluster kernel")
            err = max_err(got, want, 1e-5, f"{kname} Bd={Bd}")
            bitwise(got, again, f"{kname} Bd={Bd}")
            want_s = plain_stream(L, B, idx, wv, K, **kw)
            got_s = clone_all(L, B)
            for c in range(4):
                got_s = blocked_chunk(*got_s, idx[c * K : (c + 1) * K].contiguous(), wv[:, c * K : (c + 1) * K].contiguous(), **kw)
            torch.cuda.synchronize()
            err_stream = max_err(got_s, want_s, 2e-4, f"{kname} 4-chunk stream Bd={Bd}")
            dist = max(float((a - b).abs().max()) for a, b in zip(got, flat1))
            dist_s = max(float((a - b).abs().max()) for a, b in zip(got_s, flat_s))

            # the yardstick applies this chunk's factors from the plain recursion
            if kname == "blocked_chunk_sub":
                U, Pm, R = blocked_factors_sub(p0, SUB)

                def library(L, B):
                    for lo in range(0, K, SUB):
                        rows = slice(lo, lo + SUB)
                        L.baddbmm_(torch.bmm(L, R[:, rows].mT), U[:, rows])
                        B.baddbmm_(torch.bmm(B, Pm[:, rows].mT), U[:, rows])

                # the local recursions, the Pallas association's two
                # correction GEMMs per pair of sub-blocks (4 sub^2 m flops),
                # the rank-K apply
                flops = Bd * (2 * K * idx.shape[1] * m + nb * 5 * SUB * (SUB - 1) * m
                              + nb * (nb - 1) // 2 * 4 * SUB * SUB * m + 8 * m * m * K)
            else:
                Ut, Pt, Rt = blocked_factors_coord(p0)
                TL, TB = Rt.mT @ Ut, Pt.mT @ Ut

                def library(L, B):
                    L.baddbmm_(torch.bmm(torch.bmm(L, p0.mT), TL), p0)
                    B.baddbmm_(torch.bmm(torch.bmm(B, p0.mT), TB), p0)

                # M = P0 P0^T (symmetric), the recursion (~7 K^3 / 3), the
                # flat factors from the lower-triangular Ut, Rt, Pt, one
                # rank-K apply
                flops = Bd * (2 * K * idx.shape[1] * m + K * (K + 1) * m + 7 * K**3 // 3
                              + 3 * K * (K + 1) * m + 8 * m * m * K)
            call = lambda L, B, i, w, kw=kw: blocked_chunk(L, B, i, w, **kw)
            plain = lambda L, B, i, w, kw=kw: blocked_chunk_plain(L, B, i, w, **kw)
            P = idx.shape[1]
            nbytes = 4 * (4 * Bd * m * m + Bd * K * P + K * P)
            bms, by = bound_ms(nbytes, flops, peaks)
            ms, stages = device_ms(call, make, profile_kernels[kname])
            out[kname][Bd] = dict(
                max_abs_err=err, stream_max_abs_err=err_stream, flat_max_abs_dist=dist,
                stream_flat_max_abs_dist=dist_s, ms=ms, flat_ms=flat_ms, stages_ms=stages,
                wrapper_ms=time_ms(call, make), plain_ms=time_ms(plain, make) if Bd == 1 else None,
                library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
            )
    out["blocked_chunk_sub"].update(check_sub_sizes(rng, dev))
    return out


def check_sub_kernel_at_sub_k(L, B, idx, wv):
    """K5 sub's fused kernel at sub = k has no boundary, so it runs K1's
    two-exchange step alone (cluster_step, of which the grid and spread
    kernels keep a copy in csrc/root_update.cu). Through its C entry (the
    wrapper takes sub < k only), its chunk must be the flat plain chunk to
    1e-5, and bitwise the same on a second call."""
    lib = cuda_root_update._root_update_lib()
    Bd, m = L.shape[0], L.shape[-1]
    k, P = idx.shape
    plan = chunk_cluster_plan(k, m)
    aplan = chunk_apply_plan(k, m, m)
    f32 = dict(dtype=torch.float32, device=L.device)
    p_ = _build.ptr
    chunks = []
    for _ in range(2):
        Lc, Bc = clone_all(L, B)
        factors = torch.empty((4, Bd, k, m), **f32)
        rc = lib.ogp_blocked_chunk_sub_cluster(p_(Lc), p_(Bc), p_(idx), p_(wv), *(p_(x) for x in factors), None,
                                               Bd, k, k, P, m, aplan.cluster, plan.cluster, _build.stream_of(Lc))
        _build.launch_check(rc, "chunk_sub_cluster_kernel at sub = k", plan, aplan)
        chunks.append((Lc, Bc))
    torch.cuda.synchronize()
    max_err(chunks[0], blocked_chunk_plain(L, B, idx, wv), 1e-5, f"K5 sub's kernel at sub = k (Bd={Bd})")
    bitwise(*chunks, f"K5 sub's kernel at sub = k (Bd={Bd})")


def check_sub_sizes(rng, dev):
    """One K5-sub chunk on each side of the fused kernel's envelope edge
    (K1's: chunk_cluster_plan), against the plain version to 1e-5:
    SUB_EDGE_SIDE^2 near the edge, fused, its boundaries in the most rounds
    of rows (and bitwise the same on a second call); OUTSIDE_SIDE^2 beyond
    it, one sub-block at a time."""
    out = {}
    for side, fused in ((SUB_EDGE_SIDE, True), (OUTSIDE_SIDE, False)):
        grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
        m = grid.num_points
        plan = chunk_cluster_plan(K, m)
        if (plan is not None and plan.clusters == 1) != fused:
            raise AssertionError(f"(k={K}, sub={SUB}, m={m}) was meant to lie {'in' if fused else 'out'}side "
                                 "the fused kernel's envelope")
        L, B = synthetic_roots(rng, 1, m, dev)
        _, idx, w = stencil(rng, grid, K, dev)
        wv = w[None].contiguous()
        before = (blocked_chunk.sub_launches, blocked_chunk.sub_cluster_launches)
        got = blocked_chunk(*clone_all(L, B), idx, wv, sub=SUB)
        if fused:
            bitwise(got, blocked_chunk(*clone_all(L, B), idx, wv, sub=SUB), f"blocked_chunk(sub={SUB}) m={m}")
        torch.cuda.synchronize()
        calls = 1 + fused
        if (blocked_chunk.sub_launches - before[0], blocked_chunk.sub_cluster_launches - before[1]) != (calls, calls * fused):
            raise AssertionError(f"blocked_chunk(sub={SUB}) at m={m} did not take the {'fused' if fused else 'per sub-block'} path")
        err = max_err(got, blocked_chunk_plain(L, B, idx, wv, sub=SUB), 1e-5, f"blocked_chunk(sub={SUB}) m={m}")
        out["fused near the edge" if fused else "outside"] = dict(m=m, k=K, sub=SUB, max_abs_err=err)
    return out


def spd_batch(rng, shape, dev):
    """SPD matrices a a^T / m + I of the given shape (..., m, m)."""
    a = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)
    return (a @ a.mT / shape[-1] + torch.eye(shape[-1], device=dev)).contiguous()


def check_cholesky_case(q, what):
    """K6 on q against its plain version and torch.linalg.cholesky (atol
    2e-5, rtol 1e-4), bitwise the same on a second call, strict upper
    triangle exactly 0, and blocked_cholesky_ex bitwise the same with its
    failure flag clear. Returns the factor and the max abs errors."""
    got = blocked_cholesky(q, CHOL_BLOCK)
    again, info = blocked_cholesky_ex(q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((got,), (again,), f"blocked_cholesky {what}")
    if bool((info != 0).any()):
        raise AssertionError(f"blocked_cholesky_ex {what}: the failure flag is set on an SPD batch")
    errs = {}
    for name, want in (("plain", blocked_cholesky_plain(q, CHOL_BLOCK)), ("torch.linalg.cholesky", torch.linalg.cholesky(q))):
        errs[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, atol=2e-5, rtol=1e-4):
            raise AssertionError(f"blocked_cholesky {what}: max abs err {errs[name]:.3e} against {name}")
    if not bool((torch.triu(got, 1) == 0).all()):
        raise AssertionError(f"blocked_cholesky {what}: the strict upper triangle is not exactly 0")
    return got, errs


def check_cholesky(rng, Q, peaks, dev):
    """K6 on SPD batches at CHOL_SIZES x CHOL_BATCHES and on a (2, 2, m, m)
    batch, then times at m = 900 for Bd = 1 (phase 4's Q) and Bd = 4 of
    blocked_cholesky_ex, the entry with the failure flag that spd_cholesky
    calls: the device span with programmatic dependent launch (ms) and
    without (plain_launch_ms), each kernel's summed durations, and the device spans
    of torch.linalg.cholesky (library_ms) and torch.linalg.cholesky_ex."""
    m = Q.shape[-1]
    for mc in CHOL_SIZES:
        for Bd in CHOL_BATCHES:
            _, errs = check_cholesky_case(spd_batch(rng, (Bd, mc, mc), dev), f"Bd={Bd} m={mc}")
            print(f"  K6 Bd={Bd} m={mc}: max abs err {json.dumps(errs)}")
    q4d = spd_batch(rng, (2, 2, m, m), dev)
    got4d, errs = check_cholesky_case(q4d, f"(2, 2, {m}, {m})")
    if got4d.shape != q4d.shape:
        raise AssertionError(f"blocked_cholesky returned {tuple(got4d.shape)} for {tuple(q4d.shape)}")
    print(f"  K6 (2, 2, {m}, {m}): max abs err {json.dumps(errs)}")

    # Q's entries grow with the data: phase 4 holds its factor to a relative
    # bound; here it must come back the same from a second call
    Lq, again = blocked_cholesky(Q, CHOL_BLOCK), blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((Lq,), (again,), f"blocked_cholesky on Q (m={m})")
    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    out = {}
    for Bd, q in ((1, Q), (4, spd_batch(rng, (4, m, m), dev))):
        make = lambda q=q: (q, CHOL_BLOCK)
        bms, by = chol_bound(Bd, m, peaks)
        plan = k6_plan(Bd, m, dev)
        r = dict(bound_ms=bms, bound_by=by, route=k6_route(plan))
        for key, pdl in (("", True), ("plain_launch_", False)):
            cuda_chol.PROGRAMMATIC_LAUNCH = pdl
            try:
                r[f"{key}ms"], r[f"{key}stages_ms"] = device_span_ms(blocked_cholesky_ex, make,
                                                                     cuda_chol.stage_launches(plan))
                r[f"{key}kernel_sum_ms"] = sum(r[f"{key}stages_ms"].values())
            finally:
                cuda_chol.PROGRAMMATIC_LAUNCH = True
        r["library_ms"] = device_span_ms(lambda q, b: torch.linalg.cholesky(q), make)[0]
        r["library_ex_ms"] = device_span_ms(lambda q, b: torch.linalg.cholesky_ex(q), make)[0]
        r["library_wall_ms"] = time_ms(lambda q, b: torch.linalg.cholesky(q), make)
        r["wrapper_ms"] = time_ms(blocked_cholesky_ex, make)
        if Bd == 1:
            r.update(max_abs_err=float((Lq - want).abs().max()), rel_max_err=rel_max_err(Lq, want),
                     max_abs_err_vs_library=float((Lq - torch.linalg.cholesky(Q)).abs().max()),
                     plain_ms=time_ms(blocked_cholesky_plain, make))
        out[Bd] = r
    return out


# --------------------------------------------------------------------------
# phase 5: the training path through OnlineSKIRegression
# --------------------------------------------------------------------------


def _gp_leaves(params):
    return [params["kernel"]["raw_lengthscale"], params["kernel"]["raw_outputscale"], params["raw_second_noise"]]


def _named_leaves(params, prefix=""):
    """[(name, tensor)] of a nested params dict, in its order."""
    out = []
    for key, val in params.items():
        out += _named_leaves(val, f"{prefix}{key}/") if isinstance(val, dict) else [(prefix + key, val)]
    return out


def load_twin(reg, x0, y0, cls=OnlineSKIRegression, **kw):
    """A wrapper of class ``cls`` on the CPU built with reg's configuration
    ``kw``, started from reg's params, stem and state as they stand
    (convert.load_wrapper); the dense or the rank-capped state, as reg has."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a routed configuration may warn
        twin = cls(LinearStem(2, 2), x0, y0, device="cpu", **kw)
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    stem_params = {"lin": {"w": host(reg.stem.lin.weight).T, "b": host(reg.stem.lin.bias)}}
    bn = {"bn": {"mean": host(reg.stem.bn.running_mean), "var": host(reg.stem.bn.running_var),
                 "momentum": host(reg.stem.bn.momentum)}}
    params = {key: {k: host(v) for k, v in val.items()} if isinstance(val, dict) else host(val)
              for key, val in reg.params.items()}
    s = reg.state
    if hasattr(s, "used"):
        state = dict(wty=host(s.wty), ydy=host(s.ydy), root=host(s.root), used=s.used, d_logdet=host(s.d_logdet),
                     num_data=s.num_data)
    else:
        state = dict(wty=host(s.wty), ydy=host(s.ydy), mat=host(s.roots.mat), root=host(s.roots.root),
                     inv_root=host(s.roots.inv_root), d_logdet=host(s.d_logdet), num_data=s.num_data)
    convert.load_wrapper(twin, params, stem_params, bn, state, device="cpu")
    return twin


def training_path(rng, card, dev):
    """Phase 5's path: OnlineSKIRegression at bench.py's full-update
    configuration on the card: fit, 64 update()s at q = 1, 8 at q = 32, one
    hyper_step, predict, prequential and absorb, with the launch counters
    zeroed just before and read just after. The first 8 q = 1 updates run
    on a CPU twin too (convert). Returns (reg, launches, seed data)."""
    f32 = np.float32
    x0 = rng.uniform(-1, 1, (N_SEED, 2)).astype(f32)
    y0 = np.sin(3 * x0[:, :1])

    def points(n):
        x = rng.uniform(-1, 1, (n, 2)).astype(f32)
        return x, np.sin(3 * x[:, :1])

    x1, y1 = points(N_UPD1)
    x32, y32 = points(N_UPD32 * 32)
    xh, yh = points(32)
    xt, yt = points(N_TEST)
    xp, yp = points(N_TEST)
    xa, ya = points(N_ABSORB)
    reg = OnlineSKIRegression(LinearStem(2, 2), x0, y0, lr=TRAIN_LR, grid_size=M_SIDE, slim_state=True, device=dev)
    torch.cuda.synchronize()

    zero_counters()
    t0 = time.perf_counter()
    records = reg.fit(x0, y0, FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    twin = load_twin(reg, x0, y0, lr=TRAIN_LR, grid_size=M_SIDE, slim_state=True)
    per_update = []  # (K6, K2) launches of each update
    losses, upd1_s, upd32_s = [], [], []
    for i in range(N_UPD1 + N_UPD32):
        x, y = (x1[i : i + 1], y1[i : i + 1]) if i < N_UPD1 else (
            x32[(i - N_UPD1) * 32 : (i - N_UPD1 + 1) * 32], y32[(i - N_UPD1) * 32 : (i - N_UPD1 + 1) * 32])
        before = (blocked_cholesky.launches, rank1_apply.launches)
        r0 = time.perf_counter()
        losses.append(reg.update(x, y))  # returns floats: the host waits for the card
        (upd1_s if i < N_UPD1 else upd32_s).append(time.perf_counter() - r0)
        per_update.append((blocked_cholesky.launches - before[0], rank1_apply.launches - before[1]))
        if i < N_TWIN:
            losses[-1] += twin.update(x, y)
        if i == N_TWIN - 1:
            twin_errs = compare_twin(reg, twin)
    # what the hyper step starts from, for check_hyper_gradient after the path
    # (prequential and absorb update the state's roots in place on the card)
    snapshot = ({k: (v.detach().clone() if torch.is_tensor(v) else {a: b.detach().clone() for a, b in v.items()})
                 for k, v in reg.params.items()},
                reg.state._replace(wty=reg.state.wty.clone(), roots=RootCache(
                    None, reg.state.roots.root.clone(), reg.state.roots.inv_root.clone())))
    k6_before = blocked_cholesky.launches
    losses.append(reg.hyper_step(xh, yh))
    k6_hyper = blocked_cholesky.launches - k6_before
    mean, var = reg.predict(xt)
    pm, pv = reg.prequential(xp, yp)
    reg.absorb(xa, ya)
    torch.cuda.synchronize()
    launches = read_window()

    print(f"training path (OnlineSKIRegression, LinearStem(2, 2), m={M_SIDE**2}, slim state, lr {TRAIN_LR}) on {card}:")
    print(f"  fit {FIT_EPOCHS} epochs on {N_SEED} points: {fit_s:.4f} s; train losses "
          f"{json.dumps([r['train_loss'] for r in records])}")
    for label, q, times in (("q = 1", 1, upd1_s), ("q = 32", 32, upd32_s)):
        rates = [q / t for t in times[1:]]
        print(f"  update() {label}, {len(rates)} calls after a warm-up: median {np.median(rates):.1f} points/s "
              f"({1e3 * np.median(times[1:]):.3f} ms a call), spread {min(rates):.1f}-{max(rates):.1f}")
    k6_per = [k for k, _ in per_update]
    print(f"  K6 launches per update(): {sorted(set(k6_per))} (mean {np.mean(k6_per):.3f}); per hyper_step: {k6_hyper}")
    print(f"  CPU twin after {N_TWIN} q = 1 updates: {json.dumps(twin_errs)}")
    print(f"  kernel launches: {json.dumps(launches)}")

    if any(k < 1 for k in k6_per) or k6_hyper < 1:
        raise AssertionError("an update() or the hyper_step did not factor Q with K6")
    if any(k2 != 1 for _, k2 in per_update[:N_UPD1]):
        raise AssertionError(f"K2 did not launch once per q = 1 update: {[k2 for _, k2 in per_update[:N_UPD1]]}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the training path never launched {name}")
    if (launches["chunk_recursion_cluster"], launches["pred_recursion_cluster"]) != (
            launches["blocked_chunk"], launches["pred_chunk"]):
        raise AssertionError("a chunk of the training path did not run its recursion on a cluster")
    values = [v for pair in losses for v in pair] + [r["train_loss"] for r in records] + [reg.mll_value()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"a non-finite loss or MLL on the training path: {values}")
    for name, t in (("mean", mean), ("var", var), ("prequential mean", pm), ("prequential var", pv)):
        if tuple(t.shape) != (N_TEST, 1) or not torch.isfinite(t).all():
            raise AssertionError(f"training path: {name} is not finite of shape ({N_TEST}, 1)")
    rmse = float(torch.sqrt(torch.mean((mean[:, 0].cpu() - torch.tensor(yt[:, 0])) ** 2)))
    print(f"  held-out RMSE vs sin(3 x0): {rmse:.6f}; mll_value {reg.mll_value():.6f}")
    return reg, launches, (x0, y0), snapshot


def compare_twin(reg, twin):
    """reg (the card) against its CPU twin: params within TWIN_PARAM_TOL
    (a tenth of one Adam step), roots within 1e-3 * scale (bench.py's
    gate)."""
    errs = {}
    pairs = [(n, p, q) for (n, p), (_, q) in zip(_named_leaves(reg.params), _named_leaves(twin.params))]
    pairs += [(f"stem {n}", p, q) for (n, p), q in zip(reg.stem.named_parameters(), twin.stem.parameters())]
    for name, a, b in pairs:
        errs[name] = float((a.detach().cpu() - b.detach()).abs().max())
        if not errs[name] <= TWIN_PARAM_TOL:
            raise AssertionError(f"CPU twin: {name} differs by {errs[name]:.3e} (tol {TWIN_PARAM_TOL})")
    for name in ("root", "inv_root"):
        a, b = getattr(reg.state.roots, name).cpu(), getattr(twin.state.roots, name)
        errs[name] = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not errs[name] <= 1e-3 * max(scale, 1.0):
            raise AssertionError(f"CPU twin: {name} differs by {errs[name]:.3e} (scale {scale:.3e})")
    return errs


def autograd_mll(model, params, state):
    """-sum(wiski_mll) with skip_logdet_forward, written out with
    torch.linalg.cholesky and left to autograd (no closed form): the
    yardstick of the check of _DenseInnerCore's backward."""
    s2 = torch.exp(params["raw_second_noise"])
    E = grid_kuu_dense(model.kernel, params["kernel"], model.grid) / s2[:, None, None]
    L, wty = state.roots.root, state.wty
    with f32_matmul_precision():
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        Lq = torch.linalg.cholesky(eye + L.mT @ (E @ L))
        Kw = E @ wty
        proj = L.mT @ Kw
        qf = torch.sum(proj * torch.cholesky_solve(proj, Lq), dim=(-2, -1))
        ld = 2.0 * torch.sum(torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1)), dim=-1)
    ld = ld - ld.detach()
    n = float(state.num_data)
    quad = (state.ydy - torch.sum(wty * Kw, dim=(-2, -1)) + qf) / s2
    return torch.sum(0.5 * (quad + ld + state.d_logdet + n * LOG_2PI + n * torch.log(s2)) / n)


def split_ms(loss_fn, leaves, reps=TIMING_REPS):
    """Median device ms of the forward (loss_fn()) and of the backward
    (torch.autograd.grad), between CUDA events recorded behind a long spin
    kernel, so that the host has queued both before the card reaches them."""
    fwd, bwd = [], []
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        torch.cuda._sleep(5 * SPIN_CYCLES)
        ev[0].record()
        loss = loss_fn()
        ev[1].record()
        torch.autograd.grad(loss, leaves)
        ev[2].record()
        torch.cuda.synchronize()
        if r:
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
    return float(np.median(fwd)), float(np.median(bwd))


def check_hyper_gradient(model, params, state, card):
    """The gradient of one hyper step (the training path's, from its params
    and state) at float32 on the card: _DenseInnerCore's closed form against
    autograd through torch.linalg.cholesky (the value too), each leaf to
    HYPER_GRAD_RTOL of its largest entry; both beside a float64 reference on
    the card. Then the device time of the forward and of each backward."""
    for leaf in _gp_leaves(params):
        leaf.requires_grad_(True)
    cfg_skip = DEFAULT_CONFIG.replace(skip_logdet_forward=True)
    leaves = _gp_leaves(params)
    closed = lambda: -torch.sum(wiski_mll(model, params, state, cfg_skip))
    plain = lambda: autograd_mll(model, params, state)
    v_cf, v_ad = closed(), plain()
    g_cf = torch.autograd.grad(v_cf, leaves)
    g_ad = torch.autograd.grad(v_ad, leaves)
    p64 = {"kernel": {k: v.detach().double().requires_grad_(True) for k, v in params["kernel"].items()},
           "raw_second_noise": params["raw_second_noise"].detach().double().requires_grad_(True)}
    s64 = state._replace(wty=state.wty.double(), ydy=state.ydy.double(), d_logdet=state.d_logdet.double(),
                         roots=RootCache(None, state.roots.root.double(), state.roots.inv_root.double()))
    g_64 = torch.autograd.grad(-torch.sum(wiski_mll(model, p64, s64, cfg_skip)), _gp_leaves(p64))
    out = {"value": float(v_cf.detach()), "value_autograd": float(v_ad.detach())}
    for name, a, b, c in zip(("raw_lengthscale", "raw_outputscale", "raw_second_noise"), g_cf, g_ad, g_64):
        scale = float(b.abs().max())
        out[name] = dict(closed_vs_autograd=float((a - b).abs().max()) / scale,
                         closed_vs_f64=float((a.double() - c).abs().max()) / scale,
                         autograd_vs_f64=float((b.double() - c).abs().max()) / scale)
        if not out[name]["closed_vs_autograd"] <= HYPER_GRAD_RTOL:
            raise AssertionError(f"hyper gradient {name}: closed form and autograd differ: {out[name]}")
    if not abs(out["value"] - out["value_autograd"]) <= HYPER_GRAD_RTOL * abs(out["value_autograd"]):
        raise AssertionError(f"hyper step value: closed form {out['value']} vs autograd {out['value_autograd']}")
    fwd, bwd = split_ms(closed, leaves)
    fwd_ad, bwd_ad = split_ms(plain, leaves)
    out.update(forward_ms=fwd, closed_backward_ms=bwd, autograd_forward_ms=fwd_ad, autograd_backward_ms=bwd_ad)
    print(f"hyper step at n={state.num_data} on {card}: " + json.dumps(out))
    return out


def check_k6_flag(model, params, state, card):
    """K6's flag on the card: on the Q of (params, state) with one eigenvalue
    set to -1, spd_cholesky gives NaN in the lower triangle where cholesky_ex
    reports failure; the SPD Q beside it in the batch is factored bitwise as
    alone."""
    with torch.no_grad():
        Q = q_matrix(model, params, state)[0]
    lam, V = torch.linalg.eigh(Q.double())
    lam[0] = -1.0
    bad = ((V * lam) @ V.mT).float()
    batch = torch.stack([bad, Q]).contiguous()
    got = spd_cholesky(batch)
    _, info = blocked_cholesky_ex(batch)
    _, info_lib = torch.linalg.cholesky_ex(batch)
    alone = blocked_cholesky(Q.contiguous())
    torch.cuda.synchronize()
    rows, cols = torch.tril_indices(Q.shape[-1], Q.shape[-1], device=Q.device)
    nan_lower = bool(torch.isnan(got[0][rows, cols]).all())
    print(f"K6 flag on {card}: info {info.tolist()} (cholesky_ex {info_lib.tolist()}), "
          f"NaN lower triangle on the indefinite Q: {nan_lower}")
    if not (info[0] != 0 and info_lib[0] != 0 and nan_lower):
        raise AssertionError("spd_cholesky did not give NaN on an indefinite Q")
    err = rel_max_err(got[1], alone)
    print(f"  the SPD Q beside it: relative max err {err:.3e} against K6 on it alone")
    if not (info[1] == 0 and info_lib[1] == 0 and torch.isfinite(got[1]).all() and err <= 1e-6):
        raise AssertionError("spd_cholesky changed the factor of an SPD Q")


def time_fit_epochs(reg, x0, y0, card):
    """fit(num_epochs=1), HOST_REPEATS calls after a warm-up: one epoch and
    the final refresh of the state, each call synchronised."""
    times = []
    for _ in range(1 + HOST_REPEATS):
        r0 = time.perf_counter()
        reg.fit(x0, y0, 1)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - r0))
    print(f"  fit(num_epochs=1) on {N_SEED} points, {HOST_REPEATS} calls after a warm-up on {card}: median "
          f"{np.median(times[1:]):.3f} ms, spread {min(times[1:]):.3f}-{max(times[1:]):.3f}")
    return times[1:]


def profile_update(reg, rng, card, n=4):
    """Where an update() at q = 1 spends its time: n calls under
    torch.profiler (CPU and CUDA), after a warm-up. Prints the wall time a
    call, the CUDA kernels' summed time and launches a call, the device's
    idle share (1 - kernel time / wall time, the profiler on), the kernels
    by device time and the host ops by self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = rng.uniform(-1, 1, (n + 1, 2)).astype(np.float32)
    y = np.sin(3 * x[:, :1])
    reg.update(x[n:], y[n:])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        for i in range(n):
            reg.update(x[i : i + 1], y[i : i + 1])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        # device activity; the spans of record_function ranges (such as
        # Optimizer.step) are annotations over it, not activity of their own
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            count, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, us + e.time_range.end - e.time_range.start)
    busy_us = sum(us for _, us in by_name.values())
    launches = sum(c for c, _ in by_name.values())
    print(f"update() q = 1 under torch.profiler on {card}: {wall_us / n / 1e3:.3f} ms a call, CUDA kernels "
          f"{busy_us / n / 1e3:.3f} ms and {launches / n:.1f} launches a call, device idle share "
          f"{1 - busy_us / wall_us:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (count, us) in top:
        print(f"  {us / n / 1e3:8.4f} ms  {count / n:5.1f} x  {name[:110]}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


# --------------------------------------------------------------------------
# phase 6: the large-grid regime at m = 4,096
# --------------------------------------------------------------------------


def large_model(dev, seed_rng):
    """bench_iterative_hyper_step's model and state: a 64x64 grid, RBF,
    learned second noise, N_SEED6 points of sin(3 x0)."""
    grid = Grid.create([(-1.1, 1.1)] * 2, M6_SIDE, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)
    x0 = torch.tensor(seed_rng.uniform(-1, 1, (N_SEED6, 2)), dtype=torch.float32, device=dev)
    y0 = torch.sin(3 * x0[:, :1])
    return model, params, wiski_init(model, x0, y0, torch.ones_like(y0))


def check_kernels_large(rng, model, params, state, peaks, dev):
    """K2 (16 calls), K1 and K3 (one chunk each: K1's recursion on G = 4
    clusters of 8, K3's on a cluster of 16) and K6 (Q of the state) at
    m = 4,096 against their plain versions on the card, with device times,
    bounds and yardsticks. Returns (those rows, the checks beside them:
    K1 and K3 at Bd = 2 and at the edges of their envelopes)."""
    grid = model.grid
    m = grid.num_points
    L, B = synthetic_roots(rng, 1, m, dev)
    out = {}
    _, idx2, w2 = stencil(rng, grid, N_K2_6, dev)
    out["rank1_apply"] = check_k2(L, B, idx2, w2[None], peaks, f"m={m}", PLAIN_REPS6)
    out["rank1_apply"]["route"] = "row kernel looping over each row (m > 32 kRowRegs)"
    _, idx, w = stencil(rng, grid, K, dev)
    plan = chunk_cluster_plan(K, m)
    if plan is None or plan.clusters < 2:
        raise AssertionError(f"(k={K}, m={m}) was expected on G >= 2 clusters of K1's grid recursion")
    out["blocked_chunk"] = check_k1(L, B, idx, w[None].contiguous(), peaks, f"m={m}", "grid", PLAIN_REPS6)
    # its recursion as a row of its own, as phase 2's: the device time within
    # the chunk, the plain recursion's; 10 t m flops at step t, p0 in, U, P, R out
    p0 = torch.einsum("bkp,bkpm->bkm", w[None], B[:, idx.long()]).contiguous()
    bms, by = bound_ms(4 * 4 * K * m, 5 * K * (K - 1) * m, peaks)
    out["chunk_recursion_grid"] = dict(
        max_abs_err=out["blocked_chunk"]["max_abs_err"],
        ms=out["blocked_chunk"]["stages_ms"]["chunk_recursion_grid_kernel"],
        route=recursion_route(plan), plain_ms=time_ms(blocked_factors, lambda: (p0,), PLAIN_REPS6), library_ms=None,
        bound_ms=bms, bound_by=by)

    # K3: one chunk on the model's caches
    with torch.no_grad():
        mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    x, idx3, w3 = stencil(rng, grid, K, dev)
    plan3 = pred_cluster_plan(K, m, idx3.shape[1])
    if plan3 is None or plan3.cluster != 16:
        raise AssertionError(f"(k={K}, m={m}) was expected on K3's cluster of 16 blocks")
    y = torch.sin(3 * x[:, 0])[None].contiguous()
    C1, mu1 = cov_cache.contiguous(), mean_cache[..., 0].contiguous()
    out["pred_chunk"] = check_k3(C1, mu1, idx3, w3, y, peaks, f"m={m}", "wide", PLAIN_REPS6)
    S, P = stencil_rows(idx3, w3, m), idx3.shape[1]
    plain_args = (S, S @ C1, mu1 @ S.mT, y, torch.ones_like(y))
    # a: 2 t P, ct: 2 t m flops at step t; c0w in, Z out
    bms, by = bound_ms(4 * (2 * K * m + 5 * K) + 8 * K * P, K * (K - 1) * (m + P), peaks)
    out["pred_recursion_wide"] = dict(
        max_abs_err=out["pred_chunk"]["max_abs_err"],
        ms=out["pred_chunk"]["stages_ms"]["pred_recursion_cluster_kernel"],
        route=recursion_route(plan3), plain_ms=time_ms(pred_chunk_factors, lambda: plain_args, PLAIN_REPS6),
        library_ms=None, bound_ms=bms, bound_by=by)
    out["blocked_cholesky"] = check_k6(q_matrix(model, params, state), peaks, f"Q (m={m})", PLAIN_REPS6)

    lib, plib = cuda_root_update._root_update_lib(), cuda_pred_stream._pred_stream_lib()
    beside = {"capacity": {
        "K1 grid recursion": dict(plan=plan._asdict(), clusters_at_once=lib.ogp_chunk_grid_capacity(
            K, m, plan.cluster, plan.clusters)),
        "K3 cluster recursion": dict(plan=plan3._asdict(), clusters_at_once=plib.ogp_pred_cluster_capacity(
            K, m, idx3.shape[1], plan3.cluster))}}
    L2, B2 = synthetic_roots(rng, 2, m, dev)
    wv2 = (w[None] * torch.tensor([1.0, 1.3], device=dev)[:, None, None]).contiguous()
    beside["blocked_chunk Bd=2"] = check_k1(L2, B2, idx, wv2, peaks, f"m={m} Bd=2", "grid", 1)
    C2 = torch.cat([C1, 0.9 * C1]).contiguous()
    mu2 = torch.cat([mu1, -mu1]).contiguous()
    y2 = torch.cat([y, 0.5 * y]).contiguous()
    beside["pred_chunk Bd=2"] = check_k3(C2, mu2, idx3, w3, y2, peaks, f"m={m} Bd=2", "wide", 1)
    for me, route in K1_EDGES.items():
        Le, Be = synthetic_roots(rng, 1, me, dev)
        ie, we = edge_stencil(rng, K, me, dev)
        beside[f"blocked_chunk m={me}"] = check_k1(Le, Be, ie, we[None].contiguous(), peaks, f"m={me}", route, 1)
    for me, route in K3_EDGES.items():
        Ce, mue = edge_caches(rng, me, dev)
        ie, we = edge_stencil(rng, K, me, dev)
        ye = torch.tensor(rng.normal(size=(1, K)), dtype=torch.float32, device=dev)
        beside[f"pred_chunk m={me}"] = check_k3(Ce, mue, ie, we, ye, peaks, f"m={me}", route, 1)
    for Bd, me in K6_EDGES:
        beside[f"blocked_cholesky Bd={Bd} m={me}"] = check_k6(spd_batch(rng, (Bd, me, me), dev), peaks,
                                                              f"SPD (Bd={Bd}, m={me})", 1)
    return out, beside


def edge_stencil(rng, k, m, dev):
    """(idx (k, 16) int32, w (k, 16)) of k random points' stencils over
    [0, m), weights positive and summing to 1: for the envelopes' edges,
    whose m is no grid's."""
    w = rng.uniform(0.0, 1.0, (k, 16))
    return (torch.tensor(rng.integers(0, m, (k, 16)), dtype=torch.int32, device=dev),
            torch.tensor(w / w.sum(1, keepdims=True), dtype=torch.float32, device=dev))


def edge_caches(rng, m, dev):
    """(C (1, m, m), mu (1, m)): an SPD covariance cache G G^T / 64 + 0.1 I
    of rank-64 G, and a mean cache."""
    G = torch.tensor(rng.normal(size=(1, m, 64)), dtype=torch.float32, device=dev)
    return ((G @ G.mT / 64 + 0.1 * torch.eye(m, device=dev)).contiguous(),
            torch.tensor(rng.normal(size=(1, m)), dtype=torch.float32, device=dev))


def check_k2(L, B, idx, wv, peaks, what, plain_reps=TIMING_REPS, atol=1e-5):
    """K2 against its plain version on each point of a stencil stream in
    turn (idx (n, P); wv (Bd, n, P), the weights over sqrt(noise)), the
    roots carried from call to call, to 1e-5 (allclose, with ``atol``);
    then device time, bound and yardstick on the first point."""
    Lk, Bk = clone_all(L, B)
    err = 0.0
    for i in range(idx.shape[0]):
        p = torch.einsum("bp,bpm->bm", wv[:, i], Bk[:, idx[i].long()]).contiguous()
        want = rank1_apply_plain(Lk, Bk, p)
        got = rank1_apply(Lk, Bk, p)
        torch.cuda.synchronize()
        err = max(err, max_err(got, want, 1e-5, f"rank1_apply {what} call {i}", atol))
    p = torch.einsum("bp,bpm->bm", wv[:, 0], B[:, idx[0].long()]).contiguous()
    make = lambda: (*clone_all(L, B), p)
    bms, by = rank1_bound(L.shape[0], L.shape[-1], peaks)
    ms, stages = device_ms(rank1_apply, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1})
    return dict(
        calls=idx.shape[0], max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(rank1_apply, make),
        plain_ms=time_ms(rank1_apply_plain, make, plain_reps), library_ms=time_ms(rank1_library, make),
        bound_ms=bms, bound_by=by)


def k1_counts(wrapper):
    """A K1 wrapper's (launches, cluster, grid-cluster, spread) counters and
    its carried launches, cluster less grid-cluster."""
    return (wrapper.launches, wrapper.cluster_launches, wrapper.grid_cluster_launches, wrapper.spread_launches,
            wrapper.cluster_launches - wrapper.grid_cluster_launches)


def k1_route_counts(plan, n=1):
    """The counters' moves of n K1 recursions on ``plan``."""
    spread = isinstance(plan, _build.SpreadPlan)
    grid = not spread and plan.clusters > 1
    return n, n * (not spread), n * grid, n * spread, n * (not spread and not grid)


def check_k1(L, B, idx, wv, peaks, what, route, plain_reps=TIMING_REPS, atol=1e-5):
    """One K1 chunk (idx (k, P), wv (Bd, k, P)) against its plain version to
    1e-5 (allclose, with ``atol``) and bitwise the same on a second call,
    its recursion on the route the caller names (k1_route: "cluster",
    "grid" or "spread"; planned so, and taken so by the counters); then
    device time, bound and yardstick."""
    plan, recursion = k1_route(idx.shape[0], L.shape[-1], route)
    before = k1_counts(blocked_chunk)
    got = blocked_chunk(*clone_all(L, B), idx, wv)
    again = blocked_chunk(*clone_all(L, B), idx, wv)
    torch.cuda.synchronize()
    if tuple(a - b for a, b in zip(k1_counts(blocked_chunk), before)) != k1_route_counts(plan, 2):
        raise AssertionError(f"blocked_chunk {what} did not take the {recursion_route(plan)}")
    err = max_err(got, blocked_chunk_plain(L, B, idx, wv), 1e-5, f"blocked_chunk {what}", atol)
    bitwise(got, again, f"blocked_chunk {what}")
    library = chunk_library(*blocked_factors(torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()])))
    make = lambda: (*clone_all(L, B), idx, wv)
    k, P = idx.shape
    bms, by = chunk_bound(L.shape[0], L.shape[-1], k, P, peaks)
    ms, stages = device_ms(blocked_chunk, make, {"chunk_gather_kernel": 1, recursion: 1,
                                                 **k1_apply_kernels(k, L.shape[-1], L.shape[-1])})
    return dict(
        k=k, max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(blocked_chunk, make),
        plain_ms=time_ms(blocked_chunk_plain, make, plain_reps),
        library_ms=time_ms(library, lambda: clone_all(L, B)), bound_ms=bms, bound_by=by,
        route=f"{recursion_route(plan)} ({recursion})")


def k3_counts(wrapper):
    """A K3 wrapper's (launches, cluster, wide-cluster, spread) counters."""
    return (wrapper.launches, wrapper.cluster_launches, wrapper.wide_cluster_launches, wrapper.spread_launches)


def k3_route_counts(plan, n=1):
    """The counters' moves of n K3 recursions on ``plan``."""
    spread = isinstance(plan, _build.SpreadPlan)
    return (n, n * (not spread), n * (not spread and plan.cluster == 16), n * spread)


def check_k3(C, mu, idx, w, y, peaks, what, route, plain_reps=TIMING_REPS):
    """One K3 chunk (idx, w (k, P); y (Bd, k), unit noise) on the caches
    (C, mu) against its plain version to 2e-4 and bitwise the same on a
    second call, its recursion on the route the caller names (k3_route:
    "cluster", "wide" or "spread"; planned so, and taken so by the
    counters); then device time, bound and yardstick."""
    m, (k, P) = C.shape[-1], idx.shape
    plan, recursion = k3_route(k, m, P, route)
    nz = torch.ones_like(y)
    before = k3_counts(pred_chunk)
    got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    again = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
    torch.cuda.synchronize()
    if tuple(a - b for a, b in zip(k3_counts(pred_chunk), before)) != k3_route_counts(plan, 2):
        raise AssertionError(f"pred_chunk {what} did not take the {recursion_route(plan)}")
    err = max_err(got, pred_chunk_stencil_plain(C, mu, idx, w, y, nz), 2e-4, f"pred_chunk {what}")
    bitwise(got, again, f"pred_chunk {what}")
    S = stencil_rows(idx, w, m)
    library = pred_library(*pred_chunk_factors(S, S @ C, mu @ S.mT, y, nz)[:2])
    make = lambda: (*clone_all(C, mu), idx, w, y, nz)
    bms, by = pred_bound(C.shape[0], m, k, P, peaks)
    ms, stages = device_ms(pred_chunk, make, {"pred_gather_kernel": 1, recursion: 1,
                                              **k3_apply_kernels(C.shape[0], m, m)})
    return dict(
        k=k, max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(pred_chunk, make),
        plain_ms=time_ms(pred_chunk_stencil_plain, make, plain_reps),
        library_ms=time_ms(library, lambda: clone_all(C, mu)), bound_ms=bms, bound_by=by,
        route=f"{recursion_route(plan)} ({recursion})")


@contextlib.contextmanager
def k6_lookahead(on):
    """K6's plans with look-ahead on (at every m) or off, inside the block."""
    saved = cuda_chol.LOOKAHEAD, cuda_chol.LOOKAHEAD_MIN_BD_M
    cuda_chol.LOOKAHEAD, cuda_chol.LOOKAHEAD_MIN_BD_M = on, (0 if on else saved[1])
    try:
        yield
    finally:
        cuda_chol.LOOKAHEAD, cuda_chol.LOOKAHEAD_MIN_BD_M = saved


def check_k6(Q, peaks, what, plain_reps=TIMING_REPS):
    """K6 on Q (..., m, m) against its plain version and
    torch.linalg.cholesky (relative max error <= 5e-4), bitwise the same on
    a second call and with look-ahead on and off; strict upper triangle
    exactly 0; then the device span of blocked_cholesky_ex on its plan
    with each kernel's summed time, bound and the library's span; the span
    of each look-ahead arm (la_on_ms, la_off_ms; one of them the plan's
    own); and the stages alone (trailing_ms, factor_ms, solve_ms): their
    kernels' summed durations with look-ahead and programmatic dependent
    launch off, so that no kernel's time holds a wait or an overlap."""
    m, Bd = Q.shape[-1], Q[..., 0, 0].numel()
    plan = k6_plan(Bd, m, Q.device)
    Lq, again = blocked_cholesky(Q, CHOL_BLOCK), blocked_cholesky(Q, CHOL_BLOCK)
    with k6_lookahead(not plan.lookahead):
        other = blocked_cholesky(Q, CHOL_BLOCK)
    torch.cuda.synchronize()
    bitwise((Lq,), (again,), f"blocked_cholesky on {what}")
    bitwise((Lq,), (other,), f"blocked_cholesky on {what}, look-ahead on and off")
    want = blocked_cholesky_plain(Q, CHOL_BLOCK)
    e_plain, e_lib = rel_max_err(Lq, want), rel_max_err(Lq, torch.linalg.cholesky(Q))
    if not (e_plain <= 5e-4 and e_lib <= 5e-4):
        raise AssertionError(f"K6 on {what}: relative max err {e_plain:.3e} vs plain, {e_lib:.3e} vs library")
    if not bool((torch.triu(Lq, 1) == 0).all()):
        raise AssertionError(f"K6 on {what}: the strict upper triangle is not exactly 0")
    make = lambda: (Q, CHOL_BLOCK)
    bms, by = chol_bound(Bd, m, peaks)
    ms, stages = device_span_ms(blocked_cholesky_ex, make, cuda_chol.stage_launches(plan))
    r = dict(
        panels=len(plan.panels) + 1, max_abs_err=float((Lq - want).abs().max()), rel_max_err=e_plain,
        rel_max_err_vs_library=e_lib, ms=ms, stages_ms=stages, wrapper_ms=time_ms(blocked_cholesky_ex, make),
        plain_ms=time_ms(blocked_cholesky_plain, make, plain_reps),
        library_ms=device_span_ms(lambda q, b: torch.linalg.cholesky(q), make)[0], bound_ms=bms, bound_by=by,
        route=k6_route(plan))
    own, flip = ("la_on", "la_off") if plan.lookahead else ("la_off", "la_on")
    r[f"{own}_ms"] = ms
    with k6_lookahead(not plan.lookahead):
        r[f"{flip}_ms"] = device_span_ms(blocked_cholesky_ex, make,
                                         cuda_chol.stage_launches(k6_plan(Bd, m, Q.device)))[0]
    cuda_chol.PROGRAMMATIC_LAUNCH = False
    try:
        with k6_lookahead(False):
            alone = device_span_ms(blocked_cholesky_ex, make, cuda_chol.stage_launches(k6_plan(Bd, m, Q.device)))[1]
    finally:
        cuda_chol.PROGRAMMATIC_LAUNCH = True
    r.update(trailing_ms=k6_trailing_ms(alone), factor_ms=alone["chol_factor_kernel"],
             solve_ms=alone["chol_solve_kernel"])
    return r


def iterative_hyper_step(model, params, state, card):
    """bench_iterative_hyper_step: the gate (CG/SLQ MLL against the dense
    one, Q on K6), then HYPER_STEPS Adam steps, 1 + HYPER_REPEATS times,
    each with new probes; hyper steps/s and the peak device memory."""
    m = model.grid.num_points
    cfg_iter = DEFAULT_CONFIG.replace(max_cholesky_size=2048, use_toeplitz=True)
    cfg_dense = DEFAULT_CONFIG.replace(max_cholesky_size=2 * m)
    with torch.no_grad():
        v_iter = float(torch.sum(wiski_mll(model, params, state, cfg_iter, generator=torch.Generator().manual_seed(0))))
        k6 = blocked_cholesky.launches
        v_dense = float(torch.sum(wiski_mll(model, params, state, cfg_dense)))
        if blocked_cholesky.launches - k6 != 1:
            raise AssertionError("the dense MLL at m = 4,096 did not factor Q with K6")
    rel = abs(v_iter - v_dense) / max(abs(v_dense), 1.0)
    print(f"iterative MLL at m={m} on {card}: {v_iter:.6f} against the dense {v_dense:.6f}, rel {rel:.3e}")
    if not rel <= ITER_GATE_REL:
        raise AssertionError(f"iterative/dense MLL mismatch {rel:.3e} at m={m}")

    base = {"kernel": {k: v.detach().clone() for k, v in params["kernel"].items()},
            "raw_second_noise": params["raw_second_noise"].detach().clone()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    rates, losses = [], []
    for rep in range(1 + HYPER_REPEATS):
        p = {"kernel": {k: v.clone().requires_grad_(True) for k, v in base["kernel"].items()},
             "raw_second_noise": base["raw_second_noise"].clone().requires_grad_(True)}
        leaves = _gp_leaves(p)
        opt = torch.optim.Adam(leaves, lr=HYPER_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(HYPER_STEPS):
            loss = -torch.sum(wiski_mll(model, p, state, cfg_iter,
                                        generator=torch.Generator().manual_seed((1 << 32) + i)))
            for leaf, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                leaf.grad = g
            opt.step()
            if rep == 0 and i == 0:
                losses.append(float(loss.detach()))
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        if rep:
            rates.append(HYPER_STEPS / (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite iterative-MLL loss: {losses}")
    profile_hyper_step(lambda: -torch.sum(wiski_mll(model, p, state, cfg_iter, generator=torch.Generator().manual_seed(1))),
                       leaves, card)
    out = dict(gate_rel=rel, value_iterative=v_iter, value_dense=v_dense, first_loss=losses[0],
               last_losses=losses[1:], steps_per_s_median=float(np.median(rates)), steps_per_s=rates,
               peak_bytes=peak, held_bytes_before=held)
    print(f"  {HYPER_STEPS} hyper steps, {HYPER_REPEATS} repeats after a warm-up: median "
          f"{out['steps_per_s_median']:.3f} steps/s, spread {min(rates):.3f}-{max(rates):.3f}; peak device "
          f"memory {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before); losses {json.dumps(losses)}")
    return out


def profile_hyper_step(loss_fn, leaves, card):
    """One hyper step's value and gradient under torch.profiler (CPU and
    CUDA): wall time, the CUDA kernels' summed time and launches, and the
    device's idle share (the profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.autograd.grad(loss_fn(), leaves)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        torch.autograd.grad(loss_fn(), leaves)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    print(f"  one hyper step under torch.profiler on {card}: {wall_us / 1e3:.3f} ms, CUDA kernels "
          f"{sum(busy) / 1e3:.3f} ms in {len(busy)} launches, device idle share {1 - sum(busy) / wall_us:.3f}")


def lowrank_stream(rng, card, dev):
    """bench_lowrank_stream: the exact-regime gate against a dense SKI oracle
    (float64), then LR_CHUNKS chunks of LR_CHUNK points with compressions
    firing, 1 + LR_REPEATS times from the same state; points/s."""
    grid = Grid.create([(-1.1, 1.1)] * 2, M6_SIDE, device=dev)
    m = grid.num_points
    model = WiskiLowRankModel(RBFKernel(), grid, rank=LR_RANK)
    params = model.init_params(2)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (LR_SEED, 2)), **f32)
    y0 = torch.sin(3 * x0[:, :1])
    state = wiski_lowrank_init(model, x0, y0, torch.ones_like(y0), params=params)
    if state.used != LR_SEED:
        raise AssertionError(f"the seed absorb compressed (used {state.used}); the gate needs the exact regime")
    xt = torch.tensor(rng.uniform(-1, 1, (64, 2)), **f32)
    mean, _ = wiski_lowrank_predict(model, params, state, xt)
    p64 = {"kernel": {k: v.double() for k, v in params["kernel"].items()}}
    kuu = grid_kuu_dense(model.kernel, p64["kernel"], grid).double()
    W = dense_w(*interp_coeffs(grid, x0, detach=True), m).T.double()
    Wt = dense_w(*interp_coeffs(grid, xt, detach=True), m).T.double()
    Kn = W @ kuu @ W.T + torch.eye(LR_SEED, dtype=torch.float64, device=dev)
    want = (Wt @ kuu @ W.T @ torch.linalg.solve(Kn, y0.double()))[:, 0]
    err = float((mean.double() - want).abs().max())
    scale = float(want.abs().max())
    print(f"rank-capped stream (m={m}, rank {LR_RANK}) on {card}: exact-regime mean err {err:.3e} "
          f"(scale {scale:.3e}) against the dense SKI oracle")
    if not err <= LR_GATE * max(scale, 1.0):
        raise AssertionError(f"lowrank/dense posterior-mean drift {err:.3e} at m={m}")

    xs = torch.tensor(rng.uniform(-1, 1, (LR_CHUNKS, LR_CHUNK, 2)), **f32)
    ys = torch.sin(3 * xs[..., :1])
    ns = torch.ones_like(ys)
    rates = []
    for rep in range(1 + LR_REPEATS):
        st, compressions = state, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(LR_CHUNKS):
            used = st.used
            st = wiski_lowrank_condition(model, st, xs[c], ys[c], ns[c], params)
            compressions += st.used < used
        torch.cuda.synchronize()
        if rep:
            rates.append(LR_CHUNKS * LR_CHUNK / (time.perf_counter() - t0))
    if st.num_data != LR_SEED + LR_CHUNKS * LR_CHUNK or not compressions:
        raise AssertionError(f"the stream absorbed {st.num_data} points with {compressions} compressions")
    if not torch.isfinite(st.root).all():
        raise AssertionError("non-finite rank-capped root after the stream")
    out = dict(gate_err=err, gate_scale=scale, points=LR_CHUNKS * LR_CHUNK, compressions=compressions,
               points_per_s_median=float(np.median(rates)), points_per_s=rates)
    print(f"  {LR_CHUNKS} chunks of {LR_CHUNK}, {compressions} compressions, {LR_REPEATS} repeats after a "
          f"warm-up: median {out['points_per_s_median']:.1f} points/s, spread {min(rates):.1f}-{max(rates):.1f}")
    return out


def _compare_twin_predictions(reg, twin, xt, what):
    errs = {}
    for name, a, b in zip(("mean", "var"), reg.predict(xt), twin.predict(xt)):
        a, b = a.cpu(), b
        errs[name] = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not (torch.isfinite(a).all() and errs[name] <= 1e-3 * max(scale, 1e-30)):
            raise AssertionError(f"{what} CPU twin: predicted {name} differs by {errs[name]:.3e} (scale {scale:.3e})")
    for name, a, b in zip(("raw_lengthscale", "raw_outputscale", "raw_second_noise"),
                          _gp_leaves(reg.params), _gp_leaves(twin.params)):
        errs[name] = float((a.detach().cpu() - b.detach()).abs().max())
        if not errs[name] <= TWIN_PARAM_TOL:
            raise AssertionError(f"{what} CPU twin: {name} differs by {errs[name]:.3e} (tol {TWIN_PARAM_TOL})")
    return errs


def large_grid_wrappers(rng, card, dev):
    """The wrappers at m = 4,096 and 16,384 through their entry points, with
    the launch counters zeroed just before and read just after. Returns the
    launches of this path and per-wrapper results."""
    f32 = np.float32

    def points(n):
        x = rng.uniform(-1, 1, (n, 2)).astype(f32)
        return x, np.sin(3 * x[:, :1])

    x0, y0 = points(N_WRAP_SEED)
    xu, yu = points(N_WRAP_UPD)
    xt, _ = points(N_TEST)
    xp, yp = points(N_PREQ6)
    xa, ya = points(N_ABSORB6)
    x_twin = xt[:64]
    configs = (("dense m=4096", dict(grid_size=M6_SIDE), 1),
               ("low_rank=512 m=4096", dict(grid_size=M6_SIDE, low_rank=LR_RANK), 2),
               (f"routed m={BIG_SIDE**2}", dict(grid_size=BIG_SIDE), 2))
    regs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the rank-capped core ignores update_stem, with a warning
        for name, kw, _ in configs:
            regs[name] = OnlineSKIRegression(LinearStem(2, 2), x0, y0, lr=TRAIN_LR, device=dev, **kw)
    if type(regs["dense m=4096"]) is not OnlineSKIRegression or not all(
            isinstance(regs[n], OnlineSKILowRankRegression) for n, _, _ in configs[1:]):
        raise AssertionError("OnlineSKIRegression did not route the large grids as expected")
    torch.cuda.synchronize()

    zero_counters()
    results = {}
    for name, kw, n_twin in configs:
        reg = regs[name]
        twin = load_twin(reg, x0, y0, lr=TRAIN_LR, **kw)
        upd_ms, per_update, losses = [], [], []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for i in range(N_WRAP_UPD):
                before = (rank1_apply.launches, blocked_cholesky.launches)
                r0 = time.perf_counter()
                losses.append(reg.update(xu[i : i + 1], yu[i : i + 1]))  # floats: the host waits
                upd_ms.append(1e3 * (time.perf_counter() - r0))
                per_update.append((rank1_apply.launches - before[0], blocked_cholesky.launches - before[1]))
                if i < n_twin:
                    losses.append(twin.update(xu[i : i + 1], yu[i : i + 1]))
                if i == n_twin - 1:
                    twin_errs = _compare_twin_predictions(reg, twin, x_twin, name)
        r0 = time.perf_counter()
        mean, var = reg.predict(xt)
        torch.cuda.synchronize()
        pred_ms = 1e3 * (time.perf_counter() - r0)
        r = dict(m=reg.model.grid.num_points, update_ms_median=float(np.median(upd_ms[1:])),
                 update_ms=upd_ms, predict_ms=pred_ms, K2_K6_per_update=sorted(set(per_update)),
                 twin_updates=n_twin, twin=twin_errs)
        if name == "dense m=4096":
            r0 = time.perf_counter()
            pm, pv = reg.prequential(xp, yp)
            torch.cuda.synchronize()
            r1 = time.perf_counter()
            reg.absorb(xa, ya)
            torch.cuda.synchronize()
            r.update(prequential_ms=1e3 * (r1 - r0), absorb_ms=1e3 * (time.perf_counter() - r1))
            if any(k2 != 1 for k2, _ in per_update):
                raise AssertionError(f"K2 did not launch once per q = 1 update at m = 4,096: {per_update}")
            if any(k6 < 1 for _, k6 in per_update):
                raise AssertionError(f"an update() at m = 4,096 did not factor Q with K6: {per_update}")
            for what, t in (("prequential mean", pm), ("prequential var", pv)):
                if tuple(t.shape) != (N_PREQ6, 1) or not torch.isfinite(t).all():
                    raise AssertionError(f"{name}: {what} is not finite of shape ({N_PREQ6}, 1)")
        values = [v for pair in losses for v in pair]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{name}: a non-finite loss: {values}")
        for what, t in (("mean", mean), ("var", var)):
            if tuple(t.shape) != (N_TEST, 1) or not torch.isfinite(t).all():
                raise AssertionError(f"{name}: predicted {what} is not finite of shape ({N_TEST}, 1)")
        r["rmse"] = float(torch.sqrt(torch.mean((mean[:, 0].cpu() - torch.sin(3 * torch.tensor(xt[:, 0]))) ** 2)))
        results[name] = r
        print(f"wrapper {name} on {card}: " + json.dumps(r))
    launches = read_window()
    print(f"  phase 6 wrapper path kernel launches: {json.dumps(launches)}")
    for kname in ("rank1_apply", "blocked_chunk", "pred_chunk", "blocked_cholesky"):
        if launches[kname] <= 0:
            raise AssertionError(f"the phase 6 wrapper path never launched {kname}")
    grid, wide = blocked_chunk.grid_cluster_launches, pred_chunk.wide_cluster_launches
    print(f"  phase 6 wrapper path: K1 chunks on G >= 2 clusters {grid}, K3 chunks on 16 blocks {wide}")
    if not launches["chunk_recursion_cluster"] == grid == launches["blocked_chunk"]:
        raise AssertionError("a K1 chunk at m = 4,096 did not run its recursion on G >= 2 clusters")
    if not launches["pred_recursion_cluster"] == wide == launches["pred_chunk"]:
        raise AssertionError("a K3 chunk at m = 4,096 did not run its recursion on a cluster of 16")
    launches["chunk_recursion_grid"], launches["pred_recursion_wide"] = grid, wide
    return launches, results


def large_grid(rng, peaks, card, dev):
    """Phase 6; returns (kernel rows at m = 4,096, launches of its wrapper
    path, results)."""
    t0 = time.perf_counter()
    model, params, state = large_model(dev, rng)
    kernels6, beside = check_kernels_large(rng, model, params, state, peaks, dev)
    for kname, r in kernels6.items():
        print(f"{kname} m={model.grid.num_points} on {card}: " + json.dumps(r))
    for what, r in beside.items():
        print(f"phase 6 {what} on {card}: " + json.dumps(r))
    t1 = time.perf_counter()
    results = {"hyper": iterative_hyper_step(model, params, state, card)}
    t2 = time.perf_counter()
    results["stream"] = lowrank_stream(rng, card, dev)
    t3 = time.perf_counter()
    launches6, results["wrappers"] = large_grid_wrappers(rng, card, dev)
    t4 = time.perf_counter()
    print(f"phase 6 command time: {t4 - t0:.1f} s (kernel checks {t1 - t0:.1f}, hyper step {t2 - t1:.1f}, "
          f"rank-capped stream {t3 - t2:.1f}, wrappers {t4 - t3:.1f})")
    return kernels6, launches6, results


# --------------------------------------------------------------------------
# phase 7: Dirichlet classification through OnlineSKIClassifier
# --------------------------------------------------------------------------


def spread(values):
    return dict(median=float(np.median(values)), min=float(np.min(values)), max=float(np.max(values)))


def per_update_launches(clf, x, y, q):
    """clf.update on q-point batches of (x, y): the call times (s), losses and
    (K2, K6) launches of each call."""
    times, losses, launches = [], [], []
    for i in range(0, len(x), q):
        before = (rank1_apply.launches, blocked_cholesky.launches)
        t0 = time.perf_counter()
        losses.append(clf.update(x[i : i + q], y[i : i + q]))  # returns floats: the host waits for the card
        times.append(time.perf_counter() - t0)
        launches.append((rank1_apply.launches - before[0], blocked_cholesky.launches - before[1]))
    return times, losses, launches


def gpd_path(card, dev):
    """Phase 7 (a): the experiment layer's wiski_gpd model (banana, 2
    classes; online_gp_tpu/experiments/config.py:45-46) through the entry
    point, as tests/classification/test_ski_classifier.py::test_online_eye_stem
    runs it, then an absorb of the rest of the training split. The launch
    counters are zeroed just before and read just after. Returns (the
    classifier, launches, results)."""
    tr_x, tr_y, te_x, te_y = banana_dataset(n=GPD_N, seed=0)
    clf = OnlineSKIClassifier(IdentityStem(2), tr_x[:GPD_INIT], tr_y[:GPD_INIT], alpha_eps=CLS_ALPHA_EPS,
                              lr=GPD_LR, grid_size=GPD_SIDE, grid_bound=1.0, device=dev)
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    clf.fit(tr_x[:GPD_INIT], tr_y[:GPD_INIT], num_epochs=GPD_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    clf.set_lr(GPD_STREAM_LR)
    correct, upd_s, pred_s, per_update = 0, [], [], []
    for i in range(GPD_INIT, GPD_INIT + GPD_STREAM):
        t0 = time.perf_counter()
        pred = clf.predict(tr_x[i : i + 1])
        correct += int(pred[0] == int(tr_y[i]))  # the host waits for the card
        pred_s.append(time.perf_counter() - t0)
        times, _, launches = per_update_launches(clf, tr_x[i : i + 1], tr_y[i : i + 1], 1)
        upd_s += times
        per_update += launches
    cum_acc = correct / GPD_STREAM
    test_acc = clf.evaluate(te_x, te_y)
    rest = slice(GPD_INIT + GPD_STREAM, len(tr_x))
    t0 = time.perf_counter()
    clf.absorb(tr_x[rest], tr_y[rest])
    torch.cuda.synchronize()
    absorb_s = time.perf_counter() - t0
    launches = read_window()
    r = dict(m=clf.model.grid.num_points, classes=clf.num_classes, fit_s=fit_s, cumulative_acc=cum_acc,
             test_acc=test_acc, test_acc_after_absorb=clf.evaluate(te_x, te_y),
             update_ms=spread([1e3 * t for t in upd_s[1:]]), predict_one_ms=spread([1e3 * t for t in pred_s[1:]]),
             absorb_points=len(tr_x[rest]), absorb_points_per_s=len(tr_x[rest]) / absorb_s,
             K2_K6_per_update=sorted(set(per_update)), launches=launches)
    print(f"phase 7 (a) wiski_gpd (IdentityStem, m={GPD_SIDE**2}, C=2) on {card}: " + json.dumps(r))
    if not (cum_acc >= GPD_CUM_GATE and test_acc >= GPD_TEST_GATE):
        raise AssertionError(f"wiski_gpd: cumulative accuracy {cum_acc:.4f} (gate {GPD_CUM_GATE}), "
                             f"test accuracy {test_acc:.4f} (gate {GPD_TEST_GATE})")
    check_classifier_launches(launches, per_update, "wiski_gpd")
    return clf, launches, r


def check_classifier_launches(launches, per_update, what):
    """K2 once per q = 1 update, K6 on every update, K1 in absorb with its
    recursion on a cluster."""
    if any(k2 != 1 for k2, _ in per_update):
        raise AssertionError(f"{what}: K2 did not launch once per q = 1 update: {sorted(set(per_update))}")
    if any(k6 < 1 for _, k6 in per_update):
        raise AssertionError(f"{what}: an update() did not factor Q with K6: {sorted(set(per_update))}")
    if launches["blocked_chunk"] < 1 or launches["chunk_recursion_cluster"] != launches["blocked_chunk"]:
        raise AssertionError(f"{what}: absorb did not run K1 on its cluster recursion: {launches}")


def classifier_path(card, dev):
    """Phase 7 (b): OnlineSKIClassifier at the constructor's default width
    (LinearStem(2, 2), grid 30, m = 900, C = 2) on banana points: 64
    update()s at q = 1, 8 at q = 32, a predict of 1,024 and an absorb of
    4,096, with the launch counters zeroed just before and read just after.
    A CPU twin (convert) runs the first 8 updates: params within
    TWIN_PARAM_TOL, roots within 1e-3 * scale. Returns (the classifier,
    launches, results, the test split)."""
    tr_x, tr_y, te_x, te_y = banana_dataset(n=CLS_N, seed=1)
    n0, n8 = CLS_SEED_PTS, CLS_SEED_PTS + CLS_TWIN
    n1, n32 = n0 + CLS_UPD1, n0 + CLS_UPD1 + 32 * CLS_UPD32
    kw = dict(alpha_eps=CLS_ALPHA_EPS, lr=TRAIN_LR, grid_size=M_SIDE)
    clf = OnlineSKIClassifier(LinearStem(2, 2), tr_x[:n0], tr_y[:n0], device=dev, **kw)
    twin = load_twin(clf, tr_x[:n0], tr_y[:n0], cls=OnlineSKIClassifier, **kw)
    torch.cuda.synchronize()
    zero_counters()
    t1, losses, per_update = per_update_launches(clf, tr_x[n0:n8], tr_y[n0:n8], 1)
    for i in range(n0, n8):
        losses.append(twin.update(tr_x[i : i + 1], tr_y[i : i + 1]))
    twin_errs = compare_twin(clf, twin)
    more = per_update_launches(clf, tr_x[n8:n1], tr_y[n8:n1], 1)
    t1, losses, per_update = t1 + more[0], losses + more[1], per_update + more[2]
    t32, losses32, per32 = per_update_launches(clf, tr_x[n1:n32], tr_y[n1:n32], 32)
    xt = te_x[:CLS_PRED]
    pred_ms = []
    for _ in range(HOST_REPEATS + 1):
        t0 = time.perf_counter()
        pred = clf.predict(xt)
        torch.cuda.synchronize()
        pred_ms.append(1e3 * (time.perf_counter() - t0))
    xa, ya = tr_x[n32 : n32 + CLS_ABSORB], tr_y[n32 : n32 + CLS_ABSORB]
    t0 = time.perf_counter()
    clf.absorb(xa, ya)
    torch.cuda.synchronize()
    absorb_s = time.perf_counter() - t0
    launches = read_window()
    r = dict(m=clf.model.grid.num_points, classes=clf.num_classes,
             update_q1_ms=spread([1e3 * t for t in t1[1:]]),
             update_q32_points_per_s=spread([32 / t for t in t32[1:]]), predict_ms=spread(pred_ms[1:]),
             predict_points=len(xt), absorb_points=len(xa), absorb_points_per_s=len(xa) / absorb_s,
             test_acc=clf.evaluate(te_x, te_y), K2_K6_per_update=sorted(set(per_update)),
             K6_per_q32_update=sorted({k6 for _, k6 in per32}), twin=twin_errs, launches=launches)
    print(f"phase 7 (b) OnlineSKIClassifier (LinearStem(2, 2), m={M_SIDE**2}, C=2) on {card}: " + json.dumps(r))
    values = [v for pair in losses + losses32 for v in pair]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"classifier path: a non-finite loss: {values}")
    if tuple(pred.shape) != (CLS_PRED,) or not bool(((pred == 0) | (pred == 1)).all()):
        raise AssertionError("classifier path: predict did not return one class label per point")
    check_classifier_launches(launches, per_update, "classifier path")
    if any(k6 < 1 for _, k6 in per32):
        raise AssertionError("classifier path: a q = 32 update() did not factor Q with K6")
    return clf, launches, r, (te_x, te_y)


def lowrank_classifier_path(card, dev):
    """Phase 7 (c): the rank-capped classifier at grid 72 (m = 5,184, routed)
    with low_rank=256, as tests/classification/test_lowrank_classifier.py::
    test_big_grid_auto_routes_and_learns_banana runs it."""
    tr_x, tr_y, te_x, te_y = banana_dataset(seed=0)
    w = OnlineSKIClassifier(IdentityStem(2), tr_x[:LRC_INIT], tr_y[:LRC_INIT], grid_size=LRC_SIDE, lr=GPD_LR,
                            low_rank=LRC_RANK, device=dev)
    if not isinstance(w, OnlineSKILowRankClassifier):
        raise AssertionError("OnlineSKIClassifier did not route grid 72 to the rank-capped core")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.fit(tr_x[:LRC_INIT], tr_y[:LRC_INIT], num_epochs=LRC_EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    upd_ms = []
    for i in range(LRC_INIT, LRC_INIT + 4 * LRC_UPDATES, 4):
        t0 = time.perf_counter()
        w.update(tr_x[i : i + 4], tr_y[i : i + 4], update_stem=False)
        upd_ms.append(1e3 * (time.perf_counter() - t0))
    acc = w.evaluate(te_x, te_y)
    r = dict(m=w.model.grid.num_points, rank=w.model.rank, fit_s=fit_s, update_q4_ms=spread(upd_ms[1:]),
             test_acc=acc)
    print(f"phase 7 (c) OnlineSKILowRankClassifier on {card}: " + json.dumps(r))
    if not (math.isfinite(acc) and acc >= LRC_GATE):
        raise AssertionError(f"rank-capped classifier: banana accuracy {acc:.4f} (gate {LRC_GATE})")
    return r


def _state_fields(state):
    return {"wty": state.wty, "ydy": state.ydy, "d_logdet": state.d_logdet, "mat": state.roots.mat,
            "root": state.roots.root, "inv_root": state.roots.inv_root}


def _state_to(state, device):
    return state._replace(wty=state.wty.to(device), ydy=state.ydy.to(device), d_logdet=state.d_logdet.to(device),
                          roots=RootCache(*(None if t is None else t.to(device) for t in state.roots)))


def differentiable_route(clf, te_x, te_y, card):
    """Phase 7 (d): wiski_fantasize (F = 3, q = 2) and the differentiable
    route (detach_interp=False: condition at q = 1 and 2, a stream and a
    prequential stream of 16 in chunks of 8), with gradients with respect
    to x, on the classifier's CUDA state, each against a CPU twin of the
    same call (values within 1e-3 * scale, gradients within HYPER_GRAD_RTOL
    of their largest entry). K1, K2 and K3 must not launch, and the base
    state must come back bitwise as it was."""
    model, state = clf.model, clf.state
    grid = model.grid
    host_model = model._replace(grid=convert.grid_from_numpy(
        grid.sizes, grid.mins.cpu().numpy(), grid.spacings.cpu().numpy(), device="cpu"))
    host_state = _state_to(state, "cpu")
    params = {"kernel": {k: v.detach() for k, v in clf.params["kernel"].items()}}
    host_params = {"kernel": {k: v.cpu() for k, v in params["kernel"].items()}}
    snapshot = {k: None if v is None else v.clone() for k, v in _state_fields(state).items()}
    feats = clf._features(clf._inputs(te_x[:16]))
    targets, sigma2 = clf._transform(te_y[:16])
    with torch.no_grad():
        caches = wiski_prediction_caches(model, params, state)
    host_caches = tuple(c.cpu() for c in caches)
    rng = np.random.default_rng(SEED + 7)
    weights = {k: torch.tensor(rng.normal(size=tuple(v.shape)) / v.numel() ** 0.5, dtype=torch.float32)
               for k, v in _state_fields(state).items() if k in ("wty", "mat", "root", "inv_root")}

    def scalar(st):
        fields = _state_fields(st)
        return sum(torch.sum(fields[k] * w.to(fields[k].device)) for k, w in weights.items())

    def cases(mdl, prm, st, c):
        y, n = targets.to(st.wty.device), sigma2.to(st.wty.device)
        return {
            "condition q=1": lambda x: scalar(wiski_condition(mdl, st, x[:1], y[:1], n[:1], detach_interp=False)),
            "condition q=2": lambda x: scalar(wiski_condition(mdl, st, x[:2], y[:2], n[:2], detach_interp=False)),
            "stream 16": lambda x: scalar(wiski_stream(mdl, st, x, y, n, detach_interp=False, block_size=8)),
            "prequential 16": lambda x: (lambda o: scalar(o[0]) + o[2].sum() + o[3].sum())(
                wiski_prequential_stream(mdl, prm, st, c, x, y, n, detach_interp=False, block_size=8)),
        }

    before = (rank1_apply.launches, blocked_chunk.launches, pred_chunk.launches)
    fx = feats[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, 2)
    fy = targets[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, -1)
    fn = sigma2[: N_FANT * Q_FANT].reshape(N_FANT, Q_FANT, -1)
    fant = wiski_fantasize(model, state, fx, fy, fn)
    host_fant = wiski_fantasize(host_model, host_state, fx.cpu(), fy.cpu(), fn.cpu())
    out = {}
    for name, got in _state_fields(fant).items():
        want = _state_fields(host_fant)[name]
        err, scale = float((got.cpu() - want).abs().max()), float(want.abs().max())
        out[f"fantasize {name}"] = err
        if got.shape != (N_FANT, *snapshot[name].shape) or not err <= 1e-3 * max(scale, 1.0):
            raise AssertionError(f"wiski_fantasize {name}: {tuple(got.shape)}, differs from the CPU twin by {err:.3e}")
    card_cases, host_cases = cases(model, params, state, caches), cases(host_model, host_params, host_state,
                                                                        host_caches)
    for name, fn_card in card_cases.items():
        grads = []
        for fn_, x in ((fn_card, feats), (host_cases[name], feats.cpu())):
            x = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(fn_(x), [x])
            grads.append(g)
        err, scale = float((grads[0].cpu() - grads[1]).abs().max()), float(grads[1].abs().max())
        out[f"d/dx {name}"] = err / scale
        if not (bool(torch.isfinite(grads[0]).all()) and err <= HYPER_GRAD_RTOL * scale):
            raise AssertionError(f"d/dx of {name} (detach_interp=False) on the card: {err:.3e} from the CPU twin "
                                 f"(largest entry {scale:.3e})")
    torch.cuda.synchronize()
    moved = (rank1_apply.launches - before[0], blocked_chunk.launches - before[1], pred_chunk.launches - before[2])
    if moved != (0, 0, 0):
        raise AssertionError(f"the differentiable route launched (K2, K1, K3) {moved} times")
    for name, was in snapshot.items():
        now = _state_fields(state)[name]
        if (was is None) != (now is None) or (was is not None and not torch.equal(was, now)):
            raise AssertionError(f"the differentiable route moved the base state's {name}")
    print(f"phase 7 (d) fantasize and the differentiable route on {card}: " + json.dumps(out))
    return out


def check_kernels_cls(clfs, peaks, card):
    """Phase 7 (e): K2 (16 calls), K1 (one chunk of k = 128, on its cluster
    recursion) and K6 (Q) at Bd = C = 2 on the classifiers' states at m = 256
    and m = 900, against their plain versions at phase 2's and phase 4's
    tolerances, with device times, bounds and yardsticks. The update vectors
    are banana points' stencils over sqrt(sigma2), each class its noise."""
    out = {}
    tr_x, tr_y, _, _ = banana_dataset(n=CLS_N, seed=2)
    for tag, clf in clfs.items():
        grid, state = clf.model.grid, clf.state
        m = grid.num_points
        L, B = state.roots.root.contiguous(), state.roots.inv_root.contiguous()
        feats = clf._features(clf._inputs(tr_x[:K]))
        _, sigma2 = clf._transform(tr_y[:K])
        idx, w = interp_coeffs(grid, feats)
        idx = idx.to(torch.int32).contiguous()
        wv = (w[None] / torch.sqrt(sigma2.T)[:, :, None]).contiguous()  # (C, K, P)
        rows = {"rank1_apply": check_k2(L, B, idx[:N_K2_6], wv[:, :N_K2_6], peaks, f"{tag} Bd=2")}
        if chunk_cluster_plan(K, m) is None:
            raise AssertionError(f"(k={K}, m={m}) was expected inside K1's cluster envelope")
        rows["blocked_chunk"] = check_k1(L, B, idx, wv, peaks, f"{tag} Bd=2", "cluster")
        rows["blocked_cholesky"] = check_k6(q_matrix(clf.model, clf.params, state), peaks, f"Q ({tag}, Bd=2)")
        for kname, r in rows.items():
            out[f"{kname}@{tag}-bd2"] = r
            print(f"{kname} {tag} Bd=2 on {card}: " + json.dumps(r))
    return out


def classification(peaks, card, dev):
    """Phase 7; returns (kernel rows, {row: launches}, the launch counts of
    the windows of (a) and (b))."""
    t0 = time.perf_counter()
    clf_a, launches_a, _ = gpd_path(card, dev)
    clf_b, launches_b, _, (te_x, te_y) = classifier_path(card, dev)
    lowrank_classifier_path(card, dev)
    differentiable_route(clf_b, te_x, te_y, card)
    rows = check_kernels_cls({"cls-m256": clf_a, "cls-m900": clf_b}, peaks, card)
    launches = {row: (launches_a if "m256" in row else launches_b)[row.split("@")[0]] for row in rows}
    print(f"phase 7 command time: {time.perf_counter() - t0:.1f} s")
    return rows, launches, (launches_a, launches_b)


# --------------------------------------------------------------------------
# phase 8: the online baselines at the experiment presets' widths
# --------------------------------------------------------------------------


def _host_tree(tree):
    """A nested dict (or NamedTuple fields) of tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _copy_optimizers(src, dst):
    """The Adam moments and step counts of src's optimizers into dst's (the
    loaders of convert start them fresh; the wrappers carry them across
    fit and updates)."""
    for name in ("opt", "stem_opt"):
        a, b = getattr(src, name, None), getattr(dst, name, None)
        if a is not None and a.opt is not None:
            b.opt.load_state_dict(copy.deepcopy(a.opt.state_dict()))  # no state shared with src
            b.count = a.count


def _cast_tree(tree, dtype):
    """Floating numpy arrays of a nested dict in ``dtype`` (None: as they are)."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if dtype is not None and isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
        return tree.astype(dtype)
    return tree


def baseline_twin(w, cls, x0, y0, kw, dtype=None):
    """A CPU twin of the baseline wrapper w, built with its configuration kw
    and started from w's state as it stands through convert's loaders,
    optimizer moments copied; ``dtype`` casts its params and state (the
    local GP's expert buffers stay float32, as the JAX package keeps them)."""
    twin = cls(IdentityStem(x0.shape[1]), x0, y0, device="cpu", **kw)
    host = lambda tree: _cast_tree(_host_tree(tree), dtype)
    params = host(w.params)
    if isinstance(w, (OnlineExactRegression, OnlineExactClassifier)):
        convert.load_exact(twin, params, {}, {}, host(w.data._asdict()), host(w._raw), device="cpu")
    elif isinstance(w, OnlineLocalGPRegression):
        convert.load_localgp(twin, params, {}, {}, _host_tree(w.state._asdict()), device="cpu")
    elif isinstance(w, OnlineSGPRegression):
        convert.load_sgpr(twin, params, {}, {}, None if w.old is None else host(w.old._asdict()),
                          None if w.moments is None else host(w.moments._asdict()), w._absorbs_since_rebase,
                          device="cpu")
    else:
        convert.load_svgp(twin, params, {}, {}, None if w.old is None else host(w.old._asdict()), device="cpu")
    _copy_optimizers(w, twin)
    return twin


def compare_baseline_twin(w, twin, make_ref, xt, what):
    """w (the card, float32) against its CPU float32 twin: every param leaf
    within 1e-3 of max(|.|, 1), the predictions on xt within 1e-3 of their
    scale, predicted labels the same but where p(y = 1) lies within that
    difference of 0.5 (at least 99% of them, where a classifier gives
    labels alone). Where a bound is missed, ``make_ref()`` runs the
    float64 twin, and twice the CPU's own float32 distance from float64 is
    added to the bound: the card's and the CPU's float32 errors are two
    independent errors of about that size (float32's resolution through an
    ill-conditioned K_zz, and Adam's steps on gradient entries at rounding
    level, which it normalizes to full size)."""
    xt64 = xt.astype(np.float64)
    leaves = lambda m: [(n, t.detach().cpu().double()) for n, t in _named_leaves(m.params)]

    def outs(m, x):
        out = m.predict(x)
        return [o.cpu() for o in (out if isinstance(out, tuple) else (out,))]

    # (name, card, CPU float32, scale, the float64 twin's value or None)
    pairs = [(n, a, b, max(float(b.abs().max()), 1.0), i) for i, ((n, a), (_, b)) in
             enumerate(zip(leaves(w), leaves(twin)))]
    out_w, out_t = outs(w, xt), outs(twin, xt)
    floats = [(f"predict {i}", a.double(), b.double(), max(float(b.abs().max()), 1e-30), i)
              for i, (a, b) in enumerate(zip(out_w, out_t)) if a.is_floating_point()]
    ref = None
    errs = {}
    for kind, rows in (("param", pairs), ("prediction", floats)):
        for name, a, b, scale, i in rows:
            err = float((a - b).abs().max())
            errs[name] = [err]
            if err <= BASE_TWIN_RTOL * scale:
                continue
            if ref is None:
                ref = make_ref()
                ref_leaves, ref_out = leaves(ref), outs(ref, xt64)
            c = ref_leaves[i][1] if kind == "param" else ref_out[i].double()
            ref_err = float((b - c).abs().max())
            errs[name].append(ref_err)
            if not (torch.isfinite(a).all() and err <= BASE_TWIN_RTOL * scale + 2.0 * ref_err):
                raise AssertionError(f"{what} CPU twin: {kind} {name} differs by {err:.3e} (scale {scale:.3e}; "
                                     f"float32 vs float64 on the CPU: {ref_err:.3e})")
    if not out_w[0].is_floating_point():
        differ = out_w[0] != out_t[0]
        errs["label mismatch share"] = float(differ.double().mean())
        if floats:
            # a label may flip only where p(y = 1) is within the measured p
            # difference of the 0.5 threshold
            p_err, p_twin = errs[floats[-1][0]][0], floats[-1][2]
            bad = differ & ((p_twin - 0.5).abs() > p_err)
            if bool(bad.any()):
                raise AssertionError(f"{what} CPU twin: {int(bad.sum())} labels differ away from p = 0.5")
        elif not errs["label mismatch share"] <= 0.01:
            raise AssertionError(f"{what} CPU twin: {errs['label mismatch share']:.3%} of the predicted labels differ")
    return errs


def profile_baseline_update(w, x, y, card, what):
    """One update() under torch.profiler after a warm-up: wall ms, CUDA
    kernel ms and launches, the device's idle share, and the host syncs
    (readbacks of a device scalar, aten::_local_scalar_dense, and
    device-to-host copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    w.update(x[:1], y[:1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        w.update(x[1:2], y[1:2])
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    busy_us, launches, dtoh, scalars = 0.0, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            if "Memcpy DtoH" in e.name:
                dtoh += 1
            else:
                launches += 1
                busy_us += e.time_range.end - e.time_range.start
        elif e.name == "aten::_local_scalar_dense":
            scalars += 1
    r = dict(wall_ms=wall_us / 1e3, cuda_kernel_ms=busy_us / 1e3, launches=launches,
             device_idle_share=1 - busy_us / wall_us, scalar_readbacks=scalars, dtoh_copies=dtoh)
    print(f"  {what} update() under torch.profiler on {card}: " + json.dumps(r))
    return r


def baseline_stream(name, card, dev):
    """One preset (online_gp_tpu/experiments/config.py:24-50) on the card
    with an IdentityStem, as experiments/regression.py runs it: init on the
    first 5% of the training stream, a fit of BASE_FIT_EPOCHS on it, then
    BASE_STREAM prequential steps at batch 1 (evaluate the point, then
    update), then the test set. CPU twins (convert) at float32 and at
    float64 run BASE_TWIN steps from the state after the first update (see
    compare_baseline_twin). Returns the results."""
    cls, task, kw = BASE_PRESETS[name]
    if task == "regression":
        tr_x, tr_y, te_x, te_y = streaming_friedman(n=BASE_N, num_dims=BASE_DIMS, seed=0)
    else:
        tr_x, tr_y, te_x, te_y = banana_dataset(n=BASE_CLS_N, seed=0)
    n0 = int(BASE_INIT_RATIO * len(tr_x))
    x0, y0 = tr_x[:n0], tr_y[:n0]
    w = cls(IdentityStem(tr_x.shape[1]), x0, y0, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.fit(x0, y0, BASE_FIT_EPOCHS)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    upd_ms, losses, online, twin_errs, twin_s = [], [], [], None, 0.0
    t_stream = time.perf_counter()
    for i in range(n0, n0 + BASE_STREAM):
        x, y = tr_x[i : i + 1], tr_y[i : i + 1]
        if i == n0 + 1:
            # the twins start after the first update: the fit leaves the
            # optimizers fresh, and a fresh Adam's first step is lr * sign(g),
            # which turns a gradient entry at float32 rounding level (K_zz's
            # condition reaches 4e10 at 256 inducing points in 2-D) into a
            # full step of either sign
            twin, ref = baseline_twin(w, cls, x0, y0, kw), baseline_twin(w, cls, x0, y0, kw, np.float64)
            twin_steps = []
        if task == "regression":
            online.append(w.evaluate(x, y)[0])
        else:
            pred = w.predict(x)
            pred = pred[0] if isinstance(pred, tuple) else pred
            online.append(float(int(pred[0]) == int(y[0])))
        t1 = time.perf_counter()
        losses.append(w.update(x, y))  # returns floats: the host waits for the card
        upd_ms.append(1e3 * (time.perf_counter() - t1))
        if 1 <= i - n0 <= BASE_TWIN:
            t1 = time.perf_counter()
            losses.append(twin.update(x, y))
            twin_steps.append((x.astype(np.float64), y.astype(np.float64) if task == "regression" else y))
            if i - n0 == BASE_TWIN:

                def make_ref():
                    for step in twin_steps:
                        ref.update(*step)
                    return ref

                twin_errs = compare_baseline_twin(w, twin, make_ref, te_x, name)
            twin_s += time.perf_counter() - t1
    pred_ms = []
    for _ in range(HOST_REPEATS + 1):
        t1 = time.perf_counter()
        out = w.predict(te_x)
        torch.cuda.synchronize()
        pred_ms.append(1e3 * (time.perf_counter() - t1))
    stream_s = time.perf_counter() - t_stream - twin_s
    r = dict(preset=name, n_init=n0, fit_epochs=BASE_FIT_EPOCHS, fit_ms=fit_ms, stream=BASE_STREAM,
             stream_s=stream_s, cpu_twins_s=twin_s,
             update_ms=spread(upd_ms[1:]), predict_ms=spread(pred_ms[1:]), predict_points=len(te_x))
    if task == "regression":
        r["online_rmse"] = float(np.mean(online))
        r["test_rmse"], r["test_nll"] = w.evaluate(te_x, te_y)
        mean, var = out
        values = [mean, var]
    else:
        r["online_acc"] = float(np.mean(online))
        r["test_acc"] = w.evaluate(te_x, te_y)
        values = [out[1]] if isinstance(out, tuple) else []
    r["twin"] = twin_errs
    flat = [v for pair in losses for v in pair if not (isinstance(w, OnlineSGPRegression) and math.isnan(v))]
    if not all(math.isfinite(v) for v in flat):
        raise AssertionError(f"{name}: a non-finite loss on the stream")
    for t in values:
        if t.shape[0] != len(te_x) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: the test predictions are not finite of {len(te_x)} rows")
    if task == "regression" and not all(math.isfinite(r[k]) for k in ("test_rmse", "test_nll")):
        raise AssertionError(f"{name}: test RMSE or NLL not finite")
    print(f"phase 8 {name} ({cls.__name__}, IdentityStem({tr_x.shape[1]})) on {card}: " + json.dumps(r))
    r["profile"] = profile_baseline_update(w, tr_x[n0 + BASE_STREAM :], tr_y[n0 + BASE_STREAM :], card, name)
    return r


def baseline_bars(card, dev):
    """The JAX package's own quality bars (tests/regression/test_baseline_models.py:33-138)
    on the card, at their configurations: IdentityStem(2),
    streaming_friedman(n=1200, num_dims=2) and banana_dataset(n=800)."""
    t0 = time.perf_counter()
    tx, ty, ex, ey = streaming_friedman(n=1200, num_dims=2, seed=0)
    bx, by, bex, bey = banana_dataset(n=800, seed=0)
    s2, res = IdentityStem, {}

    m = OnlineExactRegression(s2(2), tx[:100], ty[:100], lr=0.05, device=dev)
    m.fit(tx[:400], ty[:400], num_epochs=40)
    fit_rmse, fit_nll = m.evaluate(ex, ey)
    for i in range(400, 420):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["exact_regression"] = r = dict(rmse=fit_rmse, nll=fit_nll, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok = r["rmse"] <= 0.2 and r["nll"] <= 1.0 and r["rmse_after_stream"] <= 0.2

    m = OnlineSVGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True, device=dev)
    m.fit(tx[:800], ty[:800], num_epochs=150, batch_size=256)
    rmse = m.evaluate(ex, ey)[0]
    for i in range(800, 820):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["svgp_regression"] = r = dict(rmse=rmse, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok &= r["rmse"] <= 0.6 and math.isfinite(r["rmse_after_stream"])

    arms = {}
    for mode in ("closed_form", "grad"):
        m = OnlineSVGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, streaming=True,
                                 variational_mode=mode, device=dev)
        m.fit(tx[:100], ty[:100], num_epochs=60, batch_size=100)
        for i in range(100, 500, 4):
            m.update(tx[i : i + 4], ty[i : i + 4])
        arms[mode] = m.evaluate(ex, ey)[0]
    res["svgp_closed_form_streaming"] = arms
    ok &= math.isfinite(arms["closed_form"]) and arms["closed_form"] <= arms["grad"] + 1e-6 and arms["closed_form"] <= 0.45

    m = OnlineSGPRegression(s2(2), tx[:100], ty[:100], num_inducing=32, lr=0.05, num_update_steps=0, device=dev)
    m.fit(tx[:800], ty[:800], num_epochs=60)
    rmse = m.evaluate(ex, ey)[0]
    for i in range(800, 900):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["sgpr_regression"] = r = dict(rmse=rmse, rmse_after_stream=m.evaluate(ex, ey)[0])
    ok &= r["rmse"] <= 0.3 and r["rmse_after_stream"] <= r["rmse"] + 0.05

    m = OnlineLocalGPRegression(s2(2), tx[:200], ty[:200], lr=0.05, max_data_per_model=128, max_experts=8, device=dev)
    m.fit(tx[:200], ty[:200], num_epochs=40)
    for i in range(200, 260):
        m.update(tx[i : i + 1], ty[i : i + 1])
    res["localgp_regression"] = r = dict(rmse=m.evaluate(ex, ey)[0], experts=m.num_experts)
    ok &= r["rmse"] <= 0.35 and r["experts"] >= 2

    c = OnlineExactClassifier(s2(2), bx[:100], by[:100], lr=0.05, device=dev)
    c.fit(bx[:400], by[:400], num_epochs=40)
    acc = c.evaluate(bex, bey)
    correct = 0
    for i in range(400, 500):
        correct += int(int(c.predict(bx[i : i + 1])[0]) == by[i])
        c.update(bx[i : i + 1], by[i : i + 1])
    res["exact_classifier"] = r = dict(test_acc=acc, online_acc=correct / 100, test_acc_after_stream=c.evaluate(bex, bey))
    ok &= r["test_acc"] >= 0.89 and r["online_acc"] >= 0.80 and r["test_acc_after_stream"] >= 0.89

    v = OnlineSVGPClassifier(s2(2), bx[:100], by[:100], num_inducing=32, lr=0.1, device=dev)
    v.fit(bx[:600], by[:600], num_epochs=150, batch_size=256)
    acc = v.evaluate(bex, bey)
    correct = 0
    for i in range(600, 640):
        correct += int(int(v.predict(bx[i : i + 1])[0][0]) == by[i])
        v.update(bx[i : i + 1], by[i : i + 1])
    res["svgp_classifier"] = r = dict(test_acc=acc, online_acc=correct / 40, test_acc_after_stream=v.evaluate(bex, bey))
    ok &= r["test_acc"] >= 0.85 and r["online_acc"] >= 0.65 and r["test_acc_after_stream"] >= 0.75

    res["seconds"] = time.perf_counter() - t0
    print(f"phase 8 quality bars (tests/regression/test_baseline_models.py) on {card}: " + json.dumps(res))
    if not ok:
        raise AssertionError(f"phase 8: a baseline quality bar failed: {res}")
    return res


def baselines(card, dev):
    """Phase 8: the six baseline wrappers; no kernel of the port runs here
    (the JAX baselines reach no pl.pallas_call), so the launch counters
    must not move."""
    t0 = time.perf_counter()
    zero_counters()
    results = {name: baseline_stream(name, card, dev) for name in BASE_PRESETS}
    results["bars"] = baseline_bars(card, dev)
    launches = read_counters()
    if any(launches.values()):
        raise AssertionError(f"phase 8 launched a WISKI kernel: {launches}")
    print(f"phase 8 command time: {time.perf_counter() - t0:.1f} s")
    return results


# --------------------------------------------------------------------------
# phase 9: BayesOpt and active learning at the JAX package's default widths
# --------------------------------------------------------------------------


def bo_run(card, dev, what, **kw):
    """run_bayesopt at the defaults (Ackley, dim 3, grid 10: m = 1,000, the
    reference surrogate, 10 initial points, 50 Adam refit steps) with kw,
    its launch counters zeroed just before and read just after. Gate: the
    best-so-far is monotone and the last is at least the first."""
    zero_counters()
    t0 = time.perf_counter()
    out = bo_loop.run_bayesopt(verbose=False, device=dev, **kw)
    torch.cuda.synchronize()
    launches = read_window()
    bps = out["best_per_step"]
    if not (all(b2 >= b1 for b1, b2 in zip(bps, bps[1:])) and bps[-1] >= bps[0]):
        raise AssertionError(f"phase 9 {what}: best-so-far not monotone: {bps}")
    recs = out["records"]
    r = dict(steps=len(recs), best_per_step=bps, acq_values=[x["acq_value"] for x in recs],
             fit_s=spread([x["fit_time"] for x in recs]), acq_s=spread([x["acq_time"] for x in recs]),
             cond_ms=spread([1e3 * x["cond_time"] for x in recs]),
             k2_launches=launches["rank1_apply"], k6_launches=launches["blocked_cholesky"],
             seconds=time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in r["acq_values"]):
        raise AssertionError(f"phase 9 {what}: a non-finite acquisition value {r['acq_values']}")
    print(f"phase 9 (a) run_bayesopt {what} on {card}: " + json.dumps(r))
    return out, launches, r


def _params_cpu(params):
    return tree_rebuild(params, [p.cpu() for p in tree_leaves(params)])


def _clone_roots(state):
    """The state with its roots copied: K2 conditions them in place."""
    return state._replace(roots=RootCache(*(None if t is None else t.clone() for t in state.roots)))


def bo_step(model, params, state, cfg, step_i, gen, train_u, best_f, noise_value):
    """One BO step of run_bayesopt (UCB, q = 1) from its pieces: the refit,
    the acquisition, its optimization and the condition (which takes the
    state). Returns (params, candidate, new state)."""
    init, fit = bo_loop.make_fit_fn(model, cfg, "adam", 50, 0.05)
    params, _, _ = fit(params, state, init(params))
    acq_fn = bo_loop.make_acquisition("ucb", model, params, state, cfg, 1, gen, step_i, best_f, train_u, 0.1)
    raw = sobol_raw_init(1, 3, bo_loop.ACQ_RAW, step_i)
    unit = torch.tensor([[0.0, 1.0]] * 3, device=state.wty.device)
    cand, _ = optimize_acqf(acq_fn, unit, q=1, num_restarts=bo_loop.ACQ_RESTARTS, raw_samples=bo_loop.ACQ_RAW,
                            maxiter=bo_loop.ACQ_MAXITER, raw_init=raw)
    y = torch.full((1, 1), 0.5, device=state.wty.device)
    state = wiski_condition(model, state, cand, y, noise_value * torch.ones_like(y))
    return params, cand, state


def bo_twin(out, card, dev):
    """A CPU twin of one BO step from the card's final state: the refit's
    params within BO_TWIN_RTOL of max(scale, 1); the UCB and EI acquisitions
    of the card's params at BO_TWIN_PTS fixed points within BO_TWIN_RTOL of
    their largest value; the roots after conditioning on one of the points
    within BO_TWIN_RTOL * scale."""
    cfg = SolverConfig(use_toeplitz=True)
    model, noise_value = bo_loop._make_surrogate("reference", 3, 10, 0.1, device=dev)
    cmodel, _ = bo_loop._make_surrogate("reference", 3, 10, 0.1, device="cpu")
    params, state, train_u = out["params"], out["state"], out["train_u"]
    best_f = torch.tensor(0.0)
    cstate = _state_to(state, "cpu")
    init, fit = bo_loop.make_fit_fn(model, cfg, "adam", 50, 0.05)
    p_card, _, _ = fit(params, state, init(params))
    cinit, cfit = bo_loop.make_fit_fn(cmodel, cfg, "adam", 50, 0.05)
    cparams = _params_cpu(params)
    p_cpu, _, _ = cfit(cparams, cstate, cinit(cparams))
    worst = {}
    for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1.0)
        worst["params"] = max(worst.get("params", 0.0), err)
    pts = torch.rand((BO_TWIN_PTS, 1, 3), generator=torch.Generator().manual_seed(9))
    for name in ("ucb", "ei"):
        g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        fa = bo_loop.make_acquisition(name, model, p_card, state, cfg, 1, g1, 3, best_f.to(dev), train_u, 0.1)
        fb = bo_loop.make_acquisition(name, cmodel, _params_cpu(p_card), cstate, cfg, 1, g2, 3, best_f,
                                      train_u.cpu(), 0.1)
        with torch.no_grad():
            va, vb = fa(pts.to(dev)).cpu(), fb(pts)
        worst[f"acq_{name}"] = float((va - vb).abs().max() / vb.abs().max())
    cand = pts[0].to(dev)
    y = torch.full((1, 1), 0.25)
    s_card = wiski_condition(model, _clone_roots(state), cand, y.to(dev), noise_value * torch.ones((1, 1), device=dev))
    s_cpu = wiski_condition(cmodel, cstate, cand.cpu(), y, noise_value * torch.ones((1, 1)))
    for f in ("root", "inv_root"):
        a, b = getattr(s_card.roots, f).cpu(), getattr(s_cpu.roots, f)
        worst[f] = float((a - b).abs().max() / b.abs().max())
    print(f"phase 9 (a) CPU twin of one BO step on {card} (relative max errors): " + json.dumps(worst))
    if any(v > BO_TWIN_RTOL for v in worst.values()):
        raise AssertionError(f"phase 9: the CPU twin of a BO step parts from the card: {worst}")
    return worst


def profile_bo_step(out, card, dev):
    """One BO step (UCB, q = 1) under torch.profiler from the card's final
    state: wall ms, CUDA kernel ms and launches, the device's idle share,
    K2 and K6 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = SolverConfig(use_toeplitz=True)
    model, noise_value = bo_loop._make_surrogate("reference", 3, 10, 0.1, device=dev)
    params, train_u = out["params"], out["train_u"]
    bo_step(model, params, _clone_roots(out["state"]), cfg, 1, torch.Generator().manual_seed(2), train_u,
            torch.tensor(0.0, device=dev), noise_value)
    torch.cuda.synchronize()
    zero_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        bo_step(model, params, _clone_roots(out["state"]), cfg, 1, torch.Generator().manual_seed(2), train_u,
                torch.tensor(0.0, device=dev), noise_value)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    launches = read_window()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            count, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, us + e.time_range.end - e.time_range.start)
    busy_us = sum(us for _, us in by_name.values())
    r = dict(wall_ms=wall_us / 1e3, cuda_kernel_ms=busy_us / 1e3, cuda_launches=sum(c for c, _ in by_name.values()),
             device_idle_share=1 - busy_us / wall_us, k2_launches=launches["rank1_apply"],
             k6_launches=launches["blocked_cholesky"])
    print(f"phase 9 one BO step (UCB, q = 1, m = 1000) under torch.profiler on {card}: " + json.dumps(r))
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d} x  {name[:110]}")
    return r


def check_kernels_bo(out, peaks, card, dev):
    """K2 (BO_K2_CALLS calls: stencils of points in the unit cube over the
    fixed noise's root) and K6 (Q) on the BO path's final state at
    m = 1,000, against their plain versions at phase 2's and phase 4's
    tolerances, with device times, bounds and yardsticks. Phase 2's 1e-5
    is for roots of unit scale; the BO state's fixed noise of 0.01 scales
    its roots and update vectors up, so K2's absolute part is 1e-5 of
    max(scale, 1), the scale the largest entry of its inputs (the roots
    and L's update, |L p|); the relative part stays 1e-5."""
    model, noise_value = bo_loop._make_surrogate("reference", 3, 10, 0.1, device=dev)
    state = out["state"]
    L, B = state.roots.root.contiguous(), state.roots.inv_root.contiguous()
    x = torch.rand((BO_K2_CALLS, 3), generator=torch.Generator().manual_seed(4)).to(dev)
    idx, w = interp_coeffs(model.grid, x)
    wv = (w[None] / math.sqrt(noise_value)).contiguous()
    p = torch.einsum("bp,bpm->bm", wv[:, 0], B[:, idx[0]])
    scale = max(float(L.abs().max()), float(B.abs().max()), float((L @ p[..., None]).abs().max()), 1.0)
    print(f"  K2 on the BO state: scale {scale:.4g}, atol {1e-5 * scale:.3g}")
    rows = {"rank1_apply": check_k2(L, B, idx.to(torch.int32).contiguous(), wv, peaks, "bo-m1000",
                                    atol=1e-5 * scale),
            "blocked_cholesky": check_k6(q_matrix(model, out["params"], state), peaks, "Q (bo-m1000)")}
    for kname, r in rows.items():
        print(f"{kname} bo-m1000 on {card}: " + json.dumps(r))
    return {f"{kname}@bo-m1000": r for kname, r in rows.items()}


def active_learning_runs(card, dev):
    """(b) run_active_learning at the reference's 30x30 grid (m = 900) on
    malaria_dataset(n=2500), WISKI and exact, AL_STEPS steps each; (c)
    run_mpv_osvgp at 64 inducing points. Gates: finite RMSE, the WISKI
    arm's mean variance contracts, MPV's does not grow (the JAX tests'
    bars). K2 launches once per WISKI condition, K6 on every refit step;
    the exact arm and MPV launch neither."""
    res, windows = {}, {}
    for arm in ("wiski", "exact"):
        zero_counters()
        t0 = time.perf_counter()
        out = run_active_learning(model_type=arm, num_steps=AL_STEPS, verbose=False, device=dev)
        torch.cuda.synchronize()
        launches = read_window()
        recs = out["records"]
        r = dict(test_rmse=[x["test_rmse"] for x in recs], avg_variance=[x["avg_variance"] for x in recs],
                 fit_s=spread([x["fit_time"] for x in recs]), acq_s=spread([x["acq_time"] for x in recs]),
                 cond_ms=spread([1e3 * x["cond_time"] for x in recs]), k2_launches=launches["rank1_apply"],
                 k6_launches=launches["blocked_cholesky"], seconds=time.perf_counter() - t0)
        print(f"phase 9 (b) run_active_learning {arm} on {card}: " + json.dumps(r))
        if not all(math.isfinite(v) for v in r["test_rmse"]):
            raise AssertionError(f"phase 9 (b) {arm}: non-finite test RMSE {r['test_rmse']}")
        if arm == "wiski":
            if not r["avg_variance"][-1] < r["avg_variance"][0]:
                raise AssertionError(f"phase 9 (b): the posterior variance did not contract: {r['avg_variance']}")
            if launches["rank1_apply"] != AL_STEPS or launches["blocked_cholesky"] < AL_STEPS * 100:
                raise AssertionError(f"phase 9 (b): K2 must launch once per condition and K6 on every refit "
                                     f"step: {launches}")
            windows["al"] = launches
        elif any(launches.values()):
            raise AssertionError(f"phase 9 (b): the exact arm launched a WISKI kernel: {launches}")
        res[arm] = r
    zero_counters()
    t0 = time.perf_counter()
    out = run_mpv_osvgp(num_steps=MPV_STEPS, num_inducing=64, verbose=False, device=dev)
    torch.cuda.synchronize()
    recs = out["records"]
    r = dict(test_rmse=[x["test_rmse"] for x in recs], avg_variance=[x["avg_variance"] for x in recs],
             acq_s=spread([x["acq_time"] for x in recs]), seconds=time.perf_counter() - t0)
    print(f"phase 9 (c) run_mpv_osvgp (64 inducing points) on {card}: " + json.dumps(r))
    if any(read_counters().values()):
        raise AssertionError("phase 9 (c): MPV-OSVGP launched a WISKI kernel")
    if not (all(math.isfinite(v) for v in r["test_rmse"]) and r["avg_variance"][-1] <= r["avg_variance"][0] + 1e-3):
        raise AssertionError(f"phase 9 (c): a bar failed: {r}")
    res["mpv"] = r
    return res, windows


def bayesopt_phase(peaks, card, dev):
    """Phase 9; returns (kernel rows, {row: launches}, the launch counts of
    its path windows)."""
    t0 = time.perf_counter()
    windows = {}
    out, launches, r = bo_run(card, dev, f"UCB q=1 ({BO_UCB_STEPS} steps)", acqf="ucb", num_steps=BO_UCB_STEPS)
    # q = 1: K2 absorbs each queried point; K6 factors Q in every refit
    # forward (50 a step) and once for the step's acquisition caches
    if launches["rank1_apply"] != BO_UCB_STEPS or launches["blocked_cholesky"] != BO_UCB_STEPS * 51:
        raise AssertionError(f"phase 9 (a): K2 {launches['rank1_apply']} (want {BO_UCB_STEPS}), "
                             f"K6 {launches['blocked_cholesky']} (want {BO_UCB_STEPS * 51})")
    windows["ucb"] = launches
    for acqf in ("ei", "nei", "kg", "mves", "ucb"):
        torch.cuda.reset_peak_memory_stats()
        _, launches_q, rq = bo_run(card, dev, f"{acqf.upper()} q={BO_Q} (1 step)", acqf=acqf, num_steps=1, batch_size=BO_Q)
        rq["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"  peak device memory of the {acqf.upper()} q={BO_Q} step: {rq['peak_gib']:.3f} GiB")
        if launches_q["rank1_apply"] != 0 or launches_q["blocked_cholesky"] < 50:
            raise AssertionError(f"phase 9 (a) {acqf} q={BO_Q}: K2 must not launch (a q > 1 condition is the "
                                 f"plain dense update) and K6 must factor the refit's Q: {launches_q}")
        windows[f"{acqf}-q{BO_Q}"] = launches_q
    torch.cuda.reset_peak_memory_stats()
    _, launches_k, rk = bo_run(card, dev, "KG q=1 (1 step)", acqf="kg", num_steps=1)
    print(f"  peak device memory of the KG q=1 step: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    windows["kg"] = launches_k
    _, launches_l, _ = bo_run(card, dev, "UCB q=1, fit_method=lbfgs (1 step)", acqf="ucb", num_steps=1,
                              fit_method="lbfgs")
    if launches_l["rank1_apply"] != 1 or launches_l["blocked_cholesky"] < 50:
        raise AssertionError(f"phase 9 (a) lbfgs: {launches_l}")
    windows["lbfgs"] = launches_l
    bo_twin(out, card, dev)
    profile_bo_step(out, card, dev)
    al, al_windows = active_learning_runs(card, dev)
    windows.update(al_windows)
    rows = check_kernels_bo(out, peaks, card, dev)
    total = {k: sum(w[k] for w in windows.values()) for k in ("rank1_apply", "blocked_cholesky")}
    launches_rows = {row: total[row.split("@")[0]] for row in rows}
    print(f"phase 9 path launches (K2, K6): {json.dumps(total)}")
    print(f"phase 9 command time: {time.perf_counter() - t0:.1f} s")
    return rows, launches_rows, windows


# --------------------------------------------------------------------------
# phase 10: the experiment drivers
# --------------------------------------------------------------------------


def driver_cfg(args, name, dev):
    return exp_config.parse_config(args + [f"log_dir={DRIVER_DIR / name}", f"device={dev}"])


def driver_window(what, fn, log):
    """fn() with the launch counters zeroed just before and read just after,
    its prints sent to ``log``; returns (result, launches, seconds)."""
    zero_counters()
    t0 = time.perf_counter()
    print(f"==== {what}", file=log, flush=True)
    with contextlib.redirect_stdout(log):
        out = fn()
    torch.cuda.synchronize()
    return out, read_window(), time.perf_counter() - t0


def online_metrics(log_dir, what, columns):
    """The online_metrics table: the JAX driver's schema, every value finite."""
    with open(Path(log_dir) / "online_metrics.csv") as f:
        reader = csv.DictReader(f)
        cols, rows = reader.fieldnames, [{k: float(v) for k, v in r.items()} for r in reader]
    if cols != columns:
        raise AssertionError(f"phase 10 {what}: online_metrics columns {cols}")
    if not rows or not all(math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"phase 10 {what}: a non-finite or missing online metric: {rows}")
    return rows


def check_resume(cfg, out, what, card, log):
    """A fresh wrapper on the card, loaded from the driver's final_state,
    reproduces its test metrics to RESUME_TOL; returns the wrapper."""
    with contextlib.redirect_stdout(log):
        train_x, train_y, test_x, test_y = load_dataset(cfg)
        n0 = int(cfg["model"]["init_ratio"] * len(train_x))
        fresh = build_model(cfg, train_x[:n0], train_y[:n0])
    load_wrapper(out["checkpoint"], fresh)
    got = fresh.evaluate(test_x, test_y)
    got = got if isinstance(got, tuple) else (got,)
    want = (out["test_rmse"], out["test_nll"]) if "test_rmse" in out else (out["test_acc"],)
    err = max(abs(a - b) for a, b in zip(got, want))
    print(f"  phase 10 {what}: the checkpoint resumes on {card}: {list(got)} against {list(want)}, err {err:.3g}")
    if not err <= RESUME_TOL:
        raise AssertionError(f"phase 10 {what}: the resumed wrapper parts by {err} > {RESUME_TOL}")
    return fresh


def check_kernels_drv(reg, cfg, peaks, card, log):
    """K2 (N_K2_6 calls), K1 and K3 (one chunk of k = K each) and K6 (Q) at
    the driver path's shapes (Bd = 1, m = 256), on the state and caches of
    the fused trial's final online model (``reg``, resumed from its
    checkpoint), against their plain versions, with device times, bounds
    and yardsticks. The update vectors are stencils of the test split's
    stem features at unit noise, as the drivers' updates are. K3 keeps
    phase 2's 2e-4; K2 and K1 keep phase 2's relative 1e-5, their absolute
    part 1e-5 of max(scale, 1), the scale the largest entry of the roots
    and of L's update |L p| (phase 9's rule: the state's roots are not of
    unit scale)."""
    with contextlib.redirect_stdout(log):
        _, _, test_x, test_y = load_dataset(cfg)
        feats = reg._features(reg._inputs(test_x[:K])).detach()
        y = reg._targets(test_y[:K]).T.contiguous()
        with torch.no_grad():
            mean_cache, cov_cache = reg._ensure_pred_caches()
    grid, state = reg.model.grid, reg.state
    m = grid.num_points
    L, B = state.roots.root.contiguous(), state.roots.inv_root.contiguous()
    idx, w = interp_coeffs(grid, feats)
    idx, w = idx.to(torch.int32).contiguous(), w.contiguous()
    p = torch.einsum("bp,bpm->bm", w[None, 0], B[:, idx[0].long()])
    scale = max(float(L.abs().max()), float(B.abs().max()), float((L @ p[..., None]).abs().max()), 1.0)
    print(f"  kernels on the driver state (m = {m}): scale {scale:.4g}, atol {1e-5 * scale:.3g}")
    rows = {
        "rank1_apply": check_k2(L, B, idx[:N_K2_6], w[None, :N_K2_6].contiguous(), peaks, "drv-m256",
                                atol=1e-5 * scale),
        "blocked_chunk": check_k1(L, B, idx, w[None].contiguous(), peaks, "drv-m256", "cluster",
                                  atol=1e-5 * scale),
        "pred_chunk": check_k3(cov_cache.contiguous(), mean_cache[..., 0].contiguous(), idx, w, y, peaks,
                               "drv-m256", "cluster"),
        "blocked_cholesky": check_k6(q_matrix(reg.model, reg.params, state), peaks, "Q (drv-m256)"),
    }
    for kname, r in rows.items():
        print(f"{kname} drv-m256 on {card}: " + json.dumps(r))
    return {f"{kname}@drv-m256": r for kname, r in rows.items()}


def stream_twin(dev, card, log):
    """(a)'s CPU twin: the trial up to its stream on the card (prepare_trial:
    dataset, batch fit, online pretrain), both models saved and loaded into
    CPU wrappers of the same config, then REG_TWIN_STREAM online_regression
    steps on each side. The twin starts from the card's models because the
    float32 LinearStem fit itself parts run from run (PERF.md); the stream's
    online_metrics must agree within DRIVER_TWIN_RTOL."""
    cfg = driver_cfg(REG_ARGS + [f"max_stream={REG_TWIN_STREAM}"], "twin-card", dev)
    cfg_cpu = driver_cfg(REG_ARGS + [f"max_stream={REG_TWIN_STREAM}"], "twin-cpu", "cpu")
    with contextlib.redirect_stdout(log):
        _, batch, online, (sx, sy, tx, ty) = prepare_trial(cfg)
        train_x, train_y, _, _ = load_dataset(cfg_cpu)
        n0 = int(cfg["model"]["init_ratio"] * len(train_x))
        twins = []
        for name, model, x, y in (("batch", batch, train_x, train_y), ("online", online, train_x[:n0], train_y[:n0])):
            save_wrapper(str(DRIVER_DIR / "twin-snap" / name), model)
            twin = build_model(cfg_cpu, x, y)
            load_wrapper(str(DRIVER_DIR / "twin-snap" / name), twin)
            twins.append(twin)
        base_lr = cfg["dataset"]["base_lr"]
        twins[1].set_lr(gp_lr=base_lr / 10, stem_lr=base_lr / 100)
        tables = []
        for b, o in ((batch, online), twins):
            logger = CSVLogger(str(DRIVER_DIR / "twin-rows"), "card" if b is batch else "cpu")
            online_regression(b, o, sx, sy, tx, ty, cfg["update_stem"], cfg["batch_size"], logger,
                              cfg["logging_freq"], REG_TWIN_STREAM)
            tables.append(logger.tables["online_metrics"])
    errs = {}
    for col in ONLINE_METRICS:
        if col == "step_time":
            continue
        terms = ("online_rmse", "batch_rmse") if col == "regret" else (col,)
        scale = max(max(abs(r[t]) for r in tables[0] for t in terms), 1e-12)
        errs[col] = max(abs(a[col] - b[col]) for a, b in zip(*tables)) / scale
    print(f"  phase 10 (a) CPU twin of {REG_TWIN_STREAM} stream steps on {card}: relative errors {json.dumps(errs)}")
    bad = {k: v for k, v in errs.items() if not v <= DRIVER_TWIN_RTOL}
    if bad or len(tables[0]) != len(tables[1]) or not tables[0]:
        raise AssertionError(f"phase 10 (a): the CPU twin parts from the card: {bad}")


def drivers_phase(peaks, card, dev):
    """Phase 10; returns the kernel checks on the driver state and the
    launch counts of its windows, summed."""
    t_phase = time.perf_counter()
    if not native_available():
        raise AssertionError("phase 10: the native stream loader did not build (g++)")
    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    DRIVER_DIR.mkdir(parents=True)
    windows, seconds = {}, {}
    with open(DRIVER_DIR / "driver_stdout.log", "w") as log:
        # (a) the regression driver, step mode
        cfg = driver_cfg(REG_ARGS + [f"max_stream={REG_STREAM}"], "regression", dev)
        out, windows["a"], seconds["a"] = driver_window("(a)", lambda: regression_trial(cfg), log)
        rows = online_metrics(out["log_dir"], "(a)", ONLINE_METRICS)
        steps = spread([1e3 * r["step_time"] for r in rows])
        print(f"phase 10 (a) regression_trial (skillcraft surrogate, linear stem, grid 16^2, {REG_STREAM} steps) "
              f"on {card}: {seconds['a']:.1f} s, step ms {json.dumps(steps)}, test RMSE {out['test_rmse']:.4f}, "
              f"NLL {out['test_nll']:.4f}, launches {json.dumps(windows['a'])}")
        if windows["a"]["rank1_apply"] == 0 or windows["a"]["blocked_cholesky"] == 0:
            raise AssertionError(f"phase 10 (a): K2 and K6 must launch: {windows['a']}")
        check_resume(cfg, out, "(a)", card, log)
        t0 = time.perf_counter()
        stream_twin(dev, card, log)
        seconds["a twin"] = time.perf_counter() - t0

        # (b) the fused stream
        cfg = driver_cfg(FUSED_ARGS, "fused", dev)
        out, windows["b"], seconds["b"] = driver_window("(b)", lambda: regression_trial(cfg), log)
        rows = online_metrics(out["log_dir"], "(b)", ONLINE_METRICS + ["points_per_sec"])
        pps = [r["points_per_sec"] for r in rows]
        print(f"phase 10 (b) regression_trial stream_mode=fused (segments of 512) on {card}: {seconds['b']:.1f} s, "
              f"points/s {json.dumps(pps)}, test RMSE {out['test_rmse']:.4f}, launches {json.dumps(windows['b'])}")
        if windows["b"]["pred_chunk"] == 0 or len(rows) != 2:
            raise AssertionError(f"phase 10 (b): K3 never launched, or {len(rows)} segments: {windows['b']}")
        fused = check_resume(cfg, out, "(b)", card, log)
        t0 = time.perf_counter()
        kernels = check_kernels_drv(fused, cfg, peaks, card, log)
        seconds["kernels"] = time.perf_counter() - t0

        # (c) the classification driver
        cfg = driver_cfg(CLS_DRIVER_ARGS, "classification", dev)
        out, windows["c"], seconds["c"] = driver_window("(c)", lambda: classification_trial(cfg), log)
        rows = online_metrics(out["log_dir"], "(c)", CLS_ONLINE_METRICS)
        steps = spread([1e3 * r["step_time"] for r in rows])
        print(f"phase 10 (c) classification_trial (wiski_gpd, banana, eye stem, 200 steps) on {card}: "
              f"{seconds['c']:.1f} s, step ms {json.dumps(steps)}, cumulative acc {rows[-1]['online_acc']:.4f}, "
              f"test acc {out['test_acc']:.4f}, launches {json.dumps(windows['c'])}")
        if not out["test_acc"] >= CLS_DRIVER_GATE:
            raise AssertionError(f"phase 10 (c): test accuracy {out['test_acc']} < {CLS_DRIVER_GATE}")
        if windows["c"]["rank1_apply"] == 0 or windows["c"]["blocked_cholesky"] == 0:
            raise AssertionError(f"phase 10 (c): K2 and K6 must launch: {windows['c']}")
        check_resume(cfg, out, "(c)", card, log)

        # (d) the fixed-noise driver, both arms
        kw = dict(FIXED_NOISE_KW, log_dir=str(DRIVER_DIR / "fixed_noise"), verbose=False, arm="both", device=dev)
        out, windows["d"], seconds["d"] = driver_window("(d)", lambda: fixed_noise_regression.run(**kw), log)
        arms = {arm: dict(cond_ms=out[arm]["median_cond_ms"], mll_ms=out[arm]["median_mll_ms"],
                          test_rmse=[r["test_rmse"] for r in out[arm]["eval_rows"]]) for arm in ("wiski", "exact")}
        print(f"phase 10 (d) fixed_noise_regression arm=both (malaria field, grid 30, {FIXED_NOISE_KW['num_steps']} "
              f"steps) on {card}: {seconds['d']:.1f} s, {json.dumps(arms)}, cond_speedup {out['cond_speedup']:.3f}, "
              f"mll_speedup {out['mll_speedup']:.3f}, launches {json.dumps(windows['d'])}")
        if not all(math.isfinite(v) for a in arms.values() for v in a["test_rmse"]):
            raise AssertionError(f"phase 10 (d): a non-finite test RMSE: {arms}")
        if windows["d"]["rank1_apply"] == 0 or windows["d"]["blocked_cholesky"] == 0:
            raise AssertionError(f"phase 10 (d): K2 (the WISKI conditions) and K6 (the MLL steps) must launch: "
                                 f"{windows['d']}")

        # (e) the sequential sweep
        args = SWEEP_ARGS + [f"log_dir={DRIVER_DIR / 'sweep'}", f"device={dev}"]
        out, windows["e"], seconds["e"] = driver_window("(e)", lambda: run_sweep(2, "seq", args), log)
        rmse = [r["test_rmse"] for r in out]
        print(f"phase 10 (e) run_sweep(2, seq) (friedman, linear stem) on {card}: {seconds['e']:.1f} s, "
              f"test RMSE {rmse}, launches {json.dumps(windows['e'])}")
        if len(out) != 2 or not all(math.isfinite(v) for v in rmse) or windows["e"]["rank1_apply"] == 0:
            raise AssertionError(f"phase 10 (e): {rmse}, {windows['e']}")
    total = {k: sum(w[k] for w in windows.values()) for k in windows["a"]}
    print(f"phase 10 driver path launches: {json.dumps(total)}")
    print(f"phase 10 seconds on {card}: {json.dumps(seconds)}, all {time.perf_counter() - t_phase:.1f}")
    return kernels, total


# --------------------------------------------------------------------------
# phase 11: the parallel layer
# --------------------------------------------------------------------------

# (a) the regression mesh sweep at the preset's width (skillcraft's flagged
# surrogate, linear stem: 2 features, grid 16^2 = 256), T = 8 trials
MESH_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh"
MESH_TRIALS, MESH_EPOCHS, MESH_STREAM = 8, 20, 256
MESH_REG_ARGS = ["model=wiski_gp_regression", "dataset=skillcraft", "stem=linear", "batch_size=1",
                 f"num_batch_epochs={MESH_EPOCHS}", f"max_stream={MESH_STREAM}"]
# batching: friedman in 2-D, an eye stem (no fit that parts run from run),
# grid 16^2, 64 steps at T = 8 and T = 2, and a CPU twin of the T = 2 run
BATCHING_ARGS = ["model=wiski_gp_regression", "dataset=friedman", "dataset.input_dim=2", "stem=eye",
                 "stem.input_dim=2", "model.grid_size=16", f"num_batch_epochs={MESH_EPOCHS}", "max_stream=64"]
BATCHING_RTOL, MESH_TWIN_RTOL = 1e-4, 1e-3  # of each column's largest magnitude
# (b) the wiski_gpd mesh sweep: 4 trials of 2 classes (Bd = 8)
MESH_CLS_ARGS = ["model=wiski_gpd", "dataset=banana", "stem=eye", "num_batch_epochs=30", "max_stream=200"]
MESH_CLS_TRIALS, MESH_CLS_GATE = 4, 0.7
# (c) the tensor-parallel streams on two gloo ranks sharing the card:
# m -> (grid side, streamed points); phase 3's model, and the 64x64 grid
TP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
TP_RANKS, TP_PREFIX, TP_PRED_TOL = 2, 256, 2e-4
TP_CASES = {900: (M_SIDE, 4096), 4096: (M6_SIDE, 4 * K)}
TP_ROUTES = {900: ("cluster", "cluster"), 4096: ("grid", "wide")}  # m -> K1's and K3's recursion routes
# (d) the expert-parallel LocalGP step: the localgp_regression preset's
# 256 points an expert, 8 experts (4 a rank)
LGP_CAP, LGP_EXPERTS, LGP_TEST, LGP_TOL = 256, 8, 512, 1e-5
STAGE_META = {
    "chunk_gather_rows": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
    "chunk_factors": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
    "chunk_apply_rows": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
    "pred_gather_rows": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
    "pred_factors": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
    "pred_apply_rows": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
}
STAGES = {name: getattr(cuda_root_update if name.startswith("chunk") else cuda_pred_stream, name)
          for name in STAGE_META}


def zero_stage_counters():
    for fn in STAGES.values():
        fn.launches = 0
    cuda_root_update.chunk_factors.cluster_launches = cuda_pred_stream.pred_factors.cluster_launches = 0
    cuda_root_update.chunk_factors.grid_cluster_launches = cuda_pred_stream.pred_factors.wide_cluster_launches = 0


def read_stage_counters():
    out = {name: fn.launches for name, fn in STAGES.items()}
    out["chunk_factors_cluster"] = cuda_root_update.chunk_factors.cluster_launches
    out["pred_factors_cluster"] = cuda_pred_stream.pred_factors.cluster_launches
    out["chunk_factors_grid"] = cuda_root_update.chunk_factors.grid_cluster_launches
    out["pred_factors_wide"] = cuda_pred_stream.pred_factors.wide_cluster_launches
    return out


class KernelShapes:
    """Records the (Bd, m, m) of each K2 call of the trial-batched path and
    of each K6 call of ``spd_cholesky`` while the block runs (the wrappers
    themselves count the launches)."""

    def __enter__(self):
        import online_gp_torch.ops.chol as chol_mod
        import online_gp_torch.parallel.trials as trials_mod

        self.k2, self.k6 = [], []
        self._orig = (trials_mod.rank1_apply, chol_mod.blocked_cholesky_ex)

        def k2(L, B, p):
            self.k2.append(tuple(L.shape))
            return self._orig[0](L, B, p)

        def k6(q, *args, **kw):
            self.k6.append(tuple(q.shape))
            return self._orig[1](q, *args, **kw)

        trials_mod.rank1_apply, chol_mod.blocked_cholesky_ex = k2, k6
        return self

    def __exit__(self, *exc):
        import online_gp_torch.ops.chol as chol_mod
        import online_gp_torch.parallel.trials as trials_mod

        trials_mod.rank1_apply, chol_mod.blocked_cholesky_ex = self._orig


def mesh_window(what, trials, args, log, device="cuda"):
    """run_sweep(trials, "mesh", args) with the counters zeroed just before
    and read just after; returns (results, launches, seconds, shapes)."""
    zero_counters()
    t0 = time.perf_counter()
    print(f"==== {what}", file=log, flush=True)
    with KernelShapes() as shapes, contextlib.redirect_stdout(log):
        out = run_sweep(trials, "mesh", args + [f"log_dir={MESH_DIR / what}", f"device={device}"])
    torch.cuda.synchronize()
    return out, read_window(), time.perf_counter() - t0, shapes


def mesh_table(log_dir, what, columns, nan_cols, last_cols):
    """A mesh trial's online_metrics: the JAX sweep's schema, ``nan_cols``
    NaN on every row, ``last_cols`` finite on the last row only, every other
    value finite."""
    with open(Path(log_dir) / "online_metrics.csv") as f:
        reader = csv.DictReader(f)
        cols, rows = reader.fieldnames, [{k: float(v) for k, v in r.items()} for r in reader]
    if cols != columns or not rows:
        raise AssertionError(f"phase 11 {what}: online_metrics columns {cols}, {len(rows)} rows")
    for i, r in enumerate(rows):
        for k, v in r.items():
            finite = (k not in nan_cols) and (k not in last_cols or i == len(rows) - 1)
            if math.isfinite(v) != finite:
                raise AssertionError(f"phase 11 {what}: row {i} {k} = {v}")
    return rows


def tables_apart(got, want, what):
    """The largest distance of two runs' online_metrics, column by column
    (step_time aside), over each column's largest magnitude; NaN must stand
    where the other run has NaN."""
    errs = {}
    for col in want[0]:
        if col == "step_time":
            continue
        a, b = np.array([r[col] for r in got]), np.array([r[col] for r in want])
        if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"phase 11 {what}: column {col} parts: {a} against {b}")
        if np.isfinite(b).any():
            errs[col] = float(np.nanmax(np.abs(a - b)) / max(np.nanmax(np.abs(b)), 1e-12))
    return errs


def mesh_sweeps(card, log):
    """(a) and (b); returns their launch windows, seconds and the (a)
    sweep's step times."""
    windows, seconds = {}, {}
    reg_cols = ONLINE_METRICS
    nan_reg, last_reg = ("batch_rmse", "batch_nll", "regret"), ("test_rmse", "test_nll")
    out, windows["a"], seconds["a"], shapes = mesh_window("a", MESH_TRIALS, MESH_REG_ARGS, log)
    rows = [mesh_table(r["log_dir"], "(a)", reg_cols, nan_reg, last_reg) for r in out]
    k6_want = 2 * MESH_STREAM + MESH_EPOCHS + 1  # caches and Q a step, Q an epoch, the held-out caches
    bd = (MESH_TRIALS, 256, 256)
    step_s = rows[0][-1]["step_time"]  # the sweep's wall time over its steps times its trials
    print(f"phase 11 (a) run_sweep({MESH_TRIALS}, mesh) (skillcraft surrogate, linear stem, grid 16^2, "
          f"{MESH_STREAM} steps) on {card}: {seconds['a']:.1f} s ({MESH_TRIALS / seconds['a']:.2f} trials/s), "
          f"step ms {step_s * MESH_TRIALS * 1e3:.3f} for all {MESH_TRIALS} trials ({1.0 / step_s:.1f} trial-steps/s), "
          f"test RMSE "
          f"{[round(r['test_rmse'], 4) for r in out]}, launches {json.dumps(windows['a'])}, "
          f"K2 shapes {sorted(set(shapes.k2))}, K6 shapes {sorted(set(shapes.k6))}")
    if (windows["a"]["rank1_apply"], len(shapes.k2)) != (MESH_STREAM, MESH_STREAM) or set(shapes.k2) != {bd}:
        raise AssertionError(f"phase 11 (a): K2 must launch once a step at {bd}: {windows['a']}, {set(shapes.k2)}")
    if (windows["a"]["blocked_cholesky"], len(shapes.k6)) != (k6_want, k6_want) or set(shapes.k6) != {bd}:
        raise AssertionError(f"phase 11 (a): K6 must factor {k6_want} Q at {bd}: {windows['a']}, {set(shapes.k6)}")

    runs = {}
    for T in (8, 2):
        runs[T], windows[f"a T={T}"], seconds[f"a T={T}"], _ = mesh_window(f"batch{T}", T, BATCHING_ARGS, log)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        twin = run_sweep(2, "mesh", BATCHING_ARGS + [f"log_dir={MESH_DIR / 'twin'}", "device=cpu"])
    seconds["a twin"] = time.perf_counter() - t0
    tab = lambda r: mesh_table(r["log_dir"], "(a) batching", reg_cols, nan_reg, last_reg)
    batching = max(max(tables_apart(tab(runs[8][t]), tab(runs[2][t]), "(a) T=8 vs T=2").values()) for t in (0, 1))
    twin_err = max(max(tables_apart(tab(twin[t]), tab(runs[2][t]), "(a) CPU twin").values()) for t in (0, 1))
    print(f"phase 11 (a) batching (friedman 2-D, eye stem, grid 16^2, 64 steps): trials 0, 1 at T = 8 against "
          f"T = 2 apart by {batching:.3e} of each column's largest value; the CPU twin of T = 2 by {twin_err:.3e}; "
          f"{seconds['a T=8']:.1f} s and {seconds['a T=2']:.1f} s on the card, twin {seconds['a twin']:.1f} s")
    if not batching <= BATCHING_RTOL or not twin_err <= MESH_TWIN_RTOL:
        raise AssertionError(f"phase 11 (a): batching {batching} (<= {BATCHING_RTOL}), twin {twin_err} "
                             f"(<= {MESH_TWIN_RTOL})")

    out, windows["b"], seconds["b"], shapes = mesh_window("b", MESH_CLS_TRIALS, MESH_CLS_ARGS, log)
    crow = [mesh_table(r["log_dir"], "(b)", CLS_ONLINE_METRICS, ("batch_acc", "regret"), ("test_acc",))
            for r in out]
    acc = [r["test_acc"] for r in out]
    print(f"phase 11 (b) run_sweep({MESH_CLS_TRIALS}, mesh) (wiski_gpd, banana, eye stem, 200 steps) on {card}: "
          f"{seconds['b']:.1f} s, step_time {crow[0][-1]['step_time'] * 1e3:.3f} ms a trial-step, test acc {acc}, "
          f"launches {json.dumps(windows['b'])}, K2 shapes {sorted(set(shapes.k2))}")
    if not min(acc) >= MESH_CLS_GATE:
        raise AssertionError(f"phase 11 (b): test accuracy {acc} below {MESH_CLS_GATE}")
    if set(shapes.k2) != {(2 * MESH_CLS_TRIALS, 256, 256)} or windows["b"]["blocked_cholesky"] == 0:
        raise AssertionError(f"phase 11 (b): K2 at Bd = 8 and K6 must launch: {set(shapes.k2)}, {windows['b']}")
    return windows, seconds


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_inputs(m, dev):
    """Phase 3's configuration at m (2-D inputs, RBF, learned second noise,
    N_SEED seed points of sin(3 x0), slim state) with its stream and the
    prediction caches, on the card."""
    side, n = TP_CASES[m]
    rng = np.random.default_rng(SEED + m)
    grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)
    f32 = dict(dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (N_SEED, 2)), **f32)
    state = wiski_slim(wiski_init(model, x0, torch.sin(3 * x0[:, :1]), torch.ones((N_SEED, 1), **f32)))
    xs = torch.tensor(rng.uniform(-1, 1, (n, 2)), **f32)
    ys = torch.sin(3 * xs[:, :1])
    mean_cache, cov_cache = wiski_prediction_caches(model, params, state)
    idx, w = interp_coeffs(grid, xs)
    return model, state, xs, ys, dict(L=state.roots.root[0], B=state.roots.inv_root[0], C=cov_cache[0],
                                      mu=mean_cache[0, :, 0], idx=idx, w=w, y=ys[:, 0], nz=torch.ones_like(ys[:, 0]))


def tp_references(m, dev, card):
    """The single-device runs the ranks are held to: wiski_stream (K1), the
    plain per-point update over the prefix, the K3 stream; saved under
    TP_DIR with the inputs. Returns (path, inputs, single-device rates)."""
    model, state, xs, ys, a = tp_inputs(m, dev)
    ns = torch.ones_like(ys)
    roots0 = RootCache(None, a["L"][None].clone(), a["B"][None].clone())
    sync(dev)
    t0 = time.perf_counter()
    streamed = wiski_stream(model, state._replace(roots=RootCache(None, roots0.root.clone(), roots0.inv_root.clone())),
                            xs, ys, ns, block_size=K)
    sync(dev)
    t1 = time.perf_counter()
    C, mu, pm, pv = pred_stream_blocked(a["C"].clone(), a["mu"].clone(), a["idx"], a["w"], a["y"], a["nz"], block=K)
    sync(dev)
    t2 = time.perf_counter()
    prefix = plain_prefix_roots(model, roots0, xs[:TP_PREFIX], ns[:TP_PREFIX])
    refs = dict(L=streamed.roots.root[0], B=streamed.roots.inv_root[0], L_prefix=prefix.root[0],
                B_prefix=prefix.inv_root[0], C=C, mu=mu, pm=pm, pv=pv)
    TP_DIR.mkdir(parents=True, exist_ok=True)
    path = TP_DIR / f"m{m}.pt"
    torch.save({"inputs": {k: v.cpu() for k, v in a.items()}, "refs": {k: v.cpu() for k, v in refs.items()}}, path)
    n = xs.shape[0]
    rates = dict(stream_updates_per_s=n / (t1 - t0), pred_points_per_s=n / (t2 - t1))
    print(f"  phase 11 (c) single-device m = {m} on {card}: wiski_stream {rates['stream_updates_per_s']:.1f} "
          f"updates/s, K3 stream {rates['pred_points_per_s']:.1f} points/s ({n} points)")
    return str(path), a, rates


def lgp_data():
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1, 1, (LGP_CAP * LGP_EXPERTS, 2)).astype(np.float32)
    return x, np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]), rng.uniform(-1, 1, (LGP_TEST, 2)).astype(np.float32)


def lgp_step(dev, sharded_mesh=None):
    """One localgp_experts_step at the preset's expert size: on the whole
    expert fleet, or with the experts sharded over ``sharded_mesh``."""
    from online_gp_torch.models.localgp import LocalGPModel, localgp_init
    from online_gp_torch.parallel.mesh import localgp_experts_step, replicate, shard_leading
    from online_gp_torch.utils.optim import adam

    model = LocalGPModel(RBFKernel(), max_data_per_model=LGP_CAP, max_experts=LGP_EXPERTS)
    x, y, xt = lgp_data()
    state = localgp_init(model, x, y, device=dev)
    params = model.init_params(2, device=dev)
    optimizer = adam(1e-2)
    opt = optimizer.init(tree_leaves(params))
    xt = torch.from_numpy(xt).to(dev)
    if sharded_mesh is not None:
        state, params, xt = shard_leading(state, sharded_mesh), replicate(params, sharded_mesh), replicate(
            xt, sharded_mesh)
    step = localgp_experts_step(model, optimizer)
    step(params, opt, state, xt)  # a warm-up: the first call's one-time costs are set-up
    sync(dev)
    t0 = time.perf_counter()
    p, _, loss, mean, var = step(params, opt, state, xt)
    sync(dev)
    out = dict(loss=loss.cpu().numpy(), mean=mean.cpu().numpy(), var=var.cpu().numpy(),
               params=[a.cpu().numpy() for a in tree_leaves(p)], seconds=time.perf_counter() - t0)
    if sharded_mesh is not None:
        out["experts"] = int(state.x.to_local().shape[0])
    return out


def _rel_apart(got, want, tol, what):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / (tol + np.abs(np.asarray(want)))))
    if not err <= 1.0:
        raise AssertionError(f"{what}: parts from the one-process run beyond {tol} (allclose ratio {err:.3g})")
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def tp_rank(rank, world, paths, lgp_ref, device_type="cuda"):
    """A gloo rank on the card: (c) both sharded streams at each m against
    the single-device references, the stage counters zeroed just before and
    read just after; (d) the expert-parallel step against the one-process
    run."""
    from online_gp_torch.parallel.mesh import (
        local_device,
        make_mesh,
        sharded_pred_stream_blocked,
        sharded_stream_blocked,
    )

    mesh = make_mesh(axis_name="tp", device_type=device_type)
    dev = local_device(device_type)
    report = {}
    with f32_matmul_precision():
        for m, path in paths.items():
            saved = torch.load(path)
            a = {k: v.to(dev) for k, v in saved["inputs"].items()}
            refs = {k: v.to(dev) for k, v in saved["refs"].items()}
            rows = slice(rank * (m // world), (rank + 1) * (m // world))
            wv = a["w"]  # unit noise
            # a warm-up chunk of each stream (the first collective's and launches' one-time costs)
            sharded_stream_blocked(a["L"], a["B"], a["idx"][:K], wv[:K], mesh, block=K)
            sharded_pred_stream_blocked(a["C"], a["mu"], a["idx"][:K], a["w"][:K], a["y"][:K], a["nz"][:K], mesh,
                                        block=K)
            zero_stage_counters()
            zero_apply_counters()
            sync(dev)
            t0 = time.perf_counter()
            L, B = sharded_stream_blocked(a["L"], a["B"], a["idx"], wv, mesh, block=K)
            sync(dev)
            t1 = time.perf_counter()
            C, mu, pm, pv = sharded_pred_stream_blocked(a["C"], a["mu"], a["idx"], a["w"], a["y"], a["nz"], mesh, block=K)
            sync(dev)
            t2 = time.perf_counter()
            Lp, Bp = sharded_stream_blocked(a["L"], a["B"], a["idx"][:TP_PREFIX], wv[:TP_PREFIX], mesh, block=K)
            sync(dev)
            launches, applies = read_stage_counters(), read_apply_shapes()
            errs = {}
            for name, got, want in (("L", L, refs["L"]), ("B", B, refs["B"]), ("L_prefix", Lp, refs["L_prefix"]),
                                    ("B_prefix", Bp, refs["B_prefix"])):
                want = want[rows]
                scale = max(float(want.abs().max()), 1.0)
                errs[name] = float((got.to_local() - want).abs().max())
                if not errs[name] <= 1e-3 * scale:
                    raise AssertionError(f"rank {rank} m = {m}: {name} parts by {errs[name]:.3e} (scale {scale:.3g})")
            for name, got, want in (("C", C, refs["C"][rows]), ("mu", mu, refs["mu"][rows]), ("pm", pm, refs["pm"]),
                                    ("pv", pv, refs["pv"])):
                errs[name] = max_err((got.to_local(),), (want,), TP_PRED_TOL, f"rank {rank} m = {m} {name}")
            n = a["idx"].shape[0]
            report[m] = dict(errors=errs, launches=launches, applies=applies, stream_updates_per_s=n / (t1 - t0),
                             pred_points_per_s=n / (t2 - t1), rows=L.to_local().shape[0])
        lgp = lgp_step(dev, make_mesh(device_type=device_type))
        errs = {k: _rel_apart(lgp[k], lgp_ref[k], LGP_TOL, f"rank {rank} (d) {k}") for k in ("loss", "mean", "var")}
        errs["params"] = max(_rel_apart(a, b, LGP_TOL, f"rank {rank} (d) params")
                             for a, b in zip(lgp["params"], lgp_ref["params"]))
        report["localgp"] = dict(errors=errs, experts=lgp["experts"], seconds=lgp["seconds"])
    return report


def tp_phase(card, dev):
    """(c) and (d): the references, then the two gloo ranks on the card;
    returns each m's inputs and the summed stage launches by m."""
    inputs, paths, single = {}, {}, {}
    for m in TP_CASES:
        paths[m], inputs[m], single[m] = tp_references(m, dev, card)
    lgp_ref = lgp_step(dev)
    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, TP_RANKS, (paths, lgp_ref), store=str(TP_DIR / "store"))
    spawn_s = time.perf_counter() - t0
    launches = {}
    for m in TP_CASES:
        side, n = TP_CASES[m]
        plans = chunk_cluster_plan(K, m), pred_cluster_plan(K, m, 16)
        cluster = plans[0] is not None, plans[1] is not None
        grid, wide = cluster[0] and plans[0].clusters > 1, cluster[1] and plans[1].cluster == 16
        k1 = -(-n // K) + -(-TP_PREFIX // K)
        want = dict(chunk_gather_rows=k1, chunk_factors=k1, chunk_apply_rows=k1, pred_gather_rows=n // K,
                    pred_factors=n // K, pred_apply_rows=n // K, chunk_factors_cluster=k1 * cluster[0],
                    pred_factors_cluster=(n // K) * cluster[1], chunk_factors_grid=k1 * grid,
                    pred_factors_wide=(n // K) * wide)
        for r, rep in enumerate(ranks):
            got = rep[m]["launches"]
            print(f"phase 11 (c) rank {r} m = {m} (rows {rep[m]['rows']}, {n} points) on {card}: sharded wiski "
                  f"stream {rep[m]['stream_updates_per_s']:.1f} updates/s (single device "
                  f"{single[m]['stream_updates_per_s']:.1f}), sharded K3 stream {rep[m]['pred_points_per_s']:.1f} "
                  f"points/s (single device {single[m]['pred_points_per_s']:.1f}), errors "
                  f"{json.dumps(rep[m]['errors'])}, launches {json.dumps(got)}")
            if got != want:
                raise AssertionError(f"phase 11 (c) rank {r} m = {m}: stage launches {got}, expected {want}")
        launches[m] = {k: sum(rep[m]["launches"][k] for rep in ranks) for k in STAGES}
        for rep in ranks:
            PATH_APPLIES.update(rep[m]["applies"])
    for r, rep in enumerate(ranks):
        lg = rep["localgp"]
        print(f"phase 11 (d) rank {r} localgp_experts_step ({lg['experts']} of {LGP_EXPERTS} experts of {LGP_CAP} "
              f"points) on {card}: {lg['seconds'] * 1e3:.2f} ms (one process {lgp_ref['seconds'] * 1e3:.2f} ms), "
              f"apart from the one-process step by {json.dumps(lg['errors'])}")
        if lg["experts"] != LGP_EXPERTS // TP_RANKS:
            raise AssertionError(f"phase 11 (d): rank {r} holds {lg['experts']} experts")
    print(f"phase 11 (c, d) two gloo ranks on {card}: {spawn_s:.1f} s with their start")
    return inputs, launches


def stage_bound(name, Bd, rows, m, k, P, u, e, peaks):
    """The least time of a stage on a shard of ``rows`` rows: u stencil rows
    and e stencil entries fall in the shard (counted from this run's
    stencil)."""
    if name == "chunk_gather_rows":  # the touched rows of B, the stencil; p0 out
        return bound_ms(4 * (Bd * (u * m + k * m + k * P) + k * P), Bd * 2 * e * m, peaks)
    if name == "chunk_factors":  # p0 in; U, P, R out; 10 t m flops at step t
        return bound_ms(4 * 4 * Bd * k * m, Bd * 5 * k * (k - 1) * m, peaks)
    if name == "chunk_apply_rows":  # the rows of L and B in and out, U, P, R in
        return bound_ms(4 * Bd * (4 * rows * m + 3 * k * m), Bd * 8 * rows * m * k, peaks)
    if name == "pred_gather_rows":
        return bound_ms(4 * (Bd * (u * (m + 1) + k * (m + 1)) + 2 * k * P), Bd * 2 * e * (m + 1), peaks)
    if name == "pred_factors":  # c0w in, Z out; the recursion's k^2 m
        return bound_ms(4 * (Bd * (2 * k * m + 6 * k) + 2 * k * P), Bd * (k * (k - 1) * m + 2 * k * m), peaks)
    return bound_ms(4 * Bd * (2 * rows * (m + 1) + k * m + k), Bd * 2 * rows * (m + 1) * k, peaks)


def check_stage(name, make, tol, peaks, bound, kernels, library, plain_reps):
    """A stage wrapper against its plain version (allclose at ``tol``, the
    absolute part ``tol`` times each output's largest magnitude, at least
    1), then its device time, wrapper time, plain time and yardstick."""
    fn = STAGES[name]
    plain = getattr(cuda_root_update if name.startswith("chunk") else cuda_pred_stream, f"{name}_plain")
    got, want = fn(*make()), plain(*make())
    torch.cuda.synchronize()
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    err = max(max_err((g,), (w,), tol, name, tol * max(float(w.abs().max()), 1.0)) for g, w in zip(got, want))
    ms, stages = device_ms(fn, make, kernels)
    return dict(max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(fn, make),
                plain_ms=time_ms(plain, make, plain_reps),
                library_ms=None if library is None else time_ms(*library), bound_ms=bound[0], bound_by=bound[1])


def check_stages(m, a, peaks, card):
    """The six stages on rank 0's rows of (c)'s inputs at m, one chunk of
    k = K: K1's at phase 2's 1e-5, K3's at 2e-4."""
    rows = m // TP_RANKS
    idx = a["idx"][:K].to(torch.int32).contiguous()
    w = a["w"][:K].contiguous()
    wv = w[None].contiguous()
    k, P = idx.shape
    loc, wl = shard_stencil(idx, w, 0, rows)
    u, e = int(torch.unique(loc[wl != 0]).numel()), int((wl != 0).sum())
    S = torch.zeros((1, k, rows), device=w.device).scatter_add(2, loc[None].expand(1, k, P), wl[None])
    L = a["L"][None, :rows].contiguous()
    B = a["B"][None, :rows].contiguous()
    C = a["C"][None, :rows].contiguous()
    mu = a["mu"][None, :rows].contiguous()
    full_B, full_C, full_mu = a["B"][None].contiguous(), a["C"][None].contiguous(), a["mu"][None].contiguous()
    p0 = cuda_root_update.chunk_gather_rows(B, idx, wv, 0) + cuda_root_update.chunk_gather_rows(
        full_B[:, rows:].contiguous(), idx, wv, rows)
    U, Pm, R = cuda_root_update.chunk_factors(p0)
    c0w, mu0w = (x + z for x, z in zip(cuda_pred_stream.pred_gather_rows(C, mu, idx, w, 0),
                                      cuda_pred_stream.pred_gather_rows(full_C[:, rows:].contiguous(),
                                                                        full_mu[:, rows:].contiguous(), idx, w, rows)))
    y, nz = a["y"][None, :K].contiguous(), a["nz"][None, :K].contiguous()
    Z, r, _, _ = cuda_pred_stream.pred_factors(idx, w, c0w, mu0w, y, nz)
    Zl = Z[..., :rows]
    (k1_plan, k1_kernel), (k3_plan, k3_kernel) = k1_route(K, m, TP_ROUTES[m][0]), k3_route(K, m, P, TP_ROUTES[m][1])
    recursion, pred_rec = recursion_route(k1_plan), recursion_route(k3_plan)
    reps = PLAIN_REPS6 if m > M_SIDE**2 else TIMING_REPS
    bnd = lambda name: stage_bound(name, 1, rows, m, k, P, u, e, peaks)
    cases = {
        "chunk_gather_rows": (lambda: (B, idx, wv, 0), 1e-5, {"chunk_gather_kernel": 1},
                              (lambda B_, *_: torch.bmm(S, B_), lambda: (B,))),
        "chunk_factors": (lambda: (p0,), 1e-5, {k1_kernel: 1}, None),
        "chunk_apply_rows": (lambda: (*clone_all(L, B), U, Pm, R), 1e-5,
                             k1_apply_kernels(K, rows, m),
                             (chunk_library(U, Pm, R), lambda: clone_all(L, B))),
        "pred_gather_rows": (lambda: (C, mu, idx, w, 0), TP_PRED_TOL, {"pred_gather_kernel": 1},
                             (lambda C_, mu_: (torch.bmm(S, C_), torch.bmm(mu_[:, None], S.mT)), lambda: (C, mu))),
        "pred_factors": (lambda: (idx, w, c0w, mu0w, y, nz), TP_PRED_TOL, {k3_kernel: 1}, None),
        "pred_apply_rows": (lambda: (*clone_all(C, mu), Z, r, 0), TP_PRED_TOL, k3_apply_kernels(1, rows, m),
                            (lambda C_, mu_: (C_.baddbmm_(Zl.mT, Z, alpha=-1.0),
                                              mu_.add_(torch.bmm(Zl.mT, r[..., None])[..., 0])),
                             lambda: clone_all(C, mu))),
    }
    out = {}
    for name, (make, tol, kernels, library) in cases.items():
        out[name] = check_stage(name, make, tol, peaks, bnd(name), kernels, library, reps)
        out[name]["route"] = f"rows [0, {rows}) of {m}" + (
            f", {recursion if name.startswith('chunk') else pred_rec}" if "factors" in name else "")
        print(f"{name} tp-m{m}-d{TP_RANKS} on {card}: " + json.dumps(out[name]))
    return out


def check_kernels_sweep(peaks, card, dev):
    """K2 (16 calls) and K6 (Q) at the mesh sweep's shapes (T = 8 trials of
    one output folded, Bd = 8, m = 256): the trial-batched state of (a)'s
    configuration at the start of its stream (its 8 stems at their seeded
    init), against their plain versions at phase 10's tolerances."""
    from online_gp_torch.experiments.sweep import _stack_trial_data, trial_stems
    from online_gp_torch.kernels.base import make_kernel
    from online_gp_torch.parallel.trials import fold, trials_init, trials_params

    cfg = exp_config.parse_config(MESH_REG_ARGS + ["device=cuda"])
    with contextlib.redirect_stdout(io.StringIO()):
        tx, ty, _, _ = _stack_trial_data(cfg, MESH_TRIALS, "multi")
    stems = trial_stems(cfg, range(MESH_TRIALS), dev)
    n0 = max(int(cfg["model"]["init_ratio"] * tx.shape[1]), 2)
    grid = Grid.create([(-1.1, 1.1)] * 2, 16, device=dev)
    model = WiskiModel(make_kernel("rbf"), grid, num_outputs=1, learn_additional_noise=True)
    with torch.no_grad():
        feats = torch.stack([s(torch.from_numpy(tx[t]).to(dev)) for t, s in enumerate(stems)])
        y = torch.from_numpy(ty).to(dev)
        state = trials_init(model, feats[:, :n0], y[:, :n0], torch.ones_like(y[:, :n0]))
    fmodel, fparams, fstate = fold(model, trials_params(model, 2, MESH_TRIALS, device=dev), state)
    L, B = fstate.roots.root.contiguous(), fstate.roots.inv_root.contiguous()
    idx, w = interp_coeffs(grid, feats[0, n0 : n0 + N_K2_6])
    idx, w = idx.to(torch.int32).contiguous(), w.contiguous()
    wv = w[None].expand(MESH_TRIALS, *w.shape).contiguous()
    p = torch.einsum("bp,bpm->bm", wv[:, 0], B[:, idx[0].long()])
    scale = max(float(L.abs().max()), float(B.abs().max()), float((L @ p[..., None]).abs().max()), 1.0)
    rows = {
        "rank1_apply": check_k2(L, B, idx, wv, peaks, "sweep-m256-bd8", atol=1e-5 * scale),
        "blocked_cholesky": check_k6(q_matrix(fmodel, fparams, fstate), peaks, "Q (sweep-m256-bd8)"),
    }
    for kname, r in rows.items():
        print(f"{kname} sweep-m256-bd8 on {card}: " + json.dumps(r))
    return rows


def parallel_phase(peaks, card, dev):
    """Phase 11; returns the kernel rows and the launches of its windows
    (K2 and K6 summed over the sweeps' windows, the stages by m)."""
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    with open(MESH_DIR / "sweep_stdout.log", "w") as log:
        windows, seconds = mesh_sweeps(card, log)
    total = {k: sum(w[k] for w in windows.values()) for k in windows["a"]}
    t0 = time.perf_counter()
    inputs, stage_launches = tp_phase(card, dev)
    seconds["c, d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = {}
    for m, a in inputs.items():
        for name, r in check_stages(m, a, peaks, card).items():
            rows[f"{name}@tp-m{m}-d{TP_RANKS}"] = (r, stage_launches[m][name])
    for kname, r in check_kernels_sweep(peaks, card, dev).items():
        rows[f"{kname}@sweep-m256-bd8"] = (r, total[kname])
    seconds["e"] = time.perf_counter() - t0
    print(f"phase 11 sweep launches: {json.dumps(total)}")
    print(f"phase 11 seconds on {card}: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
          f"all {time.perf_counter() - t_phase:.1f}")
    return rows, total


# --------------------------------------------------------------------------
# phase 12: the slice that finishes the port
# --------------------------------------------------------------------------

# (a) grid-sharded WISKI on two gloo ranks sharing the card: bench.py's
# configuration (30 x 30, m = 900) and a 44 x 44 grid (m = 1,936: divides by
# 2 and 4, under max_cholesky_size), the state whole (the Gram kept)
GS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_gs"
GS_RANKS, GS_SIDES, GS_COND, GS_LR, GS_K2_CALLS = 2, (M_SIDE, 44), 64, 1e-2, 16
GS_MLL_RTOL, GS_GRAD_RTOL, GS_ROOT_TOL, GS_MEAN_RTOL, GS_VAR_RTOL = 1e-5, 1e-4, 1e-5, 1e-5, 1e-4
GS_DCP_M = 44**2  # (e) the state saved with backend="dcp"
# (f) grid-sharded WISKI past max_cholesky_size at bench.py's iterative
# configuration (bench.py:569-600: 64 x 64, m = 4,096, RBF, learned second
# noise, 1,024 seed points, Toeplitz, max_cholesky_size 2,048, 32 probes),
# LOVE and the sampling root at rank 512; the warm-up runs the same calls
# with GSI_WARM's short counts (their one-time costs)
GSI_SIDE, GSI_SEED_POINTS, GSI_COND, GSI_RANK, GSI_PROBE_SEED = M6_SIDE, N_SEED6, 16, 512, 1
GSI_CFG = DEFAULT_CONFIG.replace(max_cholesky_size=2048, use_toeplitz=True, max_root_decomposition_size=GSI_RANK)
GSI_WARM = dict(max_cg_iterations=4, max_root_decomposition_size=8)
GSI_M = GSI_SIDE * GSI_SIDE
# (c) the baseline mesh sweeps at the presets' widths (256 inducing points,
# online_gp_tpu/experiments/config.py:25-50), 8 trials, depth cut to 10
# epochs and 32 steps (SGPR's hyper step and rebase every 8th). A rank runs
# its trials one at a time, so a trial's results do not depend on the split
BASE_SWEEP_TRIALS, BASE_SWEEP_RTOL = 8, 1e-5
BASE_SWEEPS = {
    "svgp_regression": ["model=svgp_regression", "dataset=friedman", "stem=eye", "num_batch_epochs=10",
                        "max_stream=32"],
    "sgpr_regression": ["model=sgpr_regression", "dataset=friedman", "stem=eye", "num_batch_epochs=10",
                        "max_stream=32", "model.rebase_every=8"],
    "svgp_classification": ["model=svgp_classification", "dataset=banana", "stem=eye", "num_batch_epochs=10",
                            "max_stream=32"],
}


def rank1_rows_bound(Bd, rows, m, peaks):
    """K2 on a row shard: the shard's rows of L and B read and written, p
    read; |p|^2, two row-matvecs and two outer products on the rows."""
    return bound_ms(4 * (4 * Bd * rows * m + Bd * m), Bd * (8 * rows * m + 2 * m), peaks)


def gs_hyper_step(model, params, state, cfg, **mll_kw):
    """(a)'s and (f)'s hyper step: -sum(wiski_mll), its gradient, one Adam
    step at GS_LR; returns (loss, gradients, new params)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = -torch.sum(wiski_mll(model, tree_rebuild(params, leaves), state, cfg, **mll_kw))
        grads = torch.autograd.grad(loss, leaves)
    updates, _ = adam_update(grads, adam_init(leaves), GS_LR)
    return loss.detach(), grads, tree_rebuild(params, [p.detach() + u for p, u in zip(leaves, updates)])


def gs_sequence(model, params, state, xc, yc, xt, cfg=DEFAULT_CONFIG):
    """(a)'s calls on one state, whole or row-sharded: a warm-up hyper step
    and caches + predict first (their one-time costs), then with the
    counters zeroed a hyper step (MLL, gradient, Adam), GS_COND single-point
    conditions and caches + predict; returns the outputs (the roots
    gathered), the times, the counters and the state's bytes on this
    process."""
    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows
    from online_gp_torch.parallel.grid import gather_wiski_state

    dev = xc.device
    gs_hyper_step(model, params, state, cfg)
    wiski_predict(model, params, state, xt, cfg)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    nbytes = sum(local(t).nbytes for t in (state.wty, *state.roots))
    zero_counters()
    rank1_apply_rows.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    loss, grads, new_params = gs_hyper_step(model, params, state, cfg)
    sync(dev)
    t1 = time.perf_counter()
    for i in range(GS_COND):
        state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], torch.ones_like(yc[:1]))
    sync(dev)
    t2 = time.perf_counter()
    mean, var = wiski_predict(model, new_params, state, xt, cfg)
    sync(dev)
    t3 = time.perf_counter()
    launches = {**read_window(), "rank1_apply_rows": rank1_apply_rows.launches}
    whole = gather_wiski_state(state)
    out = dict(mll=-loss, grads=list(grads), roots=[whole.roots.root, whole.roots.inv_root, whole.roots.mat, whole.wty],
               mean=mean, var=var)
    times = dict(hyper_ms=(t1 - t0) * 1e3, updates_per_s=GS_COND / (t2 - t1), predict_ms=(t3 - t2) * 1e3)
    return out, times, launches, nbytes, dict(params=new_params, state=state)


def gs_inputs(side, dev, dtype=torch.float32, n_seed=N_SEED, n_cond=GS_COND):
    """(a)'s model, params, seed state and points at ``side`` x ``side``
    (and (f)'s, with its counts)."""
    m = side * side
    rng = np.random.default_rng(SEED + m)
    grid = Grid.create([(-1.1, 1.1)] * 2, side, dtype=dtype, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2, dtype=dtype)
    f = dict(dtype=dtype, device=dev)
    x0 = torch.tensor(rng.uniform(-1, 1, (n_seed, 2)).astype(np.float32), **f)
    state = wiski_init(model, x0, torch.sin(3 * x0[:, :1]), torch.ones((n_seed, 1), **f))
    xc = torch.tensor(rng.uniform(-1, 1, (n_cond, 2)).astype(np.float32), **f)
    xt = torch.tensor(rng.uniform(-1, 1, (N_TEST, 2)).astype(np.float32), **f)
    return model, params, state, xc, torch.sin(3 * xc[:, :1]), xt


def gs_distances(got, want):
    """(a)'s five distances of ``got`` from ``want``: mll relative,
    gradients over each leaf's largest entry, roots over max(1, scale),
    mean and var over their largest magnitude; (f)'s also the sampling
    path's mean and var."""
    rel = lambda a, b: float((a.double().cpu() - b.double().cpu()).abs().max()) / max(float(b.abs().max()), 1e-30)
    out = dict(mll=rel(got["mll"], want["mll"]), grads=max(rel(a, b) for a, b in zip(got["grads"], want["grads"])),
               roots=max(float((a.double().cpu() - b.double().cpu()).abs().max()) / max(float(b.abs().max()), 1.0)
                         for a, b in zip(got["roots"], want["roots"])),
               mean=rel(got["mean"], want["mean"]), var=rel(got["var"], want["var"]))
    for k in ("samples_mean", "samples_var"):
        if k in want:
            out[k] = rel(got[k], want[k])
    return out


def gs_save_inputs(path, side, params, state, xc, yc, xt):
    """A seed state and its points on the host, for the ranks
    (:func:`gs_load_inputs`)."""
    cpu = lambda t: None if t is None else t.detach().cpu()
    torch.save(dict(side=side, state=[cpu(t) for t in (state.wty, state.ydy, *state.roots, state.d_logdet)],
                    num_data=state.num_data, params=[cpu(t) for t in tree_leaves(params)], xc=cpu(xc), yc=cpu(yc),
                    xt=cpu(xt)), path)


def gs_load_inputs(path, mesh, dev):
    """A rank's (model, params, seed state row-sharded over ``tp``, xc, yc,
    xt) from :func:`gs_save_inputs`' file, and the single-device runs'
    outputs saved beside it."""
    from online_gp_torch.models.wiski import WiskiState
    from online_gp_torch.parallel.grid import shard_wiski_state

    saved = torch.load(path)
    refs = torch.load(path.replace(".pt", "_refs.pt"))
    grid = Grid.create([(-1.1, 1.1)] * 2, saved["side"], device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = tree_rebuild(model.init_params(2), [t.to(dev) for t in saved["params"]])
    wty, ydy, mat, root, inv_root, d_logdet = (t.to(dev) for t in saved["state"])
    state = shard_wiski_state(WiskiState(wty, ydy, RootCache(mat, root, inv_root), d_logdet, saved["num_data"]),
                              mesh, "tp")
    return (model, params, state, *(saved[k].to(dev) for k in ("xc", "yc", "xt"))), refs


def gs_reference(side, dev, card):
    """The single-device run (a)'s ranks are held to (closed-form MLL
    gradient and Q on K6, K2), and its float64 twin on the CPU from the same
    inputs; the inputs and both runs' outputs saved under GS_DIR."""
    m = side * side
    model, params, state, xc, yc, xt = gs_inputs(side, dev)
    path = GS_DIR / f"m{m}.pt"
    gs_save_inputs(path, side, params, state, xc, yc, xt)
    cpu = lambda t: None if t is None else t.detach().cpu()
    initial = RootCache(*(t.clone() for t in state.roots))
    # the sharded MLL's gradient runs autograd through the Cholesky of Q:
    # its single-device yardstick is the same (the closed form's is printed)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        autograd_grads = list(torch.autograd.grad(autograd_mll(model, tree_rebuild(params, leaves), state), leaves))
    out, times, launches, nbytes, final = gs_sequence(model, params, state, xc, yc, xt)
    if (launches["rank1_apply"], launches["blocked_cholesky"], launches["rank1_apply_rows"]) != (GS_COND, 2, 0):
        raise AssertionError(f"phase 12 (a) single device m = {m}: K2 must launch {GS_COND} times, K6 twice: "
                             f"{launches}")
    twin = gs_sequence(*gs_inputs(side, "cpu", torch.float64))[0]
    out["grads_autograd"] = autograd_grads
    host = lambda o: {k: [cpu(t) for t in v] if isinstance(v, list) else cpu(v) for k, v in o.items()}
    torch.save(dict(single=host(out), twin=host(twin)), GS_DIR / f"m{m}_refs.pt")
    single = dict(times, state_bytes=nbytes, twin=gs_distances(dict(out, grads=autograd_grads), twin),
                  closed_form_twin=gs_distances(out, twin)["grads"])
    print(f"phase 12 (a) single device m = {m} on {card}: hyper step {times['hyper_ms']:.3f} ms, "
          f"{times['updates_per_s']:.1f} condition updates/s, caches + predict of {N_TEST} "
          f"{times['predict_ms']:.3f} ms, persistent state {nbytes} bytes, float32 apart from its float64 twin "
          f"{json.dumps(single['twin'])} (gradients through autograd; the closed form's "
          f"{single['closed_form_twin']:.3e}), launches {json.dumps(launches)}")
    return str(path), dict(model=model, initial=initial, xc=xc, **final), single, launches


def gsi_sequence(model, params, state, xc, yc, xt, cfg):
    """(f)'s calls on one state, whole or row-sharded: a warm-up of the hyper
    step and the caches + predict at GSI_WARM's short counts, then with the
    counters zeroed one hyper step on the CG/SLQ MLL (probes from a
    generator seeded GSI_PROBE_SEED, Adam), GSI_COND single-point
    conditions, caches + predict under fast_pred_var (LOVE at rank
    GSI_RANK) and predict under fast_pred_samples on those caches (the
    Lanczos root of the covariance cache); returns the outputs (the roots
    gathered), the times, the counters and the state's bytes on this
    process."""
    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows
    from online_gp_torch.parallel.grid import gather_wiski_state

    dev = xc.device
    hyper_step = lambda cfg: gs_hyper_step(model, params, state, cfg,
                                           generator=torch.Generator().manual_seed(GSI_PROBE_SEED))

    def predict(p, cfg):
        with torch.no_grad():
            caches = wiski_prediction_caches(model, p, state, cfg)
            return caches, wiski_predict(model, p, state, xt, cfg, caches=caches)

    cfg_var = cfg.replace(fast_pred_var=True)
    warm = cfg.replace(**GSI_WARM)
    hyper_step(warm)
    predict(params, warm.replace(fast_pred_var=True))
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    nbytes = sum(local(t).nbytes for t in (state.wty, *state.roots))
    zero_counters()
    rank1_apply_rows.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    loss, grads, new_params = hyper_step(cfg)
    sync(dev)
    t1 = time.perf_counter()
    for i in range(GSI_COND):
        state = wiski_condition(model, state, xc[i : i + 1], yc[i : i + 1], torch.ones_like(yc[:1]))
    sync(dev)
    t2 = time.perf_counter()
    caches, (mean, var) = predict(new_params, cfg_var)
    sync(dev)
    t3 = time.perf_counter()
    with torch.no_grad():
        s_mean, s_var = wiski_predict(model, new_params, state, xt, cfg_var.replace(fast_pred_samples=True),
                                      caches=caches)
    sync(dev)
    t4 = time.perf_counter()
    launches = {**read_window(), "rank1_apply_rows": rank1_apply_rows.launches}
    whole = gather_wiski_state(state)
    out = dict(mll=-loss, grads=list(grads), roots=[whole.roots.root, whole.roots.inv_root, whole.roots.mat, whole.wty],
               mean=mean, var=var, samples_mean=s_mean, samples_var=s_var)
    times = dict(hyper_s=t1 - t0, updates_per_s=GSI_COND / (t2 - t1), predict_ms=(t3 - t2) * 1e3,
                 samples_ms=(t4 - t3) * 1e3)
    return out, times, launches, nbytes, dict(params=new_params, state=state)


def gsi_reference(dev, card):
    """(f)'s single-device run (K2, Q on K6) and its float64 twin on the
    CPU from the same inputs; the inputs and both runs' outputs saved under
    GS_DIR."""
    model, params, state, xc, yc, xt = gs_inputs(GSI_SIDE, dev, n_seed=GSI_SEED_POINTS, n_cond=GSI_COND)
    path = GS_DIR / "iterative.pt"
    gs_save_inputs(path, GSI_SIDE, params, state, xc, yc, xt)
    cpu = lambda t: None if t is None else t.detach().cpu()
    initial = RootCache(*(t.clone() for t in state.roots))
    out, times, launches, nbytes, final = gsi_sequence(model, params, state, xc, yc, xt, GSI_CFG)
    if (launches["rank1_apply"], launches["blocked_cholesky"], launches["rank1_apply_rows"]) != (GSI_COND, 1, 0):
        raise AssertionError(f"phase 12 (f) single device m = {GSI_M}: K2 must launch {GSI_COND} times, K6 once: "
                             f"{launches}")
    t0 = time.perf_counter()
    twin = gsi_sequence(*gs_inputs(GSI_SIDE, "cpu", torch.float64, GSI_SEED_POINTS, GSI_COND), GSI_CFG)[0]
    twin_s = time.perf_counter() - t0
    host = lambda o: {k: [cpu(t) for t in v] if isinstance(v, list) else cpu(v) for k, v in o.items()}
    torch.save(dict(single=host(out), twin=host(twin)), GS_DIR / "iterative_refs.pt")
    single = dict(times, state_bytes=nbytes, twin=gs_distances(out, twin))
    print(f"phase 12 (f) single device m = {GSI_M} on {card}: iterative hyper step {times['hyper_s']:.3f} s, "
          f"{times['updates_per_s']:.1f} condition updates/s, caches + predict of {N_TEST} under fast_pred_var "
          f"{times['predict_ms']:.3f} ms, predict under fast_pred_samples {times['samples_ms']:.3f} ms, persistent "
          f"state {nbytes} bytes, float32 apart from its float64 twin {json.dumps(single['twin'])} (the twin "
          f"{twin_s:.1f} s on the CPU), launches {json.dumps(launches)}")
    return str(path), dict(model=model, initial=initial, xc=xc, **final), single, launches


def gs_rank(rank, world, paths, sweep_root, iterative_path=None):
    """A gloo rank on the card: (a) at each m the seed state row-sharded over
    the ranks and :func:`gs_sequence` with ``grid_shard_axis``, its outputs'
    distances from the single-device run and from its float64 twin; (e) at
    GS_DCP_M the conditioned state saved with backend="dcp"; (f) from
    ``iterative_path`` the same for :func:`gsi_sequence`; (c) the baseline
    mesh sweeps with the trials split over the ranks."""
    import torch.distributed as dist

    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows
    from online_gp_torch.parallel.grid import gather_wiski_state
    from online_gp_torch.parallel.mesh import local_device, make_mesh
    from online_gp_torch.utils.checkpoint import save_pytree

    mesh = make_mesh(axis_name="tp", device_type="cuda")
    dev = local_device("cuda")
    report = {}
    with f32_matmul_precision():
        dist.all_reduce(torch.zeros(1, device=dev))  # the first collective's set-up
        for m, path in paths.items():
            inputs, refs = gs_load_inputs(path, mesh, dev)
            out, times, launches, nbytes, final = gs_sequence(*inputs, SolverConfig(grid_shard_axis="tp"))
            apart = gs_distances(out, dict(refs["single"], grads=refs["single"]["grads_autograd"]))
            apart["grads_closed_form"] = gs_distances(out, refs["single"])["grads"]
            report[m] = dict(single=apart, twin=gs_distances(out, refs["twin"]),
                             launches=launches, state_bytes=nbytes, rows=tuple(final["state"].roots.root.to_local().shape),
                             **times)
            if m == GS_DCP_M:
                sync(dev)
                t0 = time.perf_counter()
                save_pytree(str(GS_DIR / "state_dcp"), final["state"], backend="dcp")
                report[m]["dcp_save_ms"] = (time.perf_counter() - t0) * 1e3
                whole = gather_wiski_state(final["state"])
                if rank == 0:
                    torch.save([whole.wty.cpu(), whole.ydy.cpu(), *(t.cpu() for t in whole.roots),
                                whole.d_logdet.cpu(), whole.num_data], GS_DIR / "state_gathered.pt")
                del whole
            del inputs, final, out
        if iterative_path is not None:
            report["iterative"] = gsi_rank(mesh, dev, iterative_path)
        report["sweeps"] = {}
        for name, args in BASE_SWEEPS.items():
            zero_counters()
            rank1_apply_rows.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = run_sweep(BASE_SWEEP_TRIALS, "mesh", args + [f"log_dir={sweep_root / 'ranks' / name}",
                                                                  "device=cuda"])
            sync(dev)
            counts = {**read_counters(), "rank1_apply_rows": rank1_apply_rows.launches}
            report["sweeps"][name] = dict(results=out, seconds=time.perf_counter() - t0, launches=counts)
    return report


def gsi_rank(mesh, dev, path):
    """(f) on a rank: the saved seed state row-sharded and
    :func:`gsi_sequence` with ``grid_shard_axis``, its outputs' distances
    from the single-device run and from its float64 twin."""
    inputs, refs = gs_load_inputs(path, mesh, dev)
    out, times, launches, nbytes, final = gsi_sequence(*inputs, GSI_CFG.replace(grid_shard_axis="tp"))
    return dict(single=gs_distances(out, refs["single"]), twin=gs_distances(out, refs["twin"]), launches=launches,
                state_bytes=nbytes, rows=tuple(final["state"].roots.root.to_local().shape), **times)


def check_k2_rows(L, B, idx, w, rows, peaks, what):
    """K2's row-shard entry on the first ``rows`` rows of (L, B) against
    rank1_apply_rows_plain, one call a stencil point (p = B^T v from the
    whole inverse root), to 1e-5 (allclose, the absolute part 1e-5 times
    the roots' and the update's scale, at least 1: the seed state's inverse
    root reaches 1/sqrt(jitter), as phases 9 to 11 rule); then device time,
    bound and yardstick (mv + addr_ on the shard) on the first point."""
    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows, rank1_apply_rows_plain

    Lr, Br = L[:, :rows].contiguous(), B[:, :rows].contiguous()
    ps = [torch.einsum("p,bpm->bm", w[i], B[:, idx[i].long()]).contiguous() for i in range(idx.shape[0])]
    scale = max(float(L.abs().max()), float(B.abs().max()), max(float((L @ p[..., None]).abs().max()) for p in ps),
                 1.0)
    err = 0.0
    for i, p in enumerate(ps):
        got = rank1_apply_rows(*clone_all(Lr, Br), p)
        want = rank1_apply_rows_plain(*clone_all(Lr, Br), p)
        torch.cuda.synchronize()
        err = max(err, max_err(got, want, 1e-5, f"rank1_apply_rows {what} call {i}", 1e-5 * scale))
    make = lambda: (*clone_all(Lr, Br), ps[0])
    bms, by = rank1_rows_bound(L.shape[0], rows, L.shape[-1], peaks)
    ms, stages = device_ms(rank1_apply_rows, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1})
    return dict(calls=len(ps), rows=rows, scale=scale, max_abs_err=err, ms=ms, stages_ms=stages,
                wrapper_ms=time_ms(rank1_apply_rows, make), plain_ms=time_ms(rank1_apply_rows_plain, make),
                library_ms=time_ms(rank1_library, make), bound_ms=bms, bound_by=by)


def check_k2_rows_at_m(state):
    """K2 at rows = m through both entries on phase 3's final roots: bitwise
    the same (one kernel), and against the plain version to 1e-5."""
    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows

    L, B = state.roots.root.contiguous(), state.roots.inv_root.contiguous()
    p = (B[:, 7] * 0.3 + B[:, 400] * 0.7).contiguous()
    whole = rank1_apply(*clone_all(L, B), p)
    rows = rank1_apply_rows(*clone_all(L, B), p)
    torch.cuda.synchronize()
    bitwise(whole, rows, "rank1_apply against rank1_apply_rows at rows = m")
    return max_err(whole, rank1_apply_plain(L, B, p), 1e-5, "rank1_apply at rows = m")


def baseline_sweeps(card, root):
    """(c) in this process: each baseline sweep at T = BASE_SWEEP_TRIALS, the
    counters zeroed just before and read just after (every one must stay
    0: the baselines run no kernel)."""
    from online_gp_torch.ops.cuda_root_update import rank1_apply_rows

    out = {}
    for name, args in BASE_SWEEPS.items():
        zero_counters()
        rank1_apply_rows.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = run_sweep(BASE_SWEEP_TRIALS, "mesh", args + [f"log_dir={root / 'one' / name}", "device=cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {**read_counters(), "rank1_apply_rows": rank1_apply_rows.launches}
        if any(counts.values()):
            raise AssertionError(f"phase 12 (c) {name}: the baseline sweep launched kernels: {counts}")
        out[name] = dict(results=res, seconds=seconds)
    return out


def _sweep_rows(results):
    rows = []
    for r in results:
        with open(Path(r["log_dir"]) / "online_metrics.csv") as f:
            rows.append([{k: float(v) for k, v in row.items()} for row in csv.DictReader(f)])
    return rows


def finishing_phase(peaks, card, dev, phase3_state):
    """Phase 12; returns the kernel rows, the launches of its windows and
    the seconds of its parts."""
    from online_gp_torch.parallel.dryrun import dryrun_multichip
    from online_gp_torch.utils.checkpoint import load_pytree

    t_phase = time.perf_counter()
    shutil.rmtree(GS_DIR, ignore_errors=True)
    GS_DIR.mkdir(parents=True)
    seconds, launches = {}, {"rank1_apply": 0, "blocked_cholesky": 0}
    paths, inputs, single = {}, {}, {}
    t0 = time.perf_counter()
    for side in GS_SIDES:
        m = side * side
        paths[m], inputs[m], single[m], counts = gs_reference(side, dev, card)
        for k in launches:
            launches[k] += counts[k]
    one = baseline_sweeps(card, GS_DIR / "sweeps")
    seconds["a, c single"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gsi_path, inputs[GSI_M], gsi_single, counts = gsi_reference(dev, card)
    for k in launches:
        launches[k] += counts[k]
    seconds["f single and twin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn_ranks(gs_rank, GS_RANKS, (paths, GS_DIR / "sweeps", gsi_path), store=str(GS_DIR / "store"))
    seconds["a, c, e, f ranks"] = time.perf_counter() - t0

    gs_launches = {}
    bars = dict(mll=GS_MLL_RTOL, grads=GS_GRAD_RTOL, roots=GS_ROOT_TOL, mean=GS_MEAN_RTOL, var=GS_VAR_RTOL)
    for m in paths:
        # a distance passes at its bar, or where float32 cannot resolve the
        # bar, at twice the single device's own distance from its float64 twin
        allowed = {k: max(v, 2 * single[m]["twin"][k]) for k, v in bars.items()}
        for r, rep in enumerate(ranks):
            got = rep[m]["launches"]
            print(f"phase 12 (a) rank {r} m = {m} (rows {rep[m]['rows']}) on {card}: hyper step "
                  f"{rep[m]['hyper_ms']:.3f} ms (single device {single[m]['hyper_ms']:.3f}), "
                  f"{rep[m]['updates_per_s']:.1f} condition updates/s (single device "
                  f"{single[m]['updates_per_s']:.1f}), caches + predict {rep[m]['predict_ms']:.3f} ms (single device "
                  f"{single[m]['predict_ms']:.3f}), persistent state {rep[m]['state_bytes']} bytes (single device "
                  f"{single[m]['state_bytes']}), apart from the single device {json.dumps(rep[m]['single'])}, from "
                  f"the float64 twin {json.dumps(rep[m]['twin'])}, launches {json.dumps(got)}")
            if (got["rank1_apply_rows"], got["blocked_cholesky"], got["rank1_apply"]) != (GS_COND, 1, 0):
                raise AssertionError(f"phase 12 (a) rank {r} m = {m}: K2's row-shard entry must launch {GS_COND} "
                                     f"times, K6 once (the caches' Q), K2 never: {got}")
            over = {k: v for k, v in rep[m]["single"].items() if k in allowed and not v <= allowed[k]}
            if over:
                raise AssertionError(f"phase 12 (a) rank {r} m = {m}: apart from the single device beyond "
                                     f"{allowed}: {over}")
            if rep[m]["state_bytes"] * GS_RANKS != single[m]["state_bytes"]:
                raise AssertionError(f"phase 12 (a) rank {r} m = {m}: {rep[m]['state_bytes']} bytes of state, "
                                     f"not 1/{GS_RANKS} of {single[m]['state_bytes']}")
        gs_launches[m] = {k: sum(rep[m]["launches"][k] for rep in ranks) for k in ("rank1_apply_rows",
                                                                                   "blocked_cholesky")}

    allowed = {k: max(v, 2 * gsi_single["twin"][k]) for k, v in dict(
        bars, samples_mean=GS_MEAN_RTOL, samples_var=GS_VAR_RTOL).items()}
    for r, rep in enumerate(ranks):
        it = rep["iterative"]
        got = it["launches"]
        print(f"phase 12 (f) rank {r} m = {GSI_M} (rows {it['rows']}) on {card}: iterative hyper step "
              f"{it['hyper_s']:.3f} s (single device {gsi_single['hyper_s']:.3f}), {it['updates_per_s']:.1f} "
              f"condition updates/s (single device {gsi_single['updates_per_s']:.1f}), caches + predict under "
              f"fast_pred_var {it['predict_ms']:.3f} ms (single device {gsi_single['predict_ms']:.3f}), predict "
              f"under fast_pred_samples {it['samples_ms']:.3f} ms (single device {gsi_single['samples_ms']:.3f}), "
              f"persistent state {it['state_bytes']} bytes (single device {gsi_single['state_bytes']}), apart from "
              f"the single device {json.dumps(it['single'])}, from the float64 twin {json.dumps(it['twin'])}, "
              f"launches {json.dumps(got)}")
        if (got["rank1_apply_rows"], got["blocked_cholesky"], got["rank1_apply"]) != (GSI_COND, 1, 0):
            raise AssertionError(f"phase 12 (f) rank {r}: K2's row-shard entry must launch {GSI_COND} times, K6 once "
                                 f"(the caches' Q), K2 never: {got}")
        over = {k: v for k, v in it["single"].items() if not v <= allowed[k]}
        if over:
            raise AssertionError(f"phase 12 (f) rank {r}: apart from the single device beyond {allowed}: {over}")
        if it["state_bytes"] * GS_RANKS != gsi_single["state_bytes"]:
            raise AssertionError(f"phase 12 (f) rank {r}: {it['state_bytes']} bytes of state, not 1/{GS_RANKS} of "
                                 f"{gsi_single['state_bytes']}")
    gs_launches[GSI_M] = {k: sum(rep["iterative"]["launches"][k] for rep in ranks) for k in ("rank1_apply_rows",
                                                                                             "blocked_cholesky")}

    for name, res in one.items():
        want = _sweep_rows(res["results"])
        for r, rep in enumerate(ranks):
            sw = rep["sweeps"][name]
            if any(sw["launches"].values()):
                raise AssertionError(f"phase 12 (c) rank {r} {name}: the baseline sweep launched kernels: "
                                     f"{sw['launches']}")
        got = _sweep_rows(ranks[0]["sweeps"][name]["results"])
        apart = max(max(tables_apart(g, w, f"(c) {name}").values()) for g, w in zip(got, want))
        step_s = want[0][-1]["step_time"]
        tests = [round(v, 4) for r in res["results"] for k, v in r.items() if k.startswith("test_") and k != "test_nll"]
        print(f"phase 12 (c) run_sweep({BASE_SWEEP_TRIALS}, mesh) {name} (256 inducing points, 32 steps) on {card}: "
              f"{res['seconds']:.1f} s in one process, {1.0 / step_s:.1f} trial-steps/s; on {GS_RANKS} ranks "
              f"{[round(rep['sweeps'][name]['seconds'], 1) for rep in ranks]} s; per-trial results apart by "
              f"{apart:.3e}; test metric {tests}")
        if not apart <= BASE_SWEEP_RTOL:
            raise AssertionError(f"phase 12 (c) {name}: the ranks' trials part from the one-process run by {apart}")

    t0 = time.perf_counter()
    loaded = load_pytree(str(GS_DIR / "state_dcp"), device=dev)
    sync(dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    gathered = torch.load(GS_DIR / "state_gathered.pt")
    got = [loaded.wty, loaded.ydy, *loaded.roots, loaded.d_logdet]
    if loaded.num_data != gathered[-1] or not all(torch.equal(g.cpu(), w) for g, w in zip(got, gathered[:-1])):
        raise AssertionError("phase 12 (e): the dcp checkpoint of the sharded state does not load bitwise whole")
    print(f"phase 12 (e) m = {GS_DCP_M} state saved with backend=dcp from {GS_RANKS} ranks "
          f"({[round(rep[GS_DCP_M]['dcp_save_ms'], 2) for rep in ranks]} ms) and loaded whole in one process "
          f"({load_ms:.2f} ms), bitwise the gathered state")

    t0 = time.perf_counter()
    rows = {}
    for m, a in inputs.items():
        L, B = a["initial"].root, a["initial"].inv_root
        idx, w = interp_coeffs(a["model"].grid, a["xc"][:GS_K2_CALLS])
        r = check_k2_rows(L, B, idx, w, m // GS_RANKS, peaks, f"gs-m{m}-d{GS_RANKS}")
        print(f"rank1_apply_rows gs-m{m}-d{GS_RANKS} on {card}: " + json.dumps(r))
        rows[f"rank1_apply_rows@gs-m{m}-d{GS_RANKS}"] = (r, gs_launches[m]["rank1_apply_rows"])
        Q = q_matrix(a["model"], a["params"], a["state"])
        r = check_k6(Q, peaks, f"Q (gs-m{m}-d{GS_RANKS})", PLAIN_REPS6)
        print(f"blocked_cholesky gs-m{m}-d{GS_RANKS} on {card}: " + json.dumps(r))
        rows[f"blocked_cholesky@gs-m{m}-d{GS_RANKS}"] = (r, gs_launches[m]["blocked_cholesky"])
    err = check_k2_rows_at_m(phase3_state)
    print(f"phase 12 (b) rank1_apply and rank1_apply_rows at rows = m on phase 3's roots: bitwise equal, "
          f"{err:.3e} from the plain version")
    seconds["b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    errors = dryrun_multichip(GS_RANKS, "cuda", store=str(GS_DIR / "dryrun_store"))
    seconds["d"] = time.perf_counter() - t0
    print(f"phase 12 (d) dryrun_multichip({GS_RANKS}) on {card}: {json.dumps(errors)}")
    print(f"phase 12 seconds on {card}: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
          f"all {time.perf_counter() - t_phase:.1f}")
    return rows, launches


# --------------------------------------------------------------------------
# phase 13: K1's and K3's applies
# --------------------------------------------------------------------------

APPLY_SIDES = (16, M_SIDE, 64)  # m = 256, 900 (the main path's) and 4,096 (phase 6's)
APPLY_SUB_K, APPLY_LARGE_K = SUB, 1024  # K5 sub's per-sub-block rank; a rank chunk_apply_plan sends to the tiled kernels
APPLY_STREAM, APPLY_PREQ = 8 * K, 4 * K  # the main-path window: chunks of wiski_stream and of the prequential stream
APPLY_K1_TOL, APPLY_K3_TOL = 1e-5, 2e-4  # K1: of max(scale, 1); K3: allclose, as phase 2
APPLY_META = {
    "chunk_apply": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
    "pred_apply": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
}


def apply_inputs(rng, side, Bd, dev):
    """Roots (L, B) and caches (C = B B^T, mu) of Bd outputs on a side^2
    grid, and the factors of one chunk of K stencil points from the plain
    recursions: (L, B, U, Pm, R, C, mu, Z, r)."""
    grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
    m = grid.num_points
    L, B = synthetic_roots(rng, Bd, m, dev)
    x, idx, w = stencil(rng, grid, K, dev)
    wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
    U, Pm, R = blocked_factors(torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()]))
    C = (B @ B.mT).contiguous()
    mu = torch.tensor(rng.normal(size=(Bd, m)), dtype=torch.float32, device=dev)
    S = stencil_rows(idx, w, m)
    y = (torch.sin(3 * x[:, 0])[None] * torch.tensor([1.0, 0.5][:Bd], device=dev)[:, None]).contiguous()
    Z, r, _, _ = pred_chunk_factors(S, S @ C, mu @ S.mT, y, torch.ones_like(y))
    return L, B, U, Pm, R, C, mu, Z.contiguous(), r.contiguous()


def check_apply(name, make, peaks, Bd, rows, m, k, plain_reps):
    """One apply (``chunk_apply_rows`` or ``pred_apply_rows`` on the rows
    make() gives) against its plain version (K1 within APPLY_K1_TOL of each
    output's largest magnitude, at least 1; K3 allclose at APPLY_K3_TOL),
    bitwise the same on a second call; then device ms, wrapper ms, plain ms,
    the baddbmm yardstick and the bound."""
    k1 = name == "chunk_apply"
    fn, plain = (cuda_root_update.chunk_apply_rows, cuda_root_update.chunk_apply_rows_plain) if k1 else (
        cuda_pred_stream.pred_apply_rows, cuda_pred_stream.pred_apply_rows_plain)
    got, again, want = fn(*make()), fn(*make()), plain(*make())
    torch.cuda.synchronize()
    what = f"{name} (Bd={Bd}, rows={rows}, m={m}, k={k})"
    bitwise(got, again, what)
    if k1:
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(max(float(w.abs().max()) for w in want), 1.0)
        if not (all(torch.isfinite(g).all() for g in got) and err <= APPLY_K1_TOL * scale):
            raise AssertionError(f"{what}: max abs err {err:.3e} exceeds {APPLY_K1_TOL:g} x {scale:.3g}")
    else:
        err = max_err(got, want, APPLY_K3_TOL, what)
    if k1:
        L, B, U, Pm, R = make()
        library = (chunk_library(U, Pm, R), lambda: clone_all(*make()[:2]))
        kernels = k1_apply_kernels(k, rows, m)
    else:
        C, mu, Z, r, row0 = make()
        Zl = Z[..., row0 : row0 + rows]
        library = (lambda C_, mu_: (C_.baddbmm_(Zl.mT, Z, alpha=-1.0), mu_.add_(torch.bmm(Zl.mT, r[..., None])[..., 0])),
                   lambda: clone_all(*make()[:2]))
        kernels = k3_apply_kernels(Bd, rows, m)
    bms, by = stage_bound(f"{name}_rows", Bd, rows, m, k, 0, 0, 0, peaks)
    ms, stages = device_ms(fn, make, kernels)
    return dict(k=k, rows=rows, max_abs_err=err, ms=ms, stages_ms=stages, wrapper_ms=time_ms(fn, make),
                plain_ms=time_ms(plain, make, plain_reps), library_ms=time_ms(*library), bound_ms=bms, bound_by=by)


def apply_main_path(model, params, phase3_state, dev):
    """The main path's window at m = 900: wiski_stream of APPLY_STREAM points
    and the prequential stream of APPLY_PREQ on copies of phase 3's final
    state, each chunk ending in an apply; returns the counters read just
    after, zeroed just before."""
    rng = np.random.default_rng(SEED + 13)
    f32 = dict(dtype=torch.float32, device=dev)
    state = phase3_state._replace(roots=RootCache(None, phase3_state.roots.root.clone(),
                                                  phase3_state.roots.inv_root.clone()))
    caches = wiski_prediction_caches(model, params, state)
    x = torch.tensor(rng.uniform(-1, 1, (APPLY_STREAM + APPLY_PREQ, 2)), **f32)
    y = torch.sin(3 * x[:, :1])
    n = torch.ones_like(y)
    torch.cuda.synchronize()
    zero_counters()
    state = wiski_stream(model, state, x[:APPLY_STREAM], y[:APPLY_STREAM], n[:APPLY_STREAM], block_size=K)
    wiski_prequential_stream(model, params, state, caches, x[APPLY_STREAM:], y[APPLY_STREAM:], n[APPLY_STREAM:],
                             block_size=K)
    torch.cuda.synchronize()
    return {**read_window(), **read_apply_counters()}


def apply_phase(peaks, card, dev, model, params, phase3_state):
    """Phase 13; returns the kernel rows of the shapes that a path window
    of phases 3-13 ran, with those windows' launches (PATH_APPLIES), and
    the main-path launches. A shape that only this phase's checks run is
    printed and left out of the rows."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    main = apply_main_path(model, params, phase3_state, dev)
    want = {"blocked_chunk": APPLY_STREAM // K + APPLY_PREQ // K, "pred_chunk": APPLY_PREQ // K}
    print(f"phase 13 main path (wiski_stream {APPLY_STREAM} points, prequential {APPLY_PREQ}, m = {M_SIDE**2}) on "
          f"{card}: launches {json.dumps(main)}")
    if (main["blocked_chunk"], main["pred_chunk"], main["chunk_apply_cluster"], main["chunk_apply_tiled"],
            main["pred_apply"]) != (want["blocked_chunk"], want["pred_chunk"], want["blocked_chunk"], 0,
                                    want["pred_chunk"]):
        raise AssertionError(f"phase 13: every chunk of the main path must end in the cluster apply (K1) and K3's "
                             f"apply: {main}, expected {want}")
    rows = {}
    for side in APPLY_SIDES:
        m = side * side
        for Bd in (1, 2):
            L, B, U, Pm, R, C, mu, Z, r = apply_inputs(rng, side, Bd, dev)
            factors = {K: (U, Pm, R)}
            if side == M_SIDE and Bd == 1:
                factors[APPLY_SUB_K] = tuple(f[:, :APPLY_SUB_K].contiguous() for f in (U, Pm, R))
                _, idx, w = stencil(rng, Grid.create([(-1.1, 1.1)] * 2, side, device=dev), APPLY_LARGE_K, dev)
                factors[APPLY_LARGE_K] = blocked_factors(torch.einsum("kp,bkpm->bkm", w, B[:, idx.long()]))
            for n_rows in (m, m // 2):
                Lr, Br, Cr, mur = (t[:, :n_rows].contiguous() for t in (L, B, C, mu))
                reps = PLAIN_REPS6 if m > M_SIDE**2 else TIMING_REPS
                for k, (Uk, Pk, Rk) in factors.items():
                    if k != K and n_rows != m:
                        continue
                    make = lambda Uk=Uk, Pk=Pk, Rk=Rk: (*clone_all(Lr, Br), Uk, Pk, Rk)
                    zero_apply_counters()
                    cuda_root_update.chunk_apply_rows(*make())
                    torch.cuda.synchronize()
                    count = read_apply_counters()
                    plan = chunk_apply_plan(k, n_rows, m)
                    cluster = plan is not None
                    launched = count["chunk_apply_cluster" if cluster else "chunk_apply_tiled"]
                    if launched != 1:
                        raise AssertionError(f"phase 13: chunk_apply_rows (k={k}, rows={n_rows}, m={m}) launched "
                                             f"{count}; its plan says {'cluster' if cluster else 'tiled'}")
                    res = check_apply("chunk_apply", make, peaks, Bd, n_rows, m, k, reps)
                    res["route"] = (f"cluster, {plan.blocks} blocks of {plan.tile_rows} rows x {plan.cols} columns"
                                    if cluster else "tiled (gemm_tile)")
                    row = f"chunk_apply@m{m}-r{n_rows}-bd{Bd}" + ("" if k == K else f"-k{k}")
                    rows[row] = (res, PATH_APPLIES[("chunk_apply", Bd, n_rows, m, k)])
                    print(f"{row} on {card}: " + json.dumps(res))
                make = lambda: (*clone_all(Cr, mur), Z, r, 0)
                zero_apply_counters()
                cuda_pred_stream.pred_apply_rows(*make())
                torch.cuda.synchronize()
                launched = read_apply_counters()["pred_apply"]
                if launched != 1:
                    raise AssertionError(f"phase 13: pred_apply_rows (rows={n_rows}, m={m}) launched {launched}")
                res = check_apply("pred_apply", make, peaks, Bd, n_rows, m, K, reps)
                plan = k3_apply_plan(Bd, n_rows, m)
                res["route"] = f"{plan.blocks} tiles of {plan.tile_rows} x {plan.tile_cols}"
                row = f"pred_apply@m{m}-r{n_rows}-bd{Bd}"
                rows[row] = (res, PATH_APPLIES[("pred_apply", Bd, n_rows, m, K)])
                print(f"{row} on {card}: " + json.dumps(res))
            del L, B, C, mu, Z, r, factors
            torch.cuda.empty_cache()
    print(f"phase 13 applies of the path windows of phases 3-13 by (name, Bd, rows, m, k): "
          + json.dumps(sorted([*shape, n] for shape, n in PATH_APPLIES.items())))
    for row, (_, count) in rows.items():
        print(f"{row}: {count} launches in the path windows" if count else
              f"{row}: no path window runs this shape; timed above, left out of the kernels line")
    print(f"phase 13 seconds on {card}: {time.perf_counter() - t_phase:.1f}")
    return {row: rc for row, rc in rows.items() if rc[1]}, main


# --------------------------------------------------------------------------
# phase 14: every grid size the JAX package streams
# --------------------------------------------------------------------------

# (a), Bd = 1, m -> the route of K1's recursion (route_name); and Bd = 2 at SPREAD_BD2_M
SPREAD_K1_MS = {4481: "grid", 8192: "grid", 16384: "spread", 32400: "spread", 46656: "spread"}
SPREAD_BD2_M = 16384
SPREAD_K3_MS = {6017: "spread", 16384: "spread", 65536: "spread"}  # (b), m -> K3's route
SPREAD_BIG_SIDE = 216  # (c): m = 46,656, K2 through wiski_condition and K6
SPREAD_K2_CALLS = 16
SPREAD_FUNC_SIDE = 128  # (d): m = 16,384 on the dense core
SPREAD_FUNC_SEED, SPREAD_FUNC_STREAM, SPREAD_FUNC_PREQ = 256, 4096, 1024
SPREAD_SHARD_M = (46656, 65536)  # (e): K1's and K3's row-sharded streams
SPREAD_SHARD_CHUNKS = 8
SPREAD_PLAIN_K1_M, SPREAD_PLAIN_K3_M = 32400, 16384  # whole chunks against the plain chunk up to here
SPREAD_ROWS = 256  # past them, rows held against the plain apply
SPREAD_REPS = 3
ROW_BLOCK = 32  # rows of a seeded block of the synthetic matrices (divides each rank's rows)
SPREAD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_spread"
SPREAD_SEEDS = dict(k1=1400, k3=1500, big=1600, spd=1700, shard_k1=1800, shard_k3=1900)


def seeded_rows(seed, r0, r1, m, dev):
    """Rows [r0, r1) of an (m, m) matrix of standard normals drawn on the
    card ROW_BLOCK rows at a time, block i from a generator seeded with
    (seed, i): a rank draws its own rows alone, the same as the whole
    matrix's."""
    out = torch.empty((r1 - r0, m), device=dev)
    g = torch.Generator(device=dev)
    for i in range(r0 // ROW_BLOCK, -(-r1 // ROW_BLOCK)):
        lo, hi = i * ROW_BLOCK, min((i + 1) * ROW_BLOCK, m)
        g.manual_seed(1_000_003 * seed + i)
        blk = torch.randn((hi - lo, m), generator=g, device=dev)
        a, b = max(lo, r0), min(hi, r1)
        out[a - r0 : b - r0] = blk[a - lo : b - lo]
    return out


def spread_roots(m, seed, dev, r0=0, r1=None):
    """Rows [r0, r1) of synthetic roots L = I + 0.01 N / sqrt(m) and
    B = I + 0.01 N' / sqrt(m), N and N' seeded normals (seeded_rows), made
    on the card: near the identity, so every chunk is well conditioned. B
    is not L^-T: the kernels' arithmetic takes any pair, and a rank draws
    its rows of both alone, without the whole inverse."""
    r1 = m if r1 is None else r1
    out = []
    for s in (seed, seed + 1):
        X = seeded_rows(s, r0, r1, m, dev).mul_(0.01 / math.sqrt(m))
        X.diagonal(offset=r0).add_(1.0)
        out.append(X)
    return out


def spread_gram(m, seed, dev, r0=0, r1=None, scale=1 / 64, shift=0.1):
    """Rows [r0, r1) of scale G G^T + shift I for a seeded G (m, 64), and a
    seeded m-vector's entries [r0, r1): made on the card in row blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((m, 64), generator=g, device=dev)
    v = torch.randn((m,), generator=g, device=dev)
    r1 = m if r1 is None else r1
    out = torch.empty((r1 - r0, m), device=dev)
    for a in range(r0, r1, 4096):
        b = min(a + 4096, r1)
        torch.matmul(G[a:b], G.T, out=out[a - r0 : b - r0])
    out.mul_(scale).diagonal(offset=r0).add_(shift)
    return out, v[r0:r1].contiguous()


def scaled_err(got, want, tol, what):
    """max |got - want| over the pairs; raises unless each pair is within tol
    times its scale, max(max |want|, 1)."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite kernel output")
        scale = max(float(w.abs().max()), 1.0)
        d = float((g - w).abs().max())
        if not d <= tol * scale:
            raise AssertionError(f"{what}: max abs err {d:.3e} beyond {tol:g} of the scale {scale:.4g}")
        worst = max(worst, d)
    return worst


def moved(counts, before):
    return tuple(a - b for a, b in zip(counts, before))


def peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9


def spread_k1(rng, peaks, card, dev):
    """(a): K1 and chunk_factors at k = 128, P = 16 past the cluster
    envelopes. Returns {m: the recursion's row} for the kernels line."""
    recs = {}
    for Bd, m in [(1, m) for m in SPREAD_K1_MS] + [(2, SPREAD_BD2_M)]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        pairs = [spread_roots(m, SPREAD_SEEDS["k1"] + 2 * b, dev) for b in range(Bd)]
        L, B = (torch.stack(x) for x in zip(*pairs))
        del pairs
        idx, w = edge_stencil(rng, K, m, dev)
        wv = (w[None] * torch.tensor([1.0, 1.3][:Bd], device=dev)[:, None, None]).contiguous()
        plan, recursion = k1_route(K, m, SPREAD_K1_MS[m])
        p0 = torch.einsum("bkp,bkpm->bkm", wv, B[:, idx.long()]).contiguous()
        before = k1_counts(cuda_root_update.chunk_factors)
        f1, f2 = cuda_root_update.chunk_factors(p0), cuda_root_update.chunk_factors(p0)
        torch.cuda.synchronize()
        route = moved(k1_counts(cuda_root_update.chunk_factors), before)
        if route != k1_route_counts(plan, 2):
            raise AssertionError(f"chunk_factors m={m} Bd={Bd}: counters moved {route}, its plan {plan}")
        fp = cuda_root_update.chunk_factors_plain(p0)
        rec_err = scaled_err(f1, fp, 1e-5, f"chunk_factors m={m} Bd={Bd}")
        bitwise(f1, f2, f"chunk_factors m={m} Bd={Bd}")
        del f1, f2
        before = k1_counts(blocked_chunk)
        got = blocked_chunk(*clone_all(L, B), idx, wv)
        again = blocked_chunk(*clone_all(L, B), idx, wv)
        torch.cuda.synchronize()
        route = moved(k1_counts(blocked_chunk), before)
        if route != k1_route_counts(plan, 2):
            raise AssertionError(f"blocked_chunk m={m} Bd={Bd}: counters moved {route}, its plan {plan}")
        bitwise(got, again, f"blocked_chunk m={m} Bd={Bd}")
        del again
        held = "whole chunk"
        if m <= SPREAD_PLAIN_K1_M:
            err = scaled_err(got, blocked_chunk_plain(L, B, idx, wv), 1e-5, f"blocked_chunk m={m} Bd={Bd}")
            apply_err = None
        else:  # the plain copy of L and B does not fit beside them: rows at both ends
            rows = torch.cat([torch.arange(SPREAD_ROWS // 2), torch.arange(m - SPREAD_ROWS // 2, m)]).to(dev)
            want = cuda_root_update.chunk_apply_rows_plain(L[:, rows], B[:, rows], *fp)
            err = scaled_err((got[0][:, rows], got[1][:, rows]), want, 1e-5, f"blocked_chunk m={m} rows")
            ga = cuda_root_update.chunk_apply_rows(*clone_all(L[:, rows].contiguous(), B[:, rows].contiguous()), *fp)
            apply_err = scaled_err(ga, want, 1e-5, f"chunk_apply_rows m={m} rows")
            held = f"{SPREAD_ROWS} rows against the plain apply of the plain factors"
        del got
        make = lambda: (*clone_all(L, B), idx, wv)
        bms, by = chunk_bound(Bd, m, K, idx.shape[1], peaks)
        ms, stages = device_ms(blocked_chunk, make, {"chunk_gather_kernel": 1, recursion: 1,
                                                     **k1_apply_kernels(K, m, m)}, SPREAD_REPS)
        rec_ms, _ = device_ms(cuda_root_update.chunk_factors, lambda: (p0,), {recursion: 1}, SPREAD_REPS)
        rbms, rby = bound_ms(4 * 4 * Bd * K * m, Bd * 5 * K * (K - 1) * m, peaks)
        rec = dict(max_abs_err=rec_err, ms=rec_ms, plain_ms=time_ms(blocked_factors, lambda: (p0,), 1),
                   wrapper_ms=time_ms(cuda_root_update.chunk_factors, lambda: (p0,), SPREAD_REPS),
                   bound_ms=rbms, bound_by=rby, library_ms=None, route=recursion_route(plan), kernel=recursion)
        row = dict(Bd=Bd, max_abs_err=err, held=held, apply_rows_err=apply_err, ms=ms, stages_ms=stages,
                   wrapper_ms=time_ms(blocked_chunk, make, SPREAD_REPS),
                   plain_ms=time_ms(blocked_chunk_plain, make, 1) if m <= SPREAD_PLAIN_K1_M else None,
                   library_ms=time_ms(chunk_library(*fp), lambda: clone_all(L, B), SPREAD_REPS),
                   bound_ms=bms, bound_by=by, recursion=rec, counters=dict(zip(
                       ("launches", "cluster_launches", "grid_cluster_launches", "spread_launches"), route)),
                   peak_gb=peak_gb(dev))
        print(f"phase 14 (a) blocked_chunk m={m} Bd={Bd} k={K} on {card}: " + json.dumps(row))
        if Bd == 1:
            recs[m] = rec
        del L, B, p0, fp
    return recs


def spread_k3(rng, peaks, card, dev):
    """(b): K3 and pred_factors at k = 128, P = 16 past the 16-block
    envelope. Returns {m: the recursion's row} for the kernels line."""
    recs = {}
    for m in SPREAD_K3_MS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        C, mu = spread_gram(m, SPREAD_SEEDS["k3"] + m, dev)
        C, mu = C[None], mu[None]
        idx, w = edge_stencil(rng, K, m, dev)
        y = torch.tensor(rng.normal(size=(1, K)), dtype=torch.float32, device=dev)
        nz = torch.ones_like(y)
        plan, recursion = k3_route(K, m, idx.shape[1], SPREAD_K3_MS[m])
        c0w, mu0w = cuda_pred_stream.pred_gather_rows(C, mu, idx, w, 0)
        args = (idx, w, c0w, mu0w, y, nz)
        before = k3_counts(cuda_pred_stream.pred_factors)
        f1, f2 = cuda_pred_stream.pred_factors(*args), cuda_pred_stream.pred_factors(*args)
        torch.cuda.synchronize()
        route = moved(k3_counts(cuda_pred_stream.pred_factors), before)
        if route != k3_route_counts(plan, 2):
            raise AssertionError(f"pred_factors m={m}: counters moved {route}, its plan {plan}")
        fp = cuda_pred_stream.pred_factors_plain(*args)
        rec_err = scaled_err(f1, fp, 2e-4, f"pred_factors m={m}")
        bitwise(f1, f2, f"pred_factors m={m}")
        del f1, f2
        before = k3_counts(pred_chunk)
        got = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        again = pred_chunk(*clone_all(C, mu), idx, w, y, nz)
        torch.cuda.synchronize()
        route = moved(k3_counts(pred_chunk), before)
        if route != k3_route_counts(plan, 2):
            raise AssertionError(f"pred_chunk m={m}: counters moved {route}, its plan {plan}")
        bitwise(got, again, f"pred_chunk m={m}")
        del again
        Zp, rp = fp[0], fp[1]
        held = "whole chunk"
        if m <= SPREAD_PLAIN_K3_M:
            err = scaled_err(got, pred_chunk_stencil_plain(C, mu, idx, w, y, nz), 2e-4, f"pred_chunk m={m}")
            apply_err = None
        else:  # the plain copy of C does not fit beside it: rows at both ends, and the moments
            rows = torch.cat([torch.arange(SPREAD_ROWS // 2), torch.arange(m - SPREAD_ROWS // 2, m)]).to(dev)
            Cr, mur = C[:, rows].contiguous(), mu[:, rows].contiguous()
            want = (Cr - Zp[:, :, rows].mT @ Zp, mur + (Zp[:, :, rows].mT @ rp[..., None])[..., 0])
            err = scaled_err((got[0][:, rows], got[1][:, rows], got[2], got[3]), (*want, fp[2], fp[3]), 2e-4,
                             f"pred_chunk m={m} rows")
            ga = cuda_pred_stream.pred_apply_rows(*clone_all(C[:, : SPREAD_ROWS // 2].contiguous(),
                                                             mu[:, : SPREAD_ROWS // 2].contiguous()), Zp, rp, 0)
            wa = cuda_pred_stream.pred_apply_rows_plain(C[:, : SPREAD_ROWS // 2], mu[:, : SPREAD_ROWS // 2], Zp, rp, 0)
            apply_err = scaled_err(ga, wa, 2e-4, f"pred_apply_rows m={m} rows")
            held = f"{SPREAD_ROWS} rows of C and mu and the moments against the plain factors' apply"
        del got
        make = lambda: (*clone_all(C, mu), idx, w, y, nz)
        bms, by = pred_bound(1, m, K, idx.shape[1], peaks)
        ms, stages = device_ms(pred_chunk, make, {"pred_gather_kernel": 1, recursion: 1,
                                                  **k3_apply_kernels(1, m, m)}, SPREAD_REPS)
        rec_ms, _ = device_ms(cuda_pred_stream.pred_factors, lambda: args, {recursion: 1}, SPREAD_REPS)
        P = idx.shape[1]
        rbms, rby = bound_ms(4 * (2 * K * m + 5 * K) + 8 * K * P, K * (K - 1) * (m + P), peaks)
        rec = dict(max_abs_err=rec_err, ms=rec_ms,
                   plain_ms=time_ms(cuda_pred_stream.pred_factors_plain, lambda: args, 1),
                   wrapper_ms=time_ms(cuda_pred_stream.pred_factors, lambda: args, SPREAD_REPS),
                   bound_ms=rbms, bound_by=rby, library_ms=None, route=recursion_route(plan), kernel=recursion)
        row = dict(max_abs_err=err, held=held, apply_rows_err=apply_err, ms=ms, stages_ms=stages,
                   wrapper_ms=time_ms(pred_chunk, make, SPREAD_REPS),
                   plain_ms=time_ms(pred_chunk_stencil_plain, make, 1) if m <= SPREAD_PLAIN_K3_M else None,
                   library_ms=time_ms(pred_library(Zp, rp), lambda: clone_all(C, mu), SPREAD_REPS),
                   bound_ms=bms, bound_by=by, recursion=rec, counters=dict(zip(
                       ("launches", "cluster_launches", "wide_cluster_launches", "spread_launches"), route)),
                   peak_gb=peak_gb(dev))
        print(f"phase 14 (b) pred_chunk m={m} k={K} on {card}: " + json.dumps(row))
        recs[m] = rec
        del C, mu, c0w, mu0w, args, fp, Zp, rp
    return recs


def spread_big(rng, peaks, card, dev):
    """(c): K2 through wiski_condition (q = 1) and K6 at m = 46,656, each
    output of more than 2^31 elements. Returns the path window's counts."""
    side = SPREAD_BIG_SIDE
    m = side * side
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    grid = Grid.create([(-1.1, 1.1)] * 2, side, device=dev)
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    f32 = dict(dtype=torch.float32, device=dev)
    state = WiskiState(wty=torch.zeros((1, m, 1), **f32), ydy=torch.zeros((1,), **f32),
                       roots=RootCache(None, *(X[None] for X in spread_roots(m, SPREAD_SEEDS["big"], dev))),
                       d_logdet=torch.zeros((1,), **f32), num_data=0)
    x = torch.tensor(rng.uniform(-1, 1, (SPREAD_K2_CALLS, 2)), **f32)
    y, noise = torch.sin(3 * x[:, :1]), torch.full((SPREAD_K2_CALLS, 1), 0.5, **f32)
    zero_counters()
    err = 0.0
    for i in range(SPREAD_K2_CALLS):
        idx, w = interp_coeffs(grid, x[i : i + 1], detach=True)
        with f32_matmul_precision():
            p = torch.einsum("p,bpm->bm", w[0], state.roots.inv_root[:, idx[0], :]) / math.sqrt(0.5)
        want = rank1_apply_plain(state.roots.root, state.roots.inv_root, p)
        state = wiski_condition(model, state, x[i : i + 1], y[i : i + 1], noise[i : i + 1])
        torch.cuda.synchronize()
        err = max(err, scaled_err((state.roots.root, state.roots.inv_root), want, 1e-5,
                                  f"wiski_condition m={m} call {i}"))
        del want
    window = read_window()
    if window["rank1_apply"] != SPREAD_K2_CALLS:
        raise AssertionError(f"phase 14 (c): wiski_condition at m={m} launched K2 {window['rank1_apply']} times")
    del state
    L, B = spread_roots(m, SPREAD_SEEDS["big"], dev)  # the roots again, for the times
    idx, w = interp_coeffs(grid, x[:1], detach=True)
    p = torch.einsum("p,bpm->bm", w[0], B[None][:, idx[0], :]).contiguous()
    make = lambda: (*clone_all(L[None], B[None]), p)
    bms, by = rank1_bound(1, m, peaks)
    ms, stages = device_ms(rank1_apply, make, {"rank1_prepass_kernel": 1, "rank1_rows_kernel": 1}, SPREAD_REPS)
    k2 = dict(calls=SPREAD_K2_CALLS, max_abs_err=err, ms=ms, stages_ms=stages,
              wrapper_ms=time_ms(rank1_apply, make, SPREAD_REPS), plain_ms=time_ms(rank1_apply_plain, make, 1),
              library_ms=time_ms(rank1_library, make, SPREAD_REPS), bound_ms=bms, bound_by=by, peak_gb=peak_gb(dev))
    print(f"phase 14 (c) rank1_apply (wiski_condition, q = 1) m={m} on {card}: " + json.dumps(k2))
    del L, B
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    Q, _ = spread_gram(m, SPREAD_SEEDS["spd"], dev, scale=1.0 / m, shift=1.0)
    Q = Q[None]
    before = blocked_cholesky.launches
    L1, info = blocked_cholesky_ex(Q)
    L2, _ = blocked_cholesky_ex(Q)
    torch.cuda.synchronize()
    if blocked_cholesky.launches - before != 2 or int(info.max()) != 0:
        raise AssertionError(f"phase 14 (c): K6 at m={m} launched {blocked_cholesky.launches - before} "
                             f"times, info {info.tolist()}")
    bitwise((L1,), (L2,), f"blocked_cholesky m={m}")
    del L2
    if not bool((torch.triu(L1[0], 1) == 0).all()):
        raise AssertionError(f"blocked_cholesky m={m}: the strict upper triangle is not 0")
    events = lambda fn: time_ms(fn, lambda: (Q,), 1)
    k6_ms = events(blocked_cholesky)
    lib_ms = events(torch.linalg.cholesky)
    ref = torch.linalg.cholesky(Q)
    rel = rel_max_err(L1, ref)
    del ref, L1
    if not rel <= 5e-4:
        raise AssertionError(f"blocked_cholesky m={m}: relative max error {rel:.3e} against torch.linalg.cholesky")
    bms, by = chol_bound(1, m, peaks)
    k6 = dict(rel_max_err=rel, ms=k6_ms, library_ms=lib_ms, plain_ms=None, bound_ms=bms, bound_by=by,
              timing="CUDA events around one call after two warm-up calls", peak_gb=peak_gb(dev))
    print(f"phase 14 (c) blocked_cholesky m={m} on {card}: " + json.dumps(k6))
    del Q
    return window


def spread_functional(rng, card, dev):
    """(d): the functional path at m = 16,384 on the dense core (a 128 x 128
    grid): wiski_init, wiski_stream, wiski_prediction_caches and
    wiski_prequential_stream, the counters zeroed just before and read just
    after, against the same calls on the plain chunk forms, which
    detach_interp=False runs on the card (the caches once, from the
    kernels' state). Returns the window's counts and its spread launches
    (K1, K3)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    grid = Grid.create([(-1.1, 1.1)] * 2, SPREAD_FUNC_SIDE, device=dev)
    m = grid.num_points
    model = WiskiModel(RBFKernel(), grid, num_outputs=1, learn_additional_noise=True)
    params = model.init_params(2)
    f32 = dict(dtype=torch.float32, device=dev)

    def points(n):
        x = torch.tensor(rng.uniform(-1, 1, (n, 2)), **f32)
        y = torch.sin(3 * x[:, :1])
        return x, y, torch.ones_like(y)

    x0, y0, n0 = points(SPREAD_FUNC_SEED)
    xs, ys, ns = points(SPREAD_FUNC_STREAM)
    xp, yp, npr = points(SPREAD_FUNC_PREQ)
    copy = lambda st: st._replace(roots=RootCache(*(None if t is None else t.clone() for t in st.roots)),
                                  wty=st.wty.clone())
    zero_counters()
    spread0 = (blocked_chunk.spread_launches, pred_chunk.spread_launches)
    t0 = time.perf_counter()
    state0 = wiski_init(model, x0, y0, n0)
    twin_start = copy(state0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = wiski_stream(model, state0, xs, ys, ns, block_size=K)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    streamed = (state.roots.root.clone(), state.roots.inv_root.clone())
    twin_state = copy(state)
    with torch.no_grad():
        caches = wiski_prediction_caches(model, params, state)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    twin_caches = tuple(c.clone() for c in caches)
    state, caches, pm, pv = wiski_prequential_stream(model, params, state, caches, xp, yp, npr, block_size=K)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    window = read_window()
    spread = (blocked_chunk.spread_launches - spread0[0], pred_chunk.spread_launches - spread0[1])
    chunks = -(-SPREAD_FUNC_STREAM // K) + -(-SPREAD_FUNC_PREQ // K)
    if (window["blocked_chunk"], spread[0], window["pred_chunk"], spread[1]) != (
            chunks, chunks, SPREAD_FUNC_PREQ // K, SPREAD_FUNC_PREQ // K) or window["blocked_cholesky"] < 1:
        raise AssertionError(f"phase 14 (d): launches {window}, spread {spread}: every K1 and K3 chunk at m={m} "
                             f"must run spread over the card, and K6 factor Q")
    # the twin: the same calls on the plain chunk forms
    twin = wiski_stream(model, twin_start, xs, ys, ns, detach_interp=False, block_size=K)
    errs = dict(stream_roots=scaled_err(streamed, (twin.roots.root, twin.roots.inv_root), 1e-3,
                                        f"wiski_stream m={m}"))
    del twin, streamed
    twin_state, twin_caches, tpm, tpv = wiski_prequential_stream(model, params, twin_state, twin_caches, xp, yp, npr,
                                                                 detach_interp=False, block_size=K)
    errs["prequential_roots"] = scaled_err((state.roots.root, state.roots.inv_root),
                                           (twin_state.roots.root, twin_state.roots.inv_root), 1e-3,
                                           f"wiski_prequential_stream m={m} roots")
    errs["prequential_moments"] = max_err((pm, pv), (tpm, tpv), TP_PRED_TOL, f"wiski_prequential_stream m={m}")
    errs["prequential_caches"] = max_err(caches, twin_caches, TP_PRED_TOL, f"wiski_prequential_stream m={m} caches")
    out = dict(m=m, seconds=dict(init=t1 - t0, stream=t2 - t1, caches=t3 - t2, prequential=t4 - t3),
               stream_updates_per_s=SPREAD_FUNC_STREAM / (t2 - t1), prequential_points_per_s=SPREAD_FUNC_PREQ / (t4 - t3),
               errors=errs, launches=window, spread_launches=dict(blocked_chunk=spread[0], pred_chunk=spread[1]),
               peak_gb=peak_gb(dev))
    print(f"phase 14 (d) functional path m={m} (wiski_init of {SPREAD_FUNC_SEED}, wiski_stream of "
          f"{SPREAD_FUNC_STREAM}, caches, wiski_prequential_stream of {SPREAD_FUNC_PREQ}) on {card}: " + json.dumps(out))
    return window, spread


def sampled_rows(m):
    """Rows of an m-row matrix held between the sharded and the single-device
    streams: 32 at each end of each of the two ranks' shards."""
    half = m // 2
    picks = [torch.arange(a, a + 32) for a in (0, half - 32, half, m - 32)]
    return torch.cat(picks)


def spread_references(rng, dev):
    """(e)'s single-device streams, first: K1's at m = 46,656 and K3's at
    m = 65,536, SPREAD_SHARD_CHUNKS chunks of K each, on inputs made on
    the card from seeds the ranks share; sampled rows (sampled_rows), mu and
    the moments kept on the host, in a file the ranks read."""
    SPREAD_DIR.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(SPREAD_DIR / "store", ignore_errors=True)
    n = SPREAD_SHARD_CHUNKS * K
    m1, m3 = SPREAD_SHARD_M
    saved, single = {}, {}
    torch.cuda.empty_cache()
    idx, w = edge_stencil(rng, n, m1, dev)
    L, B = spread_roots(m1, SPREAD_SEEDS["shard_k1"], dev)
    sync(dev)
    t0 = time.perf_counter()
    L, B = roots_stream_blocked(L, B, idx, w, block=K)
    sync(dev)
    single["stream_updates_per_s"] = n / (time.perf_counter() - t0)
    rows = sampled_rows(m1)
    saved.update(k1_idx=idx.cpu(), k1_wv=w.cpu(), k1_rows=rows, k1_L=L[rows.to(dev)].cpu(), k1_B=B[rows.to(dev)].cpu())
    del L, B
    torch.cuda.empty_cache()
    idx3, w3 = edge_stencil(rng, n, m3, dev)
    y = torch.tensor(rng.normal(size=(n,)), dtype=torch.float32, device=dev)
    nz = torch.ones_like(y)
    C, mu = spread_gram(m3, SPREAD_SEEDS["shard_k3"], dev)
    sync(dev)
    t0 = time.perf_counter()
    C, mu, pm, pv = pred_stream_blocked(C, mu, idx3, w3, y, nz, block=K)
    sync(dev)
    single["pred_points_per_s"] = n / (time.perf_counter() - t0)
    rows3 = sampled_rows(m3)
    saved.update(k3_idx=idx3.cpu(), k3_w=w3.cpu(), k3_y=y.cpu(), k3_nz=nz.cpu(), k3_rows=rows3,
                 k3_C=C[rows3.to(dev)].cpu(), k3_mu=mu.cpu(), k3_pm=pm.cpu(), k3_pv=pv.cpu())
    del C, mu
    torch.cuda.empty_cache()
    path = SPREAD_DIR / "refs.pt"
    torch.save(saved, path)
    return path, single


def spread_counts():
    """The stage counters and the recursions' spread counters."""
    out = read_stage_counters()
    out["chunk_factors_spread"] = cuda_root_update.chunk_factors.spread_launches
    out["pred_factors_spread"] = cuda_pred_stream.pred_factors.spread_launches
    return out


def spread_rank(rank, world, path):
    """(e) on one gloo rank sharing the card: its rows of the inputs made
    from the single device's seeds, sharded_stream_blocked (K1, m = 46,656)
    and sharded_pred_stream_blocked (K3, m = 65,536), each with the stage
    counters zeroed just before and read just after, held against the
    single device's sampled rows, mu and moments."""
    from torch.distributed.tensor import DTensor, Shard

    from online_gp_torch.parallel.mesh import (
        local_device,
        make_mesh,
        sharded_pred_stream_blocked,
        sharded_stream_blocked,
    )

    mesh = make_mesh(axis_name="tp", device_type="cuda")
    dev = local_device("cuda")
    saved = torch.load(path)
    put = lambda x: DTensor.from_local(x, mesh, [Shard(0)], run_check=False)
    report = {}
    with f32_matmul_precision():
        m1, m3 = SPREAD_SHARD_M
        rows = m1 // world
        r0 = rank * rows
        L, B = spread_roots(m1, SPREAD_SEEDS["shard_k1"], dev, r0, r0 + rows)
        idx, wv = saved["k1_idx"].to(dev), saved["k1_wv"].to(dev)
        zero_stage_counters()
        zero_apply_counters()
        cuda_root_update.chunk_factors.spread_launches = cuda_pred_stream.pred_factors.spread_launches = 0
        sync(dev)
        t0 = time.perf_counter()
        Ls, Bs = sharded_stream_blocked(put(L), put(B), idx, wv, mesh, block=K)
        sync(dev)
        t1 = time.perf_counter()
        counts1, applies1 = spread_counts(), read_apply_shapes()
        del L, B
        sel = saved["k1_rows"]
        mine = (sel >= r0) & (sel < r0 + rows)
        loc = (sel[mine] - r0).to(dev)
        errs = {}
        for name, got, want in (("L", Ls.to_local()[loc], saved["k1_L"][mine]),
                                ("B", Bs.to_local()[loc], saved["k1_B"][mine])):
            errs[name] = scaled_err((got,), (want.to(dev),), 1e-3, f"rank {rank} sharded K1 {name}")
        del Ls, Bs
        torch.cuda.empty_cache()
        rows3 = m3 // world
        r3 = rank * rows3
        C, mu = spread_gram(m3, SPREAD_SEEDS["shard_k3"], dev, r3, r3 + rows3)
        args = [saved[k].to(dev) for k in ("k3_idx", "k3_w", "k3_y", "k3_nz")]
        zero_stage_counters()
        zero_apply_counters()
        cuda_root_update.chunk_factors.spread_launches = cuda_pred_stream.pred_factors.spread_launches = 0
        sync(dev)
        t2 = time.perf_counter()
        Cs, mus, pm, pv = sharded_pred_stream_blocked(put(C), put(mu), *args, mesh, block=K)
        sync(dev)
        t3 = time.perf_counter()
        counts3, applies3 = spread_counts(), read_apply_shapes()
        del C, mu
        sel = saved["k3_rows"]
        mine = (sel >= r3) & (sel < r3 + rows3)
        loc = (sel[mine] - r3).to(dev)
        errs["C"] = max_err((Cs.to_local()[loc],), (saved["k3_C"][mine].to(dev),), TP_PRED_TOL, f"rank {rank} C")
        for name, got, want in (("mu", mus.to_local(), saved["k3_mu"][r3 : r3 + rows3]), ("pm", pm.to_local(),
                                saved["k3_pm"]), ("pv", pv.to_local(), saved["k3_pv"])):
            errs[name] = max_err((got,), (want.to(dev),), TP_PRED_TOL, f"rank {rank} {name}")
        n = idx.shape[0]
        report = dict(errors=errs, k1_launches=counts1, k3_launches=counts3, applies={**applies1, **applies3},
                      stream_updates_per_s=n / (t1 - t0), pred_points_per_s=n / (t3 - t2), rows=(rows, rows3),
                      peak_gb=peak_gb(dev))
    return report


def spread_sharded(rng, card, dev):
    """(e): the references, then two gloo ranks sharing the card. Returns
    each stage's launches summed over the ranks (K1's recursion's spread
    launches and K3's among them)."""
    path, single = spread_references(rng, dev)
    t0 = time.perf_counter()
    ranks = spawn_ranks(spread_rank, TP_RANKS, (path,), store=str(SPREAD_DIR / "store"))
    spawn_s = time.perf_counter() - t0
    c = SPREAD_SHARD_CHUNKS
    want1 = dict(chunk_gather_rows=c, chunk_factors=c, chunk_apply_rows=c, chunk_factors_spread=c)
    want3 = dict(pred_gather_rows=c, pred_factors=c, pred_apply_rows=c, pred_factors_spread=c)
    for r, rep in enumerate(ranks):
        print(f"phase 14 (e) rank {r} (rows {rep['rows']}) on {card}: sharded K1 stream at m={SPREAD_SHARD_M[0]} "
              f"{rep['stream_updates_per_s']:.1f} updates/s (single device {single['stream_updates_per_s']:.1f}), "
              f"sharded K3 stream at m={SPREAD_SHARD_M[1]} {rep['pred_points_per_s']:.1f} points/s (single device "
              f"{single['pred_points_per_s']:.1f}), errors {json.dumps(rep['errors'])}, launches "
              f"{json.dumps(rep['k1_launches'])} / {json.dumps(rep['k3_launches'])}, peak {rep['peak_gb']:.1f} GB")
        got1 = {k: rep["k1_launches"][k] for k in want1}
        got3 = {k: rep["k3_launches"][k] for k in want3}
        if got1 != want1 or got3 != want3:
            raise AssertionError(f"phase 14 (e) rank {r}: launches {got1}, {got3}; expected {want1}, {want3}")
        PATH_APPLIES.update(rep["applies"])
    print(f"phase 14 (e) two gloo ranks on {card}: {spawn_s:.1f} s with their start")
    return {k: sum(rep["k1_launches"][k] for rep in ranks) for k in want1} | {
        k: sum(rep["k3_launches"][k] for rep in ranks) for k in want3}


def spread_phase(peaks, card, dev):
    """Phase 14; returns the kernel rows of the spread recursions with the
    launches of its path windows ((d) and (e)), and the main-path launches
    of its windows ((c) and (d))."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    rec1 = spread_k1(rng, peaks, card, dev)
    rec3 = spread_k3(rng, peaks, card, dev)
    window_c = spread_big(rng, peaks, card, dev)
    window_d, spread_d = spread_functional(rng, card, dev)
    sharded = spread_sharded(rng, card, dev)
    torch.cuda.empty_cache()
    mf, (m1, m3) = SPREAD_FUNC_SIDE**2, SPREAD_SHARD_M
    rows = {
        f"chunk_recursion_spread@m{mf}": (rec1[mf], spread_d[0]),
        f"pred_recursion_spread@m{mf}": (rec3[mf], spread_d[1]),
        f"chunk_factors@m{m1}-d2": (rec1[m1], sharded["chunk_factors_spread"]),
        f"pred_factors@m{m3}-d2": (rec3[m3], sharded["pred_factors_spread"]),
    }
    for row, (r, count) in rows.items():
        print(f"{row} on {card}: {count} launches in the path windows; " + json.dumps(r))
        if count <= 0:
            raise AssertionError(f"phase 14: no path window launched {row}")
    launches = {k: window_c[k] + window_d[k] for k in window_c}
    print(f"phase 14 seconds on {card}: {time.perf_counter() - t_phase:.1f}")
    return rows, launches


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(smi)
    part, peaks = card_peaks(name)
    print(f"peaks for the bound: {part} ({peaks[0]:.3g} B/s, {peaks[1]:.3g} f32 flop/s)")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")

    with f32_matmul_precision():
        assert_true_f32()
        print("TF32 off for matmuls and convolutions")
        build_s, logs = _build.build_all(verbose=True)
        print(f"kernel build: {build_s:.2f} s")
        for src, log in logs.items():
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  ptxas {src}: {line.strip()}")

        rng = np.random.default_rng(SEED)
        model, params = bench_model(dev)
        grid = model.grid
        card = f"{name} ({smi})"
        results = {"rank1_apply": check_rank1(rng, grid, peaks, dev)}
        results["blocked_chunk"], results["chunk_recursion_cluster"] = check_blocked_chunk(rng, grid, peaks, dev)
        results["pred_chunk"], results["pred_recursion_cluster"] = check_pred_chunk(
            rng, grid, model, params, peaks, dev)
        for kname, by_bd in results.items():
            for Bd, r in by_bd.items():
                case = f"Bd={Bd} m={grid.num_points} k={K}" if isinstance(Bd, int) else f"{Bd} the cluster envelope"
                print(f"{kname} {case} on {card}: " + json.dumps(r))
        profile_condition(rng, model, dev)

        launches, final_state = main_path(rng, model, params, card, dev)

        launches4, Q = remaining_path(rng, model, params, final_state, card, dev)
        for kname, count in launches4.items():
            launches[kname] = launches.get(kname, 0) + count
        results4 = {
            "rank1_update": check_rank1_update(rng, grid, peaks, dev),
            **check_chunk_variants(rng, grid, peaks, dev),
            "blocked_cholesky": check_cholesky(rng, Q, peaks, dev),
        }
        for kname, by_case in results4.items():
            for case, r in by_case.items():
                print(f"{kname} {case if isinstance(case, str) else f'Bd={case}'} m={grid.num_points} on {card}: " + json.dumps(r))
        results.update(results4)

        reg, launches5, (x0, y0), (params5, state5) = training_path(rng, card, dev)
        check_k6_flag(reg.model, params5, state5, card)
        results["hyper_step"] = check_hyper_gradient(reg.model, params5, state5, card)
        time_fit_epochs(reg, x0, y0, card)
        profile_update(reg, rng, card)
        for kname, count in launches5.items():
            launches[kname] += count

        kernels6, launches6, _ = large_grid(rng, peaks, card, dev)
        for kname, count in launches6.items():
            launches[kname] = launches.get(kname, 0) + count

        kernels7, launches7, windows7 = classification(peaks, card, dev)
        for window in windows7:
            for kname, count in window.items():
                launches[kname] += count

        baselines(card, dev)

        kernels9, launches9, windows9 = bayesopt_phase(peaks, card, dev)
        for window in windows9.values():
            for kname, count in window.items():
                launches[kname] += count

        kernels10, launches10 = drivers_phase(peaks, card, dev)
        for kname, count in launches10.items():
            launches[kname] += count

        kernels11, launches11 = parallel_phase(peaks, card, dev)
        for kname, count in launches11.items():
            launches[kname] += count

        kernels12, launches12 = finishing_phase(peaks, card, dev, final_state)
        for kname, count in launches12.items():
            launches[kname] += count

        kernels13, launches13 = apply_phase(peaks, card, dev, model, params, final_state)
        for kname in read_counters():
            launches[kname] += launches13[kname]

        kernels14, launches14 = spread_phase(peaks, card, dev)
        for kname, count in launches14.items():
            launches[kname] += count

    meta = {
        "rank1_apply": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:264"),
        "blocked_chunk": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
        "pred_chunk": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
        "chunk_recursion_cluster": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:608"),
        "pred_recursion_cluster": ("online_gp_torch/csrc/pred_stream.cu", "online_gp_tpu/ops/pallas_pred_stream.py:95"),
        "rank1_update": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:298"),
        "blocked_chunk_sub": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:415"),
        "blocked_chunk_coord": ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:516"),
        "blocked_cholesky": ("online_gp_torch/csrc/chol.cu", "online_gp_tpu/ops/pallas_chol.py:106"),
    }
    kernels = []
    for kname, (source, replaces) in meta.items():
        r = results[kname][1]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    rows = [(f"{kname}@m4096", r, launches6[kname]) for kname, r in kernels6.items()]
    rows += [(row, r, launches7[row]) for row, r in kernels7.items()]
    rows += [(row, r, launches9[row]) for row, r in kernels9.items()]
    rows += [(row, r, launches10[row.split("@")[0]]) for row, r in kernels10.items()]
    rows += [(row, r, count) for row, (r, count) in kernels11.items()]
    rows += [(row, r, count) for row, (r, count) in kernels12.items()]
    rows += [(row, r, count) for row, (r, count) in kernels13.items()]
    rows += [(row, r, count) for row, (r, count) in kernels14.items()]
    meta.update(STAGE_META)
    meta.update(APPLY_META)
    meta["chunk_recursion_grid"] = meta["chunk_recursion_cluster"]
    meta["pred_recursion_wide"] = meta["pred_recursion_cluster"]
    meta["chunk_recursion_spread"] = meta["chunk_recursion_cluster"]
    meta["pred_recursion_spread"] = meta["pred_recursion_cluster"]
    meta["rank1_apply_rows"] = ("online_gp_torch/csrc/root_update.cu", "online_gp_tpu/ops/pallas_root_update.py:264")
    for row, r, count in rows:
        source, replaces = meta[row.split("@")[0]]
        kernels.append({
            "name": row, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
