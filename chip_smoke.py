#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch port (``wiki_grx_gym_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 22 alone, on the worlds of ``NCCL_WORLDS`` named (default every one
the machine's cards hold: one rank a card), after building the libraries
they load; it prints no result line:

    python3 chip_smoke.py --phase22 [WORLD ...]

Phases (any failure exits non-zero and prints no result; no phase's
exception is swallowed; the checks of phases 5-9 are collected and reported
together after phase 9):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the kernels with nvcc into ``build/kernels``, one nvcc per
   library, all started together: K1 (``csrc/decimation.cu``) once for each
   of its programs (``K1_SETS``: the GR1T1 lower limb, the 32-DOF GR1T1
   full body, the lower limb without self-collision pairs, all on the plane
   with the post fold; and without the fold the lower limb on heightfield
   terrain (``local_plane``), on trimesh terrain (``local_plane_walls``) and
   on the plane with heading commands; the lower limb's fold with all 50
   reward terms and 4 penalized contact groups, its fold with the V and
   with the T control law, V with heading commands (no fold), and the
   bench's ``ref_equiv_subset``: viscous friction (tangent stiffness 0,
   K1's ``use_tangent = 0`` branch) without self-collision pairs, the same
   library as the no-pairs program, and the same on trimesh terrain (the
   terrain modes' viscous branch); each with its team shape,
   ``sim/cuda_step.py:team_shape``), K2 (``csrc/ppo_grads.cu``)
   and K3 (``csrc/ppo_update.cu``); print the build times and ptxas'
   register/spill report of each kernel, and the count of HGMMA (wgmma)
   instructions in K2's SASS (``cuobjdump -sass``): 0 fails. For each of
   K1's team kernels its lanes an env, envs a block, shared memory a block
   and resident blocks an SM (``k1_occupancy``) are printed; for
   K3's ``k3_fused_step`` its registers and spills, its grid barrier (a
   cooperative launch) and the blocks the card holds at once (fewer than
   216 fails).
3. For each of K1's programs (the GR1T1 lower limb first), K1 against its
   plain PyTorch version (the lane program) on the card:
   4096 envs of the set's training config (noise, domain randomization,
   pushes, actuation delay on), reachable states (``init_state`` + a few
   steps with random actions; on terrain the robots start anywhere within
   3.5 m of their cells' origins, 16 steps, and K1 reads the ground lanes
   the env samples), one policy step through each. On trimesh the envs with
   a riser wall in contact and with a tread force suppressed inside a
   riser solid are counted at the step's start; none fails. Every float
   output must agree within rtol 1e-4 / atol 1e-4 (atol 1e-2 N for the
   contact forces), in all but at most 0.1% of the envs: ten stiff substeps
   amplify last-bit rounding differences, and in a few chaotic envs they
   exceed that tolerance, as threshold flips do for the boolean lanes.
   Those envs together (a boolean lane differs, or a float lane is over the
   stated tolerance) may be at most 0.1% of all; in the envs over the float
   tolerance each output must still lie within it plus 3x the float32 noise
   floor of the plain program on that output group (its float32 result
   against float64 on the same input, largest over the envs without a
   boolean flip). Then the team kernel (the main path's) against the
   one-thread kernel (``decimation_kernel``, kept as its reference) on the
   same packed input: 0 differing output lanes of all 4096 envs, compared
   bit for bit (NaN lanes by bit pattern). Times both kernels per launch
   (CUDA events, 50 launches, and again in turns), the wrapper and the plain
   version, and computes K1's bound; for the lower limb the team kernel
   must be faster than the one-thread kernel. The all-terms, V, T, V
   heading and both viscous programs must equal their plain versions in
   every output bit of every env; for the viscous programs the points in
   ground contact with a horizontal force at the step's end are counted (none, or
   fewer than half the envs in contact, fails), and the plain version with
   the friction coefficient x1.05 (which then feeds only the viscous law)
   must differ from K1 (a planted fault); the all-terms program runs on planted states
   (``cuda_step.planted_all_terms``: every 4th env dropped and pitched so
   that thighs and shanks touch, the next with its joints past their soft
   limits, the next with friction 6), and each reward term that no earlier
   program folds, and the penalized count, must be non-zero in some env
   (the counts are printed).
4. The slice: ``OnPolicyRunner(...).init_state()`` and one 64-step rollout
   at 4096 envs (K1 must launch exactly 64 times; all outputs finite), then
   the port's ``play`` loop for 20 steps from a seeded ``policy.npz``. One
   more rollout under torch.profiler: device time by kernel; a K1 device
   time of 0 under the team kernel's name fails.
5. K2's tensor-core GEMM alone (``gemm_check``: the main path's ``wg_gemm``
   with an f32 output and no epilogue) against the float64 product of the
   same bf16 values at every main-path shape (22 products) and at ragged row
   counts 1, 63, 65 and 200: each entry within K x 2^-23 x sum |a b| (the
   products are exact in f32). ``pack_params``' packed bf16 weights must
   equal its plain version ``pack_weights``' bit for bit. Then
   K2 against its plain version (``FusedPPOGrad.grads_plain``) on one
   full-width GR1T1 minibatch (10480 rows) of the phase-4 rollout buffer
   (4096 envs, GAE, the block shuffle): with float32 operands, where only
   the order of the sums differs (loss and aux rtol 1e-5; each gradient leaf
   rtol 1e-3 with atol 2e-5 x the leaf's largest |value|), and with bf16,
   the main path's type, where a sum taken in another order can also round
   a hidden activation or a backward gradient to the neighbouring bf16 value
   (loss and aux rtol 1e-4; each leaf rtol 1e-2 with atol 1e-3 x its
   largest |value|). Two aux values are means of terms that cancel, so
   their rtol applies to the size of the terms: the surrogate (and the
   loss) to its value plus the mean |advantage| (the ratio is ~1), the KL
   to its value plus an atol of 4 x A x 2^-24 (each row sums A terms of
   ~0.5 that cancel to ~1e-5, each rounded to float32 in another order or
   FMA contraction). Prints the largest difference per leaf. The check
   runs at the rollout's params, where the ratio is ~1 and nothing clips,
   and again at the params after phase 6a's epoch (the plain version's),
   where rows clip and the KL is more than its constant; the share of
   clipped rows there is printed. K2 and its plain version sum in another
   order (in bf16 a few activations then round the other way), and a row
   whose ratio (or value change) sits that close to a clip bound takes the
   other branch of the loss in one of them: its whole gradient term then
   differs (one such row moves a bf16 leaf by up to ~4% of its largest
   value). Such rows, found from K2's own mean and value and the plain
   version's (its forward row tile by row tile, as it computes it), are
   counted (at most 10 of the 10480) and taken out of both before the
   comparison (advantage 0, old value = the plain value). A planted fault
   must fail every leaf's check: K2's gradient with that leaf scaled by
   1.05.
6. K3 against its plain version (``update_scan_plain``), from the same
   buffer and params, one epoch (25 steps, every minibatch once). (a)
   float32 operands: the two trajectories stay at float32 summation noise,
   so update (final minus initial params), m and v agree to 1e-4 in L2,
   each param to 0.05 x LR, the final LR to rtol 1e-6, the metric means as
   K2's f32 aux; this also holds the adaptive LR sharply. (b) bf16
   operands, the main path's type, at a fixed LR: in bf16 a KL near the
   adaptive thresholds flips a step's 1.5x LR change by rounding alone, so
   the adaptive LR (held in (a)) is switched off here. A hidden activation
   rounded to the neighbouring bf16 value moves the gradient of the
   entries at the noise level, and Adam moves such an entry by about LR
   whichever its sign, from the first step on. The plain version run again
   with another row tile (1024, 2048: only the order of its sums changes)
   spreads as much. So the kernel is held to the plain version within the
   stated tolerance plus 3x the larger of those two spreads: update, m and
   v 1% in L2, each param 0.05 x LR, the metric means rtol 1e-3; the LR
   stays exactly the same. (c) The whole bf16 update (8 epochs, 200 steps,
   adaptive LR on), which two correct programs cannot share (their
   trajectories drift ~10-20% apart), is checked step by step from the
   kernel's own state (``whole_update_check``): at every 8th step and the
   last, the plain version runs the kernel's step from the same params,
   moments, count and LR, in bf16 within 6b's limits and, every 8th step,
   in float32 operands leaf by leaf (``f32_step_check``: in each actor and
   critic weight and bias and in ``std``, update, m and v within 1e-4 of
   the step in L2 plus 3x the plain version's spread in that leaf over row
   tiles; K3 fed K2's gradient with the largest leaf or ``std`` scaled by
   1.05 must fail it; rows on another branch of the loss taken out of both,
   as in 5); then the
   whole-update call must equal the composition of its 200 one-step calls
   bit for bit in p, m, v and the LR. The 200-step distance to the plain
   version's whole update is printed, not checked. Every ``update_scan``
   call of 6a-6c runs through the update's CUDA graph (captured at the
   first call for each shape and step count, replayed after copying the
   inputs in), so 6c's bit-for-bit composition also checks that the graph
   replays the right minibatch, count and LR sequence. (d) K3's fused step
   (``k3_step``, one cooperative launch: the main path's) against PR 2's
   two-launch step (``k3_step_ref``: ``k3_norm`` + ``k3_adam``, kept as its
   reference) on K2's bf16 gradient at full width, bit for bit in p, m, v,
   g, the LR/metric state slots, the partial sums and the step record (NaN
   lanes by bit pattern): at the rollout's params (Adam from zero), at the
   params after 6a's epoch (rows clip, the KL moves the LR down), with a
   gradient entry and the surrogate sum set to NaN (a NaN row: the NaN-loss
   path), and with the surrogate sum alone NaN (ok = 0, finite gradient).
7. The slice: ``OnPolicyRunner.learn(2)`` on the GR1T1 config at 4096 envs
   with ``log_dir`` under ``build/`` (since the compiled iteration,
   ``learn`` runs ``_train_iter``: the launch counts below are the graphed
   path's, the first iteration's from its warm-up and each later one's
   from a replay's tally; the profiled iteration after it is the eager
   ``iteration``, run once unprofiled first): finite losses, K3 launched once per
   iteration, K2's chain 200 times per iteration, K1 64 times per iteration
   (+1 for the initial step), and ``model_2.pt`` loads back bit-identical.
   Prints each iteration's time split into collection and update, the
   training env-steps/s and the peak memory; then one more iteration under
   torch.profiler: device time by kernel (K1, K2's chain, K3's step, the
   rest; K1's 0 while K1 launched fails), the device's busy share, and the
   device launches of each of
   K2's and K3's kernels, counted by the profiler (each must be a whole
   multiple of the iteration's grad steps, and K3 one ``k3_fused_step`` a
   grad step; a ``k3_norm`` or ``k3_adam`` fails); the host's launch calls
   inside ``FusedPPOGrad.update_scan`` (one ``cudaGraphLaunch`` an update,
   beside the input copies) and the captured graph's kernel nodes (all, and
   the cooperative ones) are counted too. Where the profiler sees no kernel
   inside the graph, the node count stands for the device launches, and the
   output says so. The kernels' JSON line takes K2's launches per grad step
   and the update's launches from these counts.
8. Times K2 per grad step, K3's fused step alone beside its reference pair
   (CUDA events, 50 steps each, and again in turns; the fused step must be
   the faster) and K3 per update (graph replays) beside their plain
   versions and bounds, K2's launches one by one (torch.profiler), a cuBLAS
   yardstick for K2 (``torch.matmul`` of the same 22 products on bf16
   operands, GEMMs only, captured in one CUDA graph and timed by its
   replays), an Adam yardstick for K3's step (PyTorch's fused Adam with
   ``clip_grad_norm_(foreach=True)`` on one 436,885-entry f32 vector, one
   CUDA graph replay: not the same function, it lacks K3's LR rule and bias
   correction; the port never calls either yardstick), the update graph's
   capture and instantiation time, and the update's wall time beside 200 x
   (K2 + K3 step) of kernel time.
9. The 32-DOF full body (``GR1T1_full``: obs 105, critic obs 234, 32
   actions, std floor 0.10, entropy coefficient 0), through the same entry
   points at 4096 envs: one rollout, then phase 5's GEMM check and K2
   against its plain version under phase 5's rule (at the rollout's params
   and after one epoch, the branch-flip rule and the planted fault
   included), K3 over one float32 epoch step by step from the kernel's
   state against the plain version's step (6c's per-leaf float32 rule, the
   rows on another branch in the row tiles taken out too; K3 fed K2's
   gradient with its largest leaf or ``std`` scaled by 1.05 must fail
   those limits at every checked step), the update's one-epoch CUDA graph in bf16
   (adaptive LR on) equal to the composition of its 25 one-step calls bit
   for bit (6c's last check), K3's fused step against its reference pair
   bit for bit (6d), K2's time per grad step beside its plain version,
   bound and the cuBLAS yardstick; then phase 7 on ``GR1T1_full`` (K1 64,
   K2's chain 200 and K3 once an iteration, K2's 11 device launches a grad
   step, finite losses, the checkpoint loads back bit-identical); then one
   64-step rollout of the no-pairs config (K1 launched 64 times).
10. Terrain training: phase 7 on GR1T1 with ``mesh_type`` heightfield and
   trimesh (without the profiled iteration) and the curriculum on (the config's 10 x 20 grid; the post
   stage outside K1, K1's ``local_plane`` and ``local_plane_walls``
   programs): K1 64, K2's chain 200 and K3 once an iteration, and the final
   state's ground planes and measured heights finite and non-zero on the
   rough rows; then one 64-step rollout with heading commands (K1's plane
   program without the fold, launched 64 times).
11. The all-terms fold's path: phase 7's ``learn(1)`` (unprofiled) on GR1T1
   with every reward term and the penalized groups
   (``cuda_step.all_terms_config``): K1 65, K2's chain 200 and K3 once,
   every term's episode mean finite; then one 64-step rollout each with the
   V law, the T law, V with heading commands, and the viscous contact on
   trimesh (K1 64 each).
12. The recurrent task ``GR1T1_lstm`` (``lstm_phase``): ``learn(2)`` at 4096
   envs (the compiled iteration: the collection graph, then one grad
   step's graph replayed 200 times; K1 129, K2 and K3 never), the LSTM
   weights and std moved, the
   checkpoint back bit for bit; the update's replay of a new rollout from
   its start memory with the done resets equal to the rollout's mu and
   values within 1e-5 (a replay without the resets must fail that); 20
   play steps of the stateful policy and the exported ``policy.npz``'s
   LSTM keys; a rollout and two grad steps of the update under the
   profiler.
13. The mirror-symmetry loss (``symmetry_phase``): ``learn(1)`` of GR1T1 at
   4096 envs with ``symmetry_coef`` 0.5 on the xla path, compiled (K1 65, K2 and K3
   never), the loss term and its gradient finite and non-zero on a
   minibatch at the trained params; then one grad step of GR1T1_lstm's
   recurrent update with the loss after a 64-step rollout (K1 64).
14. Data parallel (``dp_phase``): the one-process step path's ``learn(1)``
   (the update's yardstick); then two gloo ranks sharing the card
   (``dp_worker``, NCCL refuses two ranks on one device), 2048 envs each:
   (a) ``learn(2)``, K1 129 and K2's chain 400 on each rank, K3 never; (b)
   each rank's K2 against its plain version on its own minibatch under
   phase 5's rule, and the all-reduced mean against the plain versions'
   mean; (c) planted faults that must fail: rank 1's largest leaf x1.05
   before the all-reduce, and rank 1 dropping the all-reduce's result once
   (the identity check); (d) the ranks' learner states bit-identical after
   each update, the checkpoint from rank 0 only; the gloo all-reduce of the
   gradient timed alone. The ranks are joined within ``DP_JOIN_S`` or
   killed. Rank 0 also times K2's plain version and the cuBLAS yardstick
   (phase 8's) at its 5,232 rows, and K2's eager step-path call both ways:
   with its context built anew (``grads()``) and through
   ``step_context`` (made once an update, as the step path now calls it).
   (e) ``torchrun --nproc_per_node=1 -m
   wiki_grx_gym_tpu_torch.scripts.train --distributed`` with NCCL, one
   iteration, exit 0, its printed iteration line "compiled" (NCCL's
   collectives are captured). Each of phases 13 and 14 prints its seconds.
15. Eval and deploy (``eval_deploy_phase``), the launch counts set to 0
   just before each part and read just after: (a) ``play --record`` of
   GR1T1 from phase 7's ``model_2.pt`` (50 envs, 100 steps; K1 once a step
   and once for the load's initial step; ``traj.npz`` with JAX's keys,
   shapes and dtypes, finite; ``policy.npz`` and ``policy.grxpolicy``
   written); (b) the native C++ runtime (``deploy/runtime.py``, built by
   g++) on that ``.grxpolicy`` and 4096 rows of phase 4's observations
   against the port's actor on the card in f32, rtol 1e-4 / atol 1e-5, one
   weight of the file moved by 1e-2 must fail it, and the forward's host
   CPU time, for the batch and for 1,000 single-row calls (median, p99); (c) the same for GR1T1_lstm's export from phase 12, streamed
   20 steps against the port's stateful policy and again after
   ``reset()``; (d) the replay frames of (a)'s file (forward kinematics on
   the card) against float64 on the CPU within 1e-5 m; (e) ``eval_tracking``
   at 64 envs: six finite rows, survival in [0, 1], K1 1 + 6 x 261 times;
   (f) ``learn(5, profile_dir=...)`` at 4096 envs: one Chrome trace of
   iterations 2-4 naming K1's team kernel and K2's and K3's kernels (or,
   ``learn`` being compiled, the graphs' launches). Play and eval_tracking
   step through ``env.step_graph`` (the first step of each graph is its
   warm-up, counted as any eager step). Prints its seconds.
16. The engine path (``engine_phase``; ``sim/engine.physics_step`` under
   the env's decimation loop, ``cfg.sim.use_pallas = False``): (a) K1 (the
   GR1T1 fold program) against the engine on phase 3's 4096 reachable
   states and inputs, one policy step each: the physics state within rtol
   1e-3 / atol 1e-4, the feet sums, torques and point forces within rtol
   2e-3 / atol 2e-2 (tests/test_scalarized.py's decimation check): at most
   0.1% of the envs over them plus 3x their own float32 noise floor (the
   lane program's float32 against float64 on the env's outputs), and every
   env within them plus 3x the lane program's float32 floor on the group
   (phase 3's widened bound); the envs over the bare tolerance are counted
   (two float32 programs drift apart by about their noise floor in envs
   whose contact amplifies it); the engine with its
   contact stiffness times 1.05 must fail every check; the engine's step
   timed beside K1's and its device kernels counted. (b) ``learn(1)`` of
   GR1T1 at 4096 envs with ``use_pallas = False`` in the config only: the
   physics on the card, K1 0 launches, K2 and K3 as in phase 7, finite
   losses; seconds, env-steps/s, peak memory and the card line.
17. Item 16 and item 14b at GR1T1's full width. (a, ``dtype_phase``)
   ``compute_dtype`` and ``update_dtype`` bf16 with f32 storage on the mega
   path: K2's operands bf16 by JAX's rule, the bf16 rollout at iteration 0
   within 1e-2 / 2e-2 of the f32 net's mu and values, ``learn(1)`` with K1
   65, K2 200, K3 1, finite losses and params. (b) The xla path at the
   trained state, one minibatch: ``remat_update``'s gradient bit for bit,
   ``fused_trunk``'s f32 gradient within 1e-4 of the leaf's largest, the
   bf16 gradient within 5e-2 and one bf16 grad step's params within
   tests/test_parallel.py's bf16 bounds of the f32 ones, a planted fault
   (the last layer accumulated in bf16) reported against both. (c,
   ``tp_phase``) ``tp_worker`` on two gloo ranks at ``--num_mp 2``: each
   rank's parameter count, an mp1 checkpoint loaded as the shards,
   ``learn(1)`` at 16 steps an env (K1 16, the xla path), the peers bit-identical, the gathered
   gradient against one process's (1e-4 of each leaf's largest), two planted
   faults failing that check, 4 grad steps against one process's, the mp2
   checkpoint loaded at mp1; then four ranks at dp2 x mp2 (2 x 2048 envs)
   while the phase stays inside its budget.
18. The port's bench (``bench_phase``, ``scripts/bench.py``): its
   ``build_run`` and ``time_run`` for ``main`` (4096 envs),
   ``ref_equiv_subset`` and ``envs8192`` (the reference's default 8192
   envs) at 5 timed iterations each, the launch counts set to 0 before
   each and held to the iterations and rollouts the cell reports; each
   cell's line finite with ``pallas_kernel`` true, its per-iteration times
   and peak memory. Then on the 8192-env cell's run: one iteration counted
   alone (K1 64, K2 200, K3 1); K1 against its plain version and the team
   kernel against the one-thread kernel on its env state, by phase 3's
   rule; on its rollout buffer (20,960-row minibatches: K2's row splits
   end on partial blocks) K2's GEMM check and K2 against its plain version
   under phase 5's rule and limits, at the params and after one float32
   epoch; the whole 200-step bf16 update's CUDA graph against its 200
   one-step calls bit for bit; K2's time beside its plain version, bound
   and cuBLAS yardstick at 20,960 rows.
19. The compiled iteration (``compiled_phase``; ``learn/graphs.py``,
   ``OnPolicyRunner._train_iter``, ``LeggedEnv.step_graph``) at 4096 envs:
   (t) eager and graphed iteration times (min / median / max; collection
   and update from the CUDA events), peak memory, each graph's warm-up,
   capture and instantiate ms and kernel nodes, and the graphed
   iterations' launch counts (K1 64, K2 200, K3 1 each); (a) three
   ``_train_iter`` calls with injected noise, u and perm against three eager
   iterations, the donated state feeding the next call: the Transition's
   nine fields, last values, returns, advantages, the env state, the PPO
   state and the metrics bit for bit; (b) the same with generator draws
   (the graphed draws equal the eager ones; two consecutive replays sample
   other noise); (f2) a GR1T1 env of the same K1 sizes with its contact
   stiffness x1.05 steps eagerly (uploading its constants) between two
   replays of one state and draws: the replays agree bit for bit; (c) one
   graphed and one eager iteration under torch.profiler: the host's launch
   calls, device time, busy share, equal kernel counts; (d) heightfield and
   GR1T1_full under (a)'s rule (a warm-up and a replay); (e) ``step_graph``
   against ``step`` at play's 50 envs, bit for bit for 20 steps, and the
   eval step at 64 envs timed both ways; (f1) a capture that does not
   register the generators must fail (b) or raise.
20. The compiled update on the other paths (``compiled_update_phase``) at
   4096 envs: the registry's GR1T1_lstm (one grad step's graph replayed
   200 times, the step index on the device), GR1T1 with the symmetry loss
   on the xla path, on the step path (K2 inside the update's graph) and on
   the xla path. (a) Two ``_train_iter`` calls against two eager
   iterations with injected noise, u and perm: every collection output,
   the state (the LSTM memory included), the PPO state and the metrics bit
   for bit (GR1T1_lstm at 4 steps an env, ``UPDATE_CHECK_STEPS``: its
   eager iteration scales with T). (b) Three graphed iterations (generator
   draws, 64 steps an env): min / median /
   max, collection and update from the CUDA events, beside (a)'s eager
   times; launch counts (K1 64, K2 200 on the step path, each); the
   graphs' warm-up, capture and instantiate ms and kernel nodes; peak
   memory; the host's launch calls and the device busy share from the
   profiler (GR1T1_lstm: estimated from one collection replay and 10
   grad-step replays). (c) GR1T1_lstm: a grad-step graph whose step index
   does not advance and a collection that keeps the old memory must each
   fail (a)'s check.
21. The compiled iteration on the engine (``engine_compiled_phase``,
   ``use_pallas = False``: one rollout step's graph replayed 64 times, then
   the collection's tail, then K3's update graph) at 4096 envs: (a) two
   calls against eager with injected draws and two with generator draws,
   4 steps an env (the eager engine is host-bound, ~29 s an iteration of
   64 steps), bit for bit; (b) three graphed iterations of 64 steps timed,
   launch counts, host calls, the device time of A1 and A2 + the update;
   (c) A1 without its index advanced must fail (a)'s check; (d)
   ``step_graph`` on the engine at 64 envs, bit for bit, timed.
22. The compiled iteration over NCCL (``nccl_phase``: ``nccl_worker`` on
   each world of ``NCCL_WORLDS`` the cards hold, one rank a card, 4096
   envs a dp rank, GR1T1 (or GR1T1_lstm) with the all-terms fold and the
   command curriculum on, which all-reduces in every env step only with
   the fold's tracking_lin_vel term): (a) one rank of a world-1 NCCL group
   (the mega path; its collectives, the curriculum's all-reduce in each
   env step and the metric sums' in K3's graph, captured; at one rank NCCL
   launches no kernel, so (a) holds the rule and the capture's plumbing,
   not NCCL's kernels in a graph); (b) with two cards dp2 on the step
   path; (c) with two cards dp2 on the xla path, with the symmetry loss,
   on the engine and on GR1T1_lstm (these two at 16 steps an env: their
   eager iterations take ~29 s at 64) and mp2 on the xla path, with four
   dp2 x mp2 on the xla path and dp4 on the step path; (d) the global
   shuffle (``permutation_groups`` the dp group does not divide, every
   rank updating on the gathered global batch) with two cards dp2 on the
   mega path (K3), on the step path (K2) and on GR1T1_lstm on the engine,
   with four dp4 with ``permutation_groups = 2`` on the xla path; mp2 (two
   cards) and dp2 x mp2 (four) with the symmetry loss on the engine and on
   GR1T1_lstm (the engine and LSTM worlds at 16 steps an env); (e) the
   last runs JAX jits across ranks: with two cards dp2
   ``permutation_groups = 1`` with the symmetry loss, dp2 GR1T1_lstm with
   the symmetry loss (alone and under the global shuffle) and mp2
   GR1T1_lstm with the symmetry loss on the engine, with four dp2 x mp2
   ``permutation_groups = 1`` on the xla path (JAX's own CLI run, ``train
   --num_mp 2`` on four devices), with the symmetry loss, on GR1T1_lstm on
   the engine and on GR1T1_lstm with the symmetry loss, and dp2 x mp2
   GR1T1_lstm with the symmetry loss; and at one rank GR1T1_lstm with the
   symmetry loss (the recurrent mirror loss's update graph), run only
   under ``--phase22``: together every key of ``mesh.COMPILED_COLLECTIONS``
   and ``COMPILED_UPDATES``.
   Each rank: the rule compiles it;
   ``_train_iter`` calls against eager iterations with injected draws and
   with generator draws, bit for bit; each graph's nodes by kind (NCCL's
   kernels counted apart: across ranks the collection and the update hold
   some) and the collectives it captured; five graphed iterations timed
   with their launch counts (K1 one a step on K1; K2 200 on the step and
   mega paths; K3 1 on the mega path); one under torch.profiler (host
   launch calls, and on the MLP worlds device time and busy share);
   ``learn(1)`` printing "iteration: compiled" with the ranks' digests
   equal; a planted fault that must be caught: at world 1 the metric
   sums' all-reduce captured ahead of the collection that writes them
   (the metrics differ from eager's); under dp alone rank 1's update with
   ``PPO.reduce``'s result dropped, under mp mp rank 1's
   ``_CopyToMP`` backward result dropped (the collective still issued,
   so no rank waits): ``learn``'s digest check must raise; under the
   global shuffle the first injected call's update must equal the
   one-process update (a PPO without dp) of the true global batch
   (``true_global``: gathered apart, into a list) with dp rank 0's
   permutation, within ``GLOBAL_TOL``, its one all-gather captured in the
   graph that stages the update, and the planted fault is that batch
   gathered in rotated rank order (every rank's slice one place late: the
   ranks stay equal to each other), which must fail that check (under dp
   x mp the global shuffle's worlds plant both faults, the rotation
   first). Each world ends
   within its own deadline or its ranks are killed and the phase fails
   naming where each rank stopped; one world's failure does not stop the
   next. Prints the worlds run, ``nccl_cards`` and what was skipped for
   want of cards.
   Prints the kernels' JSON line (K1 for each program, its main-path count
   from phase 4 with phase 15's, 16's and 17's counts beside it under their
   own keys, the viscous program's from phase 18's ``ref_equiv_subset``
   cell, the trimesh viscous program's from phase 11's rollout, GR1T1's at
   8192 envs from phase 18, K2 at both widths with its data-parallel use
   under ``dp`` and at 20,960 rows from phase 18, K3; K1, K2 and K3 also
   with phase 19's graphed iterations' counts, phase 21's on the engine
   and phase 22's per NCCL world and rank (``dp_graphed_launches``); K2
   with phase 20's graphed step path's), the card line, and the final ok
   line.
"""

import copy
import ctypes
import gc
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple, Optional

THIS = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 4096
ROLLOUT_STEPS = 64
PLAY_STEPS = 20
FP32_PEAK = 67e12      # H100 SXM FP32 FLOP/s outside the tensor cores (data sheet;
                       # an FMA counts as two operations)
BF16_TC_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
HBM_RATE = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
TRAIN_ITERS = 2
# phase 12: the LSTM replay against the rollout's mu and values (largest |diff|)
REPLAY_TOL = 1e-5
# K2 vs plain: (loss/aux rtol, leaf rtol, leaf atol as a fraction of the leaf's largest |value|)
K2_TOL = {"float32": (1e-5, 1e-3, 2e-5), "bfloat16": (1e-4, 1e-2, 1e-3)}
# K3 vs plain, one bf16 epoch: stated L2 share of update, m and v (plus 3x the
# plain version's spread over these row tiles)
K3_BF16_TOL = 0.01
K3_FLOOR_TILES = (1024, 2048)
# phases 5 and 6c: rows of a 10480-row minibatch that may take another branch
# of the loss in the kernel than in its plain version (0.1%; neutralize_flips)
MAX_FLIPS = 10
# phases 5 and 9: a planted fault every check of K2's leaves, and phase 9's
# K3 step check (widened by the plain version's spread), must fail: a
# gradient leaf off by this factor
FAULT_SCALE = 1.05


def plain_variants(fused):
    """Copies of ``fused`` whose plain versions differ from it only in the
    order of their sums (row tiles K3_FLOOR_TILES): their distance from the
    plain version is its own spread."""
    out = []
    for tile in K3_FLOOR_TILES:
        f = copy.copy(fused)
        f.tile, f.n_tiles = tile, -(-fused.rows // tile)
        out.append(f)
    return out
# 6c, float32 operands: one grad step's update, m and v within this share in L2
F32_STEP_TOL = 1e-4
# 6c: the steps of the whole update checked against the plain version (every
# this many, and the last; each check is host-bound plain-version work)
STEP_CHECK_STRIDE = 8
# the kernels of K2's chain and of K3's step (csrc/ppo_grads.cu, csrc/ppo_update.cu)
# (the main path's bf16 chain; the f32 chain's SIMT kernels run only in checks)
KERNEL_NAMES = {"K1": ("decimation_team_kernel",),
                "K2": ("pack_params", "wg_gemm", "loss_rows", "k2_reduce"),
                "K3": ("k3_fused_step",)}
K3_REFERENCE_NAMES = ("k3_norm", "k3_adam")   # PR 2's step: never on the main path
K2_LAUNCHES_PER_STEP = 11   # K2's bf16 chain a grad step (csrc/ppo_grads.cu)
K3_BARRIER = "cooperative launch (cudaLaunchAttributeCooperative, cooperative_groups::this_grid().sync())"
HGMMA_COUNT = [None]   # HGMMA instructions in K2's SASS (phase 2)
RTOL, ATOL, ATOL_FORCE = 1e-4, 1e-4, 1e-2
FORCE_GROUPS = ("force_sum", "point_force")   # contact forces, newtons
BOOL_GROUPS = ("post/term_contact", "post/tilt", "post/bad", "post/feet_contact",
               "post/contact_filt", "post/first_contact")


FAILURES = []


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase_done(name):
    log(f"[time] {name} done at {time.perf_counter() - T0:.1f} s")


def fail(msg):
    """Record a failed check of phases 5-9; main exits non-zero after the
    last phase (so one run reports every check) and prints no result."""
    FAILURES.append(msg)
    log("FAIL:", msg)


def logger_finite(logger):
    """Every value play's EvalLogger holds, the stored rewards included, is
    finite (a NaN reward times an episode count of 0 stays NaN)."""
    import numpy as np

    return all(bool(np.isfinite(v).all()) for vals in {**logger.state_log, **logger.rew_log}.values()
               for v in vals)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def groups(res):
    """Every output group of the K1 wrapper's return tuple, float64 (the
    final-state point positions in the terrain modes, the post stage's
    outputs in the post-fold program)."""
    g = {f: getattr(res[0], f) for f in ("base_pos", "base_quat", "base_lin_vel",
                                         "base_ang_vel", "q", "qd", "anchor")}
    g.update(force_sum=res[1], vxyz_sum=res[2], vrpy_sum=res[3], tau=res[4],
             point_force=res[5], post_rel=res[6][0], post_quat=res[6][1])
    if res[7] is not None:
        g["point_pos"] = res[7]
    g.update({"post/" + k: v for k, v in (res[8] or {}).items()})
    return {k: v.double().reshape(v.shape[0], -1) for k, v in g.items()}


def count_plain_ops(task="GR1T1", mutate=None):
    """Floating-point operations of the plain lane program per env and
    policy step of ``task``'s training config (``mutate`` applied): every
    elementwise arithmetic, comparison and select op run at N=1 counts one
    per output element (views, copies and stacking do not count)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from wiki_grx_gym_tpu_torch.sim import cuda_step

    skip = ("view", "stack", "cat", "clone", "copy", "zeros", "ones", "empty", "full",
            "select", "slice", "unsqueeze", "squeeze", "expand", "_to_copy", "lift",
            "detach", "alias", "t.", "transpose", "reshape", "unbind", "scalar_tensor",
            "_local_scalar", "as_strided", "split", "unsafe", "broadcast")

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func.overloadpacket.__name__) + "."
            if not any(name.startswith(s) for s in skip) and isinstance(out, torch.Tensor):
                Count.ops += out.numel()
            return out

    env = cuda_step.task_env(task, 1, "cpu", mutate)
    state = env.init_state(0)
    args, kw = cuda_step.decimation_inputs(env, state, torch.Generator().manual_seed(0))
    with Count():
        env.decimation_op.plain(*args, **kw)
    return Count.ops


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def weight_counts(fused):
    """(all weights, weights of the two input layers) of the actor-critic."""
    dims = [fused.actor_dims, fused.critic_dims]
    total = sum(a * b for d in dims for a, b in zip(d[:-1], d[1:]))
    return total, sum(d[0] * d[1] for d in dims)


def k2_work(fused, op_bytes):
    """Operations and bytes of one K2 call at these shapes: forward, weight
    gradient and input gradient (none for the input layers) products, two
    operations per multiply-add; each input read once (the minibatch's
    obs||critic_obs in the operand type, its f32 scalars, the f32 params),
    each output written once (the f32 gradient)."""
    w, w_in = weight_counts(fused)
    r = fused.rows
    ops = 2 * r * w + 2 * r * w + 2 * r * (w - w_in)
    n = fused.net.num_params
    nbytes = (r * (fused.obs_dim + fused.cobs_dim) * op_bytes + r * (3 * fused.act_dim + 4) * 4
              + 2 * n * 4)
    return ops, nbytes


def leaf_diffs(net, got, want):
    """Per layout leaf: (name, max |diff|, max |want|)."""
    out = []
    for name, off, shape in net.layout:
        n = math.prod(shape)
        a, b = got[off: off + n], want[off: off + n]
        out.append((name, float((a - b).abs().max()), float(b.abs().max())))
    return out


def clip_shares(fused, p, bufs, mb):
    """Shares of minibatch ``mb``'s rows whose probability ratio, and whose
    value change, lie outside the clip range at params ``p`` (float32
    forwards): how much of K2's clip branches a check at ``p`` reaches."""
    import torch

    actor, critic, std = fused.net.leaves(p)

    def mlp(x, layers):
        for i, (w, b) in enumerate(layers):
            x = x @ w.t() + b
            if i < len(layers) - 1:
                x = torch.nn.functional.elu(x)
        return x

    A, clip = fused.act_dim, fused.clip_param
    fs = bufs["fscal"][mb]
    mean = mlp(bufs["obs"][mb].float(), actor)
    value = mlp(bufs["cobs"][mb].float(), critic)[:, 0]
    logp = (-0.5 * (((fs[:, :A] - mean) / std) ** 2).sum(1)
            - (0.5 * A * math.log(2.0 * math.pi) + torch.log(std).sum()))
    ratio = torch.exp(logp - fs[:, A])
    return (float(((ratio - 1.0).abs() > clip).float().mean()),
            float(((value - fs[:, 3 * A + 1]).abs() > clip).float().mean()))


def loss_branches(fused, p, fs, mean, value):
    """Per row, the branches the loss takes (csrc/ppo_grads.cu loss_rows,
    in float64 from the given forward outputs): the ratio below / inside /
    above the clip range (-1, 0, 1), the value change likewise, and whether
    the unclipped value loss is the larger outside the value clip range."""
    import torch

    A, clip = fused.act_dim, fused.clip_param
    fs, mean, value = fs.double(), mean.double(), value.double()
    std = (torch.full((A,), fused.init_noise_std, dtype=torch.float64, device=fs.device) if fused.fixed_std
           else p[fused.std_off:].double())
    logp = (-0.5 * (((fs[:, :A] - mean) / std) ** 2).sum(1)
            - (0.5 * A * math.log(2.0 * math.pi) + torch.log(std).sum()))
    ratio = torch.exp(logp - fs[:, A])
    rb = (ratio > 1.0 + clip).int() - (ratio < 1.0 - clip).int()
    old_v, ret = fs[:, 3 * A + 1], fs[:, 3 * A + 2]
    vdelta = value - old_v
    vb = (vdelta > clip).int() - (vdelta < -clip).int()
    e2, ec2 = (value - ret) ** 2, (old_v + vdelta.clamp(-clip, clip) - ret) ** 2
    vmax = (e2 > ec2) & (vb != 0) if fused.use_clipped_value_loss else torch.zeros_like(vb, dtype=torch.bool)
    return rb, vb, vmax


def plain_forward(fused, p, bufs, mb):
    """The plain version's forward outputs (mean, value) on minibatch ``mb``
    at params ``p``, row tile by row tile as ``grads_plain`` computes them
    (the same products on the same tile shapes, so the same roundings)."""
    import torch

    aw, cw, _ = fused._op_leaves(p)
    T = fused.tile

    def tile_of(x, t):
        x = x[t * T:(t + 1) * T]
        return torch.cat([x, x.new_zeros((T - x.shape[0],) + x.shape[1:])]) if x.shape[0] < T else x

    means, values = [], []
    for t in range(fused.n_tiles):
        means.append(fused._mlp_forward(fused._rnd(tile_of(bufs["obs"][mb], t)), aw)[1])
        values.append(fused._mlp_forward(fused._rnd(tile_of(bufs["cobs"][mb], t)), cw)[1][:, 0])
    return torch.cat(means)[:fused.rows], torch.cat(values)[:fused.rows]


def neutralize_flips(fused, p, bufs, mb, variants=()):
    """K2's forward and its plain version's sum in another order (in bf16 a
    few activations then round the other way), and a row whose ratio or
    value change sits that close to a clip bound takes the other branch of
    the loss in one of them: its whole gradient term then differs. Those
    rows of minibatch ``mb`` are found from K2's own forward outputs (its
    mean and value) and the plain version's (``plain_forward``), and taken
    out of both: their advantage set to 0 (no surrogate gradient) and their
    old value set to the plain version's value (no value clip). Rows on
    another branch in one of the plain ``variants`` (other row tiles, whose
    distance from the plain version is its own spread) than in K2 are
    taken out too. Returns (the buffers with those rows changed, the count
    of rows on another branch in K2 than in the plain version, the count of
    rows taken out)."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import fused_update

    args, keep = fused._k2_context(p, bufs)
    fused._k2_launch(fused_update._lib("k2"), args, mb, p.device)
    fs = bufs["fscal"][mb]
    rk, vk, mk = loss_branches(fused, p, fs, keep["mean"], keep["value"])
    outs = [plain_forward(f, p, bufs, mb) for f in (fused, *variants)]
    rflip, vflip = [], []
    for mean, value in outs:
        rp, vp, mp = loss_branches(fused, p, fs, mean, value)
        rflip.append(rk != rp)
        vflip.append((vk != vp) | (mk != mp))
    flips = int((rflip[0] | vflip[0]).sum())
    rflip, vflip = torch.stack(rflip).any(0), torch.stack(vflip).any(0)
    value_p = outs[0][1]
    A = fused.act_dim
    fs2 = bufs["fscal"].clone()
    fs2[mb, rflip, 3 * A + 3] = 0.0
    fs2[mb, vflip, 3 * A + 1] = value_p[vflip]
    return dict(bufs, fscal=fs2), flips, int((rflip | vflip).sum())


def pack_check(fused, p, bufs):
    """K2's ``pack_params`` (the first kernel of a bf16 grad step) against
    its plain version ``pack_weights``: the packed bf16 weights, pads and
    gaps included, bit for bit."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import fused_update

    args, keep = fused._k2_context(p, bufs)
    fused._k2_launch(fused_update._lib("k2"), args, 0, p.device)
    want = fused_update.pack_weights(p, fused.net.layout, fused.q_layout, fused.q_total)
    return bool(torch.equal(keep["q"], want))


def k2_launch_profile(k2_launch):
    """Device time of each kernel launch of one K2 grad step (the last of
    three under torch.profiler), in launch order: [(kernel, ms), ...]."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    k2_launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            k2_launch()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    first = [i for i, e in enumerate(ev) if e.name.startswith("pack_params")]
    if not first:
        log(f"[K2 profile] {len(ev)} device kernels in 3 grad steps, none of them pack_params: "
            + ", ".join(e.name[:40] for e in ev) + "; per-launch times not measured")
        return None
    out = [(e.name.split("(")[0], e.time_range.elapsed_us() / 1e3) for e in ev[first[-1]:]]
    log(f"[K2 profile] one grad step, {len(out)} launches, {sum(t for _, t in out):.4f} ms of kernel time: "
        + ", ".join(f"{n} {t * 1e3:.1f} us" for n, t in out))
    return out


def cublas_yardstick(fused, dev):
    """The library call for K2's products: torch.matmul (cuBLAS) on bf16
    operands at the main path's shapes, the same products as K2's
    tensor-core chain (forward, input and weight gradients of both MLPs),
    GEMMs only (no epilogue, loss or reduction). The 22 calls are captured
    once in a CUDA graph and its replays timed with CUDA events, so the
    time is the device's, not the host's issue of 22 Python calls. The port
    never calls it."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)
    prods = []
    for kind, M, N, K, _ in fused.gemm_shapes():
        if kind == 0:
            a, b = rnd(M, K), rnd(N, K)
            prods.append(lambda a=a, b=b: a @ b.t())
        elif kind == 1:
            a, b = rnd(M, K), rnd(K, N)
            prods.append(lambda a=a, b=b: a @ b)
        else:
            a, b = rnd(K, M), rnd(K, N)
            prods.append(lambda a=a, b=b: a.t() @ b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # cuBLAS sets up its handle and workspace outside the capture
        for _ in range(3):
            [f() for f in prods]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in prods]
    ms = cuda_ms(graph.replay, reps=50, warmup=3)
    del graph, outs
    # cuBLAS keeps a workspace per stream (here the side and capture streams)
    # until told otherwise: free them, so phase 7's peak memory is the port's
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return ms


def gemm_checks(fused, dev):
    """Phase 5's sharp check of K2's tensor-core GEMM (``gemm_check``: the
    main path's wg_gemm, f32 output, no epilogue) against the float64
    product of the same bf16 values, at every main-path shape and at ragged
    row counts 1, 63, 65 and 200 (input layers, K = 39 and 168 padded, and a
    hidden input gradient). Products of bf16 values are exact in f32, so
    each entry must lie within K x 2^-23 x sum |a b|. Returns the largest
    |error| / limit."""
    import numpy as np
    import torch

    from wiki_grx_gym_tpu_torch.learn.fused_update import gemm_check, gemm_check_plain

    cases = fused.gemm_shapes()
    for rows in (1, 63, 65, 200):
        cases += [c for c in fused.gemm_shapes(rows) if c[4].endswith(" 0 forward")
                  or c[4].endswith(" 0 weight gradient") or c[4] == "actor 2 input gradient"]
    rng = np.random.RandomState(11)
    worst, bad = 0.0, []
    for kind, M, N, K, label in cases:
        shapes = {0: ((M, K), (N, K)), 1: ((M, K), (K, N)), 2: ((K, M), (K, N))}[kind]
        a, b = [torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(dev).to(torch.bfloat16) for sh in shapes]
        c = gemm_check(kind, a, b)
        err = (c.double() - gemm_check_plain(kind, a, b)).abs()
        ratio = float((err / (K * 2.0**-23 * gemm_check_plain(kind, a.abs(), b.abs()))).max())
        good = math.isfinite(ratio) and ratio <= 1.0 and bool(torch.isfinite(c).all())
        worst = max(worst, ratio)
        if not good:
            bad.append(f"{label} {M}x{N}x{K}")
        log(f"[K2 GEMM] {label:26s} M {M:5d} N {N:4d} K {K:5d}: largest |error| {float(err.max()):.3e}, "
            f"{ratio:.3e} of its limit K x 2^-23 x sum|ab|; {good}")
    log(f"[K2 GEMM] {len(cases)} products, largest |error| / limit {worst:.3e}")
    if bad:
        fail(f"K2's tensor-core GEMM disagrees with float64 at {bad}")
    return worst


def one_step(fused):
    """A copy of ``fused`` that runs one grad step: one minibatch, one epoch."""
    f = copy.copy(fused)
    f.num_mini_batches, f.num_epochs = 1, 1
    return f


def step_dist(x, y, base):
    """Distances of two one-step results from the same params ``base``:
    update, m and v as shares of y's in L2; largest |param| difference."""
    import torch

    nrm = lambda t: float(torch.linalg.vector_norm(t))
    return {"update": nrm(x[0] - y[0]) / max(nrm(y[0] - base), 1e-30),
            "m": nrm(x[1] - y[1]) / max(nrm(y[1]), 1e-30),
            "v": nrm(x[2] - y[2]) / max(nrm(y[2]), 1e-30),
            "pmax": float((x[0] - y[0]).abs().max())}


def leaf_dists(net, x, y, base):
    """``step_dist`` per leaf of ``net.layout`` (each actor and critic weight
    and bias, and std): {leaf: {update, m, v, pmax}}."""
    out = {}
    for name, off, shape in net.layout:
        sl = slice(off, off + math.prod(shape))
        out[name] = step_dist(tuple(t[sl] for t in x[:3]), tuple(t[sl] for t in y[:3]), base[sl])
    return out


def f32_step_check(one, state, used, tag):
    """The f32 check of one K3 step (phases 6c and 9), leaf by leaf: K3's
    fused step from ``state`` = (p, m, v, count, lr) on the buffers ``used``
    (rows on another branch of the loss already taken out) against the
    plain step, in each leaf (``leaf_dists``) update, m and v within
    ``F32_STEP_TOL`` in L2 plus 3x the plain version's own spread in that
    leaf over row tiles (``plain_variants``: an entry whose gradient sums to
    noise level moves by about LR whichever its sign, most at Adam's first
    step), and the same LR. Planted faults must fail it: K3 fed K2's
    gradient with the largest leaf and with the smallest (``std``) scaled by
    ``FAULT_SCALE`` (``k3_fault``). Returns (ok, the kernel's step, the
    worst share of a leaf's limit, that leaf, the largest |param|
    difference)."""
    p, m, v, cnt, lr = state
    k = one.update_scan(p, m, v, cnt, lr, used)
    pl = one.update_scan_plain(p, m, v, cnt, lr, used)
    floors = [leaf_dists(one.net, fz.update_scan_plain(p, m, v, cnt, lr, used), pl, p)
              for fz in plain_variants(one)]
    lim = {leaf: {key: F32_STEP_TOL + 3.0 * max(f[leaf][key] for f in floors) for key in ("update", "m", "v")}
           for leaf in floors[0]}
    d = leaf_dists(one.net, k, pl, p)
    share = {leaf: max(d[leaf][key] / lim[leaf][key] for key in lim[leaf]) for leaf in d}
    worst = max(share, key=share.get)
    ok = share[worst] <= 1.0 and abs(float(k[3]) - float(pl[3])) <= 1e-6 * abs(float(pl[3]))
    faults = {}
    for leaf in (max(one.net.layout, key=lambda e: math.prod(e[2]))[0], "std"):
        fd = k3_fault(one, state, used, pl, leaf)
        fshare = max(fd[lf][key] / lim[lf][key] for lf in fd for key in lim[lf])
        faults[leaf] = (fshare, fshare > 1.0)
    log(f"[K3 f32 step] {tag}: worst leaf {worst} at {share[worst]:.3f} of its limit (update "
        f"{d[worst]['update']:.3e}, m {d[worst]['m']:.3e}, v {d[worst]['v']:.3e}; limits "
        f"{lim[worst]['update']:.3e}, {lim[worst]['m']:.3e}, {lim[worst]['v']:.3e}); std leaf at "
        f"{share['std']:.3f}; lr {float(k[3]):.6e} vs {float(pl[3]):.6e}; {ok}; K3 fed K2's gradient with a leaf x"
        f"{FAULT_SCALE}: " + ", ".join(f"{leaf} at {fs:.2f} of the limit, caught {c}" for leaf, (fs, c) in faults.items()))
    for leaf, (_, caught) in faults.items():
        if not caught:
            fail(f"K3 {tag}: a gradient off by x{FAULT_SCALE} in {leaf} passes the per-leaf limits")
    return ok, k, share[worst], worst, float((k[0] - pl[0]).abs().max())


def whole_update_check(fused16, fused32, bufs16, bufs32, args0, k3_err):
    """Phase 6c. The kernel drives the whole bf16 update (every epoch and
    minibatch, adaptive LR on) one grad step at a time: a one-step
    ``FusedPPOGrad`` fed minibatch ``s % MB``'s slice, Adam count
    ``count0 + s`` and the LR the kernel carried out of step s - 1. At every
    ``STEP_CHECK_STRIDE``-th step and the last, the plain version runs the same step from the
    kernel's state: in bf16 within the stated tolerance plus 3x the plain
    version's own one-step spread (``plain_variants``, as in 6b), and at
    every ``STEP_CHECK_STRIDE``-th step also in float32 operands, sharply (update, m and v 1e-4
    in L2, the same LR). In both, the rows that take another branch of the
    loss in the two are taken out of both (``neutralize_flips``, as in
    phase 5). Then the whole-update call must equal the composition of its
    one-step calls bit for bit in p, m, v and the final LR. Returns the
    whole-update result."""
    import torch

    mbs = fused16.num_mini_batches
    steps = fused16.num_epochs * mbs
    one16, one32 = one_step(fused16), one_step(fused32)
    sl = lambda bufs, k: {key: x[k:k + 1] for key, x in bufs.items()}
    p, m, v, count0, lr = args0
    sampled = sorted(set(range(0, steps, STEP_CHECK_STRIDE)) | {steps - 1})
    worst16 = {"update": 0.0, "m": 0.0, "v": 0.0, "pmax_lr": 0.0}
    worst32 = {"share": 0.0, "leaf": None}
    bad16, bad32 = [], []
    max_flips = max_flips32 = 0
    rows = fused16.rows
    for s in range(steps):
        cnt = count0 + s
        k = s % mbs
        nxt = one16.update_scan(p, m, v, cnt, lr, sl(bufs16, k))
        if s in sampled:
            # rows the kernel and the plain version send down different
            # branches of the loss are taken out of both for the comparison
            # (the trajectory goes on with the kernel's own step)
            variants = plain_variants(one16)
            used, flips, taken = neutralize_flips(one16, p, sl(bufs16, k), 0, variants)
            ks = one16.update_scan(p, m, v, cnt, lr, used) if taken else nxt
            pl = one16.update_scan_plain(p, m, v, cnt, lr, used)
            spread = [fz.update_scan_plain(p, m, v, cnt, lr, used) for fz in variants]
            floors = [step_dist(z, pl, p) for z in spread]
            floor = {key: max(f[key] for f in floors) for key in floors[0]}
            d = step_dist(ks, pl, p)
            lr_p = float(pl[3])
            stated = {"update": K3_BF16_TOL, "m": K3_BF16_TOL, "v": K3_BF16_TOL, "pmax": 0.05 * lr_p}
            lim = {key: stated[key] + 3.0 * floor[key] for key in stated}
            lr_ok = float(ks[3]) in [lr_p] + [float(z[3]) for z in spread]
            fin = all(bool(torch.isfinite(t).all()) for t in nxt[:4])
            ok = fin and lr_ok and flips <= MAX_FLIPS and all(d[key] <= lim[key] for key in lim)
            max_flips = max(max_flips, flips)
            for key in ("update", "m", "v"):
                worst16[key] = max(worst16[key], d[key] / lim[key])
            worst16["pmax_lr"] = max(worst16["pmax_lr"], d["pmax"] / lr_p)
            if not ok:
                bad16.append(s)
            log(f"[6c] step {s:3d} mb {k:2d} bf16: " + ", ".join(
                f"{key} {d[key]:.3e} (limit {lim[key]:.3e}, spread {floor[key]:.3e})" for key in lim)
                + f"; lr {float(ks[3]):.6e} vs {lr_p:.6e}; rows on another branch {flips} (taken out, "
                f"with the row tiles' {taken}); {ok}")
            if s % STEP_CHECK_STRIDE == 0:
                used32, flips32, _ = neutralize_flips(one32, p, sl(bufs32, k), 0, plain_variants(one32))
                ok32, _, share32, leaf32, _ = f32_step_check(one32, (p, m, v, cnt, lr), used32,
                                                             f"6c GR1T1 step {s} mb {k}")
                ok32 = ok32 and flips32 <= MAX_FLIPS
                if share32 > worst32["share"]:
                    worst32.update(share=share32, leaf=leaf32)
                max_flips32 = max(max_flips32, flips32)
                if not ok32:
                    bad32.append(s)
        p, m, v, lr = nxt[0], nxt[1], nxt[2], nxt[3]
    log(f"[6c] {len(sampled)} bf16 steps checked, worst share of the limit: "
        + ", ".join(f"{key} {val:.3f}" for key, val in worst16.items() if key != "pmax_lr")
        + f"; largest param diff {worst16['pmax_lr']:.2f} x LR; at most {max_flips} rows on another branch "
        f"of the loss (limit {MAX_FLIPS}); failed at steps {bad16}")
    log(f"[6c] {len([s for s in sampled if s % STEP_CHECK_STRIDE == 0])} f32 steps checked leaf by leaf, worst "
        f"{worst32['share']:.3f} of a limit (in {worst32['leaf']}); at most {max_flips32} rows on another branch "
        f"of the loss; failed at steps {bad32}")
    if bad16:
        fail(f"6c: the kernel's bf16 step disagrees with the plain version's at steps {bad16}")
    if bad32:
        fail(f"6c: the kernel's f32 step disagrees with the plain version's at steps {bad32}")
    k3_err["bfloat16_step"] = worst16["pmax_lr"]

    whole = fused16.update_scan(*args0, bufs16)
    same_as_composition(whole, (p, m, v, lr), steps, "GR1T1")
    return whole


def same_as_composition(whole, composed, steps, tag):
    """6c's last check: a whole-update call's (p, m, v, LR) equal those of
    the composition of its ``steps`` one-step calls, bit for bit."""
    import torch

    torch.cuda.synchronize()
    same = {name: bool(torch.equal(a.reshape(-1), b.reshape(-1)))
            for name, a, b in zip(("p", "m", "v", "lr"), whole[:4], composed)}
    log(f"[6c] {tag}: whole {steps}-step update vs the composition of its {steps} one-step calls, "
        f"bit for bit: {same}; lr {float(whole[3]):.6e} vs {float(composed[3]):.6e}")
    if not all(same.values()):
        fail(f"6c ({tag}): the whole update differs from its one-step composition: {same}")


def k3_fused_check(fused, state, bufs, mb, s, tag, nan=None):
    """Phase 6d. K3's fused step (``k3_step``: one cooperative launch, the
    main path's) against PR 2's two-launch step (``k3_step_ref``: k3_norm +
    k3_adam, its reference) on K2's gradient of minibatch ``mb`` at the
    params of ``state`` = (p, m, v, count, lr), as grad step ``s`` of an
    update: bit for bit in p, m, v, g, the LR/metric state slots, the
    partial sums and the step record (NaN lanes by bit pattern). ``nan``:
    "grad" sets one gradient entry and the surrogate sum to NaN (a NaN row:
    the NaN-loss path), "loss" the surrogate sum alone (ok = 0 with a finite
    gradient). Returns the count of differing words."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import fused_update

    p, m, v, count, lr = state
    args, keep = fused._k2_context(p, bufs)
    fused._k2_launch(fused_update._lib("k2"), args, mb, p.device)
    if nan == "grad":
        keep["g"][keep["g"].numel() // 2] = float("nan")
    if nan in ("grad", "loss"):
        keep["aux"][0] = float("nan")
    out = {name: fused_update.k3_step_once(fused, p, m, v, keep["g"], keep["aux"], count, lr, s,
                                           reference=name == "reference")
           for name in ("fused", "reference")}
    torch.cuda.synchronize()
    bits = lambda t: t.reshape(-1).view(torch.int32)
    f, r = out["fused"], out["reference"]
    differ = {n: int((bits(f[n]) != bits(r[n])).sum()) for n in f}
    lr_in, lr_out = float(lr), float(f["state"][((s + 1) & 1) * 8])
    log(f"[6d] {tag}: fused step vs reference pair at step {s}, bit for bit: "
        + ", ".join(f"{n} {d}" for n, d in differ.items()) + f" differing words; lr {lr_in:.6e} -> "
        f"{lr_out:.6e}; ok {float(f['step'][0]):g}; NaN entries in p {int(torch.isnan(f['p']).sum())}; "
        f"|update| max {float((f['p'] - p).abs().nan_to_num(0.0).max()):.3e}")
    total = sum(differ.values())
    if total:
        fail(f"6d ({tag}): K3's fused step differs from its reference pair in {differ}")
    return total


def adam_yardstick(n, dev):
    """A yardstick for K3's step that the port never calls: PyTorch's fused
    Adam (``torch.optim.Adam(fused=True, capturable=True)``) after
    ``clip_grad_norm_(foreach=True)`` on one ``n``-entry f32 vector,
    captured once in a CUDA graph and timed by its replays (CUDA events).
    Not the same function: it lacks K3's loss finalisation, LR rule and
    bias correction."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    p = torch.nn.Parameter(0.1 * torch.randn(n, generator=gen, device=dev))
    p.grad = torch.randn(n, generator=gen, device=dev)
    opt = torch.optim.Adam([p], lr=1e-4, fused=True, capturable=True)

    def step():
        torch.nn.utils.clip_grad_norm_([p], 1.0, foreach=True)
        opt.step()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # the optimizer's state is made outside the capture
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    ms = cuda_ms(graph.replay, reps=50, warmup=3)
    del graph, opt, p
    return ms


def learner_setups(runner, rs, batch, task, dev):
    """K2/K3's inputs from one rollout buffer of ``runner`` (``task``'s
    training config): GAE, the block shuffle, and for each operand type (the
    config's bf16 storage, and float32) the ``FusedPPOGrad`` and its
    minibatch buffers. A minibatch holds the whole blocks of
    ``shuffle_block`` envs at one step that the buffer's steps x envs split
    into the config's minibatches give (10,480 rows at 4096 envs, 20,960 at
    8192). Returns {type name: (fused, buffers)}."""
    import torch

    from wiki_grx_gym_tpu_torch.learn.ppo import PPO

    alg, net = runner.alg, runner.net
    t_len, n = batch.rewards.shape
    with torch.no_grad():
        last = net.evaluate(rs.critic_obs)
    returns, adv = alg.compute_returns(batch, last)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    perm = alg.draw_perm(t_len, n, gen, dev)
    cfg32 = copy.deepcopy(runner.alg_cfg)
    cfg32.storage_dtype = "float32"
    algs = {"bfloat16": alg, "float32": PPO(net, cfg32)}
    setups = {}
    for name, a in algs.items():
        w, f, mb_rows = a._pack_shuffle(batch, returns, adv, perm)
        fused = a._get_fused(mb_rows)
        setups[name] = (fused, fused.split_buffers(w, f, batch.obs.shape[-1]))
    fused16 = setups["bfloat16"][0]
    log(f"[ppo {task}] buffer: {t_len} steps x {n} envs, {alg.num_mini_batches} minibatches of {fused16.rows} "
        f"rows, {alg.num_learning_epochs} epochs, path {alg.path}; widths obs {fused16.obs_dim}, critic obs "
        f"{fused16.cobs_dim}, actions {fused16.act_dim}, {net.num_params} params")
    block = alg.shuffle_block
    rows = t_len * (n // block) // alg.num_mini_batches * block
    assert fused16.rows == rows and fused16.op_dtype == torch.bfloat16, (fused16.rows, rows)
    return setups


def k2_check(setups, net, alg, p, at, k2_err, tag=""):
    """Phase 5: K2 against its plain version (``FusedPPOGrad.grads_plain``)
    at params ``p``, for each operand type, on the first and last
    minibatch; rows on another branch of the loss are taken out of both
    (``neutralize_flips``). The largest leaf difference per type goes into
    ``k2_err``. A planted fault must fail: K2's gradient with one leaf
    scaled by ``FAULT_SCALE`` fails that leaf's limit, for every leaf."""
    import torch

    for name, (fused, bufs) in setups.items():
        loss_tol, rtol, atol_frac = K2_TOL[name]
        ok = True
        A = fused.act_dim
        if name == "bfloat16":
            same = pack_check(fused, p, bufs)
            ok &= same
            log(f"[K2 vs plain]{tag} {at} pack_params' bf16 weights equal pack_weights' bit for bit: {same}")
        for mb in (0, alg.num_mini_batches - 1):
            # rows that K2 and its plain version send down different
            # branches of the loss are taken out of both (counted)
            used, flips, _ = neutralize_flips(fused, p, bufs, mb)
            ok &= flips <= MAX_FLIPS
            log(f"[K2 vs plain]{tag} {at} {name} mb {mb:2d}: {flips} rows take another branch of the loss "
                f"in K2 than in the plain version (limit {MAX_FLIPS}); taken out of both")
            lk, gk, ak = fused.grads(p, used, mb)
            lp, gp, ap = fused.grads_plain(p, used, mb)
            torch.cuda.synchronize()
            adv_scale = float(bufs["fscal"][mb][:, 3 * A + 3].abs().mean())
            extra = {"loss": adv_scale, "surrogate_loss": adv_scale, "value_loss": 0.0,
                     "kl": 4.0 * A * 2.0**-24 / loss_tol}
            line = []
            for key, x, y in [("loss", lk, lp)] + [(k, ak[k], ap[k]) for k in ak]:
                x, y = float(x), float(y)
                lim = loss_tol * (abs(y) + extra[key])
                good = abs(x - y) <= lim and math.isfinite(x)
                ok &= good
                line.append(f"{key} {x:.6e} vs {y:.6e} |diff| {abs(x - y):.2e} (limit {lim:.2e}) {good}")
            worst = 0.0
            diffs = leaf_diffs(net, gk, gp)
            uncaught = []
            for (leaf, d, scale), (_, off, shape) in zip(diffs, net.layout):
                lim = rtol * scale + atol_frac * scale
                good = d <= lim and math.isfinite(d)
                ok &= good
                worst = max(worst, d / max(scale, 1e-30))
                n = math.prod(shape)
                fault = float((FAULT_SCALE * gk[off: off + n] - gp[off: off + n]).abs().max())
                if not fault > lim:
                    uncaught.append(leaf)
                log(f"[K2 vs plain]{tag} {at} {name:8s} mb {mb:2d} {leaf:16s} max|diff| {d:.3e} "
                    f"(leaf max {scale:.3e}, {d / max(scale, 1e-30):.2e} of it; limit {lim:.3e}; x{FAULT_SCALE} "
                    f"fault {fault:.3e}, caught {fault > lim}) {good}")
            log(f"[K2 vs plain]{tag} {at} {name} mb {mb}: " + "; ".join(line) +
                f"; largest leaf diff {worst:.2e} of the leaf's max")
            if uncaught:
                fail(f"K2{tag} ({at}, {name}, mb {mb}): a leaf's gradient scaled by {FAULT_SCALE} passes its "
                     f"limit in {uncaught}")
            k2_err[name] = max(k2_err.get(name, 0.0), max(d for _, d, _ in diffs))
        if not ok:
            fail(f"K2{tag} disagrees with its plain version ({name} operands, {at})")


def k3_fault(one, state, bufs, want, leaf):
    """A planted fault for a one-step check of K3: K3's fused step
    (``k3_step_once``) fed K2's gradient of ``bufs`` with the leaf ``leaf``
    scaled by ``FAULT_SCALE``, from ``state`` = (p, m, v, count, lr).
    Returns its distances to the plain step ``want``, leaf by leaf
    (``leaf_dists``), which the check's limits must catch. (A scale of the
    whole gradient is no such fault: the norm clip takes it out.)"""
    from wiki_grx_gym_tpu_torch.learn import fused_update

    p, m, v, count, lr = state
    args, keep = one._k2_context(p, bufs)
    one._k2_launch(fused_update._lib("k2"), args, 0, p.device)
    _, off, shape = next(e for e in one.net.layout if e[0] == leaf)
    g = keep["g"].clone()
    g[off: off + math.prod(shape)] *= FAULT_SCALE
    r = fused_update.k3_step_once(one, p, m, v, g, keep["aux"], count, lr, 0)
    return leaf_dists(one.net, (r["p"], r["m"], r["v"]), want, p)


def k3_steps_f32(setups, args0, tag):
    """Phase 9's check of K3 at a width: one float32 epoch driven by the
    kernel one grad step at a time (a one-step ``FusedPPOGrad`` fed
    minibatch s's slice, Adam count ``count0 + s`` and the LR the kernel
    carried out of step s - 1); at every 4th step and the last the plain
    version runs the same step from the kernel's state, rows on another
    branch of the loss taken out of both (``neutralize_flips``, with the
    row tiles' own), and the step is held leaf by leaf (``f32_step_check``:
    each leaf's update, m and v within ``F32_STEP_TOL`` in L2 plus 3x the
    plain version's own spread in that leaf over row tiles, the same LR; K3
    fed a gradient off by ``FAULT_SCALE`` in its largest leaf and in
    ``std`` must fail those limits). Over a whole
    epoch two correct trajectories part further, so the epoch's distance to
    the plain version's epoch is printed, not checked. Returns the kernel's
    state after the epoch and the largest |param| difference of a checked
    step."""
    import torch

    fused32, bufs32 = setups["float32"]
    one = one_step(fused32)
    sl = lambda k: {key: x[k:k + 1] for key, x in bufs32.items()}
    p, m, v, count0, lr = args0
    mbs = fused32.num_mini_batches
    worst, bad, max_flips = {"share": 0.0, "leaf": None, "pmax": 0.0}, [], 0
    for s in range(mbs):
        nxt = one.update_scan(p, m, v, count0 + s, lr, sl(s))
        if s % 4 == 0 or s == mbs - 1:
            used, flips, taken = neutralize_flips(one, p, sl(s), 0, plain_variants(one))
            ok, k, share, leaf, pmax = f32_step_check(one, (p, m, v, count0 + s, lr), used,
                                                      f"{tag} step {s} (rows on another branch {flips}, taken "
                                                      f"out with the row tiles' {taken})")
            ok = ok and flips <= MAX_FLIPS and all(bool(torch.isfinite(t).all()) for t in k[:4])
            max_flips = max(max_flips, flips)
            if share > worst["share"]:
                worst.update(share=share, leaf=leaf)
            worst["pmax"] = max(worst["pmax"], pmax)
            if not ok:
                bad.append(s)
        p, m, v, lr = nxt[0], nxt[1], nxt[2], nxt[3]
    f1 = copy.copy(fused32)
    f1.num_epochs = 1
    whole = f1.update_scan_plain(*args0, bufs32)
    nrm = lambda t: float(torch.linalg.vector_norm(t))
    log(f"[K3 steps] {tag} worst of the checked steps: {worst['share']:.3f} of a leaf's limit (in {worst['leaf']}), "
        f"largest param diff {worst['pmax']:.3e}; at most {max_flips} rows on another branch; failed at steps {bad}; "
        f"the kernel's epoch against the plain "
        f"version's (printed, not checked): update {nrm(p - whole[0]) / nrm(whole[0] - args0[0]):.3e}, "
        f"m {nrm(m - whole[1]) / nrm(whole[1]):.3e} in L2")
    if bad:
        fail(f"K3 {tag}: the kernel's f32 step disagrees with the plain version's at steps {bad}")
    return p, m, v, lr, worst["pmax"]


def composition_check(fused, bufs, args0, tag, epochs=1):
    """6c's last check over ``epochs`` epochs (``same_as_composition``): the
    update's CUDA graph for them (every minibatch once an epoch, adaptive LR
    on) against its one-step calls, step s fed minibatch s % MB's slice,
    Adam count ``count0 + s`` and the LR of the step before."""
    one = one_step(fused)
    mbs = fused.num_mini_batches
    p, m, v, count0, lr = args0
    for s in range(epochs * mbs):
        k = s % mbs
        p, m, v, lr = one.update_scan(p, m, v, count0 + s, lr, {key: x[k:k + 1] for key, x in bufs.items()})[:4]
    f1 = copy.copy(fused)
    f1.num_epochs = epochs
    same_as_composition(f1.update_scan(*args0, bufs), (p, m, v, lr), epochs * mbs, tag)


def ppo_phases(runner, rs, batch, dev):
    """Phases 5, 6 and 8's kernel timings: K2 and K3 against their plain
    versions on the phase-4 rollout buffer. Returns the K2 and K3 rows of
    the kernels' JSON line (launches filled in from the training run)."""
    import torch

    from wiki_grx_gym_tpu_torch import build as kbuild
    from wiki_grx_gym_tpu_torch.learn import fused_update

    alg = runner.alg
    net = runner.net
    p0 = net.params_flat.clone()
    setups = learner_setups(runner, rs, batch, "GR1T1", dev)
    fused16, bufs16 = setups["bfloat16"]
    rows = fused16.rows

    # ---- phase 5: K2 vs plain ----
    k2_err = {}
    gemm_worst = gemm_checks(fused16, dev)
    k2_check(setups, net, alg, p0, "at p0", k2_err)

    # ---- phase 6: K3 vs plain ----
    steps = alg.num_learning_epochs * alg.num_mini_batches
    st0 = alg.init(p0.clone())
    args0 = (st0.params, st0.m, st0.v, st0.count, st0.learning_rate)
    nrm = lambda x: float(torch.linalg.vector_norm(x))
    mkeys = ("value_loss", "surrogate_loss", "kl")

    def dist(x, y):
        """Distances of two update_scan results: update (final minus
        initial params), m and v as shares of y's in L2; largest |param|
        difference; |difference| of each metric mean."""
        d = {"update": nrm(x[0] - y[0]) / nrm(y[0] - p0), "m": nrm(x[1] - y[1]) / nrm(y[1]),
             "v": nrm(x[2] - y[2]) / nrm(y[2]), "pmax": float((x[0] - y[0]).abs().max())}
        d.update({k: abs(float(x[4][k]) - float(y[4][k])) for k in mkeys})
        return d

    def report(tag, k, pl, d, lim):
        good = all(math.isfinite(v) and v <= lim[key] for key, v in d.items()) and \
            all(bool(torch.isfinite(t).all()) for t in k[:3])
        log(f"[K3 vs plain] {tag}: " + ", ".join(f"{key} {d[key]:.3e} (limit {lim[key]:.3e})" for key in d)
            + f"; lr {float(k[3]):.6e} vs {float(pl[3]):.6e}; metrics "
            + ", ".join(f"{key} {float(k[4][key]):.6e} vs {float(pl[4][key]):.6e}" for key in mkeys)
            + f"; {good}")
        return good

    # 6a: float32 operands, one epoch (every minibatch once): the
    # trajectories stay at float32 summation noise, so the check is sharp
    fused32, bufs32 = setups["float32"]
    f1 = copy.copy(fused32)
    f1.num_epochs = 1
    k = f1.update_scan(*args0, bufs32)
    pl = f1.update_scan_plain(*args0, bufs32)
    torch.cuda.synchronize()
    A = fused32.act_dim
    adv_scale = float(bufs32["fscal"][..., 3 * A + 3].abs().mean())
    d = dist(k, pl)
    lim = {"update": 1e-4, "m": 1e-4, "v": 1e-4, "pmax": 0.05 * float(pl[3]),
           "value_loss": 1e-5 * abs(float(pl[4]["value_loss"])),
           "surrogate_loss": 1e-5 * (abs(float(pl[4]["surrogate_loss"])) + adv_scale),
           "kl": 1e-5 * abs(float(pl[4]["kl"])) + 4.0 * A * 2.0**-24}
    good = report(f"float32, {f1.num_mini_batches} steps", k, pl, d, lim)
    good &= abs(float(k[3]) - float(pl[3])) <= 1e-6 * abs(float(pl[3]))
    k3_err = {"float32": d["pmax"]}
    if not good:
        fail("K3 disagrees with its plain version (float32 operands, one epoch)")

    # phase 5 again, at the params after that epoch: rows clip and the KL
    # is more than its constant, so K2's clip and tie branches are compared
    p1 = pl[0]
    share = [clip_shares(fused32, p1, bufs32, mb) for mb in (0, alg.num_mini_batches - 1)]
    log("[K2 vs plain] after one epoch: rows outside the ratio clip range "
        + ", ".join(f"{100 * r:.2f}%" for r, _ in share) + "; outside the value clip range "
        + ", ".join(f"{100 * v:.2f}%" for _, v in share) + " (minibatches 0, last)")
    k2_check(setups, net, alg, p1, "after one epoch", k2_err)
    log(f"[K2 vs plain] largest |diff| bf16 {k2_err['bfloat16']:.3e}, f32 {k2_err['float32']:.3e}")

    # 6d: K3's fused step against its reference pair, bit for bit, on K2's
    # bf16 gradient at full width
    last = alg.num_mini_batches - 1
    state1 = (p1, pl[1], pl[2], st0.count + alg.num_mini_batches, pl[3])
    k3_differ = (k3_fused_check(fused16, args0, bufs16, 0, 0, "at p0")
                 + k3_fused_check(fused16, state1, bufs16, last, 1, "after one epoch")
                 + k3_fused_check(fused16, state1, bufs16, 0, 2, "NaN gradient entry and loss", nan="grad")
                 + k3_fused_check(fused16, state1, bufs16, 0, 3, "NaN loss, finite gradient", nan="loss"))

    # 6b: bf16 operands (the main path's type), one epoch at a fixed LR,
    # against the plain version and the plain version's own spread over a
    # change of its row tile (the order of its sums)
    f1 = copy.copy(fused16)
    f1.num_epochs = 1
    f1.adaptive_lr = False
    k = f1.update_scan(*args0, bufs16)
    pl = f1.update_scan_plain(*args0, bufs16)
    spread = []
    for fz in plain_variants(f1):
        spread.append(fz.update_scan_plain(*args0, bufs16))
    torch.cuda.synchronize()
    floors = [dist(z, pl) for z in spread]
    floor = {key: max(f[key] for f in floors) for key in floors[0]}
    log(f"[K3 vs plain] bf16 plain version against itself with row tiles "
        + ", ".join(map(str, K3_FLOOR_TILES)) + ": " + ", ".join(f"{key} {v:.3e}" for key, v in floor.items())
        + "; lr " + ", ".join(f"{float(z[3]):.6e}" for z in spread))
    d = dist(k, pl)
    lr_p = float(pl[3])
    stated = {"update": K3_BF16_TOL, "m": K3_BF16_TOL, "v": K3_BF16_TOL, "pmax": 0.05 * lr_p,
              **{key: 1e-3 * abs(float(pl[4][key])) for key in mkeys}}
    lim = {key: stated[key] + 3.0 * floor[key] for key in stated}
    good = report(f"bfloat16, {f1.num_mini_batches} steps (limits: stated + 3 x the plain version's spread)",
                  k, pl, d, lim)
    # params move by at most about LR a step: the largest param difference
    # in units of the final LR x steps
    log(f"[K3 vs plain] bfloat16 largest param diff {d['pmax'] / (lr_p * f1.num_mini_batches):.3e} "
        f"(limit {lim['pmax'] / (lr_p * f1.num_mini_batches):.3e}) x the final LR x {f1.num_mini_batches} steps")
    lr_good = float(k[3]) == lr_p == float(st0.learning_rate)
    k3_err["bfloat16"] = d["pmax"]
    if not (good and lr_good):
        fail("K3 disagrees with its plain version (bf16 operands, one epoch)")

    # 6c: the whole bf16 update (adaptive LR on), step by step from the
    # kernel's own state, and that update against the whole-update call
    whole_k = whole_update_check(fused16, fused32, bufs16, bufs32, args0, k3_err)

    # ---- phase 8 (timing): K2 per grad step, K3 per update, and their plain versions ----
    lib2, lib3 = fused_update._lib("k2"), fused_update._lib("k3")
    args16, keep = fused16._k2_context(p0, bufs16)
    stream = torch.cuda.current_stream().cuda_stream

    def k2_launch():
        fused16._k2_launch(lib2, args16, 0, dev)

    k2_ms = cuda_ms(k2_launch, reps=50, warmup=3)
    k2_plain_ms = cuda_ms(lambda: fused16.grads_plain(p0, bufs16, 0), reps=3, warmup=1)
    k2_launch_ms = k2_launch_profile(k2_launch)
    # K3's optimizer step alone, on K2's gradient (copies of the state): the
    # fused step (the main path's) and its reference pair, in the same call
    p3, m3, v3 = p0.clone(), st0.m.clone(), st0.v.clone()   # the struct points into these
    b3 = fused16._k3_context(p3, m3, v3, keep)
    keep["count0"].copy_(st0.count.reshape(1))
    keep["state"][0] = keep["state"][8] = st0.learning_rate
    k3_calls = [0]

    def k3_launcher(step):
        def launch():
            fused_update._check(step(ctypes.addressof(b3), k3_calls[0] & 1, stream), "K3 step")
            k3_calls[0] += 1
        return launch

    fused_step, ref_pair = k3_launcher(lib3.k3_step), k3_launcher(lib3.k3_step_ref)
    k3_step_ms = cuda_ms(fused_step, reps=50, warmup=2)
    k3_ref_ms = cuda_ms(ref_pair, reps=50, warmup=2)
    k3_turns = {"reference": cuda_ms(ref_pair, reps=50, warmup=1), "fused": cuda_ms(fused_step, reps=50, warmup=1)}
    log(f"[K3 step] fused step {k3_step_ms:.5f} ms, then {k3_turns['fused']:.5f} ms; reference pair "
        f"{k3_ref_ms:.5f} ms, then {k3_turns['reference']:.5f} ms (CUDA events, 50 steps each)")
    if not (k3_step_ms < k3_ref_ms and k3_turns["fused"] < k3_turns["reference"]):
        fail(f"K3's fused step ({k3_step_ms:.5f}, {k3_turns['fused']:.5f} ms) is not faster than its "
             f"reference pair ({k3_ref_ms:.5f}, {k3_turns['reference']:.5f} ms)")
    library_ms = cublas_yardstick(fused16, dev)
    adam_ms = adam_yardstick(net.num_params, dev)
    args = (st0.params, st0.m, st0.v, st0.count, st0.learning_rate, bufs16)
    ctx = fused16.update_graph(dev, bufs16)   # captured by 6c's whole-update call
    log(f"[K3 graph] {steps}-step update captured in {ctx.capture_ms:.1f} ms, instantiated in "
        f"{ctx.instantiate_ms:.1f} ms (once per process and shape); kernel nodes {ctx.nodes['kernels']}, "
        f"cooperative {ctx.nodes['cooperative']}")
    if ctx.nodes["cooperative"] != steps:
        fail(f"the update's graph holds {ctx.nodes['cooperative']} cooperative kernel nodes, not {steps}")
    whole = [whole_k]
    k3_ms = cuda_ms(lambda: fused16.update_scan(*args), reps=5, warmup=1)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused16.update_scan(*args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    k3_plain_ms = cuda_ms(lambda: whole.append(fused16.update_scan_plain(*args)), reps=1, warmup=0)
    del keep, b3, p3, m3, v3
    d = dist(*whole)
    log(f"[K3 vs plain] bf16 whole update, {steps} steps (printed, not checked: correct runs drift apart; "
        f"6c checks it step by step): " + ", ".join(f"{key} {v:.3e}" for key, v in d.items())
        + f"; lr {float(whole[0][3]):.6e} vs {float(whole[1][3]):.6e}")
    if not all(bool(torch.isfinite(t).all()) for t in whole[0][:4]):
        fail(f"K3's whole {steps}-step update is not finite")
    ops, nbytes = k2_work(fused16, 2)
    k2_bound_tc = max(ops / BF16_TC_PEAK, nbytes / HBM_RATE) * 1e3
    k2_bound_fp32 = max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3
    P = net.num_params
    opt_bytes = 7 * 4 * P
    k3_ops = steps * ops
    k3_bytes = (alg.num_mini_batches * nbytes - alg.num_mini_batches * 2 * P * 4) + 6 * 4 * P
    k3_bound_tc = max(k3_ops / BF16_TC_PEAK, k3_bytes / HBM_RATE) * 1e3
    k3_bound_fp32 = max(k3_ops / FP32_PEAK, k3_bytes / HBM_RATE) * 1e3
    log(f"[K2] {k2_ms:.4f} ms per grad step ({rows} rows, bf16 operands, tensor cores; PR 2's SIMT chain "
        f"2.71-2.73 ms); plain {k2_plain_ms:.3f} ms; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; bound "
        f"{k2_bound_tc:.4f} ms at the bf16 tensor-core peak ({100 * k2_bound_tc / k2_ms:.1f}% of it reached), "
        f"{k2_bound_fp32:.4f} ms at the FP32 peak; achieved {ops / (k2_ms * 1e-3) / 1e12:.2f} TFLOP/s; "
        f"cuBLAS yardstick (torch.matmul, the same {len(fused16.gemm_shapes())} products on bf16 operands, "
        f"GEMMs only, one CUDA graph replay) {library_ms:.4f} ms")
    log(f"[K3] {k3_ms:.3f} ms per update ({steps} steps, one graph replay); plain {k3_plain_ms:.1f} ms; "
        f"bound {k3_bound_tc:.3f} ms (bf16 tensor cores), "
        f"{k3_bound_fp32:.3f} ms (FP32); optimizer step {k3_step_ms:.5f} ms alone (reference pair "
        f"{k3_ref_ms:.5f} ms), its bytes {opt_bytes / 1e6:.2f} MB = {opt_bytes / HBM_RATE * 1e6:.2f} us at "
        f"{HBM_RATE / 1e12} TB/s ({100 * opt_bytes / HBM_RATE * 1e3 / k3_step_ms:.1f}% of it reached); Adam "
        f"yardstick (torch fused Adam + clip_grad_norm_, one CUDA graph replay, not the same function) "
        f"{adam_ms:.5f} ms")
    dev_ms = steps * (k2_ms + k3_step_ms)
    log(f"[K3] update wall time (host clock to a synchronize) " + ", ".join(f"{w:.2f}" for w in walls)
        + f" ms vs {steps} x (K2 {k2_ms:.4f} + K3 step {k3_step_ms:.4f}) = {dev_ms:.2f} ms of kernel time: "
        + ("the host keeps up" if min(walls) <= 1.1 * dev_ms else "host-bound (the card waits for launches)"))
    k2_row = {
        "name": "K2 PPO minibatch loss + gradients (GR1T1, 10480 rows, bf16 operands)",
        "route": "cuda", "source": "wiki_grx_gym_tpu_torch/csrc/ppo_grads.cu",
        "replaces": "wiki_grx_gym_tpu/learn/fused_update.py:348",
        "launches": None, "max_abs_err": k2_err["bfloat16"], "max_abs_err_f32": k2_err["float32"],
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_tc, "bound_by": "operations",
        "bound_ms_fp32": k2_bound_fp32, "library_ms": library_ms,
        "library": "torch.matmul (cuBLAS) of the same bf16 products, GEMMs only, one CUDA graph replay; "
                   "not used by the port",
        "gflop": ops / 1e9, "bytes": nbytes, "kernel_launches_per_grad_step": None,
        "launch_ms": k2_launch_ms, "hgmma_in_sass": HGMMA_COUNT[0], "gemm_err_share_of_limit": gemm_worst,
        "build_s": kbuild.BUILD_INFO["k2_ppo_grads"].get("seconds"),
        "ptxas": kbuild.BUILD_INFO["k2_ppo_grads"].get("ptxas", []),
    }
    k3_row = {
        "name": "K3 whole PPO update (8 x 25 K2 steps + clip/Adam/adaptive LR, GR1T1)",
        "route": "cuda", "source": "wiki_grx_gym_tpu_torch/csrc/ppo_update.cu",
        "replaces": "wiki_grx_gym_tpu/learn/fused_update.py:511",
        "launches": None, "max_abs_err": k3_err["bfloat16"], "max_abs_err_f32": k3_err["float32"],
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_tc, "bound_by": "operations",
        "bound_ms_fp32": k3_bound_fp32, "library_ms": None, "optimizer_step_alone_ms": k3_step_ms,
        "ms_reference_pair": k3_ref_ms, "ms_in_turns": k3_turns,
        "optimizer_step_bound_ms": opt_bytes / HBM_RATE * 1e3, "adam_yardstick_ms": adam_ms,
        "adam_yardstick": "torch.optim.Adam(fused=True, capturable=True) + clip_grad_norm_(foreach=True) on "
                          "one f32 vector of the params' size, one CUDA graph replay; not the same function, "
                          "not used by the port",
        "barrier": K3_BARRIER, "fused_vs_reference_differing_words": k3_differ,
        "update_wall_ms": walls, "update_kernel_ms": dev_ms,
        "graph_capture_ms": ctx.capture_ms, "graph_instantiate_ms": ctx.instantiate_ms,
        "graph_kernel_nodes": ctx.nodes, "host_launches_per_update": None,
        "kernel_launches_per_update": None,
        "build_s": kbuild.BUILD_INFO["k3_ppo_update"].get("seconds"),
        "ptxas": kbuild.BUILD_INFO["k3_ppo_update"].get("ptxas", []),
    }
    return k2_row, k3_row


def train_phase(dev, task="GR1T1", mutate=None, iters=TRAIN_ITERS, profiled=True):
    """Phase 7: ``learn(iters)`` on ``task``'s training config (``mutate``
    applied) at 4096 envs through the entry points a user calls; the launch
    counts are set to 0 just before and read just after; every loss and
    every reward term's episode mean must be finite. On terrain the
    final state's ground planes and measured heights must be finite and
    non-zero in some envs on the rough rows (levels above 0). ``profiled``:
    one more iteration under torch.profiler."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry

    name = task if mutate is None else f"{task}_{mutate.__name__}"
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    if mutate is not None:
        mutate(cfg)
    t0 = time.perf_counter()
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    make_s = time.perf_counter() - t0
    runner, train_cfg = task_registry.make_alg_runner(
        env, task, train_cfg=train_cfg, log_root=os.path.join(THIS, "build", "smoke_train", name))
    assert runner.alg.path == "mega"
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = runner.learn(iters, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    terrain = None
    if env.terrain is not None:
        es = state.env_state
        rough = es.terrain_levels > 0
        gp, mh = es.ground_plane, es.measured_cache
        terrain = {"env_build_s": make_s, "terrain_mode": env.terrain_mode, "rough_envs": int(rough.sum()),
                   "rough_envs_nonzero_planes": int((gp[rough] != 0).any(-1).any(-1).sum()),
                   "rough_envs_nonzero_measured": int((mh[rough] != 0).any(-1).sum()),
                   "planes_finite": bool(torch.isfinite(gp).all()), "measured_finite": bool(torch.isfinite(mh).all()),
                   "mean_terrain_level": float(es.terrain_levels.float().mean())}
        log(f"[train {name}] env with its {env.terrain.shape[0]} x {env.terrain.shape[1]} terrain built in "
            f"{make_s:.2f} s; after learn: {terrain}")
        if not (terrain["planes_finite"] and terrain["measured_finite"] and terrain["rough_envs_nonzero_planes"]
                and terrain["rough_envs_nonzero_measured"]):
            fail(f"{name}: the ground planes or measured heights are not finite, or zero on every rough row: {terrain}")
    want = {"k1": iters * ROLLOUT_STEPS + 1, "k2": iters * steps, "k3": iters}
    if launches != want:
        fail(f"{name}: training launched {launches}, expected {want}")
    for h in runner.log_history:
        m = h["metrics"]
        if not all(math.isfinite(m[k]) for k in ("value_loss", "surrogate_loss", "kl", "lr")):
            fail(f"iteration {h['it']}: non-finite losses {m}")
        episode = {k: v for k, v in m.items() if k.startswith("episode/")}
        if len(episode) < len(env.all_reward_names) or not all(math.isfinite(v) for v in episode.values()):
            fail(f"{name} iteration {h['it']}: a reward term's episode mean is missing or not finite: {episode}")
        log(f"[train {name}] it {h['it']}: {h['elapsed_s']:.3f} s = collection {h['collection_s']:.3f} s + "
            f"update {h['update_s']:.3f} s "
            f"(+ {h['elapsed_s'] - h['collection_s'] - h['update_s']:.3f} s "
            f"host); {h['fps']:.0f} env-steps/s; value loss {m['value_loss']:.4f}, surrogate "
            f"{m['surrogate_loss']:.5f}, kl {m['kl']:.5f}, lr {m['lr']:.3e}, reward {m['mean_step_reward']:.4f}")
    ck = os.path.join(runner.log_dir, f"model_{iters}.pt")
    loaded = runner.load(ck).ppo
    same = all(getattr(loaded, k).dtype == getattr(state.ppo, k).dtype
               and torch.equal(getattr(loaded, k), getattr(state.ppo, k))
               for k in ("params", "m", "v", "count", "learning_rate"))
    if not same:
        fail(f"checkpoint {ck} does not load back bit-identical")
    log(f"[train {name}] learn({iters}) in {wall:.2f} s; launches {launches}; peak memory {peak:.3f} GiB; "
        f"{os.path.basename(ck)} loads back bit-identical: {same}; {len(env.reward_names)} reward terms, episode "
        f"means finite")
    hist = runner.log_history
    result = {
        "launches": launches, "iters": iters, "envs": N_ENVS, "wall_s": wall, "peak_mem_gib": peak,
        "iteration_s": [h["elapsed_s"] for h in hist], "collection_s": [h["collection_s"] for h in hist],
        "update_s": [h["update_s"] for h in hist], "env_steps_per_s": [h["fps"] for h in hist],
        "profile": None, "terrain": terrain, "reward_terms": len(env.reward_names),
    }
    if not profiled:
        return result

    # where an eager iteration's time goes: one more under torch.profiler
    # (after the launch counts were read; the profiler slows the host side).
    # learn ran the compiled iteration; the profiled one is the eager
    # ``iteration``, whose update graph is captured first, unprofiled
    # (phase 19 profiles the compiled one)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if runner.eager_reason is None:
        runner.iteration(state)
        torch.cuda.synchronize()
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.iteration(state)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    grad_steps = LAUNCHES["k2"] - before["k2"]
    updates = LAUNCHES["k3"] - before["k3"]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    of = lambda names: [e for e in kern if any(n in e.key for n in names)]
    by = {g: sum(dev_us(e) for e in of(names)) / 1e3 for g, names in KERNEL_NAMES.items()}
    total_ms = sum(dev_us(e) for e in kern) / 1e3
    by["other"] = total_ms - sum(by.values())
    iter_ms = 1e3 * sum(h["elapsed_s"] for h in hist) / len(hist)
    # device launches of each kernel of K2's chain and K3's step in this iteration
    counts = {n: sum(e.count for e in of((n,))) for g in ("K2", "K3") for n in KERNEL_NAMES[g]}
    ref_counts = {n: sum(e.count for e in of((n,))) for n in K3_REFERENCE_NAMES}
    # the host's launch and copy calls inside the update (FusedPPOGrad.update_scan's range)
    events = prof.events()
    ranges = [e for e in events if e.name == "FusedPPOGrad.update_scan" and e.device_type == DeviceType.CPU]
    calls = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")
             and any(k in e.name for k in ("Launch", "Memcpy", "Memset"))]
    inside = [e.name for e in calls if any(r.time_range.start <= e.time_range.start
                                           and e.time_range.end <= r.time_range.end for r in ranges)]
    host = {name: inside.count(name) for name in sorted(set(inside))}
    graph_launches = host.get("cudaGraphLaunch", 0)
    nodes = [ctx.nodes for f in runner.alg._fused_cache.values() for ctx in f._graphs.values()]
    log(f"[train {name} profile] host calls inside {len(ranges)} update(s): {host or 'none seen'}; the update graph's "
        f"kernel nodes {nodes}")
    profile_out = {"wall_ms": prof_s * 1e3, "device_ms": total_ms, "by_kernel_ms": by,
                   "busy_share_of_unprofiled_iteration": total_ms / iter_ms,
                   "grad_steps": grad_steps, "updates": updates, "kernel_launches": counts,
                   "reference_pair_launches": ref_counts, "host_calls_in_update": host,
                   "graph_kernel_nodes": nodes, "kernel_launches_from": None,
                   "k2_kernel_launches_per_grad_step": None, "kernel_launches_per_update": None,
                   "host_launches_per_update": None}
    if len(ranges) != 1 or len(nodes) != 1:
        fail(f"the profiled iteration ran {len(ranges)} update(s) over {len(nodes)} update graph(s), not 1")
    elif host:
        profile_out["host_launches_per_update"] = graph_launches
        if graph_launches != 1:
            fail(f"the host issued {graph_launches} graph launches in the update, not 1")
    else:
        log(f"[train {name} profile] the profiler recorded no host launch call: host launches per update not measured")
    if any(ref_counts.values()):
        fail(f"the main path launched K3's reference pair: {ref_counts}")
    if total_ms > 0:
        log(f"[train {name} profile] one iteration under the profiler {prof_s * 1e3:.1f} ms wall; device kernels "
            f"{total_ms:.1f} ms in {sum(e.count for e in kern)} launches: "
            + ", ".join(f"{g} {v:.1f} ms" for g, v in by.items())
            + f"; device busy {100 * total_ms / iter_ms:.1f}% of the unprofiled iteration's {iter_ms:.1f} ms")
        k2n = sum(counts[n] for n in KERNEL_NAMES["K2"])
        k3n = sum(counts[n] for n in KERNEL_NAMES["K3"])
        log(f"[train {name} profile] {updates} update(s), {grad_steps} grad steps; device launches "
            + ", ".join(f"{n} {c}" for n, c in counts.items())
            + f": K2's chain {k2n / max(grad_steps, 1):g} a grad step, K3's step {k3n / max(grad_steps, 1):g}, "
            f"{(k2n + k3n) / max(updates, 1):g} an update")
        if by["K1"] == 0 and LAUNCHES["k1"] > before["k1"]:
            fail(f"the training profile attributes no device time to {KERNEL_NAMES['K1']} though K1 "
                 f"launched {LAUNCHES['k1'] - before['k1']} times")
        if k2n + k3n == 0 and grad_steps and len(nodes) == 1:
            # the profiler sees no kernel inside the graph: its kernel nodes stand for the launches
            log(f"[train {name} profile] the profiler saw no kernel of K2 or K3 inside the update's graph; the graph's "
                f"kernel nodes stand for its device launches: {nodes[0]}")
            k3n = nodes[0]["cooperative"]
            k2n = nodes[0]["kernels"] - k3n
            profile_out["kernel_launches_from"] = "graph kernel nodes"
        else:
            profile_out["kernel_launches_from"] = "profiler"
        if updates != 1 or grad_steps == 0 or k3n != grad_steps or k2n == 0 or k2n % grad_steps or (
                profile_out["kernel_launches_from"] == "profiler"
                and any(c == 0 or c % grad_steps for c in counts.values())):
            fail(f"the profiled iteration ran {updates} update(s) of {grad_steps} grad steps, "
                 f"but launched {counts} (K2 {k2n}, K3 {k3n})")
        elif k2n != K2_LAUNCHES_PER_STEP * grad_steps:
            fail(f"{name}: K2's chain launched {k2n / grad_steps:g} kernels a grad step, not {K2_LAUNCHES_PER_STEP}")
        else:
            profile_out["k2_kernel_launches_per_grad_step"] = k2n // grad_steps
            profile_out["kernel_launches_per_update"] = k2n + k3n
    else:
        log(f"[train {name} profile] the profiler saw no device time; device busy share and kernel "
            "launches not measured")
    return dict(result, profile=profile_out)


def lstm_phase(dev):
    """Phase 12: the recurrent task ``GR1T1_lstm`` (LSTM 256 ahead of the
    [512, 256, 128] heads, 1,333,397 parameters) at 4096 envs through the
    entry points a user calls: ``learn(2)`` with the launch counts set to 0
    just before and read just after (K1 64 an iteration and 1 for the
    initial step; K2 and K3 never: the recurrent update is autograd over
    the LSTM replay), finite losses and episode means, the LSTM weights and
    std moved, ``model_2.pt`` loaded back bit for bit. Then the replay
    check: one more rollout at the trained params, and
    ``joint_mean_value_seq`` over its stored batch from the memory at the
    rollout's start with the done resets must give the rollout's ``mu`` and
    ``values`` within ``REPLAY_TOL``; the same replay without the resets
    must not (the rollout must hold dones). Then 20 play steps of the
    stateful policy from the checkpoint (K1 21 launches) and its exported
    ``policy.npz`` (the LSTM keys). Under torch.profiler: one rollout and
    two grad steps of the update's shape (163 env columns each): device
    launches and time a
    grad step, and the device's busy share of an iteration estimated from
    them (rollout + 200 grad steps over the unprofiled iteration's wall
    time)."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    task = "GR1T1_lstm"
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    log_root = os.path.join(THIS, "build", "smoke_train", task)
    runner, train_cfg = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=log_root)
    net, alg = runner.net, runner.alg
    if not runner.recurrent or net.num_params != 1_333_397:
        raise SystemExit(f"{task}: recurrent {runner.recurrent}, {net.num_params} parameters")
    p0 = net.params_flat.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = runner.learn(TRAIN_ITERS, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {"k1": TRAIN_ITERS * ROLLOUT_STEPS + 1, "k2": 0, "k3": 0}
    if launches != want:
        fail(f"{task}: training launched {launches}, expected {want}")
    hist = runner.log_history
    for h in hist:
        m = h["metrics"]
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"{task} iteration {h['it']}: non-finite metrics {m}")
        log(f"[lstm] it {h['it']}: {h['elapsed_s']:.3f} s = collection {h['collection_s']:.3f} s + update "
            f"{h['update_s']:.3f} s (+ {h['elapsed_s'] - h['collection_s'] - h['update_s']:.3f} s host); "
            f"{h['fps']:.0f} env-steps/s; value loss {m['value_loss']:.4f}, surrogate {m['surrogate_loss']:.5f}, "
            f"kl {m['kl']:.5f}, lr {m['lr']:.3e}, reward {m['mean_step_reward']:.4f}")
    moved = {name: not torch.equal(p0[off: off + math.prod(shape)], state.ppo.params[off: off + math.prod(shape)])
             for name, off, shape in net.layout if name.startswith("memory") or name == "std"}
    if not all(moved.values()):
        fail(f"{task}: the LSTM weights or std did not move: {moved}")
    ck = os.path.join(runner.log_dir, f"model_{TRAIN_ITERS}.pt")
    loaded = runner.load(ck).ppo
    same = all(getattr(loaded, k).dtype == getattr(state.ppo, k).dtype
               and torch.equal(getattr(loaded, k), getattr(state.ppo, k))
               for k in ("params", "m", "v", "count", "learning_rate"))
    if not same:
        fail(f"{task}: {ck} does not load back bit-identical")
    log(f"[lstm] learn({TRAIN_ITERS}) in {wall:.2f} s; launches {launches}; peak memory {peak:.3f} GiB; "
        f"LSTM weights and std moved {moved}; {os.path.basename(ck)} loads back bit-identical: {same}")

    # the replay reproduces the rollout
    net.bind(state.ppo.params)
    hidden0 = state.hidden
    with torch.no_grad():
        rs, batch, _ = runner.rollout(state)
        n = batch.rewards.shape[1]
        done_prev = torch.cat([torch.zeros((1, n), device=dev), batch.dones[:-1].to(torch.float32)], dim=0)
        mean, value = net.joint_mean_value_seq(batch.obs, batch.critic_obs, done_prev, hidden0)
        mean0, value0 = net.joint_mean_value_seq(batch.obs, batch.critic_obs, torch.zeros_like(done_prev), hidden0)
    torch.cuda.synchronize()
    err = {"mu": float((mean - batch.mu).abs().max()), "values": float((value - batch.values).abs().max())}
    err0 = {"mu": float((mean0 - batch.mu).abs().max()), "values": float((value0 - batch.values).abs().max())}
    resets = int(batch.dones[:-1].sum())
    replay_ok = max(err.values()) <= REPLAY_TOL
    caught = max(err0.values()) > REPLAY_TOL
    log(f"[lstm replay] {ROLLOUT_STEPS} x {n}: the replay with the done resets against the rollout's mu and "
        f"values, largest |diff| {err} (limit {REPLAY_TOL:g}): {replay_ok}; {resets} resets mid-rollout; the replay "
        f"without them {err0}: caught {caught}")
    if not replay_ok:
        fail(f"{task}: the update's replay does not reproduce the rollout: {err}")
    if not resets or not caught:
        fail(f"{task}: a replay that skips the done resets is not caught ({resets} resets, {err0})")

    # the stateful policy through play, from the checkpoint
    before = LAUNCHES["k1"]
    play_log = play(get_args(["--task", task, "--device", "cuda"]), num_steps=PLAY_STEPS, log_root=log_root)
    play_launches = LAUNCHES["k1"] - before
    npz = os.path.join(log_root, "exported", "policies", "policy.npz")
    import numpy as np

    keys = sorted(np.load(npz).files)
    if play_launches != PLAY_STEPS + 1 or not logger_finite(play_log):
        fail(f"{task}: play launched K1 {play_launches} times or produced non-finite values")
    if not {"lstm0_w_ih", "lstm0_w_hh", "lstm0_b_ih", "lstm0_b_hh", "std"} <= set(keys):
        fail(f"{task}: the exported policy.npz lacks the LSTM keys: {keys}")
    log(f"[lstm play] {PLAY_STEPS} steps, K1 launches {play_launches}; exported {os.path.basename(npz)} keys {keys}")

    # where an iteration's time goes: a rollout and one epoch of the update under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    net.bind(state.ppo.params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs2, batch2, _ = runner.rollout(rs)
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    roll_ms, roll_n = sum(dev_us(e) for e in kern) / 1e3, sum(e.count for e in kern)
    k1_ms = sum(dev_us(e) for e in kern if any(nm in e.key for nm in KERNEL_NAMES["K1"])) / 1e3
    with torch.no_grad():
        last, _ = net.evaluate_rnn(rs2.critic_obs, rs2.hidden)
    ret, adv = alg.compute_returns(batch2, last)
    # two grad steps of the update's shape: the first 2 x 163 env columns
    # as two minibatches of one epoch (a whole update is ~10^6 launches,
    # more than the profiler should hold)
    mb_envs, _ = alg.recurrent_geometry(n)
    cols = slice(0, 2 * mb_envs)
    two = copy.copy(alg)
    two.num_learning_epochs, two.num_mini_batches = 1, 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sub = type(batch2)(*(x[:, cols] for x in batch2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        two.update_recurrent(state.ppo, sub, ret[:, cols], adv[:, cols], rs.hidden.select(cols), generator=gen)
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    upd_ms, upd_n = sum(dev_us(e) for e in kern) / 1e3, sum(e.count for e in kern)
    grad_steps = 2
    iter_ms = 1e3 * sum(h["elapsed_s"] for h in hist) / len(hist)
    per_update = alg.num_learning_epochs * alg.num_mini_batches
    busy = (roll_ms + per_update * upd_ms / grad_steps) / iter_ms if iter_ms else None
    profile_out = {"rollout_wall_ms": roll_s * 1e3, "rollout_device_ms": roll_ms, "rollout_launches": roll_n,
                   "rollout_k1_ms": k1_ms, "grad_steps_profiled": grad_steps, "grad_steps_wall_ms": steps_s * 1e3,
                   "grad_steps_device_ms": upd_ms, "grad_steps_launches": upd_n,
                   "launches_per_grad_step": upd_n / grad_steps if upd_ms else None,
                   "device_ms_per_grad_step": upd_ms / grad_steps, "busy_share_estimate": busy}
    if roll_ms > 0 and upd_ms > 0:
        log(f"[lstm profile] rollout {roll_s * 1e3:.1f} ms wall, device {roll_ms:.1f} ms in {roll_n} launches (K1 "
            f"{k1_ms:.1f} ms); {grad_steps} grad steps of {mb_envs} env columns {steps_s * 1e3:.1f} ms wall, device "
            f"{upd_ms:.1f} ms in {upd_n} launches: {upd_n / grad_steps:.0f} device launches and "
            f"{upd_ms / grad_steps:.3f} ms of device time a grad step; device busy ~{100 * busy:.1f}% of the "
            f"unprofiled iteration's {iter_ms:.1f} ms (rollout + {per_update} grad steps)")
        if k1_ms == 0:
            fail(f"{task}: the rollout profile attributes no device time to K1")
    else:
        log("[lstm profile] the profiler saw no device time; launches a grad step and busy share not measured")
    return {"launches": launches, "iters": TRAIN_ITERS, "envs": N_ENVS, "wall_s": wall, "peak_mem_gib": peak,
            "iteration_s": [h["elapsed_s"] for h in hist], "collection_s": [h["collection_s"] for h in hist],
            "update_s": [h["update_s"] for h in hist], "env_steps_per_s": [h["fps"] for h in hist],
            "replay_max_abs_err": err, "replay_without_resets_err": err0, "replay_resets": resets,
            "play_launches": play_launches, "params": net.num_params, "profile": profile_out}


def no_self_collision(cfg):
    """The GR1T1 config with self-collision off: K1's no-pairs program, with
    the anchored stick friction kept. (The reference bench's
    ``ref_equiv_subset``, bench.py:98-102, also turns the stick spring off:
    ``GR1T1_viscous``.)"""
    cfg.asset.self_collisions = 1


def heightfield(cfg):
    """The GR1T1 config on heightfield terrain with the curriculum on, as
    the reference bench's ``heightfield`` cell (bench.py:95-97, 165-169):
    the 10 x 20 grid of the config, K1's ``local_plane`` program."""
    cfg.terrain.mesh_type = "heightfield"
    cfg.terrain.curriculum = True


def trimesh(cfg):
    """The GR1T1 config on trimesh terrain (stair risers as walls), as the
    reference bench's ``trimesh`` cell: K1's ``local_plane_walls`` program."""
    cfg.terrain.mesh_type = "trimesh"
    cfg.terrain.curriculum = True


def trimesh_viscous(cfg):
    """The trimesh program with the bench's viscous contact and no
    self-collision (``scripts/bench.py:ref_equiv_subset``): K1's
    terrain-mode ``use_tangent = 0`` branch."""
    from wiki_grx_gym_tpu_torch.scripts import bench

    trimesh(cfg)
    bench.ref_equiv_subset(cfg)


def heading(cfg):
    """The GR1T1 config with heading commands (a 4th command, the heading
    target) on the plane: K1's plane program without the post fold."""
    cfg.commands.heading_command = True
    cfg.commands.num_commands = 4


# K1's programs: (task, config change, what it is, spread). Each builds its
# own library (sim/cuda_step.py:team_shape, nvcc_flags). ``spread``: on
# terrain, phase 3's reachable states start anywhere within that many meters
# of the cell's origin (cuda_step.reachable_state), so that feet land on
# stairs, slopes and stones and touch riser walls.
K1_SETS = {
    "GR1T1": ("GR1T1", None, "GR1T1 lower limb, plane, post fold", None),
    "GR1T1_full": ("GR1T1_full", None, "GR1T1 full body, 32 DOF, plane, post fold", None),
    "GR1T1_no_pairs": ("GR1T1", no_self_collision, "GR1T1 lower limb without self-collision pairs", None),
    "GR1T1_heightfield": ("GR1T1", heightfield, "GR1T1 lower limb, heightfield (local_plane), no post fold", 3.5),
    "GR1T1_trimesh": ("GR1T1", trimesh, "GR1T1 lower limb, trimesh (local_plane_walls), no post fold", 3.5),
    "GR1T1_heading": ("GR1T1", heading, "GR1T1 lower limb, plane, heading commands, no post fold", None),
    "GR1T1_all_terms": ("GR1T1", None, "GR1T1 lower limb, plane, post fold with all 50 reward terms and 4 "
                        "penalized contact groups", None),
    "GR1T1_V": ("GR1T1", None, "GR1T1 lower limb, plane, post fold, V control", None),
    "GR1T1_T": ("GR1T1", None, "GR1T1 lower limb, plane, post fold, T control", None),
    "GR1T1_V_heading": ("GR1T1", None, "GR1T1 lower limb, plane, heading commands, no post fold, V control",
                        None),
    "GR1T1_viscous": ("GR1T1", None, "GR1T1 lower limb, plane, post fold, viscous friction (tangent "
                      "stiffness 0), no self-collision: the bench's ref_equiv_subset", None),
    "GR1T1_trimesh_viscous": ("GR1T1", trimesh_viscous, "GR1T1 lower limb, trimesh (local_plane_walls), no post "
                              "fold, viscous friction, no self-collision", 3.5),
}
# the programs that must equal their plain versions in every output bit of
# every env (phase 3), and the terms of the all-terms fold that no earlier
# program folds (each must be non-zero in some env of phase 3's states)
K1_EXACT = ("GR1T1_all_terms", "GR1T1_V", "GR1T1_T", "GR1T1_V_heading", "GR1T1_viscous", "GR1T1_trimesh_viscous")
NEW_TERMS = ("action_diff_knee", "action_rate", "ang_vel_xy", "base_height", "cmd_diff_ang_vel_pitch",
             "cmd_diff_ang_vel_roll", "cmd_diff_forehead_orient", "collision", "dof_acc", "dof_pos_limits",
             "dof_tor_new_hip_roll", "dof_vel", "dof_vel_limits", "dof_vel_new", "dof_vel_new_knee",
             "feet_contact_forces", "feet_speed_z_close_to_height_target", "limits_actions", "lin_vel_z",
             "orientation", "pose_offset_hip_yaw", "stumble", "torque_limits", "torques", "tracking_ang_vel",
             "tracking_lin_vel")


def k1_set_mutate(name):
    """The config change of K1 program ``name`` (``K1_SETS``; the later
    programs take theirs from ``sim/cuda_step.py`` and ``scripts/bench.py``)."""
    from wiki_grx_gym_tpu_torch.scripts import bench
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    return {"GR1T1_all_terms": cuda_step.all_terms_config, "GR1T1_V": cuda_step.control_config("V"),
            "GR1T1_T": cuda_step.control_config("T"),
            "GR1T1_V_heading": cuda_step.control_config("V", cuda_step.heading_config),
            "GR1T1_viscous": bench.ref_equiv_subset}.get(name, K1_SETS[name][1])
TERRAIN_STEPS = 16   # phase 3's policy steps from init on terrain (the drop from 0.3 m lands)


def _plain_ops_of_set(name):
    """:func:`count_plain_ops` of K1 program ``name`` (``K1_SETS``), in a
    worker process of :func:`plain_op_counts`."""
    import torch

    torch.set_num_threads(1)
    return count_plain_ops(K1_SETS[name][0], k1_set_mutate(name))


def plain_op_counts(names, workers=4):
    """Start :func:`count_plain_ops` for each of the K1 programs ``names`` in
    ``workers`` spawned processes (each count runs the lane program at N=1
    under a dispatch mode: seconds of host time) while phase 3 works the
    card. Returns (the pool, {name: future}); shut the pool down after."""
    import importlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    module = importlib.import_module("chip_smoke")   # pickled by this name, also when run as a script
    pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(module._plain_ops_of_set, name) for name in names}


def k1_phase(dev, task, mutate, label, spread, require_faster, exact=False, run=None, plain_ops=None):
    """Phase 3 for one K1 program: the kernel against its plain version on
    4096 reachable envs of ``task``'s training config (``mutate`` applied;
    on terrain the ground lanes the env samples), or on ``run``, an (env,
    env state) pair of that config, at its env count; the team kernel
    against the one-thread kernel bit for bit, both timed, the plain version
    timed, and the bound; on trimesh the envs with a riser wall in contact and with
    a tread force suppressed are counted (none fails). ``exact``: the
    kernel must equal its plain version in every output bit of every env;
    for the all-terms fold the states are planted
    (``cuda_step.planted_all_terms``) and each term of ``NEW_TERMS`` must
    be non-zero in some env (``collision`` non-zero where the penalized
    count is). ``plain_ops``: the program's :func:`count_plain_ops`, a
    count or a future of one (None: counted here). Any failure stops the
    script. Returns the numbers of the
    kernels' JSON row."""
    import torch

    from wiki_grx_gym_tpu_torch import build as kbuild
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    tag = f"[K1 {task}{'' if mutate is None else ', ' + mutate.__name__}]"
    if run is None:
        env, state = cuda_step.reachable_state(N_ENVS, dev, task=task, mutate=mutate, spread=spread,
                                               steps=8 if spread is None else TERRAIN_STEPS)
    else:
        env, state = run
        tag = f"{tag[:-1]}, {env.num_envs} envs]"
    n_envs = env.num_envs
    op = env.decimation_op
    all_terms = op.post is not None and len(op.post.reward_names) == len(cuda_step.REWARD_IDS)
    if all_terms:
        state = cuda_step.planted_all_terms(env, state)
    log(f"{tag} sizes {op.sizes._asdict()}, team {op.team[0]} lanes x {op.team[1]} envs; terrain mode "
        f"{env.terrain_mode}, post fold {op.post is not None}, control {op.deci.control_type}, last_qd "
        f"input {op.with_last_qd}")
    walls = None
    if env.riser_mode:
        active, inside = cuda_step.wall_contacts(env, state, state.ground_plane)
        walls = {"envs_with_wall_contact": int(active.any(1).sum()),
                 "envs_with_tread_suppressed": int(inside.any(1).sum()),
                 "points_with_wall_contact": int(active.sum()), "points_with_tread_suppressed": int(inside.sum())}
        log(f"{tag} ground lanes sampled by the env at the step's start: {walls['envs_with_wall_contact']} envs "
            f"({walls['points_with_wall_contact']} points) with a riser wall in contact, "
            f"{walls['envs_with_tread_suppressed']} envs ({walls['points_with_tread_suppressed']} points) with the "
            f"tread force suppressed inside a riser solid")
        if not (walls["envs_with_wall_contact"] and walls["envs_with_tread_suppressed"]):
            raise SystemExit(f"{tag} the riser-wall branches of the contact are dead in these states: {walls}")
    gen_in = torch.Generator(device=dev)
    gen_in.manual_seed(1)
    args, kw = cuda_step.decimation_inputs(env, state, gen_in)
    gen_in.manual_seed(1)
    args64, kw64 = cuda_step.decimation_inputs(env, state, gen_in, dtype=torch.float64)
    k = groups(op(*args, **kw))
    # the plain version's call against the kernel is the one timed (CUDA events)
    plain_ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    plain_ev[0].record()
    p = groups(op.plain(*args, **kw))
    plain_ev[1].record()
    p64 = groups(op.plain(*args64, **kw64))
    torch.cuda.synchronize()
    flips = torch.zeros(n_envs, dtype=torch.bool, device=dev)
    for name in BOOL_GROUPS:
        if name in k:   # the post fold's
            flips |= (k[name] != p[name]).any(dim=1)
    keep = ~flips
    over = torch.zeros(n_envs, dtype=torch.bool, device=dev)   # over the stated tolerance
    widened_ok, max_abs_err = True, 0.0
    for name in k:
        if name in BOOL_GROUPS:
            continue
        a, b, b64 = k[name], p[name], p64[name]
        if not (torch.isfinite(a[keep]).all() and torch.isfinite(b[keep]).all()):
            raise SystemExit(f"{tag} K1 vs plain: {name} has non-finite values")
        err = (a - b).abs()
        atol = ATOL_FORCE if name in FORCE_GROUPS else ATOL
        stated = atol + RTOL * b.abs()
        floor = float((b - b64)[keep].abs().max())
        env_over = (err > stated).any(dim=1) & keep
        over |= env_over
        good = bool((err[keep] <= stated[keep] + 3.0 * floor).all())
        widened_ok &= good
        rel = float((err[keep] / (b[keep].abs() + 1e-6)).max())
        if name not in FORCE_GROUPS:
            max_abs_err = max(max_abs_err, float(err[keep].max()))
        log(f"{tag} vs plain {name:26s} max_abs {float(err[keep].max()):.3e} max_rel {rel:.3e} "
            f"envs over rtol {RTOL:g}/atol {atol:g}: {int(env_over.sum())}; "
            f"f32 noise floor {floor:.3e}; within stated + 3 x floor {good}")
    divergent = flips | over
    div_frac = float(divergent.float().mean())
    same = torch.ones(n_envs, dtype=torch.bool, device=dev)
    for name in k:
        same &= ((k[name] == p[name]) | (k[name].isnan() & p[name].isnan())).all(dim=1)
    log(f"{tag} vs plain, {n_envs} envs: boolean lanes differ in {int(flips.sum())}, float lanes "
        f"over the stated tolerance in {int(over.sum())}; together {int(divergent.sum())} envs "
        f"({100 * div_frac:.3f}%, limit 0.1%); every output equal in {int(same.sum())} envs")
    force_err = max(float((k[g] - p[g])[keep].abs().max()) for g in FORCE_GROUPS)
    if div_frac > 1e-3 or not widened_ok:
        raise SystemExit(f"{tag} K1 disagrees with its plain version")
    if exact and int(same.sum()) != n_envs:
        raise SystemExit(f"{tag} K1 differs from its plain version in {n_envs - int(same.sum())} envs")
    viscous = None
    if op.deci.sub.contact.tangent_stiffness == 0.0:
        # the viscous law ran: points in ground contact at the step's end
        # (the last substep's forces) with a horizontal force (on the
        # plane: the tangential force; on terrain the normal's tilt and the
        # walls add to it). A planted
        # fault must fail the exact check: the plain version with the
        # friction coefficient times FAULT_SCALE, which without the stick
        # spring feeds only the viscous law (|f_t| = min(m / dt, mu f_n /
        # max(|v_t|, slip)) |v_t|)
        f = k["point_force"].reshape(n_envs, -1, 3)
        active = f[..., 2] > 0
        horizontal = active & (f[..., :2].abs().amax(dim=-1) > 0)
        rand = args[5]
        bad_args = args[:5] + (rand.replace(friction=rand.friction * FAULT_SCALE),) + args[6:]
        pf = groups(op.plain(*bad_args, **kw))
        fault_same = torch.ones(n_envs, dtype=torch.bool, device=dev)
        fault_over = torch.zeros(n_envs, dtype=torch.bool, device=dev)
        for name in k:
            fault_same &= ((k[name] == pf[name]) | (k[name].isnan() & pf[name].isnan())).all(dim=1)
            if name not in BOOL_GROUPS:
                atol = ATOL_FORCE if name in FORCE_GROUPS else ATOL
                fault_over |= ((k[name] - pf[name]).abs() > atol + RTOL * pf[name].abs()).any(dim=1)
        viscous = {"points_in_contact": int(active.sum()), "envs_in_contact": int(active.any(1).sum()),
                   "points_with_horizontal_force": int(horizontal.sum()),
                   "fault_envs_differing": n_envs - int(fault_same.sum()),
                   "fault_envs_over_tolerance": int(fault_over.sum())}
        log(f"{tag} viscous contact at the step's end: {viscous['points_in_contact']} points in "
            f"{viscous['envs_in_contact']} envs with an upward force, {viscous['points_with_horizontal_force']} "
            f"with a horizontal force; the plain version with friction x{FAULT_SCALE} differs from K1 in "
            f"{viscous['fault_envs_differing']} envs ({viscous['fault_envs_over_tolerance']} over the stated "
            f"tolerance): caught {bool(viscous['fault_envs_differing'])}")
        if not (viscous["points_with_horizontal_force"] and viscous["envs_in_contact"] >= n_envs // 2):
            raise SystemExit(f"{tag} the viscous law is not exercised by these states: {viscous}")
        if not viscous["fault_envs_differing"]:
            raise SystemExit(f"{tag} the planted viscous-friction fault passes the exact check")
        del pf, bad_args
    term_envs = None
    if all_terms:
        names = op.post.reward_names
        nz = (k["post/rew_terms"] != 0).sum(dim=0).tolist()
        term_envs = {n: int(nz[names.index(n)]) for n in NEW_TERMS}
        term_envs["pen_count"] = term_envs["collision"]   # collision is 0 exactly where the count is
        log(f"{tag} envs (of {n_envs}) where each new term is non-zero: {term_envs}")
        dead = [n for n, c in term_envs.items() if c == 0]
        if dead:
            raise SystemExit(f"{tag} terms zero in every env: {dead}")

    # the team kernel against the one-thread kernel on the same packed
    # input: every output lane bit for bit
    comp = op._pack(*args, **kw)
    out = torch.full((op.c_out, n_envs), -7.0, dtype=torch.float32, device=dev)
    ref = torch.empty_like(out)
    op.launch_packed(comp, ref, kernel="thread")
    op.launch_packed(comp, out)
    torch.cuda.synchronize()
    differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
    log(f"{tag} team vs thread: {op.c_out} x {n_envs} output lanes, bit for bit (NaN lanes by bit "
        f"pattern; {int(torch.isnan(ref).sum())} NaN lanes): {differ} differing lanes")
    if differ:
        raise SystemExit(f"{tag} the team kernel differs from the one-thread kernel in {differ} output lanes")

    # timing: both kernels alone on packed buffers (CUDA events, in turns),
    # the wrapper, and the plain version
    team = lambda: op.launch_packed(comp, out)
    thread = lambda: op.launch_packed(comp, ref, kernel="thread")
    k1_ms = cuda_ms(team, reps=50, warmup=3)
    thread_ms = cuda_ms(thread, reps=50, warmup=3)
    turns = [cuda_ms(thread, reps=50, warmup=1), cuda_ms(team, reps=50, warmup=1)]
    wrapper_ms = cuda_ms(lambda: op(*args, **kw), reps=20, warmup=2)
    plain_ms = plain_ev[0].elapsed_time(plain_ev[1])   # the call against the kernel, above
    if plain_ops is None:
        ops_per_env = count_plain_ops(task, mutate)
    else:
        ops_per_env = plain_ops.result() if hasattr(plain_ops, "result") else int(plain_ops)
    bytes_moved = (op.c_in + op.c_out) * 4 * n_envs
    ops_ms = ops_per_env * n_envs / FP32_PEAK * 1e3
    bytes_ms = bytes_moved / HBM_RATE * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    # K1 is built with --fmad=false: no FMA pairing, so its attainable rate
    # for these ops is half the peak
    ops_ms_no_fma = 2.0 * ops_ms
    log(f"{tag} team kernel {k1_ms:.4f} ms/launch at {n_envs} envs, then {turns[1]:.4f}; one-thread kernel "
        f"{thread_ms:.4f}, then {turns[0]:.4f} ms; wrapper incl. pack/unpack {wrapper_ms:.4f} ms; plain "
        f"{plain_ms:.2f} ms; ops/env/step {ops_per_env}; bound {bound_ms:.4f} ms by {bound_by} (ops "
        f"{ops_ms:.4f} ms, {ops_ms_no_fma:.4f} ms without FMA pairing; bytes {bytes_ms:.4f} ms); the team "
        f"kernel reaches {100 * ops_ms_no_fma / k1_ms:.1f}% of the no-FMA bound")
    if require_faster and not k1_ms < thread_ms:
        raise SystemExit(f"{tag} the team kernel ({k1_ms:.4f} ms) is not faster than the one-thread kernel "
                         f"({thread_ms:.4f} ms)")
    info = kbuild.BUILD_INFO[cuda_step.library_name(op.sizes)]
    row = {
        "name": f"K1 decimation ({label})",
        "route": "cuda",
        "source": "wiki_grx_gym_tpu_torch/csrc/decimation.cu",
        "replaces": "wiki_grx_gym_tpu/sim/pallas_step.py:149",
        "launches": None,
        "max_abs_err": max_abs_err,
        "max_abs_err_forces": force_err,
        "ms": k1_ms,
        "ms_thread_kernel": thread_ms,
        "ms_in_turns": {"thread": turns[0], "team": turns[1]},
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ms_no_fma": max(ops_ms_no_fma, bytes_ms),
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
        "envs": n_envs,
        "sizes": op.sizes._asdict(),
        "ops_per_env_step": ops_per_env,
        "bytes": bytes_moved,
        "build_s": info.get("seconds"),
        "ptxas": info.get("ptxas", []),
        "kernels_ptxas": cuda_step.ptxas_report(op.sizes),
        **cuda_step.team_occupancy(op),
        "team_vs_thread_differing_lanes": differ,
        "divergent_envs": int(divergent.sum()),
        "envs_equal_to_plain": int(same.sum()),
        "terrain_mode": env.terrain_mode,
        "post_fold": op.post is not None,
        "wall_contacts": walls,
        "control": op.deci.control_type,
        "term_nonzero_envs": term_envs,
        "viscous": viscous,
    }
    del env, state, op, comp, out, ref, args, kw, args64, kw64, k, p, p64
    gc.collect()
    torch.cuda.empty_cache()
    return row


def full_body_ppo_phase(dev):
    """Phase 9: K2 at the full-body widths (GR1T1_full: obs 105, critic obs
    234, 32 actions, std floor 0.10, entropy coefficient 0) on one 64-step
    rollout buffer at 4096 envs: the tensor-core GEMM against float64 at
    every product's shape (as in phase 5), K2 against its plain version at
    the rollout's params and after one epoch under phase 5's rule (the
    branch-flip rule and the planted fault included, ``k2_check``), K3 step by step over that float32 epoch against its
    plain version (``k3_steps_f32``), the one-epoch bf16 update graph
    against its one-step composition bit for bit (``composition_check``),
    K3's fused step against its reference pair bit for bit (6d), and K2's
    time per grad step beside
    its plain version, its bound and the cuBLAS yardstick of the same 22
    products. Returns the K2 row of the kernels' JSON line."""
    import torch

    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

    task = "GR1T1_full"
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    runner = OnPolicyRunner(env, train_cfg, device=dev)
    rs = runner.init_state()
    rs, batch, acc = runner.rollout(rs)
    torch.cuda.synchronize()
    for name, v in list(batch._asdict().items()) + list(acc.items()):
        if name != "dones" and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{task} rollout output {name} is not finite")
    assert batch.obs.shape == (ROLLOUT_STEPS, N_ENVS, 105), batch.obs.shape
    assert batch.critic_obs.shape == (ROLLOUT_STEPS, N_ENVS, 234), batch.critic_obs.shape
    assert batch.actions.shape == (ROLLOUT_STEPS, N_ENVS, 32), batch.actions.shape
    net, alg = runner.net, runner.alg
    log(f"[ppo {task}] {net.num_params} params; std floor {net.noise_std_floor}, entropy coefficient "
        f"{alg.entropy_coef}; rollout mean reward {float(acc['rew'].mean()) / ROLLOUT_STEPS:.4f}")
    p0 = net.params_flat.clone()
    setups = learner_setups(runner, rs, batch, task, dev)
    fused16, bufs16 = setups["bfloat16"]
    k2_err, tag = {}, f" {task}"
    gemm_worst = gemm_checks(fused16, dev)
    k2_check(setups, net, alg, p0, "at p0", k2_err, tag)
    st0 = alg.init(p0.clone())
    args0 = (st0.params, st0.m, st0.v, st0.count, st0.learning_rate)
    p1, m1, v1, lr1, k3_pmax = k3_steps_f32(setups, args0, task)
    composition_check(fused16, bufs16, args0, f"{task}, bf16 operands, one epoch")
    k2_check(setups, net, alg, p1, "after one epoch", k2_err, tag)
    log(f"[K2 vs plain]{tag} largest |diff| bf16 {k2_err['bfloat16']:.3e}, f32 {k2_err['float32']:.3e}; "
        f"K3's f32 steps largest param diff {k3_pmax:.3e}")
    # K3's fused step against its reference pair, bit for bit, at this width
    state1 = (p1, m1, v1, st0.count + alg.num_mini_batches, lr1)
    k3_differ = (k3_fused_check(fused16, args0, bufs16, 0, 0, f"{task} at p0")
                 + k3_fused_check(fused16, state1, bufs16, alg.num_mini_batches - 1, 1, f"{task} after one epoch"))

    row = dict(k2_timed_row(fused16, p0, bufs16, dev, tag,
                            "K2 PPO minibatch loss + gradients (GR1T1_full, 10480 rows, obs 105, critic obs 234, "
                            "32 actions, bf16 operands)", k2_err, gemm_worst),
               k3_f32_step_max_abs_err=k3_pmax, k3_fused_vs_reference_differing_words=k3_differ,
               params=net.num_params)
    del setups, fused16, bufs16, batch, acc, rs, runner, env
    return row


def k2_timed_row(fused16, p0, bufs16, dev, tag, name, k2_err, gemm_worst):
    """K2's time per grad step on minibatch 0 of ``bufs16`` at params ``p0``
    (CUDA events, 50 launches) beside its plain version, its bound and the
    cuBLAS yardstick of the same products at these rows (phases 9 and 18):
    the K2 row of the kernels' JSON line, ``launches`` left to the caller."""
    from wiki_grx_gym_tpu_torch import build as kbuild
    from wiki_grx_gym_tpu_torch.learn import fused_update

    lib2 = fused_update._lib("k2")
    args16, keep = fused16._k2_context(p0, bufs16)
    k2_ms = cuda_ms(lambda: fused16._k2_launch(lib2, args16, 0, dev), reps=50, warmup=3)
    k2_plain_ms = cuda_ms(lambda: fused16.grads_plain(p0, bufs16, 0), reps=3, warmup=1)
    del args16, keep
    library_ms = cublas_yardstick(fused16, dev)
    ops, nbytes = k2_work(fused16, 2)
    bound_tc = max(ops / BF16_TC_PEAK, nbytes / HBM_RATE) * 1e3
    bound_fp32 = max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3
    log(f"[K2{tag}] {k2_ms:.4f} ms per grad step ({fused16.rows} rows, bf16 operands, tensor cores); plain "
        f"{k2_plain_ms:.3f} ms; {ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB; bound {bound_tc:.4f} ms at the "
        f"bf16 tensor-core peak ({100 * bound_tc / k2_ms:.1f}% of it reached), {bound_fp32:.4f} ms at the FP32 "
        f"peak; achieved {ops / (k2_ms * 1e-3) / 1e12:.2f} TFLOP/s; cuBLAS yardstick (torch.matmul, the same "
        f"{len(fused16.gemm_shapes())} products on bf16 operands, GEMMs only, one CUDA graph replay) "
        f"{library_ms:.4f} ms")
    return {
        "name": name,
        "route": "cuda", "source": "wiki_grx_gym_tpu_torch/csrc/ppo_grads.cu",
        "replaces": "wiki_grx_gym_tpu/learn/fused_update.py:348",
        "launches": None, "max_abs_err": k2_err["bfloat16"], "max_abs_err_f32": k2_err["float32"],
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": bound_tc, "bound_by": "operations",
        "bound_ms_fp32": bound_fp32, "library_ms": library_ms,
        "library": "torch.matmul (cuBLAS) of the same bf16 products, GEMMs only, one CUDA graph replay; "
                   "not used by the port",
        "gflop": ops / 1e9, "bytes": nbytes, "rows": fused16.rows, "kernel_launches_per_grad_step": None,
        "gemm_err_share_of_limit": gemm_worst,
        "build_s": kbuild.BUILD_INFO["k2_ppo_grads"].get("seconds"),
    }


def drive_rollout(dev, task, mutate):
    """One 64-step rollout of ``task``'s training config (``mutate``
    applied) at 4096 envs through ``OnPolicyRunner``, the launch counts set
    to 0 just before and read just after: every output finite, K1 launched
    once a step. Returns K1's launches."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner

    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    mutate(cfg)
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    runner = OnPolicyRunner(env, train_cfg, device=dev)
    rs = runner.init_state()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rs, batch, acc = runner.rollout(rs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = LAUNCHES["k1"]
    for name, v in list(batch._asdict().items()) + list(acc.items()):
        if name != "dones" and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"{task} ({mutate.__name__}) rollout output {name} is not finite")
    log(f"[rollout {task}, {mutate.__name__}] {ROLLOUT_STEPS} steps x {N_ENVS} envs in {secs:.3f} s; "
        f"K1 launches {launches}; mean reward {float(acc['rew'].mean()) / ROLLOUT_STEPS:.4f}")
    if launches != ROLLOUT_STEPS:
        raise SystemExit(f"K1 launched {launches} times in a {ROLLOUT_STEPS}-step rollout of {task} "
                         f"({mutate.__name__})")
    return launches


# phase 13: the symmetry loss's coefficient (GR1T1 and GR1T1_lstm)
SYMMETRY_COEF = 0.5
# phase 14: data parallel, two gloo ranks on the one card
DP_WORLD = 2
DP_JOIN_S = 300.0     # the ranks' time limit; past it both are killed and the phase fails
DP_ALLREDUCE_REPS = 20


def symmetry_phase(dev):
    """Phase 13: the mirror-symmetry loss (``learn/symmetry.py``) through the
    entry points a user calls. (a) GR1T1 at 4096 envs with
    ``symmetry_coef`` 0.5: ``learn(1)`` on the xla path (an extra loss term
    takes it: ``FusedPPOGrad.supported`` is false), the launch counts set to
    0 just before and read just after (K1 65, K2 and K3 never), finite
    losses; then on one minibatch of a new rollout at the trained params the
    loss term and its gradient must be finite and non-zero. (b) GR1T1_lstm
    at 4096 envs with the loss: one rollout (K1 64), then ONE grad step of
    the recurrent update (the first minibatch, 163 env columns, autograd over
    the LSTM replay; a whole eager update takes ~28 s, PERF.md section 5): the
    loss term and the gradient finite and non-zero."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry

    out = {}
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    train_cfg.algorithm.symmetry_coef = SYMMETRY_COEF
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg,
                                              log_root=os.path.join(THIS, "build", "smoke_train", "GR1T1_symmetry"))
    alg = runner.alg
    if alg.path != "xla" or alg.extra_loss_fn is None:
        fail(f"GR1T1 with symmetry_coef {SYMMETRY_COEF}: path {alg.path}, extra loss {alg.extra_loss_fn}")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = runner.learn(1, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    want = {"k1": ROLLOUT_STEPS + 1, "k2": 0, "k3": 0}
    if launches != want:
        fail(f"GR1T1 symmetry: learn(1) launched {launches}, expected {want}")
    h = runner.log_history[-1]
    m = h["metrics"]
    if not all(math.isfinite(m[k]) for k in ("value_loss", "surrogate_loss", "kl", "lr")):
        fail(f"GR1T1 symmetry: non-finite losses {m}")
    log(f"[symmetry GR1T1] learn(1) in {wall:.2f} s: {h['elapsed_s']:.3f} s = collection {h['collection_s']:.3f} s "
        f"+ update {h['update_s']:.3f} s; {h['fps']:.0f} env-steps/s; launches {launches}; path {alg.path}; value "
        f"loss {m['value_loss']:.4f}, surrogate {m['surrogate_loss']:.5f}, kl {m['kl']:.5f}")
    runner.net.bind(state.ppo.params)
    rs, batch, _ = runner.rollout(state)
    with torch.no_grad():
        last = runner.net.evaluate(rs.critic_obs)
    ret, adv = alg.compute_returns(batch, last)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    w, _, rows = alg._pack_shuffle(batch, ret, adv, alg.draw_perm(*batch.rewards.shape, gen, dev))
    term, gnorm = _extra_term(alg, state.ppo.params, {"obs": w[0, :, :env.obs_dim]})
    log(f"[symmetry GR1T1] the loss term on minibatch 0 ({rows} rows) at the trained params: {term:.6e}, its "
        f"gradient's norm {gnorm:.6e}")
    if not (math.isfinite(term) and term > 0 and math.isfinite(gnorm) and gnorm > 0):
        fail(f"GR1T1 symmetry: the loss term {term} or its gradient norm {gnorm} is not finite and non-zero")
    out["GR1T1"] = {"launches": launches, "envs": N_ENVS, "wall_s": wall, "iteration_s": h["elapsed_s"],
                    "collection_s": h["collection_s"], "update_s": h["update_s"], "env_steps_per_s": h["fps"],
                    "loss_term": term, "loss_term_grad_norm": gnorm, "path": alg.path}
    del runner, env, state, rs, batch, w
    gc.collect()
    torch.cuda.empty_cache()

    task = "GR1T1_lstm"
    cfg, train_cfg = task_registry.get_cfgs(task)
    cfg.env.num_envs = N_ENVS
    train_cfg.algorithm.symmetry_coef = SYMMETRY_COEF
    env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
    runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
    alg = runner.alg
    state = runner.init_state()
    torch.cuda.synchronize()
    reset_launch_counts()
    rs, batch, _ = runner.rollout(state)
    with torch.no_grad():
        last, _ = runner.net.evaluate_rnn(rs.critic_obs, rs.hidden)
    ret, adv = alg.compute_returns(batch, last)
    mb = alg.recurrent_minibatches(batch, ret, adv, state.hidden, generator=gen)(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        p = state.ppo.params.detach().requires_grad_(True)
        loss, aux = alg._minibatch_loss_recurrent(p, mb)
        (g,) = torch.autograd.grad(loss, p)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    loss = float(loss.detach())
    launches = dict(LAUNCHES)
    term, term_gnorm = _extra_term(alg, state.ppo.params, mb)
    gn = float(torch.linalg.vector_norm(g))
    log(f"[symmetry {task}] one grad step of the recurrent update ({mb['obs'].shape[1]} env columns x "
        f"{mb['obs'].shape[0]} steps) in {step_s * 1e3:.1f} ms: loss {loss:.6f}, the loss term {term:.6e} "
        f"(its gradient's norm {term_gnorm:.6e}), the whole gradient's norm {gn:.6e}; launches {launches}")
    if launches != {"k1": ROLLOUT_STEPS, "k2": 0, "k3": 0}:
        fail(f"{task} symmetry: the rollout and grad step launched {launches}")
    if not (math.isfinite(term) and term > 0 and math.isfinite(term_gnorm) and term_gnorm > 0
            and math.isfinite(gn) and gn > 0 and math.isfinite(loss)):
        fail(f"{task} symmetry: loss {loss}, term {term}, gradient norms {term_gnorm} / {gn}")
    out[task] = {"launches": launches, "grad_step_s": step_s, "loss": loss, "loss_term": term,
                 "loss_term_grad_norm": term_gnorm, "grad_norm": gn, "env_columns": int(mb["obs"].shape[1])}
    return out


def _extra_term(alg, params, mb):
    """The extra loss term of ``alg`` on ``mb`` at ``params`` and the norm of
    its gradient."""
    import torch

    with torch.enable_grad():
        p = params.detach().requires_grad_(True)
        term = alg.extra_loss_fn(p, mb)
        (g,) = torch.autograd.grad(term, p)
    return float(term.detach()), float(torch.linalg.vector_norm(g))


def leaf_check(net, got, want, tol):
    """Per layout leaf: max |got - want| within ``rtol x scale + atol_frac x
    scale`` (``tol`` = K2_TOL's (loss, rtol, atol_frac); scale = the leaf's
    largest |want|). Returns (all within, {leaf: (diff, limit)})."""
    _, rtol, atol_frac = tol
    out, ok = {}, True
    for name, d, scale in leaf_diffs(net, got, want):
        lim = (rtol + atol_frac) * scale
        good = d <= lim and math.isfinite(d)
        ok &= good
        out[name] = (d, lim)
    return ok, out


def dp_worker(rank, world, init_method, out_dir, device, num_envs):
    """Phase 14, one rank of two gloo processes on the one card: GR1T1 at
    4096 envs in all (2048 a rank), through the entry points a user calls
    with ``dp``. (a) ``learn(2)``, the launch counts set to 0 just before and
    read just after: K1 129 and K2's chain 400 on this rank (the step path: K2
    per shard, the gradient all-reduce, clip and Adam), K3 never; (d) the
    ranks' learner states bit-identical after each update (the runner checks
    the all-gathered digests and raises otherwise). Then a gloo all-reduce of
    the gradient's size timed alone. (b) On a new rollout of this rank's
    shard: K2 against its plain version on this rank's minibatch 0 (5232
    rows), leaf by leaf at phase 5's bf16 limits, rows on another branch of
    the loss taken out of both (phase 5's rule); the all-reduced mean of the
    two ranks' K2 gradients against the mean of their plain versions at the
    same limits. (c) Planted faults: rank 1's largest leaf scaled by 1.05
    before the all-reduce must fail the mean's check; rank 1 dropping the
    all-reduce's result once (its own gradient into its Adam step) must fail
    the ranks' identity check. Results go to ``out_dir/rank<r>.json``."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.ppo import PPOState
    from wiki_grx_gym_tpu_torch.parallel import mesh, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = mesh.init_distributed(backend="gloo", init_method=init_method, world_size=world, rank=rank,
                               device=device, timeout_s=DP_JOIN_S)
    try:
        dev = dp.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        cfg, train_cfg = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = num_envs
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(
            env, "GR1T1", train_cfg=train_cfg, log_root=os.path.join(THIS, "build", "smoke_train", "GR1T1_dp2"),
            dp=dp)
        alg, net = runner.alg, runner.net
        steps = alg.num_learning_epochs * alg.num_mini_batches
        res = {"rank": rank, "world": world, "backend": "gloo", "device": str(dev), "envs": env.num_envs,
               "shard": list(env.shard), "path": alg.path}
        saved = []   # the checkpoints this rank writes
        save = runner.save
        runner.save = lambda path, st: (saved.append(os.path.basename(path)), save(path, st))
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        state = runner.learn(TRAIN_ITERS, init_at_random_ep_len=True)
        sync()
        res["learn_s"] = time.perf_counter() - t0
        res["launches"] = dict(LAUNCHES)
        hist = runner.log_history
        res.update(iteration_s=[h["elapsed_s"] for h in hist], collection_s=[h["collection_s"] for h in hist],
                   update_s=[h["update_s"] for h in hist], env_steps_per_s=[h["fps"] for h in hist],
                   metrics=[h["metrics"] for h in hist],
                   digests=[[str(int(x)) for x in d] for d in runner.replica_digests])
        res["checkpoints_saved"] = saved

        # the gloo all-reduce of one grad step's (gradient, loss, 3 metrics) alone
        buf = torch.zeros(net.num_params + 4, device=dev)
        dp.all_reduce_sum(buf)
        sync()
        t0 = time.perf_counter()
        for _ in range(DP_ALLREDUCE_REPS):
            dp.all_reduce_sum(buf)
        sync()
        res["allreduce_ms"] = 1e3 * (time.perf_counter() - t0) / DP_ALLREDUCE_REPS

        # (b) K2 against its plain version on this rank's shard
        net.bind(state.ppo.params)
        rs, batch, _ = runner.rollout(state)
        with torch.no_grad():
            last = net.evaluate(rs.critic_obs)
        ret, adv = alg.compute_returns(batch, last)
        gen = torch.Generator(device=dev)
        gen.manual_seed(14)
        perm = alg._shared_perm(None, gen, lambda g: alg.draw_perm(*batch.rewards.shape, g, dev), dev)
        w, f, rows = alg._pack_shuffle(batch, ret, adv, perm)
        fused = alg._get_fused(rows)
        bufs = fused.split_buffers(w, f, env.obs_dim)
        p = state.ppo.params
        # (on the CPU, a rehearsal, grads is the plain version itself: no branch flips)
        used, flips, taken = neutralize_flips(fused, p, bufs, 0) if dev.type == "cuda" else (bufs, 0, 0)
        lk, gk, ak = fused.grads(p, used, 0)
        lp, gp, ap = fused.grads_plain(p, used, 0)
        sync()
        tol = K2_TOL["bfloat16"]
        rank_ok, diffs = leaf_check(net, gk, gp, tol)
        rank_ok &= flips <= MAX_FLIPS
        mean_k = dp.all_reduce_sum(gk.clone()) / world
        mean_p = dp.all_reduce_sum(gp.clone()) / world
        mean_ok, mean_diffs = leaf_check(net, mean_k, mean_p, tol)
        # (c) rank 1's largest leaf scaled by FAULT_SCALE before the all-reduce
        name, off, shape = max(net.layout, key=lambda leaf: math.prod(leaf[2]))
        gk_f = gk.clone()
        if rank == 1:
            gk_f[off: off + math.prod(shape)] *= FAULT_SCALE
        fault_ok, fault_diffs = leaf_check(net, dp.all_reduce_sum(gk_f) / world, mean_p, tol)
        # (c) rank 1 drops the all-reduce's result once: its Adam step takes its own gradient
        s = state.ppo
        honest = alg.reduce(lk, gk, ak)
        own = (lk, gk, ak) if rank == 1 else honest
        caught = {}
        for tag, (loss_r, g_r, aux_r) in (("honest", honest), ("rank 1 skips", own)):
            lr = alg._adapt_lr(s.learning_rate, aux_r["kl"])
            p2, m2, v2, c2 = alg._optax_step(s.params, s.m, s.v, s.count, lr, g_r)
            try:
                sharding.check_replicas_identical(dp, PPOState(params=p2, m=m2, v=v2, count=c2, learning_rate=lr))
                caught[tag] = False
            except RuntimeError:
                caught[tag] = True
        # K2 at this rank's rows (rank 0 times it while rank 1 waits): its
        # launch on a prepared context, as phase 8 times it; a grads() call
        # (the context built anew each call, as the eager step path made it
        # before); and the eager step path's call now (its context made once
        # an update, the step's params copied in)
        k2_ms = grads_ms = ctx_ms = plain_ms = library_ms = None
        if rank == 0 and dev.type == "cuda":
            from wiki_grx_gym_tpu_torch.learn import fused_update

            args, _keep = fused._k2_context(p, bufs)
            lib = fused_update._lib("k2")
            k2_ms = cuda_ms(lambda: fused._k2_launch(lib, args, 0, dev), reps=50, warmup=3)
            grads_ms = cuda_ms(lambda: fused.grads(p, bufs, 0), reps=20, warmup=2)
            ctx = fused.step_context(p.clone(), bufs)
            ctx_ms = cuda_ms(lambda: ctx.grads(0, p), reps=20, warmup=2)
            # K2's plain version and the cuBLAS yardstick at this rank's rows
            plain_ms = cuda_ms(lambda: fused.grads_plain(p, bufs, 0), reps=5, warmup=1)
            library_ms = cublas_yardstick(fused, dev)
        dp.all_reduce_sum(torch.zeros(1, device=dev))
        ops, nbytes = k2_work(fused, 2)
        res.update(rows=rows, k2_ms=k2_ms, k2_grads_call_ms=grads_ms, k2_step_context_call_ms=ctx_ms,
                   k2_plain_ms=plain_ms,
                   k2_library_ms=library_ms,
                   k2_bound_ms=max(ops / BF16_TC_PEAK, nbytes / HBM_RATE) * 1e3, flips=flips, rows_taken_out=taken, k2_rank_ok=bool(rank_ok),
                   k2_rank_worst={k: d / max(lim, 1e-30) for k, (d, lim) in diffs.items()},
                   k2_loss=[float(lk), float(lp)],
                   k2_mean_ok=bool(mean_ok),
                   k2_mean_worst={k: d / max(lim, 1e-30) for k, (d, lim) in mean_diffs.items()},
                   fault_leaf=name, fault_caught=not fault_ok,
                   fault_ratio=fault_diffs[name][0] / max(fault_diffs[name][1], 1e-30),
                   identity_check={"honest step flagged": caught["honest"],
                                   "rank 1 skipping the all-reduce caught": caught["rank 1 skips"]})
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        mesh.destroy(dp)


def dp_phase(dev):
    """Phase 14: data parallel over ``torch.distributed``. The one-process
    step path's update at 4096 envs first (``learn(1)``, ``fused_mega``
    off: K2 per grad step, then clip and Adam; the yardstick for the dp
    update's time, which stages each all-reduce through the host over gloo:
    not the cost of dp on NVLink). Then ``dp_worker`` on two gloo ranks
    sharing the card (NCCL refuses two ranks on one device), joined within
    ``DP_JOIN_S`` (past it both are killed and the phase fails). Then (e)
    ``torchrun --nproc_per_node=1 -m wiki_grx_gym_tpu_torch.scripts.train
    --distributed`` with NCCL, one iteration, must exit 0. Returns the
    phase's results (K2's dp row)."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.parallel.launch import spawn

    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    train_cfg.algorithm.fused_mega = False
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    assert runner.alg.path == "step"
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    reset_launch_counts()
    runner.learn(1)
    one = runner.log_history[-1]
    if dict(LAUNCHES) != {"k1": ROLLOUT_STEPS + 1, "k2": steps, "k3": 0}:
        fail(f"the one-process step path launched {dict(LAUNCHES)}")
    log(f"[dp] one process, step path, {N_ENVS} envs: update {one['update_s']:.3f} s, iteration {one['elapsed_s']:.3f} s "
        f"(collection {one['collection_s']:.3f} s); launches {dict(LAUNCHES)}")
    del runner, env
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = os.path.join(THIS, "build", "smoke_dp")
    os.makedirs(out_dir, exist_ok=True)
    for r in range(DP_WORLD):
        if os.path.exists(os.path.join(out_dir, f"rank{r}.json")):
            os.remove(os.path.join(out_dir, f"rank{r}.json"))
    t0 = time.perf_counter()
    rank_dev = str(torch.device(dev.type, dev.index or 0)) if dev.type == "cuda" else "cpu"
    spawn(dp_worker, DP_WORLD, args=(out_dir, rank_dev, N_ENVS), rendezvous_dir=out_dir, timeout_s=DP_JOIN_S)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    want = {"k1": TRAIN_ITERS * ROLLOUT_STEPS + 1, "k2": TRAIN_ITERS * steps, "k3": 0}
    for r in ranks:
        log(f"[dp rank {r['rank']}] {r['envs']} envs {r['shard']} on {r['device']} over {r['backend']}, path "
            f"{r['path']}: learn({TRAIN_ITERS}) in {r['learn_s']:.2f} s; launches {r['launches']}; iterations "
            + ", ".join(f"{a:.3f} s (collection {b:.3f} + update {c:.3f})"
                        for a, b, c in zip(r["iteration_s"], r["collection_s"], r["update_s"]))
            + f"; {', '.join(f'{x:.0f}' for x in r['env_steps_per_s'])} env-steps/s in all; gloo all-reduce of "
            f"the gradient {r['allreduce_ms']:.3f} ms; digests {r['digests']}; checkpoints written "
            f"{r['checkpoints_saved']}")
        log(f"[dp rank {r['rank']}] K2 vs plain on its minibatch 0 ({r['rows']} rows): {r['flips']} rows on another "
            f"branch (limit {MAX_FLIPS}), {r['rows_taken_out']} taken out of both; loss {r['k2_loss'][0]:.6e} vs "
            f"{r['k2_loss'][1]:.6e}; worst leaf at {max(r['k2_rank_worst'].values()):.3f} of its limit: "
            f"{r['k2_rank_ok']}; the all-reduced mean against the plain versions' mean, worst leaf at "
            f"{max(r['k2_mean_worst'].values()):.3f} of its limit: {r['k2_mean_ok']}; rank 1's {r['fault_leaf']} "
            f"x{FAULT_SCALE} fault at {r['fault_ratio']:.2f}x the limit, caught {r['fault_caught']}; identity "
            f"check {r['identity_check']}" + (f"; K2 {r['k2_ms']:.4f} ms a launch on a prepared context at "
                                               f"{r['rows']} rows (bound {r['k2_bound_ms']:.4f} ms), a "
                                               f"grads() call (its context built anew) "
                                               f"{r['k2_grads_call_ms']:.4f} ms, the eager step path's call "
                                               f"(step_context, made once an update) "
                                               f"{r['k2_step_context_call_ms']:.4f} ms, its "
                                               f"plain version {r['k2_plain_ms']:.3f} ms, the cuBLAS "
                                               f"yardstick (22 bf16 products, one graph) "
                                               f"{r['k2_library_ms']:.4f} ms"
                                               if r["k2_ms"] else ""))
        if r["launches"] != want:
            fail(f"dp rank {r['rank']}: launched {r['launches']}, expected {want}")
        if r["path"] != "step" or not r["k2_rank_ok"] or not r["k2_mean_ok"]:
            fail(f"dp rank {r['rank']}: path {r['path']}, K2 vs plain {r['k2_rank_ok']}, mean {r['k2_mean_ok']}")
        if not r["fault_caught"] or r["identity_check"] != {"honest step flagged": False,
                                                             "rank 1 skipping the all-reduce caught": True}:
            fail(f"dp rank {r['rank']}: a planted dp fault passed: {r['fault_caught']}, {r['identity_check']}")
        if not all(math.isfinite(m[k]) for m in r["metrics"] for k in ("value_loss", "surrogate_loss", "kl")):
            fail(f"dp rank {r['rank']}: non-finite losses")
        if len(r["digests"]) != TRAIN_ITERS or any(len(set(d)) != 1 for d in r["digests"]):
            fail(f"dp rank {r['rank']}: the ranks' digests differ or are missing: {r['digests']}")
    if ranks[0]["digests"] != ranks[1]["digests"] or ranks[0]["metrics"] != ranks[1]["metrics"]:
        fail("dp: the ranks disagree on the digests or the metrics")
    if ranks[0]["checkpoints_saved"] != [f"model_{TRAIN_ITERS}.pt"] or ranks[1]["checkpoints_saved"]:
        fail(f"dp: the checkpoint must come from rank 0 only: {[r['checkpoints_saved'] for r in ranks]}")

    # (e) torchrun, NCCL at world size 1, one iteration of the train CLI
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
           "wiki_grx_gym_tpu_torch.scripts.train", "--distributed", "--task", "GR1T1", "--num_envs", str(N_ENVS),
           "--max_iterations", "1", "--experiment_name", "smoke_torchrun"] + (["--device", "cpu"] if dev.type == "cpu"
                                                                            else [])
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=THIS, timeout=DP_JOIN_S)
    torchrun_s = time.perf_counter() - t0
    it_lines = [line for line in res.stdout.splitlines() if line.startswith("it ")]
    how = [line for line in res.stdout.splitlines() if line.startswith("iteration: ")]
    log(f"[dp torchrun] {' '.join(cmd[2:])}: exit {res.returncode} in {torchrun_s:.1f} s; {how}; {it_lines}")
    if res.returncode != 0 or len(it_lines) != 1:
        log(res.stdout[-3000:])
        log(res.stderr[-3000:])
        fail(f"torchrun with NCCL at world size 1 exited {res.returncode} with {len(it_lines)} iteration lines")
    # over NCCL the iteration is compiled, the collectives captured in its graphs
    if dev.type == "cuda" and not (how and how[0].startswith("iteration: compiled")):
        fail(f"torchrun with NCCL at world size 1 did not run the compiled iteration: {how}")
    return {"world": DP_WORLD, "backend": "gloo", "device": ranks[0]["device"], "path": ranks[0]["path"],
            "rows_per_rank": ranks[0]["rows"], "launches_per_rank": [r["launches"] for r in ranks],
            "k2_ms_at_rows_per_rank": ranks[0]["k2_ms"], "k2_grads_call_ms": ranks[0]["k2_grads_call_ms"],
            "k2_bound_ms_at_rows_per_rank": ranks[0]["k2_bound_ms"],
            "k2_plain_ms_at_rows_per_rank": ranks[0]["k2_plain_ms"],
            "k2_library_ms_at_rows_per_rank": ranks[0]["k2_library_ms"], "allreduce_ms_per_grad_step": [r["allreduce_ms"] for r in ranks],
            "iteration_s": ranks[0]["iteration_s"], "collection_s": ranks[0]["collection_s"],
            "update_s": ranks[0]["update_s"], "env_steps_per_s": ranks[0]["env_steps_per_s"],
            "one_process_step_update_s": one["update_s"], "one_process_step_iteration_s": one["elapsed_s"],
            "k2_step_context_call_ms": ranks[0]["k2_step_context_call_ms"],
            "spawn_s": spawn_s, "torchrun_nccl_world1": {"exit": res.returncode, "seconds": torchrun_s,
                                                         "how": how, "iteration": it_lines}}


# phase 15: eval and deploy
EVAL_PLAY_STEPS = 100
NATIVE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_deploy.py's limits
NATIVE_FAULT = 1e-2   # one weight of the .grxpolicy moved by this much must fail NATIVE_TOL
LSTM_STREAM = 20
NATIVE_ROW_CALLS = 1000   # single-row forwards timed: one robot's control step each
FRAME_TOL = 1e-5      # replay frames on the card against float64 FK on the CPU, meters
EVAL_TRANSIENT, EVAL_WINDOW, EVAL_ENVS = 60, 200, 64
PROFILE_ITERS = 5


def native_check(native, obs, want):
    """(largest |native - want|, within NATIVE_TOL) on a batch."""
    import numpy as np

    got = native(obs)
    err = np.abs(got - want)
    return float(err.max()), bool((err <= NATIVE_TOL["atol"] + NATIVE_TOL["rtol"] * np.abs(want)).all())


def eval_deploy_phase(dev, eval_obs, stream_obs):
    """Phase 15: the eval and deploy path through the entry points a user
    calls, the launch counts set to 0 just before and read just after.
    (a) ``play --record`` of GR1T1 from phase 7's ``model_2.pt`` (the eval
    config: 50 envs, 100 steps): K1 once a step plus the load's initial
    step; ``traj.npz`` with JAX's keys, shapes and dtypes, all finite;
    ``policy.npz`` and ``policy.grxpolicy`` written. (b) ``NativePolicy`` on
    that ``.grxpolicy`` (the C++ runtime, built by g++ into build/deploy)
    on ``eval_obs`` (4096 rows of the phase-4 rollout) against the port's
    actor on the card in f32 (TF32 off) within rtol 1e-4 / atol 1e-5; one
    weight of the file moved by 1e-2 must fail it; the forward's CPU time,
    for the batch and for single-row calls (a robot's control step).
    (c) The same for GR1T1_lstm from phase 12's export: the native stream
    against the port's stateful policy for 20 steps of ``stream_obs``, and
    again after ``reset()``. (d) The replay frames of (a)'s ``traj.npz``
    (FK on the card) against the same FK on the CPU in float64 within 1e-5
    m. (e) ``eval_tracking`` of the trained GR1T1 at 64 envs: six finite
    rows, survival in [0, 1], K1 1 + 6 x (1 + 260) launches. (f)
    ``learn(5, profile_dir=...)`` at 4096 envs: one Chrome trace naming
    K1's ``decimation_team_kernel`` and K3's ``k3_fused_step`` and K2's
    chain, or the update's ``cudaGraphLaunch`` where the profiler sees no
    kernel inside the graph. Returns the phase's numbers."""
    import numpy as np
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.deploy.runtime import MAGIC, NativePolicy, ensure_library
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
    from wiki_grx_gym_tpu_torch.learn.recurrent import ActorCriticRecurrent
    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.tools.eval_tracking import evaluate
    from wiki_grx_gym_tpu_torch.tools.visualize import replay_frames
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args
    from wiki_grx_gym_tpu_torch.utils.task_registry import get_load_path

    t_phase = time.perf_counter()
    out = {}
    k1_total = 0
    root = os.path.join(THIS, "build", "smoke_train", "GR1T1")
    export = os.path.join(root, "exported", "policies")

    # (a) play --record
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    logger = play(get_args(["--task", "GR1T1", "--device", str(dev), "--record"]), num_steps=EVAL_PLAY_STEPS,
                  log_root=root)
    torch.cuda.synchronize()
    play_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    k1_total += launches["k1"]
    traj = np.load(os.path.join(root, "traj.npz"), allow_pickle=False)
    shapes = {k: (str(traj[k].dtype), traj[k].shape) for k in traj.files}
    want = {"base_pos": ("float32", (EVAL_PLAY_STEPS, 3)), "base_quat": ("float32", (EVAL_PLAY_STEPS, 4)),
            "q": ("float32", (EVAL_PLAY_STEPS, 10)), "dt": ("float32", ()), "task": ("<U5", ())}
    finite = all(bool(np.isfinite(traj[k]).all()) for k in ("base_pos", "base_quat", "q", "dt")) and logger_finite(
        logger)
    exports = {f: os.path.isfile(os.path.join(export, f)) for f in ("policy.npz", "policy.grxpolicy")}
    log(f"[eval play] play --record, GR1T1 from {os.path.relpath(get_load_path(root), THIS)}, 50 envs, "
        f"{EVAL_PLAY_STEPS} steps in {play_s:.2f} s; launches {launches}; traj.npz {shapes}; finite {finite}; "
        f"exports {exports}; {logger.num_episodes} episodes ended")
    if launches != {"k1": EVAL_PLAY_STEPS + 1, "k2": 0, "k3": 0} or shapes != want or not finite or not all(
            exports.values()):
        fail(f"play --record: launches {launches}, traj {shapes}, finite {finite}, exports {exports}")
    out["play"] = {"seconds": play_s, "launches": launches, "episodes": logger.num_episodes}

    # (b) the native runtime against the port's actor on the card
    t0 = time.perf_counter()
    lib = ensure_library()
    build_s = time.perf_counter() - t0
    _, train_cfg = task_registry.get_cfgs("GR1T1")
    net = ActorCritic(39, 168, 10, train_cfg.policy).to(dev)
    ck = torch.load(get_load_path(root), map_location=dev, weights_only=True)
    net.params_flat.copy_(ck["params"])
    with torch.no_grad():
        want_act = net.act_inference(torch.from_numpy(eval_obs).to(dev)).cpu().numpy()
    path = os.path.join(export, "policy.grxpolicy")
    native = NativePolicy(path)
    native(eval_obs[:8])
    t0 = time.perf_counter()
    err, ok = native_check(native, eval_obs, want_act)
    native_s = time.perf_counter() - t0
    row_s = []
    for i in range(NATIVE_ROW_CALLS):   # a robot runs one row a call
        t0 = time.perf_counter()
        native(eval_obs[i % len(eval_obs)])
        row_s.append(time.perf_counter() - t0)
    row_us = np.percentile(row_s, [50, 99]) * 1e6
    blob = bytearray(open(path, "rb").read())
    off = 16 + 8   # header (magic, version, layers, activation), layer 0's (in, out); then W[0, 0]
    w = np.frombuffer(bytes(blob[off: off + 4]), np.float32)[0]
    blob[off: off + 4] = np.float32(w + NATIVE_FAULT).tobytes()
    faulty = os.path.join(THIS, "build", "smoke_faulty.grxpolicy")
    with open(faulty, "wb") as fh:
        fh.write(bytes(blob))
    f_err, f_ok = native_check(NativePolicy(faulty), eval_obs, want_act)
    magic = int(np.frombuffer(bytes(blob[:4]), np.uint32)[0])
    log(f"[eval native] libgrxpolicy.so ({os.path.relpath(lib, THIS)}, g++ {build_s:.2f} s if built now) on "
        f"{len(eval_obs)} rollout observations against the port's actor on the card (f32): largest |diff| "
        f"{err:.3e}, within rtol {NATIVE_TOL['rtol']:g} / atol {NATIVE_TOL['atol']:g}: {ok}; the forward "
        f"{native_s * 1e3:.1f} ms on the host CPU ({native_s / len(eval_obs) * 1e6:.2f} us a row of the batch); "
        f"{NATIVE_ROW_CALLS} single-row calls: median {row_us[0]:.2f} us, p99 {row_us[1]:.2f} us; W0[0,0] "
        f"moved by {NATIVE_FAULT:g}: largest |diff| {f_err:.3e}, caught {not f_ok}")
    if not ok or f_ok or magic != MAGIC:
        fail(f"native runtime: within tolerance {ok}, planted fault caught {not f_ok}, magic {magic:#x}")
    out["native"] = {"rows": len(eval_obs), "max_abs_err": err, "ok": ok, "fault_caught": not f_ok,
                     "fault_max_abs_err": f_err, "forward_ms_host_cpu": native_s * 1e3,
                     "us_per_row_host_cpu": native_s / len(eval_obs) * 1e6,
                     "single_row_median_us_host_cpu": float(row_us[0]),
                     "single_row_p99_us_host_cpu": float(row_us[1])}

    # (c) the LSTM's native stream against the port's stateful policy
    lroot = os.path.join(THIS, "build", "smoke_train", "GR1T1_lstm")
    _, lcfg = task_registry.get_cfgs("GR1T1_lstm")
    lnet = ActorCriticRecurrent(39, 168, 10, lcfg.policy).to(dev)
    ck = torch.load(get_load_path(lroot), map_location=dev, weights_only=True)
    lnet.params_flat.copy_(ck["params"])
    lnative = NativePolicy(os.path.join(lroot, "exported", "policies", "policy.grxpolicy"))

    def port_stream(n):
        hidden, acts = lnet.initial_hidden(1), []
        with torch.no_grad():
            for t in range(n):
                a, hidden = lnet.act_inference_rnn(torch.from_numpy(stream_obs[t: t + 1]).to(dev), hidden)
                acts.append(a[0].cpu().numpy())
        return np.stack(acts)

    lwant = port_stream(LSTM_STREAM)
    l_err, l_ok = native_check(lnative, stream_obs[:LSTM_STREAM], lwant)
    lnative.reset()
    r_err, r_ok = native_check(lnative, stream_obs[:LSTM_STREAM], lwant)
    log(f"[eval native lstm] GR1T1_lstm ({lnative.num_lstm_layers} LSTM layer(s)), {LSTM_STREAM} streamed steps "
        f"against the port's stateful policy on the card: largest |diff| {l_err:.3e}: {l_ok}; after reset() "
        f"{r_err:.3e}: {r_ok}")
    if not (l_ok and r_ok) or lnative.num_lstm_layers < 1:
        fail(f"native LSTM stream: {l_ok}, after reset {r_ok}")
    out["native_lstm"] = {"steps": LSTM_STREAM, "max_abs_err": max(l_err, r_err), "ok": l_ok and r_ok}

    # (d) replay frames: FK on the card against float64 FK on the CPU
    tpath = os.path.join(root, "traj.npz")
    frames, model, _, _, stride = replay_frames(tpath, dev)
    frames64 = replay_frames(tpath, "cpu", dtype=torch.float64)[0]
    f_diff = float(np.abs(frames - frames64).max())
    log(f"[eval replay] {len(frames)} frames (stride {stride}) of {model.num_bodies} bodies: largest |card f32 - "
        f"CPU f64| {f_diff:.3e} m (limit {FRAME_TOL:g}); the GIF is drawn by tools/visualize.py where matplotlib "
        f"and Pillow are installed")
    if not f_diff <= FRAME_TOL:
        fail(f"replay frames differ from float64 FK by {f_diff} m")
    out["replay"] = {"frames": len(frames), "max_abs_err_m": f_diff}

    # (e) command tracking
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    rows = evaluate("GR1T1", num_envs=EVAL_ENVS, transient=EVAL_TRANSIENT, window=EVAL_WINDOW, log_root=root,
                    device=str(dev))
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    k1_total += launches["k1"]
    want_k1 = 1 + 6 * (1 + EVAL_TRANSIENT + EVAL_WINDOW)
    steps = 6 * (1 + EVAL_TRANSIENT + EVAL_WINDOW) * EVAL_ENVS
    rows_ok = len(rows) == 6 and all(math.isfinite(r[2]) and 0.0 <= r[4] <= 1.0 for r in rows)
    log(f"[eval tracking] {EVAL_ENVS} envs, transient {EVAL_TRANSIENT}, window {EVAL_WINDOW}: {eval_s:.2f} s, "
        f"{steps / eval_s:.0f} env-steps/s; launches {launches} (K1 expected {want_k1}); rows "
        + "; ".join(f"{r[0]} measured {r[2]:+.3f} survival {r[4]:.3f}" for r in rows))
    if launches != {"k1": want_k1, "k2": 0, "k3": 0} or not rows_ok:
        fail(f"eval_tracking: launches {launches} (K1 {want_k1} expected), rows {rows}")
    out["eval_tracking"] = {"seconds": eval_s, "env_steps_per_s": steps / eval_s, "launches": launches,
                            "rows": [list(r) for r in rows]}

    # (f) learn(5, profile_dir=...): a device trace of iterations 2-4
    prof_dir = os.path.join(THIS, "build", "smoke_profile")
    if os.path.isdir(prof_dir):
        for f in os.listdir(prof_dir):
            os.remove(os.path.join(prof_dir, f))
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    runner.learn(PROFILE_ITERS, profile_dir=prof_dir)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    k1_total += launches["k1"]
    files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    names = set()
    if len(files) == 1:
        with open(os.path.join(prof_dir, files[0])) as fh:
            events = json.load(fh)["traceEvents"]
        names = {str(e.get("name", "")) for e in events}
    has = lambda frag: any(frag in n for n in names)
    seen = {k: has(k) for k in (*KERNEL_NAMES["K1"], *KERNEL_NAMES["K2"], *KERNEL_NAMES["K3"], "cudaGraphLaunch")}
    iters = sorted(int(n.rsplit(" ", 1)[1]) for n in names if n.startswith("OnPolicyRunner.iteration "))
    k23 = all(seen[k] for k in (*KERNEL_NAMES["K2"], *KERNEL_NAMES["K3"]))
    size_mb = os.path.getsize(os.path.join(prof_dir, files[0])) / 2**20 if len(files) == 1 else 0.0
    log(f"[eval profile] learn({PROFILE_ITERS}, profile_dir=build/smoke_profile) at {N_ENVS} envs in {learn_s:.2f} s; "
        f"launches {launches}; trace files {files} ({size_mb:.1f} MiB), iterations traced {iters}; names seen "
        f"{seen}" + ("" if k23 else "; no K2/K3 kernel inside the update's graph in the trace: its "
                     "cudaGraphLaunch stands for them"))
    grad_steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    want = {"k1": PROFILE_ITERS * ROLLOUT_STEPS + 1, "k2": PROFILE_ITERS * grad_steps, "k3": PROFILE_ITERS}
    # learn runs the compiled iteration: K1's kernels may appear only as the
    # collection graph's launch, as K2's and K3's as the update graph's
    k1_seen = seen["decimation_team_kernel"] or (runner.eager_reason is None and seen["cudaGraphLaunch"])
    if len(files) != 1 or iters != [2, 3, 4] or not k1_seen or not (
            k23 or seen["cudaGraphLaunch"]) or launches != want:
        fail(f"learn(profile_dir=): files {files}, iterations {iters}, names {seen}, launches {launches} "
             f"(expected {want})")
    out["profile"] = {"seconds": learn_s, "launches": launches, "trace_mib": size_mb, "iterations": iters,
                      "names_seen": seen}
    out["k1_launches"] = k1_total
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 15 took {out['seconds']:.1f} s; K1 launched {k1_total} times in it")
    return out


# phase 17: item 16 (bf16 policy and update dtypes, remat_update, fused_trunk)
# and item 14b (tensor parallelism over torch.distributed)
TP_WORLD = 2
TP_JOIN_S = 240.0     # the ranks' time limit; past it all are killed and the phase fails
TP_BUDGET_S = 90.0    # the 4-rank dp2 x mp2 run follows only while the phase is inside this
FULL_PARAMS = 436885  # GR1T1's actor-critic: 39 / 168 -> [512, 256, 128] -> 10 / 1, and std
BF16_MEAN_TOL, BF16_VALUE_TOL = 1e-2, 2e-2      # tests/test_learn.py:306-326
BF16_PARAM_RTOL, BF16_PARAM_ATOL = 1e-2, 5e-3   # tests/test_parallel.py:193-196
BF16_GRAD_TOL = 5e-2   # 17b: bf16 gradient vs f32, per leaf, a share of the leaf's largest |value|
TRUNK_GRAD_TOL = 1e-4  # 17b: the stacked trunk's f32 gradient vs the two stacks', likewise
TP_GRAD_TOL = 1e-4     # 17c: the gathered mp2 gradient vs one process, likewise
TP_STEP_TOL = 1e-3     # 17c: 4 grad steps' update, per leaf, L2 share of the one-process update
TP_STEPS = 4
# 17c's steps an env (T cut from 64): the eager mp update over gloo is
# host-bound, and its all-reduces of the activations scale with the rows
TP_ENV_STEPS = 16


def dtype_cfgs(update="bfloat16", compute="bfloat16", storage="float32", **alg):
    """GR1T1 at 4096 envs with the item-16 options."""
    from wiki_grx_gym_tpu_torch.envs import task_registry

    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    train_cfg.policy.compute_dtype = compute
    train_cfg.algorithm.update_dtype = update
    train_cfg.algorithm.storage_dtype = storage
    for k, v in alg.items():
        setattr(train_cfg.algorithm, k, v)
    return cfg, train_cfg


def sync(dev):
    """Wait for the card (a no-op on the CPU, where phase 17 is rehearsed)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def worst_share(net, got, want, tol):
    """(all leaves within ``tol`` x the leaf's largest |want|, the worst
    leaf's share of its limit)."""
    worst = 0.0
    for name, d, scale in leaf_diffs(net, got, want):
        worst = max(worst, d / max(tol * scale, 1e-30)) if math.isfinite(d) else math.inf
    return worst <= 1.0, worst


def l2_share(net, got, want):
    """The largest per-leaf ||got - want|| / ||want||."""
    worst = 0.0
    for _, off, shape in net.layout:
        n = math.prod(shape)
        a, b = got[off: off + n], want[off: off + n]
        worst = max(worst, float((a - b).norm() / b.norm().clamp_min(1e-30)))
    return worst


def _last_layer_in_bf16(orig):
    """A planted fault of 17b: ``networks._layer`` with the last layer's
    float32 accumulation dropped to a bf16 product."""
    def layer(x, w, b, i, n, dtype, mp):
        if dtype is None or i != n - 1:
            return orig(x, w, b, i, n, dtype, mp)
        return (x @ w.transpose(-1, -2).to(dtype)).float() + b
    return layer


def dtype_phase(dev):
    """Phase 17a-b: item 16 at GR1T1's full width, 4096 envs. (a) The mega
    path with ``compute_dtype`` and ``update_dtype`` bf16 and f32 storage:
    K2's operands bf16 by JAX's rule; the bf16 rollout's mu and values at
    iteration 0 against the f32 net's at the same params (1e-2 / 2e-2,
    tests/test_learn.py:306-326); ``learn(1)`` with the counts set to 0
    just before (K1 65, K2 200, K3 1), finite losses and params. (b) The xla
    path at the trained state and one minibatch of a new rollout: remat's
    gradient bit for bit the plain one; the stacked trunk's f32 gradient
    within TRUNK_GRAD_TOL of the two stacks'; the bf16 gradient within
    BF16_GRAD_TOL of the f32 one and one bf16 grad step's params within
    tests/test_parallel.py's bf16 bounds of the f32 step's; a planted fault
    (the last layer accumulated in bf16) reported against both. Returns the
    phase's numbers and the trained runner (17c's mp1 side)."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import networks
    from wiki_grx_gym_tpu_torch.learn.ppo import PPO

    out = {}
    t0 = time.perf_counter()
    cfg, train_cfg = dtype_cfgs()
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
    alg, net = runner.alg, runner.net
    rs, batch, _ = runner.rollout(runner.init_state(init_at_random_ep_len=True))
    o, c = batch.obs.reshape(-1, env.obs_dim), batch.critic_obs.reshape(-1, batch.critic_obs.shape[-1])
    with torch.no_grad():
        mu32 = net.action_mean(o, dtype=None).reshape(batch.mu.shape)
        v32 = net.evaluate(c, dtype=None).reshape(batch.values.shape)
    d_mu, d_v = float((batch.mu - mu32).abs().max()), float((batch.values - v32).abs().max())
    rows = alg.shuffle_geometry(ROLLOUT_STEPS, env.num_envs)[3]
    op = alg._get_fused(rows).op_dtype
    del rs, batch, o, c, mu32, v32
    sync(dev)
    reset_launch_counts()
    t1 = time.perf_counter()
    state = runner.learn(1, init_at_random_ep_len=True)
    sync(dev)
    learn_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    m = runner.log_history[-1]["metrics"]
    finite = all(math.isfinite(m[k]) for k in ("value_loss", "surrogate_loss", "kl", "lr")) and bool(
        torch.isfinite(state.ppo.params).all())
    log(f"[17a] bf16 compute and update, f32 storage, path {alg.path}: K2 operands {op}; the bf16 rollout "
        f"at iteration 0 against the f32 net: mu {d_mu:.3e} (limit {BF16_MEAN_TOL}), values {d_v:.3e} (limit "
        f"{BF16_VALUE_TOL}); learn(1) in {learn_s:.2f} s, launches {launches}; value loss {m['value_loss']:.5f}, "
        f"kl {m['kl']:.5f}, finite {finite}")
    want = {"k1": ROLLOUT_STEPS + 1, "k2": alg.num_learning_epochs * alg.num_mini_batches, "k3": 1}
    if alg.path != "mega" or op != torch.bfloat16 or launches != want or not finite:
        fail(f"17a: path {alg.path}, K2 operands {op}, launches {launches} (expected {want}), finite {finite}")
    if not (d_mu <= BF16_MEAN_TOL and d_v <= BF16_VALUE_TOL):
        fail(f"17a: the bf16 rollout is {d_mu} / {d_v} from the f32 net's")
    out["a"] = {"op_dtype": str(op), "launches": launches, "learn_s": learn_s, "mu_diff": d_mu,
                "value_diff": d_v, "iteration": runner.log_history[-1]["elapsed_s"],
                "update_s": runner.log_history[-1]["update_s"], "metrics": m}

    # (b) the xla path, one minibatch of a new rollout at the trained state
    runner.net.bind(state.ppo.params)
    rs, batch, _ = runner.rollout(state)
    with torch.no_grad():
        last = net.evaluate(rs.critic_obs)
    ret, adv = alg.compute_returns(batch, last)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    w, f, _ = alg._pack_shuffle(batch, ret, adv, alg.draw_perm(*batch.rewards.shape, gen, dev))
    mb = PPO.minibatch(w, f, env.obs_dim, env.num_actions, 0)
    del rs, batch

    def xla(update="float32", **flags):
        _, tc = dtype_cfgs(update, fused_update=False, **flags)
        return PPO(net, tc.algorithm)

    p, s0 = state.ppo.params, state.ppo
    g32 = xla().loss_and_grad(p, mb)[1]
    g_remat = xla(remat_update=True).loss_and_grad(p, mb)[1]
    g_trunk = xla(fused_trunk=True).loss_and_grad(p, mb)[1]
    g16 = xla("bfloat16").loss_and_grad(p, mb)[1]
    remat_equal = bool(torch.equal(g32, g_remat))
    trunk_ok, trunk_worst = worst_share(net, g_trunk, g32, TRUNK_GRAD_TOL)
    g16_ok, g16_worst = worst_share(net, g16, g32, BF16_GRAD_TOL)

    def step(ppo, g):
        lr = ppo._adapt_lr(s0.learning_rate, torch.zeros((), device=dev))
        return ppo._optax_step(s0.params, s0.m, s0.v, s0.count, lr, g)[0]

    def params_within(a, b):
        d = (a - b).abs() - (BF16_PARAM_ATOL + BF16_PARAM_RTOL * b.abs())
        return bool((d <= 0).all()), float((a - b).abs().max())

    p32, p16 = step(xla(), g32), step(xla("bfloat16"), g16)
    step_ok, step_diff = params_within(p16, p32)
    layer = networks._layer
    networks._layer = _last_layer_in_bf16(layer)
    try:
        g_fault = xla("bfloat16").loss_and_grad(p, mb)[1]
    finally:
        networks._layer = layer
    fault_grad_ok, fault_worst = worst_share(net, g_fault, g32, BF16_GRAD_TOL)
    fault_step_ok, fault_step_diff = params_within(step(xla("bfloat16"), g_fault), p32)
    fault_moved = l2_share(net, g_fault, g16)
    log(f"[17b] xla path, one minibatch ({mb['obs'].shape[0]} rows) at the trained state: remat's gradient "
        f"equal bit for bit {remat_equal}; fused_trunk's f32 gradient worst leaf at {trunk_worst:.3f} of "
        f"{TRUNK_GRAD_TOL} x its largest |value|; the bf16 gradient worst leaf at {g16_worst:.3f} of "
        f"{BF16_GRAD_TOL}; one bf16 grad step's params within rtol {BF16_PARAM_RTOL} / atol {BF16_PARAM_ATOL} of "
        f"the f32 step's: {step_ok} (largest |diff| {step_diff:.3e}); planted fault (last layer accumulated in "
        f"bf16): gradient moved {fault_moved:.3e} (L2 share) from the honest bf16 one, worst leaf at "
        f"{fault_worst:.3f} of the bf16 bound: caught {not fault_grad_ok}; its step within the params bound: "
        f"{fault_step_ok} (caught {not fault_step_ok}, largest |diff| {fault_step_diff:.3e})")
    if not (remat_equal and trunk_ok and g16_ok and step_ok):
        fail(f"17b: remat {remat_equal}, trunk {trunk_ok}, bf16 gradient {g16_ok}, bf16 step {step_ok}")
    if not fault_moved > 0:
        fail("17b: the planted fault did not change the bf16 gradient")
    out["b"] = {"rows": int(mb["obs"].shape[0]), "remat_bit_equal": remat_equal, "trunk_worst": trunk_worst,
                "bf16_grad_worst": g16_worst, "bf16_step_ok": step_ok, "bf16_step_diff": step_diff,
                "fault": {"grad_moved_l2": fault_moved, "grad_worst": fault_worst,
                          "caught_by_grad_check": not fault_grad_ok, "caught_by_step_check": not fault_step_ok}}
    out["seconds"] = time.perf_counter() - t0
    log(f"[time] phase 17a-b took {out['seconds']:.1f} s")
    return out, runner, state


def tp_worker(rank, world, init_method, out_dir, device, num_mp, num_envs, full_checks):
    """Phase 17c, one rank of a gloo group on the one card at ``num_mp``:
    GR1T1 at full width, ``TP_ENV_STEPS`` steps an env, through the entry
    points a user calls with the mesh. With ``full_checks`` (mp2, dp1): the
    mp1 checkpoint ``mp1.pt`` loaded as this rank's shard; ``learn(1)`` with
    the counts set to 0 just before (K1 16 from the loaded state, K2 and K3
    never: the xla path), the
    peers held bit-identical by the runner after the update; the gathered
    checkpoint ``mp2.pt`` from rank 0; on a new rollout, minibatch 0's
    gathered gradient against the one-process xla gradient (rank 0) leaf by
    leaf; two planted faults (rank 1's shard of the first actor layer x1.05;
    the forward's row-parallel all-reduce skipped) against the same check;
    the first TP_STEPS grad steps of an update against one process's.
    Without: ``learn(1)`` (K1 17) and the peers' identity. Results go to
    ``out_dir/tp<world>_rank<r>.json``."""
    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import networks
    from wiki_grx_gym_tpu_torch.learn.networks import ActorCritic
    from wiki_grx_gym_tpu_torch.learn.ppo import PPO
    from wiki_grx_gym_tpu_torch.parallel import mesh, sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = mesh.init_distributed(backend="gloo", init_method=init_method, world_size=world, rank=rank,
                                  device=device, timeout_s=TP_JOIN_S)
    try:
        dp = mesh.make_mesh(num_mp, group)
        mp, dev = dp.mp, dp.device
        cfg, train_cfg = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = num_envs
        train_cfg.runner.num_steps_per_env = TP_ENV_STEPS
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, dp=dp)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None, dp=dp)
        alg, net = runner.alg, runner.net
        res = {"rank": rank, "world": world, "dp": [dp.world, dp.rank], "mp": [mp.world, mp.rank],
               "envs": env.num_envs, "shard": list(env.shard), "path": alg.path, "params": net.num_params,
               "full_params": net.full_num_params}
        state = None
        if full_checks:
            state = runner.load(os.path.join(out_dir, "mp1.pt"))
            ck = torch.load(os.path.join(out_dir, "mp1.pt"), map_location=dev, weights_only=True)
            res["mp1_loads_as_shard"] = bool(torch.equal(
                state.ppo.params, sharding.shard_flat(net, ck["params"], mp.world, mp.rank)))
        sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        state = runner.learn(1, init_at_random_ep_len=True, state=state)
        sync(dev)
        res["learn_s"] = time.perf_counter() - t0
        res["launches"] = dict(LAUNCHES)
        h = runner.log_history[-1]
        res.update(iteration_s=h["elapsed_s"], collection_s=h["collection_s"], update_s=h["update_s"],
                   env_steps_per_s=h["fps"], metrics=h["metrics"],
                   digests=[[str(int(x)) for x in d] for d in runner.replica_digests])
        if full_checks:
            runner.save(os.path.join(out_dir, "mp2.pt"), state)
            full = runner.gathered(state.ppo)
            res["gathered_params_digest"] = str(int(sharding._digest([full.params])[0]))
            # a new rollout; minibatch 0 at the trained shard
            net.bind(state.ppo.params)
            rs, batch, _ = runner.rollout(state)
            with torch.no_grad():
                last = net.evaluate(rs.critic_obs)
            ret, adv = alg.compute_returns(batch, last)
            gen = torch.Generator(device=dev)
            gen.manual_seed(17)
            w, f, rows = alg._pack_shuffle(batch, ret, adv, alg.draw_perm(*batch.rewards.shape, gen, dev))
            a = env.num_actions
            mb = PPO.minibatch(w, f, env.obs_dim, a, 0)
            gather = lambda x: sharding.gather_flat(net, mp.all_gather(x.contiguous()))
            p = state.ppo.params
            grads = {"honest": gather(alg.loss_and_grad(p, mb)[1])}
            pf = p.clone()
            _, off, shape = next(leaf for leaf in net.layout if leaf[0] == "actor.0.weight")
            if mp.rank == 1:
                pf[off: off + math.prod(shape)] *= FAULT_SCALE
            grads["rank 1's actor.0.weight shard x1.05"] = gather(alg.loss_and_grad(pf, mb)[1])
            forward = networks._ReduceFromMP.forward
            networks._ReduceFromMP.forward = staticmethod(lambda ctx, y, mp_: y.clone())
            try:
                grads["row-parallel all-reduce skipped"] = gather(alg.loss_and_grad(p, mb)[1])
            finally:
                networks._ReduceFromMP.forward = forward
            # the first TP_STEPS grad steps of an update from the trained state
            grad_fn = lambda q, i: alg.loss_and_grad(q, PPO.minibatch(w, f, env.obs_dim, a, i))
            t1 = time.perf_counter()
            s4, m4 = alg._run_epochs(state.ppo, grad_fn, steps=TP_STEPS)
            sync(dev)
            res["tp_grad_step_ms"] = 1e3 * (time.perf_counter() - t1) / TP_STEPS
            f4 = runner.gathered(s4)
            if rank == 0:
                # one process on the same inputs: the whole net, the xla path
                ref_cfg = copy.deepcopy(train_cfg)
                ref_cfg.algorithm.fused_update = False
                ref_net = ActorCritic(env.obs_dim, net.num_critic_input, a, ref_cfg.policy,
                                      generator=torch.Generator()).to(dev)
                ref = PPO(ref_net, ref_cfg.algorithm)
                want = ref.loss_and_grad(full.params, mb)[1]
                res["grad_checks"] = {}
                for tag, g in grads.items():
                    ok, worst = worst_share(ref_net, g, want, TP_GRAD_TOL)
                    res["grad_checks"][tag] = {"within": ok, "worst": worst}
                ref_fn = lambda q, i: ref.loss_and_grad(q, PPO.minibatch(w, f, env.obs_dim, a, i))
                t1 = time.perf_counter()
                r4, rm4 = ref._run_epochs(full, ref_fn, steps=TP_STEPS)
                sync(dev)
                res["one_process_grad_step_ms"] = 1e3 * (time.perf_counter() - t1) / TP_STEPS
                res["steps_l2_share"] = {k: l2_share(ref_net, getattr(f4, k) - getattr(full, k),
                                                     getattr(r4, k) - getattr(full, k)) for k in ("params", "m", "v")}
                res["steps_metrics"] = {k: [float(m4[k]), float(rm4[k])] for k in ("value_loss", "kl", "lr")}
                res["rows"] = rows
            # the peers after the checks' steps: the runner's check on the 4-step state
            sharding.check_replicas_identical(dp, s4, "4 grad steps", net=net,
                                              replicated=torch.stack([m4[k] for k in sorted(m4)]))
        with open(os.path.join(out_dir, f"tp{world}_rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        mesh.destroy(group)


def tp_phase(dev, runner1, state1):
    """Phase 17c: item 14b on the card. ``tp_worker`` on two gloo ranks
    sharing the card at ``--num_mp 2`` (dp1, 4096 envs on each: mp peers
    step the same envs), then, inside TP_BUDGET_S, four at dp2 x mp2 with
    2 x 2048 envs; NCCL refuses two ranks on one device, so the collectives
    stage through the host (the cost of gloo on one card, not of TP over
    NVLink). The mp1 side of the checkpoint round trip is 17a's runner:
    ``mp1.pt`` from its state before, ``mp2.pt`` loaded into it after, equal
    to the ranks' gathered params. Returns the phase's numbers."""
    import torch

    from wiki_grx_gym_tpu_torch.parallel import sharding
    from wiki_grx_gym_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    out_dir = os.path.join(THIS, "build", "smoke_tp")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    runner1.save(os.path.join(out_dir, "mp1.pt"), state1)
    rank_dev = str(torch.device(dev.type, dev.index or 0)) if dev.type == "cuda" else "cpu"
    spawn(tp_worker, TP_WORLD, args=(out_dir, rank_dev, 2, N_ENVS, True), rendezvous_dir=out_dir,
          timeout_s=TP_JOIN_S)
    ranks = [json.load(open(os.path.join(out_dir, f"tp{TP_WORLD}_rank{r}.json"))) for r in range(TP_WORLD)]
    back = runner1.load(os.path.join(out_dir, "mp2.pt"))
    mp2_loads = str(int(sharding._digest([back.ppo.params])[0])) == ranks[0]["gathered_params_digest"]
    out = {"mp2": ranks, "mp2_checkpoint_loads_at_mp1": mp2_loads}
    r0 = ranks[0]
    for r in ranks:
        log(f"[17c mp2 rank {r['rank']}] dp {r['dp']} mp {r['mp']}: {r['params']:,} params on this rank of the "
            f"whole net's {r['full_params']:,}; {r['envs']} envs {r['shard']}, path {r['path']}; learn(1) in "
            f"{r['learn_s']:.2f} s: {r['iteration_s']:.3f} s = collection {r['collection_s']:.3f} + update "
            f"{r['update_s']:.3f} s, {r['env_steps_per_s']:.0f} env-steps/s; launches {r['launches']}; digests "
            f"{r['digests']}; mp1 checkpoint loads as the shard {r['mp1_loads_as_shard']}; a grad step of the "
            f"checks {r['tp_grad_step_ms']:.1f} ms")
    log(f"[17c mp2] the gathered gradient against one process on minibatch 0 ({r0['rows']} rows), worst leaf "
        f"against {TP_GRAD_TOL} x its largest |value|: " + "; ".join(
            f"{k}: {v['worst']:.3f} of the limit, within {v['within']}" for k, v in r0["grad_checks"].items())
        + f"; {TP_STEPS} grad steps' update against one process's (L2 share per leaf, limit {TP_STEP_TOL}): "
        f"{r0['steps_l2_share']}, metrics {r0['steps_metrics']} (one process {r0['one_process_grad_step_ms']:.1f} "
        f"ms a grad step); the mp2 checkpoint loads at mp1 {mp2_loads}")
    want = {"k1": TP_ENV_STEPS, "k2": 0, "k3": 0}
    checks = r0["grad_checks"]
    for r in ranks:
        if r["path"] != "xla" or r["launches"] != want or r["params"] >= r["full_params"]:
            fail(f"17c mp2 rank {r['rank']}: path {r['path']}, launches {r['launches']} (expected {want}), "
                 f"params {r['params']}")
        if not r["mp1_loads_as_shard"] or not all(math.isfinite(r["metrics"][k])
                                                  for k in ("value_loss", "surrogate_loss", "kl")):
            fail(f"17c mp2 rank {r['rank']}: mp1 checkpoint as shard {r['mp1_loads_as_shard']}, metrics {r['metrics']}")
    # (each rank's digests are its dp group's, here itself: the runner held the
    # mp peers' replicated leaves, env states and metrics bit-identical)
    if ranks[0]["metrics"] != ranks[1]["metrics"] or any(len(d) != 1 for r in ranks for d in r["digests"]):
        fail("17c mp2: the mp peers disagree on the metrics, or a digest is missing")
    if ranks[0]["full_params"] != FULL_PARAMS:
        fail(f"17c: the whole net has {ranks[0]['full_params']} params, expected {FULL_PARAMS}")
    if not checks["honest"]["within"] or any(v["within"] for k, v in checks.items() if k != "honest"):
        fail(f"17c mp2: the gradient check {checks}")
    if not all(v <= TP_STEP_TOL for v in r0["steps_l2_share"].values()) or not mp2_loads:
        fail(f"17c mp2: {TP_STEPS} grad steps {r0['steps_l2_share']}, mp2 checkpoint at mp1 {mp2_loads}")
    elapsed = time.perf_counter() - t_phase
    if elapsed < 0.6 * TP_BUDGET_S:
        world = 4
        spawn(tp_worker, world, args=(out_dir, rank_dev, 2, N_ENVS, False), rendezvous_dir=out_dir,
              timeout_s=TP_JOIN_S)
        q = [json.load(open(os.path.join(out_dir, f"tp{world}_rank{r}.json"))) for r in range(world)]
        for r in q:
            log(f"[17c dp2 x mp2 rank {r['rank']}] dp {r['dp']} mp {r['mp']}: {r['params']:,} params, {r['envs']} "
                f"envs {r['shard']}; learn(1) in {r['learn_s']:.2f} s: {r['iteration_s']:.3f} s = collection "
                f"{r['collection_s']:.3f} + update {r['update_s']:.3f} s, {r['env_steps_per_s']:.0f} env-steps/s "
                f"in all; launches {r['launches']}; digests {r['digests']}")
            if r["launches"] != {"k1": TP_ENV_STEPS + 1, "k2": 0, "k3": 0} or r["path"] != "xla":
                fail(f"17c dp2 x mp2 rank {r['rank']}: launches {r['launches']}, path {r['path']}")
        # dp peers (ranks 0 and 2, 1 and 3) hold the same shard; mp peers the same envs
        if any(x["metrics"] != q[0]["metrics"] for x in q) or q[0]["digests"] != q[2]["digests"] \
                or q[1]["digests"] != q[3]["digests"] or q[0]["shard"] != q[1]["shard"] \
                or q[0]["shard"] == q[2]["shard"]:
            fail("17c dp2 x mp2: the peers disagree or the shards are not as laid out")
        out["dp2_mp2"] = q
    else:
        log(f"[17c] the dp2 x mp2 run is left out: the phase took {elapsed:.1f} s of its {TP_BUDGET_S} s")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 17c took {out['seconds']:.1f} s")
    return out


# phase 16: the engine path on the card (sim/engine.physics_step under the
# env's decimation loop, cfg.sim.use_pallas = False)
ENGINE_TOL = {"state": (1e-3, 1e-4), "forces": (2e-3, 2e-2)}   # (rtol, atol): tests/test_scalarized.py's decimation check
ENGINE_GROUPS = {"state": ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel", "q", "qd", "anchor"),
                 "forces": ("force_sum", "vxyz_sum", "vrpy_sum", "tau", "point_force")}
ENGINE_MAX_SHARE = 1e-3   # envs over the tolerance + 3x their own float32 floor (engine_vs)
ENGINE_FAULT = 1.05       # the planted fault: the engine's contact stiffness times this
ENGINE_PROFILE_STEPS = 1


def engine_path(cfg):
    """The config change of phase 16b: the engine path, set in the config only."""
    cfg.sim.use_pallas = False


def physics_groups(res):
    """The output groups that K1 and the engine both return, float64 (N, -1)."""
    g = {f: getattr(res[0], f) for f in ENGINE_GROUPS["state"]}
    g.update(force_sum=res[1], vxyz_sum=res[2], vrpy_sum=res[3], tau=res[4], point_force=res[5])
    return {k: v.double().reshape(v.shape[0], -1) for k, v in g.items()}


def engine_vs(k, e, p, p64):
    """K1's outputs ``k`` against the engine's ``e``, per group family of
    ENGINE_GROUPS at its ENGINE_TOL, with the plain lane program's float32
    (``p``) and float64 (``p64``) outputs for the noise floors. Two checks:
    (share) the envs where an output is over the tolerance plus 3x that
    env's own float32 noise floor on the group (max |p - p64| over the
    env's outputs of the group) may be at most ENGINE_MAX_SHARE of all;
    (widened) every output of every env within the tolerance plus 3x the
    group's float32 floor (over all envs; phase 3's widened bound). Two
    float32 programs that round differently drift apart by about their
    own noise floor in envs whose contact amplifies it, so the envs over
    the bare tolerance are counted and printed but not limited. Returns
    {family: (envs over the tolerance, envs over the per-env bound, share
    ok, widened ok, largest |diff| per group)}."""
    import torch

    out = {}
    for fam, names in ENGINE_GROUPS.items():
        rtol, atol = ENGINE_TOL[fam]
        over = torch.zeros(N_ENVS, dtype=torch.bool, device=k["q"].device)
        over_env = torch.zeros_like(over)
        widened, largest = True, {}
        for name in names:
            err = (k[name] - e[name]).abs()
            stated = atol + rtol * e[name].abs()
            noise = (p[name] - p64[name]).abs()
            finite = torch.isfinite(err).all(dim=1)
            over |= (err > stated).any(dim=1) | ~finite
            over_env |= (err > stated + 3.0 * noise.amax(dim=1, keepdim=True)).any(dim=1) | ~finite
            widened &= bool(finite.all()) and bool((err <= stated + 3.0 * noise.max()).all())
            largest[name] = float(err.max())
        out[fam] = (int(over.sum()), int(over_env.sum()), float(over_env.float().mean()) <= ENGINE_MAX_SHARE,
                    widened, largest)
    return out


def engine_floor_samples(k, e, p64, samples):
    """ROADMAP queue 3's question, a measurement beside ``engine_vs``'s
    gate (which stays as it is): each env's float32 floor estimated from
    several samples of the lane program in float32 (``samples``: the
    unperturbed run first, then runs on inputs nudged by +-1 ulp), each
    against the float64 run ``p64``. Per family of ENGINE_GROUPS: (envs
    whose one-sample floor undershoots the several-sample floor on some
    output group, envs over the tolerance + 3x the several-sample floor)."""
    import torch

    out = {}
    for fam, names in ENGINE_GROUPS.items():
        rtol, atol = ENGINE_TOL[fam]
        under = torch.zeros(N_ENVS, dtype=torch.bool, device=k["q"].device)
        over = torch.zeros_like(under)
        for name in names:
            floors = torch.stack([(x[name] - p64[name]).abs().amax(dim=1) for x in samples])
            one, many = floors[0], floors.amax(dim=0)
            under |= one < many
            err = (k[name] - e[name]).abs()
            stated = atol + rtol * e[name].abs()
            over |= (err > stated + 3.0 * many[:, None]).any(dim=1) | ~torch.isfinite(err).all(dim=1)
        out[fam] = (int(under.sum()), int(over.sum()))
    return out


def nudged(tree, sign):
    """``tree`` with every floating tensor moved by one ulp towards
    ``sign`` x infinity (integer and boolean tensors kept)."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import graphs

    return graphs.map_tensors(lambda t: torch.nextafter(t, torch.full_like(t, sign * math.inf))
                              if t.is_floating_point() else t, tree)


def engine_phase(dev):
    """Phase 16: the engine path on the card. (a) K1 (the GR1T1 fold
    program) against the batched engine (``sim/engine.physics_step`` under
    the env's ``_run_decimation`` with ``cfg.sim.use_pallas = False``) on
    phase 3's 4096 reachable GR1T1 states and inputs, one policy step each:
    the physics state at rtol 1e-3 / atol 1e-4, the feet sums, torques and
    point forces at rtol 2e-3 / atol 2e-2, under ``engine_vs``'s two checks;
    the engine with its contact stiffness times 1.05 must fail every
    check. ROADMAP queue 3's measurement (``engine_floor_samples``): the
    per-env floor from three samples (the lane program on the inputs and on
    the inputs nudged by +-1 ulp) against the one-sample floor the gate
    uses, printed beside the gate's counts. The engine's policy step is
    timed (CUDA events) beside K1's, and its device kernels counted under
    torch.profiler. (b) ``learn(1)`` of GR1T1 at 4096 envs with
    ``use_pallas = False`` set in the config only, compiled
    (``runner.eager_reason`` None: the per-step collection graphs and K3's
    update graph): every physics tensor on the card, K1 launched 0 times,
    K2 and K3 as in phase 7, finite losses; its seconds (the captures
    included), env-steps/s, peak memory and each graph's replays. Returns
    the phase's numbers."""
    import copy

    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("[16] TF32 matmuls are on; the engine must run in float32")
    t_phase = time.perf_counter()
    out = {}

    # (a) K1 against the engine
    env, state = cuda_step.reachable_state(N_ENVS, dev)
    op = env.decimation_op
    eng = cuda_step.task_env("GR1T1", N_ENVS, dev, engine_path)
    if not (env.backend == "kernel" and op.post is not None and eng.backend == "engine" and not eng._post_fold):
        raise SystemExit(f"[16a] backends {env.backend} (fold {op.post is not None}) / {eng.backend}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    args, kw = cuda_step.decimation_inputs(env, state, gen)
    gen.manual_seed(1)
    args64, kw64 = cuda_step.decimation_inputs(env, state, gen, dtype=torch.float64)

    def engine_step(e, args, kw):
        phys, actions, last_actions, motor, delay, rand = args
        s = state.replace(physics=phys, last_actions=last_actions, motor_strength=motor, rand=rand,
                          last_dof_vel=kw["last_qd"], torques=torch.zeros_like(phys.q))
        return e._run_decimation(s, actions, delay[:, None], commands=None)

    reset_launch_counts()
    k = physics_groups(op(*args, **kw))
    if LAUNCHES["k1"] != 1:
        raise SystemExit(f"[16a] K1 launched {LAUNCHES['k1']} times for one policy step")
    reset_launch_counts()
    res = engine_step(eng, args, kw)
    e = physics_groups(res)
    if LAUNCHES["k1"] != 0 or res[6] is not None or res[8] is not None:
        raise SystemExit("[16a] the engine step launched K1 or returned K1's outputs")
    p, p64 = physics_groups(op.plain(*args, **kw)), physics_groups(op.plain(*args64, **kw64))
    floor = {name: float((p[name] - p64[name]).abs().max()) for name in p}
    checks = engine_vs(k, e, p, p64)
    torch.cuda.synchronize()
    ok = True
    for fam, (n_over, n_over_env, share_ok, widened_ok, largest) in checks.items():
        rtol, atol = ENGINE_TOL[fam]
        log(f"[16a] K1 vs engine, {fam} (rtol {rtol:g} / atol {atol:g}): {n_over} of {N_ENVS} envs over the "
            f"tolerance, {n_over_env} over it + 3 x their own f32 floor ({100 * n_over_env / N_ENVS:.3f}%, limit "
            f"{100 * ENGINE_MAX_SHARE:g}%); every env within it + 3 x the lane program's f32 floor: {widened_ok}; "
            "largest |diff| " + ", ".join(f"{n} {v:.3e} (floor {floor[n]:.3e})" for n, v in largest.items()))
        ok &= share_ok and widened_ok
    if not ok:
        raise SystemExit("[16a] K1 disagrees with the engine")
    # ROADMAP queue 3: the per-env floor from three samples (a measurement only)
    samples = [p] + [physics_groups(op.plain(*nudged(args, sign), **nudged(kw, sign))) for sign in (1.0, -1.0)]
    floor3 = engine_floor_samples(k, e, p64, samples)
    for fam, (n_under, n_over3) in floor3.items():
        log(f"[16a] per-env f32 floor, {fam}: the one-sample floor undershoots the three-sample one (inputs and "
            f"inputs +-1 ulp, each against float64) in {n_under} of {N_ENVS} envs; {n_over3} envs over the "
            f"tolerance + 3 x the three-sample floor (the gate's one-sample count: {checks[fam][1]})")
    del samples
    # the planted fault must fail every check
    bad = copy.copy(eng)
    bad.contact_params = eng.contact_params.replace(stiffness=eng.contact_params.stiffness * ENGINE_FAULT)
    fault = engine_vs(k, physics_groups(engine_step(bad, args, kw)), p, p64)
    caught = {f"{fam} {what}": not val for fam, v in fault.items()
              for what, val in (("share", v[2]), ("widened", v[3]))}
    log(f"[16a] the engine's contact stiffness x {ENGINE_FAULT}: envs over the per-env bound "
        f"{({f: v[1] for f, v in fault.items()})}; checks failed {caught}")
    if not all(caught.values()):
        raise SystemExit(f"[16a] a planted fault passed a check: {caught}")
    # time: the engine's policy step and K1's (the wrapper), CUDA events
    engine_ms = cuda_ms(lambda: engine_step(eng, args, kw), reps=3, warmup=1)
    k1_wrapper_ms = cuda_ms(lambda: op(*args, **kw), reps=20, warmup=2)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ENGINE_PROFILE_STEPS):
            engine_step(eng, args, kw)
        torch.cuda.synchronize()
    dev_us = lambda ev: getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
    kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    n_kern = sum(ev.count for ev in kern)
    dev_ms = sum(dev_us(ev) for ev in kern) / 1e3 / ENGINE_PROFILE_STEPS
    per_substep = n_kern / ENGINE_PROFILE_STEPS / eng.decimation
    log(f"[16a] engine policy step at {N_ENVS} envs: {engine_ms:.2f} ms (CUDA events, 3 steps), K1's wrapper "
        f"{k1_wrapper_ms:.4f} ms; under the profiler {n_kern / ENGINE_PROFILE_STEPS:.0f} device kernels a step "
        f"({per_substep:.0f} a substep), {dev_ms:.2f} ms of device time (busy {100 * dev_ms / engine_ms:.1f}%)")
    out["a"] = {"envs": N_ENVS, "checks": {f: {"envs_over_tolerance": v[0], "envs_over_env_bound": v[1],
                                               "share_ok": v[2], "widened_ok": v[3], "max_abs": v[4]}
                                           for f, v in checks.items()},
                "f32_floor": floor, "fault": ENGINE_FAULT, "fault_envs_over": {f: v[1] for f, v in fault.items()},
                "fault_checks_failed": caught, "engine_step_ms": engine_ms, "k1_wrapper_ms": k1_wrapper_ms,
                "engine_kernels_per_step": n_kern / ENGINE_PROFILE_STEPS, "engine_kernels_per_substep": per_substep,
                "engine_device_ms_per_step": dev_ms,
                "floor_three_samples": {f: {"envs_one_sample_undershoots": v[0], "envs_over_three_sample_bound": v[1]}
                                        for f, v in floor3.items()}}
    del env, state, op, eng, bad, args, kw, args64, kw64, k, e, p, p64, res
    gc.collect()
    torch.cuda.empty_cache()

    # (b) learn(1) through the engine
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    engine_path(cfg)
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner, train_cfg = task_registry.make_alg_runner(
        env, "GR1T1", train_cfg=train_cfg, log_root=os.path.join(THIS, "build", "smoke_train", "GR1T1_engine"))
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    if runner.eager_reason is not None:
        raise SystemExit(f"[16b] the engine's iteration is not compiled: {runner.eager_reason}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    rs = runner.learn(1, init_at_random_ep_len=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ph = rs.env_state.physics
    devices = {f: getattr(ph, f).device.type for f in ENGINE_GROUPS["state"]}
    if env.backend != "engine" or set(devices.values()) != {"cuda"}:
        raise SystemExit(f"[16b] backend {env.backend}; physics tensors on {devices}")
    want = {"k1": 0, "k2": steps, "k3": 1}
    if launches != want:
        raise SystemExit(f"[16b] learn(1) through the engine launched {launches}, expected {want}")
    h = runner.log_history[-1]
    m = h["metrics"]
    if not all(math.isfinite(m[x]) for x in ("value_loss", "surrogate_loss", "kl", "lr", "mean_step_reward")):
        raise SystemExit(f"[16b] non-finite losses {m}")
    card = card_line()
    ci = runner.compiled
    # the host's graph launches of this (first) call: A1's replays after its
    # warm-up and capture, A2 (its warm-up and capture only), K3's update graph
    replays = {"rollout step (A1)": ci.collect["draw"].replays, "collection tail (A2)": ci.tail["draw"].replays,
               "update (K3)": launches["k3"]}
    log(f"[16b] learn(1) of GR1T1 at {N_ENVS} envs through the engine, compiled, in {wall:.2f} s (the graphs' "
        f"captures included): collection {h['collection_s']:.3f} s + update {h['update_s']:.3f} s (CUDA events); "
        f"{h['fps']:.0f} env-steps/s; launches {launches}; graph replays {replays} ({sum(replays.values())} "
        f"graph launches); peak memory {peak:.3f} GiB; value loss {m['value_loss']:.4f}, surrogate "
        f"{m['surrogate_loss']:.5f}, kl {m['kl']:.5f}, reward {m['mean_step_reward']:.4f}; physics on {devices['q']}; "
        f"{card}")
    for g in ci.reports():
        log(f"[16b] graph {json.dumps(g)}")
    out["b"] = {"envs": N_ENVS, "wall_s": wall, "collection_s": h["collection_s"], "update_s": h["update_s"],
                "env_steps_per_s": h["fps"], "peak_mem_gib": peak, "launches": launches, "card": card,
                "compiled": True, "graph_replays": replays, "graphs": ci.reports()}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[time] phase 16 took {out['seconds']:.1f} s")
    del runner, env, rs, ci
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 18: the port's bench (scripts/bench.py) through its own entry points,
# three of its cells (bench.cells) cut to BENCH_ITERS timed iterations (the
# bench's own 30 / 15); the 8192-env cell last, its run kept for the checks
BENCH_ITERS = 5
BENCH_CELLS = ("main", "ref_equiv_subset", "envs8192")
BIG_ENVS = 8192      # the reference's default env count (envs/gr1t1_config.py)


def bench_phase(dev, plain_ops=None):
    """Phase 18: the port's bench at the reference's default sizes
    (``plain_ops``: GR1T1's :func:`count_plain_ops` from phase 3, None to
    count it here). (a)
    Each of ``BENCH_CELLS`` through ``bench.build_run`` and
    ``bench.time_run`` at ``BENCH_ITERS`` timed iterations, the launch
    counts set to 0 just before and read just after (K1 once for
    ``init_state`` and 64 times for each iteration and rollout the cell
    reports, K2 200 and K3 once for each iteration): the cell's line
    finite, ``pallas_kernel`` true, its per-iteration times and peak memory
    printed. (b) On the 8192-env cell's run: one more iteration counted
    alone (K1 64, K2 200, K3 1, finite metrics); K1 against its plain
    version and the team kernel against the one-thread kernel on its env
    state (1,024 blocks) by phase 3's rule (``k1_phase``); on a rollout
    buffer at its params (20,960-row minibatches, where K2's row splits end
    on partial blocks) K2's GEMM against float64 and K2 against its plain
    version under phase 5's rule and limits (``k2_check``, at those params
    and after one float32 epoch of the plain version), the whole 200-step
    bf16 update's CUDA graph against its 200 one-step calls bit for bit
    (``composition_check``), that graph's replay time, and K2's time beside
    its plain version, bound and cuBLAS yardstick. Returns the cells, and
    the K1 and K2 rows of the kernels' JSON line at 8192 envs."""
    import statistics

    import torch

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.scripts import bench

    t18 = time.perf_counter()
    alg_cfg = task_registry.get_cfgs("GR1T1")[1].algorithm
    steps = alg_cfg.num_learning_epochs * alg_cfg.num_mini_batches
    cells = dict(bench.cells(on_card=True, full=True))
    out = {"cells": {}}
    for name in BENCH_CELLS:
        kw = {k: v for k, v in cells[name].items() if k != "iters"}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        env, runner, state = bench.build_run(device=str(dev), **kw)
        r, state = bench.time_run(env, runner, state, BENCH_ITERS, device=str(dev))
        sync(dev)
        got = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        cell = bench.cell_summary(r)
        calls = r["calls"]
        want = {"k1": 1 + ROLLOUT_STEPS * (calls["iterations"] + calls["rollouts"]),
                "k2": steps * calls["iterations"], "k3": calls["iterations"]}
        each = r["iter_ms_each"]
        finite = all(math.isfinite(v) for v in cell.values() if not isinstance(v, bool)) and \
            all(math.isfinite(v) for v in each)
        log(f"[18 bench {name}] {kw['num_envs']} envs, {BENCH_ITERS} timed iterations: {json.dumps(cell)}; "
            f"iteration ms min {min(each):.2f} / median {statistics.median(each):.2f} / max {max(each):.2f}; "
            f"peak memory {peak:.3f} GiB; calls {calls}; launches {got} (expected {want})")
        if not (finite and cell["pallas_kernel"] is True):
            fail(f"phase 18: the bench's {name} cell is not finite or did not run K1: {cell}")
        if got != want:
            fail(f"phase 18: the bench's {name} cell launched {got}, not {want}")
        out["cells"][name] = dict(cell, iter_ms_each=each, peak_mem_gib=peak, calls=calls, launches=got)
        if name != "envs8192":
            del env, runner, state
    assert env.num_envs == BIG_ENVS

    reset_launch_counts()
    state, metrics = runner.iteration(state)
    sync(dev)
    one = dict(LAUNCHES)
    finite = all(bool(torch.isfinite(v).all()) for v in metrics.values())
    log(f"[18 {BIG_ENVS} envs] one iteration: launches {one}; metrics finite {finite}; "
        f"collection {runner.last_timing['collection_s']:.3f} s, update {runner.last_timing['update_s']:.3f} s")
    if one != {"k1": ROLLOUT_STEPS, "k2": steps, "k3": 1} or not finite:
        fail(f"phase 18: one {BIG_ENVS}-env iteration launched {one} (finite metrics {finite})")
    _, _, label, _ = K1_SETS["GR1T1"]
    k1_row = k1_phase(dev, "GR1T1", None, f"{label}, {BIG_ENVS} envs", None, require_faster=False,
                      run=(env, state.env_state), plain_ops=plain_ops)
    k1_row["launches"] = one["k1"]
    k1_row["launches_from"] = "one iteration of the bench's envs8192 cell, counted alone"
    rs, batch, acc = runner.rollout(state)
    net, alg = runner.net, runner.alg
    p0 = net.params_flat.clone()
    setups = learner_setups(runner, rs, batch, "GR1T1", dev)
    del rs, batch, acc, state
    fused16, bufs16 = setups["bfloat16"]
    fused32, bufs32 = setups["float32"]
    k2_err, tag = {}, f" {BIG_ENVS} envs"
    gemm_worst = gemm_checks(fused16, dev)
    k2_check(setups, net, alg, p0, "at p0", k2_err, tag)
    st0 = alg.init(p0.clone())
    args0 = (st0.params, st0.m, st0.v, st0.count, st0.learning_rate)
    f1 = copy.copy(fused32)
    f1.num_epochs = 1
    p1 = f1.update_scan_plain(*args0, bufs32)[0]
    share = [clip_shares(fused32, p1, bufs32, mb) for mb in (0, alg.num_mini_batches - 1)]
    log(f"[K2 vs plain]{tag} after one epoch: rows outside the ratio clip range "
        + ", ".join(f"{100 * r:.2f}%" for r, _ in share) + "; outside the value clip range "
        + ", ".join(f"{100 * v:.2f}%" for _, v in share) + " (minibatches 0, last)")
    k2_check(setups, net, alg, p1, "after one epoch", k2_err, tag)
    log(f"[K2 vs plain]{tag} largest |diff| bf16 {k2_err['bfloat16']:.3e}, f32 {k2_err['float32']:.3e}")
    composition_check(fused16, bufs16, args0, f"GR1T1 at {BIG_ENVS} envs, bf16 operands, the whole update",
                      epochs=fused16.num_epochs)
    # the update's graph (captured by the whole-update call above) replayed
    ctx = fused16.update_graph(dev, bufs16)
    k3_ms = cuda_ms(lambda: fused16.update_scan(*args0, bufs16), reps=3, warmup=1)
    log(f"[K3{tag}] {k3_ms:.3f} ms per update ({ctx.steps} steps of {fused16.rows} rows, one graph replay); captured "
        f"in {ctx.capture_ms:.1f} ms, instantiated in {ctx.instantiate_ms:.1f} ms")
    out["k3_update_ms"], out["k3_capture_ms"] = k3_ms, ctx.capture_ms
    del ctx
    row = k2_timed_row(fused16, p0, bufs16, dev, tag,
                       f"K2 PPO minibatch loss + gradients (GR1T1 at {BIG_ENVS} envs, {fused16.rows} rows, bf16 "
                       "operands)", k2_err, gemm_worst)
    row["launches"] = one["k2"]
    row["launches_from"] = "one iteration of the bench's envs8192 cell, counted alone"
    out["one_iteration_launches"] = one
    out["seconds"] = time.perf_counter() - t18
    log(f"[time] phase 18 took {out['seconds']:.1f} s")
    del setups, fused16, bufs16, fused32, bufs32, runner, env
    return out, k1_row, row


# phase 19: the compiled iteration (learn/graphs.py, OnPolicyRunner._train_iter)
COMPILED_CALLS = 3     # (a), (b): the first call warms up and captures, the next two replay
COMPILED_TIMED = 10    # graphed iterations timed; eager ones: EAGER_TIMED
EAGER_TIMED = 3
EVAL_GRAPH_ENVS, EVAL_GRAPH_STEPS = 50, 20   # (e): play's envs, bit for bit
EVAL_TIMED_ENVS, EVAL_TIMED_STEPS = 64, 100  # (e): the eval step timed at eval_tracking's envs
PLANT_STIFFNESS = 1.05  # (f2): the other K1 instance's contact stiffness (a __constant__ value)


def _bits(x):
    """A tensor's bits, as an integer tensor (NaN compared by pattern)."""
    import torch

    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()]) if x.is_floating_point() else x


def tree_diffs(got, want, prefix=""):
    """The leaves of two state trees (or dicts, named tuples of tensors) that
    differ in a bit, their shape or type; generators by seed and offset."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import graphs

    out = []
    for (p, x), (_, y) in zip(graphs.leaves(got, prefix), graphs.leaves(want, prefix)):
        if torch.is_tensor(x):
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(_bits(x), _bits(y)):
                out.append(p)
        elif isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                out.append(p)
        elif x is not y and x != y:
            out.append(p)
    return out


def injected_draws(runner, seed, dev):
    """(noise, u, perm) of one iteration, drawn on the card from ``seed``."""
    import torch

    env, t = runner.env, runner.num_steps_per_env
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((t, env.num_envs, env.num_actions), generator=g, device=dev)
    u = torch.rand((t, env.num_envs, env._step_u_cols[1]), generator=g, device=dev)
    # the update's blocks (the recurrent update's env columns), of the global
    # batch under the global shuffle
    n_blocks, used = runner.alg.perm_size(t, env.num_envs, recurrent=runner.recurrent)
    return noise, u, torch.randperm(n_blocks, generator=g, device=dev)[:used]


def compiled_vs_eager(runner, s_e, s_g, calls, draws, dev, tag, phase="19"):
    """``calls`` iterations of the eager ``iteration`` and of ``_train_iter``
    side by side, each fed its own last state; every collection output, the
    env state, the obs, the PPO state and the metrics compared bit for bit
    (``draws``: "injected" noise, u and perm, or "generators"; the lines
    tagged ``[<phase> <tag>]``). Returns (the per-call diff lists, the
    sampled noise of each graphed call)."""
    import torch

    diffs, eps = [], []
    mode = "inject" if draws == "injected" else "draw"
    for it in range(calls):
        kw = dict(zip(("noise", "u", "perm"), injected_draws(runner, 1000 + it, dev))) \
            if draws == "injected" else {}
        want = {}
        s_e, m_e = runner.iteration(s_e, out=want, **kw)
        graph = runner.compiled.collect.get(mode) if runner.compiled else None
        how = "replay" if graph is not None and graph.graph is not None else "warm-up and capture"
        s_g, m_g = runner._train_iter(s_g, **kw)
        got = runner.compiled.last
        d = tree_diffs({k: got[k] for k in want}, want)
        d += tree_diffs(s_g, s_e, "state")
        d += [f"metric {k}" for k in m_e if not torch.equal(_bits(m_g[k]), _bits(m_e[k]))]
        if list(m_g) != list(m_e):
            d.append("metric keys")
        b = got["batch"]
        eps.append(((b.actions - b.mu) / b.sigma).clone())
        diffs.append(d)
        log(f"[{phase} {tag}] call {it} ({how}, {draws} draws): "
            f"{'every output, the state and the metrics equal bit for bit' if not d else f'{len(d)} differ: {d[:12]}'}")
    return diffs, eps, s_e, s_g


def fresh_draws(eps_a, eps_b):
    """Whether two graphed calls sampled different action noise: the noise
    recovered as (actions - mu) / sigma (the same draws give it to float32
    rounding, fresh ones differ by O(1))."""
    import torch

    close = (eps_a - eps_b).abs() < 1e-3
    return float(close.float().mean()), float((eps_a - eps_b).abs().max())


def host_calls(prof):
    """The host's runtime launch, copy and set calls in a profile."""
    from torch.autograd import DeviceType

    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU and e.name.startswith("cu")
             and any(k in e.name for k in ("Launch", "Memcpy", "Memset"))]
    return {n: names.count(n) for n in sorted(set(names))}


def device_kernels(prof):
    """(device kernel ms, launches, K1 launches) in a profile."""
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k1 = sum(e.count for e in kern if any(n in e.key for n in KERNEL_NAMES["K1"]))
    return sum(dev_us(e) for e in kern) / 1e3, sum(e.count for e in kern), k1


def compiled_phase(dev):
    """Phase 19: the compiled iteration (``OnPolicyRunner._train_iter``: the
    collection graph and K3's donated update graph; ``LeggedEnv.step_graph``).
    (t) GR1T1 at 4096 envs: peak memory and iteration times of the eager
    ``iteration`` and of ``_train_iter`` (min / median / max; collection and
    update from the CUDA events), the graphs' warm-up, capture and
    instantiate ms and kernel nodes, the launch counts of the graphed
    iterations (K1 64, K2 200, K3 1 each). (a) Injected noise, u and perm:
    three ``_train_iter`` calls (warm-up and capture, then two replays of
    the donated state) against three eager iterations, every collection
    output (the Transition's nine fields, last values, returns,
    advantages), the env state, the obs, the PPO state (p, m, v, count, LR)
    and the metrics bit for bit. (b) Generator draws, the same: the graphed
    draws equal the eager ones from the same generator states (and leave the
    generators where the eager ones are), and two consecutive replays sample
    other noise. (f2) A second GR1T1 env of the same K1 size set with the
    contact stiffness x``PLANT_STIFFNESS`` (a value in K1's __constant__
    memory) steps eagerly, uploading its constants, between two replays of
    the same state and draws: the replays must agree bit for bit, the
    planted env's step must differ from the main env's, and its next eager
    step must equal its first. (c) One graphed and one eager iteration under
    torch.profiler: the host's launch calls, the device time and the busy
    share, K1's device launches. (d) heightfield and GR1T1_full: two
    ``_train_iter`` calls against eager under (a)'s rule. (e) Play's config
    at 50 envs: ``step_graph`` against ``step`` bit for bit for 20 steps;
    the eval step at 64 envs timed both ways. (f1) A fresh compiled
    iteration whose capture does not register the generators must fail (b):
    the capture raises, or two replays sample the same noise."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import graphs
    from wiki_grx_gym_tpu_torch.scripts.play import no_randomization
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    t19 = time.perf_counter()
    out = {}

    def make(task="GR1T1", mutate=None, n=N_ENVS):
        cfg, train_cfg = task_registry.get_cfgs(task)
        cfg.env.num_envs = n
        if mutate is not None:
            mutate(cfg)
        env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
        runner, _ = task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)
        return env, runner

    # ---- (t) peak memory and times, eager then graphed ----
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    env, runner = make()
    if runner.eager_reason is not None:
        fail(f"phase 19: GR1T1 is not compiled: {runner.eager_reason}")
        return out
    state = runner.init_state(init_at_random_ep_len=True)
    eager = []
    for _ in range(EAGER_TIMED + 1):
        t0 = time.perf_counter()
        state, _ = runner.iteration(state)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0, dict(runner.last_timing)))
    eager = eager[1:]
    peak_eager = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    graphed = []
    reset_launch_counts()
    for _ in range(COMPILED_TIMED + 1):
        t0 = time.perf_counter()
        state, metrics = runner._train_iter(state)
        graphed.append((time.perf_counter() - t0, dict(runner.last_timing)))
    launches = dict(LAUNCHES)
    peak_graphed = torch.cuda.max_memory_allocated() / 2**30
    first, graphed = graphed[0], graphed[1:]
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    calls = COMPILED_TIMED + 1
    want = {"k1": calls * ROLLOUT_STEPS, "k2": calls * steps, "k3": calls}
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    ms = lambda xs: [1e3 * x for x in xs]
    stats = lambda xs: {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}
    t_out = {
        "eager_iteration_ms": stats(ms([w for w, _ in eager])),
        "eager_collection_ms": stats(ms([t["collection_s"] for _, t in eager])),
        "eager_update_ms": stats(ms([t["update_s"] for _, t in eager])),
        "graphed_iteration_ms": stats(ms([w for w, _ in graphed])),
        "graphed_collection_ms": stats(ms([t["collection_s"] for _, t in graphed])),
        "graphed_update_ms": stats(ms([t["update_s"] for _, t in graphed])),
        "first_call_ms": 1e3 * first[0], "peak_mem_gib_eager": peak_eager, "peak_mem_gib_graphed": peak_graphed,
        "launches": launches, "graphs": runner.compiled.reports(),
    }
    out["t"] = t_out
    log(f"[19 t] GR1T1 at {N_ENVS} envs: eager iteration ms {t_out['eager_iteration_ms']} (collection "
        f"{t_out['eager_collection_ms']['median']:.2f}, update {t_out['eager_update_ms']['median']:.2f}); "
        f"graphed {t_out['graphed_iteration_ms']} (collection {t_out['graphed_collection_ms']['median']:.2f}, "
        f"update {t_out['graphed_update_ms']['median']:.2f}, from the events); the first call {1e3 * first[0]:.1f} "
        f"ms; peak memory eager {peak_eager:.3f} GiB, graphed {peak_graphed:.3f} GiB")
    for g in t_out["graphs"]:
        log(f"[19 t] graph {json.dumps(g)}")
    log(f"[19 t] {calls} graphed iterations launched {launches} (expected {want}); metrics finite {finite}")
    if launches != want or not finite:
        fail(f"phase 19 (t): {calls} graphed iterations launched {launches}, not {want}, or non-finite metrics")

    # ---- (a) injected draws, 3 calls against eager ----
    diffs, _, _, s_g = compiled_vs_eager(runner, runner.init_state(), runner.init_state(), COMPILED_CALLS,
                                         "injected", dev, "a GR1T1")
    out["a"] = {"calls": COMPILED_CALLS, "differing": diffs}
    if any(diffs):
        fail(f"phase 19 (a): the compiled iteration differs from the eager one: {diffs}")

    # ---- (b) generator draws: the same draws as eager, fresh on each replay ----
    diffs, eps, _, s_g = compiled_vs_eager(runner, runner.init_state(), runner.init_state(), COMPILED_CALLS,
                                           "generators", dev, "b GR1T1")
    same_share, max_diff = fresh_draws(eps[1], eps[2])
    fresh = same_share < 0.01 and max_diff > 0.5
    log(f"[19 b] replays 1 and 2 sampled noise equal to 1e-3 in {100 * same_share:.3f}% of the entries, largest "
        f"|diff| {max_diff:.3f}: fresh {fresh}")
    out["b"] = {"differing": diffs, "same_noise_share": same_share, "max_noise_diff": max_diff, "fresh": fresh}
    if any(diffs) or not fresh:
        fail(f"phase 19 (b): generator draws differ from eager ({diffs}) or are not fresh ({same_share}, {max_diff})")

    # ---- (f2) another K1 instance of the same sizes uploads between two replays ----
    plant = lambda cfg: setattr(cfg.sim, "contact_stiffness", cfg.sim.contact_stiffness * PLANT_STIFFNESS)
    env2 = cuda_step.task_env("GR1T1", N_ENVS, dev, plant)
    op, op2 = env.decimation_op, env2.decimation_op
    x = graphs.map_tensors(torch.clone, runner.compiled.static)
    draws = dict(zip(("noise", "u", "perm"), injected_draws(runner, 77, dev)))
    zeros = torch.zeros((N_ENVS, env.num_actions), device=dev)
    u0 = draws["u"][0]
    _, o1 = env.step(x.env_state, zeros, u=u0)   # the main env's step (its constants)
    runner._train_iter(x, **draws)
    first_batch = graphs.map_tensors(torch.clone, runner.compiled.last["batch"])
    _, o2a = env2.step(x.env_state, zeros, u=u0)   # the planted env uploads its constants (the eager path)
    o2a = graphs.map_tensors(torch.clone, o2a)
    runner._train_iter(x, **draws)   # the replay right after the planted upload
    d_replay = tree_diffs(runner.compiled.last["batch"], first_batch)
    owner = cuda_step._CONST_OWNER.get(op.sizes) is op
    _, o2b = env2.step(x.env_state, zeros, u=u0)   # it must upload again after the replay
    visible = bool((o1.obs != o2a.obs).any())
    d_again = tree_diffs({k: getattr(o2b, k) for k in ("obs", "pri_obs", "rew", "reset")},
                         {k: getattr(o2a, k) for k in ("obs", "pri_obs", "rew", "reset")})
    log(f"[19 f2] a GR1T1 env with contact stiffness x{PLANT_STIFFNESS} (same K1 sizes: {op2.sizes == op.sizes}) "
        f"stepped eagerly between two replays: the replays differ in {d_replay or 'nothing'}; its step differs from "
        f"the main env's: {visible}; the replay left the main wrapper the owner of the constants: {owner}; its next "
        f"step equals its first: {not d_again}")
    out["f2"] = {"same_sizes": op2.sizes == op.sizes, "replay_diffs": d_replay, "plant_visible": visible,
                 "owner_after_replay": owner, "planted_step_diffs": d_again}
    if d_replay or not visible or not owner or d_again or op2.sizes != op.sizes:
        fail(f"phase 19 (f2): {out['f2']}")
    del env2, op2, x, first_batch, o1, o2a, o2b

    # ---- (c) host launches, device time: one graphed and one eager iteration under the profiler ----
    prof_out = {}
    for name, fn in (("graphed", lambda s: runner._train_iter(s)), ("eager", lambda s: runner.iteration(s))):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s_g, _ = fn(s_g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        host = host_calls(prof)
        dev_ms, kernels, k1_seen = device_kernels(prof)
        wall_unprofiled = (t_out["graphed_iteration_ms"] if name == "graphed" else t_out["eager_iteration_ms"])["median"]
        prof_out[name] = {"host_calls": host, "host_launch_calls": sum(v for k, v in host.items() if "Launch" in k),
                          "device_ms": dev_ms, "device_kernels": kernels, "k1_device_launches": k1_seen,
                          "busy_share": dev_ms / wall_unprofiled, "profiled_wall_ms": 1e3 * wall,
                          "launches": dict(LAUNCHES)}
        log(f"[19 c] one {name} iteration under the profiler: host calls {host}; device kernels {dev_ms:.1f} ms in "
            f"{kernels} launches (K1 {k1_seen}); device busy {100 * dev_ms / wall_unprofiled:.1f}% of the unprofiled "
            f"median {wall_unprofiled:.1f} ms; kernel counts {dict(LAUNCHES)}")
    out["c"] = prof_out
    lg, le = prof_out["graphed"]["launches"], prof_out["eager"]["launches"]
    if lg != le or lg != {"k1": ROLLOUT_STEPS, "k2": steps, "k3": 1}:
        fail(f"phase 19 (c): kernel counts graphed {lg}, eager {le}")
    if prof_out["graphed"]["host_calls"] and prof_out["graphed"]["host_launch_calls"] > 100:
        fail(f"phase 19 (c): the graphed iteration made {prof_out['graphed']['host_launch_calls']} host launch calls")
    del runner, env, state, s_g, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) other configs: heightfield, GR1T1_full ----
    out["d"] = {}
    for name, task, mutate in (("heightfield", "GR1T1", heightfield), ("GR1T1_full", "GR1T1_full", None)):
        env, runner = make(task, mutate)
        if runner.eager_reason is not None:
            fail(f"phase 19 (d): {name} is not compiled: {runner.eager_reason}")
            continue
        diffs, _, _, _ = compiled_vs_eager(runner, runner.init_state(), runner.init_state(), 2, "injected", dev,
                                           f"d {name}")
        out["d"][name] = {"differing": diffs, "graphs": runner.compiled.reports()}
        for g in out["d"][name]["graphs"]:
            log(f"[19 d {name}] graph {json.dumps(g)}")
        if any(diffs):
            fail(f"phase 19 (d): {name} differs from eager: {diffs}")
        del env, runner
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (e) eval: step_graph against step at play's 50 envs; the eval step timed at 64 envs ----
    def eval_env(n):
        cfg, _ = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = n
        no_randomization(cfg)
        return task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)[0]

    env = eval_env(EVAL_GRAPH_ENVS)
    s_e, s_g = env.init_state(0), env.init_state(0)
    g = torch.Generator(device=dev).manual_seed(5)
    e_diffs = []
    for t in range(EVAL_GRAPH_STEPS):
        a = 0.3 * torch.randn((EVAL_GRAPH_ENVS, env.num_actions), generator=g, device=dev)
        s_e, o_e = env.step(s_e, a)
        s_g, o_g = env.step_graph(s_g, a)
        d = tree_diffs(s_g, s_e, "state") + tree_diffs({k: getattr(o_g, k) for k in ("obs", "pri_obs", "rew", "reset")},
                                                       {k: getattr(o_e, k) for k in ("obs", "pri_obs", "rew", "reset")})
        if d:
            e_diffs.append((t, d[:8]))
    sg = next(iter(env._step_graphs.values())).graph
    log(f"[19 e] step_graph against step at {EVAL_GRAPH_ENVS} envs, {EVAL_GRAPH_STEPS} steps: "
        f"{'equal bit for bit' if not e_diffs else e_diffs}; the step graph {json.dumps(sg.report())}")
    timed = {}
    env = eval_env(EVAL_TIMED_ENVS)
    for name in ("eager", "graphed"):
        st = env.init_state(0)
        a = torch.zeros((EVAL_TIMED_ENVS, env.num_actions), device=dev)
        fn = env.step if name == "eager" else env.step_graph
        each = []
        for _ in range(EVAL_TIMED_STEPS + 1):
            t0 = time.perf_counter()
            st, o = fn(st, a)
            torch.cuda.synchronize()
            each.append(1e3 * (time.perf_counter() - t0))
        timed[name] = stats(each[1:])
    log(f"[19 e] the eval step at {EVAL_TIMED_ENVS} envs, ms (host clock, each ended by a synchronize): "
        f"eager {timed['eager']}, graphed {timed['graphed']}")
    out["e"] = {"differing": e_diffs, "step_graph": sg.report(), "step_ms": timed}
    if e_diffs:
        fail(f"phase 19 (e): step_graph differs from step: {e_diffs}")
    del env, s_e, s_g

    # ---- (f1) planted: a capture that does not register the generators ----
    env, runner = make()
    torch.cuda.CUDAGraph.register_generator_state = lambda self, gen: None   # shadows the real one
    caught = None
    try:
        s = runner.init_state()
        eps = []
        for _ in range(COMPILED_CALLS):
            s, _ = runner._train_iter(s)
            b = runner.compiled.last["batch"]
            eps.append(((b.actions - b.mu) / b.sigma).clone())
        same_share, max_diff = fresh_draws(eps[1], eps[2])
        if not (same_share < 0.01 and max_diff > 0.5):
            caught = f"(b)'s check: replays 1 and 2 sampled the same noise ({100 * same_share:.2f}% equal)"
    except RuntimeError as e:
        caught = f"the capture raised: {str(e).splitlines()[0][:200]}"
    finally:
        del torch.cuda.CUDAGraph.register_generator_state
    log(f"[19 f1] a capture without the generators registered: caught {caught is not None} ({caught})")
    out["f1"] = {"caught": caught}
    if caught is None:
        fail("phase 19 (f1): a graph captured without its generators drew fresh noise: the planted fault went unseen")
    del env, runner
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t19
    log(f"[time] phase 19 took {out['seconds']:.1f} s")
    return out


# phase 20: the compiled update on the recurrent, step and xla paths
UPDATE_CONFIGS = {   # name: (task, algorithm settings)
    "GR1T1_lstm": ("GR1T1_lstm", {}),
    "symmetry": ("GR1T1", {"fused_mega": False, "fused_update": False, "symmetry_coef": SYMMETRY_COEF}),
    "step_path": ("GR1T1", {"fused_mega": False}),
    "xla_path": ("GR1T1", {"fused_update": False}),
}
UPDATE_CALLS = 2    # (a): compiled against eager, injected draws
# (a) and (c) of GR1T1_lstm at 4 steps an env (T cut from 64: its eager
# iteration, ~28-32 s at 64 steps and 15 s at 16 on a slow host, scales
# with T); (b) at the task's 64
UPDATE_CHECK_STEPS = {"GR1T1_lstm": 4}
UPDATE_TIMED = 3    # (b): graphed iterations timed (generator draws), after one that captures their collection
STEP_PROFILED = 10  # (b), GR1T1_lstm: grad-step replays under the profiler (a whole update is ~1.6M kernels)


def _tensor_diffs(got, want, prefix):
    """The tensor leaves of two trees that differ in a bit (generators left
    out: a planted run's and a later eager call's generators are others)."""
    import torch

    from wiki_grx_gym_tpu_torch.learn import graphs

    return [p for (p, x), (_, y) in zip(graphs.leaves(got, prefix), graphs.leaves(want, prefix))
            if torch.is_tensor(x) and (x.shape != y.shape or not torch.equal(_bits(x), _bits(y)))]


def update_config_check(dev, name, task, alg_kw):
    """Phase 20 on one config (:func:`compiled_update_phase`): (a), (b) and,
    recurrent, (c). Returns its results (None if the config is not
    compiled, a failure); everything it made is freed when it returns."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import graphs

    ms = lambda xs: [1e3 * x for x in xs]
    stats = lambda xs: {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}
    t_cfg = time.perf_counter()

    def make(steps=None):
        cfg, train_cfg = task_registry.get_cfgs(task)
        cfg.env.num_envs = N_ENVS
        if steps is not None:
            train_cfg.runner.num_steps_per_env = steps
        for k, v in alg_kw.items():
            setattr(train_cfg.algorithm, k, v)
        env, _ = task_registry.make_env(task, env_cfg=cfg, device=dev)
        return task_registry.make_alg_runner(env, task, train_cfg=train_cfg, log_root=None)[0]

    check_steps = UPDATE_CHECK_STEPS.get(name)
    runner = make(check_steps)
    path = "recurrent" if runner.recurrent else runner.alg.path
    if runner.eager_reason is not None:
        fail(f"phase 20: {name} is not compiled: {runner.eager_reason}")
        return None
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    k2_each = steps if path == "step" else 0

    # ---- (a) against eager, injected draws ----
    base = torch.cuda.memory_allocated() / 2**30   # what earlier work left allocated
    torch.cuda.reset_peak_memory_stats()
    p0 = runner.net.params_flat.clone()   # (c) starts from these params again
    s_e, s_g = runner.init_state(), runner.init_state()
    diffs, eager, first_ms, ref0 = [], [], [], None
    for it in range(UPDATE_CALLS):
        kw = dict(zip(("noise", "u", "perm"), injected_draws(runner, 2000 + it, dev)))
        want = {}
        t0 = time.perf_counter()
        s_e, m_e = runner.iteration(s_e, out=want, **kw)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0, dict(runner.last_timing)))
        if it == 0:
            ref0 = graphs.map_tensors(torch.clone, {"draws": kw, "out": want, "state": s_e, "metrics": m_e})
        t0 = time.perf_counter()
        s_g, m_g = runner._train_iter(s_g, **kw)
        first_ms.append(1e3 * (time.perf_counter() - t0))
        d = tree_diffs({k: runner.compiled.last[k] for k in want}, want)
        d += tree_diffs(s_g, s_e, "state")
        d += [f"metric {k}" for k in m_e if not torch.equal(_bits(m_g[k]), _bits(m_e[k]))]
        diffs.append(d)
        log(f"[20 a {name}] call {it} ({path} update; {'warm-up and capture' if it == 0 else 'replay'}; "
            f"{runner.num_steps_per_env} steps an env): "
            f"{'every output, the state and the metrics equal bit for bit' if not d else f'{len(d)} differ: {d[:12]}'}")
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    res = {"path": path, "a": {"calls": UPDATE_CALLS, "steps": runner.num_steps_per_env, "differing": diffs,
                               "graphed_call_ms": first_ms}}
    if any(diffs):
        fail(f"phase 20 (a): {name}'s compiled iteration differs from the eager one: {diffs}")
    del s_e
    checked = runner   # (c) plants its faults in (a)'s config
    if check_steps is not None:   # (b) at the task's own depth
        checked.compiled = None
        runner = make()
        s_g = runner.init_state()

    # ---- (b) timed graphed iterations (generator draws) ----
    torch.cuda.reset_peak_memory_stats()
    s_g, _ = runner._train_iter(s_g)   # captures the generators' collection graph
    reset_launch_counts()
    graphed = []
    for _ in range(UPDATE_TIMED):
        t0 = time.perf_counter()
        s_g, metrics = runner._train_iter(s_g)
        graphed.append((time.perf_counter() - t0, dict(runner.last_timing)))
    launches = dict(LAUNCHES)
    want_l = {"k1": UPDATE_TIMED * ROLLOUT_STEPS, "k2": UPDATE_TIMED * k2_each, "k3": 0}
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    reserved_b = torch.cuda.max_memory_reserved() / 2**30
    b = {"eager_iteration_ms": stats(ms([w for w, _ in eager])),
         "eager_collection_ms": stats(ms([t["collection_s"] for _, t in eager])),
         "eager_update_ms": stats(ms([t["update_s"] for _, t in eager])),
         "eager_steps": checked.num_steps_per_env, "graphed_steps": runner.num_steps_per_env,
         "graphed_iteration_ms": stats(ms([w for w, _ in graphed])),
         "graphed_collection_ms": stats(ms([t["collection_s"] for _, t in graphed])),
         "graphed_update_ms": stats(ms([t["update_s"] for _, t in graphed])),
         "launches": launches, "base_mem_gib": base, "peak_mem_gib_a": peak_a, "peak_mem_gib_graphed": peak_b,
         "peak_reserved_gib_graphed": reserved_b, "graphs": runner.compiled.reports()}
    log(f"[20 b {name}] eager iteration ({checked.num_steps_per_env} steps) ms {b['eager_iteration_ms']} (collection "
        f"{b['eager_collection_ms']['median']:.2f}, update {b['eager_update_ms']['median']:.2f}); graphed "
        f"({runner.num_steps_per_env} steps) {b['graphed_iteration_ms']} (collection "
        f"{b['graphed_collection_ms']['median']:.2f}, update "
        f"{b['graphed_update_ms']['median']:.2f}, from the events); peak memory {peak_a:.3f} GiB in (a), from "
        f"{base:.3f} GiB allocated before it, "
        f"graphed {peak_b:.3f} GiB (reserved {reserved_b:.3f}); {UPDATE_TIMED} graphed iterations launched "
        f"{launches} (expected {want_l}); metrics finite {finite}")
    for g in b["graphs"]:
        log(f"[20 b {name}] graph {json.dumps(g)}")
    if launches != want_l or not finite:
        fail(f"phase 20 (b): {name}'s graphed iterations launched {launches}, not {want_l}, or non-finite metrics")
    wall_ms = b["graphed_iteration_ms"]["median"]
    if path != "recurrent":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s_g, _ = runner._train_iter(s_g)
            torch.cuda.synchronize()
        host = host_calls(prof)
        dev_ms, kernels, _ = device_kernels(prof)
        b["profile"] = {"host_calls": host, "host_launch_calls": sum(v for k, v in host.items() if "Launch" in k),
                        "device_ms": dev_ms, "device_kernels": kernels, "busy_share": dev_ms / wall_ms}
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s_g, _ = runner._train_iter(s_g)
            torch.cuda.synchronize()
        host = host_calls(prof)
        ci = runner.compiled
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ci.collect["draw"]()
            torch.cuda.synchronize()
        coll_ms, coll_k, _ = device_kernels(prof)
        ci.step_index.zero_()
        n_prof = min(STEP_PROFILED, steps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                ci.update()
            torch.cuda.synchronize()
        step_ms, step_k, _ = device_kernels(prof)
        est = coll_ms + steps * step_ms / n_prof
        b["profile"] = {"host_calls": host, "host_launch_calls": sum(v for k, v in host.items() if "Launch" in k),
                        "collection_device_ms": coll_ms, "collection_kernels": coll_k,
                        "grad_step_device_ms": step_ms / n_prof, "grad_step_kernels": step_k / n_prof,
                        "device_ms_estimate": est, "busy_share_estimate": est / wall_ms}
    log(f"[20 b {name}] profile {json.dumps(b['profile'])}")
    if b["profile"]["host_calls"] and b["profile"]["host_launch_calls"] > steps + 100:
        fail(f"phase 20 (b): {name}'s graphed iteration made {b['profile']['host_launch_calls']} host launch calls")
    res["b"] = b

    # ---- (c) planted faults must fail (a)'s check ----
    if checked is not runner:
        runner.compiled = None
        del runner
    if path == "recurrent":
        from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration

        plants = {"step index not advanced": ("_advance", lambda self: None),
                  "collection keeps the old memory": (
                      "_collected", lambda self, rs: rs.replace(ppo=self.static.ppo, hidden=self.static.hidden))}
        res["c"] = {}
        for plant, (attr, fn) in plants.items():
            checked.compiled = None
            gc.collect()
            orig = getattr(CompiledIteration, attr)
            setattr(CompiledIteration, attr, fn)
            try:
                s0 = checked.init_state()
                s0 = s0.replace(ppo=s0.ppo.replace(params=p0.clone()))
                s_p, m_p = checked._train_iter(s0, **ref0["draws"])
                d = _tensor_diffs({"ppo": s_p.ppo, "hidden": s_p.hidden, "metrics": m_p},
                                  {"ppo": ref0["state"].ppo, "hidden": ref0["state"].hidden,
                                   "metrics": ref0["metrics"]}, "")
            finally:
                setattr(CompiledIteration, attr, orig)
            res["c"][plant] = {"caught": bool(d), "differing": d}
            log(f"[20 c {name}] planted: {plant}: (a)'s check against the first eager call differs in {d[:8]}: "
                f"caught {bool(d)}")
            if not d:
                fail(f"phase 20 (c): the planted fault ({plant}) passed (a)'s check")
    res["seconds"] = time.perf_counter() - t_cfg
    log(f"[time] phase 20 {name} took {res['seconds']:.1f} s")
    return res


def compiled_update_phase(dev):
    """Phase 20: the compiled iteration on the update paths beside K3's,
    at 4096 envs: the registry's GR1T1_lstm (the recurrent update: one grad
    step's graph replayed 200 times, the step index on the device), GR1T1
    with the symmetry loss on the xla path, on the step path (K2 a grad
    step inside the update's graph) and on the xla path. For each: (a)
    ``UPDATE_CALLS`` ``_train_iter`` calls against as many eager
    ``iteration`` calls with injected noise, u and perm, each fed its own
    last state: the collection's outputs, the state (env state, obs, the
    LSTM memory, the PPO state) and the metrics bit for bit; the eager
    calls' times are (b)'s eager side. (b) ``UPDATE_TIMED`` graphed
    iterations with generator draws (min / median / max; collection and
    update from the CUDA events), their launch counts (K1 64 each, K2 200
    each on the step path), the graphs' warm-up, capture and instantiate ms
    and kernel nodes, peak memory; one graphed iteration under
    torch.profiler: the host's launch calls and, but for GR1T1_lstm, the
    device time and busy share (GR1T1_lstm: the host calls from a CPU-only
    profile; the device time of one collection replay and
    ``STEP_PROFILED`` grad-step replays, the busy share estimated from
    them). (c) GR1T1_lstm: two planted faults must fail (a)'s check against
    its first eager call: a grad-step graph whose step index does not
    advance (every step on minibatch 0) and a collection that keeps the
    old memory."""
    import torch

    t20 = time.perf_counter()
    out = {}
    for name, (task, alg_kw) in UPDATE_CONFIGS.items():
        gc.collect()
        torch.cuda.empty_cache()
        res = update_config_check(dev, name, task, alg_kw)
        if res is not None:
            out[name] = res
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t20
    log(f"[time] phase 20 took {out['seconds']:.1f} s")
    return out


# phase 21: the compiled iteration on the engine path (learn/graphs.py: one
# rollout step's graph replayed T times, then the collection's tail)
ENGINE_CALLS = 2              # (a): compiled against eager, each source of draws
# (a) and (c): 4 steps an env (T cut from 64; the eager side is
# host-bound, ~29 s an iteration of 64 steps at any env count); (b) at 64
ENGINE_GEN_STEPS = 4
ENGINE_TIMED = 3              # (b): graphed iterations timed
ENGINE_STEPS_PROFILED = 4     # (b): A1 replays under the profiler (a whole collection is ~1.7M kernels)
ENGINE_EVAL_ENVS, ENGINE_EVAL_STEPS, ENGINE_EVAL_TIMED = 64, 5, 10   # (d)


def engine_compiled_phase(dev):
    """Phase 21: the compiled iteration on the engine (GR1T1 with
    ``use_pallas = False``: A1 one rollout step's graph over the static
    state, buffers and sums, the step index on the device, replayed 64
    times; A2 the last values, GAE, the update's inputs and the sums; K3's
    update graph). (a) At 4096 envs, ``ENGINE_CALLS`` ``_train_iter`` calls
    against as many eager ``iteration`` calls with injected noise, u and
    perm, each fed its own last state: the collection's outputs (the
    Transition, the acc sums, last values, returns, advantages), the state
    and the metrics bit for bit; then the same with generator draws at
    4096 envs and ``ENGINE_GEN_STEPS`` steps an env. (b) ``ENGINE_TIMED`` graphed iterations at
    4096 envs (generator draws): min / median / max, the collection and
    update from the CUDA events, env-steps/s, the launch counts (K1 0, K2
    200, K3 1 each), each graph's warm-up, capture and instantiate ms and
    kernel nodes, peak memory; the host's launch calls of one graphed
    iteration (a CPU-only profile: T + 2 graph launches, and at most 4
    kernels a graph launch, the registered generators' seed and offset
    written before a replay); the device time of ``ENGINE_STEPS_PROFILED``
    A1 replays and of A2 + the update under torch.profiler, and the busy
    share estimated from them. (c) A planted fault: A1 replayed without
    advancing its device index must fail (a)'s check against the first
    eager call. (d) ``env.step_graph`` on the engine at 64 envs (play's
    config) against ``env.step`` bit for bit over 5 steps; the step timed
    both ways."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import graphs
    from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration
    from wiki_grx_gym_tpu_torch.scripts.play import no_randomization

    t21 = time.perf_counter()
    out = {}
    ms = lambda xs: [1e3 * x for x in xs]
    stats = lambda xs: {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}

    def make(n, steps=None):
        cfg, train_cfg = task_registry.get_cfgs("GR1T1")
        cfg.env.num_envs = n
        if steps is not None:
            train_cfg.runner.num_steps_per_env = steps
        engine_path(cfg)
        env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
        runner, _ = task_registry.make_alg_runner(env, "GR1T1", train_cfg=train_cfg, log_root=None)
        return env, runner

    env, runner = make(N_ENVS, ENGINE_GEN_STEPS)
    if env.backend != "engine" or runner.eager_reason is not None:
        fail(f"phase 21: the engine's iteration is not compiled ({env.backend}: {runner.eager_reason})")
        return out
    steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
    checked = runner   # (a) and (c) at ENGINE_GEN_STEPS steps an env

    # ---- (a) injected draws at 4096 envs against eager ----
    torch.cuda.reset_peak_memory_stats()
    p0 = runner.net.params_flat.clone()   # (c) starts from these params again
    s_e, s_g = runner.init_state(), runner.init_state()
    diffs, eager, first_ms, ref0 = [], [], [], None
    for it in range(ENGINE_CALLS):
        kw = dict(zip(("noise", "u", "perm"), injected_draws(runner, 3000 + it, dev)))
        want = {}
        t0 = time.perf_counter()
        s_e, m_e = runner.iteration(s_e, out=want, **kw)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0, dict(runner.last_timing)))
        if it == 0:
            ref0 = graphs.map_tensors(torch.clone, {"draws": kw, "out": want, "state": s_e, "metrics": m_e})
        t0 = time.perf_counter()
        s_g, m_g = runner._train_iter(s_g, **kw)
        first_ms.append(1e3 * (time.perf_counter() - t0))
        d = tree_diffs({k: runner.compiled.last[k] for k in want}, want)
        d += tree_diffs(s_g, s_e, "state")
        d += [f"metric {k}" for k in m_e if not torch.equal(_bits(m_g[k]), _bits(m_e[k]))]
        diffs.append(d)
        how = f"warm-up, capture and {runner.num_steps_per_env - 1} A1 replays" if it == 0 else "replays"
        log(f"[21 a] call {it} ({how}, injected "
            f"draws, {N_ENVS} envs, {runner.num_steps_per_env} steps an env): "
            f"{'every output, the state and the metrics equal bit for bit' if not d else f'{len(d)} differ: {d[:12]}'}")
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    out["a"] = {"calls": ENGINE_CALLS, "differing": diffs, "graphed_call_ms": first_ms}
    if any(diffs):
        fail(f"phase 21 (a): the engine's compiled iteration differs from the eager one: {diffs}")
    del s_e

    # ---- (b) timed graphed iterations (generator draws), 64 steps an env ----
    checked.compiled = None
    env, runner = make(N_ENVS)
    torch.cuda.reset_peak_memory_stats()
    s_g, _ = runner._train_iter(runner.init_state())   # warms up and captures the generators' graphs
    reset_launch_counts()
    graphed = []
    for _ in range(ENGINE_TIMED):
        t0 = time.perf_counter()
        s_g, metrics = runner._train_iter(s_g)
        graphed.append((time.perf_counter() - t0, dict(runner.last_timing)))
    launches = dict(LAUNCHES)
    want_l = {"k1": 0, "k2": ENGINE_TIMED * steps, "k3": ENGINE_TIMED}
    finite = all(math.isfinite(float(v)) for v in metrics.values())
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    ci = runner.compiled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s_g, _ = runner._train_iter(s_g)
        torch.cuda.synchronize()
    host = host_calls(prof)
    t_len = runner.num_steps_per_env
    n_prof = min(ENGINE_STEPS_PROFILED, t_len)   # the index starts at 0 and must stay below T
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            ci.collect["draw"]()
        torch.cuda.synchronize()
    step_ms, step_k, k1_seen = device_kernels(prof)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ci.tail["draw"]()   # zeroes the step index and the sums: the next call starts a collection
        ci._update()
        torch.cuda.synchronize()
    rest_ms, rest_k, _ = device_kernels(prof)
    wall = stats(ms([w for w, _ in graphed]))
    est = t_len * step_ms / n_prof + rest_ms
    b = {"eager_iteration_ms": stats(ms([w for w, _ in eager])),
         "eager_collection_ms": stats(ms([t["collection_s"] for _, t in eager])),
         "eager_update_ms": stats(ms([t["update_s"] for _, t in eager])),
         "eager_steps": checked.num_steps_per_env, "graphed_steps": t_len,
         "graphed_iteration_ms": wall,
         "graphed_collection_ms": stats(ms([t["collection_s"] for _, t in graphed])),
         "graphed_update_ms": stats(ms([t["update_s"] for _, t in graphed])),
         "env_steps_per_s": t_len * N_ENVS / (wall["median"] / 1e3),
         "launches": launches, "peak_mem_gib_a": peak_a, "peak_mem_gib_graphed": peak_b,
         "host_calls": host, "host_launch_calls": sum(v for k, v in host.items() if "Launch" in k),
         "step_device_ms": step_ms / n_prof, "step_kernels": step_k / n_prof,
         "step_k1_kernels": k1_seen, "tail_and_update_device_ms": rest_ms, "tail_and_update_kernels": rest_k,
         "device_ms_estimate": est, "busy_share_estimate": est / wall["median"], "graphs": ci.reports()}
    log(f"[21 b] GR1T1 on the engine at {N_ENVS} envs: eager iteration ({checked.num_steps_per_env} steps) ms "
        f"{b['eager_iteration_ms']} (collection "
        f"{b['eager_collection_ms']['median']:.2f}, update {b['eager_update_ms']['median']:.2f}); graphed "
        f"({t_len} steps) {wall} (collection {b['graphed_collection_ms']['median']:.2f}, update "
        f"{b['graphed_update_ms']['median']:.2f}, from the events); {b['env_steps_per_s']:.0f} env-steps/s at the "
        f"median; peak memory {peak_a:.3f} GiB in (a), graphed {peak_b:.3f} GiB; {ENGINE_TIMED} graphed iterations "
        f"launched {launches} (expected {want_l}); metrics finite {finite}")
    log(f"[21 b] one graphed iteration's host calls {host}; an A1 replay {b['step_device_ms']:.3f} ms of device "
        f"time in {b['step_kernels']:.0f} kernels (K1 {k1_seen}); A2 + the update {rest_ms:.3f} ms in {rest_k} "
        f"kernels; device time an iteration ~{est:.1f} ms, busy ~{100 * est / wall['median']:.1f}% of the median")
    for g in b["graphs"]:
        log(f"[21 b] graph {json.dumps(g)}")
    out["b"] = b
    if launches != want_l or not finite:
        fail(f"phase 21 (b): {ENGINE_TIMED} graphed engine iterations launched {launches}, not {want_l}, or "
             "non-finite metrics")
    n_graphs = host.get("cudaGraphLaunch", 0)
    if host and (n_graphs != t_len + 2 or b["host_launch_calls"] - n_graphs > 4 * n_graphs):
        fail(f"phase 21 (b): a graphed engine iteration made {host}: not {t_len + 2} graph launches and at most "
             f"4 kernels each")
    del s_g, ci, runner, env

    # ---- (c) planted: A1 replayed without advancing its device index ----
    runner = checked
    gc.collect()
    orig = CompiledIteration._advance_rollout
    CompiledIteration._advance_rollout = lambda self: None
    try:
        s0 = runner.init_state()
        s0 = s0.replace(ppo=s0.ppo.replace(params=p0.clone()))
        s_p, m_p = runner._train_iter(s0, **ref0["draws"])
        d = _tensor_diffs({"batch": runner.compiled.last["batch"], "ppo": s_p.ppo, "metrics": m_p},
                          {"batch": ref0["out"]["batch"], "ppo": ref0["state"].ppo, "metrics": ref0["metrics"]}, "")
    finally:
        CompiledIteration._advance_rollout = orig
    log(f"[21 c] planted: A1's step index not advanced: (a)'s check against the first eager call differs in "
        f"{d[:8]}: caught {bool(d)}")
    out["c"] = {"caught": bool(d), "differing": d}
    if not d:
        fail("phase 21 (c): A1 without its index advanced passed (a)'s check")
    del runner, checked, s0, s_p, ref0
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (a) generator draws, ENGINE_GEN_STEPS steps an env ----
    env, runner = make(N_ENVS, ENGINE_GEN_STEPS)
    g_diffs, _, _, _ = compiled_vs_eager(runner, runner.init_state(), runner.init_state(), ENGINE_CALLS,
                                         "generators", dev, f"a {ENGINE_GEN_STEPS} steps", phase="21")
    out["a"]["generators"] = {"envs": N_ENVS, "steps": ENGINE_GEN_STEPS, "differing": g_diffs}
    if any(g_diffs):
        fail(f"phase 21 (a): generator draws ({ENGINE_GEN_STEPS} steps an env) differ from eager: {g_diffs}")
    del env, runner
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) step_graph on the engine at play's 64 envs ----
    cfg, _ = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = ENGINE_EVAL_ENVS
    engine_path(cfg)
    no_randomization(cfg)
    env = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)[0]
    if env.step_graph_reason is not None:
        fail(f"phase 21 (d): the engine's step is not graphed: {env.step_graph_reason}")
    s_e, s_g = env.init_state(0), env.init_state(0)
    g = torch.Generator(device=dev).manual_seed(5)
    e_diffs = []
    for t in range(ENGINE_EVAL_STEPS):
        a = 0.3 * torch.randn((ENGINE_EVAL_ENVS, env.num_actions), generator=g, device=dev)
        s_e, o_e = env.step(s_e, a)
        s_g, o_g = env.step_graph(s_g, a)
        d = tree_diffs(s_g, s_e, "state") + tree_diffs({k: getattr(o_g, k) for k in ("obs", "pri_obs", "rew", "reset")},
                                                       {k: getattr(o_e, k) for k in ("obs", "pri_obs", "rew", "reset")})
        if d:
            e_diffs.append((t, d[:8]))
    sg = next(iter(env._step_graphs.values())).graph
    timed = {}
    for name in ("eager", "graphed"):
        st = env.init_state(0)
        a = torch.zeros((ENGINE_EVAL_ENVS, env.num_actions), device=dev)
        fn = env.step if name == "eager" else env.step_graph
        each = []
        for _ in range(ENGINE_EVAL_TIMED + 1):
            t0 = time.perf_counter()
            st, _ = fn(st, a)
            torch.cuda.synchronize()
            each.append(1e3 * (time.perf_counter() - t0))
        timed[name] = stats(each[1:])
    log(f"[21 d] step_graph against step on the engine at {ENGINE_EVAL_ENVS} envs, {ENGINE_EVAL_STEPS} steps: "
        f"{'equal bit for bit' if not e_diffs else e_diffs}; the step graph {json.dumps(sg.report())}; the step ms "
        f"(host clock, each ended by a synchronize): eager {timed['eager']}, graphed {timed['graphed']}")
    out["d"] = {"differing": e_diffs, "step_graph": sg.report(), "step_ms": timed}
    if e_diffs:
        fail(f"phase 21 (d): the engine's step_graph differs from step: {e_diffs}")
    del env, s_e, s_g, st
    gc.collect()
    torch.cuda.empty_cache()
    out["card"] = card_line()
    out["seconds"] = time.perf_counter() - t21
    log(f"[time] phase 21 took {out['seconds']:.1f} s")
    return out


# phase 22: the compiled iteration over NCCL (learn/graphs.py under
# parallel/mesh.py's groups; the collectives captured in the graphs)
NCCL_CALLS = 2        # compiled against eager, each source of draws
NCCL_TIMED = 5        # graphed iterations timed


class NcclWorld(NamedTuple):
    """One world of phase 22: its part ("a" to "d"), its cards (one
    rank a card), num_mp, the task, algorithm and sim settings, the steps
    an env (None: the task's), the world's deadline, and whether one
    graphed iteration is profiled on the device too (else on the host
    alone)."""

    part: str
    cards: int
    num_mp: int = 1
    task: str = "GR1T1"
    alg: dict = {}
    sim: dict = {}
    steps: Optional[int] = None
    deadline_s: float = 300.0
    device_profile: bool = True


# GR1T1 (GR1T1_lstm) with the all-terms fold and the command curriculum on:
# the curriculum runs only with the tracking_lin_vel term (GR1T1's own
# reward set has none), and then all-reduces in every env step. The engine
# and the LSTM at 16 steps an env (their eager iterations, host-bound, take
# ~29 s at 64 steps), a whole engine or LSTM iteration under the device
# profiler is ~0.4-1.7M kernel records: profiled on the host alone
NCCL_WORLDS = {
    "world1": NcclWorld("a", 1),                                            # the mega path (K3)
    "dp2_step": NcclWorld("b", 2, alg={"fused_mega": False}),               # K2 per shard
    "dp2_xla": NcclWorld("c", 2, alg={"fused_update": False}),
    "dp2_symmetry": NcclWorld("c", 2, alg={"symmetry_coef": SYMMETRY_COEF}),
    "dp2_engine": NcclWorld("c", 2, sim={"use_pallas": False}, steps=16, deadline_s=420.0, device_profile=False),
    "dp2_lstm": NcclWorld("c", 2, task="GR1T1_lstm", steps=16, deadline_s=420.0, device_profile=False),
    "mp2_xla": NcclWorld("c", 2, num_mp=2),
    "dp2_mp2_xla": NcclWorld("c", 4, num_mp=2),
    "dp4_step": NcclWorld("c", 4, alg={"fused_mega": False}),
    # (d) the global shuffle (permutation_groups the dp group does not
    # divide: every rank updates on the gathered global batch), and mp with
    # the symmetry loss, the LSTM and the engine; each world holds one
    # collection key and one update key of mesh.COMPILED_COLLECTIONS /
    # COMPILED_UPDATES
    "dp2_global_mega": NcclWorld("d", 2, alg={"permutation_groups": 1}),                         # K3
    "dp2_global_step": NcclWorld("d", 2, alg={"permutation_groups": 1, "fused_mega": False}),   # K2
    "dp2_global_lstm_engine": NcclWorld("d", 2, task="GR1T1_lstm", alg={"permutation_groups": 1},
                                        sim={"use_pallas": False}, steps=16, deadline_s=600.0,
                                        device_profile=False),
    "dp4_global_xla": NcclWorld("d", 4, alg={"permutation_groups": 2}),
    "mp2_symmetry_engine": NcclWorld("d", 2, num_mp=2, alg={"symmetry_coef": SYMMETRY_COEF},
                                     sim={"use_pallas": False}, steps=16, deadline_s=480.0, device_profile=False),
    "mp2_lstm": NcclWorld("d", 2, num_mp=2, task="GR1T1_lstm", steps=16, deadline_s=480.0, device_profile=False),
    "dp2_mp2_symmetry_engine": NcclWorld("d", 4, num_mp=2, alg={"symmetry_coef": SYMMETRY_COEF},
                                         sim={"use_pallas": False}, steps=16, deadline_s=480.0,
                                         device_profile=False),
    "dp2_mp2_lstm": NcclWorld("d", 4, num_mp=2, task="GR1T1_lstm", steps=16, deadline_s=480.0,
                              device_profile=False),
    # (e) the last runs JAX jits across ranks: the global shuffle with the
    # symmetry loss and under dp x mp (dp2_mp2_global_xla is JAX's own CLI
    # run, `train --num_mp 2` on four devices), the LSTM with the symmetry
    # loss, mp on the engine with the LSTM; and the recurrent mirror loss's
    # update graph in one process
    "dp2_global_symmetry": NcclWorld("e", 2, alg={"permutation_groups": 1, "symmetry_coef": SYMMETRY_COEF}),
    "dp2_lstm_symmetry": NcclWorld("e", 2, task="GR1T1_lstm", alg={"symmetry_coef": SYMMETRY_COEF}, steps=16,
                                   deadline_s=480.0, device_profile=False),
    "dp2_global_lstm_symmetry": NcclWorld("e", 2, task="GR1T1_lstm",
                                          alg={"permutation_groups": 1, "symmetry_coef": SYMMETRY_COEF},
                                          steps=16, deadline_s=480.0, device_profile=False),
    "mp2_lstm_symmetry_engine": NcclWorld("e", 2, num_mp=2, task="GR1T1_lstm", alg={"symmetry_coef": SYMMETRY_COEF},
                                          sim={"use_pallas": False}, steps=16, deadline_s=600.0,
                                          device_profile=False),
    "dp2_mp2_global_xla": NcclWorld("e", 4, num_mp=2, alg={"permutation_groups": 1}),
    "dp2_mp2_global_symmetry": NcclWorld("e", 4, num_mp=2,
                                         alg={"permutation_groups": 1, "symmetry_coef": SYMMETRY_COEF}),
    "dp2_mp2_global_lstm_engine": NcclWorld("e", 4, num_mp=2, task="GR1T1_lstm", alg={"permutation_groups": 1},
                                            sim={"use_pallas": False}, steps=16, deadline_s=600.0,
                                            device_profile=False),
    "dp2_mp2_lstm_symmetry": NcclWorld("e", 4, num_mp=2, task="GR1T1_lstm", alg={"symmetry_coef": SYMMETRY_COEF},
                                       steps=16, deadline_s=480.0, device_profile=False),
    "dp2_mp2_global_lstm_symmetry": NcclWorld("e", 4, num_mp=2, task="GR1T1_lstm",
                                              alg={"permutation_groups": 1, "symmetry_coef": SYMMETRY_COEF},
                                              steps=16, deadline_s=480.0, device_profile=False),
    "world1_lstm_symmetry": NcclWorld("e", 1, task="GR1T1_lstm", alg={"symmetry_coef": SYMMETRY_COEF}, steps=16,
                                      deadline_s=420.0, device_profile=False),
}
# (d): the gathered update against the one-process update of the true global
# batch (its own all-gather into a list, the same permutation): the largest L2
# share of the difference, in the params over the update's own step and in
# Adam's moments over their size (Adam's early steps move the params by about
# the LR whatever the minibatch; the moments follow the minibatches' gradients)
GLOBAL_TOL = 1e-6


class _Rotated:
    """A dp view whose all-gather returns the ranks' parts in rotated rank
    order (phase 22 (d)'s planted fault: every rank's slice one place late)."""

    def __init__(self, view):
        self.view, self.world = view, view.world

    def all_gather(self, x):
        import torch

        return torch.roll(self.view.all_gather(x), 1, 0)


def true_global(dp, tensors):
    """Each of this rank's (T, n, ...) or (L, n, H) ``tensors`` joined with
    every dp rank's along dim 1 in dp rank order, through
    ``torch.distributed.all_gather`` into a list, apart from the port's
    ``sharding.gather_envs``."""
    import torch
    import torch.distributed as dist

    out = []
    for x in tensors:
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(dp.world)]
        dist.all_gather(parts, y, group=dp.group)
        out.append(torch.cat(parts, dim=1).to(x.dtype))
    return out


def global_check(runner, dp, before, hidden0, last, perm, after):
    """Phase 22 (d): the gathered update's result ``after`` (a PPOState)
    against the one-process update (a PPO without ``dp``, the same config
    and path) of the true global batch (:func:`true_global` of ``last``,
    the iteration's collection outputs, and of the start memories
    ``hidden0``) from ``before`` with dp rank 0's permutation ``perm``.
    Returns the largest L2 share of the difference (the params' over the
    update's own step, m's and v's over their own norms), whether every
    leaf is equal bit for bit, and the path."""
    import torch

    from wiki_grx_gym_tpu_torch.learn.ppo import PPO
    from wiki_grx_gym_tpu_torch.learn.recurrent import Hidden
    from wiki_grx_gym_tpu_torch.parallel.mesh import DataParallel

    alg = runner.alg
    # under dp x mp the one-process update of the rank's shard: a dp view of
    # one rank that carries this rank's mp view (its collectives over the mp
    # group, which every mp peer runs alike)
    one = None if dp.mp is None else DataParallel(world=1, rank=0, device=dp.device, mp=dp.mp, backend=dp.backend)
    ref = PPO(runner.net, runner.alg_cfg, extra_loss_fn=alg.extra_loss_fn, perm_groups=alg.perm_groups,
              shuffle_block=alg.shuffle_block, dp=one)
    perm = dp.broadcast(perm.clone())
    b = last["batch"]
    k = len(b)
    mine = list(b) + [last["returns"], last["advantages"]] + ([] if hidden0 is None else list(hidden0))
    g = true_global(dp, mine)
    batch, ret, adv = type(b)(*g[:k]), g[k], g[k + 1]
    if runner.recurrent:
        want, _ = ref.update_recurrent(before, batch, ret, adv, Hidden(*g[k + 2:]), perm=perm)
    else:
        want, _ = ref.update(before, batch, ret, adv, perm=perm)
    norm = lambda x: float(torch.linalg.vector_norm(x))
    share = max(norm(after.params - want.params) / max(norm(want.params - before.params), 1e-30),
                norm(after.m - want.m) / max(norm(want.m), 1e-30), norm(after.v - want.v) / max(norm(want.v), 1e-30))
    equal = all(torch.equal(_bits(getattr(after, f)), _bits(getattr(want, f)))
                for f in ("params", "m", "v", "count", "learning_rate"))
    return {"share": share, "equal_bits": equal, "path": ref.path, "gathered_path": alg.path,
            "global_envs": int(ret.shape[1])}


def nccl_worker(rank, world, init_method, out_dir, name):
    """Phase 22, one rank of the NCCL group of world ``name`` of
    ``NCCL_WORLDS`` (``cuda:<rank>``): its task at 4096 envs a dp rank, with
    the all-terms fold (``cuda_step.all_terms_config``: its tracking_lin_vel
    term) and the command curriculum on (its all-reduce in every env step),
    through the entry points a user calls with ``dp``
    (``make_mesh(num_mp)``). The rule must compile it. ``NCCL_CALLS``
    ``_train_iter`` calls against as many eager ``iteration`` calls,
    injected draws then generator draws (each dp rank's own, the
    permutation dp rank 0's), bit for bit; every graph's nodes (NCCL's kernels apart) and
    the collectives it captured; ``NCCL_TIMED`` graphed iterations timed,
    their launch counts set to 0 just before and read just after; one
    graphed iteration under torch.profiler (host launch calls; with
    ``device_profile`` device time, NCCL's kernels and their time, the busy
    share without them); ``learn(1)``
    (its printed iteration line, the digest check). Then the planted fault:
    at one rank (``world1``) the metric sums' all-reduce captured ahead of
    the collection that writes them: the metrics must differ from the first
    eager call's; under dp alone, rank 1's update captured with
    ``PPO.reduce``'s result dropped (the all-reduce still issued); under mp,
    mp rank 1's ``_CopyToMP`` backward result dropped (the all-reduce still
    issued): ``learn(1)``'s digest check must raise. Each step is named
    with ``launch.stage``. Results go to ``out_dir/<name>_rank<r>.json``."""
    import contextlib
    import io
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wiki_grx_gym_tpu_torch.build import LAUNCHES, reset_launch_counts
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn import fused_update, graphs, networks
    from wiki_grx_gym_tpu_torch.learn.graphs import CompiledIteration
    from wiki_grx_gym_tpu_torch.parallel import mesh, sharding
    from wiki_grx_gym_tpu_torch.parallel.launch import stage
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    w = NCCL_WORLDS[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage("init_distributed")
    whole = mesh.init_distributed(backend="nccl", init_method=init_method, world_size=world, rank=rank,
                                  device="cuda", timeout_s=w.deadline_s)
    dp = mesh.make_mesh(w.num_mp, whole)
    dev = dp.device
    num_envs = N_ENVS * dp.world
    ms = lambda xs: [1e3 * x for x in xs]
    stats = lambda xs: {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}
    t_w = time.perf_counter()
    try:
        def make():
            cfg, train_cfg = task_registry.get_cfgs(w.task)
            cfg.env.num_envs = num_envs
            cuda_step.all_terms_config(cfg)
            cfg.commands.curriculum = True
            for k, v in w.sim.items():
                setattr(cfg.sim, k, v)
            if w.steps is not None:
                train_cfg.runner.num_steps_per_env = w.steps
            for k, v in w.alg.items():
                setattr(train_cfg.algorithm, k, v)
            env, _ = task_registry.make_env(w.task, env_cfg=cfg, dp=dp)
            return task_registry.make_alg_runner(env, w.task, train_cfg=train_cfg, log_root=None, dp=dp)[0]

        stage("building the runner")
        runner = make()
        path, steps_an_env = runner.rule_path, runner.num_steps_per_env
        res = {"name": name, "part": w.part, "rank": rank, "world": world, "dp": dp.world, "mp": w.num_mp,
               "device": str(dev), "card": torch.cuda.get_device_name(dev), "backend": dp.backend,
               "task": w.task, "physics": runner.env.backend, "envs": runner.env.num_envs,
               "envs_in_all": num_envs, "steps_an_env": steps_an_env, "path": path,
               "eager_reason": runner.eager_reason, "capture_mode": fused_update.CAPTURE_ERROR_MODE}
        if runner.eager_reason is not None:
            raise RuntimeError(f"phase 22 {name}: not compiled: {runner.eager_reason}")
        steps = runner.alg.num_learning_epochs * runner.alg.num_mini_batches
        gathered = runner.alg.gathered   # the global shuffle
        res["gathered"] = gathered
        p0 = runner.net.params_flat.clone()   # the fault's start
        # ---- compiled against eager: injected draws, then generator draws ----
        diffs, eager, ref0 = {}, [], None
        s_e, s_g = runner.init_state(), runner.init_state()
        for draws in ("injected", "generators"):
            if draws == "generators":
                s_e, s_g = runner.init_state(), runner.init_state()
            d_all = []
            for it in range(NCCL_CALLS):
                # each dp rank its own draws; mp peers step one env shard and draw alike
                kw = (dict(zip(("noise", "u", "perm"), injected_draws(runner, 4000 + 10 * it + dp.rank, dev)))
                      if draws == "injected" else {})
                want = {}
                stage(f"eager iteration {it}, {draws} draws")
                t0 = time.perf_counter()
                s_e, m_e = runner.iteration(s_e, out=want, **kw)
                torch.cuda.synchronize()
                eager.append((time.perf_counter() - t0, dict(runner.last_timing)))
                if ref0 is None:
                    ref0 = graphs.map_tensors(torch.clone, {"draws": kw, "metrics": m_e})
                stage(f"compiled iteration {it}, {draws} draws")
                check = gathered and draws == "injected" and it == 0
                if check:   # (d): the state and the start memories before the call
                    before = graphs.map_tensors(torch.clone, (s_g.ppo, s_g.hidden))
                s_g, m_g = runner._train_iter(s_g, **kw)
                if check:
                    stage("the global check")
                    res["global_check"] = global_check(runner, dp, *before, runner.compiled.last, kw["perm"],
                                                       s_g.ppo)
                d = tree_diffs({k: runner.compiled.last[k] for k in want}, want)
                d += tree_diffs(s_g, s_e, "state")
                d += [f"metric {k}" for k in m_e if not torch.equal(_bits(m_g[k]), _bits(m_e[k]))]
                d_all.append(d)
            diffs[draws] = d_all
        res["differing"] = diffs
        del s_e
        # ---- the graphs: nodes by kind, the collectives captured ----
        stage("counting the graphs' nodes")
        ci = runner.compiled
        res["graphs"] = ci.reports()
        nodes = {}
        for mode, g in ci.collect.items():
            nodes[f"collection ({mode})"] = graphs.node_kinds(g.graph)
        for mode, g in ci.tail.items():
            nodes[f"collection tail ({mode})"] = graphs.node_kinds(g.graph)
        nodes["update"] = graphs.node_kinds(ci.update.graph)
        if ci.epilogue is not None:
            nodes["update metrics"] = graphs.node_kinds(ci.epilogue.graph)
        res["nodes"] = nodes
        # ---- timed graphed iterations (generator draws) ----
        stage("timed graphed iterations")
        torch.cuda.synchronize()
        reset_launch_counts()
        graphed = []
        for _ in range(NCCL_TIMED):
            t0 = time.perf_counter()
            s_g, metrics = runner._train_iter(s_g)
            graphed.append((time.perf_counter() - t0, dict(runner.last_timing)))
        res["launches"] = dict(LAUNCHES)
        base = path.split("+")[0]
        res["launches_expected"] = {"k1": NCCL_TIMED * steps_an_env * (runner.env.backend == "kernel"),
                                    "k2": NCCL_TIMED * (steps if base in ("step", "mega") else 0),
                                    "k3": NCCL_TIMED * (base == "mega")}
        res["finite"] = all(math.isfinite(float(v)) for v in metrics.values())
        wall = stats(ms([t for t, _ in graphed]))
        res["eager_iteration_ms"] = stats(ms([t for t, _ in eager]))
        res["graphed_iteration_ms"] = wall
        res["graphed_collection_ms"] = stats(ms([t["collection_s"] for _, t in graphed]))
        res["graphed_update_ms"] = stats(ms([t["update_s"] for _, t in graphed]))
        res["env_steps_per_s"] = steps_an_env * num_envs / (wall["median"] / 1e3)
        stage("one graphed iteration under torch.profiler")
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if w.device_profile else [])
        with profile(activities=activities) as prof:
            s_g, _ = runner._train_iter(s_g)
            torch.cuda.synchronize()
        host = host_calls(prof)
        res["profile"] = {"host_calls": host, "host_launch_calls": sum(v for k, v in host.items() if "Launch" in k)}
        if w.device_profile:
            from torch.autograd import DeviceType

            dev_ms, kernels, _ = device_kernels(prof)
            nccl = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()]
            # an NCCL kernel's time includes its wait for the peers (and it
            # runs beside the compute stream): the busy share leaves it out
            nccl_ms = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                          for e in nccl) / 1e3
            res["profile"].update(device_ms=dev_ms, device_kernels=kernels, nccl_kernels=sum(e.count for e in nccl),
                                  nccl_ms=nccl_ms, busy_share=(dev_ms - nccl_ms) / wall["median"])
        del s_g, prof
        # ---- learn(1): the printed line, the digest check between replays ----
        stage("learn(1)")
        runner.compiled = None
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            runner.learn(1)
        res["learn_lines"] = [ln for ln in out.getvalue().splitlines() if ln.startswith(("iteration:", "it "))]
        res["digests"] = [[str(int(x)) for x in d] for d in runner.replica_digests]

        # ---- the planted fault ----
        stage("the planted fault")
        runner.compiled = None
        gc.collect()
        faults = []   # under dp x mp with the global shuffle two, planted in turn
        if world == 1:
            stale = {}
            orig_body, orig_sums = CompiledIteration._collection_body, runner.global_sums

            def early(self, mode):
                body = orig_body(self, mode)

                def run():
                    buf = stale.setdefault("sums", torch.zeros_like(self.sums))
                    buf.copy_(self.sums)
                    dp.all_reduce_sum(buf)   # captured ahead of the collection that writes the sums
                    return body()
                return run

            CompiledIteration._collection_body = early
            runner.global_sums = lambda sums: stale["sums"]
            try:
                s0 = runner.init_state()
                s0 = s0.replace(ppo=s0.ppo.replace(params=p0.clone()))
                _, m_p = runner._train_iter(s0, **ref0["draws"])
                d = [k for k in ref0["metrics"] if not torch.equal(_bits(m_p[k]), _bits(ref0["metrics"][k]))]
            finally:
                CompiledIteration._collection_body = orig_body
                runner.global_sums = orig_sums
            faults.append({"plant": "the metric sums' all-reduce captured ahead of the collection that writes "
                                    "them", "differing": d, "caught": bool(d)})
        if gathered:
            # every rank's slice one place late in the gathered batch: the
            # ranks stay equal to each other, so only the check against the
            # one-process update of the true global batch can see it
            orig_gather = sharding.gather_envs
            sharding.gather_envs = lambda view, xs: orig_gather(_Rotated(view), xs)
            try:
                s0 = runner.init_state()
                s0 = s0.replace(ppo=s0.ppo.replace(params=p0.clone()))
                before = graphs.map_tensors(torch.clone, (s0.ppo, s0.hidden))
                s_p, _ = runner._train_iter(s0, **ref0["draws"])
                got = global_check(runner, dp, *before, runner.compiled.last, ref0["draws"]["perm"], s_p.ppo)
            finally:
                sharding.gather_envs = orig_gather
            faults.append({"plant": "the gathered batch in rotated rank order (each rank's slice one place late)",
                           "global_check": got, "caught": got["share"] > GLOBAL_TOL and not got["equal_bits"]})
        if world > 1 and (not gathered or w.num_mp > 1):
            runner.compiled = None
            gc.collect()
            if w.num_mp == 1:
                plant = "rank 1's update graph with PPO.reduce's result dropped (the all-reduce still issued)"
                if dp.rank == 1:
                    alg, reduce = runner.alg, runner.alg.reduce
                    alg.reduce = lambda loss, g, aux: (reduce(loss, g, aux), (loss, g, aux))[1]
            else:
                plant = ("mp rank 1's graphs with _CopyToMP's backward result dropped (the all-reduce still "
                         "issued)")
                if dp.mp.rank == 1:
                    copy_back = networks._CopyToMP.backward
                    networks._CopyToMP.backward = staticmethod(lambda ctx, g: (copy_back(ctx, g), (g, None))[1])
            caught, why = False, ""
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    runner.learn(1)
            except RuntimeError as e:
                caught, why = "differ" in str(e), str(e)[:300]
            faults.append({"plant": plant, "caught": caught, "error": why})
        res["fault"] = {k: v for f in faults for k, v in f.items()}
        res["fault"].update(plant="; then ".join(f["plant"] for f in faults), caught=all(f["caught"] for f in faults))
        res["seconds"] = time.perf_counter() - t_w
        with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as fh:
            json.dump(res, fh, default=str)
        stage("teardown")
    finally:
        mesh.destroy(whole)


def nccl_phase(dev, only=None):
    """Phase 22: the compiled iteration over NCCL (``nccl_worker`` for each
    world of ``NCCL_WORLDS`` that this machine's cards hold; NCCL takes one
    rank a card; ``only``: the names of the worlds to run, None for all):
    (a) one rank of a world-1 NCCL group on every machine; (b) dp2 on the
    step path and (c) the other cases across ranks where there are two or
    four cards. Each world's ranks are joined within its deadline or
    killed; a world that fails is reported and the next one runs. Returns
    the phase's results: the worlds run, ``nccl_cards``, what was skipped
    and why, and each rank's launch counts (the kernels line's
    ``dp_graphed_launches``)."""
    import torch

    from wiki_grx_gym_tpu_torch.parallel.launch import spawn

    t22 = time.perf_counter()
    cards = torch.cuda.device_count()
    out = {"nccl_cards": cards, "worlds_run": [], "skipped": {}, "failed": {}, "worlds": {}}
    out_dir = os.path.join(THIS, "build", "smoke_nccl")
    os.makedirs(out_dir, exist_ok=True)
    for name, w in NCCL_WORLDS.items():
        tag = f"22 {w.part} {name}"
        if only is not None and name not in only:
            continue
        if w.cards > cards:
            out["skipped"][name] = f"needs {w.cards} cards, the machine has {cards} (NCCL takes one rank a card)"
            log(f"[{tag}] skipped: {out['skipped'][name]}")
            continue
        for r in range(w.cards):
            if os.path.exists(os.path.join(out_dir, f"{name}_rank{r}.json")):
                os.remove(os.path.join(out_dir, f"{name}_rank{r}.json"))
        rendezvous = os.path.join(out_dir, name)   # the world's own (two worlds may run at once)
        os.makedirs(rendezvous, exist_ok=True)
        t0 = time.perf_counter()
        try:
            spawn(nccl_worker, w.cards, args=(out_dir, name), rendezvous_dir=rendezvous, timeout_s=w.deadline_s)
        except Exception as e:   # reported as the world's failure; the next world runs
            out["failed"][name] = f"{type(e).__name__}: {str(e)[-1500:]}"
            fail(f"phase 22 {name}: the world failed after {time.perf_counter() - t0:.1f} s: "
                 f"{out['failed'][name]}")
            continue
        ranks = []
        for r in range(w.cards):
            with open(os.path.join(out_dir, f"{name}_rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        for r in ranks:
            log(f"[{tag}] rank {r['rank']} on {r['device']} ({r['card']}) over {r['backend']}, dp "
                f"{r['dp']} x mp {r['mp']}, {r['task']} on {r['physics']}, {r['envs']} envs of {r['envs_in_all']}, "
                f"{r['steps_an_env']} steps an env, the {r['path']} update, capture mode {r['capture_mode']}: "
                "compiled against eager "
                + "; ".join(f"{draws} {['equal bit for bit' if not d else d[:8] for d in ds]}"
                            for draws, ds in r["differing"].items()))
            log(f"[{tag}] rank {r['rank']}: eager iteration ms {r['eager_iteration_ms']}; graphed "
                f"{r['graphed_iteration_ms']} (collection {r['graphed_collection_ms']['median']:.2f}, update "
                f"{r['graphed_update_ms']['median']:.2f}, from the events); {r['env_steps_per_s']:.0f} env-steps/s "
                f"in all at the median; {NCCL_TIMED} graphed iterations launched {r['launches']} (expected "
                f"{r['launches_expected']}); metrics finite {r['finite']}")
            log(f"[{tag}] rank {r['rank']}: graph nodes {json.dumps(r['nodes'])}; collectives captured "
                + json.dumps({g['name']: g.get('collectives') for g in r['graphs']}))
            fault = r["fault"]
            seen = {k: fault[k] for k in ("differing", "error", "global_check") if k in fault}
            log(f"[{tag}] rank {r['rank']}: one graphed iteration's profile {json.dumps(r['profile'])}; "
                f"learn(1) {r['learn_lines']}; digests {r['digests']}; planted: {fault['plant']}: caught "
                f"{fault['caught']} {seen}; {r['seconds']:.1f} s")
            if any(d for ds in r["differing"].values() for d in ds):
                fail(f"phase 22 {name} rank {r['rank']}: the compiled iteration differs from eager: {r['differing']}")
            if r["launches"] != r["launches_expected"] or not r["finite"]:
                fail(f"phase 22 {name} rank {r['rank']}: launched {r['launches']}, expected "
                     f"{r['launches_expected']}, or non-finite metrics")
            if r["rank"] == 0 and not (r["learn_lines"] and "iteration: compiled" in r["learn_lines"][0]):
                fail(f"phase 22 {name}: learn(1) did not print a compiled iteration: {r['learn_lines']}")
            if len(r["digests"]) != 1 or len(set(r["digests"][0])) != 1:
                fail(f"phase 22 {name} rank {r['rank']}: the ranks' digests {r['digests']}")
            if not r["fault"]["caught"]:
                fail(f"phase 22 {name} rank {r['rank']}: the planted fault passed: {r['fault']}")
            captured = sum(n for g in r["graphs"] for n in (g.get("collectives") or {}).values())
            nccl = {k: v.get("nccl_kernels", 0) for k, v in r["nodes"].items()}
            # the update's NCCL kernels: under the global shuffle with no mp
            # group the recurrent grad step holds none (no gradient
            # all-reduce), its metrics graph the metric sums'
            update_nccl = nccl["update"] + nccl.get("update metrics", 0)
            if not captured or (w.cards > 1 and not (nccl["collection (inject)"] and update_nccl)):
                fail(f"phase 22 {name} rank {r['rank']}: {captured} collectives captured, NCCL kernel nodes "
                     f"{nccl} (across ranks the collection and the update must hold some)")
            if r["gathered"]:
                # the global shuffle's one all-gather, in the graph that stages the update
                gathers = {g["name"]: (g.get("collectives") or {}).get("all_gather", 0) for g in r["graphs"]
                           if g["name"].startswith(("collection (", "collection tail ("))}
                chk = r.get("global_check", {})
                log(f"[{tag}] rank {r['rank']}: the all-gathers captured {gathers}; the gathered update against "
                    f"the one-process update of the true global batch ({chk.get('global_envs')} envs, the "
                    f"{chk.get('path')} path): L2 share {chk.get('share')} (limit {GLOBAL_TOL}), bit for bit "
                    f"{chk.get('equal_bits')}")
                if sorted(set(gathers.values())) != [1] or not chk or chk["share"] > GLOBAL_TOL \
                        or chk["path"] != chk["gathered_path"]:
                    fail(f"phase 22 {name} rank {r['rank']}: the global shuffle: all-gathers {gathers}, the check "
                         f"against the one-process update {chk}")
        out["worlds_run"].append(name)
        out["worlds"][name] = {"ranks": ranks, "seconds": time.perf_counter() - t0}
        log(f"[{tag}] the world took {out['worlds'][name]['seconds']:.1f} s")
    out["seconds"] = time.perf_counter() - t22
    log(json.dumps({"nccl": {"worlds_run": out["worlds_run"], "nccl_cards": cards, "skipped": out["skipped"],
                             "failed": out["failed"]}}))
    log(f"[time] phase 22 took {out['seconds']:.1f} s")
    return out


def build_libraries(k1_sets):
    """Build K1 for each K1_SETS name in ``k1_sets``, K2 and K3 (a library
    already built is kept): one nvcc per library, all started together.
    Returns ({set name: its K1 op}, {library name: (source, flags)},
    seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from wiki_grx_gym_tpu_torch import build as kbuild
    from wiki_grx_gym_tpu_torch.learn import fused_update
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    t0 = time.perf_counter()
    k1_ops = {name: cuda_step.task_env(K1_SETS[name][0], 1, "cpu", k1_set_mutate(name)).decimation_op
              for name in k1_sets}
    jobs = {cuda_step.library_name(op.sizes): (cuda_step._SOURCE, cuda_step.nvcc_flags(op.sizes))
            for op in k1_ops.values()}
    jobs.update({
        "k2_ppo_grads": (fused_update.K2_SOURCE, fused_update.FLAGS),
        "k3_ppo_update": (fused_update.K3_SOURCE, fused_update.FLAGS),
    })
    with ThreadPoolExecutor(len(jobs)) as ex:
        for f in [ex.submit(kbuild.build, name, src, flags) for name, (src, flags) in jobs.items()]:
            f.result()
    return k1_ops, jobs, time.perf_counter() - t0


# the K1 programs phase 22's worlds load (GR1T1's for bench_scaling beside them)
PHASE22_K1_SETS = ("GR1T1", "GR1T1_all_terms")


def phase22_main(names):
    """``python3 chip_smoke.py --phase22 [WORLD ...]``: phase 22 alone, on
    the worlds of ``NCCL_WORLDS`` named (default every one the cards hold),
    after building the libraries they load. Prints the card line and what
    failed; exits 0 only if every world run passed. The full run (no
    arguments) is the one that prints the kernels' and the final line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card", file=sys.stderr)
        return 2
    unknown = [n for n in names if n not in NCCL_WORLDS]
    if unknown:
        print(f"chip_smoke: no phase 22 world {unknown}; the worlds: {sorted(NCCL_WORLDS)}", file=sys.stderr)
        return 2
    log("card:", card_line())
    sys.path.insert(0, THIS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, jobs, build_s = build_libraries(PHASE22_K1_SETS)
    log(f"[build] {len(jobs)} libraries in {build_s:.1f} s: {sorted(jobs)}")
    nccl_phase(torch.device("cuda"), only=names or None)
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed: " + "; ".join(FAILURES))
        return 1
    log(f"chip_smoke --phase22: every world run passed in {time.perf_counter() - T0:.1f} s")
    return 0


def main():
    import torch

    if sys.argv[1:2] == ["--phase22"]:
        return phase22_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    card = card_line()
    log("card:", card)
    sys.path.insert(0, THIS)
    from wiki_grx_gym_tpu_torch.envs import task_registry
    from wiki_grx_gym_tpu_torch.learn.runner import OnPolicyRunner
    from wiki_grx_gym_tpu_torch.sim import cuda_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 2: build K1, K2, K3: one nvcc per source, all started together ----
    from wiki_grx_gym_tpu_torch import build as kbuild
    from wiki_grx_gym_tpu_torch.learn import fused_update

    k1_ops, jobs, build_s = build_libraries(K1_SETS)
    for name in jobs:
        info = kbuild.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {info.get('seconds', 0.0):.1f} s")
        for line in info.get("ptxas", []):
            log(f"[build] {name} ptxas:", line)
    log(f"[build] all {len(jobs)} libraries built in {build_s:.1f} s (one nvcc each, started together)")
    # K2's products must run on the tensor cores: count wgmma's SASS (HGMMA)
    cuobjdump = os.path.join(os.path.dirname(kbuild.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kbuild.BUILD_INFO["k2_ppo_grads"]["path"]],
                          capture_output=True, text=True, timeout=120)
    HGMMA_COUNT[0] = sum("HGMMA" in line for line in sass.stdout.splitlines())
    log(f"[build] k2_ppo_grads SASS: {HGMMA_COUNT[0]} HGMMA instructions (cuobjdump rc {sass.returncode})")
    if not HGMMA_COUNT[0]:
        raise SystemExit("K2's SASS holds no HGMMA instruction: its products do not run on the tensor cores")
    for set_name, op in k1_ops.items():
        for name, r in cuda_step.ptxas_report(op.sizes).items():
            log(f"[build] K1 {set_name} {name}: {r.get('registers')} registers, {r.get('spill_stores')} B spill "
                f"stores, {r.get('spill_loads')} B spill loads")
        occ = cuda_step.team_occupancy(op)
        log(f"[build] K1 {set_name} team kernel: {occ['threads_per_env']} lanes an env, {occ['envs_per_block']} "
            f"envs a block, {occ['smem_bytes_per_block']} B of shared memory a block, "
            f"{occ['blocks_per_sm']} blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    k3_kernels = {name: r for name, r in kbuild.ptxas_summary(kbuild.BUILD_INFO["k3_ppo_update"].get("ptxas", [])).items()
                  if "k3_" in name}
    for name, r in k3_kernels.items():
        log(f"[build] K3 {name}: {r.get('registers')} registers, {r.get('spill_stores')} B spill stores, "
            f"{r.get('spill_loads')} B spill loads")
    if not k3_kernels:
        log("[build] K3: no ptxas report (the library was built before this run)")
    k3_resident = fused_update.k3_coresident(dev)   # raises below K3_BLOCKS
    log(f"[build] K3 k3_fused_step: grid barrier by {K3_BARRIER}; {fused_update.K3_BLOCKS} blocks of 256 "
        f"threads, {k3_resident} co-resident on this card")

    phase_done("phase 2")
    # ---- phase 3: K1 against its plain version, 4096 envs, each size set ----
    k1_rows = {}
    pool, plain_ops = plain_op_counts(K1_SETS)
    with pool:
        for name, (task, _, label, spread) in K1_SETS.items():
            k1_rows[name] = k1_phase(dev, task, k1_set_mutate(name), label, spread, require_faster=name == "GR1T1",
                                     exact=name in K1_EXACT, plain_ops=plain_ops[name])
    del k1_ops

    phase_done("phase 3")
    # ---- phase 4: the slice's main path ----
    cfg, train_cfg = task_registry.get_cfgs("GR1T1")
    cfg.env.num_envs = N_ENVS
    env, _ = task_registry.make_env("GR1T1", env_cfg=cfg, device=dev)
    runner = OnPolicyRunner(env, train_cfg, device=dev)
    assert runner.num_steps_per_env == ROLLOUT_STEPS
    rs = runner.init_state()
    rs, _, _ = runner.rollout(rs)   # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_step.reset_launch_counts()
    t0 = time.perf_counter()
    rs, batch, acc = runner.rollout(rs)
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    rollout_launches = cuda_step.LAUNCHES["k1"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, v in list(batch._asdict().items()) + list(acc.items()):
        if name != "dones" and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"rollout output {name} is not finite")
    assert batch.obs.shape == (ROLLOUT_STEPS, N_ENVS, 39), batch.obs.shape
    assert batch.critic_obs.shape == (ROLLOUT_STEPS, N_ENVS, 168), batch.critic_obs.shape
    assert batch.actions.shape == (ROLLOUT_STEPS, N_ENVS, 10)
    if rollout_launches != ROLLOUT_STEPS:
        raise SystemExit(f"K1 launched {rollout_launches} times in a {ROLLOUT_STEPS}-step rollout")
    steps_per_s = ROLLOUT_STEPS * N_ENVS / rollout_s
    log(f"[rollout] {ROLLOUT_STEPS} steps x {N_ENVS} envs in {rollout_s:.3f} s = "
        f"{steps_per_s:.0f} env-steps/s; K1 launches {rollout_launches}; "
        f"mean reward {float(acc['rew'].mean()) / ROLLOUT_STEPS:.4f}; dones {int(acc['done'].sum())}; "
        f"peak memory {peak_gib:.3f} GiB")

    import numpy as np

    from wiki_grx_gym_tpu_torch.scripts.play import play
    from wiki_grx_gym_tpu_torch.utils.helpers import get_args

    rng = np.random.RandomState(0)
    dims = [39, 512, 256, 128, 10]
    blob = {}
    for i in range(4):
        bound = 1.0 / math.sqrt(dims[i])
        blob[f"actor_w{i}"] = rng.uniform(-bound, bound, (dims[i], dims[i + 1])).astype(np.float32)
        blob[f"actor_b{i}"] = rng.uniform(-bound, bound, dims[i + 1]).astype(np.float32)
    blob["std"] = np.full(10, 0.2, np.float32)
    blob["activation"] = np.asarray("elu")
    os.makedirs(os.path.join(THIS, "build"), exist_ok=True)
    npz = os.path.join(THIS, "build", "smoke_policy.npz")
    np.savez(npz, **blob)
    before = cuda_step.LAUNCHES["k1"]
    play_log = play(get_args(["--task", "GR1T1", "--policy", npz, "--device", "cuda"]),
                    num_steps=PLAY_STEPS)
    play_launches = cuda_step.LAUNCHES["k1"] - before
    if play_launches != PLAY_STEPS + 1:
        raise SystemExit(f"play launched K1 {play_launches} times for {PLAY_STEPS} steps + init")
    if not logger_finite(play_log):
        raise SystemExit("play produced non-finite values")
    main_path_launches = cuda_step.LAUNCHES["k1"]
    log(f"[play] {PLAY_STEPS} steps, K1 launches {play_launches} (incl. the init step)")

    # where the rollout's time goes: one more rollout under torch.profiler
    # (after the launch counts were read; the profiler slows the host side)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rs, _, _ = runner.rollout(rs)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device kernel rows only (operator rows repeat their kernels' time)
    kern = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    dev_total_ms = sum(dev_us(e) for e in kern) / 1e3
    k1_dev_ms = sum(dev_us(e) for e in kern if any(n in e.key for n in KERNEL_NAMES["K1"])) / 1e3
    if dev_total_ms > 0:
        log(f"[profile] rollout under the profiler {prof_s * 1e3:.1f} ms wall; device kernels "
            f"{dev_total_ms:.1f} ms in {sum(e.count for e in kern)} launches "
            f"({dev_total_ms / ROLLOUT_STEPS:.3f} ms per step); K1 {k1_dev_ms:.1f} ms; device busy "
            f"{100 * dev_total_ms / (rollout_s * 1e3):.1f}% of the unprofiled rollout's "
            f"{rollout_s * 1e3:.1f} ms")
        for e in kern[:8]:
            log(f"[profile]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  {e.key[:90]}")
    else:
        log("[profile] the profiler saw no device time; device busy share not measured")
    if dev_total_ms > 0 and k1_dev_ms == 0:
        raise SystemExit(f"the rollout profile attributes no device time to {KERNEL_NAMES['K1']} "
                         f"though K1 launched {rollout_launches} times in a rollout")

    # phase 15's inputs: one step of the rollout's observations, and env 0's first steps
    eval_obs = batch.obs[ROLLOUT_STEPS // 2].cpu().numpy()
    stream_obs = batch.obs[:LSTM_STREAM, 0].cpu().numpy()

    phase_done("phase 4")
    # ---- phases 5-8: the learner ----
    ppo_rows = ppo_phases(runner, rs, batch, dev)
    # the checks' runner and its update graphs go before phase 7 measures its peak memory
    del batch, acc, rs, runner, env
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(dev)

    phase_done("phases 5-8")
    # ---- phase 9: the 32-DOF full body: K2 at its widths, learn(2); the no-pairs rollout ----
    k2_full_row = full_body_ppo_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    train_full = train_phase(dev, "GR1T1_full")
    no_pairs_launches = drive_rollout(dev, "GR1T1", no_self_collision)

    phase_done("phase 9")
    # ---- phase 10: terrain training (heightfield, trimesh); the heading rollout ----
    gc.collect()
    torch.cuda.empty_cache()
    # trimesh without phase 7's profiled eager iteration (the profiler's ~80k
    # launches cost ~45 s; heightfield's profile stands for the terrain path)
    train_terrain = {m.__name__: train_phase(dev, "GR1T1", m, profiled=m is heightfield)
                     for m in (heightfield, trimesh)}
    heading_launches = drive_rollout(dev, "GR1T1", heading)
    phase_done("phase 10")
    # ---- phase 11: the all-terms fold's path (learn(1)); rollouts with V, T, V with heading, trimesh viscous ----
    gc.collect()
    torch.cuda.empty_cache()
    train_all_terms = train_phase(dev, "GR1T1", cuda_step.all_terms_config, iters=1, profiled=False)
    control_launches = {name: drive_rollout(dev, "GR1T1", k1_set_mutate(name))
                        for name in ("GR1T1_V", "GR1T1_T", "GR1T1_V_heading", "GR1T1_trimesh_viscous")}
    phase_done("phase 11")
    # ---- phase 12: the recurrent task GR1T1_lstm ----
    gc.collect()
    torch.cuda.empty_cache()
    train_lstm = lstm_phase(dev)
    phase_done("phase 12")
    # ---- phase 13: the mirror-symmetry loss (GR1T1 learn(1); one GR1T1_lstm grad step) ----
    gc.collect()
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    symmetry = symmetry_phase(dev)
    log(f"[time] phase 13 took {time.perf_counter() - t13:.1f} s")
    phase_done("phase 13")
    # ---- phase 14: data parallel (two gloo ranks on the card; torchrun with NCCL at world size 1) ----
    gc.collect()
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    dp_row = dp_phase(dev)
    log(f"[time] phase 14 took {time.perf_counter() - t14:.1f} s")
    phase_done("phase 14")
    # ---- phase 15: eval and deploy (play --record, the native runtime, replay, eval_tracking, profile_dir) ----
    gc.collect()
    torch.cuda.empty_cache()
    eval_deploy = eval_deploy_phase(dev, eval_obs, stream_obs)
    phase_done("phase 15")
    # ---- phase 16: the engine path (K1 against the engine; learn(1) through the engine) ----
    gc.collect()
    torch.cuda.empty_cache()
    engine = engine_phase(dev)
    phase_done("phase 16")
    # ---- phase 17: bf16 policy and update dtypes, remat_update, fused_trunk; tensor parallelism ----
    gc.collect()
    torch.cuda.empty_cache()
    dtypes, runner17, state17 = dtype_phase(dev)
    tp = tp_phase(dev, runner17, state17)
    del runner17, state17
    phase_done("phase 17")
    # ---- phase 18: the port's bench at 4096 and 8192 envs; K2 and K3 at 8192 ----
    gc.collect()
    torch.cuda.empty_cache()
    bench18, k1_big_row, k2_big_row = bench_phase(dev, k1_rows["GR1T1"]["ops_per_env_step"])
    phase_done("phase 18")
    # ---- phase 19: the compiled iteration (the collection and update graphs; step_graph) ----
    gc.collect()
    torch.cuda.empty_cache()
    compiled = compiled_phase(dev)
    phase_done("phase 19")
    # ---- phase 20: the compiled update on the recurrent, step and xla paths (symmetry loss) ----
    gc.collect()
    torch.cuda.empty_cache()
    compiled_update = compiled_update_phase(dev)
    phase_done("phase 20")
    # ---- phase 21: the compiled iteration on the engine (one step's graph replayed 64 times) ----
    gc.collect()
    torch.cuda.empty_cache()
    engine_compiled = engine_compiled_phase(dev)
    phase_done("phase 21")
    # ---- phase 22: the compiled iteration over NCCL (world 1; dp2 where cards allow) ----
    gc.collect()
    torch.cuda.empty_cache()
    # parts (a)-(d); part (e) runs only under --phase22
    nccl = nccl_phase(dev, only=[name for name, w in NCCL_WORLDS.items() if w.part != "e"])
    phase_done("phase 22")

    k2_row, k3_row = ppo_rows
    k2_row["launches"] = train["launches"]["k2"]
    k2_row["dp"] = dict(dp_row, launches_from=f"learn({TRAIN_ITERS}) on each of {DP_WORLD} gloo ranks (2048 envs "
                        "each), the step path: K2 per shard, the gradient all-reduce, clip and Adam")
    k3_row["launches"] = train["launches"]["k3"]
    # phase 16b's learn(1) through the engine, counted from 0, under their own keys
    k2_row["engine_learn_launches"] = engine["b"]["launches"]["k2"]
    k3_row["engine_learn_launches"] = engine["b"]["launches"]["k3"]
    # phase 17a's learn(1) with bf16 compute and update, and 17c's per-rank
    # learn(1) under tensor parallelism (the xla path: K2 and K3 never)
    for row, k in ((k2_row, "k2"), (k3_row, "k3")):
        row["dtype_learn_launches"] = dtypes["a"]["launches"][k]
        row["tp_learn_launches"] = [r["launches"][k] for r in tp["mp2"]]
    k2_row["kernel_launches_per_grad_step"] = train["profile"]["k2_kernel_launches_per_grad_step"]
    k3_row["kernel_launches_per_update"] = train["profile"]["kernel_launches_per_update"]
    k3_row["kernel_launches_from"] = train["profile"]["kernel_launches_from"]
    k3_row["host_launches_per_update"] = train["profile"]["host_launches_per_update"]
    k3_row["kernels_ptxas"] = k3_kernels
    k3_row["coresident_blocks"] = k3_resident
    # phase 19's graphed iterations, counted from 0 (a replay adds its graph's tally)
    graphed_from = (f"{COMPILED_TIMED + 1} calls of OnPolicyRunner._train_iter at {N_ENVS} envs (the first "
                    "warms up and captures, the others replay the collection and update graphs)")
    for row, k in ((k2_row, "k2"), (k3_row, "k3")):
        row["graphed_iteration_launches"] = compiled.get("t", {}).get("launches", {}).get(k)
        row["graphed_iteration_launches_from"] = graphed_from
    # phase 20's graphed step path: K2 a grad step inside the update's graph
    k2_row["step_path_graphed_launches"] = compiled_update.get("step_path", {}).get("b", {}).get("launches", {}).get("k2")
    k2_row["step_path_graphed_launches_from"] = (f"{UPDATE_TIMED} graphed iterations of the step path "
                                                 f"(fused_mega False) at {N_ENVS} envs, replays of its update graph")
    # phase 21's graphed engine iterations, counted from 0 (K1 0: the engine replaces it)
    engine_graphed = engine_compiled.get("b", {}).get("launches", {})
    engine_graphed_from = (f"{ENGINE_TIMED} graphed iterations of GR1T1 on the engine (use_pallas False) at "
                           f"{N_ENVS} envs: 64 A1 replays, A2 and K3's update graph each")
    for row, k in ((k2_row, "k2"), (k3_row, "k3")):
        row["engine_graphed_launches"] = engine_graphed.get(k)
        row["engine_graphed_launches_from"] = engine_graphed_from
    # phase 22's graphed iterations over NCCL, per world and rank, counted from 0
    dp_graphed_from = (f"{NCCL_TIMED} graphed iterations of GR1T1 (the all-terms fold, the command curriculum "
                       f"on) on each rank of "
                       f"each NCCL world run: {', '.join(nccl['worlds_run'])}")
    dp_graphed = {k: {name: [r["launches"][k] for r in w["ranks"]] for name, w in nccl["worlds"].items()}
                  for k in ("k1", "k2", "k3")}
    for row, k in ((k2_row, "k2"), (k3_row, "k3")):
        row["dp_graphed_launches"] = dp_graphed[k]
        row["dp_graphed_launches_from"] = dp_graphed_from

    # launches: phase 4's rollout and play, as in every earlier slice; phase
    # 15's runs, each counted from 0, under their own keys
    k1_row = dict(k1_rows["GR1T1"], launches=main_path_launches,
                  eval_deploy_launches=eval_deploy["k1_launches"],
                  eval_play_launches=eval_deploy["play"]["launches"]["k1"],
                  eval_tracking_launches=eval_deploy["eval_tracking"]["launches"]["k1"],
                  eval_learn_launches=eval_deploy["profile"]["launches"]["k1"],
                  engine_learn_launches=engine["b"]["launches"]["k1"],
                  dtype_learn_launches=dtypes["a"]["launches"]["k1"],
                  tp_learn_launches=[r["launches"]["k1"] for r in tp["mp2"]], build_all_s=build_s,
                  rollout_env_steps_per_s=steps_per_s, rollout_launches=rollout_launches,
                  peak_mem_gib=peak_gib, train_launches=train["launches"]["k1"],
                  graphed_iteration_launches=compiled.get("t", {}).get("launches", {}).get("k1"),
                  graphed_iteration_launches_from=graphed_from,
                  engine_graphed_launches=engine_graphed.get("k1"),
                  engine_graphed_launches_from=engine_graphed_from,
                  dp_graphed_launches=dp_graphed["k1"], dp_graphed_launches_from=dp_graphed_from)
    k1_full_row = dict(k1_rows["GR1T1_full"], launches=train_full["launches"]["k1"])
    k1_no_pairs_row = dict(k1_rows["GR1T1_no_pairs"], launches=no_pairs_launches,
                           launches_from="one 64-step rollout of the no-pairs config")
    k1_terrain_rows = [dict(k1_rows[f"GR1T1_{m}"], launches=train_terrain[m]["launches"]["k1"],
                            launches_from=f"learn({TRAIN_ITERS}) on {m}") for m in ("heightfield", "trimesh")]
    k1_heading_row = dict(k1_rows["GR1T1_heading"], launches=heading_launches,
                          launches_from="one 64-step rollout with heading commands")
    k1_all_terms_row = dict(k1_rows["GR1T1_all_terms"], launches=train_all_terms["launches"]["k1"],
                            launches_from="learn(1) of the all-terms config")
    k1_control_rows = [dict(k1_rows[name], launches=control_launches[name],
                            launches_from=f"one 64-step rollout ({name})") for name in control_launches]
    subset_cell = bench18["cells"]["ref_equiv_subset"]
    k1_viscous_row = dict(k1_rows["GR1T1_viscous"], launches=subset_cell["launches"]["k1"],
                          launches_from=f"phase 18's ref_equiv_subset cell: init_state, "
                                        f"{subset_cell['calls']['iterations']} iterations and "
                                        f"{subset_cell['calls']['rollouts']} rollouts")
    k2_full_row["launches"] = train_full["launches"]["k2"]
    k2_full_row["kernel_launches_per_grad_step"] = train_full["profile"]["k2_kernel_launches_per_grad_step"]
    kernels = [k1_row, k1_full_row, k1_no_pairs_row, *k1_terrain_rows, k1_heading_row, k1_all_terms_row,
               *k1_control_rows, k1_viscous_row, k1_big_row, k2_row, k2_full_row, k2_big_row, k3_row]
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "launches"}}))
    log(json.dumps({"train_GR1T1_full": {k: v for k, v in train_full.items() if k != "launches"}}))
    for m, tr in train_terrain.items():
        log(json.dumps({f"train_GR1T1_{m}": {k: v for k, v in tr.items() if k != "launches"}}))
    log(json.dumps({"train_GR1T1_all_terms": {k: v for k, v in train_all_terms.items() if k != "launches"}}))
    log(json.dumps({"train_GR1T1_lstm": train_lstm}))
    log(json.dumps({"symmetry": symmetry}))
    log(json.dumps({"data_parallel": dp_row}))
    log(json.dumps({"eval_deploy": eval_deploy}))
    log(json.dumps({"engine": engine}))
    log(json.dumps({"dtype_options": dtypes}))
    log(json.dumps({"tensor_parallel": tp}))
    log(json.dumps({"bench": bench18}))
    log(json.dumps({"compiled_iteration": compiled}, default=str))
    log(json.dumps({"compiled_update": compiled_update}, default=str))
    log(json.dumps({"engine_compiled": engine_compiled}, default=str))
    log(json.dumps({"nccl_compiled": {k: v for k, v in nccl.items() if k != "worlds"}}, default=str))
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed: " + "; ".join(FAILURES))
        return 1
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
