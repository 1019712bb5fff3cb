#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one card,
nvcc (``/usr/local/cuda``), the flagship weights in
``artifacts/flagship/ema_params.pkl``, the distilled student's in
``artifacts/onpolicy_cartpole/`` (``student_1eval.pkl``, ``report.json``) and
the LMPC parity workload's in ``artifacts/flagship_lmpc/`` (``ema_params.pkl``,
``report.json``), the distillation's teacher in
``artifacts/flagship_modality/ema_params.pkl``, the quadrotor student in
``artifacts/onpolicy_quadrotor/student_1eval.pkl``, the scene-conditioned student in
``artifacts/scene_conditioned/scene_student_ema.pkl``, the quadrotor flagship's teacher in
``artifacts/flagship_quadrotor/`` (``ema_params.pkl``, ``dataset.npz``), the panda student in
``artifacts/onpolicy_panda/student_1eval.pkl``, its CFG teacher in
``artifacts/flagship_panda_rbd/ema_params.pkl`` (with its ``dataset.npz``), the distilled
panda student in ``artifacts/distilled_panda/student_3eval.pkl``, and writes nothing but
the kernel builds under ``build/torch_kernels/`` and, for a moment, phase 26's checkpoint under
``build/chip_smoke_train/`` and phases 41-42's student and data under
``build/chip_smoke_making/``. Phases,
each printing one line with its own seconds:

1. device: the card's name, the device count, and nvidia-smi's name and
   power limit. Without a card the script exits non-zero and prints no result.
2. build: nvcc on every ``ops/csrc/*.cu`` for sm_90a, one process per
   source, all started together, with each one's wall time and its
   ``-Xptxas -v`` register, shared-memory and spill report; the five
   cluster kernels' registers and spills again on one line (the CFG chain,
   the U-Net pass, the CFG episode, the DDIM chain and the DDIM episode:
   clusters of 8 CTAs on ``unet_body_cluster.cuh``), each with the cluster
   occupancy query (``cudaOccupancyMaxActiveClusters``) at its shared memory
   at full width: the chains' and the pass's plan, the episodes' for K = 1
   and K = 4; the same for the bf16 entries of the CFG chain and the CFG
   episode (``cfg_chain_bf16``, ``cfg_episode_bf16``: the __nv_bfloat16
   instantiations of ``cfg_chain.cu`` and ``cfg_episode.cu``) and for the
   CFG episode's linear cart-pole entry (``cfg_episode_lmpc``) at K = 1 and
   K = 8 on the LMPC model, its quadrotor entry (``cfg_episode_quadrotor``)
   at K = 1 and 16 on the scene student, and the DDIM episode's quadrotor
   entry at K = 1 and 16; and the conv
   kernel's registers and spills (one CTA per
   GroupNorm group and batch chunk on ``mma.sync`` tf32 tiles in 3xTF32,
   one instantiation per accumulator tiles a warp holds: 1, 2, 4, 8).
3. kernel vs plain: the CFG chain kernel (one cluster per sample) on three
   contexts, and the U-Net pass kernel (one cluster per batch row) on three
   (x, t, context, mask) draws at batch 2, each against its plain PyTorch
   version on the flagship weights at full width.
4. per-replan path (``BENCH_FUSED=chain``): the flagship cart-pole CFG
   closed loop, 80 replans from x0 = [0, 0, 3.0, 0, theta*(3.0)], with the
   chain kernel as the sampler; the counts are set to 0 just before and read
   just after. The first 10 replans through the plain chain on the same
   noise must give the same tracks.
5. episode, K = 1: the whole 80-replan loop as one launch of the episode
   kernel (one cluster of 8 CTAs that splits the U-Net body by GroupNorm
   group), on phase 4's noise, against phase 4's tracks, exactly one
   launch; and a 10-replan episode against the plain episode on the same
   noise (row 3's plain time is bench_kernels' 80-replan plain episode,
   phase 16).
6. episode, K = 4, selection_horizon 8: 8 replans against the plain
   episode, the chosen candidate of every replan included; one launch.
7. bench.py's default path, the protocol ``sustained_800step_dependent_chain``:
   10 dependent 80-replan episodes through the episode kernel, each x0 the
   last episode's final state, one sync at the end; the counts are set to 0
   just before and read just after (10 episode launches, nothing else). It
   prints ``closed_loop_control_hz`` on a line of its own.
8. ``BENCH_FUSED=1``: the plain sampler's closed loop with the U-Net pass
   kernel as the denoiser, 10 replans (300 launches), against the same loop
   with the plain forward.

The distilled student's path (``scripts/bench_deep_students.py``'s): the
1-eval student ``student_1eval.pkl`` on its times grid [23], with its
teacher's normalizer statistics (``data/teacher_stats.py``) and the
collection cost it is scored with. The grid [23] is one step with c1 = 1 and
c2 = 0, so every kernel check also runs the 3-step grid [23, 15, 7] on the
same weights, which exercises the affine update and the step loop.

9. student chain vs plain: the DDIM chain kernel (one cluster per sample)
   against its plain version on three contexts at B = 1 and B = 4, on both
   grids; and on [23] against one pass of the U-Net pass kernel followed by
   the recon and clip.
10. the student's per-replan path: ``make_closed_loop`` with the DDIM chain
    kernel as its ``sample_override``, 80 replans from x0 at K = 1; the
    counts are set to 0 just before and read just after (80 chain launches,
    nothing else). The same loop through the plain chain must give the same
    tracks.
11. student episode: one launch of the DDIM episode kernel (one cluster of 8
    CTAs on the body's one row-set) on phase 10's
    noise, against the plain episode and phase 10's tracks; on the 3-step
    grid against the plain episode; at K = 4 with selection_horizon 8, 8
    replans on both grids, the chosen candidate of every replan equal.
12. the student's sustained protocol: 10 dependent 80-replan K = 1 episodes
    through the episode kernel, one sync; the counts are set to 0 just
    before and read just after (10 episode launches, nothing else). It
    prints the replans per second as ``student_closed_loop_control_hz``.
13. student quality: 10 K = 1 episodes through the episode kernel from x0,
    each on the draw of a seeded ``torch.Generator``; each seed's cost over
    the expert's in ``report.json``, and their mean, which must be at most
    1.05.
14. timing: every kernel and its plain version by CUDA events at the main
    paths' shapes (the plain CFG episode, 80 replans at ~11 s, by
    bench_kernels' call on the host clock in phase 16); the U-Net pass and the DDIM chain both by their launch
    alone (``_launch`` on prepared tensors) and by the wrapper's whole call
    (``FusedUnet.forward``, ``FusedDdimChain.__call__``), which splits off
    the host's share; the DDIM chain also on [23, 15, 7] and at B = 4; the
    per-replan loops' and the ``BENCH_FUSED=1`` loop's replans per second.

The fused conv block and the port's ``bench_kernels``, the path that runs it:

15. conv: the fused Conv1d + GroupNorm + Mish kernel against its plain
    version at ``bench_kernels``' six shapes, with and without a FiLM
    pre-bias, b, gamma and beta drawn, and once at eps 1e-3; the counts are
    read back exactly.
16. ``bench_kernels --quick``: every row of the port's kernel benchmark (the
    conv rows, one U-Net pass, both chains, the CFG episode), each kernel
    within its tolerance of its plain twin; the counts are set to 0 just
    before and read just after.
17. flagship quality: ``scripts/flagship_parity``'s protocol on the card, 10
    torch-seeded K = 1 loops of 80 replans through the CFG chain kernel with
    the flagship dataset's statistics (``data/flagship_stats.py``): the mean
    closed-loop cost over the JAX package's iLQR expert on the CPU
    (``data/flagship_expert_yardstick.py``, 784,750.03; the report's TPU
    expert, 784,750.6, printed beside it) at most 1.01 and all 10 runs
    swinging left, the report's modality; the horizon cost printed beside
    the report's and the parity against that expert's tracks beside the
    report's parity. Then the same 10 seeds through the CFG episode
    kernel (``flagship_parity.run_episode_quality``, 10 launches and nothing
    else) under the same gate.
18. timing of the conv kernel at the six shapes: the launch alone as the
    device sees it (100 launches of ``FusedConv1dGnMish._launch`` on
    prepared tensors captured into a CUDA graph, the graph replayed between
    CUDA events, ``scripts/conv_timing.py``'s ``graph_ms``), the whole call
    (``kernel``, by CUDA events), the kernel's device time per launch from
    ``torch.profiler`` at the last shape (or none where it records none), its
    plain version,
    the three PyTorch calls that compute the same block (``torch_seq``) and
    the bound, with the bound's share of the launch alone.

bf16 weights (``weights_dtype=torch.bfloat16``, ``bench.py``'s ``BENCH_BF16=1``)
and the port's bench:

19. bf16: the bf16 entries against their plain bf16 versions
    (``models/bf16.py``). A kernel and its plain version sum in other
    orders, so now and then an activation rounds to the other bf16
    neighbour in one of them; over 30 steps such flips cascade until two
    correct bf16 versions part by about as much as bf16 parts from fp32. So
    the gate is at one U-Net pass (T = 1, no tail): the chain over 64
    samples in one launch, the episode over 64 replans at K = 1 and 8 at
    K = 4 (choices equal), the per-sample max |kernel - plain| at most 5e-6
    at the median and 1e-3 at the worst (``ONE_PASS_*``). At full depth the
    chain on phase 3's three contexts and the episode on phase 4's noise
    over 10 replans are held to JAX's own bound of bf16 against fp32, 8e-2,
    and their differences printed; K = 4 over 8 replans prints both
    versions' choices.
20. the flagship's quality through the bf16 episode, phase 17's protocol
    over 3 seeds: recorded, not gated (no bf16 report exists).
21. the port's bench: ``python3 -m mpc_via_diffusion_model_tpu_torch.bench``
    in a process of its own with ``bench.py``'s protocol cut
    (``BENCH_SMOKE=1``, the bench's ``SMOKE_CUT``: one sustained chain of 2
    dependent episodes and 2 independent episodes for the pipelined rate;
    5 episode launches), its last line parsed and its keys checked; then
    ``bench.run`` in this process for the episode in bf16 (one repetition
    per measure), for ``chain`` and ``chain`` in bf16 (one episode of 20
    replans each) and for ``1`` (one episode of 5 replans), each launch
    count exact. Then the bf16 entries' times.

The LMPC parity workload (``scripts/lmpc_parity.py``: the linear cart-pole
at horizon 8, context 4, against its LQR expert; the committed weights and
``data/lmpc_stats.py``):

22. LMPC kernels against plain: the CFG chain kernel at H = 8 on three
    contexts at B = 1 and one at B = 8 (1e-4), and the episode's
    ``cfg_episode_lmpc`` entry from the sweep's first state, 10 replans at
    K = 1 and 4 at K = 8 (tracks 1e-3; choices equal wherever the plain
    version's best two candidate scores are more than 1e-5 apart, each
    near-tie printed with both scores and both choices); one launch each.
23. LMPC parity: ``lmpc_parity``'s episode route over the 16 sweep states,
    50 replans each. n = 1 (16 launches and nothing else): every track
    finite, each state's u_l1 within 1e-3 + 1% of the JAX package's loop on
    the CPU (``LMPC_U_L1``) and the mean within 1% of its mean, printed
    beside it and ``report.json``'s. K = 8 (one launch per state; reported,
    not gated; over the first 2 states, to keep the script within its time):
    the same numbers beside the report's (over 16 states), the choices
    other than candidate 0, and the spread of the 8 candidates' first
    controls (the chain kernel at B = 8 on the first 2 states' replans). The chain
    route over the first 2 states (100 chain launches) gives the episode's
    tracks within 1e-3. Then the times of the episode entry at K = 1 and 8
    and of the chain at H = 8.

Training on the card (``train/trainer.py``; the yardstick
``data/lmpc_train_yardstick.py``, the JAX package's 200 steps on the CPU):

24. training against the JAX package: step 1 of ``scripts/flagship_lmpc.py``
    (the recipe's dataset, 146,250 LQR solves) on the card, its limits
    within 1e-5 of the yardstick's; the initial weights (``init_like_flax``
    from ``RandomState(1)``) with the yardstick's checksum; step 1's loss
    and gradient against the same step in float64 on the CPU (1e-5
    relative), with the signs that differ and the near-zero gradients
    counted; the 200 yardstick steps as one ``make_scanned_train_steps``
    chunk on the staged draws, gated as ``YS_*`` states, the kernel
    entries that read only zero padding exactly at their init, and the EMA
    a hard copy of the parameters.
25. the trained model through the kernels: the EMA weights carried through
    ``to_flax_params`` and ``from_flax_params`` into a fresh module, with
    step 1's statistics: the CFG chain at H = 8 on three contexts (1e-4)
    and ``cfg_episode_lmpc`` from the sweep's first state, 10 replans at K
    = 1 (tracks 1e-3), each against its plain version; 3 and 1 launches.
26. the training rate: ``Trainer.fit`` chunked (32), batch 512, 64
    steps under ``cudnn.deterministic``, steps per second by the host clock
    and ms per step by CUDA events, beside step 1's collection time; a
    checkpoint and the generator's state taken after step 32, and a fresh
    ``Trainer`` resumed from it runs the last 32 steps again on the same
    draws: the mean loss, params, EMA and Adam's moments equal the
    uninterrupted run's.

The flagship's iLQR expert (``solvers/ilqr.py``, ``make_nmpc_closed_loop``; no
kernel of the port: eager PyTorch on the card), against the JAX package's on
the CPU (``data/flagship_expert_yardstick.py``):

27. iLQR batch: one ``ilqr_solve`` (H = 32, 25 iterations) over the flagship
    collection's first control step: its 400 nominal solves (grid 10 x 20
    times kicks +-5) and 10 replicas of each from a seeded
    ``torch.Generator`` (4,400 solves); the nominal costs and first controls
    within ``FIRST_STEP_BOUNDS`` of the JAX package's and every
    ``backward_ok`` as its; one iteration first under
    ``torch.cuda.set_sync_debug_mode("error")`` and ``torch.profiler``, with
    no synchronizing CUDA runtime call inside an ATen op; the seconds
    and ms per iteration, by the host clock and CUDA events, the converged
    fraction.
28. NMPC prefix: ``make_nmpc_closed_loop`` from the flagship's x0 for its
    first 5 steps, within ``EXPERT_BOUNDS[5]`` of the JAX package's expert
    (cost, controls, states); ms per control step, and per iteration of
    its solves at batch 1.

Progressive distillation and the AMPC baseline (``diffusion/distillation.py``,
``models/ampc.py``, ``make_ampc_closed_loop``), against the JAX package on the
CPU (``data/distill_yardstick.py``), and the first launches at horizon 64:

29. distill steps: step 1 of round 0 (the teacher
    ``artifacts/flagship_modality``, H = 64, batch 512, CFG teacher at w =
    0.01) against the same step in float64 on the card, loss and gradient
    within the yardstick's (d) (``GRAD_BOUND``, ``LOSS1_BOUND``); then the
    yardstick's 60 staged steps (50 of round 0, 10 of round 1 on round 0's
    EMA) through ``make_scanned_train_steps``: every loss within (d)'s
    ``LOSS_BOUNDS`` tiers of the JAX package's (steps 1-10, 1-50, every
    step), the checksums of the params and the EMA at steps 1, 10, 50 and 60
    within ``CHECKSUM_BOUND``, no update skipped; ms per step by the host
    clock and by CUDA events.
30. the first launches at H = 64: round 0's EMA student (12 evals) through
    the DDIM chain kernel at B = 1 and 3 on two contexts each against its
    plain sampler (1e-4), and through the DDIM episode kernel (K = 1, 20
    replans, the teacher's statistics and the collection cost) against the
    plain loop (``make_closed_loop`` with the plain sampler; controls 1e-4 in
    normalized units, the rest 1e-3); the teacher through the CFG episode
    kernel (K = 1, 5 replans) against the plain episode; counts exact; the
    kernels' and plain versions' times.
31. AMPC loop: ``make_ampc_closed_loop`` on ``AMPCNet(horizon=64)`` with the
    yardstick's weights, 80 steps from x0, the summed cost and the controls
    within ``AMPC_BOUNDS`` of the JAX package's.

The quadrotor student's serving path (the JAX package's
``scripts/bench_quadrotor_student.py``): the 1-eval student
``artifacts/onpolicy_quadrotor/student_1eval.pkl`` at horizon 48 with a
12-dim context, the quadrotor plant (``dynamics/quadrotor.py``), the
safety-first selection cost (``scripts/quadrotor_task.py``) and
``data/quadrotor_stats.py``; every kernel check on [23] and [23, 15, 7]:

32. quadrotor kernels: the DDIM chain at H = 48 against plain at B = 1 and 4
    on two contexts each (1e-4); the main path, its counts set to 0 just
    before and read just after: the per-replan loop through the chain (20
    launches), the quadrotor episode entry ``ddim_episode_quadrotor`` at K =
    1 over 20 replans and at K = 4 with the safety-first scorer over 10 (one
    launch each), each against its plain version (controls in normalized
    units at 1e-4, the rest at 1e-3; the choices equal wherever the plain
    version's best two scores are more than 1e-5 apart, each near-tie
    printed; the reported costs the task quadratic on the tracks), K = 1
    also against the loop; the same on [23, 15, 7].
33. in-kernel noise: the draw's test entries give Random123's three
    known answers of Philox4x32-10; 2^20 in-kernel normals against the
    twin's table (1e-5) and within tests/test_fused_episode.py:341-362's
    moment and quantile tolerances of N(0, 1); the episode's draw entry at
    K = 1 (20 replans) and K = 8 (10) against the plain episode on the
    twin's table, gated as phase 32; one seed twice gives the same bits, two
    seeds different tracks.
34. quadrotor quality: 16 of the 64 eval starts x 60 replans at K = 1
    (staged) and K = 8 (in-kernel draw), ``track_metrics`` printed (no
    track may diverge), ms per replan, and the sustained rate of one
    600-replan episode per launch at K = 1 (staged and drawn) and K = 8.
    The full 64-start protocol is ``scripts/bench_quadrotor_student.py``'s.

The scene-conditioned student's serving path (the JAX package's
``scripts/bench_scene_student.py``): one student for any obstacle layout,
``artifacts/scene_conditioned/scene_student_ema.pkl`` at horizon 48 with a
24-dim context (the 12-state followed by the scene's 12 features,
``control/conditions.py::ConcatFeatures``), ``data/scene_stats.py``, held-out
scene 0 of ``sample_scenes(1, seed=99)``, T = 25 + 5, w = 0.01:

35. scene episode: ``cfg_episode_quadrotor`` (the CFG episode with the
    quadrotor, the context map and the scene's safety-first scorer in the
    kernel) at K = 1 over 10 replans and at K = 16 over 3, one launch each,
    against its plain version (controls in normalized units at 1e-4, the
    rest at 1e-3; the choices equal wherever the plain version's best two
    scores are more than 1e-5 apart, each near-tie printed); scene 1
    through the same library, its table differing only in the features and
    the spheres, its track another.
36. scene chain: the CFG chain at H = 48 and context 24 at B = 1 and 16
    against its plain version (1e-4); the main path of the per-replan loop
    (``make_closed_loop`` with the scene's ``state_to_condition``) through
    it over the first 10 replans of phase 35's K = 1 noise (10 launches)
    against the loop through the plain chain and against that episode.
37. scene bench: ``scripts/bench_scene_student.py``'s K = 1 row, its 16
    starts x 60 replans through the episode (16 launches), its metrics
    within ``data/scene_yardstick.py``'s bounds; its pipelined (3 episodes)
    and sustained (3 chained episodes) rates. The K = 16 rows are the
    bench's.
38. guided parts: on the quadrotor flagship's teacher (H = 48, context 12),
    the U-Net pass kernel at B = 2, 32 and 256 against ``TemporalUnet``
    (1e-4; whole call timed beside it), the CFG chain at B = 1 and 16
    against its plain version (1e-4); ``make_penalty_grad`` on the card
    against the CPU's on a batch with two overflowing plans (their raw
    gradient not finite, their step 0); one guided CFG step through the
    kernel against the plain denoiser (1e-4 in normalized units).
39. guided loop: the flagship's guided loop from ``bench_highdim.py``'s
    start over 1 replan through the U-Net pass kernel (30 launches) and
    its unguided loop through the chain (1 launch), each against its
    plain route (controls 1e-4 in normalized units, the rest 1e-3); one
    guide call timed.
40. guided study: the scene study's per-scene guided oracle over the
    held-out protocol's 128 (scene, start) pairs as one batched loop
    through the kernel at B = 256 (30 launches) and the scene-blind
    teacher through the chain at B = 128 (1 launch), 1 replan each on the
    same noise; ms per replan; then the paired gate of
    ``data/guided_yardstick.py`` on their first plans, each rolled
    open-loop against its own scene: the guide's per-pair gain in min
    clearance (mean, and pairs raised) within the JAX package's bounds,
    and the same oracle with a guide that returns zeros outside them; one
    batched guide call timed and traced (the host's share of it, and the
    guide calls' share of the replan). The 60-replan protocols, their
    yardstick and their paired gates are the scripts'
    (``scripts/flagship_quadrotor.py``,
    ``scripts/scene_conditioned_quadrotor.py``).

The scene study's making half (``scripts/scene_conditioned_quadrotor.py
--make``, ``scripts/onpolicy_scene.py``):

41. scene making: one chunk of the guided data with per-row scenes (the
    teacher's dataset's states, the training scenes, the chunk's staged
    noise) at B = 256 through the U-Net pass kernel at 512 rows against the
    plain denoiser: the plans within 1e-4, the same keep mask but where a
    row lies within 1e-4 of a threshold, 30 launches; one chunk at the
    script's B = 2,048 (4,096 rows) timed, and one pass at 4,096 rows
    against ``TemporalUnet`` (1e-4); then the script's ``--make --quick``
    (its teacher rows left out) within ``data/scene_making_yardstick.py``'s
    bounds, its student and dataset written under
    ``build/chip_smoke_making/`` and removed at the end.
42. onpolicy scene: one labeler batch, 256 rows x K = 16 of the scene
    student plus the LQR hover plan, through the CFG chain kernel at 4,096
    samples against its plain version (the candidates within 1e-4 but the
    chaotic samples, found as in phase 41, at most 15%; the same picks on
    the rows of calm samples but near-ties; one launch); then
    ``onpolicy_scene`` at the
    yardstick's toy size on phase 41's output within
    ``data/onpolicy_scene_yardstick.py``'s bounds.

The panda arm's student (the JAX package's ``scripts/bench_panda_student.py``): the on-policy
1-eval student at horizon 128 with 7 channels and a 20-dim context (``make_panda_context``: q,
qd and the end effector's position and velocity), the rigid-body arm (``dynamics/arm.py``) and
``data/panda_stats.py``, on the one-row-set plan of shared memory (154,764 B per CTA; the CFG
kernels' two-row-set plan does not fit one block there, and they run their two passes in turn,
phases 46-48):

43. panda kernels: the U-Net pass at B = 2 and 16 and the DDIM chain at B = 1 and 16 on [23]
    and B = 1 on [23, 15, 7] against their plain versions (1e-4), and kernel 2's path,
    ``bench_kernels``' panda rows (the U-Net pass and the 3-eval chain within 1e-4 of their
    twins, the CFG chain on the teacher in turns); the pass's and the chain's times.
44. chain split: the bench's K = 1 row, its 10 episodes of 80 replans as one batched loop
    through the DDIM chain (80 launches), and its K = 16, sel_h 32 row over the 10 episodes'
    first 20 replans (20 launches at 160 samples; the eager arm's rollouts are launch-bound),
    the counts set to 0 just before and read just after; the mean cost within
    ``data/panda_yardstick.py``'s bounds of the JAX package's on the CPU; the first 2 replans
    of each against the loop through the plain chain (controls 1e-4 in normalized units, the
    rest 1e-3).
45. panda episode: ``ddim_episode_panda`` (``PandaRbd`` and ``PandaContext`` of
    ``plants.cuh`` inside the DDIM episode) at K = 1 and at K = 4 with selection horizon 16,
    one launch per episode over the 10 episodes (20 launches), their mean costs within the
    yardstick's bounds; against the plain twin (``panda_rbd_unrolled``) over 10 replans at
    K = 1 and 2 at K = 4 on the same staged noise (phase 32's gate); K = 4 at selection
    horizon 1 beside 16 for the time of the scorer's serial arm steps.

The panda arm's CFG teacher (the JAX package's ``scripts/bench_highdim.py`` panda rows;
``artifacts/flagship_panda_rbd/ema_params.pkl``, the student's architecture): the CFG kernels on
the plan in turns (the conditional and the unconditional pass one after the other on one
row-set's activations; 158,348 B per CTA for the chain, 174,928 B for the episode at K = 1):

46. panda CFG chain: ``cfg_chain_turns`` at B = 1 (the protocol's x0) and 16 against its plain
    version (1e-4 over the calm samples; the chaotic ones, whose chain's clip amplifies fp32
    differences, found as in phase 41, at most 15% and listed), ``cfg_chain_turns_bf16`` at one
    pass over 64 samples (on the flagship phase 19's gate; at the panda shape, where nearly
    every sample flips a rounding, nearer its plain version than three known-wrong functions'
    plain versions, with the fp32 entry's output put through the same gate as a control that
    must fail it) and at full depth (phase 19's 8e-2), their times; on the flagship, the chain
    in turns against its two-row-set kernel and its plain version on the same noise (1e-4),
    their times taken in turns; the counted runs: the teacher's chain split through the bf16
    entry (and the fp32 one) and the flagship's per-replan loop through its entry in turns
    (against its two-row-set kernel, 1e-3), 3 replans each.
47. panda CFG episode: ``cfg_episode_panda`` against its plain twin (``panda_rbd_unrolled``) on
    staged noise over 3 replans at K = 1 and 2 at K = 4 (sel_h 16), the choices equal but at
    near-ties; ``cfg_episode_panda_draw`` over 3 replans against the plain episode on
    ``cfg_normal_table``'s draw of the seed, one seed twice giving the same bits; the chain
    split (kernel 1 with ``panda_rbd`` in torch, 3 launches) against the staged episode's tracks
    (one launch) on the same noise, within 1.6e-5 (controls in normalized units), the counts
    set to 0 just before and read just after.
48. teacher quality: 10 episodes of the yardstick's first 20 replans through the drawing entry
    (10 launches, the counts set to 0 just before and read just after), each seeded by
    ``seed_from_generator``; their mean cost within ``data/panda_teacher_yardstick.py``'s bounds
    of the JAX package's on the CPU, and each episode within the yardstick's paired bound of the
    port's plain episode on the CPU on the same seed; the same path at w = 0 on the first seed,
    a control, must lie outside that bound. The full 80-replan gate is
    ``scripts/bench_highdim.py``'s.

ROADMAP.md's B1 (bf16 weights in kernels 2, 4 and 5; ``clip_denoised=False``
in kernels 1, 3, 4 and 5), carried by the panda arm's distillation recipe:

49. bf16 at one pass: ``fused_unet_bf16``, ``ddim_chain_bf16`` and
    ``ddim_episode_bf16`` on the flagship's shape (the flagship, the
    cart-pole student, 64 samples or replans) and ``fused_unet_bf16``,
    ``ddim_chain_bf16`` and ``ddim_episode_panda_bf16`` on the panda's (the
    distilled 3-eval student at H = 128; 64 samples, 16 replans), each
    through ``bf16_nearest_gate`` against the known-wrong functions of
    ``B1_WRONG`` (the pass keeps its final 1x1 conv fp32, the DDIM kernels
    round theirs), the pass on raw eps within ``UNET_BF16_ONE_PASS_MAX``
    elementwise, the chain and the episode's controls (against the plain
    chain's from the kernel's own states) within 1e-3; each fp32 entry
    through the same gate, a control,
    must fail it; at full depth ([23, 15, 7]) within phase 19's 8e-2; the
    launches exact; each bf16 entry timed in turns with its fp32 entry.
50. ``clip_denoised=False``: the CFG chain (B = 4) and episode and the DDIM
    chain (B = 4) and episode (3 replans each) on the flagship's weights
    against their plain versions (chains 1e-4 relative to their largest
    magnitude past 1, episodes' controls 1e-4 in normalized units), on
    inputs where the clip binds (the share of reconstructions beyond +-1,
    printed, must be above 0; the DDIM draws scaled by 3); each clip-on
    kernel, a control, must lie outside the tolerance.
51. ``distill_panda``: the recipe's serving rows (``scripts/distill_panda.py``)
    on the committed 3-eval student, fp32 and bf16, 10 episodes of 20
    replans through the chain split (20 launches each, the counts set to 0
    just before and read just after): each fp32 episode within
    ``data/distilled_panda_yardstick.py``'s paired bound of the port's plain
    chain split on the CPU, the bf16 row (another function) outside it, both
    means within the bound of the JAX package's; then 5 distill steps from
    the teacher on its dataset (batch 256), each loss within the
    yardstick's relative bound of the JAX package's.

It then prints the ``training`` JSON line, the ``ilqr`` JSON line, the
``distill`` JSON line, the ``kernels`` JSON line (rows 1 and 3 carry their bf16
entries under ``bf16``, row 1 its H = 8 times under ``h8``, rows 3, 4 and 5 their
H = 64 times under ``h64`` (phase 30), rows 4 and 5 their H = 48 times under
``h48`` (phase 32), ``cfg_episode_lmpc`` has a row of its own as a further
entry of kernel 3, and ``ddim_episode_quadrotor`` one as a further entry of
kernel 5, with its in-kernel draw under ``inkernel_noise``; row 1 its H = 48,
context 24 times under ``h48`` (phase 36) and ``cfg_episode_quadrotor`` a row
of its own as a further entry of kernel 3, rows 1 and 2 their times on the
quadrotor teacher, H = 48 and context 12, under ``h48_ctx12``, phases 38-40, and
the U-Net pass at 4,096 rows and the CFG chain at 4,096 samples under ``b4096``,
phases 41-42, rows 2 and 4 their panda times under ``panda`` and ``ddim_episode_panda`` a row of
its own as a further entry of kernel 5, phases 43-45, row 1 its panda times in turns under
``panda`` and the flagship's in turns under ``flagship_turns``, and ``cfg_episode_panda`` a row
of its own as a further entry of kernel 3, its draw under ``inkernel_noise``, phases 46-48;
rows 2, 5 and ``ddim_episode_panda`` their bf16 entries under ``bf16`` and row 4 its panda bf16
entry under ``panda_bf16`` with the recipe's rows under ``distill_panda``, and rows 1, 3, 4 and 5
their clip-off runs under ``clip_off``, phases 49-51), the
``guided`` JSON line (phases 38-40), the ``making`` JSON line
(phases 41-42), the
``phase_seconds`` line (each phase's seconds), the nvidia-smi line and,
last, the result line. Any failure raises, and the exit code is then not 0.

Phases 3-8 and ``bench_kernels``' episode row run the flagship with the
synthetic limits of ``bench.py`` (controls +-30, conditions +-10); phase 17
with its dataset's own.
"""
from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mpc_via_diffusion_model_tpu_torch import bench as port_bench
from mpc_via_diffusion_model_tpu_torch.control import (make_ampc_closed_loop, make_closed_loop,
                                                       make_nmpc_closed_loop)
from mpc_via_diffusion_model_tpu_torch.core import make_schedule
from mpc_via_diffusion_model_tpu_torch.data import (NormalizerStats, lmpc_stats, normalize,
                                                    unnormalize)
from mpc_via_diffusion_model_tpu_torch.data import distill_yardstick as dys
from mpc_via_diffusion_model_tpu_torch.data import flagship_expert_yardstick as xys
from mpc_via_diffusion_model_tpu_torch.data import lmpc_train_yardstick as ys
from mpc_via_diffusion_model_tpu_torch.data.lmpc_stats import LMPC_U_L1, LMPC_U_L1_SUMMARY
from mpc_via_diffusion_model_tpu_torch.data import guided_yardstick as gys
from mpc_via_diffusion_model_tpu_torch.data import onpolicy_scene_yardstick as oys
from mpc_via_diffusion_model_tpu_torch.data import scene_making_yardstick as mys
from mpc_via_diffusion_model_tpu_torch.data import scene_yardstick as sys_
from mpc_via_diffusion_model_tpu_torch.data import panda_teacher_yardstick as tys
from mpc_via_diffusion_model_tpu_torch.data import panda_yardstick as pys
from mpc_via_diffusion_model_tpu_torch.data import distilled_panda_yardstick as dpy
from mpc_via_diffusion_model_tpu_torch.data.panda_stats import panda_stats
from mpc_via_diffusion_model_tpu_torch.data.quadrotor_stats import quadrotor_stats
from mpc_via_diffusion_model_tpu_torch.data.scene_stats import scene_stats
from mpc_via_diffusion_model_tpu_torch.data.teacher_stats import teacher_stats
from mpc_via_diffusion_model_tpu_torch.diffusion import (GaussianDiffusion, ddim_time_grid,
                                                         distill_loss, halve_times)
from mpc_via_diffusion_model_tpu_torch.diffusion.distillation import (ddim_affine_coefs,
                                                                      make_student_ddim_sampler)
from mpc_via_diffusion_model_tpu_torch.dynamics import (cartpole_lmpc, cartpole_lmpc_cost,
                                                        cartpole_virtual_collect_cost,
                                                        cartpole_virtual_cost,
                                                        cartpole_virtual_swingup, quadrotor,
                                                        quadrotor_cost, theta_to_red_theta)
from mpc_via_diffusion_model_tpu_torch.dynamics.arm import (make_panda_context, panda_cost,
                                                            panda_rbd, panda_rbd_unrolled)
from mpc_via_diffusion_model_tpu_torch.dynamics.base import rollout
from mpc_via_diffusion_model_tpu_torch.dynamics.quadrotor import obstacle_cost
from mpc_via_diffusion_model_tpu_torch.eval.timing import pipelined_time_fn
from mpc_via_diffusion_model_tpu_torch.models import (LMPC_CONFIG, TEACHER_CONFIG, AMPCNet,
                                                      TemporalUnet, from_flax_params,
                                                      load_flagship, load_lmpc,
                                                      load_panda_student, load_panda_teacher,
                                                      load_quadrotor_student, load_scene_student,
                                                      load_student,
                                                      mlp_from_flax_params, to_flax_params)
from mpc_via_diffusion_model_tpu_torch.models.bf16 import bf16_conv_copy
from mpc_via_diffusion_model_tpu_torch.ops import _build, fused_conv1d_gn_mish, philox
from mpc_via_diffusion_model_tpu_torch.ops.fused_denoise import (
    cfg_chain_bf16_max_active_clusters, cfg_chain_max_active_clusters,
    ddim_chain_max_active_clusters, FusedCfgChain, make_fused_cfg_chain, make_fused_ddim_chain)
from mpc_via_diffusion_model_tpu_torch.ops.fused_episode import (
    cfg_episode_bf16_max_active_clusters, cfg_episode_lmpc_max_active_clusters,
    cfg_episode_max_active_clusters, cfg_episode_panda_draw_max_active_clusters,
    cfg_episode_panda_max_active_clusters, cfg_episode_quadrotor_max_active_clusters,
    ddim_episode_max_active_clusters, ddim_episode_panda_max_active_clusters,
    ddim_episode_quadrotor_draw_max_active_clusters, ddim_episode_quadrotor_max_active_clusters,
    make_fused_cfg_episode, make_fused_ddim_episode)
from mpc_via_diffusion_model_tpu_torch.ops.fused_unet import (fused_unet_max_active_clusters,
                                                              make_fused_unet)
from mpc_via_diffusion_model_tpu_torch.ops.unet_pack import CLUSTER, TURNS, cluster_split, pack_unet
from mpc_via_diffusion_model_tpu_torch.scripts import (bench_highdim, bench_kernels,
                                                       bench_panda_student,
                                                       bench_scene_student,
                                                       conv_timing, distill_divergence,
                                                       distill_panda, distill_panda_divergence,
                                                       flagship_lmpc, flagship_parity,
                                                       flagship_quadrotor, guided_divergence,
                                                       lmpc_parity, onpolicy_scene,
                                                       quadrotor_task,
                                                       scene_conditioned_quadrotor)
from mpc_via_diffusion_model_tpu_torch.scripts.quadrotor_task import (eval_start_states,
                                                                      make_select_cost)
from mpc_via_diffusion_model_tpu_torch.scripts.conv_timing import cuda_ms
from mpc_via_diffusion_model_tpu_torch.solvers import ILQRConfig, ilqr, ilqr_solve
from mpc_via_diffusion_model_tpu_torch.train import (ParamLayout, Trainer, diffusion_loss,
                                                     make_scanned_train_steps, save_checkpoint,
                                                     value_and_grad)
from mpc_via_diffusion_model_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "artifacts" / "flagship" / "ema_params.pkl"
STUDENT = ROOT / "artifacts" / "onpolicy_cartpole" / "student_1eval.pkl"
STUDENT_REPORT = ROOT / "artifacts" / "onpolicy_cartpole" / "report.json"
LMPC = ROOT / "artifacts" / "flagship_lmpc" / "ema_params.pkl"
GRID, GRID3 = [23], [23, 15, 7]   # the 1-eval student's times grid; the 3-eval grid
N_QUALITY = 10             # seeds of the student's quality check
N_BF16_QUALITY = 3         # seeds of phase 20's bf16 quality record (5 until phases 49-51, 10
                           # until phases 35-37)
N_TIMED_LOOP = 20          # replans of phase 14's timed per-replan loops (80 until phases 49-51)
QUALITY_MEAN_MAX = 1.05    # mean cost over the expert's (report: 1.0064 over 10 seeds)
# The flagship's mean cost over its expert's: the JAX package's expert on the CPU, 784,750.03
# (data/flagship_expert_yardstick.py; report.json: 784,747.4 over 784,750.6 on the TPU)
FLAGSHIP_MEAN_MAX, FLAGSHIP_MODALITY = 1.01, {"left": 10, "right": 0}
N_STEPS, HORIZON, T, N_TAIL, W = 80, 32, 25, 5, 0.01
N_PLAIN_LOOP = 10          # replans of the plain per-replan loop (phase 4) and of the plain
                           # episode phase 5 holds the kernel to (80 took 11 s; 20 until phases
                           # 35-37 were added; row 3's plain time is bench_kernels' 80-replan
                           # plain episode, phase 16)
N_BF16_EP = 10             # replans of phase 19's full-depth bf16 episode (at 80 its plain
                           # version took 20 s; 20 until phases 35-37 were added)
K4, SEL_H, N_STEPS_K4 = 4, 8, 8
N_CHAIN = 10               # dependent episodes of the sustained protocol
N_UNET_LOOP = 10           # replans of the BENCH_FUSED=1 loop
# Kernel vs plain version, u_norm after one chain: fp32 sums in other orders
# (FMA loops vs cuDNN), ~1e-6 expected; 1e-4 is the JAX suite's chain
# tolerance. The first step's 1e6 coefficients are clipped right after and
# amplify only elements with |x - eps| < ~1e-6. One U-Net pass: the same.
CHAIN_TOL = UNET_TOL = 1e-4
# The conv block, kernel vs plain: bench_kernels' tolerance, the JAX suite's for kernels
CONV_TOL = bench_kernels.KERNEL_TOL
CONV_SHAPES = bench_kernels.CONV_SHAPES
# Tracks of closed loops, kernel vs plain: per-replan differences of ~1e-6
# in u_norm (x30 after unnormalizing) pass through up to 80 plant steps.
TRACK_TOL = 1e-3
# The student's controls span its teacher's limits, +-3,381 on average
# (data/teacher_stats.py), so the same ~1e-6 in u_norm is ~1e-2 in u: its
# controls compare in the sampler's normalized units, u over the half-range,
# at CHAIN_TOL; its states and costs at TRACK_TOL (student_close).
# bf16 weights (phase 19). A kernel and its plain version sum in other orders, so an
# activation within that difference of a midpoint between two bf16 numbers rounds one way in
# one and the other way in the other. One such flip moves a pass by up to ~1e-4 in u_norm; over
# 30 steps the flips cascade, and two correct bf16 versions then part by as much as bf16 parts
# from fp32 (on the CPU the plain bf16 chain in fp32 against float64 at T = 25 + 5, 64 samples:
# 1.1e-3 median, 3.1e-3 max; bf16 against fp32 itself 0.8e-3 median). So the bf16 kernels are
# gated at one U-Net pass (T = 1, no tail), over N_ONE_PASS samples or replans: a correct
# kernel agrees to fp32 rounding wherever no flip happened, which on the CPU was most of them
# (median 1.9e-7, 23% of samples flipped, max 8e-5), while one rounding point left out (the
# final 1x1 conv's input) moved every sample (median 2.5e-5). Full depth is gated at JAX's own
# bound of bf16 against fp32 (tests/test_fused_denoise.py:59-77) and otherwise recorded.
N_ONE_PASS = 64
ONE_PASS_MEDIAN_MAX, ONE_PASS_MAX = 5e-6, 1e-3
BF16_VS_FP32 = 8e-2
U_HALF_RANGE = 30.0        # bench.py's control limits +-30: u_norm = u / 30
BENCH_EPISODE_KEYS = ["metric", "value", "unit", "vs_baseline", "pipelined_hz", "protocol"]
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense bf16 on the tensor
# cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# The LMPC parity workload (phases 22-23): horizon 8, context 4, the linear cart-pole
LMPC_H, K8 = 8, 8
N_LMPC_EP, N_LMPC_EP8 = 10, 4   # replans of phase 22's episode checks at K = 1 and K = 8
# sweep states of phase 23's K = 8 run (reported, not gated): over all 16 the K = 8 run alone
# took 32.5 s and phases 22-23 44.4 s on the H100, at the 45 s they may take; over 8 it took
# 16.4 s on a slow host, where the whole script took 392 s with phases 29-31; 2 since phases
# 32-34 were added
N_LMPC_STATES_K8 = 2
N_LMPC_CHAIN_STATES = 2         # sweep states run through the chain route too
# Per state, u_l1 (a sum of 50 |du|) within 1e-3 + 1% of the JAX package's on the CPU; the mean
# within 1% of the JAX mean. Choices at K = 8 are compared where the plain version's best two
# scores are more than 1e-5 apart (relative): the candidates hardly differ, and nearer scores
# than that can swap under the fp32 difference between kernel and plain.
LMPC_ABS, LMPC_REL, NEAR_TIE = 1e-3, 0.01, 1e-5
# Training against the JAX package (phases 24-26; data/lmpc_train_yardstick.py). Step 1's limits and
# gradient: fp32 sums in other orders. The loss gates follow scripts/train_divergence.py on the
# CPU, the port against the same JAX run, 14 runs (the port as it is and with a random 10% of its
# initial weights moved by one ulp, 6 seeds, at 4 and 8 threads): steps 1-10 within 5.3e-7 of the
# yardstick, 11-50 within 3.1e-6, 51-100 within 1.2e-3, and then apart as chaotically as any two
# fp32 runs: every step within 0.30-0.67, the mean of the last 20 within 1.4-8.1% (the perturbed
# runs from the unperturbed one: 0.15-0.58 and 0.5-12.5%). The card starts from a larger rounding
# difference than the CPU, so the early gates leave room for it; the late ones are about twice
# the largest CPU value.
YS_LIMITS_RTOL = GRAD_REL_TOL = 1e-5
YS_HEAD, YS_HEAD_RTOL = 10, 1e-4     # steps 1-10
YS_EARLY, YS_EARLY_RTOL = 50, 1e-2   # steps 1-50
YS_STEP_RTOL = 1.5                   # every step
YS_TAIL, YS_TAIL_RTOL = 20, 0.16     # the mean of the last 20
# phase 26: Trainer.fit's steps in chunks of FIT_CHUNK, of which the last are resumed; 64 in
# chunks of 32 since phases 49-51 were added (126 in chunks of 63 since phases 41-42, 250 in
# chunks of 125 since phases 35-37, 500 in the recipe's chunks of 250 since phases 29-31, 1,000
# before: 30-49 s of the 335 s the script may take)
N_FIT, N_RESUME, FIT_CHUNK = 64, 32, 32
# The flagship's iLQR expert (phases 27-28; data/flagship_expert_yardstick.py, the JAX package on
# the CPU): the first step's 400 nominal solves beside N_NOISY replicas of each, and the first
# N_NMPC_PREFIX steps of the NMPC expert, within the yardstick's bounds (EXPERT_BOUNDS,
# FIRST_STEP_BOUNDS: twice the gaps scripts/ilqr_divergence.py saw on the CPU). A step of the
# expert took 1.2-2.1 s on the H100 (launch-bound eager iLQR, the host's speed varying between
# calls), and 10 steps pushed phases 27-28 to 25.6 s on a slow host, past their 25 s: 5 steps
N_NOISY, N_NMPC_PREFIX = 10, 5
# Distillation and the AMPC baseline (phases 29-31; data/distill_yardstick.py, the JAX package on
# the CPU): the 60 yardstick steps within its bounds (d), then the first launches at horizon 64:
# round 0's 12-eval student through the DDIM chain at B = 1 and B_DISTILL_CHAIN and through the
# DDIM episode over N_DISTILL_EP replans, and the teacher through the CFG episode over
# N_TEACHER_EP replans, each against its plain version
B_DISTILL_CHAIN, N_DISTILL_EP, N_TEACHER_EP = 3, 20, 5
# The quadrotor student's serving path (phases 32-34; the JAX package's
# scripts/bench_quadrotor_student.py): the 1-eval student at horizon 48, context 12, the
# quadrotor plant and its safety-first selection cost (scripts/quadrotor_task.py), the
# statistics of data/quadrotor_stats.py. Phase 32 checks K = 1 over N_Q_EP replans and K = K4
# with the safety-first scorer over N_Q_EP4, and the chain loop over N_Q_EP; phase 33 the
# in-kernel draw at K = 1 and K8; phase 34 runs N_Q_STARTS of the 64 eval starts over
# N_Q_STEPS replans and a N_Q_RATE-replan episode in one launch at K = 1 and K8.
QUADROTOR_STUDENT = ROOT / "artifacts" / "onpolicy_quadrotor" / "student_1eval.pkl"
N_Q_EP, N_Q_EP4, N_Q_STARTS, N_Q_STEPS, N_Q_RATE = 20, 10, 16, 60, 600
# the in-kernel normals (2^20 of them) against N(0, 1): tests/test_fused_episode.py:341-362's
# tolerances on the mean, the standard deviation, the 95% and 99% quantiles, the third and the
# fourth moment
NORMAL_TOLS = {"mean": 5e-3, "std": 5e-3, "q95": 2e-3, "q99": 1e-3, "m3": 2e-2, "m4": 5e-2}
# fp32 operations of one candidate's scoring step besides the six sin and cos: the quadrotor's
# step (69, plants.cuh) and the safety-first stage cost (107)
Q_STEP_FLOPS = 176
# The scene-conditioned quadrotor student's serving path (phases 35-37; the JAX package's
# scripts/bench_scene_student.py): the student at horizon 48 with a 24-dim context (the 12-state
# followed by the scene's 12 features, data/scene_stats.py), held-out scene 0 of the seed-99
# draw, T = 25 + 5, w = 0.01. Phase 35 holds cfg_episode_quadrotor to its plain version at K = 1
# over N_S_EP replans and at K = 16 (the scene's safety-first scorer) over N_S_EP16, and scene 1
# through the same build; phase 36 the CFG chain at H = 48, context 24, B = 1 and 16, and the
# per-replan loop over the first N_S_LOOP replans of the episode's noise; phase 37 the bench's
# K = 1 row (its 16 starts x 60 replans) within data/scene_yardstick.py's bounds, and its rates
# over N_S_CHUNKS chained episodes and N_S_PIPE pipelined ones. The first run took 30.8 s for
# the three phases, with N_S_LOOP 20 (the loop through the plain chain 211 ms per replan) and
# N_S_CHUNKS, N_S_PIPE 5, 4; the second 30.9 s on a host ~1.3x slower with 10, 3, 3; since
# phases 41-42 N_S_EP 10 (20 before), N_S_CHUNKS and N_S_PIPE 1 (2 before).
N_S_EP, N_S_EP16, N_S_LOOP, N_S_CHUNKS, N_S_PIPE = 10, 3, 10, 1, 1
# Cost-gradient guidance on the quadrotor flagship's teacher (phases 38-40; the port's
# scripts/flagship_quadrotor.py and scripts/scene_conditioned_quadrotor.py): horizon 48, context
# 12, T = 25 + 5, w = 0.01, the obstacle guide at scale 0.1. Phase 38 holds the U-Net pass kernel
# at G_UNET_BATCHES (2: one start's doubled batch; 32: the flagship's 16 starts; 256: the scene
# study's 128 pairs) and the CFG chain at G_CHAIN_BATCHES to TemporalUnet and the plain chain,
# make_penalty_grad on the card to the CPU's, and one guided step; phase 39 flies the flagship's
# guided and unguided loops from bench_highdim.py's start over N_G_LOOP replans through kernels 2
# and 1 against their plain routes; phase 40 the scene study's oracle and scene-blind rows over
# the held-out protocol's 128 pairs (scene 0's 16 starts until phases 41-42), N_G_LOOP replans,
# their paired gate, and one batched guide call traced for the device's busy share. A guided
# replan took 1.8-3.7 s on the card (the guide's eager autograd, ~9,400 kernels per call), and
# torch.profiler took ~80 s to trace one whole guided replan, so N_G_LOOP is 1 (2 until phases
# 41-42; the guide's effect on the plans shows in phase 40's paired gate) and only a guide call
# is traced (scripts/guided_profile.py traces whole replans).
N_G_LOOP = 1
G_UNET_BATCHES, G_CHAIN_BATCHES = (2, 32, 256), (1, 16)

# The scene study's making half (phases 41-42; the port's scripts/scene_conditioned_quadrotor.py
# --make and scripts/onpolicy_scene.py): the teacher's guided sampling with per-row scenes through
# the U-Net pass kernel at 2 B rows, checked against the plain denoiser on one chunk of MK_CHECK_B
# rows and timed on one chunk of the script's MK_FULL_B; its --quick making half within
# data/scene_making_yardstick.py's bounds; onpolicy_scene's labeler through the CFG chain kernel at
# LABEL_ROWS x LABEL_K samples against its plain version, and its toy run within
# data/onpolicy_scene_yardstick.py's bounds. A sampling chunk's keep mask may differ only where a
# row lies within KEEP_NEAR of one of the curation's thresholds. The plain route with its eps
# moved by a relative 1e-6 moved 9 of 256 rows by more than 1e-5 on the CPU (2 past 1e-4, 1.4e-3
# at most) and 17 on the card: such chaotic rows are left out of the gates, and may be up to
# MK_CHAOTIC_SHARE of the chunk (the card's first count was 6.6%; 0.05 failed there).
MK_CHECK_B, MK_FULL_B, LABEL_K, KEEP_NEAR, MK_CHAOTIC_SHARE = 256, 2048, 16, 1e-4, 0.15


PHASE_SECONDS = {}  # each phase's seconds by its log line, printed on one line before the last


def log(phase: str, t0: float, msg: str) -> None:
    seconds = time.perf_counter() - t0
    PHASE_SECONDS[phase] = round(seconds, 3)
    print(f"[{phase}] {seconds:.3f}s {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def bound(flops: float, n_bytes: float, bf16_flops: float = 0.0) -> dict:
    """The least time the card could take: the largest of the fp32 operations
    over the fp32 peak, the bf16 products (a bf16 entry's conv products, bf16
    weights on bf16-rounded activations) over the dense bf16 peak, and the
    bytes over the memory rate. The two kinds of operations run on different
    units, so their times are not added."""
    t_ops = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def assert_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Raises unless both are finite and agree within tol; returns max |diff|."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, msg=name)
    return (got.double() - want.double()).abs().max().item()


def student_close(name: str, got: torch.Tensor, want: torch.Tensor, u_unit: torch.Tensor) -> float:
    """assert_close for a track of the student: controls (u_track,
    u_horizons) divided by ``u_unit`` at CHAIN_TOL, the rest at TRACK_TOL."""
    if name.split()[-1].startswith("u_"):
        return assert_close(name, got / u_unit, want / u_unit, CHAIN_TOL)
    return assert_close(name, got, want, TRACK_TOL)


def one_pass_gate(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The bf16 kernels' gate at one U-Net pass: per sample (the first axis) the max |got -
    want|, whose median must be at most ONE_PASS_MEDIAN_MAX and whose max at most ONE_PASS_MAX;
    returns the median, the max and the share of samples past 1e-5 (flipped roundings)."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"{name}: non-finite values")
    per = (got.double() - want.double()).abs().flatten(1).max(dim=1).values.tolist()
    out = {"median": statistics.median(per), "max": max(per),
           "flipped_share": sum(v > 1e-5 for v in per) / len(per), "n": len(per)}
    if not (out["median"] <= ONE_PASS_MEDIAN_MAX and out["max"] <= ONE_PASS_MAX):
        raise RuntimeError(f"{name}: per-sample max |kernel - plain| median {out['median']:.3e} "
                           f"(at most {ONE_PASS_MEDIAN_MAX:.0e}), max {out['max']:.3e} (at most "
                           f"{ONE_PASS_MAX:.0e})")
    return out


def fmt_gate(g: dict) -> str:
    return (f"median {g['median']:.3e}, max {g['max']:.3e}, {100 * g['flipped_share']:.1f}% of "
            f"{g['n']} past 1e-5 (gate: median <= {ONE_PASS_MEDIAN_MAX:.0e}, max <= "
            f"{ONE_PASS_MAX:.0e})")


def near_tie(scores: torch.Tensor) -> bool:
    """Whether the best two candidate scores differ by at most NEAR_TIE, relative."""
    best2 = torch.sort(scores.double()).values[:2]
    return bool(best2[1] - best2[0] <= NEAR_TIE * best2[0].abs())


def counts(*wrappers) -> list:
    return [(w.launches, w.plain_calls) for w in wrappers]


def reset(*wrappers) -> None:
    for w in wrappers:
        w.launches = w.plain_calls = 0


def train_phases(dev, schedule) -> dict:
    """Phases 24-26 on ``dev``: training against the JAX package, the trained model through the
    LMPC kernels, the training rate and checkpoint resume. Returns the ``training`` line."""
    # 24. training against the JAX package (data/lmpc_train_yardstick.py): the recipe's step 1 on
    # the card, the yardstick's initial weights, step 1's gradient against float64 on the CPU, and
    # the 200 yardstick steps through make_scanned_train_steps
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tds = flagship_lmpc.collect_recipe_dataset(dev)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t1
    lim_err = max(
        ((getattr(tds.normalizer.stats[f], k).double() - torch.tensor(want, dtype=torch.float64))
         .abs() / torch.tensor(want, dtype=torch.float64).abs()).max().item()
        for f, k, want in (("inputs", "mins", ys.INPUTS_MINS), ("inputs", "maxs", ys.INPUTS_MAXS),
                           ("condition", "mins", ys.CONDITION_MINS),
                           ("condition", "maxs", ys.CONDITION_MAXS)))
    if tds.n_init != ys.N_SAMPLES or not lim_err <= YS_LIMITS_RTOL:
        raise RuntimeError(f"training: step 1 collected {tds.n_init} samples (want "
                           f"{ys.N_SAMPLES}); limits off the yardstick's by {lim_err:.3e} (rtol "
                           f"{YS_LIMITS_RTOL:.0e})")
    tmodel = flagship_lmpc.lmpc_model(dev)
    init_sum = ys.checksum(list(tmodel.parameters()))
    if init_sum != ys.INIT_CHECKSUM:
        raise RuntimeError(f"training: initial weights' checksum {init_sum}, yardstick's "
                           f"{ys.INIT_CHECKSUM}")
    tdiff = GaussianDiffusion(schedule)
    trainer = Trainer(tdiff, tmodel, lr=flagship_lmpc.LR, device=dev)
    layout, init = trainer.state.layout, trainer.state.params.clone()
    ys_draws = {k: torch.from_numpy(v).to(dev) for k, v in ys.staged_draws(tds.n_init).items()}
    # step 1 on the card and in float64 on the CPU, on the same batch and draws
    idx0 = ys_draws["idx"][0]
    x1, c1 = tds.inputs_normalized[idx0], tds.condition_normalized[idx0]
    d1 = {k: ys_draws[k][0] for k in ("t", "noise", "mask")}
    loss_gpu, g_gpu = value_and_grad(diffusion_loss(trainer.diffusion, tmodel), layout, init, x1,
                                     c1, d1)
    cpu_model = flagship_lmpc.lmpc_model("cpu").double()
    t1 = time.perf_counter()
    loss_64, g_64 = value_and_grad(
        diffusion_loss(GaussianDiffusion(schedule), cpu_model), layout,
        layout.flatten(dict(cpu_model.named_parameters())), x1.cpu().double(), c1.cpu().double(),
        {k: v.cpu().double() if v.is_floating_point() else v.cpu() for k, v in d1.items()})
    cpu64_s = time.perf_counter() - t1
    g_gpu = g_gpu.cpu().double()
    grad_err = ((g_gpu - g_64).norm() / g_64.norm()).item()
    loss1_err = abs(loss_gpu.item() / loss_64.item() - 1)
    taps = tmodel.padding_taps()  # kernel entries that read only zero padding: gradient exactly 0
    pad = layout.flatten({n: taps[n].cpu() if n in taps else torch.zeros(s, dtype=torch.bool)
                          for n, s in zip(layout.names, layout.shapes)})
    near_zero = (g_64.abs() < 1e-5) & (g_64 != 0)
    sign_flips = int(((torch.sign(g_gpu) != torch.sign(g_64)) & (g_64 != 0)).sum())
    if not (grad_err <= GRAD_REL_TOL and loss1_err <= GRAD_REL_TOL and (g_gpu[pad] == 0).all()
            and (g_64[pad] == 0).all()):
        raise RuntimeError(f"training: step 1 on the card against float64 on the CPU: gradient "
                           f"{grad_err:.3e}, loss {loss1_err:.3e} (tol {GRAD_REL_TOL:.0e}); "
                           f"padding taps exactly 0: {bool((g_gpu[pad] == 0).all())}")
    # the 200 yardstick steps, one chunk, no host sync inside
    chunk200 = make_scanned_train_steps(trainer.train_step, ys.N_STEPS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tstate, ys_losses = chunk200(trainer.state, tds.inputs_normalized, tds.condition_normalized,
                                 ys.BATCH, ys_draws, per_step=True)
    torch.cuda.synchronize()
    ys_s = time.perf_counter() - t1
    ys_losses = ys_losses.cpu().double()
    ys_want = torch.tensor(ys.LOSSES, dtype=torch.float64)
    ys_rel = (ys_losses / ys_want - 1).abs()
    ys_mean_rel = abs(ys_losses[-YS_TAIL:].mean().item() / ys_want[-YS_TAIL:].mean().item() - 1)
    pad_dev = pad.to(dev)
    pad_kept = bool(torch.equal(tstate.params[pad_dev], init[pad_dev]))
    ema_copy = bool(torch.equal(tstate.ema_params, tstate.params))  # a hard copy before step 1,000
    ys_gates = (f"steps 1-{YS_HEAD} max rel {ys_rel[:YS_HEAD].max():.3e} (tol {YS_HEAD_RTOL:.0e}), "
                f"1-{YS_EARLY} {ys_rel[:YS_EARLY].max():.3e} (tol {YS_EARLY_RTOL:.0e}), every step "
                f"{ys_rel.max():.3e} (tol {YS_STEP_RTOL}), mean of the last {YS_TAIL} "
                f"{ys_mean_rel:.3e} (tol {YS_TAIL_RTOL})")
    if not (torch.isfinite(ys_losses).all() and ys_rel[:YS_HEAD].max() <= YS_HEAD_RTOL
            and ys_rel[:YS_EARLY].max() <= YS_EARLY_RTOL and ys_rel.max() <= YS_STEP_RTOL
            and ys_mean_rel <= YS_TAIL_RTOL and pad_kept and ema_copy
            and int(tstate.step) == ys.N_STEPS):
        raise RuntimeError(f"training against the yardstick: {ys_gates}; padding taps kept "
                           f"{pad_kept}; EMA a copy {ema_copy}; losses {ys_losses.tolist()}")
    log("train-vs-jax", t0, f"step 1's collection {collect_s:.3f}s, {tds.n_init} samples, limits "
        f"within {lim_err:.3e} of the yardstick's (rtol {YS_LIMITS_RTOL:.0e}); initial weights' "
        f"checksum equal; step 1 against float64 on the CPU ({cpu64_s:.3f}s): loss "
        f"{loss1_err:.3e}, gradient {grad_err:.3e} (tol {GRAD_REL_TOL:.0e}), {sign_flips} signs "
        f"differ, {int(near_zero.sum())} elements below 1e-5 but not 0, {int(pad.sum())} padding "
        f"taps exactly 0; {ys.N_STEPS} steps in one chunk {ys_s:.3f}s: {ys_gates}; padding taps "
        f"at their init")

    # 25. the trained model through the kernels: the EMA weights (a hard copy before step 1,000)
    # carried through the flax layout into a fresh module, with step 1's statistics
    t0 = time.perf_counter()
    fresh = TemporalUnet(**LMPC_CONFIG, cfg_indicator=True)
    fresh.load_state_dict(from_flax_params(to_flax_params(layout.views(tstate.ema_params))))
    fresh = fresh.to(dev).eval()
    t_ins, t_cond = tds.normalizer.stats["inputs"], tds.normalizer.stats["condition"]
    tchain = make_fused_cfg_chain(fresh, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    tep = make_fused_cfg_episode(tchain.packed, schedule, t_ins, t_cond, cartpole_lmpc(),
                                 cartpole_lmpc_cost(), n_steps=N_LMPC_EP, w=W,
                                 n_diffusion_steps_without_noise=N_TAIL, n_candidates=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    lx0 = lmpc_parity.sweep_states(1)[0].to(dev)
    l_noise = torch.randn((T + N_TAIL + 1, 1, LMPC_H, 1), generator=gen, device=dev)
    l_ep_noise = torch.randn(tep.noise_shape, generator=gen, device=dev)
    t_contexts = [normalize(t_cond.to(dev), lx0)[None]] + [
        torch.randn((1, 4), generator=gen, device=dev) for _ in range(2)]
    reset(tchain, tep)
    tchain_err = max(assert_close(f"trained cfg_chain H={LMPC_H}", tchain.kernel(c_, l_noise),
                                  tchain.plain(c_, l_noise), CHAIN_TOL) for c_ in t_contexts)
    got, want = tep.kernel(lx0, l_ep_noise), tep.plain(lx0, l_ep_noise)
    tep_err = max(assert_close(f"trained cfg_episode_lmpc {name}", g, w_, TRACK_TOL)
                  for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want))
    if counts(tchain, tep) != [(len(t_contexts), len(t_contexts)), (1, 1)]:
        raise RuntimeError(f"trained model through the kernels: counts {counts(tchain, tep)}")
    log("trained-kernels", t0, f"the trained EMA weights (to_flax_params -> from_flax_params): "
        f"cfg_chain at H={LMPC_H} on {len(t_contexts)} contexts max |kernel - plain| "
        f"{tchain_err:.3e} (tol {CHAIN_TOL:.0e}); cfg_episode_lmpc K=1 {N_LMPC_EP} replans from "
        f"the sweep's first state {tep_err:.3e} (tol {TRACK_TOL:.0e}); launches "
        f"{counts(tchain, tep)}")

    # 26. the training rate and checkpoint resume: Trainer.fit chunked at batch 512 for N_FIT
    # steps under cuDNN's deterministic algorithms, with a checkpoint and the generator's state
    # taken after step N_FIT - N_RESUME; its last steps are the uninterrupted run, and a fresh Trainer
    # resumed from the checkpoint, the generator set back, runs them again
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fit_gen = torch.Generator(device=dev).manual_seed(flagship_lmpc.DRAW_SEED)
    fit_logs = []

    def timed_fit(trainer, n_steps):
        """(host seconds, device ms by CUDA events) of ``trainer.fit`` up to step n_steps."""
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev0.record()
        trainer.fit(tds, n_steps, ys.BATCH, fit_gen, chunk_size=FIT_CHUNK,
                    steps_til_summary=FIT_CHUNK, log_fn=fit_logs.append)
        ev1.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t1, ev0.elapsed_time(ev1)

    fit_trainer = Trainer(tdiff, flagship_lmpc.lmpc_model(dev), lr=flagship_lmpc.LR, device=dev)
    ck_path = ROOT / "build" / "chip_smoke_train" / "resume.ckpt"
    s1, d1 = timed_fit(fit_trainer, N_FIT - N_RESUME)
    save_checkpoint(str(ck_path), fit_trainer.state)
    gen_state = fit_gen.get_state()
    s2, d2 = timed_fit(fit_trainer, N_FIT)
    fit_s, fit_ms = s1 + s2, (d1 + d2) / N_FIT
    fit_losses = [v for _, v in fit_trainer.train_losses]
    if int(fit_trainer.state.step) != N_FIT or not all(math.isfinite(v) for v in fit_losses):
        raise RuntimeError(f"Trainer.fit: step {int(fit_trainer.state.step)}, losses {fit_losses}")
    resumed = Trainer(tdiff, flagship_lmpc.lmpc_model(dev), lr=flagship_lmpc.LR, device=dev)
    resumed.resume(str(ck_path))
    shutil.rmtree(ck_path.parent)
    fit_gen.set_state(gen_state)
    resumed.fit(tds, N_FIT, ys.BATCH, fit_gen, chunk_size=FIT_CHUNK,
                steps_til_summary=FIT_CHUNK, log_fn=fit_logs.append)
    torch.backends.cudnn.deterministic = deterministic
    a, b = fit_trainer.state, resumed.state
    resume_dparam = (a.params - b.params).abs().max().item()
    resume_equal = (resumed.train_losses == fit_trainer.train_losses[-1:] and resume_dparam == 0
                    and all(torch.equal(x, y) for x, y in ((a.ema_params, b.ema_params),
                                                           (a.opt_state.mu, b.opt_state.mu),
                                                           (a.opt_state.nu, b.opt_state.nu))))
    if not resume_equal:
        raise RuntimeError(f"resume: the last {N_RESUME} steps' mean loss {resumed.train_losses} "
                           f"against {fit_trainer.train_losses[-1:]}; params {resume_dparam:.3e}")
    log("train-rate", t0, f"Trainer.fit {N_FIT} steps at batch {ys.BATCH} in chunks of "
        f"{FIT_CHUNK} (cudnn.deterministic): {fit_s:.3f}s, {N_FIT / fit_s:.2f} steps/s "
        f"by the host clock, {fit_ms:.4f} ms per step by CUDA events (phase 24's chunk of "
        f"{ys.N_STEPS}: {ys.N_STEPS / ys_s:.2f} steps/s); chunk means {fit_losses}; step 1's "
        f"collection {collect_s:.3f}s; resumed from step {N_FIT - N_RESUME}'s checkpoint, the last "
        f"{N_RESUME} steps equal the uninterrupted run's (mean loss, params, EMA, mu, nu)")
    training_line = {
        "model": "flagship_lmpc", "params": layout.numel, "batch": ys.BATCH,
        "collect_s": collect_s, "n_samples": tds.n_init, "limits_max_rel_err": lim_err,
        "step1": {"loss_rel_err": loss1_err, "grad_rel_err": grad_err, "sign_flips": sign_flips,
                  "near_zero_1e-5": int(near_zero.sum()), "padding_taps": int(pad.sum()),
                  "cpu64_s": cpu64_s},
        "yardstick": {"steps": ys.N_STEPS, "s": ys_s, "head_max_rel": ys_rel[:YS_HEAD].max().item(),
                      "step_max_rel": ys_rel.max().item(), "tail_mean_rel": ys_mean_rel,
                      "early_max_rel": ys_rel[:YS_EARLY].max().item(),
                      "gates": {"head": [YS_HEAD, YS_HEAD_RTOL], "early": [YS_EARLY, YS_EARLY_RTOL],
                                "step": YS_STEP_RTOL, "tail": [YS_TAIL, YS_TAIL_RTOL]},
                      "losses": ys_losses.tolist(), "padding_taps_kept": pad_kept},
        "trained_kernels": {"cfg_chain_h8_max_abs_err": tchain_err,
                            "cfg_episode_lmpc_max_abs_err": tep_err,
                            "launches": counts(tchain, tep)},
        "fit": {"steps": N_FIT, "s": fit_s, "steps_per_s": N_FIT / fit_s, "ms_per_step": fit_ms,
                "chunk_mean_losses": fit_losses, "cudnn_deterministic": True,
                "yardstick_chunk_steps_per_s": ys.N_STEPS / ys_s},
        "resume": {"steps": N_RESUME, "losses_equal": resume_equal,
                   "params_max_abs_diff": resume_dparam},
        "nvidia_smi": nvidia_smi()}

    return training_line


def distill_phases(dev) -> dict:
    """Phases 29-31 on ``dev``: distillation against the JAX package, its students and teacher
    through the kernels at horizon 64, and the AMPC loop. Returns the ``distill`` line, whose
    ``h64`` entries hold each kernel's row at horizon 64."""
    dev = resolve_device(dev)  # TF32 off
    schedule = make_schedule("exponential", dys.T)
    ins, cond = (st.to(dev) for st in teacher_stats())
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_collect_cost()
    x0 = torch.tensor(dys.X0, device=dev)
    # 29. distill steps against the JAX package (data/distill_yardstick.py (a)): step 1's loss
    # and gradient against float64 on the card, then the 60 staged steps of rounds 0 and 1
    t0 = time.perf_counter()
    model = distill_divergence.teacher_model(dev)
    layout = ParamLayout.of(model)
    grid = ddim_time_grid(dys.T, t_start=dys.T_START)
    x_all, c_all = (torch.from_numpy(a).to(dev) for a in dys.synthetic_data())
    d0 = {k: torch.from_numpy(v[0]).to(dev) for k, v in dys.staged_draws().items()}
    step1 = {}
    for dt in (torch.float32, torch.float64):
        m = model if dt == torch.float32 else distill_divergence.teacher_model(dev).double()
        teacher = {n: p.detach() for n, p in m.named_parameters()}
        loss_fn = distill_loss(schedule, m, teacher, grid, w=dys.W, teacher_cfg=True)
        step1[dt] = value_and_grad(loss_fn, layout, layout.flatten(teacher),
                                   x_all[d0["idx"]].to(dt), c_all[d0["idx"]].to(dt),
                                   {"j": d0["j"], "noise": d0["noise"].to(dt)})
    (l32, g32), (l64, g64) = step1[torch.float32], step1[torch.float64]
    grad_err = ((g32.double() - g64).norm() / g64.norm()).item()
    loss1_err = abs(l32.item() / l64.item() - 1)
    if not (grad_err <= dys.GRAD_BOUND and loss1_err <= dys.LOSS1_BOUND):
        raise RuntimeError(f"distill step 1 against float64 on the card: gradient {grad_err:.3e} "
                           f"(bound {dys.GRAD_BOUND:.1e}), loss {loss1_err:.3e} (bound "
                           f"{dys.LOSS1_BOUND:.1e})")
    n_steps = dys.ROUND0_STEPS + dys.ROUND1_STEPS
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev0.record()
    run = distill_divergence.distill_steps(model, dev)
    ev1.record()
    torch.cuda.synchronize()
    steps_s, steps_dev_ms = time.perf_counter() - t1, ev0.elapsed_time(ev1)
    rel = np.abs(run["losses"] / np.asarray(dys.LOSSES) - 1)
    sum_gaps = distill_divergence.checksum_gaps(run["sums"], dys.CHECKSUMS)
    (n_head, b_head), (n_early, b_early) = dys.LOSS_BOUNDS["head"], dys.LOSS_BOUNDS["early"]
    gates = (f"steps 1-{n_head} max rel {rel[:n_head].max():.3e} (bound {b_head:.1e}), "
             f"1-{n_early} {rel[:n_early].max():.3e} (bound {b_early:.1e}), every step "
             f"{rel.max():.3e} (bound {dys.LOSS_BOUNDS['step']:.1e}); checksums "
             f"{max(sum_gaps.values()):.3e} (bound {dys.CHECKSUM_BOUND:.1e})")
    if not (np.isfinite(run["losses"]).all() and rel[:n_head].max() <= b_head
            and rel[:n_early].max() <= b_early and rel.max() <= dys.LOSS_BOUNDS["step"]
            and max(sum_gaps.values()) <= dys.CHECKSUM_BOUND and not run["skipped"].any()
            and len(run["losses"]) == n_steps):
        raise RuntimeError(f"distill steps against the yardstick: {gates}; update skipped "
                           f"{run['skipped'].tolist()}; losses {run['losses'].tolist()}")
    log("distill-steps", t0, f"step 1 against float64 on the card: loss {loss1_err:.3e}, "
        f"gradient {grad_err:.3e} (bounds {dys.LOSS1_BOUND:.1e}, {dys.GRAD_BOUND:.1e}); "
        f"{dys.ROUND0_STEPS} steps of round 0 (CFG teacher, 12 pairs) and {dys.ROUND1_STEPS} of "
        f"round 1 at batch {dys.BATCH}, H={dys.HORIZON}: {steps_s:.3f}s, "
        f"{1e3 * steps_s / n_steps:.2f} ms per step by the host clock, "
        f"{steps_dev_ms / n_steps:.2f} by CUDA events; against the yardstick {gates}; no update "
        f"skipped")

    # 30. the first launches at horizon 64: round 0's EMA student (12 evals) through the DDIM
    # chain and episode kernels, and the teacher through the CFG episode kernel
    t0 = time.perf_counter()
    student = TemporalUnet(**TEACHER_CONFIG, cfg_indicator=True)
    student.load_state_dict(layout.views(run["emas"][0]))
    student = student.to(dev).eval()
    grid12 = halve_times(grid)
    u_unit = 0.5 * (ins.maxs - ins.mins)
    gen = torch.Generator(device=dev).manual_seed(30)
    ctx0 = normalize(cond, x0)[None]
    chains = {b: make_fused_ddim_chain(student, schedule, grid12, n_samples=b, device=dev)
              for b in (1, B_DISTILL_CHAIN)}
    spacked = chains[1].packed
    sep = make_fused_ddim_episode(spacked, schedule, grid12, ins, cond, plant, cost,
                                  n_steps=N_DISTILL_EP, device=dev)
    tep = make_fused_cfg_episode(distill_divergence.teacher_model(dev).eval(), schedule, ins, cond,
                                 plant, cost, n_steps=N_TEACHER_EP, w=dys.W,
                                 n_diffusion_steps_without_noise=N_TAIL, device=dev)
    wrappers = [*chains.values(), sep, tep]
    reset(*wrappers)
    chain_err, chain_inputs = 0.0, {}
    for b, ch in chains.items():
        ctxs = [ctx0.expand(b, 5).contiguous(), torch.rand((b, 5), generator=gen, device=dev) * 2 - 1]
        for ctx in ctxs:
            x_init = torch.randn(ch.noise_shape, generator=gen, device=dev)
            got, want = ch.kernel(ctx, x_init), ch.plain(ctx, x_init)
            torch.cuda.synchronize()
            chain_err = max(chain_err, assert_close(f"ddim_chain H={dys.HORIZON} {len(grid12)} "
                                                    f"evals B={b}", got, want, CHAIN_TOL))
        chain_inputs[b] = (ctxs[0], x_init)
    s_noise = torch.randn(sep.noise_shape, generator=gen, device=dev)
    got = sep.kernel(x0, s_noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop = make_closed_loop(GaussianDiffusion(schedule), student, ins, cond, plant, cost,
                            horizon=dys.HORIZON, n_steps=N_DISTILL_EP,
                            sample_override=chains[1].plain, noise_shape=chains[1].noise_shape,
                            device=dev)(x0, s_noise)
    torch.cuda.synchronize()
    sep_plain_ms = 1e3 * (time.perf_counter() - t1)  # the plain loop: the episode's plain work
    sep_err = max(student_close(f"ddim_episode H={dys.HORIZON} vs the plain loop {name}", g,
                                getattr(loop, name), u_unit)
                  for name, g in zip(("x_track", "u_track", "stage_costs"), got))
    t_noise = torch.randn(tep.noise_shape, generator=gen, device=dev)
    got_t = tep.kernel(x0, t_noise)
    t1 = time.perf_counter()
    want_t = tep.plain(x0, t_noise)
    torch.cuda.synchronize()
    tep_plain_s = time.perf_counter() - t1
    tep_err = max(student_close(f"cfg_episode H={dys.HORIZON} teacher {name}", g, w_, u_unit)
                  for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got_t, want_t))
    launches = counts(*wrappers)
    # the B = 1 chain's plain version is also the plain loop's sampler
    want_counts = [(2, 2 + N_DISTILL_EP), (2, 2), (1, 0), (1, 1)]
    if launches != want_counts:
        raise RuntimeError(f"horizon-64 kernels: counts {launches}, expected {want_counts}")
    ch1_ms = cuda_ms(lambda: chains[1].kernel(*chain_inputs[1]), n=20, warmup=3)
    ch3_ms = cuda_ms(lambda: chains[B_DISTILL_CHAIN].kernel(*chain_inputs[B_DISTILL_CHAIN]), n=20,
                     warmup=3)
    ch1_plain_ms = cuda_ms(lambda: chains[1].plain(*chain_inputs[1]), n=5, warmup=1)
    sep_ms = cuda_ms(lambda: sep.kernel(x0, s_noise), n=5, warmup=1)
    tep_ms = cuda_ms(lambda: tep.kernel(x0, t_noise), n=3, warmup=1)
    log("distill-student-kernels", t0, f"H={dys.HORIZON}, round 0's EMA student on its "
        f"{len(grid12)}-eval grid: ddim_chain at B=1 and {B_DISTILL_CHAIN} max |kernel - plain| "
        f"{chain_err:.3e} (tol {CHAIN_TOL:.0e}), {ch1_ms:.4f} ms per replan at B=1, {ch3_ms:.4f} "
        f"at B={B_DISTILL_CHAIN} (plain {ch1_plain_ms:.3f}); ddim_episode K=1 over "
        f"{N_DISTILL_EP} replans against the plain loop {sep_err:.3e} (controls "
        f"{CHAIN_TOL:.0e} in normalized units, the rest {TRACK_TOL:.0e}), "
        f"{sep_ms / N_DISTILL_EP:.4f} ms per replan (the plain loop {sep_plain_ms / N_DISTILL_EP:.3f} "
        f"by the host clock); "
        f"the teacher through cfg_episode K=1 over {N_TEACHER_EP} replans {tep_err:.3e}, "
        f"{tep_ms / N_TEACHER_EP:.4f} ms per replan (plain {1e3 * tep_plain_s / N_TEACHER_EP:.2f} "
        f"by the host clock); launches {launches}")

    # 31. the AMPC loop against the JAX package (data/distill_yardstick.py (c))
    t0 = time.perf_counter()
    ampc = AMPCNet(dys.HORIZON)
    ampc.load_state_dict(mlp_from_flax_params(dys.ampc_params(), ampc))
    ampc_run = make_ampc_closed_loop(ampc.to(dev).eval(), ins, cond, plant, cost,
                                     n_steps=dys.N_EXPERT_STEPS, device=dev)(x0)
    torch.cuda.synchronize()
    ampc_u = ampc_run.u_track[:, 0].double().cpu()
    ampc_gaps = {"cost_rel": abs(math.fsum(ampc_run.stage_costs.double().tolist()) / dys.AMPC_COST
                                 - 1),
                 "u_max": (ampc_u - torch.tensor(dys.AMPC_U_TRACK, dtype=torch.float64)).abs().max().item()}
    if not all(ampc_gaps[k] <= b for k, b in dys.AMPC_BOUNDS.items()):
        raise RuntimeError(f"AMPC loop against the JAX package's: {ampc_gaps} (bounds "
                           f"{dys.AMPC_BOUNDS})")
    log("ampc-loop", t0, f"make_ampc_closed_loop, AMPCNet(horizon={dys.HORIZON}) on the "
        f"yardstick's weights, {dys.N_EXPERT_STEPS} steps from x0: against the JAX package's "
        f"cost rel {ampc_gaps['cost_rel']:.3e}, u {ampc_gaps['u_max']:.3e} (bounds "
        f"{dys.AMPC_BOUNDS})")

    # each kernel's row at horizon 64, the keys of the kernels line
    weights, meta_n = spacked.weights.numel(), spacked.metas[1].numel()
    film_w = sum(math.prod(shape) for name, (_, shape) in spacked.segments.items()
                 if name.split(".")[0] == "films")
    film_flops = 2 * 2 * int(spacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in student.res_blocks())
    ch = chains[1]
    ch_flops = spacked.flops_per_pass * ch.n_total
    ch_bytes = 4 * (weights - film_w + meta_n + ch.films(chain_inputs[1][0]).numel()
                    + chain_inputs[1][1].numel() + ch.coefs.numel() + dys.HORIZON)
    tail = 5 + (N_DISTILL_EP + 1) * 5 + N_DISTILL_EP * 3
    sep_flops = N_DISTILL_EP * sep.n_total * (spacked.flops_per_pass + film_flops / 2)
    sep_bytes = 4 * (weights + meta_n + sep.t_embs.numel() + s_noise.numel() + sep.coefs.numel()
                     + sep.consts.numel() + tail)
    tpacked = tep.packed
    tep_flops = N_TEACHER_EP * tep.n_total * (2 * tpacked.flops_per_pass + film_flops)
    tep_bytes = 4 * (tpacked.weights.numel() + tpacked.metas[1].numel() + tep.t_embs.numel()
                     + t_noise.numel() + tep.coefs.numel() + tep.consts.numel() + 5
                     + (N_TEACHER_EP + 1) * 5 + N_TEACHER_EP * 3)
    h64 = {
        "ddim_chain": {"launches": launches[0][0] + launches[1][0], "max_abs_err": chain_err,
                       "ms": ch1_ms, "plain_ms": ch1_plain_ms, **bound(ch_flops, ch_bytes),
                       "library_ms": None, "times": grid12, f"b{B_DISTILL_CHAIN}_ms": ch3_ms},
        "ddim_episode": {"launches": launches[2][0], "max_abs_err": sep_err, "ms": sep_ms,
                         "plain_ms": sep_plain_ms, **bound(sep_flops, sep_bytes),
                         "library_ms": None, "times": grid12, "replans": N_DISTILL_EP,
                         "ms_per_replan": sep_ms / N_DISTILL_EP},
        "cfg_episode": {"launches": launches[3][0], "max_abs_err": tep_err, "ms": tep_ms,
                        "plain_ms": 1e3 * tep_plain_s, **bound(tep_flops, tep_bytes),
                        "library_ms": None, "replans": N_TEACHER_EP,
                        "ms_per_replan": tep_ms / N_TEACHER_EP}}
    for row in h64.values():
        row.update(model="flagship_modality", horizon=dys.HORIZON)
    return {"steps": {"n": n_steps, "s": steps_s, "ms_per_step": 1e3 * steps_s / n_steps,
                      "device_ms_per_step": steps_dev_ms / n_steps, "batch": dys.BATCH,
                      "loss_max_rel": {"head": float(rel[:n_head].max()),
                                       "early": float(rel[:n_early].max()),
                                       "step": float(rel.max())},
                      "checksum_max_rel": max(sum_gaps.values()), "bounds": dys.LOSS_BOUNDS,
                      "checksum_bound": dys.CHECKSUM_BOUND, "losses": run["losses"].tolist()},
            "step1": {"grad_rel_err": grad_err, "loss_rel_err": loss1_err,
                      "bounds": [dys.GRAD_BOUND, dys.LOSS1_BOUND]},
            "ampc": {**ampc_gaps, "bounds": dys.AMPC_BOUNDS},
            "h64": h64, "nvidia_smi": nvidia_smi()}


def episode_gate(name: str, ep, got, want, u_unit: torch.Tensor, ties: list) -> float:
    """A DDIM episode kernel's run against its plain version's: the tracks
    (``student_close``), the reported costs equal to the task quadratic on
    the tracks, and the chosen candidates equal wherever the plain version's
    best two scores are more than NEAR_TIE apart (each near-tie appended to
    ``ties``). Returns the max |kernel - plain|."""
    err = max(student_close(f"{name} {n}", g, w_, u_unit)
              for n, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want))
    cost = ep.cost.stage(got[0][:-1], got[1])
    err = max(err, assert_close(f"{name} stage costs vs the task quadratic", got[2], cost,
                                TRACK_TOL))
    for i in range(ep.n_steps):
        if ep.n_candidates > 1 and near_tie(ep.plain_scores[i]):
            best2 = torch.sort(ep.plain_scores[i].double()).values[:2].tolist()
            ties.append(f"{name} replan {i}: best two plain scores {best2[0]:.9g}, "
                        f"{best2[1]:.9g}; kernel chose {int(got[3][i])}, plain {int(want[3][i])}")
        elif got[3][i] != want[3][i]:
            raise RuntimeError(f"{name}: replan {i} chosen {got[3].tolist()} vs plain "
                               f"{want[3].tolist()}")
    return err


def normal_moments(z: torch.Tensor) -> dict:
    """The gaps of a sample's moments and quantiles from N(0, 1)'s, under NORMAL_TOLS' keys."""
    z = z.double().flatten()
    a = z.abs()
    return {"mean": abs(z.mean().item()), "std": abs(z.std().item() - 1.0),
            "q95": abs((a < 1.96).double().mean().item() - 0.95),
            "q99": abs((a < 2.58).double().mean().item() - 0.99),
            "m3": abs((z ** 3).mean().item()), "m4": abs((z ** 4).mean().item() - 3.0)}


def quadrotor_phases(dev) -> dict:
    """Phases 32-34 on ``dev``: the quadrotor student's serving path (the DDIM chain at H = 48,
    the quadrotor episode entry with staged noise and with the in-kernel draw, best-of-K by the
    safety-first scorer) against the plain versions, the draw's known answers and moments, and
    the task metrics over 16 starts. Returns each kernel's row of the kernels line: ``h48``
    under the DDIM chain and episode, ``ddim_episode_quadrotor`` and its ``inkernel_noise``."""
    dev = resolve_device(dev)
    schedule = make_schedule("exponential", T)
    plant, qcost = quadrotor(), quadrotor_cost()
    sel = make_select_cost(qcost)
    ins, cond = (st.to(dev) for st in quadrotor_stats())
    u_unit = 0.5 * (ins.maxs - ins.mins)
    starts = torch.from_numpy(eval_start_states(64)).to(dev)
    x0 = starts[0]
    gen = torch.Generator(device=dev).manual_seed(32)
    # 32. the DDIM chain at H = 48 and the quadrotor episode entry against their plain versions,
    # and the main path: the per-replan loop through the chain, the episode at K = 1 and at
    # K = 4 with the safety-first scorer
    t0 = time.perf_counter()
    student = load_quadrotor_student(QUADROTOR_STUDENT, device=dev)
    chain = make_fused_ddim_chain(student, schedule, GRID, n_samples=1, device=dev)
    qpacked = chain.packed
    chains = {(tuple(times), b): chain if (times, b) == (GRID, 1) else
              make_fused_ddim_chain(qpacked, schedule, times, n_samples=b, device=dev)
              for times in (GRID, GRID3) for b in (1, K4)}
    ctx0 = normalize(cond, x0)[None]
    chain_err, chain_inputs = 0.0, {}
    for (times, b), ch in chains.items():
        for ctx in (ctx0.expand(b, 12).contiguous(),
                    torch.rand((b, 12), generator=gen, device=dev) * 2 - 1):
            x_init = torch.randn(ch.noise_shape, generator=gen, device=dev)
            got, want = ch.kernel(ctx, x_init), ch.plain(ctx, x_init)
            torch.cuda.synchronize()
            chain_err = max(chain_err, assert_close(f"ddim_chain H=48 {list(times)} B={b}", got,
                                                    want, CHAIN_TOL))
            chain_inputs[times, b] = (ctx, x_init)
    qep = lambda times, k, n_steps, **kw: make_fused_ddim_episode(
        qpacked, schedule, times, ins, cond, plant, qcost, n_steps=n_steps, n_candidates=k,
        selection_cost=sel if k > 1 else None, device=dev, **kw)
    ep1, ep4 = qep(GRID, 1, N_Q_EP), qep(GRID, K4, N_Q_EP4)
    loop = lambda sampler: make_closed_loop(
        GaussianDiffusion(schedule), student, ins, cond, plant, qcost, horizon=48,
        n_steps=N_Q_EP, sample_override=sampler, noise_shape=chain.noise_shape, device=dev)
    nz1 = torch.randn(ep1.noise_shape, generator=gen, device=dev)
    nz4 = torch.randn(ep4.noise_shape, generator=gen, device=dev)
    wrappers = [*chains.values(), ep1, ep4]
    reset(*wrappers)
    res = loop(chain)(x0, nz1)
    got1, got4 = ep1.kernel(x0, nz1), ep4.kernel(x0, nz4)
    torch.cuda.synchronize()
    launches = counts(*wrappers)
    want_counts = [(N_Q_EP, 0)] + [(0, 0)] * 3 + [(1, 0), (1, 0)]
    if launches != want_counts:
        raise RuntimeError(f"quadrotor serving path: counts {launches}, expected {want_counts}")
    ref = loop(chain.plain)(x0, nz1)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        student_close(f"quadrotor chain loop {name}", getattr(res, name), getattr(ref, name), u_unit)
    ties = []
    t1 = time.perf_counter()
    want1 = ep1.plain(x0, nz1)
    torch.cuda.synchronize()
    ep1_plain_ms = 1e3 * (time.perf_counter() - t1)
    ep_err = episode_gate("ddim_episode_quadrotor K=1", ep1, got1, want1, u_unit, ties)
    vs_loop = max(student_close(f"quadrotor episode vs the chain loop {name}", g,
                                getattr(res, name), u_unit)
                  for name, g in zip(("x_track", "u_track", "stage_costs"), got1))
    ep_err = max(ep_err, episode_gate(f"ddim_episode_quadrotor K={K4}", ep4, got4,
                                      ep4.plain(x0, nz4), u_unit, ties))
    chosen4 = got4[3].tolist()
    for k, n_steps in ((1, N_Q_EP4), (K4, N_Q_EP4 // 2)):  # the 3-step grid
        ep = qep(GRID3, k, n_steps)
        nz = torch.randn(ep.noise_shape, generator=gen, device=dev)
        ep_err = max(ep_err, episode_gate(f"ddim_episode_quadrotor {GRID3} K={k}", ep,
                                          ep.kernel(x0, nz), ep.plain(x0, nz), u_unit, ties))
    ch_ms = cuda_ms(lambda: chain.kernel(*chain_inputs[tuple(GRID), 1]), n=20, warmup=3)
    ch4_ms = cuda_ms(lambda: chains[tuple(GRID), K4].kernel(*chain_inputs[tuple(GRID), K4]), n=20,
                     warmup=3)
    ch3_ms = cuda_ms(lambda: chains[tuple(GRID3), 1].kernel(*chain_inputs[tuple(GRID3), 1]), n=20,
                     warmup=3)
    ch_plain_ms = cuda_ms(lambda: chain.plain(*chain_inputs[tuple(GRID), 1]), n=5, warmup=1)
    ep1_ms = cuda_ms(lambda: ep1.kernel(x0, nz1), n=5, warmup=1)
    ep4_ms = cuda_ms(lambda: ep4.kernel(x0, nz4), n=5, warmup=1)
    log("quadrotor-kernels", t0, f"H=48, context 12: ddim_chain max |kernel - plain| "
        f"{chain_err:.3e} over 2 contexts x B in (1, {K4}) x grids {GRID} and {GRID3} (tol "
        f"{CHAIN_TOL:.0e}), {ch_ms:.4f} ms per replan at B=1, {ch4_ms:.4f} at B={K4}, "
        f"{ch3_ms:.4f} on {GRID3} (plain {ch_plain_ms:.3f}); the per-replan loop through it "
        f"{N_Q_EP} replans; ddim_episode_quadrotor K=1 {N_Q_EP} replans and K={K4} (safety-first "
        f"scorer) {N_Q_EP4}, and on {GRID3}: max |kernel - plain| {ep_err:.3e}, K=1 against the "
        f"chain loop {vs_loop:.3e} (controls {CHAIN_TOL:.0e} in normalized units, the rest "
        f"{TRACK_TOL:.0e}); stage costs the task quadratic on the tracks; K={K4} chosen "
        f"{chosen4}; {ep1_ms / N_Q_EP:.4f} ms per replan at K=1, {ep4_ms / N_Q_EP4:.4f} at "
        f"K={K4} (plain {ep1_plain_ms / N_Q_EP:.3f} by the host clock); launches {launches}; "
        f"near-ties (not gated): {len(ties)}: " + " | ".join(ties))

    # 33. the in-kernel draw: Philox's known answers, 2^20 normals against N(0, 1) and against
    # the twin's table, the episode with the draw against the plain episode on that table
    t0 = time.perf_counter()
    kat_c = torch.tensor([[0, 0, 0, 0], [0xFFFFFFFF] * 4,
                          [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]], device=dev)
    kat_k = torch.tensor([[0, 0], [0xFFFFFFFF] * 2, [0xA4093822, 0x299F31D0]], device=dev)
    kat = [[0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8],
           [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD],
           [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]]
    if philox.words(kat_c, kat_k).tolist() != kat:
        raise RuntimeError(f"Philox4x32-10 known answers: {philox.words(kat_c, kat_k).tolist()}")
    seed = philox.seed_from_generator(torch.Generator().manual_seed(33)).to(dev)
    shape = (1024, 16, 16, 4)  # 2^20 normals
    z = philox.table(seed, shape)
    z_twin = philox.normal_table(seed, shape)
    torch.cuda.synchronize()
    z_err = assert_close("in-kernel normals vs the twin", z, z_twin, 1e-5)
    gaps = normal_moments(z)
    if not all(gaps[k] < tol for k, tol in NORMAL_TOLS.items()):
        raise RuntimeError(f"in-kernel normals: gaps {gaps} (tolerances {NORMAL_TOLS})")
    dep = {k: qep(GRID, k, n, inkernel_noise=True) for k, n in ((1, N_Q_EP), (K8, N_Q_EP4))}
    reset(*dep.values())
    seeds = [philox.seed_from_generator(torch.Generator().manual_seed(330 + i)).to(dev)
             for i in range(2)]
    got_d = {k: ep.kernel(x0, seeds[0]) for k, ep in dep.items()}
    again = dep[1].kernel(x0, seeds[0])
    other = dep[1].kernel(x0, seeds[1])
    torch.cuda.synchronize()
    d_launches = counts(*dep.values())
    if d_launches != [(3, 0), (1, 0)]:
        raise RuntimeError(f"in-kernel draw: counts {d_launches}, expected [(3, 0), (1, 0)]")
    if not all(torch.equal(a, b) for a, b in zip(again, got_d[1])):
        raise RuntimeError("in-kernel draw: one seed twice gave different tracks")
    if torch.equal(other[0], got_d[1][0]):
        raise RuntimeError("in-kernel draw: two seeds gave the same track")
    d_err, d_ties = 0.0, []
    for k, ep in dep.items():
        t1 = time.perf_counter()
        want = ep.plain(x0, seeds[0])
        torch.cuda.synchronize()
        if k == 1:
            d1_plain_ms = 1e3 * (time.perf_counter() - t1)
        d_err = max(d_err, episode_gate(f"ddim_episode_quadrotor_draw K={k}", ep, got_d[k],
                                        want, u_unit, d_ties))
    d1_ms = cuda_ms(lambda: dep[1].kernel(x0, seeds[0]), n=5, warmup=1)
    d8_ms = cuda_ms(lambda: dep[K8].kernel(x0, seeds[0]), n=5, warmup=1)
    log("inkernel-noise", t0, f"Philox4x32-10's three known answers; 2^20 in-kernel normals "
        f"against the twin's table {z_err:.3e} (tol 1e-5), against N(0, 1) {gaps} (tolerances "
        f"{NORMAL_TOLS}); ddim_episode_quadrotor_draw K=1 {N_Q_EP} replans and K={K8} "
        f"{N_Q_EP4} against the plain episode on the twin's table: max |kernel - plain| "
        f"{d_err:.3e}; one seed twice equal, two seeds apart; {d1_ms / N_Q_EP:.4f} ms per replan "
        f"at K=1, {d8_ms / N_Q_EP4:.4f} at K={K8}; near-ties (not gated): {len(d_ties)}: "
        + " | ".join(d_ties))

    # 34. quality on 16 of the 64 eval starts, 60 replans, K = 1 staged and K = 8 with the draw;
    # the sustained rate of one 600-replan episode per launch at K = 1 and K = 8
    t0 = time.perf_counter()
    q1 = qep(GRID, 1, N_Q_STEPS)
    q8 = qep(GRID, K8, N_Q_STEPS, inkernel_noise=True)
    tracks = {1: [], K8: []}
    for i in range(N_Q_STARTS):
        g = torch.Generator(device=dev).manual_seed(340 + i)
        tracks[1].append(q1(starts[i], torch.randn(q1.noise_shape, generator=g, device=dev))[0])
        tracks[K8].append(q8(starts[i], philox.seed_from_generator(
            torch.Generator().manual_seed(340 + i)).to(dev))[0])
    metrics = {k: quadrotor_task.track_metrics(torch.stack(v).cpu().numpy())
               for k, v in tracks.items()}
    if any("diverged_fraction" in m for m in metrics.values()):
        raise RuntimeError(f"quadrotor quality: diverged tracks {metrics}")
    rates = {}
    for k, draw in ((1, False), (1, True), (K8, True)):
        ep = qep(GRID, k, N_Q_RATE, inkernel_noise=draw)
        arg = seeds[0] if draw else torch.randn(ep.noise_shape, generator=gen, device=dev)
        ep(x0, arg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x_tr = ep(x0, arg)[0]
        torch.cuda.synchronize()
        rates[f"k{k}_{'inkernel' if draw else 'staged'}_hz"] = N_Q_RATE / (time.perf_counter() - t1)
        if not torch.isfinite(x_tr).all():
            raise RuntimeError(f"quadrotor {N_Q_RATE}-replan episode K={k}: non-finite track")
    q1_ms = cuda_ms(lambda: q1.kernel(starts[0], torch.randn(q1.noise_shape, device=dev)), n=3,
                    warmup=1)
    log("quadrotor-quality", t0, f"{N_Q_STARTS} eval starts x {N_Q_STEPS} replans: K=1 staged "
        f"{metrics[1]}; K={K8} in-kernel draw, safety-first scorer {metrics[K8]}; "
        f"{q1_ms / N_Q_STEPS:.4f} ms per replan at K=1; one {N_Q_RATE}-replan episode per launch: "
        f"{ {k: round(v, 1) for k, v in rates.items()} } replans/s")

    # each row of the kernels line; bytes and operations of this run's inputs
    weights, meta_n = qpacked.weights.numel(), qpacked.metas[1].numel()
    film_w = sum(math.prod(shape_) for name, (_, shape_) in qpacked.segments.items()
                 if name.split(".")[0] == "films")
    film_flops = 2 * 2 * int(qpacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in student.res_blocks())
    ch_flops = qpacked.flops_per_pass * chain.n_total
    ch_bytes = 4 * (weights - film_w + meta_n + chain.films(ctx0).numel()
                    + chain_inputs[tuple(GRID), 1][1].numel() + chain.coefs.numel() + 48 * 4)

    def row_ep(ep, launches_, ms, plain_ms, err, n_noise, **extra):
        """An episode's row: the main path's launches, its times, and its bound at K = 1 (the
        scorer runs only at K > 1)."""
        flops = ep.n_steps * ep.n_total * (qpacked.flops_per_pass + film_flops / 2)
        n_bytes = 4 * (weights + meta_n + ep.t_embs.numel() + n_noise + ep.coefs.numel()
                       + ep.consts.numel() + 12 + (ep.n_steps + 1) * 12 + ep.n_steps * 6)
        return {"launches": launches_, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **bound(flops, n_bytes), "library_ms": None, "times": GRID,
                "replans": ep.n_steps, "ms_per_replan": ms / ep.n_steps, **extra}

    # at K > 1 candidates run in turn and each scoring step adds Q_STEP_FLOPS per candidate
    k_bound = lambda ep: bound(
        ep.n_steps * ep.n_candidates * (ep.n_total * (qpacked.flops_per_pass + film_flops / 2)
                                        + 48 * Q_STEP_FLOPS),
        4 * (weights + meta_n + ep.n_steps * ep.n_candidates * 48 * 4))["bound_ms"]
    h48 = {"ddim_chain": {"launches": launches[0][0], "max_abs_err": chain_err, "ms": ch_ms,
                          "plain_ms": ch_plain_ms, **bound(ch_flops, ch_bytes),
                          "library_ms": None, "times": GRID, "b4_ms": ch4_ms,
                          "grid3_ms": ch3_ms},
           "ddim_episode": {"entry": "ddim_episode_quadrotor",
                            **row_ep(ep1, launches[4][0], ep1_ms, ep1_plain_ms, ep_err,
                                     nz1.numel())}}
    quad_row = {
        "name": "ddim_episode_quadrotor", "route": "cuda",
        "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_episode_quadrotor.cu",
        "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
        "entry_of": "ddim_episode", "plant": "quadrotor", "scorer": "safety_first",
        **row_ep(ep1, launches[4][0] + launches[5][0], ep1_ms, ep1_plain_ms, ep_err,
                 nz1.numel(), k4_ms_per_replan=ep4_ms / N_Q_EP4, k4_bound_ms=k_bound(ep4),
                 rates=rates, metrics16=metrics),
        "inkernel_noise": {
            "name": "ddim_episode_quadrotor_draw", "route": "cuda",
            "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/philox.cuh",
            "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:82",
            **row_ep(dep[1], d_launches[0][0] + d_launches[1][0], d1_ms, d1_plain_ms, d_err, 2,
                     k8_ms_per_replan=d8_ms / N_Q_EP4, k8_bound_ms=k_bound(dep[K8]),
                     normals_vs_twin=z_err, normal_gaps=gaps)}}
    for row in (*h48.values(), quad_row):
        row.update(model="onpolicy_quadrotor", horizon=48)
    return {"h48": h48, "row": quad_row}


def scene_phases(dev) -> dict:
    """Phases 35-37 on ``dev``: the scene-conditioned quadrotor student's serving path (the CFG
    episode's quadrotor entry with the context map and the scene's safety-first scorer, the CFG
    chain at H = 48 and context 24, the per-replan loop) against the plain versions, two scenes
    through one build, and the bench's K = 1 row within the yardstick's bounds. Returns the
    kernels line's ``cfg_episode_quadrotor`` row and the CFG chain's ``h48`` entry."""
    dev = resolve_device(dev)
    bss = bench_scene_student
    schedule = make_schedule("exponential", T)
    ins, _ = scene_stats()
    u_unit = (0.5 * (ins.maxs - ins.mins)).to(dev)
    starts = torch.from_numpy(sys_.eval_starts()).to(dev)
    x0 = starts[0]
    gen = torch.Generator(device=dev).manual_seed(35)
    # 35. cfg_episode_quadrotor against its plain version, K = 1 and K = 16, and a second scene
    # through the same build
    t0 = time.perf_counter()
    model = load_scene_student(sys_.STUDENT, device=dev)
    spacked = pack_unet(model, dev)
    sc0, sc1 = bss.scene(0, dev), bss.scene(1, dev)
    ep1 = bss.episode(spacked, sc0, 1, N_S_EP, dev)
    ep16 = bss.episode(spacked, sc0, 16, N_S_EP16, dev)
    ep16b = bss.episode(spacked, sc1, 16, N_S_EP16, dev)
    nz1 = torch.randn(ep1.noise_shape, generator=gen, device=dev)
    nz16 = torch.randn(ep16.noise_shape, generator=gen, device=dev)
    reset(ep1, ep16, ep16b)
    got1, got16, got16b = ep1.kernel(x0, nz1), ep16.kernel(x0, nz16), ep16b.kernel(x0, nz16)
    torch.cuda.synchronize()
    e_launches = counts(ep1, ep16, ep16b)
    if e_launches != [(1, 0)] * 3:
        raise RuntimeError(f"cfg_episode_quadrotor: counts {e_launches}, expected [(1, 0)] * 3")
    ties = []
    t1 = time.perf_counter()
    want1 = ep1.plain(x0, nz1)
    torch.cuda.synchronize()
    ep1_plain_ms = 1e3 * (time.perf_counter() - t1)
    ep_err = episode_gate("cfg_episode_quadrotor K=1", ep1, got1, want1, u_unit, ties)
    t1 = time.perf_counter()
    want16 = ep16.plain(x0, nz16)
    torch.cuda.synchronize()
    ep16_plain_ms = 1e3 * (time.perf_counter() - t1)
    ep_err = max(ep_err, episode_gate("cfg_episode_quadrotor K=16 scene 0", ep16, got16, want16,
                                      u_unit, ties))
    ep_err = max(ep_err, episode_gate("cfg_episode_quadrotor K=16 scene 1", ep16b, got16b,
                                      ep16b.plain(x0, nz16), u_unit, ties))
    # the scene is data: one library, tables that differ only in the features and the spheres
    if ep16b.lib() is not ep16.lib():
        raise RuntimeError("cfg_episode_quadrotor: the second scene loaded another library")
    c_len = ep16.consts.numel()
    # episode.cuh's C_CD, the 12 features, then the scorer's 18 constants, whose last 12 are the
    # spheres' centers and radii (after u_hover, factor, weight)
    feat_at, sphere_at = c_len - 18 - 12, c_len - 12
    moved = set(torch.nonzero(ep16.consts != ep16b.consts).flatten().tolist())
    if not moved or not moved <= set(range(feat_at, feat_at + 12)) | set(range(sphere_at,
                                                                               sphere_at + 12)):
        raise RuntimeError(f"cfg_episode_quadrotor: the scenes' tables differ at {sorted(moved)}")
    if torch.equal(got16[0], got16b[0]):
        raise RuntimeError("cfg_episode_quadrotor: two scenes gave the same track")
    ep1_ms = cuda_ms(lambda: ep1.kernel(x0, nz1), n=2, warmup=0)
    ep16_ms = cuda_ms(lambda: ep16.kernel(x0, nz16), n=2, warmup=0)
    log("scene-episode", t0, f"H=48, context 24 (the state and scene 0's 12 features): "
        f"cfg_episode_quadrotor K=1 {N_S_EP} replans, K=16 (scene 0's safety-first scorer) "
        f"{N_S_EP16}, and scene 1 through the same build at K=16: max |kernel - plain| "
        f"{ep_err:.3e} (controls {CHAIN_TOL:.0e} in normalized units, the rest {TRACK_TOL:.0e}); "
        f"stage costs the task quadratic on the tracks; K=16 chosen {got16[3].tolist()} (scene 0), "
        f"{got16b[3].tolist()} (scene 1); the tables differ at {len(moved)} entries, all in the "
        f"features and the spheres; {ep1_ms / N_S_EP:.4f} ms per replan at K=1, "
        f"{ep16_ms / N_S_EP16:.4f} at K=16 (plain {ep1_plain_ms / N_S_EP:.3f} and "
        f"{ep16_plain_ms / N_S_EP16:.3f} by the host clock); launches {e_launches}; near-ties "
        f"(not gated): {len(ties)}: " + " | ".join(ties))

    # 36. the CFG chain at H = 48, context 24, B = 1 and 16, against its plain version; then the
    # main path of the per-replan loop through it from the first start on the first N_S_LOOP
    # replans of the episode's noise
    t0 = time.perf_counter()
    chains = {b: make_fused_cfg_chain(spacked, schedule, n_samples=b, w=W, n_tail=N_TAIL,
                                      device=dev)
              for b in (1, 16)}
    ch_err, ch_inputs = 0.0, {}
    for b, ch in chains.items():
        ctx = torch.rand((b, 24), generator=gen, device=dev) * 2 - 1
        nz = torch.randn((ch.n_total + 1, b, 48, 4), generator=gen, device=dev)
        got, want = ch.kernel(ctx, nz), ch.plain(ctx, nz)
        torch.cuda.synchronize()
        ch_err = max(ch_err, assert_close(f"cfg_chain H=48 context 24 B={b}", got, want,
                                          CHAIN_TOL))
        ch_inputs[b] = (ctx, nz)
    loop, _ = bss.chain_loop(spacked, sc0, 1, N_S_LOOP, dev, chain=chains[1])
    nz_loop = nz1[:N_S_LOOP]
    reset(*chains.values())
    t1 = time.perf_counter()
    res = loop(x0, nz_loop)
    torch.cuda.synchronize()
    loop_hz = N_S_LOOP / (time.perf_counter() - t1)
    c_launches = counts(*chains.values())
    if c_launches != [(N_S_LOOP, 0), (0, 0)]:
        raise RuntimeError(f"scene per-replan loop: counts {c_launches}, expected "
                           f"[({N_S_LOOP}, 0), (0, 0)]")
    ref, _ = bss.chain_loop(spacked, sc0, 1, N_S_LOOP, dev, chain=chains[1].plain)
    ref = ref(x0, nz_loop)
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        student_close(f"scene chain loop {name}", getattr(res, name), getattr(ref, name), u_unit)
    ends = {"x_track": N_S_LOOP + 1, "u_track": N_S_LOOP, "stage_costs": N_S_LOOP}
    vs_loop = max(student_close(f"scene episode vs the chain loop {name}", g[:ends[name]],
                                getattr(res, name), u_unit)
                  for name, g in zip(("x_track", "u_track", "stage_costs"), got1))
    ch1_ms = cuda_ms(lambda: chains[1].kernel(*ch_inputs[1]), n=10, warmup=2)
    ch16_ms = cuda_ms(lambda: chains[16].kernel(*ch_inputs[16]), n=5, warmup=1)
    ch_plain_ms = cuda_ms(lambda: chains[1].plain(*ch_inputs[1]), n=1, warmup=0)
    log("scene-chain", t0, f"cfg_chain H=48, context 24: max |kernel - plain| {ch_err:.3e} at "
        f"B=1 and 16 (tol {CHAIN_TOL:.0e}), {ch1_ms:.4f} ms per replan at B=1, {ch16_ms:.4f} at "
        f"B=16 (plain {ch_plain_ms:.3f}); the per-replan loop through it {N_S_LOOP} replans "
        f"({loop_hz:.1f} replans/s by the host clock), against the loop through the plain chain "
        f"and against the K=1 episode on the same noise ({vs_loop:.3e}); launches {c_launches}")

    # 37. the bench's K = 1 row: its 16 starts x 60 replans through the episode within the
    # yardstick's bounds, its pipelined and sustained rates (cut)
    t0 = time.perf_counter()
    n = sys_.N_STARTS
    noise = bss.start_noise(n, sys_.N_STEPS, 1, dev)
    q1 = bss.episode(spacked, sc0, 1, sys_.N_STEPS, dev)
    reset(q1)
    tracks = torch.stack([q1(starts[i], noise[i])[0] for i in range(n)])
    torch.cuda.synchronize()
    q_launches = counts(q1)
    if q_launches != [(n, 0)]:
        raise RuntimeError(f"scene bench row: counts {q_launches}, expected [({n}, 0)]")
    metrics = quadrotor_task.track_metrics(tracks.cpu().numpy(), centers=sc0.centers.cpu(),
                                           radii=sc0.radii.cpu())
    if not sys_.within(metrics, 1):
        raise RuntimeError(f"scene bench K=1: {metrics} outside data/scene_yardstick.py's bounds "
                           f"(gaps {sys_.gaps(metrics, 1)}, bounds {sys_.BOUNDS[1]})")
    pipe_args = [(starts[i], torch.randn(q1.noise_shape, generator=gen, device=dev))
                 for i in range(N_S_PIPE)]
    pipelined_hz = sys_.N_STEPS / pipelined_time_fn(lambda x, z: q1(x, z)[0], pipe_args,
                                                    n_batches=1)
    x = x0
    t1 = time.perf_counter()
    for i in range(N_S_CHUNKS):
        x = q1(x, pipe_args[i % N_S_PIPE][1])[0][-1]
    torch.cuda.synchronize()
    sustained_hz = N_S_CHUNKS * sys_.N_STEPS / (time.perf_counter() - t1)
    if not torch.isfinite(x).all():
        raise RuntimeError("scene bench: the sustained chain diverged")
    q1_ms = cuda_ms(lambda: q1.kernel(x0, noise[0]), n=1, warmup=0)
    log("scene-bench", t0, f"scene 0, {n} starts x {sys_.N_STEPS} replans at K=1 through "
        f"cfg_episode_quadrotor: {metrics}, within data/scene_yardstick.py's bounds (gaps "
        f"{ {k: round(v, 6) for k, v in sys_.gaps(metrics, 1).items()} }); "
        f"{q1_ms / sys_.N_STEPS:.4f} ms per replan; k1_hz_pipelined {pipelined_hz:.1f} "
        f"({N_S_PIPE} episodes, one batch), k1_hz_sustained {sustained_hz:.1f} ({N_S_CHUNKS} "
        f"chained episodes); launches {q_launches}")

    # each row of the kernels line; bytes and operations of this run's inputs
    weights, meta_n = spacked.weights.numel(), spacked.metas[1].numel()
    film_w = sum(math.prod(shape_) for name, (_, shape_) in spacked.segments.items()
                 if name.split(".")[0] == "films")
    film_flops = 2 * 2 * int(spacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in model.res_blocks())
    n_total = chains[1].n_total
    ch_flops = spacked.flops_per_pass * 2 * n_total
    ch_bytes = 4 * (weights - film_w + meta_n + chains[1].films(ch_inputs[1][0]).numel()
                    + ch_inputs[1][1].numel() + chains[1].coefs.numel() + 48 * 4)

    def ep_bound(ep, n_noise):
        """The bound of an episode: both row-sets of every candidate's passes, the in-kernel
        FiLM of the two groups, and at K > 1 each candidate's 48 scoring steps."""
        flops = ep.n_steps * (ep.n_candidates * ep.n_total * 2 * spacked.flops_per_pass
                              + ep.n_total * film_flops
                              + (ep.n_candidates > 1) * ep.n_candidates * 48 * Q_STEP_FLOPS)
        n_bytes = 4 * (weights + meta_n + ep.t_embs.numel() + n_noise + ep.coefs.numel()
                       + ep.consts.numel() + 12 + (ep.n_steps + 1) * 12 + ep.n_steps * 6)
        return bound(flops, n_bytes)

    h48 = {"launches": c_launches[0][0], "max_abs_err": ch_err, "ms": ch1_ms,
           "plain_ms": ch_plain_ms, **bound(ch_flops, ch_bytes), "library_ms": None,
           "b16_ms": ch16_ms, "per_replan_loop_hz": loop_hz, "model": "scene_conditioned",
           "horizon": 48, "context_dim": 24}
    row = {"name": "cfg_episode_quadrotor", "route": "cuda",
           "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode_quadrotor.cu",
           "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
           "entry_of": "cfg_episode", "plant": "quadrotor", "scorer": "safety_first",
           "condition": "concat_features", "launches": q_launches[0][0], "max_abs_err": ep_err,
           "ms": ep1_ms, "plain_ms": ep1_plain_ms, **ep_bound(ep1, nz1.numel()),
           "library_ms": None, "replans": N_S_EP, "ms_per_replan": ep1_ms / N_S_EP,
           "k16_ms_per_replan": ep16_ms / N_S_EP16,
           "k16_bound_ms": ep_bound(ep16, nz16.numel())["bound_ms"], "k16_replans": N_S_EP16,
           "k16_plain_ms": ep16_plain_ms, "k1_hz_pipelined": pipelined_hz,
           "k1_hz_sustained": sustained_hz, "metrics16": metrics,
           "yardstick_gaps": sys_.gaps(metrics, 1), "model": "scene_conditioned",
           "horizon": 48, "context_dim": 24, "scenes": [0, 1]}
    return {"h48": h48, "row": row}


def busy_ms(fn) -> dict:
    """One traced call of ``fn``: its CUDA kernels and the device's busy milliseconds (their
    summed durations, torch.profiler)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"kernels": len(kernels), "busy_ms": sum(e.device_time for e in kernels) / 1e3}


def guided_phases(dev) -> dict:
    """Phases 38-40 on ``dev``: cost-gradient guidance on the quadrotor flagship's teacher. The
    U-Net pass kernel and the CFG chain at H = 48, context 12 against their plain versions, the
    obstacle guide on the card against the CPU's, one guided step, the flagship's guided and
    unguided loops through the kernels against their plain routes with exact launch counts, and
    the scene study's batched oracle and scene-blind rows over scene 0's starts, traced. Returns
    the kernels line's ``h48_ctx12`` entries of rows 1 and 2 and the ``guided`` line."""
    dev = resolve_device(dev)
    fq = flagship_quadrotor
    schedule = make_schedule("exponential", T)
    ins, cond = quadrotor_stats()
    ins_d = ins.to(dev)
    u_unit = (0.5 * (ins.maxs - ins.mins)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(38)
    plant = quadrotor()
    # 38. the U-Net pass kernel at B = 2, 32, 256 against TemporalUnet, timed beside it; the CFG
    # chain at B = 1 and 16 against its plain version; the guide on the card against the CPU's on
    # a batch with an overflowing plan; one guided CFG step through the kernel against the plain
    # denoiser on staged noise
    t0 = time.perf_counter()
    tpacked = fq.teacher(dev)
    model = tpacked.model
    unets = {b: make_fused_unet(tpacked, b, device=dev) for b in G_UNET_BATCHES}
    u_inputs, u_err = {}, 0.0
    for b, fu in unets.items():
        u_inputs[b] = (torch.randn((b, 48, 4), generator=gen, device=dev),
                       torch.randint(0, T, (b,), generator=gen, device=dev),
                       torch.rand((b, 12), generator=gen, device=dev) * 2 - 1,
                       (torch.arange(b, device=dev) >= b // 2).float()[:, None])
        got = fu.kernel(*u_inputs[b])
        torch.cuda.synchronize()
        u_err = max(u_err, assert_close(f"fused_unet H=48 context 12 B={b}", got,
                                        model(*u_inputs[b]), UNET_TOL))
    unet_ms = {b: cuda_ms(lambda b=b: unets[b].kernel(*u_inputs[b]), n=20, warmup=3)
               for b in G_UNET_BATCHES}
    tunet_ms = {b: cuda_ms(lambda b=b: model(*u_inputs[b]), n=10, warmup=2)
                for b in G_UNET_BATCHES}
    chains = {b: make_fused_cfg_chain(tpacked, schedule, n_samples=b, w=W, n_tail=N_TAIL,
                                      device=dev) for b in G_CHAIN_BATCHES}
    c_inputs, c_err = {}, 0.0
    for b, ch in chains.items():
        c_inputs[b] = (torch.rand((b, 12), generator=gen, device=dev) * 2 - 1,
                       torch.randn((ch.n_total + 1, b, 48, 4), generator=gen, device=dev))
        got = ch.kernel(*c_inputs[b])
        torch.cuda.synchronize()
        c_err = max(c_err, assert_close(f"cfg_chain H=48 context 12 B={b}", got,
                                        ch.plain(*c_inputs[b]), CHAIN_TOL))
    chain_ms = {b: cuda_ms(lambda b=b: chains[b].kernel(*c_inputs[b]), n=5, warmup=1)
                for b in G_CHAIN_BATCHES}
    chain_plain_ms = cuda_ms(lambda: chains[1].plain(*c_inputs[1]), n=1, warmup=0)
    # the guide: hover-like plans from three states, two plans each, the third spinning at
    # thousands of rad/s so that its rollout overflows (its gradient is not finite: the mask acts)
    hover = normalize(ins, torch.tensor([quadrotor_task.HOVER_THRUST, 0.0, 0.0, 0.0]))
    u_g = hover + 0.05 * torch.randn((6, 48, 4), generator=torch.Generator().manual_seed(3))
    states = torch.zeros((3, 12))
    states[:, :3] = torch.tensor([[0.9, 0.5, 1.2], [1.5, 0.4, 1.1], [2.0, 0.0, 1.0]])
    states[2, 9:12] = torch.tensor([3e3, -2e3, 1e3])
    g_rows = states.repeat_interleave(2, dim=0)
    g_c, g_r = (torch.from_numpy(a) for a in quadrotor_task.sample_scenes(6, seed=3))
    per = quadrotor_task.make_penalty_grad(plant, ins, 0.1, scene_args=True)
    g_cpu = per(u_g, g_rows, g_c, g_r)
    g_dev = per(*(v.to(dev) for v in (u_g, g_rows, g_c, g_r)))
    with torch.enable_grad():
        un = u_g[4:].to(dev).requires_grad_(True)
        pen = obstacle_cost(rollout(plant, g_rows[4:].to(dev), unnormalize(ins_d, un)),
                            g_c[4:].to(dev), g_r[4:].to(dev)).sum()
        raw_finite = bool(torch.isfinite(torch.autograd.grad(pen, un)[0]).all())
    if raw_finite or g_dev[4:].any() or not g_dev[:4].any():
        raise RuntimeError(f"make_penalty_grad on the card: the overflowing plans' raw gradient "
                           f"finite {raw_finite}, their step {g_dev[4:].abs().max().item()}, the "
                           f"others' {g_dev[:4].abs().max().item()}")
    g_err = assert_close("make_penalty_grad card vs CPU", g_dev.cpu(), g_cpu, CHAIN_TOL)
    x0_q = torch.tensor(fq.X0_Q, device=dev)
    guide = quadrotor_task.make_loop_guide_builder(plant, ins, 0.1)(x0_q)
    # the step from a state inside the first sphere, on a hover-like plan, so that the guide acts
    x0_in = states[1].to(dev)
    guide_in = quadrotor_task.make_loop_guide_builder(plant, ins, 0.1)(x0_in)
    diffusion = GaussianDiffusion(schedule).to(dev)
    x_s = (hover + 0.05 * torch.randn((1, 48, 4), generator=torch.Generator().manual_seed(4))
           ).to(dev)
    nz_s = torch.randn((1, 48, 4), generator=gen, device=dev)
    ctx_s = normalize(cond.to(dev), x0_in)[None]
    step = lambda den: diffusion.ddpm_cfg_step(den, x_s, 10, nz_s, ctx_s, W, guide=guide_in,
                                               t_start_guide=T / 2)
    with torch.no_grad():
        unets[2].launches = 0
        got_s = step(unets[2])
        torch.cuda.synchronize()
        step_err = assert_close("one guided CFG step, kernel vs plain denoiser", got_s,
                                step(model), CHAIN_TOL)
        moved = (got_s - diffusion.ddpm_cfg_step(unets[2], x_s, 10, nz_s, ctx_s, W)).abs().max()
    if unets[2].launches != 2 or moved.item() == 0.0:
        raise RuntimeError(f"guided step: launches {unets[2].launches}, guide moved {moved}")
    log("guided-parts", t0, f"H=48, context 12 (the quadrotor teacher): fused_unet max |kernel - "
        f"TemporalUnet| {u_err:.3e} at B={list(G_UNET_BATCHES)} (tol {UNET_TOL:.0e}), whole call "
        f"{ {b: round(v, 4) for b, v in unet_ms.items()} } ms per pass against TemporalUnet's "
        f"{ {b: round(v, 4) for b, v in tunet_ms.items()} }; cfg_chain max |kernel - plain| "
        f"{c_err:.3e} at B={list(G_CHAIN_BATCHES)}, {chain_ms[1]:.4f} ms per replan at B=1, "
        f"{chain_ms[16]:.4f} at B=16 (plain {chain_plain_ms:.3f}); make_penalty_grad card vs CPU "
        f"{g_err:.3e} on 6 plans, the 2 overflowing ones' raw gradient not finite and their step "
        f"0; one guided CFG step (i=10) through the kernel vs the plain denoiser {step_err:.3e}, "
        f"the guide moved it by {moved.item():.3e}")

    # 39. the flagship's loops from bench_highdim.py's start: guided through kernel 2 (30 launches
    # per replan), unguided through kernel 1 (one per replan), each against its plain route
    t0 = time.perf_counter()
    noise = torch.randn((N_G_LOOP, T + N_TAIL + 1, 1, 48, 4), generator=gen, device=dev)
    gloop, groute = fq.flagship_loop(tpacked, True, 1, N_G_LOOP, dev, route=unets[2])
    uloop, uroute = fq.flagship_loop(tpacked, False, 1, N_G_LOOP, dev, route=chains[1])
    reset(groute, uroute)
    t1 = time.perf_counter()
    gres = gloop(x0_q, noise)
    torch.cuda.synchronize()
    g_ms = 1e3 * (time.perf_counter() - t1) / N_G_LOOP
    t1 = time.perf_counter()
    ures = uloop(x0_q, noise)
    torch.cuda.synchronize()
    u_ms = 1e3 * (time.perf_counter() - t1) / N_G_LOOP
    l_counts = counts(groute, uroute)
    want_counts = [((T + N_TAIL) * N_G_LOOP, 0), (N_G_LOOP, 0)]
    if l_counts != want_counts:
        raise RuntimeError(f"flagship loops: counts {l_counts}, expected {want_counts}")
    gref, _ = fq.flagship_loop(tpacked, True, 1, N_G_LOOP, dev, route=model)
    uref, _ = fq.flagship_loop(tpacked, False, 1, N_G_LOOP, dev, route=chains[1].plain)
    t1 = time.perf_counter()
    gref = gref(x0_q, noise)
    torch.cuda.synchronize()
    g_plain_ms = 1e3 * (time.perf_counter() - t1) / N_G_LOOP
    uref = uref(x0_q, noise)
    loop_err = 0.0
    for tag, res, ref in (("guided", gres, gref), ("unguided", ures, uref)):
        for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
            loop_err = max(loop_err, student_close(f"flagship {tag} loop {name}",
                                                   getattr(res, name), getattr(ref, name),
                                                   u_unit))
    guided_moved = (gres.u_horizons - ures.u_horizons).abs().max().item()
    u_zero = torch.zeros((1, 48, 4), device=dev)
    guide_ms = cuda_ms(lambda: guide(u_zero), n=2, warmup=1)
    log("guided-loop", t0, f"x0 {list(fq.X0_Q)}, {N_G_LOOP} replans: the guided loop through "
        f"fused_unet (B=2) and the unguided one through cfg_chain (B=1) against their plain routes "
        f"(TemporalUnet, the plain chain): max {loop_err:.3e} (controls {CHAIN_TOL:.0e} in "
        f"normalized units, the rest {TRACK_TOL:.0e}); the guide moved the plans by "
        f"{guided_moved:.3e}; launches {l_counts}; guided {g_ms:.1f} ms per replan (plain route "
        f"{g_plain_ms:.1f}), unguided {u_ms:.2f}; one guide call {guide_ms:.1f} ms (18 per "
        f"replan)")

    # 40. the scene study's oracle and scene-blind rows over the held-out protocol's 128 (scene,
    # start) pairs, one batched loop each, N_G_LOOP replans on the same noise, the oracle's guide
    # traced; the paired gate of data/guided_yardstick.py on their first plans (each rolled
    # open-loop against its own scene), which the same oracle with a guide that returns zeros
    # must fail
    t0 = time.perf_counter()
    prs = scene_conditioned_quadrotor.Pairs(gys.N_SCENES, gys.N_STARTS, dev)
    n = len(prs)
    s_noise = bench_scene_student.start_noise(n, N_G_LOOP, 1, dev, seed=41)
    chain_h = make_fused_cfg_chain(tpacked, schedule, n_samples=n, w=W, n_tail=N_TAIL, device=dev)
    oloop, oroute = scene_conditioned_quadrotor.teacher_loop(
        tpacked, prs.centers, prs.radii, N_G_LOOP, dev, True, route=unets[2 * n])
    bloop, broute = scene_conditioned_quadrotor.teacher_loop(
        tpacked, prs.centers, prs.radii, N_G_LOOP, dev, False, route=chain_h)
    reset(oroute, broute)
    t1 = time.perf_counter()
    ores = oloop(prs.x0, s_noise)
    torch.cuda.synchronize()
    o_ms = 1e3 * (time.perf_counter() - t1) / N_G_LOOP
    t1 = time.perf_counter()
    bres = bloop(prs.x0, s_noise)
    torch.cuda.synchronize()
    b_ms = 1e3 * (time.perf_counter() - t1) / N_G_LOOP
    s_counts = counts(oroute, broute)
    want_counts = [((T + N_TAIL) * N_G_LOOP, 0), (N_G_LOOP, 0)]
    if s_counts != want_counts:
        raise RuntimeError(f"scene rows: counts {s_counts}, expected {want_counts}")
    if not (torch.isfinite(ores.x_track).all() and torch.isfinite(bres.x_track).all()):
        raise RuntimeError("scene rows: non-finite tracks")
    zloop, _ = fq.serving_loop(tpacked, (ins, cond), quadrotor_cost(), n, 1, dev,
                               guide_builder=lambda x0: torch.zeros_like,
                               t_start_guide=gys.T_START_SCENE, route=unets[2 * n])
    zres = zloop(prs.x0, s_noise[:, :1])
    first = {tag: guided_divergence.plan_clearance(res.x_track[:, 0], res.u_horizons[:, 0],
                                                   prs.centers, prs.radii)
             for tag, res in (("oracle", ores), ("blind", bres), ("zero", zres))}
    paired = gys.paired(first["oracle"], first["blind"])
    zero_paired = gys.paired(first["zero"], first["blind"])
    gate = "heldout_first_plans"
    if not gys.paired_within(paired, gate) or gys.paired_within(zero_paired, gate):
        raise RuntimeError(f"the paired gate on the held-out first plans: guided {paired} (within "
                           f"{gys.paired_within(paired, gate)}), a zero guide {zero_paired} "
                           f"(within {gys.paired_within(zero_paired, gate)}); the JAX package's "
                           f"{gys.PAIRED[gate]}, bounds {gys.PAIRED_BOUNDS[gate]}")
    # one batched guide call of the oracle (12 per replan), timed and traced
    oguide = scene_conditioned_quadrotor.scene_guide_builder(plant, ins, 0.1, prs.centers,
                                                             prs.radii)(prs.x0)
    u_o = torch.zeros((n, 48, 4), device=dev)
    oguide_ms = cuda_ms(lambda: oguide(u_o), n=2, warmup=1)
    o1 = busy_ms(lambda: oguide(u_o))
    n_guided = sum(1 for i in range(T - 1, -N_TAIL - 1, -1) if i < gys.T_START_SCENE)
    log("guided-study", t0, f"the held-out protocol's {n} pairs x {N_G_LOOP} replans as one "
        f"batched loop each: the per-scene guided oracle through fused_unet (B={2 * n}) "
        f"{o_ms:.1f} ms per replan, the scene-blind teacher through cfg_chain (B={n}) "
        f"{b_ms:.2f}; launches {s_counts}; one batched guide call {oguide_ms:.1f} ms, traced: "
        f"{o1['kernels']} kernels, {o1['busy_ms']:.2f} ms of device time, the host's share "
        f"{1 - o1['busy_ms'] / oguide_ms:.4f}; the {n_guided} guide calls "
        f"{n_guided * oguide_ms / o_ms:.3f} of the replan; the paired gate on the first plans "
        f"{paired} (JAX {gys.PAIRED[gate]}, bounds {gys.PAIRED_BOUNDS[gate]}), a zero guide "
        f"{zero_paired}, outside them")

    # the kernels line's entries at H = 48, context 12: the chain at B = 1 (one replan), the pass
    # at B = 2 (backbone only, one pass), this run's inputs
    weights, meta_n = tpacked.weights.numel(), tpacked.metas[1].numel()
    seg = lambda *prefixes: sum(math.prod(shape_) for name, (_, shape_) in tpacked.segments.items()
                                if name.split(".")[0] in prefixes)
    ch = chains[1]
    ch_flops = tpacked.flops_per_pass * 2 * ch.n_total
    ch_bytes = 4 * (weights - seg("films") + meta_n + ch.films(c_inputs[1][0]).numel()
                    + c_inputs[1][1].numel() + ch.coefs.numel() + 48 * 4)
    x_u = u_inputs[2][0]
    un_flops = 2 * (tpacked.flops_per_pass - tpacked.flops_final_1x1)
    un_bytes = 4 * (weights - seg("films", "final1x1") + meta_n
                    + unets[2].films(model.conditioning(*u_inputs[2][1:])).numel()
                    + x_u.numel() + 2 * 48 * model.unet_input_dim)
    common = {"library_ms": None, "model": "flagship_quadrotor", "horizon": 48, "context_dim": 12}
    return {
        "cfg_chain": {"launches": l_counts[1][0] + s_counts[1][0], "max_abs_err": c_err,
                      "ms": chain_ms[1], "plain_ms": chain_plain_ms, **bound(ch_flops, ch_bytes),
                      "b16_ms": chain_ms[16], **common},
        "fused_unet": {"launches": l_counts[0][0] + s_counts[0][0], "max_abs_err": u_err,
                       "ms": unet_ms[2], "plain_ms": tunet_ms[2], **bound(un_flops, un_bytes),
                       "whole_call": True, "ms_by_batch": unet_ms, "temporal_unet_ms_by_batch":
                       tunet_ms, **common},
        "guided": {"loop_max_err": loop_err, "penalty_grad_card_vs_cpu": g_err,
                   "guided_step_err": step_err, "guided_ms_per_replan": g_ms,
                   "guided_plain_ms_per_replan": g_plain_ms, "unguided_ms_per_replan": u_ms,
                   "guide_call_ms": guide_ms, "oracle_ms_per_replan": o_ms,
                   "blind_ms_per_replan": b_ms, "oracle_guide_call_ms": oguide_ms,
                   "oracle_guide_trace": o1,
                   "oracle_guide_host_share": 1 - o1["busy_ms"] / oguide_ms,
                   "oracle_guide_share_of_replan": n_guided * oguide_ms / o_ms,
                   "paired_gate_first_plans": paired, "paired_gate_zero_guide": zero_paired,
                   "replans": N_G_LOOP, "nvidia_smi": nvidia_smi()}}


def near_threshold(out: dict, clear_margin: float = 0.05,
                   progress_keep: float = 0.85) -> torch.Tensor:
    """The rows of a sampling chunk within KEEP_NEAR of one of the curation's thresholds."""
    return (((out["clear"] - clear_margin).abs() <= KEEP_NEAR)
            | ((out["d1"] - progress_keep * out["d0"]).abs() <= KEEP_NEAR)
            | ((out["d0"] - 0.5).abs() <= KEEP_NEAR))


def making_phases(dev, work: Path) -> dict:
    """Phases 41-42 on ``dev``: the scene study's making half. The guided sampling chunk through
    the U-Net pass kernel against the plain denoiser and at the script's chunk size, the --quick
    making half within its yardstick (its student and dataset written to ``work``), the
    labeler through the CFG chain kernel against its plain version, and the toy onpolicy_scene
    within its yardstick. Returns the kernels line's ``b4096`` entries of rows 1 and 2 and the
    ``making`` line."""
    dev = resolve_device(dev)
    scq = scene_conditioned_quadrotor
    t0 = time.perf_counter()
    tpacked = flagship_quadrotor.teacher(dev)
    pool = scq.load_pool(gys.TEACHER.parent / "dataset.npz", dev)
    rng = np.random.RandomState(scq.POOL_SEED)
    sc_c, sc_r = (torch.from_numpy(a).to(dev) for a in quadrotor_task.sample_scenes(
        MK_FULL_B, seed=scq.SCENE_DRAW_SEED))
    # 41. one chunk of MK_CHECK_B rows through the kernel at 2 B rows against the plain
    # denoiser on the same staged noise: plans, keep mask, 30 launches
    idx = torch.from_numpy(rng.randint(0, len(pool), MK_FULL_B)).to(dev)
    args_ = lambda b: (pool.condition[idx[:b]], pool.condition_normalized[idx[:b]], sc_c[:b],
                       sc_r[:b], scq.chunk_noise(0, b, dev))
    fu = make_fused_unet(tpacked, 2 * MK_CHECK_B, device=dev)
    reset(fu)
    got = scq.sample_chunk(fu, *args_(MK_CHECK_B))
    torch.cuda.synchronize()
    check_counts = counts(fu)
    want = scq.sample_chunk(tpacked.model, *args_(MK_CHECK_B))
    # the guide's gradient through a 48-step rollout is ill-conditioned at some rows (deep in a
    # sphere, near tan(theta)'s pole), where the chain amplifies fp32 differences of the
    # denoiser: the plain denoiser with every eps moved by a relative 1e-6 (a fixed sign pattern)
    # finds those rows, which the gates leave out (at most MK_CHAOTIC_SHARE of them)
    signs = torch.sign(torch.sin(torch.arange(2 * MK_CHECK_B * 48 * 4, device=dev,
                                              dtype=torch.float32))).reshape(2 * MK_CHECK_B, 48, 4)
    moved = scq.sample_chunk(lambda x, t, c, m: tpacked.model(x, t, c, m) * (1 + 1e-6 * signs),
                             *args_(MK_CHECK_B))
    chaotic = (moved["u_norm"] - want["u_norm"]).abs().flatten(1).amax(1) > CHAIN_TOL / 10
    calm = ~chaotic
    plan_err = assert_close(f"guided sampling chunk B={MK_CHECK_B}, kernel vs plain denoiser, "
                            f"the {int(calm.sum())} calm rows", got["u_norm"][calm],
                            want["u_norm"][calm], CHAIN_TOL)
    keep_g = scq.keep_mask(got["clear"], got["d0"], got["d1"], 0.05, 0.85)
    keep_w = scq.keep_mask(want["clear"], want["d0"], want["d1"], 0.05, 0.85)
    near = near_threshold(got) | near_threshold(want)
    differ = (keep_g != keep_w) & ~near & calm
    if (check_counts != [(T + N_TAIL, 0)] or differ.any()
            or chaotic.float().mean().item() > MK_CHAOTIC_SHARE):
        raise RuntimeError(f"guided sampling chunk: launches {check_counts}, keep masks differ "
                           f"away from a threshold at {differ.sum().item()} calm rows, "
                           f"{int(chaotic.sum())} chaotic rows of {MK_CHECK_B}")
    chaos_err = (got["u_norm"] - want["u_norm"]).abs().max().item()
    ctx_err = assert_close("ctx24, kernel vs plain route", got["ctx24"], want["ctx24"], 0.0)
    # one chunk at the script's size, 2 x MK_FULL_B rows through the kernel, timed
    fu_full = make_fused_unet(tpacked, 2 * MK_FULL_B, device=dev)
    reset(fu_full)
    t1 = time.perf_counter()
    full = scq.sample_chunk(fu_full, *args_(MK_FULL_B))
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t1
    full_counts = counts(fu_full)
    if full_counts != [(T + N_TAIL, 0)] or not torch.isfinite(full["u_norm"]).all():
        raise RuntimeError(f"guided sampling chunk B={MK_FULL_B}: launches {full_counts}, finite "
                           f"{bool(torch.isfinite(full['u_norm']).all())}")
    n_keep_full = int(scq.keep_mask(full["clear"], full["d0"], full["d1"], 0.05, 0.85).sum())
    u_in = (torch.randn((2 * MK_FULL_B, 48, 4), generator=torch.Generator(device=dev)
                        .manual_seed(41), device=dev),
            torch.full((2 * MK_FULL_B,), 10, device=dev),
            torch.cat([pool.condition_normalized[idx]] * 2),
            (torch.arange(2 * MK_FULL_B, device=dev) >= MK_FULL_B).float()[:, None])
    unet_err = assert_close(f"fused_unet H=48 context 12 B={2 * MK_FULL_B}",
                            fu_full.kernel(*u_in), tpacked.model(*u_in), UNET_TOL)
    unet_ms = cuda_ms(lambda: fu_full.kernel(*u_in), n=3, warmup=1)
    unet_plain_ms = cuda_ms(lambda: tpacked.model(*u_in), n=3, warmup=1)
    # the --quick making half through the script's entry point (the teacher's rows left out:
    # data/guided_yardstick.py holds them), within data/scene_making_yardstick.py's bounds
    rep = scq.main(["--make", "--quick", "--no-teacher-rows", "--out",
                    str(work / "report.json")])
    making = {"n_kept": rep["n_kept"], "final_loss": rep["final_loss"],
              **{m: rep["making"][m] for m in ("keep_fraction", "kept_clearance_mean",
                                               "first_losses")}}
    rows_ = dict(rep["held_out"], canonical_scene_student=rep["canonical_scene_student"])
    quick_gaps = mys.gaps(making, rows_)
    quick_launches = rep["making"]["sample_launches"]
    if not mys.within(making, rows_) or quick_launches != 2 * (T + N_TAIL):
        raise RuntimeError(f"--quick making half: gaps {quick_gaps} against bounds "
                           f"{mys.BOUNDS}; sampling launches {quick_launches}")
    log("scene-making", t0, f"guided sampling with per-row scenes on the quadrotor teacher: "
        f"B={MK_CHECK_B} through fused_unet at {2 * MK_CHECK_B} rows against the plain denoiser "
        f"{plan_err:.3e} on the {int(calm.sum())} calm rows (tol {CHAIN_TOL:.0e}; "
        f"{int(chaotic.sum())} chaotic rows, which moved by up to {chaos_err:.3e}), keep masks "
        f"equal away from the thresholds ({int(near.sum())} rows near one), launches "
        f"{check_counts}; B={MK_FULL_B} "
        f"({2 * MK_FULL_B} rows) {chunk_s:.2f} s per chunk, kept {n_keep_full}/{MK_FULL_B}, "
        f"one pass {unet_ms:.3f} ms (TemporalUnet {unet_plain_ms:.3f}, max |diff| "
        f"{unet_err:.3e}); --quick making: kept {making['n_kept']}/{rep['n_drawn']}, final loss "
        f"{making['final_loss']:.5f}, sample {rep['sample_seconds']} s, fine-tune "
        f"{rep['finetune_seconds']} s, within data/scene_making_yardstick.py's bounds")

    # 42. onpolicy_scene's labeler: LABEL_ROWS rows x LABEL_K candidates through the chain at
    # LABEL_ROWS LABEL_K samples against its plain version, the LQR plan appended, the same
    # choices but near-ties; then the toy run within its yardstick
    t0 = time.perf_counter()
    spacked = pack_unet(load_scene_student(sys_.STUDENT, device=dev), dev)
    lqr = quadrotor_task.make_lqr_hover_plan(quadrotor(), quadrotor_cost(), scene_stats()[0],
                                             48, dev)
    labeler = onpolicy_scene.Labeler(spacked, LABEL_K, onpolicy_scene.LABEL_ROWS, dev, 0.0, lqr)
    n_rows = onpolicy_scene.LABEL_ROWS
    lx = torch.from_numpy(eval_start_states(n_rows, seed=60)).to(dev)
    lc, lr = (torch.from_numpy(a).to(dev) for a in quadrotor_task.sample_scenes(n_rows, seed=500))
    l_noise = torch.randn((T + N_TAIL + 1, n_rows * LABEL_K, 48, 4),
                          generator=torch.Generator(device=dev).manual_seed(42), device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def timed_chain(ctx_, noise_):
        """The labeler's own chain call, between two CUDA events."""
        ev[0].record()
        out = labeler.chain(ctx_, noise_)
        ev[1].record()
        return out

    reset(labeler.chain)
    t1 = time.perf_counter()
    _, pick_k, _, cand_k = labeler.batch(lx, lc, lr, l_noise, sample=timed_chain)
    torch.cuda.synchronize()
    label_s = time.perf_counter() - t1
    chain_ms = ev[0].elapsed_time(ev[1])
    label_counts = counts(labeler.chain)
    ctx_l = labeler.context(lx, lc, lr).repeat_interleave(LABEL_K, dim=0)
    plain_out = {}
    chain_plain_ms = cuda_ms(lambda: plain_out.update(x=labeler.chain.plain(ctx_l, l_noise)),
                             n=1, warmup=0)
    _, pick_p, score_p, cand_p = labeler.batch(lx, lc, lr, l_noise,
                                               sample=lambda c, nz: plain_out["x"])
    # as in phase 41: the chain's clip amplifies fp32 differences at some samples (the plain
    # chain with eps moved by a relative 1e-6 moved 11 of 1,024 samples past 1e-5 on the CPU, 5
    # past 1e-4); such chaotic samples, at most MK_CHAOTIC_SHARE, are left out of the gates, and
    # the picks compared on the rows whose every candidate is calm
    plain_model = labeler.chain.plain_model
    signs = torch.sign(torch.sin(torch.arange(2 * n_rows * LABEL_K * 48 * 4, device=dev,
                                              dtype=torch.float32))).reshape(-1, 48, 4)
    labeler.chain.plain_model = lambda x, t, c, m: plain_model(x, t, c, m) * (1 + 1e-6 * signs)
    moved = labeler.chain.plain(ctx_l, l_noise)
    labeler.chain.plain_model = plain_model
    l_chaotic = (moved - plain_out["x"]).abs().flatten(1).amax(1) > CHAIN_TOL / 10
    calm_rows = ~l_chaotic.reshape(n_rows, LABEL_K).any(1)
    ties = [i for i in range(n_rows) if near_tie(score_p[i])]
    diff_picks = [i for i in range(n_rows) if pick_k[i] != pick_p[i] and i not in ties
                  and calm_rows[i]]
    # the chain's candidates (the LQR plan after them overflows from a start far from hover,
    # and its NaN score loses, the labeler's rule)
    calm_s = ~l_chaotic
    label_err = assert_close(f"labeler candidates, cfg_chain at {n_rows * LABEL_K} samples vs "
                             f"plain, the {int(calm_s.sum())} calm samples",
                             cand_k[:, :LABEL_K].reshape(-1, 48, 4)[calm_s],
                             cand_p[:, :LABEL_K].reshape(-1, 48, 4)[calm_s], CHAIN_TOL)
    label_chaos_err = (cand_k[:, :LABEL_K] - cand_p[:, :LABEL_K]).abs().max().item()
    if (label_counts != [(1, 0)] or diff_picks
            or l_chaotic.float().mean().item() > MK_CHAOTIC_SHARE):
        raise RuntimeError(f"labeler: launches {label_counts}, choices differ away from a "
                           f"near-tie at calm rows {diff_picks}, {int(l_chaotic.sum())} chaotic "
                           f"samples of {n_rows * LABEL_K}")
    toy = onpolicy_scene.main(["--scene-dir", str(work), "--out", str(work / "toy"),
                               *oys.TOY_ARGS])
    toy_got = {"pairs": toy["iterations"][0]["pairs"],
               "rows": {f"{r['student']}_k{r['K']}": r for r in toy["rows"]}}
    toy_launches = (toy["iterations"][0]["collect_launches"]
                    + toy["iterations"][0]["label_launches"]
                    + sum(r["launches"] for r in toy["rows"]))
    if not oys.within(toy_got):
        raise RuntimeError(f"toy onpolicy_scene: gaps {oys.gaps(toy_got)} against bounds "
                           f"{oys.BOUNDS}")
    log("onpolicy-scene", t0, f"the labeler at {n_rows} rows x K={LABEL_K} (+ the LQR plan): "
        f"cfg_chain at {n_rows * LABEL_K} samples against plain {label_err:.3e} on the "
        f"{int(calm_s.sum())} calm samples (tol {CHAIN_TOL:.0e}; {int(l_chaotic.sum())} chaotic, "
        f"up to {label_chaos_err:.3e}), choices equal on the {int(calm_rows.sum())} calm rows but "
        f"{len(ties)} near-ties, launches {label_counts}, "
        f"{label_s:.2f} s per batch, the chain {chain_ms:.1f} ms (plain {chain_plain_ms:.1f}); "
        f"toy onpolicy_scene: {toy_got['pairs']} pairs, {toy_launches} chain launches, within "
        f"data/onpolicy_scene_yardstick.py's bounds")
    # the kernels line's entries at this slice's batch sizes, this run's inputs: the U-Net pass
    # at 2 MK_FULL_B rows (backbone only, one pass), the chain at n_rows LABEL_K samples (one
    # replan, context 24)
    weights, meta_n = tpacked.weights.numel(), tpacked.metas[1].numel()
    seg = lambda pk, *prefixes: sum(math.prod(shape_) for name, (_, shape_) in pk.segments.items()
                                    if name.split(".")[0] in prefixes)
    un_flops = 2 * MK_FULL_B * (tpacked.flops_per_pass - tpacked.flops_final_1x1)
    un_bytes = 4 * (weights - seg(tpacked, "films", "final1x1") + meta_n
                    + fu_full.films(tpacked.model.conditioning(*u_in[1:])).numel()
                    + u_in[0].numel() + 2 * MK_FULL_B * 48 * tpacked.model.unet_input_dim)
    ch = labeler.chain
    ch_flops = spacked.flops_per_pass * 2 * ch.n_total * ch.n_samples
    ch_bytes = 4 * (spacked.weights.numel() - seg(spacked, "films") + spacked.metas[1].numel()
                    + ch.films(ctx_l).numel() + l_noise.numel() + ch.coefs.numel()
                    + ch.n_samples * 48 * 4)
    common = {"library_ms": None, "horizon": 48}
    return {
        "fused_unet": {"launches": full_counts[0][0] + check_counts[0][0] + quick_launches,
                       "max_abs_err": max(unet_err, plan_err), "ms": unet_ms,
                       "plain_ms": unet_plain_ms, **bound(un_flops, un_bytes), "batch":
                       2 * MK_FULL_B, "whole_call": True, "model": "flagship_quadrotor",
                       "context_dim": 12, "chunk_seconds": chunk_s, **common},
        "cfg_chain": {"launches": label_counts[0][0] + toy_launches, "max_abs_err": label_err,
                      "ms": chain_ms, "plain_ms": chain_plain_ms, **bound(ch_flops, ch_bytes),
                      "n_samples": ch.n_samples, "model": "scene_conditioned",
                      "context_dim": 24, "label_batch_seconds": label_s, **common},
        "making": {"plan_err": plan_err, "chaotic_rows": int(chaotic.sum()),
                   "chaotic_max_err": chaos_err, "ctx24_err": ctx_err, "rows_near_threshold":
                   int(near.sum()), "chunk_seconds": chunk_s, "kept_full_chunk": n_keep_full,
                   "quick": making, "quick_rows": {r: {m: rows_[r][m] for m in oys.METRICS_KEYS}
                                                   for r in mys.ROWS},
                   "quick_gaps": quick_gaps, "sample_seconds": rep["sample_seconds"],
                   "finetune_seconds": rep["finetune_seconds"], "label_err": label_err,
                   "label_chaotic_samples": int(l_chaotic.sum()),
                   "label_chaotic_max_err": label_chaos_err,
                   "label_near_ties": len(ties), "label_batch_seconds": label_s,
                   "toy": {"pairs": toy_got["pairs"], "gaps": oys.gaps(toy_got),
                           "iteration": toy["iterations"][0]},
                   "nvidia_smi": nvidia_smi()}}


# The panda arm's student (phases 43-45; the JAX package's scripts/bench_panda_student.py): the
# on-policy 1-eval student at horizon 128 with 7 channels and a 20-dim context (the shifted
# 14-state's q, qd and the end effector's position and velocity, make_panda_context), the
# rigid-body arm (dynamics/arm.py) and data/panda_stats.py, on the one-row-set plan of shared
# memory (154,764 B per CTA for the pass and the chain; the two-row-set plan, 304,780 B, does not
# fit one block). Phase 43 holds kernels 2 and 4 at that shape to their plain versions (the U-Net
# pass at P_UNET_B rows, the DDIM chain at B = 1 and 16 on [23] and at B = 1 on [23, 15, 7]) and
# runs bench_kernels' panda rows, kernel 2's path; phase 44 the chain split's K = 1 row over its
# 10 episodes (80 replans, one batched loop) and its K = 16, sel_h 32 row over the 10 episodes'
# first P_K16_STEPS replans (the eager arm's rollouts are launch-bound: the full row is
# scripts/bench_panda_student.py's), each within data/panda_yardstick.py's bounds, and the first
# P_CHECK replans of each against the loop through the plain chain; phase 45 the episode kernel's
# panda entry at K = 1 and K = 4 (sel_h 16) over the 10 episodes within the bounds, against its
# plain twin over P_EP_CHECK (K = 1) and P_EP4_CHECK (K = 4) replans on the same staged noise, and
# K = 4 at selection horizon 1 beside 16, whose difference is 15 serial arm steps of the scorer.
PANDA_STUDENT = ROOT / "artifacts" / "onpolicy_panda" / "student_1eval.pkl"
P_UNET_B, P_K16, P_SEL_H, P_K16_STEPS = (2, 16), 16, 32, 20
# (3, 20 and 4 took phases 43-45 26.1 s on an H100 and 45.2 s beside a host ~2.4x slower, the
# plain K = 4 episode 4.0 s per replan there; hence 2, 10 and 2)
P_CHECK, P_EP_CHECK, P_EP4_CHECK = 2, 10, 2
# fp32 operations of one PandaRbd::step (plants.cuh), counted from its code: eight RNE passes of
# 1,596 (7 outward links of 174: eight cross products of 9, five 3 x 3 products of 15, the adds
# and the mass's 3; then 6 inward links of 42 and 7 of 18), the links' 77, q's 7, the
# symmetrisation's 98, the right side's 21, the Cholesky factor's 140, the two solves' 98 and the
# Euler step's 28 (sin and cos counted as one each); the context's FK is left out
PANDA_STEP_FLOPS = 8 * 1596 + 77 + 7 + 98 + 21 + 140 + 98 + 28


def panda_phases(dev) -> dict:
    """Phases 43-45 on ``dev``: the panda student's serving path (kernels 2 and 4 at horizon
    128, the chain split's rows, the episode kernel's panda entry) against the plain versions
    and the JAX package's yardstick. Returns each kernel's row of the kernels line: ``panda``
    under the U-Net pass and the DDIM chain, ``ddim_episode_panda`` a row of its own."""
    dev = resolve_device(dev)
    schedule = make_schedule("exponential", T)
    ins, cond = (st.to(dev) for st in panda_stats())
    u_unit = 0.5 * (ins.maxs - ins.mins)
    x0 = torch.from_numpy(pys.x0()).to(dev)
    xs = x0.expand(pys.N_SEEDS, 14)
    gen = torch.Generator(device=dev).manual_seed(43)
    # 43. kernels 2 and 4 at the panda shape against their plain versions, and kernel 2's path:
    # bench_kernels' panda rows
    t0 = time.perf_counter()
    student = load_panda_student(PANDA_STUDENT, device=dev)
    unets = {b: make_fused_unet(student, batch_size=b, device=dev) for b in P_UNET_B}
    ppacked = unets[2].packed
    chains = {(tuple(times), b): make_fused_ddim_chain(ppacked, schedule, times, n_samples=b,
                                                       device=dev)
              for times, b in ((GRID, 1), (GRID, P_K16), (GRID3, 1))}
    unet_err, unet_in = 0.0, {}
    for b, un in unets.items():
        args = (torch.randn((b, pys.H, 7), generator=gen, device=dev),
                torch.full((b,), GRID[0], dtype=torch.long, device=dev),
                torch.rand((b, 20), generator=gen, device=dev) * 2 - 1,
                torch.zeros((b, 1), device=dev))
        got, want = un.kernel(*args), un.plain(*args)
        torch.cuda.synchronize()
        unet_err = max(unet_err, assert_close(f"fused_unet H=128 B={b}", got, want, UNET_TOL))
        unet_in[b] = args
    ctx0 = normalize(cond, make_panda_context()(x0))[None]
    chain_err, chain_in = 0.0, {}
    for (times, b), ch in chains.items():
        for ctx in (ctx0.expand(b, 20).contiguous(),
                    torch.rand((b, 20), generator=gen, device=dev) * 2 - 1):
            x_init = torch.randn(ch.noise_shape, generator=gen, device=dev)
            got, want = ch.kernel(ctx, x_init), ch.plain(ctx, x_init)
            torch.cuda.synchronize()
            chain_err = max(chain_err, assert_close(f"ddim_chain H=128 {list(times)} B={b}", got,
                                                    want, CHAIN_TOL))
            chain_in[times, b] = (ctx, x_init)
    bench_rows = bench_kernels.bench_panda(dev, quick=True)
    torch.cuda.synchronize()
    unet_launches = next(r["launches"] for r in bench_rows if r["kernel"] == "unet_forward")
    if not unet_launches or any(r["kernel_us"] is None for r in bench_rows):
        raise RuntimeError(f"bench_kernels' panda rows: {bench_rows}")
    un2 = unets[2]
    films2 = un2.films(student.conditioning(*unet_in[2][1:])).contiguous()
    y2 = torch.empty((2, pys.H, student.unet_input_dim), device=dev)
    unet_launch_ms = cuda_ms(lambda: un2._launch(un2.cluster.weights, films2, unet_in[2][0], y2),
                             n=20, warmup=3)
    unet_ms = cuda_ms(lambda: un2.kernel(*unet_in[2]), n=20, warmup=3)
    unet16_ms = cuda_ms(lambda: unets[16].kernel(*unet_in[16]), n=10, warmup=2)
    unet_plain_ms = cuda_ms(lambda: un2.plain(*unet_in[2]), n=10, warmup=2)
    ch1 = chains[tuple(GRID), 1]
    ch_ms = cuda_ms(lambda: ch1.kernel(*chain_in[tuple(GRID), 1]), n=20, warmup=3)
    ch16_ms = cuda_ms(lambda: chains[tuple(GRID), P_K16].kernel(*chain_in[tuple(GRID), P_K16]),
                      n=10, warmup=2)
    ch3_ms = cuda_ms(lambda: chains[tuple(GRID3), 1].kernel(*chain_in[tuple(GRID3), 1]), n=10,
                     warmup=2)
    ch_plain_ms = cuda_ms(lambda: ch1.plain(*chain_in[tuple(GRID), 1]), n=10, warmup=2)
    log("panda-kernels", t0, f"H=128, 7 channels, context 20, the one-row-set plan "
        f"({un2.smem_bytes} B per CTA; two row-sets {ppacked.chain_smem_bytes(2)}, in turns "
        f"{ppacked.chain_smem_bytes(TURNS)} B): fused_unet "
        f"max |kernel - plain| {unet_err:.3e} at B in {P_UNET_B}, ddim_chain {chain_err:.3e} over "
        f"2 contexts at B = 1 and {P_K16} on {GRID} and B = 1 on {GRID3} (tol {CHAIN_TOL:.0e}); "
        f"fused_unet at B=2 {unet_launch_ms:.4f} ms by launch alone, {unet_ms:.4f} by whole call, "
        f"{unet16_ms:.4f} at B=16 (plain {unet_plain_ms:.3f}); ddim_chain {ch_ms:.4f} ms at B=1, "
        f"{ch16_ms:.4f} at B={P_K16}, {ch3_ms:.4f} on {GRID3} (plain {ch_plain_ms:.3f}); "
        f"bench_kernels' panda rows: " + "; ".join(
            f"{r['kernel']} {r['max_abs_err']:.3e}, {r['kernel_us']:.1f} us (plain "
            f"{r['plain_us']:.1f})" for r in bench_rows)
        + f"; fused_unet launches there {unet_launches}")

    # 44. the chain split's rows (the JAX script's XLA rows): K = 1 over the 10 episodes, K = 16
    # at sel_h 32 over their first P_K16_STEPS replans, one batched loop each
    t0 = time.perf_counter()
    loop1, chain1 = bench_panda_student.chain_loop(student, 1, None, pys.N_STEPS, pys.N_SEEDS, dev)
    loop16, chain16 = bench_panda_student.chain_loop(student, P_K16, P_SEL_H, P_K16_STEPS,
                                                     pys.N_SEEDS, dev)
    noise1 = bench_panda_student.staged_noise(pys.N_SEEDS, pys.N_STEPS, 1, dev, 44)
    noise16 = bench_panda_student.staged_noise(pys.N_SEEDS, P_K16_STEPS, P_K16, dev, 45)
    reset(chain1, chain16)
    t1 = time.perf_counter()
    res1 = loop1(xs, noise1)
    torch.cuda.synchronize()
    loop1_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    res16 = loop16(xs, noise16)
    torch.cuda.synchronize()
    loop16_s = time.perf_counter() - t1
    split_launches = counts(chain1, chain16)
    if split_launches != [(pys.N_STEPS, 0), (P_K16_STEPS, 0)]:
        raise RuntimeError(f"panda chain split: counts {split_launches}, expected "
                           f"[({pys.N_STEPS}, 0), ({P_K16_STEPS}, 0)]")
    costs1 = res1.stage_costs.double().sum(-1).cpu().numpy()
    prefix16 = res16.stage_costs.double().sum(-1).cpu().numpy()
    for name, res in (("K=1", res1), (f"K={P_K16}", res16)):
        if not all(torch.isfinite(getattr(res, n)).all() for n in ("x_track", "u_track")):
            raise RuntimeError(f"panda chain split {name}: non-finite tracks")
    gaps1, gaps16 = pys.gaps("k1", costs1), pys.gaps("k16_selh32", None, prefix16)
    if not (pys.within("k1", costs1) and pys.within("k16_selh32", None, prefix16)):
        raise RuntimeError(f"panda chain split: gaps from the yardstick K=1 {gaps1}, K={P_K16} "
                           f"{gaps16}; bounds {pys.BOUNDS['k1']}, {pys.BOUNDS['k16_selh32']}")
    split_err = 0.0
    for name, loop_kw, res, noise in (
            ("K=1", dict(k=1, sel_h=None, chain=chain1), res1, noise1),
            (f"K={P_K16}", dict(k=P_K16, sel_h=P_SEL_H, chain=chain16), res16, noise16)):
        plain_loop = make_closed_loop(
            GaussianDiffusion(schedule), student, ins, cond, panda_rbd(), panda_cost(),
            horizon=pys.H, n_steps=P_CHECK, n_candidates=loop_kw["k"],
            state_to_condition=make_panda_context(), sample_override=loop_kw["chain"].plain,
            selection_horizon=loop_kw["sel_h"], noise_shape=(loop_kw["k"], pys.H, 7), device=dev)
        ref = plain_loop(xs, noise[:, :P_CHECK])
        for n in ("x_track", "u_track", "u_horizons", "stage_costs"):
            got = getattr(res, n)
            split_err = max(split_err, student_close(
                f"panda chain loop {name} {n}", got[:, :getattr(ref, n).shape[1]],
                getattr(ref, n), u_unit))
    log("panda-chain-split", t0, f"{pys.N_SEEDS} episodes from x0 = 0.3 rad as one batched loop "
        f"through ddim_chain (launches {split_launches}): K=1 {pys.N_STEPS} replans, mean cost "
        f"{costs1.mean():.6f} (yardstick {pys.MEAN10['k1']:.6f}, gaps {gaps1}, bounds "
        f"{pys.BOUNDS['k1']}); K={P_K16} sel_h {P_SEL_H} the first {P_K16_STEPS} replans, mean "
        f"cost {prefix16.mean():.6f} (yardstick {np.mean(pys.PREFIX_COSTS['k16_selh32']):.6f}, "
        f"gaps {gaps16}, bounds {pys.BOUNDS['k16_selh32']}); the first {P_CHECK} replans of each "
        f"against the loop through the plain chain {split_err:.3e} (controls {CHAIN_TOL:.0e} in "
        f"normalized units, the rest {TRACK_TOL:.0e}); {1e3 * loop1_s / pys.N_STEPS:.3f} ms per "
        f"replan at K=1 ({pys.N_SEEDS} episodes), {1e3 * loop16_s / P_K16_STEPS:.3f} at K={P_K16} by the "
        "host clock")

    # 45. the episode kernel's panda entry: K = 1 and K = 4 (sel_h 16) over the 10 episodes, each
    # one launch, then against its plain twin, and the scorer's serial arm steps
    t0 = time.perf_counter()
    ep = lambda k, sel_h, n: bench_panda_student.episode(student, k, sel_h, n, dev)
    ep1, ep4 = ep(1, None, pys.N_STEPS), ep(4, 16, pys.N_STEPS)
    noise4 = bench_panda_student.staged_noise(pys.N_SEEDS, pys.N_STEPS, 4, dev, 46)
    reset(ep1, ep4)
    out1 = [ep1.kernel(x0, noise1[i]) for i in range(pys.N_SEEDS)]
    out4 = [ep4.kernel(x0, noise4[i]) for i in range(pys.N_SEEDS)]
    torch.cuda.synchronize()
    ep_launches = counts(ep1, ep4)
    if ep_launches != [(pys.N_SEEDS, 0), (pys.N_SEEDS, 0)]:
        raise RuntimeError(f"panda episode: counts {ep_launches}, expected {pys.N_SEEDS} each")
    ecosts1 = np.array([float(o[2].double().sum()) for o in out1])
    ecosts4 = np.array([float(o[2].double().sum()) for o in out4])
    if not all(torch.isfinite(o[0]).all() for o in out1 + out4):
        raise RuntimeError("panda episode: non-finite tracks")
    egaps1, egaps4 = pys.gaps("episode", ecosts1), pys.gaps("episode_k4_selh16", ecosts4)
    if not (pys.within("episode", ecosts1) and pys.within("episode_k4_selh16", ecosts4)):
        raise RuntimeError(f"panda episode: gaps from the yardstick K=1 {egaps1}, K=4 {egaps4}; "
                           f"bounds {pys.BOUNDS['episode']}, {pys.BOUNDS['episode_k4_selh16']}")
    vs_loop = float((out1[0][0] - res1.x_track[0]).abs().max())  # the other plant: recorded
    ties, ep_err, plain_ms = [], 0.0, {}
    checks = {}
    for k, sel_h, n in ((1, None, P_EP_CHECK), (4, 16, P_EP4_CHECK)):
        e = ep(k, sel_h, n)
        nz = (noise1 if k == 1 else noise4)[0, :n]
        got = e.kernel(x0, nz)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = e.plain(x0, nz)
        torch.cuda.synchronize()
        plain_ms[k] = 1e3 * (time.perf_counter() - t1)
        ep_err = max(ep_err, episode_gate(f"ddim_episode_panda K={k}", e, got, want, u_unit, ties))
        checks[k] = (e, nz)
    e1_ms = cuda_ms(lambda: checks[1][0].kernel(x0, checks[1][1]), n=3, warmup=1)
    e4_ms = cuda_ms(lambda: checks[4][0].kernel(x0, checks[4][1]), n=3, warmup=1)
    full1_ms = cuda_ms(lambda: ep1.kernel(x0, noise1[0]), n=2, warmup=1)
    full4_ms = cuda_ms(lambda: ep4.kernel(x0, noise4[0]), n=2, warmup=1)
    sel1 = ep(4, 1, P_EP4_CHECK)
    sel1_ms = cuda_ms(lambda: sel1.kernel(x0, checks[4][1]), n=3, warmup=1)
    arm_step_ms = (e4_ms - sel1_ms) / P_EP4_CHECK / 15  # 15 more serial steps per replan
    log("panda-episode", t0, f"ddim_episode_panda over {pys.N_SEEDS} episodes (launches "
        f"{ep_launches}): K=1 mean cost {ecosts1.mean():.6f} (yardstick "
        f"{pys.MEAN10['episode']:.6f}, gaps {egaps1}, bounds {pys.BOUNDS['episode']}), K=4 sel_h "
        f"16 {ecosts4.mean():.6f} (yardstick {pys.MEAN10['episode_k4_selh16']:.6f}, gaps {egaps4}, "
        f"bounds {pys.BOUNDS['episode_k4_selh16']}); against the plain twin over {P_EP_CHECK} "
        f"(K=1) and {P_EP4_CHECK} (K=4) replans {ep_err:.3e} (controls {CHAIN_TOL:.0e} in "
        f"normalized units, the rest {TRACK_TOL:.0e}); K=1 episode vs the chain split's first "
        f"episode (panda_rbd_unrolled against panda_rbd, recorded) {vs_loop:.3e}; "
        f"{full1_ms / pys.N_STEPS:.4f} ms per replan at K=1, {full4_ms / pys.N_STEPS:.4f} at K=4 "
        f"(plain {plain_ms[1] / P_EP_CHECK:.3f} and {plain_ms[4] / P_EP4_CHECK:.3f} by the host "
        f"clock); one serial arm step of the scorer {1e3 * arm_step_ms:.2f} us (K=4 at sel_h 16 "
        f"against sel_h 1); near-ties (not gated): {len(ties)}: " + " | ".join(ties))

    # each row of the kernels line; bytes and operations of this run's inputs
    weights, meta_n = ppacked.weights.numel(), ppacked.metas[1].numel()
    seg = lambda *prefixes: sum(math.prod(shape) for name, (_, shape) in ppacked.segments.items()
                                if name.split(".")[0] in prefixes)
    film_flops = 2 * 2 * int(ppacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in student.res_blocks())
    unet_flops = 2 * (ppacked.flops_per_pass - ppacked.flops_final_1x1)
    unet_bytes = 4 * (weights - seg("films", "final1x1") + meta_n + films2.numel()
                      + unet_in[2][0].numel() + y2.numel())
    ctx1, xi1 = chain_in[tuple(GRID), 1]
    ch_flops = ppacked.flops_per_pass * ch1.n_total
    ch_bytes = 4 * (weights - seg("films") + meta_n + ch1.films(ctx1).numel() + xi1.numel()
                    + ch1.coefs.numel() + xi1.numel())
    e1 = checks[1][0]
    e_flops = P_EP_CHECK * (e1.n_total * (ppacked.flops_per_pass + film_flops / 2)
                            + PANDA_STEP_FLOPS)
    e_bytes = 4 * (weights + meta_n + e1.t_embs.numel() + checks[1][1].numel() + e1.coefs.numel()
                   + e1.consts.numel() + 14 + (P_EP_CHECK + 1) * 14 + P_EP_CHECK * 9)
    e4 = checks[4][0]
    e4_bound = bound(P_EP4_CHECK * (4 * e4.n_total * (ppacked.flops_per_pass + film_flops / 2)
                                    + (4 * 16 + 1) * PANDA_STEP_FLOPS),
                     4 * (weights + meta_n + checks[4][1].numel()))["bound_ms"]
    panda = {"model": "onpolicy_panda", "horizon": pys.H, "context_dim": 20}
    return {
        "fused_unet": {"launches": unet_launches, "max_abs_err": unet_err, "ms": unet_ms,
                       "launch_ms": unet_launch_ms, "plain_ms": unet_plain_ms,
                       **bound(unet_flops, unet_bytes), "library_ms": None, "batch": 2,
                       "b16_ms": unet16_ms, "smem_bytes": un2.smem_bytes, **panda},
        "ddim_chain": {"launches": split_launches[0][0] + split_launches[1][0],
                       "max_abs_err": chain_err, "ms": ch_ms, "plain_ms": ch_plain_ms,
                       **bound(ch_flops, ch_bytes), "library_ms": None, "times": GRID,
                       "b16_ms": ch16_ms, "grid3_ms": ch3_ms, "smem_bytes": ch1.smem_bytes,
                       "k1_cost_mean10": float(costs1.mean()), "k1_gaps": gaps1,
                       f"k{P_K16}_prefix{P_K16_STEPS}_cost_mean10": float(prefix16.mean()),
                       f"k{P_K16}_gaps": gaps16, "k1_ms_per_replan": 1e3 * loop1_s / pys.N_STEPS,
                       f"k{P_K16}_ms_per_replan": 1e3 * loop16_s / P_K16_STEPS, **panda},
        "row": {"name": "ddim_episode_panda", "route": "cuda",
                "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_episode_panda.cu",
                "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
                "entry_of": "ddim_episode", "plant": "panda_rbd", "scorer": "quadratic",
                "condition": "panda_context", "launches": ep_launches[0][0] + ep_launches[1][0],
                "max_abs_err": ep_err, "ms": e1_ms, "plain_ms": plain_ms[1],
                **bound(e_flops, e_bytes), "library_ms": None, "times": GRID,
                "replans": P_EP_CHECK, "ms_per_replan": full1_ms / pys.N_STEPS,
                "k4_ms_per_replan": full4_ms / pys.N_STEPS, "k4_bound_ms": e4_bound,
                "k4_check_ms": e4_ms, "k4_plain_ms": plain_ms[4], "arm_step_us": 1e3 * arm_step_ms,
                "cost_mean10": float(ecosts1.mean()), "gaps": egaps1,
                "k4_cost_mean10": float(ecosts4.mean()), "k4_gaps": egaps4,
                "vs_chain_split_max_abs_err": vs_loop, **panda}}


# Phases 46-48, the panda arm's CFG teacher (the JAX package's scripts/bench_highdim.py panda
# rows) on the plans in turns: kernel 1 at B = 1 and PC_B16 against its plain version, the
# samples whose chain's clip amplifies fp32 differences (found as in phase 41) left out of the
# gate, at most MK_CHAOTIC_SHARE of them, and listed; kernel 3's panda entries over PC_EP_CHECK
# replans at K = 1 and PC_EP4_CHECK at K = 4 (sel_h PC_SEL_H) against their plain twins; the
# chain split against the episode over PC_EP_CHECK replans within PC_ARM_TOL, the gap PR 22
# measured between the unrolled arm and the scanned one over 80 replans of the student; phase 48
# the mean cost of 10 draw-seeded episodes over the yardstick's first PREFIX_STEPS replans.
# (phases 46-48 took 18.2-21.5 s on an H100, over the 15 s they were given; 6-8 s of it the
# plain K = 4 episode, ~3.3 s per replan of ~9,000 eager ops per arm step)
PC_B16, PC_EP_CHECK, PC_EP4_CHECK, PC_SEL_H, PC_ARM_TOL = 16, 3, 2, 16, 1.6e-5
# bf16 at one pass at the panda shape: the plain versions of the known-wrong functions the bf16
# kernel must lie farther from than from its own plain version (on the CPU, elementwise median
# |wrong - plain|: the fp32 U-Net 4.8e-5, bf16 weights on fp32 activations 3.7e-5, the final 1x1
# conv's input left unrounded 1.8e-5 in float64, against 9.0e-6 for the correct plain version
# in float64)
PC_BF16_WRONG = ("fp32", "bf16_weights_fp32_activations", "final_1x1_input_unrounded")


class TurnsChain(FusedCfgChain):
    """The CFG chain on the plan in turns at any shape (the flagship's checks of the two plans
    against each other)."""
    _plans = (TURNS,)


def bf16_plains(chain, teacher, ctx: torch.Tensor, noise: torch.Tensor) -> dict:
    """The one-pass chain's plain versions at the panda shape on (ctx, noise): ``bf16`` its own,
    ``bf16_f64`` the same function summed in float64 (a correct version in other orders), and
    each of PC_BF16_WRONG's known-wrong functions."""
    wrong_final = bf16_conv_copy(teacher)
    wrong_final.final_conv[1]._forward_pre_hooks.clear()
    wrong_acts = bf16_conv_copy(teacher)
    for module in wrong_acts.modules():
        module._forward_pre_hooks.clear()
    model64 = bf16_conv_copy(copy.deepcopy(teacher).double())
    models = {"bf16_f64": lambda x, t, c, m: model64(x.double(), t, c.double(),
                                                     m.double()).float(),
              "fp32": teacher, "bf16_weights_fp32_activations": wrong_acts,
              "final_1x1_input_unrounded": wrong_final}
    out = {"bf16": chain.plain(ctx, noise)}
    plain_model = chain.plain_model
    try:
        for name, model in models.items():
            chain.plain_model = model
            out[name] = chain.plain(ctx, noise)
    finally:
        chain.plain_model = plain_model
    return out


def bf16_nearest_gate(got: torch.Tensor, plains: dict, wrong=PC_BF16_WRONG,
                      max_abs: float = ONE_PASS_MAX) -> dict:
    """The bf16 gate at one pass at the panda shape, where nearly every sample flips a rounding
    (two correct plain versions part by ~2.7e-4 per sample): the elementwise median |got -
    plain| at most twice the plain versions' own (bf16 against bf16_f64), smaller than to each
    known-wrong function's plain version (``wrong``, PC_BF16_WRONG by default), and every
    element within ``max_abs`` (ONE_PASS_MAX by default). Returns the readings and
    ``passed``."""
    med = lambda a, b: float((a.double() - b.double()).abs().median())
    dist = {name: med(got, want) for name, want in plains.items()}
    g = {"median_to": dist, "spread": med(plains["bf16_f64"], plains["bf16"]),
         "max": float((got.double() - plains["bf16"].double()).abs().max()), "n": got.shape[0]}
    g["passed"] = bool(torch.isfinite(got).all() and g["max"] <= max_abs
                       and dist["bf16"] <= 2 * g["spread"]
                       and all(dist["bf16"] < dist[name] for name in wrong))
    return g


def clip_moved(chain, ctx: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The plain CFG chain with every eps moved by a relative 1e-6 (a fixed sign pattern): the
    samples it moves past CHAIN_TOL / 10 are those whose chain's clip amplifies fp32 differences
    (phase 41's test)."""
    plain_model = chain.plain_model
    rows = 2 * ctx.shape[0]
    n = rows * chain.packed.horizon * chain.packed.state_dim
    signs = torch.sign(torch.sin(torch.arange(n, device=ctx.device, dtype=torch.float32)))
    signs = signs.reshape(rows, chain.packed.horizon, chain.packed.state_dim)
    chain.plain_model = lambda x, t, c, m: plain_model(x, t, c, m) * (1 + 1e-6 * signs)
    try:
        return chain.plain(ctx, noise)
    finally:
        chain.plain_model = plain_model


def panda_cfg_phases(dev) -> dict:
    """Phases 46-48 on ``dev``: the panda arm's CFG teacher (kernel 1 in turns at horizon 128 in
    fp32 and bf16, kernel 3's panda entries staged and drawing, the chain split, the teacher's
    quality against the JAX package's yardstick), and kernel 1's plan in turns on the flagship
    against its two-row-set kernel. Returns the kernels line's rows: ``panda`` and
    ``flagship_turns`` under the CFG chain, ``cfg_episode_panda`` a row of its own with its draw
    entry under ``inkernel_noise``."""
    dev = resolve_device(dev)
    schedule = make_schedule("exponential", T)
    ins, cond = (st.to(dev) for st in panda_stats())
    u_unit = 0.5 * (ins.maxs - ins.mins)
    x0 = torch.from_numpy(tys.x0()).to(dev)
    gen = torch.Generator(device=dev).manual_seed(46)
    # 46. kernel 1 at the panda shape in turns, fp32 and bf16, and on the flagship beside its
    # two-row-set kernel
    t0 = time.perf_counter()
    teacher = load_panda_teacher(tys.TEACHER, device=dev)
    chains = {b: bench_highdim.panda_chain(teacher, b, dev) for b in (1, PC_B16)}
    tpacked = chains[1].packed
    ctx0 = normalize(cond, make_panda_context()(x0))[None]
    chain_err, n_checked, chaotic, chain_in = 0.0, 0, [], {}
    marks = {"load": time.perf_counter() - t0}  # seconds since the phase began, for its log
    for b, ch in chains.items():
        if (ch.plan, ch.entry, ch.smem_bytes) != (TURNS, "cfg_chain_turns",
                                                  tpacked.chain_smem_bytes(TURNS)):
            raise RuntimeError(f"the panda CFG chain chose {ch.plan}, {ch.entry}, {ch.smem_bytes} B")
        ctx = torch.cat([ctx0, torch.rand((b - 1, 20), generator=gen, device=dev) * 2 - 1])
        noise = torch.randn((ch.n_total + 1, b, tys.H, 7), generator=gen, device=dev)
        got, want = ch.kernel(ctx, noise), ch.plain(ctx, noise)
        torch.cuda.synchronize()
        chaos = (clip_moved(ch, ctx, noise) - want).abs().flatten(1).amax(1) > CHAIN_TOL / 10
        calm = ~chaos
        chain_err = max(chain_err, assert_close(
            f"cfg_chain_turns H=128 B={b}, the {int(calm.sum())} calm samples", got[calm],
            want[calm], CHAIN_TOL))
        chaotic += [f"B={b} sample {i}: {float((got[i] - want[i]).abs().max()):.3e}"
                    for i in chaos.nonzero().flatten().tolist()]
        n_checked += b
        chain_in[b] = (ctx, noise)
        marks[f"b{b}"] = time.perf_counter() - t0
    if len(chaotic) > MK_CHAOTIC_SHARE * n_checked:
        raise RuntimeError(f"cfg_chain_turns: {len(chaotic)} chaotic samples of {n_checked}: "
                           f"{chaotic}")
    fmodel = load_flagship(FLAGSHIP, device=dev)
    two = make_fused_cfg_chain(fmodel, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    turns = TurnsChain(two.packed, schedule, 1, W, N_TAIL)
    if (two.plan, two.entry, turns.plan, turns.entry) != (2, "cfg_chain", TURNS, "cfg_chain_turns"):
        raise RuntimeError(f"the flagship's chains chose {two.entry}, {turns.entry}")
    # bf16 at one pass: PR 13's rule (phase 19) where it tells a correct kernel from a wrong one,
    # the flagship's shape, on the same entry in turns; at the panda shape nearly every sample
    # sees a flipped rounding, so there the entry must lie nearer its own plain version than the
    # known-wrong functions' (bf16_nearest_gate), and the fp32 entry's output, put through the
    # same gate as a control, must fail it
    bf16 = torch.bfloat16
    bf = bench_highdim.panda_chain(teacher, 1, dev, bf16)
    sched1 = make_schedule("exponential", 1)  # one step: u_norm = clip(x - 0.01 eps_cfg)
    one_gate = {}
    for name, packed, cdim, h, d in (("flagship", two.packed, 5, HORIZON, 1),
                                     ("panda", tpacked, 20, tys.H, 7)):
        one = TurnsChain(packed, sched1, N_ONE_PASS, W, 0, weights_dtype=bf16)
        if one.entry != "cfg_chain_turns_bf16" or (name == "panda" and bf.entry != one.entry):
            raise RuntimeError(f"the {name} bf16 chain chose {one.entry}, {bf.entry}")
        ctx_one = torch.rand((N_ONE_PASS, cdim), generator=gen, device=dev) * 2 - 1
        noise_one = torch.randn((2, N_ONE_PASS, h, d), generator=gen, device=dev)
        got = one.kernel(ctx_one, noise_one)
        torch.cuda.synchronize()
        if name == "flagship":
            one_gate[name] = one_pass_gate("cfg_chain_turns_bf16 one pass, flagship", got,
                                           one.plain(ctx_one, noise_one))
            continue
        plains = bf16_plains(one, teacher, ctx_one, noise_one)
        one32 = TurnsChain(packed, sched1, N_ONE_PASS, W, 0)
        control = bf16_nearest_gate(one32.kernel(ctx_one, noise_one), plains)
        g = bf16_nearest_gate(got, plains)
        one_gate[name], one_gate["panda_control_fp32_entry"] = g, control
        if not g["passed"] or control["passed"]:
            raise RuntimeError(f"cfg_chain_turns_bf16 one pass, panda: {g}; the fp32 entry "
                               f"through the same gate (must fail): {control}")
    bf_got = bf.kernel(*chain_in[1])
    torch.cuda.synchronize()
    # full depth: the flips cascade, so the bound is JAX's own of bf16 against fp32 (phase 19's)
    bf_full = assert_close("cfg_chain_turns_bf16 full depth B=1", bf_got, bf.plain(*chain_in[1]),
                           BF16_VS_FP32)
    # the counted run of each chain in turns on a main path: the teacher's chain-split loop
    # through the bf16 entry (beside the fp32 one) and the flagship's per-replan loop through
    # its entry in turns (beside its two-row-set kernel), the counts set to 0 just before
    snz = torch.randn((PC_EP_CHECK, chains[1].n_total + 1, 1, tys.H, 7), generator=gen,
                      device=dev)
    fplant, fcost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    fins = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0)).to(dev)
    fcond = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0)).to(dev)
    floop = lambda chain: make_closed_loop(
        GaussianDiffusion(schedule), fmodel, fins, fcond, fplant, fcost, horizon=HORIZON,
        n_steps=PC_EP_CHECK, w=W, n_diffusion_steps_without_noise=N_TAIL,
        sample_override=chain, device=dev)
    fx0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    fnz = torch.randn((PC_EP_CHECK, two.n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    bsplit = bench_highdim.panda_chain_loop(teacher, PC_EP_CHECK, 1, dev, bf)
    fsplit = bench_highdim.panda_chain_loop(teacher, PC_EP_CHECK, 1, dev, chains[1])
    reset(bf, chains[1], turns, two)
    r_bf, r_fp = bsplit(x0, snz), fsplit(x0, snz)
    r_turns, r_two = floop(turns)(fx0, fnz), floop(two)(fx0, fnz)
    torch.cuda.synchronize()
    loop_counts = counts(bf, chains[1], turns, two)
    if loop_counts != [(PC_EP_CHECK, 0)] * 4:
        raise RuntimeError(f"the chains' counted loops: counts {loop_counts}")
    f_loop_err = 0.0
    for name in ("x_track", "u_track", "stage_costs"):
        if not torch.isfinite(getattr(r_bf, name)).all():
            raise RuntimeError(f"the teacher's chain split through {bf.entry}: non-finite {name}")
        f_loop_err = max(f_loop_err, assert_close(
            f"the flagship's loop in turns against two row-sets {name}", getattr(r_turns, name),
            getattr(r_two, name), TRACK_TOL))
    bf_loop_du = float(((r_bf.u_track - r_fp.u_track) / u_unit).abs().max())  # recorded
    marks["bf16"] = time.perf_counter() - t0
    ch1 = chains[1]  # every wrapper below has run once: the timings need no warm-up
    ch_ms = cuda_ms(lambda: ch1.kernel(*chain_in[1]), n=5, warmup=0)
    ch16_ms = cuda_ms(lambda: chains[PC_B16].kernel(*chain_in[PC_B16]), n=2, warmup=0)
    bf_ms = cuda_ms(lambda: bf.kernel(*chain_in[1]), n=5, warmup=0)
    ch_plain_ms = cuda_ms(lambda: ch1.plain(*chain_in[1]), n=1, warmup=0)
    bf_plain_ms = cuda_ms(lambda: bf.plain(*chain_in[1]), n=1, warmup=0)
    fctx = torch.randn((1, 5), generator=gen, device=dev)
    fnoise = torch.randn((two.n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    f_two, f_turns = two.kernel(fctx, fnoise), turns.kernel(fctx, fnoise)
    torch.cuda.synchronize()
    f_plain = turns.plain(fctx, fnoise)
    flag_err = max(assert_close("flagship cfg_chain_turns vs cfg_chain", f_turns, f_two, CHAIN_TOL),
                   assert_close("flagship cfg_chain_turns vs plain", f_turns, f_plain, CHAIN_TOL))
    flag_ms = {"cfg_chain": [], "cfg_chain_turns": []}
    for w_ in (two, turns, turns, two):  # in turns
        flag_ms[w_.entry].append(cuda_ms(lambda: w_.kernel(fctx, fnoise), n=10, warmup=1))
    f_plain_ms = cuda_ms(lambda: turns.plain(fctx, fnoise), n=1, warmup=0)
    marks["timing"] = time.perf_counter() - t0
    log("panda-cfg-chain", t0, f"the teacher at H=128: {ch1.entry} on the plan in turns "
        f"({ch1.smem_bytes} B per CTA; two row-sets {tpacked.chain_smem_bytes(2)} B) max |kernel - "
        f"plain| {chain_err:.3e} over the calm samples at B = 1 and {PC_B16} (tol "
        f"{CHAIN_TOL:.0e}); chaotic samples (left out, at most {MK_CHAOTIC_SHARE:.0%}): "
        f"{len(chaotic)} of {n_checked} {chaotic}; {bf.entry} one pass on the flagship "
        f"{fmt_gate(one_gate['flagship'])}, at the panda shape {one_gate['panda']}, the fp32 entry "
        f"through the same gate (fails, as it must) {one_gate['panda_control_fp32_entry']} (gate: "
        f"every element within {ONE_PASS_MAX:.0e}, the elementwise median to the plain version "
        f"at most twice the spread and below that to each of {PC_BF16_WRONG}), full depth B=1 "
        f"{bf_full:.3e} (tol {BF16_VS_FP32:.0e}); counted loops {loop_counts} (the teacher's "
        f"chain split through {bf.entry} and {ch1.entry}, {PC_EP_CHECK} replans, bf16 against "
        f"fp32 {bf_loop_du:.3e} in u_norm, recorded; the flagship's loop through "
        f"cfg_chain_turns against cfg_chain {f_loop_err:.3e}, tol {TRACK_TOL:.0e}); "
        f"{ch_ms:.4f} ms per replan at B=1, "
        f"{ch16_ms:.4f} at B={PC_B16}, bf16 {bf_ms:.4f} (plain {ch_plain_ms:.3f}, bf16 "
        f"{bf_plain_ms:.3f}); the flagship in turns against its two-row-set kernel "
        f"{flag_err:.3e} (and against plain), ms in turns (two, turns, turns, two): "
        f"{flag_ms['cfg_chain'][0]:.4f}, {flag_ms['cfg_chain_turns'][0]:.4f}, "
        f"{flag_ms['cfg_chain_turns'][1]:.4f}, {flag_ms['cfg_chain'][1]:.4f}; seconds into the "
        f"phase: {marks}")

    # 47. kernel 3's panda entries against their plain twins; the chain split against the episode
    t0 = time.perf_counter()
    ep_of = lambda k, sel_h, n, draw=False: make_fused_cfg_episode(
        tpacked, schedule, ins, cond, panda_rbd_unrolled(), panda_cost(), n_steps=n, w=W,
        n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, selection_horizon=sel_h,
        state_to_condition=make_panda_context(), inkernel_noise=draw, device=dev)
    ties, ep_err, plain_ms, checks = [], 0.0, {}, {}
    marks = {}
    for k, sel_h, n in ((1, None, PC_EP_CHECK), (4, PC_SEL_H, PC_EP4_CHECK)):
        e = ep_of(k, sel_h, n)
        if (e.name, e.plan) != ("cfg_episode_panda", TURNS):
            raise RuntimeError(f"the panda CFG episode chose {e.name}, {e.plan}")
        nz = torch.randn(e.noise_shape, generator=gen, device=dev)
        got = e.kernel(x0, nz)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = e.plain(x0, nz)
        torch.cuda.synchronize()
        plain_ms[k] = 1e3 * (time.perf_counter() - t1)
        ep_err = max(ep_err, episode_gate(f"cfg_episode_panda K={k}", e, got, want, u_unit, ties))
        checks[k] = (e, nz)
        marks[f"k{k}"] = time.perf_counter() - t0
    d1 = ep_of(1, None, PC_EP_CHECK, True)
    seed = philox.seed_from_generator(torch.Generator().manual_seed(47)).to(dev)
    dgot, dgot2 = d1.kernel(x0, seed), d1.kernel(x0, seed)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(dgot, dgot2)):
        raise RuntimeError("cfg_episode_panda_draw: one seed gave two different episodes")
    t1 = time.perf_counter()
    dwant = d1.plain(x0, seed)
    torch.cuda.synchronize()
    plain_ms["draw"] = 1e3 * (time.perf_counter() - t1)
    draw_err = episode_gate("cfg_episode_panda_draw K=1", d1, dgot, dwant, u_unit, ties)
    marks["draw"] = time.perf_counter() - t0
    e1, nz1 = checks[1]
    split_chain = bench_highdim.panda_chain(teacher, 1, dev)
    split = bench_highdim.panda_chain_loop(teacher, PC_EP_CHECK, 1, dev, split_chain)
    reset(split_chain, e1)
    res = split(x0, nz1)
    ep_out = e1.kernel(x0, nz1)
    torch.cuda.synchronize()
    split_counts = counts(split_chain, e1)
    if split_counts != [(PC_EP_CHECK, 0), (1, 0)]:
        raise RuntimeError(f"panda chain split and episode: counts {split_counts}")
    arm_err = max(float((res.x_track - ep_out[0]).abs().max()),
                  float(((res.u_track - ep_out[1]) / u_unit).abs().max()))
    if not arm_err <= PC_ARM_TOL:
        raise RuntimeError(f"the panda chain split against the episode: {arm_err:.3e} > "
                           f"{PC_ARM_TOL:.1e}")
    marks["split"] = time.perf_counter() - t0
    e1_ms = cuda_ms(lambda: e1.kernel(x0, nz1), n=2, warmup=0)
    e4, nz4 = checks[4]
    e4_ms = cuda_ms(lambda: e4.kernel(x0, nz4), n=2, warmup=0)
    d1_ms = cuda_ms(lambda: d1.kernel(x0, seed), n=2, warmup=0)
    log("panda-cfg-episode", t0, f"cfg_episode_panda on the plan in turns ({e1.smem_bytes} B per "
        f"CTA at K = 1, {e4.smem_bytes} at K = 4) against its plain twin over {PC_EP_CHECK} (K=1) "
        f"and {PC_EP4_CHECK} (K=4, sel_h {PC_SEL_H}) replans {ep_err:.3e}, "
        f"cfg_episode_panda_draw over {PC_EP_CHECK} against the plain episode on the Philox table "
        f"{draw_err:.3e} (controls {CHAIN_TOL:.0e} in normalized units, the rest {TRACK_TOL:.0e}), "
        f"one seed twice the same bits; the chain split (launches {split_counts}) against the "
        f"episode {arm_err:.3e} (tol {PC_ARM_TOL:.1e}); {e1_ms / PC_EP_CHECK:.4f} ms per replan at "
        f"K=1, {e4_ms / PC_EP4_CHECK:.4f} at K=4, drawing {d1_ms / PC_EP_CHECK:.4f} (plain "
        f"{plain_ms[1] / PC_EP_CHECK:.3f}, {plain_ms[4] / PC_EP4_CHECK:.3f}, "
        f"{plain_ms['draw'] / PC_EP_CHECK:.3f} by the host clock); seconds into the phase: "
        f"{marks}; near-ties (not gated): {len(ties)}: " + " | ".join(ties))

    # 48. the teacher's quality: 10 draw-seeded episodes over the yardstick's first PREFIX_STEPS
    t0 = time.perf_counter()
    ep20 = ep_of(1, None, tys.PREFIX_STEPS, True)
    seeds = bench_highdim.draw_seeds(tys.N_SEEDS, tys.PAIRED_SEED_BASE, dev)
    reset(ep20)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t1 = time.perf_counter()
    ev[0].record()
    outs = [ep20(x0, sd) for sd in seeds]
    ev[1].record()
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t1
    q_counts = counts(ep20)
    if q_counts != [(tys.N_SEEDS, 0)]:
        raise RuntimeError(f"panda teacher quality: counts {q_counts}")
    if not all(torch.isfinite(o[0]).all() and torch.isfinite(o[1]).all() for o in outs):
        raise RuntimeError("panda teacher quality: non-finite tracks")
    prefix = np.array([float(o[2].double().sum()) for o in outs])
    gaps = tys.gaps("episode", None, prefix)
    pgaps = tys.paired_gaps(prefix)
    if not (tys.within("episode", None, prefix) and tys.paired_within(prefix)):
        raise RuntimeError(f"panda teacher quality: the mean cost of the first {tys.PREFIX_STEPS} "
                           f"replans {prefix.mean():.6f}, gaps {gaps}, bounds "
                           f"{tys.BOUNDS['episode']}; each episode's gap from the plain episode "
                           f"on the CPU {pgaps} (bound {tys.PAIRED_BOUND:.3e})")
    e20_ms = ev[0].elapsed_time(ev[1]) / tys.N_SEEDS  # per 20-replan episode, by CUDA events
    # the control: the same path at w = 0 on the first seed must fail the paired gate (on the
    # CPU it moved that episode by 6.2e-3, the most of the 10)
    ctl = make_fused_cfg_episode(
        tpacked, schedule, ins, cond, panda_rbd_unrolled(), panda_cost(),
        n_steps=tys.PREFIX_STEPS, w=0.0, n_diffusion_steps_without_noise=N_TAIL,
        state_to_condition=make_panda_context(), inkernel_noise=True, device=dev)
    ctl_gap = abs(float(ctl(x0, seeds[0])[2].double().sum()) - tys.PAIRED_PREFIX[0])
    if not ctl_gap > tys.PAIRED_BOUND:
        raise RuntimeError(f"panda teacher quality: w = 0 lies {ctl_gap:.3e} from the plain "
                           f"episode at w = {W}, within the paired bound {tys.PAIRED_BOUND:.3e}")
    log("panda-teacher-quality", t0, f"{tys.N_SEEDS} draw-seeded episodes of "
        f"{tys.PREFIX_STEPS} replans through cfg_episode_panda_draw (launches {q_counts}): mean "
        f"cost {prefix.mean():.6f} (yardstick {tys.PREFIX_MEAN10['episode']:.6f}, gaps {gaps}, "
        f"bounds {tys.BOUNDS['episode']}); each episode against the port's plain episode on the "
        f"CPU on the same seed (the paired gate, bound {tys.PAIRED_BOUND:.3e}): max gap "
        f"{max(pgaps):.3e}, gaps {[float(f'{g:.3e}') for g in pgaps]}; the control (w = 0, the "
        f"first seed) {ctl_gap:.3e} from it, outside the bound as it must be; "
        f"{e20_ms / tys.PREFIX_STEPS:.4f} ms per replan, {q_s:.3f} s for the 10 by the host "
        f"clock")

    # each row of the kernels line; bytes and operations of this run's inputs
    weights, meta_n = tpacked.weights.numel(), tpacked.metas[1].numel()
    seg = lambda *prefixes: sum(math.prod(shape) for name, (_, shape) in tpacked.segments.items()
                                if name.split(".")[0] in prefixes)
    film_flops = 2 * 2 * int(tpacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in teacher.res_blocks())
    ch_flops = tpacked.flops_per_pass * 2 * ch1.n_total
    ctx1, nz_c = chain_in[1]
    ch_bytes = 4 * (weights - seg("films") + meta_n + ch1.films(ctx1).numel() + nz_c.numel()
                    + ch1.coefs.numel() + tys.H * 7)
    conv_w = sum(math.prod(tpacked.segments[name][1])
                 for name in [*bf.cluster.split.convs, "final1x1.w"])
    replan_flops = ch1.n_total * (2 * tpacked.flops_per_pass + film_flops) + PANDA_STEP_FLOPS
    ep_bytes = lambda e, n, noise_n: 4 * (weights + meta_n + e.t_embs.numel() + noise_n
                                          + e.coefs.numel() + e.consts.numel() + 14
                                          + (n + 1) * 14 + n * 9)
    fp = two.packed
    f_flops = fp.flops_per_pass * 2 * two.n_total
    f_bytes = 4 * (fp.weights.numel() - sum(math.prod(shape) for name, (_, shape)
                                            in fp.segments.items() if name.startswith("films"))
                   + fp.metas[1].numel() + two.films(fctx).numel() + fnoise.numel()
                   + two.coefs.numel() + HORIZON)
    panda = {"model": "flagship_panda_rbd", "horizon": tys.H, "context_dim": 20}
    src = "mpc_via_diffusion_model_tpu_torch/ops/csrc/"
    chain_row = {"name": "cfg_chain_turns", "route": "cuda",
                 "source": src + "cfg_chain_turns.cu",
                 "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47"}
    return {
        "cfg_chain": {
            **chain_row, "launches": split_counts[0][0], "max_abs_err": chain_err, "ms": ch_ms,
            "plain_ms": ch_plain_ms, **bound(ch_flops, ch_bytes), "library_ms": None,
            "plan": TURNS, "smem_bytes": ch1.smem_bytes, "b16_ms": ch16_ms,
            "chaotic_samples": chaotic, "checked_samples": n_checked, **panda,
            "bf16": {**chain_row, "name": bf.entry, "launches": loop_counts[0][0],
                     "max_abs_err": one_gate["panda"]["max"],
                     "ms": bf_ms, "plain_ms": bf_plain_ms,
                     **bound(0, ch_bytes - 2 * conv_w, bf16_flops=ch_flops), "library_ms": None,
                     "one_pass": one_gate, "full_depth_max_abs_err": bf_full,
                     "chain_split_du_vs_fp32": bf_loop_du, "weights_dtype": "bfloat16"}},
        "flagship_turns": {
            **chain_row, "launches": loop_counts[2][0], "max_abs_err": flag_err,
            "ms": statistics.mean(flag_ms["cfg_chain_turns"]), "plain_ms": f_plain_ms,
            **bound(f_flops, f_bytes), "library_ms": None, "ms_in_turns": flag_ms,
            "smem_bytes": turns.smem_bytes, "two_row_set_smem_bytes": two.smem_bytes,
            "loop_vs_two_row_sets_max_abs_err": f_loop_err,
            "model": "flagship", "horizon": HORIZON},
        "row": {
            "name": "cfg_episode_panda", "route": "cuda", "source": src + "cfg_episode_panda.cu",
            "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
            "entry_of": "cfg_episode", "plant": "panda_rbd", "scorer": "quadratic",
            "condition": "panda_context", "launches": split_counts[1][0], "max_abs_err": ep_err,
            "ms": e1_ms, "plain_ms": plain_ms[1],
            **bound(PC_EP_CHECK * replan_flops, ep_bytes(e1, PC_EP_CHECK, nz1.numel())),
            "library_ms": None, "replans": PC_EP_CHECK, "plan": TURNS, "smem_bytes": e1.smem_bytes,
            "k4_ms_per_replan": e4_ms / PC_EP4_CHECK, "k4_plain_ms": plain_ms[4],
            "k4_smem_bytes": e4.smem_bytes, "vs_chain_split_max_abs_err": arm_err, **panda,
            "inkernel_noise": {
                "name": "cfg_episode_panda_draw", "route": "cuda",
                "source": src + "cfg_episode_panda.cu",
                "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
                "launches": q_counts[0][0], "max_abs_err": draw_err, "ms": d1_ms,
                "plain_ms": plain_ms["draw"],
                **bound(PC_EP_CHECK * replan_flops, ep_bytes(d1, PC_EP_CHECK, 2)),
                "library_ms": None, "replans": PC_EP_CHECK,
                "ms_per_replan": e20_ms / tys.PREFIX_STEPS,
                f"prefix{tys.PREFIX_STEPS}_cost_mean10": float(prefix.mean()), "gaps": gaps,
                "paired_max_gap": max(pgaps), "paired_bound": tys.PAIRED_BOUND,
                "control_w0_gap": ctl_gap}}}


# Phases 49-50 (ROADMAP B1): bf16 weights in kernels 2, 4 and 5 at one pass on the flagship's
# shape and the panda arm's, and clip_denoised=False in kernels 1, 3, 4 and 5. The distilled
# panda student (round 2 of the JAX package's scripts/distill_panda.py, grid [23, 15, 7]) carries
# the panda shape; B1_EP replans for the episode checks at full depth and without the clip.
DISTILLED_PANDA = ROOT / "artifacts" / "distilled_panda" / "student_3eval.pkl"
B1_EP, B1_PANDA_ONE_PASS, B1_CLIP_SCALE, B1_TIMED_EP = 3, 16, 3.0, 10
CLIP_REPLACES = {"cfg_chain": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47",
                 "cfg_episode": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
                 "ddim_chain": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:164",
                 "ddim_episode": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142"}
# the known-wrong functions of the bf16 gate: kernel 2 runs its final 1x1 conv outside the
# kernel in fp32 on an unrounded y (JAX fused_unet.py:450), kernels 4 and 5 inside it in bf16 on
# a rounded y (fused_denoise.py:213, fused_episode.py:339): each is held off the other's choice
# kernel 2's elementwise bound on raw eps at phase 49's shapes: twice the largest gap of its
# plain version (bf16_conv_copy(model, False)) from the same function summed in float64 on the
# CPU, 4 seeds of 64 rows (distill_panda_divergence --unet-pass: flagship 1.296e-2, panda 3.600e-2)
UNET_BF16_ONE_PASS_MAX = {"flagship": 2.6e-2, "panda": 7.2e-2}
B1_WRONG = {"fused_unet": ("fp32", "bf16_weights_fp32_activations", "final_1x1_rounded"),
            "ddim": ("fp32", "bf16_weights_fp32_activations", "final_1x1_fp32")}


def bf16_variants(model, final_rounded: bool) -> dict:
    """The U-Nets of phase 49's gate, each ``(x, t, context, mask) -> eps``: ``bf16`` the right
    function (bf16 convs; the final 1x1 conv rounded too where ``final_rounded``), ``bf16_f64``
    the same summed in float64 (a right version in other orders), and the known-wrong functions
    of B1_WRONG: the fp32 U-Net, bf16 weights on fp32 activations, and the right one with its
    final 1x1 conv the other way."""
    acts = bf16_conv_copy(model, final_rounded)
    for module in acts.modules():
        module._forward_pre_hooks.clear()
    m64 = bf16_conv_copy(copy.deepcopy(model).double(), final_rounded)
    return {"bf16": bf16_conv_copy(model, final_rounded),
            "bf16_f64": lambda x, t, c, m: m64(x.double(), t, c.double(), m.double()).float(),
            "fp32": model, "bf16_weights_fp32_activations": acts,
            "final_1x1_fp32" if final_rounded else "final_1x1_rounded":
                bf16_conv_copy(model, not final_rounded)}


def ddim_first_controls(ep, model, schedule, times, states: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """Each replan's applied control of a K = 1 DDIM episode ``ep``, computed by the plain chain
    with the U-Net ``model`` from the state ``states[s]`` and the draw ``noise[s]``, all replans
    as one batch: the episode's arithmetic at the kernel's own states, so that a flipped bf16
    rounding in one replan does not carry into the next."""
    c, dc, du = ep.consts, ep.context_dim, ep.plant.control_dim
    to_cond = ep.state_to_condition or (lambda v: v)
    ctx = (to_cond(states) - c[:dc]) * c[dc:2 * dc]
    u = make_student_ddim_sampler(schedule, model, times, ep.clip_denoised)(ctx, noise[:, 0])
    return (torch.clamp(u, -1.0, 1.0) * c[2 * dc + du:2 * dc + 2 * du] + c[2 * dc:2 * dc + du])[:, 0]


def ddim_recon_share(model, schedule, times, ctx: torch.Tensor, x_init: torch.Tensor) -> float:
    """The share of the DDIM chain's x0 reconstructions sra x - srm eps beyond [-1, 1] on (ctx,
    x_init) with the clip off: where the clip would bind."""
    tab = ddim_affine_coefs(schedule, times)
    x, mask, beyond, n = x_init, torch.zeros((ctx.shape[0], 1), device=ctx.device), 0, 0
    with torch.no_grad():
        for i, t in enumerate(tab["t"].tolist()):
            eps = model(x, torch.full((ctx.shape[0],), t, device=ctx.device), ctx, mask)
            rec = float(tab["sra"][i]) * x - float(tab["srm"][i]) * eps
            beyond, n = beyond + int((rec.abs() > 1).sum()), n + rec.numel()
            x = float(tab["c1"][i]) * rec + float(tab["c2"][i]) * x
    return beyond / n


def cfg_recon_share(chain, ctx: torch.Tensor, noise: torch.Tensor) -> float:
    """The same share for the CFG chain ``chain`` (its plain version's arithmetic, the clip off):
    the CFG combination of the two reconstructions at every step."""
    b, w = ctx.shape[0], chain.w
    ctx2 = torch.cat([ctx, ctx])
    mask2 = torch.cat([torch.zeros((b, 1), device=ctx.device), torch.ones((b, 1), device=ctx.device)])
    x, beyond, n = noise[0], 0, 0
    with torch.no_grad():
        for si in range(chain.n_total):
            sra, srm, c1, c2, sg = chain.coefs[si]
            x2 = torch.cat([x, x])
            r2 = sra * x2 - srm * chain.plain_model(x2, chain.t_eff[si].expand(2 * b), ctx2, mask2)
            rec = (1.0 + w) * r2[:b] - w * r2[b:]
            beyond, n = beyond + int((rec.abs() > 1).sum()), n + rec.numel()
            x = c1 * rec + c2 * x + sg * noise[si + 1]
    return beyond / n


@torch.no_grad()
def b1_phases(dev) -> dict:
    """Phase 49 on ``dev``: the bf16 entries of kernels 2, 4 and 5 at one pass on the
    flagship's shape and the panda arm's, each through its gate with its fp32 entry as the
    control that must fail it, and at full depth. Returns the gates' readings, the times, the
    launches and the timed wrappers (``fused_unet_bf16``, ``ddim_chain_bf16``,
    ``ddim_episode_bf16``, ``ddim_episode_panda_bf16``)."""
    dev = resolve_device(dev)
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(49)
    schedule, sched1 = make_schedule("exponential", T), make_schedule("exponential", 1)
    t0 = time.perf_counter()
    flagship = load_flagship(FLAGSHIP, device=dev)
    student = load_student(STUDENT, device=dev)
    pstudent = load_panda_student(DISTILLED_PANDA, device=dev)
    fins, fcond = (st.to(dev) for st in teacher_stats())
    pins, pcond = (st.to(dev) for st in panda_stats())
    fx0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    shapes = {  # the unet of kernel 2, the student of kernels 4 and 5, and the episode's plant
        "flagship": dict(unet=flagship, student=student, plant=cartpole_virtual_swingup(),
                         cost=cartpole_virtual_collect_cost(), ins=fins, cond=fcond, cmap=None,
                         x0=fx0, h=HORIZON, d=1, c=5, n_ep=N_ONE_PASS),
        "panda": dict(unet=pstudent, student=pstudent, plant=panda_rbd_unrolled(),
                      cost=panda_cost(), ins=pins, cond=pcond, cmap=make_panda_context(),
                      x0=torch.from_numpy(pys.x0()).to(dev), h=pys.H, d=7, c=20,
                      n_ep=B1_PANDA_ONE_PASS)}
    gates, wrappers, expected, objs, failures = {}, [], [], {}, []

    def gate(name, kind, got, plains, got_control, plains_control=None, max_abs=ONE_PASS_MAX):
        """The bf16 entry's ``bf16_nearest_gate`` and, as the control that must fail it, the
        fp32 entry's (against its own plain versions where given), with phase 19's
        ``one_pass_gate`` read beside it and recorded, not gated: at the flagship's shape the
        DDIM chain's one-step outputs flip a rounding in over half the samples (per-sample max
        median 5.7e-6 against its 5e-6 on the H100), at the panda's nearly every sample does.
        A failure is raised once every gate of the phase has been read."""
        g = bf16_nearest_gate(got, plains, B1_WRONG[kind], max_abs)
        ctl = bf16_nearest_gate(got_control, plains_control or plains, B1_WRONG[kind], max_abs)
        for reading, a, b in ((g, got, plains), (ctl, got_control, plains_control or plains)):
            try:
                reading["one_pass"] = fmt_gate(one_pass_gate(name, a, b["bf16"]))
                reading["one_pass_passed"] = True
            except RuntimeError as e:
                reading["one_pass"], reading["one_pass_passed"] = str(e), False
        if not g["passed"] or ctl["passed"]:
            failures.append(name)
        gates[name] = {**g, "control_fp32_entry": ctl}

    # 49. one pass
    for shape, s in shapes.items():
        n, h, d, c = N_ONE_PASS, s["h"], s["d"], s["c"]
        # kernel 2: one U-Net pass at batch N_ONE_PASS, half the rows masked
        un = make_fused_unet(s["unet"], n, weights_dtype=bf16, device=dev)
        un32 = make_fused_unet(un.packed, n, device=dev)
        x = torch.randn((n, h, d), generator=gen, device=dev)
        t = torch.randint(0, T, (n,), generator=gen, device=dev)
        ctx = torch.rand((n, c), generator=gen, device=dev) * 2 - 1
        mask = (torch.rand((n, 1), generator=gen, device=dev) < 0.5).float()
        reset(un, un32)
        got, got32 = un.kernel(x, t, ctx, mask), un32.kernel(x, t, ctx, mask)
        torch.cuda.synchronize()
        wrappers += [un, un32]
        expected += [(1, 0), (1, 0)]
        objs[shape] = {"unet_args": (x, t, ctx, mask)}
        plains = {k: f(x, t, ctx, mask) for k, f in bf16_variants(s["unet"], False).items()}
        gate(f"fused_unet_bf16 {shape}", "fused_unet", got, plains, got32,
             max_abs=UNET_BF16_ONE_PASS_MAX[shape])
        objs[shape]["packed"] = un.packed
        # kernel 4: the chain on the one-step grid [0], u = clip(sra x - srm eps)
        ch = make_fused_ddim_chain(s["student"], sched1, [0], n, weights_dtype=bf16, device=dev)
        ch32 = make_fused_ddim_chain(ch.packed, sched1, [0], n, device=dev)
        objs[shape]["spacked"] = ch.packed
        x_init = torch.randn((n, h, d), generator=gen, device=dev)
        reset(ch, ch32)
        got, got32 = ch.kernel(ctx, x_init), ch32.kernel(ctx, x_init)
        torch.cuda.synchronize()
        wrappers += [ch, ch32]
        expected += [(1, 0), (1, 0)]
        plains = {k: make_student_ddim_sampler(sched1, f, [0])(ctx, x_init)
                  for k, f in bf16_variants(s["student"], True).items()}
        gate(f"ddim_chain_bf16 {shape}", "ddim", got, plains, got32)
        # kernel 5: an episode of one-step chains; each replan's control against the plain
        # chain's from the kernel's own states
        ep_of = lambda n_steps, times, sched, wd=torch.float32: make_fused_ddim_episode(
            ch.packed, sched, times, s["ins"], s["cond"], s["plant"], s["cost"], n_steps=n_steps,
            weights_dtype=wd, state_to_condition=s["cmap"], device=dev)
        ep, ep32 = ep_of(s["n_ep"], [0], sched1, bf16), ep_of(s["n_ep"], [0], sched1)
        nz = torch.randn(ep.noise_shape, generator=gen, device=dev)
        reset(ep, ep32)
        got, got32 = ep.kernel(s["x0"], nz), ep32.kernel(s["x0"], nz)
        torch.cuda.synchronize()
        wrappers += [ep, ep32]
        expected += [(1, 0), (1, 0)]
        u_unit = 0.5 * (s["ins"].maxs - s["ins"].mins)
        variants = bf16_variants(s["student"], True)
        first = lambda states: {k: ddim_first_controls(ep, f, sched1, [0], states, nz) / u_unit
                                for k, f in variants.items()}
        gate(f"{ep.name} {shape}", "ddim", got[1] / u_unit, first(got[0][:-1]),
             got32[1] / u_unit, first(got32[0][:-1]))
        # full depth on [23, 15, 7]: flips cascade, so only BF16_VS_FP32 (phase 19's)
        chf = make_fused_ddim_chain(ch.packed, schedule, GRID3, 4, weights_dtype=bf16, device=dev)
        ctx4 = torch.rand((4, c), generator=gen, device=dev) * 2 - 1
        x4 = torch.randn((4, h, d), generator=gen, device=dev)
        epf = ep_of(B1_EP, GRID3, schedule, bf16)
        nzf = torch.randn(epf.noise_shape, generator=gen, device=dev)
        reset(chf, epf)
        gotc, gote = chf.kernel(ctx4, x4), epf.kernel(s["x0"], nzf)
        torch.cuda.synchronize()
        wrappers += [chf, epf]
        expected += [(1, 1), (1, 1)]  # and one plain call each, below
        t1 = time.perf_counter()
        wante = epf.plain(s["x0"], nzf)
        torch.cuda.synchronize()
        objs[shape]["ep_plain_ms"] = 1e3 * (time.perf_counter() - t1)
        gates[f"full_depth {shape}"] = {
            "ddim_chain_bf16": assert_close(f"ddim_chain_bf16 {shape} full depth", gotc,
                                            chf.plain(ctx4, x4), BF16_VS_FP32),
            epf.name: assert_close(f"{epf.name} {shape} {B1_EP} replans u_norm",
                                   gote[1] / u_unit, wante[1] / u_unit, BF16_VS_FP32)}
    if failures:
        raise RuntimeError(f"phase 49's bf16 gates failed (or their fp32 controls passed): "
                           f"{failures}; every reading: {gates}")
    b1_counts = counts(*wrappers)
    if b1_counts != expected:
        raise RuntimeError(f"phase 49's launches {b1_counts}, expected {expected}")
    # times, each bf16 entry in turns with its fp32 entry (fp32, bf16, bf16, fp32) at the main
    # paths' shapes: kernel 2 at the flagship's batch 2 by its launch alone, kernel 4 at the
    # panda's one sample on [23, 15, 7], kernel 5 over B1_TIMED_EP replans of the swing-up on
    # [23] and B1_EP of the panda on [23, 15, 7]; every wrapper below runs once before
    fl, pa = objs["flagship"], objs["panda"]
    in_turns = lambda calls, n: {wd: [cuda_ms(calls[w_], n=n, warmup=1) for w_ in
                                      (torch.float32, bf16, bf16, torch.float32) if w_ == wd]
                                 for wd in calls}
    ux, ut, uc, um = (a[:2].contiguous() for a in fl["unet_args"])
    uns = {wd: make_fused_unet(fl["packed"], 2, weights_dtype=wd, device=dev)
           for wd in (torch.float32, bf16)}
    u_films = uns[bf16].films(uns[bf16].model.conditioning(ut, uc, um)).contiguous()
    u_y = torch.empty((2, HORIZON, uns[bf16].model.unet_input_dim), device=dev)
    for u in uns.values():
        u.cluster.require_fit(u.smem_bytes, dev)
    unet_ms = in_turns({wd: (lambda u=u: u._launch(u.cluster.weights, u_films, ux, u_y))
                        for wd, u in uns.items()}, 100)
    unet_plain_ms = cuda_ms(lambda: uns[bf16].plain(ux, ut, uc, um), n=5, warmup=1)
    pctx = torch.rand((1, 20), generator=gen, device=dev) * 2 - 1
    px = torch.randn((1, pys.H, 7), generator=gen, device=dev)
    chs = {wd: make_fused_ddim_chain(pa["spacked"], schedule, GRID3, 1, weights_dtype=wd,
                                     device=dev) for wd in (torch.float32, bf16)}
    chain_ms = in_turns({wd: (lambda c=c: c.kernel(pctx, px)) for wd, c in chs.items()}, 10)
    chain_plain_ms = cuda_ms(lambda: chs[bf16].plain(pctx, px), n=2, warmup=1)
    eps_ = {}
    for name, shape, times, n_steps in (("ddim_episode_bf16", "flagship", GRID, B1_TIMED_EP),
                                        ("ddim_episode_panda_bf16", "panda", GRID3, B1_EP)):
        s_ = shapes[shape]
        eps_[name] = {wd: make_fused_ddim_episode(
            objs[shape]["spacked"], schedule, times, s_["ins"], s_["cond"], s_["plant"],
            s_["cost"], n_steps=n_steps, weights_dtype=wd, state_to_condition=s_["cmap"],
            device=dev) for wd in (torch.float32, bf16)}
        nz = torch.randn(eps_[name][bf16].noise_shape, generator=gen, device=dev)
        # the panda's plain episode at this shape ran at full depth above, on the host's clock
        plain_ms = (objs[shape]["ep_plain_ms"] if shape == "panda" else
                    cuda_ms(lambda e=eps_[name][bf16]: e.plain(shapes[shape]["x0"], nz), n=1,
                            warmup=0))
        eps_[name] = (eps_[name], nz, in_turns({wd: (lambda e=e: e.kernel(shapes[shape]["x0"], nz))
                                                 for wd, e in eps_[name].items()}, 3), plain_ms)
    # each bf16 row's bound: the fp32 entry's operations, the conv products (the final 1x1's
    # where it is in the kernel) at the bf16 rate, its bytes less 2 per conv weight
    def sizes(packed, model, final_in_kernel):
        seg = lambda *pre: sum(math.prod(shape) for name, (_, shape) in packed.segments.items()
                               if name.split(".")[0] in pre)
        conv_w = sum(math.prod(packed.segments[name][1]) for name in
                     [*cluster_split(packed).convs] + (["final1x1.w"] if final_in_kernel else []))
        film1 = 2 * int(packed.films_w.shape[1]) * sum(rb.cond_mlp[1].out_features
                                                       for rb in model.res_blocks())
        return seg, conv_w, film1
    seg, conv_w, _ = sizes(fl["packed"], flagship, False)
    meta_n = fl["packed"].metas[1].numel()
    unet_row = bound(0, 4 * (fl["packed"].weights.numel() - seg("films", "final1x1") + meta_n
                             + u_films.numel() + ux.numel() + u_y.numel()) - 2 * conv_w,
                     bf16_flops=2 * (fl["packed"].flops_per_pass - fl["packed"].flops_final_1x1))
    seg, conv_w, film1 = sizes(pa["spacked"], pstudent, True)
    ch_b = chs[bf16]
    chain_row = bound(0, 4 * (pa["spacked"].weights.numel() - seg("films") + meta_n
                              + ch_b.films(pctx).numel() + px.numel() + ch_b.coefs.numel()
                              + pys.H * 7) - 2 * conv_w,
                      bf16_flops=pa["spacked"].flops_per_pass * ch_b.n_total)
    ep_rows = {}
    for name, shape, model, step_flops in (("ddim_episode_bf16", "flagship", student, 0),
                                           ("ddim_episode_panda_bf16", "panda", pstudent,
                                            PANDA_STEP_FLOPS)):
        (e32_bf, nz, turns, plain_ms) = eps_[name]
        e = e32_bf[bf16]
        seg, conv_w, film1 = sizes(e.packed, model, True)
        dx, du = e.plant.state_dim, e.plant.control_dim
        ep_rows[name] = {
            "ms": statistics.mean(turns[bf16]), "plain_ms": plain_ms,
            **bound(e.n_steps * (e.n_total * film1 + step_flops),
                    4 * (e.packed.weights.numel() + meta_n + e.t_embs.numel() + nz.numel()
                         + e.coefs.numel() + e.consts.numel() + dx + (e.n_steps + 1) * dx
                         + e.n_steps * (du + 2)) - 2 * conv_w,
                    bf16_flops=e.n_steps * e.n_total * e.packed.flops_per_pass),
            "replans": e.n_steps, "times": GRID if shape == "flagship" else GRID3,
            "ms_per_replan": statistics.mean(turns[bf16]) / e.n_steps,
            "ms_in_turns": {"fp32": turns[torch.float32], "bf16": turns[bf16]},
            "one_pass": gates[f"{name} {shape}"],
            "full_depth_max_abs_err_u_norm": gates[f"full_depth {shape}"][name]}
    src = "mpc_via_diffusion_model_tpu_torch/ops/csrc/"
    common = {"route": "cuda", "library_ms": None, "weights_dtype": "bfloat16"}
    rows = {
        "fused_unet_bf16": {
            "name": "fused_unet_bf16", "source": src + "fused_unet.cu",
            "replaces": "mpc_via_diffusion_model_tpu/ops/fused_unet.py:387",
            "launches": b1_counts[0][0] + b1_counts[8][0],
            "max_abs_err": max(gates[f"fused_unet_bf16 {k}"]["max"] for k in shapes),
            "ms": statistics.mean(unet_ms[bf16]), "plain_ms": unet_plain_ms, **unet_row,
            "batch": 2, "ms_in_turns": {"fp32": unet_ms[torch.float32], "bf16": unet_ms[bf16]},
            "one_pass": {k: gates[f"fused_unet_bf16 {k}"] for k in shapes}, **common},
        "ddim_chain_bf16": {
            "name": "ddim_chain_bf16", "source": src + "ddim_chain.cu",
            "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:164",
            "launches": sum(b1_counts[i][0] for i in (2, 6, 10, 14)),
            "max_abs_err": gates["ddim_chain_bf16 panda"]["max"],
            "ms": statistics.mean(chain_ms[bf16]), "plain_ms": chain_plain_ms, **chain_row,
            "times": GRID3, "horizon": pys.H, "model": "distilled_panda student_3eval",
            "ms_in_turns": {"fp32": chain_ms[torch.float32], "bf16": chain_ms[bf16]},
            "one_pass": {k: gates[f"ddim_chain_bf16 {k}"] for k in shapes},
            "full_depth_max_abs_err": {k: gates[f"full_depth {k}"]["ddim_chain_bf16"]
                                       for k in shapes}, **common},
        **{name: {"name": name, "source": src + ("ddim_episode.cu" if name == "ddim_episode_bf16"
                                                  else "ddim_episode_panda.cu"),
                  "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
                  "launches": b1_counts[4 if name == "ddim_episode_bf16" else 12][0]
                  + b1_counts[7 if name == "ddim_episode_bf16" else 15][0],
                  "max_abs_err": row["one_pass"]["max"], **row, **common}
           for name, row in ep_rows.items()}}
    log("bf16-b1", t0, f"one pass (the fp32 entry as the control that must fail its gate): "
        + "; ".join(f"{k} (phase 19's one-pass gate, recorded: {g['one_pass']}): median to "
                    f"{g['median_to']}, spread {g['spread']:.3e}, max {g['max']:.3e}; the fp32 "
                    f"entry: median to {g['control_fp32_entry']['median_to']}"
                    for k, g in gates.items() if "median_to" in g)
        + f"; full depth (tol {BF16_VS_FP32:.0e}): "
        + "; ".join(f"{k} {v}" for k, v in gates.items() if k.startswith("full_depth"))
        + f"; launches {b1_counts}; ms in turns (fp32, bf16, bf16, fp32 as two lists): "
        + "; ".join(f"{k} {r['ms_in_turns']} (plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
                    f"by {r['bound_by']})" for k, r in rows.items()))
    return rows


@torch.no_grad()
def clip_phases(dev) -> dict:
    """Phase 50 on ``dev``: kernels 1, 3, 4 and 5 with the clip off (``clip_denoised=False``)
    against their plain versions on the flagship's weights and shape, on inputs where the
    clip binds (the share of reconstructions beyond [-1, 1] read and required above 0), the
    clip-on kernel as the control that must fail. Returns each kernel's row."""
    dev = resolve_device(dev)
    gen = torch.Generator(device=dev).manual_seed(50)
    schedule = make_schedule("exponential", T)
    t0 = time.perf_counter()
    flagship = load_flagship(FLAGSHIP, device=dev)
    student = load_student(STUDENT, device=dev)
    fins, fcond = (st.to(dev) for st in teacher_stats())
    fx0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    u_f = 0.5 * (fins.maxs - fins.mins)
    ctx4 = torch.randn((4, 5), generator=gen, device=dev)
    clip_rows = {}
    cfg = {c: make_fused_cfg_chain(flagship, schedule, n_samples=4, w=W, n_tail=N_TAIL,
                                   clip_denoised=c, device=dev) for c in (False, True)}
    ddim = {c: make_fused_ddim_chain(student, schedule, GRID3, 4, clip_denoised=c, device=dev)
            for c in (False, True)}
    cfg_ep = {c: make_fused_cfg_episode(cfg[False].packed, schedule, fins, fcond,
                                        cartpole_virtual_swingup(), cartpole_virtual_cost(),
                                        n_steps=B1_EP, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                        clip_denoised=c, device=dev) for c in (False, True)}
    ddim_ep = {c: make_fused_ddim_episode(ddim[False].packed, schedule, GRID3, fins, fcond,
                                          cartpole_virtual_swingup(),
                                          cartpole_virtual_collect_cost(), n_steps=B1_EP,
                                          clip_denoised=c, device=dev) for c in (False, True)}
    nz_c = torch.randn((cfg[False].n_total + 1, 4, HORIZON, 1), generator=gen, device=dev)
    # the trained student's reconstructions of standard draws stay inside [-1, 1] on [23, 15, 7]
    # (the clip never binds there), so its draws are scaled by B1_CLIP_SCALE
    x_d = B1_CLIP_SCALE * torch.randn((4, HORIZON, 1), generator=gen, device=dev)
    nz_ce = torch.randn(cfg_ep[False].noise_shape, generator=gen, device=dev)
    nz_de = B1_CLIP_SCALE * torch.randn(ddim_ep[False].noise_shape, generator=gen, device=dev)
    runs = {"cfg_chain": (cfg, (ctx4, nz_c)), "ddim_chain": (ddim, (ctx4, x_d)),
            "cfg_episode": (cfg_ep, (fx0, nz_ce)), "ddim_episode": (ddim_ep, (fx0, nz_de))}
    reset(*(w_ for ws, _ in runs.values() for w_ in ws.values()))
    got = {name: {c: ws[c].kernel(*inp) for c in ws} for name, (ws, inp) in runs.items()}
    torch.cuda.synchronize()
    clip_counts = {name: counts(*ws.values()) for name, (ws, _) in runs.items()}
    if any(cn != [(1, 0), (1, 0)] for cn in clip_counts.values()):
        raise RuntimeError(f"phase 50's launches {clip_counts}")
    ties = []
    for name, (ws, inp) in runs.items():
        off = ws[False]
        t1 = time.perf_counter()
        want = off.plain(*inp)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t1)
        if name.endswith("chain"):
            # relative to the plain output's largest magnitude where that passes 1: unclipped,
            # the CFG chain's first step (sra = srm = 1e6) leaves x at ~1e5
            scale = max(1.0, float(want.abs().max()))
            err = assert_close(f"{name} clip_denoised=False (over {scale:.3e})",
                               got[name][False] / scale, want / scale, CHAIN_TOL)
            ctl = float((got[name][True] - want).abs().max()) / scale
            ctl_tol = CHAIN_TOL
        else:
            err = episode_gate(f"{name} clip_denoised=False", off, got[name][False], want, u_f,
                               ties)
            ctl = max(float(((got[name][True][1] - want[1]) / u_f).abs().max()),
                      float((got[name][True][0] - want[0]).abs().max()) * CHAIN_TOL / TRACK_TOL)
            ctl_tol = CHAIN_TOL
        if not ctl > ctl_tol:
            raise RuntimeError(f"{name}: the clip-on kernel lies {ctl:.3e} from the clip-off plain "
                               f"version, within the tolerance {ctl_tol:.0e}: the check cannot "
                               "see the flag")
        # where the clip binds: the chain's inputs, the episode's first replan
        if name == "cfg_chain":
            share = cfg_recon_share(off, *inp)
        elif name == "ddim_chain":
            share = ddim_recon_share(student, schedule, GRID3, *inp)
        elif name == "cfg_episode":
            ctx1 = normalize(fcond, fx0)[None]
            share = cfg_recon_share(make_fused_cfg_chain(off.packed, schedule, 1, W, N_TAIL,
                                                         clip_denoised=False, device=dev),
                                    ctx1, nz_ce[0])
        else:
            share = ddim_recon_share(student, schedule, GRID3, normalize(fcond, fx0)[None],
                                     nz_de[0])
        if not share > 0:
            raise RuntimeError(f"{name}: no reconstruction beyond [-1, 1]: the clip never binds")
        pk = off.packed
        seg = lambda *pre: sum(math.prod(shape) for n_, (_, shape) in pk.segments.items()
                               if n_.split(".")[0] in pre)
        film1 = 2 * int(pk.films_w.shape[1]) * sum(rb.cond_mlp[1].out_features
                                                   for rb in pk.model.res_blocks())
        rows_per_pass = 2 if name.startswith("cfg") else 1  # the CFG kernels' doubled batch
        if name.endswith("chain"):
            b = inp[0].shape[0]
            flops = pk.flops_per_pass * rows_per_pass * b * off.n_total
            n_bytes = 4 * (pk.weights.numel() - seg("films") + pk.metas[1].numel()
                           + off.films(inp[0]).numel() + inp[1].numel() + off.coefs.numel()
                           + b * HORIZON)
        else:
            flops = off.n_steps * off.n_total * (rows_per_pass * pk.flops_per_pass
                                                 + rows_per_pass * film1)
            n_bytes = 4 * (pk.weights.numel() + pk.metas[1].numel() + off.t_embs.numel()
                           + inp[1].numel() + off.coefs.numel() + off.consts.numel() + 5
                           + (off.n_steps + 1) * 5 + off.n_steps * 3)
        clip_rows[name] = {"name": name, "route": "cuda",
                           "source": f"mpc_via_diffusion_model_tpu_torch/ops/csrc/{name}.cu",
                           "replaces": CLIP_REPLACES[name], **bound(flops, n_bytes),
                           "library_ms": None, "clip_denoised": False,
                           "max_abs_err": err, "plain_ms": plain_ms,
                           "ms": cuda_ms(lambda off=off, inp=inp: off.kernel(*inp), n=3, warmup=0),
                           "ms_clip_on": cuda_ms(lambda w_=ws[True], inp=inp: w_.kernel(*inp),
                                                 n=3, warmup=0),
                           "recon_beyond_share": share, "control_clip_on_err": ctl,
                           "launches": clip_counts[name][0][0]}
    log("clip-off", t0, f"clip_denoised=False against the plain versions (chains {CHAIN_TOL:.0e} "
        f"relative to max(1, max |plain|), "
        f"episodes' controls {CHAIN_TOL:.0e} in u_norm and tracks {TRACK_TOL:.0e}): "
        + "; ".join(f"{k} {v['max_abs_err']:.3e} (reconstructions beyond +-1: {v['recon_beyond_share']:.3f}; "
                    f"the clip-on kernel {v['control_clip_on_err']:.3e} off, as it must be; ms "
                    f"{v['ms']:.4f} clip off, {v['ms_clip_on']:.4f} on)" for k, v in clip_rows.items())
        + f"; launches {clip_counts}; near-ties {ties}")
    return clip_rows


def distill_panda_phases(dev) -> dict:
    """Phase 51 on ``dev``: the port of the panda arm's distillation recipe
    (``scripts/distill_panda.py``). Its serving rows on the committed 3-eval student, fp32 and
    bf16 (kernel 4's ``ddim_chain`` and ``ddim_chain_bf16`` as the chain split's sampler, the
    10 paired episodes as one batch, cut to ``dpy.PREFIX_STEPS`` replans; the counts set to 0
    just before): each fp32 episode within ``dpy.PAIRED_BOUND`` of the port's plain chain split
    on the CPU on the same draws, the bf16 row outside it (the control: bf16 is another
    function), both rows' mean within ``dpy.BOUNDS['prefix']`` of the JAX package's. Then
    (b)'s distill steps from the teacher on its dataset, each loss within ``dpy.LOSS_BOUND`` of
    JAX's, relative. Returns the kernels line's fields of the bf16 row."""
    dev = resolve_device(dev)
    t0 = time.perf_counter()
    n, steps = dpy.N_SEEDS, dpy.PREFIX_STEPS
    with torch.no_grad():
        student = load_panda_student(dpy.STUDENT, device=dev)
        ins, cond = (st.to(dev) for st in panda_stats())
        noise = distill_panda.seeded_draws(range(dpy.PAIRED_SEED_BASE, dpy.PAIRED_SEED_BASE + n),
                                           steps, dpy.H, dev)
        start = torch.from_numpy(dpy.x0()).to(dev).expand(n, 14)
        loops = {tag: distill_panda.chain_loop(student, dpy.TIMES, n, steps, dpy.H, dev, ins,
                                               cond, wd)
                 for tag, wd in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
        chains = [chain for _, chain in loops.values()]
        reset(*chains)
        res, secs = {}, {}
        for tag, (loop, _) in loops.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res[tag] = loop(start, noise)
            torch.cuda.synchronize()
            secs[tag] = time.perf_counter() - t1
        serve_counts = counts(*chains)
    if serve_counts != [(steps, 0)] * 2 or [c.entry for c in chains] != ["ddim_chain",
                                                                           "ddim_chain_bf16"]:
        raise RuntimeError(f"distill_panda's serving rows: counts {serve_counts}, entries "
                           f"{[c.entry for c in chains]}")
    if not all(torch.isfinite(r.x_track).all() and torch.isfinite(r.u_track).all()
               for r in res.values()):
        raise RuntimeError("distill_panda's serving rows: non-finite tracks")
    prefix = {tag: [float(c) for c in r.stage_costs.double().sum(-1).cpu()]
              for tag, r in res.items()}
    pgaps = {tag: dpy.paired_gaps(c) for tag, c in prefix.items()}
    mgaps = {tag: dpy.gaps(prefix_costs=c) for tag, c in prefix.items()}
    if not (dpy.paired_within(prefix["fp32"]) and not dpy.paired_within(prefix["bf16"])
            and all(dpy.within(prefix_costs=c) for c in prefix.values())):
        raise RuntimeError(f"distill_panda's serving rows over {steps} replans: each episode's "
                           f"gap from the port's plain chain split on the CPU {pgaps} (fp32 "
                           f"within {dpy.PAIRED_BOUND:.3e}, bf16 outside it); the means' gaps "
                           f"from the JAX package's {mgaps} (bound {dpy.BOUNDS['prefix']})")
    # kernel 4 at the rows' shape: 10 samples on [23, 15, 7], one launch per replan
    ctx = normalize(cond, make_panda_context()(start))
    k_ms = {tag: cuda_ms(lambda c=chain: c.kernel(ctx, noise[:, 0, 0]), n=5, warmup=0)
            for tag, chain in zip(loops, chains)}
    marks = {"serving": time.perf_counter() - t0}
    dl = distill_panda_divergence.distill_losses(dev)
    lgaps = dpy.loss_gaps(dl["losses"])
    if not max(lgaps) <= dpy.LOSS_BOUND:
        raise RuntimeError(f"distill_panda's steps: losses {dl['losses']} against the JAX "
                           f"package's {list(dpy.LOSSES)}, relative gaps {lgaps} (bound "
                           f"{dpy.LOSS_BOUND:.3e})")
    log("distill-panda", t0, f"the committed 3-eval student's serving rows, {n} episodes x "
        f"{steps} replans through the chain split (launches {serve_counts}): fp32 each episode "
        f"{max(pgaps['fp32']):.3e} at most from the port's plain chain split on the CPU (bound "
        f"{dpy.PAIRED_BOUND:.3e}), bf16 (the control) {min(pgaps['bf16']):.3e} at least; mean "
        f"cost fp32 {np.mean(prefix['fp32']):.6f}, bf16 {np.mean(prefix['bf16']):.6f} (JAX "
        f"{dpy.PREFIX_MEAN10:.6f}, gaps {mgaps}, bound {dpy.BOUNDS['prefix']:.3f}); "
        f"{1e3 * secs['fp32'] / steps:.3f} and {1e3 * secs['bf16'] / steps:.3f} ms per replan of "
        f"the {n} episodes by the host clock; ddim_chain at B={n} {k_ms['fp32']:.4f} ms, bf16 "
        f"{k_ms['bf16']:.4f}; {dpy.N_DISTILL_STEPS} distill steps from the teacher at batch "
        f"{dpy.BATCH}: losses {dl['losses']}, relative gaps from JAX's {lgaps} (bound "
        f"{dpy.LOSS_BOUND:.3e}), {dl['ms_per_step']:.3f} ms per step; seconds into the phase "
        f"{marks}")
    return {"launches": serve_counts[1][0], "fp32_launches": serve_counts[0][0],
            "prefix_cost_mean10": {tag: float(np.mean(c)) for tag, c in prefix.items()},
            "paired_max_gap_fp32": max(pgaps["fp32"]), "paired_min_gap_bf16": min(pgaps["bf16"]),
            "paired_bound": dpy.PAIRED_BOUND, "mean_gaps": mgaps, "b10_ms": k_ms,
            "ms_per_replan_host": {tag: 1e3 * s / steps for tag, s in secs.items()},
            "distill_losses": dl["losses"], "distill_loss_gaps": lgaps,
            "distill_ms_per_step": dl["ms_per_step"]}


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def aten_parent(event):
    """The nearest ATen op around a traced event, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("aten::"):
        p = p.cpu_parent
    return None if p is None else p.name


def ilqr_phases(dev) -> dict:
    """Phases 27-28 on ``dev``: the flagship collection's first step as one batched iLQR solve,
    and the NMPC expert's first steps, each against the JAX package's on the CPU. Returns the
    ``ilqr`` line."""
    dev = resolve_device(dev)  # TF32 off for the matmuls
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost().to(dev)
    cfg = ILQRConfig(xys.HORIZON, xys.ITERATIONS)
    # 27. one ilqr_solve over the 400 nominal first-step solves and N_NOISY replicas of each
    # (x + 0.15 N(0, 1) from a seeded generator, from the same kick), the nominal ones gated
    t0 = time.perf_counter()
    x_nom, u_nom = (v.to(dev) for v in xys.first_step_batch())
    n_nom = len(x_nom)
    gen = torch.Generator(device=dev).manual_seed(27)
    x_noisy = x_nom[:, None] + 0.15 * torch.randn((n_nom, N_NOISY, 5), generator=gen, device=dev)
    x_all = torch.cat([x_nom, x_noisy.reshape(-1, 5)])
    u_all = torch.cat([u_nom, u_nom.repeat_interleave(N_NOISY, dim=0)])
    # one iteration with any host sync an error (set_sync_debug_mode), traced: the prototype
    # debug mode misses syncs made inside a library (torch.cholesky_solve's batched path syncs
    # the stream in every call), so the trace must hold no synchronizing runtime call in an op
    j, xs = ilqr._total_cost(plant, cost, x_all, u_all)
    alphas = torch.tensor(cfg.line_search_alphas, device=dev)[:, None]
    reg = torch.full(j.shape, cfg.reg_init, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ilqr._iteration(plant, cost, x_all, alphas, cfg, u_all, xs, j, reg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1  # the first iteration: the solver libraries load
    op_syncs = [f"{e.name} in {op}" for e, op in ((e, aten_parent(e)) for e in prof.events())
                if e.name in SYNC_CALLS and op is not None]
    if op_syncs:
        raise RuntimeError(f"ilqr: one iteration waits on the host: {op_syncs}")
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev0.record()
    sol = ilqr_solve(plant, cost, x_all, u_all, cfg)
    ev1.record()
    torch.cuda.synchronize()
    batch_s, batch_dev_ms = time.perf_counter() - t1, ev0.elapsed_time(ev1)
    nominal = type(sol)(*(v[:n_nom] for v in (sol.us, sol.xs, sol.cost, sol.improved_last_iter,
                                                sol.backward_ok)))
    gaps = xys.first_step_gaps(nominal)
    converged = sol.backward_ok.float().mean().item()
    if not (torch.isfinite(sol.us).all() and torch.isfinite(sol.cost).all()
            and xys.within(gaps, xys.FIRST_STEP_BOUNDS, ("cost_rel", "u0_max"))
            and gaps["backward_ok_differ"] == 0):
        raise RuntimeError(f"ilqr batch: the nominal first-step solves against the JAX package's "
                           f"{gaps} (bounds cost_rel, u0_max {xys.FIRST_STEP_BOUNDS}); finite "
                           f"{bool(torch.isfinite(sol.us).all())}")
    log("ilqr-batch", t0, f"one ilqr_solve (H={cfg.horizon}, {cfg.n_iterations} iterations) over "
        f"{len(x_all)} solves ({n_nom} nominal first-step solves of the flagship collection and "
        f"{N_NOISY} noisy replicas of each): {batch_s:.3f}s by the host clock, "
        f"{1e3 * batch_s / cfg.n_iterations:.3f} ms per iteration ({batch_dev_ms:.3f} ms by CUDA "
        f"events), {len(x_all) / batch_s:.1f} solves/s; the first iteration {first_s:.3f}s, under "
        f"set_sync_debug_mode('error') and traced: no synchronizing runtime call in an op; "
        f"converged fraction {converged:.4f}; "
        f"the nominal solves against the JAX package's: cost rel {gaps['cost_rel']:.3e}, first "
        f"control {gaps['u0_max']:.3e} (bounds {xys.FIRST_STEP_BOUNDS}), backward_ok differ "
        f"{gaps['backward_ok_differ']}")

    # 28. the NMPC expert's first N_NMPC_PREFIX steps from the flagship's x0
    t0 = time.perf_counter()
    loop = make_nmpc_closed_loop(plant, cost, cfg, n_steps=N_NMPC_PREFIX,
                                 u_init_scale=xys.KICKS[0], device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    run = loop(torch.tensor(xys.EXPERT_X0, device=dev))
    torch.cuda.synchronize()
    nmpc_s = time.perf_counter() - t1
    egaps = xys.expert_gaps(run, N_NMPC_PREFIX)
    if not xys.within(egaps, xys.EXPERT_BOUNDS[N_NMPC_PREFIX], ("cost_rel", "u_max", "x_max")):
        raise RuntimeError(f"nmpc prefix: the first {N_NMPC_PREFIX} steps against the JAX "
                           f"package's expert {egaps} (bounds {xys.EXPERT_BOUNDS[N_NMPC_PREFIX]})")
    log("nmpc-prefix", t0, f"make_nmpc_closed_loop from x0 = {list(xys.EXPERT_X0)}, "
        f"{N_NMPC_PREFIX} steps: {nmpc_s:.3f}s, {1e3 * nmpc_s / N_NMPC_PREFIX:.1f} ms per control "
        f"step (one solve at batch 1: {1e3 * nmpc_s / N_NMPC_PREFIX / cfg.n_iterations:.3f} ms per "
        f"iteration); against the JAX package's expert: cost rel {egaps['cost_rel']:.3e}, u "
        f"{egaps['u_max']:.3e}, x {egaps['x_max']:.3e} (bounds "
        f"{xys.EXPERT_BOUNDS[N_NMPC_PREFIX]}); u_track {[round(v, 5) for v in run.u_track[:, 0].tolist()]}")
    return {"first_step": {"solves": len(x_all), "nominal": n_nom, "iterations": cfg.n_iterations,
                           "horizon": cfg.horizon, "s": batch_s, "device_ms": batch_dev_ms,
                           "ms_per_iteration": 1e3 * batch_s / cfg.n_iterations,
                           "solves_per_s": len(x_all) / batch_s, "converged_fraction": converged,
                           "first_iteration_s": first_s, "nominal_vs_jax": gaps,
                           "bounds": xys.FIRST_STEP_BOUNDS},
            "nmpc_prefix": {"steps": N_NMPC_PREFIX, "s": nmpc_s,
                            "ms_per_step": 1e3 * nmpc_s / N_NMPC_PREFIX,
                            "ms_per_iteration": 1e3 * nmpc_s / N_NMPC_PREFIX / cfg.n_iterations,
                            "vs_jax": egaps,
                            "bounds": xys.EXPERT_BOUNDS[N_NMPC_PREFIX]},
            "nvidia_smi": nvidia_smi()}


def main() -> None:
    # 1. device
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script drives the port on an NVIDIA GPU")
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log("device", t0, f"{kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(smi, flush=True)

    # 2. build, every kernel at once
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, b in built.items():
        print(f"  {name}: nvcc {b.seconds:.3f}s -> {b.path.name}\n{b.report}", flush=True)
    # the cluster kernels: their registers and spills (from cuobjdump when the build was reused),
    # and how many of their clusters fit at once at full width
    # each kernel's plan: the CFG kernels' two row-sets, the U-Net pass's and the DDIM kernels' one
    packed_cpu = pack_unet(load_flagship(FLAGSHIP, device="cpu"), "cpu")
    panda_cpu = pack_unet(load_panda_student(PANDA_STUDENT, device="cpu"), "cpu")
    ep_smem = [packed_cpu.episode_smem_bytes(k, 2) for k in (1, K4)]
    sep_smem = [packed_cpu.episode_smem_bytes(k, 1) for k in (1, K4)]
    lmpc_smem = [pack_unet(load_lmpc(LMPC, device="cpu"), "cpu").episode_smem_bytes(k, 2)
                 for k in (1, K8)]
    quad_smem = [pack_unet(load_quadrotor_student(QUADROTOR_STUDENT, device="cpu"),
                           "cpu").episode_smem_bytes(k, 1) for k in (1, 16)]
    scene_smem = [pack_unet(load_scene_student(sys_.STUDENT, device="cpu"),
                            "cpu").episode_smem_bytes(k, 2) for k in (1, 16)]
    panda_smem = [panda_cpu.episode_smem_bytes(k, 1) for k in (1, K4, 16)]
    one_smem = [packed_cpu.chain_smem_bytes(1), panda_cpu.chain_smem_bytes(1)]
    # the plan in turns: the panda teacher's (the student's architecture) and the flagship's chain
    turns_smem = [panda_cpu.chain_smem_bytes(TURNS), packed_cpu.chain_smem_bytes(TURNS)]
    pcfg_smem = [panda_cpu.episode_smem_bytes(k, TURNS) for k in (1, K4, 16)]
    cluster_kernels = {  # entry: (occupancy query, shared memory per CTA of each launch shape)
        "cfg_chain": (cfg_chain_max_active_clusters, [packed_cpu.chain_smem_bytes(2)]),
        "cfg_chain_bf16": (cfg_chain_bf16_max_active_clusters, [packed_cpu.chain_smem_bytes(2)]),
        "fused_unet": (fused_unet_max_active_clusters, one_smem),
        "cfg_episode": (cfg_episode_max_active_clusters, ep_smem),
        "cfg_episode_bf16": (cfg_episode_bf16_max_active_clusters, ep_smem),
        "ddim_chain": (ddim_chain_max_active_clusters, one_smem),
        "ddim_episode": (ddim_episode_max_active_clusters, sep_smem),
        "cfg_episode_lmpc": (cfg_episode_lmpc_max_active_clusters, lmpc_smem),
        "ddim_episode_quadrotor": (ddim_episode_quadrotor_max_active_clusters, quad_smem),
        "cfg_episode_quadrotor": (cfg_episode_quadrotor_max_active_clusters, scene_smem),
        "ddim_episode_panda": (ddim_episode_panda_max_active_clusters, panda_smem),
        "cfg_chain_turns": (lambda b: cfg_chain_max_active_clusters(b, "cfg_chain_turns"),
                            turns_smem),
        "cfg_chain_turns_bf16": (
            lambda b: cfg_chain_max_active_clusters(b, "cfg_chain_turns_bf16"), turns_smem),
        "cfg_episode_panda": (cfg_episode_panda_max_active_clusters, pcfg_smem),
        "cfg_episode_panda_draw": (cfg_episode_panda_draw_max_active_clusters, pcfg_smem),
        "fused_unet_bf16": (lambda b: fused_unet_max_active_clusters(b, "fused_unet_bf16"),
                            one_smem),
        "ddim_chain_bf16": (lambda b: ddim_chain_max_active_clusters(b, "ddim_chain_bf16"),
                            one_smem),
        "ddim_episode_bf16": (lambda b: ddim_episode_max_active_clusters(b, "ddim_episode_bf16"),
                              sep_smem),
        "ddim_episode_panda_bf16": (
            lambda b: ddim_episode_panda_max_active_clusters(b, "ddim_episode_panda_bf16"),
            panda_smem)}
    # the library of each entry that is one instantiation of another library's kernel, and the
    # template arguments that pick it (bf16 weights; the kernel's bool arguments: the plan in
    # turns, then the in-kernel draw); every other entry is its library's float kernels
    instances = {"cfg_chain": ("cfg_chain", False, (False,)),
                 "cfg_chain_bf16": ("cfg_chain", True, (False,)),
                 "cfg_chain_turns": ("cfg_chain_turns", False, (True,)),
                 "cfg_chain_turns_bf16": ("cfg_chain_turns", True, (True,)),
                 "cfg_episode": ("cfg_episode", False, (False, False)),
                 "cfg_episode_bf16": ("cfg_episode", True, (False, False)),
                 "cfg_episode_panda": ("cfg_episode_panda", False, (True, False)),
                 "cfg_episode_panda_draw": ("cfg_episode_panda", False, (True, True)),
                 "fused_unet_bf16": ("fused_unet", True, None),
                 "ddim_chain_bf16": ("ddim_chain", True, None),
                 "ddim_episode_bf16": ("ddim_episode", True, None),
                 "ddim_episode_panda_bf16": ("ddim_episode_panda", True, None)}

    def template_args(kernel: str):
        """(bf16, the bool arguments) of a kernel's mangled template arguments."""
        m = re.search(r"_kernelI(.+?)Ev", kernel)
        targs = m.group(1) if m else ""
        return "13__nv_bfloat16" in targs, tuple(v == "1" for v in re.findall(r"Lb([01])E", targs))

    def resources(entry: str):
        """(registers, spills) of each kernel of an entry, from nvcc's report or, when the
        build was reused, cuobjdump's: an entry of ``instances`` is the one instantiation of
        its library's kernel that its template arguments pick, every other entry its
        library's float kernels."""
        name, bf16, flags = instances.get(entry, (entry, False, None))
        report = built[name].report or subprocess.run(
            [str(Path(_build._nvcc()).with_name("cuobjdump")), "--dump-resource-usage",
             str(built[name].path)], capture_output=True, text=True, timeout=60).stdout
        marks = list(re.finditer(r"Compiling entry function '(\w+)'|Function (\w+):", report))
        regs, spills = [], []
        for mark, nxt in zip(marks, marks[1:] + [None]):
            got_bf16, got_flags = template_args(mark.group(1) or mark.group(2))
            if got_bf16 != bf16 or (flags is not None and got_flags != flags):
                continue
            part = report[mark.end():nxt.start() if nxt else len(report)]
            regs += [int(a or b) for a, b in re.findall(r"Used (\d+) registers|REG:(\d+)", part)]
            spills += [[int(v) for v in t if v] for t in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads|LOCAL:(\d+)", part)]
        if not regs or not spills:
            raise RuntimeError(f"{entry}: no register or spill report in\n{report}")
        return regs, spills

    cluster_info, lines = {}, []
    for name, (query, smems) in cluster_kernels.items():
        regs, spills = resources(name)
        slots = [query(b) for b in smems]
        if not all(slots):
            raise RuntimeError(f"{name}: no cluster of {CLUSTER} CTAs fits on the card: {slots} at "
                               f"{smems} B per CTA")
        cluster_info[name] = {"registers": regs, "spill_bytes": spills, "clusters_fit": slots,
                              "smem_bytes_per_cta": smems}
        lines.append(f"{name} registers {regs}, spill stores and loads (or local bytes) {spills}, "
                     f"clusters of {CLUSTER} CTAs that fit at once "
                     + ", ".join(f"{n} at {b} B per CTA" for n, b in zip(slots, smems)))
    # the quadrotor entry's in-kernel draw: the same library's other instantiation
    draw_slots = [ddim_episode_quadrotor_draw_max_active_clusters(b) for b in quad_smem]
    if not all(draw_slots):
        raise RuntimeError(f"ddim_episode_quadrotor_draw: no cluster fits: {draw_slots}")
    cluster_info["ddim_episode_quadrotor"]["draw_clusters_fit"] = draw_slots
    lines.append(f"ddim_episode_quadrotor_draw clusters that fit at once {draw_slots}")
    # the conv kernel: one instantiation per accumulator tiles per warp (1, 2, 4, 8)
    conv_regs, conv_spills = resources("fused_conv")
    conv_info = {"registers": conv_regs, "spill_bytes": conv_spills}
    lines.append(f"fused_conv registers {conv_regs}, spill stores and loads (or local bytes) "
                 f"{conv_spills}")
    log("build", t0, f"{len(built)} libraries; " + "; ".join(lines)
        + f" (the chains' and the pass's plan at every batch: the CFG chain's on two row-sets, "
        f"the pass's and the DDIM chain's on one, on the flagship and on the panda student; "
        f"episodes at K = 1 and K = {K4}, the CFG episode's plan on two row-sets, the DDIM "
        f"episode's on one; cfg_episode_lmpc at K = 1 and K = {K8} on the LMPC model, "
        "ddim_episode_quadrotor at K = 1 and 16 on the quadrotor student, cfg_episode_quadrotor "
        f"at K = 1 and 16 on the scene student, ddim_episode_panda at K = 1, {K4} and 16 on the "
        f"panda student; cfg_chain_turns and its bf16 entry on the plan in turns at the panda "
        f"shape and the flagship's, cfg_episode_panda and its draw at K = 1, {K4} and 16 in turns; "
        "the _bf16 entries are the bf16 instantiations of their libraries' kernels, "
        "cfg_episode_lmpc is cfg_episode.cu compiled for the "
        "linear cart-pole, cfg_episode_quadrotor cfg_episode.cu for the quadrotor with the "
        "context map and the safety-first scorer, ddim_episode_quadrotor ddim_episode.cuh for the "
        "quadrotor, ddim_episode_panda ddim_episode.cuh for the arm with its context map, "
        "ddim_episode_quadrotor's "
        "registers those of its staged and drawing instantiations and of the draw's two test "
        "kernels); nvcc seconds per library, all started together: "
        + json.dumps({name: round(b.seconds, 1) for name, b in built.items()}))

    # 3. kernels vs plain versions, flagship weights, full width
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model = load_flagship(FLAGSHIP, device=dev)
    schedule = make_schedule("exponential", T)
    chain = make_fused_cfg_chain(model, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    unet = make_fused_unet(chain.packed, batch_size=2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_total = T + N_TAIL
    noise = torch.randn((n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    x0 = torch.tensor([0.0, 0.0, 3.0, 0.0, theta_to_red_theta(3.0)], device=dev)
    inputs_stats = NormalizerStats("limits", torch.full((1,), -30.0), torch.full((1,), 30.0))
    cond_stats = NormalizerStats("limits", torch.full((5,), -10.0), torch.full((5,), 10.0))
    contexts = [normalize(cond_stats.to(dev), x0)[None]] + [
        torch.randn((1, 5), generator=gen, device=dev) for _ in range(2)]
    chain_err = 0.0
    for ctx in contexts:
        got, want = chain.kernel(ctx, noise), chain.plain(ctx, noise)
        torch.cuda.synchronize()
        chain_err = max(chain_err, assert_close("cfg_chain", got, want, CHAIN_TOL))
    mask2 = torch.tensor([[0.0], [1.0]], device=dev)  # the CFG doubling: kept, dropped
    unet_inputs = []
    for i in range(3):
        ctx = torch.randn((1, 5), generator=gen, device=dev).expand(2, 5).contiguous()
        t = torch.full((2,), [24, 7, 0][i], dtype=torch.long, device=dev)
        unet_inputs.append((torch.randn((2, HORIZON, 1), generator=gen, device=dev), t, ctx, mask2))
    unet_err = 0.0
    for args in unet_inputs:
        got, want = unet.kernel(*args), unet.plain(*args)
        torch.cuda.synchronize()
        unet_err = max(unet_err, assert_close("fused_unet", got, want, UNET_TOL))
    log("kernel-vs-plain", t0, f"cfg_chain max_abs_err={chain_err:.3e} over {len(contexts)} "
        f"contexts; fused_unet max_abs_err={unet_err:.3e} over {len(unet_inputs)} draws at "
        f"batch 2; tol {CHAIN_TOL:.0e}")

    # 4. the per-replan path: the 80-replan CFG closed loop through the chain kernel
    t0 = time.perf_counter()
    diffusion = GaussianDiffusion(schedule)
    plant, cost = cartpole_virtual_swingup(), cartpole_virtual_cost()
    loop = lambda n_steps, **kw: make_closed_loop(
        diffusion, model, inputs_stats, cond_stats, plant, cost, horizon=HORIZON,
        n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL, device=dev, **kw)
    loop_kernel = loop(N_STEPS, sample_override=chain)
    ep_noise = torch.randn((N_STEPS, n_total + 1, 1, HORIZON, 1), generator=gen, device=dev)
    reset(chain, unet)
    res = loop_kernel(x0, ep_noise)
    torch.cuda.synchronize()
    chain_launches = chain.launches
    if counts(chain, unet) != [(N_STEPS, 0), (0, 0)]:
        raise RuntimeError(f"per-replan path: counts {counts(chain, unet)}; expected "
                           f"{N_STEPS} chain launches and nothing else")
    ref = loop(N_PLAIN_LOOP, sample_override=chain.plain)(x0, ep_noise[:N_PLAIN_LOOP])
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        got = getattr(res, name)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"per-replan path: non-finite {name}")
        assert_close(name, got[:len(getattr(ref, name))], getattr(ref, name), TRACK_TOL)
    log("per-replan-path", t0, f"{N_STEPS} replans: cfg_chain launches={chain_launches}; "
        f"total cost {res.stage_costs.sum().item():.6f}; first {N_PLAIN_LOOP} replans equal the "
        f"plain chain's to atol = rtol = {TRACK_TOL:.0e}; x_final={[round(v, 6) for v in res.x_track[-1].tolist()]}")

    # 5. the episode kernel at K = 1 on phase 4's noise
    t0 = time.perf_counter()
    episode = lambda k, n_steps, sel_h=None: make_fused_cfg_episode(
        chain.packed, schedule, inputs_stats, cond_stats, plant, cost, n_steps=n_steps, w=W,
        n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, selection_horizon=sel_h,
        device=dev)
    ep1 = episode(1, N_STEPS)
    got = ep1.kernel(x0, ep_noise)
    torch.cuda.synchronize()
    if ep1.launches != 1:
        raise RuntimeError(f"episode K=1: {ep1.launches} launches for one episode")
    vs_loop = max(assert_close(f"episode vs per-replan loop {name}", g, getattr(res, name), TRACK_TOL)
                  for name, g in zip(("x_track", "u_track", "stage_costs"), got))
    # the kernel against the plain episode over the first N_PLAIN_LOOP replans of the same noise
    ep_p = episode(1, N_PLAIN_LOOP)
    got_p = ep_p.kernel(x0, ep_noise[:N_PLAIN_LOOP])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = ep_p.plain(x0, ep_noise[:N_PLAIN_LOOP])
    torch.cuda.synchronize()
    plain_episode_s = time.perf_counter() - t1
    ep_err = 0.0
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got_p, want):
        ep_err = max(ep_err, assert_close(f"episode K=1 {name}", g, w_, TRACK_TOL))
    if not torch.equal(got_p[3], want[3]):
        raise RuntimeError("episode K=1: chosen candidates differ")
    log("episode-k1", t0, f"{N_STEPS} replans in one launch: max |episode - per-replan loop|="
        f"{vs_loop:.3e}; over the first {N_PLAIN_LOOP} replans max |kernel - plain|={ep_err:.3e}, "
        f"atol = rtol = {TRACK_TOL:.0e}; total cost kernel={got[2].sum().item():.6f} per-replan "
        f"loop={res.stage_costs.sum().item():.6f}; plain {N_PLAIN_LOOP}-replan episode "
        f"{plain_episode_s:.3f}s by the host clock")

    # 6. the episode kernel at K = 4 with a truncated selection horizon
    t0 = time.perf_counter()
    ep4 = episode(K4, N_STEPS_K4, SEL_H)
    noise4 = torch.randn(ep4.noise_shape, generator=gen, device=dev)
    got4 = ep4.kernel(x0, noise4)
    torch.cuda.synchronize()
    if ep4.launches != 1:
        raise RuntimeError(f"episode K={K4}: {ep4.launches} launches for one episode")
    want4 = ep4.plain(x0, noise4)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got4, want4):
        ep_err = max(ep_err, assert_close(f"episode K=4 {name}", g, w_, TRACK_TOL))
    if not torch.equal(got4[3], want4[3]):
        raise RuntimeError(f"episode K=4: chosen {got4[3].tolist()} vs plain {want4[3].tolist()}")
    log("episode-k4", t0, f"{N_STEPS_K4} replans, K={K4}, selection_horizon={SEL_H}: chosen "
        f"{got4[3].tolist()} in both; max |kernel - plain| so far {ep_err:.3e}")

    # 7. bench.py's default path and protocol through the episode kernel
    t0 = time.perf_counter()
    reset(chain, unet, ep1)
    x_cur = x0
    t1 = time.perf_counter()
    for _ in range(N_CHAIN):
        ep_nz = torch.randn(ep1.noise_shape, generator=gen, device=dev)
        x_tr, _, _ = ep1(x_cur, ep_nz)
        x_cur = x_tr[-1]
    torch.cuda.synchronize()
    sustained_s = time.perf_counter() - t1
    episode_launches = ep1.launches
    if counts(ep1, chain, unet) != [(N_CHAIN, 0), (0, 0), (0, 0)]:
        raise RuntimeError(f"protocol: counts (episode, chain, unet) {counts(ep1, chain, unet)}; "
                           f"expected {N_CHAIN} episode launches and nothing else")
    if not torch.isfinite(x_cur).all():
        raise RuntimeError("protocol: non-finite final state")
    control_hz = N_CHAIN * N_STEPS / sustained_s
    print(json.dumps({"metric": "closed_loop_control_hz", "value": control_hz, "unit": "Hz",
                      "protocol": "sustained_800step_dependent_chain",
                      "episode_launches": episode_launches, "seconds": sustained_s}), flush=True)
    log("protocol", t0, f"{N_CHAIN} dependent episodes of {N_STEPS} replans: {sustained_s:.3f}s, "
        f"{control_hz:.2f} replans/s; episode launches={episode_launches}; "
        f"x_final={[round(v, 6) for v in x_cur.tolist()]}")

    # 8. BENCH_FUSED=1: the plain sampler with the U-Net pass kernel as denoiser
    t0 = time.perf_counter()
    reset(chain, unet, ep1)
    loop_unet = make_closed_loop(diffusion, unet, inputs_stats, cond_stats, plant, cost,
                                 horizon=HORIZON, n_steps=N_UNET_LOOP, w=W,
                                 n_diffusion_steps_without_noise=N_TAIL, device=dev)
    res_u = loop_unet(x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    unet_launches = unet.launches
    if counts(unet, chain, ep1) != [(N_UNET_LOOP * n_total, 0), (0, 0), (0, 0)]:
        raise RuntimeError(f"BENCH_FUSED=1 path: counts (unet, chain, episode) "
                           f"{counts(unet, chain, ep1)}; expected {N_UNET_LOOP * n_total} "
                           f"U-Net launches and nothing else")
    ref_u = make_closed_loop(diffusion, unet.plain, inputs_stats, cond_stats, plant, cost,
                             horizon=HORIZON, n_steps=N_UNET_LOOP, w=W,
                             n_diffusion_steps_without_noise=N_TAIL, device=dev)(
        x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        assert_close(f"BENCH_FUSED=1 {name}", getattr(res_u, name), getattr(ref_u, name), TRACK_TOL)
    log("unet-path", t0, f"{N_UNET_LOOP} replans: fused_unet launches={unet_launches}; tracks "
        f"equal the plain forward's to atol = rtol = {TRACK_TOL:.0e}")

    # 9. the student's DDIM chain kernel vs its plain version, both grids
    t0 = time.perf_counter()
    student = load_student(STUDENT, device=dev)
    s_ins, s_cond = (st.to(dev) for st in teacher_stats())
    u_unit = 0.5 * (s_ins.maxs - s_ins.mins)
    s_cost = cartpole_virtual_collect_cost()
    schain = make_fused_ddim_chain(student, schedule, GRID, n_samples=1, device=dev)
    spacked = schain.packed
    ddim = lambda times, b: make_fused_ddim_chain(spacked, schedule, times, n_samples=b, device=dev)
    sctx = normalize(s_cond, x0)[None]
    sx_init = torch.randn(schain.noise_shape, generator=gen, device=dev)
    schain_err = 0.0
    for times in (GRID, GRID3):
        for b in (1, 4):
            ch = schain if (times, b) == (GRID, 1) else ddim(times, b)
            ctxs = [sctx.expand(b, 5).contiguous()] + [
                torch.randn((b, 5), generator=gen, device=dev) for _ in range(2)]
            for ctx in ctxs:
                x_init = torch.randn(ch.noise_shape, generator=gen, device=dev)
                got, want = ch.kernel(ctx, x_init), ch.plain(ctx, x_init)
                torch.cuda.synchronize()
                schain_err = max(schain_err, assert_close(f"ddim_chain {times} B={b}", got, want,
                                                          CHAIN_TOL))
    # on [23] the chain is one recon step (c1 = 1, c2 = 0): one U-Net pass and the clip
    sunet = make_fused_unet(spacked, batch_size=1, device=dev)
    sra, srm = schain.coefs[0, 0], schain.coefs[0, 1]
    eps = sunet.kernel(sx_init, schain.t_eval[:1], sctx, torch.zeros((1, 1), device=dev))
    via_unet = torch.clamp(sra * sx_init - srm * eps, -1.0, 1.0)
    got = schain.kernel(sctx, sx_init)
    torch.cuda.synchronize()
    vs_unet = assert_close("ddim_chain vs fused_unet pass", got, via_unet, CHAIN_TOL)
    log("student-chain", t0, f"ddim_chain max |kernel - plain|={schain_err:.3e} over 3 contexts "
        f"x B in (1, 4) x grids {GRID} and {GRID3}; vs one fused_unet pass + recon + clip on "
        f"{GRID}: {vs_unet:.3e}; tol {CHAIN_TOL:.0e}")

    # 10. the student's per-replan path: 80 replans through the DDIM chain kernel
    t0 = time.perf_counter()
    wrappers = [chain, unet, ep1, ep4, schain, sunet]
    s_loop = lambda sampler, n_steps=N_STEPS: make_closed_loop(
        diffusion, student, s_ins, s_cond, plant, s_cost, horizon=HORIZON, n_steps=n_steps,
        sample_override=sampler, noise_shape=schain.noise_shape, device=dev)
    s_noise = torch.randn((N_STEPS,) + schain.noise_shape, generator=gen, device=dev)
    reset(*wrappers)
    s_res = s_loop(schain)(x0, s_noise)
    torch.cuda.synchronize()
    s_chain_launches = schain.launches
    if counts(*wrappers) != [(0, 0)] * 4 + [(N_STEPS, 0), (0, 0)]:
        raise RuntimeError(f"student per-replan path: counts {counts(*wrappers)}; expected "
                           f"{N_STEPS} ddim_chain launches and nothing else")
    s_ref = s_loop(schain.plain)(x0, s_noise)
    torch.cuda.synchronize()
    for name in ("x_track", "u_track", "u_horizons", "stage_costs"):
        student_close(f"student loop {name}", getattr(s_res, name), getattr(s_ref, name), u_unit)
    # the controls' gap in u's own units and in u_norm's, the reading behind comparing them
    # normalized: fp32 rounding in u_norm, scaled by the teacher's half-range
    du = (s_res.u_horizons.double() - s_ref.u_horizons.double()).abs()
    du_max, du_norm_max = du.max().item(), (du / u_unit.double()).max().item()
    log("student-per-replan-path", t0, f"{N_STEPS} replans: ddim_chain launches="
        f"{s_chain_launches}; total cost {s_res.stage_costs.sum().item():.6f}; equal to the plain "
        f"chain's to atol = rtol = {TRACK_TOL:.0e} (controls {CHAIN_TOL:.0e} in normalized units); "
        f"controls max |du|={du_max:.3e}, max |du_norm|={du_norm_max:.3e} over half-range "
        f"{u_unit.max().item():.3f}, max |u|={s_ref.u_horizons.abs().max().item():.3f}; "
        f"x_final={[round(v, 6) for v in s_res.x_track[-1].tolist()]}")

    # 11. the student's episode kernel, K = 1 on phase 10's noise, and K = 4
    t0 = time.perf_counter()
    sepisode = lambda times, k, n_steps, sel_h=None: make_fused_ddim_episode(
        spacked, schedule, times, s_ins, s_cond, plant, s_cost, n_steps=n_steps, n_candidates=k,
        selection_horizon=sel_h, device=dev)
    sep1 = sepisode(GRID, 1, N_STEPS)
    sep_err, s_chosen = 0.0, []
    for times in (GRID, GRID3):
        for k, n_steps, sel_h in ((1, N_STEPS, None), (K4, N_STEPS_K4, SEL_H)):
            ep = sep1 if (times, k) == (GRID, 1) else sepisode(times, k, n_steps, sel_h)
            nz = s_noise if ep is sep1 else torch.randn(ep.noise_shape, generator=gen, device=dev)
            got, want = ep.kernel(x0, nz), ep.plain(x0, nz)
            torch.cuda.synchronize()
            for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
                sep_err = max(sep_err, student_close(f"ddim_episode {times} K={k} {name}", g, w_,
                                                     u_unit))
            if not torch.equal(got[3], want[3]):
                raise RuntimeError(f"ddim_episode {times} K={k}: chosen {got[3].tolist()} vs "
                                   f"plain {want[3].tolist()}")
            if k > 1:
                s_chosen.append(got[3].tolist())
            if ep is sep1:
                s_vs_loop = max(
                    student_close(f"ddim_episode vs per-replan loop {name}", g,
                                  getattr(s_res, name), u_unit)
                    for name, g in zip(("x_track", "u_track", "stage_costs"), got))
    log("student-episode", t0, f"{N_STEPS} replans in one launch on {GRID} and {GRID3}: max "
        f"|kernel - plain|={sep_err:.3e}, max |episode - per-replan loop|={s_vs_loop:.3e}, "
        f"atol = rtol = {TRACK_TOL:.0e} (controls {CHAIN_TOL:.0e} in normalized units); K={K4}, "
        f"selection_horizon={SEL_H}, {N_STEPS_K4} replans: "
        f"chosen {s_chosen} in both")

    # 12. the student's sustained protocol through the episode kernel
    t0 = time.perf_counter()
    wrappers.append(sep1)
    reset(*wrappers)
    x_cur = x0
    t1 = time.perf_counter()
    for _ in range(N_CHAIN):
        ep_nz = torch.randn(sep1.noise_shape, generator=gen, device=dev)
        x_tr, _, _ = sep1(x_cur, ep_nz)
        x_cur = x_tr[-1]
    torch.cuda.synchronize()
    s_sustained_s = time.perf_counter() - t1
    s_episode_launches = sep1.launches
    if counts(*wrappers) != [(0, 0)] * 6 + [(N_CHAIN, 0)]:
        raise RuntimeError(f"student protocol: counts {counts(*wrappers)}; expected {N_CHAIN} "
                           f"ddim_episode launches and nothing else")
    if not torch.isfinite(x_cur).all():
        raise RuntimeError("student protocol: non-finite final state")
    s_control_hz = N_CHAIN * N_STEPS / s_sustained_s
    print(json.dumps({"metric": "student_closed_loop_control_hz", "value": s_control_hz,
                      "unit": "Hz", "protocol": "sustained_800step_dependent_chain",
                      "times": GRID, "episode_launches": s_episode_launches,
                      "seconds": s_sustained_s}), flush=True)
    log("student-protocol", t0, f"{N_CHAIN} dependent episodes of {N_STEPS} replans: "
        f"{s_sustained_s:.3f}s, {s_control_hz:.2f} replans/s; ddim_episode launches="
        f"{s_episode_launches}; x_final={[round(v, 6) for v in x_cur.tolist()]}")

    # 13. the student's control quality against the report's expert
    t0 = time.perf_counter()
    expert_cost = json.loads(STUDENT_REPORT.read_text())["expert_cost"]
    ratios = []
    for seed in range(N_QUALITY):
        g = torch.Generator(device=dev).manual_seed(seed)
        _, _, costs = sep1(x0, torch.randn(sep1.noise_shape, generator=g, device=dev))
        ratios.append(costs.sum().item() / expert_cost)
    if not all(math.isfinite(r) for r in ratios):
        raise RuntimeError(f"student quality: non-finite cost ratios {ratios}")
    ratio_mean, ratio_max = sum(ratios) / len(ratios), max(ratios)
    if ratio_mean > QUALITY_MEAN_MAX:
        raise RuntimeError(f"student quality: mean cost ratio {ratio_mean:.5f} > {QUALITY_MEAN_MAX}")
    log("student-quality", t0, f"{N_QUALITY} seeds, K=1, {N_STEPS} replans, cost over expert "
        f"{expert_cost}: {[round(r, 5) for r in ratios]}; mean {ratio_mean:.5f}, max "
        f"{ratio_max:.5f} (at most {QUALITY_MEAN_MAX} on the mean)")

    # 14. timing at the main paths' shapes
    t0 = time.perf_counter()
    ctx = contexts[0]
    chain_ms = cuda_ms(lambda: chain.kernel(ctx, noise), n=20, warmup=3)
    chain_plain_ms = cuda_ms(lambda: chain.plain(ctx, noise), n=2, warmup=0)
    args = unet_inputs[0]
    # the U-Net pass: the launch alone on prepared tensors, and the wrapper's whole call
    u_films = unet.films(unet.model.conditioning(*args[1:])).contiguous()
    u_y = torch.empty((2, HORIZON, model.unet_input_dim), device=dev)
    unet_ms = cuda_ms(lambda: unet._launch(unet.cluster.weights, u_films, args[0], u_y), n=200,
                      warmup=10)
    unet_call_ms = cuda_ms(lambda: unet(*args), n=200, warmup=10)
    unet_plain_ms = cuda_ms(lambda: unet.plain(*args), n=10, warmup=2)
    episode_ms = cuda_ms(lambda: ep1.kernel(x0, ep_noise), n=1, warmup=0)
    ep_p_plain_ms = 1e3 * plain_episode_s / N_PLAIN_LOOP  # phase 5's plain episode, per replan
    episode4_ms = cuda_ms(lambda: ep4.kernel(x0, noise4), n=1, warmup=0)
    # the DDIM chain: the launch alone and the whole call on [23], B = 1; the launch alone on
    # [23, 15, 7] and at B = 4 (clusters side by side)
    def launch_alone(ch, ctx_, x_):
        films, out = ch.films(ctx_).contiguous(), torch.empty(ch.noise_shape, device=dev)
        return lambda: ch._launch(ch.cluster.weights, films, x_, out)

    schain_ms = cuda_ms(launch_alone(schain, sctx, sx_init), n=200, warmup=10)
    schain_call_ms = cuda_ms(lambda: schain(sctx, sx_init), n=200, warmup=10)
    schain_plain_ms = cuda_ms(lambda: schain.plain(sctx, sx_init), n=10, warmup=2)
    schain4 = ddim(GRID, K4)
    x4 = torch.randn(schain4.noise_shape, generator=gen, device=dev)
    schain3_ms = cuda_ms(launch_alone(ddim(GRID3, 1), sctx, sx_init), n=100, warmup=5)
    schain4_ms = cuda_ms(launch_alone(schain4, sctx.expand(K4, 5), x4), n=200, warmup=10)
    sep_ms = cuda_ms(lambda: sep1.kernel(x0, s_noise), n=5, warmup=1)
    sep_plain_ms = cuda_ms(lambda: sep1.plain(x0, s_noise), n=1, warmup=0)
    sep3 = sepisode(GRID3, 1, N_STEPS)
    sep3_ms = cuda_ms(lambda: sep3.kernel(x0, s_noise), n=3, warmup=1)
    sep4 = sepisode(GRID, K4, N_STEPS_K4, SEL_H)
    s_noise4 = torch.randn(sep4.noise_shape, generator=gen, device=dev)
    sep4_ms = cuda_ms(lambda: sep4.kernel(x0, s_noise4), n=5, warmup=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop(N_TIMED_LOOP, sample_override=chain)(x0, ep_noise[:N_TIMED_LOOP])
    torch.cuda.synchronize()
    per_replan_hz = N_TIMED_LOOP / (time.perf_counter() - t1)
    s_loop_kernel = s_loop(schain, N_TIMED_LOOP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_loop_kernel(x0, s_noise[:N_TIMED_LOOP])
    torch.cuda.synchronize()
    s_per_replan_hz = N_TIMED_LOOP / (time.perf_counter() - t1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loop_unet(x0, ep_noise[:N_UNET_LOOP])
    torch.cuda.synchronize()
    unet_loop_hz = N_UNET_LOOP / (time.perf_counter() - t1)
    log("timing", t0, f"cfg_chain {chain_ms:.4f} ms (plain {chain_plain_ms:.4f}) per replan; "
        f"fused_unet {unet_ms:.4f} ms launch alone, {unet_call_ms:.4f} ms whole call (plain "
        f"{unet_plain_ms:.4f}) per pass at batch 2; BENCH_FUSED=1 loop {unet_loop_hz:.2f} "
        f"replans/s; "
        f"cfg_episode K=1 {episode_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{episode_ms / N_STEPS:.4f} ms per replan (plain {ep_p_plain_ms:.3f} ms per replan over "
        f"{N_PLAIN_LOOP}); "
        f"K={K4} {episode4_ms:.3f} ms per {N_STEPS_K4} replans = "
        f"{episode4_ms / N_STEPS_K4:.4f} ms per replan; per-replan loop through cfg_chain "
        f"{per_replan_hz:.2f} replans/s")
    log("timing-student", t0, f"ddim_chain {GRID} {schain_ms:.4f} ms launch alone, "
        f"{schain_call_ms:.4f} ms whole call (plain {schain_plain_ms:.4f}) per replan, {GRID3} "
        f"{schain3_ms:.4f} ms, {GRID} B={K4} {schain4_ms:.4f} ms launch alone; ddim_episode "
        f"{GRID} K=1 {sep_ms:.3f} ms per {N_STEPS}-replan episode = "
        f"{sep_ms / N_STEPS:.4f} ms per replan (plain {sep_plain_ms:.3f} ms); {GRID3} K=1 "
        f"{sep3_ms / N_STEPS:.4f} ms per replan; {GRID} K={K4} {sep4_ms / N_STEPS_K4:.4f} ms per "
        f"replan; per-replan loop through ddim_chain {s_per_replan_hz:.2f} replans/s")

    # 15. the fused conv block against its plain version at the bench's six shapes
    t0 = time.perf_counter()
    conv_inputs, conv_err = {}, 0.0
    reset(fused_conv1d_gn_mish)
    for bsz, h, cin, cout in CONV_SHAPES:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        c_args = (rnd(bsz, h, cin), rnd(5, cin, cout) * 0.1, rnd(cout), rnd(cout), rnd(cout),
                8 if cout % 8 == 0 else 1)
        conv_inputs[(bsz, h, cin, cout)] = c_args
        for pb, eps in ((None, 1e-5), (rnd(bsz, cin), 1e-5)):
            got = fused_conv1d_gn_mish.kernel(*c_args, pb, eps)
            torch.cuda.synchronize()
            conv_err = max(conv_err, assert_close(f"fused_conv {(bsz, h, cin, cout)} pre_bias="
                                                  f"{pb is not None}", got,
                                                  fused_conv1d_gn_mish.plain(*c_args, pb, eps),
                                                  CONV_TOL))
    c_args = conv_inputs[CONV_SHAPES[-1]]
    pb = torch.randn((c_args[0].shape[0], c_args[0].shape[2]), generator=gen, device=dev)
    got = fused_conv1d_gn_mish.kernel(*c_args, pb, 1e-3)
    torch.cuda.synchronize()
    conv_err = max(conv_err, assert_close("fused_conv eps=1e-3", got,
                                          fused_conv1d_gn_mish.plain(*c_args, pb, 1e-3), CONV_TOL))
    n_conv = 2 * len(CONV_SHAPES) + 1
    if counts(fused_conv1d_gn_mish) != [(n_conv, n_conv)]:
        raise RuntimeError(f"conv: counts {counts(fused_conv1d_gn_mish)}; expected {n_conv} "
                           f"launches and {n_conv} plain calls")
    log("conv", t0, f"fused_conv max |kernel - plain|={conv_err:.3e} at {len(CONV_SHAPES)} shapes "
        f"with and without pre_bias and at eps 1e-3, atol = rtol = {CONV_TOL:.0e}; "
        f"launches={n_conv}, plain calls={n_conv}")

    # 16. the path that runs the conv kernel: the port's bench_kernels --quick
    t0 = time.perf_counter()
    wrappers.append(fused_conv1d_gn_mish)
    reset(*wrappers)
    bench_rows = bench_kernels.main(["--quick", "--skip-panda"])  # the panda rows: phase 43
    torch.cuda.synchronize()
    conv_launches = fused_conv1d_gn_mish.launches
    conv_rows = [r for r in bench_rows if r["kernel"] == "conv1d_gn_mish"]
    if (counts(*wrappers[:-1]) != [(0, 0)] * (len(wrappers) - 1) or not conv_launches
            or conv_launches != sum(r["launches"] for r in conv_rows)):
        raise RuntimeError(f"bench_kernels: counts {counts(*wrappers)}; expected the conv rows' "
                           f"{sum(r['launches'] for r in conv_rows)} conv launches and nothing "
                           f"of this script's other wrappers")
    for r in bench_rows:
        if r["kernel_us"] is None or r["max_abs_err"] is None or not r["max_abs_err"] <= r["tol"]:
            raise RuntimeError(f"bench_kernels: row {r}")
    # row 3's plain time: bench_kernels' plain 80-replan episode at phase 5's shapes, host clock
    episode_plain_ms = 1e-3 * next(r["plain_us"] for r in bench_rows
                                   if r["kernel"] == "cfg_episode_80step")
    log("bench-kernels", t0, f"{len(bench_rows)} rows, every kernel within its tolerance of its "
        f"plain twin: " + "; ".join(
            f"{r['kernel']}{r.get('shape', '')}{' +pre_bias' if r.get('pre_bias') else ''} "
            f"{r['max_abs_err']:.3e} <= {r['tol']:.0e}, {r['kernel_us']:.1f} us "
            f"(plain {r['plain_us']:.1f})" for r in bench_rows) + f"; fused_conv launches="
        f"{conv_launches}")

    # 17. the flagship's control quality with its dataset's statistics
    t0 = time.perf_counter()
    reset(*wrappers)
    par = flagship_parity.run_parity(dev, n_seeds=N_QUALITY, n_steps=N_STEPS)
    if counts(*wrappers) != [(0, 0)] * len(wrappers) or par["chain_launches"] != N_QUALITY * N_STEPS:
        raise RuntimeError(f"flagship quality: {par['chain_launches']} chain launches, counts "
                           f"{counts(*wrappers)}; expected {N_QUALITY * N_STEPS} launches of its "
                           f"own chain and nothing else")
    if not all(math.isfinite(c) for c in par["closed_loop_costs"]):
        raise RuntimeError(f"flagship quality: non-finite costs {par['closed_loop_costs']}")
    if not par["cost_over_expert"] <= FLAGSHIP_MEAN_MAX or par["modality"] != FLAGSHIP_MODALITY:
        raise RuntimeError(f"flagship quality: mean cost over the expert's "
                           f"{par['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}), modality "
                           f"{par['modality']} (expected {FLAGSHIP_MODALITY})")
    reset(*wrappers)
    epq = flagship_parity.run_episode_quality(dev, n_seeds=N_QUALITY, n_steps=N_STEPS)
    if counts(*wrappers) != [(0, 0)] * len(wrappers) or epq["episode_launches"] != N_QUALITY:
        raise RuntimeError(f"flagship quality, episode: {epq['episode_launches']} episode "
                           f"launches, counts {counts(*wrappers)}; expected {N_QUALITY} launches "
                           f"of its own episode and nothing else")
    if not all(math.isfinite(c) for c in epq["closed_loop_costs"]):
        raise RuntimeError(f"flagship quality, episode: non-finite costs {epq['closed_loop_costs']}")
    if not epq["cost_over_expert"] <= FLAGSHIP_MEAN_MAX or epq["modality"] != FLAGSHIP_MODALITY:
        raise RuntimeError(f"flagship quality, episode: mean cost over the expert's "
                           f"{epq['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}), modality "
                           f"{epq['modality']} (expected {FLAGSHIP_MODALITY})")
    log("flagship-quality", t0, f"{N_QUALITY} seeds, K=1, {N_STEPS} replans through cfg_chain "
        f"({par['chain_launches']} launches), the flagship's statistics: closed-loop costs "
        f"{[round(c, 3) for c in par['closed_loop_costs']]}; mean {par['closed_loop_cost_mean']:.3f} "
        f"(report {par['closed_loop_cost_report']}, its TPU expert {par['closed_loop_cost_nmpc']}), "
        f"over the JAX package's expert on the CPU ({par['expert_cost']:.3f}) "
        f"{par['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}); modality "
        f"{par['modality']} (report {par['modality_report']}); horizon cost mean "
        f"{par['horizon_cost_mean']:.1f} (report {par['horizon_cost_report']}, expert "
        f"{par['horizon_cost_nmpc']}); seed 0's parity with the JAX expert's tracks "
        f"{ {k: round(v, 5) for k, v in par['parity'].items()} } (report {par['parity_report']}); "
        f"through cfg_episode ({epq['episode_launches']} launches): closed-loop costs "
        f"{[round(c, 3) for c in epq['closed_loop_costs']]}; mean {epq['closed_loop_cost_mean']:.3f}, "
        f"over the expert's {epq['cost_over_expert']:.6f} (at most {FLAGSHIP_MEAN_MAX}); modality "
        f"{epq['modality']}")

    # 18. timing of the conv kernel: the launch alone as the device sees it (100 launches of
    # _launch captured into a CUDA graph, the graph replayed), the whole call, the kernel's device
    # time from torch.profiler (at the last shape, the kernels line's: a profiler session per
    # shape took ~1.5 s each), its plain version and the PyTorch calls of the same block
    t0 = time.perf_counter()
    conv_times = []
    for shape in CONV_SHAPES:
        c_args = conv_inputs[shape]
        x_c, w_c, b_c, g_c, be_c, groups = c_args
        xt, wt = x_c.transpose(1, 2).contiguous(), w_c.permute(2, 1, 0).contiguous()
        torch_seq = lambda: F.mish(F.group_norm(F.conv1d(xt, wt, b_c, padding=2), groups, g_c,
                                                be_c, 1e-5))
        seq_err = assert_close(f"torch_seq {shape}", torch_seq().transpose(1, 2),
                               fused_conv1d_gn_mish.plain(*c_args), CONV_TOL)
        bsz, h, cin, cout = shape
        alone = conv_timing.launch_alone(fused_conv1d_gn_mish, c_args)
        row = {"shape": list(shape), "launch_ms": conv_timing.graph_ms(alone),
               "ms": cuda_ms(lambda: fused_conv1d_gn_mish.kernel(*c_args), 50, 3),
               "profiler_ms": (conv_timing.profiler_ms(alone) if shape == CONV_SHAPES[-1]
                               else None),
               "plain_ms": cuda_ms(lambda: fused_conv1d_gn_mish.plain(*c_args), 10, 2),
               "torch_seq_ms": cuda_ms(torch_seq, 50, 3), "torch_seq_max_abs_err": seq_err,
               **bound(2 * bsz * h * 5 * cin * cout,
                       4 * (bsz * h * cin + 5 * cin * cout + 3 * cout + bsz * h * cout))}
        row["bound_share"] = row["bound_ms"] / row["launch_ms"]
        conv_times.append(row)
    log("timing-conv", t0, "; ".join(
        f"{c['shape']}: fused_conv launch alone {c['launch_ms']:.5f} ms, whole call {c['ms']:.5f} "
        f"(profiler " + ("none" if c["profiler_ms"] is None else f"{c['profiler_ms']:.5f}")
        + f"; plain {c['plain_ms']:.4f}, torch_seq {c['torch_seq_ms']:.4f}, bound "
        f"{c['bound_ms']:.6f} by {c['bound_by']}, {100 * c['bound_share']:.2f}% of the launch)"
        for c in conv_times))

    # 19. bf16 weights: the bf16 entries of the CFG chain and CFG episode against their plain
    # bf16 versions, first at one U-Net pass (where a correct kernel agrees but for an occasional
    # flipped rounding), then at full depth (where flips cascade and are only recorded)
    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    chain_bf = make_fused_cfg_chain(chain.packed, schedule, n_samples=1, w=W, n_tail=N_TAIL,
                                    weights_dtype=bf16, device=dev)
    sched1 = make_schedule("exponential", 1)  # one step: u_norm = clip(x - 0.01 eps_cfg)
    one = make_fused_cfg_chain(chain.packed, sched1, n_samples=N_ONE_PASS, w=W, n_tail=0,
                               weights_dtype=bf16, device=dev)
    ctx_one = torch.randn((N_ONE_PASS, 5), generator=gen, device=dev)
    noise_one = torch.randn((2, N_ONE_PASS, HORIZON, 1), generator=gen, device=dev)
    got = one.kernel(ctx_one, noise_one)
    torch.cuda.synchronize()
    one_chain = one_pass_gate("cfg_chain_bf16 one pass", got, one.plain(ctx_one, noise_one))
    ep_one = lambda k, n_steps, sel_h=None: make_fused_cfg_episode(
        chain.packed, sched1, inputs_stats, cond_stats, plant, cost, n_steps=n_steps, w=W,
        n_diffusion_steps_without_noise=0, n_candidates=k, selection_horizon=sel_h,
        weights_dtype=bf16, device=dev)
    one_ep, one_chosen = {}, []
    for k, n_steps, sel_h in ((1, N_ONE_PASS, None), (K4, N_STEPS_K4, SEL_H)):
        ep = ep_one(k, n_steps, sel_h)
        nz = torch.randn(ep.noise_shape, generator=gen, device=dev)
        got, want = ep.kernel(x0, nz), ep.plain(x0, nz)
        torch.cuda.synchronize()
        one_ep[k] = one_pass_gate(f"cfg_episode_bf16 K={k} one pass per replan",
                                  got[1][:, :, None] / U_HALF_RANGE, want[1][:, :, None] / U_HALF_RANGE)
        if not torch.equal(got[3], want[3]):
            raise RuntimeError(f"cfg_episode_bf16 K={k} one pass per replan: chosen "
                               f"{got[3].tolist()} vs plain {want[3].tolist()}")
        if k > 1:
            one_chosen = got[3].tolist()
    # full depth: phase 3's contexts, phase 4's noise through 80 replans, K = 4 over 8
    chain_bf_err = 0.0
    for ctx in contexts:
        got = chain_bf.kernel(ctx, noise)
        torch.cuda.synchronize()
        chain_bf_err = max(chain_bf_err, assert_close("cfg_chain_bf16", got,
                                                      chain_bf.plain(ctx, noise), BF16_VS_FP32))
    ep_bf = make_fused_cfg_episode(chain.packed, schedule, inputs_stats, cond_stats, plant, cost,
                                   n_steps=N_BF16_EP, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                   weights_dtype=bf16, device=dev)
    bf_noise = ep_noise[:N_BF16_EP]
    got_bf = ep_bf.kernel(x0, bf_noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_bf = ep_bf.plain(x0, bf_noise)
    torch.cuda.synchronize()
    plain_bf_episode_s = time.perf_counter() - t1
    du_bf = assert_close(f"cfg_episode_bf16 {N_BF16_EP} replans u_norm", got_bf[1] / U_HALF_RANGE,
                         want_bf[1] / U_HALF_RANGE, BF16_VS_FP32)
    dx_bf = (got_bf[0].double() - want_bf[0].double()).abs().max().item()
    du_vs_fp32 = ((got_bf[1] - res.u_track[:N_BF16_EP]).abs().max() / U_HALF_RANGE).item()
    ep4_bf = make_fused_cfg_episode(chain.packed, schedule, inputs_stats, cond_stats, plant, cost,
                                    n_steps=N_STEPS_K4, w=W, n_diffusion_steps_without_noise=N_TAIL,
                                    n_candidates=K4, selection_horizon=SEL_H, weights_dtype=bf16,
                                    device=dev)
    got4_bf, want4_bf = ep4_bf.kernel(x0, noise4), ep4_bf.plain(x0, noise4)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in (*got_bf[:3], *got4_bf[:3])):
        raise RuntimeError("bf16 episodes: non-finite tracks")
    same4 = int((got4_bf[3] == want4_bf[3]).sum())
    log("bf16", t0, f"one pass (T = 1): cfg_chain_bf16 over {N_ONE_PASS} samples "
        f"{fmt_gate(one_chain)}; cfg_episode_bf16 K=1 over {N_ONE_PASS} replans "
        f"{fmt_gate(one_ep[1])}; K={K4} over {N_STEPS_K4} replans {fmt_gate(one_ep[K4])}, chosen "
        f"{one_chosen} in both. Full depth (T = {T} + {N_TAIL}): cfg_chain_bf16 max |kernel - "
        f"plain| {chain_bf_err:.3e} over {len(contexts)} contexts; cfg_episode_bf16 {N_BF16_EP} "
        f"replans on phase 4's noise: max |du_norm| {du_bf:.3e}, max |dx| {dx_bf:.3e}, total "
        f"cost kernel {got_bf[2].sum().item():.6f} plain {want_bf[2].sum().item():.6f} (fp32 "
        f"per-replan loop {res.stage_costs[:N_BF16_EP].sum().item():.6f}), max "
        f"|du_norm| against the fp32 per-replan loop {du_vs_fp32:.3e}; K={K4} over "
        f"{N_STEPS_K4} replans chosen {got4_bf[3].tolist()} vs plain {want4_bf[3].tolist()} "
        f"({same4} of {N_STEPS_K4} equal); full depth gated at {BF16_VS_FP32:.0e} only (two "
        f"correct bf16 versions part by a flipped rounding that cascades); plain episode "
        f"{plain_bf_episode_s:.3f}s by the host clock")

    # 20. the flagship's quality through the bf16 episode (recorded, not gated: no bf16 report)
    t0 = time.perf_counter()
    reset(*wrappers)
    epq_bf = flagship_parity.run_episode_quality(dev, n_seeds=N_BF16_QUALITY, n_steps=N_STEPS,
                                                 weights_dtype=bf16)
    if (counts(*wrappers) != [(0, 0)] * len(wrappers)
            or epq_bf["episode_launches"] != N_BF16_QUALITY):
        raise RuntimeError(f"bf16 quality: {epq_bf['episode_launches']} episode launches, counts "
                           f"{counts(*wrappers)}; expected {N_BF16_QUALITY} launches of its own "
                           f"episode and nothing else")
    if not all(math.isfinite(c) for c in epq_bf["closed_loop_costs"]):
        raise RuntimeError(f"bf16 quality: non-finite costs {epq_bf['closed_loop_costs']}")
    log("bf16-quality", t0, f"{N_BF16_QUALITY} seeds through cfg_episode_bf16 "
        f"({epq_bf['episode_launches']} launches), the flagship's statistics: closed-loop costs "
        f"{[round(c, 3) for c in epq_bf['closed_loop_costs']]}; mean "
        f"{epq_bf['closed_loop_cost_mean']:.3f}, over the expert's "
        f"{epq_bf['cost_over_expert']:.6f} (fp32 {epq['cost_over_expert']:.6f}); modality "
        f"{epq_bf['modality']}")

    # 21. the port's bench: the default mode by its own entry point, in a process of its own,
    # with bench.py's protocol cut (BENCH_SMOKE=1); then the
    # other four combinations in this process, cut
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k not in ("BENCH_FUSED", "BENCH_BF16")}
    env["BENCH_SMOKE"] = "1"
    proc = subprocess.run([sys.executable, "-m", "mpc_via_diffusion_model_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"bench exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    bench_lines = proc.stdout.strip().splitlines()
    bench_line = json.loads(bench_lines[-1])
    if list(bench_line) != BENCH_EPISODE_KEYS or not bench_line["value"] > 0:
        raise RuntimeError(f"bench: last line {bench_lines[-1]}; expected bench.py's keys "
                           f"{BENCH_EPISODE_KEYS}")
    print(bench_lines[-2], flush=True)
    print(bench_lines[-1], flush=True)
    bench_runs = {}
    for mode, use_bf16, cut in (("episode", True, dict(n_rep=1, n_chain=1, n_best=1)),
                                ("chain", False, dict(n_rep=1, n_steps=20)),
                                ("chain", True, dict(n_rep=1, n_steps=20)),
                                ("1", False, dict(n_rep=1, n_steps=5))):
        r = port_bench.run(mode, use_bf16, dev, **cut)
        if r.launches != port_bench.expected_calls(mode, **cut) or r.plain_calls:
            raise RuntimeError(f"bench {mode} bf16={use_bf16}: {r.launches} launches, "
                               f"{r.plain_calls} plain calls")
        bench_runs[mode, use_bf16] = r
        print(f"bench BENCH_FUSED={mode} BENCH_BF16={int(use_bf16)} {cut}: {r.launches} "
              f"{r.wrapper} launches; " + json.dumps(r.line), flush=True)
    log("bench", t0, f"python3 -m mpc_via_diffusion_model_tpu_torch.bench: {bench_lines[-1]}; "
        f"in process, cut: " + "; ".join(
            f"{m}{' bf16' if b else ''} {r.line['value']} Hz ({r.launches} launches)"
            for (m, b), r in bench_runs.items()))

    # bf16 timing at the main paths' shapes
    chain_bf_ms = cuda_ms(lambda: chain_bf.kernel(contexts[0], noise), n=20, warmup=3)
    chain_bf_plain_ms = cuda_ms(lambda: chain_bf.plain(contexts[0], noise), n=2, warmup=0)
    ep_bf_ms = cuda_ms(lambda: ep_bf.kernel(x0, bf_noise), n=5, warmup=1)
    log("timing-bf16", t0, f"cfg_chain_bf16 {chain_bf_ms:.4f} ms (fp32 {chain_ms:.4f}; plain "
        f"{chain_bf_plain_ms:.4f}) per replan; cfg_episode_bf16 K=1 {ep_bf_ms:.3f} ms per "
        f"{N_BF16_EP}-replan episode, {ep_bf_ms / N_BF16_EP:.4f} per replan (fp32 "
        f"{episode_ms / N_STEPS:.4f}; plain {1e3 * plain_bf_episode_s:.1f} per episode by the host "
        "clock)")

    # 22. the LMPC workload's kernels against their plain versions on its committed weights at
    # full width: the CFG chain at horizon 8 and context 4, and the CFG episode's linear cart-pole
    # entry (cfg_episode_lmpc)
    t0 = time.perf_counter()
    lmodel = load_lmpc(LMPC, device=dev)
    l_ins, l_cond = lmpc_stats()
    lx0 = lmpc_parity.sweep_states(1)[0].to(dev)
    lchain = make_fused_cfg_chain(lmodel, schedule, n_samples=1, w=W, n_tail=N_TAIL, device=dev)
    lchain8 = make_fused_cfg_chain(lchain.packed, schedule, n_samples=K8, w=W, n_tail=N_TAIL,
                                   device=dev)
    l_noise = torch.randn((n_total + 1, 1, LMPC_H, 1), generator=gen, device=dev)
    l_contexts = [normalize(l_cond.to(dev), lx0)[None]] + [
        torch.randn((1, 4), generator=gen, device=dev) for _ in range(2)]
    l_ctx8 = torch.randn((K8, 4), generator=gen, device=dev)
    l_noise8 = torch.randn((n_total + 1, K8, LMPC_H, 1), generator=gen, device=dev)
    lchain_err = 0.0
    for ch, c_, nz in [(lchain, c_, l_noise) for c_ in l_contexts] + [(lchain8, l_ctx8, l_noise8)]:
        got = ch.kernel(c_, nz)
        torch.cuda.synchronize()
        lchain_err = max(lchain_err, assert_close(f"cfg_chain H={LMPC_H} B={ch.n_samples}", got,
                                                  ch.plain(c_, nz), CHAIN_TOL))
    lep = lambda k, n_steps: make_fused_cfg_episode(
        lchain.packed, schedule, l_ins, l_cond, cartpole_lmpc(), cartpole_lmpc_cost(),
        n_steps=n_steps, w=W, n_diffusion_steps_without_noise=N_TAIL, n_candidates=k, device=dev)
    lep1, lep8 = lep(1, N_LMPC_EP), lep(K8, N_LMPC_EP8)
    l_ep_noise = torch.randn(lep1.noise_shape, generator=gen, device=dev)
    l_ep_noise8 = torch.randn(lep8.noise_shape, generator=gen, device=dev)
    lep_err, l_chosen, l_ties = 0.0, {}, []
    for ep, nz in ((lep1, l_ep_noise), (lep8, l_ep_noise8)):
        got = ep.kernel(lx0, nz)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = ep.plain(lx0, nz)
        torch.cuda.synchronize()
        if ep is lep1:
            lep_plain_s = time.perf_counter() - t1
        k = ep.n_candidates
        for name, g, w_ in zip(("x_track", "u_track", "stage_costs"), got, want):
            lep_err = max(lep_err, assert_close(f"cfg_episode_lmpc K={k} {name}", g, w_, TRACK_TOL))
        for i in range(ep.n_steps):
            if k > 1 and near_tie(ep.plain_scores[i]):
                best2 = torch.sort(ep.plain_scores[i].double()).values[:2].tolist()
                l_ties.append(f"replan {i}: best two plain scores {best2[0]:.9g}, {best2[1]:.9g}; "
                              f"kernel chose {int(got[3][i])}, plain {int(want[3][i])}")
            elif got[3][i] != want[3][i]:
                raise RuntimeError(f"cfg_episode_lmpc K={k}: replan {i} chosen {got[3].tolist()} "
                                   f"vs plain {want[3].tolist()}, scores "
                                   f"{ep.plain_scores[i].tolist()}")
        l_chosen[k] = (got[3].tolist(), want[3].tolist())
    if counts(lchain, lchain8, lep1, lep8) != [(3, 3), (1, 1), (1, 1), (1, 1)]:
        raise RuntimeError(f"LMPC kernels vs plain: counts {counts(lchain, lchain8, lep1, lep8)}")
    log("lmpc-kernel-vs-plain", t0, f"cfg_chain at H={LMPC_H}, context 4: max |kernel - plain| "
        f"{lchain_err:.3e} over {len(l_contexts)} contexts at B=1 and one at B={K8} (tol "
        f"{CHAIN_TOL:.0e}); cfg_episode_lmpc from the sweep's first state, K=1 {N_LMPC_EP} "
        f"replans and K={K8} {N_LMPC_EP8}: max |kernel - plain| {lep_err:.3e} (tol "
        f"{TRACK_TOL:.0e}); chosen (kernel, plain) {l_chosen}; near-ties (best two plain scores "
        f"within {NEAR_TIE:.0e}, not gated): {len(l_ties)}: " + " | ".join(l_ties))

    # 23. the LMPC parity workload: scripts/lmpc_parity.py's episode route over the 16 sweep
    # states, 50 replans each, n = 1 gated against the JAX package's loop on the CPU, K = 8
    # reported; the chain route on the first states' noise; the kernels' times
    t0 = time.perf_counter()
    lwrappers = [lchain, lchain8, lep1, lep8]
    reset(*wrappers, *lwrappers)
    lpar = lmpc_parity.run(dev, "episode", candidates=(1,))
    n_states = lpar["n_states"]
    if counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4) or \
            lpar["launches"][1] != n_states:
        raise RuntimeError(f"LMPC parity: {lpar['launches']} episode launches, counts "
                           f"{counts(*wrappers, *lwrappers)}; expected {n_states} launches of its "
                           f"own episode and nothing else")
    for x_tr, u_tr, _ in lpar["tracks"][1]:
        if not (torch.isfinite(x_tr).all() and torch.isfinite(u_tr).all()):
            raise RuntimeError("LMPC parity: non-finite tracks")
    u_l1 = lpar["per_state_u_l1"][1]
    off = [(i, got, want) for i, (got, want) in enumerate(zip(u_l1, LMPC_U_L1))
           if not abs(got - want) <= LMPC_ABS + LMPC_REL * want]
    jax_mean = LMPC_U_L1_SUMMARY[0]
    if off or not abs(lpar["u_l1_mean"] - jax_mean) <= LMPC_REL * jax_mean:
        raise RuntimeError(f"LMPC parity: states off the JAX package's u_l1 (state, port, JAX): "
                           f"{off}; mean {lpar['u_l1_mean']:.6f} against {jax_mean:.6f}")
    k1_s = time.perf_counter() - t0
    reset(*wrappers, *lwrappers)
    t1 = time.perf_counter()
    lpar8 = lmpc_parity.run(dev, "episode", n_states=N_LMPC_STATES_K8, candidates=(K8,))
    k8_s = time.perf_counter() - t1
    if counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4) or \
            lpar8["launches"][K8] != N_LMPC_STATES_K8:
        raise RuntimeError(f"LMPC parity K={K8}: {lpar8['launches']} episode launches, counts "
                           f"{counts(*wrappers, *lwrappers)}")
    k8_tracks = lpar8["tracks"][K8]
    if not all(torch.isfinite(x_tr).all() for x_tr, _, _ in k8_tracks):
        raise RuntimeError(f"LMPC parity K={K8}: non-finite tracks")
    not_first = sum(int((chosen != 0).sum()) for _, _, chosen in k8_tracks)
    # the spread of the 8 candidates' first controls, through the chain kernel at B = 8 on the
    # K = 8 run's states and noise of the first states (launches outside the counted runs)
    spread = 0.0
    for i in range(N_LMPC_CHAIN_STATES):
        nz_all = lmpc_parity.state_noise(i, (lmpc_parity.N_STEPS, *lep8.noise_shape[1:]), dev)
        x_tr = k8_tracks[i][0]
        for step in range(lmpc_parity.N_STEPS):
            l_ctx = normalize(l_cond.to(dev), x_tr[step]).expand(K8, 4).contiguous()
            u0 = unnormalize(l_ins.to(dev), lchain8.kernel(l_ctx, nz_all[step]))[:, 0, 0]
            spread = max(spread, (u0.max() - u0.min()).item())
    reset(*wrappers, *lwrappers)
    lpar_chain = lmpc_parity.run(dev, "chain", n_states=N_LMPC_CHAIN_STATES, candidates=(1,))
    n_chain_launches = lpar_chain["launches"][1]
    if n_chain_launches != N_LMPC_CHAIN_STATES * lmpc_parity.N_STEPS or \
            counts(*wrappers, *lwrappers) != [(0, 0)] * (len(wrappers) + 4):
        raise RuntimeError(f"LMPC parity, chain route: {n_chain_launches} chain launches, counts "
                           f"{counts(*wrappers, *lwrappers)}")
    route_err = 0.0
    for i, ((xc, uc, _), (xe, ue, _)) in enumerate(zip(lpar_chain["tracks"][1], lpar["tracks"][1])):
        route_err = max(route_err, assert_close(f"LMPC state {i} chain route x_track", xc, xe,
                                                TRACK_TOL),
                        assert_close(f"LMPC state {i} chain route u_track", uc, ue, TRACK_TOL))
    fmt4 = lambda d: " / ".join(f"{d[k]:.4f}" for k in lmpc_parity.KEYS[:4])
    report = lpar["report"]
    lmpc_line = {
        "n1": {k: lpar[k] for k in lmpc_parity.KEYS}, "n1_per_state_u_l1": u_l1,
        "k8": lpar8[f"candidates{K8}"], "k8_states": N_LMPC_STATES_K8,
        "k8_per_state_u_l1": lpar8["per_state_u_l1"][K8], "k8_choices_not_0": not_first,
        "k8_choices": N_LMPC_STATES_K8 * lmpc_parity.N_STEPS, "k8_first_control_spread": spread,
        "jax_cpu": lpar["jax_cpu"], "report": report, "chain_route_max_abs_err": route_err}
    print(json.dumps({"lmpc_parity": lmpc_line}), flush=True)
    log("lmpc-parity", t0, f"episode route, {n_states} states x {lmpc_parity.N_STEPS} replans, "
        f"n=1 ({lpar['launches'][1]} launches, {k1_s:.3f}s): u_l1 mean/median/best/worst "
        f"{fmt4(lpar)} (JAX on the CPU {fmt4(lpar['jax_cpu'])}; report.json {fmt4(report)}), "
        f"u_step_max_mean {lpar['u_step_max_mean']:.5f}; every state within {LMPC_ABS:.0e} + "
        f"{LMPC_REL:.0%} of the JAX package's, the mean within {LMPC_REL:.0%}. K={K8} over "
        f"{N_LMPC_STATES_K8} states ({lpar8['launches'][K8]} launches, {k8_s:.3f}s, not gated): "
        f"{fmt4(lpar8[f'candidates{K8}'])} (report.json {fmt4(report['candidates8'])}); "
        f"{not_first} of {N_LMPC_STATES_K8 * lmpc_parity.N_STEPS} choices not candidate 0; the "
        f"8 candidates' first controls spread at most {spread:.3e} over the first "
        f"{N_LMPC_CHAIN_STATES} states' replans. Chain route over the first "
        f"{N_LMPC_CHAIN_STATES} states ({n_chain_launches} cfg_chain launches): tracks within "
        f"{route_err:.3e} of the episode's (tol {TRACK_TOL:.0e})")

    # the LMPC kernels' times at the workload's shapes
    lep1_ms = cuda_ms(lambda: lep1.kernel(lx0, l_ep_noise), n=5, warmup=1)
    lep8_ms = cuda_ms(lambda: lep8.kernel(lx0, l_ep_noise8), n=3, warmup=1)
    lchain_ms = cuda_ms(lambda: lchain.kernel(l_contexts[0], l_noise), n=20, warmup=3)
    lchain8_ms = cuda_ms(lambda: lchain8.kernel(l_ctx8, l_noise8), n=20, warmup=3)
    lchain_plain_ms = cuda_ms(lambda: lchain.plain(l_contexts[0], l_noise), n=3, warmup=1)
    log("timing-lmpc", t0, f"cfg_episode_lmpc K=1 {lep1_ms:.3f} ms per {N_LMPC_EP}-replan "
        f"episode = {lep1_ms / N_LMPC_EP:.4f} ms per replan (plain {1e3 * lep_plain_s:.1f} ms by "
        f"the host clock); K={K8} {lep8_ms / N_LMPC_EP8:.4f} ms per replan; cfg_chain at "
        f"H={LMPC_H} {lchain_ms:.4f} ms per replan at B=1, {lchain8_ms:.4f} at B={K8} (plain "
        f"{lchain_plain_ms:.4f})")

    training_line = train_phases(dev, schedule)
    ilqr_line = ilqr_phases(dev)
    distill_line = distill_phases(dev)
    quad_line = quadrotor_phases(dev)
    scene_line = scene_phases(dev)
    guided_line = guided_phases(dev)
    making_dir = ROOT / "build" / "chip_smoke_making"
    shutil.rmtree(making_dir, ignore_errors=True)
    making_line = making_phases(dev, making_dir)
    shutil.rmtree(making_dir, ignore_errors=True)
    panda_line = panda_phases(dev)
    panda_cfg_line = panda_cfg_phases(dev)
    b1_line = b1_phases(dev)
    clip_line = clip_phases(dev)
    distill_panda_line = distill_panda_phases(dev)

    packed = chain.packed
    seg = lambda *prefixes: sum(math.prod(shape) for name, (_, shape) in packed.segments.items()
                                if name.split(".")[0] in prefixes)
    weights = packed.weights.numel()
    backbone_w = weights - seg("films", "final1x1")
    chain_weights = weights - seg("films")
    meta_n = packed.metas[1].numel()
    # cfg_chain: one replan, B = 1 (conv FLOPs of both row-sets at every step)
    chain_flops = packed.flops_per_pass * 2 * chain.n_samples * n_total
    chain_bytes = 4 * (chain_weights + meta_n + chain.films(ctx).numel() + noise.numel()
                       + chain.coefs.numel() + HORIZON)
    # fused_unet: one pass at batch 2, backbone only
    x_u = args[0]
    unet_flops = 2 * (packed.flops_per_pass - packed.flops_final_1x1)
    unet_bytes = 4 * (backbone_w + meta_n + unet.films(unet.model.conditioning(*args[1:])).numel()
                      + x_u.numel() + x_u.shape[0] * HORIZON * model.unet_input_dim)
    # cfg_episode: one 80-replan episode at K = 1, FiLM in the kernel included
    film_flops = 2 * 2 * int(packed.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in model.res_blocks())
    ep_flops = N_STEPS * n_total * (chain_flops / n_total + film_flops)
    # the bf16 episode of phase 19: N_BF16_EP replans
    bf_ep_bytes = 4 * (weights + meta_n + ep1.t_embs.numel() + bf_noise.numel() + ep1.coefs.numel()
                       + ep1.consts.numel() + 5 + (N_BF16_EP + 1) * 5 + N_BF16_EP * 3)
    ep_bytes = 4 * (weights + meta_n + ep1.t_embs.numel() + ep_noise.numel() + ep1.coefs.numel()
                    + ep1.consts.numel() + 5 + (N_STEPS + 1) * 5 + N_STEPS * 3)
    # ddim_chain: one replan on the student's grid, B = 1 (one row-set per step); the student
    # has the flagship's architecture, so the weight counts above are its own
    if spacked.weights.numel() != weights or spacked.metas[1].numel() != meta_n:
        raise RuntimeError("the student's packed U-Net differs in size from the flagship's")
    schain_flops = spacked.flops_per_pass * schain.n_samples * schain.n_total
    schain_bytes = 4 * (chain_weights + meta_n + schain.films(sctx).numel() + sx_init.numel()
                        + schain.coefs.numel() + HORIZON)
    # ddim_episode: one 80-replan episode at K = 1, the FiLM of one group in the kernel included
    sep_flops = N_STEPS * sep1.n_total * (spacked.flops_per_pass + film_flops / 2)
    sep_bytes = 4 * (weights + meta_n + sep1.t_embs.numel() + s_noise.numel() + sep1.coefs.numel()
                     + sep1.consts.numel() + 5 + (N_STEPS + 1) * 5 + N_STEPS * 3)
    # the bf16 entries read every conv kernel (the body's and the final 1x1) as 2 bytes, the rest
    # as 4: the same operations, fewer bytes, the conv products at the bf16 rate
    conv_w = sum(math.prod(packed.segments[name][1])
                 for name in [*chain_bf.cluster.split.convs, "final1x1.w"])
    bf16_row = lambda name, source_row, launches, err, ms, plain_ms, conv_flops, fp32_flops, \
            n_bytes, **extra: {
        "name": name, "route": "cuda", "source": source_row["source"],
        "replaces": source_row["replaces"], "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, **bound(fp32_flops, n_bytes - 2 * conv_w, bf16_flops=conv_flops),
        "library_ms": None,
        "weights_dtype": "bfloat16", "bf16_weight_bytes_saved": 2 * conv_w,
        "registers": cluster_info[name]["registers"],
        "spill_bytes": cluster_info[name]["spill_bytes"],
        "clusters_fit": cluster_info[name]["clusters_fit"], **extra}
    rows = [
        {"name": "cfg_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:47",
         "launches": chain_launches, "max_abs_err": chain_err, "ms": chain_ms,
         "plain_ms": chain_plain_ms, **bound(chain_flops, chain_bytes), "library_ms": None,
         "per_replan_loop_hz": per_replan_hz, "cluster_ctas": CLUSTER, **cluster_info["cfg_chain"]},
        {"name": "fused_unet", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/fused_unet.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_unet.py:387",
         "launches": unet_launches, "max_abs_err": unet_err, "ms": unet_ms,
         "plain_ms": unet_plain_ms, **bound(unet_flops, unet_bytes), "library_ms": None,
         "call_ms": unet_call_ms, "launches_per_replan": unet_launches // N_UNET_LOOP,
         "bench_fused_loop_hz": unet_loop_hz, "cluster_ctas": CLUSTER,
         **cluster_info["fused_unet"]},
        {"name": "cfg_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
         "launches": episode_launches, "max_abs_err": ep_err, "ms": episode_ms,
         "plain_ms": episode_plain_ms, **bound(ep_flops, ep_bytes), "library_ms": None,
         "ms_per_replan": episode_ms / N_STEPS, "k4_ms_per_replan": episode4_ms / N_STEPS_K4,
         "closed_loop_control_hz": control_hz, "cluster_ctas": CLUSTER,
         "flagship_cost_over_expert": epq["cost_over_expert"], **cluster_info["cfg_episode"]},
        {"name": "ddim_chain", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_chain.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_denoise.py:164",
         "launches": s_chain_launches, "max_abs_err": schain_err, "ms": schain_ms,
         "plain_ms": schain_plain_ms, **bound(schain_flops, schain_bytes), "library_ms": None,
         "times": GRID, "call_ms": schain_call_ms, "grid3_ms": schain3_ms,
         "b4_ms": schain4_ms, "per_replan_loop_hz": s_per_replan_hz, "cluster_ctas": CLUSTER,
         **cluster_info["ddim_chain"]},
        {"name": "ddim_episode", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/ddim_episode.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:142",
         "launches": s_episode_launches, "max_abs_err": sep_err, "ms": sep_ms,
         "plain_ms": sep_plain_ms, **bound(sep_flops, sep_bytes), "library_ms": None,
         "times": GRID, "ms_per_replan": sep_ms / N_STEPS,
         "grid3_ms_per_replan": sep3_ms / N_STEPS, "k4_ms_per_replan": sep4_ms / N_STEPS_K4,
         "student_closed_loop_control_hz": s_control_hz, "cost_ratio_mean": ratio_mean,
         "cost_ratio_max": ratio_max, "cluster_ctas": CLUSTER, **cluster_info["ddim_episode"]},
        # at the bench's largest shape, (64, 8, 64, 128); every shape in "shapes"
        {"name": "fused_conv", "route": "cuda",
         "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/fused_conv.cu",
         "replaces": "mpc_via_diffusion_model_tpu/ops/fused_conv.py:126",
         "launches": conv_launches, "max_abs_err": conv_err,
         **{k: conv_times[-1][k] for k in ("ms", "launch_ms", "profiler_ms", "plain_ms",
                                           "bound_ms", "bound_by", "bound_share")},
         "library_ms": None, "torch_seq_ms": conv_times[-1]["torch_seq_ms"],
         "shape": conv_times[-1]["shape"], "shapes": conv_times, **conv_info,
         "flagship_cost_over_expert": par["cost_over_expert"]},
    ]
    rows[0]["bf16"] = bf16_row(
        "cfg_chain_bf16", rows[0], bench_runs["chain", True].launches, one_chain["max"],
        chain_bf_ms, chain_bf_plain_ms, chain_flops, 0, chain_bytes, one_pass=one_chain,
        full_depth_max_abs_err=chain_bf_err, bench_chain_hz=bench_runs["chain", True].line["value"])
    rows[2]["bf16"] = bf16_row(
        "cfg_episode_bf16", rows[2], bench_runs["episode", True].launches, one_ep[1]["max"],
        ep_bf_ms, 1e3 * plain_bf_episode_s, N_BF16_EP * chain_flops,
        N_BF16_EP * n_total * film_flops, bf_ep_bytes, replans=N_BF16_EP,
        one_pass=one_ep[1],
        one_pass_k4=one_ep[K4], full_depth_max_abs_err_u_norm=du_bf,
        full_depth_max_abs_err_x=dx_bf, k4_full_depth_chosen_equal=same4,
        bench_episode_hz=bench_runs["episode", True].line["value"],
        flagship_cost_over_expert=epq_bf["cost_over_expert"], flagship_modality=epq_bf["modality"])
    # the LMPC workload: cfg_episode_lmpc, a further entry of kernel 3, at phase 22's 10-replan
    # K = 1 episode; the CFG chain at horizon 8 (under row 1's "h8"), one replan at B = 1
    lpacked = lchain.packed
    l_weights, l_meta = lpacked.weights.numel(), lpacked.metas[1].numel()
    l_film_w = sum(math.prod(shape) for name, (_, shape) in lpacked.segments.items()
                   if name.split(".")[0] == "films")
    l_film_flops = 2 * 2 * int(lpacked.films_w.shape[1]) * sum(
        rb.cond_mlp[1].out_features for rb in lmodel.res_blocks())
    l_chain_flops = lpacked.flops_per_pass * 2 * n_total
    l_chain_bytes = 4 * (l_weights - l_film_w + l_meta + lchain.films(l_contexts[0]).numel()
                         + l_noise.numel() + lchain.coefs.numel() + LMPC_H)
    l_ep_flops = N_LMPC_EP * n_total * (l_chain_flops / n_total + l_film_flops)
    l_ep_bytes = 4 * (l_weights + l_meta + lep1.t_embs.numel() + l_ep_noise.numel()
                      + lep1.coefs.numel() + lep1.consts.numel() + 4 + (N_LMPC_EP + 1) * 4
                      + N_LMPC_EP * 3)
    rows[0]["h8"] = {
        "name": "cfg_chain", "route": "cuda", "source": rows[0]["source"],
        "replaces": rows[0]["replaces"], "launches": n_chain_launches,
        "max_abs_err": lchain_err, "ms": lchain_ms, "plain_ms": lchain_plain_ms,
        **bound(l_chain_flops, l_chain_bytes), "library_ms": None, "model": "flagship_lmpc",
        "horizon": LMPC_H, "context_dim": 4, "b8_ms": lchain8_ms}
    rows.append({
        "name": "cfg_episode_lmpc", "route": "cuda",
        "source": "mpc_via_diffusion_model_tpu_torch/ops/csrc/cfg_episode_lmpc.cu",
        "replaces": "mpc_via_diffusion_model_tpu/ops/fused_episode.py:410",
        "entry_of": "cfg_episode", "plant": "cartpole_lmpc",
        "launches": lpar["launches"][1] + lpar8["launches"][K8], "max_abs_err": lep_err,
        "ms": lep1_ms, "plain_ms": 1e3 * lep_plain_s, **bound(l_ep_flops, l_ep_bytes),
        "library_ms": None, "replans": N_LMPC_EP, "ms_per_replan": lep1_ms / N_LMPC_EP,
        "k8_ms_per_replan": lep8_ms / N_LMPC_EP8, "u_l1_mean": lpar["u_l1_mean"],
        "u_l1_mean_jax_cpu": jax_mean, "cluster_ctas": CLUSTER,
        **cluster_info["cfg_episode_lmpc"]})
    # the first launches at horizon 64 (phase 30), each under its kernel's row
    for i, name in ((2, "cfg_episode"), (3, "ddim_chain"), (4, "ddim_episode")):
        rows[i]["h64"] = {"name": name, "route": "cuda", "source": rows[i]["source"],
                          "replaces": rows[i]["replaces"], **distill_line["h64"][name]}
    # the quadrotor student at horizon 48 (phases 32-34): the DDIM chain and episode under
    # their rows' "h48", the quadrotor's episode entry a row of its own with its in-kernel draw
    for i, name in ((3, "ddim_chain"), (4, "ddim_episode")):
        rows[i]["h48"] = {"name": name, "route": "cuda", "source": rows[i]["source"],
                          "replaces": rows[i]["replaces"], **quad_line["h48"][name]}
    rows.append({**quad_line["row"], "cluster_ctas": CLUSTER,
                 **cluster_info["ddim_episode_quadrotor"]})
    # the scene-conditioned student (phases 35-37): the CFG chain at H = 48 and context 24 under
    # row 1's "h48", the quadrotor's CFG episode entry a row of its own
    rows[0]["h48"] = {"name": "cfg_chain", "route": "cuda", "source": rows[0]["source"],
                      "replaces": rows[0]["replaces"], **scene_line["h48"]}
    rows.append({**scene_line["row"], "cluster_ctas": CLUSTER,
                 **cluster_info["cfg_episode_quadrotor"]})
    # the quadrotor flagship's teacher (phases 38-40): the CFG chain and the U-Net pass at H = 48,
    # context 12 under rows 1's and 2's "h48_ctx12"
    for i, name in ((0, "cfg_chain"), (1, "fused_unet")):
        rows[i]["h48_ctx12"] = {"name": name, "route": "cuda", "source": rows[i]["source"],
                                "replaces": rows[i]["replaces"], **guided_line[name]}
    # the scene study's making half (phases 41-42): the U-Net pass at 2 x 2,048 rows and the
    # CFG chain at 256 x 16 samples under rows 2's and 1's "b4096"
    for i, name in ((0, "cfg_chain"), (1, "fused_unet")):
        rows[i]["b4096"] = {"name": name, "route": "cuda", "source": rows[i]["source"],
                            "replaces": rows[i]["replaces"], **making_line[name]}
    # the panda student at horizon 128 (phases 43-45): the U-Net pass and the DDIM chain under
    # their rows' "panda", the arm's episode entry a row of its own
    for i, name in ((1, "fused_unet"), (3, "ddim_chain")):
        rows[i]["panda"] = {"name": name, "route": "cuda", "source": rows[i]["source"],
                            "replaces": rows[i]["replaces"], **panda_line[name]}
    rows.append({**panda_line["row"], "cluster_ctas": CLUSTER,
                 **cluster_info["ddim_episode_panda"]})
    # the panda teacher (phases 46-48): the CFG chain in turns at horizon 128 under row 1's "panda"
    # (its bf16 entry under "bf16" there) and on the flagship under "flagship_turns", kernel 3's
    # panda entry a row of its own with its drawing entry under "inkernel_noise"
    rows[0]["panda"] = {**panda_cfg_line["cfg_chain"], "cluster_ctas": CLUSTER,
                        **cluster_info["cfg_chain_turns"]}
    rows[0]["panda"]["bf16"].update(cluster_info["cfg_chain_turns_bf16"])
    rows[0]["flagship_turns"] = panda_cfg_line["flagship_turns"]
    rows.append({**panda_cfg_line["row"], "cluster_ctas": CLUSTER,
                 **cluster_info["cfg_episode_panda"]})
    rows[-1]["inkernel_noise"].update(cluster_info["cfg_episode_panda_draw"])
    # ROADMAP B1 (phases 49-51): the bf16 entries of kernels 2, 4 and 5, each under its fp32
    # row's "bf16" (kernel 4's at the panda's horizon under "panda_bf16", its launches those of
    # the distillation recipe's bf16 serving row, phase 51); the clip-off runs of kernels 1, 3, 4
    # and 5 under their rows' "clip_off"
    rows[1]["bf16"] = {**b1_line["fused_unet_bf16"], **cluster_info["fused_unet_bf16"]}
    rows[3]["panda_bf16"] = {**b1_line["ddim_chain_bf16"], **cluster_info["ddim_chain_bf16"],
                             "launches": distill_panda_line["launches"],
                             "phase49_launches": b1_line["ddim_chain_bf16"]["launches"],
                             "distill_panda": distill_panda_line}
    rows[4]["bf16"] = {**b1_line["ddim_episode_bf16"], **cluster_info["ddim_episode_bf16"]}
    panda_row = next(r for r in rows if r["name"] == "ddim_episode_panda")
    panda_row["bf16"] = {**b1_line["ddim_episode_panda_bf16"],
                         **cluster_info["ddim_episode_panda_bf16"]}
    for i, name in ((0, "cfg_chain"), (2, "cfg_episode"), (3, "ddim_chain"), (4, "ddim_episode")):
        rows[i]["clip_off"] = clip_line[name]
    rows[2]["bench_closed_loop_control_hz"] = bench_line["value"]
    rows[2]["bench_pipelined_hz"] = bench_line["pipelined_hz"]
    print(json.dumps({"training": training_line}), flush=True)
    print(json.dumps({"ilqr": ilqr_line}), flush=True)
    print(json.dumps({"distill": {k: v for k, v in distill_line.items() if k != "h64"}}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"guided": guided_line["guided"]}), flush=True)
    print(json.dumps({"making": making_line["making"]}), flush=True)
    print(json.dumps({"phase_seconds": PHASE_SECONDS}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
