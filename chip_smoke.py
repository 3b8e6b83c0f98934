#!/usr/bin/env python3
"""Run the PyTorch port's served, training and corpus paths, the
tokenizer-ablation arms, the image protocol, the policy baselines, the
offline-RL and hierarchical algorithms, MCR, the synthetic closed loop,
checkpoint import, policy export, the train-step profiler, data-parallel
training, the subprocess vector env, the flagship on single- and
multi-stage kitchen demonstrations, the multi-task kitchen suite's
training and serving, the dataset tools and conversion scripts feeding
training, and the config, sweep, profiling and loader tools, the
model-prediction plots and the simple examples on one NVIDIA GPU, and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and nvcc, and
builds every kernel from the sources in the checkout (one nvcc per source,
all started together). Phases:

1. Set-up: torch version, the card's name and power limit, the kernel build.
2. Kernels: each kernel against its plain version on the card (TF32 off).
   K1: exact ids on the fixtures of tests/test_vq_lookup.py; at the served
   request's, the train step's and the corpus shape, ids may differ only
   where the two chosen codes' fp64 distances differ by <= 1e-5 * max(1, d).
   K2: on its fixtures ids and counts exactly equal, sums within rtol 1e-5 /
   atol 1e-5; at the train step's and the corpus shape ids within K1's tie
   tolerance, counts exactly equal to the plain stats of K2's own ids, sums
   within 1e-5 + 1e-5 |s| + 4 n u S (n the code's count, u = 2^-24, S the
   sum of the rows' magnitudes: the recursive-summation bound of both
   sides). A skewed K2 case at the corpus shape puts every row on one code
   (code 0 is the mean of z, the others lie far away): counts exact, the
   sums within the same bound and equal, bit for bit, to a sequential
   ascending fp32 sum (numpy's cumsum), two calls bit-identical; beside its
   bound it prints the floor of those sums, a chain of B dependent adds.
   K2 above one shared histogram's 49152 codes (B = 8192, D = 208, N = 49153, 65536, 131075):
   ids within K1's tie tolerance, counts exactly the plain stats of K2's own
   ids, sums within the bound and, at N = 65536, bit-equal to a sequential
   ascending sum. The skewed and the wide K2 cases are timed beside their
   plain versions and addmm + argmin + bincount + index_add_. K1f (one bf16
   pass on the tensor cores, wgmma fed by a TMA ring): exact ids on
   bf16-exact fixtures (both configurations, D off the
   64-column swizzle and the largest D); at the three shapes ids may differ
   from its plain version only on near-ties of the fp32 expand form over
   bf16 operands (``tie_gap`` in ops/vq_lookup.py states the bound),
   counted; the share of ids that differ from K1's; times beside those of
   its earlier mma.sync design and the bound's share.
   Times per call are CUDA-event medians; device times come from
   torch.profiler, per kernel and, for K2, per stage (cn, lookup, sort,
   sums); K1's wrapper host time is the median time from entry to return
   on an idle card, of the ``ctypes`` wrapper and of ``vq_nearest`` through
   the registered op. K1 also runs at the profiler's largest low-dim batch
   (8000 x 1024 x 791) and its image step (80 x 1024 x 905).
   The selective scan (``scan_phase``; ``ops/selective_scan.py``) in its
   gated form, the one the Mamba block runs on the card: at the Jamba
   cell's call (192 x 30 x 5120 x 16, bf16 dt, z and out), the icl_mamba
   arms' train and served calls (50 and 16 x 30 x 1024 x 8, fp32) and a
   narrow one (10 x 10 x 24 x 8, fp32), a forward and a backward through
   ``gated_selective_scan``: exactly two launches and 2 b t d n elements
   counted; out, dx, ddt, dA, dB, dC, dD and dz within 1e-4 (plus 2**-7
   where bf16) of ``gated_scan_forward_plain`` / ``gated_scan_backward_plain``'s
   value plus 1e-5 of the tensor's largest (sums in another order);
   CUDA-event medians (the forward also keeping no steps, as served),
   profiler time by kernel (every kernel named ``selective_scan``), the
   plain versions' times and the bound (each tensor read or written once
   over the HBM rate, or 7 / 23 operations an element over the dense peak).
   Then the Mamba mixer's chain (``mixer_case``) at the Jamba cell's layer
   (192 x 30 x 5120 x 16, bf16 Dense outputs), from in_proj's output to
   out_proj's and x_proj's operands with dt_proj's output given (the GEMMs
   left out): the fused kernels (conv + SiLU, the gated scan) against the
   composed PyTorch chain, each output and the gradients of every input
   within 1e-4 of the composed chain's plus 1e-5 of the tensor's largest;
   each side's CUDA-event time of a forward and backward and the fused
   side's profiler time by kernel, beside each kernel's bytes over the HBM
   rate.
   The optimizer (``optimizer_phase``; ``ops/fused_adamw.py``): the Jamba
   cell's parameters (the icl_mamba policy built on the meta device from
   its configuration: 256 fp32 tensors, 1.43 B elements) under its two
   AdamW optimizers (the policy's clipped at 100, the grads N(0, 0.01) so
   that the clip engages) take 4 steps through ``step_optimizers`` (both
   on the kernels' path) and 4 through torch's block (``global_norm``,
   ``clip_by_global_norm_``, torch's foreach AdamW) from the same weights
   and grads: the logged norms within 1e-5, p within a thousandth of one
   step and the moments within 1e-5 of their largest; every kernel of the
   kernels' step credited to a host op named ``_foreach``, and as many
   launches profiled as the library reported. Adam with L2 (the branch of
   DP, ACT and BC) is held the same way at ACT's parameters and settings
   (``adam_l2_check``). Every main path that trains (the train phase, the
   baselines) counts the optimizer's launches and steps: all on the
   kernels, none on torch's path. Printed: the
   device time of a step of each path (CUDA events, the card kept busy while
   the host enqueues), profiler time by kernel, the share of 3.35 TB/s over
   32 bytes a parameter (28 for the update, 4 for the norms), the step's
   extra memory and the peak, the host's time to enqueue a step here and at
   the flagship's 93 tensors.
3. Serve: the flagship ICLTransformerGMM at full width (6 layers x 512 x 8
   heads, 30 tokens, 1024 x 791 codebook, bf16 compute) behind
   ICLRolloutPolicy answers 5 requests for 16 envs and 3 single-env
   requests; every request must launch K1 once. The same weights in fp32 on
   the card and on the CPU must agree.
4. Train: the same model with the template's training settings (batch 100 =
   50 context + 50 query demos, dropout 0.1, AdamW lr 1e-4, L2 0.01, clip
   100) takes 20 steps of run_epoch over a DataLoader of seeded in-memory
   sequence items, once with the loss-based codebook (one K1 launch per
   step, no K2) and once with the EMA codebook (one K2 launch per step, no
   K1). One fp32 EMA-codebook step without dropout on the card and on the
   CPU from the same weights must agree as ``hold_step`` states (losses,
   gradients, each device's AdamW step, buffers) with equal context ids and
   the codebook rows the EMA wrote to rtol 1e-5 / atol 1e-7. One EMA step of
   ``LipVQVAE`` at 65536 codes (latent 208, 5000 rows) must launch K2 once
   and K1 never, give finite loss and state, and counts summing to the rows.
5. Script: the port's own entry points at full width. Two seeded synthetic
   exports (40 demos x 300 steps each, the flagship's obs keys and 12-d
   actions) go as a ``train.data`` list (a MetaDataset) to
   ``lipvq_tpu_torch.scripts.train.main`` with phase 4's loss-codebook
   settings (the template's warmup): 2 epochs x 10 steps, a checkpoint
   every epoch, and each epoch one wave of batched rollouts in 16
   SyntheticKitchen envs, 50 steps, no early stop. K1 must launch once per
   train step and once per rollout request (2 x 10 + 2 x 50 = 120), K2
   never; both checkpoints and ``latest_full.state`` must exist and every
   logged number be finite. The last checkpoint, reloaded on the card with
   ``policy_from_checkpoint``, must give GMM parameters bit-equal to the
   in-process algo's; a fresh algo loaded from ``latest_full.state`` must
   take the writer's next step with losses within rtol 1e-5 (one K1 launch
   each); ``eval_checkpoint`` runs 2 episodes x 50 steps on one env (one K1
   launch per step). Printed: ``Time_*`` per step, the idle share over the
   last epoch's steps (torch.profiler), ms per batched rollout step against
   phase 3's bare request and the 16 envs' own step, the checkpoint's size
   and save / load times. Then the same script with ``train.hdf5_cache_mode
   = "device"`` (``device_cache_script``): the corpus preprocessed once into
   tables on the card, the loader's first batch bit-equal to the host path's
   ``process_batch_for_training`` of the same items, K1 again 20 + 100, and
   its ``Time_Data_Loading`` per step printed beside the host path's.
6. Corpus: ``lipvq_tpu_torch.scripts.tokenize_corpus`` on a seeded export
   of 2^20 action rows (1024 demos x 1024 steps of smooth trajectories) at
   full width (latent 208, 1024 codes), the tokenizer from a state_dict
   file: a dry run and a writing run with K1 and a dry run with K1f, each
   launching its kernel exactly once per chunk of 2^16 rows (16) and no
   other. The ids must equal the plain tokenize's on the card but for
   near-ties of the fp32 expand form (``tie_gap``; the latents' squared
   norms of ~50 make its cancellation decide some), the tokens read back
   from the export must equal the ids, and K1f's ids must hold against its
   plain version; printed: rows per second of each run, the share of ids
   K1f changes, the device busy time and idle share of one tokenization.
7. Tokenizers (``tokenizers_phase``), on phase 6's export:
   ``scripts/tokenizer_sweep.main`` at its defaults (256, 1024 and 4096
   codes, latent 64, batch 512, 300 steps, the loss and then the EMA
   codebook), each setting's launches asserted ((302, 0, 0) with the loss
   codebook, (2, 0, 300) with the EMA one) and its four metrics printed;
   ``VQVAE`` at B = 500, latent 791, 128 and 1024 codes (one K1 launch per
   forward + backward, ids within phase 2's tie rule, loss the CPU's within
   rtol 1e-5); ``LFQVAE``, ``SpectralLFQVAE`` and ``LSTMVQVAE`` at B = 500,
   latent 791, and the CLIP text tower at ViT-L/14 text width on 64 seeded
   id rows, each fp32 on the card held against the CPU.
8. Arms: the other arms of the paper's tokenizer ablation at full width
   (``arms_phase``): bin, ln_act and raw on the GPT backbone, ln_act and
   LipVQ on icl_mamba, each serving 8 requests of 16 envs and taking 10
   train steps (K1 once per request and step for LipVQ only; the scan's
   launches, the mixer's conv calls and its fused and composed forwards
   counted: where a Mamba block runs, the icl_mamba backbone or the ln_act
   tokenizer, every forward fused with one conv call, one more a backward,
   and none elsewhere), its fp32
   forward on the card held against the CPU, and one fp32 step of the bin
   and the raw arm held against the CPU step by ``hold_step``. Then FAST
   (``fast_arm``): 10 train steps (the BPE refits on the first 8), 8
   requests with a processed context, no launches, the host time of the
   feature pipeline per step, refitting and frozen steps apart, and the
   request time with a processed and with a raw context; its fp32 forward
   and one fp32 step held against the CPU.
9. Visual (``visual_phase``): the RoboCasa image protocol at full width
   (three 128 x 128 uint8 cameras through FiLM ResNet-18 cores with 32
   keypoints and 64 features, a 116 x 116 crop, latent 983, batch 16).
   cuBLAS TF32 asserted off and no conv kernel of a profiled request or
   step named TF32, the card's division of uint8 frames bit-equal to the
   host's. Serve: 5 requests of 16 envs (processed
   frames) and 3 single-env requests (raw frames), K1 once each; the fp32
   forward on the card within rtol 1e-3 / atol 1e-4 of the CPU's at 4 envs
   (running statistics moved off their init, the center crop). Train: 20
   run_epoch steps with each codebook (K1 20 / K2 0, then K1 0 / K2 20), the
   BatchNorm statistics moved; one fp32 EMA step held against the CPU by
   ``hold_step`` with the crop at its identity setting (the card's and the
   CPU's generators differ), the BatchNorm buffers among the buffers, and
   a control: the same step with TF32 convolutions must miss the CPU's
   visual-core gradients by more than the held step's limit and run conv
   kernels named TF32. Then
   ``scripts/train.py`` over a seeded export (8 demos x 120 steps x 3
   cameras): 2 epochs x 10 steps, 5 data worker processes, no cache, the
   MSE visualizer in epoch 2 (K1 20 in steps + 4 in the MSE pass), the last
   checkpoint reloaded bit-equal. Printed: request and step times, device
   busy and idle share, the share of the kernels that convolution ops
   launched (by the profiler's kernel-to-op link), the trunk's TFLOP/s
   against its FLOP count from the conv shapes, ``Time_*`` per step.
   K1 (160 / 10 / 80 rows) and K2 (80 rows) at latent 983 are timed in
   phase 2.
10. Baselines (``baselines_phase``): the JAX package's templates
   (exps/templates/{diffusion_policy,act,bc}.json) at their widths on the
   flagship's low-dim obs (791 wide, 12-d actions, batch 100): Diffusion
   Policy (UNet 256 / 512 / 1024, kernel 5, 89.87 M parameters, To 2, Tp
   16, Ta 8, DDPM 100 / 100, EMA), ACT (512 wide, 4 + 7 layers, ff 3200,
   chunk 10), BC-GMM (MLP 1024 x 1024), BC-Transformer-GMM (6 x 512, 8
   heads, context 10) and BC-RNN-GMM (2 x 400 LSTM, horizon 10). Each serves
   5 requests of 16 envs, rolls out one 40-step single-env episode through
   ``RolloutPolicy`` + ``rollout_with_stats`` on the synthetic env and takes
   10 ``run_epoch`` steps: K1 / K1f / K2 launch 0 times. Printed: the
   parameter count, a 16-env request that samples a new chunk and a queued
   one, the step (median of 10), device busy and idle share, the top
   kernels; no kernel of a profiled request or step is named TF32 (DP's
   conv kernels by the profiler's kernel-to-op link). DP also serves one
   request by 10-step DDIM, and its 100-step DDPM chain from the same noise
   on the card is held against the CPU (atol 1e-3). One fp32 step of DP,
   ACT and BC-Transformer-GMM (batch 16, no warmup, no dropout, the same
   draws) is held against the CPU by ``hold_step`` (ACT's attention key
   biases, of exact gradient 0, as zeros; DP's EMA net on each device
   against its own new parameters, rtol 1e-6). Then ``scripts/train.py``
   with the DP template over a seeded export: 2 epochs x 10 steps, rollouts
   off (a baseline's single-env rollout raises in the script, as in the JAX
   package), the checkpoint reloaded bit-equal, the EMA net included.
11. Offline RL and hierarchical (``rl_phase``): the JAX package's templates
   (exps/templates/{td3_bc,iql,cql,bcq,gl,hbc,iris}.json) at their widths on
   the flagship's low-dim obs (791 wide, 12-d actions, batch 100), over
   seeded in-memory windows with next_obs, rewards and dones (10 steps:
   GL, HBC and IRIS read the subgoal at ``subgoal_horizon`` 10, so their
   ``train.seq_length`` is 10, not the templates' 1): TD3-BC (256 x 256),
   IQL, CQL and BCQ (300 x 400), GL (a 300 x 400 planner), HBC (GL planner,
   BC-GMM actor 1024 x 1024, 5 modes) and IRIS (GL-VAE planner, the same
   actor, a BCQ value at its defaults scoring 10 subgoal samples per env).
   Each serves 5 requests of 16 envs (GL: subgoal predictions), rolls out
   one 40-step single-env episode through ``RolloutPolicy`` +
   ``rollout_with_stats`` on the synthetic env (not GL, a planner; HBC and
   IRIS ``reset()`` first) and takes 10 ``run_epoch`` steps: K1 / K1f / K2
   launch 0 times. Printed: the parameter count, a 16-env request (HBC and
   IRIS: with a new subgoal, and on the current one), the step (median of
   10), device busy and idle share, the top kernels; no kernel of a
   profiled request or step is named TF32. One fp32 step of TD3-BC (two:
   the second skips the actor), IQL, CQL, BCQ and IRIS (batch 16, the same
   draws, HBC's actor without warmup) is held against the CPU by
   ``hold_step`` (each optimizer's Adam step from its moments, the target
   networks by polyak on each device, CQL's ``log_alpha`` with its own
   Adam), no kernel of the card's steps named TF32. Then
   ``scripts/train.py`` with the TD3-BC template over a seeded export with
   next_obs / rewards / dones: 2 epochs x 10 steps, rollouts off, the
   checkpoint reloaded bit-equal (target networks included), and a fresh
   algo from ``latest_full.state`` takes the writer's next two steps with
   losses within rtol 1e-5, the actor moved on the first (step 20) only.
12. MCR (``mcr_phase``): the representation workspace at its defaults
   (112 x 112 crops, batch 16, embed 128, langweight 0.1) trains 20 steps on
   the synthetic corpus in the manifest layout, its snapshot reloads
   bit-equal and takes 2 more steps; the pretrainer takes 20 steps at batch
   16; ``MCRTransformerGMM`` at the mcr template's widths (6 x 512, 8 heads,
   context 10) with one 128 x 128 camera (the template names none) grafts
   the snapshot's trunk (every core's trunk parameters equal the
   snapshot's, its statistics the init's), serves 5 requests of 16 envs and
   takes 10 steps at the image protocol's batch of 16; one fp32 step is
   held against the CPU by ``hold_step`` (the visual core as a whole). K1 /
   K1f / K2 launch 0 times on every path.
13. Closed loop (``closed_loop_phase``): the convergence twin
   (``lipvq_tpu_torch/examples/convergence_demo.py``) at its settings: K1
   launches exactly once per train step and once per policy request, K1f
   and K2 never; its last evaluation's success may fall at most 0.3 below
   the JAX package's CPU curve (``JAX_CPU_CURVE``). A step and a request are
   timed and profiled; K1 at the loop's shapes (160 and 10 rows x 256 codes
   x 791) gives exact ids on Gaussian fixtures and ids within ``tie_gap`` on
   the loop's own latents, timed beside its bound, the plain version and
   addmm + argmin.
14. Import (``import_phase``): a seeded reference LLFQVAE_V4 payload at the
   flagship's width through ``scripts/import_torch_ckpt.py`` into
   ``LipVQVAE`` on the card: K1 ids exactly the plain version's on Gaussian
   rows and within ``tie_gap`` on the tokenizer's latents (2 launches); a
   seeded R3M-layout ResNet-18 through ``convert`` into ``R3MConv`` (its
   running statistics taken from one batch, as a trained trunk's match its
   activations), card against CPU within rtol 1e-3 / atol 1e-4.
15. Export (``export_phase``): the flagship at the serving width through a
   checkpoint and ``scripts/export_policy.py`` at 16 envs and 1; the graph
   holds the K1 op once; each program runs in a fresh process that imports
   only the op registration: one K1 launch per request (counted there), the
   actions equal ``get_action``'s at the same draws (max abs difference 0),
   per-request time beside eager's.
16. Profile (``profile_phase``): ``scripts/profile_train_step.py`` at the
   template width, low-dim at batches 100 and 1600, 100 with the EMA
   codebook, image at 16: every row (FLOPs, bytes, step time, MFU against
   the H100's bf16 and fp32 peaks), K1 once per loss-codebook step, K2 once
   per EMA step. K1 at the largest batch's and the image step's shapes is
   timed in phase 2.
17. Data-parallel (``ddp_phase``): ``scripts/train.py`` on one seeded export
   with the EMA codebook, 5 steps, ``train.num_devices=1`` (NCCL, a group of
   one) against no mesh: losses and every tensor of the checkpoint bit-equal,
   K2 once per step; then two ranks sharing the card over gloo with CUDA
   tensors, 3 steps with dropout 0.1 against the single process at rtol 1e-4
   (not a criterion: an error is printed and recorded).
18. Vector (``vector_phase``): the flagship serves 16 synthetic envs stepped
   in lock-step by ``SubprocVectorEnv`` and ``VectorEnv`` with the same
   actions, 20 steps: observations, rewards and dones bit-equal, K1 once per
   request; ms per rollout step of each beside the bare request.
19. Kitchen (``kitchen_phase``): the card's machine has no ``mujoco``
   (``import mujoco`` raises ModuleNotFoundError there), so the phase works
   from the OpenDrawer corpus committed under
   ``lipvq_tpu_torch/assets/kitchen/`` (8 scripted demos written by the
   port's ``collect_kitchen_suite``). ``scripts/train.py`` trains the
   flagship at the core-8 recipe's full width (6 x 384, 8 heads, 512 codes,
   batch 64, the suite's obs keys, the device-resident corpus), 2 epochs x
   20 steps with rollouts on: the script prints "Rollout disabled" naming
   mujoco and trains on, K1 once per step, K1f and K2 never. The last
   checkpoint reloads bit-equal; 8 requests of 16 envs on frame-stacked
   windows of the corpus's recorded observations launch K1 once each; one
   fp32 step is held against the CPU (``hold_step``); the learning floor of
   tests/test_learning_floor.py (3 L / 128 d, 3 x 50 steps) must hold on the
   card (final NLL < initial - 2 and < 5, K1 once per step). Printed: the
   step and the 16-env request (host ms, device busy, idle share), and K1
   at the kitchen's shapes (320 and 160 rows x 512 codes x 823, 120 x 128 x
   807): exact ids on Gaussian fixtures, ``tie_gap`` on the corpus's
   latents, timed beside its bound, the plain version and addmm + argmin.
20. Multi-stage kitchen (``kitchen_multi_phase``): ``import mujoco`` must
   raise ModuleNotFoundError; then the same recipe on the corpus committed
   under ``lipvq_tpu_torch/assets/kitchen_multi/`` (3 scripted demos of each
   of four of the paper's five multi-stage activities: MicrowaveThawing's
   expert outlasts the collector's 500-step kitchen), the four exports as one
   weighted ``train.data`` list (a MetaDataset): 2 x 20 steps with
   "Rollout disabled" naming mujoco, K1 once per step, K1f and K2 never; the
   reload bit-equal; 8 requests of 16 envs split across the tasks, each
   env's context a demo of its own task (K1 once each); one fp32 step held
   against the CPU; the step and the request timed and profiled; K1 at 320
   and 160 rows x 512 codes x 823 on the corpus's latents.
21. Kitchen suite (``kitchen_suite_phase``): ``import mujoco`` must raise
   ModuleNotFoundError; a corpus directory of links to the committed
   OpenDrawer and PrepareCoffee exports (two tasks of the suite's full set);
   the suite twin's own entry point
   (``lipvq_tpu_torch.examples.kitchen_multitask_suite.main``, in process)
   with ``--train_only --balance_tasks`` at the core-8 recipe's full width
   (6 x 384, 512 codes, batch 64), 2 epochs x 20 steps: no collection, K1
   exactly once per step, K1f and K2 never; again with ``--resume --epochs
   3``: "[resume] ... -> start_epoch 3", 20 more steps (K1 20),
   ``model_epoch_3.ckpt``. The last checkpoint loads on the card; for each
   task the suite's ``task_policy`` builds its policy and context, which
   serves 8 requests of 16 envs on frame-stacked windows of that task's
   recorded observations (K1 once each); the step and the 16-env request
   timed and profiled; K1 at 320 and 160 rows x 512 codes x 823 on the
   phase's latents.
22. Dataset tools (``data_tools_phase``): ``import mujoco``, ``import
   gymnasium`` and ``import h5py`` must raise ModuleNotFoundError; a copy of
   the committed OpenDrawer corpus gets ``split_train_val`` (ratio 0.25,
   seed 0: 6 train, 2 valid demos) and ``filter_dataset_size`` (4 demos),
   then ``set_dataset_attr`` (an ``MG_`` env name), ``remove_mg_env_label``,
   ``copy_ds_key`` and ``get_dataset_info``, each through its ``main``, each
   report checked. ``scripts/train.py`` trains the kitchen flagship at the
   core-8 recipe's full width on ``hdf5_filter_key="train"`` with validation
   on ``"valid"``, 2 epochs x 10 steps and 5 validation steps each: the train
   and valid datasets hold exactly their masks' demos and steps, the
   device-resident corpus (``DeviceCachedLoader``) one item per train-mask
   step; "Rollout disabled" names mujoco; K1 exactly 20 + 10, K1f and K2
   never. ``convert_d4rl`` turns a seeded .npz buffer at Hopper's widths
   (obs 11, act 3, 200 episodes x 1000 steps cut by timeouts) into an export
   for ``Hopper-v4``; ``scripts/train.py`` trains the flagship (1024 codes)
   on its ``flat`` observation for 20 steps from the low-dim cache: "Rollout
   disabled" names gymnasium, K1 exactly 20. A train step of each run and a
   validation step timed and profiled (device busy, idle share); K1 at the
   phase's shapes on its own latents.
23. Tools (``tools_phase``): ``import h5py`` must raise ModuleNotFoundError;
   ``scripts/train.py`` writes a checkpoint of the kitchen flagship at the
   core-8 recipe's full width (6 x 384, 512 codes) on the committed
   OpenDrawer corpus, 1 epoch x 5 steps (K1 5); then
   ``scripts/plot_model_predictions.plot_predictions`` over the corpus's
   first 2 demos on the card, counted as the main path: K1 exactly once per
   prediction (one ``get_action`` per 10-step window), K1f and K2 never, one
   PNG per demo (drawn by PIL where matplotlib is absent); the checkpoint in
   fp32 with codes kept apart, plotted on the card and the CPU with the same
   GMM draws, every predicted action within 1e-4; one prediction request
   timed and profiled (host ms, device busy, idle share) and K1 at its shape
   (10 x 512 x 823) on its own latents; ``examples/tokenize_actions`` (K1 1)
   and ``examples/simple_train_loop`` (K1 15, K2 0) through their ``main``;
   ``utils/profile_utils.timeit`` (both modes) and ``trace`` around 20 K1
   calls, the kernel named in the trace file; ``scripts/bench_loader.main``
   at its defaults (its JSON printed); ``config_gen/icl_xfmr_gen`` and
   ``hyperparam_helper`` into a temporary directory, one generated ICL
   config loaded by ``config_factory``.
24. Output: a ``kernels`` JSON line (K1, K1f, K2, the gated selective
   scan, the mixer's conv and the optimizer's passes, with the launches of
   every path), the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA's data sheet: dense, at the full 700 W
# power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM = 12
N_ENVS = 16
SLICE_SHAPE = (160, 1024, 791)  # 16 envs x 10 context steps, codes, latent
TRAIN_SHAPE = (500, 1024, 791)  # 50 context demos x 10 steps, codes, latent
CORPUS_SHAPE = (1 << 20, 1024, 208)  # bench.py's corpus tokenization shape
BATCH = 100  # exps/templates/icl.json: train.batch_size
SEQ_STEPS = 19  # frame_stack - 1 + seq_length of the template
TRAIN_STEPS = 20
FP32_U = 2.0 ** -24
K2_WIDE_N = (49153, 65536, 131075)  # above the 49152 codes of one shared histogram
K2_WIDE_SHAPE = (8192, 208)  # rows, latent
EMA_WIDE_CODES, EMA_WIDE_ROWS = 65536, 5000  # phase 4's EMA step beyond one histogram
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock: the skewed K2 case's chain floor
# phase 10, the RoboCasa image protocol (config_gen_utils.set_env_settings and
# set_mod_settings with mod="im"): three 128 x 128 cameras, FiLM ResNet-18
# cores with 32 keypoints and 64 features each, a 116 x 116 crop, batch 16
VIS_CAMERAS = ("robot0_agentview_left_image", "robot0_agentview_right_image",
               "robot0_eye_in_hand_image")
VIS_FRAME, VIS_CROP = (128, 128, 3), 116
VIS_SHAPES = {**OBS_SHAPES, **{k: list(VIS_FRAME) for k in VIS_CAMERAS}}
VIS_BATCH, VIS_WORKERS = 16, 5
VIS_LATENT = 791 + 64 * len(VIS_CAMERAS)  # the flagship's low-dim width + 3 cores' features
VIS_SLICE_SHAPE = (N_ENVS * 10, 1024, VIS_LATENT)  # a 16-env request's context tokens
VIS_SINGLE_SHAPE = (10, 1024, VIS_LATENT)  # a single-env request's
VIS_TRAIN_SHAPE = (VIS_BATCH // 2 * 10, 1024, VIS_LATENT)  # 8 context demos x 10 steps
VIS_REQUESTS, VIS_SINGLE, VIS_CPU_ENVS = 5, 3, 4
VIS_HOLD_BATCH = 4  # the card-vs-CPU step: 2 context + 2 query demos
VIS_SCRIPT_DEMOS, VIS_SCRIPT_LEN, VIS_MSE_SAMPLES = 8, 120, 4
# K1f's earlier design (mma.sync m16n8k16, the codebook staged through
# registers), as this script measured it on an NVIDIA H100 80GB HBM3 at
# 700.00 W: per call and device ms at the served, train and corpus shapes
K1F_MMA_SYNC = {"slice": (0.126, 0.084), "train": (0.110, 0.082), "corpus": (5.89, 5.20)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: bool = True) -> float:
    """Median host time of one call of ``fn``, which must return only once
    its device work is done, after one warm-up call (``warmup``)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wrapper_host_ms(fn, reps: int = 50) -> float:
    """Median host time of one call of ``fn`` from entry to return, the
    card idle before each call: what the Python wrapper costs the caller."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# K2's kernels by stage, matched on the profiler's kernel names
K2_STAGES = {"cn": ("code_norms",), "lookup": ("nearest_tile", "reduce_splits"),
             "sort": ("hist_kernel", "colscan", "codescan", "scatter"),
             "sums": ("short_sums", "long_sums")}


def stage_ms(kernels: dict) -> dict:
    return {stage: sum(ms for name, ms in kernels.items() if any(k in name for k in keys))
            for stage, keys in K2_STAGES.items()}


def profile_device(fn, reps: int, warmup: bool = True) -> tuple[float | None, dict]:
    """Device time per call of ``fn`` under torch.profiler (CUDA activity
    only), after one warm-up call (``warmup``): (busy ms, {kernel name:
    ms}), busy being the union of the kernels' and copies' intervals. (None,
    {}) where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_busy(prof, reps)


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespace noise, template
    and call arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0]


def launch_counts() -> tuple[int, int, int]:
    """The launch counts of K1, K1f and K2 since the last reset."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_with_stats_cuda

    return (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches,
            vq_nearest_with_stats_cuda.launches)


def zero_launch_counts() -> None:
    """Set the launch counts of K1, K1f and K2, the optimizer's counts
    (``optimizer_counts``) and the Mamba mixer's (``mixer_counts``) to 0,
    just before a main path."""
    from lipvq_tpu_torch.models.mamba import MambaBlock
    from lipvq_tpu_torch.ops import fused_adamw
    from lipvq_tpu_torch.ops.causal_conv1d import causal_conv1d_silu
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_with_stats_cuda

    vq_nearest_cuda.launches = vq_nearest_cuda.fast_launches = 0
    vq_nearest_with_stats_cuda.launches = 0
    fused_adamw.sq_norms.launches = fused_adamw.adam_step_.launches = 0
    fused_adamw.adam_step_.steps = fused_adamw.adam_step_.elems = 0
    fused_adamw.torch_step_.steps = 0
    causal_conv1d_silu.launches = 0
    MambaBlock.fused_forwards = MambaBlock.composed_forwards = 0


def mixer_counts() -> tuple[int, int, int]:
    """The Mamba mixer's counts since the last reset: the conv kernels'
    calls (one a forward, one a backward) and the block's forwards on the
    card by path, fused and composed."""
    from lipvq_tpu_torch.models.mamba import MambaBlock
    from lipvq_tpu_torch.ops.causal_conv1d import causal_conv1d_silu

    return causal_conv1d_silu.launches, MambaBlock.fused_forwards, MambaBlock.composed_forwards


def optimizer_counts() -> dict[str, int]:
    """Since the last reset: the optimizer's kernels launched on the card
    (both passes, as the library reports them), the optimizer steps they
    took and the steps on torch's path."""
    from lipvq_tpu_torch.ops import fused_adamw

    return {"launches": fused_adamw.sq_norms.launches + fused_adamw.adam_step_.launches,
            "fused_steps": fused_adamw.adam_step_.steps,
            "torch_steps": fused_adamw.torch_step_.steps}


def assert_fused_optimizer(label: str, counts: dict, steps: int) -> None:
    """``counts`` (``optimizer_counts``) of a main path that took ``steps``
    optimizer steps: every one on the kernels, none on torch's path."""
    if not (counts["fused_steps"] == steps and counts["torch_steps"] == 0
            and counts["launches"] > 0):
        raise AssertionError(f"{label}: optimizer {counts}, want {steps} steps on the kernels")


def profile_convs(fn, reps: int, warmup: bool = True) -> tuple[float | None, dict, dict, list]:
    """``profile_device``'s (busy ms, {kernel: ms}) per call of ``fn``, the
    CPU's ops recorded too, plus {kernel: ms} of the kernels a convolution
    op launched (the profiler links each kernel to the innermost op that
    launched it: aten::cudnn_convolution in the forward,
    aten::convolution_backward in the backward; not the bias adds, the
    BatchNorms or the GEMMs) and the full names of those kernels."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, kernels = device_busy(prof, reps)
    convs, names = {}, set()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and "conv" in e.name:
            for k in e.kernels:
                names.add(k.name)
                convs[kernel_name(k.name)] = convs.get(kernel_name(k.name), 0.0) + \
                    k.duration / 1e3 / reps
    return busy, kernels, convs, sorted(names)


def device_busy(prof, reps: int = 1) -> tuple[float | None, dict]:
    """(busy ms, {kernel name: ms}) per rep from a finished torch.profiler
    run, busy being the union of the device intervals; (None, {}) where it
    recorded no device activity. A ``record_function`` range mirrored on the
    device's timeline (``Optimizer.step#AdamW.step``, with CPU activity on)
    is no device work and is left out."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return None, {}
    busy, (start, end) = 0.0, spans[0][:2]
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        name = kernel_name(name)
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / reps
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy / 1e3 / reps, by_name


def vq_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """Least time (ms) for the lookup: fp32 operations 2*B*N*D for the dot
    products + 2*N*D for ||c||^2, against z and c read once and the ids
    written once."""
    ops_ms = (2 * b * n * d + 2 * n * d) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 4 * (b * d + n * d + b) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def stats_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """Least time (ms) for the lookup + stats: the lookup's operations plus
    B*D adds, against z and c read once and ids, counts and sums written
    once."""
    ops_ms = (2 * b * n * d + 2 * n * d + b * d) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 4 * (b * d + n * d + b + n + n * d) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def check_ids(z, c, got, want) -> tuple[int, float]:
    """Ids may differ only where the chosen codes' fp64 distances differ by
    <= 1e-5 * max(1, d). Returns (differing rows, largest distance gap)."""
    bad = (got != want).nonzero().flatten()
    if bad.numel() == 0:
        return 0, 0.0
    zb = z[bad].double()
    d_got = ((zb - c[got[bad].long()].double()) ** 2).sum(1)
    d_want = ((zb - c[want[bad].long()].double()) ** 2).sum(1)
    gap = (d_got - d_want).abs()
    allowed = 1e-5 * torch.clamp(torch.minimum(d_got, d_want), min=1.0)
    if (gap > allowed).any():
        raise AssertionError(f"ids differ beyond the tie tolerance on "
                             f"{int((gap > allowed).sum())} rows")
    return bad.numel(), float(gap.max())


def hold_stats(z, ids, counts, sums, where: str) -> float:
    """K2's counts exactly the plain stats of its own ids (summing to the
    rows), its sums within the summation bound of ``where``'s plain stats:
    1e-5 + 1e-5 |sum| + 4 u count sum|z|. Returns the sums' largest error."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_cluster_stats

    n = counts.shape[0]
    want_counts, want_sums = vq_cluster_stats(z, ids, n)
    _, abs_sums = vq_cluster_stats(z.abs(), ids, n)
    if not torch.equal(counts, want_counts) or float(counts.sum()) != z.shape[0]:
        raise AssertionError(f"K2 counts differ from the plain stats {where}")
    err = (sums - want_sums).abs()
    allowed = 1e-5 + 1e-5 * want_sums.abs() + 4 * FP32_U * counts[:, None] * abs_sums
    if (err > allowed).any():
        raise AssertionError(f"K2 sums exceed the summation bound on "
                             f"{int((err > allowed).sum())} entries {where}")
    return float(err.max())


def kernel_phase(card: str) -> dict:
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest,
        vq_nearest_cuda,
        vq_nearest_reference,
    )

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    dev = torch.device("cuda")

    # fixtures of tests/test_vq_lookup.py: ids exactly equal
    fixtures = []
    for b, n, d in [(80, 128, 12), (300, 1024, 208), (512, 256, 64)]:
        rng = np.random.default_rng(0)
        z = rng.standard_normal((b, d), dtype=np.float32)
        fixtures.append((f"gauss{b}x{n}x{d}", z, rng.standard_normal((n, d), dtype=np.float32)))
    rng = np.random.default_rng(0)
    z = torch.sigmoid(torch.from_numpy(10.0 * rng.standard_normal((400, 32)).astype(np.float32)))
    c = torch.sigmoid(torch.from_numpy(10.0 * rng.standard_normal((256, 32)).astype(np.float32)))
    fixtures.append(("sigmoid400x256x32", z.numpy(), c.numpy()))
    fixtures.append(("ties", np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32),
                     np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32)))
    for name, z, c in fixtures:
        zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
        got = vq_nearest_cuda(zt, ct)
        want = vq_nearest_reference(zt, ct)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 ids differ from the plain version on {name}")
        if name == "ties" and got.tolist() != [1, 3]:
            raise AssertionError(f"K1 tie rule: got {got.tolist()}, want [1, 3]")
    print(f"K1 fixtures: ids exactly equal to the plain version on {len(fixtures)} fixtures")

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, (b, n, d), reps, plain_reps in (("slice", SLICE_SHAPE, 50, 3),
                                               ("train", TRAIN_SHAPE, 50, 3),
                                               ("corpus", CORPUS_SHAPE, 10, 1),
                                               ("visual_serve", VIS_SLICE_SHAPE, 50, 3),
                                               ("visual_single", VIS_SINGLE_SHAPE, 50, 3),
                                               ("visual_train", VIS_TRAIN_SHAPE, 50, 3),
                                               ("profile_1600", PROFILE_SHAPE, 20, 1),
                                               ("profile_image", PROFILE_IMAGE_SHAPE, 50, 3)):
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        got = vq_nearest_cuda(z, c)
        want = vq_nearest_reference(z, c)
        mismatches, max_gap = check_ids(z, c, got, want)
        ms = cuda_ms(lambda: vq_nearest_cuda(z, c), reps)
        # the plain version just ran at this shape: no warm-up call
        plain_ms = cuda_ms(lambda: vq_nearest_reference(z, c), plain_reps, warmup=0)
        library_ms = cuda_ms(
            lambda: torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1), reps)
        device_ms, kernels = profile_device(lambda: vq_nearest_cuda(z, c), reps)
        wrapper_ms = wrapper_host_ms(lambda: vq_nearest_cuda(z, c), reps)
        # the dispatcher every path calls: the registered op over the same launch
        op_wrapper_ms = wrapper_host_ms(lambda: vq_nearest(z, c), reps)
        bound_ms, bound_by = vq_bound(b, n, d)
        results[label] = {"shape": [b, n, d], "mismatches": mismatches,
                          "max_abs_err": max_gap, "ms": ms, "device_ms": device_ms,
                          "wrapper_host_ms": wrapper_ms, "op_wrapper_host_ms": op_wrapper_ms,
                          "kernel_ms": kernels,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 {label} {b}x{n}x{d}: {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); K1 {ms:.4f} ms per call "
              f"(wrapper host {wrapper_ms:.4f} ms, through the registered op "
              f"{op_wrapper_ms:.4f} ms; device busy {device_ms} ms: {kernels}), "
              f"plain {plain_ms:.4f} ms, "
              f"addmm+argmin {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]")
        del z, c, got, want
    results["corpus"].update(tc_rescored(*CORPUS_SHAPE[1:], gauss=True))
    results["corpus_latents"] = tc_corpus_latents(card)
    torch.cuda.empty_cache()
    return results


def corpus_latents(seed: int, rows: int, codes: int, d: int):
    """LipVQ latents of 0.5 N(0, 1) actions under seeded encoder weights, the
    codebook the latents of other actions (the lowdim corpus cell's kind:
    sigmoid outputs close together, many near-ties), on the card."""
    gen = torch.Generator().manual_seed(seed)
    w1, w2 = torch.randn(64, 12, generator=gen) / 12 ** 0.5, torch.randn(128, 64, generator=gen) / 8
    w = torch.randn(d, 128, generator=gen)
    ci = 3.0 + 0.3 * torch.randn(d, generator=gen)
    w = w * torch.clamp(torch.nn.functional.softplus(ci)[:, None] / w.abs().sum(1, keepdim=True),
                        max=1.0)
    w1, w2, w = (t.cuda() for t in (w1, w2, w))
    gelu = torch.nn.functional.gelu

    def encode(x):
        return torch.sigmoid(gelu(gelu(x.cuda() @ w1.T) @ w2.T) @ w.T).contiguous()

    return (encode(0.5 * torch.randn(rows, 12, generator=gen)),
            encode(0.5 * torch.randn(codes, 12, generator=gen)))


def tc_rescored(n: int, d: int, gauss: bool = False, z=None, c=None) -> dict:
    """One K1 call at the corpus shape (the tensor-core path): the share of
    rows re-scored exactly by K1's chain, over candidates or over every code,
    from the card's counters; on seeded Gaussians with ``gauss``."""
    from lipvq_tpu_torch.ops import vq_lookup

    if gauss:
        gen = torch.Generator(device="cuda").manual_seed(0)
        z = torch.randn(CORPUS_SHAPE[0], d, generator=gen, device="cuda")
        c = torch.randn(n, d, generator=gen, device="cuda")
    tc_before = vq_lookup.vq_nearest_cuda.tc_launches
    vq_lookup.vq_nearest_cuda(z, c)
    counts = vq_lookup.rescored_rows()[torch.cuda.current_device()]
    before = counts.clone()
    vq_lookup.vq_nearest_cuda(z, c)
    rescored, every = (counts - before).tolist()
    if vq_lookup.vq_nearest_cuda.tc_launches != tc_before + 2:
        raise AssertionError("K1 at the corpus shape did not take the tensor-core path")
    b = z.shape[0]
    tc_ms, _ = fast_bound(b, n, d)
    print(f"K1 tensor-core path {b}x{n}x{d}{' gauss' if gauss else ''}: {rescored} rows "
          f"re-scored exactly ({100 * rescored / b:.3f} %), {every} of them over every code "
          f"({100 * every / b:.4f} %); tensor-core bound {tc_ms:.4f} ms")
    return {"path": "tensor cores", "rescored_rows": rescored, "every_code_rows": every,
            "rescored_share": rescored / b, "every_code_share": every / b, "tc_bound_ms": tc_ms}


def tc_corpus_latents(card: str) -> dict:
    """K1 at 2^20 x 1024 x 208 on the corpus cell's kind of latents: ids bit
    for bit those of the SIMT tiles (the same rows in 8192-row calls), per
    call, device time, bounds and shares, plain and library times, and the
    share of rows re-scored."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_reference

    b, n, d = CORPUS_SHAPE
    z, c = corpus_latents(1, b, n, d)
    got = vq_nearest_cuda(z, c)
    want = torch.cat([vq_nearest_cuda(zc.contiguous(), c) for zc in z.split(8192)])
    differ = int((got != want).sum())
    if differ:
        raise AssertionError(f"K1's tensor-core path differs from the SIMT tiles on {differ} rows")
    out = tc_rescored(n, d, z=z, c=c)
    ms = cuda_ms(lambda: vq_nearest_cuda(z, c), 10)
    simt_ms = cuda_ms(lambda: [vq_nearest_cuda(zc.contiguous(), c) for zc in z.split(8192)], 3)
    plain_ms = cuda_ms(lambda: vq_nearest_reference(z, c), 1, warmup=0)
    library_ms = cuda_ms(lambda: torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1), 10)
    device_ms, kernels = profile_device(lambda: vq_nearest_cuda(z, c), 10)
    bound_ms, _ = vq_bound(b, n, d)
    share = out["tc_bound_ms"] / device_ms if device_ms else None
    out.update({"shape": [b, n, d], "ms": ms, "device_ms": device_ms, "kernel_ms": kernels,
                "simt_medium_ms": simt_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "tc_share": share})
    print(f"K1 corpus latents {b}x{n}x{d}: ids bit-equal to the SIMT tiles; {ms:.4f} ms per "
          f"call (device busy {device_ms} ms: {kernels}); fp32 bound {bound_ms:.4f} ms, "
          f"tensor-core bound {out['tc_bound_ms']:.4f} ms (share "
          f"{'not measured' if share is None else f'{100 * share:.2f} %'}); SIMT in 8192-row "
          f"calls {simt_ms:.4f} ms, plain {plain_ms:.4f} ms, addmm+argmin {library_ms:.4f} ms "
          f"[{card}]")
    return out


def stats_phase(card: str) -> dict:
    """K2 against its plain version on the fixtures, then at the train
    step's and the corpus shape with times."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest_with_stats_cuda,
        vq_nearest_with_stats_reference,
    )

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    dev = torch.device("cuda")
    fixtures = []
    for b, n, d in [(300, 64, 16), (1, 1, 1), (70, 65, 791)]:
        rng = np.random.default_rng(0)
        z = rng.standard_normal((b, d), dtype=np.float32)
        fixtures.append((f"gauss{b}x{n}x{d}", z, rng.standard_normal((n, d), dtype=np.float32)))
    fixtures.append(("ties", np.asarray([[1, 0], [0, 1], [1, 0]], np.float32),
                     np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32)))
    for name, z, c in fixtures:
        zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
        ids, counts, sums = vq_nearest_with_stats_cuda(zt, ct)
        want_ids, want_counts, want_sums = vq_nearest_with_stats_reference(zt, ct)
        torch.cuda.synchronize()
        if not (torch.equal(ids, want_ids) and torch.equal(counts, want_counts)):
            raise AssertionError(f"K2 ids or counts differ from the plain version on {name}")
        torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-5)
        if name == "ties" and (ids.tolist() != [1, 3, 1]
                               or counts.tolist() != [0, 2, 0, 1, 0]):
            raise AssertionError(f"K2 tie rule: got {ids.tolist()}, {counts.tolist()}")
    print(f"K2 fixtures: ids and counts exactly equal to the plain version, sums "
          f"within rtol 1e-5 / atol 1e-5 on {len(fixtures)} fixtures")

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for label, (b, n, d), reps, plain_reps in (("train", TRAIN_SHAPE, 50, 3),
                                               ("corpus", CORPUS_SHAPE, 10, 1),
                                               ("visual_train", VIS_TRAIN_SHAPE, 50, 3),
                                               ("profile_1600", PROFILE_SHAPE, 20, 1),
                                               ("profile_image", PROFILE_IMAGE_SHAPE, 50, 3)):
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
        again = vq_nearest_with_stats_cuda(z, c)
        if not all(torch.equal(x, y) for x, y in zip((ids, counts, sums), again)):
            raise AssertionError(f"K2 is not deterministic at {label}")
        mismatches, max_gap = check_ids(z, c, ids, vq_nearest_with_stats_reference(z, c)[0])
        max_err = hold_stats(z, ids, counts, sums, f"at {label}")

        def library():
            lib_ids = torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1)
            torch.bincount(lib_ids, minlength=n)
            torch.zeros(n, d, device=dev).index_add_(0, lib_ids, z)

        ms = cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), reps)
        # the plain version just ran at this shape: no warm-up call
        plain_ms = cuda_ms(lambda: vq_nearest_with_stats_reference(z, c), plain_reps,
                           warmup=0)
        library_ms = cuda_ms(library, reps)
        device_ms, kernels = profile_device(lambda: vq_nearest_with_stats_cuda(z, c), reps)
        bound_ms, bound_by = stats_bound(b, n, d)
        results[label] = {"shape": [b, n, d], "mismatches": mismatches, "max_id_gap": max_gap,
                          "max_abs_err": max_err, "ms": ms, "device_ms": device_ms,
                          "stage_ms": stage_ms(kernels), "kernel_ms": kernels,
                          "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "codes_used": int((counts > 0).sum())}
        print(f"K2 {label} {b}x{n}x{d}: {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); counts equal; sums max abs err "
              f"{max_err:.3g} ({int((counts > 0).sum())} codes used); K2 {ms:.4f} ms per "
              f"call (device busy {device_ms} ms, by stage {stage_ms(kernels)}: {kernels}), "
              f"plain {plain_ms:.4f} ms, addmm+argmin+bincount+index_add_ "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        del z, c, ids, counts, sums, again
    torch.cuda.empty_cache()
    results["skewed"] = skewed_stats(card, gen)
    results["wide"] = wide_stats(card, gen)
    return results


def wide_stats(card: str, gen) -> dict:
    """K2 above one shared histogram's 49152 codes (the row sort runs over
    code ranges): B = 8192, D = 208, N in ``K2_WIDE_N``. Ids within K1's
    tie tolerance of the plain version, counts exactly the plain stats of
    K2's own ids, sums within the summation bound and, at N = 65536, bit-equal
    to a sequential ascending fp32 sum (numpy's unbuffered add.at); device
    times."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest_reference,
        vq_nearest_with_stats_cuda,
        vq_nearest_with_stats_reference,
    )

    b, d = K2_WIDE_SHAPE
    dev = torch.device("cuda")
    results = {}
    for n in K2_WIDE_N:
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
        mismatches, max_gap = check_ids(z, c, ids, vq_nearest_reference(z, c))
        max_err = hold_stats(z, ids, counts, sums, f"at N = {n}")
        bitwise = None
        if n == 65536:
            sequential = np.zeros((n, d), np.float32)
            np.add.at(sequential, ids.cpu().numpy(), z.cpu().numpy())
            bitwise = bool(np.array_equal(sums.cpu().numpy(), sequential))
            if not bitwise:
                raise AssertionError("K2 sums at N = 65536 are not the sequential ascending sum")
        def library():
            lib_ids = torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1)
            torch.bincount(lib_ids, minlength=n)
            torch.zeros(n, d, device=dev).index_add_(0, lib_ids, z)

        ms = cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), 10)
        plain_ms = cuda_ms(lambda: vq_nearest_with_stats_reference(z, c), 1, warmup=0)
        library_ms = cuda_ms(library, 5)
        device_ms, kernels = profile_device(lambda: vq_nearest_with_stats_cuda(z, c), 5)
        bound_ms, bound_by = stats_bound(b, n, d)
        stages = stage_ms(kernels)
        results[n] = {"shape": [b, n, d], "mismatches": mismatches, "max_id_gap": max_gap,
                      "max_abs_err": max_err, "sums_bit_equal": bitwise, "ms": ms,
                      "device_ms": device_ms, "stage_ms": stages, "bound_ms": bound_ms,
                      "bound_by": bound_by, "plain_ms": plain_ms, "library_ms": library_ms,
                      "codes_used": int((counts > 0).sum())}
        print(f"K2 {b}x{n}x{d} (code ranges of 49152): {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); counts equal; sums max abs err "
              f"{max_err:.3g}" + ("" if bitwise is None else
                                           ", bit-equal to a sequential ascending fp32 sum")
              + f"; {int((counts > 0).sum())} codes used; K2 {ms:.4f} ms per call (device "
              f"busy {device_ms} ms, by stage {stages}), plain {plain_ms:.3f} ms, "
              f"addmm+argmin+bincount+index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]")
        del z, c, ids, counts, sums
        torch.cuda.empty_cache()
    return results


def skewed_stats(card: str, gen) -> dict:
    """K2 at the corpus shape with every row on code 0, as at random init."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest_with_stats_cuda,
        vq_nearest_with_stats_reference,
    )

    b, n, d = CORPUS_SHAPE
    dev = torch.device("cuda")
    z = torch.randn(b, d, generator=gen, device=dev)
    c = 100.0 + torch.randn(n, d, generator=gen, device=dev)
    c[0] = z.mean(0)
    ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
    again = vq_nearest_with_stats_cuda(z, c)
    if not all(torch.equal(x, y) for x, y in zip((ids, counts, sums), again)):
        raise AssertionError("K2 is not deterministic in the skewed case")
    if int(ids.abs().sum()) != 0 or float(counts[0]) != b or float(counts.sum()) != b:
        raise AssertionError(f"skewed K2: {int((ids != 0).sum())} rows off code 0, "
                             f"counts[0] = {float(counts[0])}")
    max_err = hold_stats(z, ids, counts, sums, "in the skewed case")
    sequential = torch.from_numpy(np.cumsum(z.cpu().numpy(), axis=0, dtype=np.float32)[-1])
    if not (torch.equal(sums[0].cpu(), sequential) and int(sums[1:].abs().sum()) == 0):
        raise AssertionError("skewed K2 sums are not the sequential ascending fp32 sum")
    ms = cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), 5)
    device_ms, kernels = profile_device(lambda: vq_nearest_with_stats_cuda(z, c), 5)
    stages = stage_ms(kernels)

    def library():
        lib_ids = torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1)
        torch.bincount(lib_ids, minlength=n)
        torch.zeros(n, d, device=dev).index_add_(0, lib_ids, z)

    library_ms = cuda_ms(library, 5)
    plain_ms = cuda_ms(lambda: vq_nearest_with_stats_reference(z, c), 1, warmup=0)
    bound_ms, bound_by = stats_bound(b, n, d)
    # not part of the bound: the port's bit-equal sums make code 0's sum a
    # chain of B dependent fp32 adds per column (~4 cycles each), a floor of
    # its own design that the one-hot product of the TPU kernel does not have
    chain_ms = 4 * b / SM_CLOCK_HZ * 1e3
    print(f"K2 skewed {b}x{n}x{d} (all rows on code 0): counts exact, sums bit-equal to a "
          f"sequential fp32 sum (plain one-hot product within {max_err:.3g}), two "
          f"calls bit-identical; K2 {ms:.4f} ms per call (device busy {device_ms} ms, by "
          f"stage {stages}: {kernels}), plain {plain_ms:.3f} ms, addmm+argmin+bincount+"
          f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); the "
          f"sequential sums' floor, a chain of "
          f"{b} dependent adds, {chain_ms:.3f} ms at {SM_CLOCK_HZ / 1e6:.0f} MHz [{card}]")
    return {"shape": [b, n, d], "max_abs_err": max_err, "ms": ms,
            "device_ms": device_ms, "stage_ms": stages, "kernel_ms": kernels,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def fast_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """Least time (ms) for K1f: 2*B*N*D bf16 operations over the dense bf16
    tensor peak, against z and c (fp32) read once and the ids written once."""
    ops_ms = 2 * b * n * d / PEAK_BF16_FLOPS * 1e3
    bytes_ms = 4 * (b * d + n * d + b) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def check_near_ties(z, c, got, want, bf16: bool = True) -> tuple[int, float, float]:
    """Ids may differ only on near-ties of the fp32 expand form (over bf16
    operands with ``bf16``: K1f against its plain version), as ``tie_gap``
    states. Returns (differing rows, largest fp64 distance gap, largest gap
    over its allowance)."""
    from lipvq_tpu_torch.ops.vq_lookup import tie_gap

    gap, allowed = tie_gap(z, c, got, want, bf16=bf16)
    if (gap > allowed).any():
        raise AssertionError(f"ids differ beyond the near-tie bound on "
                             f"{int((gap > allowed).sum())} rows")
    if not gap.numel():
        return 0, 0.0, 0.0
    return gap.numel(), float(gap.max()), float((gap / allowed).max())


def fast_phase(card: str) -> dict:
    """K1f against its plain version: exact ids on bf16-exact fixtures, the
    near-tie rule of ``check_near_ties`` at the served, train and corpus
    shapes, the share of ids that differ from K1's, times."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        FAST_MAX_D,
        plan_fast,
        vq_nearest_cuda,
        vq_nearest_fast_reference,
    )

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    dev = torch.device("cuda")
    # operands k/8 with |k| < 256 are bf16-exact and every sum is exact in
    # fp32, so the ids are exactly the plain version's
    fixtures = []
    for b, n, d in [(80, 128, 12), (300, 1024, 208), (70, 65, 791), (1, 1, 1),
                    (40000, 1024, 208), (70, 65, 129), (100, 300, FAST_MAX_D)]:
        rng = np.random.default_rng(0)
        z = np.round(np.clip(rng.standard_normal((b, d)) * 8, -255, 255)) / 8
        c = np.round(np.clip(rng.standard_normal((n, d)) * 8, -255, 255)) / 8
        fixtures.append((f"dyadic{b}x{n}x{d}", z.astype(np.float32), c.astype(np.float32)))
    fixtures.append(("ties", np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32),
                     np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32)))
    for name, z, c in fixtures:
        zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
        got = vq_nearest_cuda(zt, ct, precision="fast")
        want = vq_nearest_fast_reference(zt, ct)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1f ids differ from the plain version on {name}: "
                                 f"{int((got != want).sum())} rows")
        if name == "ties" and got.tolist() != [1, 3]:
            raise AssertionError(f"K1f tie rule: got {got.tolist()}, want [1, 3]")
    print(f"K1f fixtures: ids exactly equal to the plain version on {len(fixtures)} "
          f"bf16-exact fixtures")

    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for label, (b, n, d), reps, plain_reps in (("slice", SLICE_SHAPE, 50, 10),
                                               ("train", TRAIN_SHAPE, 50, 10),
                                               ("corpus", CORPUS_SHAPE, 10, 3)):
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        got = vq_nearest_cuda(z, c, precision="fast")
        want = vq_nearest_fast_reference(z, c)
        exceptions, max_gap, worst = check_near_ties(z, c, got, want)
        flips = float((got != vq_nearest_cuda(z, c)).float().mean())
        ms = cuda_ms(lambda: vq_nearest_cuda(z, c, precision="fast"), reps)
        plain_ms = cuda_ms(lambda: vq_nearest_fast_reference(z, c), plain_reps)
        library_ms = cuda_ms(lambda: ((c * c).sum(1) - 2.0 * (
            z.bfloat16() @ c.bfloat16().T).float()).argmin(1), reps)
        device_ms, kernels = profile_device(lambda: vq_nearest_cuda(z, c, precision="fast"),
                                            reps)
        bound_ms, bound_by = fast_bound(b, n, d)
        share = None if device_ms is None else bound_ms / device_ms
        plan = plan_fast(b, n, d, torch.cuda.get_device_properties(dev).multi_processor_count)
        results[label] = {"shape": [b, n, d], "mismatches": exceptions,
                          "max_abs_err": max_gap, "max_gap_over_allowance": worst,
                          "flip_rate_vs_k1": flips, "ms": ms,
                          "device_ms": device_ms, "kernel_ms": kernels, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_share": share,
                          "plan": plan._asdict()}
        print(f"K1f {label} {b}x{n}x{d}: {exceptions} rows differ from the plain version, "
              f"all within the near-tie bound (largest fp64 gap {max_gap:.3g}, "
              f"{worst:.3g} of its allowance); "
              f"ids differ from K1's on {flips:.4%} of rows; K1f {ms:.4f} ms per call "
              f"(mma.sync design: {K1F_MMA_SYNC[label][0]}), device busy {device_ms} ms "
              f"(mma.sync design: {K1F_MMA_SYNC[label][1]}; {kernels}), plan {tuple(plan)} "
              f"({plan.ctas} CTAs), plain {plain_ms:.4f} ms, bf16 matmul+argmin "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16), "
              f"{share if share is None else f'{share:.1%}'} of it [{card}]")
        del z, c, got, want
    torch.cuda.empty_cache()
    return results


# the tokenizer switches of each arm of the paper's ablation
ARM_SWITCHES = {"vq": {"vq_vae_enabled": True, "ln_act_enabled": False},
                "bin": {"bin_enabled": True, "ln_act_enabled": False},
                "ln_act": {"ln_act_enabled": True},
                "raw": {"ln_act_enabled": False},
                "fast": {"fast_enabled": True, "ln_act_enabled": False}}


# the gated scan's calls (the Mamba block's on the card) and the Dense
# layers' dtype: the Jamba cell's (bf16), the icl_mamba arms' (6 x 512,
# d_state 8, fp32: 50 pairs a train step, 16 envs a request) and a narrow
# one (the ln_act tokenizer's d_inner 24)
SCAN_SHAPES = {"jamba": (192, 30, 5120, 16, torch.bfloat16),
               "arm_train": (50, 30, 1024, 8, torch.float32),
               "arm_serve": (16, 30, 1024, 8, torch.float32),
               "narrow": (10, 10, 24, 8, torch.float32)}
SCAN_OPS = (7, 23)  # per element (b, t, d, n), forward and backward


def scan_bound(b: int, t: int, d: int, n: int, size: int) -> tuple[float, float]:
    """Least ms of the gated scan's forward and backward call, dt, z, out
    and their gradients of ``size`` bytes an element: each tensor read or
    written once over the HBM rate (forward x, dt, z, B, C, A, D in and out
    out; backward those with out's gradient in, the seven gradients out),
    or the operations over the dense peak, whichever is larger."""
    e, btd, btn = b * t * d * n, b * t * d, b * t * n
    fwd = max(SCAN_OPS[0] * e / PEAK_BF16_FLOPS,
              ((4 + 3 * size) * btd + 4 * (2 * btn + d * n + d)) / PEAK_BYTES_PER_S)
    bwd = max(SCAN_OPS[1] * e / PEAK_BF16_FLOPS,
              ((8 + 5 * size) * btd + 4 * (4 * btn + 2 * d * n + 2 * d)) / PEAK_BYTES_PER_S)
    return 1e3 * fwd, 1e3 * bwd


def scan_counts() -> tuple[int, int]:
    from lipvq_tpu_torch.ops.selective_scan import selective_scan_cuda

    return selective_scan_cuda.launches, selective_scan_cuda.elems


MIXER_SHAPE = (192, 30, 5120, 16)  # the Jamba cell's mixer: b, t, d_inner, d_state


def mixer_chain(fused: bool, h, dt, A, B, C, D, w, bias):
    """(out_proj's operand, x_proj's operand) of the Mamba block's chain from
    in_proj's output h, dt_proj's output dt given: ``MambaBlock._fused``'s
    kernels or ``._composed``'s PyTorch operations, less their GEMMs."""
    from lipvq_tpu_torch.ops import causal_conv1d
    from lipvq_tpu_torch.ops import selective_scan as ss

    if fused:
        xh, z = h.chunk(2, dim=-1)
        xs, xs_op = causal_conv1d.causal_conv1d_silu(xh, w, bias, copy=True)
        return ss.gated_selective_scan(xs, dt, A, B, C, D, z), xs_op
    t, k = h.shape[1], w.shape[0]
    xs, z = h.float().chunk(2, dim=-1)
    xp = torch.nn.functional.pad(xs, (0, 0, k - 1, 0))
    xs = torch.nn.functional.silu(sum(w[j] * xp[:, j:j + t] for j in range(k)) + bias)
    y = ss.selective_scan(xs, torch.nn.functional.softplus(dt.float()), A, B, C, D)
    return (y * torch.nn.functional.silu(z)).to(h.dtype), xs.to(h.dtype)


def mixer_case(card: str) -> dict:
    """The mixer's chain at ``MIXER_SHAPE``: fused against composed (module
    docstring, phase 2)."""
    b, t, d, n = MIXER_SHAPE
    g = torch.Generator(device="cuda").manual_seed(26)
    bf16 = torch.bfloat16
    h = torch.randn(b, t, 2 * d, generator=g, device="cuda").to(bf16)
    dt = (1.5 * torch.randn(b, t, d, generator=g, device="cuda") - 2.0).to(bf16)
    A = -torch.rand(d, n, generator=g, device="cuda") * 2.0 - 0.1
    B, C = (torch.randn(b, t, n, generator=g, device="cuda") for _ in range(2))
    D = torch.randn(d, generator=g, device="cuda")
    w = torch.randn(4, d, generator=g, device="cuda") / 2.0
    bias = 0.1 * torch.randn(d, generator=g, device="cuda")
    args = [v.requires_grad_() for v in (h, dt, A, B, C, D, w, bias)]
    grads_out = [torch.randn(b, t, d, generator=g, device="cuda").to(bf16) for _ in range(2)]

    def step(fused):
        outs = mixer_chain(fused, *args)
        return [o.detach() for o in outs], torch.autograd.grad(outs, args, grads_out)

    want, want_g = step(False)
    calls = mixer_counts()[0]
    got, got_g = step(True)
    calls = mixer_counts()[0] - calls
    if calls != 2:
        raise AssertionError(f"mixer: {calls} conv kernel calls for one forward and backward")
    names = ("out", "xs_op", "dh", "ddt", "dA", "dB", "dC", "dD", "dconv_kernel", "dconv_bias")
    worst, unequal = {}, {}
    for name, a, e in zip(names, (*got, *got_g), (*want, *want_g)):
        unequal[name] = float((a != e).float().mean())  # the share not bit-equal
        a, e = a.float(), e.float()
        atol = 1e-5 * float(e.abs().max())
        worst[name] = float(((a - e).abs() / (atol + 1e-4 * e.abs())).max())
        if worst[name] > 1:
            print(f"mixer {name}: worst {worst[name]}, unequal share {unequal[name]}")
    if max(worst.values()) > 1:
        raise AssertionError(f"mixer: fused against composed beyond 1e-4: {worst}")
    del want, want_g, got, got_g
    ms = {side: cuda_ms(lambda: step(side == "fused"), 10) for side in ("composed", "fused")}
    _, kernels = profile_device(lambda: step(True), 5)
    conv = {k: v for k, v in kernels.items() if "causal_conv1d" in k}
    scan = {k: v for k, v in kernels.items() if "selective_scan" in k}
    if not conv or not scan:
        raise AssertionError(f"mixer: kernels {sorted(kernels)}")
    btd, btn = b * t * d, b * t * n
    # bytes each kernel pair must move: conv x (bf16) in, xs (fp32) and its
    # copy out, then x, both gradients in and dx out; the scan x (fp32), dt,
    # z in and out out, then those with out's gradient in and dx (fp32), ddt,
    # dz out, B and C (and their gradients) once each way
    conv_bytes = (8 * btd, 10 * btd)
    scan_bytes = (10 * btd + 8 * btn, 18 * btd + 16 * btn)
    bound = {"conv": [1e3 * v / PEAK_BYTES_PER_S for v in conv_bytes],
             "scan": [1e3 * v / PEAK_BYTES_PER_S for v in scan_bytes]}
    out = {"shape": [b, t, d, n], "launches": calls, "worst_in_tolerance": worst,
           "unequal_share": unequal, "ms": ms,
           "conv_kernel_ms": conv, "scan_kernel_ms": scan, "bound_ms": bound,
           "kernel_ms": {k: v for k, v in kernels.items() if k not in conv and k not in scan}}
    print(f"mixer {(b, t, d, n)}: fused against composed within rtol 1e-4 / atol 1e-5 of the "
          f"largest (worst in units of the tolerance {worst}; share of elements not bit-equal "
          f"{unequal}); forward + backward {ms} ms; "
          f"conv kernels {conv} ms (bound {bound['conv']}), scan kernels {scan} ms (bound "
          f"{bound['scan']}), other kernels {out['kernel_ms']} [{card}]")
    return out


def scan_phase(card: str) -> dict:
    """The gated selective scan, the form the Mamba block runs on the card,
    against its plain versions at the shapes of ``SCAN_SHAPES``, then the
    mixer's chain (module docstring, phase 2)."""
    from lipvq_tpu_torch.ops import selective_scan as ss

    results = {}
    for label, (b, t, d, n, dtype) in SCAN_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(16)
        x = torch.randn(b, t, d, generator=g, device="cuda")
        dt = (1.5 * torch.randn(b, t, d, generator=g, device="cuda") - 2.0).to(dtype)
        A = -torch.rand(d, n, generator=g, device="cuda") * 2.0 - 0.1
        B, C = (torch.randn(b, t, n, generator=g, device="cuda") for _ in range(2))
        D = torch.randn(d, generator=g, device="cuda")
        # the gate, a half of in_proj's output (rows 2d apart)
        z = torch.randn(b, t, 2 * d, generator=g, device="cuda").to(dtype)[..., d:]
        args = [v.requires_grad_() for v in (x, dt, A, B, C, D)] + [z.requires_grad_()]
        before = scan_counts()
        out = ss.gated_selective_scan(*args)
        dout = torch.randn(b, t, d, generator=g, device="cuda").to(dtype)
        grads = torch.autograd.grad(out, args, dout)
        torch.cuda.synchronize()
        launches, elems = (a - c for a, c in zip(scan_counts(), before))
        if (launches, elems) != (2, 2 * b * t * d * n):
            raise AssertionError(f"scan {label}: {launches} launches of {elems} elements for "
                                 f"one forward and backward of {(b, t, d, n)}")
        plain = [v.detach() for v in args]
        with torch.no_grad():
            want = (ss.gated_scan_forward_plain(*plain),
                    *ss.gated_scan_backward_plain(*plain, dout))
        worst = {}
        for name, got, w in zip(("out", "dx", "ddt", "dA", "dB", "dC", "dD", "dz"),
                                (out.detach(), *grads), want):
            # a bf16 result of fp32 values that agree to fp32 rounding may
            # also round to the next bf16 value (up to 2**-7 of it)
            rtol = 1e-4 + (2.0**-7 if got.dtype == torch.bfloat16 else 0.0)
            got, w = got.float(), w.float()
            atol = 1e-5 * float(w.abs().max())
            torch.testing.assert_close(got, w, rtol=rtol, atol=atol, msg=f"scan {label} {name}")
            # the worst element's error in units of its tolerance
            worst[name] = float(((got - w).abs() / (atol + rtol * w.abs())).max())
        del out, grads, want
        _, steps = ss._gated_forward_cuda(*plain)
        fwd_ms = cuda_ms(lambda: ss._gated_forward_cuda(*plain), 20)
        serve_ms = cuda_ms(lambda: ss._gated_forward_cuda(*plain, keep_steps=False), 20)
        bwd_ms = cuda_ms(lambda: ss._backward_cuda(*plain[:6], dout, plain[6], steps), 20)
        fwd_dev, fwd_kernels = profile_device(lambda: ss._gated_forward_cuda(*plain), 10)
        bwd_dev, bwd_kernels = profile_device(
            lambda: ss._backward_cuda(*plain[:6], dout, plain[6], steps), 10)
        named = {**fwd_kernels, **bwd_kernels}
        if not named or not all("selective_scan" in k for k in named):
            raise AssertionError(f"scan {label}: kernels {sorted(named)}")
        with torch.no_grad():
            plain_fwd_ms = cuda_ms(lambda: ss.gated_scan_forward_plain(*plain), 3)
            plain_bwd_ms = cuda_ms(lambda: ss.gated_scan_backward_plain(*plain, dout), 3)
        bound = scan_bound(b, t, d, n, dtype.itemsize)
        results[label] = {
            "shape": [b, t, d, n], "dtype": str(dtype), "launches": launches, "elems": elems,
            "worst_in_tolerance": worst, "ms": [fwd_ms, bwd_ms], "forward_no_steps_ms": serve_ms,
            "device_ms": [fwd_dev, bwd_dev], "kernel_ms": named,
            "plain_ms": [plain_fwd_ms, plain_bwd_ms], "bound_ms": list(bound),
            "share": [None if dv is None else bd / dv for bd, dv in zip(bound, (fwd_dev, bwd_dev))]}
        print(f"scan {label} {(b, t, d, n)} {dtype}: gated, 2 launches, {elems} elements; out "
              f"and the seven gradients within rtol 1e-4 (+2**-7 in bf16) / atol 1e-5 of the "
              f"largest of the plain versions (worst in units of the tolerance {worst}); "
              f"forward {fwd_ms:.4f} ms (device {fwd_dev} ms; {serve_ms:.4f} ms keeping no "
              f"steps), backward {bwd_ms:.4f} ms (device {bwd_dev} ms): {named}; plain "
              f"{plain_fwd_ms:.3f} / {plain_bwd_ms:.3f} ms; bound {bound[0]:.4f} / "
              f"{bound[1]:.4f} ms [{card}]")
        del plain, args, dout, steps
        torch.cuda.empty_cache()
    results["mixer"] = mixer_case(card)
    torch.cuda.empty_cache()
    return results


OPT_CONFIGS = {"jamba": "portbench/configs/icl_lipvq_jamba2_3b.json",
               "lowdim": "portbench/configs/icl_lipvq_lowdim.json"}
OPT_STEPS = 4  # the optimizer phase's steps on each path; the first makes the moments
OPT_BYTES = (28, 4)  # bytes a parameter: the update (p, g, m, v in; p, m, v out), the norms
OPT_HOST_REPS = 30
OPT_L2_LR = 1e-4  # the L2 check's rate, held constant (the template's warm-up starts at 0)


def param_sizes(path: str) -> list[list[int]]:
    """The element counts of a benchmark configuration's parameters by
    optimizer (policy, tokenizer): its policy built on the meta device,
    where no weight is made."""
    import lipvq_tpu_torch.algo.icl as icl_module
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils import obs_utils

    cfg = json.loads(open(path).read())
    cf = config_factory(cfg["algo"], cfg["port_config"])
    obs_utils.initialize_obs_utils_with_config(cf)
    saved = icl_module.seeded_init, torch.nn.Module.to
    icl_module.seeded_init = lambda *args, **kwargs: None
    torch.nn.Module.to = lambda self, *args, **kwargs: self
    try:
        with torch.device("meta"):
            algo = algo_factory(cfg["algo"], cf, {k: list(v) for k, v in cfg["obs"]},
                                ac_dim=cfg["ac_dim"], device="cpu")
    finally:
        icl_module.seeded_init, torch.nn.Module.to = saved
    return [[p.numel() for p in o.params] for o in algo.optimizers().values()]


def jamba_optimizers(lrs=(1e-4, 1e-3)):
    """A policy's and a tokenizer's AdamW as the Jamba cell builds them (the
    cells' rates after the warm-up, the policy's clip at 100) over
    ``params`` [policy's, tokenizer's]."""
    from lipvq_tpu_torch.algo.base import ScheduledOptimizer

    def make(params):
        return [ScheduledOptimizer(params[0], torch.optim.AdamW, lambda step: lrs[0],
                                   max_grad_norm=100.0, weight_decay=0.01, eps=1e-8),
                ScheduledOptimizer(params[1], torch.optim.AdamW, lambda step: lrs[1],
                                   weight_decay=1e-4, eps=1e-8)]
    return make


def optimizer_paths(start: list[list[torch.Tensor]], make):
    """Two copies of the optimizers ``make`` builds over fp32 parameters
    from ``start`` (one list of tensors an optimizer, taken by the first
    copy), one shared grad per parameter, and one step of each path:
    (grads, kernels' optimizers, step, torch's optimizers, step). The
    kernels' step goes first: torch's clips the shared grads in place."""
    from lipvq_tpu_torch.algo.base import clip_by_global_norm_, global_norm, step_optimizers

    grads = [[torch.empty_like(t) for t in ts] for ts in start]
    plain = make([[torch.nn.Parameter(t.clone()) for t in ts] for ts in start])
    fused = make([[torch.nn.Parameter(t) for t in ts] for ts in start])
    start.clear()

    def give(opts) -> None:
        for o, gs in zip(opts, grads):
            for p, g in zip(o.params, gs):
                p.grad = g

    def fused_step():
        give(fused)
        return step_optimizers(fused)

    def torch_step():
        """The block without the kernels: the logged norm, each clip,
        torch's foreach step of each optimizer."""
        give(plain)
        norm = global_norm([g for gs in grads for g in gs])
        for o, gs in zip(plain, grads):
            if o.max_grad_norm is not None:
                clip_by_global_norm_(gs, o.max_grad_norm)
            o.optimizer.step()
            o._advance()
        return norm

    return grads, fused, fused_step, plain, torch_step


def expected_launches(sizes: list[list[int]], clips: list) -> int:
    """The launches one ``step_optimizers`` call over optimizers of
    parameters of ``sizes`` with clips ``clips`` makes, as the argument
    blocks call for: each clipping optimizer's norm pass and finalize, each
    optimizer's update (one set of hyper-parameters each), then one norm
    pass and finalize over the rest's grads; empty tensors take no place."""
    from lipvq_tpu_torch.ops import fused_adamw

    lim = fused_adamw.limits()
    launches, rest = 0, 0
    for ns, clip in zip(sizes, clips):
        k = sum(1 for n in ns if n)
        launches += -(-k // lim["adam_tensors"])
        if clip is None:
            rest += k
        else:
            launches += -(-k // lim["norm_tensors"]) + 1
    return launches + -(-rest // lim["norm_tensors"]) + 1


def optimizer_gaps(fused, plain) -> dict[str, float]:
    """After the same steps from the same start: the largest gap of p in
    units of the optimizer's rate (one step's size), of each moment over
    its largest element."""
    worst = {"p": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0}
    for of, op in zip(fused, plain):
        lr = op.optimizer.param_groups[0]["lr"]
        for pf, pp in zip(of.params, op.params):
            sf, sp = of.optimizer.state[pf], op.optimizer.state[pp]
            worst["p"] = max(worst["p"], float((pf - pp).detach().abs().max()) / lr)
            for k in ("exp_avg", "exp_avg_sq"):
                scale = float(sp[k].abs().max()) or 1.0
                worst[k] = max(worst[k], float((sf[k] - sp[k]).abs().max()) / scale)
            if not float(sf["step"]) == float(sp["step"]) == OPT_STEPS:
                raise AssertionError("optimizer: step counts differ")
    return worst


def check_gaps(label: str, worst: dict, norms: list) -> float:
    """The clip's scale differs in its last bits (the norm's order of sums):
    p within a thousandth of one step, the moments within 1e-5 of their
    largest, the logged norms within 1e-5. Returns the norms' largest gap."""
    rel_norm = max(abs(a - b) / b for a, b in norms)
    if worst["p"] > 1e-3 or max(worst["exp_avg"], worst["exp_avg_sq"]) > 1e-5 or rel_norm > 1e-5:
        raise AssertionError(f"optimizer {label}: kernels against torch {worst}, norms {norms}")
    return rel_norm


def adam_l2_check(card: str, gen) -> dict:
    """Adam with L2 into the gradient, the branch Diffusion Policy, ACT and
    BC take: ``optimizer_from_optim_params`` over ACT's parameters and with
    its template's settings (L2 1e-4, its clip; the rate held at
    OPT_L2_LR), from ACT's initial weights, grads N(0, 1e-3) so that the
    L2 term shows in the moments; OPT_STEPS steps of each path, held as the
    Jamba parameters are."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.base import optimizer_from_optim_params

    act = algo_factory("act", baseline_config("act", {}), OBS_SHAPES, ac_dim=AC_DIM)
    start = [[p.detach().clone() for p in act.optimizers()["policy"].params]]
    optim_params = act.algo_config.optim_params.policy
    clip = act.global_config.train.max_grad_norm
    del act

    def make(params):
        o = optimizer_from_optim_params(params[0], optim_params, max_grad_norm=clip)
        o.schedule = lambda step: OPT_L2_LR
        for group in o.optimizer.param_groups:
            group["lr"] = OPT_L2_LR
        return [o]

    elems = sum(t.numel() for t in start[0])
    grads, fused, fused_step, plain, torch_step = optimizer_paths(start, make)
    group = fused[0].optimizer.param_groups[0]
    assert type(fused[0].optimizer) is torch.optim.Adam and group["weight_decay"] > 0
    before = optimizer_counts()
    norms = []
    for _ in range(OPT_STEPS):
        for g in grads[0]:
            g.normal_(0.0, 1e-3, generator=gen)
        norms.append([float(fused_step()), float(torch_step())])
    counts = {k: v - before[k] for k, v in optimizer_counts().items()}
    assert_fused_optimizer("adam_l2", counts, OPT_STEPS)
    worst = optimizer_gaps(fused, plain)
    rel_norm = check_gaps("adam_l2", worst, norms)
    print(f"optimizer, Adam with L2 {group['weight_decay']} (ACT's {len(grads[0])} tensors, "
          f"{elems} parameters, clip {clip}): kernels against torch: p within "
          f"{worst['p']:.3g} of a step, moments {worst['exp_avg']:.3g} / "
          f"{worst['exp_avg_sq']:.3g} of their largest, norm {rel_norm:.3g}; "
          f"{counts['launches']} launches in {OPT_STEPS} steps [{card}]")
    del fused, plain, grads, fused_step, torch_step
    torch.cuda.empty_cache()
    return {"elems": elems, "weight_decay": group["weight_decay"], "worst": worst,
            "norm_rel_gap": rel_norm, "counts": counts}


def optimizer_phase(card: str) -> dict:
    """The optimizer's two kernels against torch's foreach path at the
    Jamba cell's parameters (AdamW) and at ACT's (Adam with L2), and the
    host time of each path's step at the Jamba cell's and the flagship's
    (module docstring, phase 2)."""
    from torch.profiler import ProfilerActivity, profile

    sizes = param_sizes(OPT_CONFIGS["jamba"])
    elems = sum(map(sum, sizes))
    gen = torch.Generator(device="cuda").manual_seed(24)
    start = [[torch.randn(n, generator=gen, device="cuda") * 0.02 for n in ns] for ns in sizes]
    grads, fused, fused_step, plain, torch_step = optimizer_paths(start, jamba_optimizers())
    ms, peak, norms = {"kernels": [], "torch": []}, {}, []
    host_ms = {cell: {"kernels": [], "torch": []} for cell in OPT_CONFIGS}
    before = optimizer_counts()
    for i in range(OPT_STEPS):
        for gs in grads:  # N(0, 0.01): the policy's norm ~380, so the clip engages
            for g in gs:
                g.normal_(0.0, 0.01, generator=gen)
        pair = []
        for label, fn in (("kernels", fused_step), ("torch", torch_step)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            # the card kept busy while the host enqueues the step: e0 -> e1 is
            # the step's device time (the profiler can lose a session's first
            # kernels in a long process)
            torch.cuda._sleep(int(0.03 * SM_CLOCK_HZ))
            t0 = time.perf_counter()
            e0.record()
            pair.append(fn())
            e1.record()
            host = (time.perf_counter() - t0) * 1e3
            e1.synchronize()
            if i > 0:
                ms[label].append(e0.elapsed_time(e1))
                host_ms["jamba"][label].append(host)
            top = torch.cuda.max_memory_allocated()
            peak[label] = (top - base, top)
        norms.append([float(n) for n in pair])
    counts = {k: v - before[k] for k, v in optimizer_counts().items()}
    assert_fused_optimizer("jamba", counts, 2 * OPT_STEPS)
    worst = optimizer_gaps(fused, plain)
    rel_norm = check_gaps("jamba", worst, norms)
    # the device time of one more step of each, by kernel and by host op (the
    # profiler may credit a kernel to its own "Activity Buffer Request" too);
    # the launches the library reported against those the argument blocks
    # call for (the profiler can lose a session's first kernels in a long
    # process: it sees at most as many)
    want = expected_launches(sizes, [o.max_grad_norm for o in fused])
    before = optimizer_counts()["launches"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_step()
        torch.cuda.synchronize()
    launches = optimizer_counts()["launches"] - before
    dev_ms, kernels = device_busy(prof)
    by_op: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            for k in e.kernels:
                by_op[e.name] = by_op.get(e.name, 0.0) + k.duration / 1e3
    seen = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and ("sq_norms" in e.name or "clip_adamw" in e.name))
    foreach_ms = sum(v for op, v in by_op.items() if "_foreach" in op)
    if not kernels or abs(foreach_ms - sum(kernels.values())) > 1e-4 * foreach_ms:
        raise AssertionError(f"optimizer: kernels {kernels} launched under ops {by_op}")
    if launches != want or seen > launches or counts["launches"] != OPT_STEPS * want:
        raise AssertionError(f"optimizer: {launches} launches counted ({counts['launches']} in "
                             f"{OPT_STEPS} steps), {want} a step expected, {seen} profiled")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch_step()
        torch.cuda.synchronize()
    torch_dev_ms, torch_kernels = device_busy(prof)
    del fused, plain, grads, fused_step, torch_step
    torch.cuda.empty_cache()
    # the host's time from entry to return, the card idle before each call,
    # at the flagship's parameters (its cell is paced by the host)
    sizes_lowdim = param_sizes(OPT_CONFIGS["lowdim"])
    start = [[torch.randn(n, generator=gen, device="cuda") * 0.02 for n in ns]
             for ns in sizes_lowdim]
    grads, fused, fused_step, plain, torch_step = optimizer_paths(start, jamba_optimizers())
    for gs in grads:
        for g in gs:
            g.normal_(0.0, 0.01, generator=gen)
    for i in range(2 * (OPT_HOST_REPS + 1)):
        label, fn = (("kernels", fused_step), ("torch", torch_step))[i % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if i >= 2:
            host_ms["lowdim"][label].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    del fused, plain, grads, fused_step, torch_step
    torch.cuda.empty_cache()
    host = {cell: {k: statistics.median(v) for k, v in d.items()} for cell, d in host_ms.items()}
    bytes_moved = sum(OPT_BYTES) * elems
    out = {"elems": elems, "tensors": sum(map(len, sizes)), "bytes": bytes_moved,
           "ms": {k: statistics.median(v) for k, v in ms.items()},
           "profiled_ms": {"kernels": dev_ms, "torch": torch_dev_ms},
           "hbm_share": {k: bytes_moved / (v * 1e-3) / PEAK_BYTES_PER_S
                         for k, v in (("kernels", statistics.median(ms["kernels"])),
                                      ("torch", statistics.median(ms["torch"])))},
           "bound_ms": 1e3 * bytes_moved / PEAK_BYTES_PER_S, "launches": launches,
           "profiled_launches": seen,
           "counts": counts, "kernel_ms": kernels, "op_ms": by_op,
           "torch_kernel_ms": torch_kernels,
           "extra_bytes": {k: v[0] for k, v in peak.items()},
           "peak_bytes": {k: v[1] for k, v in peak.items()},
           "worst": worst, "norm_rel_gap": rel_norm, "host_ms": host,
           "host_tensors": {"jamba": sum(map(len, sizes)), "lowdim": sum(map(len, sizes_lowdim))}}
    print(f"optimizer at the Jamba cell's {out['tensors']} tensors, {elems} parameters (AdamW, "
          f"clip 100 engaged, logged norm): kernels {out['ms']['kernels']:.3f} ms of device time "
          f"(profiled {dev_ms} ms, {launches} launches counted, {seen} profiled), "
          f"{out['hbm_share']['kernels']} of 3.35 TB/s over {bytes_moved / 1e9:.2f} GB; torch's "
          f"foreach {out['ms']['torch']:.3f} ms (profiled {torch_dev_ms} ms); bound "
          f"{out['bound_ms']:.3f} ms; extra memory of the step {out['extra_bytes']} B, peak "
          f"{out['peak_bytes']} B; kernels against torch: p within {worst['p']:.3g} of a step, "
          f"moments {worst['exp_avg']:.3g} / {worst['exp_avg_sq']:.3g} of their largest, norm "
          f"{rel_norm:.3g}; {counts['launches']} launches in {OPT_STEPS} steps; by op {by_op}; "
          f"host ms a step (the enqueue), kernels / torch: {host} at {out['host_tensors']} "
          f"tensors [{card}]")
    out["adam_l2"] = adam_l2_check(card, gen)
    return out


def icl_config(compute_dtype: str = "bfloat16", train: dict | None = None,
               algo: str = "icl", arm: str = "vq"):
    """The paper's template widths with the flagship switches (``arm`` picks
    another tokenizer, ``algo="icl_mamba"`` the Mamba backbone). ``train``
    ({"ema": bool, "dropout": float, "warmup": int or None}) adds the
    training settings of exps/templates/icl.json: batch 100, AdamW lr 1e-4
    with L2 0.01 and a constant_with_warmup schedule, clip 100. A warmup of
    None keeps the template's (no ``num_warmup_steps`` key: 10000 steps),
    so the config loads again through ``config_factory``."""
    from lipvq_tpu_torch.config import config_factory

    section = "mamba" if algo == "icl_mamba" else "transformer"
    cfg = config_factory(algo, {
        "algo": {
            "gmm": {"enabled": True, "num_modes": 5},
            section: {
                "enabled": True, "context_length": 10, "embed_dim": 512,
                "num_layers": 6, "num_heads": 8, "causal": False,
                "supervise_all_steps": True, "pred_future_acs": True,
                "compute_dtype": compute_dtype, **ARM_SWITCHES[arm],
            },
            "vq": {"num_codes": 1024, "hidden_dim": 128},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if train is not None:
            cfg.train.batch_size = BATCH
            cfg.train.max_grad_norm = 100.0
            policy = cfg.algo.optim_params.policy
            policy.optimizer_type = "adamw"
            policy.regularization.L2 = 0.01
            policy.learning_rate.initial = 1e-4
            policy.learning_rate.scheduler_type = "constant_with_warmup"
            if train["warmup"] is not None:
                policy.learning_rate.num_warmup_steps = train["warmup"]
            cfg.algo.vq.ema_codebook = train["ema"]
            for key in ("emb_dropout", "attn_dropout", "block_output_dropout"):
                setattr(cfg.algo[section], key, train["dropout"])
    return cfg


def set_codebook(tok, algos, rng, extra_actions=None) -> None:
    """Set every algo's codebook to the latents of seeded actions under the
    fp32 CPU tokenizer ``tok`` (the codebook of a random init sends every
    latent to one code); the latents of ``extra_actions`` [k, A] take k
    random slots."""
    n = tok.quantizer.codebook.shape[0]
    with torch.no_grad():
        codebook = tok.encode(torch.from_numpy(
            rng.uniform(-1, 1, (n, AC_DIM)).astype(np.float32)))
        if extra_actions is not None:
            slots = torch.from_numpy(rng.permutation(n)[:len(extra_actions)])
            codebook[slots] = tok.encode(torch.from_numpy(extra_actions))
        for a in algos:
            a.nets.net.encoder.action_network.quantizer.codebook.copy_(codebook)


def set_separated_codebook(tok, algos, actions: np.ndarray, picks: int = 16,
                           rel_gap: float = 1e-5) -> int:
    """Set every algo's codebook so that the latent of each row of
    ``actions`` under the fp32 CPU tokenizer ``tok`` has one nearest code by
    a clear margin, and return the number of codes in use. Scripted actions
    repeat and nearly repeat, so codes made from them (``set_codebook``)
    leave latents whose two nearest codes differ by ~1e-6 in squared
    distance, where fp32 rounding decides between them. Here: codes at the
    latents of up to ``picks`` rows far apart (farthest-point order); while
    some latent's two nearest codes lie within ``rel_gap`` * ||z||^2 of each
    other (fp64), that latent's second-nearest code is dropped; the other
    slots lie far from every latent."""
    with torch.no_grad():
        z = tok.encode(torch.from_numpy(actions)).double()
    chosen, d = [0], ((z - z[0]) ** 2).sum(1)
    while len(chosen) < picks and float(d.max()) > 0:
        i = int(d.argmax())
        chosen.append(i)
        d = torch.minimum(d, ((z - z[i]) ** 2).sum(1))
    norm = (z * z).sum(1)
    while len(chosen) > 1:
        dist, order = (torch.cdist(z, z[chosen]) ** 2).sort(1)
        gap = (dist[:, 1] - dist[:, 0]) / norm
        if float(gap.min()) >= rel_gap:
            break
        chosen.pop(int(order[int(gap.argmin()), 1]))
    n = tok.quantizer.codebook.shape[0]
    codebook = z.mean(0) + 100.0 + torch.arange(n, dtype=torch.float64)[:, None]
    codebook[:len(chosen)] = z[chosen]
    with torch.no_grad():
        for a in algos:
            a.nets.net.encoder.action_network.quantizer.codebook.copy_(codebook.float())
    return len(chosen)


def random_obs(rng, lead) -> dict:
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32)
            for k, s in OBS_SHAPES.items()}


def slice_phase(card: str) -> dict:
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy

    algo = algo_factory("icl", icl_config(), OBS_SHAPES, ac_dim=AC_DIM)  # CUDA by default
    algo32 = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM)
    algo_cpu = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM,
                            device="cpu")
    net = algo.nets.net
    assert algo.device.type == "cuda"
    assert net.encoder.action_network.quantizer.codebook.shape == (1024, 791)
    assert net.transformer.block_0.mlp_fc.compute_dtype == torch.bfloat16
    assert net.transformer.num_layers == 6 and net.embed_dim == 512

    rng = np.random.default_rng(0)
    t = algo.context_length
    context = {"obs": random_obs(rng, (1, t)),
               "actions": rng.uniform(-1, 1, (1, t, AC_DIM)).astype(np.float32)}
    # the context's own latents are among the codes
    set_codebook(algo_cpu.nets.net.encoder.action_network, (algo, algo32, algo_cpu), rng,
                 context["actions"][0])

    batched_obs = [random_obs(rng, (N_ENVS, t)) for _ in range(5)]
    single_obs = [random_obs(rng, (t,)) for _ in range(3)]
    policy = ICLRolloutPolicy(algo)

    # the main path: 5 batched + 3 single-env requests, counted
    zero_launch_counts()
    batched = [policy.batched(o, context) for o in batched_obs]
    single = [policy(o, context) for o in single_obs]
    launches, k1f_launches, k2_launches = launch_counts()
    requests = len(batched) + len(single)
    if launches != requests or k1f_launches != 0 or k2_launches != 0:
        raise AssertionError(f"K1 launched {launches}, K1f {k1f_launches} and K2 "
                             f"{k2_launches} times for {requests} requests")
    for a in batched:
        assert a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all(), a.shape
    for a in single:
        assert a.shape == (AC_DIM,) and np.isfinite(a).all(), a.shape
    print(f"slice: {requests} requests served, K1 launched {launches} times")

    # the last batched request again, in bf16 and fp32 on the card and fp32
    # on the CPU
    ctx = {"obs": {k: np.repeat(v, N_ENVS, 0) for k, v in context["obs"].items()},
           "actions": np.repeat(context["actions"], N_ENVS, 0)}
    outs = {}
    with torch.inference_mode():
        for name, a in (("bf16", algo), ("fp32", algo32), ("cpu", algo_cpu)):
            obs, ctx_obs, ctx_act = (a._put_infer(x) for x in (batched_obs[-1], ctx["obs"],
                                                               ctx["actions"]))
            d, _ = a.nets.forward_train(obs, ctx_obs, ctx_act, low_noise_eval=False)
            ids = a.nets.net.encoder.action_network.tokenize(ctx_act.reshape(-1, AC_DIM))
            outs[name] = ([x.float().cpu().numpy() for x in d], ids.cpu().numpy())
    # low-noise eval samples one of its row's mode means (sigma 1e-4)
    gap = np.abs(batched[-1][:, None, :] - outs["bf16"][0][0][:, 0]).max(-1).min(-1).max()
    assert gap <= 1e-3, f"a served action lies {gap} from every mode mean"
    for field, got, want in zip(("means", "scales", "logits"), outs["fp32"][0], outs["cpu"][0]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=field)
    np.testing.assert_array_equal(outs["fp32"][1], outs["cpu"][1])
    distinct = len(np.unique(outs["cpu"][1]))
    assert distinct >= 8, f"only {distinct} distinct context codes"
    bf16_err = float(np.abs(outs["bf16"][0][0] - outs["cpu"][0][0]).max())
    print(f"slice: fp32 card == CPU within rtol 1e-3 / atol 1e-4; VQ ids equal "
          f"({distinct} distinct codes); bf16 card means within {bf16_err:.3g} of fp32 CPU")

    batched_ms = host_ms(lambda: policy.batched(batched_obs[0], context))
    single_ms = host_ms(lambda: policy(single_obs[0], context))
    busy_ms, kernels = profile_device(lambda: policy.batched(batched_obs[0], context), 10)
    idle = None if busy_ms is None else 1.0 - busy_ms / batched_ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"slice latency: {batched_ms:.3f} ms per {N_ENVS}-env request, "
          f"{single_ms:.3f} ms per single-env request (median of 20); device "
          f"busy {busy_ms} ms per {N_ENVS}-env request, idle share {idle}; "
          f"{len(kernels)} distinct device ops, top {top} [{card}]")
    return {"launches": launches, "k1f_launches": k1f_launches, "k2_launches": k2_launches,
            "batched_request_ms": batched_ms,
            "single_request_ms": single_ms, "device_busy_ms": busy_ms,
            "idle_share": idle}


class SequenceItems:
    """In-memory training items shaped like SequenceDataset's: obs leaves
    [19, ...] and actions [19, 12], made in bulk from a seed."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        obs = random_obs(rng, (n, SEQ_STEPS))
        actions = rng.uniform(-1, 1, (n, SEQ_STEPS, AC_DIM)).astype(np.float32)
        self.items = [{"obs": {k: v[i] for k, v in obs.items()}, "actions": actions[i]}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def train_phase(card: str) -> dict:
    """20 run_epoch steps with the loss-based and with the EMA codebook,
    launches counted; step time, device busy time and top device ops."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    items = SequenceItems(2 * BATCH, seed=3)
    tok_cpu = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM,
                           device="cpu").nets.net.encoder.action_network
    results = {}
    for label, ema in (("train", False), ("train_ema", True)):
        algo = algo_factory("icl", icl_config(train={"ema": ema, "dropout": 0.1, "warmup": 10}),
                            OBS_SHAPES, ac_dim=AC_DIM)
        tok = algo.nets.net.encoder.action_network
        assert algo.device.type == "cuda" and tok.quantizer.codebook.shape == (1024, 791)
        set_codebook(tok_cpu, (algo,), np.random.default_rng(4))
        loader = DataLoader(items, BATCH, seed=5)

        # the main path: 20 train steps, counted
        zero_launch_counts()
        log = run_epoch(algo, loader, epoch=1, num_steps=TRAIN_STEPS)
        k1, k1f, k2 = launch_counts()
        opt = optimizer_counts()
        if (k1, k1f, k2) != ((0, 0, TRAIN_STEPS) if ema else (TRAIN_STEPS, 0, 0)):
            raise AssertionError(f"{label}: K1 launched {k1}, K1f {k1f} and K2 {k2} times in "
                                 f"{TRAIN_STEPS} steps")
        assert_fused_optimizer(label, opt, TRAIN_STEPS * len(algo.optimizers()))
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{label}: non-finite step log {log}")
        lr = algo.policy_optimizer.optimizer.param_groups[0]["lr"]
        assert lr > 0, "the policy's learning rate is still 0"
        used = int((tok.ema_cluster_size > 0).sum()) if ema else None
        if ema and not (used > 0 and bool(tok.ema_embed_sum.abs().sum() > 0)):
            raise AssertionError("the EMA buffers are still zero")

        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=10)
        busy_ms, kernels = profile_device(lambda: algo.train_on_batch(batch, 1), 5)
        idle = None if busy_ms is None else 1.0 - busy_ms / step_ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        print(f"{label}: {TRAIN_STEPS} steps of batch {BATCH}, K1 launched {k1} and K2 "
              f"{k2} times, the optimizer's kernels {opt['launches']} times over "
              f"{opt['fused_steps']} optimizer steps; Loss {log['Loss']:.4f}, "
              f"VQ_Loss {log['VQ_Loss']:.4f}, "
              f"grad norm {log['Policy_Grad_Norms']:.4f}, policy lr {lr:.3g}"
              + (f", {used} codes with EMA mass" if ema else "") + "; "
              f"Time_* minutes { {k: v for k, v in log.items() if k.startswith('Time_')} }")
        print(f"{label} step: {step_ms:.3f} ms median of 10; device busy {busy_ms} ms "
              f"per step, idle share {idle}; {len(kernels)} distinct device ops, top "
              f"{top} [{card}]")
        results[label] = {"k1_launches": k1, "k1f_launches": k1f, "k2_launches": k2,
                          "optimizer": opt, "log": log,
                          "step_ms": step_ms, "device_busy_ms": busy_ms, "idle_share": idle,
                          "top_ops_ms": dict(top), "ema_codes_used": used}
        del algo, tok, batch
        torch.cuda.empty_cache()
    results["parity"] = train_parity(items)
    results["ema_wide"] = ema_wide_step(card)
    return results


def ema_wide_step(card: str) -> dict:
    """One EMA-codebook train step of ``LipVQVAE`` on the card at 65536
    codes (latent 208), above one shared histogram of K2's row sort: the
    training forward (one K2 launch, no K1), Adam on its loss, the EMA
    codebook written back. The stats K2 returned are observed on the way:
    their counts must sum to the rows; losses, EMA buffers and codebook
    finite."""
    import lipvq_tpu_torch.models.tokenizers.lipvq as lipvq
    from lipvq_tpu_torch.models.base_nets import seeded_init

    latent, rows = CORPUS_SHAPE[2], EMA_WIDE_ROWS
    model = lipvq.LipVQVAE(AC_DIM, latent, num_codes=EMA_WIDE_CODES, ema_codebook=True)
    seeded_init(model, torch.Generator().manual_seed(16))
    rng = np.random.default_rng(17)
    with torch.no_grad():
        # spread the latents and set the codes to latents of seeded actions
        model.to_latent.ci.fill_(30.0)
        model.quantizer.codebook.copy_(model.encode(torch.from_numpy(
            rng.uniform(-1, 1, (EMA_WIDE_CODES, AC_DIM)).astype(np.float32))))
    dev = torch.device("cuda")
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    x = torch.from_numpy(rng.uniform(-1, 1, (rows, AC_DIM)).astype(np.float32)).to(dev)

    seen = {}
    stats = lipvq.vq_nearest_with_stats

    def observed(z_e, codebook):
        seen["stats"] = stats(z_e, codebook)
        return seen["stats"]

    lipvq.vq_nearest_with_stats = observed
    try:
        # the main path: one EMA train step, counted
        zero_launch_counts()
        t0 = time.perf_counter()
        _, loss, ids = model(x, train=True)
        opt.zero_grad()
        loss.backward()
        opt.step()
        model.apply_ema_codebook()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
    finally:
        lipvq.vq_nearest_with_stats = stats
    _, counts, _ = seen["stats"]
    if launches != (0, 0, 1):
        raise AssertionError(f"EMA step at {EMA_WIDE_CODES} codes: launches (K1, K1f, K2) "
                             f"{launches}, want (0, 0, 1)")
    if float(counts.sum()) != rows or not torch.equal(
            counts, torch.bincount(ids.long(), minlength=EMA_WIDE_CODES).float()):
        raise AssertionError(f"EMA step at {EMA_WIDE_CODES} codes: counts sum to "
                             f"{float(counts.sum())} for {rows} rows")
    finite = all(bool(torch.isfinite(t).all()) for t in (
        loss, model.ema_cluster_size, model.ema_embed_sum, model.quantizer.codebook))
    if not finite:
        raise AssertionError(f"EMA step at {EMA_WIDE_CODES} codes: non-finite loss or state")
    used, top, loss = int((counts > 0).sum()), int(ids.max()), loss.detach()
    print(f"train_ema at {EMA_WIDE_CODES} codes: one LipVQVAE step of {rows} rows (latent "
          f"{latent}), launches (K1, K1f, K2) {launches}; loss {float(loss):.5f}; counts sum "
          f"to {int(counts.sum())} over {used} codes (highest id {top}); {step_ms:.1f} ms "
          f"(first call) [{card}]")
    return {"launches": launches, "loss": float(loss), "codes_used": used, "max_id": top,
            "step_ms": step_ms}


LOOSE_FROBENIUS = 2e-2  # hold_step's limit on a visual core's gradient, card against CPU


def capture_grads(algo, handles: list | None = None) -> dict:
    """{parameter name: grad}, filled with the grads each of ``algo``'s
    optimizer steps receives as it runs; the hooks' handles go into
    ``handles`` where one is given (for their removal)."""
    names = {id(p): n for n, p in algo.nets.named_parameters()}
    grads = {}

    def hook(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                grads[names[id(p)]] = p.grad.detach().cpu().clone()

    for o in algo.optimizers().values():
        handle = o.optimizer.register_step_pre_hook(hook)
        if handles is not None:
            handles.append(handle)
    return grads


def adam_states(algo) -> dict:
    """{parameter name: (lr, weight decay, eps, betas, decoupled, exp_avg,
    exp_avg_sq, step)} of each parameter's optimizer before a step, on the
    CPU (the moments None before the optimizer's first step)."""
    names = {id(p): n for n, p in algo.nets.named_parameters()}
    out = {}
    for o in algo.optimizers().values():
        g = o.optimizer.param_groups[0]
        for p in o.params:
            st = o.optimizer.state.get(p) or {}
            moments = ((st["exp_avg"].cpu().clone(), st["exp_avg_sq"].cpu().clone(),
                        int(st["step"])) if st else (None, None, 0))
            out[names[id(p)]] = (g["lr"], g["weight_decay"], g["eps"], g["betas"],
                                 isinstance(o.optimizer, torch.optim.AdamW), *moments)
    return out


def adam_step(p0, g, state) -> torch.Tensor:
    """The parameter after one Adam (L2 into the gradient) or AdamW step of
    gradient ``g`` from ``p0`` and the optimizer ``state`` (``adam_states``)."""
    lr, wd, eps, (b1, b2), decoupled, m0, v0, t0 = state
    if decoupled:
        p0 = p0 * (1 - lr * wd)
    else:
        g = g + wd * p0
    m = (1 - b1) * g if m0 is None else b1 * m0 + (1 - b1) * g
    v = (1 - b2) * g * g if v0 is None else b2 * v0 + (1 - b2) * g * g
    t = t0 + 1
    return p0 - lr / (1 - b1 ** t) * m / (v.sqrt() / math.sqrt(1 - b2 ** t) + eps)


def polyak_pairs(algo) -> dict:
    """{target buffer name: (online parameter name, tau)} of an offline-RL
    algo's target networks, and of those of IRIS's value BCQ."""
    from lipvq_tpu_torch.algo.rl_common import RLAlgo

    out = {}
    parts = algo.parts() if hasattr(algo, "parts") else {"": algo}
    for part_name, part in parts.items():
        if not isinstance(part, RLAlgo):
            continue
        pre = f"{part_name}." if part_name else ""
        for net in part.TARGETS:
            for key, _ in getattr(part.nets, net).named_parameters():
                out[f"{pre}target.{net}.{key}"] = (f"{pre}{net}.{key}", part.tau)
    return out


def assert_allclose(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
                    err_msg: str) -> None:
    """``np.testing.assert_allclose`` on CPU tensors: its test (|got - want| <=
    atol + rtol |want|, NaNs equal) runs first in torch's threads, and numpy
    checks and reports where that test fails."""
    if got.is_floating_point() and got.dtype == want.dtype:
        fast = bool(torch.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True).all())
    else:
        fast = torch.equal(got, want)
    if not fast:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol,
                                   err_msg=err_msg)


def rel_frobenius(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def hold_step(card, cpu, batch, keep=None, zero=(), loose=(), draws=None,
              targets=None) -> tuple[dict, dict]:
    """One fp32 train step of ``card`` and ``cpu`` (the same weights and
    optimizer states) on ``batch`` (with the same random ``draws`` where the
    algo takes them), held as follows.

    Adam's first step moves an element by lr * g / (|g| + 1e-8): where |g| is
    near that eps, the last digits of g, which differ between the two
    devices' reduction orders, decide much of the step, so the parameters of
    the two devices are not compared directly. The check holds instead
    (1) the losses to rtol 1e-4; (2) each gradient the optimizers receive,
    card against CPU, to rtol 1e-3 + atol 1e-4 * the tensor's largest |g|,
    except the parameters named in ``zero``, whose gradient is 0 in exact
    arithmetic (the key bias of attention, to which the softmax is
    invariant): they hold only rounding noise, which differs between the
    devices, and are held below 1e-6 of the step's largest |g| on both; (3) on
    each device, every parameter to its optimizer's step of its own gradient
    from the moments it held before (the first step: p0 (1 - lr wd) - lr g /
    (|g| + eps) for AdamW, p0 - lr g' / (|g'| + eps), g' = g + wd p0, for
    Adam with L2), at the learning rate of the step, to atol 1e-3 lr + rtol
    1e-6, but for the elements ``keep(cpu)`` ({name: mask}) excludes; a
    parameter whose optimizer did not step (TD3-BC's actor between its
    updates, BCQ's perturbation when it is off) must be unchanged, bit for
    bit, on both; (4) every buffer, card against CPU, to rtol 1e-5 / atol
    1e-7, but the target networks ``targets`` ({buffer: (parameter, tau)},
    ``polyak_pairs``): each, on each device, to (1 - tau) t0 + tau p of that
    device's own new parameter (rtol 1e-6 / atol 1e-7), and card against
    CPU within tau times its parameter's card-vs-CPU difference (+ 1e-6
    |t| + 1e-7). The gradients of
    parameters whose name holds one of ``loose`` (the visual cores) pass
    back through BatchNorms that renormalize by batch statistics, which
    cancels most of the terms of some elements, so the two devices' fp32
    rounding moves such an element by a few 1e-2 of the tensor's largest
    |g|: each of those gradients is held as a whole instead, card against
    CPU, to a relative Frobenius error of LOOSE_FROBENIUS (2e-2; a trunk
    with TF32 convolutions misses it: ``ema_parity_step``'s control), and
    their buffers (the
    BatchNorm statistics, reductions over ~1e5 values per channel) to rtol
    1e-5 / atol 2e-6. Returns (the card's losses, the worst errors)."""
    targets = targets or {}
    start = {"card": {n: p.detach().cpu().clone() for n, p in card.nets.named_parameters()},
             "cpu": {n: p.detach().clone() for n, p in cpu.nets.named_parameters()}}
    before = {"card": {n: b.cpu().clone() for n, b in card.nets.named_buffers() if n in targets},
              "cpu": {n: b.clone() for n, b in cpu.nets.named_buffers() if n in targets}}
    states = {"card": adam_states(card), "cpu": adam_states(cpu)}
    handles = []
    grads = {"card": capture_grads(card, handles), "cpu": capture_grads(cpu, handles)}
    kwargs = {} if draws is None else {"draws": draws}
    try:
        got = card.train_on_batch(batch, 1, **kwargs)["losses"]
        want = cpu.train_on_batch(batch, 1, **kwargs)["losses"]
    finally:
        for handle in handles:
            handle.remove()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)

    masks = keep(cpu) if keep is not None else {}
    worst = {"grad_err_over_max": 0.0, "zero_grads_over_max": 0.0, "step_err_in_lr": 0.0,
             "card_vs_cpu_in_lr": 0.0, "buffers": 0.0}
    if loose:
        worst.update(loose_grad_err_over_max=0.0, loose_grad_frobenius=0.0, loose_buffers=0.0)
    if targets:
        worst.update(target_step_err=0.0, target_card_vs_cpu=0.0)
    top = max(float(g.abs().max()) for g in grads["cpu"].values())
    after = {"card": {n: p.detach().cpu() for n, p in card.nets.named_parameters()},
             "cpu": {n: q.detach() for n, q in cpu.nets.named_parameters()}}
    for name in start["cpu"]:
        if name not in grads["cpu"]:
            if name in grads["card"] or not all(torch.equal(after[d][name], start[d][name])
                                                for d in ("card", "cpu")):
                raise AssertionError(f"{name}: its optimizer did not step, yet it moved")
            continue
        g_card, g_cpu = grads["card"][name], grads["cpu"][name]
        scale = float(g_cpu.abs().max())
        if name in zero:
            largest = max(scale, float(g_card.abs().max()))
            if largest >= 1e-6 * top:
                raise AssertionError(f"the gradient of {name} should be 0, is {largest}")
            worst["zero_grads_over_max"] = max(worst["zero_grads_over_max"], largest / top)
        elif any(k in name for k in loose):
            fro = rel_frobenius(g_card, g_cpu)
            if fro > LOOSE_FROBENIUS:
                raise AssertionError(f"grad of {name}: relative Frobenius error {fro}")
            worst["loose_grad_frobenius"] = max(worst["loose_grad_frobenius"], fro)
            worst["loose_grad_err_over_max"] = max(
                worst["loose_grad_err_over_max"],
                float((g_card - g_cpu).abs().max()) / max(scale, 1e-30))
        else:
            assert_allclose(g_card, g_cpu, rtol=1e-3, atol=1e-4 * scale,
                            err_msg=f"grad of {name}")
            worst["grad_err_over_max"] = max(
                worst["grad_err_over_max"],
                float((g_card - g_cpu).abs().max()) / max(scale, 1e-30))
        lr = states["cpu"][name][0]
        mask = masks.get(name)
        for device, g in (("card", g_card), ("cpu", g_cpu)):
            now, adam = after[device][name], adam_step(start[device][name], g,
                                                       states[device][name])
            if mask is not None:
                now, adam = now[mask], adam[mask]
            assert_allclose(now, adam, rtol=1e-6, atol=1e-3 * lr,
                            err_msg=f"Adam step of {name}")
            worst["step_err_in_lr"] = max(worst["step_err_in_lr"],
                                          float((now - adam).abs().max()) / lr)
        worst["card_vs_cpu_in_lr"] = max(
            worst["card_vs_cpu_in_lr"],
            float((after["card"][name] - after["cpu"][name]).abs().max()) / lr)
    for (name, b), (_, c) in zip(card.nets.named_buffers(), cpu.nets.named_buffers()):
        if name in targets:
            param, tau = targets[name]
            for device, now in (("card", b.cpu()), ("cpu", c)):
                want_t = before[device][name] * (1 - tau) + after[device][param] * tau
                assert_allclose(now, want_t, rtol=1e-6, atol=1e-7,
                                err_msg=f"the target {name} on the {device}")
                worst["target_step_err"] = max(worst["target_step_err"],
                                               float((now - want_t).abs().max()))
            diff = (b.cpu() - c).abs()
            allowed = tau * (after["card"][param] - after["cpu"][param]).abs() + \
                1e-6 * c.abs() + 1e-7
            if not bool((diff <= allowed).all()):
                raise AssertionError(f"the target {name}: card against CPU {float(diff.max())}")
            worst["target_card_vs_cpu"] = max(worst["target_card_vs_cpu"], float(diff.max()))
            continue
        is_loose = any(k in name for k in loose)
        assert_allclose(b.cpu(), c, rtol=1e-5, atol=2e-6 if is_loose else 1e-7, err_msg=name)
        key = "loose_buffers" if is_loose else "buffers"
        worst[key] = max(worst[key], float((b.cpu().double() - c.double()).abs().max()))
    return {k: float(v) for k, v in got.items()}, worst


def train_parity(items) -> dict:
    """One fp32 step without dropout, EMA codebook on, from the same weights
    on the card and on the CPU (warmup 0, so both optimizers move), held by
    ``ema_parity_step``."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader

    def make(device=None):
        return algo_factory("icl", icl_config("float32", {"ema": True, "dropout": 0.0,
                                                          "warmup": 0}),
                            OBS_SHAPES, ac_dim=AC_DIM, device=device)

    card, cpu = make(), make("cpu")
    batch = card.process_batch_for_training(next(iter(DataLoader(items, BATCH, seed=7))))
    return ema_parity_step(card, cpu, batch, "train parity")


def ema_parity_step(card, cpu, batch, label: str, zero=(), loose=(), control=None) -> dict:
    """One fp32 EMA-codebook step of ``card`` and ``cpu`` (the same weights)
    on ``batch``, held by ``hold_step`` (``zero`` and ``loose`` passed on);
    the codebook rows the EMA wrote are held, card against CPU, to rtol
    1e-5 / atol 1e-7 in place of the AdamW rule.

    ``control``, a third algo on the card with the same weights, is
    prepared as ``card`` is and takes the same step first, its convolutions
    in TF32 (``tf32_convolutions``): the ``loose`` gradients' relative
    Frobenius error against the CPU's must exceed LOOSE_FROBENIUS there (the
    limit tells a TF32 trunk from an fp32 one), and its convolutions must
    have run kernels named TF32 (the name check of ``assert_fp32_convs``
    sees them)."""
    half = next(iter(batch["obs"].values())).shape[0] // 2
    ctx_act = batch["actions"][:half].reshape(-1, AC_DIM)
    # At the init's Lipschitz bound (softplus(1) per latent unit) every
    # latent lies within ~1e-3 of sigmoid(0) = 0.5 in squared distance, so
    # fp32 rounding of ||c||^2 - 2 z.c (||z||^2 ~ 198) decides the nearest
    # code. A bound of ~30 spreads the latents. The latents of the context
    # actions moved by N(0, 0.02) are codes as well: each context latent
    # then lies ~0.002 from its code and >= 0.16 further from any other
    # code, far above that rounding, and the commitment loss still sends a
    # gradient into the encoder (from exact codes it would be 0).
    tok = cpu.nets.net.encoder.action_network
    algos = (card, cpu) if control is None else (card, cpu, control)
    with torch.no_grad():
        for a in algos:
            a.nets.net.encoder.action_network.to_latent.ci.fill_(30.0)
    rng = np.random.default_rng(6)
    near = ctx_act + rng.normal(0.0, 0.02, ctx_act.shape).astype(np.float32)
    set_codebook(tok, algos, rng, near)
    card_ids = card.nets.net.encoder.action_network.tokenize(
        torch.from_numpy(ctx_act).cuda()).cpu()
    cpu_ids = cpu.nets.net.encoder.action_network.tokenize(torch.from_numpy(ctx_act))
    if not torch.equal(card_ids, cpu_ids):
        raise AssertionError(f"{label}: {int((card_ids != cpu_ids).sum())} context tokens "
                             f"differ between the card and the CPU")
    codebook = "net.encoder.action_network.quantizer.codebook"

    def untouched(algo):
        touched = algo.nets.net.encoder.action_network.ema_cluster_size > 0
        return {codebook: ~touched[:, None].expand_as(algo.nets.get_parameter(codebook))}

    checked = {}
    if control is not None:
        want, got = capture_grads(cpu), capture_grads(control)
        with tf32_convolutions():
            _, _, convs, names = profile_convs(lambda: control.train_on_batch(batch, 1), 1,
                                               warmup=False)
    losses, worst = hold_step(card, cpu, batch, keep=untouched, zero=zero, loose=loose)
    if control is not None:
        fro = max(rel_frobenius(got[n], want[n]) for n in want if any(k in n for k in loose))
        tf32 = [n for n in names if "tf32" in n.lower()]
        print(f"{label} control: the same step with TF32 convolutions misses the CPU's by a "
              f"relative Frobenius error of {fro:.4g} (the held step's worst "
              f"{worst['loose_grad_frobenius']:.4g}, limit {LOOSE_FROBENIUS}); {len(tf32)} of "
              f"its {len(names)} conv kernels are named TF32, e.g. {tf32[:2]}")
        if fro <= LOOSE_FROBENIUS or not tf32:
            raise AssertionError(f"{label} control: a TF32 trunk passes the check (relative "
                                 f"Frobenius {fro}, TF32 kernels {tf32}, all {names})")
        checked = {"control_tf32_loose_grad_frobenius": fro,
                   "control_tf32_conv_kernels": len(tf32),
                   "control_conv_ms": sum(convs.values())}
    touched = ~untouched(cpu)[codebook][:, 0]
    np.testing.assert_allclose(card.nets.get_parameter(codebook)[touched.cuda()].detach()
                               .cpu().numpy(),
                               cpu.nets.get_parameter(codebook)[touched].detach().numpy(),
                               rtol=1e-5, atol=1e-7, err_msg="the codebook rows the EMA wrote")
    assert int(touched.sum()) > 0
    print(f"{label}: one fp32 step on the card == the CPU step; losses within rtol "
          f"1e-4 ({losses}); context ids equal; {int(touched.sum())} codebook rows written "
          f"by the EMA; worst {worst} (gradient error over the tensor's max |g|; error "
          f"against the AdamW step of each device's own gradient, and card against CPU, in "
          f"units of lr; buffers, card against CPU)")
    return {"losses": losses, "worst": worst, **checked}


ARMS = (("icl", "bin"), ("icl", "ln_act"), ("icl", "raw"), ("icl_mamba", "ln_act"),
        ("icl_mamba", "vq"))
ARM_REQUESTS, ARM_STEPS = 8, 10


def arms_phase(card: str) -> dict:
    """The other arms of the tokenizer ablation at full width (6 layers x
    512, the flagship's obs, latent 791, batch 100): bin, ln_act and raw on
    the GPT backbone, ln_act and LipVQ on icl_mamba. Each is built on the
    card, serves 8 requests of 16 envs and takes 10 train steps (launches
    counted: K1 once per request and step for LipVQ, never for the others;
    K1f and K2 never; the scan and the mixer's conv only where a Mamba
    block runs, every mixer forward fused); its fp32 forward on the card is held against the CPU
    (rtol 1e-3 / atol 1e-4, as the served flagship's); one fp32 step of the
    bin and the raw arm is held against the CPU step by ``hold_step`` (the
    running bounds, step count and spectral-norm vectors among the buffers)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    items = SequenceItems(2 * BATCH, seed=14)
    results = {}
    for algo_name, arm in ARMS:
        label = f"{algo_name}/{arm}"
        rng = np.random.default_rng(15)
        algo = algo_factory(algo_name, icl_config(
            train={"ema": False, "dropout": 0.1, "warmup": 10}, algo=algo_name, arm=arm),
            OBS_SHAPES, ac_dim=AC_DIM)  # CUDA by default
        algo32 = algo_factory(algo_name, icl_config("float32", algo=algo_name, arm=arm),
                              OBS_SHAPES, ac_dim=AC_DIM)
        algo_cpu = algo_factory(algo_name, icl_config("float32", algo=algo_name, arm=arm),
                                OBS_SHAPES, ac_dim=AC_DIM, device="cpu")
        net = algo.nets.net
        assert algo.device.type == "cuda" and net.embed_dim == 512
        assert type(net.transformer).__name__ == (
            "MambaBackbone" if algo_name == "icl_mamba" else "GPTBackbone")
        t = algo.context_length
        context = {"obs": random_obs(rng, (1, t)),
                   "actions": rng.uniform(-1, 1, (1, t, AC_DIM)).astype(np.float32)}
        if arm == "vq":
            set_codebook(algo_cpu.nets.net.encoder.action_network, (algo, algo32, algo_cpu),
                         rng, context["actions"][0])
        requests = [random_obs(rng, (N_ENVS, t)) for _ in range(ARM_REQUESTS)]
        policy = ICLRolloutPolicy(algo)

        # the main path: 8 served requests, then 10 train steps, each counted
        zero_launch_counts()
        scan0 = scan_counts()
        served = [policy.batched(o, context) for o in requests]
        serve_counts, serve_mixer = launch_counts(), mixer_counts()
        scan1 = scan_counts()
        loader = DataLoader(items, BATCH, seed=5)
        zero_launch_counts()
        log = run_epoch(algo, loader, epoch=1, num_steps=ARM_STEPS)
        train_counts, train_mixer = launch_counts(), mixer_counts()
        scan2 = scan_counts()
        k1 = arm == "vq"
        if serve_counts != (ARM_REQUESTS * k1, 0, 0) or train_counts != (ARM_STEPS * k1, 0, 0):
            raise AssertionError(f"{label}: launches (K1, K1f, K2) {serve_counts} serving "
                                 f"{ARM_REQUESTS} requests, {train_counts} in {ARM_STEPS} steps")
        scans = (scan1[0] - scan0[0], scan2[0] - scan1[0])
        mamba_block = algo_name == "icl_mamba" or arm == "ln_act"
        if (min(scans) > 0) != mamba_block or (max(scans) > 0) != mamba_block:
            raise AssertionError(f"{label}: scan launches {scans} serving and training")
        # (conv calls, fused, composed forwards): every forward fused, one
        # conv call each, and one more a backward while training
        (sc, sf, sp), (tc, tf, tp) = serve_mixer, train_mixer
        if mamba_block != (sf > 0 and tf > 0) or sp or tp or sc != sf or not tf <= tc <= 2 * tf:
            raise AssertionError(f"{label}: mixer counts (conv calls, fused, composed) "
                                 f"{serve_mixer} serving and {train_mixer} training")
        if not all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all() for a in served):
            raise AssertionError(f"{label}: served actions not finite of shape (16, 12)")
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{label}: non-finite step log {log}")
        tok = net.encoder.action_network
        if arm == "bin" and int(tok.num_step) != ARM_STEPS:
            raise AssertionError(f"{label}: the bin bounds advanced {int(tok.num_step)} times")

        # fp32 on the card against the CPU, the last request's inputs
        ctx = {"obs": {k: np.repeat(v, N_ENVS, 0) for k, v in context["obs"].items()},
               "actions": np.repeat(context["actions"], N_ENVS, 0)}
        outs = []
        with torch.inference_mode():
            for a in (algo32, algo_cpu):
                inputs = (a._put_infer(x) for x in (requests[-1], ctx["obs"], ctx["actions"]))
                outs.append([x.float().cpu().numpy() for x in a.nets.forward_train(
                    *inputs, low_noise_eval=False)[0]])
        for field, got, want in zip(("means", "scales", "logits"), *outs):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                       err_msg=f"{label} fp32 {field}")
        fwd_err = max(float(np.abs(g - w).max()) for g, w in zip(*outs))

        request_ms = host_ms(lambda: policy.batched(requests[0], context), reps=10)
        request_busy, _ = profile_device(lambda: policy.batched(requests[0], context), 5)
        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=5)
        step_busy, kernels = profile_device(lambda: algo.train_on_batch(batch, 1), 3)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
        results[label] = {
            "serve_launches": serve_counts, "train_launches": train_counts, "log": log,
            "scan_launches": scans, "mixer_counts": {"serve": serve_mixer, "train": train_mixer},
            "fp32_forward_max_abs_err": fwd_err, "request_ms": request_ms,
            "request_busy_ms": request_busy,
            "request_idle_share": None if request_busy is None else 1 - request_busy / request_ms,
            "step_ms": step_ms, "step_busy_ms": step_busy,
            "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
            "step_top_ops_ms": top}
        r = results[label]
        print(f"arm {label}: {ARM_REQUESTS} requests of {N_ENVS} envs and {ARM_STEPS} steps of "
              f"batch {BATCH}, launches (K1, K1f, K2) {serve_counts} / {train_counts}, of the "
              f"scan {scans[0]} / {scans[1]}, mixer (conv calls, fused, composed) "
              f"{serve_mixer} / {train_mixer}; Loss "
              f"{log['Loss']:.4f}; fp32 card == CPU within rtol 1e-3 / atol 1e-4 (max abs "
              f"{fwd_err:.3g}); request {request_ms:.3f} ms (device busy {request_busy} ms, "
              f"idle share {r['request_idle_share']}), step {step_ms:.3f} ms (device busy "
              f"{step_busy} ms, idle share {r['step_idle_share']}), top {top} [{card}]")

        if arm in ("bin", "raw"):
            def make(device=None, algo_name=algo_name, arm=arm):
                return algo_factory(algo_name, icl_config(
                    "float32", {"ema": False, "dropout": 0.0, "warmup": 0}, algo=algo_name,
                    arm=arm), OBS_SHAPES, ac_dim=AC_DIM, device=device)

            card_algo, cpu_algo = make(), make("cpu")
            pbatch = card_algo.process_batch_for_training(
                next(iter(DataLoader(items, BATCH, seed=7))))
            key_biases = [n for n, _ in cpu_algo.nets.named_parameters()
                          if ".action_network.attn_" in n and n.endswith(".key.bias")]
            assert len(key_biases) == (4 if arm == "raw" else 0), key_biases
            losses, worst = hold_step(card_algo, cpu_algo, pbatch, zero=key_biases)
            r["train_parity"] = {"losses": losses, "worst": worst}
            print(f"arm {label} train parity: one fp32 step on the card == the CPU step "
                  f"(hold_step: losses rtol 1e-4, gradients, each device's AdamW step, "
                  f"buffers rtol 1e-5 / atol 1e-7); losses {losses}; worst {worst}")
            del card_algo, cpu_algo
        del algo, algo32, algo_cpu, policy, net, tok, batch
        torch.cuda.empty_cache()
    results["icl/fast"] = fast_arm(card, items)
    return results


def fast_arm(card: str, items) -> dict:
    """The FAST arm at full width: the context actions' DCT + BPE token
    strings, embedded by the hash LangEncoder, reach the GPT as 512-wide
    host features. A user trains before serving (the fit refits on each of
    the first 8 batches and then freezes), so the arm takes its 10 train
    steps first, then serves 8 requests of 16 envs with a context processed
    by ``process_batch_for_training`` (its ``ctx_act_feat`` kept on the
    card); no kernel launches. Printed: the host time of the feature
    pipeline per step, the refitting and the frozen steps apart; the step
    time; the request time with the processed context and with a raw one,
    whose features ``get_action`` recomputes on every request. The fp32
    forward on the card is held against the CPU on the same features, and
    one fp32 step by ``hold_step`` on a batch the trained (frozen)
    tokenizer processed."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.models.obs_nets import FAST_FEAT_DIM
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    label = "icl/fast"
    algo = algo_factory("icl", icl_config(train={"ema": False, "dropout": 0.1, "warmup": 10},
                                          arm="fast"), OBS_SHAPES, ac_dim=AC_DIM)
    net = algo.nets.net
    assert algo.device.type == "cuda" and algo.fast_enabled and net.encoder.arm == "fast"
    assert net.embed_dim == 512 and net.transformer.num_layers == 6
    assert net.encoder.fast_proj_0.weight.shape == (64, FAST_FEAT_DIM)
    assert net.encoder.output_dim == sum(s[0] for s in OBS_SHAPES.values()) == 791

    # the host feature pipeline, timed per call: (ms, refit in that call)
    pipeline = []
    features = algo._fast_features

    def timed(actions):
        refit = not algo._fast_frozen
        t0 = time.perf_counter()
        out = features(actions)
        pipeline.append(((time.perf_counter() - t0) * 1e3, refit))
        return out

    algo._fast_features = timed
    loader = DataLoader(items, BATCH, seed=5)
    rng = np.random.default_rng(15)
    t = algo.context_length
    context_item = SequenceItems(1, seed=18).items[0]
    requests = [random_obs(rng, (N_ENVS, t)) for _ in range(ARM_REQUESTS)]
    policy = ICLRolloutPolicy(algo)

    # the main path: 10 train steps, then 8 served requests, each counted
    zero_launch_counts()
    t0 = time.perf_counter()
    log = run_epoch(algo, loader, epoch=1, num_steps=ARM_STEPS)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    train_counts = launch_counts()
    steps_pipeline = list(pipeline)
    context = algo.process_batch_for_training(stack_collate([context_item]))
    zero_launch_counts()
    served = [policy.batched(o, context) for o in requests]
    serve_counts = launch_counts()
    if serve_counts != (0, 0, 0) or train_counts != (0, 0, 0):
        raise AssertionError(f"{label}: launches (K1, K1f, K2) {serve_counts} serving "
                             f"{ARM_REQUESTS} requests, {train_counts} in {ARM_STEPS} steps")
    refits = [ms for ms, refit in steps_pipeline if refit]
    frozen = [ms for ms, refit in steps_pipeline if not refit]
    if len(steps_pipeline) != ARM_STEPS or len(refits) != 8 or not algo._fast_frozen:
        raise AssertionError(f"{label}: {len(steps_pipeline)} feature computations in "
                             f"{ARM_STEPS} steps, {len(refits)} refits, frozen "
                             f"{algo._fast_frozen}; want 10, 8, True")
    if len(pipeline) != ARM_STEPS + 1:  # + the context: requests reuse its features
        raise AssertionError(f"{label}: the served requests recomputed the features")
    if not all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all() for a in served):
        raise AssertionError(f"{label}: served actions not finite of shape (16, 12)")
    if not all(np.isfinite(v) for v in log.values()):
        raise AssertionError(f"{label}: non-finite step log {log}")
    feat = context["ctx_act_feat"]
    if feat.shape != (1, t, FAST_FEAT_DIM) or feat.dtype != np.float32:
        raise AssertionError(f"{label}: context features {feat.shape} {feat.dtype}")

    # fp32 on the card against the CPU, the same weights and features
    algo32 = algo_factory("icl", icl_config("float32", arm="fast"), OBS_SHAPES, ac_dim=AC_DIM)
    algo_cpu = algo_factory("icl", icl_config("float32", arm="fast"), OBS_SHAPES,
                            ac_dim=AC_DIM, device="cpu")
    inputs = (requests[-1], {k: np.repeat(v, N_ENVS, 0) for k, v in context["obs"].items()},
              np.repeat(feat, N_ENVS, 0))
    outs = []
    with torch.inference_mode():
        for a in (algo32, algo_cpu):
            outs.append([x.float().cpu().numpy() for x in a.nets.forward_train(
                *(a._put_infer(x) for x in inputs), low_noise_eval=False)[0]])
    for field, got, want in zip(("means", "scales", "logits"), *outs):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=f"{label} fp32 {field}")
    fwd_err = max(float(np.abs(g - w).max()) for g, w in zip(*outs))
    del algo32, algo_cpu

    raw_context = {"obs": context["obs"], "actions": context["actions"]}
    request_ms = host_ms(lambda: policy.batched(requests[0], context), reps=10)
    raw_request_ms = host_ms(lambda: policy.batched(requests[0], raw_context), reps=10)
    raw_pipeline = [ms for ms, _ in pipeline[ARM_STEPS + 1:]]
    request_busy, _ = profile_device(lambda: policy.batched(requests[0], context), 5)
    batch = algo.process_batch_for_training(next(iter(loader)))

    def step():
        algo.train_on_batch(batch, 1)
        torch.cuda.synchronize()

    step_ms = host_ms(step, reps=5)
    step_busy, kernels = profile_device(lambda: algo.train_on_batch(batch, 1), 3)
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
    per_step = {k: v * 60e3 / ARM_STEPS for k, v in log.items() if k.startswith("Time_")}

    def make(device=None):
        return algo_factory("icl", icl_config("float32", {"ema": False, "dropout": 0.0,
                                                          "warmup": 0}, arm="fast"),
                            OBS_SHAPES, ac_dim=AC_DIM, device=device)

    card_algo, cpu_algo = make(), make("cpu")
    pbatch = algo.process_batch_for_training(next(iter(DataLoader(items, BATCH, seed=7))))
    losses, worst = hold_step(card_algo, cpu_algo, pbatch)
    del card_algo, cpu_algo
    r = {"serve_launches": serve_counts, "train_launches": train_counts, "log": log,
         "fp32_forward_max_abs_err": fwd_err, "request_ms": request_ms,
         "raw_context_request_ms": raw_request_ms,
         "raw_context_pipeline_ms": statistics.median(raw_pipeline),
         "request_busy_ms": request_busy,
         "request_idle_share": None if request_busy is None else 1 - request_busy / request_ms,
         "step_ms": step_ms, "step_busy_ms": step_busy,
         "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
         "step_top_ops_ms": top, "pipeline_refit_ms": refits, "pipeline_frozen_ms": frozen,
         "epoch_s": epoch_s, "time_ms_per_step": per_step,
         "vocab_size": int(algo._fast_tok.bpe.vocab_size),
         "train_parity": {"losses": losses, "worst": worst}}
    print(f"arm {label}: {ARM_STEPS} steps of batch {BATCH}, then {ARM_REQUESTS} requests of "
          f"{N_ENVS} envs, launches (K1, K1f, K2) {train_counts} / {serve_counts}; Loss "
          f"{log['Loss']:.4f}; BPE vocabulary {r['vocab_size']}; fp32 card == CPU within rtol "
          f"1e-3 / atol 1e-4 (max abs {fwd_err:.3g}); step {step_ms:.3f} ms (device busy "
          f"{step_busy} ms, idle share {r['step_idle_share']}), top {top} [{card}]")
    print(f"arm {label} host feature pipeline per step (ms): refitting steps "
          f"{[round(x, 1) for x in refits]}, frozen steps {[round(x, 2) for x in frozen]}; "
          f"the epoch of {ARM_STEPS} steps {epoch_s:.1f} s, Time_* per step "
          f"{ {k: round(v, 2) for k, v in per_step.items()} } ms; request {request_ms:.3f} ms "
          f"with the processed context (device busy {request_busy} ms, idle share "
          f"{r['request_idle_share']}), {raw_request_ms:.3f} ms with a raw context (its "
          f"pipeline {r['raw_context_pipeline_ms']:.3f} ms per request) [{card}]")
    print(f"arm {label} train parity: one fp32 step on the card == the CPU step (hold_step); "
          f"losses {losses}; worst {worst}")
    del algo, policy, net, batch, pbatch
    torch.cuda.empty_cache()
    return r


CORPUS_DEMOS, CORPUS_DEMO_LEN = 1024, 1024  # 2^20 action rows of 12
CORPUS_CHUNK = 1 << 16  # tokenize_array's default chunk: one lookup per chunk


def write_corpus_export(tmp: str) -> tuple[str, np.ndarray, float]:
    """A seeded export of 2^20 action rows (1024 demos x 1024 steps of
    smooth trajectories) under ``tmp``: (its root, the actions [demos,
    steps, 12], seconds to write)."""
    from lipvq_tpu_torch.data.export import ExportWriter

    rows = CORPUS_DEMOS * CORPUS_DEMO_LEN
    assert rows == CORPUS_SHAPE[0]
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    t = np.arange(CORPUS_DEMO_LEN, dtype=np.float32)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, (CORPUS_DEMOS, 1, AC_DIM)).astype(np.float32)
    freq = rng.uniform(0.05, 0.2, (CORPUS_DEMOS, 1, AC_DIM)).astype(np.float32)
    actions = (0.8 * np.sin(freq * t + phase)).astype(np.float32)  # smooth trajectories
    writer = ExportWriter(os.path.join(tmp, "corpus"))
    for i in range(CORPUS_DEMOS):
        writer.add_demo(f"demo_{i}", {"num_samples": CORPUS_DEMO_LEN}, {"actions": actions[i]})
    root = writer.finish({"total": rows, "env_args": json.dumps(
        {"env_name": "SyntheticKitchen", "type": 1, "env_kwargs": {}})}, {})
    return root, actions, time.perf_counter() - t0


def corpus_phase(card: str, root: str, actions: np.ndarray, export_s: float) -> dict:
    """scripts/tokenize_corpus on the seeded export of 2^20 action rows at
    ``root`` (``actions``) at full width (latent 208, 1024 codes), the
    tokenizer from a state_dict file: a dry run and a writing run with K1, a
    dry run with K1f; launches counted, the ids held against the plain
    tokenize on the card, the written tokens read back, and K1f's ids
    against K1's."""
    from torch.profiler import ProfilerActivity, profile

    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_fast_reference, vq_nearest_reference
    from lipvq_tpu_torch.parallel.corpus import tokenize_array
    from lipvq_tpu_torch.scripts import tokenize_corpus

    latent, codes = CORPUS_SHAPE[2], CORPUS_SHAPE[1]
    rows = CORPUS_SHAPE[0]
    rng = np.random.default_rng(14)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tokenizer_") as tmp:
        # the tokenizer file: a seeded init with its Lipschitz bound raised
        # to 30 and its codebook set to the latents of seeded actions, so
        # the ids spread over the codes as a trained tokenizer's do
        model = LipVQVAE(AC_DIM, latent, num_codes=codes)
        seeded_init(model, torch.Generator().manual_seed(13))
        with torch.no_grad():
            model.to_latent.ci.fill_(30.0)
            model.quantizer.codebook.copy_(model.encode(torch.from_numpy(
                rng.uniform(-1, 1, (codes, AC_DIM)).astype(np.float32))))
        ckpt = os.path.join(tmp, "tokenizer.pt")
        torch.save(model.state_dict(), ckpt)
        args = ["--datasets", root, "--ckpt", ckpt, "--latent_dim", str(latent),
                "--num_codes", str(codes)]
        want_launches = -(-rows // CORPUS_CHUNK)

        def run(extra):
            """The CLI once, counted: (stats, K1, K1f, K2 launches, printed)."""
            zero_launch_counts()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                stats = tokenize_corpus.main(args + extra)
            counts = launch_counts()
            return stats, counts, out.getvalue()

        # the main path: the CLI, a dry run and a writing run with K1, then a
        # dry run with K1f, each counted
        dry, dry_counts, printed = run(["--dry_run"])
        wrote, wrote_counts, _ = run([])
        fast, fast_counts, _ = run(["--dry_run", "--precision", "fast"])
        if dry_counts != (want_launches, 0, 0) or wrote_counts != (want_launches, 0, 0) or \
                fast_counts != (0, want_launches, 0):
            raise AssertionError(f"corpus: launches (K1, K1f, K2) {dry_counts} dry, "
                                 f"{wrote_counts} writing, {fast_counts} fast; want "
                                 f"{want_launches} per run")
        if not printed.startswith("device: cuda") or json.loads(
                printed[printed.index("{"):]) != dry:
            raise AssertionError(f"corpus CLI printed {printed[:200]!r}")
        for stats in (dry, wrote, fast):
            if (stats["files"], stats["demos"], stats["chunks"]) != (1, CORPUS_DEMOS, rows):
                raise AssertionError(f"corpus stats {stats}")

        # the ids against the plain tokenize on the card, and read back
        dev = torch.device("cuda")
        model.to(dev)
        with torch.inference_mode():
            x = torch.from_numpy(actions.reshape(rows, AC_DIM)).to(dev)
            z = torch.cat([model.encode(xc) for xc in x.split(CORPUS_CHUNK)])
            ids = torch.from_numpy(tokenize_array(model, x.cpu().numpy())).to(dev)
            fast_ids = torch.from_numpy(tokenize_array(model, x.cpu().numpy(),
                                                       precision="fast")).to(dev)
            codebook = model.quantizer.codebook
            # the latents lie in [0, 1]^208 with ||z||^2 ~ 50 and their
            # nearest codes close by, so the expand form's cancellation (K1,
            # as the Pallas kernel) decides some near-ties against the exact
            # difference form of the plain tokenize: held by tie_gap
            mismatches, max_gap, _ = check_near_ties(z, codebook, ids,
                                                     vq_nearest_reference(z, codebook),
                                                     bf16=False)
            fast_exceptions = check_near_ties(z, codebook, fast_ids,
                                              vq_nearest_fast_reference(z, codebook))[0]
        reader = Export(root)
        stored = np.concatenate([reader.load(d, "tokens/lipvq_tokens")
                                 for d in sorted(reader.demos, key=lambda e: int(e[5:]))])
        if not np.array_equal(stored, ids.cpu().numpy()):
            raise AssertionError(f"corpus: {int((stored != ids.cpu().numpy()).sum())} tokens "
                                 f"read back differ from the ids")
        used = int(torch.unique(ids).numel())
        flips = float((fast_ids != ids).float().mean())

        # device busy time and idle share of the tokenization (dry run, K1)
        host = np.ascontiguousarray(actions.reshape(rows, AC_DIM))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tokenize_array(model, host)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, kernels = device_busy(prof)
        idle = None if busy_ms is None else 1.0 - busy_ms / wall_ms
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    print(f"corpus: {rows} action rows in {CORPUS_DEMOS} demos (export written in "
          f"{export_s:.1f} s); tokenize_corpus dry run {dry['chunks_per_sec']:.4g} rows/s "
          f"({dry['seconds'] * 1e3:.1f} ms), writing run {wrote['chunks_per_sec']:.4g} "
          f"rows/s, K1f dry run {fast['chunks_per_sec']:.4g} rows/s; launches (K1, K1f, K2) "
          f"{dry_counts} / {wrote_counts} / {fast_counts} ({want_launches} chunks of "
          f"{CORPUS_CHUNK}); ids vs the plain tokenize on the card: {mismatches} differ, "
          f"all near-ties of the fp32 expand form (max fp64 gap {max_gap:.3g}); {used} codes "
          f"used; the "
          f"tokens read back equal the ids; K1f ids within the near-tie bound of its plain "
          f"version ({fast_exceptions} differ), {flips:.4%} differ from K1's [{card}]")
    print(f"corpus device: tokenize_array of {rows} rows {wall_ms:.2f} ms wall, device busy "
          f"{busy_ms} ms, idle share {idle}; top {top} [{card}]")
    return {"rows": rows, "launches": {"dry": dry_counts, "write": wrote_counts,
                                       "fast": fast_counts},
            "chunks_per_sec": {"dry": dry["chunks_per_sec"], "write": wrote["chunks_per_sec"],
                               "fast": fast["chunks_per_sec"]},
            "seconds": {"dry": dry["seconds"], "write": wrote["seconds"],
                        "fast": fast["seconds"]},
            "mismatches": mismatches, "codes_used": used, "fast_flip_rate": flips,
            "fast_exceptions": fast_exceptions, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": idle, "top_ops_ms": top,
            "export_s": export_s}


# scripts/tokenizer_sweep.py's defaults: 256 / 1024 / 4096 codes, latent 64,
# batch 512, 300 steps per setting
SWEEP_STEPS, SWEEP_CODES, SWEEP_LATENT, SWEEP_BATCH = 300, (256, 1024, 4096), 64, 512
VQVAE_ROWS, TOKENIZER_LATENT = 500, 791  # 50 context windows of 10, the flagship latent
CLIP_ROWS = 64


def sweep_kernels(card: str) -> dict:
    """K1 and K2 at the sweep's shapes against their plain versions, on
    seeded Gaussian latents that spread over the codes (the sweep's own
    latents fall on one code of this corpus). For each codebook size, latent
    64: K1 at the training batch (512 rows), the eval rows (2^15) and the
    whole corpus (2^20 rows), its ids within the near-tie bound of the plain
    lookup and spread over the codes; K2 at the training batch, its ids the
    same, its counts exactly the plain stats of its ids, its sums within the
    summation bound. These launches are checks, counted on no path."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest_cuda,
        vq_nearest_reference,
        vq_nearest_with_stats_cuda,
    )
    from lipvq_tpu_torch.scripts.tokenizer_sweep import EVAL_ROWS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    k1_rows = {"train": SWEEP_BATCH, "eval": EVAL_ROWS, "tokenize": CORPUS_SHAPE[0]}
    results = {}
    for n in SWEEP_CODES:
        c = torch.randn(n, SWEEP_LATENT, generator=gen, device=dev)
        z_all = torch.randn(CORPUS_SHAPE[0], SWEEP_LATENT, generator=gen, device=dev)
        r = {}
        for label, rows in k1_rows.items():
            z = z_all[:rows]
            ids = vq_nearest_cuda(z, c)
            mismatches, max_gap, _ = check_near_ties(z, c, ids, vq_nearest_reference(z, c),
                                                     bf16=False)
            used = int(torch.unique(ids).numel())
            if used < min(rows, n) // 4:
                raise AssertionError(f"K1 at {rows}x{n}x{SWEEP_LATENT}: ids on {used} codes")
            r[f"k1_{label}"] = {"shape": [rows, n, SWEEP_LATENT], "mismatches": mismatches,
                                "max_id_gap": max_gap, "codes_used": used,
                                "ms": cuda_ms(lambda: vq_nearest_cuda(z, c), 5)}
        z = z_all[:SWEEP_BATCH]
        ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
        mismatches, max_gap, _ = check_near_ties(z, c, ids, vq_nearest_reference(z, c),
                                                 bf16=False)
        max_err = hold_stats(z, ids, counts, sums, f"at {SWEEP_BATCH}x{n}x{SWEEP_LATENT}")
        r["k2_train"] = {"shape": [SWEEP_BATCH, n, SWEEP_LATENT], "mismatches": mismatches,
                         "max_id_gap": max_gap, "max_abs_err": max_err,
                         "codes_used": int((counts > 0).sum()),
                         "ms": cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), 5)}
        results[n] = r
        print(f"sweep shapes, {n} codes x {SWEEP_LATENT}: K1 at "
              + ", ".join(f"{v['shape'][0]} rows {v['mismatches']} ids off the plain lookup "
                          f"(near-ties), {v['codes_used']} codes used, {v['ms']:.4f} ms"
                          for k, v in r.items() if k.startswith("k1"))
              + f"; K2 at {SWEEP_BATCH} rows {r['k2_train']['mismatches']} ids off (near-ties), "
              f"counts exact, sums max abs err {max_err:.3g}, "
              f"{r['k2_train']['codes_used']} codes used, {r['k2_train']['ms']:.4f} ms [{card}]")
        del c, z_all, z, ids, counts, sums
    torch.cuda.empty_cache()
    return results


def tokenizers_phase(card: str, root: str) -> dict:
    """The rest of the tokenizer ablation at full size. (a) The sweep,
    ``scripts/tokenizer_sweep.main`` at its defaults on the corpus phase's
    export of 2^20 rows, each setting counted: a loss-codebook step launches
    K1 once and an EMA-codebook step K2 once, and the eval forward and the
    tokenization of the whole corpus K1 once each, so a setting launches
    (300 + 2, 0, 0) with the loss codebook and (2, 0, 300) with the EMA one;
    then K1 and K2 held against their plain versions at those shapes
    (``sweep_kernels``). (b) ``VQVAE`` at B = 500, latent 791, 128 and 1024 codes: a forward and
    a backward launch K1 once; the ids equal the plain lookup's but for
    near-ties (phase 2's rule) and the fp32 loss is the CPU's within rtol
    1e-5. (c) ``LFQVAE``, ``SpectralLFQVAE`` and ``LSTMVQVAE`` at B = 500
    (50 windows of 10), latent 791: the fp32 latents and loss on the card
    within rtol 1e-4 / atol 1e-5 of the CPU's, no launches. (d) The CLIP text
    tower at ViT-L/14 text width (12 layers x 768, 77 positions, vocab
    49408) from a seeded init, put on the card by a ``LangEncoder`` given no
    device, which embeds 64 strings tokenized to seeded id rows ending in
    EOS: within rtol 1e-4 / atol 1e-5 of the tower on the CPU in fp32."""
    from lipvq_tpu_torch.models import clip_text
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.tokenizers import vqvae
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_reference
    from lipvq_tpu_torch.scripts import tokenizer_sweep
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    dev = torch.device("cuda")

    # (a) the sweep, each setting counted
    sweep, launches = [], []
    setting = tokenizer_sweep.train_tokenizer

    def counted(*args, **kwargs):
        zero_launch_counts()
        t0 = time.perf_counter()
        r = setting(*args, **kwargs)
        torch.cuda.synchronize()
        launches.append(launch_counts())
        sweep.append({**r, "launches": launch_counts(), "seconds": time.perf_counter() - t0})
        return r

    out = io.StringIO()
    tokenizer_sweep.train_tokenizer = counted
    try:
        with contextlib.redirect_stdout(out):
            results = tokenizer_sweep.main(["--dataset", root])
    finally:
        tokenizer_sweep.train_tokenizer = setting
    printed = out.getvalue().splitlines()
    if printed[0] != f"corpus: {CORPUS_SHAPE[0]} chunks x {AC_DIM} dims" or [
            json.loads(line) for line in printed[1:]] != results:
        raise AssertionError(f"tokenizer_sweep printed {printed[:3]}")
    ran = [(r["num_codes"], r["codebook_update"]) for r in results]
    if ran != [(n, ema) for n in SWEEP_CODES for ema in ("loss", "ema")]:
        raise AssertionError(f"tokenizer_sweep ran {ran}")
    for r in sweep:
        expect = (SWEEP_STEPS + 2, 0, 0) if r["codebook_update"] == "loss" else (
            2, 0, SWEEP_STEPS)
        if r["launches"] != expect:
            raise AssertionError(f"sweep {r['num_codes']} {r['codebook_update']}: launches "
                                 f"(K1, K1f, K2) {r['launches']}, want {expect}")
        metrics = [r[k] for k in ("final_train_loss", "recon_mse", "codebook_utilization",
                                  "tokenize_chunks_per_sec")]
        if not all(np.isfinite(metrics)) or not 0 < r["codebook_utilization"] <= 1:
            raise AssertionError(f"sweep: metrics {r}")
        print(f"sweep {r['num_codes']} codes, {r['codebook_update']} codebook: launches (K1, "
              f"K1f, K2) {r['launches']}; final_train_loss {r['final_train_loss']:.5f}, "
              f"recon_mse {r['recon_mse']:.5f}, codebook_utilization "
              f"{r['codebook_utilization']:.4f}, tokenize {r['tokenize_chunks_per_sec']:.4g} "
              f"rows/s; {r['seconds']:.1f} s for the setting [{card}]")
    shapes = sweep_kernels(card)

    # (b) VQVAE: one K1 launch per forward + backward
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.standard_normal((VQVAE_ROWS, AC_DIM), dtype=np.float32))
    vq = {}
    for codes in (128, 1024):
        cpu = seeded_init(vqvae.VQVAE(AC_DIM, TOKENIZER_LATENT, num_embeddings=codes),
                          torch.Generator().manual_seed(21))
        with torch.no_grad():  # codes at latents of other inputs, so the ids spread
            cpu.embedding.copy_(cpu.encode(torch.from_numpy(
                rng.standard_normal((codes, AC_DIM), dtype=np.float32))))
        card_model = vqvae.VQVAE(AC_DIM, TOKENIZER_LATENT, num_embeddings=codes).to(dev)
        card_model.load_state_dict(cpu.state_dict())
        xc = x.to(dev)
        zero_launch_counts()
        _, loss, ids = card_model(xc)
        loss.backward()
        torch.cuda.synchronize()
        got = launch_counts()
        if got != (1, 0, 0):
            raise AssertionError(f"VQVAE {codes} codes: launches (K1, K1f, K2) {got}")
        with torch.no_grad():
            z_e = card_model.encode(xc)
            mismatches, max_gap = check_ids(z_e, card_model.embedding, ids,
                                            vq_nearest_reference(z_e, card_model.embedding))
        _, want_loss, want_ids = cpu(x)
        loss, want_loss = loss.detach(), want_loss.detach()
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                                   err_msg=f"VQVAE {codes} codes: fp32 loss, card vs CPU")
        ms = cuda_ms(lambda: card_model(xc)[1].backward(), 10)
        vq[codes] = {"launches": got, "mismatches": mismatches, "max_id_gap": max_gap,
                     "distinct_ids": int(torch.unique(ids).numel()),
                     "ids_equal_cpu": int((ids.cpu() == want_ids).sum()),
                     "loss": float(loss), "cpu_loss": float(want_loss), "ms": ms}
        print(f"VQVAE {VQVAE_ROWS}x{codes}x{TOKENIZER_LATENT}: forward + backward launched "
              f"(K1, K1f, K2) {got}; {mismatches} ids differ from the plain lookup within the "
              f"tie tolerance (max fp64 gap {max_gap:.3g}), "
              f"{vq[codes]['distinct_ids']} distinct; {vq[codes]['ids_equal_cpu']} of "
              f"{VQVAE_ROWS} ids equal the CPU's; loss {float(loss):.6f} == CPU "
              f"{float(want_loss):.6f} within rtol 1e-5; {ms:.3f} ms per forward + backward "
              f"[{card}]")
        del cpu, card_model

    # (c) the other tokenizers of the family: card against CPU, no launches
    x = torch.from_numpy(rng.uniform(-1, 1, (VQVAE_ROWS, AC_DIM)).astype(np.float32))
    family = {}
    for name, make in (("LFQVAE", lambda: vqvae.LFQVAE(AC_DIM, TOKENIZER_LATENT)),
                       ("SpectralLFQVAE", lambda: vqvae.SpectralLFQVAE(AC_DIM, TOKENIZER_LATENT)),
                       ("LSTMVQVAE", lambda: vqvae.LSTMVQVAE(AC_DIM, TOKENIZER_LATENT))):
        cpu = seeded_init(make(), torch.Generator().manual_seed(22))
        card_model = make().to(dev)
        card_model.load_state_dict(cpu.state_dict())
        zero_launch_counts()
        with torch.no_grad():
            z, loss = card_model(x.to(dev))[:2]
            torch.cuda.synchronize()
            got = launch_counts()
            want_z, want_loss = cpu(x)[:2]
        if got != (0, 0, 0):
            raise AssertionError(f"{name}: launches (K1, K1f, K2) {got}")
        np.testing.assert_allclose(z.cpu().numpy(), want_z.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} latents, card vs CPU")
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} loss, card vs CPU")
        if name == "SpectralLFQVAE":  # both advanced u once, from the same start
            np.testing.assert_allclose(card_model.enc_0.u.cpu().numpy(), cpu.enc_0.u.numpy(),
                                       rtol=1e-4, atol=1e-5)
        xc = x.to(dev)
        ms = cuda_ms(lambda: card_model(xc), 10)
        family[name] = {"launches": got, "max_abs_err": float((z.cpu() - want_z).abs().max()),
                        "loss": float(loss), "cpu_loss": float(want_loss), "ms": ms}
        print(f"{name} {VQVAE_ROWS}x{TOKENIZER_LATENT}: fp32 card == CPU within rtol 1e-4 / "
              f"atol 1e-5 (latents max abs {family[name]['max_abs_err']:.3g}, loss "
              f"{float(loss):.6f}), launches (K1, K1f, K2) {got}; {ms:.3f} ms per forward "
              f"[{card}]")
        del cpu, card_model

    # (d) the CLIP text tower at ViT-L/14 text width, through a LangEncoder
    cfg = clip_text.CLIPTextConfig()
    cpu = seeded_init(clip_text.CLIPTextTower(cfg), torch.Generator().manual_seed(23))
    tower = clip_text.CLIPTextTower(cfg)
    tower.load_state_dict(cpu.state_dict())
    ids = rng.integers(0, cfg.eos_token_id, (CLIP_ROWS, cfg.max_positions))
    ends = rng.integers(2, cfg.max_positions + 1, CLIP_ROWS)
    for r, end in enumerate(ends):
        ids[r, end - 1:] = cfg.eos_token_id  # the EOS, then EOS padding
    ids = torch.from_numpy(ids)
    strings = [f"instruction {r}" for r in range(CLIP_ROWS)]
    row = {s: r for r, s in enumerate(strings)}
    encoder = LangEncoder()  # no device given: the tower goes to the card
    encoder.use_tower(tower, lambda texts, padding, return_tensors: {
        "input_ids": ids[[row[t] for t in texts]]})
    zero_launch_counts()
    got = torch.from_numpy(encoder.get_lang_emb(strings))
    with torch.no_grad():
        want = cpu(ids)
        clip_ms = cuda_ms(lambda: tower(ids.to(dev)), 10)
    on_card = next(tower.parameters()).device.type == "cuda"
    counts = launch_counts()
    if counts != (0, 0, 0) or got.shape != (CLIP_ROWS, cfg.projection_dim) or not on_card:
        raise AssertionError(f"CLIP tower: launches {counts}, shape {tuple(got.shape)}, "
                             f"on the card: {on_card}")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                               err_msg="CLIP tower, card vs CPU")
    clip_err = float((got - want).abs().max())
    print(f"CLIP text tower {cfg.num_layers} x {cfg.hidden_size}, {cfg.max_positions} "
          f"positions, vocab {cfg.vocab_size}, on the card through LangEncoder: {CLIP_ROWS} "
          f"strings, fp32 card == CPU within rtol 1e-4 / atol 1e-5 (max abs {clip_err:.3g}); "
          f"{clip_ms:.3f} ms per call of the tower [{card}]")
    del cpu, tower, encoder
    torch.cuda.empty_cache()
    return {"sweep": sweep, "sweep_kernels": shapes, "vqvae": vq, "family": family,
            "clip": {"max_abs_err": clip_err, "ms": clip_ms}}


SCRIPT_EXPORTS, SCRIPT_DEMOS, SCRIPT_DEMO_LEN = 2, 40, 300
SCRIPT_EPOCHS, SCRIPT_STEPS = 2, 10
ROLLOUT_HORIZON = 50  # N_ENVS envs, n = N_ENVS: one wave of 50 batched requests an epoch
EVAL_EPISODES, EVAL_HORIZON = 2, 50


def script_config(exports: list[str], output_dir: str) -> dict:
    """The config file of the script phase: train_phase's loss-codebook
    settings with the template's warmup, the exports as a ``train.data``
    list (a MetaDataset), the template's windows (frame_stack and
    seq_length 10) and low_dim cache, a checkpoint every
    epoch and one wave of batched rollouts per epoch."""
    cfg = json.loads(icl_config(train={"ema": False, "dropout": 0.1, "warmup": None}).dump())
    cfg["train"].update({"data": exports, "output_dir": output_dir,
                         "num_epochs": SCRIPT_EPOCHS, "hdf5_cache_mode": "low_dim",
                         "hdf5_load_next_obs": False, "frame_stack": 10, "seq_length": 10})
    exp = cfg["experiment"]
    exp.update({"name": "chip_smoke", "epoch_every_n_steps": SCRIPT_STEPS,
                "render_video": False})
    exp["logging"].update({"terminal_output_to_txt": False, "log_tb": False})
    exp["save"].update({"enabled": True, "every_n_epochs": 1})
    exp["rollout"].update({"enabled": True, "batched": True, "num_batch_envs": N_ENVS,
                           "n": N_ENVS, "horizon": ROLLOUT_HORIZON, "rate": 1,
                           "warmstart": 0, "terminate_on_success": False})
    return cfg


def per_step_ms(logs: dict, key: str, steps: int) -> list[float]:
    """A ``Time_*`` log (minutes per epoch) as ms per step, one per epoch."""
    return [v * 60e3 / steps for v in logs[key]]


def script_phase(card: str, served: dict) -> dict:
    """scripts/train.py on two seeded exports at full width, then the
    checkpoint reloaded, the full state resumed and eval_checkpoint run."""
    from torch.profiler import ProfilerActivity, profile

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.scripts.eval_checkpoint import evaluate_checkpoint
    from lipvq_tpu_torch.utils import file_utils, train_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        obs_shapes = {k: tuple(s) for k, s in OBS_SHAPES.items() if k != "lang_emb"}
        exports = [make_synthetic_export(os.path.join(tmp, f"export{i}"), n_demos=SCRIPT_DEMOS,
                                         demo_len=SCRIPT_DEMO_LEN, action_dim=AC_DIM,
                                         obs_key_shapes=obs_shapes,
                                         lang=f"synthetic task {i}", seed=i)
                   for i in range(SCRIPT_EXPORTS)]
        export_s = time.perf_counter() - t0
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(script_config(exports, os.path.join(tmp, "out")), f)

        # run_epoch, observed: the in-process algo, K1's launches inside the
        # train steps, and the device's busy time over the last epoch's steps
        seen = {"algo": None, "k1_steps": 0, "k1f_steps": 0, "k2_steps": 0, "profile": None}
        run_epoch = train_utils.run_epoch

        def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
            seen["algo"] = model
            before = launch_counts()
            if epoch != SCRIPT_EPOCHS or validate:
                log = run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    log = run_epoch(model, loader, epoch, validate=validate,
                                    num_steps=num_steps)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                busy_ms, kernels = device_busy(prof)
                seen["profile"] = {
                    "wall_ms": wall_ms, "busy_ms": busy_ms,
                    "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
                    "top_ops_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])}
            for key, after, was in zip(("k1_steps", "k1f_steps", "k2_steps"),
                                       launch_counts(), before):
                seen[key] += after - was
            return log

        out = io.StringIO()
        train_utils.run_epoch = observed_run_epoch
        try:
            # the main path: the training script, counted
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                ckpt_dir = train_script.main(["--config", cfg_path])
            script_s = time.perf_counter() - t0
            k1, k1f, k2 = launch_counts()
        except BaseException:
            print(out.getvalue()[-8000:])
            raise
        finally:
            train_utils.run_epoch = run_epoch
        for line in out.getvalue().splitlines():
            if line.startswith(("Rollout Epoch", "save checkpoint", "Rollout disabled")):
                print(f"  script: {line}")

        k1_steps, want_steps = seen["k1_steps"], SCRIPT_EPOCHS * SCRIPT_STEPS
        k1_rollout, want_rollout = k1 - k1_steps, SCRIPT_EPOCHS * ROLLOUT_HORIZON
        if (k1_steps, k1_rollout, k1f, k2) != (want_steps, want_rollout, 0, 0):
            raise AssertionError(
                f"script: K1 launched {k1_steps} times in the train steps (want {want_steps}) "
                f"and {k1_rollout} in the rollouts (want {want_rollout}), K1f {k1f} and K2 "
                f"{k2} (want 0)")
        names = sorted(os.listdir(ckpt_dir))
        ckpts = {e: [n for n in names if n.startswith(f"model_epoch_{e}") and n.endswith(".ckpt")]
                 for e in range(1, SCRIPT_EPOCHS + 1)}
        if not all(len(v) == 1 for v in ckpts.values()) or not {
                "latest_full.state", "latest_full.state.epoch"} <= set(names):
            raise AssertionError(f"script: checkpoint files {names}")
        with open(os.path.join(ckpt_dir, "latest_full.state.epoch")) as f:
            assert f.read() == str(SCRIPT_EPOCHS)
        with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
            logs = json.load(f)
        bad = {k: v for k, v in logs.items() if not np.isfinite(v).all()}
        if bad or len(logs.get("Rollout/Success_Rate/SyntheticKitchen", [])) != SCRIPT_EPOCHS:
            raise AssertionError(f"script: non-finite or missing logs {bad or sorted(logs)}")
        print(f"script: {SCRIPT_EPOCHS} epochs x {SCRIPT_STEPS} steps over {SCRIPT_EXPORTS} "
              f"exports ({SCRIPT_DEMOS} demos x {SCRIPT_DEMO_LEN} steps each, written in "
              f"{export_s:.2f} s) through MetaDataset, {N_ENVS}-env batched rollouts of "
              f"{ROLLOUT_HORIZON} steps each epoch, in {script_s:.1f} s; K1 launched "
              f"{k1_steps} times in train steps + {k1_rollout} in rollouts, K2 {k2}; files "
              f"{names}; Train/Loss {logs['Train/Loss']}")

        # reload: the last checkpoint on the card against the in-process algo
        algo = seen["algo"]
        last = os.path.join(ckpt_dir, ckpts[SCRIPT_EPOCHS][0])
        t0 = time.perf_counter()
        reloaded, ckpt = file_utils.policy_from_checkpoint(last)  # CUDA by default
        torch.cuda.synchronize()
        policy_load_ms = (time.perf_counter() - t0) * 1e3
        assert reloaded.device.type == "cuda" and algo.device.type == "cuda"
        rng = np.random.default_rng(8)
        t = algo.context_length
        inputs = (random_obs(rng, (N_ENVS, t)), random_obs(rng, (N_ENVS, t)),
                  rng.uniform(-1, 1, (N_ENVS, t, AC_DIM)).astype(np.float32))
        dists = []
        with torch.inference_mode():
            for a in (algo, reloaded):
                dists.append(a.nets.forward_train(*(a._put_infer(x) for x in inputs),
                                                  low_noise_eval=True)[0])
        if not all(torch.equal(x, y) for x, y in zip(*dists)):
            raise AssertionError("the reloaded checkpoint's GMM parameters differ from the "
                                 "in-process algo's")
        print("script reload: policy_from_checkpoint on the card gives GMM parameters "
              "bit-equal to the in-process algo's")

        # resume: a fresh algo from latest_full.state takes the writer's next step
        config = file_utils.config_from_checkpoint(ckpt)
        shape_meta = json.loads(ckpt["shape_metadata"])
        fresh = algo_factory("icl", config, shape_meta["all_shapes"], ac_dim=shape_meta["ac_dim"])
        state_path = os.path.join(ckpt_dir, "latest_full.state")
        fresh.deserialize_full(torch.load(state_path, map_location="cpu", weights_only=True))
        batch = fresh.process_batch_for_training(
            next(iter(DataLoader(SequenceItems(BATCH, seed=9), BATCH, seed=10))))
        zero_launch_counts()
        got = fresh.train_on_batch(batch, SCRIPT_EPOCHS + 1)["losses"]
        want = algo.train_on_batch(batch, SCRIPT_EPOCHS + 1)["losses"]
        k1_resume, _, k2_resume = launch_counts()
        if (k1_resume, k2_resume) != (2, 0):
            raise AssertionError(f"resume: K1 launched {k1_resume}, K2 {k2_resume} in 2 steps")
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
        bit_exact = all(torch.equal(got[k], want[k]) for k in want) and all(
            torch.equal(p, q) for p, q in zip(fresh.nets.state_dict().values(),
                                              algo.nets.state_dict().values()))
        print(f"script resume: the resumed step's losses agree to rtol 1e-5 "
              f"({ {k: float(v) for k, v in got.items()} }); bit-exact losses and weights: "
              f"{bit_exact}; K1 launched once per step")

        # checkpoint size and save / load times
        probe = os.path.join(tmp, "probe.ckpt")
        save_ms = host_ms(lambda: file_utils.save_checkpoint(
            probe, algo, config, shape_meta=shape_meta), reps=3)
        state_probe = os.path.join(tmp, "probe.state")
        save_state_ms = host_ms(lambda: torch.save(algo.serialize_full(), state_probe), reps=3)

        def load():
            fresh.deserialize(file_utils.load_checkpoint_dict(probe)["model"])
            torch.cuda.synchronize()

        load_ms = host_ms(load, reps=3)
        ckpt_bytes, state_bytes = os.path.getsize(last), os.path.getsize(state_path)
        del fresh, reloaded

        # eval_checkpoint on one env, counted
        zero_launch_counts()
        t0 = time.perf_counter()
        stats = evaluate_checkpoint(last, n=EVAL_EPISODES, horizon=EVAL_HORIZON,
                                    terminate_on_success=False, verbose=False)
        eval_s = time.perf_counter() - t0
        k1_eval, k1f_eval, k2_eval = launch_counts()
        want_eval = EVAL_EPISODES * EVAL_HORIZON
        if (k1_eval, k1f_eval, k2_eval) != (want_eval, 0, 0) or \
                stats["episodes"] != EVAL_EPISODES or \
                stats["Horizon"] != EVAL_HORIZON or not all(
                    np.isfinite(v) for v in stats.values()):
            raise AssertionError(f"eval_checkpoint: K1 {k1_eval} (want {want_eval}), K1f "
                                 f"{k1f_eval}, K2 {k2_eval}, stats {stats}")
        device_cache = device_cache_script(card, exports, tmp)

    # the host's share of a rollout step: 16 synthetic envs stepped with
    # their frame stacks, no request
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.vector_env import VectorEnv

    vec = VectorEnv([SyntheticKitchenEnv for _ in range(N_ENVS)], frame_stack=algo.context_length,
                    obs_keys=[k for k in OBS_SHAPES if k != "lang_emb"])
    vec.reset()
    acts = np.random.default_rng(11).uniform(-1, 1, (N_ENVS, AC_DIM)).astype(np.float32)
    env_step_ms = host_ms(lambda: vec.step(acts), reps=50)

    steps = SCRIPT_STEPS
    timing = {k: per_step_ms(logs, f"Timing_Stats/Train_{k}", steps)
              for k in ("Data_Loading", "Process_Batch", "Train_Batch", "Log_Info")}
    rollout_step_ms = per_step_ms(logs, "Timing_Stats/Rollout_SyntheticKitchen_Rollouts",
                                  ROLLOUT_HORIZON)
    prof = seen["profile"]
    print(f"script Time_* per step, epoch 1 and epoch {SCRIPT_EPOCHS} (profiler on): "
          f"{ {k: [round(x, 3) for x in v] for k, v in timing.items()} } ms; device busy "
          f"{prof['busy_ms']} ms of {prof['wall_ms']:.1f} ms over epoch {SCRIPT_EPOCHS}'s "
          f"{steps} steps, idle share {prof['idle_share']}; top {prof['top_ops_ms']} [{card}]")
    print(f"script rollout: {[round(x, 3) for x in rollout_step_ms]} ms per batched step of "
          f"{N_ENVS} envs, env stepping included (epochs 1, {SCRIPT_EPOCHS}), against "
          f"{served['batched_request_ms']:.3f} ms per bare {N_ENVS}-env request and "
          f"{env_step_ms:.3f} ms per step of the {N_ENVS} envs alone [{card}]")
    print(f"script checkpoint: {ckpt_bytes} bytes (full state {state_bytes}); save "
          f"{save_ms:.1f} ms, full-state save {save_state_ms:.1f} ms, load into an algo "
          f"{load_ms:.1f} ms, policy_from_checkpoint {policy_load_ms:.1f} ms (median of 3) "
          f"[{card}]")
    print(f"eval_checkpoint: {EVAL_EPISODES} episodes x {EVAL_HORIZON} steps in {eval_s:.1f} s, "
          f"K1 launched {k1_eval} times; {stats}")
    print(f"script data loading per step, host path (low_dim cache) against the device cache: "
          f"{[round(x, 3) for x in timing['Data_Loading']]} against "
          f"{[round(x, 3) for x in device_cache['time_ms_per_step']['Data_Loading']]} ms "
          f"(epochs 1, {SCRIPT_EPOCHS}); train batch "
          f"{[round(x, 3) for x in timing['Train_Batch']]} against "
          f"{[round(x, 3) for x in device_cache['time_ms_per_step']['Train_Batch']]} ms [{card}]")
    return {"device_cache": device_cache,
            "k1_train_steps": k1_steps, "k1_rollout": k1_rollout, "k1_eval": k1_eval,
            "k1f_train_steps": seen["k1f_steps"], "k1f_rollout": k1f - seen["k1f_steps"],
            "k1f_eval": k1f_eval, "k2_train_steps": seen["k2_steps"],
            "k2_rollout": k2 - seen["k2_steps"], "k2_eval": k2_eval, "script_s": script_s,
            "time_ms_per_step": timing, "rollout_step_ms": rollout_step_ms,
            "env_step_ms": env_step_ms,
            "profile": prof, "ckpt_bytes": ckpt_bytes, "state_bytes": state_bytes,
            "save_ms": save_ms, "save_state_ms": save_state_ms, "load_ms": load_ms,
            "policy_load_ms": policy_load_ms, "resume_bit_exact": bit_exact,
            "eval": stats, "eval_s": eval_s}


def visual_config(compute_dtype: str = "bfloat16", train: dict | None = None,
                  crop: int = VIS_CROP):
    """The ICL template (``icl_config``) with the RoboCasa image protocol of
    config_gen_utils.set_env_settings / set_mod_settings (mod="im"): the
    three cameras as rgb keys, ``VisualCoreLanguageConditioned`` cores
    (ResNet18ConvFiLM, SpatialSoftmax with 32 keypoints, 64 features), a
    ``crop`` x ``crop`` CropRandomizer; with ``train``, batch 16, 5 data
    workers and no dataset cache."""
    cfg = icl_config(compute_dtype, train)
    with cfg.unlocked():
        cfg.update_from({"observation": {
            "modalities": {"obs": {"rgb": list(VIS_CAMERAS)}},
            "encoder": {"rgb": {
                "core_class": "VisualCoreLanguageConditioned",
                "core_kwargs": {"feature_dimension": 64, "backbone_class": "ResNet18ConvFiLM",
                                "pool_class": "SpatialSoftmax", "pool_kwargs": {"num_kp": 32}},
                "obs_randomizer_class": "CropRandomizer",
                "obs_randomizer_kwargs": {"crop_height": crop, "crop_width": crop,
                                          "num_crops": 1}}}}}, strict=True)
        if train is not None:
            cfg.train.batch_size = VIS_BATCH
            cfg.train.num_data_workers = VIS_WORKERS
            cfg.train.hdf5_cache_mode = None
    return cfg


def visual_obs(rng, lead, processed: bool) -> dict:
    """Seeded low-dim obs and uint8 camera frames of shape ``lead`` +
    [128, 128, 3]; ``processed`` gives the frames as float32 / 255."""
    obs = random_obs(rng, lead)
    for k in VIS_CAMERAS:
        frames = rng.integers(0, 256, (*lead, *VIS_FRAME), dtype=np.uint8)
        obs[k] = frames.astype(np.float32) / np.float32(255.0) if processed else frames
    return obs


class ImageItems(SequenceItems):
    """SequenceItems with the three cameras' uint8 frames, [19, 128, 128, 3]."""

    def __init__(self, n: int, seed: int):
        super().__init__(n, seed)
        rng = np.random.default_rng([seed, 1])
        for item in self.items:
            for k in VIS_CAMERAS:
                item["obs"][k] = rng.integers(0, 256, (SEQ_STEPS, *VIS_FRAME), dtype=np.uint8)


def visual_cores(algo) -> list:
    enc = algo.nets.net.encoder.group_encoder.enc_obs
    return [getattr(enc, f"core_{k}") for k in VIS_CAMERAS]


def trunk_gflop_per_frame(algo) -> float:
    """GFLOP (2 x multiply-adds) of one visual core's convolutions for one
    frame at the crop size, counted from the shapes of an eval forward
    (output elements x input channels x kernel taps of each conv)."""
    x = torch.zeros((1, VIS_CROP, VIS_CROP, 3), device=algo.device)
    lang = torch.zeros((1, 768), device=algo.device)
    return sum(2 * m.weight[0].numel() * n
               for m, n in _conv_outputs(visual_cores(algo)[0], x, lang)) / 1e9


def conv_share(convs: dict, busy_ms) -> tuple[float, float | None]:
    """(conv kernels' ms, their share of the busy time) from profile_convs."""
    conv_ms = sum(convs.values())
    return conv_ms, None if not busy_ms else conv_ms / busy_ms


def assert_fp32_convs(names: list, label: str) -> None:
    """The port runs its convolutions with cuDNN's TF32 off: no conv kernel
    of the run is named TF32 (``ema_parity_step``'s control shows that a
    TF32 run's are)."""
    if not names:
        raise AssertionError(f"{label}: the profiler linked no kernel to a convolution")
    tf32 = [n for n in names if "tf32" in n.lower()]
    if tf32:
        raise AssertionError(f"{label}: TF32 conv kernels {tf32}")


@contextlib.contextmanager
def tf32_convolutions():
    """For the control only: the port's fp32 scope for convolutions
    (``base_nets.cudnn_fp32``) swapped for one with cuDNN's TF32 on."""
    from lipvq_tpu_torch.models import base_nets

    @contextlib.contextmanager
    def tf32():
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = before

    fp32, base_nets.cudnn_fp32 = base_nets.cudnn_fp32, tf32
    try:
        yield
    finally:
        base_nets.cudnn_fp32 = fp32


def move_batchnorm_stats(algos, seed: int) -> None:
    """Set every BatchNorm's running mean to N(0, 0.1) and var to U(0.5, 1.5)
    (from one seed, the same in each algo): the init's (0, 1) would make
    running-statistics normalization trivial."""
    from lipvq_tpu_torch.models.base_nets import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    stats = {}
    for name, m in algos[0].nets.named_modules():
        if isinstance(m, BatchNorm):
            n = m.mean.shape[0]
            stats[name] = (0.1 * torch.randn(n, generator=gen),
                           0.5 + torch.rand(n, generator=gen))
    with torch.no_grad():
        for a in algos:
            for name, (mean, var) in stats.items():
                m = a.nets.get_submodule(name)
                m.mean.copy_(mean)
                m.var.copy_(var)


def trunk_layouts(card: str) -> dict:
    """One FiLM ResNet-18 trunk (+ pool, proj) on 160 frames at 116 x 116:
    CUDA-event ms of the eval forward and of a train forward + backward with
    the input contiguous NCHW (the port's) and channels_last, cuDNN TF32
    off; the trunk's TFLOP/s in each."""
    from lipvq_tpu_torch.models import obs_core
    from lipvq_tpu_torch.models.base_nets import seeded_init

    core = seeded_init(obs_core.VisualCore(
        VIS_FRAME, 64, "ResNet18ConvFiLM", num_kp=32, crop_height=VIS_CROP,
        crop_width=VIS_CROP, film=True, lang_dim=768), torch.Generator().manual_seed(25)).cuda()
    frames = N_ENVS * 10
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.rand(frames, VIS_CROP, VIS_CROP, 3, device="cuda", generator=gen)
    lang = torch.randn(frames, 768, device="cuda", generator=gen)
    gflop = sum(2 * m.weight[0].numel() * o for m, o in _conv_outputs(core, x[:1], lang[:1])
                ) / 1e9 * frames
    out = {}
    for layout in ("contiguous", "channels_last"):
        inp = x.permute(0, 3, 1, 2)
        inp = inp.contiguous() if layout == "contiguous" else inp

        def forward():
            with torch.no_grad():
                core.proj(core.pool(core.backbone(inp, False, lang)))

        def train():
            core.proj(core.pool(core.backbone(inp, True, lang))).sum().backward()

        fwd_ms, train_ms = cuda_ms(forward, 10, warmup=3), cuda_ms(train, 10, warmup=3)
        out[layout] = {"eval_forward_ms": fwd_ms, "train_ms": train_ms,
                       "eval_tflops": gflop / fwd_ms, "train_tflops": 3 * gflop / train_ms}
        print(f"visual trunk {layout}: eval forward {fwd_ms:.2f} ms ({gflop / fwd_ms:.1f} "
              f"TFLOP/s), train forward + backward {train_ms:.2f} ms "
              f"({3 * gflop / train_ms:.1f} TFLOP/s at 3x the forward's {gflop:.1f} GFLOP) "
              f"for {frames} frames at {VIS_CROP}x{VIS_CROP} [{card}]")
    del core
    return out


def _conv_outputs(core, x, lang) -> list:
    """(conv module, output elements) of each conv of ``core``'s eval
    forward on the NHWC crop ``x``."""
    from lipvq_tpu_torch.models.base_nets import Conv

    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append((mod, out.numel())))
             for m in core.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            core.proj(core.pool(core.backbone(x.permute(0, 3, 1, 2).contiguous(), False,
                                              lang)))
    finally:
        for h in hooks:
            h.remove()
    return seen


def visual_phase(card: str) -> dict:
    """Phase 10: the image protocol at full width. Serve (5 requests of 16
    envs, 3 single-env requests), train (20 steps with the loss and with the
    EMA codebook), one fp32 step held against the CPU, then the training
    script with 5 data workers and the MSE visualizer."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.base import frames_to_float
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.utils import obs_utils
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    obs_utils.initialize_obs_utils_with_config(visual_config())
    # the device's division of uint8 frames equals the host's, every value
    values = np.arange(256, dtype=np.uint8)
    on_card = frames_to_float(torch.from_numpy(values).cuda()).cpu().numpy()
    np.testing.assert_array_equal(on_card.view(np.int32),
                                  (values.astype(np.float32) / np.float32(255.0)).view(np.int32))

    algo = algo_factory("icl", visual_config(), VIS_SHAPES, ac_dim=AC_DIM)  # CUDA by default
    algo32 = algo_factory("icl", visual_config("float32"), VIS_SHAPES, ac_dim=AC_DIM)
    algo_cpu = algo_factory("icl", visual_config("float32"), VIS_SHAPES, ac_dim=AC_DIM,
                            device="cpu")
    assert not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 must stay off"
    net = algo.nets.net
    assert net.encoder.output_dim == VIS_LATENT and net.embed_dim == 512
    assert net.encoder.action_network.quantizer.codebook.shape == (1024, VIS_LATENT)
    for core in visual_cores(algo):
        assert core.backbone.film and core.crop.crop_height == VIS_CROP
        assert core.pool.out_features == 64 and core.proj.weight.shape == (64, 64)
    gflop_frame = trunk_gflop_per_frame(algo)

    rng = np.random.default_rng(18)
    t = algo.context_length
    # a context as process_batch_for_training leaves it: uint8 frames
    context = {"obs": visual_obs(rng, (1, t), processed=False),
               "actions": rng.uniform(-1, 1, (1, t, AC_DIM)).astype(np.float32)}
    set_codebook(algo_cpu.nets.net.encoder.action_network, (algo, algo32, algo_cpu), rng,
                 context["actions"][0])
    move_batchnorm_stats((algo_cpu, algo, algo32), seed=19)
    batched_obs = [visual_obs(rng, (N_ENVS, t), processed=True) for _ in range(VIS_REQUESTS)]
    single_obs = [visual_obs(rng, (t,), processed=False) for _ in range(VIS_SINGLE)]
    policy = ICLRolloutPolicy(algo)

    # the main path: 5 batched + 3 single-env requests, counted
    zero_launch_counts()
    batched = [policy.batched(o, context) for o in batched_obs]
    single = [policy(o, context) for o in single_obs]
    serve_counts = launch_counts()
    requests = VIS_REQUESTS + VIS_SINGLE
    if serve_counts != (requests, 0, 0):
        raise AssertionError(f"visual serve: launches (K1, K1f, K2) {serve_counts} for "
                             f"{requests} requests")
    if not (all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all() for a in batched)
            and all(a.shape == (AC_DIM,) and np.isfinite(a).all() for a in single)):
        raise AssertionError("visual serve: served actions not finite or misshapen")

    # fp32 on the card against the CPU: running statistics, the center crop
    n = VIS_CPU_ENVS
    obs_n = {k: v[:n] for k, v in batched_obs[-1].items()}
    ctx_n = {"obs": {k: np.repeat(v, n, 0) for k, v in context["obs"].items()},
             "actions": np.repeat(context["actions"], n, 0)}
    outs = {}
    with torch.inference_mode():
        for name, a in (("fp32", algo32), ("cpu", algo_cpu)):
            x = (a._put_infer(v) for v in (obs_n, ctx_n["obs"], ctx_n["actions"]))
            d, _ = a.nets.forward_train(*x, low_noise_eval=False)
            outs[name] = [v.float().cpu().numpy() for v in d]
    for field, got, want in zip(("means", "scales", "logits"), outs["fp32"], outs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                   err_msg=f"visual serve fp32 {field}")
    fwd_err = max(float(np.abs(g - w).max()) for g, w in zip(outs["fp32"], outs["cpu"]))
    tok_cpu = algo_cpu.nets.net.encoder.action_network  # sets the train phase's codebooks
    del algo_cpu

    batched_ms = host_ms(lambda: policy.batched(batched_obs[0], context), reps=10)
    single_ms = host_ms(lambda: policy(single_obs[0], context), reps=10)
    busy, kernels, convs, conv_names = profile_convs(
        lambda: policy.batched(batched_obs[0], context), 5)
    assert_fp32_convs(conv_names, "visual serve")
    conv_ms, conv_frac = conv_share(convs, busy)
    serve_gflop = gflop_frame * 2 * N_ENVS * t * len(VIS_CAMERAS)  # query + tiled context
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    serve = {"launches": serve_counts, "fp32_forward_max_abs_err": fwd_err,
             "batched_request_ms": batched_ms, "single_request_ms": single_ms,
             "device_busy_ms": busy, "idle_share": None if busy is None else 1 - busy / batched_ms,
             "conv_ms": conv_ms, "conv_share": conv_frac, "conv_kernels": len(conv_names),
             "trunk_gflop": serve_gflop,
             "trunk_tflops_per_busy_s": None if not busy else serve_gflop / busy,
             "trunk_tflops_per_conv_s": None if not conv_ms else serve_gflop / conv_ms,
             "top_ops_ms": top,
             "top_conv_ms": dict(sorted(convs.items(), key=lambda kv: -kv[1])[:4])}
    print(f"visual serve: {requests} requests ({VIS_REQUESTS} of {N_ENVS} envs, {VIS_SINGLE} "
          f"single), launches (K1, K1f, K2) {serve_counts}; fp32 card == CPU at {n} envs "
          f"within rtol 1e-3 / atol 1e-4 (max abs {fwd_err:.3g}); cuBLAS TF32 off, none of "
          f"the {len(conv_names)} conv kernels named TF32")
    print(f"visual serve latency: {batched_ms:.2f} ms per {N_ENVS}-env request, {single_ms:.2f} "
          f"ms per single-env request (median of 10); device busy {busy} ms, idle share "
          f"{serve['idle_share']}; conv kernels {conv_ms:.2f} ms ({conv_frac}); trunk "
          f"{serve_gflop:.0f} GFLOP per request ({gflop_frame:.4f} GFLOP per frame at "
          f"{VIS_CROP}x{VIS_CROP} x {2 * N_ENVS * t} frames x {len(VIS_CAMERAS)} cameras), "
          f"{serve['trunk_tflops_per_busy_s']} TFLOP/s over the busy time, "
          f"{serve['trunk_tflops_per_conv_s']} over the conv kernels' (fp32 peak "
          f"{PEAK_FP32_FLOPS / 1e12:.0f}); top {top}; top conv {serve['top_conv_ms']} [{card}]")
    del algo, algo32, policy, batched_obs, net
    torch.cuda.empty_cache()

    # train: 20 steps with each codebook, counted
    items = ImageItems(2 * VIS_BATCH, seed=20)
    results = {"serve": serve, "trunk_gflop_per_frame": gflop_frame,
               "trunk_layouts": trunk_layouts(card)}
    step_gflop = 3 * gflop_frame * VIS_BATCH * t * len(VIS_CAMERAS)  # forward + 2 backward
    for label, ema in (("train", False), ("train_ema", True)):
        algo = algo_factory("icl", visual_config(train={"ema": ema, "dropout": 0.1,
                                                        "warmup": 10}), VIS_SHAPES,
                            ac_dim=AC_DIM)
        set_codebook(tok_cpu, (algo,), np.random.default_rng(4))
        loader = DataLoader(items, VIS_BATCH, seed=21)
        stem = visual_cores(algo)[0].backbone.stem_bn
        zero_launch_counts()
        log = run_epoch(algo, loader, epoch=1, num_steps=TRAIN_STEPS)
        k1, k1f, k2 = launch_counts()
        if (k1, k1f, k2) != ((0, 0, TRAIN_STEPS) if ema else (TRAIN_STEPS, 0, 0)):
            raise AssertionError(f"visual {label}: K1 launched {k1}, K1f {k1f} and K2 {k2} "
                                 f"times in {TRAIN_STEPS} steps")
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"visual {label}: non-finite step log {log}")
        if torch.equal(stem.var, torch.ones_like(stem.var)):
            raise AssertionError(f"visual {label}: the BatchNorm statistics did not move")
        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=10)
        busy, kernels, convs, conv_names = profile_convs(lambda: algo.train_on_batch(batch, 1),
                                                         5)
        assert_fp32_convs(conv_names, f"visual {label}")
        conv_ms, conv_frac = conv_share(convs, busy)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
        timing = {k[5:]: v * 60e3 / TRAIN_STEPS for k, v in log.items() if k.startswith("Time_")}
        results[label] = {
            "k1_launches": k1, "k1f_launches": k1f, "k2_launches": k2, "log": log,
            "step_ms": step_ms,
            "device_busy_ms": busy, "idle_share": None if busy is None else 1 - busy / step_ms,
            "conv_ms": conv_ms, "conv_share": conv_frac, "conv_kernels": len(conv_names),
            "trunk_gflop": step_gflop,
            "trunk_tflops_per_busy_s": None if not busy else step_gflop / busy,
            "trunk_tflops_per_conv_s": None if not conv_ms else step_gflop / conv_ms,
            "run_epoch_ms_per_step": timing, "top_ops_ms": top,
            "top_conv_ms": dict(sorted(convs.items(), key=lambda kv: -kv[1])[:4])}
        r = results[label]
        print(f"visual {label}: {TRAIN_STEPS} steps of batch {VIS_BATCH}, K1 launched {k1}, K1f "
              f"{k1f} and K2 {k2} times; Loss {log['Loss']:.4f}, VQ_Loss "
              f"{log['VQ_Loss']:.4f}; run_epoch ms per step { {k: round(v, 2) for k, v in timing.items()} }")
        print(f"visual {label} step: {step_ms:.2f} ms median of 10; device busy {busy} ms, idle "
              f"share {r['idle_share']}; conv kernels {conv_ms:.2f} ms ({conv_frac}); trunk "
              f"~{step_gflop:.0f} GFLOP per step (3 x forward), "
              f"{r['trunk_tflops_per_busy_s']} TFLOP/s over the busy time, "
              f"{r['trunk_tflops_per_conv_s']} over the conv kernels'; top {top}; top conv "
              f"{r['top_conv_ms']} [{card}]")
        del algo, batch, stem
        torch.cuda.empty_cache()

    # one fp32 EMA step on the card against the CPU; the crop at its identity
    # setting (the full frame), as the card's and the CPU's generators differ
    def make(device=None):
        return algo_factory("icl", visual_config("float32", {"ema": True, "dropout": 0.0,
                                                             "warmup": 0}, crop=VIS_FRAME[0]),
                            VIS_SHAPES, ac_dim=AC_DIM, device=device)

    card_algo, cpu_algo, control = make(), make("cpu"), make()
    pbatch = card_algo.process_batch_for_training(
        next(iter(DataLoader(items, VIS_HOLD_BATCH, seed=22))))
    # the keypoint convs' biases shift a softmax's logits evenly: their exact
    # gradient is 0
    kp_biases = [n for n, _ in cpu_algo.nets.named_parameters() if n.endswith("kp_conv.bias")]
    assert len(kp_biases) == len(VIS_CAMERAS), kp_biases
    results["parity"] = ema_parity_step(card_algo, cpu_algo, pbatch, "visual train parity",
                                        zero=kp_biases, loose=("core_",), control=control)
    del card_algo, cpu_algo, control, items
    torch.cuda.empty_cache()
    results["script"] = visual_script(card)
    return results


def visual_script(card: str) -> dict:
    """scripts/train.py over a seeded image export (8 demos x 120 steps,
    three 128 x 128 cameras): 2 epochs x 10 steps, 5 data workers, no cache,
    the MSE visualizer in the second epoch (one request per sample), a
    checkpoint each epoch, the last reloaded bit-equal."""
    from torch.profiler import ProfilerActivity, profile

    from lipvq_tpu_torch.data.loaders import MultiprocessLoader
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.utils import file_utils, train_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    with tempfile.TemporaryDirectory(prefix="chip_smoke_visual_") as tmp:
        t0 = time.perf_counter()
        low_dim = {k: tuple(s) for k, s in OBS_SHAPES.items() if k != "lang_emb"}
        root = make_synthetic_export(os.path.join(tmp, "images"), n_demos=VIS_SCRIPT_DEMOS,
                                     demo_len=VIS_SCRIPT_LEN, action_dim=AC_DIM,
                                     obs_key_shapes=low_dim,
                                     image_key_shapes={k: VIS_FRAME for k in VIS_CAMERAS},
                                     lang="synthetic image task", seed=23)
        export_s = time.perf_counter() - t0
        export_bytes = sum(os.path.getsize(os.path.join(d, f))
                           for d, _, fs in os.walk(root) for f in fs)
        cfg = json.loads(visual_config(train={"ema": False, "dropout": 0.1,
                                              "warmup": None}).dump())
        cfg["train"].update({"data": root, "output_dir": os.path.join(tmp, "out"),
                             "num_epochs": SCRIPT_EPOCHS, "hdf5_load_next_obs": False,
                             "frame_stack": 10, "seq_length": 10})
        exp = cfg["experiment"]
        exp.update({"name": "chip_smoke_visual", "epoch_every_n_steps": SCRIPT_STEPS,
                    "render_video": False})
        exp["logging"].update({"terminal_output_to_txt": False, "log_tb": False})
        exp["save"].update({"enabled": True, "every_n_epochs": 1})
        exp["rollout"]["enabled"] = False  # the synthetic env has no cameras
        exp["mse"].update({"enabled": True, "every_n_epochs": SCRIPT_EPOCHS,
                           "on_save_ckpt": False, "num_samples": VIS_MSE_SAMPLES,
                           "visualize": False})
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

        seen = {"algo": None, "loader": None, "k1_steps": 0, "profile": None}
        run_epoch = train_utils.run_epoch

        def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
            seen["algo"], seen["loader"] = model, loader
            before = launch_counts()[0]
            if epoch != SCRIPT_EPOCHS:
                log = run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    log = run_epoch(model, loader, epoch, validate=validate,
                                    num_steps=num_steps)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                busy_ms, kernels = device_busy(prof)
                seen["profile"] = {
                    "wall_ms": wall_ms, "busy_ms": busy_ms,
                    "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
                    "top_ops_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])}
            seen["k1_steps"] += launch_counts()[0] - before
            return log

        out = io.StringIO()
        train_utils.run_epoch = observed_run_epoch
        try:
            # the main path: the training script, counted
            procs = len(multiprocessing.active_children())
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                ckpt_dir = train_script.main(["--config", cfg_path])
            script_s = time.perf_counter() - t0
            k1, k1f, k2 = launch_counts()
        except BaseException:
            print(out.getvalue()[-8000:])
            raise
        finally:
            train_utils.run_epoch = run_epoch
        loader = seen["loader"]
        if not isinstance(loader, MultiprocessLoader) or loader.num_workers != VIS_WORKERS \
                or len(multiprocessing.active_children()) != procs:
            raise AssertionError(f"visual script: train loader {loader!r} (want "
                                 f"{VIS_WORKERS} workers, stopped after training)")
        k1_steps, k1_mse = seen["k1_steps"], k1 - seen["k1_steps"]
        if (k1_steps, k1_mse, k1f, k2) != (SCRIPT_EPOCHS * SCRIPT_STEPS, VIS_MSE_SAMPLES, 0,
                                           0):
            raise AssertionError(f"visual script: K1 launched {k1_steps} times in train steps "
                                 f"and {k1_mse} in the MSE pass, K1f {k1f}, K2 {k2}")
        names = sorted(os.listdir(ckpt_dir))
        want_files = {f"model_epoch_{e}.ckpt" for e in range(1, SCRIPT_EPOCHS + 1)}
        if not want_files | {"latest_full.state"} <= set(names):
            raise AssertionError(f"visual script: checkpoint files {names}")
        with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
            logs = json.load(f)
        bad = {k: v for k, v in logs.items() if not np.isfinite(v).all()}
        if bad or len(logs.get("MSE/action_mse", [])) != 1:
            raise AssertionError(f"visual script: non-finite or missing logs "
                                 f"{bad or sorted(logs)}")

        algo = seen["algo"]
        reloaded, _ = file_utils.policy_from_checkpoint(
            os.path.join(ckpt_dir, f"model_epoch_{SCRIPT_EPOCHS}.ckpt"))
        rng = np.random.default_rng(24)
        t = algo.context_length
        inputs = (visual_obs(rng, (2, t), processed=False), visual_obs(rng, (2, t), False),
                  rng.uniform(-1, 1, (2, t, AC_DIM)).astype(np.float32))
        dists = []
        with torch.inference_mode():
            for a in (algo, reloaded):
                dists.append(a.nets.forward_train(*(a._put_infer(x) for x in inputs),
                                                  low_noise_eval=True)[0])
        same_state = all(torch.equal(x, y) for x, y in zip(
            algo.nets.state_dict().values(), reloaded.nets.state_dict().values()))
        if not (same_state and all(torch.equal(x, y) for x, y in zip(*dists))):
            raise AssertionError("visual script: the reloaded checkpoint differs from the "
                                 "in-process algo")
        del reloaded, algo

    timing = {k: per_step_ms(logs, f"Timing_Stats/Train_{k}", SCRIPT_STEPS)
              for k in ("Data_Loading", "Process_Batch", "Train_Batch", "Log_Info")}
    prof = seen["profile"]
    print(f"visual script: {SCRIPT_EPOCHS} epochs x {SCRIPT_STEPS} steps over an export of "
          f"{VIS_SCRIPT_DEMOS} demos x {VIS_SCRIPT_LEN} steps x {len(VIS_CAMERAS)} cameras "
          f"({export_bytes / 1e6:.1f} MB written in {export_s:.2f} s), {VIS_WORKERS} data "
          f"workers, in {script_s:.1f} s; K1 launched {k1_steps} times in train steps + "
          f"{k1_mse} in the MSE pass, K2 {k2}; MSE {logs['MSE/action_mse']}; the last "
          f"checkpoint reloads bit-equal (BatchNorm statistics included)")
    print(f"visual script Time_* per step, epoch 1 and epoch {SCRIPT_EPOCHS} (profiler on): "
          f"{ {k: [round(x, 3) for x in v] for k, v in timing.items()} } ms; device busy "
          f"{prof['busy_ms']} ms of {prof['wall_ms']:.1f} ms over epoch {SCRIPT_EPOCHS}'s "
          f"{SCRIPT_STEPS} steps, idle share {prof['idle_share']}; top {prof['top_ops_ms']} "
          f"[{card}]")
    return {"k1_train_steps": k1_steps, "k1_mse": k1_mse, "k1f": k1f, "k2": k2,
            "script_s": script_s,
            "export_s": export_s, "export_bytes": export_bytes, "time_ms_per_step": timing,
            "profile": prof, "mse": logs["MSE/action_mse"]}

# phase 10, the policy baselines: the JAX package's templates at their widths
# on the flagship's low-dim obs (label, algo, overrides of the template's algo)
BASELINES = (("diffusion_policy", "diffusion_policy", {}),
             ("act", "act", {}),
             ("bc_gmm", "bc", {}),
             ("bc_transformer_gmm", "bc", {"transformer": {"enabled": True}}),
             ("bc_rnn_gmm", "bc", {"rnn": {"enabled": True}}))
BASELINE_STEPS, BASELINE_REQUESTS, BASELINE_HORIZON = 10, 5, 40
BASELINE_HOLD_BATCH, BASELINE_CPU_ENVS = 16, 2
DP_DDIM_STEPS = 10
DP_SAMPLE_ATOL = 1e-3  # a 100-step DDPM chain from the same noise, card against CPU
UNET_PARAMS = 89_874_188  # ConditionalUnet1D(12, 2 x 791), the template's widths


def _deep_update(d: dict, over: dict) -> dict:
    for k, v in over.items():
        d[k] = _deep_update(d.get(k, {}), v) if isinstance(v, dict) else v
    return d


def baseline_config(algo: str, over: dict, hold: bool = False):
    """exps/templates/{algo}.json with ``over`` on its algo section and the
    flagship's low-dim obs. ``hold``: the card-vs-CPU step's settings, no
    warmup (the step moves every parameter) and no dropout."""
    from lipvq_tpu_torch.config import config_factory

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "exps", "templates",
                           f"{algo}.json")) as f:
        template = json.load(f)
    _deep_update(template["algo"], over)
    if hold and algo == "bc":
        _deep_update(template["algo"], {"transformer": {
            "emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0}})
    cfg = config_factory(algo, template)
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if hold:
            cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 0
    return cfg


def baseline_obs(algo, rng, n: int) -> dict:
    """Serving obs for ``n`` envs: [n, T, ...] windows of the steps the algo
    reads (Diffusion Policy's To, the sequence BC variants' context), [n, ...]
    for the one-step ones."""
    steps = baseline_frame_stack(algo)
    return random_obs(rng, (n,) if steps is None else (n, steps))


def baseline_frame_stack(algo) -> int | None:
    """The obs window the algo reads: Diffusion Policy's To, the sequence BC
    variants' context; None for the one-step ones."""
    if hasattr(algo, "To"):
        return algo.To
    return algo._seq_len() if getattr(algo, "sequence", False) else None


def assert_no_tf32(names, label: str) -> None:
    """No kernel of the run is named TF32: convolutions (cuDNN) and the GEMMs
    of the linears and the LSTM gates (cuBLAS) run in fp32."""
    tf32 = [n for n in names if "tf32" in n.lower()]
    if tf32:
        raise AssertionError(f"{label}: TF32 kernels {tf32}")


def baselines_phase(card: str) -> dict:
    """Phase 10: Diffusion Policy, ACT, BC-GMM, BC-Transformer-GMM and
    BC-RNN-GMM at their templates' widths: each serves 16-env requests,
    rolls out one single-env episode and takes 10 train steps (K1 / K1f /
    K2 launches 0), timed and profiled; one fp32 step of DP, ACT and
    BC-Transformer-GMM held against the CPU, a DDPM chain from the same
    noise held against the CPU, then DP through scripts/train.py."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.rollout import rollout_with_stats
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    assert not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 must stay off"
    items = SequenceItems(2 * BATCH, seed=25)
    results = {}
    for label, algo_name, over in BASELINES:
        t_start, dp = time.perf_counter(), label == "diffusion_policy"
        algo = algo_factory(algo_name, baseline_config(algo_name, over), OBS_SHAPES,
                            ac_dim=AC_DIM)  # CUDA by default
        assert algo.device.type == "cuda"
        params = sum(p.numel() for p in algo.nets.parameters())
        r = results[label] = {"class": type(algo).__name__, "params": params}
        if dp:
            unet = sum(p.numel() for p in algo.nets.unet.parameters())
            assert unet == UNET_PARAMS and algo.num_inference_timesteps == 100, unet
            assert (algo.To, algo.Tp, algo.Ta) == (2, 16, 8) and algo.ema_enabled
        rng = np.random.default_rng(26)
        requests = [baseline_obs(algo, rng, N_ENVS) for _ in range(BASELINE_REQUESTS)]
        queue = hasattr(algo, "reset")
        loader = DataLoader(items, BATCH, seed=5)

        # the main path: requests, one episode, 10 train steps, counted
        zero_launch_counts()
        served = [algo.get_action(o) for o in requests]
        env = SyntheticKitchenEnv(seed=27)
        policy = RolloutPolicy(algo, lang_encoder=LangEncoder(device=algo.device))
        if queue:
            algo.reset()  # the rollout does not (reference fault (a))
        t0 = time.perf_counter()
        rollout, _ = rollout_with_stats(policy, {"SyntheticKitchen": env},
                                        horizon=BASELINE_HORIZON, num_episodes=1,
                                        frame_stack=baseline_frame_stack(algo))
        episode_s = time.perf_counter() - t0
        opt = optimizer_counts()  # requests and the episode step no optimizer
        log = run_epoch(algo, loader, epoch=1, num_steps=BASELINE_STEPS)
        counts = launch_counts()
        opt = {k: v - opt[k] for k, v in optimizer_counts().items()}
        if counts != (0, 0, 0):
            raise AssertionError(f"{label}: launches (K1, K1f, K2) {counts}")
        assert_fused_optimizer(label, opt, BASELINE_STEPS * len(algo.optimizers()))
        if not all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all() for a in served):
            raise AssertionError(f"{label}: served actions not finite of shape (16, 12)")
        stats = rollout["SyntheticKitchen"]
        if stats["Horizon"] != BASELINE_HORIZON or not np.isfinite(stats["Return"]):
            raise AssertionError(f"{label}: episode {stats}")
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{label}: non-finite step log {log}")

        def fresh():
            if queue:
                algo.reset()
            return algo.get_action(requests[0])

        # Diffusion Policy's new chunks (~0.8 s each) are warm from the
        # requests served above: no warm-up calls
        new_ms = host_ms(fresh, reps=3 if dp else 20, warmup=not dp)
        queued_ms = None
        if queue:
            fresh()
            times = []
            while algo._action_queue:
                t0 = time.perf_counter()
                algo.get_action(requests[0])
                times.append((time.perf_counter() - t0) * 1e3)
            queued_ms = statistics.median(times)
        request_busy, request_kernels = profile_device(fresh, 1 if dp else 2, warmup=not dp)
        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=BASELINE_STEPS)
        step_busy, kernels, convs, names = profile_convs(lambda: algo.train_on_batch(batch, 1),
                                                         3)
        assert_no_tf32(list(kernels) + names + list(request_kernels), label)
        if dp:
            assert_fp32_convs(names, label)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
        request_top = dict(sorted(request_kernels.items(), key=lambda kv: -kv[1])[:4])
        r.update({
            "launches": counts, "optimizer": opt, "log": log, "episode": stats,
            "episode_s": episode_s, "new_request_ms": new_ms, "queued_request_ms": queued_ms,
            "request_busy_ms": request_busy,
            "request_idle_share": None if request_busy is None else 1 - request_busy / new_ms,
            "step_ms": step_ms, "step_busy_ms": step_busy,
            "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
            "step_conv_ms": sum(convs.values()), "step_top_ops_ms": top,
            "request_top_ops_ms": request_top})
        print(f"baseline {label} ({r['class']}, {params / 1e6:.2f} M parameters): "
              f"{BASELINE_REQUESTS} requests of {N_ENVS} envs, one {BASELINE_HORIZON}-step "
              f"episode (Return {stats['Return']:.3f}, {episode_s:.2f} s) and "
              f"{BASELINE_STEPS} steps of batch {BATCH}, launches (K1, K1f, K2) {counts}, "
              f"the optimizer's kernels {opt['launches']} over {opt['fused_steps']} steps; "
              f"Loss {log['Loss']:.4f}; {N_ENVS}-env request {new_ms:.3f} ms with a new "
              f"sample (device busy {request_busy} ms, idle share {r['request_idle_share']}), "
              f"{queued_ms} ms from the queue; step {step_ms:.3f} ms (device busy {step_busy} "
              f"ms, idle share {r['step_idle_share']}, convolution kernels "
              f"{r['step_conv_ms']:.3f} ms); top {top}; the request's top {request_top} "
              f"[{card}]")
        r["seconds"] = {"served_and_timed": time.perf_counter() - t_start}
        if dp:
            t0 = time.perf_counter()
            r["ddim"] = dp_ddim_request(card, algo, requests[0])
            r["seconds"]["ddim"] = time.perf_counter() - t0
        print(f"baseline {label}: seconds {r['seconds']}")
        del algo, policy, batch, served
        torch.cuda.empty_cache()
    results["hold"] = baseline_holds(items)
    t0 = time.perf_counter()
    results["script"] = dp_script(card)
    results["script"]["seconds"] = time.perf_counter() - t0
    print(f"baseline diffusion_policy script: {results['script']['seconds']:.1f} s in all")
    return results


def dp_ddim_request(card: str, algo, obs) -> dict:
    """One 16-env request of the same DP weights sampled by DDIM in 10 steps."""
    from lipvq_tpu_torch.algo import algo_factory

    ddim = algo_factory("diffusion_policy", baseline_config("diffusion_policy", {"ddim": {
        "enabled": True, "num_inference_timesteps": DP_DDIM_STEPS}}), OBS_SHAPES,
        ac_dim=AC_DIM)
    ddim.deserialize(algo.serialize())
    assert ddim.use_ddim and ddim.num_inference_timesteps == DP_DDIM_STEPS

    def fresh():
        ddim.reset()
        return ddim.get_action(obs)

    zero_launch_counts()
    act = fresh()
    counts = launch_counts()
    assert counts == (0, 0, 0) and act.shape == (N_ENVS, AC_DIM) and np.isfinite(act).all()
    ms = host_ms(fresh, reps=10)
    print(f"baseline diffusion_policy DDIM: a {N_ENVS}-env request with a new "
          f"{DP_DDIM_STEPS}-step DDIM sample {ms:.3f} ms [{card}]")
    return {"request_ms": ms, "launches": counts}


def dp_sample_parity(algo, cpu, rng) -> dict:
    """The 100-step DDPM chain of the card's EMA net and of the CPU algo
    ``cpu`` given the card's weights, from the same obs and the same noise
    (initial sample and per-step draws)."""
    cpu.deserialize(algo.serialize())
    n, steps = BASELINE_CPU_ENVS, algo.num_inference_timesteps
    obs = baseline_obs(algo, rng, n)
    gen = torch.Generator().manual_seed(28)
    shape = (n, algo.Tp, AC_DIM)
    noise = (torch.randn(shape, generator=gen), torch.randn((steps, *shape), generator=gen))
    got = algo.sample(algo._put_infer(obs), noise=tuple(x.cuda() for x in noise)).cpu()
    want = cpu.sample(cpu._put_infer(obs), noise=noise)
    err = float((got - want).abs().max())
    if not err <= DP_SAMPLE_ATOL:
        raise AssertionError(f"DDPM sample: card against CPU max abs {err}")
    print(f"baseline diffusion_policy: a {steps}-step DDPM chain from the same noise on the "
          f"card and on the CPU agrees to {err:.3g} (limit {DP_SAMPLE_ATOL})")
    return {"max_abs_err": err}


def baseline_holds(items) -> dict:
    """One fp32 step of DP, ACT and BC-Transformer-GMM on the card held
    against the CPU step by ``hold_step`` (the same draws on both devices,
    no warmup, no dropout), batch 16; for DP, each device's EMA net also
    equals decay * start + (1 - decay) * its own new parameters, and then
    the two DP algos, given the card's weights, sample a DDPM chain from the
    same noise (``dp_sample_parity``)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader

    results = {}
    for label, algo_name, over in BASELINES:
        if label not in ("diffusion_policy", "act", "bc_transformer_gmm"):
            continue
        t0 = time.perf_counter()
        card, cpu = (algo_factory(algo_name, baseline_config(algo_name, over, hold=True),
                                  OBS_SHAPES, ac_dim=AC_DIM, device=d) for d in (None, "cpu"))
        batch = card.process_batch_for_training(
            next(iter(DataLoader(items, BASELINE_HOLD_BATCH, seed=7))))
        gen = torch.Generator().manual_seed(29)
        draws, zero = None, []
        if label == "diffusion_policy":
            draws = {"noise": torch.randn(batch["actions"].shape, generator=gen),
                     "timesteps": torch.randint(cpu.scheduler.num_train_timesteps,
                                                (BASELINE_HOLD_BATCH,), generator=gen)}
            ema_start = {n: p.detach().cpu().clone() for n, p in cpu.ema_nets.named_parameters()}
        elif label == "act":
            draws = {"eps": torch.randn((BASELINE_HOLD_BATCH, cpu.nets.latent_dim),
                                        generator=gen)}
            zero = [n for n, _ in cpu.nets.named_parameters()
                    if n.endswith(("_attn.key.bias", "_cross.key.bias"))]
            assert len(zero) == 4 + 2 * 7, zero
        losses, worst = hold_step(card, cpu, batch, zero=zero, draws=draws)
        if label == "diffusion_policy":
            decay = cpu.ema_decay(1)
            for a in (card, cpu):
                for (n, e), p in zip(a.ema_nets.named_parameters(), a.nets.parameters()):
                    want = decay * ema_start[n] + (1 - decay) * p.detach().cpu()
                    assert_allclose(e.detach().cpu(), want, rtol=1e-6, atol=1e-7,
                                    err_msg=f"EMA of {n}")
        results[label] = {"losses": losses, "worst": worst}
        if label == "diffusion_policy":
            results[label]["ddpm_vs_cpu"] = dp_sample_parity(card, cpu,
                                                             np.random.default_rng(26))
        results[label]["seconds"] = time.perf_counter() - t0
        print(f"baseline {label} train parity: one fp32 step on the card == the CPU step "
              f"(hold_step: losses rtol 1e-4, gradients, each device's Adam step, buffers)"
              + (", the EMA net on each device" if label == "diffusion_policy" else "")
              + f"; losses {losses}; worst {worst}; {results[label]['seconds']:.1f} s")
        del card, cpu
    return results


def dp_script(card: str) -> dict:
    """scripts/train.py with the Diffusion Policy template over a seeded
    export (flagship obs): 2 epochs x 10 steps, one checkpoint, rollouts off
    (the script's single-env rollout raises for a baseline, reference fault
    (d)); the checkpoint rebuilds bit-equal, the EMA net included."""
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.utils import file_utils, train_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        obs_shapes = {k: tuple(s) for k, s in OBS_SHAPES.items() if k != "lang_emb"}
        root = make_synthetic_export(os.path.join(tmp, "export"), n_demos=SCRIPT_DEMOS,
                                     demo_len=SCRIPT_DEMO_LEN, action_dim=AC_DIM,
                                     obs_key_shapes=obs_shapes, lang="synthetic dp task",
                                     seed=30)
        cfg = json.loads(baseline_config("diffusion_policy", {}).dump())
        cfg["train"].update({"data": root, "output_dir": os.path.join(tmp, "out"),
                             "num_epochs": SCRIPT_EPOCHS, "hdf5_cache_mode": "low_dim"})
        exp = cfg["experiment"]
        exp.update({"name": "chip_smoke_dp", "epoch_every_n_steps": SCRIPT_STEPS,
                    "render_video": False, "validate": False})
        exp["logging"].update({"terminal_output_to_txt": False, "log_tb": False})
        exp["save"].update({"enabled": True, "every_n_epochs": SCRIPT_EPOCHS})
        exp["rollout"]["enabled"] = False
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

        seen = {}
        run_epoch = train_utils.run_epoch

        def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
            seen["algo"] = model
            return run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)

        out = io.StringIO()
        train_utils.run_epoch = observed_run_epoch
        try:
            # the main path: the training script, counted
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                ckpt_dir = train_script.main(["--config", cfg_path])
            script_s = time.perf_counter() - t0
            counts = launch_counts()
        except BaseException:
            print(out.getvalue()[-8000:])
            raise
        finally:
            train_utils.run_epoch = run_epoch
        if counts != (0, 0, 0):
            raise AssertionError(f"DP script: launches (K1, K1f, K2) {counts}")
        names = sorted(os.listdir(ckpt_dir))
        if not {f"model_epoch_{SCRIPT_EPOCHS}.ckpt", "latest_full.state"} <= set(names):
            raise AssertionError(f"DP script: checkpoint files {names}")
        with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
            logs = json.load(f)
        if not all(np.isfinite(v).all() for v in logs.values()):
            raise AssertionError(f"DP script: non-finite logs {logs}")
        algo = seen["algo"]
        t0 = time.perf_counter()
        reloaded, _ = file_utils.policy_from_checkpoint(
            os.path.join(ckpt_dir, f"model_epoch_{SCRIPT_EPOCHS}.ckpt"))
        load_s = time.perf_counter() - t0
        want, got = algo.serialize(), reloaded.serialize()
        ema = sum(k.startswith("ema.") for k in want)
        if want.keys() != got.keys() or not ema or not all(
                torch.equal(want[k], got[k]) for k in want):
            raise AssertionError("DP script: the reloaded checkpoint differs from the "
                                 "in-process algo")
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"model_epoch_{SCRIPT_EPOCHS}.ckpt"))
        del reloaded, algo
    timing = {k: per_step_ms(logs, f"Timing_Stats/Train_{k}", SCRIPT_STEPS)
              for k in ("Data_Loading", "Process_Batch", "Train_Batch", "Log_Info")}
    print(f"baseline diffusion_policy script: {SCRIPT_EPOCHS} epochs x {SCRIPT_STEPS} steps over "
          f"an export of {SCRIPT_DEMOS} demos x {SCRIPT_DEMO_LEN} steps in {script_s:.1f} s, "
          f"launches (K1, K1f, K2) {counts}; the checkpoint ({ckpt_bytes / 1e6:.1f} MB, {ema} "
          f"EMA tensors) reloads bit-equal in {load_s:.2f} s; Train/Loss {logs['Train/Loss']}; "
          f"Time_* per step {({k: [round(x, 3) for x in v] for k, v in timing.items()})} ms "
          f"[{card}]")
    return {"launches": counts, "script_s": script_s, "ckpt_bytes": ckpt_bytes,
            "load_s": load_s, "time_ms_per_step": timing, "loss": logs["Train/Loss"]}

# phase 11: the offline-RL and hierarchical algorithms at their templates' widths
RL_ALGOS = ("td3_bc", "iql", "cql", "bcq", "gl", "hbc", "iris")
RL_HOLD = ("td3_bc", "iql", "cql", "bcq", "iris")
RL_SEQ = 10  # GL / HBC / IRIS read next_obs[:, subgoal_horizon - 1]: windows of 10
RL_STEPS, RL_REQUESTS, RL_HORIZON, RL_HOLD_BATCH = 10, 5, 40, 16


def rl_config(algo: str, hold: bool = False):
    """exps/templates/{algo}.json at its widths on the flagship's low-dim
    obs, the hierarchical ones with ``train.seq_length`` at their subgoal
    horizon (the templates' 1 cannot reach it, ROADMAP queue 3). ``hold``:
    HBC's and IRIS's actor without warmup (the template warms up over 10000
    steps: the held step would not move it)."""
    cfg = baseline_config(algo, {})
    with cfg.unlocked():
        if algo in ("gl", "hbc", "iris"):
            cfg.train.seq_length = RL_SEQ
        if hold and algo in ("hbc", "iris"):
            cfg.algo.actor.optim_params.policy.learning_rate.num_warmup_steps = 0
    return cfg


class RLItems:
    """In-memory transition windows shaped like SequenceDataset's with
    ``hdf5_load_next_obs``: obs and next_obs leaves [10, ...] (next_obs the
    obs one step on), actions [10, 12], rewards and dones [10] (one window
    in eight ends in a done), made in bulk from a seed."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        obs = random_obs(rng, (n, RL_SEQ + 1))
        actions = rng.uniform(-1, 1, (n, RL_SEQ, AC_DIM)).astype(np.float32)
        rewards = rng.standard_normal((n, RL_SEQ)).astype(np.float32)
        dones = np.zeros((n, RL_SEQ), np.float32)
        dones[::8, -1] = 1.0
        self.items = [{"obs": {k: v[i, :-1] for k, v in obs.items()},
                       "next_obs": {k: v[i, 1:] for k, v in obs.items()},
                       "actions": actions[i], "rewards": rewards[i], "dones": dones[i]}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def rl_phase(card: str) -> dict:
    """Phase 11: TD3-BC, IQL, CQL, BCQ, GL, HBC and IRIS at their templates'
    widths: each serves 16-env requests (GL: subgoal predictions), rolls out
    one single-env episode (not GL, a planner) and takes 10 train steps (K1 /
    K1f / K2 launches 0), timed and profiled; one fp32 step of TD3-BC (two),
    IQL, CQL, BCQ and IRIS held against the CPU; then TD3-BC through
    scripts/train.py."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.rollout import rollout_with_stats
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    assert not torch.backends.cuda.matmul.allow_tf32, "cuBLAS TF32 must stay off"
    items = RLItems(2 * BATCH, seed=31)
    results = {}
    for name in RL_ALGOS:
        t_start = time.perf_counter()
        algo = algo_factory(name, rl_config(name), OBS_SHAPES, ac_dim=AC_DIM)  # CUDA
        assert algo.device.type == "cuda"
        params = sum(p.numel() for p in algo.nets.parameters())
        r = results[name] = {"class": type(algo).__name__, "params": params}
        rng = np.random.default_rng(32)
        requests = [random_obs(rng, (N_ENVS,)) for _ in range(RL_REQUESTS)]
        loader = DataLoader(items, BATCH, seed=5)
        hier = hasattr(algo, "reset")  # HBC / IRIS: the subgoal state

        def serve(obs):
            if name == "gl":
                out = algo.get_subgoal_predictions(obs)
                return np.concatenate([v.reshape(N_ENVS, -1).cpu().numpy()
                                       for v in out.values()], axis=1)
            return algo.get_action(obs)

        # the main path: requests, one episode, 10 train steps, counted
        zero_launch_counts()
        served = [serve(o) for o in requests]
        stats = episode_s = None
        if name != "gl":
            policy = RolloutPolicy(algo, lang_encoder=LangEncoder(device=algo.device))
            if hier:
                algo.reset()  # the rollout does not (reference fault (a))
            t0 = time.perf_counter()
            rollout, _ = rollout_with_stats(policy, {"SyntheticKitchen": SyntheticKitchenEnv(
                seed=27)}, horizon=RL_HORIZON, num_episodes=1)
            episode_s = time.perf_counter() - t0
            stats = rollout["SyntheticKitchen"]
        log = run_epoch(algo, loader, epoch=1, num_steps=RL_STEPS)
        counts = launch_counts()
        if counts != (0, 0, 0):
            raise AssertionError(f"{name}: launches (K1, K1f, K2) {counts}")
        width = 791 if name == "gl" else AC_DIM
        if not all(a.shape == (N_ENVS, width) and np.isfinite(a).all() for a in served):
            raise AssertionError(f"{name}: served outputs not finite of shape (16, {width})")
        if stats is not None and (stats["Horizon"] != RL_HORIZON
                                  or not np.isfinite(stats["Return"])):
            raise AssertionError(f"{name}: episode {stats}")
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{name}: non-finite step log {log}")

        def fresh():  # HBC / IRIS: a request that plans a new subgoal
            if hier:
                algo.reset()
            serve(requests[0])

        new_ms = host_ms(fresh, reps=10)
        cached_ms = None
        if hier:  # calls 1-9 of an interval of 10 reuse the subgoal
            fresh()
            cached_ms = host_ms(lambda: serve(requests[0]), reps=8, warmup=False)
        request_busy, request_kernels = profile_device(fresh, 2)
        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=RL_STEPS)
        step_busy, kernels = profile_device(lambda: algo.train_on_batch(batch, 1), 2)
        assert_no_tf32(list(kernels) + list(request_kernels), name)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
        r.update({
            "launches": counts, "log": log, "episode": stats, "episode_s": episode_s,
            "request_ms": new_ms, "cached_subgoal_request_ms": cached_ms,
            "request_busy_ms": request_busy,
            "request_idle_share": None if request_busy is None else 1 - request_busy / new_ms,
            "step_ms": step_ms, "step_busy_ms": step_busy,
            "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
            "step_top_ops_ms": top,
            "request_top_ops_ms": dict(sorted(request_kernels.items(),
                                              key=lambda kv: -kv[1])[:4]),
            "seconds": time.perf_counter() - t_start})
        print(f"rl {name} ({r['class']}, {params / 1e6:.3f} M parameters): {RL_REQUESTS} "
              f"requests of {N_ENVS} envs"
              + ("" if stats is None else f", one {RL_HORIZON}-step episode (Return "
                 f"{stats['Return']:.3f}, {episode_s:.2f} s)")
              + f" and {RL_STEPS} steps of batch {BATCH}, launches (K1, K1f, K2) {counts}; "
              f"Loss {log['Loss']:.4f}; {N_ENVS}-env request {new_ms:.3f} ms"
              + (" with a new subgoal" if hier else "")
              + f" (device busy {request_busy} ms, idle share {r['request_idle_share']})"
              + ("" if cached_ms is None else f", {cached_ms:.3f} ms on the current subgoal")
              + f"; step {step_ms:.3f} ms (device busy {step_busy} ms, idle share "
              f"{r['step_idle_share']}); top {top}; {r['seconds']:.1f} s [{card}]")
        del algo, batch, served
    results["hold"] = rl_holds(items)
    t0 = time.perf_counter()
    results["script"] = td3_script(card)
    results["script"]["seconds"] = time.perf_counter() - t0
    return results


def rl_draws(name: str, gen, b: int) -> dict | None:
    """Seeded draws for one step of ``name`` at batch ``b`` (the template's
    latent 14 and 10 candidates for BCQ and IRIS's value BCQ)."""
    def bcq():
        return {"vae": torch.randn((b, 14), generator=gen),
                "next": torch.randn((b * 10, 14), generator=gen),
                "perturb": torch.randn((b, 14), generator=gen)}

    if name == "td3_bc":
        return {"noise": torch.randn((b, AC_DIM), generator=gen)}
    if name == "cql":
        out = {k: torch.randn((b, AC_DIM), generator=gen)
               for k in ("next_eps", "pi_eps", "actor_eps")}
        out["rand"] = torch.rand((10, b, AC_DIM), generator=gen) * 2 - 1
        return out
    if name == "bcq":
        return bcq()
    if name == "iris":
        return {"planner": {"noise": torch.randn((b, 14), generator=gen)}, "value": bcq()}
    return None


def rl_holds(items) -> dict:
    """One fp32 step of TD3-BC (two: the second skips the actor), IQL, CQL,
    BCQ and IRIS (its GL-VAE planner, BC-GMM actor and BCQ value) on the card
    held against the CPU step by ``hold_step`` (the same weights and draws,
    batch 16; the target networks by polyak on each device), no kernel of
    the card's steps named TF32."""
    from torch.profiler import ProfilerActivity, profile

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader

    results = {}
    loader = iter(DataLoader(items, RL_HOLD_BATCH, seed=7))
    for name in RL_HOLD:
        t0 = time.perf_counter()
        card, cpu = (algo_factory(name, rl_config(name, hold=True), OBS_SHAPES, ac_dim=AC_DIM,
                                  device=d) for d in (None, "cpu"))
        gen = torch.Generator().manual_seed(33)
        held = []
        for _ in range(2 if name == "td3_bc" else 1):
            batch = card.process_batch_for_training(next(loader))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                held.append(hold_step(card, cpu, batch, draws=rl_draws(name, gen, RL_HOLD_BATCH),
                                      targets=polyak_pairs(cpu)))
            assert_no_tf32(list(device_busy(prof)[1]), f"{name} hold")
        actor_losses = [h[0]["actor_loss"] for h in held if "actor_loss" in h[0]]
        if name == "td3_bc" and (actor_losses[0] == 0 or actor_losses[1] != 0):
            raise AssertionError(f"TD3-BC: actor losses {actor_losses} (the actor moves on "
                                 f"the first step only)")
        results[name] = {"losses": [h[0] for h in held], "worst": [h[1] for h in held],
                         "seconds": time.perf_counter() - t0}
        print(f"rl {name} train parity: {len(held)} fp32 step(s) on the card == the CPU's "
              f"(hold_step: losses rtol 1e-4, gradients, each device's Adam step, the target "
              f"networks by polyak, buffers), no TF32 kernel; losses "
              f"{results[name]['losses']}; worst {results[name]['worst']}; "
              f"{results[name]['seconds']:.1f} s")
        del card, cpu
    return results


def td3_script(card: str) -> dict:
    """scripts/train.py with the TD3-BC template (its widths, obs and batch)
    over a seeded export with next_obs, rewards and dones: 2 epochs x 10
    steps, a checkpoint each epoch, rollouts off (the script's single-env
    rollout raises for a baseline, reference fault (d)). The last checkpoint
    reloads bit-equal (the target networks included); a fresh algo loaded
    from ``latest_full.state`` takes the writer's next two steps with losses
    within rtol 1e-5, its actor moved on the first (step 20) only."""
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.utils import file_utils, train_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    with tempfile.TemporaryDirectory(prefix="chip_smoke_td3_") as tmp:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "exps", "templates",
                               "td3_bc.json")) as f:
            cfg = json.load(f)
        obs_shapes = {k: tuple(s) for k, s in OBS_SHAPES.items()
                      if k in cfg["observation"]["modalities"]["obs"]["low_dim"]}
        root = make_synthetic_export(os.path.join(tmp, "export"), n_demos=SCRIPT_DEMOS,
                                     demo_len=SCRIPT_DEMO_LEN, action_dim=AC_DIM,
                                     obs_key_shapes=obs_shapes, seed=34, transitions=True)
        cfg["train"].update({"data": root, "output_dir": os.path.join(tmp, "out"),
                             "num_epochs": SCRIPT_EPOCHS})
        cfg["experiment"] = {"name": "chip_smoke_td3", "epoch_every_n_steps": SCRIPT_STEPS,
                             "render_video": False, "validate": False,
                             "logging": {"terminal_output_to_txt": False, "log_tb": False},
                             "save": {"enabled": True, "every_n_epochs": 1},
                             "rollout": {"enabled": False}}
        cfg_path = os.path.join(tmp, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)

        seen = {}
        run_epoch = train_utils.run_epoch

        def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
            seen["algo"], seen["loader"] = model, loader
            return run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)

        out = io.StringIO()
        train_utils.run_epoch = observed_run_epoch
        try:
            # the main path: the training script, counted
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                ckpt_dir = train_script.main(["--config", cfg_path])
            script_s = time.perf_counter() - t0
            counts = launch_counts()
        except BaseException:
            print(out.getvalue()[-8000:])
            raise
        finally:
            train_utils.run_epoch = run_epoch
        if counts != (0, 0, 0):
            raise AssertionError(f"TD3-BC script: launches (K1, K1f, K2) {counts}")
        names = sorted(os.listdir(ckpt_dir))
        if not {f"model_epoch_{SCRIPT_EPOCHS}.ckpt", "latest_full.state"} <= set(names):
            raise AssertionError(f"TD3-BC script: checkpoint files {names}")
        with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
            logs = json.load(f)
        if not all(np.isfinite(v).all() for v in logs.values()):
            raise AssertionError(f"TD3-BC script: non-finite logs {logs}")
        algo = seen["algo"]
        ckpt = os.path.join(ckpt_dir, f"model_epoch_{SCRIPT_EPOCHS}.ckpt")
        reloaded, _ = file_utils.policy_from_checkpoint(ckpt)
        want, got = algo.serialize(), reloaded.serialize()
        targets = sum(k.startswith("target.") for k in want)
        if want.keys() != got.keys() or not targets or not all(
                torch.equal(want[k], got[k]) for k in want):
            raise AssertionError("TD3-BC script: the reloaded checkpoint differs from the "
                                 "in-process algo")
        reloaded.deserialize_full(torch.load(os.path.join(ckpt_dir, "latest_full.state"),
                                             weights_only=True))
        if reloaded.step != algo.step or algo.step != SCRIPT_EPOCHS * SCRIPT_STEPS:
            raise AssertionError(f"TD3-BC script: steps {algo.step} / {reloaded.step}")
        gen = torch.Generator().manual_seed(35)
        resumed = []
        for _ in range(2):
            batch = algo.process_batch_for_training(next(iter(seen["loader"])))
            draws = rl_draws("td3_bc", gen, batch["actions"].shape[0])
            want = algo.train_on_batch(batch, 3, draws=draws)["losses"]
            got = reloaded.train_on_batch(batch, 3, draws=draws)["losses"]
            for k in want:
                np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                           err_msg=f"resumed {k}")
            resumed.append({k: float(v) for k, v in got.items()})
        if resumed[0]["actor_loss"] == 0 or resumed[1]["actor_loss"] != 0:
            raise AssertionError(f"TD3-BC resume: the actor-update phase {resumed}")
        ckpt_bytes = os.path.getsize(ckpt)
        del reloaded, algo, seen
    timing = {k: per_step_ms(logs, f"Timing_Stats/Train_{k}", SCRIPT_STEPS)
              for k in ("Data_Loading", "Process_Batch", "Train_Batch", "Log_Info")}
    print(f"rl td3_bc script: {SCRIPT_EPOCHS} epochs x {SCRIPT_STEPS} steps over an export of "
          f"{SCRIPT_DEMOS} demos x {SCRIPT_DEMO_LEN} steps with next_obs / rewards / dones in "
          f"{script_s:.1f} s, launches (K1, K1f, K2) {counts}; the checkpoint "
          f"({ckpt_bytes / 1e6:.2f} MB, {targets} target tensors) reloads bit-equal; a fresh "
          f"algo from latest_full.state takes the writer's steps 21-22 (losses within rtol "
          f"1e-5, the actor moved on 21 only): {resumed}; Train/Loss {logs['Train/Loss']}; "
          f"Time_* per step {({k: [round(x, 3) for x in v] for k, v in timing.items()})} ms "
          f"[{card}]")
    return {"launches": counts, "script_s": script_s, "ckpt_bytes": ckpt_bytes,
            "resumed": resumed, "time_ms_per_step": timing, "loss": logs["Train/Loss"]}


# phase 12, MCR: the representation workspace at its defaults (112 x 112
# crops, batch 16, embed 128) with langweight 0.1, the pretrainer at batch
# 16, and the grafted policy at the mcr template's widths with one camera
MCR_STEPS, MCR_RESUME_STEPS, MCR_POLICY_STEPS, MCR_REQUESTS = 20, 2, 10, 5
MCR_CAM, MCR_FRAME = "robot0_agentview_left_image", (128, 128, 3)
MCR_LOW_DIM = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "object")
MCR_SHAPES = {**{k: OBS_SHAPES[k] for k in MCR_LOW_DIM}, MCR_CAM: list(MCR_FRAME)}
MCR_BATCH = 16  # the image protocol's batch: the template's 100 is a low-dim batch
MCR_HOLD_BATCH = 4


def mcr_config(snapshot: str, hold: bool = False):
    """exps/templates/mcr.json with one 128 x 128 rgb camera (the template
    names none, so the graft would have no target), the workspace's
    snapshot as ``pretrained_ckpt`` and the image protocol's batch; ``hold``:
    no dropout and no warmup, for the card-vs-CPU step."""
    from lipvq_tpu_torch.config import config_factory

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "exps", "templates",
                           "mcr.json")) as f:
        template = json.load(f)
    template["observation"]["modalities"]["obs"]["rgb"] = [MCR_CAM]
    template["algo"]["mcr"]["pretrained_ckpt"] = snapshot
    template["train"]["batch_size"] = MCR_BATCH
    if hold:
        template["algo"]["transformer"].update(
            {"emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0})
    cfg = config_factory("mcr", template)
    if hold:
        with cfg.unlocked():
            cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 0
    return cfg


class MCRItems:
    """Sequence items of the grafted policy: the template's low-dim keys and
    the uint8 camera, [10, ...] windows, 12-d actions, made from a seed."""

    def __init__(self, n: int, t: int, seed: int):
        rng = np.random.default_rng(seed)
        low = {k: rng.standard_normal((n, t, *OBS_SHAPES[k]), dtype=np.float32)
               for k in MCR_LOW_DIM}
        frames = rng.integers(0, 256, (n, t, *MCR_FRAME), dtype=np.uint8)
        actions = rng.uniform(-1, 1, (n, t, AC_DIM)).astype(np.float32)
        self.items = [{"obs": {**{k: v[i] for k, v in low.items()}, MCR_CAM: frames[i]},
                       "actions": actions[i]} for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def mcr_phase(card: str) -> dict:
    """Phase 12: the MCR pipeline on the card. The workspace trains 20 steps
    on the synthetic corpus in the manifest layout, its snapshot reloads
    bit-equal and the reloaded workspace takes 2 more steps; the pretrainer
    takes 20 steps on the buffer's frames; MCRTransformerGMM at the
    template's widths (6 x 512, 8 heads, context 10) with one 128 x 128
    camera grafts the snapshot's trunk, serves 5 requests of 16 envs and
    takes 10 run_epoch steps at batch 16; one fp32 step is held against the
    CPU by ``hold_step`` (the visual core's gradients as wholes, the
    keypoint conv's bias, of exact gradient 0, as zeros). K1 / K1f / K2
    launch 0 times on every path."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.mcr import MCRPretrainer, flatten
    from lipvq_tpu_torch.algo.mcr_data import build_synthetic_corpus
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.scripts.train_mcr_representation import RepresentationWorkspace
    from lipvq_tpu_torch.utils import obs_utils
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mcr_") as tmp:
        corpus = build_synthetic_corpus(tmp)  # the manifest layout: the card has no h5py
        assert os.path.isfile(os.path.join(tmp, "manifest.csv"))

        # the workspace at its defaults, counted
        ws = RepresentationWorkspace(corpus, langweight=0.1)  # CUDA by default
        assert ws.device.type == "cuda" and ws.train_buffer.out_hw == (112, 112)
        zero_launch_counts()
        t0 = time.perf_counter()
        hist = ws.train(MCR_STEPS, log_every=0)
        torch.cuda.synchronize()
        ws_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != (0, 0, 0) or not all(np.isfinite(v) for h in hist for v in h.values()):
            raise AssertionError(f"mcr workspace: launches {counts}, history {hist[-1]}")
        snap = os.path.join(tmp, "mcr_snapshot.pt")
        ws.save_snapshot(snap)
        fresh = RepresentationWorkspace(corpus, langweight=0.1, seed=1)
        fresh.load_snapshot(snap)
        for (k, a), b in zip(ws.encoder.state_dict().items(),
                             fresh.encoder.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"mcr snapshot: {k} differs after the reload")
        zero_launch_counts()
        resumed = fresh.train(MCR_RESUME_STEPS, log_every=0)
        if launch_counts() != (0, 0, 0) or fresh.global_step != MCR_STEPS + MCR_RESUME_STEPS \
                or not all(np.isfinite(v) for h in resumed for v in h.values()):
            raise AssertionError(f"mcr resume: {resumed}")
        ws_busy, ws_kernels = profile_device(lambda: fresh.train(1, log_every=0), 2)
        ev = fresh.evaluate()
        results["workspace"] = {
            "launches": counts, "first": hist[0], "last": hist[-1], "resumed": resumed[-1],
            "step_ms": ws_s * 1e3 / MCR_STEPS, "step_busy_ms": ws_busy,
            "step_idle_share": None if ws_busy is None else 1 - ws_busy / (ws_s * 1e3 / MCR_STEPS),
            "evaluate": ev, "snapshot_bytes": os.path.getsize(snap),
            "top_ops_ms": dict(sorted(ws_kernels.items(), key=lambda kv: -kv[1])[:5])}
        print(f"mcr workspace: {MCR_STEPS} steps (112 x 112, batch 16, embed 128, langweight "
              f"0.1) on the manifest corpus, launches (K1, K1f, K2) {counts}; first {hist[0]}, "
              f"last {hist[-1]}; {results['workspace']['step_ms']:.2f} ms per step (device "
              f"busy {ws_busy} ms, idle share {results['workspace']['step_idle_share']}); "
              f"snapshot ({os.path.getsize(snap)} bytes) reloaded bit-equal, {MCR_RESUME_STEPS} "
              f"more steps {resumed[-1]}; evaluate {ev} [{card}]")
        del ws

        # the pretrainer on the buffer's frames: anchor s1, positive s2, far start
        pre = MCRPretrainer()  # CUDA by default
        rng = np.random.default_rng(41)
        batches = []
        for _ in range(MCR_STEPS):
            frames, _ = fresh.train_buffer.sample_batch(MCR_BATCH)
            batches.append((np.ascontiguousarray(frames[:, [3, 4, 0]]),
                            rng.uniform(-1, 1, (MCR_BATCH, AC_DIM)).astype(np.float32)))
        zero_launch_counts()
        t0 = time.perf_counter()
        pre_hist = [pre.train_step(f, a) for f, a in batches]
        pre_s = time.perf_counter() - t0
        counts = launch_counts()
        if counts != (0, 0, 0) or not all(np.isfinite(v) for h in pre_hist for v in h.values()):
            raise AssertionError(f"mcr pretrainer: launches {counts}, history {pre_hist[-1]}")
        pre_busy, _ = profile_device(lambda: pre.train_step(*batches[0]), 2)
        results["pretrainer"] = {"launches": counts, "first": pre_hist[0], "last": pre_hist[-1],
                                 "step_ms": pre_s * 1e3 / MCR_STEPS, "step_busy_ms": pre_busy}
        print(f"mcr pretrainer: {MCR_STEPS} steps at batch {MCR_BATCH} (3 x 112 x 112 frames "
              f"each), launches {counts}; first {pre_hist[0]}, last {pre_hist[-1]}; "
              f"{pre_s * 1e3 / MCR_STEPS:.2f} ms per step (device busy {pre_busy} ms) [{card}]")
        del pre, fresh, batches

        # the grafted policy at the template's widths: graft, serve, train, counted
        cfg = mcr_config(snap)
        obs_utils.initialize_obs_utils_with_config(cfg)
        algo = algo_factory("mcr", cfg, MCR_SHAPES, ac_dim=AC_DIM)  # CUDA by default
        assert type(algo).__name__ == "MCRTransformerGMM" and algo.device.type == "cuda"
        trunk = flatten(torch.load(snap, weights_only=True)["params"]["backbone"])
        cores = [(n, m) for n, m in algo.nets.named_modules() if n.endswith("backbone")]
        if len(cores) != 1:
            raise AssertionError(f"mcr policy: trunks {[n for n, _ in cores]}")
        for name, core in cores:
            params = dict(core.named_parameters())
            if params.keys() != trunk.keys() or not all(
                    torch.equal(p.detach().cpu(), trunk[k]) for k, p in params.items()):
                raise AssertionError(f"mcr policy: {name} is not the snapshot's trunk")
            if not all(torch.equal(b, torch.zeros_like(b) if k.endswith("mean")
                                   else torch.ones_like(b)) for k, b in core.named_buffers()):
                raise AssertionError(f"mcr policy: {name}'s statistics are not the init's")
        n_params = sum(p.numel() for p in algo.nets.parameters())
        t = int(cfg.algo.transformer.context_length)
        items = MCRItems(4 * MCR_BATCH, t, seed=42)
        loader = DataLoader(items, MCR_BATCH, seed=43)
        rng = np.random.default_rng(44)
        requests = [stack_collate([items[int(i)] for i in rng.integers(len(items), size=N_ENVS)])
                    ["obs"] for _ in range(MCR_REQUESTS)]
        zero_launch_counts()
        served = [algo.get_action(o) for o in requests]
        log = run_epoch(algo, loader, epoch=1, num_steps=MCR_POLICY_STEPS)
        counts = launch_counts()
        if counts != (0, 0, 0) or not all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all()
                                           for a in served) or not np.isfinite(log["Loss"]):
            raise AssertionError(f"mcr policy: launches {counts}, log {log}")
        request_ms = host_ms(lambda: algo.get_action(requests[0]))
        request_busy, _ = profile_device(lambda: algo.get_action(requests[0]), 2)
        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=MCR_POLICY_STEPS)
        step_busy, kernels, convs, names = profile_convs(lambda: algo.train_on_batch(batch, 1),
                                                         2)
        assert_fp32_convs(names, "mcr policy step")
        assert_no_tf32(list(kernels), "mcr policy step")
        results["policy"] = {
            "params": n_params, "launches": counts, "log": log, "request_ms": request_ms,
            "request_busy_ms": request_busy,
            "request_idle_share": None if request_busy is None else 1 - request_busy / request_ms,
            "step_ms": step_ms, "step_busy_ms": step_busy,
            "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
            "step_conv_ms": sum(convs.values()),
            "step_top_ops_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])}
        print(f"mcr policy (MCRTransformerGMM, {n_params / 1e6:.2f} M parameters, the "
              f"snapshot's trunk grafted, its statistics the init's): {MCR_REQUESTS} requests "
              f"of {N_ENVS} envs and {MCR_POLICY_STEPS} steps of batch {MCR_BATCH}, launches "
              f"{counts}; Loss {log['Loss']:.4f}; request {request_ms:.3f} ms (device busy "
              f"{request_busy} ms), step {step_ms:.3f} ms (device busy {step_busy} ms, "
              f"convolution kernels {results['policy']['step_conv_ms']:.3f} ms) [{card}]")
        del algo, batch, served

        # one fp32 step, card against CPU, from the same weights
        t0 = time.perf_counter()
        hold_cfg = mcr_config(snap, hold=True)
        card_algo, cpu_algo = (algo_factory("mcr", hold_cfg, MCR_SHAPES, ac_dim=AC_DIM,
                                            device=d) for d in (None, "cpu"))
        hold_batch = card_algo.process_batch_for_training(
            next(iter(DataLoader(items, MCR_HOLD_BATCH, seed=45))))
        # the keypoint conv's bias: a spatial softmax is invariant to it, its
        # exact gradient is 0
        kp_biases = [n for n, _ in cpu_algo.nets.named_parameters()
                     if n.endswith("kp_conv.bias")]
        losses, worst = hold_step(card_algo, cpu_algo, hold_batch, zero=kp_biases,
                                  loose=("core_",))
        results["hold"] = {"losses": losses, "worst": worst,
                           "seconds": time.perf_counter() - t0}
        print(f"mcr policy train parity: one fp32 step on the card == the CPU step "
              f"(hold_step, the visual core's gradients as wholes); losses {losses}; worst "
              f"{worst}; {results['hold']['seconds']:.1f} s")
        del card_algo, cpu_algo
    torch.cuda.empty_cache()
    return results


# phase 13, the synthetic closed loop: the convergence twin at its settings
# and K1 at its shapes (a train step's 16 context demos x 10 steps and a
# single-env request's 10 context steps, 256 codes, latent 791)
LOOP_TRAIN_SHAPE, LOOP_REQUEST_SHAPE = (160, 256, 791), (10, 256, 791)
# the JAX package's examples/convergence_demo.py on the CPU (JAX_PLATFORMS=cpu,
# the seeds written there): (epoch, success rate, mean horizon)
JAX_CPU_CURVE = ((0, 0.2, 97.0), (4, 1.0, 16.0), (8, 1.0, 19.0), (12, 1.0, 22.0))
LOOP_SUCCESS_MARGIN = 0.3


def closed_loop_phase(card: str) -> dict:
    """Phase 13: ``lipvq_tpu_torch.examples.convergence_demo`` at its full
    settings on the card (40 scripted demos, 4 x 256 flagship with 256
    codes, 12 epochs of 50 steps, 5 + 3 x 10 evaluation episodes): K1 must
    launch exactly once per train step and once per policy request, K1f and
    K2 never; the last evaluation's success may fall at most 0.3 below the
    JAX package's CPU curve. Then a step and a request are timed and
    profiled, and K1 is held against its plain version at the loop's shapes
    (exact ids on Gaussian fixtures, ``tie_gap`` on the loop's own latents)
    and timed beside its bound, the plain version and addmm + argmin."""
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper
    from lipvq_tpu_torch.examples import convergence_demo
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_reference

    zero_launch_counts()
    out = convergence_demo.run(seed=0, log=lambda line: print(f"  closed loop: {line}"))
    counts = launch_counts()
    want = out["train_steps"] + out["requests"]
    if counts != (want, 0, 0):
        raise AssertionError(f"closed loop: launches (K1, K1f, K2) {counts}, want "
                             f"({out['train_steps']} steps + {out['requests']} requests, 0, 0)")
    curve = out["curve"]
    if [c["epoch"] for c in curve] != [e for e, _, _ in JAX_CPU_CURVE]:
        raise AssertionError(f"closed loop: evaluations at {[c['epoch'] for c in curve]}")
    last, jax_last = curve[-1]["success"], JAX_CPU_CURVE[-1][1]
    if last < jax_last - LOOP_SUCCESS_MARGIN:
        raise AssertionError(f"closed loop: last success {last} more than "
                             f"{LOOP_SUCCESS_MARGIN} below the JAX package's {jax_last}")
    model, policy, ctx = out["model"], out["policy"], out["context"]
    batch = model.process_batch_for_training(next(iter(out["loader"])))

    def step():
        model.train_on_batch(batch, 13)
        torch.cuda.synchronize()

    step_ms = host_ms(step, reps=20)
    step_busy, step_kernels = profile_device(lambda: model.train_on_batch(batch, 13), 5)
    env = FrameStackWrapper(SyntheticKitchenEnv(seed=98, horizon=120), num_frames=10)
    policy.start_episode(lang="drive the effector to the goal")
    ob = env.reset()
    request_ms = host_ms(lambda: policy(ob, ctx))
    request_busy, request_kernels = profile_device(lambda: policy(ob, ctx), 10)
    points = [(c["epoch"], c["success"], c["horizon"], c["loss"], c["distinct_ids"])
              for c in curve]
    print(f"closed loop: {out['train_steps']} train steps + {out['requests']} requests = "
          f"{counts[0]} K1 launches, K1f {counts[1]}, K2 {counts[2]}, in {out['seconds']:.1f} s; "
          f"curve (epoch, success, horizon, loss, distinct ids) {points} "
          f"against the JAX package's CPU curve {JAX_CPU_CURVE}; step {step_ms:.3f} ms (device "
          f"busy {step_busy} ms), single-env request {request_ms:.3f} ms (device busy "
          f"{request_busy} ms) [{card}]")

    # K1 at the loop's shapes: Gaussian fixtures exact, the loop's latents
    # within the near-tie bound
    tok = model.nets.net.encoder.action_network
    c_loop = tok.quantizer.codebook.detach()
    assert tuple(c_loop.shape) == LOOP_TRAIN_SHAPE[1:], c_loop.shape
    with torch.no_grad():
        loop_z = {"train": tok.encode(torch.as_tensor(
                      batch["actions"][:len(batch["actions"]) // 2], device=model.device)
                      .reshape(-1, AC_DIM)),
                  "request": tok.encode(torch.as_tensor(ctx["actions"], device=model.device)
                                        .reshape(-1, AC_DIM))}
    gen = torch.Generator(device=model.device).manual_seed(51)
    rows = {}
    for label, (b, n, d) in (("train", LOOP_TRAIN_SHAPE), ("request", LOOP_REQUEST_SHAPE)):
        z = torch.randn(b, d, generator=gen, device=model.device)
        c = torch.randn(n, d, generator=gen, device=model.device)
        if not torch.equal(vq_nearest_cuda(z, c), vq_nearest_reference(z, c)):
            raise AssertionError(f"K1 ids differ from the plain version at {b}x{n}x{d}")
        zl = loop_z[label]
        assert tuple(zl.shape) == (b, d), zl.shape
        got = vq_nearest_cuda(zl, c_loop)
        mismatches, max_gap, _ = check_near_ties(zl, c_loop, got,
                                                 vq_nearest_reference(zl, c_loop), bf16=False)
        ms = cuda_ms(lambda: vq_nearest_cuda(z, c), 50)
        plain_ms = cuda_ms(lambda: vq_nearest_reference(z, c), 10)
        library_ms = cuda_ms(
            lambda: torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1), 50)
        device_ms, _ = profile_device(lambda: vq_nearest_cuda(z, c), 50)
        bound_ms, bound_by = vq_bound(b, n, d)
        rows[label] = {"shape": [b, n, d], "mismatches": mismatches, "max_abs_err": max_gap,
                       "loop_codes_used": int(torch.unique(got).numel()), "ms": ms,
                       "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 closed loop {label} {b}x{n}x{d}: Gaussian ids exact; the loop's latents "
              f"{mismatches} ids off the plain lookup (near-ties, max fp64 gap {max_gap:.3g}) on "
              f"{rows[label]['loop_codes_used']} codes; K1 {ms:.4f} ms per call (device "
              f"{device_ms} ms), plain {plain_ms:.4f} ms, addmm+argmin {library_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    result = {k: v for k, v in out.items() if k not in ("model", "loader", "dataset",
                                                         "context", "policy")}
    result.update({"launches": counts, "jax_cpu_curve": JAX_CPU_CURVE, "step_ms": step_ms,
                   "step_busy_ms": step_busy,
                   "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
                   "request_ms": request_ms, "request_busy_ms": request_busy,
                   "request_idle_share": (None if request_busy is None
                                          else 1 - request_busy / request_ms),
                   "step_top_ops_ms": dict(sorted(step_kernels.items(),
                                                  key=lambda kv: -kv[1])[:5]),
                   "request_top_ops_ms": dict(sorted(request_kernels.items(),
                                                     key=lambda kv: -kv[1])[:5]),
                   "k1": rows})
    del out, model, policy, batch
    torch.cuda.empty_cache()
    return result


def device_cache_script(card: str, exports: list[str], tmp: str) -> dict:
    """The script phase's run once more with ``train.hdf5_cache_mode =
    "device"``: the corpus preprocessed once into tables on the card, each
    batch one gather there. The loader's first batch must equal, bit for
    bit, the host path's ``process_batch_for_training`` of the same items;
    K1 launches once per train step and once per rollout request, as on the
    host path."""
    import copy

    from lipvq_tpu_torch.data.loaders import DeviceCachedLoader
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.utils import train_utils
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate

    cfg = script_config(exports, os.path.join(tmp, "out_device"))
    cfg["train"]["hdf5_cache_mode"] = "device"
    cfg_path = os.path.join(tmp, "config_device.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    seen = {"k1_steps": 0, "checked": None, "setup_s": None}
    run_epoch, make_loaders = train_utils.run_epoch, train_utils.make_loaders

    def observed_make_loaders(config, train_ds, valid_ds, model=None):
        t0 = time.perf_counter()
        loaders = make_loaders(config, train_ds, valid_ds, model=model)
        torch.cuda.synchronize()
        seen.update(setup_s=time.perf_counter() - t0, dataset=train_ds)
        return loaders

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            return {p: a for k, v in tree.items() for p, a in leaves(v, path + (k,)).items()}
        if tree is None:
            return {}
        return {path: tree.cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}

    def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
        if seen["checked"] is None:
            if not isinstance(loader, DeviceCachedLoader) or not loader.preprocessed:
                raise AssertionError(f"device cache: the train loader is a "
                                     f"{type(loader).__name__}")
            idx = copy.deepcopy(loader._rng).choice(loader._n, size=loader.batch_size,
                                                    replace=True, p=loader._p)
            got = leaves(loader.gather(idx))
            want = leaves(model.process_batch_for_training(
                stack_collate([seen["dataset"][int(i)] for i in idx])))
            if got.keys() != want.keys() or not all(
                    got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                    for k in want):
                raise AssertionError("device cache: the first batch differs from the host "
                                     "path's")
            seen["checked"] = {
                "leaves": len(got),
                "table_rows": [int(t.shape[0]) for t in loader._tables],
                "items": loader._n,
                "table_bytes": sum(t.numel() * t.element_size() for t in loader._tables)}
        before = launch_counts()[0]
        log = run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)
        seen["k1_steps"] += launch_counts()[0] - before
        return log

    out = io.StringIO()
    train_utils.run_epoch, train_utils.make_loaders = observed_run_epoch, observed_make_loaders
    try:
        # the main path: the training script with the device cache, counted
        zero_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ckpt_dir = train_script.main(["--config", cfg_path])
        script_s = time.perf_counter() - t0
        k1, k1f, k2 = launch_counts()
    except BaseException:
        print(out.getvalue()[-8000:])
        raise
    finally:
        train_utils.run_epoch, train_utils.make_loaders = run_epoch, make_loaders
    k1_rollout = k1 - seen["k1_steps"]
    want = (SCRIPT_EPOCHS * SCRIPT_STEPS, SCRIPT_EPOCHS * ROLLOUT_HORIZON, 0, 0)
    if (seen["k1_steps"], k1_rollout, k1f, k2) != want:
        raise AssertionError(f"device cache script: K1 {seen['k1_steps']} in steps and "
                             f"{k1_rollout} in rollouts, K1f {k1f}, K2 {k2}; want {want}")
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        logs = json.load(f)
    bad = {k: v for k, v in logs.items() if not np.isfinite(v).all()}
    if bad:
        raise AssertionError(f"device cache script: non-finite logs {bad}")
    timing = {k: per_step_ms(logs, f"Timing_Stats/Train_{k}", SCRIPT_STEPS)
              for k in ("Data_Loading", "Process_Batch", "Train_Batch")}
    print(f"script, device cache: the first batch bit-equal to the host path's "
          f"({seen['checked']['leaves']} leaves; tables of {seen['checked']['table_rows']} rows "
          f"for {seen['checked']['items']} items, {seen['checked']['table_bytes']} bytes, built "
          f"in {seen['setup_s']:.2f} s); {SCRIPT_EPOCHS} epochs in {script_s:.1f} s, K1 "
          f"{seen['k1_steps']} in steps + {k1_rollout} in rollouts, K2 {k2}; Time_* per step "
          f"{ {k: [round(x, 3) for x in v] for k, v in timing.items()} } ms [{card}]")
    return {"k1_train_steps": seen["k1_steps"], "k1_rollout": k1_rollout, "k1f": k1f, "k2": k2,
            "first_batch": seen["checked"], "setup_s": seen["setup_s"], "script_s": script_s,
            "time_ms_per_step": timing}


# ---------------------------------------------------------------------------
# The twelfth slice: reference-checkpoint import, policy export, the
# train-step profiler, data-parallel training, the subprocess vector env
# ---------------------------------------------------------------------------

PROFILE_SHAPE = (8000, 1024, 791)  # the profiler's largest batch: 800 context demos x 10
PROFILE_IMAGE_SHAPE = (80, 1024, 905)  # its image step: 8 context demos, 2 cameras
EXPORT_BATCHES = (N_ENVS, 1)
EXPORT_REPS = 20
DDP_STEPS = 5  # train steps of each ddp run
VECTOR_STEPS = 20


def _reference_lipvq_state_dict(rng) -> dict:
    """A seeded state_dict in the reference LLFQVAE_V4 layout at the flagship's
    width (12 -> 64 -> 128 -> 791, 1024 codes): torch Linear weights [out, in]."""
    def lin(out, inp):
        bound = 1.0 / math.sqrt(inp)
        return (rng.uniform(-bound, bound, (out, inp)).astype(np.float32),
                rng.uniform(-bound, bound, out).astype(np.float32))

    sd = {}
    for name, (out, inp) in (("encoder.0", (64, AC_DIM)), ("encoder.2", (128, 64)),
                             ("decoder.0", (64, 791)), ("decoder.2", (128, 64)),
                             ("to_output", (AC_DIM, 128))):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = lin(out, inp)
    sd["to_latent.W"] = rng.standard_normal((791, 128)).astype(np.float32)
    sd["to_latent.b"] = np.zeros(791, np.float32)
    sd["to_latent.ci"] = np.ones(791, np.float32)
    sd["quantizer.codebook"] = rng.standard_normal((1024, 791)).astype(np.float32)
    return sd


def _reference_resnet18_state_dict(rng, prefix: str) -> dict:
    """A seeded torchvision-layout ResNet-18 state_dict (conv1, bn1,
    layer{1..4}.{0,1}, the stage-entry downsample), BatchNorm statistics off
    their init, an fc head the import ignores."""
    sd = {}

    def conv(key, out, inp, k):
        sd[f"{key}.weight"] = (rng.standard_normal((out, inp, k, k))
                               * math.sqrt(2.0 / (inp * k * k))).astype(np.float32)

    def bn(key, c):
        sd[f"{key}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{key}.running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[f"{key}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{key}.num_batches_tracked"] = np.asarray(100)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    width = 64
    for stage, feats in enumerate((64, 128, 256, 512), start=1):
        for block in range(2):
            key, inp = f"layer{stage}.{block}", width if block == 0 else feats
            conv(f"{key}.conv1", feats, inp, 3)
            bn(f"{key}.bn1", feats)
            conv(f"{key}.conv2", feats, feats, 3)
            bn(f"{key}.bn2", feats)
            if block == 0 and inp != feats:
                conv(f"{key}.downsample.0", feats, inp, 1)
                bn(f"{key}.downsample.1", feats)
        width = feats
    sd["fc.weight"] = rng.standard_normal((1000, 512)).astype(np.float32)
    return {prefix + k: v for k, v in sd.items()}


def import_phase(card: str) -> dict:
    """Part A on the card: a seeded reference LLFQVAE_V4 payload through the
    import CLI into ``LipVQVAE`` (K1 ids against the plain version), and a
    seeded R3M-layout ResNet-18 through ``convert`` into ``R3MConv``
    (card against CPU at the visual phase's tolerance)."""
    from lipvq_tpu_torch.models import obs_core
    from lipvq_tpu_torch.models.base_nets import BatchNorm
    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
    from lipvq_tpu_torch.ops.vq_lookup import tie_gap, vq_nearest, vq_nearest_reference
    from lipvq_tpu_torch.scripts import import_torch_ckpt

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as tmp:
        src, dst = os.path.join(tmp, "model.pth"), os.path.join(tmp, "params.pt")
        sd = _reference_lipvq_state_dict(rng)
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                    "config": {"algo_name": "icl"}}, src)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            import_torch_ckpt.main(["--torch_ckpt", src, "--output", dst])
        convert_s = time.perf_counter() - t0
        tok = LipVQVAE(AC_DIM, 791, num_codes=1024).to(dev)
        tok.load_state_dict(torch.load(dst, map_location=dev, weights_only=True)["params"])
        codebook = tok.quantizer.codebook.detach()
        assert torch.equal(codebook.cpu(), torch.from_numpy(sd["quantizer.codebook"]))

        # the main path: the imported tokenizer's lookups, counted
        gauss = torch.randn(SLICE_SHAPE[0], 791, generator=torch.Generator(dev).manual_seed(0),
                            device=dev)
        actions = torch.from_numpy(rng.uniform(-1, 1, (SLICE_SHAPE[0], AC_DIM))
                                   .astype(np.float32)).to(dev)
        zero_launch_counts()
        with torch.no_grad():
            ids_gauss = vq_nearest(gauss, codebook)
            latents = tok.encode(actions)
            ids_tok = tok.tokenize(actions)
        launches = launch_counts()
        assert launches == (2, 0, 0), launches
        if not torch.equal(ids_gauss, vq_nearest_reference(gauss, codebook)):
            raise AssertionError("the imported codebook's K1 ids differ from the plain version "
                                 "on Gaussian inputs")
        plain = vq_nearest_reference(latents, codebook)
        gap, allowed = tie_gap(latents, codebook, ids_tok, plain, bf16=False)
        if not bool((gap <= allowed).all()):
            raise AssertionError("the imported tokenizer's ids differ beyond near-ties")
        flips = int((ids_tok != plain).sum())

        trunk = os.path.join(tmp, "r3m.pt")
        converted = import_torch_ckpt.convert(
            {k: np.asarray(v) for k, v in _reference_resnet18_state_dict(
                rng, "module.convnet.").items()}, "resnet18")
        import_torch_ckpt.save_converted(converted, trunk)
        frames = torch.rand(8, 3, 128, 128, generator=torch.Generator().manual_seed(1))
        # a trained trunk's running statistics match its activations: take
        # them from one batch (momentum 0), so the outputs are O(1) as a
        # pretrained trunk's are, and write the trunk again
        core = obs_core.R3MConv()
        obs_core.apply_pretrained(core, trunk)
        for m in core.modules():
            if isinstance(m, BatchNorm):
                m.momentum = 0.0
        with torch.no_grad():
            core.backbone(frames, train=True)
        params, stats = core.load_pretrained(trunk)
        state = core.state_dict()
        import_torch_ckpt.save_converted(
            {"params": {k[len("backbone."):]: state[k] for k in params},
             "batch_stats": {k[len("backbone."):]: state[k] for k in stats}}, trunk)
        cores = {"cuda": obs_core.R3MConv().to(dev), "cpu": obs_core.R3MConv()}
        for core in cores.values():
            obs_core.apply_pretrained(core, trunk)
        with torch.no_grad():
            got = cores["cuda"](frames.to(dev)).cpu()
            want = cores["cpu"](frames)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-4)
        trunk_err = float((got - want).abs().max())
        trunk_max = float(want.abs().max())
    print(f"import: LLFQVAE_V4 payload converted by the CLI in {convert_s:.2f} s and loaded "
          f"on the card; K1 ids exactly the plain version's on {SLICE_SHAPE[0]} Gaussian rows, "
          f"{flips} of {SLICE_SHAPE[0]} tokenizer ids differ on near-ties only; launches "
          f"{launches}; R3M trunk card vs CPU max abs {trunk_err:.3g} of outputs up to "
          f"{trunk_max:.3g} (rtol 1e-3 / atol 1e-4) [{card}]")
    return {"launches": launches, "tokenizer_near_tie_flips": flips,
            "trunk_max_abs_err": trunk_err, "convert_s": convert_s}


EXPORT_RUNNER = r"""
import statistics, sys, time
import torch
import lipvq_tpu_torch.ops.vq_lookup as V

program, inputs, out = sys.argv[1:4]
reps = int(sys.argv[4])
args = torch.load(inputs, map_location="cuda", weights_only=True)
run = torch.export.load(program).module()
V.vq_nearest_cuda.launches = 0
with torch.no_grad():
    actions = run(*args)
    torch.cuda.synchronize()
    first = V.vq_nearest_cuda.launches
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
torch.save(actions.cpu(), out)
loaded = sorted(m for m in sys.modules if m.startswith("lipvq_tpu_torch."))
print(first, V.vq_nearest_cuda.launches, statistics.median(times), ",".join(loaded))
"""


def export_phase(card: str) -> dict:
    """Part B on the card: the flagship at the serving width through a
    checkpoint, ``export_policy`` at 16 envs and 1, each program reloaded
    in a fresh process that imports only the op registration; its actions
    against ``get_action``'s at the same draws."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.scripts import export_policy as EP
    from lipvq_tpu_torch.utils import file_utils

    algo = algo_factory("icl", icl_config(), OBS_SHAPES, ac_dim=AC_DIM)
    rng = np.random.default_rng(14)
    tok = algo.nets.net.encoder.action_network
    with torch.no_grad():
        tok.quantizer.codebook.copy_(tok.encode(torch.from_numpy(
            rng.uniform(-1, 1, (1024, AC_DIM)).astype(np.float32)).cuda()))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        ckpt = os.path.join(tmp, "model.ckpt")
        file_utils.save_checkpoint(ckpt, algo, algo.global_config,
                                   env_meta={"env_name": "SyntheticKitchen", "type": 1,
                                             "env_kwargs": {}},
                                   shape_meta={"ac_dim": AC_DIM, "all_shapes": OBS_SHAPES,
                                               "all_obs_keys": list(OBS_SHAPES),
                                               "use_images": False},
                                   obs_normalization_stats=None,
                                   action_normalization_stats=None, lang_backend="hash")
        model, _ = file_utils.policy_from_checkpoint(ckpt)
        for batch in EXPORT_BATCHES:
            path = os.path.join(tmp, f"policy{batch}.pt2")
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                EP.export_policy(ckpt, path, batch=batch)
            export_s = time.perf_counter() - t0
            program = torch.export.load(path)
            nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
            assert nodes.count(EP.LOOKUP_OP) == 1, "the exported graph holds no K1 node"
            t = model.context_length
            obs = {k: v[:batch] for k, v in random_obs(rng, (N_ENVS, t)).items()}
            context = {"obs": {k: v[:batch] for k, v in random_obs(rng, (N_ENVS, t)).items()},
                       "actions": rng.uniform(-1, 1, (batch, t, AC_DIM)).astype(np.float32)}
            state = model._generator.get_state()
            want = model.get_action(obs, context)
            model._generator.set_state(state)
            *_, u_like, eps_like = EP.user_inputs(program)
            args = [model._put_infer(x) for x in (obs, context["obs"], context["actions"])]
            args += list(EP.draw_like(model, u_like, eps_like))
            inputs, result = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "actions.pt")
            torch.save(args, inputs)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", EXPORT_RUNNER, path, inputs, result,
                                   str(EXPORT_REPS)], capture_output=True, text=True,
                                  timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
            reload_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"the reloaded program failed:\n{proc.stderr[-4000:]}")
            first, total, program_ms, loaded = proc.stdout.strip().splitlines()[-1].split(" ")
            assert "lipvq_tpu_torch.algo" not in loaded and "lipvq_tpu_torch.models" not in loaded
            got = torch.load(result, weights_only=True).numpy()
            max_abs = float(np.abs(got - want).max())
            assert got.shape == want.shape == (batch, AC_DIM) and np.isfinite(got).all()
            assert int(first) == 1, f"the reloaded program launched K1 {first} times"

            def eager():
                with torch.inference_mode():
                    model._get_action_impl(*args[:3], None, draws=tuple(args[3:]))
                torch.cuda.synchronize()

            eager_ms = host_ms(eager)
            out[batch] = {"k1_launches": int(total), "k1_launches_first_call": int(first),
                          "max_abs_diff": max_abs, "program_ms": float(program_ms),
                          "eager_ms": eager_ms, "export_s": export_s, "reload_run_s": reload_s,
                          "bytes": os.path.getsize(path)}
            print(f"export batch {batch}: {os.path.getsize(path)} bytes in {export_s:.1f} s; "
                  f"the graph holds {EP.LOOKUP_OP} once; reloaded in a fresh process "
                  f"(modules {loaded}): K1 launched {first} time(s) on the checked call, "
                  f"{total} over {1 + EXPORT_REPS} calls; actions' max abs difference from "
                  f"get_action {max_abs:.3g}; {float(program_ms):.3f} ms per request "
                  f"against eager {eager_ms:.3f} ms [{card}]")
            if max_abs != 0.0:
                raise AssertionError(f"the reloaded program's actions differ from "
                                     f"get_action's by {max_abs}")
    return out


def profile_phase(card: str) -> dict:
    """Part C on the card: ``profile_train_step`` at the template width,
    low-dim at batches 100 and 1600 (the loss codebook), 100 with the EMA
    codebook and the image protocol at 16; launches counted per run."""
    from lipvq_tpu_torch.scripts import profile_train_step

    rows = {}
    for label, argv in (("lowdim", ["--mode", "lowdim", "--batches", "100", "1600"]),
                        ("lowdim_ema", ["--mode", "lowdim", "--batches", "100",
                                        "--ema_codebook"]),
                        ("image", ["--mode", "image", "--batches", "16"])):
        zero_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            got = profile_train_step.main(argv + ["--iters", "10"])
        launches = launch_counts()
        for row in got:
            key = f"{label} {row['batch']}"
            rows[key] = row
            per = row["launches_per_step"]
            want = (0, 0, 1) if row["ema_codebook"] else (1, 0, 0)
            assert (per["k1"], per["k1f"], per["k2"]) == want, (key, per)
            print(f"profile {key}: {json.dumps(row)}")
        rows[f"{label} launches"] = list(launches)
        gc_cuda()
    print(f"profile: card {card}")
    return rows


def gc_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _ddp_config(export: str, output_dir: str, num_devices) -> dict:
    """The script phase's settings with the EMA codebook, one export, one
    epoch of ``DDP_STEPS`` steps, no rollouts or validation."""
    cfg = script_config([export], output_dir)
    cfg["algo"]["vq"]["ema_codebook"] = True
    cfg["train"]["num_epochs"] = 1
    cfg["train"]["num_devices"] = num_devices
    cfg["experiment"]["epoch_every_n_steps"] = DDP_STEPS
    cfg["experiment"]["validate"] = False
    cfg["experiment"]["rollout"]["enabled"] = False
    return cfg


def _gloo_rank(rank: int, world: int, tmp: str) -> None:
    """One of two ranks sharing the card over gloo with CUDA tensors: the
    flagship's EMA step on this rank's pairs."""
    import torch.distributed as dist

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    try:
        spec = torch.load(os.path.join(tmp, "spec.pt"), weights_only=False)
        algo = algo_factory("icl", spec["config"], OBS_SHAPES, ac_dim=AC_DIM)
        algo.nets.load_state_dict(spec["state"])
        algo.attach_mesh(make_mesh(world))
        losses = [float(algo.train_on_batch(b, 0)["losses"]["action_loss"])
                  for b in spec["batches"]]
        torch.save(losses, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ddp_phase(card: str) -> dict:
    """Part D on the card: ``scripts/train.py`` with ``train.num_devices=1``
    (a group of one over NCCL) against ``num_devices=None`` on one seeded
    export, the EMA codebook, bit for bit; then two ranks sharing the card
    over gloo with CUDA tensors against the single process (not a
    criterion: an error is recorded)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.scripts import train as train_script
    from lipvq_tpu_torch.utils import file_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
        obs_shapes = {k: tuple(s) for k, s in OBS_SHAPES.items() if k != "lang_emb"}
        export = make_synthetic_export(os.path.join(tmp, "export"), n_demos=20, demo_len=100,
                                       action_dim=AC_DIM, obs_key_shapes=obs_shapes,
                                       lang="synthetic task", seed=0)
        for label, n in (("none", None), ("nccl1", 1)):
            cfg_path = os.path.join(tmp, f"{label}.json")
            with open(cfg_path, "w") as f:
                json.dump(_ddp_config(export, os.path.join(tmp, label), n), f)
            # the main path: the script, counted
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                ckpt_dir = train_script.main(["--config", cfg_path])
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
                logs = json.load(f)
            state = file_utils.load_checkpoint_dict(
                os.path.join(ckpt_dir, "model_epoch_1.ckpt"))["model"]
            runs[label] = {"launches": launches, "seconds": seconds, "state": state,
                           "loss": logs["Train/Loss"]}
            assert launches == (0, 0, DDP_STEPS), (label, launches)
        a, b = runs["none"], runs["nccl1"]
        assert a["loss"] == b["loss"], (a["loss"], b["loss"])
        for k, v in a["state"].items():
            if not torch.equal(v, b["state"][k]):
                raise AssertionError(f"num_devices=1 differs from num_devices=None at {k}")
        print(f"ddp: scripts/train.py num_devices=1 (NCCL, a group of one) equals "
              f"num_devices=None bit for bit over {DDP_STEPS} EMA steps (loss {b['loss']}, "
              f"{len(b['state'])} tensors); K2 launched {b['launches'][2]} times; "
              f"{b['seconds']:.1f} s against {a['seconds']:.1f} s [{card}]")

        gloo = {}
        try:
            cfg = icl_config(train={"ema": True, "dropout": 0.1, "warmup": None})
            single = algo_factory("icl", cfg, OBS_SHAPES, ac_dim=AC_DIM)
            items = SequenceItems(BATCH * 3, seed=21)
            from lipvq_tpu_torch.utils.tensor_utils import stack_collate

            batches = [single.process_batch_for_training(stack_collate(
                [items[i] for i in range(s * BATCH, (s + 1) * BATCH)])) for s in range(3)]
            spec = {"config": cfg, "batches": batches,
                    "state": {k: v.cpu().clone() for k, v in single.nets.state_dict().items()}}
            torch.save(spec, os.path.join(tmp, "spec.pt"))
            want = [float(single.train_on_batch(b, 0)["losses"]["action_loss"])
                    for b in batches]
            del single
            gc_cuda()
            t0 = time.perf_counter()
            torch.multiprocessing.spawn(_gloo_rank, args=(2, tmp), nprocs=2, join=True)
            got = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
            assert got[0] == got[1]
            np.testing.assert_allclose(got[0], want, rtol=1e-4)
            gloo = {"losses": got[0], "single": want, "seconds": time.perf_counter() - t0}
            print(f"ddp: 2 gloo ranks sharing the card (CUDA tensors) equal the single "
                  f"process within rtol 1e-4 over 3 steps with dropout 0.1: {got[0]} vs "
                  f"{want} [{card}]")
        except Exception as e:  # not a criterion: recorded
            gloo = {"error": f"{type(e).__name__}: {str(e)[-2000:]}"}
            print(f"ddp: 2 gloo ranks sharing the card failed: {gloo['error']}")
    return {"nccl1": {k: v for k, v in runs["nccl1"].items() if k != "state"},
            "none": {k: v for k, v in runs["none"].items() if k != "state"}, "gloo": gloo}


def vector_phase(card: str) -> dict:
    """Part E on the card: the flagship served over a ``SubprocVectorEnv``
    of 16 synthetic envs in lock-step with the in-process ``VectorEnv``
    (observations bit-equal), timed per rollout step beside the bare
    request."""
    import functools

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.vector_env import SubprocVectorEnv, VectorEnv

    algo = algo_factory("icl", icl_config(), OBS_SHAPES, ac_dim=AC_DIM)
    rng = np.random.default_rng(15)
    tok = algo.nets.net.encoder.action_network
    with torch.no_grad():
        tok.quantizer.codebook.copy_(tok.encode(torch.from_numpy(
            rng.uniform(-1, 1, (1024, AC_DIM)).astype(np.float32)).cuda()))
    t = algo.context_length
    context = {"obs": {k: np.repeat(v, N_ENVS, 0) for k, v in random_obs(rng, (1, t)).items()},
               "actions": np.repeat(rng.uniform(-1, 1, (1, t, AC_DIM)).astype(np.float32),
                                    N_ENVS, 0)}
    policy = ICLRolloutPolicy(algo)
    fns = [functools.partial(SyntheticKitchenEnv, seed=1000 + i) for i in range(N_ENVS)]
    keys = [k for k in OBS_SHAPES if k != "lang_emb"]
    t0 = time.perf_counter()
    sub = SubprocVectorEnv(fns, frame_stack=t, obs_keys=keys)
    local = VectorEnv(fns, frame_stack=t, obs_keys=keys)
    try:
        obs = [sub.reset(), local.reset()]
        start_s = time.perf_counter() - t0
        lang = np.zeros((N_ENVS, t, 768), np.float32)
        times = {"request": [], "subproc": [], "local": []}
        zero_launch_counts()
        for _ in range(VECTOR_STEPS):
            for k in obs[0]:
                np.testing.assert_array_equal(obs[0][k], obs[1][k])
            t0 = time.perf_counter()
            acts = policy.batched({**obs[0], "lang_emb": lang}, context)
            times["request"].append((time.perf_counter() - t0) * 1e3)
            steps = []
            for name, env, i in (("subproc", sub, 0), ("local", local, 1)):
                t0 = time.perf_counter()
                obs[i], rews, dones, _ = env.step(acts)
                times[name].append((time.perf_counter() - t0) * 1e3)
                steps.append((rews, dones))
            np.testing.assert_array_equal(steps[0][0], steps[1][0])
            np.testing.assert_array_equal(steps[0][1], steps[1][1])
        launches = launch_counts()
    finally:
        sub.close()
    assert launches == (VECTOR_STEPS, 0, 0), launches
    request_ms, env_sub, env_local = (statistics.median(times[k][1:])
                                      for k in ("request", "subproc", "local"))
    sub_ms, local_ms = request_ms + env_sub, request_ms + env_local
    print(f"vector: {N_ENVS} synthetic envs, {VECTOR_STEPS} served steps in lock-step, "
          f"observations, rewards and dones bit-equal across SubprocVectorEnv and VectorEnv; "
          f"ms per rollout step (request + env step): subprocess {sub_ms:.3f} (env "
          f"{env_sub:.3f}), in-process {local_ms:.3f} (env {env_local:.3f}), bare request "
          f"{request_ms:.3f} (medians); subprocess start {start_s:.1f} s; K1 {launches} "
          f"[{card}]")
    return {"launches": launches, "subproc_step_ms": sub_ms, "local_step_ms": local_ms,
            "subproc_env_ms": env_sub, "local_env_ms": env_local, "request_ms": request_ms,
            "subproc_start_s": start_s}


# phase 19, the kitchen: the card's machine has no mujoco (``python3 -c
# "import mujoco"`` there raises ModuleNotFoundError), so the phase trains and
# serves on the committed OpenDrawer corpus, written by the port's
# collect_kitchen_suite (lipvq_tpu_torch/assets/kitchen/README.md)
KITCHEN_CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lipvq_tpu_torch",
                              "assets", "kitchen", "OpenDrawer")
# examples/kitchen_multitask_suite.py:83-97
KITCHEN_OBS_KEYS = ("robot0_base_pos", "robot0_base_quat", "robot0_eef_pos", "robot0_eef_quat",
                    "robot0_gripper_qpos", "robot0_base_to_eef_pos", "fixture_state",
                    "obj_state", "lang_emb")
KITCHEN_BATCH, KITCHEN_EPOCHS, KITCHEN_STEPS = 64, 2, 20
# the suite twin's flags for the core-8 recipe at full width, 2 epochs x 20
# steps, a checkpoint every epoch (lipvq_tpu_torch/examples/
# kitchen_multitask_suite.py)
KITCHEN_SUITE_RECIPE = ("--embed_dim", "384", "--num_layers", "6", "--batch_size",
                        str(KITCHEN_BATCH), "--epochs", str(KITCHEN_EPOCHS), "--steps_per_epoch",
                        str(KITCHEN_STEPS), "--save_every", "1", "--train_seed", "1")
KITCHEN_REQUESTS = 8  # 16-env requests on the corpus's recorded observations
# K1 at the kitchen's shapes: a train step's 32 context demos x 10 steps, a
# 16-env request's 16 x 10 context steps (512 codes, latent 823: 55 low-dim
# + 768 lang), the learning floor's 12 x 10 (128 codes, latent 807)
KITCHEN_TRAIN_SHAPE = (320, 512, 823)
KITCHEN_REQUEST_SHAPE = (160, 512, 823)
KITCHEN_FLOOR_SHAPE = (120, 128, 807)
FLOOR_EPOCHS, FLOOR_STEPS = 3, 50  # tests/test_learning_floor.py


def kitchen_config(data, output_dir: str | None = None, compute_dtype: str = "bfloat16",
                   hold: bool = False) -> dict:
    """The core-8 recipe of BASELINE.md:583-610 at full width, as the suite
    twin's ``make_config`` builds it (``KITCHEN_SUITE_RECIPE``: 6 layers x
    384, 8 heads, 512 codes, batch 64, min_max actions, GMM min_std 0.03, lr
    1e-3 constant, the device-resident corpus, 2 epochs x 20 steps, a
    checkpoint every epoch), on ``data`` under ``output_dir``; then only the
    phase's overrides: the run's name, a wave of 16 batched rollouts per
    epoch (no video), ``compute_dtype``, and with ``hold`` the card-vs-CPU
    step's low_dim cache and no dropout."""
    from lipvq_tpu_torch.examples import kitchen_multitask_suite as suite

    args = suite.build_parser().parse_args([*KITCHEN_SUITE_RECIPE, "--out", "unused"])
    d = suite.make_config(args, {}).to_dict()
    d["train"].update({"data": data, "output_dir": output_dir})
    d["experiment"]["name"] = "chip_smoke_kitchen"
    d["experiment"]["render_video"] = False
    d["experiment"]["rollout"].update({"enabled": True, "batched": True, "num_batch_envs": N_ENVS,
                                       "n": N_ENVS, "horizon": ROLLOUT_HORIZON, "rate": 1})
    d["algo"]["transformer"]["compute_dtype"] = compute_dtype
    if hold:
        d["train"]["hdf5_cache_mode"] = "low_dim"
        d["algo"]["transformer"].update(
            {"emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0})
    return d


class RecordedKitchen:
    """An env that replays one demo's recorded kitchen observations from
    step ``start`` (the export's ``obs/<key>``); ``VectorEnv`` frame-stacks
    it as it does a live kitchen."""

    action_dimension = AC_DIM

    def __init__(self, export, demo: str, start: int):
        self.obs = {k: export.load(demo, f"obs/{k}") for k in KITCHEN_OBS_KEYS
                    if k != "lang_emb"}
        self.ep_lang_str = json.loads(export.demo_attrs(demo)["ep_meta"])["lang"]
        self.start, self.t = start, start

    def _obs(self):
        return {k: v[self.t] for k, v in self.obs.items()}

    def reset(self):
        self.t = self.start
        return self._obs()

    def step(self, action):
        self.t = min(self.t + 1, len(self.obs["robot0_eef_pos"]) - 1)
        return self._obs(), 0.0, False, {"is_success": {"task": False}}

    def is_success(self):
        return {"task": False}


def kitchen_loaders(cfg_dict: dict, lang, corpus: str = KITCHEN_CORPUS):
    """(config, shape metadata, train dataset, train loader, context loader)
    of the train script's helpers on ``cfg_dict``; ``corpus`` (an export of
    ``train.data``) gives the shapes."""
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils import file_utils
    from lipvq_tpu_torch.utils import obs_utils as ObsUtils
    from lipvq_tpu_torch.utils import train_utils as TrainUtils

    cfg = config_factory("icl", cfg_dict)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    sm = file_utils.get_shape_metadata_from_dataset(corpus, all_obs_keys=cfg.all_obs_keys)
    ds, _ = TrainUtils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"], lang_encoder=lang)
    loader, _, ctx_loader = TrainUtils.make_loaders(cfg, ds, None)
    return cfg, sm, ds, loader, ctx_loader


def kitchen_floor(card: str) -> dict:
    """The learning floor on the card: tests/test_learning_floor.py's 3 L /
    128 d flagship (batch 24, lr 1e-3, 128 codes, its obs keys) on the
    committed corpus, 3 epochs x 50 run_epoch steps (K1 once per step): the
    train NLL must end more than 2 nats below the first epoch's and below
    5."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.utils import train_utils as TrainUtils
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder
    from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides

    d = icl_test_config_overrides()
    d["train"].update({"data": KITCHEN_CORPUS, "num_epochs": FLOOR_EPOCHS, "batch_size": 24})
    d["experiment"].update({"epoch_every_n_steps": FLOOR_STEPS, "rollout": {"enabled": False},
                            "save": {"enabled": False}, "validate": False})
    d["algo"]["transformer"].update({"embed_dim": 128, "num_layers": 3, "num_heads": 4})
    d["algo"]["optim_params"] = {"policy": {"learning_rate": {
        "initial": 1e-3, "scheduler_type": "none"}}}
    d["algo"]["vq"] = {"num_codes": 128}
    d["observation"]["modalities"]["obs"]["low_dim"] = [
        "robot0_base_pos", "robot0_base_quat", "robot0_eef_pos", "robot0_eef_quat",
        "robot0_gripper_qpos", "robot0_base_to_eef_pos", "object", "lang_emb"]
    cfg, sm, _, loader, _ = kitchen_loaders(d, LangEncoder())
    model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"])  # CUDA
    losses = []
    zero_launch_counts()
    t0 = time.perf_counter()
    for epoch in range(1, FLOOR_EPOCHS + 1):
        log = TrainUtils.run_epoch(model, loader, epoch, num_steps=FLOOR_STEPS)
        model.on_epoch_end(epoch)
        losses.append(float(log["Loss"]))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if counts != (FLOOR_EPOCHS * FLOOR_STEPS, 0, 0):
        raise AssertionError(f"kitchen learning floor: launches (K1, K1f, K2) {counts}")
    initial, final = losses[0], losses[-1]
    if not (np.isfinite(losses).all() and final < initial - 2.0 and final < 5.0):
        raise AssertionError(f"kitchen learning floor not met: losses {losses} (want final < "
                             f"initial - 2.0 and < 5.0)")
    batch = model.process_batch_for_training(next(iter(loader)))
    tok = model.nets.net.encoder.action_network
    with torch.no_grad():
        half = len(batch["actions"]) // 2
        z = tok.encode(torch.as_tensor(batch["actions"][:half], device=model.device)
                       .reshape(-1, AC_DIM))
    print(f"kitchen learning floor: {FLOOR_EPOCHS} x {FLOOR_STEPS} steps of the 3 L / 128 d "
          f"flagship (batch 24, 128 codes) in {seconds:.1f} s, epoch losses {losses} "
          f"(final < initial - 2.0 and < 5.0 hold); launches (K1, K1f, K2) {counts} [{card}]")
    result = {"losses": losses, "seconds": seconds, "launches": counts,
              "z": z, "codebook": tok.quantizer.codebook.detach().clone()}
    del model, loader
    return result


@contextlib.contextmanager
def counted_run_epoch():
    """Inside: ``train_utils.run_epoch`` records the algo it trains
    (``seen["algo"]``) and adds the K1 launches made inside it to
    ``seen["k1_steps"]``; yields ``seen``."""
    from lipvq_tpu_torch.utils import train_utils

    seen = {"algo": None, "k1_steps": 0}
    run_epoch = train_utils.run_epoch

    def observed_run_epoch(model, loader, epoch, validate=False, num_steps=None):
        seen["algo"] = model
        before = launch_counts()[0]
        log = run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)
        seen["k1_steps"] += launch_counts()[0] - before
        return log

    train_utils.run_epoch = observed_run_epoch
    try:
        yield seen
    finally:
        train_utils.run_epoch = run_epoch


@contextlib.contextmanager
def captured_data():
    """Inside: ``train_utils.load_data_for_training`` and ``make_loaders``
    record what they return (``seen["datasets"]``, ``seen["loaders"]``)."""
    from lipvq_tpu_torch.utils import train_utils

    seen = {}
    load, make = train_utils.load_data_for_training, train_utils.make_loaders

    def observed_load(*args, **kwargs):
        seen["datasets"] = load(*args, **kwargs)
        return seen["datasets"]

    def observed_make(*args, **kwargs):
        seen["loaders"] = make(*args, **kwargs)
        return seen["loaders"]

    train_utils.load_data_for_training, train_utils.make_loaders = observed_load, observed_make
    try:
        yield seen
    finally:
        train_utils.load_data_for_training, train_utils.make_loaders = load, make


def counted_script(label: str, cfg_dict: dict, tmp: str, want: int, package: str,
                   epochs: int) -> dict:
    """``scripts/train.py`` (``main``) on ``cfg_dict``, counted as the main
    path: the script must print one "Rollout disabled" line naming
    ``package``'s ModuleNotFoundError and finish, K1 must launch exactly
    ``want`` times, all inside run_epoch (K1f and K2 never), and every logged
    number be finite over ``epochs`` epochs. Returns the in-process algo,
    the datasets and loaders the script built, the checkpoint directory, the
    launches, the logs and the seconds."""
    from lipvq_tpu_torch.scripts import train as train_script

    cfg_path = os.path.join(tmp, f"{label.replace(' ', '_')}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg_dict, f)
    out = io.StringIO()
    try:
        with counted_run_epoch() as seen, captured_data() as data:
            zero_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                ckpt_dir = train_script.main(["--config", cfg_path])
            script_s = time.perf_counter() - t0
            counts = launch_counts()
    except BaseException:
        print(out.getvalue()[-8000:])
        raise
    text = out.getvalue()
    disabled = [line for line in text.splitlines() if line.startswith("Rollout disabled")]
    for line in disabled:
        print(f"  {label} script: {line}")
    if ckpt_dir is None or len(disabled) != 1 or "ModuleNotFoundError" not in disabled[0] \
            or f"'{package}'" not in disabled[0]:
        print(text[-8000:])
        raise AssertionError(f"{label} script: want one 'Rollout disabled' line naming "
                             f"{package}'s ModuleNotFoundError and a finished run")
    if counts != (want, 0, 0) or seen["k1_steps"] != want:
        raise AssertionError(f"{label} script: launches (K1, K1f, K2) {counts}, K1 in the "
                             f"epochs {seen['k1_steps']}; want ({want}, 0, 0)")
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        logs = json.load(f)
    bad = {k: v for k, v in logs.items() if not np.isfinite(v).all()}
    if bad or len(logs.get("Train/Loss", [])) != epochs:
        raise AssertionError(f"{label} script: non-finite or missing logs {bad or logs}")
    return {"algo": seen["algo"], "datasets": data["datasets"], "loaders": data["loaders"],
            "ckpt_dir": ckpt_dir, "launches": counts, "logs": logs, "script_s": script_s}


def kitchen_script(label: str, data: list, tmp: str, what: str) -> dict:
    """``scripts/train.py`` (``main``) on ``data`` at ``kitchen_config``'s
    recipe, counted as the main path (``counted_script``): "Rollout
    disabled" naming mujoco, K1 exactly once per step."""
    run = counted_script(label, kitchen_config(data, os.path.join(tmp, "out")), tmp,
                         KITCHEN_EPOCHS * KITCHEN_STEPS, "mujoco", KITCHEN_EPOCHS)
    print(f"{label} script: {KITCHEN_EPOCHS} epochs x {KITCHEN_STEPS} steps of the 6 x 384 "
          f"flagship (512 codes, batch {KITCHEN_BATCH}) on {what} in {run['script_s']:.1f} s; "
          f"launches (K1, K1f, K2) {run['launches']}; Train/Loss {run['logs']['Train/Loss']}")
    return run


def kitchen_reload(label: str, algo, ckpt_dir: str, batch) -> None:
    """The last checkpoint, reloaded on the card (``policy_from_checkpoint``),
    gives GMM parameters bit-equal to the in-process algo's on ``batch``."""
    from lipvq_tpu_torch.utils import file_utils

    last = os.path.join(ckpt_dir, f"model_epoch_{KITCHEN_EPOCHS}.ckpt")
    reloaded, _ = file_utils.policy_from_checkpoint(last)  # CUDA by default
    assert reloaded.device.type == "cuda" and algo.device.type == "cuda"
    half = len(batch["actions"]) // 2
    inputs = ({k: v[half:] for k, v in batch["obs"].items()},
              {k: v[:half] for k, v in batch["obs"].items()}, batch["actions"][:half])
    dists = []
    with torch.inference_mode():
        for a in (algo, reloaded):
            dists.append(a.nets.forward_train(*(a._put_infer(x) for x in inputs),
                                              low_noise_eval=True)[0])
    if not all(torch.equal(x, y) for x, y in zip(*dists)):
        raise AssertionError(f"{label}: the reloaded checkpoint's GMM parameters differ from "
                             "the in-process algo's")
    print(f"{label} reload: policy_from_checkpoint on the card gives GMM parameters "
          "bit-equal to the in-process algo's on a corpus batch")


def kitchen_requests(card: str, label: str, algo, batch, policy, vec, ctx) -> dict:
    """``KITCHEN_REQUESTS`` requests of the 16 envs of ``vec`` with context
    ``ctx`` (K1 once each, finite actions); then the train step on ``batch``
    and the 16-env request timed (host) and profiled (device busy, idle
    share)."""
    obs = vec.reset()
    policy.start_episode(lang=vec.ep_lang_strs)
    zero_launch_counts()
    actions = []
    for _ in range(KITCHEN_REQUESTS):
        acts = policy.batched(obs, ctx)
        actions.append(acts)
        obs = vec.step(acts)[0]
    request_counts = launch_counts()
    if request_counts != (KITCHEN_REQUESTS, 0, 0):
        raise AssertionError(f"{label} requests: launches (K1, K1f, K2) {request_counts}")
    if not all(a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all() for a in actions):
        raise AssertionError(f"{label} requests: actions of the wrong shape or not finite")
    print(f"{label} requests: {KITCHEN_REQUESTS} requests of {N_ENVS} envs on frame-stacked "
          f"windows of the corpus's observations; launches (K1, K1f, K2) {request_counts}")

    def step():
        algo.train_on_batch(batch, KITCHEN_EPOCHS + 1)
        torch.cuda.synchronize()

    step_ms = host_ms(step, reps=20)
    step_busy, step_kernels = profile_device(
        lambda: algo.train_on_batch(batch, KITCHEN_EPOCHS + 1), 5)
    request_ms = host_ms(lambda: policy.batched(obs, ctx))
    request_busy, request_kernels = profile_device(lambda: policy.batched(obs, ctx), 10)
    out = {
        "request_launches": request_counts, "step_ms": step_ms, "step_busy_ms": step_busy,
        "step_idle_share": None if step_busy is None else 1 - step_busy / step_ms,
        "request_ms": request_ms, "request_busy_ms": request_busy,
        "request_idle_share": None if request_busy is None else 1 - request_busy / request_ms,
        "step_top_ops_ms": dict(sorted(step_kernels.items(), key=lambda kv: -kv[1])[:5]),
        "request_top_ops_ms": dict(sorted(request_kernels.items(), key=lambda kv: -kv[1])[:5])}
    print(f"{label} timing: step {step_ms:.3f} ms (device busy {step_busy} ms, idle share "
          f"{out['step_idle_share']}), {N_ENVS}-env request {request_ms:.3f} ms (device "
          f"busy {request_busy} ms, idle share {out['request_idle_share']}); top step "
          f"ops {out['step_top_ops_ms']} [{card}]")
    return out


def context_latents(algo, batch) -> tuple[torch.Tensor, torch.Tensor]:
    """The tokenizer's latents of a train step's context actions (K1's input
    on that path) and its codebook."""
    tok = algo.nets.net.encoder.action_network
    actions = torch.as_tensor(batch["actions"], device=algo.device)
    with torch.no_grad():
        z = tok.encode(actions[:len(actions) // 2].reshape(-1, actions.shape[-1]))
    return z, tok.quantizer.codebook.detach().clone()


def kitchen_latents(algo, batch, ctx) -> tuple[dict, torch.Tensor]:
    """The tokenizer's latents of a train step's context actions and of a
    16-env request's context, and its codebook: K1's inputs on those paths."""
    z_train, codebook = context_latents(algo, batch)
    tok = algo.nets.net.encoder.action_network
    ctx_actions = np.asarray(ctx["actions"])
    ctx_actions = np.repeat(ctx_actions, N_ENVS // len(ctx_actions), 0)
    with torch.no_grad():
        z_request = tok.encode(torch.as_tensor(ctx_actions, device=algo.device)
                               .reshape(-1, AC_DIM))
    return {"train": z_train, "request": z_request}, codebook


def kitchen_hold(label: str, data, lang, corpus: str) -> dict:
    """One fp32 step at the kitchen's width on ``data``, card against CPU
    (``hold_step``), with the context ids equal on both."""
    from lipvq_tpu_torch.algo import algo_factory

    hold_cfg = kitchen_config(data, compute_dtype="float32", hold=True)
    hcfg, sm, _, hold_loader, _ = kitchen_loaders(hold_cfg, lang, corpus)

    def make(device=None):
        return algo_factory("icl", hcfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device=device)

    card_algo, cpu_algo = make(), make("cpu")
    hbatch = card_algo.process_batch_for_training(next(iter(hold_loader)))
    half = len(hbatch["actions"]) // 2
    ctx_act = np.asarray(hbatch["actions"][:half]).reshape(-1, AC_DIM)
    with torch.no_grad():
        for a in (card_algo, cpu_algo):
            a.nets.net.encoder.action_network.to_latent.ci.fill_(30.0)
    codes = set_separated_codebook(cpu_algo.nets.net.encoder.action_network,
                                   (card_algo, cpu_algo), ctx_act)
    ids = [a.nets.net.encoder.action_network.tokenize(
        torch.from_numpy(ctx_act).to(a.device)).cpu() for a in (card_algo, cpu_algo)]
    if not torch.equal(*ids):
        raise AssertionError(f"{label} train parity: context ids differ between the card and "
                             "the CPU")
    losses, worst = hold_step(card_algo, cpu_algo, hbatch)
    distinct = int(torch.unique(ids[1]).numel())
    print(f"{label} train parity: one fp32 step of batch {KITCHEN_BATCH} on the card == the "
          f"CPU step (hold_step), context ids equal on {distinct} codes of {codes} set "
          f"apart; losses {losses}; worst {worst}")
    return {"losses": losses, "worst": worst, "codes": codes, "distinct_ids": distinct}


def kitchen_k1(card: str, label: str, cases) -> dict:
    """K1 at a kitchen phase's shapes, each case (name, (b, n, d), the path's
    own latents, its codebook): exact ids on Gaussian fixtures, the path's
    latents within the near-tie bound (``tie_gap``), timed beside its bound,
    the plain version and addmm + argmin."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_reference

    gen = torch.Generator(device="cuda").manual_seed(61)
    rows = {}
    for name, (b, n, d), zl, cl in cases:
        assert tuple(zl.shape) == (b, d) and tuple(cl.shape) == (n, d), (zl.shape, cl.shape)
        z = torch.randn(b, d, generator=gen, device="cuda")
        c = torch.randn(n, d, generator=gen, device="cuda")
        if not torch.equal(vq_nearest_cuda(z, c), vq_nearest_reference(z, c)):
            raise AssertionError(f"K1 ids differ from the plain version at {b}x{n}x{d}")
        got = vq_nearest_cuda(zl, cl)
        mismatches, max_gap, _ = check_near_ties(zl, cl, got, vq_nearest_reference(zl, cl),
                                                 bf16=False)
        ms = cuda_ms(lambda: vq_nearest_cuda(z, c), 50)
        plain_ms = cuda_ms(lambda: vq_nearest_reference(z, c), 10)
        library_ms = cuda_ms(
            lambda: torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1), 50)
        device_ms, _ = profile_device(lambda: vq_nearest_cuda(z, c), 50)
        bound_ms, bound_by = vq_bound(b, n, d)
        rows[name] = {"shape": [b, n, d], "mismatches": mismatches, "max_abs_err": max_gap,
                      "corpus_codes_used": int(torch.unique(got).numel()), "ms": ms,
                      "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 {label} {name} {b}x{n}x{d}: Gaussian ids exact; the corpus's latents "
              f"{mismatches} ids off the plain lookup (near-ties, max fp64 gap {max_gap:.3g}) on "
              f"{rows[name]['corpus_codes_used']} codes; K1 {ms:.4f} ms per call (device "
              f"{device_ms} ms), plain {plain_ms:.4f} ms, addmm+argmin {library_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return rows


def kitchen_phase(card: str) -> dict:
    """Phase 19: the kitchen on the card. The card's machine has no mujoco
    (asked: ``import mujoco`` raises ModuleNotFoundError), so the phase works
    from the committed OpenDrawer corpus (8 scripted demos, 456 steps):

    - ``scripts/train.py`` (``main``) trains the flagship at the core-8
      recipe's full width (6 x 384, 8 heads, 512 codes, batch 64, the
      suite's obs keys, the device-resident corpus), 2 epochs x 20 steps,
      rollouts on: the script must print "Rollout disabled" naming
      ``mujoco`` and train on; K1 exactly once per step, K1f and K2 never;
    - the last checkpoint reloads (``policy_from_checkpoint``) with GMM
      parameters bit-equal to the in-process algo's;
    - 8 requests of 16 envs on frame-stacked windows of the corpus's
      recorded observations (``VectorEnv`` over ``RecordedKitchen``), with a
      context from the script's context loader: K1 once per request;
    - one fp32 step at that width held on the card against the CPU
      (``hold_step``), the context ids equal on both;
    - the learning floor (``kitchen_floor``);
    - the step and the 16-env request timed (host) and profiled (device busy,
      idle share); K1 at the kitchen's shapes: exact ids on Gaussian
      fixtures, ``tie_gap`` on the corpus's own latents, timed beside its
      bound, the plain version and addmm + argmin."""
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.envs.vector_env import VectorEnv
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    export = Export(KITCHEN_CORPUS)
    results = {"corpus": {"demos": len(export.demos), "steps": export.data_attrs["total"]}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitchen_") as tmp:
        data = [{"path": KITCHEN_CORPUS, "weight": 1.0}]
        run = kitchen_script("kitchen", data, tmp,
                             f"the OpenDrawer corpus ({results['corpus']})")
        algo = run.pop("algo")
        lang = LangEncoder(device=algo.device)
        cfg_dict = kitchen_config(data)
        cfg_dict["train"]["hdf5_cache_mode"] = "low_dim"
        _, _, ds, loader, ctx_loader = kitchen_loaders(cfg_dict, lang)
        batch = algo.process_batch_for_training(next(iter(loader)))
        kitchen_reload("kitchen", algo, run["ckpt_dir"], batch)

        # requests: 16 envs replaying the corpus's observations, frame-stacked
        ctx = algo.process_batch_for_training(next(iter(ctx_loader)))
        policy = ICLRolloutPolicy(
            algo, action_normalization_stats=ds.get_action_normalization_stats(),
            lang_encoder=lang)
        vec = VectorEnv([lambda i=i: RecordedKitchen(export, export.demos[i % len(export.demos)],
                                                     start=(i // len(export.demos)) * 20)
                         for i in range(N_ENVS)], frame_stack=algo.context_length,
                        obs_keys=[k for k in KITCHEN_OBS_KEYS if k != "lang_emb"])
        results.update({"script_s": run["script_s"], "launches": run["launches"],
                        "losses": run["logs"]["Train/Loss"]})
        results.update(kitchen_requests(card, "kitchen", algo, batch, policy, vec, ctx))
        kitchen_z, codebook = kitchen_latents(algo, batch, ctx)
        del algo, policy, vec
        results["train_parity"] = kitchen_hold("kitchen", KITCHEN_CORPUS, lang, KITCHEN_CORPUS)
    results["floor"] = kitchen_floor(card)
    floor_z, floor_codebook = results["floor"].pop("z"), results["floor"].pop("codebook")
    results["k1"] = kitchen_k1(card, "kitchen", (
        ("train", KITCHEN_TRAIN_SHAPE, kitchen_z["train"], codebook),
        ("request", KITCHEN_REQUEST_SHAPE, kitchen_z["request"], codebook),
        ("floor_train", KITCHEN_FLOOR_SHAPE, floor_z, floor_codebook)))
    torch.cuda.empty_cache()
    return results


# phase 20, the multi-stage kitchen: the paper's multi-stage activities
# (lipvq_tpu_torch/robocasa/dataset_registry.py: MULTI_STAGE_TASK_DATASETS)
# from the corpus the port's collect_kitchen_suite wrote
# (lipvq_tpu_torch/assets/kitchen_multi/README.md); MicrowaveThawing is not
# in it: its expert needs ~750 steps, the collector's kitchen ends at 500
KITCHEN_MULTI_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lipvq_tpu_torch",
                                  "assets", "kitchen_multi")
KITCHEN_MULTI_TASKS = ("ArrangeVegetables", "RestockPantry", "PreSoakPan", "PrepareCoffee")


def kitchen_multi_phase(card: str) -> dict:
    """Phase 20: the flagship trained multi-task on the multi-stage
    activities of the committed corpus (``KITCHEN_MULTI_TASKS``, 3 scripted
    demos each). It asks for ``mujoco`` first and expects the
    ModuleNotFoundError; then:

    - ``scripts/train.py`` (``main``) trains the flagship at the core-8
      recipe's full width on the exports as one weighted ``train.data``
      list (a MetaDataset), 2 epochs x 20 steps, rollouts on: "Rollout
      disabled" naming mujoco, K1 exactly once per step, K1f and K2 never;
    - the last checkpoint reloads bit-equal;
    - 8 requests of 16 envs split across the tasks, each env on
      frame-stacked windows of a recorded demo of its task and with a
      context from another demo of the same task: K1 once per request;
    - one fp32 step held on the card against the CPU (``hold_step``);
    - the step and the 16-env request timed and profiled; K1 at the phase's
      shapes on the corpus's own latents."""
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.envs.vector_env import VectorEnv
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate

    try:
        import mujoco  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"kitchen_multi: import mujoco raises {type(e).__name__}: {e}")
    else:
        raise AssertionError("kitchen_multi: mujoco imports here; the phase is written for the "
                             "card's machine, which has no mujoco")
    paths = [os.path.join(KITCHEN_MULTI_ROOT, t) for t in KITCHEN_MULTI_TASKS]
    exports = [Export(p) for p in paths]
    results = {"corpus": {t: {"demos": len(e.demos), "steps": e.data_attrs["total"]}
                          for t, e in zip(KITCHEN_MULTI_TASKS, exports)}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitchen_multi_") as tmp:
        data = [{"path": p, "weight": 1.0} for p in paths]
        steps = sum(c["steps"] for c in results["corpus"].values())
        run = kitchen_script("kitchen_multi", data, tmp,
                             f"the {len(paths)} multi-stage exports ({steps} steps)")
        algo = run.pop("algo")
        lang = LangEncoder(device=algo.device)
        cfg_dict = kitchen_config(data)
        cfg_dict["train"]["hdf5_cache_mode"] = "low_dim"
        _, _, ds, loader, _ = kitchen_loaders(cfg_dict, lang, paths[0])
        batch = algo.process_batch_for_training(next(iter(loader)))
        kitchen_reload("kitchen_multi", algo, run["ckpt_dir"], batch)

        # env i replays demo j of task t; its context is demo j + 1 of task t
        n_tasks = len(exports)
        envs, items = [], []
        for i in range(N_ENVS):
            t = i % n_tasks
            demos = exports[t].demos
            j = (i // n_tasks) % len(demos)
            envs.append(lambda t=t, j=j, i=i: RecordedKitchen(
                exports[t], exports[t].demos[j], start=(i // (n_tasks * len(demos))) * 20))
            first = ds.datasets[t]._demo_id_to_start_indices[demos[(j + 1) % len(demos)]]
            items.append(ds[int(ds._boundaries[t]) + first])
        ctx = algo.process_batch_for_training(stack_collate(items))
        policy = ICLRolloutPolicy(
            algo, action_normalization_stats=ds.get_action_normalization_stats(),
            lang_encoder=lang)
        vec = VectorEnv(envs, frame_stack=algo.context_length,
                        obs_keys=[k for k in KITCHEN_OBS_KEYS if k != "lang_emb"])
        results.update({"script_s": run["script_s"], "launches": run["launches"],
                        "losses": run["logs"]["Train/Loss"]})
        results.update(kitchen_requests(card, "kitchen_multi", algo, batch, policy, vec, ctx))
        z, codebook = kitchen_latents(algo, batch, ctx)
        del algo, policy, vec
        results["train_parity"] = kitchen_hold("kitchen_multi", data, lang, paths[0])
    results["k1"] = kitchen_k1(card, "kitchen_multi", (
        ("train", KITCHEN_TRAIN_SHAPE, z["train"], codebook),
        ("request", KITCHEN_REQUEST_SHAPE, z["request"], codebook)))
    torch.cuda.empty_cache()
    return results


# phase 21, the multi-task kitchen suite through its own entry point: a corpus
# directory of links to two committed exports of the suite's full task set
KITCHEN_SUITE_CORPORA = {"OpenDrawer": KITCHEN_CORPUS,
                         "PrepareCoffee": os.path.join(KITCHEN_MULTI_ROOT, "PrepareCoffee")}


def _suite_main(label: str, argv: list) -> tuple[str, tuple, int]:
    """The suite twin's ``main(argv)`` in process, counted as the main path:
    -> (its stdout, the launches (K1, K1f, K2), K1 launches inside
    ``run_epoch``)."""
    from lipvq_tpu_torch.examples import kitchen_multitask_suite as suite

    out = io.StringIO()
    try:
        with counted_run_epoch() as seen:
            zero_launch_counts()
            with contextlib.redirect_stdout(out):
                suite.main(argv)
            counts = launch_counts()
    except BaseException:
        print(out.getvalue()[-8000:])
        raise
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("[collect]", "[resume]", "[train]")):
            print(f"  {label}: {line}")
    return text, counts, seen["k1_steps"]


def kitchen_suite_phase(card: str) -> dict:
    """Phase 21: the multi-task kitchen suite twin
    (``lipvq_tpu_torch.examples.kitchen_multitask_suite``) on the card. It
    asks for ``mujoco`` first and expects the ModuleNotFoundError; then:

    - ``main`` with ``--train_only --balance_tasks`` over a corpus directory
      linking the committed OpenDrawer and PrepareCoffee exports, at the
      core-8 recipe's full width, 2 epochs x 20 steps: no collection, K1
      exactly once per step, K1f and K2 never;
    - ``main`` again with ``--resume --epochs 3``: start epoch 3 from the
      state's ``.epoch`` sidecar, 20 more steps (K1 20), ``model_epoch_3``;
    - the last checkpoint loaded on the card (``policy_from_checkpoint``);
      per task, ``task_policy`` builds the policy and context, which serve 8
      requests of 16 envs on that task's recorded observations (K1 once
      each); the step and the 16-env request timed and profiled;
    - K1 at the phase's shapes on its own latents."""
    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.envs.vector_env import VectorEnv
    from lipvq_tpu_torch.examples import kitchen_multitask_suite as suite
    from lipvq_tpu_torch.utils import file_utils
    from lipvq_tpu_torch.utils import train_utils as TrainUtils
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    try:
        import mujoco  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"kitchen_suite: import mujoco raises {type(e).__name__}: {e}")
    else:
        raise AssertionError("kitchen_suite: mujoco imports here; the phase is written for the "
                             "card's machine, which has no mujoco")
    tasks = list(KITCHEN_SUITE_CORPORA)
    exports = {t: Export(p) for t, p in KITCHEN_SUITE_CORPORA.items()}
    results = {"corpus": {t: {"demos": len(e.demos), "steps": e.data_attrs["total"]}
                          for t, e in exports.items()}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitchen_suite_") as tmp:
        corpus_dir, out = os.path.join(tmp, "corpora"), os.path.join(tmp, "out")
        os.makedirs(corpus_dir)
        for t, p in KITCHEN_SUITE_CORPORA.items():
            os.symlink(p, os.path.join(corpus_dir, t))
        argv = ["--tasks", ",".join(tasks), "--corpus_dir", corpus_dir, "--out", out,
                "--train_only", *KITCHEN_SUITE_RECIPE, "--balance_tasks"]
        want = KITCHEN_EPOCHS * KITCHEN_STEPS
        t0 = time.perf_counter()
        text, counts, k1_steps = _suite_main("kitchen_suite", argv)
        train_s = time.perf_counter() - t0
        if "[collect]" in text or "[train] done" not in text:
            raise AssertionError("kitchen_suite: want no collection and a finished training")
        if counts != (want, 0, 0) or k1_steps != want:
            raise AssertionError(f"kitchen_suite train: launches (K1, K1f, K2) {counts}, K1 in "
                                 f"the steps {k1_steps}; want ({want}, 0, 0)")
        resume_argv = argv + ["--resume", "--epochs", str(KITCHEN_EPOCHS + 1)]
        t0 = time.perf_counter()
        text, resume_counts, k1_steps = _suite_main("kitchen_suite resume", resume_argv)
        resume_s = time.perf_counter() - t0
        resumed = [line for line in text.splitlines() if line.startswith("[resume]")]
        if len(resumed) != 1 or not resumed[0].endswith(f"-> start_epoch {KITCHEN_EPOCHS + 1}"):
            raise AssertionError(f"kitchen_suite resume: want one '[resume] ... -> start_epoch "
                                 f"{KITCHEN_EPOCHS + 1}' line, got {resumed}")
        if resume_counts != (KITCHEN_STEPS, 0, 0) or k1_steps != KITCHEN_STEPS:
            raise AssertionError(f"kitchen_suite resume: launches (K1, K1f, K2) {resume_counts}; "
                                 f"want ({KITCHEN_STEPS}, 0, 0)")
        last = glob.glob(os.path.join(out, "run", "**", f"model_epoch_{KITCHEN_EPOCHS + 1}.ckpt"),
                         recursive=True)
        if len(last) != 1:
            raise AssertionError(f"kitchen_suite resume: model_epoch_{KITCHEN_EPOCHS + 1}.ckpt "
                                 f"written {len(last)} times")
        losses = []
        for path in sorted(glob.glob(os.path.join(out, "run", "**", "scalars.json"),
                                     recursive=True)):
            with open(path) as f:
                losses += json.load(f)["Train/Loss"]
        if len(losses) != KITCHEN_EPOCHS + 1 or not np.isfinite(losses).all():
            raise AssertionError(f"kitchen_suite: epoch losses {losses}")
        print(f"kitchen_suite: the suite's main trained {KITCHEN_EPOCHS} x {KITCHEN_STEPS} steps "
              f"of the 6 x 384 flagship (512 codes, batch {KITCHEN_BATCH}, balanced over "
              f"{tasks}) in {train_s:.1f} s, resumed at epoch {KITCHEN_EPOCHS + 1} for "
              f"{KITCHEN_STEPS} more in {resume_s:.1f} s; launches (K1, K1f, K2) {counts} + "
              f"{resume_counts}; epoch losses {losses}")
        results.update({"train_s": train_s, "resume_s": resume_s, "launches": counts,
                        "resume_launches": resume_counts, "losses": losses})

        model, ckpt = file_utils.policy_from_checkpoint(last[0])  # CUDA by default
        args = suite.build_parser().parse_args(argv)
        lang = LangEncoder(device=model.device)
        cfg = suite.make_config(args, {t: os.path.join(corpus_dir, t) for t in tasks})
        with cfg.unlocked():
            cfg.train.hdf5_cache_mode = "low_dim"
        ds, _ = TrainUtils.load_data_for_training(cfg, obs_keys=model.obs_shapes.keys(),
                                                  lang_encoder=lang)
        batch = model.process_batch_for_training(next(iter(TrainUtils.make_loaders(
            cfg, ds, None)[0])))
        results["tasks"] = {}
        for t in tasks:
            policy, ctx, tcfg = suite.task_policy(args, model, ckpt, t,
                                                  os.path.join(corpus_dir, t), lang)
            ex = exports[t]
            vec = VectorEnv([lambda i=i, ex=ex: RecordedKitchen(
                ex, ex.demos[i % len(ex.demos)], start=(i // len(ex.demos)) * 20)
                for i in range(N_ENVS)], frame_stack=tcfg.train.frame_stack,
                obs_keys=[k for k in model.obs_shapes if k != "lang_emb"])
            results["tasks"][t] = kitchen_requests(card, f"kitchen_suite {t}", model, batch,
                                                   policy, vec, ctx)
            z, codebook = kitchen_latents(model, batch, ctx)
        del model, policy, vec
    results["k1"] = kitchen_k1(card, "kitchen_suite", (
        ("train", KITCHEN_TRAIN_SHAPE, z["train"], codebook),
        ("request", KITCHEN_REQUEST_SHAPE, z["request"], codebook)))
    torch.cuda.empty_cache()
    return results


# phase 22, the dataset tools: the committed OpenDrawer corpus split and cut
# into subsets by the port's tools, the flagship trained on the filter keys,
# and a D4RL buffer at Hopper's widths converted and trained on. The card's
# machine has no mujoco, gymnasium or h5py: the tools that run there work over
# exports, and the D4RL buffer is an .npz
DATA_TOOLS_RATIO, DATA_TOOLS_SIZES = 0.25, (4,)
DATA_TOOLS_STEPS, DATA_TOOLS_VALID_STEPS = 10, 5  # per epoch, KITCHEN_EPOCHS epochs
# hopper-medium-v2's widths (obs 11, act 3) and 1000-step timeouts; 200
# episodes, a fifth of its ~1M transitions
D4RL_EPISODES, D4RL_EPISODE_LEN, D4RL_OBS, D4RL_ACT = 200, 1000, 11, 3
D4RL_STEPS, D4RL_CODES = 20, 1024  # the flagship template's codebook


def _tool_main(main, argv: list, echo: bool = True) -> str:
    """A dataset tool's ``main(argv)``; returns what it reported and, with
    ``echo``, prints it."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    text = out.getvalue()
    for line in text.strip().splitlines() if echo else ():
        print(f"  data_tools: {line}")
    return text


def assert_mask_honoured(label: str, ds, export, mask: str) -> int:
    """``ds`` holds exactly the demos of ``mask`` and one item per step of
    them (the windows are padded); returns that step count."""
    demos = sorted(export.mask(mask), key=lambda d: int(d[5:]))
    steps = sum(int(export.demo_attrs(d)["num_samples"]) for d in demos)
    if list(ds.demos) != demos or len(ds) != steps:
        raise AssertionError(f"{label}: the {mask!r} dataset holds {ds.demos} ({len(ds)} items); "
                             f"want the mask's {demos} ({steps} steps)")
    return steps


def step_timing(card: str, label: str, algo, batch, validate: bool = False) -> dict:
    """One train (or validation) step on ``batch``, timed (host) and profiled
    (device busy, idle share)."""
    def step():
        algo.train_on_batch(batch, KITCHEN_EPOCHS + 1, validate=validate)
        torch.cuda.synchronize()

    step_ms = host_ms(step, reps=10)
    busy, kernels = profile_device(
        lambda: algo.train_on_batch(batch, KITCHEN_EPOCHS + 1, validate=validate), 5)
    out = {"step_ms": step_ms, "step_busy_ms": busy,
           "step_idle_share": None if busy is None else 1 - busy / step_ms,
           "step_top_ops_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])}
    print(f"{label} timing: {'validation' if validate else 'train'} step {step_ms:.3f} ms "
          f"(device busy {busy} ms, idle share {out['step_idle_share']}) [{card}]")
    return out


def write_d4rl_buffer(path: str) -> str:
    """A seeded D4RL-style flat buffer at Hopper's widths: 200 episodes of
    1000 steps, each cut by a timeout, no terminal."""
    rng = np.random.default_rng(22)
    n = D4RL_EPISODES * D4RL_EPISODE_LEN
    timeouts = np.zeros(n, np.float32)
    timeouts[D4RL_EPISODE_LEN - 1::D4RL_EPISODE_LEN] = 1
    np.savez(path, observations=rng.standard_normal((n, D4RL_OBS), np.float32),
             actions=rng.uniform(-1, 1, (n, D4RL_ACT)).astype(np.float32),
             rewards=rng.standard_normal(n, np.float32), terminals=np.zeros(n, np.float32),
             timeouts=timeouts)
    return path


def data_tools_phase(card: str) -> dict:
    """Phase 22: the dataset tools and conversion scripts over exports, and
    the flagship trained through them. ``import mujoco``, ``import gymnasium``
    and ``import h5py`` must raise; then:

    - a copy of the committed OpenDrawer corpus (8 demos, 456 steps) gets
      ``split_train_val`` (ratio 0.25, seed 0) and ``filter_dataset_size``
      (sizes 4); ``get_dataset_info``, ``set_dataset_attr`` (an ``MG_`` env
      name), ``remove_mg_env_label`` and ``copy_ds_key`` (from the committed
      corpus) run over it, each through its ``main``;
    - ``scripts/train.py`` trains the kitchen flagship at the core-8
      recipe's full width (6 x 384, 8 heads, 512 codes, batch 64, the
      device-resident corpus) on ``hdf5_filter_key="train"`` with validation
      on ``"valid"``, 2 epochs x 10 steps and 5 validation steps each: the
      train and valid datasets hold exactly their masks' demos and steps,
      the ``DeviceCachedLoader`` one item per train-mask step; "Rollout
      disabled" names mujoco; K1 exactly 20 + 10, K1f and K2 never;
    - ``convert_d4rl`` turns a seeded .npz buffer at Hopper's widths (200
      episodes x 1000 steps, timeouts) into an export for ``Hopper-v4``, and
      ``scripts/train.py`` trains the flagship (1024 codes) on its ``flat``
      observation for 20 steps from the low-dim cache (the device-resident
      corpus would materialize all 200 000 windows first): "Rollout
      disabled" names gymnasium; K1 exactly 20;
    - a train step of each run and a validation step timed and profiled; K1
      at the phase's shapes on its own latents."""
    import shutil

    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.scripts import filter_dataset_size, get_dataset_info, split_train_val
    from lipvq_tpu_torch.scripts.conversion import (
        convert_d4rl,
        copy_ds_key,
        remove_mg_env_label,
        set_dataset_attr,
    )

    for package in ("mujoco", "gymnasium", "h5py"):
        try:
            __import__(package)
        except ModuleNotFoundError as e:
            print(f"data_tools: import {package} raises {type(e).__name__}: {e}")
        else:
            raise AssertionError(f"data_tools: {package} imports here; the phase is written for "
                                 f"the card's machine, which has no {package}")
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_tools_") as tmp:
        t0 = time.perf_counter()
        root = shutil.copytree(KITCHEN_CORPUS, os.path.join(tmp, "OpenDrawer"))
        text = _tool_main(split_train_val.main, ["--dataset", root, "--ratio",
                                                 str(DATA_TOOLS_RATIO)])
        if text.strip() != "train: 6 demos, valid: 2 demos":
            raise AssertionError(f"data_tools: split_train_val reported {text!r}")
        _tool_main(filter_dataset_size.main,
                   ["--dataset", root, "--sizes", *map(str, DATA_TOOLS_SIZES)])
        _tool_main(set_dataset_attr.main, ["--dataset", root, "--attr", "env_args.env_name",
                                           "--value", "MG_OpenDrawer"])
        text = _tool_main(remove_mg_env_label.main, ["--dataset", root])
        if text.strip() != "env_name is now 'OpenDrawer'":
            raise AssertionError(f"data_tools: remove_mg_env_label reported {text!r}")
        text = _tool_main(copy_ds_key.main, ["--src", KITCHEN_CORPUS, "--target", root,
                                             "--keys", "action_dict", "actions"])
        if not text.startswith("copied 16 key instances"):
            raise AssertionError(f"data_tools: copy_ds_key reported {text!r}")
        info = json.loads(_tool_main(get_dataset_info.main, ["--dataset", root], echo=False))
        print(f"  data_tools: {json.dumps(info)}")
        want = {"n_demos": 8, "total_samples": 456, "env_name": "OpenDrawer",
                "filter_keys": ["4_demos", "train", "valid"]}
        if {k: info[k] for k in want} != want:
            raise AssertionError(f"data_tools: get_dataset_info reported {info}")
        export = Export(root)
        source = Export(KITCHEN_CORPUS)
        for demo in export.demos:
            if not np.array_equal(export.load(demo, "actions"), source.load(demo, "actions")):
                raise AssertionError(f"data_tools: copy_ds_key changed {demo}/actions")
        results["tools_s"] = time.perf_counter() - t0
        results["masks"] = {k: export.mask(k) for k in export.masks}
        print(f"data_tools: the tools over a copy of the OpenDrawer corpus in "
              f"{results['tools_s']:.2f} s; masks {results['masks']}")

        # the kitchen flagship on the filter keys
        cfg = kitchen_config(root, os.path.join(tmp, "out_filter"))
        cfg["train"].update({"hdf5_filter_key": "train", "hdf5_validation_filter_key": "valid"})
        cfg["experiment"].update({"validate": True, "epoch_every_n_steps": DATA_TOOLS_STEPS,
                                  "validation_epoch_every_n_steps": DATA_TOOLS_VALID_STEPS})
        want_k1 = KITCHEN_EPOCHS * (DATA_TOOLS_STEPS + DATA_TOOLS_VALID_STEPS)
        run = counted_script("data_tools filter_key", cfg, tmp, want_k1, "mujoco",
                             KITCHEN_EPOCHS)
        train_ds, valid_ds = run["datasets"]
        train_loader, valid_loader, _ = run["loaders"]
        train_steps = assert_mask_honoured("data_tools train", train_ds, export, "train")
        valid_steps = assert_mask_honoured("data_tools valid", valid_ds, export, "valid")
        if type(train_loader).__name__ != "DeviceCachedLoader" or train_loader._n != train_steps:
            raise AssertionError(f"data_tools: the train loader is {type(train_loader).__name__} "
                                 f"over {getattr(train_loader, '_n', None)} items; want the "
                                 f"DeviceCachedLoader over the {train_steps} train-mask steps")
        if len(run["logs"].get("Valid/Loss", [])) != KITCHEN_EPOCHS:
            raise AssertionError(f"data_tools: validation losses {run['logs'].get('Valid/Loss')}")
        algo = run["algo"]
        steps = KITCHEN_EPOCHS * DATA_TOOLS_STEPS
        print(f"data_tools filter_key script: {KITCHEN_EPOCHS} epochs x {DATA_TOOLS_STEPS} steps "
              f"+ {DATA_TOOLS_VALID_STEPS} validation steps of the 6 x 384 flagship (512 codes, "
              f"batch {KITCHEN_BATCH}) in {run['script_s']:.1f} s; the 'train' mask "
              f"({len(train_ds.demos)} demos, {train_steps} steps) through the "
              f"DeviceCachedLoader ({train_loader._n} items on the card), the 'valid' mask "
              f"({len(valid_ds.demos)} demos, {valid_steps} steps) through the host "
              f"{type(valid_loader).__name__}; launches (K1, K1f, K2) {run['launches']}; "
              f"Train/Loss {run['logs']['Train/Loss']}, Valid/Loss {run['logs']['Valid/Loss']}")
        timing = {k: per_step_ms(run["logs"], f"Timing_Stats/Train_{k}", DATA_TOOLS_STEPS)
                  for k in ("Data_Loading", "Process_Batch", "Train_Batch")}
        batch = next(iter(train_loader))  # preprocessed, on the card
        valid_batch = algo.process_batch_for_training(next(iter(valid_loader)))
        results["filter_key"] = {
            "script_s": run["script_s"], "launches": run["launches"],
            "train_mask": {"demos": len(train_ds.demos), "steps": train_steps},
            "valid_mask": {"demos": len(valid_ds.demos), "steps": valid_steps},
            "train_loader": type(train_loader).__name__, "train_loader_items": train_loader._n,
            "valid_loader": type(valid_loader).__name__, "losses": run["logs"]["Train/Loss"],
            "valid_losses": run["logs"]["Valid/Loss"], "script_step_ms": timing,
            "train": step_timing(card, "data_tools filter_key", algo, batch),
            "valid": step_timing(card, "data_tools filter_key", algo, valid_batch,
                                 validate=True)}
        z_train, codebook = context_latents(algo, batch)
        z_valid, _ = context_latents(algo, valid_batch)
        del algo, run, batch, valid_batch, train_loader, valid_loader

        # a D4RL buffer converted, and the flagship trained on it
        t0 = time.perf_counter()
        buf = write_d4rl_buffer(os.path.join(tmp, "hopper.npz"))
        d4rl_root = os.path.join(tmp, "hopper_export")
        text = _tool_main(convert_d4rl.main, ["--buffer", buf, "--env_name", "Hopper-v4",
                                              "--output", d4rl_root])
        convert_s = time.perf_counter() - t0
        d4rl = Export(d4rl_root)
        if len(d4rl.demos) != D4RL_EPISODES or \
                d4rl.data_attrs["total"] != D4RL_EPISODES * D4RL_EPISODE_LEN:
            raise AssertionError(f"data_tools: convert_d4rl reported {text!r}")
        cfg = kitchen_config(d4rl_root, os.path.join(tmp, "out_d4rl"))
        cfg["train"].update({"num_epochs": 1, "hdf5_cache_mode": "low_dim"})
        cfg["experiment"]["epoch_every_n_steps"] = D4RL_STEPS
        cfg["algo"]["vq"]["num_codes"] = D4RL_CODES
        cfg["observation"]["modalities"]["obs"]["low_dim"] = ["flat"]
        run = counted_script("data_tools d4rl", cfg, tmp, D4RL_STEPS, "gymnasium", 1)
        train_ds = run["datasets"][0]
        if len(train_ds) != D4RL_EPISODES * D4RL_EPISODE_LEN:
            raise AssertionError(f"data_tools d4rl: {len(train_ds)} items")
        algo = run["algo"]
        print(f"data_tools d4rl: convert_d4rl wrote {len(d4rl.demos)} demos "
              f"({d4rl.data_attrs['total']} transitions) in {convert_s:.1f} s; scripts/train.py "
              f"trained {D4RL_STEPS} steps of the 6 x 384 flagship ({D4RL_CODES} codes, batch "
              f"{KITCHEN_BATCH}, obs 'flat' {D4RL_OBS}, actions {D4RL_ACT}) in "
              f"{run['script_s']:.1f} s; launches (K1, K1f, K2) {run['launches']}; Train/Loss "
              f"{run['logs']['Train/Loss']}")
        d4rl_batch = algo.process_batch_for_training(next(iter(run["loaders"][0])))
        results["d4rl"] = {
            "demos": len(d4rl.demos), "transitions": d4rl.data_attrs["total"],
            "convert_s": convert_s, "script_s": run["script_s"], "launches": run["launches"],
            "losses": run["logs"]["Train/Loss"],
            "script_step_ms": {k: per_step_ms(run["logs"], f"Timing_Stats/Train_{k}", D4RL_STEPS)
                               for k in ("Data_Loading", "Process_Batch", "Train_Batch")},
            "train": step_timing(card, "data_tools d4rl", algo, d4rl_batch)}
        z_d4rl, d4rl_codebook = context_latents(algo, d4rl_batch)
        del algo, run, d4rl_batch, train_ds
    results["k1"] = kitchen_k1(card, "data_tools", (
        ("train", (len(z_train), len(codebook), z_train.shape[1]), z_train, codebook),
        ("valid", (len(z_valid), len(codebook), z_valid.shape[1]), z_valid, codebook),
        ("d4rl_train", (len(z_d4rl), len(d4rl_codebook), z_d4rl.shape[1]), z_d4rl,
         d4rl_codebook)))
    torch.cuda.empty_cache()
    return results


# phase 23, the config, sweep, profiling and loader tools, the
# model-prediction plots and the simple examples; the plots load a kitchen
# flagship checkpoint written by a short train run on the committed corpus
TOOLS_DEMOS = 2  # plot_predictions over the corpus's first two demos
TOOLS_STEPS = 5  # train steps of the checkpoint the plots load
# the predicted actions of the fp32 checkpoint, card against CPU, on the
# same GMM draws (actions within [-1, 1])
PLOT_ATOL = 1e-4
TOOLS_REQUEST_REPS = 20
# K1 calls inside profile_utils.trace: a window of one ~0.05 ms launch can
# miss the kernel's device record late in a long process
TOOLS_TRACED_CALLS = 20


@contextlib.contextmanager
def recorded_policies(log: list, draws: bool = False):
    """Inside: the policy that ``file_utils.policy_from_checkpoint`` returns
    appends each ``get_action`` result to ``log``; with ``draws`` its GMM
    sample takes the draws of a CPU generator seeded by the call's index, so
    two devices sample alike. Yields the loaded models."""
    from lipvq_tpu_torch.models.distributions import gmm_sample_from_draws
    from lipvq_tpu_torch.utils import file_utils

    load, models = file_utils.policy_from_checkpoint, []

    def recorded(*args, **kwargs):
        model, ckpt = load(*args, **kwargs)
        get_action, start = model.get_action, len(log)

        def get(obs, ctx, goal=None):
            out = get_action(obs, ctx, goal)
            log.append(np.array(out))
            return out

        def head(dists, draws_=None):
            gen = torch.Generator().manual_seed(1000 + len(log) - start)
            means = dists.means.shape
            u = torch.rand(dists.logits.shape, generator=gen)
            eps = torch.randn(means[:-2] + means[-1:], generator=gen)
            return gmm_sample_from_draws(dists, u.to(dists.means.device),
                                         eps.to(dists.means.device))
        model.get_action = get
        if draws:
            model._action_from_head = head
        models.append(model)
        return model, ckpt
    file_utils.policy_from_checkpoint = recorded
    try:
        yield models
    finally:
        file_utils.policy_from_checkpoint = load


def hold_checkpoint(ckpt: str, out: str, actions: np.ndarray) -> int:
    """``ckpt`` rewritten for a card-against-CPU comparison as ``out``: fp32
    compute, the tokenizer's ``to_latent.ci`` raised to 30 and the codebook
    set so that each row of ``actions`` has one nearest code by a clear
    margin (``set_separated_codebook``); returns the codes in use."""
    from lipvq_tpu_torch.utils import file_utils

    payload = file_utils.load_checkpoint_dict(ckpt)
    cfg = json.loads(payload["config"])
    cfg["algo"]["transformer"]["compute_dtype"] = "float32"
    payload["config"] = json.dumps(cfg, indent=4)
    torch.save(payload, out)
    model, _ = file_utils.policy_from_checkpoint(out, device="cpu")
    tok = model.nets.net.encoder.action_network
    with torch.no_grad():
        tok.to_latent.ci.fill_(30.0)
    codes = set_separated_codebook(tok, (model,), actions)
    payload["model"] = model.serialize()
    torch.save(payload, out)
    return codes


def _example_main(main, argv: list) -> tuple[list, tuple]:
    """An example's ``main(argv)`` counted as the main path: (its printed
    lines, the launches (K1, K1f, K2))."""
    out = io.StringIO()
    zero_launch_counts()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines(), launch_counts()


def tools_phase(card: str) -> dict:
    """Phase 23: the tools, the plots and the examples on the card. ``import
    h5py`` must raise (the card's machine has none); then:

    - ``scripts/train.py`` writes a checkpoint of the kitchen flagship at the
      core-8 recipe's full width (6 x 384, 8 heads, 512 codes, batch 64) on
      the committed OpenDrawer corpus, 1 epoch x 5 steps (K1 5);
    - ``scripts/plot_model_predictions.plot_predictions`` over the corpus's
      first 2 demos on the card, counted as the main path: K1 exactly once
      per prediction (one ``get_action`` per 10-step window), K1f and K2
      never; one PNG per demo written (by PIL where matplotlib is absent);
    - the same checkpoint in fp32 with codes kept apart, plotted on the card
      and on the CPU with the same GMM draws: every predicted action within
      ``PLOT_ATOL``;
    - one prediction request timed (host) and profiled (device busy, idle
      share); K1 at the request's shape (10 x 512 x 823) on its own latents;
    - ``examples/tokenize_actions`` (K1 1) and ``examples/simple_train_loop``
      (K1 15, loss codebook; K2 0) through their ``main`` on the card;
    - ``utils/profile_utils``: ``timeit`` in both modes and ``trace`` around
      20 K1 calls, the kernel's name found in the trace file;
    - ``scripts/bench_loader.main`` at its defaults, its JSON printed;
    - ``config_gen/icl_xfmr_gen`` and ``hyperparam_helper`` into a temporary
      directory; one generated ICL config loaded by ``config_factory``."""
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.examples import simple_train_loop, tokenize_actions
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda
    from lipvq_tpu_torch.scripts import bench_loader, hyperparam_helper
    from lipvq_tpu_torch.scripts.config_gen import icl_xfmr_gen
    from lipvq_tpu_torch.scripts.plot_model_predictions import plot_predictions
    from lipvq_tpu_torch.utils import profile_utils

    try:
        __import__("h5py")
    except ModuleNotFoundError as e:
        print(f"tools: import h5py raises {type(e).__name__}: {e}")
    else:
        raise AssertionError("tools: h5py imports here; the phase is written for the card's "
                             "machine, which has no h5py")
    try:
        __import__("matplotlib")
        drawer = "matplotlib"
    except ModuleNotFoundError:
        drawer = "PIL"
    export = Export(KITCHEN_CORPUS)
    demos = sorted(export.demos)[:TOOLS_DEMOS]
    want = sum(int(export.demo_attrs(d)["num_samples"]) - 10 for d in demos)
    results = {"drawer": drawer, "demos": demos, "predictions": want}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        cfg = kitchen_config(KITCHEN_CORPUS, os.path.join(tmp, "out"))
        cfg["train"]["num_epochs"] = 1
        cfg["experiment"]["epoch_every_n_steps"] = TOOLS_STEPS
        run = counted_script("tools checkpoint", cfg, tmp, TOOLS_STEPS, "mujoco", 1)
        ckpt = os.path.join(run["ckpt_dir"], "model_epoch_1.ckpt")
        results["checkpoint_launches"] = run["launches"]
        del run

        # the main path: the plots on the card
        log = []
        with recorded_policies(log) as models:
            zero_launch_counts()
            t0 = time.perf_counter()
            paths = plot_predictions(ckpt, KITCHEN_CORPUS, os.path.join(tmp, "png"),
                                     TOOLS_DEMOS)
            plot_s = time.perf_counter() - t0
            counts = launch_counts()
        model = models[0]
        if model.device.type != "cuda" or counts != (want, 0, 0) or len(log) != want:
            raise AssertionError(f"tools plot_predictions: {len(log)} predictions on "
                                 f"{model.device}, launches (K1, K1f, K2) {counts}; want "
                                 f"({want}, 0, 0) on the card")
        names = [os.path.basename(p) for p in paths]
        if names != [f"{d}_predictions.png" for d in demos] or \
                not all(os.path.getsize(p) > 0 for p in paths):
            raise AssertionError(f"tools plot_predictions wrote {names}")
        preds = np.stack(log)
        if preds.shape != (want, 1, AC_DIM) or not np.isfinite(preds).all():
            raise AssertionError(f"tools plot_predictions: predictions {preds.shape}, finite "
                                 f"{np.isfinite(preds).all()}")
        results.update({"plot_s": plot_s, "launches": counts, "pngs": names,
                        "png_bytes": [os.path.getsize(p) for p in paths]})
        print(f"tools plot_predictions: {want} predictions over {demos} of the OpenDrawer "
              f"corpus by the 6 x 384 flagship (512 codes, bf16) on the card in "
              f"{plot_s:.2f} s; launches (K1, K1f, K2) {counts}; wrote {names} with "
              f"{drawer} ({results['png_bytes']} bytes)")

        # one request: the window of the last prediction, timed and profiled
        t = model.context_length
        acts = export.load(demos[0], "actions").astype(np.float32)
        obs = {k: (np.zeros((1, t, *model.obs_shapes[k]), np.float32) if k == "lang_emb"
                   else export.load(demos[0], f"obs/{k}")[:t].astype(np.float32)[None])
               for k in model.obs_shapes}
        ctx = {"obs": obs, "actions": acts[:t][None]}
        request_ms = host_ms(lambda: model.get_action(obs, ctx), reps=TOOLS_REQUEST_REPS)
        busy, kernels = profile_device(lambda: model.get_action(obs, ctx), 10)
        results["request"] = {
            "ms": request_ms, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / request_ms,
            "top_ops_ms": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:5])}
        print(f"tools timing: one prediction request {request_ms:.3f} ms (device busy {busy} "
              f"ms, idle share {results['request']['idle_share']}); top ops "
              f"{results['request']['top_ops_ms']} [{card}]")
        tok = model.nets.net.encoder.action_network
        with torch.no_grad():
            z_request = tok.encode(torch.as_tensor(acts[:t], device=model.device))
        codebook = tok.quantizer.codebook.detach().clone()
        del model, models

        # the fp32 checkpoint with codes kept apart, card against CPU
        hold = os.path.join(tmp, "hold.ckpt")
        all_acts = np.concatenate([export.load(d, "actions") for d in demos]).astype(np.float32)
        codes = hold_checkpoint(ckpt, hold, all_acts)
        got = {}
        for device in ("cuda", "cpu"):
            log = []
            with recorded_policies(log, draws=True):
                zero_launch_counts()
                plot_predictions(hold, KITCHEN_CORPUS, os.path.join(tmp, f"png_{device}"),
                                 TOOLS_DEMOS, device=device)
                hold_counts = launch_counts()
            got[device] = np.stack(log)
            if hold_counts != ((want, 0, 0) if device == "cuda" else (0, 0, 0)):
                raise AssertionError(f"tools fp32 plot on {device}: launches {hold_counts}")
        err = float(np.abs(got["cuda"] - got["cpu"]).max())
        if got["cuda"].shape != (want, 1, AC_DIM) or not err <= PLOT_ATOL:
            raise AssertionError(f"tools fp32 plot: card against CPU max abs error {err} "
                                 f"(want <= {PLOT_ATOL})")
        results["hold"] = {"codes": codes, "max_abs_err": err, "atol": PLOT_ATOL}
        print(f"tools fp32 plot: {want} predictions on the card within {err:.3g} of the "
              f"CPU's (<= {PLOT_ATOL}) on the same GMM draws, {codes} codes kept apart")

        # the examples on the card
        examples = {}
        for name, main, want_counts in (
                ("tokenize_actions", tokenize_actions.main, (1, 0, 0)),
                ("simple_train_loop", simple_train_loop.main, (15, 0, 0))):
            t0 = time.perf_counter()
            lines, ex_counts = _example_main(main, [])
            seconds = time.perf_counter() - t0
            if ex_counts != want_counts:
                raise AssertionError(f"tools {name}: launches (K1, K1f, K2) {ex_counts}; want "
                                     f"{want_counts}")
            for line in lines:
                print(f"  {name}: {line}")
            examples[name] = {"launches": ex_counts, "seconds": seconds, "lines": lines}
        losses = [float(line.split("loss=")[1].split()[0]) for line in
                  examples["simple_train_loop"]["lines"] if line.startswith("epoch")]
        if len(losses) != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"tools simple_train_loop: losses {losses}")
        results["examples"] = examples

        # profile_utils around K1 calls at the request's shape
        gen = torch.Generator(device="cuda").manual_seed(23)
        z = torch.randn(*z_request.shape, generator=gen, device="cuda")
        c = torch.randn(*codebook.shape, generator=gen, device="cuda")
        timed = {mode: profile_utils.timeit(vq_nearest_cuda, z, c, iters=50, fetch=fetch)
                 for mode, fetch in (("amortized", True), ("synchronize", False))}
        trace_dir = os.path.join(tmp, "trace")
        with profile_utils.trace(trace_dir):
            for _ in range(TOOLS_TRACED_CALLS):
                vq_nearest_cuda(z, c)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
        device = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        traced = sum("nearest_tile_kernel" in name for name in device)
        if not traced:
            print(f"tools profile_utils: the trace holds {len(events)} events, {len(device)} "
                  f"kernels: {sorted(set(device))[:8]}")
        if not traced or any(sorted(r) != sorted({"mean_s", "iters", "mode"} | (
                {"p50_s"} if m == "synchronize" else set())) or r["mode"] != m
                for m, r in timed.items()):
            raise AssertionError(f"tools profile_utils: timeit {timed}, kernel traced {traced}")
        results["profile_utils"] = timed
        print(f"tools profile_utils: timeit of K1 at {tuple(z.shape)} x {tuple(c.shape)}: "
              f"{timed}; trace.json names nearest_tile_kernel in {traced} of its "
              f"{len(device)} kernel events ({TOOLS_TRACED_CALLS} K1 calls traced) [{card}]")

        # bench_loader at its defaults
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench_loader.main([])
        bench = json.loads(out.getvalue().strip().splitlines()[-1])
        results["bench_loader"] = {**bench, "seconds": time.perf_counter() - t0}
        print(f"tools bench_loader: {json.dumps(bench)} in "
              f"{results['bench_loader']['seconds']:.1f} s [{card}]")

        # a config generator and the sweep helper; a generated config loads
        argv = sys.argv
        try:
            sys.argv = ["icl_xfmr_gen", "--name", "smoke", "--tokenizer", "vq_vae",
                        "--output_dir", os.path.join(tmp, "gen")]
            with contextlib.redirect_stdout(io.StringIO()):
                icl_xfmr_gen.main()
        finally:
            sys.argv = argv
        (generated,) = glob.glob(os.path.join(tmp, "gen", "configs", "smoke", "*.json"))
        with open(generated) as f:
            raw = json.load(f)
        loaded = config_factory(raw.pop("algo_name"), raw)
        if not (loaded.algo.transformer.vq_vae_enabled and loaded.experiment.name == "smoke"):
            raise AssertionError(f"tools: the generated config {generated} did not load")
        base = os.path.join(tmp, "base.json")
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "exps", "templates",
                               "icl_transformer.json")) as src, open(base, "w") as dst:
            dst.write(src.read())
        with contextlib.redirect_stdout(io.StringIO()):
            sweep = hyperparam_helper.main(["--config", base,
                                            "--script", os.path.join(tmp, "sweep", "run.sh")])
        if len(sweep) != 8:
            raise AssertionError(f"tools hyperparam_helper wrote {len(sweep)} configs")
        results["config_tools"] = {"generated": os.path.basename(generated),
                                   "sweep_configs": len(sweep)}
        print(f"tools config: icl_xfmr_gen wrote {os.path.basename(generated)}, which "
              f"config_factory loads; hyperparam_helper wrote {len(sweep)} configs")
    results["k1"] = kitchen_k1(card, "tools", (
        ("plot_request", tuple(z_request.shape[:1]) + tuple(codebook.shape), z_request,
         codebook),))
    torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from lipvq_tpu_torch import native
    from lipvq_tpu_torch.ops import _build

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"card: {card}")
    for tool in (_build._nvcc(), "g++"):
        out = subprocess.run([tool, "--version"], capture_output=True, text=True, check=True,
                             timeout=60).stdout.strip().splitlines()
        print(f"{tool}: {out[-1] if 'nvcc' in tool else out[0]}")
    t0 = time.perf_counter()
    logs = _build.build(["vq_nearest", "vq_nearest_fast", "vq_stats", "selective_scan",
                         "causal_conv1d", "fused_adamw"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    print(f"BPE library build (g++): {native.build().name} in "
          f"{time.perf_counter() - t0:.1f} s")

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    k1 = timed("kernel", kernel_phase, card)
    k2 = timed("stats", stats_phase, card)
    k1f = timed("fast", fast_phase, card)
    scan = timed("scan", scan_phase, card)
    optimizer = timed("optimizer", optimizer_phase, card)
    served = timed("slice", slice_phase, card)
    trained = timed("train", train_phase, card)
    scripted = timed("script", script_phase, card, served)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        root, actions, export_s = write_corpus_export(tmp)
        corpus = timed("corpus", corpus_phase, card, root, actions, export_s)
        del actions
        tokenizers = timed("tokenizers", tokenizers_phase, card, root)
    arms = timed("arms", arms_phase, card)
    visual = timed("visual", visual_phase, card)
    baselines = timed("baselines", baselines_phase, card)
    offline = timed("rl", rl_phase, card)
    mcr = timed("mcr", mcr_phase, card)
    loop = timed("closed_loop", closed_loop_phase, card)
    imported = timed("import", import_phase, card)
    exported = timed("export", export_phase, card)
    profiled = timed("profile", profile_phase, card)
    ddp = timed("ddp", ddp_phase, card)
    vector = timed("vector", vector_phase, card)
    kitchen = timed("kitchen", kitchen_phase, card)
    kitchen_multi = timed("kitchen_multi", kitchen_multi_phase, card)
    kitchen_suite = timed("kitchen_suite", kitchen_suite_phase, card)
    data_tools = timed("data_tools", data_tools_phase, card)
    tools = timed("tools", tools_phase, card)

    keys = ("shape", "mismatches", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    k1_paths = {"serve": served["launches"], "train": trained["train"]["k1_launches"],
                "train_ema": trained["train_ema"]["k1_launches"],
                "train_script": scripted["k1_train_steps"], "rollout": scripted["k1_rollout"],
                "eval_checkpoint": scripted["k1_eval"],
                "corpus": corpus["launches"]["dry"][0] + corpus["launches"]["write"][0],
                "corpus_fast": corpus["launches"]["fast"][0]}
    k1_paths["train_ema_65536"] = trained["ema_wide"]["launches"][0]
    k1f_paths = {"serve": served["k1f_launches"], "train": trained["train"]["k1f_launches"],
                 "train_ema": trained["train_ema"]["k1f_launches"],
                 "train_script": scripted["k1f_train_steps"], "rollout": scripted["k1f_rollout"],
                 "eval_checkpoint": scripted["k1f_eval"]}
    k1f_paths["corpus"] = corpus["launches"]["dry"][1] + corpus["launches"]["write"][1]
    k1f_paths["corpus_fast"] = corpus["launches"]["fast"][1]
    k1f_paths["train_ema_65536"] = trained["ema_wide"]["launches"][1]
    k2_paths = {"serve": served["k2_launches"], "train": trained["train"]["k2_launches"],
                "train_ema": trained["train_ema"]["k2_launches"],
                "train_ema_65536": trained["ema_wide"]["launches"][2],
                "train_script": scripted["k2_train_steps"], "rollout": scripted["k2_rollout"],
                "eval_checkpoint": scripted["k2_eval"],
                "corpus": sum(corpus["launches"][run][2] for run in ("dry", "write", "fast"))}
    for label, r in arms.items():
        for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
            paths[f"arm {label}"] = r["serve_launches"][i] + r["train_launches"][i]
    for r in tokenizers["sweep"]:
        for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
            paths[f"sweep {r['num_codes']} {r['codebook_update']}"] = r["launches"][i]
    for codes, r in tokenizers["vqvae"].items():
        for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
            paths[f"vqvae {codes}"] = r["launches"][i]
    for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
        paths["visual serve"] = visual["serve"]["launches"][i]
    k1_paths["visual train"] = visual["train"]["k1_launches"]
    k2_paths["visual train"] = visual["train"]["k2_launches"]
    k1_paths["visual train_ema"] = visual["train_ema"]["k1_launches"]
    k2_paths["visual train_ema"] = visual["train_ema"]["k2_launches"]
    k1_paths["visual train_script"] = visual["script"]["k1_train_steps"] + visual["script"][
        "k1_mse"]
    k2_paths["visual train_script"] = visual["script"]["k2"]
    k1f_paths["visual train"] = visual["train"]["k1f_launches"]
    k1f_paths["visual train_ema"] = visual["train_ema"]["k1f_launches"]
    k1f_paths["visual train_script"] = visual["script"]["k1f"]
    for label, _, _ in BASELINES:
        for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
            paths[f"baseline {label}"] = baselines[label]["launches"][i]
    for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
        paths["baseline diffusion_policy ddim"] = baselines["diffusion_policy"]["ddim"][
            "launches"][i]
        paths["baseline diffusion_policy train_script"] = baselines["script"]["launches"][i]
        for name in RL_ALGOS:
            paths[f"rl {name}"] = offline[name]["launches"][i]
        paths["rl td3_bc train_script"] = offline["script"]["launches"][i]
        for part in ("workspace", "pretrainer", "policy"):
            paths[f"mcr {part}"] = mcr[part]["launches"][i]
        paths["closed_loop"] = loop["launches"][i]
    dc = scripted["device_cache"]
    k1_paths["train_script_device_cache"] = dc["k1_train_steps"]
    k1_paths["rollout_device_cache"] = dc["k1_rollout"]
    k1f_paths["device_cache_script"] = dc["k1f"]
    k2_paths["device_cache_script"] = dc["k2"]
    scan_paths = {f"scan {label}": r["launches"] for label, r in scan.items()
                  if label != "mixer"}
    # the optimizer's kernels, as the library reported their launches
    opt_paths = {"optimizer jamba": optimizer["counts"]["launches"] + optimizer["launches"],
                 "optimizer adam_l2": optimizer["adam_l2"]["counts"]["launches"],
                 **{label: trained[label]["optimizer"]["launches"]
                    for label in ("train", "train_ema")},
                 **{f"baseline {label}": baselines[label]["optimizer"]["launches"]
                    for label, _, _ in BASELINES}}
    conv_paths = {"mixer case": scan["mixer"]["launches"]}
    fused_paths = {}
    for label, r in arms.items():
        if "scan_launches" in r:
            scan_paths[f"arm {label}"] = sum(r["scan_launches"])
            for part, (conv, fused, _) in r["mixer_counts"].items():
                conv_paths[f"arm {label} {part}"] = conv
                fused_paths[f"arm {label} {part}"] = fused
    for paths, i in ((k1_paths, 0), (k1f_paths, 1), (k2_paths, 2)):
        paths["import"] = imported["launches"][i]
        for label in ("lowdim", "lowdim_ema", "image"):
            paths[f"profile {label}"] = profiled[f"{label} launches"][i]
        for label in ("none", "nccl1"):
            paths[f"ddp train_script {label}"] = ddp[label]["launches"][i]
        paths["vector subproc + local"] = vector["launches"][i]
        paths["kitchen train_script"] = kitchen["launches"][i]
        paths["kitchen requests"] = kitchen["request_launches"][i]
        paths["kitchen learning_floor"] = kitchen["floor"]["launches"][i]
        paths["kitchen_multi train_script"] = kitchen_multi["launches"][i]
        paths["kitchen_multi requests"] = kitchen_multi["request_launches"][i]
        paths["kitchen_suite train"] = kitchen_suite["launches"][i]
        paths["kitchen_suite resume"] = kitchen_suite["resume_launches"][i]
        for t, r in kitchen_suite["tasks"].items():
            paths[f"kitchen_suite requests {t}"] = r["request_launches"][i]
        paths["data_tools filter_key train_script"] = data_tools["filter_key"]["launches"][i]
        paths["data_tools d4rl train_script"] = data_tools["d4rl"]["launches"][i]
        paths["tools checkpoint train_script"] = tools["checkpoint_launches"][i]
        paths["tools plot_predictions"] = tools["launches"][i]
        for name, r in tools["examples"].items():
            paths[f"tools {name}"] = r["launches"][i]
    for batch in EXPORT_BATCHES:  # counted in the reloading process
        k1_paths[f"export reloaded batch {batch}"] = exported[batch]["k1_launches"]
    print(json.dumps({"kernels": [{
        "name": "vq_nearest (K1)",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_nearest.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:68",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "fixtures_exact": True,
        **{k: k1["slice"][k] for k in keys},
        "wrapper_host_ms": k1["slice"]["wrapper_host_ms"],
        "train_shape": k1["train"],
        "corpus": k1["corpus"],
        "visual_serve_shape": k1["visual_serve"],
        "visual_single_shape": k1["visual_single"],
        "visual_train_shape": k1["visual_train"],
        "closed_loop_train_shape": loop["k1"]["train"],
        "closed_loop_request_shape": loop["k1"]["request"],
        "profile_lowdim_1600_shape": k1["profile_1600"],
        "profile_image_16_shape": k1["profile_image"],
        "kitchen_train_shape": kitchen["k1"]["train"],
        "kitchen_request_shape": kitchen["k1"]["request"],
        "kitchen_floor_train_shape": kitchen["k1"]["floor_train"],
        "kitchen_multi_train_shape": kitchen_multi["k1"]["train"],
        "kitchen_multi_request_shape": kitchen_multi["k1"]["request"],
        "kitchen_suite_train_shape": kitchen_suite["k1"]["train"],
        "kitchen_suite_request_shape": kitchen_suite["k1"]["request"],
        "data_tools_train_shape": data_tools["k1"]["train"],
        "data_tools_valid_shape": data_tools["k1"]["valid"],
        "data_tools_d4rl_train_shape": data_tools["k1"]["d4rl_train"],
        "tools_plot_request_shape": tools["k1"]["plot_request"],
        "op_wrapper_host_ms": k1["slice"]["op_wrapper_host_ms"],
        "card": card,
    }, {
        "name": "vq_nearest_fast (K1f)",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_nearest_fast.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:68",
        "launches": sum(k1f_paths.values()),
        "launches_by_path": k1f_paths,
        "fixtures_exact": True,
        **{k: k1f["corpus"][k] for k in keys},
        "flip_rate_vs_k1": k1f["corpus"]["flip_rate_vs_k1"],
        "slice_shape": k1f["slice"],
        "train_shape": k1f["train"],
        "card": card,
    }, {
        "name": "vq_nearest_with_stats (K2)",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_stats.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:95",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "fixtures_exact": True,
        **{k: k2["train"][k] for k in keys},
        "stage_ms": k2["train"]["stage_ms"],
        "corpus": k2["corpus"],
        "skewed": k2["skewed"],
        "beyond_one_histogram": k2["wide"],
        "visual_train_shape": k2["visual_train"],
        "card": card,
    }, {
        "name": "selective_scan",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/selective_scan.cu",
        "replaces": "lipvq_tpu/models/mamba.py:34",
        "form": "gated: softplus of dt in, y * silu(z) out (the Mamba block's on the card)",
        "launches": sum(scan_paths.values()),
        "launches_by_path": scan_paths,
        **{k: scan["jamba"][k] for k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                          "worst_in_tolerance")},
        "shapes": {label: r for label, r in scan.items() if label != "mixer"},
        "card": card,
    }, {
        "name": "causal_conv1d and the gated selective scan",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/causal_conv1d.cu, selective_scan.cu",
        "replaces": "lipvq_tpu_torch/models/mamba.py's composed chain (MambaBlock._composed)",
        **scan["mixer"],
        "launches": sum(conv_paths.values()),
        "launches_by_path": conv_paths,
        "ssm_mixer_fused_by_path": fused_paths,
        "card": card,
    }, {
        "name": "fused_adamw",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/fused_adamw.cu",
        "replaces": "torch.optim.AdamW's foreach step and clip_by_global_norm_",
        "launches": sum(opt_paths.values()),
        "launches_by_path": opt_paths,
        "profiled_step_launches": optimizer["launches"],
        **{k: optimizer[k] for k in ("elems", "tensors", "bytes", "ms", "profiled_ms",
                                     "hbm_share", "bound_ms", "extra_bytes", "worst")},
        "adam_l2_worst": optimizer["adam_l2"]["worst"],
        "card": card,
    }], "optimizer": optimizer, "serve": served, "train": trained, "script": scripted,
        "corpus": corpus, "arms": arms, "tokenizers": tokenizers, "visual": visual,
        "baselines": baselines,
        "rl": offline, "mcr": mcr, "closed_loop": loop, "import": imported,
        "export": exported, "profile": profiled, "ddp": ddp, "vector": vector,
        "kitchen": kitchen, "kitchen_multi": kitchen_multi, "kitchen_suite": kitchen_suite,
        "data_tools": data_tools, "tools": tools, "phase_s": phase_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
