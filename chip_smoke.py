#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``confild_tpu_torch``) on one H100.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` compiles every ``confild_tpu_torch/csrc/*.cu``, one
   process per source, all started together (timed; ptxas registers and
   spills, and for the flash and SIREN tensor-core kernels the count of
   ``HMMA`` and ``HGMMA`` instructions in ``cuobjdump -sass``: every flash
   backward instantiation must have some, every instantiation of the SIREN
   cluster kernels (the float32 and bf16 forwards, the chain in its
   training mode and in its dz mode), of the training backward's reduction
   and of the flash forward some ``HGMMA``, the reduction, the bf16 SIREN
   forward and the flash forward no ``HMMA``, each of the reduction's tile
   widths an instantiation, and the flash forward all six (D = 32, 64,
   128 in float32 and bf16), each with its plan (keys a tile, raw and image
   stages, dynamic shared memory) held to the wrapper's mirror; the three
   column-group flash kernels for heads above 128 one instantiation a type
   each, ``HGMMA`` only, their plans at D = 256, 384, 512 and 1024 held to
   the mirror; the float32 forward with Q resident (D up to 512, groups of
   128 and 256) and the bf16 forward and backward pair (dq, dk/dv) on TMA
   tensor copies at D = 256, 384 and 512, ``HGMMA`` only, no spill, their
   plans held to the mirror; the float32 backward pair with the resident
   rows at the same widths likewise, starting at 168 registers, with no
   note of ptxas's that it serialised their wgmma, C7515 or C7514);
3. forward decode kernel against its plain version and a float64 run under
   the JAX tests' criterion ``err_kernel <= 2 * err_plain_f32 + 1e-6`` (each
   error printed as a share of its limit), two launches bitwise equal: at
   Case4 widths (SIREN-FiLM 3 -> 384 x 16 modulated layers -> 3, w0 30),
   16 rows x 262144 points (a decoder chunk) and 4 x 262144 (a CNF training
   batch), at Case2 widths (2 -> 256 x 11 -> 4) at 3 x 3000 (a cluster of
   one block, a ragged last cluster), and at a hidden width of 96 (3 ->
   96 x 4 -> 3, zero-padded to 128 by the wrapper) at 4 x 3000; at 16 and
   4 rows the kernel's time
   (median of 7 separately timed calls with the least and largest, the SM
   clocks before and after), the weight preparation's and the forward's
   device time from ``torch.profiler`` with the rate of products, the L2
   bytes of the split weight stream, the plain version's time and the roofline bound
   (the SIREN rows' bound: matrix products at the tensor cores' 3xTF32
   rate, sines at the CUDA-core float32 rate, bytes at the HBM rate, the
   largest; the CUDA-core figure of all the flops is logged beside it);
4. dz kernel (the cluster chain's dz mode and its fold) against its plain version
   and a float64 autograd run (same criterion on ``dL/dlatents``, each
   error printed as a share of its limit),
   two launches bitwise equal: at Case4 widths 384 rows x 10 sensors, 384 x
   1024 and a ragged 100 x 3000 (rows cut across clusters and chunks), at
   Case2 widths 3 x 3000 and at the hidden width 96 at 4 x 3000; at 384 x
   1024 also against the training
   backward's dz under the same criterion; at 384 x 1024 and 384 x 10 the
   kernel's time (median of 7 separately timed calls with the least and
   largest, the SM clocks before and after), the chain's, the fold's and
   the weight preparation's device time from ``torch.profiler`` with the rate of
   products, the peak workspace, the plain version's time and the bound;
   then the time and peak memory above inputs of the whole operator
   gradient (plain autograd decode vs forward + dz kernels) over a sweep of
   sensor counts up to 2048, which places the crossover of the operator's
   ``rows x points > 65536`` rule;
5. main path: ``confild_tpu_torch.cli.sample_conditional.main`` at full Case4
   widths (U-Net 384^2, 128 ch, mult 1,1,2,2,4,4, 2 res blocks, 64-channel
   heads; CNF 16 x 384) on synthetic assets written from a seed in the
   reference ``.pt`` layout, 1000 steps respaced to 10, one sample, a
   4096-point mesh.  It runs twice: with Case4's 10 sensors (the operator
   takes the plain decode, the full-field decode takes the forward kernel)
   and with 1024 sensors (393216 pairs > 65536: the guidance gradient takes
   the forward and dz kernels).  Launch counts are zeroed before and read
   after each run; every kernel must have launched;
6. fused path inside DPS: one guided step's gradient with respect to
   ``x_prev`` through the full-width U-Net with the operator forced onto the
   kernels and forced onto the plain decode, at 10 and at 1024 sensors;
   they must agree to a relative L2 error of 1e-3; each step's time, and
   at 1024 sensors each route's device time from ``torch.profiler``;
7. the training backward's dW_mid reduction alone on seeded workspaces
   (Case4's chunk, ragged steps and tiles, H = 3072) against ``torch.bmm``
   in float32 and float64 under the same criterion, two launches bitwise
   equal; then the training-backward kernel against its plain version at
   Case4 widths,
   4 rows x 262144 points (a training batch: each row spans 4 chunks of
   the kernel) and 4 rows x 16384 points (one chunk holds every row):
   every cotangent (dz, dW_first, dW_mid, dW_head, and after the
   autograd chain dlatents, dW2, db1) held to a chunked float64 autograd
   run of the reference decode under the same criterion with a
   ``1e-6 * max|f64|`` floor (also at the hidden width 96, 4 x 3000); two
   launches bitwise equal; at 4 x 262144
   the kernel's time (median of 7 separately timed calls with the least
   and largest, the SM clocks before and after), each of its kernels'
   device time from ``torch.profiler`` (the chain and the reduction with
   their rate of products; the reduction's own bound, plain time and the
   float32 ``torch.bmm`` of its products as the library figure), the plain
   version's time, and the bound;
8. the general op's gradient on the card (latents, decoder and coordinates
   all requiring grad) against plain autograd at 4 x 4096, and one training
   batch's gradients with ``use_fused_decode`` true and false at 4 x 16384:
   relative L2 of 1e-3 per leaf;
9. main path, training: ``confild_tpu_torch.cli.train_cnf.main`` at full
   Case4 width (``recipes/cnf/case4.yml``: 16 x 384 SIREN-FiLM, batch 4)
   on 8 seeded snapshots x 262144 points: 3 epochs (6 batch steps, 2
   decoder steps, 2 evals, 2 checkpoints), then a resume for 1 epoch that
   must continue the epoch count; launch counts zeroed before and read
   after each run; the newest checkpoint must load through
   ``CNF_inference``.

10. flash-attention kernels (forward, dq, dk/dv) against their plain
    versions and a float64 run at the path's shape (64, 144, 64), a ragged
    (2, 200, 32), the xl recipe's (16, 9216, 64), the auto threshold's
    (4, 16384, 64), bf16 (2, 256, 64) and (64, 144, 64) (P and dS rounded
    to bf16 as in JAX), 16-channel heads (8, 144, 16) in f32 and bf16
    (zero-padded to 32 by the wrapper), and above 128 (the column-group
    kernels; the forward up to 512 the float32 kernel with Q resident and
    the bf16 one on TMA tensor copies, the backward pair up to 512 the
    bf16 one on TMA tensor copies and the float32 one with the resident
    rows)
    D = 160 (padded to 256), 256, 384 and 512 at a ragged (2, 300, D),
    1024 at (2, 200, 1024) and the one-head Case4 middle block (8, 144,
    512), each in f32 and bf16, under the same criterion (each
    error's share of its limit is printed); two launches bitwise equal;
    forward + backward at (4, 16384, 64) within 64 MB above inputs and
    outputs (O(N) memory); times of the kernels, the plain versions and
    ``scaled_dot_product_attention`` (a yardstick only: its forward, its
    backward alone on a retained graph, on the (BH, N, D) tensors and on
    their (1, BH, N, D) view, which takes another backend, and the CUDA
    kernels each launches) at (64, 144, 64), (16, 9216, 64) and
    (4, 16384, 64), each the median of 7 separately timed repeats with
    their least and largest (at 144 tokens, where the host's launch rate
    bounds those, also the forwards' device time from ``torch.profiler``),
    the SM clock and its maximum logged before and after, beside two
    bounds (the tensor cores' 3xTF32 rate, and CUDA-core float32); then
    the forward alone (on ``wgmma``) beside its plain version and
    SDPA on the same tensors, both layouts, and its bound (products at the
    3xTF32 or the dense bf16 rate, exponentials, bytes): bf16 at the same
    three shapes, float32 at phase 18 (d)'s classifier shapes (16, 1024,
    64), (32, 256, 64) and (32, 64, 64); the wrapper's host time a
    call at (64, 144, 64) (``time.perf_counter`` over 200 unsynchronised
    calls) with its parts, beside SDPA's; and above 128 the forward and
    backward pair at (8, 144, 512) and (8, 9216, 256) in f32 and bf16 as
    the forward and the pair above (``[flash-fwd]``,
    ``[flash-bwd]``), and the forward alone at (4, 9216, 512), with their
    recompute factors (``[flash-wide]``);
11. the full-width Case4 U-Net (384^2, 128 ch, mult 1,1,2,2,4,4, heads of
    64), batch 8: one ``training_losses`` forward and backward with
    ``use_flash_attention`` true and false on the same weights and draws;
    loss and every parameter gradient agree to a relative L2 of 1e-3;
12. main path, diffusion training: ``confild_tpu_torch.cli.train_diffusion
    .main`` on ``recipes/diffusion/case4.yml``, which leaves
    ``use_flash_attention`` on auto (null: dense at Case4's 144 tokens),
    forced to ``true``, on 32 + 8 seeded synthetic 384 x 384
    latent images: 3 steps (``save_interval`` 2, ``log_interval`` 1), then a
    resume from ``model000003.pt`` to step 4 that must read back the step
    count and the EMA; ms per step, peak memory, a device profile of one
    step;
12b. the slice's path above 128: the same CLI and recipe with the JAX
    ``create_model`` head defaults (``num_heads`` 1, ``num_head_channels``
    -1: one head of all a block's channels; Case4's one attention block,
    the middle block's, becomes one head of 512 channels at 144 tokens) and
    flash on, batch 8, 3 steps and a resume to step 4: every flash kernel
    above 128 launched at D = 512 (counts zeroed before and read after each
    run), no narrow one, finite losses, ms per step; then the same in bf16
    (``use_bf16``, 3 steps): the TMA forward and the bf16 backward pair at
    D = 512 launched;
13. train -> sample: ``cli.sample_conditional.main`` once more with the EMA
    just written and flash attention on (the DPS gradient runs the flash
    forward and backward).
14. unguided generation and evaluation, in the same temporary root:
    (a) ``cli.sample.main`` on ``recipes/diffusion/case4.yml`` with phase
    12's EMA and data range, flash forced on, the published batch of 8,
    1000 steps respaced to 10, decoding through a Case4-width CNF
    (``recipes/cnf/case4.yml``) trained for 1 epoch by ``cli.train_cnf`` on 4
    seeded snapshots of a 4096-point mesh: fields ``(8, 384, 4096, 3)``,
    finite; two saved rows held to a float64 decode of the same denormalized
    latents under the forward check's criterion (against the folded plain
    decode); then ms per sampling step (synchronized wall, median of the
    steps after the first, a loop of its own on the same weights), a device
    profile of one step, peak memory, the decode's seconds and the derived
    seconds per 1000-step batch of 8; the decode of every generated row
    timed on the card by ``CNFTrainer.infer`` (the plain decode the CLI
    takes) and by the forward kernel; ``ddim_sample_loop`` at ``eta`` 0 run
    twice from the same noise must be finite and bitwise equal;
    (b) ``cli.eval_cnf.main`` on phase 9's newest checkpoint and its 8 x
    262144-point snapshots (the SIREN forward kernel), its per-channel MSE
    and rMAE held to the same evaluation through the plain decode on the
    card within a relative 1e-4, and the spot-check mode once;
    (c) ``cli.integral_timescale.main`` on a ``.npy`` of channel 0 of
    generated sample 0, ``(time, points)``, without ``--plot`` (the card's
    machine has neither ``h5py`` nor ``matplotlib``): tau finite and equal to
    ``analysis.metrics.integral_timescale`` called directly.
    Launch counts are zeroed before and read after each CLI run; the flash
    forward must launch in (a) and the SIREN forward in (b).
15. bf16 and rematerialization, at full width:
    (a) the bf16 SIREN forward kernel (``compute_dtype`` bfloat16: the
    cluster kernel's bf16 mode, ``siren_fwd_cluster_bf16_kernel``) against
    its plain version (relative L2 1e-2) at 16 x 262144 and 384 x 10 on
    Case4's decoder, two launches bitwise equal, its float64 error beside
    the float32 kernel's, its plan, registers, spills and shared memory,
    and the instantiation a profiled call ran held to the plan's (every
    bf16 check does all this); its time (median of 7) at 16 x 262144 and 4
    x 262144 beside the float32 kernel's in the same run and the plain bf16
    version's, with its bound at the dense bf16 tensor-core rate and the
    L2 bytes of its weight stream; one
    ``fused_siren_decode_frozen(..., compute_dtype=bf16)`` forward and its
    dz backward at 384 x 1024 (counts zeroed before, read after: the bf16
    forward and dz kernels must launch), its gradient equal to the float32
    op's;
    (b) ``cli.train_diffusion`` on ``recipes/diffusion/case4.yml`` with
    ``use_bf16`` true and flash forced on (3 steps; the flash forward, dq
    and dk/dv kernels must launch on bf16), ms per step and peak memory
    beside phase 12's float32 figures; ``cli.sample`` from its EMA (batch 8,
    ``cast_torso_params``, flash on, 10 respaced steps, the CNF of phase
    14), ms per unguided step beside phase 14's and peak memory; the bf16
    vs float32 relative error of one forward with the same weights;
    (c) one training step of the Case4 U-Net with ``use_checkpoint``
    ("full") and without, from the same state: gradients equal to a
    relative 1e-5, each step's time and peak memory; then
    ``recipes/diffusion/case4_xl_768.yml``'s model (768^2, batch 4, f32,
    flash on auto: dense at 9216 tokens) through ``cli.train_diffusion``
    for 3 steps with ``remat_policy`` "full" and "matmuls": ms per step and
    peak memory of each.
16. the slice of the 2-D turbulence demo:
    (a) the float32 SIREN kernels (the cluster forward and the cluster
    chain in its dz and training modes) at the narrow widths a recipe may
    ask for (``NARROW_CHECKS``): H = 64 (padded to 128), 128, 256, 320
    (padded to 384), 384, 448 (padded to 512) and 512 (3 -> 3 or 2 -> 2,
    six modulated layers), and one modulated layer at 128: the forward at
    4 x 16384 and a ragged 3 x 3001, dz at 64 x 1024 (also against the
    training backward's) and a ragged 100 x 3000 (rows cut across
    clusters and chunks), the training backward at 4 x 16384, under the
    criteria of phases 3, 4 and 7 with bitwise repeats, and the bf16
    forward at 4 x 16384 under phase 15's at each of these widths and
    alone at 192 (one block of 192 columns, also a ragged 3 x 3001); each
    width's plan,
    registers, spills and clusters the card holds at once; the launches of
    each width's checks (zeroed before, read after), and the kernel
    instantiations a profiled forward, dz and training backward ran, which
    must be the width's plan's; the float32 forward and the training
    backward timed at 4 x 262144 at 448 and 512 and at the demo
    ``--fast``'s 64 x 1024 at 128 (median of 7, with their bounds and
    plain versions);
    (b) the Case4 U-Net (float32, batch 8, flash on) trained by
    ``TrainLoop`` with ``steps_per_call`` 4 over 32 seeded images resident
    on the card (``device_data``): ms per step of a call, against
    ``run_step`` on the same loop and phase 12's figure, peak memory,
    finite losses, the EMA moved;
    (c) ``confild_tpu_torch.examples.demo_turbulence`` end to end, ``--fast``
    (32^2 grid, H = 128) and at the f4 widths cut to 2 trajectories, 2 CNF
    epochs, 25 diffusion steps and 100 sampling steps (the script's 500
    took 99 s of the run), each run after the SIREN forward and
    training-backward kernels are held against their plain versions and
    float64 at its CNF's widths and batch (2 -> 128 x 5 -> 2 over 64 x
    1024; 2 -> 384 x 7 -> 2 over 128 x 4096; criteria of phases 3 and 7):
    each stage's wall, the CNF batch step,
    the diffusion step, peak memory, the metrics; every gate finite; the
    SIREN forward and training-backward launches of the CNF stage counted
    (zeroed before each run, read after);
    (d) the demo's held-out DPS experiment and quality report against (c)'s
    f4-width run directory: ``examples.demo_conditional.main`` cut to 2
    held-out trajectories, 2 members, 20 steps, scale 1.0 and the sensor
    sweep at 16 and 1000, without the prior check, whose oracle fit (200
    steps, not the script's 4000) and one round trip then run alone on a
    held-out trajectory; ``examples.demo_report.main`` with 4 members of 10
    steps; at the sweep's 1000-sensor batch (4 members x 64 rows x 1000
    points, over ``FUSED_MIN_PAIRS``) the DPS gradient on the fused route
    (SIREN forward + dz kernels) and the plain route: d misfit / d x0_hat
    against float64 under phase 4's criterion, and one guided step's
    gradient through the bf16 U-Net within phase 6's 1e-3; the sweep's two
    budgets alone with the counts zeroed before each (the forward and dz
    kernels launch at 1000 sensors, nothing at 16); each stage's wall, ms
    per guided step at 16 and 1000 sensors, the oracle fit's ms a step and
    peak memory, each JSON's pooled numbers, all finite, with the JAX
    scripts' keys; the launches of both ``main`` runs counted.
17. multi-device (``confild_tpu_torch/parallel/mesh.py``, ring
    attention, the sharded entry points), held against one process on the
    same global batches and seeds, which runs first: ``cli.train_cnf`` on
    phase 9's case cut to 2 epochs with ``multiGPU: 2`` (one process:
    no mesh), a ``TrainLoop`` step of the Case4 U-Net (flash forced,
    phase 5's seeded weights, global batch 8, phase 11's draws), and
    ``cli.sample_conditional`` with a 2-member ensemble at 10 and 1024
    sensors, 1000 steps respaced to 5 (one process also with every U-Net
    weight one float32 ulp up, to measure how far the guided trajectory
    carries a rounding difference):
    (b) two ranks spawned on this card over gloo (NCCL refuses two ranks
    on one device; each rank passes ``cuda:0`` and joins within
    ``RANK_JOIN_S``): the CNF gradients before each optimizer's first step
    and the epochs' losses, the U-Net's gradients and loss within a
    relative L2 of 1e-5, the SIREN forward and backward kernels and the
    flash kernels launched on each rank, the ensembles' fields within 1e-4
    or 10x the one-ulp move, the larger, each side's operator route
    printed; ms per CNF batch step and per diffusion step a rank beside
    one process's, and the all-reduce of a step's gradients timed alone
    (recorded only);
    (c) where two cards are visible, the same over NCCL, a card a rank,
    and the xl recipe's 9216-token attention block through the ring
    against its dense route (relative L2 1e-5); on one card a line says
    it did not run;
    (a) last, in this process: a 1-rank NCCL group on a file store
    (destroyed in ``finally``): ``CNFTrainer`` (phase 9's case, 1 epoch)
    and the ``TrainLoop`` step with ``get_mesh(1)`` bitwise equal to
    ``mesh=None`` (cuDNN's deterministic algorithms on for both), and
    ``ring_attention`` over the one rank at (16, 9216, 64) against phase
    10's float64 attention under phase 10's criterion.  The ranks' and
    (a)'s mesh runs' launches are added to the kernels' counts.
18. the rest of the model zoo (fatal on failure, as every phase):
    (a) every auto-decoder of the decoder zoo (``SIREN_rez_Autodecoder_film``,
    ``SIRENAutodecoder_tw_film``, ``FNAutodecoder_film``,
    ``GNAutodecoder_film``, ``SIRENAutodecoder_fp``,
    ``SIRENAutodecoder_mdf_film``) through ``cli.train_cnf`` on phase 9's
    recipe (Case4 widths; the two hypernetwork decoders, fp and mdf, cut to
    3 hidden layers, ``ZOO_DEPTH``) over 8 seeded snapshots of 65536 points
    (a quarter of Case4's, for plain autograd's activations), lr 1e-5 / 1e-3
    (``ZOO_LR``): 2 epochs and a 1-epoch resume, losses finite and falling, tw_film's ``w0`` moved, no
    kernel launched (the plain route), ms per batch step and peak memory;
    ``cli.eval_cnf`` on the residual decoder's checkpoint, its decode held
    to the trainer's within 1e-4; the same recipe with
    ``SIRENAutodecoder_film`` launching the SIREN forward and training
    kernels (counts zeroed before each run, read after);
    (b) every registry decoder (the trained ones, the others seeded at
    Case4 widths) forward and input gradient at 2 x 4096 in float32
    against the same module in float64 on the card (relative L2 1e-4);
    (c) ``cli.train_classifier`` on upstream guided-diffusion's published
    256^2 classifier (width 128, depth 2, attention at 32,16,8, attention
    pool, scale-shift norm, resblock up/down; lr 3e-4, weight decay 0.05),
    2 classes, 64 seeded latent images, batch 32, 10 steps, the checkpoint
    read back, ms per step, peak memory;
    (d) that classifier with ``use_flash_attention``: logits and
    ``classifier_cond_fn``'s gradient against the dense build (phase 11's
    1e-3), the flash forward, dq and dk/dv launched (1024, 256 and 64
    tokens, 64-channel heads);
    (e) classifier-guided DDPM (1000 steps respaced to 10, batch 4) of a
    class-conditional U-Net at Case4's widths at 256^2 (2 classes, labels
    fed to it and to ``cond_fn``): finite samples, ms per guided step, one
    step's guided mean against float64 (1e-3);
    (f) ``create_sr_model(256, 64, 128, 2)``: one forward and backward at
    batch 4 against float64 (1e-3 on the output, the input's and every
    parameter's gradient), then the same weights with
    ``use_flash_attention`` (its one head a block: 512 channels at 256 and
    64 tokens, the kernels above 128) against the dense route (1e-3 on
    the same).
    Phase 18's flash launches are added to the kernels' counts, and so are
    the SIREN launches of its FiLM run; the launches above 128 of 12b
    and (f) are the kernels line's ``@D256`` / ``@D512`` rows' (and the
    ``@D512N9216`` rows', the same instantiations), 12b's bf16 launches
    the ``flash_forward_bf16@D512``, ``flash_bwd_dq_bf16@D512`` and
    ``flash_bwd_dkv_bf16@D512`` rows'.
19. the SIREN kernels at every width a FiLM recipe may ask for (hidden
    widths up to 1024, the float32 and bf16 forwards up to 3072, 16
    coordinates and outputs), on
    ``recipes/cnf/case4.yml`` with ``hidden_features`` 1024 and
    ``out_features`` 5 (``WIDE_CNF``: 3 -> 1024 x 16 modulated layers -> 5,
    which the kernels refused before):
    (a) every SIREN kernel (float32 and bf16 forward, dz, training
    backward) against its plain version and float64 under the criteria of
    phases 3, 15, 4 and 7, with bitwise repeats, at H = 576 and 896 with 3
    -> 5 (six modulated layers), at H = 1024 with 16 -> 16 and
    at 384 with 3 -> 16 (six layers), and at ``WIDE_CNF`` (also a ragged 3
    x 3001 forward): the forwards at 4 x 16384, dz at a ragged 64 x 1000
    (also against the training backward's), the training backward at 4 x
    16384, and at ``WIDE_CNF`` also at the shapes (b) and (c) give them,
    several chunks of 65536 pairs: dz at 384 x 1000 (also against the
    training backward's) and the training backward at 4 x 65536; each
    width's registers, spills and shared memory;
    (e) at ``WIDE_CNF`` the float32 forward, the training backward and the
    bf16 forward at 4 x 262144 (the bf16 beside the float32 kernel in the
    same call) and dz at 384 x 1000 timed (medians of 3,
    beside their bounds and plain versions; the plain training backward
    over chunks of the points), and the forward and training backward of
    the two C = 16 decoders at 4 x 65536;
    (b) ``cli.train_cnf`` on the recipe over 4 seeded 5-field snapshots of
    65536 points, 2 epochs and a 1-epoch resume at phase 18's latent
    learning rate and a tenth of its decoder rate (``WIDE_LR``): losses
    finite and falling, ms per batch step, peak memory, the forward and
    training-backward kernels launched;
    (c) ``cli.sample_conditional`` with phase 5's Case4 U-Net and the
    decoder (b) trained, 1000 steps respaced to 10, at 1000 sensors (384 x
    1000 pairs: the operator on the forward and dz kernels), and (d) the
    CLI's full-field decode of the 384 rows at phase 5's 4096 points
    through ``inference.decoder`` (the forward kernel): fields finite and
    of 5 channels.  (b)'s and (c)'s launches (zeroed before each run, read
    after) are the H = 1024 rows' counts; (e) also times the forward at
    the shapes they launch it at (4 x 65536, 384 x 1000, 16 x 4096) and
    the training backward at 4 x 65536;
    (f) the float32 and bf16 forwards and the chain of dz and the training
    backward are thread-block cluster kernels at every width
    (``csrc/siren_fwd_cluster.cu``, ``csrc/siren_chain_cluster.cu``:
    wgmma, bulk asynchronous copies, distributed shared memory), so (a)'s
    checks hold them, and they are also checked alone: their plan at every
    width 64..3072 equal to the built library's (with both forwards'
    rings and shared memory), their weight preparations (the bf16
    forward's too) bitwise against the plain layouts at 576, 1024, 2048
    and 3072, the float32 and bf16 forwards, dz and the training backward
    against their plain versions and float64 at 2048 and 3072 (3 -> 5, six
    modulated layers; ragged 3 x 3001 forwards at 2048; bitwise repeats),
    the bf16 forward also at 1152 (six blocks of 192), dz and the training
    backward also on decoders of one and two modulated layers at 640 and
    3072, and timed (medians of 3, SM clocks, the stream
    bytes) at 2048 with ``WIDE_CNF``'s depth at 4 x 262144 (the float32
    and bf16 forwards) and at 3072 at six layers (the bf16 forward too, at
    4 x 65536); the SASS scan counts their wgmma (HGMMA) instructions;
    (g) a decoder of ``WIDE_CNF``'s depth at H = 2048 through
    ``inference.CNF_inference`` (16 rows x 4096 points, against its plain
    route): its launches are the H = 2048 row's.
20. the SIREN kernels at more than 16 coordinates or outputs (their tables
    take 16 features, wider ones in chunks): (a) every SIREN kernel against
    its plain version and float64 as in 19 (a), at Case4's decoder (384 x
    16 modulated layers) at 20 -> 24 and at six layers of 1024 at 40 ->
    64, timed at the first (the kernels line's ``@H384C20x24`` rows); (b)
    ``cli.train_cnf`` on ``recipes/cnf/case4.yml`` at 20 -> 24 over 4
    seeded 24-field snapshots of 65536 points, 2 epochs and a 1-epoch
    resume: losses finite and falling, the forward and training-backward
    kernels launched; (c) its checkpoint through ``inference.CNF_inference``
    at its mesh against the plain route (relative 1e-4), and its bf16
    ``compute_dtype`` forward against its plain version (1e-2); (d) a guided
    step's gradient through ``CNFDecodeOperator`` at 1000 sensors (384 x
    1000 pairs: the forward and dz kernels) against the plain route's (1e-3).
    (b)-(d)'s launches (zeroed before each run, read after) are the rows'.

The script imports nothing of JAX or of ``confild_tpu``.  With no CUDA
device it exits non-zero and prints no result.  The last line is
``{"ok": true, "device": {...}}``; the line before it lists every kernel
(the rows at H = 448 and 512, at C = 16, at H = 3072 and the bf16 rows
above 384 with 0 launches: no main path runs them; the rows at H = 128
with the demo ``--fast``'s launches, phase 16c; the float32 rows at H =
1024 and 2048 with phase 19's); the
card's name and power limit, the build's seconds and the script's total
come before it.
"""

from __future__ import annotations

import copy
import csv
import ctypes
import dataclasses
import datetime
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import yaml

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.analysis import metrics
from confild_tpu_torch.cli import (eval_cnf, integral_timescale, sample, sample_conditional,
                                   train_cnf, train_diffusion)
from confild_tpu_torch.core.normalize import Normalizer
from confild_tpu_torch.core.packing import minmax_to_unit_interval, unit_interval_to_minmax
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.device import resolve_device, synchronize
from confild_tpu_torch.examples import demo_conditional, demo_report, demo_turbulence
from confild_tpu_torch.guidance import (create_sampler, get_conditioning_method,
                                        get_noise, get_operator)
from confild_tpu_torch.guidance.operators import FUSED_MIN_PAIRS, CNFDecodeOperator
from confild_tpu_torch.inference import CNF_inference
from confild_tpu_torch.io.checkpoint import latest_checkpoint
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models.cnf import SirenFilm, siren_film_apply
from confild_tpu_torch.ops.ring_attention import ring_attention
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.train.diffusion_trainer import TrainLoop
from confild_tpu_torch.utils import logger as tlog
from confild_tpu_torch.ops import cuda_build
from confild_tpu_torch.ops import flash_attention as fa
from confild_tpu_torch.ops import siren_decode as sd

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3,
# dense TF32 on the tensor cores (a 3xTF32 product takes three), and the
# special-function units' exponentials (132 SMs x 16 a clock x 1.98 GHz)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
TF32_SPLIT_PRODUCTS = 3
PEAK_BF16_FLOPS = 989e12
PEAK_EXP_PER_S = 132 * 16 * 1.98e9

CASE4_CNF = dict(in_coord_features=3, in_latent_features=384, out_features=3,
                 num_hidden_layers=15, hidden_features=384, w0=30.0)
# recipes/conditional/case4_random_sensor.yml, cut to 10 respaced steps and
# one sample; no use_bf16 (the f32 torso of cli/train_diffusion.py:41)
CASE4_RECIPE = dict(
    image_size=384, num_channels=128, num_res_blocks=2, num_heads=4,
    num_head_channels=64, attention_resolutions="32,16,8",
    channel_mult="1,1,2,2,4,4", steps=1000, timestep_respacing="10",
    noise_schedule="cosine", operator="case4", operator_batch_size=384,
    sampler="ddpm", conditioning="ps", scale=1.0, noise="gaussian",
    noise_sigma=0.0, clip_denoised=True, no_of_samples=1, time_length=384,
    latent_size=384, decode_batch_size=16, seed=0)
MESH_POINTS = 4096
GRAD_REL_TOL = 1e-3
RECIPE_CNF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes", "cnf",
                          "case4.yml")
RECIPE_DIFFUSION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes",
                                "diffusion", "case4.yml")
# (BH, N, D, dtype) of the flash checks: the Case4 middle block at batch 8,
# a ragged edge, the xl recipe's level-8 block at batch 4, the auto
# threshold, bf16, a 16-channel head (padded to 32), and the widest head
# the kernels take, 128 (its own plans: one consumer warpgroup in float32)
FLASH_CHECKS = ((64, 144, 64, torch.float32), (2, 200, 32, torch.float32),
                (16, 9216, 64, torch.float32), (4, 16384, 64, torch.float32),
                (2, 256, 64, torch.bfloat16), (64, 144, 64, torch.bfloat16),
                (8, 144, 16, torch.float32), (8, 144, 16, torch.bfloat16),
                (2, 144, 128, torch.float32), (2, 144, 128, torch.bfloat16))
# heads above 128 (at 256, 384 and 512 the float32 forward with Q resident
# and backward pair with the resident rows, the bf16 TMA forward and
# backward; above, the column-group kernels): D = 160 (padded to 256), 256,
# 384, 512 and 1024
# on a ragged N, and the one-head Case4 middle block at batch 8 (8, 144,
# 512), each in float32 and bf16
FLASH_WIDE_CHECKS = tuple((bh, n, d, dtype)
                          for bh, n, d in ((2, 300, 160), (2, 300, 256), (2, 300, 384),
                                           (2, 300, 512), (2, 200, 1024), (8, 144, 512))
                          for dtype in (torch.float32, torch.bfloat16))
FLASH_CHECKS += FLASH_WIDE_CHECKS
FLASH_TIMES = ((64, 144, 64), (16, 9216, 64), (4, 16384, 64))
# timed above 128: the one-head Case4 middle block at batch 8 (the slice's
# path; the kernels line's @D512 rows) and the xl recipe's ds-8 block
# (9216 tokens) under num_heads 1 at batch 8 (the @D256 rows)
FLASH_WIDE_TIMES = {"@D512": (8, 144, 512), "@D256": (8, 9216, 256)}
# the forward alone above 128 at a many-token head of 512 (four heads of
# the xl recipe's ds-8 block at 9216 tokens): the kernels line's
# @D512N9216 rows
FLASH_WIDE_FWD_TIMES = {"@D512N9216": (4, 9216, 512)}
# the float32 backward pair at the same shape (the resident rows' pair at
# 512): the kernels line's float32 @D512N9216 backward rows
FLASH_WIDE_BWD_TIMES = {"@D512N9216": (4, 9216, 512)}
FLASH_PATH_SHAPE = "64x144x64"
# phase 18 (d)'s classifier at batch 4: 4 heads at 1024 tokens, 8 at 256
# and at 64, of 64 channels
FLASH_CLASSIFIER_SHAPES = ((16, 1024, 64), (32, 256, 64), (32, 64, 64))
# flops of one sin2pi activation in the kernels: round-reduce (2), square (1),
# five FMAs (10), final multiply (1), FiLM add (1)
ACT_FLOPS = 15
# ptxas's report of each kernel instantiation ("N registers, ..."), filled
# by phase 2
PTXAS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_median(fn, calls: int, repeats: int = 7) -> tuple[float, float, float]:
    """Milliseconds per call as ``(median, least, largest)`` over
    ``repeats`` separately timed runs of ``calls`` calls each (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2], times[0], times[-1]


def sm_clocks() -> str:
    """The SM clock and its maximum, as ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time with every flop on the CUDA cores (float32)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tc_bound(flops: float, nbytes: float, other_s: float = 0.0,
             rate: float = PEAK_TF32_FLOPS / TF32_SPLIT_PRODUCTS) -> tuple[float, str]:
    """Least time with the matrix products (``flops``) on the tensor cores
    at ``rate`` (by default the 3xTF32 rate; ``PEAK_BF16_FLOPS`` for bf16
    operands), the rest of the arithmetic taking ``other_s`` seconds on its
    own units, and the bytes at the HBM rate: the largest of the three (ms,
    what bounds it)."""
    t_ops = max(flops / rate, other_s)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def device_profile(label: str, fn, top: int = 6) -> dict:
    """Device time by kernel name (torch.profiler) of one call of ``fn``
    after a warm-up call, and the device's busy share of its wall time;
    returns ``{kernel name: (ms, launches)}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # the profiler now and then records no device activity at all for a
    # call that ran kernels; such a call is profiled again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (ms + e.device_time_total / 1e3, n + 1)
        if kernels:
            break
        log(f"[profile] {label}: no device activity recorded; profiling it again")
    busy = sum(ms for ms, _ in kernels.values())
    log(f"[profile] {label}: wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), {sum(n for _, n in kernels.values())} "
        f"kernel launches")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"[profile]   {ms:9.2f} ms  x{n:<5d} {name[:100]}")
    return kernels


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi[0]}")
    return name, count, smi[0]


def kernel_label(line: str) -> str | None:
    """``flash_bwd_dq_kernel<64, f32>``, ``siren_fwd_cluster_kernel<256, 2>``,
    ``siren_fwd_cluster_bf16_kernel<256, 2>`` or
    ``siren_chain_cluster_kernel<256, 2, dz>`` (its training mode ``bwd``)
    from a line holding a kernel's mangled name, or None."""
    chain = re.search(r"(siren_chain_cluster_kernel)ILi(\d+)ELi(\d+)ELb([01])E", line)
    if chain:
        return (f"{chain.group(1)}<{chain.group(2)}, {chain.group(3)}, "
                f"{'dz' if chain.group(4) == '1' else 'bwd'}>")
    found = re.search(r"((?:siren|flash)(?:_(?:[a-z]+|bf16))+_kernel)(?:ILi(\d+)E(\w*?)E)?",
                      line)
    if not found:
        return None
    if not found.group(2):
        return found.group(1)
    second = re.fullmatch(r"Li(\d+)", found.group(3))
    if second:
        return f"{found.group(1)}<{found.group(2)}, {second.group(1)}>"
    if found.group(1).startswith("siren"):
        return f"{found.group(1)}<{found.group(2)}>"
    return (f"{found.group(1)}<{found.group(2)}, "
            f"{'bf16' if 'bfloat16' in found.group(3) else 'f32'}>")


def hmma_counts(paths) -> dict:
    """Tensor-core instructions per kernel in the SASS of the built
    libraries, from ``cuobjdump -sass`` (``hmma_in``): one process per kernel
    (the kernels that ``cuobjdump -res-usage`` lists), as many at once as
    there are CPU cores."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def cuobjdump(*args) -> str:
        proc = subprocess.run([tool, *args], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"cuobjdump {args[0]} failed with code {proc.returncode}")
        return proc.stdout
    jobs = [(fun, str(path)) for path in paths
            for fun in re.findall(r"Function (\S+?):", cuobjdump("-res-usage", str(path)))]
    counts = {}
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        for sass in pool.map(lambda job: cuobjdump("-sass", "-fun", *job), jobs):
            counts.update(hmma_in(sass))
    return counts


def hmma_in(sass: str) -> dict:
    """Tensor-core instructions per kernel in a ``cuobjdump -sass`` listing:
    ``{kernel: {"HMMA": n, "HGMMA": n}}`` (``mma.sync`` and ``wgmma``)."""
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = kernel_label(line)
            if kernel:
                counts[kernel] = {"HMMA": 0, "HGMMA": 0}
        elif kernel:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[kernel][op] += 1
    return counts


def flash_fwd_label(d: int, dtype) -> str:
    """``flash_fwd_kernel<64, f32>``, as ``kernel_label`` names it."""
    return f"{FLASH_FWD_KERNEL}<{d}, {'f32' if dtype == torch.float32 else 'bf16'}>"


def tc_label(counts: dict) -> str:
    """``48 HMMA`` or ``0 HMMA, 24 HGMMA``."""
    return f"{counts['HMMA']} HMMA" + (f", {counts['HGMMA']} HGMMA" if counts["HGMMA"] else "")


# kernels whose every instantiation must run its products on the tensor
# cores' wgmma (HGMMA) and none on mma.sync (HMMA): the SIREN cluster
# kernels, the training backward's reduction and the three flash kernels
BF16_FWD_KERNEL = "siren_fwd_cluster_bf16_kernel"
FLASH_FWD_KERNEL = "flash_fwd_kernel"
FLASH_BWD_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
CLUSTER_KERNELS = ("siren_fwd_cluster_kernel", "siren_chain_cluster_kernel", BF16_FWD_KERNEL)
# the column-group kernels above 128, one instantiation a type
FLASH_WIDE_KERNELS = ("flash_fwd_wide_kernel", "flash_bwd_dq_wide_kernel",
                      "flash_bwd_dkv_wide_kernel")
# the bf16 forward on TMA tensor copies, one instantiation a width, and
# the float32 forward with Q resident, one a group width (128, 256), at
# 256, 384 and 512
FLASH_TMA_KERNEL = "flash_fwd_tma_kernel"
FLASH_WQ_KERNELS = ("flash_fwd_wq_kernel<128, f32>", "flash_fwd_wq_kernel<256, f32>")
# the bf16 backward on TMA tensor copies (dq, dk/dv), one instantiation a
# width each at 256, 384 and 512, and the float32 backward with the
# resident rows, the same
FLASH_TMA_BWD_KERNELS = ("flash_bwd_dq_tma_kernel", "flash_bwd_dkv_tma_kernel")
FLASH_WQB_KERNELS = ("flash_bwd_dq_wq_kernel", "flash_bwd_dkv_wq_kernel")
WGMMA_KERNELS = (CLUSTER_KERNELS + ("siren_bwd_reduce_kernel", FLASH_FWD_KERNEL)
                 + FLASH_BWD_KERNELS + FLASH_WIDE_KERNELS
                 + (FLASH_TMA_KERNEL, "flash_fwd_wq_kernel") + FLASH_TMA_BWD_KERNELS
                 + FLASH_WQB_KERNELS)
# the flash kernels' instantiations: every head width in both types
FLASH_FWD_INSTANCES = tuple((d, dtype) for d in (32, 64, 128)
                            for dtype in (torch.float32, torch.bfloat16))


def flash_wide_label(kernel: str, dtype) -> str:
    """``flash_fwd_wide_kernel<128, f32>``, as ``kernel_label`` names it."""
    return f"{kernel}<128, {'f32' if dtype == torch.float32 else 'bf16'}>"


def flash_tma_label(d: int, kernel: str = "fwd") -> str:
    """``flash_fwd_tma_kernel<256, bf16>`` (``kernel`` "fwd"), or
    ``flash_bwd_dq_tma_kernel<256, bf16>`` ("dq", "dkv"), as
    ``kernel_label`` names it."""
    return f"flash_{'fwd' if kernel == 'fwd' else 'bwd_' + kernel}_tma_kernel<{d}, bf16>"


def flash_wide_bwd_label(d: int, kernel: str, dtype) -> str:
    """The backward instantiation above 128 at ``TMA_WIDTHS``:
    ``flash_bwd_dq_tma_kernel<256, bf16>`` in bf16,
    ``flash_bwd_dq_wq_kernel<256, f32>`` (``kernel`` "dq" or "dkv") in
    float32, as ``kernel_label`` names them."""
    if dtype == torch.bfloat16:
        return flash_tma_label(d, kernel)
    return f"flash_bwd_{kernel}_wq_kernel<{d}, f32>"


def ptxas_serial_notes(log: str, labels) -> list[str]:
    """ptxas's notes (C7515, C7514) that it serialised the ``wgmma`` of one
    of the kernels ``labels`` (as ``kernel_label`` names them)."""
    return [line.strip() for line in log.splitlines()
            if re.search(r"C751[45]", line) and kernel_label(line) in labels]


def flash_bwd_label(kernel: str, d: int, dtype) -> str:
    """``flash_bwd_dq_kernel<64, f32>`` (``kernel`` "dq" or "dkv"), as
    ``kernel_label`` names it."""
    return f"flash_bwd_{kernel}_kernel<{d}, {'f32' if dtype == torch.float32 else 'bf16'}>"


# the reduction's instantiations, ``<tile columns, subtile columns>``, one a
# tile width (csrc/siren_decode_bwd.cu::reduce_cols), both launched by the
# main paths (128 at H = 128, 512 and 1024; 192 at Case4's 384)
REDUCE_TILES = (128, 192)


def phase_build():
    names = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    paths = cuda_build.build_all(names)
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(p.name for p in paths)} in {dt:.2f} s")
    # one line per kernel instantiation: registers and spills (ptxas -v),
    # and for the tensor-core libraries the HMMA and HGMMA counts of each
    # kernel
    hmma = hmma_counts(cuda_build.library_path(lib) for lib in (
        "flash_attention", "siren_decode_bwd", "siren_fwd_cluster",
        "siren_chain_cluster"))
    for name in names:
        kernel, spill = None, ""
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if "Function properties" in line and kernel_label(line):
                kernel = kernel_label(line)
            elif "spill stores" in line:
                spill = re.sub(r"\s+", " ", line.strip())
            elif "registers" in line and kernel:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                tc = f", {tc_label(hmma[kernel])}" if kernel in hmma else ""
                PTXAS[kernel] = f"{regs} registers, {spill}{tc}"
                log(f"[build] {name}: {kernel}: {PTXAS[kernel]}")
                kernel = None
    no_hgmma = [k for k, v in hmma.items() if k.startswith(WGMMA_KERNELS) and v["HGMMA"] == 0]
    mma_sync = [k for k, v in hmma.items() if k.startswith(WGMMA_KERNELS) and v["HMMA"]]
    missing = [bn for bn in REDUCE_TILES
               if not any(k.startswith(f"siren_bwd_reduce_kernel<{bn},") for k in hmma)]
    missing += [label for d, dtype in FLASH_FWD_INSTANCES
                for label in (flash_fwd_label(d, dtype), flash_bwd_label("dq", d, dtype),
                              flash_bwd_label("dkv", d, dtype)) if label not in hmma]
    missing += [flash_tma_label(d, kernel) for d in fa.TMA_WIDTHS
                for kernel in ("fwd", *fa.BWD_KERNELS) if flash_tma_label(d, kernel) not in hmma]
    missing += [k for k in FLASH_WQ_KERNELS if k not in hmma]
    missing += [flash_wide_bwd_label(d, kernel, torch.float32) for d in fa.TMA_WIDTHS
                for kernel in fa.BWD_KERNELS
                if flash_wide_bwd_label(d, kernel, torch.float32) not in hmma]
    missing += [flash_wide_label(k, dtype) for k in FLASH_WIDE_KERNELS
                for dtype in (torch.float32, torch.bfloat16)
                if flash_wide_label(k, dtype) not in hmma]
    missing += [p for p in WGMMA_KERNELS if not any(k.split("<")[0] == p for k in hmma)]
    if no_hgmma or mma_sync or missing:
        raise SystemExit(f"kernel instantiations without wgmma (HGMMA): {no_hgmma}; with "
                         f"mma.sync (HMMA): {mma_sync}; reduction tile widths, flash "
                         f"instantiations or kernels missing: {missing}")
    # the flash kernels' plans in each instantiation: the library's against
    # the wrapper's mirror, beside their registers and spills
    for d, dtype in FLASH_FWD_INSTANCES:
        label = flash_fwd_label(d, dtype)
        plan = fa.library_forward_plan(d, dtype)
        log(f"[build] {label}: {plan['keys']} keys a tile, {plan['raw_stages']} raw and "
            f"{plan['image_stages']} image stages, {plan['smem']} bytes of dynamic shared "
            f"memory; {PTXAS.get(label)}")
        if plan != fa.forward_plan(d, dtype):
            raise SystemExit(f"{label}: the library's plan {plan} is not the wrapper's "
                             f"{fa.forward_plan(d, dtype)}")
        plans = fa.library_backward_plan(d, dtype)
        for kernel in fa.BWD_KERNELS:
            label, plan = flash_bwd_label(kernel, d, dtype), plans[kernel]
            log(f"[build] {label}: {plan['rows']} rows a block in {plan['consumers']} consumer "
                f"warpgroups, {plan['tile']} rows a tile, {plan['raw_stages']} raw and "
                f"{plan['image_stages']} image stages, {plan['smem']} bytes of dynamic shared "
                f"memory; {PTXAS.get(label)}")
            if plan != fa.backward_plan(d, dtype, kernel):
                raise SystemExit(f"{label}: the library's plan {plan} is not the wrapper's "
                                 f"{fa.backward_plan(d, dtype, kernel)}")
    # the float32 forward with Q resident: no spill (its plans: below)
    for label in FLASH_WQ_KERNELS:
        log(f"[build] {label}: {PTXAS.get(label)}")
        if " 0 bytes spill stores" not in PTXAS.get(label, ""):
            raise SystemExit(f"{label} spills: {PTXAS.get(label)}")
    # the bf16 TMA forward: every instantiation HGMMA only with no spill,
    # its plan the wrapper's
    for d in fa.TMA_WIDTHS:
        label, plan = flash_tma_label(d), fa.library_forward_plan(d, torch.bfloat16)
        log(f"[build] {label}: {plan['keys']} keys a tile, {plan['raw_stages']} TMA stages, "
            f"{fa.forward_columns(d, torch.bfloat16)} output columns a block, {plan['smem']} "
            f"bytes of dynamic shared memory; {PTXAS.get(label)}")
        if plan != fa.forward_plan(d, torch.bfloat16):
            raise SystemExit(f"{label}: the library's plan {plan} is not the wrapper's "
                             f"{fa.forward_plan(d, torch.bfloat16)}")
        if " 0 bytes spill stores" not in PTXAS.get(label, ""):
            raise SystemExit(f"{label} spills: {PTXAS.get(label)}")
        # the bf16 TMA backward and the float32 backward with the resident
        # rows: the same, both passes; the float32 pair with no note of
        # ptxas's that it serialised its wgmma either
        for dtype in (torch.bfloat16, torch.float32):
            for kernel, plan in fa.library_backward_plan(d, dtype).items():
                label = flash_wide_bwd_label(d, kernel, dtype)
                log(f"[build] {label}: {plan['rows']} rows a block in {plan['consumers']} "
                    f"consumer warpgroups, {plan['tile']} rows a tile, {plan['raw_stages']} "
                    f"TMA and {plan['image_stages']} item stages, "
                    f"{fa.backward_columns(d, dtype)} output columns a block, "
                    f"{plan['smem']} bytes of dynamic shared memory; {PTXAS.get(label)}")
                if plan != fa.backward_plan(d, dtype, kernel):
                    raise SystemExit(f"{label}: the library's plan {plan} is not the "
                                     f"wrapper's {fa.backward_plan(d, dtype, kernel)}")
                if " 0 bytes spill stores" not in PTXAS.get(label, ""):
                    raise SystemExit(f"{label} spills: {PTXAS.get(label)}")
                # three warpgroups whose setmaxnreg share out the 168 each starts at
                if dtype == torch.float32 and not PTXAS.get(label, "").startswith("168 "):
                    raise SystemExit(f"{label} does not start at 168 registers: "
                                     f"{PTXAS.get(label)}")
        serial = ptxas_serial_notes(cuda_build.build_logs.get("flash_attention", ""),
                                    {flash_wide_bwd_label(d, kernel, torch.float32)
                                     for kernel in fa.BWD_KERNELS})
        if serial:
            raise SystemExit(f"ptxas serialised the float32 backward's wgmma at D = {d}: "
                             f"{serial}")
    # above 128: one plan a pass and type, whatever the width (the bf16
    # forward's and backward's at 256, 384 and 512 are the TMA kernels',
    # above; the float32 forward's up to 512 that with Q resident, whose
    # bytes follow d)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (256, 384, 512, 1024):
            plans = {"fwd": fa.library_forward_plan(d, dtype),
                     **fa.library_backward_plan(d, dtype)}
            mirror = {"fwd": fa.forward_plan(d, dtype),
                      **{k: fa.backward_plan(d, dtype, k) for k in fa.BWD_KERNELS}}
            for kernel, key in zip(FLASH_WIDE_KERNELS, ("fwd", "dq", "dkv")):
                label = (flash_wide_label(kernel, dtype) if d not in fa.TMA_WIDTHS
                         else flash_wide_bwd_label(d, key, dtype) if key != "fwd"
                         else flash_tma_label(d) if dtype == torch.bfloat16
                         else FLASH_WQ_KERNELS[d % 256 == 0])
                log(f"[build] {label} at D = {d}: {plans[key]}; {PTXAS.get(label)}")
                if plans[key] != mirror[key]:
                    raise SystemExit(f"{label} at D = {d}: the library's plan {plans[key]} is "
                                     f"not the wrapper's {mirror[key]}")


def case4_decoder(device):
    gen = torch.Generator().manual_seed(1)
    return SirenFilm(**CASE4_CNF, generator=gen).to(device).requires_grad_(False)


def f64_decode(model, coords, latents, chunk: int):
    """Float64 reference decode (torch.sin layer loop), chunked over points."""
    m64 = _double(model)
    with torch.no_grad():
        return torch.cat([sd.siren_decode(m64, coords[i:i + chunk].double(), latents.double(),
                                       m64.w0, use_pallas=False)
                          for i in range(0, coords.shape[0], chunk)], dim=1)


def f64_dlatents(model, coords, latents, g, chunk: int):
    """Float64 autograd dL/dlatents of sum(decode * g), chunked over points."""
    m64 = _double(model)
    total = torch.zeros_like(latents, dtype=torch.float64)
    for i in range(0, coords.shape[0], chunk):
        lat = latents.double().requires_grad_(True)
        out = sd.siren_decode(m64, coords[i:i + chunk].double(), lat, m64.w0, use_pallas=False)
        (grad,) = torch.autograd.grad((out * g[:, i:i + chunk].double()).sum(), lat)
        total += grad
    return total


def _double(model):
    return copy.deepcopy(model).double()


CASE2_CNF = dict(in_coord_features=2, in_latent_features=256, out_features=4,
                 num_hidden_layers=10, hidden_features=256, w0=30.0)
# a hidden width that is no multiple of 64: the wrappers pad it to 128
H96_CNF = dict(in_coord_features=3, in_latent_features=384, out_features=3,
               num_hidden_layers=3, hidden_features=96, w0=30.0)


def h96_decoder(device):
    return SirenFilm(**H96_CNF, generator=torch.Generator().manual_seed(3)).to(
        device).requires_grad_(False)


def forward_case(model, device, rows, points, seed):
    """Coordinates and latents from a seed, and the folded operands."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c_in, n_lat = model.net1[0].in_features, model.net2[0].in_features
    coords = torch.rand((points, c_in), generator=gen, device=device) * 2 - 1
    latents = torch.randn((rows, n_lat), generator=gen, device=device) * 0.1
    w_first, w_mid, w_head, b_head, w2, b1, scale = sd.stack_weights(model, model.w0)
    z = sd.film_table(latents, w2, b1, scale)
    return coords, latents, z, [w_first, w_mid, w_head, b_head]


def forward_check(model, device, rows, points, seed, label) -> float:
    """Forward kernel vs plain vs float64 at ``rows x points`` under the JAX
    tests' criterion ``err_kernel <= 2 * err_plain_f32 + 1e-6``, and two
    launches bitwise equal; returns the kernel's error."""
    coords, latents, z, ops = forward_case(model, device, rows, points, seed)
    with torch.no_grad():
        kern = sd.decode_forward(coords, z, *ops)
        same = torch.equal(kern, sd.decode_forward(coords, z, *ops))
        plain = sd.decode_forward_plain(coords, z, *ops)
        truth = f64_decode(model, coords, latents, chunk=32768)
    torch.cuda.synchronize()
    err_k = (kern.double() - truth).abs().max().item()
    err_p = (plain.double() - truth).abs().max().item()
    limit = 2 * err_p + 1e-6
    ok = err_k <= limit and same and torch.isfinite(kern).all().item()
    log(f"[forward] {label} {rows}x{points}: |kernel-f64| {err_k:.3e}, |plain-f64| "
        f"{err_p:.3e}, |kernel-plain| {(kern - plain).abs().max().item():.3e}, max |f64| "
        f"{truth.abs().max().item():.3e}, error / limit {err_k / limit:.3f}; two launches "
        f"bitwise equal: {same} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("forward kernel fails the f64-relative criterion or is not "
                         "deterministic")
    del kern, plain, truth
    torch.cuda.empty_cache()
    return err_k


def forward_time(model, device, rows, points, seed, repeats: int = 7) -> dict:
    """The forward kernel at ``rows x points``: median of ``repeats``
    separately timed calls with the least and largest and the SM clocks
    around them, each
    of its kernels' device time (torch.profiler) with the rate of
    products, the plain version's time, the bound, and the bytes that the
    blocks read of the split weight stream (from L2)."""
    coords, _, z, ops = forward_case(model, device, rows, points, seed)
    fn = lambda: sd.decode_forward(coords, z, *ops)
    with torch.no_grad():
        log(f"[forward-time] SM clock, max before: {sm_clocks()}")
        ms, least, largest = cuda_median(fn, 1, repeats)
        log(f"[forward-time] SM clock, max after: {sm_clocks()}")
        plain_ms = cuda_median(lambda: sd.decode_forward_plain(coords, z, *ops),
                               3 if repeats > 3 else 1, repeats=1)[0]
        prof = device_profile(f"forward {rows}x{points}", fn, top=3)
    n_mod, h = z.shape[0], z.shape[2]
    c_in, c_out = coords.shape[1], ops[2].shape[1]
    pairs = rows * points
    products = pairs * 2 * (n_mod - 1) * h * h
    mat = pairs * 2 * h * (c_in + (n_mod - 1) * h + c_out)
    act = pairs * ACT_FLOPS * h * n_mod
    flops = mat + act
    nbytes = 4 * (points * c_in + n_mod * rows * h + c_in * h + (n_mod - 1) * h * h
                  + h * c_out + c_out + pairs * c_out)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
    fwd_ms = 0.0
    for part, name in (("prep", PREP_KERNEL), ("forward", "siren_fwd_cluster_kernel")):
        hits = [v for k, v in prof.items() if name in k]
        dev_ms = sum(ms_ for ms_, _ in hits)
        if not hits:
            log(f"[forward-time] {rows}x{points} {part}: device time not measured")
            continue
        rate = (f", {products / dev_ms / 1e9:.2f} TFLOP/s of products"
                if part == "forward" else "")
        fwd_ms = dev_ms if part == "forward" else fwd_ms
        log(f"[forward-time] {rows}x{points} {part}: {dev_ms:.3f} ms device, "
            f"{sum(n for _, n in hits)} launches{rate}")
    # every cluster (each block its columns) reads the whole split stream
    group = sd.cluster_plan(h).pairs
    stream = -(-pairs // group) * (n_mod - 1) * 2 * h * h * 4
    log(f"[forward-time] {rows}x{points}: the clusters of {group} pairs read "
        f"{stream / 1e12:.3f} TB of the "
        f"{(n_mod - 1) * 2 * h * h * 4 / 1e6:.1f} MB split weight stream from L2"
        + (f" ({stream / 1e9 / fwd_ms:.2f} TB/s over the forward's device time)"
           if fwd_ms else ""))
    log(f"[forward] {rows}x{points} H={h}: kernel {ms:.3f} ms [{least:.3f}-{largest:.3f}] median "
        f"of {repeats} ({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}; every flop on the CUDA cores: "
        f"{bound(flops, nbytes)[0]:.3f} ms); library: none (no single PyTorch call "
        f"computes it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=f"{rows}x{points}")


def phase_forward(device, results):
    """Forward kernel vs plain vs float64 at one decoder chunk of a
    262144-point mesh (16 rows), at a CNF training batch (4 rows) and at
    Case2's widths (a second instantiation, a ragged last block); timed
    at 16 and 4 rows."""
    model = case4_decoder(device)
    err = forward_check(model, device, 16, 262144, 3, "case4")
    forward_check(model, device, 4, 262144, 4, "case4")
    case2 = SirenFilm(**CASE2_CNF, generator=torch.Generator().manual_seed(2)).to(device)
    forward_check(case2.requires_grad_(False), device, 3, 3000, 5, "case2")
    del case2
    forward_check(h96_decoder(device), device, 4, 3000, 6, "H=96 (padded to 128)")
    results["siren_decode_forward"] = dict(forward_time(model, device, 16, 262144, 3),
                                           max_abs_err=err)
    forward_time(model, device, 4, 262144, 4)


def dz_case(model, device, rows, points, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    c_in, n_lat = model.net1[0].in_features, model.net2[0].in_features
    coords = torch.rand((points, c_in), generator=gen, device=device) * 2 - 1
    latents = torch.rand((rows, n_lat), generator=gen, device=device) * 2 - 1
    g = torch.randn((rows, points, model.net1[-1].out_features), generator=gen, device=device)
    w_first, w_mid, w_head, _, w2, b1, scale = sd.stack_weights(model, model.w0)
    ops = [w_first, w_mid, w_head]
    z = sd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, ops, w2, scale


def dz_check(model, device, rows, points, seed, label, against_bwd=False) -> float:
    """dz kernel vs plain vs float64 on ``dL/dlatents`` at ``rows x
    points`` under ``err_kernel <= 2 * err_plain + 1e-6``, two
    launches bitwise equal, and with ``against_bwd`` the training
    backward's dz under the same criterion and against the kernel's;
    returns the kernel's error."""
    coords, latents, g, z, ops, w2, scale = dz_case(model, device, rows, points, seed)
    dl = lambda dz: torch.einsum("nth,nlh->tl", dz * scale, w2)
    with torch.no_grad():
        dz_k = sd.decode_dz(coords, z, g, *ops)
        same = torch.equal(dz_k, sd.decode_dz(coords, z, g, *ops))
        dl_k, dl_p = dl(dz_k), dl(sd.decode_dz_plain(coords, z, g, *ops))
        dl_b = dl(sd.decode_bwd(coords, z, g, *ops)[0]) if against_bwd else None
    truth = f64_dlatents(model, coords, latents, g, chunk=128)
    err_k = (dl_k.double() - truth).abs().max().item()
    err_p = (dl_p.double() - truth).abs().max().item()
    top = truth.abs().max().item()
    limit = 2 * err_p + 1e-6
    ok = err_k <= limit and same and torch.isfinite(dl_k).all().item()
    log(f"[dz] {label} {rows}x{points}: |dlatents kernel-f64| {err_k:.3e}, |plain-f64| "
        f"{err_p:.3e}, max |f64| {top:.3e}, error / limit {err_k / limit:.3f}; two launches "
        f"bitwise equal: {same} -> {'ok' if ok else 'FAIL'}")
    if dl_b is not None:
        err_b = (dl_b.double() - truth).abs().max().item()
        diff = (dl_k - dl_b).abs().max().item()
        good = err_b <= limit and diff <= limit
        ok &= good
        log(f"[dz] {label} {rows}x{points}: training backward's dz |dlatents bwd-f64| "
            f"{err_b:.3e} (error / limit {err_b / limit:.3f}), |dz kernel - bwd| "
            f"{diff:.3e} (/ limit {diff / limit:.3f}) -> {'ok' if good else 'FAIL'}")
    if not ok:
        raise SystemExit("dz kernel fails the f64-relative criterion, disagrees with the "
                         "training backward or is not deterministic")
    del dz_k, dl_k, dl_p, dl_b, truth
    torch.cuda.empty_cache()
    return err_k


def peak_above(fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated
    before it, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


# the kernels of the float32 forward's and the chain's weight preparation
# and of the chain, in both modes, at every width
PREP_KERNEL = "siren_cluster_prep_kernel"
CHAIN_KERNEL = "siren_chain_cluster_kernel"


def chain_stream(pairs: int, h: int, n_mod: int, chain_ms: float) -> str:
    """The bytes that the chain's clusters (each block its columns) read of
    the split weight stream, the forward's products and the dx chain's,
    over ``pairs`` pairs in chunks of ``BWD_PAIRS``, and the rate over the
    chain's device time."""
    group = sd.cluster_plan(h).pairs
    units = sum(-(-q // group) for _, q in sd.pair_chunks(pairs, min(pairs, sd.BWD_PAIRS)))
    one = 2 * (n_mod - 1) * 2 * h * h * 4
    return (f"the clusters of {group} pairs read "
            f"{units * one / 1e12:.3f} TB of the {one / 1e6:.1f} MB split weight stream from L2"
            + (f" ({units * one / 1e9 / chain_ms:.2f} TB/s over the chain's device time)"
               if chain_ms else ""))


def dz_time(model, device, rows, points, seed, repeats: int = 7) -> dict:
    """The dz kernel at ``rows x points``: median of ``repeats`` separately
    timed calls with the least and largest and the SM clocks around them, the
    device time of the chain, the fold and the weight preparation
    (torch.profiler) with
    the rate of products, the peak workspace, the plain version's time and
    the bound."""
    coords, _, g, z, ops, _, _ = dz_case(model, device, rows, points, seed)
    fn = lambda: sd.decode_dz(coords, z, g, *ops)
    n_mod, h = z.shape[0], z.shape[2]
    c_in, c_out = coords.shape[1], g.shape[2]
    pairs = rows * points
    with torch.no_grad():
        log(f"[dz-time] SM clock, max before: {sm_clocks()}")
        ms, least, largest = cuda_median(fn, 1 if pairs > 65536 else 5, repeats)
        log(f"[dz-time] SM clock, max after: {sm_clocks()}")
        peak = peak_above(fn)
        plain_ms = cuda_median(lambda: sd.decode_dz_plain(coords, z, g, *ops),
                               3 if repeats > 3 else 1, repeats=1)[0]
        prof = device_profile(f"dz {rows}x{points}", fn, top=4)
    dz_mib = 4 * z.numel() / 2**20
    log(f"[dz-time] {rows}x{points}: peak memory above inputs {peak * 1024:.1f} MiB: dz "
        f"{dz_mib:.1f} MiB and a workspace of {peak * 1024 - dz_mib:.1f} MiB (a chunk's "
        f"pre-activations and partials, the split weights)")
    products = pairs * 4 * (n_mod - 1) * h * h   # forward recompute and dx chain
    chain_ms = 0.0
    for part, name in (("chain", CHAIN_KERNEL), ("fold", "siren_dz_fold_kernel"),
                       ("prep", PREP_KERNEL)):
        hits = [v for k, v in prof.items() if name in k]
        dev_ms = sum(ms_ for ms_, _ in hits)
        chain_ms = dev_ms if part == "chain" else chain_ms
        rate = (f", {products / dev_ms / 1e9:.2f} TFLOP/s of products"
                if part == "chain" and dev_ms else "")
        log(f"[dz-time] {rows}x{points} {part}: {dev_ms:.3f} ms device, "
            f"{sum(n for _, n in hits)} launches{rate}")
    log(f"[dz-time] {rows}x{points}: {chain_stream(pairs, h, n_mod, chain_ms)}")
    mat = pairs * 2 * h * (c_in + 2 * (n_mod - 1) * h + c_out)
    act = pairs * (2 * ACT_FLOPS + 2) * h * n_mod
    nbytes = 4 * (points * c_in + n_mod * rows * h + pairs * c_out + c_in * h
                  + (n_mod - 1) * h * h + h * c_out + n_mod * rows * h)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
    log(f"[dz] {rows}x{points} H={h}: kernel {ms:.3f} ms [{least:.3f}-{largest:.3f}] median of "
        f"{repeats} "
        f"({products / ms / 1e9:.2f} TFLOP/s of products), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}; every flop on the CUDA cores: "
        f"{bound(mat + act, nbytes)[0]:.3f} ms); library: none (no single PyTorch call "
        f"computes it; the operator's other route is timed in [crossover])")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=f"{rows}x{points}")


def phase_dz(device, results):
    """dz kernel vs plain vs float64 at Case4's 10 sensors, at 1024 points
    (also against the training backward's dz), at a ragged 100 x 3000 that
    cuts rows across blocks and chunks, and at Case2's widths; timed at
    384 x 1024 and 384 x 10."""
    model = case4_decoder(device)
    err = {}
    for rows, points in ((384, 10), (384, 1024), (100, 3000)):
        err[rows, points] = dz_check(model, device, rows, points, 5, "case4",
                                     against_bwd=points == 1024)
    case2 = SirenFilm(**CASE2_CNF, generator=torch.Generator().manual_seed(2)).to(device)
    dz_check(case2.requires_grad_(False), device, 3, 3000, 6, "case2")
    del case2
    dz_check(h96_decoder(device), device, 4, 3000, 7, "H=96 (padded to 128)")
    for rows, points in ((384, 1024), (384, 10)):
        results[f"siren_decode_dz@{rows}x{points}"] = dict(
            dz_time(model, device, rows, points, 5), max_abs_err=err[rows, points])


def phase_crossover(device):
    """Operator gradient cost, plain autograd decode vs forward + dz kernels,
    over sensor counts at 384 rows: time and peak memory above inputs, where
    the operator's 65536 rule sits."""
    model = case4_decoder(device)
    rows = []
    for points in (10, 64, 128, 170, 256, 512, 1024, 2048):
        coords, latents, g, *_ = dz_case(model, device, 384, points, seed=7)

        def plain():
            lat = latents.clone().requires_grad_(True)
            out = sd.siren_decode(model, coords, lat, model.w0, use_pallas=False)
            torch.autograd.grad((out * g).sum(), lat)

        def fused():
            lat = latents.clone().requires_grad_(True)
            out = sd.fused_siren_decode_frozen(model, coords, lat, model.w0)
            torch.autograd.grad((out * g).sum(), lat)

        t_plain = cuda_median(plain, 5, repeats=1)[0]
        mem_plain = peak_above(plain)
        torch.cuda.empty_cache()
        t_fused = cuda_median(fused, 5, repeats=1)[0]
        mem_fused = peak_above(fused)
        torch.cuda.empty_cache()
        rows.append({"points": points, "pairs": 384 * points, "plain_autograd_ms": t_plain,
                     "fused_ms": t_fused, "plain_peak_gib": mem_plain, "fused_peak_gib": mem_fused})
        log(f"[crossover] 384x{points} ({384 * points} pairs): plain autograd {t_plain:.3f} ms, "
            f"peak {mem_plain:.3f} GiB; "
            f"forward+dz kernels {t_fused:.3f} ms, peak {mem_fused:.3f} GiB")
    log("[crossover] " + json.dumps(rows))


def write_assets(root, n_sensors: int) -> dict:
    """Case4 assets from a seed: U-Net and CNF weights in the reference .pt
    layout, the hierarchical normalizer file, mesh, sensors and measures."""
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    unet_pt = os.path.join(root, "ema.pt")
    if not os.path.exists(unet_pt):
        torch.manual_seed(0)
        unet = tunet.create_model(**{k: CASE4_RECIPE[k] for k in (
            "image_size", "num_channels", "num_res_blocks", "num_heads", "num_head_channels",
            "attention_resolutions", "channel_mult")})
        torch.save(unet.state_dict(), unet_pt)
        model = case4_decoder("cpu")
        rng = np.random.default_rng(0)
        torch.save({"model_state_dict": model.state_dict(),
                    "hidden_states": {"latents": torch.zeros(1, L)}},
                   os.path.join(root, "cnf.pt"))
        torch.save({"x_normalizer_params": (torch.ones(3), torch.zeros(3)),
                    "y_normalizer0u_params": torch.ones(1, 3),
                    "y_normalizer0l_params": -torch.ones(1, 3)},
                   os.path.join(root, "normalizer.pt"))
        np.save(os.path.join(root, "coords.npy"),
                rng.uniform(size=(MESH_POINTS, 3)).astype(np.float32))
        np.save(os.path.join(root, "data_max.npy"), np.float32(1.0))
        np.save(os.path.join(root, "data_min.npy"), np.float32(-1.0))
    rng = np.random.default_rng(n_sensors)
    sensors = os.path.join(root, f"sensors_{n_sensors}.npy")
    measures = os.path.join(root, f"measures_{n_sensors}.npy")
    np.save(sensors, rng.uniform(size=(n_sensors, 3)).astype(np.float32))
    np.save(measures, (0.1 * rng.standard_normal((T, n_sensors, 3))).astype(np.float32))
    return dict(CASE4_RECIPE, ema_path=unet_pt, cnf_checkpoint=os.path.join(root, "cnf.pt"),
                cnf_normalizer=os.path.join(root, "normalizer.pt"),
                cnf_coords=os.path.join(root, "coords.npy"),
                data_max=os.path.join(root, "data_max.npy"),
                data_min=os.path.join(root, "data_min.npy"),
                sensor_coords=sensors, sensor_measures=measures,
                save_path=os.path.join(root, f"samples_{n_sensors}.npy"))


def phase_main_path(root):
    """The CLI at full width, at 10 and at 1024 sensors; returns the summed
    launch counts of the two runs."""
    T = CASE4_RECIPE["time_length"]
    launches = {k: 0 for k in sd.LAUNCHES}
    for n_sensors in (10, 1024):
        recipe = write_assets(root, n_sensors)
        path = os.path.join(root, f"case4_{n_sensors}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(recipe, f)
        torch.cuda.reset_peak_memory_stats()
        sd.reset_launch_counts()
        t0 = time.perf_counter()
        timings = sample_conditional.main([path])
        wall = time.perf_counter() - t0
        counts = dict(sd.LAUNCHES)
        fields = np.load(recipe["save_path"])
        expected = (1, T, MESH_POINTS, 3)
        ok = fields.shape == expected and np.isfinite(fields).all()
        log(f"[main] {n_sensors} sensors: fields {fields.shape}, finite "
            f"{bool(np.isfinite(fields).all())}; {timings['steps']} guided steps "
            f"{timings['sample_s'] * 1e3 / timings['steps']:.1f} ms/step, decode "
            f"{timings['decode_s'] * 1e3:.1f} ms ({T} rows x {MESH_POINTS} points), CLI wall "
            f"{wall:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {counts}")
        if not ok:
            raise SystemExit(f"main path output wrong: {fields.shape}, expected {expected}")
        need = ["siren_decode_forward"] + (["siren_decode_dz"] if n_sensors * T > FUSED_MIN_PAIRS else [])
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise SystemExit(f"main path ran without launching {missing}")
        for k, v in counts.items():
            launches[k] += v
    return launches


def profile_step(step) -> None:
    """Device time of one guided step by kernel and the convolutions' share."""
    kernels = device_profile("one guided step (plain decode)", step, top=8)
    busy = sum(ms for ms, _ in kernels.values())
    conv = sum(ms for k, (ms, _) in kernels.items()
               if "conv" in k.lower() or "cudnn" in k.lower() or "implicit" in k.lower())
    log(f"[profile]   convolution kernels {conv:.1f} ms ({conv / max(busy, 1e-9):.1%} of busy)")


def phase_fused_dps(root, device):
    """One guided step's gradient through the full-width U-Net, with the
    operator forced onto the kernels and onto the plain decode, at Case4's
    10 sensors and at 1024; at 1024 each route's device time."""
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    hp = cfgmod.basic_input(write_assets(root, 10))
    model, _ = sample_conditional.build_model_and_diffusion(hp)
    model = sample_conditional.load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
    sampler = create_sampler(steps=hp.steps, noise_schedule=hp.noise_schedule,
                             timestep_respacing=hp.timestep_respacing)
    gen = torch.Generator(device=device).manual_seed(11)
    # a late step (internal index 1): at the first steps x0_hat is clamped
    # to [-1, 1] nearly everywhere and the gradient is almost all zero
    x_prev = 0.5 * torch.randn((1, 1, T, L), generator=gen, device=device)
    noise = torch.randn((1, 1, T, L), generator=gen, device=device)
    t = torch.full((1,), 1, dtype=torch.long)
    for n_sensors in (10, 1024):
        assets = write_assets(root, n_sensors)
        y = torch.as_tensor(np.load(assets["sensor_measures"]), device=device)
        grads = {}
        for use_pallas in (False, True):
            op = get_operator("case4", coords_path=assets["sensor_coords"],
                              max_val_path=hp.data_max, min_val_path=hp.data_min,
                              normalizer_params_path=hp.cnf_normalizer,
                              ckpt_path=hp.cnf_checkpoint, device=device)
            op.use_pallas = use_pallas
            method = get_conditioning_method("ps", op, get_noise("gaussian", sigma=0.0),
                                             scale=1.0)

            def grad():
                x = x_prev.clone().requires_grad_(True)
                out = sampler.diffusion.p_sample(model, x, t, noise=noise)
                norm = method.misfit(out["pred_xstart"], y)
                return torch.autograd.grad(norm.sum(), x)[0]

            def step():
                sampler._one_step(model, x_prev, t, y, method, noise=noise,
                                  measurement_noise=torch.zeros_like(y))
            sd.reset_launch_counts()
            grads[use_pallas] = grad()
            torch.cuda.synchronize()
            counts = dict(sd.LAUNCHES)
            if use_pallas and (counts["siren_decode_forward"] == 0
                               or counts["siren_decode_dz"] == 0):
                raise SystemExit(f"forced fused DPS step launched {counts}")
            step_ms = cuda_median(step, 3, repeats=1)[0]
            log(f"[dps] {n_sensors} sensors, use_pallas={use_pallas}: launches {counts}, "
                f"guided step {step_ms:.1f} ms")
            if n_sensors == 10 and not use_pallas:   # the path Case4's 10 sensors take
                profile_step(step)
            elif n_sensors == 1024:
                device_profile(f"one guided step, 1024 sensors, "
                               f"{'forward + dz kernels' if use_pallas else 'plain decode'}",
                               step, top=3)
        a, b = grads[True], grads[False]
        rel = ((a - b).norm() / b.norm()).item()
        ok = rel <= GRAD_REL_TOL and torch.isfinite(a).all().item() and b.norm().item() > 0
        log(f"[dps] {n_sensors} sensors, grad wrt x_prev, kernels vs plain decode: rel L2 "
            f"{rel:.3e} (tol {GRAD_REL_TOL}), max abs {(a - b).abs().max().item():.3e}, "
            f"|grad| {b.norm().item():.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("fused DPS gradient disagrees with the plain decode")


# ---------------------------------------------------------------------------
# training: the training-backward kernel, the ops' gradients, the CLI
# ---------------------------------------------------------------------------

def abs_max(x: torch.Tensor) -> float:
    """The largest magnitude in ``x``; 0 for an empty tensor (the middle
    weights' gradient of a decoder of one modulated layer)."""
    return x.abs().max().item() if x.numel() else 0.0


def f64_train_grads(model, coords, latents, g, chunk: int):
    """Float64 autograd of ``sum(decode * g)`` through the reference layer
    loop (``siren_film_apply``'s ``torch.sin`` arithmetic), chunked over
    points: the decoder's parameter gradients, ``dL/dlatents`` and
    ``dL/dz_l`` per row (the gradient of each layer's FiLM term)."""
    m64 = _double(model).requires_grad_(True)
    lat = latents.double().requires_grad_(True)
    dz = torch.zeros((m64.n_modulated, latents.shape[0], m64.net1[0].out_features),
                     dtype=torch.float64, device=latents.device)
    for i in range(0, coords.shape[0], chunk):
        x, films = coords[i:i + chunk].double()[None], []
        for lin1, lin2 in zip(m64.net1[:-1], m64.net2):
            films.append(lin2(lat[:, None, :]))
            films[-1].retain_grad()
            x = torch.sin(m64.w0 * (lin1(x) + films[-1]))
        (m64.net1[-1](x) * g[:, i:i + chunk].double()).sum().backward()
        for l, f in enumerate(films):
            dz[l] += f.grad[:, 0, :]
    grads = {n: p.grad for n, p in m64.named_parameters()}
    n_mod, h = m64.n_modulated, dz.shape[2]
    # a decoder of one modulated layer has no middle weights
    dw_mid = [grads[f"net1.{l}.weight"].t() for l in range(1, n_mod)]
    return {
        "dz": dz, "dW_first": grads["net1.0.weight"].t(),
        "dW_mid": torch.stack(dw_mid) if dw_mid else dz.new_zeros((0, h, h)),
        "dW_head": grads[f"net1.{n_mod}.weight"].t(), "dlatents": lat.grad,
        "dW2": torch.stack([grads[f"net2.{l}.weight"].t() for l in range(n_mod)]),
        "db1": torch.stack([grads[f"net1.{l}.bias"] for l in range(n_mod)])}


def bwd_case(model, device, rows, points, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    c_in, n_lat = model.net1[0].in_features, model.net2[0].in_features
    coords = torch.rand((points, c_in), generator=gen, device=device) * 2 - 1
    latents = torch.randn((rows, n_lat), generator=gen, device=device) * 0.1
    g = torch.randn((rows, points, model.net1[-1].out_features), generator=gen, device=device)
    w_first, w_mid, w_head, _, w2, b1, scale = sd.stack_weights(model, model.w0)
    z = sd.film_table(latents, w2, b1, scale)
    return coords, latents, g, z, (w_first, w_mid, w_head), w2, scale


def bwd_check(model, device, rows, points, seed, chunk: int = 4096) -> float:
    """Training-backward kernel vs plain vs float64 at ``rows x points``,
    every cotangent, and two launches bitwise equal; returns the kernel's
    largest error against float64 (computed ``chunk`` points at a time)."""
    coords, latents, g, z, ops, w2, scale = bwd_case(model, device, rows, points, seed)
    with torch.no_grad():
        kern = sd.decode_bwd(coords, z, g, *ops)
        again = sd.decode_bwd(coords, z, g, *ops)
        plain = sd.decode_bwd_plain(coords, z, g, *ops)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(kern, again))
    kern_u = sd.unfold_bwd(kern, latents, w2, scale)
    plain_u = sd.unfold_bwd(plain, latents, w2, scale)
    del plain
    # the chained cotangents as training takes them: autograd through the
    # train op (backward = the kernel) to the latents, net2 and the biases
    m = copy.deepcopy(model).requires_grad_(True)
    lat = latents.clone().requires_grad_(True)
    out = sd.fused_siren_decode_train(m, coords, lat, m.w0)
    out.backward(g)
    n_mod = m.n_modulated
    kern_u["dlatents"] = lat.grad
    kern_u["dW2"] = torch.stack([m.net2[l].weight.grad.t() for l in range(n_mod)])
    kern_u["db1"] = torch.stack([m.net1[l].bias.grad for l in range(n_mod)])
    truth = f64_train_grads(model, coords, latents, g, chunk=chunk)
    ok = same
    for name, want in truth.items():
        err_k = abs_max(kern_u[name].double() - want)
        err_p = abs_max(plain_u[name].double() - want)
        top = abs_max(want)
        good = err_k <= 2 * err_p + 1e-6 * top and torch.isfinite(kern_u[name]).all().item()
        ok &= good
        log(f"[bwd] {rows}x{points} {name}: |kernel-f64| {err_k:.3e}, |plain-f64| "
            f"{err_p:.3e}, max |f64| {top:.3e} -> {'ok' if good else 'FAIL'}")
    log(f"[bwd] {rows}x{points} two launches bitwise equal: {same}")
    if not ok:
        raise SystemExit("training-backward kernel fails the f64-relative criterion "
                         "or is not deterministic")
    max_abs_err = max(abs_max(kern_u[k].double() - truth[k]) for k in truth)
    del plain_u, kern_u, truth, m, out
    torch.cuda.empty_cache()
    return max_abs_err


# (H, n_mod, pairs) of the reduction's own checks: Case4's chunk (tiles of
# 192 columns), a ragged step on tiles of 128, ragged row and column tiles
# (320 = 2.5 x 128), the widest width
REDUCE_CHECKS = ((384, 16, 65536), (128, 3, 1000), (320, 3, 4100), (3072, 2, 4096))


def reduce_workspace(device, h, n_mod, q, seed):
    """A chunk's workspace as the chain leaves it, from a seed: R (n_mod,
    Qa, H) uniform in [-1, 1) and D normal, Qa = q rounded up to 128 pairs."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qa = -(-q // 128) * 128
    r = torch.rand((n_mod, qa, h), generator=gen, device=device) * 2 - 1
    d = torch.randn((n_mod, qa, h), generator=gen, device=device)
    return r, d, qa


def reduce_launch(r, d, parts, q, qa) -> None:
    """The reduction kernel alone on a workspace, into ``parts``
    (``BWD_SLICES`` partials of dW_mid, added to): a comparison launch,
    counted nowhere."""
    n_mod, _, h = r.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    sd._raise_on(sd._bwd_library().siren_bwd_reduce(
        sd._ptr(r), sd._ptr(d), sd._ptr(parts), parts.shape[1], 0, q, qa, h, n_mod,
        sd.BWD_SLICES, stream), "siren_bwd_reduce launch")


def reduce_products(r, d, q, dtype=torch.float32):
    """sin2pi(R[0:n-1])^T . D[1:n] over the first q pairs as one
    ``torch.bmm`` (float32 with TF32 off, or float64)."""
    s, dd = sd._sin2pi(r[:-1, :q]).to(dtype), d[1:, :q].to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.bmm(s.transpose(1, 2), dd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def reduce_check(device, h, n_mod, q, seed) -> float:
    """The dW_mid reduction kernel alone on a seeded workspace: its slices'
    partials folded in slice order, against ``torch.bmm`` in float32 and
    float64 (the phase 7 criterion), and two launches bitwise equal;
    returns its largest error against float64.  The library's tile width
    must be ``sd.reduce_cols``'s."""
    r, d, qa = reduce_workspace(device, h, n_mod, q, seed)
    runs = []
    for _ in range(2):
        parts = torch.zeros((sd.BWD_SLICES, (n_mod - 1) * h * h), device=device)
        reduce_launch(r, d, parts, q, qa)
        got = parts[0].clone()
        for p in parts[1:]:
            got += p
        runs.append(got.view(n_mod - 1, h, h))
    torch.cuda.synchronize()
    same = torch.equal(*runs)
    plain = reduce_products(r, d, q)
    truth = reduce_products(r, d, q, torch.float64)
    err_k, err_p = abs_max(runs[0].double() - truth), abs_max(plain.double() - truth)
    top = abs_max(truth)
    cols = sd._bwd_library().siren_bwd_reduce_cols(h)
    good = (same and err_k <= 2 * err_p + 1e-6 * top and cols == sd.reduce_cols(h)
            and torch.isfinite(runs[0]).all().item())
    log(f"[reduce] H={h} n_mod={n_mod} Q={q} (tiles 128 x {cols}, the mirror's "
        f"{sd.reduce_cols(h)}): |kernel-f64| {err_k:.3e}, "
        f"|bmm f32-f64| {err_p:.3e}, max |f64| {top:.3e}, two launches bitwise equal: {same} "
        f"-> {'ok' if good else 'FAIL'}")
    if not good:
        raise SystemExit("the dW_mid reduction fails the f64-relative criterion or is not "
                         "deterministic")
    del r, d, runs, plain, truth
    torch.cuda.empty_cache()
    return err_k


def reduce_figures(device, h, n_mod, pairs, profiled_ms, repeats: int = 7) -> dict:
    """The reduction's own row at ``pairs`` pairs, on one chunk's seeded
    workspace, times the chunks: its time (the median of ``repeats``
    launches, CUDA events; ``profiled_ms``, its device time inside the
    backward's profiled call, is printed beside it: the profiler now and
    then drops launches), its bound (the 3xTF32 products and the workspace
    it reads, the sines on the CUDA cores), its plain version's time
    (``decode_bwd_plain``'s sine and product a layer), and the library
    figure: the median of ``repeats`` of one float32 ``torch.bmm`` (TF32
    off) of sin2pi(R[0:n-1])^T . D[1:n], the sines computed before it
    (products only)."""
    q = min(pairs, sd.BWD_PAIRS)
    chunks = pairs / q
    r, d, qa = reduce_workspace(device, h, n_mod, q, seed=0)
    parts = torch.zeros((sd.BWD_SLICES, (n_mod - 1) * h * h), device=device)
    ms = cuda_median(lambda: reduce_launch(r, d, parts, q, qa), 1, repeats)[0] * chunks
    del parts
    s, dd = sd._sin2pi(r[:-1, :q]), d[1:, :q]

    def plain():
        for l in range(n_mod - 1):
            sd._sin2pi(r[l, :q]).t() @ d[l + 1, :q]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = cuda_median(lambda: torch.bmm(s.transpose(1, 2), dd), 1, repeats)[0] * chunks
        del s, dd
        plain_ms = cuda_median(plain, 1, repeats=1)[0] * chunks
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del r, d
    torch.cuda.empty_cache()
    flops = 2 * (n_mod - 1) * h * h * pairs
    nbytes = 4 * (2 * (n_mod - 1) * pairs * h + (n_mod - 1) * h * h)
    bound_ms, bound_by = tc_bound(flops, nbytes, (n_mod - 1) * pairs * h * ACT_FLOPS
                                  / PEAK_F32_FLOPS)
    log(f"[bwd-time] reduce alone: {ms:.3f} ms ({profiled_ms:.3f} ms device as profiled in the "
        f"backward), bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.2f} TFLOP of products "
        f"x {TF32_SPLIT_PRODUCTS} at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {nbytes / 1e9:.2f} GB "
        f"of workspace at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s), {bound_ms / ms:.1%} of it; plain "
        f"{plain_ms:.3f} ms; library torch.bmm float32 (TF32 off, products only) {lib:.3f} ms")
    return dict(ms=ms, profiled_ms=profiled_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib, library_call="torch.bmm float32, TF32 off",
                library_covers="products only")


def phase_bwd(device, results):
    """The training-backward kernel checked at 4 x 262144, the shape the
    training path gives it (every row spans 4 chunks of ``BWD_PAIRS``
    pairs, so a row's dz sums across chunk launches), and at 4 x 16384
    (one chunk holds all four rows); kernel and plain timed at 4 x 262144,
    the kernel as the median of 7 separately timed calls, and the device
    time of each of its kernels from one profiled call."""
    for i, (h, n_mod, q) in enumerate(REDUCE_CHECKS):
        reduce_check(device, h, n_mod, q, seed=60 + i)
    model = case4_decoder(device)
    max_abs_err = bwd_check(model, device, 4, 262144, seed=14)
    bwd_check(model, device, 4, 16384, seed=13)
    bwd_check(h96_decoder(device), device, 4, 3000, seed=16)
    results["siren_decode_bwd"] = dict(bwd_time(model, device, 4, 262144, seed=14),
                                       max_abs_err=max_abs_err)


# bytes of the pre-activations that the plain training backward keeps at
# once: above them it runs over the points in chunks
PLAIN_BWD_BYTES = 30e9


def bwd_time(model, device, rows, points, seed, repeats: int = 7) -> dict:
    """The training backward at ``rows x points``: the median of
    ``repeats`` separately timed calls with the SM clocks around them, the
    plain version's time and peak memory (over chunks of the points when
    its pre-activations would pass ``PLAIN_BWD_BYTES``; the cotangents sum
    over the points), the bound, and each of its kernels' device time from
    one profiled call."""
    coords, latents, g, z, ops, w2, scale = bwd_case(model, device, rows, points, seed)
    n_mod = z.shape[0]
    step = points
    while 4 * n_mod * rows * step * z.shape[2] > PLAIN_BWD_BYTES:
        step = -(-step // 2)

    def plain():
        for lo in range(0, points, step):
            sd.decode_bwd_plain(coords[lo:lo + step], z, g[:, lo:lo + step].contiguous(), *ops)
    with torch.no_grad():
        log(f"[bwd-time] SM clock, max before: {sm_clocks()}")
        ms, least, largest = cuda_median(lambda: sd.decode_bwd(coords, z, g, *ops), 1, repeats)
        log(f"[bwd-time] SM clock, max after: {sm_clocks()}")
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_median(plain, 2 if repeats > 3 else 1, repeats=1)[0]
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    h, c_in, c_out = z.shape[2], coords.shape[1], g.shape[2]
    pairs = rows * points
    # forward recompute, dx chain and dW products (section 3 of the port's
    # plan: 3 x 4.43 MFLOP a pair at Case4), the sine and its derivative
    mat = pairs * (2 * h * (c_in + 3 * (n_mod - 1) * h + 2 * c_out) + 2 * c_in * h)
    act = pairs * (2 * ACT_FLOPS + 3) * h * n_mod
    flops = mat + act
    nbytes = 4 * (points * c_in + 2 * n_mod * rows * h + pairs * c_out + 2 * c_in * h
                  + 2 * (n_mod - 1) * h * h + 2 * h * c_out)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS)
    with torch.no_grad():
        prof = device_profile(f"training backward {rows}x{points}",
                              lambda: sd.decode_bwd(coords, z, g, *ops), top=6)
    # the products each kernel computes (the chain: forward and dx chain)
    products = {"chain": pairs * 4 * (n_mod - 1) * h * h, "reduce": pairs * 2 * (n_mod - 1) * h * h}
    part_ms = {}
    for part in ("chain", "reduce", "sums", "prep", "fold"):
        name = {"prep": PREP_KERNEL, "chain": CHAIN_KERNEL}.get(part, f"siren_bwd_{part}_kernel")
        hits = [v for k, v in prof.items() if name in k]
        dev_ms = part_ms[part] = sum(ms for ms, _ in hits)
        rate = (f", {products[part] / dev_ms / 1e9:.2f} TFLOP/s of products"
                if part in products and dev_ms else "")
        if part == "sums":   # a pass over D of every layer and the last R, bound by bytes
            sums_bytes = 4 * (pairs * h * (n_mod + 1) + points * c_in + pairs * c_out)
            rate = (f", bound {sums_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms (bytes: "
                    f"{sums_bytes / 1e9:.2f} GB of workspace, coordinates and cotangent)")
        log(f"[bwd-time] {part}: {dev_ms:.3f} ms device, {sum(n for _, n in hits)} "
            f"launches{rate}")
    log(f"[bwd-time] {rows}x{points}: {chain_stream(pairs, h, n_mod, part_ms['chain'])}")
    reduce = (reduce_figures(device, h, n_mod, pairs, part_ms["reduce"], repeats)
              if n_mod > 1 else None)
    log(f"[bwd] {rows}x{points} H={h}: kernel {ms:.3f} ms [{least:.3f}-{largest:.3f}] median "
        f"of {repeats} ({flops / ms / 1e9:.2f} TFLOP/s), bound {bound_ms:.3f} ms ({bound_by}, "
        f"{flops / 1e12:.2f} TFLOP; every flop on the CUDA cores: "
        f"{bound(flops, nbytes)[0]:.3f} ms); plain {plain_ms:.3f} ms"
        + (f" over {-(-points // step)} chunks of {step} points" if step < points else "")
        + f" (peak memory {plain_peak:.2f} GiB); library: none (no single PyTorch call "
        f"computes it)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=f"{rows}x{points}", **({"reduce": reduce} if reduce else {}))


def rel_l2(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def phase_op_grads(device, root):
    """The general op's gradient on the card, and one training batch's
    gradients with the fused decode and with the plain decode."""
    model = case4_decoder(device)
    coords, latents, g, *_ = bwd_case(model, device, 4, 4096, seed=15)
    leaves = {}
    for fused in (True, False):
        m = copy.deepcopy(model).requires_grad_(True)
        lat = latents.clone().requires_grad_(True)
        c = coords.clone().requires_grad_(True)
        out = (sd.fused_siren_decode(m, c, lat, m.w0) if fused
               else siren_film_apply(m, c[None], lat[:, None], m.w0))
        out.backward(g)
        leaves[fused] = {"latents": lat.grad, "coords": c.grad,
                         **{n: p.grad for n, p in m.named_parameters()}}
    worst = max(rel_l2(leaves[True][k], leaves[False][k]) for k in leaves[False])
    log(f"[op-grad] general op 4x4096, kernels vs plain autograd: worst leaf rel L2 "
        f"{worst:.3e} over {len(leaves[False])} leaves (tol {GRAD_REL_TOL})")
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("general op gradient disagrees with plain autograd")

    recipe = write_training_case(os.path.join(root, "step"), n_snapshots=8, points=16384)
    grads = {}
    for fused in (True, False):
        hp = cfgmod.basic_input(recipe, use_fused_decode=fused)
        tr = CNFTrainer(hp)
        tr.init_state(seed=0)
        with torch.no_grad():   # a non-zero table, so every latent leaf is live
            tr.state.latents.copy_(0.1 * torch.randn(
                tr.state.latents.shape, generator=torch.Generator().manual_seed(1)))
        sd.reset_launch_counts()
        loss = tr._batch_loss(torch.arange(4, device=device), 0, 0)
        loss.backward()
        torch.cuda.synchronize()
        counts = dict(sd.LAUNCHES)
        if fused and (counts["siren_decode_forward"] == 0 or counts["siren_decode_bwd"] == 0):
            raise SystemExit(f"fused training step launched {counts}")
        grads[fused] = {"latents": tr.state.latents.grad,
                        **{n: p.grad for n, p in tr.model.named_parameters()}}
    worst = max(rel_l2(grads[True][k], grads[False][k]) for k in grads[False])
    log(f"[step-grad] one training batch 4x16384, use_fused_decode true vs false: worst "
        f"leaf rel L2 {worst:.3e} over {len(grads[False])} leaves (tol {GRAD_REL_TOL})")
    if not worst <= GRAD_REL_TOL:
        raise SystemExit("fused training step disagrees with the plain decode")


def write_training_case(root, n_snapshots: int, points: int, epochs: int = 3,
                        channels: int = 3, **nf) -> str:
    """``recipes/cnf/case4.yml`` at full width (its ``NF`` entries
    overridden by ``nf``) on seeded synthetic flow snapshots of ``channels``
    fields (smooth travelling waves on random 3-D points)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(points)
    coords = rng.uniform(size=(points, 3)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(n_snapshots, 1, channels))
    k = rng.normal(size=(3, channels)) * 4
    fois = (np.sin(coords @ k + phase)
            + 0.1 * rng.standard_normal((n_snapshots, points, channels)))
    np.save(os.path.join(root, "output.npy"), fois.astype(np.float32))
    np.save(os.path.join(root, "coords.npy"), coords)
    with open(RECIPE_CNF) as f:
        recipe = yaml.safe_load(f)
    recipe.update(data_path=os.path.join(root, "output.npy"),
                  coor_path=os.path.join(root, "coords.npy"),
                  save_path=os.path.join(root, "run"), epochs=epochs, save_every=2,
                  multiGPU=1)
    recipe["NF"].update(nf)
    path = os.path.join(root, "case4.yml")
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


def phase_train(root):
    """The training CLI at full Case4 width; then a 1-epoch resume."""
    recipe = write_training_case(os.path.join(root, "train"), n_snapshots=8, points=262144)
    hp = cfgmod.basic_input(recipe)
    torch.cuda.reset_peak_memory_stats()
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cnf.main([recipe])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sd.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(hp.save_path, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    epoch_s = [float(r["wait_train_chunk"]) for r in rows if r.get("wait_train_chunk")]
    eval_s = [float(r["wait_eval"]) for r in rows if r.get("wait_eval")]
    n_batches = trainer.N_samples // hp.batch_size
    t1 = time.perf_counter()
    trainer.save(999)
    save_ms = (time.perf_counter() - t1) * 1e3
    os.remove(os.path.join(hp.save_path, "checkpoint_999.pt"))
    log(f"[train] Case4 {trainer.N_samples} snapshots x {trainer.flat_coords.shape[0]} points, "
        f"batch {hp.batch_size}: {len(losses)} epochs, losses {[round(x, 6) for x in losses]}, "
        f"CLI wall {wall:.1f} s, peak memory {peak:.2f} GiB; launches {counts}")
    log(f"[train] ms per batch step {np.mean(epoch_s[1:]) * 1e3 / n_batches:.1f} (first "
        f"epoch {epoch_s[0] * 1e3 / n_batches:.1f}), eval {np.mean(eval_s) * 1e3:.1f} ms "
        f"({trainer.N_samples} rows), checkpoint {save_ms:.1f} ms")
    if not (losses and all(np.isfinite(losses))):
        raise SystemExit(f"training losses not finite: {losses}")
    # one more batch step of the real epoch loop (with the decoder step of
    # an epoch > 0), in memory only: the checkpoints on disk stay as written
    device_profile("one training batch step (Case4, 4 x 262144)",
                   lambda: trainer._run_epoch(np.arange(hp.batch_size)[None], 1, False))
    missing = [k for k in ("siren_decode_forward", "siren_decode_bwd") if counts[k] == 0]
    if missing:
        raise SystemExit(f"training ran without launching {missing}")

    hp_resume = cfgmod.basic_input(recipe, epochs=1)
    with open(recipe, "w") as f:
        yaml.safe_dump(hp_resume.to_dict(), f)
    sd.reset_launch_counts()
    resumed = train_cnf.main([recipe])
    torch.cuda.synchronize()
    for k, v in sd.LAUNCHES.items():
        counts[k] += v
    with open(os.path.join(hp.save_path, "progress.csv")) as f:
        first_epoch = int(next(csv.DictReader(f))["epoch"])
    log(f"[train] resume: first epoch {first_epoch}, final epoch {resumed.state.epoch}, "
        f"launches {dict(sd.LAUNCHES)}")
    if first_epoch != trainer.state.epoch or resumed.state.epoch != trainer.state.epoch:
        raise SystemExit("the resumed run did not continue the epoch count")

    newest = os.path.join(hp.save_path, f"checkpoint_{resumed.state.epoch}.pt")
    cnf_yml = os.path.join(root, "train", "cnf.yml")
    with open(cnf_yml, "w") as f:
        yaml.safe_dump({k: hp.to_dict()[k] for k in ("dims", "hidden_size", "NF")}, f)
    inf = CNF_inference(newest, cnf_yml)
    # Case4's lumped normalizer is per mesh point: decode the whole mesh
    pred = inf.predict(resumed.train_coord, [0, 1], batch_size=2)
    want = resumed.infer(resumed.train_coord, resumed.state.latents[:2]).cpu().numpy()
    rel = float(np.linalg.norm(pred - want) / np.linalg.norm(want))
    log(f"[train] {os.path.basename(newest)} through CNF_inference: {pred.shape}, rel L2 "
        f"vs the trainer's own decode {rel:.3e}")
    if not (np.isfinite(pred).all() and rel <= GRAD_REL_TOL):
        raise SystemExit("the trainer's checkpoint does not load through CNF_inference")
    return counts


# ---------------------------------------------------------------------------
# flash attention: the kernels, the U-Net route, diffusion training
# ---------------------------------------------------------------------------

def f64_attention(q, k, v, g):
    """Float64 forward and backward of softmax attention, one head at a
    time: ``{"out", "lse", "dq", "dk", "dv"}``."""
    scale = 1.0 / q.shape[-1] ** 0.5
    res = {n: [] for n in ("out", "lse", "dq", "dk", "dv")}
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (t[b].double() for t in (q, k, v, g))
        s = qb @ kb.t() * scale
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[:, None])
        out = p @ vb
        ds = p * (gb @ vb.t() - (gb * out).sum(-1, keepdim=True))
        for name, val in (("out", out), ("lse", lse), ("dq", ds @ kb * scale),
                          ("dk", ds.t() @ qb * scale), ("dv", p.t() @ gb)):
            res[name].append(val)
        del s, p, ds
    return {n: torch.stack(v) for n, v in res.items()}


def flash_case(device, bh, n, d, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((bh, n, d), generator=gen, device=device).to(dtype) for _ in range(4)]


def flash_check(device, bh, n, d, dtype) -> dict:
    """Kernels vs plain vs float64 on every output, two launches bitwise
    equal; returns the kernels' largest errors against float64."""
    q, k, v, g = flash_case(device, bh, n, d, dtype, seed=bh + n)
    out, lse = fa.flash_forward(q, k, v)
    kern = dict(zip(("dq", "dk", "dv"), fa.flash_backward(q, k, v, out, lse, g)),
                out=out, lse=lse)
    out2, lse2 = fa.flash_forward(q, k, v)
    again = (out2, lse2, *fa.flash_backward(q, k, v, out2, lse2, g))
    same = all(torch.equal(a, kern[n]) for a, n in zip(again, ("out", "lse", "dq", "dk", "dv")))
    del again, out2, lse2
    p_out, p_lse = fa.flash_forward_plain(q, k, v)
    plain = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(q, k, v, p_out, p_lse, g)),
                 out=p_out, lse=p_lse)
    truth = f64_attention(q, k, v, g)
    torch.cuda.synchronize()
    ok, errs = same, {}
    for name, want in truth.items():
        err_k = (kern[name].double() - want).abs().max().item()
        err_p = (plain[name].double() - want).abs().max().item()
        top = want.abs().max().item()
        limit = 2 * err_p + 1e-6 * top
        good = err_k <= limit and torch.isfinite(kern[name]).all().item()
        ok &= good
        errs[name] = err_k
        log(f"[flash] ({bh}, {n}, {d}) {str(dtype)[6:]} {name}: |kernel-f64| {err_k:.3e}, "
            f"|plain-f64| {err_p:.3e}, max |f64| {top:.3e}, error / limit "
            f"{err_k / limit:.3f} -> {'ok' if good else 'FAIL'}")
    log(f"[flash] ({bh}, {n}, {d}) {str(dtype)[6:]} two launches bitwise equal: {same}")
    if not ok:
        raise SystemExit("flash kernels fail the f64-relative criterion or are not "
                         "deterministic")
    del kern, plain, truth
    torch.cuda.empty_cache()
    return errs


def flash_memory(device) -> None:
    """Forward + backward through the kernels at (4, 16384, 64): the peak
    above inputs and outputs is O(N), not the (BH, N, N) weights."""
    q, k, v, g = flash_case(device, 4, 16384, 64, torch.float32, seed=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, lse = fa.flash_forward(q, k, v)
    grads = fa.flash_backward(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    outputs = sum(t.numel() * t.element_size() for t in (out, lse, *grads))
    extra = (torch.cuda.max_memory_allocated() - base - outputs) / 2**20
    dense = 4 * 16384 * 16384 * 4 / 2**30
    log(f"[flash] (4, 16384, 64) forward + backward: {extra:.2f} MiB above inputs and "
        f"outputs (limit 64 MiB; one dense (BH, N, N) f32 tensor is {dense:.2f} GiB)")
    if not extra < 64:
        raise SystemExit("flash forward + backward is not O(N) in memory")


def flash_bounds(bh, n, d, dtype=torch.float32) -> dict:
    """Per function ``(tensor-core ms, bound_by, CUDA-core f32 ms)`` from its
    flops, its exponentials and the bytes of its inputs and outputs in
    ``dtype``; the products at the 3xTF32 rate (float32) or the dense bf16
    rate, like ``forward_bound``; on the CUDA cores an exponential counts as
    one operation."""
    mat, rows, exps = bh * n * n * d, bh * n, bh * n * n
    io = torch.empty((), dtype=dtype).element_size() * bh * n * d
    rate = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
            else PEAK_TF32_FLOPS / TF32_SPLIT_PRODUCTS)
    work = {"flash_forward": (4 * mat, 3 * io + io + 4 * rows, exps),
            "flash_bwd_dq": (6 * mat, 4 * io + 8 * rows + io, exps),
            "flash_bwd_dkv": (8 * mat, 4 * io + 8 * rows + 2 * io, exps),
            "backward": (10 * mat, 5 * io + 4 * rows + 3 * io, exps),
            "bwd_pair": (14 * mat, 8 * io + 16 * rows + 3 * io, 2 * exps)}
    return {name: (*tc_bound(flops, nbytes, e / PEAK_EXP_PER_S, rate=rate),
                   bound(flops + e, nbytes)[0])
            for name, (flops, nbytes, e) in work.items()}


def sdpa_kernels(device, bh, n, d) -> None:
    """The CUDA kernels that scaled_dot_product_attention's float32 forward
    and backward launch (which backend, which precision), by name, on the
    kernels' (BH, N, D) layout and on its (1, BH, N, D) view."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in ((bh, n, d), (1, bh, n, d)):
        leaves = [t.reshape(shape).requires_grad_(True)
                  for t in flash_case(device, bh, n, d, torch.float32, 7)[:3]]
        out = sdpa(*leaves)
        torch.autograd.grad(out, leaves, torch.ones_like(out), retain_graph=True)   # warm-up
        torch.cuda.synchronize()
        for label, fn in (("forward", lambda: sdpa(*leaves)),
                          ("backward", lambda: torch.autograd.grad(
                              out, leaves, torch.ones_like(out), retain_graph=True))):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
            log(f"[flash-sdpa] {shape} f32 {label} kernels: {names}")
        del leaves, out


def flash_times(device, bh, n, d) -> dict:
    """Kernels, plain versions and scaled_dot_product_attention at one shape,
    each the median of 7 separately timed repeats (CUDA events, after a
    warm-up); every time in ms, and under ``spread`` each one's least and
    largest repeat."""
    q, k, v, g = flash_case(device, bh, n, d, torch.float32, seed=7)
    out, lse = fa.flash_forward(q, k, v)
    delta = (g * out).sum(-1).contiguous()
    calls = 20 if n < 1000 else 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(*leaves), leaves, g)
    graph = sdpa(*leaves)   # retained: its backward alone is timed
    # the same call on the (1, BH, N, D) view, which takes another backend
    leaves4 = [t.detach().reshape(1, bh, n, d).requires_grad_(True) for t in leaves]
    graph4 = sdpa(*leaves4)
    fns = {
        "flash_forward": lambda: fa.flash_forward(q, k, v),
        "flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, g, lse, delta),
        "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, g, lse, delta),
        "fwd_bwd": lambda: fa.flash_backward(q, k, v, *fa.flash_forward(q, k, v), g),
        "plain_forward": lambda: fa.flash_forward_plain(q, k, v),
        "plain_fwd_bwd": lambda: fa.flash_backward_plain(
            q, k, v, *fa.flash_forward_plain(q, k, v), g),
        "sdpa_forward": lambda: sdpa(q, k, v),
        "sdpa_fwd_bwd": sdpa_fwd_bwd,
        "sdpa_backward": lambda: torch.autograd.grad(graph, leaves, g, retain_graph=True),
        "sdpa_4d_forward": lambda: sdpa(*leaves4),
        "sdpa_4d_backward": lambda: torch.autograd.grad(
            graph4, leaves4, g.reshape(1, bh, n, d), retain_graph=True)}
    t, spread = {}, {}
    for name, fn in fns.items():
        t[name], *spread[name] = cuda_median(fn, calls)
    t["plain_backward"] = t["plain_fwd_bwd"] - t["plain_forward"]
    t["bwd_pair"] = t["flash_bwd_dq"] + t["flash_bwd_dkv"]
    if calls > 1:   # the host's launch rate bounds the events here: device time too
        for name in ("flash_forward", "sdpa_4d_forward"):
            kernels = device_profile(f"{name} ({bh}, {n}, {d}), {calls} calls",
                                     lambda: [fns[name]() for _ in range(calls)], top=3)
            t[f"{name}_device"] = sum(ms for ms, _ in kernels.values()) / calls

    def ms(name):
        return f"{t[name]:.3f} [{spread[name][0]:.3f}-{spread[name][1]:.3f}]"
    b = flash_bounds(bh, n, d)
    log(f"[flash-time] ({bh}, {n}, {d}) f32, ms as median [least-largest] of 7: forward "
        f"kernel {ms('flash_forward')} (bound {b['flash_forward'][0]:.3f} tensor cores, "
        f"{b['flash_forward'][2]:.3f} f32; "
        f"{4 * bh * n * n * d / t['flash_forward'] / 1e9:.2f} TFLOP/s), plain "
        f"{ms('plain_forward')}, sdpa {ms('sdpa_forward')} ((1, BH, N, D) view "
        f"{ms('sdpa_4d_forward')})" + (
            f"; device time a call (torch.profiler): forward kernel "
            f"{t['flash_forward_device']:.4f}, sdpa view {t['sdpa_4d_forward_device']:.4f}"
            if calls > 1 else ""))
    log(f"[flash-time] ({bh}, {n}, {d}) f32: dq kernel {ms('flash_bwd_dq')} (bound "
        f"{b['flash_bwd_dq'][0]:.3f} tensor cores, {b['flash_bwd_dq'][2]:.3f} f32), dk/dv "
        f"kernel {ms('flash_bwd_dkv')} (bound {b['flash_bwd_dkv'][0]:.3f}, "
        f"{b['flash_bwd_dkv'][2]:.3f}); pair {t['bwd_pair']:.3f} ms "
        f"({14 * bh * n * n * d / t['bwd_pair'] / 1e9:.2f} TFLOP/s), sdpa backward alone "
        f"{ms('sdpa_backward')} ((1, BH, N, D) view {ms('sdpa_4d_backward')})")
    log(f"[flash-time] ({bh}, {n}, {d}) f32: forward + backward: kernels {ms('fwd_bwd')} "
        f"(bound {b['flash_forward'][0] + b['backward'][0]:.3f}), plain "
        f"{ms('plain_fwd_bwd')}, sdpa {ms('sdpa_fwd_bwd')}")
    del leaves, graph, leaves4, graph4
    torch.cuda.empty_cache()
    return dict(t, bounds=b, spread=spread)


def forward_bound(bh, n, d, dtype) -> tuple[float, str]:
    """The forward's bound (ms, what bounds it): its products at the 3xTF32
    rate (float32) or the dense bf16 rate, its exponentials, and the bytes
    of q, k, v, out and lse."""
    size = torch.empty((), dtype=dtype).element_size()
    rate = (PEAK_BF16_FLOPS if dtype == torch.bfloat16
            else PEAK_TF32_FLOPS / TF32_SPLIT_PRODUCTS)
    return tc_bound(4 * bh * n * n * d, 4 * bh * n * d * size + 4 * bh * n,
                    bh * n * n / PEAK_EXP_PER_S, rate=rate)


def forward_times(device, bh, n, d, dtype) -> dict:
    """The forward kernel as called, its plain version and
    scaled_dot_product_attention on the same tensors, on their (BH, N, D)
    layout and their (1, BH, N, D) view, each the median of 7 separately
    timed runs of back-to-back calls (20 below 1000 tokens, where the host's
    launch rate bounds them) with their least and largest: ms a call."""
    q, k, v, _ = flash_case(device, bh, n, d, dtype, seed=11)
    q4, k4, v4 = (t.reshape(1, bh, n, d) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = 20 if n < 1000 else 1
    fns = {"kernel": lambda: fa.flash_forward(q, k, v),
           "sdpa": lambda: sdpa(q, k, v), "sdpa_4d": lambda: sdpa(q4, k4, v4),
           "plain": lambda: fa.flash_forward_plain(q, k, v)}
    t = {name: cuda_median(fn, calls) for name, fn in fns.items()}
    b_ms, b_by = forward_bound(bh, n, d, dtype)
    device_ms = None
    if calls > 1 and d > 128:   # the events time the host there: the device time too
        kernels = device_profile(f"flash forward ({bh}, {n}, {d}) {str(dtype)[6:]}, {calls} "
                                 f"calls", lambda: [fns["kernel"]() for _ in range(calls)],
                                 top=2)
        device_ms = sum(ms for name, (ms, _) in kernels.items() if "flash_fwd" in name) / calls

    def ms(name):
        return f"{t[name][0]:.4f} [{t[name][1]:.4f}-{t[name][2]:.4f}]"
    lib = min(t["sdpa"][0], t["sdpa_4d"][0])
    log(f"[flash-fwd] ({bh}, {n}, {d}) {str(dtype)[6:]}, ms as median [least-largest] of 7 "
        f"({calls} calls each): forward kernel {ms('kernel')} (bound {b_ms:.4f}, {b_by}; "
        f"{4 * bh * n * n * d / t['kernel'][0] / 1e9:.1f} TFLOP/s), plain {ms('plain')}, "
        f"sdpa {ms('sdpa')} ((1, BH, N, D) view {ms('sdpa_4d')}): the kernel "
        f"{'beats' if t['kernel'][0] < lib else 'does not beat'} SDPA's faster layout"
        + (f"; device time a call (torch.profiler): {device_ms:.4f}" if device_ms else ""))
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    return dict(t, bound=(b_ms, b_by), device_ms=device_ms)


def backward_times(device, bh, n, d, dtype) -> dict:
    """The backward kernels alone and as called (``flash_backward``: delta,
    then both), the plain backward and scaled_dot_product_attention's
    backward alone on both layouts, on the same tensors, each the median of
    7 separately timed runs of back-to-back calls (20 below 1000 tokens,
    where the host's launch rate bounds them) with their least and largest:
    ms a call; below 1000 tokens also the pair's device time a call
    (torch.profiler)."""
    q, k, v, g = flash_case(device, bh, n, d, dtype, seed=13)
    out, lse = fa.flash_forward(q, k, v)
    delta = fa._delta(out, g)
    calls = 20 if n < 1000 else 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    leaves4 = [t.detach().reshape(1, bh, n, d).requires_grad_(True) for t in leaves]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    graph, graph4 = sdpa(*leaves), sdpa(*leaves4)   # retained: the backward alone is timed
    fns = {"flash_bwd_dq": lambda: fa.bwd_dq(q, k, v, g, lse, delta),
           "flash_bwd_dkv": lambda: fa.bwd_dkv(q, k, v, g, lse, delta),
           "backward": lambda: fa.flash_backward(q, k, v, out, lse, g),
           "plain": lambda: fa.flash_backward_plain(q, k, v, out, lse, g),
           "sdpa_backward": lambda: torch.autograd.grad(graph, leaves, g, retain_graph=True),
           "sdpa_4d_backward": lambda: torch.autograd.grad(
               graph4, leaves4, g.reshape(1, bh, n, d), retain_graph=True)}
    t = {name: cuda_median(fn, calls) for name, fn in fns.items()}
    pair = t["flash_bwd_dq"][0] + t["flash_bwd_dkv"][0]
    b = flash_bounds(bh, n, d, dtype)
    device_ms = None
    if calls > 1:
        kernels = device_profile(f"flash backward ({bh}, {n}, {d}) {str(dtype)[6:]}, {calls} "
                                 f"calls", lambda: [fns["backward"]() for _ in range(calls)],
                                 top=4)
        device_ms = {name: ms / calls for name, (ms, _) in kernels.items()
                     if "flash_bwd" in name}

    def ms(name):
        return f"{t[name][0]:.4f} [{t[name][1]:.4f}-{t[name][2]:.4f}]"
    lib = min(t["sdpa_backward"][0], t["sdpa_4d_backward"][0])
    log(f"[flash-bwd] ({bh}, {n}, {d}) {str(dtype)[6:]}, ms as median [least-largest] of 7 "
        f"({calls} calls each): dq kernel {ms('flash_bwd_dq')} (bound "
        f"{b['flash_bwd_dq'][0]:.4f}, {b['flash_bwd_dq'][1]}), dk/dv kernel "
        f"{ms('flash_bwd_dkv')} (bound {b['flash_bwd_dkv'][0]:.4f}); pair {pair:.4f} (bound "
        f"{b['bwd_pair'][0]:.4f}; {14 * bh * n * n * d / pair / 1e9:.1f} TFLOP/s), as called "
        f"{ms('backward')}, plain {ms('plain')}, sdpa backward {ms('sdpa_backward')} ((1, BH, "
        f"N, D) view {ms('sdpa_4d_backward')}): the pair "
        f"{'beats' if pair < lib else 'does not beat'} SDPA's faster layout"
        + (f"; device time a call (torch.profiler): {device_ms}" if device_ms else ""))
    del leaves, leaves4, graph, graph4, q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return dict(t, bounds={k: b[k][:2] for k in ("flash_bwd_dq", "flash_bwd_dkv", "bwd_pair")},
                device_ms=device_ms)


def forward_host_us(device, bh=64, n=144, d=64, calls=200) -> dict:
    """Host microseconds a call at (64, 144, 64) float32 (time.perf_counter
    over ``calls`` calls with no synchronisation between them, median of 5
    runs), of the forward as called and of its parts: the wrapper behind
    the CPU / padding dispatch (``_launch_forward``), its two output
    allocations alone, and the library call alone on ready arguments (which
    launches the kernel); beside scaled_dot_product_attention's."""
    q, k, v, _ = flash_case(device, bh, n, d, torch.float32, seed=12)
    out, lse = torch.empty_like(q), torch.empty((bh, n), device=device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = fa._library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, n, d,
            0, 1.0 / d ** 0.5, fa._stream(q.get_device()))
    parts = {"flash_forward": lambda: fa.flash_forward(q, k, v),
             "_launch_forward": lambda: fa._launch_forward(q, k, v, None),
             "allocations": lambda: (torch.empty_like(q), q.new_empty((bh, n))),
             "library call": lambda: lib.flash_forward(*args),
             "sdpa": lambda: sdpa(q, k, v)}
    us = {}
    for name, fn in parts.items():
        runs = []
        for _ in range(5):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        us[name] = sorted(runs)[2]
    log(f"[flash-host] ({bh}, {n}, {d}) f32, host us a call (perf_counter over {calls} "
        f"unsynchronised calls, median of 5): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    return us


def wide_factors(d: int, dtype=torch.float32) -> tuple[float, float]:
    """The kernels' products above 128 over the least that attention
    needs, forward and backward pair: the forward's d / c groups of c
    output columns (``fa.forward_columns``: 128, and in bf16 the TMA
    forward's 256 where they divide d) each compute S over the whole head,
    and their own c columns of P V: (d / c + 1) / 2; the backward's
    ``fa.backward_products`` (the pairs at 256, 384 and 512, their dk/dv
    split by output: (5 g + 3) / 7; column groups above: (8 g + 6) /
    14)."""
    groups = d // fa.forward_columns(d, dtype)
    return (groups + 1) / 2, fa.backward_products(d, dtype)


def phase_flash(device, results) -> None:
    errs = {}
    for bh, n, d, dtype in FLASH_CHECKS:
        errs[(bh, n, d, dtype)] = flash_check(device, bh, n, d, dtype)
    flash_memory(device)
    sdpa_kernels(device, *FLASH_TIMES[1])
    path = errs[(64, 144, 64, torch.float32)]
    log(f"[flash-time] SM clock, max SM clock before the timings: {sm_clocks()}")
    times = {f"{bh}x{n}x{d}": flash_times(device, bh, n, d) for bh, n, d in FLASH_TIMES}
    # the forward alone: bf16 at the same shapes, float32 at the classifier's
    fwd_times = {f"{bh}x{n}x{d} {str(dtype)[6:]}": forward_times(device, bh, n, d, dtype)
                 for (bh, n, d), dtype in [(s, torch.bfloat16) for s in FLASH_TIMES]
                 + [(s, torch.float32) for s in FLASH_CLASSIFIER_SHAPES]}
    host = forward_host_us(device)
    # the backward pair: its device time at 144 tokens in float32, bf16 at the
    # same shapes, float32 at the classifier's
    bwd_times = {f"{bh}x{n}x{d} {str(dtype)[6:]}": backward_times(device, bh, n, d, dtype)
                 for (bh, n, d), dtype in [(FLASH_TIMES[0], torch.float32)]
                 + [(s, torch.bfloat16) for s in FLASH_TIMES]
                 + [(s, torch.float32) for s in FLASH_CLASSIFIER_SHAPES]}
    # above 128 at the slice's shape and the xl
    # recipe's under num_heads 1, both types: the forward and the backward
    # pair beside their plain versions, SDPA and their bounds
    wide_t = {(tag, dtype): (forward_times(device, *shape, dtype),
                             backward_times(device, *shape, dtype))
              for tag, shape in FLASH_WIDE_TIMES.items()
              for dtype in (torch.float32, torch.bfloat16)}
    # the forward alone at many tokens and 512 channels, and the float32
    # backward pair there
    wide_fwd = {(tag, dtype): forward_times(device, *shape, dtype)
                for tag, shape in FLASH_WIDE_FWD_TIMES.items()
                for dtype in (torch.float32, torch.bfloat16)}
    wide_bwd = {tag: backward_times(device, *shape, torch.float32)
                for tag, shape in FLASH_WIDE_BWD_TIMES.items()}
    for tag, (bh, n, d) in {**FLASH_WIDE_TIMES, **FLASH_WIDE_FWD_TIMES}.items():
        for dtype in (torch.float32, torch.bfloat16):
            log(f"[flash-wide] ({bh}, {n}, {d}) {str(dtype)[6:]}: the forward's products are "
                f"{wide_factors(d, dtype)[0]:.2f}x the least ({d // fa.forward_columns(d, dtype)}"
                f" groups of {fa.forward_columns(d, dtype)} columns each compute S over the "
                f"head), the backward pair's {wide_factors(d, dtype)[1]:.2f}x ("
                f"{d // fa.backward_columns(d, dtype)} groups of "
                f"{fa.backward_columns(d, dtype)} columns each compute S and dP"
                + (", dk/dv split by output" if d in fa.TMA_WIDTHS else "") + ")")
    log(f"[flash-time] SM clock, max SM clock after the timings: {sm_clocks()}")
    log("[flash-fwd] " + json.dumps(dict(fwd_times, host_us=host)))
    log("[flash-bwd] " + json.dumps(bwd_times))
    log("[flash-time] " + json.dumps({s: {k: v for k, v in t.items() if k != "bounds"}
                                      for s, t in times.items()}))
    t = times[FLASH_PATH_SHAPE]
    fwd, lib = t["flash_forward"], min(t["sdpa_forward"], t["sdpa_4d_forward"])
    log(f"[flash-time] {FLASH_PATH_SHAPE} forward as called, event median {fwd:.4f} ms against "
        f"SDPA's faster layout {lib:.4f}: {'beats' if fwd < lib else 'does not beat'} it")
    pair = "flash_bwd_dq + flash_bwd_dkv"
    for name, err, plain, step, covers in (
            ("flash_forward", max(path["out"], path["lse"]), t["plain_forward"], "forward",
             "flash_forward"),
            ("flash_bwd_dq", path["dq"], t["plain_backward"], "backward", pair),
            ("flash_bwd_dkv", max(path["dk"], path["dv"]), t["plain_backward"], "backward",
             pair)):
        # the faster of SDPA's two layouts, which take different backends
        lib, layout = min((t[f"sdpa_{step}"], "(BH, N, D)"),
                          (t[f"sdpa_4d_{step}"], "(1, BH, N, D)"))
        results[name] = dict(max_abs_err=err, ms=t[name], plain_ms=plain,
                             bound_ms=t["bounds"][name][0], bound_by=t["bounds"][name][1],
                             library_ms=lib, library_call=f"scaled_dot_product_attention "
                             f"{step} on {layout}", library_covers=covers,
                             shape=FLASH_PATH_SHAPE)
    # the forward's rows above 128 in bf16 (the TMA forward) and at many
    # tokens and 512 channels in both types: errors from the checks at the
    # same width
    fwd_rows = {(tag, dtype): wide_fwd[(tag, dtype)]
                for tag, dtype in wide_fwd}
    fwd_rows.update({(tag, torch.bfloat16): wide_t[(tag, torch.bfloat16)][0]
                     for tag in FLASH_WIDE_TIMES})
    for (tag, dtype), fw in fwd_rows.items():
        bh, n, d = {**FLASH_WIDE_TIMES, **FLASH_WIDE_FWD_TIMES}[tag]
        check = errs[(8, 144, 512, dtype) if d == 512 else (2, 300, d, dtype)]
        lib, call = min((fw["sdpa"][0], "forward on (BH, N, D)"),
                        (fw["sdpa_4d"][0], "forward on (1, BH, N, D)"))
        name = "flash_forward" + ("_bf16" if dtype == torch.bfloat16 else "")
        results[name + tag] = dict(
            max_abs_err=max(check["out"], check["lse"]), ms=fw["kernel"][0],
            plain_ms=fw["plain"][0], bound_ms=fw["bound"][0], bound_by=fw["bound"][1],
            library_ms=lib, library_call=f"scaled_dot_product_attention {call}",
            library_covers="flash_forward", shape=f"{bh}x{n}x{d}",
            recompute=wide_factors(d, dtype)[0])
    # the rows above 128, float32: errors from the checks at the same width
    # (the backward alone at many tokens and 512 channels: those at 512)
    for tag, (bh, n, d) in FLASH_WIDE_BWD_TIMES.items():
        bw, check = wide_bwd[tag], errs[(8, 144, 512, torch.float32)]
        lib, call = min((bw["sdpa_backward"][0], "backward on (BH, N, D)"),
                        (bw["sdpa_4d_backward"][0], "backward on (1, BH, N, D)"))
        for name, err in (("flash_bwd_dq", check["dq"]),
                          ("flash_bwd_dkv", max(check["dk"], check["dv"]))):
            bnd = bw["bounds"][name]
            results[name + tag] = dict(
                max_abs_err=err, ms=bw[name][0], plain_ms=bw["plain"][0], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib,
                library_call=f"scaled_dot_product_attention {call}", library_covers=pair,
                shape=f"{bh}x{n}x{d}", recompute=wide_factors(d)[1])
    for tag, (bh, n, d) in FLASH_WIDE_TIMES.items():
        fw, bw = wide_t[(tag, torch.float32)]
        check = errs[(8, 144, 512, torch.float32) if d == 512 else (2, 300, 256, torch.float32)]
        fwd_lib = min((fw["sdpa"][0], "forward on (BH, N, D)"),
                      (fw["sdpa_4d"][0], "forward on (1, BH, N, D)"))
        bwd_lib = min((bw["sdpa_backward"][0], "backward on (BH, N, D)"),
                      (bw["sdpa_4d_backward"][0], "backward on (1, BH, N, D)"))
        for name, err, ms, plain, bnd, (lib, call), covers, factor in (
                ("flash_forward", max(check["out"], check["lse"]), fw["kernel"][0],
                 fw["plain"][0], fw["bound"], fwd_lib, "flash_forward", wide_factors(d)[0]),
                ("flash_bwd_dq", check["dq"], bw["flash_bwd_dq"][0], bw["plain"][0],
                 bw["bounds"]["flash_bwd_dq"], bwd_lib, pair, wide_factors(d)[1]),
                ("flash_bwd_dkv", max(check["dk"], check["dv"]), bw["flash_bwd_dkv"][0],
                 bw["plain"][0], bw["bounds"]["flash_bwd_dkv"], bwd_lib, pair,
                 wide_factors(d)[1])):
            results[name + tag] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=lib, library_call=f"scaled_dot_product_attention {call}",
                library_covers=covers, shape=f"{bh}x{n}x{d}", recompute=factor)
    # the backward rows above 128 in bf16 (the TMA pair at 256 and 512):
    # errors from the bf16 checks at the same width
    for tag, (bh, n, d) in FLASH_WIDE_TIMES.items():
        bw = wide_t[(tag, torch.bfloat16)][1]
        check = errs[(8, 144, 512, torch.bfloat16) if d == 512
                     else (2, 300, 256, torch.bfloat16)]
        lib, call = min((bw["sdpa_backward"][0], "backward on (BH, N, D)"),
                        (bw["sdpa_4d_backward"][0], "backward on (1, BH, N, D)"))
        for name, err in (("flash_bwd_dq", check["dq"]),
                          ("flash_bwd_dkv", max(check["dk"], check["dv"]))):
            bnd = bw["bounds"][name]
            results[f"{name}_bf16{tag}"] = dict(
                max_abs_err=err, ms=bw[name][0], plain_ms=bw["plain"][0], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=lib,
                library_call=f"scaled_dot_product_attention {call}", library_covers=pair,
                shape=f"{bh}x{n}x{d}", recompute=wide_factors(d, torch.bfloat16)[1])


CASE4_UNET = {k: CASE4_RECIPE[k] for k in (
    "image_size", "num_channels", "num_res_blocks", "num_heads", "num_head_channels",
    "attention_resolutions", "channel_mult")}


def phase_unet_flash(root, device) -> None:
    """One training_losses forward and backward of the full-width Case4
    U-Net at batch 8 with flash attention on and off: same weights, t and
    noise."""
    state = torch.load(write_assets(root, 10)["ema_path"], weights_only=True)
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine")
    gen = torch.Generator(device=device).manual_seed(21)
    x0 = torch.rand((8, 1, 384, 384), generator=gen, device=device) * 2 - 1
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([3, 120, 250, 400, 555, 700, 850, 999])
    res = {}
    for flash in (True, False):
        model = tunet.create_model(**CASE4_UNET, use_flash_attention=flash)
        model.load_state_dict(state)
        model.to(device)
        fa.reset_launch_counts()
        loss = diffusion.training_losses(model, x0, t, noise=noise)["loss"]
        loss.mean().backward()
        torch.cuda.synchronize()
        counts = dict(fa.LAUNCHES)
        res[flash] = (loss.detach(), {n: p.grad for n, p in model.named_parameters()})
        log(f"[unet-flash] use_flash_attention={flash}: loss mean {loss.mean().item():.6f}, "
            f"launches {counts}")
        if not (all(v > 0 for v in counts.values()) if flash else not any(counts.values())):
            raise SystemExit(f"flash route launches wrong for use_flash_attention={flash}")
        del model, loss
    loss_rel = rel_l2(res[True][0], res[False][0])
    worst = max((rel_l2(res[True][1][n], res[False][1][n]), n) for n in res[False][1])
    log(f"[unet-flash] Case4 U-Net batch 8, flash vs dense: loss rel L2 {loss_rel:.3e}, worst "
        f"gradient rel L2 {worst[0]:.3e} ({worst[1]}) over {len(res[False][1])} parameters "
        f"(tol {GRAD_REL_TOL})")
    if not (loss_rel <= GRAD_REL_TOL and worst[0] <= GRAD_REL_TOL):
        raise SystemExit("the U-Net's flash route disagrees with the dense route")
    del res
    torch.cuda.empty_cache()


def write_diffusion_case(root, n_train=32, n_valid=8, recipe_path=RECIPE_DIFFUSION,
                         **over) -> dict:
    """A diffusion recipe (``recipes/diffusion/case4.yml`` by default) as
    published, with flash attention on unless ``over`` says otherwise, on
    seeded synthetic latent images of its image size; cut to 3 steps, a
    save every 2, a log line every step; ``over`` updates the recipe."""
    os.makedirs(root, exist_ok=True)
    with open(recipe_path) as f:
        recipe = yaml.safe_load(f)
    size = recipe["image_size"]
    rng = np.random.default_rng(size)
    for name, n in (("train", n_train), ("valid", n_valid)):
        base = np.sin(np.linspace(0, 8 * np.pi, size))[None, :, None] * rng.uniform(
            0.5, 1.5, size=(n, 1, 1))
        np.save(os.path.join(root, f"{name}.npy"),
                (base + 0.1 * rng.standard_normal((n, size, size))).astype(np.float32))
    recipe.update({"use_flash_attention": True, "lr_anneal_steps": 3, "save_interval": 2,
                   "log_interval": 1, "log_path": os.path.join(root, "logs"),
                   "train_data_path": os.path.join(root, "train.npy"),
                   "valid_data_path": os.path.join(root, "valid.npy"), **over})
    return recipe


def timed_steps(loop, batches) -> list[float]:
    """Synchronized wall ms of one ``run_step`` (train + validation forward)
    per batch, in memory only (the files on disk stay as written)."""
    step_ms = []
    for batch in batches:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop.run_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    return step_ms


def _write_yaml(path, recipe) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


def phase_train_diffusion(root, figures) -> tuple[dict, str]:
    """The diffusion training CLI at full Case4 width, then a resume; returns
    the launch counts and the newest EMA file, and puts the ms per step and
    the peak memory into ``figures``."""
    recipe = write_diffusion_case(os.path.join(root, "diffusion"))
    logs = recipe["log_path"]
    path = _write_yaml(os.path.join(root, "diffusion", "case4.yml"), recipe)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loop = train_diffusion.main([path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(logs, "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    valid = [float(r["valid_mse"]) for r in rows]
    files = sorted(os.listdir(logs))
    log(f"[train-diffusion] Case4 U-Net, batch {loop.batch_size}, 384^2: {loop.step} steps, "
        f"losses {[round(x, 6) for x in losses]}, valid_mse {[round(x, 6) for x in valid]}, "
        f"CLI wall {wall:.1f} s, peak memory {peak:.2f} GiB; launches {counts}; files {files}")
    want = [f"{p}{s:06d}.pt" for s in (2, 3) for p in ("model", "opt", "ema_0.9999_")]
    if not (loop.step == 3 and len(losses) == 3 and all(np.isfinite(losses + valid))
            and set(want) <= set(files)):
        raise SystemExit("diffusion training: wrong step count, non-finite losses or "
                         "missing checkpoints")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SystemExit(f"diffusion training ran without launching {missing}")

    # ms per step: three more steps of the same loop; then a profile
    data = [next(loop.data)[0] for _ in range(4)]
    step_ms = timed_steps(loop, data[:3])
    figures.update(diffusion_step_ms=step_ms, diffusion_peak_gib=peak)
    log(f"[train-diffusion] ms per training step (train + validation forward, synchronized "
        f"wall, after the CLI's 3): {[round(x, 1) for x in step_ms]}; CLI wall per step "
        f"{wall * 1e3 / 3:.1f} (first step, build and data set-up included)")
    kernels = device_profile("one diffusion training step (Case4, batch 8, flash on)",
                             lambda: loop.run_step(data[3]), top=10)
    busy = sum(ms for ms, _ in kernels.values())
    shares = {"convolutions and matmuls (cuDNN, cuBLAS)": (
                  "conv", "cudnn", "implicit", "winograd", "fft", "gemm", "xmma", "cutlass"),
              "flash kernels": ("flash_",), "optimizer": ("adam", "multi_tensor", "foreach")}
    parts = []
    for label, keys in shares.items():
        ms = sum(m for k, (m, _) in kernels.items()
                 if any(key in k.lower() for key in keys)
                 and (label.startswith("flash") or "flash_" not in k.lower()))
        parts.append(f"{label} {ms:.1f} ms ({ms / max(busy, 1e-9):.1%})")
    log("[profile]   " + ", ".join(parts) + " of busy")
    del loop
    torch.cuda.empty_cache()

    ema3 = torch.load(os.path.join(logs, "ema_0.9999_000003.pt"), weights_only=True)
    resume = dict(recipe, lr_anneal_steps=4,
                  resume_checkpoint=os.path.join(logs, "model000003.pt"))
    fa.reset_launch_counts()
    again = train_diffusion.main([_write_yaml(path, resume)])
    torch.cuda.synchronize()
    for k, v in fa.LAUNCHES.items():
        counts[k] += v
    params4 = torch.load(os.path.join(logs, "model000004.pt"), weights_only=True)
    ema4 = torch.load(os.path.join(logs, "ema_0.9999_000004.pt"), weights_only=True)
    ema_err = max((ema4[k] - (0.9999 * ema3[k] + 0.0001 * params4[k])).abs().max().item()
                  for k in ema4)
    log(f"[train-diffusion] resume: resume step {again.resume_step}, final step {again.step}, "
        f"max |ema4 - (r ema3 + (1 - r) params4)| {ema_err:.3e}; launches {dict(fa.LAUNCHES)}")
    if not (again.resume_step == 3 and again.step == 4 and ema_err <= 1e-6):
        raise SystemExit("the resumed diffusion run did not read back the step or the EMA")
    del again
    torch.cuda.empty_cache()
    return counts, os.path.join(logs, "ema_0.9999_000004.pt")


# the launches of the flash kernels above 128 on the paths that run them
# (phase 12b and phase 18 (f)), by pass and padded width: the kernels line's
# @D256 / @D512 rows
WIDE_FLASH_LAUNCHES = {}
# the one-head recipe: create_model's JAX defaults, one head a block
ONE_HEAD = dict(num_heads=1, num_head_channels=-1)


def _add_wide_launches(counts) -> None:
    for k, v in counts.items():
        WIDE_FLASH_LAUNCHES[k] = WIDE_FLASH_LAUNCHES.get(k, 0) + v


def phase_one_head(root) -> dict:
    """Phase 12b, the slice's path above 128: ``cli.train_diffusion`` on
    ``recipes/diffusion/case4.yml`` with ``create_model``'s JAX head defaults
    (``num_heads`` 1, ``num_head_channels`` -1: one head of all a block's
    channels; its attention resolutions 32, 16, 8 are ds 12, 24, 48, no level
    of the 384^2 U-Net, so its one attention block is the middle block's,
    one head of 512 channels at 144 tokens) and flash on, batch 8, 3 steps
    and a resume to step 4; every flash kernel above 128 must launch at D =
    512, and no narrow one; then the same in bf16 (``use_bf16``, 3 steps):
    the TMA forward and the TMA backward pair at 512 must launch.  Returns
    the wide launches."""
    recipe = write_diffusion_case(os.path.join(root, "one_head"), **ONE_HEAD)
    logs = recipe["log_path"]
    path = _write_yaml(os.path.join(root, "one_head", "case4.yml"), recipe)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loop = train_diffusion.main([path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, narrow, steps = dict(fa.LAUNCHES_WIDE), dict(fa.LAUNCHES), loop.step
    peak = torch.cuda.max_memory_allocated() / 2**30
    plan = loop.model.plan
    heads = sorted({(s.ch // s.num_heads, s.use_flash) for block in (
        *plan.input_blocks, plan.middle_block, *plan.output_blocks) for s in block
        if isinstance(s, tunet.AttnSpec)})
    with open(os.path.join(logs, "progress.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    data = [next(loop.data)[0] for _ in range(2)]
    step_ms = timed_steps(loop, data)
    log(f"[one-head] Case4 U-Net, num_heads 1, flash on, batch {loop.batch_size}: heads "
        f"(width, flash) {heads}; {steps} steps, losses {[round(x, 6) for x in losses]}, "
        f"CLI wall {wall:.1f} s, peak memory {peak:.2f} GiB, ms per step after the CLI's "
        f"{[round(x, 1) for x in step_ms]}; launches above 128 {counts}, narrow {narrow}")
    missing = [f"{k}@D512" for k in fa.LAUNCHES if counts.get(f"{k}@D512", 0) == 0]
    if not (steps == 3 and len(losses) == 3 and np.isfinite(losses).all()):
        raise SystemExit("one-head diffusion training: wrong step count or non-finite losses")
    if missing or any(narrow.values()):
        raise SystemExit(f"one-head diffusion training did not launch {missing}, or launched "
                         f"a narrow flash kernel: {narrow}")
    del loop
    torch.cuda.empty_cache()
    resume = dict(recipe, lr_anneal_steps=4,
                  resume_checkpoint=os.path.join(logs, "model000003.pt"))
    fa.reset_launch_counts()
    again = train_diffusion.main([_write_yaml(path, resume)])
    torch.cuda.synchronize()
    log(f"[one-head] resume: resume step {again.resume_step}, final step {again.step}; "
        f"launches {dict(fa.LAUNCHES_WIDE)}")
    if not (again.resume_step == 3 and again.step == 4):
        raise SystemExit("the resumed one-head run did not read back the step")
    for k, v in fa.LAUNCHES_WIDE.items():
        counts[k] = counts.get(k, 0) + v
    del again
    torch.cuda.empty_cache()
    # the bf16 torso (use_bf16) with the same heads: the forward and the
    # backward pair on TMA tensor copies at 512
    rec16 = write_diffusion_case(os.path.join(root, "one_head_bf16"), use_bf16=True, **ONE_HEAD)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loop16 = train_diffusion.main([_write_yaml(os.path.join(root, "one_head_bf16", "case4.yml"),
                                               rec16)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c16, narrow16, steps16 = dict(fa.LAUNCHES_WIDE), dict(fa.LAUNCHES), loop16.step
    with open(os.path.join(rec16["log_path"], "progress.csv")) as f:
        losses16 = [float(r["loss"]) for r in csv.DictReader(f)]
    step16_ms = timed_steps(loop16, [next(loop16.data)[0] for _ in range(2)])
    log(f"[one-head] the same in bf16 (use_bf16): {steps16} steps, losses "
        f"{[round(x, 6) for x in losses16]}, CLI wall {wall:.1f} s, ms per step after the "
        f"CLI's {[round(x, 1) for x in step16_ms]}; launches {c16}, narrow {narrow16}")
    missing = [f"{k}_bf16@D512" for k in fa.LAUNCHES if c16.get(f"{k}_bf16@D512", 0) == 0]
    if not (steps16 == 3 and len(losses16) == 3 and np.isfinite(losses16).all()):
        raise SystemExit("one-head bf16 diffusion training: wrong step count or non-finite "
                         "losses")
    if missing or any(narrow16.values()):
        raise SystemExit(f"one-head bf16 diffusion training did not launch {missing}, or "
                         f"launched a narrow flash kernel: {narrow16}")
    for k, v in c16.items():
        counts[k] = counts.get(k, 0) + v
    del loop16
    torch.cuda.empty_cache()
    _add_wide_launches(counts)
    return counts


def phase_train_to_sample(root, ema_path) -> dict:
    """The DPS CLI with the EMA just trained and flash attention on."""
    recipe = dict(write_assets(root, 10), ema_path=ema_path, use_flash_attention=True,
                  save_path=os.path.join(root, "samples_trained.npy"))
    path = _write_yaml(os.path.join(root, "case4_trained.yml"), recipe)
    fa.reset_launch_counts()
    sd.reset_launch_counts()
    timings = sample_conditional.main([path])
    torch.cuda.synchronize()
    counts = {**fa.LAUNCHES, **sd.LAUNCHES}
    fields = np.load(recipe["save_path"])
    T = CASE4_RECIPE["time_length"]
    log(f"[train-sample] fields {fields.shape} from {os.path.basename(ema_path)}, finite "
        f"{bool(np.isfinite(fields).all())}; {timings['steps']} guided steps "
        f"{timings['sample_s'] * 1e3 / timings['steps']:.1f} ms/step; launches {counts}")
    if fields.shape != (1, T, MESH_POINTS, 3) or not np.isfinite(fields).all():
        raise SystemExit("sampling from the trained EMA gave a wrong field")
    missing = [k for k in fa.LAUNCHES if fa.LAUNCHES[k] == 0]
    if missing:
        raise SystemExit(f"sampling with flash on ran without launching {missing}")
    return counts

def generated_rows_check(trainer, latents, fields, rows) -> None:
    """Rows of the saved fields against a float64 decode of the same
    denormalized latents, under the forward check's criterion with the
    folded plain decode as the f32 yardstick; the forward kernel's error on
    the same rows is printed beside them."""
    device = trainer.device
    model = trainer.model
    coords = trainer.in_normalizer.to(device).normalize(
        torch.as_tensor(trainer.train_coord, device=device))
    denorm = trainer.out_normalizer.to(device).denormalize
    lat = torch.as_tensor(latents[rows], device=device)
    w_first, w_mid, w_head, b_head, w2, b1, scale = sd.stack_weights(model, model.w0)
    with torch.no_grad():
        truth = denorm(f64_decode(model, coords, lat, chunk=MESH_POINTS))
        fold = denorm(sd.decode_forward_plain(coords, sd.film_table(lat, w2, b1, scale),
                                              w_first, w_mid, w_head, b_head))
        kern = denorm(sd.fused_siren_decode(model, coords, lat, model.w0))
    saved = torch.as_tensor(fields[rows], device=device)
    err_s, err_f, err_k = ((x.double() - truth).abs().max().item() for x in (saved, fold, kern))
    limit = 2 * err_f + 1e-6
    ok = err_s <= limit and bool(torch.isfinite(saved).all())
    log(f"[generate] rows {rows} of sample 0 ({len(rows)}x{MESH_POINTS}): |saved-f64| "
        f"{err_s:.3e}, |folded plain-f64| {err_f:.3e}, |forward kernel-f64| {err_k:.3e}, "
        f"max |f64| {truth.abs().max().item():.3e}, error / limit {err_s / limit:.3f} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the generated fields are not the decode of the generated latents")


def decode_route_times(trainer, latents) -> None:
    """The CLI's decode of every generated row, ``CNFTrainer.infer`` (the
    plain decode, as the JAX package routes it) against the forward kernel
    on the same rows and chunks: synchronized wall seconds of each, results
    kept on the card."""
    device = trainer.device
    model = trainer.model
    coords = trainer.in_normalizer.to(device).normalize(
        torch.as_tensor(trainer.train_coord, device=device))
    denorm = trainer.out_normalizer.to(device).denormalize
    lat = torch.as_tensor(latents.reshape(-1, latents.shape[-1]), device=device)
    chunk = 16
    routes = {
        "infer (plain)": lambda rows: trainer.infer(trainer.train_coord, rows),
        "forward kernel": lambda rows: denorm(sd.fused_siren_decode(model, coords, rows,
                                                                    model.w0))}
    seconds = {}
    with torch.no_grad():
        for name, fn in routes.items():
            fn(lat[:chunk])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(0, lat.shape[0], chunk):
                fn(lat[i:i + chunk])
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
    log(f"[generate] decode routes, {lat.shape[0]} rows x {coords.shape[0]} points in chunks "
        f"of {chunk}, on the card: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
        + f"; plain / kernel {seconds['infer (plain)'] / seconds['forward kernel']:.2f}")


def unguided_step_ms(path, device):
    """ms per unguided step of a ``cli.sample`` recipe: the CLI's U-Net (its
    torso pre-cast, as the CLI does) and loop, a synchronized clock read
    after every step; returns the step times, the model, the diffusion and
    the sample shape."""
    hp = cfgmod.basic_input(path)
    model, diffusion = train_diffusion.build_model_and_diffusion(hp)
    model = sample.load_unet(hp.ema_path, model).to(device).eval().requires_grad_(False)
    model.cast_torso_params()
    shape = (hp.test_batch_size, 1, hp.time_length, hp.latent_length)
    stamps = []

    def clock(x_t, **_):
        synchronize(device)
        stamps.append(time.perf_counter())
        return x_t
    synchronize(device)
    stamps.append(time.perf_counter())
    diffusion.p_sample_loop(model, shape, generator=torch.Generator(device).manual_seed(1),
                            step_hook=clock)
    return np.diff(stamps) * 1e3, model, diffusion, shape


def sample_recipe(root, ema_path, cnf_recipe, name, **over) -> str:
    """``recipes/diffusion/case4.yml`` for ``cli.sample`` from ``ema_path``
    (and the data range saved beside it), flash on, 10 respaced steps,
    decoding through ``cnf_recipe``'s CNF."""
    logs = os.path.dirname(ema_path)
    with open(RECIPE_DIFFUSION) as f:
        recipe = yaml.safe_load(f)
    recipe.update(use_flash_attention=True, timestep_respacing="10", ema_path=ema_path,
                  max_val=os.path.join(logs, "data_max.npy"),
                  min_val=os.path.join(logs, "data_min.npy"), cnf_case_file_path=cnf_recipe,
                  save_path=os.path.join(root, f"{name}.npy"), seed=0, **over)
    return _write_yaml(os.path.join(root, f"{name}.yml"), recipe)


def phase_generate(root, ema_path, device, figures) -> dict:
    """Unguided generation at full Case4 U-Net width through ``cli.sample``,
    then ``cli.eval_cnf`` and ``cli.integral_timescale``; returns the launch
    counts of the CLI runs and puts the ms per step and the CLI's peak
    memory into ``figures``."""
    T = CASE4_RECIPE["time_length"]
    cnf_recipe = write_training_case(os.path.join(root, "generate"), n_snapshots=4,
                                     points=MESH_POINTS, epochs=1)
    train_cnf.main([cnf_recipe])
    path = sample_recipe(os.path.join(root, "generate"), ema_path, cnf_recipe, "sample")
    recipe = cfgmod.basic_input(path).to_dict()
    batch = recipe["test_batch_size"]

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    out = sample.main([path])
    wall = time.perf_counter() - t0
    counts = {**fa.LAUNCHES, **sd.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    fields = np.load(recipe["save_path"])
    expected = (batch, T, MESH_POINTS, 3)
    log(f"[generate] cli.sample: fields {fields.shape}, finite "
        f"{bool(np.isfinite(fields).all())}; {out['steps']} steps {out['sample_s']:.3f} s, "
        f"decode {out['decode_s']:.3f} s ({batch} x {T} rows x {MESH_POINTS} points, the "
        f"plain decode of CNFTrainer.infer), CLI wall {wall:.1f} s, peak memory {peak:.2f} "
        f"GiB; launches {counts}")
    if fields.shape != expected or not np.isfinite(fields).all():
        raise SystemExit(f"unguided generation gave a wrong field: {fields.shape}, "
                         f"expected {expected}")
    if counts["flash_forward"] == 0:
        raise SystemExit("unguided generation with flash on ran without the flash forward")
    trainer = CNFTrainer(cfgmod.basic_input(cnf_recipe), device=device)
    trainer.load(-1, siren_only=True)
    generated_rows_check(trainer, out["latents"][0], fields[0], [0, T - 1])
    decode_route_times(trainer, out["latents"])
    del trainer

    # ms per step: the same loop on the same weights
    step_ms, model, diffusion, shape = unguided_step_ms(path, device)
    median = float(np.median(step_ms[1:]))
    figures.update(unguided_ms=median, sample_peak_gib=peak)
    log(f"[generate] ms per unguided step (batch {batch}, synchronized wall): "
        f"{[round(float(x), 1) for x in step_ms]}; median after the first {median:.1f} ms; "
        f"seconds per 1000-step batch of {batch} {median:.1f} (derived)")
    x = torch.randn(shape, generator=torch.Generator(device).manual_seed(2), device=device)
    t_mid = torch.full((batch,), diffusion.num_timesteps // 2, dtype=torch.long)
    with torch.no_grad():
        device_profile(f"one unguided step (Case4, batch {batch}, flash on)",
                       lambda: diffusion.p_sample(model, x, t_mid, noise=x), top=8)
    ddim = [diffusion.ddim_sample_loop(model, shape, noise=x, eta=0.0)
            for _ in range(2)]
    same = torch.equal(ddim[0], ddim[1])
    finite = bool(torch.isfinite(ddim[0]).all())
    log(f"[generate] ddim_sample_loop, eta 0, {diffusion.num_timesteps} steps, twice from "
        f"the same noise: finite {finite}, bitwise equal {same}, max |diff| "
        f"{(ddim[0] - ddim[1]).abs().max().item():.3e}")
    if not (same and finite):
        raise SystemExit("DDIM at eta 0 is not finite or not repeatable")
    del model, ddim
    torch.cuda.empty_cache()

    # (b) eval_cnf on phase 9's checkpoint and snapshots, kernel vs plain
    train_root = os.path.join(root, "train")
    ckpt, _ = latest_checkpoint(os.path.join(train_root, "run"))
    args = ["--checkpoint", ckpt, "--config", os.path.join(train_root, "cnf.yml"),
            "--data", os.path.join(train_root, "output.npy"),
            "--coords", os.path.join(train_root, "coords.npy"), "--batch-size", "16"]
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    mse, rmae = eval_cnf.main(args)
    eval_s = time.perf_counter() - t0
    eval_counts = dict(sd.LAUNCHES)
    inf = CNF_inference(ckpt, os.path.join(train_root, "cnf.yml"),
                        os.path.join(train_root, "output.npy"), use_pallas=False)
    t0 = time.perf_counter()
    pred = inf.predict(np.load(os.path.join(train_root, "coords.npy")),
                       list(range(inf.data.shape[0])), 16)
    plain_s = time.perf_counter() - t0
    p_mse = metrics.per_channel_mse(pred, inf.data)
    p_rmae = metrics.per_channel_rmae(pred, inf.data)
    rel = max(float(np.max(np.abs(mse - p_mse) / np.abs(p_mse))),
              float(np.max(np.abs(rmae - p_rmae) / np.abs(p_rmae))))
    log(f"[eval] cli.eval_cnf on {os.path.basename(ckpt)} ({inf.data.shape[0]} x "
        f"{inf.data.shape[1]} points): MSE {mse.tolist()}, rMAE {rmae.tolist()}; plain "
        f"decode MSE {p_mse.tolist()}, rMAE {p_rmae.tolist()}; largest relative "
        f"difference {rel:.3e}; CLI wall {eval_s:.3f} s, plain predict {plain_s:.3f} s; "
        f"launches {eval_counts}")
    if not (rel <= 1e-4 and np.isfinite(mse).all()):
        raise SystemExit("eval_cnf through the kernel disagrees with the plain decode")
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    spot = eval_cnf.main(args + ["--timestep", "2", "--row", "0", "--vals", "5"])
    log(f"[eval] spot check at timestep 2: MSE {spot[0].tolist()}, wall "
        f"{time.perf_counter() - t0:.3f} s; launches {dict(sd.LAUNCHES)}")
    for k, v in sd.LAUNCHES.items():
        eval_counts[k] += v
    if eval_counts["siren_decode_forward"] == 0 or not np.isfinite(spot[0]).all():
        raise SystemExit("eval_cnf ran without the SIREN forward kernel or gave non-finite "
                         "errors")
    del inf, pred

    # (c) the integral timescale of channel 0 of generated sample 0
    u_path = os.path.join(root, "generate", "u.npy")
    np.save(u_path, fields[0, :, :, 0])
    t0 = time.perf_counter()
    tau = integral_timescale.main(["--output-dir", u_path, "--output-dt", "1.0"])
    direct = metrics.integral_timescale(np.load(u_path), 1.0)
    log(f"[timescale] channel 0 of sample 0, {T} x {MESH_POINTS}: tau {tau!r} (in snapshot "
        f"intervals), direct {direct!r}, wall {time.perf_counter() - t0:.3f} s")
    if not (np.isfinite(tau) and tau == direct):
        raise SystemExit("integral_timescale disagrees with analysis.metrics")
    for k, v in eval_counts.items():
        counts[k] += v
    return counts


# ---------------------------------------------------------------------------
# phase 15: bf16 (the SIREN forward's compute dtype, the U-Net torso) and
# block rematerialization
# ---------------------------------------------------------------------------

RECIPE_XL = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recipes", "diffusion",
                         "case4_xl_768.yml")
# the bf16 forward kernel against its plain version: both round every
# product's operands to bf16; f32 sums in other orders flip a rounding now
# and then, and 16 layers of w0 = 30 carry a flip on
BF16_DECODE_REL_TOL = 1e-2
REMAT_REL_TOL = 1e-5


def bf16_forward_check(model, device, rows, points, seed, label="case4") -> float:
    """The bf16 forward kernel against its plain bf16 version (relative L2)
    and float64 beside the float32 kernel's and the plain version's errors,
    two launches bitwise equal; the width's bf16 plan (shared memory,
    stages, registers, spills, clusters at once) logged, and the
    instantiation a profiled bf16 forward ran held to it
    (``bf16_route``); returns its largest error against float64."""
    coords, latents, z, ops = forward_case(model, device, rows, points, seed)
    width = sd.kernel_hidden_width(z.shape[2], coords.shape[1], ops[2].shape[1], "forward_bf16")
    log(f"[bf16-forward] {label}: {cluster_plan_line(width, 'forward_bf16')}")
    bf16_route(coords, z, ops, label)

    def bf16():
        return sd.decode_forward(coords, z, *ops, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        kern = bf16()
        same = torch.equal(kern, bf16())
        plain = sd.decode_forward_plain(coords, z, *ops, torch.bfloat16)
        f32 = sd.decode_forward(coords, z, *ops)
        truth = f64_decode(model, coords, latents, chunk=32768)
    torch.cuda.synchronize()
    rel = rel_l2(kern, plain)
    errs = {name: ((x.double() - truth).abs().max().item(), rel_l2(x.double(), truth))
            for name, x in (("bf16 kernel", kern), ("bf16 plain", plain), ("f32 kernel", f32))}
    ok = rel <= BF16_DECODE_REL_TOL and same and bool(torch.isfinite(kern).all())
    log(f"[bf16-forward] {label} {rows}x{points}: kernel vs plain bf16 rel L2 {rel:.3e} (tol "
        f"{BF16_DECODE_REL_TOL}), max abs {(kern - plain).abs().max().item():.3e}; against "
        f"float64 (max abs, rel L2): " + ", ".join(f"{k} {a:.3e}, {r:.3e}"
                                                  for k, (a, r) in errs.items())
        + f", max |f64| {truth.abs().max().item():.3e}; two launches bitwise equal: {same} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the bf16 forward kernel disagrees with its plain version or is not "
                         "deterministic")
    del kern, plain, f32, truth
    torch.cuda.empty_cache()
    return errs["bf16 kernel"][0]


def bf16_route(coords, z, ops, label) -> None:
    """The kernel instantiation a bf16 forward of these operands ran (one
    call profiled on its own, up to three times, as ``cluster_route``),
    held to the cluster plan of its kernel width:
    ``siren_fwd_cluster_bf16_kernel<S, MT>``; any other SIREN forward
    instantiation fails.  As in ``cluster_route``, a profile that records
    nothing is logged, not failed: the profiler now and then drops every
    launch of a window."""
    plan = sd.cluster_plan(sd.kernel_hidden_width(z.shape[2], coords.shape[1], ops[2].shape[1],
                                                  "forward_bf16"))
    want = f"{BF16_FWD_KERNEL}<{plan.share}, {plan.m_tiles}>"
    ran = set()
    for _ in range(3):
        with torch.no_grad():
            prof = device_profile(f"{label}: {want}", lambda: (
                torch.zeros(1, device=coords.device),
                sd.decode_forward(coords, z, *ops, compute_dtype=torch.bfloat16)), top=0)
        for name in prof:
            found = re.search(r"(siren_fwd\w*_kernel)<(\d+), (\d+)>", name)
            if found:
                ran.add(f"{found.group(1)}<{found.group(2)}, {found.group(3)}>")
        if want in ran:
            break
    log(f"[bf16-forward] {label}: the profiled bf16 forward ran {sorted(ran) or 'nothing recorded'}"
        f"; the plan's instantiation {want}")
    if ran - {want}:
        raise SystemExit(f"{label}: the bf16 forward ran {sorted(ran)}, not only the plan's "
                         f"{want}")


def bf16_forward_time(model, device, rows, points, seed, repeats: int = 7) -> dict:
    """The bf16 forward kernel and the float32 one at ``rows x points`` in
    this run (medians of ``repeats`` with the least and largest, SM clocks around
    them), the bf16 kernel's device time by launch, the plain bf16 version's
    time, and the bound with the products at the dense bf16 rate."""
    coords, _, z, ops = forward_case(model, device, rows, points, seed)
    fns = {"bf16": lambda: sd.decode_forward(coords, z, *ops, compute_dtype=torch.bfloat16),
           "f32": lambda: sd.decode_forward(coords, z, *ops)}
    with torch.no_grad():
        log(f"[bf16-time] SM clock, max before: {sm_clocks()}")
        t = {k: cuda_median(fn, 1, repeats) for k, fn in fns.items()}
        log(f"[bf16-time] SM clock, max after: {sm_clocks()}")
        plain_ms = cuda_median(lambda: sd.decode_forward_plain(coords, z, *ops, torch.bfloat16),
                               2 if repeats > 3 else 1, repeats=1)[0]
        prof = device_profile(f"bf16 forward {rows}x{points}", fns["bf16"], top=3)
    n_mod, h = z.shape[0], z.shape[2]
    c_in, c_out = coords.shape[1], ops[2].shape[1]
    pairs = rows * points
    mat = pairs * 2 * h * (c_in + (n_mod - 1) * h + c_out)
    act = pairs * ACT_FLOPS * h * n_mod
    nbytes = 4 * (points * c_in + n_mod * rows * h + c_in * h + (n_mod - 1) * h * h
                  + h * c_out + c_out + pairs * c_out)
    bound_ms, bound_by = tc_bound(mat, nbytes, act / PEAK_F32_FLOPS, rate=PEAK_BF16_FLOPS)
    for part, name in (("prep", "siren_cluster_prep_bf16_kernel"), ("forward", BF16_FWD_KERNEL)):
        hits = [v for k, v in prof.items() if name in k]
        if not hits:
            log(f"[bf16-time] {rows}x{points} {part}: device time not measured")
            continue
        dev_ms = sum(ms for ms, _ in hits)
        rate = (f", {pairs * 2 * (n_mod - 1) * h * h / dev_ms / 1e9:.2f} TFLOP/s of products"
                if part == "forward" and dev_ms else "")
        log(f"[bf16-time] {rows}x{points} {part}: {dev_ms:.3f} ms device, "
            f"{sum(n for _, n in hits)} launches{rate}")
    # every cluster (each block its columns) reads the whole bf16 stream
    group = sd.cluster_plan(h).pairs
    stream = -(-pairs // group) * (n_mod - 1) * h * h * 2
    ms, least, largest = t["bf16"]
    log(f"[bf16-forward] {rows}x{points} H={h}: kernel {ms:.3f} ms [{least:.3f}-{largest:.3f}] "
        f"median of {repeats} ({(mat + act) / ms / 1e9:.2f} TFLOP/s), float32 kernel in this run "
        f"{t['f32'][0]:.3f} ms [{t['f32'][1]:.3f}-{t['f32'][2]:.3f}] "
        f"({t['f32'][0] / ms:.2f}x), plain bf16 {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by}: products at the dense bf16 rate, sines on the CUDA cores); the clusters "
        f"of {group} pairs read {stream / 1e12:.3f} TB of the bf16 weight stream from L2; "
        f"library: none")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                shape=f"{rows}x{points}", f32_ms=t["f32"][0], stream_tb=stream / 1e12)


def bf16_frozen_path(device) -> dict:
    """``fused_siren_decode_frozen`` with ``compute_dtype`` float32, then
    bfloat16, forward and dz backward at 384 x 1024 (the DPS gradient at
    1024 sensors): the bf16 run must launch the bf16 forward and the dz
    kernels (counts zeroed before, read after), and its gradient equals the
    float32 run's (the backward ignores the compute dtype); returns the
    bf16 run's launch counts."""
    model = case4_decoder(device)
    coords, latents, g, *_ = dz_case(model, device, 384, 1024, seed=9)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        lat = latents.clone().requires_grad_(True)
        sd.reset_launch_counts()
        out = sd.fused_siren_decode_frozen(model, coords, lat, model.w0, compute_dtype=dtype)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        counts = dict(sd.LAUNCHES)
        grads[dtype] = lat.grad
    same = torch.equal(grads[torch.bfloat16], grads[torch.float32])
    ok = (same and counts["siren_decode_forward_bf16"] > 0 and counts["siren_decode_dz"] > 0
          and counts["siren_decode_forward"] == 0
          and bool(torch.isfinite(grads[torch.bfloat16]).all()))
    log(f"[bf16-frozen] fused_siren_decode_frozen(compute_dtype=bf16) 384x1024, forward and dz "
        f"backward: launches {counts}; dL/dlatents equal to the float32 op's: {same} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the bf16 frozen decode did not run the bf16 forward and the dz "
                         "kernels, or its gradient is not the float32 backward's")
    return counts


def phase_bf16_decode(device, results) -> dict:
    """Phase 15 (a): the bf16 SIREN forward kernel; returns the launch
    counts of the frozen op's run."""
    model = case4_decoder(device)
    err = bf16_forward_check(model, device, 16, 262144, 3)
    bf16_forward_check(model, device, 384, 10, 5)
    results["siren_decode_forward_bf16"] = dict(bf16_forward_time(model, device, 16, 262144, 3),
                                                max_abs_err=err)
    bf16_forward_time(model, device, 4, 262144, 4)
    return bf16_frozen_path(device)


def phase_bf16_unet(root, device, figures) -> dict:
    """Phase 15 (b): the bf16 Case4 U-Net trained and sampled through the
    CLIs; returns the flash launch counts of both CLI runs."""
    recipe = write_diffusion_case(os.path.join(root, "diffusion_bf16"), use_bf16=True)
    logs = recipe["log_path"]
    path = _write_yaml(os.path.join(root, "diffusion_bf16", "case4.yml"), recipe)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    loop = train_diffusion.main([path])
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(logs, "progress.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    step_ms = timed_steps(loop, [next(loop.data)[0] for _ in range(3)])
    f32_ms = figures["diffusion_step_ms"]
    log(f"[bf16-unet] cli.train_diffusion, Case4 U-Net bf16 torso, batch {loop.batch_size}, "
        f"flash on: losses {[round(x, 6) for x in losses]}, launches {counts}; ms per step "
        f"{[round(x, 1) for x in step_ms]} (float32, phase 12: "
        f"{[round(x, 1) for x in f32_ms]}; {np.median(f32_ms) / np.median(step_ms):.2f}x), "
        f"peak memory {peak:.2f} GiB (float32: {figures['diffusion_peak_gib']:.2f})")
    if not (loop.model.cfg.torso_dtype == torch.bfloat16 and len(losses) == 3
            and np.isfinite(losses).all() and all(v > 0 for v in counts.values())):
        raise SystemExit("bf16 diffusion training: wrong torso, non-finite losses or a flash "
                         "kernel not launched")
    batch = next(loop.data)[0]
    device_profile("one bf16 diffusion training step (Case4, batch 8, flash on)",
                   lambda: loop.run_step(batch), top=8)
    del loop
    torch.cuda.empty_cache()

    # phase 5's seeded Case4 weights (the EMA of 3 steps from the zeroed
    # output convolutions gives an output near 0)
    state = torch.load(write_assets(root, 10)["ema_path"], weights_only=True)
    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn((2, 1, 384, 384), generator=gen, device=device)
    ts = torch.tensor([100, 700], device=device)
    outs = {}
    for bf16 in (False, True):
        model = tunet.create_model(**CASE4_UNET, use_flash_attention=True, use_bf16=bf16)
        model.load_state_dict(state)
        with torch.no_grad():
            outs[bf16] = model.to(device).eval()(x, ts)
        del model
    log(f"[bf16-unet] one forward (batch 2, flash on) with phase 5's seeded Case4 weights: "
        f"bf16 vs float32 relative L2 {rel_l2(outs[True], outs[False]):.3e}, max abs "
        f"{(outs[True] - outs[False]).abs().max().item():.3e}, max |float32| "
        f"{outs[False].abs().max().item():.3e}")

    ema_path = os.path.join(logs, "ema_0.9999_000003.pt")

    cnf_recipe = os.path.join(root, "generate", "case4.yml")   # phase 14's CNF
    spath = sample_recipe(os.path.join(root, "diffusion_bf16"), ema_path, cnf_recipe,
                          "sample", use_bf16=True)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    out = sample.main([spath])
    speak = torch.cuda.max_memory_allocated() / 2**30
    scounts = dict(fa.LAUNCHES)
    fields = np.load(cfgmod.basic_input(spath).save_path)
    step_ms, model, *_ = unguided_step_ms(spath, device)
    median = float(np.median(step_ms[1:]))
    cast = {p.dtype for m in model.torso_layers() for p in m.parameters()}
    log(f"[bf16-unet] cli.sample from the bf16 EMA: fields {fields.shape}, finite "
        f"{bool(np.isfinite(fields).all())}, sampling {out['sample_s']:.3f} s, decode "
        f"{out['decode_s']:.3f} s, peak memory {speak:.2f} GiB (float32, phase 14: "
        f"{figures['sample_peak_gib']:.2f}); launches {scounts}; torso dtypes {cast}; ms per "
        f"unguided step {[round(float(v), 1) for v in step_ms]}, median after the first "
        f"{median:.1f} (float32, phase 14: {figures['unguided_ms']:.1f}; "
        f"{figures['unguided_ms'] / median:.2f}x)")
    if not (np.isfinite(fields).all() and fields.shape[0] == 8 and scounts["flash_forward"] > 0
            and cast == {torch.bfloat16}):
        raise SystemExit("bf16 sampling gave a wrong field, ran without the flash forward or "
                         "did not pre-cast its torso")
    del model
    torch.cuda.empty_cache()
    return {k: counts[k] + scounts[k] for k in counts}


def phase_remat(root, device) -> None:
    """Phase 15 (c): one Case4 training step with and without block
    rematerialization from the same state, then the xl recipe through the
    CLI under the "full" and "matmuls" policies."""
    state = torch.load(write_assets(root, 10)["ema_path"], weights_only=True)
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine")
    gen = torch.Generator(device=device).manual_seed(41)
    x0 = torch.rand((8, 1, 384, 384), generator=gen, device=device) * 2 - 1
    noise = torch.randn(x0.shape, generator=gen, device=device)
    t = torch.tensor([3, 120, 250, 400, 555, 700, 850, 999])
    res = {}
    for ckpt in (False, True):
        model = tunet.create_model(**CASE4_UNET, use_checkpoint=ckpt)
        model.load_state_dict(state)
        model.to(device)

        def step():
            model.zero_grad(set_to_none=True)
            diffusion.training_losses(model, x0, t, noise=noise)["loss"].mean().backward()
        step()   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        res[ckpt] = ((time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 2**30,
                     {n: p.grad for n, p in model.named_parameters()})
        del model
        torch.cuda.empty_cache()
    worst = max((rel_l2(res[True][2][n], res[False][2][n]), n) for n in res[False][2])
    ok = worst[0] <= REMAT_REL_TOL
    log(f"[remat] Case4 U-Net, batch 8, one training step (forward + backward): "
        f"use_checkpoint full {res[True][0]:.1f} ms, peak {res[True][1]:.2f} GiB; without "
        f"{res[False][0]:.1f} ms, peak {res[False][1]:.2f} GiB; worst gradient rel L2 "
        f"{worst[0]:.3e} ({worst[1]}, tol {REMAT_REL_TOL}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("rematerialized gradients differ from the plain step's")
    del res
    for policy in ("full", "matmuls"):
        try:
            train_xl(root, policy, batch=4)
            continue
        except torch.cuda.OutOfMemoryError as err:   # recorded, then a batch that fits
            log(f"[remat] case4_xl_768.yml, remat_policy {policy}, batch 4: out of memory, "
                f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"({str(err).splitlines()[0]}); again at batch 2")
        gc.collect()
        torch.cuda.empty_cache()
        train_xl(root, policy, batch=2)


def train_xl(root, policy: str, batch: int) -> None:
    """``recipes/diffusion/case4_xl_768.yml``'s model (768^2, f32, flash on
    auto) through ``cli.train_diffusion`` for 3 steps at ``batch`` under
    ``remat_policy``: ms per step and peak memory."""
    recipe = write_diffusion_case(os.path.join(root, f"xl_{policy}_{batch}"), n_train=2 * batch,
                                  n_valid=batch, recipe_path=RECIPE_XL,
                                  use_flash_attention=None, remat_policy=policy,
                                  batch_size=batch)
    path = _write_yaml(os.path.join(root, f"xl_{policy}_{batch}", "case.yml"), recipe)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop = train_diffusion.main([path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(recipe["log_path"], "progress.csv")) as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    step_ms = timed_steps(loop, [next(loop.data)[0] for _ in range(2)])
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg = loop.model.cfg
    log(f"[remat] cli.train_diffusion on case4_xl_768.yml (768^2, batch {loop.batch_size}, f32, "
        f"flash {'on' if cfg.use_flash_attention else 'off (auto: dense)'}), use_checkpoint "
        f"{cfg.use_checkpoint}, remat_policy {cfg.remat_policy}: losses "
        f"{[round(x, 6) for x in losses]}, CLI wall {wall:.1f} s, ms per step "
        f"{[round(x, 1) for x in step_ms]}, peak memory {peak:.2f} GiB")
    if not (cfg.use_checkpoint and cfg.remat_policy == policy and len(losses) == 3
            and np.isfinite(losses).all()):
        raise SystemExit(f"the xl recipe did not train under remat policy {policy}")


# ---------------------------------------------------------------------------
# phase 16: the float32 SIREN kernels at the narrow widths, multi-step
# training from a device-resident set, the turbulence demo end to end
# ---------------------------------------------------------------------------

# six modulated layers at the widest narrow plan, two blocks of 256 columns
# (448 padded to it): Case4's 3 coordinates and outputs at 448, the demo's
# 2 at 512
WIDE_CNFS = {448: dict(in_coord_features=3, in_latent_features=256, out_features=3,
                       num_hidden_layers=5, hidden_features=448, w0=30.0),
             512: dict(in_coord_features=2, in_latent_features=256, out_features=2,
                       num_hidden_layers=5, hidden_features=512, w0=30.0)}
# the narrower plans, (C_in, C_out, hidden layers, H): six modulated layers
# at 64 (padded to 128), 256 (a cluster of one block), 320 (padded to 384)
# and 384 (two blocks of 192), 3 -> 3, and one modulated layer (no middle
# weight) at 128; the demo --fast's decoder (DEMO_CNFS, 2 -> 128 x 5 -> 2,
# one block) is checked and timed beside them
NARROW_CHECKS = ((3, 3, 5, 64), (3, 3, 0, 128), (3, 3, 5, 256), (3, 3, 5, 320),
                 (3, 3, 5, 384))
# the narrow plan no float32 check takes, one block of 192 columns: the bf16
# forward's alone (six modulated layers, 3 -> 3)
BF16_ONLY_NARROW = 192
# the families whose launches every narrow width's checks must count
FLOAT32_KEYS = ("siren_decode_forward", "siren_decode_dz", "siren_decode_bwd")


def cluster_route(model, device, label) -> list:
    """The kernel instantiations that a float32 forward, dz and training
    backward of ``model`` at 4 x 4096 ran, each call profiled on its own
    (torch.profiler), held to the cluster plan of its kernel width:
    ``siren_fwd_cluster_kernel<S, MT>`` and ``siren_chain_cluster_kernel<S,
    MT, dz | bwd>``.  The profiler may record only part of a window, so a
    call whose instantiation is missing is profiled again, up to three
    times; any other float32 SIREN instantiation fails the check.  Returns
    what was recorded."""
    coords, _, z, ops = forward_case(model, device, 4, 4096, 29)
    c_in, c_out = coords.shape[1], ops[2].shape[1]
    plan = sd.cluster_plan(sd.kernel_hidden_width(z.shape[2], c_in, c_out, "forward"))
    g = torch.randn((4, 4096, c_out), generator=torch.Generator(device=device).manual_seed(29),
                    device=device)
    pl = f"{plan.share}, {plan.m_tiles}"
    calls = ((f"siren_fwd_cluster_kernel<{pl}>", lambda: sd.decode_forward(coords, z, *ops)),
             (f"{CHAIN_KERNEL}<{pl}, dz>", lambda: sd.decode_dz(coords, z, g, *ops[:3])),
             (f"{CHAIN_KERNEL}<{pl}, bwd>", lambda: sd.decode_bwd(coords, z, g, *ops[:3])))
    ran = set()
    for want, call in calls:
        for _ in range(3):
            # a fill first: the profiler may drop the window's first launch
            with torch.no_grad():
                prof = device_profile(f"{label}: {want}",
                                      lambda: (torch.zeros(1, device=device), call()), top=0)
            for name in prof:
                found = re.search(r"(siren_\w+_kernel)<(\d+), (\d+)(?:, (true|false))?>", name)
                if found:
                    mode = {"true": ", dz", "false": ", bwd"}.get(found.group(4), "")
                    ran.add(f"{found.group(1)}<{found.group(2)}, {found.group(3)}{mode}>")
                elif kernel_label(name):
                    ran.add(kernel_label(name))
            if want in ran:
                break
    ran = sorted(k for k in ran if k.startswith(("siren_fwd_cluster_kernel<", CHAIN_KERNEL + "<")))
    expected = sorted(want for want, _ in calls)
    log(f"[narrow] {label}: the profiled calls ran {ran or 'nothing recorded'}; the plan's "
        f"instantiations {expected}")
    if set(ran) - set(expected):
        raise SystemExit(f"{label}: the float32 SIREN calls ran {ran}, not only the cluster "
                         f"plan's {expected}")
    return ran


def narrow_checks(model, device, label, bf16: bool = False) -> dict:
    """The float32 forward, dz and the training backward of ``model`` (a
    width up to 512) against their plain versions and float64 under the
    criteria of phases 3, 4 and 7, each with a bitwise repeat: the forward
    at 4 x 16384 and a ragged 3 x 3001 (with ``bf16`` also the bf16
    forward at 4 x 16384), dz at 64 x 1024 (also against the training
    backward's) and a ragged 100 x 3000 (rows cut across clusters and
    chunks), the training backward at 4 x 16384; the width's cluster plans
    first; the checks' launches (zeroed before, read after), which every
    float32 family must have; then ``cluster_route``.  Returns the
    kernels' errors against float64 (``bf16`` the bf16 forward's too)."""
    h = model.net1[0].out_features
    width = sd.kernel_hidden_width(h, model.net1[0].in_features, model.net1[-1].out_features,
                                   "forward")
    for family in ("forward", "dz", "bwd"):
        log(f"[narrow] {label}: {sd.FAMILIES[family]}: {cluster_plan_line(width, family)}")
    sd.reset_launch_counts()
    errs = {"forward": forward_check(model, device, 4, 16384, 21, label)}
    forward_check(model, device, 3, 3001, 22, label)
    if bf16:
        errs["bf16"] = bf16_forward_check(model, device, 4, 16384, 23, label)
    errs["dz"] = dz_check(model, device, 64, 1024, 24, label, against_bwd=True)
    dz_check(model, device, 100, 3000, 25, label)
    errs["bwd"] = bwd_check(model, device, 4, 16384, seed=26)
    torch.cuda.synchronize()
    counts = dict(sd.LAUNCHES)
    log(f"[narrow] {label}: launches of the checks {counts}")
    missing = [k for k in FLOAT32_KEYS if counts[k] == 0]
    if missing:
        raise SystemExit(f"{label}: the checks did not launch {missing}")
    cluster_route(model, device, label)
    return errs


def phase_narrow(device, results) -> None:
    """Phase 16a: the float32 and bf16 forwards, dz and the training
    backward on the cluster kernels at every narrow plan (``NARROW_CHECKS``,
    the demo --fast's decoder and ``WIDE_CNFS``) under ``narrow_checks``, and
    the bf16 forward alone at ``BF16_ONLY_NARROW`` (also a ragged 3 x
    3001); the float32 forward and the training
    backward timed at 4 x 262144 at 448 and 512, and at the demo --fast's
    batch (64 x 1024) at 128, whose rows in the kernels line take that
    run's launches."""
    for c_in, c_out, layers, h in NARROW_CHECKS:
        model, label = check_decoder(device, c_in, c_out, layers, h)
        narrow_checks(model, device, label + f" ({layers + 1} modulated)", bf16=True)
        del model
        torch.cuda.empty_cache()
    # the bf16 forward alone on the plan of one block of 192 columns, with a
    # ragged tail
    model, label = check_decoder(device, 3, 3, 5, BF16_ONLY_NARROW)
    bf16_forward_check(model, device, 4, 16384, 23, label)
    bf16_forward_check(model, device, 3, 3001, 22, label)
    del model
    torch.cuda.empty_cache()
    cfg, rows, points = DEMO_CNFS["--fast"]
    model = SirenFilm(**cfg, generator=torch.Generator().manual_seed(rows)).to(
        device).requires_grad_(False)
    errs = narrow_checks(model, device, "demo --fast H=128", bf16=True)
    results["siren_decode_forward@H128"] = dict(
        forward_time(model, device, rows, points, 27), max_abs_err=errs["forward"])
    results["siren_decode_bwd@H128"] = dict(
        bwd_time(model, device, rows, points, seed=28), max_abs_err=errs["bwd"])
    del model
    torch.cuda.empty_cache()
    for h, cfg in WIDE_CNFS.items():
        model = SirenFilm(**cfg, generator=torch.Generator().manual_seed(h)).to(
            device).requires_grad_(False)
        errs = narrow_checks(model, device, f"H={h}", bf16=True)
        results[f"siren_decode_forward@H{h}"] = dict(
            forward_time(model, device, 4, 262144, 27), max_abs_err=errs["forward"])
        results[f"siren_decode_bwd@H{h}"] = dict(
            bwd_time(model, device, 4, 262144, seed=28), max_abs_err=errs["bwd"])
        del model
        torch.cuda.empty_cache()


def phase_multistep(root, device, figures) -> None:
    """Phase 16b: the Case4 U-Net (float32, batch 8, flash on as in phase
    12) trained ``steps_per_call`` = 4 steps a call over 32 seeded images
    resident on the card (``device_data``): synchronized wall per step of a
    call after a first one, against ``run_step`` on the same loop and
    batches of the same set (no validation data: the step alone) and
    phase 12's ``run_step`` (which adds a validation forward), peak memory,
    finite losses, the EMA moved."""
    recipe = write_diffusion_case(os.path.join(root, "multistep"))
    hp = cfgmod.Config(recipe)
    model, diffusion = train_diffusion.build_model_and_diffusion(hp)
    model.reset_parameters(torch.Generator().manual_seed(42))
    images = np.load(recipe["train_data_path"])[:, None]
    tlog.configure(os.path.join(root, "multistep", "logs"), [])
    loop = TrainLoop(model=model, diffusion=diffusion, data=None, device_data=images,
                     batch_size=hp.batch_size, lr=float(hp.lr), ema_rate=hp.get("ema_rate", "0.9999"),
                     steps_per_call=4, save_dir=os.path.join(root, "multistep", "logs"),
                     device=device)
    ema0 = [e.clone() for e in loop.ema_params[0]]
    logged = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        synchronize(device)
        t0 = time.perf_counter()
        loop.run_steps(4)
        synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        logged.append(tlog.get_current().dumpkvs())
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = max((e - e0).abs().max().item() for e, e0 in zip(loop.ema_params[0], ema0))
    losses = [row["loss"] for row in logged]
    one_ms = timed_steps(loop, [loop.device_batch() for _ in range(4)])
    single = figures.get("diffusion_step_ms", [])
    log(f"[multistep] Case4 U-Net, batch {hp.batch_size}, 4 steps a call over {len(images)} "
        f"images on the card: mean loss per call {[round(x, 6) for x in losses]}, second "
        f"call {wall_ms / 4:.1f} ms a step; run_step on the same loop "
        f"{[round(x, 1) for x in one_ms]} ms (median {np.median(one_ms):.1f}); phase 12's "
        f"run_step with its validation forward {[round(x, 1) for x in single]}; peak memory "
        f"{peak:.2f} GiB, max |EMA moved| {moved:.3e}")
    if not (loop.step == 12 and all(np.isfinite(losses)) and moved > 0):
        raise SystemExit("multi-step training from device data: wrong step count, non-finite "
                         "losses or an EMA that did not move")
    del loop, model
    torch.cuda.empty_cache()


DEMO_F4_CUT = ["--flow", "forced_soft", "--n-traj", "2", "--n-snap", "64", "--window", "64",
               "--latent", "256", "--hidden", "384", "--nf-layers", "6", "--nf-cadence",
               "batch", "--unet-channels", "96", "--unet-mult", "1,1,2,2,4", "--diff-batch",
               "64", "--scale-sigmas", "2.5", "--cnf-epochs", "2", "--diff-steps", "25",
               "--sample-steps", "100"]


# the demo CNF (its cnf.yml: 2 coordinates and outputs, w0 30) and the batch
# its fused step gives the kernels (batch_size snapshots x grid^2 points):
# --fast (latent 32, 4 hidden layers of 128, 64 x 32^2), then DEMO_F4_CUT's
# widths (latent 256, 6 hidden layers of 384, 128 x 64^2)
DEMO_CNFS = {"--fast": (dict(in_coord_features=2, in_latent_features=32, out_features=2,
                             num_hidden_layers=4, hidden_features=128, w0=30.0), 64, 1024),
             "f4 widths, cut": (dict(in_coord_features=2, in_latent_features=256,
                                     out_features=2, num_hidden_layers=6,
                                     hidden_features=384, w0=30.0), 128, 4096)}


# each demo run's SIREN launches, by its label in DEMO_CNFS (phase_demo)
DEMO_LAUNCHES = {}


def phase_demo(root, device) -> dict:
    """Phase 16c: ``confild_tpu_torch.examples.demo_turbulence`` end to end
    on the card, ``--fast`` (32^2 grid, H = 128), then at the f4 widths
    with a cut depth (2 trajectories, 2 CNF epochs, 25 diffusion steps).
    Before each run the SIREN forward and training-backward kernels at that
    run's CNF widths and batch, against their plain versions and float64
    under the criteria of phases 3 and 7.  Each run: each stage's wall, the
    CNF batch step, the diffusion step, the metrics; every gate finite, and
    the CNF stage launched the SIREN forward and training-backward kernels
    (counts zeroed before each run, read after; the later stages launch
    none).  Returns the two runs' launch counts; each run's are kept in
    ``DEMO_LAUNCHES`` under its label."""
    counts = dict.fromkeys(sd.LAUNCHES, 0)
    for label, name, argv in (("--fast", "demo_fast", ["--fast"]),
                              ("f4 widths, cut", "demo_f4", DEMO_F4_CUT)):
        cfg, rows, points = DEMO_CNFS[label]
        model = SirenFilm(**cfg, generator=torch.Generator().manual_seed(rows)).to(
            device).requires_grad_(False)
        err_f = forward_check(model, device, rows, points, 31, f"demo {label}")
        err_b = bwd_check(model, device, rows, points, seed=32, chunk=512)
        log(f"[demo] {label}: the kernels at the CNF's {rows}x{points} batch, H = "
            f"{cfg['hidden_features']}, {model.n_modulated} modulated layers: forward "
            f"|kernel-f64| {err_f:.3e}, training backward {err_b:.3e} -> ok")
        del model
        torch.cuda.empty_cache()
        sd.reset_launch_counts()
        m = demo_turbulence.main(argv + ["--out", os.path.join(root, name)])
        synchronize(torch.device("cuda"))
        run = DEMO_LAUNCHES[label] = dict(sd.LAUNCHES)
        for k, v in run.items():
            counts[k] += v
        gates = m["cnf_rmae"] + [m["spectra_relative_error"], m["timescale_ratio"]]
        log(f"[demo] {label}: stages (s) "
            f"{ {k: round(v, 2) for k, v in m['timing']['stage_s'].items()} }, CNF batch step "
            f"{m['timing']['cnf_batch_step_ms']:.1f} ms, diffusion step "
            f"{m['timing']['diffusion_step_ms']:.1f} ms, peak {m['timing']['peak_gib']:.2f} GiB, "
            f"SIREN launches {run}")
        log(f"[demo] {label}: " + json.dumps({k: v for k, v in m.items() if k != "timing"}))
        if not (all(np.isfinite(gates)) and run["siren_decode_forward"] > 0
                and run["siren_decode_bwd"] > 0):
            raise SystemExit(f"demo {label}: non-finite gates or the CNF stage ran without the "
                             "SIREN kernels")
    return counts


# the keys of the JAX scripts' reports (examples/demo_conditional.py:656-690,
# examples/demo_report.py:334-351); the port's add "device"
COND_KEYS = {"run_dir", "protocol", "per_trajectory", "sensor_rmae_pooled",
             "sigma3_coverage_pooled", "field_rmae_held_out", "field_rmae_per_member_held_out",
             "field_rmae_pooled_incl_validation", "field_rmae_unconditional_control",
             "conditioning_gain", "sensor_sweep", "prior_coverage", "in_distribution_control",
             "spectra_relative_error", "integral_timescale_truth",
             "integral_timescale_conditional", "timescale_ratio", "wall_clock_s"}
REPORT_KEYS = {"run_dir", "cnf_rmae", "cnf_recon_spectra_error", "spectra_relative_error",
               "integral_timescale_real", "integral_timescale_generated", "timescale_ratio",
               "spectra_error_ci95", "timescale_ratio_ci95", "velocity_pdf_js_divergence",
               "two_point_correlation_error", "bootstrap_resamples", "n_gen", "sample_steps"}
# phase 16d's cut of the conditional protocol, and the oracle fit's steps
# when called alone (the script's 4000 a trajectory take minutes)
DEMO_COND_CUT = ["--n-held", "2", "--n-ens", "2", "--steps", "20", "--scales", "1.0",
                 "--sensor-sweep", "16,1000", "--no-prior-check"]
ORACLE_FIT_STEPS = 200


def f64_misfit_grad(assets, coords, yn_params, y, x0):
    """d(sum of the members' ||y - A(x0)||) / dx0 with the CNF operator's
    arithmetic in float64 (the plain decode of a float64 copy of the
    decoder)."""
    tr, dev = assets.tr, assets.device
    m64 = _double(tr.model)
    xn = tr.in_normalizer.to(dev).normalize(torch.as_tensor(coords, device=dev)).double()
    y_norm = Normalizer(tuple(torch.as_tensor(p, dtype=torch.float64, device=dev)
                              for p in yn_params), tr.out_normalizer.method,
                        tr.out_normalizer.dim)
    x = x0.double().requires_grad_(True)
    rows = unit_interval_to_minmax(x, assets.mx, assets.mn).reshape(-1, x.shape[-1])
    fields = y_norm.denormalize(siren_film_apply(m64, xn, rows[:, None, :], m64.w0))
    b = x.shape[0]
    misfit = torch.linalg.vector_norm(y.double().reshape(1, -1) - fields.reshape(b, -1), dim=1)
    return torch.autograd.grad(misfit.sum(), x)[0]


def demo_guidance_check(assets, truth, idx, device) -> None:
    """Phase 16d (c): the DPS gradient at the sensor sweep's 1000-sensor
    batch (4 members x 64 rows x 1000 points) on the fused route (SIREN
    forward + dz kernels) and on the plain route, from the same inputs.
    The operator's gradient d misfit / d x0_hat on both routes against
    float64 under phase 4's criterion (max |err| of the kernels <= 2 x the
    plain route's, with phase 7's floor of 1e-6 x max |f64|; relative L2
    error <= 2 x the plain route's + 1e-6); then one
    guided step's gradient with respect to x_prev through the bf16 U-Net,
    fused against plain within GRAD_REL_TOL (phase 6's).  The fused route
    must launch the forward and dz kernels, the plain route neither."""
    n_ens, T, L = 4, assets.n_snap, assets.latent
    coords = assets.full_coords[idx]
    yn = demo_conditional.ynorm_sliced(assets.tr.out_normalizer, idx)
    y = torch.as_tensor(truth[:, idx, :], device=device)
    sampler = create_sampler(steps=1000, noise_schedule="cosine", timestep_respacing="20")
    gen = torch.Generator(device=device).manual_seed(16)
    x_prev = 0.5 * torch.randn((n_ens, 1, T, L), generator=gen, device=device)
    noise = torch.randn((n_ens, 1, T, L), generator=gen, device=device)
    # a late step: at the first steps x0_hat is clamped nearly everywhere
    t = torch.full((n_ens,), 1, dtype=torch.long)
    with torch.no_grad():
        x0 = sampler.diffusion.p_sample(assets.unet, x_prev, t, noise=noise)["pred_xstart"]
    x0 = x0.float()
    op_grads, step_grads = {}, {}
    for use_pallas in (True, False):
        method = demo_conditional.dps_method(assets, coords, yn, use_pallas=use_pallas)
        sd.reset_launch_counts()
        x = x0.clone().requires_grad_(True)
        op_grads[use_pallas] = torch.autograd.grad(method.misfit(x, y).sum(), x)[0]
        x = x_prev.clone().requires_grad_(True)
        out = sampler.diffusion.p_sample(assets.unet, x, t, noise=noise)
        step_grads[use_pallas] = torch.autograd.grad(
            method.misfit(out["pred_xstart"], y).sum(), x)[0]
        torch.cuda.synchronize()
        counts = dict(sd.LAUNCHES)
        launched = counts["siren_decode_forward"] > 0 and counts["siren_decode_dz"] > 0
        log(f"[demo-cond] guidance gradient at {n_ens}x{T} rows x {len(idx)} points, "
            f"use_pallas={use_pallas}: launches {counts}")
        if launched != use_pallas or (not use_pallas and any(counts.values())):
            raise SystemExit(f"the {'fused' if use_pallas else 'plain'} DPS route launched "
                             f"{counts}")
    truth64 = f64_misfit_grad(assets, coords, yn, y, x0)
    err = {k: (g.double() - truth64).abs().max().item() for k, g in op_grads.items()}
    rel = {k: ((g.double() - truth64).norm() / truth64.norm()).item()
           for k, g in op_grads.items()}
    # phase 7's floor, 1e-6 of the largest float64 entry, keeps the
    # max-abs limit meaningful at any gradient scale
    limit = 2 * err[False] + 1e-6 * truth64.abs().max().item()
    rel_limit = 2 * rel[False] + 1e-6
    a, b = step_grads[True], step_grads[False]
    step_rel = ((a - b).norm() / b.norm()).item()
    ok = (err[True] <= limit and rel[True] <= rel_limit and step_rel <= GRAD_REL_TOL
          and torch.isfinite(a).all().item() and b.norm().item() > 0)
    log(f"[demo-cond] d misfit / d x0_hat, kernels vs float64: max |err| {err[True]:.3e} "
        f"(plain {err[False]:.3e}, error / limit {err[True] / limit:.3f}), rel L2 "
        f"{rel[True]:.3e} (plain {rel[False]:.3e}, / limit {rel[True] / rel_limit:.3f}), max "
        f"|f64| {truth64.abs().max().item():.3e}; guided step's grad wrt x_prev through the "
        f"bf16 U-Net, kernels vs plain: rel L2 {step_rel:.3e} (tol {GRAD_REL_TOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the fused DPS route's gradient fails its criterion against float64 "
                         "or the plain route")


def _finite(values) -> bool:
    return bool(np.all(np.isfinite(np.asarray(values, dtype=np.float64))))


def phase_demo_conditional(root, device) -> dict:
    """Phase 16d: ``demo_conditional`` and ``demo_report`` against phase
    16c's f4-width run directory.  (a) ``demo_conditional.main`` on 2
    held-out trajectories, 2 members, 20 steps, scale 1.0, the sweep at 16
    and 1000 sensors, without the prior check, whose stages then run
    alone on trajectory 0: the oracle fit for ``ORACLE_FIT_STEPS`` steps
    (ms a step, peak memory) and one round trip at t* = 15 of 20;
    (b) ``demo_report.main`` with 4 members of 10 steps; (c) the guidance
    gradient check (``demo_guidance_check``); (d) the sweep's two budgets
    again with the counts zeroed before each: the forward and dz kernels
    launch at 1000 sensors and not at 16; ms per guided step at each;
    every stage's wall and each JSON's pooled numbers, all finite, and
    the JAX scripts' keys.  Returns the launch counts of (a) and (b)."""
    run = os.path.join(root, "demo_f4")
    counts = dict.fromkeys(sd.LAUNCHES, 0)
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    rep = demo_conditional.main(DEMO_COND_CUT + ["--out", run])
    synchronize(device)
    cond_s = time.perf_counter() - t0
    for k, v in sd.LAUNCHES.items():
        counts[k] += v
    if not (counts["siren_decode_forward"] > 0 and counts["siren_decode_dz"] > 0):
        raise SystemExit(f"demo_conditional's 1000-sensor sweep launched {counts}")
    timing = rep["device"]["timing"]
    log(f"[demo-cond] demo_conditional.main {' '.join(DEMO_COND_CUT)}: {cond_s:.1f} s, stages "
        f"(s) { {k: round(v, 2) for k, v in timing['stage_s'].items()} }, ms per guided step "
        f"{ {k: round(v, 1) for k, v in timing['guided_step_ms'].items()} }, unguided "
        f"{timing['unconditional_step_ms']:.1f}, peak {timing['peak_gib']:.2f} GiB, SIREN "
        f"launches {counts}")
    pooled = {k: rep[k] for k in ("sensor_rmae_pooled", "sigma3_coverage_pooled",
                                  "field_rmae_held_out", "field_rmae_per_member_held_out",
                                  "field_rmae_unconditional_control", "conditioning_gain",
                                  "spectra_relative_error", "timescale_ratio")}
    log("[demo-cond] pooled: " + json.dumps(pooled))
    log("[demo-cond] sweep: " + json.dumps(rep["sensor_sweep"]))
    numbers = list(pooled.values()) + [v for r in rep["sensor_sweep"] for v in r.values()]
    if not (_finite(numbers) and COND_KEYS | {"device"} == set(rep)):
        raise SystemExit("demo_conditional: non-finite numbers or other keys than the JAX "
                         "script's")

    assets = demo_conditional.load_assets(run, device)
    held = demo_turbulence.simulate_turbulence(
        assets.grid, assets.n_snap, 1, seed=777, **demo_turbulence.FLOW_PRESETS[assets.flow])
    truth = held.reshape(assets.n_snap, -1, 2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z, loss_end, loss_mid = demo_conditional.fit_oracle(assets, truth, ORACLE_FIT_STEPS)
    synchronize(device)
    fit_ms = (time.perf_counter() - t0) * 1e3 / ORACLE_FIT_STEPS
    fit_gib = torch.cuda.max_memory_allocated() / 2**30
    x0 = torch.as_tensor(minmax_to_unit_interval(
        z.cpu().numpy(), assets.mx, assets.mn), device=device)[None, None]
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                          timestep_respacing="20")
    t0 = time.perf_counter()
    img = demo_conditional.roundtrip(assets, diffusion, x0, 15,
                                     torch.Generator(device).manual_seed(50))
    synchronize(device)
    rt_s = time.perf_counter() - t0
    rt_rel = ((img - x0).norm() / x0.norm()).item()
    log(f"[demo-cond] oracle fit alone on trajectory 0 ({assets.n_snap} rows x "
        f"{assets.grid ** 2} points, {ORACLE_FIT_STEPS} steps, not the script's "
        f"{demo_conditional.N_FIT}): {fit_ms:.2f} ms a step, peak {fit_gib:.2f} GiB, loss at "
        f"step {ORACLE_FIT_STEPS // 2} {loss_mid:.4e}, at the end {loss_end:.4e}; round trip "
        f"to t* = 15 of 20 and back {rt_s:.2f} s, latent rel L2 {rt_rel:.3f}")
    if not _finite([fit_ms, loss_end, loss_mid, rt_rel]):
        raise SystemExit("oracle fit or round trip not finite")

    sd.reset_launch_counts()
    t0 = time.perf_counter()
    rrep = demo_report.main(["--out", run, "--n-gen", "4", "--sample-steps", "10"])
    synchronize(device)
    report_s = time.perf_counter() - t0
    for k, v in sd.LAUNCHES.items():
        counts[k] += v
    scalars = {k: v for k, v in rrep.items() if k not in ("run_dir", "device")}
    log(f"[demo-report] demo_report.main --n-gen 4 --sample-steps 10: {report_s:.1f} s, stages "
        f"(s) { {k: round(v, 2) for k, v in rrep['device']['timing']['stage_s'].items()} }, "
        f"{rrep['device']['timing']['sample_step_ms']:.1f} ms a sampling step; "
        + json.dumps(scalars))
    numbers = (rrep["cnf_rmae"] + rrep["spectra_error_ci95"] + rrep["timescale_ratio_ci95"]
               + list(rrep["velocity_pdf_js_divergence"].values())
               + [rrep[k] for k in ("spectra_relative_error", "timescale_ratio",
                                    "two_point_correlation_error")])
    if not (_finite(numbers) and REPORT_KEYS | {"device"} == set(rrep)):
        raise SystemExit("demo_report: non-finite numbers or other keys than the JAX "
                         "script's")

    idx16, idx1000 = demo_conditional.sweep_indices(assets.grid, (16, 1000), 777)
    demo_guidance_check(assets, truth, idx1000, device)
    for idx in (idx16, idx1000):
        sd.reset_launch_counts()
        row, ms = demo_conditional.sweep_sensors(assets, truth, idx, "ps", 1.0, 20, 316)
        synchronize(device)
        run_counts = dict(sd.LAUNCHES)
        fused = len(idx) * 4 * assets.n_snap > FUSED_MIN_PAIRS
        log(f"[demo-cond] sweep alone at {len(idx)} sensors (4 x {assets.n_snap} rows, "
            f"{'fused' if fused else 'plain'} route): {ms:.1f} ms a guided step, launches "
            f"{run_counts}, field rMAE {row['field_rmae']:.4f}")
        launched = run_counts["siren_decode_forward"] > 0 and run_counts["siren_decode_dz"] > 0
        if launched != fused or (not fused and any(run_counts.values())):
            raise SystemExit(f"the sweep at {len(idx)} sensors launched {run_counts}")
    del assets
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 17: multi-device (the data mesh over torch.distributed, ring attention)
# ---------------------------------------------------------------------------

MESH_RANKS = 2
# the spawned ranks' limit: they build nothing (phase 2 did) and run about a
# minute; a hung collective ends at the process group's own timeout first
RANK_JOIN_S = 600
RANK_GROUP_TIMEOUT = datetime.timedelta(minutes=5)
# the diffusion step's inputs: phase 11's t, unit weights and seeded x0 and noise
DIFF_T = (3, 120, 250, 400, 555, 700, 850, 999)
# the ensembles' guided steps: phase 5's 1000 steps respaced to 5, not 10
# (one process runs each ensemble twice, once one ulp up, before the ranks)
MULTI_RESPACING = "5"


def _rel(a, b) -> float:
    """Relative L2 of ``a`` against ``b`` (0 when both are zero)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    den = b.norm().item()
    return (a - b).norm().item() / den if den else (a - b).norm().item()


def allreduce_ms(tensors, mesh) -> float:
    """Synchronized wall ms of one all-reduce of copies of ``tensors`` over
    ``mesh`` (a step's gradient all-reduce, timed alone after a barrier),
    median of 3; 0 without a mesh."""
    if mesh is None:
        return 0.0
    copies = [t.detach().clone() for t in tensors]
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        pmesh.barrier(mesh)
        t0 = time.perf_counter()
        pmesh.all_reduce_mean_(copies, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cnf_run(recipe: str) -> dict:
    """``cli.train_cnf.main`` on ``recipe`` with the first gradient of each
    optimizer recorded just before its step (the latent table's at batch
    0, the decoder's summed epoch-0 gradient at epoch 1), the epochs'
    losses, the launches, then one more epoch timed, and the all-reduces
    of a batch step (the latent table's; the decoder's, once an epoch)
    timed alone."""
    from confild_tpu_torch.train import cnf_trainer
    grads, losses = {}, []
    adam_step, run_epoch = cnf_trainer._adam_step, CNFTrainer._run_epoch

    def recording_step(opt, schedule):
        params = opt.param_groups[0]["params"]
        name = "latents" if len(params) == 1 else "decoder"
        grads.setdefault(name, [p.grad.detach().cpu().clone() for p in params])
        adam_step(opt, schedule)

    def recording_epoch(self, perm, epoch, fix_nf):
        losses.append(run_epoch(self, perm, epoch, fix_nf))
        return losses[-1]
    cnf_trainer._adam_step, CNFTrainer._run_epoch = recording_step, recording_epoch
    try:
        sd.reset_launch_counts()
        trainer = train_cnf.main([recipe])
        torch.cuda.synchronize()
    finally:
        cnf_trainer._adam_step, CNFTrainer._run_epoch = adam_step, run_epoch
    counts = dict(sd.LAUNCHES)
    bs = trainer.hp.batch_size
    n_batches = trainer.N_samples // bs
    perm = np.arange(n_batches * bs).reshape(n_batches, bs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer._run_epoch(perm, 2, False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_batches
    allreduce = (allreduce_ms([trainer.state.latents], trainer.mesh)
                 + allreduce_ms(list(trainer.model.parameters()), trainer.mesh) / n_batches)
    out = {"grads": grads, "losses": losses, "counts": counts, "ms": ms,
           "allreduce_ms": allreduce,
           "mesh": None if trainer.mesh is None else trainer.mesh.size}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def diffusion_inputs(device, size: int):
    """Phase 11's draws: a seeded global batch of 8 ``size``^2 images, its
    noise, ``DIFF_T`` and unit weights."""
    gen = torch.Generator(device=device).manual_seed(21)
    x0 = torch.rand((8, 1, size, size), generator=gen, device=device) * 2 - 1
    return x0, torch.tensor(DIFF_T), torch.ones(8), torch.randn(x0.shape, generator=gen,
                                                                device=device)


def diffusion_loop(root, device, mesh):
    """The Case4 U-Net of ``recipes/diffusion/case4.yml`` (flash forced,
    phase 5's seeded weights) in a ``TrainLoop`` of global batch 8 over
    ``mesh``."""
    with open(RECIPE_DIFFUSION) as f:
        recipe = dict(yaml.safe_load(f), use_flash_attention=True)
    model, diffusion = train_diffusion.build_model_and_diffusion(cfgmod.Config(recipe))
    model.load_state_dict(torch.load(os.path.join(root, "ema.pt"), weights_only=True))
    return TrainLoop(model=model, diffusion=diffusion, data=None, batch_size=8,
                     lr=float(recipe["lr"]), save_dir=os.path.join(root, "multi_diffusion"),
                     mesh=mesh, device=device)


def diffusion_run(root, device, mesh) -> dict:
    """One step on the seeded global batch: loss, every gradient before the
    optimizer, the flash launches; then two steps timed, and the all-reduce
    of the U-Net's gradients timed alone (DDP runs it in buckets during
    the backward)."""
    loop = diffusion_loop(root, device, mesh)
    inputs = diffusion_inputs(device, loop.model.cfg.image_size)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    metrics = loop.train_step(*inputs)
    torch.cuda.synchronize()
    out = {"loss": metrics["loss"], "counts": dict(fa.LAUNCHES),
           "grads": {n: p.grad.detach().cpu() for n, p in loop.model.named_parameters()}}
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.train_step(*inputs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = step_ms
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["allreduce_ms"] = allreduce_ms(loop.params, mesh)
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dps_run(recipe: str) -> dict:
    sd.reset_launch_counts()
    out = sample_conditional.main([recipe])
    torch.cuda.synchronize()
    return {**out, "counts": dict(sd.LAUNCHES)}


def multi_cases(root) -> dict:
    """Recipes of phase 17's main paths, for one process (``one``) and for
    the ranks of (b) (``gloo``) and of (c) (``nccl``), on separate save
    paths: the CNF case of phase 9
    (8 snapshots x 262144 points, batch 4, 2 epochs, ``multiGPU: 2``) and
    the DPS CLI of phase 5 with a 2-member ensemble at 10 and 1024
    sensors (``MULTI_RESPACING`` guided steps); and for one process the
    same ensemble with every U-Net weight one float32 ulp up (``ulp``),
    which measures how far the guided trajectory carries a rounding
    difference."""
    cnf = os.path.join(root, "multi_cnf")
    with open(write_training_case(cnf, n_snapshots=8, points=262144, epochs=2)) as f:
        base = yaml.safe_load(f)
    ema = torch.load(write_assets(root, 10)["ema_path"], weights_only=True)
    ema_ulp = os.path.join(root, "ema_ulp.pt")
    torch.save({k: torch.nextafter(v, torch.full_like(v, float("inf"))) for k, v in ema.items()},
               ema_ulp)
    cases = {}
    for side in ("one", "gloo", "nccl", "ulp"):
        cases[f"cnf_{side}"] = _write_yaml(
            os.path.join(cnf, f"case_{side}.yml"),
            dict(base, multiGPU=MESH_RANKS, save_path=os.path.join(cnf, f"run_{side}")))
        for n_sensors in (10, 1024):
            recipe = dict(write_assets(root, n_sensors), no_of_samples=MESH_RANKS,
                          timestep_respacing=MULTI_RESPACING,
                          save_path=os.path.join(root, f"multi_{side}_{n_sensors}.npy"))
            if side == "ulp":
                recipe["ema_path"] = ema_ulp
            cases[f"dps{n_sensors}_{side}"] = _write_yaml(
                os.path.join(root, f"multi_dps{n_sensors}_{side}.yml"), recipe)
    return cases


def ring_block_check(mesh, device) -> None:
    """Phase 17c: the xl recipe's first attention block (9216 tokens, 256
    channels in 4 heads, batch 4) of a U-Net over ``mesh``, through the
    ring, against the same block's dense route: output and gradients
    within a relative L2 of 1e-5 (float32 both, sums in another order)."""
    with open(RECIPE_XL) as f:
        xl = yaml.safe_load(f)
    model = tunet.create_model(**{k: xl[k] for k in (
        "image_size", "num_channels", "num_res_blocks", "num_heads", "num_head_channels",
        "attention_resolutions", "channel_mult")}, use_flash_attention=False,
        sequence_parallel_mesh=mesh)
    block = next(m for m in model.modules() if isinstance(m, tunet.AttentionBlock))
    torch.manual_seed(3)
    block = block.to(device)
    for p in block.parameters():
        torch.nn.init.normal_(p, std=0.05)
    x = torch.randn((4, block.spec.ch, 96, 96), device=device)
    g = torch.randn_like(x)
    res = {}
    for route, seq_mesh in (("ring", mesh), ("dense", None)):
        block.seq_mesh = seq_mesh
        block.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        out = block(xi)
        (out * g).sum().backward()
        torch.cuda.synchronize()
        res[route] = [out.detach(), xi.grad, *(p.grad for p in block.parameters())]
    worst = max(_rel(a, b) for a, b in zip(res["ring"], res["dense"]))
    log(f"[multi] (c) rank {pmesh.process_index()}: the xl recipe's 9216-token block over "
        f"{mesh.size} ranks, ring vs dense: worst relative L2 over the output and gradients "
        f"{worst:.3e} (tol 1e-5)")
    if not worst <= 1e-5:
        raise SystemExit("the U-Net's ring route disagrees with its dense route")


def rank_main(rank, world, backend, store, root, cases):
    """One spawned rank of phase 17 (b) or (c): on ``cuda:0`` over gloo for
    (b), on ``cuda:<rank>`` over NCCL for (c); saves its results beside
    ``root``."""
    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    # the CLIs take this rank's card from LOCAL_RANK, as under torchrun
    os.environ["LOCAL_RANK"] = str(device.index)
    try:
        device = pmesh.initialize_distributed(device, backend=backend,
                                              init_method=f"file://{store}",
                                              world_size=world, rank=rank,
                                              timeout=RANK_GROUP_TIMEOUT)
        out = {"cnf": cnf_run(cases[f"cnf_{backend}"]),
               "diffusion": diffusion_run(root, device, pmesh.get_mesh())}
        out.update({f"dps{n}": dps_run(cases[f"dps{n}_{backend}"]) for n in (10, 1024)})
        if backend == "nccl":
            ring_block_check(pmesh.get_mesh(), device)
        torch.save(out, os.path.join(root, f"multi_{backend}_rank{rank}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn_ranks(root, cases, backend: str) -> list[dict]:
    """``MESH_RANKS`` spawned ranks of ``rank_main``, each joined within
    ``RANK_JOIN_S``; a rank that fails, or is still running, fails the
    phase (the others are ended)."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(root, f"multi_{backend}_store")
    procs = [ctx.Process(target=rank_main, args=(r, MESH_RANKS, backend, store, root, cases))
             for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_JOIN_S
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    if alive or any(p.exitcode for p in procs):
        raise SystemExit(f"phase 17 ranks over {backend}: exit codes "
                         f"{[p.exitcode for p in procs]} (None: still running at "
                         f"{RANK_JOIN_S} s)")
    return [torch.load(os.path.join(root, f"multi_{backend}_rank{r}.pt"), weights_only=False)
            for r in range(MESH_RANKS)]


def compare_ranks(label: str, backend: str, ranks: list[dict], one: dict, root) -> dict:
    """Each rank against the one-process run on the same global batches:
    gradients before the optimizer and losses within a relative L2 of
    1e-5 (the losses also at rtol 1e-5; a U-Net gradient within 1e-5 of
    its norm plus 1e-6 of the largest one's, for gradients that are zero up
    to rounding), the DPS ensembles' fields within 1e-4 where both sides
    take the same operator route (else phase 16d's ``GRAD_REL_TOL``) or 10x
    their move under a one-ulp change of the U-Net's weights, the larger,
    every path's kernels launched on every rank.
    Returns the launches summed over the ranks."""
    tol = 1e-5
    ok, launches = True, {}
    for r, res in enumerate(ranks):
        cnf, diff = res["cnf"], res["diffusion"]
        worst_cnf = max(_rel(a, b) for k in ("latents", "decoder")
                        for a, b in zip(cnf["grads"][k], one["cnf"]["grads"][k]))
        loss_cnf = _rel(cnf["losses"], one["cnf"]["losses"])
        # per tensor, with a floor of 1e-6 of the largest gradient's norm for
        # the gradients that are zero up to rounding
        largest = max(g.norm().item() for g in one["diffusion"]["grads"].values())
        worst_diff, worst_name = max(
            ((diff["grads"][n] - g).norm().item() / (g.norm().item() + 0.1 * largest), n)
            for n, g in one["diffusion"]["grads"].items())
        loss_diff = _rel(diff["loss"], one["diffusion"]["loss"])
        good = (cnf["mesh"] == MESH_RANKS and max(worst_cnf, loss_cnf, worst_diff, loss_diff) <= tol
                and np.allclose(cnf["losses"], one["cnf"]["losses"], rtol=tol, atol=0)
                and np.isclose(diff["loss"], one["diffusion"]["loss"], rtol=tol, atol=0)
                and cnf["counts"]["siren_decode_forward"] > 0
                and cnf["counts"]["siren_decode_bwd"] > 0
                and all(v > 0 for v in diff["counts"].values()))
        log(f"[multi] ({label}) rank {r}: CNF on a {cnf['mesh']}-rank mesh, epoch losses "
            f"{[round(x, 6) for x in cnf['losses']]} (one process "
            f"{[round(x, 6) for x in one['cnf']['losses']]}, rel L2 {loss_cnf:.3e}), worst "
            f"gradient rel L2 {worst_cnf:.3e}, SIREN launches {cnf['counts']}, ms per batch "
            f"step {cnf['ms']:.1f} (one process {one['cnf']['ms']:.1f}), its all-reduces "
            f"alone {cnf['allreduce_ms']:.2f} ms ({cnf['allreduce_ms'] / cnf['ms']:.1%}); "
            f"diffusion loss "
            f"{diff['loss']:.6f} (one process {one['diffusion']['loss']:.6f}, rel {loss_diff:.3e}), "
            f"worst gradient rel L2 {worst_diff:.3e} ({worst_name}) over {len(diff['grads'])} "
            f"tensors, flash "
            f"launches {diff['counts']}, ms per step {[round(x, 1) for x in diff['ms']]} (one "
            f"process {[round(x, 1) for x in one['diffusion']['ms']]}), the all-reduce of "
            f"its gradients alone {diff['allreduce_ms']:.1f} ms "
            f"({diff['allreduce_ms'] / np.median(diff['ms']):.1%} of a step), peak "
            f"{diff['peak_gib']:.2f} GiB -> {'ok' if good else 'FAIL'}")
        ok &= good
        for key in ("cnf", "diffusion", "dps10", "dps1024"):
            for k, v in res[key]["counts"].items():
                launches[k] = launches.get(k, 0) + v
    for n_sensors in (10, 1024):
        key, ref = f"dps{n_sensors}", one[f"dps{n_sensors}one"]
        got, want, ulp = (np.load(os.path.join(root, f"multi_{side}_{n_sensors}.npy"))
                          for side in (backend, "one", "ulp"))
        routes = {"one process": ref["fused"],
                  **{f"rank {r}": res[key]["fused"] for r, res in enumerate(ranks)}}
        # a rank's batch of one member runs other cuDNN and cuBLAS algorithms
        # than one process's batch of two, and the guided trajectory carries a
        # rounding difference far (1/sqrt(alpha_bar) in x0_hat, the w0 = 30
        # decoder): the limit is 1e-4 or 10x the one-process ensemble's own
        # move under a one-ulp change of every U-Net weight, the larger
        drift = _rel(torch.from_numpy(ulp), torch.from_numpy(want))
        limit = max(1e-4 if len(set(routes.values())) == 1 else GRAD_REL_TOL, 10 * drift)
        err = _rel(torch.from_numpy(got), torch.from_numpy(want))
        good = got.shape == want.shape and np.isfinite(got).all() and err <= limit
        log(f"[multi] ({label}) DPS ensemble of {MESH_RANKS} at {n_sensors} sensors, one member "
            f"a rank: fields {got.shape}, rel L2 against one process {err:.3e} (limit "
            f"{limit:.3e}; one process with every U-Net weight one ulp up: {drift:.3e}); "
            f"operator route (kernels?) {routes}; SIREN launches per rank "
            f"{[res[key]['counts'] for res in ranks]}, ms per guided step per rank "
            f"{[round(res[key]['sample_s'] * 1e3 / res[key]['steps'], 1) for res in ranks]} "
            f"(one process {ref['sample_s'] * 1e3 / ref['steps']:.1f}) -> "
            f"{'ok' if good else 'FAIL'}")
        ok &= good
    if not ok:
        raise SystemExit(f"phase 17 ({label}): the ranks disagree with one process")
    return launches


def one_rank_check(root, device) -> dict:
    """Phase 17a, in this process, last: a 1-rank NCCL group (file store);
    ``CNFTrainer`` (phase 9's case, 1 epoch) and ``TrainLoop`` (phase 12's
    U-Net, flash forced, 1 step) with ``get_mesh(1)`` bitwise equal to
    ``mesh=None`` (cuDNN's deterministic algorithms on for both); then
    ``ring_attention`` over the one rank at (16, 9216, 64) against phase
    10's float64 attention under phase 10's criterion.  Returns the mesh
    runs' launches."""
    store = os.path.join(root, "multi_nccl1_store")
    deterministic = torch.backends.cudnn.deterministic
    torch.distributed.init_process_group("nccl", init_method=f"file://{store}", world_size=1,
                                         rank=0, timeout=RANK_GROUP_TIMEOUT)
    torch.backends.cudnn.deterministic = True
    launches = {}
    try:
        mesh = pmesh.get_mesh(1)
        recipe = write_training_case(os.path.join(root, "multi_one_rank"), n_snapshots=8,
                                     points=262144, epochs=1)
        states = {}
        for name, m in (("none", None), ("mesh", mesh)):
            sd.reset_launch_counts()
            trainer = CNFTrainer(cfgmod.basic_input(recipe, save_path=os.path.join(
                root, "multi_one_rank", name)), device=device, mesh=m)
            trainer.init_state(seed=0)
            trainer.train(log_formats=())
            torch.cuda.synchronize()
            states[name] = [trainer.state.latents.detach().clone(),
                            *(p.detach().clone() for p in trainer.model.parameters()),
                            *(p.grad.clone() for p in trainer.model.parameters())]
            if m is not None:
                launches = dict(sd.LAUNCHES)
            del trainer
        cnf_equal = all(torch.equal(a, b) for a, b in zip(states["none"], states["mesh"]))
        del states
        runs = {}
        for name, m in (("none", None), ("mesh", mesh)):
            loop = diffusion_loop(root, device, m)
            fa.reset_launch_counts()
            metrics = loop.train_step(*diffusion_inputs(device, loop.model.cfg.image_size))
            torch.cuda.synchronize()
            runs[name] = (metrics["loss"], [p.grad.clone() for p in loop.params],
                          [p.detach().clone() for p in loop.params])
            if m is not None:
                launches.update(fa.LAUNCHES)
            del loop
            gc.collect()
            torch.cuda.empty_cache()
        diff_equal = (runs["none"][0] == runs["mesh"][0] and all(
            torch.equal(a, b) for i in (1, 2) for a, b in zip(runs["none"][i], runs["mesh"][i])))
        del runs
        log(f"[multi] (a) 1 rank over NCCL, get_mesh(1) against mesh=None: CNFTrainer 1 epoch "
            f"(latents, decoder, its gradient sum) bitwise equal {cnf_equal}; TrainLoop 1 step "
            f"(loss, gradients, parameters) bitwise equal {diff_equal}; launches {launches}")
        if not (cnf_equal and diff_equal):
            raise SystemExit("a 1-rank mesh does not reproduce the single-process run bitwise")

        q, k, v, g = flash_case(device, 16, 9216, 64, torch.float32, seed=17)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = ring_attention(*leaves, mesh)
        (out * g).sum().backward()
        ring = {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
                "dv": leaves[2].grad}
        del out, leaves
        p_out, p_lse = fa.flash_forward_plain(q, k, v)
        plain = dict(zip(("dq", "dk", "dv"), fa.flash_backward_plain(q, k, v, p_out, p_lse, g)),
                     out=p_out)
        truth = f64_attention(q, k, v, g)
        torch.cuda.synchronize()
        ok = True
        for name, r in ring.items():
            want = truth[name]
            err_r = (r.double() - want).abs().max().item()
            err_p = (plain[name].double() - want).abs().max().item()
            limit = 2 * err_p + 1e-6 * want.abs().max().item()
            good = err_r <= limit and torch.isfinite(r).all().item()
            ok &= good
            log(f"[multi] (a) ring_attention over 1 rank (16, 9216, 64) {name}: |ring-f64| "
                f"{err_r:.3e}, |plain-f64| {err_p:.3e}, error / limit {err_r / limit:.3f} -> "
                f"{'ok' if good else 'FAIL'}")
        if not ok:
            raise SystemExit("ring attention fails phase 10's float64 criterion")
        del ring, plain, truth, q, k, v, g
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def one_process_runs(root, device, cases) -> dict:
    """Phase 17's references: each path in this process, without a mesh."""
    one = {"cnf": cnf_run(cases["cnf_one"]), "diffusion": diffusion_run(root, device, None),
           **{f"dps{n}{side}": dps_run(cases[f"dps{n}_{side}"])
              for n in (10, 1024) for side in ("one", "ulp")}}
    if one["cnf"]["mesh"] is not None:
        raise SystemExit("multiGPU: 2 in one process did not train on one device")
    gc.collect()
    torch.cuda.empty_cache()
    return one


def phase_multidevice(root, device) -> dict:
    """Phase 17: (b) two spawned ranks on this card over gloo, then (c)
    over NCCL with a card a rank where there are two cards, each held
    against one process on the same global batches; then (a) in this
    process.  Returns the ranks' and (a)'s mesh runs' launches."""
    cases = multi_cases(root)
    one = one_process_runs(root, device, cases)
    launches = compare_ranks("b", "gloo", spawn_ranks(root, cases, "gloo"), one, root)
    if torch.cuda.device_count() >= MESH_RANKS:
        for k, v in compare_ranks("c", "nccl", spawn_ranks(root, cases, "nccl"), one,
                                  root).items():
            launches[k] = launches.get(k, 0) + v
    else:
        log(f"[multi] (c) not run: {torch.cuda.device_count()} card visible; NCCL puts one "
            f"rank on each card, and (c) needs {MESH_RANKS}")
    for k, v in one_rank_check(root, device).items():
        launches[k] = launches.get(k, 0) + v
    return launches



# ---------------------------------------------------------------------------
# phase 18: the decoder zoo and the classifier
# ---------------------------------------------------------------------------

# the auto-decoders the CNF trainer takes (plain route), then the FiLM
# decoder, which must still take the kernels
ZOO_TRAINED = ("SIREN_rez_Autodecoder_film", "SIRENAutodecoder_tw_film", "FNAutodecoder_film",
               "GNAutodecoder_film", "SIRENAutodecoder_fp", "SIRENAutodecoder_mdf_film")
# Case4's 262144 points a snapshot cut to a quarter: plain autograd keeps
# every layer's activations (about 13 GB at 4 x 65536 for the 16-layer
# decoders, twice that for the residual one)
ZOO_POINTS = 65536
# the learning rates of phase 18's CNF runs: the published ones (nf 1e-4,
# latents 1e-5) raise the loss at the decoder's first Adam step on a fresh
# decoder (phase 9's FiLM run: 0.557, 0.568, 0.559), so 3 epochs cannot show
# training; a tenth of the decoder's rate and 100 times the latents' fall
# from the first step for every zoo decoder (the CPU at 4096 points)
ZOO_LR = {"nf": 1e-5, "latents": 1e-3}
# the two hypernetwork decoders at 3 hidden layers instead of Case4's 15:
# their output layer holds every SIREN weight (0.85 G parameters at 15
# layers, 0.17 G at 3); at 15 their host-side init, float64 checks and
# 10 GB checkpoints took 70-80 s more of phase 18, and the script 1235 s
# on an H100 host that built the kernels in 101 s, over its time limit
ZOO_DEPTH = {"SIRENAutodecoder_fp": 3, "SIRENAutodecoder_mdf_film": 3}
# the f32-vs-f64 check of every registry decoder: rows x points
ZOO_CHECK = (2, 4096)
ZOO_REL_TOL = 1e-4
# upstream guided-diffusion's published 256x256 classifier (the JAX CLI's and
# create_classifier's defaults), 2 classes, batch 32, 10 steps
CLASSIFIER_RECIPE = dict(image_size=256, classifier_width=128, classifier_depth=2,
                         classifier_attention_resolutions="32,16,8", out_channels=2,
                         batch_size=32, lr=3e-4, weight_decay=0.05, lr_anneal_steps=10,
                         noised=True, steps=1000, noise_schedule="cosine", log_interval=1,
                         save_interval=10)
CLASSIFIER_IMAGES = 64
# create_sr_model's (large_size, small_size, num_channels, num_res_blocks)
SR_MODEL = (256, 64, 128, 2)
# the Case4 U-Net's widths at 256^2, class-conditional
CLASS_COND_UNET = dict(image_size=256, num_channels=128, num_res_blocks=2, num_heads=4,
                       num_head_channels=64, attention_resolutions="32,16,8",
                       channel_mult="1,1,2,2,4,4", class_cond=True, num_classes=2)


def _nf_kwargs_case4(name) -> dict:
    """Case4's decoder widths for any registry name (the autoencoders encode
    64 prior features through a 2 x 384 sine MLP into the 384 latent)."""
    if name.startswith("SIRENAutoencoder"):
        return dict(hyper_in_features=64,
                    hyper_latent_features=CASE4_CNF["in_latent_features"],
                    hyper_num_hidden_layers=2,
                    hyper_hidden_features=CASE4_CNF["hidden_features"],
                    nf_in_features=4 if name.endswith("extra_in") else 3, out_features=3,
                    nf_num_hidden_layers=CASE4_CNF["num_hidden_layers"],
                    nf_hidden_features=CASE4_CNF["hidden_features"])
    kw = {k: v for k, v in CASE4_CNF.items() if k != "w0"}
    if name.endswith("extra_in"):
        kw["in_coord_features"] = 4
    return kw


def _perturb_(model, seed: int, scale: float = 0.02):
    """Every parameter plus seeded noise: the zero-initialised layers would
    make a random U-Net's output and gradients trivial."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen).to(p.device))
    return model


def _as_float64(model):
    """A float64 copy of a U-Net-family module, its torso dtype too (the
    torso casts its input to ``cfg.torso_dtype``)."""
    m = copy.deepcopy(model).double()
    m.zero_grad(set_to_none=True)
    m.cfg = dataclasses.replace(m.cfg, torso_dtype=torch.float64)
    return m


def zoo_train(root, name, recipe, lr: dict = ZOO_LR) -> dict:
    """``cli.train_cnf`` on ``recipe`` with ``NF.name`` set to ``name`` and
    learning rates ``lr``: 2 epochs, then a 1-epoch resume; launches
    counted (zeroed before each run, read after), ms per batch step, peak
    memory."""
    hp = cfgmod.basic_input(recipe)
    spec = dict(hp.NF)
    spec["name"] = name
    if name in ZOO_DEPTH:
        spec["num_hidden_layers"] = ZOO_DEPTH[name]
    path = _write_yaml(os.path.join(root, f"{name}.yml"), {
        **hp.to_dict(), "NF": spec, "save_path": os.path.join(root, name), "epochs": 2,
        "keep_checkpoints": 1, "lr": lr})
    torch.cuda.reset_peak_memory_stats()
    sd.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = train_cnf.main([path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**sd.LAUNCHES, **fa.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    w0_moved = (None if name != "SIRENAutodecoder_tw_film"
                else float(trainer.model.w0.detach()) - CASE4_CNF["w0"])
    losses, epoch_s = [], []

    save_s = []

    def read_progress():          # each run rewrites progress.csv
        with open(os.path.join(root, name, "progress.csv")) as f:
            rows = list(csv.DictReader(f))
        losses.extend(float(r["loss"]) for r in rows if r.get("loss"))
        epoch_s.extend(float(r["wait_train_chunk"]) for r in rows if r.get("wait_train_chunk"))
        save_s.extend(float(r["wait_save"]) for r in rows if r.get("wait_save"))
    read_progress()
    _write_yaml(path, {**cfgmod.basic_input(path).to_dict(), "epochs": 1})
    sd.reset_launch_counts()
    fa.reset_launch_counts()
    resumed = train_cnf.main([path])
    torch.cuda.synchronize()
    for k, v in {**sd.LAUNCHES, **fa.LAUNCHES}.items():
        counts[k] += v
    read_progress()
    n_batches = trainer.N_samples // hp.batch_size
    step_ms = [s * 1e3 / n_batches for s in epoch_s]
    log(f"[zoo] {name}: {sum(p.numel() for p in trainer.model.parameters()) / 1e6:.1f} M "
        f"parameters, losses {[round(x, 6) for x in losses]} (2 epochs, then the resume's), "
        f"ms per batch step {[round(x, 1) for x in step_ms]}, checkpoints "
        f"{[round(x, 1) for x in save_s]} s, CLI wall {wall:.1f} s, peak "
        f"{peak:.2f} GiB, launches {counts}"
        + ("" if w0_moved is None else f", w0 moved by {w0_moved:.3e}"))
    if not (len(losses) == 3 and np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"{name}: the losses are not finite and falling: {losses}")
    if resumed.state.epoch != trainer.state.epoch:
        raise SystemExit(f"{name}: the resume did not continue the epoch count")
    if w0_moved is not None and w0_moved == 0.0:
        raise SystemExit("tw_film's trainable w0 did not move")
    return {"trainer": resumed, "counts": counts, "step_ms": step_ms, "peak": peak,
            "path": path}


def zoo_check(name, model, device, seed) -> None:
    """``model``'s forward and its input gradient (``sum(out * g)`` with
    respect to the coordinates and the latents, or the priors) in float32
    against the same module in float64, on the card: relative L2."""
    rows, points = ZOO_CHECK
    gen = torch.Generator(device).manual_seed(seed)
    coords = torch.rand((rows, points, 3), generator=gen, device=device) * 2 - 1
    if name.startswith("SIRENAutoencoder"):
        second = torch.randn((rows, 1, 64), generator=gen, device=device)
    elif name == "SIRENAutodecoder_film_single":
        second = None
    else:
        second = 0.1 * torch.randn((rows, 1, CASE4_CNF["in_latent_features"]), generator=gen,
                                   device=device)
    extra = torch.rand((rows, 1, 1), generator=gen, device=device) if name.endswith(
        "extra_in") else None
    res = {}
    for dtype in (torch.float32, torch.float64):
        m = model if dtype == torch.float32 else copy.deepcopy(model).double()
        c = coords.to(dtype).detach().requires_grad_(True)
        z = None if second is None else second.to(dtype).detach().requires_grad_(True)
        inp = c if extra is None else (c, extra.to(dtype))
        outs = m(inp, z) if z is not None else m(inp)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = [torch.randn(o.shape, generator=torch.Generator(device).manual_seed(seed + i),
                         device=device).to(dtype) for i, o in enumerate(outs)]
        leaves = [c] if z is None else [c, z]
        grads = torch.autograd.grad(sum((o * gi).sum() for o, gi in zip(outs, g)), leaves)
        res[dtype] = [o.detach() for o in outs] + [gr.detach() for gr in grads]
        del m
    errs = [rel_l2(a, b) for a, b in zip(res[torch.float32], res[torch.float64])]
    log(f"[zoo-f64] {name}: rel L2 vs float64 of the outputs and the input gradients "
        f"{[f'{e:.2e}' for e in errs]} (tol {ZOO_REL_TOL})")
    if not all(np.isfinite(e) and e <= ZOO_REL_TOL for e in errs):
        raise SystemExit(f"{name}: float32 disagrees with float64")


def phase_zoo(root, device) -> dict:
    """(a) every auto-decoder of the zoo through ``cli.train_cnf`` at Case4
    widths, ``cli.eval_cnf`` on one zoo checkpoint, the FiLM decoder on the
    same recipe through the kernels; (b) every registry decoder's forward
    and input gradient against float64 on the card.  Returns the FiLM
    run's launches."""
    from confild_tpu_torch.models.cnf import NF_REGISTRY, create_nf
    zoo = os.path.join(root, "zoo")
    recipe = write_training_case(zoo, n_snapshots=8, points=ZOO_POINTS, epochs=2)
    trained = {}
    for name in ZOO_TRAINED:
        run = zoo_train(zoo, name, recipe)
        if any(run["counts"].values()):
            raise SystemExit(f"{name} launched a kernel: the zoo takes the plain route")
        trained[name] = run
        if name == "SIREN_rez_Autodecoder_film":
            # cli.eval_cnf on its checkpoint: the plain decode, held to the
            # trainer's own decode through CNF_inference
            tr = run["trainer"]
            ck = os.path.join(zoo, name, f"checkpoint_{tr.state.epoch}.pt")
            yml = _write_yaml(os.path.join(zoo, f"{name}_cnf.yml"), {
                k: cfgmod.basic_input(run["path"]).to_dict()[k]
                for k in ("dims", "hidden_size", "NF")})
            t0 = time.perf_counter()
            mse, rmae = eval_cnf.main(["--checkpoint", ck, "--config", yml, "--data",
                                       os.path.join(zoo, "output.npy"), "--coords",
                                       os.path.join(zoo, "coords.npy"), "--batch-size", "4",
                                       "--device", str(device)])
            wall = time.perf_counter() - t0
            inf = CNF_inference(ck, yml, device=device)
            pred = inf.predict(tr.train_coord, [0, 1], batch_size=2)
            want = tr.infer(tr.train_coord, tr.state.latents[:2]).cpu().numpy()
            rel = float(np.linalg.norm(pred - want) / np.linalg.norm(want))
            log(f"[zoo] eval_cnf on {name}'s checkpoint: MSE {mse.tolist()}, rMAE "
                f"{rmae.tolist()}, wall {wall:.1f} s; CNF_inference vs the trainer's decode "
                f"rel L2 {rel:.3e}")
            if not (np.all(np.isfinite(mse)) and np.all(np.isfinite(rmae))
                    and rel <= ZOO_REL_TOL):
                raise SystemExit("eval_cnf on a zoo checkpoint failed")
        run["trainer"] = run["trainer"].model      # keep the decoder only
        shutil.rmtree(os.path.join(zoo, name))     # its checkpoints (2 GB for fp, mdf)
        gc.collect()
        torch.cuda.empty_cache()
    film = zoo_train(zoo, "SIRENAutodecoder_film", recipe)
    missing = [k for k in ("siren_decode_forward", "siren_decode_bwd") if film["counts"][k] == 0]
    if missing:
        raise SystemExit(f"SIRENAutodecoder_film trained without launching {missing}")
    del film["trainer"]
    gc.collect()
    torch.cuda.empty_cache()

    for i, name in enumerate(sorted(NF_REGISTRY)):
        if name in trained:
            model = trained[name]["trainer"]
        else:
            with torch.device(device):      # 0.85 G parameters drawn on the card
                model = create_nf(name, **_nf_kwargs_case4(name))
                model.reset_parameters(torch.Generator(device).manual_seed(100 + i))
        zoo_check(name, model, device, seed=200 + i)
        del model
        trained.pop(name, None)
        gc.collect()
        torch.cuda.empty_cache()
    return {k: film["counts"][k] for k in ("siren_decode_forward", "siren_decode_bwd")}


def write_classifier_case(root) -> str:
    """64 seeded 256 x 256 latent images of 2 classes whose means differ,
    and the published classifier's recipe cut to 10 steps."""
    os.makedirs(root, exist_ok=True)
    size = CLASSIFIER_RECIPE["image_size"]
    rng = np.random.default_rng(size)
    labels = np.arange(CLASSIFIER_IMAGES) % 2
    base = np.sin(np.linspace(0, 8 * np.pi, size))[None, :, None] * rng.uniform(
        0.5, 1.5, size=(CLASSIFIER_IMAGES, 1, 1))
    data = base + (labels[:, None, None] - 0.5) + 0.1 * rng.standard_normal(
        (CLASSIFIER_IMAGES, size, size))
    np.save(os.path.join(root, "latents.npy"), data.astype(np.float32))
    np.save(os.path.join(root, "labels.npy"), labels)
    return _write_yaml(os.path.join(root, "classifier.yml"), {
        **CLASSIFIER_RECIPE, "train_data_path": os.path.join(root, "latents.npy"),
        "label_path": os.path.join(root, "labels.npy"), "log_path": os.path.join(root, "logs")})


def phase_classifier(root, device) -> dict:
    """(c) ``cli.train_classifier`` on the published 256^2 classifier; (d) the
    same classifier with flash attention against the dense build; (e)
    classifier-guided DDPM of a class-conditional Case4-width U-Net; (f)
    ``SuperResModel`` forward and backward against float64.  Returns the
    flash launches of (d)."""
    from confild_tpu_torch.cli import train_classifier
    from confild_tpu_torch.models import unet_extras
    from confild_tpu_torch.train.classifier_trainer import classifier_cond_fn
    recipe = write_classifier_case(os.path.join(root, "classifier"))
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    loop = train_classifier.main([recipe])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(fa.LAUNCHES.values()):
        raise SystemExit("the dense classifier launched a flash kernel")
    with open(os.path.join(root, "classifier", "logs", "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    accs = [float(r["acc"]) for r in rows if r.get("acc")]
    step_ms = []
    for _ in range(3):            # in memory only: the checkpoint stays as written
        x, y = next(loop.data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop.run_step(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    ck = os.path.join(root, "classifier", "logs", "model000010.pt")
    clf = unet_extras.create_classifier(**{k: CLASSIFIER_RECIPE[k] for k in (
        "image_size", "classifier_width", "classifier_depth",
        "classifier_attention_resolutions", "out_channels")})
    clf.load_state_dict(torch.load(ck, weights_only=True))
    clf.to(device).eval().requires_grad_(False)
    size = CLASSIFIER_RECIPE["image_size"]
    log(f"[classifier] {size}^2, batch {CLASSIFIER_RECIPE['batch_size']}: losses "
        f"{[round(v, 4) for v in losses]}, accuracy {accs}, CLI wall {wall:.1f} s for 10 "
        f"steps, ms per step {[round(v, 1) for v in step_ms]}, peak {peak:.2f} GiB; "
        f"{os.path.basename(ck)} read back")
    if not (len(losses) == 10 and np.all(np.isfinite(losses))):
        raise SystemExit(f"classifier training losses: {losses}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the flash build against the dense one: logits and cond_fn's gradient
    flash = unet_extras.EncoderUNetModel(
        dataclasses.replace(clf.cfg, use_flash_attention=True), pool="attention",
        encoder_out_channels=2)
    flash.load_state_dict(clf.state_dict())
    flash.to(device).eval().requires_grad_(False)
    diffusion = create_gaussian_diffusion(steps=1000, noise_schedule="cosine")
    gen = torch.Generator(device).manual_seed(18)
    x0 = torch.as_tensor(np.load(os.path.join(root, "classifier", "latents.npy"))[:4, None],
                         device=device)
    x0 = (x0 - x0.min()) / (x0.max() - x0.min()) * 2 - 1
    ts = torch.tensor([10, 300, 600, 900])
    xt = diffusion.q_sample(x0, ts, torch.randn(x0.shape, generator=gen, device=device))
    y = torch.tensor([0, 1, 0, 1], device=device)
    res = {}
    for label, m in (("dense", clf), ("flash", flash)):
        fa.reset_launch_counts()
        with torch.no_grad():
            logits = m(xt, ts.to(device))
        grad = classifier_cond_fn(m, scale=1.0)(xt, ts.to(device), y=y)
        torch.cuda.synchronize()
        res[label] = (logits, grad, dict(fa.LAUNCHES))
    counts = res["flash"][2]
    errs = (rel_l2(res["flash"][0], res["dense"][0]), rel_l2(res["flash"][1], res["dense"][1]))
    log(f"[classifier-flash] 1024 / 256 / 64 tokens, 64-channel heads, batch 4: logits rel "
        f"L2 {errs[0]:.3e}, cond_fn gradient rel L2 {errs[1]:.3e} (tol {GRAD_REL_TOL}); "
        f"flash launches {counts}, dense {res['dense'][2]}")
    if any(res["dense"][2].values()) or not all(v > 0 for v in counts.values()):
        raise SystemExit("the classifier's flash route did not launch every flash kernel")
    if not all(e <= GRAD_REL_TOL for e in errs):
        raise SystemExit("the classifier's flash route disagrees with the dense route")
    del flash, res
    gc.collect()
    torch.cuda.empty_cache()

    # (e) classifier-guided DDPM, a class-conditional U-Net at Case4 widths
    unet = _perturb_(tunet.create_model(**CLASS_COND_UNET).reset_parameters(
        torch.Generator().manual_seed(19)), 20).to(device).eval().requires_grad_(False)
    guided = create_gaussian_diffusion(steps=1000, noise_schedule="cosine",
                                       timestep_respacing="10")
    cond_fn = classifier_cond_fn(clf, scale=1.0)
    kwargs = {"y": torch.tensor([0, 1, 0, 1], device=device)}
    shape = (4, 1, size, size)
    stamps = []

    def clock(x_t, **_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return x_t
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    out = guided.p_sample_loop(unet, shape, generator=torch.Generator(device).manual_seed(1),
                               cond_fn=cond_fn, model_kwargs=kwargs, step_hook=clock)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = np.diff(stamps) * 1e3
    x = torch.randn(shape, generator=torch.Generator(device).manual_seed(2), device=device)
    tt = torch.full((4,), guided.num_timesteps - 1, dtype=torch.long)
    means = {}
    for dtype in (torch.float32, torch.float64):
        u = unet if dtype == torch.float32 else _as_float64(unet)
        c = clf if dtype == torch.float32 else _as_float64(clf)
        pmv = guided.p_mean_variance(u, x.to(dtype), tt, model_kwargs=kwargs)
        means[dtype] = guided.condition_mean(classifier_cond_fn(c, 1.0), pmv, x.to(dtype), tt,
                                             kwargs)
        del u, c
    err = rel_l2(means[torch.float32], means[torch.float64])
    log(f"[guided] class-conditional U-Net {size}^2 (Case4 widths, 2 classes), batch 4, 10 "
        f"respaced steps under classifier guidance: finite {bool(torch.isfinite(out).all())}, "
        f"ms per guided step {np.median(ms[1:]):.1f} (first {ms[0]:.1f}), peak {peak:.2f} GiB; "
        f"one step's guided mean vs float64 rel L2 {err:.3e} (tol {GRAD_REL_TOL})")
    if not (torch.isfinite(out).all() and err <= GRAD_REL_TOL):
        raise SystemExit("classifier-guided sampling failed")
    del unet, out, means
    gc.collect()
    torch.cuda.empty_cache()

    # (f) SuperResModel: one forward and backward against float64
    sr = _perturb_(unet_extras.create_sr_model(*SR_MODEL).reset_parameters(
        torch.Generator().manual_seed(21)), 22).to(device)
    gen = torch.Generator(device).manual_seed(23)
    large, small = SR_MODEL[:2]
    xs = torch.randn((4, 1, large, large), generator=gen, device=device)
    low = torch.randn((4, 1, small, small), generator=gen, device=device)
    g = torch.randn((4, 1, large, large), generator=gen, device=device)
    ts = torch.tensor([5, 250, 500, 999], device=device)
    res = {}
    for dtype in (torch.float32, torch.float64):
        m = sr if dtype == torch.float32 else _as_float64(sr)
        xi = xs.to(dtype).detach().requires_grad_(True)
        o = m(xi, ts, low_res=low.to(dtype))
        (o * g.to(dtype)).sum().backward()
        res[dtype] = {"out": o.detach(), "dx": xi.grad,
                      **{n: p.grad for n, p in m.named_parameters()}}
    names = [n for n in res[torch.float32] if n not in ("out", "dx")]
    # a conv bias straight before a one-channel-a-group GroupNorm has a zero
    # gradient: each parameter's error is taken against the norm of all
    # parameter gradients
    total = torch.sqrt(sum(res[torch.float64][n].norm() ** 2 for n in names)).item()
    errs = {"out": rel_l2(res[torch.float32]["out"], res[torch.float64]["out"]),
            "dx": rel_l2(res[torch.float32]["dx"], res[torch.float64]["dx"]),
            "params": rel_l2(torch.cat([res[torch.float32][n].flatten() for n in names]),
                             torch.cat([res[torch.float64][n].flatten() for n in names]))}
    worst = max(((res[torch.float32][n] - res[torch.float64][n]).norm().item() / total, n)
                for n in names)
    log(f"[super-res] create_sr_model{SR_MODEL}, batch 4, vs float64: rel L2 of the output "
        f"{errs['out']:.3e}, of dx {errs['dx']:.3e}, of all {len(names)} parameter "
        f"gradients {errs['params']:.3e}, the worst parameter's error over their norm "
        f"{worst[0]:.3e} ({worst[1]}) (tol {GRAD_REL_TOL})")
    if not all(e <= GRAD_REL_TOL for e in (*errs.values(), worst[0])):
        raise SystemExit("SuperResModel disagrees with float64")
    # the same weights with flash on (its one head a block: 512 channels at
    # 256 and 64 tokens, the kernels above 128) against the dense route;
    # the model doubles its config's in_channels for the low-resolution input
    flash_sr = unet_extras.SuperResModel(dataclasses.replace(
        sr.cfg, use_flash_attention=True, in_channels=sr.cfg.in_channels // 2)).to(device)
    flash_sr.load_state_dict(sr.state_dict())
    fa.reset_launch_counts()
    xi = xs.detach().requires_grad_(True)
    o = flash_sr(xi, ts, low_res=low)
    (o * g).sum().backward()
    torch.cuda.synchronize()
    sr_counts = dict(fa.LAUNCHES_WIDE)
    dense = res[torch.float32]
    flash_res = {"out": o.detach(), "dx": xi.grad,
                 **{n: p.grad for n, p in flash_sr.named_parameters()}}
    errs = {"out": rel_l2(flash_res["out"], dense["out"]),
            "dx": rel_l2(flash_res["dx"], dense["dx"]),
            "params": rel_l2(torch.cat([flash_res[n].flatten() for n in names]),
                             torch.cat([dense[n].flatten() for n in names]))}
    log(f"[super-res] the same with use_flash_attention, against the dense route: rel L2 of "
        f"the output {errs['out']:.3e}, of dx {errs['dx']:.3e}, of all parameter gradients "
        f"{errs['params']:.3e} (tol {GRAD_REL_TOL}); launches above 128 {sr_counts}, "
        f"narrow {dict(fa.LAUNCHES)}")
    if not (all(e <= GRAD_REL_TOL for e in errs.values())
            and all(sr_counts.get(f"{k}@D512", 0) > 0 for k in fa.LAUNCHES)):
        raise SystemExit("the super-resolution model's flash route disagrees with its dense "
                         "route or did not launch every flash kernel above 128")
    _add_wide_launches(sr_counts)
    del sr, res, flash_sr, flash_res, dense
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 19: the SIREN kernels at every width a FiLM recipe may ask for, and
# the float32 forward's cluster kernel above H = 512 up to its widest
# ---------------------------------------------------------------------------

# recipes/cnf/case4.yml at the widest decoder the kernels take: 3
# coordinates, 15 hidden layers of 1024, 5 outputs (u, v, w, p, T)
WIDE_NF = dict(hidden_features=1024, out_features=5)
WIDE_CNF = dict(CASE4_CNF, **WIDE_NF)
# (a)'s other decoders, (C_in, C_out, hidden layers, H): six modulated
# layers with Case4's coordinates and WIDE_NF's outputs at the narrowest and
# the widest plan of 3 to 7 blocks above 512 (576: three blocks of 192; 896:
# seven of 128; 640 and 768 were cut for the script's time), 16 coordinates
# and outputs at 1024, 16 outputs at Case4's 384
WIDER_CHECKS = tuple((3, 5, 5, h) for h in (576, 896)) + (
    (16, 16, 5, 1024), (3, 16, 5, 384))
# the timed C = 16 decoders, at 4 x this many points
C16_POINTS = 65536
WIDE_SENSORS = 1000
WIDE_POINTS = 65536
# (b)'s learning rates: phase 18's latents rate; the decoder's a tenth of
# phase 18's, since a first Adam step moves a pre-activation by up to w0 x
# lr x H (at phase 18's 1e-5 the loss rose at H = 1024: 0.7063, 0.7179,
# 0.7239)
WIDE_LR = {"nf": 1e-6, "latents": 1e-3}
# the cluster forward alone at widths no other kernel takes, (C_in, C_out,
# hidden layers, H): six modulated layers, Case4's coordinates, WIDE_NF's
# outputs, up to the widest (sd.MAX_HIDDEN["forward"]); 1536 was cut for
# the script's time (2048 has the same 256-column blocks, eight of them)
CLUSTER_CHECKS = tuple((3, 5, 5, h) for h in (2048, sd.MAX_HIDDEN["forward"]))
# the chain in both modes on shallow decoders, (C_in, C_out, hidden layers,
# H): one modulated layer (no middle weight, no dx product) and two, at
# each pair count of the cluster plans (128 pairs at 640, 64 at the widest;
# 2048 was cut for the script's time)
SHALLOW_CHECKS = tuple((3, 5, layers, h) for h in (640, sd.MAX_HIDDEN["dz"])
                       for layers in (0, 1))
# the bf16 forward alone at a plan above 1024 that no other check takes:
# six blocks of 192 columns (3 -> 5, six modulated layers)
BF16_CLUSTER_ONLY = (1152,)
# the preparation's widths, checked bitwise against the plain layout
PREP_WIDTHS = (576, 1024, 2048, sd.MAX_HIDDEN["forward"])
# the widest forward's timed shape: 4 x this many points
CLUSTER_MAX_POINTS = 65536
# cli-free decode through inference.CNF_inference at H = 2048: rows, points
INFER_2048 = (16, MESH_POINTS)


def check_decoder(device, c_in: int, c_out: int, layers: int, h: int):
    """A frozen decoder of ``layers`` middle layers of width ``h`` (256
    latents, w0 30, weights from the seed ``h + c_in``) and its label."""
    model = SirenFilm(in_coord_features=c_in, in_latent_features=256, out_features=c_out,
                      num_hidden_layers=layers, hidden_features=h, w0=30.0,
                      generator=torch.Generator().manual_seed(h + c_in)).to(
        device).requires_grad_(False)
    return model, f"H={h} {c_in}->{c_out}"


def cluster_plan_line(h: int, family: str = "forward") -> str:
    """A cluster kernel's plan at width ``h`` (``sd.cluster_plan``, held to
    the built libraries'), its ptxas line and the clusters the card holds
    at once: the float32 forward's, the bf16 forward's (``family``
    "forward_bf16"), or the chain's in the ``family`` "dz" or "bwd" (its dz
    or training mode)."""
    plan = sd.cluster_plan(h)
    bf16 = family == "forward_bf16"
    kernel = (f"siren_fwd_cluster_kernel<{plan.share}, {plan.m_tiles}>" if family == "forward"
              else f"{BF16_FWD_KERNEL}<{plan.share}, {plan.m_tiles}>" if bf16
              else f"siren_chain_cluster_kernel<{plan.share}, {plan.m_tiles}, {family}>")
    return (f"{plan.blocks} blocks of {plan.share} columns over {plan.pairs} pairs, "
            f"{plan.ring(bf16)} stages, {plan.shared_bytes(bf16)} bytes of shared memory, "
            f"{sd.cluster_capacity(torch.cuda.current_device(), plan.width, 3, 5, family)} "
            f"clusters at once; {kernel}: {PTXAS.get(kernel, 'not reported')}")


def wide_kernel_checks(model, device, label) -> dict:
    """Every SIREN kernel of ``model``'s width against its plain version
    and float64 under the criteria of phases 3, 15, 4 and 7, each with a
    bitwise repeat: the float32 and bf16 forwards at 4 x 16384, dz at a
    ragged 64 x 1000 (also against the training backward's), the training
    backward at 4 x 16384; the width's cluster plans (the float32 forward,
    dz and the training backward; the bf16 forward's in its check),
    registers, spills and shared memory first.  Returns the kernels' errors
    against float64."""
    h = model.net1[0].out_features
    width = sd.kernel_hidden_width(h, model.net1[0].in_features, model.net1[-1].out_features,
                                   "bwd")
    for family in ("forward", "dz", "bwd"):
        log(f"[wider] {label}: cluster {sd.FAMILIES[family]}: "
            f"{cluster_plan_line(width, family)}")
    return {"forward": forward_check(model, device, 4, 16384, 31, label),
            "bf16": bf16_forward_check(model, device, 4, 16384, 32, label),
            "dz": dz_check(model, device, 64, WIDE_SENSORS, 33, label, against_bwd=True),
            "bwd": bwd_check(model, device, 4, 16384, seed=34)}


def write_wide_assets(root, model) -> str:
    """Phase 5's Case4 assets (its seeded U-Net, mesh and data range) with
    ``model`` as the CNF, its normalizer and ``WIDE_SENSORS`` sensors'
    measures at its outputs: a ``cli.sample_conditional`` recipe."""
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    recipe = write_assets(root, WIDE_SENSORS)
    c_out = model.net1[-1].out_features
    cnf = os.path.join(root, "cnf_wide.pt")
    torch.save({"model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                "hidden_states": {"latents": torch.zeros(1, L)}}, cnf)
    normalizer = os.path.join(root, "normalizer_wide.pt")
    torch.save({"x_normalizer_params": (torch.ones(3), torch.zeros(3)),
                "y_normalizer0u_params": torch.ones(1, c_out),
                "y_normalizer0l_params": -torch.ones(1, c_out)}, normalizer)
    rng = np.random.default_rng(19)
    measures = os.path.join(root, "measures_wide.npy")
    np.save(measures, (0.1 * rng.standard_normal((T, WIDE_SENSORS, c_out))).astype(np.float32))
    recipe.update(cnf_checkpoint=cnf, cnf_normalizer=normalizer, sensor_measures=measures,
                  save_path=os.path.join(root, "samples_wide.npy"))
    return _write_yaml(os.path.join(root, "case4_wide.yml"), recipe)


def phase_wider(root, device, results) -> dict:
    """Phase 19: ``recipes/cnf/case4.yml`` with ``hidden_features`` 1024
    and ``out_features`` 5 (``WIDE_CNF``), which the kernels refused before
    they took H up to 1024 and C up to 16.  (a) every SIREN kernel at
    every width of ``WIDER_CHECKS`` and at ``WIDE_CNF``'s (also a ragged
    3 x 3001 forward, dz at 384 x ``WIDE_SENSORS`` and the training
    backward at 4 x ``WIDE_POINTS``, the shapes (c) and (b) give them); (e) the float32 forward, the training backward, the
    bf16 forward at 4 x 262144 and dz at 384 x 1000 timed at ``WIDE_CNF``
    (medians of 3), and the forward and the training backward of the two
    C = 16 decoders at 4 x ``C16_POINTS``; (b) ``cli.train_cnf`` on the
    recipe over 4 seeded 5-field snapshots of ``WIDE_POINTS`` points (2
    epochs and a 1-epoch resume at ``WIDE_LR``): finite, falling losses;
    (c) ``cli.sample_conditional`` with the Case4 U-Net of phase 5 and the
    decoder (b) trained, at ``WIDE_SENSORS`` sensors, 10 guided steps, the
    operator on the forward and dz kernels (384 x 1000 pairs), and (d) the
    CLI's full-field decode through ``inference.decoder`` (the forward
    kernel).  (e) also times the forward at the shapes (b) and (c) launch it
    at and the training backward at 4 x ``WIDE_POINTS``.  Above H = 512 the
    float32 forward, dz and the training backward's chain are the cluster
    kernels.  Then (f) the cluster kernels alone at the widths above 1024
    (``cluster_checks``) and (g) an H = 2048 decoder through
    ``inference.CNF_inference`` (``infer_2048``).  Returns (b)'s and (c)'s
    launches (zeroed before each run, read after) and (g)'s."""
    errs = {}
    for c_in, c_out, layers, h in WIDER_CHECKS:
        model, label = check_decoder(device, c_in, c_out, layers, h)
        errs[h, c_out] = wide_kernel_checks(model, device, label)
        if c_out == 16:
            tag = f"@H{h}C16"
            results[f"siren_decode_forward{tag}"] = dict(
                forward_time(model, device, 4, C16_POINTS, 35, repeats=3),
                max_abs_err=errs[h, c_out]["forward"])
            results[f"siren_decode_bwd{tag}"] = dict(
                bwd_time(model, device, 4, C16_POINTS, seed=36, repeats=3),
                max_abs_err=errs[h, c_out]["bwd"])
        del model
        torch.cuda.empty_cache()
    model = SirenFilm(**WIDE_CNF, generator=torch.Generator().manual_seed(19)).to(
        device).requires_grad_(False)
    label = "Case4 at H=1024 3->5"
    err = wide_kernel_checks(model, device, label)
    forward_check(model, device, 3, 3001, 37, label)
    # the main path's shapes, which span several chunks of BWD_PAIRS pairs:
    # (c)'s dz at 384 x 1000 (rows straddle chunk launches) and (b)'s
    # training backward at 4 x WIDE_POINTS; the rows report their errors
    err["dz"] = dz_check(model, device, CASE4_RECIPE["time_length"], WIDE_SENSORS, 41, label,
                         against_bwd=True)
    err["bwd"] = bwd_check(model, device, 4, WIDE_POINTS, seed=42)
    results["siren_decode_forward@H1024"] = dict(
        forward_time(model, device, 4, 262144, 38, repeats=3), max_abs_err=err["forward"])
    results["siren_decode_bwd@H1024"] = dict(
        bwd_time(model, device, 4, 262144, seed=39, repeats=3), max_abs_err=err["bwd"])
    results["siren_decode_forward_bf16@H1024"] = dict(
        bf16_forward_time(model, device, 4, 262144, 38, repeats=3), max_abs_err=err["bf16"])
    results["siren_decode_dz@H1024"] = dict(
        dz_time(model, device, CASE4_RECIPE["time_length"], WIDE_SENSORS, 40, repeats=3),
        max_abs_err=err["dz"])
    # the shapes (b) and (c) launch the forward and the training backward
    # at (a training batch, a guided step's operator, a decode chunk), for
    # calls x (time - bound) in PERF.md
    for rows, points in ((4, WIDE_POINTS), (CASE4_RECIPE["time_length"], WIDE_SENSORS),
                         (CASE4_RECIPE["decode_batch_size"], MESH_POINTS)):
        forward_time(model, device, rows, points, 48, repeats=3)
    bwd_time(model, device, 4, WIDE_POINTS, seed=49, repeats=3)
    del model
    torch.cuda.empty_cache()
    cluster_checks(device, results)
    counts = wider_paths(root)
    counts["siren_decode_forward@H2048"] = infer_2048(root, device)
    return counts


def prep_check(h: int) -> None:
    """The cluster kernels' weight preparations at width ``h`` (two middle
    weights from a seed) bitwise against their plain layouts: the
    forward's (``sd.cluster_weight_layout``), the chain's, the forward's
    products then the dx chain's transposed ones
    (``sd.cluster_chain_weight_layout``), and the bf16 forward's
    (``sd.cluster_bf16_weight_layout``)."""
    plan = sd.cluster_plan(h)
    gen = torch.Generator(device="cuda").manual_seed(h)
    w_mid = torch.randn((2, h, h), generator=gen, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for what, prep, layout, n_prod in (
            ("forward", sd._cluster_library().siren_fwd_cluster_prep, sd.cluster_weight_layout,
             2),
            ("chain", sd._chain_cluster_library().siren_chain_cluster_prep,
             sd.cluster_chain_weight_layout, 4),
            ("bf16 forward", sd._cluster_library().siren_fwd_cluster_prep_bf16,
             sd.cluster_bf16_weight_layout, 2)):
        bf16 = what == "bf16 forward"
        image = (torch.empty(n_prod * h * h, device="cuda", dtype=torch.bfloat16) if bf16
                 else torch.empty(n_prod * 2 * h * h, device="cuda"))
        sd._raise_on(prep(sd._ptr(w_mid), sd._ptr(image), h, 2, stream), f"the {what}'s prep")
        same = torch.equal(image, layout(w_mid, plan.share))
        log(f"[cluster] H={h}: the {what}'s preparation of 2 middle weights ({n_prod} "
            f"products) bitwise equal to the plain layout: {same}")
        if not same:
            raise SystemExit(f"the cluster {what}'s weight preparation differs from its plain "
                             f"layout")


def cluster_checks(device, results) -> None:
    """Phase 19 (f): the cluster kernels above H = 1024.  Their plan at
    every width they take (64 .. 3072), held to the built library's
    (``siren_fwd_cluster_plan``, float32 and bf16: the forwards and the
    chain share ``siren_cluster.cuh::plan_for``); their preparations
    bitwise against the plain layouts; the float32 and bf16 forwards
    against their plain versions and float64 (phases 3 and 15's criteria,
    bitwise repeats) at ``CLUSTER_CHECKS`` (4 x 16384) and a ragged 3 x
    3001 at 2048, the bf16 forward alone at ``BF16_CLUSTER_ONLY``, the
    chain's dz mode (64 x
    ``WIDE_SENSORS``, also against the training backward's dz) and training
    mode (4 x 16384) under phases 4 and 7's criteria at ``CLUSTER_CHECKS``
    and on the shallow decoders of ``SHALLOW_CHECKS``; timed (medians of
    3, SM clocks, the reckoned stream bytes) at 2048 with WIDE_CNF's depth
    at 4 x 262144 (the float32 and bf16 forwards) and at the widest at six
    layers (the float32 and bf16 forwards and the training backward at 4 x
    ``CLUSTER_MAX_POINTS``, dz at 384 x ``WIDE_SENSORS``)."""
    lib = sd._cluster_library()
    out = (ctypes.c_int * 5)()
    for h in range(64, sd.MAX_HIDDEN["forward"] + 1, 64):
        plan = sd.cluster_plan(h)
        for bf16 in (False, True):
            sd._raise_on(lib.siren_fwd_cluster_plan(h, int(bf16), out), "siren_fwd_cluster_plan")
            if tuple(out) != (plan.blocks, plan.share, plan.m_tiles, plan.ring(bf16),
                              plan.shared_bytes(bf16)):
                raise SystemExit(f"cluster plan at H = {h} (bf16 {bf16}): the library's "
                                 f"{tuple(out)}, the wrapper's {plan}")
    log(f"[cluster] the wrapper's plans equal the library's (siren_cluster.cuh::plan_for, "
        f"which the float32 and bf16 forwards and the chain share; the rings and shared "
        f"memory of both forwards) at H = 64..{sd.MAX_HIDDEN['forward']}")
    for h in PREP_WIDTHS:
        prep_check(h)
    for c_in, c_out, layers, h in CLUSTER_CHECKS:
        model, label = check_decoder(device, c_in, c_out, layers, h)
        for family in ("forward", "dz", "bwd"):
            log(f"[cluster] {label}: {sd.FAMILIES[family]}: {cluster_plan_line(h, family)}")
        err = forward_check(model, device, 4, 16384, 43, label)
        err_bf16 = bf16_forward_check(model, device, 4, 16384, 56, label)
        if h == 2048:
            forward_check(model, device, 3, 3001, 44, label)
            bf16_forward_check(model, device, 3, 3001, 57, label)
        # the chain in both modes: dz at a ragged 64 x 1000 (also against the
        # training backward's dz), the training backward at 4 x 16384
        err_dz = dz_check(model, device, 64, WIDE_SENSORS, 50, label, against_bwd=True)
        err_bwd = bwd_check(model, device, 4, 16384, seed=51)
        if h == sd.MAX_HIDDEN["forward"]:
            results[f"siren_decode_forward@H{h}"] = dict(
                forward_time(model, device, 4, CLUSTER_MAX_POINTS, 45, repeats=3),
                max_abs_err=err)
            results[f"siren_decode_dz@H{h}"] = dict(
                dz_time(model, device, CASE4_RECIPE["time_length"], WIDE_SENSORS, 52,
                        repeats=3), max_abs_err=err_dz)
            results[f"siren_decode_bwd@H{h}"] = dict(
                bwd_time(model, device, 4, CLUSTER_MAX_POINTS, seed=53, repeats=3),
                max_abs_err=err_bwd)
            results[f"siren_decode_forward_bf16@H{h}"] = dict(
                bf16_forward_time(model, device, 4, CLUSTER_MAX_POINTS, 45, repeats=3),
                max_abs_err=err_bf16)
        del model
        torch.cuda.empty_cache()
    for h in BF16_CLUSTER_ONLY:
        model, label = check_decoder(device, 3, 5, 5, h)
        bf16_forward_check(model, device, 4, 16384, 58, label)
        del model
        torch.cuda.empty_cache()
    for c_in, c_out, layers, h in SHALLOW_CHECKS:
        model, label = check_decoder(device, c_in, c_out, layers, h)
        label += f" ({layers + 1} modulated)"
        log(f"[cluster] {label}: dz (64 x {WIDE_SENSORS}) and the training backward "
            f"(4 x 16384) of a shallow decoder")
        dz_check(model, device, 64, WIDE_SENSORS, 54, label, against_bwd=True)
        bwd_check(model, device, 4, 16384, seed=55)
        del model
        torch.cuda.empty_cache()
    model = SirenFilm(**dict(WIDE_CNF, hidden_features=2048),
                      generator=torch.Generator().manual_seed(2048)).to(
        device).requires_grad_(False)
    err = forward_check(model, device, 4, 16384, 46, "Case4 at H=2048 3->5")
    err_bf16 = bf16_forward_check(model, device, 4, 16384, 59, "Case4 at H=2048 3->5")
    results["siren_decode_forward@H2048"] = dict(
        forward_time(model, device, 4, 262144, 47, repeats=3), max_abs_err=err)
    results["siren_decode_forward_bf16@H2048"] = dict(
        bf16_forward_time(model, device, 4, 262144, 47, repeats=3), max_abs_err=err_bf16)
    del model
    torch.cuda.empty_cache()


def infer_2048(root, device) -> int:
    """Phase 19 (g): a decoder of ``WIDE_CNF``'s depth at H = 2048 (the
    parent port raised) decoded through ``inference.CNF_inference`` on the
    card, ``INFER_2048`` rows x points: finite, of its shape, and against the
    plain route (``use_pallas=False``, relative 1e-4 as phase 14's
    ``eval_cnf``).  Returns the cluster forward's launches in the kernel
    route's run (zeroed before, read after)."""
    d = os.path.join(root, "infer_2048")
    os.makedirs(d, exist_ok=True)
    nf = dict(WIDE_NF, hidden_features=2048)
    model = SirenFilm(**dict(WIDE_CNF, **nf), generator=torch.Generator().manual_seed(4096))
    rows, points = INFER_2048
    rng = np.random.default_rng(2048)
    torch.save({"model_state_dict": model.state_dict(),
                "hidden_states": {"latents": torch.from_numpy(
                    (0.1 * rng.standard_normal((rows, WIDE_CNF["in_latent_features"])))
                    .astype(np.float32))}}, os.path.join(d, "checkpoint_1.pt"))
    c_out = nf["out_features"]
    torch.save({"x_normalizer_params": (torch.ones(3), torch.zeros(3)),
                "y_normalizer_params": (torch.full((1, c_out), 2.0),
                                        torch.full((1, c_out), -1.0))},
               os.path.join(d, "normalizer_params.pt"))
    with open(RECIPE_CNF) as f:
        recipe = yaml.safe_load(f)
    recipe["NF"].update(nf)
    cfg = _write_yaml(os.path.join(d, "cnf.yml"), recipe)
    del model
    coords = rng.uniform(size=(points, 3)).astype(np.float32)
    args = (os.path.join(d, "checkpoint_1.pt"), cfg)
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    fused = CNF_inference(*args, device=device).predict(coords, batch_size=rows)
    wall = time.perf_counter() - t0
    launches = sd.LAUNCHES["siren_decode_forward"]
    plain = CNF_inference(*args, device=device, use_pallas=False).predict(coords,
                                                                          batch_size=rows)
    rel = float(np.linalg.norm(fused - plain) / np.linalg.norm(plain))
    ok = (fused.shape == (rows, points, c_out) and bool(np.isfinite(fused).all())
          and rel <= ZOO_REL_TOL and launches > 0)
    log(f"[cluster] inference.CNF_inference at H=2048 ({WIDE_CNF['num_hidden_layers'] + 1} "
        f"modulated layers, {c_out} outputs): {fused.shape}, finite "
        f"{bool(np.isfinite(fused).all())}, {wall:.2f} s with the load; against the plain "
        f"route rel L2 {rel:.3e} (tol {ZOO_REL_TOL}); cluster forward launches {launches} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("CNF_inference at H = 2048 is wrong or did not launch the cluster "
                         "forward")
    return launches


def wider_paths(root) -> dict:
    """Phase 19 (b), (c) and (d); returns their launches."""
    wide = os.path.join(root, "wider")
    recipe = write_training_case(wide, n_snapshots=4, points=WIDE_POINTS, epochs=2,
                                 channels=WIDE_NF["out_features"], **WIDE_NF)
    run = zoo_train(wide, "SIRENAutodecoder_film", recipe, lr=WIDE_LR)
    counts = dict(run["counts"])
    log(f"[wider] cli.train_cnf on case4.yml with {WIDE_NF}: ms per batch step (4 x "
        f"{WIDE_POINTS}) {[round(x, 1) for x in run['step_ms']]}, peak {run['peak']:.2f} GiB, "
        f"launches {counts}")
    missing = [k for k in ("siren_decode_forward", "siren_decode_bwd") if counts[k] == 0]
    if missing:
        raise SystemExit(f"the wide CNF trained without launching {missing}")

    path = write_wide_assets(root, run["trainer"].model)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    T = CASE4_RECIPE["time_length"]
    torch.cuda.reset_peak_memory_stats()
    sd.reset_launch_counts()
    t0 = time.perf_counter()
    timings = sample_conditional.main([path])
    wall = time.perf_counter() - t0
    dps = dict(sd.LAUNCHES)
    fields = np.load(cfgmod.basic_input(path).save_path)
    expected = (1, T, MESH_POINTS, WIDE_NF["out_features"])
    log(f"[wider] cli.sample_conditional, {WIDE_SENSORS} sensors: fields {fields.shape}, finite "
        f"{bool(np.isfinite(fields).all())}; {timings['steps']} guided steps "
        f"{timings['sample_s'] * 1e3 / timings['steps']:.1f} ms/step (operator on the "
        f"{'kernels' if timings['fused'] else 'plain decode'}), decode "
        f"{timings['decode_s'] * 1e3:.1f} ms ({T} rows x {MESH_POINTS} points), CLI wall "
        f"{wall:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"launches {dps}")
    if fields.shape != expected or not np.isfinite(fields).all():
        raise SystemExit(f"the wide CNF's DPS output is wrong: {fields.shape}, expected "
                         f"{expected}")
    missing = [k for k in ("siren_decode_forward", "siren_decode_dz") if dps[k] == 0]
    if missing or not timings["fused"]:
        raise SystemExit(f"the wide CNF's DPS run did not launch {missing}")
    for k, v in dps.items():
        counts[k] += v
    return counts


# phase 20: the SIREN kernels at more than 16 coordinates or outputs (the
# tables take them in chunks of 16).  (C_in, C_out, hidden layers, H): Case4's
# decoder (384 x 16 modulated layers) at 20 -> 24, neither a multiple of 16,
# and six layers of 1024 at 40 -> 64
FEATURE_CHECKS = ((20, 24, 15, 384), (40, 64, 5, 1024))
FEATURE_CNF = dict(CASE4_CNF, in_coord_features=20, out_features=24)
FEATURE_TAG = "@H384C20x24"
FEATURE_POINTS = 65536
FEATURE_SENSORS = 1000
# the kernels' launches in phase 20's main paths, by family
feature_launches = {}


def write_feature_case(root, n_snapshots: int, points: int) -> str:
    """``recipes/cnf/case4.yml`` with ``FEATURE_CNF``'s coordinates and
    outputs (``dims`` 20, ``out_features`` 24) on seeded synthetic
    snapshots: 24 smooth travelling waves on random 20-D points."""
    os.makedirs(root, exist_ok=True)
    c_in, c_out = FEATURE_CNF["in_coord_features"], FEATURE_CNF["out_features"]
    rng = np.random.default_rng(points + c_in)
    coords = rng.uniform(size=(points, c_in)).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=(n_snapshots, 1, c_out))
    k = rng.normal(size=(c_in, c_out)) * 2
    fois = np.sin(coords @ k + phase) + 0.1 * rng.standard_normal((n_snapshots, points, c_out))
    np.save(os.path.join(root, "output.npy"), fois.astype(np.float32))
    np.save(os.path.join(root, "coords.npy"), coords)
    with open(RECIPE_CNF) as f:
        recipe = yaml.safe_load(f)
    recipe.update(data_path=os.path.join(root, "output.npy"),
                  coor_path=os.path.join(root, "coords.npy"),
                  save_path=os.path.join(root, "run"), epochs=2, save_every=2, multiGPU=1,
                  dims=c_in)
    recipe["NF"].update(in_coord_features=c_in, out_features=c_out)
    return _write_yaml(os.path.join(root, "case4.yml"), recipe)


def feature_paths(root, device) -> dict:
    """Phase 20 (b)-(d), the main paths at ``FEATURE_CNF``: (b)
    ``cli.train_cnf`` on 4 snapshots of ``FEATURE_POINTS`` points, 2
    epochs and a 1-epoch resume (the forward and the training backward);
    (c) its checkpoint read back and decoded at its mesh through
    ``inference.CNF_inference`` (the float32 forward) against the plain
    route, and the same decoder's bf16 ``compute_dtype`` forward
    (``fused_siren_decode``, as phase 15a; neither package's inference API
    takes a compute dtype) against its plain version; (d) one guided step's
    gradient through ``CNFDecodeOperator`` at ``FEATURE_SENSORS`` sensors (384
    x 1000 pairs, above ``FUSED_MIN_PAIRS``: the forward and dz) against the
    plain route's.  Returns the launches, zeroed before each run and read
    after."""
    froot = os.path.join(root, "features")
    recipe = write_feature_case(froot, 4, FEATURE_POINTS)
    run = zoo_train(froot, "SIRENAutodecoder_film", recipe, lr=WIDE_LR)
    counts = dict(run["counts"])
    log(f"[features] cli.train_cnf at {FEATURE_CNF['in_coord_features']} -> "
        f"{FEATURE_CNF['out_features']} features: ms per batch step (4 x {FEATURE_POINTS}) "
        f"{[round(x, 1) for x in run['step_ms']]}, peak {run['peak']:.2f} GiB, launches "
        f"{counts}")
    missing = [k for k in ("siren_decode_forward", "siren_decode_bwd") if counts[k] == 0]
    if missing:
        raise SystemExit(f"the CNF at C > 16 trained without launching {missing}")
    ckpt = latest_checkpoint(os.path.join(froot, "SIRENAutodecoder_film"))[0]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    # the training mesh (the normalizers are pointwise over it)
    rows, rng = CASE4_RECIPE["decode_batch_size"], np.random.default_rng(20)
    coords = np.load(os.path.join(froot, "coords.npy"))
    sd.reset_launch_counts()
    inf = CNF_inference(ckpt, recipe, device=device)
    fused = inf.predict(coords, list(range(min(rows, inf.latents.shape[0]))), batch_size=rows)
    counts["siren_decode_forward"] += sd.LAUNCHES["siren_decode_forward"]
    plain = CNF_inference(ckpt, recipe, device=device, use_pallas=False).predict(
        coords, list(range(min(rows, inf.latents.shape[0]))), batch_size=rows)
    rel = float(np.linalg.norm(fused - plain) / np.linalg.norm(plain))
    model, lat = inf.model, inf.latents
    ncoords = inf.x_normalizer.normalize(torch.as_tensor(coords, device=device)).contiguous()
    sd.reset_launch_counts()
    with torch.no_grad():
        bf16 = sd.fused_siren_decode(model, ncoords, lat, compute_dtype=torch.bfloat16)
        counts["siren_decode_forward_bf16"] += sd.LAUNCHES["siren_decode_forward_bf16"]
        w_first, w_mid, w_head, b_head, w2, b1, scale = sd.stack_weights(model, model.w0)
        bf16_plain = sd.decode_forward_plain(ncoords, sd.film_table(lat, w2, b1, scale),
                                             w_first, w_mid, w_head, b_head, torch.bfloat16)
    rel16 = rel_l2(bf16, bf16_plain)
    ok = (fused.shape == plain.shape and np.isfinite(fused).all() and rel <= ZOO_REL_TOL
          and torch.isfinite(bf16).all().item() and rel16 <= 1e-2)
    log(f"[features] inference.CNF_inference on the trained checkpoint: {fused.shape}, "
        f"finite {bool(np.isfinite(fused).all())}, against the plain route rel L2 {rel:.3e} "
        f"(tol {ZOO_REL_TOL}); the bf16 forward on {tuple(lat.shape)} latents against its "
        f"plain version rel L2 {rel16:.3e} (tol 1e-2) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the decode at C > 16 is wrong")
    # (d) a guided step's gradient at FEATURE_SENSORS sensors
    T, L = CASE4_RECIPE["time_length"], CASE4_RECIPE["latent_size"]
    sensors = rng.uniform(size=(FEATURE_SENSORS, FEATURE_CNF["in_coord_features"])).astype(
        np.float32)
    y = torch.as_tensor(0.1 * rng.standard_normal((T, FEATURE_SENSORS,
                                                   FEATURE_CNF["out_features"])),
                        dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.uniform(-1, 1, (1, 1, T, L)), dtype=torch.float32, device=device)
    c_out = FEATURE_CNF["out_features"]
    # the CNF's coordinate normalizer; fields in [-1, 1] (the trained one is
    # pointwise over the training mesh)
    y_norm = Normalizer((torch.ones(1, c_out), -torch.ones(1, c_out)), "-11", 0)
    grads, walls = {}, {}
    for route in (None, False):
        op = CNFDecodeOperator(model=model, coords=sensors, x_normalizer=inf.x_normalizer,
                               y_normalizer=y_norm, max_val=1.0, min_val=-1.0,
                               use_pallas=route, device=device)
        xr = x.clone().requires_grad_(True)
        sd.reset_launch_counts()
        t0 = time.perf_counter()
        (grads[route],) = torch.autograd.grad(((op.forward(xr) - y) ** 2).sum(), xr)
        torch.cuda.synchronize()
        walls[route] = (time.perf_counter() - t0) * 1e3
        if route is None:
            fused_route = op.fused_route(T)
            for k in ("siren_decode_forward", "siren_decode_dz"):
                counts[k] += sd.LAUNCHES[k]
            step = dict(sd.LAUNCHES)
    rel_g = rel_l2(grads[None], grads[False])
    ok = (fused_route and torch.isfinite(grads[None]).all().item() and rel_g <= GRAD_REL_TOL
          and step["siren_decode_forward"] > 0 and step["siren_decode_dz"] > 0)
    log(f"[features] a guided step's gradient through CNFDecodeOperator at {FEATURE_SENSORS} "
        f"sensors ({T} x {FEATURE_SENSORS} pairs, kernels {fused_route}): against the plain "
        f"route rel L2 {rel_g:.3e} (tol {GRAD_REL_TOL}); wall {walls[None]:.1f} ms (plain "
        f"route {walls[False]:.1f} ms, first calls); launches {step} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the guided step at C > 16 is wrong or did not launch the kernels")
    return counts


def phase_features(root, device, results) -> dict:
    """Phase 20: the SIREN kernels at more than 16 coordinates or outputs,
    which the port refused before while the JAX kernels ran.  (a) every
    SIREN kernel (the float32 and bf16 forwards, dz, the training backward)
    at each of ``FEATURE_CHECKS`` against its plain version and float64
    under the criteria of phases 3, 15, 4 and 7, with bitwise repeats and
    its plans logged (``wide_kernel_checks``); timed at Case4's width at 20
    -> 24 (the forward, bf16 forward and the backward at 4 x
    ``FEATURE_POINTS``, dz at 384 x ``FEATURE_SENSORS``; medians of 3):
    the kernels line's ``FEATURE_TAG`` rows; then the main paths
    (``feature_paths``), whose launches the rows take."""
    errs = {}
    for c_in, c_out, layers, h in FEATURE_CHECKS:
        model, label = check_decoder(device, c_in, c_out, layers, h)
        errs[h] = wide_kernel_checks(model, device, label)
        if h == 384:
            T = CASE4_RECIPE["time_length"]
            results[f"siren_decode_forward{FEATURE_TAG}"] = dict(
                forward_time(model, device, 4, FEATURE_POINTS, 60, repeats=3),
                max_abs_err=errs[h]["forward"])
            results[f"siren_decode_forward_bf16{FEATURE_TAG}"] = dict(
                bf16_forward_time(model, device, 4, FEATURE_POINTS, 61, repeats=3),
                max_abs_err=errs[h]["bf16"])
            results[f"siren_decode_dz{FEATURE_TAG}"] = dict(
                dz_time(model, device, T, FEATURE_SENSORS, 62, repeats=3),
                max_abs_err=errs[h]["dz"])
            results[f"siren_decode_bwd{FEATURE_TAG}"] = dict(
                bwd_time(model, device, 4, FEATURE_POINTS, seed=63, repeats=3),
                max_abs_err=errs[h]["bwd"])
        del model
        torch.cuda.empty_cache()
    counts = feature_paths(root, device)
    feature_launches.update(counts)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    device = resolve_device("cuda")
    start = time.perf_counter()

    def stamp(done: str) -> None:
        log(f"[time] {done} done at {time.perf_counter() - start:.1f} s")
    name, count, smi = phase_device()
    phase_build()
    stamp("phases 1-2 (build)")
    results = {}
    phase_forward(device, results)
    phase_dz(device, results)
    phase_crossover(device)
    phase_bwd(device, results)
    stamp("phases 3-4, 7 (SIREN kernels)")
    phase_flash(device, results)
    stamp("phase 10 (flash kernels)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        launches = phase_main_path(root)
        phase_fused_dps(root, device)
        stamp("phases 5-6 (DPS)")
        phase_op_grads(device, root)
        for k, v in phase_train(root).items():
            launches[k] += v
        stamp("phases 8-9 (CNF training)")
        phase_unet_flash(root, device)
        figures = {}
        flash_launches, ema_path = phase_train_diffusion(root, figures)
        stamp("phases 11-12 (diffusion training)")
        phase_one_head(root)
        stamp("phase 12b (one head a block: the flash kernels above 128)")
        for label, run in (("phase 13 (train -> sample)",
                            lambda: phase_train_to_sample(root, ema_path)),
                           ("phase 14 (generation, evaluation)",
                            lambda: phase_generate(root, ema_path, device, figures)),
                           ("phase 15a (bf16 SIREN forward)",
                            lambda: phase_bf16_decode(device, results)),
                           ("phase 15b (bf16 U-Net)",
                            lambda: phase_bf16_unet(root, device, figures))):
            for k, v in run().items():
                if k in flash_launches:
                    flash_launches[k] += v
                else:
                    launches[k] += v
            stamp(label)
        phase_remat(root, device)
        stamp("phase 15c (remat)")
        phase_narrow(device, results)
        stamp("phase 16a (the float32 SIREN kernels at H = 64 .. 512)")
        phase_multistep(root, device, figures)
        stamp("phase 16b (multi-step training from device data)")
        for k, v in phase_demo(root, device).items():
            launches[k] += v
        stamp("phase 16c (the turbulence demo)")
        for k, v in phase_demo_conditional(root, device).items():
            launches[k] += v
        stamp("phase 16d (the demo's DPS experiment and report)")
        for k, v in phase_multidevice(root, device).items():
            if k in flash_launches:
                flash_launches[k] += v
            else:
                launches[k] += v
        stamp("phase 17 (multi-device)")
        for k, v in phase_zoo(root, device).items():
            launches[k] += v
        stamp("phase 18a-b (the decoder zoo)")
        for k, v in phase_classifier(root, device).items():
            flash_launches[k] += v
        stamp("phase 18c-f (classifier, guidance, super-resolution)")
        wide_launches = phase_wider(root, device, results)
        stamp("phase 19 (the SIREN kernels up to H = 1024, C = 16; the cluster kernels up "
              f"to H = {sd.MAX_HIDDEN['forward']})")
        phase_features(root, device, results)
        stamp("phase 20 (the SIREN kernels at C > 16)")
    launches.update(flash_launches)

    # the rows at H = 128 take the demo --fast's launches (its CNF stage is
    # the decoder phase 16a times there)
    for kname in ("siren_decode_forward", "siren_decode_bwd"):
        wide_launches[f"{kname}@H128"] = DEMO_LAUNCHES["--fast"][kname]
    fwd, chain = ("siren_fwd_cluster.cu", "siren_decode.py:96"), ("siren_chain_cluster.cu",)
    rows = [("siren_decode_forward", "siren_decode_forward", *fwd),
            ("siren_decode_forward_bf16", "siren_decode_forward_bf16", *fwd),
            ("siren_decode_dz", "siren_decode_dz@384x1024", *chain, "siren_decode.py:315"),
            ("siren_decode_bwd", "siren_decode_bwd", *chain, "siren_decode.py:434")]
    for h in (128, 448, 512):
        rows += [("siren_decode_forward", f"siren_decode_forward@H{h}", *fwd),
                 ("siren_decode_bwd", f"siren_decode_bwd@H{h}", *chain, "siren_decode.py:434")]
    rows += [("siren_decode_forward", f"siren_decode_forward@H{h}", *fwd)
             for h in (1024, 2048, sd.MAX_HIDDEN["forward"])]
    rows += [("siren_decode_forward_bf16", f"siren_decode_forward_bf16@H{h}", *fwd)
             for h in (1024, 2048, sd.MAX_HIDDEN["forward_bf16"])]
    for h in (1024, sd.MAX_HIDDEN["dz"]):
        rows += [("siren_decode_dz", f"siren_decode_dz@H{h}", *chain, "siren_decode.py:315"),
                 ("siren_decode_bwd", f"siren_decode_bwd@H{h}", *chain, "siren_decode.py:434")]
    for h in (1024, 384):
        rows += [("siren_decode_forward", f"siren_decode_forward@H{h}C16", *fwd),
                 ("siren_decode_bwd", f"siren_decode_bwd@H{h}C16", *chain, "siren_decode.py:434")]
    rows += [("flash_forward", "flash_forward", "flash_attention.cu", "flash_attention.py:56"),
             ("flash_bwd_dq", "flash_bwd_dq", "flash_attention.cu", "flash_attention.py:158"),
             ("flash_bwd_dkv", "flash_bwd_dkv", "flash_attention.cu", "flash_attention.py:188")]
    for tag in FLASH_WIDE_TIMES:
        rows += [("flash_forward", f"flash_forward{tag}", "flash_attention.cu",
                  "flash_attention.py:56"),
                 ("flash_bwd_dq", f"flash_bwd_dq{tag}", "flash_attention.cu",
                  "flash_attention.py:158"),
                 ("flash_bwd_dkv", f"flash_bwd_dkv{tag}", "flash_attention.cu",
                  "flash_attention.py:188")]
    rows += [("flash_forward", f"flash_forward{bf16}{tag}", "flash_attention.cu",
              "flash_attention.py:56")
             for tag, bf16 in [(t, "_bf16") for t in FLASH_WIDE_TIMES]
             + [(t, b) for t in FLASH_WIDE_FWD_TIMES for b in ("", "_bf16")]]
    # the bf16 backward above 128 (the TMA pair), and the float32 pair at
    # many tokens and 512 channels
    rows += [(name, f"{name}_bf16{tag}", "flash_attention.cu", f"flash_attention.py:{line}")
             for tag in FLASH_WIDE_TIMES
             for name, line in (("flash_bwd_dq", 158), ("flash_bwd_dkv", 188))]
    rows += [(name, f"{name}{tag}", "flash_attention.cu", f"flash_attention.py:{line}")
             for tag in FLASH_WIDE_BWD_TIMES
             for name, line in (("flash_bwd_dq", 158), ("flash_bwd_dkv", 188))]
    # the SIREN kernels at more than 16 features (phase 20)
    rows += [(fam, f"{fam}{FEATURE_TAG}", *(fwd if "forward" in fam else chain),
              *(() if "forward" in fam else
                (f"siren_decode.py:{315 if fam == 'siren_decode_dz' else 434}",)))
             for fam in ("siren_decode_forward", "siren_decode_forward_bf16",
                         "siren_decode_dz", "siren_decode_bwd")]
    kernels = []
    for kname, key, src, replaces in rows:
        r = results[key]
        kernels.append({
            "name": key if "@H" in key or "@D" in key else kname, "route": "cuda",
            "source": f"confild_tpu_torch/csrc/{src}",
            "replaces": f"confild_tpu/ops/{replaces}",
            # phase 19's main paths (cli.train_cnf, cli.sample_conditional)
            # run its decoder at H = 1024, 3 -> 5, and (g)
            # inference.CNF_inference one at 2048; the demo --fast runs
            # H = 128; no main path runs the other widths listed apart or
            # C = 16 (the base rows count the other main paths' launches);
            # the flash rows above 128 take phase 12b's and 18 (f)'s
            # the rows at many tokens and 512 channels are the same
            # instantiations as @D512's: their launches
            "launches": (wide_launches[kname] if key.endswith("@H1024")
                         else feature_launches[kname] if key.endswith(FEATURE_TAG)
                         else wide_launches.get(key, 0) if "@H" in key
                         else WIDE_FLASH_LAUNCHES.get(key.replace("N9216", ""), 0)
                         if "@D" in key
                         else launches[kname]),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"],
            **{k: r[k] for k in ("library_call", "library_covers", "reduce", "recompute")
               if k in r}})
    log(f"[time] total {time.perf_counter() - start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
