#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, few-shot driver,
intrinsic-dimension, CLIP pre-training, multi-process, sequence-parallel,
stacked-layout and pipelined paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: Python, torch and CUDA versions; the card's name and
   power limit from nvidia-smi;
2. build: every kernel of ``peft_vit_tpu_torch/csrc`` with nvcc for sm_90a,
   with ptxas's registers, spills and shared memory of each instantiation
   of the K1 and K4 forward, of the K2, K3 and K5 backward and of K6 (with
   the blocks a SM holds; K6's at each K of the path);
3. kernel: each hand-written kernel against its plain PyTorch version on
   the card.  ``flash_attention_fwd`` (the CUDA counterpart of the Pallas
   flash forward): bf16 at every batch the serving path gives it and, with
   lse, at the training batch; fp32, with a bias, ragged N; and at the
   edges of its two designs (one resident product up to N = 256, streamed
   key tiles beyond): N = 8, 64, 196, 200, 255, 256, 257, 577 at B = 1 and
   32, bf16 and fp32, both scales, with and without lse and bias.
   ``flash_attention_bwd_dq`` (which also computes delta = rowsum(dO o O))
   and ``flash_attention_bwd_dkv`` (the counterparts of the two Pallas
   backward kernels): bf16 at the training batch and at B = 1, fp32, N = 50,
   197, 257 and 577 (one to four 64-row chunks, ragged), o and lse from the
   forward kernel, the kernel's delta against ``_row_dot``; then the
   ``flash_attention`` autograd Function against autograd through the plain
   reference.  Then
   each kernel's time beside its bound, its plain version and
   ``torch.nn.functional.scaled_dot_product_attention``, forward and
   backward (a yardstick only: the port never calls it); K1 also at N =
   257 and 577.
   RPB's path: K1, K2 and K3 with a bias and ``attention_bias_grad`` (K7,
   the bias's gradient, with delta from K2 and with delta computed from o)
   against their plain versions, bf16 and fp32, at (16, 12, 197, 64) with one
   bias and (48, 12, 197, 64) with a bias per cell of a round of 3, and at
   N = 50, 257 and 8 (ragged keys, the streamed forward, the narrowest
   product), the bias zero on its first row and column in every other case;
   the ``flash_attention`` Function with per-cell biases under the vmap
   equal to each cell alone bit for bit, one launch each of K1, K2, K3 and
   K7, and K7 alone when only the bias needs a gradient; in fp32 against
   autograd of the reference (the vmap at 16 and 32 elements a cell).  K7
   where its split of the batch matters (B = 21, 13 and 1 at C = 1, 15 and
   96 at C = 3, and Swin-T's stage-2 fold at B = 192, C = 3) against its
   plain version, each round equal to its cells alone bit for bit, and on
   ViT-B/16 at B = 16 and Swin-T's stage-2 fold at B = 64 three calls and
   two graph replays equal to the first call bit for bit.  Then K1, K2 and
   K3 with and without the bias and K7 beside its bound, its plain version
   and SDPA's backward with a float mask that requires a gradient;
   ``int8_gemm_dynamic`` and ``int8_gemm_static`` (the counterpart of the
   Pallas quantize + int8 matmul + rescale kernel) are held to EQUALITY with
   their plain versions, bf16 and fp32, at M = 197 x {1, 8, 16, 32} for the
   four GEMMs of a block and their transposes (the dx products), at M = 1,
   with an all-zero row, an outlier row, values on .5 steps, a saturating
   static scale and a non-contiguous input, and at the edges of its layout
   (K = 64, 192, 704, 3008, 3072 x N = 64, 192 x M = 1, 63, 64, 65, 197,
   both variants, bf16 and fp32); shapes the kernel does not take must
   raise.  Then their times beside the bound, the plain version, the
   library route (``quantize_rows`` + ``torch._int_mm`` + rescale) and the
   dense bf16 ``F.linear``;
4. slice: the ViT-B/16 LoRA flagship (bf16, channel BN; ViT-B/16's width,
   4 of its 12 blocks, ``LAYERS``, in phases 4-9, the zero-shot drives and
   intrinsic, for the script's time) built from a numpy weight tree in the
   JAX package's layout, served by ``ServingSession``
   with buckets (1, 8, 32), each captured as a CUDA graph at load, for
   requests of 1, 5, 8, 32 and 40 images.  The logits must be finite and
   equal bit for bit to an eager session's; the 5-image request must agree
   with the same model run on the CPU in fp32; each bucket's graph launches
   the forward kernel once per layer a replay, and one replay runs per
   forward batch.  Then the same weights and requests through the flagship
   built with ``int8=True``, its weights quantized once at load: 4 launches
   of the int8 kernel and 1 of the attention kernel a block a replay, no weight
   quantized by a request, logits equal bit for bit to the eager session's
   and to the per-call quantize's, top-1 equal to the bf16 session's, logits
   near it, the fp32 int8 forward on the card equal bit for bit to the same
   forward with the plain version in the kernel's place and near the fp32
   int8 forward on the CPU;
5. train: the same flagship (bf16 compute, fp32 master weights, LoRA mask)
   takes SGD steps at batch 16 through ``bench_torch.make_step``.  The LoRA
   leaves of every block and the head train (``TRAINABLE``); every loss is
   finite; each of the three kernels is
   launched once per layer per step; the frozen leaves stay bit-identical
   and every trainable leaf moves; one step's update equals the update of
   the same step with the plain backward in the kernels' place; 8 steps on
   one batch lower the loss; 3 steps in fp32 on the card (at lr 1e-5, B=4)
   match the same steps on the CPU, and the bf16 losses and LoRA updates at
   B=16 track the CPU's fp32 ones.  Then the step rate and a profile of one
   step;
6. int8 train: the flagship with ``int8_train=True`` takes 3 steps at batch
   16 under each of three recipes (pre-quantized tree; with the int8 dx
   backward; static activation scales at margin 1.5 with the int8 dx).  The
   launch counts are derived from the model (4 forward launches a block a
   step, one dx launch fewer: block 0's in_proj input needs no gradient); the frozen
   leaves and the quantized tree stay bit-identical; every trainable leaf
   moves; one step's update equals, bit for bit, the update of the same step
   with the plain versions in the kernel's place; 8 steps on one batch lower
   the loss.  Then each recipe's step rate and profile beside the bf16 step.

7. fused: ``fused_short_attention_fwd`` (K4) and ``fused_short_attention_bwd``
   (K5), the counterparts of the Pallas fused short-sequence pair, against
   their plain versions at (B, 12, N, 64) for N = 197 at B = 1, 8, 16, 32,
   N = 50, 577 and 1024, bf16 and fp32, at scale 1 with post-scaled q and at
   0.125, and on the flagship's own block-0 q, k, v; the autograd path of
   ``multi_head_attention(use_fused=True)`` against the same call with the
   plain versions; K4 at the edge shapes of K1's list and N = 1024, K5 there
   too at scales 1, 0.125 and 0.3 (no power of two: the scale folded into ds
   before rounding shows); the dispatch rule (a bias or N = 1025 takes K1);
   then their path (12 forward and backward calls at B = 16) and their times
   beside K1, K2 (with delta) + K3 and ``scaled_dot_product_attention``, K4
   and K5 also at N = 577 and 1024;
8. graph: the step as the engine runs it (``make_epoch_fn``), each step a
   CUDA-graph replay, against the same epoch run eagerly: 3 steps at B=16,
   equal bit for bit, in bf16 and under the three int8 recipes; the
   launches of a replay against their formulas (K1, K2 and K3 once a
   block; 4 int8 forward a block and one dx fewer); the captured and eager
   step rates and a profile.
   Then a sweep round of 3 cells (``cells=True``) against the same cells
   trained one at a time, bf16 and fp32, and the times of rounds of 3 and 7
   against their cells, with the peak memory;
9. driver: ``commands.run.finetune_main`` at full ViT-B/16 width
   (vitb16_CLIP.yaml at the flagship's depth, random numpy weights, synthetic 5-way 4-shot, batch
   16): the bf16 sweep of 18 cells in 6 rounds of 3 of 2 epochs and the
   final train; every step and eval batch one replay of its graph, each
   graph's launches a replay those of one cell (a round's cells ride the
   batch), finite losses, frozen leaves bit-identical, the choice, score,
   wall times and peak memory, then a profiled run's device busy time and
   idle share; the int8 drive (``TPU.INT8_FWD_TRAIN``, ``TRAIN.NO_TUNING``)
   with one quantized tree for the run and 4 int8 launches a block a replay; the
   tiny fp32 drive with a 2-lr grid on the card and on the CPU, which must
   choose alike;
10. methods: each PEFT method beside LoRA (``METHODS``: KAdaptation, the
   Houlsby adapter, AdapterDrop, Compacter, the LoRA variants, LePE, VPT
   shallow and deep, the transformer probe) at ViT-B/16's width from
   ``vitb16_CLIP.yaml``, 2 of its 12 blocks (``METHOD_DEPTH``, for the
   script's time), through ``build_image_classifier``, every leaf drawn
   nonzero: a 5-image request through ``ServingSession`` (top-1 and the bf16
   bound against the fp32 CPU forward, the captured bucket equal to eager);
   a captured round of 3 cells, one step at B=16, equal to eager, its
   launches a replay those ``launch_rule`` derives from the mask, its update
   with K2/K3 as near the float64 backward as the plain versions'; the
   one-cell step's rate, busy time and launches; KAdaptation and the adapter
   under the int8 recipe with int8 dx (K6 launches a replay, the update with
   K6 equal to the plain version's); KAdaptation through the whole driver
   and AdapterDrop's int8 ``NO_TUNING`` drive;
11. tower: RPB and the six methods that train a subset of the pretrained
   tower (``TOWER_METHODS``: full, bitfit, layernorm, attention,
   first_attention and first_mlp, the last two with
   ``TRAIN.CACHE_FROZEN_PREFIX`` False) at the methods phase's ViT-B/16
   (2 blocks), each served and trained
   as a captured round of 3 as in the methods phase, with K7 in the launch
   rule; the frozen remainder bit-identical; a one-cell round's first step
   against the one-cell step (cosine of each leaf's momentum); RPB's update
   with K2, K3 and K7 against the float64 backward; attention and full also
   under the int8 recipe with int8 dx; RPB and bitfit through the whole
   driver;
12. zeroshot: the CLIP text tower of vitb16_CLIP.yaml (width 512, 12 blocks
   of 8 heads, context 77, vocabulary 49,408) from a numpy tree in the JAX
   layout.  K1 with the tower's causal bias (-1e30 above the diagonal, in
   the compute dtype) against its plain version at (T, 8, 77, 64), T the 18
   templates of cifar-100, and at B = 1, bf16 and fp32, K7 launched 0 times;
   its time with and without the bias beside its bound, the plain version
   and SDPA with the same float mask.  The zero-shot classifier of
   cifar-100's 100 classes in bf16 on the card (K1 12 times a text forward)
   against fp32 on the CPU (``TOL_TEXT_COS``); ``zeroshot_main`` end to end
   (bf16; fp32 against the CPU on a 5-image request, top-1 equal);
   ``finetune_contrast`` and ``linear_probe_contrast`` through
   ``finetune_main`` (a round of 3 cells, each step a replay, launches from
   ``launch_rule``, the class-text bank bit-identical); at the flagship's
   depth, the linear probe and AdapterDrop on the last block through the
   cached-prefix sweep (K1 once a block
   before the cut a prefix batch, the same choice and score as the drive
   through the whole tower); ``linear_probe --classifier logistic`` in fp32,
   the card choosing C as the CPU does; int8 attention (the static recipe
   with int8 dx, and with P V): the int32 scores equal to their exact sum,
   the calibrated scales, captured steps equal to eager, the launches a
   replay (K1 only in the backward), one step's update against the bf16
   recipe's;
13. fullshot: ``commands.train.train_main`` (the full-shot trainer) at
   ViT-B/16 from vitb16_sup.yaml at the flagship's depth (the supervised
   timm-style tower, random
   weights from build_image_classifier's seed), synthetic 10-way at 224 px, batch 64, 2
   epochs: the full fine-tune with SGD nesterov, warmupcosine, EMA 0.999,
   mixup 0.8 with cutmix 1.0, label smoothing 0.1, the global-norm clip 1.0
   and a checkpoint every 2 steps under AUTO_RESUME.  Every step and eval
   batch one replay, K1, K2 and K3 once a block each a step replay (K1 once
   a block an eval replay); the rate each replay used equal to ``build_lr_schedule`` at its
   step; the first step captured equal to it eager bit for bit, and its
   update with K1-K3 against the float64 backward, no farther than the plain
   dq/dk/dv's; a fresh ``Trainer`` stopped after its first mid-epoch
   checkpoint and one resumed from it equal to the uninterrupted run bit for
   bit (trainable, momentum, EMA).  The step's time, busy time, idle share,
   launches and the optimizer chain's time, the epochs' and evals' wall
   times, the peak memory.  Then LoRA on the same tower under the int8 static
   recipe with int8 dx (K6 4 static a block + one dx fewer a replay, the scales
   recalibrated each epoch, captured == eager and K6 == its plain version
   bit for bit on the first step, the step's time), and a width-64, one-head
   tower in fp32 on the card against the CPU (the epoch losses within
   ``TOL_FULLSHOT_LOSS_REL``, the same best top-1);
14. streaming: the native runtime built from ``runtime/pvtio.cpp`` into
   ``build/`` (its path and build time, or what is missing); 640 train and
   128 test PNGs of 256x320 and 320x256 (written with zlib and struct), 10
   classes, as 4 TSV shards, an ImageFolder tree and an ELEVATER manifest.
   With the runtime: the TSV source's epochs equal ``decode_resize`` of each
   image in the sampler's order with RandomState(seed + 7919 (epoch + 1))'s
   flips, ``batches(e, skip_batches=3)`` the uninterrupted tail (K = 1 and
   2), K = 2 chunks the single batches, the three layouts the same images,
   and the decode rate.  Without it, the narrowed path: the same source
   checks over an in-memory uint8 loader (no decode).  Then
   ``train_main`` at ViT-B/16 (vitb16_sup.yaml, B = 64, every leaf trained)
   through the streaming branch with ``AUG.TIMM_AUG`` (rand-m9-mstd0.5-inc1,
   erasing 0.25 pixel, hflip 0.5) inside the captured step, K = 2 chunks
   through the pinned prefetch, 2 epochs of 10 steps: the batches from the
   source (the tower at the flagship's depth), every step and eval batch
   one replay, K1-K3 once a block each a replay,
   the first step captured == eager and its update with K1-K3 against the
   float64 backward, a run stopped in epoch 1 and resumed == the
   uninterrupted one (state, both generators), the augmentation on the card
   against the CPU with the same draws; the step's time, the augmentation's
   share of its busy time, a streaming epoch's idle share, the pinned copy's
   time.  Then ``finetune_main`` (LoRA, vitb16_CLIP.yaml) on the 5-way
   manifest: its train split equal to ``decode_resize`` of each PNG, one
   round of 3 cells and the final train, K1-K3 counted by ``launch_rule``.

15. resnet: the ResNet family.  The determinism probe: every convolution of
   the ResNet-50 v1 step (B = 64, 224 px, bf16, channels-last) and of the
   CLIP RN50 tower (a round's folded batch, and the grouped convolutions of
   per-cell weights), each gradient computed three times under the cuDNN
   algorithms ``models.resnet._Conv2d`` runs for its dtype (the default ones
   for bf16); each must repeat bit for bit.  RN50 CLIP
   (rn50_CLIP.yaml) at 224 px, weights from a numpy seed, bf16: served
   through ``ServingSession`` (buckets 1, 8 and 32; captured == eager, no
   kernel launched, top-1 and logits against fp32 on the CPU, fp32 on the
   card against the CPU, latency); ``zeroshot_main`` (K1 12 times a text
   forward, with the causal bias; none in the RN tower); a captured round of
   3 bitfit cells at B = 16 against it eager (bit for bit, BN statistics
   included) and against each cell trained alone; ``finetune_main`` (bitfit)
   on the tiny RN tower in fp32, card against CPU.  DropBlock on the card
   against the CPU on the same noise at the step's two shapes.  Then
   ``train_main`` on r50_s3.yaml's ResNet-50 v1 (B = 64, 224 px, SGD,
   warmup-cosine, mixup 0.2 / cutmix 1.0, label smoothing 0.1, DropBlock on
   stages 3 and 4 at keep 0.9, block 7): no kernel launched, the first step
   captured == eager and a resumed run == the uninterrupted one bit for bit
   (BN statistics and the drop generator included), ``update_bn``, the
   step's time, busy time and idle share;
16. swin: the Swin family.  K1, K2 (delta too), K3 and K7 at head dim 32
   against their plain versions at Swin-T's four stage folds (B = 16, and
   B = 64 in bf16; N = 49, nW h heads, the gathered table plus the shift
   mask), a per-cell bias (C = 3), an odd N (25), bf16 and fp32, and a D =
   48 call refused; their
   times at the stage-0 and stage-2 folds (K7 at all four), B = 64, beside
   the bound, the plain version and SDPA.  Swin-T (swin_tiny.yaml) at 224 px, weights from a
   numpy seed: ``ServingSession`` buckets 1, 8, 32 (K1 12 a replay, captured
   == eager, top-1 and logits against fp32 on the CPU, fp32 card against
   CPU, latency); ``train_main`` at B = 64 (K1, K2, K3 and K7 12 each a step
   replay, the first step captured == eager and its update against the
   float64 backward, a resumed run == the uninterrupted one, the step's
   time, busy time and idle share).  CLIP Swin-T (clip_swin_tiny.yaml):
   ``zeroshot_main`` (K1 through the text tower's causal bias and the Swin
   tower), captured rounds of 3 LoRA and 3 RPB cells (== eager, each cell
   against it alone, the launches a replay from ``launch_rule``), the tiny
   fp32 ``finetune_main`` card against CPU.  ConvViT and CSwin at a tiny
   size: fp32 card against CPU, a captured step == eager, K1-K7 launched 0
   times; their convolutions in the determinism probe.
17. zoo: the zoo's other CNNs, in a child process of its own started
   before the build (no kernel runs on its paths, and the card is idle
   while nvcc runs; the parent waits for it before phase 3 and takes over
   its failed checks).  The determinism probe over every
   convolution of the EfficientNet-B0, ReXNet 1.0x, TTNet v2 and HRNet-W18
   full-shot steps (B = 64, 224 px, bf16; the depthwise convs at kernel 3
   and 5, strides 1 and 2), of B0's linear-probe round (the folded batch)
   and of a per-cell round (the grouped form), and of HRNet v2 with grouped
   blocks.  Every tower built at its width and run (the four at 224 px,
   HRNet v2 / v2_share / v3 / v4 and TTNet v3 at the JAX tests' configs, 64
   px).  B0 (efficientnet_b0.yaml) served in bf16 (buckets 1, 8, 32;
   captured == eager, top-1 and logits against fp32 on the CPU, fp32 card
   against CPU, latency); a captured linear-probe round of 3 at B = 16
   against it eager and each cell against it alone through float64; the
   logistic probe and ``finetune_main`` linear (a round of 3 cells, the
   final train).  ``train_main`` at B = 64 on B0 (2 epochs of 2 steps) and
   HRNet-W18 (1 epoch of 2): the first step captured == eager, a resumed run
   == the uninterrupted one, ``update_bn``, the step's time (B0's busy time
   and idle share; HRNet's is not profiled); on ReXNet and TTNet v2 (1
   epoch): the first step captured == eager, the step's time, busy time and
   idle share; the five small towers served in fp32 (captured == eager,
   card against CPU).  K1-K7 launched 0 times on every path.
18. intrinsic: the two WHT forms on one vector at d = 256 ... 16,384 (the
   measure of ``ops.wht.DENSE_MAX``).  ViT-B/16 (vitb16_CLIP.yaml at the
   flagship's depth, bf16, seeded random weights) with Fastfood over every
   block's mlp at d = 1,000 (4 leaves a block, 2 at LL = 2^22): theta on
   the card against
   the CPU in fp32 per leaf, v = 0 and SAID's lambda = 0 giving theta0 bit for
   bit; an epoch of 2 steps at B = 16 through ``make_epoch_fn`` captured ==
   eager bit for bit, its launches a replay (K1 once a block, K2 and K3 one
   fewer: block 0's attention precedes the first wrapped leaf); the step's
   time, the transform's time and share of it, one WHT at 2^22, the
   profile; the dense projection over the last block's mlp (19 GB of P): its rays against the CPU's,
   v = 0 exact, one step.
19. clip: ``commands.train_clip.train_clip_main`` at CLIP ViT-B/16 width
   (vitb16_CLIP.yaml, 149.6 M parameters, seeded random weights) on the
   synthetic pairs, 32 a step, adamW, 2 epochs of 2 steps, GATHER_TENSORS on:
   without a group (the model's own logits), then in a one-rank NCCL group
   (a file rendezvous): captured, the same run eager, and eager with the
   gather and the mean all-reduce as identities (what they are over one
   rank); the captured run equal to both bit for bit (losses and every
   parameter), near the no-group run; one graph, K1-K3 24 a replay and K7
   0; K1-K3 on the text tower's causal operands of the step against their
   plain versions, bf16 (the eager run's first step) and fp32 (a step of the
   fp32 model); the step's time, images/s and profile.  Then the sharded
   LoRA step of ``parallel`` over the group, replicated and ZeRO-1: 2
   captured steps == eager == the engine's one-process step, bit for bit.
20. multichip: the multi-process half of parallelism, on the one card.
   ``train_main`` on vitb16_sup.yaml (B = 64, 2 epochs of 2 steps, the
   full-shot phase's recipe and depth) without a group, then in a one-rank NCCL group
   (a file rendezvous) replicated and under ZeRO-1: each equal to the
   no-group run bit for bit (every step's loss, the trainable leaves, the
   optimizer state, EMA, each eval's top-1), one replay a step with K1-K3
   once a block each, the first step eager == its capture with the collectives of a
   step counted, the step's time beside the no-group step's; a ZeRO-1 run
   stopped at its first mid-epoch checkpoint and resumed == the
   uninterrupted one.  LoRA under the int8 static recipe in the group: the
   scales == those calibrated without the group, K6 == its plain version
   inside the first step, bit for bit.  The ResNet-50 of r50_s3.yaml in
   fp32: the stem BN's moments through the group's sums within 1e-6 of the
   local ones, the first step's update within test_torch_port_trainer's
   ResNet bound of the no-group step.  The in-memory streaming source in
   the group == without it.  ViT-B/16 LoRA at B = 16 as two tensor-parallel
   shards in turn (K1-K3 on 6 heads each, 24 launches a forward): the
   logits against the whole model (bf16 0.1, fp32 1e-4 of the largest
   logit), the fp32 LoRA gradients within 1e-4.  ``dryrun_multichip(4)`` on
   gloo CPU processes (dp x tp = 2 x 2; run at nice 19 in a child process
   started beside the zoo phase's, as it touches no card), then ``dryrun_multichip`` on the
   host's cards by its default (one card a rank, NCCL): the first loss, the
   sequence-parallel one and the pipelined one (before and after its SGD
   step) within 1e-5 of the same losses in one process.
21. seqpipe: sequence parallelism, the stacked block layout and GPipe.
   ViT-B/32 (vit_base_patch32_224.yaml: 7 x 7 + 1 = 50 tokens, which split
   over a model degree of 2 where ViT-B/16's 197 do not) full fine-tune at
   B = 16 as two sequence-parallel shards in turn (25 tokens a shard between
   the regions, 6 heads inside): K1-K3 24 each a step and on the shards'
   operands against their plain versions, the logits against the whole
   model (bf16 0.1, fp32 1e-4 of the largest logit), every fp32 gradient
   (LayerNorms and biases included) within 1e-4.  ``train_main`` on
   vitb16_sup.yaml at its 12 blocks (B = 64, 2 steps, the clip off) with
   ``TPU.SCAN_LAYERS`` against the unrolled run: bit for bit, one replay a
   step, K1-K3 12 each.  GPipe: ViT-B/16 stacked as 4 stages of 3 blocks
   over the local ring, 4 microbatches of B = 64: K1-K3 48 each a step and
   on the microbatches' operands against their plain versions, the logits
   (bf16, fp32) and every fp32 gradient against the unpipelined model, one
   microbatch bit for bit, the step's time pipelined and not.
22. tphooks: tensor and sequence parallelism under the PEFT hooks and int8.
   K6's K-cut form (``int8_gemm_partial``: the codes at given row scales or
   the static one, the int32 accumulator out) and the partial row absmax
   (``int8_row_absmax``) against their plain versions, equal, bf16 and fp32,
   on the halves of ``out_proj`` (K = 384 a rank), ``c_proj`` (1,536) and the
   dx products of ``in_proj`` and ``c_fc`` at M = 3,152; the two halves'
   int32 route (the global row scale, the int32 sum, the rescale) against
   the unsplit K6 bit for bit, dynamic and static; the rank-local row scale
   flips codes; the times beside the bound, the plain version and the
   library route.  Then ViT-B/16 at full width and depth, B = 16, with
   ``PEFT.PROMPT_TOKENS`` = 1 (198 tokens, 99 a shard between the regions)
   as two tensor-parallel and two sequence-parallel shards (the shards in
   threads of one process, the model group's collectives exchanges between
   them) under each hook (VPT shallow and deep, the adapter, AdapterDrop,
   Compacter, KAdaptation, the shared qkv adapter, LePE, RPB,
   ``lora_ref_reshape``, int8 attention and the int8 static recipe): the
   logits against the whole model (bf16 0.1, fp32 1e-4 of the largest
   logit; int8 the int8 bounds), every fp32 trainable gradient within 1e-4
   (int8 within its bound), K1-K3 and K7 twice the whole model's launches
   (once a shard) and on RPB's shards' operands against their plain
   versions.

The last two lines of standard output are a JSON object with the kernels'
numbers and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense tensor-core bf16
INT8_OPS_PER_S = 1979e12  # dense tensor-core int8
# ViT-B/16's width, heads and patch; 4 of its 12 blocks in the flagship's
# phases (slice to graph, the driver, the zero-shot drives, intrinsic), for
# the script's time: every kernel launches once a block, so the cut removes
# repeats of the same shapes, none of them
WIDTH, LAYERS, HEADS, IMAGE, PATCH = 768, 4, 12, 224, 16
OUTPUT_DIM, NUM_CLASSES, LORA_RANK = 512, 100, 4
N_TOKENS, HEAD_DIM = (IMAGE // PATCH) ** 2 + 1, WIDTH // HEADS
BUCKETS = (1, 8, 32)
FULLSHOT_BATCH = 64  # vitb16_sup.yaml's TRAIN.BATCH_SIZE_PER_GPU
TIMED_BATCHES = (1, 8, 16, 32, FULLSHOT_BATCH)  # K1; K2 and K3 at the training batches among them
TRAIN_TIMED_BATCHES = (8, 16, 32, FULLSHOT_BATCH)
REQUESTS = (1, 5, 8, 32, 40)
CHECKED_REQUEST = 5
TRAIN_BATCH, TRAIN_STEPS, TRAIN_K, TRAIN_WINDOWS = 16, 4, 8, 7
# Device launches (kernels and copies) of one bf16 training step as the
# profiler counts them: 1,392 while delta = rowsum(dO o O) was a PyTorch
# expression (two casts, a product and a sum in each of the 12 layers'
# backward), 48 fewer since the dq kernel computes it.  Printed beside the
# profile; a copy more or less between profiled steps moves the count, so
# the check is on the Function's backward (backward_kernel_checks).
TRAIN_STEP_LAUNCHES_12 = 1392 - 4 * 12  # at all 12 blocks
FIXED_BATCH_STEPS = 8
F32_BATCH, F32_STEPS = 4, 3
TRAINABLE = LAYERS * 2 * 2 * WIDTH * LORA_RANK + OUTPUT_DIM * NUM_CLASSES + NUM_CLASSES
# The int8 frozen tower: the four GEMMs of a block as (name, K, N); the dx
# products run the same four transposed.  M = batch x tokens.
INT8_GEMMS = (("in_proj", WIDTH, 3 * WIDTH), ("out_proj", WIDTH, WIDTH),
              ("c_fc", WIDTH, 4 * WIDTH), ("c_proj", 4 * WIDTH, WIDTH))
INT8_BATCHES = (1, 8, 16, 32)  # the serving buckets and the training batch
INT8_F32_BATCHES = (F32_BATCH, 8)  # the fp32 card-vs-CPU runs: training batch, serving bucket
INT8_TRAIN_STEPS = 3
INT8_KERNEL_LINE = ("c_fc", TRAIN_BATCH)  # the GEMM and batch of the kernels line

# Tolerances, each with its reason.
TOL_BF16_OUT = 2e-2  # the repo's bf16 flash pin: p and o rounded to bf16 at other points
TOL_F32_OUT = 1e-4  # fp32 throughout; sums in another order than cuBLAS
TOL_LSE = 1e-3  # fp32 log-sum-exp of the same scores, another summation order
# Gradients of the backward kernels, as max |diff| / max |plain| per tensor.
# bf16: a gradient is rounded to bf16 once, so a sum that lands across a
# rounding boundary moves it one bf16 step, 2^-8 of its value, at most 3.9e-3
# of the tensor's max; ds and p rounded across a boundary add less.  Bound
# 1e-2, about 2.5 steps at the max.
TOL_BF16_GRAD_REL = 1e-2
# fp32: the same arithmetic; sums in another order than cuBLAS and expf
# against torch.exp (2 ulp).
TOL_F32_GRAD_REL = 1e-4
# delta = rowsum(dO o O), which K2 computes: fp32 sums of the same 64
# products in another order than torch's, so each stands within a few fp32
# ulps of the row's sum of |products|; bound 1e-5 of the largest such sum.
TOL_DELTA_REL = 1e-5
# Logits, as max |diff| / max |logit| against the same model in fp32 on the CPU.
# fp32 on the card: only the summation order differs, over 12 layers.
TOL_F32_LOGITS_REL = 1e-3
# bf16 on the card: bf16 keeps 8 significant bits, so each GEMM output and
# residual add rounds at ~4e-3 relative, and 12 random-weight layers grow
# that to several percent (6.9e-2 measured on the H100); the same model in
# bf16 on the CPU, with no kernel, is printed beside it as the yardstick.
TOL_BF16_LOGITS_REL = 1e-1
# Training, fp32 on the card against fp32 on the CPU, the same 3 steps: the
# same arithmetic with sums in another order (cuBLAS and the kernels against
# the CPU), through 12 layers forward and backward.  The comparison steps at
# lr 1e-5: at the benchmark's 1e-3 a step moves the LoRA leaves (~0.02) by
# more than their size (gradients of ~30 per element at alpha/rank = 32), the
# loss jumps from step to step, and two fp32 runs part by percents within 3
# steps (measured on the H100: losses 3.8e-2 apart, updates 0.7), which says
# nothing about the kernels.  Loss relative; update as max |diff| / max
# |update| over the leaves.
COMPARE_LR = 1e-5
TOL_F32_TRAIN_LOSS_REL = 1e-4
TOL_F32_TRAIN_UPDATE_REL = 1e-2
# bf16 compute on the card against fp32 on the CPU, the same steps at the
# training batch of 16: the logits already differ by several percent (see
# above).  At B = 4 train-mode BN divides by the spread of 4 rows and the
# loss of a batch moved by up to 14 % (measured on the H100).
TOL_BF16_TRAIN_LOSS_REL = 1e-1
# The bf16 card's update of each leaf after those steps against the CPU's fp32
# update, by cosine.  On this random-weight model bf16 rounding alone turns a
# LoRA leaf's gradient far from the fp32 one: measured on the H100, the least
# cosine over the 50 leaves was 0.63-0.66 and the median 0.73-0.74, and no
# nearer with the plain dq and dk/dv in the kernels' place (printed beside
# it).  So this bound only catches a backward that is grossly wrong; the one
# below holds the kernels.
TOL_BF16_TRAIN_UPDATE_COS_LEAST = 0.45
TOL_BF16_TRAIN_UPDATE_COS_MEDIAN = 0.6
# One bf16 step of the main path against the same step with the plain dq and
# dk/dv in the backward kernels' place (the forward kernel stays): the
# forward is then bit-identical, and the backward is linear in dO, so the two
# updates differ only by the kernels' bf16 rounding of every layer's dq, dk
# and dv, carried down 12 layers.  Per leaf: cosine (0.9999 measured) and max
# |diff| / max |update| (1.9e-2 measured).
TOL_KERNEL_BWD_UPDATE_COS = 0.999
TOL_KERNEL_BWD_UPDATE_REL = 5e-2

# int8: the kernel repeats its plain version's arithmetic step by step (IEEE
# division, round half to even, an exact integer sum, two multiplies in the
# same order), so every output is held to equality, bf16 and fp32.
TOL_INT8_KERNEL = 0.0
# int8 serving against the bf16 session on the same weights: per-row int8
# activations and per-channel int8 weights add about 1/127 of each GEMM's
# operands as noise, through 48 GEMMs of a random-weight tower.  Measured on
# the H100: 9.9e-2 (bf16 itself stands 6.9e-2 from fp32).
TOL_INT8_VS_BF16_LOGITS_REL = 1.5e-1
# fp32 int8 on the card against fp32 int8 on the CPU: outside the GEMMs the
# two differ at 1e-6, which flips a code at a .5 boundary here and there, one
# step of 1/127 of a row's range each, in 48 GEMMs of a random-weight tower.
# Measured on the H100: 3.4e-2; the CPU model itself moves by as much when its
# input is scaled by 1 + 1e-6 (printed beside it).  What holds the kernel in
# the model is the check before it: the same forward with the plain versions
# in the kernel's place, equal bit for bit.
TOL_INT8_F32_LOGITS_REL = 6e-2

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def environment_phase() -> str:
    smi = nvidia_smi()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    # fp32 references run in full fp32 (cuDNN convolutions default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase(ptxas_verbose: bool = False, niceness: int = 0) -> float:
    from peft_vit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=ptxas_verbose, niceness=niceness)
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        print(f"built lib{name}.so")
        if ptxas_verbose and text.strip():
            print(text.strip())
    if ptxas_verbose:
        for name, label in (("flash_attn_fwd", "K1"), ("fused_short_attn", "K4")):
            for line in ptxas_summary(logs.get(name, "")):
                print(f"ptxas {label} {line}")
        for line in ptxas_bwd_summary(logs):
            print(f"ptxas {line}")
        for line in ptxas_int8_summary(logs.get("int8_gemm", "")):
            print(f"ptxas K6 {line}")
        for line in ptxas_bias_grad_summary(logs.get("attn_bias_grad", "")):
            print(f"ptxas K7 {line}")
    print(f"build seconds {seconds:.2f}")
    return seconds


def ptxas_summary(text: str) -> list:
    """One line per instantiation of the sm90 attention forward in an
    ``nvcc -Xptxas -v`` log: its head dim, key width, resident or streamed,
    registers, spills, static shared memory, the dynamic shared memory its
    launcher asks for (as ``attn_fwd_sm90.cuh`` sizes it), and whether ptxas
    serialized its wgmma instructions for want of registers (C7512)."""
    import re

    serialized = set(re.findall(r"C7512.*?for the function '(\S+)'", text))
    lines, current = [], None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            args = re.search(r"attn_fwd_sm90_kernelILi(\d+)ELb([01])ELb([01])ELb([01])ELi(\d+)E",
                             found.group(1))
            current = None if args is None else {
                "keys": int(args.group(1)), "stream": args.group(2) == "1",
                "bias": args.group(4) == "1", "d": int(args.group(5)),
                "serialized": found.group(1) in serialized}
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            current["spill"] = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if used:
            stores, loads = current.get("spill", (0, 0))
            keys, stages, row = current["keys"], 2 if current["stream"] else 1, 2 * current["d"]
            k_span = (keys * row + 1023) // 1024 * 1024
            dynamic = 128 * row + stages * (k_span + (keys + 15) // 16 * 16 * row) + 1024
            lines.append(
                f"D={current['d']} keys={keys} {'streamed' if current['stream'] else 'resident'}"
                f"{' bias' if current['bias'] else ''}: "
                f"{used.group(1)} registers, spill stores {stores} B, spill loads {loads} B, "
                f"static smem {used.group(2)} B, dynamic smem {dynamic} B"
                + (", wgmma serialized (C7512)" if current["serialized"] else ""))
            current = None
    return sorted(lines, key=lambda x: (x.split()[0], ("bias" in x), ("streamed" in x),
                                        int(x.split()[1][5:])))


SM_REGISTERS, SM_SHARED_BYTES, BLOCK_RESERVED_SHARED = 65536, 233472, 1024  # H100, a SM


def ptxas_bwd_summary(logs: dict) -> list:
    """One line for each role of the sm90 backward kernel (K2 and K3 in the
    ``flash_attn_bwd`` library's ``nvcc -Xptxas -v`` log, K5 in the
    ``fused_short_attn`` library's): registers a thread, spills, shared
    memory (static, and the dynamic size the library's launcher asks for),
    the blocks of 128 threads a SM holds at those registers and that shared
    memory, and whether ptxas serialized its wgmma instructions (C7512)."""
    import re

    from peft_vit_tpu_torch.ops import attention as attn

    lines = []
    for library, smem_fn in (("flash_attn_bwd", "flash_attn_bwd_smem_bytes"),
                             ("fused_short_attn", "fused_short_attn_bwd_smem_bytes")):
        text = logs.get(library, "")
        smem_of = getattr(attn._kernel_library(library), smem_fn)
        serialized = set(re.findall(r"C7512.*?for the function '(\S+)'", text))
        current = None
        for line in text.splitlines():
            found = re.search(r"Compiling entry function "
                              r"'(\S*attn_bwd_sm90_kernelILi(\d)ELb([01])ELi(\d+)E\S*)'", line)
            if found:
                d = int(found.group(4))
                current = {"kernel": ("K2", "K3", "K5")[int(found.group(2))]
                           + (" bias" if found.group(3) == "1" else "") + f" D={d}",
                           "serialized": found.group(1) in serialized,
                           "dynamic": smem_of(d) if library == "flash_attn_bwd" else smem_of()}
                continue
            if current is None:
                continue
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                current["spill"] = (int(spill.group(1)), int(spill.group(2)))
            used = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
            if used:
                regs, static = int(used.group(1)), int(used.group(2))
                dynamic = current["dynamic"]
                by_regs = SM_REGISTERS // ((regs + 7) // 8 * 8 * 128)
                by_smem = SM_SHARED_BYTES // (dynamic + static + BLOCK_RESERVED_SHARED)
                stores, loads = current.get("spill", (0, 0))
                lines.append(
                    f"{current['kernel']}: {regs} registers, spill stores {stores} B, "
                    f"spill loads {loads} B, static smem {static} B, dynamic smem {dynamic} B, "
                    f"blocks a SM {min(by_regs, by_smem)} (registers {by_regs}, shared memory "
                    f"{by_smem})" + (", wgmma serialized (C7512)" if current["serialized"] else ""))
                current = None
    return sorted(lines)


def ptxas_bias_grad_summary(text: str) -> list:
    """One line for each kernel of K7 in the ``attn_bias_grad`` library's
    ``nvcc -Xptxas -v`` log (``bias_grad_bf16_kernel<from o, D>``,
    ``bias_grad_f32_kernel<D>``, ``bias_grad_sum_kernel``): registers a
    thread, spills and static shared memory; for the bf16 kernel also the
    dynamic shared memory its launcher asks for at ``BIAS_GRAD_CHUNK``
    elements a chunk (``attn_bias_grad_smem_bytes``), the blocks of 128 threads a SM holds
    and whether ptxas serialized its wgmma (C7512)."""
    import re

    from peft_vit_tpu_torch.ops import attention as attn

    smem_of = attn._kernel_library("attn_bias_grad").attn_bias_grad_smem_bytes
    serialized = set(re.findall(r"C7512.*?for the function '(\S+)'", text))
    lines, current = [], None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\S*bias_grad_(bf16|f32|sum)_kernel"
                          r"(?:I(?:Lb([01])E)?Li(\d+)E)?\S*)'", line)
        if found:
            kind, from_o, d = found.group(2), found.group(3), found.group(4)
            current = {"name": kind + (f" D={d}" if d else "")
                       + {"1": " from o", "0": " delta given"}.get(from_o, ""),
                       "dynamic": (smem_of(int(d), int(from_o), attn.BIAS_GRAD_CHUNK)
                                   if kind == "bf16" else 0),
                       "bf16": kind == "bf16", "serialized": found.group(1) in serialized}
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            current["spill"] = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used:  # ptxas names no smem when the kernel has no static shared memory
            regs, static = int(used.group(1)), int(used.group(2) or 0)
            stores, loads = current.get("spill", (0, 0))
            out = (f"{current['name']}: {regs} registers, spill stores {stores} B, spill loads "
                   f"{loads} B, static smem {static} B")
            if current["bf16"]:
                dynamic = current["dynamic"]
                by_regs = SM_REGISTERS // ((regs + 7) // 8 * 8 * 128)
                by_smem = SM_SHARED_BYTES // (dynamic + static + BLOCK_RESERVED_SHARED)
                out += (f", dynamic smem {dynamic} B, blocks a SM {min(by_regs, by_smem)} "
                        f"(registers {by_regs}, shared memory {by_smem})"
                        + (", wgmma serialized (C7512)" if current["serialized"] else ""))
            lines.append(out)
            current = None
    return sorted(lines)


def ptxas_int8_summary(text: str) -> list:
    """One line for each instantiation of K6 (``int8_gemm_kernel<T, kScale,
    kRaw>`` in the ``int8_gemm`` library's ``nvcc -Xptxas -v`` log; the K-cut
    form's as "rows" / "static" with "int32 out"):
    registers a thread, spills, static shared memory, and at each K of the
    path the dynamic shared memory and weight-ring depth the launcher takes
    (``int8_gemm_smem_bytes`` / ``int8_gemm_stages``), the blocks of 256
    threads a SM holds, and whether ptxas serialized its wgmma (C7512)."""
    import re

    from peft_vit_tpu_torch.ops import int8 as i8

    lib = i8._kernel_library()
    ks = sorted({k for _, k, _ in INT8_GEMMS} | {n for _, _, n in INT8_GEMMS})
    serialized = set(re.findall(r"C7512.*?for the function '(\S+)'", text))
    lines, current = [], None
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '(\S*int8_gemm_kernelI(13__nv_bfloat16|f)"
                          r"Li([012])ELb([01])E\S*)'", line)
        if found:
            current = {"name": f"{'bf16' if found.group(2) != 'f' else 'fp32'} "
                               f"{('dynamic', 'static', 'rows')[int(found.group(3))]}"
                               + (" int32 out" if found.group(4) == "1" else ""),
                       "serialized": found.group(1) in serialized}
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            current["spill"] = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if used:  # ptxas names no smem when the kernel has no static shared memory
            regs, static = int(used.group(1)), int(used.group(2) or 0)
            by_regs = SM_REGISTERS // ((regs + 7) // 8 * 8 * 256)
            dynamic = [lib.int8_gemm_smem_bytes(k) for k in ks]
            by_smem = [SM_SHARED_BYTES // (d + static + BLOCK_RESERVED_SHARED) for d in dynamic]
            stores, loads = current.get("spill", (0, 0))
            per_k = " / ".join(str(k) for k in ks)
            lines.append(
                f"{current['name']}: {regs} registers, spill stores {stores} B, spill loads "
                f"{loads} B, static smem {static} B; at K = {per_k}: dynamic smem "
                f"{' / '.join(str(d) for d in dynamic)} B, ring "
                f"{' / '.join(str(lib.int8_gemm_stages(k)) for k in ks)} stages, blocks a SM "
                f"{' / '.join(str(min(by_regs, b)) for b in by_smem)} (registers {by_regs})"
                + (", wgmma serialized (C7512)" if current["serialized"] else ""))
            current = None
    return sorted(lines)


def _device_ms(fn, reps: int, trials: int = 5) -> float:
    """Median over trials of one CUDA-graph replay of ``reps`` calls, per
    call: device time without the host's launch overhead."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _eager_ms(fn, reps: int, trials: int = 5) -> float:
    """Median per-call time of ``reps`` back-to-back eager calls (includes
    the wrapper's host time when that exceeds the kernel's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound(b: int, h: int, n: int, d: int, itemsize: int, kernel: str):
    """Least time for the function: each (B, H, N, D) operand read once and
    each result written once, with the fp32 rows (lse, delta) a backward
    reads or writes, against its flops at the bf16 tensor-core peak.  fwd
    (K1, and K4 as timed, without the lse): q, k, v -> o, two products; dq:
    q, k, v, o, dO, lse -> dq, delta, three (K2 computes delta from o and
    dO); dkv: q, k, v, dO, lse, delta -> dk, dv, four; fused_bwd (K5): q, k,
    v, o, dO, lse -> dq, dk, dv, five (q k^T, dO v^T, p^T dO, ds k, ds^T q)."""
    tensors, products, rows = {"fwd": (4, 2, 0), "dq": (6, 3, 2), "dkv": (6, 4, 2),
                               "fused_bwd": (8, 5, 1)}[kernel]
    bytes_moved = tensors * b * h * n * d * itemsize + rows * b * h * n * 4
    flops = 2 * products * b * h * n * n * d
    t_bytes, t_flops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def kernel_phase(timing: bool = True) -> dict:
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    # (name, B, N, dtype, scale, q std, bias, lse, tolerance of o).  The
    # serving path calls the kernel at scale 1.0 with q already multiplied
    # by 1/sqrt(D) (post-scale-q), so that case draws q at std 1/8.
    # The first cases are the main paths' own: every serving bucket, the
    # training batch with lse, and the full-shot batch with lse at the timm
    # tower's scale (no PEFT delta: q unscaled, 1/sqrt(64) in the kernel).
    cases = [
        *((f"bf16 scale=1.0 (post-scaled q), serving bucket {b}", b, N_TOKENS, torch.bfloat16,
           1.0, 0.125, False, False, TOL_BF16_OUT) for b in BUCKETS),
        ("bf16 scale=1.0 (post-scaled q) lse, training batch", TRAIN_BATCH, N_TOKENS,
         torch.bfloat16, 1.0, 0.125, False, True, TOL_BF16_OUT),
        ("bf16 scale=0.125 lse, full-shot batch", FULLSHOT_BATCH, N_TOKENS, torch.bfloat16,
         0.125, 1.0, False, True, TOL_BF16_OUT),
        ("bf16 scale=0.125", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, False, False, TOL_BF16_OUT),
        ("bf16 bias", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, True, False, TOL_BF16_OUT),
        ("bf16 lse", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, False, True, TOL_BF16_OUT),
        ("bf16 ragged N=50 bias lse", 2, 50, torch.bfloat16, 0.125, 1.0, True, True, TOL_BF16_OUT),
        ("bf16 ragged N=257 bias lse", 2, 257, torch.bfloat16, 0.125, 1.0, True, True, TOL_BF16_OUT),
        ("fp32 bias lse", 2, N_TOKENS, torch.float32, 0.125, 1.0, True, True, TOL_F32_OUT),
        ("fp32 ragged N=257", 2, 257, torch.float32, 0.125, 1.0, False, True, TOL_F32_OUT),
    ]
    main_err = {}  # by batch, of the main paths' cases
    for i, (name, b, n, dtype, scale, q_std, with_bias, with_lse, tol) in enumerate(cases):
        shape = (b, HEADS, n, HEAD_DIM)
        q, k, v = rand(shape, dtype, q_std), rand(shape, dtype), rand(shape, dtype)
        bias = rand((HEADS, n, n), torch.float32) if with_bias else None
        out = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=with_lse)
        ref = attn._flash_attention_plain(q, k, v, bias, scale, with_lse)
        torch.cuda.synchronize()
        if with_lse:
            (out, lse), (ref, ref_lse) = out, ref
            lse_err = (lse - ref_lse).abs().max().item()
            check(lse.shape == (b, HEADS, 1, n) and lse_err <= TOL_LSE,
                  f"kernel {name}: lse max abs err {lse_err:.3e} <= {TOL_LSE:g}")
        err = (out.float() - ref.float()).abs().max().item()
        check(out.shape == shape and bool(torch.isfinite(out).all()) and err <= tol,
              f"kernel {name} {tuple(shape)}: out max abs err {err:.3e} <= {tol:g}")
        if i <= len(BUCKETS) + 1:
            main_err[b] = err

    edge_checks(attn, rand, "K1")
    bwd_err = backward_kernel_checks(attn, rand)
    # the kernels line gives the forward's error at the batch of its times
    result = {"max_abs_err": {"fwd": main_err[BUCKETS[1]], **bwd_err["main"]},
              "max_abs_err_fullshot": {"fwd": main_err[FULLSHOT_BATCH], **bwd_err["fullshot"]},
              "fwd": {}, "dq": {}, "dkv": {}}
    if timing:
        kernel_timing(attn, rand, result)
    return result


# N at the edges of the sm90 forward's designs: one resident product of
# width round_up(N, 8) up to N = 256, 64-key tiles streamed beyond (K4 in two
# passes); 8 and 64 the narrowest widths, 577 ViT-B/16 at 384 px, 1024 the
# fused pair's bound (K4 only).
EDGE_NS = (8, 64, 196, 200, 255, 256, 257, 577)
EDGE_BATCHES = (1, 32)


def edge_checks(attn, rand, kernel: str) -> None:
    """K1 (``flash_attention_fwd``) or K4 (``fused_short_attention_fwd``)
    against its plain version at every N of ``EDGE_NS`` (K4 also 1024), B =
    1 and 32, bf16 and fp32, at scale 1 with post-scaled q and at 0.125; the
    lse and (K1) the bias alternate so that each N sees each with and
    without."""
    ns = EDGE_NS + ((1024,) if kernel == "K4" else ())
    for n in ns:
        for b in EDGE_BATCHES:
            for dtype in (torch.bfloat16, torch.float32):
                for scale, q_std in ((1.0, 0.125), (0.125, 1.0)):
                    with_lse = (scale == 1.0) == (b == 1)
                    with_bias = kernel == "K1" and (dtype == torch.float32) == (scale == 1.0)
                    shape = (b, HEADS, n, HEAD_DIM)
                    q, k, v = rand(shape, dtype, q_std), rand(shape, dtype), rand(shape, dtype)
                    bias = rand((HEADS, n, n), torch.float32) if with_bias else None
                    if kernel == "K1":
                        got = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=with_lse)
                        want = attn._flash_attention_plain(q, k, v, bias, scale, with_lse)
                    else:
                        got = attn.fused_short_attention_fwd(q, k, v, scale, return_lse=with_lse)
                        want = attn._fused_short_fwd_plain(q, k, v, scale, with_lse)
                    torch.cuda.synchronize()
                    (got, lse), (want, ref_lse) = ((got, want) if with_lse
                                                   else ((got, None), (want, None)))
                    tol = TOL_BF16_OUT if dtype == torch.bfloat16 else TOL_F32_OUT
                    err = (got.float() - want.float()).abs().max().item()
                    lse_err = 0.0 if lse is None else (lse - ref_lse).abs().max().item()
                    tag = (f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} scale={scale}"
                           f"{' bias' if with_bias else ''}{' lse' if with_lse else ''}")
                    check(got.shape == shape and bool(torch.isfinite(got).all()) and err <= tol
                          and lse_err <= TOL_LSE,
                          f"edge {kernel} {tag} {shape}: out max abs err {err:.3e} <= {tol:g}"
                          + ("" if lse is None else f", lse {lse_err:.3e} <= {TOL_LSE:g}"))


def backward_kernel_checks(attn, rand) -> dict:
    """K2 (dq, and delta) and K3 (dk, dv) against ``_flash_attention_bwd_plain``
    on the card, o and lse from K1, K2's delta against ``_row_dot`` and fed
    to K3; then the whole ``flash_attention`` Function in fp32 against
    autograd through ``attention_reference``.  N = 50, 197 and 257 and 577
    cover one to four resident 64-row chunks and the streamed ring (N >
    256), ragged last chunks among them; B = 1 a grid of one block column.
    Returns the max abs errors of the first two cases, which have the
    training path's shape (``main``) and the full-shot path's
    (``fullshot``)."""
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, B, N, dtype, scale, q std, relative tolerance)
    cases = [
        ("bf16 scale=1.0 (post-scaled q), training batch", TRAIN_BATCH, N_TOKENS, bf16, 1.0, 0.125,
         TOL_BF16_GRAD_REL),
        ("bf16 scale=0.125, full-shot batch", FULLSHOT_BATCH, N_TOKENS, bf16, 0.125, 1.0,
         TOL_BF16_GRAD_REL),
        ("bf16 scale=0.125", 8, N_TOKENS, bf16, 0.125, 1.0, TOL_BF16_GRAD_REL),
        ("bf16 B=1", 1, N_TOKENS, bf16, 1.0, 0.125, TOL_BF16_GRAD_REL),
        ("bf16 ragged N=50", 2, 50, bf16, 0.125, 1.0, TOL_BF16_GRAD_REL),
        ("bf16 ragged N=257 (streamed)", 2, 257, bf16, 0.125, 1.0, TOL_BF16_GRAD_REL),
        ("bf16 N=577 (streamed)", 2, 577, bf16, 1.0, 0.125, TOL_BF16_GRAD_REL),
        ("fp32 N=197", 2, N_TOKENS, f32, 0.125, 1.0, TOL_F32_GRAD_REL),
        ("fp32 B=1 ragged N=50", 1, 50, f32, 1.0, 0.125, TOL_F32_GRAD_REL),
        ("fp32 ragged N=257", 2, 257, f32, 0.125, 1.0, TOL_F32_GRAD_REL),
        ("fp32 N=577", 2, 577, f32, 1.0, 0.125, TOL_F32_GRAD_REL),
    ]
    main = []
    for name, b, n, dtype, scale, q_std, tol in cases:
        shape = (b, HEADS, n, HEAD_DIM)
        q, k, v, do = rand(shape, dtype, q_std), rand(shape, dtype), rand(shape, dtype), rand(shape, dtype)
        o, lse = attn.flash_attention_fwd(q, k, v, None, scale, return_lse=True)
        dq, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale)
        dk, dv = attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
        want = attn._flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        want_delta = attn._row_dot(do, o)
        torch.cuda.synchronize()
        # delta: two fp32 sums of the same 64 products in other orders
        scale_delta = (do.float() * o.float()).abs().sum(-1).max().item()
        delta_err = (delta - want_delta).abs().max().item()
        check(delta.shape == (b, HEADS, 1, n) and delta.dtype == f32
              and delta_err <= TOL_DELTA_REL * scale_delta,
              f"kernel bwd {name} {tuple(shape)}: delta max abs err {delta_err:.3e} <= "
              f"{TOL_DELTA_REL:g} x max sum |dO o O| ({scale_delta:.3e})")
        errs = {"delta": delta_err}
        for what, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            errs[what] = err
            check(got.shape == shape and got.dtype == dtype and bool(torch.isfinite(got).all())
                  and rel <= tol,
                  f"kernel bwd {name} {tuple(shape)}: {what} max abs err {err:.3e}, "
                  f"/ max |plain| = {rel:.3e} <= {tol:g}")
        if len(main) < 2:
            main.append({"dq": errs["dq"], "dkv": max(errs["dk"], errs["dv"]),
                         "delta": delta_err})

    # the Function's backward launches the two kernels and nothing else: the
    # dq kernel computes delta, so no PyTorch expression runs for it
    shape = (TRAIN_BATCH, HEADS, N_TOKENS, HEAD_DIM)
    q, k, v = (rand(shape, bf16, std).requires_grad_() for std in (0.125, 1.0, 1.0))
    out = attn.flash_attention(q, k, v, None, 1.0)
    w = rand(shape, bf16)
    _, launches, top = _device_breakdown(
        lambda: torch.autograd.grad(out, (q, k, v), w, retain_graph=True), reps=1)
    check(launches == 2,
          f"flash_attention backward bf16 {tuple(shape)}: {launches} device launches == 2 "
          "(dq with delta, dk/dv): " + "; ".join(name for name, _ in top))

    shape = (2, HEADS, N_TOKENS, HEAD_DIM)
    q, k, v = (rand(shape, f32).requires_grad_() for _ in range(3))
    w = rand(shape, f32)
    got = torch.autograd.grad(attn.flash_attention(q, k, v, None, 0.125), (q, k, v), w)
    want = torch.autograd.grad(attn.attention_reference(q, k, v, None, 0.125), (q, k, v), w)
    torch.cuda.synchronize()
    for what, g_, r_ in zip(("dq", "dk", "dv"), got, want):
        rel = ((g_ - r_).abs().max() / r_.abs().max()).item()
        check(rel <= TOL_F32_GRAD_REL,
              f"flash_attention Function fp32 {tuple(shape)} vs autograd of the reference: "
              f"{what} max |diff| / max |ref| = {rel:.3e} <= {TOL_F32_GRAD_REL:g}")
    return dict(zip(("main", "fullshot"), main))


def flash_backward(attn, q, k, v, o, lse, do):
    """The backward that ``flash_attention`` runs: K2, which computes delta,
    then K3."""
    dq, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, 1.0)
    return (dq, *attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 1.0))


def kernel_timing(attn, rand, result: dict) -> None:
    """Device time of each kernel (CUDA-graph replay, bf16, scale 1, q at std
    1/8) beside its bound, its plain version and the library yardstick:
    ``scaled_dot_product_attention`` forward for K1, and its backward through
    ``torch.autograd.grad`` beside K2 (with delta inside) + K3."""
    import torch.nn.functional as F

    for b in TIMED_BATCHES:
        shape = (b, HEADS, N_TOKENS, HEAD_DIM)
        q = rand(shape, torch.bfloat16, 0.125)
        k, v, do = (rand(shape, torch.bfloat16) for _ in range(3))
        reps = 200
        row = {
            "ms": _device_ms(lambda: attn.flash_attention_fwd(q, k, v, None, 1.0), reps),
            "plain_ms": _device_ms(lambda: attn._flash_attention_plain(q, k, v, None, 1.0, False), 50),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), reps),
            "eager_ms": _eager_ms(lambda: attn.flash_attention_fwd(q, k, v, None, 1.0), reps),
        }
        row["bound_ms"], row["bound_by"] = attention_bound(b, HEADS, N_TOKENS, HEAD_DIM, 2, "fwd")
        result["fwd"][b] = row
        _print_timing("flash_attn_fwd", b, shape, row)
        if b not in TRAIN_TIMED_BATCHES:
            continue

        o, lse = attn.flash_attention_fwd(q, k, v, None, 1.0, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, 1.0)
        args = {"dq": (q, k, v, do, lse, o, 1.0), "dkv": (q, k, v, do, lse, delta, 1.0)}
        sdpa_bwd = _sdpa_bwd_ms(q, k, v, do, reps)
        ours_bwd = _device_ms(lambda: flash_backward(attn, q, k, v, o, lse, do), reps)
        for key, fn, plain_fn in (("dq", attn.flash_attention_bwd_dq, attn._bwd_dq_plain),
                                  ("dkv", attn.flash_attention_bwd_dkv, attn._bwd_dkv_plain)):
            row = {"ms": _device_ms(lambda: fn(*args[key]), reps),
                   "plain_ms": _device_ms(lambda: plain_fn(*args[key]), 50)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, HEADS, N_TOKENS, HEAD_DIM, 2, key)
            result[key][b] = row
            _print_timing(f"flash_attn_bwd_{key}", b, shape, row)
        for key in ("dq", "dkv"):  # the library computes dq, dk and dv in one backward
            result[key][b]["library_ms"] = sdpa_bwd
            result[key][b]["backward_ms"] = ours_bwd
        print(f"kernel timing B={b} backward: dq (with delta) + dk/dv {ours_bwd:.6f} ms, "
              f"scaled_dot_product_attention backward {sdpa_bwd:.6f} ms (forward and "
              "backward in one graph, less the forward alone)", flush=True)
    result["fwd_long"] = long_timing(attn, rand, "K1")


# K1, K2 and K3 with a bias, and K7 (the bias's gradient), the kernels of
# RPB's path: (B, C) at the training batch with one bias (C = 1) and a sweep
# round of 3 cells folded into the batch, each cell with its own bias; then
# (B, C, N) at the edges: ragged keys (N = 50), the streamed forward and two
# key tiles of K7 (N = 257), the narrowest product (N = 8).
BIAS_SHAPES = ((TRAIN_BATCH, 1), (3 * TRAIN_BATCH, 3))
BIAS_EDGES = ((1, 1, 50), (4, 2, 257), (6, 3, 8))
# K7 against its plain version: dbias[c] sums the B / C fp32 values of
# ds = p o (dp - delta) in another order than torch's sum (in chunks of the
# batch, the chunks' partials then added in chunk order), each from S and dP
# summed in another order (wgmma or fp32 FMAs against cuBLAS) and ex2.approx
# or expf against torch.exp: each term within a few fp32 ulps of |ds|, so a
# sum within about 1e-6 of sum |ds|.  Bound: 1e-4 of the cell's largest sum
# over its batch of |ds| (as K2's delta is held against sum |dO o O|).
TOL_DBIAS_REL = 1e-4
# (B, C) at N = 197 where K7's split of a cell's batch matters: a short last
# chunk (21 = 16 + 5), a batch of 13 (one short chunk), one element, cells of
# 5 (one chunk each) and cells of 32 (two chunks each)
BIAS_SPLIT_EDGES = ((21, 1), (13, 1), (1, 1), (15, 3), (96, 3))
# (B, C) on Swin-T's stage-2 fold (48 heads, N = 49, D = 32): a round of 3 rpb
# cells at the training batch, four chunks a cell
SWIN_SPLIT_EDGES = ((3 * 64, 3),)


def _bias(rand, c: int, n: int, zero_prefix: bool) -> torch.Tensor:
    """A (C, H, N, N) fp32 bias (C = 1: (H, N, N)) at about the scores'
    size; ``zero_prefix``: zero on row and column 0, as RPB's class token."""
    shape = (c, HEADS, n, n)
    bias = rand(shape, torch.float32, 0.5)
    if zero_prefix:
        bias[:, :, 0, :] = 0.0
        bias[:, :, :, 0] = 0.0
    return bias[0] if c == 1 else bias


def _dbias_scale(attn, q, k, v, do, lse, delta, bias, scale: float = 1.0) -> torch.Tensor:
    """Per cell, the largest sum over its batch of |ds| (fp32 plain), (C,)."""
    _, ds = attn._bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias)
    c = attn._bias_cells(bias)
    return ds.abs().unflatten(0, (c, -1)).sum(1).flatten(1).amax(1)


def bias_kernel_checks(attn, rand) -> dict:
    """K1 (out, lse), K2 (dq, delta), K3 (dk, dv) with a bias, and K7 with
    delta from K2 and with delta computed from o, against their plain
    versions on the card, bf16 and fp32, at ``BIAS_SHAPES`` and
    ``BIAS_EDGES``, the bias zero on its first row and column (RPB's class
    token) in every other case; the bounds the file states for K1 to K3 and
    ``TOL_DBIAS_REL`` for K7.  Returns the max abs errors of the first case,
    which has the training path's shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"{'bf16' if dt == bf16 else 'fp32'} B={b} C={c}", b, c, N_TOKENS, dt)
             for dt in (bf16, f32) for b, c in BIAS_SHAPES]
    cases += [(f"{'bf16' if dt == bf16 else 'fp32'} edge B={b} C={c} N={n}", b, c, n, dt)
              for dt in (bf16, f32) for b, c, n in BIAS_EDGES]
    main = None
    for i, (name, b, c, n, dtype) in enumerate(cases):
        shape = (b, HEADS, n, HEAD_DIM)
        q, k, v, do = (rand(shape, dtype, std) for std in (0.125, 1.0, 1.0, 1.0))
        bias = _bias(rand, c, n, zero_prefix=i % 2 == 0)
        errs = bias_case_checks(attn, name, q, k, v, do, bias, 1.0)
        if main is None:
            main = {"fwd_bias": errs["fwd"], "dq_bias": errs["dq"],
                    "dkv_bias": max(errs["dk"], errs["dv"]), "dbias": errs["dbias"]}
    bias_function_checks(attn, rand)
    bias_split_checks(attn, rand)
    return main


def bias_split_checks(attn, rand) -> None:
    """K7 (bf16) where its split of the batch matters: ``BIAS_SPLIT_EDGES``
    and ``SWIN_SPLIT_EDGES`` against the plain version
    (``bias_case_checks``), and each round of cells equal bit for bit to
    each of its cells alone; then, at ViT-B/16's B = 16 and on Swin-T's
    stage-2 fold at B = 64 (a split batch), the same operands three times
    and a CUDA graph of the call replayed twice, all equal to the first
    eager call bit for bit."""
    bf16 = torch.bfloat16
    vit = (HEADS, N_TOKENS, HEAD_DIM)
    cases = [(f"N={N_TOKENS} B={b} C={c}", (b, *vit), _bias(rand, c, N_TOKENS, i % 2 == 0),
              0.125, 1.0) for i, (b, c) in enumerate(BIAS_SPLIT_EDGES)]
    res, heads = SWIN_STAGES[2]
    for b, c in SWIN_SPLIT_EDGES:
        bias = swin_bias(rand, c, res, SWIN_WINDOW, heads, True, bf16)
        cases.append((f"Swin-T stage 2 B={b} C={c}",
                      (b, bias.shape[-3], SWIN_WINDOW ** 2, SWIN_HEAD_DIM), bias, 1.0,
                      SWIN_HEAD_DIM ** -0.5))
    for name, shape, bias, q_std, scale in cases:
        c = attn._bias_cells(bias)
        per = shape[0] // c
        q, k, v, do = (rand(shape, bf16, std) for std in (q_std, 1.0, 1.0, 1.0))
        name = f"bf16 split {name} ({attn.bias_grad_split(per)} chunk(s) a cell)"
        bias_case_checks(attn, name, q, k, v, do, bias, scale)
        if c == 1:
            continue
        o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
        for label, key, rows in (("delta from K2", "delta", delta), ("delta from o", "o", o)):
            whole = attn.attention_bias_grad(q, k, v, do, lse, scale, bias, **{key: rows})
            cell = lambda t, i: t[i * per:(i + 1) * per]
            alone = [attn.attention_bias_grad(*(cell(t, i) for t in (q, k, v, do, lse)), scale,
                                              bias[i], **{key: cell(rows, i)})
                     for i in range(c)]
            torch.cuda.synchronize()
            check(all(torch.equal(whole[i], a) for i, a in enumerate(alone)),
                  f"K7 {name} ({label}): the round == each of its {c} cells alone bit for bit")
    res, heads = SWIN_STAGES[2]
    swin = swin_bias(rand, 1, res, SWIN_WINDOW, heads, True, bf16)
    for name, shape, bias, scale in (
            ("ViT-B/16 B=16", (TRAIN_BATCH, *vit), _bias(rand, 1, N_TOKENS, True), 1.0),
            ("Swin-T stage 2 B=64", (SWIN_TIMED_BATCH, swin.shape[0], SWIN_WINDOW ** 2,
                                     SWIN_HEAD_DIM), swin, SWIN_HEAD_DIM ** -0.5)):
        q, k, v, do = (rand(shape, bf16) for _ in range(4))
        o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
        for label, kw in (("delta from K2", {"delta": delta}), ("delta from o", {"o": o})):
            call = lambda: attn.attention_bias_grad(q, k, v, do, lse, scale, bias, **kw)
            first = call()
            again = [call() for _ in range(2)]
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                call()
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = call()
            replays = []
            for _ in range(2):
                graph.replay()
                replays.append(captured.clone())
            torch.cuda.synchronize()
            check(all(torch.equal(first, t) for t in (*again, *replays)),
                  f"K7 bf16 {name} ({label}, {attn.bias_grad_split(shape[0])} chunk(s)): "
                  "three calls and two graph replays == the first call bit for bit")


def bias_case_checks(attn, name: str, q, k, v, do, bias, scale: float) -> dict:
    """K1 (out, lse), K2 (dq, delta), K3 (dk, dv) and K7 (delta from K2 and
    from o) on one case with a bias, against their plain versions, under the
    bounds the file states (``TOL_DBIAS_REL`` for K7).  Returns the max abs
    errors."""
    bf16, f32 = torch.bfloat16, torch.float32
    dtype, shape = q.dtype, tuple(q.shape)
    c = attn._bias_cells(bias)
    bf = dtype == bf16
    tol_out, tol_grad = (TOL_BF16_OUT, TOL_BF16_GRAD_REL) if bf else (TOL_F32_OUT,
                                                                        TOL_F32_GRAD_REL)
    o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
    want_o, want_lse = attn._flash_attention_plain(q, k, v, bias, scale, True)
    dq, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
    dk, dv = attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, bias)
    want = attn._flash_attention_bwd_plain(q, k, v, o, lse, do, scale, bias)
    dbias = attn.attention_bias_grad(q, k, v, do, lse, scale, bias, delta=delta)
    dbias_o = attn.attention_bias_grad(q, k, v, do, lse, scale, bias, o=o)
    want_dbias = attn._bias_grad_plain(q, k, v, do, lse, scale, bias, delta=delta)
    want_dbias_o = attn._bias_grad_plain(q, k, v, do, lse, scale, bias, o=o)
    torch.cuda.synchronize()
    errs = {"fwd": (o.float() - want_o.float()).abs().max().item()}
    lse_err = (lse - want_lse).abs().max().item()
    check(bool(torch.isfinite(o).all()) and errs["fwd"] <= tol_out and lse_err <= TOL_LSE,
          f"bias kernel K1 {name} {shape}: out max abs err {errs['fwd']:.3e} <= {tol_out:g}, "
          f"lse {lse_err:.3e} <= {TOL_LSE:g}")
    scale_delta = (do.float() * o.float()).abs().sum(-1).max().item()
    errs["delta"] = (delta - attn._row_dot(do, o)).abs().max().item()
    check(errs["delta"] <= TOL_DELTA_REL * scale_delta,
          f"bias kernel K2 {name}: delta max abs err {errs['delta']:.3e} <= "
          f"{TOL_DELTA_REL:g} x max sum |dO o O| ({scale_delta:.3e})")
    for what, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        errs[what] = err
        check(got.dtype == dtype and bool(torch.isfinite(got).all()) and rel <= tol_grad,
              f"bias kernel {'K2' if what == 'dq' else 'K3'} {name}: {what} max abs err "
              f"{err:.3e}, / max |plain| = {rel:.3e} <= {tol_grad:g}")
    cell_scale = _dbias_scale(attn, q, k, v, do, lse, delta, bias, scale)
    for label, got, ref in (("delta from K2", dbias, want_dbias),
                            ("delta from o", dbias_o, want_dbias_o)):
        per_cell = (got - ref).abs().reshape(c, -1).amax(1)
        worst = (per_cell / cell_scale).max().item()
        errs.setdefault("dbias", (got - ref).abs().max().item())
        check(got.shape == bias.shape and got.dtype == f32 and bool(torch.isfinite(got).all())
              and worst <= TOL_DBIAS_REL,
              f"bias kernel K7 {name} ({label}): max abs err a cell / that cell's max "
              f"sum_b |ds| = {worst:.3e} <= {TOL_DBIAS_REL:g} (max abs err "
              f"{(got - ref).abs().max().item():.3e})")
    return errs


def bias_function_checks(attn, rand) -> None:
    """The bias path's autograd Function on the card: bf16 rounds of 3
    cells under the vmap against each cell alone (16 and 32 elements a cell:
    K7's batch one chunk and two), K7 alone when only the bias needs a
    gradient, fp32 against autograd of the reference."""
    bf16, f32 = torch.bfloat16, torch.float32
    # the Function: a round of 3 cells, each with its own bf16 bias, under the
    # vmap equals each cell alone bit for bit (every kernel's arithmetic is a
    # batch element's or a cell's own); its backward launches K2, K3 and K7
    # once each, and K7 alone when only the bias needs a gradient
    from torch.func import vmap

    for per_cell in (2 * TRAIN_BATCH, TRAIN_BATCH):
        shape = (3, per_cell, HEADS, N_TOKENS, HEAD_DIM)
        q, k, v, do = (rand(shape, bf16, std) for std in (0.125, 1.0, 1.0, 1.0))
        bias = _bias(rand, 3, N_TOKENS, True).to(bf16)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        _zero_attention_counts(attn)
        out = vmap(lambda a, b_, c_, d: attn.flash_attention(a, b_, c_, d, 1.0))(*leaves)
        got = torch.autograd.grad(out, leaves, do)
        counts = _attention_counts(attn)
        alone = []
        for i in range(3):
            cell = [t[i].clone().requires_grad_() for t in (q, k, v, bias)]
            o_i = attn.flash_attention(*cell, 1.0)
            alone.append((o_i, *torch.autograd.grad(o_i, cell, do[i])))
        torch.cuda.synchronize()
        same = all(torch.equal(t[i], a[j]) for i, a in enumerate(alone)
                   for j, t in enumerate((out, *got)))
        check(same and counts["flash_attention_fwd"] == 1
              and counts["flash_attention_bwd_dq"] == 1
              and counts["flash_attention_bwd_dkv"] == 1 and counts["attention_bias_grad"] == 1,
              f"bias Function bf16: a round of 3 cells x {tuple(shape[1:])} with per-cell "
              f"biases under the vmap == each cell alone bit for bit (o, dq, dk, dv, dbias in "
              f"bf16; K7 {attn.bias_grad_split(per_cell)} chunk(s) a cell); one launch each of "
              f"K1, K2, K3, K7: {counts}")
    b32 = bias[0].float().requires_grad_()
    _zero_attention_counts(attn)
    (g,) = torch.autograd.grad(attn.flash_attention(q[0], k[0], v[0], b32, 1.0), (b32,), do[0])
    counts = _attention_counts(attn)
    check(counts["attention_bias_grad"] == 1 and counts["flash_attention_bwd_dq"] == 0
          and counts["flash_attention_bwd_dkv"] == 0 and g.dtype == f32,
          f"bias Function: only the bias needs a gradient: K7 alone (delta from o): {counts}")

    shape = (4, HEADS, N_TOKENS, HEAD_DIM)
    leaves = [rand(shape, f32).requires_grad_() for _ in range(3)]
    leaves.append(_bias(rand, 2, N_TOKENS, True).requires_grad_())
    w = rand(shape, f32)
    got = torch.autograd.grad(attn.flash_attention(*leaves, 0.125), leaves, w)
    want = torch.autograd.grad(attn.attention_reference(
        *leaves[:3], attn._batch_bias(leaves[3], 4), 0.125), leaves, w)
    torch.cuda.synchronize()
    for what, g_, r_ in zip(("dq", "dk", "dv", "dbias"), got, want):
        rel = ((g_ - r_).abs().max() / r_.abs().max()).item()
        check(rel <= TOL_F32_GRAD_REL,
              f"bias Function fp32 {tuple(shape)} C=2 vs autograd of the reference: {what} "
              f"max |diff| / max |ref| = {rel:.3e} <= {TOL_F32_GRAD_REL:g}")


def bias_bound(b: int, h: int, n: int, d: int, c: int, itemsize: int, from_o: bool = False):
    """K7's least time: q, k, v and dO read once (itemsize each), lse and
    delta (fp32) read, the (C, H, N, N) fp32 bias read and dbias written,
    against its two products (S = q k^T and dP = dO v^T, 2 B H N^2 D flops
    each) at the bf16 tensor-core peak.  ``from_o``: delta computed from O
    instead, O read in its place (and rowsum(dO o O)'s 2 B H N D flops)."""
    bytes_moved = ((5 if from_o else 4) * b * h * n * d * itemsize
                   + (1 if from_o else 2) * b * h * n * 4 + 2 * c * h * n * n * 4)
    flops = 2 * 2 * b * h * n * n * d + (2 * b * h * n * d if from_o else 0)
    t_bytes, t_flops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def bias_grad_times(attn, q, k, v, do, o, lse, delta, bias, scale: float, reps: int) -> dict:
    """K7's device times on one case (delta given, and from o), its plain
    version's and SDPA's backward with a float mask that requires a
    gradient."""
    chunks = attn.bias_grad_split(q.shape[0] // attn._bias_cells(bias))
    return {"ms": _device_ms(lambda: attn.attention_bias_grad(q, k, v, do, lse, scale, bias,
                                                              delta=delta), reps),
            "ms_from_o": _device_ms(lambda: attn.attention_bias_grad(q, k, v, do, lse, scale,
                                                                     bias, o=o), reps),
            "plain_ms": _device_ms(lambda: attn._bias_grad_plain(q, k, v, do, lse, scale, bias,
                                                                 delta=delta), 10),
            "library_ms": _sdpa_bias_bwd_ms(q, k, v, bias, do, reps, scale),
            "split": f"{attn.BIAS_GRAD_CHUNK} a chunk, {chunks} chunk(s)"
                     + (", sum kernel" if chunks > 1 else "")}


def _sdpa_bias_bwd_ms(q, k, v, bias, do, reps: int, scale: float = 1.0) -> float:
    """The ``scaled_dot_product_attention`` backward with a float
    ``attn_mask`` (the bias, (H, N, N) broadcast over the batch) that
    requires a gradient: dq, dk, dv and the mask's gradient, timed as
    ``_sdpa_bwd_ms`` times the bias-free one."""
    import torch.nn.functional as F

    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    bg = bias.to(q.dtype).clone().requires_grad_()
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bg, scale=scale)
    return (_device_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg, bg), do), reps)
            - _device_ms(sdpa, reps))


def bias_kernel_timing(attn, rand, result: dict) -> None:
    """At B = 16, bf16, scale 1 with post-scaled q, one bias: K1, K2 and K3
    with and without the bias (the same inputs, in turns); K7 beside its
    bound, its plain version and the SDPA backward with a float mask that
    requires a gradient (dq, dk, dv and the mask's gradient in one call)."""
    b = TRAIN_BATCH
    shape = (b, HEADS, N_TOKENS, HEAD_DIM)
    q = rand(shape, torch.bfloat16, 0.125)
    k, v, do = (rand(shape, torch.bfloat16) for _ in range(3))
    bias = _bias(rand, 1, N_TOKENS, True)
    reps = 200
    o, lse = attn.flash_attention_fwd(q, k, v, bias, 1.0, return_lse=True)
    _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, 1.0, bias)
    pair = {}
    for with_bias in (False, True, True, False):
        bb = bias if with_bias else None
        for key, fn in (("fwd", lambda: attn.flash_attention_fwd(q, k, v, bb, 1.0)),
                        ("dq", lambda: attn.flash_attention_bwd_dq(q, k, v, do, lse, o, 1.0, bb)),
                        ("dkv", lambda: attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                     1.0, bb))):
            pair.setdefault((key, with_bias), []).append(_device_ms(fn, reps))
    for (key, with_bias), times in sorted(pair.items()):
        result.setdefault(f"{key}_bias_ms" if with_bias else f"{key}_ms", min(times))
    row = bias_grad_times(attn, q, k, v, do, o, lse, delta, bias, 1.0, reps)
    row["bound_ms"], row["bound_by"] = bias_bound(b, HEADS, N_TOKENS, HEAD_DIM, 1, 2)
    row["bound_from_o_ms"], _ = bias_bound(b, HEADS, N_TOKENS, HEAD_DIM, 1, 2, from_o=True)
    result["k7"] = row
    _print_timing("attn_bias_grad", b, shape, row)
    print(f"bias timing B={b}: K1 {result['fwd_ms']:.6f} / with the bias "
          f"{result['fwd_bias_ms']:.6f} ms; K2 {result['dq_ms']:.6f} / {result['dq_bias_ms']:.6f}"
          f" ms; K3 {result['dkv_ms']:.6f} / {result['dkv_bias_ms']:.6f} ms (the less of two "
          "turns each)", flush=True)


def bias_kernel_phase(timing: bool = True) -> dict:
    """The kernels of RPB's path: ``bias_kernel_checks`` and, with
    ``timing``, ``bias_kernel_timing``."""
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    result = {"max_abs_err": bias_kernel_checks(attn, rand)}
    if timing:
        bias_kernel_timing(attn, rand, result)
    return result


# Swin-T's window attention on K1, K2, K3 and K7 at head dim 32 (swin_tiny.yaml
# at 224 px, window 7: N = 49).  A block runs batch B with nW h heads (the
# uniform fold of models/swin.py): (resolution, heads) of the four stages give
# nW = 64, 16, 4, 1 windows and 192, 96, 48, 24 folded heads.  The shifted
# blocks of stages 0-2 add the shift mask (-1e9) to the gathered table.
SWIN_HEAD_DIM = 32
SWIN_WINDOW = 7
SWIN_STAGES = ((56, 3), (28, 6), (14, 12), (7, 24))
SWIN_CHECK_BATCH = 16
SWIN_TIMED_BATCH = 64  # swin_tiny.yaml's TRAIN.BATCH_SIZE_PER_GPU
SWIN_TIMED_STAGES = (0, 2)  # K1, K2 and K3
SWIN_K7_TIMED_STAGES = (0, 1, 2, 3)
# (B, C, resolution, window, heads): a per-cell bias (a round of 3 rpb cells at
# stage 2's fold) and an odd N (window 5: N = 25, four windows of two heads)
SWIN_EDGES = ((3 * 4, 3, 14, 7, 12), (3, 1, 10, 5, 2))


def swin_bias(rand, c: int, res: int, ws: int, heads: int, shifted: bool, dtype) -> torch.Tensor:
    """A Swin block's folded bias as the model hands it to the kernels: a
    random ((2 ws - 1)^2, heads) table gathered into (heads, N, N), tiled over
    the nW windows, plus the shift mask when ``shifted``; rounded to the
    compute dtype ``dtype`` and given in fp32, (C, nW heads, N, N) (C = 1:
    (nW heads, N, N))."""
    from peft_vit_tpu_torch.models.layers import _rpb_index
    from peft_vit_tpu_torch.models.swin import _shift_attn_mask

    n, nw = ws * ws, (res // ws) ** 2
    index = torch.as_tensor(_rpb_index(ws).reshape(-1), device="cuda")
    table = rand((c, (2 * ws - 1) ** 2, heads), torch.float32, 0.5)
    gathered = table[:, index].reshape(c, n, n, heads).permute(0, 3, 1, 2)  # (C, h, N, N)
    bias = gathered[:, None].expand(c, nw, heads, n, n)
    if shifted:
        mask = torch.as_tensor(_shift_attn_mask(res, res, ws, ws // 2), device="cuda")
        bias = bias + mask[None, :, None]
    bias = bias.reshape(c, nw * heads, n, n).to(dtype).float().contiguous()
    return bias[0] if c == 1 else bias


def swin_kernel_checks(attn, rand) -> dict:
    """K1, K2 (delta too), K3 and K7 at head dim 32 against their plain
    versions (``bias_case_checks``, the D = 64 bounds), bf16 and fp32, at
    Swin-T's four stage shapes (B = 16, the shift mask in stages 0-2), a
    per-cell bias (C = 3) and an odd N; in bf16 also at the four stage folds
    at the training batch (B = 64: K7's batch in four chunks); a D = 48 call
    refused.  Returns the max abs errors of the bf16 stage-0 case."""
    main = None
    for dtype in (torch.bfloat16, torch.float32):
        label = "bf16" if dtype == torch.bfloat16 else "fp32"
        batches = (SWIN_CHECK_BATCH, SWIN_TIMED_BATCH) if dtype == torch.bfloat16 else (
            SWIN_CHECK_BATCH,)
        cases = [(f"stage {i} B={b}", b, 1, res, SWIN_WINDOW, heads)
                 for b in batches for i, (res, heads) in enumerate(SWIN_STAGES)]
        cases += [(f"edge C={c} N={ws * ws}", b, c, res, ws, heads)
                  for b, c, res, ws, heads in SWIN_EDGES]
        for name, b, c, res, ws, heads in cases:
            ws = min(ws, res)
            shifted = ws < res
            bias = swin_bias(rand, c, res, ws, heads, shifted, dtype)
            shape = (b, (res // ws) ** 2 * heads, ws * ws, SWIN_HEAD_DIM)
            q, k, v, do = (rand(shape, dtype) for _ in range(4))
            errs = bias_case_checks(attn, f"D=32 {label} {name}{' shifted' if shifted else ''}",
                                    q, k, v, do, bias, SWIN_HEAD_DIM ** -0.5)
            if main is None:
                main = errs
    q = rand((2, 4, 49, 48), torch.bfloat16)
    try:
        attn.flash_attention_fwd(q, q, q)
        refused = False
    except ValueError:
        refused = True
    check(refused, "D=48: the kernel wrapper refuses a head dim it is not built at")
    return main


def swin_kernel_timing(attn, rand, result: dict) -> None:
    """At Swin-T's stage-0 and stage-2 folds, B = 64, bf16, the shifted
    block's bias: K1 against SDPA's forward with the float bias, K2 + K3
    against SDPA's backward, K7 against SDPA's backward with a bias that
    requires a gradient, each beside its bound and its plain version."""
    import torch.nn.functional as F

    b = SWIN_TIMED_BATCH
    for stage in SWIN_TIMED_STAGES:
        res, heads = SWIN_STAGES[stage]
        bias = swin_bias(rand, 1, res, SWIN_WINDOW, heads, True, torch.bfloat16)
        h = bias.shape[0]
        n, d = SWIN_WINDOW ** 2, SWIN_HEAD_DIM
        shape = (b, h, n, d)
        scale = d ** -0.5
        q, k, v, do = (rand(shape, torch.bfloat16) for _ in range(4))
        reps = 100
        o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
        bias_bf = bias.to(torch.bfloat16)
        rows = {}
        fwd = {"ms": _device_ms(lambda: attn.flash_attention_fwd(q, k, v, bias, scale), reps),
               "plain_ms": _device_ms(lambda: attn._flash_attention_plain(
                   q, k, v, bias, scale, False), 10),
               "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=bias_bf, scale=scale), reps)}
        fwd["bound_ms"], fwd["bound_by"] = attention_bound(b, h, n, d, 2, "fwd")
        rows["fwd"] = fwd
        for key, fn in (("dq", lambda: attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale,
                                                                    bias)),
                        ("dkv", lambda: attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                      scale, bias))):
            row = {"ms": _device_ms(fn, reps)}
            row["bound_ms"], row["bound_by"] = attention_bound(b, h, n, d, 2, key)
            rows[key] = row
        rows["dq"]["plain_ms"] = _device_ms(lambda: attn._bwd_dq_plain(
            q, k, v, do, lse, o, scale, bias), 10)
        rows["dkv"]["plain_ms"] = _device_ms(lambda: attn._bwd_dkv_plain(
            q, k, v, do, lse, delta, scale, bias), 10)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bias_bf, scale=scale)
        sdpa_bwd = (_device_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do), reps)
                    - _device_ms(sdpa, reps))
        for key in ("dq", "dkv"):
            rows[key]["library_ms"] = sdpa_bwd
            rows[key]["library_computes"] = "dq, dk and dv in one SDPA backward"
        for key, row in rows.items():
            _print_timing(f"D=32 swin stage {stage} {key}", b, shape, row)
        result[stage] = rows
    result["k7"] = {}
    for stage in SWIN_K7_TIMED_STAGES:
        res, heads = SWIN_STAGES[stage]
        ws = min(SWIN_WINDOW, res)
        bias = swin_bias(rand, 1, res, ws, heads, ws < res, torch.bfloat16)
        shape = (b, bias.shape[0], ws * ws, SWIN_HEAD_DIM)
        scale = SWIN_HEAD_DIM ** -0.5
        q, k, v, do = (rand(shape, torch.bfloat16) for _ in range(4))
        o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
        k7 = bias_grad_times(attn, q, k, v, do, o, lse, delta, bias, scale, 100)
        k7["bound_ms"], k7["bound_by"] = bias_bound(*shape, 1, 2)
        k7["bound_from_o_ms"], _ = bias_bound(*shape, 1, 2, from_o=True)
        result["k7"][stage] = k7
        _print_timing(f"D=32 swin stage {stage} k7", b, shape, k7)


def swin_kernel_phase(timing: bool = True) -> dict:
    """The kernels of Swin's path at head dim 32: ``swin_kernel_checks`` and,
    with ``timing``, ``swin_kernel_timing``."""
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 170)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    result = {"max_abs_err": swin_kernel_checks(attn, rand)}
    if timing:
        swin_kernel_timing(attn, rand, result)
    return result


LONG_TIMED_BATCH = TRAIN_BATCH
LONG_TIMED_NS = {"K1": (257, 577), "K4": (577, 1024), "K5": (577, 1024)}


def _sdpa_bwd_ms(q, k, v, do, reps: int) -> float:
    """The ``scaled_dot_product_attention`` backward at scale 1: autograd runs
    a backward on its forward's stream, so a graph can only capture the two
    together; the backward is their time less the forward's."""
    import torch.nn.functional as F

    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qg, kg, vg, scale=1.0)
    return (_device_ms(lambda: torch.autograd.grad(sdpa(), (qg, kg, vg), do), reps)
            - _device_ms(sdpa, reps))


def long_timing(attn, rand, kernel: str) -> dict:
    """K1 or K4 past the resident design (64-key tiles streamed; K4 in two
    passes), or K5 at long N, at B = 16, bf16, scale 1 with post-scaled q:
    device time beside the bound, the plain version and
    ``scaled_dot_product_attention`` (K5: its backward, and K2 (with delta) +
    K3 as ``flash_bwd_ms``).  Returns ``{N: row}``."""
    import torch.nn.functional as F

    rows = {}
    for n in LONG_TIMED_NS[kernel]:
        shape = (LONG_TIMED_BATCH, HEADS, n, HEAD_DIM)
        q = rand(shape, torch.bfloat16, 0.125)
        k, v = rand(shape, torch.bfloat16), rand(shape, torch.bfloat16)
        if kernel == "K5":
            do = rand(shape, torch.bfloat16)
            o, lse = attn.fused_short_attention_fwd(q, k, v, 1.0, return_lse=True)
            fo, flse = attn.flash_attention_fwd(q, k, v, None, 1.0, return_lse=True)
            row = {"ms": _device_ms(
                       lambda: attn.fused_short_attention_bwd(q, k, v, o, lse, do, 1.0), 100),
                   "plain_ms": _device_ms(
                       lambda: attn._fused_short_bwd_plain(q, k, v, o, lse, do, 1.0), 20),
                   "library_ms": _sdpa_bwd_ms(q, k, v, do, 100),
                   "flash_bwd_ms": _device_ms(
                       lambda: flash_backward(attn, q, k, v, fo, flse, do), 100)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                LONG_TIMED_BATCH, HEADS, n, HEAD_DIM, 2, "fused_bwd")
            rows[n] = row
            _print_timing(f"fused_short_attn_bwd N={n}", LONG_TIMED_BATCH, shape, row)
            continue
        if kernel == "K1":
            fn = lambda: attn.flash_attention_fwd(q, k, v, None, 1.0)
            plain = lambda: attn._flash_attention_plain(q, k, v, None, 1.0, False)
        else:
            fn = lambda: attn.fused_short_attention_fwd(q, k, v, 1.0)
            plain = lambda: attn._fused_short_fwd_plain(q, k, v, 1.0, False)
        row = {"ms": _device_ms(fn, 100), "plain_ms": _device_ms(plain, 20),
               "library_ms": _device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 100),
               "eager_ms": _eager_ms(fn, 100)}
        row["bound_ms"], row["bound_by"] = attention_bound(
            LONG_TIMED_BATCH, HEADS, n, HEAD_DIM, 2, "fwd")
        rows[n] = row
        _print_timing(f"{'flash_attn_fwd' if kernel == 'K1' else 'fused_short_attn_fwd'} N={n}",
                      LONG_TIMED_BATCH, shape, row)
    return rows


def _print_timing(name: str, b: int, shape, row: dict) -> None:
    print(f"kernel timing {name} B={b} {tuple(shape)} bf16: " + " ".join(
        f"{key}={val:.6f}" if isinstance(val, float) else f"{key}={val}"
        for key, val in row.items()), flush=True)


# K4/K5, the fused short-sequence pair: (B, N) of the checks.  N = 197 is
# ViT-B/16 at 224 px at every batch of the serving and training paths; N = 50
# ViT-B/32 (vitb32_CLIP.yaml); N = 577 ViT-B/16 at 384 px; N = 1024 the
# dispatcher's edge.
FUSED_SHAPES = ((1, 197), (8, 197), (16, 197), (32, 197), (8, 50), (4, 577), (2, 1024))
FUSED_TIMED_BATCHES = (8, 16, 32)
FUSED_KERNEL_LINE_BATCH = TRAIN_BATCH  # the batch of the kernels line


@contextlib.contextmanager
def plain_fused(attn):
    """Within, the fused pair runs its plain versions wherever the autograd
    Function calls it."""
    saved = attn.fused_short_attention_fwd, attn.fused_short_attention_bwd
    attn.fused_short_attention_fwd = attn._fused_short_fwd_plain
    attn.fused_short_attention_bwd = attn._fused_short_bwd_plain
    try:
        yield
    finally:
        attn.fused_short_attention_fwd, attn.fused_short_attention_bwd = saved


def _attention_wrappers(attn) -> tuple:
    return (attn.flash_attention_fwd, attn.flash_attention_bwd_dq,
            attn.flash_attention_bwd_dkv, attn.attention_bias_grad,
            attn.fused_short_attention_fwd, attn.fused_short_attention_bwd)


def _attention_counts(attn) -> dict:
    return {w.__name__: w.launches for w in _attention_wrappers(attn)}


def _zero_attention_counts(attn) -> None:
    for w in _attention_wrappers(attn):
        w.launches = 0


def fused_kernel_phase(timing: bool = True) -> dict:
    """K4 (``fused_short_attention_fwd``) and K5 (``fused_short_attention_bwd``)
    against their plain versions on the card at every shape of
    ``FUSED_SHAPES``, bf16 and fp32, at scale 1.0 with post-scaled q (the
    model's call) and at 0.125; the autograd path of
    ``multi_head_attention(use_fused=True)`` against the same call with the
    plain versions; the dispatch rule; the flagship's own q, k, v of block 0.
    Then the times."""
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    errs = {"fwd": 0.0, "bwd": 0.0}

    def hold(label, q, k, v, do, scale):
        """K4's o and lse and K5's dq, dk, dv against the plain versions."""
        bf16 = q.dtype == torch.bfloat16
        tol_o, tol_g = (TOL_BF16_OUT, TOL_BF16_GRAD_REL) if bf16 else (TOL_F32_OUT, TOL_F32_GRAD_REL)
        o, lse = attn.fused_short_attention_fwd(q, k, v, scale, return_lse=True)
        ref_o, ref_lse = attn._fused_short_fwd_plain(q, k, v, scale, True)
        grads = attn.fused_short_attention_bwd(q, k, v, o, lse, do, scale)
        want = attn._fused_short_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        err = (o.float() - ref_o.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        check(o.shape == q.shape and bool(torch.isfinite(o).all()) and err <= tol_o
              and lse.shape == ref_lse.shape and lse_err <= TOL_LSE,
              f"fused kernel fwd {label} {tuple(q.shape)}: o max abs err {err:.3e} <= {tol_o:g}, "
              f"lse {lse_err:.3e} <= {TOL_LSE:g}")
        worst = 0.0
        for what, got, ref in zip(("dq", "dk", "dv"), grads, want):
            e = (got.float() - ref.float()).abs().max().item()
            rel = e / ref.float().abs().max().item()
            worst = max(worst, e)
            check(got.shape == q.shape and got.dtype == q.dtype
                  and bool(torch.isfinite(got).all()) and rel <= tol_g,
                  f"fused kernel bwd {label} {tuple(q.shape)}: {what} max abs err {e:.3e}, "
                  f"/ max |plain| = {rel:.3e} <= {tol_g:g}")
        return err, worst

    for b, n in FUSED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for scale, q_std in ((1.0, 0.125), (0.125, 1.0)):
                shape = (b, HEADS, n, HEAD_DIM)
                q = rand(shape, dtype, q_std)
                k, v, do = (rand(shape, dtype) for _ in range(3))
                tag = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} scale={scale}"
                e_o, e_g = hold(tag, q, k, v, do, scale)
                if (b, n, dtype, scale) == (FUSED_KERNEL_LINE_BATCH, N_TOKENS, torch.bfloat16, 1.0):
                    errs = {"fwd": e_o, "bwd": e_g}

    edge_checks(attn, rand, "K4")
    fused_bwd_edge_checks(attn, rand)

    # the autograd path through the dispatcher, against the same call with the
    # plain versions in the kernels' place
    for dtype, tol in ((torch.bfloat16, TOL_BF16_GRAD_REL), (torch.float32, TOL_F32_GRAD_REL)):
        shape = (4, HEADS, N_TOKENS, HEAD_DIM)
        base = [rand(shape, dtype, std) for std in (0.125, 1.0, 1.0)]
        w = rand(shape, dtype)

        def run():
            q, k, v = (t.clone().requires_grad_() for t in base)
            out = attn.multi_head_attention(q, k, v, scale=1.0, use_fused=True)
            return (out, *torch.autograd.grad(out, (q, k, v), w))

        _zero_attention_counts(attn)
        got = run()
        counts = _attention_counts(attn)
        with plain_fused(attn):
            want = run()
        torch.cuda.synchronize()
        check(counts == {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                         "flash_attention_bwd_dkv": 0, "attention_bias_grad": 0,
                         "fused_short_attention_fwd": 1, "fused_short_attention_bwd": 1},
              f"fused dispatch {dtype}: use_fused=True forward and backward launch K4 and K5 "
              f"once each and no flash kernel: {counts}")
        for what, g_, r_ in zip(("o", "dq", "dk", "dv"), got, want):
            rel = ((g_.float() - r_.float()).abs().max() / r_.float().abs().max()).item()
            check(rel <= tol, f"fused autograd {dtype} {tuple(shape)}: {what} of "
                  f"multi_head_attention(use_fused=True) vs the plain versions: max |diff| / "
                  f"max |plain| = {rel:.3e} <= {tol:g}")

    # the rule: a bias or N > 1024 takes the flash kernels; use_fused=None is off
    for label, n, with_bias, use_fused, want_fused in (
            ("bias", N_TOKENS, True, True, False), ("N=1025", 1025, False, True, False),
            ("use_fused=None", N_TOKENS, False, None, False),
            ("N=1024", 1024, False, True, True)):
        shape = (1, HEADS, n, HEAD_DIM)
        q, k, v = (rand(shape, torch.bfloat16).requires_grad_(not with_bias) for _ in range(3))
        bias = rand((HEADS, n, n), torch.float32) if with_bias else None
        _zero_attention_counts(attn)
        out = attn.multi_head_attention(q, k, v, bias, scale=0.125, use_fused=use_fused)
        if not with_bias:
            out.float().sum().backward()
        torch.cuda.synchronize()
        counts = _attention_counts(attn)
        fused = counts["fused_short_attention_fwd"] + counts["fused_short_attention_bwd"]
        flash = counts["flash_attention_fwd"]
        ok = (fused == 2 and flash == 0) if want_fused else (fused == 0 and flash == 1)
        check(ok, f"fused dispatch {label}: {'K4/K5' if want_fused else 'K1'} "
              f"as the JAX rule says: {counts}")

    flagship_qkv_check(attn)

    # the fused pair's own path, read for the kernels line: the dispatcher
    # forward and backward at the training shape, once per layer of the
    # flagship, counts from 0 just before and read just after
    shape = (FUSED_KERNEL_LINE_BATCH, HEADS, N_TOKENS, HEAD_DIM)
    base = [rand(shape, torch.bfloat16, std) for std in (0.125, 1.0, 1.0)]
    w = rand(shape, torch.bfloat16)
    _zero_attention_counts(attn)
    for _ in range(LAYERS):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = attn.multi_head_attention(q, k, v, scale=1.0, use_fused=True)
        grads = torch.autograd.grad(out, (q, k, v), w)
    torch.cuda.synchronize()
    counts = _attention_counts(attn)
    launches = {"fwd": counts["fused_short_attention_fwd"],
                "bwd": counts["fused_short_attention_bwd"]}
    check(launches == {"fwd": LAYERS, "bwd": LAYERS} and counts["flash_attention_fwd"] == 0
          and all(bool(torch.isfinite(g).all()) for g in (out, *grads)),
          f"fused path: {LAYERS} forward and backward calls of multi_head_attention("
          f"use_fused=True) {tuple(shape)} launch K4 {launches['fwd']} and K5 "
          f"{launches['bwd']} times, no flash kernel, finite results")
    result = {"max_abs_err": errs, "fwd": {}, "bwd": {}, "launches": launches}
    if timing:
        fused_kernel_timing(attn, rand, result)
    return result


# K5 at the edges: the scales of fused_bwd_edge_checks as (scale, q std).
# 0.3 is no power of two, so ds = scale p (dp - delta) rounds to bf16 other
# than p (dp - delta) scaled after the products would.
FUSED_BWD_EDGE_SCALES = ((1.0, 0.125), (0.125, 1.0), (0.3, 1.0))


def fused_bwd_edge_checks(attn, rand) -> None:
    """K5 (``fused_short_attention_bwd``) against ``_fused_short_bwd_plain``
    at every N of ``EDGE_NS`` and 1024 (one to sixteen 64-row chunks, ragged
    last chunks of 8 to 64 rows), B = 1 and 32, bf16 and fp32, at each scale
    of ``FUSED_BWD_EDGE_SCALES``; o and lse from K4."""
    for n in EDGE_NS + (1024,):
        for b in EDGE_BATCHES:
            for dtype in (torch.bfloat16, torch.float32):
                tol = TOL_BF16_GRAD_REL if dtype == torch.bfloat16 else TOL_F32_GRAD_REL
                for scale, q_std in FUSED_BWD_EDGE_SCALES:
                    shape = (b, HEADS, n, HEAD_DIM)
                    q = rand(shape, dtype, q_std)
                    k, v, do = (rand(shape, dtype) for _ in range(3))
                    o, lse = attn.fused_short_attention_fwd(q, k, v, scale, return_lse=True)
                    got = attn.fused_short_attention_bwd(q, k, v, o, lse, do, scale)
                    want = attn._fused_short_bwd_plain(q, k, v, o, lse, do, scale)
                    torch.cuda.synchronize()
                    rels = []
                    for g_, r_ in zip(got, want):
                        rels.append(((g_.float() - r_.float()).abs().max()
                                     / r_.float().abs().max()).item())
                    ok = all(g_.shape == shape and g_.dtype == dtype
                             and bool(torch.isfinite(g_).all()) for g_ in got)
                    tag = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} scale={scale}"
                    check(ok and max(rels) <= tol,
                          f"edge K5 {tag} {shape}: dq, dk, dv max |diff| / max |plain| = "
                          + ", ".join(f"{r:.3e}" for r in rels) + f" <= {tol:g}")


def flagship_qkv_check(attn) -> None:
    """K4/K5 on the q, k, v that block 0 of the bf16 ViT-B/16 LoRA flagship
    hands its attention (captured from the model's call), held against the
    plain versions."""
    from peft_vit_tpu_torch.models import flagship, layers, load_jax_variables

    model = load_jax_variables(
        flagship(WIDTH, LAYERS, HEADS, IMAGE, PATCH, NUM_CLASSES, use_bn=True),
        jax_layout_tree(np.random.RandomState(SEED + 5))).eval()
    captured = []
    original = layers.multi_head_attention

    def spy(q, k, v, *args, **kwargs):
        if not captured:
            captured.append((q.detach().clone(), k.detach().clone(), v.detach().clone(),
                             kwargs.get("scale")))
        return original(q, k, v, *args, **kwargs)

    x = torch.as_tensor(np.random.RandomState(SEED + 6).standard_normal(
        (FUSED_KERNEL_LINE_BATCH, IMAGE, IMAGE, 3)).astype(np.float32), device="cuda")
    layers.multi_head_attention = spy
    try:
        with torch.no_grad():
            model(x)
    finally:
        layers.multi_head_attention = original
    q, k, v, scale = captured[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    o, lse = attn.fused_short_attention_fwd(q, k, v, scale, return_lse=True)
    ref_o, ref_lse = attn._fused_short_fwd_plain(q, k, v, scale, True)
    grads = attn.fused_short_attention_bwd(q, k, v, o, lse, do, scale)
    want = attn._fused_short_bwd_plain(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    err = (o.float() - ref_o.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    check(err <= TOL_BF16_OUT and lse_err <= TOL_LSE,
          f"fused kernel on the flagship's block-0 q, k, v {tuple(q.shape)} {q.dtype} scale={scale}:"
          f" o max abs err {err:.3e} <= {TOL_BF16_OUT:g}, lse {lse_err:.3e} <= {TOL_LSE:g}")
    for what, got, ref in zip(("dq", "dk", "dv"), grads, want):
        rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        check(rel <= TOL_BF16_GRAD_REL and bool(torch.isfinite(got).all()),
              f"fused kernel bwd on the flagship's block-0 q, k, v: {what} max |diff| / "
              f"max |plain| = {rel:.3e} <= {TOL_BF16_GRAD_REL:g}")
    del model


def fused_kernel_timing(attn, rand, result: dict) -> None:
    """Device time of K4 and K5 (CUDA-graph replay, L2-warm, bf16, scale 1, q
    at std 1/8) at N = 197 beside the bound, the plain versions, K1 (the
    flash forward), K2 (with delta) + K3, and ``scaled_dot_product_attention``
    forward and backward (yardsticks only)."""
    import torch.nn.functional as F

    for b in FUSED_TIMED_BATCHES:
        shape = (b, HEADS, N_TOKENS, HEAD_DIM)
        q = rand(shape, torch.bfloat16, 0.125)
        k, v, do = (rand(shape, torch.bfloat16) for _ in range(3))
        reps = 200
        o, lse = attn.fused_short_attention_fwd(q, k, v, 1.0, return_lse=True)
        row = {
            "ms": _device_ms(lambda: attn.fused_short_attention_fwd(q, k, v, 1.0), reps),
            "plain_ms": _device_ms(lambda: attn._fused_short_fwd_plain(q, k, v, 1.0, False), 50),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
                                     reps),
            "flash_fwd_ms": _device_ms(lambda: attn.flash_attention_fwd(q, k, v, None, 1.0), reps),
            "eager_ms": _eager_ms(lambda: attn.fused_short_attention_fwd(q, k, v, 1.0), reps),
        }
        row["bound_ms"], row["bound_by"] = attention_bound(b, HEADS, N_TOKENS, HEAD_DIM, 2, "fwd")
        result["fwd"][b] = row
        _print_timing("fused_short_attn_fwd", b, shape, row)

        sdpa_bwd = _sdpa_bwd_ms(q, k, v, do, reps)
        fo, flse = attn.flash_attention_fwd(q, k, v, None, 1.0, return_lse=True)

        flash_bwd = _device_ms(lambda: flash_backward(attn, q, k, v, fo, flse, do), reps)
        row = {
            "ms": _device_ms(lambda: attn.fused_short_attention_bwd(q, k, v, o, lse, do, 1.0),
                             reps),
            "plain_ms": _device_ms(
                lambda: attn._fused_short_bwd_plain(q, k, v, o, lse, do, 1.0), 50),
            "library_ms": sdpa_bwd,
            "flash_bwd_ms": flash_bwd,
        }
        row["bound_ms"], row["bound_by"] = attention_bound(b, HEADS, N_TOKENS, HEAD_DIM, 2,
                                                           "fused_bwd")
        result["bwd"][b] = row
        _print_timing("fused_short_attn_bwd", b, shape, row)
        print(f"fused timing B={b}: K5 {row['ms']:.6f} ms beside K2 (with delta) + K3 "
              f"{flash_bwd:.6f} ms and the scaled_dot_product_attention backward "
              f"{sdpa_bwd:.6f} ms (forward and backward in one graph, less the forward)",
              flush=True)
    result["fwd_long"] = long_timing(attn, rand, "K4")
    result["bwd_long"] = long_timing(attn, rand, "K5")


def int8_bound(m: int, k: int, n: int, itemsize: int):
    """Least time for the function: x (M, K) read once, w_i8 (N, K) and s_w
    read once, out (M, N) written once, against 2 M K N operations at the
    dense int8 tensor-core peak."""
    bytes_moved = m * k * itemsize + n * k + 4 * n + m * n * itemsize
    ops = 2 * m * k * n
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int8_kernel_phase(timing: bool = True) -> dict:
    """``int8_gemm_dynamic`` and ``int8_gemm_static`` (the CUDA counterpart of
    the Pallas ``_prequant_kernel``) against their plain versions on the card,
    held to equality: bf16 at M = 197 x {1, 8, 16, 32} for the four GEMMs of a
    block and their transposes (the dx products), fp32 at the batches of the
    fp32 runs, and the corner cases.  Then the times."""
    from peft_vit_tpu_torch.ops import int8 as i8

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def rand(shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    def weight(k, n):
        return i8.quantize_cols(rand((n, k), std=k**-0.5))

    def hold(name, got, want):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err, bad = diff.max().item(), int((diff > 0).sum())
        check(got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all()) and err <= TOL_INT8_KERNEL,
              f"int8 kernel {name} {tuple(got.shape)}: max abs err {err:.3e} "
              f"({bad} of {got.numel()} differ) == plain")
        return err

    shapes = [(name, k, n) for name, k, n in INT8_GEMMS]
    shapes += [(name + "^T (dx)", n, k) for name, k, n in INT8_GEMMS]
    weights = {(k, n): weight(k, n) for _, k, n in shapes}
    errs = {"dynamic": 0.0, "static": 0.0}
    for dtype, batches in ((torch.bfloat16, INT8_BATCHES), (torch.float32, INT8_F32_BATCHES)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for b in batches:
            m = b * N_TOKENS
            for name, k, n in shapes:
                w_i8, s_w = weights[(k, n)]
                x = rand((m, k), dtype)
                err = hold(f"dynamic {tag} B={b} {name} K={k} N={n}",
                           i8.int8_gemm_dynamic(x, w_i8, s_w), i8._prequant_forward(x, w_i8, s_w))
                errs["dynamic"] = max(errs["dynamic"], err)
                if "dx" in name:
                    continue  # a cotangent always takes the dynamic quantize
                s_x = x.float().abs().max() * 1.5 / 127.0
                err = hold(f"static {tag} B={b} {name} K={k} N={n}",
                           i8.int8_gemm_static(x, w_i8, s_w, s_x),
                           i8._static_forward(x, w_i8, s_w, s_x))
                errs["static"] = max(errs["static"], err)

    # corner cases, on c_fc's weight
    k, n = INT8_GEMMS[2][1:]
    w_i8, s_w = weights[(k, n)]
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        x = rand((1, k), dtype)
        hold(f"dynamic {tag} M=1", i8.int8_gemm_dynamic(x, w_i8, s_w),
             i8._prequant_forward(x, w_i8, s_w))
        x = rand((2, 70, k), dtype)
        x[0, 3] = 0.0  # an all-zero row: scale 1e-8, codes 0
        x[1, 5] *= 1000.0  # an outlier row keeps its own scale
        # rows whose values sit exactly on .5 steps of their scale (absmax 127
        # gives scale 1): round half to even
        x[1, 7] = (torch.arange(k, device="cuda") % 255 - 127).to(dtype) / 2
        x[1, 7, 0] = 127.0
        out = i8.int8_gemm_dynamic(x, w_i8, s_w)
        hold(f"dynamic {tag} 3-D input, zero row, outlier row, .5 steps", out,
             i8._prequant_forward(x, w_i8, s_w))
        check(bool((out[0, 3] == 0).all()), f"int8 kernel dynamic {tag}: the zero row gives zeros")
        x = rand((300, k), dtype)
        s_x = x.float().abs().max() / 127.0 / 8.0  # most of the data saturates at +-127
        sat = (i8.quantize_static(x, s_x).abs() == 127).float().mean().item()
        hold(f"static {tag} saturating ({sat:.2f} of the codes at +-127)",
             i8.int8_gemm_static(x, w_i8, s_w, s_x), i8._static_forward(x, w_i8, s_w, s_x))
        g = rand((k, 300), dtype).t()  # a cotangent with the strides its producer left
        check(not g.is_contiguous(), "int8 kernel: the test cotangent is not contiguous")
        hold(f"dynamic {tag} non-contiguous input", i8.int8_gemm_dynamic(g, w_i8, s_w),
             i8._prequant_forward(g, w_i8, s_w))
    int8_edge_checks(i8, rand, errs)
    for bad_k, bad_n in ((k + 32, n), (k, n + 8), (4096, n)):
        try:
            i8.int8_gemm_dynamic(rand((4, bad_k), torch.bfloat16),
                                 torch.zeros((bad_n, bad_k), dtype=torch.int8, device="cuda"),
                                 torch.ones(bad_n, device="cuda"))
            raised = False
        except ValueError:
            raised = True
        check(raised, f"int8 kernel: K={bad_k} N={bad_n} raises, no fallback")

    result = {"max_abs_err": errs, "rows": []}
    if timing:
        int8_kernel_timing(i8, rand, weights, shapes, result)
    return result


# The edges of K6's layout: K with a half-filled last 128-byte code slab (64,
# 192, 704, 3008) and the largest code tile (3072); N with a half-empty
# 128-column tile, the second warpgroup's columns beyond N (64, 192); M about
# one 64-row tile and one image.
INT8_EDGE_KS = (64, 192, 704, 3008, 3072)
INT8_EDGE_NS = (64, 192)
INT8_EDGE_MS = (1, 63, 64, 65, 197)


def int8_edge_checks(i8, rand, errs: dict) -> None:
    """Both variants, bf16 and fp32, at every (K, N, M) of the edge lists,
    held to equality: one check per dtype, variant and K over its N x M
    cases, naming the cases that differ."""
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for k in INT8_EDGE_KS:
            cases = {"dynamic": [], "static": []}
            for n in INT8_EDGE_NS:
                w_i8, s_w = i8.quantize_cols(rand((n, k), std=k**-0.5))
                for m in INT8_EDGE_MS:
                    x = rand((m, k), dtype)
                    s_x = x.float().abs().max() * 1.5 / 127.0
                    for variant, got, want in (
                            ("dynamic", i8.int8_gemm_dynamic(x, w_i8, s_w),
                             i8._prequant_forward(x, w_i8, s_w)),
                            ("static", i8.int8_gemm_static(x, w_i8, s_w, s_x),
                             i8._static_forward(x, w_i8, s_w, s_x))):
                        err = (got.float() - want.float()).abs().max().item()
                        ok = (got.shape == want.shape and got.dtype == want.dtype
                              and bool(torch.isfinite(got).all()) and err <= TOL_INT8_KERNEL)
                        cases[variant].append((n, m, ok, err))
            torch.cuda.synchronize()
            for variant, found in cases.items():
                worst = max(err for _, _, _, err in found)
                errs[variant] = max(errs[variant], worst)
                bad = [f"N={n} M={m} ({err:.3e})" for n, m, ok, err in found if not ok]
                check(not bad, f"int8 kernel {variant} {tag} edges K={k}: {len(found)} cases "
                               f"(N in {INT8_EDGE_NS}, M in {INT8_EDGE_MS}), max abs err "
                               f"{worst:.3e} == plain" + (f"; differ: {', '.join(bad)}" if bad
                                                          else ""))


def int8_kernel_timing(i8, rand, weights, shapes, result: dict) -> None:
    """Device time (CUDA-graph replay, bf16) of the kernel per path shape
    beside its bound, its plain version, the library route for the same
    function (``quantize_rows`` + ``torch._int_mm`` + rescale in PyTorch: four
    or more launches, with ``torch._int_mm`` alone beside it) and the dense
    bf16 ``F.linear`` of the same shape, which int8 has to beat to be worth
    having.  None of the yardsticks is called by the port."""
    import torch.nn.functional as F

    def library(x, w_t, s_w):
        x_i8, s_x = i8.quantize_rows(x)
        return (torch._int_mm(x_i8, w_t).to(torch.float32) * s_x * s_w).to(x.dtype)

    for b in INT8_BATCHES:
        m = b * N_TOKENS
        for name, k, n in shapes:
            w_i8, s_w = weights[(k, n)]
            w_t = w_i8.t()  # (K, N) column-major: the operand torch._int_mm takes
            w_bf16 = rand((n, k), torch.bfloat16, k**-0.5)
            x = rand((m, k), torch.bfloat16)
            s_x = x.float().abs().max() * 1.5 / 127.0
            reps = 100 if b <= 8 else 40
            row = {"gemm": name, "batch": b, "M": m, "K": k, "N": n,
                   "ms": _device_ms(lambda: i8.int8_gemm_dynamic(x, w_i8, s_w), reps),
                   "static_ms": None if "dx" in name else _device_ms(
                       lambda: i8.int8_gemm_static(x, w_i8, s_w, s_x), reps),
                   "plain_ms": _device_ms(lambda: i8._prequant_forward(x, w_i8, s_w), 5, 3),
                   "static_plain_ms": None if "dx" in name else _device_ms(
                       lambda: i8._static_forward(x, w_i8, s_w, s_x), 5, 3),
                   "linear_bf16_ms": _device_ms(lambda: F.linear(x, w_bf16), reps)}
            x_i8, _ = i8.quantize_rows(x)
            try:  # torch._int_mm wants M > 16; a yardstick only
                row["library_ms"] = _device_ms(lambda: library(x, w_t, s_w), reps)
                row["int_mm_ms"] = _device_ms(lambda: torch._int_mm(x_i8, w_t), reps)
            except RuntimeError as e:
                row["library_ms"] = row["int_mm_ms"] = None
                print(f"int8 timing: torch._int_mm does not take M={m} K={k} N={n}: "
                      f"{str(e).splitlines()[0]}")
            row["bound_ms"], row["bound_by"] = int8_bound(m, k, n, 2)
            result["rows"].append(row)
            print("int8 timing " + " ".join(
                f"{key}={val:.6f}" if isinstance(val, float) else f"{key}={val}"
                for key, val in row.items()), flush=True)


def jax_layout_tree(rng: np.random.RandomState, num_classes: int = NUM_CLASSES) -> dict:
    """Random flagship weights in the JAX package's variable layout (the
    names a flax init produces; Dense kernels (in, out), conv HWIO), with a
    head of ``num_classes``."""

    def normal(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o, std=i**-0.5), "bias": normal(o, std=0.02)}

    def layer_norm():
        return {"scale": 1.0 + normal(WIDTH, std=0.1), "bias": normal(WIDTH, std=0.02)}

    g = IMAGE // PATCH
    backbone = {
        "conv1": {"kernel": normal(PATCH, PATCH, 3, WIDTH, std=(PATCH * PATCH * 3) ** -0.5)},
        "class_embedding": normal(WIDTH, std=WIDTH**-0.5),
        "positional_embedding": normal(g * g + 1, WIDTH, std=0.1),
        "ln_pre": layer_norm(),
        "ln_post": layer_norm(),
        "proj": normal(WIDTH, OUTPUT_DIM, std=WIDTH**-0.5),
    }
    for i in range(LAYERS):
        attn = {"in_proj": dense(WIDTH, 3 * WIDTH), "out_proj": dense(WIDTH, WIDTH)}
        for t in ("q", "v"):
            attn[f"{t}_adapter1"] = {"kernel": normal(WIDTH, LORA_RANK, std=0.02)}
            attn[f"{t}_adapter2"] = {"kernel": normal(LORA_RANK, WIDTH, std=0.02)}
        backbone[f"blocks_{i}"] = {
            "ln_1": layer_norm(),
            "attn": attn,
            "ln_2": layer_norm(),
            "mlp": {"c_fc": dense(WIDTH, 4 * WIDTH), "c_proj": dense(4 * WIDTH, WIDTH)},
        }
    return {
        "params": {"backbone": backbone, "classifier": {"head": dense(OUTPUT_DIM, num_classes)}},
        "batch_stats": {"classifier": {"channel_bn": {
            "bn_mean": normal(OUTPUT_DIM, std=0.1),
            "bn_var": rng.uniform(0.5, 1.5, OUTPUT_DIM).astype(np.float32),
        }}},
    }


def prototype_head(tree: dict, feats: np.ndarray) -> None:
    """Make class c (c < len(feats)) the nearest-prototype class of image c:
    its head row is image c's BN-standardised feature, centred over the
    images and scaled so that the CPU fp32 logit of image c for class c is
    10, and its bias removes the shared centre.  Random weights give no
    decisive class; this makes top-1 a test of each image's identity."""
    stats = tree["batch_stats"]["classifier"]["channel_bn"]
    z = (feats - stats["bn_mean"]) / np.sqrt(stats["bn_var"] + 1e-5)
    centre = z.mean(axis=0)
    d = z - centre
    rows = 10.0 * d / (d * d).sum(axis=1, keepdims=True)
    head = tree["params"]["classifier"]["head"]
    head["kernel"][:, : len(feats)] = rows.T
    head["bias"][: len(feats)] = -(rows @ centre)
    spread = float(np.linalg.norm(d, axis=1).mean() / np.linalg.norm(z, axis=1).mean())
    print(f"slice: prototype head over {len(feats)} images, feature spread {spread:.4f} "
          "(mean |z - centre| / mean |z|)")


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def slice_phase(smi: str) -> dict:
    import bench_torch
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.models import flagship, load_jax_variables, params_from_jax
    from peft_vit_tpu_torch.ops import attention as attn

    rng = np.random.RandomState(SEED)
    tree = jax_layout_tree(rng)
    requests = {n: rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32) for n in REQUESTS}
    checked = requests[CHECKED_REQUEST]

    t0 = time.perf_counter()
    shape = dict(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                 num_classes=NUM_CLASSES, use_bn=True)
    cpu_model = flagship(**shape, dtype=torch.float32, device="cpu").eval()
    load_jax_variables(cpu_model, tree)
    with torch.no_grad():
        feats = cpu_model.backbone(torch.from_numpy(checked)).numpy()
    prototype_head(tree, feats)
    load_jax_variables(cpu_model, tree)
    with torch.no_grad():
        cpu_logits = cpu_model(torch.from_numpy(checked)).numpy()
    print(f"slice: CPU fp32 reference of {CHECKED_REQUEST} images in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cpu_bf16 = load_jax_variables(
        flagship(**shape, dtype=torch.bfloat16, device="cpu"), tree).eval()
    with torch.no_grad():
        cpu_bf16_logits = cpu_bf16(torch.from_numpy(checked)).float().numpy()
    del cpu_bf16
    drift_cpu_bf16 = _rel(cpu_bf16_logits, cpu_logits)
    print(f"slice: bf16 on the CPU (no kernel) vs fp32 CPU: max |logit diff| / max |logit| = "
          f"{drift_cpu_bf16:.4e} ({time.perf_counter() - t0:.1f} s)")

    # the main path, the session's load (each bucket warmed up and captured)
    # and its requests: counts from 0 just before, read just after
    attn.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    session = ServingSession(flagship(**shape), params_from_jax(tree), IMAGE,
                             buckets=BUCKETS)
    print(f"slice: ServingSession ready in {time.perf_counter() - t0:.1f} s "
          f"(buckets {BUCKETS}, warm-up and capture included)")
    logits = {n: session.predict(x) for n, x in requests.items()}
    launches = attn.flash_attention_fwd.launches
    batches = sum(math.ceil(n / BUCKETS[-1]) for n in REQUESTS)

    for n, out in logits.items():
        check(out.shape == (n, NUM_CLASSES) and out.dtype == np.float32
              and bool(np.isfinite(out).all()),
              f"slice: request of {n} -> finite float32 logits {out.shape}")
    _serving_graphs(session, {"flash_attention_fwd": LAYERS}, launches, batches, "slice")
    with bench_torch.eager_on_card():
        eager = ServingSession(flagship(**shape), params_from_jax(tree), IMAGE, buckets=BUCKETS)
    same = [n for n, x in requests.items() if np.array_equal(eager.predict(x), logits[n])]
    check(len(same) == len(requests),
          f"slice: captured buckets == eager buckets bit for bit on {len(same)} of "
          f"{len(requests)} requests")
    del eager
    got = logits[CHECKED_REQUEST]
    rel = _rel(got, cpu_logits)
    top_gpu, top_cpu = got.argmax(axis=1), cpu_logits.argmax(axis=1)
    check(bool((top_gpu == top_cpu).all()),
          f"slice: top-1 bf16 card {top_gpu.tolist()} == fp32 CPU {top_cpu.tolist()}")
    check(rel <= TOL_BF16_LOGITS_REL,
          f"slice: bf16 card vs fp32 CPU: max |logit diff| / max |logit| = {rel:.4e} "
          f"<= {TOL_BF16_LOGITS_REL:g} (bf16 CPU: {drift_cpu_bf16:.4e})")

    # the port's arithmetic on the card with no bf16 rounding: fp32 throughout,
    # through the kernel's fp32 instantiation
    infer32 = make_infer_fn(flagship(**shape, dtype=torch.float32), params_from_jax(tree))
    card32 = infer32(torch.from_numpy(checked).cuda()).cpu().numpy()
    rel32 = _rel(card32, cpu_logits)
    check(rel32 <= TOL_F32_LOGITS_REL and bool((card32.argmax(1) == top_cpu).all()),
          f"slice: fp32 card vs fp32 CPU: max |logit diff| / max |logit| = {rel32:.4e} "
          f"<= {TOL_F32_LOGITS_REL:g}, top-1 equal")
    del infer32

    latency = _serving_latency(session, "bf16", rng, smi)
    int8 = int8_slice_phase(shape, tree, requests, got, batches, rng, smi)
    return {"launches": launches, "batches": batches, "latency_ms": latency, "int8": int8}


def _serving_graphs(session, per_replay: dict, counted: int, batches: int, label: str,
                    blocks: int = LAYERS) -> None:
    """Each bucket of ``session`` a captured graph launching ``per_replay``
    a replay; the forward kernel's wrapper counted (warm-up + capture) x its
    launches a replay (``blocks``) for each bucket, and the requests' batches
    replayed."""
    from peft_vit_tpu_torch.engine import StepGraph

    graphs = session._graphs
    check(sorted(graphs) == sorted(BUCKETS), f"{label}: buckets {sorted(graphs)} captured")
    for b, graph in sorted(graphs.items()):
        _per_replay(graph, per_replay, f"{label}: bucket {b}")
    want = (StepGraph.WARMUP + 1) * blocks * len(graphs)
    replays = sum(g.replays for g in graphs.values())
    check(counted == want > 0 and replays == batches,
          f"{label}: flash_attn_fwd counted {counted} == ({StepGraph.WARMUP} warm-up runs + the "
          f"capture) x {blocks} blocks x {len(graphs)} buckets; {replays} replays == {batches} "
          "forward batches")


def _serving_latency(session, label: str, rng, smi: str, profiled=BUCKETS) -> dict:
    """Median request time per bucket on the host clock, and the device's
    share of it from the profiler (for the buckets in ``profiled``)."""
    latency = {}
    for b in BUCKETS:
        x = rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)
        session.predict(x)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            session.predict(x)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        latency[b] = ms
        print(f"slice latency {label} bucket {b}: {ms:.3f} ms/request, {b / ms * 1e3:.1f} images/s "
              f"(median of 10, host clock, NHWC fp32 in -> fp32 logits out; {smi})")
        if b not in profiled:
            continue
        device_ms, n_launches, top = _device_breakdown(lambda: session.predict(x), reps=3)
        if device_ms is None:
            print(f"slice profile {label} bucket {b}: device time not measured (the profiler "
                  "saw no CUDA kernel)")
            continue
        print(f"slice profile {label} bucket {b}: device busy {device_ms:.3f} ms/request in "
              f"{n_launches:.0f} launches, idle share "
              f"{max(0.0, 1.0 - device_ms / ms):.3f} of the {ms:.3f} ms request; top: "
              + "; ".join(f"{name} {t:.3f} ms" for name, t in top))
    return latency


def int8_slice_phase(shape, tree, requests, bf16_logits, batches, rng, smi: str) -> dict:
    """The flagship with ``int8=True`` (eval forwards run the frozen tower's
    four GEMMs per block through the int8 kernel, the tower quantized once at
    load) served by ``ServingSession`` on the same weights and requests as the
    bf16 session."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.models import flagship, load_jax_variables, params_from_jax
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8

    from peft_vit_tpu_torch.engine import StepGraph
    from peft_vit_tpu_torch.models import cast_frozen_

    quantized = {"load": 0, "requests": 0}
    real_quantize, phase = i8.quantize_cols, ["load"]

    def counted_quantize(w):
        quantized[phase[0]] += 1
        return real_quantize(w)

    wrappers = (attn.flash_attention_fwd, i8.int8_gemm_dynamic, i8.int8_gemm_static)
    for w in wrappers:  # counts from 0 just before the main path, read just after
        w.launches = 0
    i8.quantize_cols = counted_quantize
    try:
        t0 = time.perf_counter()
        session = ServingSession(flagship(**shape, int8=True), params_from_jax(tree), IMAGE,
                                 buckets=BUCKETS)
        print(f"slice int8: ServingSession ready in {time.perf_counter() - t0:.1f} s")
        phase[0] = "requests"
        logits = {n: session.predict(x) for n, x in requests.items()}
    finally:
        i8.quantize_cols = real_quantize
    k1, dynamic, static = (w.launches for w in wrappers)
    for n, out in logits.items():
        check(out.shape == (n, NUM_CLASSES) and out.dtype == np.float32
              and bool(np.isfinite(out).all()),
              f"slice int8: request of {n} -> finite float32 logits {out.shape}")
    gemms = len(INT8_GEMMS) * LAYERS
    check(quantized == {"load": gemms, "requests": 0},
          f"slice int8: quantize_cols ran {quantized['load']} times at load == {gemms} GEMMs, "
          f"{quantized['requests']} times in the requests")
    _serving_graphs(session, {"flash_attention_fwd": LAYERS, "int8_gemm_dynamic": gemms}, k1,
                    batches, "slice int8")
    want = (StepGraph.WARMUP + 1) * gemms * len(BUCKETS)
    check(dynamic == want and static == 0,
          f"slice int8: int8_gemm_dynamic counted {dynamic} == ({StepGraph.WARMUP} + 1) x "
          f"{gemms} GEMMs x {len(BUCKETS)} buckets, int8_gemm_static {static} == 0")
    with bench_torch.eager_on_card():
        eager = ServingSession(flagship(**shape, int8=True), params_from_jax(tree), IMAGE,
                               buckets=BUCKETS)
    same = [n for n, x in requests.items() if np.array_equal(eager.predict(x), logits[n])]
    check(len(same) == len(requests),
          f"slice int8: captured buckets == eager buckets bit for bit on {len(same)} of "
          f"{len(requests)} requests")
    del eager
    # the forward as it ran before the codes were cached: every weight quantized
    # per call, on the same padded bucket
    per_call = flagship(**shape, int8=True)
    per_call.load_state_dict(params_from_jax(tree))
    cast_frozen_(per_call.requires_grad_(False)).eval()
    padded = torch.zeros((BUCKETS[1], IMAGE, IMAGE, 3))
    padded[:CHECKED_REQUEST] = torch.from_numpy(requests[CHECKED_REQUEST])
    with torch.inference_mode():
        old = per_call(padded.cuda())[:CHECKED_REQUEST].float().cpu().numpy()
    check(np.array_equal(old, logits[CHECKED_REQUEST]),
          f"slice int8: logits of the {CHECKED_REQUEST}-image request == the per-call quantize's "
          "bit for bit")
    del per_call
    got = logits[CHECKED_REQUEST]
    rel = _rel(got, bf16_logits)
    check(bool((got.argmax(axis=1) == bf16_logits.argmax(axis=1)).all()),
          f"slice int8: top-1 int8 {got.argmax(axis=1).tolist()} == bf16 session "
          f"{bf16_logits.argmax(axis=1).tolist()} on the prototype images")
    check(rel <= TOL_INT8_VS_BF16_LOGITS_REL,
          f"slice int8: int8 session vs bf16 session: max |logit diff| / max |logit| = "
          f"{rel:.4e} <= {TOL_INT8_VS_BF16_LOGITS_REL:g}")

    # the int8 arithmetic on the card against the same on the CPU, fp32 outside the GEMMs
    checked = torch.from_numpy(requests[CHECKED_REQUEST])
    t0 = time.perf_counter()
    cpu_model = load_jax_variables(
        flagship(**shape, dtype=torch.float32, int8=True, device="cpu"), tree).eval()
    with torch.no_grad():
        cpu_logits = cpu_model(checked).numpy()
        nudged = _rel(cpu_model(checked * (1.0 + 1e-6)).numpy(), cpu_logits)
    del cpu_model
    print(f"slice int8: CPU fp32 int8 reference in {time.perf_counter() - t0:.1f} s")
    infer32 = make_infer_fn(flagship(**shape, dtype=torch.float32, int8=True),
                            params_from_jax(tree))
    card32 = infer32(checked.cuda())
    with plain_int8(i8):
        card32_plain = infer32(checked.cuda())
    check(torch.equal(card32, card32_plain),
          "slice int8: fp32 int8 forward on the card with the kernel == the same forward with "
          f"the plain version (largest diff {(card32 - card32_plain).abs().max().item():.3e})")
    card32 = card32.cpu().numpy()
    rel32 = _rel(card32, cpu_logits)
    check(rel32 <= TOL_INT8_F32_LOGITS_REL
          and bool((card32.argmax(1) == cpu_logits.argmax(1)).all()),
          f"slice int8: fp32 int8 card vs fp32 int8 CPU: max |logit diff| / max |logit| = "
          f"{rel32:.4e} <= {TOL_INT8_F32_LOGITS_REL:g}, top-1 equal (the CPU model on its input "
          f"scaled by 1 + 1e-6: {nudged:.4e})")
    del infer32
    return {"launches": dynamic, "vs_bf16_rel": rel,
            "latency_ms": _serving_latency(session, "int8", rng, smi)}


@contextlib.contextmanager
def plain_backward(attn):
    """Within, the ``flash_attention`` Function's backward runs the plain
    versions of the dq and dk/dv kernels and of the bias-gradient kernel on
    the q, k, v, lse, bias and dO that the model gives it; its forward stays
    the kernel."""
    saved = attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad
    attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad = (
        attn._bwd_dq_plain, attn._bwd_dkv_plain, attn._bias_grad_plain)
    try:
        yield
    finally:
        attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad = saved


@contextlib.contextmanager
def exact_backward(attn):
    """Within, the ``flash_attention`` Function's backward computes dq, dk and
    dv in float64 from the operands the model gives it (the plain versions'
    steps, with p and ds unrounded) and rounds each to its operand's dtype
    once: the reference the kernels' and the plain versions' bf16 rounding
    are both measured against.  The bias's gradient likewise (fp32, as the
    kernel returns it)."""
    saved = attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad

    def f64(t):
        return None if t is None else t.double()

    def dq(q, k, v, do, lse, o, scale, bias=None):
        g, delta = saved_plain[0](*(t.double() for t in (q, k, v, do, lse, o)), scale, f64(bias))
        return g.to(q.dtype), delta

    def dkv(q, k, v, do, lse, delta, scale, bias=None):
        gk, gv = saved_plain[1](*(t.double() for t in (q, k, v, do, lse, delta)), scale,
                                f64(bias))
        return gk.to(k.dtype), gv.to(v.dtype)

    def dbias(q, k, v, do, lse, scale, bias, delta=None, o=None):
        return saved_plain[2](*(t.double() for t in (q, k, v, do, lse)), scale, bias.double(),
                              f64(delta), f64(o)).float()

    saved_plain = attn._bwd_dq_plain, attn._bwd_dkv_plain, attn._bias_grad_plain
    attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad = (
        dq, dkv, dbias)
    try:
        yield
    finally:
        attn.flash_attention_bwd_dq, attn.flash_attention_bwd_dkv, attn.attention_bias_grad = saved


def train_phase(smi: str, device: str = "cuda") -> dict:
    """``device`` is the card; "cpu" rehearses the phase's own code at a tiny
    size, where no kernel is launched and the launch checks fail."""
    import bench_torch
    from peft_vit_tpu_torch.engine import init_cell_state, make_apply_fn
    from peft_vit_tpu_torch.models import cast_frozen_, flagship, load_jax_variables
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.peft import build_mask, count_trainable, split_params

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.RandomState(SEED + 1)
    tree = jax_layout_tree(rng)
    shape = dict(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                 num_classes=NUM_CLASSES, use_bn=True)

    def build(dtype, device, lr=bench_torch.LR):
        """The flagship with the LoRA mask applied: (model, frozen leaves,
        fresh train state, step function)."""
        model = load_jax_variables(
            flagship(**shape, dtype=dtype, ln_fp32=False, device=device), tree)
        mask = build_mask(model, "lora", num_layers=LAYERS)
        trainable, frozen = split_params(model, mask)
        cast_frozen_(model)
        n = count_trainable(model, mask)
        check(n == TRAINABLE, f"train: {dtype} on {device}: {n:,} trainable parameters == "
              f"{TRAINABLE:,}, stored in "
              f"{sorted({str(t.dtype) for t in trainable.values()})}")
        state = init_cell_state(trainable, dict(model.named_buffers()))
        step_fn = bench_torch.make_step(make_apply_fn(model), compute_dtype=dtype, has_bn=True,
                                        lr=lr)
        return model, frozen, state, step_fn

    def batches(k, b, device):
        xs = rng.randint(0, 256, (k, b, IMAGE, IMAGE, 3), dtype=np.uint8)
        ys = rng.randint(0, NUM_CLASSES, (k, b))
        return torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device)

    def steps(step_fn, state, xs, ys):
        """One step per batch of the chunk; the loss of each."""
        losses = []
        for i in range(xs.shape[0]):
            state, loss = step_fn(state, {}, xs[i:i + 1], ys[i:i + 1])
            losses.append(float(loss))
        return state, losses

    def updates(end, start):
        return {k: end.trainable[k].cpu() - v.cpu() for k, v in start.trainable.items()}

    def cosines(got, want):
        return {k: torch.nn.functional.cosine_similarity(
            got[k].flatten(), want[k].flatten(), dim=0).item() for k in want}

    def max_rel(got, want):
        return {k: ((got[k] - want[k]).abs().max() / want[k].abs().max()).item() for k in want}

    # ---- the main path: bf16 compute, fp32 masters, B = 16
    model, frozen, state0, step_fn = build(torch.bfloat16, device)
    frozen_start = {k: v.detach().clone() for k, v in frozen.items()}
    xs, ys = batches(TRAIN_STEPS, TRAIN_BATCH, device)
    steps(step_fn, state0, xs[:1], ys[:1])  # warm-up: library plans, kernels loaded
    sync()
    wrappers = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv}
    for w in wrappers.values():  # counts from 0 just before the main path, read just after
        w.launches = 0
    state, losses = steps(step_fn, state0, xs, ys)
    sync()
    launches = {name: w.launches for name, w in wrappers.items()}

    check(all(math.isfinite(x) for x in losses),
          f"train: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, losses "
          + " ".join(f"{x:.4f}" for x in losses) + " all finite")
    for name, n in launches.items():
        check(n == LAYERS * TRAIN_STEPS > 0,
              f"train: {name} launches {n} == {LAYERS} layers x {TRAIN_STEPS} steps")
    same = [k for k, v in frozen.items() if torch.equal(v, frozen_start[k])]
    check(len(same) == len(frozen) > 0,
          f"train: {len(same)} of {len(frozen)} frozen leaves bit-identical after the steps")
    moved = [k for k, v in state.trainable.items() if not torch.equal(v, state0.trainable[k])]
    check(len(moved) == len(state.trainable) == 4 * LAYERS + 2,
          f"train: {len(moved)} of {len(state.trainable)} trainable leaves moved")
    check(all(t.dtype == torch.float32 for t in (*state.trainable.values(),
                                                 *state.momentum.values(), *state.bn.values())),
          "train: trainable leaves, momentum and BN statistics are fp32")

    # the backward kernels on the main path's own q, k, v and dO: its first step
    # again, and once more with their plain versions in their place
    with_kernels, _ = steps(step_fn, state0, xs[:1], ys[:1])
    with plain_backward(attn):
        with_plain, _ = steps(step_fn, state0, xs[:1], ys[:1])
    got, want = updates(with_kernels, state0), updates(with_plain, state0)
    cos, rel = cosines(got, want), max_rel(got, want)
    low, far = min(cos, key=cos.get), max(rel, key=rel.get)
    check(cos[low] >= TOL_KERNEL_BWD_UPDATE_COS and rel[far] <= TOL_KERNEL_BWD_UPDATE_REL,
          f"train: one bf16 step at B={TRAIN_BATCH}, dq and dk/dv kernels vs their plain "
          f"versions in the same backward, update of each of {len(want)} leaves: least cosine "
          f"{cos[low]:.5f} >= {TOL_KERNEL_BWD_UPDATE_COS:g} ({low}), largest max |diff| / max "
          f"|update| {rel[far]:.3e} <= {TOL_KERNEL_BWD_UPDATE_REL:g} ({far})")
    del with_kernels, with_plain

    fixed_x, fixed_y = xs[:1].expand(FIXED_BATCH_STEPS, *xs.shape[1:]), ys[:1].expand(
        FIXED_BATCH_STEPS, -1)
    _, fixed = steps(step_fn, state0, fixed_x, fixed_y)
    check(all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
          f"train: {FIXED_BATCH_STEPS} steps on one batch lower the loss: "
          + " ".join(f"{x:.4f}" for x in fixed))

    # ---- the same 3 steps on the CPU in fp32 and on the card, at lr 1e-5: fp32
    # on the card (the kernels' fp32 instantiations) at B = 4, bf16 at B = 16
    def cpu_reference(batch):
        xs_, ys_ = batches(F32_STEPS, batch, "cpu")
        t0 = time.perf_counter()
        _, _, start, cpu_step = build(torch.float32, "cpu", COMPARE_LR)
        end, cpu_losses = steps(cpu_step, start, xs_, ys_)
        print(f"train: CPU fp32 reference, {F32_STEPS} steps at B={batch} in "
              f"{time.perf_counter() - t0:.1f} s, losses "
              + " ".join(f"{x:.5f}" for x in cpu_losses))
        return xs_.to(device), ys_.to(device), start, end, cpu_losses

    def loss_rel(got, want):
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    xs4, ys4, cpu_start, cpu_end, cpu_losses = cpu_reference(F32_BATCH)
    _, _, card_start, card_step = build(torch.float32, device, COMPARE_LR)
    card_end, card_losses = steps(card_step, card_start, xs4, ys4)
    rel = loss_rel(card_losses, cpu_losses)
    check(rel <= TOL_F32_TRAIN_LOSS_REL,
          f"train: fp32 card vs fp32 CPU at B={F32_BATCH}, per-step loss max rel diff "
          f"{rel:.3e} <= {TOL_F32_TRAIN_LOSS_REL:g} ("
          + " ".join(f"{x:.5f}" for x in card_losses) + ")")
    want, got = updates(cpu_end, cpu_start), updates(card_end, card_start)
    worst = max(max_rel(got, want).values())
    check(worst <= TOL_F32_TRAIN_UPDATE_REL,
          f"train: fp32 card vs fp32 CPU, updated leaves after {F32_STEPS} steps: "
          f"max |diff| / max |update| = {worst:.3e} <= {TOL_F32_TRAIN_UPDATE_REL:g}")
    del card_step, card_end, cpu_end

    xs16, ys16, cpu_start, cpu_end, cpu_losses = cpu_reference(TRAIN_BATCH)
    _, _, bf16_start, bf16_step = build(torch.bfloat16, device, COMPARE_LR)
    bf16_end, bf16_losses = steps(bf16_step, bf16_start, xs16, ys16)
    rel = loss_rel(bf16_losses, cpu_losses)
    check(rel <= TOL_BF16_TRAIN_LOSS_REL,
          f"train: bf16 card vs fp32 CPU at B={TRAIN_BATCH}, per-step loss max rel diff "
          f"{rel:.3e} <= {TOL_BF16_TRAIN_LOSS_REL:g} ("
          + " ".join(f"{x:.5f}" for x in bf16_losses) + ")")
    want, got = updates(cpu_end, cpu_start), updates(bf16_end, bf16_start)
    cos = cosines(got, want)
    low, median = min(cos, key=cos.get), statistics.median(cos.values())
    with plain_backward(attn):  # the yardstick: the same steps without the backward kernels
        plain_end, _ = steps(bf16_step, bf16_start, xs16, ys16)
    plain_cos = cosines(updates(plain_end, bf16_start), want).values()
    check(cos[low] >= TOL_BF16_TRAIN_UPDATE_COS_LEAST
          and median >= TOL_BF16_TRAIN_UPDATE_COS_MEDIAN,
          f"train: bf16 card vs fp32 CPU at B={TRAIN_BATCH}, update of each of {len(want)} "
          f"leaves after {F32_STEPS} steps: least cosine {cos[low]:.4f} >= "
          f"{TOL_BF16_TRAIN_UPDATE_COS_LEAST:g} ({low}), median {median:.4f} >= "
          f"{TOL_BF16_TRAIN_UPDATE_COS_MEDIAN:g}, largest max |diff| / max |update| "
          f"{max(max_rel(got, want).values()):.3e} (with the plain dq and dk/dv: least "
          f"{min(plain_cos):.4f}, median {statistics.median(plain_cos):.4f})")
    del bf16_step, bf16_end, plain_end, cpu_end

    # ---- numbers
    rates, _ = bench_torch.measure(step_fn, state0, {}, TRAIN_BATCH, TRAIN_K, TRAIN_WINDOWS,
                                   warmup=1, image=IMAGE, num_classes=NUM_CLASSES, device=device)
    rate = statistics.median(rates)
    step_ms = 1e3 * TRAIN_BATCH / rate
    print(f"train rate B={TRAIN_BATCH} k={TRAIN_K}: {rate:.1f} images/s, {step_ms:.3f} ms/step "
          f"(median of {TRAIN_WINDOWS} windows: " + " ".join(f"{r:.1f}" for r in rates)
          + f"; host clock, one sync per window; {smi})")
    result = {"launches": launches, "images_per_s": rate}
    device_ms, n_launches, top = _device_breakdown(
        lambda: steps(step_fn, state0, xs[:2], ys[:2]), reps=1, host_top=10)
    if device_ms is None:
        print("train profile: device time not measured (the profiler saw no CUDA kernel)")
        return result
    device_ms, n_launches = device_ms / 2, n_launches / 2  # two steps per call
    print(f"train profile: device busy {device_ms:.3f} ms/step in {n_launches:.0f} launches, "
          f"idle share {max(0.0, 1.0 - device_ms / step_ms):.3f} of the {step_ms:.3f} ms step; "
          "top: " + "; ".join(f"{name} {t / 2:.3f} ms" for name, t in top))
    print(f"train profile: {n_launches:.1f} launches a step at {LAYERS} blocks (two steps "
          f"profiled); {TRAIN_STEP_LAUNCHES_12} at 12 blocks with no delta expression")
    return result


@contextlib.contextmanager
def plain_int8(i8):
    """Within, the int8 ops run the plain versions of the kernel, forward and
    dx backward, on the tensors the model gives them."""
    saved = i8.int8_gemm_dynamic, i8.int8_gemm_static
    i8.int8_gemm_dynamic, i8.int8_gemm_static = i8._prequant_forward, i8._static_forward
    try:
        yield
    finally:
        i8.int8_gemm_dynamic, i8.int8_gemm_static = saved


def int8_train_phase(smi: str, bf16_rate: float, device: str = "cuda") -> dict:
    """The flagship with ``int8_train=True`` (bf16 compute, fp32 masters, LoRA
    mask) takes SGD steps at batch 16 under three recipes: the pre-quantized
    tree (dense dx), the tree with the int8 dx backward, and static activation
    scales (margin 1.5) with the int8 dx.  ``device`` "cpu" rehearses the
    phase's code at a tiny size, where no kernel is launched."""
    import bench_torch
    from peft_vit_tpu_torch.engine import init_cell_state, make_apply_fn
    from peft_vit_tpu_torch.models import flagship, load_jax_variables
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.RandomState(SEED + 3)
    tree = jax_layout_tree(rng)
    shape = dict(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                 num_classes=NUM_CLASSES, use_bn=True)
    xs = torch.as_tensor(rng.randint(0, 256, (INT8_TRAIN_STEPS, TRAIN_BATCH, IMAGE, IMAGE, 3),
                                     dtype=np.uint8), device=device)
    ys = torch.as_tensor(rng.randint(0, NUM_CLASSES, (INT8_TRAIN_STEPS, TRAIN_BATCH)),
                         device=device)

    def steps(step_fn, state, frozen, xs_, ys_):
        losses = []
        for i in range(xs_.shape[0]):
            state, loss = step_fn(state, frozen, xs_[i:i + 1], ys_[i:i + 1])
            losses.append(float(loss))
        return state, losses

    wrappers = {"flash_attn_fwd": attn.flash_attention_fwd,
                "flash_attn_bwd_dq": attn.flash_attention_bwd_dq,
                "flash_attn_bwd_dkv": attn.flash_attention_bwd_dkv,
                "int8_gemm_dynamic": i8.int8_gemm_dynamic,
                "int8_gemm_static": i8.int8_gemm_static}
    gemms = len(INT8_GEMMS) * LAYERS
    result = {}
    for name, bwd_dx, static in (("prequant", False, False), ("prequant+dx", True, False),
                                 ("static+dx", True, True)):
        model = load_jax_variables(
            flagship(**shape, dtype=torch.bfloat16, ln_fp32=False, int8_train=True,
                     device=device), tree)
        trainable, frozen, qtree = bench_torch.prepare(model, LAYERS, int8=True, bwd_dx=bwd_dx)
        apply_fn = make_apply_fn(model)
        if static:
            qtree.update(bench_torch.calibration_scales(
                model, apply_fn, TRAIN_BATCH, IMAGE, torch.bfloat16, device))
        per_gemm = (4 if bwd_dx else 2) + (1 if static else 0)
        check(len(qtree) == gemms * per_gemm and all(
            t.device.type == device for t in qtree.values()),
            f"train int8 {name}: the quantized tree holds {len(qtree)} == {gemms} GEMMs x "
            f"{per_gemm} tensors")
        state0 = init_cell_state(trainable, dict(model.named_buffers()))
        step_fn = bench_torch.make_step(apply_fn, compute_dtype=torch.bfloat16, has_bn=True)
        start = {k: v.detach().clone() for k, v in {**frozen, **qtree}.items()}
        steps(step_fn, state0, qtree, xs[:1], ys[:1])  # warm-up
        sync()
        for w in wrappers.values():  # counts from 0 just before the main path, read just after
            w.launches = 0
        state, losses = steps(step_fn, state0, qtree, xs, ys)
        sync()
        launches = {k: w.launches for k, w in wrappers.items()}

        # Every Int8Dense runs once forward.  The dx product runs where the
        # GEMM's input needs a gradient: everywhere but block 0's in_proj, whose
        # input depends on no trainable leaf.
        fwd = gemms * INT8_TRAIN_STEPS
        dx = (gemms - 1) * INT8_TRAIN_STEPS if bwd_dx else 0
        want = {"int8_gemm_dynamic": dx + (0 if static else fwd),
                "int8_gemm_static": fwd if static else 0,
                "flash_attn_fwd": LAYERS * INT8_TRAIN_STEPS,
                "flash_attn_bwd_dq": LAYERS * INT8_TRAIN_STEPS,
                "flash_attn_bwd_dkv": LAYERS * INT8_TRAIN_STEPS}
        for k, n in launches.items():
            check(n == want[k] and (device != "cuda" or n > 0 or want[k] == 0),
                  f"train int8 {name}: {k} launches {n} == {want[k]} in {INT8_TRAIN_STEPS} steps")
        check(all(math.isfinite(x) for x in losses),
              f"train int8 {name}: {INT8_TRAIN_STEPS} steps at B={TRAIN_BATCH}, losses "
              + " ".join(f"{x:.4f}" for x in losses) + " all finite")
        same = [k for k, v in {**frozen, **qtree}.items() if torch.equal(v, start[k])]
        check(len(same) == len(start),
              f"train int8 {name}: {len(same)} of {len(start)} frozen leaves and tensors of the "
              "quantized tree bit-identical after the steps")
        moved = [k for k, v in state.trainable.items() if not torch.equal(v, state0.trainable[k])]
        check(len(moved) == len(state.trainable) == 4 * LAYERS + 2,
              f"train int8 {name}: {len(moved)} of {len(state.trainable)} trainable leaves moved")

        # the kernel on the model's own activations and cotangents: the first
        # step again, and once more with the plain versions in its place
        with_kernel, _ = steps(step_fn, state0, qtree, xs[:1], ys[:1])
        with plain_int8(i8):
            with_plain, _ = steps(step_fn, state0, qtree, xs[:1], ys[:1])
        differ = [k for k, v in with_kernel.trainable.items()
                  if not torch.equal(v, with_plain.trainable[k])]
        worst = max(((with_kernel.trainable[k] - with_plain.trainable[k]).abs().max().item()
                     for k in differ), default=0.0)
        check(not differ,
              f"train int8 {name}: one step's update with the kernel == the same step with the "
              f"plain versions, {len(with_kernel.trainable) - len(differ)} of "
              f"{len(with_kernel.trainable)} leaves bit-identical (largest diff {worst:.3e})")
        del with_kernel, with_plain

        fixed_x = xs[:1].expand(FIXED_BATCH_STEPS, *xs.shape[1:])
        fixed_y = ys[:1].expand(FIXED_BATCH_STEPS, -1)
        _, fixed = steps(step_fn, state0, qtree, fixed_x, fixed_y)
        check(all(math.isfinite(x) for x in fixed) and fixed[-1] < fixed[0],
              f"train int8 {name}: {FIXED_BATCH_STEPS} steps on one batch lower the loss: "
              + " ".join(f"{x:.4f}" for x in fixed))

        rates, _ = bench_torch.measure(step_fn, state0, qtree, TRAIN_BATCH, TRAIN_K, 5, warmup=1,
                                       image=IMAGE, num_classes=NUM_CLASSES, device=device)
        rate = statistics.median(rates)
        step_ms = 1e3 * TRAIN_BATCH / rate
        print(f"train int8 {name} rate B={TRAIN_BATCH} k={TRAIN_K}: {rate:.1f} images/s, "
              f"{step_ms:.3f} ms/step (median of 5 windows: " + " ".join(f"{r:.1f}" for r in rates)
              + f"; bf16 step of the same call {bf16_rate:.1f} images/s; host clock; {smi})")
        result[name] = {"launches": launches, "images_per_s": rate}
        if device != "cuda":
            continue
        device_ms, n_launches, top = _device_breakdown(
            lambda: steps(step_fn, state0, qtree, xs[:2], ys[:2]), reps=1)
        if device_ms is None:
            print(f"train int8 {name} profile: device time not measured")
            continue
        print(f"train int8 {name} profile: device busy {device_ms / 2:.3f} ms/step in "
              f"{n_launches / 2:.0f} launches, idle share "
              f"{max(0.0, 1.0 - device_ms / 2 / step_ms):.3f} of the {step_ms:.3f} ms step; top: "
              + "; ".join(f"{k} {t / 2:.3f} ms" for k, t in top))
        del model, step_fn, state0, state
    return result


# The captured step and a sweep round at the full width of ViT-B/16.
GRAPH_STEPS = 3  # steps of one epoch, captured against eager
GRAPH_RECIPES = (("bf16", False, False, False), ("int8 prequant", True, False, False),
                 ("int8 prequant+dx", True, True, False), ("int8 static+dx", True, True, True))
ROUND_SIZES = (3, 7)
ROUND_BATCHES = 2  # an epoch of a round: 2 batches of 16, as the driver's 20 training images
ROUND_REPS = 5  # timed epochs of each
ROUND_LRS, ROUND_WDS = (1e-5, 2e-5, 5e-5), (1e-4, 1e-2, 1.0)  # the compared round of 3
# A round of 3 against its cells trained one at a time, each trainable leaf
# at lr 1e-5 (the LoRA B leaves start at 0, so theirs is the update).  The
# round's forward is a cell's bit for bit (the frozen GEMMs fold the cells
# into their rows, the bias inside the GEMM as for one cell), but the LoRA
# weight gradients of a round are batched GEMMs whose sums of 16 x 197
# products cuBLAS orders otherwise than one cell's, and bf16 rounds them
# otherwise here and there.  bf16: cosine per leaf after one step, the bound
# that holds a kernel inside one step (TOL_KERNEL_BWD_UPDATE_COS; measured on
# the H100: least 1.000000 of 150 pairs, printed to 6 places); a second step
# carries the first one's rounding into its forward (0.999151), so that is
# printed, not held.
# fp32: the same arithmetic with sums in another order, after both steps, on
# what the steps changed, so that a cell's lr or wd taken for another's shows:
# the update (end - start) of each trainable leaf and BN statistic and the
# momentum buffer (start 0), max |diff| <= TOL_ROUND_F32_REL x max |update| +
# TOL_ROUND_F32_ULPS units in the last place of max |start| (an fp32 leaf
# rounds its update to its own ulp: a LoRA A leaf's weight decay at lr 1e-5,
# wd 1e-4 moves it by 1e-9 of itself, below one).
TOL_ROUND_BF16_COS = 0.999
TOL_ROUND_F32_REL = 1e-4
TOL_ROUND_F32_ULPS = 4


def _per_replay(graph, want: dict, what: str) -> None:
    """Hold a StepGraph's launches per replay (what its capture counted)
    against ``want`` (every other wrapper: 0)."""
    if graph is None:
        check(False, f"{what}: no graph was captured")
        return
    got = {k: n for k, n in graph.launches.items() if n or k in want}
    full = {k: want.get(k, 0) for k in got}
    check(got == full and (any(got.values()) or not any(want.values())),
          f"{what}: launches per replay {got} == {full}")


def _flagship_state(tree, dtype, device, int8_train=False, bwd_dx=False, int8_attn=False,
                    int8_attn_pv=False):
    """The flagship (channel BN, LoRA mask; ``int8_attn``: int8 attention
    scores, ``int8_attn_pv`` with P V) from ``tree``: (model, the trainable
    leaves, the quantized tree or {}, a fresh state)."""
    import bench_torch
    from peft_vit_tpu_torch.engine import init_cell_state
    from peft_vit_tpu_torch.models import flagship, load_jax_variables

    shape = dict(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                 num_classes=NUM_CLASSES, use_bn=True)
    model = load_jax_variables(flagship(**shape, dtype=dtype, ln_fp32=False,
                                        int8_train=int8_train, int8_attn=int8_attn,
                                        int8_attn_pv=int8_attn_pv, device=device), tree)
    trainable, _, qtree = bench_torch.prepare(model, LAYERS, int8=int8_train, bwd_dx=bwd_dx)
    bn = {k: v for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    return model, trainable, qtree, init_cell_state(trainable, bn)


def graph_phase(smi: str, device: str = "cuda") -> dict:
    """The step as the engine runs it: one epoch of ``GRAPH_STEPS`` steps at
    B=16 through ``make_epoch_fn``, captured (a CUDA-graph replay a step)
    against the same epoch run eagerly on the same state and batches, equal
    bit for bit, for bf16 and the three int8 recipes; the launches of a
    replay against their formulas; the captured and eager step rates.  Then a
    sweep round of 3 cells against the same cells trained one at a time,
    and the times of rounds of 3 and 7 against their cells one at a time.
    ``device`` "cpu" rehearses the phase's code at a tiny size (no capture
    there: the checks of the graphs fail)."""
    import bench_torch
    from peft_vit_tpu_torch.engine import StepGraph, ce_per_example, make_apply_fn, make_epoch_fn
    from peft_vit_tpu_torch.ops import launch_counts

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.RandomState(SEED + 9)
    tree = jax_layout_tree(rng)
    n = GRAPH_STEPS * TRAIN_BATCH
    images = rng.randint(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
    x = bench_torch.normalize(torch.as_tensor(images, device=device), torch.float32)
    y = torch.as_tensor(rng.randint(0, NUM_CLASSES, n), device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    perm = rng.permutation(n)
    gemms = len(INT8_GEMMS) * LAYERS
    result = {}
    for name, int8_train, bwd_dx, static in GRAPH_RECIPES:
        model, _, qtree, state0 = _flagship_state(tree, torch.bfloat16, device, int8_train,
                                                  bwd_dx)
        apply_fn = make_apply_fn(model)
        graphs = {}
        epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True,
                              calibrate_model=model if static else None, graphs=graphs)
        run = lambda: epoch(state0, qtree, x, y, valid, perm, bench_torch.LR, bench_torch.WD)
        with bench_torch.eager_on_card():
            eager, eager_loss = run()
        sync()
        before = launch_counts()  # counts from 0 just before the main path, read just after
        captured, captured_loss = run()
        sync()
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        differ = [f"{part}.{k}" for part in ("trainable", "momentum", "bn")
                  for k, v in getattr(eager, part).items()
                  if not torch.equal(v, getattr(captured, part)[k])]
        check(not differ and torch.equal(eager_loss, captured_loss),
              f"graph {name}: {GRAPH_STEPS} captured steps == the same steps eager, bit for bit: "
              f"{len(eager.trainable) * 2 + len(eager.bn) - len(differ)} of "
              f"{len(eager.trainable) * 2 + len(eager.bn)} leaves, momentum buffers and BN "
              f"statistics equal, mean loss {float(captured_loss):.6f} == "
              f"{float(eager_loss):.6f}" + (f"; differ: {differ[:4]}" if differ else ""))
        graph = graphs.get(("step", None, TRAIN_BATCH))
        if graph is None:
            check(False, f"graph {name}: no step graph was captured")
            continue
        fwd = gemms
        dx = gemms - 1 if bwd_dx else 0  # block 0's in_proj input needs no gradient
        want = {"flash_attention_fwd": LAYERS, "flash_attention_bwd_dq": LAYERS,
                "flash_attention_bwd_dkv": LAYERS}
        if int8_train:
            want["int8_gemm_dynamic"] = dx + (0 if static else fwd)
            want["int8_gemm_static"] = fwd if static else 0
        _per_replay(graph, want, f"graph {name}")
        # the calibration forward runs eagerly, outside the graph, once an epoch
        calib = ({"flash_attention_fwd": LAYERS, "int8_gemm_dynamic": fwd} if static else {})
        wanted = {k: (StepGraph.WARMUP + 1) * graph.launches[k] + calib.get(k, 0)
                  for k in counts}
        check(counts == wanted and graph.replays == GRAPH_STEPS,
              f"graph {name}: the wrappers counted {counts} == ({StepGraph.WARMUP} warm-up "
              f"steps + the capture) x the launches per replay + the calibration; "
              f"{graph.replays} replays == {GRAPH_STEPS} steps")
        before = launch_counts()
        run()
        sync()
        again = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        check(again == calib and graph.replays == 2 * GRAPH_STEPS,
              f"graph {name}: a second epoch replays the graph ({graph.replays} replays) and "
              f"the wrappers count only the calibration {again}")

        # the step rates, captured and eager, as bench_torch.py times them (the
        # static scales calibrated once, as it does)
        frozen = qtree if not static else {**qtree, **bench_torch.calibration_scales(
            model, apply_fn, TRAIN_BATCH, IMAGE, torch.bfloat16, device)}
        rates = {}
        for capture in (False, True):
            with contextlib.nullcontext() if capture else bench_torch.eager_on_card():
                r, _ = bench_torch.measure(
                    bench_torch.make_epoch_step(apply_fn, has_bn=True), state0, frozen,
                    TRAIN_BATCH, TRAIN_K, 5, warmup=1, image=IMAGE, num_classes=NUM_CLASSES,
                    device=device)
            rates[capture] = statistics.median(r)
        step_ms = 1e3 * TRAIN_BATCH / rates[True]
        print(f"graph {name} rate B={TRAIN_BATCH} k={TRAIN_K}: captured {rates[True]:.1f} "
              f"images/s ({step_ms:.3f} ms/step), eager {rates[False]:.1f} images/s "
              f"({1e3 * TRAIN_BATCH / rates[False]:.3f} ms/step) (median of 5 windows; host "
              f"clock; {smi})")
        result[name] = {"images_per_s": rates[True], "eager_images_per_s": rates[False],
                        "launches_per_replay": dict(graph.launches)}
        if on_card:  # a window of the captured steps under the profiler
            epoch = bench_torch.make_epoch_step(apply_fn, has_bn=True)
            xs = torch.as_tensor(np.random.RandomState(SEED + 11).randint(
                0, 256, (TRAIN_K, TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8), device=device)
            ys = torch.as_tensor(np.random.RandomState(SEED + 12).randint(
                0, NUM_CLASSES, (TRAIN_K, TRAIN_BATCH)), device=device)
            epoch(state0, frozen, xs, ys)  # the capture
            device_ms, n_launches, top = _device_breakdown(lambda: epoch(state0, frozen, xs, ys),
                                                           reps=1)
            window_ms = TRAIN_K * step_ms
            if device_ms is None:
                print(f"graph {name} profile: device time not measured")
            else:
                print(f"graph {name} profile: a window of {TRAIN_K} captured steps, device busy "
                      f"{device_ms / TRAIN_K:.3f} ms/step in {n_launches / TRAIN_K:.0f} launches "
                      f"(the window's state copies included), idle share "
                      f"{max(0.0, 1.0 - device_ms / window_ms):.3f} of the {window_ms:.3f} ms "
                      "window at the captured rate; top: "
                      + "; ".join(f"{k} {t / TRAIN_K:.3f} ms" for k, t in top))
        del model, epoch, graphs, graph, eager, captured, frozen
    result["round"] = round_phase(smi, tree, x, y, valid, device)
    return result


def round_phase(smi: str, tree, x, y, valid, device: str = "cuda") -> dict:
    """A sweep round (``make_epoch_fn(cells=True)``) against its cells
    trained one at a time (``cells=False``), both captured: the compared
    round of 3 in bf16 and in fp32 after one and ``ROUND_BATCHES`` steps;
    then the times of a round of 3 and of 7 against their cells, the
    launches per replay of the round's step (those of one cell's step) and
    the peak memory; then an int8 round's launches per replay."""
    from peft_vit_tpu_torch.commands.run import _fresh_leaf
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn, make_eval_fn, step_decay_lr)
    from peft_vit_tpu_torch.engine.sweep import CellKey

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = ROUND_BATCHES * TRAIN_BATCH
    perm = np.random.RandomState(SEED + 10).permutation(n)
    data = (x[:n], y[:n], valid[:n])  # one set of tensors: a graph reads them in place
    result = {}

    def stacked(trainable, bn, k):
        draws = [{name: _fresh_leaf(name, v.shape, CellKey(SEED, k, i).generator())
                  for name, v in trainable.items()} for i in range(k)]
        start = {name: torch.stack([d[name] for d in draws]).to(device) for name in draws[0]}
        return draws, init_cell_state(start, {n_: v.expand(k, *v.shape) for n_, v in bn.items()})

    for dtype in (torch.bfloat16, torch.float32):
        model, trainable, _, state0 = _flagship_state(tree, dtype, device)
        apply_fn = make_apply_fn(model)
        graphs = {}
        epoch = {cells: make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True,
                                      cells=cells, graphs=graphs) for cells in (False, True)}
        k = len(ROUND_LRS)
        draws, state = stacked(trainable, state0.bn, k)

        def compare(steps):
            """Each (cell, leaf) after ``steps`` steps, the round against the
            cell alone.  bf16: the trainable leaves' cosine.  fp32: each
            trainable leaf's, momentum buffer's and BN statistic's change
            over the steps, max |diff| over the bound of TOL_ROUND_F32_REL
            and TOL_ROUND_F32_ULPS (<= 1 holds), and max |diff| / max
            |change| at the worst pair."""
            rows = steps * TRAIN_BATCH
            p = np.random.RandomState(SEED + 10).permutation(rows)
            args = (x[:rows], y[:rows], valid[:rows], p)
            end, _ = epoch[True](state, {}, *args, step_decay_lr(ROUND_LRS, 0, ()),
                                 torch.tensor(ROUND_WDS))
            worst, rel = {}, {}
            eps = torch.finfo(torch.float32).eps
            for i in range(k):
                alone = init_cell_state({n_: v.to(device) for n_, v in draws[i].items()},
                                        state0.bn)
                alone_end, _ = epoch[False](alone, {}, *args, ROUND_LRS[i], ROUND_WDS[i])
                if dtype == torch.bfloat16:
                    for name, v in alone_end.trainable.items():
                        worst[(i, name)] = torch.nn.functional.cosine_similarity(
                            end.trainable[name][i].float().flatten(), v.float().flatten(),
                            dim=0).item()
                    continue
                for part in ("trainable", "momentum", "bn"):
                    for name, v in getattr(alone_end, part).items():
                        start = getattr(alone, part)[name].float()
                        want = v.float() - start
                        got = getattr(end, part)[name][i].float() - start
                        diff = (got - want).abs().max().item()
                        change = want.abs().max().item()
                        bound = (TOL_ROUND_F32_REL * change
                                 + TOL_ROUND_F32_ULPS * eps * start.abs().max().item())
                        worst[(i, f"{part} {name}")] = diff / bound if bound else math.inf
                        rel[(i, f"{part} {name}")] = diff / change if change else math.inf
            key = (min if dtype == torch.bfloat16 else max)(worst, key=worst.get)
            return worst[key], key, len(worst), rel.get(key)

        (one, one_at, pairs, one_rel), (two, two_at, _, two_rel) = (compare(1),
                                                                    compare(ROUND_BATCHES))
        if dtype == torch.bfloat16:
            check(one >= TOL_ROUND_BF16_COS,
                  f"round bf16: {k} cells together vs one at a time, each of {pairs} (cell, "
                  f"leaf) pairs after one step: least cosine {one:.6f} >= "
                  f"{TOL_ROUND_BF16_COS:g} (cell {one_at[0]}, {one_at[1]}); after "
                  f"{ROUND_BATCHES} steps {two:.6f} (cell {two_at[0]}, {two_at[1]}), not held")
        else:
            check(two <= 1.0,
                  f"round fp32: {k} cells together vs one at a time, each of {pairs} (cell, "
                  f"state tensor) pairs' change over {ROUND_BATCHES} steps (trainable leaves, "
                  f"momentum, BN statistics): largest max |diff| / ({TOL_ROUND_F32_REL:g} x max "
                  f"|change| + {TOL_ROUND_F32_ULPS} ulp of max |start|) {two:.3e} <= 1 (cell "
                  f"{two_at[0]}, {two_at[1]}: max |diff| / max |change| {two_rel:.3e}); after "
                  f"one step {one:.3e} ({one_at[1]}, {one_rel:.3e})")
        if dtype == torch.float32 or not on_card:
            del model, graphs, epoch
            continue
        for k in ROUND_SIZES:  # bf16 timings: a round against its cells one at a time
            graphs.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            draws, state = stacked(trainable, state0.bn, k)
            lrs, wds = [1e-5] * k, torch.full((k,), 1e-4)
            times = {}
            for cells in (True, False):
                def one_round():
                    if cells:
                        epoch[True](state, {}, *data, perm, step_decay_lr(lrs, 0, ()), wds)
                    else:
                        for i in range(k):
                            epoch[False](state0, {}, *data, perm, 1e-5, 1e-4)
                one_round()
                sync()
                reps = []
                for _ in range(ROUND_REPS):
                    t0 = time.perf_counter()
                    one_round()
                    sync()
                    reps.append((time.perf_counter() - t0) * 1e3)
                times[cells] = statistics.median(reps)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            g = graphs[("step", k, TRAIN_BATCH)]
            _per_replay(g, {"flash_attention_fwd": LAYERS, "flash_attention_bwd_dq": LAYERS,
                            "flash_attention_bwd_dkv": LAYERS},
                        f"round of {k}: one step of the round")
            print(f"round of {k} bf16: an epoch of {ROUND_BATCHES} steps at B={TRAIN_BATCH} "
                  f"takes {times[True]:.3f} ms for the round, {times[False]:.3f} ms for its "
                  f"{k} cells one at a time ({times[False] / times[True]:.2f}x; median of "
                  f"{ROUND_REPS}, host clock, captured); peak device memory {peak:.2f} GiB "
                  f"above the model, both graphs held; {smi}")
            result[k] = {"round_ms": times[True], "serial_ms": times[False], "peak_gib": peak}
        graphs.clear()
        del model, epoch
        torch.cuda.empty_cache()

    # an int8 round of 3: the tower's GEMMs launch once for the round, forward
    # and dx, unless each cell calibrates its own static scale (once a cell)
    k, gemms = len(ROUND_LRS), len(INT8_GEMMS) * LAYERS
    for name, static in (("prequant+dx", False), ("static+dx", True)):
        model, trainable, qtree, state0 = _flagship_state(tree, torch.bfloat16, device, True,
                                                          True)
        apply_fn = make_apply_fn(model)
        graphs = {}
        epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True,
                              calibrate_model=model if static else None, graphs=graphs)
        evaluate = make_eval_fn(apply_fn, TRAIN_BATCH, has_bn=True, cells=True, graphs=graphs)
        _, state = stacked(trainable, state0.bn, k)
        end, losses = epoch(state, qtree, *data, perm, step_decay_lr(ROUND_LRS, 0, ()),
                            torch.tensor(ROUND_WDS))
        logits = evaluate(end.trainable, qtree, data[0], end.bn)
        check(losses.shape == (k,) and bool(losses.isfinite().all())
              and logits.shape == (k, n, NUM_CLASSES) and bool(logits.isfinite().all()),
              f"round int8 {name}: a round of {k}, losses " + " ".join(
                  f"{float(v):.4f}" for v in losses) + f", eval logits {tuple(logits.shape)} "
              "finite")
        want = {"flash_attention_fwd": LAYERS, "flash_attention_bwd_dq": LAYERS,
                "flash_attention_bwd_dkv": LAYERS}
        if static:
            want.update(int8_gemm_static=k * gemms, int8_gemm_dynamic=k * (gemms - 1))
        else:
            want.update(int8_gemm_dynamic=gemms + gemms - 1)
        _per_replay(graphs.get(("step", k, TRAIN_BATCH)), want,
                    f"round int8 {name}: one step of a round of {k}")
        _per_replay(graphs.get(("eval", k, TRAIN_BATCH)),
                    {"flash_attention_fwd": LAYERS, "int8_gemm_dynamic": gemms},
                    f"round int8 {name}: one eval batch of a round of {k}")
        del model, epoch, evaluate, graphs
    return result


# The driver: finetune_main through the port at the full width of ViT-B/16
# (vitb16_CLIP.yaml), the synthetic dataset 5-way 4-shot, batch 16, 2 epochs a
# cell, a 3-point wd grid under the default 6-point lr grid: 18 cells, then the
# final train on train+val for 2 + EXTRA_FINAL_TRAIN_EPOCH epochs, cut from the
# yaml's 40 to 2 for the script's time (every drive of the script that takes
# DRIVER or ZS: 4 final epochs, not 42).
MODEL_YAML = "peft_vit_tpu/resources/model/vitb16_CLIP.yaml"
DRIVE_EXTRA_FINAL_EPOCHS = 2
DRIVER = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 5,
          "DATASET.NUM_SAMPLES_PER_CLASS": 4, "TRAIN.BATCH_SIZE_PER_GPU": 16,
          "TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 3, "TRAIN.SEARCH_WD_INIT_POINTS": 3,
          "TRAIN.EXTRA_FINAL_TRAIN_EPOCH": DRIVE_EXTRA_FINAL_EPOCHS, "PEFT.METHOD": "lora"}
DRIVER_CELLS = 6 * 3
# The flagship's depth (``LAYERS`` of the yaml's 12 blocks) wherever a drive
# takes ``jax_layout_tree``'s weights, and AdapterDrop on its last block
FLAGSHIP_DEPTH = {"MODEL.SPEC.VISION.LAYERS": LAYERS, "PEFT.ADAPTER_LAYERS": [LAYERS - 1]}
# The card-vs-CPU check of the driver: the SKILL.md tiny drive (clip_tiny,
# 16 px, 2 layers) in fp32 with a 2-lr grid over a 5-point wd grid up to
# 1e-2, at width 64 with one head: the card's attention kernels take head
# dim 64 only.  Larger lr or wd make the tiny model chaotic from step to step,
# and two devices' fp32 runs then part (measured on the CPU against the JAX
# package: 2e-6 apart after one epoch at lr 0.02, 20 % after three).
TINY_DRIVER = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4,
               "DATASET.NUM_SAMPLES_PER_CLASS": 8, "TRAIN.IMAGE_SIZE": [16, 16],
               "TRAIN.BATCH_SIZE_PER_GPU": 8, "TRAIN.END_EPOCH": 8, "TRAIN.SCHEDULE": [],
               "TRAIN.SEARCH_WD_POINTS": 5, "TRAIN.SEARCH_WD_INIT_POINTS": 3,
               "TRAIN.SEARCH_WD_LOG_UPPER": -2, "MODEL.NAME": "clip_tiny",
               "MODEL.SPEC.EMBED_DIM": 32, "MODEL.SPEC.VISION.PATCH_SIZE": 8,
               "MODEL.SPEC.VISION.WIDTH": 64, "MODEL.SPEC.VISION.LAYERS": 2,
               "MODEL.SPEC.VISION.HEADS": 1, "PEFT.METHOD": "lora",
               "TPU.COMPUTE_DTYPE": "float32"}
TINY_DRIVER_LRS = (1e-4, 1e-3)


def driver_cfg(over: dict, yaml_file=MODEL_YAML):
    from peft_vit_tpu_torch.config import get_default_config

    cfg = get_default_config()
    if yaml_file:
        cfg.merge_from_file(yaml_file)
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


@contextlib.contextmanager
def driver_spy(run, sync, lr_grid=None):
    """Within, ``finetune_main`` runs as it does, observed: its SweepEngine
    counts the rounds and cells it trains, keeps every epoch's loss (each
    cell's), its CUDA graphs and the wall time of the sweep and of the final
    train (``lr_grid`` replaces the default lr grid); the frozen leaves (and
    a contrastive model's class-text bank) are copied right after the driver
    casts them, each ``quantize_frozen_tree`` call is counted, its tree
    copied; each cached prefix keeps its cut, its graph and its batches; the
    text features' encoding keeps the kernels it launched and its classes."""
    from peft_vit_tpu_torch.engine import cached
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.ops import launch_counts

    rec = {"cells": 0, "rounds": 0, "losses": [], "sweep_s": 0.0, "final_s": 0.0,
           "quantize": 0, "prefix": [], "text": {}, "classes": 0}

    class Spy(run.SweepEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            rec["graphs"] = self.graphs
            for attr in ("_epoch_fn", "_epoch_cells"):
                def recorded(*a, epoch_fn=getattr(self, attr)):
                    state, loss = epoch_fn(*a)
                    rec["losses"].extend(float(v) for v in loss.reshape(-1))
                    return state, loss

                setattr(self, attr, recorded)

        def train_cells(self, lrs, *args, **kwargs):
            rec["cells"] += len(lrs)
            rec["rounds"] += 1
            return super().train_cells(lrs, *args, **kwargs)

        def sweep(self, task, end_epoch, grid=None):
            t0 = time.perf_counter()
            out = super().sweep(task, end_epoch, lr_grid or grid)
            sync()
            rec["sweep_s"] = time.perf_counter() - t0
            return out

        def train_final(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = super().train_final(*args, **kwargs)
            sync()
            rec["final_s"] = time.perf_counter() - t0
            return out

    def cast(model):
        real_cast(model)
        rec["model"] = model
        rec["frozen"] = {k: v.detach().clone() for k, v in model.named_parameters()
                         if not v.requires_grad}
        if hasattr(model, "text_features"):
            rec["text_bank"] = model.text_features.clone()

    def prefix(model, x, cut, batch, frozen=None, graphs=None):
        graphs = {}
        out = real_prefix(model, x, cut, batch, frozen, graphs)
        rec["prefix"].append((cut, graphs.get(("prefix", None, batch)), -(-len(x) // batch)))
        return out

    def text(encode_text, cfg, *args, **kwargs):
        before = launch_counts()
        feats = real_text(encode_text, cfg, *args, **kwargs)
        sync()
        for k, n in launch_counts().items():
            rec["text"][k] = rec["text"].get(k, 0) + n - before[k]
        rec["classes"] += len(feats)
        return feats

    def quantize(*args, **kwargs):
        tree = real_quantize(*args, **kwargs)
        rec["quantize"] += 1
        rec["qtree"] = tree
        rec["qtree_start"] = {k: v.clone() for k, v in tree.items()}
        return tree

    saved = run.SweepEngine, run.cast_frozen_, run.extract_text_features
    real_cast, real_quantize, real_text = run.cast_frozen_, i8.quantize_frozen_tree, saved[2]
    real_prefix = cached.precompute_prefix_tokens
    run.SweepEngine, run.cast_frozen_, run.extract_text_features = Spy, cast, text
    i8.quantize_frozen_tree, cached.precompute_prefix_tokens = quantize, prefix
    try:
        yield rec
    finally:
        run.SweepEngine, run.cast_frozen_, run.extract_text_features = saved
        i8.quantize_frozen_tree, cached.precompute_prefix_tokens = real_quantize, real_prefix


def _results_dir() -> str:
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    root.mkdir(parents=True, exist_ok=True)
    return tempfile.mkdtemp(dir=root)


def _replay_ms(graph, reps: int, trials: int = 5) -> float:
    """Median over trials of ``reps`` back-to-back replays of a
    ``StepGraph``'s CUDA graph, per replay (CUDA events)."""
    graph.graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def launch_rule(model, trainable, cells: int = 1, int8: bool = False,
                bwd_dx: bool = False, start_layer: int = 0, int8_attn: bool = False) -> dict:
    """The kernels one training step launches a replay, derived from where
    the trainable leaves (the names in ``trainable``) sit in ``model``
    (PERF.md §2), over the blocks from ``start_layer`` on (the cached-prefix
    sweep's suffix): K1 once a block (a round's cells ride the batch; with
    ``int8_attn`` and its scales the forward's attention is plain PyTorch,
    and K1 runs once in each block whose backward recomputes o and lse for
    K2 and K3); K2 and K3
    once in each block whose attention operands q, k, v need a gradient,
    that is where a trainable leaf sits in or before the block's attention
    products (the prompts, the tower's own leaves up to ``in_proj``, an
    attention delta, the shared qkv adapter, the probe block's own weights)
    or anywhere in an earlier block; K7 once in each block whose relative
    position table trains (the bias's gradient, which needs no q, k or v
    gradient: RPB's block 0 launches K7 and neither K2 nor K3); under
    ``int8`` K6 once a frozen GEMM forward (once a cell for a trainable
    weight, quantized per call) and, with ``bwd_dx``, once a frozen GEMM
    whose input needs a gradient.  KAdaptation's ``phmb`` is never read and
    an adapter that AdapterDrop skips never runs: neither makes anything
    need a gradient.  A CNN tower launches none of them, nor does ConvViT
    (its attention is plain PyTorch).  A Swin tower: K1 once a block; K2 and
    K3 once in each block whose q, k, v need a gradient (a trainable leaf in
    or before the block's ``in_proj``: the patch embedding, an earlier block
    or patch merging, the block's ``ln_1``, ``in_proj`` or LoRA deltas); K7
    once in each block whose table trains."""
    backbone, names = model.backbone, set(trainable)
    if hasattr(backbone, "stages"):  # Swin
        def trains_any(prefix: str, *skip: str) -> bool:
            return any(n.startswith(prefix) and not n.startswith(skip) for n in names)

        carry = trains_any("backbone.patch_embed.") or trains_any("backbone.pos_norm.") or (
            "backbone.absolute_pos_embed" in names)
        k1 = k23 = k7 = 0
        for block_names, merge in backbone.stages:
            for name in block_names:
                p = f"backbone.{name}."
                table = trains_any(p + "attn.relative_position_bias_table")
                attn = carry or trains_any(p + "ln_1.") or trains_any(
                    p + "attn.", p + "attn.out_proj.", p + "attn.relative_position_bias_table")
                k1, k23, k7 = k1 + 1, k23 + attn, k7 + table
                carry = carry or trains_any(p)
            if merge is not None:
                carry = carry or trains_any(f"backbone.{merge}.")
        return {"flash_attention_fwd": k1, "flash_attention_bwd_dq": k23,
                "flash_attention_bwd_dkv": k23, "attention_bias_grad": k7}
    if getattr(backbone, "style", None) is None:
        # a CNN tower (the ResNet family): convolutions, pools and BN are
        # library calls, and its attention pool is plain PyTorch; ConvViT's
        # attention is plain PyTorch too; K1-K7 never run
        out = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
               "flash_attention_bwd_dkv": 0, "attention_bias_grad": 0}
        if int8:
            out["int8_gemm_dynamic"] = 0
        return out

    def trains(prefix: str, *skip: str) -> bool:
        return any(n.startswith(prefix) and not n.startswith(skip) for n in names)

    carry = any(n.startswith("backbone.") and not n.startswith((
        "backbone.blocks.", "backbone.ln_post.", "backbone.proj",
        "backbone.deep_prompt_embeddings")) for n in names)
    k23 = k7 = fwd = dx = 0
    for i, block in enumerate(backbone.blocks):
        if i < start_layer:
            continue
        p = f"backbone.blocks.{i}."
        if 0 < i < backbone.layers and "backbone.deep_prompt_embeddings" in names:
            carry = True
        ln1 = trains(p + "ln_1.")
        table = trains(p + "attn.relative_position_bias_table")
        attn = carry or ln1 or trains(p + "attn.", p + "attn.get_v.", p + "attn.out_proj.",
                                      p + "attn.phmb", p + "attn.relative_position_bias_table")
        k23 += attn
        k7 += table
        x1 = carry or attn or table or trains(p + "attn.get_v.") or trains(p + "attn.out_proj.")
        fc_in = x1 or trains(p + "ln_2.")
        proj_in = fc_in or trains(p + "mlp.c_fc.")
        for gemm, needs in (("attn.in_proj", carry or ln1),
                            ("attn.out_proj", attn or table or trains(p + "attn.get_v.")),
                            ("mlp.c_fc", fc_in), ("mlp.c_proj", proj_in)):
            frozen = f"{p}{gemm}.weight" not in names
            fwd += 1 if frozen else cells
            dx += bool(needs and frozen)
        carry = proj_in or trains(p + "mlp.c_proj.") or (
            block.adapter_name is not None and trains(f"{p}{block.adapter_name}."))
    blocks = len(backbone.blocks) - start_layer
    out = {"flash_attention_fwd": k23 if int8_attn else blocks, "flash_attention_bwd_dq": k23,
           "flash_attention_bwd_dkv": k23, "attention_bias_grad": k7}
    if int8:
        out["int8_gemm_dynamic"] = fwd + (dx if bwd_dx else 0)
    return out


def drive(label: str, cfg, tree, smi: str, device: str = "cuda", want_cells: int = 0,
          profile: bool = False, lr_grid=None) -> dict:
    """``commands.run.finetune_main(cfg)`` through the port on ``device`` from
    the numpy weights ``tree`` (``lr_grid``: the sweep's lrs), observed by
    ``driver_spy``: the sweep's cells (``want_cells``), every step and eval
    batch one replay of a graph of its shape, each graph's launches a replay
    the mask-derived ones (``launch_rule``, from the cut of a cached prefix,
    whose batches are replays of a graph of K1 once a block before the cut),
    the text features' K1 once a text block and class and no K7, finite
    losses, frozen leaves, a contrastive model's class-text bank and the
    quantized tree bit-identical, the score in results.jsonl; then, with
    ``profile``, the same run under the profiler."""
    from peft_vit_tpu_torch.commands import run
    from peft_vit_tpu_torch.data import construct_splits
    from peft_vit_tpu_torch.engine import StepGraph
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    on_card = device == "cuda"
    splits = construct_splits(cfg)
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    n_tr, n_va, n_te = len(splits.y_train), len(splits.y_val), len(splits.y_test)
    out_dir = _results_dir()
    _zero_attention_counts(attn)
    for w in (i8.int8_gemm_dynamic, i8.int8_gemm_static):
        w.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with driver_spy(run, sync, lr_grid) as rec:  # counts from 0 just before the path, read just after
        t0 = time.perf_counter()
        score = run.finetune_main(cfg, out_dir, device=device, variables=tree)
        sync()
        wall = time.perf_counter() - t0
    counts = _attention_counts(attn)
    k6 = {"dynamic": i8.int8_gemm_dynamic.launches, "static": i8.int8_gemm_static.launches}
    record = json.loads(open(f"{out_dir}/results.jsonl").read().splitlines()[-1])
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")

    nb = lambda n: -(-n // batch)
    epochs = int(cfg.TRAIN.END_EPOCH)
    final_epochs = epochs + int(cfg.TRAIN.EXTRA_FINAL_TRAIN_EPOCH)
    # every step and eval batch is one replay of a graph of its shape
    steps = rec["rounds"] * epochs * nb(n_tr) + final_epochs * nb(n_tr + n_va)
    evals = rec["rounds"] * epochs * nb(n_va) + (final_epochs + 1) * nb(n_te)
    print(f"driver {label}: {n_tr} train, {n_va} val, {n_te} test images; {rec['cells']} "
          f"cells in {rec['rounds']} rounds x {epochs} epochs, final train {final_epochs} "
          f"epochs; {steps} steps, {evals} eval batches of {batch}, each a replay; "
          f"graphs {sorted(rec['graphs'], key=str)}")
    check(rec["cells"] == want_cells, f"driver {label}: {rec['cells']} sweep cells == "
          f"{want_cells}")
    # a sweep cell may diverge (lr 0.1 at wd 1e6): the protocol scores it 0
    final_losses = rec["losses"][-final_epochs:]
    diverged = sum(not math.isfinite(x) for x in rec["losses"][:-final_epochs])
    check(len(rec["losses"]) == rec["cells"] * epochs + final_epochs
          and all(math.isfinite(x) for x in final_losses),
          f"driver {label}: {len(rec['losses'])} epoch losses; the final train's "
          f"{final_epochs} all finite (" + " ".join(f"{x:.4f}" for x in final_losses[:4])
          + f" ... {final_losses[-1]:.4f}); {diverged} sweep-cell epochs not finite")
    model = rec["model"]
    trainable = [k for k, v in model.named_parameters() if v.requires_grad]
    int8_on = bool(cfg.TPU.get("INT8_FWD_TRAIN", False))
    bwd_dx = bool(cfg.TPU.get("INT8_BWD_DX", False))
    graphs = rec["graphs"]
    replays = {kind: sum(g.replays for key, g in graphs.items() if key[0] == kind)
               for kind in ("step", "eval")}
    check(replays == {"step": steps, "eval": evals} and (not on_card or graphs),
          f"driver {label}: {replays['step']} step replays == {steps}, {replays['eval']} "
          f"eval replays == {evals}")
    cut = rec["prefix"][0][0] if rec["prefix"] else 0
    for key, graph in sorted(graphs.items(), key=str):
        # an eval batch launches the forward's kernels: K1 and K6 without dx
        want = launch_rule(model, trainable, key[1] or 1, int8_on, bwd_dx and key[0] == "step",
                           start_layer=cut)
        if key[0] == "eval":
            for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                         "attention_bias_grad"):
                want.pop(name)
        _per_replay(graph, {k: v for k, v in want.items() if v},
                    f"driver {label}: {key[0]} graph of {key[1] or 1} cell(s)"
                    + (f" from block {cut}" if cut else ""))
    prefix_graphs = [g for _, g, _ in rec["prefix"]]
    for pcut, graph, batches in rec["prefix"]:
        _per_replay(graph, {"flash_attention_fwd": pcut},
                    f"driver {label}: a cached-prefix batch (blocks 0-{pcut - 1})")
        check(graph is None or graph.replays == batches,
              f"driver {label}: the prefix through block {pcut - 1} once: "
              f"{None if graph is None else graph.replays} replays == {batches} batches")
    if rec["prefix"]:
        print(f"driver {label}: cached prefix at block {cut}, "
              f"{sum(b for _, _, b in rec['prefix'])} prefix batches over "
              f"{len(rec['prefix'])} splits")
    text_layers = int(cfg.MODEL.SPEC.TEXT.LAYERS)
    if rec["classes"]:
        got = {k: n for k, n in rec["text"].items() if n}
        check(got == ({"flash_attention_fwd": text_layers * rec["classes"]} if on_card else {}),
              f"driver {label}: the text features of {rec['classes']} classes launched {got} "
              f"(K1 once a text block and class, no K7)")
    want = {name: (StepGraph.WARMUP + 1) * sum(g.launches[name] for g in graphs.values())
            + (StepGraph.WARMUP + 1) * sum(g.launches[name] for g in prefix_graphs if g)
            + rec["text"].get(name, 0) for name in counts}
    for name, n in counts.items():
        check(n == want[name] and (not on_card or n > 0 or want[name] == 0),
              f"driver {label}: {name} counted {n} == ({StepGraph.WARMUP} warm-up runs + "
              f"the capture) x its launches a replay, over {len(graphs)} graphs"
              + (f" and {len(prefix_graphs)} prefix graphs" if prefix_graphs else "")
              + (" + the text features'" if rec["classes"] else ""))
    if "text_bank" in rec:
        check(torch.equal(rec["text_bank"], model.text_features),
              f"driver {label}: the frozen class-text bank {tuple(model.text_features.shape)} "
              "bit-identical after the run")
    same = [k for k, v in rec["frozen"].items()
            if torch.equal(v, dict(model.named_parameters())[k])]
    # finetune_contrast trains every leaf of the tower: its frozen part is the
    # class-text bank, held below
    check(len(same) == len(rec["frozen"]) and (len(same) > 0 or "text_bank" in rec),
          f"driver {label}: {len(same)} of {len(rec['frozen'])} frozen leaves bit-identical "
          "after the run")
    want_k6 = (StepGraph.WARMUP + 1) * sum(g.launches.get("int8_gemm_dynamic", 0)
                                           for g in graphs.values())
    check(rec["quantize"] == (1 if int8_on else 0) and k6["dynamic"] == want_k6
          and (want_k6 > 0 or not int8_on or not on_card) and k6["static"] == 0,
          f"driver {label}: quantize_frozen_tree called {rec['quantize']} time(s); "
          f"int8_gemm_dynamic counted {k6['dynamic']} == ({StepGraph.WARMUP} + 1) x its "
          f"launches a replay over {len(graphs)} graphs = {want_k6}, int8_gemm_static "
          f"{k6['static']}")
    if int8_on:
        same = [k for k, v in rec["qtree"].items() if torch.equal(v, rec["qtree_start"][k])]
        check(len(same) == len(rec["qtree"]) > 0,
              f"driver {label}: the shared quantized tree ({len(same)} of "
              f"{len(rec['qtree'])} tensors) bit-identical after the run")
    check(math.isfinite(score) and 0.0 <= score <= 100.0 and record["score"] == score,
          f"driver {label}: score {score:.3f} written to results.jsonl")
    print(f"driver {label}: chose lr {record['lr']:g}, wd {record['wd']:g}; test "
          f"{record['metric']} {score:.3f}; sweep {rec['sweep_s']:.2f} s, final train "
          f"{rec['final_s']:.2f} s, whole run {wall:.2f} s; peak device memory {peak:.2f} GiB "
          f"(host clock; {smi})", flush=True)
    step_ms = None
    final = graphs.get(("step", None, batch))
    if on_card and final is not None:
        # the final train's captured one-cell step, replayed on its last
        # batch: the device's time for a step of this run (the run is done)
        step_ms = _replay_ms(final, 20)
        print(f"driver {label}: the captured one-cell step replays in {step_ms:.3f} ms "
              f"(CUDA events, 20 replays; {smi})", flush=True)
    result = {"launches": counts, "int8_launches": k6, "steps": steps, "cut": cut,
              "step_ms": step_ms,
              "text_launches": dict(rec["text"]), "graphs": {
                  f"{k[0]} {k[1] or 1}": dict(g.launches) for k, g in graphs.items()},
              "evals": evals, "cells": rec["cells"], "lr": record["lr"],
              "wd": record["wd"], "score": score, "sweep_s": rec["sweep_s"],
              "final_s": rec["final_s"], "wall_s": wall, "peak_gib": peak}
    del rec, graphs, model
    if on_card and profile:
        # the same run again under the profiler: the device's busy time and
        # idle share of the whole run (the profiler's cost in the wall time)
        with driver_spy(run, sync):
            t0 = []
            busy, n_launches, top = _device_breakdown(
                lambda: t0.append(time.perf_counter()) or run.finetune_main(
                    cfg, _results_dir(), device=device, variables=tree), reps=1, host=False)
            profiled = time.perf_counter() - t0[0]
        if busy is None:
            print(f"driver {label} profile: device time not measured")
        else:
            print(f"driver {label} profile: device busy {busy / 1e3:.3f} s in "
                  f"{n_launches:.0f} launches, idle share "
                  f"{max(0.0, 1.0 - busy / 1e3 / wall):.3f} of the unprofiled run's "
                  f"{wall:.2f} s (model build and data included; the profiled run took "
                  f"{profiled:.2f} s); top: "
                  + "; ".join(f"{k} {t:.1f} ms" for k, t in top))
    return result


def driver_phase(smi: str, device: str = "cuda", tree=None) -> dict:
    """``commands.run.finetune_main`` through the port on the card: the bf16
    sweep of 18 cells and the final train at full ViT-B/16 width, from the
    numpy weights of ``jax_layout_tree``; then the int8 drive
    (``TPU.INT8_FWD_TRAIN``, ``TRAIN.NO_TUNING``) with its one shared
    quantized tree; then the card-vs-CPU check at the tiny size.  ``device``
    "cpu" (with ``tree`` and the constants shrunk) rehearses the phase's
    code, where no kernel launches."""
    if tree is None:
        tree = jax_layout_tree(np.random.RandomState(SEED + 8), DRIVER["DATASET.NUM_CLASSES"])
    result = {
        "bf16 sweep": drive("bf16 sweep", driver_cfg({**DRIVER, **FLAGSHIP_DEPTH}), tree, smi,
                            device, DRIVER_CELLS, profile=True),
        "int8": drive("int8", driver_cfg({**DRIVER, **FLAGSHIP_DEPTH, "TPU.INT8_FWD_TRAIN": True,
                                          "TRAIN.NO_TUNING": True}), tree, smi, device),
    }
    tiny_driver_check(device)
    return result


# The PEFT methods beside LoRA, each at ViT-B/16 (vitb16_CLIP.yaml: width 768,
# 12 blocks, 12 heads, N = 197, 207 with the prompts), 100 classes, channel
# BN, bf16 compute with fp32 masters, at the config's defaults: adapter dim
# 64, Compacter 32 / 4 at reduction 12, 10 prompts, AdapterDrop on block 11.
# KAdaptation at phm_dim 4, rank 1: the default, the reference's 768, is a
# (768, 768, 768) fp32 rule of 1.8 GB a block (PERF.md §4).
METHODS = (
    ("kadaptation", {"PEFT.METHOD": "kadaptation", "PEFT.PHM_DIM": 4, "PEFT.PHM_RANK": 1}),
    ("adapter", {"PEFT.METHOD": "adapter"}),
    ("adapterdrop", {"PEFT.METHOD": "adapterdrop"}),
    ("compacter", {"PEFT.METHOD": "compacter"}),
    ("lora_fix_one", {"PEFT.METHOD": "lora_fix_one"}),
    ("lora_moe", {"PEFT.METHOD": "lora_moe"}),
    ("lora_adapter", {"PEFT.METHOD": "lora_adapter"}),
    ("lora_compacter", {"PEFT.METHOD": "lora_compacter"}),
    ("lora_drop_adapter", {"PEFT.METHOD": "lora_drop_adapter"}),
    ("lepe", {"PEFT.METHOD": "lepe"}),
    ("vpt", {"PEFT.METHOD": "vpt"}),
    ("vpt_deep", {"PEFT.METHOD": "vpt", "PEFT.PROMPT_DEEP": True}),
    ("transformer_probe", {"PEFT.METHOD": "transformer_probe"}),
)
METHOD_OVERRIDES = dict(METHODS)
# A method's bf16 update with K2 and K3 against the same step with their plain
# versions: both round dq, dk and dv to bf16, at other points, and where a
# leaf's gradient is a sum over every token that cancels (the adapters'
# LayerNorm scales, Compacter's rules, the prompts) that rounding moves it by
# percents.  Measured on the H100 (this phase, NVIDIA H100 80GB HBM3, 700 W)
# against the float64 backward (dq, dk, dv from the same operands, rounded
# once): on the adapter's block-1 LayerNorm scale the kernels stand at cosine
# 0.988 from it and the plain versions at 0.994, on VPT's prompts at 0.982
# both, so kernel against plain is 0.986 there.  The per-leaf cosine 0.999 of
# the LoRA path holds no kernel here; what is held is that the kernels round
# no worse than the plain versions: over a round's (cell, leaf) pairs the
# mean of 1 - cosine against the float64 backward at most twice the plain
# versions' (+ 1e-4, where both stand at 1; measured: 0.83-1.03 times it).
TOL_METHOD_EXACT_RATIO = 2.0
TOL_METHOD_EXACT_FLOOR = 1e-4
METHODS_INT8 = ("kadaptation", "adapter")  # also under INT8_FWD_TRAIN + INT8_BWD_DX
METHOD_BUCKET = 8  # the serving bucket of the 5-image request
# config overrides of the methods' and tower methods' model: ViT-B/16 cut to 2
# of its 12 blocks for the script's time (6, then 3, until the script passed
# 1,200 s on a slow host), AdapterDrop on the last (a CPU rehearsal shrinks it
# here)
METHOD_DEPTH = 2
METHOD_MODEL: dict = {"MODEL.SPEC.VISION.LAYERS": METHOD_DEPTH,
                      "PEFT.ADAPTER_LAYERS": [METHOD_DEPTH - 1]}


def _leaves_of(tree: dict, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves_of(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def method_tree(model, rng: np.random.RandomState) -> dict:
    """``model``'s parameters and BN statistics as a JAX-layout tree
    (``params_to_jax``), every leaf redrawn from ``rng`` and none of them
    zero: kernels at 1 / sqrt(fan in), LoRA's A and B and the MoE gates at
    0.02, the adapters' down and up at half the kernels' scale, PHM weights
    and rules, KAdaptation factors, LePE's conv and the prompts at scales
    where each hook moves the logits, so that a broken hook shows."""
    from peft_vit_tpu_torch.models import params_to_jax

    tree = params_to_jax(model.state_dict())
    for path, arr in list(_leaves_of(tree)):
        module, leaf, shape = path[-2], path[-1], arr.shape
        normal = rng.standard_normal(shape)
        if leaf == "bn_var":
            x = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bn_mean":
            x = 0.1 * normal
        elif leaf == "scale":
            x = 1.0 + 0.1 * normal
        elif leaf in ("bias", "b", "phmb"):
            x = 0.02 * normal
        elif leaf == "kernel" and module.endswith(("_adapter1", "_adapter2")):
            x = 0.02 * normal
        elif leaf == "kernel" and module in ("down", "up"):
            x = 0.5 * normal / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "kernel" and module == "get_v":
            x = 0.1 * normal
        elif leaf == "kernel" or leaf == "proj":
            x = normal / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "W":  # PHM: H = sum_i rule_i (x) W_i near 0.5 / sqrt(fan in)
            x = normal / (shape[0] * np.sqrt(shape[1]))
        elif leaf == "phm_rule":
            x = 0.5 * normal
        elif leaf.startswith(("W_left", "W_right")):
            x = 0.1 * normal
        elif leaf in ("prompt_embeddings", "deep_prompt_embeddings"):
            x = 0.5 * normal
        elif leaf == "relative_position_bias_table":  # a bias of about the scores' size
            x = 0.5 * normal
        elif leaf == "class_embedding":
            x = normal / np.sqrt(shape[0])
        elif leaf == "positional_embedding":
            x = 0.1 * normal
        else:
            raise ValueError(f"no draw for {'/'.join(path)}")
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[leaf] = x.astype(np.float32)
    return tree


def serve_method(label: str, over: dict, rng: np.random.RandomState, images: np.ndarray,
                 device: str = "cuda"):
    """The method of the config overrides ``over`` at ViT-B/16, its weights
    drawn by ``method_tree`` from ``rng``, a prototype head over ``images``:
    the request through ``ServingSession`` (bucket ``METHOD_BUCKET``,
    captured) against the fp32 CPU forward (top-1 and the bf16 bound) and
    against the same bucket run eagerly (bit for bit), the bucket's launches
    a replay.  Returns (the tree, the drift)."""
    from peft_vit_tpu_torch.engine import ServingSession
    from peft_vit_tpu_torch.models import build_image_classifier, load_jax_variables
    from peft_vit_tpu_torch.models import params_from_jax
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = driver_cfg({**METHOD_MODEL, **over})
    spec = spec_from_config(cfg)

    def build(dev):
        return build_image_classifier(cfg, spec, NUM_CLASSES, use_bn=True, device=dev)[0]

    t0 = time.perf_counter()
    cpu = build("cpu").eval()
    tree = method_tree(cpu, rng)
    load_jax_variables(cpu, tree)
    with torch.no_grad():
        feats = cpu.backbone(torch.from_numpy(images))
    prototype_head(tree, feats.numpy())
    load_jax_variables(cpu, tree)
    with torch.no_grad():
        cpu_logits = cpu.classifier(feats).numpy()
    del cpu
    cpu_s = time.perf_counter() - t0

    served = build(device)
    blocks = len(served.backbone.blocks)
    _zero_attention_counts(attn)  # counts from 0 just before the main path, read just after
    session = ServingSession(served, params_from_jax(tree), IMAGE, buckets=(METHOD_BUCKET,),
                             device=device)
    got = session.predict(images)
    counted = attn.flash_attention_fwd.launches
    graph = session._graphs.get(METHOD_BUCKET)
    _per_replay(graph, {"flash_attention_fwd": blocks}, f"methods {label}: serving bucket")
    padded = torch.zeros((METHOD_BUCKET, IMAGE, IMAGE, 3))
    padded[:CHECKED_REQUEST] = torch.from_numpy(images)
    eager = session._infer(padded.to(device))[:CHECKED_REQUEST].float().cpu().numpy()
    rel = _rel(got, cpu_logits)
    check(got.shape == (CHECKED_REQUEST, NUM_CLASSES) and bool(np.isfinite(got).all())
          and np.array_equal(got, eager),
          f"methods {label}: serving, {CHECKED_REQUEST} images through the captured bucket "
          f"of {METHOD_BUCKET}: finite, equal bit for bit to the bucket run eagerly; "
          f"flash_attn_fwd counted {counted} (warm-up and capture of {blocks} blocks)")
    check(bool((got.argmax(1) == cpu_logits.argmax(1)).all()) and rel <= TOL_BF16_LOGITS_REL,
          f"methods {label}: serving top-1 {got.argmax(1).tolist()} == fp32 CPU "
          f"{cpu_logits.argmax(1).tolist()}; max |logit diff| / max |logit| = {rel:.4e} <= "
          f"{TOL_BF16_LOGITS_REL:g} (CPU reference {cpu_s:.1f} s)")
    return tree, rel


def methods_phase(smi: str, device: str = "cuda") -> dict:
    """Each PEFT method of ``METHODS`` through the port's entry points at
    ViT-B/16: ``build_image_classifier`` from the yaml and the method's
    config, the weights of ``method_tree``; a 5-image request through
    ``ServingSession`` (bucket 8, captured) against the fp32 CPU forward
    (top-1 with a prototype head, the bf16 bound) and against the same bucket
    run eagerly (bit for bit); a captured round of 3 cells
    (``method_round``); then KAdaptation's driver sweep and the int8
    AdapterDrop drive (``drive``).  ``device`` "cpu" (with ``METHOD_MODEL``
    and ``IMAGE`` shrunk, ``StepGraph`` rehearsed) runs the phase's code,
    where the launch checks fail."""
    import bench_torch
    from peft_vit_tpu_torch.engine import step_decay_lr
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    rng = np.random.RandomState(SEED + 20)
    images = rng.standard_normal((CHECKED_REQUEST, IMAGE, IMAGE, 3)).astype(np.float32)
    raw = rng.randint(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    data = (bench_torch.normalize(torch.as_tensor(raw, device=device), torch.float32),
            torch.as_tensor(rng.randint(0, NUM_CLASSES, TRAIN_BATCH), device=device),
            torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device), np.arange(TRAIN_BATCH),
            step_decay_lr(ROUND_LRS, 0, ()), torch.tensor(ROUND_WDS))
    result = {}
    for label, over in METHODS:
        tree, rel = serve_method(label, over, rng, images, device)
        row = {"serving_rel": rel, "round": method_round(label, over, tree, data, smi, device)}
        if label in METHODS_INT8:
            row["int8"] = method_round(label, over, tree, data, smi, device, int8=True)
        result[label] = row
        if device == "cuda":
            torch.cuda.empty_cache()

    # the paper's method through the whole driver, and AdapterDrop's int8 drive
    for label, over, extra, cells in (
            ("kadaptation sweep", METHOD_OVERRIDES["kadaptation"], {}, DRIVER_CELLS),
            ("adapterdrop int8", METHOD_OVERRIDES["adapterdrop"],
             {"TPU.INT8_FWD_TRAIN": True, "TRAIN.NO_TUNING": True,
              "TRAIN.CACHE_FROZEN_PREFIX": False}, 0)):
        cfg = driver_cfg({**DRIVER, **METHOD_MODEL, **over, **extra})
        model = build_image_classifier(cfg, spec_from_config(cfg),
                                       int(cfg.DATASET.NUM_CLASSES), use_bn=True,
                                       device="cpu")[0]
        tree = method_tree(model, np.random.RandomState(SEED + 22))
        del model
        result[label] = drive(label, cfg, tree, smi, device, cells)
    return result


def method_round(label: str, over: dict, tree: dict, data, smi: str, device: str = "cuda",
                 int8: bool = False, tower: bool = False, exact: bool = True) -> dict:
    """A round of 3 cells of ``label`` (the config overrides ``over``, the
    weights ``tree``), one captured step at B=16 through
    ``make_epoch_fn(cells=True)``: the launches a replay against the
    mask-derived ``launch_rule``; the captured step equal bit for bit to the
    same step run eagerly; the update with K2/K3 (and K7) against the float64
    backward, no farther than the plain versions' (``TOL_METHOD_EXACT_RATIO``;
    ``exact`` False: not run) or, under ``int8`` (``INT8_FWD_TRAIN`` +
    ``INT8_BWD_DX``), with the plain int8 GEMM in K6's place, equal bit for
    bit; the round's peak memory; with ``tower`` (a method whose trainable
    leaves are the pretrained tower's), the frozen remainder bit-identical
    after the runs and a one-cell round's first step against the one-cell
    step (``tower_one_cell``); then, in bf16, the captured one-cell step's
    rate, device busy time and launches."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn)
    from peft_vit_tpu_torch.models import build_image_classifier, cast_frozen_, load_jax_variables
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.engine import StepGraph
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    name = f"methods {label}" + (" int8" if int8 else "")
    cfg = driver_cfg({**METHOD_MODEL, **over, **(
        {"TPU.INT8_FWD_TRAIN": True, "TPU.INT8_BWD_DX": True} if int8 else {})})
    spec = spec_from_config(cfg)
    model = build_image_classifier(cfg, spec, NUM_CLASSES, use_bn=True, device=device)[0]
    load_jax_variables(model, tree)
    mask = build_mask(model, spec.method, num_layers=model.backbone.layers,
                      train_head=bool(cfg.PEFT.TRAIN_HEAD),
                      extra_regex=str(cfg.PEFT.TRAINABLE_REGEX),
                      adapter_layers=spec.adapter_layers)
    trainable, frozen = split_params(model, mask)
    qtree = i8.quantize_frozen_tree(frozen, bwd_dx=True) if int8 else {}
    cast_frozen_(model)
    apply_fn = make_apply_fn(model)
    bn = {k: v for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    k = len(ROUND_LRS)
    crng = np.random.RandomState(SEED + 21)
    # each cell's leaves: the tree's, each element scaled by 1 + N(0, 0.1^2)
    draws = [{n: v.detach() * (1.0 + 0.1 * torch.from_numpy(crng.standard_normal(
        tuple(v.shape)).astype(np.float32)).to(v.device)) for n, v in trainable.items()}
        for _ in range(k)]
    start = {n: torch.stack([d[n] for d in draws]) for n in draws[0]}
    state = init_cell_state(start, {n: v.expand(k, *v.shape) for n, v in bn.items()})
    x, y, valid, perm, lrs, wds = data
    graphs = {}
    epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True,
                          graphs=graphs)
    run = lambda: epoch(state, qtree, x, y, valid, perm, lrs, wds)
    frozen_start = {n: p.detach().clone() for n, p in model.named_parameters()
                    if not p.requires_grad} if tower else {}
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if on_card else 0
    before = launch_counts()  # counts from 0 just before the main path, read just after
    captured, loss = run()
    sync()
    counts = {n: c - before[n] for n, c in launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    with bench_torch.eager_on_card():
        eager, eager_loss = run()
    parts = ("trainable", "momentum", "bn")
    differ = [f"{part}.{n}" for part in parts for n, v in getattr(eager, part).items()
              if not torch.equal(v, getattr(captured, part)[n])]
    check(not differ and torch.equal(loss, eager_loss) and bool(loss.isfinite().all()),
          f"{name}: a round of {k} cells, one step at B={TRAIN_BATCH}, captured == eager bit for "
          f"bit ({len(trainable)} trainable leaves x 3 parts, losses " + " ".join(
              f"{float(v):.4f}" for v in loss) + ")" + (f"; differ: {differ[:4]}" if differ else ""))
    graph = graphs.get(("step", k, TRAIN_BATCH))
    want = launch_rule(model, trainable, k, int8, bwd_dx=int8)
    _per_replay(graph, {n: c for n, c in want.items() if c},
                f"{name}: one step of a round of {k} (mask-derived {want})")
    if graph is not None:
        wanted = {n: (StepGraph.WARMUP + 1) * graph.launches[n] for n in counts}
        check(counts == wanted, f"{name}: the wrappers counted {counts} == ({StepGraph.WARMUP} "
              "warm-up steps + the capture) x the launches a replay")
    plain = None
    if int8:
        with bench_torch.eager_on_card(), plain_int8(i8):
            plain, _ = run()
        same = [f"{part}.{n}" for part in parts for n, v in getattr(plain, part).items()
                if torch.equal(v, getattr(captured, part)[n])]
        total = sum(len(getattr(plain, part)) for part in parts)
        check(len(same) == total, f"{name}: the step with K6 == the same step with its plain "
              f"version bit for bit ({len(same)} of {total} state tensors)")
    elif exact:
        with bench_torch.eager_on_card(), plain_backward(attn):
            plain, _ = run()
        with bench_torch.eager_on_card(), exact_backward(attn):
            exact_run, _ = run()
        cos = {}  # (cell, leaf) -> cosines kernel~plain, kernel~exact, plain~exact
        for n, s0 in start.items():
            for c in range(k):
                u = [(r.trainable[n][c] - s0[c]).double().flatten()
                     for r in (captured, plain, exact_run)]
                cos[(c, n)] = tuple(
                    1.0 if torch.equal(a, b) else torch.nn.functional.cosine_similarity(
                        a, b, dim=0).item() for a, b in ((u[0], u[1]), (u[0], u[2]), (u[1], u[2])))
        least = min(cos, key=lambda key: cos[key][0])
        miss = {who: statistics.fmean(1.0 - v[i] for v in cos.values())
                for i, who in ((1, "kernel"), (2, "plain"))}
        check(miss["kernel"] <= TOL_METHOD_EXACT_RATIO * miss["plain"] + TOL_METHOD_EXACT_FLOOR,
              f"{name}: the update with K2/K3 against the same step with the float64 backward, "
              f"{len(cos)} (cell, leaf) pairs: mean 1 - cosine {miss['kernel']:.3e} <= "
              f"{TOL_METHOD_EXACT_RATIO:g} x the plain versions' {miss['plain']:.3e} + "
              f"{TOL_METHOD_EXACT_FLOOR:g}; against the plain versions least cosine "
              f"{cos[least][0]:.6f} (cell {least[0]}, {least[1]}: kernel~float64 "
              f"{cos[least][1]:.6f}, plain~float64 {cos[least][2]:.6f}), printed, not held")
        del exact_run
    del plain
    row = {"launches_per_replay": dict(graph.launches) if graph is not None else {},
           "want": want, "peak_round_gib": peak, "trainable": sum(
               v.numel() for v in trainable.values())}
    del graphs, graph, epoch, captured, eager
    if tower:
        tower_one_cell(name, apply_fn, draws[0], bn, qtree, data)
        same = [n for n, v in frozen_start.items()
                if torch.equal(v, dict(model.named_parameters())[n])]
        check(len(same) == len(frozen_start),
              f"{name}: {len(same)} of {len(frozen_start)} frozen leaves bit-identical after "
              "the round's runs")
    if int8 or not on_card:
        return row
    # the captured one-cell step, as bench_torch.py times it
    state1 = init_cell_state(draws[0], bn)
    step = bench_torch.make_epoch_step(apply_fn, has_bn=True)
    rates, _ = bench_torch.measure(step, state1, qtree, TRAIN_BATCH, TRAIN_K, 3, warmup=1,
                                   image=IMAGE, num_classes=NUM_CLASSES, device=device)
    rate = statistics.median(rates)
    step_ms = 1e3 * TRAIN_BATCH / rate
    xs = torch.as_tensor(np.random.RandomState(SEED + 11).randint(
        0, 256, (TRAIN_K, TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8), device=device)
    ys = torch.as_tensor(np.random.RandomState(SEED + 12).randint(
        0, NUM_CLASSES, (TRAIN_K, TRAIN_BATCH)), device=device)
    step(state1, qtree, xs, ys)  # the capture
    busy, n_launches, top = _device_breakdown(lambda: step(state1, qtree, xs, ys), reps=1)
    busy_ms = None if busy is None else busy / TRAIN_K
    per_step = None if n_launches is None else n_launches / TRAIN_K
    print(f"methods {label} step B={TRAIN_BATCH}: captured {rate:.1f} images/s ({step_ms:.3f} "
          f"ms/step, median of 3 windows of {TRAIN_K}), device busy "
          + ("not measured" if busy_ms is None else
             f"{busy_ms:.3f} ms/step in {per_step:.0f} launches (idle share "
             f"{max(0.0, 1.0 - busy_ms / step_ms):.3f})")
          + f"; kernels a replay {dict((n, c) for n, c in row['launches_per_replay'].items() if c)}"
          f"; round of {k} peak {peak:.2f} GiB; {row['trainable']} trainable; top: "
          + "; ".join(f"{n} {t / TRAIN_K:.3f} ms" for n, t in top) + f"; {smi}", flush=True)
    row.update(images_per_s=rate, step_ms=step_ms, busy_ms=busy_ms, launches_per_step=per_step)
    return row


# RPB and the six methods that train a subset of the pretrained tower (phase
# 11), each at ViT-B/16's width from vitb16_CLIP.yaml as the methods phase
# builds them (``METHOD_MODEL``); first_attention and first_mlp train block 1, so they run with
# TRAIN.CACHE_FROZEN_PREFIX False, as in the CPU tests.  attention and full
# also under INT8_FWD_TRAIN + INT8_BWD_DX; RPB and bitfit through the whole
# driver.
TOWER_METHODS = (
    ("rpb", {"PEFT.METHOD": "rpb"}),
    ("full", {"PEFT.METHOD": "full"}),
    ("bitfit", {"PEFT.METHOD": "bitfit"}),
    ("layernorm", {"PEFT.METHOD": "layernorm"}),
    ("attention", {"PEFT.METHOD": "attention"}),
    ("first_attention", {"PEFT.METHOD": "first_attention", "TRAIN.CACHE_FROZEN_PREFIX": False}),
    ("first_mlp", {"PEFT.METHOD": "first_mlp", "TRAIN.CACHE_FROZEN_PREFIX": False}),
)
TOWER_INT8 = ("attention", "full")
TOWER_DRIVES = ("rpb", "bitfit")
# Leaves whose gradient is zero in exact arithmetic: ln_post's bias only
# shifts every row's features (through proj) by one vector, which train-mode
# channel BN subtracts with the batch mean.  Their gradient is rounding
# alone, so no cosine holds them (tests/test_torch_port_tower_methods.py).
ZERO_GRAD = ("backbone.ln_post.bias",)


def tower_one_cell(name: str, apply_fn, draw: dict, bn: dict, qtree: dict, data) -> None:
    """A one-cell round's first step (``make_epoch_fn(cells=True)`` on a
    state stacked over one cell) against the one-cell step (``cells``
    False), eagerly on the card, bf16: per trainable leaf, the cosine of the
    two momentum buffers after the step (the gradient plus weight decay,
    which the fp32 masters do not round as they round an update of 1e-5 of
    themselves) at least ``TOL_ROUND_BF16_COS``, the round bound of the
    graph phase.  The leaves of ``ZERO_GRAD`` are printed, not held."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ce_per_example, init_cell_state, make_epoch_fn

    x, y, valid, perm, lrs, wds = data
    one = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True)
    round_fn = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True)
    with bench_torch.eager_on_card():
        alone, _ = one(init_cell_state(draw, bn), qtree, x, y, valid, perm, lrs[0], wds[0])
        stacked = init_cell_state({n: v[None] for n, v in draw.items()},
                                  {n: v[None] for n, v in bn.items()})
        cell, _ = round_fn(stacked, qtree, x, y, valid, perm, lrs[:1], wds[:1])
    cos = {n: torch.nn.functional.cosine_similarity(
        v.double().flatten(), cell.momentum[n][0].double().flatten(), dim=0).item()
        for n, v in alone.momentum.items()}
    held = {n: c for n, c in cos.items() if n not in ZERO_GRAD}
    least = min(held, key=held.get)
    check(held[least] >= TOL_ROUND_BF16_COS,
          f"{name}: a one-cell round's first step against the one-cell step, {len(held)} "
          f"leaves: least cosine of the momentum (gradient + wd p) {held[least]:.6f} "
          f"({least}) >= {TOL_ROUND_BF16_COS:g}; printed, not held: " + ", ".join(
              f"{n} {c:.4f}" for n, c in cos.items() if n in ZERO_GRAD))


def tower_phase(smi: str, device: str = "cuda") -> dict:
    """RPB and the six methods of ``TOWER_METHODS`` through the port's entry
    points at ViT-B/16: each served (``serve_method``) and trained as a
    captured round of 3 (``method_round`` with ``tower``: captured == eager,
    launches a replay from ``launch_rule`` with K7, the frozen remainder
    bit-identical, a one-cell round against the one-cell step; RPB's update
    also against the float64 backward, with K7 in it); ``TOWER_INT8`` under
    the int8 recipe with int8 dx; ``TOWER_DRIVES`` through the whole driver.
    ``device`` "cpu" rehearses the phase as ``methods_phase`` does."""
    import bench_torch
    from peft_vit_tpu_torch.engine import step_decay_lr
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    rng = np.random.RandomState(SEED + 40)
    images = rng.standard_normal((CHECKED_REQUEST, IMAGE, IMAGE, 3)).astype(np.float32)
    raw = rng.randint(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    data = (bench_torch.normalize(torch.as_tensor(raw, device=device), torch.float32),
            torch.as_tensor(rng.randint(0, NUM_CLASSES, TRAIN_BATCH), device=device),
            torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device), np.arange(TRAIN_BATCH),
            step_decay_lr(ROUND_LRS, 0, ()), torch.tensor(ROUND_WDS))
    result = {}
    t0 = time.perf_counter()
    for label, over in TOWER_METHODS:
        tree, rel = serve_method(label, over, rng, images, device)
        row = {"serving_rel": rel, "round": method_round(label, over, tree, data, smi, device,
                                                         tower=True, exact=label == "rpb")}
        if label in TOWER_INT8:
            row["int8"] = method_round(label, over, tree, data, smi, device, int8=True,
                                       tower=True)
        result[label] = row
        if device == "cuda":
            torch.cuda.empty_cache()
    for label in TOWER_DRIVES:
        over = dict(TOWER_METHODS)[label]
        cfg = driver_cfg({**DRIVER, **METHOD_MODEL, **over})
        model = build_image_classifier(cfg, spec_from_config(cfg),
                                       int(cfg.DATASET.NUM_CLASSES), use_bn=True,
                                       device="cpu")[0]
        tree = method_tree(model, np.random.RandomState(SEED + 42))
        del model
        result[f"{label} sweep"] = drive(f"{label} sweep", cfg, tree, smi, device, DRIVER_CELLS)
    print(f"tower phase: {time.perf_counter() - t0:.1f} s (host clock; {smi})", flush=True)
    return result


def tiny_driver_check(device: str = "cuda", over: dict = None, lrs=TINY_DRIVER_LRS,
                      label: str = "driver tiny fp32") -> tuple:
    """The tiny fp32 drive (``over``: the config, ``TINY_DRIVER``'s by
    default) with the lr grid ``lrs`` on ``device`` and on the CPU: the same
    weights (drawn on the CPU from the config's seed), data and cell draws,
    so both must choose the same (lr, wd) and score."""
    from peft_vit_tpu_torch.commands import run

    picks = {}
    for dev in ("cpu", device):
        cfg = driver_cfg({**(TINY_DRIVER if over is None else over), "TRAIN.NO_TUNING": False},
                         yaml_file=None)
        sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
        with driver_spy(run, sync, lr_grid=lrs) as rec:
            out_dir = _results_dir()
            score = run.finetune_main(cfg, out_dir, device=dev)
        record = json.loads(open(f"{out_dir}/results.jsonl").read().splitlines()[-1])
        picks[dev] = (record["lr"], record["wd"], score, rec["cells"])
    check(picks["cpu"] == picks[device],
          f"{label}: {device} chose (lr, wd, score, cells) {picks[device]} == cpu "
          f"{picks['cpu']}")
    return picks[device]


# ---------------------------------------------------------------------------
# Phase 12: zero-shot, the contrastive methods, the cached prefix, the
# logistic probe and int8 attention.  The CLIP text tower of vitb16_CLIP.yaml:
# width 512, 12 blocks of 8 heads (head dim 64), context 77, vocabulary 49,408
# (a CPU rehearsal shrinks them here).
TEXT_WIDTH, TEXT_LAYERS, TEXT_HEADS, CONTEXT, VOCAB = 512, 12, 8, 77, 49408
ZS_DATASET = "cifar-100"  # the class names and templates of the text-feature check
ZS_CPU_CLASSES = 8  # of them also on the CPU in fp32 (all 100 take ~45 s there)
ZS_CLASSES = 5  # the synthetic task of the zero-shot, contrastive and probe drives
ZS_TEST_BATCH = 16  # TEST.BATCH_SIZE_PER_GPU of those drives: the training batch
ZS = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": ZS_CLASSES,
      "DATASET.NUM_SAMPLES_PER_CLASS": 4, "TRAIN.BATCH_SIZE_PER_GPU": 16,
      "TEST.BATCH_SIZE_PER_GPU": ZS_TEST_BATCH, "TRAIN.END_EPOCH": 2,
      "TRAIN.SEARCH_WD_POINTS": 3, "TRAIN.SEARCH_WD_INIT_POINTS": 3,
      "TRAIN.EXTRA_FINAL_TRAIN_EPOCH": DRIVE_EXTRA_FINAL_EPOCHS}
LOGISTIC_CLASSES = 2  # the logistic drive's task: its CPU run extracts 48 images' features
ZS_LRS = (1e-3,)  # the contrastive drives' sweep: one round of 3 (lr, wd) cells
# The cached-prefix drives, each against the same drive through the whole
# tower: two lrs, the wd grid up to 1e-2 (lr x wd near 1 makes a cell chaotic
# from step to step, and two fp32 paths whose sums differ in the last bit
# then part).
ZS_CACHED = {"TRAIN.SEARCH_WD_LOG_UPPER": -2}
ZS_CACHED_LRS = (1e-3, 1e-2)
ZS_MODEL: dict = FLAGSHIP_DEPTH  # config overrides of the model (a CPU rehearsal shrinks it here)
# The text features in bf16 on the card against fp32 on the CPU, per class:
# cosine of the two L2-normalized features.  bf16 rounds every GEMM output
# and residual add of 12 random-weight blocks at ~4e-3 (the image tower's
# logits stand 6.9e-2 from fp32, TOL_BF16_LOGITS_REL); a class's feature is
# the mean of 18 templates' normalized features, which averages part of it.
TOL_TEXT_COS = 0.99
# int8 attention (static recipe with int8 dx) against the bf16 recipe after
# one step from the same state and batch, per LoRA leaf: cosine of the two
# updates.  The int8 forward (every GEMM and the scores on codes) moves the
# logits by ~1e-1 of their size on this random-weight tower
# (TOL_INT8_VS_BF16_LOGITS_REL), and bf16 alone turns a leaf's gradient to
# cosine 0.63 of the fp32 one (TOL_BF16_TRAIN_UPDATE_COS_LEAST).  Measured on
# the H100 (NVIDIA H100 80GB HBM3, 700.00 W): median over the 50 leaves 0.235
# (+ P V: 0.260) against bf16, 0.240 (0.209) against the static recipe
# without int8 attention, whose own against bf16 is printed beside them.  A
# leaf's update is a vector of ~3,000 entries, so two unrelated ones stand at
# cosine ~0.02: the bound 0.1 holds the gradient's direction, no more.
TOL_INT8_ATTN_UPDATE_COS_MEDIAN = 0.1
INT8_ATTN_RECIPES = (("int8 static+dx+attn", False), ("int8 static+dx+attn+pv", True))


def text_tree(rng: np.random.RandomState) -> dict:
    """Random text-tower weights in the JAX package's layout (the names of a
    flax ``TextTransformer`` init), as ``{"params": ...}``."""

    def normal(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o, std=i**-0.5), "bias": normal(o, std=0.02)}

    def layer_norm():
        return {"scale": 1.0 + normal(TEXT_WIDTH, std=0.1),
                "bias": normal(TEXT_WIDTH, std=0.02)}

    w = TEXT_WIDTH
    params = {"token_embedding": {"embedding": normal(VOCAB, w, std=0.02)},
              "positional_embedding": normal(CONTEXT, w, std=0.01),
              "ln_final": layer_norm(), "text_projection": normal(w, OUTPUT_DIM, std=w**-0.5)}
    for i in range(TEXT_LAYERS):
        params[f"blocks_{i}"] = {
            "ln_1": layer_norm(), "ln_2": layer_norm(),
            "attn": {"in_proj": dense(w, 3 * w), "out_proj": dense(w, w)},
            "mlp": {"c_fc": dense(w, 4 * w), "c_proj": dense(4 * w, w)}}
    return {"params": params}


def _causal(n: int, dtype) -> torch.Tensor:
    """The text tower's (H, N, N) causal bias as its attention builds it: -1e30
    above the diagonal in fp32, cast to the compute dtype."""
    c = torch.full((n, n), -1e30, device="cuda").triu(1).to(dtype)
    return c.expand(TEXT_HEADS, n, n).contiguous()


def causal_kernel_phase(templates: int, timing: bool = True) -> dict:
    """K1 with the text tower's causal bias against its plain version on the
    card: bf16 (the bias rounded to -1.0014e30) and fp32, at the text path's
    (T, 8, 77, 64), T the templates of a class, and at B = 1 (the first row
    sees one key; the last key tile is ragged, its padding masked by the
    kernel besides the bias), o and lse at the bounds of the kernel phase;
    K7 launched 0 times (nothing asks the bias's gradient).  With
    ``timing``: K1 with and without the bias (in turns), its bound with the
    fp32 bias read, the plain version and SDPA with the same float mask."""
    import torch.nn.functional as F
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    d = TEXT_WIDTH // TEXT_HEADS
    scale = d**-0.5
    errs = {}
    attn.attention_bias_grad.launches = 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL_BF16_OUT if dtype == torch.bfloat16 else TOL_F32_OUT
        for b in (templates, 1):
            shape = (b, TEXT_HEADS, CONTEXT, d)
            q, k, v = (rand(shape, dtype) for _ in range(3))
            bias = _causal(CONTEXT, dtype)
            o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
            po, plse = attn._flash_attention_plain(q, k, v, bias, scale, True)
            err = (o.float() - po.float()).abs().max().item()
            lerr = (lse - plse).abs().max().item()
            name = f"{'bf16' if dtype == torch.bfloat16 else 'fp32'} B={b}"
            check(bool(torch.isfinite(o).all()) and err <= tol and lerr <= TOL_LSE,
                  f"causal K1 {name} (B, {TEXT_HEADS}, {CONTEXT}, {d}): max |o - plain| "
                  f"{err:.3e} <= {tol:g}, max |lse - plain| {lerr:.3e} <= {TOL_LSE:g}; row 0 "
                  f"== v[0] within the same bound: {(o[:, :, 0].float() - v[:, :, 0].float()).abs().max().item():.3e}")
            if b == templates:
                errs["bf16" if dtype == torch.bfloat16 else "fp32"] = err
    check(attn.attention_bias_grad.launches == 0,
          f"causal K1: attention_bias_grad (K7) launched {attn.attention_bias_grad.launches} times")
    result = {"max_abs_err": errs["bf16"], "max_abs_err_fp32": errs["fp32"],
              "shape": [templates, TEXT_HEADS, CONTEXT, d]}
    if not timing:
        return result
    shape = (templates, TEXT_HEADS, CONTEXT, d)
    q, k, v = (rand(shape, torch.bfloat16) for _ in range(3))
    bias = _causal(CONTEXT, torch.bfloat16)
    reps = 200
    turns = {}
    for with_bias in (False, True, True, False):
        bb = bias if with_bias else None
        turns.setdefault(with_bias, []).append(
            _device_ms(lambda: attn.flash_attention_fwd(q, k, v, bb, scale), reps))
    bound, by = attention_bound(templates, TEXT_HEADS, CONTEXT, d, 2, "fwd")
    # the kernel reads the bias once, in fp32
    bias_ms = TEXT_HEADS * CONTEXT * CONTEXT * 4 / HBM_BYTES_PER_S * 1e3
    if by == "bytes":
        bound += bias_ms
    else:
        bound = max(bound, (4 * templates * TEXT_HEADS * CONTEXT * d * 2
                            + TEXT_HEADS * CONTEXT * CONTEXT * 4) / HBM_BYTES_PER_S * 1e3)
    mask = bias[0]  # SDPA broadcasts an (N, N) float mask over batch and heads
    result.update({
        "ms": min(turns[True]), "ms_without": min(turns[False]), "bound_ms": bound,
        "bound_by": by,
        "plain_ms": _device_ms(lambda: attn._flash_attention_plain(q, k, v, bias, scale, False),
                               20),
        "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), reps)})
    _print_timing("flash_attn_fwd causal", templates, shape, result)
    print(f"causal K1 B={templates}: {result['ms']:.6f} ms with the bias, "
          f"{result['ms_without']:.6f} without (the less of two turns each)", flush=True)
    return result


def zs_cfg(over: dict, dtype: str = "bfloat16"):
    return driver_cfg({**ZS, **ZS_MODEL, "TPU.COMPUTE_DTYPE": dtype, **over})


def _text_encoder(tree: dict, device: str, dtype: torch.dtype):
    """The text tower of ``tree`` on ``device`` in ``dtype`` as
    ``encode_text``, its frozen weights stored in the compute dtype."""
    from peft_vit_tpu_torch.models import TextEncoder, TextTransformer, cast_frozen_
    from peft_vit_tpu_torch.models import load_jax_variables

    def build():
        module = TextTransformer(VOCAB, CONTEXT, TEXT_WIDTH, TEXT_LAYERS, TEXT_HEADS,
                                 OUTPUT_DIM, dtype=dtype, device=device)
        load_jax_variables(module, tree)
        return cast_frozen_(module.requires_grad_(False))

    return TextEncoder(build, CONTEXT)


def text_features_check(tree: dict, smi: str, device: str = "cuda") -> dict:
    """The zero-shot classifier of ``ZS_DATASET`` (its class names and
    templates from the prompt resources) through ``extract_text_features``:
    bf16 on ``device``, one text forward of the class's templates a class, 12
    K1 launches each, no K7, against the same in fp32 on the CPU, per class
    cosine at least ``TOL_TEXT_COS``."""
    from peft_vit_tpu_torch.data.prompts import class_map
    from peft_vit_tpu_torch.engine.zeroshot import extract_text_features
    from peft_vit_tpu_torch.ops import attention as attn

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = zs_cfg({"DATASET.DATASET": ZS_DATASET})
    card = _text_encoder(tree, device, torch.bfloat16)
    card.module  # build it before the counts
    extract_text_features(card, cfg, classnames=["warm-up"])  # the kernels' first build
    sync()
    _zero_attention_counts(attn)  # counts from 0 just before the main path, read just after
    t0 = time.perf_counter()
    got = extract_text_features(card, cfg)
    sync()
    card_s = time.perf_counter() - t0
    counts = {k: n for k, n in _attention_counts(attn).items() if n}
    classes = got.shape[0]
    t0 = time.perf_counter()
    names = class_map(ZS_DATASET)[:ZS_CPU_CLASSES]
    want = extract_text_features(_text_encoder(tree, "cpu", torch.float32), cfg,
                                 classnames=names)
    cpu_s = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(got[:len(names)].cpu().double(),
                                                want.double(), dim=1)
    least = int(cos.argmin())
    check(bool(torch.isfinite(got).all()) and float(cos[least]) >= TOL_TEXT_COS,
          f"zeroshot text features: {classes} classes of {ZS_DATASET} in bf16 on the card, "
          f"finite; the first {len(names)} against fp32 on the CPU: least cosine "
          f"{float(cos[least]):.6f} (class {least}) >= {TOL_TEXT_COS:g}, median "
          f"{float(cos.median()):.6f}")
    on_card = device == "cuda"
    check(counts == ({"flash_attention_fwd": TEXT_LAYERS * classes} if on_card else {}),
          f"zeroshot text features: launched {counts} (K1 once a text block and class: "
          f"{TEXT_LAYERS} x {classes}; no K7)")
    print(f"zeroshot text features: {classes} classes in {card_s:.3f} s on the card, "
          f"{len(names)} in {cpu_s:.1f} s on the CPU (host clock; {smi})", flush=True)
    return {"launches": counts.get("flash_attention_fwd", 0), "card_s": card_s,
            "least_cos": float(cos[least]), "classes": classes}


def zeroshot_main_check(tree: dict, text: dict, smi: str, device: str = "cuda") -> dict:
    """``zeroshot_main`` end to end on the synthetic test split, the classes
    registered with the cifar-100 names and templates: in bf16 on the card
    (finite score; K1 once a text block and class and once a visual block and
    test batch, no K7), then in fp32 on the card against the same request of
    ``CHECKED_REQUEST`` images in fp32 on the CPU, top-1 equal (bf16 moves
    random-weight cosines by more than their gaps)."""
    from peft_vit_tpu_torch.commands import zeroshot_eval
    from peft_vit_tpu_torch.data import construct_splits
    from peft_vit_tpu_torch.data.prompts import class_map, register_prompts, template_map
    from peft_vit_tpu_torch.engine.zeroshot import extract_text_features
    from peft_vit_tpu_torch.models import build_image_classifier, load_jax_variables
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.peft import PEFTSpec

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    register_prompts("synthetic", class_map(ZS_DATASET)[:ZS_CLASSES], template_map(ZS_DATASET))
    cfg = zs_cfg({})
    n_test = len(construct_splits(cfg, test_split_only=True).y_test)
    seen = {}
    real = zeroshot_eval.clip_zeroshot_evaluator

    def evaluator(img, txt, labels, metric):
        seen["logits"] = real(img, txt, labels, metric)[1]
        return real(img, txt, labels, metric)

    zeroshot_eval.clip_zeroshot_evaluator = evaluator
    try:
        _zero_attention_counts(attn)  # counts from 0 just before the main path, read just after
        t0 = time.perf_counter()
        score = zeroshot_eval.zeroshot_main(cfg, device=device, variables=tree,
                                            text_variables=text)
        sync()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in _attention_counts(attn).items() if n}
        bf16_logits = seen["logits"]
        f32 = zeroshot_eval.zeroshot_main(zs_cfg({}, "float32"), device=device, variables=tree,
                                          text_variables=text)
        card = seen["logits"][:CHECKED_REQUEST]
    finally:
        zeroshot_eval.clip_zeroshot_evaluator = real
    want_k1 = TEXT_LAYERS * ZS_CLASSES + LAYERS * -(-n_test // ZS_TEST_BATCH)
    on_card = device == "cuda"
    check(math.isfinite(score) and 0.0 <= score <= 100.0 and bool(torch.isfinite(
        bf16_logits).all()) and counts == ({"flash_attention_fwd": want_k1} if on_card else {}),
          f"zeroshot_main bf16: score {score:.3f} on {n_test} test images, {ZS_CLASSES} "
          f"classes; launched {counts} == K1 {TEXT_LAYERS} x {ZS_CLASSES} text forwards + "
          f"{LAYERS} x {-(-n_test // ZS_TEST_BATCH)} image batches, no K7; {wall:.2f} s "
          f"(host clock; {smi})")
    # the same request on the CPU in fp32
    ccfg = zs_cfg({}, "float32")
    x = construct_splits(ccfg, test_split_only=True).x_test[:CHECKED_REQUEST]
    model = build_image_classifier(ccfg, PEFTSpec(), ZS_CLASSES, device="cpu")[0]
    load_jax_variables(model, tree).eval()
    with torch.no_grad():
        img = model.backbone(torch.from_numpy(x))
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = extract_text_features(_text_encoder(text, "cpu", torch.float32), ccfg)
    cpu = 100.0 * img @ txt.t()
    rel = _rel(card.numpy(), cpu.numpy())
    check(torch.equal(card.argmax(1), cpu.argmax(1)) and rel <= TOL_F32_LOGITS_REL,
          f"zeroshot_main fp32: a {CHECKED_REQUEST}-image request's top-1 "
          f"{card.argmax(1).tolist()} == the CPU's {cpu.argmax(1).tolist()}; max |logit diff| / "
          f"max |logit| {rel:.3e} <= {TOL_F32_LOGITS_REL:g} (score {f32:.3f}; bf16 top-1 "
          f"{bf16_logits[:CHECKED_REQUEST].argmax(1).tolist()})")
    return {"score": score, "launches": counts.get("flash_attention_fwd", 0), "wall_s": wall}


def logistic_check(rng: np.random.RandomState, smi: str, device: str = "cuda") -> dict:
    """``linear_probe --classifier logistic`` (``logistic_main``) on the
    ``LOGISTIC_CLASSES``-way synthetic task in fp32 on the card and on the
    CPU from the same weights (drawn from ``rng``): the same chosen C and
    test accuracy (bf16 features stand ~1e-2 from fp32, enough to move a
    few-shot validation accuracy at some C and with it the choice)."""
    from peft_vit_tpu_torch.commands import linear_probe
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import PEFTSpec

    cfg = zs_cfg({"DATASET.NUM_CLASSES": LOGISTIC_CLASSES}, "float32")
    tree = method_tree(build_image_classifier(cfg, PEFTSpec(), LOGISTIC_CLASSES,
                                              device="cpu")[0], rng)
    picks = {}
    real = linear_probe.logistic_probe_sweep
    for dev in ("cpu", device):
        def sweep(*a, _dev=dev, **kw):
            picks[_dev] = real(*a, **kw)
            return picks[_dev]

        linear_probe.logistic_probe_sweep = sweep
        try:
            t0 = time.perf_counter()
            linear_probe.logistic_main(cfg, _results_dir(), device=dev, variables=tree)
            print(f"logistic probe on {dev}: {time.perf_counter() - t0:.2f} s (test acc, C) "
                  f"= {picks[dev]}", flush=True)
        finally:
            linear_probe.logistic_probe_sweep = real
    check(picks[device] == picks["cpu"],
          f"logistic probe: the card chose C = {picks[device][1]:g} (test accuracy "
          f"{picks[device][0]:.3f}) == the CPU's C = {picks['cpu'][1]:g} "
          f"({picks['cpu'][0]:.3f})")
    return {"card": picks[device], "cpu": picks["cpu"]}


def int8_attention_check(smi: str, device: str = "cuda") -> dict:
    """The flagship under ``INT8_FWD_TRAIN``, ``INT8_BWD_DX``,
    ``INT8_STATIC_ACT`` and ``INT8_ATTN`` (and ``+ INT8_ATTN_PV``): the int32
    scores of the card EQUAL to their exact integer sum; per recipe, the
    calibrated s_q, s_k, s_v of every block finite and positive, an epoch of
    ``GRAPH_STEPS`` captured steps equal bit for bit to the same steps run
    eagerly, the launches a replay those ``launch_rule`` derives (K1 only in
    the backward: the forward's attention is plain PyTorch on the codes) and
    the static int8 GEMMs', the calibration's launches outside the graph; one
    step's update against the bf16 recipe's (``TOL_INT8_ATTN_UPDATE_COS_MEDIAN``)
    and the static recipe's without int8 attention."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (StepGraph, ce_per_example, make_apply_fn,
                                           make_epoch_fn)
    from peft_vit_tpu_torch.engine.train import calibrate
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.ops import launch_counts

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # the scores: the card's fp32 sum of the codes against the exact sum
    gen = np.random.RandomState(SEED + 51)
    shape = (TRAIN_BATCH, HEADS, N_TOKENS, HEAD_DIM)
    q, k = (torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16) for _ in range(2))
    s_q, s_k = (t.float().abs().amax() / torch.tensor(127.0, device=device) for t in (q, k))
    got = attn.int8_attention_scores(q, k, s_q, s_k)
    exact = torch.matmul(i8.quantize_static(q, s_q).cpu().long(),
                         i8.quantize_static(k, s_k).cpu().long().transpose(-1, -2))
    check(torch.equal(got.cpu().long(), exact) and torch.equal(got, got.round()),
          f"int8 attention: the int32 scores at {shape} bf16 on the card == their exact integer "
          f"sum, bit for bit (largest |score| {int(exact.abs().max())} < 2^24)")

    rng = np.random.RandomState(SEED + 52)
    tree = jax_layout_tree(rng)
    n = GRAPH_STEPS * TRAIN_BATCH
    images = rng.randint(0, 256, (n, IMAGE, IMAGE, 3), dtype=np.uint8)
    x = bench_torch.normalize(torch.as_tensor(images, device=device), torch.float32)
    y = torch.as_tensor(rng.randint(0, NUM_CLASSES, n), device=device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    perm = rng.permutation(n)
    gemms = len(INT8_GEMMS) * LAYERS
    result = {}
    updates = {}

    def one_step(name, int8_train, static, int8_attn, pv):
        model, trainable, qtree, state0 = _flagship_state(
            tree, torch.bfloat16, device, int8_train, int8_train, int8_attn, pv)
        apply_fn = make_apply_fn(model)
        epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True,
                              calibrate_model=model if static else None)
        with bench_torch.eager_on_card():
            one, _ = epoch(state0, qtree, x[:TRAIN_BATCH], y[:TRAIN_BATCH],
                           valid[:TRAIN_BATCH], np.arange(TRAIN_BATCH), bench_torch.LR,
                           bench_torch.WD)
        updates[name] = {k: (one.trainable[k] - v).double().flatten()
                         for k, v in state0.trainable.items()}

    one_step("bf16", False, False, False, False)
    one_step("int8 static+dx", True, True, False, False)
    for name, pv in INT8_ATTN_RECIPES:
        model, trainable, qtree, state0 = _flagship_state(tree, torch.bfloat16, device, True,
                                                          True, True, pv)
        apply_fn = make_apply_fn(model)
        scales = calibrate(model, apply_fn, {**qtree}, x[:TRAIN_BATCH])
        attn_scales = {k: v for k, v in scales.items() if k.endswith((".s_q", ".s_k", ".s_v"))}
        check(len(attn_scales) == 3 * LAYERS and all(
            bool(torch.isfinite(v)) and float(v) > 0 for v in attn_scales.values()),
              f"{name}: {len(attn_scales)} calibrated attention scales (s_q, s_k, s_v of "
              f"{LAYERS} blocks) finite and positive, s_q of block 0 "
              f"{float(attn_scales['backbone.blocks.0.attn.s_q']):.4e}")
        graphs = {}
        epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True,
                              calibrate_model=model, graphs=graphs)
        run = lambda: epoch(state0, qtree, x, y, valid, perm, bench_torch.LR, bench_torch.WD)
        with bench_torch.eager_on_card():
            eager, eager_loss = run()
        sync()
        before = launch_counts()  # counts from 0 just before the main path, read just after
        captured, captured_loss = run()
        sync()
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        differ = [f"{part}.{k}" for part in ("trainable", "momentum", "bn")
                  for k, v in getattr(eager, part).items()
                  if not torch.equal(v, getattr(captured, part)[k])]
        check(not differ and torch.equal(eager_loss, captured_loss)
              and bool(torch.isfinite(captured_loss)),
              f"{name}: {GRAPH_STEPS} captured steps == the same steps eager, bit for bit "
              f"(mean loss {float(captured_loss):.6f})" + (f"; differ: {differ[:4]}"
                                                            if differ else ""))
        graph = graphs.get(("step", None, TRAIN_BATCH))
        want = launch_rule(model, list(trainable), 1, int8_attn=True)
        want.update(int8_gemm_static=gemms, int8_gemm_dynamic=gemms - 1)
        _per_replay(graph, {k: v for k, v in want.items() if v},
                    f"{name}: a step (mask-derived {want})")
        calib = {"flash_attention_fwd": LAYERS, "int8_gemm_dynamic": gemms}
        if graph is not None:
            wanted = {k: (StepGraph.WARMUP + 1) * graph.launches[k] + calib.get(k, 0)
                      for k in counts}
            check(counts == wanted, f"{name}: the wrappers counted {counts} == "
                  f"({StepGraph.WARMUP} warm-up steps + the capture) x the launches a replay "
                  "+ the calibration's (plain attention, dynamic K6)")
        one_step(name, True, True, True, pv)
        result[name] = {"launches_per_replay": dict(graph.launches) if graph else {},
                        "loss": float(captured_loss)}
        del model, epoch, graphs, graph, eager, captured
    if on_card:
        # the captured step's rate at B=16, as bench_torch.py times it (the
        # static scales calibrated once), each int8 attention recipe between
        # the static recipe's turns
        rates = {}
        for name, attn_on, pv in (("int8 static+dx", False, False),
                                  *((n, True, p) for n, p in INT8_ATTN_RECIPES),
                                  ("int8 static+dx", False, False)):
            model, _, qtree, state0 = _flagship_state(tree, torch.bfloat16, device, True, True,
                                                      attn_on, pv)
            apply_fn = make_apply_fn(model)
            frozen = {**qtree, **bench_torch.calibration_scales(
                model, apply_fn, TRAIN_BATCH, IMAGE, torch.bfloat16, device)}
            r, _ = bench_torch.measure(bench_torch.make_epoch_step(apply_fn, has_bn=True),
                                       state0, frozen, TRAIN_BATCH, TRAIN_K, 5, warmup=1,
                                       image=IMAGE, num_classes=NUM_CLASSES, device=device)
            rates.setdefault(name, []).append(statistics.median(r))
            del model, frozen
        for name, r in rates.items():
            rate = max(r)
            print(f"{name} step B={TRAIN_BATCH}: captured {rate:.1f} images/s "
                  f"({1e3 * TRAIN_BATCH / rate:.3f} ms/step; the better of {len(r)} turns, "
                  f"median of 5 windows of {TRAIN_K}; host clock; {smi})", flush=True)
            result.setdefault(name, {})["step_ms"] = 1e3 * TRAIN_BATCH / rate
    for name in ("int8 static+dx", *(n for n, _ in INT8_ATTN_RECIPES)):
        for ref in ("bf16", "int8 static+dx")[:1 if name == "int8 static+dx" else 2]:
            cos = {k: torch.nn.functional.cosine_similarity(u, updates[ref][k], dim=0).item()
                   for k, u in updates[name].items()}
            least = min(cos, key=cos.get)
            median = statistics.median(cos.values())
            held = ref == "bf16" and name != "int8 static+dx"
            check(not held or median >= TOL_INT8_ATTN_UPDATE_COS_MEDIAN,
                  f"{name}: one step's update against the {ref} recipe's, {len(cos)} leaves: "
                  f"median cosine {median:.4f}" + (f" >= {TOL_INT8_ATTN_UPDATE_COS_MEDIAN:g}"
                                                   if held else " (printed, not held)")
                  + f", least {cos[least]:.4f} ({least})")
            result.setdefault(name, {})[f"update_cos_median_vs_{ref}"] = median
    return result


def zeroshot_phase(smi: str, device: str = "cuda") -> dict:
    """The CLIP text tower's path and what rides it, at full width (the text
    tower of vitb16_CLIP.yaml, the ViT-B/16 visual tower), the weights drawn
    from numpy in the JAX layout: K1 with the causal bias against its plain
    version and timed; the zero-shot classifier of cifar-100's 100 classes,
    bf16 on the card against fp32 on the CPU; ``zeroshot_main``; the
    contrastive methods through ``finetune_main`` (a round of 3 cells, the
    text bank frozen); the linear probe and AdapterDrop on the last block
    through the cached-prefix sweep, which must choose and score as the same drive
    with ``TRAIN.CACHE_FROZEN_PREFIX`` False; the logistic probe, card
    against CPU; int8 attention.  ``device`` "cpu" rehearses the phase's code
    with the constants shrunk (no kernel there: the launch checks fail)."""
    from peft_vit_tpu_torch.data.prompts import template_map
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import PEFTSpec, spec_from_config

    t0 = time.perf_counter()
    result = {}
    if device == "cuda":
        result["causal"] = causal_kernel_phase(len(template_map(ZS_DATASET)))
    rng = np.random.RandomState(SEED + 53)
    text = text_tree(rng)
    result["text"] = text_features_check(text, smi, device)
    cfg = zs_cfg({})
    tree = method_tree(build_image_classifier(cfg, PEFTSpec(), ZS_CLASSES, device="cpu")[0], rng)
    result["zeroshot"] = zeroshot_main_check(tree, text, smi, device)
    for method in ("finetune_contrast", "linear_probe_contrast"):
        cfg = zs_cfg({"PEFT.METHOD": method})
        # the driver's own model (no channel BN, no head), its weights redrawn
        model = build_image_classifier(cfg, spec_from_config(cfg), ZS_CLASSES, device="cpu")[0]
        drawn = method_tree(model, rng)
        del model
        result[method] = drive(method, cfg, drawn, smi, device, len(ZS_LRS) * 3,
                               lr_grid=ZS_LRS)
    for method, over in (("linear", ZS_CACHED), ("adapterdrop", ZS_CACHED)):
        cfg = zs_cfg({"PEFT.METHOD": method, **over})
        model = build_image_classifier(cfg, spec_from_config(cfg), ZS_CLASSES,
                                       use_bn=bool(cfg.TRAIN.CHANNEL_BN), device="cpu")[0]
        drawn = method_tree(model, rng)
        del model
        cells = len(ZS_CACHED_LRS) * 3
        cached = drive(f"{method} cached", cfg, drawn, smi, device, cells, lr_grid=ZS_CACHED_LRS)
        whole = drive(f"{method} whole", zs_cfg({"PEFT.METHOD": method,
                                                 "TRAIN.CACHE_FROZEN_PREFIX": False, **over}),
                      drawn, smi, device, cells, lr_grid=ZS_CACHED_LRS)
        check(cached["cut"] == (LAYERS if method == "linear" else LAYERS - 1)
              and (cached["lr"], cached["wd"], cached["score"]) == (
                  whole["lr"], whole["wd"], whole["score"]),
              f"{method}: the cached-prefix sweep (prefix through block {cached['cut'] - 1}) "
              f"chose lr {cached['lr']:g}, wd {cached['wd']:g}, score {cached['score']:.3f} == "
              f"the whole-tower drive's lr {whole['lr']:g}, wd {whole['wd']:g}, score "
              f"{whole['score']:.3f}; sweep {cached['sweep_s']:.2f} s against "
              f"{whole['sweep_s']:.2f} s (host clock; {smi})")
        result[f"{method} cached"], result[f"{method} whole"] = cached, whole
    result["logistic"] = logistic_check(rng, smi, device)
    result["int8_attention"] = int8_attention_check(smi, device)
    print(f"zeroshot phase: {time.perf_counter() - t0:.1f} s (host clock; {smi})", flush=True)
    return result




# Full-shot training (phase 13): commands.train.train_main at ViT-B/16 from
# vitb16_sup.yaml (the supervised timm-style tower), random weights from the
# model builder's seed, the synthetic 10-way task at 224 px (160 training images:
# two steps of 64 an epoch, 200 test images).  The full fine-tune runs the
# recipe of the full-shot trainer: SGD with nesterov momentum, warmupcosine,
# EMA, mixup with cutmix and label smoothing, the global-norm clip, a
# checkpoint every 2 steps under AUTO_RESUME.  Then LoRA on the same tower
# under the int8 static recipe with int8 dx, and a tiny fp32 run on the card
# against the CPU (width 64, one head: the kernels take head dim 64 only).
FULLSHOT_YAML = "peft_vit_tpu/resources/model/vitb16_sup.yaml"
# MODEL.NUM_CLASSES: the class count of mixup's targets (the JAX trainer's
# quirk: its default is 1000, whatever the dataset's)
FULLSHOT = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 10, "MODEL.NUM_CLASSES": 10,
            "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], "PEFT.METHOD": "none",
            "TRAIN.BATCH_SIZE_PER_GPU": 64, "TEST.BATCH_SIZE_PER_GPU": 64, "TRAIN.END_EPOCH": 2,
            "TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True,
            "TRAIN.LR": 1e-3, "TRAIN.WD": 1e-4, "TRAIN.LR_SCHEDULER.METHOD": "warmupcosine",
            "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "TRAIN.EMA_DECAY": 0.999, "AUG.MIXUP": 0.8,
            "AUG.MIXCUT": 1.0, "LOSS.LABEL_SMOOTHING": 0.1, "TRAIN.CLIP_GRAD_NORM": 1.0,
            "TRAIN.CHECKPOINT_EVERY_STEPS": 2, "TRAIN.AUTO_RESUME": True,
            "TPU.COMPUTE_DTYPE": "bfloat16", "PRINT_FREQ": 1, "NAME": "fullshot"}
# the tower's shape (the yaml's); a rehearsal on the CPU shrinks it
FULLSHOT_MODEL = {}
# the full-shot, streaming and multichip phases' depth: the flagship's (the
# seqpipe phase's stacked and GPipe checks keep the yaml's 12 blocks)
FULLSHOT_DEPTH = {"MODEL.SPEC.VISION.LAYERS": LAYERS}
FULLSHOT_LORA = {"PEFT.METHOD": "lora", "TPU.INT8_FWD_TRAIN": True, "TPU.INT8_BWD_DX": True,
                 "TPU.INT8_STATIC_ACT": True, "AUG.MIXUP": 0.0, "AUG.MIXCUT": 0.0,
                 "TRAIN.EMA_DECAY": 0.0, "TRAIN.CHECKPOINT_EVERY_STEPS": 0,
                 "NAME": "fullshot_lora_int8"}
FULLSHOT_TINY = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4,
                 "TRAIN.IMAGE_SIZE": [32, 32], "MODEL.NAME": "cls_vit_tiny",
                 "MODEL.SPEC.VISION.PATCH_SIZE": 8, "MODEL.SPEC.VISION.WIDTH": 64,
                 "MODEL.SPEC.VISION.LAYERS": 2, "MODEL.SPEC.VISION.HEADS": 1,
                 "PEFT.METHOD": "none", "TRAIN.BATCH_SIZE_PER_GPU": 8,
                 "TEST.BATCH_SIZE_PER_GPU": 16, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-3,
                 "TRAIN.MOMENTUM": 0.9, "TRAIN.LR_SCHEDULER.METHOD": "cosine",
                 "TPU.COMPUTE_DTYPE": "float32", "PRINT_FREQ": 1, "NAME": "fullshot_tiny"}
FULLSHOT_DIR = "build/fullshot"  # checkpoints and logs, removed after the phase
TOL_FULLSHOT_LOSS_REL = 1e-4  # the tiny fp32 run's epoch losses, card against CPU
# fwd + bwd GEMMs, attention aside: ViT-B/16's 86.6 M parameters are 7.08 M a
# block and 1.64 M outside them
FULLSHOT_STEP_FLOPS_PER_IMAGE = 3 * 2 * (7.08e6 * LAYERS + 1.64e6) * N_TOKENS


@contextlib.contextmanager
def trainer_spy(sync):
    """Within, ``commands.train`` builds its splits and ``Trainer`` as it
    does, observed: the yielded dict gets ``splits``, ``trainer`` and, per
    step, the step count before it, the rate it used (cloned before the next
    replay overwrites it) and the first step's batch, generator state and
    state before and after (clones); per epoch the wall time, its stats and
    the static scales it trained on; per evaluation the wall time."""
    from peft_vit_tpu_torch.commands import train as train_cmd

    seen = {"steps": [], "epochs": [], "evals": [], "losses": []}
    saved = train_cmd.Trainer, train_cmd.construct_splits

    def snapshot(t):
        s = t.state
        return {"trainable": {k: v.detach().clone() for k, v in s.trainable.items()},
                "opt": {k: v.clone() for k, v in s.opt_state.items()},
                "ema": {k: v.clone() for k, v in s.ema.shadow.items()} if s.ema else {},
                "bn": {k: v.clone() for k, v in (s.batch_stats or {}).items()}}

    class Spy(train_cmd.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["trainer"] = self

        def train_step(self, x, y, epoch):
            step = int(self.state.step)
            if step == 0:
                seen["first"] = {
                    "x": x.clone() if torch.is_tensor(x) else np.array(x),
                    "y": y.clone() if torch.is_tensor(y) else np.array(y),
                    "rng": self.generator.get_state(), "before": snapshot(self),
                    "noise_rng": (self.noise_generator.get_state()
                                  if self.noise_generator is not None else None),
                    "drop_rng": (self.drop_generator.get_state()
                                 if self.drop_generator is not None else None)}
            loss, lr = super().train_step(x, y, epoch)
            seen["steps"].append((step, lr.clone()))
            seen["losses"].append(loss.detach().clone())
            if step == 0:
                seen["first"]["after"] = snapshot(self)
            return loss, lr

        def train_one_epoch(self, batches, epoch, *args, **kwargs):
            sync()
            t0 = time.perf_counter()
            stats = super().train_one_epoch(batches, epoch, *args, **kwargs)
            sync()
            seen["epochs"].append({"epoch": epoch, "s": time.perf_counter() - t0, **stats,
                                   "scales": {k: v.clone() for k, v in (self._qscale or {}).items()}})
            return stats

        def evaluate(self, batches, use_ema=False, use_swa=False, metric=None):
            sync()
            t0 = time.perf_counter()
            acc = super().evaluate(batches, use_ema, use_swa, metric)
            sync()
            seen["evals"].append({"ema": use_ema, "s": time.perf_counter() - t0, "acc": acc})
            return acc

    def splits_spy(*args, **kwargs):
        seen["splits"] = saved[1](*args, **kwargs)
        return seen["splits"]

    train_cmd.Trainer, train_cmd.construct_splits = Spy, splits_spy
    try:
        yield seen
    finally:
        train_cmd.Trainer, train_cmd.construct_splits = saved


def _state_differ(trainer, want: dict) -> list:
    """The state tensors of ``trainer`` that differ from the snapshot
    ``want`` (``trainer_spy``'s layout)."""
    s = trainer.state
    got = {"trainable": s.trainable, "opt": s.opt_state,
           "ema": s.ema.shadow if s.ema is not None else {}, "bn": s.batch_stats or {}}
    return [f"{part}.{k}" for part, leaves in want.items() for k, v in leaves.items()
            if not torch.equal(v, got[part][k])]


def _rerun_first_step(trainer, first: dict) -> None:
    """Put the first step's state and generator back into ``trainer`` and run
    the step again (eagerly under ``bench_torch.eager_on_card``)."""
    from peft_vit_tpu_torch.engine.trainer import FullTrainState

    s, b = trainer.state, first["before"]
    trainer.state = FullTrainState(
        {k: v.clone() for k, v in b["trainable"].items()},
        {k: v.clone() for k, v in b["opt"].items()},
        torch.zeros_like(s.step),
        s.ema._replace(shadow={k: v.clone() for k, v in b["ema"].items()}) if s.ema else None,
        s.swa, {k: v.clone() for k, v in b["bn"].items()} if s.batch_stats else None,
        torch.ones_like(s.finite))
    trainer.generator.set_state(first["rng"])
    if first.get("noise_rng") is not None:
        trainer.noise_generator.set_state(first["noise_rng"])
    if first.get("drop_rng") is not None:
        trainer.drop_generator.set_state(first["drop_rng"])
    trainer.train_step(first["x"], first["y"], 0)


@contextlib.contextmanager
def attention_spy():
    """Within, every attention call of the tower records its q, k, v and
    scale (clones), and the gradient that flows back into its output: the
    operands K1, K2 and K3 were given."""
    from peft_vit_tpu_torch.models import layers, swin

    calls = []
    original = layers.multi_head_attention

    def spy(q, k, v, *args, **kwargs):
        bias = kwargs.get("bias")
        rec = {"q": q.detach().clone(), "k": k.detach().clone(), "v": v.detach().clone(),
               "scale": kwargs.get("scale"),
               "bias": None if bias is None else bias.detach().float().contiguous()}
        calls.append(rec)
        out = original(q, k, v, *args, **kwargs)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__(
                "do", g.detach().clone(memory_format=torch.contiguous_format)))
        return out

    layers.multi_head_attention = swin.multi_head_attention = spy
    try:
        yield calls
    finally:
        layers.multi_head_attention = swin.multi_head_attention = original


def hold_step_attention(attn, label: str, calls: list) -> dict:
    """K1 (with lse), K2 and K3 on the operands each block's attention got
    in one training step (``attention_spy``), against their plain versions
    on the same operands, to the kernel checks' tolerances: o by max abs
    error, lse likewise, dq, dk and dv by max abs error over the plain
    version's largest magnitude.  o's bf16 bound is set for |o| below 4,
    where one bf16 step is 2^-6; it doubles for each binade the largest |o|
    stands above that, as one bf16 step grows with it.  Returns the largest
    errors over the blocks."""
    worst = {"fwd": 0.0, "lse": 0.0, "dq": 0.0, "dkv": 0.0}
    rels = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    finite = True
    largest_o = 0.0
    for c in calls:
        q, k, v, scale, do = c["q"], c["k"], c["v"], c["scale"], c["do"]
        if scale is None:  # multi_head_attention's default (Swin passes none)
            scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = attn.flash_attention_fwd(q, k, v, c["bias"], scale, return_lse=True)
        ref_o, ref_lse = attn._flash_attention_plain(q, k, v, c["bias"], scale, True)
        dq, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, c["bias"])
        dk, dv = attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale, c["bias"])
        want = attn._flash_attention_bwd_plain(q, k, v, o, lse, do, scale, c["bias"])
        torch.cuda.synchronize()
        worst["fwd"] = max(worst["fwd"], (o.float() - ref_o.float()).abs().max().item())
        largest_o = max(largest_o, ref_o.float().abs().max().item())
        worst["lse"] = max(worst["lse"], (lse - ref_lse).abs().max().item())
        for what, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err = (got.float() - ref.float()).abs().max().item()
            rels[what] = max(rels[what], err / ref.float().abs().max().item())
            key = "dq" if what == "dq" else "dkv"
            worst[key] = max(worst[key], err)
            finite = finite and bool(torch.isfinite(got).all())
    shape = tuple(calls[0]["q"].shape)
    # the kernel phase's bounds for the operands' dtype
    tol_out, tol_grad = ((TOL_F32_OUT, TOL_F32_GRAD_REL) if calls[0]["q"].dtype == torch.float32
                         else (TOL_BF16_OUT, TOL_BF16_GRAD_REL))
    if calls[0]["q"].dtype != torch.float32 and largest_o >= 4.0:
        tol_out *= 2.0 ** (math.floor(math.log2(largest_o)) - 1)
    check(worst["fwd"] <= tol_out and worst["lse"] <= TOL_LSE,
          f"{label}: K1 on the operands of the {len(calls)} blocks' attention {shape} "
          f"{calls[0]['q'].dtype} scale={calls[0]['scale']}"
          + (" with the bias" if calls[0]["bias"] is not None else "")
          + f": o max abs err {worst['fwd']:.3e} <= {tol_out:g} (largest |o| {largest_o:.3g}), "
          f"lse {worst['lse']:.3e} <= "
          f"{TOL_LSE:g}")
    check(finite and max(rels.values()) <= tol_grad,
          f"{label}: K2 and K3 on the same operands and the step's own dO: finite, dq, dk, dv "
          "max |diff| / max |plain| over the blocks = "
          + ", ".join(f"{r:.3e}" for r in rels.values()) + f" <= {tol_grad:g}")
    worst.update({f"{k}_rel": r for k, r in rels.items()})
    return worst


def _graphs_of(trainer, kind: str) -> list:
    return [g for key, g in trainer.graphs.items() if key[0] == kind]


def fullshot_drive(label: str, cfg, smi: str, device: str, sync, sources=None,
                   out_dir: str = FULLSHOT_DIR) -> dict:
    """``train_main(cfg)`` observed (``trainer_spy``): the wrappers' counts
    from 0 just before and read just after, the wall time and peak memory.
    ``sources``: ``train_main``'s streaming sources in place of the config's."""
    import shutil

    from peft_vit_tpu_torch.commands import train as train_cmd
    from peft_vit_tpu_torch.ops import launch_counts

    shutil.rmtree(out_dir, ignore_errors=True)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    with trainer_spy(sync) as seen:
        before = launch_counts()
        sync()
        t0 = time.perf_counter()
        best = train_cmd.train_main(cfg, device=device, sources=sources)
        sync()
        seen["wall_s"] = time.perf_counter() - t0
        seen["counts"] = {n: c - before[n] for n, c in launch_counts().items()}
    seen["best"] = best
    seen["peak_gib"] = ((torch.cuda.max_memory_allocated() - base) / 2**30
                        if device == "cuda" else float("nan"))
    return seen


def _hold_graphs(label: str, trainer, counts: dict, train_want: dict, eval_want: dict,
                 steps: int, eval_batches: int, eager: dict = None) -> None:
    """Every step and eval batch one replay; the launches a replay of each
    graph against ``train_want`` / ``eval_want``; the wrappers' counts
    against (warm-up + capture) x those of each graph, plus ``eager``: what
    runs outside the graphs (the static recipe's calibration forwards)."""
    from peft_vit_tpu_torch.engine import StepGraph

    trains, evals = _graphs_of(trainer, "train"), _graphs_of(trainer, "eval")
    replays = sum(g.replays for g in trains), sum(g.replays for g in evals)
    check(replays == (steps, eval_batches) and len(trains) == 1,
          f"{label}: {replays[0]} train replays of {len(trains)} graph(s) for {steps} steps, "
          f"{replays[1]} eval replays of {len(evals)} graph(s) for {eval_batches} eval batches")
    for g in trains:
        _per_replay(g, train_want, f"{label}: a train step")
    for g in evals:
        _per_replay(g, eval_want, f"{label}: an eval batch {tuple(g.inputs['x'].shape)}")
    eager = eager or {}
    wanted = {n: (StepGraph.WARMUP + 1) * sum(g.launches.get(n, 0) for g in trains + evals)
              + eager.get(n, 0) for n in counts}
    check(counts == wanted, f"{label}: the wrappers counted {counts} == ({StepGraph.WARMUP} "
          "warm-up runs + the capture) x the launches a replay of each graph"
          + (f" + {eager} outside them" if eager else ""))


def hold_first_step(label: str, tr, first: dict, on_card: bool):
    """The first train step (``trainer_spy``'s record) run again eagerly:
    equal to its capture bit for bit; its attention operands held against
    K1-K3's plain versions; its update with K1-K3 against the float64
    backward, no farther than the plain dq/dk/dv's.  Returns the kernels'
    largest errors (None on the CPU)."""
    import bench_torch
    from peft_vit_tpu_torch.ops import attention as attn

    captured = {part: dict(leaves) for part, leaves in first["after"].items()}
    backbone = tr.model.backbone
    layers = getattr(backbone, "layers", None) or sum(getattr(backbone, "depths", ()))
    with bench_torch.eager_on_card(), attention_spy() as calls:
        _rerun_first_step(tr, first)
    differ = _state_differ(tr, captured)
    n_state = sum(len(v) for v in captured.values())
    check(not differ, f"{label}: the first step captured == eager bit for bit ({n_state} "
          "state tensors: trainable, momentum, EMA)" + (f"; differ: {differ[:4]}" if differ else ""))
    check(len(calls) == layers and all("do" in c for c in calls),
          f"{label}: the eager step's {len(calls)} attention calls (== {layers}) each "
          "received a gradient")
    kernel_err = hold_step_attention(attn, f"{label} first step", calls) if on_card else None
    del calls
    if on_card:
        updates = {}
        for name, ctx in (("plain", plain_backward), ("exact", exact_backward)):
            with bench_torch.eager_on_card(), ctx(attn):
                _rerun_first_step(tr, first)
            updates[name] = {k: (v - first["before"]["trainable"][k]).double().flatten()
                             for k, v in tr.state.trainable.items()}
        kernel = {k: (v - first["before"]["trainable"][k]).double().flatten()
                  for k, v in captured["trainable"].items()}
        cos = {}
        for k, u in kernel.items():
            cos[k] = tuple(1.0 if torch.equal(a, b) else torch.nn.functional.cosine_similarity(
                a, b, dim=0).item() for a, b in ((u, updates["plain"][k]),
                                                 (u, updates["exact"][k]),
                                                 (updates["plain"][k], updates["exact"][k])))
        miss = {who: statistics.fmean(1.0 - v[i] for v in cos.values())
                for i, who in ((1, "kernel"), (2, "plain"))}
        least = min(cos, key=lambda k: cos[k][0])
        check(miss["kernel"] <= TOL_METHOD_EXACT_RATIO * miss["plain"] + TOL_METHOD_EXACT_FLOOR,
              f"{label}: the first step's update with K1-K3 against the float64 backward, "
              f"{len(cos)} leaves: mean 1 - cosine {miss['kernel']:.3e} <= "
              f"{TOL_METHOD_EXACT_RATIO:g} x the plain dq/dk/dv's {miss['plain']:.3e} + "
              f"{TOL_METHOD_EXACT_FLOOR:g}; against the plain versions least cosine "
              f"{cos[least][0]:.6f} ({least}), printed, not held")
    return kernel_err


def fullshot_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 13 (see the module docstring); ``device`` "cpu" rehearses the
    phase's own code at a tiny size (with the StepGraph stand-in patched in,
    only the launch checks fail there)."""
    import itertools
    import shutil

    import bench_torch
    from peft_vit_tpu_torch.commands import train as train_cmd
    from peft_vit_tpu_torch.engine import StepGraph
    from peft_vit_tpu_torch.engine.trainer import Trainer, _skip_batches, batch_iterator
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.peft import build_mask

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}

    # 1. the full fine-tune through train_main
    cfg = driver_cfg({**FULLSHOT, **FULLSHOT_DEPTH, **FULLSHOT_MODEL, "OUTPUT_DIR": FULLSHOT_DIR},
                     FULLSHOT_YAML)
    run = fullshot_drive("full", cfg, smi, device, sync)
    tr, splits = run["trainer"], run["splits"]
    # the uninterrupted run's final state, which the resumed run must equal
    final = {"trainable": {k: v.detach().clone() for k, v in tr.state.trainable.items()},
             "opt": {k: v.clone() for k, v in tr.state.opt_state.items()},
             "ema": {k: v.clone() for k, v in tr.state.ema.shadow.items()}}
    spe = tr.steps_per_epoch
    steps = spe * int(cfg.TRAIN.END_EPOCH)
    n_eval = -(-len(splits.y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
    layers = tr.model.backbone.layers
    check(bool(tr.state.finite) and math.isfinite(run["best"]) and all(
        math.isfinite(e["loss"]) for e in run["epochs"]),
        f"fullshot full: {steps} steps at B={cfg.TRAIN.BATCH_SIZE_PER_GPU}, finite losses "
        + " ".join(f"{e['loss']:.4f}" for e in run["epochs"]) + f", best top-1 {run['best']:.2f}")
    trainable = sum(v.numel() for v in tr.state.trainable.values())
    check(trainable == sum(p.numel() for p in tr.model.parameters()),
          f"fullshot full: every one of {trainable} parameters trains")
    _hold_graphs("fullshot full", tr, run["counts"],
                 {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                  "flash_attention_bwd_dkv": layers}, {"flash_attention_fwd": layers},
                 steps, 2 * int(cfg.TRAIN.END_EPOCH) * n_eval)
    # the rate each replay used, against the schedule at its step (on the
    # card: the same kernels; on the CPU: within fp32 rounding)
    bad = [(s, float(lr)) for s, lr in run["steps"]
           if not torch.equal(lr, tr.schedule(torch.tensor(s, dtype=torch.int32,
                                                           device=device)))]
    cpu_rel = max(abs(float(lr) - float(tr.schedule(s))) / abs(float(tr.schedule(s)))
                  for s, lr in run["steps"])
    check(not bad and cpu_rel <= 1e-6 and len({float(lr) for _, lr in run["steps"]}) == steps,
          f"fullshot full: the rate of each of {steps} replays == build_lr_schedule at its step "
          f"({', '.join(f'{float(lr):.6g}' for _, lr in run['steps'])}; the CPU's within "
          f"{cpu_rel:.1e} relative)" + (f"; differ: {bad}" if bad else ""))

    # 2. the first step captured against it eager, and with the plain dq and
    # dk/dv (and the float64 backward) in the kernels' place
    first = run["first"]
    after = first["after"]
    captured = {part: dict(leaves) for part, leaves in after.items()}
    kernel_err = hold_first_step("fullshot full", tr, first, on_card)

    # 3. a fresh Trainer stopped after its first mid-epoch checkpoint (one
    # step: CHECKPOINT_EVERY_STEPS 1, since 160 images at B=64 make an epoch
    # of two steps) and a fresh one resumed from it, against the run above
    mask = build_mask(tr.model, "full", num_layers=layers)
    resume_dir = f"{FULLSHOT_DIR}/resume"
    rcfg = driver_cfg({**FULLSHOT, **FULLSHOT_DEPTH, **FULLSHOT_MODEL,
                       "OUTPUT_DIR": FULLSHOT_DIR, "TRAIN.CHECKPOINT_EVERY_STEPS": 1},
                      FULLSHOT_YAML)
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)

    def epoch_batches(e):
        return batch_iterator(splits.x_train, splits.y_train, batch,
                              shuffle=bool(cfg.TRAIN.SHUFFLE), seed=e)

    stopped = Trainer(rcfg, tr.model, mask, spe)
    stopped.train_one_epoch(itertools.islice(epoch_batches(0), 1), 0, checkpoint_dir=resume_dir)
    del stopped
    resumed = Trainer(rcfg, tr.model, mask, spe)
    epoch0 = resumed.maybe_resume(resume_dir)
    at = resumed.resume_batch_in_epoch
    for e in range(epoch0, int(cfg.TRAIN.END_EPOCH)):
        sb = at if e == epoch0 else 0
        resumed.train_one_epoch(_skip_batches(epoch_batches(e), sb), e, start_batch=sb)
    differ = _state_differ(resumed, final)
    check((epoch0, at) == (0, 1) and not differ,
          f"fullshot full: a fresh Trainer resumed at epoch {epoch0} batch {at} from the first "
          f"mid-epoch checkpoint == the uninterrupted run bit for bit after {steps} steps "
          f"({sum(len(v) for v in final.values())} state tensors)"
          + (f"; differ: {differ[:4]}" if differ else ""))
    del resumed
    shutil.rmtree(FULLSHOT_DIR, ignore_errors=True)

    # 4. the timings of the full fine-tune
    row = {"steps": steps, "epochs": [e["s"] for e in run["epochs"]],
           "ema_eval_s": [e["s"] for e in run["evals"] if e["ema"]],
           "eval_s": [e["s"] for e in run["evals"] if not e["ema"]],
           "wall_s": run["wall_s"], "peak_gib": run["peak_gib"], "best": run["best"],
           "launches": run["counts"], "kernel_err": kernel_err,
           "per_replay": dict(_graphs_of(tr, "train")[0].launches)}
    if on_card:
        graph = _graphs_of(tr, "train")[0]
        step_ms = _replay_ms(graph, 10)
        busy, n_launches, top = _device_breakdown(graph.graph.replay, reps=5)
        # the optimizer chain alone, captured on copies of the state
        opt_in = {"p": {k: v.detach().clone() for k, v in tr.state.trainable.items()},
                  "g": {k: torch.randn_like(v) * 1e-3 for k, v in tr.state.trainable.items()},
                  "s": {k: v.clone() for k, v in tr.state.opt_state.items()},
                  "c": tr.state.step.clone()}
        opt_graph = StepGraph(lambda b: tr.tx.step(b["p"], b["g"], b["s"], b["c"]), opt_in)
        opt_ms = _replay_ms(opt_graph, 10)
        del opt_graph, opt_in
        row.update(step_ms=step_ms, images_per_s=1e3 * batch / step_ms, busy_ms=busy,
                   device_launches=n_launches, opt_ms=opt_ms,
                   idle_share=None if busy is None else max(0.0, 1.0 - busy / step_ms),
                   bound_ms=batch * FULLSHOT_STEP_FLOPS_PER_IMAGE / BF16_FLOPS_PER_S * 1e3)
        print(f"fullshot full step B={batch} (ViT-B/16 timm, bf16, SGD nesterov + clip + EMA + "
              f"mixup/cutmix): captured {step_ms:.3f} ms ({row['images_per_s']:.1f} images/s, "
              f"median of 5 windows of 10 replays), device busy "
              + ("not measured" if busy is None else
                 f"{busy:.3f} ms in {n_launches:.0f} launches (idle share "
                 f"{row['idle_share']:.3f})")
              + f"; the optimizer chain alone {opt_ms:.3f} ms"
              + ("" if busy is None else f" ({opt_ms / busy:.3f} of the busy time)")
              + f"; GEMM bound {row['bound_ms']:.3f} ms at the bf16 peak; top: "
              + "; ".join(f"{n} {t:.3f} ms" for n, t in top) + f"; {smi}", flush=True)
    print(f"fullshot full: train_main {row['wall_s']:.3f} s (2 epochs of {spe} steps, evals, "
          f"checkpoints), epochs " + ", ".join(f"{s:.3f}" for s in row["epochs"])
          + " s, evals raw " + ", ".join(f"{s:.3f}" for s in row["eval_s"])
          + " s, with EMA " + ", ".join(f"{s:.3f}" for s in row["ema_eval_s"])
          + f" s ({n_eval} batches of up to 64); peak {row['peak_gib']:.2f} GiB; "
          f"launches a step {row['per_replay']}; {smi}", flush=True)
    out["full"] = row
    del run, tr, first, after, captured, final
    gc_collect(on_card)

    # 5. LoRA under the int8 static recipe with int8 dx
    cfg8 = driver_cfg({**FULLSHOT, **FULLSHOT_DEPTH, **FULLSHOT_MODEL, **FULLSHOT_LORA,
                       "OUTPUT_DIR": FULLSHOT_DIR}, FULLSHOT_YAML)
    run8 = fullshot_drive("lora int8", cfg8, smi, device, sync)
    tr8 = run8["trainer"]
    gemms = 4 * layers
    _hold_graphs("fullshot lora int8", tr8, run8["counts"],
                 {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                  "flash_attention_bwd_dkv": layers, "int8_gemm_static": gemms,
                  "int8_gemm_dynamic": gemms - 1},
                 {"flash_attention_fwd": layers, "int8_gemm_dynamic": gemms},
                 steps, int(cfg8.TRAIN.END_EPOCH) * n_eval,
                 # each epoch's calibration: one eager forward, its weights
                 # quantized per call
                 eager={"flash_attention_fwd": int(cfg8.TRAIN.END_EPOCH) * layers,
                        "int8_gemm_dynamic": int(cfg8.TRAIN.END_EPOCH) * gemms})
    s0, s1 = (run8["epochs"][i]["scales"] for i in (0, 1))
    moved = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    check(len(s0) == gemms and bool(moved),
          f"fullshot lora int8: {len(s0)} static scales recalibrated at each epoch start, "
          f"{len(moved)} of them moved between the epochs")
    first8 = run8["first"]
    captured8 = {part: dict(leaves) for part, leaves in first8["after"].items()}
    tr8._qscale = s0
    with bench_torch.eager_on_card():
        _rerun_first_step(tr8, first8)
    differ = _state_differ(tr8, captured8)
    check(not differ, "fullshot lora int8: the first step captured == eager bit for bit"
          + (f"; differ: {differ[:4]}" if differ else ""))
    tr8._qscale = s0
    with bench_torch.eager_on_card(), plain_int8(i8):
        _rerun_first_step(tr8, first8)
    differ = _state_differ(tr8, captured8)
    check(not differ, "fullshot lora int8: the first step with K6 == the same step with its "
          "plain version bit for bit" + (f"; differ: {differ[:4]}" if differ else ""))
    row8 = {"launches": run8["counts"], "per_replay": dict(_graphs_of(tr8, "train")[0].launches),
            "best": run8["best"], "trainable": sum(v.numel() for v in tr8.state.trainable.values())}
    if on_card:
        row8["step_ms"] = _replay_ms(_graphs_of(tr8, "train")[0], 10)
        print(f"fullshot lora int8 step B={batch} (static scales, int8 dx): captured "
              f"{row8['step_ms']:.3f} ms ({1e3 * batch / row8['step_ms']:.1f} images/s); "
              f"{row8['trainable']} trainable; launches a step {row8['per_replay']}; {smi}",
              flush=True)
    out["lora_int8"] = row8
    del run8, tr8, first8, captured8
    shutil.rmtree(FULLSHOT_DIR, ignore_errors=True)
    gc_collect(on_card)

    # 6. the tiny fp32 run on the card against the CPU
    runs = {}
    for dev in (device, "cpu"):
        tcfg = driver_cfg({**FULLSHOT_TINY, "OUTPUT_DIR": FULLSHOT_DIR}, None)
        r = fullshot_drive(f"tiny {dev}", tcfg, smi, dev,
                           sync if dev == device else (lambda: None))
        runs[dev] = ([e["loss"] for e in r["epochs"]], r["best"])
        shutil.rmtree(FULLSHOT_DIR, ignore_errors=True)
    (card_l, card_b), (cpu_l, cpu_b) = runs[device], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    check(rel <= TOL_FULLSHOT_LOSS_REL and card_b == cpu_b,
          f"fullshot tiny fp32 (width 64, one head): epoch losses on the card "
          + " ".join(f"{v:.6f}" for v in card_l) + " against the CPU's "
          + " ".join(f"{v:.6f}" for v in cpu_l) + f" (max {rel:.2e} relative <= "
          f"{TOL_FULLSHOT_LOSS_REL:g}), best top-1 {card_b:.2f} == {cpu_b:.2f}")
    out["tiny_rel"] = rel
    return out


# Streaming data (phase 14): the native decode ring and the streaming source
# feeding train_main at ViT-B/16 with the timm augmentation inside the
# captured step, and finetune_main on an ELEVATER manifest.
STREAM_CLASSES = 10
STREAM_TRAIN, STREAM_TEST = 640, 128  # ImageNet's 1.28 M train images cut to 640
STREAM_SIZES = ((256, 320), (320, 256))  # PNG heights x widths, in turn: the resize-and-crop runs
STREAM_SHARDS = 4
STREAM_K = 2  # TPU.STEPS_PER_DISPATCH of the source checks
STREAM_SKIP = 3  # skip_batches of the source checks: aligned at K = 1, misaligned at K = 2
STREAM_RESUME_AT = 4  # the trainer's mid-epoch checkpoint: 2 chunks of K = 2 into epoch 1
STREAM_DIR = "build/streaming"  # the data, checkpoints and logs, removed after the phase
STREAM = {"DATASET.NUM_CLASSES": STREAM_CLASSES, "MODEL.NUM_CLASSES": STREAM_CLASSES,
          "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], "PEFT.METHOD": "none",
          "TRAIN.BATCH_SIZE_PER_GPU": FULLSHOT_BATCH, "TEST.BATCH_SIZE_PER_GPU": FULLSHOT_BATCH,
          "TRAIN.END_EPOCH": 2, "TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9,
          "TRAIN.NESTEROV": True, "TRAIN.LR": 1e-3, "TRAIN.WD": 1e-4,
          "TRAIN.LR_SCHEDULER.METHOD": "warmupcosine", "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1,
          "TRAIN.EMA_DECAY": 0.999, "AUG.TIMM_AUG.USE_TRANSFORM": True,
          "AUG.TIMM_AUG.AUTO_AUGMENT": "rand-m9-mstd0.5-inc1", "AUG.TIMM_AUG.RE_PROB": 0.25,
          "AUG.TIMM_AUG.RE_MODE": "pixel", "AUG.TIMM_AUG.HFLIP": 0.5,
          "DATASET.RANDOM_SEED_SAMPLING": 3, "TPU.PREFETCH_DEPTH": 2, "WORKERS": 8,
          "TPU.STEPS_PER_DISPATCH": STREAM_K,
          "TPU.COMPUTE_DTYPE": "bfloat16", "PRINT_FREQ": 5, "NAME": "streaming"}
STREAM_FEWSHOT = {"DATASET.NUM_CLASSES": 5, "DATASET.NUM_SAMPLES_PER_CLASS": 4,
                  "TRAIN.BATCH_SIZE_PER_GPU": 16, "TRAIN.END_EPOCH": 2,
                  "TRAIN.SEARCH_WD_POINTS": 3, "TRAIN.SEARCH_WD_INIT_POINTS": 3,
                  "TRAIN.SEARCH_WD_LOG_UPPER": -2, "PEFT.METHOD": "lora"}
STREAM_FEWSHOT_LRS = (1e-3,)  # one round of 3 (lr, wd) cells
STREAM_AUG_TOL = 1e-4  # an op, card against CPU, on the [0, 255] scale (the CPU tests' bound)
STREAM_STEP_CONSUMPTION = 2085.0  # images/s of the in-memory full-shot step (PERF.md §5, PR 14)


def png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG, from the standard
    library's zlib and struct (no PIL)."""
    import struct
    import zlib

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def stream_image(i: int, rng: np.random.RandomState, h: int, w: int) -> Tuple[np.ndarray, int]:
    """Image ``i``: noise with a bright band at its class's rows (the
    synthetic dataset's learnable pattern)."""
    c = i % STREAM_CLASSES
    x = rng.randint(0, 120, (h, w, 3)).astype(np.uint8)
    band = h // STREAM_CLASSES
    x[c * band:(c + 1) * band] += 120
    return x, c


def write_stream_dataset(root: str, on_disk: bool = True) -> dict:
    """The train and test images as PNGs laid out three ways under
    ``root``: ``STREAM_SHARDS`` base64 TSV shards (and one test shard), an
    ImageFolder tree, and an ELEVATER manifest (``vision_datasets.json``, a
    coco index, ``images.zip@member``) of all the classes and one of the
    first five (the few-shot drive's).  Returns the PNG bytes and labels in
    TSV order, and the in-memory uint8 images at ``IMAGE`` (the same pattern
    drawn at the decoded size: what needs no decode), which alone are made
    when not ``on_disk``."""
    import base64
    import zipfile

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(SEED + 14)
    out = {}
    for split, n in (("train", STREAM_TRAIN), ("test", STREAM_TEST)):
        labels = np.arange(n) % STREAM_CLASSES
        mem = np.stack([stream_image(i, np.random.RandomState(SEED + 15 + i), IMAGE, IMAGE)[0]
                        for i in range(n)])
        out[split] = {"labels": labels.astype(np.int64), "mem": mem}
        if not on_disk:
            continue
        pngs = []
        for i in range(n):
            h, w = STREAM_SIZES[i % len(STREAM_SIZES)]
            pngs.append(png_bytes(stream_image(i, rng, h, w)[0]))
        shards = STREAM_SHARDS if split == "train" else 1
        per = -(-n // shards)
        names = []
        for s in range(shards):
            names.append(f"{split}{s}.tsv")
            with open(os.path.join(root, names[-1]), "w") as f:
                for i in range(s * per, min(n, (s + 1) * per)):
                    f.write(f"{split}{i}\t{base64.b64encode(pngs[i]).decode()}\t{labels[i]}\n")
        for i, (b, c) in enumerate(zip(pngs, labels)):
            d = os.path.join(root, "folder", split, f"class{c:02d}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{i:05d}.png"), "wb") as f:
                f.write(b)
        out[split].update(png=pngs, tsv=names)
    if not on_disk:
        return out
    for name, classes in (("stream-10way", STREAM_CLASSES), ("stream-5way", 5)):
        folder = os.path.join(root, "elevater", name)
        os.makedirs(folder, exist_ok=True)
        entry = {"name": name, "type": "classification_multiclass", "root_folder": name,
                 "format": "coco"}
        for split in ("train", "test"):
            keep = [i for i, c in enumerate(out[split]["labels"]) if c < classes]
            with zipfile.ZipFile(os.path.join(folder, "images.zip"), "a") as z:
                for i in keep:
                    z.writestr(f"{split}/{i:05d}.png", out[split]["png"][i])
            index = {"images": [{"id": j + 1, "file_name": f"images.zip@{split}/{i:05d}.png"}
                                for j, i in enumerate(keep)],
                     "annotations": [{"id": j + 1, "image_id": j + 1,
                                      "category_id": int(out[split]["labels"][i]) + 1}
                                     for j, i in enumerate(keep)],
                     "categories": [{"id": c + 1, "name": f"pattern {c}"}
                                    for c in range(classes)]}
            with open(os.path.join(folder, f"{split}.json"), "w") as f:
                json.dump(index, f)
            entry[split] = {"index_path": f"{split}.json", "files_for_local_usage": ["images.zip"]}
        out[name] = entry
    with open(os.path.join(root, "elevater", "vision_datasets.json"), "w") as f:
        json.dump([out["stream-10way"], out["stream-5way"]], f)
    return out


def stream_cfg(root: str, source: str, **over):
    """``STREAM`` over the TSV shards, the ImageFolder tree or the zip
    manifest under ``root``."""
    src = {"tsv": {"DATASET.DATASET": "stream", "DATASET.ROOT": root,
                   "DATASET.TRAIN_TSV_LIST": [f"train{s}.tsv" for s in range(STREAM_SHARDS)],
                   "DATASET.TEST_TSV_LIST": ["test0.tsv"]},
           "folder": {"DATASET.DATASET": "stream", "DATASET.ROOT": f"{root}/folder",
                      "DATASET.TRAIN_SET": "train", "DATASET.TEST_SET": "test"},
           "zip": {"DATASET.DATASET": "stream-10way", "DATASET.ROOT": f"{root}/elevater",
                   "DATASET.TRAIN_SET": "", "DATASET.TEST_SET": ""}}[source]
    return driver_cfg({**STREAM, **FULLSHOT_DEPTH, **FULLSHOT_MODEL, **src,
                       "OUTPUT_DIR": f"{STREAM_DIR}/out",
                       **over}, FULLSHOT_YAML)


def _flat_batches(items) -> list:
    out = []
    for item in items:
        if len(item) == 3:
            out += [(item[0][j], item[1][j]) for j in range(item[0].shape[0])]
        else:
            out.append((item[0], item[1]))
    return out


def stream_source_checks(label: str, make_source, image_of, labels: np.ndarray) -> None:
    """A source's train epochs against their construction by hand, in the
    sampler's order with the flips of RandomState(seed + 7919 (epoch + 1)),
    each image ``image_of(i)`` normalised; ``batches(e, skip)`` against the
    uninterrupted epoch's tail, chunk-aligned (K = 1) and misaligned (K = 2);
    K = 2 chunks against the single batches."""
    from peft_vit_tpu_torch.data.samplers import build_order

    src = make_source(1, True)
    b, seed = src.batch, src.seed
    mean, std = src.mean, src.std
    bad = []
    for epoch in (0, 1):
        order = build_order(src.sampler, len(labels), epoch, seed, labels_fn=lambda: labels)
        rng = np.random.RandomState(seed + 7919 * (epoch + 1))
        got = _flat_batches(src.batches(epoch))
        for j, (x, y) in enumerate(got):
            idx = order[j * b:(j + 1) * b]
            want = np.stack([image_of(i) for i in idx]).astype(np.float32)
            flip = rng.rand(b) < 0.5
            want[flip] = want[flip, :, ::-1]
            want = (want - mean) / std
            if not (np.array_equal(x, want) and np.array_equal(y, labels[idx])):
                bad.append((epoch, j))
    check(not bad and len(got) == len(labels) // b,
          f"{label}: 2 epochs of {len(got)} normalised batches == the images in the sampler's "
          "order with RandomState(seed + 7919 (epoch + 1))'s flips, bit for bit"
          + (f"; differ: {bad[:4]}" if bad else ""))
    single = _flat_batches(src.batches(1))
    chunked = make_source(STREAM_K, True)
    pairs = _flat_batches(chunked.batches(1))
    same = len(pairs) == len(single) and all(
        np.array_equal(a, c) and np.array_equal(bb, d) for (a, bb), (c, d) in zip(pairs, single))
    check(same, f"{label}: K = {STREAM_K} chunks of epoch 1 == its single batches bit for bit "
          f"({len(pairs)} batches)")
    for k, src_k in ((1, src), (STREAM_K, chunked)):
        tail = _flat_batches(src_k.batches(1, skip_batches=STREAM_SKIP))
        same = len(tail) == len(single) - STREAM_SKIP and all(
            np.array_equal(a, c) and np.array_equal(bb, d)
            for (a, bb), (c, d) in zip(tail, single[STREAM_SKIP:]))
        check(same, f"{label}: batches(1, skip_batches={STREAM_SKIP}) at K = {k} "
              f"({'aligned' if STREAM_SKIP % k == 0 else 'misaligned'}) == the uninterrupted "
              f"epoch's last {len(single) - STREAM_SKIP} batches bit for bit")


@contextlib.contextmanager
def source_spy():
    """Within, every ``StreamingSource.batches`` item is counted per split."""
    from peft_vit_tpu_torch.data import streaming

    seen = {"train": 0, "test": 0, "dtypes": set()}
    original = streaming.StreamingSource.batches

    def spy(self, *args, **kwargs):
        for item in original(self, *args, **kwargs):
            seen[self.split] += item[0].shape[0] if len(item) == 3 else 1
            seen["dtypes"].add(str(item[0].dtype))
            yield item

    streaming.StreamingSource.batches = spy
    try:
        yield seen
    finally:
        streaming.StreamingSource.batches = original


def augment_card_check(tr, x: torch.Tensor, smi: str) -> dict:
    """The augmentation's arithmetic on the card against the same arithmetic
    on the CPU with the same draws and noise: each of the 16 ops (every image
    drawing it), then the whole transform; and the transform's time alone,
    captured."""
    from peft_vit_tpu_torch.data import augment as aug
    from peft_vit_tpu_torch.engine import StepGraph

    t = tr.transform
    g = torch.Generator().manual_seed(SEED + 16)
    xf = x.to(torch.float32)
    m = torch.clamp(9.0 + 0.5 * torch.randn(x.shape[0], generator=g), 0, 10)
    m = torch.where(torch.rand(x.shape[0], generator=g) < 0.5, -m, m)
    worst = {}
    for k, name in enumerate(aug.OPS):
        mk = m if aug.SIGNED[k] else m.abs()
        op = torch.full((x.shape[0],), k)
        mat = aug.affine_matrices(op, mk, x.shape[1], x.shape[2])  # on the host, as draw() does
        card = aug.apply_op(xf, op.to(x.device), mk.to(x.device), mat.to(x.device))
        cpu = aug.apply_op(xf.cpu(), op, mk, mat)
        worst[name] = (card.cpu() - cpu).abs().max().item()
    check(max(worst.values()) <= STREAM_AUG_TOL,
          f"streaming augment: each of the 16 RandAugment ops on the card against the CPU on the "
          f"first batch {tuple(x.shape)}, the geometric matrices from the host: max abs err "
          + (", ".join(f"{n} {e:.1e}" for n, e in worst.items() if e) + " (the others 0)"
             if any(worst.values()) else "0 for every op")
          + f" <= {STREAM_AUG_TOL:g} on the [0, 255] scale")
    draws = t.draw(g, x.shape)
    noise = torch.randn(x.shape, generator=g)
    card = t(x, {k: v.to(x.device) for k, v in draws.items()}, noise.to(x.device))
    cpu = t(x.cpu(), draws, noise)
    diff = (card.cpu() - cpu).abs() * 255.0 * min(t.std)
    share = (diff > STREAM_AUG_TOL).float().mean().item()
    check(diff.max().item() <= STREAM_AUG_TOL,
          f"streaming augment: the whole transform (flip, rand-m{t.magnitude:g}-mstd"
          f"{t.mag_std:g} x{t.num_ops}, erasing p={t.re_prob:g} {t.re_mode}, normalise) on the "
          f"card against the CPU, same draws and noise: max abs err {diff.max().item():.3e} on "
          f"the [0, 255] scale (share beyond {STREAM_AUG_TOL:g}: {share:.2e}) <= "
          f"{STREAM_AUG_TOL:g}")
    row = {"op_err": worst, "transform_err": diff.max().item()}
    if x.is_cuda:
        inputs = {"x": x, "d": {k: v.to(x.device) for k, v in draws.items()},
                  "n": noise.to(x.device)}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        graph = StepGraph(lambda b: t(b["x"], b["d"], b["n"]), inputs)
        row["peak_gib"] = (torch.cuda.max_memory_allocated() - before) / 2**30
        row["ms"] = _replay_ms(graph, 10)
        print(f"streaming augment alone on {tuple(x.shape)}: {row['ms']:.3f} ms a replay, "
              f"{row['peak_gib']:.2f} GiB of memory at its capture; {smi}", flush=True)
        del graph
    return row


def pinned_copy_ms(shape, reps: int = 20) -> float:
    """One (B, S, S, 3) uint8 batch's host -> card copy from a pinned buffer
    (the prefetch's copy), per batch, CUDA events."""
    host = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(shape, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    dev.copy_(host, non_blocking=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(side):
        start.record(side)
        for _ in range(reps):
            dev.copy_(host, non_blocking=True)
        end.record(side)
    end.synchronize()
    return start.elapsed_time(end) / reps


def streaming_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 14 (see the module docstring); ``device`` "cpu" rehearses the
    phase's own code at a tiny size (with the StepGraph stand-in patched in,
    only the launch checks fail there)."""
    import itertools
    import shutil

    from peft_vit_tpu_torch.commands import train as train_cmd
    from peft_vit_tpu_torch.data import native, registry
    from peft_vit_tpu_torch.data.streaming import ArrayLoader, StreamingSource, host_prefetch
    from peft_vit_tpu_torch.engine.trainer import Trainer
    from peft_vit_tpu_torch.peft import build_mask

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    shutil.rmtree(STREAM_DIR, ignore_errors=True)

    # 1. the native runtime: built from runtime/pvtio.cpp into build/
    t0 = time.perf_counter()
    try:
        lib = native.build()
        native_ok, why = native.native_available(), native.native_error()
    except RuntimeError as e:
        native_ok, why, lib = False, str(e), None
    built_s = time.perf_counter() - t0
    out["native"] = native_ok
    print(f"streaming native runtime: "
          + (f"{lib} built and loaded in {built_s:.2f} s" if native_ok else
             f"UNAVAILABLE after {built_s:.2f} s, the phase runs the narrowed path (the "
             f"augmentation in the captured step, the pinned prefetch and chunking over an "
             f"in-memory uint8 source, the samplers; no decode): {why}"), flush=True)

    # 2. the dataset, three layouts of the same PNGs (no PIL)
    root = f"{STREAM_DIR}/data"
    t0 = time.perf_counter()
    data = write_stream_dataset(root, on_disk=native_ok)
    print(f"streaming data: {STREAM_TRAIN} train and {STREAM_TEST} test images, "
          f"{STREAM_CLASSES} classes, "
          + (f"PNGs of {' / '.join(f'{h}x{w}' for h, w in STREAM_SIZES)} as {STREAM_SHARDS} TSV "
             "shards, an ImageFolder tree and an ELEVATER manifest" if native_ok else
             f"in memory at {IMAGE} px only (nothing to decode without the runtime)")
          + f", made in {time.perf_counter() - t0:.2f} s", flush=True)
    train, test = data["train"], data["test"]

    # 3. the source: its epochs by hand, resume, chunks; the three layouts alike
    if native_ok:
        cache = {}

        def decoded(i):
            if i not in cache:
                cache[i] = native.decode_resize(train["png"][i], IMAGE)
            return cache[i]

        def tsv_source(k, normalize):
            return StreamingSource(stream_cfg(root, "tsv"), "train", normalize=normalize,
                                   batch_multiplier=k)

        stream_source_checks("streaming source (TSV shards, native decode)", tsv_source, decoded,
                             train["labels"])
        n = STREAM_TRAIN
        seen = []
        for source in ("tsv", "folder", "zip"):
            src = StreamingSource(stream_cfg(root, source), "train", normalize=False)
            seen.append(sorted((int(y), x.tobytes()) for xs, ys, c in
                               src.loader.epoch(0, order=np.arange(n))
                               for x, y in zip(xs[:c], ys[:c])))
            src.close()
        check(len(seen[0]) == n and seen[0] == seen[1] == seen[2],
              f"streaming source: the ImageFolder tree and the zip manifest decode the {n} "
              "(image, label) pairs of the TSV shards, bit for bit")
        cache.clear()
        from peft_vit_tpu_torch.commands import test_io

        rate = test_io.measure([f"{root}/{s}" for s in train["tsv"]], IMAGE, FULLSHOT_BATCH,
                               int(STREAM["WORKERS"]))
        out["decode_images_per_s"] = rate["images_per_s"]
        print(f"streaming decode: NativeTsvLoader {rate['images_per_s']:.1f} images/s at "
              f"{IMAGE} px with {STREAM['WORKERS']} threads (PNG {STREAM_SIZES}), against the "
              f"full-shot step's consumption of ~{STREAM_STEP_CONSUMPTION:g} images/s at B = "
              f"{FULLSHOT_BATCH}; {smi}", flush=True)
        sources = None
        cfg = stream_cfg(root, "tsv")
    else:
        mem, labels = train["mem"], train["labels"]

        def mem_source(k, normalize, split="train"):
            d = data[split]
            return StreamingSource(
                stream_cfg(root, "tsv"), split, normalize=normalize, batch_multiplier=k,
                loader=ArrayLoader(d["mem"], d["labels"],
                                   (k if split == "train" else 1) * FULLSHOT_BATCH))

        stream_source_checks("streaming source (in-memory uint8, no decode)", mem_source,
                             lambda i: mem[i], labels)
        out["decode_images_per_s"] = None
        print(f"streaming decode: not measured (the native runtime is unavailable on this "
              f"machine); {smi}", flush=True)
        sources = (mem_source(STREAM_K, False), mem_source(1, False, "test"))
        cfg = stream_cfg(root, "tsv")

    # 4. train_main through the streaming branch with the timm augmentation
    shutil.rmtree(f"{STREAM_DIR}/out", ignore_errors=True)
    with source_spy() as fed:
        run = fullshot_drive("streaming", cfg, smi, device, sync,
                             sources=sources, out_dir=f"{STREAM_DIR}/out")
    tr = run["trainer"]
    spe = tr.steps_per_epoch
    steps = spe * int(cfg.TRAIN.END_EPOCH)
    n_eval = -(-STREAM_TEST // int(cfg.TEST.BATCH_SIZE_PER_GPU))
    layers = tr.model.backbone.layers
    check(fed["train"] == steps and fed["test"] == 2 * 2 * n_eval
          and fed["dtypes"] == {"uint8"} and tr.transform is not None,
          f"streaming full: train_main's batches came from StreamingSource "
          f"({'TSV shards through the native ring' if native_ok else 'an in-memory uint8 loader'}"
          f"): {fed['train']} train batches == {steps} steps, {fed['test']} eval batches == "
          f"2 epochs x (raw + EMA) x {n_eval}, raw {sorted(fed['dtypes'])}; the timm "
          "augmentation in the step")
    check(bool(tr.state.finite) and math.isfinite(run["best"]) and all(
        math.isfinite(e["loss"]) for e in run["epochs"]),
        f"streaming full: {steps} steps at B={cfg.TRAIN.BATCH_SIZE_PER_GPU} with RandAugment + "
        "random erasing in the step, finite losses "
        + " ".join(f"{e['loss']:.4f}" for e in run["epochs"]) + f", best top-1 {run['best']:.2f}")
    _hold_graphs("streaming full", tr, run["counts"],
                 {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                  "flash_attention_bwd_dkv": layers}, {"flash_attention_fwd": layers},
                 steps, 2 * int(cfg.TRAIN.END_EPOCH) * n_eval)
    final = {"trainable": {k: v.detach().clone() for k, v in tr.state.trainable.items()},
             "opt": {k: v.clone() for k, v in tr.state.opt_state.items()},
             "ema": {k: v.clone() for k, v in tr.state.ema.shadow.items()}}
    final_rng = (tr.generator.get_state(), tr.noise_generator.get_state())
    first = run["first"]
    x0 = first["x"] if torch.is_tensor(first["x"]) else torch.as_tensor(first["x"])
    kernel_err = hold_first_step("streaming full", tr, first, on_card)

    # 5. stopped in epoch 1 at its mid-epoch checkpoint, resumed by a fresh
    # Trainer that seeks in the source, against the uninterrupted run
    mask = build_mask(tr.model, "full", num_layers=layers)
    resume_dir = f"{STREAM_DIR}/resume"
    rcfg = stream_cfg(root, "tsv", **{"TRAIN.CHECKPOINT_EVERY_STEPS": STREAM_RESUME_AT})
    train_src = (sources[0] if sources is not None else
                 StreamingSource(rcfg, "train", normalize=False, batch_multiplier=STREAM_K))
    stopped = Trainer(rcfg, tr.model, mask, spe)
    stopped.train_one_epoch(host_prefetch(train_src.batches(0), depth=2), 0)
    stopped.train_one_epoch(itertools.islice(train_src.batches(1), STREAM_RESUME_AT // STREAM_K),
                            1, checkpoint_dir=resume_dir)
    del stopped
    resumed = Trainer(rcfg, tr.model, mask, spe)
    epoch0 = resumed.maybe_resume(resume_dir)
    at = resumed.resume_batch_in_epoch
    resumed.train_one_epoch(host_prefetch(train_src.batches(1, skip_batches=at), depth=2), 1,
                            start_batch=at)
    differ = _state_differ(resumed, final)
    same_rng = (torch.equal(resumed.generator.get_state(), final_rng[0])
                and torch.equal(resumed.noise_generator.get_state(), final_rng[1]))
    check((epoch0, at) == (1, STREAM_RESUME_AT) and not differ and same_rng,
          f"streaming full: stopped at epoch 1 batch {STREAM_RESUME_AT}, a fresh Trainer resumed at "
          f"epoch {epoch0} batch {at} (the source seeking past the trained prefix) == the "
          f"uninterrupted run bit for bit ({sum(len(v) for v in final.values())} state tensors, "
          "the host generator and the card's noise generator)"
          + (f"; differ: {differ[:4]}" if differ else ""))
    del resumed

    # 6. the augmentation on the card against the CPU; the step, the epoch,
    # the pinned copy
    row = {"steps": steps, "launches": run["counts"], "best": run["best"],
           "kernel_err": kernel_err, "epochs": [e["s"] for e in run["epochs"]],
           "per_replay": dict(_graphs_of(tr, "train")[0].launches)}
    row["augment"] = augment_card_check(tr, x0.to(device), smi)
    if on_card:
        graph = _graphs_of(tr, "train")[0]
        step_ms = _replay_ms(graph, 10)
        busy, n_launches, top = _device_breakdown(graph.graph.replay, reps=5)
        wall = []
        for e in (2, 3):  # steady epochs: every graph captured
            sync()
            t0 = time.perf_counter()
            tr.train_one_epoch(host_prefetch(train_src.batches(e), depth=2), e)
            sync()
            wall.append(time.perf_counter() - t0)
        epoch_busy, epoch_launches, _ = _device_breakdown(
            lambda: tr.train_one_epoch(host_prefetch(train_src.batches(4), depth=2), 4), reps=1)
        copy_ms = pinned_copy_ms((FULLSHOT_BATCH, IMAGE, IMAGE, 3))
        aug_ms = row["augment"]["ms"]
        epoch_s = statistics.median(wall)
        row.update(step_ms=step_ms, images_per_s=1e3 * FULLSHOT_BATCH / step_ms, busy_ms=busy,
                   device_launches=n_launches, aug_ms=aug_ms,
                   aug_share=None if busy is None else aug_ms / busy,
                   idle_share=None if busy is None else max(0.0, 1.0 - busy / step_ms),
                   epoch_s=epoch_s, epoch_busy_ms=epoch_busy,
                   epoch_idle_share=(None if epoch_busy is None
                                     else max(0.0, 1.0 - epoch_busy / (1e3 * epoch_s))),
                   copy_ms=copy_ms)
        print(f"streaming full step B={FULLSHOT_BATCH} (ViT-B/16 timm, bf16, SGD nesterov + EMA, "
              f"RandAugment x{tr.transform.num_ops} + erasing in the graph): captured "
              f"{step_ms:.3f} ms ({row['images_per_s']:.1f} images/s), device busy "
              + ("not measured" if busy is None else
                 f"{busy:.3f} ms in {n_launches:.0f} launches (idle share "
                 f"{row['idle_share']:.3f}); the augmentation alone {aug_ms:.3f} ms captured ("
                 f"{row['aug_share']:.3f} of the busy time)")
              + "; top: " + "; ".join(f"{n} {t:.3f} ms" for n, t in top) + f"; {smi}",
              flush=True)
        print(f"streaming epoch ({spe} steps from the source through host_prefetch and the "
              f"pinned prefetch): wall {epoch_s:.3f} s (median of {len(wall)}: "
              + ", ".join(f"{w:.3f}" for w in wall) + "), device busy "
              + ("not measured" if epoch_busy is None else
                 f"{epoch_busy / 1e3:.3f} s in {epoch_launches:.0f} launches (profiled epoch), "
                 f"idle share {row['epoch_idle_share']:.3f}")
              + f"; the pinned copy of a ({FULLSHOT_BATCH}, {IMAGE}, {IMAGE}, 3) uint8 batch "
              f"{copy_ms:.3f} ms ({FULLSHOT_BATCH * IMAGE * IMAGE * 3 / copy_ms / 1e6:.2f} GB/s); "
              f"{smi}", flush=True)
    out["full"] = row
    del run, tr, first, final
    if sources is None:
        train_src.close()
    gc_collect(on_card)

    # 7. finetune_main, the flagship LoRA config, on the 5-way ELEVATER manifest
    # (its images decode: it waits for the native runtime where that is missing)
    if not native_ok:
        print("streaming few-shot: finetune_main on the ELEVATER manifest not run on this "
              "machine: its images need the native decode, which is unavailable here "
              "(tests/test_torch_port_data_sources.py holds the drive against JAX on the CPU)",
              flush=True)
        shutil.rmtree(STREAM_DIR, ignore_errors=True)
        return out
    fcfg = driver_cfg({**DRIVER, **FLAGSHIP_DEPTH, **STREAM_FEWSHOT,
                       "DATASET.DATASET": "stream-5way",
                       "DATASET.ROOT": f"{root}/elevater", "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE]})
    from peft_vit_tpu_torch.data import prompts

    saved = dict(registry._INFO), dict(prompts._builtin_cache)
    try:
        loaded = registry.load_split(fcfg, "train")
        keep = [i for i, c in enumerate(train["labels"]) if c < 5]
        want = np.stack([native.decode_resize(train["png"][i], IMAGE) for i in keep])
        check(np.array_equal(loaded[0], want) and np.array_equal(loaded[1],
                                                                 train["labels"][keep]),
              f"streaming few-shot: the manifest's train split ({len(keep)} images of "
              f"images.zip@member) == decode_resize of each PNG in the index's order, bit for "
              "bit (the native decode)")
        del loaded, want
        tree = jax_layout_tree(np.random.RandomState(SEED + 17), 5)
        out["fewshot"] = drive("streaming few-shot (ELEVATER manifest)", fcfg, tree, smi,
                               device, want_cells=3, lr_grid=STREAM_FEWSHOT_LRS)
    finally:
        for live, copy in zip((registry._INFO, prompts._builtin_cache), saved):
            live.clear()
            live.update(copy)
    shutil.rmtree(STREAM_DIR, ignore_errors=True)
    return out


# ---------------------------------------------------------------- the ResNet family

RN_BATCH = 64  # r50_s3.yaml's TRAIN.BATCH_SIZE_PER_GPU
RN_PROBE_CELLS, RN_PROBE_CELL_BATCH = 3, 16  # a bitfit / full round of the RN50 tower
RN_PROBE_REPEATS = 3


def conv_signatures(model, x) -> list:
    """The distinct convolutions of one train-mode forward of ``model`` on
    ``x``: (x shape, w shape, stride, padding, groups, dtype), in order."""
    from peft_vit_tpu_torch.models import resnet as rn

    seen, real = [], rn._Conv2d.apply

    def spy(xx, w, stride, padding, groups):
        sig = (tuple(xx.shape), tuple(w.shape), stride, padding, groups, xx.dtype)
        if sig not in seen:
            seen.append(sig)
        return real(xx, w, stride, padding, groups)

    rn._Conv2d.apply = spy
    try:
        with torch.no_grad():
            model.train()(x)
    finally:
        rn._Conv2d.apply = real
    return seen


def conv_kind(w_shape, stride: int, groups: int) -> str:
    """A convolution's class in the determinism table: ``<k>x<k>/<stride>``,
    ``g`` appended for a grouped one."""
    k = int(w_shape[-1])
    return f"{k}x{k}/{int(stride)}" + ("g" if groups > 1 else "")


def conv_determinism_probe(signatures, label: str) -> list:
    """Each convolution's input and weight gradients computed
    ``RN_PROBE_REPEATS`` times on the same operands, channels-last as the
    towers give them, under the cuDNN algorithms ``_Conv2d`` runs for their
    dtype (``resnet.deterministic_backward``: the default ones for bf16, the
    deterministic ones for fp32).  Rows: the conv's kind, shapes, the
    algorithms and whether each gradient repeated bit for bit; each fails
    the run if one did not."""
    from peft_vit_tpu_torch.models import resnet as rn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for xs, ws, stride, padding, groups, dtype in signatures:
        x = torch.randn(xs, generator=gen, device="cuda").to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        w = (torch.randn(ws, generator=gen, device="cuda") / math.sqrt(
            ws[1] * ws[2] * ws[3])).to(dtype)
        out = torch.nn.functional.conv2d(x, w, None, stride, padding, 1, groups)
        g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=torch.channels_last)
        det = rn.deterministic_backward(dtype)
        row = {"kind": conv_kind(ws, stride, groups), "x": list(xs), "w": list(ws),
               "dtype": str(dtype).split(".")[-1],
               "form": "deterministic" if det else "default"}
        for which in ("dx", "dw"):
            outs = []
            for _ in range(RN_PROBE_REPEATS):
                with rn._cudnn(dtype, det):
                    if which == "dx":
                        outs.append(torch.nn.grad.conv2d_input(
                            x.shape, w, g, stride, padding, 1, groups))
                    else:
                        outs.append(torch.nn.grad.conv2d_weight(
                            x, w.shape, g, stride, padding, 1, groups))
            row[f"{which}_repeats"] = all(torch.equal(outs[0], o) for o in outs[1:])
        rows.append(row)
        print(f"determinism {label} {row['kind']} x {xs} w {ws} {row['dtype']}: dx repeats "
              f"{row['dx_repeats']}, dw repeats {row['dw_repeats']}; form: cuDNN's "
              f"{row['form']}", flush=True)
    bad = [f"{r['kind']} w {r['w']}" for r in rows if not (r["dx_repeats"] and r["dw_repeats"])]
    forms = sorted({r["form"] for r in rows})
    check(not bad, f"determinism {label}: {len(rows)} convolutions' dx and dw repeat bit for "
          f"bit under cuDNN's {' and '.join(forms)} algorithms (the form `_Conv2d` runs for "
          "their dtype)" + (f"; not: {bad[:4]}" if bad else ""))
    return rows


def _grouped(signatures, cells: int) -> list:
    """The grouped convolutions a round of ``cells`` makes of per-cell
    weights (``_Conv2d``'s batching rule): the cells' channels side by side."""
    out = []
    for xs, ws, stride, padding, groups, dtype in signatures:
        out.append(((xs[0], xs[1] * cells, *xs[2:]), (ws[0] * cells, *ws[1:]), stride,
                    padding, groups * cells, dtype))
    return out


def determinism_phase() -> dict:
    """The determinism probe over every convolution of the ResNet-50 v1
    full-shot step (B = 64, 224 px, bf16), of the CLIP RN50 tower (a round's
    folded batch, and the grouped convs of per-cell weights) and of ConvViT
    and CSwin (``convvit_signatures``; Swin's patch embedding is
    ``vit._PatchConv``, a fixed-order weight gradient)."""
    from peft_vit_tpu_torch.models.clip_resnet import ModifiedResNet
    from peft_vit_tpu_torch.models.resnet import resnet50

    torch.manual_seed(SEED)
    x = torch.randn(RN_BATCH, IMAGE, IMAGE, 3, device="cuda")
    r50 = resnet50(dtype=torch.bfloat16, device="cuda")
    sig50 = conv_signatures(r50, x)
    del r50
    clip = ModifiedResNet(dtype=torch.bfloat16, device="cuda")
    xc = torch.randn(RN_PROBE_CELLS * RN_PROBE_CELL_BATCH, IMAGE, IMAGE, 3, device="cuda")
    sigc = conv_signatures(clip, xc)
    sigg = _grouped(conv_signatures(clip, xc[:RN_PROBE_CELL_BATCH]), RN_PROBE_CELLS)
    del clip
    rows = {"resnet50": conv_determinism_probe(sig50, "resnet50"),
            "rn50_round": conv_determinism_probe(sigc, "rn50_round"),
            "rn50_grouped": conv_determinism_probe(sigg, "rn50_grouped"),
            "convvit": conv_determinism_probe(convvit_signatures(), "convvit")}
    gc_collect(True)
    return rows


RN_CLIP_YAML = "peft_vit_tpu/resources/model/rn50_CLIP.yaml"
R50_YAML = "peft_vit_tpu/resources/model/r50_s3.yaml"
RN_EMBED = 1024  # rn50_CLIP.yaml's EMBED_DIM: the pool's output and the text projection's
RN_CLIP = {"TPU.COMPUTE_DTYPE": "bfloat16"}
RN_MODEL: dict = {}  # overrides of the RN50 tower (a CPU rehearsal shrinks it here)
# r50_s3.yaml's recipe (SGD nesterov, warmup-cosine, mixup 0.2 / cutmix 1.0,
# label smoothing 0.1) on synthetic 10-way at 224 px, B = 64, 2 epochs of 2
# steps, with DropBlock on stages 3 and 4 at keep 0.9, block 7: stage 3's
# 14 x 14 maps take the min-pool branch, stage 4's 7 x 7 the whole-map one.
# The warm-up is cut from 5 epochs to 1, the lr from 0.4 to 0.02 (random
# weights: at 0.1 the second epoch's loss rose to 32 on the H100).
R50_FULLSHOT = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 10,
                "MODEL.NUM_CLASSES": 10, "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE],
                "PEFT.METHOD": "none", "TEST.BATCH_SIZE_PER_GPU": RN_BATCH,
                "TRAIN.BATCH_SIZE_PER_GPU": RN_BATCH, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 0.02,
                "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True,
                "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "AUG.DROPBLOCK_KEEP_PROB": 0.9,
                "AUG.DROPBLOCK_LAYERS": [3, 4], "AUG.DROPBLOCK_BLOCK_SIZE": 7,
                "TRAIN.CHECKPOINT_EVERY_STEPS": 0, "TRAIN.AUTO_RESUME": False,
                "TPU.COMPUTE_DTYPE": "bfloat16", "PRINT_FREQ": 1, "NAME": "resnet50"}
R50_MODEL: dict = {}  # overrides of the ResNet-50 (a CPU rehearsal shrinks it here)
RN_CONFIG_OVER: dict = {}  # overrides of every config of rn_configs_check (likewise)
R50_DIR = "build/resnet"  # checkpoints and logs, removed after the phase
R50_FLOPS_PER_IMAGE = 3 * 4.1e9  # a ResNet-50 forward at 224 px is 4.1 GFLOP; fwd + bwd ~3x
RN_UPDATE_BN_BATCHES = 2
# The RN50 CLIP tower in bf16 on the card against fp32 on the CPU, max |logit
# diff| / max |logit| of a 5-image request through the prototype head: bf16
# rounds each conv output and BN input at ~4e-3 relative through 16
# random-weight bottlenecks (eval BN on random statistics normalizes nothing,
# so the activations grow block by block) and the pool's softmax.  The first
# measurement on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): 0.399, top-1
# equal; the same model in bf16 on the CPU, with no card, is printed beside
# it as the yardstick.  Bound 0.6.
TOL_RN_BF16_LOGITS_REL = 0.6
# fp32 on the card against the CPU: the same arithmetic summed in other orders
# (cuDNN's convolutions against the CPU's), TF32 off for fp32 operands.
TOL_RN_F32_LOGITS_REL = 1e-3
# The tiny fp32 few-shot drive on the RN tower, card against CPU: the choice
# and the score equal, as the ViT's tiny drive.
RN_TINY_DRIVER = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4,
                  "DATASET.NUM_SAMPLES_PER_CLASS": 8, "TRAIN.IMAGE_SIZE": [32, 32],
                  "TRAIN.BATCH_SIZE_PER_GPU": 8, "TRAIN.END_EPOCH": 2, "TRAIN.SCHEDULE": [],
                  "MODEL.NAME": "RN50", "MODEL.SPEC.EMBED_DIM": 16,
                  "MODEL.SPEC.VISION.MODEL": "resnet", "MODEL.SPEC.VISION.WIDTH": 8,
                  "MODEL.SPEC.VISION.LAYERS": [1, 1, 1, 1], "MODEL.SPEC.VISION.HEADS": 4,
                  "MODEL.SPEC.TEXT.WIDTH": 16, "MODEL.SPEC.TEXT.HEADS": 2,
                  "MODEL.SPEC.TEXT.LAYERS": 1, "PEFT.METHOD": "bitfit",
                  "TPU.COMPUTE_DTYPE": "float32", "TRAIN.SEARCH_WD_LOG_UPPER": -2}
RN_TINY_LRS = (1e-3, 3e-2)
# Leaves of the RN50 classifier whose gradient is zero in exact arithmetic
# under the train-mode channel BN: the pool's value and output biases shift
# every image's feature by one vector, which the BN subtracts with the batch
# mean, and the key bias adds one number to every score of a query row, which
# the softmax ignores.  Their bf16 gradient is rounding alone, so no cosine
# holds them: printed, not held (as the ViT's ln_post bias, ZERO_GRAD).
RN_ZERO_GRAD = ("backbone.attnpool.k_proj.bias", "backbone.attnpool.v_proj.bias",
                "backbone.attnpool.c_proj.bias")


def rn_numpy_state(model, rng: np.random.RandomState) -> dict:
    """Every parameter and statistic of ``model`` drawn from ``rng`` (its
    state_dict's names and shapes): conv and dense weights at 1 / sqrt(fan
    in), norm scales near 1, biases and means near 0, variances in [0.5,
    1.5], the pool's positional embedding at 1 / sqrt(C)."""
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) >= 2:
            a = rng.standard_normal(shape) / math.sqrt(int(np.prod(shape[1:])))
        elif leaf == "weight":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bn_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "positional_embedding":
            a = rng.standard_normal(shape) / math.sqrt(shape[-1])
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def _rn_clip(num_classes: int, dtype: str, device: str):
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import PEFTSpec

    cfg = driver_cfg({**RN_CLIP, **RN_MODEL, "TPU.COMPUTE_DTYPE": dtype}, RN_CLIP_YAML)
    return cfg, build_image_classifier(cfg, PEFTSpec(), num_classes, device=device)


def rn_serving_check(smi: str, device: str) -> dict:
    """The RN50 CLIP classifier (rn50_CLIP.yaml: width 64, layers 3/4/6/3, the
    pool over 7 x 7 + 1 tokens in 32 heads of 64, embed 1024) at 224 px,
    weights from a numpy seed and a prototype head, through ``ServingSession``
    (bf16, buckets 1, 8 and 32): captured == eager bit for bit, no kernel
    launched, top-1 and the logits against fp32 on the CPU, fp32 on the card
    against the CPU, each bucket's latency."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.ops import launch_counts

    from peft_vit_tpu_torch.models import ImageClassifier, ModifiedResNet

    rng = np.random.RandomState(SEED + 60)
    cfg, (cpu_model, _, _) = _rn_clip(NUM_CLASSES, "float32", "cpu")
    state = rn_numpy_state(cpu_model, rng)
    size = cpu_model.backbone.attnpool.positional_embedding.shape[0]
    image = int(round((size - 1) ** 0.5)) * 32
    requests = {n: rng.standard_normal((n, image, image, 3)).astype(np.float32)
                for n in REQUESTS}
    checked = requests[CHECKED_REQUEST]
    cpu_model.load_state_dict(state)
    cpu_model.eval()
    with torch.no_grad():
        feats = cpu_model.backbone(torch.from_numpy(checked)).numpy()
    # the prototype head: class c's row image c's centred feature, scaled so
    # that the CPU's logit of image c for class c is 10
    d = feats - feats.mean(axis=0)
    rows = 10.0 * d / (d * d).sum(axis=1, keepdims=True)
    head_w = state["classifier.head.weight"].numpy().copy()
    head_b = state["classifier.head.bias"].numpy().copy()
    head_w[:len(feats)] = rows
    head_b[:len(feats)] = -(rows @ feats.mean(axis=0))
    state["classifier.head.weight"] = torch.from_numpy(head_w)
    state["classifier.head.bias"] = torch.from_numpy(head_b)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        cpu_logits = cpu_model(torch.from_numpy(checked)).numpy()
    del cpu_model
    # the yardstick: the same weights in bf16 on the CPU
    t0 = time.perf_counter()
    tower = cfg.MODEL.SPEC
    cpu_bf16 = ImageClassifier(ModifiedResNet(
        layers=tuple(tower.VISION.LAYERS), output_dim=int(tower.EMBED_DIM),
        heads=int(tower.VISION.HEADS), image_size=image, width=int(tower.VISION.WIDTH),
        dtype=torch.bfloat16, device="cpu"), NUM_CLASSES, dtype=torch.bfloat16, device="cpu")
    cpu_bf16.load_state_dict(state)
    with torch.no_grad():
        drift_cpu = _rel(cpu_bf16.eval()(torch.from_numpy(checked)).float().numpy(), cpu_logits)
    del cpu_bf16
    print(f"rn50 serving: bf16 on the CPU (no card) vs fp32 CPU: max |logit diff| / max |logit| "
          f"= {drift_cpu:.4e} ({time.perf_counter() - t0:.1f} s)", flush=True)
    _, (model, _, _) = _rn_clip(NUM_CLASSES, "bfloat16", device)
    model.load_state_dict(state)
    before = launch_counts()  # counts from 0 just before the main path, read just after
    session = ServingSession(model, None, image, buckets=BUCKETS, device=device)
    logits = {n: session.predict(x) for n, x in requests.items()}
    counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    check(counts == {} and all(bool(np.isfinite(v).all()) for v in logits.values()),
          f"rn50 serving: {len(requests)} requests, finite logits; kernels launched {counts} "
          "(none: convolutions, pools and BN are library calls, the pool plain PyTorch)")
    with bench_torch.eager_on_card():
        _, (model_e, _, _) = _rn_clip(NUM_CLASSES, "bfloat16", device)
        model_e.load_state_dict(state)
        eager = ServingSession(model_e, None, image, buckets=BUCKETS, device=device)
        same = [n for n, x in requests.items() if np.array_equal(eager.predict(x), logits[n])]
    check(len(same) == len(requests),
          f"rn50 serving: captured buckets == eager bit for bit on {len(same)} of "
          f"{len(requests)} requests")
    del eager, model_e
    got = logits[CHECKED_REQUEST]
    rel = _rel(got, cpu_logits)
    top, top_cpu = got.argmax(1), cpu_logits.argmax(1)
    check(bool((top == top_cpu).all()) and rel <= TOL_RN_BF16_LOGITS_REL,
          f"rn50 serving: bf16 card top-1 {top.tolist()} == fp32 CPU {top_cpu.tolist()}; max "
          f"|logit diff| / max |logit| {rel:.4e} <= {TOL_RN_BF16_LOGITS_REL:g} (bf16 CPU: "
          f"{drift_cpu:.4e})")
    _, (m32, _, _) = _rn_clip(NUM_CLASSES, "float32", device)
    m32.load_state_dict(state)
    card32 = make_infer_fn(m32, None)(torch.from_numpy(checked).to(device)).cpu().numpy()
    rel32 = _rel(card32, cpu_logits)
    check(rel32 <= TOL_RN_F32_LOGITS_REL and bool((card32.argmax(1) == top_cpu).all()),
          f"rn50 serving: fp32 card vs fp32 CPU max |logit diff| / max |logit| {rel32:.4e} <= "
          f"{TOL_RN_F32_LOGITS_REL:g}, top-1 equal")
    del m32
    latency = _serving_latency(session, "rn50 bf16", rng, smi) if device == "cuda" else {}
    return {"bf16_rel": rel, "bf16_cpu_rel": drift_cpu, "f32_rel": rel32, "latency_ms": latency,
            "launches": counts}


def rn_zeroshot_check(smi: str, device: str) -> dict:
    """``zeroshot_main`` on rn50_CLIP.yaml at 224 px in bf16, the towers from
    numpy seeds (the text tower of width 512, 12 blocks of 8 heads, context 77,
    projecting to 1024): finite score; the wrappers count K1 12 times a text
    forward (the causal bias) and nothing for the RN tower."""
    from peft_vit_tpu_torch.commands import zeroshot_eval
    from peft_vit_tpu_torch.data.prompts import class_map, register_prompts, template_map
    from peft_vit_tpu_torch.models import params_to_jax
    from peft_vit_tpu_torch.ops import attention as attn

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.RandomState(SEED + 61)
    register_prompts("synthetic", class_map(ZS_DATASET)[:ZS_CLASSES], template_map(ZS_DATASET))
    text = text_tree(rng)
    w = text["params"]["text_projection"].shape[0]
    text["params"]["text_projection"] = (rng.standard_normal((w, RN_EMBED)) / math.sqrt(w)
                                         ).astype(np.float32)
    cfg = driver_cfg({**RN_CLIP, **RN_MODEL, **ZS}, RN_CLIP_YAML)
    # the RN tower's weights from the numpy seed, in the JAX layout of the seam
    _, (cpu_model, _, _) = _rn_clip(ZS_CLASSES, "float32", "cpu")
    variables = params_to_jax(rn_numpy_state(cpu_model, np.random.RandomState(SEED + 62)))
    del cpu_model
    _zero_attention_counts(attn)  # counts from 0 just before the main path, read just after
    t0 = time.perf_counter()
    score = zeroshot_eval.zeroshot_main(cfg, device=device, variables=variables,
                                        text_variables=text)
    sync()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in _attention_counts(attn).items() if n}
    want = {"flash_attention_fwd": TEXT_LAYERS * ZS_CLASSES} if device == "cuda" else {}
    check(math.isfinite(score) and counts == want,
          f"rn50 zeroshot_main bf16: score {score:.3f}, {ZS_CLASSES} classes; launched {counts} "
          f"== K1 {TEXT_LAYERS} a text forward (causal bias) x {ZS_CLASSES} classes, none in "
          f"the RN tower; {wall:.2f} s (host clock; {smi})")
    return {"launches": counts.get("flash_attention_fwd", 0), "wall_s": wall, "score": score}


def rn_round_check(smi: str, device: str) -> dict:
    """A captured round of 3 bitfit cells on the RN50 CLIP tower
    (``cnn_round_check``)."""
    cfg = driver_cfg({**RN_CLIP, **RN_MODEL, "PEFT.METHOD": "bitfit"}, RN_CLIP_YAML)
    return cnn_round_check("rn50 bitfit", cfg, "bitfit", 4, SEED + 63, SEED + 64, RN_ZERO_GRAD,
                           smi, device)


def cnn_round_check(label: str, cfg, method: str, num_layers: int, state_seed: int,
                    data_seed: int, zero_grad, smi: str, device: str) -> dict:
    """A captured round of 3 ``method`` cells on the BatchNorm tower of
    ``cfg`` (bf16, B=16, the channel-BN head, every BN statistic per cell,
    the tower's BN in train mode as the few-shot step runs it; the weights
    from ``RandomState(state_seed)``): one step equal to it eager bit for
    bit, statistics included; no kernel launched; the round's time; each
    cell against the same cell trained alone, through float64
    (``_round_exact``; ``zero_grad``: the leaves whose gradient is zero in
    exact arithmetic, left out of the bf16 comparison)."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn, step_decay_lr)
    from peft_vit_tpu_torch.models import build_image_classifier, cast_frozen_
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params

    model = build_image_classifier(cfg, spec_from_config(cfg), NUM_CLASSES, use_bn=True,
                                   device=device)[0]
    model.load_state_dict(rn_numpy_state(model, np.random.RandomState(state_seed)))
    mask = build_mask(model, method, num_layers=num_layers)
    trainable, _ = split_params(model, mask)
    cast_frozen_(model)
    apply_fn = make_apply_fn(model)
    bn = {k: v for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    k = len(ROUND_LRS)
    rng = np.random.RandomState(data_seed)
    image = int(cfg.TRAIN.IMAGE_SIZE[0])
    x = torch.as_tensor(rng.standard_normal((TRAIN_BATCH, image, image, 3)).astype(np.float32),
                        device=device)
    y = torch.as_tensor(rng.randint(0, NUM_CLASSES, TRAIN_BATCH), device=device)
    valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device)
    perm, lrs, wds = np.arange(TRAIN_BATCH), step_decay_lr(ROUND_LRS, 0, ()), torch.tensor(
        ROUND_WDS)
    draws = [{n: v.detach() * (1.0 + 0.1 * torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32)).to(v.device)) for n, v in trainable.items()}
        for _ in range(k)]
    start = {n: torch.stack([d[n] for d in draws]) for n in draws[0]}
    state = init_cell_state(start, {n: v.expand(k, *v.shape) for n, v in bn.items()})
    graphs = {}
    epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True,
                          graphs=graphs)
    before = launch_counts()
    captured, loss = epoch(state, {}, x, y, valid, perm, lrs, wds)
    counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    with bench_torch.eager_on_card():
        eager, eager_loss = epoch(state, {}, x, y, valid, perm, lrs, wds)
    parts = ("trainable", "momentum", "bn")
    differ = [f"{part}.{n}" for part in parts for n, v in getattr(eager, part).items()
              if not torch.equal(v, getattr(captured, part)[n])]
    n_state = sum(len(getattr(eager, part)) for part in parts)
    check(not differ and torch.equal(loss, eager_loss) and bool(loss.isfinite().all()),
          f"{label}: a round of {k} cells, one step at B={TRAIN_BATCH}, captured == eager "
          f"bit for bit ({n_state} state tensors: {len(start)} trainable leaves, their momentum, "
          f"{len(bn)} BN statistics; losses " + " ".join(f"{float(v):.4f}" for v in loss) + ")"
          + (f"; differ: {differ[:4]}" if differ else ""))
    graph = graphs.get(("step", k, TRAIN_BATCH))
    want = launch_rule(model, trainable, k)
    if device == "cuda":
        _per_replay(graph, want, f"{label}: one step of a round of {k}")
    check(counts == {}, f"{label} round: kernels launched {counts} (none)")
    one = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True)
    cos, alone = {}, []
    with bench_torch.eager_on_card():
        for c in range(k):
            alone.append(one(init_cell_state(draws[c], bn), {}, x, y, valid, perm, lrs[c],
                             wds[c])[0])
            for n, v in alone[c].momentum.items():
                cos[(c, n)] = torch.nn.functional.cosine_similarity(
                    v.double().flatten(), captured.momentum[n][c].double().flatten(), dim=0).item()
    least = min(cos, key=cos.get)
    print(f"{label} bf16: each of {k} cells against the cell trained alone, momentum "
          f"cosine per leaf: least {cos[least]:.6f} (cell {least[0]}, {least[1]}), median "
          f"{statistics.median(cos.values()):.6f}; printed, not held: the round's convs see a "
          "batch of 48 against 16 and round their bf16 outputs otherwise, and on this "
          "random-weight tower the BN biases' gradients are rounding-dominated (the float64 "
          "comparison below is held)", flush=True)
    row = {"round_ms": None, "launches": counts, "bf16_least_cos": cos[least]}
    if device == "cuda" and graph is not None:
        row["round_ms"] = _replay_ms(graph, 5)
        print(f"{label} round of {k} at B={TRAIN_BATCH}: captured {row['round_ms']:.3f} ms a "
              f"step ({k * TRAIN_BATCH / row['round_ms'] * 1e3:.1f} cell-images/s); {smi}",
              flush=True)
    del graphs, graph, epoch
    gc_collect(device == "cuda")
    row["exact"] = _round_exact(label, model, draws, bn, x, y, valid, perm, lrs, wds,
                                {"round": captured, "alone": alone}, zero_grad, device)
    del captured, eager, model
    return row


def _as_float64(model):
    """``model`` computing in float64: every module's compute dtype, its
    parameters and its statistics (the norms compute in at least fp32, so in
    float64 here)."""
    for m in model.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, torch.float64)
    return model.double()


def _round_exact(label: str, model, draws, bn, x, y, valid, perm, lrs, wds, bf16_round,
                 zero_grad, device: str):
    """The round of ``cnn_round_check`` against float64 on the card:
    the float64 round equal to its cells trained alone in float64 (max |diff|
    <= 1e-9 of each state tensor's largest change over the step: a cell's lr,
    wd, state or batch taken for another's shows); the bf16 round's update
    (its momentum after the step, the gradient plus wd p) against the
    float64 one no farther than the bf16 cells trained alone
    (``TOL_METHOD_EXACT_RATIO`` x their mean 1 - cosine +
    ``TOL_METHOD_EXACT_FLOOR``), the leaves of ``zero_grad`` left out."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn)

    k = len(draws)
    m64 = _as_float64(model)
    apply64 = make_apply_fn(m64)
    d64 = [{n: v.double() for n, v in d.items()} for d in draws]
    bn64 = {n: v.double() for n, v in bn.items()}
    x64 = x.double()
    with bench_torch.eager_on_card():
        one = make_epoch_fn(apply64, ce_per_example, TRAIN_BATCH, has_bn=True)
        alone = [one(init_cell_state(d64[c], bn64), {}, x64, y, valid, perm, lrs[c], wds[c])[0]
                 for c in range(k)]
        state = init_cell_state({n: torch.stack([d[n] for d in d64]) for n in d64[0]},
                                {n: v.expand(k, *v.shape) for n, v in bn64.items()})
        end = make_epoch_fn(apply64, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True)(
            state, {}, x64, y, valid, perm, lrs, wds)[0]
    worst = (0.0, None)
    for c in range(k):
        for part in ("trainable", "momentum", "bn"):
            for name, v in getattr(alone[c], part).items():
                s0 = (d64[c] if part == "trainable" else bn64 if part == "bn" else {}).get(
                    name, torch.zeros_like(v))
                change = (v - s0).abs().max().item()
                diff = (getattr(end, part)[name][c] - v).abs().max().item()
                ratio = diff / change if change else (0.0 if diff == 0 else math.inf)
                if ratio > worst[0]:
                    worst = (ratio, f"cell {c} {part} {name}")
    check(worst[0] <= 1e-9,
          f"{label} float64: a round of {k} against its cells trained alone, every state "
          f"tensor's change over one step: max |diff| / max |change| {worst[0]:.3e} <= 1e-9 "
          f"({worst[1]})")
    miss = {"round": [], "alone": []}
    for c in range(k):
        for name, exact in alone[c].momentum.items():
            if name in zero_grad:
                continue
            e = exact.double().flatten()
            miss["round"].append(1.0 - torch.nn.functional.cosine_similarity(
                bf16_round["round"].momentum[name][c].double().flatten(), e, dim=0).item())
            miss["alone"].append(1.0 - torch.nn.functional.cosine_similarity(
                bf16_round["alone"][c].momentum[name].double().flatten(), e, dim=0).item())
    got, base = statistics.fmean(miss["round"]), statistics.fmean(miss["alone"])
    check(got <= TOL_METHOD_EXACT_RATIO * base + TOL_METHOD_EXACT_FLOOR,
          f"{label} bf16: the round's update against float64, {len(miss['round'])} (cell, "
          f"leaf) pairs: mean 1 - cosine {got:.3e} <= {TOL_METHOD_EXACT_RATIO:g} x the cells "
          f"trained alone's {base:.3e} + {TOL_METHOD_EXACT_FLOOR:g}")
    del m64
    return {"float64_worst": worst[0], "bf16_round_miss": got, "bf16_alone_miss": base}


def dropblock_card_check(smi: str, device: str) -> dict:
    """DropBlock on the card against its plain version on the CPU with the
    same noise, at the ResNet-50 step's two DropBlock shapes (stage 3: (64,
    1024, 14, 14), the min-pool branch; stage 4: (64, 2048, 7, 7), the
    whole-map one), bf16, keep 0.9 at block 7: equal bit for bit; the op's
    time on the card."""
    from peft_vit_tpu_torch.ops.dropblock import drop_block

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = {}
    for shape in ((RN_BATCH, 1024, 14, 14), (RN_BATCH, 2048, 7, 7)):
        x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        u = torch.rand(shape, generator=gen, device=device)
        got = drop_block(x, block_size=7, keep_prob=0.9, noise=u)
        want = drop_block(x.cpu(), block_size=7, keep_prob=0.9, noise=u.cpu())
        same = torch.equal(got.cpu(), want)
        dropped = float((want == 0).float().mean())
        ms = None
        if device == "cuda":
            ms = _device_ms(lambda: drop_block(x, block_size=7, keep_prob=0.9, noise=u), 20)
        check(same, f"dropblock {shape} bf16 keep 0.9 block 7: card == CPU bit for bit "
              f"({dropped:.4f} of the elements dropped)"
              + ("" if ms is None else f"; {ms:.4f} ms on the card ({smi})"))
        rows[str(shape)] = {"ms": ms, "dropped": dropped}
    return rows


def r50_fullshot_check(smi: str, device: str) -> dict:
    """``train_main`` on r50_s3.yaml's ResNet-50 v1 with DropBlock (see
    ``R50_FULLSHOT``), through ``cnn_fullshot_check``."""
    cfg = driver_cfg({**R50_FULLSHOT, **R50_MODEL, "OUTPUT_DIR": R50_DIR}, R50_YAML)
    return cnn_fullshot_check("resnet50", cfg, R50_DIR, R50_FLOPS_PER_IMAGE, "bn1",
                              "SGD nesterov, mixup/cutmix, DropBlock", smi, device)


def cnn_fullshot_check(label: str, cfg, out_dir: str, flops_per_image, stem_bn: str,
                       recipe: str, smi: str, device: str, resume: bool = True,
                       profile_reps: int = 3) -> dict:
    """``train_main`` on the BatchNorm tower of ``cfg`` (DropBlock when it
    asks): every step and eval batch one replay, no kernel launched
    (``launch_rule``), finite losses; the first step captured == eager bit
    for bit, BN statistics included; with ``resume``, a run stopped after
    its first mid-epoch checkpoint and resumed == the uninterrupted run bit
    for bit (trainable, momentum, BN statistics, a drop generator's state),
    and ``update_bn`` against the batch means of the BN at ``stem_bn`` (a
    module path under the backbone); the step's time and, profiled over
    ``profile_reps`` replays (0: not profiled), its busy time and idle
    share, beside the bound of ``flops_per_image`` (None: 3 x the
    convolutions' FLOPs of one forward, ``conv_macs``)."""
    import shutil

    import bench_torch

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    run = fullshot_drive(label, cfg, smi, device, sync, out_dir=out_dir)
    tr, splits = run["trainer"], run["splits"]
    spe = tr.steps_per_epoch
    steps = spe * int(cfg.TRAIN.END_EPOCH)
    n_eval = -(-len(splits.y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
    final = {"trainable": {k: v.detach().clone() for k, v in tr.state.trainable.items()},
             "opt": {k: v.clone() for k, v in tr.state.opt_state.items()},
             "bn": {k: v.clone() for k, v in tr.state.batch_stats.items()}}
    dropblock = float(cfg.AUG.get("DROPBLOCK_KEEP_PROB", 1.0)) < 1.0
    drop_final = tr.drop_generator.get_state() if dropblock else None
    check(bool(tr.state.finite) and all(math.isfinite(e["loss"]) for e in run["epochs"])
          and tr.use_dropblock == dropblock and len(tr.state.batch_stats) > 0,
          f"{label} full-shot: {steps} steps at B={batch}"
          + (" with DropBlock" if dropblock else "") + ", finite losses "
          + " ".join(f"{e['loss']:.4f}" for e in run["epochs"])
          + f", {len(tr.state.batch_stats)} BN statistics, best top-1 {run['best']:.2f}")
    rule = launch_rule(tr.model, tr.state.trainable)
    _hold_graphs(f"{label} full-shot", tr, run["counts"], rule, rule, steps,
                 int(cfg.TRAIN.END_EPOCH) * n_eval)
    check(not any(run["counts"].values()),
          f"{label} full-shot: K1-K7 launched 0 times on the vision path ({run['counts']})")
    first = run["first"]
    captured = {part: dict(leaves) for part, leaves in first["after"].items()}
    with bench_torch.eager_on_card():
        _rerun_first_step(tr, first)
    differ = _state_differ(tr, captured)
    n_state = sum(len(v) for v in captured.values())
    check(not differ, f"{label} full-shot: the first step captured == eager bit for bit "
          f"({n_state} state tensors: trainable, momentum, BN statistics"
          + ("; DropBlock drawn from the registered generator" if dropblock else "") + ")"
          + (f"; differ: {differ[:4]}" if differ else ""))
    row = {"steps": steps, "launches": run["counts"], "best": run["best"],
           "per_replay": dict(_graphs_of(tr, "train")[0].launches), "wall_s": run["wall_s"],
           "peak_gib": run["peak_gib"]}
    if resume:
        _resume_and_update_bn(label, cfg, tr, run["first"]["before"], splits, final, drop_final,
                              stem_bn, steps)
    shutil.rmtree(out_dir, ignore_errors=True)
    if flops_per_image is None:
        image = int(cfg.TRAIN.IMAGE_SIZE[0])
        flops_per_image = 3 * 2 * conv_macs(tr.model.backbone, torch.zeros(
            1, image, image, 3, device=device))
    if on_card:
        graph = _graphs_of(tr, "train")[0]
        step_ms = _replay_ms(graph, 5)
        busy, n_launches, top = (_device_breakdown(graph.graph.replay, reps=profile_reps)
                                 if profile_reps else (None, None, []))
        row.update(step_ms=step_ms, images_per_s=1e3 * batch / step_ms, busy_ms=busy,
                   device_launches=n_launches,
                   idle_share=None if busy is None else max(0.0, 1.0 - busy / step_ms),
                   bound_ms=batch * flops_per_image / BF16_FLOPS_PER_S * 1e3)
        print(f"{label} full-shot step B={batch} (bf16, {recipe}): captured {step_ms:.3f} ms "
              f"({row['images_per_s']:.1f} images/s), device busy "
              + ("not measured" if busy is None else
                 f"{busy:.3f} ms in {n_launches:.0f} launches a replay (idle share "
                 f"{row['idle_share']:.3f})")
              + f"; conv FLOP bound {row['bound_ms']:.3f} ms at the bf16 peak; train_main "
              f"{run['wall_s']:.2f} s, peak {run['peak_gib']:.2f} GiB; top: "
              + "; ".join(f"{n} {t:.3f} ms" for n, t in top) + f"; {smi}", flush=True)
    del run, tr, first, captured, final
    gc_collect(on_card)
    return row


def _resume_and_update_bn(label: str, cfg, tr, bn0_state: dict, splits, final: dict,
                          drop_final, stem_bn: str, steps: int) -> None:
    """``cnn_fullshot_check``'s resume and ``update_bn`` checks on the trainer
    ``tr`` of its run (``final``: its state at the end; ``bn0_state``: the
    first step's state before it)."""
    import itertools

    from peft_vit_tpu_torch.engine.trainer import Trainer, _skip_batches, batch_iterator
    from peft_vit_tpu_torch.peft import build_mask

    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    spe = tr.steps_per_epoch
    mask = build_mask(tr.model, "full", num_layers=0)
    resume_dir = f"{cfg.OUTPUT_DIR}/resume"
    rcfg = copy.deepcopy(cfg)
    rcfg.defrost()
    rcfg.TRAIN.CHECKPOINT_EVERY_STEPS = 1
    rcfg.TRAIN.AUTO_RESUME = True

    def epoch_batches(e):
        return batch_iterator(splits.x_train, splits.y_train, batch,
                              shuffle=bool(cfg.TRAIN.SHUFFLE), seed=e)

    bn0 = bn0_state["bn"]

    def fresh():
        t = Trainer(rcfg, tr.model, mask, spe)
        for k, v in t.state.batch_stats.items():  # the run's initial statistics
            v.copy_(bn0[k])
        return t

    stopped = fresh()
    stopped.train_one_epoch(itertools.islice(epoch_batches(0), 1), 0, checkpoint_dir=resume_dir)
    del stopped
    resumed = fresh()
    epoch0 = resumed.maybe_resume(resume_dir)
    at = resumed.resume_batch_in_epoch
    for e in range(epoch0, int(cfg.TRAIN.END_EPOCH)):
        sb = at if e == epoch0 else 0
        resumed.train_one_epoch(_skip_batches(epoch_batches(e), sb), e, start_batch=sb)
    differ = _state_differ(resumed, final)
    same_rng = drop_final is None or torch.equal(resumed.drop_generator.get_state(), drop_final)
    check((epoch0, at) == (0, 1) and not differ and same_rng,
          f"{label} full-shot: resumed at epoch {epoch0} batch {at} from the first mid-epoch "
          f"checkpoint == the uninterrupted run bit for bit after {steps} steps "
          f"({sum(len(v) for v in final.values())} state tensors"
          + ("" if drop_final is None else
             f"; the drop generator's state {'equal' if same_rng else 'differs'}") + ")"
          + (f"; differ: {differ[:4]}" if differ else ""))
    # update_bn: the stem BN's new mean against the batch means of its input
    batches = list(itertools.islice(epoch_batches(0), RN_UPDATE_BN_BATCHES))
    seen = []
    hook = tr.model.backbone.get_submodule(stem_bn).register_forward_hook(
        lambda m, args, out: seen.append(args[0].float().mean(dim=(0, 2, 3))))
    try:
        stats = resumed.update_bn(iter(batches))
    finally:
        hook.remove()
    # update_bn runs each batch from zeros and (the first) from ones: keep
    # the passes from zeros
    means = torch.stack([seen[0]] + seen[2:]).mean(0)
    got = stats[f"backbone.{stem_bn}.bn_mean"]
    rel = float((got - means).abs().max() / means.abs().max())
    check(all(bool(torch.isfinite(v).all()) for v in stats.values()) and rel <= 1e-3,
          f"{label} full-shot: update_bn over {len(batches)} batches"
          + (" (DropBlock live)" if drop_final is not None else "") + ": the stem "
          f"BN's mean {rel:.3e} of its largest from the average of the batch means (<= 1e-3: "
          "recovered as new / (1 - momentum) through the fp32 statistics)")
    del resumed


RN_CONFIGS = ("resnet50", "resnet101", "r50_s3", "rn50_CLIP", "rn101_CLIP", "rn50x4_CLIP",
              "rn50x16_CLIP")
# configs no yaml ships: a resnetD with DYReLU and the BiT name
RN_EXTRA_CONFIGS = {
    "cls_resnetd_dyrelu": {"MODEL.NAME": "cls_resnetd50", "MODEL.SPEC.VISION.MODEL": "resnet",
                           "MODEL.SPEC.VISION.DEEP_STEM": True,
                           "MODEL.SPEC.VISION.AVG_DOWN": True,
                           "MODEL.SPEC.VISION.DY_RELU": {"ENABLE": True}},
    "bit_resnet50": {"MODEL.NAME": "bit_resnet50", "MODEL.SPEC.VISION.MODEL": "resnet"},
}


def rn_configs_check(smi: str, device: str) -> None:
    """Every ResNet-family config through ``build_image_classifier`` at its
    own width, depth and image size, bf16 (the shipped yamls, a resnetD with
    DYReLU, the BiT name, and a builder registered under a name): finite
    logits of a train-mode and an eval forward of 2 images, the BN
    statistics moved by the train-mode one."""
    from peft_vit_tpu_torch.models import build_image_classifier, register_model
    from peft_vit_tpu_torch.models.registry import _BUILDERS
    from peft_vit_tpu_torch.peft import spec_from_config

    @register_model("chip_smoke_custom_resnet")
    def custom(cfg, spec, num_classes, device, seed):
        cfg.defrost()
        cfg.MODEL.NAME = "resnet50"
        return build_image_classifier(cfg, spec, num_classes, device=device, seed=seed)

    t0 = time.perf_counter()
    names = {**{n: ({}, f"peft_vit_tpu/resources/model/{n}.yaml") for n in RN_CONFIGS},
             **{n: (over, None) for n, over in RN_EXTRA_CONFIGS.items()},
             "custom": ({"MODEL.NAME": "chip_smoke_custom_resnet"}, R50_YAML)}
    try:
        for name, (over, yaml_file) in names.items():
            cfg = driver_cfg({"TPU.COMPUTE_DTYPE": "bfloat16", **RN_CONFIG_OVER, **over},
                             yaml_file)
            model = build_image_classifier(cfg, spec_from_config(cfg), NUM_CLASSES,
                                           device=device)[0]
            size = int(cfg.TRAIN.IMAGE_SIZE[0])
            x = torch.randn(2, size, size, 3, device=device)
            before = {k: v.clone() for k, v in model.named_buffers()}
            with torch.no_grad():
                train = model.train()(x)
                moved = any(not torch.equal(v, before[k]) for k, v in model.named_buffers())
                out = model.eval()(x)
            check(bool(torch.isfinite(train).all() and torch.isfinite(out).all()) and moved,
                  f"rn config {name}: {type(model.backbone).__name__} at {size} px, "
                  f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters, "
                  "finite train and eval logits, BN statistics moved")
            del model
            gc_collect(device == "cuda")
    finally:
        _BUILDERS.pop("chip_smoke_custom_resnet", None)
    print(f"rn configs: {len(names)} built and run in {time.perf_counter() - t0:.1f} s "
          f"(host clock; {smi})", flush=True)


def resnet_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 15 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    if device == "cuda":
        out["determinism"] = determinism_phase()
    rn_configs_check(smi, device)
    out["serving"] = rn_serving_check(smi, device)
    gc_collect(device == "cuda")
    out["zeroshot"] = rn_zeroshot_check(smi, device)
    gc_collect(device == "cuda")
    out["round"] = rn_round_check(smi, device)
    gc_collect(device == "cuda")
    out["tiny"] = tiny_driver_check(device, RN_TINY_DRIVER, RN_TINY_LRS,
                                    "rn tiny fp32 finetune_main (bitfit)")
    out["dropblock"] = dropblock_card_check(smi, device)
    out["fullshot"] = r50_fullshot_check(smi, device)
    # the phase's launches per wrapper: its main paths' counts (the zero-shot
    # text tower's K1; the RN towers' none)
    launches = {n: out["fullshot"]["launches"].get(n, 0) for n in out["fullshot"]["launches"]}
    launches["flash_attention_fwd"] += out["zeroshot"]["launches"]
    for part in ("serving", "round"):
        for n, c in out[part].get("launches", {}).items():
            launches[n] = launches.get(n, 0) + c
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"resnet phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 16: the Swin family and ConvViT.  Swin-T of swin_tiny.yaml (embed 96,
# depths 2/2/6/2, heads 3/6/12/24, window 7, patch 4) at 224 px; CLIP Swin-T
# of clip_swin_tiny.yaml (the same tower, projection 512, the CLIP text tower);
# ConvViT and CSwin at a tiny size.  A CPU rehearsal shrinks SWIN_MODEL.
SWIN_YAML = "peft_vit_tpu/resources/model/swin_tiny.yaml"
CLIP_SWIN_YAML = "peft_vit_tpu/resources/model/clip_swin_tiny.yaml"
SWIN_MODEL: dict = {}  # overrides of the Swin-T tower (a CPU rehearsal shrinks it here)
SWIN_BATCH = 64  # swin_tiny.yaml's TRAIN.BATCH_SIZE_PER_GPU
# swin_tiny.yaml's recipe (the defaults under its model and batch) on
# synthetic 10-way at 224 px, the full fine-tune, 2 epochs of 2 steps.
SWIN_FULLSHOT = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 10,
                 "MODEL.NUM_CLASSES": 10, "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE],
                 "PEFT.METHOD": "none", "TEST.BATCH_SIZE_PER_GPU": SWIN_BATCH,
                 "TRAIN.BATCH_SIZE_PER_GPU": SWIN_BATCH, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-3,
                 "TRAIN.MOMENTUM": 0.9, "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1,
                 "TRAIN.CHECKPOINT_EVERY_STEPS": 0, "TRAIN.AUTO_RESUME": False,
                 "TPU.COMPUTE_DTYPE": "bfloat16", "PRINT_FREQ": 1, "NAME": "swin"}
SWIN_DIR = "build/swin"  # checkpoints and logs, removed after the phase
SWIN_FLOPS_PER_IMAGE = 3 * 4.5e9  # a Swin-T forward at 224 px is 4.5 GFLOP; fwd + bwd ~3x
# Swin-T in bf16 on the card against fp32 on the CPU, max |logit diff| / max
# |logit| of a 5-image request through the prototype head: bf16 rounds every
# GEMM and LayerNorm output through 12 random-weight blocks and 3 patch
# mergings (no BN: each LayerNorm renormalises).  The first measurement on
# the H100 (NVIDIA H100 80GB HBM3, 700.00 W): 1.25e-2, top-1 equal.  Bound
# 5e-2.
TOL_SWIN_BF16_LOGITS_REL = 5e-2
# fp32 on the card against the CPU: the same arithmetic summed in other orders.
TOL_SWIN_F32_LOGITS_REL = 1e-3
# The tiny fp32 few-shot drive on CLIP Swin (LoRA), card against CPU.
SWIN_TINY_DRIVER = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4,
                    "DATASET.NUM_SAMPLES_PER_CLASS": 4, "TRAIN.IMAGE_SIZE": [32, 32],
                    "TRAIN.BATCH_SIZE_PER_GPU": 8, "TRAIN.END_EPOCH": 1, "TRAIN.SCHEDULE": [],
                    "MODEL.NAME": "clip_swin_tiny", "MODEL.SPEC.EMBED_DIM": 16,
                    "MODEL.SPEC.VISION.MODEL": "swin", "MODEL.SPEC.VISION.PATCH_SIZE": 4,
                    "MODEL.SPEC.VISION.EMBED_DIM": 32, "MODEL.SPEC.VISION.DEPTHS": [2, 2],
                    "MODEL.SPEC.VISION.NUM_HEADS": [1, 2], "MODEL.SPEC.VISION.WINDOW_SIZE": 4,
                    "MODEL.SPEC.TEXT.WIDTH": 16, "MODEL.SPEC.TEXT.HEADS": 2,
                    "MODEL.SPEC.TEXT.LAYERS": 1, "PEFT.METHOD": "lora", "PEFT.LORA_RANK": 2,
                    "TPU.COMPUTE_DTYPE": "float32", "TRAIN.SEARCH_WD_LOG_UPPER": -2}
SWIN_TINY_LRS = (1e-3,)
# ConvViT and CSwin at a tiny size (32 px, patch 8, width 64, 2 blocks of 2 heads)
CONVVIT_TINY = {
    "cls_vit_conv": {"MODEL.NAME": "cls_vit_conv", "MODEL.SPEC.VISION.HAS_CONV": True,
                     "MODEL.SPEC.VISION.RES_SCORE": True, "MODEL.SPEC.VISION.ADD_CLS": True},
    "cls_vit_cswin": {"MODEL.NAME": "cls_vit_cswin", "MODEL.SPEC.VISION.RES_SCORE": True},
}
CONVVIT_SIZE = {"TRAIN.IMAGE_SIZE": [32, 32], "MODEL.SPEC.VISION.PATCH_SIZE": 8,
                "MODEL.SPEC.VISION.WIDTH": 64, "MODEL.SPEC.VISION.LAYERS": 2,
                "MODEL.SPEC.VISION.HEADS": 2, "TPU.COMPUTE_DTYPE": "float32"}
# ConvViT's convolutions at a ViT-S/16 width for the determinism probe: 384
# channels, a 14 x 14 grid, B = 64: the mixer's depthwise 3x3 dw and LePE's
# depthwise get_v (the mixer's 1x1 pw1 / pw2 are GEMMs: cuDNN's fp32 weight
# gradient of them did not repeat in a captured step on the H100)
CONVVIT_PROBE = dict(image_size=224, patch_size=16, width=384, layers=1, heads=6)


def _swin(yaml_file: str, num_classes: int, dtype: str, device: str, use_bn: bool = False,
          **over):
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = driver_cfg({"TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], **SWIN_MODEL,
                      "TPU.COMPUTE_DTYPE": dtype, **over}, yaml_file)
    return cfg, build_image_classifier(cfg, spec_from_config(cfg), num_classes, use_bn=use_bn,
                                       device=device)


def swin_serving_check(smi: str, device: str) -> dict:
    """Swin-T (swin_tiny.yaml) at 224 px, weights from a numpy seed and a
    prototype head, through ``ServingSession`` (bf16, buckets 1, 8 and 32):
    K1 once a block a replay, captured == eager bit for bit, top-1 and the
    logits against fp32 on the CPU, fp32 on the card against the CPU (the
    D = 32 fp32 kernels), each bucket's latency."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.ops import launch_counts

    rng = np.random.RandomState(SEED + 70)
    _, (cpu_model, _, _) = _swin(SWIN_YAML, NUM_CLASSES, "float32", "cpu")
    blocks = sum(cpu_model.backbone.depths)
    state = rn_numpy_state(cpu_model, rng)
    requests = {n: rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)
                for n in REQUESTS}
    checked = requests[CHECKED_REQUEST]
    cpu_model.load_state_dict(state)
    cpu_model.eval()
    with torch.no_grad():
        feats = cpu_model.backbone(torch.from_numpy(checked)).numpy()
    d = feats - feats.mean(axis=0)
    rows = 10.0 * d / (d * d).sum(axis=1, keepdims=True)
    head_w = state["classifier.head.weight"].numpy().copy()
    head_b = state["classifier.head.bias"].numpy().copy()
    head_w[:len(feats)] = rows
    head_b[:len(feats)] = -(rows @ feats.mean(axis=0))
    state["classifier.head.weight"] = torch.from_numpy(head_w)
    state["classifier.head.bias"] = torch.from_numpy(head_b)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        cpu_logits = cpu_model(torch.from_numpy(checked)).numpy()
    del cpu_model
    _, (model, _, _) = _swin(SWIN_YAML, NUM_CLASSES, "bfloat16", device)
    model.load_state_dict(state)
    before = launch_counts()  # counts from 0 just before the main path, read just after
    session = ServingSession(model, None, IMAGE, buckets=BUCKETS, device=device)
    logits = {n: session.predict(x) for n, x in requests.items()}
    counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    batches = sum(math.ceil(n / BUCKETS[-1]) for n in REQUESTS)
    check(all(bool(np.isfinite(v).all()) for v in logits.values()),
          f"swin serving: {len(requests)} requests, finite logits")
    if device == "cuda":
        _serving_graphs(session, {"flash_attention_fwd": blocks},
                        counts.get("flash_attention_fwd", 0), batches, "swin serving", blocks)
    with bench_torch.eager_on_card():
        _, (model_e, _, _) = _swin(SWIN_YAML, NUM_CLASSES, "bfloat16", device)
        model_e.load_state_dict(state)
        eager = ServingSession(model_e, None, IMAGE, buckets=BUCKETS, device=device)
        same = [n for n, x in requests.items() if np.array_equal(eager.predict(x), logits[n])]
    check(len(same) == len(requests),
          f"swin serving: captured buckets == eager bit for bit on {len(same)} of "
          f"{len(requests)} requests")
    del eager, model_e
    got = logits[CHECKED_REQUEST]
    rel = _rel(got, cpu_logits)
    top, top_cpu = got.argmax(1), cpu_logits.argmax(1)
    check(bool((top == top_cpu).all()) and rel <= TOL_SWIN_BF16_LOGITS_REL,
          f"swin serving: bf16 card top-1 {top.tolist()} == fp32 CPU {top_cpu.tolist()}; max "
          f"|logit diff| / max |logit| {rel:.4e} <= {TOL_SWIN_BF16_LOGITS_REL:g}")
    _, (m32, _, _) = _swin(SWIN_YAML, NUM_CLASSES, "float32", device)
    m32.load_state_dict(state)
    card32 = make_infer_fn(m32, None)(torch.from_numpy(checked).to(device)).cpu().numpy()
    rel32 = _rel(card32, cpu_logits)
    check(rel32 <= TOL_SWIN_F32_LOGITS_REL and bool((card32.argmax(1) == top_cpu).all()),
          f"swin serving: fp32 card vs fp32 CPU max |logit diff| / max |logit| {rel32:.4e} <= "
          f"{TOL_SWIN_F32_LOGITS_REL:g}, top-1 equal")
    del m32
    latency = _serving_latency(session, "swin-t bf16", rng, smi) if device == "cuda" else {}
    return {"bf16_rel": rel, "f32_rel": rel32, "latency_ms": latency, "launches": counts}


def swin_fullshot_check(smi: str, device: str) -> dict:
    """``train_main`` on swin_tiny.yaml's Swin-T (the full fine-tune, B =
    64, 224 px, bf16; see ``SWIN_FULLSHOT``): every step and eval batch one
    replay, K1, K2, K3 and K7 each once a block a step replay (``launch_rule``:
    12), K1 12 an eval replay; finite losses; the first step captured ==
    eager bit for bit, its attention operands against K1-K3's plain versions
    and its update with K1-K3 and K7 against the float64 backward
    (``hold_first_step``); a run stopped after its first mid-epoch
    checkpoint and resumed == the uninterrupted run bit for bit; the step's
    time, busy time and idle share."""
    import itertools
    import shutil

    from peft_vit_tpu_torch.engine.trainer import Trainer, _skip_batches, batch_iterator
    from peft_vit_tpu_torch.peft import build_mask

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    over = {**SWIN_FULLSHOT, **SWIN_MODEL, "OUTPUT_DIR": SWIN_DIR}
    cfg = driver_cfg(over, SWIN_YAML)
    run = fullshot_drive("swin", cfg, smi, device, sync, out_dir=SWIN_DIR)
    tr, splits = run["trainer"], run["splits"]
    spe = tr.steps_per_epoch
    steps = spe * int(cfg.TRAIN.END_EPOCH)
    n_eval = -(-len(splits.y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
    final = {"trainable": {k: v.detach().clone() for k, v in tr.state.trainable.items()},
             "opt": {k: v.clone() for k, v in tr.state.opt_state.items()}}
    check(bool(tr.state.finite) and all(math.isfinite(e["loss"]) for e in run["epochs"]),
          f"swin full-shot: {steps} steps at B={SWIN_BATCH}, finite losses "
          + " ".join(f"{e['loss']:.4f}" for e in run["epochs"]) + f", best top-1 {run['best']:.2f}")
    blocks = sum(tr.model.backbone.depths)
    rule = launch_rule(tr.model, tr.state.trainable)
    check(rule == dict.fromkeys(rule, blocks),
          f"swin full-shot: launch_rule gives K1, K2, K3 and K7 {blocks} each a step: {rule}")
    _hold_graphs("swin full-shot", tr, run["counts"], rule,
                 {"flash_attention_fwd": blocks}, steps, int(cfg.TRAIN.END_EPOCH) * n_eval)
    kernel_err = hold_first_step("swin full-shot", tr, run["first"], on_card)
    # a run stopped after its first mid-epoch checkpoint, and one resumed from it
    mask = build_mask(tr.model, "full", num_layers=12)
    resume_dir = f"{SWIN_DIR}/resume"
    rcfg = driver_cfg({**over, "TRAIN.CHECKPOINT_EVERY_STEPS": 1, "TRAIN.AUTO_RESUME": True},
                      SWIN_YAML)

    def epoch_batches(e):
        return batch_iterator(splits.x_train, splits.y_train, SWIN_BATCH,
                              shuffle=bool(cfg.TRAIN.SHUFFLE), seed=e)

    first = run["first"]["before"]

    def fresh():
        t = Trainer(rcfg, tr.model, mask, spe)
        for k, v in t.state.trainable.items():  # the run's initial weights
            v.copy_(first["trainable"][k])
        return t

    stopped = fresh()
    stopped.train_one_epoch(itertools.islice(epoch_batches(0), 1), 0, checkpoint_dir=resume_dir)
    del stopped
    resumed = fresh()
    epoch0 = resumed.maybe_resume(resume_dir)
    at = resumed.resume_batch_in_epoch
    for e in range(epoch0, int(cfg.TRAIN.END_EPOCH)):
        sb = at if e == epoch0 else 0
        resumed.train_one_epoch(_skip_batches(epoch_batches(e), sb), e, start_batch=sb)
    differ = _state_differ(resumed, final)
    check((epoch0, at) == (0, 1) and not differ,
          f"swin full-shot: resumed at epoch {epoch0} batch {at} from the first mid-epoch "
          f"checkpoint == the uninterrupted run bit for bit after {steps} steps "
          f"({sum(len(v) for v in final.values())} state tensors)"
          + (f"; differ: {differ[:4]}" if differ else ""))
    del resumed
    shutil.rmtree(SWIN_DIR, ignore_errors=True)
    row = {"steps": steps, "launches": run["counts"], "best": run["best"],
           "per_replay": dict(_graphs_of(tr, "train")[0].launches), "wall_s": run["wall_s"],
           "peak_gib": run["peak_gib"], "kernel_err": kernel_err}
    if on_card:
        graph = _graphs_of(tr, "train")[0]
        step_ms = _replay_ms(graph, 5)
        busy, n_launches, top = _device_breakdown(graph.graph.replay, reps=3)
        row.update(step_ms=step_ms, images_per_s=1e3 * SWIN_BATCH / step_ms, busy_ms=busy,
                   device_launches=n_launches,
                   idle_share=None if busy is None else max(0.0, 1.0 - busy / step_ms),
                   bound_ms=SWIN_BATCH * SWIN_FLOPS_PER_IMAGE / BF16_FLOPS_PER_S * 1e3)
        print(f"swin full-shot step B={SWIN_BATCH} (bf16, the full fine-tune, K1-K3 and K7 at "
              f"D = 32): captured {step_ms:.3f} ms ({row['images_per_s']:.1f} images/s), "
              "device busy " + ("not measured" if busy is None else
                                f"{busy:.3f} ms in {n_launches:.0f} launches a replay (idle share "
                                f"{row['idle_share']:.3f})")
              + f"; FLOP bound {row['bound_ms']:.3f} ms at the bf16 peak; train_main "
              f"{run['wall_s']:.2f} s, peak {run['peak_gib']:.2f} GiB; top: "
              + "; ".join(f"{n} {t:.3f} ms" for n, t in top) + f"; {smi}", flush=True)
    del run, tr, final
    gc_collect(on_card)
    return row


def swin_zeroshot_check(smi: str, device: str) -> dict:
    """``zeroshot_main`` on clip_swin_tiny.yaml at 224 px in bf16, the towers
    from numpy seeds: finite score; K1 12 times a text forward (the causal
    bias, D = 64) and 12 times a Swin image batch (D = 32), nothing else."""
    from peft_vit_tpu_torch.commands import zeroshot_eval
    from peft_vit_tpu_torch.data.prompts import class_map, register_prompts, template_map
    from peft_vit_tpu_torch.models import params_to_jax
    from peft_vit_tpu_torch.ops import attention as attn

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    rng = np.random.RandomState(SEED + 71)
    register_prompts("synthetic", class_map(ZS_DATASET)[:ZS_CLASSES], template_map(ZS_DATASET))
    text = text_tree(rng)
    cfg = driver_cfg({"TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], **SWIN_MODEL, **ZS,
                      "TPU.COMPUTE_DTYPE": "bfloat16"}, CLIP_SWIN_YAML)
    w = text["params"]["text_projection"].shape[0]
    text["params"]["text_projection"] = (rng.standard_normal(
        (w, int(cfg.MODEL.SPEC.EMBED_DIM))) / math.sqrt(w)).astype(np.float32)
    _, (cpu_model, _, _) = _swin(CLIP_SWIN_YAML, ZS_CLASSES, "float32", "cpu",
                                 **{"MODEL.SPEC.EMBED_DIM": int(cfg.MODEL.SPEC.EMBED_DIM)})
    blocks = sum(cpu_model.backbone.depths)
    variables = params_to_jax(rn_numpy_state(cpu_model, np.random.RandomState(SEED + 72)))
    del cpu_model
    _zero_attention_counts(attn)  # counts from 0 just before the main path, read just after
    t0 = time.perf_counter()
    score = zeroshot_eval.zeroshot_main(cfg, device=device, variables=variables,
                                        text_variables=text)
    sync()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in _attention_counts(attn).items() if n}
    k1 = counts.get("flash_attention_fwd", 0)
    image_k1 = k1 - TEXT_LAYERS * ZS_CLASSES
    ok = (list(counts) == ["flash_attention_fwd"] and image_k1 > 0 and image_k1 % blocks == 0
          if device == "cuda" else counts == {})
    check(math.isfinite(score) and ok,
          f"swin zeroshot_main bf16: score {score:.3f}, {ZS_CLASSES} classes; launched {counts}: "
          f"K1 {TEXT_LAYERS} a text forward (causal bias) x {ZS_CLASSES} classes + {blocks} a "
          f"Swin image batch x {image_k1 // blocks}; {wall:.2f} s (host clock; {smi})")
    return {"launches": k1, "wall_s": wall, "score": score}


def swin_round_check(smi: str, device: str, method: str) -> dict:
    """A captured round of 3 cells of ``method`` (lora or rpb) on CLIP Swin-T
    (clip_swin_tiny.yaml, bf16, B = 16, 224 px, the channel-BN head; rpb's
    tables per cell, so each block's bias is (3, nW h, 49, 49)): one step
    equal to it eager bit for bit; K1-K3 and K7 a replay from
    ``launch_rule``; each cell against the same cell trained alone (momentum
    cosine per leaf >= TOL_ROUND_BF16_COS)."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn, step_decay_lr)
    from peft_vit_tpu_torch.models import cast_frozen_
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.peft import build_mask, split_params

    _, (model, _, _) = _swin(CLIP_SWIN_YAML, NUM_CLASSES, "bfloat16", device, use_bn=True,
                             **{"PEFT.METHOD": method})
    model.load_state_dict(rn_numpy_state(model, np.random.RandomState(SEED + 73)))
    mask = build_mask(model, method)
    trainable, _ = split_params(model, mask)
    cast_frozen_(model)
    apply_fn = make_apply_fn(model)
    bn = {k: v for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    k = len(ROUND_LRS)
    rng = np.random.RandomState(SEED + 74)
    x = torch.as_tensor(rng.standard_normal((TRAIN_BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                        device=device)
    y = torch.as_tensor(rng.randint(0, NUM_CLASSES, TRAIN_BATCH), device=device)
    valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=device)
    perm, lrs, wds = np.arange(TRAIN_BATCH), step_decay_lr(ROUND_LRS, 0, ()), torch.tensor(
        ROUND_WDS)
    # each cell's leaves: the built ones plus N(0, 0.02^2), so that no LoRA B is zero
    draws = [{n: v.detach() + 0.02 * torch.from_numpy(rng.standard_normal(
        tuple(v.shape)).astype(np.float32)).to(v.device) for n, v in trainable.items()}
        for _ in range(k)]
    state = init_cell_state({n: torch.stack([d[n] for d in draws]) for n in draws[0]},
                            {n: v.expand(k, *v.shape) for n, v in bn.items()})
    graphs = {}
    epoch = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True, cells=True,
                          graphs=graphs)
    before = launch_counts()
    captured, loss = epoch(state, {}, x, y, valid, perm, lrs, wds)
    counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    with bench_torch.eager_on_card():
        eager, eager_loss = epoch(state, {}, x, y, valid, perm, lrs, wds)
    parts = ("trainable", "momentum", "bn")
    differ = [f"{part}.{n}" for part in parts for n, v in getattr(eager, part).items()
              if not torch.equal(v, getattr(captured, part)[n])]
    check(not differ and torch.equal(loss, eager_loss) and bool(loss.isfinite().all()),
          f"clip swin {method}: a round of {k} cells, one step at B={TRAIN_BATCH}, captured == "
          f"eager bit for bit ({len(draws[0])} trainable leaves, their momentum, the head's BN; "
          "losses " + " ".join(f"{float(v):.4f}" for v in loss) + ")"
          + (f"; differ: {differ[:4]}" if differ else ""))
    graph = graphs.get(("step", k, TRAIN_BATCH))
    want = launch_rule(model, trainable, k)
    if device == "cuda":
        _per_replay(graph, want, f"clip swin {method}: one step of a round of {k}")
    one = make_epoch_fn(apply_fn, ce_per_example, TRAIN_BATCH, has_bn=True)
    cos = {}
    with bench_torch.eager_on_card():
        for c in range(k):
            alone = one(init_cell_state(draws[c], bn), {}, x, y, valid, perm, lrs[c], wds[c])[0]
            for n, v in alone.momentum.items():
                if n.startswith("classifier."):
                    continue  # the head's gradient is the channel BN's, held by the tower's
                cos[(c, n)] = torch.nn.functional.cosine_similarity(
                    v.double().flatten(), captured.momentum[n][c].double().flatten(), dim=0).item()
    least = min(cos, key=cos.get)
    check(cos[least] >= TOL_ROUND_BF16_COS,
          f"clip swin {method} bf16: each of {k} cells against the cell trained alone, "
          f"momentum cosine per tower leaf: least {cos[least]:.6f} (cell {least[0]}, "
          f"{least[1]}) >= {TOL_ROUND_BF16_COS:g}, median {statistics.median(cos.values()):.6f}")
    row = {"round_ms": None, "launches": counts, "per_replay": want, "least_cos": cos[least]}
    if device == "cuda" and graph is not None:
        row["round_ms"] = _replay_ms(graph, 5)
        print(f"clip swin {method} round of {k} at B={TRAIN_BATCH}: captured "
              f"{row['round_ms']:.3f} ms a step ({k * TRAIN_BATCH / row['round_ms'] * 1e3:.1f} "
              f"cell-images/s); launches a replay {want}; {smi}", flush=True)
    del graphs, graph, epoch, model, captured, eager
    gc_collect(device == "cuda")
    return row


def ssl_swin_check(smi: str, device: str) -> dict:
    """An SSL-Swin built by ``build_ssl_swin`` from swin_tiny.yaml's tower
    with ``USE_APE`` and ``DROP_PATH_RATE`` 0.2, in fp32 at 224 px, weights
    from a numpy seed: the linear-eval features of the last 4 blocks
    (``extract_n_last_blocks``) on the card against the CPU
    (``TOL_SWIN_F32_LOGITS_REL``), K1 12 times; ``multi_crop_forward`` over
    three crops equal to one forward of them; the student's train-mode
    forward drawing its drop path from a generator on the card (finite, and
    not the eval forward); the teacher without drop path."""
    from peft_vit_tpu_torch.models.ssl_swin import (build_ssl_swin, extract_n_last_blocks,
                                                    multi_crop_forward)
    from peft_vit_tpu_torch.ops import launch_counts

    cfg = driver_cfg({"TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], **SWIN_MODEL,
                      "MODEL.SPEC.VISION.USE_APE": True,
                      "MODEL.SPEC.VISION.DROP_PATH_RATE": 0.2,
                      "TPU.COMPUTE_DTYPE": "float32"}, SWIN_YAML)
    rng = np.random.RandomState(SEED + 76)
    x = rng.standard_normal((3, IMAGE, IMAGE, 3)).astype(np.float32)
    feats, state = {}, None
    for dev in ("cpu", device):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            student = build_ssl_swin(cfg, device=dev)
        if state is None:
            state = rn_numpy_state(student, rng)
        student.load_state_dict(state)
        before = launch_counts()
        feats[dev] = extract_n_last_blocks(student, torch.from_numpy(x).to(dev), 4)
        counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    blocks = sum(student.depths)
    rel = _rel(feats[device].cpu().numpy(), feats["cpu"].numpy())
    want = {"flash_attention_fwd": blocks} if device == "cuda" else {}
    check(rel <= TOL_SWIN_F32_LOGITS_REL and counts == want
          and bool(torch.isfinite(feats[device]).all()),
          f"ssl swin fp32: the last 4 blocks' features {tuple(feats[device].shape)}, card vs "
          f"CPU max |diff| / max |ref| {rel:.4e} <= {TOL_SWIN_F32_LOGITS_REL:g}; launched "
          f"{counts} == {want}")
    xt = torch.from_numpy(x).to(device)
    student.eval()
    with torch.no_grad():
        whole = student(xt)
        crops = multi_crop_forward(student, [xt[:1], xt[1:2], xt[2:]])
        gen = torch.Generator(device=xt.device).manual_seed(SEED)
        dropped = student.train()(xt, generator=gen)
    teacher = build_ssl_swin(cfg, is_teacher=True, device=device)
    check(torch.equal(crops, whole) and bool(torch.isfinite(dropped).all())
          and not torch.equal(dropped, whole) and student.drop_path_rate == 0.2
          and teacher.drop_path_rate == 0.0,
          "ssl swin: multi_crop_forward over 3 crops == one forward of them; the student's "
          "train-mode forward with drop path 0.2 from a generator on the device: finite, not "
          "the eval forward; the teacher without drop path")
    del student, teacher
    return {"f32_rel": rel, "launches": counts}


def convvit_check(smi: str, device: str) -> dict:
    """ConvViT (``HAS_CONV``, ``RES_SCORE``, ``ADD_CLS``) and CSwin (LePE,
    ``RES_SCORE``) at a tiny size in fp32: the card's logits against the
    CPU's (``TOL_SWIN_F32_LOGITS_REL``); one captured few-shot step (the
    mixer's BN in train mode, its statistics carried) equal to it eager bit
    for bit; K1-K7 launched 0 times."""
    import bench_torch
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_epoch_fn, make_infer_fn)
    from peft_vit_tpu_torch.models import build_image_classifier, cast_frozen_
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params

    out = {}
    for name, over in CONVVIT_TINY.items():
        rng = np.random.RandomState(SEED + 75)
        cfg = driver_cfg({**CONVVIT_SIZE, **over}, None)
        x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        y = rng.randint(0, 4, 8)
        state = None
        logits = {}
        for dev in ("cpu", device):
            model = build_image_classifier(cfg, spec_from_config(cfg), 4, use_bn=True,
                                           device=dev)[0]
            if state is None:
                state = rn_numpy_state(model, rng)
            model.load_state_dict(state)
            logits[dev] = make_infer_fn(model, None)(torch.from_numpy(x).to(dev)).cpu().numpy()
        rel = _rel(logits[device], logits["cpu"])
        mask = build_mask(model, "full", num_layers=2)
        trainable, _ = split_params(model, mask)
        cast_frozen_(model)
        bn = {k: v for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
        start = init_cell_state({k: v.detach().clone() for k, v in trainable.items()}, bn)
        graphs = {}
        epoch = make_epoch_fn(make_apply_fn(model), ce_per_example, 8, has_bn=True,
                              graphs=graphs)
        xt, yt = torch.from_numpy(x).to(device), torch.as_tensor(y, device=device)
        valid = torch.ones(8, dtype=torch.bool, device=device)
        before = launch_counts()
        captured, loss = epoch(start, {}, xt, yt, valid, np.arange(8), 1e-3, 1e-4)
        counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
        with bench_torch.eager_on_card():
            eager, eager_loss = epoch(start, {}, xt, yt, valid, np.arange(8), 1e-3, 1e-4)
        differ = [f"{part}.{n}" for part in ("trainable", "momentum", "bn")
                  for n, v in getattr(eager, part).items()
                  if not torch.equal(v, getattr(captured, part)[n])]
        n_stats = sum(1 for k in bn if "conv.bn" in k)
        check(rel <= TOL_SWIN_F32_LOGITS_REL and not differ and torch.equal(loss, eager_loss)
              and counts == {} and bool(torch.isfinite(loss).all()),
              f"{name} fp32: card vs CPU max |logit diff| / max |logit| {rel:.4e} <= "
              f"{TOL_SWIN_F32_LOGITS_REL:g}; a captured step == eager bit for bit ({len(trainable)} "
              f"leaves, {n_stats} mixer BN statistics); K1-K7 launched {counts} (none: its "
              "attention is plain PyTorch)" + (f"; differ: {differ[:4]}" if differ else ""))
        out[name] = {"f32_rel": rel, "launches": counts}
        del model, graphs, epoch
    return out


def convvit_signatures() -> list:
    """ConvViT's and CSwin's convolutions at ``CONVVIT_PROBE`` (B = 64, bf16):
    the mixer's depthwise 3x3 dw, LePE's depthwise get_v."""
    from peft_vit_tpu_torch.models.vit_conv import ConvViT

    x = torch.randn(RN_BATCH, CONVVIT_PROBE["image_size"], CONVVIT_PROBE["image_size"], 3,
                    device="cuda")
    sigs = []
    for kw in (dict(has_conv=True), dict(lepe=True)):
        tower = ConvViT(**CONVVIT_PROBE, **kw, dtype=torch.bfloat16, device="cuda")
        sigs += [s for s in conv_signatures(tower, x) if s not in sigs]
        del tower
    return sigs


def swin_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 16 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    if device == "cuda":
        out["kernels"] = swin_kernel_phase()
    out["serving"] = swin_serving_check(smi, device)
    gc_collect(device == "cuda")
    out["fullshot"] = swin_fullshot_check(smi, device)
    out["zeroshot"] = swin_zeroshot_check(smi, device)
    gc_collect(device == "cuda")
    for method in ("lora", "rpb"):
        out[method] = swin_round_check(smi, device, method)
    out["tiny"] = tiny_driver_check(device, SWIN_TINY_DRIVER, SWIN_TINY_LRS,
                                    "swin tiny fp32 finetune_main (lora)")
    out["ssl"] = ssl_swin_check(smi, device)
    out["convvit"] = convvit_check(smi, device)
    # the phase's launches per wrapper: its main paths' counts
    launches = dict(out["fullshot"]["launches"])
    for part in ("serving", "lora", "rpb"):
        for n, c in out[part].get("launches", {}).items():
            launches[n] = launches.get(n, 0) + c
    launches["flash_attention_fwd"] = launches.get("flash_attention_fwd", 0) + out[
        "zeroshot"]["launches"]
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"swin phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17: the zoo's other CNNs.  EfficientNet-B0 (efficientnet_b0.yaml),
# ReXNet 1.0x, TTNet v2 (its fixed topology) and HRNet-W18 (cls_hrnet's
# defaults: width 18, stage modules 1 / 4 / 3), all at 224 px and full
# width; HRNet v2 / v2_share / v3 / v4 and TTNet v3, which no yaml ships, at
# the JAX tests' configs (64 px).  A CPU rehearsal shrinks them through
# ZOO_MODEL / ZOO_FULLSHOT_OVER.
EFFNET_YAML = "peft_vit_tpu/resources/model/efficientnet_b0.yaml"
ZOO_BATCH = 64  # efficientnet_b0.yaml's TRAIN.BATCH_SIZE_PER_GPU, and the other towers'
ZOO_TOWERS = {  # label -> (config overrides, yaml)
    "efficientnet_b0": ({}, EFFNET_YAML),
    "rexnet": ({"MODEL.NAME": "rexnet"}, None),
    "cls_ttnet_v2": ({"MODEL.NAME": "cls_ttnet_v2"}, None),
    "cls_hrnet": ({"MODEL.NAME": "cls_hrnet"}, None),
}
ZOO_MODEL: dict = {}  # overrides of every zoo tower (a CPU rehearsal shrinks them here)
# the JAX tests' configs (tests/test_refexec_models.py, tests/test_ttnet.py):
# three stages of 2 / 3 / 4 branches, two blocks a branch, SE on
_HRNET_V_STAGES = {"NUM_MODULES": [1, 1, 1], "NUM_BRANCHES": [2, 3, 4],
                   "NUM_BLOCKS": [[2, 2], [2, 2, 2], [2, 2, 2, 2]]}
_INVERTED = {"NUM_CHANNELS": [[8, 16], [8, 16, 32], [8, 16, 32, 64]], "BLOCK": ["INVERTED"] * 3}
_INVERTED_HEAD = {"BLOCK": ["INVERTED"] * 4, "NUM_CHANNELS": [16, 32, 64, 128],
                  "NUM_CHANNELS_PROJ": 256}
ZOO_SMALL = {
    "cls_hrnet_v2": {"MODEL.SPEC.WITH_SE": True, "MODEL.SPEC.STAGES": {
        **_HRNET_V_STAGES, "NUM_CHANNELS": [[8, 16], [9, 18, 36], [10, 20, 40, 80]],
        "BLOCK": ["BASIC"] * 3}, "MODEL.SPEC.HEAD": {
        "BLOCK": ["BOTTLENECK"] * 4, "NUM_CHANNELS": [8, 16, 32, 64], "NUM_CHANNELS_PROJ": 128}},
    "cls_hrnet_v2_share": {"MODEL.SPEC.WITH_SE": True, "MODEL.SPEC.STAGES": {
        **_HRNET_V_STAGES, "NUM_CHANNELS": [[8, 16], [8, 16, 32], [8, 16, 32, 64]],
        "BLOCK": ["BASIC"] * 3}, "MODEL.SPEC.HEAD": {
        "BLOCK": ["BOTTLENECK"] * 4, "NUM_CHANNELS": [8, 16, 32, 64], "NUM_CHANNELS_PROJ": 128}},
    "cls_hrnet_v3": {"MODEL.EXTRA": {"WITH_SE": True, "STAGES_SPEC": {
        **_HRNET_V_STAGES, **_INVERTED}, "HEAD_SPEC": _INVERTED_HEAD}},
    "cls_hrnet_v4": {"MODEL.EXTRA": {
        "WITH_SE": True, "STEM_SPEC": "conv32s2maxpools2inv32e6x1",
        "STAGES_SPEC": {**_HRNET_V_STAGES, **_INVERTED}, "HEAD_SPEC": _INVERTED_HEAD}},
    "cls_ttnet_v3": {"MODEL.EXTRA": {
        "STEM": {"NUM_CHANNEL_KICKOFF": 8, "NUM_CHANNEL_STEM_START": 16,
                 "EXPAND_STEM_START": 2, "KERNEL_SIZE": 3},
        "STAGES": {"NUM_CHANNEL_OUTPUT": [32, 64], "NUM_BLOCK_REPEATS": [2, 3],
                   "KERNEL_SIZE": [3, 5]}, "NUM_CHANNEL_FINAL": 128}},
}
ZOO_SMALL_IMAGE = 64
# v2 with grouped basic blocks (GROUPS, which the shipped configs leave at 1):
# its convolutions join the determinism probe
ZOO_GROUPED = {"MODEL.SPEC.WITH_SE": True, "MODEL.SPEC.STAGES": {
    **_HRNET_V_STAGES, "NUM_CHANNELS": [[8, 16], [8, 16, 32], [8, 16, 32, 64]],
    "BLOCK": ["BASIC"] * 3, "GROUPS": [[1, 2], [1, 2, 4], [1, 2, 4, 8]]},
    "MODEL.SPEC.HEAD": {"BLOCK": ["BOTTLENECK"] * 4, "NUM_CHANNELS": [8, 16, 32, 64],
                        "NUM_CHANNELS_PROJ": 128}}
# The full-shot recipe of the zoo's steps: the port's defaults under each
# tower at B = 64, synthetic 10-way at 224 px, the full fine-tune with SGD
# nesterov at lr 0.02 (random weights; r50_s3's cut lr), 1 warm-up epoch,
# epochs of 2 steps (2 epochs for B0, 1 for the others: ``zoo_phase``).
ZOO_FULLSHOT = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 10,
                "MODEL.NUM_CLASSES": 10, "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE],
                "PEFT.METHOD": "none", "TEST.BATCH_SIZE_PER_GPU": ZOO_BATCH,
                "TRAIN.BATCH_SIZE_PER_GPU": ZOO_BATCH, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 0.02,
                "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True,
                "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "TRAIN.CHECKPOINT_EVERY_STEPS": 0,
                "TRAIN.AUTO_RESUME": False, "TPU.COMPUTE_DTYPE": "bfloat16", "PRINT_FREQ": 1}
ZOO_FULLSHOT_OVER: dict = {}  # a CPU rehearsal cuts the batch here
ZOO_DIR = "build/zoo"  # checkpoints and logs, removed after each run
ZOO_CALIBRATION = 16  # images of the BN statistics' calibration (``calibrated_bn``)
# EfficientNet-B0 in bf16 on the card against fp32 on the CPU, max |logit
# diff| / max |logit| of a 5-image request through the prototype head (the
# other classes' rows zero), the BN statistics calibrated (``calibrated_bn``):
# bf16 rounds every conv output and SE gate through 16 blocks.  The first
# measurement on the H100 (NVIDIA H100 80GB HBM3, 700.00 W): 0.1152, top-1
# equal (with random statistics 35, top-1 wrong).  Bound 0.25.
TOL_ZOO_BF16_LOGITS_REL = 0.25
# fp32 on the card against the CPU: the same arithmetic summed in other
# orders, TF32 off for fp32 operands.
TOL_ZOO_F32_LOGITS_REL = 1e-3


def zoo_cfg(label: str, over: dict = None, dtype: str = "bfloat16"):
    """The config of zoo tower ``label`` (``ZOO_TOWERS`` or ``ZOO_SMALL``)
    at its own width and 224 px (``ZOO_SMALL_IMAGE`` for the small ones)."""
    if label in ZOO_SMALL:
        base, yaml_file, image = {"MODEL.NAME": label, **ZOO_SMALL[label]}, None, ZOO_SMALL_IMAGE
    else:
        (base, yaml_file), image = ZOO_TOWERS[label], IMAGE
    return driver_cfg({"TRAIN.IMAGE_SIZE": [image, image], **base, **ZOO_MODEL,
                       "TPU.COMPUTE_DTYPE": dtype, **(over or {})}, yaml_file)


def _zoo_model(label: str, dtype: str, device: str, over: dict = None, num_classes=NUM_CLASSES,
               use_bn: bool = False):
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = zoo_cfg(label, over, dtype)
    return build_image_classifier(cfg, spec_from_config(cfg), num_classes, use_bn=use_bn,
                                  device=device)[0]


def conv_macs(model, x) -> int:
    """The multiply-adds of every convolution of one forward of ``model`` on
    ``x`` (k x k x in/groups a channel and output element)."""
    from peft_vit_tpu_torch.models import resnet as rn

    total, real = [0], rn._Conv2d.apply

    def spy(xx, w, stride, padding, groups):
        out = real(xx, w, stride, padding, groups)
        total[0] += out.numel() * int(w.shape[1] * w.shape[2] * w.shape[3])
        return out

    rn._Conv2d.apply = spy
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        rn._Conv2d.apply = real
    return total[0]


def zoo_determinism() -> dict:
    """The determinism probe (``conv_determinism_probe``) over every
    convolution of the zoo's full-shot steps (B = 64, 224 px, bf16:
    EfficientNet-B0's and ReXNet's depthwise 3x3 and 5x5 at strides 1 and 2,
    TTNet v2's 5x5 depthwise, HRNet-W18's), of EfficientNet-B0's linear-probe
    round (the frozen tower on the folded batch of 3 cells x 16) and of a
    full fine-tune round's per-cell weights (the grouped form, cells x
    channels groups), and of HRNet v2 with grouped basic blocks in fp32."""
    torch.manual_seed(SEED)
    x = torch.randn(ZOO_BATCH, IMAGE, IMAGE, 3, device="cuda")
    sigs = {}
    for label in ZOO_TOWERS:
        model = _zoo_model(label, "bfloat16", "cuda")
        sigs[label] = conv_signatures(model.backbone, x)
        if label == "efficientnet_b0":
            xr = x[:RN_PROBE_CELLS * RN_PROBE_CELL_BATCH]
            sigs["efficientnet_b0_round"] = conv_signatures(model.backbone, xr)
            sigs["efficientnet_b0_grouped"] = _grouped(
                conv_signatures(model.backbone, xr[:RN_PROBE_CELL_BATCH]), RN_PROBE_CELLS)
        del model
        gc_collect(True)
    model = _zoo_model("cls_hrnet_v2", "float32", "cuda", ZOO_GROUPED)
    xs = torch.randn(ZOO_BATCH, ZOO_SMALL_IMAGE, ZOO_SMALL_IMAGE, 3, device="cuda")
    sigs["cls_hrnet_v2_groups"] = conv_signatures(model.backbone, xs)
    del model
    return {label: conv_determinism_probe(s, label) for label, s in sigs.items()}


def zoo_configs_check(smi: str, device: str) -> None:
    """Every zoo tower (``ZOO_TOWERS`` at 224 px, ``ZOO_SMALL`` at 64) through
    ``build_image_classifier`` at its own width, bf16: finite logits of a
    train-mode and an eval forward of 2 images, the BN statistics moved by
    the train-mode one, no family refused."""
    t0 = time.perf_counter()
    for label in (*ZOO_TOWERS, *ZOO_SMALL):
        model = _zoo_model(label, "bfloat16", device)
        size = int(zoo_cfg(label).TRAIN.IMAGE_SIZE[0])
        x = torch.randn(2, size, size, 3, device=device)
        before = {k: v.clone() for k, v in model.named_buffers()}
        with torch.no_grad():
            train = model.train()(x)
            moved = any(not torch.equal(v, before[k]) for k, v in model.named_buffers())
            out = model.eval()(x)
        check(bool(torch.isfinite(train).all() and torch.isfinite(out).all()) and moved,
              f"zoo config {label}: {type(model.backbone).__name__} at {size} px, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, "
              "finite train and eval logits, BN statistics moved")
        del model
        gc_collect(device == "cuda")
    print(f"zoo configs: {len(ZOO_TOWERS) + len(ZOO_SMALL)} built and run in "
          f"{time.perf_counter() - t0:.1f} s (host clock; {smi})", flush=True)


def _prototype_state(cpu_model, state: dict, images: np.ndarray) -> np.ndarray:
    """``state`` with the prototype head (class c's row image c's centred
    feature, scaled so that the CPU's logit of image c for class c is 10;
    the other classes' rows zero), loaded into ``cpu_model``; returns the
    CPU's logits of ``images``."""
    cpu_model.load_state_dict(state)
    cpu_model.eval()
    with torch.no_grad():
        feats = cpu_model.backbone(torch.from_numpy(images)).numpy()
    d = feats - feats.mean(axis=0)
    rows = 10.0 * d / (d * d).sum(axis=1, keepdims=True)
    head_w = np.zeros_like(state["classifier.head.weight"].numpy())
    head_b = np.zeros_like(state["classifier.head.bias"].numpy())
    head_w[:len(feats)] = rows
    head_b[:len(feats)] = -(rows @ feats.mean(axis=0))
    state["classifier.head.weight"] = torch.from_numpy(head_w)
    state["classifier.head.bias"] = torch.from_numpy(head_b)
    cpu_model.load_state_dict(state)
    with torch.no_grad():
        return cpu_model(torch.from_numpy(images)).numpy()


def calibrated_bn(cpu_model, state: dict, images: np.ndarray) -> dict:
    """``state`` with every BatchNorm's running statistics the batch
    statistics of ``images`` (one train-mode fp32 forward on the CPU from
    zeroed statistics, recovered as new / (1 - momentum), as ``update_bn``
    does): random statistics normalise nothing, and through EfficientNet's
    16 blocks the activations then outgrow what a bf16 forward can compare
    (the first card run: 35x the largest logit apart)."""
    cpu_model.load_state_dict(state)
    stats = {k: torch.zeros_like(v) for k, v in cpu_model.named_buffers()
             if k.endswith(("bn_mean", "bn_var"))}
    with torch.no_grad():
        torch.func.functional_call(cpu_model.train(), stats, (torch.from_numpy(images),))
    return {**state, **{k: v / (1.0 - 0.9) for k, v in stats.items()}}


def zoo_serving_check(label: str, smi: str, device: str, buckets=BUCKETS,
                      bf16: bool = True) -> dict:
    """Zoo tower ``label`` at its size, weights from a numpy seed (the BN
    statistics calibrated, ``calibrated_bn``) and a prototype head, through
    ``ServingSession`` (``buckets``; bf16, or fp32
    with ``bf16`` False): captured == eager bit for bit, no kernel launched,
    top-1 and the logits against fp32 on the CPU, fp32 on the card against
    the CPU; with bf16, each bucket's latency."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.ops import launch_counts

    rng = np.random.RandomState(SEED + 90)
    image = int(zoo_cfg(label).TRAIN.IMAGE_SIZE[0])
    cpu_model = _zoo_model(label, "float32", "cpu")
    state = calibrated_bn(cpu_model, rn_numpy_state(cpu_model, rng), rng.standard_normal(
        (ZOO_CALIBRATION, image, image, 3)).astype(np.float32))
    requests = {n: rng.standard_normal((n, image, image, 3)).astype(np.float32)
                for n in REQUESTS}
    checked = requests[CHECKED_REQUEST]
    cpu_logits = _prototype_state(cpu_model, state, checked)
    del cpu_model
    dtype = "bfloat16" if bf16 else "float32"
    model = _zoo_model(label, dtype, device)
    model.load_state_dict(state)
    before = launch_counts()  # counts from 0 just before the main path, read just after
    session = ServingSession(model, None, image, buckets=buckets, device=device)
    logits = {n: session.predict(x) for n, x in requests.items()}
    counts = {n: c - before[n] for n, c in launch_counts().items() if c - before[n]}
    check(counts == {} and all(bool(np.isfinite(v).all()) for v in logits.values()),
          f"{label} serving ({dtype}): {len(requests)} requests, finite logits; kernels "
          f"launched {counts} (none: convolutions, pools and BN are library calls)")
    with bench_torch.eager_on_card():
        model_e = _zoo_model(label, dtype, device)
        model_e.load_state_dict(state)
        eager = ServingSession(model_e, None, image, buckets=buckets, device=device)
        same = [n for n, x in requests.items() if np.array_equal(eager.predict(x), logits[n])]
    check(len(same) == len(requests),
          f"{label} serving ({dtype}): captured buckets {list(buckets)} == eager bit for bit on "
          f"{len(same)} of {len(requests)} requests")
    del eager, model_e
    got = logits[CHECKED_REQUEST]
    rel, top, top_cpu = _rel(got, cpu_logits), got.argmax(1), cpu_logits.argmax(1)
    row = {"rel": rel, "launches": counts}
    if bf16:
        check(bool((top == top_cpu).all()) and rel <= TOL_ZOO_BF16_LOGITS_REL,
              f"{label} serving: bf16 card top-1 {top.tolist()} == fp32 CPU {top_cpu.tolist()}; "
              f"max |logit diff| / max |logit| {rel:.4e} <= {TOL_ZOO_BF16_LOGITS_REL:g}")
        m32 = _zoo_model(label, "float32", device)
        m32.load_state_dict(state)
        got = make_infer_fn(m32, None)(torch.from_numpy(checked).to(device)).cpu().numpy()
        del m32
        row["f32_rel"] = _rel(got, cpu_logits)
    else:
        row["f32_rel"] = rel
    check(row["f32_rel"] <= TOL_ZOO_F32_LOGITS_REL and bool((got.argmax(1) == top_cpu).all()),
          f"{label} serving: fp32 card vs fp32 CPU max |logit diff| / max |logit| "
          f"{row['f32_rel']:.4e} <= {TOL_ZOO_F32_LOGITS_REL:g}, top-1 equal")
    if bf16 and device == "cuda":
        row["latency_ms"] = _serving_latency(session, f"{label} bf16", rng, smi,
                                             profiled=(buckets[-1],))
    del session, model
    gc_collect(device == "cuda")
    return row


def zoo_probe_check(smi: str, device: str) -> dict:
    """EfficientNet-B0 as the ELEVATER probe backbone through its entry
    points, bf16: ``linear_probe --classifier logistic`` (the frozen tower's
    features and the C sweep, on the ``LOGISTIC_CLASSES``-way task) and
    ``finetune_main`` linear (``drive``: a
    round of 3 (lr, wd) cells and the final train, the tower's BN in train
    mode with its statistics per cell, every step and eval batch a replay,
    no kernel launched)."""
    from peft_vit_tpu_torch.commands import linear_probe
    from peft_vit_tpu_torch.models import params_to_jax

    over = {**DRIVER, "PEFT.METHOD": "linear", "TRAIN.SEARCH_WD_LOG_UPPER": -2}
    cfg = zoo_cfg("efficientnet_b0", over)
    classes = int(cfg.DATASET.NUM_CLASSES)
    model = _zoo_model("efficientnet_b0", "float32", "cpu", over, classes, use_bn=True)
    tree = params_to_jax(rn_numpy_state(model, np.random.RandomState(SEED + 91)))
    del model
    t0 = time.perf_counter()
    lcfg = zoo_cfg("efficientnet_b0", {**over, "DATASET.NUM_CLASSES": LOGISTIC_CLASSES})
    lmodel = _zoo_model("efficientnet_b0", "float32", "cpu", over, LOGISTIC_CLASSES)
    ltree = params_to_jax(rn_numpy_state(lmodel, np.random.RandomState(SEED + 91)))
    del lmodel
    acc = linear_probe.logistic_main(lcfg, _results_dir(), device=device, variables=ltree)
    check(math.isfinite(acc), f"efficientnet_b0 logistic probe: test accuracy {acc:.3f} on the "
          f"{LOGISTIC_CLASSES}-way task ({time.perf_counter() - t0:.2f} s)")
    return {"logistic": acc, "linear": drive("efficientnet_b0 linear", cfg, tree, smi, device,
                                             want_cells=3, lr_grid=(1e-3,))}


def zoo_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 17 (see the module docstring)."""
    t0 = time.perf_counter()
    on_card = device == "cuda"
    out = {}
    if on_card:
        out["determinism"] = zoo_determinism()
    zoo_configs_check(smi, device)
    out["serving"] = zoo_serving_check("efficientnet_b0", smi, device)
    out["round"] = cnn_round_check(
        "efficientnet_b0 linear", zoo_cfg("efficientnet_b0", {"PEFT.METHOD": "linear"}),
        "linear", 12, SEED + 92, SEED + 93, (), smi, device)
    gc_collect(on_card)
    out["probe"] = zoo_probe_check(smi, device)
    gc_collect(on_card)
    out["fullshot"] = {}
    # (label, the stem BN, epochs, resume, profiled replays): HRNet-W18's step
    # is not profiled (torch.profiler's trace of its replay ends the process
    # with a segmentation fault on the H100) and runs 1 epoch for the time
    for label, stem_bn, epochs, resume, reps in (("efficientnet_b0", "bn1", 2, True, 1),
                                                 ("cls_hrnet", "stem_bn1.bn", 1, True, 0),
                                                 ("rexnet", "stem_bn", 1, False, 1),
                                                 ("cls_ttnet_v2", "conv1_bn", 1, False, 1)):
        over = {**ZOO_FULLSHOT, "OUTPUT_DIR": ZOO_DIR, "NAME": label, "TRAIN.END_EPOCH": epochs,
                **ZOO_FULLSHOT_OVER}
        out["fullshot"][label] = cnn_fullshot_check(
            label, zoo_cfg(label, over), ZOO_DIR, None, stem_bn,
            "SGD nesterov, the defaults' augmentation", smi, device, resume=resume,
            profile_reps=reps)
    for label in ZOO_SMALL:
        out[label] = zoo_serving_check(label, smi, device, buckets=(8,), bf16=False)
    # the phase's launches per wrapper: none of K1-K7 on any of its paths
    launches = {}
    parts = [out["serving"], out["round"], out["probe"]["linear"], *out["fullshot"].values(),
             *(out[label] for label in ZOO_SMALL)]
    for part in parts:
        for n, c in part.get("launches", {}).items():
            launches[n] = launches.get(n, 0) + c
    check(not any(launches.values()),
          f"zoo phase: K1-K7 launched 0 times on every path of the phase ({launches})")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    print(f"zoo phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# ---- phase 18: intrinsic dimension (the Fastfood and dense reparameterization)

INTRINSIC = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 10, "PEFT.METHOD": "intrinsic",
             "TPU.COMPUTE_DTYPE": "bfloat16"}
INTRINSIC_MODEL = {}  # overrides of vitb16_CLIP.yaml (a CPU rehearsal's tiny widths)
INTRINSIC_DIM = 1000  # d: the reference's intrinsic_dimension.py runs d in the thousands
INTRINSIC_BATCH = 16
INTRINSIC_STEPS = 2  # the captured epoch held against it eager
INTRINSIC_DENSE_ROWS = 4096  # rows of each dense P whose ray is held against the CPU
WHT_SPLIT_NS = tuple(2 ** i for i in range(8, 15))  # 256 ... 16,384: ops.wht.DENSE_MAX's measure
# theta on the card against the CPU in fp32: the same two WHTs (2^22 long at
# the kernels) in another summation order (the dense forms through cuBLAS
# against the CPU's BLAS), so a ray stands a few fp32 ulps of its largest
# element apart
TOL_RAY_REL = 1e-5


def wht_split_timing() -> dict:
    """Each WHT form on one vector (unnormalized, forward) at each length of
    ``WHT_SPLIT_NS``: the measure behind ``ops.wht.DENSE_MAX``."""
    from peft_vit_tpu_torch.ops import wht

    rows = {}
    for n in WHT_SPLIT_NS:
        x = torch.randn(n, device="cuda")
        rows[n] = {"dense_ms": _device_ms(lambda: wht.wht_matmul(x, False), 20),
                   "butterfly_ms": _device_ms(lambda: wht.wht_butterfly(x, False), 20)}
        print(f"intrinsic: WHT of one vector at d = {n}: dense product "
              f"{rows[n]['dense_ms'] * 1e3:.3f} us, butterfly {rows[n]['butterfly_ms'] * 1e3:.3f} "
              f"us (DENSE_MAX {wht.DENSE_MAX})")
    wht._MATRICES.clear()  # up to 1 GiB of H
    return rows


def intrinsic_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 18 (see the module docstring)."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ce_per_example, init_cell_state, make_apply_fn
    from peft_vit_tpu_torch.engine.train import make_epoch_fn, make_train_step
    from peft_vit_tpu_torch.models import build_image_classifier, cast_frozen_
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import wht
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params
    from peft_vit_tpu_torch.peft import intrinsic

    t0 = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {"split": wht_split_timing() if on_card else {}}
    cfg = driver_cfg({**INTRINSIC, **FLAGSHIP_DEPTH, **INTRINSIC_MODEL})
    torch.manual_seed(SEED)
    model, _, _ = build_image_classifier(cfg, spec_from_config(cfg), NUM_CLASSES, device=device)
    named = dict(model.named_parameters())
    split_params(model, build_mask(model, "intrinsic", num_layers=model.backbone.layers,
                                   train_head=False))
    sel = intrinsic.select_intrinsic_targets(named, "mlp")
    targets = {k: v for k, v in named.items() if sel[k]}  # fp32, before the cast
    gen = torch.Generator(device=device).manual_seed(SEED + 200)
    proj = intrinsic.build_projection(gen, targets, INTRINSIC_DIM)
    ll = max(leaf.ll for leaf in proj.leaves.values())  # 2^22 at ViT-B/16
    big = [k for k, leaf in proj.leaves.items() if leaf.ll == ll]
    cast_frozen_(model)
    rng = np.random.RandomState(SEED + 201)
    v = torch.from_numpy((rng.standard_normal(INTRINSIC_DIM) * 0.1).astype(np.float32))

    # theta: the card against the CPU in fp32, v = 0 and SAID's lambda = 0 exact
    theta = intrinsic.materialize(proj, v.to(device))
    zero = intrinsic.materialize(proj, torch.zeros(INTRINSIC_DIM, device=device))
    off = intrinsic.materialize(proj, v.to(device), {k: torch.zeros((), device=device)
                                                     for k in proj.theta0})
    cpu = intrinsic.materialize(proj.to("cpu"), v)
    errs = {}
    for k, theta0 in proj.theta0.items():
        ray = cpu[k] - theta0.cpu()
        errs[k] = ((theta[k].cpu() - cpu[k]).abs().max() / ray.abs().max()).item()
    worst = max(errs, key=errs.get)
    layers = model.backbone.layers
    check(len(proj.theta0) == 4 * layers and len(big) == 2 * layers
          and max(errs.values()) <= TOL_RAY_REL,
          f"intrinsic: Fastfood over mlp, {len(proj.theta0)} leaves ({len(big)} at LL = {ll}, "
          f"d = {INTRINSIC_DIM}): theta on the card vs the CPU in fp32, max |diff| / max |ray| "
          f"{errs[worst]:.3e} ({worst}) <= {TOL_RAY_REL:g}")
    check(all(torch.equal(zero[k], t) and torch.equal(off[k], t) for k, t in proj.theta0.items()),
          "intrinsic: v = 0 gives theta0 bit for bit on every leaf; so does SAID with lambda = 0")
    del theta, zero, off, cpu

    # the step: an epoch of INTRINSIC_STEPS batches captured, against it eager
    apply_fn, trainable = intrinsic.make_intrinsic_apply(make_apply_fn(model), proj)
    n = INTRINSIC_BATCH * INTRINSIC_STEPS
    x = torch.from_numpy(rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, n)).to(device)
    valid = torch.ones(n, dtype=torch.bool, device=device)
    perm = np.arange(n)
    graphs = {}
    epoch = make_epoch_fn(apply_fn, ce_per_example, INTRINSIC_BATCH, graphs=graphs)
    lr, wd = 1e-2, 1e-4
    _zero_attention_counts(attn)
    state_c, loss_c = epoch(init_cell_state(trainable), {}, x, y, valid, perm, lr, wd)
    sync()
    counts = _attention_counts(attn)
    with bench_torch.eager_on_card():
        state_e, loss_e = epoch(init_cell_state(trainable), {}, x, y, valid, perm, lr, wd)
    same = (torch.equal(state_c.trainable["v"], state_e.trainable["v"])
            and torch.equal(state_c.momentum["v"], state_e.momentum["v"])
            and torch.equal(loss_c, loss_e))
    check(same and bool(torch.isfinite(loss_c)) and bool(state_c.trainable["v"].abs().max() > 0),
          f"intrinsic: {INTRINSIC_STEPS} captured steps at B={INTRINSIC_BATCH} == eager bit for "
          f"bit (v, its momentum, the loss {float(loss_c):.6f}); v moved")
    graph = graphs.get(("step", None, INTRINSIC_BATCH))
    per_replay = graph.launches if graph is not None else {}
    # K1 in every block; K2 and K3 from block 1 on: block 0's attention runs
    # before its mlp, the first leaf theta reaches, so its q, k, v need no gradient
    want = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers - 1,
            "flash_attention_bwd_dkv": layers - 1, "attention_bias_grad": 0}
    check(all(per_replay.get(k, 0) == n_ for k, n_ in want.items()),
          f"intrinsic: launches a step replay {per_replay} == {want}; the wrappers counted "
          f"{counts} over the warm-up and the capture")
    out["launches"] = per_replay

    # the step's time, the transform's share of it, its profile
    if on_card:
        step_ms = _replay_ms(graph, reps=5)
        vg = torch.zeros(INTRINSIC_DIM, device=device, requires_grad=True)
        weights = {k: torch.randn_like(t) for k, t in proj.theta0.items()}

        def transform():  # theta and dL/dv through it, as the step takes them
            th = intrinsic.materialize(proj, vg)
            torch.autograd.grad(sum((th[k] * w).sum() for k, w in weights.items()), vg)

        transform_ms = _device_ms(transform, reps=2)
        x22 = torch.randn(ll, device=device)
        one_ms = _device_ms(lambda: wht.wht(x22, False), reps=5)
        busy, n_launch, top = _device_breakdown(lambda: graph.graph.replay(), reps=1, host=False)
        # the profiler's view: the transform's kernels run alone, against the step's
        t_busy, t_launch, _ = _device_breakdown(transform, reps=1, host=False)
        out.update(step_ms=step_ms, transform_ms=transform_ms, wht_big_ms=one_ms,
                   share=transform_ms / step_ms, busy_ms=busy, step_launches=n_launch,
                   transform_busy_ms=t_busy)
        if busy is not None and t_busy is not None:
            print(f"intrinsic profile: the transform alone busy {t_busy:.3f} ms in "
                  f"{t_launch:.0f} launches, {t_busy / busy:.3f} of the step's busy time")
        print(f"intrinsic: the step at B={INTRINSIC_BATCH} {step_ms:.3f} ms "
              f"({1e3 * INTRINSIC_BATCH / step_ms:.1f} images/s, graph replay, CUDA events); "
              f"theta and dL/dv alone {transform_ms:.3f} ms, share {transform_ms / step_ms:.3f} of "
              f"the step; one WHT at LL = {ll} {one_ms:.3f} ms (4 a big leaf a step, "
              f"{len(big)} big leaves); {smi}")
        if busy is not None:  # _device_breakdown's numbers are per replay
            print(f"intrinsic profile: busy {busy:.3f} ms a step in {n_launch:.0f} launches, "
                  f"idle share {max(0.0, 1.0 - busy / step_ms):.3f}; top: "
                  + "; ".join(f"{name} {t:.3f} ms" for name, t in top))
    del graphs, graph, state_c, state_e
    gc_collect(on_card)

    # the dense projection over one block's mlp (P is DD x d fp32: 9.4 GB for c_fc)
    # theta0 in fp32 (the model's own tensors are bf16 since the cast)
    last = layers - 1  # TRAIN.INTRINSIC_LAYER of the dense run: the last block's mlp
    dense_targets = {k: t for k, t in proj.theta0.items()
                     if intrinsic.select_intrinsic_targets({k: t}, "mlp", last)[k]}
    dproj = intrinsic.build_projection(gen, dense_targets, INTRINSIC_DIM, kind="dense")
    theta = intrinsic.materialize(dproj, v.to(device))
    zero = intrinsic.materialize(dproj, torch.zeros(INTRINSIC_DIM, device=device))
    derr = 0.0
    for k, p in dproj.leaves.items():
        ray = theta[k] - dproj.theta0[k]
        flat = (ray.t() if ray.dim() == 2 else ray).reshape(-1)[:INTRINSIC_DENSE_ROWS].cpu()
        want_ray = p[:INTRINSIC_DENSE_ROWS].cpu() @ v
        derr = max(derr, ((flat - want_ray).abs().max() / want_ray.abs().max()).item())
    check(len(dproj.leaves) == 4 and derr <= TOL_RAY_REL
          and all(torch.equal(zero[k], t) for k, t in dproj.theta0.items()),
          f"intrinsic dense: block {last}'s mlp ({len(dproj.leaves)} leaves, "
          f"{sum(p.numel() for p in dproj.leaves.values()) * 4 / 2 ** 30:.1f} GiB of P): the "
          f"first {INTRINSIC_DENSE_ROWS} rows of each ray (the JAX layout) vs the CPU's P v, max "
          f"|diff| / max |ray| {derr:.3e} <= {TOL_RAY_REL:g}; v = 0 gives theta0 bit for bit")
    del theta, zero
    dapply, dtrainable = intrinsic.make_intrinsic_apply(make_apply_fn(model), dproj)
    step = make_train_step(dapply, ce_per_example)
    _zero_attention_counts(attn)
    st, dloss = step(init_cell_state(dtrainable), {}, x[:INTRINSIC_BATCH], y[:INTRINSIC_BATCH],
                     None, torch.tensor(lr, device=device), torch.tensor(wd, device=device))
    sync()
    dcounts = _attention_counts(attn)
    # K1 in every block; K2 and K3 in none: the last block's attention runs
    # before its mlp, so no q, k, v needs a gradient
    dwant = {"flash_attention_fwd": layers, "flash_attention_bwd_dq": 0,
             "flash_attention_bwd_dkv": 0, "attention_bias_grad": 0}
    check(bool(torch.isfinite(dloss)) and bool(st.trainable["v"].abs().max() > 0)
          and all(dcounts[k] == n_ for k, n_ in dwant.items()),
          f"intrinsic dense: one eager step on block {last}'s mlp, loss "
          f"{float(dloss):.6f} finite, v moved; launches {dcounts}, K1-K3 and K7 == {dwant}")
    out["dense_launches"] = dcounts
    del dproj, dapply, step, st, proj, model
    gc_collect(on_card)
    out["seconds"] = time.perf_counter() - t0
    print(f"intrinsic phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# ---- phase 19: CLIP pre-training (train_clip) and the data-parallel steps

CLIP_BATCH = 32  # pairs a step
CLIP = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4, "PEFT.METHOD": "full",
        "TRAIN.BATCH_SIZE_PER_GPU": CLIP_BATCH, "TRAIN.BEGIN_EPOCH": 0, "TRAIN.END_EPOCH": 2,
        "TRAIN.OPTIMIZER": "adamW", "TRAIN.LR": 1e-5, "TRAIN.WD": 0.05,
        "TRAIN.LR_SCHEDULER.METHOD": "constant", "PRINT_FREQ": 1, "OUTPUT_DIR": "",
        "MODEL.SPEC.GATHER_TENSORS": True, "TPU.COMPUTE_DTYPE": "bfloat16"}
CLIP_MODEL = {}  # overrides of vitb16_CLIP.yaml (a CPU rehearsal's tiny widths)
DP_MODEL = {}  # the sharded step's flagship: ViT-B/16 unless a rehearsal shrinks it
CLIP_REPS = 5  # timed replays of the step
DP_BATCH = 16  # the sharded LoRA step's batch
DP_STEPS = 2
# the no-group step (the model's own logits) against the gathered step over a
# one-rank group: the same products in fp32 after the bf16 towers; a bound of
# one bf16 step (2^-8) of the loss, 5 per cent above it
TOL_CLIP_NO_GROUP_LOSS_REL = 4.1e-3


@contextlib.contextmanager
def _identity_collectives():
    """The collectives of the CLIP step as what they are over one rank:
    copies (the gather and the mean all-reduce)."""
    from peft_vit_tpu_torch.parallel import collectives

    saved = collectives.gather_features, collectives.psum_mean
    collectives.gather_features = lambda x: x
    collectives.psum_mean = lambda x: x.detach().clone()
    try:
        yield
    finally:
        collectives.gather_features, collectives.psum_mean = saved


def clip_drive(label: str, cfg, device: str, sync, spy_attention: bool = False) -> dict:
    """``train_clip_main(cfg)`` observed: the StepGraphs it captures, each
    step's loss and the parameters after the last, the wrappers' counts from
    0 just before and read just after, the wall time (and with
    ``spy_attention`` the first step's attention operands)."""
    from peft_vit_tpu_torch.commands import train_clip
    from peft_vit_tpu_torch.engine import train as train_engine
    from peft_vit_tpu_torch.ops import attention as attn

    rec = {"graphs": [], "losses": []}
    real_graph, real_step = train_engine.StepGraph, train_clip.make_clip_train_step

    class Recorded(real_graph):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec["graphs"].append(self)

    def spy(*a, **kw):
        step = real_step(*a, **kw)

        def observed(params, opt, images, tokens):
            out = step(params, opt, images, tokens)
            rec["losses"].append(out[2].clone())
            rec["params"] = out[0]
            return out

        return observed

    train_engine.StepGraph, train_clip.make_clip_train_step = Recorded, spy
    _zero_attention_counts(attn)
    spied = attention_spy() if spy_attention else contextlib.nullcontext([])
    try:
        with spied as calls:
            t0 = time.perf_counter()
            loss = train_clip.train_clip_main(cfg, device=device)
            sync()
            rec["wall_s"] = time.perf_counter() - t0
    finally:
        train_engine.StepGraph, train_clip.make_clip_train_step = real_graph, real_step
    rec["counts"] = _attention_counts(attn)
    rec["calls"] = calls[:int(cfg.MODEL.SPEC.VISION.LAYERS) + int(cfg.MODEL.SPEC.TEXT.LAYERS)]
    # ^ the first step's
    rec["loss"] = loss
    rec["losses"] = torch.stack(rec["losses"]).cpu()
    rec["params"] = {k: t.detach().clone() for k, t in rec["params"].items()}
    print(f"{label}: train_clip_main {len(rec['losses'])} steps at {CLIP_BATCH} pairs, losses "
          + " ".join(f"{float(x):.6f}" for x in rec["losses"])
          + f", {rec['wall_s']:.2f} s wall", flush=True)
    return rec


def clip_fp32_attention(device: str) -> dict:
    """One eager fp32 CLIP step at full width (no group) with K1-K3 held on
    every attention call's operands: the text tower's (B, 8, 77, 64) with the
    causal bias, the image tower's (B, 12, 197, 64)."""
    from peft_vit_tpu_torch.commands.train_clip import load_pairs
    from peft_vit_tpu_torch.data.tokenizer import tokenize
    from peft_vit_tpu_torch.engine.contrastive import clip_opt_state, make_clip_train_step
    from peft_vit_tpu_torch.engine.optim import build_optimizer
    from peft_vit_tpu_torch.models.clip import clip_from_config
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = driver_cfg({**CLIP, **CLIP_MODEL, "TPU.COMPUTE_DTYPE": "float32"})
    torch.manual_seed(SEED + 210)
    model = clip_from_config(cfg, spec_from_config(cfg), device=device)
    x_u8, caps = load_pairs(cfg)
    mean = np.asarray(cfg.INPUT.MEAN, np.float32) * 255.0
    std = np.asarray(cfg.INPUT.STD, np.float32) * 255.0
    x = torch.from_numpy((x_u8[:CLIP_BATCH].astype(np.float32) - mean) / std).to(device)
    tok = torch.from_numpy(tokenize(caps[:CLIP_BATCH], 77).astype(np.int64)).to(device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    tx = build_optimizer(cfg, params, 2)
    step = make_clip_train_step(model, tx)
    import bench_torch

    with bench_torch.eager_on_card(), attention_spy() as calls:
        step(params, clip_opt_state(tx, params), x, tok)
    text = [c for c in calls if c["bias"] is not None]
    image = [c for c in calls if c["bias"] is None]
    check(len(text) == int(cfg.MODEL.SPEC.TEXT.LAYERS)
          and len(image) == int(cfg.MODEL.SPEC.VISION.LAYERS),
          f"clip fp32: the step's attention calls, {len(text)} with the causal bias (text) and "
          f"{len(image)} without (image)")
    return {"text": hold_step_attention(attn, "clip fp32 text tower (causal)", text),
            "image": hold_step_attention(attn, "clip fp32 image tower", image)}


def sharded_step_check(smi: str, device: str) -> dict:
    """The sharded LoRA step of ``parallel`` over the one-rank NCCL group,
    replicated and ZeRO-1 (their collectives over one rank are copies):
    ``DP_STEPS`` captured steps == the same steps eager == the engine's
    one-process ``make_train_step``, bit for bit, at ViT-B/16, B = 16."""
    import bench_torch
    from peft_vit_tpu_torch.engine import ce_per_example, init_cell_state, make_apply_fn
    from peft_vit_tpu_torch.engine.train import make_train_step
    from peft_vit_tpu_torch.models import flagship
    from peft_vit_tpu_torch.parallel import make_mesh, make_sharded_train_step

    torch.manual_seed(SEED + 220)
    model = flagship(**DP_MODEL, device=device)
    trainable, _, _ = bench_torch.prepare(model)
    apply_fn = make_apply_fn(model)
    rng = np.random.RandomState(SEED + 221)
    x = torch.from_numpy(rng.standard_normal((DP_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                         ).to(device, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, DP_BATCH)).to(device)
    lr, wd = torch.tensor(1e-4, device=device), torch.tensor(1e-4, device=device)
    one = make_train_step(apply_fn, ce_per_example)
    with bench_torch.eager_on_card():
        st = init_cell_state(trainable)
        for _ in range(DP_STEPS):
            st, _ = one(st, {}, x, y, None, lr, wd)
    want = st.trainable
    out = {}
    mesh = make_mesh()
    for zero1 in (False, True):
        runs = {}
        for mode in ("captured", "eager"):
            step, place = make_sharded_train_step(apply_fn, ce_per_example, mesh, zero1=zero1)
            ctx = bench_torch.eager_on_card() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                state, frozen = place(init_cell_state(trainable), {})
                for _ in range(DP_STEPS):
                    state, loss = step(state, frozen, x, y, lr, wd)
            runs[mode] = state.trainable
        differ = [k for k in want if not (torch.equal(runs["captured"][k], runs["eager"][k])
                                          and torch.equal(runs["eager"][k], want[k]))]
        check(not differ, f"sharded step (zero1={zero1}) over the one-rank NCCL group: "
              f"{DP_STEPS} captured steps == eager == make_train_step bit for bit over "
              f"{len(want)} LoRA leaves at B={DP_BATCH}" + (f"; differ: {differ[:3]}" if differ
                                                              else ""))
        out[zero1] = not differ
    return out


def clip_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 19 (see the module docstring)."""
    import bench_torch
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.utils import dist

    t0 = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = driver_cfg({**CLIP, **CLIP_MODEL})
    blocks = int(cfg.MODEL.SPEC.VISION.LAYERS) + int(cfg.MODEL.SPEC.TEXT.LAYERS)
    out = {}
    # no group: the model's own logits
    solo = clip_drive("clip no group", cfg, device, sync)
    if on_card and solo["graphs"]:  # the step without collectives, beside the group's
        out["no_group_step_ms"] = _replay_ms(solo["graphs"][0], reps=CLIP_REPS)
        print(f"clip: the captured step without a group {out['no_group_step_ms']:.3f} ms "
              f"(graph replay, CUDA events; {smi})")
    del solo["params"], solo["graphs"]
    gc_collect(on_card)
    rendezvous = os.path.join(_results_dir(), "rendezvous")
    dist.init_distributed(init_method=f"file://{rendezvous}", num_processes=1, process_id=0,
                          device=device)
    try:
        group = clip_drive("clip one-rank group (captured)", cfg, device, sync)
        graph = group["graphs"][0] if group["graphs"] else None
        gc_collect(on_card)
        with bench_torch.eager_on_card():
            eager = clip_drive("clip one-rank group (eager)", cfg, device, sync,
                               spy_attention=on_card)
        gc_collect(on_card)
        with bench_torch.eager_on_card(), _identity_collectives():
            ident = clip_drive("clip, the collectives as identities (eager)", cfg, device, sync)
        n_params = len(group["params"])
        for other, what in ((eager, "the same steps eager"),
                            (ident, "the gathered loss and update computed eagerly with the "
                                    "gather and the mean all-reduce as identities")):
            differ = [k for k, t in group["params"].items()
                      if not torch.equal(t, other["params"][k])]
            check(torch.equal(group["losses"], other["losses"]) and not differ,
                  f"clip: the one-rank group's {len(group['losses'])} captured gathered steps == "
                  f"{what}, bit for bit (each loss, {n_params} parameters)"
                  + (f"; differ: {differ[:3]}" if differ else ""))
        rel = ((group["losses"] - solo["losses"]).abs() / solo["losses"].abs()).max().item()
        check(bool(torch.isfinite(group["losses"]).all()) and rel <= TOL_CLIP_NO_GROUP_LOSS_REL,
              f"clip: the gathered steps' losses finite and within {TOL_CLIP_NO_GROUP_LOSS_REL:g} "
              f"relative of the no-group steps' (the model's own logits): {rel:.3e}")
        per_replay = graph.launches if graph is not None else {}
        want = {"flash_attention_fwd": blocks, "flash_attention_bwd_dq": blocks,
                "flash_attention_bwd_dkv": blocks, "attention_bias_grad": 0}
        check(len(group["graphs"]) == 1
              and all(per_replay.get(k, 0) == n for k, n in want.items()),
              f"clip: one StepGraph for the run, launches a replay {per_replay} == {want} (12 "
              f"image and 12 text blocks; the causal bias needs no gradient: K7 0); the wrappers "
              f"counted {group['counts']} over the warm-up and the capture")
        out.update(launches=per_replay, counts=group["counts"], losses=group["losses"].tolist())
        if on_card:
            text = [c for c in eager["calls"] if c["bias"] is not None]
            out["causal_bf16"] = hold_step_attention(
                attn, "clip bf16 text tower (causal), train_clip's own step", text)
            del eager["calls"]
            gc_collect(on_card)
            out["causal_fp32"] = clip_fp32_attention(device)["text"]
            step_ms = _replay_ms(graph, reps=CLIP_REPS)
            busy, n_launch, top = _device_breakdown(lambda: graph.graph.replay(), reps=2)
            out.update(step_ms=step_ms, images_per_s=1e3 * CLIP_BATCH / step_ms,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            print(f"clip: the captured step at {CLIP_BATCH} pairs {step_ms:.3f} ms, "
                  f"{out['images_per_s']:.1f} images/s (graph replay, CUDA events, adamW over "
                  f"{n_params} leaves); {smi}")
            if busy is not None:  # _device_breakdown's numbers are per replay
                print(f"clip profile: busy {busy:.3f} ms a step in {n_launch:.0f} launches, "
                      f"idle share {max(0.0, 1.0 - busy / step_ms):.3f}; top: "
                      + "; ".join(f"{name} {t:.3f} ms" for name, t in top))
        del group, eager, ident, graph
        gc_collect(on_card)
        out["sharded"] = sharded_step_check(smi, device)
    finally:
        dist.destroy_distributed()
    gc_collect(on_card)
    out["seconds"] = time.perf_counter() - t0
    print(f"clip phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# The multi-process Trainer, tensor parallelism and the dryrun (phase 20).
# train_main on vitb16_sup.yaml as the full-shot phase runs it, checkpoints only
# where the resume check asks for them (a ViT-B/16 checkpoint is ~1 GB)
MC = {**FULLSHOT, **FULLSHOT_DEPTH, "TRAIN.CHECKPOINT_EVERY_STEPS": 0,
      "TRAIN.AUTO_RESUME": False, "NAME": "multichip"}
MC_INT8 = {**FULLSHOT_LORA, "TRAIN.END_EPOCH": 1, "NAME": "multichip_int8"}
MC_DIR = "build/multichip"  # checkpoints and logs, removed after the phase
# the stem BN's moments through the group's sums against the local mean and
# two-pass variance: one fp32 sum and division in another order
TOL_BN_MOMENT_REL = 1e-6
# the ResNet-50's first step with the group's BN moments against the local
# ones, fp32: test_torch_port_trainer.py's bound for two ResNet runs whose BN
# moments round otherwise (the JAX trainer's one-pass variance there)
TOL_RN_GROUP_UPDATE = dict(rtol=1e-4, atol=1e-5)
TP_BATCH = 16  # the tensor-parallel check's batch (ViT-B/16 LoRA)
TP_DEGREE = 2
# the two shards' sum against the whole model, max |logit diff| / max |logit|:
# the serving bounds (bf16 drift over 12 blocks; fp32 summation order)
TOL_TP_LOGITS_REL = {torch.bfloat16: 0.1, torch.float32: 1e-4}
TOL_TP_GRAD_REL = 1e-4  # fp32 LoRA gradients, max |diff| / max |whole|
DRYRUN_PROCESSES = 4  # dp x tp = 2 x 2 on gloo CPU processes
STREAM_MC = {"DATASET.NUM_CLASSES": 10, "TRAIN.IMAGE_SIZE": [32, 32],
             "TRAIN.BATCH_SIZE_PER_GPU": 16, "TEST.BATCH_SIZE_PER_GPU": 16}
STREAM_MC_IMAGES = 200


@contextlib.contextmanager
def count_collectives():
    """Within, every call of ``torch.distributed``'s collectives counted by
    name (the yielded dict)."""
    import torch.distributed as tdist

    counts: dict = {}
    names = [n for n in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                         "all_gather_single", "reduce_scatter_single", "all_gather",
                         "all_gather_object", "barrier") if hasattr(tdist, n)]
    saved = {n: getattr(tdist, n) for n in names}

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for n in names:
        setattr(tdist, n, counted(n, saved[n]))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(tdist, n, fn)


def _snapshot(tr) -> dict:
    """The trainer's state in ``_state_differ``'s layout (clones)."""
    s = tr.state
    return {"trainable": {k: v.detach().clone() for k, v in s.trainable.items()},
            "opt": {k: v.clone() for k, v in s.opt_state.items()},
            "ema": {k: v.clone() for k, v in s.ema.shadow.items()} if s.ema else {},
            "bn": {k: v.clone() for k, v in (s.batch_stats or {}).items()}}


def mc_group_runs(smi: str, device: str, ref: dict, out: dict) -> None:
    """``train_main`` in the one-rank group, replicated and under ZeRO-1,
    against the no-group run ``ref`` (its final state, each step's loss and
    each eval's top-1): bit for bit; one replay a step with K1-K3 12 each;
    the collectives of a step (an eager rerun of the first step, equal to its
    capture); under ZeRO-1 a run stopped at its first mid-epoch checkpoint
    and resumed == the uninterrupted run; each step's time."""
    import itertools
    import shutil

    import bench_torch
    from peft_vit_tpu_torch.engine.trainer import Trainer, _skip_batches, batch_iterator
    from peft_vit_tpu_torch.peft import build_mask

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for zero1 in (False, True):
        label = f"multichip group ({'ZeRO-1' if zero1 else 'replicated'})"
        cfg = driver_cfg({**MC, **FULLSHOT_MODEL, "OUTPUT_DIR": MC_DIR, "TPU.ZERO1": zero1},
                         FULLSHOT_YAML)
        run = fullshot_drive(label, cfg, smi, device, sync, out_dir=MC_DIR)
        tr, splits = run["trainer"], run["splits"]
        layers, spe = tr.model.backbone.layers, tr.steps_per_epoch
        steps = spe * int(cfg.TRAIN.END_EPOCH)
        n_eval = -(-len(splits.y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
        final = _snapshot(tr)
        differ = _state_differ(tr, ref["state"])
        losses = torch.stack(run["losses"]).cpu()
        top1 = [e["acc"] for e in run["evals"]]
        check(tr.mesh is not None and tr.zero1 == zero1 and not differ
              and torch.equal(losses, ref["losses"]) and top1 == ref["top1"],
              f"{label}: train_main over a one-rank group (mesh {tr.mesh.shape}) == the run "
              f"without a group bit for bit: {steps} losses, "
              f"{sum(len(v) for v in final.values())} state tensors (trainable, optimizer "
              f"state, EMA), {len(top1)} eval top-1s {top1}"
              + (f"; differ: {differ[:4]}" if differ else ""))
        _hold_graphs(label, tr, run["counts"],
                     {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                      "flash_attention_bwd_dkv": layers}, {"flash_attention_fwd": layers},
                     steps, 2 * int(cfg.TRAIN.END_EPOCH) * n_eval)
        first = run["first"]
        captured = {part: dict(leaves) for part, leaves in first["after"].items()}
        with bench_torch.eager_on_card(), count_collectives() as calls:
            _rerun_first_step(tr, first)
        differ = _state_differ(tr, captured)
        n_calls = sum(calls.values())
        check(not differ and n_calls > 0,
              f"{label}: the first step eager == its capture bit for bit; {n_calls} collectives "
              f"a step ({calls}) for {len(final['trainable'])} leaves"
              + (f"; differ: {differ[:4]}" if differ else ""))
        row = {"collectives": dict(calls), "n_collectives": n_calls,
               "launches": run["counts"],
               "per_replay": dict(_graphs_of(tr, "train")[0].launches)}
        if on_card:
            row["step_ms"] = _replay_ms(_graphs_of(tr, "train")[0], 10)
            print(f"{label}: the captured step at B={cfg.TRAIN.BATCH_SIZE_PER_GPU} "
                  f"{row['step_ms']:.3f} ms against {out['no_group_step_ms']:.3f} ms without "
                  f"the group ({n_calls} collectives a step; graph replay, CUDA events; {smi})",
                  flush=True)
        if zero1:
            # stopped after its first mid-epoch checkpoint, resumed by a fresh one
            rcfg = driver_cfg({**MC, **FULLSHOT_MODEL, "OUTPUT_DIR": MC_DIR, "TPU.ZERO1": True,
                               "TRAIN.CHECKPOINT_EVERY_STEPS": 1, "TRAIN.AUTO_RESUME": True},
                              FULLSHOT_YAML)
            model = tr.model
            mask = build_mask(model, "full", num_layers=layers)
            batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
            rows = tr._rows(batch)

            def epoch_batches(e):
                for bx, by in batch_iterator(splits.x_train, splits.y_train, batch,
                                             shuffle=bool(cfg.TRAIN.SHUFFLE), seed=e):
                    yield bx[rows], by[rows]

            del run, tr, first, captured
            gc_collect(on_card)
            resume_dir = f"{MC_DIR}/resume"
            stopped = Trainer(rcfg, model, mask, spe)
            stopped.train_one_epoch(itertools.islice(epoch_batches(0), 1), 0,
                                    checkpoint_dir=resume_dir)
            del stopped
            resumed = Trainer(rcfg, model, mask, spe)
            epoch0 = resumed.maybe_resume(resume_dir)
            at = resumed.resume_batch_in_epoch
            for e in range(epoch0, int(cfg.TRAIN.END_EPOCH)):
                sb = at if e == epoch0 else 0
                resumed.train_one_epoch(_skip_batches(epoch_batches(e), sb), e, start_batch=sb)
            differ = _state_differ(resumed, final)
            check((epoch0, at) == (0, 1) and resumed.zero1 and not differ,
                  f"{label}: a fresh Trainer resumed at epoch {epoch0} batch {at} from the "
                  f"first mid-epoch checkpoint (rank 0's whole leaves, cut again) == the "
                  f"uninterrupted run bit for bit after {steps} steps"
                  + (f"; differ: {differ[:4]}" if differ else ""))
            del resumed, model
        else:
            del run, tr, first, captured
        shutil.rmtree(MC_DIR, ignore_errors=True)
        out["zero1" if zero1 else "replicated"] = row
        gc_collect(on_card)


# the no-group ResNet-50 trainer and its splits, for the same step in the group
_MC_MODELS: dict = {}


def mc_int8_check(smi: str, device: str) -> dict:
    """LoRA under the int8 static recipe with int8 dx, in the group: the
    static scales of the first batch (their absmax max-reduced over the
    group) == the scales calibrated without the group bit for bit; the
    launches a replay; K6 == its plain version inside the first step, bit
    for bit."""
    import bench_torch
    from peft_vit_tpu_torch.engine import train as train_engine
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.peft.masks import merge_params

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = driver_cfg({**FULLSHOT, **FULLSHOT_MODEL, **MC_INT8, "OUTPUT_DIR": MC_DIR},
                     FULLSHOT_YAML)
    run = fullshot_drive("multichip lora int8", cfg, smi, device, sync, out_dir=MC_DIR)
    tr, first = run["trainer"], run["first"]
    layers, gemms = tr.model.backbone.layers, 4 * tr.model.backbone.layers
    epochs = int(cfg.TRAIN.END_EPOCH)
    n_eval = -(-len(run["splits"].y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
    _hold_graphs("multichip lora int8", tr, run["counts"],
                 {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                  "flash_attention_bwd_dkv": layers, "int8_gemm_static": gemms,
                  "int8_gemm_dynamic": gemms - 1},
                 {"flash_attention_fwd": layers, "int8_gemm_dynamic": gemms},
                 tr.steps_per_epoch * epochs, epochs * n_eval,
                 eager={"flash_attention_fwd": epochs * layers,
                        "int8_gemm_dynamic": epochs * gemms})
    group = run["epochs"][0]["scales"]
    variables = merge_params(first["before"]["trainable"], tr.frozen)
    local = train_engine.calibrate(tr.model, tr.apply_fn, variables,
                                   tr._normalize(tr._on_device(first["x"])), tr.calib_margin)
    differ = [k for k in local if not torch.equal(local[k], group.get(k, local[k] + 1))]
    check(tr.mesh is not None and len(group) == gemms and set(group) == set(local)
          and not differ,
          f"multichip lora int8: the {len(group)} static scales calibrated in the group (absmax "
          f"max-reduced over the ranks) == those calibrated without it, bit for bit"
          + (f"; differ: {differ[:4]}" if differ else ""))
    captured = {part: dict(leaves) for part, leaves in first["after"].items()}
    tr._qscale = group
    with bench_torch.eager_on_card(), plain_int8(i8):
        _rerun_first_step(tr, first)
    differ = _state_differ(tr, captured)
    check(not differ, "multichip lora int8: the group's first step with K6 == the same step with "
          "its plain version bit for bit" + (f"; differ: {differ[:4]}" if differ else ""))
    row = {"launches": run["counts"], "per_replay": dict(_graphs_of(tr, "train")[0].launches)}
    del run, tr, first, captured
    gc_collect(on_card)
    return row


def mc_bn_step(cfg, device: str, model=None):
    """A ResNet-50 Trainer of ``cfg`` (over ``model`` when given, else a new
    one from ``build_trainer``) after one eager step on the first batch of
    epoch 0: the trainer, the update of every trainable leaf, and the stem
    BN's input."""
    import bench_torch
    from peft_vit_tpu_torch.commands.train import build_trainer
    from peft_vit_tpu_torch.engine.trainer import Trainer, batch_iterator
    from peft_vit_tpu_torch.peft import build_mask

    if model is None:
        splits, tr = build_trainer(cfg, device)
        _MC_MODELS["rn_splits"] = splits
    else:
        tr = Trainer(cfg, model, build_mask(model, "full", num_layers=0),
                     _MC_MODELS["rn_tr"].steps_per_epoch)
    splits = _MC_MODELS["rn_splits"]
    before = {k: v.detach().clone() for k, v in tr.state.trainable.items()}
    stem = {}
    hook = tr.model.backbone.bn1.register_forward_pre_hook(
        lambda m, args: stem.setdefault("x", args[0].detach().clone()))
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    x, y = next(batch_iterator(splits.x_train, splits.y_train, batch,
                               shuffle=bool(cfg.TRAIN.SHUFFLE), seed=0))
    rows = tr._rows(batch)
    with bench_torch.eager_on_card():
        tr.train_step(x[rows], y[rows], 0)
    hook.remove()
    update = {k: (v.detach() - before[k]) for k, v in tr.state.trainable.items()}
    return tr, update, stem["x"]


def mc_bn_check(local: dict, device: str) -> dict:
    """The ResNet-50 of r50_s3.yaml in fp32 with the BN moments taken through
    the group's sums over one rank, against ``local`` (the same step
    without the group): the stem BN's moments within ``TOL_BN_MOMENT_REL``,
    the first step's update within ``TOL_RN_GROUP_UPDATE``."""
    from peft_vit_tpu_torch.models import resnet
    from peft_vit_tpu_torch.parallel import sum_over_group
    from peft_vit_tpu_torch.utils import dist

    tr, update, stem = mc_bn_step(local["cfg"], device, model=_MC_MODELS["rn_tr"].model)
    x32 = stem.float()
    m = x32.mean(dim=(0, 2, 3))
    v = (x32 - m.reshape(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    with dist.data_shard(0, x32.shape[0], functools.partial(sum_over_group, group=tr.group)):
        gm, gv = resnet._group_moments(x32, (0, 2, 3))
    rel = max(((gm - m).abs().max() / m.abs().max()).item(),
              ((gv - v).abs().max() / v.abs().max()).item())
    check(tr.mesh is not None and rel <= TOL_BN_MOMENT_REL,
          f"multichip resnet50: the stem BN's moments {tuple(stem.shape)} through the group's "
          f"sums (Σx and the count, then Σ(x - m)^2) against the local mean and variance: "
          f"{rel:.3e} relative <= {TOL_BN_MOMENT_REL:g}")
    worst, far = 0.0, None
    for k, u in update.items():
        want = local["update"][k]
        excess = ((u - want).abs() - (TOL_RN_GROUP_UPDATE["atol"]
                                      + TOL_RN_GROUP_UPDATE["rtol"] * want.abs())).max().item()
        if far is None or excess > worst:
            worst, far = excess, k
    check(worst <= 0.0,
          f"multichip resnet50: the first step's update (fp32, B={x32.shape[0]}, every BN's "
          f"moments over the group) against the step without the group, {len(update)} leaves "
          f"within rtol {TOL_RN_GROUP_UPDATE['rtol']:g} + atol {TOL_RN_GROUP_UPDATE['atol']:g} "
          f"(largest excess {worst:.3e} at {far})")
    return {"moment_rel": rel}


def mc_stream_batches(loader_data) -> list:
    """The in-memory streaming source's epoch 1 (K = 2 chunks, raw uint8)
    and its eval split, in whatever group is joined."""
    from peft_vit_tpu_torch.data.streaming import ArrayLoader, StreamingSource

    x, y = loader_data
    cfg = driver_cfg(STREAM_MC, None)
    train = StreamingSource(cfg, "train", normalize=False, batch_multiplier=2,
                            loader=ArrayLoader(x, y, 2 * int(cfg.TRAIN.BATCH_SIZE_PER_GPU)))
    test = StreamingSource(cfg, "test", normalize=False,
                           loader=ArrayLoader(x, y, int(cfg.TEST.BATCH_SIZE_PER_GPU)))
    return [tuple(np.asarray(a) for a in item[:2]) for item in train.batches(1)] + [
        tuple(np.asarray(a) for a in item) for item in test.batches()]


class _Shard(torch.nn.Module):
    """``forward`` of the module ``m`` (the attention's or the MLP's own), as
    a module whose leaves ``functional_call`` can replace by one shard's."""

    def __init__(self, m, forward):
        super().__init__()
        self.m, self.fn = m, forward

    def forward(self, x, *args, **kwargs):
        return self.fn(self.m, x, *args, **kwargs)


class _ShardComm:
    """The model group of ``two_shards``' shards, which run in threads of one
    process: ``rank`` is the calling thread's shard, and a collective is an
    exchange between the threads (``parallel.ModelComm``'s interface).  The
    tokens are held joined, so ``own_tokens`` and ``all_tokens`` are the
    identity; ``sum_int`` hands the sum to shard 0 and zeros to the others,
    as the runner then sums the shards' outputs (the sum ``g`` takes).  A
    collective outside the shards' threads (a backward's) raises: the
    exchange waits at a barrier with a time limit."""

    def __init__(self, degree: int):
        import threading

        self.size = degree
        self._local = threading.local()
        self._barrier = threading.Barrier(degree, timeout=120)
        self._slots = [None] * degree

    @property
    def rank(self) -> int:
        return getattr(self._local, "rank", 0)

    def _exchange(self, t):
        if not hasattr(self._local, "rank"):
            raise RuntimeError("two_shards: a model-group collective outside the shards' "
                               "threads (a backward's)")
        self._slots[self.rank] = t
        self._barrier.wait()
        got = list(self._slots)
        self._barrier.wait()
        return got

    def max(self, t):
        return functools.reduce(torch.maximum, [g.detach() for g in self._exchange(t)])

    def sum_int(self, t):
        total = functools.reduce(torch.add, self._exchange(t))
        return total if self.rank == 0 else torch.zeros_like(total)

    def own_tokens(self, t):
        return t

    def all_tokens(self, t):
        return t

    def cat_heads(self, t):
        return torch.cat(self._exchange(t), dim=-1)


@contextlib.contextmanager
def two_shards(model, degree: int = TP_DEGREE, sequence: bool = False):
    """Within, every attention and MLP of ``model`` runs its own tensor-
    parallel forward (``layers.tensor_parallel``, one process) once a shard,
    each on its rank's cut of the leaves and buffers (``parallel.tp_slice``,
    differentiable: the gradients reach the whole leaves; the int8 tree and
    scales as the step gives them), and the shards' outputs are summed: the
    sum the model group's ``g`` would take.  The row-parallel bias stands in
    shard 0 only, so that it is added once.  The shards run in threads, one
    a shard, each on its own copy of the module, so that the model group's
    other collectives (``_ShardComm``: the int8 GEMMs' global scales and
    int32 sums, the reference layouts' gather of every head) are exchanges
    between them; those of a backward (the int8 dx of a column-parallel
    GEMM) are not simulated and raise.

    ``sequence``: sequence parallelism (``tensor_parallel`` with the token
    split and gather).  The ranks' token slices are held in rank order in
    one (B, N, C) tensor: the split after the embedding cuts it into the
    ranks' slices and joins them again, ``f`` (the all-gather at each
    region's entry) and the gather before the head are the concatenation of
    the slices, and ``g`` (the reduce-scatter) is the shards' sum, taken
    where each shard's output is added, cut into the ranks' slices and
    joined; so LoRA A runs on the gathered tokens, the row-parallel bias is
    added after ``g``, and the model's sequence-parallel branches run (the
    deep prompts replace their rows of the joined sequence).  Otherwise
    ``f`` and ``g`` are the identity."""
    import threading

    from torch.func import functional_call

    from peft_vit_tpu_torch.models import layers
    from peft_vit_tpu_torch.parallel import tp_cut, tp_slice

    names = {id(m): n for n, m in model.named_modules()}
    # each shard's own copy of every attention and MLP (functional_call
    # swaps a module's tensors while it runs); the cut leaves replace all of
    # its tensors, so the copies hold none
    copies = {id(m): [copy.deepcopy(m).to_empty(device="meta") for _ in range(degree)]
              for m in model.modules() if isinstance(m, (layers.MultiHeadAttention, layers.Mlp))}
    comm = _ShardComm(degree)
    saved = layers.MultiHeadAttention.forward, layers.Mlp.forward

    def sharded(forward, row_bias: str):
        def run(self, x, *args, **kwargs):
            prefix = names[id(self)]
            tensors = [*self.named_parameters(), *self.named_buffers()]
            outs, errors = [None] * degree, []
            grad = torch.is_grad_enabled()
            comm._barrier.reset()

            def shard(r):
                comm._local.rank = r
                try:
                    with torch.set_grad_enabled(grad):
                        cut = {f"m.{k}": tp_slice(t, tp_cut(f"{prefix}.{k}", tuple(t.shape)), r,
                                                  degree) for k, t in tensors}
                        if r:
                            cut[f"m.{row_bias}"] = torch.zeros_like(cut[f"m.{row_bias}"])
                        mod = copies[id(self)][r].train(self.training)
                        outs[r] = functional_call(_Shard(mod, forward), cut, (x, *args), kwargs)
                except BaseException as e:  # re-raised below, after the other shards stop
                    errors.append(e)
                    comm._barrier.abort()
                finally:
                    del comm._local.rank

            threads = [threading.Thread(target=shard, args=(r,)) for r in range(degree)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            total = 0
            for o in outs:
                total = total + o
            return total
        return run

    def joined(t):  # the ranks' token slices, in rank order, joined
        return torch.cat(t.chunk(degree, 1), 1)

    fns = (joined, joined, joined, joined) if sequence else (lambda t: t, lambda t: t)
    layers.MultiHeadAttention.forward = sharded(saved[0], "out_proj.bias")
    layers.Mlp.forward = sharded(saved[1], "c_proj.bias")
    try:
        with layers.tensor_parallel(*fns, comm=comm):
            yield
    finally:
        layers.MultiHeadAttention.forward, layers.Mlp.forward = saved


def tp_shard_check(smi: str, device: str) -> dict:
    """ViT-B/16 LoRA at B = ``TP_BATCH`` under tensor parallelism of degree
    2, computed as the two shards in turn (``two_shards``: K1-K3 on 6 heads
    a shard, so 24 launches each a forward and backward): K1-K3 on the
    shards' operands against their plain versions, the logits against the
    whole model within the serving bounds, bf16 and fp32, and the fp32 LoRA
    gradients within ``TOL_TP_GRAD_REL``."""
    from peft_vit_tpu_torch.engine import ce_per_example
    from peft_vit_tpu_torch.models import flagship
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import launch_counts

    out = {}
    rng = np.random.RandomState(SEED + 240)
    x = torch.from_numpy(rng.standard_normal((TP_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                         ).to(device)
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, TP_BATCH)).to(device)
    layers = None
    for dtype in (torch.bfloat16, torch.float32):
        torch.manual_seed(SEED + 241)
        model = flagship(**DP_MODEL, dtype=dtype, device=device)
        layers = model.backbone.layers
        with torch.no_grad():  # every LoRA B nonzero, so that the deltas act
            for k, p in model.named_parameters():
                if "_adapter2" in k:
                    p.normal_(0.0, 0.02)
        lora = {k: p for k, p in model.named_parameters() if "_adapter" in k}
        model.train(False)
        got = {}
        for mode in ("whole", "shards"):
            ctx = two_shards(model) if mode == "shards" else contextlib.nullcontext()
            spied = attention_spy() if mode == "shards" else contextlib.nullcontext([])
            before = launch_counts()
            with ctx, spied as calls:
                logits = model(x.to(dtype))
                fwd = {n: c - before[n] for n, c in launch_counts().items()}
                grads = torch.autograd.grad(ce_per_example(logits.float(), y).mean(),
                                            list(lora.values()))
            counts = {n: c - before[n] for n, c in launch_counts().items()}
            got[mode] = (logits.detach().float(), grads, fwd, counts)
            if calls and device == "cuda":  # K1-K3 on the shards' 6-head operands
                # the random LoRA deltas (every B drawn at 0.02, times alpha / r
                # = 32) put |o| above 4, where o's bf16 bound scales with it
                got["kernel_err"] = hold_step_attention(
                    attn, f"tensor parallel {dtype}: the two shards' attention", calls)
            del calls
        whole, shards = got["whole"], got["shards"]
        rel = ((shards[0] - whole[0]).abs().max() / whole[0].abs().max()).item()
        want_fwd = {"flash_attention_fwd": TP_DEGREE * layers}
        on_card = device == "cuda"
        check(rel <= TOL_TP_LOGITS_REL[dtype] and bool(torch.isfinite(shards[0]).all())
              and (not on_card or all(shards[2].get(k, 0) == n for k, n in want_fwd.items())),
              f"tensor parallel {dtype}: ViT-B/16 LoRA at B={TP_BATCH} as {TP_DEGREE} shards in "
              f"turn (K1 launched {shards[2].get('flash_attention_fwd', 0)} times a forward, "
              f"{layers} blocks x {TP_DEGREE} shards of {model.backbone.blocks[0].attn.heads // TP_DEGREE} "
              f"heads) against the whole model: max |logit diff| / max |logit| {rel:.3e} <= "
              f"{TOL_TP_LOGITS_REL[dtype]:g}")
        row = {"logits_rel": rel, "launches_forward": shards[2], "launches_step": shards[3],
               "kernel_err": got.get("kernel_err")}
        if dtype == torch.float32:
            worst = max(((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(shards[1], whole[1]))
            check(worst <= TOL_TP_GRAD_REL,
                  f"tensor parallel fp32: the {len(lora)} LoRA gradients through the shards "
                  f"(A summed over them, B assembled from each shard's rows) against the whole "
                  f"model's: max |diff| / max |whole| {worst:.3e} <= {TOL_TP_GRAD_REL:g}")
            row["grad_rel"] = worst
        out["bf16" if dtype == torch.bfloat16 else "fp32"] = row
        print(f"tensor parallel {dtype}: launches a two-shard forward {shards[2]}, forward and "
              f"backward {shards[3]}; {smi}", flush=True)
        del model, lora, got, whole, shards
        gc_collect(device == "cuda")
    return out


def dryrun_check(n: int, device) -> dict:
    """``parallel.dryrun.dryrun_multichip(n, device)``: on gloo CPU processes
    (``device='cpu'``) or one card a rank (None), the mesh of n / 2 x 2 (n
    even) or n x 1 for the data x tensor-parallel, ZeRO-1 and
    sequence-parallel steps and of n / pipe x pipe (pipe = min(4, n)) for
    GPipe, every loss finite, the first, the sequence-parallel one and the
    pipelined one (before and after its step) within 1e-5 relative of the
    same losses over the global batch in one process."""
    from peft_vit_tpu_torch.parallel.dryrun import CHECKED, TOL_LOSS_REL, dryrun_multichip

    where = "gloo CPU processes" if device == "cpu" else "NCCL, one card a rank"
    want = {"data": n // 2, "model": 2} if n % 2 == 0 else {"data": n, "model": 1}
    pipe = min(4, n)
    want_pp = {"data": n // pipe, "pipe": pipe}
    t0 = time.perf_counter()
    try:
        out = dryrun_multichip(n, device=device)
        ok, what = True, ""
    except Exception as e:  # the dryrun's own checks raise
        out, ok, what = {}, False, f"; raised {type(e).__name__}: {str(e)[-300:]}"
    seconds = time.perf_counter() - t0
    rel = out.get("rel", {})
    check(ok and out.get("mesh") == want and out.get("pp_mesh") == want_pp
          and set(rel) == set(CHECKED) and max(rel.values()) <= TOL_LOSS_REL,
          f"dryrun_multichip({n}) on {where}: mesh {out.get('mesh')}, GPipe mesh "
          f"{out.get('pp_mesh')}; loss {out.get('loss')}, ZeRO-1 + LoRA-MoE loss "
          f"{out.get('zero1_moe_loss')}, sequence-parallel loss {out.get('seqpar_loss')}, "
          f"pipelined loss {out.get('pp_loss')} (after its step {out.get('pp_loss_after')}); "
          f"relative distances from one process {rel} (<= {TOL_LOSS_REL:g}); "
          f"{seconds:.1f} s" + what)
    return {k: out.get(k) for k in ("mesh", "pp_mesh", "loss", "zero1_moe_loss", "seqpar_loss",
                                    "pp_loss", "pp_loss_after", "one_process", "rel",
                                    "loss_rel")} | {"seconds": seconds}


def multichip_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 20 (see the module docstring)."""
    import shutil

    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.utils import dist

    t0 = time.perf_counter()
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}
    # without a group: train_main, the ResNet-50 step, the streaming source
    cfg = driver_cfg({**MC, **FULLSHOT_MODEL, "OUTPUT_DIR": MC_DIR}, FULLSHOT_YAML)
    solo = fullshot_drive("multichip no group", cfg, smi, device, sync, out_dir=MC_DIR)
    check(solo["trainer"].mesh is None, "multichip: the run without a group has no mesh")
    ref = {"state": _snapshot(solo["trainer"]), "losses": torch.stack(solo["losses"]).cpu(),
           "top1": [e["acc"] for e in solo["evals"]]}
    if on_card:
        out["no_group_step_ms"] = _replay_ms(_graphs_of(solo["trainer"], "train")[0], 10)
    else:
        out["no_group_step_ms"] = float("nan")
    del solo
    shutil.rmtree(MC_DIR, ignore_errors=True)
    gc_collect(on_card)
    rn_cfg = driver_cfg({**R50_FULLSHOT, **R50_MODEL, "TPU.COMPUTE_DTYPE": "float32",
                         "OUTPUT_DIR": R50_DIR}, R50_YAML)
    rn_tr, rn_update, _ = mc_bn_step(rn_cfg, device)
    _MC_MODELS["rn_tr"] = rn_tr
    rng = np.random.RandomState(SEED + 250)
    stream_data = (rng.randint(0, 256, (STREAM_MC_IMAGES, 32, 32, 3), dtype=np.uint8),
                   rng.randint(0, 10, STREAM_MC_IMAGES))
    stream_solo = mc_stream_batches(stream_data)
    # tensor parallelism as two shards in turn (no group: one process)
    out["tp"] = tp_shard_check(smi, device)
    # the one-rank group
    rendezvous = os.path.join(_results_dir(), "rendezvous")
    dist.init_distributed(init_method=f"file://{rendezvous}", num_processes=1, process_id=0,
                          device=device)
    try:
        _zero_attention_counts(attn)
        mc_group_runs(smi, device, ref, out)
        out["launches"] = dict(out["replicated"]["launches"])
        out["int8"] = mc_int8_check(smi, device)
        out["bn"] = mc_bn_check({"cfg": rn_cfg, "update": rn_update}, device)
        stream_group = mc_stream_batches(stream_data)
        check(len(stream_group) == len(stream_solo) and all(
            len(a) == len(b) and all(np.array_equal(u, v) for u, v in zip(a, b))
            for a, b in zip(stream_group, stream_solo)),
            f"multichip streaming: the in-memory source over the one-rank group == the source "
            f"without a group bit for bit ({len(stream_solo)} items: epoch 1's K = 2 chunks and "
            f"tail, the eval split)")
    finally:
        dist.destroy_distributed()
        _MC_MODELS.clear()
        shutil.rmtree(MC_DIR, ignore_errors=True)
        shutil.rmtree(R50_DIR, ignore_errors=True)
    gc_collect(on_card)
    # on gloo CPU processes: in main()'s child, run beside the zoo phase
    child = _DRYRUN_CHILD.pop("child", None)
    out["dryrun"] = (finish_dryrun_cpu(child) if child is not None
                     else dryrun_check(DRYRUN_PROCESSES, "cpu"))
    if on_card:  # the dryrun's default: every card of the host, one a rank
        out["dryrun_card"] = dryrun_check(torch.cuda.device_count(), None)
    out["seconds"] = time.perf_counter() - t0
    print(f"multichip phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# Sequence parallelism, the stacked block layout and GPipe (phase 21).
SP_YAML = "peft_vit_tpu/resources/model/vit_base_patch32_224.yaml"  # 7 x 7 + 1 = 50 tokens
SP_BATCH = 16
SP_MODEL = {}  # the yaml's tower; a rehearsal on the CPU shrinks it
# train_main on vitb16_sup.yaml at all 12 blocks, stacked and unrolled, one
# epoch of 2 steps at B = 64.  The global-norm clip is off: it sums each
# leaf's squares, over a stacked leaf's 12 layers at once where the unrolled
# run sums 12 leaves' norms, so the coefficient would differ in its last bits
STACKED = {**FULLSHOT, "TRAIN.CHECKPOINT_EVERY_STEPS": 0, "TRAIN.AUTO_RESUME": False,
           "TRAIN.END_EPOCH": 1, "TRAIN.CLIP_GRAD_NORM": 0.0, "NAME": "stacked"}
STACKED_DIR = "build/stacked"
PP_STAGES, PP_MICROBATCHES, PP_BATCH = 4, 4, FULLSHOT_BATCH
PP_MODEL = {}  # vitb16_sup.yaml's 12 blocks; a rehearsal shrinks it
# GPipe against the unpipelined stacked model: the stages run the same
# layers, but each GEMM over B / M rows, so the sums may take another order
# (cuBLAS picks by shape): the tensor-parallel check's bounds (bf16 drift over
# 12 blocks; fp32 summation order), every fp32 gradient within 1e-4 of its
# largest magnitude
TOL_PP_LOGITS_REL = TOL_TP_LOGITS_REL
TOL_PP_GRAD_REL = 1e-4
PP_TIMED_REPS = 5


def _full_tower(yaml_file: str, over: dict, dtype, device):
    """The timm tower of ``yaml_file`` (10 classes, 224 px) from
    ``build_image_classifier``'s seed, every zero leaf (the head, the biases,
    the class token) redrawn at 0.02 from ``SEED`` so that each acts, and all
    its parameters (a full fine-tune)."""
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = driver_cfg({"DATASET.NUM_CLASSES": 10, "MODEL.NUM_CLASSES": 10,
                      "TRAIN.IMAGE_SIZE": [IMAGE, IMAGE], "PEFT.METHOD": "none",
                      "TPU.COMPUTE_DTYPE": "bfloat16" if dtype == torch.bfloat16 else "float32",
                      **over}, yaml_file)
    model, _, _ = build_image_classifier(cfg, spec_from_config(cfg), 10, device=device)
    gen = torch.Generator().manual_seed(SEED + 260)
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model, dict(model.named_parameters())


def _grad_rel(got, want) -> float:
    """The largest over the leaves of max |diff| / max |want|."""
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(got, want))


def sp_shard_check(smi: str, device: str) -> dict:
    """ViT-B/32 (vit_base_patch32_224.yaml: 50 tokens) full fine-tune at B =
    ``SP_BATCH`` under sequence parallelism of degree 2, computed as the two
    shards in turn (``two_shards(sequence=True)``: 25 tokens a shard between
    the regions, 6 heads inside, K1-K3 on the gathered 50 tokens): K1-K3 on
    the shards' operands against their plain versions, the logits against the
    whole model (bf16, fp32), every fp32 gradient (the LayerNorms', biases',
    embeddings' and head's included) within ``TOL_TP_GRAD_REL``, K1 24 a
    forward and K2, K3 24 a backward."""
    from peft_vit_tpu_torch.engine import ce_per_example
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import launch_counts

    out = {}
    rng = np.random.RandomState(SEED + 261)
    x = torch.from_numpy(rng.standard_normal((SP_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                         ).to(device)
    y = torch.from_numpy(rng.randint(0, 10, SP_BATCH)).to(device)
    on_card = device == "cuda"
    for dtype in (torch.bfloat16, torch.float32):
        model, params = _full_tower(SP_YAML, SP_MODEL, dtype, device)
        layers, tokens = model.backbone.layers, model.backbone.positional_embedding.shape[0]
        model.train(False)
        got = {}
        for mode in ("whole", "shards"):
            ctx = two_shards(model, sequence=True) if mode == "shards" else contextlib.nullcontext()
            spied = (attention_spy() if mode == "shards" and dtype == torch.bfloat16
                     else contextlib.nullcontext([]))
            before = launch_counts()
            with ctx, spied as calls:
                logits = model(x)
                fwd = {n: c - before[n] for n, c in launch_counts().items()}
                grads = torch.autograd.grad(ce_per_example(logits.float(), y).mean(),
                                            list(params.values()))
            counts = {n: c - before[n] for n, c in launch_counts().items()}
            got[mode] = (logits.detach().float(), grads, fwd, counts)
            if calls and on_card:  # K1-K3 on the shards' (B, 6, 50, 64) operands
                got["kernel_err"] = hold_step_attention(
                    attn, f"sequence parallel {dtype}: the two shards' attention", calls)
            del calls
        whole, shards = got["whole"], got["shards"]
        rel = ((shards[0] - whole[0]).abs().max() / whole[0].abs().max()).item()
        want = {"flash_attention_fwd": TP_DEGREE * layers, "flash_attention_bwd_dq": TP_DEGREE
                * layers, "flash_attention_bwd_dkv": TP_DEGREE * layers}
        counted = {k: shards[3].get(k, 0) for k in want}
        check(rel <= TOL_TP_LOGITS_REL[dtype] and bool(torch.isfinite(shards[0]).all())
              and (not on_card or (shards[2].get("flash_attention_fwd", 0) == TP_DEGREE * layers
                                   and counted == want)),
              f"sequence parallel {dtype}: ViT-B/32 full fine-tune at B={SP_BATCH} as "
              f"{TP_DEGREE} shards in turn ({tokens // TP_DEGREE} of {tokens} tokens a shard "
              f"between the regions, {model.backbone.blocks[0].attn.heads // TP_DEGREE} heads "
              f"inside; K1 {shards[2].get('flash_attention_fwd', 0)} a forward, K1-K3 "
              f"{counted} a step == {TP_DEGREE * layers} each) against the whole model: max "
              f"|logit diff| / max |logit| {rel:.3e} <= {TOL_TP_LOGITS_REL[dtype]:g}")
        row = {"logits_rel": rel, "launches_forward": shards[2], "launches_step": shards[3],
               "kernel_err": got.get("kernel_err")}
        if dtype == torch.float32:
            worst = _grad_rel(shards[1], whole[1])
            check(worst <= TOL_TP_GRAD_REL,
                  f"sequence parallel fp32: every one of the {len(params)} leaves' gradients "
                  f"through the shards (the LayerNorms', biases', embeddings' and head's "
                  f"included) against the whole model's: max |diff| / max |whole| "
                  f"{worst:.3e} <= {TOL_TP_GRAD_REL:g}")
            row["grad_rel"] = worst
        out["bf16" if dtype == torch.bfloat16 else "fp32"] = row
        print(f"sequence parallel {dtype}: launches a two-shard forward {shards[2]}, forward "
              f"and backward {shards[3]}; {smi}", flush=True)
        del model, params, got, whole, shards
        gc_collect(on_card)
    return out


def _stack_like(unrolled: dict) -> dict:
    """An unrolled state dict's ``blocks.<i>.`` leaves stacked as the stacked
    layout names them (``blocks.block.``), the others as they are."""
    import re

    out, grouped = {}, {}
    for k, v in unrolled.items():
        m = re.match(r"(.*)blocks\.(\d+)\.(.*)", k)
        if m:
            grouped.setdefault(f"{m.group(1)}blocks.block.{m.group(3)}", {})[int(m.group(2))] = v
        else:
            out[k] = v
    for k, d in grouped.items():
        out[k] = torch.stack([d[i] for i in range(len(d))])
    return out


def stacked_check(smi: str, device: str) -> dict:
    """``train_main`` on vitb16_sup.yaml at its 12 blocks, B = 64, one epoch
    of 2 steps, with ``TPU.SCAN_LAYERS`` against the unrolled run (``STACKED``:
    the clip off): every step's loss, the trainable leaves, the optimizer
    state and EMA (stacked from the unrolled run's) bit for bit, the eval
    top-1s equal; each run one replay a step with K1-K3 12 each, K1 12 an
    eval batch; each step's time."""
    import shutil

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    runs, out = {}, {}
    for scan in (False, True):
        label = f"stacked layout ({'TPU.SCAN_LAYERS' if scan else 'unrolled'})"
        cfg = driver_cfg({**STACKED, **PP_MODEL, "TPU.SCAN_LAYERS": scan,
                          "OUTPUT_DIR": STACKED_DIR}, FULLSHOT_YAML)
        run = fullshot_drive(label, cfg, smi, device, sync, out_dir=STACKED_DIR)
        tr, splits = run["trainer"], run["splits"]
        layers = tr.model.backbone.layers
        steps = tr.steps_per_epoch * int(cfg.TRAIN.END_EPOCH)
        n_eval = -(-len(splits.y_test) // int(cfg.TEST.BATCH_SIZE_PER_GPU))
        check(tr.model.backbone.scan_layers == scan
              and any(".blocks.block." in k for k in tr.state.trainable) == scan,
              f"{label}: the tower holds its blocks {'stacked' if scan else 'unrolled'}")
        _hold_graphs(label, tr, run["counts"],
                     {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                      "flash_attention_bwd_dkv": layers}, {"flash_attention_fwd": layers},
                     steps, 2 * int(cfg.TRAIN.END_EPOCH) * n_eval)
        snap = _snapshot(tr)
        runs[scan] = {"state": {part: _stack_like(v) for part, v in snap.items()},
                      "losses": torch.stack(run["losses"]).cpu(),
                      "top1": [e["acc"] for e in run["evals"]]}
        row = {"launches": run["counts"], "per_replay": dict(_graphs_of(tr, "train")[0].launches)}
        if on_card:
            row["step_ms"] = _replay_ms(_graphs_of(tr, "train")[0], 10)
            print(f"{label}: the captured step at B={cfg.TRAIN.BATCH_SIZE_PER_GPU}, {layers} "
                  f"blocks {row['step_ms']:.3f} ms (graph replay, CUDA events; {smi})",
                  flush=True)
        out["stacked" if scan else "unrolled"] = row
        del run, tr, splits
        shutil.rmtree(STACKED_DIR, ignore_errors=True)
        gc_collect(on_card)
    a, b = runs[False], runs[True]
    differ = [f"{part}.{k}" for part, leaves in a["state"].items() for k, v in leaves.items()
              if k not in b["state"][part] or not torch.equal(v, b["state"][part][k])]
    n_state = sum(len(v) for v in b["state"].values())
    check(not differ and torch.equal(a["losses"], b["losses"]) and a["top1"] == b["top1"],
          f"stacked layout: train_main with TPU.SCAN_LAYERS == the unrolled run bit for bit: "
          f"{len(b['losses'])} losses, {n_state} stacked state tensors (trainable, momentum, "
          f"EMA), eval top-1s {b['top1']}" + (f"; differ: {differ[:4]}" if differ else ""))
    return out


def pp_check(smi: str, device: str) -> dict:
    """GPipe at full width: vitb16_sup.yaml's ViT-B/16 (12 blocks, stacked)
    staged as ``PP_STAGES`` stages of 3 blocks over the local ring
    (``parallel.LocalRing``: the stages in turn, the arithmetic of a pipe
    group stage by stage), ``PP_MICROBATCHES`` microbatches at B =
    ``PP_BATCH``, full fine-tune, against the unpipelined stacked model: the
    logits (bf16, fp32), every fp32 gradient, K1 48 a forward and K2, K3 48 a
    backward (12 blocks x 4 microbatches), K1-K3 on the microbatches'
    operands against their plain versions; at one microbatch the logits and
    every gradient bit for bit (bf16); the forward and backward's time
    pipelined and not."""
    from peft_vit_tpu_torch.engine import ce_per_example
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.parallel import LocalRing, vit_pipeline_forward

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    rng = np.random.RandomState(SEED + 262)
    x = torch.from_numpy(rng.standard_normal((PP_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
                         ).to(device)
    y = torch.from_numpy(rng.randint(0, 10, PP_BATCH)).to(device)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        model, params = _full_tower(FULLSHOT_YAML, {"TPU.SCAN_LAYERS": True, **PP_MODEL}, dtype,
                                    device)
        layers = model.backbone.layers
        model.train(True)

        def step(m):
            """Logits and every gradient, pipelined over m microbatches (0:
            the unpipelined model)."""
            if m:
                logits = vit_pipeline_forward(model, {}, x, microbatches=m,
                                              transport=LocalRing(PP_STAGES))
            else:
                logits = model(x)
            return logits, torch.autograd.grad(ce_per_example(logits.float(), y).mean(),
                                               list(params.values()))

        got = {}
        for m in (0, PP_MICROBATCHES, 1):
            spied = (attention_spy() if m == PP_MICROBATCHES and dtype == torch.bfloat16
                     else contextlib.nullcontext([]))
            before = launch_counts()
            with spied as calls:
                logits, grads = step(m)
            counts = {n: c - before[n] for n, c in launch_counts().items()}
            got[m] = (logits.detach().float(), grads, counts)
            if calls and on_card:  # K1-K3 on the microbatches' (16, 12, 197, 64) operands
                got["kernel_err"] = hold_step_attention(
                    attn, f"GPipe {dtype}: the microbatches' attention", calls)
            del calls
        plain, piped, one = got[0], got[PP_MICROBATCHES], got[1]
        rel = ((piped[0] - plain[0]).abs().max() / plain[0].abs().max()).item()
        want = {k: layers * PP_MICROBATCHES for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
        counted = {k: piped[2].get(k, 0) for k in want}
        check(rel <= TOL_PP_LOGITS_REL[dtype] and bool(torch.isfinite(piped[0]).all())
              and (not on_card or counted == want),
              f"GPipe {dtype}: ViT-B/16 full fine-tune at B={PP_BATCH} as {PP_STAGES} stages of "
              f"{layers // PP_STAGES} blocks over the local ring, {PP_MICROBATCHES} microbatches "
              f"(K1-K3 {counted} a step == {layers} blocks x {PP_MICROBATCHES}) against the "
              f"unpipelined stacked model: max |logit diff| / max |logit| {rel:.3e} <= "
              f"{TOL_PP_LOGITS_REL[dtype]:g}")
        row = {"logits_rel": rel, "launches_step": piped[2], "kernel_err": got.get("kernel_err")}
        if dtype == torch.float32:
            worst = _grad_rel(piped[1], plain[1])
            check(worst <= TOL_PP_GRAD_REL,
                  f"GPipe fp32: every one of the {len(params)} leaves' gradients through "
                  f"{PP_MICROBATCHES} microbatches against the unpipelined model's: max |diff| / "
                  f"max |plain| {worst:.3e} <= {TOL_PP_GRAD_REL:g}")
            row["grad_rel"] = worst
        else:
            same = torch.equal(one[0], plain[0]) and all(
                torch.equal(a, b) for a, b in zip(one[1], plain[1]))
            check(same, f"GPipe {dtype}: {PP_STAGES} stages at one microbatch == the "
                        f"unpipelined model bit for bit (the logits and {len(params)} gradients)")
            if on_card:
                times = {}
                for name, m in (("unpipelined", 0), ("pipelined", PP_MICROBATCHES)):
                    step(m)
                    sync()
                    ms = []
                    for _ in range(PP_TIMED_REPS):
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        step(m)
                        end.record()
                        end.synchronize()
                        ms.append(start.elapsed_time(end))
                    times[name] = statistics.median(ms)
                row["ms"] = times
                print(f"GPipe {dtype}: forward and backward at B={PP_BATCH}, eager, median of "
                      f"{PP_TIMED_REPS}: unpipelined {times['unpipelined']:.3f} ms, "
                      f"{PP_STAGES} stages x {PP_MICROBATCHES} microbatches in turn on one card "
                      f"{times['pipelined']:.3f} ms (CUDA events; {smi})", flush=True)
        out["bf16" if dtype == torch.bfloat16 else "fp32"] = row
        del model, params, got, plain, piped, one
        gc_collect(on_card)
    return out


def seqpipe_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 21 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"sp": sp_shard_check(smi, device), "stacked": stacked_check(smi, device),
           "pp": pp_check(smi, device)}
    out["seconds"] = time.perf_counter() - t0
    print(f"seqpipe phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


# Tensor and sequence parallelism under the hooks and int8 (phase 22).
# K6's K-cut form at the halves of the GEMMs whose K a model degree of 2 cuts:
# (name, the whole K, N, the cut of K); the dx products of in_proj and c_fc
# contract over their forward's cut N (in_proj's the rank's heads of q, k, v)
TPH_BATCH = 16
KCUT_M = TPH_BATCH * N_TOKENS  # 3,152
KCUT_GEMMS = (("out_proj", WIDTH, WIDTH, "cols"), ("c_proj", 4 * WIDTH, WIDTH, "cols"),
              ("in_proj dx", 3 * WIDTH, WIDTH, "qkv_cols"), ("c_fc dx", 4 * WIDTH, WIDTH, "cols"))
KCUT_TIMED = ("out_proj", "c_proj")  # the K-cut forms the row-parallel forward runs
TPH_MODEL = {}  # ViT-B/16 at its 12 blocks; a rehearsal on the CPU shrinks it
TPH_PROMPTS = 1  # PEFT.PROMPT_TOKENS: 197 + 1 = 198 tokens, 99 a shard between the regions
TPH_LORA = dict(attn_delta="lora", lora_rank=LORA_RANK, lora_alpha=128.0, lora_post_scale_q=True)
# hook: (the PEFTSpec fields beside the prompt, the mask's method, the int8
# recipe (static scales, int8 attention) or None: no int8); every model has
# the prompt token, which trains (the mask's extra), so that 198 tokens split
TPH_HOOKS = {
    "vpt shallow": ({}, "vpt", None),
    "vpt deep": (dict(prompt_deep=True), "vpt", None),
    "adapter": (dict(adapter="houlsby"), "adapter", None),
    "adapterdrop": (dict(adapter="houlsby", adapter_layers=(-1,)), "adapterdrop", None),
    "compacter": (dict(adapter="compacter"), "compacter", None),
    "kadaptation": (dict(attn_delta="kron"), "kadaptation", None),
    "shared_qkv": (dict(TPH_LORA, attn_adapter="shared_qkv"), "lora", None),
    "lepe": (dict(lepe=True), "lepe", None),
    "rpb": (dict(attn_bias="rpb"), "rpb", None),
    "lora_ref_reshape": (dict(TPH_LORA, lora_ref_reshape=True), "lora", None),
    "int8 attention": (TPH_LORA, "lora", (True, True)),
    "int8 static": (TPH_LORA, "lora", (True, False)),
    "int8 dynamic": (TPH_LORA, "lora", (False, False)),
}
TPH_SPIED = "rpb"  # whose shards' operands K1-K3 and K7 are held on (bf16)
# int8 through the shards against the unsplit int8 model: each GEMM equals the
# unsplit one when its codes do, but the shards' upstream sums (LoRA B's rows,
# the split LayerNorm and attention inputs) may round another way and flip a
# code at a .5 boundary, as two devices do: the int8 bounds (PERF.md §2)
TOL_TPH_INT8_REL = {torch.bfloat16: TOL_TP_LOGITS_REL[torch.bfloat16],
                    torch.float32: TOL_INT8_F32_LOGITS_REL}


def kcut_kernel_check(smi: str) -> dict:
    """K6's K-cut form and the partial row absmax against their plain
    versions, equal, and the two halves' int32 route against the unsplit
    K6 bit for bit, at ``KCUT_GEMMS`` (M = ``KCUT_M``), bf16 and fp32,
    dynamic and static; then the times of ``KCUT_TIMED`` (bf16)."""
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.parallel import tp_slice

    gen = torch.Generator(device="cuda").manual_seed(SEED + 270)

    def rand(shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    out = {"max_abs_err": {"partial": 0.0, "absmax": 0.0}, "rows": []}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for name, k, n, cut in KCUT_GEMMS:
            x = rand((KCUT_M, k), dtype)
            w_i8, s_w = i8.quantize_cols(rand((n, k), std=k**-0.5))
            s_x = x.float().abs().max() * 1.5 / 127.0
            halves = [(tp_slice(x, cut, r, TP_DEGREE), tp_slice(w_i8, cut, r, TP_DEGREE))
                      for r in range(TP_DEGREE)]
            amax = [i8.int8_row_absmax(xr) for xr, _ in halves]
            s = i8.row_scales(functools.reduce(torch.maximum, amax))
            acc = [i8.int8_gemm_partial(xr, wr, s_rows=s) for xr, wr in halves]
            acc_st = [i8.int8_gemm_partial(xr, wr, s_x=s_x) for xr, wr in halves]
            torch.cuda.synchronize()
            errs = {"absmax": max((a - i8._row_absmax_plain(xr)).abs().max().item()
                                  for a, (xr, _) in zip(amax, halves)),
                    "partial": max((a - i8._partial_plain(xr, wr, s, None)).abs().max().item()
                                   for a, (xr, wr) in zip(acc, halves))}
            errs["partial"] = max(errs["partial"], max(
                (a - i8._partial_plain(xr, wr, None, s_x)).abs().max().item()
                for a, (xr, wr) in zip(acc_st, halves)))
            for key in errs:
                out["max_abs_err"][key] = max(out["max_abs_err"][key], errs[key])
            check(errs["absmax"] == 0.0 and errs["partial"] == 0.0,
                  f"int8 K-cut {tag} {name} M={KCUT_M} K={k // TP_DEGREE} a half of {k}, N={n}: "
                  f"the partial row absmax and the int32 K-cut form (row scales, static) == "
                  f"their plain versions (max abs err {errs['absmax']:.3e}, {errs['partial']:.3e})")
            route = i8._rescale(acc[0] + acc[1], s.unsqueeze(-1), s_w, dtype)
            route_st = i8._rescale(acc_st[0] + acc_st[1], s_x, s_w, dtype)
            whole, whole_st = i8.int8_gemm_dynamic(x, w_i8, s_w), i8.int8_gemm_static(
                x, w_i8, s_w, s_x)
            local = sum(int((i8.quantize_rows(xr)[0] != torch.round(
                xr.float() / s.unsqueeze(-1)).to(torch.int8)).sum()) for xr, _ in halves)
            check(torch.equal(route, whole) and torch.equal(route_st, whole_st) and local > 0,
                  f"int8 K-cut {tag} {name}: the two halves' int32 route (the global row scale, "
                  f"the int32 sum, the rescale) == the unsplit K6 bit for bit, dynamic and "
                  f"static; the rank-local row scale flips {local} of {x.numel()} codes")
            if dtype != torch.bfloat16 or name not in KCUT_TIMED:
                continue
            xr, wr = halves[0]
            w_t = wr.t()  # (K, N) column-major: torch._int_mm's operand
            m, kr = xr.shape

            def library(xr=xr, w_t=w_t):
                return torch._int_mm(torch.round(xr.float() / s.unsqueeze(-1)).to(torch.int8),
                                     w_t)

            by = m * kr * 2 + n * kr + m * 4 + m * n * 4, 2 * m * kr * n
            row = {"gemm": name, "M": m, "K": kr, "N": n,
                   "ms": _device_ms(lambda: i8.int8_gemm_partial(xr, wr, s_rows=s), 40),
                   "static_ms": _device_ms(lambda: i8.int8_gemm_partial(xr, wr, s_x=s_x), 40),
                   "plain_ms": _device_ms(lambda: i8._partial_plain(xr, wr, s, None), 5, 3),
                   "library_ms": _device_ms(library, 40),
                   "absmax_ms": _device_ms(lambda: i8.int8_row_absmax(xr), 100),
                   "absmax_plain_ms": _device_ms(lambda: i8._row_absmax_plain(xr), 100),
                   "absmax_library_ms": _device_ms(
                       lambda: torch.linalg.vector_norm(xr, float("inf"), dim=-1,
                                                        dtype=torch.float32), 100)}
            row["bound_ms"] = max(by[0] / HBM_BYTES_PER_S, by[1] / INT8_OPS_PER_S) * 1e3
            row["bound_by"] = "bytes" if by[0] / HBM_BYTES_PER_S >= by[1] / INT8_OPS_PER_S \
                else "operations"
            row["absmax_bound_ms"] = (m * kr * 2 + m * 4) / HBM_BYTES_PER_S * 1e3
            out["rows"].append(row)
            print("int8 K-cut timing " + " ".join(
                f"{key}={val:.6f}" if isinstance(val, float) else f"{key}={val}"
                for key, val in row.items()) + f" ({smi})", flush=True)
    return out


def _tph_model(hook: str, dtype, device):
    """ViT-B/16 (``TPH_MODEL`` in a rehearsal) with ``TPH_PROMPTS`` prompt
    tokens and ``hook``, from ``SEED`` (every zero leaf redrawn at 0.02 so
    that each acts): the model, its trainable leaves (the hook's, the
    prompt's, the head's) and the frozen tensors its step takes (the int8
    tree and the whole model's static scales)."""
    from peft_vit_tpu_torch.engine import make_apply_fn
    from peft_vit_tpu_torch.engine.train import calibrate
    from peft_vit_tpu_torch.models import ImageClassifier, VisionTransformer
    from peft_vit_tpu_torch.ops.int8 import quantize_frozen_tree
    from peft_vit_tpu_torch.peft import PEFTSpec, build_mask, split_params

    fields, method, int8 = TPH_HOOKS[hook]
    dims = {"width": WIDTH, "layers": 12, "heads": HEADS, "image": IMAGE, **TPH_MODEL}
    fields = dict(fields)
    if "adapter_layers" in fields:  # AdapterDrop on the last block
        fields["adapter_layers"] = (dims["layers"] - 1,)
    torch.manual_seed(SEED + 271)
    model = ImageClassifier(
        VisionTransformer(image_size=dims["image"], patch_size=PATCH, width=dims["width"],
                          layers=dims["layers"], heads=dims["heads"], output_dim=OUTPUT_DIM,
                          spec=PEFTSpec(method=method, prompt_tokens=TPH_PROMPTS, **fields),
                          int8_train=int8 is not None, int8_attn=bool(int8 and int8[1]),
                          dtype=dtype, device=device),
        num_classes=NUM_CLASSES, dtype=dtype, device=device)
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    mask = build_mask(model, method, num_layers=dims["layers"], extra_regex="prompt_embeddings")
    trainable, frozen = split_params(model, mask)
    extra = {}
    if int8 is not None:
        extra = quantize_frozen_tree(frozen)
    if int8 is not None and int8[0]:
        rng = np.random.RandomState(SEED + 272)
        xc = torch.from_numpy(rng.standard_normal((TPH_BATCH, dims["image"], dims["image"], 3))
                              .astype(np.float32)).to(device)
        extra.update(calibrate(model, make_apply_fn(model), dict(trainable), xc.to(dtype), 1.5))
    return model, trainable, extra


def _hold_bias_grad(label: str, calls: list) -> float:
    """K7 on the operands of each spied attention with a bias (the shards'
    heads of RPB's table): against its plain version within
    ``TOL_DBIAS_REL`` of each cell's largest sum over its batch of |ds|."""
    from peft_vit_tpu_torch.ops import attention as attn

    worst = 0.0
    for c in calls:
        q, k, v, do, bias = c["q"], c["k"], c["v"], c["do"], c["bias"]
        o, lse = attn.flash_attention_fwd(q, k, v, bias, c["scale"], return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, c["scale"], bias)
        got = attn.attention_bias_grad(q, k, v, do, lse, c["scale"], bias, delta=delta)
        want = attn._bias_grad_plain(q, k, v, do, lse, c["scale"], bias, delta=delta)
        scale = _dbias_scale(attn, q, k, v, do, lse, delta, bias, c["scale"])
        err = ((got.float() - want.float()).abs().reshape(scale.shape[0], -1).amax(1)
               / scale).max().item()
        worst = max(worst, err)
    check(worst <= TOL_DBIAS_REL,
          f"{label}: K7 on the operands of the {len(calls)} shards' attention {tuple(calls[0]['q'].shape)} "
          f"with the shards' heads of the table: max abs err / the cell's max sum_b |ds| "
          f"{worst:.3e} <= {TOL_DBIAS_REL:g}")
    return worst


@contextlib.contextmanager
def adapter_relu_signs(model, signs: dict, replay: bool = False):
    """Within, every ReLU ``layers.Adapter`` of ``model`` (the shared qkv
    adapter, a Houlsby adapter with ``act`` relu) records the sign mask of
    its pre-activation at each call into ``signs``, keyed by the module's
    name, the shard (``two_shards``' thread, None outside the shards) and
    the call's order; with ``replay`` the whole model takes the recorded
    masks instead of its own (the shards' heads joined in rank order).  A
    pre-activation within a last bit of 0 may take the other sign in the
    shards, whose GEMMs sum in other orders, and each such flip moves a
    weight gradient by one row's whole outer product: the replay puts both
    runs on the same branch of the ReLU, so that the gradients can be held
    to the fp32 bound."""
    import threading

    from peft_vit_tpu_torch.models import layers

    for name, m in model.named_modules():
        if isinstance(m, layers.Adapter):
            m.relu_name = name  # carried into two_shards' copies
    calls, lock, saved = {}, threading.Lock(), layers.Adapter.forward

    def forward(self, m):
        if self.act is not torch.nn.functional.relu:
            return saved(self, m)
        h = self.down(self.adapter_norm_before(m))
        comm = getattr(layers._TP, "comm", None)
        shard = getattr(getattr(comm, "_local", None), "rank", None)
        with lock:
            i = calls.get((self.relu_name, shard), 0)
            calls[(self.relu_name, shard)] = i + 1
        if replay:
            parts = [signs[(self.relu_name, r, i)] for r in range(TP_DEGREE)
                     if (self.relu_name, r, i) in signs] or [signs[(self.relu_name, None, i)]]
            return self.up(h * torch.cat(parts, dim=1).to(h.dtype)) + m
        signs[(self.relu_name, shard, i)] = h.detach() > 0
        return self.up(self.act(h)) + m

    layers.Adapter.forward = forward
    try:
        yield signs
    finally:
        layers.Adapter.forward = saved


def _sign_flips(whole: dict, shards: dict) -> Tuple[int, int]:
    """The pre-activations whose ReLU sign differs between the whole model's
    run and the shards' (``adapter_relu_signs``), and their count."""
    flips = total = 0
    for (name, shard, i), mask in whole.items():
        parts = [shards[(name, r, i)] for r in range(TP_DEGREE) if (name, r, i) in shards] \
            or [shards[(name, None, i)]]
        flips += int((torch.cat(parts, dim=1) != mask).sum())
        total += mask.numel()
    return flips, total


def hooks_shard_check(smi: str, device: str) -> dict:
    """Each of ``TPH_HOOKS`` on ViT-B/16 with one prompt token at B =
    ``TPH_BATCH``, bf16 and fp32: the whole model, then two tensor-parallel
    and two sequence-parallel shards (``two_shards``), one forward and
    backward of the mean cross-entropy each: the logits within
    ``TOL_TP_LOGITS_REL`` of the whole model's (int8: ``TOL_TPH_INT8_REL``),
    every fp32 trainable gradient within ``TOL_TP_GRAD_REL`` (int8: the int8
    bound), K1-K3 and K7 twice the whole model's launches (``launch_rule``),
    and for the int8 static recipe K6's forms once a shard and GEMM (the
    column-parallel GEMMs the static kernel, the row-parallel ones the K-cut
    form).  On ``TPH_SPIED``'s bf16 shards K1-K3 (``hold_step_attention``) and
    K7 (``_hold_bias_grad``) are held on the shards' operands."""
    from peft_vit_tpu_torch.engine import ce_per_example, make_apply_fn
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops import launch_counts
    from peft_vit_tpu_torch.ops import int8 as i8
    from peft_vit_tpu_torch.peft import merge_params

    on_card = device == "cuda"
    image = TPH_MODEL.get("image", IMAGE)
    rng = np.random.RandomState(SEED + 273)
    x = torch.from_numpy(rng.standard_normal((TPH_BATCH, image, image, 3)).astype(np.float32)
                         ).to(device)
    y = torch.from_numpy(rng.randint(0, NUM_CLASSES, TPH_BATCH)).to(device)
    out, kernel_launches = {}, {}
    attn_keys = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "attention_bias_grad")
    for hook, (_, _, int8) in TPH_HOOKS.items():
        row = {}
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            model, trainable, extra = _tph_model(hook, dtype, device)
            layers = model.backbone.layers
            apply_fn = make_apply_fn(model)
            model.train(True)
            leaves = list(trainable.values())
            got, signs = {}, {}

            def forward_backward():
                logits = apply_fn(merge_params(trainable, extra), x.to(dtype), True)
                # AdapterDrop's skipped adapters and KAdaptation's phmb are never read
                return logits, torch.autograd.grad(ce_per_example(logits.float(), y).mean(),
                                                   leaves, allow_unused=True)

            for mode in ("whole", "tp", "sp"):
                ctx = (two_shards(model, sequence=mode == "sp") if mode != "whole"
                       else contextlib.nullcontext())
                spied = (attention_spy() if hook == TPH_SPIED and mode != "whole"
                         and dtype == torch.bfloat16 else contextlib.nullcontext([]))
                signs[mode] = {}
                before = launch_counts()
                with ctx, spied as calls, adapter_relu_signs(model, signs[mode]):
                    logits, grads = forward_backward()
                counts = {n: c - before[n] for n, c in launch_counts().items()}
                got[mode] = (logits.detach().float(), grads, counts)
                if signs[mode] and mode != "whole" and dtype == torch.float32:
                    # the whole model again on the shards' ReLU signs: the
                    # gradients' reference (``adapter_relu_signs``)
                    with adapter_relu_signs(model, signs[mode], replay=True):
                        got[f"{mode} signs"] = forward_backward()[1]
                if calls and on_card:
                    label = f"{hook} {mode} {tag}: the two shards'"
                    row[f"kernel_err_{mode}"] = hold_step_attention(attn, label + " attention",
                                                                    calls)
                    row[f"k7_err_{mode}"] = _hold_bias_grad(label + " RPB", calls)
                del calls
            whole = got["whole"]
            rule = {k: n for k, n in launch_rule(model, trainable, int8_attn=bool(
                int8 and int8[1])).items() if k in attn_keys}
            for mode in ("tp", "sp"):
                logits, grads, counts = got[mode]
                rel = ((logits - whole[0]).abs().max() / whole[0].abs().max()).item()
                tol = (TOL_TPH_INT8_REL if int8 is not None else TOL_TP_LOGITS_REL)[dtype]
                want = {k: TP_DEGREE * n for k, n in rule.items()}
                if int8 is not None:  # K6 once a shard and GEMM of the forward
                    gemms = TP_DEGREE * 2 * layers  # the column- and the row-parallel pairs
                    want.update({"int8_gemm_static": gemms if int8[0] else 0,
                                 "int8_gemm_dynamic": 0 if int8[0] else gemms,
                                 "int8_gemm_partial": gemms,
                                 "int8_row_absmax": 0 if int8[0] else gemms})
                seen = {k: counts.get(k, 0) for k in want}
                launches_ok = not on_card or (seen == want and {
                    k: whole[2].get(k, 0) for k in rule} == rule)
                check(rel <= tol and bool(torch.isfinite(logits).all()) and launches_ok,
                      f"{hook} {mode} {tag}: ViT-B/16 ({layers} blocks, {TPH_PROMPTS} prompt "
                      f"token) as {TP_DEGREE} {'sequence' if mode == 'sp' else 'tensor'}-parallel "
                      f"shards against the whole model: max |logit diff| / max |logit| "
                      f"{rel:.3e} <= {tol:g}; launches {seen} == {want} (the whole model's "
                      f"{rule} a shard)")
                row[f"{mode}_{tag}"] = {"logits_rel": rel, "launches": counts}
                if dtype == torch.float32:
                    ref = got.get(f"{mode} signs", whole[1])
                    used = [(a, b) for a, b in zip(grads, ref) if b is not None]
                    same_unused = all((a is None) == (b is None) for a, b in zip(grads, ref))
                    worst = _grad_rel(*zip(*used)) if same_unused else float("inf")
                    gtol = TOL_TPH_INT8_REL[dtype] if int8 is not None else TOL_TP_GRAD_REL
                    note = ""
                    if f"{mode} signs" in got:
                        flips, total = _sign_flips(signs["whole"], signs[mode])
                        own = _grad_rel(*zip(*[(a, b) for a, b in zip(grads, whole[1])
                                               if b is not None]))
                        note = (f" run on the shards' ReLU signs (its own differ at {flips} of "
                                f"the adapters' {total} pre-activations; against its own signs "
                                f"{own:.3e})")
                        row[f"{mode}_{tag}"].update(relu_flips=flips, grad_rel_own_signs=own)
                    check(worst <= gtol,
                          f"{hook} {mode} fp32: the {len(leaves)} trainable leaves' gradients "
                          f"through the shards against the whole model's{note}: max |diff| / "
                          f"max |whole| {worst:.3e} <= {gtol:g}")
                    row[f"{mode}_{tag}"]["grad_rel"] = worst
                else:  # the phase's main path: the bf16 shards' launches
                    for k, n in counts.items():
                        kernel_launches[k] = kernel_launches.get(k, 0) + n
            del model, trainable, extra, got, whole, signs
            gc_collect(on_card)
        out[hook] = row
        print(f"tphooks {hook}: " + "; ".join(
            f"{k} logits {v['logits_rel']:.3e}" + (f" grads {v['grad_rel']:.3e}"
                                                   if "grad_rel" in v else "")
            + (f" (ReLU flips {v['relu_flips']}, own signs {v['grad_rel_own_signs']:.3e})"
               if "relu_flips" in v else "")
            for k, v in row.items() if isinstance(v, dict) and "logits_rel" in v)
            + f" ({smi})", flush=True)
    out["launches"] = kernel_launches
    return out


def tphooks_phase(smi: str, device: str = "cuda") -> dict:
    """Phase 22 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"kcut": kcut_kernel_check(smi) if device == "cuda" else {},
           "hooks": hooks_shard_check(smi, device)}
    out["seconds"] = time.perf_counter() - t0
    print(f"tphooks phase: {out['seconds']:.1f} s (host clock; {smi})", flush=True)
    return out


def gc_collect(on_card: bool) -> None:
    import gc

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def _device_breakdown(fn, reps: int, top: int = 6, host_top: int = 0, host: bool = True):
    """Device time per call, the number of device launches (kernels and
    copies) per call and the kernels that take most of the time, from
    torch.profiler's CUDA activity (None when it records no kernel).
    ``host_top`` > 0 also prints the host-side operators that take most self
    CPU time.  ``host`` False records the CUDA activity alone: a run of tens
    of thousands of launches then takes seconds less to trace, and a launch
    or two may go unrecorded (a probe on the H100 lost 2 of 80,000), so it
    serves the busy time of a long run, not a count that is checked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host or host_top else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows, launches = [], 0
    for ev in prof.key_averages():
        # kernels and copies only: a CPU op's row repeats its kernels' time,
        # and the activity-buffer row is the profiler's own
        if ev.device_type != DeviceType.CUDA or ev.key == "Activity Buffer Request":
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((ev.key[:48], t / 1e3 / reps))
            launches += ev.count
    if not rows:
        return None, None, []
    rows.sort(key=lambda r: -r[1])
    if host_top:
        host = sorted(((ev.key[:40], ev.self_cpu_time_total / 1e3 / reps, ev.count / reps)
                       for ev in prof.key_averages() if ev.device_type != DeviceType.CUDA),
                      key=lambda r: -r[1])[:host_top]
        print("host profile (self CPU ms and calls per call of the profiled function, with the "
              "profiler's own overhead): "
              + "; ".join(f"{name} {t:.3f} ms x{n:.0f}" for name, t, n in host))
    return sum(t for _, t in rows), launches / reps, rows[:top]


ZOO_CHILD_FLAG = "--zoo-phase"  # chip_smoke.py --zoo-phase OUT.json: the zoo phase alone


def start_zoo_phase() -> tuple:
    """The zoo phase (17) in a child process of its own, started before the
    kernels' build: none of K1-K7 runs on its paths, so it needs no kernel,
    and the card is idle while nvcc runs.  The parent waits for it before
    its next phase (``finish_zoo_phase``), so no time of the parent's is
    taken while the child uses the card.  Returns (process, result file,
    log file, start time)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    out, log = root / "zoo_phase.json", root / "zoo_phase.log"
    out.unlink(missing_ok=True)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), ZOO_CHILD_FLAG,
                                 str(out)], stdout=f, stderr=subprocess.STDOUT)
    return proc, out, log, time.perf_counter()


def finish_zoo_phase(child: tuple, timeout: float = 600.0) -> dict:
    """Wait for the zoo phase's child, print its output and take over its
    failed checks; the phase fails if the child did not write its result."""
    proc, out, log, t0 = child
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    print(open(log).read(), end="", flush=True)
    result = json.loads(open(out).read()) if out.exists() else None
    check(rc == 0 and result is not None,
          f"zoo phase: the child process exited {rc} and wrote its result: "
          f"{result is not None}")
    FAILURES.extend(f"zoo phase (child): {f}" for f in (result or {}).get("failures", []))
    print(f"phase zoo_phase seconds {time.perf_counter() - t0:.1f} (in a child process from "
          "before the build to its end)", flush=True)
    return result or {"launches": {}}


def zoo_child(out: str) -> int:
    """``chip_smoke.py --zoo-phase OUT``: the zoo phase alone, its launches,
    seconds and failed checks written to OUT as JSON."""
    smi = environment_phase()
    zoo = zoo_phase(smi)
    with open(out, "w") as f:
        json.dump({"launches": zoo["launches"], "seconds": zoo["seconds"],
                   "failures": FAILURES}, f)
    return 0


DRYRUN_CHILD_FLAG = "--dryrun-cpu"  # chip_smoke.py --dryrun-cpu OUT.json: dryrun_check(4, "cpu")
_DRYRUN_CHILD: dict = {}  # the child started by main() (``start_dryrun_cpu``), if any


def start_dryrun_cpu() -> tuple:
    """``dryrun_check(DRYRUN_PROCESSES, "cpu")`` in a child process at nice 19,
    started beside the zoo phase's child: its gloo CPU processes touch no
    card and take only the host's idle cores while the parent builds the
    kernels and waits for the zoo phase.  ``multichip_phase`` takes its
    result over (``finish_dryrun_cpu``).  Returns (process, result file, log
    file)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    out, log = root / "dryrun_cpu.json", root / "dryrun_cpu.log"
    out.unlink(missing_ok=True)
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), DRYRUN_CHILD_FLAG,
                                 str(out)], stdout=f, stderr=subprocess.STDOUT,
                                preexec_fn=lambda: os.nice(19))
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc, out, log


def finish_dryrun_cpu(child: tuple, timeout: float = 600.0) -> dict:
    """Wait for the CPU dryrun's child, print its output and take over its
    failed checks; the check fails if the child did not write its result."""
    proc, out, log = child
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    print(open(log).read(), end="", flush=True)
    result = json.loads(open(out).read()) if out.exists() else None
    check(rc == 0 and result is not None,
          f"dryrun_multichip({DRYRUN_PROCESSES}) on gloo CPU processes: the child process "
          f"exited {rc} and wrote its result: {result is not None}")
    FAILURES.extend(f"dryrun (child): {f}" for f in (result or {}).get("failures", []))
    return (result or {}).get("result", {})


def dryrun_child(out: str) -> int:
    """``chip_smoke.py --dryrun-cpu OUT``: ``dryrun_check(DRYRUN_PROCESSES,
    "cpu")`` alone, its result and failed checks written to OUT as JSON."""
    result = dryrun_check(DRYRUN_PROCESSES, "cpu")
    with open(out, "w") as f:
        json.dump({"result": result, "failures": FAILURES}, f)
    return 0


def _timed(phase, *args):
    """``phase(*args)``, its wall seconds printed: the whole script has 1,200."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {phase.__name__} seconds {time.perf_counter() - t0:.1f}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = environment_phase()
    zoo_child_proc = start_zoo_phase()
    _DRYRUN_CHILD["child"] = dryrun_proc = start_dryrun_cpu()
    try:
        # nvcc at a lower priority: the zoo phase beside it takes longer
        # than the build, so its host work goes first
        _timed(build_phase, True, 10)
    except BaseException:
        for proc in (zoo_child_proc[0], dryrun_proc[0]):
            proc.kill()
            proc.wait()
        raise
    zoo = finish_zoo_phase(zoo_child_proc)
    kern = _timed(kernel_phase)
    kbias = _timed(bias_kernel_phase)
    kern8 = _timed(int8_kernel_phase)
    fused = _timed(fused_kernel_phase)
    slc = _timed(slice_phase, smi)
    trn = _timed(train_phase, smi)
    trn8 = _timed(int8_train_phase, smi, trn["images_per_s"])
    _timed(graph_phase, smi)
    drv = _timed(driver_phase, smi)
    _timed(methods_phase, smi)
    tower = _timed(tower_phase, smi)
    zs = _timed(zeroshot_phase, smi)
    fs = _timed(fullshot_phase, smi)
    ss = _timed(streaming_phase, smi)
    rn = _timed(resnet_phase, smi)
    sw = _timed(swin_phase, smi)
    intr = _timed(intrinsic_phase, smi)
    clip = _timed(clip_phase, smi)
    mc = _timed(multichip_phase, smi)
    sp = _timed(seqpipe_phase, smi)
    tph = _timed(tphooks_phase, smi)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    # (name, key of its timings, line of the TPU kernel, batch of its main path: the
    # row's launches, error and times are that path's, at that batch)
    kernels = [
        ("flash_attn_fwd", "fwd", 247, BUCKETS[1]),
        ("flash_attn_bwd_dq", "dq", 454, TRAIN_BATCH),
        ("flash_attn_bwd_dkv", "dkv", 492, TRAIN_BATCH),
    ]
    lines = []
    for name, key, line, batch in kernels:
        row = kern[key][batch]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": ("peft_vit_tpu_torch/csrc/flash_attn_fwd.cu" if key == "fwd"
                       else "peft_vit_tpu_torch/csrc/attn_bwd_sm90.cuh"),
            "replaces": f"peft_vit_tpu/ops/attention.py:{line}",
            "launches": slc["launches"] if key == "fwd" else trn["launches"][name],
            "launches_serving": slc["launches"] if key == "fwd" else 0,
            "launches_training": trn["launches"][name],
            "launches_driver": drv["bf16 sweep"]["launches"][
                {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                 "dkv": "flash_attention_bwd_dkv"}[key]],
            # the full-shot trainer's full fine-tune through train_main (phase 13)
            "launches_fullshot": fs["full"]["launches"][
                {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                 "dkv": "flash_attention_bwd_dkv"}[key]],
            # train_main over the streaming source with the timm augmentation
            # in the step (phase 14)
            "launches_streaming": ss["full"]["launches"][
                {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                 "dkv": "flash_attention_bwd_dkv"}[key]],
            "b64": {**{k: kern[key][FULLSHOT_BATCH][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                "max_abs_err": kern["max_abs_err_fullshot"][key],
                "max_abs_err_fullshot_step": fs["full"]["kernel_err"][key]},
            "max_abs_err": kern["max_abs_err"][key],
            "batch": batch,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
        # the same kernel with RPB's bias (B = 16, one bias; K2 and K3 its bias
        # instantiations), timed in turns with the bias-free one
        lines[-1]["bias"] = {"ms": kbias[f"{key}_bias_ms"], "ms_without": kbias[f"{key}_ms"],
                             "max_abs_err": kbias["max_abs_err"][f"{key}_bias"],
                             "launches_rpb_round": tower["rpb"]["round"][
                                 "launches_per_replay"].get(
                                 {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
                                  "dkv": "flash_attention_bwd_dkv"}[key], 0)}
        if key == "fwd":
            lines[-1]["eager_ms"] = row["eager_ms"]
            lines[-1]["long_n"] = kern["fwd_long"]
            # the text tower's path: the zero-shot classifier of 100 classes, K1 once a
            # text block and class, with the causal bias at (T, 8, 77, 64)
            lines[-1]["launches_zeroshot"] = zs["text"]["launches"]
            lines[-1]["causal"] = {k: zs["causal"][k] for k in (
                "shape", "ms", "ms_without", "bound_ms", "bound_by", "plain_ms", "library_ms",
                "max_abs_err", "max_abs_err_fp32")}
            lines[-1]["causal"]["library_computes"] = (
                "scaled_dot_product_attention forward with the (N, N) float mask")
        else:
            lines[-1]["library_computes"] = (
                "dq, dk and dv in one scaled_dot_product_attention backward; beside it "
                f"dq (with delta) + dk/dv take {row['backward_ms']:.6f} ms")
    row = kbias["k7"]
    rpb = tower["rpb sweep"]
    lines.append({
        "name": "attn_bias_grad",
        "route": "cuda",
        "source": "peft_vit_tpu_torch/csrc/attn_bias_grad.cu",
        "replaces": "peft_vit_tpu/ops/attention.py:928",
        "replaces_note": "not a Pallas kernel: the bias cotangent of the XLA VJP "
                         "_attention_bias_vjp_bwd (attention.py:928-941) that the JAX package "
                         "takes with a bias",
        "launches": rpb["launches"]["attention_bias_grad"],
        "launches_driver": rpb["launches"]["attention_bias_grad"],
        "launches_per_replay": tower["rpb"]["round"]["launches_per_replay"].get(
            "attention_bias_grad", 0),
        "max_abs_err": kbias["max_abs_err"]["dbias"],
        "batch": TRAIN_BATCH,
        "ms": row["ms"],
        "ms_from_o": row["ms_from_o"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_from_o_ms": row["bound_from_o_ms"],
        "split": row["split"],
        "library_ms": row["library_ms"],
        "library_computes": "dq, dk, dv and the mask's gradient in one "
                            "scaled_dot_product_attention backward with a float attn_mask",
    })
    gemm, batch = INT8_KERNEL_LINE
    row = next(r for r in kern8["rows"] if r["gemm"] == gemm and r["batch"] == batch)
    for variant in ("dynamic", "static"):
        name = f"int8_gemm_{variant}"
        training = {recipe: out["launches"][name] for recipe, out in trn8.items()}
        serving = slc["int8"]["launches"] if variant == "dynamic" else 0
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "peft_vit_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "peft_vit_tpu/ops/int8.py:110",
            "launches": serving if variant == "dynamic" else training["static+dx"],
            "launches_serving": serving,
            "launches_training": training,
            "launches_driver": drv["int8"]["int8_launches"][variant],
            "launches_fullshot": fs["lora_int8"]["launches"][name],
            "max_abs_err": kern8["max_abs_err"][variant],
            "batch": batch,
            "shape": {"gemm": gemm, "M": row["M"], "K": row["K"], "N": row["N"]},
            "ms": row["ms"] if variant == "dynamic" else row["static_ms"],
            "plain_ms": row["plain_ms"] if variant == "dynamic" else row["static_plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_computes": "quantize_rows + torch._int_mm + rescale in PyTorch (several "
                                "launches; the dynamic quantize for both variants)",
            "int_mm_ms": row["int_mm_ms"],
            "linear_bf16_ms": row["linear_bf16_ms"],
        })
    # K6's K-cut form and the partial row absmax (phase 22): their path is the
    # row-parallel int8 GEMMs of the shards; the times at c_proj's half (K =
    # 1,536), out_proj's beside them
    kcut = {r["gemm"]: r for r in tph["kcut"]["rows"]}
    for name, prefix, err in (("int8_gemm_partial", "", "partial"),
                              ("int8_row_absmax", "absmax_", "absmax")):
        row = kcut["c_proj"]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": "peft_vit_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "peft_vit_tpu/ops/int8.py:110",
            "replaces_note": (
                "K6 under tensor parallelism: " + ("its K-cut form (the codes at the model "
                                                   "group's row scales or the static scale, "
                                                   "the int32 accumulator out)"
                                                   if not prefix else
                                                   "its row-quantize prologue's absmax alone, "
                                                   "the rank's part of a row scale")),
            "launches": tph["hooks"]["launches"].get(name, 0),
            "max_abs_err": tph["kcut"]["max_abs_err"][err],
            "batch": TPH_BATCH,
            "shape": {"gemm": "c_proj", "M": row["M"], "K": row["K"], "N": row["N"]},
            "ms": row[f"{prefix}ms"],
            "plain_ms": row[f"{prefix}plain_ms"],
            "bound_ms": row[f"{prefix}bound_ms"],
            "bound_by": row["bound_by"] if not prefix else "bytes",
            "library_ms": row[f"{prefix}library_ms"],
            "library_computes": ("the codes at the row scales in PyTorch + torch._int_mm"
                                 if not prefix else
                                 "torch.linalg.vector_norm(x, inf, dim=-1, dtype=float32)"),
            "out_proj": {k: kcut["out_proj"][f"{prefix}{k}"] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")} | {"K": kcut["out_proj"]["K"]},
        })
        if not prefix:
            lines[-1]["static_ms"] = row["static_ms"]
    for name, key, line in (("fused_short_attn_fwd", "fwd", 643),
                            ("fused_short_attn_bwd", "bwd", 673)):
        row = fused[key][FUSED_KERNEL_LINE_BATCH]
        lines.append({
            "name": name,
            "route": "cuda",
            "source": ("peft_vit_tpu_torch/csrc/fused_short_attn.cu" if key == "fwd"
                       else "peft_vit_tpu_torch/csrc/attn_bwd_sm90.cuh"),
            "replaces": f"peft_vit_tpu/ops/attention.py:{line}",
            "launches": fused["launches"][key],
            "max_abs_err": fused["max_abs_err"][key],
            "batch": FUSED_KERNEL_LINE_BATCH,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_computes": (
                "scaled_dot_product_attention forward" if key == "fwd" else
                "dq, dk and dv in one scaled_dot_product_attention backward"),
            ("flash_fwd_ms" if key == "fwd" else "flash_bwd_ms"):
                row["flash_fwd_ms" if key == "fwd" else "flash_bwd_ms"],
        })
        lines[-1]["long_n"] = fused[f"{key}_long"]
        if key == "fwd":
            lines[-1]["eager_ms"] = row["eager_ms"]
    # the ResNet family's paths (phase 15): K1 in the RN50 zero-shot text
    # tower only; the RN towers launch none of the kernels
    wrapper = {"flash_attn_fwd": "flash_attention_fwd", "flash_attn_bwd_dq": "flash_attention_bwd_dq",
               "flash_attn_bwd_dkv": "flash_attention_bwd_dkv",
               "attn_bias_grad": "attention_bias_grad",
               "fused_short_attn_fwd": "fused_short_attention_fwd",
               "fused_short_attn_bwd": "fused_short_attention_bwd"}
    for line in lines:
        line["launches_resnet"] = rn["launches"].get(wrapper.get(line["name"], line["name"]), 0)
        # the Swin family's paths (phase 16): K1-K3 and K7 at head dim 32 in
        # the Swin tower (serving, the full-shot step, the rounds), K1 at 64
        # in the CLIP Swin text tower
        line["launches_swin"] = sw["launches"].get(wrapper.get(line["name"], line["name"]), 0)
        # the zoo's other CNNs (phase 17): none of the kernels on any path
        line["launches_zoo"] = zoo["launches"].get(wrapper.get(line["name"], line["name"]), 0)
        # a replay of the intrinsic step (phase 18; Fastfood over every mlp of
        # ViT-B/16) and of the CLIP pre-training step (phase 19; 12 image and
        # 12 text blocks, the text tower's causal bias in K1-K3)
        name = wrapper.get(line["name"], line["name"])
        line["launches_intrinsic"] = intr["launches"].get(name, 0)
        line["launches_clip"] = clip["launches"].get(name, 0)
        # a replay of train_main's step over the one-rank NCCL group (phase
        # 20), and ViT-B/16 LoRA's forward and backward as two
        # tensor-parallel shards in turn (6 heads each)
        line["launches_multichip"] = mc["replicated"]["per_replay"].get(name, 0)
        line["launches_tp_two_shards"] = mc["tp"]["bf16"]["launches_step"].get(name, 0)
        # phase 21: ViT-B/32's forward and backward as two sequence-parallel
        # shards in turn; a replay of train_main's step with the stacked
        # blocks; ViT-B/16's forward and backward as 4 GPipe stages of 4
        # microbatches over the local ring
        line["launches_sp_two_shards"] = sp["sp"]["bf16"]["launches_step"].get(name, 0)
        line["launches_stacked"] = sp["stacked"]["stacked"]["per_replay"].get(name, 0)
        line["launches_gpipe"] = sp["pp"]["bf16"]["launches_step"].get(name, 0)
        # phase 22: ViT-B/16 with a prompt token under every hook and int8 as
        # two tensor- and two sequence-parallel shards, forward and backward
        line["launches_tp_hooks"] = tph["hooks"]["launches"].get(name, 0)
        key = {"flash_attn_bwd_dq": "dq", "flash_attn_bwd_dkv": "dkv",
               "flash_attn_fwd": "fwd"}.get(line["name"])
        if key is not None:
            # K1-K3 on the text tower's causal operands (32, 8, 77, 64) of
            # train_clip's own step, bf16 (the captured run's eager twin) and fp32
            line["causal_train_clip"] = {
                dtype: clip[f"causal_{dtype}"][key] for dtype in ("bf16", "fp32")}
    # the D = 32 instantiations at Swin-T's stage-0 and stage-2 folds, B = 64
    # (swin_kernel_timing), and the full-shot step's launches a replay
    d32 = {"flash_attn_fwd": "fwd", "flash_attn_bwd_dq": "dq", "flash_attn_bwd_dkv": "dkv",
           "attn_bias_grad": "k7"}
    kswin = sw["kernels"]
    for line in lines:
        key = d32.get(line["name"])
        if key is None:
            continue
        line["d32"] = {
            "max_abs_err": kswin["max_abs_err"][{"fwd": "fwd", "dq": "dq", "dkv": "dk",
                                                 "k7": "dbias"}[key]],
            "launches_per_swin_step": sw["fullshot"]["per_replay"].get(
                wrapper[line["name"]], 0),
            **{f"stage{st}": {k: v for k, v in (kswin["k7"][st] if key == "k7"
                                                else kswin[st][key]).items()
                              if k in ("ms", "ms_from_o", "plain_ms", "bound_ms", "bound_by",
                                       "bound_from_o_ms", "library_ms", "split")}
               for st in (SWIN_K7_TIMED_STAGES if key == "k7" else SWIN_TIMED_STAGES)}}
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == ZOO_CHILD_FLAG:
        sys.exit(zoo_child(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == DRYRUN_CHILD_FLAG:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
