#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``keep_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (a failing phase raises, and the script
exits non-zero without a result line):

1. device   — needs CUDA; prints the card and its power limit; TF32 off.
2. build    — compiles the CUDA kernels from ``keep_tpu_torch/kernels/csrc``
   (one nvcc per source, in parallel).
3. kernel   — ``attention_qkv_slab`` against its plain PyTorch version at the
   serving shapes (ViT-L: S=197, H=16, no bias; BERT-base: S=256, H=12,
   padded key bias; each at B=32 and B=128), in fp32 (atol = rtol = 2e-5)
   and bf16 (max |Δ| < 0.05 on unpadded query rows), each timed with CUDA
   events,
   beside ``F.scaled_dot_product_attention`` on the same values (a
   yardstick the port never calls; the backend that ran is recorded).
   Then the bf16 → fp32 form the int8 blocks run (its own ``wgmma`` body)
   at the same shapes: max |Δ| < 0.05 on unpadded query rows, with the
   mean |Δ| and the share of the int8 codes re-quantized from it that move
   against those from the plain version (none by more than one), timed
   beside its bound and SDPA's bf16 time (a reading, not a yardstick: no
   one call computes the fp32-out function); and at every edge length of
   ``tests/test_torch_gpu.py`` (S = 1 … 512), padded and unpadded.
   heads — ``flash_attention`` / ``attention_qkv_heads`` (split q, k, v) at
   the same shapes and tolerances (BERT with a [B, 1, 1, S] mask), bit for
   bit against ``attention_qkv_heads`` and ``attention_qkv_slab`` on the
   same values, timed beside SDPA;
   then its path, ``ops.nn.mha_attention(use_flash=True)``, with its
   launches counted.
   int8_kernel — the int8 counterparts of the TPU kernels (the ViT and BERT
   attention sub-blocks, the MLP pair in both towers' forms and flat, the
   patch-embed and visual-head matmuls) against their plain versions at the
   serving shapes, in fp32 at the JAX package's tolerances for each
   (``tests/test_quant.py``; the attention sub-blocks, whose attention
   runs on the tensor cores in another order, at its tolerance between two
   routes: atol = rtol = 2e-2 and cosine ≥ 0.9999 per row), with the share
   of int8 codes that differ from the plain version's (for the attention
   sub-blocks also the codes re-quantized from the kernel's attention
   against the plain attention's on the same slab, none moving by more
   than one); kernel and plain times in bf16. The flat MLP pair
   bit for bit against the [B, S, D] form, and its path, ``ops.nn.Mlp`` on
   an int8 fc1/fc2 pair and a 2-D input, with its launches counted.
   int8_primitive — the three CUDA kernels alone (quant_rows, int8_gemm,
   ln_rows) at the shapes #4 and #6 give them in a ViT-L dispatch at B=32
   and B=128 (the qkv, proj, fc1 and fc2 GEMMs with their epilogues; the
   row passes over the stream, the attention output and the MLP hidden;
   BERT's post-LN rows), bit for bit against their plain versions, each
   with its device time, its bound and, for the GEMMs, TOP/s beside cuBLAS
   int8 (``torch._int_mm``) on the same operands.
   ln_matmul — the fused LayerNorm → matmul against its plain version at the
   ViT-L qkv and fc1 shapes (M = 197·B for B = 32 and 128, K = 1024, N =
   3072, 4096), fp32 at 2e-5 and bf16 within one bf16 rounding, timed
   beside the unfused cuBLAS route (``F.layer_norm`` then ``F.linear``)
   and the product alone in cuBLAS, with its statistics pass's device time
   and its share of the bound. fuse_ln_path — a full-width
   ViT-L/16 (224², bf16, B = 128, random weights whose blocks all move the
   stream) under ``use_flash=True, fuse_ln=True`` and its visual head,
   against ``fuse_ln=False``: cosine ≥ 0.999 per row, 48 ``ln_matmul`` and
   24 attention launches per forward, every ``ln_matmul`` call of the
   forward against its plain version on the same inputs (bf16 tolerance as
   above), two faults planted in the kernel's result that must each fail
   one of these gates, both forwards' device times and ``ln_matmul``'s
   share.
   attention_shapes — #1 (the slab) and #2 (split q, k, v and [B, H, S,
   Dh] heads) at the OpenCLIP zoo's shapes: Dh = 80, 88, 104, 112 at S =
   257 (ViT-H-14, ViT-g-14 / EVA01-g-14, ViT-bigG-14, ViT-e-14) and Dh =
   64 at S = 577, 785 (ViT-L-14-336, KEEP at 448²), padded and unpadded,
   fp32 bit for bit against the plain version (its bits: PyTorch's warp
   softmax serves these rows), bf16 at max |Δ| < 0.05, the three layouts
   the same bits, each call's launch counted; then every ``EDGE_S`` length
   at Dh = 64 and 80 (B = 2, H = 2), and fp32 at ``F32_STREAMED_S`` (the
   three-pass body's rows, within 2e-5). Each shape's bf16 time beside its
   bound, the plain version's and SDPA's.
   zoo_serve — ``factory.create_model("ViT-H-14")`` from a seed in bf16
   (vision 32 × 1280, Dh = 80; text 24 × 1024, context 77): uint8 images
   through ``ops.preprocess`` at the preset's ``preprocess_config`` into
   ``encode_image(use_flash=True)`` at B = 64, 32 attention launches a
   batch, unit rows at cosine ≥ 0.999 per row of ``use_flash=False`` on the
   same weights, tiles/s; then the text tower: ``text.bpe`` on a merges
   file the script writes, ``build_zero_shot_classifier`` over the 1,000
   ImageNet classes × the 7 simple templates (prompts/s, the build's ms)
   and ``zero_shot_eval_imagenet`` on the image batch (printed; random
   weights, so the accuracies mean nothing).
   long_seq — ``ViT-L-14-336`` (S = 577) and the KEEP ViT-L/16 at 384² and
   448² (S = 577, 785; the pos embed resampled), B = 32, bf16, fused
   attention against the plain route: cosine ≥ 0.999 per row, 24 launches
   each.
   zoo_towers — the zoo's other towers from ``factory.create_model`` at
   their published width and depth, bf16, random weights from seed 0 with
   the JAX init's statistics, each freed before the next (cuDNN's TF32 is
   off, phase 1, so the fp32 convolutions run in fp32): the image presets
   RN50x64 (448²), convnext_xxlarge_320, swin_base_patch4_window7_224,
   EVA02-L-14-336 (rope at S = 577), EVA02-E-14-plus (64 × 1792,
   post-norm) and vit_relpos_medium_patch16_cls_224 at B = 32, uint8
   images through ``preprocess_config``; the text presets ViT-B-32-bert
   (path-BERT, 256 tokens), xlm-roberta-large-ViT-H-14 (S = 512),
   roberta-ViT-B-32 (77) and mt5-xl-ViT-H-14 (24 × 2048, 256) at B = 64,
   random ids with padded rows; then the registry's ``kep`` (image, text
   and knowledge towers) and ``rn50-clip``. Per preset: parameters, build
   ms, forward ms, tiles/s or prompts/s, the least cosine of bf16 against
   fp32 on the same weights (1 for RN and Swin, which compute in fp32
   whatever dtype is asked, as in the JAX package), finite unit features;
   the BERT-family towers through #1: one launch a layer, cosine ≥ 0.999
   per row against plain attention. Then the card against the port on the
   CPU: one preset per tower kind at full width, every stack cut to 2
   blocks, B = 2, fp32, at the tolerance of that component's CPU test.
   Then ROADMAP queue 3's check: BERT-base width, 2 layers, bf16, #1
   against plain attention on ``bert_check_inputs``'s seeded weights (the
   CPU test takes the JAX package's distance on the same values).
4. server   — a full-width KEEP (ViT-L/16 + BERT-base) with random weights
   written in the released checkpoint layout, loaded by
   ``keep_tpu_torch.serve.build_server`` (bf16, fused attention), warmed up
   and driven over HTTP. The served features must be finite unit vectors of
   width 768 that agree (cosine ≥ 0.999) with the same weights run without
   the kernel, and the kernel's launch count must show that every block of
   every dispatch went through it.
5. numbers  — image and text throughput at bucket 128, the device-time
   share of the attention kernel, and the device time of one image and one
   text dispatch by kernel family (``scripts/torch_dispatch_profile.py``'s
   families), beside the card's name and power limit.
6. int8_drift — the int8 model of phase 4's weights against phase 4's
   features, reported, not gated: on weights whose every block moves the
   stream, W8A8 drifts further than on the JAX package's init statistics.
   server (int8) — weights drawn with the statistics of the JAX package's
   ``keep.init`` (on which its int8 gate, ``bench.py`` ``_int8_gate``, is
   measured) served by ``build_server([..., "--int8"])`` and driven over
   HTTP as in phase 4: finite unit features, cosine ≥ 0.999 per row against
   the same weights served in bf16, against the same int8 model with its
   blocks' plain versions at the JAX package's gate between two int8 routes
   (mean cosine of the image rows and cosine of the text features taken
   whole > 0.9999; the per-row cosines reported), and launch counts that
   show every block of every dispatch went through the int8 attention
   sub-block and MLP pair of its tower.
7. numbers (int8) — the same throughputs and breakdowns for the int8
   server, whose attention must show as the ``wgmma`` body's kernel.
8. attention_bwd — the backward kernel of ``attention_qkv_slab`` against its
   plain version at the training shapes at B=32 and B=128 (ViT-L: S=197,
   H=16, zero key bias; BERT-base: S=256, H=12, padded key bias), fp32 at
   atol 2e-4, rtol 1e-4 and bf16 within 1e-2 of the largest plain gradient
   on unpadded rows, each timed with CUDA events and in profiler device ms
   beside SDPA's backward (through autograd) in both; then the bf16 and
   fp32 forms at every ``EDGE_S`` length at Dh 64 and 80 (B=2, H=2),
   unpadded and with a ragged key mask, at the same gates, one launch a
   call.
9. train — ``keep_tpu_torch.train.main.main(["--config", <json>,
   "--device", "cuda"])`` on the values of ``configs/keep_train.yml``
   (batch 128, 32 captions, lhp-hn, amp_bf16, fused attention, both towers
   frozen in epoch 0) at full width from a random init, on PNG tiles,
   groups, a DO graph and a vocab written from a seed: 2 epochs of 4 steps. Every loss finite; no backward launch
   and towers equal to the seed's initial weights while frozen; in epoch 1
   every step launches the backward kernel once per block and the forward
   kernel twice (remat), and the towers move; a checkpoint that
   ``restore()`` reads back. Prints ms per unfrozen step, samples/s, peak
   device memory and the device time of the last step by kernel family.

The zero-shot WSI sweep runs between phases 7 and 8, on phase 6's weights
(``keep.init`` statistics), through ``keep_tpu_torch.wsi.run.load_model``,
once in bf16 and once with ``--int8`` (calibration 0). Every fp32 product
of the sweep is checked to give the same bits with TF32 on, against a
control: with the guard (``ops.nn.ieee_fp32``) taken out, TF32 must move
the bicubic's pixels, the probabilities and the screening's scores. The
kernels are held against their plain versions at the shapes this path
gives them (batch 256; text widths as dispatched).

10. wsi_extract — a flat 16,384² synthetic slide from a seed →
    ``io.tiles.cut_tiles`` (~3,300 tissue tiles of 256²) →
    ``wsi.extract.extract_features(resize=True, batch_size=256)``: the
    bicubic 256 → 224 and the ViT-L on the card. Gates: the card's bicubic
    against the CPU's on 64 tiles (≤ 1/255); the features against plain
    attention on the first batch (cosine ≥ 0.999); ``pipeline_depth`` 1
    against 3 (the same bits); the padded tail batch against its rows
    alone (cosine ≥ 0.9999); int8 against bf16 (cosine ≥ 0.999) and, on
    the first batch, against the same int8 model with plain blocks (mean
    row cosine > 0.9999, tests/test_quant.py:300); one attention (int8:
    sub-block and MLP pair) launch per block and batch.
    Prints tiles/s from uint8 tiles to fetched features, bf16 and int8, the
    bicubic's ms per batch and the idle share of a profiled run.
11. wsi_classifier — ``zeroshot.build_classifiers_batched`` over 1,386
    two-class prompts (texts of 5–40 tokens from ``VOCAB``) with
    ``length_buckets="auto"`` and then flat: columns at cosine ≥ 0.9999,
    the plan and its tier, prompts/s of each, 12 attention launches a text
    dispatch; one batch of each width dispatched against the same BERT
    with plain attention (cosine ≥ 0.999 per row); the flat build with the
    int8 text tower (cosine ≥ 0.999), its batches against the same int8
    model with plain blocks (> 0.9999 taken whole, tests/test_quant.py:327).
12. wsi_pipelines — 100,000 patches on a 317 × 317 grid (D = 768, a
    tumour disc): ``prompt_select`` (top 50 of 1,386), ``random_ensemble``,
    detection (overlap off and on), segmentation (a level-0 mask at 32
    pixels a patch), subtyping (3 classes + Normal) and the tumour heatmap
    on the card, each held against the same functions on the CPU:
    probabilities and the merged classifier at 1e-5, the same top-50 set,
    decisions, AUROC, Dice and heatmap bytes equal (patches within 1e-5 of
    a threshold counted; only they may move a value, by at most what they
    can move it). Prints the ms of each step.

Then:

15. int8_calibrated — on phase 4's weights (the random draw, whose
    blocks all move the stream): ``KEEPModel.quantize(calib_pixels,
    calib_text)`` (SmoothQuant) with 4 outlier channels injected per
    LayerNorm, on 32 seeded tiles and 64 seeded prompts, timed; one batch
    of 224 tiles and 256 prompts through the calibrated int8 towers.
    Gates: launches per block and batch (#1's inside the sub-blocks too);
    the calibrated features at cosine ≥ 0.999 per row against the same
    model in bf16, and the plain W8A8 ViT's below 0.999 (the BERT's is
    printed); against the calibrated model with plain blocks, image rows
    ≥ 0.999 and text taken whole > 0.9999; #4 (sum and update), #5 (with
    ``pre_scale``), #6 (ViT; BERT
    with ``pre_scale1``), #8 and #9 against their plain versions at the
    smoothed weights, on the inputs the path gave them (2e-2 and cosine ≥
    0.9999 per row for #4 / #5, bit for bit for the others).

Then, on phase 6's weights again:

16. wsi_pyramid — phase 10's slide as a PIL-written multi-page TIFF
    (16,384² and its 4× and 16× levels) → ``io.wsi.open_slide`` →
    ``io.tiles.iter_wsi_tiles`` → ``extract_features``, bf16 and ``--int8``
    at ``--int8-calib 32`` (cosine ≥ 0.999 per row), tiles/s and the host's
    read time; ``wsi.cascade.cascade_detect`` at margin 0.5 (the plain
    sweep's decisions) and 0.15 with a classifier that spreads the coarse
    calls (some tiles refined, the rest at their parent's call; coarse and
    fine encodes, ms). The reader's backend is printed and must be the one
    ``scripts/torch_native_probe.sh`` allows (native libtiff, else PIL), as
    is the route ``wsi.run`` takes.

After phase 9:

13. lora_train — ``keep_tpu_torch.train.main.main([..., "--device",
    "cuda"])`` on phase 9's values and data with ``solver.lora_rank`` 8
    (α 16, the default targets), the eval every epoch on eval sets written
    from a seed (256 PNG tiles in 4 classes with a 50-round prompt JSON,
    256 retrieval pairs, 256 validation pairs), checkpoints every epoch
    written asynchronously and a remote sync to a local directory: 2
    epochs of 4 steps, both towers frozen in epoch 0. Gates: every loss
    finite; after every step every base parameter bit-equal to its value
    at step 0, which is the seed's draw; at step 0 the merged model's
    features bit-equal to the base's (b = 0); in epoch 0 the towers'
    adapters unmoved and the visual head's moved; the steps' launches as
    phase 9's; each eval's first image and text batch at cosine ≥ 0.999
    per row of the same merged weights with plain attention, and one
    attention launch per block of each of its encodes; every eval metric
    finite, in [0, 1] or a rank ≥ 1; epoch 0's checkpoint, written while
    epoch 1 ran, bit-equal to the adapters at epoch 0's end; the synced
    copy byte for byte, without a ``.tmp``. Prints ms per unfrozen LoRA
    step, samples/s, peak device memory, the last step's device ms by
    kernel family, the eval's seconds, and the async saves' blocking ms
    beside a synchronous save's.
14. lora_serve — ``serve.build_server(["--lora", <phase 13's
    checkpoints>, ...])`` over the run's base (the seed's draw in the
    released layout), the scale from the run's params.txt, in bf16 and
    with ``--int8``: every targeted weight's fp32 values bit-equal to
    ``merge_lora`` of the restored adapters (the stored bf16 weight their
    one rounding); bf16 features finite unit rows at cosine ≥ 0.999 per
    row of the trained model's own merged encode; int8 at ≥ 0.999 of the
    bf16 server's; the int8 sub-block and MLP launches cover every block.

After phase 14, the model families ported last:

17. coca — ``coca_ViT-L-14`` from ``factory.create_model`` at published
    width and depth, bf16 (vision 24 × 1024, patch 14 on 224², S = 257,
    the 8-head attentional pooler over 256 queries; text 12 × 768 over 76
    tokens, vocab 49,408; decoder 12 layers): the image tower through #1
    (24 launches a batch of 32, latents at cosine ≥ 0.999 per row of plain
    attention), the training forward and ``coca_loss``, a greedy caption
    (``coca.generate``, 20 tokens, B = 4) and a beam one (3 beams, 12
    tokens), one loss backward through #1b at S = 257 (24 launches), #1
    against its plain version at the trunk's shape; ``coca_roberta-ViT-
    B-32``'s RoBERTa tower through #1 with its key mask (12 launches, ≥
    0.999) and its per-length greedy captions; the card against the CPU
    at 2 blocks a stack, full width, fp32, at 1e-5 (tests/test_torch_coca).
18. pmc_clip — ``factory.create_model("pmc-clip")`` at its config's
    defaults (RN50 with output 768, BERT-base, 4 fusion layers), bf16: the
    unmasked text through #1 with a zero key bias (12 launches, ≥ 0.999 per
    row of plain), the fusion module, the MLM head and ``mlm_loss``; card
    against CPU at 2 blocks, 1e-5.
19. moe — the Switch-MoE KEEP (ViT-L/16 224² with 8 experts, top-1,
    capacity factor 1.25, both ``moe_dispatch`` values; BERT-base) from
    ``KEEPModel.init``, bf16: features and aux; W8A8, W8A16 and calibrated
    int8 trunks at a mean row cosine ≥ 0.999 against bf16 on the bf16
    run's pinned routes (``scripts/moe_lab.py --route-study``'s measure),
    the least row's and the free-routing cosines and the share of routes
    moved beside it; the W8A8 model served through
    ``serve.InferenceServer``: 49 #8 launches an image dispatch (the 48 qkv /
    proj of the trunk and the patch embed), 2 #9, 12 #5 and 12 #6 a text
    dispatch; #8 bit for bit against its plain version on that dispatch's
    qkv and proj inputs, timed there; routes and features of a 2-block
    full-width trunk on the card against the CPU; then two unfrozen
    training steps through ``train.main`` at ``keep_train.yml``'s values,
    batch 128: losses finite, #1 24 and #1b 12 launches a step, the router
    and experts moved, ms a step and peak memory.
20. compat — phase 4's random draw written back in the released layout
    (``compat.export.save_pretrained``) as the ``keep`` entry of a
    temporary ``KEEP_TPU_HOME`` and loaded by name
    (``factory.create_model("keep", pretrained="keep")``, bf16, the fused
    attention): features equal to the source model's bit for bit, 24 + 12
    #1 launches; then calibrated (32 tiles, 64 prompts), written as the
    int8 deploy artifact (``save_quantized``) and served by ``serve --int8``
    over HTTP, which prints that it serves the artifact as it is: features
    equal to the in-memory int8 model's through the same server core, #4
    24 / #5 12 / #6 24 + 12 / #8 1 / #9 2 launches a dispatch pair; the
    artifact's bytes against the fp32 ``pytorch_model.bin``.
21. aot — the bf16 model (weights as inputs) and the int8 model (weights
    baked) exported by ``compat.aot.save_aot`` at buckets (1, 8, 32), then
    loaded and run in a fresh process (``chip_smoke.py --aot-child``) at
    batches 5 (padded to 8) and 32: per-row cosine ≥ 0.99999 against the
    eager model with max |Δ| reported, the same launches as eager counted
    in that process, export and load seconds, ms a call against eager.
22. fast_tokenizer — ``factory.get_tokenizer("bert", ...)`` takes the
    native WordPiece (built from ``native/wordpiece.cpp`` and ``bpe.cpp``
    alone): ids equal to the Python tokenizer's on phase 11's prompts, both
    timed, and phase 11's flat classifier build timed with each.
23. profiling — ``utils.profiling.trace`` around one bf16 image dispatch:
    the Chrome trace names the ``keep::attention_qkv_slab`` operator and
    its kernel.

24. dp — data parallelism through the entry points. (a) ``train.main``
    under a torchrun-style environment at world 1 over NCCL, at
    ``keep_train.yml``'s values (full width and depth, batch 128, 3 open
    steps), against the same steps in one process: losses and trained
    parameters bit for bit, #1 72 / #1b 36 launches a step, ms a step,
    peak memory, and the gradient all-reduce's time beside its bytes'.
    (b) Two ranks over gloo, both on ``cuda:0`` (``chip_smoke.py
    --dp-child``), fp32 with TF32 off: the dp case of phase 26. (c) ``serve
    --mesh-dp 1`` in bf16 and with ``--int8``: features bit-equal to the
    plain server's at buckets 1, 8, 32 and 128, the launches of a
    bucket-128 dispatch pair, tiles/s and prompts/s of both servers in
    turns. (d) ``wsi.run extract`` with and without ``--mesh-dp`` (bf16 and
    ``--int8``) on the top-left 8,192² of phase 10's slide: the same
    printed lines and h5 features (an npz stands in for h5py where it is
    missing); then ``prompt_select_sharded``, ``score_tiles_sharded`` and
    ``refined_probs_sharded`` on a mesh of the card against their
    unsharded forms: the same bits. (a) runs after phase 9, (b) with 26,
    (c) and (d) after phase 16.
25. wide_shapes — after phase 9: (a) #1b and the bf16 → fp32 form of the
    int8 blocks' attention at the shapes they were widened to (Dh 64 at
    S = 577 / 785; Dh 80 / 88 / 104 / 112 at S = 257; B = 32, H = 16)
    against their plain versions at phase 8's and phase 3's gates, timed
    beside their bounds and SDPA (backward through autograd beside #1b,
    in events and profiler device ms; the bf16 forward beside the fp32
    form); (b) an int8 KEEP at 384² and
    448² (``keep.init`` statistics) through the server core at bucket 32:
    int8 against bf16 at cos ≥ 0.999 per row, against its plain blocks at
    the JAX route gate (> 0.9999), #4 / #5 launched; (c) KEEP trained at
    384² (S = 577), batch 32, 3 open steps in bf16: finite losses, #1 72 /
    #1b 36 launches a step, the first step's gradient norms against a
    plain-attention step (each leaf within 5e-2, the global norm within
    3e-3).
26. dp2_layouts — after 24a: dp, fsdp, tp = 2 and tp = 2 + sp at world
    2, tp = 2 + fsdp at world 4 (dp 2 × mp 2)
    (``train/trainer.ParallelLayout``), over gloo on the one card (every
    rank on ``cuda:0``), fp32 with TF32 off, KEEP at full width with 6
    blocks a tower, global batch 16, 3 steps, all layouts' ranks started
    together: each rank's losses within rtol 1e-5 / atol 1e-6 of one
    process's; each leaf's first-step gradient (gathered from the ranks'
    pieces) against one process's, its norm within 1e-4 and its sum within
    1e-4 of the leaf's sum of magnitudes (dp's norms within rtol 1e-5 /
    atol 1e-6, its sums within 1e-5 of the sum of magnitudes); #1 / #1b
    per rank as the blocks give them (under tp each launch takes H/2
    heads); per rank the resident state's bytes (the compute copy, the
    optimizer's leaves and moments, each tensor once) beside dp's and the
    peak memory.
27. pp_ep_layouts — after 26, in its setting but the depth (gloo ranks
    on ``cuda:0``, fp32, full width, 2 blocks a tower, batch 16, 3
    steps): pp = 2 at world 2 and dp 2 × pp 2 at world 4 on the dense
    KEEP (GPipe over the ViT trunk, two microbatches a dp index,
    ``parallel.pp``), ep = 2 at world 2 and dp 2 × ep 2 at world 4 on the
    8-expert MoE KEEP of phase 19 with the grouped einsum dispatch
    (``models.moe.shard_experts_``), each kind against its own one-process
    run, the four layouts' ranks started together: phase 26's gates
    (losses, each leaf's first-step gradient norm and sum), #1 / #1b per
    rank as a stage's blocks × microbatches give them (BERT's alone on the
    MoE KEEP, whose trunk's attention is plain), every leaf two ranks of a
    pp or ep group hold bit-equal after the last step (digests), each rank
    holding only its stage's ViT blocks or its E / ep experts (the leaves'
    names and shapes) with its resident state bytes that share of the
    one-process run's (dp's) within 1e-3; per rank the peak memory and
    where its time went (spawn, imports, group, model, steps, gathers,
    checkpoint).
28. precision_policy — after 7, on phase 6's weights: ``serve.build_server
    (["--int8"])`` as it stands (the co-located line with the link's
    measured RTT median: int8 at every bucket), then again with
    ``utils.rtt``'s memo at a relay's 28 ms median, where the real
    ``rtt.pick_by_probe`` times B=1 int8 and bf16 image dispatches (both
    medians printed) and serves image bucket 1 from the winner: the
    winner's bucket-1 features bit-equal to its own ``encode_image`` of
    the tile, with the launches of its route; buckets 8 and 128 bit-equal
    to the int8 model's; after an int8 choice the build's device memory
    within 5% of the co-located build's (no bf16 copy; where the probe
    picks bf16, a third build with an infinite margin keeps int8 and
    takes this gate). Then ``InferenceServer(alt_model=bf16,
    alt_buckets={"image": (1,)})`` built directly: bucket 1 through #1
    alone (24 launches, no int8 operator), bucket 8 through #4 / #6 / #8 /
    #9 (24 / 24 / 1 / 2).

Then one JSON line of what ptxas made of every kernel function of the
library (``utils.compile.kernel_resources``: registers, spills, stack,
static shared memory), every ``.cu`` the kernels line names among its
sources, then one JSON line describing the kernels (each TPU kernel's counterpart:
its launches on the path that runs it, its time, its plain version's, its
bound — the larger of its operations over the card's peak for their type
and its bytes over 3.35 TB/s — and the one PyTorch call that computes the
same function, or null), and last the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import functools
import io
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

# #1 / #2: the bf16 bodies (wgmma fed by TMA: the one-pass body and the
# streamed one) and the entry point with the fp32 bodies (CUDA cores: the
# scores kept where they fit in shared memory, streamed past it)
SOURCE = "keep_tpu_torch/kernels/csrc/attention_qkv_slab_wgmma.cu"
ATTENTION_SOURCES = [
    SOURCE, "keep_tpu_torch/kernels/csrc/attention_qkv_slab_wgmma_streamed.cu",
    "keep_tpu_torch/kernels/csrc/attention_qkv_slab.cu"]
REPLACES = "keep_tpu/kernels/flash_attention.py:190"
# #1b: the bf16 kernels A and B (wgmma fed by TMA) and the fp32 kernels A
# and B (split TF32 on wgmma fed by TMA); their entry point,
# attention_qkv_slab_bwd.cu, holds no kernel
BWD_SOURCE = "keep_tpu_torch/kernels/csrc/attention_qkv_slab_bwd_dq.cu"
BWD_SOURCES = [
    BWD_SOURCE, "keep_tpu_torch/kernels/csrc/attention_qkv_slab_bwd_dkv.cu",
    "keep_tpu_torch/kernels/csrc/attention_qkv_slab_bwd_f32_dq.cu",
    "keep_tpu_torch/kernels/csrc/attention_qkv_slab_bwd_f32_dkv.cu"]
BWD_REPLACES = "keep_tpu/kernels/flash_attention.py:221"
HEADS_REPLACES = "keep_tpu/kernels/flash_attention.py:115"
LN_MATMUL_SOURCE = "keep_tpu_torch/kernels/csrc/ln_matmul.cu"
LN_MATMUL_REPLACES = "keep_tpu/kernels/ln_matmul.py:51"
LN_MATMUL_BODY = ("ln_stats_kernel (one read of x) + ln_matmul_wgmma_kernel: "
                  "persistent 128x256 tiles, wgmma m64n256k16 fed by TMA, "
                  "x normalised in the register-A fragments, TMA-store "
                  "epilogue")
CSRC = "keep_tpu_torch/kernels/csrc/"
# the card's published peaks (H100 SXM, dense) and memory rate, for the
# least time a kernel's work could take (bound_ms); fp32 is the CUDA
# cores' rate (the fp32 forward's route), tf32 the tensor cores' (the fp32
# backward's route: each product in split TF32, three TF32 products)
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
# the int8 counterparts of the TPU kernels: the module that composes them
# and the CUDA sources they run, the TPU kernel each replaces
INT8_KERNELS = {
    "quantized_attention_block": (
        "keep_tpu_torch/kernels/qblock.py",
        ["quant_rows.cu", "int8_gemm.cu", "attention_qkv_slab_wgmma.cu",
         "attention_qkv_slab_wgmma_streamed.cu"],
        "keep_tpu/kernels/qblock.py:79"),
    "quantized_attention_block_postln": (
        "keep_tpu_torch/kernels/qblock.py",
        ["quant_rows.cu", "int8_gemm.cu", "attention_qkv_slab_wgmma.cu",
         "attention_qkv_slab_wgmma_streamed.cu"],
        "keep_tpu/kernels/qblock.py:182"),
    "quantized_mlp_bsd": (
        "keep_tpu_torch/kernels/qmlp.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmlp.py:227"),
    "quantized_matmul_bsd": (
        "keep_tpu_torch/kernels/qmatmul.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmatmul.py:151"),
    "quantized_matmul": (
        "keep_tpu_torch/kernels/qmatmul.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmatmul.py:80"),
    "quantized_mlp": (
        "keep_tpu_torch/kernels/qmlp.py",
        ["quant_rows.cu", "int8_gemm.cu"], "keep_tpu/kernels/qmlp.py:97"),
}
# the attention phases' shapes (name, B, S, H, padded key bias): the
# serving shapes at B=32, whose slab fits the 50 MB L2, and at B=128, the
# serving and training buckets, whose slab (155 MB for ViT-L in bf16) does
# not
ATTENTION_SHAPES = [(name, b, s, h, padded) for b in (32, 128)
                    for name, s, h, padded in (("vit_l16", 197, 16, False),
                                               ("bert_base", 256, 12, True))]
# sequence lengths around the attention bodies' tiles and pieces, the two
# towers' lengths, the one-pass forward's limit (320), 512 and, past them,
# the streamed bodies' 64-key tiles, ViT-L-14-336's 577, KEEP at 448²'s 785
# and one past the longest row PyTorch's warp softmax serves
EDGE_S = [1, 15, 16, 17, 64, 197, 256, 257, 320, 321, 512, 513, 575, 576,
          577, 640, 641, 785, 1025]
# the first length at Dh 64 / 80 / 128 past the fp32 forward's kept-scores
# body (a block's 32 rows of scores in shared memory), where the three-pass
# body takes the row
F32_STREAMED_S = [(64, 1441), (80, 1377), (128, 1121)]
# the zoo's attention shapes (name, B, S, H, Dh): every head width of the
# OpenCLIP presets past 64 at their S = 257 (224², patch 14), and Dh = 64
# past 512: ViT-L-14-336 (577) and KEEP's ViT-L/16 at 448² (785)
ZOO_ATTENTION_SHAPES = [("vit_h14", 64, 257, 16, 80),
                        ("vit_g14", 64, 257, 16, 88),
                        ("vit_bigg14", 32, 257, 16, 104),
                        ("vit_e14", 32, 257, 16, 112),
                        ("vit_l14_336", 32, 577, 16, 64),
                        ("keep_448", 32, 785, 16, 64)]
ZOO_PRESET = "ViT-H-14"
# its vision depth, width and head width; text depth, width and context
ZOO_SHAPE = (32, 1280, 80, 24, 1024, 77)
ZOO_BATCH = 64
LONG_SEQ_BATCH = 32
# a merges file for the zoo's BPE: its words' pairs (the CLIP vocabulary is
# not in the repository)
ZOO_MERGES = ["a </w>", "o f</w>", "t h", "th e</w>", "p h", "ph o", "pho t",
              "phot o</w>", "i t", "it a", "ita p</w>", "b a", "ba d</w>",
              "l a", "la r", "lar g", "larg e</w>", "s m", "sm a", "sma l",
              "smal l</w>", "a r", "ar t</w>", "g a", "ga m", "gam e</w>",
              "v i", "vi d", "vid e", "vide o</w>", "o r", "or i", "ori g",
              "orig a", "origa m", "origam i</w>"]
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] an h & e image of breast invasive "
         "carcinoma normal tissue lung adeno ##carcinoma squamous cell "
         "melanoma skin kidney clear renal tumor . , -").split()
PROMPTS = ["an h&e image of breast invasive carcinoma.",
           "an h&e image of normal lung tissue.",
           "an h&e image of clear cell renal carcinoma."]


STARTED = time.perf_counter()


def phase(tag: str, /, **fields) -> None:
    """One phase's line; ``at_s``: the seconds since this script started."""
    print(json.dumps({"phase": tag, "at_s": time.perf_counter() - STARTED,
                      **fields}), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 25, calls: int = 1) -> float:
    """Median of ``runs`` times from CUDA events around ``calls`` calls
    back to back, over the calls (single calls by default)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def port_launches() -> int:
    """Every kernel launch the port's wrappers have counted so far
    (``_kops.LAUNCHES`` also counts each int8 block under the name of the
    block whose last kernel it is: those names are left out)."""
    from keep_tpu_torch.kernels import _kops, ln_matmul
    from keep_tpu_torch.kernels import flash_attention as fa

    return (sum(_kops.LAUNCHES[k] for k in ("quant_rows", "int8_gemm",
                                            "ln_rows"))
            + fa.LAUNCHES + fa.BWD_LAUNCHES + fa.HEADS_LAUNCHES
            + ln_matmul.LAUNCHES)


def device_ms(torch, fn, runs: int = 20, tries: int = 3,
              per_launch: int = 1) -> tuple[float, str]:
    """The device time of one call of ``fn`` (ms) and where it came from.
    ``"profiler"``: its kernels' time in a profiler session of ``runs``
    calls, over the calls, the host's gaps between launches left out. The
    profiler on the card's machine now and then records no kernel of a
    session, or only some: a session is kept only if it holds as many
    device records as the calls issued, a whole number a call and at least
    ``per_launch`` records for each launch the port's wrappers counted in
    it (#1b's launch is two kernels), else it is taken again.
    After ``tries`` sessions short of that, ``"events"``: CUDA events
    around the ``runs`` calls back to back, the host's gaps in where a call
    is shorter than its launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        n0 = port_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        issued = port_launches() - n0
        records = [ev for ev in prof.key_averages()
                   if getattr(ev, "device_type", None)
                   == torch.autograd.DeviceType.CUDA]
        count = sum(ev.count for ev in records)
        if count and count % runs == 0 and count >= issued * per_launch:
            return (sum(ev.self_device_time_total for ev in records) / 1e3
                    / runs, "profiler")
    return cuda_ms(fn, runs=1, calls=runs), "events"


def bound(ops: dict[str, float], nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take for work of ``ops``
    operations by type (``PEAK``'s keys) that must move ``nbytes`` (each
    input read once, each output written once): the larger of the two
    times, and which one sets it."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items()) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def attention_flops(b: int, s: int, h: int, backward: bool = False,
                    dh: int = 64) -> int:
    """The operations of one attention call: the forward's q·kᵀ and p·v
    (4·S²·Dh per head), the backward's score recompute and four products
    (10·S²·Dh)."""
    return b * h * (10 if backward else 4) * s * s * dh


def attention_bound(b: int, s: int, h: int, dtype_bytes: int,
                    key_bias: bool, backward: bool = False,
                    out_bytes: int | None = None,
                    dh: int = 64) -> tuple[float, str]:
    """The bound of one attention call: ``attention_flops`` at the peak of
    the route its input's type takes (bf16; an fp32 forward at the CUDA
    cores' fp32 rate; an fp32 backward in split TF32, three TF32 products
    for each product, at the tensor cores' TF32 rate); q, k, v (and dout)
    read, the output (dq, dk, dv) written, the forward's output in
    ``out_bytes`` a value (default: the input's)."""
    io = b * s * h * dh
    moved = (io * dtype_bytes * 3 + io * (out_bytes or dtype_bytes)
             if not backward else io * dtype_bytes * (3 + 1 + 3))
    flops = attention_flops(b, s, h, backward, dh)
    if dtype_bytes == 2:
        ops = {"bf16": flops}
    else:
        ops = {"tf32": 3 * flops} if backward else {"fp32": flops}
    return bound(ops, moved + key_bias * b * s * 4)


def sdpa_backend(torch, fn) -> str:
    """The name of the longest device kernel of one call of ``fn`` (which
    SDPA backend ran)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = kernel_ms(torch, prof)
    return max(by_kernel, key=by_kernel.get) if by_kernel else "not measured"


def check_kernel(fa, torch, gen) -> tuple[list[dict], list[dict]]:
    """Phase 3: the slab attention against its plain version in fp32 and
    bf16, then its bf16 → fp32 form (``check_f32_form``), at each of
    ``ATTENTION_SHAPES``, then the fp32-out form at the edge lengths.
    Returns (fp32 and bf16 rows, bf16 → fp32 rows)."""
    shapes = ATTENTION_SHAPES
    rows, f32_rows = [], []
    for name, b, s, h, padded in shapes:
        qkv32 = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen)
        kb, valid = None, torch.ones(b, s, dtype=torch.bool, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
            kb = (1.0 - valid.float()) * -1e9
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
            g, r = got.float()[valid], ref.float()[valid]
            err = (g - r).abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(g, r, atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} fp32 kernel vs plain: max |Δ| {err}")
            elif not err < 0.05:
                raise AssertionError(f"{name} bf16 kernel vs plain: "
                                     f"max |Δ| {err}")
            ms = cuda_ms(lambda: fa.attention_qkv_slab(qkv, kb, num_heads=h))
            plain_ms = cuda_ms(lambda: fa.attention_qkv_slab_reference(
                qkv, kb, num_heads=h))
            # the library's attention on the slab's [B, H, S, Dh] head views,
            # a yardstick the port never calls
            q, k, v = qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
            mask = None if kb is None else kb[:, None, None, :].to(dtype)
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": cuda_ms(sdpa),
                   "library_kernel": sdpa_backend(torch, sdpa)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, qkv.element_size(), kb is not None)
            phase("kernel", **row)
            rows.append(row)
        f32_rows.append(check_f32_form(fa, torch, name, qkv32.bfloat16(), kb,
                                       valid, h, rows[-1]["library_ms"]))
    check_f32_edges(fa, torch, gen)
    return rows, f32_rows


def code_moves(torch, got, ref) -> float:
    """The int8 codes an int8 block re-quantizes from an fp32 attention
    output [B, S, D] (``quant_rows`` over full D rows): the kernel's output
    through the kernel against the plain output through the plain version.
    Raises if a code moves by more than one; returns the share that
    moves."""
    from keep_tpu_torch.kernels import _kops

    d = got.shape[-1]
    q, _ = _kops.quant_rows(got.reshape(-1, d))
    rq, _ = _kops.PLAIN.quant_rows(ref.reshape(-1, d))
    diff = (q.int() - rq.int()).abs()
    if diff.max().item() > 1:
        raise AssertionError(f"int8 codes from the fp32-out attention off by "
                             f"{diff.max().item()}")
    return diff.count_nonzero().item() / diff.numel()


def check_f32_form(fa, torch, name, qkv, kb, valid, h, sdpa_ms) -> dict:
    """The bf16 → fp32 form of ``attention_qkv_slab`` (the int8 blocks'
    attention, its ``wgmma`` body) against its plain version on a bf16
    slab: finite, max |Δ| < 0.05 on unpadded query rows (the bf16 attention
    gate; the tensor cores sum in another order), the re-quantized codes
    within one of the plain version's (``code_moves``); its time (CUDA
    events; the profiler's device time beside), the plain version's, its
    bound (the bf16 slab read, the fp32 output written) and SDPA's bf16
    time on the same values (``sdpa_ms``, a reading)."""
    b, s, _ = qkv.shape
    kw = dict(num_heads=h, out_dtype=torch.float32)
    got = fa.attention_qkv_slab(qkv, kb, **kw)
    torch.cuda.synchronize()
    ref = fa.attention_qkv_slab_reference(qkv, kb, **kw)
    diff = (got - ref).abs()[valid]
    err = diff.max().item()
    if not (torch.isfinite(got).all() and err < 0.05):
        raise AssertionError(f"{name} B={b} bf16 -> fp32 kernel vs plain: "
                             f"max |Δ| {err}")
    row = {"shape": name, "B": b, "S": s, "H": h,
           "dtype": "bfloat16->float32", "max_abs_err": err,
           "mean_abs_err": diff.mean().item(),
           "int8_codes_moved_share": code_moves(torch, got, ref),
           "ms": cuda_ms(lambda: fa.attention_qkv_slab(qkv, kb, **kw)),
           "plain_ms": cuda_ms(lambda: fa.attention_qkv_slab_reference(
               qkv, kb, **kw)),
           "sdpa_bf16_ms_reading": sdpa_ms}
    row["device_ms"], row["device_ms_source"] = device_ms(
        torch, lambda: fa.attention_qkv_slab(qkv, kb, **kw))
    row["Dh"] = qkv.shape[-1] // (3 * h)
    row["bound_ms"], row["bound_by"] = attention_bound(
        b, s, h, 2, kb is not None, out_bytes=4, dh=row["Dh"])
    phase("kernel_f32", **row)
    return row


def check_f32_edges(fa, torch, gen) -> None:
    """The bf16 → fp32 form at every length of ``EDGE_S`` (B=2, H=2; the
    one-pass wgmma body up to 320, the streamed wgmma body past it), padded
    and unpadded: finite, max |Δ| < 0.05 on unpadded query rows."""
    errs = {}
    for s in EDGE_S:
        for padded in (False, True):
            qkv = torch.randn(2, s, 3 * 2 * 64, device="cuda",
                              generator=gen).bfloat16()
            kb, valid = None, torch.ones(2, s, dtype=torch.bool,
                                         device="cuda")
            if padded:
                lens = torch.randint(1, s + 1, (2,), device="cuda",
                                     generator=gen)
                valid = torch.arange(s, device="cuda")[None] < lens[:, None]
                kb = (1.0 - valid.float()) * -1e9
            kw = dict(num_heads=2, out_dtype=torch.float32)
            got = fa.attention_qkv_slab(qkv, kb, **kw)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_reference(qkv, kb, **kw)
            err = (got - ref).abs()[valid].max().item()
            if not (torch.isfinite(got).all() and err < 0.05):
                raise AssertionError(f"bf16 -> fp32 kernel at S={s}, padded "
                                     f"{padded}: max |Δ| {err}")
            errs[f"S={s}{' padded' if padded else ''}"] = err
    phase("kernel_f32_edges", max_abs_err=errs)


def check_heads(fa, torch, gen) -> tuple[list[dict], int]:
    """Phase 3b. ``flash_attention`` (split q, k, v [B, H, S, Dh], read
    through their strides by the kernel of ``attention_qkv_heads``) against
    its plain version at the serving shapes (ViT-L: S=197, H=16, no bias;
    BERT-base: S=256, H=12, a padded [B, 1, 1, S] mask; B=32 and 128), fp32
    at 2e-5 and bf16 at max |Δ| < 0.05 on unpadded query rows; bit for bit
    against ``attention_qkv_heads`` and ``attention_qkv_slab`` on the same
    q, k, v; the kernel's, the plain version's and SDPA's times. Then the
    main path: ``ops.nn.mha_attention(use_flash=True)`` at every shape in
    bf16, its launches counted from zero. Returns (rows, launches)."""
    from keep_tpu_torch.ops.nn import mha_attention

    F = torch.nn.functional
    shapes = ATTENTION_SHAPES
    rows, inputs = [], []
    for name, b, s, h, padded in shapes:
        q32, k32, v32 = (torch.randn(b, h, s, 64, device="cuda",
                                     generator=gen) for _ in range(3))
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        bias = None
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
            bias = ((1.0 - valid.float()) * -1e9)[:, None, None, :]
        kb = None if bias is None else bias.reshape(b, s)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            got = fa.flash_attention(q, k, v, bias)
            torch.cuda.synchronize()
            ref = fa.flash_attention_reference(q, k, v, bias)
            g = got.transpose(1, 2).float()[valid]
            r = ref.transpose(1, 2).float()[valid]
            err = (g - r).abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(g, r, atol=2e-5, rtol=2e-5):
                    raise AssertionError(
                        f"{name} fp32 heads kernel vs plain: max |Δ| {err}")
            elif not err < 0.05:
                raise AssertionError(f"{name} bf16 heads kernel vs plain: "
                                     f"max |Δ| {err}")
            lanes = [t.transpose(1, 2).reshape(b, s, h * 64) for t in
                     (q, k, v)]
            heads = fa.attention_qkv_heads(*lanes, kb, num_heads=h)
            slab = fa.attention_qkv_slab(torch.cat(lanes, -1).contiguous(), kb,
                                         num_heads=h)
            if not (torch.equal(heads, slab) and torch.equal(
                    got.transpose(1, 2).reshape(b, s, h * 64), heads)):
                raise AssertionError(f"{name} B={b} {dtype}: flash_attention, "
                                     f"the heads kernel and the slab kernel "
                                     f"differ on the same q, k, v")
            mask = None if bias is None else bias.to(dtype)
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "equals_slab_bitwise": True,
                   "flash_attention_equals_heads_bitwise": True,
                   "ms": cuda_ms(lambda: fa.attention_qkv_heads(
                       *lanes, kb, num_heads=h)),
                   "plain_ms": cuda_ms(lambda: fa.attention_qkv_heads_reference(
                       *lanes, kb, num_heads=h)),
                   "flash_attention_ms": cuda_ms(
                       lambda: fa.flash_attention(q, k, v, bias)),
                   "library_ms": cuda_ms(sdpa),
                   "library_kernel": sdpa_backend(torch, sdpa)}
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, q.element_size(), padded)
            phase("heads", **row)
            rows.append(row)
            if dtype == torch.bfloat16:
                inputs.append((name, q, k, v, bias, valid, ref))

    with fa._launch_lock:
        fa.HEADS_LAUNCHES = 0
    # ---- the main path: the generic attention op with the kernel -----------
    with torch.inference_mode():
        outs = [mha_attention(q, k, v, bias=bias, use_flash=True)
                for _, q, k, v, bias, _, _ in inputs]
    torch.cuda.synchronize()
    launches = fa.HEADS_LAUNCHES
    # -------------------------------------------------------------------------
    if launches != len(inputs):
        raise AssertionError(f"mha_attention(use_flash=True): {launches} "
                             f"kernel launches for {len(inputs)} calls")
    for out, (name, _, _, _, _, valid, ref) in zip(outs, inputs):
        g = out.transpose(1, 2).float()[valid]
        if not torch.isfinite(g).all() or \
                not (g - ref.transpose(1, 2).float()[valid]).abs().max() < 0.05:
            raise AssertionError(f"{name}: mha_attention(use_flash=True) "
                                 f"differs from the plain version")
    phase("heads_path", entry="ops.nn.mha_attention(use_flash=True)",
          calls=[n for n, *_ in inputs], launches=launches)
    return rows, launches


# ROADMAP queue 3's check: BERT-base width at 2 layers in bf16, the fused
# attention against the plain route, on weights and ids drawn with numpy
# from a seed, so that tests/test_torch_hf_text.py takes the JAX package's
# distance on the same values
BERT_CHECK = dict(layers=2, batch=8, seq=128, seed=0)


def bert_check_inputs(cfg, batch: int = BERT_CHECK["batch"],
                      seq: int = BERT_CHECK["seq"],
                      seed: int = BERT_CHECK["seed"]):
    """(a JAX-layout parameter tree of numpy arrays for the BERT ``cfg``,
    with the JAX package's ``bert.init`` statistics, ids [batch, seq],
    mask): weights and embeddings normal(.02), zero biases, unit
    LayerNorms; each row's length drawn in [seq / 4, seq]."""
    rng = np.random.default_rng(seed)
    d, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    def lin(fi, fo):
        return {"kernel": w(n, fi, fo), "bias": np.zeros((n, fo), np.float32)}

    def ln(*shape):
        return {"scale": np.ones(shape, np.float32),
                "bias": np.zeros(shape, np.float32)}

    tree = {"embeddings": {"word": w(cfg.vocab_size, d),
                           "position": w(cfg.max_position_embeddings, d),
                           "token_type": w(cfg.type_vocab_size, d),
                           "norm": ln(d)},
            "blocks": {"attn": {"qkv": lin(d, 3 * d), "out": lin(d, d),
                                "norm": ln(n, d)},
                       "mlp": {"fc1": lin(d, f), "fc2": lin(f, d)},
                       "norm": ln(n, d)},
            "pooler": {"kernel": w(d, d), "bias": np.zeros(d, np.float32)}}
    lens = rng.integers(seq // 4, seq + 1, batch)
    ids = rng.integers(1000, cfg.vocab_size, (batch, seq))
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int64)
    return tree, ids * mask, mask


def zoo_inputs(torch, gen, b: int, s: int, h: int, dh: int, padded: bool):
    """A random fp32 slab [B, S, 3·H·Dh], its key bias (or None) and the
    valid rows: the padded form masks a random tail of every row but the
    first."""
    qkv = torch.randn(b, s, 3 * h * dh, device="cuda", generator=gen)
    valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
    kb = None
    if padded:
        lens = torch.randint(1, s + 1, (b,), device="cuda", generator=gen)
        lens[0] = s
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
    return qkv, kb, valid


def check_zoo_call(fa, torch, qkv, kb, valid, h: int, dh: int) -> float:
    """One slab at one dtype through #1 and #2 (split q, k, v and [B, H, S,
    Dh] heads), each launch counted: the three the same bits, fp32 bit for
    bit against the plain version where PyTorch's warp softmax serves the
    row (S ≤ 1024; within 2e-5 past it), bf16 at max |Δ| < 0.05 on valid
    rows. Returns the max |Δ|."""
    b, s, _ = qkv.shape
    n0, h0 = fa.LAUNCHES, fa.HEADS_LAUNCHES
    got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
    q, k, v = (t.contiguous() for t in qkv.split(h * dh, dim=-1))
    heads = fa.attention_qkv_heads(q, k, v, kb, num_heads=h)
    bhsd = [t.view(b, s, h, dh).transpose(1, 2) for t in (q, k, v)]
    flash = fa.flash_attention(*bhsd, None if kb is None
                               else kb[:, None, None, :])
    torch.cuda.synchronize()
    if (fa.LAUNCHES - n0, fa.HEADS_LAUNCHES - h0) != (1, 2):
        raise AssertionError(f"Dh={dh} S={s}: launches {fa.LAUNCHES - n0}, "
                             f"{fa.HEADS_LAUNCHES - h0}, not 1 and 2")
    if not (torch.equal(heads, got) and torch.equal(
            flash.transpose(1, 2).reshape(b, s, h * dh), got)):
        raise AssertionError(f"Dh={dh} S={s} {qkv.dtype}: the slab, split "
                             f"heads and [B, H, S, Dh] layouts differ")
    ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
    g, r = got.float()[valid], ref.float()[valid]
    err = (g - r).abs().max().item()
    ok = (torch.equal(g, r) if qkv.dtype == torch.float32 and s <= 1024
          else torch.allclose(g, r, atol=2e-5, rtol=2e-5)
          if qkv.dtype == torch.float32 else err < 0.05)
    if not (ok and torch.isfinite(got).all()):
        raise AssertionError(f"Dh={dh} S={s} {qkv.dtype} padded "
                             f"{kb is not None}: kernel vs plain, max |Δ| "
                             f"{err}")
    return err


def check_attention_shapes(fa, torch, gen) -> tuple[list[dict], list[dict]]:
    """Phase 3e. #1 and #2 at ``ZOO_ATTENTION_SHAPES``, padded and
    unpadded, fp32 and bf16 (``check_zoo_call``); each shape's bf16 times
    (the slab, split heads and ``flash_attention`` kernels, the plain
    version, SDPA on the slab's head views) beside its bound; then every
    ``EDGE_S`` length at Dh = 64 and 80, and fp32 at ``F32_STREAMED_S``.
    Returns (slab rows, heads rows)."""
    F = torch.nn.functional
    rows, heads_rows = [], []
    for name, b, s, h, dh in ZOO_ATTENTION_SHAPES:
        errs = {}
        for padded in (False, True):
            qkv32, kb, valid = zoo_inputs(torch, gen, b, s, h, dh, padded)
            for dtype in (torch.float32, torch.bfloat16):
                errs[f"{str(dtype)[6:]}{' padded' if padded else ''}"] = \
                    check_zoo_call(fa, torch, qkv32.to(dtype), kb, valid, h,
                                   dh)
        qkv = qkv32.bfloat16()
        q, k, v = qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
        lanes = [t.contiguous() for t in qkv.split(h * dh, dim=-1)]
        bhsd = [t.view(b, s, h, dh).transpose(1, 2) for t in lanes]
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        bound_ms, bound_by = attention_bound(b, s, h, 2, False, dh=dh)
        row = {"shape": name, "B": b, "S": s, "H": h, "Dh": dh,
               "dtype": "bfloat16", "max_abs_err": errs,
               "fp32_bits_equal_plain": True,
               "ms": cuda_ms(lambda: fa.attention_qkv_slab(qkv, num_heads=h)),
               "plain_ms": cuda_ms(lambda: fa.attention_qkv_slab_reference(
                   qkv, num_heads=h)),
               "library_ms": cuda_ms(sdpa), "bound_ms": bound_ms,
               "bound_by": bound_by}
        heads_row = dict(row, ms=cuda_ms(lambda: fa.attention_qkv_heads(
            *lanes, num_heads=h)), flash_attention_ms=cuda_ms(
            lambda: fa.flash_attention(*bhsd)), plain_ms=cuda_ms(
            lambda: fa.attention_qkv_heads_reference(*lanes, num_heads=h)))
        phase("attention_shape", **row, heads_ms=heads_row["ms"],
              flash_attention_ms=heads_row["flash_attention_ms"])
        rows.append(row)
        heads_rows.append(heads_row)
    edges = {}
    for dh in (64, 80):
        for s in EDGE_S:
            for padded in (False, True):
                qkv32, kb, valid = zoo_inputs(torch, gen, 2, s, 2, dh, padded)
                for dtype in (torch.float32, torch.bfloat16):
                    edges[f"Dh={dh} S={s}{' padded' if padded else ''} "
                          f"{str(dtype)[6:]}"] = check_zoo_call(
                        fa, torch, qkv32.to(dtype), kb, valid, 2, dh)
    for dh, s in F32_STREAMED_S:
        for padded in (False, True):
            qkv32, kb, valid = zoo_inputs(torch, gen, 2, s, 2, dh, padded)
            edges[f"Dh={dh} S={s}{' padded' if padded else ''} float32"] = \
                check_zoo_call(fa, torch, qkv32, kb, valid, 2, dh)
    phase("attention_shapes", shapes=[r["shape"] for r in rows],
          edges_max_abs_err=max(edges.values()), edges=len(edges))
    return rows, heads_rows


def write_zoo_merges(d: str) -> str:
    path = os.path.join(d, "merges.txt")
    with open(path, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(ZOO_MERGES) + "\n")
    return path


def cos_min(torch, a, b) -> float:
    """The least cosine between matching rows of a and b."""
    a, b = a.float(), b.float()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()


def counted_encode(torch, fa, encode) -> tuple:
    """(features, attention launches) of one ``encode()`` call, the count
    set to 0 just before it and read just after."""
    with fa._launch_lock:
        fa.LAUNCHES = 0
    out = encode()
    torch.cuda.synchronize()
    return out, fa.LAUNCHES


def drive_zoo_serve(torch, fa, d: str, device: str = "cuda",
                    batch: int = ZOO_BATCH) -> dict:
    """Phase 3f: ViT-H-14 from the factory in bf16, images and zero-shot
    ImageNet text through it (see the module docstring)."""
    from keep_tpu_torch import factory, presets
    from keep_tpu_torch.ops.preprocess import preprocess
    from keep_tpu_torch.text.bpe import BPETokenizer
    from keep_tpu_torch.zeroshot import openclip
    from keep_tpu_torch.zeroshot.imagenet_metadata import (
        IMAGENET_CLASSNAMES, SIMPLE_IMAGENET_TEMPLATES)

    model, build_ms = synced_ms(torch, lambda: factory.create_model(
        ZOO_PRESET, seed=0, dtype=torch.bfloat16, device=device))
    v, t = model.config.vision_cfg, model.config.text_cfg
    if (v.depth, v.embed_dim, v.head_dim, t.layers, t.width,
            t.context_length) != ZOO_SHAPE:
        raise AssertionError(f"{ZOO_PRESET} resolved to {v}, {t}")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, 256, 256, 3), dtype=np.uint8)).to(device)
    pcfg = presets.preprocess_config(ZOO_PRESET)
    encode = lambda x: model.encode_image(x, use_flash=True)  # noqa: E731
    out = {"preset": ZOO_PRESET, "batch": batch, "build_ms": build_ms,
           "params": sum(p.numel() for p in model.parameters())}
    with torch.inference_mode():
        pixels = preprocess(images, pcfg)
        encode(pixels)  # warm-up
        feats, launches = counted_encode(torch, fa, lambda: model.encode_image(
            pixels, normalize=True, use_flash=True))
        plain = model.encode_image(pixels, normalize=True, use_flash=False)
        out["attention_launches"] = launches
        out["cos_vs_plain_min"] = cos_min(torch, feats, plain)
        norms = feats.norm(dim=-1)
        if launches != v.depth:
            raise AssertionError(f"{ZOO_PRESET}: {launches} attention "
                                 f"launches for one batch of {v.depth} blocks")
        if not (torch.isfinite(feats).all()
                and (norms - 1).abs().max().item() < 1e-3
                and out["cos_vs_plain_min"] >= 0.999):
            raise AssertionError(f"{ZOO_PRESET} features: {out}")
        n = 5
        _, ms = synced_ms(torch, lambda: [encode(preprocess(images, pcfg))
                                          for _ in range(n)])
        out["tiles_per_s"] = n * batch / (ms / 1e3)
        tok = BPETokenizer(write_zoo_merges(d), context_length=77)

        def tokenizer(texts, max_length):
            ids = tok(texts, context_length=max_length)
            return {"input_ids": ids, "attention_mask": (ids != 0).astype(
                np.int32)}

        def encode_text(ids, mask):
            return model.encode_text(torch.from_numpy(ids).to(device))

        encode_text(tokenizer(["a photo of a goldfish."], 77)["input_ids"],
                    None)  # warm-up
        classifier, cls_ms = synced_ms(
            torch, lambda: openclip.build_zero_shot_classifier(
                encode_text, tokenizer, IMAGENET_CLASSNAMES,
                SIMPLE_IMAGENET_TEMPLATES, num_classes_per_batch=50))
        cols = classifier.norm(dim=0)
        if classifier.shape != (t.output_dim, 1000) or not (
                torch.isfinite(classifier).all()
                and (cols - 1).abs().max().item() < 1e-4):
            raise AssertionError(f"zero-shot classifier {classifier.shape}")
        labels = rng.integers(0, 1000, batch)
        acc = openclip.zero_shot_eval_imagenet(encode, classifier,
                                               [(pixels, labels)])
    prompts = len(IMAGENET_CLASSNAMES) * len(SIMPLE_IMAGENET_TEMPLATES)
    out.update(prompts=prompts, classifier_build_ms=cls_ms,
               prompts_per_s=prompts / (cls_ms / 1e3),
               accuracy_random_weights=acc)
    phase("zoo_serve", **out)
    return out


def drive_long_seq(torch, fa, device: str = "cuda",
                   batch: int = LONG_SEQ_BATCH, keep_cfg=None) -> dict:
    """Phase 3g: ViT-L-14-336 and the KEEP ViT-L/16 at 384² and 448², fused
    attention against the plain route (see the module docstring)."""
    from keep_tpu_torch import factory
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.models.keep import KEEPModel

    gen = torch.Generator(device=device).manual_seed(1)
    out = {}

    def held(name, size, patch, encode_flash, encode_plain, blocks):
        x = torch.randn(batch, size, size, 3, device=device, generator=gen)
        with torch.inference_mode():
            encode_flash(x)  # warm-up
            feats, launches = counted_encode(torch, fa,
                                             lambda: encode_flash(x))
            _, ms = synced_ms(torch, lambda: encode_flash(x))
            cos = cos_min(torch, feats, encode_plain(x))
        row = {"image": size, "S": (size // patch) ** 2 + 1,
               "attention_launches": launches, "cos_vs_plain_min": cos,
               "forward_ms": ms}
        if launches != blocks or not cos >= 0.999 or \
                not torch.isfinite(feats).all():
            raise AssertionError(f"{name}: {row}")
        out[name] = row

    m = factory.create_model("ViT-L-14-336", seed=0, dtype=torch.bfloat16,
                             device=device)
    held("ViT-L-14-336", m.config.vision_cfg.img_size, 14,
         lambda x: m.encode_image(x, normalize=True, use_flash=True),
         lambda x: m.encode_image(x, normalize=True, use_flash=False),
         m.config.vision_cfg.depth)
    del m
    cfg = keep_cfg or KEEPConfig()
    keep = KEEPModel(cfg, dtype=torch.bfloat16, use_flash=True, device=device)
    keep.load_state_dict(load_keep_state_dict(random_keep_state_dict(
        cfg, gen, device=device), cfg))
    keep.eval()

    def plain(x):
        keep.use_flash = False
        try:
            return keep.encode_image(x)
        finally:
            keep.use_flash = True

    native, patch = cfg.vision.img_size, cfg.vision.patch_size
    for size in (native * 12 // 7, native * 2):  # 384² and 448² from 224²
        size = size // patch * patch
        held(f"KEEP ViT-L/16 {size}", size, patch, keep.encode_image, plain,
             cfg.vision.depth)
    del keep
    phase("long_seq", **out)
    return out


def check_ln_matmul(lm, torch, gen) -> list[dict]:
    """Phase 3d. ``ln_matmul`` against its plain version at the ViT-L
    projections after a LayerNorm (K = 1024, N = 3072 for qkv, 4096 for
    fc1) at B=32 and B=128 (M = 197·B): fp32 at 2e-5; bf16 within one bf16
    rounding (rtol 2⁻⁷, atol 1e-2 for outputs near zero). Times of the
    kernel and its plain version in both types; in bf16 also
    ``scripts/torch_ln_matmul_bench.py``'s ``measure``: the kernel's
    device ms split into the statistics pass (``stats_ms``) and the GEMM,
    the unfused cuBLAS route (``F.layer_norm`` then ``F.linear``, two calls:
    ``unfused_ms``), the product alone in cuBLAS on the normalised rows
    (``gemm_library_ms``), the bound and the kernel's share of it."""
    from scripts.torch_ln_matmul_bench import measure

    k = 1024
    rows = []
    for batch in (32, 128):
        m = 197 * batch
        x32 = torch.randn(m, k, device="cuda", generator=gen) * 2 + 0.5
        g = 1 + 0.1 * torch.randn(k, device="cuda", generator=gen)
        b = 0.05 * torch.randn(k, device="cuda", generator=gen)
        for n in (3072, 4096):
            w32 = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
            bias = 0.02 * torch.randn(n, device="cuda", generator=gen)
            row = {"shape": f"vit_l16 [{m},{k}]x[{k}->{n}]", "B": batch}
            for dtype in (torch.float32, torch.bfloat16):
                x, w = x32.to(dtype), w32.to(dtype)
                got = lm.ln_matmul(x, g, b, w, bias, 1e-6, dtype)
                torch.cuda.synchronize()
                ref = lm.ln_matmul_reference(x, g, b, w, bias, 1e-6, dtype)
                err = (got.float() - ref.float()).abs().max().item()
                tol = (dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32
                       else dict(atol=1e-2, rtol=2 ** -7))
                if not torch.allclose(got.float(), ref.float(), **tol):
                    raise AssertionError(f"ln_matmul {row['shape']} {dtype} "
                                         f"vs plain: max |Δ| {err}")
                tag = "fp32" if dtype == torch.float32 else "bf16"
                row[f"max_abs_err_{tag}"] = err
                if dtype == torch.float32:
                    row["ms_fp32"] = cuda_ms(
                        lambda: lm.ln_matmul(x, g, b, w, bias, 1e-6, dtype))
                row[f"plain_ms_{tag}"] = cuda_ms(lambda: lm.ln_matmul_reference(
                    x, g, b, w, bias, 1e-6, dtype))
                del got, ref
            t = measure(lm, x, g, b, w, bias)
            row.update({key: v for key, v in t.items()
                        if key not in ("B", "M", "K", "N")})
            phase("ln_matmul", **row)
            rows.append(row)
            del x, w, w32
        del x32
        torch.cuda.empty_cache()
    return rows


def drive_fuse_ln(torch, fa, lm, cfg) -> dict:
    """Phase 3e. The ViT under ``fuse_ln`` at full width: ViT-L/16 at 224²,
    bf16, tanh GELU, B = 128, random weights whose blocks all move the
    residual stream (LayerScale 0.1–0.5; ``keep.init``'s 1e-5 would scale
    every ``ln_matmul`` result down to where the features cannot see it).
    ``model.visual(..., use_flash=True, fuse_ln=True)`` and the visual head
    against the same call with ``fuse_ln=False``: finite features, cosine ≥
    0.999 per row, and exactly 2 ``ln_matmul`` and 1 slab-attention launch
    per block of the forward. Then every ``ln_matmul`` call of a second
    fused forward is held against its plain version on the same inputs at
    ``check_ln_matmul``'s bf16 tolerance, and two faults planted in the
    kernel's result must each fail one of the two gates. Device ms of both
    forwards (CUDA events) and ``ln_matmul``'s share of the fused one
    (torch.profiler)."""
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.models import vit
    from keep_tpu_torch.models.keep import KEEPModel

    gen = torch.Generator(device="cuda").manual_seed(0)
    model = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16,
                      gelu_approx=True)
    model.load_state_dict(load_keep_state_dict(
        random_keep_state_dict(cfg, gen, device="cuda"), cfg), strict=True)
    model.eval()
    size = cfg.vision.img_size
    px = torch.randn(128, size, size, 3, device="cuda", generator=gen)
    kw = dict(dtype=torch.bfloat16, use_flash=True, gelu_approx=True)

    def encode(fuse_ln: bool) -> torch.Tensor:
        return model.visual_head(model.visual(px, fuse_ln=fuse_ln, **kw))

    with torch.inference_mode():
        with fa._launch_lock:
            fa.LAUNCHES = 0
        with lm._launch_lock:
            lm.LAUNCHES = 0
        # ---- the main path: the ViT forward under fuse_ln ----------------
        fused = encode(True)
        torch.cuda.synchronize()
        ln_launches, attn_launches = lm.LAUNCHES, fa.LAUNCHES
        # -----------------------------------------------------------------
        base = encode(False)
        depth = cfg.vision.depth
        if (ln_launches, attn_launches) != (2 * depth, depth):
            raise AssertionError(f"fuse_ln forward: {ln_launches} ln_matmul "
                                 f"and {attn_launches} attention launches, "
                                 f"want {2 * depth} and {depth}")
        f, r = fused.float(), base.float()
        if not torch.isfinite(f).all():
            raise AssertionError("fuse_ln forward: non-finite features")
        cos = torch.nn.functional.cosine_similarity(f, r, dim=-1)
        if not (cos >= 0.999).all():
            raise AssertionError(f"fuse_ln vs unfused: min cos "
                                 f"{cos.min().item()}")

        def held_forward(fault=None) -> tuple[float, float, int]:
            """A fused forward with every ``ln_matmul`` call held against
            its plain version on the same inputs (rtol 2⁻⁷, atol 1e-2);
            ``fault`` alters each kernel result first. Returns the
            features' min cosine against ``fuse_ln=False``, the largest
            per-call |Δ| and the first call out of tolerance (0: none)."""
            errs, first_bad = [], []

            def held(x, g, b, w, bias, eps=1e-6, out_dtype=torch.bfloat16):
                got = lm.ln_matmul(x, g, b, w, bias, eps, out_dtype)
                if fault is not None:
                    fault(got)
                ref = lm.ln_matmul_reference(x, g, b, w, bias, eps, out_dtype)
                errs.append((got.float() - ref.float()).abs().max().item())
                if not first_bad and not torch.allclose(
                        got.float(), ref.float(), atol=1e-2, rtol=2 ** -7):
                    first_bad.append(len(errs))
                return got

            vit.ln_matmul = held
            try:
                feats = encode(True).float()
            finally:
                vit.ln_matmul = lm.ln_matmul
            if len(errs) != 2 * depth:
                raise AssertionError(f"fuse_ln forward: {len(errs)} "
                                     f"ln_matmul calls held, want {2 * depth}")
            c = torch.nn.functional.cosine_similarity(feats, r, dim=-1)
            return c.min().item(), max(errs), (first_bad or [0])[0]

        _, call_err, bad_call = held_forward()
        if bad_call:
            raise AssertionError(f"fuse_ln forward: ln_matmul call {bad_call} "
                                 f"vs plain: max |Δ| {call_err}")
        # the gates' self-check: faults planted in the kernel's result must
        # fail one of them (a zero result fails both; one token off by one
        # in 8 columns only the per-call check)
        faults = {"zeros": lambda o: o.zero_(),
                  "one_token_8_columns_plus_1": lambda o: o[1, :8].add_(1)}
        planted = {}
        for name, fault in faults.items():
            fcos, ferr, fbad = held_forward(fault)
            caught = [gname for gname, hit in (("cosine", fcos < 0.999),
                                               ("per_call", fbad)) if hit]
            if not caught:
                raise AssertionError(f"fuse_ln gates: the planted fault "
                                     f"{name} passed both (min cos {fcos}, "
                                     f"per-call max |Δ| {ferr})")
            planted[name] = {"min_cos": fcos, "per_call_max_abs_err": ferr,
                             "first_call_out_of_tolerance": fbad,
                             "caught_by": caught}
        fused_ms = cuda_ms(lambda: model.visual(px, fuse_ln=True, **kw),
                           warmup=2, runs=10)
        unfused_ms = cuda_ms(lambda: model.visual(px, **kw), warmup=2,
                             runs=10)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.visual(px, fuse_ln=True, **kw)
            torch.cuda.synchronize()
    by_kernel = kernel_ms(torch, prof)
    total = sum(by_kernel.values())
    ln_ms = sum(v for kk, v in by_kernel.items()
                if "ln_matmul" in kk or "ln_stats" in kk)
    out = {"config": "ViT-L/16 224² bf16 B=128, random weights, LayerScale "
                     "0.1-0.5",
           "ln_matmul_launches": ln_launches,
           "attention_launches": attn_launches,
           "min_cos_vs_unfused": cos.min().item(),
           "max_abs_diff_vs_unfused": (f - r).abs().max().item(),
           "ln_matmul_calls_vs_plain_max_abs_err": call_err,
           "planted_faults": planted,
           "fused_forward_ms": fused_ms, "unfused_forward_ms": unfused_ms,
           "fused_profiled_device_ms": total if total else "not measured",
           "ln_matmul_share_of_fused": ln_ms / total if total
           else "not measured"}
    phase("fuse_ln_path", **out)
    del model
    torch.cuda.empty_cache()
    return out


def check_int8_kernels(torch, gen) -> tuple[dict, list]:
    """Phase 3b. Each int8 counterpart of a TPU kernel through the kernels
    against its plain version (fp32 stream, the JAX tests' tolerance; the
    attention sub-blocks, whose attention the tensor cores sum in another
    order, at the JAX package's tolerance between two routes through the
    same int8 weights, tests/test_quant.py:297-300, 324-327: atol = rtol =
    2e-2, cosine ≥ 0.9999 per row), the share of int8 codes that differ
    from the plain quantizer's on the tensors each one quantizes (for the
    attention sub-blocks also ``code_moves`` of their attention on the same
    slab), and kernel and plain times in bf16. Then the three CUDA kernels
    alone. Returns ({name: row}, primitive rows)."""
    from keep_tpu_torch.kernels import _kops, qblock, qmatmul, qmlp
    from keep_tpu_torch.ops.nn import LayerNorm, Mlp, QLinear
    from keep_tpu_torch.quant import quantize_kernel

    P = _kops.PLAIN
    dev = "cuda"

    def randn(*shape, std=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * std

    def qlin(k, n):
        q, s = quantize_kernel(randn(n, k, std=k ** -0.5))
        return QLinear.from_quantized(q, s, randn(n, std=0.02))

    def norm(d, eps):
        m = LayerNorm(d, eps, device=dev).requires_grad_(False)
        m.weight.copy_(1 + randn(d, std=0.1))
        m.bias.copy_(randn(d, std=0.05))
        return m

    def code_share(x2, *args, **kw):
        """Share of quant_rows' codes that differ from the plain
        version's on x2; a code may move by at most one."""
        q, _ = _kops.quant_rows(x2, *args, **kw)
        rq, _ = P.quant_rows(x2, *args, **kw)
        diff = (q.int() - rq.int()).abs()
        if diff.max().item() > 1:
            raise AssertionError(f"int8 codes off by {diff.max().item()}")
        return diff.count_nonzero().item(), diff.numel()

    # ---- the serving shapes ---------------------------------------------
    vb, vs, vd, vh, vf = 32, 197, 1024, 16, 4096  # ViT-L/16
    tb, ts, td, th, tf = 32, 256, 768, 12, 3072   # BERT-base
    vx = randn(vb, vs, vd)
    vn1, vn2 = norm(vd, 1e-6), norm(vd, 1e-6)
    vqkv, vproj, vfc1, vfc2 = (qlin(vd, 3 * vd), qlin(vd, vd), qlin(vd, vf),
                               qlin(vf, vd))
    tx = randn(tb, ts, td)
    lens = torch.randint(8, ts + 1, (tb,), device=dev, generator=gen)
    kb = (1.0 - (torch.arange(ts, device=dev)[None] < lens[:, None]).float()
          ) * -1e9
    tn1, tn2 = norm(td, 1e-12), norm(td, 1e-12)
    tqkv, tout, tfc1, tfc2 = (qlin(td, 3 * td), qlin(td, td), qlin(td, tf),
                              qlin(tf, td))
    tqkv.pre_scale = torch.exp(randn(td, std=0.5))
    tfc1.pre_scale = torch.exp(randn(td, std=0.5))
    px = randn(vb, 196, 768)  # normalised 16×16×3 patches
    pe = qlin(768, vd)
    feats = randn(vb, vd)  # the pooled, normed CLS features
    hd1 = qlin(vd, 768)

    def mlp_args(x, f1, f2):
        return (x, f1.weight_q, f1.weight_scale, f1.bias, f2.weight_q,
                f2.weight_scale, f2.bias)

    def hidden(x2, f1, **kw):
        """The plain fc1 + GELU output, the tensor the MLP re-quantizes."""
        xq, a = P.quant_rows(x2, **kw)
        return P.int8_gemm(xq, a, f1.weight_q, f1.weight_scale, f1.bias,
                           order=_kops.DEQUANT_PAIRED, gelu=True)

    def slab_of(x2, b, s, d, qkv, **kw):
        """The plain bf16 qkv slab the block's attention reads."""
        xq, a = P.quant_rows(x2, **kw)
        return P.int8_gemm(xq, a, qkv.weight_q, qkv.weight_scale, qkv.bias,
                           order=_kops.DEQUANT_PAIRED,
                           out_dtype=torch.bfloat16).view(b, s, 3 * d)

    def attn_out(x2, b, s, d, h, qkv, key_bias, **kw):
        """The plain fp32 attention output, the tensor the block
        re-quantizes."""
        return P.attention(slab_of(x2, b, s, d, qkv, **kw), key_bias,
                           num_heads=h, out_dtype=torch.float32
                           ).view(b * s, d)

    def attn_moves(x2, b, s, d, h, qkv, key_bias, **kw):
        """``code_moves`` of the block's attention on its plain slab: the
        kernel's fp32 output against the plain version's."""
        slab = slab_of(x2, b, s, d, qkv, **kw)
        akw = dict(num_heads=h, out_dtype=torch.float32)
        got = _kops.KERNELS.attention(slab, key_bias, **akw)
        return code_moves(torch, got, P.attention(slab, key_bias, **akw))

    vx2, tx2 = vx.view(-1, vd), tx.view(-1, td)
    cases = [
        ("quantized_attention_block", "vit_l16 B=32 S=197 D=1024 H=16",
         qblock.quantized_attention_block,
         qblock.quantized_attention_block_reference,
         lambda x: (x, vn1, vqkv, vproj), dict(num_heads=vh, eps=1e-6),
         vx, 2e-2, 2e-2,
         lambda: [code_share(vx2, vn1.weight, vn1.bias, 1e-6),
                  code_share(attn_out(vx2, vb, vs, vd, vh, vqkv, None,
                                      ln_scale=vn1.weight,
                                      ln_bias=vn1.bias, eps=1e-6))]),
        ("quantized_mlp_bsd", "vit_l16 B=32 S=197 D=1024 F=4096, LN + "
         "residual", qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
         lambda x: mlp_args(x, vfc1, vfc2),
         dict(ln_scale=vn2.weight, ln_bias=vn2.bias, eps=1e-6,
              residual=True),
         vx, 2e-4, 1e-4,
         lambda: [code_share(vx2, vn2.weight, vn2.bias, 1e-6),
                  code_share(hidden(vx2, vfc1, ln_scale=vn2.weight,
                                    ln_bias=vn2.bias, eps=1e-6))]),
        ("quantized_attention_block_postln", "bert_base B=32 S=256 D=768 "
         "H=12, padded key bias, pre_scale",
         qblock.quantized_attention_block_postln,
         qblock.quantized_attention_block_postln_reference,
         lambda x: (x, kb, tn1, tqkv, tout), dict(num_heads=th, eps=1e-12),
         tx, 2e-2, 2e-2,
         lambda: [code_share(tx2, pre_scale=tqkv.pre_scale),
                  code_share(attn_out(tx2, tb, ts, td, th, tqkv, kb,
                                      pre_scale=tqkv.pre_scale))]),
        ("quantized_mlp_bsd", "bert_base B=32 S=256 D=768 F=3072, post-LN + "
         "pre_scale", qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
         lambda x: mlp_args(x, tfc1, tfc2),
         dict(ln_scale=tn2.weight, ln_bias=tn2.bias, eps=1e-12, post_ln=True,
              pre_scale1=tfc1.pre_scale),
         tx, 2e-3, 2e-3,
         lambda: [code_share(tx2, pre_scale=tfc1.pre_scale),
                  code_share(hidden(tx2, tfc1, pre_scale=tfc1.pre_scale))]),
        ("quantized_matmul_bsd", "patch embed [32,196,768]x[768->1024]",
         qmatmul.quantized_matmul_bsd, qmatmul.quantized_matmul_bsd_reference,
         lambda x: (x, pe.weight_q, pe.weight_scale, pe.bias), {},
         px, 1e-4, 1e-4, lambda: [code_share(px.view(-1, 768))]),
        ("quantized_matmul", "visual head [32,1024]->768",
         qmatmul.quantized_matmul, qmatmul.quantized_matmul_reference,
         lambda x: (x, hd1.weight_q, hd1.weight_scale, hd1.bias), {},
         feats, 1e-4, 1e-4, lambda: [code_share(feats)]),
        ("quantized_mlp", "vit_l16 flat M=32*197 D=1024 F=4096",
         qmlp.quantized_mlp, qmlp.quantized_mlp_reference,
         lambda x: mlp_args(x, vfc1, vfc2), {}, vx2, 2e-4, 1e-4,
         lambda: [code_share(vx2), code_share(hidden(vx2, vfc1))]),
        ("quantized_mlp", "bert_base flat M=32*256 D=768 F=3072, pre_scale",
         qmlp.quantized_mlp, qmlp.quantized_mlp_reference,
         lambda x: mlp_args(x, tfc1, tfc2), dict(pre_scale1=tfc1.pre_scale),
         tx2, 2e-4, 1e-4,
         lambda: [code_share(tx2, pre_scale=tfc1.pre_scale),
                  code_share(hidden(tx2, tfc1, pre_scale=tfc1.pre_scale))]),
    ]
    # operations by type of each case (the int8 GEMMs; the attention's
    # score and p·v products in bf16), for its bound
    attn_ops = {"quantized_attention_block": 4 * vb * vh * vs * vs * 64,
                "quantized_attention_block_postln": 4 * tb * th * ts * ts * 64}
    attn_codes = {
        "quantized_attention_block": lambda: attn_moves(
            vx2, vb, vs, vd, vh, vqkv, None, ln_scale=vn1.weight,
            ln_bias=vn1.bias, eps=1e-6),
        "quantized_attention_block_postln": lambda: attn_moves(
            tx2, tb, ts, td, th, tqkv, kb, pre_scale=tqkv.pre_scale)}
    rows: dict[str, dict] = {}
    for name, shape, fn, ref, args, kw, x, atol, rtol, codes in cases:
        out_kw = {} if name.startswith("quantized_a") else {
            "out_dtype": x.dtype}
        got = fn(*args(x), **kw, **out_kw)
        torch.cuda.synchronize()
        want = ref(*args(x), **kw, **out_kw)
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=atol, rtol=rtol):
            raise AssertionError(f"{name} ({shape}) vs plain: max |Δ| {err} "
                                 f"beyond atol {atol} / rtol {rtol}")
        extra = {}
        if name in attn_codes:
            cos = torch.nn.functional.cosine_similarity(
                got.view(-1, got.shape[-1]), want.view(-1, got.shape[-1]),
                dim=-1).min().item()
            if not cos >= 0.9999:
                raise AssertionError(f"{name} ({shape}) vs plain: min row "
                                     f"cosine {cos}")
            extra = {"min_row_cos": cos,
                     "attention_int8_codes_moved_share": attn_codes[name]()}
        changed, total = map(sum, zip(*codes()))
        x16 = x.bfloat16()
        out16 = {} if not out_kw else {"out_dtype": torch.bfloat16}
        ms = cuda_ms(lambda: fn(*args(x16), **kw, **out16))
        dev_ms, dev_source = device_ms(
            torch, lambda: fn(*args(x16), **kw, **out16))
        plain_ms = cuda_ms(lambda: ref(*args(x16), **kw, **out16))
        weights = [a for a in args(x16)[1:]
                   if isinstance(a, torch.Tensor) and a.dtype == torch.int8]
        weights += [m.weight_q for m in args(x16)[1:]
                    if isinstance(m, QLinear)]
        int8_ops = sum(2 * x16.numel() // x16.shape[-1] * w.numel()
                       for w in weights)
        moved = nbytes(x16, fn(*args(x16), **kw, **out16), *weights)
        row = {"name": name, "shape": shape, "max_abs_err": err,
               "atol": atol, "rtol": rtol,
               "int8_codes_differing": changed, "int8_codes": total,
               "int8_code_diff_share": changed / total,
               "ms_bf16": ms, "device_ms_bf16": dev_ms,
               "device_ms_source": dev_source,
               "plain_ms_bf16": plain_ms, **extra}
        row["bound_ms_bf16"], row["bound_by"] = bound(
            {"int8": int8_ops, "bf16": attn_ops.get(name, 0)}, moved)
        phase("int8_kernel", **row)
        rows.setdefault(name, {"shapes": []})["shapes"].append(row)

    # ---- the flat pair: bit for bit against the bsd form, then its path ----
    for x, f1, f2, ps in ((vx2, vfc1, vfc2, None),
                          (tx2, tfc1, tfc2, tfc1.pre_scale)):
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            flat = qmlp.quantized_mlp(*mlp_args(xd, f1, f2), out_dtype=dtype,
                                      pre_scale1=ps)
            bsd = qmlp.quantized_mlp_bsd(*mlp_args(xd.view(32, -1, x.shape[1]),
                                                   f1, f2), out_dtype=dtype,
                                         pre_scale1=ps)
            if not torch.equal(flat, bsd.view_as(flat)):
                raise AssertionError(f"flat int8 MLP differs from the bsd "
                                     f"form on {tuple(x.shape)} {dtype}")
    mlp = Mlp(vd, vf, device=dev)
    mlp.fc1, mlp.fc2 = vfc1, vfc2
    x16 = vx2.bfloat16()
    with _kops._launch_lock:
        _kops.LAUNCHES.clear()
    # ---- the main path: the int8 Mlp on a flat input --------------------------
    with torch.inference_mode():
        out = mlp(x16, gelu_approx=True)
    torch.cuda.synchronize()
    flat_launches = dict(_kops.LAUNCHES)
    # ---------------------------------------------------------------------------
    want = {"quantized_mlp": 1, "quant_rows": 2, "int8_gemm": 2}
    if flat_launches != want:
        raise AssertionError(f"Mlp.forward on [M, D]: launches "
                             f"{flat_launches}, want {want}")
    if out.shape != x16.shape or not torch.isfinite(out.float()).all():
        raise AssertionError(f"Mlp.forward on [M, D]: {tuple(out.shape)}")
    phase("int8_flat_mlp_path", entry="ops.nn.Mlp.forward(x [M, D], "
          "gelu_approx=True) with int8 fc1, fc2", shape=list(x16.shape),
          launches=flat_launches, equals_bsd_bitwise=True)
    rows["quantized_mlp"]["launches"] = flat_launches["quantized_mlp"]

    return rows, check_int8_primitives(torch, gen, (vqkv, vproj, vfc1, vfc2),
                                       vn1, tn1)


def check_int8_primitives(torch, gen, vit_linears, vit_norm, bert_norm
                          ) -> list[dict]:
    """Phase 3b, second part: the three CUDA kernels alone at the shapes #4
    and #6 give them in a ViT-L dispatch at B=32 and B=128 (M = B·197):
    ``int8_gemm`` at the qkv, proj, fc1 and fc2 shapes with their
    epilogues, beside cuBLAS's int8 GEMM (``torch._int_mm``) on the same
    operands; ``quant_rows`` on the LN'd bf16 stream, the fp32 attention
    output and the fp32 MLP hidden; ``ln_rows`` on BERT's post-LN rows.
    Each must give its plain version's bits. Times: the profiler's kernel
    time a call (``device_ms``, host gaps left out) and CUDA events around
    one call (``ms``, the wrapper's host time included where it is the
    longer), each beside its bound."""
    from keep_tpu_torch.kernels import _kops

    P = _kops.PLAIN
    dev = "cuda"
    qkv, proj, fc1, fc2 = vit_linears
    gemms = (("qkv", qkv, dict(out_dtype=torch.bfloat16), False),
             ("proj", proj, dict(out_dtype=torch.bfloat16), True),
             ("fc1", fc1, dict(gelu=True, out_dtype=torch.float32), False),
             ("fc2", fc2, dict(out_dtype=torch.bfloat16), True))
    prims = []

    def report(kind, name, got, want, fn, ref, ops, moved, **extra):
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        if not same:
            raise AssertionError(f"{kind} {name}: not the plain version's "
                                 f"bits")
        row = {"kernel": kind, "shape": name, "bitwise_equal": same,
               "ms": cuda_ms(fn), "plain_ms": cuda_ms(ref), "bytes": moved,
               **extra}
        row["device_ms"], row["device_ms_source"] = device_ms(torch, fn)
        row["bound_ms"], row["bound_by"] = bound(ops, moved)
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        if ops:
            row["tops"] = ops["int8"] / row["device_ms"] / 1e9
        phase("int8_primitive", **row)
        prims.append(row)

    for b in (32, 128):
        m = b * 197
        for gname, lin, kw, with_res in gemms:
            n, k = lin.weight_q.shape
            xq = torch.randint(-127, 128, (m, k), device=dev, generator=gen,
                               dtype=torch.int8)
            a = torch.rand(m, device=dev, generator=gen) * 1e-2
            res = (torch.randn(m, n, device=dev, generator=gen).bfloat16()
                   if with_res else None)
            args = (xq, a, lin.weight_q, lin.weight_scale, lin.bias)
            fn = lambda: _kops.int8_gemm(*args, order=1, residual=res, **kw)
            ref = lambda: P.int8_gemm(*args, order=1, residual=res, **kw)
            out = fn()
            torch.cuda.synchronize()
            lib, lib_source = device_ms(
                torch, lambda: torch._int_mm(xq, lin.weight_q.t()))
            ops = 2 * m * k * n
            report("int8_gemm", f"{gname} [{m},{k}]x[{k}->{n}] {kw}, "
                   f"residual {with_res}", [out], [ref()], fn, ref,
                   {"int8": ops}, nbytes(xq, a, lin.weight_q, out, res)
                   + 8 * n, int_mm_device_ms=lib,
                   int_mm_device_ms_source=lib_source,
                   int_mm_tops=ops / lib / 1e9)
        xs = (torch.randn(m, 1024, device=dev, generator=gen) * 3)
        for rname, x, ln in (("LN'd bf16 stream", xs.bfloat16(), True),
                             ("fp32 attention output", xs, False),
                             ("fp32 MLP hidden",
                              torch.randn(m, 4096, device=dev, generator=gen),
                              False)):
            lnw = (vit_norm.weight, vit_norm.bias) if ln else (None, None)
            fn = lambda: _kops.quant_rows(x, *lnw)
            ref = lambda: P.quant_rows(x, *lnw)
            q, s = fn()
            report("quant_rows", f"{rname} [{m},{x.shape[1]}]", [q, s],
                   list(ref()), fn, ref, {}, nbytes(x, q, s))
        t2 = torch.randn(b * 256, 768, device=dev, generator=gen) * 4 + 1
        fn = lambda: _kops.ln_rows(t2, bert_norm.weight, bert_norm.bias,
                                   1e-12, torch.bfloat16)
        ref = lambda: P.ln_rows(t2, bert_norm.weight, bert_norm.bias, 1e-12,
                                torch.bfloat16)
        out = fn()
        report("ln_rows", f"BERT post-LN [{b * 256},768] fp32 -> bf16",
               [out], [ref()], fn, ref, {}, nbytes(t2, out))
    return prims


def check_bwd_kernel(fa, torch, gen) -> list[dict]:
    """Phase 8: the backward kernel against its plain version at the
    training shapes, B=32 and B=128, its time and SDPA's backward's in CUDA
    events around single calls and in profiler device ms
    (``device_ms``, each beside its source); then the bf16 form at every
    ``EDGE_S`` length (``check_bwd_edges``)."""
    shapes = ATTENTION_SHAPES
    rows = []
    for name, b, s, h, padded in shapes:
        qkv32 = torch.randn(b, s, 3 * h * 64, device="cuda", generator=gen)
        do32 = torch.randn(b, s, h * 64, device="cuda", generator=gen)
        valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
        for dtype in (torch.float32, torch.bfloat16):
            qkv, do = qkv32.to(dtype), do32.to(dtype)
            got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
            torch.cuda.synchronize()
            ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
            g, r = got.float()[valid], ref.float()[valid]
            err = (g - r).abs().max().item()
            limit = 1e-2 * r.abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(got, ref, atol=2e-4, rtol=1e-4):
                    raise AssertionError(f"{name} fp32 backward vs plain: "
                                         f"max |Δ| {err}")
            elif not err <= limit:
                raise AssertionError(f"{name} bf16 backward vs plain: max "
                                     f"|Δ| {err} > {limit}")
            ms = cuda_ms(lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h))
            plain_ms = cuda_ms(lambda: fa.attention_qkv_slab_bwd_reference(
                qkv, kb, do, h))
            # the library's attention backward on the same values: SDPA's
            # gradient through autograd, the graph kept (retain_graph) so
            # that only the backward is timed
            q, k, v = (t.detach().requires_grad_() for t in
                       qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4))
            mask = kb[:, None, None, :].to(dtype) if padded else None
            out = torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask)
            do4 = do.view(b, s, h, 64).transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, (q, k, v), do4, retain_graph=True)
            row = {"shape": name, "B": b, "S": s, "H": h,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "max_abs_plain": r.abs().max().item(),
                   "ms": ms, "plain_ms": plain_ms,
                   "library_ms": cuda_ms(sdpa_bwd),
                   "library_kernel": sdpa_backend(torch, sdpa_bwd)}
            row["dev_ms"], row["dev_ms_source"] = device_ms(
                torch, lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h),
                per_launch=2)
            row["library_dev_ms"], row["library_dev_ms_source"] = device_ms(
                torch, sdpa_bwd)
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, qkv.element_size(), True, backward=True)
            del out
            phase("attention_bwd", **row)
            rows.append(row)
    check_bwd_edges(fa, torch, gen)
    return rows


def check_bwd_edges(fa, torch, gen) -> dict:
    """Phase 8, the edges: the backward at every ``EDGE_S`` length at Dh 64
    and 80 (B=2, H=2), unpadded and with a ragged key mask, bf16 and fp32,
    against its plain version at phase 8's gates (bf16: max |Δ| ≤ 1e-2 ·
    max |plain| on unmasked rows; fp32: atol 2e-4, rtol 1e-4), finite, each
    call one launch."""
    worst = {"ratio": 0.0}
    worst_f32 = {"max_abs_err": 0.0}
    b, h = 2, 2
    for dh in (64, 80):
        for s in EDGE_S:
            for padded in (False, True):
                qkv32 = torch.randn(b, s, 3 * h * dh, device="cuda",
                                    generator=gen)
                do32 = torch.randn(b, s, h * dh, device="cuda",
                                   generator=gen)
                valid = torch.ones(b, s, dtype=torch.bool, device="cuda")
                if padded:
                    lens = torch.randint(1, s + 1, (b,), device="cuda",
                                         generator=gen)
                    valid = (torch.arange(s, device="cuda")[None]
                             < lens[:, None])
                kb = (1.0 - valid.float()) * -1e9
                for dtype in (torch.bfloat16, torch.float32):
                    qkv, do = qkv32.to(dtype), do32.to(dtype)
                    n0 = fa.BWD_LAUNCHES
                    got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
                    torch.cuda.synchronize()
                    if fa.BWD_LAUNCHES != n0 + 1:
                        raise AssertionError(f"Dh {dh}, S {s}: the backward "
                                             f"did not launch once")
                    ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
                    if dtype == torch.float32:
                        err = (got - ref).abs().max().item()
                        if not (torch.isfinite(got).all() and torch.allclose(
                                got, ref, atol=2e-4, rtol=1e-4)):
                            raise AssertionError(
                                f"fp32 backward at Dh {dh}, S {s}, padded "
                                f"{padded} vs plain: max |Δ| {err}")
                        if err > worst_f32["max_abs_err"]:
                            worst_f32 = {"max_abs_err": err, "Dh": dh,
                                         "S": s, "padded": padded}
                        continue
                    g, r = got.float()[valid], ref.float()[valid]
                    err = (g - r).abs().max().item()
                    limit = 1e-2 * r.abs().max().item()
                    if not (torch.isfinite(got).all() and err <= limit):
                        raise AssertionError(
                            f"bf16 backward at Dh {dh}, S {s}, padded "
                            f"{padded} vs plain: max |Δ| {err} > {limit}")
                    if limit and err / limit > worst["ratio"]:
                        worst = {"ratio": err / limit, "Dh": dh, "S": s,
                                 "padded": padded, "max_abs_err": err,
                                 "limit": limit}
    out = {"lengths": EDGE_S, "head_dims": [64, 80], "B": b, "H": h,
           "calls": 2 * 2 * 2 * len(EDGE_S), "worst": worst,
           "worst_fp32": worst_f32}
    phase("attention_bwd_edges", **out)
    return out


TRAIN_NODES = {
    "DOID:14566": {"name": "disease of cellular proliferation", "parent": []},
    "DOID:162": {"name": "cancer", "parent": ["DOID:14566"]},
    "DOID:1324": {"name": "lung cancer", "parent": ["DOID:162"]},
    "DOID:3910": {"name": "lung adenocarcinoma", "parent": ["DOID:1324"]},
    "DOID:3908": {"name": "lung squamous cell carcinoma",
                  "parent": ["DOID:1324"]},
    "DOID:1909": {"name": "melanoma", "parent": ["DOID:162"]},
    "DOID:4450": {"name": "renal cell carcinoma", "parent": ["DOID:162"]},
}
TRAIN_CAPTIONS = ["an h&e image of lung adeno ##carcinoma.",
                  "squamous cell carcinoma of the lung.",
                  "melanoma of the skin.", "clear cell renal tumor.",
                  "normal lung tissue.", "breast invasive carcinoma."]


def write_train_data(d: str, n_groups: int, image_size: int,
                     n_images: int = 32) -> tuple[str, str, str, str]:
    """PNG tiles larger than the model size (so the random crop moves), a
    semantic-groups JSON, a DO-graph JSON and a vocab, from a numpy seed.
    Returns (groups, images dir, graph, vocab) paths."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir = os.path.join(d, "images")
    os.makedirs(img_dir)
    names = []
    for i in range(n_images):
        names.append(f"tile{i}.png")
        Image.fromarray(rng.integers(0, 256, (image_size + 32,
                                              image_size + 32, 3),
                                     dtype=np.uint8)).save(
            os.path.join(img_dir, names[-1]))
    labels = list(TRAIN_NODES)[2:] + [None]
    groups = {}
    for g in range(n_groups):
        lab = labels[g % len(labels)]
        groups[f"group{g}"] = {
            "captions": [TRAIN_CAPTIONS[(g + k) % len(TRAIN_CAPTIONS)]
                         for k in range(2)],
            "images": [names[(3 * g + k) % n_images] for k in range(3)],
            "labels": {lab: 1} if lab else {}}
    paths = tuple(os.path.join(d, n) for n in ("groups.json", "kg.json",
                                                "vocab.txt"))
    with open(paths[0], "w") as f:
        json.dump(groups, f)
    with open(paths[1], "w") as f:
        json.dump(TRAIN_NODES, f)
    words = sorted({w for n in TRAIN_NODES.values() for w in
                    n["name"].split()} | {w for c in TRAIN_CAPTIONS for w in
                                          c.replace(".", " .").split()})
    with open(paths[2], "w") as f:
        f.write("\n".join(VOCAB + [w for w in words if w not in VOCAB])
                + "\n")
    return paths[0], img_dir, paths[1], paths[2]


def train_config(d: str, keep: dict | None = None, batch_size: int = 128,
                 caption_num: int = 32, steps_per_epoch: int = 4) -> dict:
    """configs/keep_train.yml's values (no pretrained towers), 2 epochs,
    data written by ``write_train_data``."""
    keep = keep or {"projection_dim": 768}
    image_size = keep.get("vision", {}).get("img_size", 224)
    n_groups = steps_per_epoch * batch_size // (batch_size // caption_num)
    groups, img_dir, kg, vocab = write_train_data(d, n_groups, image_size)
    return {
        "seed": 0,
        "dataset": {"type": "json", "train_data": groups, "img_dir": img_dir,
                    "knowledge_file": kg, "label_cap": "both",
                    "vocab_path": vocab},
        "dataloader": {"batch_size": batch_size, "caption_num": caption_num,
                       "text_drop": True},
        "solver": {"epochs": 2, "lr": 1.0e-5, "weight_decay": 0.2,
                   "warmup": 200, "lr_scheduler": "cosine",
                   "grad_clip_norm": 1.0, "freeze_visual_epochs": 1,
                   "freeze_text_epochs": 1},
        "model": {"precision": "amp_bf16", "type": "hierarchy_metric",
                  "loss_subtype": "lhp-hn", "logit_scale": 0.04,
                  "use_flash": True},
        "save": {"output_dir": os.path.join(d, "logs"),
                 "experiment_name": "smoke", "save_frequency": 1},
        "keep": keep,
    }


@contextlib.contextmanager
def uncounted(fa):
    """Kernel launches inside the block (checks beside the main path) left
    out of the launch counts."""
    from keep_tpu_torch.kernels import _kops

    with fa._launch_lock:
        saved = fa.LAUNCHES, fa.BWD_LAUNCHES
    with _kops._launch_lock:
        saved_int8 = dict(_kops.LAUNCHES)
    try:
        yield
    finally:
        with fa._launch_lock:
            fa.LAUNCHES, fa.BWD_LAUNCHES = saved
        with _kops._launch_lock:
            _kops.LAUNCHES.clear()
            _kops.LAUNCHES.update(saved_int8)


@contextlib.contextmanager
def counted_steps(torch, fa, tmain, steps: list, traced: dict, trace_at: int,
                  device: str, before=None, after=None):
    """``tmain.make_train_step`` wrapped for the span of the block: each
    step timed between device synchronisations and its attention launches
    counted (forward, backward) into ``steps``; on the card step
    ``trace_at`` is traced with torch.profiler (its device ms by kernel
    into ``traced``). ``before`` / ``after(i, state, batch, model, kw)``
    run around step i, outside its timing and the launch counts."""
    make_step = tmain.make_train_step

    def timed_make_train_step(model, *args, static_frozen=None, **kw):
        inner = make_step(model, *args, static_frozen=static_frozen, **kw)

        def step(state, batch, frozen=None):
            i = len(steps)
            if before is not None:
                with uncounted(fa):
                    before(i, state, batch, model, kw)
            if device == "cuda":
                torch.cuda.synchronize()
            f0, b0 = fa.LAUNCHES, fa.BWD_LAUNCHES
            t0 = time.perf_counter()
            if device == "cuda" and i == trace_at:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    state, metrics = inner(state, batch, frozen)
                    loss = float(metrics["loss"])
                traced.update(kernel_ms(torch, prof))
            else:
                state, metrics = inner(state, batch, frozen)
                loss = float(metrics["loss"])  # waits for the step
            steps.append({"frozen": static_frozen is not None,
                          "ms": (time.perf_counter() - t0) * 1e3,
                          "loss": loss, "fwd_launches": fa.LAUNCHES - f0,
                          "bwd_launches": fa.BWD_LAUNCHES - b0})
            if after is not None:
                with uncounted(fa):
                    after(i, state, batch, model, kw)
            return state, metrics

        return step

    tmain.make_train_step = timed_make_train_step
    try:
        yield
    finally:
        tmain.make_train_step = make_step


def check_steps(steps: list, blocks: int, steps_per_epoch: int) -> None:
    """Epoch 0 frozen, epoch 1 open; every loss finite; a frozen step
    launches the forward kernel once per block and no backward, an open
    one the forward twice per block (remat) and the backward once."""
    want_phases = [True] * steps_per_epoch + [False] * steps_per_epoch
    if [s["frozen"] for s in steps] != want_phases:
        raise AssertionError(f"steps: {[s['frozen'] for s in steps]}")
    for i, s in enumerate(steps):
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"step {i}: loss {s['loss']}")
        want = (blocks, 0) if s["frozen"] else (2 * blocks, blocks)
        if (s["fwd_launches"], s["bwd_launches"]) != want:
            raise AssertionError(
                f"step {i}: forward / backward launches "
                f"{s['fwd_launches']} / {s['bwd_launches']}, want {want}")


def step_numbers(torch, steps: list, traced: dict, batch: int) -> dict:
    """ms per open and frozen step (each phase's first step, which carries
    its one-off setup, and the traced step left out), samples/s, and the
    traced step's device ms by kernel family."""
    open_ms = [s["ms"] for s in steps if not s["frozen"]][1:]
    if traced:
        open_ms = open_ms[:-1]
    frozen_ms = [s["ms"] for s in steps if s["frozen"]][1:]
    from scripts.torch_dispatch_profile import family

    families: dict[str, float] = {}
    for k, v in traced.items():
        fam = next((f for f, keys in (
            ("slab_attention_bwd", ("slab_attention_bwd",)),
            ("slab_attention", ("slab_attention", "attention_f32")))
                    if any(key in k for key in keys)), family(k))
        families[fam] = families.get(fam, 0.0) + v
    busy = sum(traced.values())
    return {"ms_per_unfrozen_step": statistics.median(open_ms),
            "ms_per_frozen_step": statistics.median(frozen_ms),
            "step_ms": [s["ms"] for s in steps],
            "samples_per_s_unfrozen":
                batch / statistics.median(open_ms) * 1e3,
            "traced_unfrozen_step": {
                "step_ms": steps[-1]["ms"] if traced else "not measured",
                "device_busy_ms": busy if traced else "not measured",
                "ms_by_family": families,
                "top_kernels_ms": sorted(traced.items(),
                                         key=lambda kv: -kv[1])[:12]}}


def drive_train(torch, fa, d: str, raw: dict, blocks: int,
                steps_per_epoch: int, device: str = "cuda") -> dict:
    """Phase 9: the training entry point on ``raw`` (``train_config`` with
    ``steps_per_epoch``). Each train step is timed between device
    synchronisations and its kernel launches counted; on the card the last
    step is traced with torch.profiler (and left out of the timing).
    ``blocks`` is the towers' block count."""
    import ast

    from keep_tpu_torch.train import checkpoint as ckpt
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train.config import TrainRunConfig

    path = os.path.join(d, "train.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    steps: list[dict] = []
    traced: dict[str, float] = {}
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with counted_steps(torch, fa, tmain, steps, traced,
                       2 * steps_per_epoch - 1, device):
        with fa._launch_lock:
            fa.LAUNCHES = fa.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        # ---- the main path: the training CLI --------------------------------
        result = tmain.main(["--config", path, "--device", device])
        fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
        # --------------------------------------------------------------------
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    out_dir = os.path.join(raw["save"]["output_dir"], "smoke")
    per_epoch = steps_per_epoch
    check_steps(steps, blocks, steps_per_epoch)
    if bwd != per_epoch * blocks or fwd != per_epoch * 3 * blocks:
        raise AssertionError(f"launches {fwd} / {bwd}")
    with open(os.path.join(out_dir, "checkpoints", "results.jsonl")) as f:
        losses = [json.loads(ln)["train_loss"] for ln in f]
    if len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"epoch losses {losses}")
    with open(os.path.join(out_dir, "out.log")) as f:
        log = f.read()
    checks = {}
    for epoch in (0, 1):
        line = log.split(f"epoch {epoch} freeze check: ")[1].splitlines()[0]
        checks[epoch] = ast.literal_eval(line)
    if (checks[0]["visual"], checks[0]["text"]) != ("frozen", "frozen"):
        raise AssertionError(f"freeze checks {checks}")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    restored = ckpt.restore(ckpt_dir)
    if ckpt.list_epochs(ckpt_dir) != [0, 1] or \
            restored["step"] != len(steps) or restored["epoch"] != 1 or \
            result["epoch"] != 1:
        raise AssertionError(f"checkpoints {ckpt.list_epochs(ckpt_dir)}, "
                             f"step {restored['step']}")
    # The norm check above cannot see updates of lr ~1e-7 (warmup), so the
    # leaves are also compared bit for bit: the seed's initial weights
    # against epoch 0's checkpoint (towers equal, visual head moved), and
    # epoch 0's against epoch 1's (most tower leaves moved).
    init = tmain.build_model(TrainRunConfig.from_dict(
        json.loads(json.dumps(raw))), device).state_dict()
    epoch0 = ckpt.restore(ckpt_dir, epoch=0)["params"]
    moved: dict[str, list[int]] = {}
    for n, t in init.items():
        top = n.split(".", 1)[0]
        counts = moved.setdefault(top, [0, 0, 0])
        counts[0] += not torch.equal(t.cpu(), epoch0[n])
        counts[1] += not torch.equal(epoch0[n], restored["params"][n])
        counts[2] += 1
    moved_share = {k: {"epoch0": c[0] / c[2], "epoch1": c[1] / c[2]}
                   for k, c in moved.items()}
    # (a LayerNorm gain behind a LayerScale of 1e-5 gets gradients far below
    # Adam's eps, and may not move by one ulp in three steps of warmup)
    for tower in ("visual", "text"):
        if moved[tower][0] or moved[tower][1] < moved[tower][2] / 2:
            raise AssertionError(f"{tower}: leaves moved {moved_share}")
    if not moved["visual_head"][0]:
        raise AssertionError(f"the visual head did not train in epoch 0: "
                             f"{moved_share}")
    out = {"card": card() if device == "cuda" else "cpu",
           "epoch_losses": losses, "step_losses": [s["loss"] for s in steps],
           "freeze_checks": checks, "leaves_moved_share": moved_share,
           "fwd_launches": fwd,
           "bwd_launches": bwd, "checkpoint_step": restored["step"],
           **step_numbers(torch, steps, traced,
                          raw["dataloader"]["batch_size"]),
           "peak_memory_gb": peak / 1e9, "wall_s": wall_s}
    phase("train", **out)
    return out


# ---- 13.–14. LoRA fine-tuning with the in-training eval, then serve --lora --

# the zero-shot classes of the LoRA phase's eval set, and the prompt
# templates its 50 rounds cycle through
LORA_CLASSES = {"luad": "lung adenocarcinoma",
                "lusc": "lung squamous cell carcinoma",
                "mel": "melanoma", "rcc": "renal cell carcinoma"}
LORA_TEMPLATES = ["an h&e image of CLASSNAME.", "CLASSNAME.",
                  "an image of CLASSNAME tissue.", "this is CLASSNAME."]


def write_eval_sets(d: str, img_dir: str, n: int = 256,
                    size: int = 240) -> dict:
    """The eval sets from a numpy seed: ``n`` PNG tiles in the 4 classes
    (cls.csv) with a 50-round prompt JSON, ``n`` retrieval pairs (ret.csv)
    and ``n`` validation pairs (val.csv, its tiles in the training image
    dir ``img_dir``). Returns the dataset section's entries."""
    from PIL import Image

    rng = np.random.default_rng(1)
    ev_dir = os.path.join(d, "eval_images")
    os.makedirs(ev_dir)

    def tiles(folder: str, prefix: str) -> list[str]:
        names = [f"{prefix}{i}.png" for i in range(n)]
        for name in names:
            Image.fromarray(rng.integers(0, 256, (size, size, 3),
                                         dtype=np.uint8)).save(
                os.path.join(folder, name))
        return names

    def csv(name: str, header: str, rows) -> str:
        path = os.path.join(d, name)
        with open(path, "w") as f:
            f.write(header + "\n" + "\n".join(f"{a},{b}" for a, b in rows))
        return path

    classes = list(LORA_CLASSES)
    cls_rows = [(t, classes[i % 4])
                for i, t in enumerate(tiles(ev_dir, "cls"))]
    caption = lambda i: TRAIN_CAPTIONS[i % len(TRAIN_CAPTIONS)]  # noqa
    ret_rows = [(t, caption(i)) for i, t in enumerate(tiles(ev_dir, "ret"))]
    val_rows = [(t, caption(i + 1))
                for i, t in enumerate(tiles(img_dir, "val"))]
    prompts = {str(r): {"classnames": LORA_CLASSES,
                        "templates": LORA_TEMPLATES[r % len(LORA_TEMPLATES)]}
               for r in range(50)}
    prompts_path = os.path.join(d, "prompts.json")
    with open(prompts_path, "w") as f:
        json.dump(prompts, f)
    return {"zeroshot_cls": csv("cls.csv", "image_name,label", cls_rows),
            "zeroshot_cls_imdir": ev_dir,
            "zeroshot_cls_prompts": prompts_path,
            "zeroshot_ret": csv("ret.csv", "image_name,caption", ret_rows),
            "zeroshot_ret_imdir": ev_dir,
            "val_data": csv("val.csv", "image_name,caption", val_rows)}


def lora_train_config(d: str, keep: dict | None = None, n_eval: int = 256,
                      **kw) -> dict:
    """``train_config`` (phase 9's values and data) with LoRA r 8, α 16 on
    the default targets, the eval every epoch on ``write_eval_sets``,
    checkpoints every epoch written asynchronously, and a remote sync to a
    local directory."""
    raw = train_config(d, keep=keep, **kw)
    size = raw["keep"].get("vision", {}).get("img_size", 224)
    raw["dataset"].update(write_eval_sets(d, raw["dataset"]["img_dir"],
                                          n=n_eval, size=size + 16))
    raw["solver"].update(lora_rank=8, lora_alpha=16.0, zeroshot_frequency=1)
    raw["save"].update(experiment_name="lora", async_checkpointing=True,
                       remote_sync=os.path.join(d, "remote"))
    return raw


def drive_lora_train(torch, fa, d: str, raw: dict, blocks: int,
                     steps_per_epoch: int, device: str = "cuda") -> dict:
    """Phase 13: the training entry point on ``raw``
    (``lora_train_config``), its steps timed and counted as in phase 9,
    the eval timed and its encodes counted, the async saves' blocking time
    measured. Returns the phase's result; ``result["ckpt_dir"]`` holds the
    adapters phase 14 serves."""
    from keep_tpu_torch.train import checkpoint as ckpt
    from keep_tpu_torch.train import lora
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train.config import TrainRunConfig

    cfg = TrainRunConfig.from_dict(json.loads(json.dumps(raw)))
    path = os.path.join(d, "lora.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    steps: list[dict] = []
    traced: dict[str, float] = {}
    snap: dict = {}
    gates: dict = {}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def before(i, state, batch, model, kw):
        if i == 0:  # on the host: a copy on the card would count in the peak
            snap["base"] = {n: t.cpu() for n, t in kw["base"].items()}
            snap["adapters"] = {n: t.detach().clone()
                                for n, t in state.params.items()}
            # b = 0: the merged model is the base, bit for bit
            px = batch["pixels"][:8]
            ids, mask = batch["input_ids"][:8], batch["attention_mask"][:8]
            merged = lora.apply_lora(kw["base"], state.params,
                                     kw["lora_scale"])
            with torch.inference_mode():
                feats = [(model.encode_image(px),
                          model.encode_text(ids, mask))]
                with lora.swapped(model, merged):
                    feats.append((model.encode_image(px),
                                  model.encode_text(ids, mask)))
            gates["step0_merged_equals_base"] = all(
                torch.equal(a, b) for a, b in zip(*feats))
        if i == steps_per_epoch:  # epoch 0's end, epoch 1 not started
            snap["epoch0_end"] = {n: t.detach().clone()
                                  for n, t in state.params.items()}

    def after(i, state, batch, model, kw):
        bad = [n for n, t in kw["base"].items()
               if not torch.equal(t.cpu(), snap["base"][n])]
        if bad:
            raise AssertionError(f"step {i}: base parameters moved: "
                                 f"{bad[:5]}")

    evals: list[dict] = []
    real_evaluate, real_encoders = tmain.evaluate, tmain.eval_encoders

    def timed_evaluate(*args, **kw):
        rec = {"image_calls": 0, "text_calls": 0}
        evals.append(rec)
        sync()
        f0, t0 = fa.LAUNCHES, time.perf_counter()
        out = real_evaluate(*args, **kw)
        sync()
        rec.update(seconds=time.perf_counter() - t0,
                   launches=fa.LAUNCHES - f0)
        return out

    def recording_encoders(model, weights, dev, *rest):
        enc_img, enc_txt = real_encoders(model, weights, dev, *rest)
        rec = evals[-1]

        def held(fn, key, *args):
            """The first call's features against the same merged weights
            with plain attention."""
            out = fn(*args)
            if key not in rec:
                with uncounted(fa):
                    model.use_flash = False
                    try:
                        ref = fn(*args)
                    finally:
                        model.use_flash = True
                rec[key] = float(cosine_rows(out.float().cpu().numpy(),
                                             ref.float().cpu().numpy()).min())
            return out

        def image(px):
            rec["image_calls"] += 1
            return held(enc_img, "image_cos_vs_plain", px)

        def text(ids, mask):
            rec["text_calls"] += 1
            return held(enc_txt, "text_cos_vs_plain", ids, mask)

        return image, text

    save_ms: list[float] = []
    real_save = ckpt.CheckpointWriter.save

    def timed_save(self, *args, **kw):
        sync()
        t0 = time.perf_counter()
        real_save(self, *args, **kw)
        save_ms.append((time.perf_counter() - t0) * 1e3)

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    tmain.evaluate, tmain.eval_encoders = timed_evaluate, recording_encoders
    ckpt.CheckpointWriter.save = timed_save
    try:
        with counted_steps(torch, fa, tmain, steps, traced,
                           2 * steps_per_epoch - 1, device, before, after):
            with fa._launch_lock:
                fa.LAUNCHES = fa.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            # ---- the main path: the training CLI with LoRA --------------------
            result = tmain.main(["--config", path, "--device", device])
            fwd, bwd = fa.LAUNCHES, fa.BWD_LAUNCHES
            # ------------------------------------------------------------------
            wall_s = time.perf_counter() - t0
    finally:
        tmain.evaluate, tmain.eval_encoders = real_evaluate, real_encoders
        ckpt.CheckpointWriter.save = real_save
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    out_dir = os.path.join(raw["save"]["output_dir"], "lora")
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    check_steps(steps, blocks, steps_per_epoch)
    if not gates.get("step0_merged_equals_base"):
        raise AssertionError("step 0: the merged model's features differ "
                             "from the base's")
    vit_l, bert_l = cfg.keep.vision.depth, cfg.keep.text.num_hidden_layers
    if len(evals) != 2:
        raise AssertionError(f"{len(evals)} evals, want one an epoch")
    for rec in evals:
        want = rec["image_calls"] * vit_l + rec["text_calls"] * bert_l
        if rec["launches"] != want or not rec["image_calls"]:
            raise AssertionError(f"eval launches {rec}, want {want}")
        for key in ("image_cos_vs_plain", "text_cos_vs_plain"):
            if not rec[key] >= 0.999:
                raise AssertionError(f"eval {key}: {rec[key]}")
    eval_launches = sum(r["launches"] for r in evals)
    if bwd != steps_per_epoch * blocks or \
            fwd != steps_per_epoch * 3 * blocks + eval_launches:
        raise AssertionError(f"launches {fwd} / {bwd}")
    # the base: the seed's draw, unchanged by every step (checked after
    # each); the snapshot taken at step 0 is that draw
    init = tmain.build_model(cfg, device).state_dict()
    if not all(torch.equal(init[n].cpu(), t)
               for n, t in snap["base"].items()):
        raise AssertionError("the base at step 0 is not the seed's draw")
    del init
    # epoch 0 froze both towers: their adapters stand as drawn, the visual
    # head's moved; its checkpoint, written while epoch 1 ran, holds the
    # adapters as they stood at its end
    epoch0 = ckpt.restore(ckpt_dir, epoch=0)["params"]
    end0 = {n: t.cpu() for n, t in snap["epoch0_end"].items()}
    if epoch0.keys() != end0.keys() or not all(
            torch.equal(epoch0[n], end0[n]) for n in end0):
        raise AssertionError("epoch 0's async checkpoint differs from the "
                             "adapters at its end")
    start = {n: t.cpu() for n, t in snap["adapters"].items()}
    towers_moved = [n for n in start if n.startswith(("visual.", "text."))
                    and not torch.equal(start[n], end0[n])]
    head_moved = [n for n in start if n.startswith("visual_head.")
                  and not torch.equal(start[n], end0[n])]
    if towers_moved or not head_moved:
        raise AssertionError(f"epoch 0: tower adapters moved "
                             f"{towers_moved[:3]}, head {head_moved}")
    last = ckpt.restore(ckpt_dir)
    open_moved = sum(not torch.equal(end0[n], last["params"][n])
                     for n in end0 if n.startswith(("visual.", "text.")))
    if open_moved < len(start) // 2:
        raise AssertionError(f"epoch 1: {open_moved} tower adapters moved")
    # the eval's metrics, every epoch
    with open(os.path.join(ckpt_dir, "results.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    metrics = {}
    for rec in records:
        for k, v in rec.items():
            if k in ("epoch", "train_loss"):
                ok = np.isfinite(v)
            elif "rank" in k:
                ok = np.isfinite(v) and v >= 1
            elif k == "val_contrastive_loss":
                ok = np.isfinite(v) and v >= 0
            else:
                ok = 0 <= v <= 1
            if not ok:
                raise AssertionError(f"epoch {rec['epoch']}: {k} = {v}")
        metrics[rec["epoch"]] = rec
    if sorted(metrics) != [0, 1] or "zeroshot-cls-WF1-median" not in \
            metrics[1] or "image_to_text_R@1" not in metrics[1]:
        raise AssertionError(f"results {records}")
    # the synced copy: the same files byte for byte, no temporary file
    remote = raw["save"]["remote_sync"]
    local_files = sorted(os.listdir(ckpt_dir))
    remote_files = sorted(os.listdir(remote))
    _, mismatch, errors = filecmp.cmpfiles(ckpt_dir, remote, local_files,
                                           shallow=False)
    if remote_files != local_files or mismatch or errors or any(
            f.endswith(".tmp") for f in remote_files):
        raise AssertionError(f"synced {remote_files} against {local_files}: "
                             f"differ {mismatch}, {errors}")
    # the same payload saved synchronously, for the blocking time
    on_device = {k: v.to(device) for k, v in last["params"].items()}
    opt = {"count": last["opt_state"]["count"],
           **{m: {k: v.to(device) for k, v in last["opt_state"][m].items()}
              for m in ("mu", "nu")}}
    sync_ms = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            ckpt.save(tmp, 0, on_device, opt, step=last["step"])
            sync_ms.append((time.perf_counter() - t0) * 1e3)
    with open(os.path.join(out_dir, "out.log")) as f:
        lora_line = next(ln for ln in f if "LoRA r=" in ln).split("| ")[-1]
    n_ad, n_ab = lora.lora_param_count(last["params"])
    out = {"card": card() if device == "cuda" else "cpu",
           "lora": lora_line.strip(), "adapter_values": n_ad,
           "ab_values": n_ab,
           "step_losses": [s["loss"] for s in steps],
           "fwd_launches": fwd, "bwd_launches": bwd,
           "train_fwd_launches": fwd - eval_launches,
           "eval_launches": eval_launches,
           **step_numbers(torch, steps, traced,
                          raw["dataloader"]["batch_size"]),
           "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
           "eval": evals, "eval_seconds": [r["seconds"] for r in evals],
           "metrics_epoch1": {k: v for k, v in metrics[1].items()
                              if k != "epoch"},
           "async_save_blocking_ms": save_ms,
           "sync_save_ms": sync_ms, "synced_files": remote_files,
           "result_epoch": result["epoch"], "ckpt_dir": ckpt_dir}
    phase("lora_train", **{k: v for k, v in out.items() if k != "ckpt_dir"})
    return out


def drive_lora_serve(torch, serve, raw: dict, ckpt_dir: str, d: str,
                     device: str = "cuda") -> dict:
    """Phase 14: ``build_server(["--lora", ckpt_dir, ...])`` over the base
    the run trained (the seed's draw, written in the released layout with
    the run's vocab), the scale from the run's params.txt, once in bf16 and
    once with ``--int8``, each driven through its core's batching path on
    the server phases' tiles and prompts."""
    import shutil

    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.train import checkpoint as ckpt
    from keep_tpu_torch.train import lora
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train.config import TrainRunConfig

    cfg = TrainRunConfig.from_dict(json.loads(json.dumps(raw)))
    write_model(d, torch, cfg.keep, device=device, keep_init=True)
    shutil.copy(raw["dataset"]["vocab_path"], os.path.join(d, "vocab.txt"))
    restored = ckpt.restore(ckpt_dir)["params"]
    scale = cfg.solver.lora_alpha / cfg.solver.lora_rank
    # the trained model's own merged encode: the run's base, the adapters
    model = tmain.build_model(cfg, device)
    base = {n: p.detach() for n, p in model.named_parameters()}
    weights = lora.merge_lora(base, {k: v.to(device)
                                     for k, v in restored.items()}, scale)
    tiles, odd = smoke_images(cfg.keep)
    out: dict = {"card": card() if device == "cuda" else "cpu",
                 "scale": scale}
    feats: dict = {}
    for int8 in (False, True):
        t0 = time.perf_counter()
        core, httpd = serve.build_server(
            ["--model-dir", d, "--lora", ckpt_dir, "--port", "0",
             "--device", device] + (["--int8"] if int8 else []))
        httpd.server_close()
        tag = "int8" if int8 else "bf16"
        try:
            setup_s = time.perf_counter() - t0
            if not int8:
                # every targeted weight the server holds, in fp32: the merge
                # of the restored adapters over the run's base, bit for bit,
                # and the stored bf16 weight its one rounding
                bad = []
                for m in lora.adapted_modules(restored):
                    lin = core.model.get_submodule(m)
                    w32 = weights[f"{m}.weight"].cpu()
                    if not (torch.equal(lin.fp32_weight, w32) and torch.equal(
                            lin.weight.cpu(), w32.to(lin.weight.dtype))):
                        bad.append(m)
                if bad:
                    raise AssertionError(f"merged weights differ: {bad[:5]}")
                out["merged_weights_checked"] = len(
                    lora.adapted_modules(restored))
            stats0 = core.stats()
            reset_launches(fa)
            # ---- the main path: serving the merged adapters ---------------
            got = {"text": core.encode_text(PROMPTS),
                   "image": core.encode_image(tiles),
                   "image_260x300": core.encode_image(odd)}
            launches, int8_launches = read_launches(fa)
            # ----------------------------------------------------------------
            stats = core.stats()
            enc = core.tokenizer(PROMPTS, max_length=core.max_length)
        finally:
            core.stop()
            del core
            if device == "cuda":
                torch.cuda.empty_cache()
        img_disp = stats["image"]["dispatches"] - stats0["image"]["dispatches"]
        txt_disp = stats["text"]["dispatches"] - stats0["text"]["dispatches"]
        check_features("text", got["text"], 3, cfg.keep.text.hidden_size)
        for k in ("image", "image_260x300"):
            check_features(k, got[k], len(got[k]), cfg.keep.projection_dim)
        vit_l = cfg.keep.vision.depth
        bert_l = cfg.keep.text.num_hidden_layers
        if not int8 and launches < img_disp * vit_l + txt_disp * bert_l:
            raise AssertionError(f"attention launches {launches}")
        row = {"setup_s": setup_s, "attention_launches": launches,
               "image_dispatches": img_disp, "text_dispatches": txt_disp}
        if int8:
            want = {"quantized_attention_block": img_disp * vit_l,
                    "quantized_attention_block_postln": txt_disp * bert_l,
                    "quantized_mlp_bsd": img_disp * vit_l + txt_disp * bert_l,
                    "quantized_matmul_bsd": img_disp,
                    "quantized_matmul": 2 * img_disp}
            for name, n in want.items():
                if int8_launches.get(name, 0) != n:
                    raise AssertionError(f"{name}: "
                                         f"{int8_launches.get(name, 0)} "
                                         f"launches, want {n}")
            cos = {k: cosine_rows(v, feats["bf16"][k]) for k, v in got.items()}
            row.update(launches=int8_launches,
                       min_cos_vs_bf16={k: float(c.min())
                                        for k, c in cos.items()})
        else:
            from keep_tpu_torch.ops.preprocess import normalize_only

            ids, mask = (torch.as_tensor(enc[k]).long().to(device)
                         for k in ("input_ids", "attention_mask"))
            with torch.inference_mode(), lora.swapped(model, weights):
                ref = {"text": model.encode_text(ids, mask),
                       "image": model.encode_image(normalize_only(
                           torch.from_numpy(tiles).to(device)))}
            cos = {k: cosine_rows(got[k], v.float().cpu().numpy())
                   for k, v in ref.items()}
            row["min_cos_vs_trained_merged"] = {k: float(c.min())
                                                for k, c in cos.items()}
        for k, c in cos.items():
            if not (c >= 0.999).all():
                raise AssertionError(f"{tag} {k}: cosine {c}")
        feats[tag] = got
        out[tag] = row
    del model, weights, base
    phase("lora_serve", **out)
    return out


def write_model(d: str, torch, cfg, device: str = "cuda",
                keep_init: bool = False) -> None:
    from keep_tpu_torch.compat.torch_loader import random_keep_state_dict

    gen = torch.Generator(device=device).manual_seed(0)
    sd = random_keep_state_dict(cfg, gen, device=device, keep_init=keep_init)
    torch.save({k: v.cpu() for k, v in sd.items()},
               os.path.join(d, "pytorch_model.bin"))
    t = cfg.text
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "vision_config": dataclasses.asdict(cfg.vision),
            "text_config": {
                "vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                "num_hidden_layers": t.num_hidden_layers,
                "num_attention_heads": t.num_attention_heads,
                "intermediate_size": t.intermediate_size,
                "max_position_embeddings": t.max_position_embeddings,
                "type_vocab_size": t.type_vocab_size,
                "layer_norm_eps": t.ln_eps, "pad_token_id": t.pad_token_id},
            "projection_dim": cfg.projection_dim,
            "max_text_length": cfg.max_text_length,
        }, f)
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(VOCAB) + "\n")


def smoke_images(cfg) -> tuple[np.ndarray, np.ndarray]:
    """The tiles the server phases send: 8 model-size ones and one 260×300
    image that takes the host-side resize."""
    rng = np.random.default_rng(0)
    size = cfg.vision.img_size
    tiles = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    odd = rng.integers(0, 256, (1, 260, 300, 3), dtype=np.uint8)
    return tiles, odd


def served_features(torch, serve, cfg, d: str, quantize: bool,
                    device: str = "cuda", plain_blocks: bool = False) -> dict:
    """The features a server built as ``build_server`` builds it (bf16,
    fused attention; ``quantize`` as ``--int8``) gives for the server
    phases' inputs, through its core in this process, without HTTP. With
    ``plain_blocks`` the int8 blocks run their plain versions on the
    card."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    model = KEEPModel.from_pretrained(d, dtype=torch.bfloat16, use_flash=True,
                                      device=device, quantize=quantize)
    core = serve.InferenceServer(
        model, WordPieceTokenizer.from_pretrained(d),
        max_length=min(cfg.max_text_length,
                       cfg.text.max_position_embeddings),
        image_size=cfg.vision.img_size)
    tiles, odd = smoke_images(cfg)
    try:
        with (plain_int8_blocks() if plain_blocks
              else contextlib.nullcontext()):
            return {"text": core.encode_text(PROMPTS),
                    "image": core.encode_image(tiles),
                    "image_260x300": core.encode_image(odd)}
    finally:
        core.stop()


@contextlib.contextmanager
def plain_int8_blocks():
    """The int8 blocks' plain versions on the card: what ``_kops.ops_for``
    hands a CUDA tensor for the duration."""
    from keep_tpu_torch.kernels import _kops

    kernels = _kops.KERNELS
    _kops.KERNELS = _kops.PLAIN
    try:
        yield
    finally:
        _kops.KERNELS = kernels


def int8_route(feats: np.ndarray, ref: np.ndarray) -> dict:
    """Two int8 routes through the same weights (the kernels against their
    plain versions) in the JAX package's gate's forms: the mean of the
    per-row cosines (image rows, tests/test_quant.py:300) and the cosine of
    the features taken whole (text, :327), with the per-row minimum."""
    rows = cosine_rows(feats, ref)
    a, b = feats.ravel(), ref.ravel()
    return {"mean_row_cos": float(rows.mean()),
            "whole_cos": float(a @ b / np.linalg.norm(a) / np.linalg.norm(b)),
            "min_row_cos": float(rows.min()), "rows": int(len(rows))}


def http(port: int, path: str, body: bytes | None = None,
         content_type: str = "application/json") -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": content_type} if body is not None else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def check_features(name: str, x: np.ndarray, n: int, width: int) -> None:
    if x.shape != (n, width):
        raise AssertionError(f"{name}: shape {x.shape}, want {(n, width)}")
    if not np.isfinite(x).all():
        raise AssertionError(f"{name}: non-finite features")
    norms = np.linalg.norm(x, axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-3):
        raise AssertionError(f"{name}: norms {norms}")


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def drive_server(torch, fa, serve, cfg, d: str, device: str = "cuda",
                 bf16_features: dict | None = None,
                 plain_int8_features: dict | None = None):
    """Phase 4, or with ``bf16_features`` (phase 4's served features) phase
    6: the int8 server, held to those and to ``plain_int8_features`` (the
    same int8 model with its blocks' plain versions). Returns the phase's
    result, the running server core (the caller stops it) and the served
    features."""
    from keep_tpu_torch.kernels import _kops
    from keep_tpu_torch.models.keep import KEEPModel

    int8 = bf16_features is not None
    t0 = time.perf_counter()
    core, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                      "--device", device]
                                     + (["--int8"] if int8 else []))
    setup_s = time.perf_counter() - t0
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        tiles, odd = smoke_images(cfg)
        sim_imgs = tiles[:2]

        stats0 = core.stats()
        with fa._launch_lock:
            fa.LAUNCHES = 0
        with _kops._launch_lock:
            _kops.LAUNCHES.clear()
        # ---- the main path, through the HTTP front end -------------------
        txt = np.asarray(json.loads(http(port, "/encode_text", json.dumps(
            {"texts": PROMPTS}).encode()))["embeddings"], np.float32)
        buf = io.BytesIO()
        np.save(buf, tiles)
        img = np.load(io.BytesIO(http(port, "/encode_image_npy",
                                      buf.getvalue(),
                                      "application/octet-stream")))
        sim = np.asarray(json.loads(http(port, "/similarity", json.dumps(
            {"texts": PROMPTS[:2], "images": sim_imgs.tolist()}).encode()))
            ["logits"], np.float32)
        odd_feat = np.asarray(json.loads(http(port, "/encode_image", json.dumps(
            {"images": odd.tolist()}).encode()))["embeddings"], np.float32)
        stats = json.loads(http(port, "/stats"))
        launches = fa.LAUNCHES
        int8_launches = dict(_kops.LAUNCHES)
        # -----------------------------------------------------------------
        check_features("encode_text", txt, 3, cfg.text.hidden_size)
        check_features("encode_image_npy", img, 8, cfg.projection_dim)
        check_features("encode_image (260x300)", odd_feat, 1,
                       cfg.projection_dim)
        if sim.shape != (2, 2) or not np.isfinite(sim).all():
            raise AssertionError(f"similarity: {sim.shape}")
        # every block of every dispatch of the run went through the kernel
        img_disp = stats["image"]["dispatches"] - stats0["image"]["dispatches"]
        txt_disp = stats["text"]["dispatches"] - stats0["text"]["dispatches"]
        want = (img_disp * cfg.vision.depth
                + txt_disp * cfg.text.num_hidden_layers)
        if img_disp < 3 or txt_disp < 2 or launches < want:
            raise AssertionError(
                f"kernel launches {launches} < {want} for {img_disp} image "
                f"and {txt_disp} text dispatches")
        feats = {"text": txt, "image": img, "image_260x300": odd_feat}
        sim_err = float(np.abs(sim - img[:2] @ txt[:2].T).max())
        if sim_err > 1e-2:
            raise AssertionError(f"similarity vs features: {sim_err}")
        if int8:
            return (check_int8_server(cfg, feats, bf16_features,
                                      plain_int8_features, int8_launches,
                                      img_disp, txt_disp, launches, setup_s,
                                      sim_err),
                    core, feats)

        # the same weights without the kernel (plain attention), same bf16
        plain = KEEPModel(cfg, dtype=torch.bfloat16, use_flash=False,
                          device=device)
        plain.load_state_dict(core.model.state_dict())
        ref_core = serve.InferenceServer(plain, core.tokenizer,
                                         max_length=core.max_length,
                                         image_size=core.image_size)
        try:
            ref_txt = ref_core.encode_text(PROMPTS)
            ref_img = ref_core.encode_image(tiles)
            ref_odd = ref_core.encode_image(odd)
        finally:
            ref_core.stop()
        cos = {"text": cosine_rows(txt, ref_txt),
               "image": cosine_rows(img, ref_img),
               "image_260x300": cosine_rows(odd_feat, ref_odd)}
        for k, c in cos.items():
            if not (c >= 0.999).all():
                raise AssertionError(f"{k}: cosine vs plain attention {c}")
        result = {"setup_s": setup_s, "launches": launches,
                  "image_dispatches": img_disp, "text_dispatches": txt_disp,
                  "min_cos_vs_plain": {k: float(c.min()) for k, c in
                                       cos.items()},
                  "similarity_max_err": sim_err}
        phase("server", **result)
        return result, core, feats
    except BaseException:
        core.stop()
        raise
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def check_int8_server(cfg, feats, bf16_features, plain_features, launches,
                      img_disp, txt_disp, attention_launches, setup_s,
                      sim_err) -> dict:
    """Phase 6's checks: the int8 features against the bf16 server's
    (cosine ≥ 0.999 per row) and against the same int8 model with its
    blocks' plain versions at the JAX package's gate between two int8
    routes, in its form: > 0.9999 for the image rows' mean cosine
    (tests/test_quant.py:300) and for the cosine of the text features taken
    whole (:327); and every block of every dispatch through its tower's
    int8 kernels. The per-row cosines are reported: at full width two int8
    routes through the same weights differ by up to ~2e-4 per row on the
    text tower (the JAX package's own int8 BERT-base against the port's
    plain one, tests/test_torch_quant.py
    ``test_int8_bert_base_routes_at_full_width``), so a per-row gate there
    would fail the reference itself."""
    cos = {k: cosine_rows(v, bf16_features[k]) for k, v in feats.items()}
    for k, c in cos.items():
        if not (c >= 0.999).all():
            raise AssertionError(f"{k}: int8 cosine vs the bf16 server {c}")
    cos_plain = {k: cosine_rows(v, plain_features[k])
                 for k, v in feats.items()}
    text, ref_text = feats["text"].ravel(), plain_features["text"].ravel()
    route_gate = {"image_mean": float(np.concatenate(
                      [cos_plain["image"], cos_plain["image_260x300"]]).mean()),
                  "text_whole": float(text @ ref_text / np.linalg.norm(text)
                                      / np.linalg.norm(ref_text))}
    if not all(v > 0.9999 for v in route_gate.values()):
        raise AssertionError(f"int8 features vs the int8 model's plain "
                             f"blocks: {route_gate}")
    vit_l, bert_l = cfg.vision.depth, cfg.text.num_hidden_layers
    want = {"quantized_attention_block": img_disp * vit_l,
            "quantized_attention_block_postln": txt_disp * bert_l,
            "quantized_mlp_bsd": img_disp * vit_l + txt_disp * bert_l,
            "quantized_matmul_bsd": img_disp,   # the patch embed
            "quantized_matmul": 2 * img_disp}   # the visual head's linears
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(
                f"{name}: {launches.get(name, 0)} launches, want {n} for "
                f"{img_disp} image and {txt_disp} text dispatches")
    if attention_launches < img_disp * vit_l + txt_disp * bert_l:
        raise AssertionError(f"attention launches {attention_launches}")
    result = {"setup_s": setup_s, "launches": launches,
              "attention_launches": attention_launches,
              "image_dispatches": img_disp, "text_dispatches": txt_disp,
              "min_cos_vs_bf16_server": {k: float(c.min())
                                         for k, c in cos.items()},
              "cos_vs_int8_plain_blocks": route_gate,
              "min_row_cos_vs_int8_plain_blocks": {
                  k: float(c.min()) for k, c in cos_plain.items()},
              "similarity_max_err": sim_err}
    phase("server_int8", **result)
    return result


# ---- 28. precision_policy: --precision-policy auto's probe -----------------

# a relay's median round trip, as tests/test_serve.py:424 sets it
RELAY_MS = 28.0
POLICY_MEMORY_GATE = 0.05   # of the co-located build's device bytes
POLICY_BUCKETS = (8, 128)   # besides bucket 1, held to the int8 model


def _allocated(torch, device: str) -> int:
    import gc

    gc.collect()
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def policy_build(torch, serve, d: str, device: str, probe=None) -> tuple:
    """``build_server(["--int8"])`` on ``d``: the core, the lines it
    printed (echoed), the device bytes it holds once built, and what
    ``rtt.pick_by_probe`` returned (``probe`` in its place, or the real
    one, recorded)."""
    from keep_tpu_torch.utils import rtt

    real, seen = rtt.pick_by_probe, []

    def recorded(*a, **kw):
        out = (probe or real)(*a, **kw)
        seen.append(out)
        return out

    base = _allocated(torch, device)
    buf = io.StringIO()
    rtt.pick_by_probe = recorded
    try:
        with contextlib.redirect_stdout(buf):
            core, httpd = serve.build_server(["--model-dir", d, "--port", "0",
                                              "--device", device, "--int8"])
    finally:
        rtt.pick_by_probe = real
    httpd.server_close()
    print(buf.getvalue(), end="", flush=True)
    return core, buf.getvalue(), _allocated(torch, device) - base, (
        seen[0] if seen else None)


def counted_serve(fa, core, tiles) -> tuple:
    """One ``encode_image`` of ``core``, with the launch counts set to 0
    just before it and read just after: (features, #1's launches, the
    int8 operators')."""
    reset_launches(fa)
    feats = core.encode_image(tiles)
    attention, int8 = read_launches(fa)
    return feats, attention, {k: v for k, v in int8.items() if v}


def own_features(torch, model, tiles, cfg, device: str) -> np.ndarray:
    """``model.encode_image`` of the uint8 ``tiles``, normalised on the
    device as the server does, outside any server."""
    from keep_tpu_torch.configs import PreprocessConfig
    from keep_tpu_torch.ops.preprocess import normalize_only

    px = torch.from_numpy(np.ascontiguousarray(tiles)).to(device)
    with torch.inference_mode():
        out = model.encode_image(normalize_only(
            px, PreprocessConfig(size=cfg.vision.img_size)))
    return out.float().cpu().numpy()


def int8_dispatch_launches(cfg) -> dict:
    """The int8 operators' launches in one image dispatch."""
    return {"quantized_attention_block": cfg.vision.depth,
            "quantized_mlp_bsd": cfg.vision.depth,
            "quantized_matmul_bsd": 1, "quantized_matmul": 2}


def check_route(tag: str, cfg, attention: int, int8: dict,
                bf16: bool) -> None:
    """A bf16 dispatch launches #1 a block and no int8 kernel; an int8 one
    #1 a block inside #4 and #4 / #6 / #8 / #9 as
    ``int8_dispatch_launches`` says."""
    want = {} if bf16 else int8_dispatch_launches(cfg)
    got = int8 if bf16 else {k: int8.get(k, 0) for k in want}
    if attention != cfg.vision.depth or got != want:
        raise AssertionError(
            f"{tag}: #1 {attention} launches, int8 operators {int8}; want "
            f"{cfg.vision.depth} and {want}")


def drive_precision_policy(torch, fa, serve, cfg, d: str,
                           device: str = "cuda", relay_ms: float = RELAY_MS,
                           buckets: tuple = POLICY_BUCKETS) -> dict:
    """28. precision_policy (see the module docstring)."""
    import math

    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
    from keep_tpu_torch.utils import rtt

    t0 = time.perf_counter()
    key = str(torch.device(device))
    rng = np.random.default_rng(28)
    size = cfg.vision.img_size
    tile = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    batches = {b: rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8)
               for b in buckets}
    out: dict = {}

    # (a) as it stands: the link measured, co-located
    rtt._memo.pop(key, None)
    core, text, colocated_bytes, probed = policy_build(torch, serve, d,
                                                       device)
    try:
        link = rtt._memo[key]
        if ("co-located — int8 at every bucket" not in text or probed
                or core.alt_model is not None or rtt.rtt_dominated(link)):
            raise AssertionError(f"co-located build: {text!r}, probe "
                                 f"{probed}, link {link}")
        out["colocated"] = {"rtt_median_ms": link["median_ms"],
                            "rtt_p95_ms": link["p95_ms"],
                            "device_bytes": colocated_bytes}
    finally:
        core.stop()
    del core

    # (b) a relay's round trip: the real probe decides image bucket 1
    rtt._memo[key] = {"median_ms": relay_ms, "p95_ms": relay_ms,
                      "min_ms": relay_ms, "n": 1}
    try:
        core, text, relay_bytes, (choice, meds) = policy_build(
            torch, serve, d, device)
        try:
            if f"relay RTT median {relay_ms:.1f} ms" not in text or \
                    f"image bucket 1 served {choice}" not in text:
                raise AssertionError(f"relay build printed {text!r}")
            bf16 = choice == "bf16"
            if (core.alt_model is not None) != bf16:
                raise AssertionError(f"probe chose {choice}, alt model "
                                     f"{core.alt_model is not None}")
            winner = core.alt_model if bf16 else core.model
            got, attention, int8 = counted_serve(fa, core, tile)
            check_route(f"relay bucket 1 ({choice})", cfg, attention, int8,
                        bf16)
            if not np.array_equal(got, own_features(torch, winner, tile, cfg,
                                                    device)):
                raise AssertionError(f"bucket 1 differs from the {choice} "
                                     f"model's own encode_image")
            for b, x in batches.items():
                if not np.array_equal(core.encode_image(x), own_features(
                        torch, core.model, x, cfg, device)):
                    raise AssertionError(f"bucket {b} differs from the int8 "
                                         f"model's own encode_image")
        finally:
            core.stop()
        del core
        out["relay"] = {"rtt_median_ms": relay_ms, "choice": choice,
                        "b1_median_ms": meds, "device_bytes": relay_bytes,
                        "bucket1_launches": {"attention": attention,
                                             **int8},
                        "bit_equal_buckets": [1, *buckets]}
        if bf16:
            # (c) the probe picked bf16: a third build, whose margin keeps
            # int8 whatever the medians, takes the memory gate
            core, text, int8_bytes, (choice_c, meds_c) = policy_build(
                torch, serve, d, device,
                probe=functools.partial(rtt.pick_by_probe, margin=math.inf))
            core.stop()
            del core
            if choice_c != "int8":
                raise AssertionError(f"infinite margin chose {choice_c}")
            out["relay_int8_kept"] = {"b1_median_ms": meds_c,
                                      "device_bytes": int8_bytes}
        else:
            int8_bytes = relay_bytes
    finally:
        rtt._memo.pop(key, None)
    if torch.device(device).type == "cuda":
        excess = abs(int8_bytes - colocated_bytes) / colocated_bytes
        out["int8_choice_bytes_vs_colocated"] = excess
        if excess > POLICY_MEMORY_GATE:
            raise AssertionError(
                f"after an int8 choice the build holds {int8_bytes} device "
                f"bytes against the co-located {colocated_bytes}: a bf16 "
                f"copy stayed")

    # (d) the server core with the bf16 model beside the int8 one, built
    # directly
    base = _allocated(torch, device)
    bf16_model = KEEPModel.from_pretrained(d, dtype=torch.bfloat16,
                                           use_flash=True, device=device)
    q = bf16_model.quantize()
    both = _allocated(torch, device) - base
    if torch.device(device).type == "cuda" and \
            both - colocated_bytes <= POLICY_MEMORY_GATE * colocated_bytes:
        raise AssertionError(f"a bf16 copy ({both - colocated_bytes} bytes) "
                             f"sits inside the memory gate")
    direct = serve.InferenceServer(
        q, WordPieceTokenizer.from_pretrained(d),
        max_length=min(cfg.max_text_length, cfg.text.max_position_embeddings),
        image_size=size, alt_model=bf16_model, alt_buckets={"image": (1,)})
    try:
        _, attention1, int8_1 = counted_serve(fa, direct, tile)
        check_route("direct bucket 1", cfg, attention1, int8_1, bf16=True)
        _, attention8, int8_8 = counted_serve(fa, direct, batches[8])
        check_route("direct bucket 8", cfg, attention8, int8_8, bf16=False)
    finally:
        direct.stop()
    del direct, q, bf16_model
    out["direct"] = {"bf16_and_int8_bytes": both,
                     "bucket1": {"attention": attention1, **int8_1},
                     "bucket8": {"attention": attention8, **int8_8}}
    out["seconds"] = time.perf_counter() - t0
    phase("precision_policy", **out)
    return out


def resources_line(kernels: list[dict]) -> list[dict]:
    """ptxas's record of every kernel function of the library
    (``utils.compile.kernel_resources``), checked to cover every ``.cu``
    the kernels line names among its sources."""
    from keep_tpu_torch.utils.compile import kernel_resources

    records = kernel_resources()
    named = {os.path.basename(p) for k in kernels
             for p in [k["source"], *k.get("sources", [])] if p.endswith(".cu")}
    covered = {r["source"] for r in records}
    if not named or named - covered:
        raise AssertionError(f"no ptxas record for {sorted(named - covered)}")
    return records


# ---- 10.–12. the zero-shot WSI sweep ----------------------------------------

# The WSI phases' sizes: a flat 16,384² slide (~3,300 tissue tiles of 256²;
# cut_tiles holds an int16 copy and an int64 integral image of it on the
# host, ~1.6 and 2.1 GB), the reference's screened prompt pool (1,386
# prompts, keep_tpu/zeroshot/classifier.py:414, 461) and a slide's long
# patch axis (100,000 patches on a 317 × 317 grid).
WSI_SLIDE_PX = 16384
WSI_BATCH = 256
WSI_PROMPTS = 1386
WSI_PATCHES = 100_000
WSI_GRID = 317
WSI_TOPN = 50
# segmentation's level-0 mask is drawn at 32 pixels a patch instead of 256
# (10,144² instead of 81,152²: the integral image of the full-size mask
# would take 53 GB of host memory); the patches' grid is the same
WSI_SEG_PATCH = 32
# a score this close to a decision threshold may land on either side of it
# under another summation order: such patches are counted and reported
NEAR = 1e-5


@functools.lru_cache(maxsize=1)
def wsi_slide(px: int, seed: int = 0) -> np.ndarray:
    """A flat synthetic H&E slide [px, px, 3] uint8 from ``seed`` (the last
    one made is kept: callers read it, never write it): a tissue
    disc (pink-purple and saturated, its colour shifted per 64-pixel block,
    with per-pixel noise) on a bright unsaturated background that
    ``io.tiles.tissue_mask`` rejects. One 1,024-row band of noise serves
    every band."""
    rng = np.random.default_rng(seed)
    nb = -(-px // 64)
    shade = rng.integers(-30, 31, (nb, nb, 3)).astype(np.int16)
    tissue = np.array([160, 80, 140], np.int16)
    band = min(px, 1024)
    noise = rng.integers(0, 48, (band, px, 3), dtype=np.uint8)
    c, r2 = (px - 1) / 2, (0.5 * px) ** 2
    xs = np.arange(px)
    img = np.empty((px, px, 3), np.uint8)
    for y0 in range(0, px, band):
        ys = np.arange(y0, min(px, y0 + band))
        nz = noise[: len(ys)]
        inside = (ys[:, None] - c) ** 2 + (xs[None] - c) ** 2 <= r2
        color = tissue + shade[ys // 64][:, xs // 64] + nz
        img[ys[0]: ys[-1] + 1] = np.where(inside[..., None], color,
                                          236 + nz // 16)
    return img


# VOCAB's words by the class whose names they make: shared, then Normal's
# and Tumor's own
WSI_WORDS = {"shared": "an h & e image of breast lung skin kidney cell . , -",
             "Normal": "normal tissue",
             "Tumor": "invasive carcinoma adeno squamous melanoma clear "
                      "renal tumor"}


def wsi_prompts(n: int, seed: int = 0) -> dict:
    """``n`` two-class prompt dicts in the reference's JSON shape, their
    class names drawn with ``seed`` from ``VOCAB``'s words, half the draws
    from the words of the class's own (``WSI_WORDS``): 3–38 words, so 5–40
    tokens with [CLS] and [SEP] (mean ~15) in a 256-token contract."""
    rng = np.random.default_rng(seed)
    shared = WSI_WORDS["shared"].split()

    def name(cls: str) -> str:
        own = WSI_WORDS[cls].split()
        k = int(np.clip(round(rng.normal(13, 6)), 3, 38))
        p = [0.5 / len(shared)] * len(shared) + [0.5 / len(own)] * len(own)
        return " ".join(rng.choice(shared + own, k, p=p))

    return {str(i): {"classnames": {c: name(c) for c in ("Normal", "Tumor")},
                     "templates": "CLASSNAME"} for i in range(n)}


def wsi_patches(stack: np.ndarray, n: int, grid: int, seed: int = 0):
    """Seeded features [n, D] and (x, y) coords of a slide's patches on a
    ``grid`` × ``grid`` lattice (holes, and 100 duplicated coordinates that
    the first-seen rule drops): inside a tumour disc the features lean
    towards the direction that tells the stack's Tumor columns from its
    Normal ones, outside away from it, at spread lengths with noise, so
    that most probabilities lie away from 0.5 and the 2×2 refinement moves
    them. Returns (features, coords, inside the disc)."""
    rng = np.random.default_rng(seed)
    dup = 100
    cells = rng.permutation(grid * grid)[: n - dup]
    cells = np.concatenate([cells, cells[:dup]])
    r, c = cells // grid, cells % grid
    coords = np.stack([c * 256, r * 256], 1).astype(np.int64)
    u = (stack[:, :, 1] - stack[:, :, 0]).mean(0)
    u = u / np.linalg.norm(u)
    mid, radius = (grid - 1) / 2, 0.3 * grid
    inside = (r - mid) ** 2 + (c - mid) ** 2 <= radius ** 2
    sign = np.where(inside, 1.0, -1.0)[:, None]
    feats = (sign * rng.uniform(0.5, 1.5, (n, 1)) * u
             + 0.02 * rng.standard_normal((n, u.size))).astype(np.float32)
    return feats, coords, inside


def seg_mask(grid: int, ps: int) -> np.ndarray:
    """The level-0 mask of ``wsi_patches``'s tumour disc at ``ps`` pixels a
    patch."""
    mid, radius = (grid - 1) / 2, 0.3 * grid
    px = (np.arange(grid * ps) + 0.5) / ps - 0.5
    return (((px[:, None] - mid) ** 2 + (px[None] - mid) ** 2
             <= radius ** 2) * 255).astype(np.uint8)


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def synced_ms(torch, fn, device: str = "cuda"):
    """(result, wall ms) of one call of ``fn``, the card synchronised
    before and after (nothing to wait for on the CPU)."""
    _sync(torch, device)
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def tf32_on(torch):
    """cuBLAS's fp32 matmuls with TF32 on; the run's setting restored."""
    from keep_tpu_torch.ops.nn import restore_tf32, tf32_state

    saved = tf32_state()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        restore_tf32(saved)


@contextlib.contextmanager
def unguarded_fp32():
    """The sweep's fp32 products without ``ops.nn.ieee_fp32``: the control
    that shows the guard, not the card's choice of kernel, keeps TF32 out
    of them (under TF32 they must then change)."""
    from keep_tpu_torch.ops import preprocess
    from keep_tpu_torch.wsi import pipelines
    from keep_tpu_torch.zeroshot import classifier

    mods = (preprocess, pipelines, classifier)
    saved = [m.ieee_fp32 for m in mods]
    for m in mods:
        m.ieee_fp32 = contextlib.nullcontext
    try:
        yield
    finally:
        for m, guard in zip(mods, saved):
            m.ieee_fp32 = guard


def reset_launches(fa) -> None:
    from keep_tpu_torch.kernels import _kops

    with fa._launch_lock:
        fa.LAUNCHES = 0
    with _kops._launch_lock:
        _kops.LAUNCHES.clear()


def read_launches(fa) -> tuple[int, dict]:
    from keep_tpu_torch.kernels import _kops

    return fa.LAUNCHES, dict(_kops.LAUNCHES)


def pixels_255(torch, x, cfg) -> "torch.Tensor":
    """Normalised pixels back on the 0..255 scale."""
    mean = torch.tensor(cfg.mean, device=x.device)
    std = torch.tensor(cfg.std, device=x.device)
    return (x * std + mean) * 255.0


def drive_wsi_extract(torch, fa, d: str, device: str = "cuda",
                      slide_px: int = WSI_SLIDE_PX,
                      batch_size: int = WSI_BATCH) -> dict:
    """Phase 10: a flat slide → ``cut_tiles`` → ``extract_features(resize=
    True)`` with the model ``wsi.run.load_model`` loads (bf16, the fused
    attention), then with ``--int8``'s (calibration 0). Gates: the card's
    bicubic against the port's CPU ``preprocess`` on 64 tiles (≤ 1/255
    before normalisation, and the same bits with TF32 on); the features
    against the same model with plain attention on the first batch (cosine
    ≥ 0.999 per row); ``pipeline_depth`` 1 against 3 (the same bits); the
    tail-padded last batch against its rows encoded alone (cosine ≥
    0.9999); the int8 features against bf16 (cosine ≥ 0.999 per row) and,
    on the first batch, against the same int8 model with plain blocks
    (mean row cosine > 0.9999); one attention launch per block of every
    batch. The TF32 gate has a control: without the guard TF32 must move
    pixels. Returns the phase's result and what the next phases use."""
    import argparse

    from keep_tpu_torch.configs import PreprocessConfig
    from keep_tpu_torch.io.tiles import cut_tiles
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.ops.preprocess import preprocess
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.wsi.extract import extract_features

    cfg = PreprocessConfig()
    t0 = time.perf_counter()
    slide = wsi_slide(slide_px)
    slide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles, coords = cut_tiles(slide, patch_size=256, tissue_fraction=0.25)
    cut_s = time.perf_counter() - t0
    del slide
    n = len(tiles)
    if n < 2 * batch_size:
        raise AssertionError(f"{n} tissue tiles")
    args = argparse.Namespace(model=d, device=device, int8=False)
    model, tokenizer = wsi_run.load_model(args)
    depth = model.cfg.vision.depth
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def extract(m, t, **kw):
        return extract_features(m, t, batch_size=kw.pop("bs", batch_size),
                                resize=True, **kw)

    extract(model, tiles[:batch_size])  # the first call pays the setup
    sync()
    reset_launches(fa)
    # ---- the main path --------------------------------------------------
    t0 = time.perf_counter()
    feats = extract(model, tiles)
    wall = time.perf_counter() - t0
    launches, _ = read_launches(fa)
    # ----------------------------------------------------------------------
    batches = -(-n // batch_size)
    if device == "cuda" and launches != batches * depth:
        raise AssertionError(f"extract: {launches} attention launches, want "
                             f"{batches * depth}")
    check_features("extract", feats, n, model.cfg.projection_dim)

    # the card's bicubic against the port's CPU preprocess, TF32 off and on
    few = torch.from_numpy(tiles[:64])
    on_card = preprocess(few.to(device), cfg)
    cpu = preprocess(few, cfg)
    diff = (pixels_255(torch, on_card.cpu(), cfg)
            - pixels_255(torch, cpu, cfg)).abs()
    if not diff.max().item() <= 1.0 + 1e-3:
        raise AssertionError(f"bicubic card vs CPU: {diff.max().item()}/255")
    with tf32_on(torch):
        tf32_same = bool(torch.equal(preprocess(few.to(device), cfg),
                                     on_card))
        with unguarded_fp32():
            loose = preprocess(few.to(device), cfg)
    tf32_moved = (loose != on_card).float().mean().item()
    del loose
    if not tf32_same:
        raise AssertionError("bicubic: TF32 on changed the pixels")
    if device == "cuda" and tf32_moved == 0.0:
        raise AssertionError("bicubic control: TF32 on without the guard "
                             "moved no pixel, so the gate cannot see it")

    # the same model with plain attention on the first batch
    plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                      device=device)
    plain.load_state_dict(model.state_dict())
    ref = extract(plain, tiles[:batch_size])
    del plain
    cos_plain = cosine_rows(feats[:batch_size], ref)
    if not (cos_plain >= 0.999).all():
        raise AssertionError(f"extract vs plain attention: {cos_plain.min()}")
    # pipeline depth 1 against 3 on four batches and a tail
    part = tiles[: 4 * batch_size + batch_size // 3]
    d1 = extract(model, part, pipeline_depth=1)
    d3 = extract(model, part, pipeline_depth=3)
    if not np.array_equal(d1, d3):
        raise AssertionError("pipeline_depth 1 and 3 differ")
    # the tail-padded last batch against its rows encoded alone
    tail = n % batch_size or batch_size
    alone = extract(model, tiles[n - tail:], bs=tail)
    cos_tail = cosine_rows(feats[n - tail:], alone)
    if not (cos_tail >= 0.9999).all():
        raise AssertionError(f"tail rows alone: {cos_tail.min()}")

    # the bicubic alone, one batch on the card; and where the time goes
    x = torch.from_numpy(tiles[:batch_size]).to(device)
    out = {"slide_px": slide_px, "slide_s": slide_s, "cut_tiles_s": cut_s,
           "tiles": n, "batches": batches, "batch_size": batch_size,
           "tiles_per_s_bf16": n / wall, "wall_s_bf16": wall,
           "attention_launches": launches,
           "attention_launches_per_batch": launches / batches,
           "bicubic_max_abs_err_255": diff.max().item(),
           "bicubic_share_differing": (diff > 0.5).float().mean().item(),
           "bicubic_same_bits_tf32_on": tf32_same,
           "bicubic_tf32_unguarded_share_moved": tf32_moved,
           "min_cos_vs_plain_attention": float(cos_plain.min()),
           "depth_1_3_same_bits": True, "tail_rows": tail,
           "min_cos_tail_alone": float(cos_tail.min())}
    if device == "cuda":
        out["bicubic_ms_per_batch"] = cuda_ms(lambda: preprocess(x, cfg))
        (out["bicubic_device_ms_per_batch"],
         out["bicubic_device_ms_source"]) = device_ms(
            torch, lambda: preprocess(x, cfg))
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            extract(model, tiles)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        busy = sum(kernel_ms(torch, prof).values()) / 1e3
        out["profiled_wall_s"] = prof_wall
        out["profiled_kernel_s"] = busy
        out["idle_share"] = 1.0 - busy / prof_wall if busy else "not measured"
    del x

    # the --int8 towers (calibration 0) on the same tiles
    model8, _ = wsi_run.load_model(argparse.Namespace(model=d, device=device,
                                                      int8=True))
    extract(model8, tiles[:batch_size])
    sync()
    reset_launches(fa)
    # ---- the main path, int8 ---------------------------------------------
    t0 = time.perf_counter()
    feats8 = extract(model8, tiles)
    wall8 = time.perf_counter() - t0
    attn8, launches8 = read_launches(fa)
    # ----------------------------------------------------------------------
    want8 = {"quantized_attention_block": batches * depth,
             "quantized_mlp_bsd": batches * depth,
             "quantized_matmul_bsd": batches, "quantized_matmul": 2 * batches}
    if device == "cuda":
        for k, v in want8.items():
            if launches8.get(k, 0) != v:
                raise AssertionError(f"int8 extract: {k} {launches8.get(k)} "
                                     f"launches, want {v}")
    cos8 = cosine_rows(feats8, feats)
    if not (cos8 >= 0.999).all():
        raise AssertionError(f"int8 extract vs bf16: {cos8.min()}")
    # the int8 kernels at this path's shapes (M = batch · 197) against
    # their plain versions on the first batch, at the gate between two
    # int8 routes (image rows: the mean of the per-row cosines)
    with plain_int8_blocks():
        ref8 = extract(model8, tiles[:batch_size])
    route8 = int8_route(feats8[:batch_size], ref8)
    if not route8["mean_row_cos"] > 0.9999:
        raise AssertionError(f"int8 extract vs its plain blocks: {route8}")
    out.update(tiles_per_s_int8=n / wall8, wall_s_int8=wall8,
               int8_launches=launches8, int8_attention_launches=attn8,
               min_cos_int8_vs_bf16=float(cos8.min()),
               int8_vs_plain_blocks=route8)
    if device == "cuda":
        out["card"] = card()
    phase("wsi_extract", **out)
    return {"result": out, "model": model, "model8": model8,
            "tokenizer": tokenizer, "features": feats, "coords": coords}


def drive_wsi_classifier(torch, fa, model, model8, tokenizer,
                         device: str = "cuda", n_prompts: int = WSI_PROMPTS,
                         batch_size: int = 256, max_length: int = 256
                         ) -> dict:
    """Phase 11: ``build_classifiers_batched`` over ``n_prompts`` two-class
    prompts with ``length_buckets="auto"`` and then ``None`` (flat), through
    ``wsi.run``'s text encoder; the two stacks' columns at cosine ≥ 0.9999;
    12 attention launches per text dispatch; the first batch of each width
    dispatched against the same BERT with plain attention (cosine ≥ 0.999
    per row); then the flat build with the int8 towers, whose columns hold
    cosine ≥ 0.999 against bf16, and whose batches hold > 0.9999 (taken
    whole) against the same int8 model with plain blocks."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.zeroshot import build_classifiers_batched

    prompts = wsi_prompts(n_prompts)
    label_map = {"Normal": 0, "Tumor": 1}
    layers = model.cfg.text.num_hidden_layers
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def build(m, buckets, info=None):
        enc = wsi_run._encoder(m, torch.device(device))
        calls, firsts = [], {}

        def counted(ids, mask):
            calls.append(ids.shape)
            # the first batch of each width, for the checks against plain
            firsts.setdefault(ids.shape[1], (np.array(ids), np.array(mask)))
            return enc(ids, mask)

        sync()
        reset_launches(fa)
        t0 = time.perf_counter()
        stack = build_classifiers_batched(
            counted, tokenizer, prompts, label_map, max_length=max_length,
            batch_size=batch_size, length_buckets=buckets, device=device,
            info=info)
        sync()
        wall = time.perf_counter() - t0
        launches, by_name = read_launches(fa)
        if device == "cuda" and launches != len(calls) * layers:
            raise AssertionError(f"classifier: {launches} attention launches "
                                 f"for {len(calls)} dispatches")
        return stack, wall, calls, launches, by_name, firsts

    def encoded(m, batches) -> dict:
        enc = wsi_run._encoder(m, torch.device(device))
        return {w: enc(ids, mask).float().cpu().numpy()
                for w, (ids, mask) in sorted(batches.items())}

    info: dict = {}
    # ---- the main path: the bucketed ("auto") build, then the flat one --
    auto, auto_s, auto_calls, auto_launches, _, auto_firsts = build(
        model, "auto", info)
    flat, flat_s, flat_calls, flat_launches, _, flat_firsts = build(
        model, None)
    # ----------------------------------------------------------------------
    # the kernel at each width the builds dispatched, one batch each,
    # against the same BERT with plain attention (the repo's bf16 gate)
    batches = {**flat_firsts, **auto_firsts}
    got = encoded(model, batches)
    plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                      device=device)
    plain.load_state_dict(model.state_dict())
    want = encoded(plain, batches)
    del plain
    cos_plain = {w: float(cosine_rows(got[w], want[w]).min()) for w in got}
    if not all(c >= 0.999 for c in cos_plain.values()):
        raise AssertionError(f"text tower vs plain attention by width: "
                             f"{cos_plain}")
    a, f = auto.cpu().numpy(), flat.cpu().numpy()
    cos = (a * f).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(f, axis=1))  # [P, C]
    if not (cos >= 0.9999).all():
        raise AssertionError(f"bucketed vs flat columns: {cos.min()}")
    texts = 2 * n_prompts
    lengths = np.asarray(tokenizer(
        [p["classnames"][k] for p in prompts.values()
         for k in ("Normal", "Tumor")],
        max_length=max_length)["attention_mask"]).sum(1)
    out = {"prompts": n_prompts, "texts": texts,
           "tokens_min_mean_max": [int(lengths.min()), float(lengths.mean()),
                                   int(lengths.max())],
           "plan": info.get("plan"), "method": info.get("method"),
           "chooser": {k: v for k, v in info.items()
                       if k not in ("plan", "method")},
           "prompts_per_s_auto": n_prompts / auto_s,
           "prompts_per_s_flat": n_prompts / flat_s,
           "dispatches_auto": len(auto_calls),
           "widths_auto": sorted({s[1] for s in auto_calls}),
           "dispatches_flat": len(flat_calls),
           "attention_launches_auto": auto_launches,
           "attention_launches_flat": flat_launches,
           "attention_launches_per_text_dispatch":
               flat_launches / len(flat_calls),
           "min_column_cos_auto_vs_flat": float(cos.min()),
           "max_abs_diff_auto_vs_flat": float(np.abs(a - f).max()),
           "min_row_cos_vs_plain_attention_by_width": cos_plain,
           "rows_vs_plain_by_width": {w: len(v) for w, v in got.items()}}
    # the text tower's cost a token position at full width, the figure the
    # bucket planner's cost model keys by device type (SEC_PER_TOKEN)
    if device == "cuda":
        ids = np.ones((batch_size, max_length), np.int64)
        enc = wsi_run._encoder(model, torch.device(device))
        ms = cuda_ms(lambda: enc(ids, ids), runs=5)
        out["full_width_dispatch_ms"] = ms
        out["sec_per_token_measured"] = ms / 1e3 / (batch_size * max_length)

    # ---- the int8 text tower, flat ----------------------------------------
    stack8, s8, calls8, attn8, by_name8, firsts8 = build(model8, None)
    a8 = stack8.cpu().numpy()
    cos8 = (a8 * f).sum(1) / (np.linalg.norm(a8, axis=1)
                              * np.linalg.norm(f, axis=1))
    if not (cos8 >= 0.999).all():
        raise AssertionError(f"int8 classifier vs bf16: {cos8.min()}")
    # the int8 kernels at each width dispatched against their plain
    # versions, at the gate between two int8 routes (text taken whole)
    got8 = encoded(model8, firsts8)
    with plain_int8_blocks():
        want8 = encoded(model8, firsts8)
    route8 = {w: int8_route(got8[w], want8[w]) for w in got8}
    if not all(r["whole_cos"] > 0.9999 for r in route8.values()):
        raise AssertionError(f"int8 text tower vs its plain blocks: {route8}")
    if device == "cuda":
        for k in ("quantized_attention_block_postln", "quantized_mlp_bsd"):
            if by_name8.get(k, 0) != len(calls8) * layers:
                raise AssertionError(f"int8 classifier: {k} {by_name8}")
    out.update(prompts_per_s_int8_flat=n_prompts / s8,
               int8_launches=by_name8, int8_attention_launches=attn8,
               dispatches_int8=len(calls8),
               min_column_cos_int8_vs_bf16=float(cos8.min()),
               int8_vs_plain_blocks_by_width=route8)
    phase("wsi_classifier", **out)
    return {"result": out, "stack": flat}


def _decision(name: str, card_value, cpu_value, near: int, bound: float,
              gates: dict) -> None:
    """A decision of the card against the CPU's on the same inputs: equal,
    or (only where ``near`` patches lie within ``NEAR`` of a threshold)
    apart by no more than those patches can move it (``bound``)."""
    a, b = np.asarray(card_value, np.float64), np.asarray(cpu_value,
                                                          np.float64)
    equal = bool(np.array_equal(a, b))
    diff = float(np.abs(a - b).max()) if a.size else 0.0
    gates[name] = {"equal": equal, "near_threshold": int(near),
                   "abs_diff": diff}
    if not equal and not (near and diff <= bound):
        raise AssertionError(f"{name}: card {card_value} vs CPU {cpu_value}, "
                             f"{near} patches near a threshold")


def _close_pairs(p: np.ndarray, labels: np.ndarray) -> int:
    """Pairs of one positive and one negative patch whose probabilities lie
    within ``NEAR`` of each other: the pairs whose order two summation
    orders may swap, each moving AUROC by 1 / (n_pos · n_neg)."""
    pos = np.sort(p[labels == 1])
    neg = p[labels == 0]
    return int((np.searchsorted(pos, neg + NEAR, "right")
                - np.searchsorted(pos, neg - NEAR, "left")).sum())


def drive_wsi_pipelines(torch, stack, device: str = "cuda",
                        n: int = WSI_PATCHES, grid: int = WSI_GRID) -> dict:
    """Phase 12: the screening and the three pipelines on the card at a
    slide's long axis, each held against the same port functions on the
    CPU with the same inputs (probabilities at 1e-5, the same top-50 set,
    the merged classifier at 1e-5, decisions and heatmap bytes equal with
    near-threshold patches counted), and the card's results the same with
    TF32 on, where without the guard TF32 moves the probabilities and the
    screening's scores (the control)."""
    from keep_tpu_torch.metrics.classification import roc_best_threshold
    from keep_tpu_torch.wsi import pipelines as wp
    from keep_tpu_torch.wsi.grid import CoordGrid
    from keep_tpu_torch.zeroshot import classifier as zc

    stack_cpu = stack.cpu()
    feats, coords, _ = wsi_patches(stack_cpu.numpy(), n, grid)
    seg_coords = coords // (256 // WSI_SEG_PATCH)
    mask = seg_mask(grid, WSI_SEG_PATCH)
    cls4 = torch.stack([stack_cpu[1, :, 1], stack_cpu[2, :, 1],
                        stack_cpu[3, :, 1], stack_cpu[0, :, 0]], 1)

    def run(dev: str, timed: bool) -> tuple[dict, dict]:
        f = torch.from_numpy(feats).to(dev)
        s, c4 = stack_cpu.to(dev), cls4.to(dev)
        out, ms = {}, {}

        def step(name, fn):
            if timed:
                out[name], ms[name] = synced_ms(torch, fn)
            else:
                out[name] = fn()

        step("prompt_select", lambda: zc._prompt_select_jit(s, f, WSI_TOPN))
        merged = out["prompt_select"][0]
        step("random_ensemble", lambda: zc.random_ensemble(s, WSI_TOPN))
        step("score_tiles", lambda: wp.score_tiles(merged, f))
        step("detection", lambda: wp.zero_shot_detection(
            merged, f, coords, patch_size=256, overlap=False))
        step("detection_overlap", lambda: wp.zero_shot_detection(
            merged, f, coords, patch_size=256, overlap=True))
        step("segmentation", lambda: wp.zero_shot_segment(
            merged, f, seg_coords, mask=mask, patch_size=WSI_SEG_PATCH))
        step("subtyping", lambda: wp.zero_shot_subtyping(
            c4, f, coords, patch_size=256))
        step("tumor_heatmap", lambda: wp.tumor_heatmap(
            merged, f, coords, patch_size=256))
        return out, ms

    if device == "cuda":
        run(device, timed=False)  # the first calls pay cuBLAS's setup
    card_out, ms = run(device, timed=device == "cuda")
    cpu_out, _ = run("cpu", timed=False)
    gates: dict = {}

    # the screening: scores, the same top-50 set, the merged classifier
    m_card, s_card, o_card = (t.cpu() for t in card_out["prompt_select"])
    m_cpu, s_cpu, o_cpu = cpu_out["prompt_select"]
    top_same = set(o_card.tolist()) == set(o_cpu.tolist())
    gates["top50_same_set"] = top_same
    gates["top50_same_order"] = bool(torch.equal(o_card, o_cpu))
    gates["scores_max_abs_diff"] = (s_card - s_cpu).abs().max().item()
    gates["merged_max_abs_diff"] = (m_card - m_cpu).abs().max().item()
    gates["random_ensemble_max_abs_diff"] = (
        card_out["random_ensemble"].cpu()
        - cpu_out["random_ensemble"]).abs().max().item()
    if not (top_same and gates["merged_max_abs_diff"] <= 1e-5
            and gates["random_ensemble_max_abs_diff"] <= 1e-5):
        raise AssertionError(f"screening card vs CPU: {gates}")
    probs = card_out["score_tiles"].cpu()
    p_cpu = cpu_out["score_tiles"]
    gates["probs_max_abs_diff"] = (probs - p_cpu).abs().max().item()
    if not gates["probs_max_abs_diff"] <= 1e-5:
        raise AssertionError(f"probabilities card vs CPU: {gates}")
    p1 = p_cpu[:, 1].numpy()
    gates["probs_within_0.05_of_half"] = float((np.abs(p1 - 0.5)
                                                <= 0.05).mean())

    # the decisions, with the patches near their thresholds
    g256 = CoordGrid.from_coords(coords, 256)
    for name, overlap in (("detection", False), ("detection_overlap", True)):
        kept = wp.refined_tumor_probs(m_cpu, torch.from_numpy(feats), g256,
                                      overlap).numpy()
        near = int((np.abs(kept - 0.5) <= NEAR).sum())
        _decision(name, card_out[name], cpu_out[name], near,
                  near / len(kept) + 1e-7, gates)
    gseg = CoordGrid.from_coords(seg_coords, WSI_SEG_PATCH)
    p_seg = wp.refined_tumor_probs(m_cpu, torch.from_numpy(feats), gseg,
                                   True).numpy()
    labels = wp.patch_labels_from_mask(mask, gseg.kept_coords(seg_coords),
                                       WSI_SEG_PATCH)
    _, thd = roc_best_threshold(labels, p_seg)
    pairs = _close_pairs(p_seg, labels)
    n_pairs = float((labels == 1).sum()) * float((labels == 0).sum())
    near_thd = int((np.abs(p_seg - thd) <= NEAR).sum())
    _decision("segmentation_auroc", card_out["segmentation"][0],
              cpu_out["segmentation"][0], pairs, pairs / n_pairs + 1e-12,
              gates)
    # a patch that crosses the threshold repaints k low-resolution pixels
    k = (WSI_SEG_PATCH / 16) ** 2
    painted = (np.count_nonzero(mask[::16, ::16])
               + float((p_seg > thd).sum()) * k)
    _decision("segmentation_dice", card_out["segmentation"][1],
              cpu_out["segmentation"][1], near_thd + pairs,
              4 * k * (near_thd + pairs) / painted, gates)
    from keep_tpu_torch.wsi.grid import refine_grid

    g4, occ = g256.scatter(wp.score_tiles(cls4, torch.from_numpy(feats)))
    refined4 = g256.gather(refine_grid(g4, occ))
    top2 = torch.topk(refined4, 2, -1).values
    near_sub = int(((top2[:, 0] - top2[:, 1]) <= NEAR).sum())
    frac = np.sort(cpu_out["subtyping"][1][:-1])
    label_near = near_sub if frac[-1] - frac[-2] <= 2 * near_sub / len(
        refined4) else 0
    _decision("subtype_label", card_out["subtyping"][0],
              cpu_out["subtyping"][0], label_near, 3.0, gates)
    _decision("subtype_fractions", card_out["subtyping"][1],
              cpu_out["subtyping"][1], near_sub,
              near_sub / len(refined4) + 1e-7, gates)
    hm_card, hm_cpu = card_out["tumor_heatmap"], cpu_out["tumor_heatmap"]
    heat, hocc = wp.probability_heatmap(m_cpu, torch.from_numpy(feats),
                                        coords, patch_size=256)
    v = np.clip(heat[hocc > 0], 0.0, 1.0) * 255.0
    near_hm = int((np.abs(v - np.floor(v) - 0.5) <= 255 * NEAR).sum())
    differing = int((hm_card != hm_cpu).sum())
    gates["heatmap"] = {"shape": list(hm_card.shape),
                        "equal": bool(np.array_equal(hm_card, hm_cpu)),
                        "near_rounding": near_hm,
                        "differing_pixels": differing}
    cell = 256 // 16  # pixels a side of one patch's cell
    if differing > near_hm * cell * cell:
        raise AssertionError(f"heatmap card vs CPU: {gates['heatmap']}")

    # TF32 on: the card gives the same results; the control: without the
    # guard TF32 moves the probabilities and the screening's scores
    f_dev, s_dev = torch.from_numpy(feats).to(device), stack_cpu.to(device)
    with tf32_on(torch):
        tf32_out, _ = run(device, timed=False)
        with unguarded_fp32():
            loose = {"score_tiles": wp.score_tiles(m_card.to(device), f_dev),
                     "screening_scores": zc._prompt_select_jit(
                         s_dev, f_dev, WSI_TOPN)[1]}
    control = {"score_tiles": (loose["score_tiles"]
                               != card_out["score_tiles"]).float().mean().item(),
               "screening_scores": (loose["screening_scores"]
                                    != card_out["prompt_select"][1]
                                    ).float().mean().item()}
    del f_dev, s_dev, loose
    if device == "cuda" and not all(v > 0 for v in control.values()):
        raise AssertionError(f"TF32 control: without the guard TF32 moved "
                             f"nothing, so the gate cannot see it: {control}")
    same = {}
    for k, v in card_out.items():
        w = tf32_out[k]
        if isinstance(v, tuple) and isinstance(v[0], torch.Tensor):
            same[k] = all(torch.equal(a, b) for a, b in zip(v, w))
        elif isinstance(v, torch.Tensor):
            same[k] = bool(torch.equal(v, w))
        elif isinstance(v, tuple):
            same[k] = all(np.array_equal(a, b) for a, b in zip(v, w))
        else:
            same[k] = bool(np.array_equal(v, w))
    if not all(same.values()):
        raise AssertionError(f"TF32 on changed: {same}")
    out = {"patches": n, "grid": [grid, grid], "topn": WSI_TOPN,
           "seg_patch_px": WSI_SEG_PATCH, "seg_mask_px": int(mask.shape[0]),
           "tumor_prob": card_out["detection"],
           "tumor_prob_overlap": card_out["detection_overlap"],
           "auroc_dice": list(card_out["segmentation"]),
           "subtype": [card_out["subtyping"][0],
                       card_out["subtyping"][1].tolist()],
           "gates": gates, "same_with_tf32_on": same,
           "tf32_unguarded_share_moved": control, "ms": ms}
    if device == "cuda":
        out["ms_total"] = sum(ms.values())
        out["card"] = card()
    phase("wsi_pipelines", **out)
    return out


def drive_wsi(torch, fa, d: str, device: str = "cuda", **sizes) -> dict:
    """Phases 10–12 on the model in ``d``. ``sizes`` shrink them for a
    rehearsal on the CPU (``slide_px``, ``batch_size``, ``n_prompts``,
    ``n``, ``grid``)."""
    ext = drive_wsi_extract(torch, fa, d, device, **{
        k: sizes[k] for k in ("slide_px", "batch_size") if k in sizes})
    cls = drive_wsi_classifier(
        torch, fa, ext["model"], ext["model8"], ext["tokenizer"], device,
        **{k: sizes[k] for k in ("n_prompts",) if k in sizes})
    del ext["model"], ext["model8"]
    if device == "cuda":
        torch.cuda.empty_cache()
    pipes = drive_wsi_pipelines(torch, cls["stack"], device, **{
        k: sizes[k] for k in ("n", "grid") if k in sizes})
    return {"extract": ext["result"], "classifier": cls["result"],
            "pipelines": pipes}


CALIB_TILES = 32     # wsi.run's default --int8-calib
CALIB_PROMPTS = 64
CALIB_EVAL_PROMPTS = 256
OUTLIERS = 4         # channels, as tests/test_quant.py's _outlier_params
OUTLIER_GAIN = 80.0  # the ViT's, as there
TEXT_OUTLIER_GAIN = 6.0   # scripts/torch_calibration_sweep.py
PYRAMID_DOWNSAMPLES = (4, 16)
CASCADE_MARGIN = 0.15


def inject_outliers(torch, model, n: int = OUTLIERS,
                    gain: float = OUTLIER_GAIN,
                    text_gain: float = TEXT_OUTLIER_GAIN) -> None:
    """``n`` outlier channels (0 … n−1) on every LayerNorm whose output a
    quantized qkv or fc1 reads, as tests/test_quant.py's
    ``_outlier_params`` / ``_outlier_bert`` build them: the gain on the
    LayerNorm's scale (and, in the ViT, its bias), the reading weight's
    input columns divided by it. In the pre-LN ViT this is an identity; in
    the post-LN BERT the LayerNorm's output is the stream itself, so it
    makes another model, whose own bf16 forward is the reference, and whose
    features the outlier channels come to dominate as the gain grows: on
    the random draw no BERT gain from 4 to 24 brings the plain W8A8 text
    below 0.999 with the calibrated one above it, and from 8 up neither
    reaches 0.999 (``scripts/torch_calibration_sweep.py``), hence the
    BERT's smaller gain. The weights change in their fp32 sources
    (``ops.nn.Linear.set_source``)."""
    ch = slice(0, n)

    def shrink(lin, g):
        w = lin.quantize_source().float().clone()
        w[:, ch] /= g
        lin.set_source(w)

    with torch.no_grad():
        for blk in model.visual.blocks:
            for norm, lin in ((blk.norm1, blk.attn.qkv),
                              (blk.norm2, blk.mlp.fc1)):
                norm.weight[ch] *= gain
                norm.bias[ch] *= gain
                shrink(lin, gain)
        model.text.embeddings.norm.weight[ch] *= text_gain
        for blk in model.text.blocks:
            blk.attn.norm.weight[ch] *= text_gain
            blk.norm.weight[ch] *= text_gain
            shrink(blk.attn.qkv, text_gain)
            shrink(blk.mlp.fc1, text_gain)


def capture_inputs(torch, modules: dict, fn) -> dict:
    """The tensor arguments each of ``modules`` ({key: module}) was first
    called with while ``fn`` ran."""
    seen: dict = {}

    def grab(key):
        def hook(_mod, args):
            seen.setdefault(key, tuple(a.detach() for a in args
                                       if isinstance(a, torch.Tensor)))
        return hook

    handles = [m.register_forward_pre_hook(grab(k))
               for k, m in modules.items()]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return seen


def hold_int8(torch, name: str, shape: str, fn, ref, args, kw,
              atol: float | None = None, rtol: float | None = None,
              residual=None) -> dict:
    """One int8 kernel of a path against its plain version on the same
    inputs: bit for bit where ``atol`` is None (the GEMMs and row passes
    compose bit-exact kernels), else at atol / rtol with cosine ≥ 0.9999
    per row (the attention sub-blocks). With ``residual`` (the block's
    input x) the update, output − x, is also held at cosine ≥ 0.9999 per
    row: a sum whose stream outweighs its update hides a wrong one."""
    got = fn(*args, **kw)
    want = ref(*args, **kw)
    if residual is not None:
        x = residual.float().reshape(-1, got.shape[-1])
        upd = torch.nn.functional.cosine_similarity(
            got.float().reshape(-1, got.shape[-1]) - x,
            want.float().reshape(-1, got.shape[-1]) - x, dim=-1).min().item()
        if not upd >= 0.9999:
            raise AssertionError(f"{name} ({shape}) vs plain: the update's "
                                 f"min row cosine {upd}")
    err = (got.float() - want.float()).abs().max().item()
    row = {"name": name, "shape": shape, "max_abs_err": err,
           "bit_equal": bool(torch.equal(got, want))}
    if atol is None:
        if not row["bit_equal"]:
            raise AssertionError(f"{name} ({shape}) vs plain: not bit for "
                                 f"bit, max |Δ| {err}")
        return row
    g, w = got.float().reshape(-1, got.shape[-1]), want.float().reshape(
        -1, got.shape[-1])
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1).min().item()
    row.update(atol=atol, rtol=rtol, min_row_cos=cos)
    if residual is not None:
        row["min_row_cos_update"] = upd
    if not (torch.allclose(g, w, atol=atol, rtol=rtol) and cos >= 0.9999):
        raise AssertionError(f"{name} ({shape}) vs plain: max |Δ| {err}, "
                             f"min row cosine {cos}")
    return row


def drive_int8_calibrated(torch, fa, d: str, device: str = "cuda",
                          slide_px: int = WSI_SLIDE_PX, crop_px: int = 4096,
                          batch_size: int = WSI_BATCH,
                          max_length: int = 256,
                          text_gain: float = TEXT_OUTLIER_GAIN,
                          route_control: int = 0) -> dict:
    """Phase 15: ``KEEPModel.quantize(calib_pixels, calib_text)`` on the
    model in ``d`` (the seeded random draw, whose blocks all move the
    stream) with ``OUTLIERS`` outlier channels per LayerNorm
    (``inject_outliers``), calibrated on ``CALIB_TILES`` seeded tiles of the
    middle ``crop_px``² of phase 10's slide (the bicubic 256 → 224, as
    ``wsi.run`` calibrates) and ``CALIB_PROMPTS`` seeded prompts. The main
    path: one batch of tiles through ``extract_features`` and
    ``CALIB_EVAL_PROMPTS`` prompts through the text tower, both int8.
    Gates: the launches per block and batch (#1's inside the sub-blocks
    too); the calibrated features at cosine ≥ 0.999 per row against the
    same model in bf16, and the plain W8A8 ViT's below 0.999 (its outliers
    are an identity that costs it accuracy; the BERT's plain W8A8 is
    printed); against the same calibrated model with plain blocks, image
    rows at cosine ≥ 0.999 and text taken whole > 0.9999
    (tests/test_quant.py:327's form); and, on the inputs the
    path gave them (captured from its first and last blocks), #4 (its sum
    and its update) and #5 (with the smoothed qkv's ``pre_scale``) at atol
    = rtol = 2e-2 and cosine ≥ 0.9999 per row, #6 (ViT; BERT with
    ``pre_scale1``), #8 and #9 bit for bit, against their plain versions
    at the smoothed weights. ``route_control`` > 0 also runs that many
    tiles through the calibrated model's plain blocks on the host."""
    import argparse
    import copy

    from keep_tpu_torch.io.tiles import cut_tiles
    from keep_tpu_torch.kernels import qblock, qmatmul, qmlp
    from keep_tpu_torch.ops.preprocess import preprocess
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.wsi.extract import extract_features

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    c, r = slide_px // 2, min(crop_px, slide_px) // 2
    tiles, _ = cut_tiles(wsi_slide(slide_px)[c - r: c + r, c - r: c + r],
                         patch_size=256)
    rng = np.random.default_rng(15)
    tiles = tiles[rng.permutation(len(tiles))]
    calib_tiles, tiles = tiles[:CALIB_TILES], tiles[CALIB_TILES:]
    tiles = tiles[:batch_size]
    model, tokenizer = wsi_run.load_model(argparse.Namespace(
        model=d, device=device, int8=False))
    inject_outliers(torch, model, text_gain=text_gain)
    enc = wsi_run._encoder
    texts = [p["classnames"][c] for p in wsi_prompts(
        (CALIB_PROMPTS + CALIB_EVAL_PROMPTS) // 2, seed=15).values()
        for c in ("Normal", "Tumor")]
    tok = tokenizer(texts, max_length=max_length)
    ids, mask = tok["input_ids"], tok["attention_mask"]
    calib_px = preprocess(torch.from_numpy(calib_tiles).to(device))
    calib_text = (torch.from_numpy(ids[:CALIB_PROMPTS]).long().to(device),
                  torch.from_numpy(mask[:CALIB_PROMPTS]).long().to(device))
    ids, mask = ids[CALIB_PROMPTS:], mask[CALIB_PROMPTS:]

    sync()
    t0 = time.perf_counter()
    model8 = model.quantize(calib_pixels=calib_px, calib_text=calib_text)
    sync()
    calib_s = time.perf_counter() - t0
    plain8 = model.quantize()
    for blk in model8.text.blocks:
        if blk.attn.qkv.pre_scale is None or blk.mlp.fc1.pre_scale is None:
            raise AssertionError("calibrated BERT without a pre_scale")

    def image(m):
        return extract_features(m, tiles, batch_size=batch_size, resize=True)

    def text(m):
        return enc(m, torch.device(device))(ids, mask).float().cpu().numpy()

    image(model8)  # the first call pays the setup
    sync()
    reset_launches(fa)
    # ---- the main path, image ----------------------------------------------
    feats8 = image(model8)
    img_attn, img_launches = read_launches(fa)
    # ------------------------------------------------------------------------
    sync()
    reset_launches(fa)
    # ---- the main path, text -------------------------------------------------
    text8 = text(model8)
    txt_attn, txt_launches = read_launches(fa)
    # ------------------------------------------------------------------------
    depth = model.cfg.vision.depth
    layers = model.cfg.text.num_hidden_layers
    batches = -(-len(tiles) // batch_size)
    # the int8 sub-blocks run their attention through #1's wrapper, which
    # counts it in ``fa.LAUNCHES``
    want = ({"attention_qkv_slab": batches * depth,
             "quantized_attention_block": batches * depth,
             "quantized_mlp_bsd": batches * depth,
             "quantized_matmul_bsd": batches,
             "quantized_matmul": 2 * batches},
            {"attention_qkv_slab": layers,
             "quantized_attention_block_postln": layers,
             "quantized_mlp_bsd": layers})
    if device == "cuda":
        for got, w in zip(({**img_launches, "attention_qkv_slab": img_attn},
                           {**txt_launches, "attention_qkv_slab": txt_attn}),
                          want):
            for k, v in w.items():
                if got.get(k, 0) != v:
                    raise AssertionError(f"calibrated path: {k} {got.get(k)} "
                                         f"launches, want {v}")
    launches = {k: img_launches.get(k, 0) + txt_launches.get(k, 0)
                for k in set(img_launches) | set(txt_launches)}

    feats, txt = image(model), text(model)
    featsp, txtp = image(plain8), text(plain8)
    cos = {"image_calibrated": cosine_rows(feats8, feats),
           "text_calibrated": cosine_rows(text8, txt),
           "image_plain_w8a8": cosine_rows(featsp, feats),
           "text_plain_w8a8": cosine_rows(txtp, txt)}
    # the ViT's outliers are an identity, so its plain W8A8 must lose
    # accuracy and the calibrated model win it back; the BERT's sit in the
    # stream they come to dominate, and its plain W8A8 is printed beside
    cal = {k: float(cos[f"{k}_calibrated"].min()) for k in ("image", "text")}
    plain_img = float(cos["image_plain_w8a8"].min())
    if not (plain_img < 0.999 <= cal["image"] and cal["text"] >= 0.999):
        raise AssertionError(
            f"int8 vs bf16: calibrated {cal}, plain W8A8 image {plain_img}; "
            f"want plain < 0.999 <= calibrated; (min, mean) row cosines "
            f"{ {n: (float(v.min()), float(v.mean())) for n, v in cos.items()} }")
    with plain_int8_blocks():
        route = {"image": int8_route(feats8, image(model8)),
                 "text": int8_route(text8, text(model8))}
    # through 24 blocks that all move the stream, the ViT's int8 route
    # carries a rounding difference from block to block (a code moved by
    # one in the next quantize): its rows are held at the repo's int8 gate,
    # each block's kernels against their plain versions below
    if not (route["image"]["min_row_cos"] >= 0.999
            and route["text"]["whole_cos"] > 0.9999):
        raise AssertionError(f"calibrated int8 vs its plain blocks: {route}")
    if route_control:
        # the same plain route on the host: how far rounding alone moves it
        px = preprocess(torch.from_numpy(tiles[:route_control]).to(device))
        with torch.inference_mode():
            with plain_int8_blocks():
                on_card = model8.encode_image(px).float().cpu().numpy()
            host = copy.deepcopy(model8).to("cpu")
            on_host = host.encode_image(px.cpu()).float().numpy()
        del host
        route["image_plain_card_vs_host"] = int8_route(on_card, on_host)
        route["image_kernels_vs_host_plain"] = int8_route(
            feats8[:route_control], on_host)

    # the kernels against their plain versions at the smoothed weights, on
    # the inputs the path gave them (comparison launches, not counted)
    vit, bert, vcfg, tcfg = (model8.visual, model8.text, model8.cfg.vision,
                             model8.cfg.text)
    with torch.inference_mode():
        seen = capture_inputs(torch, {
            "vit0": vit.blocks[0], "vit_last": vit.blocks[-1],
            "patch_embed": vit.patch_embed,
            "head_fc1": model8.visual_head.fc1},
            lambda: image(model8))
        seen.update(capture_inputs(torch, {
            "bert0": bert.blocks[0], "bert_last": bert.blocks[-1]},
            lambda: text(model8)))
        held = []
        for key, blk in (("vit0", vit.blocks[0]), ("vit_last", vit.blocks[-1])):
            (x,) = seen[key]
            shape = f"{key} {tuple(x.shape)}"
            akw = dict(num_heads=vcfg.num_heads, eps=vcfg.ln_eps)
            args = (x, blk.norm1, blk.attn.qkv, blk.attn.proj)
            held.append(hold_int8(
                torch, "quantized_attention_block", shape,
                qblock.quantized_attention_block,
                qblock.quantized_attention_block_reference, args, akw,
                2e-2, 2e-2, residual=x))
            mid = qblock.quantized_attention_block_reference(*args, **akw)
            m = blk.mlp
            held.append(hold_int8(
                torch, "quantized_mlp_bsd", shape + " LN + residual",
                qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
                (mid, m.fc1.weight_q, m.fc1.weight_scale, m.fc1.bias,
                 m.fc2.weight_q, m.fc2.weight_scale, m.fc2.bias),
                dict(out_dtype=mid.dtype, ln_scale=blk.norm2.weight,
                     ln_bias=blk.norm2.bias, eps=vcfg.ln_eps,
                     residual=True)))
        for key, blk in (("bert0", bert.blocks[0]),
                         ("bert_last", bert.blocks[-1])):
            x, kb = seen[key]
            shape = f"{key} {tuple(x.shape)}"
            akw = dict(num_heads=tcfg.num_attention_heads, eps=tcfg.ln_eps)
            args = (x, kb, blk.attn.norm, blk.attn.qkv, blk.attn.out)
            held.append(hold_int8(
                torch, "quantized_attention_block_postln",
                shape + " pre_scale",
                qblock.quantized_attention_block_postln,
                qblock.quantized_attention_block_postln_reference, args, akw,
                2e-2, 2e-2))
            mid = qblock.quantized_attention_block_postln_reference(*args,
                                                                    **akw)
            m = blk.mlp
            held.append(hold_int8(
                torch, "quantized_mlp_bsd", shape + " post-LN + pre_scale1",
                qmlp.quantized_mlp_bsd, qmlp.quantized_mlp_bsd_reference,
                (mid, m.fc1.weight_q, m.fc1.weight_scale, m.fc1.bias,
                 m.fc2.weight_q, m.fc2.weight_scale, m.fc2.bias),
                dict(out_dtype=mid.dtype, ln_scale=blk.norm.weight,
                     ln_bias=blk.norm.bias, eps=tcfg.ln_eps, post_ln=True,
                     pre_scale1=m.fc1.pre_scale)))
        pe, fc1 = vit.patch_embed, model8.visual_head.fc1
        (x,) = seen["patch_embed"]
        held.append(hold_int8(
            torch, "quantized_matmul_bsd", f"patch embed {tuple(x.shape)}",
            qmatmul.quantized_matmul_bsd,
            qmatmul.quantized_matmul_bsd_reference,
            (x, pe.weight_q, pe.weight_scale, pe.bias),
            dict(out_dtype=x.dtype)))
        (x,) = seen["head_fc1"]
        held.append(hold_int8(
            torch, "quantized_matmul", f"visual head fc1 {tuple(x.shape)}",
            qmatmul.quantized_matmul, qmatmul.quantized_matmul_reference,
            (x, fc1.weight_q, fc1.weight_scale, fc1.bias),
            dict(out_dtype=x.dtype)))

    out = {"calibration_s": calib_s, "calib_tiles": len(calib_tiles),
           "calib_prompts": CALIB_PROMPTS, "weights": "random draw",
           "outlier_channels": OUTLIERS, "outlier_gain": OUTLIER_GAIN,
           "text_outlier_gain": text_gain,
           "eval_tiles": len(tiles), "eval_prompts": len(ids),
           "launches": launches, "image_launches": img_launches,
           "text_launches": txt_launches,
           "attention_launches": {"image": img_attn, "text": txt_attn},
           "min_cos_vs_bf16": {k: float(v.min()) for k, v in cos.items()},
           "mean_cos_vs_bf16": {k: float(v.mean()) for k, v in cos.items()},
           "vs_plain_blocks": route, "held_vs_plain": held}
    if device == "cuda":
        out["card"] = card()
    phase("int8_calibrated", **out)
    return out


def spread_classifier(base: np.ndarray, coarse: np.ndarray,
                      margin: float) -> np.ndarray:
    """``base`` [D, 2] (Normal, Tumor) with a term added to its Tumor column
    along the first principal direction of the coarse tiles' features
    ``coarse`` [n, D] (orthogonal to their mean), scaled and centred so
    that about half the coarse tiles' tumour probabilities (softmax·10)
    fall within ``margin`` of 0.5 and the rest outside, on either side:
    keep.init's near-constant features would otherwise put every tile
    within any margin. float32."""
    f = coarse.astype(np.float64)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    mean = f.mean(0)
    m = mean / np.linalg.norm(mean)
    u = np.linalg.svd(f - mean, full_matrices=False)[2][0]
    u -= (u @ m) * m
    u /= np.linalg.norm(u)
    t = f @ u
    # logit(p) = 10·f·(Tumor − Normal); |p − 0.5| <= margin at |logit| <= l
    half = np.log((0.5 + margin) / (0.5 - margin)) / 10.0
    a = half / np.median(np.abs(t - np.median(t)))
    z = f @ (base[:, 1] - base[:, 0]).astype(np.float64) + a * t
    w = a * u - np.median(z) / (f @ m).mean() * m
    out = base.astype(np.float64)
    out[:, 1] += w
    return out.astype(np.float32)


def write_pil_pyramid(path: str, level0: np.ndarray,
                      downsamples=PYRAMID_DOWNSAMPLES) -> list:
    """``level0`` and its box-filtered ``downsamples`` as a multi-page
    stripped TIFF written by PIL (a pyramid both ``io.wsi`` backends read).
    Returns the levels' (width, height)."""
    from PIL import Image

    base = Image.fromarray(level0)
    h, w = level0.shape[:2]
    levels = [base.resize((w // ds, h // ds), Image.Resampling.BOX)
              for ds in downsamples]
    base.save(path, save_all=True, append_images=levels)
    return [(w, h)] + [im.size for im in levels]


def native_probe() -> dict:
    """``scripts/torch_native_probe.sh``'s answer on this host: whether the
    compiler finds each header the native reader is built with, and
    whether its trial build of the library succeeded."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "torch_native_probe.sh")
    lines = subprocess.run(["bash", script], capture_output=True, text=True,
                           timeout=600).stdout.splitlines()
    return {"headers": {ln.split()[1]: ln.startswith("HEADER_OK")
                        for ln in lines
                        if ln.startswith(("HEADER_OK", "HEADER_MISSING"))},
            "build_ok": "BUILD_RC=0" in lines}


def drive_wsi_pyramid(torch, fa, d: str, device: str = "cuda",
                      slide_px: int = WSI_SLIDE_PX,
                      batch_size: int = WSI_BATCH) -> dict:
    """Phase 16: phase 10's synthetic slide as a pyramid (level 0 and its
    4× and 16× levels, a multi-page TIFF written by PIL) → ``io.wsi.
    open_slide`` → ``io.tiles.iter_wsi_tiles`` → ``extract_features(resize=
    True)``, bf16 and then ``--int8`` at ``--int8-calib 32`` (calibrated on
    the pyramid's first 32 tiles, as ``wsi.run`` calibrates on one); then
    ``wsi.cascade.cascade_detect`` at margin 0.5 (its decisions equal to
    the plain sweep's on the same features, tiles within ``NEAR`` of the
    threshold counted) and at ``CASCADE_MARGIN``, with the prompts'
    classifier spread along the coarse tiles' variation
    (``spread_classifier``). The reader's backend must be the one
    ``scripts/torch_native_probe.sh`` allows (native where its trial build
    of the library succeeds, else PIL, as ``open_slide`` routes); the route
    ``wsi.run`` takes for the file is printed. Gates: the levels as
    written, the launches per block and batch (#1's inside the int8
    sub-blocks too), the int8 features at cosine ≥ 0.999 per row against
    bf16 on the same tiles; at ``CASCADE_MARGIN`` some but not all tiles
    refined, the refined ones at the margin-0.5 run's probabilities and
    the others at their parent's coarse call (1e-6 each). Prints tiles/s
    and the host's read time (thumbnail and regions) of each pass."""
    import argparse

    from keep_tpu_torch.io import wsi as wsi_io
    from keep_tpu_torch.io.tiles import iter_wsi_tiles
    from keep_tpu_torch.io.wsi import open_slide
    from keep_tpu_torch.ops.preprocess import preprocess
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.wsi.cascade import cascade_detect
    from keep_tpu_torch.wsi.extract import extract_features
    from keep_tpu_torch.wsi.pipelines import score_tiles
    from keep_tpu_torch.zeroshot import build_classifiers_batched

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    probe = native_probe()
    want_backend = "native" if probe["build_ok"] else "pil"
    out = {"native_probe": probe}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slide.tif")
        t0 = time.perf_counter()
        dims = write_pil_pyramid(path, wsi_slide(slide_px))
        out["write_s"] = time.perf_counter() - t0
        route = wsi_run._try_open_pyramid(path)
        out["wsi_run_route"] = ("native pyramid" if route is not None
                                else "flat image (PIL)")
        if route is not None:
            route.close()
        args = argparse.Namespace(model=d, device=device, int8=False)
        model, tokenizer = wsi_run.load_model(args)
        depth = model.cfg.vision.depth
        with open_slide(path) as reader:
            backend = getattr(reader, "backend", type(reader).__name__)
            # why the native library did not load, in the compiler's words
            lines = wsi_io._lib_error.strip().splitlines()
            out["native_library"] = (
                "loaded" if wsi_io._lib is not None else next(
                    (ln for ln in lines if "error" in ln),
                    lines[-1] if lines else "not tried")[:200])
            if backend != want_backend:
                raise AssertionError(f"pyramid read by {backend}, the "
                                     f"host's probe {probe} says "
                                     f"{want_backend}")
            if reader.level_dimensions != dims:
                raise AssertionError(f"levels {reader.level_dimensions}, "
                                     f"written {dims}")
            read_s = 0.0

            def chunks(level=0, chunk=batch_size):
                nonlocal read_s
                it = iter_wsi_tiles(reader, patch_size=256,
                                    tissue_fraction=0.25, chunk=chunk,
                                    level=level)
                while True:
                    t = time.perf_counter()
                    nxt = next(it, None)
                    read_s += time.perf_counter() - t
                    if nxt is None:
                        return
                    yield nxt

            coords = []

            def tiles_of():
                for t, c in chunks():
                    coords.append(c)
                    yield t

            extract_features(model, next(chunks())[0][:batch_size],
                             batch_size=batch_size, resize=True)
            sync()
            read_s = 0.0
            reset_launches(fa)
            # ---- the main path: bf16 extraction off the pyramid ------------
            t0 = time.perf_counter()
            feats = extract_features(model, tiles_of(), batch_size=batch_size,
                                     resize=True)
            wall = time.perf_counter() - t0
            launches, _ = read_launches(fa)
            # ----------------------------------------------------------------
            coords0 = np.concatenate(coords)
            n = len(coords0)
            batches = -(-n // batch_size)
            if device == "cuda" and launches != batches * depth:
                raise AssertionError(f"pyramid extract: {launches} attention "
                                     f"launches, want {batches * depth}")
            check_features("pyramid extract", feats, n,
                           model.cfg.projection_dim)
            out.update(backend=backend, levels=dims, tiles=n,
                       tiles_per_s_bf16=n / wall, wall_s_bf16=wall,
                       host_read_s_bf16=read_s, attention_launches=launches)

            # --int8 at --int8-calib 32: the pyramid's first 32 tiles
            first = next(chunks(chunk=CALIB_TILES))[0]
            t0 = time.perf_counter()
            model8, _ = wsi_run.load_model(
                argparse.Namespace(model=d, device=device, int8=True),
                calib_pixels=preprocess(torch.from_numpy(first).to(device)))
            sync()
            out["int8_load_and_calibration_s"] = time.perf_counter() - t0
            extract_features(model8, first, batch_size=batch_size, resize=True)
            sync()
            read_s = 0.0
            coords = []
            reset_launches(fa)
            # ---- the main path: calibrated int8 extraction -----------------
            t0 = time.perf_counter()
            feats8 = extract_features(model8, tiles_of(),
                                      batch_size=batch_size, resize=True)
            wall8 = time.perf_counter() - t0
            attn8, launches8 = read_launches(fa)
            # ----------------------------------------------------------------
            want8 = {"attention_qkv_slab": batches * depth,
                     "quantized_attention_block": batches * depth,
                     "quantized_mlp_bsd": batches * depth,
                     "quantized_matmul_bsd": batches,
                     "quantized_matmul": 2 * batches}
            if device == "cuda":
                got8 = {**launches8, "attention_qkv_slab": attn8}
                for k, v in want8.items():
                    if got8.get(k, 0) != v:
                        raise AssertionError(f"pyramid int8: {k} "
                                             f"{got8.get(k)}, want {v}")
            if not np.array_equal(np.concatenate(coords), coords0):
                raise AssertionError("pyramid int8: other tiles than bf16's")
            cos8 = cosine_rows(feats8, feats)
            if not (cos8 >= 0.999).all():
                raise AssertionError(f"pyramid int8 vs bf16: {cos8.min()}")
            out.update(tiles_per_s_int8=n / wall8, wall_s_int8=wall8,
                       host_read_s_int8=read_s, int8_launches=launches8,
                       int8_attention_launches=attn8,
                       min_cos_int8_vs_bf16=float(cos8.min()))
            del model8

            # the cascade: a classifier from a few seeded prompts, spread
            # along the coarse tiles' own variation (``spread_classifier``)
            stack = build_classifiers_batched(
                wsi_run._encoder(model, torch.device(device)), tokenizer,
                wsi_prompts(16, seed=16), {"Normal": 0, "Tumor": 1},
                max_length=64, batch_size=16, device=device)
            base = stack.mean(0)
            base = base / base.norm(dim=0, keepdim=True)
            level = reader.best_level_for_downsample(4)
            span = int(round(reader.level_downsamples[level])) * 256
            parents, inverse = np.unique(coords0 // span, axis=0,
                                         return_inverse=True)
            parents = parents * span
            coarse = extract_features(model, (
                reader.read_regions(parents[i:i + batch_size], level,
                                    (256, 256))
                for i in range(0, len(parents), batch_size)),
                batch_size=batch_size, resize=True)
            classifier = torch.from_numpy(spread_classifier(
                base.cpu().numpy(), coarse, CASCADE_MARGIN)).to(device)
            probs = score_tiles(classifier, torch.from_numpy(feats).to(
                device)).cpu().numpy()
            coarse_probs = score_tiles(classifier, torch.from_numpy(
                coarse).to(device)).cpu().numpy()
            casc, results = {}, {}
            for margin in (0.5, CASCADE_MARGIN):
                sync()
                reset_launches(fa)
                # ---- the main path: the cascade ---------------------------
                t0 = time.perf_counter()
                res = cascade_detect(
                    model, reader, classifier, patch_size=256,
                    coarse_downsample=4, margin=margin,
                    batch_size=batch_size, resize=True)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                c_launches, _ = read_launches(fa)
                # ------------------------------------------------------------
                enc_batches = (-(-res.n_coarse // batch_size)
                               + -(-res.n_fine_encoded // batch_size))
                if device == "cuda" and c_launches != enc_batches * depth:
                    raise AssertionError(f"cascade {margin}: {c_launches} "
                                         f"attention launches")
                casc[str(margin)] = {
                    "ms": ms, "n_coarse": res.n_coarse,
                    "n_fine_encoded": res.n_fine_encoded,
                    "n_fine_total": res.n_fine_total,
                    "encode_fraction": res.encode_fraction,
                    "coarse_level": res.coarse_level,
                    "downsample": res.downsample,
                    "tumor_prob": res.tumor_prob,
                    "attention_launches": c_launches}
                if margin >= 0.5:
                    if not (np.array_equal(res.coords, coords0)
                            and res.refined.all()):
                        raise AssertionError("cascade 0.5: not the plain "
                                             "sweep's grid")
                    near = np.abs(probs[:, 1] - 0.5) <= NEAR
                    moved = ((res.probs[:, 1] > 0.5)
                             != (probs[:, 1] > 0.5)) & ~near
                    if moved.any():
                        raise AssertionError(f"cascade 0.5: {moved.sum()} "
                                             f"decisions differ from the "
                                             f"plain sweep's")
                    casc[str(margin)].update(
                        near_threshold=int(near.sum()),
                        max_abs_err_vs_plain_sweep=float(
                            np.abs(res.probs - probs).max()),
                        plain_sweep_tumor_prob=float(
                            (probs[:, 1] > 0.5).mean()))
                results[margin] = res
            # the partial path: some parents refine, the others keep their
            # coarse call; a refined tile's probability is the full sweep's
            full, part = results[0.5], results[CASCADE_MARGIN]
            r = part.refined
            if not 0 < part.n_fine_encoded < part.n_fine_total:
                raise AssertionError(f"cascade {CASCADE_MARGIN}: "
                                     f"{part.n_fine_encoded} of "
                                     f"{part.n_fine_total} tiles refined")
            if not np.array_equal(part.coords, full.coords):
                raise AssertionError("cascade: the margins' grids differ")
            fine_err = float(np.abs(part.probs[r] - full.probs[r]).max())
            kept_err = float(np.abs(part.probs[~r]
                                    - coarse_probs[inverse][~r]).max())
            if not (fine_err <= 1e-6 and kept_err <= 1e-6):
                raise AssertionError(f"cascade {CASCADE_MARGIN}: refined "
                                     f"tiles {fine_err} from the full "
                                     f"sweep's, kept ones {kept_err} from "
                                     f"their parent's coarse call")
            casc[str(CASCADE_MARGIN)].update(
                max_abs_err_refined_vs_margin_0_5=fine_err,
                max_abs_err_kept_vs_coarse_call=kept_err,
                coarse_refined=int((np.abs(coarse_probs[:, 1] - 0.5)
                                    <= CASCADE_MARGIN).sum()))
            out["cascade"] = casc
    if device == "cuda":
        out["card"] = card()
    phase("wsi_pyramid", **out)
    return out


def kernel_ms(torch, prof) -> dict[str, float]:
    """Device ms by kernel name (first 80 characters) of a torch.profiler
    trace."""
    by_kernel = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        key = ev.key[:80]  # names that share 80 characters add up
        by_kernel[key] = (by_kernel.get(key, 0.0)
                          + ev.self_device_time_total / 1e3)
    return by_kernel


def served_rate(fn, items: int, calls: int = 6, callers: int = 2) -> float:
    """Items a second through a server core's ``fn`` (``items`` a call),
    ``callers`` threads at a time so that double buffering works, after
    one warm call."""
    fn()  # warm
    errors = []

    def caller():
        try:
            for _ in range(calls // callers):
                fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=caller) for _ in range(callers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return items * calls / (time.perf_counter() - t0)


def throughput(torch, core, rng, int8: bool = False) -> dict:
    """Serving throughput at bucket 128 through the server core (queue, H2D,
    dispatch, fetch), two callers at a time so that double buffering works,
    plus a device-time breakdown of one bucket-128 image dispatch. For the
    bf16 server (phase 5) the dispatches are also timed with plain attention
    on the same weights; for the int8 server (phase 7) the breakdown is also
    summed by kernel family."""
    tiles = rng.integers(0, 256, (128, 224, 224, 3), dtype=np.uint8)
    texts = [PROMPTS[i % 3] for i in range(128)]
    img_rate = served_rate(lambda: core.encode_image(tiles), 128)
    txt_rate = served_rate(lambda: core.encode_text(texts), 128)

    # device time of one bucket-128 dispatch of each tower, with the kernel
    # and with plain attention (same weights), and the image dispatch's
    # device time by kernel
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.ops.preprocess import normalize_only

    model = core.model
    models = [("int8", model)] if int8 else [("kernel", model)]
    if not int8:
        plain = KEEPModel(model.cfg, dtype=model.dtype, use_flash=False,
                          device="cuda")
        plain.load_state_dict(model.state_dict())
        models.append(("plain", plain))
    px = torch.from_numpy(tiles).cuda()
    ids = torch.zeros(128, 256, dtype=torch.long, device="cuda")
    mask = torch.ones_like(ids)
    dev_ms = {}
    with torch.inference_mode():
        for tag, m in models:
            suffix = tag if int8 else f"{tag}_attention"
            dev_ms[f"image_b128_{suffix}"] = cuda_ms(
                lambda: m.encode_image(normalize_only(px)), runs=10)
            dev_ms[f"text_b128x256_{suffix}"] = cuda_ms(
                lambda: m.encode_text(ids, mask), runs=10)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.encode_image(normalize_only(px))
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as text_prof:
            model.encode_text(ids, mask)
            torch.cuda.synchronize()
    from scripts.torch_dispatch_profile import by_family

    by_kernel = kernel_ms(torch, prof)
    total = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    attn = sum(v for k, v in by_kernel.items() if "slab_attention" in k)
    text_kernels = kernel_ms(torch, text_prof)
    # the int8 blocks' attention runs the wgmma body, and no other
    profiles = (("image", by_kernel), ("text", text_kernels))
    wgmma = {tag: sum(v for k, v in kms.items()
                      if "slab_attention_wgmma" in k) for tag, kms in profiles}
    others = [k for _, kms in profiles for k in kms
              if "slab_attention" in k and "slab_attention_wgmma" not in k]
    if int8 and total and (others or not all(wgmma.values())):
        raise AssertionError(f"int8 dispatches: the wgmma body {wgmma} ms, "
                             f"other attention kernels {others}")
    out = {"card": card(), "image_tiles_per_s_bucket128": img_rate,
           "text_prompts_per_s_bucket128x256": txt_rate,
           "device_ms": dev_ms,
           "image_b128_profiled_device_ms": total if total else "not measured",
           "attention_kernel_share_image_b128":
               attn / total if total else "not measured",
           "image_b128_top_kernels_ms": top,
           "image_b128_ms_by_family": by_family(by_kernel),
           "text_b128x256_profiled_device_ms": sum(text_kernels.values()),
           "text_b128x256_ms_by_family": by_family(text_kernels),
           "attention_wgmma_body_ms": wgmma}
    phase("numbers_int8" if int8 else "numbers", **out)
    return out


# ---- 3h. zoo_towers: the zoo's other towers at published width and depth --

# image presets (B = ZOO_TOWER_BATCH[0]) and text presets with their
# sequence lengths (B = ZOO_TOWER_BATCH[1])
ZOO_IMAGE_TOWERS = ("RN50x64", "convnext_xxlarge_320",
                    "swin_base_patch4_window7_224", "EVA02-L-14-336",
                    "EVA02-E-14-plus", "vit_relpos_medium_patch16_cls_224")
ZOO_TEXT_TOWERS = (("ViT-B-32-bert", 256), ("xlm-roberta-large-ViT-H-14", 512),
                   ("roberta-ViT-B-32", 77), ("mt5-xl-ViT-H-14", 256))
ZOO_TOWER_BATCH = (32, 64)
# the card against the port on the CPU: one preset per tower kind (both
# EVA02 block variants), every stack cut to 2 blocks, at B = 2 in fp32
# with TF32 off, at the tolerance of that component's CPU test
ZOO_CARD_VS_CPU = (("rn", "RN50x64", 5e-5, 5e-5),
                   ("convnext", "convnext_xxlarge_320", 1e-4, 1e-3),
                   ("swin", "swin_base_patch4_window7_224", 2e-5, 2e-5),
                   ("eva02 TrV", "EVA02-L-14-336", 2e-5, 2e-5),
                   ("eva02 E", "EVA02-E-14-plus", 2e-5, 2e-5),
                   ("vit_relpos", "vit_relpos_medium_patch16_cls_224", 2e-5,
                    2e-5),
                   ("path_bert", "ViT-B-32-bert", 2e-5, 2e-5),
                   ("hf", "xlm-roberta-large-ViT-H-14", 3e-5, 3e-5),
                   ("mt5", "mt5-xl-ViT-H-14", 5e-5, 5e-5))


def shrink_blocks(r, n: int = 2):
    """The resolved preset ``r`` with every block stack of both towers cut
    to ``n`` (per stage for the staged towers); widths unchanged."""
    v, t = r.vision_cfg, r.text_cfg
    if r.vision_kind == "rn":
        v = dataclasses.replace(v, layers=(n,) * len(v.layers))
    elif r.vision_kind in ("convnext", "swin"):
        v = dataclasses.replace(v, depths=(n,) * len(v.depths))
    else:
        v = dataclasses.replace(v, depth=n)
    if r.text_kind == "clip":
        t = dataclasses.replace(t, layers=n)
    elif r.text_kind == "path_bert":
        t = dataclasses.replace(t, num_hidden_layers=n)
    else:
        key = "num_layers" if t.arch == "mt5" else "num_hidden_layers"
        t = dataclasses.replace(t, trunk=dataclasses.replace(t.trunk,
                                                             **{key: n}))
    return dataclasses.replace(r, vision_cfg=v, text_cfg=t)


def padded_ids(vocab: int, pad: int, batch: int, seq: int,
               rng) -> np.ndarray:
    """[batch, seq] random ids with padded rows: each row's length drawn in
    [seq / 4, seq], pads at ``pad``; the first three ids and the last left
    out of the draw."""
    ids = rng.integers(3, vocab - 1, (batch, seq))
    lens = rng.integers(seq // 4, seq + 1, batch)
    return np.where(np.arange(seq)[None] < lens[:, None], ids, pad)


def text_ids(r, batch: int, seq: int, rng) -> np.ndarray:
    """``padded_ids`` for the resolved preset's text tower."""
    t = r.text_cfg
    vocab, pad = ((t.vocab_size, 0) if r.text_kind == "path_bert" else
                  (t.trunk.vocab_size, t.trunk.pad_token_id))
    return padded_ids(vocab, pad, batch, seq, rng)


def bert_layers(r) -> int:
    """#1's launches one encode of the preset's text tower makes."""
    if r.text_kind == "path_bert":
        return r.text_cfg.num_hidden_layers
    if r.text_kind == "hf" and r.text_cfg.arch != "mt5":
        return r.text_cfg.trunk.num_hidden_layers
    return 0


def held_unit(name: str, torch, feats, width: int) -> None:
    """Finite features of unit norm and the expected width, or raise."""
    if feats.shape[-1] != width or not torch.isfinite(feats).all() or (
            feats.float().norm(dim=-1) - 1).abs().max().item() > 1e-3:
        raise AssertionError(f"{name}: features {tuple(feats.shape)} not "
                             f"finite unit rows of width {width}")


def drive_zoo_image(torch, fa, name: str, make, batch: int,
                    device: str) -> dict:
    """One image preset: build, uint8 images through its
    ``preprocess_config``, a timed bf16 ``encode_image``, the fp32 forward
    on the same weights; no attention kernel launches (the towers' own
    attention is plain, as in the JAX package)."""
    from keep_tpu_torch import presets
    from keep_tpu_torch.ops.preprocess import preprocess

    model, build_ms = synced_ms(torch, lambda: make(name, torch.bfloat16))
    r = model.config
    v = r.vision_cfg
    # the preset's transform at the built tower's size (a rehearsal's is cut)
    pcfg = dataclasses.replace(presets.preprocess_config(name), size=getattr(
        v, "img_size", None) or v.image_size)
    rng = np.random.default_rng(0)
    side = pcfg.size * 8 // 7
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, side, side, 3), dtype=np.uint8)).to(device)
    out = {"preset": name, "kind": r.vision_kind, "batch": batch,
           "image": pcfg.size, "build_ms": build_ms,
           "params": sum(p.numel() for p in model.parameters()),
           "fp32_tower": r.vision_kind in presets.FP32_VISION}
    with torch.inference_mode():
        pixels = preprocess(images, pcfg)
        model.encode_image(pixels)  # warm-up
        feats, launches = counted_encode(torch, fa, lambda: model.encode_image(
            pixels, normalize=True))
        _, ms = synced_ms(torch, lambda: model.encode_image(preprocess(
            images, pcfg), normalize=True))
        fp32 = model.encode_image(pixels, normalize=True, dtype=torch.float32)
    out.update(forward_ms=ms, tiles_per_s=batch / (ms / 1e3),
               attention_launches=launches,
               cos_bf16_vs_fp32_min=cos_min(torch, feats, fp32))
    held_unit(name, torch, feats, r.embed_dim)
    if launches != 0:
        raise AssertionError(f"{name}: {out}")
    phase("zoo_tower", **out)
    return out


def drive_zoo_text(torch, fa, name: str, seq: int, make, batch: int,
                   device: str) -> dict:
    """One text preset: random ids with padded rows, a timed bf16
    ``encode_text`` (through #1 for the BERT-family towers: one launch a
    layer, cosine ≥ 0.999 per row against plain attention), the fp32
    forward on the same weights."""
    model, build_ms = synced_ms(torch, lambda: make(name, torch.bfloat16))
    r = model.config
    layers = bert_layers(r)
    kw = {"use_flash": True} if layers else {}
    ids = torch.from_numpy(text_ids(r, batch, seq, np.random.default_rng(
        1))).to(device)
    out = {"preset": name, "kind": r.text_kind if r.text_kind != "hf"
           else r.text_cfg.arch, "batch": batch, "seq": seq,
           "build_ms": build_ms,
           "params": sum(p.numel() for p in model.parameters())}
    with torch.inference_mode():
        model.encode_text(ids, **kw)  # warm-up
        feats, launches = counted_encode(torch, fa, lambda: model.encode_text(
            ids, normalize=True, **kw))
        _, ms = synced_ms(torch, lambda: model.encode_text(
            ids, normalize=True, **kw))
        fp32 = model.encode_text(ids, normalize=True, dtype=torch.float32)
        if layers:
            plain = model.encode_text(ids, normalize=True)
            out["cos_vs_plain_min"] = cos_min(torch, feats, plain)
    out.update(forward_ms=ms, prompts_per_s=batch / (ms / 1e3),
               attention_launches=launches, layers=layers,
               cos_bf16_vs_fp32_min=cos_min(torch, feats, fp32))
    held_unit(name, torch, feats, r.embed_dim)
    if launches != layers or not out.get("cos_vs_plain_min", 1.0) >= 0.999:
        raise AssertionError(f"{name}: {out}")
    phase("zoo_tower", **out)
    return out


def drive_zoo_registry(torch, fa, device: str, batch: tuple,
                       kep_cfg=None, rn_cfg=None) -> dict:
    """The registry's ``kep`` (image, text and knowledge towers, each
    through #1: one launch a layer, cosine ≥ 0.999 per row against plain
    attention) and ``rn50-clip`` (fp32 by default, then bf16 on the same
    weights), from ``factory.create_model``."""
    from keep_tpu_torch import factory

    def fields(cfg) -> dict:  # a rehearsal's shrunk config, as overrides
        return {} if cfg is None else {f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(cfg)}

    out = {}
    kep, build_ms = synced_ms(torch, lambda: factory.create_model(
        "kep", seed=0, dtype=torch.bfloat16, device=device,
        **fields(kep_cfg)))
    cfg = kep.config
    rng = np.random.default_rng(2)
    size = cfg.vision.img_size
    pixels = torch.from_numpy(rng.standard_normal(
        (batch[0], size, size, 3), dtype=np.float32)).to(device)
    seq = min(256, cfg.text.max_position_embeddings)
    ids = torch.from_numpy(padded_ids(cfg.text.vocab_size, 0, batch[1], seq,
                                      rng)).to(device)
    mask = (ids != 0).long()
    row = {"build_ms": build_ms,
           "params": sum(p.numel() for p in kep.parameters())}
    encoders = {
        "image": (lambda **kw: kep.encode_image(pixels, normalize=True, **kw),
                  cfg.vision.depth),
        "text": (lambda **kw: kep.encode_text(ids, mask, normalize=True, **kw),
                 cfg.text.num_hidden_layers),
        "knowledge": (lambda **kw: kep.encode_knowledge(ids, mask,
                                                        normalize=True, **kw),
                      cfg.text.num_hidden_layers)}
    with torch.inference_mode():
        for tower, (enc, layers) in encoders.items():
            enc(use_flash=True)  # warm-up
            feats, launches = counted_encode(torch, fa,
                                             lambda: enc(use_flash=True))
            _, ms = synced_ms(torch, lambda: enc(use_flash=True))
            t = {"attention_launches": launches, "layers": layers,
                 "forward_ms": ms,
                 "cos_vs_plain_min": cos_min(torch, feats, enc()),
                 "cos_bf16_vs_fp32_min": cos_min(torch, feats, enc(
                     dtype=torch.float32))}
            held_unit(f"kep {tower}", torch, feats, cfg.embed_dim)
            if launches != layers or not t["cos_vs_plain_min"] >= 0.999:
                raise AssertionError(f"kep {tower}: {t}")
            row[tower] = t
    out["kep"] = row
    phase("zoo_tower", preset="kep", **row)
    del kep
    rn, build_ms = synced_ms(torch, lambda: factory.create_model(
        "rn50-clip", seed=0, device=device, **fields(rn_cfg)))
    size = rn.config.image_size
    pixels = torch.from_numpy(rng.standard_normal(
        (batch[0], size, size, 3), dtype=np.float32)).to(device)
    with torch.inference_mode():
        rn.encode_image(pixels)  # warm-up
        feats, ms = synced_ms(torch, lambda: rn.encode_image(pixels,
                                                             normalize=True))
        half = rn.encode_image(pixels, normalize=True, dtype=torch.bfloat16)
    row = {"build_ms": build_ms, "forward_ms": ms,
           "tiles_per_s": batch[0] / (ms / 1e3),
           "params": sum(p.numel() for p in rn.parameters()),
           "cos_bf16_vs_fp32_min": cos_min(torch, half, feats)}
    held_unit("rn50-clip", torch, feats, rn.config.output_dim)
    out["rn50-clip"] = row
    phase("zoo_tower", preset="rn50-clip", **row)
    return out


def check_card_vs_cpu(torch, kind: str, name: str, atol: float,
                      rtol: float, device: str, shrink=None) -> dict:
    """``name`` at full width with 2 blocks a stack, drawn on the card in
    fp32 and copied into a CPU model: the card's features (B = 2, TF32 off;
    the BERT-family text towers through #1) against the CPU's at
    ``atol`` / ``rtol``."""
    from keep_tpu_torch import presets

    r = (shrink or shrink_blocks)(presets.resolve(name))
    card_model = presets.build_preset(r, seed=0, device=device)
    cpu_model = presets.PresetModel(r, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    cpu_model.eval()
    rng = np.random.default_rng(3)
    image = kind not in ("path_bert", "hf", "mt5")
    with torch.inference_mode():
        if image:
            v = r.vision_cfg
            size = getattr(v, "img_size", None) or v.image_size
            x = torch.from_numpy(rng.standard_normal((2, size, size, 3),
                                                     dtype=np.float32))
            got = card_model.encode_image(x.to(device))
            ref = cpu_model.encode_image(x)
        else:
            t = r.text_cfg
            seq = min(64, t.max_position_embeddings
                      if r.text_kind == "path_bert"
                      else t.context_length or 64)
            ids = torch.from_numpy(text_ids(r, 2, seq, rng))
            kw = {"use_flash": True} if bert_layers(r) else {}
            got = card_model.encode_text(ids.to(device), **kw)
            ref = cpu_model.encode_text(ids, **kw)
    got = got.float().cpu().numpy()
    ref = ref.float().numpy()
    err = float(np.abs(got - ref).max())
    row = {"kind": kind, "preset": name, "max_abs_err": err,
           "atol": atol, "rtol": rtol,
           "max_abs_ref": float(np.abs(ref).max())}
    if not np.allclose(got, ref, atol=atol, rtol=rtol):
        raise AssertionError(f"card against CPU: {row}")
    return row


def check_bert_flash_bf16(torch, device: str = "cuda") -> dict:
    """ROADMAP queue 3's check: BERT-base width at 2 layers in bf16, the
    fused attention against the plain route on ``bert_check_inputs``'s
    weights and ids (``tests/test_torch_hf_text.py`` takes the JAX
    package's distance on the same values): 1 − the least cosine of the
    pooler outputs and of the unpadded hidden rows."""
    from keep_tpu_torch.compat.torch_loader import from_jax_tree
    from keep_tpu_torch.configs import BertConfig
    from keep_tpu_torch.models.bert import BertModel

    cfg = BertConfig(num_hidden_layers=BERT_CHECK["layers"])
    tree, ids, mask = bert_check_inputs(cfg)
    m = BertModel(cfg, device=device)
    m.load_state_dict(from_jax_tree(tree, lambda p: cfg.num_hidden_layers))
    ids_t, mask_t = (torch.from_numpy(a).to(device) for a in (ids, mask))
    with torch.inference_mode():
        outs = {flash: m.eval()(ids_t, mask_t, dtype=torch.bfloat16,
                                use_flash=flash) for flash in (True, False)}
    valid = mask_t.bool()
    out = {"batch": BERT_CHECK["batch"], "seq": BERT_CHECK["seq"],
           "layers": cfg.num_hidden_layers,
           "pooler_1_minus_cos": 1 - cos_min(
               torch, outs[True]["pooler_output"],
               outs[False]["pooler_output"]),
           "hidden_1_minus_cos": 1 - cos_min(
               torch, outs[True]["last_hidden_state"][valid],
               outs[False]["last_hidden_state"][valid])}
    phase("bert_flash_bf16", **out)
    return out


def drive_zoo_towers(torch, fa, device: str = "cuda",
                     batch: tuple = ZOO_TOWER_BATCH, shrink=None,
                     kep_cfg=None, rn_cfg=None) -> dict:
    """Phase 3h: each listed image and text preset from
    ``factory.create_model`` at its published width and depth in bf16
    (``shrink``, for a rehearsal on the CPU, cuts them and builds through
    ``presets.build_preset``), each freed before the next; the registry's
    ``kep`` and ``rn50-clip``; the card against the CPU per tower kind;
    the BERT bf16 check. ``torch.backends.cudnn.allow_tf32`` is off (phase
    1), so the fp32 convolutions run in full fp32."""
    from keep_tpu_torch import factory, presets

    def make(name, dtype):
        if shrink is None:
            return factory.create_model(name, seed=0, dtype=dtype,
                                        device=device)
        return presets.build_preset(shrink(presets.resolve(name)), seed=0,
                                    dtype=dtype, device=device)

    out = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "image": {}, "text": {}}
    for name in ZOO_IMAGE_TOWERS:
        out["image"][name] = drive_zoo_image(torch, fa, name, make, batch[0],
                                             device)
        if device == "cuda":
            torch.cuda.empty_cache()
    for name, seq in ZOO_TEXT_TOWERS:
        out["text"][name] = drive_zoo_text(torch, fa, name, seq, make,
                                           batch[1], device)
        if device == "cuda":
            torch.cuda.empty_cache()
    out["registry"] = drive_zoo_registry(torch, fa, device, batch, kep_cfg,
                                         rn_cfg)
    if device == "cuda":
        torch.cuda.empty_cache()
    out["card_vs_cpu"] = [check_card_vs_cpu(torch, *row, device=device,
                                            shrink=shrink)
                          for row in ZOO_CARD_VS_CPU]
    out["bert_flash_bf16"] = check_bert_flash_bf16(torch, device)
    phase("zoo_towers", cudnn_allow_tf32=out["cudnn_allow_tf32"],
          card_vs_cpu=out["card_vs_cpu"],
          attention_launches={k: v["attention_launches"]
                              for k, v in out["text"].items()})
    return out


# ---- 17.–19. CoCa, PMC-CLIP and the Switch-MoE KEEP --------------------------

COCA_PRESET = "coca_ViT-L-14"
COCA_ROBERTA = "coca_roberta-ViT-B-32"
COCA_BATCH = 32
# PMC-CLIP at its config's defaults: RN50 (output 768), BERT-base, 4 fusion
# layers; prompts at its context length
PMC_BATCH = (32, 64)
# the MoE KEEP: ViT-L/16 224² with scripts/moe_lab.py's default 8 experts,
# top-1, capacity factor 1.25, and BERT-base
MOE_EXPERTS = 8
MOE_BATCH = 32
MOE_TRAIN_BATCH = 128


def counted(torch, fa, device: str, fn) -> tuple:
    """(result, #1 launches, #1b launches, int8 launches by name) of one
    call of ``fn``, every count set to 0 just before it and read just
    after."""
    from keep_tpu_torch.kernels import _kops

    with fa._launch_lock:
        fa.LAUNCHES = fa.BWD_LAUNCHES = 0
    with _kops._launch_lock:
        _kops.LAUNCHES.clear()
    out = fn()
    _sync(torch, device)
    return out, fa.LAUNCHES, fa.BWD_LAUNCHES, dict(_kops.LAUNCHES)


def slab_row(fa, torch, gen, name: str, b: int, s: int, h: int,
             padded: bool) -> dict:
    """#1 in bf16 at one path's shape against its plain version (max |Δ|
    < 0.05 on the unpadded rows), timed beside its bound and SDPA."""
    qkv = torch.randn(b, s, 3 * h * 64, device="cuda",
                      generator=gen).bfloat16()
    kb, valid = None, torch.ones(b, s, dtype=torch.bool, device="cuda")
    if padded:
        lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
        valid = torch.arange(s, device="cuda")[None] < lens[:, None]
        kb = (1.0 - valid.float()) * -1e9
    with uncounted(fa):
        got = fa.attention_qkv_slab(qkv, kb, num_heads=h)
        ref = fa.attention_qkv_slab_reference(qkv, kb, num_heads=h)
        err = (got.float() - ref.float())[valid].abs().max().item()
        if not err < 0.05:
            raise AssertionError(f"{name}: #1 bf16 vs plain max |Δ| {err}")
        q, k, v = qkv.view(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
        mask = None if kb is None else kb[:, None, None, :].bfloat16()
        row = {"shape": name, "B": b, "S": s, "H": h, "dtype": "bfloat16",
               "max_abs_err": err,
               "ms": cuda_ms(lambda: fa.attention_qkv_slab(qkv, kb,
                                                           num_heads=h)),
               "plain_ms": cuda_ms(lambda: fa.attention_qkv_slab_reference(
                   qkv, kb, num_heads=h)),
               "library_ms": cuda_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask))}
    row["bound_ms"], row["bound_by"] = attention_bound(b, s, h, 2,
                                                       kb is not None)
    phase("kernel", **row)
    return row


def state_close(torch, name: str, got: dict, ref: dict, atol: float,
                rtol: float) -> dict:
    """Each tensor of ``got`` (card) against ``ref`` (CPU) at atol / rtol;
    the largest error."""
    err = 0.0
    for k, r in ref.items():
        g = got[k].float().cpu()
        e = (g - r.float()).abs().max().item()
        err = max(err, e)
        if not torch.allclose(g, r.float(), atol=atol, rtol=rtol):
            raise AssertionError(f"{name} card vs CPU: {k} max |Δ| {e}")
    return {"name": name, "max_abs_err": err, "atol": atol, "rtol": rtol}


def shrink_coca(r, n: int = 2):
    """A CoCa resolution with every stack cut to ``n`` blocks."""
    c = r.text_cfg
    kw = dict(vision=dataclasses.replace(c.vision, depth=n), text_layers=n,
              decoder_layers=n)
    if c.hf_text is not None:
        kw["hf_text"] = dataclasses.replace(c.hf_text, trunk=dataclasses.replace(
            c.hf_text.trunk, num_hidden_layers=n))
    c = dataclasses.replace(c, **kw)
    return dataclasses.replace(r, text_cfg=c, vision_cfg=c.vision)


def drive_coca(torch, fa, gen, device: str = "cuda",
               batch: int = COCA_BATCH, shrink=None) -> dict:
    """Phase 17: ``coca_ViT-L-14`` from ``factory.create_model`` at its
    published width and depth in bf16 (vision 24 × 1024 at patch 14 on
    224², S = 257, the 8-head attentional pooler over 256 queries; text 12 ×
    768 over 76 tokens, vocab 49,408; decoder 12 layers): the image trunk
    through #1 (24 launches a batch, latents at cosine ≥ 0.999 per row of
    plain attention), the training forward and ``coca_loss``, greedy and
    beam captions (``coca.generate`` / ``generate_beam``), one loss
    backward through #1b at S = 257 (24 launches); #1 against its plain
    version at the trunk's shape; ``coca_roberta-ViT-B-32``'s RoBERTa
    tower through #1 with its key mask (12 launches an encode, cosine ≥
    0.999) and its per-length greedy captions; the card against the CPU at
    2 blocks a stack, full width, fp32, at the CPU test's 1e-5.
    ``shrink`` (a CPU rehearsal) cuts the presets."""
    from keep_tpu_torch import factory, presets
    from keep_tpu_torch.models import coca

    def make(name, dtype):
        if shrink is None:
            return factory.create_model(name, seed=0, dtype=dtype,
                                        device=device)
        return presets.build_preset(shrink(presets.resolve(name)), seed=0,
                                    dtype=dtype, device=device)

    rng = np.random.default_rng(17)
    model, build_ms = synced_ms(torch, lambda: make(COCA_PRESET,
                                                        torch.bfloat16), device)
    c = model.cfg
    v = c.vision
    px = torch.from_numpy(rng.standard_normal(
        (batch, v.img_size, v.img_size, 3), dtype=np.float32)).to(device)
    ids = torch.from_numpy(padded_ids(c.vocab_size, c.pad_id, batch,
                                      c.context_length + 1, rng)).to(device)
    out = {"preset": COCA_PRESET, "batch": batch, "build_ms": build_ms,
           "params": sum(p.numel() for p in model.parameters()),
           "seq": v.num_patches + 1}
    with torch.inference_mode():
        model.encode_image_tokens(px, use_flash=True)  # warm-up
        # ---- the main path: the image tower through #1 ---------------------
        (lat, ctx), launches, _, _ = counted(
            torch, fa, device, lambda: model.encode_image_tokens(
                px, use_flash=True))
        # -------------------------------------------------------------------
        _, ms = synced_ms(torch, lambda: model.encode_image_tokens(
            px, use_flash=True), device)
        plain, _ = model.encode_image_tokens(px)
        fwd, fwd_ms = synced_ms(torch, lambda: model(px, ids,
                                                         use_flash=True), device)
        loss = coca.coca_loss(fwd, pad_id=c.pad_id).item()
    held_unit(COCA_PRESET, torch, lat, c.embed_dim)
    out.update(attention_launches=launches, image_ms=ms,
               tiles_per_s=batch / (ms / 1e3),
               cos_vs_plain_min=cos_min(torch, lat, plain),
               context=list(ctx.shape), forward_ms=fwd_ms, loss=loss,
               logits=list(fwd["logits"].shape))
    if (launches != v.depth or not out["cos_vs_plain_min"] >= 0.999
            or not np.isfinite(loss)
            or not torch.isfinite(fwd["logits"]).all()
            or list(ctx.shape) != [batch, c.n_queries - 1, c.embed_dim]):
        raise AssertionError(f"coca: {out}")
    caps, gen_ms = synced_ms(torch, lambda: coca.generate(
        model, px[:4], seq_len=20, use_flash=True), device)
    beams, beam_ms = synced_ms(torch, lambda: coca.generate_beam(
        model, px[:2], seq_len=12, num_beams=3, use_flash=True), device)
    for name, cap in (("greedy", caps), ("beam", beams)):
        if (cap[:, 0] != c.sot_id).any() or cap.shape[1] < 2 or \
                cap.min() < 0 or cap.max() >= c.vocab_size:
            raise AssertionError(f"coca {name} captions {cap}")
    out.update(greedy_ms=gen_ms, greedy_tokens=caps.shape[1],
               beam_ms=beam_ms, beam_tokens=beams.shape[1])
    # one loss backward through #1b at S = 257
    sub = max(2, batch // 4)
    model.train()
    (bwd_loss, f1, b1, _) = counted(torch, fa, device, lambda: coca.coca_loss(
        model(px[:sub], ids[:sub], use_flash=True)))
    (_, f2, b2, _) = counted(torch, fa, device, bwd_loss.backward)
    grads_finite = all(torch.isfinite(p.grad).all().item()
                       for p in model.parameters() if p.grad is not None)
    model.zero_grad(set_to_none=True)
    model.eval()
    out.update(backward_batch=sub, backward_fwd_launches=f1,
               backward_launches=b2, grads_finite=grads_finite)
    if f1 != v.depth or b2 != v.depth or not grads_finite:
        raise AssertionError(f"coca backward: {out}")
    del model, fwd, lat, ctx, plain
    if device == "cuda":
        torch.cuda.empty_cache()
        out["slab"] = slab_row(fa, torch, gen, "coca_l14", batch,
                               v.num_patches + 1, v.num_heads, False)

    # coca_roberta: the RoBERTa tower through #1 with its key mask
    rob, _ = synced_ms(torch, lambda: make(COCA_ROBERTA, torch.bfloat16), device)
    rc = rob.cfg
    tc = rc.hf_text.trunk
    rids = torch.from_numpy(padded_ids(tc.vocab_size, tc.pad_token_id,
                                       2 * batch, rc.context_length,
                                       rng)).to(device)
    with torch.inference_mode():
        (rlat, rtok), rl, _, _ = counted(
            torch, fa, device, lambda: rob.encode_text_tokens(
                rids, embed_cls=False, use_flash=True))
        rplain, _ = rob.encode_text_tokens(rids, embed_cls=False)
    rpx = torch.from_numpy(rng.standard_normal(
        (2, rc.vision.img_size, rc.vision.img_size, 3),
        dtype=np.float32)).to(device)
    rcaps, rgen_ms = synced_ms(torch, lambda: coca.generate(
        rob, rpx, seq_len=8), device)
    out["roberta"] = {"preset": COCA_ROBERTA, "batch": 2 * batch,
                      "seq": rc.context_length, "attention_launches": rl,
                      "cos_vs_plain_min": cos_min(torch, rlat, rplain),
                      "greedy_ms": rgen_ms, "greedy_tokens": rcaps.shape[1]}
    held_unit(COCA_ROBERTA, torch, rlat, rc.embed_dim)
    if rl != tc.num_hidden_layers or \
            not out["roberta"]["cos_vs_plain_min"] >= 0.999 or \
            (rcaps[:, 0] != rc.sot_id).any():
        raise AssertionError(f"coca_roberta: {out['roberta']}")
    del rob
    if device == "cuda":
        torch.cuda.empty_cache()

    # the card against the CPU, 2 blocks a stack, full width, fp32
    rows = []
    for name in (COCA_PRESET, COCA_ROBERTA):
        r = shrink_coca((shrink or (lambda x: x))(presets.resolve(name)))
        card_m = presets.build_preset(r, seed=0, device=device)
        cpu_m = coca.CoCa(r.text_cfg, device="cpu")
        cpu_m.load_state_dict(card_m.state_dict())
        cpu_m.eval()
        cc = r.text_cfg
        x = torch.from_numpy(rng.standard_normal(
            (2, cc.vision.img_size, cc.vision.img_size, 3),
            dtype=np.float32))
        pad = cc.pad_id
        i = torch.from_numpy(padded_ids(cc.vocab_size if cc.hf_text is None
                                        else cc.hf_text.trunk.vocab_size,
                                        pad, 2, min(24, cc.context_length),
                                        rng))
        with torch.inference_mode():
            got = card_m(x.to(device), i.to(device), use_flash=True)
            ref = cpu_m(x, i)
        rows.append(state_close(torch, name, {k: got[k] for k in (
            "image_features", "text_features", "logits")}, {k: ref[k] for k in (
                "image_features", "text_features", "logits")}, 1e-5, 1e-5))
        del card_m, cpu_m
    out["card_vs_cpu"] = rows
    phase("coca", **{k: v for k, v in out.items() if k != "slab"})
    return out


def drive_pmc_clip(torch, fa, device: str = "cuda",
                   batch: tuple = PMC_BATCH, cfg=None) -> dict:
    """Phase 18: ``factory.create_model("pmc-clip")`` at its config's
    defaults in bf16 (RN50 with output 768, BERT-base, 4 fusion layers):
    images through the RN tower, the unmasked text (pads attend) through
    #1 with a zero key bias (12 launches an encode; the text features at
    cosine ≥ 0.999 per row of plain attention), the fusion module and the
    MLM head, ``mlm_loss``; the card against the CPU at 2 blocks a stack in
    fp32 at the CPU test's 1e-5. ``cfg`` (a CPU rehearsal) replaces the
    default config."""
    from keep_tpu_torch import factory
    from keep_tpu_torch.models import pmc_clip

    rng = np.random.default_rng(18)
    over = {} if cfg is None else dataclasses.asdict(cfg) | {
        "vision": cfg.vision, "text": cfg.text}
    model, build_ms = synced_ms(torch, lambda: factory.create_model(
        "pmc-clip", seed=0, dtype=torch.bfloat16, device=device, **over), device)
    c = model.cfg
    s = c.vision.image_size
    px = torch.from_numpy(rng.standard_normal((batch[0], s, s, 3),
                                              dtype=np.float32)).to(device)
    ids = padded_ids(c.text.vocab_size, 0, batch[0], c.context_length, rng)
    ids[:, 0] = c.cls_id
    ids = torch.from_numpy(ids).to(device)
    with torch.inference_mode():
        model(px, ids, use_flash=True)  # warm-up
        # ---- the main path: both towers, fusion and MLM ---------------------
        out_f, launches, _, _ = counted(torch, fa, device, lambda: model(
            px, ids, use_flash=True))
        # -------------------------------------------------------------------
        _, ms = synced_ms(torch, lambda: model(px, ids, use_flash=True), device)
        plain = model(px, ids)
        img_ms = synced_ms(torch, lambda: model.encode_image(px), device)[1]
        txt_ids = ids.repeat(batch[1] // batch[0], 1)
        _, txt_ms = synced_ms(torch, lambda: model.encode_text(
            txt_ids, None, out_f["image_features"].repeat(
                batch[1] // batch[0], 1), use_flash=True), device)
    labels = torch.where(ids % 7 == 0, ids, torch.zeros_like(ids))
    loss = pmc_clip.mlm_loss(out_f["bert_prediction"], labels).item()
    out = {"batch": batch, "build_ms": build_ms,
           "params": sum(p.numel() for p in model.parameters()),
           "forward_ms": ms, "image_ms": img_ms,
           "tiles_per_s": batch[0] / (img_ms / 1e3), "text_ms": txt_ms,
           "prompts_per_s": batch[1] / (txt_ms / 1e3),
           "attention_launches": launches, "mlm_loss": loss,
           "cos_vs_plain_min": cos_min(torch, out_f["text_features"],
                                       plain["text_features"])}
    for k in ("image_features", "text_features"):
        held_unit(f"pmc-clip {k}", torch, out_f[k], c.embed_dim)
    if launches != c.text.num_hidden_layers or \
            not out["cos_vs_plain_min"] >= 0.999 or not np.isfinite(loss):
        raise AssertionError(f"pmc-clip: {out}")
    del model, out_f, plain
    if device == "cuda":
        torch.cuda.empty_cache()
    small = dataclasses.replace(
        c, fusion_layers=2,
        vision=dataclasses.replace(c.vision, layers=(2, 2, 2, 2)),
        text=dataclasses.replace(c.text, num_hidden_layers=2))
    gen = torch.Generator(device=device).manual_seed(0)
    card_m = pmc_clip.PMCCLIP.init(small, gen, device=device)
    cpu_m = pmc_clip.PMCCLIP(small, device="cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    card_m.eval()
    cpu_m.eval()
    x = torch.from_numpy(rng.standard_normal((2, s, s, 3), dtype=np.float32))
    i = ids[:2].cpu()
    with torch.inference_mode():
        got = card_m(x.to(device), i.to(device), use_flash=True)
        ref = cpu_m(x, i)
    keys = ("image_features", "text_features", "bert_prediction")
    out["card_vs_cpu"] = state_close(torch, "pmc-clip", {
        k: got[k] for k in keys}, {k: ref[k] for k in keys}, 1e-5, 1e-5)
    phase("pmc_clip", **out)
    return out


def moe_keep_config(dispatch: str, vision: dict | None = None,
                    text: dict | None = None):
    """The MoE KEEP: ``KEEPConfig()``'s ViT-L/16 with ``MOE_EXPERTS``
    experts (top-1, capacity factor 1.25) and BERT-base; ``vision`` /
    ``text`` override fields (a CPU rehearsal)."""
    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig

    text_cfg = BertConfig(**(text or {}))
    return KEEPConfig(
        vision=ViTConfig(moe_experts=MOE_EXPERTS, moe_top_k=1,
                         moe_capacity_factor=1.25, moe_dispatch=dispatch,
                         **(vision or {})),
        text=text_cfg, projection_dim=text_cfg.hidden_size)


def cos_mean(torch, a, b) -> float:
    """The mean cosine between matching rows of a and b."""
    return torch.nn.functional.cosine_similarity(
        a.float(), b.float(), dim=-1).mean().item()


def drive_moe(torch, fa, serve, d: str, device: str = "cuda",
              batch: int = MOE_BATCH, train_batch: int = MOE_TRAIN_BATCH,
              vision: dict | None = None, text: dict | None = None,
              steps: int = 2) -> dict:
    """Phase 19: the Switch-MoE KEEP (``moe_keep_config``) from
    ``KEEPModel.init`` at full width in bf16, both ``moe_dispatch`` values:
    features, aux and realized routes; the int8 model (``quantize()``,
    W8A8) served through the server core (``serve.InferenceServer``):
    ``quantized_matmul_bsd`` (#8) 49 launches an image dispatch (the 48
    qkv / proj of the trunk, the patch embed), ``quantized_matmul`` (#9) 2
    (the visual head), the text tower's #5 / #6 12 each; #8 held bit for bit
    against its plain version on the qkv and proj inputs of that path and
    timed there; W8A8, W8A16 and calibrated int8 trunks at a mean row
    cosine ≥ 0.999 against bf16 on the bf16 run's pinned routes (gather
    dispatch; ``scripts/moe_lab.py --route-study``'s measure), the least
    row's and the free-routing cosines beside it; the routes on the card against the CPU
    at 2 blocks, full width, fp32; then ``steps`` unfrozen training steps
    through ``train.main`` at ``configs/keep_train.yml``'s values, batch
    ``train_batch``, with ms a step and peak memory."""
    from keep_tpu_torch.kernels import qmatmul
    from keep_tpu_torch.models import moe
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    rng = np.random.default_rng(19)
    out = {"experts": MOE_EXPERTS, "batch": batch}
    cfgs = {k: moe_keep_config(k, vision, text) for k in ("einsum", "gather")}
    v = cfgs["gather"].vision
    px = torch.from_numpy(rng.standard_normal(
        (batch, v.img_size, v.img_size, 3), dtype=np.float32)).to(device)
    feats = {}
    for dispatch, cfg in cfgs.items():
        gen = torch.Generator(device=device).manual_seed(0)
        model, build_ms = synced_ms(torch, lambda: KEEPModel.init(
            cfg, gen, dtype=torch.bfloat16, use_flash=True, device=device), device)
        with torch.inference_mode():
            model.encode_image(px)  # warm-up
            (f, aux), ms = synced_ms(torch, lambda: model.encode_image(
                px, return_aux=True), device)
        held_unit(f"moe {dispatch}", torch, f, cfg.projection_dim)
        feats[dispatch] = f
        out[dispatch] = {"build_ms": build_ms, "image_ms": ms,
                         "tiles_per_s": batch / (ms / 1e3),
                         "aux": aux.item()}
        if dispatch == "einsum":
            out["params"] = sum(p.numel() for p in model.parameters())
            del model
            if device == "cuda":
                torch.cuda.empty_cache()
    # the same weights under both dispatches: no drop at this batch moves
    # a token's expert, so the features agree up to the drops
    out["einsum_vs_gather_cos_min"] = cos_min(torch, feats["einsum"],
                                              feats["gather"])

    # int8 on pinned routes (the bf16 run's), gather dispatch: the trunk's
    # pooled features, the route study's (scripts/moe_lab.py
    # --route-study) mean row cosine, with the least row's beside it
    def trunk(m, **kw):
        return m.visual(px, dtype=m.dtype, gelu_approx=m.gelu_approx, **kw)

    with torch.inference_mode():
        t16, _, routes = trunk(model, return_routes=True)
    variants = {"w8a8": lambda: model.quantize(),
                "w8a16": lambda: model.quantize(moe_w8a16=True),
                "calibrated": lambda: model.quantize(
                    calib_pixels=px[: max(2, batch // 4)].float())}
    out["int8"] = {}
    for name, make in variants.items():
        (m8, q_ms) = synced_ms(torch, make, device)
        with torch.inference_mode():
            pinned = trunk(m8, routes=routes)[0]
            free, _, r8 = trunk(m8, return_routes=True)
        row = {"quantize_ms": q_ms,
               "cos_pinned_mean": cos_mean(torch, pinned, t16),
               "cos_pinned_min": cos_min(torch, pinned, t16),
               "cos_free_mean": cos_mean(torch, free, t16),
               "cos_free_min": cos_min(torch, free, t16),
               "routes_moved_share": (r8 != routes).float().mean().item()}
        out["int8"][name] = row
        if not row["cos_pinned_mean"] >= 0.999:
            raise AssertionError(f"moe int8 {name}: {row}")
        if name == "w8a8":
            model8 = m8
        else:
            del m8
    del model
    if device == "cuda":
        torch.cuda.empty_cache()

    # the int8 model through the server core
    vocab = os.path.join(d, "vocab.txt")
    with open(vocab, "w") as fh:
        fh.write("\n".join(VOCAB) + "\n")
    tok = WordPieceTokenizer(vocab)
    core = serve.InferenceServer(model8, tok, max_length=64,
                                 image_size=v.img_size, buckets=(batch,))
    tiles = rng.integers(0, 256, (batch, v.img_size, v.img_size, 3),
                         dtype=np.uint8)
    try:
        core.warmup()
        blk0 = model8.visual.blocks[0]
        seen = capture_inputs(torch, {"qkv": blk0.attn.qkv,
                                      "proj": blk0.attn.proj}, lambda: (
            core.encode_image(tiles)))
        served, _, _, img_launches = counted(
            torch, fa, device, lambda: core.encode_image(tiles))
        _, _, _, txt_launches = counted(torch, fa, device, lambda: (
            core.encode_text(PROMPTS * (batch // len(PROMPTS)))))
        _, serve_ms = synced_ms(torch, lambda: core.encode_image(tiles), device)
    finally:
        core.stop()
    depth = v.depth
    want_img = {"quantized_matmul_bsd": 2 * depth + 1, "quantized_matmul": 2}
    want_txt = {"quantized_attention_block_postln":
                cfgs["gather"].text.num_hidden_layers,
                "quantized_mlp_bsd": cfgs["gather"].text.num_hidden_layers}
    if device == "cuda" and (
            {k: img_launches.get(k, 0) for k in want_img} != want_img or
            {k: txt_launches.get(k, 0) for k in want_txt} != want_txt):
        raise AssertionError(f"moe int8 launches: image {img_launches}, "
                             f"text {txt_launches}")
    if not np.isfinite(served).all() or served.shape != (
            batch, cfgs["gather"].projection_dim):
        raise AssertionError(f"moe int8 served features {served.shape}")
    out["serve"] = {"image_launches": img_launches,
                    "text_launches": txt_launches,
                    "image_dispatch_ms": serve_ms,
                    "tiles_per_s": batch / (serve_ms / 1e3)}
    # #8 against its plain version on the path's own inputs, timed there
    out["qmatmul_rows"] = []
    with uncounted(fa), torch.inference_mode():
        for key, lin in (("qkv", blk0.attn.qkv), ("proj", blk0.attn.proj)):
            (x,) = seen[key]
            args = (x, lin.weight_q, lin.weight_scale, lin.bias)
            row = hold_int8(torch, "quantized_matmul_bsd",
                            f"moe {key} {tuple(x.shape)}->"
                            f"{lin.weight_q.shape[0]}",
                            qmatmul.quantized_matmul_bsd,
                            qmatmul.quantized_matmul_bsd_reference, args,
                            dict(out_dtype=x.dtype))
            if device == "cuda":
                fn = lambda: qmatmul.quantized_matmul_bsd(  # noqa: E731
                    *args, out_dtype=x.dtype)
                ref = lambda: qmatmul.quantized_matmul_bsd_reference(  # noqa
                    *args, out_dtype=x.dtype)
                n, k = lin.weight_q.shape
                m = x.numel() // k
                row["device_ms_bf16"], row["device_ms_source"] = device_ms(
                    torch, fn)
                row.update(ms_bf16=cuda_ms(fn), plain_ms_bf16=cuda_ms(ref))
                row["bound_ms_bf16"], row["bound_by"] = bound(
                    {"int8": 2 * m * n * k},
                    nbytes(x, lin.weight_q, fn()) + 8 * n)
            out["qmatmul_rows"].append(row)
    del model8
    if device == "cuda":
        torch.cuda.empty_cache()

    # routes on the card against the CPU: 2 blocks, full width, fp32
    small = dataclasses.replace(cfgs["gather"], vision=dataclasses.replace(
        v, depth=2))
    card_v = moe.MoEVisionTransformer(small.vision, device=device)
    card_v.init_weights(torch.Generator(device=device).manual_seed(0))
    cpu_v = moe.MoEVisionTransformer(small.vision, device="cpu")
    cpu_v.load_state_dict(card_v.state_dict())
    x = torch.from_numpy(rng.standard_normal(
        (4, v.img_size, v.img_size, 3), dtype=np.float32))
    with torch.inference_mode():
        gf, gaux, groutes = card_v(x.to(device), return_routes=True)
        rf, raux, rroutes = cpu_v(x, return_routes=True)
    row = state_close(torch, "moe trunk", {"features": gf, "aux": gaux},
                      {"features": rf, "aux": raux}, 1e-4, 1e-4)
    row["routes_equal"] = bool(torch.equal(groutes.cpu(), rroutes))
    if not row["routes_equal"]:
        raise AssertionError(f"moe routes card vs CPU: {row}")
    out["card_vs_cpu"] = row
    del card_v, cpu_v

    # training: unfrozen steps through the CLI
    out["train"] = drive_moe_train(torch, fa, os.path.join(d, "train"),
                                   cfgs["einsum"], train_batch, steps,
                                   device)
    phase("moe", **out)
    return out


def drive_moe_train(torch, fa, d: str, cfg, batch: int, steps: int,
                    device: str) -> dict:
    """``train.main.main`` on ``train_config``'s values (keep_train.yml) with
    the MoE KEEP ``cfg``, one epoch of ``steps`` steps with both towers
    unfrozen: every loss finite, #1 forward 24 and #1b 12 launches a step
    (the BERT tower with remat; the MoE trunk's attention is plain), the
    router and experts moved; ms a step, peak memory."""
    from keep_tpu_torch.train import main as tmain

    os.makedirs(d, exist_ok=True)
    keep = {"vision": dataclasses.asdict(cfg.vision),
            "text": dataclasses.asdict(cfg.text),
            "projection_dim": cfg.projection_dim}
    raw = train_config(d, keep=keep, batch_size=batch,
                       caption_num=min(32, batch // 4),
                       steps_per_epoch=steps)
    raw["solver"].update(epochs=1, freeze_visual_epochs=0,
                         freeze_text_epochs=0)
    path = os.path.join(d, "train.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    log: list[dict] = []
    seen = {}

    def before(i, state, batch_, model, kw):
        if i == 0:
            seen["router"] = state.params[
                "visual.blocks.0.moe.router.weight"].detach().clone()
            seen["wi"] = state.params[
                "visual.blocks.0.moe.wi.weight"].detach().clone()

    def after(i, state, batch_, model, kw):
        seen["moved"] = {k: not torch.equal(state.params[
            f"visual.blocks.0.moe.{k}.weight"], t) for k, t in
            (("router", seen["router"]), ("wi", seen["wi"]))}

    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    with counted_steps(torch, fa, tmain, log, {}, -1, device, before, after):
        t0 = time.perf_counter()
        tmain.main(["--config", path, "--device", device])
        wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    text_layers = cfg.text.num_hidden_layers
    for i, s in enumerate(log):
        if s["frozen"] or not np.isfinite(s["loss"]) or (
                s["fwd_launches"], s["bwd_launches"]) != (2 * text_layers,
                                                          text_layers):
            raise AssertionError(f"moe train step {i}: {s}")
    if len(log) != steps or not all(seen["moved"].values()):
        raise AssertionError(f"moe train: {log}, moved {seen}")
    return {"batch": batch, "steps": len(log),
            "step_ms": [s["ms"] for s in log],
            "step_losses": [s["loss"] for s in log],
            "fwd_launches": [s["fwd_launches"] for s in log],
            "bwd_launches": [s["bwd_launches"] for s in log],
            "router_and_experts_moved": seen["moved"],
            "peak_memory_gb": peak / 1e9, "wall_s": wall_s}


# ---- 20. compat: released layout → registry → pretrained=; int8 artifact --


def served_http(port: int, cfg) -> dict:
    """The server phases' texts and tiles through the HTTP front end."""
    tiles, _ = smoke_images(cfg)
    txt = np.asarray(json.loads(http(port, "/encode_text", json.dumps(
        {"texts": PROMPTS}).encode()))["embeddings"], np.float32)
    buf = io.BytesIO()
    np.save(buf, tiles)
    img = np.load(io.BytesIO(http(port, "/encode_image_npy", buf.getvalue(),
                                  "application/octet-stream")))
    return {"text": txt, "image": img}


def drive_compat(torch, fa, serve, src: str, home: str,
                 device: str = "cuda") -> dict:
    """Phase 20 (``compat``): the model in ``src`` (the released layout)
    written back with ``compat.export.save_pretrained`` into a temporary
    ``KEEP_TPU_HOME`` as the registry's ``keep`` entry and loaded by name
    (``factory.create_model("keep", pretrained="keep")``, bf16, the fused
    attention on): its features equal the source model's bit for bit, with
    #1's launches counted. Then calibrated (``CALIB_TILES`` tiles,
    ``CALIB_PROMPTS`` prompts), written as the int8 deploy artifact
    (``save_quantized``) and served by ``serve --int8`` over HTTP, which
    must print that it serves the artifact as it is: the served features
    equal the in-memory int8 model's through the same server core, with
    #4–#9 launched. Returns the phase's numbers and the two models."""
    from keep_tpu_torch import factory
    from keep_tpu_torch.compat import export, registry
    from keep_tpu_torch.models.keep import KEEPModel

    os.environ["KEEP_TPU_HOME"] = home
    target = os.path.join(home, "KEEP")
    src_model = KEEPModel.from_pretrained(src, dtype=torch.bfloat16,
                                          use_flash=True, device=device)
    t0 = time.perf_counter()
    export.save_pretrained(target, src_model)
    shutil.copy(os.path.join(src, "vocab.txt"), target)
    save_s = time.perf_counter() - t0
    if registry.resolve("keep") != target:
        raise AssertionError(f"registry: keep → {registry.resolve('keep')}")
    t0 = time.perf_counter()
    model = factory.create_model("keep", pretrained="keep",
                                 dtype=torch.bfloat16, device=device)
    load_s = time.perf_counter() - t0
    model.use_flash = True
    x = aot_inputs(torch, model.cfg, n=32, device=device)
    with torch.no_grad():
        want = (src_model.encode_image(x["pixels"]),
                src_model.encode_text(x["ids"], x["mask"]))
        (got_i, launches_i, _, _), (got_t, launches_t, _, _) = (
            counted(torch, fa, device, lambda: model.encode_image(
                x["pixels"])),
            counted(torch, fa, device, lambda: model.encode_text(
                x["ids"], x["mask"])))
    if not (torch.equal(got_i, want[0]) and torch.equal(got_t, want[1])):
        raise AssertionError("the registry-loaded model's features differ "
                             "from its source's")
    cfg = model.cfg
    if device == "cuda" and (launches_i, launches_t) != (
            cfg.vision.depth, cfg.text.num_hidden_layers):
        raise AssertionError(f"#1 launches {launches_i} / {launches_t}")
    del src_model

    # calibrate once offline, write the artifact, serve it as it is
    rng = np.random.default_rng(20)
    calib = aot_inputs(torch, cfg, n=max(CALIB_TILES, CALIB_PROMPTS),
                       seed=21, device=device)
    t0 = time.perf_counter()
    model8 = model.quantize(calib_pixels=calib["pixels"][:CALIB_TILES],
                            calib_text=(calib["ids"][:CALIB_PROMPTS],
                                        calib["mask"][:CALIB_PROMPTS]))
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    export.save_quantized(target, model8)
    save8_s = time.perf_counter() - t0
    art = os.path.join(target, export.QUANTIZED_SUBDIR, export.QUANTIZED_FILE)
    sizes = {"artifact_bytes": os.path.getsize(art),
             "fp32_bin_bytes": os.path.getsize(
                 os.path.join(target, "pytorch_model.bin"))}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        core, httpd = serve.build_server(["--model-dir", target, "--port",
                                          "0", "--device", device, "--int8"])
    setup_s = time.perf_counter() - t0
    if "serving it as-is" not in out.getvalue():
        raise AssertionError(f"serve --int8 over the artifact said: "
                             f"{out.getvalue()!r}")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        if any(not torch.equal(core.model.state_dict()[k], v)
               for k, v in model8.state_dict().items()):
            raise AssertionError("the served artifact differs from the "
                                 "quantized model")
        stats0 = core.stats()
        reset_launches(fa)
        # ---- the main path, through the HTTP front end -------------------
        served = served_http(httpd.server_address[1], cfg)
        _sync(torch, device)
        attention, int8 = read_launches(fa)
        # ------------------------------------------------------------------
        stats = core.stats()
        ref_core = serve.InferenceServer(model8, core.tokenizer,
                                         max_length=core.max_length,
                                         image_size=core.image_size)
        try:
            tiles, _ = smoke_images(cfg)
            ref = {"text": ref_core.encode_text(PROMPTS),
                   "image": ref_core.encode_image(tiles)}
        finally:
            ref_core.stop()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
        core.stop()
    for k in ("text", "image"):
        if not np.array_equal(served[k], ref[k]):
            raise AssertionError(f"served {k} features differ from the "
                                 f"in-memory int8 model's: max |Δ| "
                                 f"{np.abs(served[k] - ref[k]).max()}")
    img_disp = stats["image"]["dispatches"] - stats0["image"]["dispatches"]
    txt_disp = stats["text"]["dispatches"] - stats0["text"]["dispatches"]
    want8 = {"quantized_attention_block": img_disp * cfg.vision.depth,
             "quantized_attention_block_postln":
                 txt_disp * cfg.text.num_hidden_layers,
             "quantized_mlp_bsd": img_disp * cfg.vision.depth
             + txt_disp * cfg.text.num_hidden_layers,
             "quantized_matmul_bsd": img_disp,
             "quantized_matmul": 2 * img_disp}
    if device == "cuda" and any(int8.get(k) != v for k, v in want8.items()):
        raise AssertionError(f"artifact path launches {int8}, want {want8}")
    result = {"save_pretrained_s": save_s, "registry_load_s": load_s,
              "attention_launches": {"image": launches_i,
                                     "text": launches_t},
              "registry_equal_to_source": True, "calibration_s": calib_s,
              "save_quantized_s": save8_s, "serve_setup_s": setup_s,
              **sizes, "artifact_over_fp32_bin":
                  sizes["artifact_bytes"] / sizes["fp32_bin_bytes"],
              "image_dispatches": img_disp, "text_dispatches": txt_disp,
              "artifact_launches": {"attention": attention, **int8},
              "served_equal_to_in_memory": True}
    phase("compat", **result)
    return result, model, model8


# ---- 21. aot: torch.export bundles through the keep:: operators ----------

AOT_BUCKETS = (1, 8, 32)
AOT_BATCHES = (5, 32)  # 5 pads to bucket 8
AOT_COS = 0.99999


def aot_inputs(torch, cfg, n: int = max(AOT_BATCHES), seed: int = 0,
               device: str = "cuda") -> dict:
    """Normalised pixels and padded token ids for the aot phase: a seeded
    draw of ``n`` rows, rows past their length masked."""
    rng = np.random.default_rng(seed)
    size, seq = cfg.vision.img_size, cfg.max_text_length
    pixels = rng.standard_normal((n, size, size, 3), dtype=np.float32)
    ids = rng.integers(5, cfg.text.vocab_size, (n, seq))
    lens = rng.integers(4, seq + 1, n)
    mask = (np.arange(seq)[None] < lens[:, None]).astype(np.int64)
    ids = ids * mask
    return {"pixels": torch.from_numpy(pixels).to(device),
            "ids": torch.from_numpy(ids).to(device),
            "mask": torch.from_numpy(mask).to(device)}


def aot_encode(torch, encode_image, encode_text, x: dict) -> dict:
    """Features at each of ``AOT_BATCHES``' batch sizes, with the launches
    of each call (#1 and the int8 counts, set to 0 just before and read
    just after), then the ms of a batch-32 call of each tower."""
    from keep_tpu_torch.kernels import _kops
    from keep_tpu_torch.kernels import flash_attention as fa

    out = {}
    for b in AOT_BATCHES:
        for tower, fn, args in (
                ("image", encode_image, (x["pixels"][:b],)),
                ("text", encode_text, (x["ids"][:b], x["mask"][:b]))):
            reset_launches(fa)
            feats = fn(*args)
            torch.cuda.synchronize()
            out[f"{tower}_{b}"] = {"features": feats.float().cpu(),
                                   "attention": fa.LAUNCHES,
                                   "int8": dict(_kops.LAUNCHES)}
    b = max(AOT_BATCHES)
    out["ms"] = {
        "image": cuda_ms(lambda: encode_image(x["pixels"][:b]), runs=10),
        "text": cuda_ms(lambda: encode_text(x["ids"][:b], x["mask"][:b]),
                        runs=10)}
    return out


def aot_child(io_path: str) -> None:
    """The aot phase's fresh process: loads each bundle the parent wrote
    (nothing traced), encodes the parent's inputs with it and writes the
    features, launches and times."""
    import torch

    from keep_tpu_torch.compat import aot

    io_ = torch.load(io_path, map_location="cuda")
    out = {}
    for tag, job in io_["jobs"].items():
        t0 = time.perf_counter()
        m = aot.load_aot(job["bundle"])
        load_s = time.perf_counter() - t0
        lead = () if job["params"] is None else (job["params"],)
        out[tag] = aot_encode(torch, lambda px: m.encode_image(*lead, px),
                              lambda i, k: m.encode_text(*lead, i, k),
                              io_["x"])
        out[tag]["load_s"] = load_s
        del m
    torch.save(out, io_["out"])


def drive_aot(torch, fa, models: dict, d: str) -> dict:
    """Phase 21 (``aot``): each model of ``models`` ({tag: (KEEPModel,
    bake_params)}, one config) exported through ``compat.aot.save_aot`` at
    buckets ``AOT_BUCKETS`` (``use_flash`` on, as served), then loaded and
    run in one fresh process (``python chip_smoke.py --aot-child``) at
    batches 5 and 32, held row by row to the eager model on the same inputs
    (cosine ≥ ``AOT_COS``; max |Δ| reported), with the kernels' launches
    counted in that process: the exported graph must launch what the eager
    forward launches."""
    from keep_tpu_torch.compat import aot

    x = aot_inputs(torch, next(iter(models.values()))[0].cfg)
    jobs, eager, rows = {}, {}, {}
    for tag, (model, bake) in models.items():
        bundle = os.path.join(d, tag)
        t0 = time.perf_counter()
        aot.save_aot(bundle, model, use_flash=True, batch_sizes=AOT_BUCKETS,
                     bake_params=bake)
        rows[tag] = {"bake_params": bake,
                     "export_s": time.perf_counter() - t0,
                     "bundle_bytes": sum(
                         os.path.getsize(os.path.join(bundle, f))
                         for f in os.listdir(bundle))}
        with torch.no_grad():
            eager[tag] = aot_encode(torch, model.encode_image,
                                    model.encode_text, x)
        jobs[tag] = {"bundle": bundle,
                     "params": None if bake else aot._state(model)}
    io_path, out_path = os.path.join(d, "io.pt"), os.path.join(d, "out.pt")
    torch.save({"x": x, "out": out_path, "jobs": jobs}, io_path)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__), "--aot-child",
                    io_path], check=True, timeout=600,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    child_s = time.perf_counter() - t0
    loaded = torch.load(out_path)
    for tag, row in rows.items():
        got, want = loaded[tag], eager[tag]
        row.update(load_s=got["load_s"], ms=got["ms"], eager_ms=want["ms"],
                   batches={})
        for key in (k for k in want if k != "ms"):
            a, e = got[key], want[key]
            fa_, fe = a["features"].numpy(), e["features"].numpy()
            cos = cosine_rows(fa_, fe)
            if fa_.shape != fe.shape or not (cos >= AOT_COS).all():
                raise AssertionError(f"aot {tag} {key}: cosine {cos}")
            if (a["attention"], a["int8"]) != (e["attention"], e["int8"]):
                raise AssertionError(
                    f"aot {tag} {key}: launches {a['attention']}, "
                    f"{a['int8']} against eager {e['attention']}, "
                    f"{e['int8']}")
            if a["attention"] == 0:
                raise AssertionError(f"aot {tag} {key}: no #1 launch")
            row["batches"][key] = {
                "min_row_cos": float(cos.min()),
                "max_abs_diff": float(np.abs(fa_ - fe).max()),
                "attention_launches": a["attention"],
                "int8_launches": a["int8"]}
        phase("aot", model=tag, **row)
    phase("aot_time", child_s=child_s)
    return rows


# ---- 22.–23. fast_tokenizer and profiling ---------------------------------


def drive_fast_tokenizer(torch, model, d: str, device: str = "cuda") -> dict:
    """Phase 22 (``fast_tokenizer``): ``factory.get_tokenizer("bert", ...)``
    gives the native WordPiece (``native/wordpiece.cpp`` built alone), whose
    ids and masks over phase 11's ``WSI_PROMPTS`` prompts equal the Python
    tokenizer's; both timed, and phase 11's flat classifier build timed
    with each (the same stack from both)."""
    from keep_tpu_torch.factory import get_tokenizer
    from keep_tpu_torch.io import _native
    from keep_tpu_torch.text.fast_tokenizer import FastWordPieceTokenizer
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
    from keep_tpu_torch.wsi import run as wsi_run
    from keep_tpu_torch.zeroshot import build_classifiers_batched

    t0 = time.perf_counter()
    fast = get_tokenizer("bert", d)
    build_s = time.perf_counter() - t0
    if not isinstance(fast, FastWordPieceTokenizer):
        raise AssertionError(f"get_tokenizer gave {type(fast).__name__}")
    py = WordPieceTokenizer.from_pretrained(d)
    prompts = wsi_prompts(WSI_PROMPTS)
    texts = [t for p in prompts.values() for t in p["classnames"].values()]
    ms = {}
    for tag, tok in (("native", fast), ("python", py)):
        enc, ms[tag] = synced_ms(torch, lambda: tok(texts, max_length=256),
                                 "cpu")
        ms[tag] = min(ms[tag], synced_ms(
            torch, lambda: tok(texts, max_length=256), "cpu")[1])
        if tag == "native":
            ids = enc
    if not all(np.array_equal(np.asarray(ids[k]), np.asarray(enc[k]))
               for k in ("input_ids", "attention_mask")):
        raise AssertionError("native and Python token ids differ")
    enc_fn = wsi_run._encoder(model, torch.device(device))
    stacks, build = {}, {}
    for tag, tok in (("native", fast), ("python", py)):
        stacks[tag], build[tag] = synced_ms(torch, lambda: torch.as_tensor(
            build_classifiers_batched(
                enc_fn, tok, prompts, {"Normal": 0, "Tumor": 1},
                max_length=256, batch_size=256, length_buckets=None,
                device=device)).float().cpu().numpy(), device)
    if not np.array_equal(stacks["native"], stacks["python"]):
        raise AssertionError("the classifier differs between tokenizers")
    result = {"library": os.path.basename(_native.tokenizer_library_path()),
              "first_use_s": build_s, "texts": len(texts),
              "ids_equal": True, "tokenize_ms": ms,
              "classifier_build_s": {k: v / 1e3 for k, v in build.items()},
              "classifier_equal": True}
    phase("fast_tokenizer", **result)
    return result


def drive_profiling(torch, model, d: str, device: str = "cuda") -> dict:
    """Phase 23 (``profiling``): ``utils.profiling.trace`` around one bf16
    image dispatch: the Chrome trace names the ``keep::attention_qkv_slab``
    operator and the kernel its C entry point ``keep_attention`` launches
    (``slab_attention_wgmma_kernel``, the one-pass bf16 body at ViT-L's
    Dh = 64 and S = 197), with the device time by kernel."""
    from keep_tpu_torch.utils import profiling

    x = aot_inputs(torch, model.cfg, n=32, device=device)
    with torch.no_grad():
        model.encode_image(x["pixels"])
        with profiling.trace(d) as prof:
            model.encode_image(x["pixels"])
    path = os.path.join(d, profiling.TRACE_FILE)
    names = {e.get("name", "") for e in json.load(open(path))["traceEvents"]}
    want = ("keep::attention_qkv_slab", "slab_attention_wgmma_kernel")
    found = {w: sum(w in n for n in names) > 0 for w in want}
    if not all(found.values()):
        raise AssertionError(f"trace names {found}")
    by_kernel = kernel_ms(torch, prof)
    result = {"trace_bytes": os.path.getsize(path), "names": found,
              "attention_device_ms": sum(
                  v for k, v in by_kernel.items() if "slab_attention" in k),
              "device_ms": sum(by_kernel.values())}
    phase("profiling", **result)
    return result


# ---- 24. dp: data parallelism through the entry points ----------------------

DP_STEPS = 7              # unfrozen steps of a world-1 NCCL run, batch 128
DP_TURNS = 2              # one process and NCCL in turns, this many runs each
DP_TRACE_AT = 1           # the step traced in the last turn (not timed)
DP_BUCKETS = (1, 8, 32, 128)
DP_SLIDE_PX = 8192        # the top-left quarter of phase 10's slide
DP_CHILD_TIMEOUT = 600


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def host_state() -> dict:
    """The host as a phase of ranks finds it: the memory available (GB),
    this process's threads, and the processes it has started that are
    still alive (pid: command), which would contend with the ranks."""
    children = []
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                children += f.read().split()
        except OSError:
            pass
    alive = {}
    for pid in children:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                alive[pid] = f.read().replace(b"\0", b" ").decode()[:120]
        except OSError:
            pass
    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) / 1e6
    return {"mem_available_gb": avail, "threads": len(os.listdir("/proc/self/task")),
            "children": alive}


@contextlib.contextmanager
def launcher_env(**env):
    """A torchrun-style environment for the span of the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_train_config(d: str, batch_size: int, caption_num: int, steps: int,
                    precision: str = "amp_bf16",
                    keep: dict | None = None) -> dict:
    """``train_config``'s values (``keep_train.yml``'s), one epoch of
    ``steps`` steps with both towers open."""
    raw = train_config(d, keep=keep, batch_size=batch_size,
                       caption_num=caption_num, steps_per_epoch=steps)
    raw["solver"].update(epochs=1, freeze_visual_epochs=0,
                         freeze_text_epochs=0)
    raw["model"]["precision"] = precision
    return raw


def counted_train(torch, fa, raw: dict, argv: list, device: str,
                  keep_params: bool = False, trace_at: int = -1,
                  hold: bool = False) -> dict:
    """``train.main`` on ``raw`` (plus ``argv``): each step timed, its loss
    and attention launches (``counted_steps``), the process group it ran
    in, peak device memory, the device ms by kernel of step ``trace_at``
    (on a card) and, with ``hold``, the state's own leaves after the last
    step (``held``: the tensors themselves, no copy), with ``keep_params``
    the trained parameters (a copy, on the card)."""
    from keep_tpu_torch.train import main as tmain

    os.makedirs(raw["save"]["output_dir"], exist_ok=True)
    path = os.path.join(raw["save"]["output_dir"], "run.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    steps: list[dict] = []
    group: dict = {}
    final: dict = {}
    state_bytes: dict = {}

    def before(i, state, batch, model, kw):
        dist = torch.distributed
        if i == 0:
            group.update(backend=dist.get_backend() if dist.is_initialized()
                         else None,
                         world=dist.get_world_size() if dist.is_initialized()
                         else 1)

    last_state: dict = {}

    def after(i, state, batch, model, kw):
        if hold:
            last_state.clear()
            last_state.update(state.params)
        if keep_params:
            final.clear()
            final.update({n: p.detach().clone()
                          for n, p in state.params.items()})
        # this rank's resident training state, each tensor once: the
        # model's parameters (the compute copy), the optimizer's leaves
        # where they are other tensors (FSDP's fp32 shards) and their
        # AdamW moments
        held = {t.data_ptr(): t for t in (
            *model.parameters(), *state.params.values(),
            *(t for m in ("mu", "nu") for t in state.opt_state[m].values()))}
        state_bytes["bytes"] = nbytes(*held.values())

    if device.startswith("cuda"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    traced: dict = {}
    with counted_steps(torch, fa, tmain, steps, traced, trace_at, device,
                       before, after):
        t0 = time.perf_counter()
        tmain.main(["--config", path, *argv])
        wall_s = time.perf_counter() - t0
    return {"steps": steps, "group": group, "params": final,
            "held": last_state,
            "traced": traced, "state_bytes": state_bytes.get("bytes"),
            "wall_s": wall_s,
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device.startswith("cuda") else 0.0)}


def check_dp_steps(tag: str, steps: list, blocks: int, n: int) -> None:
    """``n`` open steps, finite losses, #1 twice (remat) and #1b once per
    block of each."""
    if len(steps) != n:
        raise AssertionError(f"{tag}: {len(steps)} steps, want {n}")
    for i, st in enumerate(steps):
        if not np.isfinite(st["loss"]) or st["frozen"]:
            raise AssertionError(f"{tag} step {i}: {st}")
        if (st["fwd_launches"], st["bwd_launches"]) != (2 * blocks, blocks):
            raise AssertionError(
                f"{tag} step {i}: forward / backward launches "
                f"{st['fwd_launches']} / {st['bwd_launches']}, want "
                f"{(2 * blocks, blocks)}")


def allreduce_ms(torch, params: dict, runs: int = 5) -> dict:
    """The gradient all-reduce of a world-1 NCCL group on buffers of the
    trained parameters' shapes (``parallel.all_reduce_grads``: flattened
    into buckets, summed, viewed back), CUDA-event median, beside the time
    its bytes take at the card's memory rate (the buckets' concatenation
    reads and writes each gradient once)."""
    from keep_tpu_torch.parallel import all_reduce_grads, multihost

    grads = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in params.items()}
    nbytes_ = sum(g.numel() * 4 for g in grads.values())
    with launcher_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port(),
                      RANK=0, WORLD_SIZE=1, LOCAL_RANK=0):
        multihost.init_from_env("cuda")
        try:
            ms = cuda_ms(lambda: all_reduce_grads(dict(grads)), warmup=1,
                         runs=runs)
        finally:
            torch.distributed.destroy_process_group()
    return {"ms": ms, "gradient_bytes": nbytes_,
            "bytes_bound_ms": 2 * nbytes_ / HBM_BYTES_PER_S * 1e3}


def drive_dp_train(torch, fa, d: str, blocks: int, steps: int = DP_STEPS,
                   device: str = "cuda", batch: int = 128,
                   keep: dict | None = None, turns: int = DP_TURNS) -> dict:
    """24a. ``train.main`` under a torchrun-style environment at world 1
    over NCCL, at ``keep_train.yml``'s values (full width and depth,
    batch 128, ``steps`` open steps), against the same steps in one
    process, ``turns`` runs each in turns: losses and trained parameters
    bit for bit, launches per step, ms a step (the first of each run and
    the traced step left out) and the NCCL step's ms less the one-process
    step's, step for step, peak memory, the gradient all-reduce's
    time, and step ``DP_TRACE_AT`` of the last turn traced with
    torch.profiler: each one's device ms and the kernels whose device
    time differs most between the two."""
    raw = dp_train_config(os.path.join(d, "data"), batch, batch // 4, steps,
                          keep=keep)
    tags = ("one_process", "nccl_world1")
    runs: dict = {tag: [] for tag in tags}
    traced: dict = {}
    on_card = device == "cuda"
    for turn in range(turns):
        for tag in tags:
            r = json.loads(json.dumps(raw))
            r["save"]["output_dir"] = os.path.join(d, f"{tag}_{turn}")
            env = (launcher_env(MASTER_ADDR="127.0.0.1",
                                MASTER_PORT=free_port(), RANK=0,
                                WORLD_SIZE=1, LOCAL_RANK=0)
                   if tag == "nccl_world1" else contextlib.nullcontext())
            last = turn == turns - 1
            with env:
                run = counted_train(
                    torch, fa, r, ["--device", device], device,
                    keep_params=True,
                    trace_at=DP_TRACE_AT if last and on_card else -1)
            check_dp_steps(tag, run["steps"], blocks, steps)
            if last and on_card:
                traced[tag] = run["traced"]
            runs[tag].append(run)
        one, dp = runs["one_process"][-1], runs["nccl_world1"][-1]
        backend = "nccl" if on_card else "gloo"
        if dp["group"] != {"backend": backend, "world": 1} or one[
                "group"] != {"backend": None, "world": 1}:
            raise AssertionError(f"groups {one['group']} / {dp['group']}")
        losses = [[st["loss"] for st in r["steps"]] for r in (one, dp)]
        if losses[0] != losses[1]:
            raise AssertionError(f"world-1 NCCL losses {losses[1]} against "
                                 f"one process {losses[0]}")
        differ = [n for n, t in one["params"].items()
                  if not torch.equal(t, dp["params"][n])]
        if differ:
            raise AssertionError(f"{len(differ)} parameters differ, e.g. "
                                 f"{differ[:3]}")
        n_params = len(one["params"])
        if turn < turns - 1:
            one["params"] = dp["params"] = None
            if on_card:
                torch.cuda.empty_cache()
    reduce = (allreduce_ms(torch, runs["one_process"][-1]["params"])
              if on_card else "not measured")
    def timed(k: int, i: int) -> bool:
        return i > 0 and not (on_card and k == turns - 1
                              and i == DP_TRACE_AT)

    step_ms = {tag: [st["ms"] for k, r in enumerate(rs)
                     for i, st in enumerate(r["steps"]) if timed(k, i)]
               for tag, rs in runs.items()}
    # the same step of the same turn: the step's time follows its batch
    paired = [b - a for a, b in zip(step_ms["one_process"],
                                    step_ms["nccl_world1"])]
    device_ms = {tag: sum(k.values()) for tag, k in traced.items()}
    names = set().union(*traced.values()) if traced else set()
    moved = sorted(((traced["nccl_world1"].get(k, 0.0)
                     - traced["one_process"].get(k, 0.0), k)
                    for k in names), key=lambda x: -abs(x[0]))[:8]
    dp = runs["nccl_world1"][-1]
    out = {"card": card() if on_card else "cpu", "steps": steps,
           "turns": turns, "batch": batch, "losses": losses[1],
           "params_bit_equal": n_params,
           "ms_per_step": {tag: statistics.median(v)
                           for tag, v in step_ms.items()},
           "timed_steps": {tag: len(v) for tag, v in step_ms.items()},
           "paired_ms_nccl_minus_one": paired,
           "paired_median_ms": statistics.median(paired),
           "step_ms": {tag: [[st["ms"] for st in r["steps"]] for r in rs]
                       for tag, rs in runs.items()},
           "traced_step": DP_TRACE_AT,
           "traced_step_ms": {tag: rs[-1]["steps"][DP_TRACE_AT]["ms"]
                              for tag, rs in runs.items()},
           "traced_device_ms": device_ms if traced else "not measured",
           "kernels_nccl_minus_one_ms": [[k, ms] for ms, k in moved],
           "peak_memory_gb": {tag: rs[-1]["peak_memory_gb"]
                              for tag, rs in runs.items()},
           "allreduce": reduce,
           "launches_per_step": [dp["steps"][0]["fwd_launches"],
                                 dp["steps"][0]["bwd_launches"]],
           "fwd_launches": sum(st["fwd_launches"] for st in dp["steps"]),
           "bwd_launches": sum(st["bwd_launches"] for st in dp["steps"])}
    del runs, one, dp
    if on_card:
        torch.cuda.empty_cache()
    phase("dp_train_nccl_world1", **out)
    return out


@contextlib.contextmanager
def first_step_grads(torch, out: dict):
    """Records, into ``out``, each parameter's gradient norm, sum and sum
    of magnitudes (``l1``) as the optimizer gets them in the first step of
    the block's training (summed over the ranks under data parallelism;
    under a parallel layout, the step's ``layout``, gathered from every
    rank's pieces into one-process leaves first), in name order."""
    from keep_tpu_torch.train import trainer

    apply = trainer._optimizer_apply

    def recording(state, grads, *args, **kw):
        if not out:
            layout = args[3] if len(args) > 3 else kw.get("layout")
            full = grads if layout is None else layout.full(grads)
            names = sorted(full)
            with torch.no_grad():
                out.update(names=names, norm=torch.stack(
                    [full[n].float().norm() for n in names]).tolist(),
                    sum=torch.stack([full[n].float().sum()
                                     for n in names]).tolist(),
                    l1=torch.stack([full[n].float().abs().sum()
                                    for n in names]).tolist())
        return apply(state, grads, *args, **kw)

    trainer._optimizer_apply = recording
    try:
        yield out
    finally:
        trainer._optimizer_apply = apply


def leaf_digest(t) -> str:
    """A digest of a tensor's bits (equal bits, equal digests)."""
    import hashlib

    import torch

    host = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.blake2b(host.numpy().tobytes(),
                           digest_size=16).hexdigest()


@contextlib.contextmanager
def rank_timeline(marks: dict, since: float):
    """Where a rank's ``train.main`` spends its time, into ``marks``
    (seconds since ``since``, the parent's spawn, on the wall clock):
    joined (the process group), built (the model on the card),
    state_built (its training state), step_made, snapshot_done (the
    epoch's parameter norms), first_batch (off the prefetcher),
    batch_on_device, first_step (its start), steps_done (the last step's
    end), main_returned; the seconds outside the steps in the layout's gathers (``gather_s``), the
    eval (``eval_s``) and the checkpoint writer (``save_s``, rank 0); the
    process's CPU seconds (``cpu_s``)."""
    import resource

    from keep_tpu_torch.train import checkpoint as ckpt
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train import trainer

    spans = {"gather_s": 0.0, "eval_s": 0.0, "save_s": 0.0}
    in_step = [False]

    def mark(key):
        marks[key] = time.time() - since

    def first(key):
        return lambda: marks.setdefault(key, time.time() - since)

    def timed(owner, attr, span=None, after=None):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t0 = time.time()
            try:
                return fn(*a, **kw)
            finally:
                if span and not in_step[0]:
                    spans[span] += time.time() - t0
                if after:
                    after()
        setattr(owner, attr, wrapper)
        return owner, attr, fn

    make_step = tmain.make_train_step

    def marked_make_train_step(*a, **kw):
        inner = make_step(*a, **kw)
        first("step_made")()

        def step(*sa, **skw):
            in_step[0] = True
            marks.setdefault("first_step", time.time() - since)
            try:
                return inner(*sa, **skw)
            finally:
                in_step[0] = False
                mark("steps_done")
        return step

    prefetcher = tmain.Prefetcher

    def marked_prefetcher(*a, **kw):
        for i, item in enumerate(prefetcher(*a, **kw)):
            if i == 0:
                first("first_batch")()
            yield item

    saved = [timed(tmain.multihost, "init_from_env", after=first("joined")),
             timed(tmain, "build_model", after=first("built")),
             timed(tmain, "tree_state", after=first("state_built")),
             timed(tmain, "snapshot", after=first("snapshot_done")),
             timed(tmain, "to_device", after=first("batch_on_device")),
             timed(trainer.ParallelLayout, "full", "gather_s"),
             timed(tmain, "evaluate", "eval_s"),
             timed(ckpt.CheckpointWriter, "save", "save_s"),
             timed(ckpt.CheckpointWriter, "close", "save_s")]
    tmain.make_train_step = marked_make_train_step
    tmain.Prefetcher = marked_prefetcher
    try:
        yield marks
    finally:
        tmain.make_train_step = make_step
        tmain.Prefetcher = prefetcher
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
        mark("main_returned")
        marks.update(spans)
        use = resource.getrusage(resource.RUSAGE_SELF)
        marks["cpu_s"] = use.ru_utime + use.ru_stime


def dp_child(spec_path: str) -> None:
    """A rank of phases 26 and 27 (``chip_smoke.py --dp-child <spec>``):
    ``train.main`` on ``cuda:0`` over gloo in fp32 with TF32 off; writes
    its steps, its first step's gradient norms and sums, a digest and the
    shape of each state leaf it holds after the last step, and where its
    time went (``rank_timeline``: ``up`` and ``imported`` are the seconds
    from the spawn to this function and past the imports)."""
    with open(spec_path) as f:
        spec = json.load(f)
    marks = {"up": time.time() - spec["spawned_at"]}
    import torch

    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.ops.nn import ieee_fp32

    marks["imported"] = time.time() - spec["spawned_at"]
    with ieee_fp32(), first_step_grads(torch, {}) as grads, \
            rank_timeline(marks, spec["spawned_at"]):
        run = counted_train(torch, fa, spec["raw"],
                            ["--device", spec["device"], "--dist-backend",
                             "gloo"], spec["device"], hold=True)
    held = run.pop("held")
    with open(f"{spec['out']}.{os.environ['RANK']}.json", "w") as f:
        json.dump({"grads": grads, "timeline": marks,
                   "digests": {k: leaf_digest(v) for k, v in held.items()},
                   "shapes": {k: list(v.shape) for k, v in held.items()},
                   **{k: run[k] for k in ("steps", "group", "wall_s",
                                          "peak_memory_gb", "state_bytes")}},
                  f)


def drive_dp_serve(torch, fa, serve, d: str, device: str = "cuda",
                   width: int = 768) -> dict:
    """24c. ``serve --mesh-dp 1`` in bf16 and with ``--int8`` on the model
    in ``d``: features bit-equal to the plain server's at every bucket,
    the mesh server's launches for a bucket-128 dispatch pair, and both
    servers' tiles/s and prompts/s at bucket 128, in turns (plain, mesh,
    mesh, plain)."""
    rng = np.random.default_rng(3)
    out = {"card": card() if device == "cuda" else "cpu"}
    for tag, extra in (("bf16", []), ("int8", ["--int8"])):
        argv = ["--model-dir", d, "--port", "0", "--device", device, *extra]
        plain, httpd = serve.build_server(argv)
        httpd.server_close()
        mesh, httpd = serve.build_server(argv + ["--mesh-dp", "1"])
        httpd.server_close()
        try:
            if len(mesh.mesh) != 1 or mesh.buckets != plain.buckets:
                raise AssertionError(f"mesh {mesh.mesh}, buckets "
                                     f"{mesh.buckets} / {plain.buckets}")
            size = mesh.image_size
            for b in DP_BUCKETS:
                tiles = rng.integers(0, 256, (b, size, size, 3), np.uint8)
                texts = [PROMPTS[i % len(PROMPTS)] for i in range(b)]
                for what, fn in (("image", lambda c: c.encode_image(tiles)),
                                 ("text", lambda c: c.encode_text(texts))):
                    a, m = fn(plain), fn(mesh)
                    check_features(f"dp {tag} {what} B={b}", m, b, width)
                    if not np.array_equal(a, m):
                        raise AssertionError(
                            f"--mesh-dp 1 {tag} {what} at bucket {b}: max "
                            f"|Δ| {np.abs(a - m).max()} against the plain "
                            f"server")
            tiles = rng.integers(0, 256, (128, size, size, 3), np.uint8)
            texts = [PROMPTS[i % len(PROMPTS)] for i in range(128)]
            reset_launches(fa)
            mesh.encode_image(tiles)
            mesh.encode_text(texts)
            attn, int8 = read_launches(fa)
            rates = {"plain": {"image": [], "text": []},
                     "mesh_dp_1": {"image": [], "text": []}}
            for who in ("plain", "mesh_dp_1", "mesh_dp_1", "plain"):
                core = plain if who == "plain" else mesh
                rates[who]["image"].append(served_rate(
                    lambda: core.encode_image(tiles), 128))
                rates[who]["text"].append(served_rate(
                    lambda: core.encode_text(texts), 128))
            out[tag] = {"buckets_bit_equal": list(DP_BUCKETS),
                        "attention_launches": attn, "launches": int8,
                        "image_tiles_per_s_bucket128": {
                            k: v["image"] for k, v in rates.items()},
                        "text_prompts_per_s_bucket128x256": {
                            k: v["text"] for k, v in rates.items()}}
        finally:
            plain.stop()
            mesh.stop()
        del plain, mesh
        if device == "cuda":
            torch.cuda.empty_cache()
    if device == "cuda" and out["bf16"]["attention_launches"] != 24 + 12:
        raise AssertionError(f"bf16 mesh dispatch pair: "
                             f"{out['bf16']['attention_launches']} #1")
    phase("dp_serve", **out)
    return out


class _H5:
    """The part of ``h5py.File`` the extraction writes and reads (datasets
    of whole arrays), stored as an npz: the card's machine has no h5py."""

    def __init__(self, path: str, mode: str = "r"):
        self.path, self.mode = path, mode
        self.data = {}
        if mode == "r":
            with np.load(path) as z:
                self.data = {k: z[k] for k in z.files}

    def create_dataset(self, name: str, data) -> None:
        self.data[name] = np.asarray(data)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        if self.mode == "w" and exc[0] is None:
            with open(self.path, "wb") as f:
                np.savez(f, **self.data)


@contextlib.contextmanager
def h5_files():
    """``h5py`` where it is installed, else ``_H5`` in its place for the
    span of the block."""
    try:
        import h5py  # noqa: F401
        yield
        return
    except ImportError:
        pass
    import types

    shim = types.ModuleType("h5py")
    shim.File = _H5
    sys.modules["h5py"] = shim
    try:
        yield
    finally:
        sys.modules.pop("h5py", None)


def drive_dp_wsi(torch, fa, d: str, device: str = "cuda",
                 slide_px: int = DP_SLIDE_PX, batch_size: int = WSI_BATCH,
                 n_prompts: int = WSI_PROMPTS, width: int = 768) -> dict:
    """24d. ``wsi.run extract`` with and without ``--mesh-dp`` (bf16, then
    ``--int8``) on the top-left ``slide_px``² of phase 10's slide written
    as a PNG: the same printed lines, the same h5 features and coords, bit
    for bit, and the mesh runs' launches; then the sharded sweeps
    (``prompt_select_sharded``, ``pipelines.score_tiles_sharded``,
    ``refined_probs_sharded``) on a mesh of the card against their
    unsharded forms on those features: the same bits."""
    from PIL import Image

    from keep_tpu_torch.io.h5 import read_h5_slide
    from keep_tpu_torch.parallel import make_mesh
    from keep_tpu_torch.wsi import pipelines, run as wsi_run, sharded
    from keep_tpu_torch.wsi.grid import CoordGrid
    from keep_tpu_torch.zeroshot.classifier import prompt_select

    png = os.path.join(d, "slide.png")
    Image.fromarray(np.ascontiguousarray(
        wsi_slide(WSI_SLIDE_PX)[:slide_px, :slide_px])).save(
        png, compress_level=1)
    out = {"card": card() if device == "cuda" else "cpu",
           "slide_px": slide_px}
    feats = coords = None
    with h5_files():
        for tag, extra in (("bf16", []), ("int8", ["--int8"])):
            runs = {}
            for mode in ("plain", "mesh_dp"):
                h5 = os.path.join(d, f"{tag}_{mode}.h5")
                argv = ["extract", "--model", d, "--image", png, "--out", h5,
                        "--batch-size", str(batch_size), "--device", device,
                        *extra] + (["--mesh-dp"] if mode == "mesh_dp" else [])
                buf = io.StringIO()
                reset_launches(fa)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    wsi_run.main(argv)
                seconds = time.perf_counter() - t0
                attn, int8 = read_launches(fa)
                f, c = read_h5_slide(h5)
                runs[mode] = {"printed": buf.getvalue().replace(h5, "<out>"),
                              "features": f, "coords": c, "seconds": seconds,
                              "attention_launches": attn, "launches": int8}
            a, m = runs["plain"], runs["mesh_dp"]
            if a["printed"] != m["printed"]:
                raise AssertionError(f"{tag}: printed {m['printed']!r} "
                                     f"against {a['printed']!r}")
            if not (np.array_equal(a["features"], m["features"])
                    and np.array_equal(a["coords"], m["coords"])):
                gap = np.abs(a["features"] - m["features"]).max()
                raise AssertionError(f"{tag}: --mesh-dp features differ, max "
                                     f"|Δ| {gap}")
            check_features(f"dp wsi {tag}", m["features"], len(m["coords"]),
                           width)
            out[tag] = {"tiles": len(m["coords"]),
                        "printed": m["printed"].strip(),
                        "seconds": {k: r["seconds"] for k, r in runs.items()},
                        "attention_launches": m["attention_launches"],
                        "launches": m["launches"]}
            if tag == "bf16":
                feats, coords = m["features"], m["coords"]
    mesh = make_mesh(1) if device == "cuda" else make_mesh(
        1, devices=[torch.device(device)])
    rng = np.random.default_rng(5)
    stack = rng.standard_normal((n_prompts, feats.shape[1], 2)).astype(
        np.float32)
    stack /= np.linalg.norm(stack, axis=1, keepdims=True)
    x = torch.from_numpy(feats).to(mesh[0])
    stack_d = torch.from_numpy(stack).to(mesh[0])
    merged = prompt_select(stack_d, x)
    merged_sh = sharded.prompt_select_sharded(stack_d, x, mesh=mesh)
    probs = pipelines.score_tiles(merged, x)
    probs_sh = pipelines.score_tiles_sharded(merged, x, mesh=mesh)
    grid = CoordGrid.from_coords(coords, 256)
    refined = pipelines._refined_probs(merged, x, grid, True).cpu().numpy()
    refined_sh = sharded.refined_probs_sharded(merged, x, coords, 256,
                                               mesh=mesh)
    for name, a, b in (("prompt_select", merged, merged_sh),
                       ("score_tiles", probs, probs_sh)):
        if not torch.equal(a, b):
            raise AssertionError(f"sharded {name}: max |Δ| "
                                 f"{(a - b).abs().max().item()}")
    if not np.array_equal(refined, refined_sh):
        raise AssertionError(f"sharded refine: max |Δ| "
                             f"{np.abs(refined - refined_sh).max()}")
    out["sweeps"] = {"prompts": n_prompts, "patches": len(coords),
                     "bit_equal": ["prompt_select_sharded",
                                   "score_tiles_sharded",
                                   "refined_probs_sharded"]}
    phase("dp_wsi", **out)
    return out

# ---- wide_shapes: the widened attention bodies on their paths -------------------

# the shapes the widened bodies take (name, B, S, H, Dh): KEEP's ViT-L/16 at
# 384² and 448², and the zoo's head widths past 64 at 224² (patch 14)
WIDE_SHAPES = [("keep_384", 32, 577, 16, 64), ("keep_448", 32, 785, 16, 64),
               ("vit_h14", 32, 257, 16, 80), ("vit_g14", 32, 257, 16, 88),
               ("vit_bigg14", 32, 257, 16, 104), ("vit_e14", 32, 257, 16, 112)]
WIDE_SERVE_SIZES = (384, 448)
WIDE_SERVE_BATCH = 32      # one dispatch at bucket 32
WIDE_TRAIN_SIZE = 384
WIDE_TRAIN_BATCH = 32
WIDE_TRAIN_STEPS = 3
# the first step's gradient through the kernels against a plain-attention
# step in bf16: each leaf's norm (leaves of at least 1e-3 of the largest
# norm) and the global norm, relative. Sound runs read ≤ 1.34e-2 / 3.06e-4
# on the card; one block's dv dropped from #1b reads 0.867 / 2.84e-2
# (scripts/torch_smoke_phases.py --plant; PERF.md §6, PR 17). Faults that
# move no norm past the bf16 floor (one block's dk, the last token's row)
# are the kernel checks' to see (phase 25 (a), fp32 at 2e-4 / 1e-4).
WIDE_GRAD_LEAF_GATE = 5e-2
WIDE_GRAD_GLOBAL_GATE = 3e-3


def check_wide_kernels(fa, torch, gen) -> tuple[list[dict], list[dict]]:
    """wide_shapes (a). #1b and the bf16 → fp32 form of the int8 blocks'
    attention at ``WIDE_SHAPES`` (the bodies that kept Dh = 64, S ≤ 512
    until they were widened) against their plain versions: the backward
    fp32 at atol 2e-4 / rtol 1e-4 and bf16 within 1e-2 of the largest plain
    gradient, the fp32 form within the bf16 attention gate
    (``check_f32_form``); each call one launch; their times, the plain
    versions', their bounds and SDPA's (backward through autograd beside
    #1b, the bf16 forward beside the fp32 form)."""
    F = torch.nn.functional
    bwd_rows, f32_rows = [], []
    for name, b, s, h, dh in WIDE_SHAPES:
        qkv32 = torch.randn(b, s, 3 * h * dh, device="cuda", generator=gen)
        do32 = torch.randn(b, s, h * dh, device="cuda", generator=gen)
        kb = torch.zeros(b, s, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            qkv, do = qkv32.to(dtype), do32.to(dtype)
            n0 = fa.BWD_LAUNCHES
            got = fa.attention_qkv_slab_bwd(qkv, kb, do, h)
            torch.cuda.synchronize()
            if fa.BWD_LAUNCHES != n0 + 1:
                raise AssertionError(f"{name}: the backward did not launch")
            ref = fa.attention_qkv_slab_bwd_reference(qkv, kb, do, h)
            err = (got.float() - ref.float()).abs().max().item()
            limit = 1e-2 * ref.float().abs().max().item()
            if dtype == torch.float32:
                if not torch.allclose(got, ref, atol=2e-4, rtol=1e-4):
                    raise AssertionError(f"{name} fp32 backward vs plain: "
                                         f"max |Δ| {err}")
            elif not (torch.isfinite(got).all() and err <= limit):
                raise AssertionError(f"{name} bf16 backward vs plain: max "
                                     f"|Δ| {err} > {limit}")
            del ref
            q, k, v = (t.detach().requires_grad_() for t in
                       qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4))
            out = F.scaled_dot_product_attention(q, k, v)
            do4 = do.view(b, s, h, dh).transpose(1, 2)
            sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, (q, k, v), do4, retain_graph=True)
            row = {"shape": name, "B": b, "S": s, "H": h, "Dh": dh,
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err, "ms": cuda_ms(
                       lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h)),
                   "plain_ms": cuda_ms(
                       lambda: fa.attention_qkv_slab_bwd_reference(
                           qkv, kb, do, h), runs=5),
                   "library_ms": cuda_ms(sdpa_bwd),
                   "library_kernel": sdpa_backend(torch, sdpa_bwd)}
            row["dev_ms"], row["dev_ms_source"] = device_ms(
                torch, lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h),
                per_launch=2)
            row["library_dev_ms"], row["library_dev_ms_source"] = device_ms(
                torch, sdpa_bwd)
            row["bound_ms"], row["bound_by"] = attention_bound(
                b, s, h, qkv.element_size(), True, backward=True, dh=dh)
            del out, q, k, v
            phase("wide_bwd", **row)
            bwd_rows.append(row)
        qkv = qkv32.bfloat16()
        q, k, v = qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        n0 = fa.LAUNCHES
        row = check_f32_form(fa, torch, name, qkv, None,
                             torch.ones(b, s, dtype=torch.bool,
                                        device="cuda"), h, sdpa_ms)
        if fa.LAUNCHES <= n0:
            raise AssertionError(f"{name}: the bf16 -> fp32 form did not "
                                 f"launch")
        f32_rows.append(row)
        torch.cuda.empty_cache()
    return bwd_rows, f32_rows


def drive_wide_int8(torch, fa, serve, d: str, cfg, device: str = "cuda",
                    sizes=WIDE_SERVE_SIZES,
                    batch: int = WIDE_SERVE_BATCH) -> dict:
    """wide_shapes (b). An int8 KEEP at each of ``sizes`` (S = 577 and 785
    for ViT-L/16), served through the server core at bucket ``batch``: the
    bf16 model, the int8 model and the int8 model with its blocks' plain
    versions, on ``keep.init``-statistics weights (those the int8 gate is
    measured on). Gates: int8 against bf16 at cos ≥ 0.999 per row (image
    and text), int8 against its plain blocks in the JAX route gate's form
    (mean image-row cosine and whole text cosine > 0.9999). The int8
    dispatch's launches of #4 / #5, whose attention is the bf16 → fp32 form
    at these lengths."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    out = {"card": card() if device == "cuda" else "cpu", "batch": batch}
    for size in sizes:
        c = dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, img_size=size))
        sub = os.path.join(d, f"keep_{size}")
        os.makedirs(sub)
        write_model(sub, torch, c, device=device, keep_init=True)
        tiles = np.random.default_rng(size).integers(
            0, 256, (batch, size, size, 3), dtype=np.uint8)
        feats, launches = {}, {}
        for tag, quantize, plain in (("bf16", False, False),
                                     ("int8", True, False),
                                     ("int8_plain_blocks", True, True)):
            model = KEEPModel.from_pretrained(
                sub, dtype=torch.bfloat16, use_flash=True, device=device,
                quantize=quantize)
            core = serve.InferenceServer(
                model, WordPieceTokenizer.from_pretrained(sub),
                max_length=min(c.max_text_length,
                               c.text.max_position_embeddings),
                image_size=size)
            try:
                with (plain_int8_blocks() if plain
                      else contextlib.nullcontext()):
                    reset_launches(fa)
                    feats[tag] = {"image": core.encode_image(tiles),
                                  "text": core.encode_text(PROMPTS)}
                    launches[tag] = read_launches(fa)[1]
            finally:
                core.stop()
            del model, core
            if device == "cuda":
                torch.cuda.empty_cache()
        row = {"S": c.vision.num_patches + 1}
        for kind in ("image", "text"):
            check_features(f"int8 {size} {kind}", feats["int8"][kind],
                           batch if kind == "image" else len(PROMPTS),
                           c.projection_dim)
            cos = cosine_rows(feats["int8"][kind], feats["bf16"][kind])
            route = int8_route(feats["int8"][kind],
                               feats["int8_plain_blocks"][kind])
            row[kind] = {"min_row_cos_vs_bf16": float(cos.min()),
                         "route_vs_plain_blocks": route}
            if not cos.min() >= 0.999:
                raise AssertionError(f"int8 KEEP at {size}²: {kind} rows at "
                                     f"cos {cos.min()} < 0.999 of bf16")
            form = "mean_row_cos" if kind == "image" else "whole_cos"
            if not route[form] > 0.9999:
                raise AssertionError(f"int8 KEEP at {size}²: {kind} {form} "
                                     f"{route[form]} against its plain "
                                     f"blocks, not > 0.9999")
        row["launches"] = launches["int8"]
        for kname in ("quantized_attention_block",
                      "quantized_attention_block_postln"):
            if not launches["int8"].get(kname):
                raise AssertionError(f"int8 KEEP at {size}²: {kname} did not "
                                     f"launch")
        out[f"keep_{size}"] = row
    phase("wide_int8_serve", **out)
    return out


def drive_wide_train(torch, fa, d: str, device: str = "cuda",
                     img_size: int = WIDE_TRAIN_SIZE,
                     batch: int = WIDE_TRAIN_BATCH,
                     steps: int = WIDE_TRAIN_STEPS,
                     keep: dict | None = None, gate: bool = True,
                     name: str = "wide_train") -> dict:
    """wide_shapes (c). KEEP with both towers open at ``img_size``² (S =
    577 at 384²) through ``train.main`` in bf16 at ``batch`` for ``steps``
    steps: finite losses, #1 twice (remat) and #1b once per block of each
    step (36 #1b launches a step at full depth); the first step's gradient
    against the same step with plain attention (``model.use_flash`` off),
    each leaf's norm and the global norm, within ``WIDE_GRAD_*_GATE``
    unless ``gate`` is off (the readings of planted faults,
    ``scripts/torch_smoke_phases.py --plant``). Prints the phase
    ``name``."""
    keep = keep or {"projection_dim": 768, "vision": {"img_size": img_size}}
    raw = dp_train_config(os.path.join(d, "data"), batch, batch // 4, steps,
                          keep=keep)
    raw["save"]["output_dir"] = os.path.join(d, "kernels")
    blocks = (raw["keep"].get("vision", {}).get("depth", 24)
              + raw["keep"].get("text", {}).get("num_hidden_layers", 12))
    with first_step_grads(torch, {}) as grads:
        run = counted_train(torch, fa, raw, ["--device", device], device)
    check_dp_steps(f"{img_size}² training", run["steps"], blocks, steps)
    plain_raw = json.loads(json.dumps(raw))
    plain_raw["save"]["output_dir"] = os.path.join(d, "plain")
    plain_raw["model"]["use_flash"] = False
    with first_step_grads(torch, {}) as plain_grads:
        plain = counted_train(torch, fa, plain_raw, ["--device", device],
                              device)
    if grads["names"] != plain_grads["names"]:
        raise AssertionError("the plain step's gradient names differ")
    a, b = np.asarray(grads["norm"]), np.asarray(plain_grads["norm"])
    big = b >= 1e-3 * b.max()
    leaf_diff = float((np.abs(a - b) / np.maximum(b, 1e-30))[big].max())
    global_diff = float(abs(np.linalg.norm(a) - np.linalg.norm(b))
                        / np.linalg.norm(b))
    if gate and not (leaf_diff <= WIDE_GRAD_LEAF_GATE
                     and global_diff <= WIDE_GRAD_GLOBAL_GATE):
        raise AssertionError(
            f"{img_size}² first step through the kernels vs plain "
            f"attention: leaf norm diff {leaf_diff}, global {global_diff}")
    img_size = raw["keep"].get("vision", {}).get("img_size", 224)
    patch = raw["keep"].get("vision", {}).get("patch_size", 16)
    out = {"card": card() if device == "cuda" else "cpu",
           "img_size": img_size, "S": (img_size // patch) ** 2 + 1,
           "batch": batch, "steps": steps, "blocks": blocks,
           "precision": raw["model"]["precision"],
           "losses": [st["loss"] for st in run["steps"]],
           "losses_plain_attention": [st["loss"] for st in plain["steps"]],
           "fwd_launches_per_step": [st["fwd_launches"]
                                     for st in run["steps"]],
           "bwd_launches_per_step": [st["bwd_launches"]
                                     for st in run["steps"]],
           "first_step_grad_leaf_norm_max_rel_diff": leaf_diff,
           "first_step_grad_global_norm_rel_diff": global_diff,
           "ms_per_step": [st["ms"] for st in run["steps"]],
           "ms_per_step_plain_attention": [st["ms"] for st in plain["steps"]],
           "peak_memory_gb": run["peak_memory_gb"]}
    phase(name, **out)
    return out


# ---- dp2_layouts: fsdp, tp, sp and tp·fsdp across ranks ----------------------

# tag: (the solver's layout keys, world); tp · fsdp at world 4 (dp 2 × mp
# 2: at world 2 tp = 2 leaves dp = 1 and fsdp nothing to shard)
DP2_LAYOUTS = {"dp": ({}, 2), "fsdp": ({"fsdp": True}, 2),
               "tp2": ({"tp": 2}, 2), "tp2_sp": ({"tp": 2, "sp": True}, 2),
               "tp2_fsdp": ({"tp": 2, "fsdp": True}, 4)}
DP2_BATCH = 16
DP2_STEPS = 3
DP2_DEPTH = 6             # blocks a tower, at full width (the ranks'
                          # cross-rank code is proven, not the depth)
# a layout's first-step gradient against one process's, per leaf: its norm
# relative, and its sum within this share of the leaf's sum of magnitudes
# (a sum cancels). Sound layouts read ≤ 4.24e-6 on the card; dropping one
# block's mp all-reduce reads 0.313 on a norm, 1.63e-2 on a sum, and its
# losses stay within rtol 1.6e-6 (scripts/torch_smoke_phases.py --plant;
# PERF.md §6, PR 17)
DP2_LEAF_GATE = 1e-4
# dp's: each row's arithmetic is one process's (norms at rtol 1e-5 / atol
# 1e-6, sums within 1e-5 of the sum of magnitudes)
DP2_DP_SUM_GATE = 1e-5


def layout_reference(torch, fa, d: str, raw: dict, device: str,
                     blocks: int, steps: int) -> tuple[dict, dict]:
    """The one-process run every layout of ``raw`` is held to (fp32, TF32
    off) and its first step's gradient norms and sums: (run, grads)."""
    from keep_tpu_torch.ops.nn import ieee_fp32

    one_raw = json.loads(json.dumps(raw))
    one_raw["save"]["output_dir"] = os.path.join(d, "one_process")
    with ieee_fp32(), first_step_grads(torch, {}) as grads:
        one = counted_train(torch, fa, one_raw, ["--device", device], device)
    check_dp_steps("one process (fp32)", one["steps"], blocks, steps)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return one, grads


def start_layout_ranks(raw: dict, layouts: dict, d: str, device: str,
                       child: list) -> tuple[dict, dict]:
    """Every layout's ranks started at once, each a ``child`` process over
    gloo on ``device``: ({tag: [process]}, {tag: its output prefix})."""
    procs, outs = {}, {}
    for tag, (solver, world) in layouts.items():
        lraw = json.loads(json.dumps(raw))
        lraw["solver"].update(solver)
        lraw["save"]["output_dir"] = os.path.join(d, tag)
        spec_path = os.path.join(d, f"{tag}_spec.json")
        outs[tag] = os.path.join(d, f"{tag}_rank")
        with open(spec_path, "w") as f:
            json.dump({"raw": lraw, "out": outs[tag], "device": device,
                       "spawned_at": time.time()}, f)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__))
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs[tag] = [subprocess.Popen(
            [*child, spec_path], env=dict(env, RANK=str(r),
                                          LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    return procs, outs


def wait_ranks(procs: dict) -> dict:
    """{tag: each rank's log} once every rank has exited; a rank past
    ``DP_CHILD_TIMEOUT`` (a deadlocked collective shows only so) is killed
    with every other, and the error carries every rank's log tail."""
    logs: dict = {}
    deadline = time.monotonic() + DP_CHILD_TIMEOUT
    try:
        for tag, ps in procs.items():
            logs[tag] = [p.communicate(timeout=max(
                1.0, deadline - time.monotonic()))[0] for p in ps]
    except subprocess.TimeoutExpired:
        tails = []
        for tag, ps in procs.items():
            for r, p in enumerate(ps):
                if p.poll() is None:
                    p.kill()
                log = p.communicate()[0] or ""
                tails.append(f"--- {tag} rank {r} (rc {p.returncode}):\n"
                             + log[-2000:])
        raise AssertionError(f"layout ranks outlived {DP_CHILD_TIMEOUT} s:"
                             f"\n" + "\n".join(tails))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return logs


def hold_layouts(result: dict, one: dict, one_grads: dict, layouts: dict,
                 procs: dict, outs: dict, logs: dict, launches,
                 gate: bool = True) -> None:
    """Each layout's ranks against the one-process run, into ``result``:
    their group, launches per step (``launches(tag)``: the #1 blocks a
    rank's step runs), losses, first-step gradient norms and sums by leaf,
    resident state bytes, peak memory; the leaves each rank holds as
    digests (``leaf_digests``) where the child wrote them. Gated (losses at
    rtol 1e-5 / atol 1e-6, ``DP2_LEAF_GATE`` on the gradients, dp's norms
    at rtol 1e-5 and its sums at ``DP2_DP_SUM_GATE``) unless ``gate`` is
    off; a failing rank raises with its log tail."""
    want = [st["loss"] for st in one["steps"]]
    norms, sums, l1 = (np.asarray(one_grads[k]) for k in ("norm", "sum",
                                                          "l1"))
    for tag, ps in procs.items():
        ranks = []
        for r, p in enumerate(ps):
            if p.returncode != 0:
                raise AssertionError(f"{tag} rank {r} exited {p.returncode}:"
                                     f"\n" + logs[tag][r][-4000:])
            with open(f"{outs[tag]}.{r}.json") as f:
                ranks.append(json.load(f))
        world = layouts[tag][1]
        steps = len(want)
        for r, rank in enumerate(ranks):
            if rank["group"] != {"backend": "gloo", "world": world}:
                raise AssertionError(f"{tag} rank {r}: group {rank['group']}")
            check_dp_steps(f"{tag} rank {r}", rank["steps"], launches(tag),
                           steps)
            if rank["grads"]["names"] != one_grads["names"]:
                raise AssertionError(f"{tag} rank {r}: gradient names differ")
        got_norms = np.asarray([rk["grads"]["norm"] for rk in ranks])
        got_sums = np.asarray([rk["grads"]["sum"] for rk in ranks])
        losses = np.asarray([[st["loss"] for st in rk["steps"]]
                             for rk in ranks])
        result[tag] = {
            "world": world,
            "losses_ranks": losses.tolist(),
            "loss_max_rel_diff": float(
                (np.abs(losses - want) / np.maximum(np.abs(want), 1e-30))
                .max()),
            "grad_leaf_norm_max_rel_diff": float(
                (np.abs(got_norms - norms) / np.maximum(norms, 1e-30))
                .max()),
            "grad_leaf_sum_max_diff_over_l1": float(
                (np.abs(got_sums - sums) / np.maximum(l1, 1e-30)).max()),
            "fwd_launches_per_rank": [sum(st["fwd_launches"]
                                          for st in rk["steps"])
                                      for rk in ranks],
            "bwd_launches_per_rank": [sum(st["bwd_launches"]
                                          for st in rk["steps"])
                                      for rk in ranks],
            "state_bytes_per_rank": [rk["state_bytes"] for rk in ranks],
            "state_bytes_vs_one_process": [
                rk["state_bytes"] / one["state_bytes"] for rk in ranks],
            "ms_per_step_rank0": [st["ms"] for st in ranks[0]["steps"]],
            "wall_s_ranks": [rk["wall_s"] for rk in ranks],
            "peak_memory_gb_ranks": [rk["peak_memory_gb"] for rk in ranks]}
        for key in ("digests", "shapes", "timeline"):
            if key in ranks[0]:
                result[tag][key] = [rk[key] for rk in ranks]
        if not gate:
            continue
        np.testing.assert_allclose(losses, np.broadcast_to(want,
                                                           losses.shape),
                                   rtol=1e-5, atol=1e-6, err_msg=tag)
        row = result[tag]
        if tag == "dp":  # each row's arithmetic is one process's
            np.testing.assert_allclose(
                got_norms, np.broadcast_to(norms, got_norms.shape),
                rtol=1e-5, atol=1e-6,
                err_msg="dp: first-step gradient norms")
            sum_gate = DP2_DP_SUM_GATE
        else:
            if not row["grad_leaf_norm_max_rel_diff"] <= DP2_LEAF_GATE:
                raise AssertionError(
                    f"{tag}: a leaf's first-step gradient norm "
                    f"{row['grad_leaf_norm_max_rel_diff']} from one "
                    f"process's")
            sum_gate = DP2_LEAF_GATE
        if not row["grad_leaf_sum_max_diff_over_l1"] <= sum_gate:
            raise AssertionError(
                f"{tag}: a leaf's first-step gradient sum "
                f"{row['grad_leaf_sum_max_diff_over_l1']} of its sum of "
                f"magnitudes from one process's")


def tower_blocks(keep: dict) -> tuple[int, int]:
    """(ViT blocks, BERT blocks) of a ``keep`` config dict."""
    return (keep.get("vision", {}).get("depth", 24),
            keep.get("text", {}).get("num_hidden_layers", 12))


def drive_dp2_layouts(torch, fa, d: str, batch: int = DP2_BATCH,
                      steps: int = DP2_STEPS, device: str = "cuda:0",
                      keep: dict | None = None,
                      layouts: dict | None = None,
                      child: list | None = None, gate: bool = True,
                      name: str = "dp2_layouts") -> dict:
    """24b / dp2_layouts. Every layout of ``DP2_LAYOUTS`` (dp, fsdp, tp =
    2, tp = 2 + sp at world 2; tp = 2 + fsdp at world 4) over gloo on one
    card (every rank on ``cuda:0``; NCCL refuses two ranks on one card),
    fp32 with TF32 off, KEEP at full width with ``DP2_DEPTH`` blocks a
    tower, the global batch ``batch`` for ``steps`` steps, all layouts'
    ranks started together (each a ``child`` process: default
    ``chip_smoke.py --dp-child``). Gated unless ``gate`` is off (the
    readings of planted faults, ``scripts/torch_smoke_phases.py
    --plant``): each rank's losses within rtol 1e-5 / atol 1e-6 of one
    process's (the CPU tests' tolerance); each leaf's first-step gradient
    (gathered from the ranks' pieces) against one process's, its norm
    within ``DP2_LEAF_GATE`` and its sum within ``DP2_LEAF_GATE`` of the
    leaf's sum of magnitudes (dp's norms at rtol 1e-5 / atol 1e-6, its sums
    within ``DP2_DP_SUM_GATE``); #1 and #1b per rank as each step's blocks
    give them (under tp each launch takes H/2 heads). Per rank the
    resident state's bytes (beside dp's) and the peak device memory.
    Prints the phase ``name``."""
    keep = keep or {"projection_dim": 768,
                    "vision": {"depth": DP2_DEPTH},
                    "text": {"num_hidden_layers": DP2_DEPTH}}
    layouts = layouts or DP2_LAYOUTS
    child = child or [sys.executable, os.path.abspath(__file__),
                      "--dp-child"]
    blocks = sum(tower_blocks(keep))
    raw = dp_train_config(os.path.join(d, "data"), batch, batch // 4, steps,
                          precision="fp32", keep=keep)
    one, one_grads = layout_reference(torch, fa, d, raw, device, blocks,
                                      steps)
    t0 = time.perf_counter()
    procs, outs = start_layout_ranks(raw, layouts, d, device, child)
    logs = wait_ranks(procs)
    result = {"card": card() if device.startswith("cuda") else "cpu",
              "host": host_state(),
              "blocks": blocks, "batch": batch, "steps": steps,
              "precision": "fp32, TF32 off",
              "losses_one_process": [st["loss"] for st in one["steps"]],
              "one_process_state_bytes": one["state_bytes"],
              "wall_s_all_layouts": time.perf_counter() - t0}
    hold_layouts(result, one, one_grads, layouts, procs, outs, logs,
                 lambda tag: blocks, gate)
    for tag in layouts:
        result[tag].pop("digests", None)
        result[tag].pop("shapes", None)
    if "dp" in result:
        for tag in layouts:
            result[tag]["state_bytes_vs_dp"] = [
                a / result["dp"]["state_bytes_per_rank"][0]
                for a in result[tag]["state_bytes_per_rank"]]
    phase(name, **result)
    return result


# ---- 27. pp_ep_layouts: pipeline and expert parallelism across ranks -------

# tag: (the solver's layout keys, world); pp on the dense KEEP, ep on the
# 8-expert MoE KEEP of phase 19 (the grouped einsum dispatch)
PP_LAYOUTS = {"pp2": ({"pp": 2}, 2), "dp2_pp2": ({"pp": 2}, 4)}
EP_LAYOUTS = {"ep2": ({"ep": 2}, 2), "dp2_ep2": ({"ep": 2}, 4)}
# blocks a tower: at phase 26's 6, twelve ranks at once need more than the
# card's 80 GB, and the pp ranks then the ep ranks took 220 s of the smoke
# run, past phase 27's 200 s; at 2 all twelve start together. Only the
# depth is cut: the pp hops, the replication and the ep gathers are the
# same per block and microbatch.
PP_EP_DEPTH = 2
# a rank's resident state against one process's, from its piece's share
# (``state_share``): the sound layouts read it to 4 digits; a rank that
# kept the whole trunk or every expert reads 1.0
PP_EP_STATE_GATE = 1e-3


def pp_launch_blocks(keep: dict, pp: int) -> int:
    """The #1 blocks a pp rank's step runs: its stage's ViT blocks once per
    microbatch (M = pp, the default) and every BERT block (the text tower
    runs on every pp rank, as JAX replicates it)."""
    vision, text = tower_blocks(keep)
    return vision // pp * pp + text


def moe_launch_blocks(keep: dict) -> int:
    """The #1 blocks an MoE KEEP's step runs: BERT's (the MoE trunk's
    attention is plain, as in the JAX package)."""
    return tower_blocks(keep)[1]


def held_leaves(tag: str, digests: list, layouts: dict) -> dict:
    """The leaves several ranks of one pp or ep group hold (the inner axis
    is the last: the group of rank r is the ``inner`` ranks from r −
    r % inner), each digest against its peers': {"compared": n, "differ":
    [...]}.
    Expert leaves (``.moe.wi.`` / ``.moe.wo.``) differ by design under ep
    (each rank its own experts): left out."""
    solver, world = layouts[tag]
    inner = solver.get("pp") or solver["ep"]
    compared, differ = 0, []
    for base in range(0, world, inner):
        group = digests[base: base + inner]
        for k in group[0]:
            if ".moe.wi." in k or ".moe.wo." in k:
                continue
            peers = [g[k] for g in group if k in g]
            if len(peers) < 2:
                continue
            compared += 1
            if len(set(peers)) != 1:
                differ.append(k)
    return {"compared": compared, "differ": differ}


def one_process_shapes(raw: dict) -> dict:
    """{name: shape} of the one-process KEEP of ``raw`` (on the meta
    device)."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.train.config import TrainRunConfig

    cfg = TrainRunConfig.from_dict(json.loads(json.dumps(raw)))
    return {n: list(p.shape) for n, p in
            KEEPModel(cfg.keep, device="meta").named_parameters()}


def split_leaf(kind: str, name: str) -> bool:
    """Whether a pp stage or an ep rank holds only a piece of the leaf:
    the ViT's blocks under pp, the expert stacks under ep."""
    if kind == "pp":
        return name.startswith("visual.blocks.")
    return ".moe.wi." in name or ".moe.wo." in name


def rank_piece(kind: str, index: int, inner: int, shapes: dict,
               depth: int) -> dict:
    """{name: shape} of what the rank at ``index`` of its pp or ep group
    holds of the one-process ``shapes``: under pp its stage's ViT blocks
    (stage s: blocks [s·L/pp, (s+1)·L/pp)) and every other leaf whole;
    under ep the expert leaves with E / ep experts (axis 0) and every
    other leaf whole."""
    out = {}
    for n, shp in shapes.items():
        if split_leaf(kind, n):
            if kind == "pp":
                if int(n.split(".")[2]) * inner // depth != index:
                    continue
            else:
                shp = [shp[0] // inner, *shp[1:]]
        out[n] = shp
    return out


def state_share(kind: str, inner: int, shapes: dict) -> float:
    """A rank's resident state against one process's, by elements (every
    state tensor is fp32): 1 − (the split leaves' share)·(1 − 1/inner)."""
    sizes = {n: int(np.prod(s)) for n, s in shapes.items()}
    split = sum(e for n, e in sizes.items() if split_leaf(kind, n))
    return 1 - split / sum(sizes.values()) * (1 - 1 / inner)


def check_pieces(tag: str, kind: str, inner: int, row: dict,
                 shape_ranks: list, shapes: dict, depth: int,
                 gate: bool) -> None:
    """Each rank of a pp or ep layout holds its own piece of the state and
    no more (``rank_piece``: the leaves' names and shapes), and its
    resident state bytes are that piece's share of one process's
    (``state_share``) within ``PP_EP_STATE_GATE``: into ``row``, raised
    when ``gate``. A rank that kept the whole trunk or every expert (a
    layout that drops to dp) fails both."""
    want = state_share(kind, inner, shapes)
    row["state_share_want"] = want
    wrong = [r for r, got in enumerate(shape_ranks)
             if got != rank_piece(kind, r % inner, inner, shapes, depth)]
    row["ranks_holding_another_piece"] = wrong
    if not gate:
        return
    if wrong:
        raise AssertionError(f"{tag}: ranks {wrong} hold another piece of "
                             f"the state than their {kind} index's")
    for r, got in enumerate(row["state_bytes_vs_one_process"]):
        if not abs(got - want) <= PP_EP_STATE_GATE:
            raise AssertionError(f"{tag} rank {r}: resident state × {got} "
                                 f"of one process's, want × {want}")


def drive_pp_ep_layouts(torch, fa, d: str, batch: int = DP2_BATCH,
                        steps: int = DP2_STEPS, device: str = "cuda:0",
                        keep: dict | None = None,
                        moe_keep: dict | None = None,
                        pp_layouts: dict | None = None,
                        ep_layouts: dict | None = None,
                        child: list | None = None, gate: bool = True,
                        name: str = "pp_ep_layouts") -> dict:
    """27. pp_ep_layouts: ``train.main`` at pp = 2 (world 2) and dp 2 × pp
    2 (world 4) on the dense KEEP, and at ep = 2 (world 2) and dp 2 × ep 2
    (world 4) on the 8-expert MoE KEEP (``moe_dispatch='einsum'``), over
    gloo with every rank on ``cuda:0``, fp32 with TF32 off, full width
    with ``PP_EP_DEPTH`` blocks a tower, the global batch ``batch`` for
    ``steps`` steps: phase 26's setting but the depth, the two one-process
    runs they are held to first, then the four layouts' twelve ranks
    together.
    Gated as phase 26 (losses at rtol 1e-5 / atol 1e-6, each leaf's
    first-step gradient norm and sum at ``DP2_LEAF_GATE``), and: #1 / #1b
    per rank per step as a pp stage's blocks × microbatches give them
    (``pp_launch_blocks``; BERT's alone on the MoE KEEP); every leaf that
    two ranks of a pp or ep group hold bit-equal after the last step
    (digests); each rank holds its stage's blocks or its E / ep experts,
    and its resident state is that share of the one-process run's (dp's,
    which replicates it) within ``PP_EP_STATE_GATE`` (``check_pieces``).
    Per rank the peak memory and where its time went (``rank_timeline``)."""
    keep = keep or {"projection_dim": 768,
                    "vision": {"depth": PP_EP_DEPTH},
                    "text": {"num_hidden_layers": PP_EP_DEPTH}}
    moe_keep = moe_keep or {
        "projection_dim": 768,
        "vision": {"depth": PP_EP_DEPTH, "moe_experts": MOE_EXPERTS,
                   "moe_top_k": 1, "moe_capacity_factor": 1.25,
                   "moe_dispatch": "einsum"},
        "text": {"num_hidden_layers": PP_EP_DEPTH}}
    pp_layouts = PP_LAYOUTS if pp_layouts is None else pp_layouts
    ep_layouts = EP_LAYOUTS if ep_layouts is None else ep_layouts
    child = child or [sys.executable, os.path.abspath(__file__),
                      "--dp-child"]
    groups = {}
    for kind, kcfg, layouts, blocks in (
            ("pp", keep, pp_layouts, sum(tower_blocks(keep))),
            ("ep", moe_keep, ep_layouts, moe_launch_blocks(moe_keep))):
        if not layouts:
            continue
        kd = os.path.join(d, kind)
        raw = dp_train_config(os.path.join(kd, "data"), batch, batch // 4,
                              steps, precision="fp32", keep=kcfg)
        t0 = time.perf_counter()
        one, grads = layout_reference(torch, fa, kd, raw, device, blocks,
                                      steps)
        groups[kind] = (kcfg, kd, raw, layouts, one, grads,
                        time.perf_counter() - t0)
    result = {"card": card() if device.startswith("cuda") else "cpu",
              "host": host_state(), "batch": batch, "steps": steps,
              "precision": "fp32, TF32 off",
              "blocks_a_tower": tower_blocks(keep)}
    t0 = time.perf_counter()
    started = {kind: start_layout_ranks(g[2], g[3], g[1], device, child)
               for kind, g in groups.items()}
    # one deadline for all twelve: a rank past it kills every other
    logs = wait_ranks({tag: ps for procs, _ in started.values()
                       for tag, ps in procs.items()})
    result["wall_s_all_layouts"] = time.perf_counter() - t0
    for kind, (kcfg, kd, raw, layouts, one, grads, one_s) in groups.items():
        procs, outs = started[kind]

        def launches(tag, kcfg=kcfg, layouts=layouts, kind=kind):
            if kind == "ep":
                return moe_launch_blocks(kcfg)
            return pp_launch_blocks(kcfg, layouts[tag][0]["pp"])

        result[f"one_process_{kind}"] = {
            "losses": [st["loss"] for st in one["steps"]],
            "state_bytes": one["state_bytes"],
            "peak_memory_gb": one["peak_memory_gb"], "seconds": one_s}
        hold_layouts(result, one, grads, layouts, procs, outs, logs,
                     launches, gate)
        shapes = one_process_shapes(raw)
        for tag in layouts:
            row = result[tag]
            row["launch_blocks_per_step"] = launches(tag)
            row["held_leaves"] = held_leaves(tag, row.pop("digests"),
                                             layouts)
            if gate and (row["held_leaves"]["differ"]
                         or not row["held_leaves"]["compared"]):
                raise AssertionError(f"{tag}: leaves held by several ranks "
                                     f"of a group: {row['held_leaves']}")
            check_pieces(tag, kind, layouts[tag][0][kind], row,
                         row.pop("shapes"), shapes, tower_blocks(kcfg)[0],
                         gate)
    phase(name, **result)
    return result


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] == "--aot-child":
        aot_child(sys.argv[2])
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-child":
        dp_child(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from keep_tpu_torch import serve
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.kernels import ln_matmul as lm

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(card(), flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0,
          compiled=_build.BUILD_SECONDS is not None,
          library=_build.library_path().name)

    # 3. kernels vs plain at the serving shapes, and the three opt-in paths
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, f32_rows = check_kernel(fa, torch, gen)
    heads_rows, heads_launches = check_heads(fa, torch, gen)
    zoo_rows, zoo_heads_rows = check_attention_shapes(fa, torch, gen)
    int8_rows, _ = check_int8_kernels(torch, gen)
    ln_rows = check_ln_matmul(lm, torch, gen)
    cfg = KEEPConfig()
    fused = drive_fuse_ln(torch, fa, lm, cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d_zoo:
        zoo = drive_zoo_serve(torch, fa, d_zoo)
    torch.cuda.empty_cache()
    long_seq = drive_long_seq(torch, fa)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    towers = drive_zoo_towers(torch, fa)
    towers["seconds"] = time.perf_counter() - t0
    phase("zoo_towers_time", seconds=towers["seconds"])
    torch.cuda.empty_cache()

    # 4.–7. the bf16 and the int8 server, end to end, and their numbers
    with tempfile.TemporaryDirectory() as d, \
            tempfile.TemporaryDirectory() as d_init:
        write_model(d, torch, cfg)
        served, core, feats = drive_server(torch, fa, serve, cfg, d)
        try:
            throughput(torch, core, np.random.default_rng(1))
        finally:
            core.stop()
        del core
        torch.cuda.empty_cache()
        # the int8 scheme on these weights, whose blocks all move the
        # stream: measured and reported, not gated
        drift = served_features(torch, serve, cfg, d, quantize=True)
        phase("int8_drift", weights="random, every block moving the stream",
              min_cos_vs_bf16_server={
                  k: float(cosine_rows(v, feats[k]).min())
                  for k, v in drift.items()})
        # the int8 server, gated at cos >= 0.999 on weights with the
        # statistics the repo's gate is measured on (keep.init)
        write_model(d_init, torch, cfg, keep_init=True)
        ref = served_features(torch, serve, cfg, d_init, quantize=False)
        ref8 = served_features(torch, serve, cfg, d_init, quantize=True,
                               plain_blocks=True)
        served8, core8, _ = drive_server(torch, fa, serve, cfg, d_init,
                                         bf16_features=ref,
                                         plain_int8_features=ref8)
        try:
            throughput(torch, core8, np.random.default_rng(1), int8=True)
        finally:
            core8.stop()
        del core8
        torch.cuda.empty_cache()
        # 28. --precision-policy auto: co-located, then the relay's probe
        policy = drive_precision_policy(torch, fa, serve, cfg, d_init)
        torch.cuda.empty_cache()
        # 10.–12. the zero-shot WSI sweep on the same weights
        wsi = drive_wsi(torch, fa, d_init)
        torch.cuda.empty_cache()
        # 15.–16. SmoothQuant calibration (on the random draw, whose
        # blocks all move the stream), then the sweep off a pyramid
        calibrated = drive_int8_calibrated(torch, fa, d)
        torch.cuda.empty_cache()
        pyramid = drive_wsi_pyramid(torch, fa, d_init)
        torch.cuda.empty_cache()
        # 24c.–24d. --mesh-dp: the server and the WSI extraction and sweeps
        dp_serve = drive_dp_serve(torch, fa, serve, d_init)
        dp_wsi = drive_dp_wsi(torch, fa, d_init)
        wsi_slide.cache_clear()
        torch.cuda.empty_cache()

    # 8.–9. the attention backward, then training through the CLI
    bwd_rows = check_bwd_kernel(fa, torch, gen)
    blocks = cfg.vision.depth + cfg.text.num_hidden_layers
    with tempfile.TemporaryDirectory() as d_train:
        trained = drive_train(torch, fa, d_train,
                              train_config(d_train, steps_per_epoch=4),
                              blocks=blocks, steps_per_epoch=4)
    torch.cuda.empty_cache()

    # 25. wide_shapes: #1b and the int8 blocks' attention at the shapes
    # they were widened to, an int8 KEEP served at 384² and 448², a KEEP
    # trained at 384²
    t0 = time.perf_counter()
    wide_bwd_rows, wide_f32_rows = check_wide_kernels(fa, torch, gen)
    with tempfile.TemporaryDirectory() as d_wide:
        wide_int8 = drive_wide_int8(torch, fa, serve, d_wide, cfg)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d_wide:
        wide_train = drive_wide_train(torch, fa, d_wide)
    torch.cuda.empty_cache()
    phase("wide_shapes_time", seconds=time.perf_counter() - t0)
    wide = {"bwd": wide_bwd_rows, "f32": wide_f32_rows, "int8": wide_int8,
            "train": wide_train}

    # 24a. data-parallel training: world 1 over NCCL
    with tempfile.TemporaryDirectory() as d_dp:
        dp_train = drive_dp_train(torch, fa, d_dp, blocks)
    torch.cuda.empty_cache()

    # 24b. / 26. dp2_layouts: dp (24b's world 2 over gloo), fsdp, tp = 2
    # and tp = 2 + sp at world 2, tp = 2 + fsdp at world 4, over gloo,
    # against one process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d_dp:
        dp2 = drive_dp2_layouts(torch, fa, d_dp)
    torch.cuda.empty_cache()
    phase("dp2_layouts_time", seconds=time.perf_counter() - t0)

    # 27. pp_ep_layouts: pp = 2 and dp 2 × pp 2 on the dense KEEP, ep = 2
    # and dp 2 × ep 2 on the 8-expert MoE KEEP, over gloo, against one
    # process each
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d_pp:
        pp_ep = drive_pp_ep_layouts(torch, fa, d_pp)
    torch.cuda.empty_cache()
    phase("pp_ep_layouts_time", seconds=time.perf_counter() - t0)

    # 13.–14. LoRA fine-tuning with the eval, then serving its adapters
    with tempfile.TemporaryDirectory() as d_lora:
        lora_raw = lora_train_config(d_lora, steps_per_epoch=4)
        lora_trained = drive_lora_train(torch, fa, d_lora, lora_raw,
                                        blocks=blocks, steps_per_epoch=4)
        torch.cuda.empty_cache()
        model_dir = os.path.join(d_lora, "model")
        os.makedirs(model_dir)
        lora_served = drive_lora_serve(torch, serve, lora_raw,
                                       lora_trained["ckpt_dir"], model_dir)

    torch.cuda.empty_cache()

    # 17.–19. CoCa, PMC-CLIP and the Switch-MoE KEEP
    coca_out = drive_coca(torch, fa, gen)
    torch.cuda.empty_cache()
    pmc = drive_pmc_clip(torch, fa)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d_moe:
        moe_out = drive_moe(torch, fa, serve, d_moe)
    torch.cuda.empty_cache()

    # 20.–23. the released layout back through the registry, the int8
    # deploy artifact served as it is, AOT bundles in a fresh process, the
    # native tokenizer and a profiler trace
    saved_home = os.environ.get("KEEP_TPU_HOME")
    with tempfile.TemporaryDirectory() as d_src, \
            tempfile.TemporaryDirectory() as home, \
            tempfile.TemporaryDirectory() as d_aot:
        try:
            write_model(d_src, torch, cfg)
            compat, model, model8 = drive_compat(torch, fa, serve, d_src,
                                                 home)
        finally:
            if saved_home is None:
                os.environ.pop("KEEP_TPU_HOME", None)
            else:
                os.environ["KEEP_TPU_HOME"] = saved_home
        aot_out = drive_aot(torch, fa, {"bf16": (model, False),
                                        "int8": (model8, True)}, d_aot)
        fast_tok = drive_fast_tokenizer(torch, model, d_src)
        profiled = drive_profiling(torch, model, os.path.join(d_aot, "trace"))
        del model, model8
    torch.cuda.empty_cache()

    kernels = kernel_line(
        rows, bwd_rows, heads_rows, heads_launches, int8_rows, ln_rows,
        fused, served, served8, trained, f32_rows, wsi, lora_trained,
        lora_served, calibrated, pyramid, zoo_rows, zoo_heads_rows, zoo,
        long_seq, towers, coca_out, pmc, moe_out, compat, aot_out,
        {"train": dp_train, "gloo": dp2["dp"], "serve": dp_serve,
         "wsi": dp_wsi}, wide, dp2, pp_ep, policy)
    print(json.dumps({"kernel_resources": resources_line(kernels)}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_line(rows, bwd_rows, heads_rows, heads_launches, int8_rows,
                ln_rows, fused, served, served8, trained,
                f32_rows, wsi, lora_trained, lora_served, calibrated,
                pyramid, zoo_rows, zoo_heads_rows, zoo,
                long_seq, towers, coca_out, pmc, moe_out, compat,
                aot_out, dp, wide, dp2, pp_ep, policy) -> list[dict]:
    """One entry per TPU kernel: its launches on the main path that runs it,
    and, at ViT-L B=32 in bf16 (the int8 kernels: the first shape of their
    phase), its time, its plain version's, its bound and the one PyTorch
    call that computes the same function (null where there is none). The
    attention sub-blocks also carry their attention's rows (``f32_rows``,
    the bf16 → fp32 form at their tower's shapes). The kernels of the WSI
    sweep carry their launches on it (phases 10–11, bf16 and int8), those
    of the LoRA phases theirs (13: the steps and the eval; 14: the bf16 and
    the int8 server), and those of the calibrated int8 path (15) and the
    pyramid's (16: extraction, bf16 and int8, and the cascade) theirs.
    #1 and #2 also carry their rows at the zoo's shapes (phase 3e), and
    #1 its launches on the zoo's paths (3f: one ViT-H-14 batch; 3g) and
    on the other towers' (3h: one encode of each BERT-family text preset
    and of each of ``kep``'s towers). Phases 17–19 add #1's launches on a
    CoCa ViT-L/14 batch, a coca_roberta and a PMC-CLIP text encode and its
    row at S = 257, #1b's on the CoCa loss backward, and the int8 kernels'
    launches on an MoE KEEP image and text dispatch with #8's rows at the
    MoE trunk's qkv and proj shapes. Phases 20–21 add the launches on the
    registry-loaded model and the served int8 artifact
    (``launches_artifact_path``) and those the exported graphs made in
    their own process (``launches_aot_path``, a batch of 32 a tower).
    Phase 24 adds the data-parallel paths' (``launches_dp_path``): the
    world-1 NCCL and the world-2 gloo training runs (per rank), a bucket-128
    dispatch pair of ``serve --mesh-dp 1`` and ``wsi.run extract
    --mesh-dp``, bf16 and int8. Phase 25 (``wide``) adds #1b's and the
    bf16 → fp32 form's rows at the widened shapes (beside #1b and beside
    #4 / #5), #4 / #5's launches on the int8 KEEP served at 384² and 448²,
    and #1 / #1b's on the 384² training steps; phase 26 (``dp2``) #1 / #1b's
    per rank on each layout; phase 27 (``pp_ep``) theirs per rank on the pp
    and ep layouts (a pp rank's stage × microbatches; BERT's alone on the
    MoE KEEP)."""
    dp2_tags = [t for t in DP2_LAYOUTS if t in dp2]
    pp_ep_tags = [t for t in {**PP_LAYOUTS, **EP_LAYOUTS} if t in pp_ep]
    def pick(rs, shape="vit_l16"):
        return next(r for r in rs if r["shape"] == shape and r["B"] == 32
                    and r["dtype"] == "bfloat16")

    def entry(name, source, replaces, launches, r, err, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"), **extra}

    vit = pick(rows)
    kernels = [entry(
        "attention_qkv_slab", SOURCE, REPLACES, served["launches"], vit,
        max(r["max_abs_err"] for r in rows), sources=ATTENTION_SOURCES,
        library_call="torch.nn.functional.scaled_dot_product_attention",
        library_kernel=vit["library_kernel"],
        launches_int8_path=served8["attention_launches"],
        launches_train=trained["fwd_launches"],
        launches_lora_train=lora_trained["train_fwd_launches"],
        launches_lora_eval=lora_trained["eval_launches"],
        launches_lora_serve=lora_served["bf16"]["attention_launches"],
        launches_wsi_path={
            "extract": wsi["extract"]["attention_launches"],
            "classifier_auto": wsi["classifier"]["attention_launches_auto"],
            "classifier_flat": wsi["classifier"]["attention_launches_flat"]},
        launches_calibrated_path=calibrated["attention_launches"],
        launches_pyramid_path={
            "extract": pyramid["attention_launches"],
            "extract_int8": pyramid["int8_attention_launches"],
            "cascade": {m: c["attention_launches"]
                        for m, c in pyramid["cascade"].items()}},
        launches_zoo_path={
            f"{zoo['preset']} B={zoo['batch']}": zoo["attention_launches"],
            **{k: r["attention_launches"] for k, r in long_seq.items()}},
        launches_zoo_towers={
            **{f"{k} B={r['batch']} S={r['seq']}": r["attention_launches"]
               for k, r in towers["text"].items()},
            **{f"kep {t}": towers["registry"]["kep"][t]["attention_launches"]
               for t in ("image", "text", "knowledge")}},
        launches_coca={
            f"{coca_out['preset']} image B={coca_out['batch']}":
                coca_out["attention_launches"],
            f"{coca_out['roberta']['preset']} text "
            f"B={coca_out['roberta']['batch']}":
                coca_out["roberta"]["attention_launches"]},
        launches_pmc_clip_text=pmc["attention_launches"],
        launches_moe_text_train=moe_out["train"]["fwd_launches"],
        launches_registry_path=compat["attention_launches"],
        launches_artifact_path=compat["artifact_launches"]["attention"],
        launches_aot_path={
            tag: {t: r["batches"][f"{t}_32"]["attention_launches"]
                  for t in ("image", "text")}
            for tag, r in aot_out.items()},
        launches_dp_path={
            "train_nccl_world1": dp["train"]["fwd_launches"],
            "train_gloo_world2_per_rank": dp["gloo"]["fwd_launches_per_rank"],
            "serve_mesh_dp_1_pair": dp["serve"]["bf16"]["attention_launches"],
            "serve_mesh_dp_1_int8_pair":
                dp["serve"]["int8"]["attention_launches"],
            "wsi_extract_mesh_dp": dp["wsi"]["bf16"]["attention_launches"],
            "wsi_extract_mesh_dp_int8":
                dp["wsi"]["int8"]["attention_launches"]},
        launches_wide_train=sum(wide["train"]["fwd_launches_per_step"]),
        launches_dp2_layouts_per_rank={
            t: dp2[t]["fwd_launches_per_rank"] for t in dp2_tags},
        launches_pp_ep_layouts_per_rank={
            t: pp_ep[t]["fwd_launches_per_rank"] for t in pp_ep_tags},
        launches_precision_policy={
            f"relay_bucket1_{policy['relay']['choice']}":
                policy["relay"]["bucket1_launches"]["attention"],
            "alt_bf16_bucket1": policy["direct"]["bucket1"]["attention"],
            "int8_bucket8": policy["direct"]["bucket8"]["attention"]},
        shapes=rows, zoo_shapes=zoo_rows, coca_shape=coca_out["slab"])]
    vit_bwd = pick(bwd_rows)
    kernels.append(entry(
        "attention_qkv_slab_bwd", BWD_SOURCE, BWD_REPLACES,
        trained["bwd_launches"], vit_bwd,
        max(r["max_abs_err"] for r in bwd_rows), sources=BWD_SOURCES,
        dev_ms=vit_bwd["dev_ms"], dev_ms_source=vit_bwd["dev_ms_source"],
        library_dev_ms=vit_bwd["library_dev_ms"],
        launches_lora_train=lora_trained["bwd_launches"],
        launches_coca_backward=coca_out["backward_launches"],
        launches_moe_train=moe_out["train"]["bwd_launches"],
        launches_dp_path={
            "train_nccl_world1": dp["train"]["bwd_launches"],
            "train_gloo_world2_per_rank":
                dp["gloo"]["bwd_launches_per_rank"]},
        launches_wide_train=sum(wide["train"]["bwd_launches_per_step"]),
        launches_dp2_layouts_per_rank={
            t: dp2[t]["bwd_launches_per_rank"] for t in dp2_tags},
        launches_pp_ep_layouts_per_rank={
            t: pp_ep[t]["bwd_launches_per_rank"] for t in pp_ep_tags},
        library_call="scaled_dot_product_attention backward through "
                     "autograd (retain_graph; the forward not timed)",
        library_kernel=vit_bwd["library_kernel"], shapes=bwd_rows,
        wide_shapes=wide["bwd"],
        max_abs_err_wide=max(r["max_abs_err"] for r in wide["bwd"])))
    vit_heads = pick(heads_rows)
    kernels.append(entry(
        "attention_qkv_heads", SOURCE, HEADS_REPLACES, heads_launches,
        vit_heads, max(r["max_abs_err"] for r in heads_rows),
        sources=ATTENTION_SOURCES,
        library_call="torch.nn.functional.scaled_dot_product_attention",
        library_kernel=vit_heads["library_kernel"],
        flash_attention_ms=vit_heads["flash_attention_ms"],
        shapes=heads_rows, zoo_shapes=zoo_heads_rows))
    ln = ln_rows[0]
    kernels.append({
        "name": "ln_matmul", "route": "cuda", "source": LN_MATMUL_SOURCE,
        "body": LN_MATMUL_BODY, "replaces": LN_MATMUL_REPLACES,
        "launches": fused["ln_matmul_launches"],
        "max_abs_err": max(max(r["max_abs_err_fp32"], r["max_abs_err_bf16"])
                           for r in ln_rows),
        "ms": ln["ms"], "plain_ms": ln["plain_ms_bf16"],
        "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
        "library_ms": None, "unfused_ms": ln["unfused_ms"],
        "gemm_library_ms": ln["gemm_library_ms"],
        "max_abs_err_on_path": fused["ln_matmul_calls_vs_plain_max_abs_err"],
        "shapes": ln_rows})
    tower_of = {"quantized_attention_block": "vit_l16",
                "quantized_attention_block_postln": "bert_base"}
    for kname, (module, cu, replaces) in INT8_KERNELS.items():
        shapes = int8_rows[kname]["shapes"]
        launches = (int8_rows[kname]["launches"] if kname == "quantized_mlp"
                    else served8["launches"][kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + "int8_gemm.cu",
            "sources": [CSRC + f for f in cu] + [CSRC + "kops.cuh", module],
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": shapes[0]["ms_bf16"], "plain_ms": shapes[0]["plain_ms_bf16"],
            "bound_ms": shapes[0]["bound_ms_bf16"],
            "bound_by": shapes[0]["bound_by"], "library_ms": None,
            "int8_code_diff_share": max(r["int8_code_diff_share"]
                                        for r in shapes),
            "shapes": shapes})
        wsi_int8 = {"extract": wsi["extract"]["int8_launches"],
                    "classifier": wsi["classifier"]["int8_launches"]}
        kernels[-1]["launches_wsi_int8_path"] = {
            k: v.get(kname, 0) for k, v in wsi_int8.items()}
        kernels[-1]["launches_lora_serve_int8"] = (
            lora_served["int8"]["launches"].get(kname, 0))
        kernels[-1]["launches_calibrated_path"] = (
            calibrated["launches"].get(kname, 0))
        kernels[-1]["launches_pyramid_path"] = (
            pyramid["int8_launches"].get(kname, 0))
        kernels[-1]["launches_moe_int8_path"] = {
            "image": moe_out["serve"]["image_launches"].get(kname, 0),
            "text": moe_out["serve"]["text_launches"].get(kname, 0)}
        kernels[-1]["launches_artifact_path"] = (
            compat["artifact_launches"].get(kname, 0))
        kernels[-1]["launches_aot_path"] = {
            t: aot_out["int8"]["batches"][f"{t}_32"]["int8_launches"].get(
                kname, 0) for t in ("image", "text")}
        kernels[-1]["launches_dp_path"] = {
            "serve_mesh_dp_1_int8_pair":
                dp["serve"]["int8"]["launches"].get(kname, 0),
            "wsi_extract_mesh_dp_int8":
                dp["wsi"]["int8"]["launches"].get(kname, 0)}
        kernels[-1]["launches_precision_policy"] = {
            f"relay_bucket1_{policy['relay']['choice']}":
                policy["relay"]["bucket1_launches"].get(kname, 0),
            "alt_bf16_bucket1": policy["direct"]["bucket1"].get(kname, 0),
            "int8_bucket8": policy["direct"]["bucket8"].get(kname, 0)}
        if kname == "quantized_matmul_bsd":
            kernels[-1]["moe_shapes"] = moe_out["qmatmul_rows"]
        if kname in tower_of:
            kernels[-1]["attention_bf16_to_fp32"] = [
                r for r in f32_rows if r["shape"] == tower_of[kname]]
            kernels[-1]["attention_bf16_to_fp32_wide"] = wide["f32"]
            kernels[-1]["launches_wide_int8_path"] = {
                k: r["launches"].get(kname, 0)
                for k, r in wide["int8"].items() if k.startswith("keep_")}
    return kernels


if __name__ == "__main__":
    sys.exit(main())
